"""Host utilities of the port: leveled logging (log.py)."""
