"""Host entropy codecs of the port."""
