"""CRAM host framing the port needs: container and block I/O, varints and
the format constants (reference cram/cram_io.c, cram/cram_structs.h)."""

CRAM_EOF_START = 0x454F46  # container ref_seq_start magic in EOF block
