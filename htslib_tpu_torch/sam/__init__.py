"""The port's copy of the host record model the device chains need
(htslib_tpu/sam): CIGAR constants and text, a minimal header, and the BAM
record with its SAM text and aux CRUD."""
