"""The port's copy of the host record model the device chains and the
CRAM codecs need (htslib_tpu/sam): CIGAR constants, text and lengths,
the SAM header with its lines, the BAM record with its SAM text and aux
CRUD, and the BAM container."""
