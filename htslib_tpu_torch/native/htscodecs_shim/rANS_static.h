/* rANS_static.h — CRAM 3.0 rANS 4x8 entropy codec (API-compatible with
 * htscodecs rANS_static.h; wire format per the CRAM 3.0 specification).
 * Used by the reference via cram/cram_io.c:1668,1838. */
#ifndef HTSTPU_RANS_STATIC_H
#define HTSTPU_RANS_STATIC_H

unsigned char *rans_compress(unsigned char *in, unsigned int in_size,
                             unsigned int *out_size, int order);
unsigned char *rans_uncompress(unsigned char *in, unsigned int in_size,
                               unsigned int *out_size);
unsigned int rans_compress_bound(unsigned int size, int order);

#endif
