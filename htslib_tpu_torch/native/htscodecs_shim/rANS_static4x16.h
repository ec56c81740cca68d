/* rANS_static4x16.h — CRAM 3.1 rANS Nx16 codec API (htscodecs-compatible
 * prototypes; wire format per the CRAM 3.1 codec specification).
 * Reference call sites: cram/cram_io.c:1699,1859; cram/cram_external.c:619. */
#ifndef HTSTPU_RANS_STATIC4X16_H
#define HTSTPU_RANS_STATIC4X16_H

#include <stdint.h>

/* Wire-format order-byte flags (CRAM 3.1 spec; low byte goes on the wire). */
#define RANS_ORDER_X32    0x04
#define RANS_ORDER_STRIPE 0x08
#define RANS_ORDER_NOSZ   0x10
#define RANS_ORDER_CAT    0x20
#define RANS_ORDER_RLE    0x40
#define RANS_ORDER_PACK   0x80

/* Non-wire hints (must stay above the wire byte). */
#define RANS_ORDER_SIMD_AUTO 0x10000

unsigned char *rans_compress_4x16(unsigned char *in, unsigned int in_size,
                                  unsigned int *out_size, int order);
unsigned char *rans_uncompress_4x16(unsigned char *in, unsigned int in_size,
                                    unsigned int *out_size);
unsigned char *rans_uncompress_to_4x16(unsigned char *in, unsigned int in_size,
                                       unsigned char *out,
                                       unsigned int *out_size);
unsigned int rans_compress_bound_4x16(unsigned int size, int order);

#endif
