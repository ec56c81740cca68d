/* arith_dynamic.h — CRAM 3.1 adaptive arithmetic (range) coder API
 * (htscodecs-compatible prototypes; reference call sites
 * cram/cram_io.c:1718,1879). */
#ifndef HTSTPU_ARITH_DYNAMIC_H
#define HTSTPU_ARITH_DYNAMIC_H

#include <stdint.h>

unsigned char *arith_compress_to(unsigned char *in, unsigned int in_size,
                                 unsigned char *out, unsigned int *out_size,
                                 int order);
unsigned char *arith_uncompress_to(unsigned char *in, unsigned int in_size,
                                   unsigned char *out, unsigned int *out_sz);
unsigned int arith_compress_bound(unsigned int size, int order);

#endif
