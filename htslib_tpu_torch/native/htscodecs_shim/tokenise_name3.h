/* tokenise_name3.h — CRAM 3.1 name tokeniser API (htscodecs-compatible
 * prototypes; reference call sites cram/cram_io.c:1737,1891). */
#ifndef HTSTPU_TOKENISE_NAME3_H
#define HTSTPU_TOKENISE_NAME3_H

#include <stdint.h>

uint8_t *tok3_encode_names(char *blk, int len, int level, int use_arith,
                           int *out_len, int *last_start_p);
uint8_t *tok3_decode_names(uint8_t *in, uint32_t sz, uint32_t *out_len);

#endif
