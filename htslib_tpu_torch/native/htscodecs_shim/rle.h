/* rle.h — run-length transform used by the CRAM XRLE record codec
 * (reference cram/cram_codecs.c:2106,2278).  htscodecs-compatible API. */
#ifndef HTSTPU_RLE_H
#define HTSTPU_RLE_H

#include <stdint.h>

/* Decode: literals + per-run varint lengths (run = extra copies) for
 * symbols in rle_syms.  *out_len carries the expected output size in and
 * the produced size out. */
uint8_t *hts_rle_decode(uint8_t *lit, uint64_t lit_len,
                        uint8_t *run, uint64_t run_len,
                        uint8_t *rle_syms, int rle_nsyms,
                        uint8_t *out, uint64_t *out_len);

/* Encode: emits literal stream (returned; malloc'd if out_lit NULL) and
 * appends varint run lengths to out_run.  If *rle_nsyms is 0, chooses the
 * symbol set and stores it back. */
uint8_t *hts_rle_encode(uint8_t *data, uint64_t data_len,
                        uint8_t *out_run, uint64_t *out_run_len,
                        uint8_t *rle_syms, int *rle_nsyms,
                        uint8_t *out_lit, uint64_t *out_lit_len);

#endif
