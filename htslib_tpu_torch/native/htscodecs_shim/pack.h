/* pack.h — bit-packing transform used by the CRAM XPACK record codec
 * (reference cram/cram_codecs.c:1399,1520).  htscodecs-compatible API. */
#ifndef HTSTPU_PACK_H
#define HTSTPU_PACK_H

#include <stdint.h>

/* Pack data (alphabet of <=16 distinct bytes) into 8/4/2/1-bit codes.
 * out_meta receives [nsym varint][the nsym symbol values]; returns a
 * malloc'd packed buffer and sets *out_len. */
uint8_t *hts_pack(uint8_t *data, int64_t len, uint8_t *out_meta,
                  int *out_meta_len, uint64_t *out_len);

/* Unpack: nsym = values per byte (8/nbits); map = value->symbol table.
 * Writes exactly out_len bytes into out.  Returns out or NULL. */
uint8_t *hts_unpack(uint8_t *data, int64_t len, uint8_t *out,
                    uint64_t out_len, int nsym, uint8_t *map);

#endif
