/* Bit-pack transform (CRAM 3.1 XPACK).  Values are packed MSB-first
 * within each byte, matching htslib_tpu/cram/codecs.py::XPackCodec.
 * Reference behavior: cram/cram_codecs.c:1389-1405 (expand via hts_unpack).
 */
#include <stdlib.h>
#include <string.h>

#include "pack.h"
#include "varint.h"

uint8_t *hts_unpack(uint8_t *data, int64_t len, uint8_t *out,
                    uint64_t out_len, int nsym, uint8_t *map) {
    if (!out) return NULL;
    if (nsym <= 1) {          /* nbits==0: constant symbol */
        memset(out, map ? map[0] : 0, out_len);
        return out;
    }
    if (nsym == 8) {          /* 1-bit */
        uint64_t o = 0;
        for (int64_t i = 0; i < len && o < out_len; i++) {
            uint8_t b = data[i];
            for (int k = 7; k >= 0 && o < out_len; k--)
                out[o++] = map[(b >> k) & 1];
        }
        return out;
    }
    if (nsym == 4) {          /* 2-bit */
        uint64_t o = 0;
        for (int64_t i = 0; i < len && o < out_len; i++) {
            uint8_t b = data[i];
            for (int k = 3; k >= 0 && o < out_len; k--)
                out[o++] = map[(b >> (2 * k)) & 3];
        }
        return out;
    }
    if (nsym == 2) {          /* 4-bit */
        uint64_t o = 0;
        for (int64_t i = 0; i < len && o < out_len; i++) {
            uint8_t b = data[i];
            if (o < out_len) out[o++] = map[b >> 4];
            if (o < out_len) out[o++] = map[b & 15];
        }
        return out;
    }
    /* nsym==1 handled above; 8-bit passthrough with map */
    for (int64_t i = 0; i < len && (uint64_t)i < out_len; i++)
        out[i] = map[data[i]];
    return out;
}

uint8_t *hts_pack(uint8_t *data, int64_t len, uint8_t *out_meta,
                  int *out_meta_len, uint64_t *out_len) {
    /* find alphabet */
    int hist[256] = {0};
    for (int64_t i = 0; i < len; i++) hist[data[i]] = 1;
    uint8_t syms[256];
    int fmap[256];
    int nsym = 0;
    for (int i = 0; i < 256; i++) {
        if (hist[i]) {
            fmap[i] = nsym;
            syms[nsym++] = (uint8_t)i;
        }
    }
    int m = 0;
    out_meta[m++] = (uint8_t)nsym;          /* meta: nsym then symbols */
    for (int i = 0; i < nsym; i++) out_meta[m++] = syms[i];
    *out_meta_len = m;

    uint8_t *out;
    if (nsym <= 1) {
        out = malloc(1);
        if (!out) return NULL;
        *out_len = 0;
        return out;
    }
    if (nsym <= 2) {          /* 1-bit */
        uint64_t n = ((uint64_t)len + 7) / 8;
        out = calloc(n ? n : 1, 1);
        if (!out) return NULL;
        for (int64_t i = 0; i < len; i++)
            out[i >> 3] |= (uint8_t)(fmap[data[i]] << (7 - (i & 7)));
        *out_len = n;
        return out;
    }
    if (nsym <= 4) {          /* 2-bit */
        uint64_t n = ((uint64_t)len + 3) / 4;
        out = calloc(n ? n : 1, 1);
        if (!out) return NULL;
        for (int64_t i = 0; i < len; i++)
            out[i >> 2] |= (uint8_t)(fmap[data[i]] << (2 * (3 - (i & 3))));
        *out_len = n;
        return out;
    }
    if (nsym <= 16) {         /* 4-bit */
        uint64_t n = ((uint64_t)len + 1) / 2;
        out = calloc(n ? n : 1, 1);
        if (!out) return NULL;
        for (int64_t i = 0; i < len; i++)
            out[i >> 1] |= (uint8_t)(fmap[data[i]] << (4 * (1 - (i & 1))));
        *out_len = n;
        return out;
    }
    /* alphabet too large: no packing */
    out = malloc(len ? (size_t)len : 1);
    if (!out) return NULL;
    memcpy(out, data, (size_t)len);
    *out_len = (uint64_t)len;
    return out;
}
