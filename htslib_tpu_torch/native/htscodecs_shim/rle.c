/* Run-length transform (CRAM 3.1 XRLE).  A symbol in the declared set is
 * emitted once to the literal stream with a uint7 "extra copies" count in
 * the run stream.  Matches htslib_tpu/cram/codecs.py::XRleCodec. */
#include <stdlib.h>
#include <string.h>

#include "rle.h"
#include "varint.h"

uint8_t *hts_rle_decode(uint8_t *lit, uint64_t lit_len,
                        uint8_t *run, uint64_t run_len,
                        uint8_t *rle_syms, int rle_nsyms,
                        uint8_t *out, uint64_t *out_len) {
    uint8_t is_rle[256] = {0};
    for (int i = 0; i < rle_nsyms; i++) is_rle[rle_syms[i]] = 1;
    uint64_t cap = *out_len, o = 0, rp = 0;
    for (uint64_t i = 0; i < lit_len && o < cap; i++) {
        uint8_t b = lit[i];
        if (is_rle[b]) {
            uint64_t extra = 0;
            if (rp < run_len)
                rp += var_get_u64(run + rp, run + run_len, &extra);
            uint64_t n = extra + 1;
            if (n > cap - o) n = cap - o;
            memset(out + o, b, n);
            o += n;
        } else {
            out[o++] = b;
        }
    }
    *out_len = o;
    return out;
}

uint8_t *hts_rle_encode(uint8_t *data, uint64_t data_len,
                        uint8_t *out_run, uint64_t *out_run_len,
                        uint8_t *rle_syms, int *rle_nsyms,
                        uint8_t *out_lit, uint64_t *out_lit_len) {
    uint8_t is_rle[256] = {0};
    if (*rle_nsyms == 0) {
        /* pick symbols whose average run length exceeds 1 */
        uint64_t runs[256] = {0}, occ[256] = {0};
        for (uint64_t i = 0; i < data_len;) {
            uint64_t j = i;
            while (j < data_len && data[j] == data[i]) j++;
            runs[data[i]]++;
            occ[data[i]] += j - i;
            i = j;
        }
        int n = 0;
        for (int s = 0; s < 256; s++) {
            if (runs[s] && occ[s] > runs[s] * 2) {
                rle_syms[n++] = (uint8_t)s;
                is_rle[s] = 1;
            }
        }
        *rle_nsyms = n;
    } else {
        for (int i = 0; i < *rle_nsyms; i++) is_rle[rle_syms[i]] = 1;
    }

    if (!out_lit) {
        out_lit = malloc(data_len ? data_len : 1);
        if (!out_lit) return NULL;
    }
    uint64_t lo = 0, ro = 0;
    for (uint64_t i = 0; i < data_len;) {
        uint8_t b = data[i];
        uint64_t j = i;
        while (j < data_len && data[j] == b) j++;
        if (is_rle[b]) {
            out_lit[lo++] = b;
            if (out_run)
                ro += var_put_u64(out_run + ro, NULL, j - i - 1);
            else
                ro += var_size_u64(j - i - 1);
            i = j;
        } else {
            while (i < j) out_lit[lo++] = b, i++;
        }
    }
    *out_lit_len = lo;
    *out_run_len = ro;
    return out_lit;
}
