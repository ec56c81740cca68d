/* varint.h — uint7 varints (CRAM 3.1/4.0 "vint" encoding).
 *
 * API-compatible stand-in for htscodecs/varint.h so the reference htslib
 * can be built for baseline measurement without its (absent) htscodecs
 * submodule.  Wire format per the CRAM 3.1 codec specification: values are
 * emitted most-significant 7-bit group first with the 0x80 continuation
 * bit set on all but the final byte.  Same format as
 * htslib_tpu/cram/v4.py::write_uint7 (wire-vector tested).
 */
#ifndef HTSTPU_VARINT_H
#define HTSTPU_VARINT_H

#include <stdint.h>

static inline int var_put_u64(uint8_t *cp, const uint8_t *endp, uint64_t i) {
    uint8_t *op = cp;
    int s = 0;
    uint64_t X = i;
    do { s += 7; } while ((X >>= 7) > 0);
    do {
        s -= 7;
        if (endp && cp >= endp) return 0;
        *cp++ = (uint8_t)(((i >> s) & 0x7f) | (s ? 0x80 : 0));
    } while (s);
    return (int)(cp - op);
}

static inline int var_put_u32(uint8_t *cp, const uint8_t *endp, uint32_t i) {
    return var_put_u64(cp, endp, i);
}

static inline int var_get_u64(uint8_t *cp, const uint8_t *endp, uint64_t *i) {
    uint8_t *op = cp;
    uint64_t j = 0;
    if (endp) {
        while (cp < endp && (*cp & 0x80)) {
            j = (j << 7) | (*cp++ & 0x7f);
            if (cp - op > 9) { *i = 0; return 0; }
        }
        if (cp < endp)
            j = (j << 7) | *cp++;
    } else {
        while (*cp & 0x80)
            j = (j << 7) | (*cp++ & 0x7f);
        j = (j << 7) | *cp++;
    }
    *i = j;
    return (int)(cp - op);
}

static inline int var_get_u32(uint8_t *cp, const uint8_t *endp, uint32_t *i) {
    uint64_t v = 0;
    int n = var_get_u64(cp, endp, &v);
    *i = (uint32_t)v;
    return n;
}

/* Zig-zag signed variants */
static inline int var_put_s32(uint8_t *cp, const uint8_t *endp, int32_t i) {
    return var_put_u64(cp, endp, ((uint32_t)i << 1) ^ (uint32_t)(i >> 31));
}

static inline int var_get_s32(uint8_t *cp, const uint8_t *endp, int32_t *i) {
    uint64_t v = 0;
    int n = var_get_u64(cp, endp, &v);
    *i = (int32_t)((v >> 1) ^ (uint64_t)-(int64_t)(v & 1));
    return n;
}

static inline int var_put_s64(uint8_t *cp, const uint8_t *endp, int64_t i) {
    return var_put_u64(cp, endp, ((uint64_t)i << 1) ^ (uint64_t)(i >> 63));
}

static inline int var_get_s64(uint8_t *cp, const uint8_t *endp, int64_t *i) {
    uint64_t v = 0;
    int n = var_get_u64(cp, endp, &v);
    *i = (int64_t)((v >> 1) ^ (uint64_t)-(int64_t)(v & 1));
    return n;
}

static inline int var_size_u64(uint64_t v) {
    int s = 1;
    while ((v >>= 7) > 0) s++;
    return s;
}
#define var_size_u32 var_size_u64

#endif
