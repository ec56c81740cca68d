/* Carry-counting byte range coder (CRAM 3.1 spec "Range coding" section;
 * the coder family used by fqzcomp_qual / arith_dynamic / tok3 in the
 * reference call sites cram/cram_io.c:1686,1718,1737).
 *
 * Written for this project from the specification's pseudocode: 64-bit
 * `low` accumulator, 32-bit `range`, renormalisation when range < 2^24,
 * classic cache+FF-run carry propagation on encode, 5-byte bootstrap on
 * decode (the first emitted byte is the initial zero cache).  The
 * htscodecs submodule is absent from this snapshot, so bit-level
 * identity with its binaries is unverifiable here; this header is the
 * project-wide wire definition and the Python mirror
 * (htslib_tpu/codecs/arith.py) is cross-validated against it.
 */
#ifndef C_RANGE_CODER_H
#define C_RANGE_CODER_H

#include <stdint.h>
#include <stddef.h>

#define RC_TOP (1u << 24)

typedef struct {
    uint64_t low;
    uint32_t range;
    uint32_t code;
    uint32_t FFnum;
    uint8_t  cache;
    int      carry;
    uint8_t *out;     /* encode destination cursor */
    const uint8_t *in, *in_end;  /* decode source */
    uint8_t *out_start;
} RangeCoder;

static inline void RC_StartEncode(RangeCoder *rc, uint8_t *out) {
    rc->low = 0;
    rc->range = 0xFFFFFFFFu;
    rc->FFnum = 0;
    rc->cache = 0;
    rc->carry = 0;
    rc->out = out;
    rc->out_start = out;
}

static inline void RC_OutByte(RangeCoder *rc, uint8_t b) { *rc->out++ = b; }

static inline uint8_t RC_InByte(RangeCoder *rc) {
    return rc->in < rc->in_end ? *rc->in++ : 0;
}

static inline void RC_ShiftLow(RangeCoder *rc) {
    if ((uint32_t)rc->low < 0xFF000000u || (uint32_t)(rc->low >> 32)) {
        uint32_t c = (uint32_t)(rc->low >> 32);
        RC_OutByte(rc, (uint8_t)(rc->cache + c));
        while (rc->FFnum) {
            RC_OutByte(rc, (uint8_t)(0xFF + c));
            rc->FFnum--;
        }
        rc->cache = (uint8_t)(rc->low >> 24);
    } else {
        rc->FFnum++;
    }
    rc->low = (rc->low << 8) & 0xFFFFFFFFu;
}

static inline void RC_Encode(RangeCoder *rc, uint32_t cumFreq,
                             uint32_t freq, uint32_t totFreq) {
    rc->low += cumFreq * (uint64_t)(rc->range /= totFreq);
    rc->range *= freq;
    while (rc->range < RC_TOP) {
        RC_ShiftLow(rc);
        rc->range <<= 8;
    }
}

static inline size_t RC_FinishEncode(RangeCoder *rc) {
    int i;
    for (i = 0; i < 5; i++)
        RC_ShiftLow(rc);
    return (size_t)(rc->out - rc->out_start);
}

static inline void RC_StartDecode(RangeCoder *rc, const uint8_t *in,
                                  const uint8_t *in_end) {
    int i;
    rc->in = in;
    rc->in_end = in_end;
    rc->range = 0xFFFFFFFFu;
    rc->code = 0;
    for (i = 0; i < 5; i++)
        rc->code = (rc->code << 8) | RC_InByte(rc);
}

static inline uint32_t RC_GetFreq(RangeCoder *rc, uint32_t totFreq) {
    return rc->code / (rc->range /= totFreq);
}

static inline void RC_Decode(RangeCoder *rc, uint32_t cumFreq,
                             uint32_t freq, uint32_t totFreq) {
    (void)totFreq;
    rc->code -= cumFreq * rc->range;
    rc->range *= freq;
    while (rc->range < RC_TOP) {
        rc->code = (rc->code << 8) | RC_InByte(rc);
        rc->range <<= 8;
    }
}

#endif
