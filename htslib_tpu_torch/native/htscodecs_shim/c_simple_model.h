/* Adaptive symbol-frequency model over the range coder (CRAM 3.1 spec
 * "Adaptive modelling" section; used by fqzcomp_qual, arith_dynamic and
 * the tok3 arith mode).
 *
 * Mechanics per the specification pseudocode, shared verbatim with the
 * Python mirror (htslib_tpu/codecs/arith.py::SimpleModel) so the two
 * implementations stay wire-identical:
 *   - every symbol starts with frequency 1;
 *   - coding a symbol adds STEP (16) to its frequency;
 *   - when the total exceeds MAX_TOTAL (2^16 - 17) every frequency is
 *     halved rounding up, and the total recomputed;
 *   - after each update the coded symbol is transposed one slot toward
 *     the front if its frequency now exceeds its neighbour's (the
 *     adaptive-ordering step — it changes cumulative-frequency layout,
 *     so both codecs must apply it identically).
 */
#ifndef C_SIMPLE_MODEL_H
#define C_SIMPLE_MODEL_H

#include <stdint.h>
#include <string.h>

#include "c_range_coder.h"

#define SM_STEP 16
#define SM_MAX_TOTAL ((1u << 16) - 17)
#define SM_MAX_SYM 256

typedef struct {
    uint32_t total;
    uint16_t nsym;
    uint16_t freq[SM_MAX_SYM];
    uint8_t  sym[SM_MAX_SYM];    /* adaptive order: slot -> symbol */
} SimpleModel;

static inline void SM_Init(SimpleModel *m, int nsym) {
    int i;
    m->nsym = (uint16_t)nsym;
    m->total = (uint32_t)nsym;
    for (i = 0; i < nsym; i++) {
        m->freq[i] = 1;
        m->sym[i] = (uint8_t)i;
    }
}

static inline void SM_Renormalise(SimpleModel *m) {
    uint32_t tot = 0;
    int i;
    for (i = 0; i < m->nsym; i++) {
        m->freq[i] -= m->freq[i] >> 1;
        tot += m->freq[i];
    }
    m->total = tot;
}

static inline void SM_Update(SimpleModel *m, int slot) {
    m->freq[slot] = (uint16_t)(m->freq[slot] + SM_STEP);
    m->total += SM_STEP;
    if (slot > 0 && m->freq[slot] > m->freq[slot - 1]) {
        uint16_t tf = m->freq[slot];
        uint8_t ts = m->sym[slot];
        m->freq[slot] = m->freq[slot - 1];
        m->sym[slot] = m->sym[slot - 1];
        m->freq[slot - 1] = tf;
        m->sym[slot - 1] = ts;
    }
    if (m->total > SM_MAX_TOTAL)
        SM_Renormalise(m);
}

static inline void SM_EncodeSymbol(SimpleModel *m, RangeCoder *rc, int s) {
    uint32_t cum = 0;
    int i = 0;
    while (m->sym[i] != s)
        cum += m->freq[i++];
    RC_Encode(rc, cum, m->freq[i], m->total);
    SM_Update(m, i);
}

static inline int SM_DecodeSymbol(SimpleModel *m, RangeCoder *rc) {
    uint32_t f = RC_GetFreq(rc, m->total);
    uint32_t cum = 0;
    int i = 0, s;
    while (cum + m->freq[i] <= f)
        cum += m->freq[i++];
    RC_Decode(rc, cum, m->freq[i], m->total);
    s = m->sym[i];
    SM_Update(m, i);
    return s;
}

#endif
