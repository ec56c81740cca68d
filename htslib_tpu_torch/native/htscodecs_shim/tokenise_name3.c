/* Name tokeniser — CRAM 3.1 TOK3 block method (reference call sites
 * cram/cram_io.c:1737,1891; the original tokenise_name3.c lives in the
 * absent htscodecs submodule).
 *
 * C mirror of htslib_tpu/codecs/tok3.py — see that module's docstring
 * for the full wire layout (u7 ulen, u7 nnames, use_arith byte, then
 * (pos, kind, u7 clen, substream) records; column kinds TYPE/ALPHA/
 * CHAR/DIGITS/DZLEN/DELTA; type bytes END/MATCH/DELTA/DELTA0/DIGITS/
 * DIGITS0/CHAR/ALPHA and name-level DUP/DIFF).  Sub-streams are
 * rANS Nx16 (use_arith=0) or arith (1), best of order-0/order-1/CAT.
 * The two implementations are cross-validated in tests/test_codecs31.py.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "tokenise_name3.h"
#include "rANS_static4x16.h"
#include "arith_dynamic.h"
#include "varint.h"

enum { K_TYPE, K_ALPHA, K_CHAR, K_DIGITS, K_DZLEN, K_DELTA, K_NKIND };
enum { T_END, T_MATCH, T_DELTA, T_DELTA0, T_DIGITS, T_DIGITS0, T_CHAR,
       T_ALPHA, T_DUP, T_DIFF };

#define MAX_TOKP 256   /* column positions 0..255 */
#define MAX_TOK 250

typedef struct { uint8_t *d; size_t len, cap; } tbuf_t;

static int tb_put(tbuf_t *b, const void *p, size_t n) {
    if (b->len + n > b->cap) {
        size_t nc = b->cap ? b->cap * 2 : 256;
        while (nc < b->len + n) nc *= 2;
        uint8_t *nd = (uint8_t *)realloc(b->d, nc);
        if (!nd) return -1;
        b->d = nd; b->cap = nc;
    }
    memcpy(b->d + b->len, p, n);
    b->len += n;
    return 0;
}
static int tb_putc(tbuf_t *b, uint8_t c) { return tb_put(b, &c, 1); }
static int tb_putu7(tbuf_t *b, uint64_t v) {
    uint8_t tmp[10];
    int n = var_put_u64(tmp, NULL, v);
    return tb_put(b, tmp, n);
}

typedef struct { const uint8_t *s; int len; } tok_t;

static int is_digits(const tok_t *t) {
    int i;
    if (t->len == 0 || t->len > 9) return 0;
    for (i = 0; i < t->len; i++)
        if (t->s[i] < '0' || t->s[i] > '9') return 0;
    return 1;
}

static uint32_t tok_val(const tok_t *t) {
    uint32_t v = 0;
    int i;
    for (i = 0; i < t->len; i++) v = v * 10 + (uint32_t)(t->s[i] - '0');
    return v;
}

static int tokenize(const uint8_t *name, int len, tok_t *toks) {
    int i = 0, n = 0;
    while (i < len && n < MAX_TOK - 1) {
        uint8_t c = name[i];
        int j = i;
        if (c >= '0' && c <= '9') {
            while (j < len && name[j] >= '0' && name[j] <= '9') j++;
        } else if ((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z')) {
            while (j < len && ((name[j] >= 'A' && name[j] <= 'Z')
                               || (name[j] >= 'a' && name[j] <= 'z'))) j++;
        } else {
            j = i + 1;
        }
        toks[n].s = name + i;
        toks[n].len = j - i;
        n++;
        i = j;
    }
    if (i < len) {               /* fold the tail into one token */
        toks[n].s = name + i;
        toks[n].len = len - i;
        n++;
    }
    return n;
}

static uint8_t *compress_stream(const uint8_t *data, size_t len,
                                int use_arith, unsigned int *clen) {
    unsigned int best_len = 0;
    uint8_t *best = NULL;
    int fl, cand[3] = {0, 1, 0x20};
    if (len == 0) { *clen = 0; return (uint8_t *)malloc(1); }
    for (fl = 0; fl < 3; fl++) {
        unsigned int cl = 0;
        uint8_t *c;
        if (use_arith)
            c = arith_compress_to((unsigned char *)data, (unsigned int)len,
                                  NULL, &cl, cand[fl]);
        else
            c = rans_compress_4x16((unsigned char *)data, (unsigned int)len,
                                   &cl, cand[fl]);
        if (!c) continue;
        if (!best || cl < best_len) {
            free(best);
            best = c;
            best_len = cl;
        } else {
            free(c);
        }
    }
    *clen = best_len;
    return best;
}

uint8_t *tok3_encode_names(char *blk, int len, int level, int use_arith,
                           int *out_len, int *last_start_p) {
    (void)level;
    if (last_start_p) *last_start_p = 0;
    /* split on NUL (also accept trailing name without NUL) */
    int nnames = 0, i;
    for (i = 0; i < len; i++) if (blk[i] == '\0') nnames++;
    int tail = (len > 0 && blk[len - 1] != '\0');
    nnames += tail;

    tbuf_t streams[MAX_TOKP][K_NKIND];
    memset(streams, 0, sizeof streams);
    tok_t prev_toks[MAX_TOK];
    int prev_ntok = 0;
    const uint8_t *prev_name = NULL;
    int prev_name_len = -1;
    uint64_t ulen = 0;

    int pos0 = 0, r = 0;
    while (pos0 < len) {
        int e = pos0;
        while (e < len && blk[e] != '\0') e++;
        const uint8_t *name = (const uint8_t *)blk + pos0;
        int nlen = e - pos0;
        ulen += (uint64_t)nlen + 1;
        pos0 = e + 1;

        if (prev_name && nlen == prev_name_len
            && memcmp(name, prev_name, (size_t)nlen) == 0) {
            r |= tb_putc(&streams[0][K_TYPE], T_DUP);
            continue;
        }
        r |= tb_putc(&streams[0][K_TYPE], T_DIFF);
        tok_t toks[MAX_TOK];
        int ntok = tokenize(name, nlen, toks), ti;
        for (ti = 0; ti < ntok; ti++) {
            int pos = ti + 1;
            const tok_t *tok = &toks[ti];
            const tok_t *prev = ti < prev_ntok ? &prev_toks[ti] : NULL;
            if (prev && prev->len == tok->len
                && memcmp(prev->s, tok->s, (size_t)tok->len) == 0) {
                r |= tb_putc(&streams[pos][K_TYPE], T_MATCH);
                continue;
            }
            if (is_digits(tok)) {
                int zero_pad = tok->len > 1 && tok->s[0] == '0';
                uint32_t v = tok_val(tok);
                if (prev && is_digits(prev)) {
                    int pzp = prev->len > 1 && prev->s[0] == '0';
                    uint32_t pv = tok_val(prev);
                    int64_t d = (int64_t)v - (int64_t)pv;
                    if (d >= 0 && d <= 255 && zero_pad == pzp
                        && (!zero_pad || tok->len == prev->len)) {
                        r |= tb_putc(&streams[pos][K_TYPE],
                                     zero_pad ? T_DELTA0 : T_DELTA);
                        r |= tb_putc(&streams[pos][K_DELTA], (uint8_t)d);
                        continue;
                    }
                }
                uint8_t le[4] = { (uint8_t)v, (uint8_t)(v >> 8),
                                  (uint8_t)(v >> 16), (uint8_t)(v >> 24) };
                if (zero_pad) {
                    r |= tb_putc(&streams[pos][K_TYPE], T_DIGITS0);
                    r |= tb_put(&streams[pos][K_DIGITS], le, 4);
                    r |= tb_putc(&streams[pos][K_DZLEN], (uint8_t)tok->len);
                } else {
                    r |= tb_putc(&streams[pos][K_TYPE], T_DIGITS);
                    r |= tb_put(&streams[pos][K_DIGITS], le, 4);
                }
                continue;
            }
            if (tok->len == 1
                && !((tok->s[0] >= 'A' && tok->s[0] <= 'Z')
                     || (tok->s[0] >= 'a' && tok->s[0] <= 'z'))) {
                r |= tb_putc(&streams[pos][K_TYPE], T_CHAR);
                r |= tb_putc(&streams[pos][K_CHAR], tok->s[0]);
            } else {
                r |= tb_putc(&streams[pos][K_TYPE], T_ALPHA);
                r |= tb_put(&streams[pos][K_ALPHA], tok->s,
                            (size_t)tok->len);
                r |= tb_putc(&streams[pos][K_ALPHA], 0);
            }
        }
        r |= tb_putc(&streams[ntok + 1][K_TYPE], T_END);
        memcpy(prev_toks, toks, (size_t)ntok * sizeof(tok_t));
        prev_ntok = ntok;
        prev_name = name;
        prev_name_len = nlen;
    }
    if (tail) ulen -= 0;   /* trailing name already counted with +1 */

    tbuf_t out = {0, 0, 0};
    r |= tb_putu7(&out, ulen);
    r |= tb_putu7(&out, (uint64_t)nnames);
    r |= tb_putc(&out, use_arith ? 1 : 0);
    int pos, k;
    for (pos = 0; pos < MAX_TOKP && !r; pos++) {
        for (k = 0; k < K_NKIND && !r; k++) {
            tbuf_t *st = &streams[pos][k];
            if (!st->len) continue;
            unsigned int clen = 0;
            uint8_t *c = compress_stream(st->d, st->len, use_arith, &clen);
            if (!c) { r = -1; break; }
            r |= tb_putc(&out, (uint8_t)pos);
            r |= tb_putc(&out, (uint8_t)k);
            r |= tb_putu7(&out, clen);
            r |= tb_put(&out, c, clen);
            free(c);
        }
    }
    for (pos = 0; pos < MAX_TOKP; pos++)
        for (k = 0; k < K_NKIND; k++)
            free(streams[pos][k].d);
    if (r) { free(out.d); return NULL; }
    *out_len = (int)out.len;
    return out.d;
}

typedef struct { uint8_t *d; size_t len, p; } trd_t;

static int trd_byte(trd_t *r) {
    return r->p < r->len ? r->d[r->p++] : -1;
}

uint8_t *tok3_decode_names(uint8_t *in, uint32_t sz, uint32_t *out_len) {
    uint64_t p = 0, ulen64;
    uint32_t nnames;
    int n = var_get_u64(in, in + sz, &ulen64);
    if (n <= 0) return NULL;
    p = (uint64_t)n;
    n = var_get_u32(in + p, in + sz, &nnames);
    if (n <= 0) return NULL;
    p += (uint64_t)n;
    if (p >= sz) return NULL;
    int use_arith = in[p++];

    trd_t streams[MAX_TOKP][K_NKIND];
    memset(streams, 0, sizeof streams);
    int ok = 1;
    while (p < sz) {
        if (p + 2 > sz) { ok = 0; break; }
        int pos = in[p], k = in[p + 1];
        p += 2;
        uint32_t clen;
        n = var_get_u32(in + p, in + sz, &clen);
        if (n <= 0 || k >= K_NKIND) { ok = 0; break; }
        p += (uint64_t)n;
        if (p + clen > sz) { ok = 0; break; }
        unsigned int dlen = 0;
        uint8_t *d;
        if (clen == 0) {
            d = (uint8_t *)malloc(1);
            dlen = 0;
        } else if (use_arith) {
            d = arith_uncompress_to(in + p, clen, NULL, &dlen);
        } else {
            d = rans_uncompress_4x16(in + p, clen, &dlen);
        }
        if (!d) { ok = 0; break; }
        free(streams[pos][k].d);
        streams[pos][k].d = d;
        streams[pos][k].len = dlen;
        streams[pos][k].p = 0;
        p += clen;
    }

    uint8_t *out = NULL;
    size_t out_cap = (size_t)ulen64 + 1, out_pos = 0;
    size_t prev_name_start = 0, prev_name_len = 0;
    int have_prev = 0;
    /* previous/current name token spans, as offsets from the name start */
    int *p_off = NULL, *p_len = NULL, *c_off = NULL, *c_len = NULL;
    int prev_ntok = 0;
    if (ok) {
        out = (uint8_t *)malloc(out_cap);
        p_off = (int *)calloc(MAX_TOK, sizeof(int));
        p_len = (int *)calloc(MAX_TOK, sizeof(int));
        c_off = (int *)calloc(MAX_TOK, sizeof(int));
        c_len = (int *)calloc(MAX_TOK, sizeof(int));
        if (!out || !p_off || !p_len || !c_off || !c_len) ok = 0;
    }
    uint32_t ni;
    for (ni = 0; ok && ni < nnames; ni++) {
        int t0 = trd_byte(&streams[0][K_TYPE]);
        if (t0 == T_DUP) {
            if (!have_prev || out_pos + prev_name_len + 1 > out_cap) {
                ok = 0; break;
            }
            memmove(out + out_pos, out + prev_name_start, prev_name_len);
            prev_name_start = out_pos;
            out_pos += prev_name_len;
            out[out_pos++] = '\0';
            continue;
        }
        if (t0 != T_DIFF) { ok = 0; break; }
        size_t name_start = out_pos;
        int pos = 1, ntok = 0;
        for (;;) {
            int t = trd_byte(&streams[pos][K_TYPE]);
            if (t == T_END) break;
            if (t < 0 || pos >= MAX_TOKP - 1 || ntok >= MAX_TOK) {
                ok = 0; break;
            }
            uint8_t tokbuf[64];
            int toklen = 0;
            const uint8_t *tsrc = tokbuf;
            int has_prev = have_prev && pos - 1 < prev_ntok;
            const uint8_t *pts = has_prev
                ? out + prev_name_start + p_off[pos - 1] : NULL;
            int ptl = has_prev ? p_len[pos - 1] : 0;
            if (t == T_MATCH) {
                if (!has_prev) { ok = 0; break; }
                tsrc = pts;
                toklen = ptl;
            } else if (t == T_DELTA || t == T_DELTA0) {
                if (!has_prev || ptl == 0 || ptl > 20) { ok = 0; break; }
                int d = trd_byte(&streams[pos][K_DELTA]);
                if (d < 0) { ok = 0; break; }
                uint64_t pv = 0;
                int pi2;
                for (pi2 = 0; pi2 < ptl; pi2++) {
                    uint8_t c = pts[pi2];
                    if (c < '0' || c > '9') { ok = 0; break; }
                    pv = pv * 10 + (c - '0');
                }
                if (!ok) break;
                pv += (uint64_t)d;
                char tmp[24];
                int tl = snprintf(tmp, sizeof tmp, "%llu",
                                  (unsigned long long)pv);
                if (t == T_DELTA0) {
                    int w = ptl;
                    if (tl > w || w >= 64) { ok = 0; break; }
                    memset(tokbuf, '0', (size_t)(w - tl));
                    memcpy(tokbuf + (w - tl), tmp, (size_t)tl);
                    toklen = w;
                } else {
                    memcpy(tokbuf, tmp, (size_t)tl);
                    toklen = tl;
                }
            } else if (t == T_DIGITS || t == T_DIGITS0) {
                trd_t *ds = &streams[pos][K_DIGITS];
                if (ds->p + 4 > ds->len) { ok = 0; break; }
                uint32_t v = ds->d[ds->p] | ((uint32_t)ds->d[ds->p + 1] << 8)
                           | ((uint32_t)ds->d[ds->p + 2] << 16)
                           | ((uint32_t)ds->d[ds->p + 3] << 24);
                ds->p += 4;
                char tmp[16];
                int tl = snprintf(tmp, sizeof tmp, "%u", v);
                if (t == T_DIGITS0) {
                    int w = trd_byte(&streams[pos][K_DZLEN]);
                    if (w < tl || w >= 64) { ok = 0; break; }
                    memset(tokbuf, '0', (size_t)(w - tl));
                    memcpy(tokbuf + (w - tl), tmp, (size_t)tl);
                    toklen = w;
                } else {
                    memcpy(tokbuf, tmp, (size_t)tl);
                    toklen = tl;
                }
            } else if (t == T_CHAR) {
                int c = trd_byte(&streams[pos][K_CHAR]);
                if (c < 0) { ok = 0; break; }
                tokbuf[0] = (uint8_t)c;
                toklen = 1;
            } else if (t == T_ALPHA) {
                trd_t *as = &streams[pos][K_ALPHA];
                size_t e = as->p;
                while (e < as->len && as->d[e] != 0) e++;
                if (e >= as->len) { ok = 0; break; }
                tsrc = as->d + as->p;
                toklen = (int)(e - as->p);
                as->p = e + 1;
            } else {
                ok = 0; break;
            }
            if (out_pos + (size_t)toklen + 1 > out_cap) {
                size_t nc = out_cap * 2 + (size_t)toklen + 64;
                ptrdiff_t tsrc_in_out =
                    (tsrc >= out && tsrc < out + out_cap)
                        ? tsrc - out : -1;
                uint8_t *no = (uint8_t *)realloc(out, nc);
                if (!no) { ok = 0; break; }
                if (tsrc_in_out >= 0) tsrc = no + tsrc_in_out;
                out = no;
                out_cap = nc;
            }
            memmove(out + out_pos, tsrc, (size_t)toklen);
            c_off[ntok] = (int)(out_pos - name_start);
            c_len[ntok] = toklen;
            out_pos += (size_t)toklen;
            ntok++;
            pos++;
        }
        if (!ok) break;
        if (out_pos + 1 > out_cap) {
            uint8_t *no = (uint8_t *)realloc(out, out_cap + 64);
            if (!no) { ok = 0; break; }
            out = no;
            out_cap += 64;
        }
        prev_name_start = name_start;
        prev_name_len = out_pos - name_start;
        have_prev = 1;
        out[out_pos++] = '\0';
        {
            int *t1 = p_off; p_off = c_off; c_off = t1;
            int *t2 = p_len; p_len = c_len; c_len = t2;
            prev_ntok = ntok;
        }
    }
    free(p_off); free(p_len); free(c_off); free(c_len);
    {
        int pos, k;
        for (pos = 0; pos < MAX_TOKP; pos++)
            for (k = 0; k < K_NKIND; k++)
                free(streams[pos][k].d);
    }
    if (!ok || out_pos != ulen64) { free(out); return NULL; }
    *out_len = (uint32_t)out_pos;
    return out;
}
