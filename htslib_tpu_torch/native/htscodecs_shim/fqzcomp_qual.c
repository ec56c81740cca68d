/* FQZComp quality codec — CRAM 3.1 FQZ block method (reference call
 * sites cram/cram_io.c:1686,1821; the original fqzcomp_qual.c lives in
 * the absent htscodecs submodule).
 *
 * Context-modelled adaptive range coding of quality strings: each
 * quality is coded under a 16-bit context mixing recent quality
 * history, position-in-read bucket and mismatch-run ("delta") bucket,
 * per the CRAM 3.1 specification's fqzcomp section.  Wire format
 * (project-wide definition, mirrored byte-for-byte by
 * htslib_tpu/codecs/fqzcomp.py; cross-validated in
 * tests/test_codecs31.py):
 *
 *   u7    total uncompressed length
 *   byte  vers = 5
 *   byte  gflags: 1 MULTI_PARAM, 2 HAVE_STAB, 4 DO_REV (none produced
 *                 by this encoder; all accepted by the decoder)
 *   [byte nparam]                    if MULTI_PARAM
 *   [byte max_sel; stab store_array(256)]  if HAVE_STAB
 *   per parameter set:
 *     u16le context   initial context register
 *     byte  pflags: 2 DO_DEDUP, 4 DO_LEN, 8 DO_SEL, 16 HAVE_QMAP,
 *                   32 HAVE_PTAB, 64 HAVE_DTAB, 128 HAVE_QTAB
 *     byte  max_sym
 *     byte  (qbits<<4)|qshift
 *     byte  (qloc<<4)|sloc
 *     byte  (ploc<<4)|dloc
 *     [max_sym bytes qmap]           if HAVE_QMAP (code -> quality)
 *     [store_array qtab 256]         if HAVE_QTAB  else identity
 *     [store_array ptab 1024]        if HAVE_PTAB  else zeros
 *     [store_array dtab 256]         if HAVE_DTAB  else zeros
 *   range-coded payload: per record: [sel model if DO_SEL]
 *     [len as 4 bytes through len models, if DO_LEN or first record]
 *     [rev bit if DO_REV] [dup bit if DO_DEDUP; 1 => repeat previous]
 *     then per position the (mapped) quality through the context model:
 *       ctx' = ((qhist<<qshift)+qtab[q]) & (2^qbits-1)) << qloc
 *              | ptab[min(i+1,1023)] << ploc
 *              | dtab[min(delta,255)] << dloc  | sel << sloc, & 0xFFFF
 *       delta increments when consecutive mapped qualities differ.
 *
 * store_array(size): for v = 0,1,2,...: run of entries equal to v,
 * emitted with 255-continuation (array must be non-decreasing).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "fqzcomp_qual.h"
#include "c_range_coder.h"
#include "c_simple_model.h"
#include "varint.h"

#define GF_MULTI 1
#define GF_STAB  2
#define GF_REV   4

#define PF_DEDUP 2
#define PF_LEN   4
#define PF_SEL   8
#define PF_QMAP  16
#define PF_PTAB  32
#define PF_DTAB  64
#define PF_QTAB  128

typedef struct {
    uint16_t context;
    uint8_t pflags, max_sym;
    int qbits, qshift, qloc, sloc, ploc, dloc;
    uint8_t qmap[256];      /* code -> quality */
    uint8_t qmap_inv[256];  /* quality -> code */
    uint8_t qtab[256];
    uint16_t ptab[1024];
    uint8_t dtab[256];
} fqz_param;

/* ---- store_array / read_array ---- */
static void store_array(uint8_t **out, const uint16_t *arr, int size) {
    int i = 0, v = 0;
    while (i < size) {
        int r = 0;
        while (i < size && arr[i] == v) { r++; i++; }
        for (;;) {
            int b = r > 255 ? 255 : r;
            *(*out)++ = (uint8_t)b;
            if (b < 255) break;
            r -= 255;
        }
        v++;
    }
}

static int read_array(const uint8_t *in, uint64_t len, uint64_t *p,
                      uint16_t *arr, int size) {
    int i = 0, v = 0;
    while (i < size) {
        int r = 0, b;
        do {
            if (*p >= len) return -1;
            b = in[(*p)++];
            r += b;
        } while (b == 255);
        if (i + r > size) return -1;
        while (r-- > 0) arr[i++] = (uint16_t)v;
        v++;
        if (v > 65535) return -1;
    }
    return 0;
}

static int bitlen(int v) {
    int n = 0;
    while (v) { n++; v >>= 1; }
    return n;
}

/* ---- decode one parameter set ---- */
static int read_param(const uint8_t *in, uint64_t len, uint64_t *p,
                      fqz_param *pm) {
    int i;
    if (*p + 6 > len) return -1;
    pm->context = (uint16_t)(in[*p] | (in[*p + 1] << 8));
    *p += 2;
    pm->pflags = in[(*p)++];
    pm->max_sym = in[(*p)++];
    int b = in[(*p)++];
    pm->qbits = b >> 4; pm->qshift = b & 15;
    b = in[(*p)++];
    pm->qloc = b >> 4; pm->sloc = b & 15;
    if (*p >= len) return -1;
    b = in[(*p)++];
    pm->ploc = b >> 4; pm->dloc = b & 15;
    for (i = 0; i < 256; i++) {
        pm->qmap[i] = (uint8_t)i;
        pm->qmap_inv[i] = (uint8_t)i;
        pm->qtab[i] = (uint8_t)i;
        pm->dtab[i] = 0;
    }
    memset(pm->ptab, 0, sizeof pm->ptab);
    if (pm->pflags & PF_QMAP) {
        int n = pm->max_sym ? pm->max_sym : 256;
        if (*p + (uint64_t)n > len) return -1;
        for (i = 0; i < n; i++) {
            pm->qmap[i] = in[*p + i];
            pm->qmap_inv[pm->qmap[i]] = (uint8_t)i;
        }
        *p += (uint64_t)n;
    }
    if (pm->pflags & PF_QTAB) {
        uint16_t t[256];
        if (read_array(in, len, p, t, 256)) return -1;
        for (i = 0; i < 256; i++) pm->qtab[i] = (uint8_t)t[i];
    }
    if (pm->pflags & PF_PTAB) {
        if (read_array(in, len, p, pm->ptab, 1024)) return -1;
    }
    if (pm->pflags & PF_DTAB) {
        uint16_t t[256];
        if (read_array(in, len, p, t, 256)) return -1;
        for (i = 0; i < 256; i++) pm->dtab[i] = (uint8_t)t[i];
    }
    return 0;
}

typedef struct {
    SimpleModel *qual;       /* [1<<16], lazily initialised */
    uint8_t *qual_built;
    SimpleModel len[4];
    SimpleModel rev, dup, sel;
    int nsym;
} fqz_models;

static int models_init(fqz_models *m, int nsym, int nsel) {
    int i;
    m->nsym = nsym;
    m->qual = (SimpleModel *)malloc((size_t)65536 * sizeof(SimpleModel));
    m->qual_built = (uint8_t *)calloc(65536, 1);
    if (!m->qual || !m->qual_built) {
        free(m->qual); free(m->qual_built);
        return -1;
    }
    for (i = 0; i < 4; i++) SM_Init(&m->len[i], 256);
    SM_Init(&m->rev, 2);
    SM_Init(&m->dup, 2);
    SM_Init(&m->sel, nsel > 0 ? nsel : 1);
    return 0;
}

static SimpleModel *qmodel(fqz_models *m, int ctx) {
    if (!m->qual_built[ctx]) {
        SM_Init(&m->qual[ctx], m->nsym);
        m->qual_built[ctx] = 1;
    }
    return &m->qual[ctx];
}

static void models_free(fqz_models *m) {
    free(m->qual);
    free(m->qual_built);
}

char *fqz_compress(int vers, fqz_slice *s, char *in_, size_t in_size,
                   size_t *out_size, int strat, fqz_gparams *gp) {
    (void)vers; (void)strat; (void)gp;
    const uint8_t *in = (const uint8_t *)in_;
    int nrec = s ? s->num_records : 1;
    if (nrec <= 0) nrec = 1;

    /* per-parameter choices */
    fqz_param pm;
    memset(&pm, 0, sizeof pm);
    int seen[256];
    memset(seen, 0, sizeof seen);
    size_t i;
    for (i = 0; i < in_size; i++) seen[in[i]] = 1;
    int nsym = 0, sidx;
    for (sidx = 0; sidx < 256; sidx++) if (seen[sidx]) nsym++;
    int use_qmap = nsym > 0 && nsym <= 16;
    int code_of[256];
    int n_codes = 0;
    if (use_qmap) {
        for (sidx = 0; sidx < 256; sidx++)
            if (seen[sidx]) {
                pm.qmap[n_codes] = (uint8_t)sidx;
                code_of[sidx] = n_codes++;
            }
        pm.max_sym = (uint8_t)n_codes;
    } else {
        int maxq = 0;
        for (sidx = 0; sidx < 256; sidx++) if (seen[sidx]) maxq = sidx;
        for (sidx = 0; sidx < 256; sidx++) code_of[sidx] = sidx;
        pm.max_sym = (uint8_t)((maxq + 1) & 0xFF);  /* 0 => 256 */
        n_codes = maxq + 1;
        if (in_size == 0) { pm.max_sym = 1; n_codes = 1; }
    }
    pm.pflags = PF_LEN | PF_PTAB | PF_DTAB | (use_qmap ? PF_QMAP : 0);
    pm.qbits = 13; pm.qshift = 6; pm.qloc = 0;
    pm.sloc = 15; pm.ploc = 12; pm.dloc = 13;
    int k;
    for (k = 0; k < 1024; k++) pm.ptab[k] = (uint16_t)(bitlen(k) > 15 ? 15 : bitlen(k));
    for (k = 0; k < 256; k++) pm.dtab[k] = (uint8_t)(bitlen(k) > 7 ? 7 : bitlen(k));
    for (k = 0; k < 256; k++) pm.qtab[k] = (uint8_t)k;

    /* header */
    uint8_t *hdr = (uint8_t *)malloc(2 * in_size + 16384);
    if (!hdr) return NULL;
    uint8_t *hp = hdr;
    hp += var_put_u64(hp, NULL, in_size);
    *hp++ = 5;                    /* vers */
    *hp++ = 0;                    /* gflags */
    *hp++ = (uint8_t)(pm.context & 0xFF);
    *hp++ = (uint8_t)(pm.context >> 8);
    *hp++ = pm.pflags;
    *hp++ = pm.max_sym;
    *hp++ = (uint8_t)((pm.qbits << 4) | pm.qshift);
    *hp++ = (uint8_t)((pm.qloc << 4) | pm.sloc);
    *hp++ = (uint8_t)((pm.ploc << 4) | pm.dloc);
    if (use_qmap)
        for (k = 0; k < n_codes; k++) *hp++ = pm.qmap[k];
    store_array(&hp, pm.ptab, 1024);
    {
        uint16_t t[256];
        for (k = 0; k < 256; k++) t[k] = pm.dtab[k];
        store_array(&hp, t, 256);
    }

    /* range-coded body */
    fqz_models M;
    int nsym_model = n_codes + 1;
    if (nsym_model > 256) nsym_model = 256;
    if (models_init(&M, nsym_model, 1)) { free(hdr); return NULL; }
    RangeCoder rc;
    RC_StartEncode(&rc, hp);
    uint32_t qmask = (1u << pm.qbits) - 1;
    size_t pos = 0;
    int r;
    for (r = 0; r < nrec && pos < in_size; r++) {
        uint32_t rlen = s && s->len ? s->len[r]
                                    : (uint32_t)(in_size - pos);
        if (rlen > in_size - pos) rlen = (uint32_t)(in_size - pos);
        SM_EncodeSymbol(&M.len[0], &rc, rlen & 0xFF);
        SM_EncodeSymbol(&M.len[1], &rc, (rlen >> 8) & 0xFF);
        SM_EncodeSymbol(&M.len[2], &rc, (rlen >> 16) & 0xFF);
        SM_EncodeSymbol(&M.len[3], &rc, (rlen >> 24) & 0xFF);
        uint32_t qhist = 0, delta = 0, last = pm.context;
        int prevq = 0;
        uint32_t j;
        for (j = 0; j < rlen; j++) {
            int q = in[pos + j];
            int Q = code_of[q];
            SM_EncodeSymbol(qmodel(&M, (int)last), &rc, Q);
            qhist = (qhist << pm.qshift) + pm.qtab[Q];
            last = (qhist & qmask) << pm.qloc;
            last |= (uint32_t)pm.ptab[j + 1 < 1024 ? j + 1 : 1023]
                    << pm.ploc;
            last |= (uint32_t)pm.dtab[delta < 256 ? delta : 255] << pm.dloc;
            last &= 0xFFFF;
            delta += (prevq != Q);
            if (delta > 255) delta = 255;
            prevq = Q;
        }
        pos += rlen;
    }
    size_t rc_len = RC_FinishEncode(&rc);
    models_free(&M);
    *out_size = (size_t)(hp - hdr) + rc_len;
    return (char *)hdr;
}

char *fqz_decompress(char *in_, size_t in_size, size_t *out_size,
                     int *lengths, int nlengths) {
    const uint8_t *in = (const uint8_t *)in_;
    uint64_t p = 0;
    uint64_t total;
    {
        int n = var_get_u64((uint8_t *)in, (uint8_t *)in + in_size, &total);
        if (n <= 0) return NULL;
        p = (uint64_t)n;
    }
    if (p + 2 > in_size) return NULL;
    int fvers = in[p++];
    if (fvers != 5) return NULL;
    int gflags = in[p++];
    int nparam = 1;
    if (gflags & GF_MULTI) {
        if (p >= in_size) return NULL;
        nparam = in[p++];
        if (nparam <= 0) return NULL;
    }
    uint16_t stab[256];
    memset(stab, 0, sizeof stab);
    int max_sel = 0;
    if (gflags & GF_STAB) {
        if (p >= in_size) return NULL;
        max_sel = in[p++];
        if (read_array(in, in_size, &p, stab, 256)) return NULL;
    }
    fqz_param *pms = (fqz_param *)malloc((size_t)nparam * sizeof(fqz_param));
    if (!pms) return NULL;
    int pi;
    for (pi = 0; pi < nparam; pi++)
        if (read_param(in, in_size, &p, &pms[pi])) { free(pms); return NULL; }

    uint8_t *out = (uint8_t *)malloc(total ? total : 1);
    if (!out) { free(pms); return NULL; }
    int nsym_model = 0;
    for (pi = 0; pi < nparam; pi++) {
        int ns = pms[pi].max_sym ? pms[pi].max_sym : 256;
        if (ns + 1 > nsym_model) nsym_model = ns + 1;
    }
    if (nsym_model > 256) nsym_model = 256;
    fqz_models M;
    if (models_init(&M, nsym_model, max_sel + 1)) {
        free(pms); free(out);
        return NULL;
    }
    RangeCoder rc;
    RC_StartDecode(&rc, in + p, in + in_size);
    uint64_t pos = 0;
    int rec = 0;
    uint8_t *prev_rec = NULL;
    uint32_t prev_len = 0;
    while (pos < total) {
        int sel = 0;
        fqz_param *pm;
        if (gflags & GF_STAB) {
            sel = SM_DecodeSymbol(&M.sel, &rc);
            pm = &pms[stab[sel] < (uint16_t)nparam ? stab[sel] : 0];
        } else {
            pm = &pms[0];
        }
        uint32_t rlen;
        if ((pm->pflags & PF_LEN) || rec == 0) {
            rlen = (uint32_t)SM_DecodeSymbol(&M.len[0], &rc);
            rlen |= (uint32_t)SM_DecodeSymbol(&M.len[1], &rc) << 8;
            rlen |= (uint32_t)SM_DecodeSymbol(&M.len[2], &rc) << 16;
            rlen |= (uint32_t)SM_DecodeSymbol(&M.len[3], &rc) << 24;
            prev_len = rlen;
        } else {
            rlen = prev_len;
        }
        if (rlen > total - pos) { goto fail; }
        int rev = 0;
        if (gflags & GF_REV)
            rev = SM_DecodeSymbol(&M.rev, &rc);
        (void)rev;
        if (pm->pflags & PF_DEDUP) {
            if (SM_DecodeSymbol(&M.dup, &rc)) {
                if (!prev_rec || rlen != prev_len) goto fail;
                memcpy(out + pos, prev_rec, rlen);
                prev_rec = out + pos;
                pos += rlen;
                rec++;
                continue;
            }
        }
        uint32_t qmask = (1u << pm->qbits) - 1;
        uint32_t qhist = 0, delta = 0, last = pm->context;
        int prevq = 0;
        uint32_t j;
        for (j = 0; j < rlen; j++) {
            int Q = SM_DecodeSymbol(qmodel(&M, (int)last), &rc);
            out[pos + j] = pm->pflags & PF_QMAP ? pm->qmap[Q] : (uint8_t)Q;
            qhist = (qhist << pm->qshift) + pm->qtab[Q];
            last = (qhist & qmask) << pm->qloc;
            last |= (uint32_t)pm->ptab[j + 1 < 1024 ? j + 1 : 1023]
                    << pm->ploc;
            last |= (uint32_t)pm->dtab[delta < 256 ? delta : 255]
                    << pm->dloc;
            if (pm->pflags & PF_SEL)
                last |= (uint32_t)sel << pm->sloc;
            last &= 0xFFFF;
            delta += (prevq != Q);
            if (delta > 255) delta = 255;
            prevq = Q;
        }
        prev_rec = out + pos;
        prev_len = rlen;
        pos += rlen;
        rec++;
        if (lengths && rec <= nlengths)
            lengths[rec - 1] = (int)rlen;
    }
    models_free(&M);
    free(pms);
    *out_size = (size_t)total;
    return (char *)out;
fail:
    models_free(&M);
    free(pms);
    free(out);
    return NULL;
}
