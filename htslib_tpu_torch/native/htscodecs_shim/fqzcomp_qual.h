/* fqzcomp_qual.h — CRAM 3.1 FQZComp quality codec API (htscodecs-compatible
 * prototypes; reference call sites cram/cram_io.c:1686,1821). */
#ifndef HTSTPU_FQZCOMP_QUAL_H
#define HTSTPU_FQZCOMP_QUAL_H

#include <stdint.h>
#include <stdlib.h>

/* Per-slice metadata handed to the codec by the CRAM encoder
 * (layout fixed by cram/cram_io.c:1808-1819). */
typedef struct {
    int num_records;
    uint32_t *len;      /* per-record quality string lengths */
    uint32_t *flags;    /* per-record BAM flags */
} fqz_slice;

/* Optional explicit global params (NULL = auto-tune). */
typedef struct fqz_gparams fqz_gparams;

char *fqz_compress(int vers, fqz_slice *s, char *in, size_t in_size,
                   size_t *out_size, int strat, fqz_gparams *gp);
char *fqz_decompress(char *in, size_t in_size, size_t *out_size,
                     int *lengths, int nlengths);

#endif
