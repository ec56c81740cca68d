/* Version string for hts.c:149 introspection. */
#include "htscodecs.h"
const char *htscodecs_version(void) { return HTSCODECS_VERSION_TEXT; }
