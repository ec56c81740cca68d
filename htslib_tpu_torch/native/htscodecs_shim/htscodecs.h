/* htscodecs.h — version introspection (htscodecs-compatible). */
#ifndef HTSTPU_HTSCODECS_H
#define HTSTPU_HTSCODECS_H

#include "version.h"

#define HTSCODECS_VERSION 100600
const char *htscodecs_version(void);

#endif
