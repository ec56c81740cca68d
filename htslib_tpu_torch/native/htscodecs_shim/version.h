#ifndef HTSTPU_HC_VERSION_H
#define HTSTPU_HC_VERSION_H
#define HTSCODECS_VERSION_TEXT "1.6.0-htstpu-shim"
#endif
