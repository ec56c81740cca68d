#ifndef HTSTPU_HC_UTILS_H
#define HTSTPU_HC_UTILS_H
#endif
