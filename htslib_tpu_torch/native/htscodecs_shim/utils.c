/* No shared utilities needed by the shim. */
typedef int htstpu_hc_utils_unused;
