"""CRAM data model constants (reference cram/cram_structs.h)."""
from __future__ import annotations

# block compression methods (cram_structs.h / spec)
RAW = 0
GZIP = 1
BZIP2 = 2
LZMA = 3
RANS = 4        # rANS 4x8, CRAM 3.0
RANSPR = 5      # rANS 4x16, CRAM 3.1
ARITH = 6
FQZ = 7
TOK3 = 8

# block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_MAPPED_SLICE = 2
CT_UNMAPPED_SLICE = 3
CT_EXTERNAL = 4
CT_CORE = 5

# encoding (record codec) ids
E_NULL = 0
E_EXTERNAL = 1
E_GOLOMB = 2
E_HUFFMAN = 3
E_BYTE_ARRAY_LEN = 4
E_BYTE_ARRAY_STOP = 5
E_BETA = 6
E_SUBEXP = 7
E_GOLOMB_RICE = 8
E_GAMMA = 9
# CRAM 4.0
E_VARINT_UNSIGNED = 41
E_VARINT_SIGNED = 42
E_CONST_BYTE = 43
E_CONST_INT = 44
E_XPACK = 50
E_XRLE = 51
E_XDELTA = 52

# cram record flags (cram_structs.h CRAM_FLAG_*)
CRAM_FLAG_PRESERVE_QUAL_SCORES = 0x1
CRAM_FLAG_DETACHED = 0x2
CRAM_FLAG_MATE_DOWNSTREAM = 0x4
CRAM_FLAG_NO_SEQ = 0x8
CRAM_FLAG_EXPLICIT_TLEN = 0x10

# mate flags
CRAM_M_REVERSE = 1
CRAM_M_UNMAP = 2

# data series two-char keys used in the encoding map
DATA_SERIES = [
    "BF", "CF", "AP", "RG", "MQ", "NS", "MF", "TS", "NP", "NF", "TL",
    "FN", "FC", "FP", "DL", "BA", "BS", "IN", "RL", "QS", "BB", "QQ",
    "TC", "TN", "SC", "HC", "PD", "RS", "RI", "RN", "TM", "TV",
]

L1 = {}  # base -> 0..4 (cram_io.c:5174)
for _i, _b in enumerate("ACGT"):
    L1[ord(_b)] = _i
    L1[ord(_b.lower())] = _i


def l1(base: int) -> int:
    return L1.get(base, 4)
