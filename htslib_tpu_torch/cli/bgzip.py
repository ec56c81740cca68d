"""bgzip CLI (reference bgzip.c:217): block compress/decompress with
random access, .gzi indexing, test mode and byte-identical rebgzip.  The
port's copy of htslib_tpu/cli/bgzip.py:

    python -m htslib_tpu_torch.cli.bgzip [-i] file        # file.gz
    python -m htslib_tpu_torch.cli.bgzip -d|-t file.gz

`-d` and `-t` on a BGZF file inflate its members on the card
(bgzf.inflate_blocks, kernel X4), BATCH members a call, each CRC32 and
ISIZE checked on the host; standard input and plain gzip or uncompressed
input are read by the host reader, as the JAX tool reads everything.
Members are deflated on the host by bgzf.deflate_blocks: libdeflate
through the native library, the JAX tool's bytes, or zlib where
`htslib_tpu_torch.native.native` is None, the JAX tool's bytes without
its native library.  `-@` is parsed and not used, as in the JAX tool.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from htslib_tpu_torch import _build
from htslib_tpu_torch.bgzf import (BGZF_BLOCK_SIZE, BGZF_EOF, BGZFReader,
                                   BlockTable, GziIndex, deflate_blocks,
                                   inflate_blocks, read_file, scan_blocks)

BATCH = 4096    # members a device call: 256 MiB of output at most


# the tool's --help text, the JAX tool's (argparse reflows it)
DESCRIPTION = ("bgzip CLI (reference bgzip.c:217): block compress/decompress "
               "with random access, .gzi indexing, test mode and "
               "byte-identical rebgzip.")


def device_chunks(path: str, device):
    """The uncompressed bytes of the BGZF file `path`, BATCH members at a
    time, inflated on `device`."""
    raw = read_file(path)
    table = scan_blocks(raw)
    for lo in range(0, table.n, BATCH):
        part = BlockTable(table.coffsets[lo:lo + BATCH],
                          table.csizes[lo:lo + BATCH],
                          table.usizes[lo:lo + BATCH])
        yield inflate_blocks(raw, part, device=device)[0]


def host_chunks(r: BGZFReader):
    while True:
        chunk = r.read(1 << 20)
        if not chunk:
            return
        yield chunk


def open_input(src: str, device):
    """(reader, the uncompressed bytes in chunks) of `src`: a BGZF file's
    members go to the card whole; the host reader keeps the rest
    (standard input, plain gzip, uncompressed input)."""
    r = BGZFReader(src)
    if r.is_bgzf and src != "-":
        return r, device_chunks(src, _build.resolve_device(device))
    return r, host_chunks(r)


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="bgzip", description=DESCRIPTION)
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-c", "--stdout", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-i", "--index", action="store_true",
                   help="compress and create a .gzi index")
    p.add_argument("-I", "--index-name")
    p.add_argument("-b", "--offset", type=int,
                   help="decompress from virtual file offset")
    p.add_argument("-s", "--size", type=int, default=-1,
                   help="decompress SIZE bytes with -b")
    p.add_argument("-t", "--test", action="store_true")
    p.add_argument("-g", "--rebgzip", action="store_true",
                   help="recompress using an existing .gzi for "
                        "byte-identical blocks")
    p.add_argument("-l", "--compress-level", type=int, default=-1)
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=1)
    p.add_argument("file", nargs="?")
    a = p.parse_args(argv)

    src = a.file or "-"
    if a.test:
        r, chunks = open_input(src, device)
        with r:
            if not r.is_bgzf:
                print(f"{src}: not BGZF", file=sys.stderr)
                return 1
            for _ in chunks:
                pass
            ok = r.check_eof()
        return 0 if ok in (1, 2) else 1

    if a.offset is not None:
        with BGZFReader(src) as r:
            r.load_index(a.index_name)
            r.useek(a.offset)
            data = r.read(a.size if a.size >= 0 else -1)
        sys.stdout.buffer.write(data)
        return 0

    if a.decompress:
        out = "-" if (a.stdout or src == "-") else src[:-3] \
            if src.endswith(".gz") else src + ".out"
        if out != "-" and os.path.exists(out) and not a.force:
            print(f"{out} already exists; use -f to overwrite",
                  file=sys.stderr)
            return 1
        r, chunks = open_input(src, device)
        with r:
            sink = sys.stdout.buffer if out == "-" else open(out, "wb")
            for chunk in chunks:
                sink.write(chunk)
            if out != "-":
                sink.close()
                if not a.keep and src != "-":
                    os.unlink(src)
        return 0

    # compress
    out = "-" if (a.stdout or src == "-") else src + ".gz"
    if out != "-" and os.path.exists(out) and not a.force:
        print(f"{out} already exists; use -f to overwrite", file=sys.stderr)
        return 1
    if src == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(src, "rb") as fp:
            data = fp.read()
    if a.rebgzip:
        # reproduce the original block sizes from the .gzi index
        gzi = GziIndex.load(a.index_name or src + ".gz.gzi")
        bounds = [int(u) for u in gzi.uoffsets] + [len(data)]
        chunks = [data[bounds[i]:bounds[i + 1]]
                  for i in range(len(bounds) - 1) if bounds[i + 1] > bounds[i]]
    else:
        chunks = [data[i:i + BGZF_BLOCK_SIZE]
                  for i in range(0, len(data), BGZF_BLOCK_SIZE)]
    blocks = deflate_blocks(chunks, a.compress_level)
    sink = sys.stdout.buffer if out == "-" else open(out, "wb")
    co, uo = [0], [0]
    for raw, blk in zip(chunks, blocks):
        sink.write(blk)
        co.append(co[-1] + len(blk))
        uo.append(uo[-1] + len(raw))
    sink.write(BGZF_EOF)
    if out != "-":
        sink.close()
        if not a.keep and src != "-":
            os.unlink(src)
    if a.index:
        idx = GziIndex(np.array(co[:-1], np.uint64),
                       np.array(uo[:-1], np.uint64))
        idx.save(a.index_name or (out if out != "-" else src) + ".gzi")
    return 0


if __name__ == "__main__":
    sys.exit(main())
