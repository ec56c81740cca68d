"""tabix CLI (reference tabix.c:614): build TBI/CSI indexes over bgzipped
text, query regions, print/replace headers.  The port's copy of
htslib_tpu/cli/tabix.py over its own tbx.py and BGZF reader and writer,
on the host:

    python -m htslib_tpu_torch.cli.tabix -p vcf file.vcf.gz
    python -m htslib_tpu_torch.cli.tabix file.vcf.gz chr1:1000-2000
"""
from __future__ import annotations

import argparse
import sys

from htslib_tpu_torch.bgzf import BGZFReader, BGZFWriter
from htslib_tpu_torch.tbx import PRESETS, Tabix, TbxConf


# the tool's --help text, the JAX tool's (argparse reflows it)
DESCRIPTION = ("tabix CLI (reference tabix.c:614): build TBI/CSI indexes over "
               "bgzipped text, query regions, print/replace headers.")


def _reheader(fname: str, header_path: str, meta_char: int,
              out=None) -> int:
    """tabix -r (reheader_file, tabix.c:437): skip the leading meta lines
    of the bgzipped file, emit the new header + body re-bgzipped to
    stdout."""
    out = out or sys.stdout.buffer
    with BGZFReader(fname) as fp:
        data = bytes(fp.read_all())
    pos = 0
    if data[:1] and data[0] == meta_char:
        while pos < len(data):
            e = data.find(b"\n", pos)
            if e < 0:
                raise IOError(f"no body in the file: {fname}")
            pos = e + 1
            if pos >= len(data) or data[pos] != meta_char:
                break
    hdr = open(header_path, "rb").read()
    if hdr and not hdr.endswith(b"\n"):
        hdr += b"\n"
    w = BGZFWriter(out if not isinstance(out, str) else out)
    w.write(hdr)
    w.write(data[pos:])
    w.close()
    return 0


def _header_lines(fname: str, meta_char: int):
    """Leading meta lines of a bgzipped text file."""
    with BGZFReader(fname) as fp:
        lines = []
        while True:
            ln = fp.readline()
            if not ln or not ln.startswith(bytes([meta_char])):
                break
            lines.append(ln.rstrip(b"\n").decode())
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tabix", description=DESCRIPTION,
                                add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-p", "--preset", choices=sorted(PRESETS))
    p.add_argument("-s", "--sequence", type=int, default=0)
    p.add_argument("-b", "--begin", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=0)
    p.add_argument("-S", "--skip-lines", type=int, default=0)
    p.add_argument("-c", "--comment", default="#")
    p.add_argument("-0", "--zero-based", action="store_true", dest="zero")
    p.add_argument("-C", "--csi", action="store_true")
    p.add_argument("-m", "--min-shift", type=int, default=14)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-l", "--list-chroms", action="store_true")
    p.add_argument("-h", "--print-header", action="store_true")
    p.add_argument("-H", "--only-header", action="store_true")
    p.add_argument("-r", "--reheader")
    p.add_argument("-R", "--regions", dest="regions_file")
    p.add_argument("-T", "--targets")
    p.add_argument("-D", action="store_true", dest="no_download",
                   help="do not download a remote index")
    p.add_argument("--separate-regions", action="store_true")
    p.add_argument("--cache", type=int, default=10)
    p.add_argument("--verbosity", type=int, default=3)
    p.add_argument("-@", "--threads", type=int, default=1)
    p.add_argument("file")
    p.add_argument("regions", nargs="*")
    a = p.parse_args(argv)

    if a.verbosity is not None:
        from htslib_tpu_torch.util.log import hts_set_log_level
        hts_set_log_level(a.verbosity)

    meta_char = ord(a.comment[0]) if a.comment else ord("#")
    if a.preset:
        meta_char = PRESETS[a.preset].meta_char

    if a.reheader:
        return _reheader(a.file, a.reheader, meta_char)

    build = a.preset is not None or a.sequence or a.begin
    if (build and not a.regions and not a.list_chroms
            and not a.only_header and not a.regions_file and not a.targets):
        if a.preset:
            conf = PRESETS[a.preset]
        else:
            from htslib_tpu_torch.tbx import TBX_UCSC
            conf = TbxConf(TBX_UCSC if a.zero else 0, a.sequence, a.begin,
                           a.end, meta_char, a.skip_lines)
        Tabix.build(a.file, conf, min_shift=a.min_shift if a.csi else 0)
        return 0

    tbx = None
    try:
        tbx = Tabix.load_for(a.file)
    except (FileNotFoundError, IOError):
        if not a.only_header:
            raise
    if a.list_chroms:
        for n in tbx.names:
            print(n)
        return 0
    if a.only_header or a.print_header:
        mc = tbx.conf.meta_char if tbx is not None else meta_char
        for ln in _header_lines(a.file, mc):
            print(ln)
        if a.only_header:
            return 0
    with BGZFReader(a.file) as fp:
        region_list = list(a.regions)
        if a.regions_file:
            region_list += [l.strip() for l in open(a.regions_file)
                            if l.strip()]
        if a.targets:
            region_list += [l.strip() for l in open(a.targets) if l.strip()]
        for region in region_list:
            if a.separate_regions:
                print(f"{chr(meta_char)}{region}")
            for line in tbx.query_region(fp, region):
                print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
