"""htsfile CLI (reference htsfile.c:227): identify file formats; -c view
content, -h headers only.  The port's copy of htslib_tpu/cli/htsfile.py
over its own format.py and readers, on the host:

    python -m htslib_tpu_torch.cli.htsfile file.bam file.vcf.gz
"""
from __future__ import annotations

import argparse
import sys

from htslib_tpu_torch.format import Category, detect_format_file


# the tool's --help text, the JAX tool's (argparse reflows it)
DESCRIPTION = ("htsfile CLI (reference htsfile.c:227): identify file formats; "
               "-c view content, -h headers only.")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="htsfile", description=DESCRIPTION,
                                add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-c", "--view", action="store_true")
    p.add_argument("-h", "--header-only", action="store_true", dest="hdr")
    p.add_argument("-H", "--no-header", action="store_true")
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)

    status = 0
    for fname in a.files:
        try:
            fmt = detect_format_file(fname)
        except Exception as e:
            print(f"htsfile: can't open \"{fname}\": {e}", file=sys.stderr)
            status = 2
            continue
        if not a.view:
            print(f"{fname}:\t{fmt.description()}")
            continue
        # view mode
        if fmt.category == Category.SEQUENCE_DATA:
            from htslib_tpu_torch.sam import hts_open_sam
            r = hts_open_sam(fname)
            if not a.no_header:
                sys.stdout.write(r.header.full_text_with_refs())
            if not a.hdr:
                for rec in r:
                    print(rec.to_sam(r.header))
            r.close()
        elif fmt.category == Category.VARIANT_DATA:
            from htslib_tpu_torch.vcf import open_vcf
            r = open_vcf(fname)
            if not a.no_header:
                sys.stdout.write(r.header.text())
            if not a.hdr:
                for rec in r:
                    print(rec.to_vcf(r.header))
            r.close()
        else:
            print(f"htsfile: can't view {fname}: not sequence or variant "
                  "data", file=sys.stderr)
            status = 2
    return status


if __name__ == "__main__":
    sys.exit(main())
