"""The hts option system: `key=value` option strings and format names
(the port's copy of htslib_tpu/opts.py; reference hts_opt_add
hts.c:1098, hts_parse_opt_list hts.c:1247, hts_parse_format hts.c:1337,
hts_set_opt hts.c:1967).

Options travel as a parsed list and are applied to the reader or
writer that takes them (`hts_opt_apply`): the port's `CramReader`
(`decode_md`, `required_fields`, `refs`, `set_filter`), its
`CramWriter`'s encoder (`_enc`: `seqs_per_slice`,
`slices_per_container`, `embed_ref`, `lossy_names`, `set_profile`,
`set_level`, `refs`) and any object with `level`, `seqs_per_slice`,
`nthreads` or `set_filter`.  An unknown option name is an error, as in
htslib; a known one that the object cannot use is ignored with a
warning.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

from htslib_tpu_torch.format import Category, Compression, Format, HtsFormat
from htslib_tpu_torch.util.log import log_warning

# canonical option names (enum hts_fmt_option, htslib/hts.h:295-333)
_INT_OPTS = {
    "decode_md", "verbosity", "seqs_per_slice", "bases_per_slice",
    "slices_per_container", "embed_ref", "no_ref", "pos_delta",
    "ignore_md5", "use_bzip2", "use_rans", "use_lzma", "use_tok",
    "use_fqz", "use_arith", "multi_seq_per_slice", "nthreads",
    "cache_size", "block_size", "level", "store_md", "store_nm",
    "lossy_names", "required_fields",
}
_STR_OPTS = {"reference", "version", "prefix", "filter", "range"}
_FLAG_PROFILES = {"fast", "normal", "small", "archive"}

HtsOptList = List[Tuple[str, Union[int, str]]]


def hts_opt_add(opts: HtsOptList, arg: str) -> HtsOptList:
    """Parse one ``key[=value]`` option string onto ``opts``
    (hts_opt_add, hts.c:1098; bare keys mean boolean 1)."""
    if not arg:
        raise ValueError("empty option")
    if "=" in arg:
        key, val = arg.split("=", 1)
    else:
        key, val = arg, "1"
    key = key.lower()
    if key in _FLAG_PROFILES:
        opts.append(("profile", key))
    elif key in _INT_OPTS:
        try:
            opts.append((key, int(val, 0)))
        except ValueError:
            raise ValueError(f"option {key!r} requires an integer value")
    elif key in _STR_OPTS:
        opts.append((key, val))
    else:
        raise ValueError(f"unknown option {arg.split('=')[0]!r}")
    return opts


def hts_parse_opt_list(opts: HtsOptList, s: str) -> HtsOptList:
    """Tokenise ``(key(=value)?,)*`` (hts_parse_opt_list, hts.c:1247)."""
    for tok in s.split(","):
        if tok:
            hts_opt_add(opts, tok)
    return opts


_FORMATS = {
    "sam": (Category.SEQUENCE_DATA, Format.sam, Compression.no_compression),
    "sam.gz": (Category.SEQUENCE_DATA, Format.sam, Compression.bgzf),
    "bam": (Category.SEQUENCE_DATA, Format.bam, Compression.bgzf),
    "cram": (Category.SEQUENCE_DATA, Format.cram, Compression.custom),
    "vcf": (Category.VARIANT_DATA, Format.vcf, Compression.no_compression),
    "bcf": (Category.VARIANT_DATA, Format.bcf, Compression.bgzf),
    "fastq": (Category.SEQUENCE_DATA, Format.fastq_format,
              Compression.no_compression),
    "fq": (Category.SEQUENCE_DATA, Format.fastq_format,
           Compression.no_compression),
    "fastq.gz": (Category.SEQUENCE_DATA, Format.fastq_format,
                 Compression.bgzf),
    "fq.gz": (Category.SEQUENCE_DATA, Format.fastq_format, Compression.bgzf),
    "fasta": (Category.SEQUENCE_DATA, Format.fasta_format,
              Compression.no_compression),
    "fa": (Category.SEQUENCE_DATA, Format.fasta_format,
           Compression.no_compression),
    "fasta.gz": (Category.SEQUENCE_DATA, Format.fasta_format,
                 Compression.bgzf),
    "fa.gz": (Category.SEQUENCE_DATA, Format.fasta_format, Compression.bgzf),
}


def hts_parse_format(s: str) -> Tuple[HtsFormat, HtsOptList]:
    """Parse ``fmtname[,opt[=val]]...`` (hts_parse_format, hts.c:1337)."""
    name, _, rest = s.partition(",")
    key = name.strip().lower()
    if key not in _FORMATS:
        raise ValueError(f"unknown format {name!r}")
    cat, fmt, comp = _FORMATS[key]
    f = HtsFormat()
    f.category = cat
    f.format = fmt
    f.compression = comp
    opts: HtsOptList = []
    if rest:
        hts_parse_opt_list(opts, rest)
    return f, opts


def hts_opt_apply(obj, opts: Optional[HtsOptList]) -> None:
    """Apply recognised options to a reader/writer (hts_opt_apply,
    hts.c:1185; hts_set_opt hts.c:1967).  Options the object has no use
    for are skipped."""
    if not opts:
        return
    for key, val in opts:
        if key == "decode_md" and hasattr(obj, "decode_md"):
            obj.decode_md = bool(val)
        elif key == "required_fields" and hasattr(obj, "required_fields"):
            obj.required_fields = int(val)
        elif key == "ignore_md5" and hasattr(obj, "refs"):
            obj.refs.ignore_md5 = bool(val)
        elif key == "seqs_per_slice" and hasattr(obj, "_enc"):
            obj._enc.seqs_per_slice = int(val)
        elif key == "slices_per_container" and hasattr(obj, "_enc"):
            obj._enc.slices_per_container = max(1, int(val))
        elif key == "embed_ref" and hasattr(obj, "_enc"):
            obj._enc.embed_ref = int(val)
        elif key == "lossy_names" and hasattr(obj, "_enc"):
            obj._enc.lossy_names = int(val)
        elif key == "profile" and hasattr(obj, "_enc"):
            obj._enc.set_profile(str(val))
        elif key == "level" and hasattr(obj, "_enc"):
            obj._enc.set_level(int(val))
        elif key == "no_ref" and hasattr(obj, "_enc"):
            if val:
                obj._enc.refs = None
        elif key == "seqs_per_slice" and hasattr(obj, "seqs_per_slice"):
            obj.seqs_per_slice = int(val)
        elif key == "level" and hasattr(obj, "level"):
            obj.level = int(val)
        elif key == "nthreads":
            # batch-native paths size their own worker teams; accepted
            # for compatibility (HTS_OPT_NTHREADS)
            if hasattr(obj, "nthreads"):
                obj.nthreads = int(val)
        elif key == "reference":
            if hasattr(obj, "refs"):
                from htslib_tpu_torch.cram.refs import RefRegistry
                obj.refs = RefRegistry(obj.header, fasta=str(val))
            elif hasattr(obj, "_enc") and hasattr(obj._enc, "refs"):
                from htslib_tpu_torch.cram.refs import RefRegistry
                obj._enc.refs = RefRegistry(obj.header, fasta=str(val))
        elif key == "filter" and hasattr(obj, "set_filter"):
            obj.set_filter(str(val))
        else:
            log_warning("option %s not applicable here; ignored", key)
