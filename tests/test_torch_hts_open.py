"""The port's generic open and options (htslib_tpu_torch/hts.py,
sam/hts_open.py, opts.py) against the JAX package's (htslib_tpu/hts.py,
sam/hts_open.py, opts.py): the reader `hts_open` returns for each format
(BAM, CRAM 3.0 with a reference and 3.1 without, SAM plain and bgzipped,
VCF plain and bgzipped, BCF, FASTA, FASTQ plain and gzipped) and its
records; writers by mode letters with options, whose files read back
the same records in both packages; the option grammar
(`hts_opt_add`, `hts_parse_opt_list`, `hts_parse_format`) and
`hts_opt_apply`'s effect on the CRAM reader and writer; and the
crypt4gh redirect through an HTS_PATH plugin.  Inputs are seeded;
records are compared as SAM or VCF text."""
import gzip
import os

import jax
import pytest

import htslib_tpu.hfile as jhf
from chip_smoke import leg12_vcf
from htslib_tpu.hts import hts_open as jhts_open
from htslib_tpu.opts import hts_opt_add as jopt_add
from htslib_tpu.opts import hts_opt_apply as jopt_apply
from htslib_tpu.opts import hts_parse_format as jparse_format
from htslib_tpu.opts import hts_parse_opt_list as jparse_list
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.hts_open import hts_open_sam as jhts_open_sam
from htslib_tpu_torch import hfile as thf
from htslib_tpu_torch.bgzf import BgzfWriter
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.hts import hts_open
from htslib_tpu_torch.opts import (hts_opt_add, hts_opt_apply,
                                   hts_parse_format, hts_parse_opt_list)
from htslib_tpu_torch.sam import hts_open_sam
from htslib_tpu_torch.vcf.header import BcfHeader
from htslib_tpu_torch.vcf.io import vcf_file_to_bcf
from test_torch_cram import cram_records, write_bam, write_fasta


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def _text(reader):
    """A reader's records as text: SAM lines, or VCF lines."""
    with reader:
        hdr = reader.header
        return [r.to_vcf(hdr) if hasattr(r, "to_vcf") else r.to_sam(hdr)
                for r in reader]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded files of every format `hts_open` reads: {name: path}; the
    FASTA the CRAMs were written against under "fasta"."""
    d = tmp_path_factory.mktemp("hts")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 41)
    hdr, recs = cram_records(400, 43, seqs)
    out = {"fasta": fa, "bam": write_bam(str(d / "x.bam"), hdr, recs)}
    for tag, ref, ver in (("cram30", fa, (3, 0)), ("cram31", None, (3, 1))):
        out[tag] = str(d / f"x.{tag}")
        tbatch.bam_to_cram_file(out["bam"], out[tag], ref=ref, version=ver,
                                seqs_per_slice=150)
    sam = (hdr.full_text_with_refs() + "".join(
        r.to_sam(hdr) + "\n" for r in recs)).encode()
    with open(str(d / "x.sam"), "wb") as fp:
        fp.write(sam)
    out["sam"] = str(d / "x.sam")
    out["sam.gz"] = str(d / "x.sam.gz")
    with BgzfWriter(out["sam.gz"]) as w:
        w.write(sam)
    vcf = leg12_vcf(300, samples=3, seed=44)
    out["vcf"] = str(d / "x.vcf")
    with open(out["vcf"], "wb") as fp:
        fp.write(vcf)
    out["vcf.gz"] = str(d / "x.vcf.gz")
    with BgzfWriter(out["vcf.gz"]) as w:
        w.write(vcf)
    out["bcf"] = str(d / "x.bcf")
    vcf_file_to_bcf(out["vcf"], out["bcf"])
    fq = b"".join(b"@q%d/%d\n%s\n+\n%s\n" % (
        i, 1 + i % 2, recs[i].seq.encode(), b"I" * recs[i].l_qseq)
        for i in range(50) if recs[i].l_qseq)
    out["fq"] = str(d / "x.fq")
    with open(out["fq"], "wb") as fp:
        fp.write(fq)
    out["fq.gz"] = str(d / "x.fq.gz")
    with open(out["fq.gz"], "wb") as fp:
        fp.write(gzip.compress(fq))
    out["fa"] = fa
    return out


KINDS = {"bam": "BamReader", "cram30": "CramReader", "cram31": "CramReader",
         "sam": "SamReader", "sam.gz": "SamReader", "vcf": "VcfReader",
         "vcf.gz": "VcfReader", "bcf": "BcfReader", "fq": "FastxReader",
         "fq.gz": "FastxReader", "fa": "FastxReader"}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dispatch_matches_jax(files, kind):
    ref = files["fasta"] if kind == "cram30" else None
    ours = hts_open(files[kind], ref=ref)
    theirs = jhts_open(files[kind], ref=ref)
    assert type(ours).__name__ == type(theirs).__name__ == KINDS[kind]
    assert type(ours).__module__.startswith("htslib_tpu_torch.")
    got = _text(ours)
    assert got and got == _text(theirs)
    if kind not in ("vcf", "vcf.gz", "bcf"):
        sam_side = hts_open_sam(files[kind], ref=ref)
        assert type(sam_side).__name__ == KINDS[kind]
        assert _text(sam_side) == _text(jhts_open_sam(files[kind], ref=ref))


def test_hts_open_sam_refuses_variant_data_as_jax(files):
    for fn in (hts_open_sam, jhts_open_sam):
        with pytest.raises(IOError, match="not sequence data"):
            fn(files["bcf"])


MODES = [("w", [], "SamReader"), ("wz", [], "SamReader"),
         ("wb", ["level=1"], "BamReader"), ("wb0", [], "BamReader"),
         ("wc", ["seqs_per_slice=120", "reference"], "CramReader"),
         ("wc", ["fast", "slices_per_container=2"], "CramReader")]


@pytest.mark.parametrize("mode,opts,reader", MODES,
                         ids=[f"{m}-{','.join(o) or 'none'}"
                              for m, o, _ in MODES])
def test_writers_by_mode_letters(files, tmp_path, mode, opts, reader):
    """The port and the JAX package write the BAM's records by the same
    mode and options; each package reads each file back as the same
    records: the source's, or for CRAM (which keeps no =/X CIGAR ops and
    regenerates MD and NM) the JAX package's round trip."""
    fa = files["fasta"]
    opts = [f"reference={fa}" if o == "reference" else o for o in opts]
    ref = fa if any(o.startswith("reference") for o in opts) else None
    src = hts_open(files["bam"])
    recs = list(src)
    hdr = src.header
    jsrc = jhts_open(files["bam"])
    jrecs = list(jsrc)
    want = [r.to_sam(hdr) for r in recs]
    paths = {}
    for who, open_, h, rs in (("port", hts_open, hdr, recs),
                              ("jax", jhts_open, jsrc.header, jrecs)):
        paths[who] = str(tmp_path / f"{who}.out")
        w = open_(paths[who], mode, header=h, opts=opts)
        for r in rs:
            w.write(r)
        w.close()
    if reader == "CramReader":
        with jhts_open(paths["jax"], ref=fa) as r:
            want = [x.to_sam(r.header) for x in r]
        assert len(want) == len(recs)
    for path in paths.values():
        for open_ in (hts_open, jhts_open):
            r = open_(path, ref=ref or fa)
            assert type(r).__name__ == reader
            assert [x.to_sam(r.header) for x in r] == want
            r.close()


@pytest.mark.parametrize("mode", ["w", "wz", "wb"])
def test_variant_writers_by_mode_letters(files, tmp_path, mode):
    src = hts_open(files["vcf"])
    hdr_text = src.header.text()
    recs = list(src)
    want = [r.to_vcf(src.header) for r in recs]
    out = str(tmp_path / "v.out")
    w = hts_open(out, mode, header=src.header)
    for r in recs:
        w.write(r)
    w.close()
    jout = str(tmp_path / "j.out")
    jsrc = jhts_open(files["vcf"])
    jw = jhts_open(jout, mode, header=jsrc.header)
    for r in jsrc:
        jw.write(r)
    jw.close()
    for path in (out, jout):
        assert _text(hts_open(path)) == _text(jhts_open(path)) == want
    assert isinstance(src.header, BcfHeader) and hdr_text


OPT_STRINGS = ["decode_md=0", "seqs_per_slice=0x100", "nthreads=4",
               "reference=/x/ref.fa", "filter=mapq>5", "small", "ARCHIVE",
               "use_tok", "level=9", "required_fields=0x1ff",
               "embed_ref=2", "lossy_names=1", "no_ref", "version=3.1"]


def test_option_grammar_matches_jax():
    for s in OPT_STRINGS:
        assert hts_opt_add([], s) == jopt_add([], s)
    joined = ",".join(OPT_STRINGS[:6]) + ",,level=1"
    assert hts_parse_opt_list([], joined) == jparse_list([], joined)
    for bad in ("", "nosuch=1", "level=x", "seqs_per_slice"):
        for fn in (hts_opt_add, jopt_add):
            if bad == "seqs_per_slice":
                assert fn([], bad) == [("seqs_per_slice", 1)]
                continue
            with pytest.raises(ValueError):
                fn([], bad)


@pytest.mark.parametrize("spec", ["sam", "bam,level=3", "cram,no_ref,small",
                                  "vcf", "bcf", "fastq.gz", "FA",
                                  "fasta.gz,nthreads=2", "sam.gz"])
def test_parse_format_matches_jax(spec):
    f, o = hts_parse_format(spec)
    jf, jo = jparse_format(spec)
    assert (f.category.name, f.format.name, f.compression.name) == (
        jf.category.name, jf.format.name, jf.compression.name)
    assert o == jo
    for fn in (hts_parse_format, jparse_format):
        with pytest.raises(ValueError, match="unknown format"):
            fn("d4,level=1")


READER_OPTS = ["decode_md=0", "required_fields=0x3", "ignore_md5=1",
               "reference", "filter=mapq >= 20", "nthreads=2", "level=4"]
WRITER_OPTS = ["seqs_per_slice=77", "slices_per_container=0", "embed_ref=1",
               "lossy_names=1", "small", "archive", "fast", "level=9",
               "no_ref", "reference", "nthreads=3", "decode_md=0"]


def _state(obj):
    """The fields the options set.  nthreads sets no field of either
    package's CRAM objects (the JAX encoder's thread count is its CPUs,
    the port's None: it builds containers in order), so it is not read."""
    enc = getattr(obj, "_enc", None)
    if enc is not None:
        keys = ("seqs_per_slice", "slices_per_container", "embed_ref",
                "lossy_names", "use_tok", "use_fqz", "_use_bz2",
                "_use_arith", "_archive", "_level")
        return {k: getattr(enc, k) for k in keys} | {
            "refs": enc.refs is None}
    return {"decode_md": obj.decode_md,
            "required_fields": obj.required_fields,
            "ignore_md5": obj.refs.ignore_md5,
            "fai": obj.refs.fai is None,
            "filter": getattr(obj, "_filter", None) is None}


@pytest.mark.parametrize("opt", READER_OPTS + WRITER_OPTS)
def test_opt_apply_on_cram_objects_matches_jax(files, tmp_path, opt, capfd):
    """Each option applied to the port's CramReader, then to its
    CramWriter, changes the fields the JAX option changes on the JAX
    objects, and warns where the JAX one warns."""
    fa = files["fasta"]
    opt = f"reference={fa}" if opt == "reference" else opt
    parsed, jparsed = hts_opt_add([], opt), jopt_add([], opt)
    r, jr = hts_open(files["cram30"], ref=fa), jhts_open(files["cram30"],
                                                         ref=fa)
    hdr = r.header
    w = hts_open(str(tmp_path / "o.cram"), "wc", header=hdr, ref=fa)
    jw = jhts_open(str(tmp_path / "j.cram"), "wc",
                   header=JHeader(hdr.text), ref=fa)
    for ours, theirs in ((r, jr), (w, jw)):
        capfd.readouterr()
        hts_opt_apply(ours, parsed)
        warned = "not applicable" in capfd.readouterr().err
        jopt_apply(theirs, jparsed)
        assert warned == ("not applicable" in capfd.readouterr().err)
        assert _state(ours) == _state(theirs)
    for x in (r, jr, w, jw):
        x.close()


def test_crypt4gh_redirect(tmp_path, monkeypatch):
    """hts_crypt4gh_redirect (hts.c:1430): input with the crypt4gh magic
    opens again through the `crypt4gh` scheme that an HTS_PATH plugin
    registers; without the plugin both packages raise IOError."""
    sam = (b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:100\n"
           b"r1\t0\tc1\t5\t60\t4M\t*\t0\t0\tACGT\tFFFF\n")
    enc = tmp_path / "t.sam.c4gh"
    enc.write_bytes(b"crypt4gh" + bytes(b ^ 0x5A for b in sam))
    for mod, hf in (("htslib_tpu_torch", thf), ("htslib_tpu", jhf)):
        monkeypatch.delenv("HTS_PATH", raising=False)
        monkeypatch.setattr(hf, "_remote_loaded", False)
        monkeypatch.delitem(hf._scheme_handlers, "crypt4gh", raising=False)
        opener = hts_open if hf is thf else jhts_open
        with pytest.raises(IOError, match="crypt4gh"):
            opener(str(enc))
        plug = tmp_path / mod
        plug.mkdir()
        (plug / "hfile_c4gh.py").write_text(
            f"from {mod}.hfile import MemFile\n"
            "def _open(url, mode):\n"
            "    raw = open(url[len('crypt4gh:'):], 'rb').read()[8:]\n"
            "    return MemFile(bytes(b ^ 0x5A for b in raw), 'r', name=url)\n"
            "def hfile_plugin_init(add):\n"
            "    add('crypt4gh', _open)\n")
        monkeypatch.setenv("HTS_PATH", str(plug))
        monkeypatch.setattr(hf, "_remote_loaded", False)
        with opener(str(enc)) as r:
            recs = list(r)
        assert len(recs) == 1 and recs[0].qname == b"r1"
        assert recs[0].pos == 4
        monkeypatch.delitem(hf._scheme_handlers, "crypt4gh")


def test_writing_needs_a_header(tmp_path):
    for fn in (hts_open, jhts_open):
        with pytest.raises(ValueError, match="header"):
            fn(str(tmp_path / "x.bam"), "wb")
    assert not os.path.exists(str(tmp_path / "x.bam"))
