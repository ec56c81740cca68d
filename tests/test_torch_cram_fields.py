"""Required-fields pruning in the port's CRAM decoder
(htslib_tpu_torch/cram/decode.py `_active_series`, `decode_slice(...,
required_fields=)`, `CramReader(required_fields=)`) against the JAX
package's pure-Python decoder, which is its own path whenever pruning is
on (its native slice decoder is switched off here throughout).

The files are those of tests/test_torch_cram.py's corpus at a smaller
size: the port's encoder (the JAX Python encoder's bytes) and the JAX
native encoder (its own block layout), CRAM 3.0 and 3.1, with and
without a reference.  For each mask the active series, the records
(BAM bytes, including the fields left unspecified) and which blocks stay
compressed must equal the JAX decoder's."""
import jax
import pytest

from htslib_tpu.cram import CramReader as JReader
from htslib_tpu.cram import decode as jdecode
from htslib_tpu.cram.io import CramIO as JIO
from htslib_tpu.cram.io import read_file_definition as jread_def
from htslib_tpu.cram.refs import RefRegistry as JRegistry
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu_torch.cram import CRAM_EOF_START, CramReader
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram import decode as tdecode
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.refs import RefRegistry
from test_torch_cram import cram_records, jax_cram, write_bam, write_fasta

D = tdecode
MASKS = ([0] + [1 << i for i in range(13)]
         + [D.SAM_QUAL | D.SAM_SEQ, D.SAM_SEQ | D.SAM_CIGAR,
            D.SAM_CIGAR | D.SAM_TLEN, D.SAM_AUX | D.SAM_RGAUX,
            D.SAM_QNAME | D.SAM_AUX, D.SAM_FLAG | D.SAM_POS | D.SAM_MAPQ,
            D.SAM_QUAL | D.SAM_QNAME, (1 << 13) - 1])
MASK_IDS = [f"{m:#x}" for m in MASKS]
FILES = [(enc, ver, ref) for enc in ("port", "jax_native")
         for ver in ((3, 0), (3, 1)) for ref in (False, True)]
FILE_IDS = [f"{e}-{v[0]}.{v[1]}-{'ref' if r else 'noref'}"
            for e, v, r in FILES]


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(autouse=True)
def _jax_python(monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{(encoder, version, with_ref): path} over 200 records at 70 a
    slice (3 slices: one reference, both, one and the unmapped reads), and the
    FASTA."""
    d = tmp_path_factory.mktemp("fields")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 15)
    hdr, recs = cram_records(200, 17, seqs)
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    mp = pytest.MonkeyPatch()
    files = {}
    for enc, ver, with_ref in FILES:
        opts = dict(ref=fa if with_ref else None, version=ver,
                    seqs_per_slice=70)
        p = str(d / f"{enc}_{ver[0]}{ver[1]}_{int(with_ref)}.cram")
        if enc == "port":
            tbatch.bam_to_cram_file(bam, p, **opts)
        else:
            jax_cram(bam, p, True, mp, **opts)
        files[(enc, ver, with_ref)] = p
    return {"fasta": fa, "files": files}


def _slices(path, io_cls, read_def, dec):
    """(compression header, slice header, blocks) of every slice."""
    out = []
    with open(path, "rb") as fp:
        ver, _ = read_def(fp)
        io = io_cls(fp, ver)
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None or (c.ref_seq_id == -1
                             and c.ref_seq_start == CRAM_EOF_START):
                break
            end = c.data_offset + c.length
            ch = dec.decode_compression_header(io.read_block(), ver[0])
            while fp.tell() < end:
                sh = dec.decode_slice_header(io.read_block(), ver[0])
                out.append((ch, sh, [io.read_block()
                                     for _ in range(sh.num_blocks)]))
    return ver, out


def test_sam_bits_match_jax():
    for name in ("QNAME", "FLAG", "RNAME", "POS", "MAPQ", "CIGAR", "RNEXT",
                 "PNEXT", "TLEN", "SEQ", "QUAL", "AUX", "RGAUX"):
        assert getattr(D, "SAM_" + name) == getattr(jdecode, "SAM_" + name)
    assert D._FEAT_SERIES == jdecode._FEAT_SERIES


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_active_series_matches_jax(corpus, mask):
    seen = set()
    for key, path in corpus["files"].items():
        _, ours = _slices(path, CramIO, read_file_definition, tdecode)
        _, theirs = _slices(path, JIO, jread_def, jdecode)
        for (ch, _, _), (jch, _, _) in zip(ours, theirs):
            got = tdecode._active_series(ch, mask)
            assert got == jdecode._active_series(jch, mask), key
            if got is not None:
                seen.add((len(got[0]), got[1], len(got[2])))
    assert (mask == 0) == (not seen)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_reader_records_match_jax(corpus, mask):
    for key in (("port", (3, 0), True), ("port", (3, 1), False),
                ("jax_native", (3, 0), False),
                ("jax_native", (3, 1), True)):
        path = corpus["files"][key]
        ref = corpus["fasta"] if key[2] else None
        with CramReader(path, ref=ref, required_fields=mask) as r:
            ours = [rec.to_bam_buffer() for rec in r]
        with JReader(path, ref=ref, required_fields=mask) as r:
            theirs = [rec.to_bam_buffer() for rec in r]
        assert len(ours) == 200 and ours == theirs, key


@pytest.mark.parametrize("key", FILES, ids=FILE_IDS)
def test_pruned_blocks_stay_compressed_as_jax(corpus, key):
    """decode_slice over the same blocks: the records and which blocks
    were uncompressed equal the JAX decoder's, mask by mask; a mask of
    one field leaves some block compressed."""
    path = corpus["files"][key]
    ref = corpus["fasta"] if key[2] else None
    pruned = 0
    for mask in MASKS:
        ver, ours = _slices(path, CramIO, read_file_definition, tdecode)
        _, theirs = _slices(path, JIO, jread_def, jdecode)
        with CramReader(path) as r:
            hdr = r.header
        refs = RefRegistry(hdr, fasta=ref)
        jhdr = JHeader(hdr.text)
        jrefs = JRegistry(jhdr, fasta=ref)
        for (ch, sh, bl), (jch, jsh, jbl) in zip(ours, theirs):
            recs = tdecode.decode_slice(ch, sh, bl, hdr, refs.get, ver[0],
                                        required_fields=mask)
            jrecs = jdecode.decode_slice(jch, jsh, jbl, jhdr, jrefs.get,
                                         ver[0], required_fields=mask)
            assert [r.to_bam_buffer() for r in recs] == [
                r.to_bam_buffer() for r in jrecs], (mask, key)
            left = [b._uncompressed is None for b in bl]
            assert left == [b._uncompressed is None for b in jbl], mask
            pruned += mask in (D.SAM_QNAME, D.SAM_FLAG) and any(left)
    assert pruned
