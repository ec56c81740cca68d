"""The port's host record model (htslib_tpu_torch/sam: cigar, header,
record) against the JAX package's (htslib_tpu/sam): SAM text, BAM bytes,
aux CRUD and the %g text of float aux values and B arrays, CIGAR text and
lengths, and the header's names.  Outputs are text and bytes: equality
is exact."""
import struct

import numpy as np
import pytest

from chip_smoke import LEG8_REFS, varied_bam_stream
from htslib_tpu.sam import cigar as jc
from htslib_tpu.sam import record as jr
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu_torch.sam import cigar as tc
from htslib_tpu_torch.sam import record as tr
from htslib_tpu_torch.sam.header import SamHeader


def _records(payload):
    """Each record's (offset, size) in a u32-framed stream."""
    out, p = [], 0
    while p < len(payload):
        n = struct.unpack_from("<I", payload, p)[0]
        out.append((p + 4, n))
        p += 4 + n
    return out


PAYLOAD = varied_bam_stream(400, 21)
JHDR = JHeader(refs=[(n, 300_000_000) for n in LEG8_REFS])


def test_records_give_the_jax_sam_text_and_bytes():
    hdr = SamHeader("@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{n}\tLN:300000000\n" for n in LEG8_REFS))
    for off, size in _records(PAYLOAD):
        j = jr.BamRecord.from_bam_buffer(PAYLOAD, off, size)
        t = tr.BamRecord.from_bam_buffer(PAYLOAD, off, size)
        want = j.to_sam(JHDR)
        assert t.to_sam(hdr) == want
        assert t.to_sam(JHDR) == want        # any header with ref_names
        assert t.to_bam_buffer() == j.to_bam_buffer()
        assert (t.seq, t.qual_str, t.endpos()) == (j.seq, j.qual_str,
                                                    j.endpos())


def test_aux_crud_matches_jax():
    rng = np.random.default_rng(2)
    tags = [b"NM", b"MD", b"AS", b"XS", b"RG", b"XF", b"XD", b"ZB", b"QQ"]
    for off, size in _records(PAYLOAD)[:150]:
        j = jr.BamRecord.from_bam_buffer(PAYLOAD, off, size)
        t = tr.BamRecord.from_bam_buffer(PAYLOAD, off, size)
        for tag in tags:
            gj, gt = j.get_aux(tag), t.get_aux(tag)
            if isinstance(gj, np.ndarray):
                assert np.array_equal(gj, gt) and gj.dtype == gt.dtype
            else:
                assert gj == gt
        for step in range(4):
            tag = tags[int(rng.integers(0, len(tags)))]
            if step % 2:
                assert j.del_aux(tag) == t.del_aux(tag)
            else:
                kinds = [("i", int(rng.integers(-70000, 70000))),
                         ("Z", "v%d" % step), ("f", 1.5e-7), ("A", "q"),
                         ("d", -2.25e300), ("B", ("s", [-3, 9000]))]
                kind, val = kinds[int(rng.integers(0, len(kinds)))]
                j.set_aux(tag, kind, val)
                t.set_aux(tag, kind, val)
            assert t.aux == j.aux
        assert tr.format_aux_blob(t.aux) == jr.format_aux_blob(j.aux)


@pytest.mark.parametrize("value", [0.0, -0.0, 1.0, 1e-5, 123456789.0,
                                   3.4e38, 1.17549435e-38, float("inf"),
                                   float("-inf"), float("nan"), 0.1,
                                   -2.5e-45, 65504.0])
def test_float_aux_text_is_c_percent_g(value):
    """f and d values and f arrays: the %g text, as the JAX formatter's."""
    for typ in ("f", "d"):
        blob = tr.encode_aux(b"XF", typ, value)
        assert blob == jr.encode_aux(b"XF", typ, value)
        assert tr.format_aux_blob(blob) == jr.format_aux_blob(blob)
    blob = tr.encode_aux(b"ZB", "B", ("f", [value, 1.0, value]))
    assert tr.format_aux_blob(blob) == jr.format_aux_blob(blob)
    assert tr._fmt_g(value) == jr._fmt_g(value)


@pytest.mark.parametrize("sub", list("cCsSiIf"))
def test_b_arrays_match_jax(sub):
    vals = {"c": [-128, 0, 127], "C": [0, 255], "s": [-32768, 5, 32767],
            "S": [0, 65535], "i": [-(1 << 31), 7, (1 << 31) - 1],
            "I": [0, (1 << 32) - 1], "f": [0.5, -1e-30, 3e12]}[sub]
    for v in (vals, vals[:1], []):
        blob = tr.encode_aux(b"ZB", "B", (sub, v))
        assert blob == jr.encode_aux(b"ZB", "B", (sub, v))
        assert tr.format_aux_blob(blob) == jr.format_aux_blob(blob)
        t = tr.BamRecord()
        t.aux = blob
        assert np.array_equal(t.get_aux("ZB"), jr.BamRecord.get_aux(t, "ZB"))


def test_long_cigar_round_trips_through_cg():
    """Past 65,535 ops the record writes a CG tag and reads it back into
    its CIGAR (bam_tag2cigar), as the JAX record does."""
    t = tr.BamRecord()
    t.tid, t.pos, t.flag, t.qname = 0, 100, 0, b"long"
    ops = np.array([(1 << 4) | (i % 2) for i in range(70000)], np.uint32)
    t.cigar = ops
    t.set_seq("A" * int(jc.cigar2qlen(ops)))
    t.aux = tr.encode_aux(b"NM", "i", 3)
    buf = t.to_bam_buffer()
    j = jr.BamRecord.from_bam_buffer(buf)
    back = tr.BamRecord.from_bam_buffer(buf)
    assert np.array_equal(back.cigar, ops) and np.array_equal(j.cigar, ops)
    assert back.aux == j.aux and back.bin == j.bin
    assert back.to_sam(JHDR) == j.to_sam(JHDR)


def test_cigar_text_and_lengths_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        ops = ((rng.integers(0, 5000, n) << 4)
               | rng.integers(0, 10, n)).astype(np.uint32)
        text = tc.format_cigar(ops)
        assert text == jc.format_cigar(ops)
        assert tc.cigar2rlen(ops) == jc.cigar2rlen(ops)
        beg = int(rng.integers(0, 1 << 29))
        end = beg + int(rng.integers(1, 1 << 20))
        assert tc.reg2bin(beg, end) == jc.reg2bin(beg, end)
    with pytest.raises(IndexError):       # op codes 10-15 have no letter
        tc.format_cigar(np.array([(5 << 4) | 12], np.uint32))


def test_header_names_match_jax():
    text = ("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:10\n@CO\tx\n"
            "@SQ\tLN:5\tSN:chrM\tAN:MT\n@RG\tID:a\n")
    h, j = SamHeader(text), JHeader(text)
    assert h.ref_names == j.ref_names == ["chr1", "chrM"]
    for tid in (-1, 0, 1, 2):
        assert h.tid2name(tid) == j.tid2name(tid)
    assert SamHeader(ref_names=["a", "b"]).nref == 2
