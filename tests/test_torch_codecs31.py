"""The port's CRAM 3.1 host codecs (arith, fqzcomp, tok3 and their range
coder, htslib_tpu_torch/codecs/) against the JAX package's: every seeded
stream the JAX encoder writes decodes to the same bytes in both, the
port's encoders write the JAX encoders' bytes, and `cram_qual_hist` reads
a file whose QS blocks are FQZ- (and ARITH-) coded to the JAX function's
histogram."""
import numpy as np
import pytest

from htslib_tpu.codecs import arith as jarith
from htslib_tpu.codecs import fqzcomp as jfqz
from htslib_tpu.codecs import tok3 as jtok3
from htslib_tpu.codecs.rans4x16 import (O_CAT, O_NOSZ, O_ORDER1, O_PACK,
                                        O_RLE, O_STRIPE)
from htslib_tpu.cram import CramWriter
from htslib_tpu.cram.io import CramBlock as JBlock
from htslib_tpu.ops import device_stats as jds
from htslib_tpu.sam import SamHeader
from htslib_tpu.sam.cigar import parse_cigar
from htslib_tpu.sam.record import BamRecord
from htslib_tpu_torch.codecs import arith, fqzcomp, tok3
from htslib_tpu_torch.cram.io import CramBlock as TBlock
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import ARITH, CT_EXTERNAL, FQZ, TOK3
from htslib_tpu_torch.ops import device_stats as tds
from tests.test_torch_device_stats import (_jax_32bit, per_record_hist,
                                           walk_quals)

_ = _jax_32bit  # the module fixture pins the JAX reference to 32 bits


def _arith_cases():
    rng = np.random.default_rng(31)
    walk = np.clip(np.cumsum(rng.integers(-2, 3, 4000)) + 30, 2, 41)
    return [b"", b"Z", b"hello world" * 50,
            bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
            bytes(rng.choice([65, 67, 71, 84], 5000).astype(np.uint8)),
            walk.astype(np.uint8).tobytes()]


@pytest.mark.parametrize("flags", [0, O_ORDER1, O_CAT, O_PACK, O_RLE,
                                   O_STRIPE, O_PACK | O_ORDER1,
                                   O_STRIPE | O_ORDER1, O_NOSZ | O_RLE])
def test_arith_matches_jax(flags):
    for data in _arith_cases():
        comp = jarith.compress(data, flags)
        # a NOSZ stream leaves its length to the caller
        n = len(data) if flags & O_NOSZ else -1
        assert arith.uncompress(comp, n) == jarith.uncompress(comp, n) == data
        assert arith.compress(data, flags) == comp


def _quals(kind, seed):
    """Quality strings, NUL-joined as CRAM's QS series holds them, and
    their lengths: `walk` (correlated random walks), `binned` (four
    levels), `flat` (one value) and `ragged` (reads of 1..300)."""
    rng = np.random.default_rng(seed)
    lens = (rng.integers(1, 301, 60) if kind == "ragged"
            else rng.integers(80, 121, 150))
    out = bytearray()
    for ln in lens:
        if kind in ("walk", "ragged"):
            q = walk_quals(rng, 0, int(ln))
        elif kind == "binned":
            q = bytes(np.array([2, 12, 23, 37], np.uint8)[
                rng.choice(4, int(ln), p=[0.05, 0.1, 0.25, 0.6])])
        else:
            q = bytes([30]) * int(ln)
        out += q
    return bytes(out), [int(n) for n in lens]


@pytest.mark.parametrize("kind", ["walk", "binned", "flat", "ragged"])
@pytest.mark.parametrize("with_lens", [True, False])
def test_fqz_matches_jax(kind, with_lens):
    data, lens = _quals(kind, seed=len(kind))
    comp = jfqz.compress(data, lens if with_lens else None)
    assert fqzcomp.decompress(comp) == jfqz.decompress(comp) == data
    assert fqzcomp.compress(data, lens if with_lens else None) == comp


def _names(seed):
    rng = np.random.default_rng(seed)
    names = [f"HS18_09653:4:1315:{19857 + i * 7}:{61712 + (i * 13) % 999}"
             .encode() for i in range(500)]
    names += [f"SRR{int(rng.integers(1, 10**6)):07d}.{i}".encode()
              for i in range(200)]
    names += [b"read_odd_name", b"x", b"a1:b2:003:z", b"007leading",
              b"read_odd_name", b"0", b"9" * 12]
    return names


@pytest.mark.parametrize("use_arith", [0, 1])
def test_tok3_matches_jax(use_arith):
    names = _names(use_arith)
    blob = jtok3.encode_names(names, use_arith)
    want = b"\0".join(names) + b"\0"
    assert tok3.decode_names(blob) == jtok3.decode_names(blob) == want
    assert tok3.encode_names(names, use_arith) == blob


@pytest.mark.parametrize("method", [ARITH, FQZ, TOK3])
def test_cram_block_decodes_as_jax(method):
    """A block under each method decodes through `CramBlock.uncompress`
    to the JAX block's bytes; TOK3, as in the JAX package, is not held to
    its raw size."""
    data, lens = _quals("walk", seed=3)
    if method == ARITH:
        comp, raw = jarith.compress(data, O_ORDER1), len(data)
    elif method == FQZ:
        comp, raw = jfqz.compress(data, lens), len(data)
    else:
        comp, raw = jtok3.encode_names(_names(5)), 0
    args = (method, CT_EXTERNAL, tds.QS_CONTENT_ID, len(comp), raw, comp)
    assert TBlock(*args).uncompress() == JBlock(*args).uncompress()


def falling_quals(rng, ln):
    """Qualities shaped by position in the read, as an instrument's are:
    falling from 38 by one every 8 cycles, with noise of one step either
    way.  The position term is what FQZ models and order-1 coders do not,
    so the writer's trial stores such QS under FQZ."""
    pos = np.arange(ln)
    q = 38 - pos // 8 + rng.integers(-1, 2, ln)
    return bytes(np.clip(q, 2, 41).astype(np.uint8))


def write_profile_cram(path, profile, n=2000, seed=11):
    """A CRAM 3.1 of n seeded 100-bp records with `falling_quals`,
    written by the JAX CramWriter under `profile` ("small" stores QS
    under FQZ; "archive" adds the arith coder), 500 records a slice."""
    rng = np.random.default_rng(seed)
    hdr = SamHeader("@HD\tVN:1.6\tSO:coordinate\n"
                    "@SQ\tSN:chr1\tLN:1000000\n")
    starts = np.sort(rng.integers(0, 900_000, n))
    with CramWriter(path, hdr, version=(3, 1), seqs_per_slice=500,
                    profile=profile) as w:
        for i in range(n):
            r = BamRecord()
            r.qname = f"r{i:05d}".encode()
            r.tid = 0
            r.pos = int(starts[i])
            r.flag = 0
            r.mapq = 60
            r.cigar = parse_cigar("100M")
            r.set_seq("".join(rng.choice(list("ACGT"), 100)),
                      falling_quals(rng, 100))
            w.write(r)


def qs_methods(path):
    """The method of every QS block of a CRAM, read with the port's I/O."""
    out = []
    with open(path, "rb") as fp:
        io = CramIO(fp, read_file_definition(fp)[0])
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while (c := io.read_container_header()) is not None:
            end = c.data_offset + c.length
            while fp.tell() < end:
                blk = io.read_block()
                if (blk.content_type == CT_EXTERNAL
                        and blk.content_id == tds.QS_CONTENT_ID):
                    out.append(blk.method)
    return out


@pytest.mark.parametrize("profile", ["small", "archive"])
def test_cram_qual_hist_fqz_file_matches_jax(tmp_path, profile):
    path = str(tmp_path / f"{profile}.cram")
    write_profile_cram(path, profile)
    methods = qs_methods(path)
    assert FQZ in methods
    stats, jstats = {}, {}
    got = tds.cram_qual_hist(path, device="cpu", stats=stats)
    ref = jds.cram_qual_hist(path, interpret=True, stats=jstats)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, per_record_hist(path))
    assert stats == jstats
    assert stats["host_blocks"] >= methods.count(FQZ)
