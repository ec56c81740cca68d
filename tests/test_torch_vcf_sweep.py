"""The port's vcf_sweep.py against the JAX package's on seeded VCF and
BCF files: forward and backward sweeps record for record (as VCF text),
the chunk index the backward sweep builds, direction flips, and the
chunked read over files of many BGZF members."""
import numpy as np
import pytest

from htslib_tpu.vcf_sweep import VcfSweep as JSweep
from htslib_tpu_torch.bgzf import BgzfWriter
from htslib_tpu_torch.vcf_sweep import VcfSweep as TSweep
from tests.test_torch_vcfutils import seeded_vcf, to_bcf, to_vcf_gz

N_BIG = 20_000
BIG_HDR = ("##fileformat=VCFv4.2\n##contig=<ID=c1,length=100000000>\n"
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    vcf = str(d / "s.vcf")
    seeded_vcf(vcf, 4, n=90)
    to_bcf(vcf, str(d / "s.bcf"))
    to_vcf_gz(vcf, str(d / "s.vcf.gz"))
    big = str(d / "big.vcf.gz")
    rng = np.random.default_rng(8)
    with BgzfWriter(big, level=0) as w:
        w.write(BIG_HDR.encode())
        for i in range(N_BIG):
            w.write(f"c1\t{i + 1}\trs{i}\tA\t{'CGT'[i % 3]}\t"
                    f"{int(rng.integers(1, 99))}\tPASS\t.\n".encode())
    return {"vcf": vcf, "bcf": str(d / "s.bcf"), "vcf.gz":
            str(d / "s.vcf.gz"), "big": big}


def _sweep(cls, path, dirs, block_size):
    """The records a sweep gives for each direction in `dirs` (until
    None), as VCF text, and its chunk index."""
    out = []
    with cls(path, block_size=block_size) as sw:
        for d in dirs:
            got = []
            while True:
                r = sw.fwd() if d == "f" else sw.bwd()
                if r is None:
                    break
                got.append(r.to_vcf(sw.header))
            out.append(got)
        return out, sw._idx


@pytest.mark.parametrize("block", [1 << 10, 1 << 14, 1 << 16])
@pytest.mark.parametrize("dirs", ["f", "b", "fb", "bf", "bfb"])
@pytest.mark.parametrize("name", ["vcf.gz", "bcf", "big"])
def test_sweep_matches_jax(files, name, dirs, block):
    got, gidx = _sweep(TSweep, files[name], dirs, block)
    want, widx = _sweep(JSweep, files[name], dirs, block)
    assert got == want and gidx == widx
    fwd = [g for d, g in zip(dirs, got) if d == "f"]
    bwd = [g for d, g in zip(dirs, got) if d == "b"]
    for b in bwd:
        assert b == list(reversed(fwd[0] if fwd else _sweep(
            TSweep, files[name], "f", block)[0][0]))


def test_plain_vcf_forward_matches_jax(files):
    got, _ = _sweep(TSweep, files["vcf"], "f", 1 << 16)
    want, _ = _sweep(JSweep, files["vcf"], "f", 1 << 16)
    assert got == want and len(got[0]) == 90


def test_backward_sweep_chunks(files):
    """The big file is read back in chunks (the index has many marks,
    and the buffer never holds the file), as in the JAX sweep."""
    with TSweep(files["big"], block_size=1 << 12) as sw:
        first = sw.bwd()
        assert first.pos == N_BIG - 1
        assert len(sw._idx) > 4 and len(sw._buf) < N_BIG // 2
        n = 1
        while sw.bwd() is not None:
            n += 1
        assert n == N_BIG
        assert sw.fwd().pos == 0
