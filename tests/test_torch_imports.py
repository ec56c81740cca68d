"""The port imports neither JAX nor the JAX package: an `ast` walk over
every module of htslib_tpu_torch/ and over chip_smoke.py."""
import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(REPO, "htslib_tpu_torch", "**",
                                        "*.py"), recursive=True)
                 + [os.path.join(REPO, "chip_smoke.py")])


def _imported_modules(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "htslib_tpu")


def test_sources_found():
    rel = {os.path.relpath(p, REPO) for p in SOURCES}
    for want in ("chip_smoke.py", "htslib_tpu_torch/entry.py",
                 "htslib_tpu_torch/ops/rans_nx16.py",
                 "htslib_tpu_torch/ops/rans_nx16_o1.py",
                 "htslib_tpu_torch/ops/rans4x8.py",
                 "htslib_tpu_torch/ops/rans.py",
                 "htslib_tpu_torch/ops/bgzf_device.py",
                 "htslib_tpu_torch/ops/inflate.py",
                 "htslib_tpu_torch/ops/rans_enc.py",
                 "htslib_tpu_torch/ops/huffman.py",
                 "htslib_tpu_torch/carry.py",
                 "htslib_tpu_torch/codecs/rans4x8.py",
                 "htslib_tpu_torch/codecs/rangecoder.py",
                 "htslib_tpu_torch/codecs/arith.py",
                 "htslib_tpu_torch/codecs/fqzcomp.py",
                 "htslib_tpu_torch/codecs/tok3.py",
                 "htslib_tpu_torch/cram/io.py",
                 "htslib_tpu_torch/cram/__init__.py",
                 "htslib_tpu_torch/cram/batch.py",
                 "htslib_tpu_torch/cram/codecs.py",
                 "htslib_tpu_torch/cram/decode.py",
                 "htslib_tpu_torch/cram/encode.py",
                 "htslib_tpu_torch/cram/refs.py",
                 "htslib_tpu_torch/cram/index.py",
                 "htslib_tpu_torch/cram/external.py",
                 "htslib_tpu_torch/hts_expr.py",
                 "htslib_tpu_torch/faidx.py",
                 "htslib_tpu_torch/ops/bam2sam.py",
                 "htslib_tpu_torch/ops/probaln.py",
                 "htslib_tpu_torch/realn.py",
                 "htslib_tpu_torch/sam/cigar.py",
                 "htslib_tpu_torch/sam/header.py",
                 "htslib_tpu_torch/sam/record.py",
                 "htslib_tpu_torch/sam/bam.py",
                 "htslib_tpu_torch/bgzf.py",
                 "htslib_tpu_torch/parallel/distributed.py",
                 "htslib_tpu_torch/parallel/mesh.py",
                 "htslib_tpu_torch/parallel/launch.py",
                 "htslib_tpu_torch/format.py",
                 "htslib_tpu_torch/util/log.py",
                 "htslib_tpu_torch/vcf/__init__.py",
                 "htslib_tpu_torch/vcf/header.py",
                 "htslib_tpu_torch/vcf/record.py",
                 "htslib_tpu_torch/vcf/io.py",
                 "htslib_tpu_torch/vcf/merge.py",
                 "htslib_tpu_torch/index.py",
                 "htslib_tpu_torch/tbx.py",
                 "htslib_tpu_torch/regidx.py",
                 "htslib_tpu_torch/sam/indexing.py",
                 "htslib_tpu_torch/sam/samtext.py",
                 "htslib_tpu_torch/hfile.py",
                 "htslib_tpu_torch/remote/__init__.py",
                 "htslib_tpu_torch/remote/s3.py",
                 "htslib_tpu_torch/remote/gcs.py",
                 "htslib_tpu_torch/remote/multipart.py",
                 "htslib_tpu_torch/pipeline.py",
                 "htslib_tpu_torch/opts.py",
                 "htslib_tpu_torch/hts.py",
                 "htslib_tpu_torch/sam/hts_open.py",
                 "htslib_tpu_torch/sam/fastq.py",
                 "htslib_tpu_torch/sam/mods.py",
                 "htslib_tpu_torch/sam/batch.py",
                 "htslib_tpu_torch/pileup.py",
                 "htslib_tpu_torch/parallel/pileup_shard.py",
                 "htslib_tpu_torch/errmod.py",
                 "htslib_tpu_torch/kfunc.py",
                 "htslib_tpu_torch/synced_reader.py",
                 "htslib_tpu_torch/vcfutils.py",
                 "htslib_tpu_torch/vcf_sweep.py",
                 "htslib_tpu_torch/probe_pallas_gather.py",
                 "htslib_tpu_torch/probe_rans_ablate.py",
                 "htslib_tpu_torch/refcache.py",
                 "htslib_tpu_torch/util/memory.py",
                 "htslib_tpu_torch/cli/__init__.py",
                 "htslib_tpu_torch/cli/bgzip.py",
                 "htslib_tpu_torch/cli/tabix.py",
                 "htslib_tpu_torch/cli/htsfile.py",
                 "htslib_tpu_torch/cli/annot_tsv.py",
                 "htslib_tpu_torch/native/__init__.py"):
        assert want in rel


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("htslib_tpu.cram.io")
    assert not _forbidden("htslib_tpu_torch.cram.io")
