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
                 "htslib_tpu_torch/ops/rans_enc.py",
                 "htslib_tpu_torch/ops/huffman.py",
                 "htslib_tpu_torch/carry.py",
                 "htslib_tpu_torch/codecs/rans4x8.py",
                 "htslib_tpu_torch/codecs/rangecoder.py",
                 "htslib_tpu_torch/codecs/arith.py",
                 "htslib_tpu_torch/codecs/fqzcomp.py",
                 "htslib_tpu_torch/codecs/tok3.py",
                 "htslib_tpu_torch/cram/io.py"):
        assert want in rel


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("htslib_tpu.cram.io")
    assert not _forbidden("htslib_tpu_torch.cram.io")
