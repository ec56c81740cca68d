"""The committed CRAM 3.1 fixture whose QS blocks are STRIPE (0x0C,
0x0D) and PACK (0x84, 0x85) streams, through the port's `cram_qual_hist`
(the STRIPE and PACK front ends over kernels B3/B6, plain versions on the
CPU) against the JAX package's in Pallas interpret mode and a per-record
bincount.  The JAX lane compiles four runs for this file (order 0 and 1,
64 and 256 bins), so the fixture has a file of its own."""
import os

import jax
import pytest

from htslib_tpu_torch.cram import CRAM_EOF_START
from htslib_tpu_torch.cram.io import CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import RANSPR
from htslib_tpu_torch.ops import device_stats as tds
from test_torch_device_stats import (check_committed_fixture,
                                     write_stripe_pack_cram)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIPE_PACK = os.path.join(REPO, "htslib_tpu_torch", "testdata",
                           "qual_stripe_pack.cram")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def test_committed_stripe_pack_fixture(tmp_path):
    check_committed_fixture(tmp_path, STRIPE_PACK, write_stripe_pack_cram,
                            ["stripe", "pack", None])


def test_stripe_pack_fixture_wires():
    """The fixture holds STRIPE blocks of both orders and PACK blocks of
    both orders."""
    flags = set()
    with open(STRIPE_PACK, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None or c.ref_seq_start == CRAM_EOF_START:
                break
            while fp.tell() < c.data_offset + c.length:
                blk = io.read_block()
                if blk.content_id == tds.QS_CONTENT_ID \
                        and blk.method == RANSPR:
                    flags.add(blk.data[0])
    assert {0x0C, 0x0D, 0x84, 0x85} <= flags


