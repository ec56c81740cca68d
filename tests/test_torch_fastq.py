"""The port's FASTA/FASTQ reader and writer (htslib_tpu_torch/sam/fastq.py)
against the JAX package's (htslib_tpu/sam/fastq.py): seeded reads with
/1 /2 suffixes, CASAVA comments (pass and filter flags, letter and
digit barcodes), SAM aux tags in comments, UMIs in Illumina names,
SRA-style names, sequences over several lines, as FASTQ and FASTA,
plain, bgzipped, gzipped and through an `HFile`, under the option sets
of htslib's fastq tests; `FastxReader` records are compared as BAM
bytes and `fastq_format1` text byte for byte."""
import gzip

import numpy as np
import pytest

from htslib_tpu.hfile import hopen as jhopen
from htslib_tpu.sam.fastq import FastqState as JState
from htslib_tpu.sam.fastq import FastxReader as JReader
from htslib_tpu.sam.fastq import fastq_format1 as jformat1
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch.bgzf import BgzfWriter
from htslib_tpu_torch.hfile import hopen
from htslib_tpu_torch.sam.fastq import FastqState, FastxReader, fastq_format1
from htslib_tpu_torch.sam.record import FREVERSE


def fastx_text(n: int, seed: int, fasta: bool = False) -> bytes:
    """n seeded reads in rotating name styles (plain, /1 /2 /3,
    CASAVA with a letter or digit barcode and Y/N filter, aux comments,
    Illumina names with a UMI, SRA "run.n name" pairs), sequences of
    1-150 bases, some split over several lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 7
        name = f"r{i}"
        comment = ""
        if kind == 1:
            name += f"/{1 + i % 3}"
        elif kind == 2:
            bc = "".join(rng.choice(list("ACGTN"), 6)) if i % 2 else "0"
            comment = f"{1 + i % 2}:{'YN'[i % 3 > 0]}:0:{bc}"
            if i % 4 == 2:
                comment += "\tXA:Z:x"
        elif kind == 3:
            comment = (f"BC:Z:ACGT\tRG:Z:g{i % 3}\tXI:i:{i}\tXF:f:1.5"
                       "\tnot_a_tag\tab:c\tZB:B:c,1,-2")
        elif kind == 4:
            umi = "".join(rng.choice(list("ACGTN"), 8))
            name = f"M0:{i}:FC:1:1101:{1000 + i}:{2000 + i}:{umi}"
            if i % 2:
                name += "/1"
        elif kind == 5:
            name = f"SRR1.{i} orig{i}/{1 + i % 2}"
        elif kind == 6:
            comment = "plain comment with spaces"
        length = int(rng.integers(1, 151))
        seq = "".join(rng.choice(list("ACGTN"), length))
        qual = "".join(chr(33 + q) for q in rng.integers(2, 42, length))
        head = (">" if fasta else "@") + name + (
            (" " if kind != 3 else "\t") + comment if comment else "")
        cut = length if i % 5 else max(1, length // 3)
        seq_lines = [seq[j:j + cut] for j in range(0, length, cut)]
        if fasta:
            out.append("\n".join([head] + seq_lines) + "\n")
        else:
            q_lines = [qual[j:j + cut] for j in range(0, length, cut)]
            out.append("\n".join([head] + seq_lines + ["+"] + q_lines)
                       + "\n")
    return "".join(out).encode()


READ_OPTS = [{}, {"aux": True}, {"casava": True},
             {"casava": True, "barcode": "OX"}, {"aux": "RG,XI"},
             {"name2": True}, {"umi": "1"}, {"umi": "RX,OX"},
             {"casava": True, "aux": True, "umi": "1"}]


def _write(path, data, how):
    if how == "bgzf":
        with BgzfWriter(path, level=1) as w:
            w.write(data)
    elif how == "gzip":
        with open(path, "wb") as fp:
            fp.write(gzip.compress(data))
    else:
        with open(path, "wb") as fp:
            fp.write(data)
    return path


def _read_both(path, fasta, opts, hfile=False):
    src, jsrc = ((hopen(path), jhopen(path)) if hfile else (path, path))
    r = FastxReader(src, fasta=fasta, state=FastqState(fasta=fasta, **opts))
    j = JReader(jsrc, fasta=fasta, state=JState(fasta=fasta, **opts))
    with r, j:
        return ([b.to_bam_buffer() for b in r],
                [b.to_bam_buffer() for b in j])


@pytest.mark.parametrize("fasta", [False, True])
@pytest.mark.parametrize("opts", READ_OPTS,
                         ids=[",".join(f"{k}={v}" for k, v in o.items())
                              or "default" for o in READ_OPTS])
def test_fastx_reader_matches_jax(tmp_path, fasta, opts):
    path = _write(str(tmp_path / "r.fx"), fastx_text(300, 5, fasta),
                  "plain")
    ours, theirs = _read_both(path, fasta, opts)
    assert len(ours) == 300 and ours == theirs


@pytest.mark.parametrize("how", ["bgzf", "gzip", "hfile"])
def test_fastx_reader_over_compressed_and_hfile(tmp_path, how):
    data = fastx_text(500, 6)
    path = _write(str(tmp_path / "r.fq"), data,
                  "plain" if how == "hfile" else how)
    ours, theirs = _read_both(path, False, {"casava": True, "aux": True},
                              hfile=how == "hfile")
    assert len(ours) == 500 and ours == theirs


@pytest.mark.parametrize("bad", [b"@r1\nACGT\n", b"@r1\nACGT\n+\nFF\n",
                                 b"@r1\nAC\n+\nFFFF\n", b"r1\nACGT\n"])
def test_malformed_fastq_raises_as_jax(tmp_path, bad):
    path = _write(str(tmp_path / "bad.fq"), b"@ok\nA\n+\nF\n" + bad,
                  "plain")
    for reader in (FastxReader, JReader):
        with pytest.raises(IOError):
            list(reader(path))


WRITE_OPTS = [({}, False), ({"aux": True, "rnum": True}, False),
              ({"aux": True, "rnum": True}, True), ({"casava": True}, False),
              ({"casava": True, "barcode": "OX"}, False),
              ({"aux": "RG", "rnum": True}, False),
              ({"rnum": True, "umi": "1"}, False)]


@pytest.mark.parametrize("opts,fasta", WRITE_OPTS)
def test_fastq_format1_matches_jax(tmp_path, opts, fasta):
    """Records read with every tag (CASAVA, aux, UMI), every third
    reversed, written back by fastq_format1 under htslib's write
    options."""
    path = _write(str(tmp_path / "w.fq"), fastx_text(300, 7), "plain")
    read = {"casava": True, "aux": True, "umi": "1"}
    with FastxReader(path, state=FastqState(**read)) as r:
        recs = list(r)
    for i, b in enumerate(recs):
        if i % 3 == 0:
            b.flag |= FREVERSE
    state, jstate = (FastqState(fasta=fasta, **opts),
                     JState(fasta=fasta, **opts))
    for b in recs:
        jb = JRecord.from_bam_buffer(b.to_bam_buffer())
        assert fastq_format1(state, b) == jformat1(jstate, jb)
    # what fastq_format1 writes reads back as the same reads
    if not opts and not fasta:
        fwd = [b for b in recs if not b.flag & FREVERSE]
        text = "".join(fastq_format1(state, b) for b in fwd).encode()
        back = _write(str(tmp_path / "back.fq"), text, "plain")
        with FastxReader(back) as r:
            assert [(x.qname, x.seq, x.qual) for x in r] == [
                (b.qname, b.seq, b.qual) for b in fwd]
