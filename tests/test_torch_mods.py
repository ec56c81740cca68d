"""The port's base-modification walker (htslib_tpu_torch/sam/mods.py)
against the JAX package's (htslib_tpu/sam/mods.py): seeded reads with
MM/ML tags of one to three channels (letter codes, several codes in one
channel, ChEBI numbers; implicit `.`, explicit `?` and unmarked
channels; both strands of the read and of the modification; N as the
canonical base; MN given or not), and malformed tags.  `parse`'s return
code, `at_next_pos` at every position, `next_basemod` and `at_qpos`
walks, and the channel queries must be equal, with and without
HTS_MOD_REPORT_UNCHECKED."""
import numpy as np
import pytest

from htslib_tpu.sam.mods import BaseModState as JState
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch.sam.mods import HTS_MOD_REPORT_UNCHECKED, BaseModState
from htslib_tpu_torch.sam.record import FREVERSE, BamRecord, encode_aux

CODES = ["m", "h", "mh", "a", "76792", "o", "b"]


def mod_records(n: int, seed: int):
    """n seeded records with MM/ML tags: valid ones, and one in eight
    malformed (a bad base letter, a missing strand, an ML of the wrong
    length, a delta past the read, MN not the length, no ';')."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(0 if i % 29 == 0 else 5, 120))
        seq = "".join(rng.choice(list("ACGTN"), length, p=[.3, .3, .2, .15,
                                                          .05]))
        b = BamRecord()
        b.qname = b"m%d" % i
        b.flag = FREVERSE if i % 3 == 1 else 0
        b.set_seq(seq if length else "*",
                  bytes([30] * length) if length else None)
        mm, ml = [], []
        for _ in range(int(rng.integers(0, 4))):
            base = str(rng.choice(list("ACGTN")))
            strand = "+-"[int(rng.random() < 0.2)]
            codes = str(rng.choice(CODES))
            mark = str(rng.choice(["", ".", "?"]))
            have = seq.count(base) if base != "N" else length
            deltas = []
            left = have
            while left > 0 and rng.random() < 0.7:
                d = int(rng.integers(0, max(1, left)))
                if d + 1 > left:
                    break
                deltas.append(d)
                left -= d + 1
            mm.append(base + strand + codes + mark
                      + "".join(f",{d}" for d in deltas) + ";")
            width = 1 if codes.isdigit() else len(codes)
            ml += [int(q) for q in rng.integers(0, 256, width * len(deltas))]
        bad = i % 8 == 7
        if bad:
            how = i // 8 % 6
            if how == 0:
                mm.append("X+m,0;")
            elif how == 1:
                mm.append("Cm,0;")
            elif how == 2:
                ml.append(5)
            elif how == 3:
                mm.append(f"C+m,{length + 5};")
            elif how == 5:
                mm.append("A+a,0")
        if mm or (bad and i // 8 % 6 == 4):
            b.aux += encode_aux(b"MM", "Z", "".join(mm))
        if ml or i % 4 == 0:
            b.aux += encode_aux(b"ML", "B", ("C", np.array(ml, np.uint8)))
        if i % 5 == 0 or (bad and i // 8 % 6 == 4):
            b.aux += encode_aux(b"MN", "i", length + (
                3 if bad and i // 8 % 6 == 4 else 0))
        out.append(b)
    return out


def _mods(ms):
    return [(m.modified_base, m.canonical_base, m.strand, m.qual)
            for m in ms]


@pytest.mark.parametrize("flags", [0, HTS_MOD_REPORT_UNCHECKED])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_at_next_pos_matches_jax(seed, flags):
    recs = mod_records(240, seed)
    codes = []
    for b in recs:
        jb = JRecord.from_bam_buffer(b.to_bam_buffer())
        st, jst = BaseModState(), JState()
        rc = st.parse(b, flags)
        codes.append(rc)
        assert rc == jst.parse(jb, flags)
        if rc < 0:
            continue
        assert st.recorded() == jst.recorded()
        for i in range(len(st.channels) + 1):
            assert st.queryi(i) == jst.queryi(i)
        for code in set(st.recorded()) | {ord("z")}:
            assert st.query_type(code) == jst.query_type(code)
        for _ in range(b.l_qseq + 1):
            assert _mods(st.at_next_pos(b)) == _mods(jst.at_next_pos(jb))
    assert codes.count(-1) >= 20 and codes.count(0) >= 150


@pytest.mark.parametrize("flags", [0, HTS_MOD_REPORT_UNCHECKED])
def test_next_basemod_and_at_qpos_match_jax(flags):
    for b in mod_records(200, 4):
        jb = JRecord.from_bam_buffer(b.to_bam_buffer())
        st, jst = BaseModState(), JState()
        if st.parse(b, flags) < 0:
            assert jst.parse(jb, flags) < 0
            continue
        jst.parse(jb, flags)
        for _ in range(b.l_qseq + 1):
            (m, pos), (jm, jpos) = st.next_basemod(b), jst.next_basemod(jb)
            assert (_mods(m), pos) == (_mods(jm), jpos)
            if not m:
                break
        st, jst = BaseModState(), JState()
        st.parse(b, flags)
        jst.parse(jb, flags)
        for q in range(0, b.l_qseq, 7):
            assert _mods(st.at_qpos(b, q)) == _mods(jst.at_qpos(jb, q))
