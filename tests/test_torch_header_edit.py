"""The port's SAM header-editing API (htslib_tpu_torch/sam/header.py:
htslib's sam_hdr_add_line, add_lines, find_line_pos, count_lines,
find_tag_id, find_tag_pos, remove_line_id, remove_except, update_line,
add_pg, version and equality) against the JAX package's SamHeader: a
Hypothesis sequence of edits is applied to both, and after each the text,
the reference names and lengths, the lookups and any exception raised
must be the same."""
from hypothesis import given, settings
from hypothesis import strategies as st

from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu_torch.sam.header import SamHeader as THeader

BASE = ("@HD\tVN:1.6\tSO:coordinate\n"
        "@SQ\tSN:chr1\tLN:1000\tAN:one\n@SQ\tSN:chr2\tLN:2000\n"
        "@RG\tID:rg1\tSM:s1\tPL:ILLUMINA\n"
        "@PG\tID:bwa\tPN:bwa\tVN:0.7\n@CO\tfirst comment\n")
TYPES = ["HD", "SQ", "RG", "PG", "CO"]
NAMES = ["chr1", "chr2", "chrX", "one", "rg1", "rg2", "bwa", "bwa.1", "x"]
TAGS = ["SN", "LN", "ID", "SM", "PN", "PP", "VN", "SO", "DS", "AN"]
VALUES = st.one_of(st.sampled_from(NAMES),
                   st.integers(0, 5000).map(str), st.just(""))

tagvals = st.lists(st.tuples(st.sampled_from(TAGS), VALUES), max_size=4)
line_text = st.builds(
    lambda t, tv: "@" + t + "".join(f"\t{k}:{v}" for k, v in tv),
    st.sampled_from(TYPES), tagvals)
EDITS = st.one_of(
    st.tuples(st.just("add_line"), st.sampled_from(TYPES), tagvals),
    st.tuples(st.just("add_lines"), st.lists(line_text, min_size=1,
                                             max_size=3)),
    st.tuples(st.just("update_line"), st.sampled_from(TYPES),
              st.sampled_from(TAGS), st.sampled_from(NAMES),
              st.sampled_from(TAGS), st.one_of(st.none(), VALUES)),
    st.tuples(st.just("remove_line_id"), st.sampled_from(TYPES),
              st.sampled_from(TAGS), st.sampled_from(NAMES)),
    st.tuples(st.just("remove_except"), st.sampled_from(TYPES),
              st.one_of(st.none(), st.sampled_from(TAGS)),
              st.sampled_from(NAMES)),
    st.tuples(st.just("add_pg"), st.sampled_from(["bwa", "samtools", "x"]),
              st.dictionaries(st.sampled_from(["VN", "CL", "DS"]), VALUES,
                              max_size=2)),
    st.tuples(st.just("add_ref"), st.sampled_from(NAMES),
              st.integers(0, 10 ** 6)))


def _apply(h, edit):
    """The edit's result, or the type of the exception it raised."""
    kind, *args = edit
    try:
        if kind == "add_line":
            return h.add_line(args[0], *[x for kv in args[1] for x in kv])
        if kind == "add_lines":
            return h.add_lines("\n".join(args[0]) + "\n")
        if kind == "update_line":
            return h.update_line(*args)
        if kind == "add_pg":
            return h.add_pg(args[0], **args[1])
        return getattr(h, kind)(*args)
    except Exception as e:              # compared across the two
        return type(e).__name__


def _view(h):
    """What a caller can read of a header."""
    out = [h.text, list(h.ref_names), list(h.ref_lens), h.version,
           h.full_text_with_refs()]
    for t in TYPES:
        n = h.count_lines(t)
        out.append((t, n, [h.find_line_pos(t, i).format() for i in range(n)],
                    h.find_line_pos(t, n)))
        for tag in TAGS:
            out.append([h.find_tag_pos(t, i, tag) for i in range(n + 1)])
            out.append([h.find_tag_id(t, k, v, tag) for k in ("ID", "SN")
                        for v in NAMES])
    out.append([h.name2tid(n) for n in NAMES + ["*"]])
    return out


@settings(max_examples=50, deadline=None)
@given(st.lists(EDITS, max_size=12), st.booleans())
def test_edit_sequences_match_jax(edits, empty):
    text = "" if empty else BASE
    j, t = JHeader(text), THeader(text)
    assert _view(t) == _view(j)
    for edit in edits:
        assert _apply(t, edit) == _apply(j, edit), edit
        assert _view(t) == _view(j), edit
    assert (t == THeader(t.text)) and not (t == j)
    assert (t == t.copy()) == (j == j.copy())


def test_pg_chain_and_equality():
    j, t = JHeader(BASE), THeader(BASE)
    for h in (j, t):
        h.add_pg("samtools", VN="1.19", CL="samtools view")
        h.add_pg("samtools")
        h.add_line("SQ", "SN", "chrM", "LN", "16569")
        h.update_line("RG", "ID", "rg1", "SM", None, "DS", "new")
        h.remove_except("CO")
    assert t.text == j.text
    assert t.find_tag_id("PG", "ID", "samtools.1", "PP") == "samtools"
    assert t.ref_names == ["chr1", "chr2", "chrM"]
    assert t.version == "1.6" and THeader("").version is None
    assert t == THeader(j.text) and t != THeader(BASE)
