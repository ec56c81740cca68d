"""Coordinate-sharded exact mpileup: the port's copy of
htslib_tpu/parallel/pileup_shard.py (SURVEY §7 hard part #4; §5
"genomic-coordinate sharding").

The genome's (tid, pos) key space is split into disjoint contiguous
tiles; shard i owns tile i and processes every read whose alignment
OVERLAPS its tile — reads starting before the tile (boundary-spanning)
are replicated into the shard, the shard-plan equivalent of an
all_gather of halo reads.  Each shard runs the full single-node pileup
engine (resolve_cigar2 + tweak_overlap_quality, reference
sam.c:5409/5803) over its read set and emits only the columns inside
its tile.

Byte-exactness argument: a column at key (tid, p) inside tile i is
built from exactly the reads covering p, all of which overlap tile i
and are therefore in the shard.  The overlap-pair quality tweak only
modifies base qualities at positions covered by BOTH mates
(tweak_overlap_quality walks the shared span only), so any pair
affecting a column in tile i has both mates overlapping tile i and the
tweak is recomputed identically inside the shard.  Hence concatenating
tile outputs in order reproduces the single-engine output byte for
byte.  Records are read as mpileup_text reads them (pileup.py
`read_records`: the stream, its framing and every record's bases on
`device`), and each shard reads its own fresh records, since the engine
tweaks the qualities of the records it is given."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

from htslib_tpu_torch.pileup import DEFAULT_SKIP, Pileup, read_records
from htslib_tpu_torch.sam.cigar import cigar2rlen
from htslib_tpu_torch.sam.record import FUNMAP

Key = Tuple[int, int]
_KEY_MIN: Key = (-1, -1)
_KEY_MAX: Key = (1 << 40, 0)


@dataclass
class PileupTile:
    index: int
    lo: Key      # inclusive (tid, pos) key
    hi: Key      # exclusive


def record_endpos(rec) -> int:
    """bam_endpos: pos + reference span (>= pos+1)."""
    span = cigar2rlen(rec.cigar) if len(rec.cigar) else 0
    return rec.pos + max(span, 1)


def plan_pileup_tiles(records: Sequence, n_shards: int) -> List[PileupTile]:
    """Split the covered key space into n_shards contiguous tiles
    balanced by read count (`records` position-sorted; one metadata
    pass — the distributed analogue scans the index instead)."""
    keys = [(r.tid, r.pos) for r in records
            if not (r.flag & FUNMAP) and r.tid >= 0]
    if not keys:
        return [PileupTile(0, _KEY_MIN, _KEY_MAX)]
    n = len(keys)
    per = max(1, (n + n_shards - 1) // n_shards)
    cuts: List[Key] = []
    for si in range(1, n_shards):
        i = si * per
        if i >= n:
            break
        k = keys[i]
        if not cuts or k > cuts[-1]:
            cuts.append(k)
    bounds = [_KEY_MIN] + cuts + [_KEY_MAX]
    return [PileupTile(i, bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)]


def reads_for_tile(records: Sequence, tile: PileupTile) -> List:
    """All reads overlapping the tile, including boundary-spanning
    halo reads that start in earlier tiles."""
    out = []
    for r in records:
        if r.flag & FUNMAP or r.tid < 0:
            continue
        if (r.tid, r.pos) >= tile.hi:
            continue
        if (r.tid, record_endpos(r)) <= tile.lo:
            continue
        out.append(r)
    return out


def pileup_tile_columns(reads: Sequence, tile: PileupTile,
                        format_column: Callable, header) -> List[str]:
    """Full pileup engine over the tile's read set; emit only columns
    with lo <= (tid, pos) < hi."""
    it = iter(list(reads) + [None])

    def func():
        return next(it)

    out = []
    for tid, pos, col in Pileup(func, overlaps=True):
        if tid < 0:
            break
        key = (tid, pos)
        if key < tile.lo:
            continue
        if key >= tile.hi:
            break
        out.append(format_column(header, tid, pos, col))
    return out


def _load_records(path: str, device="cuda"):
    """(header, the records mpileup keeps) of `path` (SAM where it ends
    in ".sam", else BAM), read and decoded on `device`."""
    return read_records(path, path.endswith(".sam"), device, DEFAULT_SKIP)


def mpileup_one_tile(path: str, tile: PileupTile,
                     format_column: Callable, device="cuda") -> List[str]:
    """One shard's full work from its own file read: the engine mutates
    record quals when tweaking overlaps, so every shard decodes fresh
    records (as a distributed worker would)."""
    header, records = _load_records(path, device)
    return pileup_tile_columns(reads_for_tile(records, tile), tile,
                               format_column, header)


def sharded_mpileup(path: str, n_shards: int, format_column: Callable,
                    device="cuda") -> List[List[str]]:
    """End-to-end: plan tiles once, run each shard independently.
    Concatenating the per-shard outputs in tile order equals the
    single-engine output byte for byte."""
    _, records = _load_records(path, device)
    tiles = plan_pileup_tiles(records, n_shards)
    return [mpileup_one_tile(path, tile, format_column, device)
            for tile in tiles]
