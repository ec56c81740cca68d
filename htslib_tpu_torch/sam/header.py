"""A minimal SAM header: its text and the references' names and lengths,
from lists or from @SQ text.

The port's functions read a header only through `ref_names` and
`tid2name` (and a BAM writer through `text` and `ref_lens`), so any
object with those (the JAX package's `SamHeader` too) can be passed where
a `SamHeader` is taken."""
from __future__ import annotations

from typing import List, Optional


class SamHeader:
    def __init__(self, text: str = "",
                 ref_names: Optional[List[str]] = None,
                 ref_lens: Optional[List[int]] = None):
        self.text = text
        self.ref_names: List[str] = list(ref_names or [])
        self.ref_lens: List[int] = (list(ref_lens) if ref_lens is not None
                                    else [0] * len(self.ref_names))
        if len(self.ref_lens) != len(self.ref_names):
            raise ValueError("ref_lens: one length a reference name")
        for line in text.split("\n"):
            if line.startswith("@SQ"):
                tags = dict(f.split(":", 1) for f in
                            line.rstrip("\r").split("\t")[1:] if ":" in f)
                if "SN" in tags:
                    self.ref_names.append(tags["SN"])
                    self.ref_lens.append(int(tags.get("LN", 0)))

    @property
    def nref(self) -> int:
        return len(self.ref_names)

    def tid2name(self, tid: int) -> str:
        return (self.ref_names[tid] if 0 <= tid < len(self.ref_names)
                else "*")
