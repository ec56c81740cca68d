"""A minimal SAM header: reference names, from a list or from @SQ text.

The port's functions read a header only through `ref_names` and
`tid2name`, so any object with those (the JAX package's `SamHeader`
too) can be passed where a `SamHeader` is taken."""
from __future__ import annotations

from typing import List, Optional


class SamHeader:
    def __init__(self, text: str = "",
                 ref_names: Optional[List[str]] = None):
        self.ref_names: List[str] = list(ref_names or [])
        for line in text.split("\n"):
            if line.startswith("@SQ"):
                for field in line.rstrip("\r").split("\t")[1:]:
                    if field.startswith("SN:"):
                        self.ref_names.append(field[3:])
                        break

    @property
    def nref(self) -> int:
        return len(self.ref_names)

    def tid2name(self, tid: int) -> str:
        return (self.ref_names[tid] if 0 <= tid < len(self.ref_names)
                else "*")
