"""The SAM header: its text, its parsed lines, the references' names
and lengths, and htslib's header-editing API (`add_line`, `update_line`,
`remove_line_id`, `add_pg` and the rest; the port's copy of
htslib_tpu/sam/header.py; reference header.c, htslib/sam.h:483-843).

The text is kept verbatim until a line is changed (`_dirty`), then
rebuilt from the lines (header.c sam_hdr_rebuild:1604), as the JAX
package does.  The port's device functions read a header only through
`ref_names` and `tid2name`, so any object with those (the JAX package's
`SamHeader` too) can be passed where they take one."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from htslib_tpu_torch.util.log import log_warning

_ID_TAG = {"SQ": "SN", "RG": "ID", "PG": "ID"}


class HeaderLine:
    """One @-line: a type plus ordered (tag, value) pairs, or comment text."""

    __slots__ = ("type", "tags", "comment")

    def __init__(self, type_: str,
                 tags: Optional[List[Tuple[str, Optional[str]]]] = None,
                 comment: Optional[str] = None):
        self.type = type_
        self.tags = tags if tags is not None else []
        self.comment = comment

    @classmethod
    def parse(cls, line: str) -> "HeaderLine":
        if not line.startswith("@") or len(line) < 3:
            raise ValueError(f"invalid header line {line!r}")
        type_ = line[1:3]
        if type_ == "CO":
            return cls("CO", comment=line[4:] if len(line) > 3 else "")
        tags: List[Tuple[str, Optional[str]]] = []
        for field in line[3:].split("\t"):
            if not field:
                continue
            if len(field) >= 3 and field[2] == ":":
                tags.append((field[:2], field[3:]))
            else:
                # a malformed tag is kept raw, so the line round-trips
                tags.append((field, None))
        return cls(type_, tags)

    def get(self, tag: str) -> Optional[str]:
        for k, v in self.tags:
            if k == tag:
                return v
        return None

    def set(self, tag: str, value: Optional[str]) -> None:
        for i, (k, _) in enumerate(self.tags):
            if k == tag:
                if value is None:
                    del self.tags[i]
                else:
                    self.tags[i] = (tag, value)
                return
        if value is not None:
            self.tags.append((tag, value))

    def format(self) -> str:
        if self.type == "CO":
            return f"@CO\t{self.comment}"
        parts = [f"@{self.type}"]
        for k, v in self.tags:
            parts.append(k if v is None else f"{k}:{v}")
        return "\t".join(parts)


class SamHeader:
    """sam_hdr_t: the text, its lines and the reference dictionary.
    `ref_names` (with `ref_lens`, zeros where not given) is a BAM
    header's binary reference list: where the text's @SQ lines name other
    references, or none, the binary list wins, as bam_hdr_read has it."""

    def __init__(self, text: str = "",
                 ref_names: Optional[List[str]] = None,
                 ref_lens: Optional[List[int]] = None):
        self._text = text
        self._dirty = False
        self.lines: List[HeaderLine] = []
        self._index: Dict[Tuple[str, str], HeaderLine] = {}
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        self._name2tid: Dict[str, int] = {}
        for raw in text.split("\n"):
            if raw.startswith("@"):
                try:
                    self._add_parsed(HeaderLine.parse(raw.rstrip("\r")))
                except ValueError:
                    continue
        if ref_names is not None:
            lens = (list(ref_lens) if ref_lens is not None
                    else [0] * len(ref_names))
            if len(lens) != len(ref_names):
                raise ValueError("ref_lens: one length a reference name")
            if list(ref_names) != self.ref_names:
                self.ref_names = list(ref_names)
                self.ref_lens = lens
                self._name2tid = {n: i for i, n in enumerate(ref_names)}

    def _add_parsed(self, line: HeaderLine) -> None:
        self.lines.append(line)
        idtag = _ID_TAG.get(line.type)
        if idtag and line.get(idtag) is not None:
            self._index[(line.type, line.get(idtag))] = line
        if line.type == "SQ" and line.get("SN") is not None:
            sn, ln = line.get("SN"), line.get("LN")
            self._name2tid[sn] = len(self.ref_names)
            self.ref_names.append(sn)
            try:
                self.ref_lens.append(int(ln) if ln is not None else 0)
            except ValueError:
                self.ref_lens.append(0)
            for alt in (line.get("AN") or "").split(","):
                if alt:
                    self._name2tid.setdefault(alt, self._name2tid[sn])

    # -- reference dictionary ------------------------------------------
    @property
    def nref(self) -> int:
        return len(self.ref_names)

    def name2tid(self, name: str) -> int:
        """sam_hdr_name2tid (header.c:1771): -1 for "*" or unknown."""
        return -1 if name == "*" else self._name2tid.get(name, -1)

    def tid2name(self, tid: int) -> str:
        return (self.ref_names[tid] if 0 <= tid < len(self.ref_names)
                else "*")

    def tid2len(self, tid: int) -> int:
        return self.ref_lens[tid] if 0 <= tid < len(self.ref_lens) else 0

    def add_ref(self, name: str, length: int) -> int:
        """Register a reference the text does not describe, with an @SQ
        line (the SAM parser's lenient path; sam_hdr_add_line @SQ)."""
        if name in self._name2tid:
            return self._name2tid[name]
        tid = len(self.ref_names)
        self.ref_names.append(name)
        self.ref_lens.append(length)
        self._name2tid[name] = tid
        line = HeaderLine("SQ", [("SN", name), ("LN", str(length))])
        self.lines.append(line)
        self._index[("SQ", name)] = line
        self._dirty = True
        return tid

    # -- line CRUD (sam_hdr_add_line etc., htslib/sam.h:551-720) --------
    def _add_line_obj(self, line: HeaderLine) -> None:
        if line.type == "HD" and any(l.type == "HD" for l in self.lines):
            log_warning("duplicate @HD line ignored")
            return
        if line.type == "HD":
            self.lines.insert(0, line)
        else:
            self.lines.append(line)
        idtag = _ID_TAG.get(line.type)
        if idtag and line.get(idtag) is not None:
            self._index[(line.type, line.get(idtag))] = line
        self._dirty = True

    def _add_sq_ref(self, sn: Optional[str], ln: str) -> None:
        """Register a new @SQ line's reference (not its AN names)."""
        if sn and sn not in self._name2tid:
            self._name2tid[sn] = len(self.ref_names)
            self.ref_names.append(sn)
            self.ref_lens.append(int(ln))

    def add_line(self, type_: str, *tagvals: str) -> None:
        """sam_hdr_add_line: a line of `type_` with tag, value pairs."""
        tags = [(tagvals[i], tagvals[i + 1])
                for i in range(0, len(tagvals), 2)]
        if type_ == "SQ":
            self._add_sq_ref(dict(tags).get("SN"), dict(tags).get("LN", "0"))
        self._add_line_obj(HeaderLine(type_, tags))

    def add_lines(self, text: str) -> None:
        """sam_hdr_add_lines: every line of `text`."""
        for raw in text.split("\n"):
            if raw:
                line = HeaderLine.parse(raw)
                if line.type == "SQ":
                    self._add_sq_ref(line.get("SN"), line.get("LN") or "0")
                self._add_line_obj(line)

    def find_line_id(self, type_: str, id_key: str,
                     id_val: str) -> Optional[HeaderLine]:
        if _ID_TAG.get(type_) == id_key:
            return self._index.get((type_, id_val))
        for line in self.lines:
            if line.type == type_ and line.get(id_key) == id_val:
                return line
        return None

    def find_line_pos(self, type_: str, pos: int) -> Optional[HeaderLine]:
        """The `pos`-th line of `type_` (from 0), or None."""
        i = 0
        for line in self.lines:
            if line.type == type_:
                if i == pos:
                    return line
                i += 1
        return None

    def count_lines(self, type_: str) -> int:
        return sum(1 for line in self.lines if line.type == type_)

    def find_tag_id(self, type_: str, id_key: str, id_val: str,
                    tag: str) -> Optional[str]:
        line = self.find_line_id(type_, id_key, id_val)
        return line.get(tag) if line else None

    def find_tag_pos(self, type_: str, pos: int, tag: str) -> Optional[str]:
        line = self.find_line_pos(type_, pos)
        return line.get(tag) if line else None

    def remove_line_id(self, type_: str, id_key: str, id_val: str) -> bool:
        """sam_hdr_remove_line_id: drops the line's text, not its
        reference, as the JAX package does."""
        line = self.find_line_id(type_, id_key, id_val)
        if line is None:
            return False
        self.lines.remove(line)
        idtag = _ID_TAG.get(type_)
        if idtag and line.get(idtag) is not None:
            self._index.pop((type_, line.get(idtag)), None)
        self._dirty = True
        return True

    def remove_except(self, type_: str, id_key: Optional[str] = None,
                      id_val: Optional[str] = None) -> None:
        """sam_hdr_remove_except (htslib/sam.h:640): every line of
        `type_` but the one with id_key:id_val."""
        keep = None
        if id_key is not None:
            keep = self.find_line_id(type_, id_key, id_val)
        self.lines = [l for l in self.lines if l.type != type_ or l is keep]
        self._index = {k: v for k, v in self._index.items()
                       if k[0] != type_ or v is keep}
        self._dirty = True

    def update_line(self, type_: str, id_key: str, id_val: str,
                    *tagvals: Optional[str]) -> bool:
        """sam_hdr_update_line: set (or, with None, remove) tags of the
        line with id_key:id_val."""
        line = self.find_line_id(type_, id_key, id_val)
        if line is None:
            return False
        for i in range(0, len(tagvals), 2):
            line.set(tagvals[i], tagvals[i + 1])
        self._dirty = True
        return True

    def add_pg(self, name: str, **tags: str) -> None:
        """sam_hdr_add_pg (header.c:2228): an @PG line with a unique ID,
        its PP the last line of the chain's leaves."""
        pg_ids = [l.get("ID") for l in self.lines if l.type == "PG"]
        pps = {l.get("PP") for l in self.lines if l.type == "PG"}
        leaves = [i for i in pg_ids if i not in pps and i is not None]
        uid = name
        n = 0
        while uid in pg_ids:
            n += 1
            uid = f"{name}.{n}"
        tlist: List[Tuple[str, Optional[str]]] = [("ID", uid), ("PN", name)]
        if leaves:
            tlist.append(("PP", leaves[-1]))
        tlist.extend(tags.items())
        self._add_line_obj(HeaderLine("PG", tlist))

    # -- text ----------------------------------------------------------
    @property
    def text(self) -> str:
        """The header text (sam_hdr_str): verbatim, or rebuilt from the
        lines once one was changed."""
        if self._dirty:
            self._text = "".join(line.format() + "\n" for line in self.lines)
            self._dirty = False
        return self._text

    def full_text_with_refs(self) -> str:
        """The text with an @SQ line for every binary reference it lacks,
        after @HD where the text starts with one (header.c:1289)."""
        have = {line.get("SN") for line in self.lines if line.type == "SQ"}
        extra = "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in
                        zip(self.ref_names, self.ref_lens) if n not in have)
        base = self.text
        if not extra:
            return base
        if base.startswith("@HD"):
            nl = base.index("\n") + 1
            return base[:nl] + extra + base[nl:]
        return extra + base

    @property
    def version(self) -> Optional[str]:
        """The @HD line's VN, or None."""
        for line in self.lines:
            if line.type == "HD":
                return line.get("VN")
        return None

    def __eq__(self, other) -> bool:
        return isinstance(other, SamHeader) and self.text == other.text

    def copy(self) -> "SamHeader":
        h = SamHeader(self.text)
        if not h.ref_names and self.ref_names:
            h.ref_names = list(self.ref_names)
            h.ref_lens = list(self.ref_lens)
            h._name2tid = dict(self._name2tid)
        return h
