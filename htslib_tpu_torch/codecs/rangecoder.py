"""Carry-counting byte range coder + adaptive symbol model, as host
Python: the coder family shared by the CRAM 3.1 fqzcomp / arith / tok3
block methods (reference call sites cram/cram_io.c:1686,1718,1737).

The port's own copy of the JAX package's host codec, kept byte for byte
in its arithmetic so that both packages decode the same wire.  Mechanics
follow the CRAM 3.1 specification pseudocode (64-bit low + 32-bit range,
renormalise under 2^24, cache+FF carry runs, 5-byte decoder bootstrap;
model STEP 16, total cap 2^16-17, halving renormalisation, adjacent
transposition ordering).
"""
from __future__ import annotations

RC_TOP = 1 << 24

SM_STEP = 16
SM_MAX_TOTAL = (1 << 16) - 17


class RangeEncoder:
    __slots__ = ("low", "range", "FFnum", "cache", "out")

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.FFnum = 0
        self.cache = 0
        self.out = bytearray()

    def _shift_low(self) -> None:
        carry = (self.low >> 32) & 0xFF
        if (self.low & 0xFFFFFFFF) < 0xFF000000 or carry:
            self.out.append((self.cache + carry) & 0xFF)
            while self.FFnum:
                self.out.append((0xFF + carry) & 0xFF)
                self.FFnum -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.FFnum += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int) -> None:
        self.range //= tot
        self.low += cum * self.range
        self.range *= freq
        while self.range < RC_TOP:
            self._shift_low()
            self.range = (self.range << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("buf", "p", "end", "range", "code")

    def __init__(self, buf, p: int = 0, end: int = -1):
        self.buf = buf
        self.p = p
        self.end = len(buf) if end < 0 else end
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(5):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF

    def _byte(self) -> int:
        if self.p < self.end:
            b = self.buf[self.p]
            self.p += 1
            return b
        return 0

    def get_freq(self, tot: int) -> int:
        self.range //= tot
        return self.code // self.range

    def decode(self, cum: int, freq: int) -> None:
        self.code -= cum * self.range
        self.range *= freq
        while self.range < RC_TOP:
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF


class SimpleModel:
    """Adaptive frequencies with transposition ordering (wire-affecting:
    both codecs must transpose identically)."""
    __slots__ = ("total", "freq", "sym")

    def __init__(self, nsym: int = 256):
        self.total = nsym
        self.freq = [1] * nsym
        self.sym = list(range(nsym))

    def _update(self, i: int) -> None:
        freq = self.freq
        freq[i] += SM_STEP
        self.total += SM_STEP
        if i > 0 and freq[i] > freq[i - 1]:
            freq[i], freq[i - 1] = freq[i - 1], freq[i]
            s = self.sym
            s[i], s[i - 1] = s[i - 1], s[i]
        if self.total > SM_MAX_TOTAL:
            tot = 0
            for j in range(len(freq)):
                freq[j] -= freq[j] >> 1
                tot += freq[j]
            self.total = tot

    def encode(self, rc: RangeEncoder, s: int) -> None:
        cum = 0
        i = 0
        sym = self.sym
        freq = self.freq
        while sym[i] != s:
            cum += freq[i]
            i += 1
        rc.encode(cum, freq[i], self.total)
        self._update(i)

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.total)
        cum = 0
        i = 0
        freq = self.freq
        while cum + freq[i] <= f:
            cum += freq[i]
            i += 1
        rc.decode(cum, freq[i])
        s = self.sym[i]
        self._update(i)
        return s
