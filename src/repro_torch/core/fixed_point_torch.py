"""The fixed-point Goldschmidt datapath in torch tensor ops.

Counterpart of ``repro.core.fixed_point_jax``: the paper's narrow divider
(uint32 registers with ``frac_bits`` fraction bits, a truncating w×w→w
multiplier, the 2's complement block, the integer ROM, optional Mitchell
log-multiplies on the early passes) as tensor ops, **bit-identical** register
for register to the reference's JAX datapath and numpy emulation
(``repro.core.fixed_point``), as ``tests/test_torch_fixed.py`` holds over
p × frac_bits × variant × mitchell.

torch's ``uint32`` supports few operations, so a register is an ``int64``
tensor holding a value in [0, 2^32), and every operation that can wrap in
uint32 (the product's low word, the complement, the adds of the rsqrt
update, the Mitchell shifts) is masked back to 32 bits, which is what
uint32 arithmetic does.  The multiplier splits ``b`` into 16-bit halves so
each partial product stays below 2^48; the result is the low 32 bits of
⌊a·b / 2^F⌋, the value the reference's 16-bit-limb construction gives.

The only float arithmetic is at the IEEE-754 boundary of the ``*_f32``
wrappers: an exact peel of the mantissa into a register, and the
register's value times a power of two, rounded once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lut

__all__ = ["FixedPointTorch", "msb32", "rom_words", "recip_f32", "divide_f32", "rsqrt_f32",
           "sqrt_f32"]

MASK32 = 0xFFFFFFFF
_MANT_MASK = 0x7FFFFF
_F32_ONE_BITS = 1 << 23


def msb32(x: torch.Tensor) -> torch.Tensor:
    """Leading-one index of registers < 2^32 (0 for 0): the comparator
    cascade of the reference's ``fixed_point.msb``."""
    e = torch.zeros_like(x)
    t = x
    for sh in (16, 8, 4, 2, 1):
        m = t >= (1 << sh)
        e = torch.where(m, e + sh, e)
        t = torch.where(m, t >> sh, t)
    return e


@functools.lru_cache(maxsize=None)
def rom_words(kind: str, p: int, frac_bits: int, device: str) -> torch.Tensor:
    """The (p+2)-bit ``"recip"`` or ``"rsqrt"`` ROM words left-aligned to
    ``frac_bits``, as int64 registers on ``device``."""
    table = lut.reciprocal_table_int(p) if kind == "recip" else lut.rsqrt_table_int(p)
    return torch.from_numpy(table.astype(np.int64) << (frac_bits - (p + 2))).to(device)


def _shl32(x: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """uint32 ``x << amount``: the low 32 bits, and 0 for amounts >= 32."""
    out = (x << amount.clamp(max=31)) & MASK32
    return torch.where(amount >= 32, torch.zeros_like(out), out)


@dataclasses.dataclass(frozen=True)
class FixedPointTorch:
    """The n-bit divider datapath on int64-held uint32 registers.

    Register convention as the numpy reference: unsigned, value =
    reg · 2^-frac_bits, every datapath value < 4.0.  ``divide_*`` take
    registers; the ``*_f32`` wrappers peel IEEE-754 mantissas into them.
    """

    p: int = 7
    frac_bits: int = 28
    mitchell_iters: int = 0

    def __post_init__(self):
        if self.frac_bits > 30:
            raise ValueError("frac_bits > 30 overflows the 32-bit register")
        if self.frac_bits < self.p + 2:
            raise ValueError(
                f"frac_bits={self.frac_bits} cannot hold the (p+2)-bit ROM "
                f"word (p={self.p})")

    # -- hardware primitive blocks ------------------------------------------

    def mult(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """w×w→w truncating multiplier: low 32 bits of ⌊a·b / 2^F⌋."""
        F = self.frac_bits
        hi = a * (b >> 16)  # < 2^48
        lo = a * (b & 0xFFFF)  # < 2^48
        if F >= 16:
            out = (hi + (lo >> 16)) >> (F - 16)
        else:
            out = (hi << (16 - F)) + (lo >> F)
        return out & MASK32

    def mitchell_mult(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Mitchell log-multiplier, step for step the numpy/JAX block."""
        F = self.frac_bits
        ea, eb = msb32(a), msb32(b)
        fa = (a - (torch.ones_like(ea) << ea)) & MASK32
        fb = (b - (torch.ones_like(eb) << eb)) & MASK32
        fa_s = torch.where(ea <= F, _shl32(fa, F - ea.clamp(max=F)),
                           fa >> (ea.clamp(min=F) - F))
        fb_s = torch.where(eb <= F, _shl32(fb, F - eb.clamp(max=F)),
                           fb >> (eb.clamp(min=F) - F))
        s = (fa_s + fb_s) & MASK32
        e2 = ea + eb + (s >> F)
        f2 = s & ((1 << F) - 1)
        base = (1 << F) + f2
        two_f = 2 * F
        shl = e2.clamp(min=two_f) - two_f
        shr = (two_f - e2.clamp(max=two_f)).clamp(max=31)
        res = torch.where(e2 >= two_f, _shl32(base, shl), base >> shr)
        return torch.where((a == 0) | (b == 0), torch.zeros_like(res), res)

    def complement(self, r: torch.Tensor) -> torch.Tensor:
        """2's complement block: K = 2 − r."""
        return ((2 << self.frac_bits) - r) & MASK32

    def rom(self, d_reg: torch.Tensor) -> torch.Tensor:
        """ROM read: the top p fraction bits of D ∈ [1, 2) index the
        (p+2)-bit words, left-aligned to ``frac_bits``."""
        idx = ((d_reg - (1 << self.frac_bits)) & MASK32) >> (self.frac_bits - self.p)
        idx = idx.clamp(0, (1 << self.p) - 1)
        return rom_words("recip", self.p, self.frac_bits, str(d_reg.device))[idx]

    def _pass_mult(self, i: int):
        return self.mitchell_mult if i < self.mitchell_iters else self.mult

    # -- full datapaths ------------------------------------------------------

    def divide_pipelined(self, n_reg: torch.Tensor, d_reg: torch.Tensor,
                         passes: int, k1: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Unrolled datapath on registers; returns (q_reg, r_reg).  ``k1``
        overrides the ROM seed."""
        if k1 is None:
            k1 = self.rom(d_reg)
        q = self.mult(n_reg, k1)  # MULT 1
        r = self.mult(d_reg, k1)  # MULT 2
        for i in range(passes):
            k = self.complement(r)
            mul = self._pass_mult(i)
            q = mul(q, k)  # MULT X_i
            if i != passes - 1:
                r = mul(r, k)  # MULT Y_i
        return q, r

    def divide_feedback(self, n_reg: torch.Tensor, d_reg: torch.Tensor,
                        passes: int, k1: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Feedback datapath: one multiplier pair, a counter and the mux that
        feeds r back (the Mitchell block on the first passes).  The same
        multiplies in the same order as the pipelined datapath."""
        if k1 is None:
            k1 = self.rom(d_reg)
        q = self.mult(n_reg, k1)
        r = self.mult(d_reg, k1)
        counter = 0
        while counter < passes:
            k = self.complement(r)
            mul = self._pass_mult(counter)
            q = mul(q, k)
            if counter != passes - 1:
                r = mul(r, k)
            counter += 1
        return q, r

    def divide(self, n_reg, d_reg, passes: int, variant: str = "feedback",
               k1=None):
        fn = (self.divide_pipelined if variant == "pipelined"
              else self.divide_feedback)
        return fn(n_reg, d_reg, passes, k1)

    # -- rsqrt: the coupled g/h iteration in fixed point ---------------------

    def rsqrt_reg(self, m_reg: torch.Tensor, passes: int,
                  y0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """1/sqrt of m ∈ [1, 4): returns the 2h register (→ rsqrt(m)).

        The residual ``0.5 − g·h`` is carried as magnitude and direction and
        applied with an adder/subtractor, so registers stay unsigned.  Exact
        multiplies only, as in the reference.
        """
        F = self.frac_bits
        if y0 is None:
            t = ((m_reg - (1 << F)) & MASK32) >> (F - self.p)
            idx = (t // 3).clamp(0, (1 << self.p) - 1)
            y0 = rom_words("rsqrt", self.p, F, str(m_reg.device))[idx]
        g = self.mult(m_reg, y0)
        h = y0 >> 1
        half = 1 << (F - 1)
        for _ in range(passes):
            gh = self.mult(g, h)
            pos = gh <= half
            rmag = torch.where(pos, half - gh, gh - half)
            gd, hd = self.mult(g, rmag), self.mult(h, rmag)
            g = torch.where(pos, g + gd, g - gd) & MASK32
            h = torch.where(pos, h + hd, h - hd) & MASK32
        return (h << 1) & MASK32


# ---------------------------------------------------------------------------
# IEEE-754 boundary: f32 wrappers for the policy route
# ---------------------------------------------------------------------------


def _peel(x: torch.Tensor):
    """f32 → (biased exponent, mantissa with the hidden one, sign bit), int64."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & MASK32
    return (bits >> 23) & 0xFF, (bits & _MANT_MASK) | _F32_ONE_BITS, bits >> 31


def _mant_to_reg(mant: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """24-bit mantissa (1.f) → register with ``frac_bits`` fraction bits:
    exact for frac_bits ≥ 23, truncating (the hardware narrowing) below."""
    if frac_bits >= 23:
        return mant << (frac_bits - 23)
    return mant >> (23 - frac_bits)


def _reg_to_f32(reg: torch.Tensor, frac_bits: int) -> torch.Tensor:
    return reg.to(torch.float32) * np.float32(2.0 ** -frac_bits)


def _ldexp(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """f32 ``v · 2^n``, rounded once: the product is exact in f64 (2^n built
    from its bits), so a normal result is exact and a subnormal one is
    IEEE-rounded (the reference flushes those: ROADMAP C2)."""
    pow2 = ((n.to(torch.int64) + 1023) << 52).view(torch.float64)
    return (v.to(torch.float64) * pow2).to(torch.float32)


def _finite_nonzero(e: torch.Tensor) -> torch.Tensor:
    return (e > 0) & (e < 255)


def recip_f32(x: torch.Tensor, *, frac_bits: int = 28, p: int = 7,
              iters: int = 2, variant: str = "feedback",
              mitchell_iters: int = 0) -> torch.Tensor:
    """1/x through the fixed-point datapath (normals; specials, zeros and
    subnormals take torch's own division, as the reference's fall back)."""
    dp = FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=mitchell_iters)
    xf = x.to(torch.float32)
    e, mant, sign = _peel(xf)
    m_reg = _mant_to_reg(mant, frac_bits)
    q, _ = dp.divide(torch.full_like(m_reg, 1 << frac_bits), m_reg, iters, variant)
    mag = _ldexp(_reg_to_f32(q, frac_bits), 127 - e)
    res = torch.where(sign == 1, -mag, mag)
    return torch.where(_finite_nonzero(e), res, 1.0 / xf).to(x.dtype)


def divide_f32(n: torch.Tensor, d: torch.Tensor, *, frac_bits: int = 28,
               p: int = 7, iters: int = 2, variant: str = "feedback",
               mitchell_iters: int = 0) -> torch.Tensor:
    """n/d through the datapath: the mantissa ratio ∈ (0.5, 2) fits the
    registers."""
    dp = FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=mitchell_iters)
    nf, df = torch.broadcast_tensors(n.to(torch.float32), d.to(torch.float32))
    en, mn, sn = _peel(nf)
    ed, md, sd = _peel(df)
    q, _ = dp.divide(_mant_to_reg(mn, frac_bits), _mant_to_reg(md, frac_bits),
                     iters, variant)
    mag = _ldexp(_reg_to_f32(q, frac_bits), en - ed)
    res = torch.where(sn != sd, -mag, mag)
    ok = _finite_nonzero(en) & _finite_nonzero(ed)
    return torch.where(ok, res, nf / df).to(torch.result_type(n, d))


def rsqrt_f32(x: torch.Tensor, *, frac_bits: int = 28, p: int = 7,
              iters: int = 2) -> torch.Tensor:
    """1/sqrt(x) through the fixed coupled iteration (positive normals)."""
    dp = FixedPointTorch(p=p, frac_bits=frac_bits)
    xf = x.to(torch.float32)
    e, mant, _ = _peel(xf)
    ebits = e - 127
    half_e = ebits >> 1  # arithmetic floor
    rem = ebits - (half_e << 1)  # 0 or 1: fold into m ∈ [1, 4)
    m_reg = _mant_to_reg(mant, frac_bits) << rem
    res = _ldexp(_reg_to_f32(dp.rsqrt_reg(m_reg, iters), frac_bits), -half_e)
    return torch.where(_finite_nonzero(e) & (xf > 0), res,
                       torch.rsqrt(xf)).to(x.dtype)


def sqrt_f32(x: torch.Tensor, *, frac_bits: int = 28, p: int = 7,
             iters: int = 2) -> torch.Tensor:
    """sqrt(x) = x · rsqrt(x) with the fixed rsqrt core."""
    xf = x.to(torch.float32)
    out = torch.where(xf == 0, xf, xf * rsqrt_f32(xf, frac_bits=frac_bits, p=p,
                                                  iters=iters))
    return out.to(x.dtype)
