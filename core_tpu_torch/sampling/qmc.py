"""Quasi-Monte-Carlo sequences (counterpart of core_tpu/sampling/qmc.py).

The same sequences, bit for bit: RI_vdC / RI_S / RI_LP radical inverses, the
FNV-1a hash, the general-base radical inverse and Faure-scrambled Halton.

uint32 arithmetic is emulated in int64: every index tensor holds values in
[0, 2**32), and every operation that can leave that range (shift left,
multiply, add) is masked with `& 0xFFFFFFFF`, which is what the wrap-around
of a uint32 does.  Inputs may be Python ints or integer tensors; outputs are
float32 samples in [0, 1].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_INV32 = float(2.0 ** -32)  # the reference's multRatio (mcqmc.h:99)

# First 50 primes with prims[0] = 1, as the reference indexes its dimensions
# (scr_halton.h:27-32).
PRIMES = (1, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
          61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131,
          137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197,
          199, 211, 223, 227)


def as_u32(i, like=None) -> torch.Tensor:
    """Integer tensor (or int) -> int64 tensor holding the uint32 value."""
    if isinstance(i, torch.Tensor):
        return i.to(torch.int64) & MASK32
    device = like.device if like is not None else None
    return torch.tensor(int(i) & MASK32, dtype=torch.int64, device=device)


def _to_unit(bits):
    return (bits.to(torch.float32) * _INV32).clamp(0.0, 1.0)


def ri_vdc(i, scramble=0):
    """Base-2 van der Corput radical inverse with XOR scramble."""
    bits = as_u32(i)
    bits = ((bits << 16) | (bits >> 16)) & MASK32
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    return _to_unit(bits ^ _scramble(scramble))


@functools.lru_cache()
def _sobol_dirs():
    """Direction numbers of RI_S: v0=2^31, v_{k+1}=v_k^(v_k>>1)."""
    v, x = [], 1 << 31
    for _ in range(32):
        v.append(x)
        x = x ^ (x >> 1)
    return tuple(v)


@functools.lru_cache()
def _lp_dirs():
    """Direction numbers of RI_LP: v0=2^31, v_{k+1}=v_k|(v_k>>1)."""
    v, x = [], 1 << 31
    for _ in range(32):
        v.append(x)
        x = x | (x >> 1)
    return tuple(v)


def _scramble(scramble):
    """A scramble as an operand of ^: a tensor as uint32 values, a Python
    int as a Python int (a device tensor made from a host int is a copy
    that waits for the device)."""
    if isinstance(scramble, torch.Tensor):
        return as_u32(scramble)
    return int(scramble) & MASK32


def _ri_directions(i, scramble, dirs):
    i = as_u32(i)
    r = torch.zeros_like(i) ^ _scramble(scramble)
    for k in range(32):
        r = r ^ (((i >> k) & 1) * dirs[k])
    return _to_unit(r)


def ri_s(i, scramble=0):
    """Sobol' second-dimension radical inverse (reference RI_S)."""
    return _ri_directions(i, scramble, _sobol_dirs())


def ri_lp(i, scramble=0):
    """Larcher & Pillichshammer radical inverse (reference RI_LP)."""
    return _ri_directions(i, scramble, _lp_dirs())


def fnv32a(i):
    """FNV-1a hash of the 4 little-endian bytes of a uint32
    (reference fnv_32a_buf).  Returns the uint32 hash in an int64 tensor."""
    i = as_u32(i)
    h = torch.full_like(i, 0x811C9DC5)
    for k in range(4):
        h = ((h ^ ((i >> (8 * k)) & 0xFF)) * 0x01000193) & MASK32
    return h


def _digit_factors(base: int):
    """ndigits and the float32 digit weights base^-k, built by repeated
    float32 multiplication exactly as core_tpu does."""
    ndigits = int(np.ceil(32.0 / np.log2(base)))
    inv_base = np.float32(1.0 / base)
    factors, f = [], inv_base
    for _ in range(ndigits):
        factors.append(float(f))
        f = np.float32(f * inv_base)
    return factors


def radical_inverse(base: int, i):
    """Radical inverse of i in an arbitrary (static) integer base
    (reference incremental Halton at index i).

    Each digit is weighted and added as its own rounded multiply and add.
    core_tpu's jitted CPU build contracts those into FMAs for bases >= 5, so
    there the two agree only to an ulp; at base 3 (the one the path tracer
    uses) every digit product is exact and the results are identical."""
    if base == 2:
        return ri_vdc(i)
    i = as_u32(i)
    value = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for f in _digit_factors(base):
        value = value + (i % base).to(torch.float32) * f
        i = i // base
    return value.clamp(0.0, 1.0)


@functools.lru_cache()
def _faure_permutation(b: int) -> tuple:
    """Faure (1992) scrambling permutation sigma_b, built recursively
    (same construction as core_tpu.sampling.qmc._faure_permutation)."""
    if b == 1:
        return (0,)
    if b == 2:
        return (0, 1)
    if b % 2 == 0:
        s = _faure_permutation(b // 2)
        return tuple(2 * x for x in s) + tuple(2 * x + 1 for x in s)
    c = (b - 1) // 2
    s = [x + 1 if x >= c else x for x in _faure_permutation(b - 1)]
    return tuple(s[:c]) + (c,) + tuple(s[c:])


@functools.lru_cache()
def _faure_table(b: int, device) -> torch.Tensor:
    """The permutation sigma_b as a float32 table on `device`, made once (a
    table copied from the host at every call would wait for the device
    each time)."""
    return torch.tensor(_faure_permutation(b), dtype=torch.float32,
                        device=device)


def scr_halton(dim: int, n):
    """Faure-scrambled Halton sample of (static) dimension `dim` at index n
    (reference scrHalton, scr_halton.h:46-71): digits of n in base
    prims[dim] are permuted by the Faure permutation; result clamped to
    [1e-36, 1].  dim >= 50 uses core_tpu's deterministic fallback, a vdC
    scrambled by a hash of the dimension."""
    i = as_u32(n)
    if dim >= 50:
        return ri_vdc(i, fnv32a(torch.full_like(i, dim)))
    base = PRIMES[dim]
    if base == 1:
        return torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    sigma = _faure_table(base, i.device)
    value = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for f in _digit_factors(base):
        value = value + sigma[i % base] * f
        i = i // base
    return value.clamp(1e-36, 1.0)
