"""Philox-2x64 counter-based RNG keyed by global element index (i, j),
the port of the JAX package's ``matgen/philox.py`` that the random
butterfly transform and the matrix generator (``generate.py``) draw
from (reference: matgen/random.cc:43-100 philox_2x64, rand_to_real,
generate_float).

The value of element (i, j) depends only on (seed, i, j).  Implemented
twice:

* numpy (vectorized uint64): ``philox_2x64_np`` / ``random_np``;
* torch (``random_torch``), on any device: each 64-bit lane is carried
  as two 32-bit limbs in int64 tensors (torch has no unsigned 64-bit
  arithmetic), with 16-bit partial products so nothing overflows.

The two are bit-identical for the uniform and binary families (an
integer pipeline and one exact power-of-two scale); the transcendental
ones (normal, unit_disk, unit_circle) agree to a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

# Constants from Salmon et al. 2011 (reference: random.cc:55-58).
SEED_INC = 0xD2B74407B1CE6E93
MULTIPLIER = 0x9E3779B97F4A7C15
ROUNDS = 10
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# ---------------------------------------------------------------------------
# numpy path (uint64)
# ---------------------------------------------------------------------------


def _mul64_np(a: np.ndarray, b: int):
    """Exact 64x64 -> 128 product as (lo, hi), overflow-free in uint64."""
    b = np.uint64(b)
    mask = np.uint64(_MASK32)
    s32 = np.uint64(32)
    ah, al = a >> s32, a & mask
    bh, bl = b >> s32, b & mask
    albl = al * bl
    mid = ah * bl + (albl >> s32)
    mid2 = al * bh + (mid & mask)
    hi = ah * bh + (mid >> s32) + (mid2 >> s32)
    lo = a * b  # wrapping
    return lo, hi


def philox_2x64_np(i, j, seed: int):
    """128 pseudorandom bits per counter {i, j} (reference: random.cc:43-77)."""
    with np.errstate(over="ignore"):
        L = np.asarray(i, dtype=np.uint64)
        R = np.asarray(j, dtype=np.uint64)
        L, R = np.broadcast_arrays(L, R)
        key = np.uint64(seed)
        inc = np.uint64(SEED_INC)
        for r in range(ROUNDS):
            if r != 0:
                key = key + inc
            lo, hi = _mul64_np(R, MULTIPLIER)
            L, R = lo, hi ^ key ^ L
    return L, R


def _bits_to_unit_np(bits: np.ndarray, dtype) -> np.ndarray:
    """bits -> [0, 1) keeping the top `digits` bits (reference: random.cc:82-90)."""
    digits = np.finfo(dtype).nmant + 1
    shifted = (bits >> np.uint64(64 - digits)).astype(np.float64)
    return (shifted / float(1 << digits)).astype(dtype)


# ---------------------------------------------------------------------------
# torch path: 64-bit lanes as (hi, lo) 32-bit limbs in int64 tensors
# ---------------------------------------------------------------------------


def _mul32_wide(a: torch.Tensor, b: int):
    """32x32 -> 64 product of limbs as (hi, lo) limbs (16-bit partial
    products, so every intermediate stays below 2^34)."""
    b_hi, b_lo = b >> 16, b & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def _mul64_limbs(a, b: int):
    """(hi, lo) limbs times a 64-bit constant -> (hi128, lo128), each a
    (hi, lo) pair of 32-bit limbs."""
    ah, al = a
    bh, bl = (b >> 32) & _MASK32, b & _MASK32
    p0h, p0l = _mul32_wide(al, bl)
    p1h, p1l = _mul32_wide(al, bh)
    p2h, p2l = _mul32_wide(ah, bl)
    p3h, p3l = _mul32_wide(ah, bh)
    t1 = p0h + p1l + p2l
    t2 = p1h + p2h + p3l + (t1 >> 32)
    r3 = (p3h + (t2 >> 32)) & _MASK32
    return (r3, t2 & _MASK32), (t1 & _MASK32, p0l)


def philox_2x64_torch(i: torch.Tensor, j: torch.Tensor, seed: int):
    """torch version of philox_2x64_np for int64 counters 0 <= i, j < 2^63.
    Returns ((L_hi, L_lo), (R_hi, R_lo)) 32-bit limbs in int64 tensors."""
    i, j = torch.broadcast_tensors(i.long(), j.long())
    L = (i >> 32, i & _MASK32)
    R = (j >> 32, j & _MASK32)
    key = seed & _MASK64
    for r in range(ROUNDS):
        if r != 0:
            key = (key + SEED_INC) & _MASK64
        hi128, lo128 = _mul64_limbs(R, MULTIPLIER)
        R = (hi128[0] ^ (key >> 32) ^ L[0], hi128[1] ^ (key & _MASK32) ^ L[1])
        L = lo128
    return L, R


def _bits_to_unit_torch(bits, dtype: torch.dtype) -> torch.Tensor:
    """(hi, lo) limbs -> [0, 1) in ``dtype``, bit-matching numpy: the top
    `digits` bits as an exact integer, over an exact power of two."""
    hi, lo = bits
    if dtype == torch.float32:
        digits = 24
        kept = hi >> (32 - digits)
    else:
        digits = 53
        kept = (hi << (digits - 32)) | (lo >> (64 - digits))
    return (kept.to(torch.float64) / float(1 << digits)).to(dtype)


# ---------------------------------------------------------------------------
# Distribution sampling (reference: random.cc:110-160 generate_float)
# ---------------------------------------------------------------------------

DISTS = (
    "uniform",         # [0, 1)
    "uniform_signed",  # (-1, 1)
    "normal",          # Box-Muller
    "unit_disk",
    "unit_circle",
    "binary",
    "binary_signed",
)


def _apply_dist(f1, f2, dist: str, dtype, xp):
    """(re, im) of one distribution from two uniforms; ``xp`` is numpy
    or torch (both name these functions alike)."""
    two_pi = xp.asarray(2 * np.pi, dtype=dtype)
    two = xp.asarray(2, dtype=dtype)
    one_c = xp.asarray(1, dtype=dtype)
    if xp is torch:
        two_pi, two, one_c = (t.to(f1.device) for t in (two_pi, two, one_c))
    if dist == "uniform":
        re, im = f1, f2
    elif dist == "uniform_signed":
        re, im = two * f1 - one_c, two * f2 - one_c
    elif dist == "normal":
        mag = xp.sqrt(-two * xp.log1p(-f1))
        arg = two_pi * f2
        re, im = mag * xp.cos(arg), mag * xp.sin(arg)
    elif dist == "unit_disk":
        mag = xp.sqrt(f1)
        arg = two_pi * f2
        re, im = mag * xp.cos(arg), mag * xp.sin(arg)
    elif dist == "unit_circle":
        arg = two_pi * f2
        re, im = xp.cos(arg), xp.sin(arg)
    elif dist == "binary":
        one = xp.ones_like(f1)
        re, im = xp.where(f1 >= 0.5, one, 0 * one), xp.where(f2 >= 0.5, one, 0 * one)
    elif dist == "binary_signed":
        one = xp.ones_like(f1)
        re, im = xp.where(f1 >= 0.5, one, -one), xp.where(f2 >= 0.5, one, -one)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return re, im


def random_np(dist: str, seed: int, i, j, dtype=np.float64) -> np.ndarray:
    """Element values at global indices (i, j); real or complex dtype.

    Matches reference generate_float<scalar_t, dist>(seed, i, j)
    (random.cc:104-160): one philox call per element; float1 -> re,
    float2 -> im (imaginary discarded for real types)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        real_t = np.float32 if dtype == np.complex64 else np.float64
    else:
        real_t = dtype.type
    bits1, bits2 = philox_2x64_np(i, j, seed)
    f1 = _bits_to_unit_np(bits1, real_t)
    f2 = _bits_to_unit_np(bits2, real_t)
    re, im = _apply_dist(f1, f2, dist, real_t, np)
    if dtype.kind == "c":
        return (re + 1j * im).astype(dtype)
    return re.astype(dtype)


def random_torch(dist: str, seed: int, i: torch.Tensor, j: torch.Tensor,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """torch twin of random_np on i's device; bit-identical to it for
    the uniform and binary families in float32/float64."""
    if dtype.is_complex:
        real_t = torch.float32 if dtype == torch.complex64 else torch.float64
    else:
        real_t = dtype
    bits1, bits2 = philox_2x64_torch(i, j, seed)
    f1 = _bits_to_unit_torch(bits1, real_t)
    f2 = _bits_to_unit_torch(bits2, real_t)
    re, im = _apply_dist(f1, f2, dist, real_t, torch)
    if dtype.is_complex:
        return torch.complex(re, im).to(dtype)
    return re.to(dtype)
