"""Deterministic test-matrix generator, the port of the JAX package's
``matgen/generate.py`` (reference: matgen/ — ~30 named kinds with
condition-controlled spectra; kind grammar parsed in
generate_matrix_utils.cc:211-360; special-matrix formulas
generate_matrix_ge.cc:80-465; sigma distributions generate_sigma.hh:39-130;
svd/heev constructions generate_type_svd.hh / generate_type_heev.hh).

Kind grammar (identical to the reference):

    base[_dist][_scale][_modifier...]   tokens split on '_' or '-'

      base:     zeros ones identity ij jordan jordanT chebspec circul
                fiedler gfpp kms orthog riemann ris zielkeNS diag svd poev
                heev geev geevx minij hilb frank lehmer lotkin redheff triw
                tridiag toeppen pei parter moler cauchy chow clement gcdmat
                rand rands randn randb randr
      dist:     rand rands randn logrand arith geo cluster0 cluster1
                rarith rgeo rcluster0 rcluster1 specified
                (only for diag/svd/poev/heev/geev/geevx; default logrand)
      scale:    small large ufl ofl
      modifier: dominant, zerocol<N|fraction>

Every element draw comes from the Philox (i, j)-keyed RNG
(``philox.random_torch``, on the device the matrix is made on), so a
kind is bit-reproducible for a seed on one device, whatever the tiling.
The uniform and binary draws are bitwise equal to the JAX package's;
the normal ones agree to a few ulps (``philox.py``).  The orthogonal
factors of the spectrum kinds go through the port's ``householder.geqrf``
(the library QR on the CPU, ``qr_fast.geqrf_fast`` on a CUDA device from
n = 1024), so they match the JAX package's to rounding.

The entry points run on ``cuda:0`` unless given a device or a grid;
``cond_matrix`` returns a numpy array, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..exceptions import SlateError
from ..internal.precision import hdot
from ..matrix.base import BaseMatrix
from ..matrix.matrix import Matrix
from ..parallel.grid import default_grid
from ..parallel.layout import tiles_from_global
from . import philox

_RAND_KINDS = {
    "rand": "uniform",
    "rands": "uniform_signed",
    "randn": "normal",
    "randb": "binary",
    "randr": "binary_signed",
}

_DISTS = (
    "rand", "rands", "randn", "logrand", "arith", "geo", "cluster0",
    "cluster1", "rarith", "rgeo", "rcluster0", "rcluster1", "specified",
)

_SPECTRUM_KINDS = ("diag", "svd", "poev", "heev", "geev", "geevx")

#: element rows of one ``generate_tiles`` pass: the Philox limbs of a
#: pass take about 40 int64 temporaries of its size, so 2^23 elements
#: (a 512-row strip of a 16384-wide matrix) stay near 3 GB
_TILE_PASS_ELEMENTS = 1 << 23


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_grid().device


def _where(c: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where`` with Python-number branches taken as float64 (a
    bare number would make the result torch's default float32)."""
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=c.device)  # noqa: E731
    return torch.where(c, f64(a), f64(b))


def _ij_grids(m, n, device=None):
    i = torch.arange(m, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(n, dtype=torch.float64, device=device)[None, :]
    return torch.broadcast_tensors(i + 0 * j, 0 * i + j)


def _draw(dist: str, seed: int, m: int, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(m, n) Philox draws keyed by (i, j) on ``device``."""
    i = torch.arange(m, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return philox.random_torch(dist, seed, i, j, dtype)


def _special_entry(base: str, m: int, n: int, dtype, device=None) -> torch.Tensor:
    """Elementwise special matrices (generate_matrix_ge.cc:80-465)."""
    dtype = _torch_dtype(dtype)
    i, j = _ij_grids(m, n, device)
    mx = max(m, n)
    pi = np.pi
    one = 1.0
    w = _where
    if base == "zeros":
        G = torch.zeros((m, n), dtype=torch.float64, device=device)
    elif base == "ones":
        G = torch.ones((m, n), dtype=torch.float64, device=device)
    elif base == "identity":
        G = w(i == j, 1.0, 0.0)
    elif base == "ij":
        s = 1.0 / 10 ** math.ceil(math.log10(max(n, 2)))
        G = i + j * s
    elif base == "jordan":
        G = w((i == j) | (i + 1 == j), 1.0, 0.0)
    elif base == "jordanT":
        G = w((i == j) | (i == j + 1), 1.0, 0.0)
    elif base == "chebspec":
        x_i = torch.cos(pi * (i + 1) / mx)
        x_j = torch.cos(pi * (j + 1) / mx)
        c_i = w(i == mx - 1, 2.0, 1.0)
        c_j = w(j == mx - 1, 2.0, 1.0)
        sgn = w((i + j) % 2 == 0, 1.0, -1.0)
        off = sgn * c_i / (c_j * (x_j - x_i + w(i == j, 1.0, 0.0)))
        last = (2.0 * mx * mx + 1) / -6.0
        diag = w(j + 1 == mx, last, -0.5 * x_i / (one - x_i * x_i))
        G = w(i == j, diag, off)
    elif base == "circul":
        diff = j - i
        G = diff + w(diff < 0, float(mx), 0.0) + 1
    elif base == "fiedler":
        G = torch.abs(j - i)
    elif base == "gfpp":
        G = w(j == n - 1, 1.0, w(i > j, -1.0, w(i == j, 0.5, 0.0)))
    elif base == "kms":
        G = torch.pow(0.5, torch.abs(j - i))
    elif base == "orthog":
        G = math.sqrt(2.0 / (mx + 1)) * torch.sin((i + 1) * (j + 1) * pi / (mx + 1))
    elif base == "riemann":
        bi, bj = i + 2, j + 2
        G = w(bj % bi == 0, bj - 1.0, -1.0)
    elif base == "ris":
        G = 0.5 / (mx - j - i - 0.5)
    elif base == "zielkeNS":
        G = w(j < i, 1.0, w((j + 1 == mx) & (i == 0), -1.0, 0.0))
    elif base == "minij":
        G = torch.minimum(i, j) + 1
    elif base == "hilb":
        G = 1.0 / (i + j + 1)
    elif base == "frank":
        G = w(i - j > 1, 0.0, w(i - j == 1, mx - j - 1.0, mx - j + 0.0))
    elif base == "lehmer":
        G = (torch.minimum(i, j) + 1) / (torch.maximum(i, j) + 1)
    elif base == "lotkin":
        G = w(i == 0, 1.0, 1.0 / (i + j + 1))
    elif base == "redheff":
        G = w(((j + 1) % (i + 1) == 0) | (j == 0), 1.0, 0.0)
    elif base == "triw":
        G = w(i == j, 1.0, w(i > j, 0.0, -1.0))
    elif base == "tridiag":
        G = w(i == j, 2.0, w(torch.abs(i - j) == 1, -1.0, 0.0))
    elif base == "toeppen":
        G = w(torch.abs(j - i) == 1, (j - i) * 10.0, w(torch.abs(i - j) == 2, 1.0, 0.0))
    elif base == "pei":
        G = w(i == j, 2.0, 1.0)
    elif base == "parter":
        G = 1.0 / (i - j + 0.5)
    elif base == "moler":
        G = w(i == j, i + 1.0, torch.minimum(i, j) - 1.0)
    elif base == "cauchy":
        G = 1.0 / (i + j + 2)
    elif base == "chow":
        G = w(i - j < -1, 0.0, 1.0)
    elif base == "clement":
        G = w(i - j == 1, mx - j - 1.0, w(i - j == -1, j + 0.0, 0.0))
    elif base == "gcdmat":
        ii = torch.arange(1, m + 1, device=device)[:, None]
        jj = torch.arange(1, n + 1, device=device)[None, :]
        G = torch.gcd(ii, jj).to(torch.float64)
    else:
        raise SlateError(f"unknown matrix kind base: {base!r}")
    return G.to(dtype)


def _sigma(dist: str, min_mn: int, cond: float, sigma_max: float, seed: int,
           real_t, specified=None, device=None) -> torch.Tensor:
    """Singular/eigen value distribution (generate_sigma.hh:39-130)."""
    idx = torch.arange(min_mn, dtype=torch.float64, device=device)
    denom = max(min_mn - 1, 1)
    if dist == "arith":
        s = 1 - idx / denom * (1 - 1 / cond)
    elif dist == "rarith":
        s = 1 - (min_mn - 1 - idx) / denom * (1 - 1 / cond)
    elif dist == "geo":
        s = torch.pow(cond, -idx / denom)
    elif dist == "rgeo":
        s = torch.pow(cond, -(min_mn - 1 - idx) / denom)
    elif dist == "cluster0":
        s = _where(idx == 0, 1.0, 1 / cond)
    elif dist == "rcluster0":
        s = _where(idx == min_mn - 1, 1.0, 1 / cond)
    elif dist == "cluster1":
        s = _where(idx == min_mn - 1, 1 / cond, 1.0)
    elif dist == "rcluster1":
        s = _where(idx == 0, 1 / cond, 1.0)
    elif dist == "logrand":
        u = _draw("uniform", seed, min_mn, 1, torch.float64, device)[:, 0]
        s = torch.exp(u * math.log(1 / cond))
    elif dist in ("rand", "rands", "randn"):
        s = _draw({"rand": "uniform", "rands": "uniform_signed", "randn": "normal"}[dist],
                  seed, min_mn, 1, torch.float64, device)[:, 0]
    elif dist == "specified":
        if specified is None:
            raise SlateError("dist 'specified' requires sigma values")
        s = torch.as_tensor(np.asarray(specified, np.float64), device=device)
    else:
        raise SlateError(f"unknown sigma distribution {dist!r}")
    return (s * sigma_max).to(_torch_dtype(real_t))


def _random_orthogonal(m: int, k: int, seed: int, dtype, device=None) -> torch.Tensor:
    """Random Householder-based orthogonal factor (generate_type_svd.hh:
    90-123: randn matrix -> geqrf -> Q), on ``device``."""
    from ..ops.householder import geqrf, larft, materialize_v

    dtype = _torch_dtype(dtype)
    X = _draw("normal", seed, m, k, torch.complex128 if dtype.is_complex else torch.float64,
              device)
    vr, taus = geqrf(X)
    Q = torch.eye(m, k, dtype=vr.dtype, device=vr.device)
    # Q = H_0 ... H_{k-1} I  via blocked application
    nb = min(32, k)
    for k0 in range(((k + nb - 1) // nb) - 1, -1, -1):
        w = min(nb, k - k0 * nb)
        Vk = materialize_v(vr[:, k0 * nb : k0 * nb + w], offset=k0 * nb)
        Tk = larft(Vk, taus[k0 * nb : k0 * nb + w])
        W = hdot(Vk.mH, Q)
        Q = Q - hdot(Vk, hdot(Tk, W))
    return Q.to(dtype)


def parse_kind(kind: str):
    """Kind-string parsing (generate_matrix_utils.cc:211-360)."""
    tokens = [t for t in kind.replace("-", "_").split("_")]
    if not tokens or not tokens[0]:
        raise SlateError("empty matrix kind")
    base, *mods = tokens
    dist = None
    sigma_max = 1.0
    dominant = False
    zero_col = None
    ufl = np.finfo(np.float64).tiny
    ofl = 1 / ufl
    for tok in mods:
        if tok in _DISTS:
            dist = tok
        elif tok == "small":
            sigma_max = math.sqrt(ufl)
        elif tok == "large":
            sigma_max = math.sqrt(ofl)
        elif tok == "ufl":
            sigma_max = ufl
        elif tok == "ofl":
            sigma_max = ofl
        elif tok == "dominant":
            dominant = True
        elif tok.startswith("zerocol"):
            v = tok[7:]
            zero_col = float(v) if "." in v else int(v)
        else:
            raise SlateError(f"in {kind!r}: unknown suffix {tok!r}")
    if dist is not None and base not in _SPECTRUM_KINDS:
        raise SlateError(f"in {kind!r}: base {base!r} doesn't support distribution")
    if dist is None:
        dist = "logrand"
    return base, dist, sigma_max, dominant, zero_col


def _set_diag_rowsum(G: torch.Tensor, min_mn: int) -> torch.Tensor:
    """The ``dominant`` modifier: each diagonal entry set to its row's
    sum of magnitudes."""
    rowsum = torch.sum(torch.abs(G), dim=1)
    G = G.clone()
    idx = torch.arange(min_mn, device=G.device)
    G[idx, idx] = rowsum[:min_mn].to(G.dtype)
    return G


def generate_2d(
    kind: str,
    m: int,
    n: int,
    dtype=np.float64,
    seed: int = 42,
    cond: Optional[float] = None,
    sigma_specified=None,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Generate the (m, n) global tensor for `kind` on ``device``
    (default ``cuda:0``); returns (A, Sigma)."""
    base, dist, sigma_max, dominant, zero_col = parse_kind(kind)
    dtype = _torch_dtype(dtype)
    dev = _device(device)
    real_t = _real_dtype(dtype)
    if cond is None:
        cond = float(1.0 / math.sqrt(torch.finfo(real_t).eps))
    min_mn = min(m, n)
    Sigma = None

    if base in _RAND_KINDS:
        G = _draw(_RAND_KINDS[base], seed, m, n, dtype, dev)
        if sigma_max != 1.0:
            G = G * sigma_max
        if dominant:
            # generate_rand: diag += row-sum bound (max_mn) to dominate
            G = _set_diag_rowsum(G, min_mn)
            dominant = False
    elif base == "diag":
        Sigma = _sigma(dist, min_mn, cond, sigma_max, seed, real_t, sigma_specified, dev)
        G = torch.zeros((m, n), dtype=dtype, device=dev)
        idx = torch.arange(min_mn, device=dev)
        G[idx, idx] = Sigma.to(dtype)
    elif base in ("svd", "poev", "heev", "geev", "geevx"):
        Sigma = _sigma(dist, min_mn, cond, sigma_max, seed, real_t, sigma_specified, dev)
        if base == "heev":
            # signed spectrum (generate_heev rand_sign)
            signs = _draw("binary_signed", seed + 3, min_mn, 1, torch.float64, dev)[:, 0]
            Sigma = (Sigma * signs).to(real_t)
        U = _random_orthogonal(m, min_mn, seed + 1, dtype, dev)
        if base == "svd":
            V = _random_orthogonal(n, min_mn, seed + 2, dtype, dev)
            G = hdot(U * Sigma.to(dtype)[None, :], V.mH)
        elif base in ("poev", "heev"):
            G = hdot(U * Sigma.to(dtype)[None, :], U.mH)
        else:  # geev/geevx: known spectrum, non-normal: A = U T U^H,
            # T upper triangular with Sigma diagonal (Schur-form based,
            # generate_type_geev.hh)
            N = _draw("normal", seed + 4, min_mn, min_mn, dtype, dev)
            # mild non-normality: keep the eigenproblem well-conditioned so
            # the spectrum is numerically recoverable
            noise = float(torch.abs(Sigma).max()) / (4.0 * math.sqrt(min_mn))
            T = noise * torch.triu(N, 1) + torch.diag(Sigma.to(dtype))
            G = hdot(hdot(U, T), U.mH)
        G = G.to(dtype)
    else:
        G = _special_entry(base, m, n, dtype, dev)

    if dominant:
        G = _set_diag_rowsum(G, min_mn)
    if zero_col is not None:
        col = int(zero_col * (n - 1)) if isinstance(zero_col, float) else zero_col
        if not (0 <= col < n):
            raise SlateError(f"zerocol {col} outside [0, {n})")
        G = G.clone()
        G[:, col] = 0
    return G, Sigma


def generate_tiles(kind: str, layout, dtype, seed: int = 42,
                   device=None) -> Optional[torch.Tensor]:
    """Device-side generation of the (P, Q, mb, nb) storage-order tile
    tensor for the plain rand kinds: every element draws from the Philox
    counter RNG keyed by its *global* (i, j), so the result is invariant
    to tiling (reference: matgen/random.cc:43-100).  The tile rows are
    made a strip at a time (about ``_TILE_PASS_ELEMENTS`` elements a
    pass), which bounds the Philox temporaries and changes no bit.
    Padding elements are zero.  Returns None for kinds that need global
    structure (spectra, special matrices, dominant/zerocol suffixes);
    callers fall back to ``generate_2d``."""
    base, dist, sigma_max, dominant, zero_col = parse_kind(kind)
    if base not in _RAND_KINDS or dominant or zero_col is not None:
        return None
    dtype = _torch_dtype(dtype)
    dev = _device(device)
    P, Q, mb, nb = layout.storage_shape
    gr = torch.as_tensor(layout.global_rows_np.astype(np.int64), device=dev)  # (P, mb)
    gc = torch.as_tensor(layout.global_cols_np.astype(np.int64), device=dev)  # (Q, nb)
    mask = layout.element_mask(dev)
    T = torch.empty((P, Q, mb, nb), dtype=dtype, device=dev)
    rows = max(1, _TILE_PASS_ELEMENTS // max(Q * nb, 1))  # element rows a pass
    for p in range(P):
        for r0 in range(0, mb, rows):
            r1 = min(mb, r0 + rows)
            i = gr[p, r0:r1][None, :, None]  # (1, r, 1)
            j = gc[:, None, :]  # (Q, 1, nb)
            S = philox.random_torch(_RAND_KINDS[base], seed, i, j, dtype)  # (Q, r, nb)
            if sigma_max != 1.0:
                S = S * sigma_max
            T[p, :, r0:r1, :] = torch.where(mask[p, :, r0:r1, :], S, 0)
    return T


def generate_matrix(
    kind: str,
    A: BaseMatrix,
    seed: int = 42,
    cond: Optional[float] = None,
    sigma_specified=None,
) -> Tuple[BaseMatrix, Optional[torch.Tensor]]:
    """Fill an existing matrix's shape/layout with `kind`, on its device
    (reference: slate::generate_matrix, include/slate/generate_matrix.hh:
    29-60).

    Plain rand kinds generate directly on the device per tile
    (generate_tiles); structured kinds assemble the global tensor."""
    lay = A.resolved().layout
    T = generate_tiles(kind, lay, A.dtype, seed, A.device)
    if T is not None:
        return A._with(data=T), None
    G, Sigma = generate_2d(
        kind, A.m, A.n, A.dtype, seed=seed, cond=cond,
        sigma_specified=sigma_specified, device=A.device,
    )
    return A._with(data=tiles_from_global(G, lay)), Sigma


def generate(
    kind: str,
    m: int,
    n: int,
    mb: int,
    nb: Optional[int] = None,
    dtype=np.float64,
    grid=None,
    seed: int = 42,
    cond: Optional[float] = None,
) -> Matrix:
    """Convenience constructor: generate a fresh Matrix on the grid's
    device (``default_grid()`` when none is given)."""
    grid = grid if grid is not None else default_grid()
    G, _ = generate_2d(kind, m, n, dtype, seed=seed, cond=cond, device=grid.device)
    return Matrix.from_global(G, mb, nb, grid=grid)


def cond_matrix(
    n: int,
    cond: float,
    dtype=np.float64,
    seed: int = 42,
    spd: bool = False,
    device=None,
) -> np.ndarray:
    """Deterministic n x n matrix with **specified 2-norm condition
    number** via scaled-singular-value construction: A = U diag(s) V^H
    with s geometrically spaced from 1 down to 1/cond (``geo``
    distribution, generate_sigma.hh:39-130) and Philox-seeded random
    orthogonal factors — so sigma_max = 1, sigma_min = 1/cond and
    cond_2(A) = cond by construction (to rounding), reproducible for a
    seed on one device.  Built on ``device`` (default ``cuda:0``) and
    returned as a numpy array.

    ``spd=True`` uses one orthogonal factor (A = U diag(s) U^H, the
    ``poev`` construction): symmetric/Hermitian positive definite with
    the same 2-norm condition number.

    The knob the refine tests are built on: iterative-refinement
    convergence (cond such that cond * eps_factor << 1), stall
    (~1/eps_factor — where GMRES-IR still converges), and divergence +
    fallback (>> 1/eps_factor) become deterministic properties of the
    requested cond instead of luck-of-the-draw spectra."""
    if cond < 1:
        raise SlateError(f"cond must be >= 1, got {cond}")
    kind = "poev_geo" if spd else "svd_geo"
    G, _ = generate_2d(kind, n, n, dtype, seed=seed, cond=float(cond), device=device)
    return G.cpu().numpy()
