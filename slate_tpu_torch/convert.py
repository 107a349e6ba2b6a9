"""Carry matrices and factors across from the JAX package.

``matrix_from_reference`` takes the JAX package's storage-order tile
array (as a numpy array) and the plain fields of its layout and view,
and returns this package's matrix with the same storage, element for
element.  It is the counterpart of carrying weights across, and it needs
nothing of the JAX package itself:

    M = matrix_from_reference(
        np.asarray(A.data), m=A.layout.m, n=A.layout.n, mb=A.layout.mb,
        nb=A.layout.nb, p=A.layout.p, q=A.layout.q,
        kind=type(A).__name__, uplo=A.uplo.name, op=A.op.name,
        diag=A.diag.name, device="cpu")

The band kinds (``BandMatrix``, ``TriangularBandMatrix``,
``HermitianBandMatrix``) also take their bandwidths: ``kl=A.kl,
ku=A.ku`` or ``kd=A.kd``.

``pivots_from_reference`` takes its pivots' forward permutation (and a
windowed ``gbtrf``'s ``band_lperms`` / ``band_w``, so ``gbtrs`` can
solve with a band factorization the JAX package made), and
``getrf_from_reference`` a whole ``getrf`` result (the LU's tile array
and the permutation), so this package's ``getrs`` and
``getrs_from_global`` can solve with a factorization the JAX package
made.  ``geqrf_from_reference`` does the same for a ``geqrf`` result (the
factor's tile array and the T stack), for ``unmqr``, ``gels_solve_from_global``
and the LQ drivers.  ``he2hb_from_reference`` takes a ``he2hb`` result
(the band's, V's tile arrays and the T stack), so this package's
``unmtr_he2hb`` can apply the JAX package's reflectors, and
``ge2tb_from_reference`` a ``ge2tb`` result (the band's, both reflector
sets' tile arrays and both T stacks) for ``unmbr_ge2tb_left`` / ``_right``.
``factor_entry_from_reference`` takes one entry of
the JAX package's serve factor cache (its numpy factor, permutation,
bucket key and n, read by attribute) and returns this package's
``FactorEntry`` with the factor on a device, so a factor the JAX
package cached can serve hits in this package's ``FactorCache``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .enums import Diag, Op, Uplo
from .matrix.base import BaseMatrix
from .matrix.matrix import (
    BandMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    Matrix,
    SymmetricMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
)
from .parallel.grid import ProcessGrid
from .parallel.layout import TileLayout
from .types import Pivots, TriangularFactors

_KINDS = {
    "Matrix": Matrix,
    "TriangularMatrix": TriangularMatrix,
    "SymmetricMatrix": SymmetricMatrix,
    "HermitianMatrix": HermitianMatrix,
    "BandMatrix": BandMatrix,
    "TriangularBandMatrix": TriangularBandMatrix,
    "HermitianBandMatrix": HermitianBandMatrix,
}


def _enum(cls, v):
    return v if isinstance(v, cls) else cls.from_string(str(v))


def matrix_from_reference(
    data: np.ndarray,
    *,
    m: int,
    n: int,
    mb: int,
    nb: int,
    p: int = 1,
    q: int = 1,
    kind: str = "Matrix",
    uplo: Union[str, Uplo] = "General",
    op: Union[str, Op] = "NoTrans",
    diag: Union[str, Diag] = "NonUnit",
    kl: int = 0,
    ku: int = 0,
    kd: int = 0,
    device: Union[str, torch.device] = "cuda:0",
) -> BaseMatrix:
    """This package's matrix with the JAX package's tile storage (a
    (P, Q, mb, nb) array in owner-major order) on ``device``.  The p x q
    grid is kept as a logical grid on that one device.  ``kl``/``ku``
    are a BandMatrix's bandwidths, ``kd`` a triangular or Hermitian
    band's."""
    if kind not in _KINDS:
        raise ValueError(f"unknown matrix kind {kind!r}; one of {sorted(_KINDS)}")
    layout = TileLayout(m, n, mb, nb, p, q)
    grid = ProcessGrid(torch.device(device), p, q)
    T = torch.tensor(np.asarray(data), device=grid.device)
    cls = _KINDS[kind]
    if cls is Matrix:
        return Matrix(T, layout, grid=grid, op=_enum(Op, op))
    if cls is BandMatrix:
        return BandMatrix(T, layout, grid=grid, op=_enum(Op, op), kl=kl, ku=ku)
    if issubclass(cls, TriangularBandMatrix):
        return cls(T, layout, grid=grid, op=_enum(Op, op), kd=kd, uplo=_enum(Uplo, uplo),
                   diag=_enum(Diag, diag))
    return cls(T, layout, grid=grid, op=_enum(Op, op), uplo=_enum(Uplo, uplo),
               diag=_enum(Diag, diag))


def pivots_from_reference(perm: np.ndarray,
                          device: Union[str, torch.device] = "cuda:0",
                          band_lperms: Optional[np.ndarray] = None,
                          band_w: Optional[int] = None) -> Pivots:
    """This package's Pivots for the JAX package's ``Pivots.perm`` (a
    forward row permutation over the padded rows), as int32 on
    ``device``; a windowed ``gbtrf``'s ``band_lperms`` (int32 there too)
    and ``band_w`` when given."""
    lperms = None if band_lperms is None else torch.tensor(
        np.asarray(band_lperms), dtype=torch.int32, device=device)
    return Pivots(torch.tensor(np.asarray(perm), dtype=torch.int32, device=device),
                  band_lperms=lperms, band_w=None if band_w is None else int(band_w))


def getrf_from_reference(lu_data: np.ndarray, perm: np.ndarray, *, m: int, n: int,
                         mb: int, nb: int, p: int = 1, q: int = 1,
                         device: Union[str, torch.device] = "cuda:0"):
    """(LU, pivots) of this package for a JAX package ``getrf`` result:
    ``lu_data`` the LU's storage-order tile array, ``perm`` its pivots'
    permutation."""
    LU = matrix_from_reference(lu_data, m=m, n=n, mb=mb, nb=nb, p=p, q=q, device=device)
    return LU, pivots_from_reference(perm, device)


def geqrf_from_reference(fac_data: np.ndarray, T: np.ndarray, *, m: int, n: int, mb: int,
                         nb: int, p: int = 1, q: int = 1,
                         device: Union[str, torch.device] = "cuda:0"):
    """(factored Matrix, TriangularFactors) of this package for a JAX
    package ``geqrf`` result: ``fac_data`` the factor's storage-order tile
    array (V below the diagonal, R on and above), ``T`` its
    TriangularFactors' (num_panels, nb, nb) stack."""
    fac = matrix_from_reference(fac_data, m=m, n=n, mb=mb, nb=nb, p=p, q=q, device=device)
    return fac, TriangularFactors(torch.tensor(np.asarray(T), device=fac.device))


def he2hb_from_reference(band_data: np.ndarray, V_data: np.ndarray, T: np.ndarray, *,
                         n: int, nb: int, uplo: Union[str, Uplo] = "Lower", p: int = 1,
                         q: int = 1, device: Union[str, torch.device] = "cuda:0"):
    """(HermitianBandMatrix, V Matrix, TriangularFactors) of this package
    for a JAX package ``he2hb`` result: ``band_data`` and ``V_data`` the
    band's and the reflectors' storage-order tile arrays (tiles of nb,
    kd = nb), ``T`` its TriangularFactors' (num_panels, nb, nb) stack."""
    band = matrix_from_reference(band_data, m=n, n=n, mb=nb, nb=nb, p=p, q=q,
                                 kind="HermitianBandMatrix", uplo=uplo, kd=nb, device=device)
    V = matrix_from_reference(V_data, m=n, n=n, mb=nb, nb=nb, p=p, q=q, device=device)
    return band, V, TriangularFactors(torch.tensor(np.asarray(T), device=band.device))


def ge2tb_from_reference(band_data: np.ndarray, UV_data: np.ndarray, UT: np.ndarray,
                         VV_data: np.ndarray, VT: np.ndarray, *, m: int, n: int, nb: int,
                         p: int = 1, q: int = 1, device: Union[str, torch.device] = "cuda:0"):
    """(TriangularBandMatrix, UV Matrix, UT, VV Matrix, VT) of this
    package for a JAX package ``ge2tb`` result: the upper band's (kd =
    nb) and the left reflectors' m x n storage-order tile arrays, the
    right reflectors' n x n one (tiles of nb), and the two
    TriangularFactors' (num_panels, nb, nb) stacks."""
    band = matrix_from_reference(band_data, m=m, n=n, mb=nb, nb=nb, p=p, q=q,
                                 kind="TriangularBandMatrix", uplo="Upper", kd=nb, device=device)
    UV = matrix_from_reference(UV_data, m=m, n=n, mb=nb, nb=nb, p=p, q=q, device=device)
    VV = matrix_from_reference(VV_data, m=n, n=n, mb=nb, nb=nb, p=p, q=q, device=device)
    UT, VT = (TriangularFactors(torch.tensor(np.asarray(T), device=band.device)) for T in (UT, VT))
    return band, UV, UT, VV, VT


def factor_entry_from_reference(entry, device: Union[str, torch.device] = "cuda:0"):
    """This package's serve ``FactorEntry`` for a JAX package
    ``serve.factor_cache.FactorEntry``: the same fingerprint, routine,
    bucket key (through its JSON form) and n, the bucket-padded factor
    as a tensor on ``device`` and the permutation as int64 there."""
    from .serve.buckets import BucketKey
    from .serve.factor_cache import FactorEntry

    perm = None if entry.perm is None else torch.tensor(
        np.asarray(entry.perm), dtype=torch.int64, device=device)
    return FactorEntry(fp=str(entry.fp), routine=str(entry.routine),
                       key=BucketKey.from_json(entry.key.to_json()),
                       factor=torch.tensor(np.asarray(entry.factor), device=device),
                       perm=perm, n=int(entry.n), replica=entry.replica)
