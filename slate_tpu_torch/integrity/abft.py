"""Algorithm-based fault tolerance (ABFT) for the served factorizations
(the JAX package's ``integrity/abft.py``).

Huang & Abraham (IEEE Trans. Computers 1984) encode a matrix with
checksum rows and columns so that corruption is detectable from an
invariant in O(n^2) extra work.  :func:`encode` / :func:`encode_rhs`
build the bordered reference form ``[[A, A e], [e^T A, e^T A e]]``.  The
bordered matrix of an invertible A is exactly singular, so the serve
cores keep the operand unchanged and verify the checksum relations the
encoding exists for, on the device, against the factors the drivers
return:

* post-factor (LU): ``L (U e) == P (A e)``; Cholesky:
  ``L (L^H e) == A_sym e`` — two triangular matvecs, O(n^2);
* post-trsm: ``(e^T A) X == e^T B``, O(n nrhs) after the O(n^2)
  ``e^T A``.

Both are fenced at ``sqrt(eps)`` against an |L||U|e-style magnitude
bound, and the verdict is folded into the core's ``info`` as
:data:`ABFT_BAD`, a per-item flag the service's certification reads for
free.  :func:`build_core` runs the port's own ``gesv`` / ``posv``, so on
the card an ABFT bucket launches the same kernels as its plain sibling:
the factor's (panel_lu, or chol_base / syrk_diag / gemm_sub).  Their
solves are library triangular solves, as in the JAX package; the trsm
pair runs on the factor cache's solve-phase buckets.

Host-side, :func:`checksum_certificate` (numpy) runs the post-trsm
relation over the request's own operands at delivery, the cheap
certificate for ABFT buckets, covering the device-to-host leg the
on-device flag cannot see.
"""

from __future__ import annotations

import numpy as np
import torch

#: BucketKey.tag of the buckets whose cores carry the checksum checks
ABFT_TAG = "abft"

#: ``info`` of a batch item whose checksum relation failed; negative so
#: it never collides with the drivers' positive info (singular, not SPD)
ABFT_BAD = -1


# ---------------------------------------------------------------------------
# reference encoding (Huang & Abraham's bordered operand)
# ---------------------------------------------------------------------------


def encode(A: np.ndarray) -> np.ndarray:
    """The bordered encoding ``[[A, A e], [e^T A, e^T A e]]``: an
    (n+1) x (n+1) array whose last column holds the row sums and last
    row the column sums of A."""
    A = np.asarray(A)
    n = A.shape[0]
    e = np.ones((n,), dtype=A.dtype)
    c = A @ e
    w = e @ A
    out = np.zeros((n + 1, n + 1), dtype=A.dtype)
    out[:n, :n] = A
    out[:n, n] = c
    out[n, :n] = w
    out[n, n] = c.sum()
    return out


def encode_rhs(B: np.ndarray) -> np.ndarray:
    """The matching right-hand side: B with its column sums appended as
    a checksum row ((n+1) x nrhs)."""
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    return np.vstack([B, B.sum(axis=0, keepdims=True)])


# ---------------------------------------------------------------------------
# accounting mirror
# ---------------------------------------------------------------------------


def abft_flops(n: int, nrhs: int) -> float:
    """Model flops of the checks per item: the checksum vectors A e and
    e^T A (2n^2 each), the factor relation's two triangular matvecs and
    their magnitude bound (~4n^2), and the O(n nrhs) solve residual."""
    n, r = float(n), float(nrhs)
    return 8.0 * n * n + 4.0 * n * r


def overhead_ratio(key) -> float:
    """ABFT overhead as a fraction of the bucket's model flops
    (``key`` is a serve ``BucketKey``)."""
    from ..serve.buckets import phase_flops

    return abft_flops(key.n, key.nrhs) / max(phase_flops(key), 1.0)


# ---------------------------------------------------------------------------
# host-side certificate (delivery time, the request's own operands)
# ---------------------------------------------------------------------------


def checksum_certificate(A: np.ndarray, B: np.ndarray, X: np.ndarray) -> bool:
    """The post-trsm relation over a delivered solve:
    ``max|(e^T A) X - e^T B| <= sqrt(eps) scale`` with the magnitude
    scale ``|e^T A| |X| + |e^T B|``; O(n^2).  False on a non-finite X.
    Square solves only."""
    A = np.asarray(A)
    B = np.asarray(B)
    X = np.asarray(X)
    if not np.all(np.isfinite(X)):
        return False
    if B.ndim == 1:
        B = B[:, None]
    if X.ndim == 1:
        X = X[:, None]
    w = A.sum(axis=0)  # e^T A
    sb = B.sum(axis=0)  # e^T B
    r = w @ X - sb
    dt = np.result_type(A, X)
    eps = float(np.finfo(np.dtype(dt).type(0).real.dtype).eps)
    scale = float((np.abs(w) @ np.abs(X) + np.abs(sb)).max(initial=0.0))
    return float(np.abs(r).max(initial=0.0)) <= np.sqrt(eps) * max(scale, eps)


# ---------------------------------------------------------------------------
# on-device checks + serve cores
# ---------------------------------------------------------------------------


def _tol(dtype: torch.dtype) -> float:
    """sqrt(eps) of a dtype's real field."""
    return float(np.sqrt(torch.finfo(dtype.to_real() if dtype.is_complex else dtype).eps))


def _bad_solve(Ac: torch.Tensor, Bg: torch.Tensor, Xg: torch.Tensor, e: torch.Tensor,
               tol: float) -> torch.Tensor:
    """The post-trsm relation (e^T A) X == e^T B, fenced (True = BAD)."""
    w = e @ Ac
    sb = e @ Bg
    r = w @ Xg - sb
    scale = (w.abs() @ Xg.abs() + sb.abs()).max()
    return r.abs().max() > tol * torch.clamp(scale, min=tol * tol)


def gesv_check(Ag: torch.Tensor, Bg: torch.Tensor, Fg: torch.Tensor, perm: torch.Tensor,
               Xg: torch.Tensor) -> torch.Tensor:
    """Checksum verdict of one LU solve on its device: a 0-d bool tensor,
    True = BAD.  ``Fg`` is the packed LU (unit lower L below, U on and
    above), ``perm`` the forward row permutation (at least n entries),
    ``Xg`` the solution.  Post-factor ``L (U e) == (A e)[perm]`` and
    post-trsm ``(e^T A) X == e^T B``, each fenced at sqrt(eps) against a
    componentwise magnitude bound, so pivot growth never flags."""
    n = Ag.shape[0]
    e = torch.ones(n, dtype=Ag.dtype, device=Ag.device)
    er = e.real if e.is_complex() else e
    tol = _tol(Ag.dtype)
    c = Ag @ e
    cp = c[perm[:n].long()]
    U = torch.triu(Fg)
    Ls = torch.tril(Fg, -1)
    u = U @ e
    v = Ls @ u + u  # L (U e), unit diagonal
    s = U.abs() @ er
    s = Ls.abs() @ s + s  # |L| |U| e
    scale_f = s.max() + c.abs().max()
    bad_f = (v - cp).abs().max() > tol * torch.clamp(scale_f, min=tol * tol)
    return bad_f | _bad_solve(Ag, Bg, Xg, e, tol)


def posv_check(Ag: torch.Tensor, Bg: torch.Tensor, Lg: torch.Tensor,
               Xg: torch.Tensor) -> torch.Tensor:
    """Checksum verdict of one Cholesky solve (True = BAD).  ``Lg`` is the
    clean lower factor.  The operand checksum is taken over the
    symmetrized lower triangle: posv reads only the lower triangle of A,
    so junk above the diagonal must not flip the verdict."""
    n = Ag.shape[0]
    e = torch.ones(n, dtype=Ag.dtype, device=Ag.device)
    er = e.real if e.is_complex() else e
    tol = _tol(Ag.dtype)
    Asym = torch.tril(Ag) + torch.tril(Ag, -1).conj().mT
    c = Asym @ e
    v = Lg @ (Lg.conj().mT @ e)  # L L^H e
    La = Lg.abs()
    s = La @ (La.mT @ er)  # |L| |L^H| e
    scale_f = s.max() + c.abs().max()
    bad_f = (v - c).abs().max() > tol * torch.clamp(scale_f, min=tol * tol)
    return bad_f | _bad_solve(Asym, Bg, Xg, e, tol)


def _fold(info: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """Driver info wins when positive (a numerical property of the
    input, not corruption); else ABFT_BAD where the checks flagged."""
    info = info.reshape(()).to(torch.int32)
    return torch.where(info > 0, info, torch.where(
        bad, torch.full_like(info, ABFT_BAD), torch.zeros_like(info)))


def build_core(routine: str, nb: int, schedule: str):
    """The checksummed core of one ABFT bucket over one padded item:
    ``core(Ag, Bg) -> (Xg, info)``, the plain full-phase pipeline plus
    the checks, the verdict folded into ``info``.  Called by
    ``serve/cache._build_core`` for keys whose ``tag == ABFT_TAG``; the
    cache loops it over the batch."""
    from ..drivers import chol as _chol
    from ..drivers import lu as _lu
    from ..enums import Option, Uplo
    from ..matrix.matrix import HermitianMatrix, Matrix
    from ..parallel.grid import ProcessGrid

    opts = {Option.Schedule: schedule}

    if routine == "gesv":

        def core(Ag, Bg):
            g = ProcessGrid.single(Ag.device)
            X, LU, piv, info = _lu.gesv(Matrix.from_global(Ag, nb, grid=g),
                                        Matrix.from_global(Bg, nb, grid=g), opts)
            Xg = X.to_global()
            bad = gesv_check(Ag, Bg, LU.to_global(), piv.perm, Xg)
            return Xg, _fold(info, bad)

        return core

    if routine == "posv":

        def core(Ag, Bg):
            g = ProcessGrid.single(Ag.device)
            X, L, info = _chol.posv(HermitianMatrix.from_global(Ag, nb, grid=g, uplo=Uplo.Lower),
                                    Matrix.from_global(Bg, nb, grid=g), opts)
            Xg = X.to_global()
            bad = posv_check(Ag, Bg, torch.tril(L.to_global()), Xg)
            return Xg, _fold(info, bad)

        return core

    raise ValueError(f"ABFT serving supports gesv/posv, not {routine!r}")
