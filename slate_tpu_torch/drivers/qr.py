"""QR/LQ/least-squares drivers (reference: src/geqrf.cc, unmqr.cc,
gelqf.cc, unmlq.cc, cholqr.cc, gels.cc, gels_qr.cc, gels_cholqr.cc), the
single-device path of the JAX package's ``drivers/qr.py``.

Factor representation: the returned matrix stores R on and above the
diagonal and the Householder vectors V (implicit unit diagonal) below;
the TriangularFactors hold one compact-WY T per tile panel (the
reference's Tlocal).  ``geqrf`` factors the padded global tensor through
the schedule dispatcher of ops/qr_fast.py: on a CUDA device at n >= 2048
``auto`` takes the ``pallas`` family, whose base panels assemble their T
through the Hopper ``larft`` kernel.  ``gels_solve_from_global`` is the
solve-only entry point of a factor cache hit over the serve tier's
packed factor.

Not ported yet: the mesh path (``spmd_qr``, ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ..aux import metrics
from ..aux.metrics import instrumented
from ..enums import MethodGels, Op, Option, Side, Uplo
from ..exceptions import slate_assert
from ..internal.precision import hdot
from ..matrix.base import BaseMatrix, conj_transpose
from ..matrix.matrix import HermitianMatrix, Matrix, TriangularMatrix
from ..ops import qr_fast
from ..ops.householder import apply_block_reflector, geqrf as _geqrf_kernel, larft, materialize_v
from ..options import Options, get_option, resolve_schedule_opts
from ..parallel.layout import TileLayout, tiles_from_global
from ..types import TriangularFactors
from . import blas3, chol


def _padded_global_splice(A: BaseMatrix) -> torch.Tensor:
    """A's global tensor padded to whole tiles (P mb, Q nb), with ones on
    the padding diagonal."""
    lay = A.layout
    G = A.resolved().to_global()
    mp, npd = lay.P * lay.mb, lay.Q * lay.nb
    Gp = torch.nn.functional.pad(G, (0, npd - lay.n, 0, mp - lay.m))
    idx = torch.arange(min(lay.m, lay.n), min(mp, npd), device=Gp.device)
    Gp[idx, idx] += 1
    return Gp


@instrumented("geqrf")
def geqrf(A: Matrix, opts: Optional[Options] = None) -> Tuple[Matrix, TriangularFactors]:
    """Householder QR: A = Q R (reference: src/geqrf.cc).

    Returns (factored, T): factored stores V below the diagonal and R on
    and above; T holds the per-tile-panel compact-WY factors."""
    slate_assert(A.layout.mb == A.layout.nb, "geqrf requires square tiles")
    lay = A.layout
    nb = lay.nb
    kt = min(lay.mt, lay.nt)
    Gp = _padded_global_splice(A)
    mp, npd = Gp.shape
    sched, nb_switch, _ = resolve_schedule_opts(opts)
    # one resolver decides both the kernel and the accounting route
    route = qr_fast.resolve_qr_schedule(mp, npd, Gp.dtype, sched, Gp.device)
    if metrics.is_on():
        metrics.record_factor_flops("geqrf", qr_fast.geqrf_schedule_flops(
            mp, npd, nb, route, nb_switch, m_true=lay.m, n_true=lay.n))
    if route == "pallas":
        vr, taus = qr_fast.geqrf_pallas(Gp, nb_switch)
    elif route == "recursive":
        vr, taus = qr_fast.geqrf_recursive(Gp, nb_switch)
    elif route == "flat" and sched == "flat":
        # explicit flat runs the native schedule on every device (the auto
        # flat route lets householder.geqrf pick, the same schedule)
        vr, taus = qr_fast.geqrf_flat(Gp)
    else:
        vr, taus = _geqrf_kernel(Gp)
    Ts = [larft(materialize_v(vr[:, k * nb:(k + 1) * nb], offset=k * nb),
                taus[k * nb:(k + 1) * nb]) for k in range(kt)]
    Tstack = torch.stack(Ts) if Ts else vr.new_zeros((0, nb, nb))
    fac = A._with(data=tiles_from_global(vr[: lay.m, : lay.n], lay))
    return fac, TriangularFactors(Tstack)


def _vt_panels(fac: Matrix) -> Iterator[Tuple[int, torch.Tensor]]:
    """(k, V_k) for the tile panels of the factored matrix's global form;
    V_k is full height with zeros above the panel's diagonal."""
    lay = fac.layout
    nb = lay.nb
    G = fac.to_global()
    for k in range(min(lay.mt, lay.nt)):
        ncols = min(nb, lay.n - k * nb)
        yield k, materialize_v(G[:, k * nb:k * nb + ncols], offset=k * nb)


@instrumented("unmqr")
def unmqr(side: Side, op: Op, fac: Matrix, T: TriangularFactors, C: Matrix,
          opts: Optional[Options] = None) -> Matrix:
    """Multiply by Q from geqrf (reference: src/unmqr.cc).

    side Left:  C <- Q C (NoTrans) or Q^H C (ConjTrans);
    side Right: C <- C Q or C Q^H."""
    kt = min(fac.layout.mt, fac.layout.nt)
    C2 = C.to_global()
    panels = list(_vt_panels(fac))
    forward = (side == Side.Left) == (op != Op.NoTrans)
    conj_T = op != Op.NoTrans
    for k in (range(kt) if forward else range(kt - 1, -1, -1)):
        _, Vk = panels[k]
        w = Vk.shape[1]
        Tk = T.T[k][:w, :w]
        if side == Side.Left:
            C2 = apply_block_reflector(Vk, Tk, C2, trans=conj_T)
        else:
            Tm = Tk.mH if conj_T else Tk
            C2 = C2 - hdot(hdot(hdot(C2, Vk), Tm), Vk.mH)
    return C._with(data=tiles_from_global(C2.to(C.dtype), C.layout))


def ungqr(fac: Matrix, T: TriangularFactors, opts: Optional[Options] = None) -> Matrix:
    """The m x min(m, n) orthogonal factor Q (LAPACK orgqr analogue; the
    reference tester forms Q by unmqr on the identity, test_geqrf.cc)."""
    lay = fac.layout
    eye = torch.eye(lay.m, min(lay.m, lay.n), dtype=fac.dtype, device=fac.device)
    return unmqr(Side.Left, Op.NoTrans, fac, T,
                 Matrix.from_global(eye, lay.mb, lay.nb, grid=fac.grid), opts)


def _as_matrix(M: BaseMatrix, grid) -> Matrix:
    return Matrix(M.data, M.layout, grid=grid)


@instrumented("gelqf")
def gelqf(A: Matrix, opts: Optional[Options] = None) -> Tuple[Matrix, TriangularFactors]:
    """LQ factorization A = L Q (reference: src/gelqf.cc), as the dual of
    QR on A^H: A^H = Qr R, so A = R^H Qr^H = L Q.

    Returns (factored, T): factored stores L on and below the diagonal
    and the dual's reflectors V^H above it; T is the dual's T stack."""
    facH, T = geqrf(_as_matrix(conj_transpose(A).resolved(), A.grid), opts)
    fac = conj_transpose(facH).resolved()
    return A._with(data=fac.data, layout=fac.layout), T


def unmlq(side: Side, op: Op, fac: Matrix, T: TriangularFactors, C: Matrix,
          opts: Optional[Options] = None) -> Matrix:
    """Multiply by Q from gelqf (reference: src/unmlq.cc).  In the dual
    representation Q = Qr^H, so the op flips relative to unmqr."""
    facH = _as_matrix(conj_transpose(fac).resolved(), fac.grid)
    flip = {Op.NoTrans: Op.ConjTrans, Op.ConjTrans: Op.NoTrans, Op.Trans: Op.NoTrans}
    return unmqr(side, flip[op], facH, T, C, opts)


@instrumented("cholqr")
def cholqr(A: Matrix, opts: Optional[Options] = None
           ) -> Tuple[Matrix, TriangularMatrix, torch.Tensor]:
    """Cholesky QR (reference: src/cholqr.cc): H = A^H A by herk, R the
    upper Cholesky factor of H (potrf), Q = A R^-1 by trsm.

    Returns (Q, R, info)."""
    lay = A.layout
    h_lay = TileLayout(lay.n, lay.n, lay.nb, lay.nb, lay.p, lay.q)
    H = HermitianMatrix(torch.zeros(h_lay.storage_shape, dtype=A.dtype, device=A.device),
                        h_lay, grid=A.grid, uplo=Uplo.Upper)
    H = blas3.herk(1.0, conj_transpose(A), 0.0, H)
    R, info = chol.potrf(H, opts)
    Rtri = TriangularMatrix(R.data, R.layout, grid=A.grid, uplo=Uplo.Upper)
    Q = blas3.trsm(Side.Right, 1.0, Rtri, A, opts)
    return Q, Rtri, info


def gels_solve_from_global(Fg: torch.Tensor, Bg: torch.Tensor, m: int, nb: int) -> torch.Tensor:
    """Least squares against a precomputed packed QR factor: the solve
    half of ``gels``, the whole work of a factor cache hit.  ``Fg`` is
    the serve tier's pack (``solve_factor_shape`` of the JAX package's
    serve/buckets.py): rows [0, m) hold the padded V/R global (V below
    the diagonal, R on and above), and the compact-WY T of the nb-wide
    column panel at column offset k sits in rows [m + k, m + k + w),
    columns [0, w).  Q^H B one block reflector a panel (the T factors
    ride in the pack, nothing is rebuilt), then one triangular solve
    against R: O(m n nrhs) against the O(m n^2) of the full gels."""
    n = Fg.shape[1]
    VR = Fg[:m]
    C = Bg
    for k in range(0, n, nb):
        w = min(nb, n - k)
        C = apply_block_reflector(materialize_v(VR[:, k:k + w], offset=k),
                                  Fg[m + k:m + k + w, :w], C, trans=True)
    # only R's upper triangle is read; the library returns column-major
    return torch.linalg.solve_triangular(VR[:n, :n], C[:n], upper=True).contiguous()


@instrumented("gels")
def gels(A: Matrix, B: Matrix, opts: Optional[Options] = None) -> Matrix:
    """Least squares / minimum-norm solve (reference: src/gels.cc with
    MethodGels QR | CholQR; gels_qr.cc, gels_cholqr.cc).

    Overdetermined (m >= n): X = argmin ||A X - B||; underdetermined: the
    minimum-norm solution through the LQ dual.  Returns X (n x nrhs)."""
    method = get_option(opts, Option.MethodGels, MethodGels.Auto)
    if isinstance(method, str):
        method = MethodGels.from_string(method)
    m, n = A.m, A.n
    nb = A.layout.nb
    if m >= n:
        if method == MethodGels.CholQR:
            Q, R, _ = cholqr(A, opts)
            QhB = blas3.gemm(1.0, conj_transpose(Q), B, 0.0,
                             Matrix.zeros(n, B.n, nb, dtype=A.dtype, grid=A.grid))
            return blas3.trsm(Side.Left, 1.0, R, QhB, opts)
        fac, T = geqrf(A, opts)
        QhB = unmqr(Side.Left, Op.ConjTrans, fac, T, B, opts)
        QhB_top = Matrix.from_global(QhB.to_global()[:n], nb, nb, grid=A.grid)
        R = TriangularMatrix.from_global(torch.triu(fac.to_global()[:n, :n]), nb, nb,
                                         grid=A.grid, uplo=Uplo.Upper)
        return blas3.trsm(Side.Left, 1.0, R, QhB_top, opts)
    # underdetermined: A = L Q, X = Q^H L^-1 B (minimum norm)
    fac, T = gelqf(A, opts)
    mb = A.layout.mb
    L = TriangularMatrix.from_global(torch.tril(fac.to_global()[:, :m]), mb, mb,
                                     grid=A.grid, uplo=Uplo.Lower)
    Y = blas3.trsm(Side.Left, 1.0, L, B, opts).to_global()
    Yfull = torch.cat([Y, Y.new_zeros((n - m, B.n))], dim=0)
    return unmlq(Side.Left, Op.ConjTrans, fac, T, Matrix.from_global(Yfull, nb, nb, grid=A.grid),
                 opts)
