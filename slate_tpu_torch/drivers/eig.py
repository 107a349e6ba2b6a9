"""Hermitian eigensolver family (reference: src/heev.cc, he2hb.cc,
hb2st.cc, sterf.cc, steqr.cc, stedc*.cc, unmtr_he2hb.cc,
unmtr_hb2st.cc, hegst.cc, hegv.cc), the single-device path of the JAX
package's ``drivers/eig.py``.

heev:  he2hb (dense -> band, the O(n^3) work) -> band gather ->
       hb2st bulge chase (the native host chaser for real float64, the
       device wavefront of ops/bulge.py otherwise) -> tridiagonal
       eigensolve (stedc, or Sturm bisection for values only) ->
       unmtr_hb2st + unmtr_he2hb back-transforms.

Problems with n <= 4 nb eigensolve the gathered band with the library
``eigh`` (Jacobi-polished on a CUDA device, ops/jacobi.py); the others
run ``heev_staged``, which times the stages one by one.  PyTorch runs
eagerly, so he2hb and unmtr_he2hb work
on the active (h, h) trailing view of each step instead of the JAX
package's rolled, cropped padded array, and the stage cache of compiled
jits has no counterpart.  The hb2st route taken is counted in
``aux.metrics`` (``heev.hb2st.host`` / ``heev.hb2st.device``).

Not ported yet: the mesh branches (``spmd_he2hb``, ``spmd_hegst``,
``spmd_band_storage``; ROADMAP.md Queue 1 item 8c): a distributed operand
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .. import native
from ..aux import metrics
from ..aux.metrics import instrumented
from ..enums import MethodEig, Op, Option, Side, Uplo
from ..exceptions import slate_assert
from ..internal.precision import check_f32_precision, hdot
from ..matrix.base import conj_transpose, single_device
from ..matrix.matrix import HermitianBandMatrix, HermitianMatrix, Matrix, TriangularMatrix
from ..ops import blas2d, bulge
from ..ops.householder import _geqrf_panel, larft, materialize_v
from ..options import Options, get_option
from ..parallel.band_gather import band_storage_tiles
from ..parallel.layout import tiles_from_global
from ..types import TriangularFactors
from . import blas3, chol


@instrumented("he2hb")
@single_device("8c")
def he2hb(A: HermitianMatrix, opts: Optional[Options] = None
          ) -> Tuple[HermitianBandMatrix, Matrix, TriangularFactors]:
    """Reduce Hermitian A to band form with bandwidth nb (reference:
    src/he2hb.cc: a panel QR per tile column and a two-sided trailing
    update).

    Returns (band, V, T): the Hermitian band (kd = nb; both triangles
    stored), the block reflectors (panel k in tile column k, rows
    (k+1) nb ..) and their compact-WY factors, the inputs of
    ``unmtr_he2hb``.  Step k works on the active trailing view of
    h = n - (k+1) nb rows; the update is LAPACK hetrd's
    W = P - V Q2 / 2 form, so the rank-2nb update is one product."""
    slate_assert(A.m == A.n, "he2hb requires square")
    lay = A.layout
    nb, n, kt = lay.nb, A.n, lay.nt
    G = A.full_global()
    check_f32_precision(G)
    Vs = torch.zeros_like(G)
    Ts = G.new_zeros((max(kt - 1, 0), nb, nb))
    for k in range(kt - 1):
        lo, c0 = (k + 1) * nb, k * nb
        h = n - lo
        with record_function("he2hb.panel"):
            pan = F.pad(G[lo:, c0:c0 + nb], (0, 0, 0, max(nb - h, 0)))
            vr, taus = _geqrf_panel(pan)
            V = materialize_v(vr)
            Tk = larft(V, taus)
            V, R = V[:h], torch.triu(vr)[:h]
        G[lo:, c0:c0 + nb] = R
        G[c0:c0 + nb, lo:] = R.mH
        with record_function("he2hb.update"):
            A22 = G[lo:, lo:]
            P = hdot(A22, hdot(V, Tk))
            Q2 = hdot(Tk.mH, hdot(V.mH, P))
            W = P - hdot(V, 0.5 * Q2)
            G[lo:, lo:] = A22 - hdot(torch.cat([V, W], 1), torch.cat([W, V], 1).mH)
        Vs[lo:, c0:c0 + nb] = V
        Ts[k] = Tk
    band = HermitianBandMatrix(tiles_from_global(G, lay), lay, grid=A.grid, kd=nb, uplo=A.uplo)
    return band, Matrix(tiles_from_global(Vs, lay), lay, grid=A.grid), TriangularFactors(Ts)


@instrumented("unmtr_he2hb")
@single_device("8c")
def unmtr_he2hb(side: Side, op: Op, V: Matrix, T: TriangularFactors, C_mat: Matrix,
                opts: Optional[Options] = None) -> Matrix:
    """Apply the he2hb back-transform Q (reference: src/unmtr_he2hb.cc):
    Q = H_0 H_1 ... with H_k = I - V_k T_k V_k^H, V_k in tile column k
    from row (k+1) nb.  Each step touches only the rows (Left) or
    columns (Right) at or below (k+1) nb."""
    nb = V.layout.nb
    npanels = T.T.shape[0]
    if npanels == 0:
        return C_mat
    Vg = V.to_global()
    C2 = C_mat.to_global().clone()
    forward = (side == Side.Left) == (op != Op.NoTrans)
    for k in (range(npanels) if forward else range(npanels - 1, -1, -1)):
        Tk = T.T[k]
        Tm = Tk.mH if op != Op.NoTrans else Tk
        lo = (k + 1) * nb
        Vk = Vg[lo:, k * nb:(k + 1) * nb]
        if side == Side.Left:
            Cs = C2[lo:]
            C2[lo:] = Cs - hdot(Vk, hdot(Tm, hdot(Vk.mH, Cs)))
        else:
            Cs = C2[:, lo:]
            C2[:, lo:] = Cs - hdot(hdot(hdot(Cs, Vk), Tm), Vk.mH)
    return C_mat._with(data=tiles_from_global(C2.to(C_mat.dtype), C_mat.layout))


def _gathered_band_eig(band_2d: torch.Tensor, vectors: bool):
    """Eigensolve the gathered band matrix on one device with the
    library eigh, Jacobi-polished on a CUDA device (reference analogue:
    gathered hb2st + LAPACK steqr/stedc on one node, heev.cc:135-180)."""
    from ..ops.jacobi import eigh_accurate

    return eigh_accurate(band_2d, vectors=vectors)


def _hb2st(W: torch.Tensor, n: int, b: int, prefix: str = "heev"):
    """Stage 2 on the route the data allows: the native host chaser for
    real float64 when its library builds (its reflectors uploaded to
    W's device as they complete), the device wavefront otherwise.
    Counts the route in ``<prefix>.hb2st.host`` / ``<prefix>.hb2st.device``
    (``heev`` here, ``svd`` for the SVD's Jordan-Wielandt chase)."""
    if not W.is_complex() and W.dtype == torch.float64 and native.hb2st_available():
        metrics.inc(f"{prefix}.hb2st.host")
        if W.is_cuda:
            metrics.inc("transfer.d2h_bytes", W.numel() * W.element_size())
        d, e, VS, TAUS = native.hb2st_host_device(W, n, b, W.device)
        return d, e, torch.ones(n, dtype=W.dtype, device=W.device), VS, TAUS
    metrics.inc(f"{prefix}.hb2st.device")
    return bulge.hb2st(W, n, b)


def _two_stage(A: HermitianMatrix, opts) -> bool:
    n, b = A.n, A.layout.nb
    method = get_option(opts, Option.MethodEig, MethodEig.Auto)
    if isinstance(method, str):
        method = MethodEig.from_string(method)
    return b >= 2 and n > 2 and (
        method == MethodEig.Bisection or (method == MethodEig.Auto and n > 4 * b))


class _stage(metrics.phase):
    """``metrics.phase`` that waits for the device before it stops the
    clock, so a stage's time is its work, not its enqueue; the stage is
    also a ``record_function`` range, so a profiler trace attributes
    its kernels."""

    def __init__(self, name: str, device: torch.device):
        super().__init__(name, always=True)
        self.device = device
        self.range = record_function(name)

    def __enter__(self):
        self.range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = super().__exit__(*exc)
        self.range.__exit__(*exc)
        return out


@instrumented("heev_staged")
@single_device("8c")
def heev_staged(A: HermitianMatrix, opts: Optional[Options] = None, vectors: bool = True):
    """Two-stage heev timed stage by stage (reference staging:
    src/heev.cc:123-210): he2hb + band gather | hb2st | stedc +
    unmtr_hb2st (or the Sturm bisection for values only) | unmtr_he2hb,
    each recorded as a ``heev.*`` phase.  This is ``heev``'s two-stage
    path; a problem that takes the dense-band path runs ``heev`` and has
    no stages.

    Returns (w, Z or None, {stage: seconds})."""
    if not _two_stage(A, opts):
        w, Z = heev(A, opts, vectors=vectors)
        return w, Z, {}
    n, b = A.n, A.layout.nb
    dev = A.device
    times = {}
    with _stage("heev.he2hb+gather", dev) as ph:
        band, V, T = he2hb(A, opts)
        # band-limited gather (he2hbGather): the (2b+1, n_pad) chase
        # storage straight from the diagonal and subdiagonal tiles
        W = band_storage_tiles(band.data, band.layout, n + 4 * b + 8)
    times["he2hb+gather"] = ph.seconds
    with _stage("heev.hb2st", dev) as ph:
        d, e, u, VS, TAUS = _hb2st(W, n, b)
    times["hb2st"] = ph.seconds
    if not vectors:
        with _stage("heev.eigvals", dev) as ph:
            w = bulge.tridiag_eigvals_bisect(d, e)
        times["eigvals"] = ph.seconds
        return w, None, times
    with _stage("heev.stedc+unmtr_hb2st", dev) as ph:
        w, ZT = steqr(d, e, vectors=True)
        Z2 = bulge.unmtr_hb2st(VS, TAUS, (u[:, None] * ZT).to(A.dtype), n, b)
    times["stedc+unmtr_hb2st"] = ph.seconds
    with _stage("heev.unmtr_he2hb", dev) as ph:
        Zm = Matrix(tiles_from_global(Z2, A.layout), A.layout, grid=A.grid)
        Z = unmtr_he2hb(Side.Left, Op.NoTrans, V, T, Zm, opts)
    times["unmtr_he2hb"] = ph.seconds
    return w, Z, times


@instrumented("heev")
@single_device("8c")
def heev(A: HermitianMatrix, opts: Optional[Options] = None, vectors: bool = True
         ) -> Tuple[torch.Tensor, Optional[Matrix]]:
    """Hermitian eigendecomposition (reference: src/heev.cc two-stage:
    he2hb -> hb2st -> tridiagonal eigensolve -> unmtr_hb2st +
    unmtr_he2hb, heev.cc:123-210).

    Returns (Lambda ascending, Z or None).  Stage 2 chases the band when
    it is narrow (n > 4 nb), through ``heev_staged``; smaller problems
    eigensolve the band directly.  MethodEig.Bisection forces the chase
    and Sturm bisection."""
    if _two_stage(A, opts):
        w, Z, _ = heev_staged(A, opts, vectors=vectors)
        return w, Z
    band, V, T = he2hb(A, opts)
    w, Z2 = _gathered_band_eig(band.full_global(), vectors)
    if not vectors:
        return w, None
    Zm = Matrix(tiles_from_global(Z2.to(A.dtype), A.layout), A.layout, grid=A.grid)
    return w, unmtr_he2hb(Side.Left, Op.NoTrans, V, T, Zm, opts)


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


@instrumented("sterf")
def sterf(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of a symmetric tridiagonal matrix (reference:
    src/sterf.cc) by bisection with vectorised Sturm counts."""
    return bulge.tridiag_eigvals_bisect(_real(d), _real(e))


@instrumented("steqr")
def steqr(d: torch.Tensor, e: torch.Tensor, vectors: bool = True, method: str = "dc"):
    """Tridiagonal eigensolver (reference: src/steqr.cc).  Values only:
    the Sturm bisection; with vectors: divide and conquer
    (ops/stedc.py), or with ``method="stein"`` the Sturm eigenvalues and
    inverse-iteration vectors (ops/stein.py, the dstebz + dstein
    pairing)."""
    if not vectors:
        return sterf(d, e), None
    if method == "stein":
        from ..ops.stein import stein as _stein

        dr, er = _real(d), _real(e)
        w = bulge.tridiag_eigvals_bisect(dr, er)
        return w, _stein(dr, er, w)
    return stedc(d, e, vectors=True)


@instrumented("stedc")
def stedc(d: torch.Tensor, e: torch.Tensor, vectors: bool = True):
    """Tridiagonal divide and conquer (reference: src/stedc.cc and its
    deflate/merge/secular/solve/sort/z_vector parts; ops/stedc.py).
    Values only: the Sturm bisection."""
    if not vectors:
        return sterf(d, e), None
    from ..ops.stedc import stedc as _stedc_dc

    return _stedc_dc(_real(d), _real(e))


def _lower_factor(L: TriangularMatrix) -> torch.Tensor:
    """The lower factor F of B = F F^H as a global tensor: the stored
    triangle of a Lower L, or U^H for the Upper U that ``chol.potrf``
    returns for an Upper B (B = U^H U).  The other triangle is zeroed."""
    G = L._with(op=Op.NoTrans).to_global()
    return torch.tril(G) if L.uplo == Uplo.Lower else torch.triu(G).mH


@instrumented("hegst")
@single_device("8c")
def hegst(itype: int, A: HermitianMatrix, L: TriangularMatrix,
          opts: Optional[Options] = None) -> HermitianMatrix:
    """Reduce the generalized problem to standard form (reference:
    src/hegst.cc, LAPACK zhegst).  With B = L L^H (Lower) itype 1 forms
    C = L^-1 A L^-H through two library triangular solves and itype 2/3
    C = L^H A L; with B = U^H U (Upper) itype 1 forms C = U^-H A U^-1
    and itype 2/3 C = U A U^H.  A is read from its own triangle, which
    may differ from B's.

    Deviation from the JAX package: its hegst applies the Lower
    formulas to an Upper factor; this one takes the factor's uplo."""
    slate_assert(itype in (1, 2, 3), f"hegst: itype must be 1, 2 or 3, got {itype}")
    Ag = A.full_global()
    Lg = _lower_factor(L)  # U^H for an Upper factor: the Upper formulas follow
    if itype == 1:
        Y = blas2d.trsm2d(Side.Left, Uplo.Lower, Op.NoTrans, L.diag, 1.0, Lg, Ag)
        Ch = blas2d.trsm2d(Side.Right, Uplo.Lower, Op.ConjTrans, L.diag, 1.0, Lg, Y)
    else:
        Ch = hdot(hdot(Lg.mH, Ag), Lg)
    return HermitianMatrix.from_global(Ch, A.layout.mb, A.layout.nb, grid=A.grid,
                                       uplo=A.uplo)


@instrumented("hegv")
@single_device("8c")
def hegv(itype: int, A: HermitianMatrix, B: HermitianMatrix, opts: Optional[Options] = None,
         vectors: bool = True):
    """Generalized Hermitian-definite eigenproblem (reference:
    src/hegv.cc, LAPACK zhegv: potrf(B) + hegst + heev + triangular
    back-transform).  itype 1: A x = lambda B x; 2: A B x = lambda x;
    3: B A x = lambda x.  The eigenvectors are x = L^-H y (itype 1, 2)
    and x = L y (itype 3) for a Lower B, x = U^-1 y and x = U^H y for an
    Upper one.  Returns (Lambda, X or None, info).

    Deviation from the JAX package: its back-transform is x = L^-H y
    for every itype and uplo."""
    L, info = chol.potrf(B, opts)
    C = hegst(itype, A, L, opts)
    w, Z = heev(C, opts, vectors=vectors)
    if not vectors:
        return w, None, info
    lower = L.uplo == Uplo.Lower
    if itype == 3:
        X = blas3.trmm(Side.Left, 1.0, L if lower else conj_transpose(L), Z, opts)
    else:
        X = blas3.trsm(Side.Left, 1.0, conj_transpose(L) if lower else L, Z, opts)
    return w, X, info


@single_device("8c")
def sygv(itype, A, B, opts=None, vectors=True):
    """Real-symmetric alias of hegv (reference: hegv covers sygv)."""
    return hegv(itype, A, B, opts, vectors)
