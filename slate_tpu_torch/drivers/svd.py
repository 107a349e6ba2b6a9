"""SVD family (reference: src/svd.cc, ge2tb.cc, tb2bd.cc, bdsqr.cc,
unmbr_ge2tb.cc), the single-device path of the JAX package's
``drivers/svd.py``.

svd:  tall (m >= 2n) / wide (n >= 2m) pre-reduction by geqrf / the
      conjugate transpose -> ge2tb (dense -> upper band, the O(n^3)
      work) -> band gather -> stage 2 -> unmbr_ge2tb back-transforms.

Stage 2 takes the Jordan-Wielandt route when the band is narrow
(n <= m and n > 4 (2 nb + 1)): the upper band B is embedded in the
perfect-shuffle Hermitian band of size 2n and bandwidth 2 nb + 1, which
goes through the same hb2st chase as heev (the native host chaser for
real float64, the device wavefront of ops/bulge.py otherwise; counted
in ``svd.hb2st.host`` / ``svd.hb2st.device``), then the Sturm bisection
for values, or stedc + unmtr_hb2st for vectors.  Other shapes solve the
gathered band with ``svd_accurate`` (the library SVD, Jacobi-polished
on a CUDA device).  The chase, the bisection and unmtr_hb2st are timed
as ``svd.*`` stages; every stage is a ``record_function`` range
(``svd.geqrf``, ``svd.ge2tb`` and its ``ge2tb.{qr,lq}_{panel,update}``,
``svd.hb2st``, ``svd.stedc``, ...) for a profiler trace.

PyTorch runs eagerly, so ge2tb works on the active trailing views of
each step instead of the JAX package's rolled, padded array (three full
copies a step there); its band, reflectors and T factors agree with the
JAX package's within rounding, not bitwise.

Not ported yet: the mesh branches (``spmd_ge2tb``,
``spmd_unmbr_ge2tb_left`` / ``_right``, ``spmd_upper_band_diagonals``)
(ROADMAP.md Queue 1 item 8c): a distributed operand raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..aux.metrics import instrumented
from ..enums import Op, Side, Uplo
from ..internal.precision import check_f32_precision, hdot
from ..matrix.base import conj_transpose, single_device
from ..matrix.matrix import Matrix, TriangularBandMatrix
from ..ops import bulge
from ..ops.householder import _geqrf_panel, larft, materialize_v
from ..ops.jacobi import svd_accurate
from ..options import Options
from ..parallel.band_gather import upper_band_diagonals_tiles
from ..parallel.layout import TileLayout, tiles_from_global
from ..types import TriangularFactors
from . import qr as _qr
from .eig import _hb2st, _stage, steqr


def _panel_qr(P: torch.Tensor):
    """(factored panel, taus, T) of an (h, nb) panel, h >= nb: the
    unblocked Householder QR and its compact-WY T (the plain larft, as
    the JAX package's ``householder.larft``)."""
    vr, taus = _geqrf_panel(P)
    return vr, taus, larft(materialize_v(vr), taus)


@instrumented("ge2tb")
@single_device("8c")
def ge2tb(A: Matrix, opts: Optional[Options] = None
          ) -> Tuple[TriangularBandMatrix, Matrix, TriangularFactors, Matrix, TriangularFactors]:
    """Reduce general A to upper triangular band form with bandwidth nb
    (reference: src/ge2tb.cc): per tile step k, a QR panel from the left
    on the columns k nb .. and an LQ panel from the right on the rows
    k nb .. of the block right of it.

    Returns (band, UV, UT, VV, VT): the band (kd = nb, Uplo.Upper), the
    left reflectors (panel k in tile column k from row k nb; m x n) and
    their (kt, nb, nb) T stack, the right reflectors (panel k in tile
    column k from row (k+1) nb; n x n) and theirs, kt = min(mt, nt).
    Padded or ragged panel columns are tau = 0 reflectors, whose T rows
    and columns are zero."""
    lay = A.layout
    nb, m, n = lay.nb, A.m, A.n
    kt = min(lay.mt, lay.nt)
    G = A.to_global().resolve_conj().clone(memory_format=torch.contiguous_format)
    check_f32_precision(G)
    UV = torch.zeros_like(G)
    VV = G.new_zeros((n, n))
    UT = G.new_zeros((kt, nb, nb))
    VT = G.new_zeros((kt, nb, nb))
    for k in range(kt):
        lo = k * nb
        h, w = m - lo, min(nb, n - lo)
        # left QR of the column panel, then Q^H on the columns right of it
        with record_function("ge2tb.qr_panel"):
            pan = G.new_zeros((max(h, nb), nb))
            pan[:h, :w] = G[lo:, lo:lo + w]
            vr, _, UT[k] = _panel_qr(pan)
            V = materialize_v(vr)[:h]
        G[lo:, lo:lo + w] = torch.triu(vr)[:h, :w]
        UV[lo:, lo:lo + w] = V[:, :w]
        if n > lo + nb:
            with record_function("ge2tb.qr_update"):
                C = G[lo:, lo + nb:]
                C -= hdot(V, hdot(UT[k].mH, hdot(V.mH, C)))
        # right LQ: QR of the conjugate transpose of the row block
        w2, rb = n - lo - nb, min(nb, h)
        with record_function("ge2tb.lq_panel"):
            P2 = G.new_zeros((max(w2, nb), nb))
            if w2 <= 0:  # no columns right of the panel: every tau is 0
                VT[k] = larft(materialize_v(P2), P2.new_zeros(nb))
                continue
            P2[:w2, :rb] = G[lo:lo + rb, lo + nb:].mH
            vrL, _, VT[k] = _panel_qr(P2)
            VL = materialize_v(vrL)[:w2]
        G[lo:lo + rb, lo + nb:] = torch.triu(vrL)[:w2, :rb].mH
        VV[lo + nb:, lo:lo + nb] = VL
        if h > nb:
            with record_function("ge2tb.lq_update"):
                Cb = G[lo + nb:, lo + nb:]
                Cb -= hdot(hdot(hdot(Cb, VL), VT[k]), VL.mH)
    band = TriangularBandMatrix(tiles_from_global(G, lay), lay, grid=A.grid, kd=nb,
                                uplo=Uplo.Upper)
    v_lay = TileLayout(n, n, nb, nb, lay.p, lay.q)
    return (band, Matrix(tiles_from_global(UV, lay), lay, grid=A.grid), TriangularFactors(UT),
            Matrix(tiles_from_global(VV, v_lay), v_lay, grid=A.grid), TriangularFactors(VT))


def _jw_band_storage(Dg: torch.Tensor, b: int, n: int):
    """Diagonal-major band storage of the perfect-shuffle Jordan-Wielandt
    embedding C = P [[0, B], [B^H, 0]] P^T of an upper band B given by
    its packed superdiagonals Dg[t, i] = B[i, i+t], t in [0, b]: C is
    Hermitian banded with bandwidth 2b+1, C[2i + 2t + 1, 2i] =
    conj(B[i, i+t]) on the odd subdiagonals of the even columns
    (Golub-Kahan; eigenvalues come in +-sigma pairs and eigenvectors
    shuffle to (u; v)/sqrt(2)).  Returns (W, 2b+1, 2n)."""
    bw, n2 = 2 * b + 1, 2 * n
    W = Dg.new_zeros((2 * bw + 1, n2 + 4 * bw + 8))
    for t in range(b + 1):
        W[2 * t + 1, 0:2 * (n - t):2] = Dg[t, :n - t].conj()
    return W, bw, n2


def _band_svd_jw(Dg: torch.Tensor, n: int, b: int, vectors: bool):
    """SVD of an upper band matrix (packed superdiagonals Dg, (b+1, n))
    through the shuffled Jordan-Wielandt embedding and the hb2st chase
    (the replacement of the reference's tb2bd + bdsqr, src/tb2bd.cc,
    src/bdsqr.cc).  Returns (s descending, U, Vh), U and Vh None unless
    ``vectors``."""
    dtype, dev = Dg.dtype, Dg.device
    W, bw, n2 = _jw_band_storage(Dg, b, n)
    with _stage("svd.hb2st", dev):
        d, e, u, VS, TAUS = _hb2st(W, n2, bw, prefix="svd")
    if not vectors:
        with _stage("svd.eigvals", dev):
            w = bulge.tridiag_eigvals_bisect(d, e)
        return torch.flip(w, (0,))[:n], None, None
    with record_function("svd.stedc"):
        w, ZT = steqr(d, e, vectors=True)
    with _stage("svd.unmtr_hb2st", dev):
        Zjw = bulge.unmtr_hb2st(VS, TAUS, (u[:, None] * ZT).to(dtype), n2, bw)
    # stable, as jnp.argsort: equal singular values keep their order
    top = torch.argsort(-w, stable=True)[:n]
    Zsel = Zjw[:, top] * math.sqrt(2.0)
    return w[top], Zsel[0::2], Zsel[1::2].mH


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return x.real.dtype if x.is_complex() else x.dtype


@instrumented("tb2bd")
def tb2bd(band: TriangularBandMatrix):
    """Band -> bidiagonal (reference: src/tb2bd.cc bulge chasing).

    The port's band stage goes band -> shuffled Jordan-Wielandt ->
    tridiagonal directly (``_band_svd_jw``), so this API-parity wrapper
    returns the singular values as the bidiagonal's diagonal (e = 0) and
    the band stage's vectors: (d, e, U, Vh)."""
    G = band.to_global()
    check_f32_precision(G)
    m, n = G.shape
    k = min(m, n)
    b = getattr(band, "kd", n)
    if m >= n and n > 4 * (2 * b + 1) and b >= 1:
        Dg = torch.stack([F.pad(torch.diagonal(G[:n, :n], t), (0, t)) for t in range(b + 1)])
        ar = torch.arange(n, device=G.device)
        Dg = torch.where(ar[None, :] + torch.arange(b + 1, device=G.device)[:, None] < n, Dg, 0)
        s, U, Vh = _band_svd_jw(Dg, n, b, vectors=True)
    else:
        U, s, Vh = svd_accurate(G)
    return s, G.new_zeros((max(k - 1, 0),), dtype=_real_dtype(G)), U, Vh


@instrumented("bdsqr")
def bdsqr(d, e, vectors: bool = False):
    """Singular values (and vectors) of a real upper bidiagonal matrix
    (reference: src/bdsqr.cc QR iteration): the Golub-Kahan tridiagonal
    tridiag(0; [d1, e1, d2, e2, ...]) has eigenvalues +-sigma, solved by
    the Sturm bisection (values) or stedc (vectors).  The [d1, e1, ...]
    off-diagonal is the (v1, u1, v2, u2, ...) shuffle, so eigenvectors
    split as v = z[0::2], u = z[1::2].  Returns (s descending, U, Vh)."""
    d = torch.as_tensor(d)
    e = torch.as_tensor(e, device=d.device)
    n = d.shape[0]
    if n == 0:
        return d, None, None
    real = lambda x: x.real if x.is_complex() else x  # noqa: E731
    off = d.new_zeros((2 * n - 1,), dtype=_real_dtype(d))
    off[0::2] = real(d)
    if n > 1:
        off[1::2] = real(e)
    dz = off.new_zeros((2 * n,))
    if not vectors:
        w = bulge.tridiag_eigvals_bisect(dz, off)
        return torch.flip(w, (0,))[:n], None, None
    w, Z = steqr(dz, off, vectors=True)
    top = torch.argsort(-w, stable=True)[:n]
    Zsel = Z[:, top] * math.sqrt(2.0)
    return w[top], Zsel[1::2], Zsel[0::2].T


@instrumented("svd")
@single_device("8c")
def svd(A: Matrix, opts: Optional[Options] = None, vectors: bool = False
        ) -> Tuple[torch.Tensor, Optional[Matrix], Optional[Matrix]]:
    """Singular value decomposition (reference: src/svd.cc two-stage:
    ge2tb -> gather -> tb2bd -> bdsqr; tall/wide pre-reduction by QR
    when m >> n or n >> m, svd.cc:99-141).

    Returns (Sigma descending, U, VH) on A's device; U (m x k) and VH
    (k x n), k = min(m, n), are None unless ``vectors``."""
    m, n = A.m, A.n
    lay = A.layout
    check_f32_precision(A.data)
    if m >= 2 * n:
        # tall: A = Q R, svd(R), U = Q [U_R; 0]
        with record_function("svd.geqrf"):
            fac, Tq = _qr.geqrf(A, opts)
        R = Matrix.from_global(torch.triu(fac.to_global()[:n, :n]), lay.nb, lay.nb, grid=A.grid)
        s, Ur, Vh = svd(R, opts, vectors=vectors)
        if not vectors:
            return s, None, None
        Urg = Ur.to_global()
        Upad = Matrix.from_global(torch.cat([Urg, Urg.new_zeros((m - n, n))]), lay.mb, lay.nb,
                                  grid=A.grid)
        with record_function("svd.unmqr"):
            U = _qr.unmqr(Side.Left, Op.NoTrans, fac, Tq, Upad, opts)
        return s, U, Vh
    if n >= 2 * m:
        # wide: A^H is tall; A^H = Ut S Vht  =>  A = Vht^H S Ut^H
        Ahr = conj_transpose(A).resolved()
        s, Ut, Vht = svd(Matrix(Ahr.data, Ahr.layout, grid=A.grid), opts, vectors=vectors)
        if not vectors:
            return s, None, None
        U = Matrix.from_global(Vht.to_global().mH, lay.mb, lay.mb, grid=A.grid)
        return s, U, Matrix.from_global(Ut.to_global().mH, lay.mb, lay.nb, grid=A.grid)

    with record_function("svd.ge2tb"):
        band, UVm, UT, VVm, VT = ge2tb(A, opts)
    b, k = lay.nb, min(m, n)
    if n <= m and n > 4 * (2 * b + 1):
        # the band-limited gather (ge2tbGather): only the O(n kd) packed
        # superdiagonals move between the stages
        Dg = upper_band_diagonals_tiles(band.data, band.layout, n)
        if not vectors:
            return _band_svd_jw(Dg, n, b, vectors=False)[0], None, None
        s, Ub, Vhb = _band_svd_jw(Dg, n, b, vectors=True)
        if m > n:
            Ub = torch.cat([Ub, Ub.new_zeros((m - n, n))])
    else:
        Gband = band.to_global()
        if not vectors:
            return svd_accurate(Gband, compute_uv=False)[:k], None, None
        Ub, s, Vhb = svd_accurate(Gband)
    with record_function("svd.unmbr_ge2tb"):
        U = unmbr_ge2tb_left(UVm, UT, Ub, A, opts)
        Vh = unmbr_ge2tb_right(VVm, VT, Vhb, A, opts)
    return s[:k], U, Vh


def _operand(C2, V: torch.Tensor) -> torch.Tensor:
    """C2 (a tensor or array) as a fresh tensor on V's device in the
    promoted dtype of both."""
    C = torch.as_tensor(C2, device=V.device)
    return C.to(torch.promote_types(C.dtype, V.dtype)).resolve_conj().clone()


@instrumented("unmbr_ge2tb_left")
@single_device("8c")
def unmbr_ge2tb_left(UVm: Matrix, UT: TriangularFactors, C2, A: Matrix,
                     opts: Optional[Options] = None) -> Matrix:
    """Apply the left (QR-side) ge2tb reflectors: C <- Q_U C (reference:
    src/unmbr_ge2tb.cc), panels last to first.  V_k is zero above row
    k nb, so each step updates rows k nb .. only; absent reflectors have
    zero T rows and columns.  Returns C as a Matrix in A's tiles."""
    lay = A.layout
    nb = lay.nb
    UVg = UVm.to_global()
    out = _operand(C2, UVg)
    for k in range(UT.T.shape[0] - 1, -1, -1):
        lo = k * nb
        Vk = UVg[lo:, lo:lo + nb]
        w = Vk.shape[1]
        Tk = UT.T[k][:w, :w]
        Cs = out[lo:]
        Cs -= hdot(Vk, hdot(Tk, hdot(Vk.mH, Cs)))
    return Matrix.from_global(out.to(A.dtype), lay.mb, lay.nb, grid=A.grid)


@instrumented("unmbr_ge2tb_right")
@single_device("8c")
def unmbr_ge2tb_right(VVm: Matrix, VT: TriangularFactors, C2, A: Matrix,
                      opts: Optional[Options] = None) -> Matrix:
    """Apply the right (LQ-side) reflectors: C <- C Q_V^H, panels last
    to first.  V_k is zero above row (k+1) nb, so each step updates
    columns (k+1) nb .. only."""
    lay = A.layout
    nb = lay.nb
    VVg = VVm.to_global()
    out = _operand(C2, VVg)
    for k in range(VT.T.shape[0] - 1, -1, -1):
        lo = (k + 1) * nb
        Vk = VVg[lo:, k * nb:lo]
        w = Vk.shape[1]
        Tk = VT.T[k][:w, :w]
        Cs = out[:, lo:]
        # C <- C (I - V_k T_k^H V_k^H)
        Cs -= hdot(hdot(hdot(Cs, Vk), Tk.mH), Vk.mH)
    return Matrix.from_global(out.to(A.dtype), lay.mb, lay.nb, grid=A.grid)
