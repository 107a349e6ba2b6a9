"""Hand-written Hopper kernels of the Cholesky and LU solve paths, their
plain PyTorch versions, and their launch counters.

The CUDA C++ sources are in ``slate_tpu_torch/csrc/``: ``panel_kernels.cu``
(chol_base, syrk_diag, gemm_sub, the trsm pair) and ``lu_kernels.cu``
(panel_lu, butterfly_level).  Each is compiled with its own ``nvcc``, all
at once, at first use into ``build/slate_tpu_torch/`` beside the package
(a shared library with a plain C interface each, loaded with ctypes) and
rebuilt when the source's hash changes.

Every wrapper dispatches on the device of its tensors: on the CPU it
runs the plain version; on a CUDA device it launches the kernel for
float32/float64 and raises for anything else (complex, other dtypes, an
inner stride other than 1).  There is no fall back from a CUDA tensor to
the plain version.  ``LAUNCHES[name]`` counts kernel launches, and only
those.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ...internal.precision import hdot

LAUNCHES: Dict[str, int] = {
    "chol_base": 0,
    "syrk_diag": 0,
    "gemm_sub": 0,
    "trsm_lower": 0,
    "trsm_upper": 0,
    "panel_lu": 0,
    "butterfly_level": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCES = (_PKG_DIR / "csrc" / "panel_kernels.cu", _PKG_DIR / "csrc" / "lu_kernels.cu")
BUILD_DIR = _PKG_DIR.parent / "build" / "slate_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_libs: Optional[List[ctypes.CDLL]] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")


def _library(src: Path) -> Path:
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{tag}.so"


def build(verbose: bool = False) -> Tuple[List[Path], str]:
    """Compile every source that has no library for its hash yet, one
    ``nvcc`` each, all started together.  Returns (the libraries, the
    compilers' output; "" when all were cached).  ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory, spills)."""
    sos = [_library(src) for src in SOURCES]
    jobs = []
    try:
        for src, so in zip(SOURCES, sos):
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(src)]
            jobs.append((so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = []
        for so, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {so.name} ({proc.returncode}):\n{err}")
            os.replace(tmp, so)
            logs.append(f"{so.name}:\n{out}{err}")
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return sos, "\n".join(logs)


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "chol_base": [_P, _I, _L, _P],
    "gemm_sub": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _P],
    "syrk_diag": [_P, _L, _P, _L, _P, _I, _I, _I, _P],
    "trsm": [_P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _I, _P],
    "panel_lu": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "butterfly_level": [_P, _L, _P, _P, _L, _I, _I, _I, _I, _P],
}


def _load() -> List[ctypes.CDLL]:
    global _libs
    if _libs is not None:
        return _libs
    sos, _ = build()
    libs = [ctypes.CDLL(str(so)) for so in sos]
    for name, args in _SIGNATURES.items():
        for suf in ("f32", "f64"):
            sym = f"slate_{name}_{suf}"
            fn = next(getattr(lib, sym) for lib in libs if hasattr(lib, sym))
            fn.argtypes = args
            fn.restype = ctypes.c_int
    _libs = libs
    return libs


def _entry(name: str, dtype: torch.dtype):
    sym = f"slate_{name}_{'f64' if dtype == torch.float64 else 'f32'}"
    return next(getattr(lib, sym) for lib in _load() if hasattr(lib, sym))


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def _on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    every one is a CUDA float32/float64 tensor on one device with inner
    stride 1 and rows that do not overlap (kernel).  Raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in ts]}")
    dt = ts[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA kernel takes float32/float64, not {dt}")
    for t in ts:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {[x.dtype for x in ts]}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected 2-D tensors")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: inner stride {t.stride(1)} != 1")
        if t.shape[0] > 1 and t.stride(0) < t.shape[1]:
            raise ValueError(f"{name}: row stride {t.stride(0)} < row length {t.shape[1]}")
    return False


def _ld(t: torch.Tensor) -> int:
    """Leading dimension: the row stride (any value >= 1 for one row)."""
    return t.stride(0) if t.shape[0] > 1 else max(t.shape[1], 1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ksplit(M: int, N: int, K: int, tile: int, lower: bool, device) -> int:
    """Split K across blocks while the output has too few tile x tile
    tiles to fill the card, keeping every K slice at least 256 deep."""
    tm, tn = -(-M // tile), -(-N // tile)
    tiles = tm * (tm + 1) // 2 if lower else tm * tn
    ks = 1
    while tiles * ks < 2 * _sms(device) and K // (2 * ks) >= 256:
        ks *= 2
    return ks


# ---------------------------------------------------------------------------
# chol_base
# ---------------------------------------------------------------------------

#: dynamic shared memory a block may use on Hopper
_MAX_SMEM = 227 * 1024
_CB_S, _CB_LDP = 32, 33  # csrc: CB_S, CB_LDP


def chol_base_plain(G: torch.Tensor) -> torch.Tensor:
    """Plain version: column-by-column Cholesky of the lower triangle;
    entries above the diagonal pass through untouched."""
    a = G.clone()
    b = a.shape[0]
    for j in range(b):
        d = a[j, j]
        pv = torch.sqrt(d.real).to(a.dtype) if a.is_complex() else torch.sqrt(d)
        a[j, j] = pv
        l = a[j + 1:, j] / pv
        a[j + 1:, j] = l
        a[j + 1:, j + 1:] -= torch.tril(torch.outer(l, l.conj()))
    return a


def chol_base(G: torch.Tensor) -> torch.Tensor:
    """Unblocked Cholesky of one (b, b) diagonal block; the strict upper
    triangle passes through untouched (callers ``tril``).

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:chol_base_pallas``.
    Bound on the H100: neither bytes (one b x b block) nor FLOPs (b^3/3)
    — it is a chain of b dependent column steps, so it is latency-bound.
    Design: one thread block walks strips of 32 columns: one warp
    factors the diagonal block in registers, one thread a row solves the
    panel below, and one rank-32 update goes to the trailing lower
    triangle in global memory (L2-resident).  Three block barriers a
    strip, where a column-by-column loop needs three a column."""
    if G.dim() != 2 or G.shape[0] != G.shape[1]:
        raise ValueError(f"chol_base: expected a square block, got {tuple(G.shape)}")
    if _on_cpu("chol_base", G):
        return chol_base_plain(G)
    b = G.shape[0]
    if (_CB_S + b) * _CB_LDP * G.element_size() > _MAX_SMEM:
        raise ValueError(f"chol_base: b = {b} exceeds the shared-memory panel")
    out = G.contiguous().clone()
    if b:
        _launch("chol_base", _entry("chol_base", out.dtype),
                out.data_ptr(), b, _ld(out), _stream(out))
    return out


# ---------------------------------------------------------------------------
# syrk_diag / gemm_sub
# ---------------------------------------------------------------------------


def syrk_diag_plain(C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain version: C - A A^H on the lower triangle, C above it."""
    t = C.shape[0]
    low = torch.ones(t, t, dtype=torch.bool, device=C.device).tril()
    return torch.where(low, C - hdot(A, A.mH), C)


def syrk_diag(C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Diagonal block of the Cholesky trailing update: C - A A^H on the
    lower triangle; the upper triangle passes through.

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:syrk_diag_pallas``.
    Bound on the H100: operations (t^2 h FLOPs on t x h bytes, t <= 256),
    but with t = 256 the output has only 10 lower 64 x 64 tiles.  Design:
    the gemm_sub kernel with tiles above the diagonal skipped, and K split
    across blocks (partials reduced by a second kernel) so that enough
    blocks fill the card."""
    if C.dim() != 2 or A.dim() != 2 or C.shape[0] != C.shape[1] or A.shape[0] != C.shape[0]:
        raise ValueError(f"syrk_diag: shapes {tuple(C.shape)}, {tuple(A.shape)}")
    if _on_cpu("syrk_diag", C, A):
        return syrk_diag_plain(C, A)
    t, K = A.shape
    out = C.contiguous().clone()
    if t == 0:
        return out
    ks = _ksplit(t, t, K, 64, True, C.device)
    work = torch.empty((ks, t, t), dtype=C.dtype, device=C.device) if ks > 1 else out
    _launch("syrk_diag", _entry("syrk_diag", C.dtype),
            out.data_ptr(), _ld(out), A.data_ptr(), _ld(A), work.data_ptr(),
            t, K, ks, _stream(C))
    return out


def gemm_sub_plain(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: C - A B^H."""
    return C - hdot(A, B.mH)


def gemm_sub(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Off-diagonal block of the Cholesky trailing update: C - A B^H
    (for real types C - A B^T).

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:gemm_sub_pallas``.
    Bound on the H100: operations — 2 M N K FLOPs, up to (4096, 4096,
    8192) at n = 16384, about half of the factorization's FLOPs.  Design:
    a shared-memory tiled SIMT kernel (128 x 128 tiles with 8 x 8
    outputs a thread once the output fills the card, else 64 x 64 with
    4 x 4; K steps of 16, the next one loaded while the current one is
    used) reading A and B along their rows, so no transposed copy is
    made; K is split across blocks when the output has too few tiles.
    Tensor-core (DMMA / wgmma) versions are later work."""
    if (C.dim() != 2 or A.dim() != 2 or B.dim() != 2 or A.shape[0] != C.shape[0]
            or B.shape[0] != C.shape[1] or A.shape[1] != B.shape[1]):
        raise ValueError(
            f"gemm_sub: shapes {tuple(C.shape)}, {tuple(A.shape)}, {tuple(B.shape)}"
        )
    if _on_cpu("gemm_sub", C, A, B):
        return gemm_sub_plain(C, A, B)
    M, N = C.shape
    K = A.shape[1]
    out = torch.empty((M, N), dtype=C.dtype, device=C.device)
    if M == 0 or N == 0:
        return out
    # 128 x 128 tiles (8 x 8 a thread) once they fill the card, else 64 x 64
    big = -(-M // 128) * -(-N // 128) >= _sms(C.device)
    ks = _ksplit(M, N, K, 128 if big else 64, False, C.device)
    work = torch.empty((ks, M, N), dtype=C.dtype, device=C.device) if ks > 1 else out
    _launch("gemm_sub", _entry("gemm_sub", C.dtype),
            C.data_ptr(), _ld(C), A.data_ptr(), _ld(A), B.data_ptr(), _ld(B),
            out.data_ptr(), _ld(out), work.data_ptr(), M, N, K, ks, int(big), _stream(C))
    return out


# ---------------------------------------------------------------------------
# trsm_lower / trsm_upper
# ---------------------------------------------------------------------------


def trsm_plain(T: torch.Tensor, B: torch.Tensor, lower: bool, unit: bool = False,
               transposed: bool = False) -> torch.Tensor:
    """Plain version: op(T) X = B with op(T) = T^H if ``transposed``;
    ``lower`` names the triangle of op(T), the only one read."""
    Top = T.mH if transposed else T
    X = torch.linalg.solve_triangular(Top, B, upper=not lower, unitriangular=unit)
    return X.contiguous()  # row-major, as the kernel writes it


_TR_NC = 4  # csrc: TR_NC, the columns of B a block owns


def _trsm(name: str, T, B, lower: bool, unit: bool, transposed: bool):
    if T.dim() != 2 or B.dim() != 2 or T.shape[0] != T.shape[1] or T.shape[0] != B.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(T.shape)}, {tuple(B.shape)}")
    if _on_cpu(name, T, B):
        return trsm_plain(T, B, lower, unit, transposed)
    n, nrhs = B.shape
    # the kernel reads X in row strips of _TR_NC values: pad X's rows to a
    # multiple of _TR_NC (the padding is read, never used)
    ldx = -(-nrhs // _TR_NC) * _TR_NC
    Xp = torch.empty((n, ldx), dtype=B.dtype, device=B.device)
    if n and nrhs:
        _launch(name, _entry("trsm", T.dtype),
                T.data_ptr(), _ld(T), B.data_ptr(), _ld(B), Xp.data_ptr(), ldx, n, nrhs,
                int(lower), int(unit), int(transposed), _stream(T))
    return Xp if ldx == nrhs else Xp[:, :nrhs].contiguous()


_TRSM_NOTE = """
    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:{fn}``.  Bound on
    the H100: n^2 nrhs FLOPs against n^2/2 elements of the triangle;
    at nrhs = 512 the FLOPs bound it.  In practice the work each SM
    issues (loads, shared reads and FMAs of its strip's whole
    substitution) limits the kernel; every block also re-reads the
    triangle through L2.  Design: the columns of B are independent, so
    each thread block owns 4 of them and runs the whole substitution
    over row blocks of 32, in order: 16 warps split the update from the
    solved rows into 32-row chunks, each chunk's loads issued at once so
    one L2 latency is paid per chunk; then one warp solves the diagonal
    block by substitution with shuffles.  Only the stated triangle of
    op(T) is read (packed LU storage is safe).  ``transposed`` reads T
    as T^T (real types only on the card), so the backward sweep of a
    Cholesky solve needs no transposed copy of L."""


def trsm_lower(L: torch.Tensor, B: torch.Tensor, unit: bool = False,
               transposed: bool = False) -> torch.Tensor:
    """Solve op(L) X = B, op(L) lower triangular (``unit``: ones on the
    diagonal, which is then not read)."""
    return _trsm("trsm_lower", L, B, True, unit, transposed)


def trsm_upper(U: torch.Tensor, B: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """Solve op(U) X = B, op(U) upper triangular.  With ``transposed``
    the argument is a lower factor L and the solve is L^H X = B."""
    return _trsm("trsm_upper", U, B, False, False, transposed)


trsm_lower.__doc__ += _TRSM_NOTE.format(fn="trsm_lower_pallas")
trsm_upper.__doc__ += _TRSM_NOTE.format(fn="trsm_upper_pallas")


# ---------------------------------------------------------------------------
# panel_lu
# ---------------------------------------------------------------------------


def panel_lu_plain(panel: torch.Tensor, pivot: bool = True,
                   act: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, op for op as the JAX package's ``lu_kernels.panel_lu``:
    unblocked LU of an (M, nb) panel, partial pivoting by default.

    Returns (lu, perm): lu holds unit-lower L below the diagonal and U
    on/above, lu's rows are panel[perm] (perm int32, forward).  The pivot
    of column j is the first row of largest magnitude among rows
    j <= r < act (NaN counts as largest); a zero pivot gives a zero L
    column, not NaN.  ``pivot=False`` eliminates without exchanges.
    No host synchronisation: the pivot index stays on the device."""
    a = panel.clone()
    M, nb = a.shape
    rows = torch.arange(M, device=a.device)
    cols = torch.arange(nb, device=a.device)
    perm = torch.arange(M, dtype=torch.int32, device=a.device)
    for j in range(min(M, nb)):
        if pivot:
            elig = rows >= j if act is None else (rows >= j) & (rows < act)
            mag = torch.where(elig, a[:, j].abs(), -math.inf)
            sw = torch.cat((rows[j:j + 1], torch.argmax(mag).view(1)))
            a[sw] = a[sw.flip(0)]  # rows j <-> piv
            perm[sw] = perm[sw.flip(0)]
        pv = a[j, j]
        safe = torch.where(pv == 0, torch.ones_like(pv), pv)
        l = torch.where((rows > j) & (pv != 0), a[:, j] / safe, torch.zeros_like(pv))
        a[:, j] = torch.where(rows > j, l, a[:, j])
        urow = torch.where(cols > j, a[j], torch.zeros_like(pv))
        a = a - torch.outer(l, urow)
    return a, perm


def panel_lu(panel: torch.Tensor, pivot: bool = True,
             act: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot unblocked LU of an (M, nb) panel -> (lu, perm int32),
    the contract of ``panel_lu_plain``.  Rows at or past ``act`` are
    never pivots (the recursion's canonical zero pad); ``act`` must cover
    the eliminated columns.

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:panel_lu_pallas``.
    Bound on the H100: neither bytes (one read and one write of the
    panel) nor FLOPs (M nb^2) — min(M, nb) dependent column steps, each
    needing the whole column, so grid-wide synchronisation and the
    L2 traffic of the trailing update (M nb^2 reads and writes) set its
    time.  Design: one cooperative launch over the card, a slab of rows
    a block, one grid barrier a column; rows stay in place and their
    positions in the swap order are tracked, so the column step needs no
    second barrier for the row exchange.  Explicitly rounded
    multiplies, subtracts and IEEE divisions (no FMA contraction) make
    lu and perm bit-identical to the plain version."""
    if panel.dim() != 2:
        raise ValueError(f"panel_lu: expected a 2-D panel, got {tuple(panel.shape)}")
    M, nb = panel.shape
    if act is not None and act >= M:
        act = None
    if act is not None and act < min(M, nb):
        raise ValueError(f"panel_lu: act = {act} leaves columns without an eligible pivot")
    if _on_cpu("panel_lu", panel):
        return panel_lu_plain(panel, pivot, act)
    dev = panel.device
    if M == 0 or nb == 0:
        return panel.clone(), torch.arange(M, dtype=torch.int32, device=dev)
    out = torch.empty((M, nb), dtype=panel.dtype, device=dev)
    work = torch.empty((M, nb), dtype=panel.dtype, device=dev)
    perm = torch.empty(M, dtype=torch.int32, device=dev)
    max_grid = 2 * _sms(dev)
    cmag = torch.empty(2 * max_grid, dtype=panel.dtype, device=dev)
    cidx = torch.empty(4 * max_grid, dtype=torch.int32, device=dev)
    _launch("panel_lu", _entry("panel_lu", panel.dtype),
            panel.data_ptr(), _ld(panel), work.data_ptr(), out.data_ptr(), perm.data_ptr(),
            cmag.data_ptr(), cidx.data_ptr(), M, nb, M if act is None else act,
            int(pivot), max_grid, _stream(panel))
    return out, perm


# ---------------------------------------------------------------------------
# butterfly_level
# ---------------------------------------------------------------------------


def butterfly_level_plain(X: torch.Tensor, D: torch.Tensor, h: int,
                          transpose: bool) -> torch.Tensor:
    """Plain version: one butterfly level over the blocks of 2h rows of
    X (n2, w) at once, D (n2,) the level's diagonals; for each block,
    rows x1 (first h) and x2 (last h) with d1, d2 the matching parts of
    D, and s = sqrt(1/2):
    transpose: [s (d1 x1 + d2 x2); s (d1 x1 - d2 x2)], else
    [s d1 (x1 + x2); s d2 (x1 - x2)] (the JAX kernel's operation order)."""
    n2, w = X.shape
    blocks = n2 // (2 * h)
    Xr = X.reshape(blocks, 2 * h, w)
    Dr = D[: blocks * 2 * h].reshape(blocks, 2 * h, 1)
    x1, x2, d1, d2 = Xr[:, :h], Xr[:, h:], Dr[:, :h], Dr[:, h:]
    s = math.sqrt(0.5)
    if transpose:
        top, bot = s * (d1 * x1 + d2 * x2), s * (d1 * x1 - d2 * x2)
    else:
        top, bot = s * (d1 * (x1 + x2)), s * (d2 * (x1 - x2))
    return torch.cat([top, bot], dim=1).reshape(n2, w)


def butterfly_level(X: torch.Tensor, D: torch.Tensor, h: int, transpose: bool) -> torch.Tensor:
    """One level of the recursive butterfly transform, the contract of
    ``butterfly_level_plain``.

    Replaces ``slate_tpu/ops/pallas/kernels.py:butterfly_level_pallas``,
    which the JAX package vmaps over the blocks of a level; here one
    launch covers every block of the level.  Bound on the H100: bytes
    (each element of X read once and written once, a few FLOPs each).
    Design: a thread per (row pair, column), neighbouring threads on
    neighbouring columns, the JAX kernel's operation order with
    explicitly rounded operations (bit-identical to the plain version)."""
    if X.dim() != 2 or D.dim() != 1 or D.shape[0] != X.shape[0] or h < 1 \
            or X.shape[0] % (2 * h) != 0:
        raise ValueError(f"butterfly_level: X {tuple(X.shape)}, D {tuple(D.shape)}, h = {h}")
    D2 = D.reshape(1, -1)
    if _on_cpu("butterfly_level", X, D2):
        return butterfly_level_plain(X, D, h, transpose)
    n2, w = X.shape
    Y = torch.empty((n2, w), dtype=X.dtype, device=X.device)
    if w:
        _launch("butterfly_level", _entry("butterfly_level", X.dtype),
                X.data_ptr(), _ld(X), D2.data_ptr(), Y.data_ptr(), _ld(Y), n2, h, w,
                int(transpose), _stream(X))
    return Y
