"""Hand-written Hopper kernels of the Cholesky solve path, their plain
PyTorch versions, and their launch counters.

The CUDA C++ sources are in ``slate_tpu_torch/csrc/panel_kernels.cu``.
They are compiled with ``nvcc`` at first use into
``build/slate_tpu_torch/`` beside the package (a shared library with a
plain C interface, loaded with ctypes) and rebuilt when the source's
hash changes.

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
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from ...internal.precision import hdot

LAUNCHES: Dict[str, int] = {
    "chol_base": 0,
    "syrk_diag": 0,
    "gemm_sub": 0,
    "trsm_lower": 0,
    "trsm_upper": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE = _PKG_DIR / "csrc" / "panel_kernels.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "slate_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")


def build(verbose: bool = False) -> tuple:
    """Compile the kernels unless a library for this source exists.
    Returns (path of the .so, compiler log or "" when it was cached).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libpanel_kernels_{tag}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "chol_base": [P, I, L, P],
        "gemm_sub": [P, L, P, L, P, L, P, L, P, I, I, I, I, I, P],
        "syrk_diag": [P, L, P, L, P, I, I, I, P],
        "trsm": [P, L, P, L, P, L, I, I, I, I, I, P],
    }
    for name, args in sigs.items():
        for suf in ("f32", "f64"):
            fn = getattr(lib, f"slate_{name}_{suf}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _entry(name: str, dtype: torch.dtype):
    suf = "f64" if dtype == torch.float64 else "f32"
    return getattr(_load(), f"slate_{name}_{suf}")


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
