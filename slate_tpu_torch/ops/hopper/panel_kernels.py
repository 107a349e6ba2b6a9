"""Hand-written Hopper kernels of slate_tpu_torch, their plain PyTorch
versions, and their launch counters: every Pallas kernel of the JAX
package has its counterpart here.

The CUDA C++ sources are in ``slate_tpu_torch/csrc/``: ``panel_kernels.cu``
(chol_base, syrk_diag, gemm_sub, the trsm pair, larft), ``lu_kernels.cu``
(panel_lu, butterfly_level) and ``tile_kernels.cu`` (tile_norms,
tile_geadd, tile_transpose).  Each is
compiled with its own ``nvcc``, all at once, at first use into
``build/slate_tpu_torch/`` beside the package (a shared library with a
plain C interface each, loaded with ctypes) and rebuilt when the
source's hash changes.  An artifact store (``serve/artifacts.py``)
keeps a copy of the built set under its ``kernels/<digest>/``, with a
record of each file's sha256: :func:`open_from` checks those bytes and
then opens that copy instead, so a restored process runs no ``nvcc``.
A process never holds two copies of the library.

Every wrapper dispatches on the device of its tensors: on the CPU it
runs the plain version; on a CUDA device it launches the kernel for
float32/float64 and raises for anything else (complex, other dtypes, an
inner stride other than 1).  There is no fall back from a CUDA tensor to
the plain version.  ``LAUNCHES[name]`` counts kernel launches, and only
those.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ...internal.build import BUILD_DIR, build_lock
from ...internal.precision import hdot

LAUNCHES: Dict[str, int] = {
    "chol_base": 0,
    "syrk_diag": 0,
    "gemm_sub": 0,
    "trsm_lower": 0,
    "trsm_upper": 0,
    "panel_lu": 0,
    "butterfly_level": 0,
    "larft": 0,
    "tile_norms": 0,
    "tile_geadd": 0,
    "tile_transpose": 0,
}


#: serve lanes sharing a device launch from several threads (ctypes drops
#: the GIL in the call): the counts are added under a lock
_launches_lock = threading.Lock()


#: panel_lu's launch sets the kernel's dynamic shared memory limit to its
#: own plan's size, then checks residency and launches: a process-wide
#: attribute, so two lanes launching plans of different sizes at once
#: could launch one under the other's smaller limit (cudaErrorInvalidValue,
#: seen once on the card at phase 20 (c)).  The host-side sequence is
#: serialised; the launches themselves stay asynchronous.
_panel_lu_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, k: int = 1) -> None:
    with _launches_lock:
        LAUNCHES[name] += k


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCES = tuple(_PKG_DIR / "csrc" / f"{stem}.cu"
                for stem in ("panel_kernels", "lu_kernels", "tile_kernels"))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_libs: Optional[List[ctypes.CDLL]] = None
#: the library digest of ``_libs`` and the directory they were opened
#: from (``BUILD_DIR``, or an artifact store's copy); None until loaded
_libs_digest: Optional[str] = None
LOADED_FROM: Optional[Path] = None
#: set when a store's copy failed in ``_open`` after the dynamic loader
#: may have mapped some of it: no second copy is loaded after that
_half_open: Optional[Path] = None
#: ``nvcc`` processes this process has started
NVCC_RUNS = 0


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


def library_names() -> List[str]:
    """File names of the library set built from the current sources."""
    return [_library(src).name for src in SOURCES]


def library_digest() -> str:
    """Digest of the library set: a hash over each library's tag (its
    source's bytes and the flags).  Keys an artifact store's copy of the
    libraries and the runtime half of an artifact's fingerprint."""
    return hashlib.sha256(" ".join(library_names()).encode()).hexdigest()[:16]


def build(verbose: bool = False) -> Tuple[List[Path], str]:
    """Compile every source that has no library for its hash yet, one
    ``nvcc`` each, all started together.  Returns (the libraries, the
    compilers' output; "" when all were cached).  ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory, spills)."""
    with build_lock:
        return _build_locked(verbose)


def _build_locked(verbose: bool) -> Tuple[List[Path], str]:
    global NVCC_RUNS
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
            NVCC_RUNS += 1
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


_P, _L, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "chol_base": [_P, _I, _L, _P],
    "gemm_sub": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P],
    "syrk_diag": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _P],
    "gemm_layout": [_I, _P, _P, _P],
    "trsm": [_P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    "trsm_layout": [_P, _P],
    "panel_lu": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "butterfly_level": [_P, _L, _P, _P, _L, _I, _I, _I, _I, _P],
    "larft": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "larft_layout": [_I, _P, _P, _P, _P],
    "tile_norms": [_P, _L, _L, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P],
    "tile_geadd": [_D, _P, _L, _L, _D, _P, _L, _L, _P, _I, _I, _I, _P],
    "tile_transpose": [_P, _L, _L, _P, _I, _I, _I, _P],
}


def _symbol(libs: List[ctypes.CDLL], sym: str):
    return next(getattr(lib, sym) for lib in libs if hasattr(lib, sym))


def _load() -> List[ctypes.CDLL]:
    if _libs is not None:
        return _libs
    with build_lock:
        return _libs if _libs is not None else _load_locked()


def _load_locked() -> List[ctypes.CDLL]:
    global _libs, _libs_digest, LOADED_FROM
    if _half_open is not None:
        raise RuntimeError(f"the kernel library copy in {_half_open} failed to open after "
                           "loading; a second copy is not loaded beside it")
    sos, _ = build()
    _libs = _open(sos)
    _libs_digest, LOADED_FROM = library_digest(), BUILD_DIR
    return _libs


#: the record of a library copy: each file's sha256, and its own
LIBRARY_RECORD = "library.json"


class LibraryCorrupt(ValueError):
    """A library copy whose record or bytes fail their sha256."""


def _record_sha(digest: str, files: Dict[str, str]) -> str:
    return hashlib.sha256(json.dumps({"digest": digest, "files": files},
                                     sort_keys=True).encode()).hexdigest()


def library_record(digest: str, files: Dict[str, str]) -> bytes:
    """The record of a library copy of ``digest`` whose files (by name)
    have the sha256 ``files``; written after the files."""
    return json.dumps({"digest": digest, "files": files,
                       "sha256": _record_sha(digest, files)}, sort_keys=True).encode()


def check_copy(directory, digest: str) -> List[Path]:
    """The files of the library copy of ``digest`` in ``directory``, each
    checked against the record's sha256 (no ``CDLL``).  Raises
    ``FileNotFoundError`` when the record or a file is missing and
    :class:`LibraryCorrupt` when a checksum or the record fails."""
    directory = Path(directory)
    blob = (directory / LIBRARY_RECORD).read_bytes()
    try:
        rec = json.loads(blob.decode())
        files = rec["files"]
        ok = rec["digest"] == digest and rec["sha256"] == _record_sha(digest, files)
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise LibraryCorrupt(f"unreadable library record in {directory}: {e}") from None
    if not ok or sorted(files) != sorted(library_names()):
        raise LibraryCorrupt(f"library record in {directory} fails its checksum")
    sos = [directory / name for name in library_names()]
    for so in sos:
        if hashlib.sha256(so.read_bytes()).hexdigest() != files[so.name]:
            raise LibraryCorrupt(f"{so} fails its sha256")
    return sos


def open_from(directory, digest: str) -> str:
    """Open the library set from ``directory``, a copy keyed ``digest``
    (an artifact store's), after :func:`check_copy`, through the same
    signatures and tile checks as a build.  Returns ``"opened"``;
    ``"loaded"`` when this process already holds the libraries of that
    digest (no second ``CDLL``); ``"stale"`` when ``digest`` is not the
    current sources' or the process holds libraries of another digest.
    Raises when the copy is missing, fails its checksums or does not
    open; once it failed past the checks, :func:`_load` raises too."""
    global _libs, _libs_digest, LOADED_FROM, _half_open
    if digest != library_digest():
        return "stale"
    with build_lock:
        if _libs is not None:
            return "loaded" if _libs_digest == digest else "stale"
        if _half_open is not None:
            raise RuntimeError(f"the kernel library copy in {_half_open} failed to open")
        sos = check_copy(directory, digest)
        try:
            _libs = _open(sos)
        except Exception:
            _half_open = Path(directory)
            raise
        _libs_digest, LOADED_FROM = digest, Path(directory)
        return "opened"


def library_files() -> List[Path]:
    """The files of the loaded library set (loading it first)."""
    _load()
    return [LOADED_FROM / name for name in library_names()]


def _open(sos: List[Path]) -> List[ctypes.CDLL]:
    """Load the built libraries, set every entry point's signature and
    check the tiles each reports against the plans'."""
    libs = [ctypes.CDLL(str(so)) for so in sos]
    for name, args in _SIGNATURES.items():
        for suf in ("f32", "f64"):
            fn = _symbol(libs, f"slate_{name}_{suf}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    for suf in ("f32", "f64"):  # the trsm plan's tile is the one built
        kb, bn = ctypes.c_int(), ctypes.c_int()
        _symbol(libs, f"slate_trsm_layout_{suf}")(ctypes.byref(kb), ctypes.byref(bn))
        if (kb.value, bn.value) != (TRSM_KB, TRSM_BN):
            raise RuntimeError(f"trsm kernel tile {kb.value} x {bn.value} ({suf}), the plan "
                               f"assumes {TRSM_KB} x {TRSM_BN}")
    for dt, suf in ((torch.float32, "f32"), (torch.float64, "f64")):
        _GEMM_TILES[dt] = _gemm_tiles(_symbol(libs, f"slate_gemm_layout_{suf}"), suf)
        _LARFT_TILES[dt] = _larft_tiles(_symbol(libs, f"slate_larft_layout_{suf}"), suf)
    return libs


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    return _symbol(_load(), f"slate_{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    _count(name)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


#: the dtypes the kernels take on a CUDA device
KERNEL_DTYPES = (torch.float32, torch.float64)


def kernels_take(dtype: torch.dtype, device) -> bool:
    """Whether the kernel family can run operands of ``dtype`` on
    ``device``: always on the CPU (the plain versions run), only for
    ``KERNEL_DTYPES`` on a CUDA device.  The schedule resolvers route
    the other dtypes to the library or the plain schedule, so no wrapper
    is handed a tensor it raises for."""
    return torch.device(device).type == "cpu" or dtype in KERNEL_DTYPES


def _on_cpu(name: str, *ts: torch.Tensor, dim: int = 2) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    every one is a ``dim``-D (2: a matrix, 3: a stack of tiles) CUDA
    float32/float64 tensor on one device with inner stride 1 and rows
    (and tiles) that do not overlap (kernel).  Raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in ts]}")
    dt = ts[0].dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32/float64, not {dt}")
    for t in ts:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {[x.dtype for x in ts]}")
        if t.dim() != dim:
            raise ValueError(f"{name}: expected {dim}-D tensors")
        rows, cols = t.shape[-2:]
        if cols > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: inner stride {t.stride(-1)} != 1")
        if rows > 1 and t.stride(-2) < cols:
            raise ValueError(f"{name}: row stride {t.stride(-2)} < row length {cols}")
        if dim == 3 and t.shape[0] > 1 and t.stride(0) < _ld(t) * (rows - 1) + cols:
            raise ValueError(f"{name}: tile stride {t.stride(0)} overlaps the tiles")
    return False


def _ld(t: torch.Tensor) -> int:
    """Leading dimension of a matrix, or of each tile of a stack: the
    row stride (any value >= 1 for one row)."""
    return t.stride(-2) if t.shape[-2] > 1 else max(t.shape[-1], 1)


def _tile_stride(t: torch.Tensor) -> int:
    """Stride between the tiles of an (N, mb, nb) stack (any value for
    one tile)."""
    return t.stride(0) if t.shape[0] > 1 else _ld(t) * t.shape[1]


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object: a fifth of a short kernel's host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the gemm_sub / syrk_diag tile and K split
# ---------------------------------------------------------------------------


class GemmTile(NamedTuple):
    """A tile variant of the gemm_sub / syrk_diag kernel as the built
    kernel reports it (``slate_gemm_layout_*``): the output tile's edge,
    the depth of a K slice of its ring, and how many of its blocks fit on
    one SM."""
    bm: int
    bk: int
    per_sm: int


class GemmPlan(NamedTuple):
    """One gemm_sub / syrk_diag call: the tile variant (an index into the
    kernel's tiles) and the K split: ``ksplit`` blocks along K, each
    ``kchunk`` deep (a whole number of K slices), the last one the rest."""
    variant: int
    ksplit: int
    kchunk: int


#: K is split no finer than this: each block's K range keeps its ring full
MIN_SPLIT_DEPTH = 256

#: the tile variants of the built kernel, by dtype (filled by ``_load``)
_GEMM_TILES: Dict[torch.dtype, Tuple[GemmTile, ...]] = {}


def gemm_sub_plan(M: int, N: int, K: int, lower: bool, tiles: Tuple[GemmTile, ...],
                  sms: int) -> GemmPlan:
    """The tile variant and K split of one (M, N, K) product (``lower``:
    syrk_diag's lower triangle, M = N) on a card of ``sms`` SMs, from the
    kernel's ``tiles`` (largest first): the first variant whose blocks,
    with K split in powers of two down to ``MIN_SPLIT_DEPTH``, fill nine
    tenths of the card's block slots (``per_sm`` a SM), else the last
    (smallest) one.  Splitting stops once the card is filled, so a large
    output runs unsplit on the largest tile."""
    for variant, tile in enumerate(tiles):
        tm, tn = -(-M // tile.bm), -(-N // tile.bm)
        count = tm * (tm + 1) // 2 if lower else tm * tn
        slots = tile.per_sm * sms
        ks = 1
        while 10 * count * ks < 9 * slots and K // (2 * ks) >= MIN_SPLIT_DEPTH:
            ks *= 2
        if 10 * count * ks >= 9 * slots or variant == len(tiles) - 1:
            break
    nslices = max(1, -(-K // tile.bk))
    per = -(-nslices // ks)  # K slices a block; the last block takes the rest
    return GemmPlan(variant, nslices // per, per * tile.bk)


def _gemm_tiles(query, suf: str) -> Tuple[GemmTile, ...]:
    """The tile variants the built kernel reports, checked: edges
    decreasing, K slices that divide ``MIN_SPLIT_DEPTH``, and at least
    one block of each on an SM."""
    tiles = []
    for v in range(2):
        bm, bk, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = query(v, ctypes.byref(bm), ctypes.byref(bk), ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"slate_gemm_layout_{suf}({v}): CUDA error {err}")
        tiles.append(GemmTile(bm.value, bk.value, per_sm.value))
    if (any(t.per_sm < 1 or MIN_SPLIT_DEPTH % t.bk for t in tiles)
            or any(a.bm <= b.bm for a, b in zip(tiles, tiles[1:]))):
        raise RuntimeError(f"gemm kernel layout ({suf}) {tiles} does not fit the plan")
    return tuple(tiles)


def _gemm_plan(C: torch.Tensor, M: int, N: int, K: int, lower: bool) -> GemmPlan:
    _load()
    return gemm_sub_plan(M, N, K, lower, _GEMM_TILES[C.dtype], _sms(C.device))


# ---------------------------------------------------------------------------
# chol_base
# ---------------------------------------------------------------------------

#: dynamic shared memory a block may use on Hopper
_MAX_SMEM = 227 * 1024
_CB_S, _CB_LDD = 32, 33  # csrc: CB_S, CB_LDD


def chol_base_smem(b: int, itemsize: int) -> int:
    """Dynamic shared memory of one chol_base launch on a (b, b) block
    (csrc: ``cb_smem_bytes``): the strip's solved panel, ``_CB_S`` values
    for every row from ``_CB_S`` to the last whole tile, the diagonal
    block on padded rows, its reciprocal pivots and two slots of a
    column's multipliers."""
    tiles = -(-b // _CB_S)
    return ((tiles - 1) * _CB_S * _CB_S + _CB_S * _CB_LDD + 3 * _CB_S) * itemsize


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
    Bound on the H100: neither bytes (one b x b block) nor FLOPs (b^3/3,
    11 us at one SM's DMMA rate at b = 256) — it is a chain of b
    dependent column steps, so it is latency-bound.  Design: one thread
    block walks strips of 32 columns; the strip's solved panel stays in
    shared memory and the trailing lower triangle in L2, updated a 32 x
    32 tile at a time in a warp's registers (DMMA in float64, FFMA in
    float32), loaded and stored once a strip.  Warp 0 factors the next
    diagonal block (one reciprocal square root a column) while the
    other warps update the rest, and a thread a row solves the panel
    below it, right-looking.  Two block barriers a strip.  One copy of G
    (contiguous), factored in place; b up to 896 (float64) / 1792
    (float32), the shared-memory panel's limit."""
    if G.dim() != 2 or G.shape[0] != G.shape[1]:
        raise ValueError(f"chol_base: expected a square block, got {tuple(G.shape)}")
    if _on_cpu("chol_base", G):
        return chol_base_plain(G)
    b = G.shape[0]
    if chol_base_smem(b, G.element_size()) > _MAX_SMEM:
        raise ValueError(f"chol_base: b = {b} exceeds the shared-memory panel")
    out = G.clone(memory_format=torch.contiguous_format)  # the one copy, factored in place
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
    Bound on the H100: operations (t^2 h FLOPs on t x h values, t <= 256),
    but at t = 256 the output has only 3 lower tiles of 128, or 10 of 64.
    Design: the gemm_sub kernel (DMMA in float64, FFMA in float32) with
    the tiles above the diagonal skipped and the writes masked to r >= c;
    ``gemm_sub_plan`` picks the tile and splits K across blocks (partials
    summed by a second kernel in a fixed order) so that enough blocks
    fill the card."""
    if C.dim() != 2 or A.dim() != 2 or C.shape[0] != C.shape[1] or A.shape[0] != C.shape[0]:
        raise ValueError(f"syrk_diag: shapes {tuple(C.shape)}, {tuple(A.shape)}")
    if _on_cpu("syrk_diag", C, A):
        return syrk_diag_plain(C, A)
    t, K = A.shape
    out = C.contiguous().clone()
    if t == 0:
        return out
    plan = _gemm_plan(C, t, t, K, True)
    work = (torch.empty((plan.ksplit, t, t), dtype=C.dtype, device=C.device)
            if plan.ksplit > 1 else out)
    _launch("syrk_diag", _entry("syrk_diag", C.dtype),
            out.data_ptr(), _ld(out), A.data_ptr(), _ld(A), work.data_ptr(),
            t, K, plan.ksplit, plan.kchunk, plan.variant, _stream(C))
    return out


def gemm_sub_plain(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: C - A B^H."""
    return C - hdot(A, B.mH)


def gemm_sub(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Off-diagonal block of the Cholesky trailing update: C - A B^H
    (for real types C - A B^T).

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:gemm_sub_pallas``.
    Bound on the H100: operations — 2 M N K FLOPs at 67 TFLOP/s (FP64
    tensor cores, FP32 SIMT), up to (4096, 4096, 8192) at n = 16384:
    4.10 ms, about half of the factorization's FLOPs.  Design: A and B
    are read along their rows (K), which is what the mma.sync fragments
    take, so no transposed copy is made; K slices of both go through a
    ring of cp.async stages in shared memory (16-byte copies where rows
    are aligned, zero fill at the ragged edges).  float64 runs on DMMA
    (m16n8k4, 8 warps of 64 x 32 in a 128 x 128 tile), float32 on FFMA
    (no TF32; 8 x 8 outputs a thread read as float4 along K).
    ``gemm_sub_plan`` picks the 128 or the 64 tile and splits K across
    blocks (partials summed in a fixed order by a second kernel) when
    the output has too few tiles to fill the card; the epilogue writes
    C - A B^T from the registers."""
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
    plan = _gemm_plan(C, M, N, K, False)
    work = (torch.empty((plan.ksplit, M, N), dtype=C.dtype, device=C.device)
            if plan.ksplit > 1 else out)
    _launch("gemm_sub", _entry("gemm_sub", C.dtype),
            C.data_ptr(), _ld(C), A.data_ptr(), _ld(A), B.data_ptr(), _ld(B),
            out.data_ptr(), _ld(out), work.data_ptr(), M, N, K, plan.ksplit, plan.kchunk,
            plan.variant, _stream(C))
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


#: rows of a block step of the trsm sweep and columns of an output tile
#: (csrc: TR_KB, TrLayout::BN; checked against the built kernels when they
#: load), and how many source blocks a far row block takes at once, every
#: that many launches
TRSM_KB, TRSM_BN, TRSM_D = 128, 64, 2

Span = Tuple[int, int]


class TrsmUpdate(NamedTuple):
    """rows -= op(T)[rows, src] X[src] (half-open row ranges of op(T));
    ``from_b``: the rows' first update, which reads their right-hand
    side from B (later ones read X)."""
    rows: Span
    src: Span
    from_b: bool


class TrsmStep(NamedTuple):
    """One launch of a trsm sweep: ``updates`` first (the owner's, on the
    rows of ``solve``, then the far row blocks'), then the row block
    ``solve`` is solved; with no update it reads B."""
    solve: Span
    updates: Tuple[TrsmUpdate, ...]


def trsm_step_plan(n: int, lower: bool) -> List[TrsmStep]:
    """The schedule of ``trsm_lower``/``trsm_upper`` on the card, which
    ``_trsm`` hands to the kernel step by step (``lower`` names op(T)'s
    triangle; ``transposed`` changes only where op(T) lies in memory):
    row blocks of ``TRSM_KB`` rows from the top, the last one ragged,
    walked top-down for lower and bottom-up for upper.  Launch s solves
    block s after taking block s - 1 from it; the row blocks at distance
    1, 1 + d, 1 + 2d, ... (d = ``TRSM_D``) from it take the blocks solved
    by launches s - d .. s - 1 at once, so each far row block is read and
    written every d launches with d times the depth."""
    kb, d = TRSM_KB, TRSM_D
    blocks = [(r, min(n, r + kb)) for r in range(0, n, kb)]
    order = blocks if lower else blocks[::-1]

    def span(j0: int, j1: int) -> Span:  # the rows of order[j0:j1], contiguous
        sel = order[j0:j1]
        return min(b[0] for b in sel), max(b[1] for b in sel)

    steps = []
    for s, blk in enumerate(order):
        updates = []
        if s >= 1:
            updates.append(TrsmUpdate(blk, span(s - 1, s), s == 1))
            updates += [TrsmUpdate(order[s + dist], span(max(0, s - d), s), s <= d)
                        for dist in range(1, len(order) - s, d)]
        steps.append(TrsmStep(blk, tuple(updates)))
    return steps


#: the fields of one launch in the kernel's table (csrc: TrStep)
TRSM_TABLE_FIELDS = ("own_r0", "own_k0", "own_kw", "far_r0", "far_step", "far_count",
                     "far_k0", "far_kw", "reads_b")


@functools.lru_cache(maxsize=64)
def trsm_launch_table(n: int, lower: bool) -> Tuple[Tuple[int, ...], ...]:
    """``trsm_step_plan`` as the kernel takes it, one row of
    ``TRSM_TABLE_FIELDS`` a launch: the owner's rows and sources, the
    far row blocks at ``far_r0 + y * far_step`` (y < ``far_count``, each
    ``min(TRSM_KB, n - r0)`` rows) with their common sources, and
    ``reads_b`` (bit 0: the owner reads B, bit 1: the far row blocks do).
    Raises if a step does not fit that form."""
    table = []
    for st in trsm_step_plan(n, lower):
        own = st.updates[0] if st.updates else TrsmUpdate(st.solve, (st.solve[0],) * 2, True)
        far = st.updates[1:]
        first = far[0].rows[0] if far else 0
        step = far[1].rows[0] - first if len(far) > 1 else 0
        if own.rows != st.solve or len({(u.src, u.from_b) for u in far}) > 1 or any(
                u.rows != (first + y * step, min(n, first + y * step + TRSM_KB))
                for y, u in enumerate(far)):
            raise ValueError(f"trsm_launch_table: step {st} does not fit the kernel's launch")
        src = far[0].src if far else (0, 0)
        table.append((own.rows[0], own.src[0], own.src[1] - own.src[0], first, step, len(far),
                      src[0], src[1] - src[0],
                      int(own.from_b) | (2 if far and far[0].from_b else 0)))
    return tuple(table)


def _trsm_table_array(table) -> ctypes.Array:
    return (ctypes.c_int * (len(TRSM_TABLE_FIELDS) * len(table)))(
        *(v for row in table for v in row))


@functools.lru_cache(maxsize=64)
def _trsm_plan_array(n: int, lower: bool) -> ctypes.Array:
    return _trsm_table_array(trsm_launch_table(n, lower))


def _trsm_sweep(T, B, X, lower: bool, unit: bool, transposed: bool,
                plan: ctypes.Array) -> Tuple[int, int]:
    """Launch the kernel once a row of ``plan`` (a launch table as a
    ctypes int array) on CUDA tensors; returns (CUDA error, launches)."""
    launched = ctypes.c_int(0)
    err = _entry("trsm", T.dtype)(
        T.data_ptr(), _ld(T), B.data_ptr(), _ld(B), X.data_ptr(), _ld(X), B.shape[0],
        B.shape[1], int(lower), int(unit), int(transposed), plan,
        len(plan) // len(TRSM_TABLE_FIELDS), ctypes.byref(launched), _stream(T))
    return err, launched.value


def trsm_kernel_launches(n: int, nrhs: int = 1) -> int:
    """Kernel launches of one ``trsm_lower``/``trsm_upper`` call on the
    card: one a row block of ``TRSM_KB`` (none for an empty solve)."""
    return 0 if n == 0 or nrhs == 0 else -(-n // TRSM_KB)


def _trsm(name: str, T, B, lower: bool, unit: bool, transposed: bool):
    if T.dim() != 2 or B.dim() != 2 or T.shape[0] != T.shape[1] or T.shape[0] != B.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(T.shape)}, {tuple(B.shape)}")
    if _on_cpu(name, T, B):
        return trsm_plain(T, B, lower, unit, transposed)
    n, nrhs = B.shape
    X = torch.empty((n, nrhs), dtype=B.dtype, device=B.device)
    if n and nrhs:
        err, launched = _trsm_sweep(T, B, X, lower, unit, transposed, _trsm_plan_array(n, lower))
        _count(name, launched)  # the launches made, also on an error
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return X


_TRSM_NOTE = """
    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:{fn}``.  Bound on
    the H100: operations (n^2 nrhs FLOPs against n^2/2 elements of the
    triangle and 2 n nrhs of B and X; 2.05 ms at (16384, 512)).  Design:
    a right-looking blocked substitution stepped from the host, one
    launch a row block of 128 (``trsm_kernel_launches``), each a row of
    ``trsm_launch_table`` (the steps of ``trsm_step_plan``), which the
    wrapper passes in.  Launch s solves block s: the tiles of block s
    take block s - 1, the far row blocks take the last ``TRSM_D`` solved
    blocks at once every ``TRSM_D`` launches (half the right-hand-side
    traffic), then the tiles of block s solve its diagonal block (strips
    of 32 rows, substituted by groups of 8).  The products run in the
    kernel, in 128 x 64 tiles: DMMA (m16n8k4) in float64, 8 x 4 FFMA
    outputs a thread in float32, operands through a ring of cp.async
    stages.  The triangle is read once a column tile, and each step
    spreads over the unsolved row blocks.  Only the stated triangle of
    op(T) is read (packed LU storage is safe; ``unit`` never reads the
    diagonal).  ``transposed`` reads T as T^T (real types only on the
    card), so the backward sweep of a Cholesky solve needs no transposed
    copy of L."""


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


#: panel_lu's launch (csrc: PL_MAX_S, __launch_bounds__): one block an SM
#: (fewer candidates a column and a cheaper grid barrier than two, and
#: the registers of a whole SM), strips of at most 32 columns; an SM's
#: shared memory and what the card reserves of it for each block
PL_BLOCKS_PER_SM, PL_MAX_STRIP = 1, 32
_SM_SMEM, _SMEM_RESERVED = 228 * 1024, 1024


class PanelLuPlan(NamedTuple):
    """One panel_lu launch: ``grid`` blocks of ``rows`` rows each, strips
    of ``strip`` columns."""
    grid: int
    rows: int
    strip: int


def _pl_static_smem(itemsize: int) -> int:
    """The kernel's static shared memory: a candidate (value, position,
    row) a warp of 16."""
    return 16 * itemsize + 4 * 2 * 16


def _panel_lu_smem(rows: int, S: int, nb: int, itemsize: int) -> int:
    """Dynamic shared memory of a block of ``rows`` rows at strip width
    S: the strip cache (rows x ldc), the strip's pivot rows (S x ldc),
    U12 (S x (nb - S)) and the rows' positions; ldc is S rounded up to
    an odd count (no bank conflicts down a column).  At S = 1 it is what
    the column-by-column kernel needed: rows x (value + position) and
    one row of nb values."""
    ldc = S if S % 2 else S + 1
    return itemsize * (rows * ldc + S * ldc + S * max(0, nb - S)) + 4 * rows


def panel_lu_plan(M: int, nb: int, itemsize: int, sms: int,
                  smem_per_block: int) -> PanelLuPlan:
    """The grid, the rows a block and the strip width of one (M, nb)
    panel_lu on a card of ``sms`` SMs whose blocks may use
    ``smem_per_block`` bytes of shared memory: the widest strip (at most
    32 columns) for which some grid of at least 16 rows a block and at
    most ``PL_BLOCKS_PER_SM`` blocks an SM keeps every block resident at
    once (the cooperative launch needs that).  Raises when not even one-column
    strips fit."""
    static = _pl_static_smem(itemsize)
    for S in range(min(PL_MAX_STRIP, nb), 0, -1):
        grid = min(PL_BLOCKS_PER_SM * sms, max(1, -(-M // 16)))
        while True:
            rows = -(-M // grid)
            smem = _panel_lu_smem(rows, S, nb, itemsize)
            if smem + static > smem_per_block:
                break  # fewer blocks only make each one larger
            per_sm = min(PL_BLOCKS_PER_SM, _SM_SMEM // (smem + static + _SMEM_RESERVED))
            if grid <= per_sm * sms:
                return PanelLuPlan(grid, rows, S)
            grid = per_sm * sms
    raise ValueError(f"panel_lu: a ({M}, {nb}) panel does not fit in shared memory "
                     f"on {sms} SMs")


def panel_lu(panel: torch.Tensor, pivot: bool = True,
             act: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot unblocked LU of an (M, nb) panel -> (lu, perm int32),
    the contract of ``panel_lu_plain``.  Rows at or past ``act`` are
    never pivots (the recursion's canonical zero pad); ``act`` must cover
    the eliminated columns.

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:panel_lu_pallas``.
    Bound on the H100: neither bytes (one read and one write of the
    panel) nor FLOPs (M nb^2) — min(M, nb) dependent column steps, each
    needing the whole column, so grid-wide synchronisation sets its
    time.  Design: one cooperative launch over the card, a slab of rows
    a block (one block an SM, ``panel_lu_plan``), one grid barrier and
    one block barrier a column; rows stay in place and their positions
    in the swap order are tracked.  The columns go in strips of up to
    32: a block holds the strip's columns of its rows still to pivot in
    shared memory, and inside the strip updates only those.  Each block
    sends its candidate's strip row with the candidate; after the
    barrier every warp reduces the candidates and reads the pivot row's
    strip itself, then takes a row at a time (the multipliers divided a
    lane a row) and finds its candidate for the next column on the way.
    At the strip's end every block builds the strip's pivot rows on the
    trailing columns (U12, the same arithmetic in each block) and gives
    its own rows still to pivot the strip's updates there, one read and
    one write of each element a strip instead of a column.  The owner
    of a pivot row writes its U12 row only after the next grid barrier
    (a barrier of its own after the last strip), when no block reads
    the row's trailing values any more.  Every element sees the plain
    version's updates in the same order
    (tests/test_torch_panel_lu_strip.py emulates the schedule);
    explicitly rounded multiplies, subtracts and IEEE divisions (no FMA
    contraction) make lu and perm bit-identical to the plain version,
    and the NaNs that the plain version's updates of finished rows make
    from a non-finite u or l are written when the rows are copied out."""
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
    plan = _panel_lu_plan(panel)
    out = torch.empty((M, nb), dtype=panel.dtype, device=dev)
    work = torch.empty((M, nb), dtype=panel.dtype, device=dev)
    perm = torch.empty(M, dtype=torch.int32, device=dev)
    G = plan.grid
    cmag = torch.empty(2 * G, dtype=panel.dtype, device=dev)
    # candidates (2 x G x (position, row)), the rows' NaN marks (M), each
    # block's NaN marks of the columns (G x nb) and its strip's winners (G x 32)
    iscr = torch.empty(4 * G + M + G * (nb + PL_MAX_STRIP), dtype=torch.int32, device=dev)
    with _panel_lu_lock:
        _launch("panel_lu", _entry("panel_lu", panel.dtype),
                panel.data_ptr(), _ld(panel), work.data_ptr(), out.data_ptr(), perm.data_ptr(),
                cmag.data_ptr(), iscr.data_ptr(), M, nb, M if act is None else act,
                int(pivot), G, plan.rows, plan.strip, _stream(panel))
    return out, perm


def _panel_lu_plan(panel: torch.Tensor) -> PanelLuPlan:
    M, nb = panel.shape
    return panel_lu_plan(M, nb, panel.element_size(), _sms(panel.device), _MAX_SMEM)


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


# ---------------------------------------------------------------------------
# larft
# ---------------------------------------------------------------------------

#: the diagonal that stands for an absent reflector (tau == 0)
LARFT_BIG = 1e30

#: a chunk of V's rows is at least this many slices deep when V has that
#: many: a block's ring runs full and its reads outweigh its partial's write
LARFT_MIN_SLICES = 4


class LarftTile(NamedTuple):
    """A tile variant of the larft kernel as the built kernel reports it
    (``slate_larft_layout_*``): the output tile's edge, the rows of a
    slice of its ring, how many of its blocks fit on one SM, and the
    work of a diagonal tile in quarters of a full tile's (3 where the
    tile skips its quadrant below the diagonal)."""
    bm: int
    bk: int
    per_sm: int
    diag_work: int


class LarftPlan(NamedTuple):
    """One larft call: the tile variant (an index into the kernel's
    tiles), and the number of chunks the rows of V are split into (see
    ``larft_chunks``) for each diagonal tile and for each tile above the
    diagonal; one block a tile and a chunk."""
    variant: int
    diag_chunks: int
    off_chunks: int


#: the tile variants of the built larft kernel, by dtype (filled by ``_load``)
_LARFT_TILES: Dict[torch.dtype, Tuple[LarftTile, ...]] = {}


def larft_plan(M: int, w: int, tiles: Tuple[LarftTile, ...], sms: int) -> LarftPlan:
    """The tile variant and row split of one larft of V (M, w) on a card
    of ``sms`` SMs, from the kernel's ``tiles`` (largest first): the
    largest tile no wider than w (else the smallest); then the most
    chunks for the tiles above the diagonal, with the diagonal tiles'
    chunks in the ratio of their work (so a block's work is about the
    same in both), whose blocks fit in one wave of the card's block slots
    (``per_sm`` an SM), each chunk at least ``LARFT_MIN_SLICES`` slices
    deep (one chunk when V has fewer)."""
    variant = next((v for v, t in enumerate(tiles) if t.bm <= w), len(tiles) - 1)
    tile = tiles[variant]
    nt = -(-w // tile.bm)
    off = nt * (nt - 1) // 2
    most = max(1, -(-M // tile.bk) // LARFT_MIN_SLICES)
    slots = tile.per_sm * sms

    def diag_chunks(co: int) -> int:
        return max(1, min(most, (co * tile.diag_work + 2) // 4))

    if off == 0:
        cd = max(1, min(most, slots // nt))
        return LarftPlan(variant, cd, cd)
    lo, hi = 1, most  # the blocks grow with co: bisect for the last co that fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if nt * diag_chunks(mid) + off * mid <= slots:
            lo = mid
        else:
            hi = mid - 1
    return LarftPlan(variant, diag_chunks(lo), lo)


def larft_blocks(plan: LarftPlan, w: int, bm: int) -> int:
    """The blocks of one larft launch: a diagonal tile's chunks each, then
    a chunk each of the tiles above the diagonal."""
    nt = -(-w // bm)
    return nt * plan.diag_chunks + nt * (nt - 1) // 2 * plan.off_chunks


def larft_chunks(M: int, bk: int, nchunk: int) -> List[Span]:
    """The rows of V each of a tile's ``nchunk`` chunks takes, as the
    kernel computes them: chunk c of n takes the slices [c S / n,
    (c + 1) S / n) of the S slices of ``bk`` rows (the last one cut at
    M), so the chunks cover the rows once, in order, within one slice of
    each other in depth."""
    nsl = -(-M // bk)
    return [(c * nsl // nchunk * bk, min(M, (c + 1) * nsl // nchunk * bk))
            for c in range(nchunk)]


def _larft_tiles(query, suf: str) -> Tuple[LarftTile, ...]:
    """The tile variants the built larft kernel reports, checked: edges
    decreasing, at least one block of each on an SM, a diagonal tile's
    work between a quarter and a whole tile's."""
    tiles = []
    for v in range(2):
        vals = [ctypes.c_int() for _ in LarftTile._fields]
        err = query(v, *map(ctypes.byref, vals))
        if err != 0:
            raise RuntimeError(f"slate_larft_layout_{suf}({v}): CUDA error {err}")
        tiles.append(LarftTile(*(x.value for x in vals)))
    if (any(t.per_sm < 1 or t.bk < 1 or not 1 <= t.diag_work <= 4 for t in tiles)
            or any(a.bm <= b.bm for a, b in zip(tiles, tiles[1:]))):
        raise RuntimeError(f"larft kernel layout ({suf}) {tiles} does not fit the plan")
    return tuple(tiles)


def _pad_taus(taus: torch.Tensor, w: int) -> torch.Tensor:
    """taus as a contiguous (w,) vector: a short one (fewer rows than
    columns) padded with zeros, i.e. absent reflectors."""
    if taus.shape[0] < w:
        taus = torch.cat([taus, taus.new_zeros(w - taus.shape[0])])
    return taus.contiguous()


def larft_tinv_plain(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Plain version: T^-1 = strict_upper(V^H V) + diag(d), d_j = 1/tau_j
    (an IEEE division) for tau_j != 0, 1e30 for tau_j == 0."""
    taus = _pad_taus(taus, V.shape[1])
    U = torch.triu(hdot(V.mH, V), 1)
    d = torch.where(taus != 0, torch.ones_like(taus) / torch.where(taus == 0, 1, taus),
                    LARFT_BIG)
    return U + torch.diag(d)


def larft_tinv(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """The compact-WY assembly stage, the contract of ``larft_tinv_plain``:
    V (M, w) unit-lower with its unit diagonal materialized (zeros above
    it), taus (<= w,).

    Replaces ``slate_tpu/ops/pallas/panel_kernels.py:larft_pallas`` (body
    ``_larft_tinv_body``).  Bound on the H100: operations (M w (w - 1)
    FLOPs for the strict upper Gram against M w elements read: 2.1 GFLOP
    on 64 MiB at (32768, 256) in float64).  Design: the Gram's reduction
    runs along V's rows, so slices of 32 rows of the tile's two column
    blocks are staged k-major, as V lies (no transposed copy), through a
    ring of cp.async stages (16-byte copies where V's rows are aligned,
    zero fill at the ragged edges); float64 runs on DMMA (m16n8k4, 8
    warps of 64 x 32 in a 128 x 128 tile), float32 on FFMA (no TF32; 8 x
    8 outputs a thread read as float4 along the slot's rows; that tile is
    bound by its FFMAs, and a diagonal one skips its quadrant below the
    diagonal).  Only the tiles on or above the diagonal are computed;
    ``larft_plan`` splits the rows into chunks of whole slices, fewer
    for a diagonal tile that does less work, so that the (tile, chunk)
    blocks fill one wave of the card with about the same work each, each
    writing a partial tile, and a second kernel sums the partials in
    chunk order (the result does not change from run to run), writes
    the diagonal by IEEE division and the exact zeros below it."""
    if V.dim() != 2 or taus.dim() != 1 or taus.shape[0] > V.shape[1]:
        raise ValueError(f"larft: V {tuple(V.shape)}, taus {tuple(taus.shape)}")
    M, w = V.shape
    taus = _pad_taus(taus, w)
    if _on_cpu("larft", V, taus.reshape(1, w)):
        return larft_tinv_plain(V, taus)
    if w > 1024:
        raise ValueError(f"larft: w = {w} > 1024")
    out = torch.empty((w, w), dtype=V.dtype, device=V.device)
    if w == 0:
        return out
    fn, plan, work_shape = _larft_setup(M, w, V.dtype, V.device)
    work = torch.empty(work_shape, dtype=V.dtype, device=V.device)
    _launch("larft", fn, V.data_ptr(), _ld(V), taus.data_ptr(), out.data_ptr(),
            work.data_ptr(), M, w, plan.diag_chunks, plan.off_chunks, plan.variant, _stream(V))
    return out


@functools.lru_cache(maxsize=64)
def _larft_setup(M: int, w: int, dtype: torch.dtype, device: torch.device):
    """The entry point, the plan and the shape of the partials of one
    larft shape, kept: the QR recursion repeats a few shapes, and on a
    call this short the card waits out the host's time before the
    launch."""
    _load()
    tiles = _LARFT_TILES[dtype]
    plan = larft_plan(M, w, tiles, _sms(device))
    bm = tiles[plan.variant].bm
    return _entry("larft", dtype), plan, (larft_blocks(plan, w, bm), bm, bm)


def _larft_finish(Tinv: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """T from T^-1 by the library's triangular solve (<= nb, as in the
    JAX package), with exact zeros in the rows and columns of absent
    reflectors."""
    w = Tinv.shape[0]
    eye = torch.eye(w, dtype=Tinv.dtype, device=Tinv.device)
    T = torch.linalg.solve_triangular(Tinv, eye, upper=True)
    live = (taus != 0)[None, :] & (taus != 0)[:, None]
    return torch.where(live, T, 0).contiguous()


def larft_plain(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Plain version of ``larft``: the compact-WY T factor (w, w) of
    unit-lower V (M, w) and taus, Q = I - V T V^H, from the identity
    T^-1 = diag(1/tau) + strict_upper(V^H V)."""
    taus = _pad_taus(taus, V.shape[1])
    return _larft_finish(larft_tinv_plain(V, taus), taus)


def larft(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T factor of the QR base panel: the ``larft`` kernel for
    T^-1 (see ``larft_tinv``), then the library solve and the tau == 0
    masking."""
    taus = _pad_taus(taus, V.shape[1])
    return _larft_finish(larft_tinv(V, taus), taus)


# ---------------------------------------------------------------------------
# tile_norms / tile_geadd / tile_transpose
# ---------------------------------------------------------------------------

_NORM_KINDS = {"max": 0, "fro_sumsq": 1, "one": 2, "inf": 3, "max_sumsq": 4}


def _norm_args(T: torch.Tensor, kind: str, rows, cols, scale, skip) -> None:
    """Checks common to ``tile_norms`` and its plain version."""
    if kind not in _NORM_KINDS:
        raise ValueError(f"tile_norms: unknown kind {kind!r}")
    if T.dim() != 3:
        raise ValueError(f"tile_norms: expected an (N, mb, nb) stack, got {tuple(T.shape)}")
    if (rows is None) != (cols is None):
        raise ValueError("tile_norms: give both rows and cols, or neither")
    if rows is not None:
        for name, t in (("rows", rows), ("cols", cols)):
            if t.dtype != torch.int32 or t.dim() != 1 or t.device != T.device:
                raise ValueError(f"tile_norms: {name} must be a 1-D int32 tensor on "
                                 f"{T.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if rows.numel() * cols.numel() != T.shape[0]:
            raise ValueError(f"tile_norms: {rows.numel()} x {cols.numel()} counts for "
                             f"{T.shape[0]} tiles")
    if (scale is not None or skip is not None) and kind != "fro_sumsq":
        raise ValueError("tile_norms: scale and skip belong to fro_sumsq")
    for name, t, dt in (("scale", scale, T.dtype), ("skip", skip, torch.bool)):
        if t is not None and (t.dim() != 0 or t.dtype != dt or t.device != T.device):
            raise ValueError(f"tile_norms: {name} must be a 0-d {dt} tensor on {T.device}")


def tile_norms_plain(T: torch.Tensor, kind: str, rows: Optional[torch.Tensor] = None,
                     cols: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
                     skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: per-tile statistics of |T| over an (N, mb, nb)
    stack: 'max' and 'fro_sumsq' (sum of squares) -> (N,), 'max_sumsq'
    (both) -> (N, 2), 'one' (column sums) -> (N, nb), 'inf' (row sums)
    -> (N, mb).

    With ``rows`` (P,) and ``cols`` (Q,), int32 and P Q = N, tile
    b = p Q + q counts only rows < rows[p] and columns < cols[q]: the
    rest count as zero, whatever they hold.  'fro_sumsq' takes a 0-d
    ``scale`` (sums (|a| / scale)^2 over the counted elements) and a 0-d
    bool ``skip`` (all zeros when true)."""
    _norm_args(T, kind, rows, cols, scale, skip)
    a = T.abs()
    if scale is not None:
        a = a / scale
    if rows is not None:
        N, mb, nb = T.shape
        rm = torch.arange(mb, device=T.device) < rows[:, None]
        cm = torch.arange(nb, device=T.device) < cols[:, None]
        mask = (rm[:, None, :, None] & cm[None, :, None, :]).reshape(N, mb, nb)
        a = torch.where(mask, a, 0)
    if kind == "max":
        return a.amax(dim=(1, 2))
    if kind == "fro_sumsq":
        out = (a * a).sum(dim=(1, 2))
        return out if skip is None else torch.where(skip, 0, out)
    if kind == "max_sumsq":
        return torch.stack([a.amax(dim=(1, 2)), (a * a).sum(dim=(1, 2))], dim=1)
    if kind == "one":
        return a.sum(dim=1)
    return a.sum(dim=2)


def tile_norms(T: torch.Tensor, kind: str, rows: Optional[torch.Tensor] = None,
               cols: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
               skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tile norm statistics of the signed tiles, the contract of
    ``tile_norms_plain``.

    Replaces ``slate_tpu/ops/pallas/kernels.py:tile_norms_pallas``; with
    the counts it also does the JAX package's ``where(mask, |T|, 0)``,
    and with ``scale`` its division by ``safe``, in the same read.  Bound
    on the H100: bytes (each counted element read once; 2.15 GB at
    (1024, 512, 512) in float64).  Design: a block a tile; 16-byte
    streaming loads when the stack's base, row stride and tile stride
    are multiples of 16 bytes (one value at a time otherwise), four or
    eight in flight a thread; each launch holds the SM to the blocks
    that fill whole waves of the N tiles (``tn_blocks_per_sm``); the
    padding beyond the counts is never read; 'max' propagates NaN as
    ``torch.amax`` does (bit-identical to the plain version), the sums
    are fixed-order reductions in the operand's type, so two calls are
    bitwise equal.  The JAX package's gate (float32 and (8, 128)-aligned
    tiles) is a Mosaic limit: this kernel takes float32/float64 and any
    tile shape."""
    _norm_args(T, kind, rows, cols, scale, skip)
    if _on_cpu("tile_norms", T, dim=3):
        return tile_norms_plain(T, kind, rows, cols, scale, skip)
    N, mb, nb = T.shape
    shape = {"max": (N,), "fro_sumsq": (N,), "max_sumsq": (N, 2), "one": (N, nb),
             "inf": (N, mb)}[kind]
    out = torch.empty(shape, dtype=T.dtype, device=T.device)
    if not (N and mb and nb):
        return out.zero_()
    ptr, sn, ld = T.data_ptr(), _tile_stride(T), _ld(T)
    counts = (None, None, 1)
    if rows is not None:
        rows, cols = rows.contiguous(), cols.contiguous()
        counts = (rows.data_ptr(), cols.data_ptr(), cols.numel())
    _launch("tile_norms", _entry("tile_norms", T.dtype),
            ptr, sn, ld, N, mb, nb, _NORM_KINDS[kind], *counts,
            None if scale is None else scale.data_ptr(), None if skip is None else skip.data_ptr(),
            int(_vector_aligned(T.element_size(), ptr, sn, ld)), out.data_ptr(), _stream(T))
    return out


def _vector_aligned(esize: int, ptr: int, *strides: int) -> bool:
    """Whether a base address and strides (in values of esize bytes) are
    all multiples of 16 bytes."""
    return ptr % 16 == 0 and all(s * esize % 16 == 0 for s in strides)


def tile_geadd_plain(alpha, A: torch.Tensor, beta, B: torch.Tensor) -> torch.Tensor:
    """Plain version: alpha A + beta B over a tile stack."""
    return alpha * A + beta * B


def tile_geadd(alpha: float, A: torch.Tensor, beta: float, B: torch.Tensor) -> torch.Tensor:
    """B = alpha A + beta B over an (N, mb, nb) stack (a new tensor),
    alpha and beta host scalars rounded to the operands' type.

    Replaces ``slate_tpu/ops/pallas/kernels.py:tile_geadd_pallas``, which
    nothing in the JAX package calls (``tile_ops.geadd`` is a plain
    expression), so nothing here calls it either.  Bound on the H100:
    bytes (two reads and one write).  Design: a grid-stride elementwise
    pass with explicitly rounded products and sum, bit-identical to the
    plain version."""
    if A.dim() != 3 or A.shape != B.shape:
        raise ValueError(f"tile_geadd: shapes {tuple(A.shape)}, {tuple(B.shape)}")
    if _on_cpu("tile_geadd", A, B, dim=3):
        return tile_geadd_plain(alpha, A, beta, B)
    N, mb, nb = A.shape
    out = torch.empty((N, mb, nb), dtype=A.dtype, device=A.device)
    if out.numel():
        _launch("tile_geadd", _entry("tile_geadd", A.dtype),
                float(alpha), A.data_ptr(), _tile_stride(A), _ld(A), float(beta), B.data_ptr(),
                _tile_stride(B), _ld(B), out.data_ptr(), N, mb, nb, _stream(A))
    return out


def tile_transpose_plain(T: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """Plain version: (N, mb, nb) -> (N, nb, mb), each tile transposed
    (conjugated too for a complex stack with ``conj``)."""
    out = T.transpose(1, 2)
    if conj and T.is_complex():
        out = out.conj()
    return out.contiguous()


def tile_transpose(T: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """Per-tile transpose (N, mb, nb) -> (N, nb, mb), contiguous,
    conjugated too for a complex stack with ``conj`` (the contract of
    ``tile_transpose_plain``; the kernel takes real stacks only, where
    ``conj`` changes nothing).

    Replaces ``slate_tpu/ops/pallas/kernels.py:tile_transpose_pallas``,
    which the JAX package disables (``_PALLAS_TRANSPOSE_ENABLED``), so
    nothing here calls it either.  Bound on the H100: bytes (one read,
    one write).  Design: 32 x 32 blocks through a padded 32 x 33 shared
    tile, coalesced reads and writes; bit-identical by construction."""
    if T.dim() != 3:
        raise ValueError(f"tile_transpose: expected an (N, mb, nb) stack, got {tuple(T.shape)}")
    if _on_cpu("tile_transpose", T, dim=3):
        return tile_transpose_plain(T, conj)
    N, mb, nb = T.shape
    out = torch.empty((N, nb, mb), dtype=T.dtype, device=T.device)
    if out.numel():
        _launch("tile_transpose", _entry("tile_transpose", T.dtype),
                T.data_ptr(), _tile_stride(T), _ld(T), out.data_ptr(), N, mb, nb, _stream(T))
    return out
