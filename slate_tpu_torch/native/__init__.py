"""Native host kernels, compiled from C at first use: the bulge chase of
the eigensolvers' stage 2 (the counterpart of the JAX package's
``native`` package; reference: src/hb2st.cc:44-187 runs the chase with
host threads over a band gathered to one node).

``hb2st.c`` is this package's own copy of the source.  It is built with
the system C compiler into ``build/slate_tpu_torch/`` beside the package,
keyed by a hash of the source, the compiler, the flags and the host
(``-march=native`` binaries must not be shared across hosts), under the
build lock of ``internal/build.py``, and loaded with ctypes.  When no
compiler is found or the build fails ``load`` returns None and the
drivers take the device wavefront of ``ops/bulge.py``; they count the
route taken (``heev.hb2st.host`` / ``heev.hb2st.device`` in
``aux.metrics``), so a missing compiler shows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..internal.build import BUILD_DIR, build_lock

SOURCE = Path(__file__).resolve().parent / "hb2st.c"
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _compiler() -> Optional[str]:
    return shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")


def _library(cc: str) -> Path:
    key = hashlib.sha256(
        SOURCE.read_bytes() + cc.encode() + " ".join(FLAGS).encode()
        + platform.machine().encode() + platform.node().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libslate_hb2st_{key}.so"


def load() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native chase library, or None when
    there is no C compiler or the build fails."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with build_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        cc = _compiler()
        if cc is None:
            return None
        out = _library(cc)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            r = subprocess.run([cc, *FLAGS, str(SOURCE), "-lm", "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                return None
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.slate_hb2st_d.restype = ctypes.c_int
        lib.slate_hb2st_d.argtypes = args
        lib.slate_hb2st_range_d.restype = ctypes.c_int
        lib.slate_hb2st_range_d.argtypes = args + [ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    return _lib


def hb2st_available() -> bool:
    return load() is not None


def _prepare(W, n: int, b: int):
    """(library, column-major band Wt, n_pad, n_sweeps, jmax1) for a
    chase of diagonal-major W ((2b+1, n_pad) float64, numpy or a
    tensor); raises RuntimeError if the native library is unavailable."""
    lib = load()
    if lib is None:
        raise RuntimeError("native hb2st unavailable")
    W = W.detach().cpu().numpy() if torch.is_tensor(W) else W
    W = np.asarray(W, dtype=np.float64)
    n_sweeps = max(n - 2, 1)
    jmax1 = (n - 3) // b + 2 if n > 2 else 1  # Jmax + 1
    return lib, np.ascontiguousarray(W.T), W.shape[1], n_sweeps, jmax1


def hb2st_host(W, n: int, b: int):
    """Run the native bulge chase on diagonal-major band storage W.
    Returns (d, e, VS, TAUS) as numpy arrays with the shapes and meaning
    of ``ops.bulge.hb2st``'s real path."""
    lib, Wt, n_pad, n_sweeps, jmax1 = _prepare(W, n, b)
    VS = np.zeros((n_sweeps, jmax1, b), np.float64)
    TAUS = np.zeros((n_sweeps, jmax1), np.float64)
    if n > 2 and b >= 2:
        rc = lib.slate_hb2st_d(Wt.ctypes.data, n, n_pad, b, VS.ctypes.data,
                               TAUS.ctypes.data, n_sweeps, jmax1)
        if rc != 0:
            raise RuntimeError(f"slate_hb2st_d failed rc={rc}")
    return Wt[:n, 0].copy(), Wt[: n - 1, 1].copy(), VS, TAUS


def hb2st_host_device(W, n: int, b: int, device, chunk_sweeps: int = 1024):
    """The chase in ranges of ``chunk_sweeps`` sweeps with the reflector
    uploads overlapped: after each range, its VS/TAUS rows go to
    ``device`` by ``non_blocking`` copies from pinned host buffers while
    the next range chases (ctypes releases the GIL for the C call).
    Sequential ranged calls over the persistent band are exactly the
    full chase.  Returns (d, e, VS, TAUS) as tensors on ``device``."""
    from ..aux import metrics

    lib, Wt, n_pad, n_sweeps, jmax1 = _prepare(W, n, b)
    device = torch.device(device)
    pin = device.type == "cuda"
    VS_h = torch.zeros((n_sweeps, jmax1, b), dtype=torch.float64, pin_memory=pin)
    TAUS_h = torch.zeros((n_sweeps, jmax1), dtype=torch.float64, pin_memory=pin)
    VS, TAUS = VS_h.numpy(), TAUS_h.numpy()
    if not pin:
        VS_d, TAUS_d = VS_h, TAUS_h
    else:
        VS_d = torch.empty(VS_h.shape, dtype=torch.float64, device=device)
        TAUS_d = torch.empty(TAUS_h.shape, dtype=torch.float64, device=device)
    if n > 2 and b >= 2:
        for s0 in range(0, n_sweeps, chunk_sweeps):
            s1 = min(n_sweeps, s0 + chunk_sweeps)
            rc = lib.slate_hb2st_range_d(Wt.ctypes.data, n, n_pad, b, VS.ctypes.data,
                                         TAUS.ctypes.data, n_sweeps, jmax1, s0, s1)
            if rc != 0:
                raise RuntimeError(f"slate_hb2st_range_d failed rc={rc}")
            # OVERLAP CONTRACT (pairs with the VS memcpy in hb2st.c's
            # chase loop): slate_hb2st_range_d writes reflector rows only
            # for sweeps in [s0, s1), so rows [s0, s1) are final here and
            # their upload may drain while the NEXT range computes rows
            # >= s1.  Guarded on the cheap TAUS proxy: a nonzero tau at a
            # sweep >= s1 means the kernel wrote outside its range.
            assert s1 >= n_sweeps or not TAUS[s1:].any(), (
                f"hb2st range contract violated: tau written beyond sweep {s1}")
            if pin:
                VS_d[s0:s1].copy_(VS_h[s0:s1], non_blocking=True)
                TAUS_d[s0:s1].copy_(TAUS_h[s0:s1], non_blocking=True)
                metrics.inc("transfer.h2d_bytes", VS[s0:s1].nbytes + TAUS[s0:s1].nbytes)
    elif pin:
        VS_d.copy_(VS_h)
        TAUS_d.copy_(TAUS_h)
    d = torch.from_numpy(Wt[:n, 0].copy()).to(device)
    e = torch.from_numpy(Wt[: n - 1, 1].copy()).to(device)
    return d, e, VS_d, TAUS_d
