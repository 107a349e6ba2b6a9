"""Where the port's native libraries are built, and the lock that
serialises their builds.

Both loaders, the Hopper kernels' (``ops/hopper/panel_kernels.py``,
nvcc) and the host chaser's (``native/``, the C compiler), write into
``BUILD_DIR`` beside the package, under ``build_lock``.  The lock is
reentrant (a load builds) and shared: the serve worker and a caller's
warmup may both reach a load first, and must not run a compiler twice
or write one library from two threads.
"""

from __future__ import annotations

import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "slate_tpu_torch"
build_lock = threading.RLock()
