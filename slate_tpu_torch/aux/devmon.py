"""Device telemetry plane (the JAX package's ``aux/devmon.py``, mapped
to torch): per-core cost/memory capture, device memory gauges, and the
roofline peaks table (Williams, Waterman & Patterson, CACM 2009).

1. **Cost/memory capture** -- PyTorch has no compiled executable to
   read a cost analysis off, so :func:`capture_run` measures one run
   of a bucket core instead: the model FLOPs and the operand / result
   bytes the caller passes, and ``peak_bytes`` from
   ``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``
   around the run.  The serve cache calls it at a core's first run on a
   device (its cold build, or the first run after a verified artifact
   restore), keyed ``serve.<bucket>.b<batch>``, and persists the row in
   the manifest's ``"cost"`` field.  The row's field names are the JAX
   package's.
2. **Device memory gauges** -- :func:`sample_devices` reads
   ``torch.cuda.memory_stats`` / ``mem_get_info`` per device into
   ``serve.device.<i>.bytes_in_use`` / ``.bytes_in_use_peak`` gauges,
   with a process-lifetime high-water mark; a CPU device's record has
   ``None`` byte fields, as XLA:CPU's has in the JAX package.
3. **Roofline attribution** -- :func:`peaks_for` resolves a device kind
   to (peak FLOP/s, peak bytes/s) from :data:`DEFAULT_PEAKS` or the
   ``SLATE_TPU_PEAKS`` JSON override; :func:`roofline` joins a measured
   wall time with flops / bytes into the achieved rate, the arithmetic
   intensity, the bound and the fraction of the roof.

Zero overhead when off: every producer gates on :func:`is_on`, one
module-level bool.  ``SLATE_TPU_DEVMON=1`` arms it at import.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from . import metrics as _metrics

_enabled = False
_lock = threading.Lock()
#: device id -> process-lifetime high-water mark of bytes_in_use
_hwm: Dict[Any, int] = {}

PEAKS_ENV = "SLATE_TPU_PEAKS"

#: lowercase device-kind substring -> (peak FLOP/s, peak bytes/s),
#: matched by substring.  The cpu and TPU rows are the JAX package's;
#: "h100" is the H100 SXM's FP64 tensor-core / FP32 peak and HBM3 rate
#: (NVIDIA's data sheet), the bounds chip_smoke.py states.
DEFAULT_PEAKS: Dict[str, Dict[str, float]] = {
    "cpu": {"flops": 5.0e10, "bytes_per_s": 2.0e10},
    "tpu v4": {"flops": 2.75e14, "bytes_per_s": 1.2e12},
    "tpu v5": {"flops": 3.9e14, "bytes_per_s": 1.6e12},
    "tpu v6": {"flops": 9.2e14, "bytes_per_s": 1.6e12},
    "h100": {"flops": 6.7e13, "bytes_per_s": 3.35e12},
}

#: the row an unmatched device kind falls back to (reported as such)
FALLBACK_KIND = "cpu"


def on() -> None:
    """Enable device telemetry capture."""
    global _enabled
    _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def reset() -> None:
    """Clear the high-water marks (keeps on/off state)."""
    with _lock:
        _hwm.clear()


def default_device_kind() -> str:
    """Lowercased name of ``cuda:0`` (the peaks-table key), ``"cpu"``
    without a CUDA device."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0).lower()
    return "cpu"


def _kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


# ---------------------------------------------------------------------------
# cost/memory capture
# ---------------------------------------------------------------------------


def capture_run(fn: Callable[[], Any], name: Optional[str], flops: float,
                bytes_accessed: Optional[float], device, record: bool = True):
    """Run ``fn()`` once on ``device`` and measure it: returns ``(out,
    cost)`` with ``cost`` in the JAX package's record fields --
    ``flops`` and ``flops_model`` (the model count passed in),
    ``bytes_accessed`` (when given; a caller that learns the result's
    size from ``out`` fills it in), ``peak_bytes`` (on a CUDA device,
    the allocator's peak during the run above what was allocated before
    it) and ``device_kind``.  With ``record`` and a ``name`` the row
    lands in the metrics cost registry."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    cost: Dict[str, Any] = {"flops": float(flops), "flops_model": float(flops)}
    if bytes_accessed is not None:
        cost["bytes_accessed"] = float(bytes_accessed)
    if cuda:
        torch.cuda.synchronize(dev)
        cost["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev) - base)
    cost["device_kind"] = _kind(dev).lower()
    if record and name:
        _metrics.record_cost(name, cost)
    return out, cost


# ---------------------------------------------------------------------------
# device memory gauges
# ---------------------------------------------------------------------------


def bytes_in_use(device=None) -> Optional[int]:
    """Bytes the caching allocator has handed out on one device
    (default ``cuda:0``): ``memory_stats()["allocated_bytes.all.current"]``;
    None on a CPU device or without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0))


def sample_devices(devices=None) -> List[dict]:
    """One memory snapshot per device (default: every CUDA device):
    ``{"id", "device", "platform", "kind", "bytes_in_use", "bytes_limit",
    "peak_bytes_in_use"}``.  On a CUDA device the bytes in use are the
    allocator's current allocation, the limit ``mem_get_info``'s total,
    the peak the larger of the allocator's peak and this module's
    high-water mark; a CPU device's byte fields are None.  With metrics
    on, ``serve.device.<i>.bytes_in_use`` / ``.bytes_in_use_peak``
    gauges."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        did = dev.index if dev.index is not None else 0
        row = {"id": did, "device": str(dev),
               "platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": _kind(dev), "bytes_in_use": None, "bytes_limit": None,
               "peak_bytes_in_use": None}
        if dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", 0))
            row["bytes_in_use"] = in_use
            row["bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
            with _lock:
                cand = max(_hwm.get(did, 0), peak, in_use)
                _hwm[did] = cand
            row["peak_bytes_in_use"] = cand
            if _metrics.is_on():
                _metrics.gauge(f"serve.device.{did}.bytes_in_use", in_use)
                _metrics.gauge(f"serve.device.{did}.bytes_in_use_peak", cand)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# roofline peaks + attribution
# ---------------------------------------------------------------------------


def _env_peaks() -> Dict[str, Dict[str, float]]:
    """The ``SLATE_TPU_PEAKS`` override table: a JSON object mapping
    device-kind substrings to ``{"flops": ..., "bytes_per_s": ...}``.
    A malformed value degrades to the built-in table, counted
    ``devmon.peaks_parse_error``."""
    raw = os.environ.get(PEAKS_ENV)
    if not raw:
        return {}
    try:
        doc = json.loads(raw)
        out = {}
        for kind, row in doc.items():
            f, b = float(row["flops"]), float(row["bytes_per_s"])
            if f <= 0 or b <= 0:
                raise ValueError(f"peaks for {kind!r} must be positive")
            out[str(kind).lower()] = {"flops": f, "bytes_per_s": b}
        return out
    except Exception:  # noqa: BLE001 — telemetry never stops the host
        _metrics.inc("devmon.peaks_parse_error")
        return {}


def peaks_for(kind: Optional[str] = None) -> dict:
    """``{"kind", "flops", "bytes_per_s", "ridge", "source"}`` of a
    device kind (default :func:`default_device_kind`): an env row wins
    over the table; an unmatched kind takes the cpu row with
    ``source="fallback"``."""
    k = (kind if kind is not None else default_device_kind()).lower()
    env = _env_peaks()
    row, source = None, "default"
    for sub, vals in env.items():
        if sub in k:
            row, source = vals, "env"
            break
    if row is None:
        for sub, vals in DEFAULT_PEAKS.items():
            if sub in k:
                row = vals
                break
    if row is None:
        row = env.get(FALLBACK_KIND, DEFAULT_PEAKS[FALLBACK_KIND])
        source = "fallback"
    return {"kind": k, "flops": float(row["flops"]),
            "bytes_per_s": float(row["bytes_per_s"]),
            "ridge": float(row["flops"]) / float(row["bytes_per_s"]), "source": source}


def roofline(flops: float, bytes_accessed: float, seconds: float,
             peaks: Optional[dict] = None) -> Optional[dict]:
    """Achieved FLOP/s, arithmetic intensity, the compute- or
    memory-bound verdict against the ridge, the attainable roof
    ``min(peak_flops, intensity * peak_bw)`` and the fraction of it;
    None when the inputs cannot rate (non-positive flops, bytes or
    wall)."""
    if not (flops and flops > 0 and bytes_accessed and bytes_accessed > 0
            and seconds and seconds > 0):
        return None
    pk = peaks if peaks is not None else peaks_for()
    if not (pk.get("flops", 0) > 0 and pk.get("bytes_per_s", 0) > 0):
        return None
    ridge = pk.get("ridge") or pk["flops"] / pk["bytes_per_s"]
    achieved = flops / seconds
    intensity = flops / bytes_accessed
    roof = min(pk["flops"], intensity * pk["bytes_per_s"])
    return {"achieved_flops": achieved, "achieved_gflops": achieved / 1e9,
            "intensity": intensity, "ridge": ridge,
            "bound": "compute" if intensity >= ridge else "memory",
            "roof_flops": roof, "frac_of_roof": achieved / roof,
            "peaks_source": pk.get("source", "caller")}


if os.environ.get("SLATE_TPU_DEVMON") not in (None, "", "0"):
    on()
