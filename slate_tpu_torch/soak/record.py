"""Workload recorder: a live serve stream (or the span-ring flight
recorder) becomes a durable, replayable JSONL load spec (the JAX
package's ``soak/record.py``; a spec written by either package loads
in the other).

One spec row per client request::

    {"type": "load", "t_offset": 0.0123, "routine": "gesv",
     "bucket_shape": [12, 12, 2], "dtype": "float64",
     "tenant": "gold", "priority": "high", "deadline_s": 0.5,
     "matrix_seed": 912883, "rhs_seed": 7, "repeat_fp": "a1b2..."}

Operands are NEVER persisted: ``matrix_seed`` feeds the deterministic
``matgen.philox`` generator at replay (``soak/replay.materialize``),
so a spec is a few hundred bytes per request regardless of problem
size.  ``repeat_fp`` is the factor-cache matrix fingerprint when the
request carried one -- rows sharing a ``repeat_fp`` replay with the
SAME regenerated matrix bytes, preserving same-A burst structure (the
factor cache hits on the replayed stream exactly where it hit on the
recorded one).  ``matrix_seed`` derives from ``repeat_fp`` when
present (stable across processes and across the two packages: the
fingerprint is the JAX package's sha256), from the row ordinal
otherwise.

Two capture paths:

* :class:`Recorder` -- a delivery tap
  (``serve.service.add_delivery_tap``) on a live service: exact
  shapes, tenants, deadlines, and fingerprints, straight off the
  resolving ``_Request``.  Armed explicitly; detaching restores the
  hot path to one empty-list truthiness check.
* :func:`from_ring` -- reconstruction from the span ring's completed
  ``request`` root spans (the flight recorder IS a workload sample).
  Shapes come from the bucket label, so they are bucket-rounded, and
  deadlines / fingerprints are not recoverable -- check
  ``spans.pressure()`` (or ``health()["trace_ring"]``) first: a ring
  that has been evicting yields a truncated window.
"""

from __future__ import annotations

import json
import weakref
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..aux import spans, sync
from . import replay as _rp  # canonical row schema lives with the consumer

SPEC_VERSION = 1

#: row fields every writer emits (readers tolerate extras)
SPEC_FIELDS = (
    "t_offset", "routine", "bucket_shape", "dtype", "tenant", "priority",
    "deadline_s", "matrix_seed", "rhs_seed", "repeat_fp",
)


def matrix_seed_for(repeat_fp: Optional[str], ordinal: int) -> int:
    """Stable philox seed for one spec row: a hash of the matrix
    fingerprint when the request carried one (same A -> same seed ->
    byte-identical regenerated A, so repeat structure survives the
    round trip), the row ordinal otherwise."""
    key = repeat_fp if repeat_fp else f"req-{ordinal}"
    return zlib.crc32(key.encode("utf-8")) & 0x7FFFFFFF


def _dtype_name(dtype) -> str:
    """The numpy name of an operand's dtype, numpy or torch: "float64",
    never "torch.float64" (a spec row is the JAX package's format)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


class Recorder:
    """Delivery-tap workload recorder.  ``attach()`` hooks request
    resolution on every live service in the process; ``detach()``
    unhooks.  Hedge twins and duplicate resolutions are deduped on the
    client future (its identity, and a future already resolved), so the
    spec has one row per *submitted* request that resolved (requests refused at ``submit()`` never
    construct a future and are not recorded -- they are the admission
    plane's output, not the workload's shape).

    The service swallows a tap's exceptions (a tap never breaks
    delivery), so a recorder that fails records nothing silently:
    callers check ``len(rec) == delivered + typed_errors``."""

    def __init__(self) -> None:
        self._rows: List[dict] = []
        # WeakSet, not a set of id()s: a client that drops its future
        # after .result() lets CPython reuse the freed id, and an
        # id-keyed dedup would silently swallow the NEXT request that
        # allocates at the same address
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self._t0: Optional[float] = None
        self._lock = sync.Lock("soak.recorder")
        self._attached = False

    # -- capture -----------------------------------------------------------

    def attach(self) -> "Recorder":
        from ..serve import service as _svc

        _svc.add_delivery_tap(self._tap)
        self._attached = True
        return self

    def detach(self) -> "Recorder":
        from ..serve import service as _svc

        _svc.remove_delivery_tap(self._tap)
        self._attached = False
        return self

    def __enter__(self) -> "Recorder":
        return self.attach()

    def __exit__(self, *exc) -> bool:
        self.detach()
        return False

    def _tap(self, req, outcome: str) -> None:
        # the service fires taps before it sets the future, so the first
        # resolution of a request sees it pending.  A hedged pair's twin
        # shares the primary's future and every field read here: the
        # pair is recorded once, at whichever member resolves first
        # (skipping twins, as the JAX package does, loses a request whose
        # twin won and whose primary finishes after detach(), and records
        # one resolved before attach() whose primary finishes after it)
        fut = req.future
        if fut.done():
            return  # a hedged pair's loser, or a later duplicate
        from ..serve import buckets as _bk

        with self._lock:
            if fut in self._seen:
                return
            self._seen.add(fut)
            if self._t0 is None:
                self._t0 = req.t_submit
            ordinal = len(self._rows)
            self._rows.append({
                "t_offset": round(max(req.t_submit - self._t0, 0.0), 6),
                "routine": req.routine,
                "bucket_shape": [int(req.m), int(req.n), int(req.nrhs)],
                "dtype": _dtype_name(req.A.dtype),
                "tenant": req.tenant,
                "priority": _bk.priority_name(req.priority),
                "deadline_s": (
                    round(req.deadline - req.t_submit, 6)
                    if req.deadline is not None else None
                ),
                "matrix_seed": matrix_seed_for(req.factor_fp, ordinal),
                "rhs_seed": ordinal,
                "repeat_fp": req.factor_fp,
            })

    # -- results -----------------------------------------------------------

    def rows(self) -> List[dict]:
        """Recorded spec rows, submit-time order."""
        with self._lock:
            return sorted(
                (dict(r) for r in self._rows), key=lambda r: r["t_offset"]
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def save(self, path: str) -> str:
        return save(self.rows(), path, source="tap")


def from_ring(items: Optional[List[spans.Span]] = None) -> List[dict]:
    """Spec rows reconstructed from completed ``request`` root spans
    (the ring snapshot by default).  Bucket-label shapes (rounded, not
    raw), no deadlines, no fingerprints -- the tap path records all
    three exactly; this path works on any flight recording after the
    fact."""
    if items is None:
        items = spans.snapshot()
    roots = [
        sp for sp in items
        if sp.kind == "span" and sp.name == "request"
        and sp.attrs.get("routine") and sp.attrs.get("bucket")
    ]
    roots.sort(key=lambda sp: sp.t_start)
    rows: List[dict] = []
    t0 = roots[0].t_start if roots else 0.0
    for ordinal, sp in enumerate(roots):
        # bucket label: <routine>.<m>x<n>x<nrhs>.<dtype>[...]
        parts = str(sp.attrs["bucket"]).split(".")
        if len(parts) < 3:
            continue
        try:
            m, n, nrhs = (int(x) for x in parts[1].split("x"))
        except ValueError:
            continue
        rows.append({
            "t_offset": round(sp.t_start - t0, 6),
            "routine": str(sp.attrs["routine"]),
            "bucket_shape": [m, n, nrhs],
            "dtype": parts[2],
            "tenant": str(sp.attrs.get("tenant", "default")),
            "priority": str(sp.attrs.get("priority", "normal")),
            "deadline_s": None,
            "matrix_seed": matrix_seed_for(None, ordinal),
            "rhs_seed": ordinal,
            "repeat_fp": None,
        })
    return rows


# ---------------------------------------------------------------------------
# spec persistence (JSONL; one meta line + one "load" row per request)
# ---------------------------------------------------------------------------


def save(rows: List[dict], path: str, source: str = "synth") -> str:
    """Write a load spec: a ``spec_meta`` line, then one ``load`` row
    per request in ``t_offset`` order."""
    rows = sorted(rows, key=lambda r: r.get("t_offset", 0.0))
    with open(path, "w") as f:
        f.write(json.dumps({
            "type": "spec_meta", "version": SPEC_VERSION,
            "count": len(rows), "source": source,
            "duration_s": rows[-1]["t_offset"] if rows else 0.0,
        }) + "\n")
        for r in rows:
            f.write(json.dumps({"type": "load", **r}) + "\n")
    return path


def load(path: str) -> List[dict]:
    """Read a load spec back into replayable rows (t_offset order)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            if r.get("type") == "spec_meta":
                v = r.get("version", 0)
                if v > SPEC_VERSION:
                    raise ValueError(
                        f"{path}: spec version {v} is newer than this "
                        f"reader ({SPEC_VERSION})"
                    )
            elif r.get("type") == "load":
                rows.append(r)
    rows.sort(key=lambda r: r.get("t_offset", 0.0))
    return rows


def mix_histogram(rows: List[dict]) -> Dict[str, Dict[str, int]]:
    """Workload-shape histograms of a spec: request counts per tenant,
    per priority, per bucket shape, plus the repeat structure (rows
    per ``repeat_fp`` group).  The round-trip gate compares these
    between the driving spec and the recorded one -- the two must agree
    on the admitted traffic's shape even though individual outcomes
    (shed, deadline-missed) differ run to run."""
    tenants: Dict[str, int] = {}
    prios: Dict[str, int] = {}
    shapes: Dict[str, int] = {}
    repeats: Dict[str, int] = {}
    for r in rows:
        tenants[r["tenant"]] = tenants.get(r["tenant"], 0) + 1
        prios[r["priority"]] = prios.get(r["priority"], 0) + 1
        s = "x".join(str(x) for x in r["bucket_shape"]) + ":" + r["routine"]
        shapes[s] = shapes.get(s, 0) + 1
        fp = r.get("repeat_fp")
        if fp:
            repeats[fp] = repeats.get(fp, 0) + 1
    return {
        "tenants": tenants, "priorities": prios, "shapes": shapes,
        "repeat_groups": repeats,
    }


# re-exported for symmetry with the replay module's materialize()
materialize = _rp.materialize
