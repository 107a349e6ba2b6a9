"""Predictive warmup (the JAX package's ``scale/warmup_plan.py``): a
recorded workload trace replayed *offline* into a ranked warmup plan,
replacing "warm whatever was seen".

The cold-start story warms the whole manifest (``restore()``) or
whatever an operator hand-listed.  Both ignore what the traffic
actually was.  This module folds a recorded load spec
(:mod:`slate_tpu_torch.soak.record` JSONL rows) into a
:class:`WarmupPlan` -- the (bucket, batch) entries worth priming, ranked
by traffic-weighted build cost::

    score = traffic_share x compile_cost

so the cores that would hurt most to build under live load (hot AND
expensive) prime first, and a budget (``top(k)``, or a scale-up lane's
priming deadline) truncates from the bottom.  The model mirrors what the
serve tier would really dispatch:

* rows bucket through the same ``bucket_for`` lattice the service uses
  (same floors, schedule, precision);
* a bucket whose arrivals burst back-to-back gets its coalesced batch
  point planned alongside batch 1;
* repeat-``repeat_fp`` groups (the factor cache's hit population) plan
  the ``phase="solve"`` sibling too -- on a warm cache the hits dispatch
  the trsm-only family;
* the same repeat groups rank the factor-cache *preload*: biggest
  (group_size - 1) x factor-cost first.

Build cost comes from the executable cache's captured cost rows when
present (``cache.cost()``: devmon's measured first run) and falls back
to the ``phase_flops`` model, so planning works on a bare trace with no
cache at all.  Everything is deterministic: same rows in, same plan out.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..serve import buckets as _bk
from ..serve.buckets import BucketKey

PLAN_VERSION = 1


@dataclass(frozen=True)
class PlanEntry:
    """One (bucket, batch) core worth priming."""

    key: BucketKey
    batch: int
    rows: int  # trace rows that would dispatch this bucket
    share: float  # rows / total_rows
    cost: float  # build-cost estimate (model FLOPs or captured)
    score: float  # share x cost -- the ranking unit

    def to_json(self) -> dict:
        return {"key": self.key.to_json(), "batch": self.batch, "rows": self.rows,
                "share": self.share, "cost": self.cost, "score": self.score}


@dataclass(frozen=True)
class FactorPreload:
    """One repeat-A group worth pre-factoring into the cache."""

    repeat_fp: str
    rows: int  # group size in the trace
    n: int
    score: float  # (rows - 1) x factor flops -- the hits it would buy

    def to_json(self) -> dict:
        return {"repeat_fp": self.repeat_fp, "rows": self.rows, "n": self.n,
                "score": self.score}


@dataclass
class WarmupPlan:
    """Ranked warmup manifest subset + factor-cache preload."""

    entries: List[PlanEntry]  # score-descending
    preload: List[FactorPreload]  # score-descending
    total_rows: int

    def top(self, k: int) -> List[PlanEntry]:
        return self.entries[: max(int(k), 0)]

    def pairs(self, k: Optional[int] = None) -> List[Tuple[BucketKey, int]]:
        """The (key, batch) list ``ExecutableCache.prime`` consumes, in
        plan order."""
        ents = self.entries if k is None else self.top(k)
        return [(e.key, e.batch) for e in ents]

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(json.dumps({"type": "plan_meta", "version": PLAN_VERSION,
                                "total_rows": self.total_rows,
                                "entries": len(self.entries),
                                "preload": len(self.preload)}) + "\n")
            for e in self.entries:
                f.write(json.dumps({"type": "entry", **e.to_json()}) + "\n")
            for p in self.preload:
                f.write(json.dumps({"type": "preload", **p.to_json()}) + "\n")
        return path

    @staticmethod
    def load(path: str) -> "WarmupPlan":
        entries: List[PlanEntry] = []
        preload: List[FactorPreload] = []
        total = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                r = json.loads(line)
                t = r.get("type")
                if t == "plan_meta":
                    v = r.get("version", 0)
                    if v > PLAN_VERSION:
                        raise ValueError(f"{path}: plan version {v} is newer than this "
                                         f"reader ({PLAN_VERSION})")
                    total = int(r.get("total_rows", 0))
                elif t == "entry":
                    entries.append(PlanEntry(
                        key=BucketKey.from_json(r["key"]), batch=int(r["batch"]),
                        rows=int(r["rows"]), share=float(r["share"]),
                        cost=float(r["cost"]), score=float(r["score"])))
                elif t == "preload":
                    preload.append(FactorPreload(
                        repeat_fp=str(r["repeat_fp"]), rows=int(r["rows"]), n=int(r["n"]),
                        score=float(r["score"])))
        return WarmupPlan(entries=entries, preload=preload, total_rows=total)


def _burst_batch(offsets: List[float], batch_max: int, window_s: float) -> int:
    """Largest same-bucket arrival burst within one coalescing window --
    the batch point the service would actually dispatch."""
    best = 1
    start = 0
    for i in range(1, len(offsets)):
        while offsets[i] - offsets[start] > window_s:
            start += 1
        best = max(best, i - start + 1)
    return min(best, max(int(batch_max), 1))


def plan_from_trace(rows: List[dict], cache=None, batch_max: int = 8,
                    batch_window_s: float = 0.005, dim_floor: int = _bk.DIM_FLOOR,
                    nrhs_floor: int = _bk.NRHS_FLOOR, schedule: str = "auto",
                    precision: str = "full") -> WarmupPlan:
    """Fold recorded load-spec rows into a ranked :class:`WarmupPlan`.

    ``rows`` is the :mod:`soak.record` schema (``record.load()`` output,
    a live :class:`~slate_tpu_torch.soak.record.Recorder`'s rows, or a
    ``from_ring()`` reconstruction).  ``cache`` (optional) supplies
    captured costs; without it the ``phase_flops`` model ranks alone."""
    total = len(rows)
    # bucket the trace through the service's own lattice
    counts: Dict[Tuple[BucketKey, str], int] = {}
    offsets: Dict[BucketKey, List[float]] = {}
    repeats: Dict[str, dict] = {}
    for r in rows:
        m, n, nrhs = (int(x) for x in r["bucket_shape"])
        key = _bk.bucket_for(r["routine"], m, n, nrhs, r.get("dtype", "float64"),
                             floor=dim_floor, nrhs_floor=nrhs_floor, schedule=schedule,
                             precision=precision)
        counts[(key, "full")] = counts.get((key, "full"), 0) + 1
        offsets.setdefault(key, []).append(float(r.get("t_offset", 0.0)))
        fp = r.get("repeat_fp")
        if fp:
            g = repeats.setdefault(fp, {"rows": 0, "n": key.n, "key": key})
            g["rows"] += 1
    # repeat groups of >= 2 hit the factor cache at replay: their traffic
    # dispatches the solve-phase sibling, so plan it too
    for g in repeats.values():
        if g["rows"] < 2:
            continue
        key = g["key"]
        sib = key.solve_sibling()
        counts[(sib, "solve")] = counts.get((sib, "solve"), 0) + int(g["rows"]) - 1
        offsets.setdefault(sib, offsets.get(key, []))
    entries: List[PlanEntry] = []
    for (key, _phase), cnt in counts.items():
        share = cnt / total if total else 0.0
        batches = {1}
        b = _burst_batch(sorted(offsets.get(key, [])), batch_max, batch_window_s)
        if b > 1:
            batches.add(b)
        for batch in sorted(batches):
            cost = _compile_cost(cache, key, batch)
            entries.append(PlanEntry(key=key, batch=batch, rows=cnt, share=round(share, 6),
                                     cost=cost, score=round(share * cost, 3)))
    # rank: score desc, then label/batch for a deterministic tiebreak
    entries.sort(key=lambda e: (-e.score, e.key.label, e.batch))
    preload = [
        FactorPreload(repeat_fp=fp, rows=int(g["rows"]), n=int(g["n"]),
                      score=round((g["rows"] - 1) * _factor_flops(g["key"]), 3))
        for fp, g in repeats.items() if g["rows"] >= 2
    ]
    preload.sort(key=lambda p: (-p.score, p.repeat_fp))
    return WarmupPlan(entries=entries, preload=preload, total_rows=total)


def _compile_cost(cache, key: BucketKey, batch: int) -> float:
    """The captured cost row's FLOPs when the cache has one, model FLOPs
    otherwise -- one consistent unit (FLOPs) either way."""
    if cache is not None:
        rec = cache.cost(key, batch)
        if rec:
            fl = rec.get("flops") or rec.get("flops_model")
            if fl:
                return float(fl)
    return _bk.phase_flops(key, batch)


def _factor_flops(key: BucketKey) -> float:
    """The factorization-only share of one full dispatch -- what a cache
    hit saves."""
    return max(_bk.phase_flops(key, 1) - _bk.phase_flops(key.solve_sibling(), 1), 0.0)
