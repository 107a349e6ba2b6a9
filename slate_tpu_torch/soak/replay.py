"""Replay engine: drive a recorded or synthesized load spec against a
live ``SolverService`` with open-loop pacing, seeded end to end (the
JAX package's ``soak/replay.py``).

Open loop (the load-testing contract): the pacer sleeps to each row's
``t_offset / speed`` and submits regardless of how many earlier
requests are still in flight -- a service that falls behind builds a
real queue, exactly like production traffic, instead of the
closed-loop coordinated-omission artifact where a slow server
throttles its own load.  ``speed`` scales recorded time (``2.0`` =
twice as fast); a huge speed degenerates to max-rate submission.

Operands regenerate deterministically per row from ``matgen.philox``
(:func:`materialize`, numpy on the host, byte-identical to the JAX
package's): same spec + same ``seed`` -> byte-identical operand
streams, so admission / shed / hedge / quarantine decisions reproduce
within scheduling tolerance across runs.  Rows sharing a
``repeat_fp`` share ``matrix_seed`` and therefore regenerate the SAME
matrix bytes -- the factor cache hits on the replayed stream where it
hit on the recorded one.

Every replay emits the ``soak.*`` counter family the unified verdict
(``tools/soak_report.py``) reconciles::

    soak.submitted == soak.delivered + soak.typed_errors + soak.refused
    serve.requests (admitted) == soak.submitted - soak.refused

plus ``soak.bad_results`` (client-side residual check: a delivered X
that does not solve its system -- the integrity plane's escape
counter, measured from the OUTSIDE) and the ``soak.orphan_spans``
gauge (:func:`orphan_spans`).

Bundled spec generators (deterministic in their seed) synthesize the
workload shapes the serve planes were built for: multitenant burst,
repeated-A factor-cache stream, adversarial flood, deadline storm, and
the traffic step the elastic capacity plane scales through.
"""

from __future__ import annotations

import random
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..aux import metrics, spans
from ..exceptions import SlateError
from ..matgen import philox

#: per-future wait bound -- a hang turns into a loud verdict (the
#: future's TimeoutError propagates), never a wedged gate
DEFAULT_TIMEOUT_S = 300.0

_SEED_MIX = 0x9E3779B1  # Fisher/Knuth multiplicative mix, fits int32 keys


def _mix(seed: int, key: int) -> int:
    return (int(seed) * _SEED_MIX + int(key) * 2654435761 + 1) & 0x7FFFFFFF


def _philox_normal(seed: int, m: int, n: int, dtype, device=None) -> np.ndarray:
    """``philox.random_np("normal", seed, i, j)`` over the m x n grid, in
    one call on the host.  With a ``device``, the integer rounds and the
    exact scaling to uniforms run there (``philox.philox_2x64_torch``)
    and the uniforms come back for the same numpy normal transform: a
    4096 x 4096 A in a fraction of a second instead of seconds.  Each
    element depends on (seed, i, j) alone and both pipelines are exact
    up to the transform, so the bytes are the same either way."""
    dtype = np.dtype(dtype)
    if device is None:
        i, j = np.arange(m)[:, None], np.arange(n)[None, :]
        return philox.random_np("normal", seed, i + 0 * j, j + 0 * i, dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"materialize on a device draws float32 / float64, not {dtype}")
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    b1, b2 = philox.philox_2x64_torch(torch.arange(m, device=device)[:, None],
                                      torch.arange(n, device=device)[None, :], seed)
    f1 = philox._bits_to_unit_torch(b1, tdt).cpu().numpy()
    f2 = philox._bits_to_unit_torch(b2, tdt).cpu().numpy()
    return philox._apply_dist(f1, f2, "normal", dtype.type, np)[0].astype(dtype)


def materialize(row: dict, seed: int = 0, cache: Optional[dict] = None,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic host operands for one spec row.  ``A`` depends only
    on ``(routine, shape, dtype, matrix_seed, seed)`` -- rows sharing a
    ``repeat_fp`` (same ``matrix_seed``) get byte-identical matrices --
    while ``B`` varies per row via ``rhs_seed`` (same-A burst = one
    factor, many right-hand sides).  gesv matrices are made diagonally
    dominant and posv SPD, so every generated system is solvable and a
    delivered X can be residual-checked client-side.  ``cache`` (a
    plain dict the caller owns) memoizes A per matrix seed; ``device``
    draws A's philox bits there (:func:`_philox_normal`: a caller at the
    serve tier's width fills ``cache`` this way before it replays).  The
    bytes are the JAX package's ``materialize``'s, for every routine and
    dtype, with or without a device."""
    m, n, nrhs = (int(x) for x in row["bucket_shape"])
    routine = row["routine"]
    dtype = np.dtype(row.get("dtype", "float64"))
    akey = (routine, m, n, str(dtype), _mix(seed, row["matrix_seed"]))
    A = cache.get(akey) if cache is not None else None
    if A is None:
        G = _philox_normal(akey[-1], m, n, dtype, device)
        if routine == "posv":
            A = G @ G.conj().T + n * np.eye(n, dtype=dtype)
        elif routine == "gesv":
            A = G + n * np.eye(n, dtype=dtype)
        else:  # gels: tall well-conditioned-enough random systems
            A = G
        if cache is not None:
            cache[akey] = A
    bseed = _mix(seed + 1, int(row.get("rhs_seed", row["matrix_seed"])))
    return A, _philox_normal(bseed, m, nrhs, dtype)


#: the client check's bound on a gesv / posv residual over its scale
#: (the JAX package's)
RESIDUAL_TOL = 1e-6


def _residual(routine: str, A: np.ndarray, B: np.ndarray, X: np.ndarray) -> float:
    """The client's own reading of a delivered X (numpy, independent of
    the port's solvers): ``max|AX - B| / (max|A| max|X| + max|B|)``,
    evaluated in float64 for every dtype, so that it reads the solve and
    not the rounding of its own product; ``inf`` for a non-finite X, 0
    for gels (a least-squares residual is not ~0 by construction)."""
    X = np.asarray(X)
    if not np.all(np.isfinite(X)):
        return float("inf")
    if routine not in ("gesv", "posv"):
        return 0.0
    if routine == "posv":
        A = np.tril(A) + np.conj(np.tril(A, -1)).T  # the solved operand
    wide = np.complex128 if np.iscomplexobj(A) or np.iscomplexobj(X) else np.float64
    A, B, X = (np.asarray(v, dtype=wide) for v in (A, B, X))
    scale = np.abs(A).max() * np.abs(X).max() + np.abs(B).max() + 1e-30
    return float(np.abs(A @ X - B).max() / scale)


def _residual_ok(routine: str, A: np.ndarray, B: np.ndarray,
                 X: np.ndarray) -> bool:
    """The JAX package's check: finite, and for gesv / posv a residual
    (:func:`_residual`) within ``RESIDUAL_TOL`` of the scale.  A corrupted element
    (``sdc_solve``: x -> 2x + 1) reads of order one."""
    return _residual(routine, A, B, X) <= RESIDUAL_TOL


def replay(svc, rows: List[dict], speed: float = 1.0, seed: int = 0,
           timeout_s: float = DEFAULT_TIMEOUT_S,
           check_results: bool = True, cache: Optional[dict] = None) -> dict:
    """Drive ``rows`` (t_offset order) against ``svc``; block until
    every submitted future resolves; return the client-side tally.

    The tally's invariant -- ``submitted == delivered + typed_errors +
    refused`` with zero unaccounted futures -- IS the delivery
    completeness the soak verdict gates on; the same counts are
    emitted as ``soak.*`` counters so the verdict works from the
    metrics JSONL alone.  ``cache`` is :func:`materialize`'s: a caller
    that replays several specs over the same matrix pools passes one
    dict (fresh per call by default), so each A is generated once.

    The client checks the delivered X only once every future has
    resolved, so its own numpy work never competes with the service
    inside the window.  ``submit_wall_s`` ends at the last submission,
    ``resolve_wall_s`` at the last resolution (``delivered_per_s`` is
    taken over it), ``wall_s`` after the checks; ``max_residual`` is
    the largest :func:`_residual` of a delivered X."""
    rows = sorted(rows, key=lambda r: r.get("t_offset", 0.0))
    cache = {} if cache is None else cache
    pending = []  # (row, A, B, future, submit time)
    refused = 0
    speed = max(float(speed), 1e-9)
    done_at: Dict[int, float] = {}  # id(future) -> resolution time

    def _stamp(fut) -> None:
        # done-callback, fires AT resolution: client latency must be
        # submit->resolve, not submit->when-the-drain-loop-gets-there
        done_at.setdefault(id(fut), time.monotonic())

    t0 = time.monotonic()
    for row in rows:
        target = t0 + float(row.get("t_offset", 0.0)) / speed
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)  # open loop: pace, never await completions
        A, B = materialize(row, seed=seed, cache=cache)
        metrics.inc("soak.submitted")
        ts = time.monotonic()
        try:
            fut = svc.submit(
                row["routine"], A, B,
                deadline=row.get("deadline_s"),
                tenant=row.get("tenant"),
                priority=row.get("priority"),
            )
        except SlateError:
            # admission refusal (shed / quota / share / invalid): the
            # plane's synchronous no -- counted, never retried (the
            # recorded workload already reflects any client retries)
            metrics.inc("soak.refused")
            refused += 1
            continue
        fut.add_done_callback(_stamp)
        pending.append((row, A, B, fut, ts))
    t_submit_done = time.monotonic()
    delivered = typed = 0
    latencies: List[float] = []
    results = []  # (row, A, B, X) of each delivered request
    t_last = t_submit_done
    for row, A, B, fut, ts in pending:
        try:
            X = fut.result(timeout=timeout_s)
        except SlateError:
            metrics.inc("soak.typed_errors")
            typed += 1
            X = None
        t_done = done_at.get(id(fut), time.monotonic())
        t_last = max(t_last, t_done)
        if X is None:
            continue
        latencies.append(t_done - ts)
        metrics.inc("soak.delivered")
        delivered += 1
        results.append((row, A, B, X))
    bad, worst = 0, 0.0
    if check_results:
        for row, A, B, X in results:
            r = _residual(row["routine"], A, B, X)
            worst = max(worst, r)
            if not r <= RESIDUAL_TOL:
                metrics.inc("soak.bad_results")
                bad += 1
    wall = time.monotonic() - t0
    latencies.sort()

    def pct(p: float) -> Optional[float]:
        if not latencies:
            return None
        k = min(len(latencies) - 1, max(0, int(p / 100.0 * len(latencies))))
        return latencies[k]

    return {
        "submitted": len(rows),
        "delivered": delivered,
        "typed_errors": typed,
        "refused": refused,
        "bad_results": bad,
        "wall_s": round(wall, 3),
        "submit_wall_s": round(t_submit_done - t0, 3),
        "resolve_wall_s": round(t_last - t0, 3),
        "requests_per_s": round(len(rows) / max(wall, 1e-9), 1),
        "delivered_per_s": round(delivered / max(t_last - t0, 1e-9), 3),
        "max_residual": worst,
        "p50_s": pct(50), "p95_s": pct(95), "p99_s": pct(99),
    }


def orphan_spans() -> int:
    """Traces on the span ring with spans but no completed ``request``
    root -- a request whose lifecycle never closed (the hang / leak
    signal the soak verdict requires to be zero).  Size the ring above
    the replayed span count (``spans.on(ring=)``): an evicting ring
    drops old roots and fabricates orphans (``spans.pressure()`` says
    whether it did).  Publishes the count as the ``soak.orphan_spans``
    gauge so the verdict tool can audit it from the dump alone."""
    orphans = 0
    for _tr, sps in spans.by_trace().items():
        if not any(
            sp.name == "request" and sp.t_end is not None for sp in sps
        ):
            orphans += 1
    metrics.gauge("soak.orphan_spans", orphans)
    return orphans


# ---------------------------------------------------------------------------
# synthesized specs (deterministic generators; seeds in, rows out)
# ---------------------------------------------------------------------------


def _arrivals(rng: random.Random, count: int, rate_rps: float) -> List[float]:
    """Poisson arrival offsets (exponential gaps), deterministic in rng."""
    t, out = 0.0, []
    for _ in range(count):
        out.append(round(t, 6))
        t += rng.expovariate(rate_rps)
    return out


def _row(t, routine, n, nrhs, tenant, priority, mseed, rseed,
         deadline_s=None, repeat_fp=None, dtype="float64", m=None):
    return {
        "t_offset": t, "routine": routine,
        "bucket_shape": [m if m is not None else n, n, nrhs],
        "dtype": dtype, "tenant": tenant, "priority": priority,
        "deadline_s": deadline_s, "matrix_seed": mseed & 0x7FFFFFFF,
        "rhs_seed": rseed, "repeat_fp": repeat_fp,
    }


def _seed_of(fp: str) -> int:
    return zlib.crc32(fp.encode("utf-8")) & 0x7FFFFFFF


def gen_multitenant(requests: int = 200, seed: int = 0, *,
                    rate_rps: float = 200.0, n_small: int = 12,
                    n_large: int = 24, nrhs: int = 2,
                    distinct: int = 8) -> List[dict]:
    """A paying tenant's steady small-solve stream interleaved with a
    free tier's heavier, lower-priority traffic (3:1 mix) -- the
    fairness plane's bread and butter.  Each tenant re-solves against
    a pool of ``distinct`` matrices (fresh right-hand sides every
    request), the real multitenant shape -- and the reason the factor
    cache mostly hits instead of paying a direct factorization per
    arrival."""
    rng = random.Random(seed)
    rows = []
    for k, t in enumerate(_arrivals(rng, requests, rate_rps)):
        if k % 4 == 3:
            fp = f"mt-{seed}-free-{k % max(distinct, 1)}"
            rows.append(_row(t, "gesv", n_large, nrhs, "free", "low",
                             _seed_of(fp), k, repeat_fp=fp))
        else:
            rt = "posv" if k % 8 == 1 else "gesv"
            fp = f"mt-{seed}-gold-{rt}-{k % max(distinct, 1)}"
            rows.append(_row(t, rt, n_small, nrhs, "gold", "high",
                             _seed_of(fp), k, repeat_fp=fp))
    return rows


def gen_repeated_a(requests: int = 200, seed: int = 0, *,
                   rate_rps: float = 300.0, n: int = 12, nrhs: int = 2,
                   distinct: int = 4, routine: str = "gesv") -> List[dict]:
    """Factor-once solve-many: ``distinct`` matrices, each arriving as
    a consecutive burst of fresh right-hand sides (rows in a burst
    share ``repeat_fp`` and hence matrix bytes at replay) -- the factor
    cache must hit on everything after each burst's head."""
    rng = random.Random(seed)
    rows = []
    per = max(1, requests // max(distinct, 1))
    ts = _arrivals(rng, requests, rate_rps)
    for k in range(requests):
        g = min(k // per, distinct - 1)
        fp = f"synthA-{seed}-{g}"
        rows.append(_row(ts[k], routine, n, nrhs, "gold", "normal",
                         _seed_of(fp), k, repeat_fp=fp))
    return rows


def gen_adversarial_flood(requests: int = 200, seed: int = 0, *,
                          rate_rps: float = 150.0, n_flood: int = 24,
                          n_victim: int = 12, nrhs: int = 2,
                          flood_frac: float = 0.6,
                          distinct: int = 4) -> List[dict]:
    """One abusive tenant floods in tight bursts while a well-behaved
    tenant keeps a steady stream -- the shed / quota path under real
    pressure.  Flood rows arrive in near-zero-gap clumps; both sides
    draw from ``distinct``-matrix pools (an abuser hammering the same
    few problems is the canonical flood)."""
    rng = random.Random(seed)
    n_fl = int(requests * flood_frac)
    rows = []
    t = 0.0
    k = 0
    while k < n_fl:
        clump = min(8, n_fl - k)
        for c in range(clump):
            fp = f"fl-{seed}-ab-{(k + c) % max(distinct, 1)}"
            rows.append(_row(round(t + c * 1e-4, 6), "gesv", n_flood, nrhs,
                             "abuser", "low", _seed_of(fp), k + c,
                             repeat_fp=fp))
        k += clump
        t += rng.expovariate(rate_rps / 8.0)
    for i, t in enumerate(_arrivals(rng, requests - n_fl, rate_rps / 2.0)):
        fp = f"fl-{seed}-good-{i % max(distinct, 1)}"
        rows.append(_row(t, "gesv", n_victim, nrhs, "good", "high",
                         _seed_of(fp), n_fl + i, repeat_fp=fp))
    rows.sort(key=lambda r: r["t_offset"])
    return rows


def gen_deadline_storm(requests: int = 100, seed: int = 0, *,
                       rate_rps: float = 200.0, n: int = 12,
                       nrhs: int = 2, tight_s: float = 0.002,
                       slack_s: float = 5.0) -> List[dict]:
    """Deadline-carrying traffic where a third of the deadlines are
    near-infeasible -- the slo-burn tiers and queued / late miss split
    must account for every one of them."""
    rng = random.Random(seed)
    rows = []
    for k, t in enumerate(_arrivals(rng, requests, rate_rps)):
        dl = tight_s if k % 3 == 0 else slack_s
        fp = f"ds-{seed}-{k % 4}"
        rows.append(_row(t, "gesv", n, nrhs, "gold", "normal",
                         _seed_of(fp), k, deadline_s=dl, repeat_fp=fp))
    return rows


def gen_burst(requests: int = 300, seed: int = 0, *,
              base_rps: float = 40.0, burst_rps: float = 400.0,
              burst_start_s: float = 1.0, burst_len_s: float = 1.5,
              n: int = 12, nrhs: int = 2, distinct: int = 4,
              routine: str = "gesv") -> List[dict]:
    """A quiet baseline stream with one hard traffic step in the
    middle -- the elastic capacity plane's canonical input
    (:mod:`slate_tpu_torch.scale`).  Arrivals run at ``base_rps`` until
    ``burst_start_s``, jump to ``burst_rps`` for ``burst_len_s``, then
    fall back to ``base_rps`` until the request budget is spent.  A
    static fleet sized for the baseline builds queue (and misses its
    tail budget) inside the burst; an elastic fleet must scale up
    through it and give the lanes back after.

    Rows draw from a ``distinct``-matrix pool with fresh right-hand
    sides (bursts of same-A traffic, the factor cache's steady state),
    so burst latency measures dispatch capacity, not factorization."""
    rng = random.Random(seed)
    rows = []
    t = 0.0
    for k in range(requests):
        in_burst = burst_start_s <= t < burst_start_s + burst_len_s
        rate = burst_rps if in_burst else base_rps
        fp = f"burst-{seed}-{k % max(distinct, 1)}"
        rows.append(_row(round(t, 6), routine, n, nrhs, "gold", "normal",
                         _seed_of(fp), k, repeat_fp=fp))
        t += rng.expovariate(rate)
    return rows


def warm_spec(rows: List[dict], gap_s: float = 0.025) -> List[dict]:
    """A pool-warming prelude for ``rows``: the first row of every
    ``repeat_fp`` group, re-paced serially ``gap_s`` apart.  Replaying
    it (same ``seed``!) before the measured phase factors each pool
    matrix once, so the soak measures the steady state the factor
    cache was built for instead of a cold-start miss storm -- the exact
    analogue of ``warmup()`` for executables.  Deadlines are stripped
    (a warm pass must populate, not shed)."""
    seen: set = set()
    out = []
    for r in sorted(rows, key=lambda r: r.get("t_offset", 0.0)):
        fp = r.get("repeat_fp")
        if not fp or fp in seen:
            continue
        seen.add(fp)
        w = dict(r)
        w["t_offset"] = round(len(out) * gap_s, 6)
        w["deadline_s"] = None
        out.append(w)
    return out


def merge_specs(*specs: List[dict]) -> List[dict]:
    """Overlay several generated streams onto one shared timeline
    (rows keep their offsets; the result is sorted)."""
    out: List[dict] = []
    for s in specs:
        out.extend(dict(r) for r in s)
    out.sort(key=lambda r: r.get("t_offset", 0.0))
    return out


GENERATORS: Dict[str, object] = {
    "multitenant": gen_multitenant,
    "repeated_a": gen_repeated_a,
    "adversarial_flood": gen_adversarial_flood,
    "deadline_storm": gen_deadline_storm,
    "burst": gen_burst,
}
