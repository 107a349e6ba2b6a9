"""Canonical shape/dtype bucketing for the serving layer (this
package's copy of the JAX package's ``serve/buckets.py``: every
function, the manifest text and the BucketKey JSON are the same, so
each package loads the other's manifests).

Unbounded user shapes must map onto a BOUNDED executable set, or every
new (m, n, nrhs) pays a cold build (here: the first run of a bucket's
closure on its device, which loads the kernel library and warms the
library handles and the caching allocator).  The scheme is the
halving-bucket rule of the eigensolvers' ``_size_bucket_runs``: a size h is
assigned the smallest S = total / 2^m that still covers it, floored so
tiny sizes don't multiply compiled bodies.  For serving there is no
fixed ``total`` — buckets double up from ``floor`` instead, which is the
same lattice (``halving_bucket(h, total=2^k floor, floor)`` for k large
enough), so a dimension n lands on the unique power-of-two multiple of
``floor`` covering it.

Requests are padded up to their bucket and results cropped back:

* square systems (gesv/posv): A sits in the top-left corner and the
  trailing diagonal block is the identity, so the padded system is
  block-diagonal ``[[A, 0], [0, I]]`` — partial pivoting never selects a
  pad row for a real column (those entries are 0), Cholesky of the pad
  block is the identity, and the cropped solution equals the direct one.
* least squares (gels, m >= n): zero pad rows plus unit columns
  ``A_pad[m+i, n+i] = 1`` keep full column rank; the pad columns have
  support only in pad rows where B is zero, so the cropped X is the
  original LS solution.  ``bucket_mn`` bumps the row bucket when the
  column padding would not fit below the real rows.
* right-hand sides: zero columns, cropped back exactly.

This module is pure (stdlib + numpy only, no torch, no driver imports),
so any layer can share ``size_bucket_runs`` without an import cycle
through the lazy ``serve`` package.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

DIM_FLOOR = 64
NRHS_FLOOR = 8

#: default size-routing threshold for the sharded serving tier: a
#: request with n >= this routes to the spmd submesh when one is
#: configured.  Defined HERE (the one import-pure serving module) so
#: Option.ServeShardThreshold (options.py) and a directly-constructed
#: PlacementPolicy share one value instead of two drifting literals.
DEFAULT_SHARD_THRESHOLD = 2048

#: accepted BucketKey.precision values (the single source of truth —
#: SolverService validates the service-wide setting and per-submit
#: overrides against this same check)
PRECISIONS = ("full", "mixed")

#: accepted BucketKey.phase values: "full" runs the whole factor+solve
#: pipeline; "solve" is the solve-only family the factor cache
#: dispatches on a hit (gesv: pre-permuted rows + two trsm sweeps,
#: posv: two trsm sweeps, gels: blocked Q^H apply from the packed
#: compact-WY factor + one trsm) — O(n^2 nrhs) / O(m n nrhs) against
#: the full phase's O(n^3) / O(m n^2)
PHASES = ("full", "solve")

#: request priority classes at admission (serve/admission.py), highest
#: first: under sustained SLO burn the overload controller sheds
#: lowest-priority-first — "low" is shed at level 1, "normal" joins it
#: at level 2, "high" is never shed (only bounded-queue / quota
#: Rejected can refuse it).  Defined HERE (the import-pure serving
#: module) so the admission plane, the service and the error context
#: share one ordering.
PRIORITIES = ("high", "normal", "low")
PRIO_HIGH, PRIO_NORMAL, PRIO_LOW = 0, 1, 2

#: tenant id of requests submitted without one — the anonymous pool
DEFAULT_TENANT = "default"


def check_priority(priority) -> int:
    """Normalize a priority ("high"|"normal"|"low", or its index) to
    the integer class; raises on anything else."""
    if isinstance(priority, str):
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r} ({'|'.join(PRIORITIES)})"
            )
        return PRIORITIES.index(priority)
    p = int(priority)
    if not 0 <= p < len(PRIORITIES):
        raise ValueError(
            f"priority index out of range: {p} (0..{len(PRIORITIES) - 1})"
        )
    return p


def priority_name(level: int) -> str:
    """The class name of a priority index (error context / reports)."""
    return PRIORITIES[check_priority(level)]


def check_precision(precision: str) -> str:
    """Validate a serving-precision string; returns it unchanged."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown serving precision {precision!r} "
            f"({'|'.join(PRECISIONS)})"
        )
    return precision


def check_phase(phase: str) -> str:
    """Validate a serving-phase string; returns it unchanged."""
    if phase not in PHASES:
        raise ValueError(
            f"unknown serving phase {phase!r} ({'|'.join(PHASES)})"
        )
    return phase


def parse_mesh(mesh: str) -> Tuple[int, int]:
    """Parse a mesh-shape string ``"PxQ"`` into (p, q); ``""`` (the
    single-device placement) parses to (0, 0).  The grammar lives here
    (pure, no torch) so BucketKey validation, the placement policy, and
    the warmup/restore mesh filters all share one parser."""
    if not mesh:
        return (0, 0)
    parts = str(mesh).lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"bad mesh shape {mesh!r} (want 'PxQ', e.g. '2x4')")
    try:
        p, q = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"bad mesh shape {mesh!r} (want 'PxQ', e.g. '2x4')"
        ) from None
    if p <= 0 or q <= 0:
        raise ValueError(f"mesh dims must be positive, got {mesh!r}")
    return p, q


def check_mesh(mesh: str) -> str:
    """Validate a BucketKey mesh string; returns it canonicalized
    (``""`` for single-device, ``"PxQ"`` otherwise)."""
    p, q = parse_mesh(mesh)
    return "" if p == 0 else f"{p}x{q}"


def mesh_fits(mesh: str, device_count: int) -> bool:
    """True when a mesh-shape string is realizable with ``device_count``
    devices — the warmup/restore filter: a replica warms only the
    manifest entries its own mesh can run (a 2x4 entry on a 1-device
    box is skipped, not crashed on)."""
    p, q = parse_mesh(mesh)
    return p * q <= max(int(device_count), 0)


def halving_bucket(h: int, total: int, floor: int = 1) -> int:
    """Smallest S = total / 2^m with S >= h, floored at min(floor, total)
    (the drivers' bucket rule: for total=6144, h=2500 buckets to 3072,
    not pow2ceil's 4096)."""
    S = total
    while S // 2 >= max(h, 1) and S // 2 >= min(floor, total):
        S //= 2
    return S


def size_bucket_runs(
    heights: Sequence[int], total: int, floor: int = 1024
) -> Iterator[Tuple[int, int, int]]:
    """Group consecutive indices into runs of equal ``halving_bucket``
    size: yields (i0, i1, S) with every height in [i0, i1) <= S.  The
    canonical implementation behind the eigensolvers' ``_size_bucket_runs``."""
    sizes = [halving_bucket(h, total, floor) for h in heights]
    i0 = 0
    while i0 < len(sizes):
        i1 = i0
        while i1 < len(sizes) and sizes[i1] == sizes[i0]:
            i1 += 1
        yield i0, i1, sizes[i0]
        i0 = i1


def bucket_dim(n: int, floor: int = DIM_FLOOR) -> int:
    """Bucket one dimension: the power-of-two multiple of ``floor``
    covering n (the doubling view of the halving lattice)."""
    if n <= 0:
        raise ValueError(f"dimension must be positive, got {n}")
    S = floor
    while S < n:
        S *= 2
    return S


def bucket_mn(m: int, n: int, floor: int = DIM_FLOOR) -> Tuple[int, int]:
    """Bucket a tall (m >= n) shape so the gels unit pad columns fit:
    needs Mb - m >= Nb - n (each pad column carries a 1 in its own pad
    row)."""
    Nb = bucket_dim(n, floor)
    Mb = bucket_dim(m, floor)
    if Mb - m < Nb - n:
        Mb = bucket_dim(m + (Nb - n), floor)
    return Mb, Nb


@dataclass(frozen=True)
class BucketKey:
    """Identity of one compiled executable: (routine, bucket shape,
    dtype, nb, options tag, schedule).  Hashable cache key, JSON
    round-trippable for the warmup manifest.

    ``schedule`` is the factorization schedule the executable's drivers
    were traced with (Option.Schedule: auto|flat|recursive) — a
    first-class key component so a warmup manifest captured from a
    recursive-schedule deployment precompiles the recursion shapes, not
    the flat ones.  The recursion's halving splits land exactly on this
    module's bucket lattice, so one warmed bucket covers every shape
    the recursive factor touches.

    ``precision`` selects the solve path the executable was traced
    with: ``"full"`` (the direct drivers — the legacy default, so old
    manifests round-trip unchanged) or ``"mixed"`` (low-precision
    factor + device-resident iterative refinement,
    ``drivers/mixed.serve_mixed_core``).  A warmed mixed bucket solves
    at low-precision rates; non-converged items surface as
    non-finite X, which the service re-solves on the full-precision
    direct path while the bucket's circuit breaker demotes persistent
    offenders.

    ``mesh`` is the *placement* of the executable: ``""`` (the legacy
    default, so old manifests round-trip unchanged) means one device —
    the data-parallel replicated case — while ``"PxQ"`` means the
    executable runs the distributed drivers on a P x Q submesh (the
    JAX package routes large-n or explicitly-sharded requests there;
    this package's placement has no mesh yet and raises for one).  A
    first-class key field: the same bucket shape on different mesh
    shapes is a different program, so manifests warm per mesh shape.

    ``phase`` selects how much of the pipeline the executable runs:
    ``"full"`` (factor + solve — the legacy default, so old manifests
    round-trip unchanged) or ``"solve"`` (trsm-only: the cheap family
    the factor cache dispatches on a hit, taking the *factor* as its
    first operand — gesv rides pre-permuted rows + two trsm sweeps,
    posv two trsm sweeps).  A first-class key field: the solve-phase
    executable is a different program over the same bucket shape, so
    manifests warm it separately and its artifact fingerprint never
    collides with the full-phase sibling's."""

    routine: str
    m: int  # row bucket
    n: int  # column bucket
    nrhs: int  # rhs bucket
    dtype: str  # canonical numpy name, e.g. "float64"
    nb: int  # tile size the executable was built with
    tag: str = ""  # options fingerprint (empty = defaults)
    schedule: str = "auto"  # factorization schedule (Option.Schedule)
    precision: str = "full"  # solve path: full | mixed
    mesh: str = ""  # placement: "" = single device | "PxQ" spmd submesh
    phase: str = "full"  # pipeline slice: full (factor+solve) | solve

    @property
    def label(self) -> str:
        """Metric-name fragment: serve.<routine>.<label>.b<batch>.run"""
        return (
            f"{self.routine}.{self.m}x{self.n}x{self.nrhs}.{self.dtype}"
            + (f".{self.tag}" if self.tag else "")
            + (f".{self.schedule}" if self.schedule != "auto" else "")
            + (f".{self.precision}" if self.precision != "full" else "")
            + (f".mesh{self.mesh}" if self.mesh else "")
            + (f".{self.phase}" if self.phase != "full" else "")
        )

    def to_json(self) -> dict:
        return {
            "routine": self.routine, "m": self.m, "n": self.n,
            "nrhs": self.nrhs, "dtype": self.dtype, "nb": self.nb,
            "tag": self.tag, "schedule": self.schedule,
            "precision": self.precision, "mesh": self.mesh,
            "phase": self.phase,
        }

    @staticmethod
    def from_json(d: dict) -> "BucketKey":
        return BucketKey(
            routine=str(d["routine"]), m=int(d["m"]), n=int(d["n"]),
            nrhs=int(d["nrhs"]), dtype=str(d["dtype"]), nb=int(d["nb"]),
            tag=str(d.get("tag", "")),
            schedule=str(d.get("schedule", "auto")),
            precision=str(d.get("precision", "full")),
            mesh=check_mesh(str(d.get("mesh", ""))),
            phase=check_phase(str(d.get("phase", "full"))),
        )

    def solve_sibling(self) -> "BucketKey":
        """The trsm-only (phase="solve") twin of a full-phase bucket —
        the executable the factor cache dispatches on a hit."""
        import dataclasses

        return dataclasses.replace(self, phase="solve")


# ---------------------------------------------------------------------------
# circuit breaker (per-BucketKey batched-path state; service.py drives it)
# ---------------------------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclass
class Breaker:
    """Circuit-breaker state for one bucket's batched path.

    Lifecycle (SolverService drives the transitions, keyed by
    BucketKey):  ``closed`` --degrade_after consecutive failures-->
    ``open`` (requests route to the direct driver) --cooldown
    elapsed--> ``half_open`` (the next batch is a probe through the
    batched path) --probe success--> ``closed`` / --probe failure-->
    ``open`` with a fresh cooldown.  Unlike the permanent degradation
    it replaces, an open breaker is a *recoverable* state: one healthy
    probe restores batching.
    """

    state: str = BREAKER_CLOSED
    streak: int = 0  # consecutive batched-path failures
    opened_at: float = 0.0  # monotonic time of the last open transition
    opens: int = 0  # lifetime open transitions (health reporting)

    def record_failure(self, now: float, degrade_after: int) -> bool:
        """One batched-path failure; returns True when this failure
        opens the breaker (half-open probes reopen immediately)."""
        self.streak += 1
        if self.state == BREAKER_HALF_OPEN or (
            self.state == BREAKER_CLOSED and self.streak >= degrade_after
        ):
            self.state = BREAKER_OPEN
            self.opened_at = now
            self.opens += 1
            return True
        return False

    def record_success(self) -> bool:
        """One batched-path success; returns True when it closed a
        half-open breaker (the recovery transition)."""
        was_probe = self.state == BREAKER_HALF_OPEN
        self.state = BREAKER_CLOSED
        self.streak = 0
        return was_probe

    def cooling_down(self, now: float, cooldown_s: float) -> bool:
        """True while this breaker is OPEN and its cooldown has not yet
        elapsed — the ONE definition of the cooldown window, shared by
        :meth:`try_half_open` and the service's admission-side replica
        exclusion (an excluded lane must become selectable the moment
        a probe could fire, or it would stay open forever)."""
        return self.state == BREAKER_OPEN and now - self.opened_at < cooldown_s

    def try_half_open(self, now: float, cooldown_s: float) -> bool:
        """Move an open breaker whose cooldown has elapsed to
        half-open; returns True on that transition."""
        if self.state == BREAKER_OPEN and not self.cooling_down(
            now, cooldown_s
        ):
            self.state = BREAKER_HALF_OPEN
            return True
        return False


def _serve_nb(S: int) -> int:
    """Tile size for a serving executable: one tile up to
    64, then the drivers' blocked paths take over."""
    return min(64, S)


def bucket_for(
    routine: str,
    m: int,
    n: int,
    nrhs: int,
    dtype,
    floor: int = DIM_FLOOR,
    nrhs_floor: int = NRHS_FLOOR,
    tag: str = "",
    schedule: str = "auto",
    precision: str = "full",
    mesh: str = "",
    phase: str = "full",
) -> BucketKey:
    """Map one request onto its BucketKey.  gesv/posv are square
    (m == n); gels buckets rows and columns independently (m >= n —
    underdetermined systems are served by the direct path, see api).
    ``schedule`` keys the executable by factorization schedule;
    ``precision`` by solve path (full | mixed — mixed is a square-solve
    feature: gels has no low-precision-factor refinement analogue
    here, so it stays on the full path).  ``mesh`` keys the executable
    by placement: ``"PxQ"`` routes it through the spmd drivers on that
    submesh (gesv/posv full-precision only — the sharded solvers have
    no mixed or least-squares trace; serve/placement enforces the
    routing policy, this validates the combination).  ``phase`` keys
    the pipeline slice: the ``"solve"`` (solve-only) family exists for
    gesv/posv/gels at full precision on a single device only — the
    factor cache owns the factor, the mesh and mixed tiers have no
    factor-reuse trace."""
    check_precision(precision)
    check_phase(phase)
    mesh = check_mesh(mesh)
    if phase != "full" and (
        routine not in ("gesv", "posv", "gels")
        or precision != "full" or mesh
    ):
        raise ValueError(
            "solve-phase buckets exist for single-device full-precision "
            f"gesv/posv/gels only (routine={routine!r}, "
            f"precision={precision!r}, mesh={mesh!r})"
        )
    dt = np.dtype(dtype).name
    rb = bucket_dim(nrhs, nrhs_floor)
    if routine in ("gesv", "posv"):
        if m != n:
            raise ValueError(f"{routine} requires square A, got {m}x{n}")
        if mesh and precision != "full":
            raise ValueError(
                "sharded serving is full-precision only "
                f"(mesh={mesh!r}, precision={precision!r})"
            )
        S = bucket_dim(n, floor)
        return BucketKey(
            routine, S, S, rb, dt, _serve_nb(S), tag, schedule, precision,
            mesh, phase,
        )
    if routine == "gels":
        if m < n:
            raise ValueError("gels serving path requires m >= n")
        if mesh:
            raise ValueError("gels has no sharded serving path")
        Mb, Nb = bucket_mn(m, n, floor)
        return BucketKey(
            routine, Mb, Nb, rb, dt, _serve_nb(Nb), tag, schedule, "full",
            "", phase,
        )
    raise ValueError(f"unknown serving routine: {routine!r}")


def gels_pack_kt(key: BucketKey) -> int:
    """Number of compact-WY T panels in a gels solve-phase factor pack
    (one per nb-wide column panel of the padded (Mb, Nb) global)."""
    return -(-key.n // key.nb)


def solve_factor_shape(key: BucketKey) -> Tuple[int, int]:
    """Shape of the solve-phase executable's (unbatched) factor
    operand.  gesv/posv: the (Mb, Nb) bucket-padded factor global.
    gels: the packed QR representation — V/R in rows [0, Mb), then the
    kt compact-WY T panels flattened below (panel k's (w, w) T lands
    in rows [Mb + k*nb, Mb + k*nb + w), cols [0, w)), so one array
    carries everything the Q^H apply + trsm needs and a hit dispatches
    with no host-side reassembly."""
    if key.routine == "gels":
        return (key.m + gels_pack_kt(key) * key.nb, key.n)
    return (key.m, key.n)


def batch_bucket(count: int, batch_max: int) -> int:
    """Two batch points per key — 1 (lone request) and batch_max
    (coalesced) — so steady state touches exactly the executables
    warmup compiled, regardless of arrival timing."""
    return 1 if count <= 1 else batch_max


# ---------------------------------------------------------------------------
# pad / crop
# ---------------------------------------------------------------------------


def pad_square(A: np.ndarray, S: int) -> np.ndarray:
    """Top-left embed with identity trailing block (gesv/posv)."""
    n = A.shape[0]
    out = np.zeros((S, S), dtype=A.dtype)
    out[:n, :n] = A
    if S > n:
        idx = np.arange(n, S)
        out[idx, idx] = 1
    return out


def pad_tall(A: np.ndarray, Mb: int, Nb: int) -> np.ndarray:
    """Zero row pad + unit pad columns in pad rows (gels, m >= n)."""
    m, n = A.shape
    out = np.zeros((Mb, Nb), dtype=A.dtype)
    out[:m, :n] = A
    for i in range(Nb - n):
        out[m + i, n + i] = 1
    return out


def pad_rhs(B: np.ndarray, rows: int, nrhs_b: int) -> np.ndarray:
    out = np.zeros((rows, nrhs_b), dtype=B.dtype)
    out[: B.shape[0], : B.shape[1]] = B
    return out


def pad_request(key: BucketKey, A: np.ndarray, B: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad one request's (A, B) to the key's bucket shapes."""
    if key.routine == "gels":
        return pad_tall(A, key.m, key.n), pad_rhs(B, key.m, key.nrhs)
    return pad_square(A, key.n), pad_rhs(B, key.n, key.nrhs)


def crop_result(key: BucketKey, X: np.ndarray, n: int, nrhs: int) -> np.ndarray:
    """Crop a padded solution back to the request's true (n, nrhs)."""
    return X[:n, :nrhs]


def pad_waste(key: BucketKey, m: int, n: int, nrhs: int) -> int:
    """Padded-minus-true element count of one request's operands (the
    ``serve.bucket_pad_waste`` counter unit)."""
    true = m * n + m * nrhs
    padded = key.m * key.n + key.m * key.nrhs
    return max(padded - true, 0)


def phase_flops(key: BucketKey, batch: int = 1) -> float:
    """Model FLOPs of one dispatch of this bucket's executable — the
    schedule-accounting mirror behind the factor cache's ≤ 10%
    acceptance criterion (the solve-only family must cost an order
    less than its full-phase sibling).  Full phase: the factorization
    (gesv 2/3 n^3, posv 1/3 n^3) plus the two trsm sweeps; solve
    phase: the trsm sweeps alone (2 n^2 nrhs — the row permute is a
    gather, FLOP-free), or for gels the blocked Q^H apply from the
    packed compact-WY factor (~4 m n nrhs) plus one trsm.  Per-item,
    times the batch point."""
    n, r = float(key.n), float(key.nrhs)
    solve = 2.0 * n * n * r
    if key.phase == "solve":
        if key.routine == "gels":
            return batch * (4.0 * float(key.m) * n * r + n * n * r)
        return batch * solve
    if key.routine == "gesv":
        return batch * (2.0 / 3.0 * n**3 + solve)
    if key.routine == "posv":
        return batch * (1.0 / 3.0 * n**3 + solve)
    # gels: QR factor + apply + triangular solve (m >= n)
    m = float(key.m)
    return batch * (2.0 * m * n * n - 2.0 / 3.0 * n**3 + 2.0 * m * n * r)


# ---------------------------------------------------------------------------
# fingerprinting (the durable-artifact identity)
# ---------------------------------------------------------------------------


def content_fields(key: BucketKey, batch: int) -> dict:
    """The *content* half of an executable artifact's identity: every
    BucketKey field (schedule, precision AND mesh included — two
    executables traced from different schedules, solve paths or mesh
    placements are different programs) plus the batch point.  Pure and canonical; the *runtime*
    half (library versions, device kind) is appended by the artifact
    store, which this package does not have yet."""
    return {**key.to_json(), "batch": int(batch)}


def fingerprint(fields: dict) -> str:
    """Stable hex digest of a fingerprint field dict: sha256 over the
    canonical (sorted-key, compact) JSON encoding, so any drift in any
    field — bucket shape, schedule, precision, library version,
    device kind — produces a different artifact identity."""
    blob = json.dumps(fields, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def manifest_dumps(entries, costs=None) -> str:
    """Serialize [(BucketKey, batch), ...] as the warmup manifest JSON.
    ``costs`` is an optional ``{(key, batch): cost-record}`` mapping
    (the build-time ``cost_analysis``/``memory_analysis`` capture —
    serve/cache.py's registry): entries with a record get a ``"cost"``
    field, so the flops/bytes/peak evidence restores with the manifest
    instead of costing a recapture compile on the next cold start."""

    def entry(k, b):
        e = {**k.to_json(), "batch": int(b)}
        if costs:
            c = costs.get((k, int(b)))
            if c:
                e["cost"] = c
        return e

    return json.dumps(
        {
            "version": 1,
            "entries": sorted(
                (entry(k, b) for k, b in entries),
                key=lambda e: (e["routine"], e["m"], e["n"], e["nrhs"],
                               e["dtype"], e["tag"], e["schedule"],
                               e["precision"], e["mesh"], e["phase"],
                               e["batch"]),
            ),
        },
        indent=1,
    )


def _manifest_doc(text_or_doc):
    """One parse for both loaders: accepts the manifest JSON text or
    an already-parsed document dict (the cache reads the file once and
    feeds both loaders from the same doc)."""
    return (
        text_or_doc if isinstance(text_or_doc, dict)
        else json.loads(text_or_doc)
    )


def manifest_loads(text):
    """Parse a warmup manifest (JSON text or parsed doc) back into
    [(BucketKey, batch), ...]."""
    doc = _manifest_doc(text)
    out = []
    for e in doc.get("entries", []):
        out.append((BucketKey.from_json(e), int(e.get("batch", 1))))
    return out


def manifest_cost_loads(text):
    """Parse the per-entry ``"cost"`` records out of a warmup manifest
    (JSON text or parsed doc): ``{(BucketKey, batch): cost-record}``.
    Entries without the field (older manifests, or a cache that ran
    with the device monitor off) simply yield nothing;
    tools/warmup_report.py flags them ``no-cost``."""
    doc = _manifest_doc(text)
    out = {}
    for e in doc.get("entries", []):
        c = e.get("cost")
        if isinstance(c, dict) and c:
            out[(BucketKey.from_json(e), int(e.get("batch", 1)))] = dict(c)
    return out
