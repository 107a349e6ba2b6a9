"""slate_tpu_torch.serve — the batching solver service above the
drivers, on the card (the JAX package's ``serve``).

Shape-bucketed dispatch (`buckets`), an executable cache with a
persistent warmup manifest (`cache`, ``SLATE_TPU_WARMUP=/path.json``)
and an artifact store a fresh process restores from (`artifacts`,
``SLATE_TPU_ARTIFACTS=/dir``), a replica placement over the device
pool (`placement`), a factor-once/solve-many cache dispatching
trsm-only executables on repeated-A traffic (`factor_cache`,
``SLATE_TPU_FACTOR_CACHE``), the deadline-aware batching service with
its replica pool, readiness phases and integrity plane (`service`,
``SLATE_TPU_INTEGRITY``), the admission plane: tenant fairness and
quotas, priority shedding and an AIMD-adaptive batch window
(`admission`, ``SLATE_TPU_TENANTS`` / ``SLATE_TPU_ADAPTIVE``), and thin
sync wrappers (`api`): ``serve.gesv/posv/gels``, ``serve.submit``,
``serve.warmup``, ``serve.restore``, ``serve.wait_ready``,
``serve.health``, and the factor fabric's ``serve.get_arena`` (the
device factor arena, ``SLATE_TPU_FACTOR_ARENA``) and ``serve.session``
(streaming least-squares sessions).  The soak fabric that records,
replays and watches this tier is ``slate_tpu_torch.soak`` (item 7c2a);
the elastic capacity plane that sizes its replica pool is
``slate_tpu_torch.scale`` (item 7c2b, ``SLATE_TPU_SCALE``), and the
fleet tier that fronts worker processes is ``slate_tpu_torch.fleet``
(item 7c3, ``SLATE_TPU_FLEET``; ``serve.get_fleet``).

Not ported yet (ROADMAP.md Queue 1 item 8b2): the sharded lane.

Attribute access is lazy (PEP 562): importing ``slate_tpu_torch.serve``
pulls in no driver until the first request.
"""

from __future__ import annotations

import importlib

_API = (
    "gesv", "posv", "gels", "submit", "warmup", "restore", "wait_ready", "configure",
    "shutdown",
    "get_service", "get_cache", "health", "InvalidInput",
    "get_factor_cache", "factor_fingerprint", "invalidate", "invalidate_all",
    "update_factor", "get_arena", "session", "get_fleet",
)
_SERVICE = (
    "SolverService", "Rejected", "DeadlineExceeded", "Shed", "decorrelated_backoff",
    "PHASE_COLD", "PHASE_RESTORING", "PHASE_READY", "LANE_LIVE", "LANE_DRAINING",
    "LANE_REMOVED",
)
_CACHE = ("ExecutableCache", "direct_call", "WARMUP_ENV")
_ARTIFACTS = ("ArtifactStore", "ARTIFACTS_ENV", "store_from_env", "runtime_fields")
_BUCKETS = (
    "BucketKey", "Breaker", "bucket_for", "bucket_dim", "halving_bucket",
    "size_bucket_runs", "batch_bucket",
)
_PLACEMENT = ("PlacementPolicy", "LEAST_LOADED", "ROUND_ROBIN")
_FACTOR = ("FactorCache", "FactorEntry", "matrix_fingerprint", "FACTOR_CACHE_ENV")
_ADMISSION = (
    "AdmissionControl", "TenantConfig", "parse_tenants", "FairQueue", "AdaptiveWindow",
    "OverloadController", "TokenBucket", "TENANTS_ENV", "ADAPTIVE_ENV",
)
_SUBMODULES = ("api", "buckets", "cache", "artifacts", "service", "placement",
               "factor_cache", "admission")
_HOMES = {**{n: ".api" for n in _API}, **{n: ".service" for n in _SERVICE},
          **{n: ".cache" for n in _CACHE}, **{n: ".artifacts" for n in _ARTIFACTS},
          **{n: ".buckets" for n in _BUCKETS},
          **{n: ".placement" for n in _PLACEMENT}, **{n: ".factor_cache" for n in _FACTOR},
          **{n: ".admission" for n in _ADMISSION}}

__all__ = list(_HOMES) + list(_SUBMODULES)


def __getattr__(name: str):
    if name in _HOMES:
        return getattr(importlib.import_module(_HOMES[name], __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
