"""Per-call Options map (reference: types.hh:32-80 OptionValue/Options,
option defaults resolved at use-site, e.g. gemmC.cc:55).

Options are a plain dict {Option|str: value}; `get_option` resolves defaults
exactly like the reference's use-site `get_option( opts, Option::X, default )`.
String keys are accepted for ergonomics ("lookahead" == Option.Lookahead).
The keys and defaults are those of the JAX package, so one options dict
drives both.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

from .enums import Option, RefineMethod, Schedule
from .exceptions import OptionError

OptionKey = Union[Option, str]
Options = Mapping[OptionKey, Any]

#: n at or above which a request routes to the sharded drivers when a
#: mesh is configured (the JAX package keeps it in serve/buckets.py)
DEFAULT_SHARD_THRESHOLD = 2048

_DEFAULTS = {
    Option.ChunkSize: 1,
    # Lookahead follows the reference convention: 1 = the baseline
    # pipeline (one panel in flight — no extra eager panels); k > 1
    # peels k-1 exact-shape panels ahead of the recursion split in the
    # recursive factorization schedules (drivers/chol.py).
    Option.Lookahead: 1,
    Option.BlockSize: 256,
    Option.InnerBlocking: 16,
    Option.MaxPanelThreads: 1,
    Option.Tolerance: None,  # resolved per-dtype at use site (epsilon-based)
    Option.Target: None,  # Target.Devices at use site
    Option.HoldLocalWorkspace: False,
    Option.Depth: 2,
    Option.MaxIterations: 30,
    Option.UseFallbackSolver: True,
    Option.PivotThreshold: 1.0,
    Option.PrintVerbose: 0,
    Option.PrintEdgeItems: 16,
    Option.PrintWidth: 10,
    Option.PrintPrecision: 4,
    Option.MaxUnrolledTiles: 256,
    Option.UseShardMap: True,
    Option.RequireSpmd: False,
    Option.Schedule: Schedule.Auto,
    Option.RefineMethod: RefineMethod.Auto,
    Option.ServeQueueLimit: 128,
    Option.ServeBatchMax: 8,
    Option.ServeBatchWindow: 0.002,
    Option.ServeRetryBackoff: 0.01,
    Option.ServeBreakerCooldown: 5.0,
    Option.ServeValidate: True,
    Option.ServePrecision: "full",
    Option.ServeArtifacts: "",
    Option.ServeReplicas: 1,
    Option.ServeMesh: "",
    Option.ServeShardThreshold: DEFAULT_SHARD_THRESHOLD,
    Option.ServeFactorCache: False,
    Option.ServeFactorCacheEntries: 32,
    Option.ServeFactorCacheBytes: 1 << 30,
    Option.ServeFactorArena: "",
    Option.ServeTenantQuota: "",
    Option.ServeAdaptiveWindow: False,
    Option.ServeLatencyBudget: 0.0,
    Option.ServeIntegrity: "",
    Option.ServeDrainTimeout: 30.0,
    Option.ServeScale: "",
    Option.Faults: "",
}


def _canon(key: OptionKey) -> Option:
    if isinstance(key, Option):
        return key
    k = str(key).strip().lower()
    for opt in Option:
        if opt.value == k or opt.name.lower() == k:
            return opt
    raise OptionError(f"unknown option key: {key!r}")


def normalize_options(opts: Optional[Options]) -> dict:
    """Canonicalize user-provided option keys to Option enum members."""
    out: dict = {}
    for key, val in (opts or {}).items():
        out[_canon(key)] = val
    return out


def resolve_schedule_opts(opts: Optional[Options]):
    """(schedule, nb_switch, lookahead) for the factorization drivers:
    the Option.Schedule route (flat|recursive|pallas|auto), the recursion
    crossover (Option.BlockSize), and the eager-panel peel count
    (Option.Lookahead — reference semantics: 1 = baseline pipeline,
    k > 1 peels k-1 exact-shape panels ahead of the recursion split)."""
    sched = get_option(opts, Option.Schedule, Schedule.Auto)
    if isinstance(sched, str):
        sched = Schedule.from_string(sched)
    nb_switch = int(get_option(opts, Option.BlockSize, 256))
    lookahead = int(get_option(opts, Option.Lookahead, 1))
    return sched.value, nb_switch, lookahead


def get_option(opts: Optional[Options], key: OptionKey, default: Any = None) -> Any:
    """Use-site default resolution (reference pattern: get_option(opts, k, d)).

    Unknown keys in ``opts`` are ignored here; use ``normalize_options`` at
    driver entry to reject typos loudly.
    """
    key = _canon(key)
    if opts:
        if key in opts:
            return opts[key]
        for k, v in opts.items():
            try:
                kc = _canon(k)
            except OptionError:
                continue
            if kc is key:
                return v
    if default is not None:
        return default
    return _DEFAULTS.get(key)
