"""Enums and constants for slate_tpu_torch: a copy of the JAX package's
``enums.py`` (pure Python), kept so that one options dict means the same
in both packages.  In this package ``Schedule.Pallas`` names the
hand-written Hopper kernel family (``ops/hopper/panel_kernels.py``).
The original notes follow.

TPU-native re-design of the reference enum set (reference:
include/slate/enums.hh).  Enums that only existed to drive the CPU/GPU
runtime (MOSI coherence states, LayoutConvert, HostNum device ids) are
intentionally dropped: on TPU there is a single device memory space per chip
and XLA owns data layout.  Everything that shapes the *algorithms* or the
user API is kept with identical spellings so testers/sweeps translate 1:1.
"""

from __future__ import annotations

import enum


class _StrParseMixin:
    """from_string/to_string helpers matching the reference's conventions
    (reference: include/slate/enums.hh from_string/to_c_string families)."""

    @classmethod
    def from_string(cls, s: str):
        key = s.strip().lower()
        for member in cls:  # type: ignore[attr-defined]
            names = {member.name.lower(), str(member.value).lower()}
            names |= set(getattr(member, "aliases", lambda: ())())
            if key in names:
                return member
        raise ValueError(f"unknown {cls.__name__}: {s!r}")

    def to_string(self) -> str:
        return self.name


class Op(_StrParseMixin, enum.Enum):
    """Transposition op applied to a matrix view (reference: blaspp blas::Op)."""

    NoTrans = "N"
    Trans = "T"
    ConjTrans = "C"

    def aliases(self):
        return {"n": ("notrans",), "t": ("trans",), "c": ("conjtrans",)}.get(
            self.value.lower(), ()
        )


class Uplo(_StrParseMixin, enum.Enum):
    Lower = "L"
    Upper = "U"
    General = "G"


class Diag(_StrParseMixin, enum.Enum):
    NonUnit = "N"
    Unit = "U"


class Side(_StrParseMixin, enum.Enum):
    Left = "L"
    Right = "R"


class Layout(_StrParseMixin, enum.Enum):
    """Kept for ScaLAPACK-compat buffer ingestion only; device tiles are
    always logical row-major jax arrays and XLA picks physical layouts."""

    ColMajor = "C"
    RowMajor = "R"


class Target(_StrParseMixin, enum.Enum):
    """Where bulk steps execute (reference: enums.hh:38-44 Target).

    On TPU all real work is XLA; `Devices` is the default and the Host*
    targets are kept for API parity and map to the same implementation
    (single jit computation), optionally forced onto the CPU backend for
    debugging.
    """

    Host = "H"
    HostTask = "T"
    HostNest = "N"
    HostBatch = "B"
    Devices = "D"

    def aliases(self):
        return {
            "H": ("h", "host"),
            "T": ("t", "task", "hosttask"),
            "N": ("n", "nest", "hostnest"),
            "B": ("b", "batch", "hostbatch"),
            "D": ("d", "dev", "device", "devices"),
        }[self.value]


class Norm(_StrParseMixin, enum.Enum):
    One = "1"
    Two = "2"
    Inf = "I"
    Fro = "F"
    Max = "M"

    def aliases(self):
        return {
            "1": ("one", "o"),
            "2": ("two",),
            "I": ("i", "inf"),
            "F": ("f", "fro"),
            "M": ("m", "max"),
        }[self.value]


class NormScope(_StrParseMixin, enum.Enum):
    """Matrix norm vs per-column / per-row norms (reference: enums.hh:514)."""

    Columns = "C"
    Rows = "R"
    Matrix = "M"


class GridOrder(_StrParseMixin, enum.Enum):
    """Order mapping processes onto the p x q tile grid (reference: enums.hh:524)."""

    Col = "C"
    Row = "R"
    Unknown = "U"


class TileKind(enum.Enum):
    """Provenance of a tile allocation (reference: Tile.hh:97-101).  In the
    functional TPU design only the user/owned distinction survives, used by
    the compat layer to decide write-back."""

    Workspace = 0
    SlateOwned = 1
    UserOwned = 2


# ---------------------------------------------------------------------------
# Method enums — algorithm variant selectors (reference: enums.hh:100-455).
# ---------------------------------------------------------------------------


class MethodGemm(_StrParseMixin, enum.Enum):
    Auto = "*"
    A = "A"  # stationary-A (gemmA: reduce C contributions)
    C = "C"  # stationary-C (SUMMA)

    def aliases(self):
        return {"*": ("auto",), "A": ("gemma",), "C": ("gemmc",)}[self.value]


class MethodHemm(_StrParseMixin, enum.Enum):
    Auto = "*"
    A = "A"
    C = "C"

    def aliases(self):
        return {"*": ("auto",), "A": ("hemma",), "C": ("hemmc",)}[self.value]


class MethodTrsm(_StrParseMixin, enum.Enum):
    Auto = "*"
    A = "A"  # stationary-A
    B = "B"  # stationary-B

    def aliases(self):
        return {"*": ("auto",), "A": ("trsma",), "B": ("trsmb",)}[self.value]


class MethodCholQR(_StrParseMixin, enum.Enum):
    Auto = "*"
    GemmA = "A"
    GemmC = "C"
    HerkA = "R"
    HerkC = "K"


class MethodGels(_StrParseMixin, enum.Enum):
    Auto = "*"
    QR = "Q"
    CholQR = "C"

    def aliases(self):
        return {"*": ("auto",), "Q": ("qr", "geqrf"), "C": ("cholqr",)}[self.value]


class MethodLU(_StrParseMixin, enum.Enum):
    """LU variants (reference: enums.hh:302-309).  On TPU the static-schedule
    friendly variants (NoPiv, RBT, CALU/tournament) are first-class."""

    Auto = "*"
    PartialPiv = "P"
    CALU = "C"
    NoPiv = "N"
    RBT = "R"
    BEAM = "B"

    def aliases(self):
        return {
            "*": ("auto",),
            "P": ("pplu", "partialpiv"),
            "C": ("calu",),
            "N": ("nopiv",),
            "R": ("rbt",),
            "B": ("beam",),
        }[self.value]


class MethodEig(_StrParseMixin, enum.Enum):
    Auto = "*"
    QR = "Q"
    DC = "D"
    Bisection = "B"
    MRRR = "M"

    def aliases(self):
        return {"*": ("auto",), "Q": ("qr",), "D": ("dc",), "B": (), "M": ()}[self.value]


class MethodSVD(_StrParseMixin, enum.Enum):
    Auto = "*"
    QR = "Q"
    DC = "D"
    Bisection = "B"

    def aliases(self):
        return {"*": ("auto",), "Q": ("qr",), "D": ("dc",), "B": ()}[self.value]


class RefineMethod(_StrParseMixin, enum.Enum):
    """Mixed-precision refinement algorithm (slate_tpu extension over
    the reference's fixed pairing of gesv_mixed = classical IR and
    gesv_mixed_gmres = GMRES-IR; here one Option selects the method so
    serve buckets and sweeps can switch without changing routine names):

    * ``IR``    — classical iterative refinement (Wilkinson; reference
      src/gesv_mixed.cc): correct with the low-precision factors,
      residual in working precision.  Converges when
      cond(A) * eps_factor is safely below 1.
    * ``GMRES`` — restarted GMRES-IR preconditioned by the low-precision
      factors (reference src/gesv_mixed_gmres.cc; Carson & Higham SISC
      2018): survives roughly a factor 1/eps_factor more
      ill-conditioning than classical IR at extra FLOPs per iteration.
    * ``Auto``  — classical IR (the cheap path; callers wanting the
      robust path use the ``*_mixed_gmres`` drivers or set GMRES).
    """

    Auto = "auto"
    IR = "ir"
    GMRES = "gmres"

    def aliases(self):
        return {"auto": ("*",), "ir": ("classical",), "gmres": ("gmres_ir",)}[
            self.value
        ]


class Schedule(_StrParseMixin, enum.Enum):
    """Factorization schedule family (slate_tpu extension; no reference
    analogue — the reference gets exact-shape trailing updates for free
    from its dynamic tile task graph, a TPU static schedule has to pick):

    * ``Flat``      — the pre-recursion native family: the coarse
      blocked kernels where the shape admits them (``blocked_potrf``,
      ``lu_fast``, ``geqrf_fast``), the single-compiled-shape loops
      (``chol_fori`` / ``blocked_getrf`` lineage) otherwise — masked
      full-shape inner steps, ~2-6x the model FLOPs.
    * ``Recursive`` — divide & conquer on the halving lattice
      (``chol_recursive`` / ``getrf_recursive`` / ``geqrf_recursive``):
      exact statically-shrinking shapes, O(log n) distinct compile
      units, near-model FLOPs.
    * ``Pallas``    — the recursive lattice with the panel/base-case
      layer swapped for fused Pallas kernels
      (``ops/pallas/panel_kernels.py``): in-register panel LU pivot
      search, fused unblocked Cholesky, compact-WY T assembly,
      triangle-aware syrk diagonal blocks.  Compiled Mosaic on TPU for
      eligible operands; the identical kernel bodies run in interpret
      mode (plain XLA lowering) everywhere else, so the family is
      portable and artifacts stay custom-call-free.
    * ``Auto``      — backend dispatch: vendor kernel on CPU (LAPACK is
      already optimal), pallas above the crossover on accelerators,
      flat/blocked below it.
    """

    Auto = "auto"
    Flat = "flat"
    Recursive = "recursive"
    Pallas = "pallas"

    def aliases(self):
        return {
            "auto": ("*",),
            "flat": (),
            "recursive": ("rec", "dc"),
            "pallas": ("panel",),
        }[self.value]


# ---------------------------------------------------------------------------
# Option keys (reference: enums.hh:461-498)
# ---------------------------------------------------------------------------


class Option(enum.Enum):
    # Option-keyed dicts travel through jax pytree flattening (the
    # metrics layer's Tracer scan, user opts captured in jit closures),
    # which sorts dict keys — so Option must be orderable, including
    # against the string keys options.py also accepts.
    def __lt__(self, other):
        if isinstance(other, Option):
            return self.value < other.value
        if isinstance(other, str):
            return self.value < other
        return NotImplemented

    def __gt__(self, other):
        if isinstance(other, Option):
            return self.value > other.value
        if isinstance(other, str):
            return self.value > other
        return NotImplemented

    ChunkSize = "chunk_size"
    Lookahead = "lookahead"
    BlockSize = "block_size"
    InnerBlocking = "inner_blocking"
    MaxPanelThreads = "max_panel_threads"
    Tolerance = "tolerance"
    Target = "target"
    HoldLocalWorkspace = "hold_local_workspace"
    Depth = "depth"
    MaxIterations = "max_iterations"
    UseFallbackSolver = "use_fallback_solver"
    PivotThreshold = "pivot_threshold"
    # printing
    PrintVerbose = "print_verbose"
    PrintEdgeItems = "print_edgeitems"
    PrintWidth = "print_width"
    PrintPrecision = "print_precision"
    # methods
    MethodCholQR = "method_cholqr"
    MethodEig = "method_eig"
    MethodGels = "method_gels"
    MethodGemm = "method_gemm"
    MethodHemm = "method_hemm"
    MethodLU = "method_lu"
    MethodTrsm = "method_trsm"
    MethodSVD = "method_svd"
    # slate_tpu extensions
    Schedule = "schedule"  # factorization schedule: flat|recursive|auto
    RefineMethod = "refine_method"  # mixed-precision refinement: ir|gmres|auto
    MaxUnrolledTiles = "max_unrolled_tiles"  # unroll k-loop below this nt
    UseShardMap = "use_shard_map"  # explicit SPMD fast path vs GSPMD
    RequireSpmd = "require_spmd"  # error instead of gathered fallback
    # serving layer (serve/)
    ServeQueueLimit = "serve_queue_limit"  # admission bound (-> Rejected)
    ServeBatchMax = "serve_batch_max"  # coalesced batch point per bucket
    ServeBatchWindow = "serve_batch_window"  # coalescing linger, seconds
    ServeRetryBackoff = "serve_retry_backoff"  # backoff base, seconds
    ServeBreakerCooldown = "serve_breaker_cooldown"  # open -> half-open, s
    ServeValidate = "serve_validate"  # admission finiteness checks
    ServePrecision = "serve_precision"  # bucket solve precision: full|mixed
    ServeArtifacts = "serve_artifacts"  # executable artifact dir (cold start)
    ServeReplicas = "serve_replicas"  # data-parallel replica worker count
    ServeMesh = "serve_mesh"  # spmd submesh "PxQ" for sharded routing
    ServeShardThreshold = "serve_shard_threshold"  # n >= this routes sharded
    ServeFactorCache = "serve_factor_cache"  # enable the factorization cache
    ServeFactorCacheEntries = "serve_factor_cache_entries"  # LRU entry cap
    ServeFactorCacheBytes = "serve_factor_cache_bytes"  # LRU byte budget
    ServeFactorArena = "serve_factor_arena"  # device factor arena (fabric/)
    ServeTenantQuota = "serve_tenant_quota"  # tenant spec (admission grammar)
    ServeAdaptiveWindow = "serve_adaptive_window"  # AIMD batch-window control
    ServeLatencyBudget = "serve_latency_budget"  # p99 budget, s (0 = off)
    ServeIntegrity = "serve_integrity"  # SDC certification policy (integrity/)
    ServeDrainTimeout = "serve_drain_timeout"  # stop(drain=True) bound, s
    ServeScale = "serve_scale"  # elastic capacity policy (scale/ grammar)
    Faults = "faults"  # fault-injection spec string (aux/faults grammar)


# Marker constants kept for API parity (reference: enums.hh:531-534).
HostNum = -1
AllDevices = -2
AnyDevice = -3
