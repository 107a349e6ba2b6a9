"""Serve-level factorization cache: factor once, solve many (the JAX
package's ``serve/factor_cache.py``).

Real solver traffic re-uses A — one design matrix against a stream of
right-hand sides — yet every ``serve.gesv/posv`` request pays the full
O(n^3) factorization even when A is byte-identical to the last request.
This is an LRU of factorizations keyed by a matrix fingerprint, so a
repeated-A solve costs O(n^2): the ``getrs``/``potrs`` split lifted to
the serving tier.

Keying: :func:`matrix_fingerprint`, sha256 over A's bytes + dtype +
shape + routine + schedule + precision on the host — the same hex
digest as the JAX package for the same numpy A, because the digest is
the factor's identity.

Entries: a :class:`FactorEntry` holds the factor padded to its serve
bucket (``[[L, 0], [0, I]]`` / ``[[LU, 0], [0, I]]``, or the gels pack
of ``buckets.solve_factor_shape``) as a tensor on the lane's device, so
a hit uploads only B; gesv's forward row permutation rides as an int64
tensor on the same device, and P B is a gather there.  With the device
factor arena armed (``fabric/arena.py``) the service stores
:func:`host_entry` copies instead: factor and permutation in pinned host
memory, ``home`` naming the device they were computed on, and the arena
owns device residency.  ``nbytes`` is ``numel × element_size`` (plus the
permutation's), the numpy count, wherever the entry lives.

Budgets and lifecycle: an entry-count and a byte budget
(``Option.ServeFactorCacheEntries`` / ``ServeFactorCacheBytes`` or the
``SLATE_TPU_FACTOR_CACHE`` grammar), explicit invalidation, and rank-k
up/downdates (:meth:`FactorCache.update`: posv through
``ops/chol_kernels.chol_update``, gesv by a counted refactor).  Eviction
and invalidation degrade a later hit to a counted refactor, never a
wrong X.

Metrics: ``serve.factor_cache.{hit,miss,evict,invalidate,update,
update_refactor,refactor,spill,stale,uncacheable}`` counters and the
``serve.factor_cache.bytes`` / ``.entries`` gauges, each event also per
bucket (``serve.factor_cache.<label>.<event>``) and per fingerprint
(``serve.factor_cache.fp.<fp12>.<event>``, capped).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..aux import metrics, sync
from .buckets import BucketKey

FACTOR_CACHE_ENV = "SLATE_TPU_FACTOR_CACHE"

DEFAULT_MAX_ENTRIES = 32
DEFAULT_MAX_BYTES = 1 << 30  # 1 GiB of factors


def matrix_fingerprint(A: np.ndarray, routine: str, schedule: str = "auto",
                       precision: str = "full") -> str:
    """sha256 hex digest of one matrix's factor identity: A's bytes +
    dtype + shape + routine + schedule + precision (a deployment that
    flips Option.Schedule must refactor, not reuse)."""
    A = np.ascontiguousarray(A)
    h = hashlib.sha256()
    h.update(
        f"{routine}|{np.dtype(A.dtype).name}|{A.shape[0]}x{A.shape[1]}"
        f"|{schedule}|{precision}|".encode()
    )
    h.update(A.data)
    return h.hexdigest()


#: cardinality cap on the per-fingerprint metric family, which grows with
#: distinct matrices; past it, events count globally and per bucket and
#: the overflow is counted
FP_METRIC_CAP = 256
_fp_keys = metrics.CappedKeys(FP_METRIC_CAP)


def record(event: str, fp: Optional[str] = None, label: Optional[str] = None,
           n: int = 1) -> None:
    """One factor-cache event: global, per bucket, per fingerprint."""
    if not metrics.is_on():
        return
    metrics.inc(f"serve.factor_cache.{event}", n)
    if label:
        metrics.inc(f"serve.factor_cache.{label}.{event}", n)
    if fp:
        fp12 = fp[:12]
        if _fp_keys.track(fp12):
            metrics.inc(f"serve.factor_cache.fp.{fp12}.{event}", n)
        else:
            metrics.inc("serve.factor_cache.fp_overflow", n)


def _fp_gauge(fp: str, value: float) -> None:
    """Per-fingerprint bytes gauge, under the same cap."""
    if metrics.is_on() and _fp_keys.track(fp[:12]):
        metrics.gauge(f"serve.factor_cache.fp.{fp[:12]}.bytes", value)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclass(eq=False)
class FactorEntry:
    """One cached factorization, ready for the solve-phase executable
    (``eq=False``: entries are identities, not values)."""

    fp: str  # matrix_fingerprint of the A it was computed from
    routine: str  # gesv | posv | gels
    key: BucketKey  # the FULL-phase bucket key of the request stream
    # bucket-padded factor on the lane's device: (S, S) LU or L, or the
    # (Mb + kt*nb, Nb) gels pack — the exact first operand of the
    # solve-phase bucket executable
    factor: torch.Tensor
    perm: Optional[torch.Tensor]  # (n,) int64 forward row permutation (gesv)
    n: int  # true solution dimension
    replica: Optional[str] = None  # lane that factored it
    # the device the factor was computed on, when the entry holds it on
    # the host (an armed arena); None: the factor's own device
    home: Optional[torch.device] = None

    @property
    def nbytes(self) -> int:
        return _nbytes(self.factor) + _nbytes(self.perm)

    @property
    def device(self) -> torch.device:
        """Where the entry's factor is computed and updated."""
        return self.home if self.home is not None else self.factor.device

    @property
    def solve_key(self) -> BucketKey:
        return self.key.solve_sibling()


def _to_host(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A pinned host copy of a device tensor (the same tensor on the
    CPU): a later ``.to(device, non_blocking=True)`` copies without
    staging."""
    if t is None or t.device.type == "cpu":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)  # synchronous: the device copy may be freed after it
    return h


def host_entry(entry: FactorEntry) -> FactorEntry:
    """The entry an armed arena's cache stores: factor and permutation
    copied to pinned host memory, ``home`` set to their device."""
    return dataclasses.replace(entry, factor=_to_host(entry.factor),
                               perm=_to_host(entry.perm), home=entry.device)


def pad_square_t(F: torch.Tensor, S: int) -> torch.Tensor:
    """``buckets.pad_square`` of a device tensor: top-left embed with an
    identity trailing block."""
    n = F.shape[0]
    out = torch.zeros((S, S), dtype=F.dtype, device=F.device)
    out[:n, :n] = F
    if S > n:
        out[n:, n:].diagonal().fill_(1)
    return out


def _grid(device):
    from ..parallel.grid import ProcessGrid

    return ProcessGrid.single(device)


def factor_only(routine: str, A: np.ndarray, schedule: str = "auto", device=None):
    """Factor one true-shape A through the drivers on ``device`` (default
    ``cuda:0``); returns ``(factor, perm_or_None)`` as device tensors.
    gesv: getrf (LU + the forward row permutation's leading n entries,
    int64); posv: potrf (clean lower L).  Raises NumericalError on a
    nonzero info — a failed factor is never cached."""
    from ..drivers import chol as _chol
    from ..drivers import lu as _lu
    from ..enums import Option, Uplo
    from ..exceptions import NumericalError
    from ..matrix.matrix import HermitianMatrix, Matrix

    grid = _grid(device)
    n = A.shape[0]
    nb = min(64, n)
    opts = {Option.Schedule: schedule}
    if routine == "gesv":
        LU, piv, info = _lu.getrf(Matrix.from_global(A, nb, grid=grid), opts)
        if int(info) != 0:
            raise NumericalError(f"getrf: singular U({int(info)})",
                                 int(info)).with_context(routine=routine)
        perm = piv.perm[:n].to(torch.int64)
        if n and int(perm.max()) >= n:
            # cannot happen for the identity-spliced padded LU; a pivot
            # outside the leading block could not be replayed on a padded B
            raise NumericalError("getrf: pivot escaped the leading block"
                                 ).with_context(routine=routine)
        return LU.to_global(), perm
    if routine == "posv":
        L, info = _chol.potrf(HermitianMatrix.from_global(A, nb, grid=grid,
                                                          uplo=Uplo.Lower), opts)
        if int(info) != 0:
            raise NumericalError(f"potrf: not SPD at {int(info)}",
                                 int(info)).with_context(routine=routine)
        return torch.tril(L.to_global()), None
    raise ValueError(f"factor cache supports gesv/posv, not {routine!r}")


def gels_factor_pack(A: np.ndarray, key: BucketKey, schedule: str = "auto",
                     device=None) -> torch.Tensor:
    """Factor one true-shape tall A (m >= n) for the gels solve-phase
    bucket on ``device``: pad to the bucket's (Mb, Nb) tall shape (zero
    rows + unit pad columns keep full column rank), geqrf it once, and
    pack the V/R global with every panel's compact-WY T into one
    ``buckets.solve_factor_shape(key)`` tensor — the exact first operand
    of ``drivers/qr.gels_solve_from_global``."""
    from ..drivers import qr as _qr
    from ..enums import Option
    from ..matrix.matrix import Matrix
    from .buckets import gels_pack_kt, pad_tall, solve_factor_shape

    Ap = pad_tall(np.ascontiguousarray(A), key.m, key.n)
    fac, T = _qr.geqrf(Matrix.from_global(Ap, key.nb, grid=_grid(device)),
                       {Option.Schedule: schedule})
    VR = fac.to_global()
    pack = torch.zeros(solve_factor_shape(key), dtype=VR.dtype, device=VR.device)
    pack[: key.m] = VR
    for k in range(gels_pack_kt(key)):
        w = min(key.nb, key.n - k * key.nb)
        r0 = key.m + k * key.nb
        pack[r0:r0 + w, :w] = T.T[k][:w, :w]
    return pack


def solve_from_factor(entry: FactorEntry, B: np.ndarray, device=None) -> np.ndarray:
    """Direct (unbatched, eager) solve from a cached entry on the
    factor's device, or on ``device`` (a host entry's factor is copied
    there) — the math of the solve-phase bucket executable at the true
    size — for a request that finds the factor mid-flight and for parity
    checks.  Returns numpy."""
    from ..drivers import chol as _chol
    from ..drivers import lu as _lu
    from ..drivers import qr as _qr

    n = entry.n
    F = entry.factor if device is None else entry.factor.to(device)
    Bt = torch.as_tensor(np.asarray(B), device=F.device)
    if entry.routine == "gels":
        # pad B rows to the bucket height (pad rows carry zeros)
        Bp = torch.zeros((entry.key.m, Bt.shape[1]), dtype=Bt.dtype, device=F.device)
        Bp[: Bt.shape[0]] = Bt
        X = _qr.gels_solve_from_global(F, Bp, entry.key.m, entry.key.nb)[:n]
    elif entry.routine == "gesv":
        X = _lu.getrs_from_global(F[:n, :n], Bt[entry.perm.to(F.device)],
                                  entry.key.schedule)
    else:
        X = _chol.potrs_from_global(F[:n, :n], Bt, entry.key.schedule)
    return X.cpu().numpy()


def residual_ok(A: np.ndarray, B: np.ndarray, X: np.ndarray, routine: str = "gesv") -> bool:
    """Normwise backward-residual check of one served solve on the host:
    ``max|A X - B| <= sqrt(eps) * (|A|_inf |X|_inf + |B|_inf)``.  A stable
    solve sits at ~n eps whatever cond(A); a factor that no longer
    matches A lands at O(1).  gels moves the fence to the normal
    equations ``max|A^H (A X - B)|``."""
    if not np.all(np.isfinite(X)):
        return False
    dt = np.result_type(A, X)
    eps = np.finfo(np.dtype(dt).type(0).real.dtype).eps
    anrm = np.abs(A).max(initial=0.0)
    xmax = np.abs(X).max(initial=0.0)
    bmax = np.abs(B).max(initial=0.0)
    if routine == "gels":
        R = A.conj().T @ (A @ X - B)
        scale = anrm * (anrm * xmax + bmax)
    else:
        R = A @ X - B
        scale = anrm * xmax + bmax
    return float(np.abs(R).max(initial=0.0)) <= np.sqrt(eps) * max(scale, eps)


class FactorCache:
    """LRU factor cache with an entry-count and a byte budget.
    Thread-safe (admission and the lane worker both touch it)."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_entries = max(int(max_entries), 1)
        self.max_bytes = max(int(max_bytes), 1)
        self._lock = sync.RLock(name="factor_cache.FactorCache._lock")
        self._entries: "OrderedDict[str, FactorEntry]" = OrderedDict()  # guarded by: _lock
        self._bytes = 0  # guarded by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def fingerprints(self) -> list:
        """Cached fingerprints, least-recently-used first."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "max_entries": self.max_entries, "max_bytes": self.max_bytes}

    def _gauges_locked(self) -> None:
        metrics.gauge("serve.factor_cache.bytes", self._bytes)
        metrics.gauge("serve.factor_cache.entries", len(self._entries))

    def get(self, fp: str) -> Optional[FactorEntry]:
        """The entry for one fingerprint (refreshing its LRU position), or
        None.  Counts neither hit nor miss: the service counts those at
        the dispatch that serves (or misses) the factor."""
        with self._lock:
            sync.guarded(self, "_entries")
            entry = self._entries.get(fp)
            if entry is not None:
                self._entries.move_to_end(fp)
            return entry

    def put(self, entry: FactorEntry, replica: Optional[str] = None) -> bool:
        """Insert (or refresh) one entry, evicting LRU entries past either
        budget.  False when the entry alone exceeds the byte budget
        (counted uncacheable, never stored)."""
        if replica is not None:
            entry.replica = replica
        if entry.nbytes > self.max_bytes:
            record("uncacheable", fp=entry.fp, label=entry.key.label)
            return False
        with self._lock:
            sync.guarded(self, "_entries")
            old = self._entries.pop(entry.fp, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.fp] = entry
            self._bytes += entry.nbytes
            while self._entries and (len(self._entries) > self.max_entries
                                     or self._bytes > self.max_bytes):
                vfp, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                record("evict", fp=vfp, label=victim.key.label)
                _fp_gauge(vfp, 0)
            if entry.fp in self._entries:
                _fp_gauge(entry.fp, entry.nbytes)
            self._gauges_locked()
            return entry.fp in self._entries

    def invalidate(self, fp: str) -> bool:
        """Drop one fingerprint's factor; the next same-A request pays a
        counted refactor.  Returns whether it was present."""
        with self._lock:
            entry = self._entries.pop(fp, None)
            if entry is None:
                return False
            self._bytes -= entry.nbytes
            record("invalidate", fp=fp, label=entry.key.label)
            _fp_gauge(fp, 0)
            self._gauges_locked()
            return True

    def invalidate_all(self) -> int:
        """Drop every factor; returns the count dropped."""
        with self._lock:
            n = len(self._entries)
            for fp, entry in self._entries.items():
                record("invalidate", fp=fp, label=entry.key.label)
                _fp_gauge(fp, 0)
            self._entries.clear()
            self._bytes = 0
            self._gauges_locked()
            return n

    def rehome(self, old_replica: str, new_replica: Optional[str]) -> int:
        """Reassign every entry homed on ``old_replica`` (LRU positions
        untouched); returns the count moved."""
        moved = 0
        with self._lock:
            sync.guarded(self, "_entries")
            for entry in self._entries.values():
                if entry.replica == old_replica:
                    entry.replica = new_replica
                    moved += 1
        if moved:
            record("rehome", n=moved)
        return moved

    def update(self, fp: str, A_new: np.ndarray, U: np.ndarray,
               downdate: bool = False) -> Optional[str]:
        """Re-key one entry to an incrementally edited ``A_new = A ± U U^H``
        (U (n, k) or (n,)).  posv entries apply the O(k n^2) Cholesky
        up/downdate to the cached factor on its device; gesv entries, and
        a posv downdate that breaks down, refactor ``A_new``
        (``serve.factor_cache.update_refactor``).  Returns the new
        fingerprint, or None when ``fp`` is not cached.  A host entry
        (armed arena) is updated on its ``home`` device and stored back
        on the host."""
        from ..ops.chol_kernels import chol_update

        with self._lock:
            entry = self._entries.get(fp)
            if entry is not None and entry.routine == "gels":
                # rank-k A +- U U^H edits are square-matrix semantics;
                # row-streamed least squares lives in fabric.session
                raise ValueError("update: gels factors are row-streamed via "
                                 "serve.session(routine='gels'), not rank-k updated")
            entry = self._entries.pop(fp, None)
            if entry is not None:
                self._bytes -= entry.nbytes
        if entry is None:
            return None
        A_new = np.ascontiguousarray(A_new)
        if A_new.shape[0] != entry.n:
            self.put(entry)  # a different-size A is a different problem
            raise ValueError(f"update: A_new is {A_new.shape[0]}x{A_new.shape[1]}, "
                             f"entry holds n={entry.n}")
        new_fp = matrix_fingerprint(A_new, entry.routine, schedule=entry.key.schedule,
                                    precision=entry.key.precision)
        dev = entry.device
        factor = None
        perm = entry.perm
        if entry.routine == "posv":
            U2 = torch.as_tensor(np.asarray(U), dtype=entry.factor.dtype, device=dev)
            if U2.dim() == 1:
                U2 = U2[:, None]
            Up = torch.zeros((entry.factor.shape[0], U2.shape[1]), dtype=U2.dtype,
                             device=dev)
            Up[: entry.n] = U2  # pad rows untouched: I stays I
            F = chol_update(entry.factor.to(dev), Up, downdate=bool(downdate))
            if bool(torch.isfinite(F).all()):
                factor = F
                record("update", fp=new_fp, label=entry.key.label)
            # non-finite = downdate breakdown: refactor from A_new below
        if factor is None:
            raw, perm = factor_only(entry.routine, A_new, schedule=entry.key.schedule,
                                    device=dev)
            factor = pad_square_t(raw, entry.factor.shape[0])
            record("update", fp=new_fp, label=entry.key.label)
            record("update_refactor", fp=new_fp, label=entry.key.label)
        new = FactorEntry(fp=new_fp, routine=entry.routine, key=entry.key,
                          factor=factor, perm=perm, n=entry.n, replica=entry.replica)
        self.put(host_entry(new) if entry.home is not None else new)
        return new_fp


def parse_env_spec(spec: str) -> Optional[dict]:
    """Parse the ``SLATE_TPU_FACTOR_CACHE`` grammar: empty/``0``/``off``
    -> None (disabled), ``1``/``on`` -> defaults, or a comma list of
    ``entries=<int>`` / ``bytes=<float>`` overrides."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        return None
    if spec.lower() in ("1", "on", "true", "yes"):
        return {}
    out: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        k, v = k.strip().lower(), v.strip()
        if not sep:
            raise ValueError(f"{FACTOR_CACHE_ENV}={spec!r}: expected k=v, got {item!r}")
        if k == "entries":
            out["max_entries"] = int(v)
        elif k == "bytes":
            out["max_bytes"] = int(float(v))
        else:
            raise ValueError(f"{FACTOR_CACHE_ENV}={spec!r}: unknown key {k!r} "
                             "(entries|bytes)")
    return out


def cache_from_options(opts=None) -> Optional[FactorCache]:
    """The process/service default: ``SLATE_TPU_FACTOR_CACHE`` wins, else
    ``Option.ServeFactorCache`` with its two budgets.  None = disabled."""
    from ..enums import Option
    from ..options import get_option

    kw = parse_env_spec(os.environ.get(FACTOR_CACHE_ENV, ""))
    if kw is None:
        if not bool(get_option(opts, Option.ServeFactorCache)):
            return None
        kw = {}
    kw.setdefault("max_entries", int(get_option(opts, Option.ServeFactorCacheEntries)))
    kw.setdefault("max_bytes", int(get_option(opts, Option.ServeFactorCacheBytes)))
    return FactorCache(**kw)
