"""Executable cache + on-disk warmup manifest + artifact store + the
device monitor's cost registry (the JAX package's ``serve/cache.py``).

PyTorch runs eagerly, so an "executable" here is the closure that
:func:`_build_core` returns for one ``(BucketKey, batch)``, over padded
tensors on the lane's device: ``fn(A_batch, B_batch) -> (X_batch,
info_batch)`` with ``A: (batch, Mb, Nb)``, ``B: (batch, Mb, nrhs_b)``.
Its cold build is its first run on a device (``_warm_inputs`` at
warmup, or the first request): that run loads the kernel library,
creates the cuBLAS/cuSOLVER handles and warms the caching allocator.
Cold builds count under the JAX package's counter name,
``jit.compilations`` (and ``serve.<label>.b<batch>.compile`` /
``.compilations``; warm runs time ``.run``), so the JAX package's
steady-state rule reads the same here: after ``warmup()``, a stream in
warmed buckets makes no cold build, and no kernel build or library
load.

Full-phase batches loop over their items (the drivers are not batched)
and stack the results.  Solve-phase keys (the factor cache's
trsm-only family) take the factor as their first operand, unbatched:
the batch's padded right-hand sides are concatenated along columns
into one ``(Mb, batch * nrhs_b)`` operand and solved by ONE
``potrs_from_global`` / ``getrs_from_global`` /
``gels_solve_from_global`` call, then split by columns — the
counterpart of the JAX package's ``vmap(in_axes=(None, 0))``.  ABFT
keys (``tag == "abft"``) run ``integrity/abft.build_core``: the plain
pipeline plus the checksum relations, the verdict in ``info``.

Only two batch points exist per key (1 and batch_max,
``buckets.batch_bucket``), and every built ``(key, batch)`` lands in
the manifest (``SLATE_TPU_WARMUP=/path.json`` or an explicit path), so
``warmup()`` can bring a deployment's whole bucket set live at start.

With ``SLATE_TPU_ARTIFACTS=/dir`` (or ``artifact_dir``) the cache
consults an :class:`~slate_tpu_torch.serve.artifacts.ArtifactStore`
before every build (a verified entry is "restored": on a CUDA device the
kernel library opens from the store, no ``nvcc``) and persists every
cold build back to it, the library included, so a fresh process pointed
at the same directory restores the warmed set (``restore()``) instead
of rebuilding it.  ``warmup()``, ``restore()`` and ``prime()`` share one
loop (``_bring_live``) that differs only in its error policy.
Results come back to the host as numpy: that copy is the
synchronisation point of a dispatch.

With ``SLATE_TPU_DEVMON=1`` (``aux/devmon``) a core's first run on a
device (its cold build, or its first run after a verified artifact
restore) is measured by ``devmon.capture_run``: the ``phase_flops``
model, the operand and result bytes and the allocator's peak, recorded
as ``serve.<label>.b<batch>`` in the metrics cost registry and persisted
in the manifest entry's ``"cost"`` field, so a restarted process reads
the row instead of measuring again (:meth:`cost`,
:meth:`costs_by_label`, ``health()["cost"]``).
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..aux import devmon, faults, metrics, spans, sync
from ..exceptions import NumericalError
from .artifacts import ArtifactStore, store_from_env
from .buckets import (
    BucketKey,
    manifest_cost_loads,
    manifest_dumps,
    manifest_loads,
    phase_flops,
    solve_factor_shape,
)

WARMUP_ENV = "SLATE_TPU_WARMUP"

#: manifest paths already warned about this process (warn once a path)
_warned_manifests: Set[str] = set()


def _grid(device):
    from ..parallel.grid import ProcessGrid

    return ProcessGrid.single(device)


def _solve_batched(solve: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """Wrap a one-factor solve over (rows, k) into the batched solve-phase
    core: the batch's right-hand sides side by side as one operand."""

    def core(F, Bb):
        bb, m, r = Bb.shape
        X = solve(F, Bb.permute(1, 0, 2).reshape(m, bb * r))
        Xb = X.reshape(X.shape[0], bb, r).permute(1, 0, 2)
        return Xb, torch.zeros(bb, dtype=torch.int32, device=Bb.device)

    return core


def _build_core(key: BucketKey) -> Callable:
    """The batched core over padded tensors for one bucket.  The key's
    factorization schedule is threaded into the drivers through
    Option.Schedule."""
    from ..drivers import chol as _chol
    from ..drivers import lu as _lu
    from ..drivers import qr as _qr
    from ..enums import Option, Uplo
    from ..matrix.matrix import HermitianMatrix, Matrix

    nb = key.nb
    opts = {Option.Schedule: key.schedule}

    if key.mesh:
        raise NotImplementedError(
            f"bucket {key.label}: sharded serving needs the distributed drivers "
            "(ROADMAP.md Queue 1 item 8b2)")

    if key.phase == "solve":
        # trsm-only bucket (the factor cache's hit family): the first
        # operand is the bucket-padded factor ([[LU,0],[0,I]] with the
        # rows of B pre-permuted for gesv, [[L,0],[0,I]] for posv, the
        # packed QR for gels), not A
        if key.routine == "gesv":
            return _solve_batched(lambda F, B: _lu.getrs_from_global(F, B, key.schedule))
        if key.routine == "posv":
            return _solve_batched(lambda F, B: _chol.potrs_from_global(F, B, key.schedule))
        if key.routine == "gels":
            return _solve_batched(lambda F, B: _qr.gels_solve_from_global(F, B, key.m, nb))
        raise ValueError(f"solve-phase serving supports gesv/posv/gels, not {key.routine!r}")

    if key.tag == "abft" and key.routine in ("gesv", "posv"):
        # checksummed bucket: the same driver pipeline plus the checksum
        # relations, whose verdict rides out as info = ABFT_BAD (< 0)
        from ..integrity import abft as _abft

        core1 = _abft.build_core(key.routine, nb, key.schedule)

    elif key.precision == "mixed":
        # low-precision factor + refinement (drivers/mixed.serve_mixed_core);
        # non-converged items come back NaN and the service re-solves them
        from ..drivers import mixed as _mixed

        if key.routine not in ("gesv", "posv"):
            raise ValueError(f"mixed-precision serving supports gesv/posv, "
                             f"not {key.routine!r}")

        def core1(Ag, Bg):
            return _mixed.serve_mixed_core(key.routine, Ag, Bg, nb, key.schedule)

    elif key.routine == "gesv":

        def core1(Ag, Bg):
            g = _grid(Ag.device)
            X, _LU, _piv, info = _lu.gesv(Matrix.from_global(Ag, nb, grid=g),
                                          Matrix.from_global(Bg, nb, grid=g), opts)
            return X.to_global(), info

    elif key.routine == "posv":

        def core1(Ag, Bg):
            g = _grid(Ag.device)
            X, _L, info = _chol.posv(
                HermitianMatrix.from_global(Ag, nb, grid=g, uplo=Uplo.Lower),
                Matrix.from_global(Bg, nb, grid=g), opts)
            return X.to_global(), info

    elif key.routine == "gels":

        def core1(Ag, Bg):
            g = _grid(Ag.device)
            X = _qr.gels(Matrix.from_global(Ag, nb, grid=g),
                         Matrix.from_global(Bg, nb, grid=g), opts)
            return X.to_global(), torch.zeros((), dtype=torch.int32, device=Ag.device)

    else:
        raise ValueError(f"unknown serving routine: {key.routine!r}")

    def core(Ab, Bb):
        # the drivers are not batched: one item at a time, stacked (the
        # JAX package's mesh branch batches the same way)
        outs = [core1(Ab[i], Bb[i]) for i in range(Ab.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1].reshape(()).to(torch.int32) for o in outs]))

    return core


def direct_call(routine: str, A: np.ndarray, B: np.ndarray, device=None) -> np.ndarray:
    """Unpadded, unbatched driver call on ``device`` (default ``cuda:0``;
    never a quiet move to the CPU) — the reference result and the
    graceful-degradation fallback path.  Raises NumericalError on a
    nonzero info."""
    from ..drivers import chol as _chol
    from ..drivers import lu as _lu
    from ..drivers import qr as _qr
    from ..enums import Uplo
    from ..matrix.matrix import HermitianMatrix, Matrix

    faults.sleep("latency")
    faults.check("execute")
    g = _grid(device)
    nb = min(64, A.shape[1])
    if routine == "gesv":
        X, _LU, _piv, info = _lu.gesv(Matrix.from_global(A, nb, grid=g),
                                      Matrix.from_global(B, nb, grid=g))
        if int(info) != 0:
            raise NumericalError(f"gesv: singular U({int(info)})",
                                 int(info)).with_context(routine=routine)
        # sdc_solve on the direct path too: the fallback / re-execution
        # lane is hardware like any other
        return faults.perturb("sdc_solve", X.to_global().cpu().numpy())
    if routine == "posv":
        X, _L, info = _chol.posv(HermitianMatrix.from_global(A, nb, grid=g, uplo=Uplo.Lower),
                                 Matrix.from_global(B, nb, grid=g))
        if int(info) != 0:
            raise NumericalError(f"posv: not SPD at {int(info)}",
                                 int(info)).with_context(routine=routine)
        return faults.perturb("sdc_solve", X.to_global().cpu().numpy())
    if routine == "gels":
        nbm = min(64, max(A.shape))
        X = _qr.gels(Matrix.from_global(A, nbm, grid=g), Matrix.from_global(B, nbm, grid=g))
        return X.to_global().cpu().numpy()
    raise ValueError(f"unknown serving routine: {routine!r}")


def _warm_inputs(key: BucketKey, batch: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Well-conditioned dummy operands for a cold build, made on the
    device: identity A (SPD, pivot-free, full rank, and a valid LU /
    Cholesky factor for the solve-phase family; for the gels pack the
    identity V/R with zero T panels) and zero B."""
    dt = getattr(torch, key.dtype)
    d = min(key.m, key.n)
    if key.phase == "solve":
        A = torch.zeros(solve_factor_shape(key), dtype=dt, device=device)
        A[:d, :d].diagonal().fill_(1)
    else:
        A = torch.zeros((batch, key.m, key.n), dtype=dt, device=device)
        A[:, :d, :d].diagonal(dim1=1, dim2=2).fill_(1)
    return A, torch.zeros((batch, key.m, key.nrhs), dtype=dt, device=device)


def _dev_id(device) -> str:
    return str(torch.device(device))


class ExecutableCache:
    """(BucketKey, batch) -> core closure, with manifest persistence, the
    per-device cold-build record and (``artifact_dir`` /
    ``SLATE_TPU_ARTIFACTS``) an artifact store consulted before every
    build.  Thread-safe: the lane workers, ``warmup()`` and ``restore()``
    may race on a first run."""

    def __init__(self, manifest_path: Optional[str] = None,
                 artifact_dir: Optional[str] = None):
        self._lock = sync.RLock(name="cache.ExecutableCache._lock")
        self._exes: Dict[Tuple[BucketKey, int], Callable] = {}  # guarded by: _lock
        self._entries: Set[Tuple[BucketKey, int]] = set()  # guarded by: _lock
        # how each core came to be: "artifact" (a verified entry) or
        # "compile" (built here); restore() reports it
        self._origin: Dict[Tuple[BucketKey, int], str] = {}  # guarded by: _lock
        # device ids each entry has run on: the first run on a device is
        # its cold build
        self._primed: Dict[Tuple[BucketKey, int], Set[str]] = {}  # guarded by: _lock
        # single-flight builds: one thread loads the artifact (one
        # counted rung) while the others wait
        self._building: Dict[Tuple[BucketKey, int], threading.Event] = {}  # guarded by: _lock
        # the device monitor's cost rows, persisted beside each manifest
        # entry ("cost"), so a restarted process never measures again
        self._costs: Dict[Tuple[BucketKey, int], dict] = {}  # guarded by: _lock
        self.artifacts: Optional[ArtifactStore] = store_from_env(artifact_dir)
        self.manifest_path = (manifest_path if manifest_path is not None
                              else os.environ.get(WARMUP_ENV) or None)
        if self.manifest_path and os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    doc = json.load(f)
                self._entries.update(manifest_loads(doc))
                self._costs.update(manifest_cost_loads(doc))
            except (OSError, ValueError, KeyError, TypeError) as e:
                # a corrupt manifest never blocks serving, but is counted
                # and warned about once a path
                metrics.inc("serve.manifest_corrupt")
                if self.manifest_path not in _warned_manifests:
                    _warned_manifests.add(self.manifest_path)
                    warnings.warn(
                        f"corrupt warmup manifest at {self.manifest_path!r} "
                        f"({type(e).__name__}: {e}); starting with an empty bucket "
                        "set — steady state will rebuild",
                        RuntimeWarning, stacklevel=2)

    # -- manifest ----------------------------------------------------------

    def entries(self) -> List[Tuple[BucketKey, int]]:
        with self._lock:
            return sorted(self._entries, key=lambda e: (e[0].label, e[1]))

    def ensure_manifest(self, key: BucketKey, batches) -> None:
        """Record every batch point of a bucket's working set."""
        with self._lock:
            new = [int(b) for b in batches if (key, int(b)) not in self._entries]
            if new:
                self._entries.update((key, b) for b in new)
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self.manifest_path:
            return
        tmp = f"{self.manifest_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(manifest_dumps(self._entries, self._costs) + "\n")
            os.replace(tmp, self.manifest_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def save_manifest(self, path: Optional[str] = None) -> Optional[str]:
        """Write the current bucket set to ``path`` (or the configured
        path).  Returns the path written."""
        with self._lock:
            if path is not None:
                self.manifest_path = path
            self._flush_locked()
            return self.manifest_path

    # -- cost/memory registry (aux/devmon capture) -------------------------

    def cost(self, key: BucketKey, batch: int) -> Optional[dict]:
        """The cost row of one core, or None when the device monitor never
        measured it (off, or a manifest without the field)."""
        with self._lock:
            c = self._costs.get((key, int(batch)))
            return dict(c) if c else None

    def cost_registry(self) -> Dict[Tuple[BucketKey, int], dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._costs.items()}

    def costs_by_label(self) -> Dict[str, Dict[int, dict]]:
        """The registry as ``{bucket label: {batch: row}}``, the shape
        ``health()`` and the report tools read."""
        out: Dict[str, Dict[int, dict]] = {}
        with self._lock:
            for (key, batch), c in self._costs.items():
                out.setdefault(key.label, {})[int(batch)] = dict(c)
        return out

    def _first_run(self, key: BucketKey, batch: int, device: torch.device, name: str, go):
        """A core's first run on a device, measured by the device monitor
        (one bool when it is off).  A row already known for this device
        kind (a cost-bearing manifest) is recorded into this process's
        registry without measuring; a row from another device kind is
        measured again (``serve.cost_foreign_recaptured``); a failed
        measured run counts ``serve.cost_capture_failed``."""
        if not devmon.is_on():
            return go()
        kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else device.type).lower()
        with self._lock:
            known = self._costs.get((key, batch))
        if known is not None and known.get("device_kind") in (None, kind):
            metrics.record_cost(name, known)
            return go()
        if known is not None:
            metrics.inc("serve.cost_foreign_recaptured")
        try:
            out, cost = devmon.capture_run(go, None, phase_flops(key, batch), None, device,
                                           record=False)
        except Exception:
            # the measured run is the core's first: its failure is the
            # build's, and propagates; the row is never written
            metrics.inc("serve.cost_capture_failed")
            raise
        (Xd, infod), (A, B) = out
        cost["argument_bytes"] = int(A.nbytes + B.nbytes)
        cost["output_bytes"] = int(Xd.nbytes + infod.nbytes)
        cost["bytes_accessed"] = float(cost["argument_bytes"] + cost["output_bytes"])
        metrics.record_cost(name, cost)
        metrics.inc("serve.cost_captured")
        with self._lock:
            self._costs[(key, batch)] = cost
            self._flush_locked()
        return out

    # -- executables -------------------------------------------------------

    def is_live(self, key: BucketKey, batch: int) -> bool:
        """Whether the (key, batch) core has run on some device (a probe
        that never builds)."""
        with self._lock:
            return bool(self._primed.get((key, batch)))

    def executable(self, key: BucketKey, batch: int, device=None) -> Callable:
        """The core closure of one (key, batch): memory, then the
        artifact store (a verified entry is "restored"), then a build
        (the ``compile`` fault site fires on builds only).  A build
        records the entry in the manifest; its first run persists it to
        the store (:meth:`run`)."""
        while True:
            with self._lock:
                exe = self._exes.get((key, batch))
                if exe is not None:
                    return exe
                ev = self._building.get((key, batch))
                if ev is None:
                    ev = self._building[(key, batch)] = threading.Event()
                    break  # this thread builds
            ev.wait()  # a failed build leaves the entry absent: take over
        try:
            return self._build(key, batch, device)
        finally:
            with self._lock:
                self._building.pop((key, batch), None)
            ev.set()

    def _build(self, key: BucketKey, batch: int, device) -> Callable:
        origin = "compile"
        if self.artifacts is not None and self.artifacts.load(key, batch, device):
            origin = "artifact"
        else:
            # every rung but a hit rebuilds from the sources: the store's
            # library copy is opened only by a verified hit
            faults.check("compile")
        exe = _build_core(key)
        with self._lock:
            exe = self._exes.setdefault((key, batch), exe)
            self._origin.setdefault((key, batch), origin)
            if (key, batch) not in self._entries:
                self._entries.add((key, batch))
                self._flush_locked()
        return exe

    def run(self, key: BucketKey, A_batch, B_batch, device=None):
        """Execute one padded batch on ``device`` (default ``cuda:0``);
        returns host numpy (X_batch, info_batch).  A and B may be numpy
        (uploaded here) or tensors already on the device.  The first run
        of a built (not restored) entry saves it to the artifact store.

        Fault sites (one bool each when off): ``latency`` sleeps before
        dispatch, ``execute`` raises in place of the dispatch,
        ``result_corrupt`` NaN-poisons item 0 of X, ``sdc_solve``
        perturbs item 0 of a gesv/posv X to a finite wrong value,
        ``info_nonzero`` forces item 0's info nonzero."""
        faults.sleep("latency")
        faults.check("execute")
        device = torch.device(device) if device is not None else _grid(None).device
        # the batch point: A's leading axis for the full family, B's for
        # the solve family (whose factor operand is unbatched)
        batch = B_batch.shape[0] if key.phase == "solve" else A_batch.shape[0]
        exe = self.executable(key, batch, device)
        did = _dev_id(device)
        with self._lock:
            primed = self._primed.get((key, batch), ())
            cold, first = did not in primed, not primed
            save = first and self._origin.get((key, batch)) == "compile"
        name = f"serve.{key.label}.b{batch}"

        def go():
            A = torch.as_tensor(A_batch, device=device)
            B = torch.as_tensor(B_batch, device=device)
            return exe(A, B), (A, B)

        t0 = time.perf_counter()
        (Xd, infod), _ops = self._first_run(key, batch, device, name, go) if cold else go()
        X, info = Xd.cpu().numpy(), infod.cpu().numpy()  # the sync point
        dt = time.perf_counter() - t0
        if cold:
            metrics.inc("jit.compilations")
            metrics.inc(f"{name}.compilations")
            metrics.observe(f"{name}.compile", dt)
        else:
            metrics.observe(f"{name}.run", dt)
        with self._lock:
            self._primed.setdefault((key, batch), set()).add(did)
        if save and self.artifacts is not None:
            self.artifacts.save(key, batch, device)
        X = faults.corrupt("result_corrupt", X)
        if key.routine in ("gesv", "posv"):
            # a device returning finite garbage: invisible to the
            # finiteness fence, caught only by delivery certification
            X = faults.perturb("sdc_solve", X)
        info = faults.poison_info("info_nonzero", np.atleast_1d(info))
        return X, info

    # -- warmup / restore / prime (one loop, per-caller error policy) ------

    def _live_todo(self, batch_max: Optional[int] = None, extra_path: Optional[str] = None):
        """The sorted (key, batch) work list of :meth:`warmup` and
        :meth:`restore`: the manifest's entries (plus an extra manifest
        file's), minus batch points past ``batch_max`` and minus mesh
        entries, which no process of the port can serve yet (counted
        ``serve.mesh_unfit_skipped``).  Returns ``(todo, mesh_count)``."""
        with self._lock:
            todo = list(self._entries)
        if extra_path is not None and os.path.exists(extra_path):
            with open(extra_path) as f:
                todo += [e for e in manifest_loads(f.read()) if e not in todo]
        todo.sort(key=lambda e: (e[0].label, e[1]))
        out = []
        unfit = 0
        for key, batch in todo:
            if key.mesh:
                unfit += 1
                metrics.inc("serve.mesh_unfit_skipped")
                continue
            if batch_max is not None and batch > batch_max:
                continue
            out.append((key, batch))
        return out, unfit

    def _bring_live(self, todo, devices=None, on_error: Optional[Callable] = None,
                    stop_check: Optional[Callable[[], bool]] = None, verbose: bool = False,
                    tag: str = "warmup"):
        """The one loop behind :meth:`warmup`, :meth:`restore` and
        :meth:`prime`: bring each entry live (artifact-first, through
        :meth:`run`) with one dummy dispatch on every device of
        ``devices`` (default ``[cuda:0]``) it has not run on yet.

        ``on_error=None`` propagates the first failure (warmup); a
        callable receives ``(key, batch, exc)`` and the entry is reported
        ``failed`` (restore, prime).  ``stop_check`` is polled between
        entries; True abandons the rest (``serve.restore_stopped``).

        Yields ``(key, batch, outcome, origin)`` with outcome
        ``restored`` (a verified artifact), ``compiled`` (built),
        ``skipped`` (already live on every device asked for; devices it
        still had to prime count ``serve.device_primes``) or ``failed``."""
        devs = list(dict.fromkeys(_dev_id(d) for d in (devices or [_grid(None).device])))
        for key, batch in todo:
            if stop_check is not None and stop_check():
                metrics.inc("serve.restore_stopped")
                break
            with self._lock:
                primed = set(self._primed.get((key, batch), ()))
            live = bool(primed)
            need = [d for d in devs if d not in primed]
            if not need:
                yield key, batch, "skipped", None
                continue
            t0 = time.perf_counter()
            sp = (spans.start(tag, lane=tag, bucket=key.label, batch=batch)
                  if spans.is_on() else None)
            try:
                for d in need:
                    A, B = _warm_inputs(key, batch, d)
                    self.run(key, A, B, device=d)
            except Exception as e:  # noqa: BLE001 — the policy decides
                spans.end(sp, outcome="failed", error=type(e).__name__)
                if on_error is None:
                    raise
                on_error(key, batch, e)
                yield key, batch, "failed", None
                continue
            with self._lock:
                origin = self._origin.get((key, batch), "compile")
            if live:
                outcome, primes = "skipped", len(need)
            else:
                outcome = "restored" if origin == "artifact" else "compiled"
                primes = len(need) - 1
            if primes:
                metrics.inc("serve.device_primes", primes)
            spans.end(sp, outcome=outcome, origin=origin, primes=primes)
            if verbose:
                print(f"[serve.{tag}] {key.label} b{batch}: "
                      f"{'primed' if live else origin}"
                      f"{f' +{primes} device prime(s)' if primes else ''} "
                      f"{time.perf_counter() - t0:.2f}s")
            yield key, batch, outcome, origin

    def warmup(self, path: Optional[str] = None, batch_max: Optional[int] = None,
               devices=None, verbose: bool = False) -> int:
        """Cold-build every manifest entry (plus ``path``'s entries) on
        every device of ``devices`` (default ``[cuda:0]``) it has not run
        on yet.  Returns the number of entries built (restored entries
        are not counted).  Errors propagate.  The pass lands in the
        ``serve.warmup`` timer and the ``serve.warmup_s`` gauge."""
        todo, _unfit = self._live_todo(batch_max=batch_max, extra_path=path)
        compiled = 0
        with metrics.phase("serve.warmup", always=True) as ph:
            for _k, _b, outcome, _o in self._bring_live(todo, devices=devices,
                                                         verbose=verbose, tag="warmup"):
                compiled += outcome == "compiled"
        metrics.gauge("serve.warmup_s", ph.seconds)
        metrics.inc("serve.warmup_compiles", compiled)
        return compiled

    def _summary(self, todo, failed_counter: str, phase: str, **kw) -> Dict[str, int]:
        """One counting pass of :meth:`_bring_live` that never raises:
        ``{"entries", "restored", "compiled", "failed", "skipped"}`` with
        ``entries == restored + compiled + failed + skipped``; a failed
        entry counts ``failed_counter``.  The pass lands in the
        ``serve.<phase>`` timer and the ``serve.<phase>_s`` gauge."""
        out = {"entries": 0, "restored": 0, "compiled": 0, "failed": 0, "skipped": 0}

        def on_error(key, batch, exc):
            metrics.inc(failed_counter)

        with metrics.phase(f"serve.{phase}", always=True) as ph:
            for _k, _b, outcome, _o in self._bring_live(todo, on_error=on_error, **kw):
                out["entries"] += 1
                out[outcome] += 1
        metrics.gauge(f"serve.{phase}_s", ph.seconds)
        return out

    def restore(self, batch_max: Optional[int] = None, verbose: bool = False,
                stop_check: Optional[Callable[[], bool]] = None,
                devices=None) -> Dict[str, int]:
        """Bring every manifest entry live, artifact-first, primed on every
        device of ``devices``: the cold-start pass of a fresh process.
        Per-entry failures are counted (``serve.restore_failed``) and
        skipped, never raised.  Returns the :meth:`_summary`, plus
        ``mesh_unfit`` when mesh entries were skipped.  ``stop_check`` is
        polled between entries."""
        todo, unfit = self._live_todo(batch_max=batch_max)
        out = self._summary(todo, "serve.restore_failed", "restore", devices=devices,
                            stop_check=stop_check, verbose=verbose, tag="restore")
        if unfit:
            out["mesh_unfit"] = unfit
        metrics.inc("serve.restore_restored", out["restored"])
        metrics.inc("serve.restore_compiled", out["compiled"])
        return out

    def prime(self, entries=None, devices=None, batch_max: Optional[int] = None,
              verbose: bool = False, stop_check: Optional[Callable[[], bool]] = None,
              tag: str = "prime") -> Dict[str, int]:
        """Bring a caller-ordered ``(key, batch)`` subset live,
        artifact-first, on ``devices``: the warm path of a joining replica
        (``SolverService.add_replica``) and the applicator of a predictive
        :class:`~slate_tpu_torch.scale.warmup_plan.WarmupPlan`.  The
        caller's order is the priming order, so a deadline truncates from
        the plan's bottom.  ``entries=None`` walks the whole live manifest;
        explicit entries are registered in the manifest first (a planned
        bucket this process never dispatched still warms, and a later
        restore inherits it), minus batch points past ``batch_max`` and
        mesh entries (``serve.mesh_unfit_skipped``).  ``tag`` names the
        pass's spans.  Failures are counted (``serve.prime_failed``) and
        skipped, never raised.  Returns the :meth:`_summary`."""
        if entries is None:
            todo, _unfit = self._live_todo(batch_max=batch_max)
        else:
            todo = []
            for key, batch in entries:
                batch = int(batch)
                if key.mesh:
                    metrics.inc("serve.mesh_unfit_skipped")
                    continue
                if batch_max is not None and batch > batch_max:
                    continue
                self.ensure_manifest(key, (batch,))
                todo.append((key, batch))
        return self._summary(todo, "serve.prime_failed", "prime", devices=devices,
                             stop_check=stop_check, verbose=verbose, tag=tag)
