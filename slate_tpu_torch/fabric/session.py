"""Streaming least-squares sessions: factor once, append rows, solve on
demand (the JAX package's ``fabric/session.py``).

A :class:`FactorSession` owns one growing tall system ``min ||A x - B||``
in two regimes:

- **pristine** (no rows appended yet): every ``solve`` goes through the
  owning service's ``submit("gels", ...)``, so the factor cache, the
  device arena (``fabric/arena.py``) and the warmed ``phase="solve"``
  bucket all apply.
- **streamed** (after ``append``): the session keeps A and the n x n
  triangular factor R of the grown A as tensors on its device (the
  service's first lane: ``cuda:0`` on the card) and folds each appended
  block of k rows into R by Householder reflections restricted to the
  new rows, O(k n^2) instead of the O(m n^2) refactor.  Dirty solves use
  the corrected seminormal equations (R^H y = A^H B, R x = y, and one
  refinement sweep).

Every dirty solve is fenced by the serve tier's residual check
(``serve/factor_cache.residual_ok``, its gels branch, on the host).  A
fence failure, or an update breakdown (a non-finite R or a collapsed
diagonal), pays a counted refactor (``fabric.session.refactor``) and a
retry; if the fresh factor fails the fence too, the solve raises
:class:`~slate_tpu_torch.exceptions.NumericalError`: a wrong X is never
returned.

The fold's column loop runs on the device without a host read a column
(the branch on alpha = 0 or ||x|| = 0 is ``torch.where``), so it is a
loop of kernel launches issued by the host.  The refactor is
``torch.linalg.qr(mode="r")``, the counterpart of the JAX package's
``numpy.linalg.qr``; the CSNE solves are ``solve_triangular`` and
``matmul`` (the JAX package computes all three in numpy, outside any
Pallas kernel).

Metrics (under ``fabric.session.``): ``factor``, ``update``,
``update_rows``, ``solve``, ``refactor``, ``fence_fail``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..aux import faults, metrics, sync
from ..exceptions import DimensionError, InvalidInput, NumericalError

__all__ = ["FactorSession"]


def _update_r(R: torch.Tensor, C: torch.Tensor) -> None:
    """Fold k appended rows C into the triangular factor R in place.

    One Householder reflection a column, restricted to the pivot R[j, j]
    and the k new rows: after the sweep R is the triangular factor of
    [[R_old], [C]], and C is destroyed.  O(k n^2).  A column whose new
    entries are all zero is left as it is (tau = 0, v = 0): the branch is
    a ``torch.where`` on the device, so no column reads back to the host.
    """
    n = R.shape[1]
    for j in range(n):
        alpha = R[j, j].clone()
        x = C[:, j]
        xnorm2 = torch.linalg.vector_norm(x) ** 2
        absa = alpha.abs()
        mu = torch.sqrt(absa * absa + xnorm2)
        skip = xnorm2 == 0
        azero = absa == 0
        sign = torch.where(azero, torch.ones_like(alpha), alpha / torch.where(azero, 1, absa))
        beta = -sign * mu  # -mu where alpha == 0
        safe_beta = torch.where(beta == 0, torch.ones_like(beta), beta)
        tau = torch.where(skip, 0, torch.where(azero, 1, (beta - alpha) / safe_beta))
        denom = alpha - beta
        v2 = torch.where(skip, 0, x / torch.where(denom == 0, torch.ones_like(denom), denom))
        if j + 1 < n:
            s = R[j, j + 1:] + v2.conj() @ C[:, j + 1:]
            ts = tau * s
            R[j, j + 1:] -= ts
            C[:, j + 1:] -= torch.outer(v2, ts)
        R[j, j] = torch.where(skip, alpha, beta)


def _tdtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def _csne(A: torch.Tensor, R: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Corrected seminormal equations against R: R^H y = A^H B, R x = y,
    then one refinement sweep (r = B - A X, R^H w = A^H r, R dx = w)."""
    Ah = A.mH
    solve = torch.linalg.solve_triangular

    def rr(Y):
        return solve(R, solve(R.mH, Y, upper=False), upper=True)

    X = rr(Ah @ B)
    return X + rr(Ah @ (B - A @ X))


class FactorSession:
    """One streaming gels system bound to a serving tier.

    Created by ``serve.session(A, routine="gels")`` (serve/api.py) or
    directly with a :class:`~slate_tpu_torch.serve.service.SolverService`
    (or None for a session without pristine service solves).  ``device``
    holds the streamed A and R: by default the service's first lane, or
    ``cuda:0`` without a service.  Thread-safe: one lock serializes
    append / solve / refactor."""

    def __init__(self, service, A, routine: str = "gels", schedule: str = "auto",
                 device=None):
        if routine != "gels":
            raise InvalidInput(
                f"session: routine must be 'gels', got {routine!r} "
                "(streaming row appends are a least-squares notion)"
            ).with_context(routine=routine)
        A = np.array(A)  # an owned host copy: the session's A grows
        if A.ndim != 2 or A.shape[0] < A.shape[1]:
            raise DimensionError(
                "session: A must be 2-D with m >= n (tall least squares), got "
                f"shape {A.shape}").with_context(routine="gels")
        if not np.all(np.isfinite(A)):
            raise InvalidInput("session: A contains non-finite entries"
                               ).with_context(routine="gels")
        if device is None:
            if service is not None:
                device = service._replicas[0].device
            else:
                from ..parallel.grid import ProcessGrid

                device = ProcessGrid.single().device
        self.device = torch.device(device)
        self._svc = service
        self._schedule = schedule
        self._lock = sync.RLock(name="fabric.FactorSession._lock")
        # guarded by: _lock
        self._A = A  # host: pristine solves and the fence read it
        self._Ad: Optional[torch.Tensor] = None  # A on the device, from the first append
        self._R: Optional[torch.Tensor] = None  # lazy: built on append
        self._pristine = True
        self._solves = 0
        self._updates = 0
        self._refactors = 0

    # -- introspection -----------------------------------------------------

    @property
    def shape(self):
        with self._lock:
            return tuple(self._A.shape)

    @property
    def pristine(self) -> bool:
        """True until the first ``append``: pristine solves ride the
        service's factor cache and arena."""
        with self._lock:
            return self._pristine

    def stats(self) -> dict:
        with self._lock:
            return {"rows": int(self._A.shape[0]), "n": int(self._A.shape[1]),
                    "pristine": self._pristine, "solves": self._solves,
                    "updates": self._updates, "refactors": self._refactors}

    # -- factor maintenance ------------------------------------------------

    def _factor_locked(self) -> None:
        """(Re)build R from the whole current A: the counted fallback.
        Sign conventions do not matter downstream (CSNE reads only
        R^H R = A^H A)."""
        self._R = torch.linalg.qr(self._Ad, mode="r")[1][: self._Ad.shape[1]].contiguous()
        metrics.inc("fabric.session.factor")

    def _breakdown_locked(self) -> bool:
        """True when the maintained R can no longer be trusted: a
        non-finite entry or a collapsed diagonal (rank loss the sweep
        cannot see across columns)."""
        R = self._R
        if R is None or R.numel() == 0:
            return False
        collapsed = R.diagonal().abs().min() <= R.shape[1] * torch.finfo(R.dtype).eps * \
            R.abs().max()
        return bool(~torch.isfinite(R).all() | collapsed)  # one host read

    def _refactor_locked(self) -> None:
        metrics.inc("fabric.session.refactor")
        self._refactors += 1
        self._factor_locked()

    def append(self, C) -> None:
        """Append k rows to A and fold them into R in O(k n^2).

        Marks the session dirty: later solves use the maintained factor
        (fenced) instead of the service path.  A breakdown is repaired at
        once by a counted refactor: ``append`` never leaves a corrupt R.
        """
        C = np.atleast_2d(np.asarray(C))
        with self._lock:
            n = self._A.shape[1]
            if C.ndim != 2 or C.shape[1] != n:
                raise DimensionError(
                    f"session.append: rows must have {n} columns, got shape {C.shape}"
                ).with_context(routine="gels")
            if not np.all(np.isfinite(C)):
                raise InvalidInput("session.append: rows contain non-finite entries"
                                   ).with_context(routine="gels")
            dt = np.result_type(self._A.dtype, C.dtype)
            if self._A.dtype != dt:
                self._A = self._A.astype(dt)
            tdt = _tdtype(dt)
            if self._R is None:
                self._Ad = torch.as_tensor(self._A, device=self.device)
                self._factor_locked()
            elif self._R.dtype != tdt:
                self._R = self._R.to(tdt)
                self._Ad = self._Ad.to(tdt)
            Cd = torch.as_tensor(np.ascontiguousarray(C, dtype=dt), device=self.device)
            self._A = np.vstack([self._A, C.astype(dt, copy=False)])
            self._Ad = torch.cat([self._Ad, Cd])
            _update_r(self._R, Cd.clone())  # destroys its copy of C
            if faults.is_on():
                self._R = faults.perturb("session_update", self._R)
            metrics.inc("fabric.session.update")
            metrics.inc("fabric.session.update_rows", C.shape[0])
            self._updates += 1
            self._pristine = False
            if self._breakdown_locked():
                self._refactor_locked()

    def refactor(self) -> None:
        """Force a counted full refactor of the maintained R."""
        with self._lock:
            if self._Ad is None:
                self._Ad = torch.as_tensor(self._A, device=self.device)
            self._refactor_locked()

    # -- solves ------------------------------------------------------------

    def solve(self, B) -> np.ndarray:
        """Least-squares solve against the session's current A; returns
        numpy.  Pristine sessions dispatch through the owning service;
        streamed ones solve by CSNE against the maintained R, and every
        such solve passes the residual fence or escalates refactor ->
        raise."""
        B = np.asarray(B)
        vec = B.ndim == 1
        Bm = B[:, None] if vec else B
        with self._lock:
            m = self._A.shape[0]
            if Bm.ndim != 2 or Bm.shape[0] != m:
                raise DimensionError(
                    f"session.solve: B must have {m} rows (current A is {self._A.shape}), "
                    f"got shape {B.shape}").with_context(routine="gels")
            metrics.inc("fabric.session.solve")
            self._solves += 1
            if self._pristine:
                X = self._svc.submit("gels", self._A, Bm).result()
            else:
                X = self._solve_dirty_locked(Bm)
        return X[:, 0] if vec else X

    def _solve_dirty_locked(self, B: np.ndarray) -> np.ndarray:
        from ..serve.factor_cache import residual_ok

        if self._breakdown_locked():
            self._refactor_locked()
        X = self._csne_locked(B)
        if residual_ok(self._A, B, X, routine="gels"):
            return X
        metrics.inc("fabric.session.fence_fail")
        self._refactor_locked()
        X = self._csne_locked(B)
        if residual_ok(self._A, B, X, routine="gels"):
            return X
        metrics.inc("fabric.session.fence_fail")
        raise NumericalError(
            "session solve failed the residual fence even after a full refactor: "
            "the streamed system is numerically unservable", info=1,
        ).with_context(routine="gels")

    def _csne_locked(self, B: np.ndarray) -> np.ndarray:
        dt = np.result_type(self._A.dtype, B.dtype)
        Bd = torch.as_tensor(np.ascontiguousarray(B, dtype=dt), device=self.device)
        X = _csne(self._Ad.to(Bd.dtype), self._R.to(Bd.dtype), Bd)
        return X.cpu().numpy()
