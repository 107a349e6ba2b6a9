"""Silent-data-corruption defense policy: delivery certification,
per-replica integrity scoring with quarantine, and hedged
re-execution knobs (the JAX package's ``integrity/policy.py``).

The serving tier self-heals from crashes, NaN garbage and overload,
but a device that returns a *finite-but-wrong* X passes every one of
those fences.  This module is the control half of the defense
(``integrity/abft.py`` is the math half; ``serve/service.py`` threads
both through dispatch):

* :class:`IntegrityPolicy` — the ``Option.ServeIntegrity`` /
  ``SLATE_TPU_INTEGRITY`` policy: whether (and how often) delivered
  batches are certified, whether gesv/posv buckets are built with
  ABFT checksums, and the hedging/quarantine tuning.  Grammar::

      off                    # no plane (the default; zero overhead)
      full                   # certify every delivered gesv/posv
      sample=0.25            # certify a seeded 25% sample
      full,abft              # + trace checksummed bucket cores
      full,abft,hedge=1.5,cooldown=2.0,threshold=0.6

  keys: ``abft`` (flag), ``hedge=<age/p99 factor>`` (0 disables
  straggler hedging), ``cooldown=<s>`` (quarantine -> probe delay),
  ``threshold=<0..1>`` (failure-EWMA quarantine trip point),
  ``alpha=<0..1>`` (EWMA smoothing), ``retries=<n>`` (certificate
  re-executions before the last-resort direct solve).

* :class:`IntegrityScore` — one replica lane's certificate-failure
  EWMA and quarantine state machine.  **Distinct from the circuit
  breaker by design**: the breaker sees *exceptions and NaNs* (a path
  that fails loudly), the score sees *certified-wrong answers* (a
  device that fails silently).  Lifecycle mirrors the breaker's so
  operators reason about one shape: ``ok`` --EWMA over threshold-->
  ``quarantined`` (admission steers new traffic to healthy lanes)
  --cooldown elapsed--> the lane is selectable again and the next
  certified delivery is the probe: pass -> ``ok`` (recovered), fail ->
  re-quarantined with a fresh cooldown.  One bad chip degrades
  capacity, never answers.
"""

from __future__ import annotations

import os
import random
from typing import Optional

from ..aux import sync

INTEGRITY_ENV = "SLATE_TPU_INTEGRITY"

#: certification modes (the policy grammar's head token)
MODE_SAMPLE = "sample"
MODE_FULL = "full"

#: quarantine states (health()["integrity"] vocabulary)
SCORE_OK = "ok"
SCORE_QUARANTINED = "quarantined"


class IntegrityPolicy:
    """Parsed ``SLATE_TPU_INTEGRITY`` policy (module docstring has the
    grammar).  ``should_check()`` is the per-delivery sampling gate —
    seeded, so a sampled deployment's check pattern replays."""

    def __init__(
        self,
        mode: str = MODE_FULL,
        sample_p: float = 1.0,
        abft: bool = False,
        hedge_factor: float = 1.0,
        hedge_min_age_s: float = 0.01,
        quarantine_cooldown_s: float = 5.0,
        quarantine_threshold: float = 0.6,
        quarantine_alpha: float = 0.5,
        cert_retry_max: int = 2,
        seed: int = 0,
    ):
        if mode not in (MODE_SAMPLE, MODE_FULL):
            raise ValueError(
                f"unknown integrity mode {mode!r} (off|sample=<p>|full)"
            )
        if mode == MODE_SAMPLE and not 0.0 < sample_p <= 1.0:
            raise ValueError(
                f"integrity sample probability out of (0, 1]: {sample_p}"
            )
        if not 0.0 < quarantine_alpha <= 1.0:
            raise ValueError(f"integrity alpha out of (0, 1]: {quarantine_alpha}")
        if not 0.0 < quarantine_threshold <= 1.0:
            raise ValueError(
                f"integrity threshold out of (0, 1]: {quarantine_threshold}"
            )
        self.mode = mode
        self.sample_p = float(sample_p)
        self.abft = bool(abft)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_age_s = float(hedge_min_age_s)
        self.quarantine_cooldown_s = float(quarantine_cooldown_s)
        self.quarantine_threshold = float(quarantine_threshold)
        self.quarantine_alpha = float(quarantine_alpha)
        self.cert_retry_max = max(int(cert_retry_max), 0)
        self._rng = random.Random(seed)
        self._rng_lock = sync.Lock(name="integrity.IntegrityPolicy._rng_lock")

    def should_check(self) -> bool:
        """Does this delivery get a certificate?  ``full`` -> always;
        ``sample`` -> a seeded Bernoulli draw (lock-guarded: every
        worker thread samples from one replayable stream)."""
        if self.mode == MODE_FULL:
            return True
        with self._rng_lock:
            return self._rng.random() < self.sample_p

    def describe(self) -> str:
        head = (
            MODE_FULL if self.mode == MODE_FULL
            else f"sample={self.sample_p:g}"
        )
        return head + (",abft" if self.abft else "")

    def new_score(self) -> "IntegrityScore":
        """One replica lane's quarantine tracker under this policy."""
        return IntegrityScore(
            alpha=self.quarantine_alpha,
            threshold=self.quarantine_threshold,
            cooldown_s=self.quarantine_cooldown_s,
        )


def parse_spec(spec: str) -> Optional[IntegrityPolicy]:
    """Parse the policy grammar; ``""``/``off``/``0`` -> None (plane
    disabled — the service then pays one ``is None`` branch)."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        return None
    kw: dict = {}
    for i, item in enumerate(spec.split(",")):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        k, v = k.strip().lower(), v.strip()
        if i == 0:
            # head token: the certification mode
            if k == MODE_FULL and not sep:
                kw["mode"] = MODE_FULL
                continue
            if k == MODE_SAMPLE and sep:
                kw["mode"] = MODE_SAMPLE
                kw["sample_p"] = float(v)
                continue
            raise ValueError(
                f"{INTEGRITY_ENV}={spec!r}: expected off|sample=<p>|full, "
                f"got {item!r}"
            )
        if k == "abft" and not sep:
            kw["abft"] = True
        elif k == "hedge" and sep:
            kw["hedge_factor"] = float(v)
        elif k == "cooldown" and sep:
            kw["quarantine_cooldown_s"] = float(v)
        elif k == "threshold" and sep:
            kw["quarantine_threshold"] = float(v)
        elif k == "alpha" and sep:
            kw["quarantine_alpha"] = float(v)
        elif k == "retries" and sep:
            kw["cert_retry_max"] = int(v)
        elif k == "seed" and sep:
            kw["seed"] = int(v)
        else:
            raise ValueError(
                f"{INTEGRITY_ENV}={spec!r}: unknown key {item!r} "
                "(abft|hedge=|cooldown=|threshold=|alpha=|retries=|seed=)"
            )
    return IntegrityPolicy(**kw)


def from_options(integrity=None, opts=None) -> Optional[IntegrityPolicy]:
    """Resolve the service's policy: an explicit
    :class:`IntegrityPolicy` or spec string wins, ``False`` is the
    explicit off-switch (overriding the env — the baseline/AB pattern
    every serve plane follows), ``None`` resolves
    ``SLATE_TPU_INTEGRITY`` then ``Option.ServeIntegrity``."""
    if integrity is False:
        return None
    if isinstance(integrity, IntegrityPolicy):
        return integrity
    if integrity is not None:
        return parse_spec(str(integrity))
    spec = os.environ.get(INTEGRITY_ENV)
    if spec is None:
        from ..enums import Option
        from ..options import get_option

        spec = str(get_option(opts, Option.ServeIntegrity) or "")
    return parse_spec(spec)


def residual_certificate(routine: str, A, X, B) -> bool:
    """Certify one delivered solve AGAINST ITS CONTRACT: the
    factor-cache residual fence ``max|A X - B| <= sqrt(eps)(|A||X| +
    |B|)`` with posv's lower triangle symmetrized first (the api
    contract — "solves with the LOWER triangle of A" — mirrored from
    ``serve/service._cert_operand``: certifying against junk above the
    diagonal would fail every verdict on a correct X).  Routines
    without a residual contract (gels) pass vacuously.  The check runs in the precision the solve was SERVED
    at (X's dtype): the caller may hold float64 operands while the
    service computes in float32, and judging a float32 solve against
    float64's eps would fail every correct delivery."""
    import numpy as np

    if routine not in ("gesv", "posv"):
        return True
    from ..serve.factor_cache import residual_ok

    X = np.asarray(X)
    A = np.asarray(A, dtype=X.dtype)
    B = np.asarray(B, dtype=X.dtype)
    if B.ndim == 1:
        B = B[:, None]
    if X.ndim == 1:
        X = X[:, None]
    if routine == "posv":
        A = np.tril(A) + np.conj(np.tril(A, -1)).T
    return residual_ok(A, B, X)


class IntegrityScore:
    """One lane's certificate-failure EWMA + quarantine state machine
    (class docstring up top: the breaker's recoverable shape, fed by
    silent-wrong-answer evidence instead of exceptions).  Self-locked:
    workers observe from delivery loops, admission and health() read
    concurrently."""

    def __init__(
        self,
        alpha: float = 0.5,
        threshold: float = 0.6,
        cooldown_s: float = 5.0,
    ):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.cooldown_s = float(cooldown_s)
        # sync.Lock: plain threading.Lock unless the race plane is on
        self._lock = sync.Lock(name="integrity.IntegrityScore._lock")
        # the EWMA + quarantine state machine: workers observe from
        # delivery loops while admission and health() read concurrently
        # — the annotations are ground truth for the lock-discipline
        # and race-guarded-by lint rules
        self.ewma = 0.0  # guarded by: _lock
        self.state = SCORE_OK  # guarded by: _lock
        self.quarantined_at = 0.0  # guarded by: _lock
        self.quarantines = 0  # lifetime transitions  # guarded by: _lock

    def observe(self, ok: bool, now: float) -> Optional[str]:
        """Fold one certificate verdict in; returns the transition it
        caused (``"quarantined"`` / ``"recovered"``) or None.  While
        quarantined and cooling down, verdicts only extend or hold the
        quarantine (requests already queued on the lane keep being
        served — quarantine is an admission-side steer, not a stop);
        the first PASSING verdict after the cooldown is the probe that
        recovers the lane, exactly like a half-open breaker's probe."""
        with self._lock:
            if self.state == SCORE_QUARANTINED:
                if not ok:
                    # failed probe (or in-cooldown traffic still wrong):
                    # fresh cooldown, stay quarantined
                    self.quarantined_at = now
                    self.ewma = 1.0
                    return None
                if now - self.quarantined_at >= self.cooldown_s:
                    self.state = SCORE_OK
                    self.ewma = 0.0
                    return "recovered"
                return None
            self.ewma = (
                (1.0 - self.alpha) * self.ewma
                + self.alpha * (0.0 if ok else 1.0)
            )
            if not ok and self.ewma > self.threshold:
                self.state = SCORE_QUARANTINED
                self.quarantined_at = now
                self.quarantines += 1
                return "quarantined"
            return None

    def suspect(self) -> bool:
        """True while the lane is quarantined (cooldown elapsed or
        not): a sampled certification policy must check EVERY delivery
        from a suspect lane — the post-cooldown probe has to be the
        very next delivery, not the next sampled one ~1/p deliveries
        later."""
        with self._lock:
            return self.state == SCORE_QUARANTINED

    def excluded(self, now: float) -> bool:
        """Admission-side exclusion window: quarantined AND cooling
        down (one definition with the probe eligibility, the Breaker
        ``cooling_down`` pattern — past the cooldown the lane must be
        selectable again or no probe could ever reach it)."""
        with self._lock:
            return (
                self.state == SCORE_QUARANTINED
                and now - self.quarantined_at < self.cooldown_s
            )

    def snapshot(self, now: float) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "ewma": round(self.ewma, 4),
                "quarantines": self.quarantines,
                "quarantined_for_s": (
                    round(now - self.quarantined_at, 3)
                    if self.state == SCORE_QUARANTINED else None
                ),
            }
