"""The serve tier's admission plane in its default (off) form: the
part of the JAX package's ``serve/admission.py`` that the service
calls on every submit.

:func:`resolve_identity` is the one normaliser of a submit-time
(tenant, priority) pair, so a tag the plane would refuse fails the same
way with the plane off.  :meth:`AdmissionControl.from_options` returns
None when no tenant and no adaptive window are configured — the
service then keeps its plain per-lane queue — and raises when either
is, because tenancy, quotas, priority shedding and the adaptive batch
window are not ported yet (ROADMAP.md Queue 1 item 7b).  Nothing is
silently ignored.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ..enums import Option
from ..options import get_option
from .buckets import DEFAULT_TENANT, PRIO_NORMAL, check_priority

TENANTS_ENV = "SLATE_TPU_TENANTS"
ADAPTIVE_ENV = "SLATE_TPU_ADAPTIVE"


def resolve_identity(tenant, priority) -> Tuple[str, int]:
    """Normalise a submit-time (tenant, priority) pair: tenant defaults
    to the anonymous pool, priority to "normal"; an empty tenant id or
    an unknown priority raises."""
    t = DEFAULT_TENANT if tenant is None else str(tenant)
    if not t:
        raise ValueError("tenant id must be a non-empty string")
    p = PRIO_NORMAL if priority is None else check_priority(priority)
    return t, p


def _env_adaptive_on() -> bool:
    """``SLATE_TPU_ADAPTIVE``: "1"/"true"/"on" or a positive budget in
    seconds arm the window; "", "0", "false", "off" or a budget <= 0 do
    not (the JAX package's reading)."""
    v = os.environ.get(ADAPTIVE_ENV, "").strip().lower()
    if not v or v in ("0", "false", "off"):
        return False
    if v in ("1", "true", "on"):
        return True
    try:
        return float(v) > 0
    except ValueError:
        raise ValueError(
            f"{ADAPTIVE_ENV}={v!r}: expected 1 or a p99 budget in seconds"
        ) from None


class AdmissionControl:
    """Placeholder of the admission plane: only its resolver is ported."""

    @staticmethod
    def from_options(opts=None, tenants=None,
                     adaptive: Optional[bool] = None) -> Optional["AdmissionControl"]:
        """None when nothing is configured (explicit arguments, then the
        Serve* options, then the env); raises NotImplementedError when a
        tenant spec or the adaptive window is."""
        if tenants is None:
            tenants = (get_option(opts, Option.ServeTenantQuota)
                       or os.environ.get(TENANTS_ENV, ""))
        configured = bool(tenants.strip()) if isinstance(tenants, str) else bool(tenants)
        if adaptive is None:
            adaptive = bool(get_option(opts, Option.ServeAdaptiveWindow)
                            or _env_adaptive_on())
        if not configured and not adaptive:
            return None
        raise NotImplementedError(
            "serve admission plane (tenants, quotas, priority shedding, adaptive "
            "batch window) is not ported yet: ROADMAP.md Queue 1 item 7b"
        )
