"""The integrity plane's policy resolver in its default (off) form: the
part of the JAX package's ``integrity/policy.py`` that the service
calls at construction.

:func:`from_options` returns None when no policy is set (``False``,
or an empty / "off" spec from the argument, ``SLATE_TPU_INTEGRITY`` or
``Option.ServeIntegrity``), and raises when one is: delivery
certification, lane quarantine, straggler hedging and the ABFT bucket
tag are not ported yet (ROADMAP.md Queue 1 item 7).  The ABFT tag is
never produced here.
"""

from __future__ import annotations

import os

from ..enums import Option
from ..options import get_option

INTEGRITY_ENV = "SLATE_TPU_INTEGRITY"


def _off(spec: str) -> bool:
    return spec.strip().lower() in ("", "0", "off", "false", "no")


def from_options(integrity=None, opts=None):
    """None for an unset policy; ``False`` is the explicit off switch
    (over the env).  A set policy raises NotImplementedError."""
    if integrity is False:
        return None
    if integrity is None:
        integrity = os.environ.get(INTEGRITY_ENV)
        if integrity is None:
            integrity = str(get_option(opts, Option.ServeIntegrity) or "")
    if _off(str(integrity)):
        return None
    raise NotImplementedError(
        f"serve integrity policy {integrity!r} (certification, quarantine, hedging, "
        "ABFT) is not ported yet: ROADMAP.md Queue 1 item 7"
    )
