"""Lock factories and race-plane probes of the serve tier: the default
(unchecked) form of the JAX package's ``aux/sync.py``.

``Lock`` / ``RLock`` / ``Condition`` return plain ``threading``
objects; the ``name=`` each caller passes is the identity the JAX
package's lock-order checker keys on, kept here so the call sites read
the same.  ``guarded``, ``hb_publish`` and ``hb_receive`` are no-ops.
The checked runtime (lock-order graph, lockset and happens-before
probes, ``SLATE_TPU_SYNC_CHECK``) waits for the serve planes
(ROADMAP.md Queue 1 item 7b).
"""

from __future__ import annotations

import threading
from typing import Optional


def Lock(name: Optional[str] = None):
    """A plain ``threading.Lock``."""
    return threading.Lock()


def RLock(name: Optional[str] = None):
    """A plain ``threading.RLock``."""
    return threading.RLock()


def Condition(name: Optional[str] = None):
    """A plain ``threading.Condition`` over its own RLock."""
    return threading.Condition()


def guarded(obj, field: str, write: bool = True) -> None:
    """Lockset probe of a ``guarded by`` field (no-op here)."""


def hb_publish(obj) -> None:
    """Happens-before publish at a hand-off (no-op here)."""


def hb_receive(obj) -> None:
    """Happens-before receive at a hand-off (no-op here)."""
