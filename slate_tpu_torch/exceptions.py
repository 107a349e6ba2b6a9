"""Exception hierarchy (reference: include/slate/Exception.hh).

The MPI/CUDA-specific exception subclasses of the reference map onto a
single DistributedException here: XLA collective failures surface as jax
runtime errors and are wrapped where we can add context.
"""

from __future__ import annotations

from typing import Optional


class SlateError(Exception):
    """Base error for slate_tpu (reference: slate::Exception, Exception.hh).

    Structured context: layers that resolve request futures (serve/) or
    dispatch drivers attach ``routine``, ``bucket`` (BucketKey label),
    ``attempt``, and — on a tenancy-enabled service — ``tenant`` /
    ``priority`` via :meth:`with_context` wherever an exception is
    set, so operators can triage a failure from the exception object
    alone instead of scraping logs.  The fields render in ``str(e)``
    and stay machine-readable on the instance (:meth:`context`).
    """

    routine: Optional[str] = None
    bucket: Optional[str] = None
    attempt: Optional[int] = None
    tenant: Optional[str] = None
    priority: Optional[str] = None  # class name: high | normal | low

    def with_context(
        self,
        routine: Optional[str] = None,
        bucket: Optional[str] = None,
        attempt: Optional[int] = None,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> "SlateError":
        """Attach structured context; returns ``self`` for chaining
        (``raise InvalidInput(msg).with_context(routine="gesv")``)."""
        if routine is not None:
            self.routine = routine
        if bucket is not None:
            self.bucket = bucket
        if attempt is not None:
            self.attempt = int(attempt)
        if tenant is not None:
            self.tenant = tenant
        if priority is not None:
            self.priority = str(priority)
        return self

    def context(self) -> dict:
        """The context fields that are set (empty dict when none are)."""
        return {
            k: v
            for k, v in (
                ("routine", self.routine),
                ("bucket", self.bucket),
                ("attempt", self.attempt),
                ("tenant", self.tenant),
                ("priority", self.priority),
            )
            if v is not None
        }

    def __str__(self) -> str:
        base = super().__str__()
        ctx = self.context()
        if not ctx:
            return base
        tail = " ".join(f"{k}={v}" for k, v in ctx.items())
        return f"{base} [{tail}]"


class DimensionError(SlateError):
    """Shape/conformability violation in a routine's arguments."""


class OptionError(SlateError):
    """Bad Option key/value."""


class DistributedException(SlateError):
    """Failure in the distributed runtime (mesh/collective layer).

    Reference analogue: slate::MpiException (mpi.hh:16-35)."""


class InvalidInput(SlateError):
    """Admission-time rejection: malformed or non-finite operands,
    refused before any queue/compile cost is paid (serve layer)."""


class NumericalError(SlateError):
    """Numerical failure carrying an `info` code, e.g. a non-SPD matrix in
    potrf or a singular U(i,i) in getrf (reference: internal::reduce_info +
    info returns, src/internal/internal_reduce_info.cc)."""

    def __init__(self, message: str, info: int = 0):
        super().__init__(message)
        self.info = int(info)


def slate_assert(cond: bool, message: str = "assertion failed") -> None:
    """Host-side invariant check (reference: slate_assert, Exception.hh)."""
    if not cond:
        raise SlateError(message)
