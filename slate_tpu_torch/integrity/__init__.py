"""slate_tpu_torch.integrity — silent-data-corruption defense for the
serve tier (the JAX package's ``integrity``).

* ``abft`` — Huang & Abraham-style checksum relations verified on the
  device against the factors (post-factor) and the solution
  (post-trsm) at O(n^2) extra work, the host-side delivery
  certificate, and the flop accounting of the overhead.
* ``policy`` — the ``SLATE_TPU_INTEGRITY`` / ``Option.ServeIntegrity``
  certification policy (``off | sample=<p> | full``, ``,abft`` for
  checksummed bucket cores) and the per-replica
  :class:`~slate_tpu_torch.integrity.policy.IntegrityScore` quarantine
  state machine.

The enforcement lives in ``serve/service.py``: a failed certificate
never reaches the client (the request re-executes, hedged to another
replica when one exists), quarantined lanes shed new admissions until a
probe passes, and every event is counted (``serve.integrity.*``,
``serve.hedge.*``).
"""

from __future__ import annotations

from .abft import (  # noqa: F401
    ABFT_BAD,
    ABFT_TAG,
    abft_flops,
    checksum_certificate,
    encode,
    encode_rhs,
    overhead_ratio,
)
from .policy import (  # noqa: F401
    INTEGRITY_ENV,
    IntegrityPolicy,
    IntegrityScore,
    from_options,
    parse_spec,
    residual_certificate,
)

__all__ = [
    "ABFT_BAD", "ABFT_TAG", "abft_flops", "checksum_certificate",
    "encode", "encode_rhs", "overhead_ratio",
    "INTEGRITY_ENV", "IntegrityPolicy", "IntegrityScore",
    "from_options", "parse_spec", "residual_certificate",
]
