"""slate_tpu_torch.matgen — deterministic test-matrix generation
(reference: matgen/; Philox counter RNG keyed by global (i, j), so every
kind is reproducible for a given seed regardless of tiling).  See
:mod:`.generate` for the kind grammar and :func:`.generate.cond_matrix`
for the specified-condition-number construction the mixed-precision
tests are built on."""

from .generate import (  # noqa: F401
    cond_matrix,
    generate,
    generate_2d,
    generate_matrix,
    generate_tiles,
    parse_kind,
)

__all__ = [
    "cond_matrix",
    "generate",
    "generate_2d",
    "generate_matrix",
    "generate_tiles",
    "parse_kind",
]
