"""Matmul precision policy.

The JAX package's ``hdot`` is a HIGHEST-precision matmul: LAPACK-parity
residual bounds need true float32 accumulation.  Its counterpart here is
``torch.matmul`` with TF32 off.  A float32 product on a CUDA device runs
in full float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is
False and ``torch.get_float32_matmul_precision()`` is "highest", so
``hdot`` raises when either says otherwise.  ``SLATE_TPU_FAST_F32=1``
opts out of the check, as it opts out of HIGHEST in the JAX package.

The JAX package also splits emulated-float64 contractions at k = 2048
to work around the TPU's float64 emulation; CUDA has native float64, so
that chunking does not apply and is left out.
"""

from __future__ import annotations

import os

import torch

_F32 = (torch.float32, torch.complex64)


def fast_f32() -> bool:
    return os.environ.get("SLATE_TPU_FAST_F32", "0") not in ("", "0")


def check_f32_precision(*tensors: torch.Tensor) -> None:
    """Raise if a float32 CUDA product would run in TF32."""
    if fast_f32():
        return
    if not any(t.is_cuda and t.dtype in _F32 for t in tensors):
        return
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "float32 matmul with torch.backends.cuda.matmul.allow_tf32 = True "
            "would run in TF32; set it False (or SLATE_TPU_FAST_F32=1)"
        )
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {prec!r}, not 'highest'; call "
            "torch.set_float32_matmul_precision('highest') "
            "(or set SLATE_TPU_FAST_F32=1)"
        )


def hdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul (the JAX package's HIGHEST ``hdot``)."""
    check_f32_precision(a, b)
    return torch.matmul(a, b)
