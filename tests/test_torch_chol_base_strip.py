"""The order of operations of the chol_base kernel
(``slate_tpu_torch/csrc/panel_kernels.cu``), emulated on the CPU, against
``chol_base_plain`` and the JAX package's ``chol_base_pallas``
(interpret mode) and ``chol_base_reference``; and ``chol_base_smem``,
the kernel's shared memory.

The kernel walks the block in strips of 32 columns.  Warp 0 factors the
first diagonal block from the block itself.  Then, for each strip, a
thread a row solves the panel below the factored diagonal block
(x L_kk^T = a_r, right-looking: column c is final once it is multiplied
by 1 / L_cc, then subtracted from the later columns); the solved panel P
stays in shared memory.  The trailing lower triangle is updated a 32 x 32
tile at a time, C -= P_I P_J^T over the strip's 32 columns, tiles on the
diagonal read and written on and below it only; warp 0 takes the next
diagonal tile (lookahead; in float32 warps 0-3 share its update),
factors it from the updated tile (one reciprocal square root a column,
the multipliers scaled by it) and leaves it, with its reciprocal
pivots, for the next strip's panel.
``_emulate`` below is that schedule at strip level.  The emulation lives
here, not in the package: the package has the kernel and the plain
version only.

The kernel's order is not the plain version's (the updates of a strip
reach an element together, products are rounded apart, and 1 / sqrt
replaces sqrt and the divide), so the comparison is a tolerance:
elementwise 10 sqrt(b) eps (|L||L|^T)_ij / L_jj on the lower triangle,
the rounding bound of the length-b sums that make L_ij = (G_ij - sum_k
L_ik L_jk) / L_jj, as ``chip_smoke.py`` phase 2 holds the kernel to.
The strict upper triangle passes through bit for bit; it holds NaN here,
so a read of it would show in the lower triangle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

S = 32
TOL_C = 10.0
BLOCKS = [1, 31, 32, 33, 77, 256]
DTYPES = [np.float64, np.float32]


def _factor(d, w):
    """Warp 0's factor of the w x w block d (lower triangle, zero above):
    L and the reciprocal pivots."""
    d = d[:w, :w].clone()
    rd = torch.zeros(w, dtype=d.dtype)
    for c in range(w):
        r = torch.rsqrt(d[c, c])
        rd[c] = r
        l = d[c + 1:, c] * r
        d[c, c] = d[c, c] * r
        d[c + 1:, c] = l
        d[c + 1:, c + 1:] -= torch.tril(torch.outer(l, l))
    return d, rd


def _emulate(G):
    b = G.shape[0]
    nbk = -(-b // S)
    a = G.clone()
    low = lambda r0, c0, n: torch.ones(n, n, dtype=torch.bool).tril() if r0 == c0 else \
        torch.ones(n, n, dtype=torch.bool)  # noqa: E731
    P = torch.zeros(nbk * S, S, dtype=G.dtype)  # rows past b stay zero
    w = min(S, b)
    L, rd = _factor(torch.tril(a[:w, :w]), w)
    a[:w, :w] = torch.where(low(0, 0, w), L, a[:w, :w])
    for k in range(nbk - 1):
        j0, j1 = k * S, (k + 1) * S
        # b. the panel: right-looking, one reciprocal a column
        X = a[j1:, j0:j1].clone()
        for c in range(S):
            X[:, c] = X[:, c] * rd[c]
            X[:, c + 1:] -= X[:, c:c + 1] * L[c + 1:, c]
        a[j1:, j0:j1] = X
        P[j1:b] = X
        # c. the trailing tiles, row by row; (0, 0) is warp 0's lookahead
        nt = nbk - 1 - k
        for i in range(nt):
            for j in range(i + 1):
                r0, c0 = j1 + i * S, j1 + j * S
                rows, cols = min(S, b - r0), min(S, b - c0)
                mask = low(r0, c0, S)[:rows, :cols]
                t = torch.where(mask, a[r0:r0 + rows, c0:c0 + cols], 0.0)
                for kk in range(S):
                    t = t - torch.outer(P[r0:r0 + rows, kk], P[c0:c0 + cols, kk])
                if i == 0:  # the next diagonal block, factored at once
                    t, rd = _factor(t, rows)
                    L = t
                a[r0:r0 + rows, c0:c0 + cols] = torch.where(mask, t, a[r0:r0 + rows,
                                                                        c0:c0 + cols])
    return a


def _spd(b, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, b))
    g = (x @ x.T + b * np.eye(b)).astype(dtype)
    return g, torch.from_numpy(g + np.triu(np.full((b, b), np.nan, dtype), 1))


def _ratio(got, ref):
    """max |got - ref| / (TOL_C sqrt(b) eps (|L||L|^T)_ij / L_jj) over the
    lower triangle (NaN, and so a failure, where got is not finite)."""
    got, L = np.tril(np.asarray(got, np.float64)), np.tril(np.asarray(ref, np.float64))
    b = L.shape[0]
    scale = (np.abs(L) @ np.abs(L).T) / np.abs(np.diag(L))[None, :]
    limit = TOL_C * np.sqrt(b) * np.finfo(ref.dtype).eps * scale
    return float(np.max(np.where(np.tri(b, dtype=bool), np.abs(got - L) / limit, 0.0)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", BLOCKS)
def test_strip_schedule_against_the_plain_version(dtype, b):
    g, G = _spd(b, dtype, seed=b)
    got = _emulate(G)
    ref = pk.chol_base_plain(torch.from_numpy(g))
    assert torch.equal(torch.triu(got, 1).isnan(), torch.triu(torch.ones(b, b), 1).bool())
    assert _ratio(got.numpy(), ref.numpy()) <= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", BLOCKS)
def test_strip_schedule_against_the_jax_kernel(dtype, b):
    g, G = _spd(b, dtype, seed=b + 1)
    got = _emulate(G).numpy()
    for ref in (np.asarray(jpk.chol_base_pallas(jnp.asarray(g), interpret=True)),
                np.asarray(jpk.chol_base_reference(jnp.asarray(g)))):
        assert _ratio(got, ref.astype(dtype)) <= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [77, 256])
def test_strip_schedule_non_spd_gives_nan(dtype, b):
    """A negative pivot in the third strip: NaN reaches the lower triangle
    from there on, as the plain version's does."""
    g, _ = _spd(b, dtype, seed=3)
    g[70, 70] = -1.0
    got = _emulate(torch.from_numpy(g))
    ref = pk.chol_base_plain(torch.from_numpy(g))
    assert bool(torch.tril(ref).isnan().any())
    assert bool(got[70:, 70].isnan().all())
    assert bool(torch.isfinite(got[:70, :70]).all())
    np.testing.assert_array_equal(np.triu(got.numpy(), 1), np.triu(g, 1))


@pytest.mark.parametrize("itemsize,largest,before", [(8, 896, 848), (4, 1792, 1728)])
def test_chol_base_smem_takes_every_block_taken_before(itemsize, largest, before):
    """The panel fits up to ``largest``, past the earlier kernel's
    (32 + b) x 33 values (``before``)."""
    assert (32 + before) * 33 * itemsize <= pk._MAX_SMEM < (33 + before) * 33 * itemsize
    assert pk.chol_base_smem(largest, itemsize) <= pk._MAX_SMEM
    assert pk.chol_base_smem(largest + 1, itemsize) > pk._MAX_SMEM
    assert all(pk.chol_base_smem(b, itemsize) <= pk._MAX_SMEM for b in range(1, before + 1))
