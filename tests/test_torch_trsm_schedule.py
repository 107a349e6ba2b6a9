"""The host-side schedule of the Hopper trsm pair (``trsm_step_plan``,
``trsm_kernel_launches``, ``trsm_launch_table``): every row solved once,
every update reading only solved rows and only the stated triangle, B
read exactly on a row's first update, the ragged last block covered;
the launch table the kernel takes decodes back to the plan; and that
table, run step by step in numpy with the kernel's indexing and NaN in
the unread triangle and in X's unwritten rows, agrees with the JAX
package's trsm references.

The tolerance of the numeric check is ``50 n eps max|ref|``, as in
tests/test_pallas_panels.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

SIZES = [1, 5, 127, 128, 129, 300, 512, 1000]


@pytest.mark.parametrize("n,nrhs,want", [
    (0, 4, 0), (7, 0, 0), (1, 1, 1), (127, 3, 1), (128, 512, 1), (129, 1, 2),
    (1000, 7, 8), (2100, 3, 17), (16384, 512, 128), (16385, 1, 129),
])
def test_trsm_kernel_launches(n, nrhs, want):
    assert pk.trsm_kernel_launches(n, nrhs) == want
    if n and nrhs:
        assert want == len(pk.trsm_step_plan(n, True)) == len(pk.trsm_step_plan(n, False))


def _stored(rows, cols, transposed):
    """The stored elements (i, j) of T that op(T)[rows, cols] reads."""
    r, c = np.meshgrid(np.arange(*rows), np.arange(*cols), indexing="ij")
    return (c, r) if transposed else (r, c)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lower,transposed", [(True, False), (False, False), (False, True),
                                              (True, True)])
def test_trsm_step_plan_covers_and_reads_one_triangle(n, lower, transposed):
    """op(T)'s triangle is ``lower``; with ``transposed`` the stored T
    holds the other one.  Every row is solved once, after it has taken
    every row solved before it exactly once; each update reads only rows
    solved by earlier launches and only op(T) strictly inside the stored
    triangle; the owner takes one block a launch, the far row blocks at
    most TRSM_D; B is read on a row block's first update and only then."""
    steps = pk.trsm_step_plan(n, lower)
    kb, d = pk.TRSM_KB, pk.TRSM_D
    solved = np.zeros(n, int)
    taken = np.zeros((n, n), int)  # taken[i, j]: row i took solved row j
    stored_lower = lower != transposed
    for s, st in enumerate(steps):
        a, b = st.solve
        assert 0 <= a < b <= n and b - a <= kb and a % kb == 0
        assert len(st.updates) == (0 if s == 0 else 1 + -(-(len(steps) - 1 - s) // d))
        written = np.zeros(n, int)
        for k, (rows, src, from_b) in enumerate(st.updates):
            assert solved[src[0]:src[1]].all()  # read only rows solved earlier
            assert not solved[rows[0]:rows[1]].any()
            assert src[1] - src[0] <= (kb if k == 0 else d * kb)
            assert from_b == (not taken[rows[0]:rows[1]].any())
            if k == 0:
                assert rows == st.solve
            i, j = _stored(rows, src, transposed)
            assert ((i > j) if stored_lower else (i < j)).all()  # strictly in the triangle
            taken[rows[0]:rows[1], src[0]:src[1]] += 1
            written[rows[0]:rows[1]] += 1
        assert written.max() <= 1  # no two blocks of a launch write the same rows
        assert (taken[a:b] == solved[None, :]).all()  # every solved row, exactly once
        assert bool(st.updates) == bool(taken[a:b].any())  # no update: the solve reads B
        solved[a:b] += 1
        # the sweep order: top-down for lower, bottom-up for upper
        assert not solved[:a].any() if not lower else solved[:a].all()
    assert (solved == 1).all()
    last = max(steps, key=lambda st: st.solve[1])
    assert last.solve[1] == n and last.solve[1] - last.solve[0] == (n - 1) % kb + 1


def _decode(n, row):
    """One launch of the kernel's table, as the kernel reads it: the
    owner's (rows, sources, reads B) and the far row blocks'."""
    f = dict(zip(pk.TRSM_TABLE_FIELDS, row))
    span = lambda r0: (r0, min(n, r0 + pk.TRSM_KB))  # noqa: E731
    own = (span(f["own_r0"]), (f["own_k0"], f["own_k0"] + f["own_kw"]), bool(f["reads_b"] & 1))
    far = [(span(f["far_r0"] + y * f["far_step"]), (f["far_k0"], f["far_k0"] + f["far_kw"]),
            bool(f["reads_b"] & 2)) for y in range(f["far_count"])]
    return own, far


@pytest.mark.parametrize("n", SIZES + [16384, 16385])
@pytest.mark.parametrize("lower", [True, False])
def test_trsm_launch_table_is_the_plan(n, lower):
    """The table the kernel takes holds every update of the plan, in its
    order, and its owner solves the plan's row block."""
    table = pk.trsm_launch_table(n, lower)
    steps = pk.trsm_step_plan(n, lower)
    assert len(table) == len(steps) == pk.trsm_kernel_launches(n)
    for row, st in zip(table, steps):
        assert len(row) == len(pk.TRSM_TABLE_FIELDS)
        own, far = _decode(n, row)
        assert own[0] == st.solve
        if st.updates:
            assert [own] + far == [tuple(u) for u in st.updates]
        else:  # the first launch: nothing to take, the solve reads B
            assert own[1][0] == own[1][1] and own[2] and not far


def _run_table(Top, B, lower, unit):
    """The kernel's arithmetic in numpy, launch by launch from the table:
    each block's update (R = S - op(T)[rows, src] X[src], S = B or X as
    the table says), then the owner's diagonal block by column
    substitution.  X starts as NaN, so a read of a row not yet written
    poisons the result; only the triangle of op(T) (and the diagonal,
    unless ``unit``) is read."""
    n = Top.shape[0]
    X = np.full_like(B, np.nan)
    for row in pk.trsm_launch_table(n, lower):
        own, far = _decode(n, row)
        for (u0, u1), (s0, s1), from_b in [own] + far:
            S = B if from_b else X
            X[u0:u1] = S[u0:u1] - Top[u0:u1, s0:s1] @ X[s0:s1]
        a, b = own[0]
        order = range(a, b) if lower else range(b - 1, a - 1, -1)
        for k in order:
            if not unit:
                X[k] = X[k] / Top[k, k]
            rest = slice(k + 1, b) if lower else slice(a, k)
            X[rest] -= np.outer(Top[rest, k], X[k])
    return X


@pytest.mark.parametrize("n,nrhs", [(129, 3), (300, 1), (385, 65), (700, 2)])
@pytest.mark.parametrize("mode", ["lower", "unit", "upper", "transposed"])
def test_trsm_plan_solves_like_the_jax_reference(n, nrhs, mode):
    rng = np.random.default_rng(n + nrhs)
    lower, unit = mode in ("lower", "unit"), mode == "unit"
    off = rng.standard_normal((n, n)) * 0.3 / np.sqrt(n)
    low = np.tril(off, -1) + np.diag(np.ones(n) if unit else 2.0 + rng.random(n))
    b = rng.standard_normal((n, nrhs))
    if lower:
        stored, ref = low, jpk.trsm_lower_reference(jnp.asarray(low), jnp.asarray(b), unit=unit)
    else:
        stored = low if mode == "transposed" else np.ascontiguousarray(low.T)
        ref = jpk.trsm_upper_reference(jnp.asarray(low.T), jnp.asarray(b))
    # NaN where the kernel must not read: the other triangle (and the unit diagonal)
    keep = np.tril(np.ones((n, n), bool), -1 if unit else 0)
    if not lower and mode != "transposed":
        keep = keep.T
    packed = np.where(keep, stored, np.nan)
    Top = packed.T if mode == "transposed" else packed
    got = _run_table(Top, b, lower, unit)
    ref = np.asarray(ref)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=50 * n * np.finfo(float).eps
                               * max(np.abs(ref).max(), 1.0))
