"""The order of operations of the panel_lu kernel
(``slate_tpu_torch/csrc/lu_kernels.cu``), emulated on the CPU, against
``panel_lu_plain``; and ``panel_lu_plan``, the kernel's launch plan.

The kernel holds a strip of S columns of each row still to pivot on
chip, updates only the strip's columns inside the strip, builds the
strip's pivot rows on the trailing columns by a short chain (U12), and
gives every other row the strip's S updates on the trailing columns at
the strip's end.  Every element still sees the updates
``a <- a - l_rj * u_j[c]`` of the plain version, in increasing j, only
later in time.  What the plain version does to rows that are no longer
eligible (``a - 0 * u``, ``a - l * 0``) changes a value only where u or
l is not finite; the kernel writes those NaNs when it copies the rows
out.  ``_emulate`` below is that schedule, step for step, with the rows
in place and their positions tracked; it must be bitwise equal to the
plain version (NaN where the plain version has NaN, every other value
equal).  The emulation lives here, not in the package: the package has
the kernel and the plain version only.

Tolerance against the JAX package's ``panel_lu_reference``: perm equal,
LU within 1e-12 (float64) / 1e-5 (float32) of max|ref|, as in
tests/test_torch_lu_kernels.py (XLA contracts the update into FMAs)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

LU_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _pick(col, pos, eligible):
    """The pivot among the eligible rows: NaN is the largest magnitude,
    ties go to the smallest position."""
    mag = col.abs()
    nan = eligible & mag.isnan()
    if bool(nan.any()):
        cand = nan
    else:
        cand = eligible & (mag == mag[eligible].max())
    rows = torch.nonzero(cand).flatten()
    return int(rows[torch.argmin(pos[rows])])


def _emulate(panel, pivot=True, act=None, S=32):
    """The kernel's schedule: strips of S columns, the strip cache, the
    pivot row sent with its candidate, U12 and the deferred update."""
    M, nb = panel.shape
    act = M if act is None else act
    kmax = min(M, nb)
    work = panel.clone()
    rowid = torch.arange(M)
    pos = torch.arange(M)              # each row's position in the swap order
    nanl = torch.full((M,), -1)        # row r: NaN in its columns <= nanl[r]
    bad = torch.full((nb,), -1)        # column c: NaN in rows at positions <= bad[c]
    for j0 in range(0, kmax, S):
        j1 = min(j0 + S, nb)
        ns, W = min(j1, kmax) - j0, nb - j1
        cache = work[:, j0:j1].clone()           # rows still to pivot are read
        piv = torch.zeros(ns, j1 - j0, dtype=panel.dtype)
        wins = []
        for jj in range(ns):
            j = j0 + jj
            if pivot:
                w = _pick(cache[:, jj], pos, (pos >= j) & (rowid < act))
            else:
                w = j
            piv[jj] = cache[w]                   # the winner's strip row as sent
            wins.append(w)
            pw = int(pos[w])
            pos[pos == j] = pw
            pos[w] = j
            pv = piv[jj, jj]
            upd = pos > j
            a = cache[upd, jj]
            l = torch.zeros_like(a) if pv == 0 else a / pv
            cache[upd, jj] = l
            cache[upd, jj + 1:] = cache[upd, jj + 1:] - l[:, None] * piv[jj, jj + 1:]
        if W:
            u12 = work[wins, j1:].clone()        # untouched since the strip began
            for jj in range(1, ns):
                for i in range(jj):
                    u12[jj] = u12[jj] - piv[jj, i] * u12[i]
            rest = pos >= j0 + ns
            t = work[rest, j1:]
            for i in range(ns):
                t = t - cache[rest, i:i + 1] * u12[i]
            work[rest, j1:] = t
            work[wins, j1:] = u12                # after the next barrier, in the kernel
        for c in range(j0 + 1, nb):              # u not finite: rows pivoted by then
            for jj in range(min(ns, c - j0)):
                u = piv[jj, c - j0] if c < j1 else u12[jj, c - j1]
                if not math.isfinite(float(u)):
                    bad[c] = j0 + jj
        # l not finite (rows eligible at step j): the row's columns up to j
        hit = (torch.arange(j0, j0 + ns)[None, :] < pos[:, None]) & ~cache[:, :ns].isfinite()
        last = j0 + ns - 1 - hit.flip(1).int().argmax(1)
        nanl = torch.where(hit.any(1), last, nanl)
        rest = pos >= j0 + ns
        work[rest, j0:j1] = cache[rest]
        work[wins, j0:j1] = piv                  # sent before the barrier, in the kernel
    cols = torch.arange(nb)
    nan = (cols[None, :] <= nanl[:, None]) | (pos[:, None] <= bad[None, :])
    work = torch.where(nan, torch.full_like(work, math.nan), work)
    lu = torch.empty_like(work)
    lu[pos] = work
    perm = torch.empty(M, dtype=torch.int32)
    perm[pos] = rowid.to(torch.int32)
    return lu, perm


def _same(a, b):
    """Bitwise equal up to the NaNs' payload: NaN in the same places,
    every other value equal."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.where(a.isnan(), torch.zeros_like(a), a),
        torch.where(b.isnan(), torch.zeros_like(b), b))


def _panel(kind, m, nb, dtype, seed, pivot=True, act=None):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((m, nb))
    if not pivot:
        P += m * np.eye(m, nb)
    if act is not None:
        P[act:] = 0.0  # the recursion's canonical pad
    if kind == "ties":  # column 0 all +-1, column 9 all equal: the first row wins
        P[:, 0] = np.where(P[:, 0] > 0, 1.0, -1.0)
        P[:, 9 % nb] = 0.5
    elif kind == "zero_col":  # a zero pivot column: zero L column, no NaN
        P[:, 3] = 0.0
    elif kind == "nan":  # a NaN and an inf spread as the plain version spreads them
        P[m // 3, 5] = np.nan
        P[m // 2, nb - 3] = np.inf
    return torch.from_numpy(P.astype(dtype))


CASES = [  # kind, m, nb, act, pivot, S
    ("rand", 1000, 77, None, True, 32),
    ("rand", 1000, 77, 900, True, 32),
    ("rand", 1000, 77, 80, True, 32),     # few rows left to pivot at the last strip
    ("rand", 100, 40, 45, True, 8),       # act inside a block's rows, past the fifth strip
    ("rand", 300, 64, None, False, 32),
    ("rand", 40, 90, None, True, 32),     # M < nb: columns past M take every update
    ("rand", 40, 90, None, True, 7),
    ("rand", 512, 256, None, True, 1),
    ("rand", 512, 256, None, True, 8),
    ("rand", 512, 256, None, True, 32),
    ("rand", 200, 33, None, True, 32),    # a last strip of one column
    ("ties", 300, 40, None, True, 32),
    ("ties", 300, 40, None, True, 8),
    ("zero_col", 300, 40, None, True, 8),
    ("nan", 300, 40, None, True, 8),
    ("nan", 300, 40, None, True, 32),
    ("nan", 30, 50, None, True, 8),
    ("nan", 200, 40, None, False, 8),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind,m,nb,act,pivot,S", CASES)
def test_strip_schedule_is_the_plain_version(dtype, kind, m, nb, act, pivot, S):
    P = _panel(kind, m, nb, dtype, seed=m + nb + S, pivot=pivot, act=act)
    lu, perm = _emulate(P, pivot, act, S)
    ref_lu, ref_perm = pk.panel_lu_plain(P, pivot, act)
    assert torch.equal(perm, ref_perm)
    if kind == "nan":
        assert bool(ref_lu.isnan().any())
        assert _same(lu, ref_lu)
    else:
        assert torch.equal(lu, ref_lu)
    if kind == "zero_col":
        assert bool(torch.isfinite(lu).all()) and not bool(lu[4:, 3].any())
    if kind == "ties":
        assert int(perm[0]) == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_strip_schedule_against_the_jax_reference(dtype):
    P = _panel("rand", 400, 70, dtype, seed=11, act=350)
    lu, perm = _emulate(P, True, 350, 16)
    ref_lu, ref_perm = jpk.panel_lu_reference(jnp.asarray(P.numpy()), pivot=True, act=350)
    ref_lu = np.asarray(ref_lu)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_perm))
    tol = LU_RTOL[dtype] * max(float(np.abs(ref_lu).max()), 1.0)
    np.testing.assert_allclose(lu.numpy(), ref_lu, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# panel_lu_plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(16384, 256), (4096, 256), (12288, 200), (262144, 64), (1000, 77), (40, 90),
               (300, 64), (7, 3), (2304, 128), (65536, 256), (1 << 20, 256), (2_000_000, 32)]


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("M,nb", PLAN_SHAPES)
def test_panel_lu_plan_fits(M, nb, itemsize):
    plan = pk.panel_lu_plan(M, nb, itemsize, 132, pk._MAX_SMEM)
    assert 1 <= plan.strip <= min(32, nb)
    assert plan.rows == -(-M // plan.grid)
    smem = pk._panel_lu_smem(plan.rows, plan.strip, nb, itemsize)
    static = pk._pl_static_smem(itemsize)
    assert smem + static <= pk._MAX_SMEM  # the strip fits
    per_sm = min(pk.PL_BLOCKS_PER_SM, pk._SM_SMEM // (smem + static + pk._SMEM_RESERVED))
    assert 1 <= plan.grid <= per_sm * 132  # every block resident at once
    if plan.strip < min(32, nb):  # the widest strip: one column more does not fit
        assert pk._panel_lu_smem(plan.rows, plan.strip + 1, nb, itemsize) + static \
            > pk._MAX_SMEM


def test_panel_lu_plan_main_path_shapes():
    """The recursion's leftmost panel at n = 16384 takes whole strips of
    32 and one block an SM; the tall f64 panel a narrower strip."""
    for itemsize in (8, 4):
        plan = pk.panel_lu_plan(16384, 256, itemsize, 132, pk._MAX_SMEM)
        assert (plan.grid, plan.rows, plan.strip) == (132, 125, 32)
    assert pk.panel_lu_plan(262144, 64, 8, 132, pk._MAX_SMEM).strip < 32


def _old_kernel_takes(M, nb, itemsize, sms):
    """Whether the kernel before the strip cache launched (M, nb): nb
    values and rows x (value + position) of shared memory a block, at
    most two blocks an SM, every block resident."""
    grid = min(2 * sms, max(1, -(-M // 16)))
    while True:
        rows = -(-M // grid)
        smem = nb * itemsize + rows * (itemsize + 4)
        static = 16 * itemsize + 4 * 34
        if smem + static > pk._MAX_SMEM:
            return False
        per_sm = min(2, pk._SM_SMEM // (smem + static + pk._SMEM_RESERVED))
        if grid <= per_sm * sms:
            return True
        grid = per_sm * sms


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("nb", [64, 256])
def test_panel_lu_plan_reaches_one_column_strips(itemsize, nb):
    """S = 1 needs what the earlier kernel needed, so the tallest panel
    it took still plans (S = 1), and one a little taller raises."""
    lo, hi = 1, 1 << 26
    while hi - lo > 1:  # the tallest panel the earlier kernel took
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _old_kernel_takes(mid, nb, itemsize, 132) else (lo, mid)
    M = lo
    plan = pk.panel_lu_plan(M, nb, itemsize, 132, pk._MAX_SMEM)
    assert plan.strip == 1 and plan.grid == 132
    with pytest.raises(ValueError):
        pk.panel_lu_plan(hi + 132 * 64, nb, itemsize, 132, pk._MAX_SMEM)


def test_panel_lu_launch_holds_its_lock(monkeypatch):
    """panel_lu's launch sets the kernel's dynamic shared memory limit to
    its plan's size before launching: two lanes launching plans of other
    sizes at once must not interleave (a launch under the other plan's
    smaller limit fails with cudaErrorInvalidValue), so the wrapper holds
    ``_panel_lu_lock`` across the call.  The CUDA route is rehearsed on
    the CPU with the library call replaced."""
    from slate_tpu_torch.ops.hopper import panel_kernels as pkm

    seen = []

    def launch(name, fn, *args):
        seen.append((name, pkm._panel_lu_lock.locked()))

    monkeypatch.setattr(pkm, "_on_cpu", lambda *a, **k: False)
    monkeypatch.setattr(pkm, "_sms", lambda device: 132)
    monkeypatch.setattr(pkm, "_stream", lambda t: 0)
    monkeypatch.setattr(pkm, "_entry", lambda name, dtype: None)
    monkeypatch.setattr(pkm, "_launch", launch)
    pkm.panel_lu(torch.randn(300, 32, dtype=torch.float64))
    assert seen == [("panel_lu", True)] and not pkm._panel_lu_lock.locked()
