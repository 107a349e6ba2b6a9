"""Port parity: the masked ``tile_norms`` contract and the ``genorm``
schedule built on it, against the JAX package, on the CPU.

* ``tile_norms_plain`` with per-tile counts (``rows``, ``cols``),
  ``scale`` and ``skip``, on signed stacks with NaN and 1e300 in the
  padding, against the JAX package's Pallas kernel in interpret mode and
  its jnp twin applied to ``jnp.where(mask, |T|, 0)`` (and ``/ safe``);
* ``genorm`` (every norm and scope) on a ragged 37 x 29 layout in tiles
  of 8 on a 2 x 2 grid, with NaN or 1e300 written into the padding of
  both storages, against ``slate_tpu.internal.norms.genorm``; a caller's
  mask takes the JAX package's route;
* the Frobenius norm on both sides of each edge of its overflow /
  underflow guard, in float32 and float64, and on a zero matrix, one NaN
  and one Inf, each against the JAX ``genorm`` on the same storage, with
  the branch taken checked through the ``skip`` flag.

Tolerance: max norms and per-tile maxima bitwise equal; sums within
``20 k eps max|ref|`` (k the length of the sum); Fro relatively within
``20 k eps`` (k = 37), since the guard's small norms are far below 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.internal import norms as jn
from slate_tpu.ops.pallas import kernels as jk
from slate_tpu.parallel import layout as jl
from slate_tpu_torch.internal import norms as tn
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.parallel import layout as tl

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]
P, Q, MB, NB = 2, 3, 16, 24  # a 6-tile stack
LAYOUT = dict(m=37, n=29, mb=8, nb=8, p=2, q=2)


def _close(got, ref, k, dtype):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = 20 * k * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _close_rel(got, ref, dtype, k=37):
    got, ref = float(got), float(ref)
    if np.isnan(ref):
        assert np.isnan(got), (got, ref)
        return
    assert abs(got - ref) <= 20 * k * np.finfo(dtype).eps * abs(ref), (got, ref)


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


def _stack(dtype, seed, fill):
    """A signed (P Q, MB, NB) stack, ragged counts (tile 0 full, one tile
    row and one tile column empty of rows / columns), ``fill`` in the
    padding; returns (stack, rows, cols, the (P Q, MB, NB) mask)."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((P * Q, MB, NB)).astype(dtype)
    rows = np.array([MB, 5], dtype=np.int32)
    cols = np.array([NB, 0, 13], dtype=np.int32)
    rm = np.arange(MB)[None, :] < rows[:, None]
    cm = np.arange(NB)[None, :] < cols[:, None]
    mask = (rm[:, None, :, None] & cm[None, :, None, :]).reshape(P * Q, MB, NB)
    T[~mask] = fill
    return T, rows, cols, mask


def _jax_stats(a, kind):
    """(the Pallas kernel in interpret mode, its jnp twin) on a."""
    a = jnp.asarray(a)
    if kind == "max_sumsq":
        pals = [np.asarray(jk.tile_norms_pallas(a, k, interpret=True)) for k in ("max", "fro_sumsq")]
        refs = [np.asarray(jk.tile_norms_reference(a, k)) for k in ("max", "fro_sumsq")]
        return np.stack(pals, axis=1), np.stack(refs, axis=1)
    return (np.asarray(jk.tile_norms_pallas(a, kind, interpret=True)),
            np.asarray(jk.tile_norms_reference(a, kind)))


CASES = ["max", "fro_sumsq", "one", "inf", "max_sumsq", "fro_scaled", "fro_skipped",
         "fro_not_skipped"]


@pytest.mark.parametrize("fill", [np.nan, 1e300])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_counts_scale_skip_match_jax_kernel(case, dtype, fill):
    with np.errstate(over="ignore"):  # 1e300 is inf in float32: still padding
        fill = np.asarray(fill).astype(dtype)
    T, rows, cols, mask = _stack(dtype, 3, fill)
    kind = "fro_sumsq" if case.startswith("fro_") else case
    absA = np.where(mask, np.abs(T), 0).astype(dtype)
    safe = dtype(np.abs(absA).max() * 1.5)
    extra = {}
    if case != kind:
        absA = absA / safe
        extra["scale"] = torch.tensor(safe, dtype=torch.from_numpy(T).dtype)
    if case in ("fro_skipped", "fro_not_skipped"):
        extra["skip"] = torch.tensor(case == "fro_skipped")
    pal, ref = _jax_stats(absA, kind)
    if case == "fro_skipped":
        pal, ref = np.zeros_like(pal), np.zeros_like(ref)
    got = pk.tile_norms(torch.from_numpy(T), kind, rows=torch.from_numpy(rows),
                        cols=torch.from_numpy(cols), **extra).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        got, pk.tile_norms_plain(torch.from_numpy(T), kind, torch.from_numpy(rows),
                                 torch.from_numpy(cols), **extra).numpy())
    k = {"max": 1, "fro_sumsq": MB * NB, "one": MB, "inf": NB, "max_sumsq": MB * NB}[kind]
    if kind in ("max", "max_sumsq"):
        maxes = (got if kind == "max" else got[:, 0])
        np.testing.assert_array_equal(maxes, pal if kind == "max" else pal[:, 0])
    if kind != "max":
        _close(got, pal, k, dtype)
        _close(got, ref, k, dtype)


def test_plain_without_counts_keeps_todays_contract():
    T = np.random.default_rng(4).standard_normal((4, 8, 16))
    for kind in ("max", "fro_sumsq", "one", "inf"):
        got = pk.tile_norms(torch.from_numpy(T), kind).numpy()
        ref = np.asarray(jk.tile_norms_reference(jnp.asarray(np.abs(T)), kind))
        _close(got, ref, 128, np.float64)
    both = pk.tile_norms(torch.from_numpy(T), "max_sumsq").numpy()
    np.testing.assert_array_equal(both[:, 0], np.abs(T).max(axis=(1, 2)))
    _close(both[:, 1], (T * T).sum(axis=(1, 2)), 128, np.float64)


def test_tile_norms_rejects_bad_counts_and_flags():
    T = torch.zeros(6, 4, 4)
    r, c = torch.tensor([4, 4], dtype=torch.int32), torch.tensor([4, 4, 4], dtype=torch.int32)
    pk.tile_norms(T, "one", rows=r, cols=c)
    with pytest.raises(ValueError):
        pk.tile_norms(T, "one", rows=r)  # both or neither
    with pytest.raises(ValueError):
        pk.tile_norms(T, "one", rows=r, cols=c[:2])  # 2 x 2 counts for 6 tiles
    with pytest.raises(ValueError):
        pk.tile_norms(T, "one", rows=r.long(), cols=c)  # not int32
    with pytest.raises(ValueError):
        pk.tile_norms(T, "max", scale=torch.tensor(1.0))  # scale is fro_sumsq's
    with pytest.raises(ValueError):
        pk.tile_norms(T, "fro_sumsq", scale=torch.tensor([1.0]))  # not 0-d
    with pytest.raises(ValueError):
        pk.tile_norms(T, "fro_sumsq", skip=torch.tensor(1))  # not bool
    with pytest.raises(ValueError):
        pk.tile_norms_plain(T, "max_sumsq", rows=r, cols=c[:1])


# ---------------------------------------------------------------------------
# genorm on a ragged layout with junk in the padding
# ---------------------------------------------------------------------------


def _storages(a, fill):
    """The JAX and the torch storage of a (same numpy values), ``fill``
    in the padding of both."""
    jlay, tlay = jl.TileLayout(**LAYOUT), tl.TileLayout(**LAYOUT)
    S = np.array(jl.tiles_from_global(jnp.asarray(a), jlay))
    with np.errstate(over="ignore"):  # 1e300 is inf in float32
        S[~np.asarray(jlay.element_mask())] = fill
    return jnp.asarray(S), torch.from_numpy(S.copy()), jlay, tlay


def _rand(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _real(dtype):
    return np.float32 if dtype in (np.float32, np.complex64) else np.float64


@pytest.mark.parametrize("fill", [np.nan, 1e300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_genorm_every_norm_and_scope_ignores_the_padding(monkeypatch, dtype, fill):
    jS, tS, jlay, tlay = _storages(_rand((37, 29), 21, dtype), fill)
    monkeypatch.setattr(tl.TileLayout, "element_mask",
                        lambda *a, **k: pytest.fail("genorm built the padding mask"))
    real = _real(dtype)
    for name in ("Max", "One", "Inf", "Fro"):
        got = tn.genorm(stt.Norm[name], tS, tlay)
        ref = jn.genorm(st.Norm[name], jS, jlay)
        assert got.dim() == 0 and np.isfinite(float(got))
        if name == "Max":
            assert float(got) == float(ref)
        elif name == "Fro":
            _close_rel(got, ref, real)
        else:
            _close(float(got), float(ref), 37, real)
    _close(tn.genorm(stt.Norm.One, tS, tlay, stt.NormScope.Columns).numpy(),
           jn.genorm(st.Norm.One, jS, jlay, st.NormScope.Columns), 37, real)
    _close(tn.genorm(stt.Norm.Inf, tS, tlay, stt.NormScope.Rows).numpy(),
           jn.genorm(st.Norm.Inf, jS, jlay, st.NormScope.Rows), 29, real)


def test_genorm_with_a_callers_mask_takes_the_jax_route(monkeypatch):
    """A caller-given mask: |T| masked, then the kernel without counts,
    as the JAX package computes."""
    jS, tS, jlay, tlay = _storages(_rand((37, 29), 22, np.float64), 7.0)
    keep = np.random.default_rng(23).random(jlay.storage_shape) < 0.7
    keep &= np.asarray(jlay.element_mask())
    calls = []
    wrapper = pk.tile_norms
    monkeypatch.setattr(pk, "tile_norms",
                        lambda T, kind, **kw: calls.append(sorted(kw)) or wrapper(T, kind, **kw))
    for name in ("Max", "One", "Inf", "Fro"):
        got = tn.genorm(stt.Norm[name], tS, tlay, mask=torch.from_numpy(keep))
        ref = jn.genorm(st.Norm[name], jS, jlay, mask=jnp.asarray(keep))
        _close(float(got), float(ref), 37, np.float64)
    assert calls == [[], [], [], [], ["scale", "skip"]]


@pytest.mark.parametrize("op", ["transpose", "conj_transpose"])
def test_genorm_hands_the_kernel_rows_of_unit_stride(monkeypatch, op):
    """A transposed view's resolved storage lies transposed in memory;
    genorm hands the kernel (which takes inner stride 1 only) a copy
    with unit inner stride, and the norms still match the JAX package."""
    a = _rand((37, 29), 26, np.float64)
    jA = st.Matrix.from_global(a, 8, grid=st.ProcessGrid.from_devices(
        __import__("jax").devices()[:4], p=2, q=2))
    tA = stt.matrix_from_reference(np.asarray(jA.data), m=37, n=29, mb=8, nb=8, p=2, q=2,
                                   kind="Matrix", device="cpu")
    assert getattr(stt, op)(tA).resolved().data.stride(-1) != 1
    wrapper = pk.tile_norms

    def spy(T, kind, **kw):
        assert T.stride(-1) == 1, T.stride()
        return wrapper(T, kind, **kw)

    monkeypatch.setattr(pk, "tile_norms", spy)
    for name in ("Max", "One", "Inf", "Fro"):
        got = stt.norm(stt.Norm[name], getattr(stt, op)(tA))
        ref = st.norm(st.Norm[name], getattr(st, op)(jA))
        _close(float(got), float(ref), 37, np.float64)
    _close(stt.colNorms(stt.Norm.One, getattr(stt, op)(tA)).numpy(),
           np.abs(a).sum(1), 37, np.float64)


def test_layout_counts_are_made_once():
    tlay = tl.TileLayout(**LAYOUT)
    first = tn._layout_tensors(tlay, torch.device("cpu"))
    assert all(a is b for a, b in zip(first, tn._layout_tensors(tl.TileLayout(**LAYOUT),
                                                                torch.device("cpu"))))
    rows, cols, rs, cs = first
    np.testing.assert_array_equal(rows.numpy(), tlay.row_mask_np.sum(1))
    np.testing.assert_array_equal(cols.numpy(), tlay.col_mask_np.sum(1))
    assert rows.dtype == cols.dtype == torch.int32 and rs.dtype == cs.dtype == torch.long


# ---------------------------------------------------------------------------
# Fro: the guard's edges
# ---------------------------------------------------------------------------


def _edges(dtype):
    fi = np.finfo(dtype)
    return float(np.sqrt(fi.tiny) / fi.eps), float(np.sqrt(fi.max / (37 * 29)))


def _fro_cases():
    cases = [(np.float64, 1e300, False), (np.float64, 1e-160, False),
             (np.float32, 1e30, False), (np.float32, 1e-20, False)]
    for dtype in DTYPES:
        lo, hi = _edges(dtype)
        cases += [(dtype, lo * 0.5, False), (dtype, lo * 2, True),
                  (dtype, hi * 0.5, True), (dtype, hi * 2, False), (dtype, 1.0, True)]
    return cases


@pytest.mark.parametrize("dtype,amax,unscaled", _fro_cases())
def test_fro_on_both_sides_of_the_guard(monkeypatch, dtype, amax, unscaled):
    a = _rand((37, 29), 24, np.float64)
    a = (a / np.abs(a).max() * amax).astype(dtype)
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    jS, tS, jlay, tlay = _storages(a, np.nan)
    skips = []
    wrapper = pk.tile_norms

    def spy(T, kind, **kw):
        if kw.get("skip") is not None:
            skips.append(bool(kw["skip"]))
        return wrapper(T, kind, **kw)

    monkeypatch.setattr(pk, "tile_norms", spy)
    got = tn.genorm(stt.Norm.Fro, tS, tlay)
    ref = jn.genorm(st.Norm.Fro, jS, jlay)
    assert skips == [unscaled]
    assert np.isfinite(float(got))
    _close_rel(got, ref, dtype)
    # the float64 norm of the same values
    _close_rel(got, np.linalg.norm(a.astype(np.float64) / amax) * amax, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["zero", "nan", "inf"])
def test_fro_of_zero_nan_and_inf_matches_jax(dtype, case):
    a = _rand((37, 29), 25, dtype)
    if case == "zero":
        a[:] = 0
    else:
        a[20, 11] = np.nan if case == "nan" else np.inf
    jS, tS, jlay, tlay = _storages(a, 1e300)
    got = float(tn.genorm(stt.Norm.Fro, tS, tlay))
    ref = float(jn.genorm(st.Norm.Fro, jS, jlay))
    if case == "zero":
        assert got == ref == 0.0
    else:
        assert np.isnan(got) and np.isnan(ref)
    np.testing.assert_equal(float(tn.genorm(stt.Norm.Max, tS, tlay)),
                            float(jn.genorm(st.Norm.Max, jS, jlay)))  # NaN equals NaN here
