"""Port parity: slate_tpu_torch.serve.factor_cache against the JAX
package's serve/factor_cache.py on the CPU.

Exact: ``matrix_fingerprint`` hex digests (the factor's identity),
``residual_ok`` verdicts, ``parse_env_spec`` results and errors, gesv's
``perm``.  Within 200 n eps relative to the JAX package's result: the
factors, X from ``solve_from_factor`` and the gels pack.  The port runs
the ``auto`` schedule (the library on the CPU) and ``pallas`` (the
kernels' plain versions); the JAX side runs ``auto``.  The cache's LRU,
byte budget, invalidation and update are the cases of
tests/test_factor_cache.py on the port's device-tensor entries."""

import numpy as np
import pytest
import torch

from slate_tpu.serve import buckets as jbk
from slate_tpu.serve import factor_cache as jfc
from slate_tpu_torch import convert
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.serve import buckets as tbk
from slate_tpu_torch.serve import factor_cache as tfc

torch.set_num_threads(1)

FLOOR, NRHS_FLOOR = 16, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _metrics():
    metrics.off()
    metrics.reset()
    metrics.on()
    yield
    metrics.off()
    metrics.reset()


def _tol(dtype, n):
    return 200 * n * np.finfo(np.dtype(dtype)).eps


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(ref).max(), 1e-300)


def _prob(routine, n, dtype, seed=0, nrhs=2):
    r = np.random.default_rng(seed)
    if routine == "posv":
        G = r.standard_normal((n, n))
        A = G @ G.T + n * np.eye(n)
    else:
        A = r.standard_normal((n, n)) + n * np.eye(n)
    return A.astype(dtype), r.standard_normal((n, nrhs)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("shape", [(4, 4), (7, 3), (33, 33), (1, 9)])
def test_matrix_fingerprint_digests_equal(dtype, shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    A = rng.standard_normal(shape).astype(dtype)
    if np.iscomplexobj(A):
        A = A + 1j * rng.standard_normal(shape)
    for routine in ("gesv", "posv", "gels"):
        for schedule, precision in (("auto", "full"), ("pallas", "mixed")):
            assert (tfc.matrix_fingerprint(A, routine, schedule, precision)
                    == jfc.matrix_fingerprint(A, routine, schedule, precision))
    # a non-contiguous view hashes its logical bytes in both
    F = np.asfortranarray(A)
    assert tfc.matrix_fingerprint(F, "gesv") == jfc.matrix_fingerprint(A, "gesv")


@pytest.mark.parametrize("routine", ["gesv", "posv", "gels"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_residual_ok_verdicts_equal(routine, dtype):
    n = 12
    A, B = _prob("posv" if routine == "posv" else "gesv", n, dtype, seed=5)
    if routine == "gels":
        A = np.vstack([A, np.random.default_rng(6).standard_normal((8, n)).astype(dtype)])
        B = np.random.default_rng(7).standard_normal((n + 8, 2)).astype(dtype)
        X = np.linalg.lstsq(A.astype(np.float64), B.astype(np.float64), rcond=None)[0]
    else:
        X = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    X = X.astype(dtype)
    for Xc in (X, X + 0.1, X * np.nan, X + 1e-3 * np.abs(X).max()):
        verdict = tfc.residual_ok(A, B, Xc, routine)
        assert verdict == jfc.residual_ok(A, B, Xc, routine)
    assert tfc.residual_ok(A, B, X, routine) and not tfc.residual_ok(A, B, X + 0.1, routine)


@pytest.mark.parametrize("spec", ["", "0", "off", "1", "on", "entries=8,bytes=2e6",
                                  "bytes=512", "entries", "nope=3", " entries = 3 "])
def test_parse_env_spec_equal(spec):
    def call(mod):
        try:
            return mod.parse_env_spec(spec), None
        except ValueError as e:
            return None, str(e)

    assert call(tfc) == call(jfc)


# ---------------------------------------------------------------------------
# the cache itself (device-tensor entries on the CPU)
# ---------------------------------------------------------------------------


def _entry(fp, n=4, routine="gesv", S=16):
    key = tbk.bucket_for(routine, n, n, 2, np.float64, floor=S, nrhs_floor=NRHS_FLOOR)
    perm = torch.arange(n, dtype=torch.int64) if routine == "gesv" else None
    return tfc.FactorEntry(fp=fp, routine=routine, key=key,
                           factor=torch.eye(S, dtype=torch.float64), perm=perm, n=n)


def test_entry_nbytes_equal_numpy_count():
    e = _entry("a" * 64)
    assert e.nbytes == np.eye(16).nbytes + np.arange(4, dtype=np.int64).nbytes
    assert _entry("b" * 64, routine="posv").nbytes == np.eye(16).nbytes


def test_lru_entry_budget_eviction():
    fc = tfc.FactorCache(max_entries=2, max_bytes=1 << 30)
    assert fc.put(_entry("a" * 64)) and fc.put(_entry("b" * 64))
    assert fc.get("a" * 64) is not None  # refresh: "b" becomes LRU
    fc.put(_entry("c" * 64))
    assert fc.get("b" * 64) is None and fc.get("a" * 64) is not None
    assert metrics.counters().get("serve.factor_cache.evict") == 1
    assert len(fc) == 2 and fc.fingerprints() == ["c" * 64, "a" * 64]


def test_byte_budget_eviction_and_uncacheable():
    one = _entry("a" * 64).nbytes
    fc = tfc.FactorCache(max_entries=100, max_bytes=int(one * 2.5))
    for c in "abc":
        fc.put(_entry(c * 64))
    assert len(fc) == 2 and fc.bytes <= fc.max_bytes
    assert fc.get("a" * 64) is None  # LRU paid the byte budget
    big = tfc.FactorCache(max_entries=4, max_bytes=one - 1)
    assert big.put(_entry("d" * 64)) is False
    assert len(big) == 0
    assert metrics.counters().get("serve.factor_cache.uncacheable") == 1


def test_invalidate_and_invalidate_all():
    fc = tfc.FactorCache(max_entries=8)
    fc.put(_entry("a" * 64))
    fc.put(_entry("b" * 64))
    assert fc.invalidate("a" * 64) is True
    assert fc.invalidate("a" * 64) is False
    assert fc.invalidate_all() == 1
    assert len(fc) == 0 and fc.bytes == 0
    assert metrics.counters().get("serve.factor_cache.invalidate") == 2
    assert metrics.gauges()["serve.factor_cache.entries"] == 0


def test_fp_metric_family_is_capped(monkeypatch):
    monkeypatch.setattr(tfc, "_fp_keys", metrics.CappedKeys(2))
    for c in "abc":
        tfc.record("hit", fp=c * 64, label="gesv.16x16x4.float64")
    c = metrics.counters()
    assert c["serve.factor_cache.hit"] == 3
    assert c["serve.factor_cache.fp_overflow"] == 1
    assert "serve.factor_cache.fp.cccccccccccc.hit" not in c


# ---------------------------------------------------------------------------
# factor production and solves against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("routine,n", [("gesv", 12), ("posv", 12), ("gesv", 40)])
def test_factor_only_and_solve_from_factor_match_jax(routine, n, dtype, schedule):
    A, B = _prob(routine, n, dtype, seed=n)
    jF, jperm = jfc.factor_only(routine, A)
    tF, tperm = tfc.factor_only(routine, A, schedule=schedule, device=CPU)
    assert tF.device == CPU and tF.dtype == getattr(torch, np.dtype(dtype).name)
    assert _rel(tF.numpy(), jF) <= _tol(dtype, n)
    if routine == "gesv":
        assert tperm.dtype == torch.int64 and np.array_equal(tperm.numpy(), jperm)
    else:
        assert tperm is None and jperm is None
    jkey = jbk.bucket_for(routine, n, n, 2, dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    tkey = tbk.bucket_for(routine, n, n, 2, dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    jentry = jfc.FactorEntry(fp="x" * 64, routine=routine, key=jkey,
                             factor=jbk.pad_square(jF, jkey.n), perm=jperm, n=n)
    tentry = tfc.FactorEntry(fp="x" * 64, routine=routine, key=tkey,
                             factor=tfc.pad_square_t(tF, tkey.n), perm=tperm, n=n)
    assert np.array_equal(tentry.factor.numpy()[n:, n:], np.eye(tkey.n - n))
    jX = jfc.solve_from_factor(jentry, B)
    tX = tfc.solve_from_factor(tentry, B)
    assert isinstance(tX, np.ndarray) and tX.shape == (n, 2)
    assert _rel(tX, jX) <= _tol(dtype, n)
    assert tfc.residual_ok(A, B, tX, routine)
    # the JAX package's cached entry, carried across, serves the same X
    carried = convert.factor_entry_from_reference(jentry, device="cpu")
    assert carried.key == tkey and carried.nbytes == jentry.nbytes
    assert _rel(tfc.solve_from_factor(carried, B), jX) <= _tol(dtype, n)


@pytest.mark.parametrize("schedule", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gels_factor_pack_matches_jax(dtype, schedule):
    m, n = 40, 12
    rng = np.random.default_rng(11)
    A = rng.standard_normal((m, n)).astype(dtype)
    B = rng.standard_normal((m, 2)).astype(dtype)
    jkey = jbk.bucket_for("gels", m, n, 2, dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    tkey = tbk.bucket_for("gels", m, n, 2, dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    jpack = jfc.gels_factor_pack(A, jkey)
    tpack = tfc.gels_factor_pack(A, tkey, schedule=schedule, device=CPU)
    assert tuple(tpack.shape) == jpack.shape == tbk.solve_factor_shape(tkey)
    assert _rel(tpack.numpy(), jpack) <= _tol(dtype, tkey.m)
    tentry = tfc.FactorEntry(fp="g" * 64, routine="gels", key=tkey, factor=tpack,
                             perm=None, n=n)
    jentry = jfc.FactorEntry(fp="g" * 64, routine="gels", key=jkey, factor=jpack,
                             perm=None, n=n)
    tX, jX = tfc.solve_from_factor(tentry, B), jfc.solve_from_factor(jentry, B)
    assert _rel(tX, jX) <= _tol(dtype, tkey.m)
    assert tfc.residual_ok(A, B, tX, "gels")


def _cached(routine, A, n):
    fc = tfc.FactorCache(max_entries=4)
    F, perm = tfc.factor_only(routine, A, device=CPU)
    key = tbk.bucket_for(routine, n, n, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    fp = tfc.matrix_fingerprint(A, routine, schedule=key.schedule)
    fc.put(tfc.FactorEntry(fp=fp, routine=routine, key=key,
                           factor=tfc.pad_square_t(F, key.n), perm=perm, n=n))
    return fc, fp, key


def test_update_posv_matches_refactor(rng):
    n = 12
    A, B = _prob("posv", n, np.float64, seed=4)
    fc, fp, key = _cached("posv", A, n)
    u = rng.standard_normal(n)
    A2 = A + np.outer(u, u)
    fp2 = fc.update(fp, A2, u)
    assert fp2 == jfc.matrix_fingerprint(A2, "posv", schedule=key.schedule)
    assert fc.get(fp) is None and fc.get(fp2) is not None
    ref, _ = tfc.factor_only("posv", A2, device=CPU)
    assert _rel(fc.get(fp2).factor[:n, :n].numpy(), ref.numpy()) <= _tol(np.float64, n)
    X = tfc.solve_from_factor(fc.get(fp2), B)
    assert np.abs(X - np.linalg.solve(A2, B)).max() < 1e-8
    c = metrics.counters()
    assert c.get("serve.factor_cache.update") == 1
    assert not c.get("serve.factor_cache.update_refactor")
    assert fc.update("z" * 64, A2, u) is None
    # a downdate back to A reproduces A's factor
    fp3 = fc.update(fp2, A, u, downdate=True)
    assert fp3 == fp
    F0, _ = tfc.factor_only("posv", A, device=CPU)
    assert _rel(fc.get(fp3).factor[:n, :n].numpy(), F0.numpy()) <= _tol(np.float64, n)


def test_update_gesv_falls_back_to_refactor(rng):
    n = 12
    A, B = _prob("gesv", n, np.float64, seed=5)
    fc, fp, _key = _cached("gesv", A, n)
    u = rng.standard_normal(n)
    A2 = A + np.outer(u, u)
    fp2 = fc.update(fp, A2, u)
    X = tfc.solve_from_factor(fc.get(fp2), B)
    assert np.abs(X - np.linalg.solve(A2, B)).max() < 1e-9
    assert metrics.counters().get("serve.factor_cache.update_refactor") == 1
    with pytest.raises(ValueError):
        fc.update(fp2, A2[:8, :8], u[:8])
    assert fc.get(fp2) is not None  # the untouched entry went back


def test_cache_from_options_env_and_options(monkeypatch):
    monkeypatch.delenv(tfc.FACTOR_CACHE_ENV, raising=False)
    assert tfc.cache_from_options() is None
    fc = tfc.cache_from_options({"serve_factor_cache": True,
                                 "serve_factor_cache_entries": 3})
    assert fc.max_entries == 3 and fc.max_bytes == 1 << 30
    monkeypatch.setenv(tfc.FACTOR_CACHE_ENV, "entries=5,bytes=1e6")
    fc = tfc.cache_from_options()
    assert (fc.max_entries, fc.max_bytes) == (5, 1_000_000)
