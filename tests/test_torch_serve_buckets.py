"""Port parity: slate_tpu_torch.serve.buckets against the JAX package's
serve/buckets.py (pure numpy on both sides).  Every function gives
exactly equal results over a grid of (routine, m, n, nrhs, dtype,
phase, precision); the manifest text is byte-equal and each package
loads the other's; BucketKey JSON crosses both ways; Breaker transition
sequences match."""

import json
import random

import numpy as np
import pytest

from slate_tpu.serve import buckets as jbk
from slate_tpu_torch.serve import buckets as tbk

FLOOR, NRHS_FLOOR = 16, 4

_SHAPES = [("gesv", 10, 10, 2), ("gesv", 33, 33, 5), ("posv", 16, 16, 1),
           ("posv", 100, 100, 9), ("gels", 40, 12, 2), ("gels", 16, 13, 3),
           ("gels", 24, 24, 4), ("gels", 70, 30, 8)]
_GRID = [(r, m, n, k, dt, ph, pr)
         for (r, m, n, k) in _SHAPES
         for dt in (np.float32, np.float64)
         for ph in ("full", "solve")
         for pr in ("full", "mixed")]


def _call(mod, name, *a, **kw):
    """(result, None) or (None, the exception's type and text)."""
    try:
        return getattr(mod, name)(*a, **kw), None
    except Exception as e:  # noqa: BLE001 — the error is compared too
        return None, (type(e).__name__, str(e))


def _json(k):
    return None if k is None else k.to_json()


@pytest.mark.parametrize("routine,m,n,nrhs,dtype,phase,precision", _GRID)
def test_bucket_functions_match(routine, m, n, nrhs, dtype, phase, precision):
    kw = dict(floor=FLOOR, nrhs_floor=NRHS_FLOOR, phase=phase, precision=precision,
              schedule="recursive" if m % 2 else "auto")
    jk, jerr = _call(jbk, "bucket_for", routine, m, n, nrhs, dtype, **kw)
    tk, terr = _call(tbk, "bucket_for", routine, m, n, nrhs, dtype, **kw)
    assert jerr == terr
    if jk is None:
        return
    assert tk.to_json() == jk.to_json() and tk.label == jk.label
    assert tk.solve_sibling().to_json() == jk.solve_sibling().to_json()
    assert tbk.gels_pack_kt(tk) == jbk.gels_pack_kt(jk)
    assert tbk.solve_factor_shape(tk) == jbk.solve_factor_shape(jk)
    for b in (1, 4):
        assert tbk.phase_flops(tk, b) == jbk.phase_flops(jk, b)
        assert tbk.content_fields(tk, b) == jbk.content_fields(jk, b)
        assert (tbk.fingerprint(tbk.content_fields(tk, b))
                == jbk.fingerprint(jbk.content_fields(jk, b)))
    assert tbk.pad_waste(tk, m, n, nrhs) == jbk.pad_waste(jk, m, n, nrhs)
    rng = np.random.default_rng(m * 100 + n)
    A = rng.standard_normal((m, n)).astype(dtype)
    B = rng.standard_normal((m, nrhs)).astype(dtype)
    for ja, ta in zip(jbk.pad_request(jk, A, B), tbk.pad_request(tk, A, B)):
        assert ja.dtype == ta.dtype and np.array_equal(ja, ta)
    Xp = rng.standard_normal((tk.m, tk.nrhs))
    assert np.array_equal(tbk.crop_result(tk, Xp, n, nrhs),
                          jbk.crop_result(jk, Xp, n, nrhs))


@pytest.mark.parametrize("h,total,floor", [(1, 4096, 16), (3, 4096, 16), (17, 4096, 16),
                                           (1000, 4096, 16), (2500, 6144, 1024),
                                           (65, 128, 64), (0, 64, 1)])
def test_lattice_functions_match(h, total, floor):
    assert tbk.halving_bucket(h, total, floor) == jbk.halving_bucket(h, total, floor)
    assert _call(tbk, "bucket_dim", h, floor) == _call(jbk, "bucket_dim", h, floor)
    if h:
        assert tbk.bucket_mn(h + 3, h, floor) == jbk.bucket_mn(h + 3, h, floor)
    heights = [h + 100, h + 90, h + 60, h + 40, h + 10, h + 5]
    assert (list(tbk.size_bucket_runs(heights, total, floor))
            == list(jbk.size_bucket_runs(heights, total, floor)))
    for count in (0, 1, 2, 8):
        assert tbk.batch_bucket(count, 8) == jbk.batch_bucket(count, 8)


@pytest.mark.parametrize("value", ["high", "normal", "low", 0, 2, "urgent", 5, -1])
def test_priority_precision_phase_mesh_checks_match(value):
    assert _call(tbk, "check_priority", value) == _call(jbk, "check_priority", value)
    if isinstance(value, int) and 0 <= value < 3:
        assert tbk.priority_name(value) == jbk.priority_name(value)
    for fn, arg in (("check_precision", "full"), ("check_precision", "mixed"),
                    ("check_precision", "half"), ("check_phase", "solve"),
                    ("check_phase", "factor"), ("check_mesh", ""), ("check_mesh", "2X4"),
                    ("check_mesh", "2x"), ("parse_mesh", "0x3"), ("mesh_fits", "2x4")):
        extra = (8,) if fn == "mesh_fits" else ()
        assert _call(tbk, fn, arg, *extra) == _call(jbk, fn, arg, *extra)


def _entries(mod):
    keys = [mod.bucket_for(r, m, n, k, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
            for (r, m, n, k) in _SHAPES]
    keys += [k.solve_sibling() for k in keys[:3]]
    keys.append(mod.bucket_for("posv", 20, 20, 3, np.float32, floor=FLOOR,
                               precision="mixed", schedule="pallas"))
    return [(k, b) for k in keys for b in (1, 4)]


def test_manifest_text_equal_and_loads_across():
    jtext = jbk.manifest_dumps(_entries(jbk))
    ttext = tbk.manifest_dumps(_entries(tbk))
    assert ttext == jtext
    # each package loads the other's text to the same entries
    assert [(k.to_json(), b) for k, b in tbk.manifest_loads(jtext)] == \
        [(k.to_json(), b) for k, b in jbk.manifest_loads(jtext)]
    assert [(k.to_json(), b) for k, b in jbk.manifest_loads(ttext)] == \
        [(k.to_json(), b) for k, b in tbk.manifest_loads(ttext)]
    # legacy entries (no schedule / precision / mesh / phase keys) default alike
    legacy = json.dumps({"version": 1, "entries": [
        {"routine": "gesv", "m": 16, "n": 16, "nrhs": 4, "dtype": "float64", "nb": 16,
         "batch": 2}]})
    [(tk, tb)] = tbk.manifest_loads(legacy)
    [(jk, jb)] = jbk.manifest_loads(legacy)
    assert tk.to_json() == jk.to_json() and tb == jb


def test_bucketkey_json_crosses_both_ways():
    for (jk, _), (tk, _) in zip(_entries(jbk), _entries(tbk)):
        assert tbk.BucketKey.from_json(jk.to_json()) == tk
        assert jbk.BucketKey.from_json(tk.to_json()) == jk
        assert hash(tbk.BucketKey.from_json(jk.to_json())) == hash(tk)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_transition_sequences_match(seed):
    rng = random.Random(seed)
    jb, tb = jbk.Breaker(), tbk.Breaker()
    t = 100.0
    for _ in range(60):
        t += rng.choice([0.1, 0.5, 2.0])
        op = rng.choice(["fail", "ok", "half", "cool"])
        if op == "fail":
            got = (jb.record_failure(t, 2), tb.record_failure(t, 2))
        elif op == "ok":
            got = (jb.record_success(), tb.record_success())
        elif op == "half":
            got = (jb.try_half_open(t, 1.0), tb.try_half_open(t, 1.0))
        else:
            got = (jb.cooling_down(t, 1.0), tb.cooling_down(t, 1.0))
        assert got[0] == got[1]
        assert (jb.state, jb.streak, jb.opened_at, jb.opens) == \
            (tb.state, tb.streak, tb.opened_at, tb.opens)
