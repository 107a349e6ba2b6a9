"""The device monitor of slate_tpu_torch against the JAX package's, on
the CPU: the roofline peaks and attribution (the shared table rows and
the ``SLATE_TPU_PEAKS`` override), a CPU device's memory record (None
byte fields), the serve cache's cost rows (the JAX package's field
names, ``flops_model`` equal to its ``phase_flops``), their manifest
round trip with no second measurement, and ``health()``'s device
sections.  The CUDA side (bytes in use, the peak, the limit) is in
``tests/test_torch_cuda_kernels.py``."""

import json

import numpy as np
import pytest
import torch

from slate_tpu.aux import devmon as jdevmon
from slate_tpu.aux import metrics as jmetrics
from slate_tpu.serve import buckets as jbk
from slate_tpu_torch import serve
from slate_tpu_torch.aux import devmon, metrics
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the cost-row fields the JAX package's capture writes on XLA:CPU
JAX_FIELDS = {"flops", "bytes_accessed", "transcendentals", "argument_bytes", "output_bytes",
              "temp_bytes", "alias_bytes", "generated_code_bytes", "peak_bytes",
              "device_kind", "flops_model"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv(devmon.PEAKS_ENV, raising=False)
    metrics.off()
    metrics.reset()
    metrics.on()
    devmon.reset()
    devmon.on()
    yield
    devmon.off()
    devmon.reset()
    metrics.off()
    metrics.reset()


KINDS = ("cpu", "tpu v4", "TPU v5 lite", "tpu v6e", "some accelerator", "nvidia h100 80gb hbm3")


@pytest.mark.parametrize("kind", KINDS)
def test_peaks_equal_on_shared_rows(kind):
    got, ref = devmon.peaks_for(kind), jdevmon.peaks_for(kind)
    if "h100" in kind.lower():
        # the port's own row: the H100 SXM's FP64 tensor-core / FP32 and
        # HBM3 peaks (the JAX package falls back to its cpu row)
        assert got["flops"] == 6.7e13 and got["bytes_per_s"] == 3.35e12
        assert got["source"] == "default" and ref["source"] == "fallback"
    else:
        assert got == ref
    for flops, nbytes, sec in ((1e12, 1e9, 0.01), (1e9, 1e10, 0.5), (0, 1, 1), (1, 1, 0)):
        assert devmon.roofline(flops, nbytes, sec, got) == jdevmon.roofline(flops, nbytes, sec,
                                                                              got)


def test_peaks_env_override_equal(monkeypatch):
    monkeypatch.setenv(devmon.PEAKS_ENV, json.dumps({"h100": {"flops": 5e13,
                                                              "bytes_per_s": 3e12},
                                                     "cpu": {"flops": 1e11,
                                                             "bytes_per_s": 4e10}}))
    for kind in KINDS:
        assert devmon.peaks_for(kind) == jdevmon.peaks_for(kind)
    monkeypatch.setenv(devmon.PEAKS_ENV, "{not json")
    jmetrics.on()
    try:
        with metrics.deltas() as d, jmetrics.deltas() as jd:
            assert devmon.peaks_for("tpu v4") == jdevmon.peaks_for("tpu v4")
            assert d.get("devmon.peaks_parse_error") == jd.get("devmon.peaks_parse_error") == 1
    finally:
        jmetrics.off()
        jmetrics.reset()


def test_cpu_device_record_has_none_byte_fields():
    [row] = devmon.sample_devices([CPU])
    assert row["device"] == "cpu" and row["platform"] == "cpu"
    assert row["bytes_in_use"] is None and row["bytes_limit"] is None
    assert row["peak_bytes_in_use"] is None
    assert devmon.bytes_in_use(CPU) is None
    assert not [k for k in metrics.gauges() if k.startswith("serve.device.")]
    assert devmon.default_device_kind() == jdevmon.default_device_kind() == "cpu"


def _warm(cache, keys):
    for key, batch in keys:
        A = np.broadcast_to(np.eye(key.m, key.n), (batch, key.m, key.n)).copy()
        B = np.zeros((batch, key.m, key.nrhs))
        cache.run(key, A, B, device=CPU)


def _keys():
    out = []
    for routine, m, n in (("gesv", 20, 20), ("posv", 40, 40), ("gels", 40, 20)):
        out += [(bk.bucket_for(routine, m, n, 3, np.float64, floor=16, nrhs_floor=4), b)
                for b in (1, 4)]
    return out


def test_cost_rows_fields_and_flops_model(tmp_path):
    man = str(tmp_path / "m.json")
    cache = ExecutableCache(manifest_path=man)
    keys = _keys()
    with metrics.deltas() as d:
        _warm(cache, keys)
        assert d.get("serve.cost_captured") == len(keys)
    for key, batch in keys:
        row = cache.cost(key, batch)
        assert set(row) <= JAX_FIELDS and {"flops", "flops_model", "bytes_accessed",
                                           "argument_bytes", "output_bytes",
                                           "device_kind"} <= set(row)
        jkey = jbk.BucketKey.from_json(key.to_json())
        assert row["flops_model"] == jbk.phase_flops(jkey, batch) == bk.phase_flops(key, batch)
        assert row["device_kind"] == "cpu"
        assert row["bytes_accessed"] == row["argument_bytes"] + row["output_bytes"] > 0
        name = f"serve.{key.label}.b{batch}"
        assert metrics.costs()[name] == row
    by = cache.costs_by_label()
    assert sorted(by) == sorted({k.label for k, _ in keys})
    # the JAX package's manifest reader sees the same rows
    with open(man) as f:
        text = f.read()
    jrows = jbk.manifest_cost_loads(text)
    assert {(k.label, b): v for (k, b), v in jrows.items()} == \
        {(k.label, b): v for (k, b), v in cache.cost_registry().items()}


def test_manifest_round_trip_never_measures_again(tmp_path):
    man = str(tmp_path / "m.json")
    keys = _keys()[:2]
    _warm(ExecutableCache(manifest_path=man), keys)
    first = {k: ExecutableCache(manifest_path=man).cost(*k) for k in keys}
    metrics.reset()
    fresh = ExecutableCache(manifest_path=man)
    with metrics.deltas() as d:
        _warm(fresh, keys)  # a restarted process's first runs
        assert d.get("serve.cost_captured") == 0
        assert d.get("jit.compilations") == len(keys)
    for k in keys:
        assert fresh.cost(*k) == first[k]
        assert metrics.costs()[f"serve.{k[0].label}.b{k[1]}"] == first[k]
    # a row of another device kind is measured again
    fresh2 = ExecutableCache(manifest_path=man)
    with fresh2._lock:
        for k in keys:
            fresh2._costs[k] = {**fresh2._costs[k], "device_kind": "tpu v4"}
    with metrics.deltas() as d:
        _warm(fresh2, keys)
        assert d.get("serve.cost_foreign_recaptured") == len(keys)
        assert d.get("serve.cost_captured") == len(keys)
    assert all(fresh2.cost(*k)["device_kind"] == "cpu" for k in keys)


def test_devmon_off_measures_nothing(tmp_path):
    devmon.off()
    cache = ExecutableCache(manifest_path=str(tmp_path / "m.json"))
    _warm(cache, _keys()[:1])
    assert cache.cost_registry() == {} and metrics.costs() == {}
    assert "cost" not in json.loads((tmp_path / "m.json").read_text())["entries"][0]


def test_health_device_sections():
    svc = serve.SolverService(placement=serve.PlacementPolicy(devices=["cpu"]), batch_max=4,
                              dim_floor=16, nrhs_floor=4,
                              cache=ExecutableCache(manifest_path=None))
    try:
        rng = np.random.default_rng(0)
        A = rng.standard_normal((12, 12)) + 12 * np.eye(12)
        B = rng.standard_normal((12, 2))
        assert np.abs(A @ svc.submit("gesv", A, B).result(timeout=120) - B).max() < 1e-9
        h = svc.health()
    finally:
        svc.stop()
    label = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=16, nrhs_floor=4).label
    assert list(h["cost"]) == [label] and set(h["cost"][label]) == {1}
    assert [r["device"] for r in h["devices"]] == ["cpu"]
    assert h["devices"][0]["bytes_in_use"] is None
    assert "peak_bytes" not in h["latency"][label]  # no peak on the CPU
