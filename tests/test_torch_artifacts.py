"""The port's artifact store and restore on the CPU (ROADMAP.md Queue 1
item 4b): the load ladder with each rung counted and self-healing, the
three artifact fault sites, the fingerprint (its content half equal to
the JAX package's ``buckets.content_fields``, a runtime-field drift read
as stale, mesh keys apart), the kernel library's store copy (its bytes
checked against their recorded sha256 before any open, opened once,
never beside another digest, never a second copy after a failed open,
never opened by a rung that rebuilds), ``restore()``'s summary invariant, the
readiness phases and one restore drill in a fresh interpreter.

The JAX package's own artifact legs fail on this tree (its export rung
never loads), so the port is held to the store's specification: every
rung counted globally (``serve.artifact_<outcome>``) and per bucket
(``serve.artifact.<label>.b<n>.<outcome>``), no rung raises, a rebuilt
entry overwrites the bad file.  Services run on a CPU placement at small
buckets (floor 16, nrhs floor 4); results are held to 200 n eps relative
of ``numpy.linalg.solve``."""

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from slate_tpu.serve import buckets as jbk
from slate_tpu_torch.aux import faults, metrics
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import artifacts as art
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import PHASE_READY, PHASE_RESTORING, SolverService

torch.set_num_threads(1)

FLOOR, NRHS_FLOOR = 16, 4
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _env():
    metrics.off()
    metrics.reset()
    metrics.on()
    faults.reset()
    yield
    faults.reset()
    metrics.off()
    metrics.reset()


def _svc(cache, **kw):
    kw.setdefault("batch_max", 4)
    kw.setdefault("batch_window_s", 0.002)
    kw.setdefault("dim_floor", FLOOR)
    kw.setdefault("nrhs_floor", NRHS_FLOOR)
    kw.setdefault("placement", PlacementPolicy(devices=["cpu"]))
    return SolverService(cache=cache, **kw)


def _problem(n=12, nrhs=2, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n) if spd else G + n * np.eye(n)
    return A, rng.standard_normal((n, nrhs))


def _close(A, B, X):
    ref = np.linalg.solve(A, B)
    return np.abs(X - ref).max() <= 200 * A.shape[0] * np.finfo(float).eps * np.abs(ref).max()


def _key(routine="gesv", n=12, nrhs=2, **kw):
    return bk.bucket_for(routine, n, n, nrhs, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                         **kw)


def _warm(tmp_path, routines=("gesv", "posv")):
    """A manifest and a store warmed by one service: both batch points of
    each routine's bucket.  Returns (manifest path, store dir)."""
    man, store = str(tmp_path / "m.json"), str(tmp_path / "store")
    s = _svc(ExecutableCache(manifest_path=man, artifact_dir=store))
    try:
        for i, r in enumerate(routines):
            A, B = _problem(seed=i, spd=r == "posv")
            assert _close(A, B, s.submit(r, A, B).result(timeout=60))
        s.warmup()
    finally:
        s.stop()
    return man, store


def _count(outcome, key=None, batch=1):
    c = metrics.counters()
    if key is None:
        return c.get(f"serve.artifact_{outcome}", 0)
    return c.get(f"serve.artifact.{key.label}.b{batch}.{outcome}", 0)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(schedule="pallas"), dict(precision="mixed"),
                                dict(tag="abft"), dict(phase="solve")])
@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_content_fields_equal_the_jax_package(routine, kw):
    """The content half of the fingerprint is the JAX package's for the
    same bucket and batch point, field for field and digest for digest."""
    for batch in (1, 4):
        k = _key(routine, **kw)
        jk = jbk.bucket_for(routine, 12, 12, 2, np.float64, floor=FLOOR,
                            nrhs_floor=NRHS_FLOOR, **kw)
        assert bk.content_fields(k, batch) == jbk.content_fields(jk, batch)
        assert bk.fingerprint(bk.content_fields(k, batch)) == \
            jbk.fingerprint(jbk.content_fields(jk, batch))


def test_runtime_fields_and_store_fingerprint(tmp_path):
    rf = art.runtime_fields(CPU)
    assert rf == {"torch": torch.__version__, "cuda": torch.version.cuda,
                  "device_kind": "cpu", "capability": None, "kernels": pk.library_digest()}
    st = art.ArtifactStore(str(tmp_path))
    fp, fields = st.fingerprint(_key(), 1, CPU)
    assert fields == {**bk.content_fields(_key(), 1), **rf}
    assert fp == bk.fingerprint(fields)
    assert st.fingerprint(_key(), 4, CPU)[0] != fp  # the batch point is content


def test_mesh_keys_fingerprinted_apart(tmp_path):
    """A mesh key keeps its own file and fingerprint (never the
    single-device entry's), round-trips through the store, and restore
    skips it (no process of the port serves a mesh yet)."""
    st = art.ArtifactStore(str(tmp_path / "store"))
    k1, km = _key(), _key(mesh="2x2")
    assert st.path_for(k1, 1) != st.path_for(km, 1)
    assert st.fingerprint(k1, 1, CPU)[0] != st.fingerprint(km, 1, CPU)[0]
    assert st.save(km, 1, CPU) and st.load(km, 1, CPU)
    assert _count("hit", km) == 1 and _count("miss", k1) == 0
    assert not st.load(k1, 1, CPU) and _count("miss", k1) == 1
    c = ExecutableCache(manifest_path=None, artifact_dir=str(tmp_path / "store"))
    c.ensure_manifest(km, (1,))
    got = c.restore(devices=[CPU])
    assert got["mesh_unfit"] == 1 and got["entries"] == 0
    assert metrics.counters().get("serve.mesh_unfit_skipped") == 1


def test_runtime_drift_reads_stale_and_self_heals(tmp_path, monkeypatch):
    man, store = _warm(tmp_path, ("gesv",))
    monkeypatch.setattr(pk, "library_digest", lambda: "0" * 16)  # another build
    c = ExecutableCache(manifest_path=man, artifact_dir=store)
    got = c.restore(devices=[CPU])
    assert got == {"entries": 2, "restored": 0, "compiled": 2, "failed": 0, "skipped": 0}
    assert _count("stale") == 2 and _count("stale", _key(), 1) == 1
    # the rebuild re-saved each entry under this runtime: it loads now
    st = art.ArtifactStore(store)
    assert st.load(_key(), 1, CPU) and st.load(_key(), 4, CPU)
    assert json.loads(open(st.path_for(_key(), 1), "rb").readline())["fields"]["kernels"] \
        == "0" * 16


# ---------------------------------------------------------------------------
# the load ladder
# ---------------------------------------------------------------------------


def test_ladder_miss_hit_and_self_heal_on_corrupt(tmp_path):
    st = art.ArtifactStore(str(tmp_path))
    k = _key()
    assert not st.load(k, 1, CPU) and _count("miss") == 1 and _count("miss", k) == 1
    assert st.save(k, 1, CPU) and metrics.counters()["serve.artifact_saved"] == 1
    assert st.load(k, 1, CPU) and _count("hit") == 1 and _count("hit", k) == 1
    path = st.path_for(k, 1)
    blob = open(path, "rb").read()
    nl = blob.index(b"\n")
    for bad in (art.ArtifactStore._flip_byte(blob),  # a payload byte
                blob[:nl + 3],  # truncated
                b"garbage without a header",
                blob[:5] + b"X" + blob[6:]):  # the header no longer parses
        open(path, "wb").write(bad)
        assert not st.load(k, 1, CPU)
    assert _count("corrupt") == 4 and _count("corrupt", k) == 4
    assert st.save(k, 1, CPU)  # the rebuild's save overwrites the bad file
    assert open(path, "rb").read().split(b"\n", 1)[1] == blob.split(b"\n", 1)[1]
    assert st.load(k, 1, CPU) and _count("hit") == 2


@pytest.mark.parametrize("site,outcome", [("artifact_corrupt", "corrupt"),
                                          ("artifact_stale", "stale"),
                                          ("artifact_load_fail", "load_fail")])
def test_fault_sites_caught_by_their_counters(tmp_path, site, outcome):
    """Each artifact site armed once during a restore: fired once, its
    rung counted once, the entry rebuilt (correct results) and re-saved,
    and the next restore of the same store restores everything."""
    man, store = _warm(tmp_path, ("gesv",))
    faults.arm(site, once=True)
    faults.on()
    c = ExecutableCache(manifest_path=man, artifact_dir=store)
    got = c.restore(devices=[CPU])
    faults.reset()
    assert metrics.counters().get(f"faults.injected.{site}") == 1
    assert _count(outcome) == 1 and _count("hit") == 1
    assert got == {"entries": 2, "restored": 1, "compiled": 1, "failed": 0, "skipped": 0}
    assert faults.SITE_REGISTRY[site].recovery == (f"serve.artifact_{outcome}",)
    s = _svc(c)
    try:
        A, B = _problem(seed=5)
        assert _close(A, B, s.submit("gesv", A, B).result(timeout=60))
    finally:
        s.stop()
    again = ExecutableCache(manifest_path=man, artifact_dir=store).restore(devices=[CPU])
    assert again["restored"] == 2 and again["compiled"] == 0


def test_save_never_raises_and_load_never_raises(tmp_path):
    st = art.ArtifactStore(str(tmp_path / "s"))
    blocker = tmp_path / "afile"
    blocker.write_text("x")
    st.root = str(blocker)  # the store's directory became a file under it
    assert st.save(_key(), 1, CPU) is False
    assert metrics.counters().get("serve.artifact_save_error") == 1
    assert st.load(_key(), 1, CPU) is False and _count("miss") == 1


def test_no_device_without_cuda_raises(tmp_path, monkeypatch):
    """No quiet move to the CPU: an entry with no device is the default
    grid's (cuda:0), and without CUDA that raises."""
    from slate_tpu_torch.exceptions import DistributedException
    from slate_tpu_torch.parallel import grid as tgrid

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tgrid, "_default_grid", None)
    st = art.ArtifactStore(str(tmp_path / "s"))
    for call in (lambda: st.save(_key(), 1), lambda: st.load(_key(), 1),
                 lambda: st.fingerprint(_key(), 1), lambda: art.runtime_fields()):
        with pytest.raises(DistributedException):
            call()
    assert not os.path.exists(st.path_for(_key(), 1))
    assert st.save(_key(), 1, CPU) and st.load(_key(), 1, CPU)


def test_env_activation_and_store_errors(tmp_path, monkeypatch):
    monkeypatch.setenv(art.ARTIFACTS_ENV, str(tmp_path / "envstore"))
    c = ExecutableCache(manifest_path=None)
    assert c.artifacts is not None and c.artifacts.root == str(tmp_path / "envstore")
    assert art.store_from_env("") is None
    monkeypatch.delenv(art.ARTIFACTS_ENV)
    assert ExecutableCache(manifest_path=None).artifacts is None
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    assert art.store_from_env(str(blocker / "sub")) is None
    assert metrics.counters().get("serve.artifact_store_error") == 1


def test_filelock_acquire_break_and_timeout(tmp_path):
    path = str(tmp_path / ".lock")
    with art._FileLock(path):
        assert os.path.exists(path)
    assert not os.path.exists(path)
    open(path, "w").close()
    old = time.time() - 3600
    os.utime(path, (old, old))
    with art._FileLock(path, stale_s=1.0) as lk:  # a crashed writer's lock
        assert lk._held
    open(path, "w").close()
    t0 = time.monotonic()
    with art._FileLock(path, timeout_s=0.1) as lk:  # a live holder: proceed unlocked
        assert not lk._held
    assert time.monotonic() - t0 < 5
    assert metrics.counters().get("serve.artifact_lock_timeout") == 1


# ---------------------------------------------------------------------------
# the kernel library's store copy
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_library(monkeypatch, tmp_path):
    """An empty library state with ``_open`` replaced: what opening a
    store's copy does, without a card."""
    opened = []
    monkeypatch.setattr(pk, "_libs", None)
    monkeypatch.setattr(pk, "_libs_digest", None)
    monkeypatch.setattr(pk, "LOADED_FROM", None)
    monkeypatch.setattr(pk, "_half_open", None)
    monkeypatch.setattr(pk, "_open", lambda sos: opened.append(list(sos)) or ["lib"])
    d = tmp_path / "kernels" / pk.library_digest()
    d.mkdir(parents=True)
    return d, opened


def _fake_files(d, tag="library"):
    """One fake library file a source in ``d``; returns their sha256s."""
    d.mkdir(parents=True, exist_ok=True)
    shas = {}
    for i, name in enumerate(pk.library_names()):
        blob = f"{tag} {i} ".encode() * 64
        (d / name).write_bytes(blob)
        shas[name] = hashlib.sha256(blob).hexdigest()
    return shas


def _fake_copy(d):
    """A library copy with its record, as ``save_library`` writes it."""
    shas = _fake_files(d)
    (d / pk.LIBRARY_RECORD).write_bytes(pk.library_record(pk.library_digest(), shas))


def _flip(path, at=None):
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2 if at is None else at] ^= 0x01
    path.write_bytes(bytes(blob))


def test_open_from_opens_once_and_never_beside_another_digest(fake_library, monkeypatch):
    d, opened = fake_library
    with pytest.raises(FileNotFoundError):
        pk.open_from(d, pk.library_digest())  # no files yet
    _fake_copy(d)
    assert pk.open_from(d, "f" * 16) == "stale"  # not the current sources'
    assert pk.open_from(d, pk.library_digest()) == "opened"
    assert pk.LOADED_FROM == d and len(opened) == 1
    assert [p.name for p in opened[0]] == pk.library_names()
    assert pk.open_from(d, pk.library_digest()) == "loaded" and len(opened) == 1
    monkeypatch.setattr(pk, "_libs_digest", "e" * 16)  # the process holds another build
    assert pk.open_from(d, pk.library_digest()) == "stale" and len(opened) == 1
    assert pk.NVCC_RUNS == 0


def test_store_library_open_under_threads(fake_library):
    """Lanes sharing one device reach the store's library together: it
    opens exactly once, under the build lock."""
    d, opened = fake_library
    _fake_copy(d)
    st = art.ArtifactStore(str(d.parents[1]))
    got = []
    threads = [threading.Thread(target=lambda: got.append(st.open_library())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(got) == ["loaded"] * 7 + ["opened"] and len(opened) == 1
    assert art.ArtifactStore(str(d.parents[1] / "empty")).open_library() == "loaded"


def test_missing_store_library_fails_to_open(fake_library):
    d, opened = fake_library
    st = art.ArtifactStore(str(d.parents[1]))
    assert st.open_library() == "failed" and not opened and st._library_bad
    _fake_copy(d)
    (d / pk.LIBRARY_RECORD).unlink()  # files with no record: an unfinished copy
    assert st.open_library() == "failed" and not opened


@pytest.mark.parametrize("damage", ["library_byte", "library_truncated", "record_byte",
                                    "record_of_another_digest"])
def test_damaged_library_copy_reads_corrupt_before_any_open(fake_library, damage):
    """A flipped or missing byte in a stored library, or a damaged record,
    fails the sha256 check: the copy is never handed to ``_open``."""
    d, opened = fake_library
    _fake_copy(d)
    so = d / pk.library_names()[-1]
    if damage == "library_byte":
        _flip(so)
    elif damage == "library_truncated":
        so.write_bytes(so.read_bytes()[:-1])
    elif damage == "record_byte":
        _flip(d / pk.LIBRARY_RECORD, at=20)
    else:
        shas = json.loads((d / pk.LIBRARY_RECORD).read_text())["files"]
        (d / pk.LIBRARY_RECORD).write_bytes(pk.library_record("a" * 16, shas))
    with pytest.raises(pk.LibraryCorrupt):
        pk.check_copy(d, pk.library_digest())
    with pytest.raises(pk.LibraryCorrupt):
        pk.open_from(d, pk.library_digest())
    st = art.ArtifactStore(str(d.parents[1]))
    assert st.open_library() == "corrupt" and st._library_bad
    assert not opened and pk._libs is None and pk._half_open is None


def _cuda_runtime(monkeypatch):
    """runtime_fields of a card, so the store takes its CUDA path here."""
    monkeypatch.setattr(art, "runtime_fields", lambda device=None: {
        "torch": torch.__version__, "cuda": "12.x", "device_kind": "NVIDIA H100 80GB HBM3",
        "capability": "9.0", "kernels": pk.library_digest()})


def test_cuda_load_with_a_flipped_library_byte_rebuilds_and_heals(fake_library, monkeypatch,
                                                                  tmp_path):
    """The store's CUDA path: an entry saved with its library copy; in a
    fresh process a flipped library byte reads corrupt and opens nothing;
    the rebuild's save rewrites the copy, which then opens on a hit."""
    d, opened = fake_library
    _cuda_runtime(monkeypatch)
    build = tmp_path / "build"
    _fake_files(build)
    k, dev = _key(), "cuda:0"

    def holds_the_build():  # the process loaded the library it built
        monkeypatch.setattr(pk, "_libs", ["lib"])
        monkeypatch.setattr(pk, "_libs_digest", pk.library_digest())
        monkeypatch.setattr(pk, "LOADED_FROM", build)

    def fresh_process():
        monkeypatch.setattr(pk, "_libs", None)
        monkeypatch.setattr(pk, "_libs_digest", None)
        monkeypatch.setattr(pk, "LOADED_FROM", None)

    holds_the_build()
    assert art.ArtifactStore(str(d.parents[1])).save(k, 1, dev)
    assert [p.name for p in pk.check_copy(d, pk.library_digest())] == pk.library_names()
    fresh_process()
    _flip(d / pk.library_names()[0])
    st = art.ArtifactStore(str(d.parents[1]))
    assert not st.load(k, 1, dev)
    assert _count("corrupt") == 1 and _count("corrupt", k) == 1 and _count("hit") == 0
    assert not opened and pk._libs is None
    holds_the_build()  # the rebuild loads the library built from the sources
    assert st.save(k, 1, dev)
    pk.check_copy(d, pk.library_digest())  # rewritten clean
    fresh_process()
    assert art.ArtifactStore(str(d.parents[1])).load(k, 1, dev) and _count("hit") == 1
    assert len(opened) == 1 and pk.LOADED_FROM == d


def test_failed_open_of_a_checked_copy_never_loads_a_second(fake_library, monkeypatch):
    """A copy that passes its checks but fails in ``_open`` (after the
    dynamic loader may have mapped it) leaves the process without a
    library: the build's copy is never loaded beside it, so a kernel
    launch raises."""
    d, _opened = fake_library
    _fake_copy(d)

    def bad_open(sos):
        raise RuntimeError("trsm kernel tile 0 x 0")

    builds = []
    monkeypatch.setattr(pk, "_open", bad_open)
    monkeypatch.setattr(pk, "build", lambda verbose=False: builds.append(1) or ([], ""))
    with pytest.raises(RuntimeError, match="tile"):
        pk.open_from(d, pk.library_digest())
    assert pk._half_open == d and pk._libs is None
    with pytest.raises(RuntimeError, match="second copy"):
        pk._load()
    assert not builds
    assert art.ArtifactStore(str(d.parents[1])).open_library() == "failed"


@pytest.mark.parametrize("rung", ["miss", "corrupt", "stale"])
def test_rebuild_rungs_never_open_the_store_copy(tmp_path, monkeypatch, rung):
    """On a CUDA device every rung but a hit rebuilds from the sources:
    the store's library copy is not opened."""
    from slate_tpu_torch.serve import cache as cache_mod

    _cuda_runtime(monkeypatch)
    calls = []
    monkeypatch.setattr(art.ArtifactStore, "open_library",
                        lambda self: calls.append(1) or "opened")
    monkeypatch.setattr(cache_mod, "_build_core", lambda key: (lambda A, B: (B, None)))
    k, store = _key(), str(tmp_path / "store")
    if rung != "miss":
        monkeypatch.setattr(pk, "_libs", ["lib"])  # the save needs a loaded library
        monkeypatch.setattr(pk, "_libs_digest", pk.library_digest())
        monkeypatch.setattr(pk, "LOADED_FROM", tmp_path / "build")
        _fake_files(tmp_path / "build")
        st = art.ArtifactStore(store)
        assert st.save(k, 1, "cuda:0")
        path = Path(st.path_for(k, 1))
        if rung == "corrupt":
            _flip(path, at=len(path.read_bytes()) - 2)
        else:
            monkeypatch.setattr(pk, "library_digest", lambda: "0" * 16)
    ExecutableCache(manifest_path=None, artifact_dir=store).executable(k, 1, "cuda:0")
    assert _count(rung) == 1 and not calls


# ---------------------------------------------------------------------------
# restore and readiness
# ---------------------------------------------------------------------------


def test_restore_summary_invariant(tmp_path):
    """entries == restored + compiled + failed + skipped, with an entry of
    each kind: restored from the store, rebuilt (no artifact), failed (a
    compile fault) and skipped (already live)."""
    man, store = _warm(tmp_path, ("gesv",))
    c = ExecutableCache(manifest_path=man, artifact_dir=store)
    c.ensure_manifest(_key("posv"), (1, 4))  # built nowhere: no artifact
    A, B = _warm_inputs_for(_key(), 4)
    c.run(_key(), A, B, device=CPU)  # live before the pass
    faults.arm("compile", once=True)
    faults.on()
    got = c.restore(devices=[CPU])
    faults.reset()
    assert got == {"entries": 4, "restored": 1, "compiled": 1, "failed": 1, "skipped": 1}
    assert got["entries"] == sum(got[k] for k in ("restored", "compiled", "failed", "skipped"))
    assert metrics.counters().get("serve.restore_failed") == 1


def _warm_inputs_for(key, batch):
    from slate_tpu_torch.serve.cache import _warm_inputs

    return _warm_inputs(key, batch, CPU)


class _SlowCache(ExecutableCache):
    """Each dispatch waits on a gate: a restore pass that can be watched
    in the ``restoring`` phase and stopped between entries."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()

    def run(self, *a, **kw):
        self.gate.wait(10)
        return super().run(*a, **kw)


def test_phases_cold_restoring_ready_and_wait_ready_timeout(tmp_path):
    man, store = _warm(tmp_path, ("gesv",))
    c = _SlowCache(manifest_path=man, artifact_dir=store)
    s = _svc(c, start=False, restore_stuck_after_s=0.01)
    try:
        assert s.health()["phase"] == "cold" and s.wait_ready(0.01) is False
        s.start()
        assert s.wait_ready(0.1) is False  # bounded: the pass is parked
        h = s.health()
        assert h["phase"] == PHASE_RESTORING and not h["ready"]
        assert h["restore_stuck_s"] is not None and h["restore_stuck_s"] > 0.01
        c.gate.set()
        assert s.wait_ready(30) is True
        h = s.health()
        assert h["phase"] == PHASE_READY and h["ready"] and h["restore_stuck_s"] is None
        assert h["restore"] == {"entries": 2, "restored": 2, "compiled": 0, "failed": 0,
                                "skipped": 0}
    finally:
        c.gate.set()
        s.stop()


def test_stop_mid_restore_abandons_the_pass(tmp_path):
    man, store = _warm(tmp_path, ("gesv", "posv"))
    c = _SlowCache(manifest_path=man, artifact_dir=store)
    s = _svc(c)
    time.sleep(0.05)  # the pass is parked on its first entry
    threading.Timer(0.1, c.gate.set).start()
    s.stop(timeout=10)
    r = s.health()["restore"]
    assert r is not None and r["entries"] < 4
    assert metrics.counters().get("serve.restore_stopped") == 1


def test_no_store_is_ready_at_once_and_restore_on_start_false(tmp_path):
    s = _svc(ExecutableCache(manifest_path=None))
    try:
        assert s.wait_ready(0) and s.health()["restore"] is None
    finally:
        s.stop()
    man, store = _warm(tmp_path, ("gesv",))
    s = _svc(ExecutableCache(manifest_path=man, artifact_dir=store), restore_on_start=False)
    try:
        assert s.wait_ready(0) and s.health()["restore"] is None
        assert s.restore() == {"entries": 2, "restored": 2, "compiled": 0, "failed": 0,
                               "skipped": 0}
    finally:
        s.stop()


def test_api_restore_and_wait_ready(tmp_path):
    from slate_tpu_torch import serve

    man, store = _warm(tmp_path, ("posv",))
    serve.configure(cache=ExecutableCache(manifest_path=man, artifact_dir=store),
                    placement=PlacementPolicy(devices=["cpu"]), dim_floor=FLOOR,
                    nrhs_floor=NRHS_FLOOR, batch_max=4)
    try:
        assert serve.wait_ready(30)
        assert serve.health()["restore"]["restored"] == 2
        assert serve.restore(timeout=30)["skipped"] == 2  # already live
    finally:
        serve.shutdown()


_DRILL = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import SolverService
metrics.on()
man, store = sys.argv[1], sys.argv[2]
s = SolverService(cache=ExecutableCache(manifest_path=man, artifact_dir=store),
                  placement=PlacementPolicy(replicas=2, devices=["cpu"]), dim_floor=16,
                  nrhs_floor=4, batch_max=4, batch_window_s=0.002)
ready = s.wait_ready(120)
rng = np.random.default_rng(7)
with metrics.deltas() as d:
    res = []
    for i in range(12):
        G = rng.standard_normal((12, 12)); B = rng.standard_normal((12, 2))
        r = ("gesv", "posv")[i % 2]
        A = G @ G.T + 12 * np.eye(12) if r == "posv" else G + 12 * np.eye(12)
        res.append(float(np.abs(A @ s.submit(r, A, B).result(60) - B).max()))
    cold = d.get("jit.compilations")
print(json.dumps({"ready": ready, "restore": s.health()["restore"], "cold": cold,
                  "residual": max(res), "nvcc": pk.NVCC_RUNS,
                  "modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slate_tpu"))}))
s.stop()
"""


def test_restart_drill_in_a_fresh_interpreter(tmp_path):
    """Warm here, restore in a fresh interpreter of the port alone: every
    entry restored, none built, ready, and a 12-request stream on two
    lanes with no cold build."""
    man, store = _warm(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _DRILL, man, store], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ready"] and got["cold"] == 0 and got["nvcc"] == 0 and got["modules"] == []
    assert got["restore"] == {"entries": 4, "restored": 4, "compiled": 0, "failed": 0,
                              "skipped": 0}
    assert got["residual"] < 1e-10
