"""slate_tpu_torch stands alone: importing it pulls in neither JAX nor
any module of the JAX package, no source file of it imports either, and
its default grid is the CUDA card (never a silent CPU fall back)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import slate_tpu_torch as stt
from slate_tpu_torch.exceptions import DistributedException
from slate_tpu_torch.parallel import grid as tgrid

torch.set_num_threads(1)

PKG = Path(stt.__file__).resolve().parent
REPO = PKG.parent

_PROBE = """
import sys
import slate_tpu_torch
import slate_tpu_torch.ops.hopper.panel_kernels
import slate_tpu_torch.convert
import slate_tpu_torch.types
import slate_tpu_torch.ops.lu_kernels
import slate_tpu_torch.ops.lu_fast
import slate_tpu_torch.matgen.philox
import slate_tpu_torch.drivers.lu
import slate_tpu_torch.ops.householder
import slate_tpu_torch.ops.qr_fast
import slate_tpu_torch.drivers.qr
import slate_tpu_torch.drivers.aux
import slate_tpu_torch.drivers.blas3
import slate_tpu_torch.internal.norms
import slate_tpu_torch.internal.tile_ops
import slate_tpu_torch.internal.norm1est
import slate_tpu_torch.drivers.chol
import slate_tpu_torch.ops.chol_kernels
import slate_tpu_torch.func
import slate_tpu_torch.simplified
import slate_tpu_torch.matgen.generate
import slate_tpu_torch.refine.policy
import slate_tpu_torch.refine.ir
import slate_tpu_torch.refine.gmres
import slate_tpu_torch.drivers.mixed
import slate_tpu_torch.aux.faults
import slate_tpu_torch.aux.spans
import slate_tpu_torch.aux.sync
import slate_tpu_torch.aux.metrics
import slate_tpu_torch.aux.devmon
import slate_tpu_torch.integrity
import slate_tpu_torch.integrity.policy
import slate_tpu_torch.integrity.abft
import slate_tpu_torch.serve.artifacts
import slate_tpu_torch.serve
import slate_tpu_torch.serve.buckets
import slate_tpu_torch.serve.admission
import slate_tpu_torch.serve.placement
import slate_tpu_torch.serve.factor_cache
import slate_tpu_torch.serve.cache
import slate_tpu_torch.serve.service
import slate_tpu_torch.serve.api
import slate_tpu_torch.ops.band_kernels
import slate_tpu_torch.ops.aasen
import slate_tpu_torch.drivers.band
import slate_tpu_torch.drivers.indefinite
import slate_tpu_torch.native
import slate_tpu_torch.parallel.band_gather
import slate_tpu_torch.ops.bulge
import slate_tpu_torch.ops.stedc
import slate_tpu_torch.ops.stein
import slate_tpu_torch.ops.jacobi
import slate_tpu_torch.drivers.eig
import slate_tpu_torch.drivers.svd
import slate_tpu_torch.soak
import slate_tpu_torch.soak.record
import slate_tpu_torch.soak.replay
import slate_tpu_torch.soak.timeline
import slate_tpu_torch.scale
import slate_tpu_torch.scale.signals
import slate_tpu_torch.scale.controller
import slate_tpu_torch.scale.gate
import slate_tpu_torch.scale.warmup_plan
import slate_tpu_torch.fleet.wire
import slate_tpu_torch.fleet.worker
import slate_tpu_torch.fleet.router
import slate_tpu_torch.fleet
import torch
assert not torch.cuda.is_initialized()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "slate_tpu" or m.startswith("slate_tpu."))
print(",".join(bad))
"""


def test_import_leaves_no_jax_or_slate_tpu_module():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_serve_api_without_fleet_imports_no_fleet_module():
    """With SLATE_TPU_FLEET unset the serve api builds no router and the
    fleet package is never imported (one ``is None`` branch a call)."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "SLATE_TPU_FLEET"}
    code = ("import sys; from slate_tpu_torch.serve import api; "
            "print(api.get_fleet(), sorted(m for m in sys.modules if 'fleet' in m))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True, env=env)
    assert out.stdout.strip() == "None []", out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_file_imports_jax_or_slate_tpu():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(PKG)) for f in files if f.is_relative_to(PKG)}
    assert {"types.py", "ops/lu_kernels.py", "ops/lu_fast.py", "matgen/philox.py",
            "drivers/lu.py", "ops/householder.py", "ops/qr_fast.py", "drivers/qr.py",
            "drivers/aux.py", "internal/norms.py", "internal/tile_ops.py",
            "internal/norm1est.py", "func.py", "simplified.py", "drivers/chol.py",
            "drivers/blas3.py", "ops/chol_kernels.py", "aux/sync.py", "aux/devmon.py",
            "aux/metrics.py", "aux/spans.py", "aux/faults.py", "integrity/policy.py",
            "integrity/abft.py", "serve/artifacts.py",
            "serve/buckets.py", "serve/admission.py", "serve/placement.py",
            "serve/factor_cache.py", "serve/cache.py", "serve/service.py",
            "serve/api.py", "ops/band_kernels.py", "ops/aasen.py", "drivers/band.py",
            "drivers/indefinite.py", "native/__init__.py", "parallel/band_gather.py",
            "ops/bulge.py", "ops/stedc.py", "ops/stein.py", "ops/jacobi.py",
            "drivers/eig.py", "drivers/svd.py"} <= names
    assert {"soak/__init__.py", "soak/record.py", "soak/replay.py", "soak/timeline.py"} <= names
    assert {"scale/__init__.py", "scale/signals.py", "scale/controller.py", "scale/gate.py",
            "scale/warmup_plan.py"} <= names
    assert {"fleet/__init__.py", "fleet/wire.py", "fleet/worker.py", "fleet/router.py"} <= names
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "slate_tpu"), f"{f}: imports {name}"


def test_single_grid_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tgrid, "_default_grid", None)
    with pytest.raises(DistributedException):
        stt.ProcessGrid.single()
    with pytest.raises(DistributedException):
        stt.default_grid()
    with pytest.raises(DistributedException):
        stt.Matrix.from_global(torch.zeros(4, 4), 2)
    assert stt.ProcessGrid.single("cpu").device == torch.device("cpu")


def test_from_global_places_data_on_the_grid_device():
    g = stt.ProcessGrid.single("cpu")
    A = stt.HermitianMatrix.from_global(torch.eye(6, dtype=torch.float64), 4, grid=g)
    assert A.device == torch.device("cpu") and A.grid is g


def test_native_loader_reads_only_its_own_source(monkeypatch, tmp_path):
    """The native chase library builds from the port's own copy of
    hb2st.c (never the JAX package's file), into the port's build
    directory, keyed by the source's hash."""
    from slate_tpu_torch import native

    assert native.SOURCE == PKG / "native" / "hb2st.c" and native.SOURCE.is_file()
    text = (PKG / "native" / "__init__.py").read_text()
    assert "slate_tpu/" not in text and "slate_tpu." not in text.replace("slate_tpu_torch", "")
    built = []
    real_run = native.subprocess.run

    def run(cmd, *a, **k):
        built.append(cmd)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native.subprocess, "run", run)
    assert native.load() is not None
    assert len(built) == 1 and str(native.SOURCE) in built[0]
    assert [p.parent for p in tmp_path.glob("libslate_hb2st_*.so")] == [tmp_path]
