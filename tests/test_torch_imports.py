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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "slate_tpu" or m.startswith("slate_tpu."))
print(",".join(bad))
"""


def test_import_leaves_no_jax_or_slate_tpu_module():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


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
            "drivers/aux.py", "internal/norms.py", "internal/tile_ops.py"} <= names
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
