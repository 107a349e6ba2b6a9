"""A pool of gloo ranks for the port's mesh tests, and the cases each rank
runs.

``MeshPool(world, tmpdir)`` starts ``world`` CPU processes, each
``torch.set_num_threads(1)``, joined in one gloo process group through a
``file://`` rendezvous under ``tmpdir`` (no port, so concurrent test
workers never race for one).  ``pool.run(case, grid=(p, q, order, n),
**args)`` sends the case to every rank: each builds (once, collectively)
the p x q mesh over ranks 0..n-1 with ``ProcessGrid.from_ranks`` and, if
it is on it, runs ``case(grid, **args)`` and answers its result (None
off the grid).  The process group's timeout and the pool's wait for the
answers are both bounded, so a hung collective fails one test: the pool
is killed and starts afresh for the next.

This module imports neither JAX nor anything of ``slate_tpu``; the rank
processes import it by name (its directory is on their path).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection, wait
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
GLOO_TIMEOUT_S = 120  # a collective that waits longer raises on its rank
CASE_TIMEOUT_S = 90  # the pool's wait for one case's answers


class MeshPool:
    """``world`` gloo ranks answering cases (see the module docstring)."""

    def __init__(self, world: int, tmpdir):
        self.world = world
        self.tmpdir = Path(tmpdir)
        self.procs = []
        self.conns = []
        self.starts = 0

    def start(self) -> None:
        self.starts += 1
        rdv = self.tmpdir / f"rdv_{self.starts}"
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(HERE), str(REPO)]),
               "OMP_NUM_THREADS": "1", "MESH_WORLD": str(self.world),
               "MESH_INIT": f"file://{rdv}"}
        for k in range(self.world):
            to_r, from_p = os.pipe()
            to_p, from_r = os.pipe()
            proc = subprocess.Popen(
                [sys.executable, "-c", "import torch_mesh_pool as m; m._rank_main()"],
                env={**env, "MESH_RANK": str(k), "MESH_FDS": f"{to_r},{from_r}"},
                pass_fds=(to_r, from_r), cwd=str(self.tmpdir))
            os.close(to_r)
            os.close(from_r)
            self.procs.append(proc)
            self.conns.append((Connection(from_p, readable=False),
                               Connection(to_p, writable=False)))
        self._answers(CASE_TIMEOUT_S)

    def _answers(self, timeout: float) -> list:
        deadline = time.monotonic() + timeout
        got = {}
        while len(got) < self.world:
            left = deadline - time.monotonic()
            ready = wait([c[1] for i, c in enumerate(self.conns) if i not in got],
                         timeout=max(left, 0))
            if not ready:
                self.close()
                raise TimeoutError(f"mesh pool: ranks {sorted(set(range(self.world)) - set(got))}"
                                   f" did not answer within {timeout} s")
            for conn in ready:
                k = [c[1] for c in self.conns].index(conn)
                try:
                    got[k] = conn.recv()
                except EOFError:
                    self.close()
                    raise RuntimeError(f"mesh pool: rank {k} died") from None
                if isinstance(got[k], dict) and "error" in got[k]:
                    self.close()  # the other ranks may wait in a collective
                    raise AssertionError(f"rank {k} raised:\n{got[k]['error']}")
        return [got[k] for k in range(self.world)]

    def run(self, case: str, grid=(2, 2, "Col", 4), timeout: float = CASE_TIMEOUT_S,
            **args) -> list:
        """Every rank's answer to ``case(grid, **args)`` (None off the grid)."""
        if not self.procs:
            self.start()
        for send, _ in self.conns:
            send.send((case, tuple(grid), args))
        return self._answers(timeout)

    def close(self) -> None:
        for send, _ in self.conns:
            try:
                send.send(None)
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        for send, recv in self.conns:
            send.close()
            recv.close()
        self.procs, self.conns = [], []


def _rank_main() -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(os.environ["MESH_RANK"]), int(os.environ["MESH_WORLD"])
    rfd, wfd = (int(x) for x in os.environ["MESH_FDS"].split(","))
    recv, send = Connection(rfd, writable=False), Connection(wfd, readable=False)
    dist.init_process_group("gloo", init_method=os.environ["MESH_INIT"], rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    grids = {}
    send.send("ready")
    try:
        while True:
            msg = recv.recv()
            if msg is None:
                break
            case, spec, args = msg
            try:
                if spec not in grids:
                    grids[spec] = _grid(spec)
                g = grids[spec]
                send.send(None if g is None else CASES[case](g, **args))
            except Exception:  # answered to the pool, which fails the test
                send.send({"error": traceback.format_exc()})
    finally:
        dist.destroy_process_group()


def _grid(spec):
    from slate_tpu_torch import GridOrder, ProcessGrid

    p, q, order, n = spec
    return ProcessGrid.from_ranks(range(n), p, q, GridOrder[order], device="cpu")


# ---------------------------------------------------------------------------
# the cases: each runs on every rank of the mesh and answers numpy
# ---------------------------------------------------------------------------


def _kinds():
    import slate_tpu_torch as stt

    return {"Matrix": stt.Matrix, "HermitianMatrix": stt.HermitianMatrix,
            "SymmetricMatrix": stt.SymmetricMatrix, "TriangularMatrix": stt.TriangularMatrix}


def _mat(grid, spec):
    """A port matrix from ``(kind, array, mb, nb, kw)`` on ``grid`` (None
    for the single device), with an op view when ``kw['op']`` is given."""
    import slate_tpu_torch as stt

    kind, a, mb, nb, kw = spec
    kw = dict(kw)
    op = kw.pop("op", None)
    g = grid if kw.pop("mesh", True) else stt.ProcessGrid.single("cpu")
    for key in ("uplo", "diag"):
        if key in kw:
            kw[key] = getattr(stt, key.capitalize())[kw[key]]
    M = _kinds()[kind].from_global(a, mb, nb, grid=g, **kw)
    if op == "Trans":
        M = stt.transpose(M)
    elif op == "ConjTrans":
        M = stt.conj_transpose(M)
    return M


def _opts(opts):
    import slate_tpu_torch as stt

    if not opts:
        return None
    out = {}
    for k, v in opts.items():
        if k not in stt.Option.__members__:  # a string key, as a user may give it
            out[k] = v
            continue
        key = stt.Option[k]
        enum = {stt.Option.MethodGemm: stt.MethodGemm, stt.Option.MethodLU: stt.MethodLU,
                stt.Option.MethodGels: stt.MethodGels}.get(key)
        out[key] = enum[v] if enum is not None else v
    return out


def _result(M, full: bool = False) -> dict:
    """A result matrix gathered (collective), with its layout and the
    fallback tally."""
    from slate_tpu_torch.internal import fallbacks

    G = (M.full_global() if full else M.to_global()).resolve_conj().numpy()
    return {"global": G, "layout": (M.layout.m, M.layout.n, M.layout.mb, M.layout.nb,
                                    M.layout.p, M.layout.q),
            "local_shape": tuple(M.data.shape), "fallbacks": fallbacks.counters()}


def case_blas3(grid, routine, args, opts=None, full=False, patch=()):
    """``blas3.<routine>`` on the mesh: ``args`` mixes scalars and matrix
    specs (tuples led by a kind name); ``patch`` names methods made to
    raise for the call (a gather the mesh path must not make)."""
    from slate_tpu_torch.drivers import blas3
    from slate_tpu_torch.enums import Side
    from slate_tpu_torch.internal import fallbacks
    from slate_tpu_torch.matrix.base import BaseMatrix
    from slate_tpu_torch.matrix.matrix import HermitianMatrix

    call = []
    for a in args:
        if isinstance(a, tuple) and a and a[0] in _kinds():
            call.append(_mat(grid, a))
        elif isinstance(a, str) and a in ("Left", "Right"):
            call.append(Side[a])
        else:
            call.append(a)
    fallbacks.reset()
    saved = []
    for owner, name in patch:
        cls = {"BaseMatrix": BaseMatrix, "HermitianMatrix": HermitianMatrix}[owner]
        saved.append((cls, name, cls.__dict__[name]))

        def boom(self, *a, _name=name, **kw):
            raise AssertionError(f"{_name} called on the mesh path")

        setattr(cls, name, boom)
    try:
        out = getattr(blas3, routine)(*call, opts=_opts(opts))
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return _result(out, full)


def case_raises(grid, routine, args, opts=None):
    """The exception type and text of ``routine`` (module.name) on the mesh."""
    import importlib

    from slate_tpu_torch.enums import Side

    mod, name = routine.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"slate_tpu_torch.drivers.{mod}"), name)
    call = [(_mat(grid, a) if isinstance(a, tuple) and a and a[0] in _kinds()
             else Side[a] if a in ("Left", "Right") else a) for a in args]
    try:
        fn(*call, opts=_opts(opts)) if opts is not None else fn(*call)
    except Exception as e:  # the test checks which
        return {"type": type(e).__name__, "text": str(e)}
    return {"type": None, "text": ""}


def case_layout(grid, a, mb, nb, kind="Matrix"):
    """from_global on the mesh: this rank's position and block, the round
    trip through to_global, and the layout's ownership answers."""
    M = _mat(grid, (kind, a, mb, nb, {}))
    lay = M.layout
    r, c = grid.position
    own = [[lay.tileIsLocal(i, j, r, c) for j in range(lay.nt)] for i in range(lay.mt)]
    whole = M.storage()
    return {"position": (r, c), "rank": grid.rank, "block": M.data.numpy(),
            "global": M.to_global().numpy(), "own": np.asarray(own),
            "ranks": grid.ranks, "storage": whole.numpy(),
            "shard": M._with(data=whole).shard().data.numpy()}


def case_grid(grid):
    """The grid as this rank sees it, and its row / column gathers."""
    import torch

    from slate_tpu_torch.parallel import collectives as coll

    me = torch.tensor([float(grid.rank)])
    return {"position": grid.position, "ranks": grid.ranks, "rank": grid.rank,
            "p": grid.p, "q": grid.q, "row": coll.all_gather(me, grid, "q").numpy().ravel(),
            "col": coll.all_gather(me, grid, "p").numpy().ravel()}


def case_make_grid(grid, p, q, n, device="cpu"):
    """The text of the exception ``from_ranks`` raises for a grid spec it
    refuses (it raises before any collective, on every rank alike)."""
    from slate_tpu_torch import ProcessGrid

    try:
        ProcessGrid.from_ranks(range(n), p, q, device=device)
    except Exception as e:  # the test checks which
        return str(e)
    return None


def case_norms(grid, spec, scopes=False):
    """Every norm kind of the matrix on the mesh (and colNorms / row sums)."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.drivers import aux

    M = _mat(grid, spec)
    out = {k.name: aux.norm(k, M).numpy() for k in (stt.Norm.Max, stt.Norm.One,
                                                     stt.Norm.Inf, stt.Norm.Fro)}
    if scopes:
        out["cols"] = aux.colNorms(stt.Norm.One, M).numpy()
        out["rows"] = aux.norm(stt.Norm.Inf, M, scope=stt.NormScope.Rows).numpy()
    return out


def case_redistribute(grid, src, dst, opts=None):
    """``redistribute(A, B)`` with A, B given as matrix specs."""
    from slate_tpu_torch.drivers import aux
    from slate_tpu_torch.internal import fallbacks

    A, B = _mat(grid, src), _mat(grid, dst)
    fallbacks.reset()
    return _result(aux.redistribute(A, B, opts=_opts(opts)))


#: the value functions ``case_aux`` hands to ``set_lambdas``, by name
LAMBDAS = {"i+10j": lambda i, j: i + 10 * j}


def case_aux(grid, routine, args):
    """``aux.<routine>`` on the mesh: ``args`` mixes scalars, matrix specs,
    numpy vectors (made tensors) and names of :data:`LAMBDAS`."""
    import torch

    from slate_tpu_torch.drivers import aux
    from slate_tpu_torch.internal import fallbacks

    call = []
    for a in args:
        if isinstance(a, tuple) and a and a[0] in _kinds():
            call.append(_mat(grid, a))
        elif isinstance(a, np.ndarray):
            call.append(torch.from_numpy(a))
        elif isinstance(a, str):
            call.append(LAMBDAS[a])
        else:
            call.append(a)
    fallbacks.reset()
    return _result(getattr(aux, routine)(*call))


def case_print(grid, spec, verbose=4):
    from slate_tpu_torch.drivers import aux

    return aux.print_matrix("A", _mat(grid, spec), verbose=verbose)


def _packed(x):
    """A driver's output made numpy: a matrix gathered (collective) with
    its layout and block shape, pivots as their perm, T factors as their
    stack, tensors as arrays; tuples item by item."""
    import torch

    from slate_tpu_torch.matrix.base import BaseMatrix
    from slate_tpu_torch.types import Pivots, TriangularFactors

    if isinstance(x, tuple):
        return tuple(_packed(v) for v in x)
    if isinstance(x, BaseMatrix):
        lay = x.layout
        return {"global": x.to_global().resolve_conj().numpy(),
                "layout": (lay.m, lay.n, lay.mb, lay.nb, lay.p, lay.q),
                "local_shape": tuple(x.data.shape), "uplo": x.uplo.name}
    if isinstance(x, Pivots):
        return {"perm": x.perm.numpy()}
    if isinstance(x, TriangularFactors):
        return {"T": x.T.resolve_conj().numpy()}
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return x


def case_driver(grid, routine, args, opts=None, patch=(), calls=()):
    """``routine`` (module.name of ``slate_tpu_torch.drivers``) on the mesh:
    ``args`` mixes scalars, side names and matrix specs.  Returns its
    packed output, the fallback tally, the texts of the warnings it gave
    and how often each ``calls`` entry (module.name of
    ``slate_tpu_torch.parallel``) ran; ``patch`` names methods made to
    raise for the call (a gather the mesh path must not make)."""
    import importlib
    import warnings

    from slate_tpu_torch.enums import Side
    from slate_tpu_torch.internal import fallbacks
    from slate_tpu_torch.matrix.base import BaseMatrix
    from slate_tpu_torch.matrix.matrix import HermitianMatrix

    mod, name = routine.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"slate_tpu_torch.drivers.{mod}"), name)
    call = [(_mat(grid, a) if isinstance(a, tuple) and a and a[0] in _kinds()
             else Side[a] if a in ("Left", "Right") else a) for a in args]
    fallbacks.reset()
    saved, counts = [], {c: 0 for c in calls}
    for owner, attr in patch:
        cls = {"BaseMatrix": BaseMatrix, "HermitianMatrix": HermitianMatrix}[owner]
        saved.append((cls, attr, cls.__dict__[attr]))

        def boom(self, *a, _name=attr, **kw):
            raise AssertionError(f"{_name} called on the mesh path")

        setattr(cls, attr, boom)
    for c in calls:
        m, f = c.rsplit(".", 1)
        target = importlib.import_module(f"slate_tpu_torch.parallel.{m}")
        orig = getattr(target, f)

        def counting(*a, _c=c, _orig=orig, **kw):
            counts[_c] += 1
            return _orig(*a, **kw)

        saved.append((target, f, orig))
        setattr(target, f, counting)
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            out = fn(*call, opts=_opts(opts))
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
    return {"out": _packed(out), "fallbacks": fallbacks.counters(),
            "warnings": [str(w.message) for w in got], "calls": counts}


def case_factor_then(grid, spec, factor, then, opts=None):
    """``then`` applied to the factors of ``factor`` (both module.name of
    ``slate_tpu_torch.drivers``) of the matrix ``spec`` on the mesh, e.g.
    ``lu.getri`` of ``lu.getrf``'s (LU, pivots) or ``qr.ungqr`` of
    ``qr.geqrf``'s (factor, T); returns the packed result."""
    import importlib

    def fn(name):
        mod, attr = name.rsplit(".", 1)
        return getattr(importlib.import_module(f"slate_tpu_torch.drivers.{mod}"), attr)

    out = fn(factor)(_mat(grid, spec), opts=_opts(opts))
    n_args = {"lu.getri": 2, "qr.ungqr": 2}[then]
    return _packed(fn(then)(*out[:n_args]))


KERNELS = ("chol_base", "syrk_diag", "gemm_sub", "panel_lu", "larft")


def case_kernel_reach(grid, a, spd, nb, opts=None):
    """The calls of the kernel wrappers (``KERNELS``) that ``potrf`` (of
    ``spd``), ``getrf``, CALU ``getrf`` and ``geqrf`` (of ``a``) make on the
    mesh with the tile and panel resolvers answering as on a CUDA device
    (the wrappers run their plain versions on the CPU)."""
    from slate_tpu_torch import HermitianMatrix, Matrix, MethodLU, Option
    from slate_tpu_torch.drivers import chol, lu, qr
    from slate_tpu_torch.ops import lu_kernels
    from slate_tpu_torch.ops.hopper import panel_kernels as pk
    from slate_tpu_torch.parallel import spmd_chol, spmd_qr

    counts = dict.fromkeys(KERNELS, 0)
    saved = []
    for k in KERNELS:
        def counting(*args, _k=k, _orig=getattr(pk, k), **kw):
            counts[_k] += 1
            return _orig(*args, **kw)

        saved.append((pk, k, getattr(pk, k)))
        setattr(pk, k, counting)
    for owner, name in ((spmd_chol, "tile_route"), (lu_kernels, "_panel_route"),
                        (spmd_qr, "larft_route")):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, lambda dtype, device, *rest, _orig=getattr(owner, name):
                _orig(dtype, "cuda", *rest))
    opts = _opts(opts) or {}
    calls = {
        "potrf": lambda: chol.potrf(HermitianMatrix.from_global(spd, nb, grid=grid), opts),
        "getrf": lambda: lu.getrf(Matrix.from_global(a, nb, grid=grid), opts),
        "calu": lambda: lu.getrf(Matrix.from_global(a, nb, grid=grid),
                                 {**opts, Option.MethodLU: MethodLU.CALU}),
        "geqrf": lambda: qr.geqrf(Matrix.from_global(a, nb, grid=grid), opts),
    }
    out = {}
    try:
        for label, call in calls.items():
            counts.update(dict.fromkeys(KERNELS, 0))
            call()
            out[label] = dict(counts)
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)
    return out


def case_permute_rows(grid, b, nb, perm):
    """``spmd_trsm.spmd_permute_rows`` of B (``b`` tiled nb) by ``perm``."""
    import torch

    from slate_tpu_torch.parallel import spmd_trsm

    B = _mat(grid, ("Matrix", b, nb, None, {}))
    out = spmd_trsm.spmd_permute_rows(grid, B.data, B.layout,
                                      torch.as_tensor(perm, dtype=torch.int32))
    return B._with(data=out).to_global().numpy()


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}
