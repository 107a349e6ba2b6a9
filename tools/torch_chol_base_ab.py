#!/usr/bin/env python3
"""Time slate_tpu_torch's chol_base kernel on the card, for comparing two
versions of the kernel on one card.

Run it from the root of each tree (the package is imported from the
current directory), in turns, in one run on the card:

    for t in old . . old; do (cd $t && python /path/to/torch_chol_base_ab.py $t [--posv]); done

Prints one line: the tree's label, then ``chol_base`` on an SPD block
with junk above the diagonal at (256, 256) and (512, 512) (the block
sizes of ``Option.BlockSize`` 256 and 512) in float64 and float32, each
beside ``torch.linalg.cholesky`` (one library call) on the same block,
three ways: the median of 10 CUDA-event timings of one call after a
warm-up (what ``chip_smoke.py`` records: it includes the host's time
before the launch, while the card waits), the median of 10 CUDA-event
timings of 10 calls in a row over 10 (the card's time once the launches
queue up ahead of it), and the device time of the call's kernels in a
torch.profiler trace of 10 calls (the kernels alone: the wrapper's copy
and the factor).  Each shape is first checked against
``chol_base_plain``: the strict upper triangle bit for bit, the lower
triangle within ``10 sqrt(b) eps (|L||L|^T)_ij / L_jj`` elementwise, and
two calls bitwise equal.  ``--posv`` adds the chol_base piece of one
warm float64 ``posv`` at n = 16384, nrhs = 512: the device time of the
kernels named ``chol_base_kernel`` in a torch.profiler trace of the
call, and their launches.

``--steps`` takes the kernel apart instead: it builds this tree's
``csrc/panel_kernels.cu`` whole, with each step of ``chol_base_kernel``
left out, and with all of them left out, and prints each variant's
kernel time (device time in a profiler trace of 20 launches on a fresh
copy of the block) at (256, 256) in float64 and float32.  It knows two
kernels (``STEP_PATCHES``): the strip kernel of PRs 1-10 (a. warp 0
factors the 32 x 32 diagonal block, b. a thread a row solves the panel,
c. the trailing update in global memory, a warp a row) and the tiled
kernel of PR 11 (a. warp 0's factor of the next diagonal block, b. the
panel solve, c. the other warps' tiles, d. the update of the next
diagonal tile).  A step's cost is the whole kernel's time less the time
without it.  A variant leaves its block wrong; nothing of it is
checked.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
import slate_tpu_torch as stt  # noqa: E402
from slate_tpu_torch.ops.hopper import panel_kernels as pk  # noqa: E402

TOL_C = 10.0


def ms(fn, row=1, reps=10):
    """Median over ``reps`` of the CUDA-event time of ``row`` calls in a
    row, over ``row``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(row):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / row)
    return statistics.median(times)


def device_ms(fn, calls=10, key=""):
    """Device time a call of fn's kernels (those whose name holds
    ``key``), from a torch.profiler trace of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and key in e.key) / calls / 1e3


def three(fn):
    return f"{ms(fn):.4f} / {ms(fn, row=10):.4f} / {device_ms(fn):.4f}"


def spd_block(b, dt, dev, g):
    X = torch.randn(b, b, generator=g, device=dev, dtype=dt)
    G = X @ X.T + b * torch.eye(b, device=dev, dtype=dt)
    return G + torch.triu(torch.randn(b, b, generator=g, device=dev, dtype=dt), 1)


def check(G):
    """None when chol_base agrees with its plain version, else why not."""
    got, ref = pk.chol_base(G), pk.chol_base_plain(G)
    if not torch.equal(torch.triu(got, 1), torch.triu(G, 1)):
        return "the upper triangle changed"
    if not torch.equal(pk.chol_base(G), got):
        return "two calls differ"
    b = G.shape[0]
    L = torch.tril(ref)
    low = torch.ones(b, b, dtype=torch.bool, device=G.device).tril()
    scale = torch.where(low, (L.abs() @ L.abs().T) / L.diagonal().abs(), 1.0)
    limit = TOL_C * b**0.5 * torch.finfo(G.dtype).eps * scale
    ratio = float(((torch.tril(got) - L).abs() / limit).max())
    return None if ratio <= 1 else f"max err/tol {ratio:.3e}"


def posv_piece(dev, g):
    """(device ms, launches) of the chol_base kernels in one warm float64
    posv at n = 16384, nrhs = 512."""
    n, nrhs = 16384, 512
    X = torch.randn(n, n, generator=g, device=dev, dtype=torch.float64)
    A = X @ X.T
    A.diagonal().add_(n)
    del X
    B = torch.randn(n, nrhs, generator=g, device=dev, dtype=torch.float64)
    Am, Bm = stt.HermitianMatrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    stt.posv(Am, Bm)  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        stt.posv(Am, Bm)
        torch.cuda.synchronize()
    sel = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and "chol_base_kernel" in e.key
           and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    return sum(e.self_device_time_total for e in sel) / 1e3, sum(e.count for e in sel)


# each kernel's steps, each behind a switch (-DCB_SKIP_<step>=1) that
# leaves it out; --steps takes apart whichever kernel the tree has
STEP_PATCHES = {
    "the strip kernel (PRs 1-10)": {
        "a": [("    if (warp == 0) {\n      T d[CB_S];",
               "    if (warp == 0 && !CB_SKIP_a) {\n      T d[CB_S];")],
        "b": [("for (int t = tid; t < tt; t += CB_THREADS) {",
               "for (int t = tid; t < (CB_SKIP_b ? 0 : tt); t += CB_THREADS) {")],
        "c": [("for (int r = warp; r < tt; r += nwarps) {",
               "for (int r = warp; r < (CB_SKIP_c ? 0 : tt); r += nwarps) {")],
    },
    "the tiled kernel (PR 11)": {
        "a": [("      cb_factor(d, w, a, lda, j1, Dg, Rd, Xc);",
               "      if (!CB_SKIP_a) cb_factor(d, w, a, lda, j1, Dg, Rd, Xc);")],
        "b": [("    cb_panel(a, lda, b, k * CB_S, P, Dg, Rd);",
               "    if (!CB_SKIP_b) cb_panel(a, lda, b, k * CB_S, P, Dg, Rd);")],
        "c": [("q < nt * (nt + 1) / 2;", "q < (CB_SKIP_c ? 0 : nt * (nt + 1) / 2);")],
        "d": [("cb_tile_update(t, a, lda, b, j1, j1, P);",
               "if (!CB_SKIP_d) cb_tile_update(t, a, lda, b, j1, j1, P);"),
              ("cb_diag_rows(a, lda, b, j1, P, Dg, warp);",
               "if (!CB_SKIP_d) cb_diag_rows(a, lda, b, j1, P, Dg, warp);")],
    },
}


def steps(dev, g) -> str:
    src = pk.SOURCES[0].read_text()
    kernel, patches = next(((k, p) for k, p in STEP_PATCHES.items()
                            if all(src.count(old) == 1 for pairs in p.values()
                                   for old, _ in pairs)),
                           (None, None))
    if kernel is None:
        raise SystemExit(f"--steps: no kernel of STEP_PATCHES is in {pk.SOURCES[0]}")
    for pairs in patches.values():
        for old, new in pairs:
            src = src.replace(old, new)
    out_dir = Path("build") / "chol_base_steps"
    out_dir.mkdir(parents=True, exist_ok=True)
    patched = out_dir / "panel_kernels_steps.cu"
    patched.write_text(src)
    variants = {"whole": "", **{f"without {s}": s for s in patches},
                "without " + ", ".join(patches): "".join(patches)}
    jobs = {}
    for label, skip in variants.items():
        so = out_dir / f"lib_{skip or 'whole'}.so"
        flags = [f"-DCB_SKIP_{s}={int(s in skip)}" for s in patches]
        jobs[label] = (so, subprocess.Popen([pk._nvcc(), *pk.NVCC_FLAGS, *flags, "-o", str(so),
                                             str(patched)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"--steps: nvcc failed on {label}:\n{err}")
        libs[label] = ctypes.CDLL(str(so.resolve()))
    out = [kernel]
    for dt, suf in ((torch.float64, "f64"), (torch.float32, "f32")):
        b = 256
        G = spd_block(b, dt, dev, g)
        work = torch.empty_like(G)
        for label, lib in libs.items():
            fn = getattr(lib, f"slate_chol_base_{suf}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn, label=label):
                work.copy_(G)
                err = fn(work.data_ptr(), b, b, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"--steps: CUDA error {err} in {label}")

            t = device_ms(call, calls=20, key="chol_base_kernel")
            out.append(f"{suf} {label} {t:.4f} ms")
    return " | ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_chol_base_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.preferred_linalg_library("cusolver")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    pk._load()
    args = sys.argv[1:]
    label = next((a for a in args if not a.startswith("--")), ".")
    if "--steps" in args:
        print(f"{label} | chol_base (256, 256) kernel alone: {steps(dev, g)}", flush=True)
        return 0
    out = [label]
    for dt in (torch.float64, torch.float32):
        for b in (256, 512):
            G = spd_block(b, dt, dev, g)
            bad = check(G)
            if bad:
                print(f"chol_base differs from its plain version at ({b}, {b}) {dt}: {bad}")
                return 1
            out.append(f"{str(dt)[6:]} ({b}, {b}) {three(lambda: pk.chol_base(G))} ms "
                       f"(cholesky {three(lambda: torch.linalg.cholesky(G))})")
    if "--posv" in args:
        piece, launches = posv_piece(dev, g)
        out.append(f"posv f64 chol_base piece {piece:.3f} ms in {launches} launches")
    print(" | ".join(out) + "  [ms: one call / ten in a row / kernels alone]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
