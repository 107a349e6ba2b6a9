#!/usr/bin/env python3
"""Time slate_tpu_torch's norm drivers and its tile_norms kernel on the
card, for comparing two versions of them on one card.

Run it from the root of each tree (the package is imported from the
current directory), in turns, in one run on the card:

    for t in old . . old; do (cd $t && python /path/to/torch_tile_norms_ab.py $t); done

Prints two lines a tree (float64, then float32), each led by the tree's
label:

* ``stt.norm`` One, Inf, Max and Fro and ``stt.colNorms`` of a 16384^2
  normal matrix in tiles of 512, and Fro of the same matrix times 1e300
  (float64) or 1e30 (float32), which takes the scaled pass, each beside
  one library call on the same matrix (``matrix_norm`` 1 / inf / "fro",
  ``A.abs().amax()``, ``vector_norm(A, 1, dim=0)``), two ways: the
  median of 10 CUDA-event timings of one call after a warm-up, and the
  median of 10 CUDA-event timings of 10 calls in a row over 10;
* ``tile_norms`` alone on the (1024, 512, 512) tile stack of the matrix,
  every kind the tree's kernel has (without counts: the contract both
  trees share), beside ``vector_norm`` over the tiles (inf-norm for max,
  2-norm for fro_sumsq and max_sumsq, 1-norm down the columns for one,
  along the rows for inf), three ways: one call, ten in a row, and the
  device time of the call's kernels in a torch.profiler trace of 10
  calls.

Every norm is first held to a float64 reference (Max bitwise equal to
``amax``, the others within ``10 sqrt(n) eps`` relative) and each kind
to ``tile_norms_plain``; a miss prints why and exits 1.  Imports
nothing of the JAX package.

``--variants`` builds this tree's ``csrc/tile_kernels.cu`` once as it
is and once with each patch of ``VARIANTS`` (one ``nvcc`` each, all
started together) and prints, for each, the registers ptxas gives the
16-byte kernels and the device time of every kind alone on the
(1024, 512, 512) stack in float64 and float32 (a torch.profiler trace
of 20 launches; median and range of three rounds, every variant and
``vector_norm`` timed in turn in each round).  ``--host`` prints where the
host's time goes in one call of each norm (float32, 16384^2): the
median host time to enqueue the call, and the functions with the most
own time in a cProfile of 50 calls.
"""

import cProfile
import ctypes
import pstats
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, ".")
import slate_tpu_torch as stt  # noqa: E402
from slate_tpu_torch.ops.hopper import panel_kernels as pk  # noqa: E402

N, TILE = 16384, 512
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


def device_ms(fn, calls=10):
    """Device time a call of fn's kernels, from a torch.profiler trace of
    ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / calls / 1e3


def two(fn):
    return f"{ms(fn):.4f} / {ms(fn, row=10):.4f}"


def three(fn):
    return f"{two(fn)} / {device_ms(fn):.4f}"


def fail(msg):
    print(f"torch_tile_norms_ab: {msg}", flush=True)
    sys.exit(1)


def norms(A, scaled_by) -> list:
    """The norm drivers beside their library calls, after checking each."""
    Am = stt.Matrix.from_global(A, TILE)
    A64 = A.double()
    tol = TOL_C * N**0.5 * torch.finfo(A.dtype).eps
    lib = {"One": lambda: torch.linalg.matrix_norm(A, 1),
           "Inf": lambda: torch.linalg.matrix_norm(A, float("inf")),
           "Max": lambda: A.abs().amax(),
           "Fro": lambda: torch.linalg.matrix_norm(A, "fro")}
    ref = {"One": torch.linalg.matrix_norm(A64, 1),
           "Inf": torch.linalg.matrix_norm(A64, float("inf")),
           "Fro": torch.linalg.matrix_norm(A64, "fro")}
    for name, call in lib.items():
        got = stt.norm(stt.Norm[name], Am)
        if name == "Max":
            if not torch.equal(got, call()):
                fail(f"norm Max {A.dtype}: not bitwise equal to amax")
        elif float((got.double() - ref[name]).abs() / ref[name]) > tol:
            fail(f"norm {name} {A.dtype}: {float(got)} against {float(ref[name])}")
    cn = stt.colNorms(stt.Norm.One, Am)
    cref = A64.abs().sum(0)
    if float(((cn.double() - cref).abs() / cref).max()) > tol:
        fail(f"colNorms {A.dtype}: off the reference")
    Ms = stt.Matrix.from_global(A * scaled_by, TILE)
    got = stt.norm(stt.Norm.Fro, Ms)
    want = ref["Fro"] * scaled_by
    if not bool(torch.isfinite(got)) or float((got.double() - want).abs() / want) > tol:
        fail(f"norm Fro of A x {scaled_by:g} {A.dtype}: {float(got)} against {float(want)}")
    del A64, cn, cref
    timed = {name: (lambda name=name: stt.norm(stt.Norm[name], Am), call)
             for name, call in lib.items()}
    timed["colNorms"] = (lambda: stt.colNorms(stt.Norm.One, Am),
                         lambda: torch.linalg.vector_norm(A, 1, dim=0))
    timed[f"Fro of A x {scaled_by:g}"] = (lambda: stt.norm(stt.Norm.Fro, Ms), None)
    for ours, theirs in timed.values():  # one warm round, so no call is timed first
        ours(), theirs and theirs()
    torch.cuda.synchronize()
    return [f"{name} {two(ours)}" + (f" (library {two(theirs)})" if theirs else "")
            for name, (ours, theirs) in timed.items()]


def kinds(A) -> list:
    """Each kind of tile_norms alone, beside vector_norm over the tiles."""
    n, t = A.shape[0], TILE
    S = A.reshape(n // t, t, n // t, t).transpose(1, 2).reshape(-1, t, t).contiguous()
    lib = {"max": lambda: torch.linalg.vector_norm(S, float("inf"), dim=(1, 2)),
           "fro_sumsq": lambda: torch.linalg.vector_norm(S, 2, dim=(1, 2)),
           "max_sumsq": lambda: torch.linalg.vector_norm(S, 2, dim=(1, 2)),
           "one": lambda: torch.linalg.vector_norm(S, 1, dim=1),
           "inf": lambda: torch.linalg.vector_norm(S, 1, dim=2)}
    out = []
    for kind in [k for k in lib if k in pk._NORM_KINDS]:
        got, ref = pk.tile_norms(S, kind), pk.tile_norms_plain(S, kind)
        k = {"max": 1, "one": t, "inf": t}.get(kind, t * t)
        limit = TOL_C * k**0.5 * torch.finfo(S.dtype).eps * ref.abs()
        bad = (kind == "max" and not torch.equal(got, ref)) or not bool(
            ((got - ref).abs() <= limit).all())
        if bad:
            fail(f"tile_norms {kind} {S.dtype}: off its plain version")
        out.append(f"{kind} {three(lambda: pk.tile_norms(S, kind))} "
                   f"(vector_norm {three(lib[kind])})")
    return out


# patches of csrc/tile_kernels.cu, each (old, new) text found once
_PLAIN = [("v[0] = __ldcs(p);", "v[0] = p[0];"),
          ("__ldcs(reinterpret_cast<const double2*>(p));", "*reinterpret_cast<const double2*>(p);"),
          ("__ldcs(reinterpret_cast<const float4*>(p));", "*reinterpret_cast<const float4*>(p);")]
_FLOAT_MAX = [("m = abs_max(v, m);", "m = nan_max(v, m);")]
VARIANTS = {
    "no wave rule": [("  if (k < km) dyn =", "  if (false) dyn =")],
    "unroll 4 everywhere": [("(KIND == kOne || KIND == kInf || KIND == kMaxSumsq) ? 8 : 4;",
                             "(KIND == kOne || KIND == kInf || KIND == kMaxSumsq) ? 4 : 4;")],
    "unroll 8 everywhere": [("(KIND == kOne || KIND == kInf || KIND == kMaxSumsq) ? 8 : 4;",
                             "(KIND == kOne || KIND == kInf || KIND == kMaxSumsq) ? 8 : 8;")],
    "plain loads": _PLAIN,
    "float64 max by compares": _FLOAT_MAX,
}
KINDS = ("max", "fro_sumsq", "max_sumsq", "one", "inf")


def variants(g, dev, rounds=3) -> None:
    """Every variant's kinds, and vector_norm, timed in ``rounds``
    interleaved rounds; prints the median and range of each."""
    src = pk.SOURCES[2].read_text()
    out_dir = Path("build") / "tile_norms_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (label, patch) in enumerate({"as built": [], **VARIANTS}.items()):
        text = src
        for old, new in patch:
            if text.count(old) != 1:
                raise SystemExit(f"--variants: {label}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        jobs[label] = (so, subprocess.Popen(
            [pk._nvcc(), *pk.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    n, t = N, TILE
    stacks = {dt: torch.randn(n * n // (t * t), t, t, generator=g, device=dev, dtype=dt)
              for dt in (torch.float64, torch.float32)}
    calls = {}  # (label, dtype, kind) -> a call
    for dt, S in stacks.items():
        for kind, f in (("max", lambda S=S: torch.linalg.vector_norm(S, float("inf"), dim=(1, 2))),
                        ("fro_sumsq", lambda S=S: torch.linalg.vector_norm(S, 2, dim=(1, 2))),
                        ("one", lambda S=S: torch.linalg.vector_norm(S, 1, dim=1)),
                        ("inf", lambda S=S: torch.linalg.vector_norm(S, 1, dim=2))):
            calls[("vector_norm", dt, kind)] = f
    regs = {}
    for label, (so, proc) in jobs.items():
        out, err = proc.communicate()
        err = out + err
        if proc.returncode != 0:
            raise SystemExit(f"--variants: nvcc failed on {label}:\n{err}")
        regs[label] = {f"{m.group(1)}{m.group(2)}": int(m.group(3)) for m in re.finditer(
            r"tile_norms_kernelI([df])Li[24]ELi(\d)E.*?Used (\d+) registers", err, re.S)}
        lib = ctypes.CDLL(str(so.resolve()))
        for dt, S in stacks.items():
            suf = "f64" if dt == torch.float64 else "f32"
            fn = getattr(lib, f"slate_tile_norms_{suf}")
            fn.argtypes, fn.restype = pk._SIGNATURES["tile_norms"], ctypes.c_int
            N_, mb, nb = S.shape
            res = getattr(lib, f"slate_tile_norms_residency_{suf}", None)
            for kind in KINDS if res is not None else ():
                k2 = (ctypes.c_int * 2)()
                res(N_, pk._NORM_KINDS[kind], k2)
                regs[label][f"{suf} {kind} blocks an SM"] = f"{k2[1]} of {k2[0]}"
            o = torch.empty(N_ * max(mb, nb, 2), dtype=dt, device=dev)
            for kind in KINDS:
                def call(fn=fn, kind=kind, o=o, S=S, label=label):
                    err = fn(S.data_ptr(), S.stride(0), S.stride(1), N_, mb, nb,
                             pk._NORM_KINDS[kind], None, None, 1, None, None, 1, o.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"--variants: CUDA error {err} in {label}")
                calls[(label, dt, kind)] = call
    times = {key: [] for key in calls}
    for _ in range(rounds):
        for key, call in calls.items():
            times[key].append(device_ms(call, calls=20))
    for label in ["vector_norm", "as built", *VARIANTS]:
        line = [f"{label}: registers {regs.get(label, '-')}"]
        for dt in stacks:
            for kind in KINDS:
                ts = times.get((label, dt, kind))
                if ts:
                    line.append(f"{str(dt)[6:]} {kind} {statistics.median(ts):.4f} "
                                f"[{min(ts):.4f}-{max(ts):.4f}]")
        print(" | ".join(line), flush=True)


def host(g, dev) -> None:
    A = torch.randn(N, N, generator=g, device=dev, dtype=torch.float32)
    Am = stt.Matrix.from_global(A, TILE)
    calls = {name: (lambda name=name: stt.norm(stt.Norm[name], Am))
             for name in ("Max", "One", "Inf", "Fro")}
    calls["colNorms"] = lambda: stt.colNorms(stt.Norm.One, Am)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        prof = cProfile.Profile()
        for _ in range(50):
            prof.enable()
            fn()
            prof.disable()
            torch.cuda.synchronize()
        st = pstats.Stats(prof).sort_stats("tottime")
        top = [f"{fn_[2]} {tt / 50 * 1e6:.1f}" for fn_, (_, _, tt, _, _) in
               sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]]
        print(f"host {name}: enqueue {statistics.median(times) * 1e6:.1f} us; own time a call, "
              f"us: " + ", ".join(top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tile_norms_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    pk._load()
    label = next((a for a in sys.argv[1:] if not a.startswith("--")), ".")
    if "--variants" in sys.argv[1:]:
        variants(g, dev)
        return 0
    if "--host" in sys.argv[1:]:
        host(g, dev)
        return 0
    for dt, c in ((torch.float64, 1e300), (torch.float32, 1e30)):
        A = torch.randn(N, N, generator=g, device=dev, dtype=dt)
        parts = norms(A, c) + kinds(A)
        print(f"{label} | {str(dt)[6:]} | " + " | ".join(parts)
              + "  [ms: one call / ten in a row (/ kernels alone)]", flush=True)
        del A
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
