#!/usr/bin/env python3
"""Time slate_tpu_torch's larft kernel on the card, for comparing two
versions of the kernel on one card.

Run it from the root of each tree (the package is imported from the
current directory), in turns, in one run on the card:

    for t in old . . old; do (cd $t && python /path/to/torch_larft_ab.py $t [--gels]); done

Prints one line: the tree's label, then ``larft_tinv`` on the V of a
factored (32768, 256) and (24576, 256) panel (the two heights of the
gels main path) in float64 and float32, each beside ``V.mT @ V`` (one
library call for the full Gram) on the same V, three ways: the median of
10 CUDA-event timings of one call after a warm-up (what ``chip_smoke.py``
records: it includes the host's time before the launch, while the card
waits), the median of 10 CUDA-event timings of 10 calls in a row over 10
(the card's time once the launches queue up ahead of it), and the device
time of the call's kernels in a torch.profiler trace of 10 calls (the
kernels alone).  Each shape is first checked against
``larft_tinv_plain``: the diagonal bit for bit, the lower triangle
exactly zero, the strict upper part within ``10 sqrt(M) eps (|V|^T |V|)``
elementwise.  ``--gels`` adds the larft piece of one warm float64
``gels`` at (32768, 16384), nrhs = 512: the device time of the larft
kernels in a torch.profiler trace of the call (device activity only),
and their launches.
"""

import statistics
import sys

import torch

sys.path.insert(0, ".")
import slate_tpu_torch as stt  # noqa: E402
from slate_tpu_torch.ops.hopper import panel_kernels as pk  # noqa: E402
from slate_tpu_torch.ops.householder import materialize_v  # noqa: E402

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
    """Device time of fn's kernels a call, from a torch.profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / calls / 1e3


def three(fn):
    return f"{ms(fn):.4f} / {ms(fn, row=10):.4f} / {device_ms(fn):.4f}"


def check(V, taus):
    """None when larft_tinv agrees with its plain version, else why not."""
    got, ref = pk.larft_tinv(V, taus), pk.larft_tinv_plain(V, taus)
    if not torch.equal(got.diagonal(), ref.diagonal()):
        return "the diagonal differs"
    if bool(torch.tril(got, -1).any()):
        return "the lower triangle is not zero"
    scale = V.abs().T @ V.abs()
    limit = TOL_C * V.shape[0] ** 0.5 * torch.finfo(V.dtype).eps * scale
    ratio = float(torch.triu((got - ref).abs() / limit.clamp_min(torch.finfo(V.dtype).tiny),
                             1).max())
    return None if ratio <= 1 else f"max err/tol {ratio:.3e}"


def gels_piece(dev, g):
    """(device ms, launches) of the larft kernels in one warm float64
    gels: the time of both kernels of each call, the launches of the
    first."""
    m, n, nrhs = 32768, 16384, 512
    A = torch.randn(m, n, generator=g, device=dev, dtype=torch.float64)
    B = torch.randn(m, nrhs, generator=g, device=dev, dtype=torch.float64)
    Am, Bm = stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    stt.gels(Am, Bm)  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        stt.gels(Am, Bm)
        torch.cuda.synchronize()
    sel = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and "larft_" in e.key
           and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    return (sum(e.self_device_time_total for e in sel) / 1e3,
            sum(e.count for e in sel if "larft_gram_kernel" in e.key))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_larft_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    pk._load()
    args = sys.argv[1:]
    out = [next((a for a in args if not a.startswith("--")), ".")]
    for dt in (torch.float64, torch.float32):
        for M in (32768, 24576):
            fac, taus = torch.geqrf(torch.randn(M, 256, generator=g, device=dev, dtype=dt))
            V = materialize_v(fac.contiguous())
            bad = check(V, taus)
            if bad:
                print(f"larft_tinv differs from its plain version at {M}x256 {dt}: {bad}")
                return 1
            out.append(f"{str(dt)[6:]} {M}x256 {three(lambda: pk.larft_tinv(V, taus))} ms "
                       f"(V.mT @ V {three(lambda: V.mT @ V)})")
    if "--gels" in args:
        piece, launches = gels_piece(dev, g)
        out.append(f"gels f64 larft piece {piece:.3f} ms in {launches} launches")
    print(" | ".join(out) + "  [ms: one call / ten in a row / kernels alone]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
