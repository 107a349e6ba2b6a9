#!/usr/bin/env python3
"""Time slate_tpu_torch's panel_lu kernel and one warm getrf on the card,
for comparing two versions of the kernel on one card.

Run it from the root of each tree (the package is imported from the
current directory), in turns, in one session on the card:

    for t in old . . old; do (cd $t && python /path/to/torch_panel_lu_ab.py $t); done

Prints one line: the tree's label, panel_lu at (16384, 256) and
(4096, 256) in float64 and float32 and without pivoting (the RBT route's
panel) at (16384, 256) in float64 (median of 10 CUDA-event timings
after a warm-up; each checked bit for bit against the plain version
first), and the host-clock times of one warm float64 getrf and one warm
float64 ``gesv`` with MethodLU.RBT (nrhs = 512) at n = 16384.
"""

import statistics
import sys
import time

import torch

sys.path.insert(0, ".")
import slate_tpu_torch as stt  # noqa: E402
from slate_tpu_torch.ops.hopper import panel_kernels as pk  # noqa: E402


def ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_panel_lu_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    pk._load()
    out = [sys.argv[1] if len(sys.argv) > 1 else "."]
    for dt in (torch.float64, torch.float32):
        for M in (16384, 4096):
            P = torch.randn(M, 256, generator=g, device=dev, dtype=dt)
            lu, p = pk.panel_lu(P)
            rl, rp = pk.panel_lu_plain(P)
            if not (torch.equal(p, rp) and torch.equal(lu, rl)):
                print(f"panel_lu differs from its plain version at {M}x256 {dt}")
                return 1
            out.append(f"{str(dt)[6:]} {M}x256 {ms(lambda: pk.panel_lu(P)):.3f} ms")
    P = torch.randn(16384, 256, generator=g, device=dev, dtype=torch.float64)
    P += 16384 * torch.eye(16384, 256, device=dev, dtype=torch.float64)
    lu, p = pk.panel_lu(P, pivot=False)
    rl, rp = pk.panel_lu_plain(P, pivot=False)
    if not (torch.equal(p, rp) and torch.equal(lu, rl)):
        print("panel_lu without pivoting differs from its plain version")
        return 1
    out.append(f"nopiv float64 16384x256 {ms(lambda: pk.panel_lu(P, pivot=False)):.3f} ms")
    A = torch.randn(16384, 16384, generator=g, device=dev, dtype=torch.float64)
    Am = stt.Matrix.from_global(A, 512)
    stt.getrf(Am)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stt.getrf(Am)
    torch.cuda.synchronize()
    out.append(f"getrf f64 16384 {time.perf_counter() - t0:.4f} s")
    Bm = stt.Matrix.from_global(torch.randn(16384, 512, generator=g, device=dev,
                                            dtype=torch.float64), 512)
    rbt = {stt.Option.MethodLU: stt.MethodLU.RBT}
    for _ in range(2):  # the first call is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stt.gesv(Am, Bm, rbt)
        torch.cuda.synchronize()
    out.append(f"rbt gesv f64 16384 {time.perf_counter() - t0:.4f} s")
    print(" | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
