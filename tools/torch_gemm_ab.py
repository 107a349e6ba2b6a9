#!/usr/bin/env python3
"""Time slate_tpu_torch's gemm_sub and syrk_diag on the card, for comparing
two versions of the kernel on one card.

Run it from the root of each tree (the package is imported from the
current directory), in turns, in one session on the card:

    for t in old . . old; do (cd $t && python /path/to/torch_gemm_ab.py $t); done

Prints one line: the tree's label, then for float64 and float32 the
times of ``gemm_sub`` at each shape class of a posv's trailing updates
at n = 16384 ((4096, 4096, 8192), (2048, 2048, 8192), (512, 512, 8192),
(256, 256, 8192)) and of ``syrk_diag`` at C (256, 256), A (256, 4096),
each beside one ``torch.addmm`` on the same operands (median of 10
CUDA-event timings after a warm-up).  Each kernel result is first held
against the library's to 10 sqrt(k) eps of the summands' magnitudes,
elementwise.
"""

import statistics
import sys

import torch

sys.path.insert(0, ".")
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
        print("torch_gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    pk._load()
    out = [sys.argv[1] if len(sys.argv) > 1 else "."]
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=dt)  # noqa: E731
        for M, K in ((4096, 8192), (2048, 8192), (512, 8192), (256, 8192)):
            C, A, B = rnd(M, M), rnd(M, K), rnd(M, K)
            ref = torch.addmm(C, A, B.T, alpha=-1)
            tol = 10 * K**0.5 * torch.finfo(dt).eps * torch.addmm(C.abs(), A.abs(), B.abs().T)
            if not bool(((pk.gemm_sub(C, A, B) - ref).abs() <= tol).all()):
                print(f"gemm_sub {name} ({M}, {M}, {K}) differs from addmm")
                return 1
            lib = ms(lambda: torch.addmm(C, A, B.T, alpha=-1))
            out.append(f"{name} gemm_sub ({M}, {M}, {K}) {ms(lambda: pk.gemm_sub(C, A, B)):.3f} ms "
                       f"(addmm {lib:.3f})")
            del C, A, B, ref, tol
        C, A = rnd(256, 256), rnd(256, 4096)
        ref = torch.tril(torch.addmm(C, A, A.T, alpha=-1))
        tol = 10 * 64 * torch.finfo(dt).eps * torch.addmm(C.abs(), A.abs(), A.abs().T)
        if not bool(((torch.tril(pk.syrk_diag(C, A)) - ref).abs() <= tol).all()):
            print(f"syrk_diag {name} differs from addmm")
            return 1
        lib = ms(lambda: torch.addmm(C, A, A.T, alpha=-1))
        out.append(f"{name} syrk_diag (256, 4096) {ms(lambda: pk.syrk_diag(C, A)):.4f} ms "
                   f"(addmm {lib:.4f})")
    print(" | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
