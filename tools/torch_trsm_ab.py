#!/usr/bin/env python3
"""Time slate_tpu_torch's trsm pair on the card, for comparing two versions
of the kernel on one card.

Run it from the root of each tree (the package is imported from the
current directory), in turns, in one session on the card:

    for t in old . . old; do (cd $t && python /path/to/torch_trsm_ab.py $t); done

Prints one line: the tree's label, then for float64 and float32 and
nrhs = 1 and 512 at n = 16384 the times of ``trsm_lower`` (non-unit) and
of ``trsm_upper`` with ``transposed`` (the two sweeps of a Cholesky
solve) and of ``torch.linalg.solve_triangular`` on the same solve
(median of 10 CUDA-event timings after a warm-up).  Each kernel result
is first held against the library's to 10 sqrt(n) eps of the summands'
magnitudes, elementwise.

``python torch_trsm_ab.py LABEL --parts`` (a tree whose kernel takes a
launch table) adds one line a dtype
and nrhs with the forward sweep taken apart by running the kernel on
launch tables of its own (times only; these runs solve nothing): the
sweep; its owners' chain alone (every launch without its far row
blocks); the chain without the owners' updates (the diagonal solves);
and one launch of far row blocks over all of op(T) with K = 256 and
K = 8192 source rows, as the FLOP rate of their products.
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


def sweep_parts(L, B) -> str:
    """The forward sweep of L X = B taken apart (see the module note)."""
    n, nrhs = B.shape
    X = torch.empty_like(B)

    def run(table):
        plan = pk._trsm_table_array(table)

        def call():
            err, _ = pk._trsm_sweep(L, B, X, True, False, False, plan)
            if err:
                raise RuntimeError(f"trsm: CUDA error {err}")
        return call

    f = pk.TRSM_TABLE_FIELDS
    table = [dict(zip(f, row)) for row in pk.trsm_launch_table(n, True)]
    chain = [tuple({**r, "far_count": 0}[k] for k in f) for r in table]
    diag = [tuple({**r, "far_count": 0, "own_kw": 0}[k] for k in f) for r in table]
    out = [f"sweep {ms(run([tuple(r[k] for k in f) for r in table])):.3f} ms",
           f"chain {ms(run(chain)):.3f} ms", f"diagonal solves {ms(run(diag)):.3f} ms"]
    kb = pk.TRSM_KB
    for K in (256, 8192):
        rows = (n - K) // kb  # far row blocks below the K source rows
        t = ms(run([(0, 0, 0, K, kb, rows, 0, K, 0)]))
        out.append(f"far K={K} {2.0 * rows * kb * nrhs * K / t / 1e9:.1f} TFLOP/s")
    return ", ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_trsm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    pk._load()
    n = 16384
    out, parts = [sys.argv[1] if len(sys.argv) > 1 else "."], []
    for dt in (torch.float64, torch.float32):
        # strict triangle randn / sqrt(n), diagonal 2: well conditioned
        L = torch.tril(torch.randn(n, n, generator=g, device=dev, dtype=dt), -1) / n**0.5
        L += 2 * torch.eye(n, device=dev, dtype=dt)
        for nrhs in (1, 512):
            B = torch.randn(n, nrhs, generator=g, device=dev, dtype=dt)
            for label, kern, Top, upper in (
                    ("lower", lambda: pk.trsm_lower(L, B), L, False),
                    ("transposed", lambda: pk.trsm_upper(L, B, transposed=True), L.T, True)):
                ref = torch.linalg.solve_triangular(Top, B, upper=upper)
                tol = 10 * n**0.5 * torch.finfo(dt).eps * (Top.abs() @ ref.abs() + B.abs())
                if not bool(((kern() - ref).abs() <= tol).all()):
                    print(f"trsm {label} {dt} nrhs={nrhs} differs from the library's solve")
                    return 1
                lib = ms(lambda: torch.linalg.solve_triangular(Top, B, upper=upper))
                out.append(f"{str(dt)[6:]} {label} nrhs={nrhs} {ms(kern):.3f} ms "
                           f"(library {lib:.3f})")
            if "--parts" in sys.argv[2:]:
                parts.append(f"{str(dt)[6:]} nrhs={nrhs}: " + sweep_parts(L, B))
        del L, B
    print(" | ".join(out), flush=True)
    for line in parts:
        print("  parts", line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
