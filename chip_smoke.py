#!/usr/bin/env python3
"""Smoke test of slate_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py            # all phases (exit 0 = passed)
    python3 chip_smoke.py --profile  # build + profiles of one warm posv and gesv

Phases, each for float64 and float32 unless stated:
  1. build the Hopper kernels from slate_tpu_torch/csrc (one nvcc a
     source, all at once; timed), print the card, its power limit, the
     torch/CUDA versions and TF32 switches;
  2. hold every kernel against its plain PyTorch version at the shapes of
     the main paths (panel_lu with bitwise-equal perm, butterfly_level,
     the trsm pair in its Cholesky and packed-LU modes), and time kernel,
     plain version and one library call;
  3. the Cholesky main path: ``posv`` at n = 16384, nrhs = 512 with
     default options (Schedule.Auto must take the Hopper kernel family),
     scaled residual, info, launch counts against the schedule's mirror;
     then ``potrs_from_global`` on the factor through the trsm kernels;
  4. the LU main path: ``gesv`` at n = 16384, nrhs = 512 with default
     options (panel_lu launches against the mirror, getrf time against
     ``torch.linalg.lu_factor``); then ``getrs_from_global`` on the
     packed factor with P B through the trsm pair;
  5. ``gesv`` with MethodLU.RBT at n = 16384, nrhs = 512: 16
     butterfly_level launches, residual within the JAX package's bound;
  6. small cases: ``posv`` and ``gesv`` at n = 1000 with Schedule.Pallas
     (pad and splice), float64; a non-SPD matrix and a singular one give
     info > 0 and no exception.

Any failure exits non-zero.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels; the card's name and power limit
are printed on a line of their own before that.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

N_MAIN, NRHS_MAIN = 16384, 512
PEAK_FLOPS = 67e12  # H100 SXM: FP32 SIMT and FP64 tensor-core peak (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DTYPES = ("float64", "float32")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of fn in ms (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


TOL_C = 10.0


def elementwise_err(got, ref, scale, k: int):
    """(max |got - ref|, max |got - ref| / tol) with an elementwise
    tol = TOL_C sqrt(k) eps scale: the probabilistic rounding bound of a
    length-k sum (Higham and Mary, 2019), where ``scale`` is the sum of
    the magnitudes of the summands of each result (|A||B|^T + |C| for a
    product update, |T||X| + |B| for a triangular solve).  The ratio is
    NaN, and so fails, where either result is not finite."""
    diff = (got - ref).abs()
    limit = TOL_C * k**0.5 * torch.finfo(got.dtype).eps * scale
    return float(diff.max()), float((diff / limit).max())


def scaled_residual(A, X, B) -> float:
    """||A X - B||_1 / (||A||_1 ||X||_1 n eps), the repo tester's bound."""
    A64, X64, B64 = A.double(), X.double(), B.double()
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    r = n1(A64 @ X64 - B64) / (n1(A64) * n1(X64) * A.shape[0])
    return r / torch.finfo(A.dtype).eps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _recorder(out: dict, dtype: str):
    def record(name, err, ratio, ms, plain_ms, flops, nbytes, lib_ms, replaces):
        check(ratio <= 1, f"{name} {dtype}: max err/tol {ratio:.3e} > 1 (max_abs_err {err:.3e})")
        b_ms, b_by = bound(flops, nbytes)
        out[name] = {
            "max_abs_err": err, "err_over_tol": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "replaces": replaces,
        }
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        print(f"  {name:15s} {dtype}: err {err:.3e} (max err/tol {ratio:.3e})  kernel "
              f"{ms:.3f} ms  plain {plain_ms:.3f} ms  library {lib}  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    return record


def kernel_phase(pk, dtype, gen, dev) -> dict:
    dt = getattr(torch, dtype)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731
    esz = torch.finfo(dt).bits // 8
    out = {}
    record = _recorder(out, dtype)

    # chol_base at (256, 256)
    b = 256
    X = rnd(b, b)
    G = X @ X.T + b * torch.eye(b, device=dev, dtype=dt)
    G = G + torch.triu(rnd(b, b), 1)  # junk above the diagonal must pass through
    got, ref = pk.chol_base(G), pk.chol_base_plain(G)
    torch.cuda.synchronize()
    check(torch.equal(torch.triu(got, 1), torch.triu(G, 1)),
          f"chol_base {dtype}: the upper triangle changed")
    # L_ij = (G_ij - sum_k L_ik L_jk) / L_jj: the summands' scale is
    # (|L||L|^T)_ij / L_jj; the lower triangle only
    Lr = torch.tril(ref)
    low = torch.ones(b, b, dtype=torch.bool, device=dev).tril()
    scale = torch.where(low, (Lr.abs() @ Lr.abs().T) / Lr.diagonal().abs(), 1.0)
    err, ratio = elementwise_err(torch.tril(got), Lr, scale, b)
    record("chol_base", err, ratio, cuda_ms(lambda: pk.chol_base(G)),
           cuda_ms(lambda: pk.chol_base_plain(G), reps=3),
           b**3 / 3.0, 2.0 * b * b * esz,
           cuda_ms(lambda: torch.linalg.cholesky(G)),
           "slate_tpu/ops/pallas/panel_kernels.py:188")

    # syrk_diag with C (256, 256), A (256, 4096)
    t, h = 256, 4096
    C, A = rnd(t, t), rnd(t, h)
    got, ref = pk.syrk_diag(C, A), pk.syrk_diag_plain(C, A)
    torch.cuda.synchronize()
    check(torch.equal(torch.triu(got, 1), torch.triu(C, 1)),
          f"syrk_diag {dtype}: the upper triangle changed")
    err, ratio = elementwise_err(got, ref, A.abs() @ A.abs().T + C.abs(), h)
    record("syrk_diag", err, ratio, cuda_ms(lambda: pk.syrk_diag(C, A)),
           cuda_ms(lambda: pk.syrk_diag_plain(C, A)),
           float(t) * t * h, (t * h + 2.0 * t * t) * esz,
           cuda_ms(lambda: torch.addmm(C, A, A.T, alpha=-1)),
           "slate_tpu/ops/pallas/panel_kernels.py:368")

    # gemm_sub at (4096, 4096, k = 8192)
    M, N, K = 4096, 4096, 8192
    C, A, B = rnd(M, N), rnd(M, K), rnd(N, K)
    got, ref = pk.gemm_sub(C, A, B), pk.gemm_sub_plain(C, A, B)
    err, ratio = elementwise_err(got, ref, A.abs() @ B.abs().T + C.abs(), K)
    del got
    record("gemm_sub", err, ratio, cuda_ms(lambda: pk.gemm_sub(C, A, B)),
           cuda_ms(lambda: pk.gemm_sub_plain(C, A, B)),
           2.0 * M * N * K, (M * K + N * K + 2.0 * M * N) * esz,
           cuda_ms(lambda: torch.addmm(C, A, B.T, alpha=-1)),
           "slate_tpu/ops/pallas/panel_kernels.py:403")
    del C, A, B, ref

    # trsm pair at n = 16384, nrhs = 512.  The strict triangle is randn /
    # sqrt(n), so the update from the solved rows moves X by O(1), and the
    # powers of the strict triangle fall off factorially, so the solves
    # stay well conditioned (condition number ~3 with diagonal 2)
    n, nrhs = N_MAIN, NRHS_MAIN
    off = torch.tril(rnd(n, n), -1) / n**0.5
    eye = torch.eye(n, device=dev, dtype=dt)
    Lnu, Lu = off + 2 * eye, off + eye
    del off, eye
    Bm = rnd(n, nrhs)
    flops, nbytes = float(n) * n * nrhs, (n * n / 2.0 + 2.0 * n * nrhs) * esz
    # (name, case, kernel, plain, T as stored, op(T) as solved, unread triangle)
    cases = [
        ("trsm_lower", "nonunit", lambda T: pk.trsm_lower(T, Bm),
         lambda T: pk.trsm_plain(T, Bm, True), Lnu, Lnu, "upper"),
        ("trsm_lower", "unit", lambda T: pk.trsm_lower(T, Bm, unit=True),
         lambda T: pk.trsm_plain(T, Bm, True, unit=True), Lu, Lu, "upper"),
        ("trsm_upper", "upper", lambda T: pk.trsm_upper(T, Bm),
         lambda T: pk.trsm_plain(T, Bm, False), Lnu.T.contiguous(), Lnu.T, "lower"),
        ("trsm_upper", "transposed", lambda T: pk.trsm_upper(T, Bm, transposed=True),
         lambda T: pk.trsm_plain(T, Bm, False, transposed=True), Lnu, Lnu.T, "upper"),
    ]
    for name, case, kern, plain, T, Top, other in cases:
        ref = plain(T)
        got = kern(T)
        err, ratio = elementwise_err(got, ref, Top.abs() @ ref.abs() + Bm.abs(), n)
        check(ratio <= 1, f"{name}/{case} {dtype}: max err/tol {ratio:.3e} > 1")
        # the update must carry weight: X is far from B / diag(T)
        moved = float((ref - Bm / Top.diagonal()[:, None]).abs().max())
        check(moved > 0.1, f"{name}/{case} {dtype}: the update moves X by {moved:.3e} only")
        # packed storage: NaN in the other triangle must not enter
        mask = torch.ones(n, n, dtype=torch.bool, device=dev)
        mask = torch.triu(mask, 1) if other == "upper" else torch.tril(mask, -1)
        if case == "unit":
            mask |= torch.eye(n, dtype=torch.bool, device=dev)  # unit: diagonal unread
        packed = torch.where(mask, torch.full_like(T, float("nan")), T)
        del mask
        gp = kern(packed)
        check(bool(torch.isfinite(gp).all()) and torch.equal(gp, got),
              f"{name}/{case} {dtype}: the other triangle leaked into the solve")
        del packed, gp
        print(f"  {name}/{case} {dtype}: err {err:.3e} (max err/tol {ratio:.3e}), "
              f"update moves X by {moved:.3e}, packed storage ok", flush=True)
        if case in ("nonunit", "transposed"):
            lib = (lambda T=T: torch.linalg.solve_triangular(T, Bm, upper=False)) \
                if name == "trsm_lower" else \
                (lambda T=T: torch.linalg.solve_triangular(T.T, Bm, upper=True))
            record(name, err, ratio, cuda_ms(lambda: kern(T)),
                   cuda_ms(lambda: plain(T)), flops, nbytes, cuda_ms(lib),
                   "slate_tpu/ops/pallas/panel_kernels.py:"
                   + ("507" if name == "trsm_lower" else "516"))

    # the LU modes of the pair, on packed LU storage: U untransposed with
    # randn junk in the strict lower triangle (L's multipliers), and unit
    # L with randn junk on and above the diagonal (U)
    off_u = torch.triu(rnd(n, n), 1) / n**0.5
    U = off_u + 2 * torch.eye(n, device=dev, dtype=dt)
    del off_u
    packed_u = U + torch.tril(rnd(n, n), -1)
    Lunit = Lu
    del Lnu, Lu
    packed_l = torch.tril(Lunit, -1) + torch.triu(rnd(n, n))
    lu_cases = [
        ("trsm_upper", lambda T: pk.trsm_upper(T, Bm), lambda T: pk.trsm_plain(T, Bm, False),
         packed_u, U),
        ("trsm_lower", lambda T: pk.trsm_lower(T, Bm, unit=True),
         lambda T: pk.trsm_plain(T, Bm, True, unit=True), packed_l, Lunit),
    ]
    for name, kern, plain, T, Top in lu_cases:
        ref = plain(T)
        got = kern(T)
        err, ratio = elementwise_err(got, ref, Top.abs() @ ref.abs() + Bm.abs(), n)
        check(ratio <= 1, f"{name}/packed-LU {dtype}: max err/tol {ratio:.3e} > 1")
        clean = kern(Top)
        check(torch.equal(got, clean), f"{name}/packed-LU {dtype}: the junk entered the solve")
        moved = float((ref - Bm / Top.diagonal()[:, None]).abs().max())
        check(moved > 0.1, f"{name}/packed-LU {dtype}: the update moves X by {moved:.3e} only")
        ms, plain_ms = cuda_ms(lambda: kern(T)), cuda_ms(lambda: plain(T))
        lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
            T, Bm, upper=name == "trsm_upper", unitriangular=name == "trsm_lower"))
        out[name]["lu_mode"] = {"max_abs_err": err, "err_over_tol": ratio, "ms": ms,
                                "plain_ms": plain_ms, "library_ms": lib_ms}
        print(f"  {name}/packed-LU {dtype}: err {err:.3e} (max err/tol {ratio:.3e}), update "
              f"moves X by {moved:.3e}, junk ignored; kernel {ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms  library {lib_ms:.3f} ms", flush=True)
    del packed_u, packed_l, U, Lunit, Bm, ref, got, clean, cases, lu_cases, T, Top
    return out


def lu_error(lu, ref_lu, k: int):
    """Elementwise error of a packed LU against the reference, held to
    10 sqrt(k) eps times the summands' magnitudes: (|L||U|)_ic on and
    above the diagonal, (|L||U|)_ic / |u_cc| below it (k = min(M, nb))."""
    M, nb = ref_lu.shape
    L = torch.tril(ref_lu[:, :k], -1)
    L[torch.arange(k), torch.arange(k)] = 1
    U = torch.triu(ref_lu[:k])
    scale = L.abs() @ U.abs()
    below = torch.ones(M, nb, dtype=torch.bool, device=ref_lu.device).tril(-1)
    below[:, k:] = False
    d = U.diagonal().abs()
    dcols = torch.ones(nb, dtype=ref_lu.dtype, device=ref_lu.device)
    dcols[:k] = torch.where(d == 0, torch.ones_like(d), d)
    scale = torch.where(below, scale / dcols, scale)
    # zero summands (the canonical pad rows) must give exact zeros
    scale = torch.where(scale == 0, torch.finfo(scale.dtype).tiny, scale)
    return elementwise_err(lu, ref_lu, scale, k)


def lu_kernel_phase(pk, lk, dtype, gen, dev) -> dict:
    """panel_lu and butterfly_level against their plain versions."""
    dt = getattr(torch, dtype)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731
    esz = torch.finfo(dt).bits // 8
    out = {}
    record = _recorder(out, dtype)

    # panel_lu: the leftmost panel of the n = 16384 recursion (16384, 256),
    # then a canonical-pad panel: 10000 true rows padded with exact zeros
    # to the lattice height 12288 (act < M)
    nb = 256
    for M, act in ((N_MAIN, None), (lk._lat_height(10000), 10000)):
        P = rnd(M, nb)
        if act is not None:
            P[act:] = 0
        got, perm = pk.panel_lu(P, act=act)
        ref, ref_perm = pk.panel_lu_plain(P, act=act)
        check(torch.equal(perm, ref_perm), f"panel_lu {dtype} {M}x{nb}: perm differs")
        if act is not None:
            check(torch.equal(perm[act:].long(), torch.arange(act, M, device=dev)),
                  f"panel_lu {dtype}: a pad row pivoted")
        err, ratio = lu_error(got, ref, nb)
        bitwise = torch.equal(got, ref)
        print(f"  panel_lu {dtype} ({M}, {nb}, act={act}): perm equal, LU bitwise "
              f"{bitwise}, err {err:.3e} (max err/tol {ratio:.3e})", flush=True)
        if act is None:
            k = min(M, nb)
            flops = sum((M - j - 1) * (1 + 2.0 * (nb - j - 1)) for j in range(k))
            record("panel_lu", err, ratio, cuda_ms(lambda: pk.panel_lu(P)),
                   cuda_ms(lambda: pk.panel_lu_plain(P), reps=3), flops,
                   2.0 * M * nb * esz + 4.0 * M, cuda_ms(lambda: torch.linalg.lu_factor(P)),
                   "slate_tpu/ops/pallas/panel_kernels.py:250")
        else:
            check(ratio <= 1, f"panel_lu {dtype} act: max err/tol {ratio:.3e} > 1")
        del P, got, ref

    # butterfly_level: one level over the matrix (16384, 16384) and over
    # the right-hand sides (16384, 512), both directions, the two levels of
    # depth 2 (h = 8192, 4096)
    n2 = N_MAIN
    D = torch.exp(torch.rand(n2, generator=gen, device=dev, dtype=dt) * 0.2 - 0.1)
    for w in (N_MAIN, NRHS_MAIN):
        X = rnd(n2, w)
        for transpose, h in ((True, n2 // 2), (False, n2 // 4)):
            got = pk.butterfly_level(X, D, h, transpose)
            ref = pk.butterfly_level_plain(X, D, h, transpose)
            # summands: |d1 x1| + |d2 x2| (transpose), |d1| (|x1| + |x2|)
            # and |d2| (|x1| + |x2|) otherwise; k = 2, scaled by sqrt(1/2)
            blocks = n2 // (2 * h)
            Dr = D.reshape(blocks, 2 * h, 1).abs()
            Xr = X.reshape(blocks, 2 * h, w).abs()
            if transpose:
                s = Dr[:, :h] * Xr[:, :h] + Dr[:, h:] * Xr[:, h:]
                scale = torch.cat([s, s], 1).reshape(n2, w)
            else:
                s = Xr[:, :h] + Xr[:, h:]
                scale = torch.cat([Dr[:, :h] * s, Dr[:, h:] * s], 1).reshape(n2, w)
            err, ratio = elementwise_err(got, ref, scale, 2)
            bitwise = torch.equal(got, ref)
            print(f"  butterfly_level {dtype} ({n2}, {w}) transpose={transpose} h={h}: "
                  f"bitwise {bitwise}, err {err:.3e} (max err/tol {ratio:.3e})", flush=True)
            check(ratio <= 1, f"butterfly_level {dtype}: max err/tol {ratio:.3e} > 1")
            if w == N_MAIN and transpose:
                record("butterfly_level", err, ratio,
                       cuda_ms(lambda: pk.butterfly_level(X, D, h, True)),
                       cuda_ms(lambda: pk.butterfly_level_plain(X, D, h, True)),
                       4.0 * n2 * w, (2.0 * n2 * w + n2) * esz, None,
                       "slate_tpu/ops/pallas/kernels.py:199")
            del got, ref, scale, s, Xr
        del X
    return out


# ---------------------------------------------------------------------------
# phases 3-5: the drivers
# ---------------------------------------------------------------------------


def spd(n, dt, gen, dev):
    X = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    A = X @ X.T
    A.diagonal().add_(n)
    return A


def main_path(stt, pk, ck, metrics, dtype, gen, dev) -> dict:
    dt = getattr(torch, dtype)
    n, nrhs = N_MAIN, NRHS_MAIN
    check(ck.resolve_schedule(n, "auto", dev) == "pallas",
          "Schedule.Auto does not resolve to the Hopper kernel family")
    A = spd(n, dt, gen, dev)
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am = stt.HermitianMatrix.from_global(A, 512)
    Bm = stt.Matrix.from_global(B, 512)
    torch.cuda.synchronize()

    metrics.reset()
    pk.reset_launches()  # counts of the main path only
    X, L, info = stt.posv(Am, Bm)
    torch.cuda.synchronize()
    factor_counts = {k: pk.LAUNCHES[k] for k in ("chol_base", "syrk_diag", "gemm_sub")}
    Lg = L.to_global()
    Y = stt.potrs_from_global(Lg, B, "auto")
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)

    check(int(info) == 0, f"posv {dtype}: info = {int(info)}")
    r_posv = scaled_residual(A, X.to_global(), B)
    r_solve = scaled_residual(A, Y, B)
    expect = ck.chol_kernel_launches(n)
    t_fact = metrics.timers()["potrf"]["total_s"]
    gflops = n**3 / 3.0 / t_fact / 1e9
    print(f"  posv {dtype} n={n} nrhs={nrhs}: residual {r_posv:.3e}, info 0, "
          f"potrf {t_fact:.3f} s = {gflops:.1f} GFLOP/s (model n^3/3), "
          f"launches {factor_counts} (expected {expect})", flush=True)
    print(f"  potrs_from_global {dtype}: residual {r_solve:.3e}, "
          f"trsm launches lower {launches['trsm_lower']} upper {launches['trsm_upper']}",
          flush=True)
    check(r_posv <= 3, f"posv {dtype}: scaled residual {r_posv:.3f} > 3")
    check(r_solve <= 3, f"potrs_from_global {dtype}: scaled residual {r_solve:.3f} > 3")
    check(factor_counts == expect, f"posv {dtype}: launches {factor_counts} != {expect}")
    check(launches["trsm_lower"] >= 1 and launches["trsm_upper"] >= 1,
          f"potrs_from_global {dtype}: trsm kernels not launched")
    del X, L, Lg, Y, Am, Bm
    t_lib = cuda_ms(lambda: torch.linalg.cholesky(A), reps=3)
    print(f"  torch.linalg.cholesky {dtype} n={n}: {t_lib:.3f} ms "
          f"(yardstick, {n**3 / 3.0 / t_lib / 1e6:.1f} GFLOP/s)", flush=True)
    return {"launches": launches, "residual": r_posv, "solve_residual": r_solve,
            "potrf_s": t_fact, "potrf_gflops": gflops, "cholesky_lib_ms": t_lib}


def small_pallas(stt, pk, ck, gen, dev) -> None:
    n, dt = 1000, torch.float64
    A = spd(n, dt, gen, dev)
    B = torch.randn(n, 7, generator=gen, device=dev, dtype=dt)
    pk.reset_launches()
    X, _, info = stt.posv(stt.HermitianMatrix.from_global(A, 128),
                          stt.Matrix.from_global(B, 128),
                          {stt.Option.Schedule: "pallas"})
    torch.cuda.synchronize()
    r = scaled_residual(A, X.to_global(), B)
    got = {k: pk.LAUNCHES[k] for k in ("chol_base", "syrk_diag", "gemm_sub")}
    expect = ck.chol_kernel_launches(n)
    print(f"  posv float64 n={n} schedule=pallas: residual {r:.3e}, info {int(info)}, "
          f"launches {got}", flush=True)
    check(int(info) == 0 and r <= 3, "posv n=1000 pallas failed")
    check(got == expect, f"posv n=1000: launches {got} != {expect}")


def non_spd(stt, gen, dev) -> None:
    n = 2048
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        X = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
        A = X + X.T  # symmetric indefinite
        B = torch.ones(n, 1, device=dev, dtype=dt)
        _, _, info = stt.posv(stt.HermitianMatrix.from_global(A, 256),
                              stt.Matrix.from_global(B, 256))
        print(f"  non-SPD {dtype} n={n}: info {int(info)}", flush=True)
        check(int(info) > 0, f"non-SPD {dtype}: info = 0")


def lu_main_path(stt, pk, lk, metrics, dtype, gen, dev) -> dict:
    """gesv at n = 16384, nrhs = 512, default options, then
    getrs_from_global on its packed factor with P B."""
    dt = getattr(torch, dtype)
    n, nrhs = N_MAIN, NRHS_MAIN
    check(lk.resolve_lu_schedule(n, n, dt, "auto", dev) == "pallas",
          "Schedule.Auto does not resolve to the Hopper kernel family for getrf")
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    torch.cuda.synchronize()

    metrics.reset()
    pk.reset_launches()  # counts of the main path only
    X, LU, piv, info = stt.gesv(Am, Bm)
    torch.cuda.synchronize()
    gesv_counts = dict(pk.LAUNCHES)
    t_getrf = metrics.timers()["getrf"]["total_s"]
    t_gesv = metrics.timers()["gesv"]["total_s"]
    check(int(info) == 0, f"gesv {dtype}: info = {int(info)}")
    r_gesv = scaled_residual(A, X.to_global(), B)
    expect = lk.getrf_kernel_launches(n, 256, 1)
    print(f"  gesv {dtype} n={n} nrhs={nrhs}: residual {r_gesv:.3e}, info 0, getrf "
          f"{t_getrf:.3f} s = {2 * n**3 / 3.0 / t_getrf / 1e9:.1f} GFLOP/s (model 2n^3/3), "
          f"gesv {t_gesv:.3f} s, panel_lu launches {gesv_counts['panel_lu']} "
          f"(expected {expect})", flush=True)
    check(r_gesv <= 3, f"gesv {dtype}: scaled residual {r_gesv:.3f} > 3")
    check(gesv_counts["panel_lu"] == expect,
          f"gesv {dtype}: panel_lu launches {gesv_counts['panel_lu']} != {expect}")

    LUg = LU.to_global().contiguous()
    PB = piv.apply(B)
    del X, LU, Am, Bm
    pk.reset_launches()
    Y = stt.getrs_from_global(LUg, PB)
    torch.cuda.synchronize()
    solve_counts = dict(pk.LAUNCHES)
    r_solve = scaled_residual(A, Y, B)
    print(f"  getrs_from_global {dtype}: residual {r_solve:.3e}, trsm launches lower "
          f"{solve_counts['trsm_lower']} upper {solve_counts['trsm_upper']}", flush=True)
    check(r_solve <= 3, f"getrs_from_global {dtype}: scaled residual {r_solve:.3f} > 3")
    check(solve_counts["trsm_lower"] == 1 and solve_counts["trsm_upper"] == 1,
          f"getrs_from_global {dtype}: trsm launches {solve_counts}")
    t_solve = cuda_ms(lambda: stt.getrs_from_global(LUg, PB), reps=3)
    t_solve_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
        LUg, torch.linalg.solve_triangular(LUg, PB, upper=False, unitriangular=True),
        upper=True), reps=3)
    del Y, LUg, PB
    t_lib = cuda_ms(lambda: torch.linalg.lu_factor(A), reps=3)
    print(f"  getrs_from_global {dtype}: {t_solve:.3f} ms, two library solves "
          f"{t_solve_lib:.3f} ms; torch.linalg.lu_factor n={n}: {t_lib:.3f} ms (yardstick, "
          f"{2 * n**3 / 3.0 / t_lib / 1e6:.1f} GFLOP/s)", flush=True)
    return {"launches": gesv_counts, "residual": r_gesv, "solve_residual": r_solve,
            "getrf_s": t_getrf, "gesv_s": t_gesv, "lu_factor_lib_ms": t_lib,
            "getrs_from_global_ms": t_solve, "two_library_solves_ms": t_solve_lib}


def rbt_path(stt, pk, dtype, gen, dev) -> dict:
    """gesv with MethodLU.RBT at n = 16384, nrhs = 512: depth 2, so 4
    butterfly levels on A and 4 for each of the 3 solves (the first and
    two refinement steps)."""
    dt = getattr(torch, dtype)
    n, nrhs = N_MAIN, NRHS_MAIN
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    torch.cuda.synchronize()
    pk.reset_launches()
    t0 = time.perf_counter()
    X, _, _, info = stt.gesv(Am, Bm, {stt.Option.MethodLU: stt.MethodLU.RBT})
    torch.cuda.synchronize()
    t_rbt = time.perf_counter() - t0
    counts = dict(pk.LAUNCHES)
    r = scaled_residual(A, X.to_global(), B)
    print(f"  gesv_rbt {dtype} n={n} nrhs={nrhs}: residual {r:.3e} (bound 1000), info "
          f"{int(info)}, {t_rbt:.3f} s, butterfly_level launches "
          f"{counts['butterfly_level']}, panel_lu (no pivoting) {counts['panel_lu']}",
          flush=True)
    check(int(info) == 0, f"gesv_rbt {dtype}: info = {int(info)}")
    check(r <= 1000, f"gesv_rbt {dtype}: scaled residual {r:.3f} > 1000")
    check(counts["butterfly_level"] == 16,
          f"gesv_rbt {dtype}: butterfly_level launches {counts['butterfly_level']} != 16")
    return {"launches": counts, "residual": r, "gesv_rbt_s": t_rbt}


def small_lu(stt, pk, lk, gen, dev) -> None:
    """gesv at n = 1000 with Schedule.Pallas (pad to 1024 and splice);
    a matrix with one exact zero column gives info > 0, no exception."""
    n, dt = 1000, torch.float64
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(n, 7, generator=gen, device=dev, dtype=dt)
    pk.reset_launches()
    X, _, _, info = stt.gesv(stt.Matrix.from_global(A, 128), stt.Matrix.from_global(B, 128),
                             {stt.Option.Schedule: "pallas"})
    torch.cuda.synchronize()
    r = scaled_residual(A, X.to_global(), B)
    expect = lk.getrf_kernel_launches(1024, 256, 1)
    print(f"  gesv float64 n={n} schedule=pallas: residual {r:.3e}, info {int(info)}, "
          f"panel_lu launches {pk.LAUNCHES['panel_lu']} (expected {expect})", flush=True)
    check(int(info) == 0 and r <= 3, "gesv n=1000 pallas failed")
    check(pk.LAUNCHES["panel_lu"] == expect, "gesv n=1000: panel_lu launches")
    n = 2048
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
        A[:, 1234] = 0  # singular
        B = torch.ones(n, 1, device=dev, dtype=dt)
        pk.reset_launches()
        _, _, _, info = stt.gesv(stt.Matrix.from_global(A, 256), stt.Matrix.from_global(B, 256))
        torch.cuda.synchronize()
        print(f"  singular {dtype} n={n}: info {int(info)}, panel_lu launches "
              f"{pk.LAUNCHES['panel_lu']}", flush=True)
        check(int(info) > 0, f"singular {dtype}: info = 0")
        check(pk.LAUNCHES["panel_lu"] == lk.getrf_kernel_launches(n), "singular: launches")


def _profile_call(label, fn) -> None:
    """torch.profiler's device time by kernel over one call of fn and the
    host wall time of that same call, then the operator table."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    # device activity only (kernels, copies, sets): host ops would count
    # the kernels they launch a second time
    rows = sorted((e for e in ka if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    print(f"  profiled {label}: device busy {busy:.4f} s of {t_prof:.4f} s wall of the same "
          f"call (idle share {max(0.0, 1 - busy / t_prof):.3f}; the wall time includes "
          f"the profiler's own host cost)")
    for e in rows[:15]:
        print(f"    {dev_us(e) / 1e3:10.3f} ms  {e.count:6d} x  {e.key[:90]}")
    print(ka.table(sort_by="self_device_time_total", row_limit=25))


def profile(stt, gen, dev) -> None:
    """Wall time of one warm ``posv`` and one warm ``gesv`` (n = 16384,
    nrhs = 512, float64, default options), then a profile of a third call
    of each."""
    n, nrhs, dt = N_MAIN, NRHS_MAIN, torch.float64
    A = spd(n, dt, gen, dev)
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.HermitianMatrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    for _ in range(2):  # the first call is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stt.potrf(Am)
        torch.cuda.synchronize()
        t_potrf = time.perf_counter() - t0
        t0 = time.perf_counter()
        stt.posv(Am, Bm)
        torch.cuda.synchronize()
        t_posv = time.perf_counter() - t0
    print(f"  warm potrf {t_potrf:.4f} s, posv {t_posv:.4f} s (host clock, float64 n={n})")
    _profile_call("posv", lambda: stt.posv(Am, Bm))
    del Am, A
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stt.getrf(Am)
        torch.cuda.synchronize()
        t_getrf = time.perf_counter() - t0
        t0 = time.perf_counter()
        stt.gesv(Am, Bm)
        torch.cuda.synchronize()
        t_gesv = time.perf_counter() - t0
    print(f"  warm getrf {t_getrf:.4f} s, gesv {t_gesv:.4f} s (host clock, float64 n={n})")
    _profile_call("gesv", lambda: stt.gesv(Am, Bm))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import slate_tpu_torch as stt
        from slate_tpu_torch.aux import metrics
        from slate_tpu_torch.ops import chol_kernels as ck
        from slate_tpu_torch.ops import lu_kernels as lk
        from slate_tpu_torch.ops.hopper import panel_kernels as pk
    except ImportError as e:
        print(f"chip_smoke: slate_tpu_torch is not importable here: {e}", file=sys.stderr)
        return 2
    profile_only = "--profile" in sys.argv[1:]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the yardstick torch.linalg.lu_factor is cuSOLVER's getrf (the port
    # calls it only on the vendor route, which these phases do not take)
    torch.backends.cuda.preferred_linalg_library("cusolver")
    dev = torch.device("cuda:0")

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    sos, log = pk.build(verbose=True)
    pk._load()
    print(f"  built {', '.join(so.name for so in sos)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc a source, in parallel)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"  tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    if profile_only:
        print("profile: posv and gesv, float64", flush=True)
        profile(stt, gen, dev)
        print(smi)
        return 0
    t_start = time.perf_counter()
    print("phase 2: kernels against their plain versions", flush=True)
    kres = {d: kernel_phase(pk, d, gen, dev) for d in DTYPES}
    for d in DTYPES:
        kres[d].update(lu_kernel_phase(pk, lk, d, gen, dev))
    torch.cuda.empty_cache()

    metrics.on()
    print("phase 3: posv + potrs_from_global, the Cholesky main path", flush=True)
    mres = {d: main_path(stt, pk, ck, metrics, d, gen, dev) for d in DTYPES}
    torch.cuda.empty_cache()
    print("phase 4: gesv + getrs_from_global, the LU main path", flush=True)
    lres = {d: lu_main_path(stt, pk, lk, metrics, d, gen, dev) for d in DTYPES}
    torch.cuda.empty_cache()
    print("phase 5: gesv with MethodLU.RBT", flush=True)
    rres = {d: rbt_path(stt, pk, d, gen, dev) for d in DTYPES}
    torch.cuda.empty_cache()
    print("phase 6: small cases", flush=True)
    small_pallas(stt, pk, ck, gen, dev)
    small_lu(stt, pk, lk, gen, dev)
    non_spd(stt, gen, dev)
    print(f"  phases 2-6: {time.perf_counter() - t_start:.1f} s", flush=True)

    # launches: of the main path that runs each kernel (posv for the
    # Cholesky kernels and the trsm pair of potrs_from_global, gesv for
    # panel_lu, gesv with MethodLU.RBT for butterfly_level)
    sources = {"panel_lu": ("lu_kernels.cu", lres), "butterfly_level": ("lu_kernels.cu", rres)}
    entries = []
    for d, suf in (("float64", "f64"), ("float32", "f32")):
        for name in ("chol_base", "syrk_diag", "gemm_sub", "trsm_lower", "trsm_upper",
                     "panel_lu", "butterfly_level"):
            k = kres[d][name]
            src, runs = sources.get(name, ("panel_kernels.cu", mres))
            entries.append({
                "name": f"{name}.{suf}", "route": "cuda",
                "source": f"slate_tpu_torch/csrc/{src}",
                "replaces": k["replaces"], "launches": runs[d]["launches"][name],
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            })
    lu_modes = {d: {name: kres[d][name]["lu_mode"] for name in ("trsm_lower", "trsm_upper")}
                for d in DTYPES}
    strip = lambda r: {d: {k: v for k, v in r[d].items() if k != "launches"}  # noqa: E731
                       for d in DTYPES}
    print("main path: " + json.dumps({"posv": strip(mres), "gesv": strip(lres),
                                      "gesv_rbt": strip(rres), "trsm_lu_modes": lu_modes}))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
