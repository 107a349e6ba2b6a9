#!/usr/bin/env python3
"""Smoke test of slate_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py            # all phases (exit 0 = passed)
    python3 chip_smoke.py --profile  # build + profiles of one warm posv (with its chol_base,
                                     # gemm_sub and syrk_diag pieces), gesv (with its panel_lu
                                     # piece) and gels (with its larft piece) and of one
                                     # warm solve phase of posv and gesv

Phases, each for float64 and float32 unless stated:
  1. build the Hopper kernels from slate_tpu_torch/csrc (one nvcc a
     source, all at once; timed), print the card, its power limit, the
     torch/CUDA versions and TF32 switches;
  2. hold every kernel against its plain PyTorch version at the shapes of
     the main paths (panel_lu with bitwise-equal perm, butterfly_level,
     the trsm pair in its six modes: lower, unit lower, upper,
     transposed and the two packed-LU modes, each timed against
     ``solve_triangular``, plus nrhs = 1, and at the seams of its
     schedule on strided views), and time kernel, plain version and one
     library call;
  3. the Cholesky main path: ``posv`` at n = 16384, nrhs = 512 with
     default options (Schedule.Auto must take the Hopper kernel family),
     scaled residual, info, launch counts against the schedule's mirror;
     then ``potrs_from_global`` on the factor through the trsm kernels
     (``trsm_kernel_launches`` each), timed against two library solves;
  4. the LU main path: ``gesv`` at n = 16384, nrhs = 512 with default
     options (panel_lu launches against the mirror, getrf time against
     ``torch.linalg.lu_factor``); then ``getrs_from_global`` on the
     packed factor with P B through the trsm pair, timed likewise;
  5. ``gesv`` with MethodLU.RBT at n = 16384, nrhs = 512: 16
     butterfly_level launches, residual within the JAX package's bound;
  6. small cases: ``posv`` and ``gesv`` at n = 1000 with Schedule.Pallas
     (pad and splice), float64; a non-SPD matrix and a singular one give
     info > 0 and no exception;
  7. the QR main path: ``gels`` at (m, n) = (32768, 16384), nrhs = 512,
     tiles of 512, default options (Schedule.Auto must take the larft
     kernel's family: 64 launches), normal-equations residual, geqrf rate
     against ``torch.geqrf`` and ``torch.linalg.lstsq``; then
     ``gels_solve_from_global`` on the serve tier's pack of the factor
     against ``torch.ormqr`` + a library solve;
  8. small QR cases, float64: ``geqrf`` + ``ungqr`` at n = 4096 (factor
     and orthogonality residuals), ``gels`` with MethodGels.CholQR at
     (32768, 16384) through the Cholesky kernels, and an underdetermined
     ``gels`` at (2000, 6000) with Schedule.Pallas (the LQ dual);
  9. norms of a 16384^2 matrix in tiles of 512: One, Inf, Max (bitwise
     equal to the library's), Fro and colNorms, one tile_norms launch
     each (two for Fro), and Fro of the matrix times 1e300 / 1e-160
     (float64) or 1e30 / 1e-20 (float32), the scaled pass, against a
     float64 reference; Hermitian and triangular norms on the JAX
     package's plain route (no launch);
 10. complex128 ``posv``, ``gesv`` (with both solve phases), ``gesv``
     with MethodLU.RBT and ``gels`` at n = 2048, default options: the
     recursive schedule and the library solves (the kernels take
     float32/float64 only), residuals within bound, no kernel launch.

Phase 2 also holds chol_base at (256, 256) and (512, 512) (the upper
triangle bit for bit, two calls and a strided view bitwise equal), and
gemm_sub and syrk_diag at the seams of their tiles
and K ring (both tile variants, ragged and short K, unaligned rows, the
K split; bitwise repeatable), times gemm_sub against ``addmm`` at each
shape class of a posv, and holds larft (T^-1 of factored (32768, 256)
and (24576, 256) panels and of a view at column offset 5: the diagonal
bitwise, the lower triangle exactly zero, two calls bitwise equal),
tile_norms (every kind and max_sumsq; then with ragged counts and NaN
in the padding, fro_sumsq with a scale and with skip), and the unrouted
tile_geadd and tile_transpose (bitwise) against their plain versions on
the (1024, 512, 512) tile stack of a 16384^2 matrix.

Any failure exits non-zero.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels; the card's name and power limit
are printed on a line of their own before that.
"""

from __future__ import annotations

import ctypes
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


def chol_base_case(pk, b, dtype, rnd, dev):
    """chol_base on a (b, b) SPD block with junk above the diagonal,
    held to its plain version: the strict upper triangle bit for bit,
    two calls and a strided view (lda > b) bitwise equal, and the lower
    triangle elementwise within TOL_C sqrt(b) eps (|L||L|^T)_ij / L_jj
    (L_ij = (G_ij - sum_k L_ik L_jk) / L_jj: the summands' scale).
    Returns (the block, max abs error, max error over tolerance)."""
    dt = getattr(torch, dtype)
    X = rnd(b, b)
    G = X @ X.T + b * torch.eye(b, device=dev, dtype=dt)
    G = G + torch.triu(rnd(b, b), 1)  # junk above the diagonal must pass through
    got, ref = pk.chol_base(G), pk.chol_base_plain(G)
    torch.cuda.synchronize()
    check(torch.equal(torch.triu(got, 1), torch.triu(G, 1)),
          f"chol_base ({b}, {b}) {dtype}: the upper triangle changed")
    check(torch.equal(pk.chol_base(G), got), f"chol_base ({b}, {b}) {dtype}: two calls differ")
    big = torch.zeros(b + 9, b + 13, device=dev, dtype=dt)
    big[4:4 + b, 6:6 + b] = G
    check(torch.equal(pk.chol_base(big[4:4 + b, 6:6 + b]), got),
          f"chol_base ({b}, {b}) {dtype}: a strided view differs from the block")
    Lr = torch.tril(ref)
    low = torch.ones(b, b, dtype=torch.bool, device=dev).tril()
    scale = torch.where(low, (Lr.abs() @ Lr.abs().T) / Lr.diagonal().abs(), 1.0)
    err, ratio = elementwise_err(torch.tril(got), Lr, scale, b)
    return G, err, ratio


def kernel_phase(pk, dtype, gen, dev) -> dict:
    dt = getattr(torch, dtype)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731
    esz = torch.finfo(dt).bits // 8
    out = {}
    record = _recorder(out, dtype)

    # chol_base at (256, 256), the main path's block; then (512, 512),
    # Option.BlockSize 512's, held alike and timed, no bar
    G, err, ratio = chol_base_case(pk, 256, dtype, rnd, dev)
    record("chol_base", err, ratio, cuda_ms(lambda: pk.chol_base(G)),
           cuda_ms(lambda: pk.chol_base_plain(G), reps=3),
           256**3 / 3.0, 2.0 * 256 * 256 * esz,
           cuda_ms(lambda: torch.linalg.cholesky(G)),
           "slate_tpu/ops/pallas/panel_kernels.py:188")
    G, err, ratio = chol_base_case(pk, 512, dtype, rnd, dev)
    check(ratio <= 1, f"chol_base (512, 512) {dtype}: max err/tol {ratio:.3e} > 1")
    ms, lib_ms = cuda_ms(lambda: pk.chol_base(G)), cuda_ms(lambda: torch.linalg.cholesky(G))
    out["chol_base"]["b512"] = {"max_abs_err": err, "err_over_tol": ratio, "ms": ms,
                                "library_ms": lib_ms}
    print(f"  chol_base (512, 512) {dtype}: err {err:.3e} (max err/tol {ratio:.3e})  kernel "
          f"{ms:.3f} ms  library {lib_ms:.3f} ms", flush=True)
    del G

    # syrk_diag with C (256, 256), A (256, 4096)
    t, h = 256, 4096
    C, A = rnd(t, t), rnd(t, h)
    got, ref = pk.syrk_diag(C, A), pk.syrk_diag_plain(C, A)
    torch.cuda.synchronize()
    check(torch.equal(torch.triu(got, 1), torch.triu(C, 1)),
          f"syrk_diag {dtype}: the upper triangle changed")
    check(torch.equal(pk.syrk_diag(C, A), got), f"syrk_diag {dtype}: two calls differ")
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
    check(torch.equal(pk.gemm_sub(C, A, B), got), f"gemm_sub {dtype}: two calls differ")
    del got
    record("gemm_sub", err, ratio, cuda_ms(lambda: pk.gemm_sub(C, A, B)),
           cuda_ms(lambda: pk.gemm_sub_plain(C, A, B)),
           2.0 * M * N * K, (M * K + N * K + 2.0 * M * N) * esz,
           cuda_ms(lambda: torch.addmm(C, A, B.T, alpha=-1)),
           "slate_tpu/ops/pallas/panel_kernels.py:403")
    del C, A, B, ref
    # the other shape classes of a posv's gemm_sub launches: recorded, no bar
    for M, K in ((2048, 8192), (512, 8192), (256, 8192)):
        C, A, B = rnd(M, M), rnd(M, K), rnd(M, K)
        plan = pk._gemm_plan(C, M, M, K, False)
        ms, lib = cuda_ms(lambda: pk.gemm_sub(C, A, B)), cuda_ms(
            lambda: torch.addmm(C, A, B.T, alpha=-1))
        out.setdefault("gemm_sub_classes", {})[f"({M}, {M}, {K})"] = {
            "ms": ms, "library_ms": lib, "plan": list(plan)}
        print(f"  gemm_sub {dtype} ({M}, {M}, {K}): plan {tuple(plan)} kernel {ms:.3f} ms "
              f"({2.0 * M * M * K / ms / 1e9:.1f} TFLOP/s)  addmm {lib:.3f} ms", flush=True)
    del C, A, B
    gemm_seams(pk, dtype, gen, dev)

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
        pk.reset_launches()
        got = kern(T)
        check(pk.LAUNCHES[name] == pk.trsm_kernel_launches(n, nrhs),
              f"{name}/{case} {dtype}: {pk.LAUNCHES[name]} launches, expected "
              f"{pk.trsm_kernel_launches(n, nrhs)}")
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
        lib = lambda T=T, Top=Top, case=case: torch.linalg.solve_triangular(  # noqa: E731
            Top, Bm, upper=name == "trsm_upper", unitriangular=case == "unit")
        ms, lib_ms = cuda_ms(lambda: kern(T)), cuda_ms(lib)
        print(f"  {name}/{case} {dtype}: err {err:.3e} (max err/tol {ratio:.3e}), "
              f"update moves X by {moved:.3e}, packed storage ok; kernel {ms:.3f} ms  "
              f"library {lib_ms:.3f} ms", flush=True)
        out.setdefault("trsm_modes", {})[f"{name}/{case}"] = {"ms": ms, "library_ms": lib_ms}
        if case in ("nonunit", "transposed"):
            record(name, err, ratio, ms, cuda_ms(lambda: plain(T)), flops, nbytes, lib_ms,
                   "slate_tpu/ops/pallas/panel_kernels.py:"
                   + ("507" if name == "trsm_lower" else "516"))
            # one right-hand side: recorded, no bar
            b1 = Bm[:, :1].contiguous()
            k1 = (lambda T=T: pk.trsm_lower(T, b1)) if name == "trsm_lower" else \
                (lambda T=T: pk.trsm_upper(T, b1, transposed=True))
            ms1 = cuda_ms(k1)
            lib1 = cuda_ms(lambda: torch.linalg.solve_triangular(Top, b1, upper=name == "trsm_upper"))
            out["trsm_modes"][f"{name}/{case}/nrhs=1"] = {"ms": ms1, "library_ms": lib1}
            print(f"  {name}/{case} {dtype} nrhs=1: kernel {ms1:.3f} ms  library {lib1:.3f} ms",
                  flush=True)

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
    trsm_seams(pk, dtype, gen, dev)
    return out


def trsm_seams(pk, dtype, gen, dev) -> None:
    """The trsm pair at shapes that cross the kernel's seams (n = kb - 1,
    kb, kb + 1 and n not a multiple of kb, kb = 128 rows a block step;
    nrhs = 1, 3 and one column tile + 1), on row-strided views of T and
    B, in its six modes: lower, unit lower, upper, transposed, and the
    two packed-LU modes.  Each
    solve holds elementwise against the plain version, is bitwise equal
    with NaN (lower/upper/transposed) or the other LU factor (LU modes)
    in the unread triangle, and launches trsm_kernel_launches kernels."""
    dt = getattr(torch, dtype)
    kb, tile = pk.TRSM_KB, pk.TRSM_BN  # the block step and the column tile
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731
    worst = 0.0
    for n, nrhs in ((kb - 1, 3), (kb, 1), (kb + 1, tile + 1), (1000, 1), (1000, 3),
                    (1000, tile + 1)):
        eye = torch.eye(n, device=dev, dtype=dt)
        low = torch.tril(rnd(n, n), -1) / n**0.5
        junk_u = torch.triu(rnd(n, n))  # what the lower modes must not read
        junk_l = torch.tril(rnd(n, n), -1)
        nan_ud = torch.triu(torch.full((n, n), float("nan"), device=dev, dtype=dt))
        nan_u = torch.triu(nan_ud, 1)  # NaN strictly above the diagonal, 0 elsewhere
        nan_l = nan_u.T
        # (name, kernel, plain, op(T) clean, T as stored with the other
        # triangle poisoned)
        modes = [
            ("trsm_lower", lambda T, B: pk.trsm_lower(T, B),
             lambda T, B: pk.trsm_plain(T, B, True), low + 2 * eye, low + 2 * eye + nan_u),
            ("trsm_lower", lambda T, B: pk.trsm_lower(T, B, unit=True),
             lambda T, B: pk.trsm_plain(T, B, True, unit=True), low + eye, low + nan_ud),
            ("trsm_upper", lambda T, B: pk.trsm_upper(T, B),
             lambda T, B: pk.trsm_plain(T, B, False), low.T + 2 * eye, low.T + 2 * eye + nan_l),
            ("trsm_upper", lambda T, B: pk.trsm_upper(T, B, transposed=True),
             lambda T, B: pk.trsm_plain(T, B, False, transposed=True), low.T + 2 * eye,
             low + 2 * eye + nan_u),
            ("trsm_upper", lambda T, B: pk.trsm_upper(T, B),
             lambda T, B: pk.trsm_plain(T, B, False), low.T + 2 * eye, low.T + 2 * eye + junk_l),
            ("trsm_lower", lambda T, B: pk.trsm_lower(T, B, unit=True),
             lambda T, B: pk.trsm_plain(T, B, True, unit=True), low + eye, low + junk_u),
        ]
        for mode, (name, kern, plain, Top, Tst) in enumerate(modes):
            # row-strided views: T inside an (n, n + 5) buffer, B inside (n, nrhs + 3)
            Tbuf = torch.zeros(n, n + 5, device=dev, dtype=dt)
            Tbuf[:, 2:2 + n] = Tst
            Bbuf = rnd(n, nrhs + 3)
            Tv, Bv = Tbuf[:, 2:2 + n], Bbuf[:, 1:1 + nrhs]
            pk.reset_launches()
            got = kern(Tv, Bv)
            torch.cuda.synchronize()
            check(pk.LAUNCHES[name] == pk.trsm_kernel_launches(n, nrhs),
                  f"trsm seams {dtype} mode {mode} n={n}: launches {pk.LAUNCHES[name]}")
            clean_stored = Top.T.contiguous() if mode == 3 else Top.contiguous()
            clean = kern(clean_stored, Bv.contiguous())
            check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
                  f"trsm seams {dtype} mode {mode} n={n} nrhs={nrhs}: the unread triangle entered")
            ref = plain(clean_stored, Bv)
            err, ratio = elementwise_err(got, ref, Top.abs() @ ref.abs() + Bv.abs(), n)
            check(ratio <= 1, f"trsm seams {dtype} mode {mode} n={n} nrhs={nrhs}: "
                              f"max err/tol {ratio:.3e} > 1")
            worst = max(worst, ratio)
    print(f"  trsm seams {dtype}: six modes x n in ({kb - 1}, {kb}, {kb + 1}, 1000) x nrhs in "
          f"(1, 3, {tile + 1}) on strided views: bitwise equal with the unread triangle poisoned, "
          f"launches as planned, worst err/tol {worst:.3e}", flush=True)


def gemm_seams(pk, dtype, gen, dev) -> None:
    """gemm_sub and syrk_diag across the seams of their tiles and K ring,
    on views with 16-byte aligned rows and with rows one value off: M
    or N at tile - 1, tile and tile + 1 of both tile variants (the 128
    tile where a row of tiles fills the card, from the kernel's report),
    K not a multiple of the K slice and under one slice, the K split at a
    256 x 256 output with K = 8192, syrk_diag at t = 256 with K split.
    Each holds elementwise against the plain version (10 sqrt(k) eps of
    its summands), two calls are bitwise equal, and syrk_diag leaves the
    strict upper triangle bitwise untouched."""
    dt = getattr(torch, dtype)
    pk._load()
    big, small = pk._GEMM_TILES[dt]
    fill = -(-9 * big.per_sm * pk._sms(dev) // 10) * big.bm - 3  # one row of tiles fills
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731

    def view(rows, cols, aligned):
        ld = -(-cols // 4) * 4 + (0 if aligned else 4)
        off = 0 if aligned else 1
        return rnd(rows, ld)[:, off:off + cols]

    cases = [(e, fill, 40, 0, False) for e in (big.bm - 1, big.bm, big.bm + 1)]
    cases += [(fill, e, 37, 0, False) for e in (big.bm - 1, big.bm, big.bm + 1)]
    cases += [(e, e, 300, 1, None) for e in (small.bm - 1, small.bm, small.bm + 1)]
    cases += [(200, 190, 1003, 1, None), (70, 50, 3, 1, False), (256, 256, 8192, None, True)]
    worst = 0.0
    for aligned in (True, False):
        for M, N, K, variant, split in cases:
            C, A, B = view(M, N, aligned), view(M, K, aligned), view(N, K, aligned)
            plan = pk._gemm_plan(C, M, N, K, False)
            check(variant is None or plan.variant == variant,
                  f"gemm_sub seams {dtype} ({M}, {N}, {K}): tile variant {plan.variant}")
            check(split is None or (plan.ksplit > 1) == split,
                  f"gemm_sub seams {dtype} ({M}, {N}, {K}): K split {plan.ksplit}")
            got = pk.gemm_sub(C, A, B)
            check(torch.equal(pk.gemm_sub(C, A, B), got),
                  f"gemm_sub seams {dtype} ({M}, {N}, {K}): two calls differ")
            ref = pk.gemm_sub_plain(C, A, B)
            _, ratio = elementwise_err(got, ref, A.abs() @ B.abs().T + C.abs(), max(K, 1))
            check(ratio <= 1, f"gemm_sub seams {dtype} ({M}, {N}, {K}) aligned={aligned}: "
                              f"max err/tol {ratio:.3e} > 1")
            worst = max(worst, ratio)
        for t, K in ((256, 4096), (256, 8192), (small.bm + 1, 37), (big.bm + 1, 1)):
            C, A = view(t, t, aligned), view(t, K, aligned)
            got = pk.syrk_diag(C, A)
            check(torch.equal(pk.syrk_diag(C, A), got),
                  f"syrk_diag seams {dtype} t={t} K={K}: two calls differ")
            check(torch.equal(torch.triu(got, 1), torch.triu(C, 1)),
                  f"syrk_diag seams {dtype} t={t} K={K}: the upper triangle changed")
            check(K < 4096 or pk._gemm_plan(C, t, t, K, True).ksplit > 1,
                  f"syrk_diag seams {dtype} t={t} K={K}: K not split")
            ref = pk.syrk_diag_plain(C, A)
            _, ratio = elementwise_err(got, ref, A.abs() @ A.abs().T + C.abs(), K)
            check(ratio <= 1, f"syrk_diag seams {dtype} t={t} K={K} aligned={aligned}: "
                              f"max err/tol {ratio:.3e} > 1")
            worst = max(worst, ratio)
    print(f"  gemm_sub / syrk_diag seams {dtype}: tiles {big.bm} ({big.per_sm} an SM) and "
          f"{small.bm} ({small.per_sm}), K slice {big.bk}; {len(cases)} gemm_sub and 4 "
          f"syrk_diag shapes, aligned and unaligned rows: bitwise repeatable, upper triangle "
          f"untouched, worst err/tol {worst:.3e}", flush=True)


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
    # to the lattice height 12288 (act < M), and the same rows 200 wide
    # (a last strip of 8 columns); each held bit for bit
    for M, nb, act in ((N_MAIN, 256, None), (lk._lat_height(10000), 256, 10000),
                       (lk._lat_height(10000), 200, 10000)):
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
        check(torch.equal(got, ref), f"panel_lu {dtype} {M}x{nb}: LU not bitwise equal")
        plan = pk._panel_lu_plan(P)
        print(f"  panel_lu {dtype} ({M}, {nb}, act={act}), grid {plan.grid}, S {plan.strip}: "
              f"perm and LU bitwise equal, err {err:.3e} (max err/tol {ratio:.3e})", flush=True)
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
    check(ck.resolve_schedule(n, dt, "auto", dev) == "pallas",
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
    sweep = pk.trsm_kernel_launches(n, nrhs)
    check(launches["trsm_lower"] == sweep and launches["trsm_upper"] == sweep,
          f"potrs_from_global {dtype}: trsm launches {launches['trsm_lower']}, "
          f"{launches['trsm_upper']} != {sweep} each")
    t_solve = cuda_ms(lambda: stt.potrs_from_global(Lg, B, "auto"), reps=3)
    t_solve_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
        Lg.mT, torch.linalg.solve_triangular(Lg, B, upper=False), upper=True), reps=3)
    print(f"  potrs_from_global {dtype}: {t_solve:.3f} ms, two library solves "
          f"{t_solve_lib:.3f} ms", flush=True)
    del X, L, Lg, Y, Am, Bm
    t_lib = cuda_ms(lambda: torch.linalg.cholesky(A), reps=3)
    print(f"  torch.linalg.cholesky {dtype} n={n}: {t_lib:.3f} ms "
          f"(yardstick, {n**3 / 3.0 / t_lib / 1e6:.1f} GFLOP/s)", flush=True)
    return {"launches": launches, "residual": r_posv, "solve_residual": r_solve,
            "potrf_s": t_fact, "potrf_gflops": gflops, "cholesky_lib_ms": t_lib,
            "potrs_from_global_ms": t_solve, "two_library_solves_ms": t_solve_lib}


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
    sweep = pk.trsm_kernel_launches(n, nrhs)
    check(solve_counts["trsm_lower"] == sweep and solve_counts["trsm_upper"] == sweep,
          f"getrs_from_global {dtype}: trsm launches {solve_counts['trsm_lower']}, "
          f"{solve_counts['trsm_upper']} != {sweep} each")
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


# ---------------------------------------------------------------------------
# the QR and norm slices: kernels, main path, small cases, norms
# ---------------------------------------------------------------------------

M_QR, N_QR = 32768, 16384
NB_SWITCH = 256


def _nonzero(scale):
    """scale with its zeros made the smallest normal number, so that an
    exact zero is held exactly by ``elementwise_err``."""
    return torch.where(scale == 0, torch.finfo(scale.dtype).tiny, scale)


def masked_tile_norms(pk, S, dtype, gen, dev, kinds) -> None:
    """tile_norms with the norm drivers' arguments on the (N, t, t)
    stack S: ragged counts (tile 0 whole) with NaN in the padding beyond
    them, every kind and max_sumsq against the plain version (maxima
    bitwise, sums within TOL_C sqrt(k) eps of their magnitudes, all
    finite, two calls bitwise equal), then fro_sumsq with a scale and
    with skip false / true.  Adds the counted kinds' times to kinds."""
    N, t, _ = S.shape
    side = int(round(N**0.5))
    rows = torch.randint(0, t + 1, (side,), generator=gen, device=dev, dtype=torch.int32)
    cols = torch.randint(0, t + 1, (side,), generator=gen, device=dev, dtype=torch.int32)
    rows[0], cols[0] = t, t
    rm = torch.arange(t, device=dev) < rows[:, None]
    cm = torch.arange(t, device=dev) < cols[:, None]
    mask = (rm[:, None, :, None] & cm[None, :, None, :]).reshape(N, t, t)
    Sn = S.masked_fill(~mask, float("nan"))
    del mask
    for kind, k in (("max", 1), ("fro_sumsq", t * t), ("one", t), ("inf", t),
                    ("max_sumsq", t * t)):
        got, ref = pk.tile_norms(Sn, kind, rows, cols), pk.tile_norms_plain(Sn, kind, rows, cols)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"tile_norms {kind} {dtype} counted: the "
              "padding's NaN reached an output")
        check(torch.equal(pk.tile_norms(Sn, kind, rows, cols), got),
              f"tile_norms {kind} {dtype} counted: two calls differ")
        if kind in ("max", "max_sumsq"):
            check(torch.equal(got.reshape(N, -1)[:, 0], ref.reshape(N, -1)[:, 0]),
                  f"tile_norms {kind} {dtype} counted: the maxima are not bitwise equal")
        if kind != "max":  # the sums of empty rows, columns and tiles are exactly 0
            err, ratio = elementwise_err(got, ref, _nonzero(ref), k)
            check(ratio <= 1, f"tile_norms {kind} {dtype} counted: max err/tol {ratio:.3e} > 1")
        ms = cuda_ms(lambda: pk.tile_norms(Sn, kind, rows, cols))
        kinds.setdefault(kind, {})["counted_ms"] = ms
        print(f"  tile_norms {kind:9s} {dtype} counted, NaN in the padding: finite, two calls "
              f"bitwise equal, matches the plain version; kernel {ms:.3f} ms", flush=True)
    scale = pk.tile_norms_plain(Sn, "max", rows, cols).amax() * 1.5
    got = pk.tile_norms(Sn, "fro_sumsq", rows, cols, scale=scale)
    ref = pk.tile_norms_plain(Sn, "fro_sumsq", rows, cols, scale=scale)
    err, ratio = elementwise_err(got, ref, _nonzero(ref), t * t)
    check(ratio <= 1, f"tile_norms fro_sumsq {dtype} scaled: max err/tol {ratio:.3e} > 1")
    no, yes = torch.tensor(False, device=dev), torch.tensor(True, device=dev)
    check(torch.equal(pk.tile_norms(Sn, "fro_sumsq", rows, cols, scale=scale, skip=no), got),
          f"tile_norms fro_sumsq {dtype}: skip false changes the scaled sums")
    skipped = pk.tile_norms(Sn, "fro_sumsq", rows, cols, scale=scale, skip=yes)
    check(not bool(skipped.any()), f"tile_norms fro_sumsq {dtype}: skip true is not all zeros")
    ms = cuda_ms(lambda: pk.tile_norms(Sn, "fro_sumsq", rows, cols, scale=scale))
    ms_skip = cuda_ms(lambda: pk.tile_norms(Sn, "fro_sumsq", rows, cols, scale=scale, skip=yes))
    kinds["fro_sumsq"]["scaled_counted_ms"], kinds["fro_sumsq"]["skipped_ms"] = ms, ms_skip
    print(f"  tile_norms fro_sumsq {dtype} counted, scaled: err {err:.3e} (max err/tol "
          f"{ratio:.3e}) kernel {ms:.3f} ms; skip false bitwise equal, skip true zeros in "
          f"{ms_skip:.4f} ms", flush=True)
    del Sn


def qr_kernel_phase(pk, dtype, gen, dev) -> dict:
    """larft on factored (32768, 256) and (24576, 256) panels (the two
    heights of the gels main path), one with a zero column and a short
    taus, and a view at column offset 5; tile_norms, tile_geadd and
    tile_transpose on the (1024, 512, 512) tile stack of a 16384^2
    matrix."""
    from slate_tpu_torch.ops.householder import materialize_v

    dt = getattr(torch, dtype)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731
    esz = torch.finfo(dt).bits // 8
    out = {}
    record = _recorder(out, dtype)

    # larft: V and tau of real factored panels (the leftmost leaf of the
    # main path's recursion, and a panel at its other height), then the
    # same V with one column exactly zero below its diagonal (tau = 0) and
    # a short taus vector (6 absent), and V as a view at column offset 5
    # (rows not 16-byte aligned: the one-value copies)
    M, w = M_QR, NB_SWITCH

    def factored(m):
        fac, tau = torch.geqrf(rnd(m, w))
        return materialize_v(fac.contiguous()), tau

    V, taus = factored(M)
    V2, taus2 = factored(24576)
    V0, t0 = V.clone(), taus.clone()
    V0[101:, 100] = 0
    t0[100] = 0
    t0 = t0[: w - 6]
    absent = torch.cat([(t0 == 0).nonzero().flatten(),
                        torch.arange(w - 6, w, device=dev)])
    wide = torch.zeros(M, w + 5, device=dev, dtype=dt)
    wide[:, 5:] = V
    tiles = pk._LARFT_TILES[dt]
    for Vp in (V, V2):
        plan = pk.larft_plan(Vp.shape[0], w, tiles, pk._sms(dev))
        bm = tiles[plan.variant].bm
        print(f"  larft {dtype} ({Vp.shape[0]}, {w}): plan {tuple(plan)}, tile {bm}, "
              f"{plan.diag_chunks} chunks a diagonal tile, {plan.off_chunks} above, "
              f"{pk.larft_blocks(plan, w, bm)} blocks", flush=True)
    for case, Vc, tc in (("panel", V, taus), ("zero column, short taus", V0, t0),
                         ("panel at height 24576", V2, taus2),
                         ("view at column offset 5", wide[:, 5:], taus)):
        got, ref = pk.larft_tinv(Vc, tc), pk.larft_tinv_plain(Vc, tc)
        torch.cuda.synchronize()
        check(torch.equal(got.diagonal(), ref.diagonal()),
              f"larft {dtype} {case}: the diagonal differs from the plain version's")
        check(not bool(torch.tril(got, -1).any()),
              f"larft {dtype} {case}: the lower triangle is not zero")
        check(torch.equal(pk.larft_tinv(Vc, tc), got), f"larft {dtype} {case}: two calls differ")
        scale = Vc.abs().T @ Vc.abs()
        scale = torch.where(scale == 0, torch.finfo(dt).tiny, scale)
        err, ratio = elementwise_err(got, ref, scale, Vc.shape[0])
        T = pk.larft(Vc, tc)
        check(bool(torch.isfinite(T).all()), f"larft {dtype} {case}: T is not finite")
        if case.startswith("zero column"):
            check(not bool(T[absent].any()) and not bool(T[:, absent].any()),
                  f"larft {dtype}: T is not zero in the rows and columns of tau = 0")
        print(f"  larft {dtype} {tuple(Vc.shape)} {case}: diagonal bitwise, lower zero, "
              f"two calls bitwise equal, strict upper err {err:.3e} (max err/tol "
              f"{ratio:.3e}), T finite", flush=True)
        check(ratio <= 1, f"larft {dtype} {case}: max err/tol {ratio:.3e} > 1")
        if case == "panel":
            record("larft", err, ratio, cuda_ms(lambda: pk.larft_tinv(V, taus)),
                   cuda_ms(lambda: pk.larft_tinv_plain(V, taus)),
                   float(M) * w * (w - 1), (M * w + w + w * w) * esz,
                   cuda_ms(lambda: V.mT @ V), "slate_tpu/ops/pallas/panel_kernels.py:312")
    # the main path's other height: recorded, no bar
    ms2, lib2 = cuda_ms(lambda: pk.larft_tinv(V2, taus2)), cuda_ms(lambda: V2.mT @ V2)
    out["larft"]["height_24576"] = {"ms": ms2, "library_ms": lib2}
    print(f"  larft {dtype} (24576, {w}): kernel {ms2:.3f} ms  V.mT @ V {lib2:.3f} ms",
          flush=True)
    del V, V0, V2, wide, taus, taus2, t0, got, ref, scale, T

    # the tile stack of a 16384^2 matrix in tiles of 512
    n, t = N_MAIN, 512
    S = rnd(n, n).reshape(n // t, t, n // t, t).transpose(1, 2).reshape(-1, t, t).contiguous()
    N = S.shape[0]
    kinds = {}
    for kind, k, lib in (
        ("max", 1, lambda: torch.linalg.vector_norm(S, float("inf"), dim=(1, 2))),
        ("fro_sumsq", t * t, lambda: torch.linalg.vector_norm(S, 2, dim=(1, 2))),
        ("one", t, lambda: torch.linalg.vector_norm(S, 1, dim=1)),
        ("inf", t, lambda: torch.linalg.vector_norm(S, 1, dim=2)),
    ):
        got, ref = pk.tile_norms(S, kind), pk.tile_norms_plain(S, kind)
        torch.cuda.synchronize()
        if kind == "max":
            check(torch.equal(got, ref), f"tile_norms max {dtype}: not bitwise equal")
            err, ratio = 0.0, 0.0
        else:  # nonnegative summands: the sum of magnitudes is the result
            err, ratio = elementwise_err(got, ref, ref, k)
        check(ratio <= 1, f"tile_norms {kind} {dtype}: max err/tol {ratio:.3e} > 1")
        ms, plain_ms, lib_ms = cuda_ms(lambda: pk.tile_norms(S, kind)), \
            cuda_ms(lambda: pk.tile_norms_plain(S, kind)), cuda_ms(lib)
        out_elems = got.numel()
        b_ms, b_by = bound(float(S.numel()) * (2 if kind == "fro_sumsq" else 1),
                           (S.numel() + out_elems) * esz)
        res = (ctypes.c_int * 2)()  # the launch's blocks an SM, from the library's export
        check(pk._entry("tile_norms_residency", dt)(N, pk._NORM_KINDS[kind], res) == 0,
              f"tile_norms {kind} {dtype}: residency query failed")
        kmax, k = res
        kinds[kind] = {"max_abs_err": err, "err_over_tol": ratio, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                       "blocks_an_sm": [k, kmax]}
        print(f"  tile_norms {kind:9s} {dtype} ({N}, {t}, {t}): err {err:.3e} (max err/tol "
              f"{ratio:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  library "
              f"{lib_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by}), {k} of {kmax} blocks an SM",
              flush=True)
    # one NaN: that tile's statistics are NaN in every kind, the others not
    bad = N // 2
    keep = S[bad, 3, 5].clone()
    S[bad, 3, 5] = float("nan")
    for kind in kinds:
        o = pk.tile_norms(S, kind).reshape(N, -1)
        check(bool(torch.isnan(o[bad]).any()) and bool(torch.isfinite(o[:bad]).all())
              and bool(torch.isfinite(o[bad + 1:]).all()),
              f"tile_norms {kind} {dtype}: NaN does not stay in its tile")
    S[bad, 3, 5] = keep
    print(f"  tile_norms {dtype}: a NaN stays in its tile in every kind", flush=True)
    # max_sumsq, the first launch of Fro: both statistics in one read
    got = pk.tile_norms(S, "max_sumsq")
    check(torch.equal(got[:, 0], pk.tile_norms(S, "max")), f"tile_norms max_sumsq {dtype}: max")
    ref = pk.tile_norms_plain(S, "fro_sumsq")
    err, ratio = elementwise_err(got[:, 1], ref, ref, t * t)
    check(ratio <= 1, f"tile_norms max_sumsq {dtype}: max err/tol {ratio:.3e} > 1")
    ms, lib_ms = cuda_ms(lambda: pk.tile_norms(S, "max_sumsq")), None
    b_ms, b_by = bound(2.0 * S.numel(), (S.numel() + 2 * N) * esz)
    kinds["max_sumsq"] = {"max_abs_err": err, "err_over_tol": ratio, "ms": ms,
                          "plain_ms": cuda_ms(lambda: pk.tile_norms_plain(S, "max_sumsq")),
                          "library_ms": lib_ms, "bound_ms": b_ms}
    print(f"  tile_norms max_sumsq {dtype} ({N}, {t}, {t}): max bitwise, sums err {err:.3e} "
          f"(max err/tol {ratio:.3e})  kernel {ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    masked_tile_norms(pk, S, dtype, gen, dev, kinds)
    # the entry of the kernels line: 'one', the statistic of Norm.One
    k1 = kinds["one"]
    record("tile_norms", k1["max_abs_err"], k1["err_over_tol"], k1["ms"], k1["plain_ms"],
           float(S.numel()), (S.numel() + N * t) * esz, k1["library_ms"],
           "slate_tpu/ops/pallas/kernels.py:83")
    out["tile_norms"]["kinds"] = kinds

    S2 = rnd(N, t, t)
    got = pk.tile_geadd(0.75, S, -1.25, S2)
    check(torch.equal(got, pk.tile_geadd_plain(0.75, S, -1.25, S2)),
          f"tile_geadd {dtype}: not bitwise equal")
    del got
    record("tile_geadd", 0.0, 0.0, cuda_ms(lambda: pk.tile_geadd(0.75, S, -1.25, S2)),
           cuda_ms(lambda: pk.tile_geadd_plain(0.75, S, -1.25, S2)),
           3.0 * S.numel(), 3.0 * S.numel() * esz, None, "slate_tpu/ops/pallas/kernels.py:258")
    del S2
    got = pk.tile_transpose(S)
    check(torch.equal(got, pk.tile_transpose_plain(S)), f"tile_transpose {dtype}: not bitwise")
    del got
    record("tile_transpose", 0.0, 0.0, cuda_ms(lambda: pk.tile_transpose(S)),
           cuda_ms(lambda: pk.tile_transpose_plain(S)), 0.0, 2.0 * S.numel() * esz,
           cuda_ms(lambda: S.transpose(1, 2).contiguous()),
           "slate_tpu/ops/pallas/kernels.py:155")
    print(f"  tile_geadd and tile_transpose {dtype}: bitwise equal to their plain versions",
          flush=True)
    del S
    return out


def ls_residual(A, X, B) -> float:
    """||A^T (A X - B)||_1 / (||A||_1 (||A||_1 ||X||_1 + ||B||_1) m eps):
    the normal-equations residual of a least-squares solution, computed
    in float64."""
    A64, X64, B64 = A.double(), X.double(), B.double()
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    na = n1(A64)
    r = n1(A64.T @ (A64 @ X64 - B64)) / (na * (na * n1(X64) + n1(B64)) * A.shape[0])
    return r / torch.finfo(A.dtype).eps


def serve_pack(fac, T, m: int, nb: int) -> torch.Tensor:
    """The serve tier's gels pack: V/R in rows [0, m), panel k's T in rows
    [m + k nb, m + k nb + w), columns [0, w)."""
    G = fac.to_global()
    n = G.shape[1]
    kt = T.T.shape[0]
    F = torch.zeros((m + kt * nb, n), dtype=G.dtype, device=G.device)
    F[:m] = G
    for k in range(kt):
        w = min(nb, n - k * nb)
        F[m + k * nb:m + k * nb + w, :w] = T.T[k][:w, :w]
    return F


def qr_main_path(stt, pk, qf, metrics, dtype, gen, dev) -> dict:
    """gels at (32768, 16384), nrhs = 512, default options; then
    gels_solve_from_global on the serve pack of the factor."""
    dt = getattr(torch, dtype)
    m, n, nrhs, nb = M_QR, N_QR, NRHS_MAIN, 512
    check(qf.resolve_qr_schedule(m, n, dt, "auto", dev) == "pallas",
          "Schedule.Auto does not resolve to the larft kernel's family for geqrf")
    A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(m, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.Matrix.from_global(A, nb), stt.Matrix.from_global(B, nb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    metrics.reset()
    pk.reset_launches()  # counts of the main path only
    X = stt.gels(Am, Bm)
    torch.cuda.synchronize()
    counts = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t_gels = metrics.timers()["gels"]["total_s"]
    t_geqrf = metrics.timers()["geqrf"]["total_s"]
    model = 2.0 * n * n * (m - n / 3.0)
    r = ls_residual(A, X.to_global(), B)
    expect = qf.geqrf_kernel_launches(n, NB_SWITCH)
    print(f"  gels {dtype} ({m}, {n}) nrhs={nrhs}: residual {r:.3e}, gels {t_gels:.3f} s, "
          f"geqrf {t_geqrf:.3f} s = {model / t_geqrf / 1e9:.1f} GFLOP/s (model "
          f"2n^2(m - n/3)), larft launches {counts['larft']} (expected {expect}), peak "
          f"{peak:.2f} GiB allocated", flush=True)
    check(r <= 3, f"gels {dtype}: residual {r:.3f} > 3")
    check(counts["larft"] == expect, f"gels {dtype}: larft launches {counts['larft']} != {expect}")
    del X, Bm

    fac, T = stt.geqrf(Am)
    del Am
    F = serve_pack(fac, T, m, nb)
    del fac, T
    pk.reset_launches()
    Y = stt.gels_solve_from_global(F, B, m, nb)
    torch.cuda.synchronize()
    r_solve = ls_residual(A, Y, B)
    del Y
    t_solve = cuda_ms(lambda: stt.gels_solve_from_global(F, B, m, nb), reps=3)
    del F
    fq, tau = torch.geqrf(A)
    lib_solve = lambda: torch.linalg.solve_triangular(  # noqa: E731
        fq[:n, :n], torch.ormqr(fq, tau, B, left=True, transpose=True)[:n], upper=True)
    t_solve_lib = cuda_ms(lib_solve, reps=3)
    del fq, tau
    t_lib_geqrf = cuda_ms(lambda: torch.geqrf(A), reps=1)
    t_lstsq = cuda_ms(lambda: torch.linalg.lstsq(A, B), reps=1)
    print(f"  gels_solve_from_global {dtype}: residual {r_solve:.3e}, {t_solve:.3f} ms; "
          f"torch.ormqr + solve_triangular {t_solve_lib:.3f} ms", flush=True)
    print(f"  yardsticks {dtype}: torch.geqrf {t_lib_geqrf:.3f} ms "
          f"({model / t_lib_geqrf / 1e6:.1f} GFLOP/s), torch.linalg.lstsq {t_lstsq:.3f} ms",
          flush=True)
    check(r_solve <= 3, f"gels_solve_from_global {dtype}: residual {r_solve:.3f} > 3")
    return {"launches": counts, "residual": r, "solve_residual": r_solve, "gels_s": t_gels,
            "geqrf_s": t_geqrf, "geqrf_gflops": model / t_geqrf / 1e9, "peak_gib": peak,
            "gels_solve_from_global_ms": t_solve, "ormqr_solve_lib_ms": t_solve_lib,
            "torch_geqrf_ms": t_lib_geqrf, "torch_lstsq_ms": t_lstsq}


def small_qr(stt, pk, qf, ck, gen, dev) -> None:
    """geqrf + ungqr at n = 4096; CholQR gels at (32768, 16384); the
    underdetermined gels at (2000, 6000) with Schedule.Pallas; float64."""
    dt = torch.float64
    eps = torch.finfo(dt).eps
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    n = 4096
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    pk.reset_launches()
    fac, T = stt.geqrf(stt.Matrix.from_global(A, 512))
    torch.cuda.synchronize()
    launches = pk.LAUNCHES["larft"]
    Q = stt.ungqr(fac, T).to_global()
    R = torch.triu(fac.to_global())
    fres = n1(A - Q @ R) / (n1(A) * n) / eps
    orth = n1(Q.T @ Q - torch.eye(n, device=dev, dtype=dt)) / n / eps
    print(f"  geqrf + ungqr float64 n={n}: factor residual {fres:.3e} eps, orthogonality "
          f"{orth:.3e} eps, larft launches {launches}", flush=True)
    check(fres <= 3 and orth <= 3, f"geqrf n={n}: residuals {fres:.3f}, {orth:.3f} > 3")
    check(launches == qf.geqrf_kernel_launches(n, NB_SWITCH), f"geqrf n={n}: larft launches")
    del A, fac, T, Q, R

    m, n, nrhs = M_QR, N_QR, NRHS_MAIN
    A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(m, nrhs, generator=gen, device=dev, dtype=dt)
    pk.reset_launches()
    t0 = time.perf_counter()
    X = stt.gels(stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512),
                 {stt.Option.MethodGels: stt.MethodGels.CholQR})
    torch.cuda.synchronize()
    t_cholqr = time.perf_counter() - t0
    got = {k: pk.LAUNCHES[k] for k in ("chol_base", "syrk_diag", "gemm_sub", "larft")}
    expect = {**ck.chol_kernel_launches(n), "larft": 0}
    r = ls_residual(A, X.to_global(), B)
    print(f"  gels CholQR float64 ({m}, {n}): residual {r:.3e} (bound 30), {t_cholqr:.3f} s, "
          f"launches {got} (expected {expect})", flush=True)
    check(r <= 30, f"gels CholQR: residual {r:.3f} > 30")
    check(got == expect, f"gels CholQR: launches {got} != {expect}")
    del A, B, X

    m, n = 2000, 6000
    A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(m, 7, generator=gen, device=dev, dtype=dt)
    pk.reset_launches()
    X = stt.gels(stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512),
                 {stt.Option.Schedule: "pallas"}).to_global()
    torch.cuda.synchronize()
    launches = pk.LAUNCHES["larft"]
    r = n1(A @ X - B) / (n1(A) * n1(X) * n) / eps
    ref = A.T @ torch.linalg.solve(A @ A.T, B)
    diff = float((X - ref).abs().max())
    expect = qf.geqrf_kernel_launches(2048, NB_SWITCH)  # A^H padded to (6144, 2048)
    print(f"  gels underdetermined float64 ({m}, {n}) schedule=pallas: residual {r:.3e}, "
          f"max |X - A^T (A A^T)^-1 B| {diff:.3e}, larft launches {launches} "
          f"(expected {expect})", flush=True)
    check(r <= 3 and diff <= 1e-8, f"underdetermined gels: residual {r:.3f}, diff {diff:.3e}")
    check(launches == expect, f"underdetermined gels: larft launches {launches} != {expect}")


def norm_phase(stt, pk, dtype, gen, dev) -> dict:
    """norm One/Inf/Max/Fro and colNorms of a 16384^2 Matrix in tiles of
    512 (tile_norms launches: 1 each, 2 for Fro); Fro of the matrix scaled
    so that its unscaled sum of squares would overflow or underflow
    (1e300 / 1e-160 in float64, 1e30 / 1e-20 in float32: the scaled
    pass, 2 launches); ``add`` and the norm of the transposed view (no
    tile_geadd or tile_transpose launch, as in the JAX package);
    Hermitian and triangular norms on the plain route."""
    dt = getattr(torch, dtype)
    n = N_MAIN
    eps = torch.finfo(dt).eps
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    Am = stt.Matrix.from_global(A, 512)
    tol = TOL_C * n**0.5 * eps
    A64 = A.double()  # the sums' references in float64: the library's own rounding aside
    ords = {"One": 1, "Inf": float("inf"), "Fro": "fro"}
    refs = {"One": lambda: torch.linalg.matrix_norm(A, 1),
            "Inf": lambda: torch.linalg.matrix_norm(A, float("inf")),
            "Max": lambda: A.abs().amax(),
            "Fro": lambda: torch.linalg.matrix_norm(A, "fro")}
    out = {}
    counted = dict.fromkeys(("tile_norms", "tile_geadd", "tile_transpose"), 0)
    for name, lib in refs.items():
        pk.reset_launches()
        got = stt.norm(stt.Norm[name], Am)
        torch.cuda.synchronize()
        launches = pk.LAUNCHES["tile_norms"]
        counted = {k: v + pk.LAUNCHES[k] for k, v in counted.items()}
        if name == "Max":
            check(torch.equal(got, lib()), f"norm Max {dtype}: not bitwise equal to amax")
            rel = 0.0
        else:
            ref = torch.linalg.matrix_norm(A64, ords[name])
            rel = float((got.double() - ref).abs() / ref)
        ms, lib_ms = cuda_ms(lambda: stt.norm(stt.Norm[name], Am), reps=3), cuda_ms(lib, reps=3)
        out[name] = {"rel_err": rel, "launches": launches, "ms": ms, "library_ms": lib_ms}
        print(f"  norm {name} {dtype}: rel err {rel:.3e} (tol {tol:.3e}), tile_norms "
              f"launches {launches}, {ms:.3f} ms, library {lib_ms:.3f} ms", flush=True)
        check(rel <= tol, f"norm {name} {dtype}: rel err {rel:.3e} > {tol:.3e}")
        check(launches == (2 if name == "Fro" else 1), f"norm {name} {dtype}: launches")
    # Fro on data whose unscaled sum of squares would overflow or
    # underflow: the scaled pass, held to a float64 reference of the same
    # values (c times the norm of A c / c, which does not overflow)
    for c in ((1e300, 1e-160) if dtype == "float64" else (1e30, 1e-20)):
        Ac = A * c
        Mc = stt.Matrix.from_global(Ac, 512)
        pk.reset_launches()
        got = stt.norm(stt.Norm.Fro, Mc)
        torch.cuda.synchronize()
        launches = pk.LAUNCHES["tile_norms"]
        counted = {k: v + pk.LAUNCHES[k] for k, v in counted.items()}
        ref = c * torch.linalg.matrix_norm(Ac.double() / c, "fro")
        rel = float((got.double() - ref).abs() / ref)
        ms = cuda_ms(lambda: stt.norm(stt.Norm.Fro, Mc), reps=3)
        out[f"Fro {c:g}"] = {"rel_err": rel, "launches": launches, "ms": ms}
        print(f"  norm Fro {dtype} of A x {c:g} (the scaled pass): rel err {rel:.3e} (tol "
              f"{tol:.3e}), tile_norms launches {launches}, {ms:.3f} ms", flush=True)
        check(bool(torch.isfinite(got)) and rel <= tol,
              f"norm Fro {dtype} of A x {c:g}: {float(got):.6e}, rel err {rel:.3e}")
        check(launches == 2, f"norm Fro {dtype} of A x {c:g}: {launches} launches")
        del Ac, Mc
    pk.reset_launches()
    cn = stt.colNorms(stt.Norm.One, Am)
    torch.cuda.synchronize()
    launches = pk.LAUNCHES["tile_norms"]
    counted = {k: v + pk.LAUNCHES[k] for k, v in counted.items()}
    ref = A64.abs().sum(0)
    err, ratio = elementwise_err(cn, ref, ref, n)
    print(f"  colNorms {dtype}: err {err:.3e} (max err/tol {ratio:.3e}), tile_norms launches "
          f"{launches}", flush=True)
    check(ratio <= 1 and launches == 1, f"colNorms {dtype}: err/tol {ratio:.3e}, {launches}")
    pk.reset_launches()
    S = stt.add(0.5, Am, -2.0, Am).to_global()
    nt = stt.norm(stt.Norm.One, stt.conj_transpose(Am))
    torch.cuda.synchronize()
    counted = {k: v + pk.LAUNCHES[k] for k, v in counted.items()}
    same = torch.equal(S, 0.5 * A + -2.0 * A)
    ref = torch.linalg.matrix_norm(A64, float("inf"))
    rel = float((nt.double() - ref).abs() / ref)
    print(f"  add {dtype}: bitwise equal to 0.5 A - 2 A: {same}; norm One of the transposed "
          f"view: rel err {rel:.3e}; launches {dict(pk.LAUNCHES)}", flush=True)
    check(same, f"add {dtype}: not bitwise equal to 0.5 A - 2 A")
    check(rel <= tol, f"norm One of the transposed view {dtype}: rel err {rel:.3e}")
    check(pk.LAUNCHES["tile_norms"] == 1, f"norm One of the transposed view {dtype}: launches")
    del Am, cn, ref, A64, S
    # the other kinds, on the JAX package's plain route
    low = torch.tril(A).double()
    cases = (("HermitianMatrix", low + torch.tril(A, -1).T.double(),
              stt.HermitianMatrix.from_global(A, 512, uplo=stt.Uplo.Lower)),
             ("TriangularMatrix", torch.triu(A).double(),
              stt.TriangularMatrix.from_global(A, 512, uplo=stt.Uplo.Upper)))
    for kind, full, M in cases:
        pk.reset_launches()
        got = {nm: float(stt.norm(stt.Norm[nm], M)) for nm in ("One", "Max", "Fro")}
        launches = pk.LAUNCHES["tile_norms"]
        want = {"One": float(torch.linalg.matrix_norm(full, 1)),
                "Max": float(full.abs().amax()),
                "Fro": float(torch.linalg.matrix_norm(full, "fro"))}
        worst = max(abs(got[k] - want[k]) / want[k] for k in want)
        print(f"  norm of a {kind} {dtype}: worst rel err {worst:.3e}, tile_norms launches "
              f"{launches} (the plain route)", flush=True)
        check(worst <= tol, f"norm of a {kind} {dtype}: rel err {worst:.3e}")
    out["launches"] = counted
    return out


def complex_phase(stt, pk, ck, lk, qf, gen, dev) -> None:
    """complex128 ``posv`` (and ``potrs_from_global``), ``gesv`` (and
    ``getrs_from_global``), ``gesv`` with MethodLU.RBT and ``gels`` at
    n = 2048 with default options.  The kernels take float32/float64
    only, so the resolvers route complex operands to the recursive
    schedule and the solve phases to the library solve: each scaled
    residual is inside PERF.md section 2's bound and no kernel launches."""
    n, nrhs, dt = 2048, 3, torch.complex128
    eps = torch.finfo(torch.float64).eps
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    res = lambda A, X, B: n1(A @ X - B) / (n1(A) * n1(X) * A.shape[0] * eps)  # noqa: E731
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)  # noqa: E731
    routes = (ck.resolve_schedule(n, dt, "auto", dev), lk.resolve_lu_schedule(n, n, dt, "auto", dev),
              qf.resolve_qr_schedule(2 * n, n, dt, "auto", dev))
    check(routes == ("recursive",) * 3, f"complex128 routes {routes}: not the recursive schedule")
    G = rnd(n, n)
    S = G @ G.mH + n * torch.eye(n, device=dev, dtype=dt)
    B = rnd(n, nrhs)
    M = lambda X: stt.Matrix.from_global(X, 256)  # noqa: E731
    pk.reset_launches()
    t0 = time.perf_counter()
    X, L, info = stt.posv(stt.HermitianMatrix.from_global(S, 256), M(B))
    r = {"posv": res(S, X.to_global(), B)}
    check(int(info) == 0, f"complex128 posv: info {int(info)}")
    r["potrs_from_global"] = res(S, stt.potrs_from_global(L.to_global(), B), B)
    X, LU, piv, info = stt.gesv(M(G), M(B))
    check(int(info) == 0, f"complex128 gesv: info {int(info)}")
    r["gesv"] = res(G, X.to_global(), B)
    r["getrs_from_global"] = res(G, stt.getrs_from_global(LU.to_global(), piv.apply(B)), B)
    X, _, _, info = stt.gesv(M(G), M(B), {stt.Option.MethodLU: stt.MethodLU.RBT})
    check(int(info) == 0, f"complex128 gesv_rbt: info {int(info)}")
    r["gesv_rbt"] = res(G, X.to_global(), B)
    T, Bt = rnd(2 * n, n), rnd(2 * n, nrhs)
    X = stt.gels(M(T), M(Bt)).to_global()
    r["gels"] = n1(T.mH @ (T @ X - Bt)) / (n1(T) * (n1(T) * n1(X) + n1(Bt)) * 2 * n * eps)
    torch.cuda.synchronize()
    launched = {k: v for k, v in pk.LAUNCHES.items() if v}
    print(f"  complex128 n={n}, default options: routes {routes}, scaled residuals "
          + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
          + f"; kernel launches {launched or 0}; {time.perf_counter() - t0:.1f} s", flush=True)
    for k, v in r.items():
        check(v <= (1000 if k == "gesv_rbt" else 3), f"complex128 {k}: scaled residual {v:.3e}")
    check(not launched, f"complex128: kernels launched {launched}")


def _profile_call(label, fn, pieces=None) -> None:
    """torch.profiler's device time by kernel over one call of fn and the
    host wall time of that same call, then the operator table.
    ``pieces``: {name: (substrings)}, the device time of the kernels whose
    name holds any of them, printed as a line each."""
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
    for name, keys in (pieces or {}).items():
        sel = [e for e in rows if any(k in e.key for k in keys)]
        print(f"  piece {name}: {sum(dev_us(e) for e in sel) / 1e3:.3f} ms device time in "
              f"{sum(e.count for e in sel)} launches ({', '.join(keys)})")
    print(ka.table(sort_by="self_device_time_total", row_limit=25))


def profile(stt, gen, dev) -> None:
    """Wall time of one warm ``posv`` and one warm ``gesv`` (n = 16384,
    nrhs = 512, float64, default options), then a profile of a third call
    of each and of one warm solve phase of each (``potrs_from_global``,
    ``getrs_from_global``: its idle share is what the host-stepped trsm
    launches cost); then the same for ``gels`` at (32768, 16384)."""
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
    _profile_call("posv", lambda: stt.posv(Am, Bm), {
        "chol_base": ("chol_base_kernel",),
        "gemm_sub": ("sub_abt_kernel<double, false", "subk_reduce<double, false"),
        "syrk_diag": ("sub_abt_kernel<double, true", "subk_reduce<double, true")})
    # the solve phase of a factor-cache hit: two trsm sweeps, host-stepped
    Lg = stt.potrf(Am)[0].to_global().contiguous()
    stt.potrs_from_global(Lg, B)
    _profile_call("potrs_from_global", lambda: stt.potrs_from_global(Lg, B))
    del Am, A, Lg
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
    _profile_call("gesv", lambda: stt.gesv(Am, Bm), {"panel_lu": ("panel_lu_kernel",)})
    LU, piv, _ = stt.getrf(Am)
    LUg, PB = LU.to_global().contiguous(), piv.apply(B)
    del LU
    stt.getrs_from_global(LUg, PB)
    _profile_call("getrs_from_global", lambda: stt.getrs_from_global(LUg, PB))
    del LUg, PB
    del A, Am, Bm, B
    m = M_QR
    A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(m, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.Matrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stt.gels(Am, Bm)
        torch.cuda.synchronize()
        t_gels = time.perf_counter() - t0
    print(f"  warm gels {t_gels:.4f} s (host clock, float64 ({m}, {n}), nrhs={nrhs})")
    _profile_call("gels", lambda: stt.gels(Am, Bm),
                  {"larft": ("larft_gram_kernel", "larft_finish_kernel")})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import slate_tpu_torch as stt
        from slate_tpu_torch.aux import metrics
        from slate_tpu_torch.ops import chol_kernels as ck
        from slate_tpu_torch.ops import lu_kernels as lk
        from slate_tpu_torch.ops import qr_fast as qf
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
        print("profile: posv, gesv and gels, float64", flush=True)
        profile(stt, gen, dev)
        print(smi)
        return 0
    t_start = time.perf_counter()
    print("phase 2: kernels against their plain versions", flush=True)
    kres = {d: kernel_phase(pk, d, gen, dev) for d in DTYPES}
    for d in DTYPES:
        kres[d].update(lu_kernel_phase(pk, lk, d, gen, dev))
        torch.cuda.empty_cache()
        kres[d].update(qr_kernel_phase(pk, d, gen, dev))
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
    torch.cuda.empty_cache()
    print("phase 7: gels + gels_solve_from_global, the QR main path", flush=True)
    qres = {}
    for d in DTYPES:
        qres[d] = qr_main_path(stt, pk, qf, metrics, d, gen, dev)
        torch.cuda.empty_cache()
    print("phase 8: small QR cases", flush=True)
    small_qr(stt, pk, qf, ck, gen, dev)
    torch.cuda.empty_cache()
    print("phase 9: norms", flush=True)
    nres = {}
    for d in DTYPES:
        nres[d] = norm_phase(stt, pk, d, gen, dev)
        torch.cuda.empty_cache()
    print("phase 10: complex operands on the recursive schedule", flush=True)
    complex_phase(stt, pk, ck, lk, qf, gen, dev)
    torch.cuda.empty_cache()
    print(f"  phases 2-10: {time.perf_counter() - t_start:.1f} s", flush=True)

    # launches: of the main path that runs each kernel (posv for the
    # Cholesky kernels and the trsm pair of potrs_from_global, gesv for
    # panel_lu, gesv with MethodLU.RBT for butterfly_level, gels for
    # larft, the general-matrix norms and colNorms for tile_norms);
    # tile_geadd and tile_transpose have no route: their counts are those
    # of the gels run and the norm phase's runs, and must stay 0
    unrouted = {d: {"launches": {k: qres[d]["launches"][k] + nres[d]["launches"][k]
                                 for k in ("tile_geadd", "tile_transpose")}} for d in DTYPES}
    for d in DTYPES:
        check(unrouted[d]["launches"] == {"tile_geadd": 0, "tile_transpose": 0},
              f"{d}: a main path launched an unrouted kernel: {unrouted[d]['launches']}")
    sources = {"panel_lu": ("lu_kernels.cu", lres), "butterfly_level": ("lu_kernels.cu", rres),
               "larft": ("panel_kernels.cu", qres), "tile_norms": ("tile_kernels.cu", nres),
               "tile_geadd": ("tile_kernels.cu", unrouted),
               "tile_transpose": ("tile_kernels.cu", unrouted)}
    entries = []
    for d, suf in (("float64", "f64"), ("float32", "f32")):
        for name in ("chol_base", "syrk_diag", "gemm_sub", "trsm_lower", "trsm_upper",
                     "panel_lu", "butterfly_level", "larft", "tile_norms", "tile_geadd",
                     "tile_transpose"):
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
                                      "gesv_rbt": strip(rres), "gels": strip(qres),
                                      "norm": strip(nres), "trsm_lu_modes": lu_modes,
                                      "tile_norms_kinds": {d: kres[d]["tile_norms"]["kinds"]
                                                           for d in DTYPES},
                                      "larft_height_24576": {d: kres[d]["larft"]["height_24576"]
                                                             for d in DTYPES}}))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
