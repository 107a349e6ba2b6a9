#!/usr/bin/env python3
"""Smoke test of slate_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py            # all phases (exit 0 = passed)
    python3 chip_smoke.py --eig      # build + phase 15 alone (with --profile: its profile alone)
    python3 chip_smoke.py --svd      # build + phase 16 alone (with --profile: a warm float64
                                     # SVD of case (a) by stage, svd_profile)
    python3 chip_smoke.py --restore  # build + phase 17 alone
    python3 chip_smoke.py --admission  # build + phase 18 alone
    python3 chip_smoke.py --fabric   # build + phase 19 alone
    python3 chip_smoke.py --soak     # build + phase 20 alone
    python3 chip_smoke.py --scale    # build + phase 21 alone
    python3 chip_smoke.py --fleet    # build + phase 22 alone
    python3 chip_smoke.py --profile  # build + profiles of one warm posv (with its chol_base,
                                     # gemm_sub and syrk_diag pieces), gesv and CALU gesv (with
                                     # their panel_lu pieces) and gels (with its larft piece),
                                     # of one warm solve phase of posv and gesv, and of one
                                     # warm posv_mixed, posv_mixed_gmres and gesv_mixed, and a
                                     # warm float64 heev at n = 4096 by stage (eig_profile)

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
     float32/float64 only), residuals within bound, no kernel launch;
 11. the rest of the dense drivers: ``gesv`` with MethodLU.CALU at
     n = 16384, nrhs = 512 (residual within the JAX package's CALU bound
     100, ``tntpiv_kernel_launches`` = 512 panel_lu launches, getrf time
     against phase 4's and ``torch.linalg.lu_factor``); tournament
     pivoting at n = 4096 through the kernel and the plain panel (equal
     perm and bitwise-equal LU); panel_lu bit for bit against its plain
     version at the CALU path's shapes ((2048, 512) and (1024, 512) with
     pivoting, (16384, 512) without); ``trtri`` (through
     ``tri_inv_blocked``), ``potri`` and ``tri_inv_blocked`` of an
     n = 16384 factor (inverse residual <= 3, timed against
     ``solve_triangular(L, I)``, ``cholesky_inverse`` and
     ``linalg.inv``); ``pocondest``,
     ``trcondest`` and ``gecondest`` (One, Inf) within ref <= rcond <=
     3 ref; ``symm``, ``trmm`` (both sides) and ``syr2k`` against
     ``torch.matmul``; a rank-1 ``chol_update`` and downdate of the
     float64 factor (residual <= 3, host-clock time);
 12. matgen and the mixed-precision solvers: ``posv_mixed``,
     ``posv_mixed_gmres``, ``gesv_mixed`` and ``gesv_mixed_gmres`` at
     n = 16384, nrhs = 512, float64 working, default options (the
     float32 factor through chol_base / syrk_diag / gemm_sub or
     panel_lu, launches equal to the mirrors; no fallback, residual
     <= 3, final backward error <= the policy's tolerance; times
     against phases 3 and 4 and cholesky + cholesky_solve / lu_factor
     + lu_solve), ``posv_mixed`` and ``gesv_mixed`` in float32 working
     (the CUDA row's degenerate pair); ``matgen.cond_matrix`` operands
     at n = 4096 (cond 1e4 converges in <= 8 steps; cond 1e9 falls
     back, gives info != 0 without the fallback; at cond 1e7 GMRES-IR
     converges where classical IR stalls; GMRES-IR's fallback at cond
     1e8 / 1e9) and at n = 128 (GMRES-IR converges at cond 1e9 where
     classical IR stalls); ``generate_matrix`` rand / randn of a 16384^2 matrix in
     tiles of 512 and 256, bitwise equal, rand bitwise equal to
     ``philox.random_np`` at sampled (i, j);
 13. the serve path (``slate_tpu_torch.serve``) on cuda:0, metrics on,
     default options, operands passed as numpy: factor-cache hit streams
     of posv (X X^T + n I) and gesv (normal A + 2 sqrt(n) I) at n = 4096
     (bucket 4096, tiles of 64) through ``SolverService(factor_cache=
     FactorCache(8), batch_max=8, batch_window_s=0.002)``: one miss
     (launches equal to ``chol_kernel_launches`` / ``getrf_kernel_launches``
     plus one trsm sweep each), ``warmup()``, 24 requests of nrhs = 16
     over 8 B (24 hits, no cold build, only the trsm pair launched,
     ``trsm_kernel_launches(4096)`` a dispatch each, residuals <= 3),
     requests/s, p50 / p99 of the queued / execute / total latency, one
     hit dispatch against two ``solve_triangular``, the host time of
     ``matrix_fingerprint`` / ``residual_ok`` / the finiteness check a
     request, the device's idle share over a profiled stream of 8 hits,
     and ``result_corrupt`` and ``factor_stale`` fired once each (counted
     once, X still right); gels at (8192, 4096): one miss through
     ``gels_factor_pack`` (larft launches as ``geqrf_kernel_launches``),
     12 hits (normal-equations residual <= 3, no kernel launched), a hit
     dispatch against ``torch.ormqr`` + one solve; a full-phase stream
     with the factor cache off: 24 interleaved gesv and posv requests,
     n in {1500, 2600, 3900} (buckets 2048 / 4096 / 4096), coalesced,
     the kernel family at the 2048 bucket, residuals <= 3, and the 4096
     bucket's ``from_global`` / ``to_global`` in tiles of 64;
 14. band and indefinite, n = 16384, nrhs = 512, seeded operands on the
     card: ``pbsv`` at kd = 256 in both Uplo (the windowed band
     Cholesky, whose 64 window Cholesky factors take the ``flat``
     schedule: no kernel; the time a window; against ``cholesky`` +
     ``cholesky_solve`` of the dense matrix) and at kd = 4096 = n / 4 (the
     dense potrf: ``chol_kernel_launches``); ``gbsv`` at kl = ku = 128 (one
     panel_lu launch a window, ``band_lperms`` set, panel_lu at the
     window shape (256, 128) bit for bit against its plain version,
     residual within the JAX package's gbsv bound 30; against
     ``lu_factor`` + ``lu_solve``) and at kl = ku = 4096 (the dense getrf:
     ``getrf_kernel_launches``); ``tbsm`` at kd = 256, lower and upper,
     both sides and one transposed op, against ``solve_triangular``;
     ``gbmm`` and ``hbmm`` against ``torch.matmul`` of the masked dense
     matrix; ``hesv`` of (G + G^T)/2 + 3 sqrt(n) diag(+-1) (pivot-free:
     info 0, no Aasen or butterfly, ``getrf_kernel_launches`` panel_lu
     launches without pivot search, residual <= 3; against
     ``ldl_factor`` + ``ldl_solve``); float64 ``hetrf(method="rbt")`` +
     ``hetrs`` of kron(I, [[0, 1], [1, 0]]) (2 x 14 butterfly_level
     launches each, residual <= 1000); Aasen (``hetrf(method="aasen")``
     and ``hesv``'s breakdown refactor) on the zero-diagonal chain at
     n = 2048, cut from 16384 because Aasen's LTL^H is the reference's
     host column loop (O(n^3) in numpy BLAS-2 calls); complex128
     ``pbsv``, ``gbsv`` and ``hesv`` at n = 2048 with no kernel launch.
     Host-clock times, launches and peak device memory of each call.
 15. the Hermitian eigensolvers at n = 4096, tiles of 128 (the JAX
     package's on-chip heev size), seeded (G + G^H)/2 on the card, metrics
     on: ``heev`` with vectors in float64 (``heev_staged``; the native
     host chaser, counted in ``heev.hb2st.host``) and float32 (the device
     wavefront), values only in float64 (the Sturm bisection); ``hegv``
     itype 1 in float64 with B = X X^T + n I (the Cholesky kernels at
     ``chol_kernel_launches``), and itype 3 with B stored Upper at
     n = 1024 (below the crossover: no kernel); complex128 ``heev`` at
     n = 1024 (the device wavefront, no kernel).  Gates: eigenvalues
     within 10 n eps ||A||_1 of ``eigvalsh``, ||AZ - Z Lambda||_1 /
     (||A||_1 n eps) and ||Z^H Z - I||_1 / (n eps) <= 100, hegv's
     ||AX - BX Lambda||_1 / (||A||_1 ||X||_1 n eps) (itype 1) and
     ||BAX - X Lambda||_1 / (||A||_1 ||B||_1 ||X||_1 n eps) (itype 3)
     <= 100 with its eigenvalues within 10 n eps max|w| of the library
     route's, the route.
     Stage times, peak memory and the library yardsticks (``eigh``,
     ``eigvalsh``, cholesky + solve_triangular + eigh).  ``--profile``
     adds a profiled float64 heev: device busy time and launches by
     stage and of he2hb's panel against its trailing update, and the
     wavefront's and the Sturm scan's launches a step.
 16. the SVD (``stt.svd``, default options, seeded normal operands, tiles
     of 64, metrics on): (a) tall (8192, 2048) float64 with vectors: the
     geqrf pre-reduction (``geqrf_kernel_launches(2048)`` larft launches,
     no other kernel), ge2tb, the Jordan-Wielandt chase on the native
     host chaser (``svd.hb2st.host``), stedc, unmtr_hb2st, the
     unmbr_ge2tb back-transforms and unmqr; (b) square n = 2048 float32
     with vectors on the device wavefront; (c) square n = 2048 float64
     values only (host chase, Sturm bisection); (d) (1024, 1536) float64
     with vectors, tiles of 128 (``svd_accurate`` on the gathered band);
     (e) complex128 n = 1024 with vectors on the device wavefront.  Gates:
     singular values within 10 max(m, n) eps sigma_max of ``svdvals`` of
     the float64 operand, ||A - U S V^H||_1 / (||A||_1 max(m, n) eps) and
     ||U^H U - I||_1 / (k eps), ||V^H V - I||_1 / (k eps) <= 100, the
     route, the launches.  Host-clock time, the stage times of the
     instrumented sub-drivers, peak memory, cuSOLVER's ``svd`` and
     ``svdvals`` as yardsticks.  ``--svd --profile`` profiles one warm
     case (a) by stage: device busy time, launches and idle share of each
     ``svd.*`` range, ge2tb's panels against its trailing updates.
 17. restore, replicas and integrity, at phase 13's shapes (n = 4096,
     tiles of 64, nrhs = 16, batch point 4): (a) float64 cold start: a
     two-lane service with an artifact store warms gesv / posv; a fresh
     interpreter of the port alone (no nvcc on its PATH) restores it:
     every entry restored, none compiled, the kernel library opened from
     the store, no nvcc run, ``wait_ready()`` True, a 20-request stream
     with no cold build; one flipped byte in one stored kernel library
     is caught by its sha256 before the library is opened (a second
     fresh interpreter counts ``serve.artifact_corrupt``, opens the
     library from the build, solves, and the store's copy is rewritten
     clean); one flipped byte in one artifact is counted
     ``serve.artifact_corrupt``, rebuilt and re-saved clean; each artifact
     fault site armed once is caught by its counter; restore time against
     phase 1's build.  (b) ``replicas=2`` on cuda:0: a factor-cache hit
     stream and a full-phase stream (dispatches a lane), ``add_replica``
     (no cold build on traffic), ``remove_replica`` (its queue re-homed,
     nothing lost).  (c) ``integrity="full,abft"``, two lanes: every
     delivery certified, the ABFT buckets' launches equal the factor's
     mirror (``getrf_kernel_launches`` / ``chol_kernel_launches``, a
     dispatch's batch point times; the drivers' solves in a full-phase
     core are library triangular solves, so no trsm launch), ``sdc_solve`` and
     ``sdc_factor`` once each caught and recovered, a lane quarantined
     and probed back, a delayed dispatch's queue hedged to the other
     lane; the ABFT dispatch against the plain one (CUDA events, rounds
     of the two interleaved, and a profile of one of each: device time by
     op), the host certificate, requests/s with the plane on and off.
 18. the admission plane, the checked runtime and the device monitor, at
     phase 13's width (n = 4096, tiles of 64, nrhs = 16, batch point 4,
     cuda:0): (a) fairness, f64 and f32: the victim's eight gesv alone
     set the budget (twice their p99, 30 ms injected into every dispatch
     after warmup); then tenant ``abuser`` (low, ``rate=10,burst=4,
     share=0.25``) floods 48 gesv at n = 2048 before the victim ``good``
     (``weight=4``, high) submits its eight: the static service (f64;
     planes off, tags inert) misses the budget, the adaptive one
     (``adaptive=True, latency_budget_s=budget``) holds it, and
     tight-deadline abuser traffic raises the overload level and ends in
     typed Sheds beside quota rejections; its JSONL passes
     ``tools/tenant_report.py`` and is read by ``tools/latency_report.py``.
     (b) ``tenant_flood`` armed by env in a fresh interpreter: one real
     request, the 24-request burst refused and counted,
     ``tools/chaos_report.py`` exit 0.  (c) a fresh interpreter with
     ``SLATE_TPU_SYNC_CHECK=1,seed=7,yield=0.2``: two lanes, tenants,
     certification and hedging, 20 gesv / posv requests, a lane removed
     half way: no lock-order or lockset violation, ``tools/race_report.py``
     exit 0, requests/s against the same stream unchecked here.  (d) the
     device monitor: the ``cuda:0`` row (bytes in use, the peak, the
     limit), a cost row a warmed core (``flops_model`` = ``phase_flops``,
     a measured ``peak_bytes``), each core's warm rate against the
     ``h100`` peaks row, and a fresh interpreter that restores the rows
     from the manifest with no second measurement.  (e) every stream's
     launches equal the mirror of the cores it ran, every residual <= 3.
 19. the factor fabric (``slate_tpu_torch/fabric``), f64 and f32, the JAX
     gate's stream (``run_tests.py:600-640``) at the serve tier's gels
     width: A (8192, 4096), tiles of 64, nrhs = 16, one lane on cuda:0.
     The armed leg (``factor_arena=FactorArena()``): one miss (larft at
     ``geqrf_kernel_launches``), ``warmup()``, 20 pristine
     ``FactorSession`` solves (every one a factor-cache hit, no cold
     build, no kernel launch, ``serve.arena.upload_avoided_bytes`` > 0),
     an append of 64 rows (the O(k n^2) fold on the card) and one
     streamed solve (normal-equations residual <= 3, against
     ``torch.linalg.lstsq``); ``tools/factor_report.py`` exits 0 on its
     metrics dump.  The unarmed leg (``factor_arena=False``): the same
     operands give a byte-identical X stream and move no
     ``serve.arena.*`` counter.  Timed (CUDA events, submit to result,
     medians): a resident hit, a hit after ``spill`` (the pack
     re-uploaded; devmon's bytes in use before and after the spill,
     which must free the pack), an unarmed hit and a refactoring miss,
     each with the bytes it moved host to device; an append of 64 rows
     against a ``refactor``.
 20. the soak fabric (``slate_tpu_torch/soak``: the delivery-tap
     recorder, open-loop replay, the health timeline), judged by
     ``tools/soak_report.py``: (a) the JAX soak drill as written
     (``run_tests.py:1929-2090``), f64, in a fresh interpreter
     under ``SLATE_TPU_SYNC_CHECK=1``: n = 12 / 24, nrhs = 2, about 10^4
     requests open loop against two lanes on cuda:0 with tenants,
     adaptive admission, certification with hedging and a factor cache
     of 64, under ``latency:every=97,ms=30;sdc_solve:every=211,seed=3;
     worker_death:every=1501``; ``add_replica``, the record -> replay
     round trip and the two-run determinism check at the gate's
     tolerances, ``remove_replica`` with nothing dropped; the report
     with the gate's arguments exits 0, no sync violation, the orphan
     audit on a ring that never evicted.  (b) the escape stream
     (integrity and factor cache off, ``sdc_solve:every=7``): wrong X
     delivered and the report exits non-zero.  (c) the full-width drill,
     f64 and f32: tiles of 64, batch point 4, two lanes on cuda:0, the
     five generators at n = 2048 / 4096, nrhs = 16 (120 requests: 60
     repeated-A gesv, 18 posv, 22 multitenant, 10 deadline storm, 10
     flood); calibration (the warm prelude, which runs the factor
     kernels on its misses, then 24 closed-loop requests: rate R, p50,
     p99), then the mix open loop at 0.7 R under ``latency:every=23,
     ms=30;sdc_solve:every=53,seed=3;worker_death:every=61`` (each
     site fires), recorder rows = delivered + typed errors, the report
     at 4 x the calibration p99 (0 bad results, 0 orphans, 0 sampler
     errors); requests/s, each bucket's p50 / p99, the disruption
     intervals, the launches by kernel (the trsm pair on the hits), the
     idle share of a profiled slice of 20 requests, and a 30-request
     multitenant round trip replayed twice.
 21. the elastic capacity plane (``slate_tpu_torch.scale``: the signal
     aggregator, the hysteresis AutoScaler, the predictive warmup plan,
     the gate's gauges), judged by ``tools/capacity_report.py``: (a) the
     JAX burst drill as written (``run_tests.py:2220-2337``), f64, in a
     fresh interpreter under ``SLATE_TPU_SYNC_CHECK=1``: ``gen_burst(500,
     seed=9, base_rps=30, burst_rps=120, burst_start_s=1.0,
     burst_len_s=2.0, n=12, nrhs=2, distinct=4)`` saved and loaded as a
     spec, batch point 1, a factor cache of 16, an artifact store,
     ``latency:every=1,ms=12``; the static leg (one lane) misses the 1 s
     budget, the elastic leg (``min=1,max=3,up=1.0,down=0.2,
     up_cooldown=0.25,down_cooldown=2.0,step=2,period=0.05``) holds it, the
     peak <= 3 and the fleet back at 1, every up driven, no sync
     violation, no swallowed step / add / remove error, every snapshot's
     device-memory headroom a float in (0, 1]; every lane on cuda:0,
     below the kernels' crossover (no launch).  (b) the same drill at the
     serve tier's width: gesv repeated-A at n = 2048, nrhs = 16, tiles of
     64, batch point 1, a factor cache of 16; the warm prelude factors the
     4 pool matrices (panel_lu); one card's lane scaling (the closed-loop
     rate R1, R2, R3 of 24 hits from 4 clients with 1, 2, 3 lanes and the
     idle share over each); calibration (the pacer's ceiling P = 1 / the
     submit time's p50, a tax T raised from 50 ms until 2 R1(T) <= P / 2;
     f32 when f64's P cannot give s <= 4); the trace time-scaled by
     s = 60 / R1(T) (rates 0.5 / 2 R1(T), burst start, budget 0.5 s and the
     policy's period and cool-downs times s, a burst of s, the requests
     cut to end s after it); static and elastic legs under the tax, the
     report exit 0, every residual <= 3, the trsm pair's launches
     ``trsm_kernel_launches(2048)`` a dispatch and panel_lu's the
     prelude's mirror; the decision timeline, both p99s, the fleet, the
     over-provision ratio and the requests/s delivered in the burst.
     (c) the warmup plan of (b)'s recorded rows (costs from the cache's
     captured rows or the ``phase_flops`` model; the 2048 gesv bucket and
     its solve sibling, the 4 pool matrices preloaded) applied by
     ``add_replica(plan=)`` and its ``scale.prime_*`` counts.
 22. the fleet tier (``slate_tpu_torch/fleet``: the wire, the worker, the
     router), judged by ``tools/fleet_report.py``: (a) the JAX fleet drill
     as written (``run_tests.py:2400-2578``) in a fresh interpreter under
     ``SLATE_TPU_SYNC_CHECK=1``: the port's router and two spawned workers
     on cuda:0 (host0 ``sdc_solve:every=2``, host1 ``latency:every=3,
     ms=40``), N = 12, f32, tenants ``abuser:rate=4,burst=4;victim:
     rate=500,burst=100``; SDC quarantine and probe recovery, fleet-wide
     quota, a real SIGKILL (``host_death:once``) with respawn, rejoin and a
     forced probe, ``rpc_timeout:every=4;host_partition:once``, the fan-in
     (``dump_hosts``, ``tools/trace_stitch.py``, ``tools/metrics_merge.py
     --tag``); the report with the gate's arguments exits 0, no sync
     violation, no JAX module, no launch.  (b) the escape leg: one worker
     under ``sdc_solve:every=2``, ``cert=off``: wrong X delivered and the
     report exits non-zero.  The whole run starts (a) and (b)'s child
     before phase 15 and waits for it before phase 17: the n = 12 drill
     runs beside the eigensolvers and the SVD, which gate no latency;
     ``--fleet`` runs it first.  (c) the serve tier's width: gesv at n = 2048,
     nrhs = 16, f64 and f32 in turn over 4 pool matrices a dtype, no factor
     cache, workers started here (``connect=``), ``cert=full``; requests/s
     of an untaxed closed-loop stream (4 clients, 48 requests) in process
     and through the router with 1 and 2 workers, the wire bytes and the
     router's certificate ms a request, the card's idle share
     (``nvidia-smi``); the drill (SDC until quarantine and probe recovery,
     the abuser's quota, worker 1 killed with requests in flight and a
     standby process taking its port, timeouts and a partition), every delivered X
     held to the scaled residual (<= 3), the report at 4 x the in-process
     p99; each drained worker's panel_lu launches equal the mirror of the
     core items it ran (requests and the repeat pads of its batch points;
     a full-phase gesv solves with the library: no trsm launch), no nvcc
     run, no JAX module.

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
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
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
    t_posv = metrics.timers()["posv"]["total_s"]
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
            "potrf_s": t_fact, "posv_s": t_posv, "potrf_gflops": gflops,
            "cholesky_lib_ms": t_lib,
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


# ---------------------------------------------------------------------------
# phase 11: the rest of the dense drivers
# ---------------------------------------------------------------------------

CALU_BOUND = 100  # the JAX package's CALU residual bound (tests/test_lu.py:240)


def inv_residual(X, A) -> float:
    """||X A - I||_1 / (||A||_1 ||X||_1 n eps), in float64."""
    X64, A64 = X.double(), A.double()
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    R = X64 @ A64
    R.diagonal().sub_(1.0)
    return n1(R) / (n1(A64) * n1(X64) * A.shape[0]) / torch.finfo(X.dtype).eps


def calu_path(stt, pk, lk, metrics, dtype, gen, dev, lres) -> dict:
    """gesv with MethodLU.CALU at n = 16384, nrhs = 512: residual within
    CALU_BOUND, info 0, tntpiv_kernel_launches(16384, 16384, 512) = 512
    panel_lu launches (8 elections, 4 + 2 + 1 plays and one factor
    without pivoting a step, 32 steps); getrf time against phase 4's
    partial-pivot getrf and torch.linalg.lu_factor."""
    dt = getattr(torch, dtype)
    n, nrhs, nb = N_MAIN, NRHS_MAIN, 512
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.Matrix.from_global(A, nb), stt.Matrix.from_global(B, nb)
    torch.cuda.synchronize()
    metrics.reset()
    pk.reset_launches()  # counts of the CALU path only
    X, _, _, info = stt.gesv(Am, Bm, {stt.Option.MethodLU: stt.MethodLU.CALU})
    torch.cuda.synchronize()
    counts = dict(pk.LAUNCHES)
    t_getrf = metrics.timers()["getrf"]["total_s"]
    t_gesv = metrics.timers()["gesv"]["total_s"]
    r = scaled_residual(A, X.to_global(), B)
    expect = lk.tntpiv_kernel_launches(n, n, nb)
    print(f"  gesv CALU {dtype} n={n} nrhs={nrhs}: residual {r:.3e} (bound {CALU_BOUND}), "
          f"info {int(info)}, getrf {t_getrf:.3f} s (partial pivoting, phase 4: "
          f"{lres['getrf_s']:.3f} s; torch.linalg.lu_factor {lres['lu_factor_lib_ms']:.1f} ms), "
          f"gesv {t_gesv:.3f} s, panel_lu launches {counts['panel_lu']} (expected {expect})",
          flush=True)
    check(int(info) == 0, f"gesv CALU {dtype}: info = {int(info)}")
    check(r <= CALU_BOUND, f"gesv CALU {dtype}: scaled residual {r:.3f} > {CALU_BOUND}")
    check(counts["panel_lu"] == expect,
          f"gesv CALU {dtype}: panel_lu launches {counts['panel_lu']} != {expect}")
    check(sum(counts.values()) == counts["panel_lu"],
          f"gesv CALU {dtype}: other kernels launched: {counts}")
    return {"residual": r, "getrf_s": t_getrf, "gesv_s": t_gesv,
            "panel_lu_launches": counts["panel_lu"]}


def calu_panels(pk, dtype, gen, dev) -> dict:
    """panel_lu against panel_lu_plain at the CALU main path's own
    shapes, perm and LU bitwise: a (2048, 512) election and a (1024, 512)
    play with pivoting, and the (16384, 512) panel factor without
    pivoting (its rows in the partial-pivot order, as the winners stand
    on top in the tournament)."""
    dt = getattr(torch, dtype)
    out = {}
    for M, pivot in ((2048, True), (1024, True), (N_MAIN, False)):
        P = torch.randn(M, 512, generator=gen, device=dev, dtype=dt)
        if not pivot:
            P = P[pk.panel_lu_plain(P)[1].long()].contiguous()
        got, perm = pk.panel_lu(P, pivot=pivot)
        ref, ref_perm = pk.panel_lu_plain(P, pivot=pivot)
        name = f"panel_lu {dtype} ({M}, 512, pivot={pivot})"
        check(torch.equal(perm, ref_perm), f"{name}: perm differs from panel_lu_plain")
        check(torch.equal(got, ref), f"{name}: LU not bitwise equal to panel_lu_plain")
        t = cuda_ms(lambda: pk.panel_lu(P, pivot=pivot), reps=3)
        t_plain = cuda_ms(lambda: pk.panel_lu_plain(P, pivot=pivot), reps=2)
        print(f"  {name}: perm and LU bitwise equal to the plain version, {t:.3f} ms, "
              f"plain {t_plain:.3f} ms", flush=True)
        out[f"{M}x512.pivot={pivot}"] = {"ms": t, "plain_ms": t_plain}
        del P, got, ref
    return out


def calu_routes(stt, pk, lk, dtype, gen, dev) -> dict:
    """blocked_getrf_tntpiv at n = 4096 in tiles of 512 with the panel
    factor chosen explicitly: the kernel route and the plain-panel route
    must give the same perm and bitwise-equal LU."""
    dt = getattr(torch, dtype)
    n, nb = 4096, 512
    G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    pk.reset_launches()
    t0 = time.perf_counter()
    lu_k, p_k = lk.blocked_getrf_tntpiv(G, nb, panel_fn=pk.panel_lu)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = pk.LAUNCHES["panel_lu"]
    t0 = time.perf_counter()
    lu_p, p_p = lk.blocked_getrf_tntpiv(G, nb, panel_fn=pk.panel_lu_plain)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    same_perm = bool(torch.equal(p_k, p_p))
    bitwise = bool(torch.equal(lu_k, lu_p))
    diff = float((lu_k - lu_p).abs().max())
    print(f"  CALU routes {dtype} n={n}: perm equal {same_perm}, LU bitwise equal {bitwise} "
          f"(max |diff| {diff:.3e}), kernel route {t_k:.3f} s with {launches} panel_lu "
          f"launches, plain route {t_p:.3f} s", flush=True)
    check(same_perm, f"CALU routes {dtype}: perm differs between the kernel and plain routes")
    check(bitwise, f"CALU routes {dtype}: LU differs between the routes by {diff:.3e}")
    check(launches == lk.tntpiv_kernel_launches(n, n, nb), f"CALU routes {dtype}: launches")
    return {"perm_equal": same_perm, "lu_bitwise": bitwise, "lu_max_diff": diff,
            "kernel_route_s": t_k, "plain_route_s": t_p}


def inverse_phase(stt, ck, dtype, gen, dev):
    """trtri and potri of a phase-3-style SPD factor at n = 16384 and
    tri_inv_blocked, each within ||X A - I||_1 / (||A||_1 ||X||_1 n eps)
    <= 3, timed against solve_triangular(L, I), torch.cholesky_inverse
    and torch.linalg.inv; then pocondest and trcondest (One, Inf)
    within ref <= rcond <= 3 ref, ref from the port's potri / trtri with
    torch.linalg.inv as a check.  Returns (results, A, its factor L) for
    chol_update_phase."""
    dt = getattr(torch, dtype)
    n = N_MAIN
    A = spd(n, dt, gen, dev)
    Lm, info = stt.potrf(stt.HermitianMatrix.from_global(A, 512))
    check(int(info) == 0, f"inverses {dtype}: potrf info {int(info)}")
    Lg = torch.tril(Lm.to_global())
    I = torch.eye(n, dtype=dt, device=dev)
    out = {}
    tri_lib = ("solve_triangular", lambda: torch.linalg.solve_triangular(Lg, I, upper=False))
    for name, fn, libs, ref_of in (
            ("trtri", lambda: stt.trtri(Lm).to_global(), (tri_lib,), Lg),
            ("potri", lambda: stt.potri(Lm).full_global(),
             (("cholesky_inverse", lambda: torch.cholesky_inverse(Lg)),), A),
            ("tri_inv_blocked", lambda: ck.tri_inv_blocked(Lg, 512),
             (tri_lib, ("linalg.inv", lambda: torch.linalg.inv(Lg))), Lg)):
        X = fn()
        torch.cuda.synchronize()
        r = inv_residual(X, ref_of)
        del X
        t = cuda_ms(fn, reps=2)
        t_libs = {lib_name: cuda_ms(lib, reps=2) for lib_name, lib in libs}
        print(f"  {name} {dtype} n={n}: ||XA - I|| scaled {r:.3e}, {t:.2f} ms, "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in t_libs.items()), flush=True)
        check(r <= 3, f"{name} {dtype}: scaled inverse residual {r:.3f} > 3")
        out[name] = {"residual": r, "ms": t, "library_ms": t_libs}
    n1 = lambda M, o=1: float(torch.linalg.matrix_norm(M.double(), ord=o))  # noqa: E731
    # pocondest: ref from potri, torch.linalg.inv as a check
    Ainv = stt.potri(Lm).full_global()
    ref_inv = n1(Ainv)
    chk = n1(torch.linalg.inv(A))
    check(abs(ref_inv - chk) <= 1e-4 * chk, f"pocondest {dtype}: potri norm {ref_inv} vs {chk}")
    del Ainv
    est = {"pocondest": (float(stt.pocondest(Lm, n1(A))), 1.0 / (n1(A) * ref_inv))}
    Tinv = stt.trtri(Lm).to_global()
    Linv_lib = torch.linalg.inv(Lg)
    for o, name in ((1, "One"), (float("inf"), "Inf")):
        ref_inv, chk = n1(Tinv, o), n1(Linv_lib, o)
        check(abs(ref_inv - chk) <= 1e-4 * chk, f"trcondest {dtype}: trtri norm {ref_inv} vs {chk}")
        est[f"trcondest.{name}"] = (float(stt.trcondest(Lm, stt.Norm[name])),
                                    1.0 / (n1(Lg, o) * ref_inv))
    del Tinv, Linv_lib
    out["condest"] = condest_check(est, dtype)
    return out, A, Lg


def condest_check(est: dict, dtype: str) -> dict:
    """ref (1 - 1e-4) <= rcond <= 3 ref for each (rcond, ref): the JAX
    tests' bound, the slack below ref for the rounding of ref itself."""
    out = {}
    for name, (rcond, ref) in est.items():
        print(f"  {name} {dtype}: rcond {rcond:.6e}, ref {ref:.6e} (ratio {rcond / ref:.4f})",
              flush=True)
        check(ref * (1 - 1e-4) <= rcond <= 3 * ref,
              f"{name} {dtype}: rcond {rcond:.6e} outside [{ref:.6e}, 3 x]")
        out[name] = {"rcond": rcond, "ref": ref}
    return out


def gecondest_phase(stt, dtype, gen, dev) -> dict:
    """gecondest (One, Inf) of the partial-pivot LU of randn + 2 sqrt(n) I
    at n = 16384, ref from the port's getri with torch.linalg.inv as a
    check."""
    dt = getattr(torch, dtype)
    n = N_MAIN
    A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    A.diagonal().add_(2 * n**0.5)
    LU, piv, info = stt.getrf(stt.Matrix.from_global(A, 512))
    check(int(info) == 0, f"gecondest {dtype}: getrf info {int(info)}")
    Ainv = stt.getri(LU, piv).to_global()
    Alib = torch.linalg.inv(A)
    est = {}
    for o, name in ((1, "One"), (float("inf"), "Inf")):
        an = float(torch.linalg.matrix_norm(A.double(), ord=o))
        ref_inv = float(torch.linalg.matrix_norm(Ainv.double(), ord=o))
        chk = float(torch.linalg.matrix_norm(Alib.double(), ord=o))
        check(abs(ref_inv - chk) <= 1e-4 * chk, f"gecondest {dtype}: getri norm {ref_inv} vs {chk}")
        est[f"gecondest.{name}"] = (float(stt.gecondest(LU, piv, an, stt.Norm[name])),
                                    1.0 / (an * ref_inv))
    return condest_check(est, dtype)


def blas3_phase(stt, dtype, gen, dev) -> dict:
    """symm, syr2k and trmm (both sides) at n = 16384 and k = 512 against
    torch.matmul of the mirrored or triangular operand, within
    elementwise_err's 10 sqrt(k) eps scale; times against that call."""
    dt = getattr(torch, dtype)
    n, k, nb = N_MAIN, NRHS_MAIN, 512
    S = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    B = torch.randn(n, k, generator=gen, device=dev, dtype=dt)
    C = torch.randn(n, k, generator=gen, device=dev, dtype=dt)
    Sm = stt.SymmetricMatrix.from_global(S, nb)
    Sf = torch.tril(S) + torch.tril(S, -1).mT
    Bm, Cm = stt.Matrix.from_global(B, nb), stt.Matrix.from_global(C, nb)
    out = {}

    def record(name, fn, lib, ref, scale, kk):
        got = fn()
        torch.cuda.synchronize()
        err, ratio = elementwise_err(got, ref, scale, kk)
        t, t_lib = cuda_ms(fn, reps=3), cuda_ms(lib, reps=3)
        print(f"  {name} {dtype}: max |err| {err:.3e} ({ratio:.3f} of tol), {t:.2f} ms, "
              f"torch.matmul {t_lib:.2f} ms", flush=True)
        check(ratio <= 1, f"{name} {dtype}: error {ratio:.3f} of the tolerance")
        out[name] = {"max_abs_err": err, "ms": t, "matmul_ms": t_lib}

    record("symm.Left", lambda: stt.symm(stt.Side.Left, 2.0, Sm, Bm, 0.5, Cm).to_global(),
           lambda: torch.matmul(Sf, B), 2.0 * (Sf @ B) + 0.5 * C,
           2.0 * (Sf.abs() @ B.abs()) + 0.5 * C.abs(), n)
    BmT, CmT = stt.transpose(Bm), stt.transpose(Cm)
    record("symm.Right", lambda: stt.symm(stt.Side.Right, 2.0, Sm, BmT, 0.5, CmT).to_global(),
           lambda: torch.matmul(B.mT, Sf), 2.0 * (B.mT @ Sf) + 0.5 * C.mT,
           2.0 * (B.abs().mT @ Sf.abs()) + 0.5 * C.abs().mT, n)
    Lt = torch.tril(S)
    Tm = stt.TriangularMatrix.from_global(S, nb, uplo=stt.Uplo.Lower)
    record("trmm.Left", lambda: stt.trmm(stt.Side.Left, 2.0, Tm, Bm).to_global(),
           lambda: torch.matmul(Lt, B), 2.0 * (Lt @ B), 2.0 * (Lt.abs() @ B.abs()), n)
    record("trmm.Right", lambda: stt.trmm(stt.Side.Right, 2.0, Tm, BmT).to_global(),
           lambda: torch.matmul(B.mT, Lt), 2.0 * (B.mT @ Lt), 2.0 * (B.abs().mT @ Lt.abs()), n)
    del Sm, Tm, Lt
    Cs = stt.SymmetricMatrix.from_global(S, nb)
    record("syr2k", lambda: stt.syr2k(2.0, Bm, Cm, 0.5, Cs).full_global(),
           lambda: torch.matmul(B, C.mT),
           2.0 * (B @ C.mT + C @ B.mT) + 0.5 * Sf,
           2.0 * (B.abs() @ C.abs().mT + C.abs() @ B.abs().mT) + 0.5 * Sf.abs(), 2 * k)
    return out


def chol_update_phase(stt, ck, A, Lg, gen, dev) -> dict:
    """A rank-1 update, then the downdate, of the float64 factor: each
    within ||L' L'^H - (A +- u u^H)||_1 / (||A||_1 n eps) <= 3.  The
    column loop is eager and host-bound; its time is printed."""
    n = Lg.shape[0]
    u = torch.randn(n, generator=gen, device=dev, dtype=Lg.dtype)
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    eps = torch.finfo(Lg.dtype).eps
    out = {}
    L = Lg
    for name, down, target in (("update", False, A + torch.outer(u, u)), ("downdate", True, A)):
        t0 = time.perf_counter()
        L = ck.chol_update(L, u, downdate=down)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        r = n1(L @ L.mT - target) / (n1(A) * n * eps)
        del target
        print(f"  chol_update {name} float64 n={n}: residual {r:.3e}, {t:.2f} s (host clock, "
              f"eager column loop)", flush=True)
        check(r <= 3, f"chol_update {name}: scaled residual {r:.3f} > 3")
        out[name] = {"residual": r, "s": t}
    return out


# ---------------------------------------------------------------------------
# phase 12: matgen and the mixed-precision solvers
# ---------------------------------------------------------------------------

MIXED_FALLBACK_BOUND = 100  # tests/test_refine.py:218-231: the fallback's residual


def _mixed_run(stt, pk, metrics, routine: str, Am, Bm, opts=None):
    """One counted mixed solve: (X, info, iters, launches, host seconds,
    final backward error)."""
    metrics.reset()
    pk.reset_launches()  # counts of this solve only
    X, info, iters = getattr(stt, routine)(Am, Bm, opts)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    return (X.to_global(), int(info), int(iters), launches,
            metrics.timers()[routine]["total_s"],
            metrics.gauges().get(f"refine.{routine}.residual"))


def _factor_mirror(ck, lk, spd: bool, n: int) -> dict:
    """The Hopper kernel launches of the factor a mixed solve makes:
    chol_kernel_launches (posv) or getrf_kernel_launches (gesv)."""
    if spd:
        return ck.chol_kernel_launches(n)
    return {"panel_lu": lk.getrf_kernel_launches(n, 256, 1)}


def mixed_main_path(stt, pk, ck, lk, metrics, dtype, gen, dev, direct) -> dict:
    """posv_mixed, posv_mixed_gmres, gesv_mixed and gesv_mixed_gmres at
    n = 16384, nrhs = 512, tiles of 512, default options: info 0, no
    fallback (iters >= 0), scaled residual <= 3, final berr <= the
    policy's tolerance, the factor's launches equal to the mirrors (and
    no other kernel); times (host clock to a synchronize, the counted
    run and a warm one) against the direct driver of phase 3 / 4 and
    cholesky + cholesky_solve / lu_factor + lu_solve.  In float32 the
    pair is the CUDA row's degenerate one: the residual, and iters
    printed."""
    from slate_tpu_torch.refine import policy

    dt = getattr(torch, dtype)
    n, nrhs, nb = N_MAIN, NRHS_MAIN, 512
    tol = policy.default_tolerance(dt, n)
    pol = policy.select(dt, n, backend=dev.type)
    check(pol.factor == "float32", f"{dtype}: the CUDA precision row gives factor {pol.factor}")
    out = {"factor": pol.factor}
    for spd_ in (True, False):
        kind = "posv" if spd_ else "gesv"
        A = spd(n, dt, gen, dev) if spd_ else torch.randn(n, n, generator=gen, device=dev,
                                                          dtype=dt)
        B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
        Am = (stt.HermitianMatrix if spd_ else stt.Matrix).from_global(A, nb)
        Bm = stt.Matrix.from_global(B, nb)
        torch.cuda.synchronize()
        expect = _factor_mirror(ck, lk, spd_, n)
        for gmres in ((False, True) if dtype == "float64" else (False,)):
            routine = f"{kind}_mixed" + ("_gmres" if gmres else "")
            X, info, iters, launches, t, berr = _mixed_run(stt, pk, metrics, routine, Am, Bm)
            r = scaled_residual(A, X, B)
            got = {k: launches[k] for k in expect}
            others = {k: v for k, v in launches.items() if k not in expect and v}
            del X
            t0 = time.perf_counter()
            getattr(stt, routine)(Am, Bm)
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            name = f"{routine} {dtype} n={n} nrhs={nrhs}"
            cyc = f" ({iters // pol.restart} GMRES cycles)" if gmres else ""
            print(f"  {name}: residual {r:.3e}, info {info}, iters {iters}{cyc}, final berr "
                  f"{berr:.3e} (tolerance {tol:.3e}), {t:.4f} s, warm {t_warm:.4f} s "
                  f"({kind} direct, phase {3 if spd_ else 4}: "
                  f"{direct[kind][kind + '_s']:.4f} s), {pol.factor} factor launches {got} "
                  f"(expected {expect})", flush=True)
            check(info == 0, f"{name}: info = {info}")
            check(r <= 3, f"{name}: scaled residual {r:.3f} > 3")
            check(got == expect, f"{name}: launches {got} != {expect}")
            check(not others, f"{name}: other kernels launched: {others}")
            if dtype == "float64":
                check(iters >= 0, f"{name}: the fallback ran (iters = {iters})")
                check(berr is not None and berr <= tol,
                      f"{name}: final berr {berr} > tolerance {tol:.3e}")
            out[routine] = {"residual": r, "iters": iters, "berr": berr, "s": t,
                            "warm_s": t_warm, "launches": got}
        if spd_:
            t_lib = cuda_ms(lambda: torch.cholesky_solve(B, torch.linalg.cholesky(A)), reps=3)
            lib = "cholesky + cholesky_solve"
        else:
            t_lib = cuda_ms(lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor(A), B), reps=3)
            lib = "lu_factor + lu_solve"
        print(f"  {lib} {dtype} n={n} nrhs={nrhs}: {t_lib:.3f} ms", flush=True)
        out[f"{kind}_library_ms"] = t_lib
        del A, B, Am, Bm
        torch.cuda.empty_cache()
    return out


def cond_phase(stt, pk, metrics, gen, dev) -> dict:
    """matgen.cond_matrix operands at n = 4096, nrhs = 4, tiles of 512,
    seeds fixed: cond 1e4 converges in <= 8 IR steps (gesv_mixed and
    posv_mixed); cond 1e9 falls back under default options (iters < 0,
    residual <= MIXED_FALLBACK_BOUND) and gives info != 0 without the
    fallback; at cond 1e7 classical IR stalls and GMRES-IR converges
    (iters > 0).  At cond 1e9 GMRES-IR converges (iters > 0) where
    classical IR stalls at n = 128, tiles of 32: the float32 LU leaves
    about n/6 eigenvalues of the preconditioned operator away from 1,
    fewer than GMRES(30) resolves at n = 128 and far more at n = 4096,
    where its fallback (and at cond 1e8) is checked for its residual
    only; tests/test_torch_refine.py holds both reaches against the JAX
    package's."""
    n, nrhs, nb = 4096, 4, 512
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=torch.float64)
    out = {}

    def make(cond, spd_, n=n, nb=nb):
        t0 = time.perf_counter()
        A = torch.from_numpy(stt.matgen.cond_matrix(n, cond, seed=11, spd=spd_, device=dev))
        t = time.perf_counter() - t0
        print(f"  cond_matrix n={n} cond={cond:.0e} spd={spd_}: {t:.2f} s", flush=True)
        out[f"cond_matrix_{n}_{cond:.0e}_{'spd' if spd_ else 'general'}_s"] = t
        A = A.to(dev)
        return A, (stt.HermitianMatrix if spd_ else stt.Matrix).from_global(A, nb)

    def run(label, A, Am, routine, opts=None):
        Bn = B[:A.shape[0]]
        Bm = stt.Matrix.from_global(Bn, Am.nb)
        X, info, iters, _, t, berr = _mixed_run(stt, pk, metrics, routine, Am, Bm, opts)
        r = scaled_residual(A, X, Bn)
        print(f"  {label}: {routine}{' without fallback' if opts else ''}: iters {iters}, "
              f"info {info}, residual {r:.3e}, final berr {berr:.3e}, {t:.3f} s", flush=True)
        out[f"{label}.{routine}{'.no_fallback' if opts else ''}"] = {
            "iters": iters, "info": info, "residual": r, "berr": berr, "s": t}
        return info, iters, r

    no_fb = {stt.Option.UseFallbackSolver: False}
    for spd_ in (False, True):
        A, Am = make(1e4, spd_)
        routine = "posv_mixed" if spd_ else "gesv_mixed"
        info, iters, r = run("cond 1e4", A, Am, routine)
        check(info == 0 and 0 <= iters <= 8 and r <= 3,
              f"cond 1e4 {routine}: iters {iters}, info {info}, residual {r:.3f}")
    A, Am = make(1e9, False)
    info, iters, r = run("cond 1e9", A, Am, "gesv_mixed")
    check(iters < 0 and info == 0 and r <= MIXED_FALLBACK_BOUND,
          f"cond 1e9 gesv_mixed: no fallback or a bad one (iters {iters}, info {info}, "
          f"residual {r:.3f})")
    info, iters, _ = run("cond 1e9", A, Am, "gesv_mixed", no_fb)
    check(info != 0 and iters >= 0, f"cond 1e9 without fallback: info {info}, iters {iters}")
    info, iters, r = run("cond 1e9", A, Am, "gesv_mixed_gmres")
    check(info == 0 and r <= MIXED_FALLBACK_BOUND,
          f"cond 1e9 gesv_mixed_gmres: info {info}, residual {r:.3f}")
    A, Am = make(1e8, False)
    info, iters, r = run("cond 1e8", A, Am, "gesv_mixed_gmres")
    check(info == 0 and r <= MIXED_FALLBACK_BOUND,
          f"cond 1e8 gesv_mixed_gmres: info {info}, residual {r:.3f}")
    A, Am = make(1e7, False)
    info, iters, _ = run("cond 1e7", A, Am, "gesv_mixed", no_fb)
    check(info != 0, f"cond 1e7: classical IR converged (iters {iters})")
    info, iters, r = run("cond 1e7", A, Am, "gesv_mixed_gmres")
    check(info == 0 and iters > 0 and r <= 3,
          f"cond 1e7 gesv_mixed_gmres: iters {iters}, info {info}, residual {r:.3f}")
    A, Am = make(1e9, False, n=128, nb=32)
    info, iters, _ = run("n 128 cond 1e9", A, Am, "gesv_mixed", no_fb)
    check(info != 0, f"n 128 cond 1e9: classical IR converged (iters {iters})")
    info, iters, r = run("n 128 cond 1e9", A, Am, "gesv_mixed_gmres", no_fb)
    check(info == 0 and iters > 0 and r <= 3,
          f"n 128 cond 1e9 gesv_mixed_gmres: iters {iters}, info {info}, residual {r:.3f}")
    return out


def matgen_phase(stt, dev) -> dict:
    """generate_matrix("rand") and ("randn") of a 16384^2 float64 Matrix
    in tiles of 512 and of 256: the two tilings bitwise equal, rand
    bitwise equal to philox.random_np at 4096 sampled (i, j); timed."""
    from slate_tpu_torch.matgen import philox

    n, seed = N_MAIN, 2026
    out = {}
    rng = np.random.default_rng(5)
    i, j = rng.integers(0, n, 4096), rng.integers(0, n, 4096)
    for kind in ("rand", "randn"):
        G = {}
        for nb in (512, 256):
            M = stt.Matrix.zeros(n, n, nb, dtype=torch.float64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            A, _ = stt.generate_matrix(kind, M, seed=seed)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            G[nb] = A.to_global()
            out[f"{kind}.tiles_{nb}_s"] = t
            del M, A
        same = bool(torch.equal(G[512], G[256]))
        msg = ""
        if kind == "rand":
            got = G[512][torch.from_numpy(i).to(dev), torch.from_numpy(j).to(dev)].cpu().numpy()
            ref = philox.random_np("uniform", seed, i, j, np.float64)
            check(np.array_equal(got, ref), "generate_matrix rand: differs from random_np")
            msg = ", 4096 sampled (i, j) bitwise equal to random_np"
        print(f"  generate_matrix {kind} float64 n={n}: tiles of 512 "
              f"{out[kind + '.tiles_512_s']:.3f} s, of 256 {out[kind + '.tiles_256_s']:.3f} s, "
              f"the tilings bitwise equal {same}{msg}", flush=True)
        check(same, f"generate_matrix {kind}: the tilings differ")
        out[f"{kind}.tilings_bitwise_equal"] = same
        del G
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 13: the serve path
# ---------------------------------------------------------------------------

N_SERVE, NRHS_SERVE, SERVE_BATCH = 4096, 16, 8


def _serve_runs(metrics, label: str) -> int:
    """Dispatches of one bucket so far: its warm-run timer counts."""
    return sum(int(v["count"]) for k, v in metrics.timers().items()
               if k.startswith(f"serve.{label}.b") and k.endswith(".run"))


def _serve_latency(d, label: str) -> dict:
    """p50 / p99 (ms) of the window's queued / execute / total histograms."""
    out = {}
    for part in ("queued", "execute", "total"):
        h = d.hist(f"serve.latency.{label}.{part}")
        out[part] = None if h is None else {
            "count": h["count"], "p50_ms": h["p50"] * 1e3, "p99_ms": h["p99"] * 1e3}
    return out


def _host_s(fn, reps: int = 3) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _serve_faults(faults, svc, routine, A_np, B_np, A, B, residual, dtype) -> dict:
    """result_corrupt once and factor_stale once on the hit path: each is
    still delivered with a correct X, and counted once."""
    from slate_tpu_torch.aux import metrics

    out = {}
    for site, counter in (("result_corrupt", "serve.corrupt_result"),
                          ("factor_stale", "serve.factor_cache.stale")):
        faults.arm(site, once=True)
        faults.on()
        with metrics.deltas() as d:
            X = svc.submit(routine, A_np, B_np).result(timeout=600)
            fired, counted = d.get(f"faults.injected.{site}"), d.get(counter)
        faults.reset()
        r = residual(A, torch.from_numpy(X).to(A.device), B)
        print(f"  {routine} {dtype} {site}: fired {fired}, {counter} {counted}, "
              f"residual {r:.3e}", flush=True)
        check(fired == 1 and counted == 1, f"serve {routine} {dtype} {site}: fired {fired}, "
              f"{counter} {counted} (expected 1 each)")
        check(r <= 3, f"serve {routine} {dtype} {site}: residual {r:.3f} > 3")
        out[site] = {"counted": counted, "residual": r}
    return out


HITS13 = 24  # requests of each hit stream


def serve_hit_stream(serve, faults, pk, ck, lk, metrics, routine, dtype, gen, dev) -> dict:
    """One factor-cache miss, warmup(), then ``HITS13`` requests of nrhs = 16
    over 8 distinct B through SolverService on cuda:0 (posv on X X^T + n I,
    gesv on a normal A + 2 sqrt(n) I, n = 4096: bucket 4096, tiles of
    64): the miss launches the factor's mirror, the window is all hits
    with no cold build and launches only the trsm pair, one sweep a
    dispatch each."""
    dt = getattr(torch, dtype)
    n, nrhs = N_SERVE, NRHS_SERVE
    if routine == "posv":
        A = spd(n, dt, gen, dev)
    else:
        A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
        A.diagonal().add_(2 * n**0.5)
    Bs = [torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt) for _ in range(8)]
    A_np, B_np = A.cpu().numpy(), [B.cpu().numpy() for B in Bs]
    skey = serve.bucket_for(routine, n, n, nrhs, A_np.dtype).solve_sibling()
    sweep = pk.trsm_kernel_launches(n)
    svc = serve.SolverService(factor_cache=serve.FactorCache(max_entries=8),
                              batch_max=SERVE_BATCH, batch_window_s=0.002)
    try:
        pk.reset_launches()  # counts of the miss only
        with metrics.deltas() as d:
            X0 = svc.submit(routine, A_np, B_np[0]).result(timeout=600)
            check(d.get("serve.factor_cache.miss") == 1, f"serve {routine} {dtype}: no miss")
        miss = {k: v for k, v in pk.LAUNCHES.items() if v}
        expect = {**{k: v for k, v in _factor_mirror(ck, lk, routine == "posv", n).items()
                     if v}, "trsm_lower": sweep, "trsm_upper": sweep}
        check(miss == expect, f"serve {routine} {dtype} miss: launches {miss} != {expect}")
        check(scaled_residual(A, torch.from_numpy(X0).to(dev), Bs[0]) <= 3,
              f"serve {routine} {dtype}: the miss's residual > 3")
        t0 = time.perf_counter()
        built = svc.warmup()
        t_warm = time.perf_counter() - t0
        runs0 = _serve_runs(metrics, skey.label)
        pk.reset_launches()  # counts of the hit stream only
        with metrics.deltas() as d:
            t0 = time.perf_counter()
            futs = [svc.submit(routine, A_np, B_np[i % 8]) for i in range(HITS13)]
            Xs = [f.result(timeout=600) for f in futs]
            t_stream = time.perf_counter() - t0
            hits, cold = d.get("serve.factor_cache.hit"), d.get("jit.compilations")
            lat = _serve_latency(d, skey.label)
            batched = d.get("serve.batched")
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        dispatches = _serve_runs(metrics, skey.label) - runs0
        res = max(scaled_residual(A, torch.from_numpy(X).to(dev), Bs[i % 8])
                  for i, X in enumerate(Xs))
        print(f"  {routine} {dtype} hit stream: {HITS13} requests in {t_stream:.3f} s = "
              f"{HITS13 / t_stream:.1f} requests/s, hits {hits}, cold builds {cold} (warmup built "
              f"{built} in {t_warm:.3f} s), {dispatches} dispatches ({batched} batched), "
              f"launches {launches}, max residual {res:.3e}", flush=True)
        print(f"  {routine} {dtype} latency (ms) {skey.label}: " + ", ".join(
            f"{p} p50 {v['p50_ms']:.3f} p99 {v['p99_ms']:.3f}" for p, v in lat.items() if v),
            flush=True)
        check(hits == HITS13, f"serve {routine} {dtype}: {hits} hits, expected {HITS13}")
        check(cold == 0, f"serve {routine} {dtype}: {cold} cold builds after warmup()")
        check(launches == {"trsm_lower": sweep * dispatches, "trsm_upper": sweep * dispatches},
              f"serve {routine} {dtype}: hit launches {launches}, expected the trsm pair "
              f"{sweep} x {dispatches} dispatches each")
        check(res <= 3, f"serve {routine} {dtype}: hit residual {res:.3f} > 3")

        # one hit dispatch (the core, no host copy) against two library
        # solves on the same factor and the concatenated right sides
        entry = svc.factor_cache.get(serve.matrix_fingerprint(A_np, routine))
        F = entry.factor
        Bb = torch.stack([torch.nn.functional.pad(B, (0, skey.nrhs - nrhs)) for B in Bs])
        if entry.perm is not None:
            Bb = Bb[:, entry.perm]
        exe = svc.cache.executable(skey, SERVE_BATCH)
        Bcat = Bb.permute(1, 0, 2).reshape(n, -1)
        unit = routine == "gesv"  # packed LU: unit L below, U on and above
        U = F if unit else F.mT
        t_hit = cuda_ms(lambda: exe(F, Bb), reps=5)
        t_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
            U, torch.linalg.solve_triangular(F, Bcat, upper=False, unitriangular=unit),
            upper=True), reps=5)
        X = Xs[0]
        t_fp = _host_s(lambda: serve.matrix_fingerprint(A_np, routine))
        from slate_tpu_torch.serve import factor_cache as sfc

        t_res = _host_s(lambda: sfc.residual_ok(A_np, B_np[0], X, routine))
        t_val = _host_s(lambda: bool(np.isfinite(A_np).all()))
        print(f"  {routine} {dtype} hit dispatch (b{SERVE_BATCH}, {n} x {Bcat.shape[1]}): "
              f"{t_hit:.3f} ms, two solve_triangular {t_lib:.3f} ms; host a request: "
              f"matrix_fingerprint {t_fp * 1e3:.1f} ms, residual_ok {t_res * 1e3:.1f} ms, "
              f"finiteness check {t_val * 1e3:.1f} ms", flush=True)
        # the device's idle share over a second stream of 8 hits, in a
        # profiler trace (device time of every kernel and copy / wall)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in [svc.submit(routine, A_np, B_np[i % 8]) for i in range(8)]:
                f.result(timeout=600)
            t_prof = time.perf_counter() - t0
        busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e6
        idle = max(0.0, 1 - busy / t_prof)
        print(f"  {routine} {dtype} profiled hit stream: device busy {busy * 1e3:.3f} ms of "
              f"{t_prof:.3f} s (idle share {idle:.4f})", flush=True)
        flt = _serve_faults(faults, svc, routine, A_np, B_np[1], A, Bs[1], scaled_residual,
                            dtype)
    finally:
        svc.stop()
    return {"requests_per_s": 40 / t_stream, "stream_s": t_stream, "hits": hits,
            "cold_builds": cold, "dispatches": dispatches, "launches": launches,
            "miss_launches": miss, "max_residual": res, "latency": lat,
            "hit_dispatch_ms": t_hit, "two_library_solves_ms": t_lib,
            "fingerprint_host_ms": t_fp * 1e3, "residual_ok_host_ms": t_res * 1e3,
            "finite_check_host_ms": t_val * 1e3, "warmup_s": t_warm,
            "profiled_busy_ms": busy * 1e3, "profiled_wall_s": t_prof, "idle_share": idle,
            "faults": flt}


def serve_gels_stream(serve, pk, qf, metrics, dtype, gen, dev) -> dict:
    """A normal tall A at (8192, 4096) -> bucket (8192, 4096): one miss
    factors through gels_factor_pack (larft launches as the
    geqrf_kernel_launches mirror), then 12 requests of nrhs = 16 hit
    through gels_solve_from_global (no kernel: reflectors and one library
    solve, as in the JAX package)."""
    dt = getattr(torch, dtype)
    m, n, nrhs = 2 * N_SERVE, N_SERVE, NRHS_SERVE
    A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
    Bs = [torch.randn(m, nrhs, generator=gen, device=dev, dtype=dt) for _ in range(4)]
    A_np, B_np = A.cpu().numpy(), [B.cpu().numpy() for B in Bs]
    key = serve.bucket_for("gels", m, n, nrhs, A_np.dtype)
    check((key.m, key.n) == (m, n), f"gels bucket {key.label}")
    svc = serve.SolverService(factor_cache=serve.FactorCache(max_entries=4),
                              batch_max=SERVE_BATCH, batch_window_s=0.002)
    try:
        pk.reset_launches()  # counts of the miss only
        t0 = time.perf_counter()
        X0 = svc.submit("gels", A_np, B_np[0]).result(timeout=900)
        t_miss = time.perf_counter() - t0
        miss = {k: v for k, v in pk.LAUNCHES.items() if v}
        expect = qf.geqrf_kernel_launches(n, NB_SWITCH)
        check(miss == {"larft": expect}, f"serve gels {dtype} miss: launches {miss}, "
              f"expected larft {expect}")
        svc.warmup()
        pk.reset_launches()  # counts of the hit stream only
        with metrics.deltas() as d:
            t0 = time.perf_counter()
            futs = [svc.submit("gels", A_np, B_np[i % 4]) for i in range(12)]
            Xs = [f.result(timeout=600) for f in futs]
            t_stream = time.perf_counter() - t0
            hits, cold = d.get("serve.factor_cache.hit"), d.get("jit.compilations")
            lat = _serve_latency(d, key.solve_sibling().label)
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        pairs = [(X0, Bs[0])] + [(X, Bs[i % 4]) for i, X in enumerate(Xs)]
        res = max(ls_residual(A, torch.from_numpy(X).to(dev), B) for X, B in pairs)
        t_fp = _host_s(lambda: serve.matrix_fingerprint(A_np, "gels"))
        from slate_tpu_torch.serve import factor_cache as sfc

        t_res = _host_s(lambda: sfc.residual_ok(A_np, B_np[0], Xs[0], "gels"))
        print(f"  gels {dtype} ({m}, {n}): miss {t_miss:.3f} s, larft launches "
              f"{miss.get('larft')} (expected {expect}); 12 hits in {t_stream:.3f} s = "
              f"{12 / t_stream:.1f} requests/s, hits {hits}, cold builds {cold}, hit "
              f"launches {launches}, max normal-equations residual {res:.3e}; host a "
              f"request: matrix_fingerprint {t_fp * 1e3:.1f} ms, residual_ok "
              f"{t_res * 1e3:.1f} ms", flush=True)
        check(hits == 12 and cold == 0, f"serve gels {dtype}: hits {hits}, cold builds {cold}")
        check(launches == {}, f"serve gels {dtype}: the hit path launched {launches}")
        check(res <= 3, f"serve gels {dtype}: residual {res:.3f} > 3")
        entry = svc.factor_cache.get(serve.matrix_fingerprint(A_np, "gels"))
        skey = key.solve_sibling()
        exe = svc.cache.executable(skey, SERVE_BATCH)
        Bb = torch.stack([Bs[i % 4] for i in range(SERVE_BATCH)])
        t_hit = cuda_ms(lambda: exe(entry.factor, Bb), reps=3)
        fq, tau = torch.geqrf(A)
        Bcat = Bb.permute(1, 0, 2).reshape(m, -1)
        t_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
            fq[:n, :n], torch.ormqr(fq, tau, Bcat, left=True, transpose=True)[:n],
            upper=True), reps=3)
        del fq, tau
        print(f"  gels {dtype} hit dispatch (b{SERVE_BATCH}, {m} x {Bcat.shape[1]}): "
              f"{t_hit:.3f} ms, torch.ormqr + solve_triangular {t_lib:.3f} ms", flush=True)
    finally:
        svc.stop()
    return {"miss_s": t_miss, "miss_launches": miss, "requests_per_s": 12 / t_stream,
            "hits": hits, "cold_builds": cold, "max_residual": res, "latency": lat,
            "hit_dispatch_ms": t_hit, "ormqr_solve_lib_ms": t_lib,
            "fingerprint_host_ms": t_fp * 1e3, "residual_ok_host_ms": t_res * 1e3}


def serve_full_stream(stt, serve, pk, ck, metrics, dtype, gen, dev) -> dict:
    """Factor cache off: 24 interleaved gesv and posv requests, n in
    {1500, 2600, 3900} (buckets 2048 / 4096 / 4096, identity pad),
    submitted to a paused service and then served: coalesced batches,
    the posv bucket at 2048 on the kernel family, every residual <= 3."""
    dt = getattr(torch, dtype)
    check(ck.resolve_schedule(2048, dt, "auto", dev) == "pallas",
          "Schedule.Auto does not take the kernel family at the 2048 bucket")
    reqs = []
    for i in range(24):
        n = (1500, 2600, 3900)[i % 3]
        routine = ("gesv", "posv")[i % 2]
        if routine == "posv":
            A = spd(n, dt, gen, dev)
        else:
            A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
            A.diagonal().add_(2 * n**0.5)
        B = torch.randn(n, NRHS_SERVE, generator=gen, device=dev, dtype=dt)
        reqs.append((routine, A, B, A.cpu().numpy(), B.cpu().numpy()))
    svc = serve.SolverService(factor_cache=False, batch_max=SERVE_BATCH,
                              batch_window_s=0.002, start=False)
    try:
        pk.reset_launches()  # counts of this stream only
        with metrics.deltas() as d:
            futs = [svc.submit(r, a, b) for r, _, _, a, b in reqs]
            t0 = time.perf_counter()
            svc.start()
            Xs = [f.result(timeout=900) for f in futs]
            t_stream = time.perf_counter() - t0
            batched, pads, cold = (d.get("serve.batched"), d.get("serve.batch_pad"),
                                   d.get("jit.compilations"))
            lat = {lbl: _serve_latency(d, lbl) for lbl in sorted(
                {serve.bucket_for(r, a.shape[0], a.shape[0], NRHS_SERVE, a.dtype).label
                 for r, _, _, a, _ in reqs})}
    finally:
        svc.stop()
    launches = {k: v for k, v in pk.LAUNCHES.items() if v}
    res = max(scaled_residual(A, torch.from_numpy(X).to(dev), B)
              for (_, A, B, _, _), X in zip(reqs, Xs))
    print(f"  full-phase stream {dtype}: 24 requests in {t_stream:.3f} s = "
          f"{24 / t_stream:.1f} requests/s, batched {batched}, repeat pads {pads}, cold "
          f"builds {cold}, launches {launches}, max residual {res:.3e}", flush=True)
    for lbl, v in lat.items():
        print(f"  {dtype} latency (ms) {lbl}: " + ", ".join(
            f"{p} p50 {x['p50_ms']:.1f} p99 {x['p99_ms']:.1f}" for p, x in v.items() if x),
            flush=True)
    # the 4096 bucket's tiling (4096 tiles of 64): what building the
    # tiles and reading them back costs a full-phase item
    A4 = reqs[2][1]  # n = 3900: the 4096 bucket
    Ap = torch.nn.functional.pad(A4, (0, 4096 - A4.shape[1], 0, 4096 - A4.shape[0]))
    M = stt.Matrix.from_global(Ap, 64)
    t_from = cuda_ms(lambda: stt.Matrix.from_global(Ap, 64), reps=5)
    t_to = cuda_ms(lambda: M.to_global(), reps=5)
    del M, Ap
    print(f"  {dtype} tiles of 64 at the 4096 bucket: from_global {t_from:.3f} ms, "
          f"to_global {t_to:.3f} ms", flush=True)
    check(batched > 0, f"serve full-phase {dtype}: nothing coalesced")
    check(launches.get("chol_base", 0) > 0 and launches.get("panel_lu", 0) > 0,
          f"serve full-phase {dtype}: launches {launches} miss the kernel family")
    check(res <= 3, f"serve full-phase {dtype}: residual {res:.3f} > 3")
    return {"requests_per_s": 24 / t_stream, "stream_s": t_stream, "batched": batched,
            "batch_pad": pads, "cold_builds": cold, "launches": launches,
            "max_residual": res, "latency": lat, "from_global_4096_nb64_ms": t_from,
            "to_global_4096_nb64_ms": t_to}


# ---------------------------------------------------------------------------
# phase 17: restore, replicas and integrity
# ---------------------------------------------------------------------------

SERVE17_BATCH = 4
STREAM17 = 12  # requests of phase 17's replica and integrity streams

# A fresh interpreter of the port alone: restore a two-lane service from
# the store (argv: manifest, store, n, nrhs, batch point, requests), then
# serve a float64 stream of that many requests; one JSON line out.
_RESTORE_CHILD = r"""
import json, sys, time
t_start = time.perf_counter()
import numpy as np, torch
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import ExecutableCache, PlacementPolicy, SolverService

man, store, n, nrhs, bm, count = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:7])
metrics.on()
dev = torch.device("cuda:0")
t0 = time.perf_counter()
svc = SolverService(cache=ExecutableCache(manifest_path=man, artifact_dir=store),
                    placement=PlacementPolicy(replicas=2), factor_cache=False,
                    batch_max=bm, batch_window_s=0.002)
ready = svc.wait_ready(600)
t_restore = time.perf_counter() - t0
restore = svc.health()["restore"]
gen = torch.Generator(device=dev)
gen.manual_seed(17)
ops = []
for i in range(4):
    G = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    if i % 2:
        A = G @ G.T
        A.diagonal().add_(n)
    else:
        A = G
        A.diagonal().add_(2 * n ** 0.5)
    ops.append((("gesv", "posv")[i % 2], A))
Bs = [torch.randn(n, nrhs, generator=gen, device=dev, dtype=torch.float64) for _ in range(5)]
ops_np = [(r, A.cpu().numpy()) for r, A in ops]
Bs_np = [B.cpu().numpy() for B in Bs]
with metrics.deltas() as d:
    t1 = time.perf_counter()
    futs = [svc.submit(ops_np[i % 4][0], ops_np[i % 4][1], Bs_np[i % 5]) for i in range(count)]
    Xs = [f.result(timeout=600) for f in futs]
    t_stream = time.perf_counter() - t1
    cold = d.get("jit.compilations")
    lanes = {r: d.get(f"serve.replica.{r}.dispatched") for r in ("0", "1")}
n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))
res = max(n1(ops[i % 4][1] @ torch.from_numpy(X).to(dev) - Bs[i % 5])
          / (n1(ops[i % 4][1]) * n1(torch.from_numpy(X)) * n * torch.finfo(torch.float64).eps)
          for i, X in enumerate(Xs))
svc.stop()
print(json.dumps({
    "ready": ready, "restore": restore, "restore_s": t_restore,
    "process_to_ready_s": t0 - t_start + t_restore, "cold_builds": cold, "lanes": lanes,
    "requests": count, "stream_s": t_stream, "requests_per_s": count / t_stream,
    "max_residual": res,
    "nvcc_runs": pk.NVCC_RUNS, "loaded_from": str(pk.LOADED_FROM),
    "artifact": {k: v for k, v in metrics.counters().items()
                 if k.startswith("serve.artifact_")},
    "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slate_tpu"))}))
"""


def _restore_child(man: str, store: str, label: str, count: int = 20) -> dict:
    """Run _RESTORE_CHILD in a fresh interpreter with no nvcc on its PATH
    and no CUDA_HOME, so a kernel build there could only fail."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here, "CUDA_HOME": "/nonexistent",
           "PATH": os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                                   if "cuda" not in p.lower())}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _RESTORE_CHILD, man, store, str(N_SERVE),
                          str(NRHS_SERVE), str(SERVE17_BATCH), str(count)], cwd=here, env=env,
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"restore child ({label}) exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["process_wall_s"] = wall
    return got


def _ops(n, dt, gen, dev, count=4):
    """``count`` operands, gesv and posv alternating (host numpy too)."""
    out = []
    for i in range(count):
        routine = ("gesv", "posv")[i % 2]
        if routine == "posv":
            A = spd(n, dt, gen, dev)
        else:
            A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
            A.diagonal().add_(2 * n**0.5)
        out.append((routine, A, A.cpu().numpy()))
    return out


def _rhs(n, dt, gen, dev, count=5):
    Bs = [torch.randn(n, NRHS_SERVE, generator=gen, device=dev, dtype=dt) for _ in range(count)]
    return Bs, [B.cpu().numpy() for B in Bs]


def _idle(svc, timeout: float = 120.0) -> None:
    """Wait until every lane is empty and idle (a hedge twin that lost
    may still be running after its request was delivered)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        with svc._cond:
            if all(not r.q and not r.inflight for r in svc._replicas):
                return
        time.sleep(0.005)
    fail("serve lanes never went idle")


def _stream(svc, ops, Bs, Bs_np, count, dev):
    """``count`` requests over the operands and right sides, submitted at
    once; returns (seconds, max scaled residual)."""
    t0 = time.perf_counter()
    futs = [svc.submit(ops[i % len(ops)][0], ops[i % len(ops)][2], Bs_np[i % len(Bs)])
            for i in range(count)]
    Xs = [f.result(timeout=900) for f in futs]
    dt = time.perf_counter() - t0
    res = max(scaled_residual(ops[i % len(ops)][1], torch.from_numpy(X).to(dev),
                              Bs[i % len(Bs)]) for i, X in enumerate(Xs))
    return dt, res


def cold_start_leg(serve, faults, metrics, dev, gen, t_build) -> dict:
    """(a) float64: warm a two-lane service with a store, restore it in a
    fresh interpreter, then here with one flipped byte, and arm each
    artifact site once."""
    import os
    import tempfile

    from slate_tpu_torch.serve import artifacts as sart

    n, bm = N_SERVE, SERVE17_BATCH
    dt = torch.float64
    with tempfile.TemporaryDirectory() as tmp:
        man, store = os.path.join(tmp, "m.json"), os.path.join(tmp, "store")
        ops = _ops(n, dt, gen, dev, 2)
        Bs, Bs_np = _rhs(n, dt, gen, dev, 2)
        svc = serve.SolverService(cache=serve.ExecutableCache(manifest_path=man,
                                                              artifact_dir=store),
                                  replicas=2, factor_cache=False, batch_max=bm,
                                  batch_window_s=0.002)
        try:
            t0 = time.perf_counter()
            for (routine, A, A_np), B, B_np in zip(ops, Bs, Bs_np):
                X = svc.submit(routine, A_np, B_np).result(timeout=900)
                check(scaled_residual(A, torch.from_numpy(X).to(dev), B) <= 3,
                      f"restore warm {routine}: residual > 3")
            svc.warmup()
            t_warm = time.perf_counter() - t0
        finally:
            svc.stop()
        st = sart.ArtifactStore(store)
        keys = [(serve.bucket_for(r, n, n, NRHS_SERVE, np.float64), b)
                for r in ("gesv", "posv") for b in (1, bm)]
        check(len(st.entries()) == 4, f"store holds {len(st.entries())} entries, expected 4")
        kdir = st.kernels_dir()
        from slate_tpu_torch.ops.hopper import panel_kernels as pk

        libs = sorted(p.name for p in pk.check_copy(kdir, pk.library_digest()))
        check(libs == sorted(pk.library_names()), f"store kernels {libs}")
        clean = _restore_child(man, store, "clean")
        print(f"  cold start (fresh interpreter, 2 lanes on cuda:0): ready "
              f"{clean['ready']}, restore {clean['restore']} in {clean['restore_s']:.3f} s "
              f"({clean['process_to_ready_s']:.3f} s from interpreter start; phase 1 built "
              f"the library in {t_build:.2f} s, warming the store took {t_warm:.3f} s), "
              f"nvcc runs {clean['nvcc_runs']}, library from {clean['loaded_from']}; "
              f"20-request stream {clean['stream_s']:.3f} s = "
              f"{clean['requests_per_s']:.2f} requests/s, cold builds {clean['cold_builds']}, "
              f"lanes {clean['lanes']}, max residual {clean['max_residual']:.3e}", flush=True)
        check(clean["ready"], "restore child: wait_ready() False")
        check(clean["restore"] == {"entries": 4, "restored": 4, "compiled": 0, "failed": 0,
                                   "skipped": 0}, f"restore child: {clean['restore']}")
        check(clean["nvcc_runs"] == 0, "restore child ran nvcc")
        check(clean["loaded_from"].startswith(st.root), "restore child: the library was "
              f"opened from {clean['loaded_from']}, not the store")
        check(clean["cold_builds"] == 0, f"restore child: {clean['cold_builds']} cold builds")
        check(clean["max_residual"] <= 3, "restore child: residual > 3")
        check(clean["jax_modules"] == [], f"restore child imported {clean['jax_modules']}")
        # one flipped byte in one stored kernel library: its sha256 fails
        # before any CDLL, so a second fresh interpreter opens the build's
        # library, rebuilds the entry and rewrites the store's copy
        so = os.path.join(kdir, pk.library_names()[0])
        with open(so, "rb") as f:
            blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0x01
        with open(so, "wb") as f:
            f.write(blob)
        try:
            pk.check_copy(kdir, pk.library_digest())
            fail("a flipped byte in a stored kernel library passed its sha256")
        except pk.LibraryCorrupt:
            pass
        lib = _restore_child(man, store, "library byte", 4)
        art = lib["artifact"]
        print(f"  flipped byte in {os.path.basename(so)} (fresh interpreter): restore "
              f"{lib['restore']}, serve.artifact_corrupt {art.get('serve.artifact_corrupt')}, "
              f"hits {art.get('serve.artifact_hit')}, nvcc runs {lib['nvcc_runs']}, library "
              f"from {lib['loaded_from']}; {lib['requests']} requests after it, cold builds "
              f"{lib['cold_builds']}, max residual {lib['max_residual']:.3e}", flush=True)
        check(lib["ready"] and lib["restore"]["restored"] == 3
              and lib["restore"]["compiled"] == 1 and art.get("serve.artifact_corrupt") == 1,
              f"library byte: restore {lib['restore']}, counters {art}")
        check(not lib["loaded_from"].startswith(st.root), "library byte: the flipped copy "
              f"was opened ({lib['loaded_from']})")
        check(lib["cold_builds"] == 0 and lib["max_residual"] <= 3,
              f"library byte: cold builds {lib['cold_builds']}, residual {lib['max_residual']}")
        check(len(pk.check_copy(kdir, pk.library_digest())) == len(pk.library_names()),
              "library byte: the store's copy was not rewritten")
        # one flipped byte in one artifact: counted, rebuilt, re-saved
        key, b = keys[1]
        path = st.path_for(key, b)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(sart.ArtifactStore._flip_byte(blob))
        svc = serve.SolverService(cache=serve.ExecutableCache(manifest_path=man,
                                                              artifact_dir=store),
                                  replicas=2, factor_cache=False, batch_max=bm,
                                  batch_window_s=0.002)
        try:
            with metrics.deltas() as d:
                check(svc.wait_ready(600), "flipped byte: wait_ready() False")
                got = svc.health()["restore"]
                corrupt = d.get("serve.artifact_corrupt")
                _t, res = _stream(svc, ops, Bs, Bs_np, 4, dev)
        finally:
            svc.stop()
        flipped = {"restore": got, "corrupt": corrupt, "max_residual": res}
        print(f"  flipped byte in {os.path.basename(path)}: restore {got}, "
              f"serve.artifact_corrupt {corrupt}; 4 requests after it, max residual "
              f"{res:.3e}", flush=True)
        check(corrupt == 1, f"flipped byte: serve.artifact_corrupt {corrupt}")
        check(got["restored"] == 3 and got["compiled"] == 1, f"flipped byte: restore {got}")
        check(res <= 3, "flipped byte: residual > 3")
        with metrics.deltas() as d:
            healed = sart.ArtifactStore(store).load(key, b, dev)
            check(healed and d.get("serve.artifact_hit") == 1,
                  "the flipped artifact was not re-saved clean")
        sites = {}
        for site, rung in (("artifact_corrupt", "corrupt"), ("artifact_stale", "stale"),
                           ("artifact_load_fail", "load_fail")):
            c = serve.ExecutableCache(manifest_path=man, artifact_dir=store)
            faults.arm(site, once=True)
            faults.on()
            with metrics.deltas() as d:
                got = c.restore(batch_max=1, devices=[dev])
                fired, counted = d.get(f"faults.injected.{site}"), d.get(f"serve.artifact_{rung}")
            faults.reset()
            check(fired == 1 and counted == 1 and got["restored"] == 1 and got["compiled"] == 1,
                  f"{site}: fired {fired}, serve.artifact_{rung} {counted}, restore {got}")
            sites[site] = {"fired": fired, "counted": counted, "restore": got}
        print("  artifact sites armed once each (restore of the b1 entries): " + "; ".join(
            f"{s}: fired {v['fired']}, counted {v['counted']}, restore {v['restore']}"
            for s, v in sites.items()), flush=True)
    return {"build_s": t_build, "warm_store_s": t_warm, "clean": clean,
            "library_byte": lib, "flipped": flipped, "sites": sites}


def replica_leg(serve, metrics, dtype, gen, dev) -> dict:
    """(b) replicas=2 on cuda:0: a factor-cache hit stream, a full-phase
    stream, add_replica (warm, no cold build on traffic) and
    remove_replica (its queue re-homed, nothing lost)."""
    dt = getattr(torch, dtype)
    n, bm = N_SERVE, SERVE17_BATCH
    ops = _ops(n, dt, gen, dev)
    Bs, Bs_np = _rhs(n, dt, gen, dev)
    out = {}
    svc = serve.SolverService(replicas=2, factor_cache=serve.FactorCache(max_entries=4),
                              batch_max=bm, batch_window_s=0.002)
    try:
        svc.submit("gesv", ops[0][2], Bs_np[0]).result(timeout=900)  # the miss
        svc.warmup()
        with metrics.deltas() as d:
            t, res = _stream(svc, ops[:1], Bs, Bs_np, STREAM17, dev)
            lanes = {r: d.get(f"serve.replica.{r}.dispatched") for r in ("0", "1")}
            hits, cold = d.get("serve.factor_cache.hit"), d.get("jit.compilations")
        print(f"  replicas {dtype} hit stream: {STREAM17} in {t:.3f} s = {STREAM17 / t:.2f} "
              f"requests/s, "
              f"hits {hits}, cold builds {cold}, dispatched a lane {lanes}, max residual "
              f"{res:.3e}", flush=True)
        check(hits == STREAM17 and cold == 0 and res <= 3, f"replicas {dtype} hit stream")
        out["hit_stream"] = {"requests_per_s": STREAM17 / t, "lanes": lanes,
                             "max_residual": res}
    finally:
        svc.stop()
    svc = serve.SolverService(replicas=2, factor_cache=False, batch_max=bm,
                              batch_window_s=0.002)
    try:
        for routine, _A, A_np in ops[:2]:
            svc.submit(routine, A_np, Bs_np[0]).result(timeout=900)
        svc.warmup()
        with metrics.deltas() as d:
            t, res = _stream(svc, ops, Bs, Bs_np, 12, dev)
            lanes = {r: d.get(f"serve.replica.{r}.dispatched") for r in ("0", "1")}
            cold = d.get("jit.compilations")
        print(f"  replicas {dtype} full-phase stream: 12 in {t:.3f} s = {12 / t:.2f} "
              f"requests/s, cold builds {cold}, dispatched a lane {lanes}, max residual "
              f"{res:.3e}", flush=True)
        check(all(v > 0 for v in lanes.values()) and cold == 0 and res <= 3,
              f"replicas {dtype} full-phase stream: lanes {lanes}, cold {cold}")
        out["full_stream"] = {"requests_per_s": 12 / t, "lanes": lanes, "max_residual": res}
        with metrics.deltas() as d:
            t0 = time.perf_counter()
            name = svc.add_replica()
            t_add = time.perf_counter() - t0
            t, res = _stream(svc, ops, Bs, Bs_np, 12, dev)
            cold = d.get("jit.compilations")
            new = d.get(f"serve.replica.{name}.dispatched")
        print(f"  add_replica {dtype}: lane {name} in {t_add:.3f} s, then 12 in {t:.3f} s, "
              f"cold builds {cold}, the new lane dispatched {new}, max residual {res:.3e}",
              flush=True)
        check(cold == 0 and new > 0 and res <= 3, f"add_replica {dtype}: cold {cold}, new {new}")
        with metrics.deltas() as d:
            futs = [svc.submit(ops[i % 4][0], ops[i % 4][2], Bs_np[i % 5]) for i in range(12)]
            removed = svc.remove_replica(name)
            Xs = [f.result(timeout=900) for f in futs]
            moved = d.get("scale.requests_rehomed")
        res = max(scaled_residual(ops[i % 4][1], torch.from_numpy(X).to(dev), Bs[i % 5])
                  for i, X in enumerate(Xs))
        rows = {r["name"]: r["state"] for r in svc.health()["replicas"]}
        print(f"  remove_replica {dtype}: lane {removed} removed with {moved} requests "
              f"re-homed, 12 of 12 delivered, lanes {rows}, max residual {res:.3e}", flush=True)
        check(len(Xs) == 12 and res <= 3 and rows.get(name) == "removed",
              f"remove_replica {dtype}: rows {rows}")
        out["add_remove"] = {"add_s": t_add, "rehomed": moved, "max_residual": res}
    finally:
        svc.stop()
    return out


def _abft_mirror(ck, lk, routine, n, items) -> dict:
    """The kernel launches of ``items`` full-phase (ABFT) cores at bucket
    n: the factor's mirror.  The drivers' own solves (``getrs``,
    ``potrs`` through ``blas3.trsm``) are library triangular solves, as
    in the JAX package; the trsm pair runs on the solve-phase (hit)
    buckets."""
    one = (ck.chol_kernel_launches(n) if routine == "posv"
           else {"panel_lu": lk.getrf_kernel_launches(n, 256, 1)})
    return {k: v * items for k, v in one.items() if v}


def integrity_leg(serve, faults, pk, ck, lk, metrics, dtype, gen, dev) -> dict:
    """(c) integrity="full,abft", replicas=2: every delivery certified, the
    ABFT buckets' launches equal the mirrors, sdc_solve and sdc_factor
    caught and recovered, quarantine and its probe, a straggler hedged,
    and the plane's costs (dispatch, host certificate, requests/s)."""
    from slate_tpu_torch.exceptions import SlateError
    from slate_tpu_torch.integrity import abft
    from slate_tpu_torch.serve import factor_cache as sfc
    from slate_tpu_torch.serve import service as ssvc

    dt = getattr(torch, dtype)
    n, bm = N_SERVE, SERVE17_BATCH
    ops = _ops(n, dt, gen, dev)
    Bs, Bs_np = _rhs(n, dt, gen, dev)
    out = {}
    svc = serve.SolverService(replicas=2, factor_cache=False, integrity="full,abft,hedge=0",
                              batch_max=bm, batch_window_s=0.002)
    try:
        for routine, _A, A_np in ops[:2]:
            svc.submit(routine, A_np, Bs_np[0]).result(timeout=900)
        svc.warmup()
        keys = {r: serve.bucket_for(r, n, n, NRHS_SERVE, ops[0][2].dtype, tag=abft.ABFT_TAG)
                for r in ("gesv", "posv")}
        runs0 = {(r, b): _serve_runs_at(metrics, keys[r].label, b) for r in keys
                 for b in (1, bm)}
        pk.reset_launches()  # counts of the certified stream only
        with metrics.deltas() as d:
            t_on, res = _stream(svc, ops, Bs, Bs_np, STREAM17, dev)
            _idle(svc)  # the twins of hedged stragglers finish too
            checked, failed = d.get("serve.integrity.checked"), d.get("serve.integrity.fail")
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        expect = {}
        for (r, b), r0 in runs0.items():
            items = (_serve_runs_at(metrics, keys[r].label, b) - r0) * b
            for k, v in _abft_mirror(ck, lk, r, n, items).items():
                expect[k] = expect.get(k, 0) + v
        print(f"  integrity {dtype} full,abft,hedge=0 stream: {STREAM17} in {t_on:.3f} s = "
              f"{STREAM17 / t_on:.2f} requests/s, certified {checked}, failed {failed}, launches "
              f"{launches} (mirrors {expect}), max residual {res:.3e}", flush=True)
        check(checked == STREAM17 and failed == 0, f"integrity {dtype}: certified {checked}, "
              f"failed {failed}")
        check(launches == expect, f"integrity {dtype}: launches {launches} != {expect}")
        check(res <= 3, f"integrity {dtype}: residual {res:.3f} > 3")
        faults.arm("sdc_solve", once=True)
        faults.on()
        with metrics.deltas() as d:
            X = svc.submit("gesv", ops[0][2], Bs_np[1]).result(timeout=900)
            _idle(svc)
            sdc_s = {k: d.get(f"serve.{k}") for k in ("integrity.fail", "integrity.recovered",
                                                      "hedge.sent", "hedge.won")}
            fired = d.get("faults.injected.sdc_solve")
        faults.reset()
        r = scaled_residual(ops[0][1], torch.from_numpy(X).to(dev), Bs[1])
        print(f"  integrity {dtype} sdc_solve once: fired {fired}, {sdc_s}, residual "
              f"{r:.3e}", flush=True)
        check(fired == 1 and sdc_s["integrity.fail"] == 1 and sdc_s["integrity.recovered"] == 1
              and r <= 3, f"integrity {dtype} sdc_solve: {sdc_s}, residual {r:.3f}")
        out["sdc_solve"] = {**sdc_s, "residual": r}
        # the plane's costs: one ABFT dispatch against the plain core on
        # the same operands, and the host certificates of one request
        costs = {}
        for routine, A, A_np in ops[:2]:
            k = keys[routine]
            plain = svc.cache.executable(dataclasses.replace(k, tag=""), 1)
            core = svc.cache.executable(k, 1)
            A1, B1 = A[None], torch.nn.functional.pad(Bs[0], (0, k.nrhs - NRHS_SERVE))[None]
            ab, pl = _interleaved_ms(lambda: core(A1, B1), lambda: plain(A1, B1))
            t_abft, t_plain = statistics.median(ab), statistics.median(pl)
            ratios = sorted(a / p - 1 for a, p in zip(ab, pl))
            prof = _abft_profile(lambda: core(A1, B1), lambda: plain(A1, B1))
            X = core(A1, B1)[0][0, :, :NRHS_SERVE].cpu().numpy()
            t_cert = _host_s(lambda: abft.checksum_certificate(A_np, Bs_np[0], X))
            t_res = _host_s(lambda: sfc.residual_ok(A_np, Bs_np[0], X, routine))
            req = ssvc._Request(routine=routine, key=k, A=A_np, B=Bs_np[0], m=n, n=n,
                                nrhs=NRHS_SERVE)
            t_op = _host_s(lambda: ssvc._cert_operand(req))
            costs[routine] = {"abft_dispatch_ms": t_abft, "plain_dispatch_ms": t_plain,
                              "overhead": t_abft / t_plain - 1,
                              "overhead_rounds": [ratios[0], statistics.median(ratios),
                                                  ratios[-1]],
                              "profile": prof,
                              "model_overhead": abft.overhead_ratio(k),
                              "checksum_certificate_host_ms": t_cert * 1e3,
                              "cert_operand_host_ms": t_op * 1e3,
                              "residual_ok_host_ms": t_res * 1e3}
            print(f"  integrity {dtype} {routine} b1 dispatch, median of {ABFT_ROUNDS} "
                  f"interleaved rounds: abft {t_abft:.3f} ms, plain {t_plain:.3f} ms "
                  f"({(t_abft / t_plain - 1) * 100:.1f} %; a round's overhead min / median "
                  f"/ max {ratios[0] * 100:.1f} / {statistics.median(ratios) * 100:.1f} / "
                  f"{ratios[-1] * 100:.1f} %; model {abft.overhead_ratio(k) * 100:.2f} %)",
                  flush=True)
            print(f"  integrity {dtype} {routine} profiled b1 dispatch: device busy abft "
                  f"{prof['abft_busy_ms']:.3f} ms of {prof['abft_wall_ms']:.3f} ms wall, plain "
                  f"{prof['plain_busy_ms']:.3f} ms of {prof['plain_wall_ms']:.3f} ms; device "
                  "time the ABFT core adds, by op: " + ", ".join(
                      f"{key[:48]} {ms:+.3f} ms" for key, ms in prof["added_by_op"]), flush=True)
            print(f"  integrity {dtype} {routine} host a request: "
                  f"checksum_certificate {t_cert * 1e3:.2f} ms, its operand "
                  f"{t_op * 1e3:.2f} ms, residual_ok {t_res * 1e3:.2f} ms", flush=True)
        out["costs"] = costs
    finally:
        svc.stop()
    # the same stream with the plane off
    svc = serve.SolverService(replicas=2, factor_cache=False, integrity=False,
                              batch_max=bm, batch_window_s=0.002)
    try:
        for routine, _A, A_np in ops[:2]:
            svc.submit(routine, A_np, Bs_np[0]).result(timeout=900)
        svc.warmup()
        t_off, res = _stream(svc, ops, Bs, Bs_np, STREAM17, dev)
        check(res <= 3, f"integrity off {dtype}: residual {res:.3f} > 3")
    finally:
        svc.stop()
    print(f"  integrity {dtype}: {STREAM17}-request stream, requests/s on (hedge=0) "
          f"{STREAM17 / t_on:.2f}, off {STREAM17 / t_off:.2f}", flush=True)
    out["requests_per_s"] = {"on": STREAM17 / t_on, "off": STREAM17 / t_off}
    # sdc_factor on the factor path (the factor cache excludes ABFT)
    svc = serve.SolverService(replicas=2, factor_cache=serve.FactorCache(max_entries=4),
                              integrity="full,abft", batch_max=bm, batch_window_s=0.002)
    try:
        faults.arm("sdc_factor", once=True)
        faults.on()
        with metrics.deltas() as d:
            X = svc.submit("posv", ops[1][2], Bs_np[2]).result(timeout=900)
            _idle(svc)
            sdc_f = {k: d.get(f"serve.{k}") for k in ("integrity.fail", "integrity.recovered",
                                                      "factor_cache.stale", "hedge.sent")}
            fired = d.get("faults.injected.sdc_factor")
        faults.reset()
        r = scaled_residual(ops[1][1], torch.from_numpy(X).to(dev), Bs[2])
        print(f"  integrity {dtype} sdc_factor once: fired {fired}, {sdc_f}, residual "
              f"{r:.3e}", flush=True)
        check(fired == 1 and sdc_f["integrity.fail"] >= 1 and sdc_f["integrity.recovered"] >= 1
              and r <= 3, f"integrity {dtype} sdc_factor: {sdc_f}, residual {r:.3f}")
        out["sdc_factor"] = {**sdc_f, "residual": r}
    finally:
        svc.stop()
    # quarantine: every execution corrupted until a lane trips, then clean
    # traffic after the cooldown probes it back
    svc = serve.SolverService(replicas=2, factor_cache=False, batch_max=1,
                              integrity="full,abft,hedge=0,cooldown=0.3,retries=1")
    try:
        faults.arm("sdc_solve", every=1)
        faults.on()
        refused = 0
        for i in range(3):
            try:
                svc.submit("gesv", ops[0][2], Bs_np[i]).result(timeout=900)
            except SlateError:
                refused += 1
        faults.reset()
        quarantined = svc.health()["integrity"]["quarantined"]
        qn = metrics.counters().get("serve.integrity.quarantined", 0)
        time.sleep(0.35)
        with metrics.deltas() as d:
            Xs = [svc.submit("gesv", ops[0][2], Bs_np[i]).result(timeout=900) for i in range(4)]
            back = d.get("serve.integrity.unquarantined")
        res = max(scaled_residual(ops[0][1], torch.from_numpy(X).to(dev), Bs[i])
                  for i, X in enumerate(Xs))
        after = svc.health()["integrity"]["quarantined"]
        print(f"  integrity {dtype} quarantine: 3 corrupted requests refused {refused}, "
              f"quarantined {quarantined}; after the cooldown 4 clean requests, "
              f"unquarantined {back}, quarantined {after}, max residual {res:.3e}", flush=True)
        check(quarantined and qn >= 1 and back >= 1 and not after and res <= 3,
              f"integrity {dtype} quarantine: {quarantined}, {back}, {after}")
        out["quarantine"] = {"quarantined": quarantined, "refused": refused,
                             "unquarantined": back}
    finally:
        faults.reset()
        svc.stop()
    # a straggler: one dispatch delayed 1.5 s, the requests queued behind it
    # are cloned to the other lane (hedging needs a p99 of this bucket)
    n2 = N_SERVE // 2
    ops2 = _ops(n2, dt, gen, dev, 1)
    B2, B2_np = _rhs(n2, dt, gen, dev, 6)
    svc = serve.SolverService(replicas=2, factor_cache=False, batch_max=1,
                              integrity="full,abft")
    try:
        for i in range(4):  # the bucket's latency history
            svc.submit("gesv", ops2[0][2], B2_np[i]).result(timeout=900)
        faults.arm("latency", once=True, ms=1500)
        faults.on()
        with metrics.deltas() as d:
            t, res = _stream(svc, ops2, B2, B2_np, 6, dev)
            _idle(svc)
            hedge = {k: d.get(f"serve.hedge.{k}") for k in ("sent", "won", "wasted")}
        faults.reset()
        print(f"  integrity {dtype} straggler: 6 requests with one dispatch delayed 1.5 s in "
              f"{t:.3f} s, hedges {hedge}, max residual {res:.3e}", flush=True)
        check(hedge["sent"] >= 1 and hedge["won"] >= 1 and res <= 3,
              f"integrity {dtype} straggler: hedges {hedge}")
        out["straggler"] = {**hedge, "stream_s": t}
    finally:
        faults.reset()
        svc.stop()
    return out


ABFT_ROUNDS = 5  # interleaved rounds of the ABFT and the plain b1 dispatch


def _interleaved_ms(fa, fb, rounds: int = ABFT_ROUNDS):
    """CUDA-event ms of fa and fb, one call each a round, interleaved so
    clock or neighbour drift falls on both alike (after a warm call)."""
    fa(), fb()
    a, b = [], []
    for _ in range(rounds):
        a.append(cuda_ms(fa, reps=1, warm=0))
        b.append(cuda_ms(fb, reps=1, warm=0))
    return a, b


def _abft_profile(fa, fb, top: int = 6) -> dict:
    """torch.profiler's device time by op of one warm ABFT dispatch (fa)
    and one plain (fb): each one's busy and wall ms and the ``top`` ops
    whose device time the ABFT core adds most."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    out, by_op = {}, {}
    for tag, fn in (("abft", fa), ("plain", fb)):
        with torch.profiler.profile(activities=act) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")]
        by_op[tag] = {e.key: dev_us(e) / 1e3 for e in rows}
        out[f"{tag}_busy_ms"] = sum(by_op[tag].values())
        out[f"{tag}_wall_ms"] = wall * 1e3
    keys = set(by_op["abft"]) | set(by_op["plain"])
    added = sorted(((k, by_op["abft"].get(k, 0.0) - by_op["plain"].get(k, 0.0)) for k in keys),
                   key=lambda kv: -kv[1])
    out["added_by_op"] = added[:top]
    return out


def _serve_runs_at(metrics, label: str, batch: int) -> int:
    """Dispatches of one bucket at one batch point so far (its cold build
    and its warm runs)."""
    t = metrics.timers()
    return sum(int(t.get(f"serve.{label}.b{batch}.{part}", {"count": 0})["count"])
               for part in ("compile", "run"))


def restore_main(serve, faults, pk, ck, lk, metrics, gen, dev, t_build) -> dict:
    t17 = time.perf_counter()
    out = {"cold_start_float64": cold_start_leg(serve, faults, metrics, dev, gen, t_build)}
    torch.cuda.empty_cache()
    for d in DTYPES:
        out[d] = {"replicas": replica_leg(serve, metrics, d, gen, dev)}
        torch.cuda.empty_cache()
        out[d]["integrity"] = integrity_leg(serve, faults, pk, ck, lk, metrics, d, gen, dev)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t17
    print(f"  phase 17: {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: the admission plane, the checked runtime and the device monitor
# ---------------------------------------------------------------------------

N18_ABUSE = 2048  # the abuser's gesv bucket
SERVE18_BATCH = 4
FLOOD18, VICTIMS18 = 48, 8
STREAM18 = 20  # requests of the checked-runtime stream
TENANTS18 = "good:weight=4;abuser:rate=10,burst=4,share=0.25"
SYNC18 = "1,seed=7,yield=0.2"


def _tool(name: str, *args) -> subprocess.CompletedProcess:
    """One of the repo's report tools, in a subprocess (they import
    neither the port nor the JAX package)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, os.path.join(here, "tools", name), *args],
                          cwd=here, capture_output=True, text=True, timeout=120)


def _gesv_ops(n, dt, gen, dev, count):
    """``count`` gesv operands (normal A + 2 sqrt(n) I) with a right side
    each, on the card and as host numpy."""
    out = []
    for _ in range(count):
        A = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
        A.diagonal().add_(2 * n**0.5)
        B = torch.randn(n, NRHS_SERVE, generator=gen, device=dev, dtype=dt)
        out.append((A, B, A.cpu().numpy(), B.cpu().numpy()))
    return out


def _runs18(metrics, labels) -> dict:
    return {(lbl, b): _serve_runs_at(metrics, lbl, b) for lbl in labels
            for b in (1, SERVE18_BATCH)}


def _mirror18(ck, lk, metrics, runs0: dict, routines: dict) -> dict:
    """The kernel launches of the full-phase cores run since ``runs0``:
    each dispatch's batch point times its factor's mirror (the drivers'
    own solves are library solves)."""
    expect = {}
    for (lbl, b), r0 in runs0.items():
        routine, n = routines[lbl]
        items = (_serve_runs_at(metrics, lbl, b) - r0) * b
        for k, v in _abft_mirror(ck, lk, routine, n, items).items():
            expect[k] = expect.get(k, 0) + v
    return expect


def _fairness_stream(serve, svc, victims, abuser, dev, adaptive: bool) -> dict:
    """The JAX package's two-leg stream (``run_tests.py``'s adaptive gate)
    on ``svc``: ``FLOOD18`` low-priority requests from tenant ``abuser``,
    then ``VICTIMS18`` high-priority ones from ``good``; adaptive, then
    tight-deadline abuser traffic until a Shed.  Every future resolves;
    every delivered X's scaled residual is returned."""
    from slate_tpu_torch.exceptions import SlateError

    futs, refused = [], {"Shed": 0, "Rejected": 0}
    A_a, B_a, A_np, B_np = abuser

    def abuse(**kw):
        try:
            futs.append((svc.submit("gesv", A_np, B_np, tenant="abuser", priority="low", **kw),
                         A_a, B_a))
        except (serve.Shed, serve.Rejected) as e:
            refused[type(e).__name__] += 1

    t0 = time.perf_counter()
    for _ in range(FLOOD18):
        abuse()
    for A, B, A_n, B_n in victims:
        futs.append((svc.submit("gesv", A_n, B_n, tenant="good", priority="high", deadline=10.0),
                     A, B))
    if adaptive:
        time.sleep(0.4)
        for _ in range(8):
            abuse(deadline=0.02)
        end = time.monotonic() + 10.0
        while refused["Shed"] == 0 and time.monotonic() < end:
            time.sleep(0.05)
            abuse(deadline=0.02)
    res, typed = [], 0
    for f, A, B in futs:
        try:
            res.append(scaled_residual(A, torch.from_numpy(f.result(timeout=600)).to(dev), B))
        except SlateError:
            typed += 1
    _idle(svc)
    return {"stream_s": time.perf_counter() - t0, "admitted": len(futs), "delivered": len(res),
            "typed": typed, "refused": refused, "max_residual": max(res)}


def fairness_leg(serve, faults, ck, lk, pk, metrics, dtype, gen, dev, static: bool,
                 tmp: str) -> dict:
    """(a) one dtype: the victim's p99 alone sets the budget (twice it);
    the static service (planes off, tags inert) must miss it, the
    adaptive one must hold it and end in Sheds and quota rejections; the
    adaptive leg's JSONL passes tools/tenant_report.py and is read by
    tools/latency_report.py."""
    import os

    dt = getattr(torch, dtype)
    victims = _gesv_ops(N_SERVE, dt, gen, dev, VICTIMS18)
    abuser = _gesv_ops(N18_ABUSE, dt, gen, dev, 1)[0]
    kv = serve.bucket_for("gesv", N_SERVE, N_SERVE, NRHS_SERVE, victims[0][2].dtype)
    ka = serve.bucket_for("gesv", N18_ABUSE, N18_ABUSE, NRHS_SERVE, victims[0][2].dtype)
    routines = {kv.label: ("gesv", kv.n), ka.label: ("gesv", ka.n)}
    cache = serve.ExecutableCache(manifest_path=None)
    for k in (kv, ka):
        cache.ensure_manifest(k, (1, SERVE18_BATCH))
    kw = dict(cache=cache, factor_cache=False, batch_max=SERVE18_BATCH, batch_window_s=0.01)
    out = {}

    def serve_leg(name, **extra):
        # each leg's registry holds that leg alone: its p99s are the
        # histograms' own, clamped to the largest latency observed
        metrics.reset()
        svc = serve.SolverService(**kw, **extra)
        try:
            svc.warmup()
            faults.configure("latency:every=1,ms=30")  # armed after warmup
            faults.on()
            runs0 = _runs18(metrics, routines)
            pk.reset_launches()
            if name == "alone":
                t0 = time.perf_counter()
                futs = [svc.submit("gesv", a, b, tenant="good", priority="high")
                        for _A, _B, a, b in victims]
                res = max(scaled_residual(A, torch.from_numpy(f.result(timeout=600)).to(dev),
                                          B) for f, (A, B, _a, _b) in zip(futs, victims))
                _idle(svc)
                got = {"stream_s": time.perf_counter() - t0, "admitted": len(futs),
                       "delivered": len(futs), "typed": 0, "max_residual": res}
            else:
                got = _fairness_stream(serve, svc, victims, abuser, dev, name == "adaptive")
            h = svc.health()
            c = metrics.counters()
            got["p99_victim_bucket"] = metrics.percentile(f"serve.latency.{kv.label}.total",
                                                          99)
            got["fallbacks"] = c.get("serve.fallbacks", 0)
            got["rejected_quota"] = c.get("serve.rejected_quota", 0)
            got["shed"] = c.get("serve.shed", 0)
        finally:
            faults.reset()
            svc.stop()
        got["launches"] = {k: v for k, v in pk.LAUNCHES.items() if v}
        got["mirror"] = _mirror18(ck, lk, metrics, runs0, routines)
        check(got["launches"] == got["mirror"] and got["fallbacks"] == 0,
              f"fairness {dtype} {name}: launches {got['launches']} != the cores' mirror "
              f"{got['mirror']} (fallbacks {got['fallbacks']})")
        check(got["max_residual"] <= 3, f"fairness {dtype} {name}: residual "
              f"{got['max_residual']:.3f} > 3")
        check(got["delivered"] + got["typed"] == got["admitted"],
              f"fairness {dtype} {name}: a future did not resolve")
        return got, h

    alone, _h = serve_leg("alone")
    budget = 2 * alone["p99_victim_bucket"]
    out["alone"] = alone
    out["budget_s"] = budget
    print(f"  fairness {dtype}: the victim alone ({VICTIMS18} gesv at n = {N_SERVE}, 30 ms "
          f"injected a dispatch): p99 {alone['p99_victim_bucket'] * 1e3:.1f} ms -> budget "
          f"{budget * 1e3:.1f} ms; launches {alone['launches']} (mirror)", flush=True)
    if static:
        st, h = serve_leg("static")
        out["static"] = st
        print(f"  fairness {dtype} static (planes off, tags inert): victim p99 "
              f"{st['p99_victim_bucket'] * 1e3:.1f} ms against the {budget * 1e3:.1f} ms budget "
              f"({'missed' if st['p99_victim_bucket'] > budget else 'held'}); "
              f"{st['delivered']} delivered, {st['typed']} typed in {st['stream_s']:.3f} s; "
              f"plane-off launches {st['launches']} = the cores' mirror", flush=True)
        check(h["tenants"] is None and h["admission"] is None, "static leg has a plane")
        check(st["p99_victim_bucket"] > budget,
              f"fairness {dtype}: the static leg held the budget ({st['p99_victim_bucket']:.3f}"
              f" <= {budget:.3f} s)")
    ad, h = serve_leg("adaptive", tenants=TENANTS18, adaptive=True, latency_budget_s=budget)
    p99_good = metrics.percentile("serve.latency.tenant.good.total", 99)
    ad["p99_good"] = p99_good
    ad["health_tenants"] = h["tenants"]
    ad["admission"] = h["admission"]
    out["adaptive"] = ad
    print(f"  fairness {dtype} adaptive: victim p99 {p99_good * 1e3:.1f} ms against the "
          f"{budget * 1e3:.1f} ms budget ({'held' if p99_good <= budget else 'missed'}); abuser "
          f"shed {ad['refused']['Shed']}, quota-rejected {ad['rejected_quota']} (refused "
          f"{ad['refused']}), overload level {h['admission']['overload_level']}, windows "
          f"{h['admission']['windows']}; {ad['delivered']} delivered, {ad['typed']} typed in "
          f"{ad['stream_s']:.3f} s; launches {ad['launches']} = the cores' mirror", flush=True)
    check(p99_good is not None and p99_good <= budget,
          f"fairness {dtype}: the adaptive leg missed the budget ({p99_good} > {budget:.3f} s)")
    check(ad["refused"]["Shed"] > 0 and ad["rejected_quota"] > 0,
          f"fairness {dtype}: abuser shed {ad['refused']}, quota {ad['rejected_quota']}")
    check(h["tenants"]["abuser"]["shed"] == ad["refused"]["Shed"]
          and h["admission"]["overload_level"] >= 1, f"fairness {dtype}: health {h['admission']}")
    jsonl = metrics.dump(os.path.join(tmp, f"adaptive_{dtype}.jsonl"))
    tr = _tool("tenant_report.py", jsonl, "--p99-budget", repr(budget), "--well-behaved",
               "good", "--abusive", "abuser")
    lr = _tool("latency_report.py", jsonl)
    print("  tools/tenant_report.py:\n" + "\n".join("    " + ln for ln in
                                                     tr.stdout.strip().splitlines()), flush=True)
    print("  tools/latency_report.py:\n" + "\n".join("    " + ln for ln in
                                                      lr.stdout.strip().splitlines()[:8]),
          flush=True)
    check(tr.returncode == 0, f"tenant_report {dtype} exited {tr.returncode}: {tr.stderr[-500:]}")
    check(lr.returncode == 0, f"latency_report {dtype} exited {lr.returncode}: {lr.stderr[-500:]}")
    out["tenant_report_rc"], out["latency_report_rc"] = tr.returncode, lr.returncode
    return out


# A fresh interpreter of the port alone for phase 18 (argv: mode, path).
# "flood": tenant_flood armed by env, one real request; "sync": the
# checked runtime armed by env, a two-lane stream; "restore": devmon armed
# by env, restore the store and read the cost rows.  One JSON line out.
_CHILD18 = r"""
import json, sys
import chip_smoke as cs
print(json.dumps(cs.child18(sys.argv[1], sys.argv[2])))
"""


def _run_child18(mode: str, path: str, env_extra: dict) -> dict:
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here, **env_extra}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _CHILD18, mode, path], cwd=here, env=env,
                         capture_output=True, text=True, timeout=900)
    check(out.returncode == 0, f"phase 18 child ({mode}) exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["process_wall_s"] = time.perf_counter() - t0
    return got


def _sync_stream(serve, metrics, ck, lk, pk, gen, dev) -> dict:
    """(c)'s stream: two lanes on cuda:0 with tenants, certification and
    hedging; gesv / posv alternating at n = 4096, ``STREAM18`` requests,
    the second lane removed half way."""
    ops = _ops(N_SERVE, torch.float64, gen, dev)
    Bs, Bs_np = _rhs(N_SERVE, torch.float64, gen, dev)
    labels = {serve.bucket_for(r, N_SERVE, N_SERVE, NRHS_SERVE, np.float64).label: (r, N_SERVE)
              for r in ("gesv", "posv")}
    svc = serve.SolverService(replicas=2, factor_cache=False, tenants="gold:weight=4;free",
                              integrity="full", batch_max=SERVE18_BATCH, batch_window_s=0.002)
    try:
        for routine, _A, A_np in ops[:2]:
            svc.submit(routine, A_np, Bs_np[0]).result(timeout=900)
        svc.warmup()
        runs0 = _runs18(metrics, labels)
        pk.reset_launches()
        with metrics.deltas() as d:
            t0 = time.perf_counter()
            futs = []
            for i in range(STREAM18):
                routine, _A, A_np = ops[i % 4]
                futs.append(svc.submit(routine, A_np, Bs_np[i % 5],
                                       tenant=("gold", "free")[i % 2]))
                if i == STREAM18 // 2:
                    removed = svc.remove_replica()
            Xs = [f.result(timeout=900) for f in futs]
            t = time.perf_counter() - t0
            _idle(svc)
            checked, hedges = d.get("serve.integrity.checked"), d.get("serve.hedge.sent")
            rehomed, fallbacks = d.get("scale.requests_rehomed"), d.get("serve.fallbacks")
    finally:
        svc.stop()
    res = max(scaled_residual(ops[i % 4][1], torch.from_numpy(X).to(dev), Bs[i % 5])
              for i, X in enumerate(Xs))
    return {"requests": STREAM18, "stream_s": t, "requests_per_s": STREAM18 / t,
            "max_residual": res, "checked": checked, "hedges": hedges, "removed": removed,
            "rehomed": rehomed, "fallbacks": fallbacks,
            "launches": {k: v for k, v in pk.LAUNCHES.items() if v},
            "mirror": _mirror18(ck, lk, metrics, runs0, labels)}


def child18(mode: str, path: str) -> dict:
    """The phase 18 child's work (see _CHILD18); runs in a fresh
    interpreter whose env armed the plane under test."""
    import os

    from slate_tpu_torch import serve
    from slate_tpu_torch.aux import devmon, metrics, sync
    from slate_tpu_torch.ops import chol_kernels as ck
    from slate_tpu_torch.ops import lu_kernels as lk
    from slate_tpu_torch.ops.hopper import panel_kernels as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    metrics.on()
    out = {"jax_modules": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "slate_tpu"))}
    if mode == "sync":
        out["armed"] = sync.is_on()
        out["stream"] = _sync_stream(serve, metrics, ck, lk, pk, gen, dev)
        rep = sync.report()
        out["violations"] = [{k: v[k] for k in ("kind", "detail")} for v in rep["violations"]]
        out["edges"], out["field_names"] = rep["edges"], rep["field_names"]
        sync.dump(path)
    elif mode == "flood":
        A, B, A_np, B_np = _gesv_ops(N_SERVE, torch.float64, gen, dev, 1)[0]
        label = serve.bucket_for("gesv", N_SERVE, N_SERVE, NRHS_SERVE, np.float64).label
        routines = {label: ("gesv", N_SERVE)}
        svc = serve.SolverService(factor_cache=False, batch_max=SERVE18_BATCH)
        try:
            out["plane"] = svc.health()["admission"]
            runs0 = _runs18(metrics, routines)
            pk.reset_launches()
            X = svc.submit("gesv", A_np, B_np, tenant="good").result(timeout=900)
            _idle(svc)
            out["residual"] = scaled_residual(A, torch.from_numpy(X).to(dev), B)
            out["tenants"] = svc.health()["tenants"]
        finally:
            svc.stop()
        out["launches"] = {k: v for k, v in pk.LAUNCHES.items() if v}
        out["mirror"] = _mirror18(ck, lk, metrics, runs0, routines)
        out["counters"] = {k: v for k, v in metrics.counters().items()
                           if k.startswith(("faults.", "serve.shed", "serve.rejected",
                                            "serve.tenant."))}
        metrics.dump(path)
    elif mode == "restore":
        man, store = os.path.join(path, "m.json"), os.path.join(path, "store")
        out["armed"] = devmon.is_on()
        svc = serve.SolverService(cache=serve.ExecutableCache(manifest_path=man,
                                                              artifact_dir=store),
                                  factor_cache=False, batch_max=SERVE18_BATCH)
        try:
            out["ready"] = svc.wait_ready(600)
            h = svc.health()
            out["restore"], out["devices"] = h["restore"], h["devices"]
            out["registry"] = {f"{k.label}.b{b}": v for (k, b), v in
                               svc.cache.cost_registry().items()}
        finally:
            svc.stop()
        out["costs"] = metrics.costs()
        out["counters"] = {k: v for k, v in metrics.counters().items()
                           if k.startswith(("serve.cost", "jit.", "serve.artifact_hit"))}
    return out


def sync_leg(serve, metrics, ck, lk, pk, gen, dev, tmp: str) -> dict:
    """(c) the checked runtime in a fresh interpreter armed by
    SLATE_TPU_SYNC_CHECK, the same stream unchecked here."""
    import os

    dump = os.path.join(tmp, "sync.json")
    got = _run_child18("sync", dump, {"SLATE_TPU_SYNC_CHECK": SYNC18})
    st = got["stream"]
    rr = _tool("race_report.py", dump, "--quiet")
    print(f"  checked runtime (fresh interpreter, SLATE_TPU_SYNC_CHECK={SYNC18}): "
          f"{st['requests']} requests in {st['stream_s']:.3f} s = {st['requests_per_s']:.3f} "
          f"requests/s, certified {st['checked']}, hedges {st['hedges']}, lane {st['removed']} "
          f"removed ({st['rehomed']} re-homed), violations {len(got['violations'])}, order edges "
          f"{len(got['edges'])}, probed fields {got['field_names']}; launches {st['launches']} "
          f"(mirror {st['mirror']}), max residual {st['max_residual']:.3e}", flush=True)
    print("  tools/race_report.py: " + " / ".join(rr.stdout.strip().splitlines()), flush=True)
    check(got["armed"] and got["jax_modules"] == [], f"sync child: armed {got['armed']}, "
          f"imported {got['jax_modules']}")
    check(got["violations"] == [], f"checked runtime: violations {got['violations']}")
    check(rr.returncode == 0, f"race_report exited {rr.returncode}")
    check(st["launches"] == st["mirror"] and st["fallbacks"] == 0 and st["max_residual"] <= 3
          and st["checked"] >= st["requests"], f"sync stream checked: {st}")
    un = _sync_stream(serve, metrics, ck, lk, pk, gen, dev)
    check(un["launches"] == un["mirror"] and un["fallbacks"] == 0 and un["max_residual"] <= 3,
          f"sync stream unchecked: {un}")
    print(f"  the same stream unchecked (this process): {un['requests_per_s']:.3f} requests/s "
          f"(checked / unchecked {st['requests_per_s'] / un['requests_per_s']:.3f}), launches "
          f"{un['launches']} = mirror, max residual {un['max_residual']:.3e}", flush=True)
    return {"checked": st, "unchecked": un, "violations": got["violations"],
            "edges": len(got["edges"]), "field_names": got["field_names"],
            "race_report_rc": rr.returncode, "child_wall_s": got["process_wall_s"]}


def flood_leg(tmp: str) -> dict:
    """(b) tenant_flood armed by env: one real request, the burst refused
    and counted; tools/chaos_report.py joins the injection to the
    refusals."""
    import os

    jsonl = os.path.join(tmp, "flood.jsonl")
    got = _run_child18("flood", jsonl, {"SLATE_TPU_TENANTS": "flood:rate=1,burst=2,share=0.1",
                                         "SLATE_TPU_FAULTS": "tenant_flood:once,burst=24"})
    c = got["counters"]
    refused = c.get("serve.shed", 0) + c.get("serve.rejected", 0)
    cr = _tool("chaos_report.py", jsonl)
    print(f"  tenant_flood (fresh interpreter, armed by env): injected "
          f"{c.get('faults.injected.tenant_flood')}, burst refused {refused} (shed "
          f"{c.get('serve.shed', 0)}, rejected {c.get('serve.rejected', 0)}, quota "
          f"{c.get('serve.rejected_quota', 0)}, share {c.get('serve.rejected_share', 0)}), flood "
          f"admitted {c.get('serve.tenant.flood.admitted', 0)}; the real request's residual "
          f"{got['residual']:.3e}; launches {got['launches']} (mirror {got['mirror']}); "
          f"chaos_report exit {cr.returncode}", flush=True)
    check(got["plane"] is not None and got["jax_modules"] == [], f"flood child: {got}")
    check(c.get("faults.injected.tenant_flood") == 1 and refused >= 1
          and c.get("serve.tenant.good.admitted") == 1, f"tenant_flood counters {c}")
    check(got["residual"] <= 3 and got["launches"] == got["mirror"], f"tenant_flood: {got}")
    check(cr.returncode == 0, f"chaos_report exited {cr.returncode}: {cr.stdout[-800:]}")
    return {"counters": c, "refused": refused, "residual": got["residual"],
            "launches": got["launches"], "chaos_report_rc": cr.returncode}


def devmon_leg(serve, metrics, devmon, pk, gen, dev, tmp: str) -> dict:
    """(d) SLATE_TPU_DEVMON's plane on cuda:0: the device row, a cost row a
    warmed (key, batch) with the phase_flops model and a measured peak,
    the roofline of each against the h100 row, and a fresh interpreter
    that restores the rows from the manifest with no second measurement."""
    import os

    d18 = os.path.join(tmp, "devmon")
    man, store = os.path.join(d18, "m.json"), os.path.join(d18, "store")
    os.makedirs(d18, exist_ok=True)
    devmon.on()
    ops = _ops(N_SERVE, torch.float64, gen, dev, 2)
    Bs, Bs_np = _rhs(N_SERVE, torch.float64, gen, dev, 2)
    keys = [(serve.bucket_for(r, N_SERVE, N_SERVE, NRHS_SERVE, np.float64), b)
            for r in ("gesv", "posv") for b in (1, SERVE18_BATCH)]
    svc = serve.SolverService(cache=serve.ExecutableCache(manifest_path=man, artifact_dir=store),
                              factor_cache=False, batch_max=SERVE18_BATCH, batch_window_s=0.002)
    try:
        with metrics.deltas() as d:
            for k, b in keys:
                svc.cache.ensure_manifest(k, (b,))
            svc.warmup()
            captured = d.get("serve.cost_captured")
        # two measured warm runs of each core on real operands: the rates
        roof = {}
        pkk = devmon.peaks_for()
        for (k, b), (_routine, A, A_np) in zip(keys, [ops[0], ops[0], ops[1], ops[1]]):
            Ap, Bp = serve.buckets.pad_request(k, A_np, Bs_np[0])
            Ab, Bb = np.stack([Ap] * b), np.stack([Bp] * b)
            name = f"serve.{k.label}.b{b}"
            t0 = metrics.timers().get(f"{name}.run", {"count": 0, "total_s": 0.0})
            for _ in range(2):
                X, info = svc.cache.run(k, Ab, Bb, device=dev)
            t1 = metrics.timers()[f"{name}.run"]
            mean = (t1["total_s"] - t0["total_s"]) / (t1["count"] - t0["count"])
            r = scaled_residual(A, torch.from_numpy(X[0, :N_SERVE, :NRHS_SERVE]).to(dev), Bs[0])
            check(r <= 3 and int(info[0]) == 0, f"devmon {name}: residual {r}, info {info}")
            c = svc.cache.cost(k, b)
            rl = devmon.roofline(c["flops_model"], c["bytes_accessed"], mean, pkk)
            roof[f"{k.label}.b{b}"] = {"run_s": mean, "achieved_flops": rl["achieved_flops"],
                                       "frac_of_h100": rl["achieved_flops"] / pkk["flops"],
                                       "bound": rl["bound"], "intensity": rl["intensity"],
                                       "frac_of_roof": rl["frac_of_roof"]}
        h = svc.health()
    finally:
        svc.stop()
        devmon.off()
    rows = {f"{k.label}.b{b}": svc.cache.cost(k, b) for k, b in keys}
    [row] = [r for r in h["devices"] if r["device"] == str(dev)]
    print(f"  devmon {dev}: bytes_in_use {row['bytes_in_use']}, peak "
          f"{row['peak_bytes_in_use']}, limit {row['bytes_limit']} ({row['kind']}); warmup "
          f"captured {captured} cost rows; peaks row {pkk['kind']!r} ({pkk['source']}): "
          f"{pkk['flops']:.3g} FLOP/s, {pkk['bytes_per_s']:.3g} B/s", flush=True)
    for lbl, c in rows.items():
        rl = roof[lbl]
        print(f"  devmon {lbl}: flops_model {c['flops_model']:.4g}, bytes_accessed "
              f"{c['bytes_accessed']:.4g} (operands + results), peak_bytes {c['peak_bytes']} "
              f"({c['peak_bytes'] / c['bytes_accessed']:.2f} x the operands + results); warm run "
              f"{rl['run_s'] * 1e3:.2f} ms = {rl['achieved_flops'] / 1e12:.3f} TFLOP/s, "
              f"{rl['frac_of_h100'] * 100:.2f} % of the h100 row ({rl['bound']} bound, "
              f"{rl['frac_of_roof'] * 100:.2f} % of its roof)", flush=True)
    check(row["bytes_in_use"] > 0 and row["peak_bytes_in_use"] >= row["bytes_in_use"]
          and row["bytes_limit"] == torch.cuda.mem_get_info(dev)[1], f"devmon row {row}")
    check(captured == len(keys), f"devmon: warmup captured {captured} rows of {len(keys)}")
    for (k, b) in keys:
        c = rows[f"{k.label}.b{b}"]
        check(c["flops_model"] == serve.buckets.phase_flops(k, b) and c["peak_bytes"] > 0,
              f"devmon cost row {k.label}.b{b}: {c}")
    got = _run_child18("restore", d18, {"SLATE_TPU_DEVMON": "1"})
    cc = got["counters"]
    print(f"  devmon restore (fresh interpreter, SLATE_TPU_DEVMON=1): restore {got['restore']}, "
          f"cost rows read {len(got['registry'])} and recorded {len(got['costs'])}, measured "
          f"again {cc.get('serve.cost_captured', 0)}, artifact hits "
          f"{cc.get('serve.artifact_hit', 0)}", flush=True)
    check(got["armed"] and got["ready"] and got["restore"]["restored"] == len(keys)
          and got["restore"]["compiled"] == 0, f"devmon restore child: {got['restore']}")
    check(cc.get("serve.cost_captured", 0) == 0 and got["registry"] == rows
          and sorted(got["costs"]) == sorted(f"serve.{lbl}" for lbl in rows),
          f"devmon restore: the rows were measured again or lost: {cc}")
    return {"device": row, "rows": rows, "roofline": roof, "restore": got["restore"],
            "restore_counters": cc}


def admission_main(serve, faults, pk, ck, lk, metrics, gen, dev) -> dict:
    import tempfile

    from slate_tpu_torch.aux import devmon

    t18 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in DTYPES:
            out[f"fairness_{d}"] = fairness_leg(serve, faults, ck, lk, pk, metrics, d, gen, dev,
                                                d == "float64", tmp)
            torch.cuda.empty_cache()
        metrics.reset()
        out["tenant_flood"] = flood_leg(tmp)
        out["sync"] = sync_leg(serve, metrics, ck, lk, pk, gen, dev, tmp)
        torch.cuda.empty_cache()
        out["devmon"] = devmon_leg(serve, metrics, devmon, pk, gen, dev, tmp)
    out["phase_s"] = time.perf_counter() - t18
    print(f"  phase 18: {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: the factor fabric (device factor arena and streaming gels sessions)
# ---------------------------------------------------------------------------

SESSION19 = 20  # warmed pristine session solves, every one a factor-cache hit
APPEND19 = 64  # rows of the streamed append
ROUNDS19 = 3  # rounds of each hit-dispatch timing (medians)
MISS_ROUNDS19 = 1  # rounds of the refactoring miss and of append / refactor


def _event_ms(fn) -> float:
    """One call's elapsed time on the card's clock (CUDA events on the
    default stream, which the service's lane also runs on)."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def _arena_moves(d) -> dict:
    return {k: v for k, v in d.all().items() if k.startswith("serve.arena.") and v}


def fabric_leg(serve, fabric, pk, qf, metrics, ops, armed: bool, dtype, dev) -> dict:
    """One leg of the JAX gate's stream (``run_tests.py:600-640``) at the
    serve tier's gels width: one miss (larft at the
    ``geqrf_kernel_launches`` mirror), ``warmup()``, SESSION19 pristine
    session solves (all hits, no cold build, no kernel launch), an append
    of APPEND19 rows and one streamed solve.  Returns the X stream and,
    armed, the timings; the service is kept for the caller's rounds."""
    A, A_np, Bs, Bs_np, C_np, B2, B2_np = ops
    m, n = A.shape
    tag = f"fabric {dtype} {'armed' if armed else 'unarmed'}"
    svc = serve.SolverService(factor_cache=serve.FactorCache(max_entries=4),
                              factor_arena=fabric.FactorArena() if armed else False,
                              batch_max=SERVE_BATCH, batch_window_s=0.002)
    check((svc.arena is not None) == armed, f"{tag}: arena {svc.arena}")
    metrics.reset()
    pk.reset_launches()  # counts of the miss only
    t0 = time.perf_counter()
    X0 = svc.submit("gels", A_np, Bs_np[0]).result(timeout=900)
    t_miss = time.perf_counter() - t0
    miss = {k: v for k, v in pk.LAUNCHES.items() if v}
    expect = qf.geqrf_kernel_launches(n, NB_SWITCH)
    check(miss == {"larft": expect}, f"{tag} miss: launches {miss}, expected larft {expect}")
    svc.warmup()
    sess = fabric.FactorSession(svc, A_np)
    check(sess.device == dev, f"{tag}: the session's device {sess.device}")
    pk.reset_launches()
    with metrics.deltas() as d:
        t0 = time.perf_counter()
        Xs = [sess.solve(Bs_np[i % len(Bs_np)]) for i in range(SESSION19)]
        t_stream = time.perf_counter() - t0
        hits, cold = d.get("serve.factor_cache.hit"), d.get("jit.compilations")
        avoided, moved = d.get("serve.arena.upload_avoided_bytes"), _arena_moves(d)
    launches = {k: v for k, v in pk.LAUNCHES.items() if v}
    check(hits == SESSION19 and cold == 0, f"{tag}: hits {hits}, cold builds {cold}")
    check(launches == {}, f"{tag}: the hit path launched {launches}")
    if armed:
        check(avoided > 0, f"{tag}: upload_avoided_bytes {avoided}")
    else:
        check(moved == {}, f"{tag}: serve.arena.* counters moved: {moved}")
    res = max([ls_residual(A, torch.from_numpy(X0).to(dev), Bs[0])]
              + [ls_residual(A, torch.from_numpy(X).to(dev), Bs[i % len(Bs)])
                 for i, X in enumerate(Xs)])
    check(res <= 3, f"{tag}: residual {res:.3f} > 3")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.append(C_np)
    torch.cuda.synchronize()
    t_append = time.perf_counter() - t0
    with metrics.deltas() as d:
        X2 = sess.solve(B2_np)
        fence = {k: d.get(f"fabric.session.{k}") for k in ("solve", "refactor", "fence_fail")}
    A2 = torch.cat([A, torch.from_numpy(C_np).to(dev)])
    r2 = ls_residual(A2, torch.from_numpy(X2).to(dev), B2)
    Xl = torch.linalg.lstsq(A2, B2).solution
    rl = ls_residual(A2, Xl, B2)
    dl = float((torch.from_numpy(X2).to(dev) - Xl).abs().max() / Xl.abs().max())
    print(f"  {tag} ({m}, {n}), nrhs {Bs[0].shape[1]}: miss {t_miss:.3f} s, larft "
          f"{miss.get('larft')} (expected {expect}); {SESSION19} session solves in "
          f"{t_stream:.3f} s, hits {hits}, cold builds {cold}, hit launches {launches}, "
          f"serve.arena.* {moved}, max residual {res:.3e}; append of {APPEND19} rows "
          f"{t_append:.3f} s; streamed solve residual {r2:.3e}, fence {fence}, against "
          f"torch.linalg.lstsq (residual {rl:.3e}) max rel diff {dl:.3e}", flush=True)
    check(r2 <= 3, f"{tag}: streamed solve residual {r2:.3f} > 3")
    check(fence["fence_fail"] == 0, f"{tag}: fence {fence}")
    out = {"miss_s": t_miss, "miss_launches": miss, "stream_s": t_stream, "hits": hits,
           "cold_builds": cold, "upload_avoided_bytes": avoided, "max_residual": res,
           "append_s": t_append, "streamed_residual": r2, "lstsq_residual": rl,
           "streamed_vs_lstsq": dl}
    return svc, sess, np.stack([X0, *Xs]), X2, out


def _dispatch_rounds(svc, metrics, A_np, B_np, rounds, before=None) -> tuple:
    """Medians over ``rounds`` requests (CUDA events, submit to result)
    and the host-to-device bytes each one moved: the factor bytes the
    arena uploaded (``serve.arena.upload_bytes``) plus the padded B batch
    (batch point 1)."""
    ms, up = [], []
    for _ in range(rounds):
        if before is not None:
            before()
        with metrics.deltas() as d:
            ms.append(_event_ms(lambda: svc.submit("gels", A_np, B_np).result(timeout=900)))
            up.append(d.get("serve.arena.upload_bytes"))
    return statistics.median(ms), statistics.median(up)


def fabric_main(serve, pk, qf, metrics, gen, dev) -> dict:
    """Phase 19, f64 and f32 at (8192, 4096), tiles of 64, nrhs = 16: the
    armed leg, the unarmed leg (byte-identical X, no arena counter), the
    report tool on the armed leg's dump, and the timings."""
    import os
    import tempfile

    from slate_tpu_torch import fabric
    from slate_tpu_torch.aux import devmon

    t19 = time.perf_counter()
    out = {}
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        m, n, nrhs = 2 * N_SERVE, N_SERVE, NRHS_SERVE
        A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
        Bs = [torch.randn(m, nrhs, generator=gen, device=dev, dtype=dt) for _ in range(4)]
        C = torch.randn(APPEND19, n, generator=gen, device=dev, dtype=dt)
        B2 = torch.randn(m + APPEND19, nrhs, generator=gen, device=dev, dtype=dt)
        ops = (A, A.cpu().numpy(), Bs, [B.cpu().numpy() for B in Bs], C.cpu().numpy(), B2,
               B2.cpu().numpy())
        A_np, B0_np = ops[1], ops[3][0]
        b_bytes = m * nrhs * A.element_size()  # the padded B of one request, batch point 1
        row = {}
        svc, sess, Xa, x2a, row["armed"] = fabric_leg(serve, fabric, pk, qf, metrics, ops,
                                                      True, dtype, dev)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                path = metrics.dump(os.path.join(tmp, "fabric.jsonl"))
                rep = _tool("factor_report.py", path)
            check(rep.returncode == 0, f"fabric {dtype}: factor_report.py exited "
                  f"{rep.returncode}: {rep.stdout[-2000:]} {rep.stderr[-2000:]}")
            check("arena (device-resident factors)" in rep.stdout,
                  f"fabric {dtype}: factor_report.py shows no arena section")
            lane = svc._replicas[0].lane
            fp = serve.matrix_fingerprint(A_np, "gels", schedule=svc.schedule)
            pack = svc.factor_cache.get(fp).nbytes
            t_res, up_res = _dispatch_rounds(svc, metrics, A_np, B0_np, ROUNDS19)
            spill_mem = []

            def spill():
                torch.cuda.synchronize()
                b = devmon.bytes_in_use(dev)
                svc.arena.spill(lane, keep_frac=0.0)
                spill_mem.append((b, devmon.bytes_in_use(dev)))

            t_up, up_up = _dispatch_rounds(svc, metrics, A_np, B0_np, ROUNDS19, spill)
            freed = min(b - a for b, a in spill_mem)
            check(up_res == 0 and up_up == pack, f"fabric {dtype}: uploads resident {up_res}, "
                  f"after spill {up_up} (pack {pack})")
            check(freed >= pack, f"fabric {dtype}: spill freed {freed} bytes < pack {pack}")

            def invalidate():
                svc.factor_cache.invalidate(fp)
                svc.arena.drop(fp)

            t_miss, _ = _dispatch_rounds(svc, metrics, A_np, B0_np, MISS_ROUNDS19, invalidate)
            t_app, t_ref = [], []
            for _ in range(MISS_ROUNDS19):
                Cn = torch.randn(APPEND19, n, generator=gen, device=dev, dtype=dt).cpu().numpy()
                t_app.append(_event_ms(lambda: sess.append(Cn)))
                t_ref.append(_event_ms(sess.refactor))
        finally:
            svc.stop()
        del sess
        torch.cuda.empty_cache()
        svc, sess, Xu, x2u, row["unarmed"] = fabric_leg(serve, fabric, pk, qf, metrics, ops,
                                                        False, dtype, dev)
        try:
            t_unarmed, up_un = _dispatch_rounds(svc, metrics, A_np, B0_np, ROUNDS19)
        finally:
            svc.stop()
        del sess
        same = (Xa.dtype == Xu.dtype and Xa.tobytes() == Xu.tobytes()
                and x2a.tobytes() == x2u.tobytes())
        check(same, f"fabric {dtype}: the unarmed X stream is not byte-identical to the armed")
        b_mb = b_bytes / 1e6
        row.update({
            "pack_bytes": pack,
            "resident_hit_ms": t_res, "resident_hit_h2d_bytes": up_res + b_bytes,
            "reupload_hit_ms": t_up, "reupload_hit_h2d_bytes": up_up + b_bytes,
            "unarmed_hit_ms": t_unarmed, "unarmed_hit_h2d_bytes": up_un + b_bytes,
            "miss_ms": t_miss, "miss_h2d_bytes": A_np.nbytes + b_bytes,
            "append_ms": statistics.median(t_app), "refactor_ms": statistics.median(t_ref),
            "spill_bytes_in_use": spill_mem[0], "byte_identical": same,
            "report_rc": rep.returncode})
        print(f"  fabric {dtype} dispatches (CUDA events, submit to result, medians): "
              f"resident hit {t_res:.3f} ms ({(up_res + b_bytes) / 1e6:.1f} MB host to device), "
              f"after spill {t_up:.3f} ms ({(up_up + b_bytes) / 1e6:.1f} MB), unarmed hit "
              f"{t_unarmed:.3f} ms ({b_mb:.1f} MB), miss {t_miss:.3f} ms "
              f"({(A_np.nbytes + b_bytes) / 1e6:.1f} MB); pack {pack / 1e6:.1f} MB; devmon "
              f"bytes in use before / after spill {spill_mem[0][0] / 1e9:.3f} / "
              f"{spill_mem[0][1] / 1e9:.3f} GB; append of {APPEND19} rows "
              f"{row['append_ms']:.1f} ms against refactor {row['refactor_ms']:.1f} ms; "
              f"armed and unarmed X byte-identical {same}; factor_report.py exit "
              f"{rep.returncode}", flush=True)
        out[dtype] = row
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t19
    print(f"  phase 19: {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: the soak fabric (record, open-loop replay, health timeline)
# ---------------------------------------------------------------------------

TENANTS20 = ("gold:weight=4;good:weight=2;free:rate=300,share=0.5;"
             "abuser:rate=60,burst=16,share=0.25")
INTEGRITY20 = "full,hedge=1.5,cooldown=0.25"
FAULTS20A = "latency:every=97,ms=30;sdc_solve:every=211,seed=3;worker_death:every=1501"
FAULTS20B = "sdc_solve:every=7,seed=5"
FAULTS20C = "latency:every=23,ms=30;sdc_solve:every=53,seed=3;worker_death:every=61"
SITES20 = ("latency", "sdc_solve", "worker_death")
N20, N20_LARGE, NRHS20, BATCH20 = 2048, 4096, 16, 4
RING20 = 262144  # above every leg's span count: the orphan audit never meets an evicting ring
SPAN20_S = 24.0  # the full-width generators' native span, seconds (speed rescales it)
LOAD20 = 0.7  # offered rate over the calibrated closed-loop rate R
RT20 = 1.5  # the round trip's offered rate over R (it checks mixes, not tails)
RT20_N = 30  # leg (c)'s round-trip stream


def _placement20(serve, dev, replicas: int = 2):
    """Two lanes pinned to ``dev`` (cuda:0 on the card: both lanes share it)."""
    return serve.PlacementPolicy(replicas=replicas, devices=[str(dev)])


def _close20(a: dict, b: dict, what: str) -> None:
    """The JAX gate's round-trip tolerance: same keys, each count within
    max(5, 5 %)."""
    check(set(a) == set(b), f"{what}: keys {sorted(a)} != {sorted(b)}")
    for key in a:
        tol = max(5, int(0.05 * a[key]))
        check(abs(a[key] - b[key]) <= tol, f"{what}[{key}]: {a[key]} vs {b[key]}")


def _round_trip20(record, replay, svc, rt_spec, speed, cache, device=None) -> dict:
    """The JAX gate's phase 2: record ``rt_spec`` off the delivery tap,
    replay the recording twice (same seed), hold the mix histograms, the
    repeat-group structure and the delivered counts to the gate's
    tolerances.  The recording's matrix seeds are new, so its pool
    matrices are drawn into ``cache`` first (on ``device``, if given)."""
    rec = record.Recorder().attach()
    rt_res = replay.replay(svc, rt_spec, speed=speed, seed=0, cache=cache)
    rec.detach()
    recorded = rec.rows()
    check(len(recorded) == rt_res["delivered"] + rt_res["typed_errors"],
          f"recorder rows {len(recorded)} != delivered + typed of {rt_res}")
    mix_in = record.mix_histogram(recorded)
    for row in replay.warm_spec(recorded):
        replay.materialize(row, seed=0, cache=cache, device=device)
    runs = []
    for _ in (0, 1):
        r2 = record.Recorder().attach()
        got = replay.replay(svc, recorded, speed=1.0, seed=0, cache=cache)
        rows2 = r2.detach().rows()
        check(len(rows2) == got["delivered"] + got["typed_errors"],
              f"replay recorder rows {len(rows2)} != delivered + typed of {got}")
        check(got["submitted"] == got["delivered"] + got["typed_errors"] + got["refused"],
              f"replay books: {got}")
        runs.append((got, record.mix_histogram(rows2)))
    mix_out = runs[0][1]
    for part in ("tenants", "priorities", "shapes"):
        _close20(mix_in[part], mix_out[part], part)
    # repeat groups: the fingerprints are of the regenerated bytes, so the
    # preserved invariant is the group-size structure
    gs_in = sorted(mix_in["repeat_groups"].values())
    gs_out = sorted(mix_out["repeat_groups"].values())
    check(abs(len(gs_in) - len(gs_out)) <= 1, f"repeat groups {gs_in} vs {gs_out}")
    check(abs(sum(gs_in) - sum(gs_out)) <= max(10, int(0.05 * sum(gs_in))),
          f"repeat group sizes {gs_in} vs {gs_out}")
    (ra, _), (rb, _) = runs
    tol = max(10, int(0.02 * ra["submitted"]))
    check(abs(ra["delivered"] - rb["delivered"]) <= tol, f"determinism: {ra} vs {rb}")
    return {"recorded": len(recorded), "recording": rt_res, "replays": [ra, rb],
            "mix_in": mix_in["tenants"], "mix_out": mix_out["tenants"],
            "repeat_groups": [gs_in, gs_out]}


def soak_drill(dev) -> dict:
    """Leg (a): ``run_tests.py``'s soak drill (``:1929-2090``) on the
    port at its own sizes, f64: n = 12 / 24, nrhs = 2, about 10^4
    requests, two lanes
    on ``dev`` with every plane armed, latency / SDC / worker-death
    faults, then a replica added, the record -> replay round trip and
    the two-run determinism check, the replica removed.  Dumps the
    metrics JSONL (``$SLATE_TPU_METRICS``) that ``tools/soak_report.py``
    judges."""
    from slate_tpu_torch import serve
    from slate_tpu_torch.aux import faults, metrics, spans
    from slate_tpu_torch.integrity import policy as ipol
    from slate_tpu_torch.ops.hopper import panel_kernels as pk
    from slate_tpu_torch.soak import record, replay
    from slate_tpu_torch.soak.timeline import TimelineSampler

    metrics.on()
    metrics.reset()
    spans.on(ring=RING20)
    spans.clear()
    t0 = time.perf_counter()
    svc = serve.SolverService(
        cache=serve.ExecutableCache(manifest_path=None), batch_max=8, batch_window_s=0.001,
        dim_floor=16, nrhs_floor=4, placement=_placement20(serve, dev),
        retry_backoff_s=0.002, breaker_cooldown_s=0.02, retry_seed=0,
        factor_cache=serve.FactorCache(max_entries=64), tenants=TENANTS20, adaptive=True,
        latency_budget_s=0.5, integrity=ipol.parse_spec(INTEGRITY20))
    out = {"lanes": [r["device"] for r in svc.health()["replicas"]]}
    try:
        for rt, n in (("gesv", 12), ("posv", 12), ("gesv", 24)):
            k = serve.bucket_for(rt, n, n, 2, np.float64, floor=16, nrhs_floor=4)
            svc.cache.ensure_manifest(k, (1, 8))
            # the factor cache dispatches hits onto the solve sibling
            svc.cache.ensure_manifest(k.solve_sibling(), (1, 8))
        svc.warmup()
        spec = replay.merge_specs(
            replay.gen_repeated_a(5000, seed=2, rate_rps=240, distinct=10),
            replay.gen_repeated_a(1500, seed=3, rate_rps=75, distinct=4, routine="posv"),
            replay.gen_multitenant(1800, seed=1, rate_rps=88),
            replay.gen_deadline_storm(800, seed=4, rate_rps=40),
            replay.gen_adversarial_flood(900, seed=5, rate_rps=45),
        )
        rt_spec = replay.merge_specs(
            replay.gen_multitenant(700, seed=11, rate_rps=70),
            replay.gen_repeated_a(500, seed=12, rate_rps=60, distinct=5),
        )
        cache: dict = {}
        # pool-warm both phases' factors, then zero the books: the soak
        # measures the steady state (no cold build, a warm factor cache)
        replay.replay(svc, replay.warm_spec(spec), seed=0, cache=cache)
        replay.replay(svc, replay.warm_spec(rt_spec), seed=0, cache=cache)
        metrics.reset()
        pk.reset_launches()
        faults.configure(FAULTS20A)
        faults.on()
        sampler = TimelineSampler(svc, period_s=0.05).start()
        res = replay.replay(svc, spec, speed=1.0, seed=0, cache=cache)
        faults.reset()
        check(res["submitted"] == res["delivered"] + res["typed_errors"] + res["refused"],
              f"soak main books: {res}")
        out["main"] = res
        out["injected"] = {s: metrics.counters().get(f"faults.injected.{s}", 0) for s in SITES20}
        out["main_launches"] = {k: v for k, v in pk.LAUNCHES.items() if v}
        print(f"  (a) main: {res['submitted']} submitted, {res['delivered']} delivered, "
              f"{res['typed_errors']} typed, {res['refused']} refused, {res['bad_results']} bad, "
              f"{res['requests_per_s']} requests/s ({res['delivered_per_s']} delivered/s to the "
              f"last resolution), p50 {(res['p50_s'] or 0) * 1e3:.1f} ms, "
              f"p99 {(res['p99_s'] or 0) * 1e3:.1f} ms; injected {out['injected']}; launches "
              f"{out['main_launches']}", flush=True)
        # grow the fleet by one lane for the round trip, shrink it after
        added = svc.add_replica()
        with svc._cond:
            fleet = len(svc._replicas)
        check(fleet == 3, f"add_replica: fleet {fleet}")
        out["round_trip"] = _round_trip20(record, replay, svc, rt_spec, 1.0, cache)
        removed = svc.remove_replica(added, drain_timeout=120)
        h = svc.health()
        states = {lane["name"]: lane.get("state") for lane in h["replicas"]}
        check(states.get(removed) == "removed", f"remove_replica: states {states}")
        with svc._cond:
            fleet = len(svc._replicas)
        check(fleet == 2, f"remove_replica: fleet {fleet}")
        term = next(lane for lane in h["replicas"] if lane["name"] == removed)
        check(not term.get("drain_timed_out"), f"remove_replica: the drain timed out: {term}")
        rt = out["round_trip"]
        print(f"  (a) replica {added} added (fleet 3), round trip: {rt['recorded']} recorded, "
              f"mixes agree; determinism {rt['replays'][0]['delivered']} vs "
              f"{rt['replays'][1]['delivered']} delivered; replica {removed} drained and "
              f"removed (fleet 2)", flush=True)
        # a hedged primary whose twin delivered may still run: its root
        # closes when it resolves, so the audit waits for idle lanes, as
        # leg (c)'s does
        _idle(svc)
        out["pressure"] = spans.pressure()
        check(out["pressure"]["evicted"] == 0, f"span ring evicted: {out['pressure']}")
        out["orphans"] = replay.orphan_spans()
        sampler.stop()
        out["sampler_errors"] = sampler.errors
        check(sampler.errors == 0, f"timeline sampler errors: {sampler.errors}")
        svc.stop(drain=True, drain_timeout=300)
    finally:
        svc.stop()
    c = metrics.counters()
    out["books"] = {k: c.get(k, 0) for k in ("soak.submitted", "soak.delivered",
                                             "soak.typed_errors", "soak.refused",
                                             "soak.bad_results", "serve.requests")}
    check(c["serve.requests"] == c["soak.submitted"] - c.get("soak.refused", 0),
          f"admission books: {out['books']}")
    out["timeline_rows"] = len(metrics.timeline())
    out["launches"] = {k: v for k, v in pk.LAUNCHES.items() if v}
    metrics.dump()
    out["seconds"] = time.perf_counter() - t0
    return out


def soak_escape(dev) -> dict:
    """Leg (b): ``run_tests.py``'s escape leg (``:2092-2129``) on the
    port: the integrity plane and the factor cache off,
    ``sdc_solve:every=7`` armed; wrong X must reach the client
    (``soak.bad_results`` > 0)."""
    from slate_tpu_torch import serve
    from slate_tpu_torch.aux import faults, metrics, spans
    from slate_tpu_torch.soak import replay
    from slate_tpu_torch.soak.timeline import TimelineSampler

    metrics.on()
    metrics.reset()
    spans.clear()
    spans.on(ring=8192)
    t0 = time.perf_counter()
    svc = serve.SolverService(cache=serve.ExecutableCache(manifest_path=None), batch_max=8,
                              batch_window_s=0.001, dim_floor=16, nrhs_floor=4,
                              placement=_placement20(serve, dev), factor_cache=False,
                              integrity=False)
    try:
        check(svc._integrity is None and svc.factor_cache is None, "escape leg: a defense is on")
        k = serve.bucket_for("gesv", 12, 12, 2, np.float64, floor=16, nrhs_floor=4)
        svc.cache.ensure_manifest(k, (1, 8))
        svc.warmup()
        metrics.reset()
        spec = replay.gen_repeated_a(400, seed=7, rate_rps=200, distinct=4)
        faults.configure(FAULTS20B)
        faults.on()
        sampler = TimelineSampler(svc, period_s=0.05).start()
        res = replay.replay(svc, spec, speed=1.0, seed=0)
        faults.reset()
        sampler.stop()
        check(spans.pressure()["evicted"] == 0, f"escape ring evicted: {spans.pressure()}")
        orphans = replay.orphan_spans()
        svc.stop(drain=True, drain_timeout=120)
    finally:
        svc.stop()
    metrics.dump()
    check(res["bad_results"] > 0, f"the undefended soak delivered no wrong X: {res}")
    return {"res": res, "orphans": orphans, "sampler_errors": sampler.errors,
            "seconds": time.perf_counter() - t0}


# The fresh interpreter of legs (a) and (b), the port alone, under the
# checked runtime (SLATE_TPU_SYNC_CHECK in its env, decided at lock
# construction): argv dir, device.  One JSON line out.
_CHILD20 = r"""
import json, sys
import chip_smoke as cs
print(json.dumps(cs.child20(sys.argv[1], sys.argv[2])))
"""


def child20(tmp: str, device: str) -> dict:
    """Legs (a) and (b) in one interpreter, each dumping its own JSONL."""
    import os

    from slate_tpu_torch.aux import sync
    from slate_tpu_torch.ops.hopper import panel_kernels as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    if dev.type == "cuda":
        pk._load()
    out = {"armed": sync.is_on()}
    os.environ["SLATE_TPU_METRICS"] = os.path.join(tmp, "soak.jsonl")
    out["drill"] = soak_drill(dev)
    os.environ["SLATE_TPU_METRICS"] = os.path.join(tmp, "escape.jsonl")
    out["escape"] = soak_escape(dev)
    rep = sync.report()
    out["violations"] = [{k: v[k] for k in ("kind", "detail")} for v in rep["violations"]]
    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slate_tpu"))
    return out


def _soak_report(path: str, *args) -> subprocess.CompletedProcess:
    return _tool("soak_report.py", path, *args)


def _report_module(name: str = "soak_report"):
    """One of tools/*_report.py as a module (stdlib only): the soak
    report's disruption intervals and bucket tails, the capacity report's
    over-provision ratio."""
    import importlib.util
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{name}", os.path.join(here, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def soak_gate_legs(dev, tmp: str) -> dict:
    """Legs (a) and (b) in a fresh interpreter armed by
    SLATE_TPU_SYNC_CHECK=1, judged by tools/soak_report.py with the JAX
    gate's arguments (``run_tests.py`` ``soak_gate``)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here, "SLATE_TPU_SYNC_CHECK": "1"}
    for var in ("SLATE_TPU_FAULTS", "SLATE_TPU_FACTOR_CACHE", "SLATE_TPU_TENANTS",
                "SLATE_TPU_ADAPTIVE", "SLATE_TPU_INTEGRITY", "SLATE_TPU_WARMUP",
                "SLATE_TPU_ARTIFACTS", "SLATE_TPU_METRICS"):
        env.pop(var, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD20, tmp, str(dev)], cwd=here, env=env,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.strip().splitlines()[:-1]:
        print(line, flush=True)
    check(proc.returncode == 0, f"phase 20 child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    got["process_wall_s"] = time.perf_counter() - t0
    check(got["armed"] and got["jax_modules"] == [],
          f"soak child: armed {got['armed']}, imported {got['jax_modules']}")
    check(got["violations"] == [], f"soak drill: sync violations {got['violations']}")
    dr, es = got["drill"], got["escape"]
    check(set(dr["lanes"]) == {str(dev)} and len(dr["lanes"]) == 2, f"drill lanes {dr['lanes']}")
    check(dr["orphans"] == 0 and dr["sampler_errors"] == 0 and dr["main"]["bad_results"] == 0,
          f"drill: orphans {dr['orphans']}, sampler errors {dr['sampler_errors']}, "
          f"main {dr['main']}")
    rep = _soak_report(os.path.join(tmp, "soak.jsonl"), "--p99-budget-ms", "2000",
                       "--tenant-p99-budget-ms", "2000", "--min-timeline-rows", "50",
                       "--min-delivered", "5000")
    print("  (a) tools/soak_report.py (the gate's arguments): "
          + " / ".join(rep.stdout.strip().splitlines()), flush=True)
    check(rep.returncode == 0, f"soak_report exited {rep.returncode} on the drill")
    esc = _soak_report(os.path.join(tmp, "escape.jsonl"))
    print(f"  (b) escape: {es['res']['bad_results']} wrong X delivered of "
          f"{es['res']['delivered']} (integrity and factor cache off, {FAULTS20B}); "
          f"soak_report.py exit {esc.returncode}", flush=True)
    check(esc.returncode != 0, "soak_report passed the undefended escape stream")
    print(f"  (a)+(b): sync violations {len(got['violations'])}, drill "
          f"{dr['seconds']:.1f} s, escape {es['seconds']:.1f} s, child "
          f"{got['process_wall_s']:.1f} s", flush=True)
    return {"drill": dr, "escape": es, "violations": got["violations"],
            "drill_report_rc": rep.returncode, "escape_report_rc": esc.returncode,
            "child_wall_s": got["process_wall_s"]}


def _width_spec(replay, dtype: str, tight_s: float) -> list:
    """Leg (c)'s mix: the five generators at the serve tier's width, 120
    requests in the JAX drill's proportions, each stream spread over
    ``SPAN20_S`` seconds of native time."""
    r = lambda k: k / SPAN20_S  # noqa: E731
    rows = replay.merge_specs(
        replay.gen_repeated_a(60, seed=2, rate_rps=r(60), n=N20, nrhs=NRHS20, distinct=4),
        replay.gen_repeated_a(18, seed=3, rate_rps=r(18), n=N20, nrhs=NRHS20, distinct=2,
                              routine="posv"),
        replay.gen_multitenant(22, seed=1, rate_rps=r(22), n_small=N20, n_large=N20_LARGE,
                               nrhs=NRHS20, distinct=4),
        replay.gen_deadline_storm(10, seed=4, rate_rps=r(10), n=N20, nrhs=NRHS20,
                                  tight_s=tight_s, slack_s=60.0),
        replay.gen_adversarial_flood(10, seed=5, rate_rps=r(10), n_flood=N20_LARGE,
                                     n_victim=N20, nrhs=NRHS20, distinct=4),
    )
    for row in rows:
        row["dtype"] = dtype
    return rows


def _pct(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(p / 100.0 * len(xs))))]


def soak_width_leg(serve, metrics, pk, dtype: str, dev, tmp: str) -> dict:
    """Leg (c), one dtype: calibration (the warm prelude, then a
    closed-loop stream of 24 rows of the mix: rate R, p50, p99), then the
    120-request mix open loop at ``LOAD20`` R under latency / SDC /
    worker-death faults with the recorder and the timeline on, judged by
    tools/soak_report.py at 4 x the calibration p99; a profiled slice of
    20 requests; the round trip of a ``RT20_N``-request multitenant stream."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from slate_tpu_torch.aux import faults, spans
    from slate_tpu_torch.integrity import policy as ipol
    from slate_tpu_torch.soak import record, replay
    from slate_tpu_torch.soak.timeline import TimelineSampler

    t0 = time.perf_counter()
    np_dt = np.dtype(dtype)
    cache = serve.ExecutableCache(manifest_path=None)
    for rt, n in (("gesv", N20), ("posv", N20), ("gesv", N20_LARGE)):
        k = serve.bucket_for(rt, n, n, NRHS20, np_dt)
        cache.ensure_manifest(k, (1, BATCH20))
        cache.ensure_manifest(k.solve_sibling(), (1, BATCH20))
    fc = serve.FactorCache(max_entries=64)
    ops: dict = {}  # materialize's cache, shared by every replay of this dtype
    common = dict(cache=cache, factor_cache=fc, placement=_placement20(serve, dev),
                  batch_max=BATCH20, batch_window_s=0.002, tenants=TENANTS20,
                  integrity=ipol.parse_spec(INTEGRITY20), retry_backoff_s=0.002,
                  breaker_cooldown_s=0.02)
    rt_spec = replay.gen_multitenant(RT20_N, seed=11, rate_rps=RT20_N / SPAN20_S, n_small=N20,
                                     n_large=N20_LARGE, nrhs=NRHS20, distinct=4)
    for row in rt_spec:
        row["dtype"] = dtype
    # calibration: a service without the adaptive plane warms every pool
    # (the misses run the factor kernels), then a closed loop
    cal = serve.SolverService(**common)
    try:
        cal.warmup()
        spec0 = _width_spec(replay, dtype, tight_s=1.0)
        # the card draws a large A's philox bits: the bytes of the host's
        t_g = time.perf_counter()
        on_card = replay.materialize(spec0[0], seed=0, device=dev)
        t_card = time.perf_counter() - t_g
        t_g = time.perf_counter()
        on_host = replay.materialize(spec0[0], seed=0)
        t_host = time.perf_counter() - t_g
        check(all(a.tobytes() == b.tobytes() for a, b in zip(on_card, on_host)),
              f"{dtype}: materialize on the card differs from the host's")
        # each pool's A, drawn once with the card's philox into the cache
        # that every replay of this dtype reads; four threads, since
        # numpy's transform and products release the GIL
        t_g = time.perf_counter()
        pools = replay.warm_spec(spec0 + rt_spec)
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda row: replay.materialize(row, seed=0, cache=ops, device=dev),
                        pools))
        t_pools = time.perf_counter() - t_g
        pk.reset_launches()
        t_w = time.perf_counter()
        replay.replay(cal, pools, seed=0, cache=ops)
        t_warm = time.perf_counter() - t_w
        warm_launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        lat = []
        t_c = time.perf_counter()
        for row in spec0[::5]:  # 24 rows of the mix
            A, B = replay.materialize(row, seed=0, cache=ops)
            ts = time.perf_counter()
            cal.submit(row["routine"], A, B, tenant=row["tenant"],
                       priority=row["priority"]).result(timeout=600)
            lat.append(time.perf_counter() - ts)
        t_cal = time.perf_counter() - t_c
    finally:
        cal.stop()
    R = len(lat) / t_cal
    p50, p99 = _pct(lat, 50), _pct(lat, 99)
    budget_s = 4 * p99
    spec = _width_spec(replay, dtype, tight_s=p50 / 2)
    native = len(spec) / max(r["t_offset"] for r in spec)
    speed = LOAD20 * R / native
    print(f"  (c) {dtype}: materialize of a {N20} A, bytes equal: {t_card:.3f} s with the "
          f"card's philox, {t_host:.3f} s on the host; {len(pools)} pool matrices drawn in "
          f"{t_pools:.1f} s; warm prelude {t_warm:.1f} s (launches "
          f"{warm_launches}); "
          f"calibration {len(lat)} closed-loop requests: R {R:.3f} requests/s, p50 "
          f"{p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms; speed {speed:.4f}, offered "
          f"{native * speed:.3f} requests/s ({LOAD20} R), budget {budget_s * 1e3:.1f} ms, "
          f"tight deadline {p50 / 2 * 1e3:.1f} ms", flush=True)
    svc = serve.SolverService(adaptive=True, latency_budget_s=budget_s, **common)
    out = {"R": R, "cal_p50_s": p50, "cal_p99_s": p99, "speed": speed,
           "materialize_s": {"card": t_card, "host": t_host, "pools": t_pools},
           "offered_rps": native * speed, "budget_s": budget_s, "warm_s": t_warm,
           "warm_launches": warm_launches,
           "lanes": [r["device"] for r in svc.health()["replicas"]]}
    path = os.path.join(tmp, f"width_{dtype}.jsonl")
    try:
        svc.warmup()
        spans.on(ring=RING20)
        spans.clear()
        metrics.reset()
        pk.reset_launches()
        faults.configure(FAULTS20C)
        faults.on()
        rec = record.Recorder()
        with rec, TimelineSampler(svc, period_s=0.05) as sampler:
            res = replay.replay(svc, spec, speed=speed, seed=0, cache=ops)
            faults.reset()
            _idle(svc)
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        check(len(rec) == res["delivered"] + res["typed_errors"],
              f"{dtype}: recorder rows {len(rec)} != delivered + typed of {res}")
        pressure = spans.pressure()
        check(pressure["evicted"] == 0, f"{dtype}: span ring evicted {pressure}")
        orphans = replay.orphan_spans()
        c = metrics.counters()
        injected = {s: c.get(f"faults.injected.{s}", 0) for s in SITES20}
        books = {k: c.get(k, 0) for k in ("soak.submitted", "soak.delivered",
                                          "soak.typed_errors", "soak.refused",
                                          "serve.requests", "serve.shed",
                                          "serve.deadline_miss", "serve.worker_restarts",
                                          "serve.integrity.fail", "serve.factor_cache.stale",
                                          "serve.hedge.sent", "jit.compilations")}
        metrics.dump(path)
        # one profiled slice of 20 requests of the mix, same pacing
        window = spec[50:70]
        base = window[0]["t_offset"]
        window = [dict(r, t_offset=r["t_offset"] - base) for r in window]
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CUDA if dev.type == "cuda" else act.CPU]
                                    ) as prof:
            t_p = time.perf_counter()
            slice_res = replay.replay(svc, window, speed=speed, seed=0, cache=ops)
            _idle(svc)
            t_prof = time.perf_counter() - t_p
        busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e6
        rt = _round_trip20(record, replay, svc, rt_spec, RT20 * R / (RT20_N / SPAN20_S), ops,
                           dev)
    finally:
        faults.reset()
        svc.stop()
    rep = _soak_report(path, "--p99-budget-ms", f"{budget_s * 1e3:.3f}",
                       "--min-timeline-rows", "20", "--min-delivered", "90")
    mod = _report_module().analyze(path, p99_budget_ms=budget_s * 1e3)
    hists = {s: {"p50_ms": h["p50"] * 1e3, "p99_ms": h["p99"] * 1e3, "count": h["count"]}
             for s, h in ((n[len("serve.latency."):-len(".total")], h)
                          for n, h in mod["data"]["hists"].items()
                          if n.startswith("serve.latency.") and n.endswith(".total")
                          and not n.startswith(("serve.latency.tenant.",
                                                "serve.latency.replica.")))}
    intervals = [{"signal": iv["signal"], "t_start": iv["t_start"],
                  "duration_s": iv["duration_s"], "recovered": iv["recovered"]}
                 for iv in mod["intervals"]]
    out.update({"main": res, "delivered_per_s": res["delivered_per_s"],
                "buckets": hists, "intervals": intervals, "launches": launches,
                "injected": injected, "books": books, "orphans": orphans,
                "sampler_errors": sampler.errors, "timeline_rows": len(mod["data"]["timeline"]),
                "report_rc": rep.returncode, "profiled": {
                    "requests": len(window), "wall_s": t_prof, "busy_ms": busy * 1e3,
                    "idle_share": max(0.0, 1 - busy / t_prof), "res": slice_res},
                "round_trip": rt, "seconds": time.perf_counter() - t0})
    print(f"  (c) {dtype}: {res['submitted']} submitted, {res['delivered']} delivered, "
          f"{res['typed_errors']} typed, {res['refused']} refused, {res['bad_results']} bad; "
          f"last submission {res['submit_wall_s']:.3f} s, last resolution "
          f"{res['resolve_wall_s']:.3f} s (delivered {res['delivered_per_s']:.3f} requests/s), "
          f"client checks done {res['wall_s']:.3f} s, largest residual "
          f"{res['max_residual']:.3e}; injected "
          f"{injected}; orphans {orphans}; sampler errors {sampler.errors}; books {books}",
          flush=True)
    for s, h in sorted(hists.items()):
        print(f"    {s}: n {h['count']}, p50 {h['p50_ms']:.1f} ms, p99 {h['p99_ms']:.1f} ms",
              flush=True)
    print(f"    disruptions: {intervals or 'none'}; launches {launches}; profiled slice: "
          f"{len(window)} requests, device busy {busy * 1e3:.1f} ms of {t_prof:.3f} s "
          f"(idle share {out['profiled']['idle_share']:.4f})", flush=True)
    print(f"    round trip: {rt['recorded']} recorded, replays {rt['replays'][0]['delivered']} "
          f"/ {rt['replays'][1]['delivered']} delivered; soak_report.py (p99 budget "
          f"{budget_s * 1e3:.1f} ms): " + " / ".join(rep.stdout.strip().splitlines()[-14:]),
          flush=True)
    check(set(out["lanes"]) == {str(dev)} and len(out["lanes"]) == 2, f"lanes {out['lanes']}")
    check(rep.returncode == 0, f"{dtype}: soak_report exited {rep.returncode}")
    check(res["bad_results"] == 0 and orphans == 0 and sampler.errors == 0,
          f"{dtype}: bad {res['bad_results']}, orphans {orphans}, sampler {sampler.errors}")
    check(all(v >= 1 for v in injected.values()), f"{dtype}: a fault site never fired {injected}")
    check(launches.get("trsm_lower", 0) > 0 and launches.get("trsm_upper", 0) > 0,
          f"{dtype}: the hits launched no trsm pair: {launches}")
    check(all(warm_launches.get(k, 0) > 0 for k in ("chol_base", "syrk_diag", "gemm_sub",
                                                    "panel_lu")),
          f"{dtype}: the misses launched no factor kernel: {warm_launches}")
    return out


def soak_main(serve, metrics, pk, dev) -> dict:
    """Phase 20: legs (a) and (b) in a checked child, then leg (c) in
    f64 and f32 here."""
    import tempfile

    t20 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="slate_soak_") as tmp:
        out["gate"] = soak_gate_legs(dev, tmp)
        metrics.on()
        for d in DTYPES:
            out[d] = soak_width_leg(serve, metrics, pk, d, dev, tmp)
            torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t20
    print(f"  phase 20: {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 21: the elastic capacity plane
# ---------------------------------------------------------------------------

#: leg (a): run_tests.py's _SCALE_DRIVER as written (its policy, budget, tax)
POLICY21 = ("min=1,max=3,up=1.0,down=0.2,up_cooldown=0.25,down_cooldown=2.0,step=2,"
            "period=0.05")
BUDGET21_S = 1.0
TAX21 = "latency:every=1,ms=12"
#: leg (b): the serve tier's width, gesv repeated-A, batch point 1
N21, NRHS21 = 2048, 16
HITS21 = 24  # requests of each closed-loop measurement
CLIENTS21 = 4  # closed-loop clients: one lane is never starved for work
T21_MS = 50  # the first tax tried
LANE21_RPS = 60.0  # the JAX drill's one lane at its 12 ms tax: the time scale s = 60 / R1(T)
S21_MAX = 4.0  # past this time scale f64 yields to f32
REQUESTS21 = 500  # the JAX drill's trace, cut below to end ~1.0 s after the burst


def _lanes21(dev) -> list:
    """Lane devices: cuda:0 for every lane on the card; in a CPU rehearsal
    three CPU device ids, so a new lane's prime is a real first run."""
    return [str(dev)] if dev.type == "cuda" else ["cpu", "cpu:1", "cpu:2"]


def _watch21(svc, snaps: list) -> None:
    """Append every snapshot the service's autoscaler folds to ``snaps``
    (build the service paused, so its sampling thread misses none)."""
    agg = svc._scaler.aggregator
    fold = agg.update

    def update(raw):
        snap = fold(raw)
        snaps.append(snap)
        return snap

    agg.update = update


def _checks21(snaps, counters, dev, what: str) -> dict:
    """The swallowed-error counters are 0, and every snapshot's
    device-memory headroom is a float in (0, 1] on the card (a None there
    is devmon failing quietly), None on a CPU lane."""
    errs = {k: counters.get(k, 0) for k in ("scale.step_errors", "scale.add_failed",
                                            "scale.remove_failed")}
    check(not any(errs.values()), f"{what}: the autoscaler swallowed errors: {errs}")
    hs = [s.hbm_headroom_frac for s in snaps]
    check(bool(hs), f"{what}: the autoscaler took no snapshot")
    if dev.type == "cuda":
        check(all(isinstance(h, float) and 0 < h <= 1 for h in hs),
              f"{what}: a snapshot's headroom is not a float in (0, 1]: {sorted(set(hs))[:5]}")
    else:
        check(all(h is None for h in hs), f"{what}: a CPU lane reported headroom")
    return {"errors": errs, "snapshots": len(hs),
            "headroom": [min(hs), max(hs)] if dev.type == "cuda" else None}


class _Peak21:
    """The fleet's high-water mark, sampled every 20 ms (the JAX drill's
    watcher thread)."""

    def __init__(self, svc):
        import threading

        self.svc, self.peak = svc, 1
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            with self.svc._cond:
                n = len(self.svc._replicas)
            self.peak = max(self.peak, n)
            time.sleep(0.02)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(2)


def _settle21(svc, timeout_s: float) -> int:
    """Wait until the autoscaler has given the burst's lanes back (the
    JAX drill's quiet tail); returns the fleet at the end."""
    deadline = time.monotonic() + timeout_s
    while True:
        with svc._cond:
            n = len(svc._replicas)
        if n == 1 or time.monotonic() >= deadline:
            return n
        time.sleep(0.05)


def scale_drill(device: str, tmp: str) -> dict:
    """Leg (a): ``run_tests.py``'s burst drill (``_SCALE_DRIVER``,
    :2220-2337) on the port as written, f64: ``gen_burst(500, seed=9,
    base_rps=30, burst_rps=120, burst_start_s=1.0, burst_len_s=2.0, n=12,
    nrhs=2, distinct=4)`` saved and loaded as a spec, batch point 1,
    floors 16 / 4, a factor cache of 16 and an artifact store, under
    ``latency:every=1,ms=12``: a static leg (one lane, no scaler), then the
    elastic leg under ``POLICY21``, the gate's gauges and
    ``metrics.dump()`` ($SLATE_TPU_METRICS), which
    ``tools/capacity_report.py`` judges.  Every lane on ``device`` (three
    CPU ids in a CPU rehearsal)."""
    import os

    from slate_tpu_torch import serve
    from slate_tpu_torch.aux import faults, metrics, spans
    from slate_tpu_torch.scale import gate
    from slate_tpu_torch.soak import record, replay

    dev = torch.device(device)
    art, trace = os.path.join(tmp, "artifacts"), os.path.join(tmp, "burst.jsonl")
    metrics.on()
    metrics.reset()
    spans.on(ring=65536)
    t0 = time.perf_counter()
    spec = replay.gen_burst(500, seed=9, base_rps=30, burst_rps=120, burst_start_s=1.0,
                            burst_len_s=2.0, n=12, nrhs=2, distinct=4)
    record.save(spec, trace, source="gen_burst")
    rows = record.load(trace)
    snaps: list = []

    def build():
        svc = serve.SolverService(
            cache=serve.ExecutableCache(manifest_path=None, artifact_dir=art), batch_max=1,
            batch_window_s=0.0005, dim_floor=16, nrhs_floor=4,
            placement=serve.PlacementPolicy(replicas=1, devices=_lanes21(dev)),
            factor_cache=serve.FactorCache(max_entries=16), start=False)
        if svc._scaler is not None:
            _watch21(svc, snaps)
        svc.start()
        k = serve.bucket_for("gesv", 12, 12, 2, np.float64, floor=16, nrhs_floor=4)
        svc.cache.ensure_manifest(k, (1,))
        svc.cache.ensure_manifest(k.solve_sibling(), (1,))
        svc.warmup()
        # the factor pool warmed with the replay's seed: the legs hit
        replay.replay(svc, replay.warm_spec(rows), speed=1.0, seed=0)
        return svc

    faults.configure(TAX21)
    os.environ.pop("SLATE_TPU_SCALE", None)
    svc = build()
    try:
        check(svc._scaler is None, "scaler armed without SLATE_TPU_SCALE")
        faults.on()
        res_static = replay.replay(svc, rows, speed=1.0, seed=0)
        faults.off()  # off, not reset: the elastic leg re-arms the same tax
        svc.stop(drain=True, drain_timeout=120)
    finally:
        svc.stop()
    print(f"  (a) static leg: p99 {(res_static['p99_s'] or 0) * 1e3:.1f} ms over "
          f"{res_static['submitted']} requests", flush=True)
    os.environ["SLATE_TPU_SCALE"] = POLICY21
    svc = build()
    try:
        check(svc._scaler is not None, "SLATE_TPU_SCALE failed to arm")
        metrics.reset()  # the evidence window: the measured replay only
        with _Peak21(svc) as peak:
            faults.on()
            res_elastic = replay.replay(svc, rows, speed=1.0, seed=0)
            faults.reset()  # the tail drains untaxed
            n_end = _settle21(svc, 30.0)
        c = metrics.counters()
        compiles = int(c.get("jit.compilations", 0))
        # a new lane's prime inside add_replica is a counted first run
        # (serve.device_primes, pre-traffic): steady state = total - primes
        primes = int(c.get("serve.device_primes", 0))
        gate.publish({
            "static_p99_s": res_static["p99_s"] or 0.0,
            "elastic_p99_s": res_elastic["p99_s"] or 0.0,
            "budget_s": BUDGET21_S, "replica_peak": peak.peak, "replicas_end": n_end,
            "min_replicas": 1, "max_replicas": 3, "up_threshold": 1.0,
            "new_lane_compiles": compiles - primes, "device_primes": primes,
        })
        out = {"static": res_static, "elastic": res_elastic, "peak": peak.peak,
               "end": n_end, "compiles": compiles, "device_primes": primes,
               "counters": {k: v for k, v in c.items() if k.startswith("scale.")},
               "timeline": [{k: r.get(k) for k in ("t_mono", "pressure", "action", "delta",
                                                     "reason", "replicas")}
                            for r in metrics.timeline() if r.get("kind") == "scale"],
               "lanes": sorted({str(r["device"]) for r in svc.health()["replicas"]})}
        out.update(_checks21(snaps, c, dev, "(a)"))
        svc.stop(drain=True, drain_timeout=120)
    finally:
        svc.stop()
        os.environ.pop("SLATE_TPU_SCALE", None)
    metrics.dump()
    out["seconds"] = time.perf_counter() - t0
    print(f"  (a) elastic leg: p99 {(res_elastic['p99_s'] or 0) * 1e3:.1f} ms, peak "
          f"{peak.peak} lanes, end {n_end}, steady-state cold builds {compiles - primes} "
          f"({primes} pre-traffic lane primes)", flush=True)
    return out


# The fresh interpreter of leg (a), the port alone, under the checked
# runtime (SLATE_TPU_SYNC_CHECK in its env): argv dir, device.  One JSON
# line out.
_CHILD21 = r"""
import json, sys
import chip_smoke as cs
print(json.dumps(cs.child21(sys.argv[1], sys.argv[2])))
"""


def child21(tmp: str, device: str) -> dict:
    """Leg (a) in one interpreter, dumping to ``tmp``/scale.jsonl."""
    import os

    from slate_tpu_torch.aux import sync
    from slate_tpu_torch.ops.hopper import panel_kernels as pk

    dev = torch.device(device)
    if dev.type == "cuda":
        pk._load()
    out = {"armed": sync.is_on()}
    os.environ["SLATE_TPU_METRICS"] = os.path.join(tmp, "scale.jsonl")
    pk.reset_launches()
    out["drill"] = scale_drill(device, tmp)
    out["launches"] = {k: v for k, v in pk.LAUNCHES.items() if v}
    rep = sync.report()
    out["violations"] = [{k: v[k] for k in ("kind", "detail")} for v in rep["violations"]]
    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slate_tpu"))
    return out


def _report_lines(proc) -> str:
    """A report tool's verdict on one line."""
    return " / ".join(line.strip() for line in proc.stdout.strip().splitlines() if line.strip())


def scale_gate_leg(dev, tmp: str) -> dict:
    """Leg (a) in a fresh interpreter armed by SLATE_TPU_SYNC_CHECK=1,
    judged by tools/capacity_report.py (``run_tests.py`` ``scale_gate``)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here, "SLATE_TPU_SYNC_CHECK": "1"}
    for var in ("SLATE_TPU_FAULTS", "SLATE_TPU_FACTOR_CACHE", "SLATE_TPU_TENANTS",
                "SLATE_TPU_ADAPTIVE", "SLATE_TPU_INTEGRITY", "SLATE_TPU_WARMUP",
                "SLATE_TPU_ARTIFACTS", "SLATE_TPU_SCALE", "SLATE_TPU_METRICS"):
        env.pop(var, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD21, tmp, str(dev)], cwd=here, env=env,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.strip("\n").splitlines()[:-1]:
        print(line, flush=True)
    check(proc.returncode == 0, f"phase 21 child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    wall = time.perf_counter() - t0
    check(got["armed"] and got["jax_modules"] == [],
          f"scale child: armed {got['armed']}, imported {got['jax_modules']}")
    check(got["violations"] == [], f"burst drill: sync violations {got['violations']}")
    dr = got["drill"]
    check(dr["lanes"] == sorted(set(_lanes21(dev))), f"drill lanes {dr['lanes']}")
    rep = _tool("capacity_report.py", os.path.join(tmp, "scale.jsonl"))
    print(f"  (a) timeline {dr['timeline']}", flush=True)
    print(f"  (a) counters {dr['counters']}; snapshots {dr['snapshots']}, headroom "
          f"{dr['headroom']}; sync violations {len(got['violations'])}; child {wall:.1f} s "
          f"(drill {dr['seconds']:.1f} s)", flush=True)
    print("  (a) tools/capacity_report.py: " + _report_lines(rep), flush=True)
    check(rep.returncode == 0, f"capacity_report exited {rep.returncode} on the burst drill")
    check(dr["peak"] <= 3 and dr["end"] == 1, f"drill fleet: peak {dr['peak']}, end {dr['end']}")
    # n = 12 is below the kernels' crossover: the library routes, no launch
    check(got["launches"] == {}, f"(a) launched kernels: {got['launches']}")
    return {"drill": dr, "violations": got["violations"], "report_rc": rep.returncode,
            "child_wall_s": wall}


class _Keep21:
    """A service proxy for ``replay``: keeps each request's A, B, future,
    submit and resolution times, so that every delivered X is held to the
    residual bound after the leg and the burst's deliveries counted."""

    def __init__(self, svc):
        self.svc, self.kept = svc, []

    def submit(self, routine, A, B, **kw):
        item = {"A": A, "B": B, "t_submit": time.monotonic(), "t_done": None}
        item["f"] = f = self.svc.submit(routine, A, B, **kw)
        f.add_done_callback(lambda _f: item.__setitem__("t_done", time.monotonic()))
        self.kept.append(item)
        return f


def _residual21(kept, dev) -> float:
    """The largest scaled residual ||AX - B||_1 / (||A||_1 ||X||_1 n eps)
    of the delivered X (each distinct A moved to the card once)."""
    worst, on_dev = 0.0, {}
    for it in kept:
        X = it["f"].result(timeout=600)
        A = on_dev.get(id(it["A"]))
        if A is None:
            A = on_dev[id(it["A"])] = torch.from_numpy(it["A"]).to(dev)
        worst = max(worst, scaled_residual(A, torch.from_numpy(X).to(dev),
                                           torch.from_numpy(it["B"]).to(dev)))
    return worst


def _closed21(svc, rows, ops, clients: int = CLIENTS21):
    """``clients`` threads in closed loop over ``rows`` (each submits its
    next row when its last one resolves); returns (wall s, kept items)."""
    import threading

    from slate_tpu_torch.soak import replay

    keep, errors = _Keep21(svc), []

    def client(part):
        try:
            for row in part:
                A, B = replay.materialize(row, seed=0, cache=ops)
                keep.submit(row["routine"], A, B).result(timeout=600)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(rows[i::clients],))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not errors and len(keep.kept) == len(rows), f"closed loop: {errors}")
    return wall, keep.kept


def _busy_s(prof) -> float:
    return sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e6


def _submit_p50(serve, replay, rows, ops, dev) -> float:
    """The client's submit time, p50 over HITS21 calls into a paused
    service: the host work of a live submit (validation, bucketing, the
    sha256 fingerprint of A); its inverse is the open-loop pacer's ceiling
    P."""
    svc = serve.SolverService(placement=serve.PlacementPolicy(devices=[str(dev)]),
                              factor_cache=serve.FactorCache(max_entries=16), batch_max=1,
                              start=False)
    ts = []
    try:
        for row in rows[:HITS21]:
            A, B = replay.materialize(row, seed=0, cache=ops)
            t = time.perf_counter()
            svc.submit(row["routine"], A, B)
            ts.append(time.perf_counter() - t)
    finally:
        svc.stop()
    return statistics.median(ts)


def scale_width_leg(serve, metrics, pk, lk, dev, tmp: str) -> dict:
    """Legs (b) and (c): the burst drill at the serve tier's width (gesv
    repeated-A, n = 2048, nrhs = 16, tiles of 64, batch point 1, a factor
    cache of 16, every lane on ``dev``).  (b1) one card's lane scaling:
    the closed-loop rate R1..R3 of 24 hits with 1, 2, 3 lanes, no fault,
    and the device's idle share over each.  (b2) calibration: the pacer's
    ceiling P, a tax T raised until 2 R1(T) <= P / 2.  (b3) the JAX drill
    time-scaled by s = 60 / R1(T): static leg, then elastic leg, judged by
    tools/capacity_report.py.  (c) the warmup plan of the elastic leg's
    recorded rows, applied by ``add_replica(plan=)``.  f64 unless its P
    cannot give s <= 4, then f32."""
    import math
    import os

    from slate_tpu_torch.aux import devmon, faults
    from slate_tpu_torch.scale import gate
    from slate_tpu_torch.scale import warmup_plan as wp
    from slate_tpu_torch.soak import record, replay

    t21 = time.perf_counter()
    os.environ.pop("SLATE_TPU_SCALE", None)
    out: dict = {}

    def pool(dtype):
        """The drill's four pool rows and 24 hit rows over them, at this
        width and dtype; each A drawn once with the card's philox."""
        rows = replay.gen_burst(HITS21 + 4, seed=9, n=N21, nrhs=NRHS21, distinct=4)
        for r in rows:
            r["dtype"] = dtype
        ops: dict = {}
        pools = replay.warm_spec(rows)
        for row in pools:
            replay.materialize(row, seed=0, cache=ops, device=dev)
        return pools, rows[:HITS21], ops

    # the dtype: f64 keeps 2 R1(T) <= P / 2 with s <= 4 only when its
    # pacer's ceiling reaches 4 x 60 / 4 requests/s
    need_p = 4 * LANE21_RPS / S21_MAX
    pools, hits, ops = pool("float64")
    p64 = 1 / _submit_p50(serve, replay, hits, ops, dev)
    dtype = "float64" if p64 >= need_p else "float32"
    out["pacer_ceiling_f64_rps"] = p64
    if dtype == "float32":
        pools, hits, ops = pool(dtype)
        P = 1 / _submit_p50(serve, replay, hits, ops, dev)
    else:
        P = p64
    out.update({"dtype": dtype, "pacer_ceiling_rps": P})
    print(f"  (b) pacer ceiling P: f64 {p64:.2f} requests/s (s <= {S21_MAX:g} needs P >= "
          f"{need_p:g}); (b) runs in {dtype}"
          + ("" if dtype == "float64" else f", P {P:.2f} requests/s"), flush=True)

    cache = serve.ExecutableCache(manifest_path=None)
    g = lk.getrf_kernel_launches(N21, 256, 1)
    sw = pk.trsm_kernel_launches(N21)
    devmon.on()  # the cores' cost rows, captured at their first run, feed (c)

    def build(replicas, paused=False):
        return serve.SolverService(
            cache=cache, placement=serve.PlacementPolicy(replicas=replicas, devices=[str(dev)]),
            factor_cache=serve.FactorCache(max_entries=16), batch_max=1,
            batch_window_s=0.0005, start=not paused)

    def prelude(svc):
        """The warm prelude: the four pool matrices factored on the card
        (misses), then the solve bucket warmed; returns the launches."""
        pk.reset_launches()
        res = replay.replay(svc, pools, seed=0, cache=ops)
        check(res["delivered"] == len(pools), f"(b) prelude: {res}")
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        svc.warmup()
        return launches

    def mirror(delivered, hit) -> dict:
        """Every dispatch solves with the trsm pair; each one that found
        no cached factor also factored (panel_lu)."""
        want = {"trsm_lower": sw * delivered, "trsm_upper": sw * delivered,
                "panel_lu": g * (delivered - hit)}
        return {k: v for k, v in want.items() if v}

    # (b1) one card's lane scaling, no fault
    scaling = {}
    svc1 = None
    try:
        for k in (1, 2, 3):
            svc = build(k)
            try:
                pre = prelude(svc)
                if dev.type == "cuda":
                    check(pre == mirror(len(pools), 0),
                          f"(b) prelude launches {pre} != {mirror(len(pools), 0)}")
                metrics.reset()
                act = torch.profiler.ProfilerActivity
                with torch.profiler.profile(
                        activities=[act.CUDA if dev.type == "cuda" else act.CPU]) as prof:
                    wall, kept = _closed21(svc, hits, ops)
                c = metrics.counters()
                busy = _busy_s(prof)
                res = _residual21(kept, dev)
                lanes = [int(c.get(f"serve.replica.{i}.dispatched", 0)) for i in range(k)]
                scaling[k] = {"R": HITS21 / wall, "idle_share": max(0.0, 1 - busy / wall),
                              "busy_ms": busy * 1e3, "dispatched": lanes,
                              "hits": c.get("serve.factor_cache.hit", 0),
                              "cold": c.get("jit.compilations", 0), "residual": res,
                              "prelude_launches": pre}
                print(f"  (b1) {k} lane(s): R{k} {HITS21 / wall:.2f} requests/s ({HITS21} hits, "
                      f"{CLIENTS21} closed-loop clients, profiled), dispatched {lanes}, idle "
                      f"share {scaling[k]['idle_share']:.4f} (busy {busy * 1e3:.1f} ms of "
                      f"{wall:.3f} s), largest residual {res:.3e}", flush=True)
                check(scaling[k]["hits"] == HITS21 and scaling[k]["cold"] == 0,
                      f"(b1) {k} lanes: {scaling[k]}")
                check(res <= 3, f"(b1) {k} lanes: residual {res:.3f} > 3")
            finally:
                if k == 1:
                    svc1 = svc
                else:
                    svc.stop()
        out["lane_scaling"] = scaling

        # (b2) calibration: one lane under latency:every=1,ms=T
        T, cal = T21_MS, []
        while True:
            faults.configure(f"latency:every=1,ms={T}")
            faults.on()
            wall, kept = _closed21(svc1, hits, ops)
            faults.reset()
            R1T = HITS21 / wall
            cal.append({"T_ms": T, "R1": R1T})
            print(f"  (b2) tax {T} ms: R1(T) {R1T:.3f} requests/s; 2 R1(T) = {2 * R1T:.2f} "
                  f"{'<=' if 2 * R1T <= 0.5 * P else '>'} P / 2 = {0.5 * P:.2f}", flush=True)
            if 2 * R1T <= 0.5 * P or len(cal) == 5:
                break
            base = max(1 / R1T - T / 1e3, 0.0)  # a dispatch's untaxed time
            T = int(math.ceil((4 / P - base) * 1e3 / 5.0)) * 5
        check(2 * R1T <= 0.5 * P, f"(b2) no tax brought 2 R1(T) under P / 2: {cal}")
    finally:
        faults.reset()
        if svc1 is not None:
            svc1.stop()
    s = LANE21_RPS / R1T
    out.update({"calibration": cal, "tax_ms": T, "R1_T": R1T, "s": s})

    # (b3) the JAX drill, time-scaled by s
    bs, bl, tail = 1.0 * s, 1.0 * s, 1.0 * s
    base_rps, burst_rps = 0.5 * R1T, 2.0 * R1T
    requests = int(round(base_rps * bs + burst_rps * bl + base_rps * tail))
    budget = 0.5 * s
    policy = (f"min=1,max=3,up=1.0,down=0.2,up_cooldown={0.25 * s:.4f},"
              f"down_cooldown={2.0 * s:.4f},step=2,period={0.05 * s:.4f}")
    spec = replay.gen_burst(requests, seed=9, base_rps=base_rps, burst_rps=burst_rps,
                            burst_start_s=bs, burst_len_s=bl, n=N21, nrhs=NRHS21, distinct=4)
    for r in spec:
        r["dtype"] = dtype
    rows = record.load(record.save(spec, os.path.join(tmp, f"burst_{dtype}.jsonl"),
                                   source="gen_burst"))
    scaled = {"P_rps": P, "tax_ms": T, "R1_T_rps": R1T, "s": s, "base_rps": base_rps,
              "burst_rps": burst_rps, "burst_start_s": bs, "burst_len_s": bl,
              "budget_s": budget, "policy": policy, "requests": requests,
              "trace_s": rows[-1]["t_offset"]}
    out["scaled"] = scaled
    print(f"  (b3) P {P:.2f} requests/s, T {T} ms, R1(T) {R1T:.3f} requests/s, s = 60 / R1(T) "
          f"= {s:.3f}: base {base_rps:.3f} / burst {burst_rps:.3f} requests/s (0.5 / 2 R1(T)), "
          f"burst at {bs:.2f} s for {bl:.2f} s (1.0 s), budget {budget:.3f} s (0.5 s), "
          f"policy {policy}; {requests} requests (cut from {REQUESTS21}: the leg ends "
          f"{tail:.2f} s after the burst), trace {scaled['trace_s']:.2f} s", flush=True)
    tax = f"latency:every=1,ms={T}"

    def burst_rate(kept):
        """Deliveries inside the burst window, per second of it."""
        t0 = kept[0]["t_submit"] - rows[0]["t_offset"]
        lo, hi = t0 + bs, t0 + bs + bl
        return sum(1 for it in kept if it["t_done"] is not None and lo <= it["t_done"] < hi) / bl

    legs = {}
    # static leg: one lane, no scaler
    svc = build(1)
    try:
        check(svc._scaler is None, "(b) scaler armed without SLATE_TPU_SCALE")
        prelude(svc)
        metrics.reset()
        pk.reset_launches()
        keep = _Keep21(svc)
        faults.configure(tax)
        faults.on()
        res = replay.replay(keep, rows, speed=1.0, seed=0, cache=ops, check_results=False)
        faults.reset()
        c = metrics.counters()
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        legs["static"] = {"res": res, "launches": launches,
                          "hits": c.get("serve.factor_cache.hit", 0),
                          "burst_rps": burst_rate(keep.kept),
                          "residual": _residual21(keep.kept, dev)}
        svc.stop(drain=True, drain_timeout=300)
    finally:
        faults.reset()
        svc.stop()
    st = legs["static"]
    print(f"  (b3) static leg: p99 {(res['p99_s'] or 0) * 1e3:.1f} ms (budget "
          f"{budget * 1e3:.1f} ms), {res['delivered']} of {res['submitted']} delivered, "
          f"{st['burst_rps']:.3f} requests/s delivered in the burst, launches {launches}",
          flush=True)
    # elastic leg: the scaled policy, the same trace and tax
    os.environ["SLATE_TPU_SCALE"] = policy
    snaps: list = []
    svc = build(1, paused=True)
    path = os.path.join(tmp, f"width_{dtype}.jsonl")
    try:
        check(svc._scaler is not None, "(b) SLATE_TPU_SCALE failed to arm")
        _watch21(svc, snaps)
        svc.start()
        prelude(svc)
        metrics.reset()
        pk.reset_launches()
        keep = _Keep21(svc)
        rec = record.Recorder()
        with rec, _Peak21(svc) as peak:
            faults.configure(tax)
            faults.on()
            res = replay.replay(keep, rows, speed=1.0, seed=0, cache=ops, check_results=False)
            faults.reset()
            n_end = _settle21(svc, 8.0 * s)
        c = metrics.counters()
        compiles = int(c.get("jit.compilations", 0))
        primes = int(c.get("serve.device_primes", 0))
        gate.publish({
            "static_p99_s": st["res"]["p99_s"] or 0.0, "elastic_p99_s": res["p99_s"] or 0.0,
            "budget_s": budget, "replica_peak": peak.peak, "replicas_end": n_end,
            "min_replicas": 1, "max_replicas": 3, "up_threshold": 1.0,
            "new_lane_compiles": compiles - primes, "device_primes": primes,
        })
        metrics.dump(path)
        launches = {k: v for k, v in pk.LAUNCHES.items() if v}
        el = {"res": res, "launches": launches, "hits": c.get("serve.factor_cache.hit", 0),
              "burst_rps": burst_rate(keep.kept), "peak": peak.peak, "end": n_end,
              "compiles": compiles, "device_primes": primes,
              "spills": c.get("scale.affinity_spills", 0),
              "counters": {k: v for k, v in c.items() if k.startswith("scale.")},
              "timeline": [{k: r.get(k) for k in ("t_mono", "pressure", "action", "delta",
                                                    "reason", "replicas")}
                           for r in metrics.timeline() if r.get("kind") == "scale"],
              "residual": _residual21(keep.kept, dev)}
        el.update(_checks21(snaps, c, dev, "(b)"))
        legs["elastic"] = el
        rep = _tool("capacity_report.py", path)
        el["overprovision"] = _report_module("capacity_report").analyze(path)["overprovision"]
        _print_elastic21(el, budget, rep)
        # (c) the warmup plan of the recorded rows, costs from the cache's
        # captured rows where it has them
        plan = wp.plan_from_trace(rec.rows(), cache=svc.cache, batch_max=1)
        legs["plan"] = _plan21(serve, svc, plan, dev, dtype)
        svc.stop(drain=True, drain_timeout=300)
    finally:
        faults.reset()
        svc.stop()
        devmon.off()
        os.environ.pop("SLATE_TPU_SCALE", None)
    out["legs"] = legs
    check(rep.returncode == 0, f"(b) capacity_report exited {rep.returncode}")
    for name, leg in (("static", st), ("elastic", el)):
        r = leg["res"]
        check(r["delivered"] == r["submitted"], f"(b) {name}: {r}")
        check(leg["residual"] <= 3, f"(b) {name}: residual {leg['residual']:.3f} > 3")
        if dev.type == "cuda":
            want = mirror(r["delivered"], leg["hits"])
            check(leg["launches"] == want, f"(b) {name}: launches {leg['launches']} != {want}")
    out["phase_s"] = time.perf_counter() - t21
    return out


def _print_elastic21(el: dict, budget: float, rep) -> None:
    res, over = el["res"], el["overprovision"]
    print(f"  (b3) elastic leg: p99 {(res['p99_s'] or 0) * 1e3:.1f} ms (budget "
          f"{budget * 1e3:.1f} ms), {res['delivered']} of {res['submitted']} delivered, "
          f"{el['burst_rps']:.3f} requests/s delivered in the burst, peak {el['peak']}, end "
          f"{el['end']}, affinity spills {el['spills']}, over-provision "
          f"{'n/a' if over is None else f'{over:.4f}'}, launches {el['launches']}; "
          f"snapshots {el['snapshots']}, headroom {el['headroom']}", flush=True)
    for row in el["timeline"]:
        print(f"    t {row['t_mono']:.3f} pressure {row['pressure']} {row['action']} "
              f"{row['delta']} (replicas {row['replicas']}): {row['reason']}", flush=True)
    print("  (b3) tools/capacity_report.py: " + _report_lines(rep), flush=True)


def _plan21(serve, svc, plan, dev, dtype: str) -> dict:
    """Leg (c): print the plan's top entries (cost captured by the cache's
    devmon rows, or the phase_flops model) and its preload, check that the
    full bucket and its solve sibling are planned, and bring a lane live
    through ``add_replica(plan=)``: an entry already live on the lane's
    device is skipped (on one card, every entry that ran), one never
    dispatched is built (the full bucket: misses factor on the direct
    path)."""
    from slate_tpu_torch.aux import metrics

    top = []
    for e in plan.entries[:4]:
        top.append({"label": e.key.label, "batch": e.batch, "rows": e.rows, "share": e.share,
                    "cost": e.cost, "score": e.score,
                    "source": "captured" if svc.cache.cost(e.key, e.batch) else "phase_flops"})
    full = serve.bucket_for("gesv", N21, N21, NRHS21, np.dtype(dtype))
    labels = {(e.key.label, e.batch) for e in plan.entries}
    check((full.label, 1) in labels and (full.solve_sibling().label, 1) in labels,
          f"(c) the plan misses the {N21} gesv bucket or its solve sibling: {sorted(labels)}")
    preload = [p.to_json() for p in plan.preload]
    check(len(preload) == 4, f"(c) preload {preload}")
    live = sum(svc.cache.is_live(e.key, e.batch) for e in plan.entries)
    with metrics.deltas() as d:
        name = svc.add_replica(plan=plan)
        primes = {k: d.get(f"scale.prime_{k}") or 0
                  for k in ("restored", "compiled", "failed", "skipped")}
    print(f"  (c) plan of {plan.total_rows} recorded rows: " + "; ".join(
        f"{t['label']} b{t['batch']} rows {t['rows']} share {t['share']} cost {t['cost']:.4g} "
        f"({t['source']}) score {t['score']:.4g}" for t in top), flush=True)
    print("  (c) preload: " + "; ".join(f"{p['repeat_fp'][:12]} rows {p['rows']} n {p['n']} "
                                        f"score {p['score']:.4g}" for p in preload), flush=True)
    print(f"  (c) add_replica(plan=) -> lane {name}: scale.prime_* {primes} ({live} of "
          f"{len(plan.entries)} entries already live on {dev}: skipped)", flush=True)
    check(primes == {"restored": 0, "compiled": len(plan.entries) - live, "failed": 0,
                     "skipped": live}, f"(c) add_replica(plan=): {primes}, {live} live")
    return {"top": top, "preload": preload, "entries": len(plan.entries), "lane": name,
            "primes": primes}


def scale_main(serve, metrics, pk, lk, dev) -> dict:
    """Phase 21: leg (a) in a checked child, then legs (b) and (c) here."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="slate_scale_") as tmp:
        out["gate"] = scale_gate_leg(dev, tmp)
        metrics.on()
        out["width"] = scale_width_leg(serve, metrics, pk, lk, dev, tmp)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"  phase 21: {out['phase_s']:.1f} s (legs (b) + (c) {out['width']['phase_s']:.1f} s)",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 22: the fleet tier (wire, worker, router)
# ---------------------------------------------------------------------------

#: leg (a): run_tests.py's _FLEET_DRIVER as written (N, tenants, faults, p99 budget)
N22A = 12
TENANTS22 = "abuser:rate=4,burst=4;victim:rate=500,burst=100"
FAULTS22_HOST0 = "sdc_solve:every=2"
FAULTS22_HOST1 = "latency:every=3,ms=40"
RPC_FAULTS22 = "rpc_timeout:every=4;host_partition:once"
BUDGET22A_S = 15.0
#: leg (c): the serve tier's width, gesv, 4 pool matrices a dtype, no factor cache
N22, NRHS22 = 2048, 16
POOL22 = 4
CLIENTS22, STREAM22 = 4, 48  # the untaxed closed-loop streams
KILL22 = 8  # requests in flight when worker 1 is killed
#: the workers' environment: every plane a worker could arm from the
#: environment is off unless the leg sets it
_ENV22_OFF = ("SLATE_TPU_FAULTS", "SLATE_TPU_FACTOR_CACHE", "SLATE_TPU_TENANTS",
              "SLATE_TPU_ADAPTIVE", "SLATE_TPU_INTEGRITY", "SLATE_TPU_WARMUP",
              "SLATE_TPU_ARTIFACTS", "SLATE_TPU_SCALE", "SLATE_TPU_FLEET",
              "SLATE_TPU_FLEET_TENANTS", "SLATE_TPU_FLEET_DEVICE", "SLATE_TPU_METRICS",
              "SLATE_TPU_TRACE_RING", "SLATE_TPU_SYNC_CHECK", "JAX_PLATFORMS")


def _host_env22(device: str, **kw) -> dict:
    """A spawned worker's environment overrides (None drops a variable):
    the JAX drill's ``base`` without its ``JAX_PLATFORMS``, the device
    variable only for a CPU worker (unset, a worker serves on cuda:0)."""
    from slate_tpu_torch.fleet.worker import DEVICE_ENV

    env = {"JAX_PLATFORMS": None, "SLATE_TPU_FAULTS": None,
           DEVICE_ENV: "cpu" if torch.device(device).type == "cpu" else None}
    env.update(kw)
    return env


def fleet_drill(outdir: str, device: str) -> dict:
    """Leg (a): ``run_tests.py``'s fleet drill (``_FLEET_DRIVER``,
    :2400-2578) on the port as written: a router here and two spawned
    workers (host0 under ``sdc_solve:every=2``, host1 under
    ``latency:every=3,ms=40``), N = 12, f32; SDC quarantine and probe
    recovery, fleet-wide quota, a real SIGKILL (``host_death:once``) with
    respawn, rejoin and a forced probe, ``rpc_timeout:every=4;
    host_partition:once``, then the fan-in (``dump_hosts``,
    ``tools/trace_stitch.py``).  Each worker's metrics also dump at its
    exit into ``outdir`` (``host<i>.exit.jsonl``; the JAX drill names the
    file ``1``).  Returns the phases' tallies."""
    import os

    from slate_tpu_torch.aux import faults, metrics, spans
    from slate_tpu_torch.exceptions import SlateError
    from slate_tpu_torch.fleet.router import FleetRouter, note_bad_result, note_trace_orphans
    from slate_tpu_torch.serve.service import Rejected

    here = os.path.dirname(os.path.abspath(__file__))
    metrics.on()
    metrics.reset()
    spans.on(ring=65536)
    t0 = time.perf_counter()
    N = N22A
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((N, N)) + N * np.eye(N)).astype(np.float32)

    def prob(seed):
        return np.random.default_rng(seed).standard_normal((N, 2)).astype(np.float32)

    base = _host_env22(device, SLATE_TPU_TRACE_RING="65536", SLATE_TPU_SYNC_CHECK="1")
    host0 = dict(base, SLATE_TPU_FAULTS=FAULTS22_HOST0,
                 SLATE_TPU_METRICS=os.path.join(outdir, "host0.exit.jsonl"))
    host1 = dict(base, SLATE_TPU_FAULTS=FAULTS22_HOST1,
                 SLATE_TPU_METRICS=os.path.join(outdir, "host1.exit.jsonl"))
    r = FleetRouter(spawn=2, cert="full", tenants=TENANTS22, heartbeat_s=0.2,
                    rpc_timeout_s=30.0, dead_after=2, redispatch_max=2, hedge_s=1.0,
                    respawn=True, quarantine_cooldown_s=0.4, spawn_env=[host0, host1], seed=7)
    r.start()
    checked = [0]

    def solve(tenant="victim", seed=0):
        B = prob(seed)
        try:
            X = r.submit("gesv", A, B, deadline=60.0, tenant=tenant).result(timeout=120)
        except Exception as e:  # noqa: BLE001 -- the caller types it
            return e
        # NaN-safe reference check: any non-finite or off-fence entry is a
        # silent wrong answer the defenses let through
        if not np.all(np.abs(A @ X - B) <= 1e-2):
            note_bad_result()
        checked[0] += 1
        return None

    out = {}
    try:
        # phase 1: SDC containment, quarantine + probe recovery
        for i in range(120):
            e = solve(seed=100 + i)
            check(e is None,
                  f"(a) victim solve {i} failed under SDC: {e!r}; {_why22(r, metrics)}")
            c = metrics.counters()
            if c.get("fleet.quarantined", 0) >= 1 and c.get("fleet.unquarantined", 0) >= 1:
                break
            time.sleep(0.01)
        c = metrics.counters()
        check(c.get("fleet.quarantined", 0) >= 1, "(a) the sdc host was never quarantined")
        check(c.get("fleet.unquarantined", 0) >= 1, "(a) quarantine was never probed back")
        out["sdc_solves"] = i + 1
        # phase 2: fleet-wide quota (abuser refused, victim whole)
        rejected = 0
        for i in range(14):
            e = solve(tenant="abuser", seed=200 + i)
            if e is not None:
                check(isinstance(e, Rejected), f"(a) abuser got {e!r}, not Rejected")
                rejected += 1
        check(rejected > 0, "(a) the abuser burst never hit the fleet-wide quota")
        for i in range(6):
            e = solve(seed=300 + i)
            check(e is None, f"(a) victim starved during abuse: {e!r}; {_why22(r, metrics)}")
        out["abuser_rejected"] = rejected
        # phase 3: a real host death (SIGKILL) + fail-fast re-dispatch;
        # every future resolves, as a right X or a typed error
        faults.configure("host_death:once")
        faults.on()
        delivered3 = 0
        for i in range(10):
            e = solve(seed=400 + i)
            if e is None:
                delivered3 += 1
            else:
                check(isinstance(e, SlateError), f"(a) untyped failure: {e!r}")
        # death is declared by the liveness plane (heartbeat misses up to
        # dead_after), not by the request path: give it a few beats
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and metrics.counters().get("fleet.host_dead", 0) < 1:
            time.sleep(0.05)
        c = metrics.counters()
        check(c.get("fleet.host_dead", 0) >= 1, "(a) the death was never declared")
        check(c.get("fleet.redispatched", 0) >= 1, "(a) no re-dispatch recovered it")
        check(delivered3 >= 1, "(a) no request survived the host death")
        out["delivered_after_death"] = delivered3
        # phase 4: respawn -> rejoin -> forced certification probe, with
        # traffic flowing (the probe rides a routed solve)
        t_rejoin = time.perf_counter()
        deadline = time.monotonic() + 60
        states = {}
        while time.monotonic() < deadline:
            states = {k: v["state"] for k, v in r.health()["hosts"].items()}
            if all(s == "live" for s in states.values()):
                break
            e = solve(seed=510)
            if e is not None:
                check(isinstance(e, SlateError), f"(a) untyped failure: {e!r}")
            time.sleep(0.05)
        check(all(s == "live" for s in states.values()),
              f"(a) the dead host never rejoined live (states={states})")
        check(metrics.counters().get("fleet.host_respawned", 0) >= 1,
              "(a) the death was absorbed without a respawn")
        out["rejoin_s"] = time.perf_counter() - t_rejoin
        for i in range(12):
            e = solve(seed=500 + i)
            check(e is None, f"(a) victim solve failed after rejoin: {e!r}; {_why22(r, metrics)}")
        # phase 5: rpc timeouts + a partition, absorbed by retry
        faults.configure(RPC_FAULTS22)
        delivered5 = 0
        for i in range(12):
            e = solve(seed=600 + i)
            if e is None:
                delivered5 += 1
            else:
                check(isinstance(e, SlateError), f"(a) untyped failure: {e!r}")
        faults.reset()
        check(delivered5 >= 9, f"(a) timeouts / partition overwhelmed the fleet: {delivered5}/12")
        out["delivered_under_timeouts"] = delivered5
        # fan-in: per-host dumps, stitched trace, orphan gauge
        replies = r.dump_hosts(outdir)
        check(len(replies) == 2, f"(a) expected both hosts to dump, got {replies}")
        out["stitch"] = _stitch22(here, outdir, spans, note_trace_orphans)
    finally:
        faults.reset()
        r.stop(drain=True)
    out["counters"] = {k: v for k, v in metrics.counters().items() if k.startswith("fleet.")}
    out["checked"] = checked[0]
    out["seconds"] = time.perf_counter() - t0
    return out


def _why22(r, metrics) -> str:
    """The router's host states and fleet counters (a failed check's
    context)."""
    hosts = {k: (v["state"], v["inflight"], v["score"]["state"])
             for k, v in r.health()["hosts"].items()}
    return f"hosts {hosts}, counters " + str(
        {k: v for k, v in metrics.counters().items() if k.startswith(("fleet.", "faults."))})


def _stitch22(here: str, outdir: str, spans, note_trace_orphans) -> str:
    """Export the router's ring beside the hosts' traces, stitch them with
    ``tools/trace_stitch.py --allow-orphans`` and record the orphan count
    in the ``fleet.trace_orphans`` gauge; returns the summary line."""
    import os

    router_trace = os.path.join(outdir, "router.trace.json")
    spans.export_chrome(router_trace, process_name="router")
    traces = [router_trace] + sorted(
        os.path.join(outdir, f) for f in os.listdir(outdir)
        if f.endswith(".trace.json") and not f.startswith("router"))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "tools", "trace_stitch.py"), "--allow-orphans",
         "-o", os.path.join(outdir, "stitched.trace.json"), *traces],
        capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"trace_stitch: {proc.stdout} {proc.stderr}")
    line = proc.stdout.strip().splitlines()[-1]
    note_trace_orphans(int(line.rpartition("orphans=")[2]))
    return line


def fleet_escape(device: str) -> dict:
    """Leg (b): ``run_tests.py``'s ``_FLEET_ESCAPE_DRIVER`` (:2584-2618):
    one worker under ``sdc_solve:every=2``, certification off; a wrong X
    reaches the client and is counted (``fleet.bad_results``)."""
    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.fleet.router import FleetRouter, note_bad_result

    metrics.on()
    metrics.reset()
    t0 = time.perf_counter()
    N = N22A
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((N, N)) + N * np.eye(N)).astype(np.float32)
    host0 = _host_env22(device, SLATE_TPU_FAULTS=FAULTS22_HOST0, SLATE_TPU_METRICS=None,
                        SLATE_TPU_TRACE_RING=None)
    r = FleetRouter(spawn=1, cert="off", heartbeat_s=0.25, rpc_timeout_s=30.0,
                    spawn_env=[host0], seed=7)
    r.start()
    bad = 0
    try:
        for i in range(8):
            B = np.random.default_rng(700 + i).standard_normal((N, 2)).astype(np.float32)
            X = r.submit("gesv", A, B, deadline=60.0).result(timeout=120)
            if not np.all(np.abs(A @ X - B) <= 1e-2):
                note_bad_result()
                bad += 1
    finally:
        r.stop(drain=True)
    check(bad > 0, "(b) the sdc stream produced no corrupt delivery to flag")
    return {"bad": bad, "seconds": time.perf_counter() - t0}


# The fresh interpreter of legs (a) and (b), the port alone, under the
# checked runtime (SLATE_TPU_SYNC_CHECK in its env): argv dir, device.
# One JSON line out, with the child's own wall time from its first line.
_CHILD22 = r"""
import time
t0 = time.perf_counter()
import json, sys
import chip_smoke as cs
out = cs.child22(sys.argv[1], sys.argv[2])
out["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def child22(tmp: str, device: str) -> dict:
    """Legs (a) and (b) in one interpreter: the drill's router metrics to
    ``tmp``/router.jsonl, its hosts' dumps to ``tmp``/dumps, the escape
    leg's to ``tmp``/escape.jsonl."""
    import os

    from slate_tpu_torch.aux import metrics, sync
    from slate_tpu_torch.ops.hopper import panel_kernels as pk

    outdir = os.path.join(tmp, "dumps")
    os.makedirs(outdir, exist_ok=True)
    out = {"armed": sync.is_on()}
    pk.reset_launches()
    out["drill"] = fleet_drill(outdir, device)
    metrics.dump(os.path.join(tmp, "router.jsonl"))
    out["escape"] = fleet_escape(device)
    metrics.dump(os.path.join(tmp, "escape.jsonl"))
    out["launches"] = {k: v for k, v in pk.LAUNCHES.items() if v}
    rep = sync.report()
    out["violations"] = [{k: v[k] for k in ("kind", "detail")} for v in rep["violations"]]
    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slate_tpu"))
    return out


def _merge22(tmp: str, router_jsonl: str, dumps: str) -> str:
    """``tools/metrics_merge.py`` of the router's JSONL and each host's
    dump, tagged ``router`` / ``host<i>`` (the JAX gate's fan-in)."""
    import os

    host_dumps = sorted(os.path.join(dumps, f) for f in os.listdir(dumps)
                        if f.endswith(".metrics.jsonl"))
    merged = os.path.join(tmp, f"merged_{os.path.basename(router_jsonl)}")
    tags = []
    for tag in ["router"] + [os.path.basename(p).split(".")[0] for p in host_dumps]:
        tags += ["--tag", tag]
    proc = _tool("metrics_merge.py", "-o", merged, *tags, router_jsonl, *host_dumps)
    check(proc.returncode == 0, f"metrics_merge: {proc.stdout} {proc.stderr}")
    return merged


class _Gate22:
    """Legs (a) and (b) in a fresh interpreter armed by
    SLATE_TPU_SYNC_CHECK=1, judged by tools/fleet_report.py with the JAX
    gate's arguments (``run_tests.py`` ``fleet_gate``, :2621-2711).  The
    child starts at construction; the whole run starts it before phase 15
    and waits for it before phase 17, so that its n = 12 drill runs beside
    the eigensolvers and the SVD (no timing gate) and never beside a phase
    that gates a latency.  Its output goes to files in its own temporary
    directory, which leg (c) shares; both go at exit."""

    def __init__(self, dev):
        import atexit
        import os
        import shutil
        import tempfile

        here = os.path.dirname(os.path.abspath(__file__))
        self.dev, self.tmp = dev, tempfile.mkdtemp(prefix="slate_fleet_")
        env = {k: v for k, v in os.environ.items() if k not in _ENV22_OFF}
        env.update(PYTHONPATH=here, SLATE_TPU_SYNC_CHECK="1")
        self._out = open(os.path.join(self.tmp, "child22.out"), "w+")
        self._err = open(os.path.join(self.tmp, "child22.err"), "w+")
        self.t0 = time.perf_counter()
        self.waited = None  # seconds from the start to the end of wait()
        self.proc = subprocess.Popen([sys.executable, "-c", _CHILD22, self.tmp, str(dev)],
                                     cwd=here, env=env, stdout=self._out, stderr=self._err,
                                     text=True)
        atexit.register(self.close)
        self._rmtree = shutil.rmtree

    def wait(self, timeout: float = 600.0) -> None:
        """Wait for the child (it fails the run past ``timeout``)."""
        if self.waited is not None:
            return
        try:
            self.proc.wait(timeout=max(0.0, timeout - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            fail(f"phase 22 child still running after {timeout:.0f} s")
        self.waited = time.perf_counter() - self.t0

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in (self._out, self._err):
            f.close()
        self._rmtree(self.tmp, ignore_errors=True)

    def finish(self) -> dict:
        """The child's verdicts: its tallies, the fan-in and the reports."""
        import os

        self.wait()
        tmp = self.tmp
        self._out.seek(0)
        self._err.seek(0)
        stdout, stderr = self._out.read(), self._err.read()
        for line in stdout.strip("\n").splitlines()[:-1]:
            print(line, flush=True)
        check(self.proc.returncode == 0, f"phase 22 child exited {self.proc.returncode}: "
              f"{stdout[-2000:]} {stderr[-3000:]}")
        got = json.loads(stdout.strip().splitlines()[-1])
        check(got["armed"] and got["jax_modules"] == [],
              f"fleet child: armed {got['armed']}, imported {got['jax_modules']}")
        check(got["violations"] == [], f"fleet drill: sync violations {got['violations']}")
        dr, es = got["drill"], got["escape"]
        merged = _merge22(tmp, os.path.join(tmp, "router.jsonl"), os.path.join(tmp, "dumps"))
        rep = _tool("fleet_report.py", merged, "--victim", "victim", "--p99-budget",
                    f"{BUDGET22A_S:g}", "--require-stitch")
        esc = _tool("fleet_report.py", os.path.join(tmp, "escape.jsonl"))
        print(f"  (a) drill: quarantine + probe recovery after {dr['sdc_solves']} solves, abuser "
              f"rejected {dr['abuser_rejected']}/14, {dr['delivered_after_death']}/10 delivered "
              f"through the SIGKILL, rejoined live in {dr['rejoin_s']:.1f} s, "
              f"{dr['delivered_under_timeouts']}/12 under timeouts; {dr['stitch']}; "
              f"{dr['checked']} reference-checked deliveries; drill {dr['seconds']:.1f} s",
              flush=True)
        print(f"  (a) router counters {dr['counters']}", flush=True)
        print("  (a) tools/fleet_report.py (the gate's arguments): " + _report_lines(rep),
              flush=True)
        print(f"  (b) escape: {es['bad']} wrong X delivered of 8 (cert off, {FAULTS22_HOST0}); "
              f"fleet_report.py exit {esc.returncode}; (a)+(b) sync violations "
              f"{len(got['violations'])}, router launches {got['launches']}, child "
              f"{got['wall_s']:.1f} s", flush=True)
        check(rep.returncode == 0, f"fleet_report exited {rep.returncode} on the drill")
        check(esc.returncode != 0, "fleet_report passed the undefended escape leg")
        # n = 12 is below the kernels' crossover: no launch in the router either
        check(got["launches"] == {}, f"(a) launched kernels: {got['launches']}")
        return {"drill": dr, "escape": es, "violations": got["violations"],
                "drill_report_rc": rep.returncode, "escape_report_rc": esc.returncode,
                "child_wall_s": got["wall_s"], "waited_s": self.waited}


# A worker process of leg (c): serve until drained (the port's worker on
# the port given), then write what it ran to the stats file.  argv: stats
# path, port[, a file whose appearance lets a standby process bind].
_WORKER22 = r"""
import sys
import chip_smoke as cs
sys.exit(cs.worker22(sys.argv[1], int(sys.argv[2]), *sys.argv[3:]))
"""


def worker22(stats: str, port: int, gate=None) -> int:
    """Serve as a fleet worker until drained, then dump this process's
    kernel launches, nvcc runs, requests served, lane devices and the JAX
    modules it imported (none) to ``stats``.  With ``gate``, wait (imported,
    the card untouched) until that file exists before binding: a standby
    that takes a killed worker's port."""
    import os

    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.fleet import worker as fw
    from slate_tpu_torch.ops.hopper import panel_kernels as pk

    while gate is not None and not os.path.exists(gate):
        time.sleep(0.02)
    w = fw.FleetWorker(port=port, device=fw.device_from_env())
    w.bind()
    w.serve_forever()
    c = metrics.counters()
    svc = w._service
    out = {"pid": os.getpid(), "launches": {k: v for k, v in pk.LAUNCHES.items() if v},
           "nvcc_runs": pk.NVCC_RUNS,
           "loaded_from": None if pk.LOADED_FROM is None else str(pk.LOADED_FROM),
           "requests": int(c.get("serve.requests", 0)),
           "batch_pad": int(c.get("serve.batch_pad", 0)),
           "redone": {k: int(c.get(k, 0)) for k in ("serve.fallbacks", "serve.retries",
                                                    "serve.corrupt_result")},
           "solved": int(c.get("fleet.worker.solved", 0)),
           "typed_errors": int(c.get("fleet.worker.typed_errors", 0)),
           "sdc": int(c.get("faults.injected.sdc_solve", 0)),
           "lanes": [] if svc is None else [str(r["device"]) for r in svc.health()["replicas"]],
           "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "slate_tpu"))}
    with open(stats, "w") as f:
        json.dump(out, f)
    return 0


class _Proc22:
    """One worker process of leg (c), started here (``connect=`` mode):
    its announced port, its stdout drained by a thread.  ``env`` adds to
    its environment; ``gate`` makes it a standby (:func:`worker22`)."""

    def __init__(self, name: str, tmp: str, dev, faults_spec=None, port: int = 0,
                 env=None, gate=None):
        import os
        import queue
        import threading

        from slate_tpu_torch.fleet.worker import ANNOUNCE, DEVICE_ENV

        here, extra = os.path.dirname(os.path.abspath(__file__)), env
        env = {k: v for k, v in os.environ.items() if k not in _ENV22_OFF}
        env.update(PYTHONPATH=here, SLATE_TPU_TRACE_RING="65536",
                   SLATE_TPU_METRICS=os.path.join(tmp, f"{name}.exit.jsonl"))
        if faults_spec:
            env["SLATE_TPU_FAULTS"] = faults_spec
        if dev.type == "cpu":
            env[DEVICE_ENV] = "cpu"
        env.update(extra or {})
        self.name, self.stats = name, os.path.join(tmp, f"{name}.stats.json")
        self.t0 = time.perf_counter()
        argv = [sys.executable, "-c", _WORKER22, self.stats, str(port)]
        self.proc = subprocess.Popen(argv + ([gate] if gate else []), cwd=here, env=env,
                                     stdout=subprocess.PIPE, text=True)
        self._lines: "queue.Queue" = queue.Queue()
        self._announce = ANNOUNCE
        self.port = None
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def wait_port(self, timeout: float = 120.0) -> int:
        import queue

        deadline = time.monotonic() + timeout
        while self.port is None:
            try:
                line = self._lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            check(line is not None, f"(c) worker {self.name} never announced its port "
                  f"(rc={self.proc.poll()})")
            if line.startswith(self._announce):
                self.port = int(line[len(self._announce):].strip())
                self.announce_s = time.perf_counter() - self.t0
        return self.port

    def read_stats(self, timeout: float = 60.0) -> dict:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            fail(f"(c) worker {self.name} did not exit after its drain")
        check(self.proc.returncode == 0, f"(c) worker {self.name} exited {self.proc.returncode}")
        with open(self.stats) as f:
            return json.load(f)

    def reap(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _rpc22(port: int, header: dict, arrays=None, timeout: float = 600.0):
    """One RPC straight to a worker over the port's wire (the warm-ups,
    the drain of a worker no router holds)."""
    import socket

    from slate_tpu_torch.fleet import wire

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.settimeout(timeout)
        wire.send_msg(s, header, arrays)
        return wire.recv_msg(s)


def _warm22(ports, reqs) -> None:
    """Each worker's first requests, one a dtype, straight over the wire and
    the workers in parallel: its service, kernels and cores come up cold
    here, not in a measured stream."""
    import threading

    replies = []

    def warm(port):
        for A, B in reqs:
            replies.append(_rpc22(port, {"op": "solve", "routine": "gesv"}, {"A": A, "B": B})[0])

    threads = [threading.Thread(target=warm, args=(p,)) for p in ports]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    check(len(replies) == len(ports) * len(reqs) and all(r.get("ok") for r in replies),
          f"(c) warm-up replies {replies}")


class _Wire22:
    """Counts the bytes of every solve frame the router sends and
    receives (header length prefix, JSON header and arrays)."""

    def __init__(self):
        self.sent = self.received = self.solves = 0

    def __enter__(self):
        from slate_tpu_torch.fleet import wire

        self._wire = wire
        self._send, self._recv = wire.send_msg, wire.recv_msg

        def frame(header, arrays):
            return 4 + len(json.dumps({**header, "arrays": [
                [k, np.asarray(a).dtype.str, list(np.shape(a))] for k, a in (arrays or {}).items()
            ]}).encode()) + sum(np.asarray(a).nbytes for a in (arrays or {}).values())

        def send(sock, header, arrays=None):
            if header.get("op") == "solve":
                self.solves += 1
                self.sent += frame(header, arrays)
            return self._send(sock, header, arrays)

        def recv(sock):
            header, arrays = self._recv(sock)
            if "X" in arrays:
                self.received += frame(header, arrays)
            return header, arrays

        wire.send_msg, wire.recv_msg = send, recv
        return self

    def __exit__(self, *exc):
        self._wire.send_msg, self._wire.recv_msg = self._send, self._recv


class _Cert22:
    """Times the router's ``residual_certificate`` (host numpy, at the
    served precision) for every delivery it certifies."""

    def __enter__(self):
        from slate_tpu_torch.integrity import policy

        self._pol, self._fn, self.ms = policy, policy.residual_certificate, []

        def timed(routine, A, X, B):
            t = time.perf_counter()
            try:
                return self._fn(routine, A, X, B)
            finally:
                self.ms.append((time.perf_counter() - t) * 1e3)

        policy.residual_certificate = timed
        return self

    def __exit__(self, *exc):
        self._pol.residual_certificate = self._fn


class _Smi22:
    """The card's busy share over a window, from ``nvidia-smi``'s
    ``utilization.gpu`` sampled every 100 ms (every process's kernels: the
    workers are other processes, which a profiler here cannot see)."""

    def __init__(self, dev):
        self.dev, self.samples, self.proc = dev, [], None

    def __enter__(self):
        if self.dev.type == "cuda":
            try:
                self.proc = subprocess.Popen(
                    ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                     "-lms", "100", "-i", "0"], stdout=subprocess.PIPE, text=True)
            except OSError:
                self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=30)
            self.samples = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]

    def idle_share(self):
        return None if not self.samples else 1 - statistics.mean(self.samples) / 100


def _pool22(n: int, nrhs: int, count: int) -> list:
    """The drill's requests: (A, B) in f64 and f32 in turn over 4 pool
    matrices a dtype, A = G + 2 sqrt(n) I and B normal, made from one
    seed."""
    rng = np.random.default_rng(22)
    pools = {d: [] for d in DTYPES}
    for d in DTYPES:
        for _ in range(POOL22):
            A = rng.standard_normal((n, n))
            A[np.diag_indices(n)] += 2 * n**0.5
            pools[d].append(A.astype(d))
    reqs = []
    for i in range(count):
        d = DTYPES[i % 2]
        reqs.append((pools[d][(i // 2) % POOL22], rng.standard_normal((n, nrhs)).astype(d)))
    return reqs


class _Check22:
    """Holds every delivered X to the scaled residual of phases 20-21
    (float64, <= 3) on ``dev``, each pool matrix moved there once."""

    def __init__(self, dev):
        self.dev, self.on_dev, self.worst, self.bad = dev, {}, 0.0, 0

    def __call__(self, A, X, B) -> bool:
        Ad = self.on_dev.get(id(A))
        if Ad is None:
            Ad = self.on_dev[id(A)] = torch.from_numpy(A).to(self.dev)
        r = scaled_residual(Ad, torch.from_numpy(np.array(X, dtype=A.dtype)).to(self.dev),
                            torch.from_numpy(B).to(self.dev))
        self.worst = max(self.worst, r) if r == r else float("inf")
        ok = np.isfinite(X).all() and r <= 3
        self.bad += not ok
        return bool(ok)


def _closed22(target, reqs, clients: int = CLIENTS22, tenant=None):
    """``clients`` threads in closed loop over ``reqs`` through ``target``
    (a router or a service): (wall s, per-request latencies s, errors,
    delivered (A, X, B))."""
    import threading

    lat, errors, got = [], [], []
    lock = threading.Lock()

    def client(part):
        for A, B in part:
            t = time.perf_counter()
            try:
                kw = {} if tenant is None else {"tenant": tenant}
                X = target.submit("gesv", A, B, **kw).result(timeout=600)
            except Exception as e:  # noqa: BLE001 -- reported by the caller
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                lat.append(time.perf_counter() - t)
                got.append((A, X, B))

    threads = [threading.Thread(target=client, args=(reqs[i::clients],)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return time.perf_counter() - t0, lat, errors, got


def _procs22(tmp: str, dev) -> dict:
    """Leg (c)'s worker processes: worker 0 carries the SDC stream, 1 and 2
    are clean (the streams' pair)."""
    return {"w0": _Proc22("w0", tmp, dev, FAULTS22_HOST0), "w1": _Proc22("w1", tmp, dev),
            "w2": _Proc22("w2", tmp, dev)}


def fleet_width_leg(serve, metrics, lk, dev, tmp: str, n: int = N22, procs=None) -> dict:
    """Leg (c): the fleet at the serve tier's width: gesv at n = 2048,
    nrhs = 16, tiles of 64, f64 and f32 in turn over 4 pool matrices a
    dtype, no factor cache (every request a full-phase gesv in a worker),
    workers started here and joined through ``connect=``, the router at
    ``cert=full``.  (c1) the in-process calibration (phase 21's R1: the
    process service, 4 closed-loop clients, 48 requests; its p99 x 4 is
    the victim's budget), then requests/s through the router with 1 and 2
    workers in the same untaxed stream, the wire bytes, the router's
    certificate ms and the card's idle share.  (c2) the drill: worker 0
    under ``sdc_solve:every=2`` until quarantine and probe recovery, the
    abuser's quota, worker 1 killed mid-stream with requests in flight and
    a standby process taking its port (rejoin, forced probe), ``rpc_timeout:every=4;
    host_partition:once``; the fan-in judged by tools/fleet_report.py.
    Each drained worker's launches against the mirror (panel_lu
    ``getrf_kernel_launches(n)`` a core item: a request or a repeat pad
    filling a batch point; the trsm pair none: a full-phase core solves
    with the library), its nvcc runs (0) and its JAX modules (none)."""
    import os

    from slate_tpu_torch.aux import faults, spans
    from slate_tpu_torch.fleet.router import FleetRouter, note_bad_result, note_trace_orphans

    here = os.path.dirname(os.path.abspath(__file__))
    t22 = time.perf_counter()
    dumps = os.path.join(tmp, "width_dumps")
    os.makedirs(dumps, exist_ok=True)
    out: dict = {"n": n, "nrhs": NRHS22}
    procs = _procs22(tmp, dev) if procs is None else procs
    drained = []
    routers = []
    try:
        reqs = _pool22(n, NRHS22, STREAM22)
        # (c1) the in-process calibration, while the workers start
        svc = serve.configure(placement=serve.PlacementPolicy(devices=[str(dev)]))
        try:
            for A, B in reqs[:2]:  # one warm request a dtype (the cores' first runs)
                svc.submit("gesv", A, B).result(timeout=600)
            wall, lat, errors, _ = _closed22(svc, reqs)
        finally:
            serve.shutdown()
        check(not errors, f"(c1) in-process stream: {errors}")
        R0, p99 = STREAM22 / wall, float(np.percentile(lat, 99))
        budget = 4 * p99
        out["inproc"] = {"R": R0, "p50_s": float(np.median(lat)), "p99_s": p99}
        ports = {k: p.wait_port() for k, p in procs.items()}
        out["announce_s"] = {k: p.announce_s for k, p in procs.items()}
        addr = {k: ("127.0.0.1", v) for k, v in ports.items()}
        _warm22([ports[k] for k in ("w0", "w1", "w2")], reqs[:2])
        streams = {}
        for label, hosts in (("1 worker", ("w1",)), ("2 workers", ("w1", "w2"))):
            r = FleetRouter(connect=tuple(addr[h] for h in hosts), cert="full", heartbeat_s=0.5,
                            rpc_timeout_s=600.0, seed=7)
            routers.append(r)
            metrics.reset()
            with _Wire22() as wb, _Cert22() as cert, _Smi22(dev) as smi:
                wall, lat, errors, got = _closed22(r.start(), reqs)
            r.stop(drain=False)
            check(not errors, f"(c1) {label}: {errors}")
            chk = _Check22(dev)
            for A, X, B in got:
                chk(A, X, B)
            c = metrics.counters()
            streams[label] = {
                "R": STREAM22 / wall, "p50_s": float(np.median(lat)),
                "p99_s": float(np.percentile(lat, 99)),
                "wire_bytes_a_request": (wb.sent + wb.received) / max(wb.solves, 1),
                "wire_sent_a_request": wb.sent / max(wb.solves, 1),
                "cert_ms_median": statistics.median(cert.ms) if cert.ms else None,
                "cert_ms_max": max(cert.ms) if cert.ms else None, "certified": len(cert.ms),
                "idle_share": smi.idle_share(), "smi_samples": len(smi.samples),
                "residual": chk.worst, "bad": chk.bad,
                "delivered": c.get("fleet.delivered", 0)}
            s = streams[label]
            print(f"  (c1) {label}: {s['R']:.2f} requests/s ({STREAM22} gesv f64 / f32 at n = {n}, "
                  f"{CLIENTS22} closed-loop clients, cert=full; in-process {R0:.2f}), p50 "
                  f"{s['p50_s'] * 1e3:.1f} ms, p99 {s['p99_s'] * 1e3:.1f} ms, wire "
                  f"{s['wire_bytes_a_request'] / 1e6:.3f} MB a request, certificate "
                  f"{s['cert_ms_median']:.2f} ms a request (median of {s['certified']}), "
                  "idle share " + ("not measured" if s["idle_share"] is None else
                                   f"{s['idle_share']:.4f} ({s['smi_samples']} nvidia-smi "
                                   "samples)") + f", largest residual {chk.worst:.3e}",
                  flush=True)
            check(chk.bad == 0 and s["delivered"] == STREAM22 and s["certified"] == STREAM22,
                  f"(c1) {label}: {s}")
        out["streams"] = streams
        print(f"  (c1) in-process: R {R0:.2f} requests/s, p50 {out['inproc']['p50_s'] * 1e3:.1f} "
              f"ms, p99 {p99 * 1e3:.1f} ms: the victim's budget 4 x p99 = {budget:.3f} s; every "
              f"worker is a CUDA context of its own on {dev} (the card time-slices them)",
              flush=True)

        # (c2) the drill: router over w0 (SDC) and w1; worker 1's successor
        # waits as a standby (imported, not bound) to take its port
        gate = os.path.join(tmp, "w1b.gate")
        procs["w1b"] = _Proc22("w1b", tmp, dev, port=ports["w1"], gate=gate)
        metrics.reset()
        spans.on(ring=65536)
        spans.clear()
        chk = _Check22(dev)
        r = FleetRouter(connect=(addr["w0"], addr["w1"]), cert="full", tenants=TENANTS22,
                        heartbeat_s=0.2, rpc_timeout_s=600.0, dead_after=2, redispatch_max=2,
                        hedge_s=budget, quarantine_cooldown_s=0.4, seed=7)
        routers.append(r)
        r.start()
        seq = iter(range(10**6))

        def solve(tenant="victim"):
            A, B = reqs[next(seq) % len(reqs)]
            try:
                X = r.submit("gesv", A, B, deadline=600.0, tenant=tenant).result(timeout=900)
            except Exception as e:  # noqa: BLE001 -- the caller types it
                return e
            if not chk(A, X, B):
                note_bad_result()
            return None

        from slate_tpu_torch.exceptions import SlateError
        from slate_tpu_torch.serve.service import Rejected

        t = time.perf_counter()
        for i in range(120):
            e = solve()
            check(e is None,
                  f"(c2) victim solve {i} failed under SDC: {e!r}; {_why22(r, metrics)}")
            c = metrics.counters()
            if c.get("fleet.quarantined", 0) >= 1 and c.get("fleet.unquarantined", 0) >= 1:
                break
            time.sleep(0.01)
        c = metrics.counters()
        check(c.get("fleet.quarantined", 0) >= 1 and c.get("fleet.unquarantined", 0) >= 1,
              f"(c2) no quarantine and probe recovery in 120 solves: {c}")
        drill = {"sdc_solves": i + 1, "sdc_s": time.perf_counter() - t}
        # the abuser's burst, submitted back to back (a request takes longer
        # than its bucket's refill at this width, so a serial stream never
        # runs dry): the quota refuses at submit
        rejected, admitted = 0, []
        for i in range(14):
            A, B = reqs[next(seq) % len(reqs)]
            try:
                admitted.append((A, B, r.submit("gesv", A, B, deadline=600.0, tenant="abuser")))
            except Rejected:
                rejected += 1
        for A, B, f in admitted:
            try:
                X = f.result(timeout=900)
            except SlateError:
                continue
            if not chk(A, X, B):
                note_bad_result()
        check(rejected > 0, "(c2) the abuser never hit the fleet-wide quota")
        drill["abuser_rejected"] = rejected
        # worker 1 killed with requests in flight
        t = time.perf_counter()
        futs = []
        for i in range(KILL22):
            A, B = reqs[next(seq) % len(reqs)]
            futs.append((A, B, r.submit("gesv", A, B, deadline=600.0, tenant="victim")))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and r.health()["hosts"]["1"]["inflight"] < 1:
            time.sleep(0.002)
        inflight = r.health()["hosts"]["1"]["inflight"]
        check(inflight >= 1, "(c2) nothing in flight on worker 1 to kill")
        procs["w1"].proc.kill()
        procs["w1"].proc.wait()
        delivered = typed = 0
        for A, B, f in futs:
            try:
                X = f.result(timeout=900)
            except SlateError:
                typed += 1
                continue
            delivered += 1
            if not chk(A, X, B):
                note_bad_result()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and metrics.counters().get("fleet.host_dead", 0) < 1:
            time.sleep(0.05)
        c = metrics.counters()
        check(c.get("fleet.host_dead", 0) >= 1 and c.get("fleet.redispatched", 0) >= 1,
              f"(c2) the kill: host_dead {c.get('fleet.host_dead')}, redispatched "
              f"{c.get('fleet.redispatched')}")
        drill.update({"killed_inflight": inflight, "kill_delivered": delivered,
                      "kill_typed": typed, "kill_s": time.perf_counter() - t})
        # the standby takes worker 1's port and is warmed before traffic
        # resumes (its cores' first runs stay out of the victim's tail),
        # then a routed solve is its forced probe
        t = time.perf_counter()
        open(gate, "w").close()
        check(procs["w1b"].wait_port() == ports["w1"], "(c2) the restart took another port")
        _warm22([ports["w1"]], reqs[:2])
        deadline = time.monotonic() + 120
        states = {}
        while time.monotonic() < deadline:
            states = {k: v["state"] for k, v in r.health()["hosts"].items()}
            if all(s == "live" for s in states.values()):
                break
            e = solve()
            check(e is None or isinstance(e, SlateError), f"(c2) untyped failure: {e!r}")
            time.sleep(0.05)
        check(all(s == "live" for s in states.values()), f"(c2) worker 1 never rejoined: {states}")
        drill["rejoin_s"] = time.perf_counter() - t
        # rpc timeouts and a partition, absorbed by retry
        faults.configure(RPC_FAULTS22)
        faults.on()
        delivered5 = 0
        try:
            for i in range(12):
                e = solve()
                if e is None:
                    delivered5 += 1
                else:
                    check(isinstance(e, SlateError), f"(c2) untyped failure: {e!r}")
        finally:
            faults.reset()
        check(delivered5 >= 9, f"(c2) timeouts / partition overwhelmed the fleet: {delivered5}/12")
        drill["delivered_under_timeouts"] = delivered5
        replies = r.dump_hosts(dumps)
        check(len(replies) == 2, f"(c2) expected both hosts to dump, got {replies}")
        drill["stitch"] = _stitch22(here, dumps, spans, note_trace_orphans)
        r.stop(drain=True)  # drains w0 and w1b
        drill["counters"] = {k: v for k, v in metrics.counters().items()
                             if k.startswith("fleet.")}
        router_jsonl = os.path.join(tmp, "width_router.jsonl")
        metrics.dump(router_jsonl)
        merged = _merge22(tmp, router_jsonl, dumps)
        rep = _tool("fleet_report.py", merged, "--victim", "victim", "--p99-budget",
                    f"{budget:.6f}", "--require-stitch")
        drill.update({"report_rc": rep.returncode, "residual": chk.worst, "bad": chk.bad,
                      "budget_s": budget})
        out["drill"] = drill
        _rpc22(ports["w2"], {"op": "drain", "timeout": 5.0}, timeout=30)
        stats = {k: procs[k].read_stats() for k in ("w0", "w1b", "w2")}
        drained = list(stats)
        print(f"  (c2) drill: quarantine + probe recovery after {drill['sdc_solves']} solves "
              f"({drill['sdc_s']:.1f} s), abuser rejected {rejected}/14, worker 1 killed with "
              f"{inflight} in flight: {delivered}/{KILL22} delivered, {typed} typed "
              f"({drill['kill_s']:.1f} s), its standby bound and rejoined live in "
              f"{drill['rejoin_s']:.1f} s, {delivered5}/12 under timeouts; {drill['stitch']}; "
              f"largest residual {chk.worst:.3e}, wrong X {chk.bad}", flush=True)
        print(f"  (c2) router counters {drill['counters']}", flush=True)
        print(f"  (c2) tools/fleet_report.py --victim victim --p99-budget {budget:.3f} "
              "--require-stitch: " + _report_lines(rep), flush=True)
        check(rep.returncode == 0, f"(c2) fleet_report exited {rep.returncode}")
        check(chk.bad == 0, f"(c2) {chk.bad} wrong X reached the client")
        # each drained worker: the mirror of what its cores ran (every
        # request, plus the repeat pads that fill a batch point; nothing
        # re-run), no nvcc, no JAX
        g = lk.getrf_kernel_launches(n)
        for k, st in stats.items():
            items = st["requests"] + st["batch_pad"]
            want = {"panel_lu": g * items} if dev.type == "cuda" else {}
            print(f"  (c) worker {k} (pid {st['pid']}): {st['requests']} requests + "
                  f"{st['batch_pad']} repeat pads ({st['solved']} solved, {st['typed_errors']} "
                  f"typed, {st['sdc']} sdc fired, re-run {st['redone']}), launches "
                  f"{st['launches']} (mirror {want}), nvcc runs {st['nvcc_runs']}, lanes "
                  f"{st['lanes']}, JAX modules {st['jax_modules']}", flush=True)
            check(not any(st["redone"].values()), f"(c) worker {k} re-ran work: {st['redone']}")
            check(st["launches"] == want, f"(c) worker {k}: launches {st['launches']} != {want}")
            check(st["nvcc_runs"] == 0 and st["jax_modules"] == [],
                  f"(c) worker {k}: nvcc {st['nvcc_runs']}, JAX {st['jax_modules']}")
            check(st["lanes"] == [str(dev)], f"(c) worker {k}: lanes {st['lanes']}")
        out["workers"] = stats
    finally:
        faults.reset()
        for r in routers:
            r.stop(drain=False)
        for k, p in procs.items():
            if k not in drained:
                p.reap()
    out["phase_s"] = time.perf_counter() - t22
    return out


def fleet_main(serve, metrics, lk, dev, gate=None) -> dict:
    """Phase 22: legs (a) and (b) in a checked child (``gate``, started
    here when the caller has not), then leg (c) here."""
    t0 = time.perf_counter()
    out = {}
    gate = _Gate22(dev) if gate is None else gate
    try:
        # leg (c)'s workers import torch while the child ends; they touch
        # the card only when leg (c) warms them
        procs = _procs22(gate.tmp, dev)
        try:
            out["gate"] = gate.finish()
        except BaseException:
            for p in procs.values():
                p.reap()
            raise
        metrics.on()
        out["width"] = fleet_width_leg(serve, metrics, lk, dev, gate.tmp, procs=procs)
    finally:
        gate.close()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"  phase 22: {out['phase_s']:.1f} s (leg (c) {out['width']['phase_s']:.1f} s)",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: band and indefinite
# ---------------------------------------------------------------------------

KD_NARROW, KLU_NARROW, KD_WIDE = 256, 128, 4096  # kd = n / 4 takes the dense route
GBSV_BOUND = 30  # tests/test_band_indefinite.py:48: checks.passed(err, factor=30)
RBT_BOUND = 1000  # the JAX package's RBT bound (PERF.md section 2)
N_AASEN = 2048  # Aasen's host column loop: O(n^3) in numpy BLAS-2 calls


def _band(A, kl, ku):
    """A with the entries outside the band (j - i > ku or i - j > kl) zero."""
    return torch.triu(torch.tril(A, ku), -kl)


def _sym_band(n, kd, dt, gen, dev):
    """A symmetric band + (2 kd + 2) I (the JAX tests' SPD band operand)."""
    G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    A = _band(G + G.mH, kd, kd) / 2
    A.diagonal().add_(2 * kd + 2)
    return A


def _band_run(pk, metrics, fn):
    """(result, host seconds, kernel launches, peak GB) of one call that
    ends in a synchronize; the counts and the peak are this call's."""
    torch.cuda.synchronize()
    metrics.reset()
    pk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    return (out, t, {k: v for k, v in pk.LAUNCHES.items() if v},
            torch.cuda.max_memory_allocated() / 2**30)


def pbsv_phase(stt, pk, ck, metrics, dtype, gen, dev) -> dict:
    """pbsv at n = 16384, nrhs = 512: kd = 256 in both Uplo (the windowed
    band Cholesky, 64 windows of 256 whose diagonal Cholesky is the
    ``flat`` schedule: no kernel launched), timed by window and against
    cholesky + cholesky_solve of the dense matrix; kd = 4096 = n / 4 (the
    dense potrf: the Cholesky kernels, ``chol_kernel_launches``)."""
    dt = getattr(torch, dtype)
    n, nrhs = N_MAIN, NRHS_MAIN
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Bm = stt.Matrix.from_global(B, 512)
    out = {}
    for kd in (KD_NARROW, KD_WIDE):
        A = _sym_band(n, kd, dt, gen, dev)
        for uplo in (("Lower", "Upper") if kd == KD_NARROW else ("Lower",)):
            M = stt.Matrix.from_global(torch.tril(A) if uplo == "Lower" else torch.triu(A), 512)
            Ab = stt.HermitianBandMatrix(M.data, M.layout, grid=M.grid, kd=kd,
                                         uplo=stt.Uplo[uplo])
            del M
            (X, L, info), t, launches, peak = _band_run(pk, metrics, lambda: stt.pbsv(Ab, Bm))
            tm = metrics.timers()
            r = scaled_residual(A, X.to_global(), B)
            label = f"pbsv {dtype} n={n} kd={kd} {uplo}"
            steps = -(-n // min(max(kd, 32), 512))
            res = {"s": t, "pbtrf_s": tm["pbtrf"]["total_s"], "pbtrs_s": tm["pbtrs"]["total_s"],
                   "residual": r, "launches": launches, "peak_gb": peak}
            if kd == KD_NARROW:
                res["pbtrf_ms_a_window"] = res["pbtrf_s"] / steps * 1e3
                res["pbtrs_ms_a_window"] = res["pbtrs_s"] / (2 * steps) * 1e3
                expect = {}
                how = (f"{steps} windows, pbtrf {res['pbtrf_ms_a_window']:.3f} ms a window, "
                       f"pbtrs {res['pbtrs_ms_a_window']:.3f} ms a window (two sweeps)")
            else:
                expect = {k: v for k, v in ck.chol_kernel_launches(n).items() if v}
                how = "dense potrf"
            print(f"  {label}: residual {r:.3e}, info {int(info)}, {t:.3f} s (pbtrf "
                  f"{res['pbtrf_s']:.3f} s, pbtrs {res['pbtrs_s']:.3f} s; {how}), launches "
                  f"{launches or 0} (expected {expect or 0}), peak {peak:.2f} GB", flush=True)
            check(int(info) == 0, f"{label}: info = {int(info)}")
            check(r <= 3, f"{label}: scaled residual {r:.3f} > 3")
            check(launches == expect, f"{label}: launches {launches} != {expect}")
            out[f"kd{kd}.{uplo}"] = res
            del X, L, Ab
        if kd == KD_NARROW:
            t_lib = cuda_ms(lambda: torch.cholesky_solve(B, torch.linalg.cholesky(A)), reps=3)
            out["cholesky_cholesky_solve_ms"] = t_lib
            print(f"  torch.linalg.cholesky + cholesky_solve {dtype} n={n} (dense): "
                  f"{t_lib:.3f} ms (yardstick)", flush=True)
        del A
        torch.cuda.empty_cache()
    return out


def gbsv_phase(stt, pk, lk, metrics, dtype, gen, dev) -> dict:
    """gbsv at n = 16384, nrhs = 512, A = a normal band + 2 I: kl = ku =
    128 (the windowed band LU, one panel_lu launch a window at (256,
    128), band_lperms set; panel_lu there bit for bit against its plain
    version; timed against lu_factor + lu_solve), and kl = ku = 4096
    (the dense getrf: ``getrf_kernel_launches``)."""
    dt = getattr(torch, dtype)
    n, nrhs = N_MAIN, NRHS_MAIN
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Bm = stt.Matrix.from_global(B, 512)
    out = {}
    for klu in (KLU_NARROW, KD_WIDE):
        A = _band(torch.randn(n, n, generator=gen, device=dev, dtype=dt), klu, klu)
        A.diagonal().add_(2)
        Ab = stt.BandMatrix.from_global(A, klu, klu, 512)
        (X, LU, piv, info), t, launches, peak = _band_run(pk, metrics, lambda: stt.gbsv(Ab, Bm))
        tm = metrics.timers()
        r = scaled_residual(A, X.to_global(), B)
        label = f"gbsv {dtype} n={n} kl=ku={klu}"
        res = {"s": t, "gbtrf_s": tm["gbtrf"]["total_s"], "gbtrs_s": tm["gbtrs"]["total_s"],
               "residual": r, "launches": launches, "peak_gb": peak}
        if klu == KLU_NARROW:
            w = piv.band_w
            steps = -(-n // w)
            expect = {"panel_lu": steps}
            check(piv.band_lperms is not None and tuple(piv.band_lperms.shape) == (steps, w + klu),
                  f"{label}: band_lperms not set")
            how = f"{steps} windows of {w}, gbtrf {res['gbtrf_s'] / steps * 1e3:.3f} ms a window"
        else:
            expect = {"panel_lu": lk.getrf_kernel_launches(n)}
            check(piv.band_lperms is None, f"{label}: the dense route set band_lperms")
            how = "dense getrf"
        print(f"  {label}: residual {r:.3e} (bound {GBSV_BOUND}), info {int(info)}, {t:.3f} s "
              f"(gbtrf {res['gbtrf_s']:.3f} s, gbtrs {res['gbtrs_s']:.3f} s; {how}), launches "
              f"{launches} (expected {expect}), peak {peak:.2f} GB", flush=True)
        check(int(info) == 0, f"{label}: info = {int(info)}")
        check(r <= GBSV_BOUND, f"{label}: scaled residual {r:.3f} > {GBSV_BOUND}")
        check(launches == expect, f"{label}: launches {launches} != {expect}")
        del X, LU, piv, Ab
        if klu == KLU_NARROW:
            # the window panel as band_getrf takes it: a view of the padded band
            P = A[n // 2:n // 2 + w + klu, n // 2:n // 2 + w]
            got, perm = pk.panel_lu(P)
            ref, ref_perm = pk.panel_lu_plain(P)
            check(torch.equal(perm, ref_perm), f"{label}: window panel_lu perm differs")
            check(torch.equal(got, ref), f"{label}: window panel_lu not bitwise equal")
            res["window_panel_lu_ms"] = cuda_ms(lambda: pk.panel_lu(P), reps=5)
            res["window_panel_lu_plain_ms"] = cuda_ms(lambda: pk.panel_lu_plain(P), reps=3)
            t_lib = cuda_ms(lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor(A), B), reps=3)
            out["lu_factor_lu_solve_ms"] = t_lib
            print(f"  panel_lu {dtype} at the window ({w + klu}, {w}): lu and perm bitwise equal "
                  f"to the plain version, {res['window_panel_lu_ms']:.4f} ms, plain "
                  f"{res['window_panel_lu_plain_ms']:.3f} ms; torch.linalg.lu_factor + lu_solve "
                  f"n={n} (dense): {t_lib:.3f} ms (yardstick)", flush=True)
        out[f"klu{klu}"] = res
        del A
        torch.cuda.empty_cache()
    return out


def tbsm_phase(stt, pk, metrics, dtype, gen, dev) -> dict:
    """tbsm at n = 16384, kd = 256, alpha = 1: lower and upper, Side.Left
    (nrhs = 512) and Side.Right (512 rows), and one transposed op; each
    against one ``solve_triangular`` of the dense T."""
    dt = getattr(torch, dtype)
    n, nrhs, kd = N_MAIN, NRHS_MAIN, KD_NARROW
    out = {}
    for uplo in ("Lower", "Upper"):
        G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
        T = _band(G, kd, 0) if uplo == "Lower" else _band(G, 0, kd)
        del G
        T.diagonal().add_(kd + 2)
        M = stt.Matrix.from_global(T, 512)
        Tb = stt.TriangularBandMatrix(M.data, M.layout, grid=M.grid, kd=kd, uplo=stt.Uplo[uplo])
        del M
        cases = [("NoTrans", "Left"), ("NoTrans", "Right")]
        if uplo == "Lower":
            cases.append(("Trans", "Left"))
        for op, side in cases:
            A = Tb if op == "NoTrans" else stt.transpose(Tb)
            opT = T if op == "NoTrans" else T.T
            shape = (n, nrhs) if side == "Left" else (nrhs, n)
            B = torch.randn(*shape, generator=gen, device=dev, dtype=dt)
            Bm = stt.Matrix.from_global(B, 512)
            X, t, launches, peak = _band_run(
                pk, metrics, lambda: stt.tbsm(stt.Side[side], 1.0, A, Bm).to_global())
            if side == "Left":
                r = scaled_residual(opT, X, B)
                lib = lambda: torch.linalg.solve_triangular(  # noqa: E731
                    opT, B, upper=(uplo == "Upper") == (op == "NoTrans"))
            else:
                r = scaled_residual(opT.T, X.T, B.T)
                lib = lambda: torch.linalg.solve_triangular(  # noqa: E731
                    opT, B, upper=(uplo == "Upper") == (op == "NoTrans"), left=False)
            t_lib = cuda_ms(lib, reps=3)
            label = f"tbsm {dtype} n={n} kd={kd} {uplo} {op} {side}"
            print(f"  {label}: residual {r:.3e}, {t:.3f} s, launches {launches or 0}, peak "
                  f"{peak:.2f} GB; solve_triangular (dense) {t_lib:.3f} ms", flush=True)
            check(r <= 3, f"{label}: scaled residual {r:.3f} > 3")
            check(not launches, f"{label}: kernels launched {launches}")
            out[f"{uplo}.{op}.{side}"] = {"s": t, "residual": r, "peak_gb": peak,
                                          "solve_triangular_ms": t_lib}
            del X, B, Bm
        del T, Tb
        torch.cuda.empty_cache()
    return out


def band_multiply_phase(stt, pk, dtype, gen, dev) -> dict:
    """gbmm (kl = ku = 128) and hbmm (kd = 128, Side.Left) at n = 16384,
    512 columns, against ``torch.matmul`` of the masked dense matrix,
    elementwise within 10 sqrt(n) eps |A||B|."""
    dt = getattr(torch, dtype)
    n, nrhs, k = N_MAIN, NRHS_MAIN, KLU_NARROW
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Bm, Cm = stt.Matrix.from_global(B, 512), stt.Matrix.from_global(torch.zeros_like(B), 512)
    G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    out = {}
    Ag = stt.BandMatrix.from_global(G, k, k, 512)
    H = G + G.T  # stored triangle: the lower one
    M = stt.Matrix.from_global(torch.tril(H), 512)
    Ah = stt.HermitianBandMatrix(M.data, M.layout, grid=M.grid, kd=k)
    del M
    dense = {"gbmm": _band(G, k, k), "hbmm": _band(H, k, k)}
    del G, H
    for name, fn in (("gbmm", lambda: stt.gbmm(1.0, Ag, Bm, 0.0, Cm)),
                     ("hbmm", lambda: stt.hbmm(stt.Side.Left, 1.0, Ah, Bm, 0.0, Cm))):
        pk.reset_launches()
        got = fn().to_global()
        torch.cuda.synchronize()
        launches = {k_: v for k_, v in pk.LAUNCHES.items() if v}
        D = dense[name]
        ref = torch.matmul(D, B)
        err, ratio = elementwise_err(got, ref, torch.matmul(D.abs(), B.abs()), n)
        t = cuda_ms(lambda: fn(), reps=3)
        t_lib = cuda_ms(lambda: torch.matmul(D, B), reps=3)
        print(f"  {name} {dtype} n={n} k={k}: max err {err:.3e} (max err/tol {ratio:.3e}), "
              f"{t:.3f} ms, torch.matmul (dense) {t_lib:.3f} ms, launches {launches or 0}",
              flush=True)
        check(ratio <= 1, f"{name} {dtype}: max err/tol {ratio:.3e} > 1")
        check(not launches, f"{name} {dtype}: kernels launched {launches}")
        out[name] = {"max_abs_err": err, "err_over_tol": ratio, "ms": t, "matmul_ms": t_lib}
        del got, ref
    return out


def hesv_phase(stt, pk, lk, metrics, dtype, gen, dev) -> dict:
    """hesv at n = 16384, nrhs = 512, A = (G + G^T)/2 + 3 sqrt(n) diag(s),
    s a seeded +-1 vector: indefinite, its leading minors far from
    singular, so the pivot-free LDL^H holds (info 0, no Aasen or
    butterfly on L; getrf_nopiv's panel_lu launches without pivot search,
    ``getrf_kernel_launches``); residual <= 3 after the two refinement
    sweeps; timed against ldl_factor + ldl_solve."""
    dt = getattr(torch, dtype)
    n, nrhs = N_MAIN, NRHS_MAIN
    G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    A = (G + G.T) / 2
    del G
    s = torch.where(torch.randn(n, generator=gen, device=dev, dtype=dt) >= 0, 1.0, -1.0)
    A.diagonal().add_(3 * n**0.5 * s)
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.HermitianMatrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    (X, L, d, info), t, launches, peak = _band_run(pk, metrics, lambda: stt.hesv(Am, Bm))
    tm = metrics.timers()
    r = scaled_residual(A, X.to_global(), B)
    route = "aasen" if getattr(L, "_aasen", None) is not None else (
        "rbt" if getattr(L, "_rbt", None) is not None else "pivot-free")
    expect = {"panel_lu": lk.getrf_kernel_launches(n)}
    label = f"hesv {dtype} n={n} nrhs={nrhs}"
    del X, L, d
    t_lib = cuda_ms(lambda: torch.linalg.ldl_solve(*torch.linalg.ldl_factor(A), B), reps=1)
    print(f"  {label}: residual {r:.3e}, info {int(info)}, route {route}, {t:.3f} s (hetrf "
          f"{tm['hetrf']['total_s']:.3f} s, hetrs {tm['hetrs']['total_s']:.3f} s for 3 solves), "
          f"launches {launches} (expected {expect}), peak {peak:.2f} GB; "
          f"torch.linalg.ldl_factor + ldl_solve {t_lib:.3f} ms (yardstick)", flush=True)
    check(int(info) == 0, f"{label}: info = {int(info)}")
    check(route == "pivot-free", f"{label}: route {route}, not pivot-free")
    check(launches == expect, f"{label}: launches {launches} != {expect}")
    check(r <= 3, f"{label}: scaled residual {r:.3f} > 3")
    return {"s": t, "hetrf_s": tm["hetrf"]["total_s"], "hetrs_s": tm["hetrs"]["total_s"],
            "residual": r, "launches": launches, "peak_gb": peak, "ldl_factor_solve_ms": t_lib}


def hetrf_rbt_phase(stt, pk, metrics, gen, dev) -> dict:
    """hetrf(method="rbt") + hetrs at n = 16384, float64, A = kron(I,
    [[0, 1], [1, 0]]), whose odd leading minors vanish: the pivot-free pass
    breaks down, the full-depth butterfly (log2 n = 14 levels) runs
    2 x 14 butterfly_level launches for the factor and 2 x 14 for the
    solve; residual <= RBT_BOUND."""
    n, nrhs, dt = N_MAIN, NRHS_MAIN, torch.float64
    A = torch.zeros(n, n, device=dev, dtype=dt)
    i = torch.arange(0, n, 2, device=dev)
    A[i, i + 1] = 1.0
    A[i + 1, i] = 1.0
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Am, Bm = stt.HermitianMatrix.from_global(A, 512), stt.Matrix.from_global(B, 512)
    (L, d, info), t_f, l_f, peak = _band_run(pk, metrics, lambda: stt.hetrf(Am, method="rbt"))
    X, t_s, l_s, _ = _band_run(pk, metrics, lambda: stt.hetrs(L, d, Bm).to_global())
    r = scaled_residual(A, X, B)
    depth = n.bit_length() - 1
    print(f"  hetrf(rbt) + hetrs float64 n={n} kron(I, [[0,1],[1,0]]): residual {r:.3e} (bound "
          f"{RBT_BOUND}), info {int(info)} (of the randomized factor), hetrf {t_f:.3f} s "
          f"(launches {l_f}), hetrs {t_s:.3f} s (launches {l_s}), peak {peak:.2f} GB",
          flush=True)
    check(getattr(L, "_rbt", None) is not None, "hetrf(rbt): no butterfly refactor")
    check(l_f.get("butterfly_level") == 2 * depth,
          f"hetrf(rbt): butterfly_level launches {l_f.get('butterfly_level')} != {2 * depth}")
    check(l_s == {"butterfly_level": 2 * depth},
          f"hetrs(rbt): launches {l_s} != {{'butterfly_level': {2 * depth}}}")
    check(r <= RBT_BOUND, f"hetrf(rbt) + hetrs: scaled residual {r:.3f} > {RBT_BOUND}")
    return {"hetrf_s": t_f, "hetrs_s": t_s, "residual": r, "info": int(info),
            "launches_hetrf": l_f, "launches_hetrs": l_s, "peak_gb": peak}


def aasen_phase(stt, pk, dtype, dev) -> dict:
    """hetrf(method="aasen") + hetrs and hesv (auto: the pivot-free pass
    breaks down and refactors with Aasen) on the zero-diagonal chain of
    tests/test_band_indefinite.py:333 at n = N_AASEN, nrhs = 512.  Cut from
    16384: Aasen's LTL^H is the reference's host column loop, O(n^3) in
    numpy BLAS-2 calls, minutes at 16384.  Host-clock times."""
    dt = getattr(torch, dtype)
    n, nrhs = N_AASEN, NRHS_MAIN
    A = torch.diag(torch.ones(n - 1, device=dev, dtype=dt), 1)
    A = A + A.T
    B = torch.randn(n, nrhs, device=dev, dtype=dt,
                    generator=torch.Generator(device=dev).manual_seed(n))
    Am, Bm = stt.HermitianMatrix.from_global(A, 256), stt.Matrix.from_global(B, 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L, d, info = stt.hetrf(Am, method="aasen")
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = stt.hetrs(L, d, Bm).to_global()
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    r = scaled_residual(A, X, B)
    t0 = time.perf_counter()
    Xa, La, _, info_a = stt.hesv(Am, Bm)
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    r_a = scaled_residual(A, Xa.to_global(), B)
    print(f"  Aasen {dtype} n={n} (zero-diagonal chain): hetrf(aasen) {t_f:.3f} s host, hetrs "
          f"{t_s:.3f} s, residual {r:.3e}; hesv (auto) {t_a:.3f} s, route "
          f"{'aasen' if getattr(La, '_aasen', None) is not None else 'other'}, residual "
          f"{r_a:.3e}", flush=True)
    check(int(info) == 0 and getattr(L, "_aasen", None) is not None, "hetrf(aasen) failed")
    check(getattr(La, "_aasen", None) is not None and int(info_a) == 0,
          "hesv: the chain's breakdown did not refactor with Aasen")
    check(r <= 3 and r_a <= 3, f"Aasen {dtype}: scaled residuals {r:.3f}, {r_a:.3f} > 3")
    return {"hetrf_aasen_s": t_f, "hetrs_s": t_s, "residual": r, "hesv_auto_s": t_a,
            "hesv_residual": r_a}


def band_complex_phase(stt, pk, gen, dev) -> dict:
    """complex128 pbsv (kd = 64), gbsv (kl = ku = 32) and hesv at n = 2048:
    the plain window panel and the flat / recursive schedules, no kernel
    launched, residuals within bound."""
    n, nrhs, dt = 2048, 3, torch.complex128
    B = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dt)
    Bm = stt.Matrix.from_global(B, 256)
    pk.reset_launches()
    t0 = time.perf_counter()
    A1 = _sym_band(n, 64, dt, gen, dev)
    M = stt.Matrix.from_global(torch.tril(A1), 256)
    X1, _, info1 = stt.pbsv(stt.HermitianBandMatrix(M.data, M.layout, grid=M.grid, kd=64), Bm)
    A2 = _band(torch.randn(n, n, generator=gen, device=dev, dtype=dt), 32, 32)
    A2.diagonal().add_(2)
    X2, _, piv2, info2 = stt.gbsv(stt.BandMatrix.from_global(A2, 32, 32, 256), Bm)
    G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    A3 = (G + G.mH) / 2
    s = torch.where(torch.randn(n, generator=gen, device=dev, dtype=torch.float64) >= 0, 1.0, -1.0)
    A3.diagonal().add_((3 * n**0.5 * s).to(dt))
    X3, L3, _, info3 = stt.hesv(stt.HermitianMatrix.from_global(A3, 256), Bm)
    torch.cuda.synchronize()
    launched = {k: v for k, v in pk.LAUNCHES.items() if v}
    eps = torch.finfo(torch.float64).eps
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    res = lambda A, X, B: n1(A @ X - B) / (n1(A) * n1(X) * n * eps)  # noqa: E731
    r = {"pbsv": res(A1, X1.to_global(), B), "gbsv": res(A2, X2.to_global(), B),
         "hesv": res(A3, X3.to_global(), B)}
    print(f"  complex128 n={n}: scaled residuals "
          + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
          + f"; info {int(info1)}, {int(info2)}, {int(info3)}; band_lperms "
          f"{'set' if piv2.band_lperms is not None else 'unset'}; kernel launches "
          f"{launched or 0}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(int(info1) == int(info2) == int(info3) == 0, "complex128 band/indefinite: info != 0")
    check(piv2.band_lperms is not None, "complex128 gbsv: not the windowed route")
    check(getattr(L3, "_aasen", None) is None and getattr(L3, "_rbt", None) is None,
          "complex128 hesv: not pivot-free")
    for k, v in r.items():
        check(v <= (GBSV_BOUND if k == "gbsv" else 3), f"complex128 {k}: scaled residual {v:.3e}")
    check(not launched, f"complex128 band/indefinite: kernels launched {launched}")
    return r


# ---------------------------------------------------------------------------
# phase 15: the Hermitian eigensolvers
# ---------------------------------------------------------------------------

N_EIG, NB_EIG = 4096, 128  # the JAX package's on-chip heev size (tools/validate_onchip.py)
N_EIG_C128 = 1024  # complex128: the device wavefront, cut for time
N_HEGV3 = 1024  # hegv itype 3 with an Upper B: the LAPACK formulas on the card
EIG_BOUND = 100  # tools/validate_onchip.py:151: residual and orthogonality <= 100
STAGES = ("he2hb+gather", "hb2st", "stedc+unmtr_hb2st", "eigvals", "unmtr_he2hb")


def _herm(n, dt, gen, dev):
    G = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    return (G + G.mH) / 2


def eig_gates(A, w, Z, wref, eps) -> dict:
    """Eigenvalue error / (n eps ||A||_1) against ``wref``, and (with Z)
    ||AZ - Z Lambda||_1 / (||A||_1 n eps), ||Z^H Z - I||_1 / (n eps), all
    in 64 bits on the card."""
    up = torch.complex128 if A.is_complex() else torch.float64
    A64, w64 = A.to(up), w.double()
    n = A.shape[0]
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    a1 = n1(A64)
    out = {"eigval_err": float((w64 - wref.double()).abs().max()) / (n * eps * a1)}
    if Z is not None:
        Z64 = Z.to(up)
        out["residual"] = n1(A64 @ Z64 - Z64 * w64.to(up)[None, :]) / (a1 * n * eps)
        out["orthogonality"] = n1(Z64.mH @ Z64 - torch.eye(n, dtype=up, device=A.device)) / (
            n * eps)
    return out


def _eig_run(pk, metrics, fn):
    """``_band_run`` of one call, and the call's ``heev.*`` stage seconds
    and hb2st route counts."""
    out, t, launches, peak = _band_run(pk, metrics, fn)
    tm, c = metrics.timers(), metrics.counters()
    stages = {s: tm[f"heev.{s}"]["total_s"] for s in STAGES if f"heev.{s}" in tm}
    route = {k: int(c.get(f"heev.hb2st.{k}", 0)) for k in ("host", "device")}
    return out, t, stages, route, launches, peak


def heev_phase(stt, pk, metrics, dtype, n, gen, dev, vectors=True) -> dict:
    """heev of (G + G^H)/2 at n, tiles of 128, default options (its
    two-stage path, ``heev_staged``); the gates against eigvalsh /
    eigh on the same card, which are also the yardsticks."""
    dt = getattr(torch, dtype)
    A = _herm(n, dt, gen, dev)
    Am = stt.HermitianMatrix.from_global(A, NB_EIG)
    t_all = time.perf_counter()
    (w, Z), t, stages, route, launches, peak = _eig_run(
        pk, metrics, lambda: stt.heev(Am, vectors=vectors))
    Zg = Z.to_global() if Z is not None else None
    up = torch.complex128 if A.is_complex() else torch.float64
    wref = torch.linalg.eigvalsh(A.to(up))
    eps = torch.finfo(dt).eps
    g = eig_gates(A, w, Zg, wref, eps)
    lib = torch.linalg.eigh if vectors else torch.linalg.eigvalsh
    t_lib = cuda_ms(lambda: lib(A), reps=1)
    label = f"heev {dtype} n={n} {'vectors' if vectors else 'values'}"
    print(f"  {label}: {t:.3f} s host clock, stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; hb2st route {route}; gates " + ", ".join(f"{k} {v:.3e}" for k, v in g.items())
          + f"; kernel launches {launches or 0}; peak {peak:.2f} GB; torch.linalg."
          f"{'eigh' if vectors else 'eigvalsh'} {t_lib:.3f} ms (yardstick); "
          f"{time.perf_counter() - t_all:.1f} s with the checks", flush=True)
    check(g["eigval_err"] <= 10, f"{label}: eigenvalue error {g['eigval_err']:.3e} > 10 n eps")
    if vectors:
        check(g["residual"] <= EIG_BOUND, f"{label}: residual {g['residual']:.3e}")
        check(g["orthogonality"] <= EIG_BOUND, f"{label}: orthogonality {g['orthogonality']:.3e}")
    expect = "host" if dt == torch.float64 else "device"
    check(route == {"host": int(expect == "host"), "device": int(expect == "device")},
          f"{label}: hb2st route {route}, expected the {expect} route")
    check(not launches, f"{label}: launched {launches} (the eigensolver reaches no kernel)")
    return {"s": t, "stages_s": stages, "route": route, "gates": g, "peak_gb": peak,
            "library_ms": t_lib}


def hegv_phase(stt, pk, ck, metrics, gen, dev, itype=1, upper=False, n=N_EIG) -> dict:
    """hegv at n, float64: A = (G + G^T)/2, B = X X^T + n I stored Lower,
    or Upper (B = U^T U); potrf(B) launches the Cholesky kernels at
    ``chol_kernel_launches`` from the crossover up; the scaled residual of
    the itype, ||AX - BX Lambda||_1 / (||A||_1 ||X||_1 n eps) (itype 1) or
    ||BAX - X Lambda||_1 / (||A||_1 ||B||_1 ||X||_1 n eps) (itype 3), <= 100;
    the eigenvalues against cuSOLVER's route: cholesky, the reduction
    (two solve_triangular for itype 1, two products for itype 3), eigh
    and the back-transform."""
    dt = torch.float64
    A = _herm(n, dt, gen, dev)
    X0 = torch.randn(n, n, generator=gen, device=dev, dtype=dt)
    B = X0 @ X0.T
    B.diagonal().add_(n)
    del X0
    uplo = stt.Uplo.Upper if upper else stt.Uplo.Lower
    Am = stt.HermitianMatrix.from_global(A, NB_EIG)
    Bm = stt.HermitianMatrix.from_global(B, NB_EIG, uplo=uplo)
    (w, X, info), t, stages, route, launches, peak = _eig_run(
        pk, metrics, lambda: stt.hegv(itype, Am, Bm))
    Xg = X.to_global()
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    eps = torch.finfo(dt).eps
    if itype == 1:
        r = n1(A @ Xg - (B @ Xg) * w[None, :]) / (n1(A) * n1(Xg) * n * eps)
    else:
        r = n1(B @ (A @ Xg) - Xg * w[None, :]) / (n1(A) * n1(B) * n1(Xg) * n * eps)

    def library():
        L = torch.linalg.cholesky(B)
        if itype == 1:
            C = torch.linalg.solve_triangular(
                L, torch.linalg.solve_triangular(L, A, upper=False).mH, upper=False).mH
            wl, Y = torch.linalg.eigh(C)
            return wl, torch.linalg.solve_triangular(L.mH, Y, upper=True)
        wl, Y = torch.linalg.eigh(L.mH @ A @ L)
        return wl, L @ Y

    t_lib = cuda_ms(library, reps=1)
    wl, _ = library()
    werr = float((w - wl).abs().max()) / (n * eps * float(wl.abs().max()))
    expect = ({k: v for k, v in ck.chol_kernel_launches(n).items() if v}
              if n >= ck.RECURSIVE_MIN_N else {})
    label = f"hegv float64 n={n} itype {itype}{' Upper B' if upper else ''}"
    print(f"  {label}: {t:.3f} s host clock, heev stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; residual {r:.3e}, info {int(info)}, eigenvalues vs the library route "
          f"{werr:.3e} n eps max|w|; hb2st route {route}; launches {launches} (expected "
          f"{expect}); peak {peak:.2f} GB; the library route {t_lib:.3f} ms (yardstick)",
          flush=True)
    check(int(info) == 0, f"{label}: info {int(info)}")
    check(r <= EIG_BOUND, f"{label}: residual {r:.3e} > {EIG_BOUND}")
    check(werr <= 10, f"{label}: eigenvalues differ from the library route by {werr:.3e}")
    check(launches == expect, f"{label}: launches {launches} != {expect}")
    check(route == {"host": 1, "device": 0}, f"{label}: hb2st route {route}")
    return {"s": t, "stages_s": stages, "residual": r, "launches": launches, "peak_gb": peak,
            "library_ms": t_lib}


def eig_main(stt, pk, ck, metrics, gen, dev) -> dict:
    """Phase 15: heev with vectors at n = 4096 in float64 (the host
    chaser) and float32 (the device wavefront), values only in float64
    (the Sturm bisection), hegv in float64 (itype 1 at n = 4096, itype 3
    with an Upper B at n = 1024), complex128 heev at n = 1024."""
    t15 = time.perf_counter()
    eres = {}
    for d in DTYPES:
        eres[f"heev_{d}"] = heev_phase(stt, pk, metrics, d, N_EIG, gen, dev)
        torch.cuda.empty_cache()
    eres["heev_values_float64"] = heev_phase(stt, pk, metrics, "float64", N_EIG, gen, dev,
                                             vectors=False)
    eres["hegv_float64"] = hegv_phase(stt, pk, ck, metrics, gen, dev)
    torch.cuda.empty_cache()
    eres[f"hegv_itype3_upper_float64_{N_HEGV3}"] = hegv_phase(
        stt, pk, ck, metrics, gen, dev, itype=3, upper=True, n=N_HEGV3)
    eres[f"heev_complex128_{N_EIG_C128}"] = heev_phase(stt, pk, metrics, "complex128",
                                                       N_EIG_C128, gen, dev)
    torch.cuda.empty_cache()
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s", flush=True)
    return eres


def _kernel_stats(e):
    """(launches, summed kernel ms) of the device kernels launched under
    a profiler event and its children."""
    ks = getattr(e, "kernels", ())
    n, ms = len(ks), sum(k.duration for k in ks) / 1e3
    for c in e.cpu_children:
        cn, cms = _kernel_stats(c)
        n, ms = n + cn, ms + cms
    return n, ms


def eig_profile(stt, gen, dev) -> dict:
    """A profiled warm float64 heev at n = 4096 (host chaser): device
    time and kernel launches by stage and of he2hb's panel factor
    against its trailing update; then the device wavefront's launches a
    superstep and the Sturm scan's launches a row step, from a float32
    hb2st at n = 512 and a bisection at n = 256."""
    from slate_tpu_torch.ops import bulge

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    A = _herm(N_EIG, torch.float64, gen, dev)
    Am = stt.HermitianMatrix.from_global(A, NB_EIG)
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stt.heev(Am)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    ranges = {}
    for e in prof.events():
        if e.name.startswith("heev.") or e.name in ("he2hb.panel", "he2hb.update"):
            r = ranges.setdefault(e.name, {"busy_ms": 0.0, "launches": 0, "host_ms": 0.0})
            k, ms = _kernel_stats(e)
            r["busy_ms"] += ms
            r["launches"] += k
            r["host_ms"] += e.cpu_time_total / 1e3
    for name, r in ranges.items():
        print(f"  profiled {name}: device busy {r['busy_ms']:.3f} ms in {r['launches']} "
              f"launches, host {r['host_ms']:.3f} ms (idle share "
              f"{max(0.0, 1 - r['busy_ms'] / max(r['host_ms'], 1e-9)):.3f})", flush=True)
    pan, upd = ranges.get("he2hb.panel", {}), ranges.get("he2hb.update", {})
    busy = pan.get("busy_ms", 0) + upd.get("busy_ms", 0)
    share = pan.get("busy_ms", 0) / max(busy, 1e-9)
    print(f"  he2hb panel share of he2hb's device busy time {share:.3f} (panel "
          f"{pan.get('busy_ms', 0):.3f} ms in {pan.get('launches', 0)} launches, trailing "
          f"update {upd.get('busy_ms', 0):.3f} ms in {upd.get('launches', 0)} launches; "
          f"profiled heev {t_prof:.3f} s wall)", flush=True)
    out = {"ranges": ranges, "he2hb_panel_share": share}
    n, b = 512, NB_EIG
    W = bulge.band_to_storage(torch.tril(torch.triu(_herm(n, torch.float32, gen, dev), -b), b),
                              b, n + 4 * b + 8)
    steps = 3 * (n - 3) + (n - 3) // b + 2
    with torch.profiler.profile(activities=act) as prof:
        bulge.hb2st(W, n, b)
        torch.cuda.synchronize()
    k = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    out["hb2st_launches_per_superstep"] = k / steps
    d = torch.randn(256, generator=gen, device=dev, dtype=torch.float64)
    e = torch.randn(255, generator=gen, device=dev, dtype=torch.float64)
    with torch.profiler.profile(activities=act) as prof:
        bulge.tridiag_eigvals_bisect(d, e)
        torch.cuda.synchronize()
    k2 = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    out["bisect_launches_per_row_step"] = k2 / (64 * 256)
    print(f"  hb2st wavefront: {k} launches over {steps} supersteps ({k / steps:.1f} a "
          f"superstep, float32 n={n}); Sturm bisection: {k2} launches over 64 x 256 row "
          f"steps ({k2 / (64 * 256):.2f} a step)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the SVD
# ---------------------------------------------------------------------------

# (case, m, n, nb, dtype, vectors, the hb2st route or None): (a) tall, the
# geqrf pre-reduction (larft kernel) -> the JW route on the host chaser ->
# unmqr; (b) square on the device wavefront; (c) values only, host chase
# + Sturm bisection; (d) m < n < 2m, svd_accurate on the gathered band;
# (e) complex128 on the wavefront, cut to n = 1024 as phase 15's c128 case
SVD_CASES = (
    ("a", 8192, 2048, 64, "float64", True, "host"),
    ("b", 2048, 2048, 64, "float32", True, "device"),
    ("c", 2048, 2048, 64, "float64", False, "host"),
    ("d", 1024, 1536, 128, "float64", True, None),
    ("e", 1024, 1024, 64, "complex128", True, "device"),
)
SVD_TIMERS = ("geqrf", "ge2tb", "spmd.upper_band_diagonals_tiles", "svd.hb2st",
              "svd.eigvals", "stedc", "svd.unmtr_hb2st", "unmbr_ge2tb_left",
              "unmbr_ge2tb_right", "unmqr")


def _timed(fn):
    """(fn(), its CUDA-event ms): one call, no warm-up."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def svd_gates(A, s, U, Vh, sref, eps) -> dict:
    """Singular-value error / (max(m, n) eps sigma_max) against ``sref``
    (svdvals of the float64 operand), and (with U, Vh)
    ||A - U S V^H||_1 / (||A||_1 max(m, n) eps), ||U^H U - I||_1 / (k eps)
    and ||V^H V - I||_1 / (k eps), k = min(m, n), all in 64 bits."""
    up = torch.complex128 if A.is_complex() else torch.float64
    m, n = A.shape
    k, mx = min(m, n), max(m, n)
    n1 = lambda M: float(torch.linalg.matrix_norm(M, ord=1))  # noqa: E731
    out = {"sval_err": float((s.double() - sref).abs().max()) / (mx * eps * float(sref[0]))}
    if U is not None:
        A64, U64, Vh64 = A.to(up), U.to(up), Vh.to(up)
        out["reconstruction"] = n1(A64 - (U64 * s.to(up)[None, :]) @ Vh64) / (n1(A64) * mx * eps)
        eye = torch.eye(k, dtype=up, device=A.device)
        out["orthogonality_u"] = n1(U64.mH @ U64 - eye) / (k * eps)
        out["orthogonality_v"] = n1(Vh64 @ Vh64.mH - eye) / (k * eps)
    return out


def svd_case(stt, pk, qf, metrics, case, gen, dev) -> dict:
    """One SVD of a seeded normal operand through ``stt.svd`` (default
    options): host-clock time, the stage times of the instrumented
    sub-drivers, the hb2st route, launches, peak memory, the gates, and
    cuSOLVER's ``svd(full_matrices=False)`` and ``svdvals`` on the same
    operand as yardsticks (one call each; svdvals of the float64 operand
    is the gates' reference)."""
    label, m, n, nb, dtype, vectors, route_expect = case
    dt = getattr(torch, dtype)
    A = torch.randn(m, n, generator=gen, device=dev, dtype=dt)
    Am = stt.Matrix.from_global(A, nb)
    (s, U, Vh), t, launches, peak = _band_run(pk, metrics, lambda: stt.svd(Am, vectors=vectors))
    tm, c = metrics.timers(), metrics.counters()
    stages = {k: tm[k]["total_s"] for k in SVD_TIMERS if k in tm}
    route = {k: int(c.get(f"svd.hb2st.{k}", 0)) for k in ("host", "device")}
    Ug = U.to_global() if U is not None else None
    Vhg = Vh.to_global() if Vh is not None else None
    up = torch.complex128 if A.is_complex() else torch.float64
    sv, t_vals = _timed(lambda: torch.linalg.svdvals(A))
    sref = sv if A.dtype == up else torch.linalg.svdvals(A.to(up))
    g = svd_gates(A, s, Ug, Vhg, sref, torch.finfo(dt).eps)
    _, t_svd = _timed(lambda: torch.linalg.svd(A, full_matrices=False))
    name = f"svd ({label}) {dtype} ({m}, {n}) tiles {nb} {'vectors' if vectors else 'values'}"
    print(f"  {name}: {t:.3f} s host clock, stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; hb2st route {route}; gates " + ", ".join(f"{k} {v:.3e}" for k, v in g.items())
          + f"; kernel launches {launches or 0}; peak {peak:.2f} GB; torch.linalg.svd "
          f"{t_svd:.3f} ms, svdvals {t_vals:.3f} ms (yardsticks, one call each)", flush=True)
    check(g["sval_err"] <= 10, f"{name}: singular-value error {g['sval_err']:.3e} > 10")
    for k in ("reconstruction", "orthogonality_u", "orthogonality_v"):
        check(k not in g or g[k] <= EIG_BOUND, f"{name}: {k} {g.get(k, 0):.3e} > {EIG_BOUND}")
    expect_route = {"host": int(route_expect == "host"), "device": int(route_expect == "device")}
    check(route == expect_route, f"{name}: hb2st route {route}, expected {expect_route}")
    expect = {"larft": qf.geqrf_kernel_launches(n)} if m >= 2 * n else {}
    check(launches == expect, f"{name}: launches {launches} != {expect}")
    return {"s": t, "stages_s": stages, "route": route, "gates": g, "launches": launches,
            "peak_gb": peak, "library_svd_ms": t_svd, "library_svdvals_ms": t_vals}


def svd_main(stt, pk, qf, metrics, gen, dev) -> dict:
    """Phase 16: the five SVD cases of ``SVD_CASES``."""
    t16 = time.perf_counter()
    out = {}
    for case in SVD_CASES:
        out[f"{case[0]}_{case[4]}_{case[1]}x{case[2]}"] = svd_case(stt, pk, qf, metrics, case,
                                                                  gen, dev)
        torch.cuda.empty_cache()
    print(f"  phase 16: {time.perf_counter() - t16:.1f} s", flush=True)
    return out


def svd_profile(stt, gen, dev) -> dict:
    """A profiled warm float64 SVD of case (a), (8192, 2048) in tiles of
    64 with vectors: device busy time, launches and host time by stage
    (the ``svd.*`` ranges), and ge2tb's panels against its trailing
    updates."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _, m, n, nb, dtype, _, _ = SVD_CASES[0]
    A = torch.randn(m, n, generator=gen, device=dev, dtype=getattr(torch, dtype))
    Am = stt.Matrix.from_global(A, nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stt.svd(Am, vectors=True)  # the warm-up
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stt.svd(Am, vectors=True)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    ranges = {}
    for e in prof.events():
        if e.name.startswith("svd.") or e.name.startswith("ge2tb."):
            r = ranges.setdefault(e.name, {"busy_ms": 0.0, "launches": 0, "host_ms": 0.0})
            k, ms = _kernel_stats(e)
            r["busy_ms"] += ms
            r["launches"] += k
            r["host_ms"] += e.cpu_time_total / 1e3
    for name, r in ranges.items():
        print(f"  profiled {name}: device busy {r['busy_ms']:.3f} ms in {r['launches']} "
              f"launches, host {r['host_ms']:.3f} ms (idle share "
              f"{max(0.0, 1 - r['busy_ms'] / max(r['host_ms'], 1e-9)):.3f})", flush=True)
    part = lambda key, f: sum(ranges.get(f"ge2tb.{p}", {}).get(f, 0)  # noqa: E731
                              for p in key)
    pan_busy = part(("qr_panel", "lq_panel"), "busy_ms")
    upd_busy = part(("qr_update", "lq_update"), "busy_ms")
    share = pan_busy / max(pan_busy + upd_busy, 1e-9)
    print(f"  ge2tb panel share of ge2tb's device busy time {share:.3f} (panels "
          f"{pan_busy:.3f} ms in {part(('qr_panel', 'lq_panel'), 'launches')} launches, host "
          f"{part(('qr_panel', 'lq_panel'), 'host_ms'):.1f} ms; trailing updates {upd_busy:.3f} "
          f"ms in {part(('qr_update', 'lq_update'), 'launches')} launches); warm svd "
          f"{t_warm:.3f} s, profiled {t_prof:.3f} s wall", flush=True)
    return {"ranges": ranges, "ge2tb_panel_share": share, "warm_s": t_warm}


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
    launches cost), and of a ``gesv`` with MethodLU.CALU; a profile of
    one warm ``posv_mixed``, ``posv_mixed_gmres`` and ``gesv_mixed`` on
    the same operands (their float32 factor's kernels and the library
    solves and products as pieces); then the same for ``gels`` at
    (32768, 16384)."""
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
    mixed_pieces = {
        "chol_base": ("chol_base_kernel",),
        "gemm_sub": ("sub_abt_kernel<float, false", "subk_reduce<float, false"),
        "syrk_diag": ("sub_abt_kernel<float, true", "subk_reduce<float, true"),
        "panel_lu": ("panel_lu_kernel",),
        "library trsm": ("trsm",), "library gemm": ("gemm",)}
    for routine in ("posv_mixed", "posv_mixed_gmres"):
        getattr(stt, routine)(Am, Bm)  # the warm-up
        _profile_call(routine, lambda: getattr(stt, routine)(Am, Bm), mixed_pieces)
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
    stt.gesv_mixed(Am, Bm)  # the warm-up
    _profile_call("gesv_mixed", lambda: stt.gesv_mixed(Am, Bm), mixed_pieces)
    calu = {stt.Option.MethodLU: stt.MethodLU.CALU}
    stt.getrf(Am, calu)  # the warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stt.getrf(Am, calu)
    torch.cuda.synchronize()
    print(f"  warm getrf CALU {time.perf_counter() - t0:.4f} s (host clock, float64 n={n})")
    _profile_call("gesv CALU", lambda: stt.gesv(Am, Bm, calu),
                  {"panel_lu": ("panel_lu_kernel",)})
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
    del A, B, Am, Bm
    torch.cuda.empty_cache()
    eig_profile(stt, gen, dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import slate_tpu_torch as stt
        from slate_tpu_torch import serve
        from slate_tpu_torch.aux import faults, metrics
        from slate_tpu_torch.ops import chol_kernels as ck
        from slate_tpu_torch.ops import lu_kernels as lk
        from slate_tpu_torch.ops import qr_fast as qf
        from slate_tpu_torch.ops.hopper import panel_kernels as pk
    except ImportError as e:
        print(f"chip_smoke: slate_tpu_torch is not importable here: {e}", file=sys.stderr)
        return 2
    profile_only = "--profile" in sys.argv[1:]
    eig_only = "--eig" in sys.argv[1:]
    svd_only = "--svd" in sys.argv[1:]
    restore_only = "--restore" in sys.argv[1:]
    admission_only = "--admission" in sys.argv[1:]
    fabric_only = "--fabric" in sys.argv[1:]
    soak_only = "--soak" in sys.argv[1:]
    scale_only = "--scale" in sys.argv[1:]
    fleet_only = "--fleet" in sys.argv[1:]

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
    t_build = time.perf_counter() - t0
    print(f"  built {', '.join(so.name for so in sos)} in {t_build:.2f} s "
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
    if eig_only:
        metrics.on()
        if profile_only:
            print("profile: heev, float64", flush=True)
            eig_profile(stt, gen, dev)
        else:
            print("phase 15: the Hermitian eigensolvers", flush=True)
            eig_main(stt, pk, ck, metrics, gen, dev)
        print(smi)
        return 0
    if svd_only:
        metrics.on()
        if profile_only:
            print("profile: svd, float64 (8192, 2048)", flush=True)
            svd_profile(stt, gen, dev)
        else:
            print("phase 16: the SVD", flush=True)
            svd_main(stt, pk, qf, metrics, gen, dev)
        print(smi)
        return 0
    if restore_only:
        metrics.on()
        print("phase 17: restore, replicas and integrity", flush=True)
        rsres = restore_main(serve, faults, pk, ck, lk, metrics, gen, dev, t_build)
        print("main path: " + json.dumps({"serve_restore": rsres}))
        print(smi)
        return 0
    if admission_only:
        metrics.on()
        print("phase 18: admission, the checked runtime and the device monitor", flush=True)
        adres = admission_main(serve, faults, pk, ck, lk, metrics, gen, dev)
        print("main path: " + json.dumps({"serve_admission": adres}))
        print(smi)
        return 0
    if fabric_only:
        metrics.on()
        print("phase 19: the factor fabric", flush=True)
        fbres = fabric_main(serve, pk, qf, metrics, gen, dev)
        print("main path: " + json.dumps({"serve_fabric": fbres}))
        print(smi)
        return 0
    if soak_only:
        metrics.on()
        print("phase 20: the soak fabric", flush=True)
        skres = soak_main(serve, metrics, pk, dev)
        print("main path: " + json.dumps({"serve_soak": skres}))
        print(smi)
        return 0
    if scale_only:
        metrics.on()
        print("phase 21: the elastic capacity plane", flush=True)
        scres = scale_main(serve, metrics, pk, lk, dev)
        print("main path: " + json.dumps({"serve_scale": scres}))
        print(smi)
        return 0
    if fleet_only:
        metrics.on()
        print("phase 22: the fleet tier", flush=True)
        flres = fleet_main(serve, metrics, lk, dev)
        print("main path: " + json.dumps({"serve_fleet": flres}))
        print(smi)
        return 0
    if profile_only:
        print("profile: posv, gesv, CALU gesv and gels, float64", flush=True)
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
    print("phase 11: the rest of the dense drivers", flush=True)
    t11 = time.perf_counter()
    xres = {}
    for d in DTYPES:
        xres[d] = {"calu": calu_path(stt, pk, lk, metrics, d, gen, dev, lres[d])}
        torch.cuda.empty_cache()
        xres[d]["calu_panels"] = calu_panels(pk, d, gen, dev)
        xres[d]["calu_routes_4096"] = calu_routes(stt, pk, lk, d, gen, dev)
        inv, A, Lg = inverse_phase(stt, ck, d, gen, dev)
        xres[d]["inverses"] = inv
        if d == "float64":
            xres[d]["chol_update"] = chol_update_phase(stt, ck, A, Lg, gen, dev)
        del A, Lg
        torch.cuda.empty_cache()
        xres[d]["gecondest"] = gecondest_phase(stt, d, gen, dev)
        torch.cuda.empty_cache()
        xres[d]["blas3"] = blas3_phase(stt, d, gen, dev)
        torch.cuda.empty_cache()
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s", flush=True)
    print("phase 12: matgen and the mixed-precision solvers", flush=True)
    t12 = time.perf_counter()
    direct = {d: {"posv": mres[d], "gesv": lres[d]} for d in DTYPES}
    mixed = {d: mixed_main_path(stt, pk, ck, lk, metrics, d, gen, dev, direct[d])
             for d in DTYPES}
    mixed["cond_matrix_4096"] = cond_phase(stt, pk, metrics, gen, dev)
    torch.cuda.empty_cache()
    mixed["generate_matrix"] = matgen_phase(stt, dev)
    print(f"  phase 12: {time.perf_counter() - t12:.1f} s", flush=True)
    print("phase 13: the serve path", flush=True)
    t13 = time.perf_counter()
    sres = {}
    for d in DTYPES:
        sres[d] = {r: serve_hit_stream(serve, faults, pk, ck, lk, metrics, r, d, gen, dev)
                   for r in ("posv", "gesv")}
        torch.cuda.empty_cache()
        sres[d]["gels"] = serve_gels_stream(serve, pk, qf, metrics, d, gen, dev)
        torch.cuda.empty_cache()
        sres[d]["full_phase"] = serve_full_stream(stt, serve, pk, ck, metrics, d, gen, dev)
        torch.cuda.empty_cache()
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    print("phase 14: band and indefinite", flush=True)
    t14 = time.perf_counter()
    metrics.on()
    bres = {}
    for d in DTYPES:
        bres[d] = {"pbsv": pbsv_phase(stt, pk, ck, metrics, d, gen, dev)}
        bres[d]["gbsv"] = gbsv_phase(stt, pk, lk, metrics, d, gen, dev)
        torch.cuda.empty_cache()
        bres[d]["tbsm"] = tbsm_phase(stt, pk, metrics, d, gen, dev)
        bres[d]["band_multiply"] = band_multiply_phase(stt, pk, d, gen, dev)
        torch.cuda.empty_cache()
        bres[d]["hesv"] = hesv_phase(stt, pk, lk, metrics, d, gen, dev)
        torch.cuda.empty_cache()
        bres[d]["aasen_2048"] = aasen_phase(stt, pk, d, dev)
    bres["hetrf_rbt_float64"] = hetrf_rbt_phase(stt, pk, metrics, gen, dev)
    torch.cuda.empty_cache()
    bres["complex128_2048"] = band_complex_phase(stt, pk, gen, dev)
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
    # phase 22's legs (a) and (b) (a checked child at n = 12) run beside
    # phases 15 and 16, which gate no latency
    gate22 = _Gate22(dev)
    print("phase 15: the Hermitian eigensolvers", flush=True)
    eres = eig_main(stt, pk, ck, metrics, gen, dev)
    print("phase 16: the SVD", flush=True)
    svres = svd_main(stt, pk, qf, metrics, gen, dev)
    torch.cuda.empty_cache()
    gate22.wait()
    print(f"  phase 22's legs (a) and (b) ran beside phases 15-16 (their child, started "
          f"{gate22.waited:.1f} s ago, is done)", flush=True)
    print("phase 17: restore, replicas and integrity", flush=True)
    rsres = restore_main(serve, faults, pk, ck, lk, metrics, gen, dev, t_build)
    torch.cuda.empty_cache()
    print("phase 18: admission, the checked runtime and the device monitor", flush=True)
    adres = admission_main(serve, faults, pk, ck, lk, metrics, gen, dev)
    torch.cuda.empty_cache()
    print("phase 19: the factor fabric", flush=True)
    fbres = fabric_main(serve, pk, qf, metrics, gen, dev)
    torch.cuda.empty_cache()
    print("phase 20: the soak fabric", flush=True)
    skres = soak_main(serve, metrics, pk, dev)
    torch.cuda.empty_cache()
    print("phase 21: the elastic capacity plane", flush=True)
    scres = scale_main(serve, metrics, pk, lk, dev)
    torch.cuda.empty_cache()
    print("phase 22: the fleet tier", flush=True)
    flres = fleet_main(serve, metrics, lk, dev, gate22)
    print(f"  phases 2-22: {time.perf_counter() - t_start:.1f} s", flush=True)

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
                                      "dense_drivers": xres, "mixed": mixed,
                                      "serve": sres, "serve_restore": rsres,
                                      "serve_admission": adres,
                                      "serve_fabric": fbres,
                                      "serve_soak": skres,
                                      "serve_scale": scres,
                                      "serve_fleet": flres,
                                      "band_indefinite": bres,
                                      "eig": eres, "svd": svres,
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
