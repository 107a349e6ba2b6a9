// Hand-written Hopper kernels for the Cholesky solve path of slate_tpu_torch
// and larft, the compact-WY assembly of the QR path.
//
// Each kernel computes what one Pallas kernel of the JAX package
// (slate_tpu/ops/pallas/panel_kernels.py) computes; none is a block-by-
// block copy of it.  All are templated over float and double and use
// plain FP32/FP64 FMA, except the float64 products of chol_base's
// trailing update, gemm_sub, syrk_diag, the trsm pair and larft, which run
// on the FP64 tensor cores (DMMA); nothing uses TF32.  All launch on the
// caller's stream, allocate nothing, and read row-major operands through
// their leading dimensions (inner stride 1), so views of a larger matrix
// need no copy.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libpanel_kernels.so panel_kernels.cu
//
// Every entry point returns cudaGetLastError() after its launches
// (slate_trsm_* also stores how many kernels it launched; it launches the
// steps of the plan it is given).

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// Shared by the products of gemm_sub / syrk_diag and of the trsm pair:
// asynchronous copies into shared memory, the FP64 tensor-core fragment,
// and the K loop's ring of stages.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int sz = ok ? (int)sizeof(T) : 0;  // 0: no read, zero fill
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(sz));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(sz));
}
// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// c (16 x 8) += a (16 x 4) b (4 x 8), one DMMA (m16n8k4, sm_90).  Lane
// (g, t) = (lane / 4, lane % 4) holds a = A[g][t], A[g + 8][t]; b = B[t][g];
// c = C[g][2t + {0, 1}], C[g + 8][2t + {0, 1}]
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The K loop: nk slices of the operands pass through a ring of NST
// shared-memory slots, NST - 1 slices in flight ahead of the one in use.
// stage(slot, s) issues the cp.async copies of slice s into `slot`;
// body(slot) computes on the slice in `slot`.  One commit group a slice
// (empty past the end, so the wait count is a constant) and one block
// barrier a slice, which both publishes the slice that has landed and
// frees the slot refilled next (the one used an iteration before).  On
// return every copy has landed and every thread is past its last body:
// the ring's memory is free.
template <int NST, typename Stage, typename Body>
__device__ __forceinline__ void cp_ring(int nk, Stage&& stage, Body&& body) {
  static_assert(NST >= 2, "a slot in use and one in flight");
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_async_commit();
  }
  int slot = 0;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (kt + NST - 1 < nk) stage(slot == 0 ? NST - 1 : slot - 1, kt + NST - 1);
    cp_async_commit();
    body(slot);
    slot = slot + 1 == NST ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// chol_base: unblocked Cholesky of one (b, b) diagonal block.
//
// Replaces slate_tpu/ops/pallas/panel_kernels.py:chol_base_pallas, which
// runs a masked rank-1 update a column over the whole block in VMEM.  On
// the H100 the block does not fit one SM's shared memory (256^2 doubles
// are 512 KB), and the work is a chain of b dependent column steps: one
// block of 256 threads walks it in strips of CB_S = 32 columns, and what
// bounds it is the chain's latency (the block's bytes take 0.3 us, its
// b^3 / 3 FLOPs 11 us at one SM's DMMA rate, at b = 256).  The kernel
// factors a copy in place.  The strip's solved panel P (every row below
// the strip, CB_S values each) stays in shared memory; the trailing lower
// triangle stays in L2, in 32 x 32 tiles.  Per strip k:
//   b. the panel below the factored diagonal block L_kk: x L_kk^T = a_r,
//      a warp's 32 rows copied into P a row at a time (coalesced), then a
//      thread a row, right-looking: column c is final once multiplied by
//      1 / L_cc, then subtracted from the later columns (a chain of 32
//      steps, each with up to 31 independent FMAs; the earlier kernel's
//      left-looking sums made a chain of 528 FMAs and 32 divides a row);
//   c. the trailing update C -= P_I P_J^T, a 32 x 32 tile of the lower
//      triangle at a time in a warp's registers: loaded from L2 once a
//      strip, updated over the strip's 32 columns, stored once.  float64
//      on DMMA (m16n8k4, fragments as in GemmAcc<double>), float32 on an
//      FFMA tile (8 x 4 values a lane, float4 reads along k).  P's rows
//      are swizzled (cb_pidx) so that both read patterns are free of bank
//      conflicts without padding, which keeps b up to 896 / 1792.
//      Lookahead: warp 0 takes the next strip's diagonal tile, updates it
//      and factors it while the other warps update every other tile, so
//      the factor stays off the critical path but for its own length.  In
//      float64 the tile warps leave warp 0's SM sub-partition (warp % 4)
//      to it; in float32, whose FFMA tiles are the heavier work, warps
//      0-3 share the diagonal tile's update and warp 4 takes tiles too;
//   a. the factor of a diagonal block: a lane a row in warp 0's registers,
//      one reciprocal square root a column; the next pivot goes first, by
//      shuffle, and the column's other multipliers through shared memory
//      (one warp barrier and a few 16-byte reads a column, fewer
//      instructions than a shuffle a multiplier); L_kk and 1 / L_cc are
//      left in shared memory for step b.
// Two block barriers a strip.  256 threads, not 512: at 128 registers a
// thread the panel's 32-value rows and the factor spilled.  A
// non-positive pivot gives NaN (rsqrt of a negative, or 0 * inf), which
// propagates, as in the JAX package, so the driver's info fires.  Every
// element is computed in a fixed order: two calls give the same bits.
// ---------------------------------------------------------------------------

constexpr int CB_S = 32;          // strip width, tile edge
constexpr int CB_LDD = CB_S + 1;  // the diagonal block's padded row (a lane a row)
constexpr int CB_THREADS = 256;
constexpr int CB_WARPS = CB_THREADS / 32;
constexpr int CB_MAX_SMEM = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr unsigned CB_FULL = 0xffffffffu;
// float32's tiles are FFMA-bound: warps 0-3 update the next diagonal
// tile together (cb_diag_rows) and warp 4, in warp 0's SM sub-partition,
// takes tiles too.  float64's tiles are light on issue (DMMA): warp 0
// updates the diagonal tile alone and its sub-partition is left to it.
template <typename T>
constexpr bool CB_FFMA = sizeof(T) == 4;

// shared memory of a (b, b) call: the panel (CB_S values for every row
// from CB_S to the last whole tile), the diagonal block, its reciprocal
// pivots and two slots of a column's multipliers
inline size_t cb_smem_bytes(int b, size_t esz) {
  const size_t tiles = (size_t)(b + CB_S - 1) / CB_S;
  return ((tiles - 1) * CB_S * CB_S + CB_S * CB_LDD + 3 * CB_S) * esz;
}

__device__ __forceinline__ float dev_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double dev_rsqrt(double x) { return rsqrt(x); }

// P's element (row r >= CB_S of the block, column k of the strip).  The
// column is XOR-swizzled by the row: float64 DMMA fragments read rows
// g = 0..3 (a half-warp) at k = 4 kk + t, float32 float4 reads rows
// tx = 0..7 (a quarter-warp); each lands on distinct banks.
template <typename T>
__device__ __forceinline__ int cb_pidx(int r, int k) {
  const int sw = sizeof(T) == 8 ? (r & 3) << 2 : (r & 7) << 2;
  return (r - CB_S) * CB_S + (k ^ sw);
}

template <typename T>
struct CbTile;

// float64: the warp's 32 x 32 tile as 2 x 4 DMMA tiles of 16 x 8; lane
// (g, t) holds rows 16 i + g (+ 8) and columns 8 j + 2 t (+ 1)
template <>
struct CbTile<double> {
  double c[2][4][4];

  template <typename F>
  __device__ __forceinline__ void each(F&& f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f(16 * i + 8 * (e >> 1) + g, 8 * j + 2 * t + (e & 1), c[i][j][e]);
  }
  // c -= P[r0 + .] P[c0 + .]^T over the strip's columns; on the diagonal
  // (r0 == c0) the two 16 x 8 tiles wholly above it are skipped
  __device__ __forceinline__ void sub(const double* P, int r0, int c0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bool diag = r0 == c0;
#pragma unroll
    for (int kk = 0; kk < CB_S; kk += 4) {
      double a[2][2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = -P[cb_pidx<double>(r0 + 16 * i + g, kk + t)];
        a[i][1] = -P[cb_pidx<double>(r0 + 16 * i + 8 + g, kk + t)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = P[cb_pidx<double>(c0 + 8 * j + g, kk + t)];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!(diag && i == 0 && j >= 2)) dmma(c[i][j], a[i][0], a[i][1], b[j]);
    }
  }
};

// float32: lane (tx, ty) = (lane % 8, lane / 8) holds rows ty + 4 i and
// columns tx + 8 j; a quarter-warp's float4 reads are one row of P_I (a
// broadcast) and 8 rows of P_J
template <>
struct CbTile<float> {
  float c[8][4];

  template <typename F>
  __device__ __forceinline__ void each(F&& f) {
    const int tx = threadIdx.x & 7, ty = (threadIdx.x >> 3) & 3;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(ty + 4 * i, tx + 8 * j, c[i][j]);
  }
  // on the diagonal the values whose rows all lie above their columns
  // (4 i + 3 < 8 j) are skipped
  __device__ __forceinline__ void sub(const float* P, int r0, int c0) {
    const int tx = threadIdx.x & 7, ty = (threadIdx.x >> 3) & 3;
    const bool diag = r0 == c0;
#pragma unroll
    for (int k4 = 0; k4 < CB_S; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(P + cb_pidx<float>(r0 + ty + 4 * i, k4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(P + cb_pidx<float>(c0 + tx + 8 * j, k4));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (diag && 4 * i + 3 < 8 * j) continue;
          c[i][j] = fmaf(-a[i].x, b.x, c[i][j]);
          c[i][j] = fmaf(-a[i].y, b.y, c[i][j]);
          c[i][j] = fmaf(-a[i].z, b.z, c[i][j]);
          c[i][j] = fmaf(-a[i].w, b.w, c[i][j]);
        }
      }
    }
  }
};

// 16 bytes of shared memory into v
template <typename T>
__device__ __forceinline__ void cb_ld16(const T* p, T (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 8) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
}

// a. warp 0 factors the w x w block held a row a lane (d[c] = A[lane][c]
// for c <= lane < w, else 0), right-looking, one reciprocal square root a
// column.  The chain runs through the next pivot: the lane of row c + 1
// finishes it with its own multiplier and sends it by shuffle first; the
// column's other multipliers go through Xc (two slots taken in turn, one
// warp barrier a column) and are read 16 bytes at a time, off the chain.
// Leaves L in Dg (a row a lane), 1 / L_cc in Rd, and L's lower triangle
// in a at (j0, j0).
template <typename T>
__device__ __forceinline__ void cb_factor(T (&d)[CB_S], int w, T* a, long long lda, int j0,
                                          T* Dg, T* Rd, T* Xc) {
  constexpr int VN = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  T p2 = __shfl_sync(CB_FULL, d[0], 0), rd = T(0);
#pragma unroll
  for (int c = 0; c < CB_S; ++c) {
    if (c < w) {
      const T r = dev_rsqrt(p2), l = d[c] * r;
      const T next = c + 1 < CB_S ? __shfl_sync(CB_FULL, fma(-l, l, d[(c + 1) % CB_S]), c + 1)
                                  : T(0);
      T* X = Xc + (c & 1) * CB_S;
      X[lane] = l;
      if (lane == c) {
        d[c] = p2 * r;
        rd = r;
      } else if (lane > c) {
        d[c] = l;
      }
      __syncwarp();
#pragma unroll
      for (int q = (c + 1) / VN; q < CB_S / VN; ++q) {
        T v[VN];
        cb_ld16(X + q * VN, v);
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          const int c2 = q * VN + e;
          if (c2 > c && lane >= c2) d[c2] = fma(-l, v[e], d[c2]);
        }
      }
      p2 = next;
    }
  }
#pragma unroll
  for (int c = 0; c < CB_S; ++c) Dg[lane * CB_LDD + c] = d[c];
  Rd[lane] = rd;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < CB_S; ++i)  // a row at a time, coalesced
    if (i < w && lane <= i) a[(long long)(j0 + i) * lda + j0 + lane] = Dg[i * CB_LDD + lane];
}

// b. rows [j0 + CB_S, b) of the strip's columns: x L_kk^T = a_r.  A warp
// takes 32 rows: it copies them into P (a row an instruction, coalesced),
// then a thread a row solves them, right-looking: column c is final once
// multiplied by 1 / L_cc, then subtracted from the later columns (a chain
// of 32 steps, each with up to 31 independent FMAs, where the earlier
// kernel's left-looking sums made a chain of 528 FMAs and 32 divides);
// then the warp copies the rows back out.
template <typename T>
__device__ __forceinline__ void cb_panel(T* a, long long lda, int b, int j0, T* P, const T* Dg,
                                         const T* Rd) {
  const int lane = threadIdx.x & 31;
  for (int r0 = j0 + CB_S + (int)(threadIdx.x >> 5) * 32; r0 < b; r0 += CB_THREADS) {
    const int rows = min(32, b - r0);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // all 32 loads in flight at once
      if (i < rows) P[cb_pidx<T>(r0 + i, lane)] = a[(long long)(r0 + i) * lda + j0 + lane];
    __syncwarp();
    const int r = r0 + lane;  // rows past b read P's zeros and are not written
    T x[CB_S];
#pragma unroll
    for (int c = 0; c < CB_S; ++c) x[c] = P[cb_pidx<T>(r, c)];
#pragma unroll
    for (int c = 0; c < CB_S; ++c) {
      x[c] *= Rd[c];
#pragma unroll
      for (int c2 = c + 1; c2 < CB_S; ++c2) x[c2] = fma(-x[c], Dg[c2 * CB_LDD + c], x[c2]);
    }
    if (r < b) {
#pragma unroll
      for (int c = 0; c < CB_S; ++c) P[cb_pidx<T>(r, c)] = x[c];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < rows) a[(long long)(r0 + i) * lda + j0 + lane] = P[cb_pidx<T>(r0 + i, lane)];
  }
}

// c. tile (r0, c0) of the trailing lower triangle, from L2 into registers
// and the strip's update subtracted; the values outside the block (past
// b) and, on the diagonal, above it read as zero
template <typename T>
__device__ __forceinline__ void cb_tile_update(CbTile<T>& t, const T* a, long long lda, int b,
                                               int r0, int c0, const T* P) {
  t.each([&](int i, int j, T& v) {
    const int r = r0 + i, c = c0 + j;
    v = r < b && c < b && (r0 != c0 || c <= r) ? a[(long long)r * lda + c] : T(0);
  });
  t.sub(P, r0, c0);
}

// float32's lookahead: warp `part` (0-3) takes rows 8 part .. 8 part + 7 of
// the next diagonal tile (j1, j1) and leaves them, updated, in Dg (lane
// (tx, ty) holds rows ty + 4 i and columns tx + 8 j; on and below the
// diagonal, zero above it).  The FFMA tile would keep warp 0 alone on the
// chain for a whole 32 x 32 x 32 product; four warps take a quarter each.
template <typename T>
__device__ __forceinline__ void cb_diag_rows(const T* a, long long lda, int b, int j1,
                                             const T* P, T* Dg, int part) {
  constexpr int VN = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, tx = lane & 7, ty = lane >> 3;
  T c[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * part + ty + 4 * i, cc = tx + 8 * j;
      c[i][j] = j1 + r < b && j1 + cc < b && cc <= r ? a[(long long)(j1 + r) * lda + j1 + cc] : T(0);
    }
#pragma unroll
  for (int k = 0; k < CB_S; k += VN) {
    T x[2][VN], y[4][VN];
#pragma unroll
    for (int i = 0; i < 2; ++i) cb_ld16(P + cb_pidx<T>(j1 + 8 * part + ty + 4 * i, k), x[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) cb_ld16(P + cb_pidx<T>(j1 + tx + 8 * j, k), y[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < VN; ++e) c[i][j] = fma(-x[i][e], y[j][e], c[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * part + ty + 4 * i, cc = tx + 8 * j;
      Dg[r * CB_LDD + cc] = cc <= r ? c[i][j] : T(0);
    }
}

template <typename T>
__global__ void __launch_bounds__(CB_THREADS, 1)
chol_base_kernel(T* a, int b, long long lda) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbk = (b + CB_S - 1) / CB_S;  // tiles along an edge
  T* P = reinterpret_cast<T*>(smem_raw);  // [(nbk - 1) CB_S][CB_S], cb_pidx
  T* Dg = P + (nbk - 1) * CB_S * CB_S;    // [CB_S][CB_LDD] the strip's L_kk
  T* Rd = Dg + CB_S * CB_LDD;             // [CB_S] 1 / L_kk[c][c]
  T* Xc = Rd + CB_S;                      // [2][CB_S] a column's multipliers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < (nbk - 1) * CB_S * CB_S; i += CB_THREADS) P[i] = T(0);  // rows past b
  if (warp == 0) {
    const int w = min(CB_S, b);
    T d[CB_S];
#pragma unroll
    for (int c = 0; c < CB_S; ++c) d[c] = lane < w && c <= lane ? a[(long long)lane * lda + c] : T(0);
    cb_factor(d, w, a, lda, 0, Dg, Rd, Xc);
  }
  __syncthreads();

  for (int k = 0; k + 1 < nbk; ++k) {
    const int j1 = (k + 1) * CB_S;
    cb_panel(a, lda, b, k * CB_S, P, Dg, Rd);
    __syncthreads();  // P complete; Dg and Rd free
    if (CB_FFMA<T> && warp < 4) {  // the next diagonal tile, a quarter a warp
      cb_diag_rows(a, lda, b, j1, P, Dg, warp);
      if (warp == 0)
        asm volatile("bar.sync 1, 128;" ::: "memory");  // warps 1-3 arrive, and go on
      else
        asm volatile("bar.arrive 1, 128;" ::: "memory");
    }
    if (warp == 0) {  // lookahead: the next diagonal block
      if (!CB_FFMA<T>) {
        CbTile<T> t;
        cb_tile_update(t, a, lda, b, j1, j1, P);
        t.each([&](int i, int j, T& v) { Dg[i * CB_LDD + j] = v; });
        __syncwarp();
      }
      const int w = min(CB_S, b - j1);
      T d[CB_S];
#pragma unroll
      for (int c = 0; c < CB_S; ++c) d[c] = lane < w && c <= lane ? Dg[lane * CB_LDD + c] : T(0);
      __syncwarp();
      cb_factor(d, w, a, lda, j1, Dg, Rd, Xc);
    } else if (CB_FFMA<T> || warp % 4 != 0) {
      // every other tile (I, J), 0 <= J <= I < nt, row by row, (0, 0) being
      // warp 0's; float64 over the warps outside warp 0's SM sub-partition
      // (warp % 4), where the factor's chain issues alone
      const int nt = nbk - 1 - k, me = CB_FFMA<T> ? warp - 1 : warp - 1 - warp / 4;
      const int step = CB_FFMA<T> ? CB_WARPS - 1 : CB_WARPS - CB_WARPS / 4;
      for (int q = 1 + me; q < nt * (nt + 1) / 2; q += step) {
        int I = 0;
        while ((I + 1) * (I + 2) / 2 <= q) ++I;
        const int r0 = j1 + I * CB_S, c0 = j1 + (q - I * (I + 1) / 2) * CB_S;
        CbTile<T> t;
        cb_tile_update(t, a, lda, b, r0, c0, P);
        t.each([&](int i, int j, T& v) {
          const int r = r0 + i, c = c0 + j;
          if (r < b && c < b && (r0 != c0 || c <= r)) a[(long long)r * lda + c] = v;
        });
      }
    }
    __syncthreads();  // the tiles stored, the next L_kk in Dg; P free
  }
}

// ---------------------------------------------------------------------------
// C - A B^T (gemm_sub) and its lower-triangle twin (syrk_diag, B = A).
//
// A (M x K) and B (N x K) are both read along K, their rows: that is the
// row-major A fragment and the column-major B fragment of mma.sync, so no
// transposed copy is made anywhere.  A block owns a BM x BM output tile;
// slices of GemmLayout::BK columns of its A rows and B rows go through
// the cp_ring (16-byte copies where rows are 16-byte aligned, one copy a
// value otherwise; zero fill past M, N and K, so any row stride and the
// ragged edges need no padding), staged m-major / n-major with k
// contiguous on a padded row of BK + 4 values (4 mod 16 in doubles, 4 mod
// 32 in floats: the fragment reads below are free of bank conflicts).
//   float64: DMMA (mma.sync m16n8k4), 8 warps of (BM/2) x (BM/4); the
//     FP64 tensor cores are the only way to the card's 67 TFLOP/s in f64.
//   float32: FFMA (no TF32), a thread owns TM x TM = (BM/16)^2 outputs at
//     rows ty + 16 i, columns tx + 16 j, and reads them as float4 along
//     k: 2 TM LDS.128 a 4 TM^2 FFMA (16 a 256 at BM = 128).
// Bound: operations, 2 M N K FLOPs at 67 TFLOP/s (FP64 tensor and FP32
// SIMT peak alike).  Two tile variants of one template: BM = 128 and 64
// (G_TILES); the host (gemm_sub_plan in ops/hopper/panel_kernels.py)
// picks the variant and splits K across blocks (grid.z) from what
// slate_gemm_layout_* reports, so no policy lives here.  The epilogue
// writes out = C - acc from the registers.  LOWER skips the tiles wholly
// above the diagonal and writes only r >= c (the caller passes out == C,
// so the upper triangle passes through untouched).  Split K: z-slice z
// takes columns [z kchunk, (z + 1) kchunk) (the last one the rest to K),
// writes its partial product to the work buffer, and subk_reduce
// finishes out = C - sum in a fixed order (no atomics: results do not
// change from run to run).
// ---------------------------------------------------------------------------

constexpr int G_THREADS = 256;
constexpr int G_TILES[2] = {128, 64};  // the tile variants, largest first

template <typename T, int BM>
struct GemmLayout {
  static constexpr bool F64 = sizeof(T) == 8;
  // K slices of 32 in 3 slots: half the barriers of 16-deep slices, and
  // the f64 128 tile's ring still fits one block an SM
  static constexpr int BK = 32;
  static constexpr int LD = BK + 4;  // a staged row, k contiguous
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int NST = 3;
  static constexpr int OPER = BM * LD;    // one operand's slice
  static constexpr int STAGE = 2 * OPER;  // A's, then B's
  static constexpr size_t bytes = sizeof(T) * NST * STAGE;  // 216 / 108 KB at BM = 128
  static constexpr int MIN_BLOCKS = F64 && BM == 128 ? 1 : 2;  // for __launch_bounds__
};

// stage BK columns from k0 of `rows` rows of X from row r0 into dst
// (dst[r * LD + k]); rows past `rows` and columns past kend read as zero
template <typename T, int BM>
__device__ __forceinline__ void g_stage(T* dst, const T* X, long long ldx, int r0, int rows,
                                        int k0, int kend, bool vec) {
  using L = GemmLayout<T, BM>;
  constexpr int V = L::VEC, PER = L::BK / V;  // 16-byte copies along a row
  if (vec) {
#pragma unroll
    for (int i = 0; i < BM * PER / G_THREADS; ++i) {
      const int idx = threadIdx.x + i * G_THREADS;  // neighbours on neighbouring addresses
      const int r = idx / PER, k = (idx % PER) * V;
      const int valid = r < rows ? min(V, max(0, kend - k0 - k)) : 0;
      cp_async16(dst + r * L::LD + k, valid ? X + (long long)(r0 + r) * ldx + k0 + k : X,
                 valid * (int)sizeof(T));
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BM * L::BK / G_THREADS; ++i) {
      const int idx = threadIdx.x + i * G_THREADS;
      const int r = idx / L::BK, k = idx % L::BK;
      const bool ok = r < rows && k0 + k < kend;
      cp_async(dst + r * L::LD + k, ok ? X + (long long)(r0 + r) * ldx + k0 + k : X, ok);
    }
  }
}

template <typename T, int BM>
struct GemmAcc;

// float64: warp w owns rows (w % 2) BM/2 and columns (w / 2) BM/4 of the
// tile, MI x NJ DMMA tiles of 16 x 8
template <int BM>
struct GemmAcc<double, BM> {
  using L = GemmLayout<double, BM>;
  static constexpr int MI = BM / 32, NJ = BM / 32;
  double c[MI][NJ][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0;
  }
  __device__ __forceinline__ void step(const double* As, const double* Bs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const double* Aw = As + ((warp & 1) * (BM / 2) + g) * L::LD + t;
    const double* Bw = Bs + ((warp >> 1) * (BM / 4) + g) * L::LD + t;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 4) {
      double a[MI][2], b[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) {  // rows g, g + 8 of the 16-row tiles
        a[i][0] = Aw[(i * 16) * L::LD + kk];
        a[i][1] = Aw[(i * 16 + 8) * L::LD + kk];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = Bw[(j * 8) * L::LD + kk];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dmma(c[i][j], a[i][0], a[i][1], b[j]);
    }
  }
  // f(row, column, value) for every output of the thread, tile-relative
  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rw = (warp & 1) * (BM / 2), cw = (warp >> 1) * (BM / 4);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(rw + i * 16 + (e >> 1) * 8 + g, cw + j * 8 + 2 * t + (e & 1), c[i][j][e]);
  }
};

// float32: thread (tx, ty) owns rows ty + 16 i and columns tx + 16 j
// (i, j < TM); a warp is 4 values of ty by 8 of tx (warps 2 along tx, 4
// along ty), so a quarter-warp's float4 reads are one row of A (a
// broadcast) and 8 consecutive rows of B (conflict-free at LD = 4 mod 32)
__device__ __forceinline__ int g_tx() { return (threadIdx.x >> 5 & 1) * 8 + (threadIdx.x & 7); }
__device__ __forceinline__ int g_ty() { return (threadIdx.x >> 6) * 4 + (threadIdx.x >> 3 & 3); }

template <int BM>
struct GemmAcc<float, BM> {
  using L = GemmLayout<float, BM>;
  static constexpr int TM = BM / 16;
  float c[TM][TM];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    const float* Ar = As + g_ty() * L::LD;
    const float* Br = Bs + g_tx() * L::LD;
#pragma unroll
    for (int k4 = 0; k4 < L::BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(Ar + i * 16 * L::LD + k4);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(Br + j * 16 * L::LD + k4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          c[i][j] = fmaf(a[i].x, b.x, c[i][j]);
          c[i][j] = fmaf(a[i].y, b.y, c[i][j]);
          c[i][j] = fmaf(a[i].z, b.z, c[i][j]);
          c[i][j] = fmaf(a[i].w, b.w, c[i][j]);
        }
      }
    }
  }
  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
    const int tx = g_tx(), ty = g_ty();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) f(ty + 16 * i, tx + 16 * j, c[i][j]);
  }
};

template <typename T, bool LOWER, int BM>
__global__ void __launch_bounds__(G_THREADS, GemmLayout<T, BM>::MIN_BLOCKS)
sub_abt_kernel(const T* C, long long ldc,  // may alias out (LOWER)
               const T* __restrict__ A, long long lda,
               const T* __restrict__ B, long long ldb,
               T* out, long long ldo, T* __restrict__ work,
               int M, int N, int K, int kchunk, int vec_a, int vec_b) {
  using L = GemmLayout<T, BM>;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BM;
  if (LOWER && n0 > m0 + BM - 1) return;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = blockIdx.z + 1 == gridDim.z ? K : min(K, kbeg + kchunk);
  const int rows_a = min(BM, M - m0), rows_b = min(BM, N - n0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  GemmAcc<T, BM> acc;
  acc.zero();
  cp_ring<L::NST>(
      max(0, (kend - kbeg + L::BK - 1) / L::BK),
      [&](int slot, int s) {
        T* As = sm + slot * L::STAGE;
        const int k0 = kbeg + s * L::BK;
        g_stage<T, BM>(As, A, lda, m0, rows_a, k0, kend, vec_a);
        g_stage<T, BM>(As + L::OPER, B, ldb, n0, rows_b, k0, kend, vec_b);
      },
      [&](int slot) { acc.step(sm + slot * L::STAGE, sm + slot * L::STAGE + L::OPER); });

  acc.each([&](int i, int j, T v) {
    const int r = m0 + i, c = n0 + j;
    if (r >= M || c >= N) return;
    if (work != nullptr) {
      work[((long long)blockIdx.z * M + r) * N + c] = v;
    } else if (!LOWER || r >= c) {
      out[(long long)r * ldo + c] = C[(long long)r * ldc + c] - v;
    }
  });
}

template <typename T, bool LOWER>
__global__ void subk_reduce(const T* C, long long ldc, const T* __restrict__ work,
                            int ksplit, T* out, long long ldo, int M, int N) {
  const long long total = (long long)M * N;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int r = idx / N, c = idx % N;
    if (LOWER && c > r) continue;
    T s = T(0);
    for (int z = 0; z < ksplit; ++z) s += work[z * total + idx];
    out[(long long)r * ldo + c] = C[(long long)r * ldc + c] - s;
  }
}

template <typename T, bool LOWER, int BM>
int launch_sub_abt(const T* C, long long ldc, const T* A, long long lda,
                   const T* B, long long ldb, T* out, long long ldo, T* work,
                   int M, int N, int K, int ksplit, int kchunk, cudaStream_t s) {
  using L = GemmLayout<T, BM>;
  cudaError_t e = cudaFuncSetAttribute(sub_abt_kernel<T, LOWER, BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  // rows of A / B start 16-byte aligned: the staging copies 16 bytes at once
  const int vec_a = reinterpret_cast<unsigned long long>(A) % 16 == 0 && lda % L::VEC == 0;
  const int vec_b = reinterpret_cast<unsigned long long>(B) % 16 == 0 && ldb % L::VEC == 0;
  const dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM, ksplit);
  sub_abt_kernel<T, LOWER, BM><<<grid, G_THREADS, L::bytes, s>>>(
      C, ldc, A, lda, B, ldb, out, ldo, ksplit > 1 ? work : nullptr, M, N, K, kchunk, vec_a,
      vec_b);
  e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return (int)e;
  const long long total = (long long)M * N;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 4096);
  subk_reduce<T, LOWER><<<blocks, 256, 0, s>>>(C, ldc, work, ksplit, out, ldo, M, N);
  return (int)cudaGetLastError();
}

template <typename T, bool LOWER>
int launch_sub_abt_variant(int variant, const T* C, long long ldc, const T* A, long long lda,
                           const T* B, long long ldb, T* out, long long ldo, T* work, int M,
                           int N, int K, int ksplit, int kchunk, cudaStream_t s) {
  if (variant == 0)
    return launch_sub_abt<T, LOWER, G_TILES[0]>(C, ldc, A, lda, B, ldb, out, ldo, work, M, N, K,
                                                ksplit, kchunk, s);
  if (variant == 1)
    return launch_sub_abt<T, LOWER, G_TILES[1]>(C, ldc, A, lda, B, ldb, out, ldo, work, M, N, K,
                                                ksplit, kchunk, s);
  return (int)cudaErrorInvalidValue;
}

// the variant's output tile edge and K slice, and how many of its blocks
// fit on one SM (registers and shared memory as built)
template <typename T, int BM>
int gemm_layout(int* bm, int* bk, int* per_sm) {
  using L = GemmLayout<T, BM>;
  *bm = BM;
  *bk = L::BK;
  cudaError_t e = cudaFuncSetAttribute(sub_abt_kernel<T, false, BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, sub_abt_kernel<T, false, BM>,
                                                            G_THREADS, L::bytes);
}

// ---------------------------------------------------------------------------
// larft: the compact-WY assembly stage of the QR base panel,
//
//   Tinv = strict_upper(V^T V) + diag(d),  d_j = 1 / tau_j (tau_j != 0),
//                                          d_j = 1e30      (tau_j == 0)
//
// what slate_tpu/ops/pallas/panel_kernels.py:_larft_tinv_body (the body of
// larft_pallas) computes, with the lower triangle exactly zero and each d_j
// a correctly rounded IEEE division (the diagonal is bit-identical to the
// plain PyTorch version).  The <= nb triangular solve of Tinv and the
// tau == 0 masking stay outside, on the library solve, as in the JAX
// package.
//
// V is (M, w), w <= 1024, M up to 32768 on the main path; the output is
// (w, w).  Bound: operations, M w (w - 1) FLOPs of the strict upper Gram
// against M w values read (2.1 GFLOP on 64 MiB at (32768, 256) in double).
// In V^T V the reduction index runs along V's rows, its strided dimension,
// so the operands are staged k-major, as V lies, with no transposed copy:
// a slice of BK rows of the tile's row block [i0, i0 + BM) and column block
// [j0, j0 + BM) (one block only for a diagonal tile) goes through the
// cp_ring (16-byte copies along the row where V and its row stride are
// 16-byte aligned, one copy a value otherwise; zero fill past M and w) onto
// rows padded to BM + 4 values.
//   float64: DMMA (mma.sync m16n8k4), the warps of GemmAcc<double, BM>:
//     both fragments read slot[t][g + ...], and the padding (4 mod 16
//     doubles) puts the lanes 4g + t of a half-warp on distinct banks.
//   float32: FFMA (no TF32), thread (tx, ty) owns rows ty*4 + 64h + q and
//     columns tx*4 + 64h + q (h < BM / 64, q < 4), read as float4 along
//     the slot's rows: 2 BM / 32 LDS.128 a (BM / 16)^2 FFMA.  The tile is
//     bound by its FFMAs, so a diagonal 128 tile skips its quadrant below
//     the diagonal (rows 64.., columns ..63): 3/4 of the work.
// Only the tiles on or above the diagonal are computed.  An output of
// w = 256 has 3 such tiles of 128, far too few for 132 SMs, so the rows
// are split: block (tile, chunk) sums its chunk, a whole number of BK
// slices (chunk c of n takes slices [c S / n, (c + 1) S / n) of the S of
// V), into a partial tile in the work buffer.  The diagonal tiles take
// cd chunks each and the others co, so that a block's work is about the
// same in both (cd / co = the diagonal tile's share of the work, which
// slate_larft_layout_* reports); the host (larft_plan in
// ops/hopper/panel_kernels.py) sizes them so that the blocks fill one
// wave of the card.  A second kernel sums each element's partials in
// chunk order (no atomics: the result does not change from run to run),
// and writes the diagonal and the zeros below it.
// ---------------------------------------------------------------------------

template <typename T, int BM>
struct LarftLayout {
  static constexpr int BK = 32;      // rows of V a slice holds
  static constexpr int LD = BM + 4;  // a staged row of the slice, k-major
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int NST = 3;
  static constexpr int OPER = BK * LD;     // one column block's slice
  static constexpr int STAGE = 2 * OPER;   // row block's, then column block's
  static constexpr size_t bytes = sizeof(T) * NST * STAGE;  // 198 / 99 KB at BM = 128
  static constexpr int MIN_BLOCKS = sizeof(T) == 8 && BM == 128 ? 1 : 2;
};

// Block b of the grid -> its tile (ti, tj) and chunk, of n chunks: the nt
// diagonal tiles' cd chunks each first (tile by tile), then the strictly
// upper tiles' co each, row-major over the tiles
__device__ __forceinline__ void larft_block(int b, int nt, int cd, int co, int& ti, int& tj,
                                            int& chunk, int& n) {
  if (b < nt * cd) {
    ti = tj = b / cd;
    chunk = b % cd;
    n = cd;
    return;
  }
  b -= nt * cd;
  int t = b / co;
  chunk = b % co;
  n = co;
  ti = 0;
  while (t >= nt - 1 - ti) {
    t -= nt - 1 - ti;
    ++ti;
  }
  tj = ti + 1 + t;
}

// the first partial tile of tile (ti, tj) in the work buffer (its chunks
// follow one another), in tiles of BM x BM
__device__ __forceinline__ long long larft_part(int ti, int tj, int nt, int cd, int co) {
  if (ti == tj) return (long long)ti * cd;
  const int before = ti * (nt - 1) - ti * (ti - 1) / 2;  // strictly upper tiles in rows < ti
  return (long long)nt * cd + (long long)(before + tj - ti - 1) * co;
}

// stage rows [r0, r0 + BK) of columns [c0, c0 + BM) of V into dst
// (dst[k * LD + c]); rows past M and columns past w read as zero
template <typename T, int BM>
__device__ __forceinline__ void larft_stage(T* dst, const T* V, long long ldv, int r0, int M,
                                            int c0, int w, bool vec) {
  using L = LarftLayout<T, BM>;
  if (vec) {
    constexpr int PER = BM / L::VEC;  // 16-byte copies along a row
#pragma unroll
    for (int i = 0; i < L::BK * PER / G_THREADS; ++i) {
      const int idx = threadIdx.x + i * G_THREADS;  // neighbours on neighbouring addresses
      const int k = idx / PER, c = (idx % PER) * L::VEC;
      const int valid = r0 + k < M ? min(L::VEC, max(0, w - c0 - c)) : 0;
      cp_async16(dst + k * L::LD + c, valid ? V + (long long)(r0 + k) * ldv + c0 + c : V,
                 valid * (int)sizeof(T));
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < L::BK * BM / G_THREADS; ++i) {
      const int idx = threadIdx.x + i * G_THREADS;
      const int k = idx / BM, c = idx % BM;
      const bool ok = r0 + k < M && c0 + c < w;
      cp_async(dst + k * L::LD + c, ok ? V + (long long)(r0 + k) * ldv + c0 + c : V, ok);
    }
  }
}

template <typename T, int BM>
struct GramAcc;

// float64: GemmAcc's warps and outputs; the fragments read from k-major
// slots: a = A[g][t] = Vi[t][g], b = B[t][g] = Vj[t][g].  A diagonal tile
// does all the work (its warps' tiles do not follow the diagonal).
template <int BM>
struct GramAcc<double, BM> : GemmAcc<double, BM> {
  using L = LarftLayout<double, BM>;
  static constexpr int MI = BM / 32, NJ = BM / 32;
  static constexpr int DIAG_QUARTERS = 4;  // a diagonal tile's work, in quarters of a tile's

  template <bool DIAG>
  __device__ __forceinline__ void step(const double* Is, const double* Js) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const double* Iw = Is + t * L::LD + (warp & 1) * (BM / 2) + g;
    const double* Jw = Js + t * L::LD + (warp >> 1) * (BM / 4) + g;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 4) {
      double a[MI][2], b[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) {  // rows g, g + 8 of the 16-row tiles
        a[i][0] = Iw[kk * L::LD + i * 16];
        a[i][1] = Iw[kk * L::LD + i * 16 + 8];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = Jw[kk * L::LD + j * 8];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dmma(this->c[i][j], a[i][0], a[i][1], b[j]);
    }
  }
  // the partial tile, out[r * BM + c], in double2 along the rows (the
  // outputs of each() in pairs)
  __device__ __forceinline__ void store(double* out) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rw = (warp & 1) * (BM / 2), cw = (warp >> 1) * (BM / 4);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<double2*>(out + (rw + i * 16 + h * 8 + g) * BM + cw + j * 8 + 2 * t) =
              make_double2(this->c[i][j][2 * h], this->c[i][j][2 * h + 1]);
  }
};

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// float32: thread (tx, ty) of g_tx / g_ty (a quarter-warp is one ty and 8
// neighbouring tx: its float4 reads are a broadcast and 128 contiguous
// bytes) owns rows ty*4 + 64h + q and columns tx*4 + 64h' + q'.  In a
// diagonal 128 tile the outputs with h > h' lie below the diagonal, the
// same quadrant for every thread, and are skipped.
template <int BM>
struct GramAcc<float, BM> {
  using L = LarftLayout<float, BM>;
  static constexpr int H = BM / 64, TM = 4 * H;
  static constexpr int DIAG_QUARTERS = H == 2 ? 3 : 4;
  float c[TM][TM];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) c[i][j] = 0.f;
  }
  template <bool DIAG>
  __device__ __forceinline__ void step(const float* Is, const float* Js) {
    const float* Ir = Is + g_ty() * 4;
    const float* Jr = Js + g_tx() * 4;
#pragma unroll 4  // not all 32: fewer values live under the 128-register cap (faster)
    for (int k = 0; k < L::BK; ++k) {
      float4 a[H], b[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        a[h] = *reinterpret_cast<const float4*>(Ir + k * L::LD + 64 * h);
        b[h] = *reinterpret_cast<const float4*>(Jr + k * L::LD + 64 * h);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          if (!DIAG || i / 4 <= j / 4)
            c[i][j] = fmaf(lane_of(a[i / 4], i % 4), lane_of(b[j / 4], j % 4), c[i][j]);
    }
  }
  // the partial tile, out[r * BM + c], in float4 along the rows
  __device__ __forceinline__ void store(float* out) const {
    const int tx = g_tx(), ty = g_ty();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h)
        *reinterpret_cast<float4*>(out + (ty * 4 + 64 * (i / 4) + i % 4) * BM + tx * 4 + 64 * h) =
            make_float4(c[i][4 * h], c[i][4 * h + 1], c[i][4 * h + 2], c[i][4 * h + 3]);
  }
};

// block (tile, chunk): the chunk's rows of the tile's Gram into its partial
template <typename T, int BM>
__global__ void __launch_bounds__(G_THREADS, LarftLayout<T, BM>::MIN_BLOCKS)
larft_gram_kernel(const T* __restrict__ V, long long ldv, T* __restrict__ work, int M, int w,
                  int cd, int co, int vec) {
  using L = LarftLayout<T, BM>;
  using Acc = GramAcc<T, BM>;
  constexpr bool SKIP = Acc::DIAG_QUARTERS < 4;  // a diagonal tile skips a quadrant
  const int nt = (w + BM - 1) / BM;
  int ti, tj, chunk, n;
  larft_block(blockIdx.x, nt, cd, co, ti, tj, chunk, n);
  const int i0 = ti * BM, j0 = tj * BM;
  const bool diag = ti == tj;  // one column block: the row block's
  const long long nsl = (M + L::BK - 1) / L::BK;
  const int s0 = (int)(chunk * nsl / n), s1 = (int)((chunk + 1) * nsl / n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  Acc acc;
  acc.zero();
  cp_ring<L::NST>(
      s1 - s0,
      [&](int slot, int s) {
        T* Is = sm + slot * L::STAGE;
        const int r0 = (s0 + s) * L::BK;
        larft_stage<T, BM>(Is, V, ldv, r0, M, i0, w, vec);
        if (!diag) larft_stage<T, BM>(Is + L::OPER, V, ldv, r0, M, j0, w, vec);
      },
      [&](int slot) {
        const T* Is = sm + slot * L::STAGE;
        if (SKIP && diag)
          acc.template step<SKIP>(Is, Is);
        else
          acc.template step<false>(Is, diag ? Is : Is + L::OPER);
      });

  acc.store(work + (larft_part(ti, tj, nt, cd, co) + chunk) * (BM * BM));
}

__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// out = the strict upper sum of the partials, chunk by chunk in order,
// the diagonal by IEEE division, zeros below
template <typename T, int BM>
__global__ void __launch_bounds__(256)
larft_finish_kernel(const T* __restrict__ work, const T* __restrict__ taus, T* __restrict__ out,
                    int w, int cd, int co) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)w * w) return;
  const int i = (int)(idx / w), j = (int)(idx % w);
  T v = T(0);
  if (j > i) {
    const int nt = (w + BM - 1) / BM, ti = i / BM, tj = j / BM;
    const int n = ti == tj ? cd : co;
    const T* p = work + larft_part(ti, tj, nt, cd, co) * (BM * BM) + (i % BM) * BM + (j % BM);
    for (int c = 0; c < n; ++c) v += p[(long long)c * (BM * BM)];  // chunk order
  } else if (j == i) {
    const T tau = taus[i];
    v = tau != T(0) ? div_rn(T(1), tau) : T(1e30);
  }
  out[idx] = v;
}

template <typename T, int BM>
int launch_larft(const T* V, long long ldv, const T* taus, T* out, T* work, int M, int w, int cd,
                 int co, cudaStream_t s) {
  using L = LarftLayout<T, BM>;
  cudaError_t e = cudaFuncSetAttribute(larft_gram_kernel<T, BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  // rows of V start 16-byte aligned (the tiles' first columns are
  // multiples of BM): the staging copies 16 bytes at once
  const int vec = reinterpret_cast<unsigned long long>(V) % 16 == 0 && ldv % L::VEC == 0;
  const int nt = (w + BM - 1) / BM;
  const int blocks = nt * cd + nt * (nt - 1) / 2 * co;
  larft_gram_kernel<T, BM><<<blocks, G_THREADS, L::bytes, s>>>(V, ldv, work, M, w, cd, co, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)w * w;
  larft_finish_kernel<T, BM><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(work, taus, out, w,
                                                                            cd, co);
  return (int)cudaGetLastError();
}

constexpr int LARFT_TILES[2] = {128, 64};  // the tile variants, largest first

template <typename T>
int launch_larft_variant(int variant, const T* V, long long ldv, const T* taus, T* out, T* work,
                         int M, int w, int cd, int co, cudaStream_t s) {
  if (w < 1 || w > 1024 || cd < 1 || co < 1) return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return launch_larft<T, LARFT_TILES[0]>(V, ldv, taus, out, work, M, w, cd, co, s);
  if (variant == 1)
    return launch_larft<T, LARFT_TILES[1]>(V, ldv, taus, out, work, M, w, cd, co, s);
  return (int)cudaErrorInvalidValue;
}

// the variant's output tile edge and slice depth, how many of its blocks
// fit on one SM (registers and shared memory as built), and a diagonal
// tile's work in quarters of a tile's
template <typename T, int BM>
int larft_layout(int* bm, int* bk, int* per_sm, int* diag_quarters) {
  using L = LarftLayout<T, BM>;
  *bm = BM;
  *bk = L::BK;
  *diag_quarters = GramAcc<T, BM>::DIAG_QUARTERS;
  cudaError_t e = cudaFuncSetAttribute(larft_gram_kernel<T, BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, larft_gram_kernel<T, BM>,
                                                            G_THREADS, L::bytes);
}

// ---------------------------------------------------------------------------
// trsm: op(T) X = B, op(T) lower or upper triangular, op = identity or
// transpose (TRANS reads T[c][r] for op(T)[r][c], so the backward sweep of
// a Cholesky solve reads L as L^T without a copy).
//
// Right-looking blocked substitution, stepped from the host.  op(T) is cut
// into row blocks of TR_KB = 128 rows; the forward sweep (lower) walks them
// top-down, the backward sweep (upper) bottom-up, one launch a block.  The
// host passes the schedule, one TrStep a launch (the table of
// trsm_step_plan in ops/hopper/panel_kernels.py; this file decides no
// step of it):
//   grid = (column tiles of BN, 1 + far_count); block (x, y) owns an
//   output tile of TR_KB rows x BN columns of the right-hand side.
//   Row y = 0 is the owner: the row block solved by this launch, which
//   takes the block solved by the launch before.  Row y > 0 is the far
//   row block at far_r0 + (y - 1) far_step, which takes the TRSM_D = 2
//   blocks solved last at once, so each far row block is read and written
//   every second launch (half the right-hand-side traffic of a
//   step-by-step update) while the owner's chain stays one block deep.
//   1. P = op(T)[tile rows, sources] X[sources], K <= TRSM_D * TR_KB.
//      BN = 64.  float64: DMMA (mma.sync m16n8k4 f64, a shape sm_90
//      adds), 8 warps of 32 x 32; float32: register-tiled FFMA, 8 x 4
//      outputs a thread.  Operand slices of TR_BK = 32 go through a ring
//      of TrLayout::NST shared-memory stages (two blocks an SM) filled by
//      cp.async (16-byte copies where rows are aligned, else 8- or 4-byte
//      ones; zero fill, so any row stride and the ragged edges need no
//      padding); the transposed read happens in the staging (op(T) lands
//      k-major or m-major, whichever the fragment reads without bank
//      conflicts).  P goes through shared
//      memory, so R = S - P reads S (B on a tile's first update, X after,
//      as the step says) and writes X in rows (S was prefetched into L2
//      when the block started).
//   2. the owners keep R in shared memory and solve the TR_KB x TR_KB
//      diagonal block for their columns (prefetched into L2 during step 1)
//      in strips of 32 rows: the strip's column panel is staged (the
//      stated triangle only, the diagonal as reciprocals, one division a
//      row); four groups of 8 rows a column substitute it, each group
//      solving its 8 x 8 block in registers and the groups after it taking
//      its values; then the rows after the strip take its update (float64
//      on DMMA, float32 FFMA).
// A launch reads only rows solved by earlier launches and writes only rows
// no other block of it reads, so launches need no grid-wide barrier.  Each
// element of the triangle is read once a column tile (8 times at nrhs =
// 512) instead of once a column strip, and the work of a step spreads over
// the unsolved row blocks.
// Bound: n^2 nrhs FLOPs (n^2 / 2 elements of the triangle, 2 n nrhs of B
// and X).  The owners' chain (ceil(n/128) launches of one tile's update
// and one diagonal solve) is the floor at small nrhs.
// Only the stated triangle of op(T) is read — the update panels lie
// strictly inside it and the diagonal block is staged through a mask — so
// packed LU storage is safe: the other triangle never enters, not even as
// 0 * x; ``unit`` never reads the diagonal.
// ---------------------------------------------------------------------------

constexpr int TR_KB = 128, TR_BK = 32, TR_SUB = 32, TR_THREADS = 256;

// one launch of the sweep, in rows of op(T); reads_b: bit 0 the owner,
// bit 1 the far row blocks read their right-hand side from B (their first
// update), else from X
struct TrStep {
  int own_r0, own_k0, own_kw;
  int far_r0, far_step, far_count, far_k0, far_kw;
  int reads_b;
};

template <typename T>
struct TrLayout {
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr int BN = 64;  // columns of an output tile
  // op(T) slice as T's rows run: k-major [TR_BK][LDA_K] when TRANS, else
  // m-major [TR_KB][LDA_M]; LDA = 4 mod 16 keeps the fragment reads free of
  // bank conflicts
  static constexpr int LDA_K = TR_KB + 4, LDA_M = TR_BK + 4;
  static constexpr int A_ELEMS = TR_KB * LDA_M;  // >= TR_BK * LDA_K
  static constexpr int LDB = BN + 4;
  static constexpr int STAGE = A_ELEMS + TR_BK * LDB;  // one slice: 54 KB / 27 KB
  static constexpr int NST = F64 ? 2 : 4;              // the ring: two blocks an SM
  static constexpr int VEC = 16 / sizeof(T);           // values of a 16-byte copy
  static constexpr int LDR = BN + 1;                   // owner: its tile
  static constexpr int LDP = TR_SUB + VEC;             // owner: a strip's panel
  static constexpr int DIAG = TR_KB * LDR + TR_KB * LDP;
  static constexpr size_t bytes = sizeof(T) * (NST * STAGE > DIAG ? NST * STAGE : DIAG);
};

__device__ __forceinline__ float tr_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double tr_fma(double a, double b, double c) { return fma(a, b, c); }

// stage slice kb of op(T)[r0 + m][k0 + k] (m < rows, k < kw) and of
// X[k0 + k][c0 + j] (j < nrhs - c0) into stage buffer As.  vec_t / vec_x:
// T / X rows are 16-byte aligned, so a 16-byte copy takes VEC values along
// a row; the ragged edge reads its valid prefix and zero-fills the rest.
template <typename T, bool TRANS>
__device__ __forceinline__ void tr_stage(T* As, const T* Tm, long long ldt, const T* X,
                                         long long ldx, int nrhs, int r0, int rows, int k0,
                                         int kw, int c0, int kb, bool vec_t, bool vec_x) {
  using L = TrLayout<T>;
  constexpr int V = L::VEC;
  const int tid = threadIdx.x;
  if (vec_t) {
    constexpr int PER = (TRANS ? TR_KB : TR_BK) / V;  // copies along a row of T
#pragma unroll 4
    for (int idx = tid; idx < TR_KB * TR_BK / V; idx += TR_THREADS) {
      const int o = idx / PER, v = (idx % PER) * V;
      const int m = TRANS ? v : o, k = TRANS ? o : v;
      const int valid = TRANS ? (kb + k < kw ? min(V, max(0, rows - m)) : 0)
                              : (m < rows ? min(V, max(0, kw - kb - k)) : 0);
      const long long at = TRANS ? (long long)(k0 + kb + k) * ldt + r0 + m
                                 : (long long)(r0 + m) * ldt + k0 + kb + k;
      cp_async16(TRANS ? As + k * L::LDA_K + m : As + m * L::LDA_M + k, valid ? Tm + at : Tm,
                 valid * (int)sizeof(T));
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < TR_KB * TR_BK; idx += TR_THREADS) {
      // consecutive threads on consecutive addresses of T
      const int m = TRANS ? idx % TR_KB : idx / TR_BK;
      const int k = TRANS ? idx / TR_KB : idx % TR_BK;
      const bool ok = m < rows && kb + k < kw;
      const long long at = TRANS ? (long long)(k0 + kb + k) * ldt + r0 + m
                                 : (long long)(r0 + m) * ldt + k0 + kb + k;
      cp_async(TRANS ? As + k * L::LDA_K + m : As + m * L::LDA_M + k, ok ? Tm + at : Tm, ok);
    }
  }
  T* Bs = As + L::A_ELEMS;
  if (vec_x) {
    constexpr int PER = L::BN / V;
#pragma unroll 4
    for (int idx = tid; idx < TR_BK * L::BN / V; idx += TR_THREADS) {
      const int k = idx / PER, j = (idx % PER) * V;
      const int valid = kb + k < kw ? min(V, max(0, nrhs - c0 - j)) : 0;
      cp_async16(Bs + k * L::LDB + j, valid ? X + (long long)(k0 + kb + k) * ldx + c0 + j : X,
                 valid * (int)sizeof(T));
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < TR_BK * L::BN; idx += TR_THREADS) {
      const int k = idx / L::BN, j = idx % L::BN;
      const bool ok = kb + k < kw && c0 + j < nrhs;
      cp_async(Bs + k * L::LDB + j, ok ? X + (long long)(k0 + kb + k) * ldx + c0 + j : X, ok);
    }
  }
}

// the K loop over the slices of the sources, through the cp_ring:
// body(As, Bs) on each slice of op(T) and X in turn
template <typename T, bool TRANS, typename Body>
__device__ __forceinline__ void tr_ring(const T* Tm, long long ldt, const T* X, long long ldx,
                                        int nrhs, int r0, int rows, int k0, int kw, int c0,
                                        bool vec_t, bool vec_x, T* sm, Body&& body) {
  using L = TrLayout<T>;
  cp_ring<L::NST>(
      (kw + TR_BK - 1) / TR_BK,
      [&](int slot, int s) {
        tr_stage<T, TRANS>(sm + slot * L::STAGE, Tm, ldt, X, ldx, nrhs, r0, rows, k0, kw, c0,
                           s * TR_BK, vec_t, vec_x);
      },
      [&](int slot) { body(sm + slot * L::STAGE, sm + slot * L::STAGE + L::A_ELEMS); });
}

// 1. P = op(T)[r0 : r0 + rows, k0 : k0 + kw] X[k0 : k0 + kw, c0 : c0 + BN]
// into shared memory (sm[i * LDR + j]; zero when kw = 0).  float64: DMMA,
// 8 warps of 32 x 32 (2 x 4 tiles of 16 x 8)
template <bool TRANS>
__device__ void tr_product(const double* Tm, long long ldt, const double* X, long long ldx,
                           int nrhs, int r0, int rows, int k0, int kw, int c0, bool vec_t,
                           bool vec_x, double* sm) {
  using L = TrLayout<double>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows wm * 32, cols wn * 32
  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  tr_ring<double, TRANS>(Tm, ldt, X, ldx, nrhs, r0, rows, k0, kw, c0, vec_t, vec_x, sm,
                         [&](const double* As, const double* Bs) {
#pragma unroll
    for (int kk = 0; kk < TR_BK; kk += 4) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows g, g + 8 of the two 16-row tiles
        const int m = wm * 32 + i * 8 + g;
        a[i] = TRANS ? As[(kk + t) * L::LDA_K + m] : As[m * L::LDA_M + kk + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(kk + t) * L::LDB + wn * 32 + j * 8 + g];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[2 * i], a[2 * i + 1], b[j]);
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm * 32 + i * 16 + (e >> 1) * 8 + g;
        const int col = wn * 32 + j * 8 + 2 * t + (e & 1);
        sm[row * L::LDR + col] = acc[i][j][e];
      }
  __syncthreads();
}

// float32: register-tiled FFMA, 8 x 4 outputs a thread (rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, columns tx*4 + {0..3})
template <bool TRANS>
__device__ void tr_product(const float* Tm, long long ldt, const float* X, long long ldx,
                           int nrhs, int r0, int rows, int k0, int kw, int c0, bool vec_t,
                           bool vec_x, float* sm) {
  using L = TrLayout<float>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  tr_ring<float, TRANS>(Tm, ldt, X, ldx, nrhs, r0, rows, k0, kw, c0, vec_t, vec_x, sm,
                        [&](const float* As, const float* Bs) {
#pragma unroll
    for (int k4 = 0; k4 < TR_BK; k4 += 4) {
      // op(T) for 4 values of k: k-major (TRANS), two vector reads a k;
      // m-major, one vector read a row for all 4 (a warp reads two rows)
      float4 a4[8];
      if (!TRANS) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              As + ((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * L::LDA_M + k4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = k4 + kk;
        float a[8], b[4];
        if (TRANS) {
          const float4 a0 = *reinterpret_cast<const float4*>(As + k * L::LDA_K + ty * 4);
          const float4 a1 = *reinterpret_cast<const float4*>(As + k * L::LDA_K + 64 + ty * 4);
          a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
          a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a[i] = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * L::LDB + tx * 4);
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm[((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * L::LDR + tx * 4 + j] = acc[i][j];
  __syncthreads();
}

__device__ __forceinline__ void lds_vec(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void lds_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// the lines of the diagonal block's stored triangle, into L2 (the owner
// asks while its update runs; the values are read later by cp.async)
template <typename T, bool TRANS>
__device__ __forceinline__ void tr_prefetch_diag(const T* Tm, long long ldt, int r0, int w,
                                                 int lower) {
  constexpr int PER_LINE = 128 / sizeof(T), LINES = TR_KB / PER_LINE;
  const bool stored_lower = lower != TRANS;
  for (int idx = threadIdx.x; idx < TR_KB * LINES; idx += TR_THREADS) {
    const int i = idx / LINES, c = (idx % LINES) * PER_LINE;
    if (i < w && c < w && (stored_lower ? c <= i : c + PER_LINE > i))
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(Tm + (long long)(r0 + i) * ldt + r0 + c));
  }
}

// 2. the owner's diagonal block: op(T)[r0:r0+w, r0:r0+w] Y = Rs, in place:
// the block's stated triangle is staged once (reciprocal diagonal), then
// strips of TR_SUB rows: a thread a column substitutes the strip in
// registers, and all threads update the rows after it; then Y goes to X
template <typename T, bool TRANS>
__device__ void tr_diag_solve(const T* __restrict__ Tm, long long ldt, T* X, long long ldx,
                              int nrhs, int r0, int w, int c0, int lower, int unit, T* sm) {
  using L = TrLayout<T>;
  constexpr int BN = L::BN, GROUPS = TR_THREADS / BN, V = L::VEC;
  T* Rs = sm;
  T* Pn = sm + TR_KB * L::LDR;  // a strip's panel: op(T)[r0 + i][r0 + a + p]
  const int tid = threadIdx.x;
  const int nsub = (w + TR_SUB - 1) / TR_SUB;
  for (int qq = 0; qq < nsub; ++qq) {
    const int a = (lower ? qq : nsub - 1 - qq) * TR_SUB, h = min(TR_SUB, w - a);
    // the strip's column panel, the stated triangle only (zero elsewhere);
    // the block was prefetched into L2 while the update ran
#pragma unroll 4
    for (int idx = tid; idx < TR_KB * TR_SUB; idx += TR_THREADS) {
      const int i = TRANS ? idx % TR_KB : idx / TR_SUB;
      const int p = TRANS ? idx / TR_KB : idx % TR_SUB;
      const int c = a + p;
      const bool in_tri = lower ? i > c : i < c;
      const bool keep = i < w && p < h && (in_tri || (i == c && !unit));
      const long long at = TRANS ? (long long)(r0 + c) * ldt + r0 + i
                                 : (long long)(r0 + i) * ldt + r0 + c;
      cp_async(Pn + i * L::LDP + p, keep ? Tm + at : Tm, keep);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the diagonal as its reciprocal: one division a row, not one an element
    if (!unit && tid < h) Pn[(a + tid) * L::LDP + tid] = T(1) / Pn[(a + tid) * L::LDP + tid];
    __syncthreads();
    {  // the strip's substitution: a column a thread group, 4 groups of 8 rows
       // (thread = column c, group gq): a group solves its 8 x 8 diagonal
       // block in registers, then the groups after it take its 8 values
      constexpr int G8 = TR_SUB / 4;
      static_assert(TR_THREADS == 4 * BN, "four row groups of a strip a column");
      const int c = tid % BN, gq = tid / BN;
      const T* D = Pn + a * L::LDP;  // the strip's rows, its columns
      T x[G8];
#pragma unroll
      for (int r = 0; r < G8; ++r)
        x[r] = gq * G8 + r < h ? Rs[(a + gq * G8 + r) * L::LDR + c] : T(0);
      for (int step = 0; step < 4; ++step) {
        const int g = lower ? step : 3 - step;  // the group solved now
        if (gq == g) {
          const T* Dg = D + g * G8 * L::LDP + g * G8;
          if (lower) {
#pragma unroll
            for (int k = 0; k < G8; ++k) {
              if (!unit) x[k] *= Dg[k * L::LDP + k];  // the reciprocal diagonal
#pragma unroll
              for (int i = k + 1; i < G8; ++i) x[i] = tr_fma(-Dg[i * L::LDP + k], x[k], x[i]);
            }
          } else {
#pragma unroll
            for (int k = G8 - 1; k >= 0; --k) {
              if (!unit) x[k] *= Dg[k * L::LDP + k];
#pragma unroll
              for (int i = 0; i < k; ++i) x[i] = tr_fma(-Dg[i * L::LDP + k], x[k], x[i]);
            }
          }
#pragma unroll
          for (int r = 0; r < G8; ++r)
            if (g * G8 + r < h) Rs[(a + g * G8 + r) * L::LDR + c] = x[r];
        }
        __syncthreads();
        if (lower ? gq > g : gq < g) {  // x -= D[gq rows][g cols] x_g
          const T* Dq = D + gq * G8 * L::LDP + g * G8;
#pragma unroll
          for (int k = 0; k < G8; ++k) {
            const T xk = Rs[(a + g * G8 + k) * L::LDR + c];
#pragma unroll
            for (int r = 0; r < G8; ++r) x[r] = tr_fma(-Dq[r * L::LDP + k], xk, x[r]);
          }
        }
      }
    }
    __syncthreads();
    // the rows after the strip: Rs[i] -= Pn[i][0:h] Rs[a:a+h]
    const int lo = lower ? a + h : 0, hi = lower ? w : a;
    if constexpr (L::F64) {  // on DMMA: tiles of 16 rows x 8 columns, a warp a tile
      const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
      const int ntile = (hi - lo + 15) / 16 * (BN / 8);
      for (int tile = warp; tile < ntile; tile += TR_THREADS / 32) {
        const int ra = lo + tile / (BN / 8) * 16 + g, rb = ra + 8;  // rows g, g + 8
        const int col = tile % (BN / 8) * 8;
        double c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ra : rb;
          c[e] = r < hi ? Rs[r * L::LDR + col + 2 * t + (e & 1)] : 0.0;
        }
#pragma unroll
        for (int kk = 0; kk < TR_SUB; kk += 4) {
          const double a0 = ra < hi ? -Pn[ra * L::LDP + kk + t] : 0.0;
          const double a1 = rb < hi ? -Pn[rb * L::LDP + kk + t] : 0.0;
          dmma(c, a0, a1, Rs[(a + kk + t) * L::LDR + col + g]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ra : rb;
          if (r < hi) Rs[r * L::LDR + col + 2 * t + (e & 1)] = c[e];
        }
      }
    } else {  // FFMA: four rows of a thread at once (four independent chains)
      constexpr int RU = 4;
      const int c = tid % BN, grp = tid / BN;
      T xs[TR_SUB];
#pragma unroll
      for (int p = 0; p < TR_SUB; ++p) xs[p] = p < h ? Rs[(a + p) * L::LDR + c] : T(0);
      for (int i0 = lo + grp; i0 < hi; i0 += RU * GROUPS) {
        T acc[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) acc[u] = T(0);
#pragma unroll
        for (int p = 0; p < TR_SUB; p += V) {
#pragma unroll
          for (int u = 0; u < RU; ++u) {
            // a warp reads one row: a broadcast (a row past hi is dropped)
            T pv[V];
            lds_vec(Pn + min(i0 + u * GROUPS, TR_KB - 1) * L::LDP + p, pv);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[u] = tr_fma(pv[v], xs[p + v], acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < RU; ++u)
          if (i0 + u * GROUPS < hi) Rs[(i0 + u * GROUPS) * L::LDR + c] -= acc[u];
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < w * BN; idx += TR_THREADS) {
    const int i = idx / BN, j = idx % BN;
    if (c0 + j < nrhs) X[(long long)(r0 + i) * ldx + c0 + j] = Rs[i * L::LDR + j];
  }
}

// the lines of an output tile's right-hand side, into L2 (read at the end
// of the block)
template <typename T>
__device__ __forceinline__ void tr_prefetch_tile(const T* S, long long lds, int r0, int rows,
                                                 int c0, int ncols) {
  constexpr int PER_LINE = 128 / sizeof(T);
  constexpr int LINES = TrLayout<T>::BN / PER_LINE + 1;  // + 1: an unaligned start
  for (int idx = threadIdx.x; idx < TR_KB * LINES; idx += TR_THREADS) {
    const int i = idx / LINES, j = min((idx % LINES) * PER_LINE, ncols - 1);
    if (i < rows)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(S + (long long)(r0 + i) * lds + c0 + j));
  }
}

// one launch of the sweep (see the note above): block (x, 0) is the
// owner, block (x, y > 0) the far row block y - 1 of the step
template <typename T, bool TRANS>
__global__ void __launch_bounds__(TR_THREADS, 2)
trsm_step_kernel(const T* __restrict__ Tm, long long ldt, const T* B, long long ldb, T* X,
                 long long ldx, int n, int nrhs, int lower, int unit, TrStep st, int vec_t,
                 int vec_x) {
  using L = TrLayout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const bool owner = blockIdx.y == 0;  // scheduled first
  const int r0 = owner ? st.own_r0 : st.far_r0 + ((int)blockIdx.y - 1) * st.far_step;
  const int rows = min(TR_KB, n - r0);
  const int c0 = blockIdx.x * L::BN, ncols = min(L::BN, nrhs - c0);
  const T* S = (st.reads_b >> (owner ? 0 : 1)) & 1 ? B : X;
  const long long lds = S == B ? ldb : ldx;
  tr_prefetch_tile(S, lds, r0, rows, c0, ncols);
  if (owner) tr_prefetch_diag<T, TRANS>(Tm, ldt, r0, rows, lower);
  // the sources: rows solved by earlier launches, contiguous
  const int k0 = owner ? st.own_k0 : st.far_k0, kw = owner ? st.own_kw : st.far_kw;
  tr_product<TRANS>(Tm, ldt, X, ldx, nrhs, r0, rows, k0, kw, c0, vec_t, vec_x, sm);
  // R = S - P, read and written in rows (coalesced)
#pragma unroll 8
  for (int idx = threadIdx.x; idx < TR_KB * L::BN; idx += TR_THREADS) {
    const int i = idx / L::BN, j = idx % L::BN;
    const bool ok = i < rows && j < ncols;
    const T v = ok ? S[(long long)(r0 + i) * lds + c0 + j] - sm[i * L::LDR + j] : T(0);
    if (owner) sm[i * L::LDR + j] = v;
    else if (ok) X[(long long)(r0 + i) * ldx + c0 + j] = v;
  }
  if (!owner) return;
  __syncthreads();
  tr_diag_solve<T, TRANS>(Tm, ldt, X, ldx, nrhs, r0, rows, c0, lower, unit, sm);
}

template <typename T>
int launch_chol_base(T* a, int b, long long lda, cudaStream_t s) {
  const size_t smem = cb_smem_bytes(b, sizeof(T));
  if (b < 1 || smem > (size_t)CB_MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the shared-memory limit, raised once a device (a bit a device)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(chol_base_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CB_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised |= bit;
  }
  chol_base_kernel<T><<<1, CB_THREADS, smem, s>>>(a, b, lda);
  return (int)cudaGetLastError();
}

template <typename T, bool TRANS>
int launch_trsm_sweep(const T* Tm, long long ldt, const T* B, long long ldb, T* X,
                      long long ldx, int n, int nrhs, int lower, int unit, const TrStep* plan,
                      int nsteps, int* launched, cudaStream_t st) {
  constexpr size_t smem = TrLayout<T>::bytes;
  cudaError_t e = cudaFuncSetAttribute(trsm_step_kernel<T, TRANS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ncol = (nrhs + TrLayout<T>::BN - 1) / TrLayout<T>::BN;
  // rows of T / X start 16-byte aligned: the staging copies 16 bytes at once
  constexpr int V = TrLayout<T>::VEC;
  const int vec_t = reinterpret_cast<unsigned long long>(Tm) % 16 == 0 && ldt % V == 0;
  const int vec_x = reinterpret_cast<unsigned long long>(X) % 16 == 0 && ldx % V == 0;
  for (int s = 0; s < nsteps; ++s) {
    const dim3 grid(ncol, 1 + plan[s].far_count);
    trsm_step_kernel<T, TRANS><<<grid, TR_THREADS, smem, st>>>(
        Tm, ldt, B, ldb, X, ldx, n, nrhs, lower, unit, plan[s], vec_t, vec_x);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
  }
  return 0;
}

template <typename T>
int launch_trsm(const T* Tm, long long ldt, const T* B, long long ldb, T* X, long long ldx,
                int n, int nrhs, int lower, int unit, int trans, const int* plan, int nsteps,
                int* launched, cudaStream_t s) {
  static_assert(sizeof(TrStep) == 9 * sizeof(int), "a step is nine ints");
  *launched = 0;
  const TrStep* steps = reinterpret_cast<const TrStep*>(plan);
  return trans ? launch_trsm_sweep<T, true>(Tm, ldt, B, ldb, X, ldx, n, nrhs, lower, unit,
                                            steps, nsteps, launched, s)
               : launch_trsm_sweep<T, false>(Tm, ldt, B, ldb, X, ldx, n, nrhs, lower, unit,
                                             steps, nsteps, launched, s);
}

}  // namespace

#define SLATE_EXPORT extern "C" __attribute__((visibility("default")))

#define SLATE_DEFINE(SUF, T)                                                              \
  SLATE_EXPORT int slate_chol_base_##SUF(void* a, int b, long long lda, void* stream) {   \
    return launch_chol_base<T>((T*)a, b, lda, (cudaStream_t)stream);                      \
  }                                                                                       \
  SLATE_EXPORT int slate_gemm_sub_##SUF(const void* C, long long ldc, const void* A,      \
                                        long long lda, const void* B, long long ldb,      \
                                        void* out, long long ldo, void* work, int M,      \
                                        int N, int K, int ksplit, int kchunk,             \
                                        int variant, void* stream) {                      \
    return launch_sub_abt_variant<T, false>(variant, (const T*)C, ldc, (const T*)A, lda,  \
                                            (const T*)B, ldb, (T*)out, ldo, (T*)work, M,  \
                                            N, K, ksplit, kchunk, (cudaStream_t)stream);  \
  }                                                                                       \
  SLATE_EXPORT int slate_syrk_diag_##SUF(void* C, long long ldc, const void* A,           \
                                         long long lda, void* work, int t, int K,         \
                                         int ksplit, int kchunk, int variant,             \
                                         void* stream) {                                  \
    return launch_sub_abt_variant<T, true>(variant, (const T*)C, ldc, (const T*)A, lda,   \
                                           (const T*)A, lda, (T*)C, ldc, (T*)work, t, t,  \
                                           K, ksplit, kchunk, (cudaStream_t)stream);      \
  }                                                                                       \
  /* tile variant v of gemm_sub / syrk_diag: edge, K slice, blocks an SM */               \
  SLATE_EXPORT int slate_gemm_layout_##SUF(int v, int* bm, int* bk, int* per_sm) {        \
    if (v == 0) return gemm_layout<T, G_TILES[0]>(bm, bk, per_sm);                        \
    if (v == 1) return gemm_layout<T, G_TILES[1]>(bm, bk, per_sm);                        \
    return (int)cudaErrorInvalidValue;                                                    \
  }                                                                                       \
  SLATE_EXPORT int slate_trsm_##SUF(const void* Tm, long long ldt, const void* B,         \
                                    long long ldb, void* X, long long ldx, int n,         \
                                    int nrhs, int lower, int unit, int trans,             \
                                    const int* plan, int nsteps, int* launched,           \
                                    void* stream) {                                       \
    return launch_trsm<T>((const T*)Tm, ldt, (const T*)B, ldb, (T*)X, ldx, n, nrhs,       \
                          lower, unit, trans, plan, nsteps, launched,                     \
                          (cudaStream_t)stream);                                          \
  }                                                                                       \
  /* the trsm tile: rows of a block step, columns of an output tile */                    \
  SLATE_EXPORT int slate_trsm_layout_##SUF(int* kb, int* bn) {                            \
    *kb = TR_KB;                                                                          \
    *bn = TrLayout<T>::BN;                                                                \
    return 0;                                                                             \
  }                                                                                       \
  SLATE_EXPORT int slate_larft_##SUF(const void* V, long long ldv, const void* taus,      \
                                     void* out, void* work, int M, int w, int cd, int co, \
                                     int variant, void* stream) {                         \
    return launch_larft_variant<T>(variant, (const T*)V, ldv, (const T*)taus, (T*)out,    \
                                   (T*)work, M, w, cd, co, (cudaStream_t)stream);         \
  }                                                                                       \
  /* tile variant v of larft: edge, slice depth, blocks an SM, diagonal work */           \
  SLATE_EXPORT int slate_larft_layout_##SUF(int v, int* bm, int* bk, int* per_sm,         \
                                            int* diag_quarters) {                         \
    if (v == 0) return larft_layout<T, LARFT_TILES[0]>(bm, bk, per_sm, diag_quarters);    \
    if (v == 1) return larft_layout<T, LARFT_TILES[1]>(bm, bk, per_sm, diag_quarters);    \
    return (int)cudaErrorInvalidValue;                                                    \
  }

SLATE_DEFINE(f32, float)
SLATE_DEFINE(f64, double)
