// Hand-written Hopper kernels for the Cholesky solve path of slate_tpu_torch.
//
// Each kernel computes what one Pallas kernel of the JAX package
// (slate_tpu/ops/pallas/panel_kernels.py) computes; none is a block-by-
// block copy of it.  All are templated over float and double, use plain
// FP32/FP64 FMA (no tensor cores, no TF32), launch on the caller's
// stream, allocate nothing, and read row-major operands through their
// leading dimensions (inner stride 1), so views of a larger matrix need
// no copy.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libpanel_kernels.so panel_kernels.cu
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

// ---------------------------------------------------------------------------
// chol_base: unblocked Cholesky of one (b, b) diagonal block, in place.
//
// One thread block walks the columns in strips of CB_S = 32.  Per strip:
//   a. warp 0 factors the 32 x 32 diagonal block in registers (lane i holds
//      row i; pivots and multipliers travel by shuffle), with no block
//      barrier inside the column loop;
//   b. each row of the panel below is solved against it by one thread
//      (x L^T = a_r, forward substitution from shared memory);
//   c. the trailing lower triangle takes one rank-32 update in global
//      memory (512 KB at b = 256 in double: it stays in L2), a warp per
//      row, each lane with four elements in flight.
// Three block barriers a strip instead of three a column.  The strict
// upper triangle is never read or written.  A non-positive pivot gives NaN
// (sqrt of a negative), which propagates, as in the JAX package, so the
// driver's info fires.
// ---------------------------------------------------------------------------

constexpr int CB_S = 32;
constexpr int CB_LDP = CB_S + 1;  // padded shared row: no bank conflicts
constexpr int CB_THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(CB_THREADS)
chol_base_kernel(T* __restrict__ a, int b, long long lda) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Dg = reinterpret_cast<T*>(smem_raw);  // [CB_S][CB_LDP] factored diagonal block
  T* Pn = Dg + CB_S * CB_LDP;              // [b][CB_LDP] solved panel rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = CB_THREADS / 32;

  for (int j0 = 0; j0 < b; j0 += CB_S) {
    const int w = min(CB_S, b - j0);
    const int tt = b - j0 - w;  // rows below the strip

    // a. the diagonal block, in warp 0's registers
    if (warp == 0) {
      T d[CB_S];
#pragma unroll
      for (int c = 0; c < CB_S; ++c)
        d[c] = (lane < w && c <= lane) ? a[(long long)(j0 + lane) * lda + j0 + c] : T(0);
#pragma unroll
      for (int c = 0; c < CB_S; ++c) {
        if (c < w) {
          const T pv = dev_sqrt(__shfl_sync(0xffffffffu, d[c], c));
          d[c] = lane == c ? pv : (lane > c ? d[c] / pv : d[c]);
#pragma unroll
          for (int c2 = c + 1; c2 < CB_S; ++c2) {
            const T l2 = __shfl_sync(0xffffffffu, d[c], c2);
            if (lane >= c2) d[c2] = fma(-d[c], l2, d[c2]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CB_S; ++c) {
        Dg[lane * CB_LDP + c] = d[c];
        if (lane < w && c <= lane) a[(long long)(j0 + lane) * lda + j0 + c] = d[c];
      }
    }
    __syncthreads();

    // b. the panel below: x L11^T = a_r for each row r
    for (int t = tid; t < tt; t += CB_THREADS) {
      T* row = a + (long long)(j0 + w + t) * lda + j0;
      T x[CB_S];
#pragma unroll
      for (int c = 0; c < CB_S; ++c) x[c] = c < w ? row[c] : T(0);
#pragma unroll
      for (int c = 0; c < CB_S; ++c) {
        if (c < w) {
          T s = x[c];
#pragma unroll
          for (int k = 0; k < c; ++k) s = fma(-x[k], Dg[c * CB_LDP + k], s);
          x[c] = s / Dg[c * CB_LDP + c];
        }
      }
#pragma unroll
      for (int c = 0; c < CB_S; ++c) {
        Pn[t * CB_LDP + c] = x[c];
        if (c < w) row[c] = x[c];
      }
    }
    __syncthreads();

    // c. trailing lower triangle: a[r][c] -= sum_k Pn[r][k] Pn[c][k], r >= c
    for (int r = warp; r < tt; r += nwarps) {
      const T* pr = Pn + r * CB_LDP;
      T* arow = a + (long long)(j0 + w + r) * lda + j0 + w;
      for (int c0 = 0; c0 <= r; c0 += 4 * 32) {
        T v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + 32 * q + lane;
          v[q] = c <= r ? arow[c] : T(0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + 32 * q + lane;
          if (c <= r) {
            const T* pc = Pn + c * CB_LDP;
            T s = T(0);
#pragma unroll
            for (int k = 0; k < CB_S; ++k) s = fma(pr[k], pc[k], s);
            arow[c] = v[q] - s;
          }
        }
      }
    }
    __syncthreads();  // global writes visible, shared buffers free for reuse
  }
}

// ---------------------------------------------------------------------------
// C - A B^T (gemm_sub) and its lower-triangle twin (syrk_diag, B = A).
//
// Shared-memory tiled SIMT product, 256 threads a block, K in steps of
// G_BK.  Two tile shapes from one template: BM x BM = 128 x 128 with 8 x 8
// outputs per thread (gemm_sub when the output has enough tiles to fill
// the card), and 64 x 64 with 4 x 4 (syrk_diag, small outputs).  The next
// K slice is loaded into registers while the current one is multiplied
// out of shared memory.  A and B are both read along K (their rows), so no
// transposed copy is made.  LOWER skips tiles wholly above the diagonal
// and writes only r >= c (the caller passes out == C there, so the upper
// triangle passes through).  With a work buffer (split K, grid.z > 1)
// each z-slice writes its partial product and subk_reduce finishes
// out = C - sum.
// ---------------------------------------------------------------------------

constexpr int G_BK = 16, G_THREADS = 256;

template <typename T, bool LOWER, int BM, int TM>
__global__ void __launch_bounds__(G_THREADS)
sub_abt_kernel(const T* C, long long ldc,  // may alias out (LOWER)
               const T* __restrict__ A, long long lda,
               const T* __restrict__ B, long long ldb,
               T* out, long long ldo, T* __restrict__ work,
               int M, int N, int K, int kchunk) {
  constexpr int NT = BM / TM;                    // threads along each side
  constexpr int LD = (BM * G_BK) / G_THREADS;    // loads of A (and of B) a thread
  static_assert(NT * NT == G_THREADS, "one output micro-tile per thread");
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BM;
  if (LOWER && n0 > m0 + BM - 1) return;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  __shared__ T As[G_BK][BM + 1];
  __shared__ T Bs[G_BK][BM + 1];
  const int tid = threadIdx.x, tx = tid % NT, ty = tid / NT;
  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = T(0);

  T ra[LD], rb[LD];  // the next K slice, in flight while this one is used
#pragma unroll
  for (int l = 0; l < LD; ++l) {
    const int idx = tid + l * G_THREADS, r = idx / G_BK, gk = kbeg + idx % G_BK;
    ra[l] = (m0 + r < M && gk < kend) ? A[(long long)(m0 + r) * lda + gk] : T(0);
    rb[l] = (n0 + r < N && gk < kend) ? B[(long long)(n0 + r) * ldb + gk] : T(0);
  }
  for (int k0 = kbeg; k0 < kend; k0 += G_BK) {
#pragma unroll
    for (int l = 0; l < LD; ++l) {
      const int idx = tid + l * G_THREADS, r = idx / G_BK, k = idx % G_BK;
      As[k][r] = ra[l];
      Bs[k][r] = rb[l];
    }
    __syncthreads();
    if (k0 + G_BK < kend) {
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const int idx = tid + l * G_THREADS, r = idx / G_BK, gk = k0 + G_BK + idx % G_BK;
        ra[l] = (m0 + r < M && gk < kend) ? A[(long long)(m0 + r) * lda + gk] : T(0);
        rb[l] = (n0 + r < N && gk < kend) ? B[(long long)(n0 + r) * ldb + gk] : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < G_BK; ++k) {
      T av[TM], bv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + NT * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) bv[j] = Bs[k][tx + NT * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + NT * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = n0 + tx + NT * j;
      if (c >= N) continue;
      if (work != nullptr) {
        work[((long long)blockIdx.z * M + r) * N + c] = acc[i][j];
      } else if (!LOWER || r >= c) {
        out[(long long)r * ldo + c] = C[(long long)r * ldc + c] - acc[i][j];
      }
    }
  }
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

template <typename T, bool LOWER, int BM, int TM>
int launch_sub_abt(const T* C, long long ldc, const T* A, long long lda,
                   const T* B, long long ldb, T* out, long long ldo, T* work,
                   int M, int N, int K, int ksplit, cudaStream_t s) {
  const int kchunk = ((K + ksplit - 1) / ksplit + G_BK - 1) / G_BK * G_BK;
  dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM, ksplit);
  sub_abt_kernel<T, LOWER, BM, TM><<<grid, G_THREADS, 0, s>>>(
      C, ldc, A, lda, B, ldb, out, ldo, ksplit > 1 ? work : nullptr, M, N, K, kchunk);
  if (ksplit > 1) {
    const long long total = (long long)M * N;
    const int blocks = (int)std::min<long long>((total + 255) / 256, 4096);
    subk_reduce<T, LOWER><<<blocks, 256, 0, s>>>(C, ldc, work, ksplit, out, ldo, M, N);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// trsm: op(T) X = B, op(T) lower or upper triangular, op = identity or
// transpose (TRANS reads T[c][r] for op(T)[r][c], so the backward sweep of
// a Cholesky solve reads L as L^T without a copy).
//
// The columns of B are independent: each block owns TR_NC of them and runs
// the whole substitution over the row blocks of TR_KB rows, in order.  For
// each row block:
//   1. update: rhs = B[rows] - op(T)[rows, solved] X[solved].  The warps
//      split the solved range into contiguous slices of whole 32-chunks.
//      Per chunk a warp first issues all its loads at once (32 coalesced
//      rows of op(T)'s 32 x 32 chunk into registers, and one row of X per
//      lane), so one L2 latency is paid per chunk and not one per row;
//      then lane i accumulates row r0 + i in TR_NC registers, reading
//      op(T) from registers (TRANS) or from the warp's shared tile (which
//      turns the row-major chunk around), and X as a shared broadcast.
//      The slices are summed through shared memory.
//   2. solve the diagonal block in one warp: lane i holds row i of the rhs,
//      and for each pivot row the solved value is broadcast by a shuffle and
//      applied to the rows still to solve (column-oriented substitution).
//      The diagonal block is loaded before the update, so its latency hides.
// Only the stated triangle of op(T) is read — the solved range lies strictly
// inside it, and the diagonal block loads only its own triangle — so packed
// LU storage is safe: the other triangle never enters, not even as 0 * x.
// X's leading dimension is a multiple of TR_NC (the wrapper pads it), so a
// row strip loads as aligned vectors of 4.
// ---------------------------------------------------------------------------

constexpr int TR_KB = 32, TR_NC = 4, TR_WARPS = 16, TR_THREADS = 32 * TR_WARPS;
constexpr int TR_LDS = 33;  // padded staging row

__device__ __forceinline__ void ld4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// a row strip of TR_NC values, TR_NC / 4 aligned vector loads
template <typename T>
__device__ __forceinline__ void ld_strip(const T* p, T v[TR_NC]) {
#pragma unroll
  for (int q = 0; q < TR_NC; q += 4) ld4(p + q, v + q);
}

template <typename T, bool TRANS>
constexpr size_t trsm_smem() {
  return sizeof(T) * (2 * TR_WARPS * TR_KB * TR_NC + TR_KB * (TR_KB + 1) +
                      (TRANS ? 0 : TR_WARPS * 32 * TR_LDS));
}

template <typename T, bool TRANS>
__global__ void __launch_bounds__(TR_THREADS)
trsm_kernel(const T* __restrict__ Tm, long long ldt, const T* __restrict__ B, long long ldb,
            T* X, long long ldx, int n, int nrhs, int lower, int unit) {
  static_assert(TR_NC % 4 == 0, "a strip is loaded 4 columns at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);        // [TR_WARPS][TR_KB][TR_NC]
  T* xs = red + TR_WARPS * TR_KB * TR_NC;         // [TR_WARPS][32][TR_NC]
  T* D = xs + TR_WARPS * 32 * TR_NC;              // [TR_KB][TR_KB + 1]
  T* tile = D + TR_KB * (TR_KB + 1);              // !TRANS: [TR_WARPS][32][TR_LDS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  xs += warp * 32 * TR_NC;
  tile += warp * 32 * TR_LDS;
  const int c0 = blockIdx.x * TR_NC;
  const int ncols = min(TR_NC, nrhs - c0);
  const int nblk = (n + TR_KB - 1) / TR_KB;

  for (int step = 0; step < nblk; ++step) {
    const int kb = lower ? step : nblk - 1 - step;
    const int r0 = kb * TR_KB, rh = min(TR_KB, n - r0);
    const int sb = lower ? 0 : r0 + rh, se = lower ? r0 : n;  // solved rows

    // diagonal block: the stated triangle only
    for (int idx = tid; idx < TR_KB * TR_KB; idx += TR_THREADS) {
      const int ii = TRANS ? idx % TR_KB : idx / TR_KB;
      const int pp = TRANS ? idx / TR_KB : idx % TR_KB;
      const bool in_tri = lower ? pp < ii : pp > ii;
      const bool keep = ii < rh && pp < rh && (in_tri || (ii == pp && !unit));
      const long long at = TRANS ? (long long)(r0 + pp) * ldt + r0 + ii
                                 : (long long)(r0 + ii) * ldt + r0 + pp;
      D[ii * (TR_KB + 1) + pp] = keep ? Tm[at] : T(0);
    }

    // 1. update from the solved rows, one slice of whole 32-chunks per warp
    const int per = ((se - sb + TR_WARPS - 1) / TR_WARPS + 31) / 32 * 32;
    const int qb = sb + warp * per, qe = min(se, qb + per);
    T acc[TR_NC];
#pragma unroll
    for (int j = 0; j < TR_NC; ++j) acc[j] = T(0);
    for (int q0 = qb; q0 < qe; q0 += 32) {
      const int qc = min(32, qe - q0);
      T tv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (TRANS)  // tv[i] = op(T)[r0 + lane][q0 + i]
          tv[i] = (i < qc && lane < rh) ? Tm[(long long)(q0 + i) * ldt + r0 + lane] : T(0);
        else        // tv[i] = op(T)[r0 + i][q0 + lane]
          tv[i] = (i < rh && lane < qc) ? Tm[(long long)(r0 + i) * ldt + q0 + lane] : T(0);
      }
      T xv[TR_NC] = {};
      if (lane < qc) ld_strip(X + (long long)(q0 + lane) * ldx + c0, xv);
#pragma unroll
      for (int j = 0; j < TR_NC; ++j) xs[lane * TR_NC + j] = xv[j];
      if (!TRANS) {
#pragma unroll
        for (int i = 0; i < 32; ++i) tile[i * TR_LDS + lane] = tv[i];
      }
      __syncwarp();
#pragma unroll
      for (int qq = 0; qq < 32; ++qq) {
        const T t = TRANS ? tv[qq] : tile[lane * TR_LDS + qq];
        T x[TR_NC];
        ld_strip(xs + qq * TR_NC, x);  // broadcast vector loads
#pragma unroll
        for (int j = 0; j < TR_NC; ++j) acc[j] = fma(t, x[j], acc[j]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < TR_NC; ++j) red[(warp * TR_KB + lane) * TR_NC + j] = acc[j];
    __syncthreads();

    // 2. substitution in warp 0
    if (warp == 0) {
      T r[TR_NC];
#pragma unroll
      for (int j = 0; j < TR_NC; ++j) {
        T s = T(0);
        for (int w = 0; w < TR_WARPS; ++w) s += red[(w * TR_KB + lane) * TR_NC + j];
        r[j] = (lane < rh && j < ncols) ? B[(long long)(r0 + lane) * ldb + c0 + j] - s : T(0);
      }
      for (int k = 0; k < rh; ++k) {
        const int ii = lower ? k : rh - 1 - k;
        const bool below = (lower ? lane > ii : lane < ii) && lane < rh;  // still to solve
        const T dii = unit ? T(1) : D[ii * (TR_KB + 1) + ii];
        const T dl = below ? D[lane * (TR_KB + 1) + ii] : T(0);
#pragma unroll
        for (int j = 0; j < TR_NC; ++j) {
          T xv = __shfl_sync(0xffffffffu, r[j], ii);
          if (!unit) xv = xv / dii;
          if (lane == ii) r[j] = xv;
          else if (below) r[j] = fma(-dl, xv, r[j]);
        }
      }
      if (lane < rh) {
#pragma unroll
        for (int j = 0; j < TR_NC; ++j)
          if (j < ncols) X[(long long)(r0 + lane) * ldx + c0 + j] = r[j];
      }
    }
    __syncthreads();  // this row block of X is visible to the next update
  }
}

template <typename T>
int launch_chol_base(T* a, int b, long long lda, cudaStream_t s) {
  const size_t smem = (size_t)(CB_S + b) * CB_LDP * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      chol_base_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  chol_base_kernel<T><<<1, CB_THREADS, smem, s>>>(a, b, lda);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trsm(const T* Tm, long long ldt, const T* B, long long ldb, T* X, long long ldx,
                int n, int nrhs, int lower, int unit, int trans, cudaStream_t s) {
  if (ldx % TR_NC != 0 || reinterpret_cast<unsigned long long>(X) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (nrhs + TR_NC - 1) / TR_NC;  // one strip of TR_NC columns each
  if (trans) {
    constexpr size_t smem = trsm_smem<T, true>();
    cudaError_t e = cudaFuncSetAttribute(
        trsm_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    trsm_kernel<T, true><<<blocks, TR_THREADS, smem, s>>>(Tm, ldt, B, ldb, X, ldx, n, nrhs, lower, unit);
  } else {
    constexpr size_t smem = trsm_smem<T, false>();
    cudaError_t e = cudaFuncSetAttribute(
        trsm_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    trsm_kernel<T, false><<<blocks, TR_THREADS, smem, s>>>(Tm, ldt, B, ldb, X, ldx, n, nrhs, lower, unit);
  }
  return (int)cudaGetLastError();
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
                                        int N, int K, int ksplit, int big, void* stream) {\
    return big ? launch_sub_abt<T, false, 128, 8>(                                        \
                     (const T*)C, ldc, (const T*)A, lda, (const T*)B, ldb, (T*)out, ldo,  \
                     (T*)work, M, N, K, ksplit, (cudaStream_t)stream)                     \
               : launch_sub_abt<T, false, 64, 4>(                                         \
                     (const T*)C, ldc, (const T*)A, lda, (const T*)B, ldb, (T*)out, ldo,  \
                     (T*)work, M, N, K, ksplit, (cudaStream_t)stream);                    \
  }                                                                                       \
  SLATE_EXPORT int slate_syrk_diag_##SUF(void* C, long long ldc, const void* A,           \
                                         long long lda, void* work, int t, int K,         \
                                         int ksplit, void* stream) {                      \
    return launch_sub_abt<T, true, 64, 4>((const T*)C, ldc, (const T*)A, lda, (const T*)A, \
                                          lda, (T*)C, ldc, (T*)work, t, t, K, ksplit,     \
                                          (cudaStream_t)stream);                          \
  }                                                                                       \
  SLATE_EXPORT int slate_trsm_##SUF(const void* Tm, long long ldt, const void* B,         \
                                    long long ldb, void* X, long long ldx, int n,         \
                                    int nrhs, int lower, int unit, int trans,             \
                                    void* stream) {                                       \
    return launch_trsm<T>((const T*)Tm, ldt, (const T*)B, ldb, (T*)X, ldx, n, nrhs,       \
                          lower, unit, trans, (cudaStream_t)stream);                      \
  }

SLATE_DEFINE(f32, float)
SLATE_DEFINE(f64, double)
