// Hand-written Hopper kernels for the Cholesky solve path of slate_tpu_torch.
//
// Each kernel computes what one Pallas kernel of the JAX package
// (slate_tpu/ops/pallas/panel_kernels.py) computes; none is a block-by-
// block copy of it.  All are templated over float and double and use
// plain FP32/FP64 FMA, except the trsm pair's float64 products, which run
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
// wait until at most n committed groups are still in flight (n < NST <= 4)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

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

// stage slice kb of op(T)[r0 + m][k0 + k] (m < rows, k < kw) and of
// X[k0 + k][c0 + j] (j < nrhs - c0) into stage buffer As, one cp.async
// group.  vec_t / vec_x: T / X rows are 16-byte aligned, so a 16-byte copy
// takes VEC values along a row; the ragged edge reads its valid prefix and
// zero-fills the rest.
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
  cp_async_commit();
}

// the K loop over the slices of the sources, L::NST slices in flight in a
// ring: the slice just used is refilled with the one L::NST ahead
#define TR_K_LOOP(T, ...)                                                                 \
  const int nk = (kw + TR_BK - 1) / TR_BK;                                                \
  int issued = 0;                                                                         \
  for (; issued < min(nk, L::NST); ++issued)                                              \
    tr_stage<T, TRANS>(sm + issued * L::STAGE, Tm, ldt, X, ldx, nrhs, r0, rows, k0, kw,   \
                       c0, issued * TR_BK, vec_t, vec_x);                                 \
  for (int kt = 0; kt < nk; ++kt) {                                                       \
    cp_async_wait_n(issued - kt - 1);                                                     \
    __syncthreads();                                                                      \
    const T* As = sm + (kt % L::NST) * L::STAGE;                                          \
    const T* Bs = As + L::A_ELEMS;                                                        \
    __VA_ARGS__                                                                           \
    if (issued < nk) {                                                                    \
      __syncthreads(); /* every warp is done with this slot */                            \
      tr_stage<T, TRANS>(sm + (issued % L::NST) * L::STAGE, Tm, ldt, X, ldx, nrhs, r0,    \
                         rows, k0, kw, c0, issued * TR_BK, vec_t, vec_x);                 \
      ++issued;                                                                           \
    }                                                                                     \
  }                                                                                       \
  __syncthreads(); /* the ring is free: the product tile goes there */

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
  TR_K_LOOP(double, {
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
  })
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
  TR_K_LOOP(float, {
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
  })
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm[((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * L::LDR + tx * 4 + j] = acc[i][j];
  __syncthreads();
}

#undef TR_K_LOOP

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
  const size_t smem = (size_t)(CB_S + b) * CB_LDP * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      chol_base_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
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
  }

SLATE_DEFINE(f32, float)
SLATE_DEFINE(f64, double)
