// Hand-written Hopper kernels for the LU solve path of slate_tpu_torch:
// the partial-pivot panel factor (panel_lu) and one level of the random
// butterfly transform (butterfly_level).
//
// Each computes what one Pallas kernel of the JAX package computes
// (slate_tpu/ops/pallas/panel_kernels.py:panel_lu_pallas and
// slate_tpu/ops/pallas/kernels.py:butterfly_level_pallas); neither is a
// block-by-block copy of it.  Both are templated over float and double,
// launch on the caller's stream, allocate nothing, and read row-major
// operands through their leading dimensions (inner stride 1).  Every
// product, sum and quotient is an explicitly rounded intrinsic
// (__dmul_rn, __dsub_rn, __ddiv_rn, ...), so no multiply-add is
// contracted and the results are bit-identical to the plain PyTorch
// versions, which run each operation as its own kernel.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o liblu_kernels.so lu_kernels.cu
//
// Every entry point returns cudaGetLastError() (or the launch's error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double abs_v(double a) { return fabs(a); }
__device__ __forceinline__ float abs_v(float a) { return fabsf(a); }

// ---------------------------------------------------------------------------
// panel_lu: partial-pivot unblocked LU of an (M, nb) panel.
//
// The panel's columns are a chain of dependent steps, each of which needs
// the whole column (pivot search) and then touches the whole trailing
// panel.  At the largest shape of the main path (16384 x 256 in double,
// 32 MiB) the panel is far beyond one SM's shared memory but fits in the
// 50 MB L2, and one block would run the whole panel serially on one SM.
// So the kernel is one cooperative launch over the card: each block owns a
// contiguous slab of rows, and one grid barrier a column separates the
// steps.
//
// Rows never move during the elimination.  A row's current position in
// the swap order (pos) is tracked instead: column j's pivot takes position
// j and the row that held position j takes the pivot's old position, as
// the swap would have done.  The arithmetic each row sees is the same as
// with physical swaps, and pivot ties are broken by the smallest position
// (jnp.argmax's first index over the swapped rows), so LU and perm are
// those of the swap-based elimination.  Per column j:
//   1. each block finds its candidate (|value|, position, row) among its
//      rows still to pivot and writes it to a double-buffered scratch;
//      grid barrier; every block reduces all candidates (NaN counts as the
//      largest, ties go to the smallest position) -> the pivot row w;
//   2. the pivot row is read into shared memory, positions are updated;
//   3. each block scales column j of its own rows still to pivot
//      (l = a / pv by IEEE division, 0 where pv == 0) and subtracts
//      l * u from their columns right of j (a warp per row, lanes along
//      the columns: coalesced, L2-resident).
// Without pivoting, step 1 is the grid barrier alone and w is row j.
// Rows at or past ``act`` (the recursion's canonical zero pad) are never
// eligible, so they keep their positions.  At the end each block writes
// its rows to out[pos] and perm[pos] = row.
// ---------------------------------------------------------------------------

constexpr int PL_THREADS = 512;
constexpr int PL_WARPS = PL_THREADS / 32;

template <typename T>
__device__ __forceinline__ bool cand_better(T m1, int p1, T m2, int p2) {
  const bool n1 = isnan(m1), n2 = isnan(m2);
  if (n1 != n2) return n1;
  if (!n1 && m1 != m2) return m1 > m2;
  return p1 < p2;
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& m, int& p, int& r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const int p2 = __shfl_xor_sync(0xffffffffu, p, off);
    const int r2 = __shfl_xor_sync(0xffffffffu, r, off);
    if (cand_better(m2, p2, m, p)) { m = m2; p = p2; r = r2; }
  }
}

template <typename T, bool PIVOT>
__global__ void __launch_bounds__(PL_THREADS)
panel_lu_kernel(const T* __restrict__ in, long long ldi, T* work, T* __restrict__ out,
                int* __restrict__ perm, T* cmag, int* cidx, int M, int nb, int act,
                int rpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* u_s = reinterpret_cast<T*>(smem_raw);  // [nb] the pivot row
  T* l_s = u_s + nb;                        // [rpb] this column's multipliers
  int* pos_s = reinterpret_cast<int*>(l_s + rpb);  // [rpb] positions of own rows
  __shared__ T wm[PL_WARPS];
  __shared__ int wp[PL_WARPS], wr[PL_WARPS];
  __shared__ int win_row, win_pos;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x;
  const int r0 = blockIdx.x * rpb;
  const int R = max(0, min(M, r0 + rpb) - r0);
  const int kmax = min(M, nb);

  for (long long idx = tid; idx < (long long)R * nb; idx += PL_THREADS) {
    const int r = idx / nb, c = idx % nb;
    work[(long long)(r0 + r) * nb + c] = in[(long long)(r0 + r) * ldi + c];
  }
  for (int r = tid; r < R; r += PL_THREADS) pos_s[r] = r0 + r;
  __syncthreads();

  for (int j = 0; j < kmax; ++j) {
    // this block's candidate for column j, then the grid's
    if (PIVOT) {
      T m = -INFINITY;
      int p = INT_MAX, rw = -1;
      for (int r = tid; r < R; r += PL_THREADS) {
        const int ps = pos_s[r];
        if (ps >= j && r0 + r < act) {
          const T v = abs_v(work[(long long)(r0 + r) * nb + j]);
          if (cand_better(v, ps, m, p)) { m = v; p = ps; rw = r0 + r; }
        }
      }
      warp_argmax(m, p, rw);
      if (lane == 0) { wm[warp] = m; wp[warp] = p; wr[warp] = rw; }
      __syncthreads();
      if (warp == 0) {
        m = lane < PL_WARPS ? wm[lane] : T(-INFINITY);
        p = lane < PL_WARPS ? wp[lane] : INT_MAX;
        rw = lane < PL_WARPS ? wr[lane] : -1;
        warp_argmax(m, p, rw);
        if (lane == 0) {
          const int s = (j & 1) * G + blockIdx.x;
          cmag[s] = m;
          cidx[2 * s] = p;
          cidx[2 * s + 1] = rw;
        }
      }
      grid.sync();
      if (warp == 0) {
        T bm = -INFINITY;
        int bp = INT_MAX, br = -1;
        for (int b = lane; b < G; b += 32) {
          const int s = (j & 1) * G + b;
          const T m2 = cmag[s];
          const int p2 = cidx[2 * s];
          if (cand_better(m2, p2, bm, bp)) { bm = m2; bp = p2; br = cidx[2 * s + 1]; }
        }
        warp_argmax(bm, bp, br);
        if (lane == 0) { win_row = br; win_pos = bp; }
      }
    } else {
      grid.sync();  // column j - 1's update is complete everywhere
      if (tid == 0) { win_row = j; win_pos = j; }  // no exchange: row j stays
    }
    __syncthreads();
    const int w = win_row, pw = win_pos;

    // the pivot row, and the swap of positions j <-> pw
    for (int c = j + tid; c < nb; c += PL_THREADS) u_s[c] = work[(long long)w * nb + c];
    for (int r = tid; r < R; r += PL_THREADS) {
      if (r0 + r == w) pos_s[r] = j;
      else if (pos_s[r] == j) pos_s[r] = pw;
    }
    __syncthreads();
    const T pv = u_s[j];

    // multipliers of the rows still to pivot (positions > j)
    for (int r = tid; r < R; r += PL_THREADS) {
      if (pos_s[r] > j) {
        T* a = work + (long long)(r0 + r) * nb + j;
        const T l = pv == T(0) ? T(0) : div_rn(*a, pv);
        *a = l;
        l_s[r] = l;
      }
    }
    __syncthreads();

    // rank-1 update of their columns right of j: a warp per row
    for (int r = warp; r < R; r += PL_WARPS) {
      if (pos_s[r] <= j) continue;
      const T l = l_s[r];
      T* row = work + (long long)(r0 + r) * nb;
#pragma unroll 4
      for (int c = j + 1 + lane; c < nb; c += 32) row[c] = sub_rn(row[c], mul_rn(l, u_s[c]));
    }
    __syncthreads();
  }

  // rows to their final positions
  for (long long idx = tid; idx < (long long)R * nb; idx += PL_THREADS) {
    const int r = idx / nb, c = idx % nb;
    out[(long long)pos_s[r] * nb + c] = work[(long long)(r0 + r) * nb + c];
  }
  for (int r = tid; r < R; r += PL_THREADS) perm[pos_s[r]] = r0 + r;
}

template <typename T>
int launch_panel_lu(const T* in, long long ldi, T* work, T* out, int* perm, T* cmag,
                    int* cidx, int M, int nb, int act, int pivot, int max_grid,
                    cudaStream_t s) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  void* kern = pivot ? (void*)panel_lu_kernel<T, true> : (void*)panel_lu_kernel<T, false>;
  // at least 16 rows a block, at most max_grid blocks
  int grid = std::min(max_grid, std::max(1, (M + 15) / 16));
  int rpb = 0;
  size_t smem = 0;
  for (;;) {
    rpb = (M + grid - 1) / grid;
    smem = (size_t)nb * sizeof(T) + (size_t)rpb * (sizeof(T) + sizeof(int));
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PL_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (grid <= per_sm * sms) break;
    grid = per_sm * sms;  // every block must be resident at once
  }
  void* args[] = {(void*)&in, (void*)&ldi, (void*)&work, (void*)&out, (void*)&perm,
                  (void*)&cmag, (void*)&cidx, (void*)&M, (void*)&nb, (void*)&act,
                  (void*)&rpb};
  e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(PL_THREADS), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// butterfly_level: one level of the random butterfly transform over the
// whole (n2, w) operand, all 2^level blocks of 2h rows in one launch.
// For rows i1 = b 2h + r and i2 = i1 + h (r < h) and every column:
//   transpose: top = s (d1 x1 + d2 x2),  bot = s (d1 x1 - d2 x2)
//   otherwise: top = s d1 (x1 + x2),     bot = s d2 (x1 - x2)
// with d1 = D[i1], d2 = D[i2], s = sqrt(1/2) in T, in the JAX kernel's
// order of operations.  Bound by bytes (each element read and written
// once); a thread a (pair, column), neighbouring threads on neighbouring
// columns, a grid-stride loop.
// ---------------------------------------------------------------------------

template <typename T, bool TRANS>
__global__ void __launch_bounds__(256)
butterfly_kernel(const T* __restrict__ X, long long ldx, const T* __restrict__ D,
                 T* __restrict__ Y, long long ldy, int h, int pairs, int w, T s) {
  const long long total = (long long)pairs * w;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int pr = idx / w, c = idx % w;
    const long long i1 = (long long)(pr / h) * 2 * h + pr % h, i2 = i1 + h;
    const T x1 = X[i1 * ldx + c], x2 = X[i2 * ldx + c];
    const T d1 = D[i1], d2 = D[i2];
    T top, bot;
    if (TRANS) {
      const T p1 = mul_rn(d1, x1), p2 = mul_rn(d2, x2);
      top = mul_rn(s, add_rn(p1, p2));
      bot = mul_rn(s, sub_rn(p1, p2));
    } else {
      top = mul_rn(s, mul_rn(d1, add_rn(x1, x2)));
      bot = mul_rn(s, mul_rn(d2, sub_rn(x1, x2)));
    }
    Y[i1 * ldy + c] = top;
    Y[i2 * ldy + c] = bot;
  }
}

template <typename T>
int launch_butterfly(const T* X, long long ldx, const T* D, T* Y, long long ldy, int n2,
                     int h, int w, int trans, cudaStream_t st) {
  const int pairs = n2 / 2;
  const long long total = (long long)pairs * w;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 132LL * 16);
  const T s = (T)std::sqrt(0.5);
  if (trans)
    butterfly_kernel<T, true><<<blocks, 256, 0, st>>>(X, ldx, D, Y, ldy, h, pairs, w, s);
  else
    butterfly_kernel<T, false><<<blocks, 256, 0, st>>>(X, ldx, D, Y, ldy, h, pairs, w, s);
  return (int)cudaGetLastError();
}

}  // namespace

#define SLATE_EXPORT extern "C" __attribute__((visibility("default")))

#define SLATE_DEFINE(SUF, T)                                                              \
  SLATE_EXPORT int slate_panel_lu_##SUF(const void* in, long long ldi, void* work,        \
                                        void* out, void* perm, void* cmag, void* cidx,    \
                                        int M, int nb, int act, int pivot, int max_grid,  \
                                        void* stream) {                                   \
    return launch_panel_lu<T>((const T*)in, ldi, (T*)work, (T*)out, (int*)perm,           \
                              (T*)cmag, (int*)cidx, M, nb, act, pivot, max_grid,          \
                              (cudaStream_t)stream);                                      \
  }                                                                                       \
  SLATE_EXPORT int slate_butterfly_level_##SUF(const void* X, long long ldx,              \
                                               const void* D, void* Y, long long ldy,     \
                                               int n2, int h, int w, int trans,           \
                                               void* stream) {                            \
    return launch_butterfly<T>((const T*)X, ldx, (const T*)D, (T*)Y, ldy, n2, h, w,       \
                               trans, (cudaStream_t)stream);                              \
  }

SLATE_DEFINE(f32, float)
SLATE_DEFINE(f64, double)
