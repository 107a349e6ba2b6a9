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
// 32 MiB) the panel is far beyond one SM's shared memory, and one block
// would run the whole panel serially on one SM.  So the kernel is one
// cooperative launch over the card: each block owns a contiguous slab of
// rows (``rpb`` of them), and one grid barrier a column separates the
// steps.  The host plans the grid, rpb and the strip width S
// (panel_kernels.py: panel_lu_plan).
//
// Rows never move during the elimination.  A row's current position in
// the swap order (pos) is tracked instead: column j's pivot takes position
// j and the row that held position j takes the pivot's old position, as
// the swap would have done.  Pivot ties are broken by the smallest
// position (jnp.argmax's first index over the swapped rows), so LU and
// perm are those of the swap-based elimination.
//
// Strips.  The columns go in strips [j0, j1) of S <= 32.  At a strip's
// start each block copies the strip's columns of its rows still to pivot
// into shared memory (the strip cache).  Per column j of the strip, with
// one block barrier and one grid barrier:
//   1. each block's candidate (|value|, position, row) among its rows
//      still to pivot (the best of its warps' candidates) goes to a
//      double-buffered scratch, and the candidate's strip row (its current
//      values) to that row of ``work``; without pivoting the owner of row
//      j writes row j.  Grid barrier;
//   2. every warp reduces all candidates itself (NaN counts as the
//      largest, ties go to the smallest position) -> the pivot row w, and
//      reads w's strip row from work, a lane a column; warp 0 keeps it in
//      the strip's pivot rows (piv_s, S x S: row j holds w's multipliers
//      of the strip's earlier columns, then u_j);
//   3. a warp a row, a lane a column: positions are swapped, the rows
//      still to pivot take their multiplier (l = a / pv by IEEE division,
//      0 where pv == 0; one lane a row, 32 rows at once) and l * u off
//      their strip columns right of j, in the cache, and each warp keeps
//      its candidate for column j + 1 on the way.  Block barrier.
// Columns right of the strip are not touched inside the strip.
// At the strip's end every block
//   4. builds U12, the strip's pivot rows on the trailing columns [j1, nb):
//      row jj starts from w_jj's trailing values in work, which nobody has
//      written since the strip began, and takes w_jj's own multipliers
//      against the rows before it, in order (the same arithmetic in every
//      block, so no barrier is needed);
//   5. gives its rows still to pivot the strip's updates on the trailing
//      columns, in increasing j (one read and one write of each element a
//      strip), and writes their strip columns back to work.  The strip's
//      pivot rows already hold their strip values in work (what was sent
//      in step 1 is final).
// So every element sees the same sequence a <- a - l_rj * u_j[c], in
// increasing j, as the column-by-column elimination, only later in time.
//
// The race avoided: a pivot row's owner must not write the row's U12
// values while another block may still read its trailing values in step 4.
// The owner writes them after the next column's grid barrier, which every
// block passes only after its step 4; after the last strip, when trailing
// columns remain (M < nb), a grid barrier of its own comes first.  Between
// those barriers nobody reads or writes those rows' trailing columns:
// candidates, write-backs and updates touch only rows still to pivot.
//
// The column-by-column elimination also updates finished rows, with
// l = 0 (a - 0 * u) and every row's columns left of j (a - l * 0).  That
// changes a value only where u or l is not finite, into NaN; the kernel
// marks those places (a row's columns up to the last step whose l was not
// finite; a column's rows up to the last step whose u there was not
// finite) and writes the NaNs when it copies the rows out.
//
// Rows at or past ``act`` (the recursion's canonical zero pad) are never
// eligible, so they keep their positions.  At the end each block writes
// its rows to out[pos] and perm[pos] = row.
// ---------------------------------------------------------------------------

constexpr int PL_THREADS = 512;
constexpr int PL_WARPS = PL_THREADS / 32;
constexpr int PL_MAX_S = 32;
constexpr int PL_CAND = 8;  // candidates a lane loads at once (G <= 256: one round)

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
__global__ void __launch_bounds__(PL_THREADS, 1)
panel_lu_kernel(const T* __restrict__ in, long long ldi, T* work, T* __restrict__ out,
                int* __restrict__ perm, T* cmag, int* iscr, int M, int nb, int act,
                int rpb, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldc = S | 1;                    // odd: a column of the cache hits every bank
  T* cache = reinterpret_cast<T*>(smem_raw);  // [rpb][ldc] own rows, the strip's columns
  T* piv_s = cache + (long long)rpb * ldc;    // [S][ldc] the strip's pivot rows
  T* u12 = piv_s + S * ldc;                   // [S][nb - S] the same on the trailing columns
  int* pos_s = reinterpret_cast<int*>(u12 + S * max(0, nb - S));  // [rpb] positions
  __shared__ T wm[PL_WARPS];
  __shared__ int wp[PL_WARPS], wr[PL_WARPS];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x;
  const int r0 = blockIdx.x * rpb;
  const int R = max(0, min(M, r0 + rpb) - r0);
  const int kmax = min(M, nb);
  int2* cidx = reinterpret_cast<int2*>(iscr);         // [2][G] candidates (position, row)
  int* nanl = iscr + 4 * G;                           // [M] row r: NaN in columns <= nanl[r]
  int* bad = nanl + M + (long long)blockIdx.x * nb;   // [nb] column c: NaN at positions <= bad[c]
  int* wins = nanl + M + (long long)G * nb + blockIdx.x * PL_MAX_S;  // [S] the strip's winners

  for (long long idx = tid; idx < (long long)R * nb; idx += PL_THREADS) {
    const int r = idx / nb, c = idx % nb;
    work[(long long)(r0 + r) * nb + c] = in[(long long)(r0 + r) * ldi + c];
  }
  for (int r = tid; r < R; r += PL_THREADS) { pos_s[r] = r0 + r; nanl[r0 + r] = -1; }
  for (int c = tid; c < nb; c += PL_THREADS) bad[c] = -1;
  __syncthreads();

  // the last strip's pivot rows still to take their U12 rows (its j0, steps, j1)
  int pend_j0 = 0, pend_ns = 0, pend_j1 = nb;
  auto write_u12 = [&]() {
    const int W = nb - pend_j1;
    for (long long idx = tid; idx < (long long)R * W; idx += PL_THREADS) {
      const int r = idx / W, c = idx % W, jj = pos_s[r] - pend_j0;
      if (jj >= 0 && jj < pend_ns)
        work[(long long)(r0 + r) * nb + pend_j1 + c] = u12[jj * W + c];
    }
    pend_ns = 0;
  };

  for (int j0 = 0; j0 < kmax; j0 += S) {
    const int j1 = min(j0 + S, nb), sw = j1 - j0, ns = min(j1, kmax) - j0, W = nb - j1;
    for (int idx = tid; idx < R * sw; idx += PL_THREADS) {
      const int r = idx / sw, c = idx % sw;
      if (pos_s[r] >= j0) cache[r * ldc + c] = work[(long long)(r0 + r) * nb + j0 + c];
    }
    __syncthreads();
    if (PIVOT) {  // each warp's candidate for the strip's first column
      T m = -INFINITY;
      int p = INT_MAX, rw = -1;
      for (int r = tid; r < R; r += PL_THREADS) {
        const int ps = pos_s[r];
        if (ps >= j0 && r0 + r < act) {
          const T v = abs_v(cache[r * ldc]);
          if (cand_better(v, ps, m, p)) { m = v; p = ps; rw = r0 + r; }
        }
      }
      warp_argmax(m, p, rw);
      if (lane == 0) { wm[warp] = m; wp[warp] = p; wr[warp] = rw; }
      __syncthreads();
    }

    for (int jj = 0; jj < ns; ++jj) {
      const int j = j0 + jj;
      // 1. this block's candidate (the warps' best), sent with its strip row;
      //    without pivoting the owner of row j sends row j
      if (PIVOT) {
        if (warp == 0) {
          T m = lane < PL_WARPS ? wm[lane] : T(-INFINITY);
          int p = lane < PL_WARPS ? wp[lane] : INT_MAX;
          int rw = lane < PL_WARPS ? wr[lane] : -1;
          warp_argmax(m, p, rw);
          if (rw >= 0 && lane < sw)
            work[(long long)rw * nb + j0 + lane] = cache[(rw - r0) * ldc + lane];
          if (lane == 0) {
            const int s = (j & 1) * G + blockIdx.x;
            cmag[s] = m;
            cidx[s] = make_int2(p, rw);
          }
        }
      } else if (j >= r0 && j < r0 + R && tid < sw) {
        work[(long long)j * nb + j0 + tid] = cache[(j - r0) * ldc + tid];
      }
      grid.sync();
      if (pend_ns) {
        write_u12();
        __syncthreads();  // before positions change below
      }

      // 2. every warp reduces the grid's candidates itself (NaN counts as
      //    the largest, ties go to the smallest position) -> the pivot row w,
      //    and reads w's strip row, a lane a column
      int w = j, pw = j;
      if (PIVOT) {
        T bm = -INFINITY;
        int bp = INT_MAX, br = -1;
        const int par = (j & 1) * G;
        for (int b0 = 0; b0 < G; b0 += PL_CAND * 32) {
          T cm[PL_CAND];
          int2 cq[PL_CAND];
#pragma unroll
          for (int k = 0; k < PL_CAND; ++k) {  // all loads in flight at once
            const int b = b0 + 32 * k + lane;
            cm[k] = b < G ? cmag[par + b] : T(-INFINITY);
            cq[k] = b < G ? cidx[par + b] : make_int2(INT_MAX, -1);
          }
#pragma unroll
          for (int k = 0; k < PL_CAND; ++k)
            if (cand_better(cm[k], cq[k].x, bm, bp)) { bm = cm[k]; bp = cq[k].x; br = cq[k].y; }
        }
        warp_argmax(bm, bp, br);
        w = br;
        pw = bp;
      }
      const T u = lane < sw ? work[(long long)w * nb + j0 + lane] : T(0);
      if (warp == 0) {
        if (lane < sw) piv_s[jj * ldc + lane] = u;
        if (lane == 0) wins[jj] = w;
      }
      const T pv = __shfl_sync(0xffffffffu, u, jj);

      // 3. a warp a row, a lane a column: the swap of positions j <-> pw,
      //    the multipliers of the rows still to pivot (l = a / pv by IEEE
      //    division, 0 where pv == 0; a lane a row, 32 rows at a time) and
      //    the update of their strip columns right of j; the warp's
      //    candidate for column j + 1 on the way
      const bool next = PIVOT && jj + 1 < ns;
      T m = -INFINITY;
      int p = INT_MAX, rw = -1;
      for (int base = warp; base < R; base += PL_THREADS) {
        const int rt = base + PL_WARPS * lane;
        int pt = -1;
        T lt = T(0);
        if (rt < R) {
          const int p0 = pos_s[rt];
          pt = r0 + rt == w ? j : (p0 == j ? pw : p0);
          pos_s[rt] = pt;
          if (pt > j && pv != T(0)) lt = div_rn(cache[rt * ldc + jj], pv);
        }
        __syncwarp();
        const int rows = min(32, (R - base + PL_WARPS - 1) / PL_WARPS);
        for (int t = 0; t < rows; ++t) {
          const int pr = __shfl_sync(0xffffffffu, pt, t);
          const T l = __shfl_sync(0xffffffffu, lt, t);
          if (pr <= j) continue;  // the same for the whole warp
          const int r = base + PL_WARPS * t;
          T* a = cache + r * ldc;
          T v = T(0);
          if (lane == jj) a[jj] = l;
          else if (lane > jj && lane < sw) a[lane] = v = sub_rn(a[lane], mul_rn(l, u));
          if (next) {
            const T vn = abs_v(__shfl_sync(0xffffffffu, v, jj + 1));
            if (r0 + r < act && cand_better(vn, pr, m, p)) { m = vn; p = pr; rw = r0 + r; }
          }
        }
      }
      if (next && lane == 0) { wm[warp] = m; wp[warp] = p; wr[warp] = rw; }
      __syncthreads();
    }

    // U12: the strip's pivot rows on the trailing columns, in every block alike
    if (W > 0) {
      for (int idx = tid; idx < ns * W; idx += PL_THREADS)
        u12[idx] = work[(long long)wins[idx / W] * nb + j1 + idx % W];
      __syncthreads();
      for (int c = tid; c < W; c += PL_THREADS)
        for (int jj = 1; jj < ns; ++jj) {
          T v = u12[jj * W + c];
          for (int i = 0; i < jj; ++i) v = sub_rn(v, mul_rn(piv_s[jj * ldc + i], u12[i * W + c]));
          u12[jj * W + c] = v;
        }
      __syncthreads();
    }

    // NaN marks: columns where a u of this strip is not finite ...
    for (int c = j0 + 1 + tid; c < nb; c += PL_THREADS) {
      int b = -1;
      for (int jj = 0; jj < ns && j0 + jj < c; ++jj) {
        const T u = c < j1 ? piv_s[jj * ldc + c - j0] : u12[jj * W + c - j1];
        if (!isfinite(u)) b = j0 + jj;
      }
      if (b >= 0) bad[c] = b;
    }
    // ... and own rows whose l of this strip is not finite
    for (int r = tid; r < R; r += PL_THREADS) {
      int b = -1;
      for (int jj = 0; jj < ns && j0 + jj < pos_s[r]; ++jj)
        if (!isfinite(cache[r * ldc + jj])) b = j0 + jj;
      if (b >= 0) nanl[r0 + r] = b;
    }

    // own rows still to pivot: the strip's updates on the trailing columns,
    // in increasing j; a warp takes four of its rows at a time (each U12
    // value read once for the four), a lane a column
    for (int base = warp; base < R; base += 4 * PL_WARPS) {
      int rq[4];
      bool on[4], any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rq[q] = base + PL_WARPS * q;
        on[q] = rq[q] < R && pos_s[rq[q]] >= j0 + ns;
        any |= on[q];
      }
      if (!any) continue;
      for (int c = lane; c < W; c += 32) {
        T v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = on[q] ? work[(long long)(r0 + rq[q]) * nb + j1 + c] : T(0);
        for (int i = 0; i < ns; ++i) {
          const T uu = u12[i * W + c];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (on[q]) v[q] = sub_rn(v[q], mul_rn(cache[rq[q] * ldc + i], uu));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (on[q]) work[(long long)(r0 + rq[q]) * nb + j1 + c] = v[q];
      }
    }
    // ... and their strip columns back to work
    for (int idx = tid; idx < R * sw; idx += PL_THREADS) {
      const int r = idx / sw, c = idx % sw;
      if (pos_s[r] >= j0 + ns) work[(long long)(r0 + r) * nb + j0 + c] = cache[r * ldc + c];
    }
    if (W > 0) { pend_j0 = j0; pend_ns = ns; pend_j1 = j1; }
    __syncthreads();
  }
  if (pend_ns) {  // no next column: a barrier of its own before the U12 rows
    grid.sync();
    write_u12();
    __syncthreads();
  }

  // rows to their final positions, with the NaNs of the finished rows' updates
  for (long long idx = tid; idx < (long long)R * nb; idx += PL_THREADS) {
    const int r = idx / nb, c = idx % nb, p = pos_s[r];
    T v = work[(long long)(r0 + r) * nb + c];
    if (c <= nanl[r0 + r] || p <= bad[c]) v = T(NAN);
    out[(long long)p * nb + c] = v;
  }
  for (int r = tid; r < R; r += PL_THREADS) perm[pos_s[r]] = r0 + r;
}

template <typename T>
int launch_panel_lu(const T* in, long long ldi, T* work, T* out, int* perm, T* cmag,
                    int* iscr, int M, int nb, int act, int pivot, int grid, int rpb, int S,
                    cudaStream_t s) {
  if (S < 1 || S > PL_MAX_S || grid < 1 || (long long)grid * rpb < M)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  void* kern = pivot ? (void*)panel_lu_kernel<T, true> : (void*)panel_lu_kernel<T, false>;
  const int ldc = S | 1;
  const size_t smem = sizeof(T) * ((size_t)rpb * ldc + (size_t)S * ldc +
                                   (size_t)S * std::max(0, nb - S)) + sizeof(int) * (size_t)rpb;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;  // the plan's residency, checked: every block must be resident at once
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PL_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&in, (void*)&ldi, (void*)&work, (void*)&out, (void*)&perm,
                  (void*)&cmag, (void*)&iscr, (void*)&M, (void*)&nb, (void*)&act,
                  (void*)&rpb, (void*)&S};
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
                                        void* out, void* perm, void* cmag, void* iscr,    \
                                        int M, int nb, int act, int pivot, int grid,      \
                                        int rpb, int S, void* stream) {                   \
    return launch_panel_lu<T>((const T*)in, ldi, (T*)work, (T*)out, (int*)perm,           \
                              (T*)cmag, (int*)iscr, M, nb, act, pivot, grid, rpb, S,      \
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
