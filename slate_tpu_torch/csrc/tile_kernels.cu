// Hand-written Hopper kernels for the tile layer of slate_tpu_torch: the
// per-tile norm statistics (tile_norms), the fused tile add (tile_geadd)
// and the per-tile transpose (tile_transpose), over an (N, mb, nb) stack
// of tiles.
//
// Each computes what one Pallas kernel of the JAX package computes
// (slate_tpu/ops/pallas/kernels.py: tile_norms_pallas, tile_geadd_pallas,
// tile_transpose_pallas).  All three are bound by bytes: each element is
// read once (tile_geadd: two inputs) and the outputs are written once.
// The stack is read through its strides (batch stride, row stride, inner
// stride 1); outputs are contiguous.  Templated over float and double,
// launched on the caller's stream, allocating nothing.
//
//   tile_norms(kind): one block per tile, 8 warps, reading the signed
//     tiles (|.| is taken inside).  Optional per-tile counts (rows[p],
//     cols[q] for tile p Q + q) bound the valid corner: the padding
//     beyond them is never read, so a NaN left there reaches no output.
//     Loads are 16 bytes (double2 / float4) where the stack's base, row
//     stride and tile stride allow it, one value otherwise, with four
//     independent loads in flight a thread.  max, fro_sumsq and
//     max_sumsq (both in one read) walk the valid corner flat; inf gives
//     a row to a warp; one gives a vector of columns to a thread, down
//     the rows.  fro_sumsq takes an optional device scale (sums
//     (|a| / scale)^2, dividing, as the JAX package's absA / safe does)
//     and an optional device flag that makes every block write 0 and
//     return, so a caller chooses the scaled pass without a host sync.
//     max: NaN propagates as in torch.amax (CUDA's fmax would drop it),
//     so the result is the plain version's bit for bit.  The sums are
//     fixed-order reductions (several accumulators a thread, combined
//     in a fixed order, then a fixed tree), so a result does not change
//     from run to run.
//   tile_geadd: B = alpha A + beta B with explicitly rounded products and
//     sum (no multiply-add contraction): bit-identical to the plain
//     alpha * A + beta * B.
//   tile_transpose: (N, mb, nb) -> (N, nb, mb) through a padded 32 x 33
//     shared tile, coalesced on both sides.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libtile_kernels.so tile_kernels.cu
//
// Every entry point returns cudaGetLastError() (or the launch's error).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double abs_v(double a) { return fabs(a); }
__device__ __forceinline__ float abs_v(float a) { return fabsf(a); }

// max that propagates NaN from either side
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

constexpr int TN_THREADS = 256;
constexpr int TN_WARPS = TN_THREADS / 32;
// kinds of the C interface; kFroScaled is kFroSumsq given a scale
enum Kind { kMax = 0, kFroSumsq = 1, kOne = 2, kInf = 3, kMaxSumsq = 4, kFroScaled = 5 };

// independent loads a thread has in flight: 8 for the float64 kinds that
// hold 42-48 registers at 4 (one, inf, max_sumsq), so run at 4 blocks an
// SM for a 1024-tile stack (see tn_blocks_per_sm), where 4 loads leave
// them up to 4 % behind; 4 elsewhere (tools/torch_tile_norms_ab.py
// --variants; PERF.md)
template <typename T, int KIND>
__host__ __device__ constexpr int tn_unroll() {
  return sizeof(T) == 8 && (KIND == kOne || KIND == kInf || KIND == kMaxSumsq) ? 8 : 4;
}

// VEC values at p: one 16-byte load for VEC > 1 (p aligned to 16 bytes),
// marked evict-first (ld.global.cs): each byte is read once
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldcs(p);
  } else if constexpr (VEC == 2) {
    const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    static_assert(VEC == 4, "16-byte vectors: double2 or float4");
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a[0] + ... + a[K-1] (K a power of two) as a fixed pairwise tree
template <typename T, int K>
__device__ __forceinline__ T tree_sum(const T (&a)[K]) {
  T b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) b[k] = a[k];
#pragma unroll
  for (int w = K / 2; w > 0; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) b[k] += b[k + w];
  return b[0];
}

template <typename T, int K>
__device__ __forceinline__ T tree_max(const T (&a)[K]) {
  T b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) b[k] = a[k];
#pragma unroll
  for (int w = K / 2; w > 0; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) b[k] = nan_max(b[k], b[k + w]);
  return b[0];
}

// max of two values whose sign bit is clear: in float64 as 64-bit
// integers (NaN's bits lie above every number's, so NaN propagates, and
// one integer max replaces two float64 compares: on an H100, 0.700 ->
// 0.676 ms for max_sumsq at (1024, 512, 512), PERF.md); nan_max in
// float32, where the integer form measured 1-2 % slower
__device__ __forceinline__ double abs_max(double a, double b) {
  return __longlong_as_double(max(__double_as_longlong(a), __double_as_longlong(b)));
}
__device__ __forceinline__ float abs_max(float a, float b) { return nan_max(a, b); }

// the statistics of one value, |a| (divided by the scale for kFroScaled)
template <typename T, int KIND>
__device__ __forceinline__ void take(T a, T sc, T& m, T& s) {
  T v = abs_v(a);
  if (KIND == kFroScaled) v = v / sc;
  if (KIND == kMax || KIND == kMaxSumsq) m = abs_max(v, m);
  if (KIND != kMax) s += v * v;
}

// max / sum of squares over the valid rr x cc corner of a tile, walked
// flat: whole VEC-vectors first (rr x cv of them, U loads in
// flight a thread), then the cc % VEC columns left over one value at a
// time.  Each thread keeps U pairs of accumulators, combined in
// a fixed order, so a result does not change from run to run.
template <typename T, int VEC, int KIND>
__device__ __forceinline__ void flat_walk(const T* tile, long long ld, int rr, int cc, T sc,
                                          T& m_out, T& s_out) {
  constexpr int U = tn_unroll<T, KIND>();
  const int tid = threadIdx.x, cv = cc / VEC;
  T m[U], s[U];
#pragma unroll
  for (int k = 0; k < U; ++k) m[k] = s[k] = T(0);
  if (cv > 0) {
    const long long total = (long long)rr * cv;
    // a step of TN_THREADS vectors moves a position dr rows and dc vectors
    const int dr = TN_THREADS / cv, dc = TN_THREADS % cv;
    int r = tid / cv, c = tid % cv;
    for (long long i = tid; i < total; i += (long long)U * TN_THREADS) {
      T v[U][VEC];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (i + (long long)k * TN_THREADS < total) {
          load_vec<T, VEC>(tile + (long long)r * ld + (long long)c * VEC, v[k]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[k][j] = T(0);
        }
        c += dc;
        r += dr;
        if (c >= cv) {
          c -= cv;
          ++r;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (KIND != kFroScaled || i + (long long)k * TN_THREADS < total)
            take<T, KIND>(v[k][j], sc, m[k], s[k]);
    }
  }
  const int rem = cc - cv * VEC;  // < VEC columns left at the right
  for (int j = tid; j < rr * rem; j += TN_THREADS)
    take<T, KIND>(tile[(long long)(j / rem) * ld + cv * VEC + j % rem], sc, m[0], s[0]);
  m_out = tree_max(m);
  s_out = tree_sum(s);
}

// sums of |a| down W columns at p (W = VEC, aligned, or 1), over rows
// r0, r0 + step, ... < rr, U rows in flight
template <typename T, int W, int U>
__device__ __forceinline__ void column_sums(const T* p, long long ld, int r0, int step, int rr,
                                            T (&out)[W]) {
  T acc[U][W];
#pragma unroll
  for (int k = 0; k < U; ++k)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[k][j] = T(0);
  for (int r = r0; r < rr; r += U * step) {
    T v[U][W];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int rk = r + k * step;
      if (rk < rr) {
        load_vec<T, W>(p + (long long)rk * ld, v[k]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) v[k][j] = T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[k][j] += abs_v(v[k][j]);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    T col[U];
#pragma unroll
    for (int k = 0; k < U; ++k) col[k] = acc[k][j];
    out[j] = tree_sum(col);
  }
}

// the column sums of unit u of a tile's valid columns: units [0, cv) are
// VEC-vectors, the rest single columns; written to dst[column]
template <typename T, int VEC>
__device__ __forceinline__ void unit_sums(const T* tile, long long ld, int u, int cv, int r0,
                                          int step, int rr, T* dst) {
  constexpr int U = tn_unroll<T, kOne>();
  if (u < cv) {
    T o[VEC];
    column_sums<T, VEC, U>(tile + (long long)u * VEC, ld, r0, step, rr, o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[u * VEC + j] = o[j];
  } else {
    T o[1];
    const int c = cv * VEC + (u - cv);
    column_sums<T, 1, U>(tile + c, ld, r0, step, rr, o);
    dst[c] = o[0];
  }
}

// One block a tile b = p Q + q of an (N, mb, nb) stack.  With the counts,
// only rows < rows[p] and columns < cols[q] are read (the rest count as
// zero and are never loaded); without them the whole tile.  VEC = 16 /
// sizeof(T) when the stack's base, row stride and tile stride are
// multiples of 16 bytes (the wrapper checks), else 1.
template <typename T, int VEC, int KIND>
__global__ void __launch_bounds__(TN_THREADS)
tile_norms_kernel(const T* __restrict__ A, long long sn, long long ld, int mb, int nb,
                  const int* __restrict__ rows, const int* __restrict__ cols, int Q,
                  const T* __restrict__ scale, const bool* __restrict__ skip,
                  T* __restrict__ out) {
  __shared__ T red[TN_THREADS * (16 / sizeof(T))];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if ((KIND == kFroSumsq || KIND == kFroScaled) && skip != nullptr && *skip) {
    if (tid == 0) out[b] = T(0);
    return;
  }
  const T* tile = A + (long long)b * sn;
  const int rr = rows ? min(max(rows[b / Q], 0), mb) : mb;
  const int cc = cols ? min(max(cols[b % Q], 0), nb) : nb;
  const int cv = cc / VEC;

  if (KIND == kOne) {
    // column sums: a thread a unit (a VEC-vector of columns, or one of
    // the cc % VEC left), walking the rows.  When the units number fewer
    // than the threads, G groups of threads take rows g, g + G, ... and
    // their partial sums meet in shared memory, added in group order.
    const int units = cv + (cc - cv * VEC);
    T* o = out + (long long)b * nb;
    for (int c = cc + tid; c < nb; c += TN_THREADS) o[c] = T(0);
    if (units == 0) return;
    const int G = units >= TN_THREADS ? 1 : TN_THREADS / units;
    if (G == 1) {
      for (int u = tid; u < units; u += TN_THREADS) unit_sums<T, VEC>(tile, ld, u, cv, 0, 1, rr, o);
      return;
    }
    const int g = tid / units;
    if (g < G) unit_sums<T, VEC>(tile, ld, tid % units, cv, g, G, rr, red + g * cc);
    __syncthreads();
    for (int c = tid; c < cc; c += TN_THREADS) {
      T s = red[c];
      for (int h = 1; h < G; ++h) s += red[h * cc + c];
      o[c] = s;
    }
  } else if (KIND == kInf) {
    // row sums: a warp a row, each lane U vectors of it in flight, then
    // a shuffle tree
    constexpr int U = tn_unroll<T, kInf>();
    const int rem = cc - cv * VEC;
    for (int r = warp; r < mb; r += TN_WARPS) {
      T s = T(0);
      if (r < rr) {
        const T* row = tile + (long long)r * ld;
        T acc[U];
#pragma unroll
        for (int k = 0; k < U; ++k) acc[k] = T(0);
        for (int c0 = lane; c0 < cv; c0 += 32 * U) {
          T v[U][VEC];
#pragma unroll
          for (int k = 0; k < U; ++k) {
            const int c = c0 + 32 * k;
            if (c < cv) {
              load_vec<T, VEC>(row + (long long)c * VEC, v[k]);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) v[k][j] = T(0);
            }
          }
#pragma unroll
          for (int k = 0; k < U; ++k)
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[k] += abs_v(v[k][j]);
        }
        if (lane < rem) acc[0] += abs_v(row[cv * VEC + lane]);
        s = warp_sum(tree_sum(acc));
      }
      if (lane == 0) out[(long long)b * mb + r] = s;
    }
  } else {
    // max, sum of squares, or both: the flat walk, then a shuffle tree
    // and a tree over the warps
    const T sc = KIND == kFroScaled ? *scale : T(1);
    T m, s;
    flat_walk<T, VEC, KIND>(tile, ld, rr, cc, sc, m, s);
    m = warp_max(m);
    s = warp_sum(s);
    if (lane == 0) {
      red[warp] = m;
      red[TN_WARPS + warp] = s;
    }
    __syncthreads();
    if (tid == 0) {
      m = red[0];
      s = red[TN_WARPS];
      for (int w = 1; w < TN_WARPS; ++w) {
        m = nan_max(m, red[w]);
        s += red[TN_WARPS + w];
      }
      if (KIND == kMax) out[b] = m;
      else if (KIND == kMaxSumsq) {
        out[2LL * b] = m;
        out[2LL * b + 1] = s;
      } else out[b] = s;
    }
  }
}

// The grid is one block a tile, so the N blocks run in ceil(N / (sms k))
// waves at k resident blocks an SM, and this memory-bound kernel loses
// 3-10 % to a last wave that is mostly empty (at N = 1024 on an H100's
// 132 SMs, float64: 0.70-0.78 ms at 5 or 6 blocks an SM, 0.68-0.70 at 8 or 4;
// PERF.md).  So each launch takes, among 1 .. kmax (the kernel's own
// residency), the k whose waves are fullest (the larger k on a tie),
// and holds the SM to k blocks by giving each block its share of the
// SM's shared memory as dynamic shared memory it does not use.
inline int tn_blocks_per_sm(int N, int sms, int kmax) {
  int best = kmax;
  double best_fill = 0;
  for (int k = kmax; k >= 1; --k) {
    const long long slots = (long long)sms * k, waves = (N + slots - 1) / slots;
    const double fill = (double)N / (double)(waves * slots);
    if (fill > best_fill + 1e-9) {
      best = k;
      best_fill = fill;
    }
  }
  return best;
}

struct TnDevice {
  int sms = 0, smem_sm = 0, smem_block = 0, reserved = 0;
};

inline const TnDevice& tn_device(int dev) {
  static TnDevice cache[64];
  TnDevice& d = cache[dev & 63];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&d.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

// the residency of one kernel of the family on the current device:
// kmax, the k chosen for N blocks, and the dynamic shared memory that
// holds the SM to k
template <typename T, int VEC, int K>
int tn_residency(int N, int* kmax_out, int* k_out, int* dyn_out) {
  auto* kern = tile_norms_kernel<T, VEC, K>;
  static int kmax[64], static_smem[64];
  int dev = 0;
  cudaGetDevice(&dev);
  const TnDevice& d = tn_device(dev);
  if (kmax[dev & 63] == 0) {
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, kern);
    cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         d.smem_block - (int)fa.sharedSizeBytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&kmax[dev & 63], kern, TN_THREADS, 0);
    static_smem[dev & 63] = (int)fa.sharedSizeBytes;
  }
  const int km = kmax[dev & 63];
  if (km <= 0) {
    const int err = (int)cudaGetLastError();
    return err ? err : (int)cudaErrorInvalidValue;
  }
  const int k = tn_blocks_per_sm(N, d.sms, km);
  int dyn = 0;
  if (k < km) dyn = (d.smem_sm / k - d.reserved - static_smem[dev & 63]) / 1024 * 1024;
  *kmax_out = km;
  *k_out = k;
  *dyn_out = dyn;
  return 0;
}

template <typename T, int VEC, int K>
int tn_launch(const T* A, long long sn, long long ld, int N, int mb, int nb, const int* rows,
              const int* cols, int Q, const T* scale, const bool* skip, T* out, cudaStream_t s) {
  int km, k, dyn;
  if (const int err = tn_residency<T, VEC, K>(N, &km, &k, &dyn)) return err;
  tile_norms_kernel<T, VEC, K><<<N, TN_THREADS, dyn, s>>>(A, sn, ld, mb, nb, rows, cols, Q,
                                                          scale, skip, out);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_tile_norms_vec(const T* A, long long sn, long long ld, int N, int mb, int nb,
                          int kind, const int* rows, const int* cols, int Q, const T* scale,
                          const bool* skip, T* out, cudaStream_t s) {
  if (kind == kFroSumsq && scale != nullptr) kind = kFroScaled;
  switch (kind) {
#define TN_CASE(K) \
  case K: return tn_launch<T, VEC, K>(A, sn, ld, N, mb, nb, rows, cols, Q, scale, skip, out, s);
    TN_CASE(kMax)
    TN_CASE(kFroSumsq)
    TN_CASE(kOne)
    TN_CASE(kInf)
    TN_CASE(kMaxSumsq)
    TN_CASE(kFroScaled)
#undef TN_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_tile_norms(const T* A, long long sn, long long ld, int N, int mb, int nb, int kind,
                      const int* rows, const int* cols, int Q, const T* scale, const bool* skip,
                      int vec, T* out, cudaStream_t s) {
  if (Q < 1 || (kind != kFroSumsq && (scale != nullptr || skip != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (vec)
    return launch_tile_norms_vec<T, (int)(16 / sizeof(T))>(A, sn, ld, N, mb, nb, kind, rows,
                                                           cols, Q, scale, skip, out, s);
  return launch_tile_norms_vec<T, 1>(A, sn, ld, N, mb, nb, kind, rows, cols, Q, scale, skip,
                                     out, s);
}

// the residency a 16-byte launch_tile_norms of a kind over N tiles takes:
// {kmax, k}, the kernel's own blocks an SM and the blocks it is held to
template <typename T>
int tile_norms_residency(int N, int kind, int* out2) {
  int dyn = 0;
  switch (kind) {
#define TN_RES(K) \
  case K: return tn_residency<T, (int)(16 / sizeof(T)), K>(N, out2, out2 + 1, &dyn);
    TN_RES(kMax)
    TN_RES(kFroSumsq)
    TN_RES(kOne)
    TN_RES(kInf)
    TN_RES(kMaxSumsq)
#undef TN_RES
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// tile_geadd: out = alpha A + beta B, out contiguous (N, mb, nb)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
tile_geadd_kernel(T alpha, const T* __restrict__ A, long long an, long long lda, T beta,
                  const T* __restrict__ B, long long bn, long long ldb, T* __restrict__ out,
                  long long total, int mb, int nb) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long t = idx / ((long long)mb * nb);
    const int r = (int)((idx / nb) % mb), c = (int)(idx % nb);
    const T a = A[t * an + r * lda + c], b = B[t * bn + r * ldb + c];
    out[idx] = add_rn(mul_rn(alpha, a), mul_rn(beta, b));
  }
}

template <typename T>
int launch_tile_geadd(double alpha, const T* A, long long an, long long lda, double beta,
                      const T* B, long long bn, long long ldb, T* out, int N, int mb, int nb,
                      cudaStream_t s) {
  const long long total = (long long)N * mb * nb;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 132LL * 16);
  tile_geadd_kernel<T><<<blocks, 256, 0, s>>>((T)alpha, A, an, lda, (T)beta, B, bn, ldb, out,
                                              total, mb, nb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tile_transpose: out[t] = A[t]^T, out contiguous (N, nb, mb)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
tile_transpose_kernel(const T* __restrict__ A, long long an, long long lda,
                      T* __restrict__ out, int mb, int nb, int cblocks) {
  __shared__ T t[32][33];
  const long long n = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int y = ty; y < 32; y += 8) {
    const int r = r0 + y, c = c0 + tx;
    if (r < mb && c < nb) t[y][tx] = A[n * an + (long long)r * lda + c];
  }
  __syncthreads();
  T* o = out + n * mb * (long long)nb;
  for (int y = ty; y < 32; y += 8) {
    const int c = c0 + y, r = r0 + tx;  // out[c][r] = A[r][c]
    if (r < mb && c < nb) o[(long long)c * mb + r] = t[tx][y];
  }
}

template <typename T>
int launch_tile_transpose(const T* A, long long an, long long lda, T* out, int N, int mb, int nb,
                          cudaStream_t s) {
  const int cblocks = (nb + 31) / 32, rblocks = (mb + 31) / 32;
  tile_transpose_kernel<T><<<dim3((unsigned)N * cblocks, rblocks), dim3(32, 8), 0, s>>>(
      A, an, lda, out, mb, nb, cblocks);
  return (int)cudaGetLastError();
}

}  // namespace

#define SLATE_EXPORT extern "C" __attribute__((visibility("default")))

#define SLATE_DEFINE(SUF, T)                                                              \
  SLATE_EXPORT int slate_tile_norms_##SUF(const void* A, long long sn, long long ld,      \
                                          int N, int mb, int nb, int kind,                \
                                          const void* rows, const void* cols, int Q,      \
                                          const void* scale, const void* skip, int vec,   \
                                          void* out, void* stream) {                      \
    return launch_tile_norms<T>((const T*)A, sn, ld, N, mb, nb, kind, (const int*)rows,   \
                                (const int*)cols, Q, (const T*)scale, (const bool*)skip,  \
                                vec, (T*)out, (cudaStream_t)stream);                      \
  }                                                                                       \
  SLATE_EXPORT int slate_tile_norms_residency_##SUF(int N, int kind, int* out2) {       \
    return tile_norms_residency<T>(N, kind, out2);                                        \
  }                                                                                       \
  SLATE_EXPORT int slate_tile_geadd_##SUF(double alpha, const void* A, long long an,      \
                                          long long lda, double beta, const void* B,      \
                                          long long bn, long long ldb, void* out, int N,  \
                                          int mb, int nb, void* stream) {                 \
    return launch_tile_geadd<T>(alpha, (const T*)A, an, lda, beta, (const T*)B, bn, ldb,  \
                                (T*)out, N, mb, nb, (cudaStream_t)stream);                \
  }                                                                                       \
  SLATE_EXPORT int slate_tile_transpose_##SUF(const void* A, long long an, long long lda, \
                                              void* out, int N, int mb, int nb,           \
                                              void* stream) {                             \
    return launch_tile_transpose<T>((const T*)A, an, lda, (T*)out, N, mb, nb,             \
                                    (cudaStream_t)stream);                                \
  }

SLATE_DEFINE(f32, float)
SLATE_DEFINE(f64, double)
