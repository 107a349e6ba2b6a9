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
//   tile_norms(kind): one block per tile, 8 warps.  max: NaN propagates as
//     in torch.amax (CUDA's fmax would drop it), so the result is the
//     plain version's bit for bit.  fro_sumsq, one (column sums), inf (row
//     sums): fixed-order reductions (a strided serial sum per thread, then
//     a fixed tree), so a result does not change from run to run.  |.| is
//     taken inside (a no-op on the norm drivers' already absolute input).
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
enum Kind { kMax = 0, kFroSumsq = 1, kOne = 2, kInf = 3 };

template <typename T, int KIND>
__device__ __forceinline__ T combine(T a, T b) {
  if (KIND == kMax) return nan_max(a, b);
  return a + b;
}

template <typename T, int KIND>
__device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = combine<T, KIND>(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(TN_THREADS)
tile_norms_kernel(const T* __restrict__ A, long long sn, long long ld, int mb, int nb,
                  T* __restrict__ out) {
  __shared__ T red[TN_WARPS][32];
  const T* tile = A + (long long)blockIdx.x * sn;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if (KIND == kMax || KIND == kFroSumsq) {
    // a warp a row, lanes along the row (no index division), then a
    // shuffle tree and a tree over the warps
    T s = T(0);
    for (int r = warp; r < mb; r += TN_WARPS)
      for (int c = lane; c < nb; c += 32) {
        const T v = abs_v(tile[(long long)r * ld + c]);
        s = KIND == kMax ? nan_max(v, s) : s + v * v;
      }
    s = warp_reduce<T, KIND>(s);
    if (lane == 0) red[warp][0] = s;
    __syncthreads();
    if (warp == 0) {
      s = lane < TN_WARPS ? red[lane][0] : T(0);
      s = warp_reduce<T, KIND>(s);
      if (lane == 0) out[blockIdx.x] = s;
    }
  } else if (KIND == kOne) {
    // column sums: strips of 32 columns, warp w sums rows w, w + 8, ...
    for (int c0 = 0; c0 < nb; c0 += 32) {
      const int c = c0 + lane;
      T s = T(0);
      if (c < nb)
        for (int r = warp; r < mb; r += TN_WARPS) s += abs_v(tile[(long long)r * ld + c]);
      red[warp][lane] = s;
      __syncthreads();
      if (warp == 0 && c < nb) {
        T t = red[0][lane];
#pragma unroll
        for (int w = 1; w < TN_WARPS; ++w) t += red[w][lane];
        out[(long long)blockIdx.x * nb + c] = t;
      }
      __syncthreads();
    }
  } else {
    // row sums: a warp a row, lanes along the row, then a shuffle tree
    for (int r = warp; r < mb; r += TN_WARPS) {
      T s = T(0);
      for (int c = lane; c < nb; c += 32) s += abs_v(tile[(long long)r * ld + c]);
      s = warp_reduce<T, KIND>(s);
      if (lane == 0) out[(long long)blockIdx.x * mb + r] = s;
    }
  }
}

template <typename T>
int launch_tile_norms(const T* A, long long sn, long long ld, int N, int mb, int nb, int kind,
                      T* out, cudaStream_t s) {
  const dim3 g(N), b(TN_THREADS);
  switch (kind) {
    case kMax: tile_norms_kernel<T, kMax><<<g, b, 0, s>>>(A, sn, ld, mb, nb, out); break;
    case kFroSumsq: tile_norms_kernel<T, kFroSumsq><<<g, b, 0, s>>>(A, sn, ld, mb, nb, out); break;
    case kOne: tile_norms_kernel<T, kOne><<<g, b, 0, s>>>(A, sn, ld, mb, nb, out); break;
    case kInf: tile_norms_kernel<T, kInf><<<g, b, 0, s>>>(A, sn, ld, mb, nb, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
                                          int N, int mb, int nb, int kind, void* out,     \
                                          void* stream) {                                 \
    return launch_tile_norms<T>((const T*)A, sn, ld, N, mb, nb, kind, (T*)out,            \
                                (cudaStream_t)stream);                                    \
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
