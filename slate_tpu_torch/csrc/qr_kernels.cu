// Hand-written Hopper kernel for the QR path of slate_tpu_torch: the
// compact-WY assembly stage of larft.
//
// It computes what slate_tpu/ops/pallas/panel_kernels.py:_larft_tinv_body
// (the body of larft_pallas) computes, and only that:
//
//   Tinv = strict_upper(V^T V) + diag(d),  d_j = 1 / tau_j (tau_j != 0),
//                                          d_j = 1e30      (tau_j == 0)
//
// with the lower triangle exactly zero and each d_j a correctly rounded
// IEEE division, so the diagonal is bit-identical to the plain PyTorch
// version.  The <= nb triangular inverse of Tinv and the tau == 0 masking
// stay outside the kernel, on the library solve, as in the JAX package.
//
// Shape of the work: V is (M, w), w <= 1024, M up to 32768 on the main
// path (64 MiB in double at w = 256), and the output is only (w, w).
// Only the upper triangle of the Gram matrix is needed: about M w^2 FLOPs
// against M w elements read, so at w = 256 it is bound by operations.
// An output of w = 256 has only 10 tiles of 64 x 64 on or above the
// diagonal, far too few to fill 132 SMs, so the rows are split: block
// (tile, chunk) sums its chunk of rows into a partial tile in a scratch
// buffer, and a second kernel sums the partials of each element over the
// chunks in a fixed order (no atomics: the result does not change from run
// to run) and writes the diagonal and the zero lower triangle.  The first
// version is a SIMT FMA loop over shared-memory stages of 32 rows; a
// DMMA / wgmma version is later work.
//
// Templated over float and double, launched on the caller's stream,
// allocating nothing; V is read row-major through its leading dimension
// (inner stride 1).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libqr_kernels.so qr_kernels.cu
//
// Every entry point returns cudaGetLastError() (or the launch's error).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

constexpr int LT = 64;        // output tile edge
constexpr int LK = 32;        // rows of V a shared-memory stage holds
constexpr int LTHREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// Upper-triangle tile t (row-major over tiles with tj >= ti) -> (ti, tj).
__device__ __forceinline__ void tile_of(int t, int nt, int& ti, int& tj) {
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

template <typename T>
__global__ void __launch_bounds__(LTHREADS)
larft_gram_kernel(const T* __restrict__ V, long long ldv, T* __restrict__ work, int M, int w,
                  int rpc) {
  __shared__ T a_s[LK][LT];  // V[rows of the stage, tile's row columns]
  __shared__ T b_s[LK][LT];  // V[rows of the stage, tile's columns]
  const int nt = (w + LT - 1) / LT;
  int ti, tj;
  tile_of(blockIdx.x, nt, ti, tj);
  const int i0 = ti * LT, j0 = tj * LT;
  const int r_begin = blockIdx.y * rpc;
  const int r_end = min(M, r_begin + rpc);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  T acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = T(0);

  for (int r0 = r_begin; r0 < r_end; r0 += LK) {
    for (int e = tid; e < LK * LT; e += LTHREADS) {
      const int rr = e / LT, cc = e % LT;
      const int r = r0 + rr;
      const bool rok = r < r_end;
      a_s[rr][cc] = (rok && i0 + cc < w) ? V[(long long)r * ldv + i0 + cc] : T(0);
      b_s[rr][cc] = (rok && j0 + cc < w) ? V[(long long)r * ldv + j0 + cc] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < LK; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = a_s[k][ty + 16 * x];
        b[x] = b_s[k][tx + 16 * x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fma(a[x], b[y], acc[x][y]);
    }
    __syncthreads();
  }

  T* out = work + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (LT * LT);
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) out[(ty + 16 * x) * LT + tx + 16 * y] = acc[x][y];
}

template <typename T>
__global__ void __launch_bounds__(256)
larft_finish_kernel(const T* __restrict__ work, const T* __restrict__ taus, T* __restrict__ out,
                    int w, int nchunk, int tiles) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)w * w) return;
  const int i = (int)(idx / w), j = (int)(idx % w);
  T v = T(0);
  if (j > i) {
    const int nt = (w + LT - 1) / LT;
    const int ti = i / LT, tj = j / LT;
    const int t = ti * nt - ti * (ti - 1) / 2 + (tj - ti);
    const T* p = work + (long long)t * (LT * LT) + (i % LT) * LT + (j % LT);
    const long long step = (long long)tiles * (LT * LT);
    for (int c = 0; c < nchunk; ++c) v += p[c * step];  // chunks in order
  } else if (j == i) {
    const T tau = taus[i];
    v = tau != T(0) ? div_rn(T(1), tau) : T(1e30);
  }
  out[idx] = v;
}

template <typename T>
int launch_larft(const T* V, long long ldv, const T* taus, T* out, T* work, int M, int w,
                 int nchunk, int rpc, cudaStream_t s) {
  const int nt = (w + LT - 1) / LT, tiles = nt * (nt + 1) / 2;
  larft_gram_kernel<T><<<dim3(tiles, nchunk), LTHREADS, 0, s>>>(V, ldv, work, M, w, rpc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)w * w;
  larft_finish_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(work, taus, out, w,
                                                                         nchunk, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define SLATE_EXPORT extern "C" __attribute__((visibility("default")))

#define SLATE_DEFINE(SUF, T)                                                              \
  SLATE_EXPORT int slate_larft_##SUF(const void* V, long long ldv, const void* taus,      \
                                     void* out, void* work, int M, int w, int nchunk,     \
                                     int rpc, void* stream) {                             \
    return launch_larft<T>((const T*)V, ldv, (const T*)taus, (T*)out, (T*)work, M, w,     \
                           nchunk, rpc, (cudaStream_t)stream);                            \
  }

SLATE_DEFINE(f32, float)
SLATE_DEFINE(f64, double)
