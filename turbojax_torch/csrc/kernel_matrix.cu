// Fused GP kernel-matrix build for Hopper (sm_90a).
//
// Replaces turbojax/pallas_kernels.py::fused_kernel_matrix (body
// _kernel_body). For each batch b it computes
//
//     out[b] = s_b * k(z1[b], z2[b])  (+ noise_b on the global diagonal i == j)
//
// with z1 (B, n, d), z2 (B, m, d) already divided by the lengthscales and
// centered by the caller, k one of rbf / matern12 / matern32 / matern52, and
// scal (B, 2) = [outputscale, noise] read on the device (no host sync).
//
// The math is the Pallas kernel's: cross = z1 . z2^T in full precision FMAs
// (no TF32, no tensor cores), d2 = max(|z1|^2 + |z2|^2 - 2 cross, 0), then the
// kernel function with r = sqrt(d2 + 1e-30). The squared norms are
// accumulated in the same FMA order as the cross term, so two bitwise equal
// rows give d2 == 0 exactly (the diagonal of K(X, X) is exact).
//
// What bounds it on an H100: at d = 10 the FLOPs are negligible; the bound is
// the n*m*sizeof(T) output write plus one exp and one sqrt per entry (the
// 15 x 1000 x 1000 float grid batch writes 60 MB, about 18 us at 3.35 TB/s).
// The design answers that simply: each 256-thread block owns one 32 x 32
// output tile, stages its z1 and z2 rows in shared memory in chunks of 16
// features, keeps the four accumulators of each thread in registers, applies
// the kernel function as an epilogue in registers, and writes every output
// once, a warp storing 32 consecutive columns of one row (coalesced).
// Ragged edges are masked, so n, m and d are arbitrary. blockIdx.z is the
// batch index. wgmma, TMA and a persistent schedule are later work.
//
// Entry point: kernel_matrix_launch (plain C, loaded with ctypes). It
// launches on the given stream, does not synchronise, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_fn.cuh"

namespace {

constexpr int TILE = 32;             // output tile is TILE x TILE
constexpr int ROWS_PER_THREAD = 4;   // each thread owns 4 rows of one column
constexpr int THREADS = TILE * TILE / ROWS_PER_THREAD;  // 256
constexpr int ROW_STEP = THREADS / TILE;                 // 8
constexpr int KC = 16;               // features staged per shared-memory step

template <typename T, int KID, bool NOISE>
__global__ void __launch_bounds__(THREADS)
kernel_matrix_tile(const T* __restrict__ z1, const T* __restrict__ z2,
                   const T* __restrict__ scal, T* __restrict__ out,
                   int n, int m, int d) {
  // +1 column of padding keeps the per-column reads of b_s conflict-free.
  __shared__ T a_s[TILE][KC + 1];
  __shared__ T b_s[TILE][KC + 1];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % TILE;  // output column in the tile
  const int ty = threadIdx.x / TILE;  // first output row in the tile (one warp)

  z1 += (size_t)b * n * d;
  z2 += (size_t)b * m * d;
  out += (size_t)b * n * m;

  T cross[ROWS_PER_THREAD];
  T sq1[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    cross[i] = T(0);
    sq1[i] = T(0);
  }
  T sq2 = T(0);

  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
      const int r = e / KC;
      const int k = k0 + e % KC;
      // zero padding past n, m or d adds fma(0, 0, acc) == acc exactly
      a_s[r][e % KC] = (row0 + r < n && k < d) ? z1[(size_t)(row0 + r) * d + k] : T(0);
      b_s[r][e % KC] = (col0 + r < m && k < d) ? z2[(size_t)(col0 + r) * d + k] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const T bv = b_s[tx][c];
      sq2 = dev_fma(bv, bv, sq2);
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const T av = a_s[ty + ROW_STEP * i][c];  // broadcast within the warp
        cross[i] = dev_fma(av, bv, cross[i]);
        sq1[i] = dev_fma(av, av, sq1[i]);
      }
    }
    __syncthreads();
  }

  const T outputscale = scal[2 * b];
  const T noise = scal[2 * b + 1];
  const int col = col0 + tx;
  if (col >= m) return;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int row = row0 + ty + ROW_STEP * i;
    if (row < n) {
      T d2 = (sq1[i] + sq2) - T(2) * cross[i];
      d2 = d2 < T(0) ? T(0) : d2;  // clamp the cancellation; NaN propagates
      T k = kernel_fn<T, KID>(d2, outputscale);
      if (NOISE && row == col) k += noise;
      out[(size_t)row * m + col] = k;
    }
  }
}

template <typename T, int KID>
cudaError_t launch_kid(const T* z1, const T* z2, const T* scal, T* out, int batch,
                       int n, int m, int d, bool add_noise, cudaStream_t stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE, batch);
  if (add_noise) {
    kernel_matrix_tile<T, KID, true><<<grid, THREADS, 0, stream>>>(z1, z2, scal, out, n, m, d);
  } else {
    kernel_matrix_tile<T, KID, false><<<grid, THREADS, 0, stream>>>(z1, z2, scal, out, n, m, d);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* z1, const void* z2, const void* scal, void* out,
                         int batch, int n, int m, int d, int kernel_id, bool add_noise,
                         cudaStream_t stream) {
  const T* a = static_cast<const T*>(z1);
  const T* b = static_cast<const T*>(z2);
  const T* s = static_cast<const T*>(scal);
  T* o = static_cast<T*>(out);
  switch (kernel_id) {
    case RBF: return launch_kid<T, RBF>(a, b, s, o, batch, n, m, d, add_noise, stream);
    case MATERN12: return launch_kid<T, MATERN12>(a, b, s, o, batch, n, m, d, add_noise, stream);
    case MATERN32: return launch_kid<T, MATERN32>(a, b, s, o, batch, n, m, d, add_noise, stream);
    case MATERN52: return launch_kid<T, MATERN52>(a, b, s, o, batch, n, m, d, add_noise, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, otherwise the cudaError_t of the refused launch.
// is_double selects the float (0) or double (1) instantiation.
int kernel_matrix_launch(const void* z1, const void* z2, const void* scal, void* out,
                         int batch, int n, int m, int d, int kernel_id, int add_noise,
                         int is_double, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_double
      ? launch_typed<double>(z1, z2, scal, out, batch, n, m, d, kernel_id, add_noise != 0, s)
      : launch_typed<float>(z1, z2, scal, out, batch, n, m, d, kernel_id, add_noise != 0, s);
  return (int)err;
}

const char* kernel_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
