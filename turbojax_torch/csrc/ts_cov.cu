// Thompson-chunk posterior covariance for Hopper (sm_90a).
//
// Replaces turbojax/pallas_kernels.py::fused_ts_cov (body _ts_cov_body).
// For each batch b (a candidate chunk of one trust region) it computes
//
//     out[b] = s_b * k(zs[b], zs[b]) - v[b]^T v[b] + jitter_b * I
//
// with zs (B, m, d) candidates already divided by the lengthscales and
// centered by the caller, v (B, n, m) the forward solve L^-1 K(X, zs) with
// the training axis first, k one of rbf / matern12 / matern32 / matern52,
// and scal (B, 2) = [outputscale, jitter] read on the device (no host sync).
//
// The math is the Pallas kernel's: two contractions per output tile, the
// candidate cross term over d and the explained covariance over the n
// training rows, both in full-precision FMAs (no TF32: cov = K** - v^T v is
// a cancellation whose true value at deep trust-region refinement is ~1e-4
// of its operands), then the kernel function, the subtraction and the
// diagonal jitter as an epilogue in registers. The squared norms share the
// cross term's FMA order, so the diagonal's d2 is exactly 0.
//
// What bounds it on an H100: at the main path's chunk (m = 1000, n = 2048,
// d = 60) one matrix is 2 m^2 (n + d) = 4.2 GFLOP against ~8 MB read and
// 4 MB written, so it is bound by fp32 FMAs (67 TFLOP/s without tensor
// cores), not by memory. The tensor cores are ruled out (TF32 and lower
// lose the cancellation). The design is the simple one: each 256-thread
// block owns one 64 x 64 output tile, 4 x 4 outputs per thread in
// registers (rows ty + 16p, columns tx + 16q, so shared-memory reads are
// conflict-free or broadcast); the cross term stages 16 features of the
// tile's row and column candidates at a time, v^T v stages 32 training rows
// of v[:, i-tile] and v[:, j-tile] at a time (coalesced row reads). Each
// 32-row slice is summed into its own partial before it joins the total, a
// blocked summation that keeps the f32 rounding error near that of a
// blocked GEMM. One shared buffer serves both phases (32 KB in f64).
// Ragged m, n and d are masked; blockIdx.z is the batch index. Splitting
// fp32 into tensor-core passes, using the symmetry, and fusing into the TS
// Cholesky are later work.
//
// Entry point: ts_cov_launch (plain C, loaded with ctypes). It launches on
// the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_fn.cuh"

namespace {

constexpr int TILE = 64;              // output tile is TILE x TILE
constexpr int TDIM = 16;              // threads per tile side
constexpr int R = TILE / TDIM;        // 4 x 4 outputs per thread
constexpr int THREADS = TDIM * TDIM;  // 256
constexpr int KC = 16;                // features staged per cross-term step
constexpr int NS = 32;                // training rows staged per v^T v step
constexpr int SMEM = 2 * NS * TILE;   // elements; >= 2 * TILE * (KC + 1)

template <typename T, int KID>
__global__ void __launch_bounds__(THREADS)
ts_cov_tile(const T* __restrict__ zs, const T* __restrict__ v,
            const T* __restrict__ scal, T* __restrict__ out, int m, int n, int d) {
  __shared__ T smem[SMEM];
  // cross-term phase: the i-tile's and j-tile's candidates, KC features
  // (+1 column of padding keeps the column reads conflict-free)
  T (*zi_s)[KC + 1] = reinterpret_cast<T (*)[KC + 1]>(smem);
  T (*zj_s)[KC + 1] = reinterpret_cast<T (*)[KC + 1]>(smem + TILE * (KC + 1));
  // v^T v phase: NS training rows of v[:, i-tile] and v[:, j-tile]
  T (*vi_s)[TILE] = reinterpret_cast<T (*)[TILE]>(smem);
  T (*vj_s)[TILE] = reinterpret_cast<T (*)[TILE]>(smem + NS * TILE);

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % TDIM;
  const int ty = threadIdx.x / TDIM;

  zs += (size_t)b * m * d;
  v += (size_t)b * n * m;
  out += (size_t)b * m * m;

  T cross[R][R];
  T acc[R][R];
  T sqi[R];
  T sqj[R];
#pragma unroll
  for (int p = 0; p < R; ++p) {
    sqi[p] = T(0);
    sqj[p] = T(0);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      cross[p][q] = T(0);
      acc[p][q] = T(0);
    }
  }

  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
      const int r = e / KC;
      const int c = e % KC;
      const int k = k0 + c;
      // zero padding past m or d adds fma(0, 0, acc) == acc exactly
      zi_s[r][c] = (i0 + r < m && k < d) ? zs[(size_t)(i0 + r) * d + k] : T(0);
      zj_s[r][c] = (j0 + r < m && k < d) ? zs[(size_t)(j0 + r) * d + k] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      T a[R];
      T bv[R];
#pragma unroll
      for (int p = 0; p < R; ++p) {
        a[p] = zi_s[ty + TDIM * p][c];
        sqi[p] = dev_fma(a[p], a[p], sqi[p]);
        bv[p] = zj_s[tx + TDIM * p][c];
        sqj[p] = dev_fma(bv[p], bv[p], sqj[p]);
      }
#pragma unroll
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int q = 0; q < R; ++q) cross[p][q] = dev_fma(a[p], bv[q], cross[p][q]);
      }
    }
    __syncthreads();
  }

  for (int n0 = 0; n0 < n; n0 += NS) {
    for (int e = threadIdx.x; e < NS * TILE; e += THREADS) {
      const int r = e / TILE;
      const int c = e % TILE;
      const int row = n0 + r;
      vi_s[r][c] = (row < n && i0 + c < m) ? v[(size_t)row * m + i0 + c] : T(0);
      vj_s[r][c] = (row < n && j0 + c < m) ? v[(size_t)row * m + j0 + c] : T(0);
    }
    __syncthreads();
    T part[R][R];
#pragma unroll
    for (int p = 0; p < R; ++p) {
#pragma unroll
      for (int q = 0; q < R; ++q) part[p][q] = T(0);
    }
#pragma unroll 8
    for (int r = 0; r < NS; ++r) {
      T a[R];
      T bv[R];
#pragma unroll
      for (int p = 0; p < R; ++p) {
        a[p] = vi_s[r][ty + TDIM * p];
        bv[p] = vj_s[r][tx + TDIM * p];
      }
#pragma unroll
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int q = 0; q < R; ++q) part[p][q] = dev_fma(a[p], bv[q], part[p][q]);
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) {
#pragma unroll
      for (int q = 0; q < R; ++q) acc[p][q] += part[p][q];
    }
    __syncthreads();
  }

  const T outputscale = scal[2 * b];
  const T jitter = scal[2 * b + 1];
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const int row = i0 + ty + TDIM * p;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int col = j0 + tx + TDIM * q;
      if (col >= m) continue;
      T d2 = (sqi[p] + sqj[q]) - T(2) * cross[p][q];
      d2 = d2 < T(0) ? T(0) : d2;  // clamp the cancellation; NaN propagates
      T k = kernel_fn<T, KID>(d2, outputscale) - acc[p][q];
      if (row == col) k += jitter;
      out[(size_t)row * m + col] = k;
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* zs, const void* v, const void* scal, void* out,
                         int batch, int m, int n, int d, int kernel_id, cudaStream_t stream) {
  const T* z = static_cast<const T*>(zs);
  const T* vv = static_cast<const T*>(v);
  const T* s = static_cast<const T*>(scal);
  T* o = static_cast<T*>(out);
  const dim3 grid((m + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  switch (kernel_id) {
    case RBF: ts_cov_tile<T, RBF><<<grid, THREADS, 0, stream>>>(z, vv, s, o, m, n, d); break;
    case MATERN12: ts_cov_tile<T, MATERN12><<<grid, THREADS, 0, stream>>>(z, vv, s, o, m, n, d); break;
    case MATERN32: ts_cov_tile<T, MATERN32><<<grid, THREADS, 0, stream>>>(z, vv, s, o, m, n, d); break;
    case MATERN52: ts_cov_tile<T, MATERN52><<<grid, THREADS, 0, stream>>>(z, vv, s, o, m, n, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, otherwise the cudaError_t of the refused launch.
// is_double selects the float (0) or double (1) instantiation.
int ts_cov_launch(const void* zs, const void* v, const void* scal, void* out,
                  int batch, int m, int n, int d, int kernel_id, int is_double, void* stream) {
  if (batch <= 0 || m <= 0 || n < 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_double
      ? launch_typed<double>(zs, v, scal, out, batch, m, n, d, kernel_id, s)
      : launch_typed<float>(zs, v, scal, out, batch, m, n, d, kernel_id, s);
  return (int)err;
}

const char* ts_cov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
