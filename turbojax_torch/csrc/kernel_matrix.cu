// Fused GP kernel-matrix build for Hopper (sm_90a).
//
// Replaces turbojax/pallas_kernels.py::fused_kernel_matrix (body
// _kernel_body). For each batch b it computes
//
//     out[b] = s_b * k(z1[b], z2[b])  (+ noise_b on the global diagonal i == j)
//
// or, for a row block of a larger matrix (exact = 1, rows i of the block
// being rows i + diag_offset of the whole), the same with the entries on its
// global diagonal j == i + diag_offset set to the exact self-value s_b
// (+ noise_b): a cross build of the block against all of Z computes those
// entries from two copies of one point, and the caller's global diagonal
// must not depend on how the matrix was cut into blocks.
//
// with z1 (B, n, d), z2 (B, m, d) already divided by the lengthscales and
// centered by the caller, k one of rbf / matern12 / matern32 / matern52, and
// s_b = scale[b * scale_stride], noise_b = noise[b * noise_stride] read on
// the device (stride 0: one value for the whole batch; no host sync).
//
// The function is the Pallas kernel's, the kernel function of the squared
// distance with r = sqrt(d2 + 1e-30); d2 is summed directly as
// sum_k (z1_k - z2_k)^2 in full-precision FMAs on the CUDA cores (no TF32,
// no tensor cores), not through the expansion |z1|^2 + |z2|^2 - 2 z1.z2, and
// the kernel function is evaluated in double and rounded once: no
// cancellation and one rounding, so the f32 result is nearer the f64 one
// than the plain version's, and the diagonal of K(X, X) is exact (Matern-1/2
// would turn an eps * |z|^2 there into 1e-3).
//
// What bounds it on an H100: the n * m * sizeof(T) output write at d = 10
// (15 x 1000 x 1000 floats, 60 MB, 18 us at 3.35 TB/s), and at d = 60 the
// write (16 x 2000 x 2000 floats: 256 MB, 76 us) ahead of the 3 d fp32
// operations per distinct entry (5.8 GFLOP, 86 us at 67 TFLOP/s, which the
// direct differences cost: a subtraction besides each FMA). In double the
// differences run on the fp64 CUDA cores, 64 lanes a clock per SM, half the
// fp32 rate: at d = 60 the ~2d + 55 fp64 instructions per distinct entry (a
// subtraction and an FMA per feature, sqrt and exp in double) outweigh the
// bytes (2000 x 1000 at d = 60: ~21 us of fp64 issue against 5.2 us of
// bytes). The designs:
// - both: K(Z, Z) (symmetric, z2 is z1) computes the upper tiles only and
//   writes each off-diagonal tile twice, so it does half the arithmetic for
//   the same bytes written; the whole feature axis is staged at once for
//   d <= 64; one launch per call: the per-batch scalars are read through
//   pointers and strides, so the wrapper builds no scalar table;
// - float (kernel_matrix_tile): the register-tiled mainloop of
//   tile_mainloop.cuh, 64 x 64 tiles, 4 x 4 outputs per thread (d2 summed in
//   blocks of 16 features, a second accumulator), four blocks per SM, float4
//   stores along output rows where m % 4 == 0;
// - double (kernel_matrix_tile_f64): tile_f64.cuh's kernel tile, 32 x 32
//   tiles of 256 threads, 2 x 2 outputs per thread and one accumulator (<=
//   64 registers: enough threads on an SM to hide the latency of sqrt and
//   exp in double), double2 stores along output rows (the mirrored ones too)
//   where m is even; a 1000-point K(Z, Z) is 528 upper tiles, four to each
//   of the 132 SMs, where 64 x 64 tiles would give 136 (a second wave of 4
//   blocks).
// Ragged n, m and d are masked; blockIdx.z is the batch index.
//
// Entry point: kernel_matrix_launch (plain C, loaded with ctypes). It
// launches on the given stream, does not synchronise, allocates nothing and
// returns cudaGetLastError().

#include <climits>

#include "tile_f64.cuh"

namespace {

using S = tile::KTile;

// The float design (T is float).
template <typename T, int KID, bool NOISE>
__global__ void __launch_bounds__(S::THREADS, 4)
kernel_matrix_tile(const T* __restrict__ z1, const T* __restrict__ z2, const T* __restrict__ scale,
                   int scale_stride, const T* __restrict__ noise, int noise_stride, T* __restrict__ out,
                   int n, int m, int d, int col_tiles, int symmetric, int vec, int diag_offset, int exact) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int ti, tj;
  if (symmetric) {
    tile::upper_tile(blockIdx.x, ti, tj);
  } else {
    ti = blockIdx.x / col_tiles;
    tj = blockIdx.x - ti * col_tiles;
  }
  const int row0 = ti * S::TILE;
  const int col0 = tj * S::TILE;
  const int b = blockIdx.z;
  out += (size_t)b * n * m;

  T k[S::TM][S::TM];
  const T s = scale[(size_t)b * scale_stride];
  tile::kernel_tile<T, KID>(k, smem, z1 + (size_t)b * n * d, z2 + (size_t)b * m * d, row0, col0, n, m, d, s);
  // the global diagonal j == i + diag_offset crosses this tile (with offset 0: ti == tj)
  const long long shift = (long long)row0 + diag_offset - col0;
  if ((NOISE || exact) && shift > -S::TILE && shift < S::TILE) {
    const T nz = NOISE ? noise[(size_t)b * noise_stride] : T(0);
    const int ty = threadIdx.x / S::SIDE;
    const int tx = threadIdx.x % S::SIDE;
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
#pragma unroll
      for (int j = 0; j < S::TM; ++j) {
        if (S::index(ty, i) + shift == S::index(tx, j)) {
          if (exact) k[i][j] = s;
          if (NOISE) k[i][j] = dev_add(k[i][j], nz);
        }
      }
    }
  }
  tile::store_tile<T, S>(out, m, n, m, row0, col0, k, symmetric && ti != tj, vec != 0, smem);
}

// The double design: as kernel_matrix_tile, on tile_f64.cuh's kernel tile.
using SD = tile::KTileD;

template <int KID, bool NOISE>
__global__ void __launch_bounds__(SD::THREADS, 4)
kernel_matrix_tile_f64(const double* __restrict__ z1, const double* __restrict__ z2, const double* __restrict__ scale,
                       int scale_stride, const double* __restrict__ noise, int noise_stride, double* __restrict__ out,
                       int n, int m, int d, int col_tiles, int symmetric, int vec, int diag_offset, int exact) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);

  int ti, tj;
  if (symmetric) {
    tile::upper_tile(blockIdx.x, ti, tj);
  } else {
    ti = blockIdx.x / col_tiles;
    tj = blockIdx.x - ti * col_tiles;
  }
  const int row0 = ti * SD::TILE;
  const int col0 = tj * SD::TILE;
  const int b = blockIdx.z;
  out += (size_t)b * n * m;

  double k[SD::TM][SD::TM];
  const double s = scale[(size_t)b * scale_stride];
  tile::kernel_tile_d<KID, SD>(k, smem, z1 + (size_t)b * n * d, z2 + (size_t)b * m * d, row0, col0, n, m, d, s);
  // the global diagonal j == i + diag_offset crosses this tile (with offset 0: ti == tj)
  const long long shift = (long long)row0 + diag_offset - col0;
  if ((NOISE || exact) && shift > -SD::TILE && shift < SD::TILE) {
    const double nz = NOISE ? noise[(size_t)b * noise_stride] : 0.0;
    const int ty = threadIdx.x / SD::SIDE;
    const int tx = threadIdx.x % SD::SIDE;
#pragma unroll
    for (int i = 0; i < SD::TM; ++i) {
#pragma unroll
      for (int j = 0; j < SD::TM; ++j) {
        if (SD::TM * ty + i + shift == SD::TM * tx + j) {
          if (exact) k[i][j] = s;
          if (NOISE) k[i][j] = dev_add(k[i][j], nz);
        }
      }
    }
  }
  tile::store_tile_d<SD>(out, m, n, m, row0, col0, k, symmetric && ti != tj, vec != 0, smem);
}

template <int KID>
cudaError_t launch_f64_kid(const double* z1, const double* z2, const double* scale, int scale_stride,
                           const double* noise, int noise_stride, double* out, int batch, int n, int m, int d,
                           bool symmetric, bool add_noise, int diag_offset, int exact, cudaStream_t stream) {
  const int kmax = d < tile::DK ? d : tile::DK;
  const size_t smem = (size_t)(2 * kmax * SD::LDZ > SD::TILE * SD::LDT ? 2 * kmax * SD::LDZ : SD::TILE * SD::LDT) *
                      sizeof(double);
  const long long row_tiles = (n + SD::TILE - 1) / SD::TILE;
  const long long col_tiles = (m + SD::TILE - 1) / SD::TILE;
  const long long blocks = symmetric ? row_tiles * (row_tiles + 1) / 2 : row_tiles * col_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // a thread's run of columns starts at an even column: double2 stores need every row 16-byte aligned
  const bool vec = m % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto* kernel = add_noise ? &kernel_matrix_tile_f64<KID, true> : &kernel_matrix_tile_f64<KID, false>;
  cudaError_t err = add_noise ? tile::allow_smem<&kernel_matrix_tile_f64<KID, true>>(smem)
                              : tile::allow_smem<&kernel_matrix_tile_f64<KID, false>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks, 1, (unsigned)batch);
  kernel<<<grid, SD::THREADS, smem, stream>>>(z1, z2, scale, scale_stride, noise, noise_stride, out, n, m, d,
                                              (int)col_tiles, symmetric ? 1 : 0, vec ? 1 : 0, diag_offset, exact);
  return cudaGetLastError();
}

template <typename T, int KID>
cudaError_t launch_kid(const T* z1, const T* z2, const T* scale, int scale_stride, const T* noise,
                       int noise_stride, T* out, int batch, int n, int m, int d, bool symmetric, bool add_noise,
                       bool vec, int diag_offset, int exact, cudaStream_t stream) {
  const int kmax = d < tile::DK ? d : tile::DK;
  const size_t smem = (size_t)(2 * kmax * S::LDZ > S::TILE * S::LDT ? 2 * kmax * S::LDZ : S::TILE * S::LDT) *
                      sizeof(T);
  const long long row_tiles = (n + S::TILE - 1) / S::TILE;
  const long long col_tiles = (m + S::TILE - 1) / S::TILE;
  const long long blocks = symmetric ? row_tiles * (row_tiles + 1) / 2 : row_tiles * col_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto* kernel = add_noise ? &kernel_matrix_tile<T, KID, true> : &kernel_matrix_tile<T, KID, false>;
  cudaError_t err = add_noise ? tile::allow_smem<&kernel_matrix_tile<T, KID, true>>(smem)
                              : tile::allow_smem<&kernel_matrix_tile<T, KID, false>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks, 1, (unsigned)batch);
  kernel<<<grid, S::THREADS, smem, stream>>>(z1, z2, scale, scale_stride, noise, noise_stride, out, n, m, d,
                                             (int)col_tiles, symmetric ? 1 : 0, vec ? 1 : 0, diag_offset, exact);
  return cudaGetLastError();
}

cudaError_t launch_double(const void* z1, const void* z2, const void* scale, int scale_stride, const void* noise,
                          int noise_stride, void* out, int batch, int n, int m, int d, int kernel_id, bool symmetric,
                          bool add_noise, int diag_offset, int exact, cudaStream_t stream) {
  const double* a = static_cast<const double*>(z1);
  const double* b = static_cast<const double*>(z2);
  const double* s = static_cast<const double*>(scale);
  const double* nz = static_cast<const double*>(noise);
  double* o = static_cast<double*>(out);
  switch (kernel_id) {
    case RBF:
      return launch_f64_kid<RBF>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric, add_noise,
                                 diag_offset, exact, stream);
    case MATERN12:
      return launch_f64_kid<MATERN12>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                      add_noise, diag_offset, exact, stream);
    case MATERN32:
      return launch_f64_kid<MATERN32>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                      add_noise, diag_offset, exact, stream);
    case MATERN52:
      return launch_f64_kid<MATERN52>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                      add_noise, diag_offset, exact, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_typed(const void* z1, const void* z2, const void* scale, int scale_stride,
                         const void* noise, int noise_stride, void* out, int batch, int n, int m, int d,
                         int kernel_id, bool symmetric, bool add_noise, int diag_offset, int exact,
                         cudaStream_t stream) {
  const T* a = static_cast<const T*>(z1);
  const T* b = static_cast<const T*>(z2);
  const T* s = static_cast<const T*>(scale);
  const T* nz = static_cast<const T*>(noise);
  T* o = static_cast<T*>(out);
  const bool vec = sizeof(T) == 4 && m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (kernel_id) {
    case RBF:
      return launch_kid<T, RBF>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                add_noise, vec, diag_offset, exact, stream);
    case MATERN12:
      return launch_kid<T, MATERN12>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                     add_noise, vec, diag_offset, exact, stream);
    case MATERN32:
      return launch_kid<T, MATERN32>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                     add_noise, vec, diag_offset, exact, stream);
    case MATERN52:
      return launch_kid<T, MATERN52>(a, b, s, scale_stride, nz, noise_stride, o, batch, n, m, d, symmetric,
                                     add_noise, vec, diag_offset, exact, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, otherwise the cudaError_t of the refused launch.
// symmetric needs z2 == z1 (so n == m) and launches the upper tiles only.
// is_double selects the float (0) or double (1) instantiation. The global
// diagonal, where noise goes and (exact = 1) the exact self-value, is
// j == i + diag_offset (0 for a whole matrix, the block's first row for a
// row block).
int kernel_matrix_launch(const void* z1, const void* z2, const void* scale, int scale_stride,
                         const void* noise, int noise_stride, void* out, int batch, int n, int m, int d,
                         int symmetric, int kernel_id, int add_noise, int is_double, int diag_offset, int exact,
                         void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || m <= 0 || d < 0 || scale_stride < 0 || noise_stride < 0 ||
      diag_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (symmetric && (n != m || z1 != z2 || diag_offset != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? launch_double(z1, z2, scale, scale_stride, noise, noise_stride, out, batch, n, m, d, kernel_id,
                                symmetric != 0, add_noise != 0, diag_offset, exact != 0, s)
                : launch_typed<float>(z1, z2, scale, scale_stride, noise, noise_stride, out, batch, n, m, d,
                                      kernel_id, symmetric != 0, add_noise != 0, diag_offset, exact != 0, s);
  return (int)err;
}

const char* kernel_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
