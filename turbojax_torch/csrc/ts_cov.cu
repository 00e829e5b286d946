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
// and s_b = scale[b * scale_stride], jitter_b = jitter[b * jitter_stride]
// read on the device (stride 0: one value for the whole batch).
//
// The math is the Pallas kernel's: two contractions per output tile, the
// candidate distances over d and the explained covariance over the n
// training rows, both in full-precision FMAs (no TF32: cov = K** - v^T v is
// a cancellation whose true value at deep trust-region refinement is ~1e-4
// of its operands), then the kernel function, the subtraction and the
// diagonal jitter. The kernel term is the kernel matrix's kernel tile
// (tile_mainloop.cuh): the squared distance summed directly as
// sum_k (zs_ik - zs_jk)^2, so the diagonal's d2 is exactly 0 and no
// cancellation enters it, and the function evaluated in double. v^T v is
// summed in partial sums of at most 384 training rows, which keeps the f32
// error below that of cuBLAS's SGEMM.
//
// What bounds it on an H100: the 2 (n + d) FMA flops per distinct entry
// (m = 1000, n = 2000, d = 60: 2.1 GFLOP, 31 us at 67 TFLOP/s); the bytes
// (8 MB of v, 4 MB out) take a tenth of that. The design, two kernels on
// the register-tiled mainloop of tile_mainloop.cuh:
// - pass 1 works on the upper 128 x 128 tiles only (the output is
//   symmetric), 8 x 8 outputs per thread (4 shared loads per 64 FMAs, two
//   blocks per SM). A 1000-candidate chunk has 36 upper tiles for 132 SMs,
//   so the n axis is split (cuda_kernels.ts_cov_plan picks the count, and
//   keeps every partial sum short: no chain runs past 384 rows): a block
//   per (tile, split) sums v^T v over its rows, v's tiles copied as rows
//   ([n][m], m contiguous) with 16-byte cp.async copies into two stages, the
//   next one in flight while this one is contracted. The first split's
//   block also computes the kernel term (tile::kernel_tile, the kernel
//   matrix's own, in four 64 x 64 quarters), and takes fewer rows for it,
//   so that all blocks carry about equal work and fit one wave. Each
//   partial sum and the kernel term go to their own workspace slot;
// - pass 2 takes each tile in 64 x 64 quarters (4 x 4 outputs per thread,
//   four times the blocks): the kernel term minus the partial sums, added
//   in split order, plus the jitter, stored with its mirror staged through
//   shared memory.
// No atomics: the output is bitwise reproducible from run to run. No block
// holds two 8 x 8 arrays at once (the kernel term is computed before the
// partial sum starts). Ragged m, n and d are masked; blockIdx.z (pass 1) and
// blockIdx.y (pass 2) are the batch index.
//
// Entry point: ts_cov_launch (plain C, loaded with ctypes). It launches on
// the given stream, does not synchronise, allocates nothing (the caller
// passes the workspace) and returns cudaGetLastError().

#include <climits>

#include "tile_mainloop.cuh"

namespace {

using SP = tile::Tile<128, 8>;  // pass 1, v^T v: 128 x 128 tiles, 8 x 8 outputs per thread
using SF = tile::KTile;         // the kernel term and pass 2: 64 x 64 quarters, 4 x 4 outputs per thread
static_assert(SP::THREADS == SF::THREADS, "pass 1 computes the kernel term with the same threads");
constexpr int TILE = SP::TILE;
constexpr int NS = 32;  // training rows staged per step
constexpr size_t TILE_ELEMS = (size_t)TILE * TILE;

// dst[r * TILE + c] = v[(n0 + r) * m + c0 + c] for r < rows, c < TILE; zero
// for columns at or past m. With vec (float, m % 4 == 0, v 16-byte
// aligned: a run of 4 columns is then all inside or all past m) as 16-byte
// cp.async copies that the caller waits for (tile::async_wait); otherwise
// as plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_v(T* dst, const T* __restrict__ v, int n0, int rows, int m, int c0,
                                        bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      for (int e = threadIdx.x; e < rows * (TILE / 4); e += SP::THREADS) {
        const int r = e / (TILE / 4);
        const int c = 4 * (e - r * (TILE / 4));
        const bool inside = c0 + c < m;
        tile::copy16_async(dst + r * TILE + c, inside ? v + (size_t)(n0 + r) * m + c0 + c : v, inside);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < rows * TILE; e += SP::THREADS) {
    const int r = e / TILE;
    const int c = e - r * TILE;
    dst[r * TILE + c] = c0 + c < m ? v[(size_t)(n0 + r) * m + c0 + c] : T(0);
  }
}

// Slot s of upper tile t of batch b, a row-major TILE x TILE block of the
// workspace: slots 0 .. splits-1 hold the splits' partial sums of v^T v,
// slot `splits` the kernel term.
template <typename T>
__device__ __forceinline__ T* slot(T* ws, int s, int b, int t, int batch, int tiles) {
  return ws + (((size_t)s * batch + b) * tiles + t) * TILE_ELEMS;
}

template <typename T>
__device__ __forceinline__ void put_tile(T* w, const T (&acc)[SP::TM][SP::TM]) {
  const int ty = threadIdx.x / SP::SIDE;
  const int tx = threadIdx.x % SP::SIDE;
#pragma unroll
  for (int i = 0; i < SP::TM; ++i) {
#pragma unroll
    for (int g = 0; g < SP::TM / 4; ++g) {
      tile::store4(w + SP::index(ty, i) * TILE + SP::index(tx, 4 * g), &acc[i][4 * g], 4, true);
    }
  }
}

// Pass 1, block (t, y, b): v^T v of upper tile t of batch b over the
// training rows [y * chunk - lead, (y + 1) * chunk - lead) (clipped to
// [0, n)) into slot y; block y == 0 first computes the tile's kernel term
// s * k(zs_i, zs_j) into slot `splits` (lead rows are what that costs, so
// the blocks carry about equal work).
template <typename T, int KID>
__global__ void __launch_bounds__(SP::THREADS, sizeof(T) == 4 ? 2 : 1)
ts_cov_partial(const T* __restrict__ zs, const T* __restrict__ v, const T* __restrict__ scale,
               int scale_stride, T* __restrict__ ws, int m, int n, int d, int chunk, int lead, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x;
  const int y = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  int ti, tj;
  tile::upper_tile(t, ti, tj);
  if (y == 0) {  // the kernel term, as four 64 x 64 quarters of the tile
    T* w = slot(ws, splits, b, t, gridDim.z, gridDim.x);
    const int ty = threadIdx.x / SF::SIDE;
    const int tx = threadIdx.x % SF::SIDE;
    for (int q = 0; q < 4; ++q) {
      const int r0 = (q >> 1) * SF::TILE;
      const int c0 = (q & 1) * SF::TILE;
      T k[SF::TM][SF::TM];
      tile::kernel_tile<T, KID>(k, smem, zs + (size_t)b * m * d, zs + (size_t)b * m * d, ti * TILE + r0,
                                tj * TILE + c0, m, m, d, scale[(size_t)b * scale_stride]);
#pragma unroll
      for (int i = 0; i < SF::TM; ++i) {
        tile::store4(w + (size_t)(r0 + SF::index(ty, i)) * TILE + c0 + SF::index(tx, 0), k[i], 4, true);
      }
    }
  }

  T acc[SP::TM][SP::TM];
  v += (size_t)b * n * m;
#pragma unroll
  for (int i = 0; i < SP::TM; ++i) {
#pragma unroll
    for (int j = 0; j < SP::TM; ++j) acc[i][j] = T(0);
  }
  // two stages of [v rows of tile i | v rows of tile j] (one when i == j):
  // the next stage's copies are in flight while this one is contracted
  const int n_lo = max(0, y * chunk - lead);
  const int n_hi = min(n, (y + 1) * chunk - lead);
  auto stage = [&](int buf, int n0) {
    T* vi_s = smem + buf * 2 * NS * TILE;
    const int rows = min(NS, n_hi - n0);
    stage_v(vi_s, v, n0, rows, m, ti * TILE, vec != 0);
    if (ti != tj) stage_v(vi_s + NS * TILE, v, n0, rows, m, tj * TILE, vec != 0);
  };
  if (n_lo < n_hi) stage(0, n_lo);
  tile::async_commit();
  int buf = 0;
  for (int n0 = n_lo; n0 < n_hi; n0 += NS) {
    if (n0 + NS < n_hi) stage(buf ^ 1, n0 + NS);
    tile::async_commit();
    tile::async_wait<1>();  // this stage's copies have landed
    __syncthreads();
    const T* vi_s = smem + buf * 2 * NS * TILE;
    tile::contract<T, SP>(acc, vi_s, ti == tj ? vi_s : vi_s + NS * TILE, TILE, min(NS, n_hi - n0));
    __syncthreads();  // before the next iteration refills this stage's buffer
    buf ^= 1;
  }
  put_tile(slot(ws, y, b, t, gridDim.z, gridDim.x), acc);
}

// Pass 2: quarter blockIdx.x % 4 of upper tile blockIdx.x / 4 of batch
// blockIdx.y: the kernel term minus the splits' partial sums, added in
// split order, plus the jitter on the diagonal; stored with its mirror when
// the tile is off the diagonal (a diagonal tile's four quarters cover both
// of its triangles).
template <typename T>
__global__ void __launch_bounds__(SF::THREADS)
ts_cov_finish(T* __restrict__ ws, const T* __restrict__ jitter, int jitter_stride, T* __restrict__ out, int m,
              int splits, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x >> 2;
  const int qi = (blockIdx.x >> 1) & 1;
  const int qj = blockIdx.x & 1;
  const int tiles = gridDim.x >> 2;
  const int batch = gridDim.y;
  const int b = blockIdx.y;
  int ti, tj;
  tile::upper_tile(t, ti, tj);
  const int i0 = ti * TILE + qi * SF::TILE;
  const int j0 = tj * TILE + qj * SF::TILE;
  const T jit = jitter[(size_t)b * jitter_stride];
  const int ty = threadIdx.x / SF::SIDE;
  const int tx = threadIdx.x % SF::SIDE;
  const int c = SF::index(tx, 0);  // the thread's 4 consecutive columns
  T vals[SF::TM][SF::TM];
#pragma unroll
  for (int i = 0; i < SF::TM; ++i) {
    const int r = SF::index(ty, i);
    const size_t off = (size_t)(qi * SF::TILE + r) * TILE + qj * SF::TILE + c;
    T sum[4];
    tile::lds4(slot(ws, 0, b, t, batch, tiles) + off, sum);
    for (int sp = 1; sp < splits; ++sp) {
      T part[4];
      tile::lds4(slot(ws, sp, b, t, batch, tiles) + off, part);
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[q] = dev_add(sum[q], part[q]);
    }
    T kt[4];
    tile::lds4(slot(ws, splits, b, t, batch, tiles) + off, kt);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T k = dev_sub(kt[q], sum[q]);
      vals[i][q] = i0 == j0 && r == c + q ? dev_add(k, jit) : k;
    }
  }
  tile::store_tile<T, SF>(out + (size_t)b * m * m, m, m, m, i0, j0, vals, ti != tj, vec != 0, stage);
}

template <typename T, int KID>
cudaError_t launch_kid(const T* zs, const T* v, const T* scale, int scale_stride, const T* jitter,
                       int jitter_stride, T* out, T* ws, int batch, int m, int n, int d, int splits,
                       int chunk, int lead, bool vec, cudaStream_t stream) {
  const long long side = (m + TILE - 1) / TILE;
  const long long tiles = side * (side + 1) / 2;
  if (4 * tiles > INT_MAX) return cudaErrorInvalidValue;
  const int kmax = d < tile::DK ? d : tile::DK;
  const int region = 2 * kmax * SF::LDZ;  // the kernel term's staging
  const size_t smem_partial = (size_t)(region > 4 * NS * TILE ? region : 4 * NS * TILE) * sizeof(T);
  cudaError_t err = tile::allow_smem<&ts_cov_partial<T, KID>>(smem_partial);
  if (err != cudaSuccess) return err;
  ts_cov_partial<T, KID><<<dim3((unsigned)tiles, (unsigned)splits, (unsigned)batch), SP::THREADS, smem_partial,
                           stream>>>(zs, v, scale, scale_stride, ws, m, n, d, chunk, lead, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ts_cov_finish<T><<<dim3((unsigned)(4 * tiles), (unsigned)batch), SF::THREADS,
                     (size_t)SF::TILE * SF::LDT * sizeof(T), stream>>>(ws, jitter, jitter_stride, out, m, splits,
                                                                      vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* zs, const void* v, const void* scale, int scale_stride,
                         const void* jitter, int jitter_stride, void* out, void* ws, int batch, int m,
                         int n, int d, int splits, int chunk, int lead, int kernel_id, cudaStream_t stream) {
  const T* z = static_cast<const T*>(zs);
  const T* vv = static_cast<const T*>(v);
  const T* s = static_cast<const T*>(scale);
  const T* jit = static_cast<const T*>(jitter);
  T* o = static_cast<T*>(out);
  T* w = static_cast<T*>(ws);
  const bool vec = sizeof(T) == 4 && m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  switch (kernel_id) {
    case RBF:
      return launch_kid<T, RBF>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d, splits,
                                chunk, lead, vec, stream);
    case MATERN12:
      return launch_kid<T, MATERN12>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d,
                                     splits, chunk, lead, vec, stream);
    case MATERN32:
      return launch_kid<T, MATERN32>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d,
                                     splits, chunk, lead, vec, stream);
    case MATERN52:
      return launch_kid<T, MATERN52>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d,
                                     splits, chunk, lead, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, otherwise the cudaError_t of the refused launch.
// Split y of `splits` takes the training rows [y * chunk - lead, (y + 1) *
// chunk - lead) clipped to [0, n), so splits * chunk >= n + lead; the
// workspace holds (splits + 1) * batch * tiles * 128 * 128 elements, tiles
// the number of upper 128-tiles of m. is_double selects the float (0) or
// double (1) instantiation.
int ts_cov_launch(const void* zs, const void* v, const void* scale, int scale_stride, const void* jitter,
                  int jitter_stride, void* out, void* workspace, int batch, int m, int n, int d,
                  int splits, int chunk, int lead, int kernel_id, int is_double, void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n < 0 || d < 0 || scale_stride < 0 || jitter_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || chunk < 0 || lead < 0 || (long long)splits * chunk < (long long)n + lead ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_double
      ? launch_typed<double>(zs, v, scale, scale_stride, jitter, jitter_stride, out, workspace, batch, m,
                             n, d, splits, chunk, lead, kernel_id, s)
      : launch_typed<float>(zs, v, scale, scale_stride, jitter, jitter_stride, out, workspace, batch, m,
                            n, d, splits, chunk, lead, kernel_id, s);
  return (int)err;
}

const char* ts_cov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
