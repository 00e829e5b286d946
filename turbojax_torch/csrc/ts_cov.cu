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
// training rows, both at full precision (no TF32: cov = K** - v^T v is a
// cancellation whose true value at deep trust-region refinement is ~1e-4 of
// its operands), then the kernel function, the subtraction and the diagonal
// jitter. The kernel term is the kernel matrix's kernel tile
// (tile_mainloop.cuh): the squared distance summed directly as
// sum_k (zs_ik - zs_jk)^2 on the CUDA cores, so the diagonal's d2 is
// exactly 0 and no cancellation enters it, and the function evaluated in
// double. The float and double instantiations are two designs.
//
// What bounds it on an H100: the 2 (n + d) flops per distinct entry (m =
// 1000, n = 2000, d = 60: 2.1 GFLOP, 31 us at 67 TFLOP/s, the fp32 rate of
// the CUDA cores and the fp64 rate of the tensor cores); the bytes (float:
// 8 MB of v, 4 MB out) take a tenth of that.
//
// float, on the register-tiled fp32 mainloop of tile_mainloop.cuh (fp32
// FMAs; v^T v is summed in partial sums of at most 384 training rows, which
// keeps the f32 error below that of cuBLAS's SGEMM):
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
// No block holds two 8 x 8 arrays at once (the kernel term is computed
// before the partial sum starts).
//
// double, v^T v on the FP64 tensor cores (DMMA: mma.sync m16n8k4 .f64, the
// IEEE fp64 FMA at twice the rate of the fp64 CUDA cores; cuBLAS's DGEMM
// runs on them too), the kernel term on the fp64 CUDA cores:
// - pass 1 (ts_cov_gram_f64) computes v^T v on the upper 96 x 96 tiles (a
//   1000-candidate chunk: 66), four warps of 48 x 48 (3 x 6 DMMA tiles, 72
//   accumulators a thread), v's rows staged 16 at a time with cp.async
//   (16-byte copies of two doubles where m is even, else 8-byte ones) into
//   three stages, two in flight while one is contracted: 77 KB of shared
//   memory and <= 255 registers a thread, two blocks an SM. A tile's
//   training rows are cut into an even number of splits (the plan's: four
//   for a chunk, 264 blocks, one wave), a block each; the blocks of splits
//   2p and 2p + 1 form a cluster, put their sums in shared memory and add
//   them over the cluster (distributed shared memory), so one partial tile
//   per pair reaches the workspace. The 96-tile moves 27% fewer bytes from
//   L2 than a 64-tile, which pass 1 is bound by once its DMMAs run near the
//   peak rate; a cluster of four (one partial per tile) would not fit the
//   66 clusters in one wave;
// - pass 2 (ts_cov_finish_f64) takes 32 x 32 sub-tiles of the upper
//   triangle (a chunk: 528, four per SM), computes the kernel term there
//   (tile_f64.cuh's kernel tile, the double kernel matrix's own), subtracts
//   the tile's partial sums, added in pair order, adds the jitter and stores
//   with double2 stores: an off-diagonal sub-tile with its mirror, a
//   diagonal one from its upper triangle only (each lower entry is its
//   mirror's value), so the output is symmetric by construction, whatever
//   order the DMMA fragments sum in.
// No atomics: the output is bitwise reproducible from run to run. Ragged m,
// n and d are masked; blockIdx.z (float pass 1) and blockIdx.y (pass 2) are
// the batch index.
//
// Entry points: ts_cov_launch (float) and ts_cov_f64_launch (double), plain
// C, loaded with ctypes. They launch on the given stream, do not
// synchronise, allocate nothing (the caller passes the workspace) and
// return cudaGetLastError().

#include <climits>

#include <cooperative_groups.h>

#include "tile_f64.cuh"

namespace {

// ---- float: the register-tiled fp32 design (instantiated with T = float only) ----

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
__global__ void __launch_bounds__(SP::THREADS, 2)
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


// ---- double: v^T v on the FP64 tensor cores ----

constexpr int GT = 96;                 // gram tile of pass 1
constexpr int GWM = 2, GWN = 2;        // warps along its rows and columns
constexpr int GMI = GT / GWM / 16;     // DMMA tiles per warp: GMI rows of 16 ...
constexpr int GNJ = GT / GWN / 8;      // ... by GNJ columns of 8
constexpr int GNS = 16;                // training rows per step
constexpr int GSTAGES = 3;             // staged steps: two in flight while one is contracted
constexpr int GLD = GT + 4;            // doubles a staged row: 16-byte rows, conflict-free fragment loads
constexpr int GTHREADS = 32 * GWM * GWN;
constexpr int GRESIDENT = 2;           // blocks an SM holds: 77 KB of stages and <= 255 registers a thread each
constexpr int GSTAGE = 2 * GNS * GLD;  // one stage: the rows of tile i, then those of tile j
constexpr int GPAIR = 2;               // the blocks of a cluster, whose sums meet in shared memory
constexpr int RLD = GT + 2;            // a block's sum in its shared memory, [GT][RLD]
using SD = tile::KTileD;               // pass 2: 32 x 32 sub-tiles, 2 x 2 outputs a thread
constexpr int GSUB = GT / SD::TILE;    // sub-tiles per gram tile side
static_assert(GNS % 4 == 0 && GT % (16 * GWM) == 0 && GT % (8 * GWN) == 0 && GT % SD::TILE == 0 && GLD % 16 == 4,
              "gram tile shape");
static_assert(GT * RLD <= GSTAGES * GSTAGE && GT % GPAIR == 0, "the sum fits in the stages");

// D (16 x 8) += A (16 x 4, row-major) * B (4 x 8, col-major) in fp64 on the
// tensor cores. Lane (g, t) = (lane / 4, lane % 4) holds A's (g, t) and
// (g + 8, t), B's (t, g), and D's (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). (The m16n8k8 and m16n8k16 shapes ran no faster here.)
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b0) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
#endif
}

// dst[r * GLD + c] = v[(n0 + r) * m + c0 + c] for r < GNS, c < GT, zero past
// n or m, as cp.async copies (16 bytes when vec: m even and v 16-byte
// aligned, so a pair of columns is all inside or all past m).
__device__ __forceinline__ void stage_rows(double* dst, const double* __restrict__ v, int n0, int n, int m, int c0,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < GNS * (GT / 2); e += GTHREADS) {
      const int r = e / (GT / 2);
      const int c = 2 * (e - r * (GT / 2));
      const bool inside = n0 + r < n && c0 + c < m;
      tile::copy16_async(dst + r * GLD + c, inside ? v + (size_t)(n0 + r) * m + c0 + c : v, inside);
    }
  } else {
    for (int e = threadIdx.x; e < GNS * GT; e += GTHREADS) {
      const int r = e / GT;
      const int c = e - r * GT;
      const bool inside = n0 + r < n && c0 + c < m;
      tile::copy8_async(dst + r * GLD + c, inside ? v + (size_t)(n0 + r) * m + c0 + c : v, inside);
    }
  }
}

// Pass 1: block (bt, split) = (blockIdx.x / splits, blockIdx.x % splits)
// sums v^T v of upper GT-tile t = bt % tiles of batch entry bt / tiles over
// the steps [split ku / splits, (split + 1) ku / splits) of 16 training
// rows. The blocks of splits 2p and 2p + 1 form a cluster: each puts its sum
// in its shared memory, and after the cluster's barrier each adds the two
// (rank order) over half of the tile's rows and writes them to workspace
// slot bt * splits / 2 + p, a row-major GT x GT block.
__global__ void __cluster_dims__(GPAIR, 1, 1) __launch_bounds__(GTHREADS, GRESIDENT)
ts_cov_gram_f64(const double* __restrict__ v, double* __restrict__ ws, int m, int n, int tiles, int splits, int vec) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int bt = blockIdx.x / splits;
  const int split = blockIdx.x - bt * splits;
  const int b = bt / tiles;
  int ti, tj;
  tile::upper_tile(bt - b * tiles, ti, tj);
  const bool diag = ti == tj;
  v += (size_t)b * n * m;
  const int ku = (n + GNS - 1) / GNS;
  const int s_lo = (int)((long long)split * ku / splits);
  const int s_hi = (int)((long long)(split + 1) * ku / splits);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_w = (warp / GWN) * (GT / GWM);  // the warp's part of the tile
  const int col_w = (warp % GWN) * (GT / GWN);
  auto stage = [&](int buf, int step) {
    double* dst = smem + buf * GSTAGE;
    stage_rows(dst, v, step * GNS, n, m, ti * GT, vec != 0);
    if (!diag) stage_rows(dst + GNS * GLD, v, step * GNS, n, m, tj * GT, vec != 0);
  };

  double acc[GMI][GNJ][4];
#pragma unroll
  for (int i = 0; i < GMI; ++i) {
#pragma unroll
    for (int j = 0; j < GNJ; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
    }
  }
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s_lo + s < s_hi) stage(s, s_lo + s);
    tile::async_commit();
  }
  int buf = 0;
  for (int step = s_lo; step < s_hi; ++step) {
    tile::async_wait<GSTAGES - 2>();  // this step's copies have landed
    __syncthreads();                  // ... for every thread; and the buffer refilled next is free
    if (step + GSTAGES - 1 < s_hi) stage((buf + GSTAGES - 1) % GSTAGES, step + GSTAGES - 1);
    tile::async_commit();
    const double* a_s = smem + buf * GSTAGE;
    const double* b_s = diag ? a_s : a_s + GNS * GLD;
#pragma unroll
    for (int k = 0; k < GNS; k += 4) {
      double a[GMI][2];
      double bf[GNJ];
#pragma unroll
      for (int i = 0; i < GMI; ++i) {
        a[i][0] = a_s[(k + t) * GLD + row_w + 16 * i + g];
        a[i][1] = a_s[(k + t) * GLD + row_w + 16 * i + g + 8];
      }
#pragma unroll
      for (int j = 0; j < GNJ; ++j) bf[j] = b_s[(k + t) * GLD + col_w + 8 * j + g];
#pragma unroll
      for (int i = 0; i < GMI; ++i) {
#pragma unroll
        for (int j = 0; j < GNJ; ++j) dmma(acc[i][j], a[i][0], a[i][1], bf[j]);
      }
    }
    buf = (buf + 1) % GSTAGES;
  }
  tile::async_wait<0>();
  __syncthreads();  // every copy landed and every contraction is done: the stages take the sum

  double* red = smem;
#pragma unroll
  for (int i = 0; i < GMI; ++i) {
#pragma unroll
    for (int j = 0; j < GNJ; ++j) {
      const int r = row_w + 16 * i + g;
      const int c = col_w + 8 * j + 2 * t;
      *reinterpret_cast<double2*>(red + r * RLD + c) = make_double2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<double2*>(red + (r + 8) * RLD + c) = make_double2(acc[i][j][2], acc[i][j][3]);
    }
  }
  cluster.sync();  // both sums in place
  const int rank = (int)cluster.block_rank();
  const double* red0 = cluster.map_shared_rank(red, 0);
  const double* red1 = cluster.map_shared_rank(red, 1);
  double* slot = ws + ((size_t)bt * (splits / GPAIR) + split / GPAIR) * (GT * GT);
  for (int e = threadIdx.x; e < (GT / GPAIR) * (GT / 2); e += GTHREADS) {
    const int r = rank * (GT / GPAIR) + e / (GT / 2);
    const int c = 2 * (e % (GT / 2));
    const double2 x = *reinterpret_cast<const double2*>(red0 + r * RLD + c);
    const double2 y = *reinterpret_cast<const double2*>(red1 + r * RLD + c);
    *reinterpret_cast<double2*>(slot + r * GT + c) = make_double2(dev_add(x.x, y.x), dev_add(x.y, y.y));
  }
  cluster.sync();  // no block leaves while the other may still read its sum
}

// Pass 2: upper 32 x 32 sub-tile blockIdx.x (tile::upper_tile order) of batch
// blockIdx.y: s * k(zs_i, zs_j) (tile_f64.cuh's kernel tile) minus the
// partial sums of its gram tile, added in pair order, plus the jitter on
// the diagonal. An off-diagonal sub-tile is stored with its mirror; a
// diagonal one from its upper triangle (entry (r, c) with r > c takes
// (c, r)'s value), so the output is bitwise symmetric by construction.
template <int KID>
__global__ void __launch_bounds__(SD::THREADS)
ts_cov_finish_f64(const double* __restrict__ zs, const double* __restrict__ scale, int scale_stride,
                  const double* __restrict__ jitter, int jitter_stride, const double* __restrict__ ws,
                  double* __restrict__ out, int m, int d, int tiles, int parts, int vec) {
  constexpr int TM = SD::TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const int b = blockIdx.y;
  int si, sj;
  tile::upper_tile(blockIdx.x, si, sj);
  const int i0 = si * SD::TILE;
  const int j0 = sj * SD::TILE;
  const bool diag = si == sj;
  const int ty = threadIdx.x / SD::SIDE;
  const int tx = threadIdx.x % SD::SIDE;
  const int r0 = TM * ty;  // the thread's rows r0 + i and columns c0 + q of the sub-tile
  const int c0 = TM * tx;

  double vals[TM][TM];
  const double* zb = zs + (size_t)b * m * d;
  tile::kernel_tile_d<KID, SD>(vals, smem, zb, zb, i0, j0, m, m, d, scale[(size_t)b * scale_stride]);
  double sum[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int q = 0; q < TM; ++q) sum[i][q] = 0.0;
  }
  {
    const int gi = si / GSUB;
    const int gj = sj / GSUB;
    const long long bt = (long long)b * tiles + gj * (gj + 1) / 2 + gi;
    const int off = (si - gi * GSUB) * SD::TILE * GT + (sj - gj * GSUB) * SD::TILE;  // the sub-tile in its gram tile
    for (int p = 0; p < parts; ++p) {
      const double* part = ws + ((size_t)bt * parts + p) * (GT * GT) + off;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        double x[TM];
        tile::ldd<TM>(part + (r0 + i) * GT + c0, x);
#pragma unroll
        for (int q = 0; q < TM; ++q) sum[i][q] = dev_add(sum[i][q], x[q]);
      }
    }
  }
  const double jit = jitter[(size_t)b * jitter_stride];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const double k = dev_sub(vals[i][q], sum[i][q]);
      vals[i][q] = diag && r0 + i == c0 + q ? dev_add(k, jit) : k;
    }
  }
  if (!diag) {
    tile::store_tile_d<SD>(out + (size_t)b * m * m, m, m, m, i0, j0, vals, true, vec != 0, smem);
    return;
  }
  // a diagonal sub-tile: its transpose staged (kernel_tile_d ended with a
  // __syncthreads(), so its operands are free), each lower entry from it
  double* stage = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int q = 0; q < TM; ++q) stage[(c0 + q) * SD::LDT + r0 + i] = vals[i][q];
  }
  __syncthreads();
  double* ob = out + (size_t)b * m * m;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + i;
    if (i0 + r < m) {
      double w4[TM];
#pragma unroll
      for (int q = 0; q < TM; ++q) w4[q] = r > c0 + q ? stage[r * SD::LDT + c0 + q] : vals[i][q];
      tile::std_run<TM>(ob + (size_t)(i0 + r) * m + i0 + c0, w4, m - (i0 + c0), vec != 0);
    }
  }
}

template <int KID>
cudaError_t launch_f64_kid(const double* zs, const double* v, const double* scale, int scale_stride,
                           const double* jitter, int jitter_stride, double* out, double* ws, int batch, int m, int n,
                           int d, int splits, cudaStream_t stream) {
  const long long side = (m + GT - 1) / GT;
  const long long tiles = side * (side + 1) / 2;
  const long long sub_side = (m + SD::TILE - 1) / SD::TILE;
  const long long sub_tiles = sub_side * (sub_side + 1) / 2;
  if (sub_tiles > INT_MAX || batch * tiles * splits > INT_MAX || splits < GPAIR || splits % GPAIR) return cudaErrorInvalidValue;
  const bool vec = m % 2 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem_gram = (size_t)GSTAGES * GSTAGE * sizeof(double);
  cudaError_t err = tile::allow_smem<&ts_cov_gram_f64>(smem_gram);
  if (err != cudaSuccess) return err;
  ts_cov_gram_f64<<<(unsigned)(batch * tiles * splits), GTHREADS, smem_gram, stream>>>(v, ws, m, n, (int)tiles, splits,
                                                                                     vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kmax = d < tile::DK ? d : tile::DK;
  const int region = 2 * kmax * SD::LDZ;  // the kernel term's staging, then the transposed store's
  const size_t smem_finish = (size_t)(region > SD::TILE * SD::LDT ? region : SD::TILE * SD::LDT) * sizeof(double);
  err = tile::allow_smem<&ts_cov_finish_f64<KID>>(smem_finish);
  if (err != cudaSuccess) return err;
  ts_cov_finish_f64<KID><<<dim3((unsigned)sub_tiles, (unsigned)batch), SD::THREADS, smem_finish, stream>>>(
      zs, scale, scale_stride, jitter, jitter_stride, ws, out, m, d, (int)tiles, splits / GPAIR, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, otherwise the cudaError_t of the refused launch.
// float: split y of `splits` takes the training rows [y * chunk - lead,
// (y + 1) * chunk - lead) clipped to [0, n), so splits * chunk >= n + lead;
// the workspace holds (splits + 1) * batch * tiles * 128 * 128 floats, tiles
// the number of upper 128-tiles of m.
int ts_cov_launch(const void* zs, const void* v, const void* scale, int scale_stride, const void* jitter,
                  int jitter_stride, void* out, void* workspace, int batch, int m, int n, int d,
                  int splits, int chunk, int lead, int kernel_id, void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n < 0 || d < 0 || scale_stride < 0 || jitter_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || chunk < 0 || lead < 0 || (long long)splits * chunk < (long long)n + lead ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_typed<float>(zs, v, scale, scale_stride, jitter, jitter_stride, out, workspace, batch, m, n, d,
                                  splits, chunk, lead, kernel_id, static_cast<cudaStream_t>(stream));
}

// double: each upper 96-tile's training rows in `splits` (even) slices, one
// block each, summed in clusters of two; the workspace holds
// batch * tiles * splits / 2 * 96 * 96 doubles, tiles the number of upper
// 96-tiles of m.
int ts_cov_f64_launch(const void* zs, const void* v, const void* scale, int scale_stride, const void* jitter,
                      int jitter_stride, void* out, void* workspace, int batch, int m, int n, int d, int splits,
                      int kernel_id, void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n < 0 || d < 0 || scale_stride < 0 || jitter_stride < 0 ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const double* z = static_cast<const double*>(zs);
  const double* vv = static_cast<const double*>(v);
  const double* s = static_cast<const double*>(scale);
  const double* jit = static_cast<const double*>(jitter);
  double* o = static_cast<double*>(out);
  double* w = static_cast<double*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kernel_id) {
    case RBF:
      return (int)launch_f64_kid<RBF>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d, splits, st);
    case MATERN12:
      return (int)launch_f64_kid<MATERN12>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d, splits,
                                           st);
    case MATERN32:
      return (int)launch_f64_kid<MATERN32>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d, splits,
                                           st);
    case MATERN52:
      return (int)launch_f64_kid<MATERN52>(z, vv, s, scale_stride, jit, jitter_stride, o, w, batch, m, n, d, splits,
                                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ts_cov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
