// The double kernel tile shared by the kernel-matrix kernel and the TS
// covariance's finishing pass (sm_90a), on the fp64 CUDA cores.
//
// k(|z1_i - z2_j|^2) in double is latency-bound, not throughput-bound: sqrt
// and exp in double are chains of dependent fp64 operations with branches,
// so a thread evaluates its entries one after another. The float tile (4 x 4
// entries a thread, tile_mainloop.cuh) leaves too few threads on an SM to
// hide that: a 1000-point K(Z, Z) is ~33k threads of 16 entries. Here a
// thread owns TM x TM entries, TM = 2 (a 32 x 32 tile is 256 threads), in
// runs of TM consecutive rows and columns, read from shared memory and
// written to the output as double2. d2 is one FMA chain of squared
// differences over the whole feature axis, in the same order for every
// entry, so (a - b)^2 == (b - a)^2 keeps K(Z, Z) bitwise symmetric and a row
// paired with itself gives exactly 0.
#pragma once

#include "tile_mainloop.cuh"

namespace tile {

template <int TILE_, int TM_>
struct TileD {
  static_assert(TM_ % 2 == 0, "a thread's rows and columns come in runs of double2");
  static constexpr int TILE = TILE_;
  static constexpr int TM = TM_;
  static constexpr int SIDE = TILE / TM;
  static constexpr int THREADS = SIDE * SIDE;
  static constexpr int LDZ = TILE + 2;  // [k][row] staging: rows stay 16-byte aligned
  static constexpr int LDT = TILE + 2;  // transposed-store staging, the same
};

using KTileD = TileD<32, 2>;

// v[q] = p[q] for q < TM, 16 bytes at a time (p 16-byte aligned).
template <int TM>
__device__ __forceinline__ void ldd(const double* p, double* v) {
#pragma unroll
  for (int q = 0; q < TM; q += 2) {
    const double2 a = *reinterpret_cast<const double2*>(p + q);
    v[q] = a.x;
    v[q + 1] = a.y;
  }
}

// p[q] = w[q] for q < min(TM, valid): double2 stores when vec (p 16-byte
// aligned) and the run is whole.
template <int TM>
__device__ __forceinline__ void std_run(double* p, const double* w, int valid, bool vec) {
  if (vec && valid >= TM) {
#pragma unroll
    for (int q = 0; q < TM; q += 2) *reinterpret_cast<double2*>(p + q) = make_double2(w[q], w[q + 1]);
    return;
  }
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    if (q < valid) p[q] = w[q];
  }
}

// k[i][j] = s * k(|z1[row0 + TM ty + i] - z2[col0 + TM tx + j]|^2) (rows past
// n and columns past m padded with zeros); smem holds 2 * min(d, DK) *
// S::LDZ doubles. Ends with a __syncthreads(), after which smem may be
// reused.
template <int KID, typename S>
__device__ __forceinline__ void kernel_tile_d(double (&k)[S::TM][S::TM], double* smem,
                                              const double* __restrict__ z1, const double* __restrict__ z2,
                                              int row0, int col0, int n, int m, int d, double s) {
  constexpr int TM = S::TM;
  const int ty = threadIdx.x / S::SIDE;
  const int tx = threadIdx.x % S::SIDE;
  double* a_s = smem;
  double* b_s = smem + min(d, DK) * S::LDZ;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) k[i][j] = 0.0;
  }
  for (int k0 = 0; k0 < d; k0 += DK) {
    const int kn = min(DK, d - k0);
    stage_transposed<double, S>(a_s, S::LDZ, z1, row0, n, d, k0, kn);
    stage_transposed<double, S>(b_s, S::LDZ, z2, col0, m, d, k0, kn);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      double a[TM];
      double b[TM];
      ldd<TM>(a_s + kk * S::LDZ + TM * ty, a);
      ldd<TM>(b_s + kk * S::LDZ + TM * tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const double t = a[i] - b[j];
          k[i][j] = dev_fma(t, t, k[i][j]);
        }
      }
    }
    __syncthreads();
  }
  if (d == 0) __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) k[i][j] = kernel_fn<KID>(k[i][j], s);
  }
}

// Stores the thread's entries vals of the tile at (row0, col0) into out
// (leading dimension ld; rows below nrows and columns below ncols exist),
// double2 stores when vec. With mirror (block-uniform), also the tile's
// transpose at (col0, row0), staged through stage (TILE * LDT doubles,
// which may alias the kernel tile's operands), so that those stores run
// along output rows too.
template <typename S>
__device__ __forceinline__ void store_tile_d(double* out, size_t ld, int nrows, int ncols, int row0, int col0,
                                             const double (&vals)[S::TM][S::TM], bool mirror, bool vec,
                                             double* stage) {
  constexpr int TM = S::TM;
  const int ty = threadIdx.x / S::SIDE;
  const int tx = threadIdx.x % S::SIDE;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + TM * ty + i;
    if (row < nrows) std_run<TM>(out + row * ld + col0 + TM * tx, vals[i], ncols - (col0 + TM * tx), vec);
  }
  if (!mirror) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) stage[(TM * tx + j) * S::LDT + TM * ty + i] = vals[i][j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = TM * ty + i;  // a column of the tile: a row of its transpose
    if (col0 + r < ncols) {
      double w[TM];
      ldd<TM>(stage + r * S::LDT + TM * tx, w);
      std_run<TM>(out + (col0 + r) * ld + row0 + TM * tx, w, nrows - (row0 + TM * tx), vec);
    }
  }
}

// A copy of one double from global to shared memory that does not wait for
// the load (cp.async, zero-filled when !valid), where a 16-byte run would
// not be aligned; waited for as copy16_async's are.
__device__ __forceinline__ void copy8_async(void* dst, const void* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(saddr), "l"(src), "r"(valid ? 8 : 0));
#endif
}

}  // namespace tile
