// Register-tiled mainloop of the float kernel-matrix and TS-covariance
// kernels (sm_90a): fp32 FMAs on the CUDA cores, no TF32, no tensor cores.
// The double kernels have their own designs: the kernel tile of
// tile_f64.cuh (fp64 CUDA cores, 2 x 2 entries a thread) and the f64 TS
// covariance's v^T v on the FP64 tensor cores (ts_cov.cu).
//
// A block owns one TILE x TILE output tile; its SIDE x SIDE threads (SIDE =
// TILE / TM) own TM x TM outputs each: thread (ty, tx) has the rows
// index(ty, i) and the columns index(tx, j), runs of 4 consecutive indices
// 4 * SIDE apart. Operands are staged in shared memory as [k][row], so a
// thread reads each run of 4 rows or columns with one 16-byte load, and one
// k step is TM * TM FMAs for TM / 2 loads (float). Every output is summed in
// the same order whichever thread computes it, so a symmetric matrix comes
// out bitwise symmetric.
//
// A symmetric schedule launches the upper tiles ti <= tj only, enumerated
// column by column (blockIdx.x = tj (tj + 1) / 2 + ti, the order of
// LaunchPlan.tiles() in cuda_kernels.py), and stores each off-diagonal tile
// twice: directly, and transposed through shared memory, so that both
// stores run along output rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_fn.cuh"

namespace tile {

constexpr int DK = 64;  // features staged at once: the whole axis when d <= 64

template <int TILE_, int TM_>
struct Tile {
  static_assert(TM_ % 4 == 0 && TILE_ % TM_ == 0, "outputs per thread come in runs of 4");
  static constexpr int TILE = TILE_;
  static constexpr int TM = TM_;              // outputs per thread per axis
  static constexpr int SIDE = TILE / TM;      // threads per tile side
  static constexpr int THREADS = SIDE * SIDE;
  static constexpr int LDZ = TILE + 4;        // [k][row] staging: rows stay 16-byte aligned
  static constexpr int LDT = TILE + 1;        // transposed-store staging
  // Tile-local index of the i-th row (column) owned by thread coordinate t.
  __device__ static __forceinline__ int index(int t, int i) { return 4 * SIDE * (i >> 2) + 4 * t + (i & 3); }
};

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// p[q] = w[q] for q < min(4, valid): one 16-byte store when vec (float, p
// 16-byte aligned) and the run is whole.
template <typename T>
__device__ __forceinline__ void store4(T* p, const T* w, int valid, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec && valid >= 4) {
      *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < valid) p[q] = w[q];
  }
}

// acc[i][j] += sum over k < kn of a_s[k * ld + index(ty, i)] * b_s[k * ld + index(tx, j)],
// or with SQDIST the squared differences (a - b)^2 instead of the products.
template <typename T, typename S, bool SQDIST = false>
__device__ __forceinline__ void contract(T (&acc)[S::TM][S::TM], const T* a_s, const T* b_s, int ld, int kn) {
  constexpr int TM = S::TM;
  const int ty = threadIdx.x / S::SIDE;
  const int tx = threadIdx.x % S::SIDE;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    T a[TM];
    T b[TM];
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      lds4(a_s + k * ld + S::index(ty, 4 * g), a + 4 * g);
      lds4(b_s + k * ld + S::index(tx, 4 * g), b + 4 * g);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        if constexpr (SQDIST) {
          const T t = a[i] - b[j];
          acc[i][j] = dev_fma(t, t, acc[i][j]);
        } else {
          acc[i][j] = dev_fma(a[i], b[j], acc[i][j]);
        }
      }
    }
  }
}

// dst[k * ld + r] = src[(row0 + r) * d + k0 + k] for r < TILE, k < kn; zero
// for rows at or past nrows (fma(0, 0, acc) == acc, so the padding is
// inert). A tile's rows are one contiguous run of src: coalesced reads.
template <typename T, typename S>
__device__ __forceinline__ void stage_transposed(T* dst, int ld, const T* __restrict__ src, int row0,
                                                 int nrows, int d, int k0, int kn) {
  for (int e = threadIdx.x; e < S::TILE * kn; e += S::THREADS) {
    const int r = e / kn;
    const int k = e - r * kn;
    const int row = row0 + r;
    dst[k * ld + r] = row < nrows ? src[(size_t)row * d + k0 + k] : T(0);
  }
}

// d2[i][j] = |z1[row_i] - z2[col_j]|^2 for the tile at (row0, col0) of
// z1 (n, d) against z2 (m, d), summed over the features directly: FMA chains
// of squared differences, no cancellation (the plain version's expansion
// |a|^2 + |b|^2 - 2 a.b loses eps * |z|^2), a row paired with a
// bitwise-equal row gives exactly 0, and (a - b)^2 == (b - a)^2 keeps
// K(Z, Z) bitwise symmetric. Each run of BLOCK features is summed on its own
// and then added in, which keeps the f32 rounding of a long feature axis
// below the plain version's. a_s and b_s hold min(d, DK) * LDZ elements
// each. Ends with a __syncthreads(), after which they may be reused.
template <typename T, typename S, int BLOCK>
__device__ __forceinline__ void sqdist_tile(T (&d2)[S::TM][S::TM], T* a_s, T* b_s, const T* __restrict__ z1,
                                            const T* __restrict__ z2, int row0, int col0, int n, int m, int d) {
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
#pragma unroll
    for (int j = 0; j < S::TM; ++j) d2[i][j] = T(0);
  }
  for (int k0 = 0; k0 < d; k0 += DK) {
    const int kn = min(DK, d - k0);
    stage_transposed<T, S>(a_s, S::LDZ, z1, row0, n, d, k0, kn);
    stage_transposed<T, S>(b_s, S::LDZ, z2, col0, m, d, k0, kn);
    __syncthreads();
    for (int kb = 0; kb < kn; kb += BLOCK) {
      T part[S::TM][S::TM];
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
#pragma unroll
        for (int j = 0; j < S::TM; ++j) part[i][j] = T(0);
      }
      contract<T, S, true>(part, a_s + kb * S::LDZ, b_s + kb * S::LDZ, S::LDZ, min(BLOCK, kn - kb));
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
#pragma unroll
        for (int j = 0; j < S::TM; ++j) d2[i][j] += part[i][j];
      }
    }
    __syncthreads();
  }
  if (d == 0) __syncthreads();
}

// The kernel tile both kernels compute: k[i][j] = s * k(|z1_i - z2_j|^2) for
// the 64 x 64 tile at (row0, col0), 4 x 4 outputs per thread (256 threads),
// d2 summed in blocks of 16 features and the kernel function evaluated in
// double and rounded once: 0.5 ulp where the plain version's chain of float
// operations carries several, so the f32 result is nearer the f64 one than
// the plain version's. smem holds 2 * min(d, DK) * KTile::LDZ elements;
// ends with a __syncthreads().
using KTile = Tile<64, 4>;

template <typename T, int KID>
__device__ __forceinline__ void kernel_tile(T (&k)[KTile::TM][KTile::TM], T* smem, const T* __restrict__ z1,
                                            const T* __restrict__ z2, int row0, int col0, int n, int m, int d,
                                            T s) {
  constexpr int FEATURE_BLOCK = 16;
  sqdist_tile<T, KTile, FEATURE_BLOCK>(k, smem, smem + min(d, DK) * KTile::LDZ, z1, z2, row0, col0, n, m, d);
#pragma unroll
  for (int i = 0; i < KTile::TM; ++i) {
#pragma unroll
    for (int j = 0; j < KTile::TM; ++j) k[i][j] = static_cast<T>(kernel_fn<KID>(k[i][j], s));
  }
}

// Stores the thread's outputs vals of the tile at (row0, col0) into out
// (leading dimension ld; rows below nrows and columns below ncols exist),
// 4 columns per store, 16 bytes when vec. With mirror (block-uniform), also
// stores the tile's transpose at (col0, row0), staged through stage
// (TILE * LDT elements, which may alias the operand buffers: this waits on
// a __syncthreads() first), so those stores run along output rows as well.
template <typename T, typename S>
__device__ __forceinline__ void store_tile(T* out, size_t ld, int nrows, int ncols, int row0, int col0,
                                           const T (&vals)[S::TM][S::TM], bool mirror, bool vec, T* stage) {
  constexpr int TM = S::TM;
  constexpr int LDT = S::LDT;
  const int ty = threadIdx.x / S::SIDE;
  const int tx = threadIdx.x % S::SIDE;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + S::index(ty, i);
    if (row >= nrows) continue;
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const int col = col0 + S::index(tx, 4 * g);
      store4(out + row * ld + col, &vals[i][4 * g], ncols - col, vec);
    }
  }
  if (!mirror) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) stage[S::index(tx, j) * LDT + S::index(ty, i)] = vals[i][j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = S::index(ty, i);  // a column of the tile: a row of its transpose
    const int row = col0 + r;
    if (row >= ncols) continue;
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const int c = S::index(tx, 4 * g);
      T w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = stage[r * LDT + c + q];
      store4(out + row * ld + row0 + c, w, nrows - (row0 + c), vec);
    }
  }
}

// The t-th upper tile (ti <= tj) in column order: t = tj (tj + 1) / 2 + ti.
__device__ __forceinline__ void upper_tile(int t, int& ti, int& tj) {
  long long j = (long long)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > t) --j;
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  tj = (int)j;
  ti = (int)(t - j * (j + 1) / 2);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel;
// each kernel is opted in once, to the most it can ask for (227 KB).
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
  static bool opted_in = false;
  if (bytes <= 48 * 1024 || opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  opted_in = err == cudaSuccess;
  return err;
}

// A 16-byte copy from global to shared memory that does not wait for the
// load (cp.async; zero-filled when !valid), and its group fences.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src), "r"(valid ? 16 : 0));
#endif
}

__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most `pending` of this thread's committed copy groups are in flight.
template <int pending>
__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

}  // namespace tile
