// Device math shared by the kernel-matrix and TS-covariance kernels: the
// four stationary kernel functions of a squared distance, in the expression
// order of turbojax.kernels (outputscale * polynomial * exp), evaluated in
// double whatever the output type; the caller rounds the result once, 0.5
// ulp where a chain of float operations carries several.
//
// Every add and multiply is an explicitly rounded intrinsic, which the
// compiler never contracts into an FMA, so an output is rounded identically
// wherever the unrolled epilogue computes it (a contraction chosen per
// unrolled position would make K(Z, Z) differ from its transpose in the last
// bit).
#pragma once

#include <cuda_runtime.h>

enum KernelId { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

__device__ __forceinline__ float dev_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dev_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double dev_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float dev_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double dev_sub(double a, double b) { return __dsub_rn(a, b); }

template <int KID>
__device__ __forceinline__ double kernel_fn(double d2, double outputscale) {
  if (KID == RBF) {
    return __dmul_rn(outputscale, exp(__dmul_rn(-0.5, d2)));
  }
  const double r = sqrt(__dadd_rn(d2, 1e-30));
  if (KID == MATERN12) {
    return __dmul_rn(outputscale, exp(-r));
  } else if (KID == MATERN32) {
    const double sr = __dmul_rn(1.7320508075688772, r);
    return __dmul_rn(__dmul_rn(outputscale, __dadd_rn(1.0, sr)), exp(-sr));
  } else {
    const double sr = __dmul_rn(2.23606797749979, r);
    const double poly = __dadd_rn(__dadd_rn(1.0, sr), __dmul_rn(5.0 / 3.0, d2));
    return __dmul_rn(__dmul_rn(outputscale, poly), exp(-sr));
  }
}
