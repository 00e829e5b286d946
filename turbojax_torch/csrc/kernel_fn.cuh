// Device math shared by the kernel-matrix and TS-covariance kernels: the
// four stationary kernel functions of a squared distance, in the expression
// order of turbojax.kernels (outputscale * polynomial * exp).
#pragma once

#include <cuda_runtime.h>

enum KernelId { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int KID>
__device__ __forceinline__ T kernel_fn(T d2, T outputscale) {
  if (KID == RBF) {
    return outputscale * dev_exp(T(-0.5) * d2);
  }
  const T r = dev_sqrt(d2 + T(1e-30));
  if (KID == MATERN12) {
    return outputscale * dev_exp(-r);
  } else if (KID == MATERN32) {
    const T sr = T(1.7320508075688772) * r;
    return outputscale * (T(1) + sr) * dev_exp(-sr);
  } else {
    const T sr = T(2.23606797749979) * r;
    return outputscale * (T(1) + sr + (T(5) / T(3)) * d2) * dev_exp(-sr);
  }
}
