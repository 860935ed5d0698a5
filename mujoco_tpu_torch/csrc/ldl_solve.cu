// Batched p = H⁻¹ g for small dense SPD H (n ≤ 64), float and double.
//
// Replaces the Pallas kernel _ldl_solve_kernel
// (mujoco_tpu/ops/linalg_tpu.py:34, launched by ldl_solve_lanes :80).
//
// What bounds it on an H100: memory. Each env reads n² + n values and
// writes n; the arithmetic, about n³/3 multiply-adds, is below the card's
// operations-per-byte balance at n = 27 (≈ 9 flops per 4-byte value at f32
// against a balance near 20 for fp32 without tensor cores). The TPU kernel
// put 128 envs on the lanes of a vector register; here one warp owns one
// env, stages its H in shared memory, and reads H once (lower triangle only,
// contiguous per env, so a warp's loads coalesce) and writes p once. Lane i
// owns row i (and i + 32): in registers for n ≤ 32, in shared memory above
// (ldl_common.cuh), so the pivot steps need no block barrier. The ragged
// batch edge is masked (warps past B return) instead of padded with
// identity matrices.
#include <cuda_runtime.h>

#include "ldl_common.cuh"

namespace mjt {
namespace {

template <typename T>
__global__ void ldl_solve_kernel(const T* __restrict__ H,
                                 const T* __restrict__ g, T* __restrict__ p,
                                 int B, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long env = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (env >= B) return;  // whole warp leaves together
  T* h = smem + static_cast<long>(warp) * (n * ld + n);
  T* y = h + n * ld;
  const T* Hg = H + env * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    if (j <= i) h[i * ld + j] = Hg[e];
  }
  for (int i = lane; i < n; i += 32) y[i] = g[env * n + i];
  __syncwarp(kFullMask);
  warp_ldl_solve(h, ld, y, n, lane);
  for (int i = lane; i < n; i += 32) p[env * n + i] = y[i];
}

template <typename T>
int launch_ldl(const T* H, const T* g, T* p, int B, int n,
               cudaStream_t stream) {
  if (n < 1 || n > 64 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = ldl_ld(n);
  const size_t per_warp = static_cast<size_t>(n * ld + n) * sizeof(T);
  int warps = static_cast<int>((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const int blocks = (B + warps - 1) / warps;
  ldl_solve_kernel<T><<<blocks, warps * 32, warps * per_warp, stream>>>(
      H, g, p, B, n, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mjt

extern "C" {

int mjt_ldl_solve_f32(const void* H, const void* g, void* p, int B, int n,
                      void* stream) {
  return mjt::launch_ldl(static_cast<const float*>(H),
                         static_cast<const float*>(g), static_cast<float*>(p),
                         B, n, static_cast<cudaStream_t>(stream));
}

int mjt_ldl_solve_f64(const void* H, const void* g, void* p, int B, int n,
                      void* stream) {
  return mjt::launch_ldl(static_cast<const double*>(H),
                         static_cast<const double*>(g),
                         static_cast<double*>(p), B, n,
                         static_cast<cudaStream_t>(stream));
}

const char* mjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
