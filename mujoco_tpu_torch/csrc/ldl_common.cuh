// In-place LDLᵀ factor-and-solve of one small dense SPD matrix by one warp,
// shared by the LDL solve kernel (ldl_solve.cu) and the Newton kernel
// (newton.cu). Same algorithm as the Pallas kernel it replaces
// (mujoco_tpu/ops/linalg_tpu.py:34 _ldl_solve_kernel): symmetric Gaussian
// elimination without square roots, forward solve, diagonal solve, back
// solve. Only the lower triangle is read and written: after the factor,
// h[i][k] (i > k) holds L[i][k] and h[k][k] holds D[k]. The back solve reads
// L from that same lower triangle, not from the upper one.
#pragma once

#include <cuda_runtime.h>

namespace mjt {

constexpr unsigned kFullMask = 0xffffffffu;

// Row stride of an n×n matrix in shared memory: odd, so that the 32 lanes
// of a warp reading h[r*ld + j] for their own rows r fall in distinct banks.
__host__ __device__ inline int ldl_ld(int n) { return n | 1; }

// h: n×n SPD matrix, row stride ld, lower triangle valid; y: right-hand
// side, overwritten with H⁻¹y. n ≤ 64: lane l owns rows l and l + 32. The
// whole warp must call this with h and y already visible to every lane
// (__syncwarp or __syncthreads before); the results are visible to the
// warp on return.
template <typename T>
__device__ void warp_ldl_solve(T* h, int ld, T* y, int n, int lane) {
  const int r0 = lane, r1 = lane + 32;
  for (int k = 0; k < n; ++k) {
    // trailing Schur update of the rows below the pivot, reading the
    // unscaled column k; column k is scaled into L only after the warp has
    // finished reading it
    const T inv = T(1) / h[k * ld + k];
    const bool own0 = r0 > k && r0 < n, own1 = r1 > k && r1 < n;
    const T l0 = own0 ? h[r0 * ld + k] * inv : T(0);
    const T l1 = own1 ? h[r1 * ld + k] * inv : T(0);
    if (own0) {
      for (int j = k + 1; j <= r0; ++j) h[r0 * ld + j] -= l0 * h[j * ld + k];
    }
    if (own1) {
      for (int j = k + 1; j <= r1; ++j) h[r1 * ld + j] -= l1 * h[j * ld + k];
    }
    __syncwarp(kFullMask);
    if (own0) h[r0 * ld + k] = l0;
    if (own1) h[r1 * ld + k] = l1;
    __syncwarp(kFullMask);
  }
  // forward solve L z = y (unit lower L)
  for (int k = 0; k < n - 1; ++k) {
    const T yk = y[k];
    for (int r = lane; r < n; r += 32) {
      if (r > k) y[r] -= h[r * ld + k] * yk;
    }
    __syncwarp(kFullMask);
  }
  // diagonal solve z ← D⁻¹ z
  for (int r = lane; r < n; r += 32) y[r] /= h[r * ld + r];
  __syncwarp(kFullMask);
  // back solve Lᵀ x = z, column-oriented: x[k] is final once rows > k are
  // done, then it is eliminated from every row above it
  for (int k = n - 1; k > 0; --k) {
    const T xk = y[k];
    for (int r = lane; r < k; r += 32) y[r] -= h[k * ld + r] * xk;
    __syncwarp(kFullMask);
  }
}

}  // namespace mjt
