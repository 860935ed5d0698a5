// In-place LDLᵀ factor-and-solve of one small dense SPD matrix by one warp,
// shared by the Newton kernel (newton.cu), the megastep kernel
// (megastep.cu) and, for 32 < n ≤ 64, the LDL solve kernel (ldl_solve.cu),
// which has its own register routine for n ≤ 32. Same algorithm as the
// Pallas kernel it replaces
// (mujoco_tpu/ops/linalg_tpu.py:34 _ldl_solve_kernel): symmetric Gaussian
// elimination without square roots, forward solve, diagonal solve, back
// solve. Only the lower triangle is read and written: after the factor,
// h[i][k] (i > k) holds L[i][k] and h[k][k] holds D[k]. The back solve reads
// L from that same lower triangle, not from the upper one.
#pragma once

#include <cuda_runtime.h>

namespace mjt {

constexpr unsigned kFullMask = 0xffffffffu;

// 1/x rounded to nearest, the same bits as IEEE division 1/x in fewer
// dependent steps
__device__ inline float rcp_rn(float x) { return __frcp_rn(x); }
__device__ inline double rcp_rn(double x) { return __drcp_rn(x); }

// Row stride of an n×n matrix in shared memory: odd, so that the 32 lanes
// of a warp reading h[r*ld + j] for their own rows r fall in distinct banks.
__host__ __device__ inline int ldl_ld(int n) { return n | 1; }

// n ≤ 64 in shared memory: lane l owns rows l and l + 32 of h. Each
// pivot step reads the unscaled column k while it updates the rows below,
// so every step waits on shared-memory loads and stores in turn.
template <typename T>
__device__ void warp_ldl_solve_shared(T* h, int ld, T* y, int n, int lane) {
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

// n ≤ 32 in registers: lane l holds row l of the lower triangle in a[],
// the column entries a pivot step needs come from the other lanes by
// shuffles, and the only shared-memory traffic is the load of h, the store
// of the factor and the back solve's reads of it. The arithmetic is the
// shared version's, operation for operation, so both give the same bits.
// Rows n..31 are padded with the identity, so every loop runs to 32 with
// no branch on n: a padded row's pivot is 1 and its multipliers are 0, it
// changes no real row, and the warp issues a step's 31 − k independent
// shuffles back to back instead of one per branch. (A branch on n, even
// one per pivot step, stops the full unroll and sends a[] to local
// memory.) What remains serial is one chain per pivot: shuffle,
// reciprocal, multiplier, update.
template <typename T>
__device__ __noinline__ void warp_ldl_solve_regs(T* h, int ld, T* y, int n,
                                                 int lane) {
  const bool row = lane < n;
  T a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    a[j] = row ? (j <= lane ? h[lane * ld + j] : T(0)) : T(j == lane);
  T yv = row ? y[lane] : T(0);
  T d = T(1);  // this lane's pivot
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const T piv = __shfl_sync(kFullMask, a[k], k);
    const T inv = rcp_rn(piv);
    const bool own = lane > k;
    const T l = a[k] * inv;
#pragma unroll
    for (int j = k + 1; j < 32; ++j) {
      const T hjk = __shfl_sync(kFullMask, a[k], j);  // unscaled h[j][k]
      a[j] = own && j <= lane ? a[j] - l * hjk : a[j];
    }
    a[k] = own ? l : a[k];
    d = lane == k ? piv : d;
  }
  // the factor back into h: L below the diagonal, D on it
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (row && j < lane) h[lane * ld + j] = a[j];
  }
  if (row) h[lane * ld + lane] = d;
  // forward solve L z = y (unit lower L), then z ← D⁻¹ z
#pragma unroll
  for (int k = 0; k < 31; ++k) {
    const T yk = __shfl_sync(kFullMask, yv, k);
    yv = lane > k ? yv - a[k] * yk : yv;
  }
  yv = yv / d;
  __syncwarp(kFullMask);
  // back solve Lᵀ x = z, column-oriented, L read from h
#pragma unroll
  for (int k = 31; k > 0; --k) {
    const T xk = __shfl_sync(kFullMask, yv, k);
    const bool use = k < n && lane < k;
    const T lk = use ? h[k * ld + lane] : T(0);
    yv = use ? yv - lk * xk : yv;
  }
  if (row) y[lane] = yv;
  __syncwarp(kFullMask);
}

// h: n×n SPD matrix, row stride ld, lower triangle valid; y: right-hand
// side, overwritten with H⁻¹y; n ≤ 64. The whole warp must call this with h
// and y already visible to every lane (__syncwarp or __syncthreads before);
// the results are visible to the warp on return, and h holds the factor.
template <typename T>
__device__ void warp_ldl_solve(T* h, int ld, T* y, int n, int lane) {
  if (n <= 32) {
    warp_ldl_solve_regs(h, ld, y, n, lane);
  } else {
    warp_ldl_solve_shared(h, ld, y, n, lane);
  }
}

}  // namespace mjt
