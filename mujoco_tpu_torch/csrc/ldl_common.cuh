// In-place LDLᵀ factor-and-solve of one small dense SPD matrix by one warp,
// shared by the Newton kernel (newton.cu), the megastep kernel
// (megastep.cu) and, for n > 32, the LDL solve kernel (ldl_solve.cu),
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

// Any n, on a work space in shared or device memory: lane l owns rows l,
// l + 32, l + 64, ... of h. Each pivot step first updates every owned row
// below the pivot from the unscaled column k, then, once the warp has
// finished reading that column, scales it into L (the multiplier is formed
// the same way both times, so it is the same value). Every step waits on
// the work space's loads and stores in turn. __syncwarp orders the lanes'
// accesses to shared and device memory alike.
template <typename T>
__device__ void warp_ldl_solve_wide(T* h, int ld, T* y, int n, int lane) {
  for (int k = 0; k < n; ++k) {
    // trailing Schur update of the rows below the pivot, reading the
    // unscaled column k
    const T inv = T(1) / h[k * ld + k];
    for (int r = k + 1 + ((lane - k - 1) & 31); r < n; r += 32) {
      const T l = h[r * ld + k] * inv;
      for (int j = k + 1; j <= r; ++j) h[r * ld + j] -= l * h[j * ld + k];
    }
    __syncwarp(kFullMask);
    for (int r = k + 1 + ((lane - k - 1) & 31); r < n; r += 32)
      h[r * ld + k] = h[r * ld + k] * inv;
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
// wide version's, operation for operation, so both give the same bits.
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

// h: n×n SPD matrix, row stride ld, lower triangle valid, in shared or
// device memory; y: right-hand side, overwritten with H⁻¹y; any n. The
// whole warp must call this with h
// and y already visible to every lane (__syncwarp or __syncthreads before);
// the results are visible to the warp on return, and h holds the factor.
template <typename T>
__device__ void warp_ldl_solve(T* h, int ld, T* y, int n, int lane) {
  if (n <= 32) {
    warp_ldl_solve_regs(h, ld, y, n, lane);
  } else {
    warp_ldl_solve_wide(h, ld, y, n, lane);
  }
}

}  // namespace mjt
