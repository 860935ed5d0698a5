// In-place LDLᵀ factor-and-solve of one small dense SPD matrix, shared by
// the Newton kernel (newton.cu), the megastep kernel (megastep.cu) and the
// LDL solve kernel (ldl_solve.cu), which has its own register routine for
// n ≤ 32. Same algorithm as the Pallas kernel it replaces
// (mujoco_tpu/ops/linalg_tpu.py:34 _ldl_solve_kernel): symmetric Gaussian
// elimination without square roots, forward solve, diagonal solve, back
// solve. Only the lower triangle is read and written: after the factor,
// h[i][k] (i > k) holds L[i][k] and h[k][k] holds D[k]. The back solve reads
// L from that same lower triangle, not from the upper one.
//
// Two shapes of the routine:
// - by one warp (warp_ldl_solve): the matrix row-major with row stride ld,
//   rows in registers for n ≤ 32 and lane l owning rows l, l + 32, ...
//   above; the megastep and the Newton kernel at nv ≤ 32 use it;
// - by one block of warps (block_ldl_solve, n > 32): the matrix as 32×32
//   tiles and a right-looking blocked LDLᵀ over panels of 32 columns; the
//   LDL kernel and the Newton kernel above nv 32 use it.
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

// ---- blocked LDLᵀ by one block of kNT threads, n > 32 -------------------
//
// The lower triangle of H, padded to N = 32·nt rows (nt = ⌈n/32⌉), lives as
// nt(nt + 1)/2 tiles of 32×32 values, panel by panel: panel J is the tiles
// (J, J), (J + 1, J), ..., (nt − 1, J), one after another, so a panel is one
// contiguous run. A tile is row-major with its 16-byte chunks XOR-swizzled
// by the row (tile_at), so that a warp reading a row (lane = column), a
// column of rows (lane = row, whole rows by 16-byte loads) or the trailing
// update's operands touches distinct banks, and a row stays one contiguous
// 128 (f32) or 256 (f64) bytes in device memory. Rows and columns past n
// hold the identity; the part of a diagonal tile above its diagonal holds
// anything finite (the loaders write 0) and is never read.
//
// Panel k:
// 1. warp 0 factors the diagonal tile (k, k) in registers with the
//    arithmetic of warp_ldl_solve_regs, forward-solves its 32 entries of y
//    and divides them by D (the diagonal solve), and leaves D, 1/D and the
//    undivided z in aux;
// 2. every thread takes one row below the diagonal tile: L21 = A21·L11⁻ᵀ·
//    D1⁻¹ (the unscaled row first, then times 1/D), and subtracts the row's
//    L·z from y (the forward solve);
// 3. every warp takes one trailing tile (I, J), k < J ≤ I, at a time:
//    A_IJ −= (L_Ik·D)·L_Jkᵀ, each lane a 4×8 register tile, the operands
//    read from the panel 16 bytes at a time.
// That is 3 block barriers per panel where the warp routine takes n warp
// steps with serial lanes. The back solve is blocked the same way: warp 0
// solves the diagonal tile, then every thread subtracts one column's
// L_KJᵀ·x_K from y_J for J < K.
//
// Where the tiles live (kGlobal): in shared memory, or in device memory,
// where each panel is first staged in shared memory (stage: nt tiles) by
// 16-byte copies and written back once factored; the trailing tiles are
// read and written in place, each warp access one row run of a tile (a
// 4-lane quarter row per row, its other half by the next instruction), so
// no access walks a column of device memory.

constexpr int kTileValues = 1024;          // 32 × 32
constexpr int kLdlAuxValues = 96;          // D, 1/D and z of one panel

__host__ __device__ inline int ldl_tiles_per_side(int n) {
  return (n + 31) / 32;
}

__host__ __device__ inline int ldl_tile_count(int n) {
  const int nt = ldl_tiles_per_side(n);
  return nt * (nt + 1) / 2;
}

// index of tile (J, J), the first tile of panel J
__host__ __device__ inline int ldl_panel_start(int nt, int J) {
  return J * nt - J * (J - 1) / 2;
}

// position of element (r, c) in its tile
template <typename T>
__host__ __device__ inline int tile_at(int r, int c) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  return r * 32 + (((c / kV) ^ (r & 7)) * kV) + c % kV;
}

// Value (r, c) of tile (I, J) of the padded matrix whose entry (i, j),
// i, j < n, i ≥ j, is h(i, j): the identity past n, 0 above the diagonal of
// a diagonal tile.
template <typename T, class Fn>
__device__ inline T ldl_tile_value(int I, int J, int r, int c, int n,
                                   Fn h) {
  const int i = 32 * I + r, j = 32 * J + c;
  if (i >= n || j >= n) return T(i == j);
  if (I == J && c > r) return T(0);
  return h(i, j);
}

// 16 bytes of shared (or device) memory as values
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(float* v, const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <>
struct Vec16<double> {
  static constexpr int kN = 2;
  __device__ static void load(double* v, const double* p) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
};

// row r of a tile into a[32] (16-byte loads)
template <typename T>
__device__ inline void tile_row_load(const T* tile, int r, T* a) {
  constexpr int kV = Vec16<T>::kN;
#pragma unroll
  for (int c = 0; c < 32; c += kV)
    Vec16<T>::load(a + c, tile + tile_at<T>(r, c));
}

template <typename T>
__device__ inline void tile_row_store(T* tile, int r, const T* a) {
#pragma unroll
  for (int c = 0; c < 32; ++c) tile[tile_at<T>(r, c)] = a[c];
}

// Step 1 of panel k by warp 0: factor the diagonal tile in place (L below
// the diagonal, D on it, 0 above), forward-solve yk (its 32 entries of y)
// and leave z/D there; aux gets D, 1/D and z.
template <typename T>
__device__ inline void warp_factor_tile(T* tile, T* yk, T* aux, int lane) {
  T a[32];
  tile_row_load(tile, lane, a);
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = j <= lane ? a[j] : T(0);
  T yv = yk[lane];
  T d = T(1);
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
#pragma unroll
  for (int k = 0; k < 31; ++k) {
    const T yq = __shfl_sync(kFullMask, yv, k);
    yv = lane > k ? yv - a[k] * yq : yv;
  }
  tile_row_store(tile, lane, a);  // a[lane] is the pivot, D
  aux[lane] = d;
  aux[32 + lane] = rcp_rn(d);
  aux[64 + lane] = yv;
  yk[lane] = yv / d;
}

// Step 2 for one row below the diagonal tile: row r of a panel tile,
// unscaled row u = a·L11⁻ᵀ (column by column), then L = u·(1/D); returns
// the row's L·z.
template <typename T>
__device__ inline T panel_row(const T* diag, T* tile, int r, const T* aux) {
  T a[32];
  tile_row_load(tile, r, a);
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const T uq = a[q];
#pragma unroll
    for (int p = q + 1; p < 32; ++p) a[p] -= uq * diag[tile_at<T>(p, q)];
    a[q] = uq * aux[32 + q];
    acc += a[q] * aux[64 + q];
  }
  tile_row_store(tile, r, a);
  return acc;
}

// Step 3 for one trailing tile by one warp: C −= (Li·D)·Ljᵀ. Lane (ry, cx)
// = (lane / 4, lane % 4) owns rows ry + 8q (q < 4) and columns cx + 4u
// (u < 8); per 16-byte chunk of the panel columns it loads 4 chunks of Li
// and 8 of Lj, 8 distinct rows (or 4) in distinct banks.
template <typename T>
__device__ inline void trailing_tile(T* C, const T* Li, const T* Lj,
                                     const T* d, int lane) {
  constexpr int kV = Vec16<T>::kN;
  const int ry = lane >> 2, cx = lane & 3;
  T acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[q][u] = T(0);
#pragma unroll 2
  for (int p0 = 0; p0 < 32; p0 += kV) {
    T dv[kV], li[4][kV], lj[8][kV];
    Vec16<T>::load(dv, d + p0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      Vec16<T>::load(li[q], Li + tile_at<T>(ry + 8 * q, p0));
#pragma unroll
    for (int u = 0; u < 8; ++u)
      Vec16<T>::load(lj[u], Lj + tile_at<T>(cx + 4 * u, p0));
#pragma unroll
    for (int v = 0; v < kV; ++v) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T w = li[q][v] * dv[v];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[q][u] += w * lj[u][v];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      T* c = C + tile_at<T>(ry + 8 * q, cx + 4 * u);
      *c = *c - acc[q][u];
    }
}

// 16-byte copy of `values` values (a multiple of 32) by the block
template <int kNT, typename T>
__device__ inline void block_copy(T* dst, const T* src, int values) {
  constexpr int kV = Vec16<T>::kN;
  for (int e = threadIdx.x * kV; e < values; e += kNT * kV)
    *reinterpret_cast<float4*>(dst + e) =
        *reinterpret_cast<const float4*>(src + e);
}

// tiles: the padded lower triangle as above, in shared memory or (kGlobal)
// device memory; stage: kGlobal only, nt tiles of shared memory; y: N = 32·nt
// values of shared memory, 0 past n, overwritten with H⁻¹y; aux:
// kLdlAuxValues of shared memory, 16-byte aligned. Every thread of the
// block calls it with tiles and y visible to all; on return y is visible to
// all and the tiles hold the factor.
template <int kNT, bool kGlobal, typename T>
__device__ void block_ldl_solve(T* tiles, T* stage, T* y, T* aux, int n) {
  constexpr int kW = kNT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = ldl_tiles_per_side(n);
  for (int k = 0; k < nt; ++k) {
    const int m = nt - k;  // tiles in panel k
    T* home = tiles + static_cast<long>(ldl_panel_start(nt, k)) * kTileValues;
    T* P = kGlobal ? stage : home;
    if constexpr (kGlobal) {
      block_copy<kNT>(P, home, m * kTileValues);
      __syncthreads();
    }
    if (warp == 0) warp_factor_tile(P, y + 32 * k, aux, lane);
    __syncthreads();
    for (int row = tid; row < (m - 1) * 32; row += kNT) {
      const T lz = panel_row(P, P + kTileValues + (row >> 5) * kTileValues,
                             row & 31, aux);
      y[32 * (k + 1) + row] -= lz;
    }
    __syncthreads();
    if constexpr (kGlobal) block_copy<kNT>(home, P, m * kTileValues);
    // trailing tiles (k + i, k + j), 1 ≤ j ≤ i < m, row by row, so that the
    // next diagonal tile comes first
    const int ntrail = m * (m - 1) / 2;
    for (int t = warp; t < ntrail; t += kW) {
      int i = 1, base = 0;
      while (base + i <= t) {
        base += i;
        ++i;
      }
      const int j = 1 + t - base;
      T* C = tiles + static_cast<long>(ldl_panel_start(nt, k + j) + i - j) *
                         kTileValues;
      trailing_tile(C, P + i * kTileValues, P + j * kTileValues, aux, lane);
    }
    __syncthreads();
  }
  // back solve Lᵀx = z/D: warp 0 solves tile (K, K), then every thread
  // subtracts one column of L_KJᵀ·x_K from y_J, J < K
  for (int K = nt - 1; K >= 0; --K) {
    const T* D = tiles + static_cast<long>(ldl_panel_start(nt, K)) *
                             kTileValues;
    if (warp == 0) {
      T v = y[32 * K + lane];
#pragma unroll
      for (int q = 31; q > 0; --q) {
        const T xq = __shfl_sync(kFullMask, v, q);
        const T lq = lane < q ? D[tile_at<T>(q, lane)] : T(0);
        v = lane < q ? v - lq * xq : v;
      }
      y[32 * K + lane] = v;
    }
    __syncthreads();
    if (K == 0) break;
    for (int o = tid; o < 32 * K; o += kNT) {
      const int J = o >> 5, p = o & 31;
      const T* L = tiles + static_cast<long>(ldl_panel_start(nt, J) + K - J) *
                               kTileValues;
      T acc = T(0);
#pragma unroll 8
      for (int r = 0; r < 32; ++r) acc += L[tile_at<T>(r, p)] * y[32 * K + r];
      y[o] -= acc;
    }
    __syncthreads();
  }
}

}  // namespace mjt
