// Batched p = H⁻¹ g for small dense SPD H (any n), float and double.
//
// Replaces the Pallas kernel _ldl_solve_kernel
// (mujoco_tpu/ops/linalg_tpu.py:34, launched by ldl_solve_lanes :80).
//
// What bounds it on an H100: neither bytes nor operations but the chain of
// each env's factor. Each env reads n² + n values and writes n, and does
// about n³/3 multiply-adds: at n = 27 and B = 3072 the bytes take 1.6 µs
// at 3.35 TB/s. One warp owns one env, so a batch of 3072 is ~23 warps on
// each SM in a single wave, and the time is those interleaved chains of
// n pivot steps plus the launch. The design cuts the instructions of a
// pivot step and keeps the loads off the chain:
//
// - n ≤ 32 (ldl_regs_kernel): lane l holds row l of the lower triangle in
//   registers, loaded straight from device memory with every load in
//   flight (the order is a template parameter: 27, the humanoid's nv,
//   exactly; 32 for every other n, the rows past n padded with the
//   identity, as warp_ldl_solve_regs pads them). A pivot step publishes
//   its column to shared memory once (one store per lane) and every lane
//   reads the entries it needs as broadcast 16-byte loads, in place of one
//   shuffle per trailing entry; the rows below the pivot are updated with
//   no select (an entry right of a lane's diagonal is never read, so it
//   may take the update). The forward solve rides along with the factor
//   (each step takes z[k] by one shuffle), and each step stores its
//   multipliers so that the back solve's loads of L are issued ahead of
//   its chain of shuffles. At f32 __launch_bounds__ holds it to 85
//   registers, so 3 blocks of 8 warps share an SM and B 3072 runs in one
//   wave.
// - n > 32 (ldl_block_kernel): one block of warps per env runs the blocked
//   LDLᵀ of ldl_common.cuh (block_ldl_solve): 32-column panels, the
//   diagonal tile by one warp in registers, the rows below by every
//   thread, the trailing tiles by every warp from register tiles. The
//   lower triangle is staged from the row-major input, 32-value row runs
//   by cp.async with every load in flight, into tiles of shared memory
//   where they fit one block (n ≤ 320 at f32, ≤ 224 at f64 on an H100);
//   above that the tiles go to a per-env slice of a device-memory work
//   space the caller allocates (mjt_ldl_work_values says how many values
//   per env), laid out tile by tile, and each panel is staged in shared
//   memory while it is factored (route b of the design: one wave of
//   envs' tiles, 132 × 360 KB = 47.5 MB at f64 n 270, about fills the
//   50 MB L2, and every access to it is a row run of a tile). There the
//   bound is operations (~n³/3 multiply-adds per env: 0.31 ms at f32 and
//   n 270, B 3072), and the time is each env's chain of panels: the
//   diagonal tile is one warp's serial chain, the rows below are one per
//   thread, and the trailing tiles one per warp (block_kernel);
//   one env per block, as many blocks per SM as the shared memory and
//   registers hold (small blocks, so that an env's barriers stall only
//   its own warps; several envs in one block were not tried). Threads per
//   block by measurement (thread_counts.py: 64, 128, 256 and 512 at every
//   order, B 3072, an H100), by panels nt = ⌈n/32⌉:
//     nt ≤ 3 (n ≤ 96)                     64 threads, f32 and f64;
//     f32, nt 4-5 (n ≤ 160)               128;  f32 above            512;
//     f64, nt 4 (n ≤ 128)                 128;  f64, nt 5-7 (n ≤ 224) 256;
//     f64 in device memory (n > 224)      128.
//
// The ragged batch edge is masked (warps past B return) instead of padded
// with identity matrices.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "ldl_common.cuh"

namespace mjt {
namespace {

constexpr int kWarpsPerBlock = 8;

// Shared values per warp of ldl_regs_kernel<T, N>: two column buffers of
// 32 (16-byte aligned, double-buffered so that one barrier a step
// suffices) and the multipliers, row r of lane r at L[r·33 + k] (odd stride:
// the back solve's 32 lanes read 32 banks); a multiple of 4 values keeps
// every warp's columns 16-byte aligned.
template <int N>
__host__ __device__ constexpr int regs_warp_values() {
  return (2 * 32 + N * 33 + 3) / 4 * 4;
}

// One env by one warp, order N (= n when kExact, else n ≤ N = 32 with the
// rows past n padded with the identity).
template <typename T, int N, bool kExact>
__device__ __forceinline__ void ldl_env(const T* __restrict__ Hg,
                                        const T* __restrict__ gg,
                                        T* __restrict__ pg, int n_rt, T* col,
                                        T* L, int lane) {
  constexpr int kV = Vec16<T>::kN;
  const int n = kExact ? N : n_rt;
  const bool row = lane < n;
  T a[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    a[j] = row ? (j <= lane ? Hg[lane * n + j] : T(0)) : T(j == lane);
  T y = row ? gg[lane] : T(0);
  T d = T(1);  // this lane's pivot
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T* c = col + (k & 1) * 32;
    c[lane] = a[k];  // column k, unscaled: h[lane][k]
    __syncwarp(kFullMask);
    const T yk = __shfl_sync(kFullMask, y, k);  // z[k], final
    // the 16 bytes holding the pivot first, then the rest of the column
    // 16 bytes at a time, each applied as it arrives
    const int k0 = k / kV * kV;
    T v[kV];
    Vec16<T>::load(v, c + k0);
    const T piv = v[k - k0];
    const T inv = rcp_rn(piv);
    const T l = lane > k ? a[k] * inv : T(0);
    if (lane < N) L[lane * 33 + k] = l;
    y -= l * yk;
#pragma unroll
    for (int u = k - k0 + 1; u < kV && k0 + u < N; ++u) a[k0 + u] -= l * v[u];
#pragma unroll
    for (int j0 = k0 + kV; j0 < N; j0 += kV) {
      Vec16<T>::load(v, c + j0);
#pragma unroll
      for (int u = 0; u < kV && j0 + u < N; ++u) a[j0 + u] -= l * v[u];
    }
    d = lane == k ? piv : d;
  }
  y = y / d;  // z ← D⁻¹ z
  __syncwarp(kFullMask);
  // back solve Lᵀ x = z, column-oriented: x[k] is final once the rows
  // below are done; lane r reads L[k][r], stored by lane k at step r
  T lk[N];
#pragma unroll
  for (int k = 1; k < N; ++k) lk[k] = lane < k ? L[k * 33 + lane] : T(0);
#pragma unroll
  for (int k = N - 1; k > 0; --k) {
    const T xk = __shfl_sync(kFullMask, y, k);
    y = lane < k ? y - lk[k] * xk : y;
  }
  if (row) pg[lane] = y;
}

template <typename T, int N, bool kExact>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, sizeof(T) == 4 ? 3 : 2)
ldl_regs_kernel(const T* __restrict__ H, const T* __restrict__ g,
                T* __restrict__ p, T* /*work*/, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long env = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (env >= B) return;  // whole warp leaves together
  T* col = reinterpret_cast<T*>(smem_raw) + warp * regs_warp_values<N>();
  ldl_env<T, N, kExact>(H + env * n * n, g + env * n, p + env * n, n, col,
                        col + 64, lane);
}

// Values of shared memory per env of ldl_block_kernel: the tiles (or, in
// device memory, the stage of one panel), aux and y.
template <typename T>
__host__ __device__ inline int block_smem_values(int n, bool global) {
  const int nt = ldl_tiles_per_side(n);
  return (global ? nt : ldl_tile_count(n)) * kTileValues + kLdlAuxValues +
         32 * nt;
}

template <int kNT, bool kGlobal, typename T>
__global__ void __launch_bounds__(kNT)
ldl_block_kernel(const T* __restrict__ H, const T* __restrict__ g,
                 T* __restrict__ p, T* work, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nt = ldl_tiles_per_side(n);
  const int tid = threadIdx.x;
  const long env = blockIdx.x;
  T* tiles = kGlobal ? work + env * ldl_tile_count(n) * kTileValues : smem;
  T* stage = smem;
  T* aux = smem + (kGlobal ? nt : ldl_tile_count(n)) * kTileValues;
  T* y = aux + kLdlAuxValues;
  const T* Hg = H + env * n * n;
  // the lower triangle, padded, tile by tile: consecutive threads take
  // consecutive columns of a tile row, so each warp reads a run of an H row
  const auto h = [&](int i, int j) { return Hg[i * n + j]; };
  for (int J = 0, t = 0; J < nt; ++J) {
    for (int I = J; I < nt; ++I, ++t) {
      T* tile = tiles + static_cast<long>(t) * kTileValues;
      for (int w = tid; w < kTileValues; w += kNT) {
        const int r = w >> 5, c = w & 31;
        const int i = 32 * I + r, j = 32 * J + c;
        T* dst = tile + tile_at<T>(r, c);
        if (!kGlobal && i < n && j < n && (I != J || c <= r)) {
          __pipeline_memcpy_async(dst, Hg + i * n + j, sizeof(T));
        } else {
          *dst = ldl_tile_value<T>(I, J, r, c, n, h);
        }
      }
    }
  }
  for (int i = tid; i < 32 * nt; i += kNT) y[i] = i < n ? g[env * n + i] : T(0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  block_ldl_solve<kNT, kGlobal>(tiles, stage, y, aux, n);
  for (int i = tid; i < n; i += kNT) p[env * n + i] = y[i];
}

// Dynamic shared memory a block may opt into on the current device.
inline size_t smem_optin() {
  int dev = 0, v = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return static_cast<size_t>(v);
}

// The kernel that solves order n, its shared bytes per block, its envs
// (warps for the register route) per block, its threads per block, its
// device-memory work values per env and its route (0 registers, 1 shared
// memory, 2 device memory).
template <typename T>
struct Plan {
  void (*kernel)(const T*, const T*, T*, T*, int, int);
  size_t smem;
  int envs;
  int threads;
  size_t work;
  int route;
};

// Threads per block of ldl_block_kernel at order n on its route (the
// table at the top), and the instantiation: only the pairs the table
// names are built.
template <typename T>
void block_kernel(Plan<T>& pl, int n) {
  const int nt = ldl_tiles_per_side(n);
  if constexpr (sizeof(T) == 4) {
    pl.threads = nt <= 3 ? 64 : (nt <= 5 ? 128 : 512);
    pl.kernel = pl.route == 2        ? ldl_block_kernel<512, true, T>
                : pl.threads == 64  ? ldl_block_kernel<64, false, T>
                : pl.threads == 128 ? ldl_block_kernel<128, false, T>
                                    : ldl_block_kernel<512, false, T>;
  } else {
    pl.threads = nt <= 3 ? 64 : (pl.route == 2 || nt <= 4 ? 128 : 256);
    pl.kernel = pl.route == 2        ? ldl_block_kernel<128, true, T>
                : pl.threads == 64  ? ldl_block_kernel<64, false, T>
                : pl.threads == 128 ? ldl_block_kernel<128, false, T>
                                    : ldl_block_kernel<256, false, T>;
  }
}

template <typename T>
Plan<T> plan(int n) {
  Plan<T> pl;
  pl.work = 0;
  if (n <= 32) {
    // as many warps as fit 48 KB, at most kWarpsPerBlock
    pl.kernel = n == 27 ? ldl_regs_kernel<T, 27, true>
                        : ldl_regs_kernel<T, 32, false>;
    const size_t per_warp =
        (n == 27 ? regs_warp_values<27>() : regs_warp_values<32>()) *
        sizeof(T);
    const int fit = static_cast<int>((48 * 1024) / per_warp);
    pl.envs = fit > kWarpsPerBlock ? kWarpsPerBlock : fit;
    pl.threads = pl.envs * 32;
    pl.smem = pl.envs * per_warp;
    pl.route = 0;
    return pl;
  }
  pl.envs = 1;
  pl.route = 1;
  pl.smem = static_cast<size_t>(block_smem_values<T>(n, false)) * sizeof(T);
  if (pl.smem > smem_optin()) {
    pl.route = 2;
    pl.smem = static_cast<size_t>(block_smem_values<T>(n, true)) * sizeof(T);
    pl.work = static_cast<size_t>(ldl_tile_count(n)) * kTileValues;
  }
  block_kernel(pl, n);
  return pl;
}

template <typename T>
cudaError_t prepare(const Plan<T>& pl) {
  if (pl.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(pl.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(pl.smem));
}

template <typename T>
int launch_ldl(const T* H, const T* g, T* p, T* work, int B, int n,
               cudaStream_t stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan<T> pl = plan<T>(n);
  if (pl.work && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + pl.envs - 1) / pl.envs;
  pl.kernel<<<blocks, pl.threads, pl.smem, stream>>>(H, g, p, work, B, n);
  return static_cast<int>(cudaGetLastError());
}

// At order n: envs per block, resident blocks per SM (from the runtime's
// occupancy calculator), threads per block and the route (0 registers, 1
// shared memory, 2 device memory); < 0 is an error code.
template <typename T>
int ldl_occupancy(int n, int* out) {
  if (n < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const Plan<T> pl = plan<T>(n);
  int blocks = 0;
  cudaError_t err = prepare(pl);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pl.kernel, pl.threads, pl.smem);
  out[0] = pl.envs;
  out[1] = blocks;
  out[2] = pl.threads;
  out[3] = pl.route;
  return err == cudaSuccess ? 0 : -static_cast<int>(err);
}

}  // namespace
}  // namespace mjt

extern "C" {

int mjt_ldl_occupancy(int n, int f64, int* out) {
  return f64 ? mjt::ldl_occupancy<double>(n, out)
             : mjt::ldl_occupancy<float>(n, out);
}

// device-memory work values per env the solve of order n needs (0: none)
long long mjt_ldl_work_values(int n, int f64) {
  return static_cast<long long>(f64 ? mjt::plan<double>(n).work
                                    : mjt::plan<float>(n).work);
}

int mjt_ldl_solve_f32(const void* H, const void* g, void* p, void* work,
                      int B, int n, void* stream) {
  return mjt::launch_ldl(static_cast<const float*>(H),
                         static_cast<const float*>(g), static_cast<float*>(p),
                         static_cast<float*>(work), B, n,
                         static_cast<cudaStream_t>(stream));
}

int mjt_ldl_solve_f64(const void* H, const void* g, void* p, void* work,
                      int B, int n, void* stream) {
  return mjt::launch_ldl(static_cast<const double*>(H),
                         static_cast<const double*>(g),
                         static_cast<double*>(p), static_cast<double*>(work),
                         B, n, static_cast<cudaStream_t>(stream));
}

const char* mjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
