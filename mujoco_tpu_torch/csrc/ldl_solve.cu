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
// - n > 32 (ldl_shared_kernel): H staged in shared memory and factored
//   there by warp_ldl_solve_wide (ldl_common.cuh), lane l owning rows l,
//   l + 32, l + 64, ...; one warp's n·(n|1) + n values must fit what a
//   block may opt into (n ≤ 169 at f64, ≤ 240 at f32 on an H100).
// - above that (ldl_global_kernel): the same routine on a per-env slice of
//   a device-memory work space the caller allocates (mjt_ldl_work_values
//   says how many values per env), the solution built in place in p.
//
// The ragged batch edge is masked (warps past B return) instead of padded
// with identity matrices.
#include <cuda_runtime.h>

#include "ldl_common.cuh"

namespace mjt {
namespace {

constexpr int kWarpsPerBlock = 8;

// 16 bytes of shared memory as values
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

template <typename T>
__global__ void ldl_shared_kernel(const T* __restrict__ H,
                                  const T* __restrict__ g, T* __restrict__ p,
                                  T* /*work*/, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ld = ldl_ld(n);
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

// H's lower triangle copied to the env's n × n slice of work, g to p, and
// the solve done there in place
template <typename T>
__global__ void ldl_global_kernel(const T* __restrict__ H,
                                  const T* __restrict__ g, T* p, T* work,
                                  int B, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long env = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (env >= B) return;  // whole warp leaves together
  T* h = work + env * n * n;
  T* y = p + env * n;
  const T* Hg = H + env * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    if (j <= i) h[e] = Hg[e];
  }
  for (int i = lane; i < n; i += 32) y[i] = g[env * n + i];
  __syncwarp(kFullMask);
  warp_ldl_solve_wide(h, n, y, n, lane);
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

// The kernel that solves order n, its shared bytes per warp, its warps per
// block (as many as fit 48 KB, at most kWarpsPerBlock; one warp alone may
// opt into more) and its device-memory work values per env.
template <typename T>
struct Plan {
  void (*kernel)(const T*, const T*, T*, T*, int, int);
  size_t per_warp;
  int warps;
  size_t work;
};

template <typename T>
Plan<T> plan(int n) {
  Plan<T> pl;
  pl.work = 0;
  if (n <= 32) {
    pl.kernel = n == 27 ? ldl_regs_kernel<T, 27, true>
                        : ldl_regs_kernel<T, 32, false>;
    pl.per_warp = (n == 27 ? regs_warp_values<27>() : regs_warp_values<32>())
                  * sizeof(T);
  } else {
    pl.per_warp = static_cast<size_t>(n * ldl_ld(n) + n) * sizeof(T);
    pl.kernel = ldl_shared_kernel<T>;
    if (pl.per_warp > smem_optin()) {
      pl.kernel = ldl_global_kernel<T>;
      pl.per_warp = 0;
      pl.work = static_cast<size_t>(n) * n;
    }
  }
  const int fit = pl.per_warp ? static_cast<int>((48 * 1024) / pl.per_warp)
                              : kWarpsPerBlock;
  pl.warps = fit < 1 ? 1 : (fit > kWarpsPerBlock ? kWarpsPerBlock : fit);
  return pl;
}

template <typename T>
cudaError_t prepare(const Plan<T>& pl) {
  const size_t smem = pl.warps * pl.per_warp;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(pl.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  const int blocks = (B + pl.warps - 1) / pl.warps;
  pl.kernel<<<blocks, pl.warps * 32, pl.warps * pl.per_warp, stream>>>(
      H, g, p, work, B, n);
  return static_cast<int>(cudaGetLastError());
}

// Envs (warps) per block and resident blocks per SM at order n, from the
// runtime's occupancy calculator; < 0 is an error code.
template <typename T>
int ldl_occupancy(int n, int* out) {
  if (n < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const Plan<T> pl = plan<T>(n);
  int blocks = 0;
  cudaError_t err = prepare(pl);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pl.kernel, pl.warps * 32, pl.warps * pl.per_warp);
  out[0] = pl.warps;
  out[1] = blocks;
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
