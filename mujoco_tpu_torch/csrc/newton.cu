// Whole pyramidal Newton constraint solve, one warp per env up to nv 32 and
// one block of eight warps per env above, float and double.
//
// Replaces the Pallas kernel _newton_kernel
// (mujoco_tpu/ops/newton_tpu.py:155, launched by _newton_lanes :289).
// Semantics are those of the reference's XLA body _xla_newton (:81) and
// _xla_linesearch (:126): warmstart-vs-smooth pick by cost; then per
// iteration jar = Jx − aref, the row update, grad = M(x − a_s) − Jᵀf,
// H = M + JᵀWJ + reg·I, in-place LDL, p = −H⁻¹grad, a bracketed Newton
// linesearch of ls_iter steps, x += αp; then a final row update,
// qfrc = Jᵀf and the [improvement, cost] row of each iteration.
//
// What bounds it on an H100: one env's latency, not bytes. The solve is a
// chain of dependent passes (objective, Jᵀf, JᵀWJ, a 27-pivot LDL, the
// linesearch sums), each short, and the bytes an env must read are a few
// KB. The TPU kernel put 128 envs on the lanes of its vector registers;
// here the chain is cut to the work these inputs need and enough envs share
// an SM to overlap their chains:
//
// - Only the rows that can act are solved over (newton_cuda.kept_rows: D ≠
//   0, or a friction-loss row with fl ≠ 0; on the humanoid about 13 of
//   162). The block reads D, fl and the masks of every row, ranks the kept
//   rows by ballot in ascending order and copies only their J rows, aref
//   and R; a dropped row's force is written as 0 (the plain version's ±0).
//   Every sum over the kept rows is the dense sum without its exact zeros
//   (PackedRows, newton_common.cuh).
// - nv ≤ 32, one warp per env: the passes over nv and over the kept rows
//   fit one warp, the block sums are butterflies with no block barrier, and
//   the warp that factors H (in registers) is the whole block.
// - Shared memory holds M, H, the row vectors of every row the env could
//   keep, and the J rows of up to kRowCap kept rows: 17.9 KB at f32 for
//   the humanoid, so 12 blocks share an SM. An env with more kept rows
//   reads its J rows from device memory instead (a second instantiation
//   of the same solve), so every env is solved in full without a host
//   synchronisation.
// - nv > 32 (kWide), one block of kWideThreads per env: at nv 81 one warp
//   would walk 3,321 entries of H and 81 serial pivots alone. H is built
//   as the 32×32 tiles of the blocked LDLᵀ (block_ldl_solve,
//   ldl_common.cuh) in the order the factor walks them and factored by the
//   whole block; a row's product with a dof vector is one warp's, M·v reads
//   M by columns; up to kWideRowCap kept J rows stay in shared memory
//   (multi_humanoid3 keeps ~40). Where the work space does not fit what a
//   block may opt into (nv 270 at f32 and from about nv 110 at f64), H's
//   tiles, M, the J rows and the row vectors move to a per-env slice of
//   device memory that the caller allocates (kGlobalWork;
//   mjt_newton_work_values says how many values per env); the factor
//   stages each panel in shared memory, and every other pass reads runs of
//   consecutive values. 256 threads by measurement (thread_counts.py:
//   128 took 49 % longer at nv 270 and 3 % at nv 81, f32); at f32
//   __launch_bounds__ holds it to 128 registers, so two blocks may share
//   an SM.
// - nv ≤ 32 where the work space does not fit (many rows at f64): the
//   whole work space in device memory, as above, one warp per env.
// - Every input copy into shared memory is a cp.async, so an env's loads
//   are all in flight at once and none passes through registers.
//
// The solve itself is block_newton (newton_common.cuh), which the megastep
// kernel calls too with its own rows (ListRows).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "newton_common.cuh"

namespace mjt {
namespace {

constexpr int kNewtonThreads = 32;   // nv ≤ 32: one warp per env
constexpr int kNewtonMinBlocks = 12;
constexpr int kRowCap = 48;          // J rows of kept rows in shared memory
constexpr int kWideThreads = 256;    // nv > 32: eight warps per env
constexpr int kWideRowCap = 96;



struct Shapes {
  int nefc, nv, ld, cap;
  bool wide;    // nv > 32: H as tiles, factored by block_ldl_solve
  bool global;  // the work space in device memory
};

// The wide solve's values that stay in shared memory on either route: the
// factor's aux, y padded to 32·nt, five dof vectors, block sums and costs.
__host__ __device__ inline size_t wide_small_values(const Shapes& s) {
  return kLdlAuxValues + 32 * static_cast<size_t>(ldl_tiles_per_side(s.nv)) +
         5 * static_cast<size_t>(s.nv) + 64 + kStatRows + 1;
}

// The values that move to device memory on the global route: M, the kept
// J rows, the row vectors (and, wide, H's tiles before them).
__host__ __device__ inline size_t big_values(const Shapes& s) {
  return static_cast<size_t>(s.nv) * s.nv                    // M
         + static_cast<size_t>(s.cap) * s.nv                  // kept J rows
         + 8 * static_cast<size_t>(s.nefc);                   // row vectors
}

// Dynamic shared memory of one block.
template <typename T>
__host__ __device__ inline size_t smem_bytes(const Shapes& s) {
  if (s.wide) {
    const size_t tiles =
        static_cast<size_t>(s.global ? ldl_tiles_per_side(s.nv)
                                     : ldl_tile_count(s.nv)) * kTileValues;
    const size_t values = tiles + wide_small_values(s) +
                          (s.global ? 0 : big_values(s));
    return values * sizeof(T) +
           (s.global ? 0 : static_cast<size_t>(s.nefc) * sizeof(int));
  }
  if (s.global) return 0;
  const size_t values = big_values(s)
                        + static_cast<size_t>(s.nv) * s.ld  // H
                        + 6 * static_cast<size_t>(s.nv)     // dof vectors
                        + 64                                // block sums
                        + kStatRows + 1;                    // costs
  return values * sizeof(T) + static_cast<size_t>(s.nefc) * sizeof(int);
}

// Values of one env's work-space slice in device memory (global route),
// rounded up to 16 bytes: the narrow solve's whole work space, the wide
// solve's tiles and big values.
template <typename T>
__host__ __device__ inline size_t work_values(const Shapes& s) {
  Shapes all = s;
  all.global = false;
  const size_t bytes =
      s.wide ? (static_cast<size_t>(ldl_tile_count(s.nv)) * kTileValues +
                big_values(s)) * sizeof(T) +
                   static_cast<size_t>(s.nefc) * sizeof(int)
             : smem_bytes<T>(all);
  return (bytes + 15) / 16 * 16 / sizeof(T);
}

template <bool kGlobalWork, typename T>
__device__ inline void copy_async(T* dst, const T* src) {
  if constexpr (kGlobalWork) {
    *dst = *src;
  } else {
    __pipeline_memcpy_async(dst, src, sizeof(T));
  }
}

// The wide route asks for two resident blocks at f32 (128 registers a
// thread) and one at f64, whose solve spills under 128 (thread_counts.py,
// nv 81: 1.53 against 2.42 ms).
template <typename T, bool kGlobalWork, bool kWide>
__global__ void __launch_bounds__(kWide ? kWideThreads : kNewtonThreads,
                                  kWide ? (sizeof(T) == 4 ? 2 : 1)
                                        : kNewtonMinBlocks)
newton_kernel(const T* __restrict__ J, const T* __restrict__ aref,
              const T* __restrict__ D, const T* __restrict__ R,
              const T* __restrict__ fl, const T* __restrict__ fric,
              const T* __restrict__ ones, const T* __restrict__ M,
              const T* __restrict__ a_s, const T* __restrict__ warm,
              const T* __restrict__ reg, T* __restrict__ x_out,
              T* __restrict__ f_out, T* __restrict__ qfrc_out,
              T* __restrict__ stat_out, T* gwork, Shapes s, int iterations,
              int ls_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNT = kWide ? kWideThreads : kNewtonThreads;
  const int nefc = s.nefc, nv = s.nv, ld = s.ld;
  const int tid = threadIdx.x;
  const long env = blockIdx.x;

  T* sM;
  T* sH;
  T* sX;
  T* sY;   // right-hand side, then the direction p
  T* sRed;
  T* sCost;
  T* stage = nullptr;
  T* aux = nullptr;
  if constexpr (kWide) {
    // shared: [tiles, or the stage of one panel][aux][y][x as warm dx mdx]
    // [red][cost], then on the shared route the big values; device: [tiles]
    // [big values]
    const int nt = ldl_tiles_per_side(nv);
    T* sh = reinterpret_cast<T*>(smem_raw);
    T* big = kGlobalWork ? gwork + env * work_values<T>(s) : nullptr;
    const long tiles = static_cast<long>(ldl_tile_count(nv)) * kTileValues;
    if constexpr (kGlobalWork) {
      stage = sh;
      sH = big;
      sh += nt * kTileValues;
      big += tiles;
    } else {
      sH = sh;
      sh += tiles;
    }
    aux = sh;
    sY = aux + kLdlAuxValues;
    sX = sY + 32 * nt;
    sRed = sX + 5 * nv;
    sCost = sRed + 64;
    sM = kGlobalWork ? big : sCost + kStatRows + 1;
  } else {
    sM = kGlobalWork ? gwork + env * work_values<T>(s)
                     : reinterpret_cast<T*>(smem_raw);
    sH = sM + nv * nv;
  }
  T* sJ = kWide ? sM + nv * nv : sH + nv * ld;
  T* sAref = sJ + s.cap * nv;
  T* sD = sAref + nefc;
  T* sR = sD + nefc;
  T* sFl = sR + nefc;
  T* sJar = sFl + nefc;
  T* sJp = sJar + nefc;
  T* sForce = sJp + nefc;
  T* sW = sForce + nefc;
  if constexpr (!kWide) {
    sX = sW + nefc;
    sY = sX + 5 * nv;
    sRed = sY + nv;
    sCost = sRed + 64;
  }
  T* sAs = sX + nv;
  T* sWarm = sAs + nv;
  T* sDx = sWarm + nv;
  T* sMdx = sDx + nv;
  int* sInfo = reinterpret_cast<int*>(kWide ? sW + nefc
                                            : sCost + kStatRows + 1);

  // ---- every row's D and fl (masks staged in jar and jp), M, a_s, warm
  const T* Dg = D + env * nefc;
  const T* Flg = fl + env * nefc;
  for (int r = tid; r < nefc; r += kNT) {
    copy_async<kGlobalWork>(sD + r, Dg + r);
    copy_async<kGlobalWork>(sFl + r, Flg + r);
    copy_async<kGlobalWork>(sJar + r, fric + r);
    copy_async<kGlobalWork>(sJp + r, ones + r);
  }
  const T* Mg = M + env * nv * nv;
  for (int e = tid; e < nv * nv; e += kNT)
    copy_async<kGlobalWork>(sM + e, Mg + e);
  for (int i = tid; i < nv; i += kNT) {
    copy_async<kGlobalWork>(sAs + i, a_s + env * nv + i);
    copy_async<kGlobalWork>(sWarm + i, warm + env * nv + i);
  }
  __pipeline_commit();
  const T reg_e = reg[env];
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- warp 0 ranks the kept rows in ascending order, packing D, fl and
  // the masks in place (packed index k ≤ row r, and a chunk's rows are all
  // read before any of its lanes writes)
  __shared__ int s_nk;
  if (tid < 32) {
    int nk = 0;
    for (int r0 = 0; r0 < nefc; r0 += 32) {
      const int r = r0 + tid;
      bool keep = false;
      T d = T(0), f = T(0);
      int bits = r;
      if (r < nefc) {
        d = sD[r];
        f = sFl[r];
        const bool fr = sJar[r] > T(0);
        keep = d != T(0) || (fr && f != T(0));
        bits |= (fr ? kFricBit : 0) | (sJp[r] > T(0) ? kOneBit : 0);
      }
      const unsigned ball = __ballot_sync(kFullMask, keep);
      if (keep) {
        const int k = nk + __popc(ball & ((1u << tid) - 1));
        sD[k] = d;
        sFl[k] = f;
        sInfo[k] = bits;
      } else if (r < nefc) {
        f_out[env * nefc + r] = T(0);
      }
      nk += __popc(ball);
    }
    if (tid == 0) s_nk = nk;
  }
  __syncthreads();
  const int nk = s_nk;

  // ---- the kept rows' aref and R, and their J rows where they fit
  const bool fits = nk <= s.cap;
  const T* Jg = J + env * nefc * nv;
  for (int k = tid; k < nk; k += kNT) {
    const int r = sInfo[k] & kRowMask;
    copy_async<kGlobalWork>(sAref + k, aref + env * nefc + r);
    copy_async<kGlobalWork>(sR + k, R + env * nefc + r);
  }
  if (fits) {
    for (int k = 0; k < nk; ++k) {
      const T* Jr = Jg + static_cast<long>(sInfo[k] & kRowMask) * nv;
      for (int j = tid; j < nv; j += kNT)
        copy_async<kGlobalWork>(sJ + k * nv + j, Jr + j);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const NewtonWork<T> work{sM,  sH,   sJar, sJp,  sForce, sW,   sX,  sAs,
                           sWarm, sDx, sMdx, sY,  sRed,   sCost, nv, ld};
  const TileWork<T> tw{stage, aux};
  T* q = qfrc_out + env * nv;
  // the wide solve on device memory holds no J rows (cap 0): an env with
  // no kept row takes the device-J instantiation too
  if (fits && !(kWide && kGlobalWork)) {
    const PackedRows<T, false> rows{sJ, sInfo, sAref, sD, sR, sFl, nk, nv};
    block_newton<kNT, T, PackedRows<T, false>, kWide, kGlobalWork>(
        rows, work, reg_e, iterations, ls_iter, true, tw);
    for (int i = tid; i < nv; i += kNT) q[i] = rows.jtf(i, sForce);
  } else {
    const PackedRows<T, true> rows{Jg, sInfo, sAref, sD, sR, sFl, nk, nv};
    block_newton<kNT, T, PackedRows<T, true>, kWide, kGlobalWork>(
        rows, work, reg_e, iterations, ls_iter, true, tw);
    for (int i = tid; i < nv; i += kNT) q[i] = rows.jtf(i, sForce);
  }

  // ---- outputs: the kept rows' forces, x, [improvement, cost]
  for (int k = tid; k < nk; k += kNT)
    f_out[env * nefc + (sInfo[k] & kRowMask)] = sForce[k];
  for (int i = tid; i < nv; i += kNT) x_out[env * nv + i] = sX[i];
  for (int e = tid; e < 2 * kStatRows; e += kNT) {
    const int it = e >> 1;
    T v = T(0);
    if (it < iterations)
      v = (e & 1) ? sCost[it + 1] : sCost[it] - sCost[it + 1];
    stat_out[env * 2 * kStatRows + e] = v;
  }
}

Shapes shapes(int nefc, int nv) {
  const bool wide = nv > 32;
  const int cap = wide ? kWideRowCap : kRowCap;
  return Shapes{nefc, nv, ldl_ld(nv), nefc < cap ? nefc : cap, wide, false};
}

// Dynamic shared memory a block of the kernel may opt into on the current
// device (the device's limit less the kernel's static shared memory).
template <typename T, bool kWide>
size_t smem_limit() {
  int dev = 0, v = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    v = 48 * 1024;
  cudaFuncAttributes attr;
  const size_t fixed =
      cudaFuncGetAttributes(&attr, newton_kernel<T, false, kWide>) ==
              cudaSuccess
          ? attr.sharedSizeBytes
          : 64;
  return static_cast<size_t>(v) - fixed;
}

// The route at these shapes: the work space in shared memory where it
// fits, else in device memory (no J rows copied: cap 0), where the wide
// solve keeps its small values and the stage of one panel in shared
// memory. Returns the shapes and sets *smem (dynamic shared bytes) and
// *work (device-memory values per env, 0 on the shared route).
template <typename T>
Shapes route(int nefc, int nv, size_t* smem, size_t* work) {
  Shapes s = shapes(nefc, nv);
  *smem = smem_bytes<T>(s);
  *work = 0;
  const size_t limit =
      s.wide ? smem_limit<T, true>() : smem_limit<T, false>();
  if (*smem > limit) {
    s.cap = 0;
    s.global = true;
    *smem = smem_bytes<T>(s);
    *work = work_values<T>(s);
  }
  return s;
}

template <typename T, bool kGlobalWork, bool kWide>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(newton_kernel<T, kGlobalWork, kWide>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem > 48 * 1024 ? smem
                                                                : 48 * 1024));
}

// The kernel instantiation, its threads per block and its dynamic shared
// memory at these shapes (after route), with the opt-in set.
template <typename T>
struct Launch {
  void (*kernel)(const T*, const T*, const T*, const T*, const T*, const T*,
                 const T*, const T*, const T*, const T*, const T*, T*, T*,
                 T*, T*, T*, Shapes, int, int);
  int threads;
  cudaError_t err;
};

template <typename T>
Launch<T> launch_of(const Shapes& s, size_t smem) {
  Launch<T> l;
  if (s.wide) {
    l.threads = kWideThreads;
    if (s.global) {
      l.kernel = newton_kernel<T, true, true>;
      l.err = set_smem<T, true, true>(smem);
    } else {
      l.kernel = newton_kernel<T, false, true>;
      l.err = set_smem<T, false, true>(smem);
    }
  } else {
    l.threads = kNewtonThreads;
    if (s.global) {
      l.kernel = newton_kernel<T, true, false>;
      l.err = cudaSuccess;
    } else {
      l.kernel = newton_kernel<T, false, false>;
      l.err = smem > 48 * 1024 ? set_smem<T, false, false>(smem)
                               : cudaSuccess;
    }
  }
  return l;
}

template <typename T>
int launch_newton(const T* J, const T* aref, const T* D, const T* R,
                  const T* fl, const T* fric, const T* ones, const T* M,
                  const T* a_s, const T* warm, const T* reg, T* x, T* force,
                  T* qfrc, T* stat, T* work, int B, int nefc, int nv,
                  int iterations, int ls_iter, cudaStream_t stream) {
  if (B < 1 || nefc < 1 || nefc > kRowMask || nv < 1 ||
      iterations < 1 || iterations > kStatRows || ls_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0, wv = 0;
  const Shapes s = route<T>(nefc, nv, &smem, &wv);
  if (wv && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Launch<T> l = launch_of<T>(s, smem);
  if (l.err != cudaSuccess) return static_cast<int>(l.err);
  l.kernel<<<B, l.threads, smem, stream>>>(J, aref, D, R, fl, fric, ones, M,
                                          a_s, warm, reg, x, force, qfrc,
                                          stat, work, s, iterations, ls_iter);
  return static_cast<int>(cudaGetLastError());
}

// At these shapes: threads per block (one env each), the J rows of kept
// rows held in shared memory (0 on the device-memory route) and resident
// blocks per SM from the runtime's occupancy calculator (shared memory,
// registers and threads together); < 0 is an error code.
template <typename T>
int newton_occupancy(int nefc, int nv, int* out) {
  if (nefc < 1 || nv < 1) return -static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0, wv = 0;
  const Shapes s = route<T>(nefc, nv, &smem, &wv);
  const Launch<T> l = launch_of<T>(s, smem);
  int blocks = 0;
  cudaError_t err = l.err;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel,
                                                        l.threads, smem);
  out[0] = l.threads;
  out[1] = s.cap;
  out[2] = blocks;
  return err == cudaSuccess ? 0 : -static_cast<int>(err);
}

}  // namespace
}  // namespace mjt

extern "C" int mjt_newton_occupancy(int nefc, int nv, int f64, int* out) {
  return f64 ? mjt::newton_occupancy<double>(nefc, nv, out)
             : mjt::newton_occupancy<float>(nefc, nv, out);
}

// device-memory work values per env the solve at these shapes needs (0: it
// runs in shared memory)
extern "C" long long mjt_newton_work_values(int nefc, int nv, int f64) {
  size_t smem = 0, wv = 0;
  if (f64)
    mjt::route<double>(nefc, nv, &smem, &wv);
  else
    mjt::route<float>(nefc, nv, &smem, &wv);
  return static_cast<long long>(wv);
}

#define MJT_NEWTON_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* J, const void* aref, const void* D,          \
                      const void* R, const void* fl, const void* fric,         \
                      const void* ones, const void* M, const void* a_s,        \
                      const void* warm, const void* reg, void* x, void* force, \
                      void* qfrc, void* stat, void* work, int B, int nefc,     \
                      int nv, int iterations, int ls_iter, void* stream) {     \
    return mjt::launch_newton(                                                 \
        static_cast<const T*>(J), static_cast<const T*>(aref),                 \
        static_cast<const T*>(D), static_cast<const T*>(R),                    \
        static_cast<const T*>(fl), static_cast<const T*>(fric),                \
        static_cast<const T*>(ones), static_cast<const T*>(M),                 \
        static_cast<const T*>(a_s), static_cast<const T*>(warm),               \
        static_cast<const T*>(reg), static_cast<T*>(x),                        \
        static_cast<T*>(force), static_cast<T*>(qfrc), static_cast<T*>(stat),  \
        static_cast<T*>(work), B, nefc, nv, iterations, ls_iter,               \
        static_cast<cudaStream_t>(stream));                                    \
  }

MJT_NEWTON_ENTRY(mjt_newton_f32, float)
MJT_NEWTON_ENTRY(mjt_newton_f64, double)
