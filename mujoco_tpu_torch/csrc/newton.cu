// Whole pyramidal Newton constraint solve, one warp per env, float and
// double.
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
// - One warp per env: the passes over nv and over the kept rows fit one
//   warp, the block sums are butterflies with no block barrier, and the
//   warp that factors H is the whole block.
// - Shared memory holds M, H, the row vectors of every row the env could
//   keep, and the J rows of up to kRowCap kept rows: 17.9 KB at f32 for
//   the humanoid, so 12 blocks share an SM. An env with more kept rows
//   reads its J rows from device memory instead (a second instantiation
//   of the same solve), so every env is solved in full without a host
//   synchronisation.
// - Any nv: H's factor goes through the wide warp LDL (ldl_common.cuh)
//   above nv 32. Where the work space does not fit what a block may opt
//   into (at f64 from about nv 110, fewer with many rows), the whole work
//   space moves to a per-env slice of device memory that the caller
//   allocates (kGlobalWork; mjt_newton_work_values says how many values
//   per env) and every env reads its J rows from device memory.
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

constexpr int kNewtonThreads = 32;   // one warp per env
constexpr int kNewtonMinBlocks = 12;
constexpr int kRowCap = 48;          // J rows of kept rows in shared memory

struct Shapes {
  int nefc, nv, ld, cap;
};

template <typename T>
__host__ __device__ inline size_t smem_bytes(const Shapes& s) {
  const size_t values = static_cast<size_t>(s.nv) * s.nv   // M
                        + static_cast<size_t>(s.nv) * s.ld  // H
                        + static_cast<size_t>(s.cap) * s.nv // kept J rows
                        + 8 * static_cast<size_t>(s.nefc)   // row vectors
                        + 6 * static_cast<size_t>(s.nv)     // dof vectors
                        + 64                                // block sums
                        + kStatRows + 1;                    // costs
  return values * sizeof(T) + static_cast<size_t>(s.nefc) * sizeof(int);
}

// Values of one env's work-space slice in device memory: smem_bytes
// rounded up to 16 bytes.
template <typename T>
__host__ __device__ inline size_t work_values(const Shapes& s) {
  return (smem_bytes<T>(s) + 15) / 16 * 16 / sizeof(T);
}

template <bool kGlobalWork, typename T>
__device__ inline void copy_async(T* dst, const T* src) {
  if constexpr (kGlobalWork) {
    *dst = *src;
  } else {
    __pipeline_memcpy_async(dst, src, sizeof(T));
  }
}

template <typename T, bool kGlobalWork>
__global__ void __launch_bounds__(kNewtonThreads, kNewtonMinBlocks)
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
  constexpr int kNT = kNewtonThreads;
  const int nefc = s.nefc, nv = s.nv, ld = s.ld;
  const int tid = threadIdx.x;
  const long env = blockIdx.x;

  T* sM = kGlobalWork ? gwork + env * work_values<T>(s)
                      : reinterpret_cast<T*>(smem_raw);
  T* sH = sM + nv * nv;
  T* sJ = sH + nv * ld;
  T* sAref = sJ + s.cap * nv;
  T* sD = sAref + nefc;
  T* sR = sD + nefc;
  T* sFl = sR + nefc;
  T* sJar = sFl + nefc;
  T* sJp = sJar + nefc;
  T* sForce = sJp + nefc;
  T* sW = sForce + nefc;
  T* sX = sW + nefc;
  T* sAs = sX + nv;
  T* sWarm = sAs + nv;
  T* sDx = sWarm + nv;
  T* sMdx = sDx + nv;
  T* sY = sMdx + nv;   // right-hand side, then the direction p
  T* sRed = sY + nv;
  T* sCost = sRed + 64;
  int* sInfo = reinterpret_cast<int*>(sCost + kStatRows + 1);

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
  T* q = qfrc_out + env * nv;
  if (fits) {
    const PackedRows<T, false> rows{sJ, sInfo, sAref, sD, sR, sFl, nk, nv};
    block_newton<kNT>(rows, work, reg_e, iterations, ls_iter, true);
    for (int i = tid; i < nv; i += kNT) q[i] = rows.jtf(i, sForce);
  } else {
    const PackedRows<T, true> rows{Jg, sInfo, sAref, sD, sR, sFl, nk, nv};
    block_newton<kNT>(rows, work, reg_e, iterations, ls_iter, true);
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
  return Shapes{nefc, nv, ldl_ld(nv), nefc < kRowCap ? nefc : kRowCap};
}

// Dynamic shared memory a block of newton_kernel<T, false> may opt into on
// the current device (the device's limit less the kernel's static shared
// memory).
template <typename T>
size_t smem_limit() {
  int dev = 0, v = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    v = 48 * 1024;
  cudaFuncAttributes attr;
  const size_t fixed =
      cudaFuncGetAttributes(&attr, newton_kernel<T, false>) == cudaSuccess
          ? attr.sharedSizeBytes
          : 64;
  return static_cast<size_t>(v) - fixed;
}

// The route at these shapes: the work space in shared memory where it
// fits, else in device memory (no J rows copied: cap 0). Returns the
// shapes and sets *smem (dynamic shared bytes) and *work (device-memory
// values per env, 0 on the shared route).
template <typename T>
Shapes route(int nefc, int nv, size_t* smem, size_t* work) {
  Shapes s = shapes(nefc, nv);
  *smem = smem_bytes<T>(s);
  *work = 0;
  if (*smem > smem_limit<T>()) {
    s.cap = 0;
    *smem = 0;
    *work = work_values<T>(s);
  }
  return s;
}

template <typename T, bool kGlobalWork>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(newton_kernel<T, kGlobalWork>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem > 48 * 1024 ? smem
                                                                : 48 * 1024));
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
  if (wv) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    newton_kernel<T, true><<<B, kNewtonThreads, 0, stream>>>(
        J, aref, D, R, fl, fric, ones, M, a_s, warm, reg, x, force, qfrc,
        stat, work, s, iterations, ls_iter);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = set_smem<T, false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_kernel<T, false><<<B, kNewtonThreads, smem, stream>>>(
      J, aref, D, R, fl, fric, ones, M, a_s, warm, reg, x, force, qfrc, stat,
      work, s, iterations, ls_iter);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at these shapes, from the runtime's occupancy
// calculator (shared memory, registers and threads together); < 0 is an
// error code.
template <typename T>
int newton_blocks_per_sm(int nefc, int nv) {
  size_t smem = 0, wv = 0;
  route<T>(nefc, nv, &smem, &wv);
  cudaError_t err = cudaSuccess;
  int blocks = 0;
  if (wv) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, newton_kernel<T, true>, kNewtonThreads, 0);
  } else {
    err = set_smem<T, false>(smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, newton_kernel<T, false>, kNewtonThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace
}  // namespace mjt

extern "C" int mjt_newton_blocks_per_sm(int nefc, int nv, int f64) {
  return f64 ? mjt::newton_blocks_per_sm<double>(nefc, nv)
             : mjt::newton_blocks_per_sm<float>(nefc, nv);
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
