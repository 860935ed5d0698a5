// Whole pyramidal Newton constraint solve, one thread block per env, float
// and double.
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
// What bounds it on an H100: memory. Per env it must read J (nefc·nv), the
// row vectors and M once; at the humanoid's nefc 162, nv 27 and one
// iteration it does about 2.7e5 flops against about 2.3e4 values read,
// ≈ 3 flops per byte at f32, below the card's fp32 balance. The TPU kernel
// kept 128 envs resident in VMEM for the same reason. Here a block stages
// its env's J, M and row vectors in shared memory (dynamic shared memory:
// 62 KB at f64 for the humanoid, above the 48 KB static limit), so J is
// read from device memory exactly once however many times the solve
// multiplies by J or Jᵀ. Threads split the nefc rows for jar, the row
// update and the linesearch sums, the nv columns for Jᵀf, M·x and the
// gradient, and the lower triangle of H for Σ_r w_r J_rᵀJ_r, which the
// kernel sums itself; one warp then factors H in place with the LDL of the
// spd_solve kernel (ldl_common.cuh). The solve itself is block_newton
// (newton_common.cuh), which the megastep kernel calls too.
#include <cuda_runtime.h>

#include "newton_common.cuh"

namespace mjt {
namespace {

struct Shapes {
  int nefc, nv, ld;
};

template <typename T>
__host__ __device__ inline size_t smem_values(const Shapes& s) {
  return static_cast<size_t>(s.nefc) * s.nv   // J
         + static_cast<size_t>(s.nv) * s.nv   // M
         + static_cast<size_t>(s.nv) * s.ld   // H
         + 10 * static_cast<size_t>(s.nefc)   // row vectors
         + 6 * static_cast<size_t>(s.nv)      // dof vectors
         + 64                                 // block reduction
         + kStatRows + 1;                     // per-iteration costs
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
newton_kernel(const T* __restrict__ J, const T* __restrict__ aref,
              const T* __restrict__ D, const T* __restrict__ R,
              const T* __restrict__ fl, const T* __restrict__ fric,
              const T* __restrict__ ones, const T* __restrict__ M,
              const T* __restrict__ a_s, const T* __restrict__ warm,
              const T* __restrict__ reg, T* __restrict__ x_out,
              T* __restrict__ f_out, T* __restrict__ qfrc_out,
              T* __restrict__ stat_out, Shapes s, int iterations,
              int ls_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nefc = s.nefc, nv = s.nv, ld = s.ld;
  const int tid = threadIdx.x;
  const long env = blockIdx.x;

  T* sJ = reinterpret_cast<T*>(smem_raw);
  T* sM = sJ + nefc * nv;
  T* sH = sM + nv * nv;
  T* sAref = sH + nv * ld;
  T* sD = sAref + nefc;
  T* sR = sD + nefc;
  T* sFl = sR + nefc;
  T* sFric = sFl + nefc;
  T* sOnes = sFric + nefc;
  T* sJar = sOnes + nefc;
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

  // ---- stage this env's inputs in shared memory (read once)
  const T* Jg = J + env * nefc * nv;
  for (int e = tid; e < nefc * nv; e += kThreads) sJ[e] = Jg[e];
  const T* Mg = M + env * nv * nv;
  for (int e = tid; e < nv * nv; e += kThreads) sM[e] = Mg[e];
  for (int r = tid; r < nefc; r += kThreads) {
    sAref[r] = aref[env * nefc + r];
    sD[r] = D[env * nefc + r];
    sR[r] = R[env * nefc + r];
    sFl[r] = fl[env * nefc + r];
    sFric[r] = fric[r];
    sOnes[r] = ones[r];
  }
  for (int i = tid; i < nv; i += kThreads) {
    sAs[i] = a_s[env * nv + i];
    sWarm[i] = warm[env * nv + i];
  }
  const T reg_e = reg[env];
  __syncthreads();

  const DenseRows<T> rows{sJ, sAref, sD, sR, sFl, sFric, sOnes, nefc, nv};
  const NewtonWork<T> work{sM,  sH,   sJar, sJp,  sForce, sW,   sX,  sAs,
                           sWarm, sDx, sMdx, sY,  sRed,   sCost, nv, ld};
  block_newton<kThreads>(rows, work, reg_e, iterations, ls_iter, true);

  // ---- outputs: x, the final forces, qfrc = Jᵀf, [improvement, cost]
  for (int r = tid; r < nefc; r += kThreads) f_out[env * nefc + r] = sForce[r];
  for (int i = tid; i < nv; i += kThreads) {
    qfrc_out[env * nv + i] = rows.jtf(i, sForce);
    x_out[env * nv + i] = sX[i];
  }
  for (int e = tid; e < 2 * kStatRows; e += kThreads) {
    const int it = e >> 1;
    T v = T(0);
    if (it < iterations)
      v = (e & 1) ? sCost[it + 1] : sCost[it] - sCost[it + 1];
    stat_out[env * 2 * kStatRows + e] = v;
  }
}

template <typename T>
int launch_newton(const T* J, const T* aref, const T* D, const T* R,
                  const T* fl, const T* fric, const T* ones, const T* M,
                  const T* a_s, const T* warm, const T* reg, T* x, T* force,
                  T* qfrc, T* stat, int B, int nefc, int nv, int iterations,
                  int ls_iter, cudaStream_t stream) {
  if (B < 1 || nefc < 1 || nv < 1 || nv > 64 || iterations < 1 ||
      iterations > kStatRows || ls_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shapes s{nefc, nv, ldl_ld(nv)};
  const size_t smem = smem_values<T>(s) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_kernel<T><<<B, kThreads, smem, stream>>>(
      J, aref, D, R, fl, fric, ones, M, a_s, warm, reg, x, force, qfrc, stat,
      s, iterations, ls_iter);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at these shapes, from the runtime's occupancy
// calculator (shared memory, registers and threads together); < 0 is an
// error code.
template <typename T>
int newton_blocks_per_sm(int nefc, int nv) {
  const Shapes s{nefc, nv, ldl_ld(nv)};
  const size_t smem = smem_values<T>(s) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      newton_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem > 48 * 1024 ? smem : 48 * 1024));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, newton_kernel<T>, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace
}  // namespace mjt

extern "C" int mjt_newton_blocks_per_sm(int nefc, int nv, int f64) {
  return f64 ? mjt::newton_blocks_per_sm<double>(nefc, nv)
             : mjt::newton_blocks_per_sm<float>(nefc, nv);
}

#define MJT_NEWTON_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* J, const void* aref, const void* D,          \
                      const void* R, const void* fl, const void* fric,         \
                      const void* ones, const void* M, const void* a_s,        \
                      const void* warm, const void* reg, void* x, void* force, \
                      void* qfrc, void* stat, int B, int nefc, int nv,         \
                      int iterations, int ls_iter, void* stream) {             \
    return mjt::launch_newton(                                                 \
        static_cast<const T*>(J), static_cast<const T*>(aref),                 \
        static_cast<const T*>(D), static_cast<const T*>(R),                    \
        static_cast<const T*>(fl), static_cast<const T*>(fric),                \
        static_cast<const T*>(ones), static_cast<const T*>(M),                 \
        static_cast<const T*>(a_s), static_cast<const T*>(warm),               \
        static_cast<const T*>(reg), static_cast<T*>(x),                        \
        static_cast<T*>(force), static_cast<T*>(qfrc), static_cast<T*>(stat),  \
        B, nefc, nv, iterations, ls_iter, static_cast<cudaStream_t>(stream));  \
  }

MJT_NEWTON_ENTRY(mjt_newton_f32, float)
MJT_NEWTON_ENTRY(mjt_newton_f64, double)
