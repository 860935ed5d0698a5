// The pyramidal Newton solve of one env by one thread block, over operands
// already staged in shared memory. Shared by the Newton kernel (newton.cu),
// which stages rows built by the stage path, and the megastep kernel
// (megastep.cu), which builds its rows in shared memory itself.
//
// Semantics are those of the reference's XLA body _xla_newton
// (mujoco_tpu/ops/newton_tpu.py:81) and _xla_linesearch (:126), which the
// megastep's _newton_core (mujoco_tpu/ops/megastep_tpu.py:501) repeats with
// every row one-sided: warmstart-vs-smooth pick by cost; then per iteration
// jar = Jx − aref, the row update, grad = M(x − a_s) − Jᵀf,
// H = M + JᵀWJ + reg·I, in-place LDL, p = −H⁻¹grad, a bracketed Newton
// linesearch of ls_iter steps, x += αp; then a final row update.
//
// Threads split the nefc rows for jar, the row update and the linesearch
// sums, the nv columns for Jᵀf, M·x and the gradient, and the lower
// triangle of H for Σ_r w_r J_rᵀJ_r; warp 0 then factors H in place with the
// LDL of ldl_common.cuh. Block sums reduce in a fixed order and every thread
// reads the same totals, so the linesearch's scalar state (lo, hi, has_hi,
// α) is identical in all threads without a broadcast.
//
// Kinks: the linesearch stops where φ'(α) changes sign, and φ' is piecewise
// linear with a kink wherever a row crosses jar = 0 (or ±R·fl). At f32 an
// env can land on either side of a kink depending on the last bit of a sum,
// so kernel and plain version agree statistically at f32, not env by env.
// The build keeps IEEE division (no --use_fast_math) for the same reason.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "ldl_common.cuh"

namespace mjt {

constexpr int kThreads = 128;  // threads of a block that runs one solve
constexpr int kStatRows = 32;
constexpr double kMinVal = 1e-15;  // mjMINVAL

template <typename T>
__device__ inline void row_update(T jar, T D, T R, T fl, T fric, T ones,
                                  T& force, T& cost, T& w) {
  force = -D * jar;
  cost = T(0.5) * D * jar * jar;
  w = D;
  const T rfl = R * fl;
  const bool lin_neg = fric > T(0) && jar <= -rfl;
  const bool lin_pos = fric > T(0) && jar >= rfl;
  if (lin_neg || lin_pos) {
    force = lin_neg ? fl : -fl;
    cost = -T(0.5) * rfl * fl + fl * fabs(jar);
    w = T(0);
  }
  if (ones > T(0) && jar >= T(0)) {
    force = T(0);
    cost = T(0);
    w = T(0);
  }
}

// Sum a and b over the block; every thread returns the same totals.
template <typename T>
__device__ inline void block_sum2(T& a, T& b, T* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kFullMask, a, off);
    b += __shfl_down_sync(kFullMask, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = T(0);
  b = T(0);
  for (int w = 0; w < (kThreads >> 5); ++w) {
    a += red[w];
    b += red[32 + w];
  }
}

// Shared-memory operands of one env's solve. J (nefc × nv), M (nv × nv)
// and the inputs are read only; H (nv × ld), the row vectors jar, jp, force
// and w (nefc), x, dx, mdx and y (nv), red (64) and cost (kStatRows + 1) are
// work space. R, fl, fric and ones are unused when every row is one-sided.
template <typename T>
struct NewtonSmem {
  const T* J;
  const T* M;
  T* H;
  const T* aref;
  const T* D;
  const T* R;
  const T* fl;
  const T* fric;
  const T* ones;
  T* jar;
  T* jp;
  T* force;
  T* w;
  T* x;
  const T* as;
  const T* warm;
  T* dx;
  T* mdx;
  T* y;
  T* red;
  T* cost;
  int nefc, nv, ld;
};

// Row update of row r; with kOneSided every row is a one-sided row without
// friction loss (fric 0, ones 1), the megastep's whole row set.
template <typename T, bool kOneSided>
__device__ inline void row_at(const NewtonSmem<T>& s, int r, T jar, T& f,
                              T& c, T& w) {
  if (kOneSided) {
    row_update(jar, s.D[r], T(0), T(0), T(0), T(1), f, c, w);
  } else {
    row_update(jar, s.D[r], s.R[r], s.fl[r], s.fric[r], s.ones[r], f, c, w);
  }
}

// Σ_r cost_r(Jv − aref) + 0.5·(v − a_s)ᵀM(v − a_s) for v in shared memory;
// stores jar, force and w per row and dx, M·dx per dof. Every thread calls
// it and gets the total.
template <typename T, bool kOneSided>
__device__ T newton_objective(const NewtonSmem<T>& s, const T* v) {
  const int tid = threadIdx.x, nefc = s.nefc, nv = s.nv;
  T rows = T(0), quad = T(0);
  for (int r = tid; r < nefc; r += kThreads) {
    T acc = T(0);
    for (int j = 0; j < nv; ++j) acc += s.J[r * nv + j] * v[j];
    const T jar = acc - s.aref[r];
    T f, c, w;
    row_at<T, kOneSided>(s, r, jar, f, c, w);
    s.jar[r] = jar;
    s.force[r] = f;
    s.w[r] = w;
    rows += c;
  }
  for (int i = tid; i < nv; i += kThreads) s.dx[i] = v[i] - s.as[i];
  __syncthreads();
  for (int i = tid; i < nv; i += kThreads) {
    T acc = T(0);
    for (int j = 0; j < nv; ++j) acc += s.M[i * nv + j] * s.dx[j];
    s.mdx[i] = acc;
    quad += s.dx[i] * acc;
  }
  block_sum2(rows, quad, s.red);
  return rows + T(0.5) * quad;
}

// The whole solve: on return s.x holds the solution, s.force the forces of
// its final row update and s.cost[0..iterations] the objective before each
// iteration and after the last. use_warm = false starts from a_s without
// the pick (DisableBit.WARMSTART in the megastep). Every thread of the
// block must call it; the results are visible to all threads on return.
template <typename T, bool kOneSided>
__device__ void block_newton(const NewtonSmem<T>& s, T reg, int iterations,
                             int ls_iter, bool use_warm) {
  const int tid = threadIdx.x, nefc = s.nefc, nv = s.nv, ld = s.ld;
  const T* start = s.as;
  if (use_warm) {
    const T cost_warm = newton_objective<T, kOneSided>(s, s.warm);
    const T cost_smooth = newton_objective<T, kOneSided>(s, s.as);
    if (cost_warm < cost_smooth) start = s.warm;
  }
  for (int i = tid; i < nv; i += kThreads) s.x[i] = start[i];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    // jar, row update, M·(x − a_s) and the objective at x
    const T cost = newton_objective<T, kOneSided>(s, s.x);
    if (tid == 0) s.cost[it] = cost;
    // right-hand side −grad = −(M(x − a_s) − Jᵀf)
    for (int i = tid; i < nv; i += kThreads) {
      T jtf = T(0);
      for (int r = 0; r < nefc; ++r) jtf += s.J[r * nv + i] * s.force[r];
      s.y[i] = -(s.mdx[i] - jtf);
    }
    // H = M + Σ_r w_r J_rᵀ J_r + reg·I, lower triangle
    for (int e = tid; e < nv * nv; e += kThreads) {
      const int i = e / nv, j = e - i * nv;
      if (j > i) continue;
      T acc = T(0);
      for (int r = 0; r < nefc; ++r)
        acc += (s.w[r] * s.J[r * nv + i]) * s.J[r * nv + j];
      T hij = s.M[i * nv + j] + acc;
      if (i == j) hij += reg;
      s.H[i * ld + j] = hij;
    }
    __syncthreads();
    if (tid < 32) warp_ldl_solve(s.H, ld, s.y, nv, tid);
    __syncthreads();
    // linesearch inputs: jp = J p, gx0 = pᵀM(x − a_s), pmp = pᵀMp
    for (int r = tid; r < nefc; r += kThreads) {
      T acc = T(0);
      for (int j = 0; j < nv; ++j) acc += s.J[r * nv + j] * s.y[j];
      s.jp[r] = acc;
    }
    T gx0 = T(0), pmp = T(0);
    for (int i = tid; i < nv; i += kThreads) {
      T acc = T(0);
      for (int j = 0; j < nv; ++j) acc += s.M[i * nv + j] * s.y[j];
      gx0 += s.y[i] * s.mdx[i];
      pmp += s.y[i] * acc;
    }
    block_sum2(gx0, pmp, s.red);

    T lo = T(0), hi = T(INFINITY), alpha = T(0);
    bool has_hi = false;
    for (int l = 0; l < ls_iter; ++l) {
      T jpf = T(0), curv = T(0);
      for (int r = tid; r < nefc; r += kThreads) {
        T f, c, w;
        row_at<T, kOneSided>(s, r, s.jar[r] + alpha * s.jp[r], f, c, w);
        jpf += s.jp[r] * f;
        curv += w * s.jp[r] * s.jp[r];
      }
      block_sum2(jpf, curv, s.red);
      const T dphi = gx0 + alpha * pmp - jpf;
      const T ddphi = pmp + curv;
      const bool neg = dphi < T(0);
      if (neg) {
        lo = lo > alpha ? lo : alpha;
      } else {
        hi = hi < alpha ? hi : alpha;
      }
      has_hi = has_hi || !neg;
      const T prop = alpha - dphi / (ddphi > T(kMinVal) ? ddphi : T(kMinVal));
      // has_hi selects hi without ever forming inf·0
      const T mid = T(0.5) * (lo + (has_hi ? hi : lo));
      const bool ok = prop >= lo && prop <= hi;
      alpha = ok ? prop : (has_hi ? mid : prop);
    }
    alpha = alpha > T(0) ? alpha : T(0);
    for (int i = tid; i < nv; i += kThreads) s.x[i] += alpha * s.y[i];
    __syncthreads();
  }

  // final row update at the solution
  const T cost_final = newton_objective<T, kOneSided>(s, s.x);
  if (tid == 0) s.cost[iterations] = cost_final;
  __syncthreads();
}

}  // namespace mjt
