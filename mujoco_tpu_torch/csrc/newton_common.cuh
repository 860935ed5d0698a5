// The pyramidal Newton solve of one env by one thread block, over operands
// already staged in shared memory. Shared by the Newton kernel (newton.cu),
// which packs the kept rows of a dense J built by the stage path
// (PackedRows), and the megastep kernel (megastep.cu), which builds the
// list of its active rows in shared memory itself (ListRows).
//
// Semantics are those of the reference's XLA body _xla_newton
// (mujoco_tpu/ops/newton_tpu.py:81) and _xla_linesearch (:126), which the
// megastep's _newton_core (mujoco_tpu/ops/megastep_tpu.py:501) repeats with
// every row one-sided: warmstart-vs-smooth pick by cost; then per iteration
// jar = Jx − aref, the row update, grad = M(x − a_s) − Jᵀf,
// H = M + JᵀWJ + reg·I, in-place LDL, p = −H⁻¹grad, a bracketed Newton
// linesearch of ls_iter steps, x += αp; then a final row update.
//
// Threads split the rows for jar, the row update and the linesearch sums,
// the nv columns for Jᵀf, M·x and the gradient, and the lower triangle of H
// for Σ_r w_r J_rᵀJ_r; warp 0 then factors H in place with the LDL of
// ldl_common.cuh. Block sums reduce in a fixed order and every thread reads
// the same totals, so the linesearch's scalar state (lo, hi, has_hi, α) is
// identical in all threads without a broadcast.
//
// The wide solve (kWide, the Newton kernel above nv 32 and the megastep's
// wide routes, a block of several warps): H is built as the tiles of
// block_ldl_solve (ldl_common.cuh), tile by tile in the order the factor
// walks them (build_h_tiles), and factored by the whole block; a row's
// product with a
// dof vector is one warp's (lanes over the dofs, a butterfly sum), and
// M·v reads M by columns (M is symmetric), so that every pass over a work
// space in device memory reads runs of consecutive values.
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

constexpr int kStatRows = 32;
constexpr double kMinVal = 1e-15;  // mjMINVAL

// Row i of entry t of a row-major lower triangle, t = i(i + 1)/2 + j: the
// float root's guess, corrected to the exact integer row.
__device__ inline int tri_row(int t) {
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  return i;
}

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

// Sum a and b over the block of kNT threads; every thread returns the same
// totals. Shared-memory writes made before the call are visible to every
// thread after it.
template <int kNT, typename T>
__device__ inline void block_sum2(T& a, T& b, T* red) {
  if constexpr (kNT == 32) {
    // one warp: a butterfly, no shared memory and no block barrier. Each
    // level adds the same two partial sums on both lanes of a pair, so
    // every lane ends with the same bits.
    __syncwarp(kFullMask);
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kFullMask, a, off);
      b += __shfl_xor_sync(kFullMask, b, off);
    }
  } else {
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
    for (int w = 0; w < (kNT >> 5); ++w) {
      a += red[w];
      b += red[32 + w];
    }
  }
}

// Shared-memory work space of one env's solve: M (nv × nv) and the inputs
// are read only; H (nv × ld), the row vectors jar, jp, force and w (one per
// row of the solve), x, dx, mdx and y (nv), red (64) and cost
// (kStatRows + 1) are written.
template <typename T>
struct NewtonWork {
  const T* M;
  T* H;
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
  int nv, ld;
};

// The rows of a solve, as block_newton reads them: n rows; dot(k, v), row
// k's product with a dof vector; jtf(i, f) = (Jᵀf)_i summed in row order;
// build_h<kNT>(s, reg), H's lower triangle M + JᵀWJ + reg·I by the block's
// kNT threads, each entry's JᵀWJ summed in row order; update(k, jar, ...),
// the row update at jar. Two kinds:
//
// PackedRows (newton.cu): the kept rows of a dense row set (D ≠ 0, or a
// friction-loss row with fl ≠ 0) in ascending order, general rows with
// friction loss and two sides. Packed row k is dense row info[k] &
// kRowMask, with the kFricBit and kOneBit flags of its masks; its aref, D,
// R and fl are packed at k. Its J row lies at J + k·nv in shared memory,
// or, for an env with more kept rows than the shared capacity
// (kGlobalJ), at J + row·nv in the env's dense J in device memory. A
// dropped row adds force −0·jar, cost 0 and w 0, exact zeros, to every
// sum of the dense solve, so each sum here is the dense one, term for
// term, without its zeros.
constexpr int kRowMask = (1 << 29) - 1;
constexpr int kFricBit = 1 << 29;
constexpr int kOneBit = 1 << 30;

template <typename T, bool kGlobalJ>
struct PackedRows {
  const T* J;
  const int* info;
  const T* aref;
  const T* D;
  const T* R;
  const T* fl;
  int n, nv;
  __device__ const T* row(int k) const {
    return J + static_cast<long>(kGlobalJ ? info[k] & kRowMask : k) * nv;
  }
  __device__ T dot(int k, const T* v) const {
    const T* Jk = row(k);
    T acc = T(0);
    for (int j = 0; j < nv; ++j) acc += Jk[j] * v[j];
    return acc;
  }
  __device__ T jtf(int i, const T* f) const {
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc += row(k)[i] * f[k];
    return acc;
  }
  // Each thread keeps kChunk entries of the lower triangle in registers
  // and walks the rows once for all of them (as ListRows::build_h).
  template <int kNT>
  __device__ void build_h(const NewtonWork<T>& s, T reg) const {
    constexpr int kChunk = 384 / kNT;   // one pass at nv 27
    const int ntri = nv * (nv + 1) / 2;
    for (int base = 0; base < ntri; base += kChunk * kNT) {
      int ii[kChunk], jj[kChunk];
      T acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = base + threadIdx.x + c * kNT;
        const int i = tri_row(t);
        ii[c] = t < ntri ? i : -1;
        jj[c] = t - i * (i + 1) / 2;
        acc[c] = T(0);
      }
      for (int k = 0; k < n; ++k) {
        const T* Jk = row(k);
        const T wk = s.w[k];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (ii[c] >= 0) acc[c] += (wk * Jk[ii[c]]) * Jk[jj[c]];
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (ii[c] < 0) continue;
        const int i = ii[c], j = jj[c];
        T hij = s.M[i * nv + j] + acc[c];
        if (i == j) hij += reg;
        s.H[i * s.ld + j] = hij;
      }
    }
  }
  // row k's product with v by one warp: every lane gets the sum
  __device__ T dot_warp(int k, const T* v, int lane) const {
    const T* Jk = row(k);
    T acc = T(0);
    for (int j = lane; j < nv; j += 32) acc += Jk[j] * v[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, off);
    return acc;
  }
  // H = M + JᵀWJ + reg·I as the tiles of block_ldl_solve (padded with the
  // identity, 0 above a diagonal tile's diagonal). One warp per tile, the
  // tiles in panel order; lane (ry, cx) = (lane / 4, lane % 4) owns rows
  // ry + 8q (q < 4) and columns cx + 4u (u < 8) of its tile, as
  // trailing_tile does, so each kept row's J values come as one 8-value
  // and one 4-value run per warp and feed 32 multiply-adds per lane. Each
  // entry's JᵀWJ is summed in row order, (w_k·J_ki)·J_kj, as build_h.
  template <int kNT>
  __device__ void build_h_tiles(const NewtonWork<T>& s, T reg, T* tiles,
                                int nt) const {
    const int lane = threadIdx.x & 31, ry = lane >> 2, cx = lane & 3;
    const int ntiles = nt * (nt + 1) / 2;
    for (int t = threadIdx.x >> 5; t < ntiles; t += kNT / 32) {
      int J = 0, base = 0;
      while (base + nt - J <= t) {
        base += nt - J;
        ++J;
      }
      const int I = J + t - base;
      T acc[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[q][u] = T(0);
      for (int k = 0; k < n; ++k) {
        const T* Jk = row(k);
        const T wk = s.w[k];
        T a[4], b[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 32 * I + ry + 8 * q;
          a[q] = i < nv ? wk * Jk[i] : T(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = 32 * J + cx + 4 * u;
          b[u] = j < nv ? Jk[j] : T(0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[q][u] += a[q] * b[u];
      }
      T* tile = tiles + static_cast<long>(t) * kTileValues;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = ry + 8 * q, c = cx + 4 * u;
          const auto h = [&](int i, int j) {
            const T hij = s.M[i * nv + j] + acc[q][u];
            return i == j ? hij + reg : hij;
          };
          tile[tile_at<T>(r, c)] = ldl_tile_value<T>(I, J, r, c, nv, h);
        }
    }
  }
  __device__ void update(int k, T jar, T& f, T& c, T& w) const {
    const int bits = info[k];
    row_update(jar, D[k], R[k], fl[k], T((bits & kFricBit) != 0),
               T((bits & kOneBit) != 0), f, c, w);
  }
};

// ListRows (megastep.cu): the active rows only, in ascending order of their
// index in the dense row set, every one one-sided without friction loss:
// first nlim limit rows, row k with J = rc[k] at dof −1 − ra[k] and zero
// elsewhere; then four pyramidal rows jn + μ·jt per active contact slot,
// the slot's normal vector jn and tangent vectors jt1, jt2 stored one
// after the other (3·nv values) at cv + ra[k], jt at cv + rb[k], μ = rc[k]
// (+f0, −f0 with jt1, +f1, −f1 with jt2). Each entry is formed anew where
// it is used (dot, build_h, jtf); the compiler may contract jn + μ·jt into
// a fused multiply-add in one place and not in another, so an entry can
// differ in its last bit from one use to the next and from a stored row.
// Dropping the inactive rows (D = 0: force −0·jar, cost and w 0) and a
// limit row's zeros leaves every sum of the dense solve unchanged but for
// its order and that rounding.
template <typename T>
struct ListRows {
  const T* cv;
  const int* ra;
  const int* rb;
  const T* rc;
  const T* aref;
  const T* D;
  int n, nv, nlim;
  __device__ T jtf(int i, const T* f) const {
    T acc = T(0);
    for (int k = 0; k < nlim; ++k)
      if (-1 - ra[k] == i) acc += rc[k] * f[k];
    for (int k = nlim; k < n; k += 4) {
      const T* jn = cv + ra[k];
      const T n_i = jn[i], t1 = jn[nv + i], t2 = jn[2 * nv + i];
      acc += (n_i + rc[k] * t1) * f[k];
      acc += (n_i + rc[k + 1] * t1) * f[k + 1];
      acc += (n_i + rc[k + 2] * t2) * f[k + 2];
      acc += (n_i + rc[k + 3] * t2) * f[k + 3];
    }
    return acc;
  }
  // Each thread keeps up to kChunk entries of the lower triangle in
  // registers and walks the rows once for all of them: a limit row touches
  // only its dof's diagonal entry, a contact slot's four rows are formed
  // from its three vectors.
  template <int kNT>
  __device__ void build_h(const NewtonWork<T>& s, T reg) const {
    constexpr int kChunk = 8;
    const int ntri = nv * (nv + 1) / 2;
    for (int base = 0; base < ntri; base += kChunk * kNT) {
      int ii[kChunk], jj[kChunk];
      T acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = base + threadIdx.x + c * kNT;
        const int i = tri_row(t);
        ii[c] = t < ntri ? i : -1;
        jj[c] = t - i * (i + 1) / 2;
        acc[c] = T(0);
      }
      for (int k = 0; k < nlim; ++k) {
        const int dof = -1 - ra[k];
        const T mu = rc[k];
        const T wmu = s.w[k] * mu;
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (ii[c] == dof && jj[c] == dof) acc[c] += wmu * mu;
      }
      for (int k = nlim; k < n; k += 4) {
        const T* jn = cv + ra[k];
        const T mu[4] = {rc[k], rc[k + 1], rc[k + 2], rc[k + 3]};
        const T w[4] = {s.w[k], s.w[k + 1], s.w[k + 2], s.w[k + 3]};
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (ii[c] < 0) continue;
          const int i = ii[c], j = jj[c];
          const T n_i = jn[i], t1_i = jn[nv + i], t2_i = jn[2 * nv + i];
          const T n_j = jn[j], t1_j = jn[nv + j], t2_j = jn[2 * nv + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T ti = q < 2 ? t1_i : t2_i, tj = q < 2 ? t1_j : t2_j;
            acc[c] += (w[q] * (n_i + mu[q] * ti)) * (n_j + mu[q] * tj);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (ii[c] < 0) continue;
        const int i = ii[c], j = jj[c];
        T hij = s.M[i * nv + j] + acc[c];
        if (i == j) hij += reg;
        s.H[i * s.ld + j] = hij;
      }
    }
  }
  __device__ T dot(int k, const T* v) const {
    const int a = ra[k];
    const T mu = rc[k];
    if (a < 0) return mu * v[-1 - a];
    const T* jn = cv + a;
    const T* jt = cv + rb[k];
    T acc = T(0);
    for (int j = 0; j < nv; ++j) acc += (jn[j] + mu * jt[j]) * v[j];
    return acc;
  }
  // row k's product with v by one warp (lanes over the dofs, a butterfly
  // sum): every lane gets the sum
  __device__ T dot_warp(int k, const T* v, int lane) const {
    const int a = ra[k];
    const T mu = rc[k];
    if (a < 0) return mu * v[-1 - a];
    const T* jn = cv + a;
    const T* jt = cv + rb[k];
    T acc = T(0);
    for (int j = lane; j < nv; j += 32) acc += (jn[j] + mu * jt[j]) * v[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, off);
    return acc;
  }
  // H = M + JᵀWJ + reg·I as the tiles of block_ldl_solve, one warp per
  // tile in panel order, lane (ry, cx) owning rows ry + 8q and columns
  // cx + 4u of its tile (as PackedRows::build_h_tiles). Each entry's JᵀWJ
  // is summed as build_h sums it: the limit rows first (a diagonal tile's
  // entry at the row's dof), then each slot's four rows, formed from its
  // three vectors where they are used.
  template <int kNT>
  __device__ void build_h_tiles(const NewtonWork<T>& s, T reg, T* tiles,
                                int nt) const {
    const int lane = threadIdx.x & 31, ry = lane >> 2, cx = lane & 3;
    const int ntiles = nt * (nt + 1) / 2;
    for (int t = threadIdx.x >> 5; t < ntiles; t += kNT / 32) {
      int J = 0, base = 0;
      while (base + nt - J <= t) {
        base += nt - J;
        ++J;
      }
      const int I = J + t - base;
      T acc[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[q][u] = T(0);
      if (I == J) {
        for (int k = 0; k < nlim; ++k) {
          const int dof = -1 - ra[k] - 32 * I;
          const T mu = rc[k];
          const T wmu = s.w[k] * mu;
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (ry + 8 * q == dof && cx + 4 * u == dof) acc[q][u] += wmu * mu;
        }
      }
      for (int k = nlim; k < n; k += 4) {
        const T* jn = cv + ra[k];
        T ni[4], t1i[4], t2i[4], nj[8], t1j[8], t2j[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 32 * I + ry + 8 * q;
          const bool in = i < nv;
          ni[q] = in ? jn[i] : T(0);
          t1i[q] = in ? jn[nv + i] : T(0);
          t2i[q] = in ? jn[2 * nv + i] : T(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = 32 * J + cx + 4 * u;
          const bool in = j < nv;
          nj[u] = in ? jn[j] : T(0);
          t1j[u] = in ? jn[nv + j] : T(0);
          t2j[u] = in ? jn[2 * nv + j] : T(0);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const T mu = rc[k + p], w = s.w[k + p];
          T a[4], b[8];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = w * (ni[q] + mu * (p < 2 ? t1i[q] : t2i[q]));
#pragma unroll
          for (int u = 0; u < 8; ++u)
            b[u] = nj[u] + mu * (p < 2 ? t1j[u] : t2j[u]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 8; ++u) acc[q][u] += a[q] * b[u];
        }
      }
      T* tile = tiles + static_cast<long>(t) * kTileValues;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = ry + 8 * q, c = cx + 4 * u;
          const auto h = [&](int i, int j) {
            const T hij = s.M[i * nv + j] + acc[q][u];
            return i == j ? hij + reg : hij;
          };
          tile[tile_at<T>(r, c)] = ldl_tile_value<T>(I, J, r, c, nv, h);
        }
    }
  }
  __device__ void update(int k, T jar, T& f, T& c, T& w) const {
    row_update(jar, D[k], T(0), T(0), T(0), T(1), f, c, w);
  }
};


// (M·v)_i, M symmetric: by row i, or (kWide) by column i, which threads i,
// i + 1, ... read as one run
template <bool kWide, typename T>
__device__ inline T m_dot(const T* M, int nv, int i, const T* v) {
  T acc = T(0);
  if constexpr (kWide) {
    for (int j = 0; j < nv; ++j) acc += M[j * nv + i] * v[j];
  } else {
    for (int j = 0; j < nv; ++j) acc += M[i * nv + j] * v[j];
  }
  return acc;
}

// Σ_r cost_r(Jv − aref) + 0.5·(v − a_s)ᵀM(v − a_s) for v in shared memory;
// stores jar, force and w per row and dx, M·dx per dof. Every thread calls
// it and gets the total.
template <int kNT, bool kWide, typename T, class Rows>
__device__ T newton_objective(const Rows& rows, const NewtonWork<T>& s,
                              const T* v) {
  const int tid = threadIdx.x, nv = s.nv;
  T sum_rows = T(0), quad = T(0);
  if constexpr (kWide) {
    const int lane = tid & 31;
    for (int k = tid >> 5; k < rows.n; k += kNT / 32) {
      const T jar = rows.dot_warp(k, v, lane) - rows.aref[k];
      if (lane == 0) {
        T f, c, w;
        rows.update(k, jar, f, c, w);
        s.jar[k] = jar;
        s.force[k] = f;
        s.w[k] = w;
        sum_rows += c;
      }
    }
  } else {
    for (int k = tid; k < rows.n; k += kNT) {
      const T jar = rows.dot(k, v) - rows.aref[k];
      T f, c, w;
      rows.update(k, jar, f, c, w);
      s.jar[k] = jar;
      s.force[k] = f;
      s.w[k] = w;
      sum_rows += c;
    }
  }
  for (int i = tid; i < nv; i += kNT) s.dx[i] = v[i] - s.as[i];
  __syncthreads();
  for (int i = tid; i < nv; i += kNT) {
    const T acc = m_dot<kWide>(s.M, nv, i, s.dx);
    s.mdx[i] = acc;
    quad += s.dx[i] * acc;
  }
  block_sum2<kNT>(sum_rows, quad, s.red);
  return sum_rows + T(0.5) * quad;
}

// Shared memory of the wide solve's factor (block_ldl_solve): the stage of
// one panel where H's tiles are in device memory (else unused), and aux.
template <typename T>
struct TileWork {
  T* stage;
  T* aux;
};

// The whole solve by a block of kNT threads: on return s.x holds the
// solution, s.force the forces of its final row update and
// s.cost[0..iterations] the objective before each iteration and after the
// last. use_warm = false starts from a_s without the pick
// (DisableBit.WARMSTART in the megastep). Every thread of the block must
// call it; the results are visible to all threads on return.
//
// kWide (block_ldl_solve over tiles, kGlobalH: the tiles at s.H in device
// memory): s.y holds 32·⌈nv/32⌉ values, the tiles and tw are as
// block_ldl_solve takes them.
template <int kNT, typename T, class Rows, bool kWide = false,
          bool kGlobalH = false>
__device__ void block_newton(const Rows& rows, const NewtonWork<T>& s, T reg,
                             int iterations, int ls_iter, bool use_warm,
                             TileWork<T> tw = {}) {
  const int tid = threadIdx.x, n = rows.n, nv = s.nv, ld = s.ld;
  const T* start = s.as;
  // the objective at the warmstart is evaluated last, so that when the
  // warmstart wins the pick its rows and M·dx are those of x = start and
  // the first iteration reuses them and its cost
  bool have_start = false;
  T cost_start = T(0);
  if (use_warm) {
    const T cost_smooth = newton_objective<kNT, kWide>(rows, s, s.as);
    const T cost_warm = newton_objective<kNT, kWide>(rows, s, s.warm);
    if (cost_warm < cost_smooth) {
      start = s.warm;
      have_start = true;
      cost_start = cost_warm;
    }
  }
  for (int i = tid; i < nv; i += kNT) s.x[i] = start[i];
  if constexpr (kWide) {
    for (int i = nv + tid; i < 32 * ldl_tiles_per_side(nv); i += kNT)
      s.y[i] = T(0);
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    // jar, row update, M·(x − a_s) and the objective at x
    const T cost = it == 0 && have_start
                       ? cost_start
                       : newton_objective<kNT, kWide>(rows, s, s.x);
    if (tid == 0) s.cost[it] = cost;
    // right-hand side −grad = −(M(x − a_s) − Jᵀf)
    for (int i = tid; i < nv; i += kNT)
      s.y[i] = -(s.mdx[i] - rows.jtf(i, s.force));
    // H = M + Σ_r w_r J_rᵀ J_r + reg·I, lower triangle
    if constexpr (kWide) {
      const int nt = ldl_tiles_per_side(nv);
      rows.template build_h_tiles<kNT>(s, reg, s.H, nt);
      __syncthreads();
      block_ldl_solve<kNT, kGlobalH>(s.H, tw.stage, s.y, tw.aux, nv);
    } else {
      rows.template build_h<kNT>(s, reg);
      __syncthreads();
      if (tid < 32) warp_ldl_solve(s.H, ld, s.y, nv, tid);
      __syncthreads();
    }
    // linesearch inputs: jp = J p, gx0 = pᵀM(x − a_s), pmp = pᵀMp
    if constexpr (kWide) {
      const int lane = tid & 31;
      for (int k = tid >> 5; k < n; k += kNT / 32) {
        const T jp = rows.dot_warp(k, s.y, lane);
        if (lane == 0) s.jp[k] = jp;
      }
    } else {
      for (int k = tid; k < n; k += kNT) s.jp[k] = rows.dot(k, s.y);
    }
    T gx0 = T(0), pmp = T(0);
    for (int i = tid; i < nv; i += kNT) {
      const T acc = m_dot<kWide>(s.M, nv, i, s.y);
      gx0 += s.y[i] * s.mdx[i];
      pmp += s.y[i] * acc;
    }
    block_sum2<kNT>(gx0, pmp, s.red);

    T lo = T(0), hi = T(INFINITY), alpha = T(0);
    bool has_hi = false;
    for (int l = 0; l < ls_iter; ++l) {
      T jpf = T(0), curv = T(0);
      for (int k = tid; k < n; k += kNT) {
        T f, c, w;
        rows.update(k, s.jar[k] + alpha * s.jp[k], f, c, w);
        jpf += s.jp[k] * f;
        curv += w * s.jp[k] * s.jp[k];
      }
      block_sum2<kNT>(jpf, curv, s.red);
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
    for (int i = tid; i < nv; i += kNT) s.x[i] += alpha * s.y[i];
    __syncthreads();
  }

  // final row update at the solution
  const T cost_final = newton_objective<kNT, kWide>(rows, s, s.x);
  if (tid == 0) s.cost[iterations] = cost_final;
  __syncthreads();
}

}  // namespace mjt
