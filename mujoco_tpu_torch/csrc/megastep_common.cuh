// The megastep's step, work space and kernel template, shared by the
// sources that instantiate its routes (megastep.cu: the narrow route;
// megastep_wide_device_f32.cu and _f64.cu: the wide route, one source per
// dtype), so that nvcc builds them in parallel. megastep.cu describes the design.
#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <string.h>

#include "newton_common.cuh"

namespace mjt {
namespace {

// One int per name of META_FIELDS in mujoco_tpu_torch/ops/megastep_cuda.py,
// in that order: counts, then the offset of each int table, then the
// offset of each value table.
struct Meta {
  int nq, nv, nu, nbody, njnt, nl, ncon, ngroup, nfree, nefc, nlevel,
      nlist, iterations, ls_iter, flags;
  int i_body_parent, i_body_jntadr, i_body_jntnum, i_body_root, i_jnt_type,
      i_jnt_qadr, i_jnt_dadr, i_dof_jnt, i_dof_body, i_dof_q, i_dof_root,
      i_dof_spring_q, i_anc, i_danc, i_pred, i_free_qadr, i_free_dadr,
      i_act_dadr, i_act_flags, i_lim_qadr, i_lim_dadr, i_lim_pow, i_con_pow,
      i_con_group, i_grp_type, i_grp_b1, i_grp_b2, i_grp_slot, i_grp_mask,
      i_lvl_adr, i_lvl_body, i_child_adr, i_child, i_bdof_adr, i_bdof,
      i_pdof_adr, i_pdof, i_dbody_adr, i_dbody, i_dact_adr, i_dact;
  int f_scal, f_body_pos, f_body_quat, f_body_ipos, f_body_iquat,
      f_body_mass, f_body_inertia, f_body_subtreemass, f_jnt_axis, f_jnt_pos,
      f_jnt_qpos0, f_dof_armature, f_dof_damping, f_dof_spring_k,
      f_dof_spring_ref, f_act_gain, f_act_gear, f_act_ctrlrange,
      f_act_forcerange, f_lim_side, f_lim_value, f_lim_margin, f_lim_kb,
      f_lim_diaga, f_lim_imp, f_con_margin, f_con_fri, f_con_kb, f_con_rpy,
      f_con_diaga, f_con_imp, f_grp_geom;
};

// Meta.flags
constexpr int kSpringOff = 1, kDamperOff = 2, kActuationOff = 4,
              kClampCtrlOff = 8, kLimitOff = 16, kContactOff = 32,
              kUseWarm = 64, kUseDamp = 128;

// The stage clock. The timed instantiation of the kernel (kTimed) has
// thread 0 read clock64() right after the block barrier that ends each
// stage of step(), and sums the deltas per stage over the launch; the
// untimed one, which the main path launches, has no clock code. Stages in
// step() order (megastep_cuda.STAGES lists the same names):
enum Stage {
  kFk,      // quaternion normalize, hinge sin/cos, FK and frames
  kCom,     // subtree CoM
  kCinert,  // cinert, cdof, CRB
  kVel,     // com_vel, cdof_dot, cacc, u
  kRne,     // qM (and H for a_s), RNE and xfrc forces
  kForce,   // bias and xfrc projections, passive, motor forces (and the
            // wide route's tiles of H for a_s)
  kSmooth,  // qfrc_actuator, qfrc_smooth, a_s by LDL (warp 0; the wide
            // route: the block)
  kRows,    // narrowphase, limit and contact rows (warp 1 alongside the
            // LDL, only what outlasts it; the wide route: the block
            // after it)
  kNewton,  // Newton solve, qfrc_constraint
  kEuler,   // Euler, divergence guard
  kNumStages
};
constexpr const char* kStageNames[kNumStages] = {
    "fk", "com", "cinert", "vel", "rne", "force", "smooth", "rows", "newton",
    "euler"};
// Per env, the timed launch writes kNumStages cycle sums, then the active
// constraint rows summed over its steps, their most in one step, and the
// active contact slots summed over its steps.
constexpr int kStatWords = kNumStages + 3;

template <bool kTimed>
struct StageClock {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void rows(int, int) {}
};

template <>
struct StageClock<true> {
  long long* sum;  // shared, kStatWords
  long long last;  // thread 0's last reading
  __device__ void start() { last = clock64(); }
  __device__ void mark(int stage) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      sum[stage] += now - last;
      last = now;
    }
  }
  __device__ void rows(int nrow, int nslot) {
    if (threadIdx.x == 0) {
      sum[kNumStages] += nrow;
      if (nrow > sum[kNumStages + 1]) sum[kNumStages + 1] = nrow;
      sum[kNumStages + 2] += nslot;
    }
  }
};

// joint types
constexpr int kFree = 0, kSlide = 2, kHinge = 3;
constexpr double kMaxVal = 1e10;  // mjMAXVAL

// Threads of a block on the narrow route: two warps, one env. One warp has
// no second warp to build the rows alongside the LDL; more warps leave
// fewer registers for the same 8 envs per SM.
constexpr int kMT = 64;
static_assert(kMT == 64, "step() gives warp 0 and warp 1 a task each");

// The kernel's routes, which the host picks per (Model, dtype)
// (megastep_cuda.route):
// - kNarrow (nv ≤ 64, the work space within a block's shared memory): kMT
//   threads, the LDL solves in one warp's registers, warp 1 building the
//   constraint rows while warp 0 solves a_s;
// - kWideDevice (nv > 64, or a narrow work space past a block's shared
//   memory): one block of kWideThreads (8 warps) per env, as the Newton
//   kernel's wide route (newton.cu): both LDL solves by the blocked LDLᵀ
//   over H as 32×32 tiles (block_ldl_solve), the Newton solve with H built
//   as those tiles (ListRows::build_h_tiles), the rows built by the whole
//   block after the a_s solve, which needs every thread. qM, H's tiles,
//   cinert and the CRB, the contacts, the slots' vectors and the row
//   vectors live in a per-env slice of device memory that the caller
//   allocates (mjt_megastep_work_values says its size); the small per-step
//   vectors stay in shared memory, and the factor stages each panel there.
enum Route { kNarrow = 0, kWideDevice = 1 };
constexpr int kWideThreads = 256;

template <int kRoute>
struct RouteOf {
  static constexpr bool kWide = kRoute != kNarrow;
  static constexpr int kThreads = kWide ? kWideThreads : kMT;
};

// Work space of one env's step, in three parts: what lives the whole step;
// what only the smooth dynamics needs (up to a_s); what only the
// constraints need (from the narrowphase on; on kWideDevice, the stage of
// the factor's panel first), which overlays the second part. All of it in
// shared memory but, on kWideDevice, the fields that layout() takes with
// take_big.
template <typename T>
struct Work {
  T *qpos, *qvel, *ctrl, *warm, *qacc, *qfrc_app, *xfrc, *time;
  T *xpos, *xquat, *com, *cdof, *qM, *H;
  // the wide route's factor: its aux (D, 1/D and z of a panel) and the
  // stage of one panel (nt tiles)
  T *aux, *stage;
  T *smooth, *as, *qc, *x, *dx, *mdx, *y, *red, *cost;
  // the compact tree lists (i_lvl_adr .. i_dact, nlist values), copied in
  // once per launch: the tree passes walk them every step
  unsigned short* lists;
  // smooth dynamics
  T *jsc, *xipos, *ximat, *xanchor, *xaxis, *macc, *cinert, *crb;
  T *cdofdot, *cvel, *cacc, *fall, *f6, *u, *bias, *passive, *qx, *actf;
  // constraints: the narrowphase's contacts, each active slot's normal and
  // tangent vectors (cv), and per row of the active list its ListRows
  // fields (ra, rb, rc, aref, D) and the solve's row vectors
  T *cdist, *cpos, *cframe, *cv, *rc, *aref, *D, *jar, *jp, *force, *w;
  int *ra, *rb, *aslot, *cnt;  // cnt: active limit rows, active slots
};

// Carves the work space of route (w given): shared memory from base and,
// on kWideDevice, device memory from gbase (the env's slice). Returns the
// shared size in values and sets *gsize to the slice's size in values,
// rounded up to 16 bytes (0 on kNarrow); the host calls it with w null.
// The wide route's tiles (in device memory) and aux and the stage (in
// shared memory) start at 16-byte boundaries, as block_ldl_solve's 16-byte
// accesses need.
template <typename T>
__host__ __device__ size_t layout(const Meta& mt, int route, T* base,
                                  T* gbase, Work<T>* w,
                                  size_t* gsize = nullptr) {
  Work<T> unused;
  Work<T>& s = w ? *w : unused;
  const bool wide = route != kNarrow;
  size_t off = 0, goff = 0;
  auto take = [&](T*& dst, size_t n) {
    dst = base ? base + off : nullptr;
    off += n;
  };
  auto take_int = [&](int*& dst, size_t n) {
    dst = base ? reinterpret_cast<int*>(base + off) : nullptr;
    off += (n * sizeof(int) + sizeof(T) - 1) / sizeof(T);
  };
  // a field that kWideDevice keeps in device memory
  auto take_big = [&](T*& dst, size_t n) {
    if (!wide) return take(dst, n);
    dst = gbase ? gbase + goff : nullptr;
    goff += n;
  };
  auto take_big_int = [&](int*& dst, size_t n) {
    if (!wide) return take_int(dst, n);
    dst = gbase ? reinterpret_cast<int*>(gbase + goff) : nullptr;
    goff += (n * sizeof(int) + sizeof(T) - 1) / sizeof(T);
  };
  constexpr size_t kAlign = 16 / sizeof(T);
  const size_t nq = mt.nq, nv = mt.nv, nb = mt.nbody, nj = mt.njnt;
  const size_t nu = mt.nu > 0 ? mt.nu : 1, ncon = mt.ncon, nefc = mt.nefc;
  const size_t nt = ldl_tiles_per_side(mt.nv);
  // a_s and y are block_ldl_solve's right-hand sides on the wide route:
  // 32·nt values, 0 past nv
  const size_t nvpad = wide ? 32 * nt : nv;
  if (wide) {
    take(s.aux, kLdlAuxValues);
    take_big(s.H, static_cast<size_t>(ldl_tile_count(mt.nv)) * kTileValues);
  }
  take(s.qpos, nq);
  take(s.qvel, nv);
  take(s.ctrl, nu);
  take(s.warm, nv);
  take(s.qacc, nv);
  take(s.qfrc_app, nv);
  take(s.xfrc, 6 * nb);
  take(s.time, 2);
  take(s.xpos, 3 * nb);
  take(s.xquat, 4 * nb);
  take(s.com, 3 * nb);
  take(s.cdof, 6 * nv);
  take_big(s.qM, nv * nv);
  if (!wide) take(s.H, nv * static_cast<size_t>(ldl_ld(mt.nv)));
  T** dofvec[] = {&s.smooth, &s.as, &s.qc, &s.x, &s.dx, &s.mdx, &s.y};
  for (T** p : dofvec) take(*p, p == &s.as || p == &s.y ? nvpad : nv);
  take(s.red, 64);
  take(s.cost, kStatRows + 1);
  s.lists = base ? reinterpret_cast<unsigned short*>(base + off) : nullptr;
  off += (mt.nlist * sizeof(unsigned short) + sizeof(T) - 1) / sizeof(T);
  const size_t whole_step = off;

  take(s.jsc, 2 * nj);
  take(s.xipos, 3 * nb);
  take(s.ximat, 9 * nb);
  take(s.xanchor, 3 * nj);
  take(s.xaxis, 3 * nj);
  take(s.macc, 3 * nb);
  take_big(s.cinert, 36 * nb);
  take_big(s.crb, 36 * nb);
  take(s.cdofdot, 6 * nv);
  take(s.cvel, 6 * nb);
  take(s.cacc, 6 * nb);
  take(s.fall, 6 * nb);
  take(s.f6, 6 * nb);
  take(s.u, 6 * nv);
  T** smoothvec[] = {&s.bias, &s.passive, &s.qx};
  for (T** p : smoothvec) take(*p, nv);
  take(s.actf, nu);
  const size_t smooth_end = off;

  off = whole_step;
  s.stage = nullptr;
  if (wide) {
    off = (off + kAlign - 1) / kAlign * kAlign;
    take(s.stage, nt * kTileValues);
  }
  take_big(s.cdist, ncon);
  take_big(s.cpos, 3 * ncon);
  take_big(s.cframe, 9 * ncon);
  take_big(s.cv, 3 * nv * ncon);
  T** rowvec[] = {&s.rc, &s.aref, &s.D, &s.jar, &s.jp, &s.force, &s.w};
  for (T** p : rowvec) take_big(*p, nefc);
  take_big_int(s.ra, nefc);
  take_big_int(s.rb, nefc);
  take_int(s.aslot, ncon);
  take_int(s.cnt, 2);
  if (gsize) *gsize = (goff * sizeof(T) + 15) / 16 * 16 / sizeof(T);
  return off > smooth_end ? off : smooth_end;
}

// ---- per-thread vector math, as the reference's lane math (:374-425):
// normalization multiplies by the reciprocal norm

template <typename T>
__device__ inline T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ inline void cross3(const T* a, const T* b, T* o) {
  const T o0 = a[1] * b[2] - a[2] * b[1];
  const T o1 = a[2] * b[0] - a[0] * b[2];
  const T o2 = a[0] * b[1] - a[1] * b[0];
  o[0] = o0;
  o[1] = o1;
  o[2] = o2;
}

template <typename T>
__device__ inline void qmul(const T* q, const T* p, T* o) {
  const T w = q[0] * p[0] - q[1] * p[1] - q[2] * p[2] - q[3] * p[3];
  const T x = q[0] * p[1] + q[1] * p[0] + q[2] * p[3] - q[3] * p[2];
  const T y = q[0] * p[2] - q[1] * p[3] + q[2] * p[0] + q[3] * p[1];
  const T z = q[0] * p[3] + q[1] * p[2] - q[2] * p[1] + q[3] * p[0];
  o[0] = w;
  o[1] = x;
  o[2] = y;
  o[3] = z;
}

template <typename T>
__device__ inline void qnorm(T* q) {
  T n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const T lo = T(kMinVal) * T(kMinVal);
  n2 = n2 < lo ? lo : n2;
  const T inv = T(1) / sqrt(n2);
  for (int k = 0; k < 4; ++k) q[k] *= inv;
}

// v·(1/|v|) in place; returns |v| (clamped)
template <typename T>
__device__ inline T norm3(T* v) {
  T n2 = dot3(v, v);
  const T lo = T(kMinVal) * T(kMinVal);
  n2 = n2 < lo ? lo : n2;
  const T n = sqrt(n2);
  const T inv = T(1) / n;
  for (int k = 0; k < 3; ++k) v[k] *= inv;
  return n;
}

// v + 2 r × (r × v + w v)
template <typename T>
__device__ inline void qrot(const T* v, const T* q, T* o) {
  T c1[3], c2[3];
  cross3(q + 1, v, c1);
  for (int k = 0; k < 3; ++k) c1[k] += q[0] * v[k];
  cross3(q + 1, c1, c2);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + T(2) * c2[k];
}

template <typename T>
__device__ inline void qmat(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = T(1) - T(2) * (yy + zz);
  R[1] = T(2) * (xy - wz);
  R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz);
  R[4] = T(1) - T(2) * (xx + zz);
  R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy);
  R[7] = T(2) * (yz + wx);
  R[8] = T(1) - T(2) * (xx + yy);
}

// clip that keeps a NaN, as jnp.clip does
template <typename T>
__device__ inline T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// max(lo, x) that keeps a NaN, as jnp.maximum does
template <typename T>
__device__ inline T max_keep_nan(T lo, T x) {
  return x < lo ? lo : x;
}

// ---- the impedance sigmoid (_impedance_lane :448); p holds d0, dw,
// dw − d0, width, mid, a, b, power and (d0 + dw)/2, computed on the host.
// The power takes the reference's integer fast path (:461-469): codes 2-4
// multiply, they never call pow.
template <typename T>
__device__ inline T powp(T v, int code, T power) {
  if (code >= 2 && code <= 4) {
    T out = v;
    for (int k = 1; k < code; ++k) out = out * v;
    return out;
  }
  return exp(power * log(max_keep_nan(T(kMinVal), v)));
}

template <typename T>
__device__ T impedance(T pos, T margin, const T* p, int code) {
  if (code == 0) return p[8];
  const T x_raw = (pos - margin) / p[3];
  const T ax = fabs(x_raw);
  const T x = clip(ax, T(0), T(1));
  T y;
  if (code == 1) {
    y = x;
  } else {
    y = x <= p[4] ? p[5] * powp(x, code, p[7])
                  : T(1) - p[6] * powp(T(1) - x, code, p[7]);
  }
  T imp = p[0] + y * p[2];
  if (ax >= T(1)) {
    imp = p[1];
  } else if (ax <= T(0)) {
    imp = p[0];
  }
  return imp;
}

// ---- narrowphase (one thread per contact group)

// frame rows [n; y; z] from a normal and an optional tangent
// (_make_frame_lane :648)
template <typename T>
__device__ void make_frame(const T* normal, const T* tangent, T* f) {
  T n[3] = {normal[0], normal[1], normal[2]};
  norm3(n);
  T y[3];
  if (tangent) {
    y[0] = tangent[0];
    y[1] = tangent[1];
    y[2] = tangent[2];
  } else {
    const bool small = fabs(n[1]) < T(0.5);
    y[0] = T(0);
    y[1] = small ? T(1) : T(0);
    y[2] = small ? T(0) : T(1);
  }
  const T ndoty = dot3(n, y);
  for (int k = 0; k < 3; ++k) y[k] = y[k] - n[k] * ndoty;
  norm3(y);
  T z[3];
  cross3(n, y, z);
  for (int k = 0; k < 3; ++k) {
    f[k] = n[k];
    f[3 + k] = y[k];
    f[6 + k] = z[k];
  }
}

template <typename T>
__device__ inline void emit(const Work<T>& s, int c, T dist, const T* pos,
                            const T* normal, const T* tangent) {
  s.cdist[c] = dist;
  for (int k = 0; k < 3; ++k) s.cpos[3 * c + k] = pos[k];
  make_frame(normal, tangent, s.cframe + 9 * c);
}

// sphere-sphere at explicit centers; coincident centers take the normal
// normalize(ax1 × ax2) (sphere_sphere_lane :1033)
template <typename T>
__device__ void sphere_sphere(const T* c1, T r1, const T* c2, T r2,
                              const T* ax1, const T* ax2, T& dist, T* pos,
                              T* nrm) {
  T dif[3];
  for (int k = 0; k < 3; ++k) dif[k] = c2[k] - c1[k];
  T l2 = dot3(dif, dif);
  const T lo = T(kMinVal) * T(kMinVal);
  l2 = l2 < lo ? lo : l2;
  const T len = sqrt(l2);
  T alt[3];
  cross3(ax1, ax2, alt);
  norm3(alt);
  const bool use_alt = len < T(1e-9);
  for (int k = 0; k < 3; ++k) nrm[k] = use_alt ? alt[k] : dif[k] / len;
  dist = len - r1 - r2;
  for (int k = 0; k < 3; ++k) pos[k] = c1[k] + nrm[k] * (r1 + dist / T(2));
}

template <typename T>
__device__ void collide_group(const Meta& mt, const int* ic, const T* fc,
                              const Work<T>& s, int g) {
  const int code = ic[mt.i_grp_type + g];
  const int b1 = ic[mt.i_grp_b1 + g], b2 = ic[mt.i_grp_b2 + g];
  const int slot = ic[mt.i_grp_slot + g];
  const T* geo = fc + mt.f_grp_geom + 20 * g;
  const T* s1 = geo + 14;
  const T* s2 = geo + 17;
  T q1[4], q2[4], p1[3], p2[3], tmp[3];
  qmul(s.xquat + 4 * b1, geo + 3, q1);
  qmul(s.xquat + 4 * b2, geo + 10, q2);
  qrot(geo, s.xquat + 4 * b1, tmp);
  for (int k = 0; k < 3; ++k) p1[k] = s.xpos[3 * b1 + k] + tmp[k];
  qrot(geo + 7, s.xquat + 4 * b2, tmp);
  for (int k = 0; k < 3; ++k) p2[k] = s.xpos[3 * b2 + k] + tmp[k];
  const T ez[3] = {T(0), T(0), T(1)};

  if (code <= 2) {  // plane vs sphere, capsule or box
    T n[3];
    qrot(ez, q1, n);
    if (code == 2) {
      // all 8 corners, the 4 deepest kept in stable-argsort order: rank_i =
      // #{j < i: d_j <= d_i} + #{j > i: d_j < d_i}, so ties keep the lower
      // corner index (:1102-1122)
      T corner[8][3], d[8];
      int i = 0;
      for (int sx = -1; sx <= 1; sx += 2) {
        for (int sy = -1; sy <= 1; sy += 2) {
          for (int sz = -1; sz <= 1; sz += 2, ++i) {
            const T off[3] = {T(sx) * s2[0], T(sy) * s2[1], T(sz) * s2[2]};
            qrot(off, q2, tmp);
            T rel[3];
            for (int k = 0; k < 3; ++k) {
              corner[i][k] = p2[k] + tmp[k];
              rel[k] = corner[i][k] - p1[k];
            }
            d[i] = dot3(rel, n);
          }
        }
      }
      for (int sl = 0; sl < 4; ++sl) {
        T dist = T(0), pos[3] = {T(0), T(0), T(0)};
        for (int a = 0; a < 8; ++a) {
          int rank = 0;
          for (int b = 0; b < 8; ++b) {
            if (b < a) rank += d[b] <= d[a];
            if (b > a) rank += d[b] < d[a];
          }
          if (rank == sl) {
            dist = d[a];
            for (int k = 0; k < 3; ++k)
              pos[k] = corner[a][k] - T(0.5) * d[a] * n[k];
          }
        }
        emit(s, slot + sl, dist, pos, n, static_cast<const T*>(nullptr));
      }
      return;
    }
    const T r = s2[0];
    T axis[3], centers[2][3];
    int npt = 1;
    for (int k = 0; k < 3; ++k) centers[0][k] = p2[k];
    if (code == 1) {  // the capsule's two end spheres, tangent its axis
      qrot(ez, q2, axis);
      npt = 2;
      for (int k = 0; k < 3; ++k) {
        centers[0][k] = p2[k] + axis[k] * s2[1];
        centers[1][k] = p2[k] - axis[k] * s2[1];
      }
    }
    for (int c = 0; c < npt; ++c) {
      T rel[3], pos[3];
      for (int k = 0; k < 3; ++k) rel[k] = centers[c][k] - p1[k];
      const T dist = dot3(rel, n) - r;
      for (int k = 0; k < 3; ++k)
        pos[k] = centers[c][k] + n[k] * (-dist / T(2) - r);
      emit(s, slot + c, dist, pos, n, code == 1 ? axis : nullptr);
    }
    return;
  }
  T ax1[3], ax2[3], dist, pos[3], nrm[3];
  qrot(ez, q1, ax1);
  qrot(ez, q2, ax2);
  if (code == 3) {  // sphere-sphere
    sphere_sphere(p1, s1[0], p2, s2[0], ax1, ax2, dist, pos, nrm);
    emit(s, slot, dist, pos, nrm, static_cast<const T*>(nullptr));
    return;
  }
  if (code == 4) {  // sphere-capsule
    T rel[3], nearest[3];
    for (int k = 0; k < 3; ++k) rel[k] = p1[k] - p2[k];
    const T x = clip(dot3(ax2, rel), -s2[1], s2[1]);
    for (int k = 0; k < 3; ++k) nearest[k] = p2[k] + ax2[k] * x;
    sphere_sphere(p1, s1[0], nearest, s2[0], ax1, ax2, dist, pos, nrm);
    emit(s, slot, dist, pos, nrm, static_cast<const T*>(nullptr));
    return;
  }
  if (code == 5) {
    // sphere-box: closest point of the box; a center inside pushes out
    // along the shallowest face, the first index on ties (the argmin of
    // :1157-1159)
    const T r1 = s1[0];
    T dp[3], c[3], cl[3], dif[3];
    for (int k = 0; k < 3; ++k) dp[k] = p1[k] - p2[k];
    const T qc[4] = {q2[0], -q2[1], -q2[2], -q2[3]};
    qrot(dp, qc, c);
    bool inside = true;
    for (int k = 0; k < 3; ++k) {
      cl[k] = clip(c[k], -s2[k], s2[k]);
      inside = inside && fabs(c[k]) < s2[k];
      dif[k] = c[k] - cl[k];
    }
    T l2 = dot3(dif, dif);
    const T lo = T(kMinVal) * T(kMinVal);
    l2 = l2 < lo ? lo : l2;
    const T len_out = sqrt(l2);
    T fd[3], sgn[3];
    for (int k = 0; k < 3; ++k) {
      fd[k] = s2[k] - fabs(c[k]);
      sgn[k] = T((c[k] > T(0)) - (c[k] < T(0)));
    }
    const bool a0 = fd[0] <= fd[1] && fd[0] <= fd[2];
    const bool a1 = !a0 && fd[1] <= fd[2];
    const bool am[3] = {a0, a1, !a0 && !a1};
    const T fd_min = a0 ? fd[0] : (a1 ? fd[1] : fd[2]);
    dist = inside ? -(fd_min + r1) : len_out - r1;
    T n_box[3], nw[3];
    for (int k = 0; k < 3; ++k)
      n_box[k] = inside ? (am[k] ? sgn[k] : T(0)) : dif[k] / len_out;
    qrot(n_box, q2, nw);
    for (int k = 0; k < 3; ++k) {
      nrm[k] = -nw[k];
      pos[k] = p1[k] + nrm[k] * (r1 + dist / T(2));
    }
    emit(s, slot, dist, pos, nrm, static_cast<const T*>(nullptr));
    return;
  }
  // capsule-capsule: segment-segment closest points; the parallel case
  // emits 2 contacts (:1174-1257)
  const T r1 = s1[0], r2 = s2[0];
  T a1[3], a2[3], dif[3];
  for (int k = 0; k < 3; ++k) {
    a1[k] = ax1[k] * s1[1];
    a2[k] = ax2[k] * s2[1];
    dif[k] = p1[k] - p2[k];
  }
  const T ma = dot3(a1, a1), mb = -dot3(a1, a2), mc = dot3(a2, a2);
  const T u = -dot3(a1, dif), v = dot3(a2, dif);
  const T det = ma * mc - mb * mb;
  const bool parallel = fabs(det) < T(kMinVal);
  const T safe = parallel ? T(1) : det;
  T x1 = (mc * u - mb * v) / safe;
  T x2 = (ma * v - mb * u) / safe;
  x2 = x1 > T(1) ? (v - mb) / mc : (x1 < T(-1) ? (v + mb) / mc : x2);
  x1 = clip(x1, T(-1), T(1));
  x1 = x2 > T(1) ? clip((u - mb) / ma, T(-1), T(1))
                 : (x2 < T(-1) ? clip((u + mb) / ma, T(-1), T(1)) : x1);
  x2 = clip(x2, T(-1), T(1));
  T g_d, g_p[3], g_n[3], e1[3], e2[3];
  for (int k = 0; k < 3; ++k) {
    e1[k] = p1[k] + a1[k] * x1;
    e2[k] = p2[k] + a2[k] * x2;
  }
  sphere_sphere(e1, r1, e2, r2, ax1, ax2, g_d, g_p, g_n);
  if (!parallel) {
    emit(s, slot, g_d, g_p, g_n, static_cast<const T*>(nullptr));
    // the second slot carries the 1e10 placeholder: never active
    emit(s, slot + 1, T(1e10), g_p, g_n, static_cast<const T*>(nullptr));
    return;
  }
  // parallel: the 4 endpoint candidates in order; slot s takes the
  // (s+1)-th that touches (dist < 0), else candidate 0's position and
  // normal with candidate 0's distance (s = 0) or the 1e10 placeholder
  // (s = 1), as the reference's sequential early exit
  const T xs[4] = {clip((v - mb) / mc, T(-1), T(1)),
                   clip((v + mb) / mc, T(-1), T(1)),
                   clip((u - mb) / ma, T(-1), T(1)),
                   clip((u + mb) / ma, T(-1), T(1))};
  T cd[4], cp[4][3], cn[4][3];
  for (int c = 0; c < 4; ++c) {
    for (int k = 0; k < 3; ++k) {
      if (c < 2) {
        e1[k] = p1[k] + (c == 0 ? a1[k] : -a1[k]);
        e2[k] = p2[k] + a2[k] * xs[c];
      } else {
        e1[k] = p1[k] + a1[k] * xs[c];
        e2[k] = p2[k] + (c == 2 ? a2[k] : -a2[k]);
      }
    }
    sphere_sphere(e1, r1, e2, r2, ax1, ax2, cd[c], cp[c], cn[c]);
  }
  int found = 0;
  int pick[2] = {-1, -1};
  for (int c = 0; c < 4; ++c) {
    if (cd[c] < T(0)) {
      if (found < 2) pick[found] = c;
      ++found;
    }
  }
  for (int sl = 0; sl < 2; ++sl) {
    const int c = pick[sl];
    const T d = c >= 0 ? cd[c] : (sl == 0 ? cd[0] : T(1e10));
    const int src = c >= 0 ? c : 0;
    emit(s, slot + sl, d, cp[src], cn[src], static_cast<const T*>(nullptr));
  }
}

// The contact Jacobian of slot c at dof v, projected on the slot's frame:
// jacp = cdof_lin + cdof_ang × (pos − com of the dof's tree), times the
// group's ±1/0 body-chain mask (:1279-1289).
template <typename T>
__device__ inline void contact_jac(const Meta& mt, const int* ic,
                                   const Work<T>& s, int c, int v, T& jn,
                                   T& jt1, T& jt2) {
  const int g = ic[mt.i_con_group + c];
  const T cm = T(ic[mt.i_grp_mask + g * mt.nv + v]);
  const T* o = s.com + 3 * ic[mt.i_dof_root + v];
  const T* cd = s.cdof + 6 * v;
  T rel[3], jac[3];
  for (int k = 0; k < 3; ++k) rel[k] = s.cpos[3 * c + k] - o[k];
  cross3(cd, rel, jac);
  for (int k = 0; k < 3; ++k) jac[k] = cd[3 + k] + jac[k];
  const T* f = s.cframe + 9 * c;
  jn = dot3(jac, f) * cm;
  jt1 = dot3(jac, f + 3) * cm;
  jt2 = dot3(jac, f + 6) * cm;
}

// ---- the tree passes of one body

// FK of body b from its parent's frame: hinges rotate by the half-angle of
// qpos − qpos0 (:762-767), whose sine and cosine s.jsc holds; then b's
// inertial frame and its mass-weighted CoM, the start of the subtree pass.
template <typename T>
__device__ void fk_body(const Meta& mt, const int* __restrict__ ic,
                        const T* __restrict__ fc, const Work<T>& s, int b) {
  if (b == 0) {
    for (int k = 0; k < 3; ++k) s.xpos[k] = T(0);
    s.xquat[0] = T(1);
    s.xquat[1] = s.xquat[2] = s.xquat[3] = T(0);
  } else {
    const int pid = ic[mt.i_body_parent + b];
    const T* pq = s.xquat + 4 * pid;
    T bq[4], bp[3];
    qmul(pq, fc + mt.f_body_quat + 4 * b, bq);
    qnorm(bq);
    qrot(fc + mt.f_body_pos + 3 * b, pq, bp);
    for (int k = 0; k < 3; ++k) bp[k] += s.xpos[3 * pid + k];
    const int j0 = ic[mt.i_body_jntadr + b];
    for (int j = j0; j < j0 + ic[mt.i_body_jntnum + b]; ++j) {
      const int jt = ic[mt.i_jnt_type + j], qa = ic[mt.i_jnt_qadr + j];
      const T* ax = fc + mt.f_jnt_axis + 3 * j;
      const T* jpos = fc + mt.f_jnt_pos + 3 * j;
      T* xanchor = s.xanchor + 3 * j;
      T* xaxis = s.xaxis + 3 * j;
      if (jt == kFree) {
        for (int k = 0; k < 3; ++k) {
          bp[k] = s.qpos[qa + k];
          xanchor[k] = bp[k];
          xaxis[k] = ax[k];
        }
        for (int k = 0; k < 4; ++k) bq[k] = s.qpos[qa + 3 + k];
        qnorm(bq);
        continue;
      }
      T axis_w[3], jpos_w[3], anchor[3];
      qrot(ax, bq, axis_w);
      qrot(jpos, bq, jpos_w);
      for (int k = 0; k < 3; ++k) anchor[k] = bp[k] + jpos_w[k];
      if (jt == kSlide) {
        const T dq = s.qpos[qa] - fc[mt.f_jnt_qpos0 + j];
        for (int k = 0; k < 3; ++k) bp[k] = bp[k] + axis_w[k] * dq;
      } else {
        const T sn = s.jsc[2 * j], cs = s.jsc[2 * j + 1];
        const T qloc[4] = {cs, ax[0] * sn, ax[1] * sn, ax[2] * sn};
        qmul(bq, qloc, bq);
        qrot(jpos, bq, jpos_w);
        for (int k = 0; k < 3; ++k) bp[k] = anchor[k] - jpos_w[k];
      }
      for (int k = 0; k < 3; ++k) {
        xanchor[k] = anchor[k];
        xaxis[k] = axis_w[k];
      }
    }
    qnorm(bq);
    for (int k = 0; k < 3; ++k) s.xpos[3 * b + k] = bp[k];
    for (int k = 0; k < 4; ++k) s.xquat[4 * b + k] = bq[k];
  }
  T r[3], q[4];
  qrot(fc + mt.f_body_ipos + 3 * b, s.xquat + 4 * b, r);
  for (int k = 0; k < 3; ++k) s.xipos[3 * b + k] = s.xpos[3 * b + k] + r[k];
  qmul(s.xquat + 4 * b, fc + mt.f_body_iquat + 4 * b, q);
  qmat(q, s.ximat + 9 * b);
  const T mass = fc[mt.f_body_mass + b];
  for (int k = 0; k < 3; ++k) s.macc[3 * b + k] = s.xipos[3 * b + k] * mass;
}

// cinert of body b (angular first, mju_inertCom)
template <typename T>
__device__ void cinert_body(const Meta& mt, const int* __restrict__ ic,
                            const T* __restrict__ fc, const Work<T>& s,
                            int b) {
  T* ci = s.cinert + 36 * b;
  if (b == 0) {
    for (int e = 0; e < 36; ++e) ci[e] = T(0);
    return;
  }
  const T* R = s.ximat + 9 * b;
  const T* I = fc + mt.f_body_inertia + 3 * b;
  const T mass = fc[mt.f_body_mass + b];
  const int root = ic[mt.i_body_root + b];
  const T o[3] = {s.xipos[3 * b] - s.com[3 * root],
                  s.xipos[3 * b + 1] - s.com[3 * root + 1],
                  s.xipos[3 * b + 2] - s.com[3 * root + 2]};
  const T cx[3][3] = {{T(0), -o[2], o[1]},
                      {o[2], T(0), -o[0]},
                      {-o[1], o[0], T(0)}};
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) {
      T icom = T(0), cc = T(0);
      for (int k = 0; k < 3; ++k) {
        icom += R[3 * a + k] * I[k] * R[3 * c + k];
        cc += cx[a][k] * cx[c][k];
      }
      ci[6 * a + c] = icom + mass * cc;
      ci[6 * a + 3 + c] = mass * cx[a][c];
      ci[6 * (3 + a) + c] = mass * cx[c][a];
      ci[6 * (3 + a) + 3 + c] = a == c ? mass : T(0);
    }
  }
}

// cdof of dof v
template <typename T>
__device__ void cdof_dof(const Meta& mt, const int* __restrict__ ic,
                         const Work<T>& s, int v) {
  const int j = ic[mt.i_dof_jnt + v], b = ic[mt.i_dof_body + v];
  const int jt = ic[mt.i_jnt_type + j];
  const int din = v - ic[mt.i_jnt_dadr + j];
  const T* rc = s.com + 3 * ic[mt.i_dof_root + v];
  T* cd = s.cdof + 6 * v;
  T ax[3], offca[3];
  if (jt == kSlide || (jt == kFree && din < 3)) {
    for (int k = 0; k < 3; ++k) {
      cd[k] = T(0);
      cd[3 + k] = jt == kSlide ? s.xaxis[3 * j + k] : T(k == din);
    }
    return;
  }
  if (jt == kHinge) {
    for (int k = 0; k < 3; ++k) ax[k] = s.xaxis[3 * j + k];
  } else {  // free rotation: column din − 3 of the body's frame
    T Rb[9];
    qmat(s.xquat + 4 * b, Rb);
    for (int k = 0; k < 3; ++k) ax[k] = Rb[3 * k + din - 3];
  }
  for (int k = 0; k < 3; ++k) offca[k] = rc[k] - s.xanchor[3 * j + k];
  cross3(ax, offca, cd + 3);
  for (int k = 0; k < 3; ++k) cd[k] = ax[k];
}

// By one warp, after the narrowphase: the active limit rows (D > 0), each
// with its row fields, and the active contact slots (s.aslot), each listed
// in ascending order by ballots; nla and nsl get their numbers.
template <typename T>
__device__ inline void list_rows(const Meta& mt, const int* __restrict__ ic,
                                 const T* __restrict__ fc, const Work<T>& s,
                                 int& nla, int& nsl) {
  const int lane = threadIdx.x & 31;
  const int nl = mt.nl, ncon = mt.ncon, flags = mt.flags;
  const unsigned below = (1u << lane) - 1u;
  nla = 0;
  for (int base = 0; base < nl; base += 32) {
    const int r = base + lane;
    bool on = false;
    T side = T(0), margin = T(0), dist = T(0);
    if (r < nl) {
      side = fc[mt.f_lim_side + r];
      margin = fc[mt.f_lim_margin + r];
      dist = side * (fc[mt.f_lim_value + r] - s.qpos[ic[mt.i_lim_qadr + r]]);
      on = !(flags & kLimitOff) && dist < margin;
    }
    const unsigned ballot = __ballot_sync(kFullMask, on);
    if (on) {
      const int k = nla + __popc(ballot & below);
      const int da = ic[mt.i_lim_dadr + r];
      const T imp = impedance(dist, margin, fc + mt.f_lim_imp + 9 * r,
                              ic[mt.i_lim_pow + r]);
      const T kk = fc[mt.f_lim_kb + 2 * r], bb = fc[mt.f_lim_kb + 2 * r + 1];
      const T r_row = max_keep_nan(
          T(kMinVal), (T(1) - imp) * fc[mt.f_lim_diaga + r] / imp);
      const T jqvel = -side * s.qvel[da];
      s.aref[k] = -bb * jqvel - kk * imp * (dist - margin);
      s.D[k] = T(1) / r_row;
      s.ra[k] = -1 - da;
      s.rc[k] = -side;
    }
    nla += __popc(ballot);
  }
  nsl = 0;
  for (int base = 0; base < ncon; base += 32) {
    const int c = base + lane;
    const bool on = c < ncon && !(flags & kContactOff) &&
                    s.cdist[c] < fc[mt.f_con_margin + c];
    const unsigned ballot = __ballot_sync(kFullMask, on);
    if (on) s.aslot[nsl + __popc(ballot & below)] = c;
    nsl += __popc(ballot);
  }
}

// Each active slot's normal and tangent vectors, once per (slot, dof), by
// threads t, t + stride, ...
template <typename T>
__device__ inline void slot_vectors(const Meta& mt, const int* __restrict__ ic,
                                    const Work<T>& s, int nsl, int t,
                                    int stride) {
  const int nv = mt.nv;
  for (int e = t; e < nsl * nv; e += stride) {
    const int sp = e / nv, v = e - sp * nv;
    T* vec = s.cv + 3 * nv * sp;
    contact_jac(mt, ic, s, s.aslot[sp], v, vec[v], vec[nv + v],
                vec[2 * nv + v]);
  }
}

// Each active slot's four pyramidal rows jn ± μ·jt1, jn ± μ·jt2, after the
// nla limit rows, by threads t, t + stride, ...
template <typename T>
__device__ inline void slot_rows(const Meta& mt, const int* __restrict__ ic,
                                 const T* __restrict__ fc, const Work<T>& s,
                                 int nla, int nsl, int t, int stride) {
  const int nv = mt.nv;
  for (int sp = t; sp < nsl; sp += stride) {
    const int c = s.aslot[sp];
    const T* vec = s.cv + 3 * nv * sp;
    T jqn = T(0), jq1 = T(0), jq2 = T(0);
    for (int v = 0; v < nv; ++v) {
      jqn += vec[v] * s.qvel[v];
      jq1 += vec[nv + v] * s.qvel[v];
      jq2 += vec[2 * nv + v] * s.qvel[v];
    }
    const T dist = s.cdist[c], margin = fc[mt.f_con_margin + c];
    const T imp = impedance(dist, margin, fc + mt.f_con_imp + 9 * c,
                            ic[mt.i_con_pow + c]);
    const T r0 = max_keep_nan(
        T(kMinVal), (T(1) - imp) * fc[mt.f_con_diaga + c] / imp);
    const T d_py = T(1) / (fc[mt.f_con_rpy + c] * r0);
    const T k = fc[mt.f_con_kb + 2 * c], b = fc[mt.f_con_kb + 2 * c + 1];
    const T aref_base = -k * imp * (dist - margin);
    const T f0 = fc[mt.f_con_fri + 2 * c], f1 = fc[mt.f_con_fri + 2 * c + 1];
    const T jqv[4] = {jqn + f0 * jq1, jqn + (-f0) * jq1, jqn + f1 * jq2,
                      jqn + (-f1) * jq2};
    const T mu[4] = {f0, -f0, f1, -f1};
    for (int q = 0; q < 4; ++q) {
      const int row = nla + 4 * sp + q;
      s.aref[row] = -b * jqv[q] + aref_base;
      s.D[row] = d_py;
      s.ra[row] = 3 * nv * sp;
      s.rb[row] = 3 * nv * sp + nv * (1 + (q >> 1));
      s.rc[row] = mu[q];
    }
  }
}

// The constraint rows by warp 1 on the narrow route, with no block barrier:
// the narrowphase (one contact group per lane), the lists, the slots'
// vectors, then their rows. s.cnt gets the numbers of active limit rows and
// slots.
template <typename T>
__device__ void constraint_rows(const Meta& mt, const int* __restrict__ ic,
                                const T* __restrict__ fc, const Work<T>& s) {
  const int lane = threadIdx.x & 31;
  for (int g = lane; g < mt.ngroup; g += 32) collide_group(mt, ic, fc, s, g);
  __syncwarp(kFullMask);
  int nla, nsl;
  list_rows(mt, ic, fc, s, nla, nsl);
  __syncwarp(kFullMask);
  slot_vectors(mt, ic, s, nsl, lane, 32);
  __syncwarp(kFullMask);
  slot_rows(mt, ic, fc, s, nla, nsl, lane, 32);
  if (lane == 0) {
    s.cnt[0] = nla;
    s.cnt[1] = nsl;
  }
}

// The same by the whole block of kNT threads on the wide route: the
// narrowphase, the slots' vectors and their rows spread over the block,
// the lists by warp 0. Every thread calls it; the caller's barrier makes
// the rows visible.
template <int kNT, typename T>
__device__ void constraint_rows_block(const Meta& mt,
                                      const int* __restrict__ ic,
                                      const T* __restrict__ fc,
                                      const Work<T>& s) {
  const int tid = threadIdx.x;
  for (int g = tid; g < mt.ngroup; g += kNT) collide_group(mt, ic, fc, s, g);
  __syncthreads();
  if (tid < 32) {
    int nla, nsl;
    list_rows(mt, ic, fc, s, nla, nsl);
    if (tid == 0) {
      s.cnt[0] = nla;
      s.cnt[1] = nsl;
    }
  }
  __syncthreads();
  const int nla = s.cnt[0], nsl = s.cnt[1];
  slot_vectors(mt, ic, s, nsl, tid, kNT);
  __syncthreads();
  slot_rows(mt, ic, fc, s, nla, nsl, tid, kNT);
}

// H's padded lower triangle as the tiles of block_ldl_solve, entry (i, j)
// = h(i, j), by the block of kNT threads (consecutive threads on
// consecutive columns of a tile row)
template <int kNT, typename T, class Fn>
__device__ void fill_tiles(T* tiles, int n, Fn h) {
  const int nt = ldl_tiles_per_side(n);
  const int total = ldl_tile_count(n) * kTileValues;
  for (int e = threadIdx.x; e < total; e += kNT) {
    const int t = e / kTileValues, r = (e % kTileValues) / 32, c = e % 32;
    int J = 0, base = 0;
    while (base + nt - J <= t) {
      base += nt - J;
      ++J;
    }
    const int I = J + t - base;
    tiles[static_cast<long>(t) * kTileValues + tile_at<T>(r, c)] =
        ldl_tile_value<T>(I, J, r, c, n, h);
  }
}

// ---- one physics step of the block's env (every thread calls it)
template <typename T, bool kTimed, int kRoute>
__device__ void step(const Meta& mt, const int* __restrict__ ic,
                     const T* __restrict__ fc, const Work<T>& s,
                     StageClock<kTimed>& clk) {
  constexpr int kNT = RouteOf<kRoute>::kThreads;
  constexpr bool kWide = RouteOf<kRoute>::kWide;
  const int tid = threadIdx.x;
  const int nv = mt.nv, nu = mt.nu, nb = mt.nbody, nlev = mt.nlevel;
  const int ld = ldl_ld(nv);
  const int flags = mt.flags;
  const T h = fc[mt.f_scal];
  // the lists in shared memory, at their offsets from the first of them
  const auto list = [&](int i) { return s.lists + (i - mt.i_lvl_adr); };
  const unsigned short* lvl_adr = list(mt.i_lvl_adr);
  const unsigned short* lvl_body = list(mt.i_lvl_body);
  const unsigned short* child_adr = list(mt.i_child_adr);
  const unsigned short* child = list(mt.i_child);

  // normalize the free joints' quaternions (mj_normalizeQuat); each hinge's
  // half-angle sine and cosine; then FK and the frames level by level (the
  // world is level 0), parents before children
  for (int j = tid; j < mt.nfree; j += kNT)
    qnorm(s.qpos + ic[mt.i_free_qadr + j] + 3);
  for (int j = tid; j < mt.njnt; j += kNT) {
    if (ic[mt.i_jnt_type + j] == kHinge) {
      const T dq = s.qpos[ic[mt.i_jnt_qadr + j]] - fc[mt.f_jnt_qpos0 + j];
      const T half = T(0.5) * dq;
      s.jsc[2 * j] = sin(half);
      s.jsc[2 * j + 1] = cos(half);
    }
  }
  if (tid == 0) fk_body(mt, ic, fc, s, 0);
  __syncthreads();
  for (int lv = 1; lv < nlev; ++lv) {
    for (int i = lvl_adr[lv] + tid; i < lvl_adr[lv + 1]; i += kNT)
      fk_body(mt, ic, fc, s, lvl_body[i]);
    __syncthreads();
  }
  clk.mark(kFk);

  // subtree CoM, bottom-up: each body adds its children's sums in
  // descending id order, as the serial reverse pass (:786-799) adds them
  for (int lv = nlev - 1; lv >= 0; --lv) {
    for (int i = lvl_adr[lv] + tid; i < lvl_adr[lv + 1]; i += kNT) {
      const int b = lvl_body[i];
      T* mb = s.macc + 3 * b;
      for (int c = child_adr[b]; c < child_adr[b + 1]; ++c)
        for (int k = 0; k < 3; ++k) mb[k] += s.macc[3 * child[c] + k];
      const T sm = fc[mt.f_body_subtreemass + b];
      for (int k = 0; k < 3; ++k)
        s.com[3 * b + k] = sm > T(kMinVal) ? mb[k] / sm : s.xipos[3 * b + k];
    }
    __syncthreads();
  }
  clk.mark(kCom);

  // cinert per body, cdof per dof; then the CRB bottom-up, 36 entries of a
  // body per thread set, children in descending id order (the world's CRB
  // is never read)
  for (int b = tid; b < nb; b += kNT) cinert_body(mt, ic, fc, s, b);
  for (int v = tid; v < nv; v += kNT) cdof_dof(mt, ic, s, v);
  __syncthreads();
  for (int lv = nlev - 1; lv >= 1; --lv) {
    const int b0 = lvl_adr[lv], nent = 36 * (lvl_adr[lv + 1] - b0);
    for (int e = tid; e < nent; e += kNT) {
      const int b = lvl_body[b0 + e / 36], k = e % 36;
      T acc = s.cinert[36 * b + k];
      for (int c = child_adr[b]; c < child_adr[b + 1]; ++c)
        acc += s.crb[36 * child[c] + k];
      s.crb[36 * b + k] = acc;
    }
    __syncthreads();
  }
  clk.mark(kCinert);

  // com_vel: cvel per body over the dofs of its chain (bdof), cdof_dot per
  // dof over the dofs before it (pdof); then u = crb(dof body) · cdof and
  // cacc (RNE's acceleration, gravity added)
  const unsigned short* bdof_adr = list(mt.i_bdof_adr);
  const unsigned short* bdof = list(mt.i_bdof);
  const unsigned short* pdof_adr = list(mt.i_pdof_adr);
  const unsigned short* pdof = list(mt.i_pdof);
  for (int e = tid; e < 6 * nb; e += kNT) {
    const int b = e / 6, k = e - 6 * b;
    T acc = T(0);
    for (int i = bdof_adr[b]; i < bdof_adr[b + 1]; ++i) {
      const int v = bdof[i];
      acc += s.cdof[6 * v + k] * s.qvel[v];
    }
    s.cvel[e] = acc;
  }
  for (int v = tid; v < nv; v += kNT) {
    T vp[6];
    for (int k = 0; k < 6; ++k) vp[k] = T(0);
    for (int i = pdof_adr[v]; i < pdof_adr[v + 1]; ++i) {
      const int w = pdof[i];
      for (int k = 0; k < 6; ++k) vp[k] += s.cdof[6 * w + k] * s.qvel[w];
    }
    const T* m = s.cdof + 6 * v;
    T* out = s.cdofdot + 6 * v;
    T t1[3], t2[3];
    cross3(vp, m, out);          // w × m_ang
    cross3(vp, m + 3, t1);       // w × m_lin
    cross3(vp + 3, m, t2);       // u × m_ang
    for (int k = 0; k < 3; ++k) out[3 + k] = t1[k] + t2[k];
  }
  for (int e = tid; e < 6 * nv; e += kNT) {
    const int v = e / 6, a = e - 6 * v;
    const T* c = s.crb + 36 * ic[mt.i_dof_body + v] + 6 * a;
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc += c[k] * s.cdof[6 * v + k];
    s.u[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < 6 * nb; e += kNT) {
    const int b = e / 6, k = e - 6 * b;
    T acc = T(0);
    for (int i = bdof_adr[b]; i < bdof_adr[b + 1]; ++i) {
      const int v = bdof[i];
      acc += s.cdofdot[6 * v + k] * s.qvel[v];
    }
    s.cacc[e] = acc + fc[mt.f_scal + 1 + k];
  }
  __syncthreads();
  clk.mark(kVel);

  // qM on the dof-ancestor pattern (:870-875), one thread per entry of the
  // lower triangle: the dense form's entry (i, j) and its mirror (j, i) are
  // the same sum u_i·cdof_j (+0 from the pattern's other half), so each is
  // summed once and stored twice, and (narrow route) into H's lower
  // triangle for a_s; RNE forces and the xfrc wrenches per body
  for (int t = tid; t < nv * (nv + 1) / 2; t += kNT) {
    const int i = tri_row(t), j = t - i * (i + 1) / 2;
    T p = T(0);
    for (int a = 0; a < 6; ++a) p += s.u[6 * i + a] * s.cdof[6 * j + a];
    const bool da = ic[mt.i_danc + i * nv + j] != 0;
    const T q = ((da ? p : T(0)) + T(0))
                + (i == j ? fc[mt.f_dof_armature + i] : T(0));
    s.qM[i * nv + j] = q;
    s.qM[j * nv + i] = q;
    if constexpr (!kWide) s.H[i * ld + j] = q;
  }
  for (int b = tid; b < nb; b += kNT) {
    const T* ci = s.cinert + 36 * b;
    T icacc[6], icvel[6];
    for (int a = 0; a < 6; ++a) {
      T x = T(0), y = T(0);
      for (int c = 0; c < 6; ++c) {
        x += ci[6 * a + c] * s.cacc[6 * b + c];
        y += ci[6 * a + c] * s.cvel[6 * b + c];
      }
      icacc[a] = x;
      icvel[a] = y;
    }
    const T* wv = s.cvel + 6 * b;
    T t1[3], t2[3], t3[3];
    cross3(wv, icvel, t1);
    cross3(wv + 3, icvel + 3, t2);
    cross3(wv, icvel + 3, t3);
    T* fa = s.fall + 6 * b;
    for (int k = 0; k < 3; ++k) {
      fa[k] = icacc[k] + (t1[k] + t2[k]);
      fa[3 + k] = icacc[3 + k] + t3[k];
    }
    const int root = ic[mt.i_body_root + b];
    const T* xf = s.xfrc + 6 * b;
    T dp[3], to[3];
    for (int k = 0; k < 3; ++k) dp[k] = s.xipos[3 * b + k] - s.com[3 * root + k];
    cross3(dp, xf, to);
    for (int k = 0; k < 3; ++k) {
      s.f6[6 * b + k] = xf[3 + k] + to[k];
      s.f6[6 * b + 3 + k] = xf[k];
    }
  }
  __syncthreads();
  clk.mark(kRne);

  // per dof: bias (RNE backward pass) and xfrc over the bodies that carry
  // the dof (dbody), springs and dampers; per actuator: its joint motor's
  // force and the bad-ctrl guard (a NaN or huge clamped control zeroes all
  // motors), which the barrier ORs over the block; on the wide route, qM
  // as H's tiles for a_s and a_s's padding
  if constexpr (kWide) {
    fill_tiles<kNT>(s.H, nv, [&](int i, int j) { return s.qM[i * nv + j]; });
    for (int i = nv + tid; i < 32 * ldl_tiles_per_side(nv); i += kNT)
      s.as[i] = T(0);
  }
  const unsigned short* dbody_adr = list(mt.i_dbody_adr);
  const unsigned short* dbody = list(mt.i_dbody);
  for (int v = tid; v < nv; v += kNT) {
    T tb[6], tx[6];
    for (int k = 0; k < 6; ++k) tb[k] = tx[k] = T(0);
    for (int i = dbody_adr[v]; i < dbody_adr[v + 1]; ++i) {
      const int b = dbody[i];
      for (int k = 0; k < 6; ++k) {
        tb[k] += s.fall[6 * b + k];
        tx[k] += s.f6[6 * b + k];
      }
    }
    T bias = T(0), qx = T(0);
    for (int k = 0; k < 6; ++k) {
      bias += tb[k] * s.cdof[6 * v + k];
      qx += tx[k] * s.cdof[6 * v + k];
    }
    s.bias[v] = bias;
    s.qx[v] = qx;
    T pas = T(0);
    const int sq = ic[mt.i_dof_spring_q + v];
    if (!(flags & kSpringOff) && sq >= 0)
      pas = -fc[mt.f_dof_spring_k + v] * (s.qpos[sq] - fc[mt.f_dof_spring_ref + v]);
    if (!(flags & kDamperOff)) pas = pas - fc[mt.f_dof_damping + v] * s.qvel[v];
    s.passive[v] = pas;
  }
  const bool motors = nu && !(flags & kActuationOff);
  bool bad_mine = false;
  if (motors) {
    for (int i = tid; i < nu; i += kNT) {
      const int af = ic[mt.i_act_flags + i];
      T c = s.ctrl[i];
      if (!(flags & kClampCtrlOff) && (af & 1))
        c = clip(c, fc[mt.f_act_ctrlrange + 2 * i],
                 fc[mt.f_act_ctrlrange + 2 * i + 1]);
      bad_mine = bad_mine || c != c || fabs(c) > T(kMaxVal);
      T force = fc[mt.f_act_gain + i] * c;
      if (af & 2)
        force = clip(force, fc[mt.f_act_forcerange + 2 * i],
                     fc[mt.f_act_forcerange + 2 * i + 1]);
      s.actf[i] = force;
    }
  }
  const bool bad = __syncthreads_or(bad_mine);
  clk.mark(kForce);

  // qfrc_actuator per dof, its motors in actuator order; qfrc_smooth
  for (int v = tid; v < nv; v += kNT) {
    T act = T(0);
    if (motors) {
      const unsigned short* dact_adr = list(mt.i_dact_adr);
      for (int i = dact_adr[v]; i < dact_adr[v + 1]; ++i) {
        const int a = list(mt.i_dact)[i];
        if (ic[mt.i_act_flags + a] & 4) continue;
        const T force = bad ? T(0) : s.actf[a];
        act = act + fc[mt.f_act_gear + a] * force;
      }
    }
    const T sm = s.passive[v] - s.bias[v] + act + s.qfrc_app[v] + s.qx[v];
    s.smooth[v] = sm;
    s.as[v] = sm;
  }
  __syncthreads();

  // narrow route: warp 0 solves a_s by the LDL of ldl_common.cuh, warp 1
  // meanwhile builds the constraint rows; wide route: the block solves a_s
  // by the blocked LDLᵀ, then builds the rows. The smooth dynamics' work
  // space is free from here on.
  const int nefc = mt.nefc;
  if constexpr (kWide) {
    block_ldl_solve<kNT, kWide>(s.H, s.stage, s.as, s.aux, nv);
    clk.mark(kSmooth);
    if (nefc > 0) constraint_rows_block<kNT>(mt, ic, fc, s);
  } else {
    if (tid < 32) {
      warp_ldl_solve(s.H, ld, s.as, nv, tid);
      clk.mark(kSmooth);
    } else if (nefc > 0) {
      constraint_rows(mt, ic, fc, s);
    }
  }
  __syncthreads();
  clk.mark(kRows);

  if (nefc > 0) {
    const int nla = s.cnt[0], nsl = s.cnt[1];
    const int nrow = nla + 4 * nsl;
    clk.rows(nrow, nsl);

    // the Newton solve over the active rows, every one one-sided; then
    // qfrc_constraint = Jᵀf
    const ListRows<T> rows{s.cv, s.ra, s.rb, s.rc, s.aref, s.D, nrow, nv,
                           nla};
    const NewtonWork<T> work{s.qM, s.H,  s.jar, s.jp, s.force, s.w,
                             s.x,  s.as, s.warm, s.dx, s.mdx,  s.y,
                             s.red, s.cost, nv,   ld};
    // (the wide route's H and work space in device memory)
    block_newton<kNT, T, ListRows<T>, kWide, kWide>(
        rows, work, fc[mt.f_scal + 7], mt.iterations, mt.ls_iter,
        (flags & kUseWarm) != 0, TileWork<T>{s.stage, s.aux});
    for (int i = tid; i < nv; i += kNT) s.qc[i] = rows.jtf(i, s.force);
  } else {
    for (int i = tid; i < nv; i += kNT) {
      s.x[i] = s.as[i];
      s.qc[i] = T(0);
    }
  }
  __syncthreads();
  clk.mark(kNewton);

  // Euler; with joint damping the velocity update is implicit:
  // (M + h·diag(damping))⁻¹ (qfrc_smooth + qfrc_constraint) (:1327-1337).
  // qacc and the next warmstart keep the solver's x (:1362).
  const T* acc = s.x;
  if (flags & kUseDamp) {
    const auto damped = [&](int i, int j) {
      return s.qM[i * nv + j] + (i == j ? h * fc[mt.f_dof_damping + i] : T(0));
    };
    if constexpr (kWide) {
      fill_tiles<kNT>(s.H, nv, damped);
      for (int v = tid; v < 32 * ldl_tiles_per_side(nv); v += kNT)
        s.y[v] = v < nv ? s.smooth[v] + s.qc[v] : T(0);
      __syncthreads();
      block_ldl_solve<kNT, kWide>(s.H, s.stage, s.y, s.aux, nv);
    } else {
      for (int e = tid; e < nv * nv; e += kNT) {
        const int i = e / nv, j = e - i * nv;
        if (j <= i) s.H[i * ld + j] = damped(i, j);
      }
      for (int v = tid; v < nv; v += kNT) s.y[v] = s.smooth[v] + s.qc[v];
      __syncthreads();
      if (tid < 32) warp_ldl_solve(s.H, ld, s.y, nv, tid);
      __syncthreads();
    }
    acc = s.y;
  }
  for (int v = tid; v < nv; v += kNT) s.qvel[v] = s.qvel[v] + h * acc[v];
  __syncthreads();
  for (int v = tid; v < nv; v += kNT) {
    const int q = ic[mt.i_dof_q + v];
    if (q >= 0) s.qpos[q] = s.qpos[q] + h * s.qvel[v];
    s.warm[v] = s.x[v];
    s.qacc[v] = s.x[v];
  }
  for (int j = tid; j < mt.nfree; j += kNT) {
    T* q = s.qpos + ic[mt.i_free_qadr + j] + 3;
    const T* w = s.qvel + ic[mt.i_free_dadr + j] + 3;
    qnorm(q);
    T w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T lo = T(kMinVal) * T(kMinVal);
    w2 = w2 < lo ? lo : w2;
    const T wn = sqrt(w2);
    const T half = T(0.5) * (wn * h);
    const T sn = sin(half);
    const T dq[4] = {cos(half), w[0] / wn * sn, w[1] / wn * sn,
                     w[2] / wn * sn};
    qmul(q, dq, q);
    qnorm(q);
  }
  __syncthreads();
}

// Blocks per SM the launch bounds ask for: the narrow route 8 at f32 (4
// at f64), so that registers stay within what 8 blocks leave; the wide
// route 2 at f32 and 1 at f64.
template <typename T, int kRoute>
constexpr int kMinBlocks = kRoute == kNarrow ? (sizeof(T) == 4 ? 8 : 4)
                                             : (sizeof(T) == 4 ? 2 : 1);

// gwork (kWideDevice): gvalues values of device memory per env
template <typename T, bool kTimed, int kRoute>
__global__ void __launch_bounds__(RouteOf<kRoute>::kThreads,
                                  kMinBlocks<T, kRoute>)
megastep_kernel(Meta mt, const int* __restrict__ ic,
                const T* __restrict__ fc, const T* __restrict__ fresh,
                const T* __restrict__ qpos_in, const T* __restrict__ qvel_in,
                const T* __restrict__ ctrl_in, const T* __restrict__ warm_in,
                const T* __restrict__ qacc_in, const T* __restrict__ time_in,
                const T* __restrict__ qfrc_in, const T* __restrict__ xfrc_in,
                T* __restrict__ qpos_out, T* __restrict__ qvel_out,
                T* __restrict__ ctrl_out, T* __restrict__ warm_out,
                T* __restrict__ qacc_out, T* __restrict__ time_out,
                int nstep, int check, long long* __restrict__ stats,
                T* gwork, long long gvalues) {
  constexpr int kNT = RouteOf<kRoute>::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long env = blockIdx.x;
  Work<T> s;
  layout<T>(mt, kRoute, reinterpret_cast<T*>(smem_raw),
            RouteOf<kRoute>::kWide ? gwork + env * gvalues : nullptr, &s);
  const int tid = threadIdx.x;
  const int nq = mt.nq, nv = mt.nv, nu = mt.nu, nb = mt.nbody;

  // the state, read once
  for (int i = tid; i < nq; i += kNT) s.qpos[i] = qpos_in[env * nq + i];
  for (int i = tid; i < nv; i += kNT) {
    s.qvel[i] = qvel_in[env * nv + i];
    s.warm[i] = warm_in[env * nv + i];
    s.qacc[i] = qacc_in[env * nv + i];
    s.qfrc_app[i] = qfrc_in[env * nv + i];
  }
  for (int i = tid; i < nu; i += kNT) s.ctrl[i] = ctrl_in[env * nu + i];
  for (int i = tid; i < 6 * nb; i += kNT) s.xfrc[i] = xfrc_in[env * 6 * nb + i];
  for (int i = tid; i < mt.nlist; i += kNT)
    s.lists[i] = static_cast<unsigned short>(ic[mt.i_lvl_adr + i]);
  if (tid == 0) s.time[0] = time_in[env];
  StageClock<kTimed> clk;
  if constexpr (kTimed) {
    __shared__ long long clk_sum[kStatWords];
    clk.sum = clk_sum;
    for (int i = tid; i < kStatWords; i += kNT) clk_sum[i] = 0;
  }
  __syncthreads();
  clk.start();

  const T h = fc[mt.f_scal];
  for (int n = 0; n < nstep; ++n) {
    step<T, kTimed, kRoute>(mt, ic, fc, s, clk);
    if (tid == 0) s.time[0] = s.time[0] + h;
    if (check) {
      // the divergence guard (_check_reset_lane): a NaN or a value above
      // 1e10 in qpos or qvel resets qpos, qvel and ctrl to the caller's
      // fresh state and warmstart, qacc and time to 0 (not to
      // d_fresh.time, unlike the stage path's check_reset)
      bool mine = false;
      for (int i = tid; i < nq; i += kNT)
        mine = mine || s.qpos[i] != s.qpos[i] || fabs(s.qpos[i]) > T(kMaxVal);
      for (int i = tid; i < nv; i += kNT)
        mine = mine || s.qvel[i] != s.qvel[i] || fabs(s.qvel[i]) > T(kMaxVal);
      if (__syncthreads_or(mine)) {
        for (int i = tid; i < nq; i += kNT) s.qpos[i] = fresh[i];
        for (int i = tid; i < nv; i += kNT) {
          s.qvel[i] = fresh[nq + i];
          s.warm[i] = T(0);
          s.qacc[i] = T(0);
        }
        for (int i = tid; i < nu; i += kNT) s.ctrl[i] = fresh[nq + nv + i];
        if (tid == 0) s.time[0] = T(0);
      }
    }
    __syncthreads();
    clk.mark(kEuler);
  }

  // the state, written once
  for (int i = tid; i < nq; i += kNT) qpos_out[env * nq + i] = s.qpos[i];
  for (int i = tid; i < nv; i += kNT) {
    qvel_out[env * nv + i] = s.qvel[i];
    warm_out[env * nv + i] = s.warm[i];
    qacc_out[env * nv + i] = s.qacc[i];
  }
  for (int i = tid; i < nu; i += kNT) ctrl_out[env * nu + i] = s.ctrl[i];
  if (tid == 0) time_out[env] = s.time[0];
  if constexpr (kTimed) {
    for (int i = tid; i < kStatWords; i += kNT)
      stats[env * kStatWords + i] = clk.sum[i];
  }
}

// Meta from the host's int array; false if the count is not Meta's
bool read_meta(const int* meta, int nmeta, Meta* mt) {
  if (nmeta != static_cast<int>(sizeof(Meta) / sizeof(int))) return false;
  memcpy(mt, meta, sizeof(Meta));
  return true;
}

// Dynamic shared bytes of a block on route; *gvalues gets the device
// values per env (kWideDevice; else 0)
template <typename T>
size_t smem_bytes(const Meta& mt, int route, size_t* gvalues = nullptr) {
  size_t g = 0;
  const size_t values = layout<T>(mt, route, static_cast<T*>(nullptr),
                                  static_cast<T*>(nullptr),
                                  static_cast<Work<T>*>(nullptr), &g);
  if (gvalues) *gvalues = g;
  return values * sizeof(T);
}

template <typename T, bool kTimed, int kRoute>
int launch_megastep(const int* meta, int nmeta, const int* ic, const T* fc,
                    const T* fresh, const T* const* in, T* const* out, int B,
                    int nstep, int check, T* work, long long* stats,
                    cudaStream_t stream) {
  Meta mt;
  if (!read_meta(meta, nmeta, &mt) || B < 1 || nstep < 0 || mt.nv < 1 ||
      (mt.nefc > 0 && (mt.iterations < 1 || mt.iterations > kStatRows)) ||
      (kTimed && stats == nullptr) ||
      (RouteOf<kRoute>::kWide && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t gvalues = 0;
  const size_t smem = smem_bytes<T>(mt, kRoute, &gvalues);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megastep_kernel<T, kTimed, kRoute>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  megastep_kernel<T, kTimed, kRoute>
      <<<B, RouteOf<kRoute>::kThreads, smem, stream>>>(
          mt, ic, fc, fresh, in[0], in[1], in[2], in[3], in[4], in[5], in[6],
          in[7], out[0], out[1], out[2], out[3], out[4], out[5], nstep,
          check, stats, work, static_cast<long long>(gvalues));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRoute>
int megastep_blocks_per_sm(const int* meta, int nmeta) {
  Meta mt;
  if (!read_meta(meta, nmeta, &mt))
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(mt, kRoute);
  cudaError_t err = cudaFuncSetAttribute(
      megastep_kernel<T, false, kRoute>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem > 48 * 1024 ? smem : 48 * 1024));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, megastep_kernel<T, false, kRoute>,
        RouteOf<kRoute>::kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// cudaFuncGetAttributes of one instantiation: registers per thread, local
// (spilled) bytes per thread, static shared bytes, threads per block
template <typename T, bool kTimed, int kRoute>
int megastep_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, megastep_kernel<T, kTimed, kRoute>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = RouteOf<kRoute>::kThreads;
  return 0;
}

// The C entries' common arguments: the tables, the fresh state, the 8 state
// inputs and 6 outputs of STATE/OUT order, the batch, the steps, the guard
// switch and the stream; the timed entries add stats, (B, kStatWords) int64.
#define MJT_MEGASTEP_PARAMS                                                 \
  const int *meta, int nmeta, const void *ic, const void *fc,               \
      const void *fresh, const void *qpos, const void *qvel,                \
      const void *ctrl, const void *warm, const void *qacc,                 \
      const void *time, const void *qfrc, const void *xfrc, void *qpos_o,   \
      void *qvel_o, void *ctrl_o, void *warm_o, void *qacc_o, void *time_o, \
      int B, int nstep, int check, void *stream
#define MJT_MEGASTEP_ARGS                                                    \
  meta, nmeta, ic, fc, fresh, qpos, qvel, ctrl, warm, qacc, time, qfrc, xfrc, \
      qpos_o, qvel_o, ctrl_o, warm_o, qacc_o, time_o, B, nstep, check, stream

// work: the device-memory slices of kWideDevice (B·gvalues values)
template <typename T, bool kTimed, int kRoute>
int entry(MJT_MEGASTEP_PARAMS, void* work, void* stats) {
  const T* in[8] = {static_cast<const T*>(qpos), static_cast<const T*>(qvel),
                    static_cast<const T*>(ctrl), static_cast<const T*>(warm),
                    static_cast<const T*>(qacc), static_cast<const T*>(time),
                    static_cast<const T*>(qfrc), static_cast<const T*>(xfrc)};
  T* out[6] = {static_cast<T*>(qpos_o), static_cast<T*>(qvel_o),
               static_cast<T*>(ctrl_o), static_cast<T*>(warm_o),
               static_cast<T*>(qacc_o), static_cast<T*>(time_o)};
  return launch_megastep<T, kTimed, kRoute>(
      meta, nmeta, static_cast<const int*>(ic), static_cast<const T*>(fc),
      static_cast<const T*>(fresh), in, out, B, nstep, check,
      static_cast<T*>(work), static_cast<long long*>(stats),
      static_cast<cudaStream_t>(stream));
}

// The wide route's timed launch and its attributes, where the source builds
// the timed instantiation (kTimedBuilt; f32 only)
template <typename T, int kRoute, bool kTimedBuilt>
int timed_entry(MJT_MEGASTEP_PARAMS, void* work, void* stats) {
  if constexpr (kTimedBuilt) {
    return entry<T, true, kRoute>(MJT_MEGASTEP_ARGS, work, stats);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int kRoute, bool kTimedBuilt>
int attributes_of(int timed, int* out) {
  if (!timed) return megastep_attributes<T, false, kRoute>(out);
  if constexpr (kTimedBuilt) {
    return megastep_attributes<T, true, kRoute>(out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace mjt

// The wide route's C entries at one dtype (T, named DT), one source each
// (megastep_wide_device_*.cu) so that nvcc builds them side by side: the
// launch (work: the per-env slices, B·mjt_megastep_work_values values),
// the stage clock's timed launch (built at f32 only: TIMED 1), resident
// blocks per SM and the attributes of an instantiation.
#define MJT_MEGASTEP_WIDE_ENTRIES(T, DT, TIMED)                              \
  extern "C" int mjt_megastep_wide_device_##DT(MJT_MEGASTEP_PARAMS,          \
                                               void* work) {                 \
    return mjt::entry<T, false, mjt::kWideDevice>(MJT_MEGASTEP_ARGS, work,   \
                                                  nullptr);                  \
  }                                                                          \
  extern "C" int mjt_megastep_wide_device_timed_##DT(                        \
      MJT_MEGASTEP_PARAMS, void* work, void* stats) {                        \
    return mjt::timed_entry<T, mjt::kWideDevice, TIMED>(MJT_MEGASTEP_ARGS,   \
                                                        work, stats);        \
  }                                                                          \
  extern "C" int mjt_megastep_wide_device_blocks_per_sm_##DT(                \
      const int* meta, int nmeta) {                                          \
    return mjt::megastep_blocks_per_sm<T, mjt::kWideDevice>(meta, nmeta);    \
  }                                                                          \
  extern "C" int mjt_megastep_wide_device_attributes_##DT(int timed,         \
                                                          int* out) {        \
    return mjt::attributes_of<T, mjt::kWideDevice, TIMED>(timed, out);       \
  }
