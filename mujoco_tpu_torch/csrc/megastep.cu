// Whole-rollout megastep: nstep physics steps per env in one launch, one
// thread block per env, float and double.
//
// Replaces the Pallas kernel _scan_kernel
// (mujoco_tpu/ops/megastep_tpu.py:1389, launched by scan_lanes :1415). Each
// step is _lane_step (:707): normalize the free joints' quaternions; FK,
// subtree CoM, cinert, cdof, CRB → qM, com_vel/cdof_dot and RNE; springs,
// dampers, joint motors with the bad-ctrl guard, and xfrc; a_s = M⁻¹
// qfrc_smooth; the seven contact pair families, limit rows and pyramidal
// contact rows; the Newton solve; Euler, implicit in the joint damping
// where the model has it; then the divergence guard _check_reset_lane
// (:1365). The integration state is read from device memory once and
// written once per launch; qfrc_applied and xfrc are constant across it.
//
// The model is data, not code: the host packs its tables once per (Model,
// dtype) (mujoco_tpu_torch/ops/megastep_cuda.py, class Tables), an int32
// section and a section of values in T, with their offsets in Meta. The
// kernel is generic over the supported class; no source is generated per
// model.
//
// What bounds it on an H100: by the roofline, operations (about 1.3e5 per
// env-step for the humanoid over the rows its contacts make active),
// against ~2e2 state values that cross device memory once per launch, not
// per step. In practice it is the latency of one env's step, chains of
// dependent shared-memory reads, shuffles, barriers and divisions far
// above that bound, and the shared-memory pipe that the envs of an SM
// share; so the design aims at short chains, few shared-memory
// instructions and many envs per SM (PERF.md has the stage clock's
// breakdown):
//
// - Only the active constraint rows (D > 0) reach the Newton solve, as a
//   list in shared memory (ListRows, newton_common.cuh): on the humanoid
//   about 13 of 162 rows per step. An inactive row contributes exact zeros
//   to every sum of the dense solve, so dropping it changes only the order
//   of those sums. Limit rows store no Jacobian (a dof and a sign); a
//   contact slot in use stores its normal and two tangent vectors, and its
//   four pyramidal rows jn ± μ·jt are formed entry by entry, as rounded as
//   the dense kernel stored them. JᵀWJ keeps each thread's entries in
//   registers while it walks the rows once.
// - The LDL solves run in one warp's registers (ldl_common.cuh).
// - Warp 1 builds every constraint row (narrowphase, active limit rows and
//   contact slots, the slots' vectors and rows) while warp 0 solves a_s.
// - The tree passes go level by level (FK and the frames top-down, the
//   subtree CoM and the CRB bottom-up, each body gathering its children in
//   the order of the serial pass), the chains of com_vel, cdof_dot, the
//   RNE projections and the motors read compact per-body and per-dof lists
//   from the host instead of dense masks, the hinges' sines and cosines
//   are taken in parallel ahead of FK, and qM's symmetric entries are
//   summed once.
// - The work space overlays what only the smooth dynamics needs with what
//   only the constraints need: 27.8 KB per block at f32 for the humanoid,
//   with the compact tree lists copied in as 16-bit ints, so that 8 blocks
//   of 64 threads fit an SM by shared memory, and __launch_bounds__ holds
//   registers to what 8 blocks leave (128).
// - Above nv 64, or where that work space does not fit, the wide route
//   (megastep_wide_device_*.cu) runs the same step by a block of 8 warps
//   per env with the blocked LDLᵀ and the tiled Newton solve of the Newton
//   kernel's wide route, its large arrays in a per-env slice of device
//   memory (megastep_common.cuh, Route).
//
// This file instantiates the narrow route and the C entries every route
// shares; megastep_common.cuh holds the step and the kernel template.
#include "megastep_common.cuh"

extern "C" {

// Dynamic shared bytes of a block on route (megastep_cuda.ROUTES' index)
int mjt_megastep_smem_bytes(const int* meta, int nmeta, int f64, int route) {
  mjt::Meta mt;
  if (!mjt::read_meta(meta, nmeta, &mt) || route < mjt::kNarrow ||
      route > mjt::kWideDevice)
    return -1;
  return static_cast<int>(f64 ? mjt::smem_bytes<double>(mt, route)
                              : mjt::smem_bytes<float>(mt, route));
}

// Device-memory values per env of the wide device route's work space
long long mjt_megastep_work_values(const int* meta, int nmeta, int f64) {
  mjt::Meta mt;
  if (!mjt::read_meta(meta, nmeta, &mt)) return -1;
  size_t g = 0;
  if (f64)
    mjt::smem_bytes<double>(mt, mjt::kWideDevice, &g);
  else
    mjt::smem_bytes<float>(mt, mjt::kWideDevice, &g);
  return static_cast<long long>(g);
}

int mjt_megastep_blocks_per_sm(const int* meta, int nmeta, int f64) {
  return f64 ? mjt::megastep_blocks_per_sm<double, mjt::kNarrow>(meta, nmeta)
             : mjt::megastep_blocks_per_sm<float, mjt::kNarrow>(meta, nmeta);
}

int mjt_megastep_attributes(int f64, int timed, int* out) {
  using mjt::kNarrow;
  if (f64) {
    return timed ? mjt::megastep_attributes<double, true, kNarrow>(out)
                 : mjt::megastep_attributes<double, false, kNarrow>(out);
  }
  return timed ? mjt::megastep_attributes<float, true, kNarrow>(out)
               : mjt::megastep_attributes<float, false, kNarrow>(out);
}

// the SM clock in kHz, which converts the stage clock's cycles to time
int mjt_sm_clock_khz(void) {
  int dev = 0, khz = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) != cudaSuccess)
    return -1;
  return khz;
}

int mjt_megastep_f32(MJT_MEGASTEP_PARAMS) {
  return mjt::entry<float, false, mjt::kNarrow>(MJT_MEGASTEP_ARGS, nullptr,
                                                nullptr);
}
int mjt_megastep_f64(MJT_MEGASTEP_PARAMS) {
  return mjt::entry<double, false, mjt::kNarrow>(MJT_MEGASTEP_ARGS, nullptr,
                                                 nullptr);
}
int mjt_megastep_timed_f32(MJT_MEGASTEP_PARAMS, void* stats) {
  return mjt::entry<float, true, mjt::kNarrow>(MJT_MEGASTEP_ARGS, nullptr,
                                               stats);
}
int mjt_megastep_timed_f64(MJT_MEGASTEP_PARAMS, void* stats) {
  return mjt::entry<double, true, mjt::kNarrow>(MJT_MEGASTEP_ARGS, nullptr,
                                                stats);
}

}  // extern "C"
