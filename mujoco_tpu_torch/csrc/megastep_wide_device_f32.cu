// The megastep's wide route (megastep_common.cuh, Route: kWideDevice):
// one block of kWideThreads (8 warps) per env, for models above nv 64 or
// whose narrow work space does not fit a block's shared memory
// (multi_humanoid3, nv 81; the ten-humanoid scene without islands, nv
// 270). The same whole step as the narrow route (megastep.cu, which
// describes the design), with both LDL solves by the blocked LDLᵀ over H's
// 32×32 tiles and the Newton solve building H as those tiles
// (block_newton's kWide, as the Newton kernel's wide route in newton.cu):
// at nv 81 one warp would walk 3,321 entries of H and 81 serial pivots
// alone. The block solves a_s first and then builds the constraint rows,
// where the narrow route overlaps the two on its two warps: the blocked
// factor needs every thread.
//
// qM, H's tiles, cinert and the CRB, the contacts, the slots' vectors and
// the row vectors live in a per-env slice of device memory that
// megastep_cuda allocates with torch.empty, sized by
// mjt_megastep_work_values; the small per-step vectors stay in shared
// memory and the blocked factor stages each panel there. One source per
// dtype, so that nvcc builds the megastep's sources side by side. This
// one: f32, with the stage clock's timed kernel.
#include "megastep_common.cuh"

MJT_MEGASTEP_WIDE_ENTRIES(float, f32, 1)
