// The megastep's wide route at f64 (megastep_wide_device_f32.cu describes
// it).
#include "megastep_common.cuh"

MJT_MEGASTEP_WIDE_ENTRIES(double, f64, 0)
