// Velocity and dye boundary conditions: the per-cell rules, shared by the
// CIP phases (cip_phases.cu) and the MAC phases (mac_phases.cu).
//
// The rules read their operands through cell accessors (common.cuh), so
// each fused phase kernel evaluates the same lines on its shared-memory
// windows. They read the pre-BC field at other cells (ghost mirrors two
// cells away, outflow one cell upstream), so a kernel writes the BC'd field
// out of place. Internal linkage: every source that includes this header
// gets its own copy.
#pragma once

#include "common.cuh"

namespace f2d {
namespace {

// Velocity BC of channel c at cell (i, j) by its vbc_code
// (fluid2d_tpu/ops/pallas_phases.py:91-117): 1..4 ghost mirrors, 5 inflow,
// 6 outflow (x component only, fmaxf: NaN → 0.05). v: the channel's pre-BC
// field; inflow: the channel's scene constant, read only at inflow cells.
template <typename A, typename B>
__device__ __forceinline__ float velocity_bc_cell(const A& v, const B& inflow, int code, int c,
                                                  int i, int j) {
  switch (code) {
    case 1: return -v(i - 2, j);
    case 2: return -v(i + 2, j);
    case 3: return -v(i, j - 2);
    case 4: return -v(i, j + 2);
    case 5: return inflow(i, j);
    case 6:
      if (c == 0) return fmaxf(v(i - 1, j), 0.05f);
      return v(i, j);
    default: return v(i, j);
  }
}

// Dye BC: inflow cells take the scene's dye colours.
template <typename A, typename B>
__device__ __forceinline__ float dye_bc_cell(const A& dye, const B& bc_dye, int inflow, int i,
                                             int j) {
  return inflow != 0 ? bc_dye(i, j) : dye(i, j);
}

}  // namespace
}  // namespace f2d
