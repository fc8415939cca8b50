// Velocity and dye boundary conditions: the per-cell rules, shared by the
// CIP phases (cip_phases.cu) and the MAC phases (mac_phases.cu), and the
// MAC velocity phase's BC kernel.
//
// The per-cell rules (velocity_bc_cell, dye_bc_cell) read their operands
// through cell accessors (common.cuh), so the BC kernel below and the
// fused phase kernels evaluate the same lines.
//
// The kernel writes the BC'd velocity out of place, one thread per cell and
// blockIdx.z the channel: the rules read the pre-BC field at other cells
// (ghost mirrors two cells away, outflow one cell upstream), so an in-place
// update would race. The field and the scene's constants are of storage
// type S; the result goes to a float plane, which the next launch reads,
// and (st2) to its rounded copy where it is a phase output.
// Internal linkage: every source that includes this header gets its own
// copy of the kernel.
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

// Velocity BC by the packed vbc_code, both channels (blockIdx.z).
template <typename S>
__global__ void velocity_bc_kernel(const S* __restrict__ v, const int8_t* __restrict__ vbc_code,
                                   const S* __restrict__ bc_const, float* __restrict__ out,
                                   S* __restrict__ out_s, Grid g) {
  int i, j;
  if (!cell_of(g, i, j)) return;
  const int c = blockIdx.z;
  const long long k = (long long)i * g.Y + j;
  // The cell's own value is loaded with its code, not after it.
  const Plane<S> vc{v + c * g.plane(), g};
  const float v0 = ld(vc.p, k);
  const auto pre = [&](int a, int b) { return a == i && b == j ? v0 : vc(a, b); };
  const float r = velocity_bc_cell(pre, Plane<S>{bc_const + c * g.plane(), g}, vbc_code[k], c, i,
                                   j);
  st2(out, out_s, c * g.plane() + k, r);
}

}  // namespace
}  // namespace f2d
