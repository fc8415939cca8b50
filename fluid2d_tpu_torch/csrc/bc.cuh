// Velocity and dye boundary conditions, shared by the CIP phases
// (cip_phases.cu) and the MAC phases (mac_phases.cu).
//
// Each kernel writes the BC'd field out of place, one thread per cell and
// blockIdx.z the channel: the velocity rules read the pre-BC field at
// other cells (ghost mirrors two cells away, outflow one cell upstream),
// so an in-place update would race. The field and the scene's constants
// are of storage type S; the result goes to a float plane, which the next
// launch reads, and (st2) to its rounded copy where it is a phase output.
// Internal linkage: every source that includes this header gets its own
// copy of the kernels.
#pragma once

#include "common.cuh"

namespace f2d {
namespace {

// Velocity BC by the packed vbc_code (fluid2d_tpu/ops/pallas_phases.py:91-117):
// 1..4 ghost mirrors, 5 inflow, 6 outflow (x component only, fmaxf: NaN → 0.05).
template <typename S>
__global__ void velocity_bc_kernel(const S* __restrict__ v, const int8_t* __restrict__ vbc_code,
                                   const S* __restrict__ bc_const, float* __restrict__ out,
                                   S* __restrict__ out_s, Grid g) {
  int i, j;
  if (!cell_of(g, i, j)) return;
  const int c = blockIdx.z;
  const long long k = (long long)i * g.Y + j;
  const S* vc = v + c * g.plane();
  float r = ld(vc, k);
  switch (vbc_code[k]) {
    case 1: r = -ld(vc, g.at(i - 2, j)); break;
    case 2: r = -ld(vc, g.at(i + 2, j)); break;
    case 3: r = -ld(vc, g.at(i, j - 2)); break;
    case 4: r = -ld(vc, g.at(i, j + 2)); break;
    case 5: r = ld(bc_const, c * g.plane() + k); break;
    case 6:
      if (c == 0) r = fmaxf(ld(vc, g.at(i - 1, j)), 0.05f);
      break;
    default: break;
  }
  st2(out, out_s, c * g.plane() + k, r);
}

// Dye BC: inflow cells take the scene's dye colours.
template <typename S>
__global__ void dye_bc_kernel(const S* __restrict__ dye, const int8_t* __restrict__ inflow,
                              const S* __restrict__ bc_dye, float* __restrict__ out,
                              S* __restrict__ out_s, Grid g) {
  int i, j;
  if (!cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const long long kc = blockIdx.z * g.plane() + k;
  st2(out, out_s, kc, inflow[k] != 0 ? ld(bc_dye, kc) : ld(dye, kc));
}

}  // namespace
}  // namespace f2d
