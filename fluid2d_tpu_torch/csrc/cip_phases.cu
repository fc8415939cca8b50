// The CIP velocity phase, the CIP dye phase and the standalone CIP advection.
//
// The phases replace fluid2d_tpu/ops/pallas_phases.py:cip_velocity_phase_pallas
// (body _cip_velocity_body) and cip_dye_phase_pallas (body _cip_dye_body).
// The arithmetic is the port's eager path (the jnp branches of
// fluid2d_tpu/models/cip.py) operation for operation, rounded as PyTorch
// rounds it on the card (see common.cuh). Each phase cascades four stencils:
//   1. BC                 state       -> f_bc
//   2. non-advection      f_bc        -> f_na  at not-wall cells, alt elsewhere
//   3. gradient update    f_na − f_bc -> g_na  at not-wall cells, alt elsewhere
//   4. CIP advection      (f_na, g_na) by the carrying velocity at fluid
//                         cells; f_bc and the pre-phase gradients elsewhere
// The velocity phase carries by its own f_na; the dye phase by the limited
// velocity it is given, and clamps the advected dye to [0, 1].
//
// One launch a phase. A block owns a TX × TY tile of output cells and runs
// the whole cascade on it, each stage's values held as float in a shared
// memory window one cell wider on every side than the next stage reads:
// f_bc on the tile + 3, f_na + 2, g_na + 1, the advection on the tile. The
// halo is recomputed by every block that needs it, as the Pallas cascade
// recomputes it per tile; only the six outputs reach device memory. A
// window entry at a cell outside the grid holds the stage's value at the
// clamped cell (computed there, not "as if" at the outside index), which is
// what a shifted read of a whole computed field gives in the jnp path and
// what the Pallas kernels rebuild with _reclamp. So every stage value is the
// eager path's float32 value, to the bit.
//
// Memory. A block first copies its operands into the windows: the state on
// the window it first feeds (v, p and the dye on the tile + 3, the
// gradients and the dye's carrying velocity on + 1) and one flag byte a cell
// (the BC code, inflow, not-wall, fluid) from the scene's int8 planes. Every
// window spans the same chunk-aligned columns, so a row is read in aligned
// chunks (the fills of tile.cuh, shared with the fused SOR and confinement
// kernels). The stages then run from shared memory; the
// alternates, the inflow constants and the pre-phase gradients of non-fluid
// cells are read from device memory at the few cells that take them. The
// halo rows a neighbouring tile also reads come from L2. The per-cell
// arithmetic of each stage is a function of cell accessors (common.cuh),
// shared with the MAC BC kernels (bc.cuh) and the standalone advection
// (cip_advect.cuh).
//
// Velocity: both channels in one block (channel 0 takes ∂x p, channel 1
// ∂y p; each is carried by both f_na planes); the gradient update and the
// advection one channel at a time through one pair of gradient windows, as
// _cip_velocity_body does. Dye: one channel a blockIdx.z.
//
// The standalone advection (C1, replaces fluid2d_tpu/ops/pallas_stencil.py:
// cip_advect_pallas) is the advection stage alone, one launch: a block owns
// a TX × TY tile of every channel. It fills the carrying velocity on the
// tile + 1 and the fluid flags on the tile once, then each channel's f, fx,
// fy on the tile + 1 in turn, into the same three windows, and runs the
// advection cell on them; the alternates are read at the non-fluid cells
// only. When the velocity advects itself (u, w are f's first two planes),
// their windows serve as those channels' f windows. Bound: bytes (f, fx, fy,
// the velocity and the mask read once, the alternates at the non-fluid
// cells, three planes written a channel; ~120 flops a cell and channel).
//
// Storage type S (common.cuh): the state's planes, the scene's constants and
// the six outputs are S; each output is rounded once, at its store.
#include "bc.cuh"
#include "cip_advect.cuh"
#include "common.cuh"
#include "tile.cuh"

using f2d::allow_smem;
using f2d::bf16;
using f2d::chunk_loads;
using f2d::CipConsts;
using f2d::fill;
using f2d::for_window;
using f2d::Grid;
using f2d::kThreads;
using f2d::kV;
using f2d::Plane;
using f2d::tile_blocks;
using f2d::wait_fills;
using f2d::Window;

namespace {

// Output tile of a fused phase block, rows × columns, both phases and the
// standalone advection: the fastest of the shapes timed on the card
// (PERF.md §6).
constexpr int kTileX = 32, kTileY = 32;
// Blocks an SM the standalone advection's registers allow, by storage type:
// the fastest of 4 (uncapped: 64 registers), 5, 6 and 7 timed on the card
// (PERF.md §6); at bf16, 6 spills.
template <typename S>
constexpr int kAdvectBlocks = f2d::kIsBf16<S> ? 5 : 6;

// A cell's flag byte in a fused kernel's window, gathered from the scene's
// int8 planes: the velocity BC code (0..6) in the low bits, then these.
constexpr unsigned kInflow = 1u << 3, kNotWall = 1u << 4, kFluid = 1u << 5, kCode = 7u;

// fill_flags' packing of the velocity phase's (BC code, not-wall, fluid)
// bytes and the dye phase's (inflow, not-wall, fluid) bytes.
__device__ __forceinline__ unsigned mask_flags(unsigned not_wall, unsigned fluid) {
  return (not_wall != 0 ? kNotWall : 0u) | (fluid != 0 ? kFluid : 0u);
}

struct VelocityFlags {
  __device__ __forceinline__ unsigned operator()(unsigned code, unsigned not_wall,
                                                 unsigned fluid) const {
    return (code & kCode) | mask_flags(not_wall, fluid);
  }
};

struct DyeFlags {
  __device__ __forceinline__ unsigned operator()(unsigned inflow, unsigned not_wall,
                                                 unsigned fluid) const {
    return (inflow != 0 ? kInflow : 0u) | mask_flags(not_wall, fluid);
  }
};

// ∇²f at (i, j), f0 = f(i, j), by the paired second differences
// (ops/cip.py:diff2_sum).
template <typename A>
__device__ __forceinline__ float laplacian(const A& f, int i, int j, float f0,
                                           const CipConsts& c) {
  return (f(i + 1, j) - 2.0f * f0 + f(i - 1, j)) * c.inv_dx2
         + (f(i, j + 1) - 2.0f * f0 + f(i, j - 1)) * c.inv_dx2;
}

// Non-advection step of velocity channel ch: f + (−∂p + ∇²f/Re)·dt
// (ops/cip.py:non_advection_velocity), ∂x p for channel 0, ∂y p for 1.
template <typename A, typename P>
__device__ __forceinline__ float velocity_na_cell(const A& f, const P& p, int ch, int i, int j,
                                                  const CipConsts& c) {
  const float f0 = f(i, j);
  const float lap = laplacian(f, i, j, f0, c);
  const float gp = ch == 0 ? 0.5f * (p(i + 1, j) - p(i - 1, j)) * c.inv_dx
                           : 0.5f * (p(i, j + 1) - p(i, j - 1)) * c.inv_dx;
  const float rhs = -gp + lap * c.inv_re;
  return f0 + rhs * c.dt;
}

// Non-advection step of a dye channel: f + (∇²f/Re)·dt
// (ops/cip.py:non_advection_diffusion).
template <typename A>
__device__ __forceinline__ float diffusion_na_cell(const A& f, int i, int j, const CipConsts& c) {
  const float f0 = f(i, j);
  return f0 + (laplacian(f, i, j, f0, c) * c.inv_re) * c.dt;
}

// Gradient update from the non-advection change Δ = f_na − f_bc
// (ops/cip.py:non_advection_grad, fs/solver.py:242-261): gx + (Δ(i+1, j) −
// Δ(i−1, j))/(2dx), gy likewise along j.
template <typename NA, typename BC>
__device__ __forceinline__ float grad_update_x(float gx, const NA& fn, const BC& fb, int i, int j,
                                               const CipConsts& c) {
  return gx + ((fn(i + 1, j) - fb(i + 1, j)) - (fn(i - 1, j) - fb(i - 1, j))) * c.inv_two_dx;
}

template <typename NA, typename BC>
__device__ __forceinline__ float grad_update_y(float gy, const NA& fn, const BC& fb, int i, int j,
                                               const CipConsts& c) {
  return gy + ((fn(i, j + 1) - fb(i, j + 1)) - (fn(i, j - 1) - fb(i, j - 1))) * c.inv_two_dx;
}

// The windows of a TX × TY tile: NC chunks a row (pitch P); H3, H2, H1 rows
// for a halo of 3, 2, 1 cells.
template <int TX, int TY>
struct Tile {
  static_assert(TY % kV == 0, "a tile's width is a whole number of chunks");
  static constexpr int NC = TY / kV + 2, P = NC * kV;
  static constexpr int H3 = TX + 6, H2 = TX + 4, H1 = TX + 2;
};

template <int TX, int TY>
struct VelocityTile : Tile<TX, TY> {
  using B = Tile<TX, TY>;
  // v_bc ×2 and p on the tile + 3, v_na ×2 on + 2, one channel's gradients
  // on + 1, as float; the flags on + 3.
  static constexpr int kFloats = (3 * B::H3 + 2 * B::H2 + 2 * B::H1) * B::P;
  static constexpr int kBytes = 4 * kFloats + B::H3 * B::P;
};

template <int TX, int TY>
struct DyeTile : Tile<TX, TY> {
  using B = Tile<TX, TY>;
  // d_bc on the tile + 3, d_na on + 2, the gradients and the carrying
  // velocity on + 1, as float; the flags on + 3.
  static constexpr int kFloats = (B::H3 + B::H2 + 4 * B::H1) * B::P;
  static constexpr int kBytes = 4 * kFloats + B::H3 * B::P;
};

// The velocity phase on one TX × TY tile, both channels. Fields (2, X, Y)
// but p (X, Y); the masks (X, Y) int8. vec: every plane allows aligned
// chunk loads.
template <typename S, int TX, int TY>
__global__ void __launch_bounds__(kThreads) cip_velocity_fused_kernel(
    const S* __restrict__ v, const S* __restrict__ p, const S* __restrict__ v_alt,
    const S* __restrict__ vx, const S* __restrict__ vx_alt, const S* __restrict__ vy,
    const S* __restrict__ vy_alt, const S* __restrict__ bc_const,
    const int8_t* __restrict__ vbc_code, const int8_t* __restrict__ not_wall8,
    const int8_t* __restrict__ fluid8, S* __restrict__ v_out, S* __restrict__ vx_out,
    S* __restrict__ vy_out, S* __restrict__ v_na, S* __restrict__ vx_na, S* __restrict__ vy_na,
    Grid g, CipConsts c, int vec) {
  using T = VelocityTile<TX, TY>;
  constexpr int NC = T::NC, P = T::P, H3 = T::H3, H2 = T::H2, H1 = T::H1;
  extern __shared__ __align__(16) float smem[];
  float* const s_bc0 = smem;
  float* const s_bc1 = s_bc0 + H3 * P;
  float* const s_p = s_bc1 + H3 * P;
  float* const s_na0 = s_p + H3 * P;
  float* const s_na1 = s_na0 + H2 * P;
  float* const s_gx = s_na1 + H2 * P;
  float* const s_gy = s_gx + H1 * P;
  uint8_t* const s_fl = reinterpret_cast<uint8_t*>(s_gy + H1 * P);
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - kV;
  const long long plane = g.plane();
  const Window<P> bc0{s_bc0, ti - 3, c0}, bc1{s_bc1, ti - 3, c0}, pw{s_p, ti - 3, c0};
  const Window<P> na0{s_na0, ti - 2, c0}, na1{s_na1, ti - 2, c0};
  const Window<P> gx{s_gx, ti - 1, c0}, gy{s_gy, ti - 1, c0};
  const Window<P, uint8_t> fl{s_fl, ti - 3, c0};

  // 0. The tile's operands from device memory: the flags, v and p on the
  //    tile + 3, channel 0's gradients on + 1.
  fill<H3, NC>(s_bc0, v, ti - 3, c0, g, vec);
  fill<H3, NC>(s_bc1, v + plane, ti - 3, c0, g, vec);
  fill<H3, NC>(s_p, p, ti - 3, c0, g, vec);
  fill<H1, NC>(s_gx, vx, ti - 1, c0, g, vec);
  fill<H1, NC>(s_gy, vy, ti - 1, c0, g, vec);
  f2d::fill_flags<H3, NC>(s_fl, ti - 3, c0, g, vec, VelocityFlags{}, vbc_code, not_wall8, fluid8);
  wait_fills();

  // 1. Velocity BC of both channels on the tile + 3, in place: an entry
  //    reads its own value and, at the few ghost, inflow and outflow cells,
  //    device memory.
  const Plane<S> v0{v, g}, v1{v + plane, g}, in0{bc_const, g}, in1{bc_const + plane, g};
  for_window<H3, TY + 6>(ti - 3, tj - 3, [&](int i0, int j0) {
    const int e = bc0.idx(i0, j0), i = g.clamp_i(i0), j = g.clamp_j(j0);
    const int code = fl(i, j) & kCode;
    const auto pre0 = [&](int a, int b) { return a == i && b == j ? s_bc0[e] : v0(a, b); };
    const auto pre1 = [&](int a, int b) { return a == i && b == j ? s_bc1[e] : v1(a, b); };
    s_bc0[e] = f2d::velocity_bc_cell(pre0, in0, code, 0, i, j);
    s_bc1[e] = f2d::velocity_bc_cell(pre1, in1, code, 1, i, j);
  });
  __syncthreads();

  // 2. Non-advection of both channels on the tile + 2 at not-wall cells,
  //    the alternate elsewhere.
  for_window<H2, TY + 4>(ti - 2, tj - 2, [&](int i0, int j0) {
    const int e = na0.idx(i0, j0), i = g.clamp_i(i0), j = g.clamp_j(j0);
    if ((fl(i, j) & kNotWall) != 0) {
      s_na0[e] = velocity_na_cell(bc0, pw, 0, i, j, c);
      s_na1[e] = velocity_na_cell(bc1, pw, 1, i, j, c);
    } else {
      const long long k = (long long)i * g.Y + j;
      s_na0[e] = f2d::ldg(v_alt, k);
      s_na1[e] = f2d::ldg(v_alt, plane + k);
    }
  });
  __syncthreads();

#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const Window<P>& bc = ch == 0 ? bc0 : bc1;
    const Window<P>& na = ch == 0 ? na0 : na1;
    if (ch == 1) {
      fill<H1, NC>(s_gx, vx + plane, ti - 1, c0, g, vec);
      fill<H1, NC>(s_gy, vy + plane, ti - 1, c0, g, vec);
      wait_fills();
    }
    // 3. Gradient update of this channel on the tile + 1, in place.
    for_window<H1, TY + 2>(ti - 1, tj - 1, [&](int i0, int j0) {
      const int e = gx.idx(i0, j0), i = g.clamp_i(i0), j = g.clamp_j(j0);
      if ((fl(i, j) & kNotWall) != 0) {
        s_gx[e] = grad_update_x(s_gx[e], na, bc, i, j, c);
        s_gy[e] = grad_update_y(s_gy[e], na, bc, i, j, c);
      } else {
        const long long kc = ch * plane + (long long)i * g.Y + j;
        s_gx[e] = f2d::ldg(vx_alt, kc);
        s_gy[e] = f2d::ldg(vy_alt, kc);
      }
    });
    __syncthreads();

    // 4. Advection of this channel on the tile, carried by both v_na
    //    planes; the pre-phase gradients re-read at the few non-fluid
    //    cells; the six stores.
    for_window<TX, TY>(ti, tj, [&](int i, int j) {
      if (i >= g.X || j >= g.Y) return;
      const long long kc = ch * plane + (long long)i * g.Y + j;
      f2d::CipCell r;
      if ((fl(i, j) & kFluid) != 0) {
        r = f2d::cip_advect_cell(na, gx, gy, na0, na1, i, j, c);
      } else {
        r.f = bc(i, j);
        r.fx = f2d::ldg(vx, kc);
        r.fy = f2d::ldg(vy, kc);
      }
      f2d::st(v_out, kc, r.f);
      f2d::st(vx_out, kc, r.fx);
      f2d::st(vy_out, kc, r.fy);
      f2d::st(v_na, kc, na(i, j));
      f2d::st(vx_na, kc, gx(i, j));
      f2d::st(vy_na, kc, gy(i, j));
    });
    if (ch == 0) __syncthreads();  // channel 1's gradients reuse s_gx, s_gy
  }
}

// The dye phase on one TX × TY tile of channel blockIdx.z. Dye fields
// (C, X, Y), vel (2, X, Y), the masks (X, Y) int8; vec as above.
template <typename S, int TX, int TY>
__global__ void __launch_bounds__(kThreads) cip_dye_fused_kernel(
    const S* __restrict__ dye, const S* __restrict__ dye_alt, const S* __restrict__ dyex,
    const S* __restrict__ dyex_alt, const S* __restrict__ dyey, const S* __restrict__ dyey_alt,
    const S* __restrict__ vel, const S* __restrict__ bc_dye, const int8_t* __restrict__ inflow8,
    const int8_t* __restrict__ not_wall8, const int8_t* __restrict__ fluid8,
    S* __restrict__ d_out, S* __restrict__ dx_out, S* __restrict__ dy_out,
    S* __restrict__ d_na, S* __restrict__ dx_na, S* __restrict__ dy_na, Grid g, CipConsts c,
    int vec) {
  using T = DyeTile<TX, TY>;
  constexpr int NC = T::NC, P = T::P, H3 = T::H3, H2 = T::H2, H1 = T::H1;
  extern __shared__ __align__(16) float smem[];
  float* const s_bc = smem;
  float* const s_na = s_bc + H3 * P;
  float* const s_gx = s_na + H2 * P;
  float* const s_gy = s_gx + H1 * P;
  float* const s_u = s_gy + H1 * P;
  float* const s_w = s_u + H1 * P;
  uint8_t* const s_fl = reinterpret_cast<uint8_t*>(s_w + H1 * P);
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - kV;
  const long long off = blockIdx.z * g.plane();
  const Window<P> bc{s_bc, ti - 3, c0}, na{s_na, ti - 2, c0};
  const Window<P> gx{s_gx, ti - 1, c0}, gy{s_gy, ti - 1, c0};
  const Window<P> u{s_u, ti - 1, c0}, w{s_w, ti - 1, c0};
  const Window<P, uint8_t> fl{s_fl, ti - 3, c0};

  // 0. The tile's operands from device memory: the flags and the dye on the
  //    tile + 3, its gradients and the carrying velocity on + 1.
  fill<H3, NC>(s_bc, dye + off, ti - 3, c0, g, vec);
  fill<H1, NC>(s_gx, dyex + off, ti - 1, c0, g, vec);
  fill<H1, NC>(s_gy, dyey + off, ti - 1, c0, g, vec);
  fill<H1, NC>(s_u, vel, ti - 1, c0, g, vec);
  fill<H1, NC>(s_w, vel + g.plane(), ti - 1, c0, g, vec);
  f2d::fill_flags<H3, NC>(s_fl, ti - 3, c0, g, vec, DyeFlags{}, inflow8, not_wall8, fluid8);
  wait_fills();

  // 1. Dye BC on the tile + 3, in place.
  const Plane<S> colours{bc_dye + off, g};
  for_window<H3, TY + 6>(ti - 3, tj - 3, [&](int i0, int j0) {
    const int e = bc.idx(i0, j0), i = g.clamp_i(i0), j = g.clamp_j(j0);
    const auto pre = [&](int, int) { return s_bc[e]; };
    s_bc[e] = f2d::dye_bc_cell(pre, colours, fl(i, j) & kInflow, i, j);
  });
  __syncthreads();

  // 2. Diffusion on the tile + 2 at not-wall cells, the alternate elsewhere.
  for_window<H2, TY + 4>(ti - 2, tj - 2, [&](int i0, int j0) {
    const int i = g.clamp_i(i0), j = g.clamp_j(j0);
    s_na[na.idx(i0, j0)] = (fl(i, j) & kNotWall) != 0
                               ? diffusion_na_cell(bc, i, j, c)
                               : f2d::ldg(dye_alt, off + (long long)i * g.Y + j);
  });
  __syncthreads();

  // 3. Gradient update on the tile + 1, in place.
  for_window<H1, TY + 2>(ti - 1, tj - 1, [&](int i0, int j0) {
    const int e = gx.idx(i0, j0), i = g.clamp_i(i0), j = g.clamp_j(j0);
    if ((fl(i, j) & kNotWall) != 0) {
      s_gx[e] = grad_update_x(s_gx[e], na, bc, i, j, c);
      s_gy[e] = grad_update_y(s_gy[e], na, bc, i, j, c);
    } else {
      const long long kc = off + (long long)i * g.Y + j;
      s_gx[e] = f2d::ldg(dyex_alt, kc);
      s_gy[e] = f2d::ldg(dyey_alt, kc);
    }
  });
  __syncthreads();

  // 4. Advection on the tile by the given velocity, the [0, 1] clamp
  //    (fminf/fmaxf: NaN → 0) on every cell's value; the pre-phase
  //    gradients re-read at the few non-fluid cells; the six stores.
  for_window<TX, TY>(ti, tj, [&](int i, int j) {
    if (i >= g.X || j >= g.Y) return;
    const long long kc = off + (long long)i * g.Y + j;
    f2d::CipCell r;
    if ((fl(i, j) & kFluid) != 0) {
      r = f2d::cip_advect_cell(na, gx, gy, u, w, i, j, c);
    } else {
      r.f = bc(i, j);
      r.fx = f2d::ldg(dyex, kc);
      r.fy = f2d::ldg(dyey, kc);
    }
    f2d::st(d_out, kc, fminf(fmaxf(r.f, 0.0f), 1.0f));
    f2d::st(dx_out, kc, r.fx);
    f2d::st(dy_out, kc, r.fy);
    f2d::st(d_na, kc, na(i, j));
    f2d::st(dx_na, kc, gx(i, j));
    f2d::st(dy_na, kc, gy(i, j));
  });
}

// The standalone advection's windows on a TX × TY tile: the carrying
// velocity's two planes and one channel's f, fx, fy on the tile + 1, as
// float; one flag byte a cell (fluid) on the tile.
template <int TX, int TY>
struct AdvectTile : Tile<TX, TY> {
  using B = Tile<TX, TY>;
  static constexpr int kFloats = 5 * B::H1 * B::P;
  static constexpr int kBytes = 4 * kFloats + TX * B::P;
};

struct FluidFlag {  // fill_flags' packing of the fluid byte
  __device__ __forceinline__ unsigned operator()(unsigned fluid) const { return fluid != 0; }
};

// Standalone CIP advection on one TX × TY tile, every channel: the advected
// (f, fx, fy) at fluid cells, the alternates elsewhere. f, fx, fy, the
// alternates and the outputs (C, X, Y); u, w (X, Y); fluid8 (X, Y) int8.
// self: u and w are f's first two planes (the velocity advecting itself),
// whose windows then serve as those channels' f windows. vec as above.
template <typename S, int TX, int TY>
__global__ void __launch_bounds__(kThreads, kAdvectBlocks<S>) cip_advect_fused_kernel(
    const S* __restrict__ f, const S* __restrict__ fx, const S* __restrict__ fy,
    const S* __restrict__ u, const S* __restrict__ w, const S* __restrict__ alt_f,
    const S* __restrict__ alt_fx, const S* __restrict__ alt_fy,
    const int8_t* __restrict__ fluid8, S* __restrict__ out_f, S* __restrict__ out_fx,
    S* __restrict__ out_fy, Grid g, int C, CipConsts c, int vec, int self) {
  using T = AdvectTile<TX, TY>;
  constexpr int NC = T::NC, P = T::P, H1 = T::H1;
  extern __shared__ __align__(16) float smem[];
  float* const s_u = smem;
  float* const s_w = s_u + H1 * P;
  float* const s_f = s_w + H1 * P;
  float* const s_fx = s_f + H1 * P;
  float* const s_fy = s_fx + H1 * P;
  uint8_t* const s_fl = reinterpret_cast<uint8_t*>(s_fy + H1 * P);
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - kV;
  const long long plane = g.plane();
  const Window<P> uw{s_u, ti - 1, c0}, ww{s_w, ti - 1, c0}, fw{s_f, ti - 1, c0};
  const Window<P> gx{s_fx, ti - 1, c0}, gy{s_fy, ti - 1, c0};
  const Window<P, uint8_t> fl{s_fl, ti, c0};

  // 0. Once a tile: the velocity on the tile + 1, the flags on the tile.
  fill<H1, NC>(s_u, u, ti - 1, c0, g, vec);
  fill<H1, NC>(s_w, w, ti - 1, c0, g, vec);
  f2d::fill_flags<TX, NC>(s_fl, ti, c0, g, vec, FluidFlag{}, fluid8);

  for (int ch = 0; ch < C; ++ch) {
    // 1. This channel's f, fx, fy on the tile + 1 (f already there when it
    //    is a velocity plane), into the windows the last channel freed.
    const long long off = ch * plane;
    const bool own = self != 0 && ch < 2;
    if (ch > 0) __syncthreads();
    if (!own) fill<H1, NC>(s_f, f + off, ti - 1, c0, g, vec);
    fill<H1, NC>(s_fx, fx + off, ti - 1, c0, g, vec);
    fill<H1, NC>(s_fy, fy + off, ti - 1, c0, g, vec);
    wait_fills();

    // 2. Advection on the tile at fluid cells, the alternates (read only
    //    there) elsewhere; three stores.
    const Window<P> fc = own ? (ch == 0 ? uw : ww) : fw;
    for_window<TX, TY>(ti, tj, [&](int i, int j) {
      if (i >= g.X || j >= g.Y) return;
      const long long k = off + (long long)i * g.Y + j;
      f2d::CipCell r;
      if (fl(i, j) != 0) {
        r = f2d::cip_advect_cell(fc, gx, gy, uw, ww, i, j, c);
      } else {
        r.f = f2d::ldg(alt_f, k);
        r.fx = f2d::ldg(alt_fx, k);
        r.fy = f2d::ldg(alt_fy, k);
      }
      f2d::st(out_f, k, r.f);
      f2d::st(out_fx, k, r.fx);
      f2d::st(out_fy, k, r.fy);
    });
  }
}

template <typename S>
int cip_velocity_phase(const void* const* in, const int8_t* vbc_code, const int8_t* not_wall8,
                       const int8_t* fluid8, void* const* out, Grid g, CipConsts c,
                       cudaStream_t s) {
  constexpr int bytes = VelocityTile<kTileX, kTileY>::kBytes;
  constexpr auto kernel = cip_velocity_fused_kernel<S, kTileX, kTileY>;
  if (const cudaError_t err = allow_smem<kernel>(bytes); err != cudaSuccess) return (int)err;
  auto i = [in](int k) { return static_cast<const S*>(in[k]); };
  auto o = [out](int k) { return static_cast<S*>(out[k]); };
  const void* planes[] = {in[0], in[1], in[2], in[3], in[4],  in[5],
                          in[6], in[7], vbc_code, not_wall8, fluid8};
  kernel<<<tile_blocks(g, kTileX, kTileY, 1), kThreads, bytes, s>>>(
      i(0), i(1), i(2), i(3), i(4), i(5), i(6), i(7), vbc_code, not_wall8, fluid8, o(0), o(1),
      o(2), o(3), o(4), o(5), g, c, chunk_loads(g, planes, 11));
  F2D_CHECK_LAUNCH();
  return 0;
}

template <typename S>
int cip_dye_phase(const void* const* in, const int8_t* inflow8, const int8_t* not_wall8,
                  const int8_t* fluid8, void* const* out, Grid g, int C, CipConsts c,
                  cudaStream_t s) {
  constexpr int bytes = DyeTile<kTileX, kTileY>::kBytes;
  constexpr auto kernel = cip_dye_fused_kernel<S, kTileX, kTileY>;
  if (const cudaError_t err = allow_smem<kernel>(bytes); err != cudaSuccess) return (int)err;
  auto i = [in](int k) { return static_cast<const S*>(in[k]); };
  auto o = [out](int k) { return static_cast<S*>(out[k]); };
  const void* planes[] = {in[0], in[1], in[2], in[3], in[4],  in[5],
                          in[6], in[7], inflow8, not_wall8, fluid8};
  kernel<<<tile_blocks(g, kTileX, kTileY, C), kThreads, bytes, s>>>(
      i(0), i(1), i(2), i(3), i(4), i(5), i(6), i(7), inflow8, not_wall8, fluid8, o(0), o(1),
      o(2), o(3), o(4), o(5), g, c, chunk_loads(g, planes, 11));
  F2D_CHECK_LAUNCH();
  return 0;
}

// Standalone CIP advection (C1): every plane of storage type S, widened on
// load; each output rounded once. One launch, a block a tile.
template <typename S>
int cip_advect(const void* f, const void* fx, const void* fy, const void* u, const void* w,
               const void* alt_f, const void* alt_fx, const void* alt_fy, const int8_t* fluid8,
               void* out_f, void* out_fx, void* out_fy, Grid g, int C, CipConsts c,
               cudaStream_t s) {
  constexpr int bytes = AdvectTile<kTileX, kTileY>::kBytes;
  constexpr auto kernel = cip_advect_fused_kernel<S, kTileX, kTileY>;
  if (const cudaError_t err = allow_smem<kernel>(bytes); err != cudaSuccess) return (int)err;
  auto in = [](const void* p) { return static_cast<const S*>(p); };
  auto out = [](void* p) { return static_cast<S*>(p); };
  const int self = u == f && w == in(f) + g.plane();
  const void* planes[] = {f, fx, fy, u, w, alt_f, alt_fx, alt_fy, fluid8};
  kernel<<<tile_blocks(g, kTileX, kTileY, 1), kThreads, bytes, s>>>(
      in(f), in(fx), in(fy), in(u), in(w), in(alt_f), in(alt_fx), in(alt_fy), fluid8,
      out(out_f), out(out_fx), out(out_fy), g, C, c, chunk_loads(g, planes, 9), self);
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Standalone CIP advection (replaces fluid2d_tpu/ops/pallas_stencil.py:
// cip_advect_pallas): where(fluid, cip_advect(f, fx, fy, u, w), alt) per
// output. f, fx, fy, alt_f, alt_fx, alt_fy and the three outputs are
// (C, X, Y); u and w (X, Y) planes: the carrying velocity's two planes, or
// f's first two when the velocity advects itself (the read-only pointers may
// alias; no output aliases an input, the wrapper checks). Every field is
// stored as bf16 when bf16_storage != 0, else as float; fluid8 (X, Y) int8.
// Constants: dt, dx, dx², dx³, 1/dx, 1/dx², rounded as CipConsts says.
extern "C" int f2d_cip_advect(const void* f, const void* fx, const void* fy, const void* u,
                              const void* w, const void* alt_f, const void* alt_fx,
                              const void* alt_fy, const int8_t* fluid8, void* out_f, void* out_fx,
                              void* out_fy, int X, int Y, int C, int bf16_storage, float dt,
                              float dx, float dx2, float dx3, float inv_dx, float inv_dx2,
                              void* stream) {
  const CipConsts c{dt, dx, dx2, dx3, inv_dx, inv_dx2, 0.0f, 0.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_storage) {
    return cip_advect<bf16>(f, fx, fy, u, w, alt_f, alt_fx, alt_fy, fluid8, out_f, out_fx, out_fy,
                            Grid{X, Y}, C, c, s);
  }
  return cip_advect<float>(f, fx, fy, u, w, alt_f, alt_fx, alt_fy, fluid8, out_f, out_fx, out_fy,
                           Grid{X, Y}, C, c, s);
}

// The velocity phase. v, v_alt, vx, vx_alt, vy, vy_alt, bc_const and the
// six outputs (2, X, Y); p (X, Y); the masks (X, Y) int8. Outputs: the
// advected (v, vx, vy) and the new alternates (v_na, vx_na, vy_na). Every
// field is stored as bf16 when bf16_storage != 0, else as float. The grid
// constants are those of CipConsts, in its order.
extern "C" int f2d_cip_velocity_phase(
    const void* v, const void* p, const void* v_alt, const void* vx, const void* vx_alt,
    const void* vy, const void* vy_alt, const void* bc_const, const int8_t* vbc_code,
    const int8_t* not_wall8, const int8_t* fluid8, void* v_out, void* vx_out, void* vy_out,
    void* v_na, void* vx_na, void* vy_na, int X, int Y, int bf16_storage, float dt, float dx,
    float dx2, float dx3, float inv_dx, float inv_dx2, float inv_re, float inv_two_dx,
    void* stream) {
  const void* in[] = {v, p, v_alt, vx, vx_alt, vy, vy_alt, bc_const};
  void* out[] = {v_out, vx_out, vy_out, v_na, vx_na, vy_na};
  const CipConsts c{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_storage) {
    return cip_velocity_phase<bf16>(in, vbc_code, not_wall8, fluid8, out, Grid{X, Y}, c, s);
  }
  return cip_velocity_phase<float>(in, vbc_code, not_wall8, fluid8, out, Grid{X, Y}, c, s);
}

// The dye phase. Dye fields, bc_dye and the six outputs (C, X, Y); vel
// (2, X, Y), the limited velocity; the masks (X, Y) int8. Storage and
// constants as above.
extern "C" int f2d_cip_dye_phase(
    const void* dye, const void* dye_alt, const void* dyex, const void* dyex_alt,
    const void* dyey, const void* dyey_alt, const void* vel, const void* bc_dye,
    const int8_t* inflow8, const int8_t* not_wall8, const int8_t* fluid8, void* d_out,
    void* dx_out, void* dy_out, void* d_na, void* dx_na, void* dy_na, int X, int Y, int C,
    int bf16_storage, float dt, float dx, float dx2, float dx3, float inv_dx, float inv_dx2,
    float inv_re, float inv_two_dx, void* stream) {
  const void* in[] = {dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, bc_dye};
  void* out[] = {d_out, dx_out, dy_out, d_na, dx_na, dy_na};
  const CipConsts c{dt, dx, dx2, dx3, inv_dx, inv_dx2, inv_re, inv_two_dx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_storage) {
    return cip_dye_phase<bf16>(in, inflow8, not_wall8, fluid8, out, Grid{X, Y}, C, c, s);
  }
  return cip_dye_phase<float>(in, inflow8, not_wall8, fluid8, out, Grid{X, Y}, C, c, s);
}
