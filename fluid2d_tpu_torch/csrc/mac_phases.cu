// The MAC velocity phase and the MAC dye phase, upwind or Kawamura-Kuwahara.
//
// Replace fluid2d_tpu/ops/pallas_phases.py:mac_velocity_phase_pallas (core
// _mac_velocity_core) and mac_dye_phase_pallas (_mac_dye_kernel and its
// variants). The arithmetic is the port's eager path (the jnp branches of
// fluid2d_tpu/models/mac.py, fluid2d_tpu_torch/ops/advection.py) operation
// for operation, rounded as PyTorch rounds it on the card (common.cuh):
// every difference is divided by its grid constant separately, as the jnp
// stencils do, not with 1/dx factored out of the sums as the Pallas window
// helpers do.
//
// Velocity phase, one launch (mac_velocity_fused_kernel), in the design of
// the dye phase below: a block owns a TX × TY tile of output cells of both
// velocity channels. It copies the pre-BC velocity into float windows on the
// tile + (H + 2), H = 1 (upwind) or 2 (KK): the BC's ghost mirrors read two
// cells away and the outflow rule one cell upstream; the pressure on the
// tile + 1 for ∇p; one flag byte a cell (vbc_code, fluid) on the tile + H.
// It then applies the BC (velocity_bc_cell, bc.cuh) on the tile + H, each
// entry at its clamped cell with that cell's code (bc_const read from device
// memory at the few inflow cells), in place at the cells with a code: every
// entry's BC is evaluated from the pre-BC windows before any is stored
// (tile.cuh:rewrite_in_place), so an entry past the grid holds the BC'd
// value at the clamped cell:
// what the KK stencil's ±2 reads of the jnp path's computed field give at the
// grid's edge (what the Pallas kernels rebuild with _reclamp). The update
// runs on the tile, four cells a thread along Y: v_bc + dt·((−adv(v_bc) − ∇p)
// + ∇²v_bc/Re) at fluid cells, the old alternate (read only there)
// elsewhere, and two stores a channel: the update and v_bc (the new
// alternate). Bound: bytes (v, p and two int8 planes read, v_alt and
// bc_const at the cells that need them, two (2, X, Y) planes written; ~40
// (upwind) to ~60 (KK) flops a cell and channel); nothing but the outputs
// is written.
//
// Dye phase, one launch (mac_dye_fused_kernel), as the fused CIP dye phase
// (cip_phases.cu, tile.cuh): a block owns a TX × TY tile of output cells of
// every dye channel. It copies each channel's dye into a float window one
// cell (upwind) or two (KK) wider than the tile on every side, and one flag
// byte a cell (inflow, fluid), then applies the inflow BC in place at each
// entry's clamped cell (dye_bc_cell; the scene's colours read from device
// memory at the few inflow cells), so an entry past the grid holds the BC'd
// value at the clamped cell, as in the velocity phase. The update then runs on
// the tile, four cells a thread along Y: d_bc − dt·adv(d_bc) by the limited
// velocity (read at the tile's cells only) at fluid cells, the old alternate
// (read only there) elsewhere, the [0, 1] clamp (fminf/fmaxf: NaN → 0), and
// two stores: d_bc (the new alternate, unclamped) and the clamped dye. The
// velocity and the masks are read once a tile for all channels. Bound: bytes
// (the dye, the velocity and two int8 planes read, two dye planes written;
// ~15–30 flops a cell and channel); nothing but the outputs is written.
//
// Storage type S (common.cuh): the state's planes, the scene's constants and
// every output are S; each output is rounded once, at its store.
#include "bc.cuh"
#include "common.cuh"
#include "tile.cuh"

using f2d::bf16;
using f2d::Grid;
using f2d::kThreads;
using f2d::kV;
using f2d::ld;
using f2d::Window;

namespace {

// Output tile of a fused block (either phase), rows × columns.
constexpr int kTileX = 32, kTileY = 32;
// A fused dye block takes every channel of its tile (the velocity and the
// masks read once a tile); false: one channel a blockIdx.z.
constexpr bool kAllChannels = true;

// The advection term (v·∇)φ at cell (i, j) of one channel, read through the
// cell accessor `phi` (common.cuh), carried by (u, w) at that cell
// (fluid2d_tpu/ops/advection.py). inv_adv is 1/dx (upwind) or 1/(6·dx)
// (KK). A NaN velocity compares false: upwind takes the backward
// difference, KK the positive-velocity coefficients.
template <bool kKK, typename A>
__device__ __forceinline__ float advect_term(const A& phi, int i, int j, float u, float w,
                                             float inv_adv) {
  const float f0 = phi(i, j);
  if constexpr (kKK) {
    const float p2x = phi(i + 2, j), p1x = phi(i + 1, j);
    const float m1x = phi(i - 1, j), m2x = phi(i - 2, j);
    const float sx = u < 0.0f ? -2.0f * p2x + 10.0f * p1x - 9.0f * f0 + 2.0f * m1x - 1.0f * m2x
                              : 1.0f * p2x - 2.0f * p1x + 9.0f * f0 - 10.0f * m1x + 2.0f * m2x;
    const float p2y = phi(i, j + 2), p1y = phi(i, j + 1);
    const float m1y = phi(i, j - 1), m2y = phi(i, j - 2);
    const float sy = w < 0.0f ? -2.0f * p2y + 10.0f * p1y - 9.0f * f0 + 2.0f * m1y - 1.0f * m2y
                              : 1.0f * p2y - 2.0f * p1y + 9.0f * f0 - 10.0f * m1y + 2.0f * m2y;
    const float a = sx * inv_adv;
    const float b = sy * inv_adv;
    return u * a + w * b;
  }
  const float dfx = u < 0.0f ? (phi(i + 1, j) - f0) * inv_adv : (f0 - phi(i - 1, j)) * inv_adv;
  const float dfy = w < 0.0f ? (phi(i, j + 1) - f0) * inv_adv : (f0 - phi(i, j - 1)) * inv_adv;
  const float ax = u * dfx;
  const float ay = w * dfy;
  return ax + ay;
}

struct MacConsts {
  float dt, inv_dx, inv_adv, inv_dx2, inv_re;  // as ops/cuda_phases.py rounds them
};

// A cell's flag byte in the fused velocity kernel's window: its vbc_code
// (0..6) in the low bits, then fluid.
constexpr unsigned kVelCode = 7u, kVelFluid = 8u;

struct VelFlags {  // fill_flags' packing of the (vbc_code, fluid) bytes
  __device__ __forceinline__ unsigned operator()(unsigned code, unsigned fluid) const {
    return (code & kVelCode) | (fluid != 0 ? kVelFluid : 0u);
  }
};

// The windows of the velocity phase on a TX × TY tile with a halo of H cells
// (1 upwind, 2 KK): a channel's velocity on RV rows from the tile's first
// row − (H + 2) (BC'd in place on the rows from − H), the pressure on RP rows
// from − 1, the flags on RB rows from − H; all on NC chunks a row from the
// tile's first column − kV (pitch P), which covers the + (H + 2) columns the
// BC reads.
template <bool kKK, int TX, int TY>
struct MacVelTile {
  static_assert(TY % kV == 0, "a tile's width is a whole number of chunks");
  static constexpr int H = kKK ? 2 : 1;
  static_assert(H + 2 <= kV, "the BC's reach fits one chunk beyond the tile");
  static constexpr int NC = TY / kV + 2, P = NC * kV;
  static constexpr int RV = TX + 2 * (H + 2), RB = TX + 2 * H, RP = TX + 2;
  static constexpr int kBytes = 4 * (2 * RV + RP) * P + RB * P;
};

// The velocity phase on one TX × TY tile, both channels. v, v_alt, bc_const
// and the outputs are (2, X, Y), p and the masks (X, Y); vec: every plane
// allows aligned chunk loads and stores.
template <typename S, bool kKK, int TX, int TY>
__global__ void __launch_bounds__(kThreads) mac_velocity_fused_kernel(
    const S* __restrict__ v, const S* __restrict__ p, const S* __restrict__ v_alt,
    const S* __restrict__ bc_const, const int8_t* __restrict__ vbc_code,
    const int8_t* __restrict__ fluid8, S* __restrict__ v_out, S* __restrict__ v_bc, Grid g,
    MacConsts c, int vec) {
  using T = MacVelTile<kKK, TX, TY>;
  constexpr int H = T::H, NC = T::NC, P = T::P, RV = T::RV, RB = T::RB, RP = T::RP;
  extern __shared__ __align__(16) float smem[];
  float* const s_v = smem;  // the velocity, channel after channel
  float* const s_p = s_v + 2 * RV * P;
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - kV;
  const long long plane = g.plane();
  const Window<P, uint8_t> fl{reinterpret_cast<uint8_t*>(s_p + RP * P), ti - H, c0};
  const Window<P> pw{s_p, ti - 1, c0};
  const Window<P> v0{s_v, ti - (H + 2), c0}, v1{s_v + RV * P, ti - (H + 2), c0};  // u, w

  // 0. The tile's operands: the pre-BC velocity on the tile + (H + 2), the
  //    pressure on + 1, the flags on + H.
  for (int ch = 0; ch < 2; ++ch) {
    f2d::fill<RV, NC>(s_v + ch * RV * P, v + ch * plane, ti - (H + 2), c0, g, vec);
  }
  f2d::fill<RP, NC>(s_p, p, ti - 1, c0, g, vec);
  f2d::fill_flags<RB, NC>(fl.s, ti - H, c0, g, vec, VelFlags{}, vbc_code, fluid8);
  f2d::wait_fills();

  // 1. The BC on the tile + H, at each entry's clamped cell, in place at the
  //    cells with a code.
  f2d::rewrite_in_place<RB, TY + 2 * H, 2>(
      ti - H, tj - H,
      [&](int i0, int j0, float (&r)[2]) {
        const int i = g.clamp_i(i0), j = g.clamp_j(j0);
        const int code = fl(i, j) & kVelCode;
        if (code == 0) return false;  // the BC keeps the velocity
        r[0] = f2d::velocity_bc_cell(v0, f2d::Plane<S>{bc_const, g}, code, 0, i, j);
        r[1] = f2d::velocity_bc_cell(v1, f2d::Plane<S>{bc_const + plane, g}, code, 1, i, j);
        return true;
      },
      [&](int i0, int j0, const float (&r)[2]) {
        s_v[v0.idx(i0, j0)] = r[0];
        s_v[RV * P + v0.idx(i0, j0)] = r[1];
      });

  // 2. The update on the tile, kV cells a thread along Y, as the dye phase
  //    runs its update; the old alternate read only at the non-fluid cells;
  //    two stores a channel.
  constexpr int kRowChunks = TY / kV;
  for (int it = threadIdx.x; it < TX * kRowChunks; it += kThreads) {
    const int i = ti + it / kRowChunks, j = tj + kV * (it % kRowChunks);
    if (i >= g.X || j >= g.Y) continue;
    const int n = min(kV, g.Y - j);
    const long long k = (long long)i * g.Y + j;
    for (int ch = 0; ch < 2; ++ch) {
      const Window<P> f{s_v + ch * RV * P, ti - (H + 2), c0};
      const long long off = ch * plane + k;
      float bc[kV], out[kV];
#pragma unroll
      for (int t = 0; t < kV; ++t) {
        const int jt = j + t;
        bc[t] = f(i, jt);
        out[t] = 0.0f;
        if (t >= n) continue;
        if ((fl(i, jt) & kVelFluid) == 0) {
          out[t] = f2d::ldg(v_alt, off + t);
          continue;
        }
        const float f0 = bc[t];
        const float adv = advect_term<kKK>(f, i, jt, v0(i, jt), v1(i, jt), c.inv_adv);
        const float gp = ch == 0 ? 0.5f * (pw(i + 1, jt) - pw(i - 1, jt)) * c.inv_dx
                                 : 0.5f * (pw(i, jt + 1) - pw(i, jt - 1)) * c.inv_dx;
        const float lap = (f(i + 1, jt) - 2.0f * f0 + f(i - 1, jt)) * c.inv_dx2
                          + (f(i, jt + 1) - 2.0f * f0 + f(i, jt - 1)) * c.inv_dx2;
        const float rhs = -adv - gp + lap * c.inv_re;
        out[t] = f0 + c.dt * rhs;
      }
      f2d::st_chunk(v_bc, off, bc, n, vec);
      f2d::st_chunk(v_out, off, out, n, vec);
    }
  }
}

template <typename S, bool kKK>
int mac_velocity_phase(const void* const* in, const int8_t* vbc_code, const int8_t* fluid8,
                       void* v_out, void* v_bc, Grid g, MacConsts c, cudaStream_t s) {
  using T = MacVelTile<kKK, kTileX, kTileY>;
  constexpr auto kernel = mac_velocity_fused_kernel<S, kKK, kTileX, kTileY>;
  if (const cudaError_t err = f2d::allow_smem<kernel>(T::kBytes); err != cudaSuccess) {
    return (int)err;
  }
  auto i = [in](int k) { return static_cast<const S*>(in[k]); };
  const void* planes[] = {in[0], in[1], in[2], in[3], vbc_code, fluid8, v_out, v_bc};
  kernel<<<f2d::tile_blocks(g, kTileX, kTileY, 1), kThreads, T::kBytes, s>>>(
      i(0), i(1), i(2), i(3), vbc_code, fluid8, static_cast<S*>(v_out), static_cast<S*>(v_bc),
      g, c, f2d::chunk_loads(g, planes, 8));
  F2D_CHECK_LAUNCH();
  return 0;
}

// A cell's flag byte in the fused dye kernel's window.
constexpr unsigned kInflow = 1u, kFluid = 2u;

struct DyeFlags {  // fill_flags' packing of the (inflow, fluid) bytes
  __device__ __forceinline__ unsigned operator()(unsigned inflow, unsigned fluid) const {
    return (inflow != 0 ? kInflow : 0u) | (fluid != 0 ? kFluid : 0u);
  }
};

// The windows of a TX × TY tile with a halo of H cells (1 upwind, 2 KK): R
// rows from the tile's first row − H, NC chunks a row from its first column
// − kV (pitch P). A channel's dye window holds kFloats floats; the flag
// window follows the last channel's.
template <bool kKK, int TX, int TY>
struct MacDyeTile {
  static_assert(TY % kV == 0, "a tile's width is a whole number of chunks");
  static constexpr int H = kKK ? 2 : 1;
  static constexpr int NC = TY / kV + 2, P = NC * kV, R = TX + 2 * H;
  static constexpr int kFloats = R * P;
  static constexpr int bytes(int channels) { return 4 * channels * kFloats + R * P; }
};

// The dye phase on one TX × TY tile: every channel (kAllChannels), or
// channel blockIdx.z. Dye fields (C, X, Y), vel (2, X, Y), the masks (X, Y)
// int8; vec: every plane allows aligned chunk loads and stores.
template <typename S, bool kKK, int TX, int TY>
__global__ void __launch_bounds__(kThreads) mac_dye_fused_kernel(
    const S* __restrict__ dye, const S* __restrict__ dye_alt, const S* __restrict__ vel,
    const S* __restrict__ bc_dye, const int8_t* __restrict__ inflow8,
    const int8_t* __restrict__ fluid8, S* __restrict__ d_out, S* __restrict__ d_bc, Grid g,
    int C, float dt, float inv_adv, int vec) {
  using T = MacDyeTile<kKK, TX, TY>;
  constexpr int H = T::H, NC = T::NC, P = T::P, R = T::R;
  extern __shared__ __align__(16) float smem[];
  const int first = kAllChannels ? 0 : blockIdx.z, channels = kAllChannels ? C : 1;
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - kV;
  const long long plane = g.plane();
  const Window<P, uint8_t> fl{reinterpret_cast<uint8_t*>(smem + channels * T::kFloats), ti - H,
                              c0};

  // 0. The tile's operands: each channel's dye and the flags on the tile + H.
  for (int c = 0; c < channels; ++c) {
    f2d::fill<R, NC>(smem + c * T::kFloats, dye + (first + c) * plane, ti - H, c0, g, vec);
  }
  f2d::fill_flags<R, NC>(fl.s, ti - H, c0, g, vec, DyeFlags{}, inflow8, fluid8);
  f2d::wait_fills();

  // 1. Inflow BC on the tile + H, in place, at each entry's clamped cell.
  f2d::for_window<R, TY + 2 * H>(ti - H, tj - H, [&](int i0, int j0) {
    const int i = g.clamp_i(i0), j = g.clamp_j(j0);
    const unsigned inflow = fl(i, j) & kInflow;
    if (inflow == 0) return;  // the BC keeps the dye
    const int e = fl.idx(i0, j0);
    for (int c = 0; c < channels; ++c) {
      float* const s = smem + c * T::kFloats;
      const auto pre = [&](int, int) { return s[e]; };
      s[e] = f2d::dye_bc_cell(pre, f2d::Plane<S>{bc_dye + (first + c) * plane, g}, inflow, i, j);
    }
  });
  __syncthreads();

  // 2. The update on the tile, kV cells a thread along Y (one cell a thread,
  //    which reads the windows without bank conflicts, was slower: PERF.md
  //    §6); the velocity read at the tile's cells once for every channel and
  //    widened at each use, the old alternate only at the non-fluid cells;
  //    two stores a channel.
  constexpr int kRowChunks = TY / kV;
  for (int it = threadIdx.x; it < TX * kRowChunks; it += kThreads) {
    const int i = ti + it / kRowChunks, j = tj + kV * (it % kRowChunks);
    if (i >= g.X || j >= g.Y) continue;
    const int n = min(kV, g.Y - j);
    const long long k = (long long)i * g.Y + j;
    const f2d::Chunk<S> uc = f2d::load_chunk(vel, i, j, g, vec);
    const f2d::Chunk<S> wc = f2d::load_chunk(vel + plane, i, j, g, vec);
    const S* const ue = reinterpret_cast<const S*>(&uc);
    const S* const we = reinterpret_cast<const S*>(&wc);
    for (int c = 0; c < channels; ++c) {
      const Window<P> f{smem + c * T::kFloats, ti - H, c0};
      const long long off = (first + c) * plane + k;
      float bc[kV], out[kV];
#pragma unroll
      for (int t = 0; t < kV; ++t) {
        bc[t] = f(i, j + t);
        float r = 0.0f;
        if (t < n) {
          r = (fl(i, j + t) & kFluid) != 0
                  ? bc[t] - dt * advect_term<kKK>(f, i, j + t, ld(ue, t), ld(we, t), inv_adv)
                  : f2d::ldg(dye_alt, off + t);
        }
        out[t] = fminf(fmaxf(r, 0.0f), 1.0f);
      }
      f2d::st_chunk(d_bc, off, bc, n, vec);
      f2d::st_chunk(d_out, off, out, n, vec);
    }
  }
}

template <typename S, bool kKK>
int mac_dye_phase(const void* const* in, const int8_t* inflow8, const int8_t* fluid8,
                  void* d_out, void* d_bc, Grid g, int C, float dt, float inv_adv,
                  cudaStream_t s) {
  constexpr auto kernel = mac_dye_fused_kernel<S, kKK, kTileX, kTileY>;
  const int bytes = MacDyeTile<kKK, kTileX, kTileY>::bytes(kAllChannels ? C : 1);
  if (bytes > 48 * 1024) {  // the default limit of dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  auto i = [in](int k) { return static_cast<const S*>(in[k]); };
  const void* planes[] = {in[0], in[1], in[2], in[3], inflow8, fluid8, d_out, d_bc};
  kernel<<<f2d::tile_blocks(g, kTileX, kTileY, kAllChannels ? 1 : C), kThreads, bytes, s>>>(
      i(0), i(1), i(2), i(3), inflow8, fluid8, static_cast<S*>(d_out), static_cast<S*>(d_bc), g,
      C, dt, inv_adv, f2d::chunk_loads(g, planes, 8));
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// The velocity phase. v, v_alt, bc_const, v_out, v_bc: (2, X, Y); p: (X, Y);
// the masks (X, Y) int8. v_bc is the BC'd input velocity, the new alternate.
// kk selects the scheme (0 upwind); every field is stored as bf16 when
// bf16_storage != 0, else as float.
extern "C" int f2d_mac_velocity_phase(const void* v, const void* p, const void* v_alt,
                                      const void* bc_const, const int8_t* vbc_code,
                                      const int8_t* fluid8, void* v_out, void* v_bc, int X, int Y,
                                      int kk, int bf16_storage, float dt, float inv_dx,
                                      float inv_adv, float inv_dx2, float inv_re, void* stream) {
  const void* in[] = {v, p, v_alt, bc_const};
  const Grid g{X, Y};
  const MacConsts c{dt, inv_dx, inv_adv, inv_dx2, inv_re};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_storage) {
    return kk ? mac_velocity_phase<bf16, true>(in, vbc_code, fluid8, v_out, v_bc, g, c, s)
              : mac_velocity_phase<bf16, false>(in, vbc_code, fluid8, v_out, v_bc, g, c, s);
  }
  return kk ? mac_velocity_phase<float, true>(in, vbc_code, fluid8, v_out, v_bc, g, c, s)
            : mac_velocity_phase<float, false>(in, vbc_code, fluid8, v_out, v_bc, g, c, s);
}

// The dye phase. dye, dye_alt, bc_dye, d_out, d_bc: (C, X, Y); vel (2, X, Y),
// the limited velocity; the masks (X, Y) int8. d_bc is the BC'd input dye,
// the new alternate (unclamped). kk selects the scheme (0 upwind); every
// field is stored as bf16 when bf16_storage != 0, else as float.
extern "C" int f2d_mac_dye_phase(const void* dye, const void* dye_alt, const void* vel,
                                 const void* bc_dye, const int8_t* inflow8, const int8_t* fluid8,
                                 void* d_out, void* d_bc, int X, int Y, int C, int kk,
                                 int bf16_storage, float dt, float inv_adv, void* stream) {
  const void* in[] = {dye, dye_alt, vel, bc_dye};
  const Grid g{X, Y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_storage) {
    return kk ? mac_dye_phase<bf16, true>(in, inflow8, fluid8, d_out, d_bc, g, C, dt, inv_adv, s)
              : mac_dye_phase<bf16, false>(in, inflow8, fluid8, d_out, d_bc, g, C, dt, inv_adv, s);
  }
  return kk ? mac_dye_phase<float, true>(in, inflow8, fluid8, d_out, d_bc, g, C, dt, inv_adv, s)
            : mac_dye_phase<float, false>(in, inflow8, fluid8, d_out, d_bc, g, C, dt, inv_adv, s);
}
