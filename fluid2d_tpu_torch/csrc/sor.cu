// Red-black SOR: one or two iterations in one launch, optionally with the
// velocity-norm limiter.
//
// Replaces fluid2d_tpu/ops/pallas_stencil.py:sor_iteration_pallas (core
// _sor_core, n_iters 1 or 2; BC _pressure_bc_expr, prediction
// _predict_p_expr). The arithmetic is the port's eager ops/pressure.py,
// n_iters chained iterations, operation for operation, rounded as PyTorch
// rounds it on the card (common.cuh); the BC, the prediction and the limiter
// are the cell rules of pressure.cuh, shared with the Jacobi kernel. An
// iteration is
//   1. pressure BC  p_cur -> bc    (out of place: the inflow code 9 reads
//                                   (i+1, j), which may itself be rewritten)
//   2. odd sweep    bc -> pn       the relaxed value at odd fluid cells, the
//                                  alt value elsewhere: the caller's p_alt in
//                                  the first iteration, the first iteration's
//                                  bc in the second (_sor_core:1221)
//   3. even sweep   pn -> pn'      the relaxed value at even fluid cells,
//                                  from pn's odd neighbours and its own value
// and returns (pn', bc). Parity is the global (i + j) % 2.
//
// One launch a call. A block owns a TX × TY tile of output cells and runs
// every stage of every iteration on it, as the fused CIP phases do
// (cip_phases.cu, tile.cuh): each stage reaches one cell, so an iteration
// consumes three cells of halo, and p_cur's window spans the tile + 3·n_iters.
// Three float windows of that size take the stages in turn, out of place, so
// no stage reads a window it writes: with n_iters = 2
//   A: p_cur (+6)  ->  even sweep 1 (+3)
//   B: BC 1 (+5)   ->  odd sweep 2 onto BC 1 (+1)
//   C: p_alt (+4)  ->  odd sweep 1 onto p_alt (+4)  ->  BC 2 (+2)
// and the even sweep 2 goes from B straight to the stores on the tile, with
// BC 2 from C (the new p_alt) and, with the limiter, the limited velocity.
// Each window entry holds the stage's value at its clamped cell, computed
// there with that cell's parity, so the values are the eager path's float32
// values to the bit; u, w and a flag byte a cell (BC code, fluid) sit in
// windows on the tile + 3·n_iters − 1. Only p_cur, p_alt, u, w and the two
// int8 planes are read from device memory, once a block (the halo rows a
// neighbouring tile also reads come from L2), and only the outputs are
// written: the pair of a two-iteration call stays in shared memory.
//
// Storage types. The velocity (and the limited velocity) is of the state's
// type TV; the pair read, TI, and the pair returned, TO, are TV or float,
// because a chain of calls keeps its pair in float between calls and rounds
// it once at the end (fluid2d_tpu/models/common.py:98-119). The windows are
// float; each output is rounded once, at its store.
#include "common.cuh"
#include "pressure.cuh"
#include "tile.cuh"

using f2d::bf16;
using f2d::for_window;
using f2d::Grid;
using f2d::kCode;
using f2d::kSwept;
using f2d::kThreads;
using f2d::kV;
using f2d::predict_p;
using f2d::PressureFlags;
using f2d::PressureOut;
using f2d::Window;

namespace {

// Output tile of a block, rows × columns: the fastest of the shapes timed on
// the card (PERF.md §6).
constexpr int kTileX = 32, kTileY = 32;

struct SorConsts {
  float omega, one_minus_omega, dx, inv_eight_dt, v_limit;
};

// The windows of an N-iteration call on a TX × TY tile: the three pressure
// windows on the tile + H rows, u, w and the flags on + (H − 1); all on the
// columns of the tile ± CH (whole chunks), NC chunks a row, pitch P.
template <int N, int TX, int TY>
struct SorTile {
  static_assert(TY % kV == 0, "a tile's width is a whole number of chunks");
  static constexpr int H = 3 * N;
  static constexpr int CH = (H + kV - 1) / kV * kV;
  static constexpr int NC = TY / kV + 2 * CH / kV, P = NC * kV;
  static constexpr int RP = TX + 2 * H, RV = TX + 2 * (H - 1);
  static constexpr int kBytes = 4 * (3 * RP + 2 * RV) * P + RV * P;
};

// The relaxed value (1 − ω)·p + ω·predict_p at (i, j) of the pressure p.
template <int P, typename V>
__device__ __forceinline__ float relax(const Window<P>& p, const V& u, const V& w, int i, int j,
                                       const SorConsts& c) {
  return c.one_minus_omega * p(i, j) + c.omega * predict_p(p, u, w, i, j, c.dx, c.inv_eight_dt);
}

// fn(r, c) for every pair of cells (r, c), (r, c + 1) of the H × W region
// whose first cell is (i0, j0), W even. Consecutive threads take consecutive
// pairs of a row.
template <int H, int W, typename Fn>
__device__ __forceinline__ void for_pairs(int i0, int j0, Fn fn) {
  static_assert(W % 2 == 0, "a region of whole pairs");
  constexpr int WP = W / 2;
#pragma unroll 2
  for (int e = threadIdx.x; e < H * WP; e += kThreads) fn(i0 + e / WP, j0 + 2 * (e % WP));
}

// One iteration on the windows, whose entries all start at row wi0 and
// column c0: `cur` holds the pressure on the tile + h, `alt` the alt value
// on + (h − 2). The BC goes to `bc` on + (h − 1), the odd sweep onto `alt`
// on + (h − 2); the even sweep goes back into `cur` on + (h − 3), or, in the
// last iteration (h = 3), to the outputs with `bc` and the limiter.
//
// A sweep relaxes the cells of one parity, so a thread takes a pair of
// neighbours in a row, of which one has that parity wherever both lie in
// the grid: every thread relaxes one cell, where one thread a cell would
// leave half of each warp idle. A pair at the grid's column edge, whose
// positions may clamp to one cell, is taken position by position.
template <int h, int TX, int TY, int P, typename V, typename TO, typename TV>
__device__ __forceinline__ void sor_once(float* cur, float* bc, float* alt, int ti, int tj,
                                         int wi0, int c0, const Window<P, uint8_t>& fl,
                                         const V& u, const V& w, const Grid& g,
                                         const SorConsts& c, const PressureOut<TO, TV>& out) {
  const Window<P> cw{cur, wi0, c0}, bw{bc, wi0, c0}, aw{alt, wi0, c0};
  const auto fluid = [&](int i, int j) { return (fl(i, j) & kSwept) != 0; };

  // 1. BC on the tile + (h − 1).
  for_window<TX + 2 * (h - 1), TY + 2 * (h - 1)>(ti - (h - 1), tj - (h - 1), [&](int i0, int j0) {
    const int i = g.clamp_i(i0), j = g.clamp_j(j0);
    bc[bw.idx(i0, j0)] = f2d::pressure_bc_cell(cw, fl(i, j) & kCode, i, j);
  });
  __syncthreads();

  // 2. Odd sweep on the tile + (h − 2), onto the alt values.
  for_pairs<TX + 2 * (h - 2), TY + 2 * (h - 2)>(ti - (h - 2), tj - (h - 2), [&](int r, int j0) {
    const int i = g.clamp_i(r);
    if (j0 >= 0 && j0 + 1 < g.Y) {
      const int j = j0 + (((i + j0) & 1) ^ 1);  // the pair's odd cell
      if (fluid(i, j)) alt[aw.idx(r, j)] = relax(bw, u, w, i, j, c);
    } else {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int j = g.clamp_j(j0 + d);
        if (fluid(i, j) && ((i + j) & 1) != 0) alt[aw.idx(r, j0 + d)] = relax(bw, u, w, i, j, c);
      }
    }
  });
  __syncthreads();

  // 3. Even sweep: reads the odd sweep's values and writes elsewhere.
  if constexpr (h > 3) {
    for_pairs<TX + 2 * (h - 3), TY + 2 * (h - 3)>(ti - (h - 3), tj - (h - 3), [&](int r, int j0) {
      const int i = g.clamp_i(r);
      if (j0 >= 0 && j0 + 1 < g.Y) {
        const int je = j0 + ((i + j0) & 1), jo = 2 * j0 + 1 - je;  // even and odd cell
        cur[cw.idx(r, jo)] = aw(i, jo);
        cur[cw.idx(r, je)] = fluid(i, je) ? relax(aw, u, w, i, je, c) : aw(i, je);
      } else {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = g.clamp_j(j0 + d);
          const bool even_fluid = fluid(i, j) && ((i + j) & 1) == 0;
          cur[cw.idx(r, j0 + d)] = even_fluid ? relax(aw, u, w, i, j, c) : aw(i, j);
        }
      }
    });
    __syncthreads();
  } else {
    // The tile's pairs start at even columns (TY is even), all in the grid
    // but past a ragged edge; a pair in the grid is stored with one store a
    // plane where the row has an even length (its first cell's offset is even).
    const long long plane = g.plane();
    const bool even_rows = (g.Y & 1) == 0;
    const auto store = [&](int i, int j, float p) {
      const long long k = (long long)i * g.Y + j;
      f2d::st(out.p_out, k, p);
      f2d::st(out.p_bc, k, bw(i, j));
      if (out.v_lim != nullptr) f2d::limit_cell(u(i, j), w(i, j), out.v_lim, plane, k, c.v_limit);
    };
    for_pairs<TX, TY>(ti, tj, [&](int i, int j0) {
      if (i >= g.X || j0 >= g.Y) return;
      const bool odd_row = (i & 1) != 0, both = j0 + 1 < g.Y;
      const int je = j0 + odd_row, jo = j0 + 1 - odd_row;
      const float ve = je < g.Y ? (fluid(i, je) ? relax(aw, u, w, i, je, c) : aw(i, je)) : 0.0f;
      const float vo = jo < g.Y ? aw(i, jo) : 0.0f;
      const float p0 = odd_row ? vo : ve, p1 = odd_row ? ve : vo;
      if (both && even_rows) {
        const long long k = (long long)i * g.Y + j0;
        f2d::st_pair(out.p_out, k, p0, p1);
        f2d::st_pair(out.p_bc, k, bw(i, j0), bw(i, j0 + 1));
        if (out.v_lim != nullptr) {
          const float2 l0 = f2d::limited(u(i, j0), w(i, j0), c.v_limit);
          const float2 l1 = f2d::limited(u(i, j0 + 1), w(i, j0 + 1), c.v_limit);
          f2d::st_pair(out.v_lim, k, l0.x, l1.x);
          f2d::st_pair(out.v_lim, plane + k, l0.y, l1.y);
        }
      } else {
        store(i, j0, p0);
        if (both) store(i, j0 + 1, p1);
      }
    });
  }
}

// N (1 or 2) iterations on one TX × TY tile. p_cur, p_alt, u, w, the masks
// and the outputs are (X, Y) planes but v_lim (2, X, Y); vec: every plane
// allows aligned chunk loads.
template <typename TI, typename TO, typename TV, int N, int TX, int TY>
__global__ void __launch_bounds__(kThreads) sor_fused_kernel(
    const TI* __restrict__ p_cur, const TI* __restrict__ p_alt, const TV* __restrict__ u,
    const TV* __restrict__ w, const int8_t* __restrict__ pbc_code,
    const int8_t* __restrict__ fluid8, PressureOut<TO, TV> out, Grid g, SorConsts c, int vec) {
  using T = SorTile<N, TX, TY>;
  constexpr int H = T::H, NC = T::NC, P = T::P, RP = T::RP, RV = T::RV;
  extern __shared__ __align__(16) float smem[];
  float* const s_a = smem;
  float* const s_b = s_a + RP * P;
  float* const s_c = s_b + RP * P;
  float* const s_u = s_c + RP * P;
  float* const s_w = s_u + RV * P;
  uint8_t* const s_fl = reinterpret_cast<uint8_t*>(s_w + RV * P);
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - T::CH;
  const Window<P> uw{s_u, ti - (H - 1), c0}, ww{s_w, ti - (H - 1), c0};
  const Window<P, uint8_t> fl{s_fl, ti - (H - 1), c0};

  // 0. The operands: p_cur on the tile + H, p_alt on + (H − 2) (the first
  //    odd sweep's reach), u, w and the flags on + (H − 1).
  f2d::fill<RP, NC>(s_a, p_cur, ti - H, c0, g, vec);
  f2d::fill<RP - 4, NC>(s_c + 2 * P, p_alt, ti - (H - 2), c0, g, vec);
  f2d::fill<RV, NC>(s_u, u, ti - (H - 1), c0, g, vec);
  f2d::fill<RV, NC>(s_w, w, ti - (H - 1), c0, g, vec);
  f2d::fill_flags<RV, NC>(s_fl, ti - (H - 1), c0, g, vec, PressureFlags{}, pbc_code, fluid8);
  f2d::wait_fills();

  const int wi0 = ti - H;
  if constexpr (N == 2) {
    sor_once<6, TX, TY>(s_a, s_b, s_c, ti, tj, wi0, c0, fl, uw, ww, g, c, out);
    sor_once<3, TX, TY>(s_a, s_c, s_b, ti, tj, wi0, c0, fl, uw, ww, g, c, out);
  } else {
    sor_once<3, TX, TY>(s_a, s_b, s_c, ti, tj, wi0, c0, fl, uw, ww, g, c, out);
  }
}

template <typename TI, typename TO, typename TV, int N>
int sor_launch(const void* p_cur, const void* p_alt, const void* u, const void* w,
               const int8_t* pbc_code, const int8_t* fluid8, void* p_out, void* p_bc,
               void* v_lim, Grid g, SorConsts c, cudaStream_t s) {
  using T = SorTile<N, kTileX, kTileY>;
  constexpr auto kernel = sor_fused_kernel<TI, TO, TV, N, kTileX, kTileY>;
  if (const cudaError_t err = f2d::allow_smem<kernel>(T::kBytes); err != cudaSuccess) {
    return (int)err;
  }
  const void* planes[] = {p_cur, p_alt, u, w, pbc_code, fluid8};
  const PressureOut<TO, TV> out{static_cast<TO*>(p_out), static_cast<TO*>(p_bc),
                           static_cast<TV*>(v_lim)};
  kernel<<<f2d::tile_blocks(g, kTileX, kTileY, 1), kThreads, T::kBytes, s>>>(
      static_cast<const TI*>(p_cur), static_cast<const TI*>(p_alt), static_cast<const TV*>(u),
      static_cast<const TV*>(w), pbc_code, fluid8, out, g, c, f2d::chunk_loads(g, planes, 6));
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// n_iters (1 or 2) SOR iterations. p_cur, p_alt, u, w, pbc_code, fluid8,
// p_out and p_bc: (X, Y); v_lim: (2, X, Y), or null without the limiter.
// u, w and v_lim are bf16 when bf16_storage != 0, else float; the pair read
// is bf16 when in_bf16 != 0 and the pair returned when out_bf16 != 0 (both
// only with bf16 storage), else float. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these.
extern "C" int f2d_sor_iteration(const void* p_cur, const void* p_alt, const void* u,
                                 const void* w, const int8_t* pbc_code, const int8_t* fluid8,
                                 void* p_out, void* p_bc, void* v_lim, int X, int Y, int n_iters,
                                 int bf16_storage, int in_bf16, int out_bf16, float omega,
                                 float one_minus_omega, float dx, float inv_eight_dt,
                                 float v_limit, void* stream) {
  if (n_iters < 1 || n_iters > 2 || (!bf16_storage && (in_bf16 || out_bf16))) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g{X, Y};
  const SorConsts c{omega, one_minus_omega, dx, inv_eight_dt, v_limit};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2D_SOR(TI, TO, TV)                                                                   \
  (n_iters == 2 ? sor_launch<TI, TO, TV, 2>(p_cur, p_alt, u, w, pbc_code, fluid8, p_out, p_bc, \
                                            v_lim, g, c, s)                                   \
                : sor_launch<TI, TO, TV, 1>(p_cur, p_alt, u, w, pbc_code, fluid8, p_out, p_bc, \
                                            v_lim, g, c, s))
  if (!bf16_storage) return F2D_SOR(float, float, float);
  if (in_bf16) return out_bf16 ? F2D_SOR(bf16, bf16, bf16) : F2D_SOR(bf16, float, bf16);
  return out_bf16 ? F2D_SOR(float, bf16, bf16) : F2D_SOR(float, float, bf16);
#undef F2D_SOR
}

extern "C" const char* f2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
