// Up to four chained Jacobi pressure iterations in one launch, optionally
// with the velocity-norm limiter.
//
// Replaces fluid2d_tpu/ops/pallas_stencil.py:jacobi_iteration_pallas (kernel
// _jacobi_kernel). The arithmetic is the port's eager
// ops/pressure.py:jacobi_pressure_iteration, chained, operation for
// operation and rounded as PyTorch rounds it on the card (common.cuh); the
// BC, the prediction and the limiter are the cell rules of pressure.cuh,
// shared with the fused SOR kernel. An iteration is
//   1. pressure BC  p_cur -> bc    (out of place: the inflow code 9 reads
//                                   (i+1, j), which may itself be rewritten)
//   2. sweep        bc -> pn       predict_p at every not-wall cell (inflow
//                                  and outflow included), the alt value at
//                                  walls: the caller's p_alt in the first
//                                  iteration, the previous iteration's bc
//                                  after it
// and returns (pn, bc), the next iteration's (p_cur, p_alt).
//
// One launch a call, in the design of the fused SOR (sor.cu, tile.cuh): a
// block owns a TX × TY tile of output cells and runs every stage of every
// iteration on it. Each stage reaches one cell, so an iteration consumes two
// cells of halo (the _jacobi_kernel cascade), and p_cur's window spans the
// tile + 2·n_iters; u, w and a flag byte a cell (BC code, not_wall) span the
// tile + 2·n_iters − 1. Two float windows take the iterations in turn: an
// iteration's p_cur is BC'd in place at the cells with a code (every entry's
// BC evaluated before any is stored, tile.cuh:rewrite_in_place; the BC keeps
// the pressure elsewhere), and its sweep goes to the other window at the
// not-wall cells. That window holds the previous iteration's BC, which is
// this iteration's alt, so a wall cell keeps it where it stands; in the
// first iteration the caller's p_alt is read from device memory there: it
// has no window. The last sweep goes from the windows straight to the
// stores on the tile, with the last BC (the new p_alt) and, with the
// limiter, the limited velocity. Each window entry holds the stage's value
// at its clamped cell, computed there, so the values are the eager path's
// float32 values to the bit. Only p_cur, u, w, the two int8 planes and
// those p_alt cells are read, once a block (the halo rows a neighbouring
// tile also reads come from L2), and only the outputs are written.
//
// Storage types, as in sor.cu: the velocity and the limited velocity are
// TV; the pair read is TI and the pair returned TO (each TV or float),
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

// Output tile of a block, rows × columns, as the fused SOR's.
constexpr int kTileX = 32, kTileY = 32;

struct JacobiConsts {
  float dx, inv_eight_dt, v_limit;
};

// The windows of an N-iteration call on a TX × TY tile: the pressure
// windows (one, or two taken in turn from N = 2 on) on the tile + H rows,
// u, w and the flags on + (H − 1); all on the columns of the tile ± CH
// (whole chunks), NC chunks a row, pitch P.
template <int N, int TX, int TY>
struct JacobiTile {
  static_assert(TY % kV == 0, "a tile's width is a whole number of chunks");
  static constexpr int H = 2 * N;
  static constexpr int CH = (H + kV - 1) / kV * kV;
  static constexpr int NC = TY / kV + 2 * CH / kV, P = NC * kV;
  static constexpr int RP = TX + 2 * H, RV = TX + 2 * (H - 1);
  static constexpr int kPressure = N == 1 ? 1 : 2;
  static constexpr int kBytes = 4 * (kPressure * RP + 2 * RV) * P + RV * P;
};

// What a block's stages read: the windows, all from row wi0 and column c0
// (u, w and the flags from row wi0 + 1), the caller's p_alt and the grid.
template <int P, typename TI>
struct JacobiBlock {
  float* p[2];  // iteration K's p_cur, then its BC, in p[K & 1]; its sweep in the other
  Window<P> u, w;
  Window<P, uint8_t> fl;
  const TI* p_alt;
  int ti, tj, wi0, c0;
  Grid g;
  JacobiConsts c;
  bool vec;  // every plane allows aligned chunk loads and stores

  __device__ __forceinline__ bool not_wall(int i, int j) const {
    return (fl(i, j) & kSwept) != 0;
  }

  // The prediction at the in-grid cell (i, j) from the BC'd pressure b.
  __device__ __forceinline__ float predict(const Window<P>& b, int i, int j) const {
    return predict_p(b, u, w, i, j, c.dx, c.inv_eight_dt);
  }

  // The caller's p_alt at the in-grid cell (i, j).
  __device__ __forceinline__ float p_alt_at(int i, int j) const {
    return f2d::ldg(p_alt, (long long)i * g.Y + j);
  }
};

// Iteration K of N on the windows: p[K & 1] holds the pressure on the tile
// + h, h = 2·(N − K), and is BC'd in place on + (h − 1); the sweep goes to
// the other window on + (h − 2), or, in the last iteration, to the stores on
// the tile with the BC and the limiter; then the next iteration.
template <int K, int N, int TX, int TY, int P, typename TI, typename TO, typename TV>
__device__ __forceinline__ void jacobi_iters(const JacobiBlock<P, TI>& blk,
                                             const PressureOut<TO, TV>& out) {
  constexpr int h = 2 * (N - K);
  const Grid& g = blk.g;
  // bw: this iteration's pressure, BC'd below; nw: the sweep's window, which
  // holds the previous iteration's BC (this iteration's alt) from K = 1 on.
  const Window<P> bw{blk.p[K & 1], blk.wi0, blk.c0}, nw{blk.p[(K + 1) & 1], blk.wi0, blk.c0};

  // 1. The BC on the tile + (h − 1), at each entry's clamped cell, in place
  //    at the cells with a code.
  f2d::rewrite_in_place<TX + 2 * (h - 1), TY + 2 * (h - 1), 1>(
      blk.ti - (h - 1), blk.tj - (h - 1),
      [&](int i0, int j0, float (&v)[1]) {
        const int i = g.clamp_i(i0), j = g.clamp_j(j0);
        const int code = blk.fl(i, j) & kCode;
        if (code == 0) return false;  // the BC keeps the pressure
        v[0] = f2d::pressure_bc_cell(bw, code, i, j);
        return true;
      },
      [&](int i0, int j0, const float (&v)[1]) { bw.s[bw.idx(i0, j0)] = v[0]; });

  if constexpr (K + 1 < N) {
    // 2. The sweep on the tile + (h − 2) into the other window: the
    //    prediction at not-wall cells; a wall cell keeps the alt value, which
    //    that window holds but in the first iteration.
    for_window<TX + 2 * (h - 2), TY + 2 * (h - 2)>(
        blk.ti - (h - 2), blk.tj - (h - 2), [&](int i0, int j0) {
          const int i = g.clamp_i(i0), j = g.clamp_j(j0);
          if (blk.not_wall(i, j)) {
            nw.s[nw.idx(i0, j0)] = blk.predict(bw, i, j);
          } else if constexpr (K == 0) {
            nw.s[nw.idx(i0, j0)] = blk.p_alt_at(i, j);
          }
        });
    __syncthreads();
    jacobi_iters<K + 1, N, TX, TY>(blk, out);
  } else {
    // 2. The last sweep on the tile, kV cells a thread along Y (the fused MAC
    //    phases' update loop), to the stores with the BC and the limiter.
    const long long plane = g.plane();
    constexpr int kRowChunks = TY / kV;
    for (int it = threadIdx.x; it < TX * kRowChunks; it += kThreads) {
      const int i = blk.ti + it / kRowChunks, j = blk.tj + kV * (it % kRowChunks);
      if (i >= g.X || j >= g.Y) continue;
      const int n = min(kV, g.Y - j);
      const long long k = (long long)i * g.Y + j;
      float pn[kV], pb[kV];
#pragma unroll
      for (int t = 0; t < kV; ++t) {
        const int jt = j + t;
        pb[t] = bw(i, jt);
        if (t >= n) {
          pn[t] = 0.0f;
        } else if (blk.not_wall(i, jt)) {
          pn[t] = blk.predict(bw, i, jt);
        } else if constexpr (K == 0) {
          pn[t] = blk.p_alt_at(i, jt);
        } else {
          pn[t] = nw(i, jt);
        }
      }
      f2d::st_chunk(out.p_out, k, pn, n, blk.vec);
      f2d::st_chunk(out.p_bc, k, pb, n, blk.vec);
      if (out.v_lim != nullptr) {
        // the unrounded velocity from the windows, rounded once at the store
        float lu[kV], lw[kV];
#pragma unroll
        for (int t = 0; t < kV; ++t) {
          const float2 l = f2d::limited(blk.u(i, j + t), blk.w(i, j + t), blk.c.v_limit);
          lu[t] = l.x;
          lw[t] = l.y;
        }
        f2d::st_chunk(out.v_lim, k, lu, n, blk.vec);
        f2d::st_chunk(out.v_lim, plane + k, lw, n, blk.vec);
      }
    }
  }
}

// N (1..4) iterations on one TX × TY tile. p_cur, p_alt, u, w, the masks
// and the outputs are (X, Y) planes but v_lim (2, X, Y); vec: every plane
// allows aligned chunk loads and stores.
template <typename TI, typename TO, typename TV, int N, int TX, int TY>
__global__ void __launch_bounds__(kThreads) jacobi_fused_kernel(
    const TI* __restrict__ p_cur, const TI* __restrict__ p_alt, const TV* __restrict__ u,
    const TV* __restrict__ w, const int8_t* __restrict__ pbc_code,
    const int8_t* __restrict__ not_wall8, PressureOut<TO, TV> out, Grid g, JacobiConsts c,
    int vec) {
  using T = JacobiTile<N, TX, TY>;
  constexpr int H = T::H, NC = T::NC, P = T::P, RP = T::RP, RV = T::RV;
  extern __shared__ __align__(16) float smem[];
  float* const s_p = smem;
  float* const s_u = s_p + T::kPressure * RP * P;
  float* const s_w = s_u + RV * P;
  uint8_t* const s_fl = reinterpret_cast<uint8_t*>(s_w + RV * P);
  const int ti = blockIdx.y * TX, tj = blockIdx.x * TY, c0 = tj - T::CH;
  // With one iteration p[1] is never used.
  const JacobiBlock<P, TI> blk{{s_p, s_p + (T::kPressure - 1) * RP * P},
                               {s_u, ti - (H - 1), c0},
                               {s_w, ti - (H - 1), c0},
                               {s_fl, ti - (H - 1), c0},
                               p_alt,
                               ti,
                               tj,
                               ti - H,
                               c0,
                               g,
                               c,
                               vec != 0};

  // 0. The operands: p_cur on the tile + H, u, w and the flags on + (H − 1).
  f2d::fill<RP, NC>(s_p, p_cur, ti - H, c0, g, vec);
  f2d::fill<RV, NC>(s_u, u, ti - (H - 1), c0, g, vec);
  f2d::fill<RV, NC>(s_w, w, ti - (H - 1), c0, g, vec);
  f2d::fill_flags<RV, NC>(s_fl, ti - (H - 1), c0, g, vec, PressureFlags{}, pbc_code, not_wall8);
  f2d::wait_fills();

  jacobi_iters<0, N, TX, TY>(blk, out);
}

template <typename TI, typename TO, typename TV, int N>
int jacobi_launch(const void* p_cur, const void* p_alt, const void* u, const void* w,
                  const int8_t* pbc_code, const int8_t* not_wall8, void* p_out, void* p_bc,
                  void* v_lim, Grid g, JacobiConsts c, cudaStream_t s) {
  using T = JacobiTile<N, kTileX, kTileY>;
  constexpr auto kernel = jacobi_fused_kernel<TI, TO, TV, N, kTileX, kTileY>;
  if (const cudaError_t err = f2d::allow_smem<kernel>(T::kBytes); err != cudaSuccess) {
    return (int)err;
  }
  const void* planes[] = {p_cur, p_alt, u, w, pbc_code, not_wall8, p_out, p_bc, v_lim};
  const PressureOut<TO, TV> out{static_cast<TO*>(p_out), static_cast<TO*>(p_bc),
                              static_cast<TV*>(v_lim)};
  kernel<<<f2d::tile_blocks(g, kTileX, kTileY, 1), kThreads, T::kBytes, s>>>(
      static_cast<const TI*>(p_cur), static_cast<const TI*>(p_alt), static_cast<const TV*>(u),
      static_cast<const TV*>(w), pbc_code, not_wall8, out, g, c,
      f2d::chunk_loads(g, planes, v_lim != nullptr ? 9 : 8));
  F2D_CHECK_LAUNCH();
  return 0;
}

template <typename TI, typename TO, typename TV>
int jacobi_n(int n_iters, const void* p_cur, const void* p_alt, const void* u, const void* w,
             const int8_t* pbc_code, const int8_t* not_wall8, void* p_out, void* p_bc,
             void* v_lim, Grid g, JacobiConsts c, cudaStream_t s) {
#define F2D_JACOBI(N) \
  jacobi_launch<TI, TO, TV, N>(p_cur, p_alt, u, w, pbc_code, not_wall8, p_out, p_bc, v_lim, g, c, s)
  switch (n_iters) {
    case 1: return F2D_JACOBI(1);
    case 2: return F2D_JACOBI(2);
    case 3: return F2D_JACOBI(3);
    default: return F2D_JACOBI(4);
  }
#undef F2D_JACOBI
}

}  // namespace

// n_iters (1..4) Jacobi iterations. p_cur, p_alt, u, w, pbc_code, not_wall8,
// p_out and p_bc: (X, Y); v_lim: (2, X, Y), or null without the limiter.
// u, w and v_lim are bf16 when bf16_storage != 0, else float; the pair read
// is bf16 when in_bf16 != 0 and the pair returned when out_bf16 != 0 (both
// only with bf16 storage), else float. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these.
extern "C" int f2d_jacobi_iteration(const void* p_cur, const void* p_alt, const void* u,
                                    const void* w, const int8_t* pbc_code,
                                    const int8_t* not_wall8, void* p_out, void* p_bc,
                                    void* v_lim, int X, int Y, int n_iters, int bf16_storage,
                                    int in_bf16, int out_bf16, float dx, float inv_eight_dt,
                                    float v_limit, void* stream) {
  if (n_iters < 1 || n_iters > 4 || (!bf16_storage && (in_bf16 || out_bf16))) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g{X, Y};
  const JacobiConsts c{dx, inv_eight_dt, v_limit};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2D_JACOBI(TI, TO, TV)                                                                  \
  jacobi_n<TI, TO, TV>(n_iters, p_cur, p_alt, u, w, pbc_code, not_wall8, p_out, p_bc, v_lim, g, c, \
                       s)
  if (!bf16_storage) return F2D_JACOBI(float, float, float);
  if (in_bf16) return out_bf16 ? F2D_JACOBI(bf16, bf16, bf16) : F2D_JACOBI(bf16, float, bf16);
  return out_bf16 ? F2D_JACOBI(float, bf16, bf16) : F2D_JACOBI(float, float, bf16);
#undef F2D_JACOBI
}
