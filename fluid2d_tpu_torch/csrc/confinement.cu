// Vorticity confinement.
//
// Replaces fluid2d_tpu/ops/pallas_phases.py:confinement_pallas (core
// _confinement_core). The arithmetic is the port's eager ops/vorticity.py
// operation for operation, rounded as PyTorch rounds it (common.cuh). Two
// launches:
//   1. curl at fluid cells (0 elsewhere) and its magnitude -> two scratch
//      planes, so that the gradient below clamps the computed field at the
//      grid ends, as the jnp path does;
//   2. the normalised gradient of |curl| (unguarded: 0/0 stays NaN), the
//      force (ny·ω, −nx·ω) clamped to ±0.1 with fminf/fmaxf (NaN → +0.1),
//      and v + dt·ε·f at fluid cells, v_alt elsewhere.
// v, v_alt and the output are of storage type S (common.cuh); the two
// scratch planes are float.
#include "common.cuh"

using f2d::bf16;
using f2d::Grid;
using f2d::ld;

namespace {

template <typename S>
__global__ void curl_kernel(const S* __restrict__ v, const int8_t* __restrict__ fluid,
                            float* __restrict__ vort, float* __restrict__ vort_abs, Grid g,
                            float inv_dx) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const S* u = v;
  const S* w = v + g.plane();
  const float dwdx = 0.5f * (ld(w, g.at(i + 1, j)) - ld(w, g.at(i - 1, j))) * inv_dx;
  const float dudy = 0.5f * (ld(u, g.at(i, j + 1)) - ld(u, g.at(i, j - 1))) * inv_dx;
  const float curl = dwdx - dudy;
  const bool fl = fluid[k] != 0;
  vort[k] = fl ? curl : 0.0f;
  vort_abs[k] = fl ? fabsf(curl) : 0.0f;
}

template <typename S>
__global__ void confine_kernel(const S* __restrict__ v, const S* __restrict__ v_alt,
                               const int8_t* __restrict__ fluid,
                               const float* __restrict__ vort,
                               const float* __restrict__ vort_abs, S* __restrict__ out,
                               Grid g, float inv_dx, float dt_eps) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const long long kw = g.plane() + k;
  if (fluid[k] == 0) {
    f2d::st(out, k, ld(v_alt, k));
    f2d::st(out, kw, ld(v_alt, kw));
    return;
  }
  const float gx = 0.5f * (vort_abs[g.at(i + 1, j)] - vort_abs[g.at(i - 1, j)]) * inv_dx;
  const float gy = 0.5f * (vort_abs[g.at(i, j + 1)] - vort_abs[g.at(i, j - 1)]) * inv_dx;
  const float norm = sqrtf(gx * gx + gy * gy);
  const float nx = gx / norm;  // unguarded on purpose (docs/PARITY.md §4)
  const float ny = gy / norm;
  const float om = vort[k];
  const float fx = fmaxf(fminf(ny * om, 0.1f), -0.1f);
  const float fy = fmaxf(fminf(-nx * om, 0.1f), -0.1f);
  f2d::st(out, k, ld(v, k) + dt_eps * fx);
  f2d::st(out, kw, ld(v, kw) + dt_eps * fy);
}

template <typename S>
int confinement(const S* v, const S* v_alt, const int8_t* fluid8, float* vort, float* vort_abs,
                S* v_out, int X, int Y, float inv_dx, float dt_eps, cudaStream_t s) {
  const Grid g{X, Y};
  const dim3 blocks = f2d::launch_blocks(X, Y, 1), threads = f2d::launch_threads();
  curl_kernel<S><<<blocks, threads, 0, s>>>(v, fluid8, vort, vort_abs, g, inv_dx);
  F2D_CHECK_LAUNCH();
  confine_kernel<S><<<blocks, threads, 0, s>>>(v, v_alt, fluid8, vort, vort_abs, v_out, g, inv_dx,
                                               dt_eps);
  F2D_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// v, v_alt, v_out: (2, X, Y); vort, vort_abs: (X, Y) float scratch.
extern "C" int f2d_confinement(const float* v, const float* v_alt, const int8_t* fluid8,
                               float* vort, float* vort_abs, float* v_out, int X, int Y,
                               float inv_dx, float dt_eps, void* stream) {
  return confinement<float>(v, v_alt, fluid8, vort, vort_abs, v_out, X, Y, inv_dx, dt_eps,
                            static_cast<cudaStream_t>(stream));
}

// The same with bf16 v, v_alt and v_out.
extern "C" int f2d_confinement_bf16(const bf16* v, const bf16* v_alt, const int8_t* fluid8,
                                    float* vort, float* vort_abs, bf16* v_out, int X, int Y,
                                    float inv_dx, float dt_eps, void* stream) {
  return confinement<bf16>(v, v_alt, fluid8, vort, vort_abs, v_out, X, Y, inv_dx, dt_eps,
                           static_cast<cudaStream_t>(stream));
}
