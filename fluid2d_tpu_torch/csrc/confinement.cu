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
#include "common.cuh"

using f2d::Grid;

namespace {

__global__ void curl_kernel(const float* __restrict__ v, const int8_t* __restrict__ fluid,
                            float* __restrict__ vort, float* __restrict__ vort_abs, Grid g,
                            float inv_dx) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const float* u = v;
  const float* w = v + g.plane();
  const float dwdx = 0.5f * (w[g.at(i + 1, j)] - w[g.at(i - 1, j)]) * inv_dx;
  const float dudy = 0.5f * (u[g.at(i, j + 1)] - u[g.at(i, j - 1)]) * inv_dx;
  const float curl = dwdx - dudy;
  const bool fl = fluid[k] != 0;
  vort[k] = fl ? curl : 0.0f;
  vort_abs[k] = fl ? fabsf(curl) : 0.0f;
}

__global__ void confine_kernel(const float* __restrict__ v, const float* __restrict__ v_alt,
                               const int8_t* __restrict__ fluid,
                               const float* __restrict__ vort,
                               const float* __restrict__ vort_abs, float* __restrict__ out,
                               Grid g, float inv_dx, float dt_eps) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long k = (long long)i * g.Y + j;
  const long long kw = g.plane() + k;
  if (fluid[k] == 0) {
    out[k] = v_alt[k];
    out[kw] = v_alt[kw];
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
  out[k] = v[k] + dt_eps * fx;
  out[kw] = v[kw] + dt_eps * fy;
}

}  // namespace

// v, v_alt, v_out: (2, X, Y); vort, vort_abs: (X, Y) scratch.
extern "C" int f2d_confinement(const float* v, const float* v_alt, const int8_t* fluid8,
                               float* vort, float* vort_abs, float* v_out, int X, int Y,
                               float inv_dx, float dt_eps, void* stream) {
  const Grid g{X, Y};
  const dim3 blocks = f2d::launch_blocks(X, Y, 1), threads = f2d::launch_threads();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  curl_kernel<<<blocks, threads, 0, s>>>(v, fluid8, vort, vort_abs, g, inv_dx);
  F2D_CHECK_LAUNCH();
  confine_kernel<<<blocks, threads, 0, s>>>(v, v_alt, fluid8, vort, vort_abs, v_out, g, inv_dx,
                                            dt_eps);
  F2D_CHECK_LAUNCH();
  return 0;
}
