// The roofline's probes: the streaming copy (C2), the mix twin (C3) and the
// FMA-rate chains (C4). Each measures a denominator of
// fluid2d_tpu_torch/utils/profiling.py:roofline_report, not a piece of the
// simulation.
//
// copy_add1_kernel — o = x + 1 over a flat float32 buffer.
//   Replaces fluid2d_tpu/utils/profiling.py:measure_hbm_bandwidth (its
//   Pallas copy kernel). Bound: device-memory bytes, one read and one write
//   per element and no arithmetic to speak of. Design: one float4 (16 bytes,
//   the widest single load) per thread, neighbouring threads on neighbouring
//   addresses; the first `tail` threads also take the < 4 floats past the last
//   whole float4. The caller keeps the working set beyond the 50 MB L2 and
//   ping-pongs two buffers, so no launch reads what the cache still holds.
//
// mix_twin_kernel — the no-op twin of one kernel's operand mix.
//   Replaces profiling.py:measure_mix_ceiling and its sliding variants
//   measure_slide_ceiling / measure_slide2d_ceiling (the TPU's no-op twins of
//   each kernel's fetch geometry). Bound: bytes. Every input plane is read
//   once and every output plane written once, the compulsory traffic of the
//   kernel it models: on this card a stencil's halo reads come from L1/L2, so
//   the port's kernels have one fetch geometry and the three TPU twins become
//   this one. Design: one thread per cell; the plane pointers come from a
//   device table (int64: the float inputs, the bf16 inputs, the int8
//   inputs, the float outputs, the bf16 outputs); the inputs are summed in
//   table order, in float, and the sum is written to every output (rounded
//   to nearest even in a bf16 output), so no read can be dropped by the
//   compiler. A twin of a kernel at bf16 transport (mix_twin_bf16_kernel,
//   the probe C5c) reads and writes its state planes as bf16 and the planes
//   the kernel keeps in float as float. The two kernels have an entry point
//   each (f2d_mix_twin, f2d_mix_twin_bf16): the bf16 kernel's extra loops
//   would slow a float-only twin (measured on the H100: 8–18% longer at
//   3200×1600).
//
// fma_rate_kernel — eight independent chains of a = fma(a, c1, c2).
//   Replaces profiling.py:measure_vpu_throughput (the TPU's VPU-rate probe).
//   Bound: FP32 FMA issue, by construction: one 4-byte load and one store per
//   `8 * rounds` FMAs. Design: eight chains per thread hide the FMA latency;
//   c1 and c2 are kernel arguments, so the chains cannot be folded; every
//   step is __fmaf_rn, because the library is built with -fmad=false, under
//   which a*c1 + c2 would compile to a separate multiply and add and the
//   probe would read half the card's rate.
#include "common.cuh"

using f2d::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__global__ void copy_add1_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                                 long long n4, const float* __restrict__ x_tail,
                                 float* __restrict__ o_tail, int tail) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n4) {
    float4 v = x[k];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    o[k] = v;
  }
  if (k < tail) o_tail[k] = x_tail[k] + 1.0f;
}

__global__ void mix_twin_kernel(const long long* __restrict__ table, int n_f32, int n_i8,
                                int n_out, long long cells) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= cells) return;
  float acc = 0.0f;
  for (int a = 0; a < n_f32; ++a) acc += reinterpret_cast<const float*>(table[a])[k];
  for (int a = 0; a < n_i8; ++a) {
    acc += (float)reinterpret_cast<const int8_t*>(table[n_f32 + a])[k];
  }
  for (int a = 0; a < n_out; ++a) reinterpret_cast<float*>(table[n_f32 + n_i8 + a])[k] = acc;
}

// The twin of a kernel at bf16 transport: bf16 planes beside the float ones.
__global__ void mix_twin_bf16_kernel(const long long* __restrict__ table, int n_f32, int n_bf16,
                                     int n_i8, int n_out32, int n_out16, long long cells) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= cells) return;
  float acc = 0.0f;
  for (int a = 0; a < n_f32; ++a) acc += reinterpret_cast<const float*>(table[a])[k];
  for (int a = 0; a < n_bf16; ++a) {
    acc += __bfloat162float(reinterpret_cast<const bf16*>(table[n_f32 + a])[k]);
  }
  const int i8 = n_f32 + n_bf16;
  for (int a = 0; a < n_i8; ++a) acc += (float)reinterpret_cast<const int8_t*>(table[i8 + a])[k];
  const int out = i8 + n_i8;
  for (int a = 0; a < n_out32; ++a) reinterpret_cast<float*>(table[out + a])[k] = acc;
  const bf16 acc16 = __float2bfloat16_rn(acc);
  for (int a = 0; a < n_out16; ++a) reinterpret_cast<bf16*>(table[out + n_out32 + a])[k] = acc16;
}

__global__ void fma_rate_kernel(const float* __restrict__ x, float* __restrict__ o, long long n,
                                int rounds, float c1, float c2) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float xv = x[k];
  float a[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) a[c] = xv * (float)(1.0 + 1e-7 * c);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) a[c] = __fmaf_rn(a[c], c1, c2);
  }
  float acc = a[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = acc + a[c];
  o[k] = acc;
}

inline unsigned blocks_for(long long threads) {
  const long long b = (threads + kThreads - 1) / kThreads;
  return (unsigned)(b > 0 ? b : 1);
}

}  // namespace

// x, o: n floats, 16-byte aligned (the wrapper checks).
extern "C" int f2d_copy_add1(const float* x, float* o, long long n, void* stream) {
  const long long n4 = n / 4;
  const int tail = (int)(n - 4 * n4);
  copy_add1_kernel<<<blocks_for(n4 > tail ? n4 : tail), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), n4, x + 4 * n4,
      o + 4 * n4, tail);
  F2D_CHECK_LAUNCH();
  return 0;
}

// table: device int64[n_f32 + n_i8 + n_out] of plane pointers, each plane
// `cells` elements (float, int8, float).
extern "C" int f2d_mix_twin(const long long* table, int n_f32, int n_i8, int n_out,
                            long long cells, void* stream) {
  mix_twin_kernel<<<blocks_for(cells), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_f32, n_i8, n_out, cells);
  F2D_CHECK_LAUNCH();
  return 0;
}

// table: device int64[n_f32 + n_bf16 + n_i8 + n_out32 + n_out16] of plane
// pointers, each plane `cells` elements (float, bf16, int8, float, bf16).
extern "C" int f2d_mix_twin_bf16(const long long* table, int n_f32, int n_bf16, int n_i8,
                                 int n_out32, int n_out16, long long cells, void* stream) {
  mix_twin_bf16_kernel<<<blocks_for(cells), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_f32, n_bf16, n_i8, n_out32, n_out16, cells);
  F2D_CHECK_LAUNCH();
  return 0;
}

// x, o: n floats; each element runs kChains chains of `rounds` FMAs.
extern "C" int f2d_fma_rate(const float* x, float* o, long long n, int rounds, float c1, float c2,
                            void* stream) {
  fma_rate_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n, rounds, c1, c2);
  F2D_CHECK_LAUNCH();
  return 0;
}
