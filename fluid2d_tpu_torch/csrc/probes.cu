// The probes: the streaming copy (C2), the mix twin (C3) and the FMA-rate
// chains (C4), each a denominator of
// fluid2d_tpu_torch/utils/profiling.py:roofline_report; the FMA-rate sweep
// (C5d), the geometry twin (C5e, C5f), the row window (C5g) and the el-op
// counter's toys (C6). None is a piece of the simulation.
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
// fma_rate_kernel<kChains> — kChains independent chains of a = fma(a, c1, c2).
//   The 8-chain instance at 256 threads a block replaces
//   profiling.py:measure_vpu_throughput (the TPU's VPU-rate probe, C4); the
//   1-, 4- and 8-chain instances at 64, 256 or 1024 threads a block replace
//   scripts/vpu_rate_sweep.py (C5d: its Pallas kernel, swept over block
//   rows, chain count and depth). Bound: FP32 FMA issue, by construction: one
//   4-byte load and one store per `kChains * rounds` FMAs. Design: several
//   chains per thread hide the FMA latency (the sweep asks how many it
//   takes); c1 and c2 are kernel arguments, so the chains cannot be folded;
//   every step is __fmaf_rn, because the library is built with -fmad=false,
//   under which a*c1 + c2 would compile to a separate multiply and add and
//   the probe would read half the card's rate.
//
// geometry_twin_kernel — the no-op twin of an operand geometry (C5e, C5f).
//   Replaces scripts/dma_geometry_sweep.py:make_case (its no-op
//   pallas_call) and scripts/dma_geometry_bench.py:dyelike_call and
//   element_call (the CIP dye kernel's operand geometry with a near-empty
//   body). Bound: bytes. Each input is read at its cell and, with a halo
//   reach h > 0, also at rows i − h and i + h, clamped at the grid ends (a
//   stencil's neighbour reads, the TPU's halo triple); every value read is
//   summed in float, in table order, and the sum is written to every output.
//   The bytes counted are the compulsory ones, each input and output once, so
//   a halo read that costs device-memory traffic shows as a lower rate.
//   Channels run on blockIdx.z: the per-channel float inputs and the outputs
//   are (C, X, Y), the shared float and int8 inputs (X, Y) planes that every
//   channel reads (a dye phase's velocity and masks). The block is 32 threads
//   along Y by `block_rows` along X (the port's phase kernels use 8 rows).
//
// row_window_kernel — the row-window copy of scripts/dma_rowwin_1600_check.py
//   (C5g). One block per tile of t rows of an (X, Y) float plane: rows
//   [rs, rs + t + 2h) (rs as that script clamps it) go into dynamic shared
//   memory by Hopper bulk copies, one cp.async.bulk per row, completing on
//   one mbarrier; the first and last blocks realign their window in shared
//   memory (all reads of a chunk, a barrier, then its writes) and replicate
//   the edge row; out = 2 · window[h : h + t]. Bound: bytes, 2·X·Y·4 at least;
//   one block of up to 227 KB of shared memory fills an SM, so the copy is
//   latency-bound in practice. The question, as on the TPU, is whether a full
//   row window at Y = 1600 copies asynchronously at all.
//
// toy_elementwise_kernel — the toy kernels of the el-op counter test
//   (tests/test_profiling.py:134 x·2 + 1, :158 x/3 and x·3) (C6). One
//   element a thread; o = x·c + 1 (c = 2) or o = x·c (c = 3, or the division's
//   1/3 rounded as PyTorch's CUDA division by a Python scalar rounds it,
//   ops/launch.py:recip32). Bound: bytes.
#include "common.cuh"

using f2d::bf16;
using f2d::Grid;

namespace {

constexpr int kThreads = 256;
constexpr int kC4Chains = 8;  // C4: measure_fma_throughput's probe
constexpr int kWindowThreads = 1024;

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

template <int kChains>
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

// table: n_chan per-channel float inputs (C, X, Y), n_shared float and n_i8
// int8 inputs (X, Y), n_out float outputs (C, X, Y).
__global__ void geometry_twin_kernel(const long long* __restrict__ table, int n_chan,
                                     int n_shared, int n_i8, int n_out, Grid g, int h) {
  int i, j;
  if (!f2d::cell_of(g, i, j)) return;
  const long long chan = blockIdx.z * g.plane();
  const long long k = (long long)i * g.Y + j;
  const long long km = g.at(i - h, j), kp = g.at(i + h, j);
  float acc = 0.0f;
  for (int a = 0; a < n_chan + n_shared; ++a) {
    const float* p = reinterpret_cast<const float*>(table[a]) + (a < n_chan ? chan : 0);
    acc += p[k];
    if (h > 0) {
      acc += p[km];
      acc += p[kp];
    }
  }
  const int i8 = n_chan + n_shared;
  for (int a = 0; a < n_i8; ++a) {
    const int8_t* p = reinterpret_cast<const int8_t*>(table[i8 + a]);
    acc += (float)p[k];
    if (h > 0) {
      acc += (float)p[km];
      acc += (float)p[kp];
    }
  }
  for (int a = 0; a < n_out; ++a) reinterpret_cast<float*>(table[i8 + n_i8 + a])[chan + k] = acc;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbarrier_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// win[dst + e] = win[src + e] for e in [0, n), in chunks of kPer elements a
// thread: each chunk is read whole, then written; chunks run from the end
// when dst > src, so no chunk overwrites what a later one reads.
__device__ void move_within(float* win, int dst, int src, int n) {
  constexpr int kPer = 8;
  const int chunk = kPer * blockDim.x;
  const int n_chunks = (n + chunk - 1) / chunk;
  for (int q = 0; q < n_chunks; ++q) {
    const int c0 = (dst > src ? n_chunks - 1 - q : q) * chunk;
    float buf[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = c0 + m * blockDim.x + threadIdx.x;
      if (e < n) buf[m] = win[src + e];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = c0 + m * blockDim.x + threadIdx.x;
      if (e < n) win[dst + e] = buf[m];
    }
    __syncthreads();
  }
}

// Rows [row0, row0 + h) of win become copies of row `from`.
__device__ void fill_rows(float* win, int row0, int from, int h, int Y) {
  for (int e = threadIdx.x; e < h * Y; e += blockDim.x) win[row0 * Y + e] = win[from * Y + e % Y];
  __syncthreads();
}

// One block per tile of t rows; dynamic shared memory holds t + 2h rows of Y
// floats (Y·4 a multiple of 16, a 16-byte aligned plane: the wrapper checks).
__global__ void row_window_kernel(const float* __restrict__ a, float* __restrict__ out, int X,
                                  int Y, int t, int h) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  float* win = reinterpret_cast<float*>(smem);
  const int rows = t + 2 * h;
  const int i = blockIdx.x, n_t = X / t;
  int r = i * (t / h) - 1;  // the window's first row in units of h, clamped
  const int r_max = (X - t) / h - 2;
  r = r < 0 ? 0 : (r > r_max ? r_max : r);
  const long long rs = (long long)r * h;
  const unsigned b = smem_addr(&bar);
  const unsigned row_bytes = (unsigned)Y * 4u;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(row_bytes * rows)
                 : "memory");
    for (int q = 0; q < rows; ++q) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(win + (long long)q * Y)),
          "l"(a + (rs + q) * Y), "r"(row_bytes), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  while (!mbarrier_try_wait(b, 0)) {
  }
  if (i == 0) {  // window = rows [0, t + 2h): shift down by h, replicate row 0
    move_within(win, h * Y, 0, (rows - h) * Y);
    fill_rows(win, 0, h, h, Y);
  }
  if (i == n_t - 1) {  // window = rows [X − t − 2h, X): shift up by h, replicate row X − 1
    move_within(win, 0, h * Y, (rows - h) * Y);
    fill_rows(win, rows - h, rows - h - 1, h, Y);
  }
  float* o = out + (long long)i * t * Y;
  for (int e = threadIdx.x; e < t * Y; e += blockDim.x) o[e] = 2.0f * win[h * Y + e];
}

// o = x·c + 1 (op 0) or x·c (ops 1 and 2).
__global__ void toy_elementwise_kernel(const float* __restrict__ x, float* __restrict__ o,
                                       long long n, int op, float c) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  o[k] = op == 0 ? x[k] * c + 1.0f : x[k] * c;
}

inline unsigned blocks_for(long long threads, int per_block = kThreads) {
  const long long b = (threads + per_block - 1) / per_block;
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

// x, o: n floats; each element runs kC4Chains chains of `rounds` FMAs.
extern "C" int f2d_fma_rate(const float* x, float* o, long long n, int rounds, float c1, float c2,
                            void* stream) {
  fma_rate_kernel<kC4Chains><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n, rounds, c1, c2);
  F2D_CHECK_LAUNCH();
  return 0;
}

// The sweep: x, o: n floats; each element runs nchain ∈ {1, 4, 8} chains of
// `rounds` FMAs, `threads` threads a block.
extern "C" int f2d_fma_sweep(const float* x, float* o, long long n, int rounds, int nchain,
                             int threads, float c1, float c2, void* stream) {
  const unsigned blocks = blocks_for(n, threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nchain) {
    case 1: fma_rate_kernel<1><<<blocks, threads, 0, s>>>(x, o, n, rounds, c1, c2); break;
    case 4: fma_rate_kernel<4><<<blocks, threads, 0, s>>>(x, o, n, rounds, c1, c2); break;
    case 8: fma_rate_kernel<8><<<blocks, threads, 0, s>>>(x, o, n, rounds, c1, c2); break;
    default: return (int)cudaErrorInvalidValue;
  }
  F2D_CHECK_LAUNCH();
  return 0;
}

// table: device int64[n_chan + n_shared + n_i8 + n_out] of plane pointers
// (geometry_twin_kernel); C channels on blockIdx.z; halo reach h ≥ 0.
extern "C" int f2d_geometry_twin(const long long* table, int n_chan, int n_shared, int n_i8,
                                 int n_out, int X, int Y, int C, int h, int block_rows,
                                 void* stream) {
  const dim3 threads(f2d::kBlockY, block_rows, 1);
  const dim3 blocks((Y + f2d::kBlockY - 1) / f2d::kBlockY, (X + block_rows - 1) / block_rows, C);
  geometry_twin_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_chan, n_shared, n_i8, n_out, Grid{X, Y}, h);
  F2D_CHECK_LAUNCH();
  return 0;
}

// a, out: (X, Y) float; X/t tiles, t a multiple of h, X/t ≥ 2 (the wrapper
// checks, and that the window's (t + 2h)·Y·4 bytes fit a block).
extern "C" int f2d_row_window(const float* a, float* out, int X, int Y, int t, int h,
                              void* stream) {
  const int smem = (t + 2 * h) * Y * 4;
  cudaError_t err = cudaFuncSetAttribute(row_window_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  row_window_kernel<<<X / t, kWindowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, out, X, Y, t, h);
  F2D_CHECK_LAUNCH();
  return 0;
}

// x, o: n floats; op 0: o = x·c + 1, ops 1, 2: o = x·c.
extern "C" int f2d_toy_elementwise(const float* x, float* o, long long n, int op, float c,
                                   void* stream) {
  toy_elementwise_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n, op, c);
  F2D_CHECK_LAUNCH();
  return 0;
}
