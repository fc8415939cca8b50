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
//   (C5g). Every tile of t rows of an (X, Y) float plane fetches its whole
//   window, rows [rs, rs + t + 2h) (rs as that script clamps it), into
//   shared memory by Hopper bulk copies (cp.async.bulk, one a row) completing
//   on mbarriers, and out = 2 · the window's rows of the tile: rows h .. h + t
//   of an interior window, 0 .. t of the first and 2h .. 2h + t of the last
//   (the script's realignment, done by indexing). Bound: bytes, 2·X·Y·4 at
//   least; the windows read (t + 2h)/t of the plane. The question, as on
//   the TPU, is whether a full row window at Y = 1600 copies asynchronously
//   at all.
//   Design: a persistent, pipelined window. A block fills an SM (a window of
//   204,800 bytes at Y = 1600), as many are launched as fit the card, and
//   each walks the tiles i = blockIdx.x, += gridDim.x. Its shared
//   memory is a ring of `slots` groups of h rows (slots ≥ t/h + 2: a window
//   fits; the wrapper sizes it, ops/cuda_probes.py:row_window_slots), each
//   slot with a `full` mbarrier (the rows landed) and an `empty` one (the
//   consumer warps are done with it), the barriers after the ring. Warp 0's
//   first thread is the producer: it issues the block's groups in order,
//   seq = 0, 1, ..., into slot seq % slots, and refills a slot once the
//   consumers have released its last group. The other warps are the
//   consumers: for every group in order they wait on its `full` phase,
//   store 2 · its rows as 16-byte vectors if the tile owns it (a halo group
//   is fetched, as the probe asks, and never read), and arrive on its
//   `empty` barrier. So the next tile's groups are in flight while this
//   tile is stored. Every group of slot s passes both of its barriers once
//   and in turn, so the phase of seq is seq / slots on each, and a wait
//   never meets a barrier a phase behind or ahead of it, in whatever order
//   the copies land: a consumer reaches seq only after its own wait on seq −
//   slots, and the producer issues seq only after every consumer released
//   seq − slots. The block leaves only after every copy has landed (the
//   consumers waited on each). Bulk stores from the ring (2· in place, one
//   cp.async.bulk a warp) were 9% slower on the H100, and t = 8, whose
//   windows read 3× the plane against t = 16's 2×, 7% slower (PERF.md §6).
//   ops/cuda_probes.py:row_window_schedule is this schedule in Python;
//   tests/test_torch_probes.py replays it with the copies landing in issue
//   order, halo groups last, and at random.
//
// toy_elementwise_kernel — the toy kernels of the el-op counter test
//   (tests/test_profiling.py:134 x·2 + 1, :158 x/3 and x·3) (C6).
//   o = x·c + 1 (c = 2) or o = x·c (c = 3, or the division's 1/3 rounded as
//   PyTorch's CUDA division by a Python scalar rounds it,
//   ops/launch.py:recip32), the product and the sum each rounded once
//   (__fmul_rn, __fadd_rn), as the plain version rounds them. Bound: bytes.
//   Design: a 16-byte vector stream. One 4-byte element a thread streams at
//   about half of the copy rate on this card (PERF.md §6), so each
//   thread moves kToyVec whole float4s, all loads issued before any store,
//   neighbouring threads on neighbouring float4s; the first n % 4 threads
//   also take the ragged tail past the last whole float4, as
//   copy_add1_kernel does. A base of x or o that is not 16-byte aligned (a
//   view at an odd offset) takes a scalar path inside the same kernel: the
//   same kToyVec·4 elements a thread, one float a load, still coalesced.
#include <algorithm>

#include "common.cuh"

using f2d::bf16;
using f2d::Grid;

namespace {

constexpr int kThreads = 256;
constexpr int kC4Chains = 8;  // C4: measure_fma_throughput's probe
constexpr int kWindowThreads = 1024;
constexpr int kToyVec = 4;  // C6: float4s a thread (1, 2 and 4 time the same, PERF.md §6)

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

// Waits for the phase of `parity` to complete. A wrong parity would wait for
// ever: after ~10 s (2^34 cycles) it traps instead, so the launch fails.
__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned parity) {
  const long long start = clock64();
  while (!mbarrier_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Tile i's window: its first row over h (i·t/h − 1, clamped as
// ops/cuda_probes.py:_window_rows clamps it).
__device__ __forceinline__ int window_group(int i, int tg, int x_groups) {
  const int r = i * tg - 1, r_max = x_groups - tg - 2;
  return r < 0 ? 0 : (r > r_max ? r_max : r);
}

// Dynamic shared memory: `slots` groups of h rows of Y floats (Y·4 a
// multiple of 16, a 16-byte aligned plane: the wrapper checks), then the
// slots' `full` and `empty` barriers.
__global__ void __launch_bounds__(kWindowThreads)
    row_window_kernel(const float* __restrict__ a, float* __restrict__ out, int X, int Y, int t,
                      int h, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tg = t / h, groups = tg + 2, n_t = X / t, x_groups = X / h;
  const unsigned row_bytes = (unsigned)Y * 4u, group_bytes = row_bytes * h;
  auto* full = reinterpret_cast<unsigned long long*>(smem + (size_t)slots * group_bytes);
  auto* empty = full + slots;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int consumers = blockDim.x / 32 - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&empty[s])),
                   "r"(consumers)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised before anyone uses them

  if (warp == 0) {  // the producer
    if (lane != 0) return;
    int seq = 0;
    for (int i = blockIdx.x; i < n_t; i += gridDim.x) {
      const int r = window_group(i, tg, x_groups);
      for (int q = 0; q < groups; ++q, ++seq) {
        const int s = seq % slots;
        if (seq >= slots) {  // the consumers released the slot's last group
          mbarrier_wait(smem_addr(&empty[s]), ((seq - slots) / slots) & 1);
        }
        const unsigned bar = smem_addr(&full[s]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(group_bytes)
                     : "memory");
        const float* src = a + (long long)(r + q) * h * Y;
        unsigned char* dst = smem + (size_t)s * group_bytes;
        for (int row = 0; row < h; ++row) {
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
              "[%3];\n" ::"r"(smem_addr(dst + row * row_bytes)),
              "l"(src + (long long)row * Y), "r"(row_bytes), "r"(bar)
              : "memory");
        }
      }
    }
    return;
  }

  // the consumers: every group waited on and released, 2 · each group the
  // tile owns stored, 16 bytes a store
  const int n4 = (int)(group_bytes / 16), ct = threadIdx.x - 32, n_ct = consumers * 32;
  int seq = 0;
  for (int i = blockIdx.x; i < n_t; i += gridDim.x) {
    const int r = window_group(i, tg, x_groups), first = i * tg - r;
    for (int q = 0; q < groups; ++q, ++seq) {
      const int s = seq % slots;
      mbarrier_wait(smem_addr(&full[s]), (seq / slots) & 1);
      if (q >= first && q < first + tg) {
        const float4* slot = reinterpret_cast<const float4*>(smem + (size_t)s * group_bytes);
        float4* dst = reinterpret_cast<float4*>(out + (long long)(r + q) * h * Y);
        for (int e = ct; e < n4; e += n_ct) {
          float4 v = slot[e];
          v.x *= 2.0f;
          v.y *= 2.0f;
          v.z *= 2.0f;
          v.w *= 2.0f;
          dst[e] = v;
        }
      }
      __syncwarp();
      if (lane == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(&empty[s]))
                     : "memory");
      }
    }
  }
}

// o = x·c + 1 (op 0) or x·c (ops 1 and 2), each step rounded once.
__device__ __forceinline__ float toy_op(float v, int op, float c) {
  return op == 0 ? __fadd_rn(__fmul_rn(v, c), 1.0f) : __fmul_rn(v, c);
}

// A block covers kThreads · kToyVec float4s (4× as many floats); the launch
// covers n.
__global__ void toy_elementwise_kernel(const float* __restrict__ x, float* __restrict__ o,
                                       long long n, int op, float c) {
  const long long first = (long long)blockIdx.x * blockDim.x * kToyVec + threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15) == 0) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(o);
    float4 v[kToyVec];
#pragma unroll
    for (int m = 0; m < kToyVec; ++m) {
      const long long k = first + (long long)m * blockDim.x;
      if (k < n4) v[m] = x4[k];
    }
#pragma unroll
    for (int m = 0; m < kToyVec; ++m) {
      const long long k = first + (long long)m * blockDim.x;
      if (k < n4) {
        o4[k] = make_float4(toy_op(v[m].x, op, c), toy_op(v[m].y, op, c), toy_op(v[m].z, op, c),
                            toy_op(v[m].w, op, c));
      }
    }
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k < n - 4 * n4) o[4 * n4 + k] = toy_op(x[4 * n4 + k], op, c);
    return;
  }
  // misaligned: the same span of the flat array, one float a load
  const long long base = (long long)blockIdx.x * blockDim.x * kToyVec * 4 + threadIdx.x;
  float v[4 * kToyVec];
#pragma unroll
  for (int m = 0; m < 4 * kToyVec; ++m) {
    const long long k = base + (long long)m * blockDim.x;
    if (k < n) v[m] = x[k];
  }
#pragma unroll
  for (int m = 0; m < 4 * kToyVec; ++m) {
    const long long k = base + (long long)m * blockDim.x;
    if (k < n) o[k] = toy_op(v[m], op, c);
  }
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

// a, out: (X, Y) float; X/t tiles, t a multiple of h, X/t ≥ 2, a ring of
// `slots` ≥ t/h + 2 groups of h rows (sized by the wrapper:
// ops/cuda_probes.py:row_window_slots), which with its barriers must fit the
// shared memory a block may opt in to. As many persistent blocks as fit the
// card, at most one a tile.
extern "C" int f2d_row_window(const float* a, float* out, int X, int Y, int t, int h, int slots,
                              void* stream) {
  cudaError_t err;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess) {
    return (int)err;
  }
  const long long smem = (long long)slots * ((long long)h * Y * 4 + 16);  // + 2 barriers a slot
  if (slots < t / h + 2 || smem > optin) return (int)cudaErrorInvalidValue;
  static const cudaError_t allowed = cudaFuncSetAttribute(  // once a process
      row_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if ((err = allowed) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_window_kernel, kWindowThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(X / t, std::max(1, sms * per_sm));
  row_window_kernel<<<grid, kWindowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, out, X, Y, t, h, slots);
  F2D_CHECK_LAUNCH();
  return 0;
}

// x, o: n floats at any alignment; op 0: o = x·c + 1, ops 1, 2: o = x·c.
extern "C" int f2d_toy_elementwise(const float* x, float* o, long long n, int op, float c,
                                   void* stream) {
  toy_elementwise_kernel<<<blocks_for((n + 4 * kToyVec - 1) / (4 * kToyVec)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, o, n, op, c);
  F2D_CHECK_LAUNCH();
  return 0;
}
