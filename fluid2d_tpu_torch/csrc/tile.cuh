// Tiles with a recomputed halo: the window fills, chunk stores and launch
// helpers shared by the fused kernels (cip_phases.cu, sor.cu, confinement.cu,
// mac_phases.cu, jacobi.cu).
//
// A fused kernel runs a cascade of stencil stages on one block's tile of
// output cells. Each stage's values live as float in a shared-memory window
// one cell wider on every side than the next stage reads, recomputed by
// every block that needs them; an entry at a cell outside the grid holds the
// stage's value at the clamped cell (the Window accessor, common.cuh).
//
// The block first copies its operands into windows that all span the same
// chunk-aligned columns c0 .. c0 + NC·kV − 1 (pitch NC·kV), each over its
// own rows, so that a row is read in aligned chunks of kV elements: at float
// one 16-byte cp.async a chunk, all of a block's copies in flight at once; at
// bf16 an 8-byte load into registers, widened to float; the int8 scene planes
// 4 bytes, packed into one flag byte a cell. Rows and columns past the grid
// read the clamped ones. Internal linkage: every source that includes this
// header gets its own copy.
#pragma once

#include <utility>

#include "common.cuh"

namespace f2d {
namespace {

constexpr int kThreads = 256;  // threads of a fused kernel's block
constexpr int kV = 4;          // elements of a chunk: one aligned load of a window row

// fn(i, j) for every cell of the H × W region whose first cell is (i0, j0),
// possibly outside the grid. Consecutive threads take consecutive cells of
// a row.
template <int H, int W, typename Fn>
__device__ __forceinline__ void for_window(int i0, int j0, Fn fn) {
#pragma unroll 4
  for (int e = threadIdx.x; e < H * W; e += kThreads) fn(i0 + e / W, j0 + e % W);
}

// Rewrite in place the entries of the H × W region whose first cell is
// (i0, j0), for a stage that reads other entries of the same windows (a
// boundary condition): eval(i, j, v) says whether the entry at (i, j)
// changes and sets its C new values. Every thread first evaluates its
// entries into registers, and only after a barrier stores them
// (store(i, j, v)), so no entry is read after it is rewritten; a second
// barrier ends the stage. Consecutive threads take consecutive entries of a
// row, as in for_window.
template <int H, int W, int C, typename Eval, typename Store>
__device__ __forceinline__ void rewrite_in_place(int i0, int j0, Eval eval, Store store) {
  constexpr int kN = (H * W + kThreads - 1) / kThreads;
  float v[kN][C];
  bool on[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int e = threadIdx.x + n * kThreads;
    on[n] = e < H * W && eval(i0 + e / W, j0 + e % W, v[n]);
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int e = threadIdx.x + n * kThreads;
    if (on[n]) store(i0 + e / W, j0 + e % W, v[n]);
  }
  __syncthreads();
}

template <int N>
struct Bits;
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<16> {
  using type = uint4;
};

// kV consecutive elements of type E: 16 bytes of float, 8 of bf16, 4 of int8.
template <typename E>
using Chunk = typename Bits<sizeof(E) * kV>::type;

// The chunk of plane p at row `row` (in the grid) and columns c..c+kV−1:
// one aligned load where it lies inside the row and `vec` holds, else
// element by element at the clamped columns.
template <typename E>
__device__ __forceinline__ Chunk<E> load_chunk(const E* p, int row, int c, const Grid& g,
                                               bool vec) {
  const E* rp = p + (long long)row * g.Y;
  Chunk<E> r;
  if (vec && c >= 0 && c + kV <= g.Y) {
    r = __ldg(reinterpret_cast<const Chunk<E>*>(rp + c));
  } else {
    E* e = reinterpret_cast<E*>(&r);
#pragma unroll
    for (int t = 0; t < kV; ++t) e[t] = rp[g.clamp_j(c + t)];
  }
  return r;
}

// Copy 16 bytes from device to shared memory without passing through
// registers (cp.async); wait_fills() completes this thread's copies.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_fills() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Start the copy of plane p (storage type S, clamped rows and columns) into
// the float window s, rows i0 .. i0 + H − 1 and NC chunks a row from column
// c0; consecutive threads take consecutive chunks of a row, and the window
// is complete after wait_fills(). float: each chunk inside its row is one
// cp.async, so every window of a block is in flight at once; a chunk at the
// grid's column edge is loaded element by element and stored. bf16: a
// thread loads its chunks into registers, all in flight together, then
// stores them widened to float.
template <int H, int NC, typename S>
__device__ __forceinline__ void fill(float* s, const S* p, int i0, int c0, const Grid& g,
                                     bool vec) {
  constexpr int kN = (H * NC + kThreads - 1) / kThreads;
  if constexpr (std::is_same_v<S, float>) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int it = threadIdx.x + n * kThreads;
      if (it < H * NC) {
        const int c = c0 + kV * (it % NC);
        const float* rp = p + (long long)g.clamp_i(i0 + it / NC) * g.Y;
        if (vec && c >= 0 && c + kV <= g.Y) {
          copy16_async(s + kV * it, rp + c);
        } else {
#pragma unroll
          for (int t = 0; t < kV; ++t) s[kV * it + t] = rp[g.clamp_j(c + t)];
        }
      }
    }
  } else {
    Chunk<S> r[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int it = threadIdx.x + n * kThreads;
      if (it < H * NC) r[n] = load_chunk(p, g.clamp_i(i0 + it / NC), c0 + kV * (it % NC), g, vec);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int it = threadIdx.x + n * kThreads;
      if (it < H * NC) {
        const S* e = reinterpret_cast<const S*>(&r[n]);
        *reinterpret_cast<float4*>(s + kV * it) =
            make_float4(ld(e, 0), ld(e, 1), ld(e, 2), ld(e, 3));
      }
    }
  }
}

// pack(b_0, ..., b_{K-1}) of byte t of each chunk of r[·][n].
template <int K, int N, typename Pack, size_t... Q>
__device__ __forceinline__ unsigned pack_byte(const Pack& pack, const unsigned (&r)[K][N], int n,
                                              unsigned sh, std::index_sequence<Q...>) {
  return pack(((r[Q][n] >> sh) & 0xffu)...);
}

// The flag byte of every cell of the window, as fill() lays out a float
// window: pack(b_0, ...) of the cell's bytes in the int8 planes given.
template <int H, int NC, typename Pack, typename... Planes>
__device__ __forceinline__ void fill_flags(uint8_t* s, int i0, int c0, const Grid& g, bool vec,
                                           Pack pack, Planes... planes) {
  constexpr int kN = (H * NC + kThreads - 1) / kThreads, K = sizeof...(Planes);
  const int8_t* const p[K] = {planes...};
  unsigned r[K][kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int it = threadIdx.x + n * kThreads;
    if (it < H * NC) {
      const int row = g.clamp_i(i0 + it / NC), col = c0 + kV * (it % NC);
#pragma unroll
      for (int q = 0; q < K; ++q) r[q][n] = load_chunk(p[q], row, col, g, vec);
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int it = threadIdx.x + n * kThreads;
    if (it < H * NC) {
      unsigned packed = 0;
#pragma unroll
      for (int t = 0; t < kV; ++t) {
        const unsigned f = pack_byte(pack, r, n, 8 * t, std::make_index_sequence<K>{});
        packed |= (f & 0xffu) << (8 * t);
      }
      *reinterpret_cast<unsigned*>(s + kV * it) = packed;
    }
  }
}

// kV cells of plane p from cell k on, stored as S: one aligned vector store
// when `vec` holds (every chunk then lies in the grid), else the first n one
// by one.
template <typename S>
__device__ __forceinline__ void st_chunk(S* p, long long k, const float (&v)[kV], int n,
                                         bool vec) {
  if (vec) {
    if constexpr (kIsBf16<S>) {
      const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                                   __float2bfloat16_rn(v[1]));
      const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                                   __float2bfloat16_rn(v[3]));
      *reinterpret_cast<uint2*>(p + k) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                    *reinterpret_cast<const unsigned*>(&hi));
    } else {
      *reinterpret_cast<float4*>(p + k) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < kV; ++t) {
    if (t < n) st(p, k + t, v[t]);
  }
}

// Blocks of a launch over TX × TY tiles of a grid, `channels` on z.
inline dim3 tile_blocks(const Grid& g, int tx, int ty, int channels) {
  return dim3((g.Y + ty - 1) / ty, (g.X + tx - 1) / tx, channels);
}

// Allow Kernel `bytes` of dynamic shared memory (above the default 48 KB),
// once a process.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// Whether every plane allows aligned chunk loads: rows of a whole number of
// chunks, and 16-byte-aligned planes.
inline bool chunk_loads(const Grid& g, const void* const* planes, int n) {
  bool ok = g.Y % kV == 0;
  for (int k = 0; k < n; ++k) ok = ok && reinterpret_cast<uintptr_t>(planes[k]) % 16 == 0;
  return ok;
}

}  // namespace
}  // namespace f2d
