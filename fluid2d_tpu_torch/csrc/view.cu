// V1: the view's 8-bit image.
//
// to_image_kernel — the (X, Y, 3) float32 frame that FluidSimulator.render
//   returns, to the (Y, X, 3) uint8 image in screen orientation (y up: row 0
//   is the largest y), out[r, c, k] = in[c, Y-1-r, k]. Replaces no TPU
//   kernel: the JAX package converts the frame on the host in NumPy
//   (fluid2d_tpu/utils/viz.py:to_image), after a copy of the whole float32
//   frame. Here the conversion is a few microseconds of the card's time, and
//   the host copies a quarter of the bytes.
//
//   Rounding: each value as NumPy's float32 np.clip(x, 0.0, 1.0) * 255.0 +
//   0.5 followed by .astype(np.uint8): the clip, then the product and the sum
//   each rounded to nearest (the _rn intrinsics, which hold whatever the
//   -fmad flag), then truncated. fmaxf drops a NaN, so a NaN value reads 0,
//   as NumPy's cast of NaN gives on x86-64; ±inf read 255 and 0.
//
//   Bound: bytes, the frame read once (12 a cell) and the image written once
//   (3 a cell): 76.8 MB, 0.0229 ms at 3200×1600 and 3.35 TB/s.
//
//   Design: a block transposes a tile of kTileX x-rows by kTileY y-columns
//   through shared memory. An x-row of the tile is kTileY·3 contiguous floats
//   of the frame, read as 16-byte loads by neighbouring threads; each value is
//   converted as it is loaded and its byte staged at (y, x) in the tile, whose
//   rows are the image's: kTileX·3 bytes, padded by one word so that the rows
//   the threads of a warp write fall on different banks. Each image row of
//   the tile is then written as 32-bit words, neighbouring threads on
//   neighbouring words. This vector path needs X and Y multiples of 4 and a
//   16-byte aligned frame: every x-row's 16-byte groups and every image row's
//   words are then aligned (x0·3 and y0·3 are multiples of 192), and a tile
//   on the ragged edge holds whole groups and words, the ones past the edge
//   masked. A frame without that alignment takes the scalar path, one float
//   and one byte a thread, masked at the edge.
#include "common.cuh"

namespace {

constexpr int kTileX = 64;  // x-rows of the frame a tile: columns of the image
constexpr int kTileY = 64;  // y-columns of the frame a tile: rows of the image
constexpr int kThreads = 256;
constexpr int kRowBytes = kTileX * 3;   // an image row of the tile
constexpr int kPitch = kRowBytes + 4;   // 49 words: 17·y mod 32 banks apart
constexpr int kRowFloats = kTileY * 3;  // an x-row of the tile
constexpr int kVecs = kRowFloats / 4;   // its float4s
constexpr int kWords = kRowBytes / 4;   // an image row's words
constexpr int kLoads = kTileX * kVecs / kThreads;   // float4s a thread
constexpr int kStores = kTileY * kWords / kThreads;  // words a thread
static_assert(kLoads * kThreads == kTileX * kVecs && kStores * kThreads == kTileY * kWords,
              "whole float4s and words a thread in the vector path");

__device__ __forceinline__ unsigned char to_u8(float x) {
  const float c = fminf(fmaxf(x, 0.f), 1.f);
  return (unsigned char)__float2uint_rz(__fadd_rn(__fmul_rn(c, 255.f), 0.5f));
}

// Value p = y·3 + k of x-row xl of the tile, staged at image row y, byte xl·3 + k.
__device__ __forceinline__ void stage(unsigned char* tile, int xl, int p, float x) {
  tile[(p / 3) * kPitch + xl * 3 + p % 3] = to_u8(x);
}

__global__ void __launch_bounds__(kThreads)
    to_image_kernel(const float* __restrict__ in, unsigned char* __restrict__ out, int X, int Y,
                    bool vec) {
  __shared__ __align__(16) unsigned char tile[kTileY * kPitch];
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int nx = min(kTileX, X - x0), ny = min(kTileY, Y - y0);
  const float* src = in + ((long long)x0 * Y + y0) * 3;  // x-row xl at src + xl·Y·3
  // Image row yl of the tile (row Y-1-y0-yl of the image) at dst - yl·X·3.
  unsigned char* dst = out + ((long long)(Y - 1 - y0) * X + x0) * 3;
  const long long in_pitch = (long long)Y * 3, out_pitch = (long long)X * 3;
  if (vec) {  // nx and ny are multiples of 4: whole float4s and words, masked at the edge
    const int row_vecs = ny * 3 / 4, row_words = nx * 3 / 4;
    float4 f[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int v = it * kThreads + threadIdx.x, xl = v / kVecs, q = v % kVecs;
      if (xl < nx && q < row_vecs) {
        f[it] = __ldg(reinterpret_cast<const float4*>(src + xl * in_pitch) + q);
      }
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int v = it * kThreads + threadIdx.x, xl = v / kVecs, q = v % kVecs;
      if (xl < nx && q < row_vecs) {
        stage(tile, xl, 4 * q, f[it].x);
        stage(tile, xl, 4 * q + 1, f[it].y);
        stage(tile, xl, 4 * q + 2, f[it].z);
        stage(tile, xl, 4 * q + 3, f[it].w);
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kStores; ++it) {
      const int v = it * kThreads + threadIdx.x, yl = v / kWords, w = v % kWords;
      if (yl < ny && w < row_words) {
        reinterpret_cast<unsigned*>(dst - yl * out_pitch)[w] =
            reinterpret_cast<const unsigned*>(tile + yl * kPitch)[w];
      }
    }
  } else {
    for (int v = threadIdx.x; v < kTileX * kRowFloats; v += kThreads) {
      const int xl = v / kRowFloats, p = v % kRowFloats;
      if (xl < nx && p < ny * 3) stage(tile, xl, p, __ldg(src + xl * in_pitch + p));
    }
    __syncthreads();
    for (int v = threadIdx.x; v < kTileY * kRowBytes; v += kThreads) {
      const int yl = v / kRowBytes, b = v % kRowBytes;
      if (yl < ny && b < nx * 3) dst[b - yl * out_pitch] = tile[yl * kPitch + b];
    }
  }
}

}  // namespace

// in: (X, Y, 3) float32, contiguous; out: (Y, X, 3) uint8, contiguous; X, Y ≥ 1.
// Returns cudaGetLastError().
extern "C" int f2d_to_image(const float* in, unsigned char* out, int X, int Y, void* stream) {
  const bool vec = X % 4 == 0 && Y % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 blocks((X + kTileX - 1) / kTileX, (Y + kTileY - 1) / kTileY);
  to_image_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, X, Y, vec);
  F2D_CHECK_LAUNCH();
  return 0;
}
