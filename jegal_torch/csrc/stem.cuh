// What the two GestSync stem kernels (stem.cu: window, stem_band.cu: band)
// share: the block-1 geometry and the two input forms a kernel reads its
// raw (t, y, x, c) pixels from.
//
//   FloatFrames: (T, H, W, 3) float32 frames in [0, 1], masked;
//   PlanarU8:    (T, H/3, 27, W/3) uint8 host-repacked frames (the JAX
//                package's host.media.s2d_repack; jegal_torch.ops.video
//                .s2d_repack), raw 0..255 bytes, the /255 folded into the
//                weights by the caller.
//
// A kernel is a template on its source, so one body serves both forms and
// the uint8 -> float conversion happens as the pixels are staged into
// shared memory. `exact` says every pixel is exact in TF32 (10 mantissa
// bits): the integers 0..255 of the planar form are, so a tensor-core
// kernel needs no low TF32 part of them (stem.cu). The planar form is read
// pixel by pixel in the raw frame's order, (y, x, c) -> [t, y/3,
// ((y%3)*3 + x%3)*3 + c, x/3], so the kernel
// does the same 7x7x3 taps either way: read as its s2d form, a 3x3 kernel
// over 27 channels, the 9x9 padded window would multiply 243 taps where 147
// are nonzero.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace jt {

constexpr int ST_C = 64;                 // output channels
constexpr int ST_KT = 5, ST_KH = 7, ST_KW = 7, ST_CIN = 3, ST_S = 3;
constexpr int ST_TAPS = ST_KH * ST_KW * ST_CIN;     // 147 taps a frame
constexpr int ST_WS = ST_TAPS * ST_C;    // 9408 floats: one temporal tap

// Pooled geometry of an (H, W) frame: conv k7 s3, then pool k3 s2.
__host__ __device__ inline int stem_pooled(int n) {
  return ((n - ST_KH) / ST_S + 1 - 3) / 2 + 1;
}

struct FloatFrames {
  static constexpr bool exact = false;
  const float* p;
  int H, W;
  // xq = x * 3 + c; the caller keeps y < H and xq < 3 W
  __device__ __forceinline__ float at(int t, int y, int xq) const {
    return p[((size_t)t * H + y) * W * ST_CIN + xq];
  }
};

struct PlanarU8 {
  static constexpr bool exact = true;
  const uint8_t* p;
  int H, W;  // raw frame size: 3 H3 x 3 W3
  __device__ __forceinline__ float at(int t, int y, int xq) const {
    const int x = xq / 3, c = xq - 3 * x;
    const int h3 = y / 3, dh = y - 3 * h3;
    const int w3 = x / 3, dw = x - 3 * w3;
    const int W3 = W / 3;
    return (float)p[(((size_t)t * (H / 3) + h3) * 27 + (dh * 3 + dw) * 3 + c)
                        * W3 + w3];
  }
};

}  // namespace jt
