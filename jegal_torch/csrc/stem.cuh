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
// A kernel is a template on its source, so one body serves both forms; the
// planar form is staged as bytes and converted in the kernel (stem.cu a
// tap's patch at once, stem_band.cu each value as it gathers its A
// fragments). `exact` says every pixel is exact in TF32 (10
// mantissa bits): the integers 0..255 of the planar form are, so a
// tensor-core kernel needs no low TF32 part of them. Both kernels read the
// planar form in the raw frame's order, (y, x, c) -> [t, y/3,
// ((y%3)*3 + x%3)*3 + c, x/3], and do the same 7x7x3 taps either way: read
// as its s2d form, a 3x3 kernel over 27 channels, the 9x9 padded window
// would multiply 243 taps where 147 are nonzero.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace jt {

constexpr int ST_C = 64;                 // output channels
constexpr int ST_KT = 5, ST_KH = 7, ST_KW = 7, ST_CIN = 3, ST_S = 3;
constexpr int ST_TAPS = ST_KH * ST_KW * ST_CIN;     // 147 taps a frame
constexpr int ST_WS = ST_TAPS * ST_C;    // 9408 floats: one temporal tap
// The implicit GEMM of both kernels: K one temporal tap at a time, its 147
// taps in (dy, dx, c) order padded to 152 (k8 steps), the tensor cores'
// products added to a float32 sum every 32 columns.
constexpr int ST_KP = 152;               // 147 taps padded to k8 steps
constexpr int ST_KSTEPS = ST_KP / 8;     // 19
constexpr int ST_FLUSH = 4;              // k8 steps a float32 flush
constexpr int ST_NF = ST_C / 8;          // n8 tiles of the 64 channels

// Pooled geometry of an (H, W) frame: conv k7 s3, then pool k3 s2.
__host__ __device__ inline int stem_pooled(int n) {
  return ((n - ST_KH) / ST_S + 1 - 3) / 2 + 1;
}

struct FloatFrames {
  static constexpr bool exact = false;
  const float* p;
  int H, W;
};

struct PlanarU8 {
  static constexpr bool exact = true;
  const uint8_t* p;
  int H, W;  // raw frame size: 3 H3 x 3 W3
};

}  // namespace jt
