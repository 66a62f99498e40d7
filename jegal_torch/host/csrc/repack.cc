// The host's space-to-depth repack of the GestSync stem's planar input,
// apart from the libav runtime (decoder.cc) so that it builds where libav
// is absent: it needs the C++ standard library and nothing else.
//
// Build: see jegal_torch/host/media.py (g++ -O2 -shared -fPIC repack.cc,
// no -l flags, into build/jegal_torch_host/ at the repository root).

#include <cstdint>
#include <cstring>

extern "C" {

// Space-to-depth block-3 repack of packed RGB24 frames into the GestSync
// stem kernel's channel layout, with the face mask folded in. This is the
// host half of the port's planar input (ops/video.s2d_repack, which this
// equals bit for bit): the decode threads emit this layout, so the device
// graph starts at the stem kernel with no layout work.
//
//   out[t][h/3=h3][c=(dh*3+dw)*3+ch][w/3=w3] = rgb[t][3*h3+dh][3*w3+dw][ch]
//   shape (nframes, height/3, 27, width/3), tight u8 (no padding).
//
// cut_rows (nullable): per-frame chin row; raw rows h < cut_rows[t] are
// zeroed (reference masks rows 0..y2+15 inclusive before the tower,
// inference_embs.py:262-286; same semantics as mask_s2d_core's `cut`).
// height/width must be multiples of 3. Returns 0 on success.
int jegal_s2d_repack(const uint8_t* rgb, int64_t nframes, int height,
                     int width, const int32_t* cut_rows, uint8_t* out) {
  if (height % 3 != 0 || width % 3 != 0 || nframes < 0) return -1;
  const int h3n = height / 3, w3n = width / 3;
  const size_t row_bytes = static_cast<size_t>(width) * 3;
  const size_t plane = static_cast<size_t>(w3n);          // one (c) row
  const size_t block = 27 * plane;                        // one h3 block
  for (int64_t t = 0; t < nframes; ++t) {
    const uint8_t* ft = rgb + t * height * row_bytes;
    const int cut = cut_rows ? cut_rows[t] : 0;
    uint8_t* ot = out + t * h3n * block;
    for (int h3 = 0; h3 < h3n; ++h3) {
      uint8_t* ob = ot + h3 * block;
      for (int dh = 0; dh < 3; ++dh) {
        const int h = 3 * h3 + dh;
        uint8_t* oc = ob + (dh * 9) * plane;              // planes 9dh..9dh+8
        if (h < cut) {
          std::memset(oc, 0, 9 * plane);
          continue;
        }
        const uint8_t* row = ft + h * row_bytes;
        // 9 planes of this raw row: plane q = dw*3+ch takes lane 9*w3+q.
        // One sequential read pass scattering to 9 write streams beats the
        // 9-pass stride-9 gather ~10x (all streams stay in L1).
        uint8_t* d[9];
        for (int q = 0; q < 9; ++q) d[q] = oc + q * plane;
        for (int w3 = 0; w3 < w3n; ++w3) {
          const uint8_t* p = row + 9 * w3;
          d[0][w3] = p[0]; d[1][w3] = p[1]; d[2][w3] = p[2];
          d[3][w3] = p[3]; d[4][w3] = p[4]; d[5][w3] = p[5];
          d[6][w3] = p[6]; d[7][w3] = p[7]; d[8][w3] = p[8];
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
