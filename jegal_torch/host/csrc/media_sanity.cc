// Sanitizer harness for the port's native host runtime (the JAX package's
// host/csrc/media_sanity.cc, with the repack added).
//
// Builds decoder.cc and repack.cc into a standalone binary under
// -fsanitize=address,undefined and exercises every C-ABI entry point:
// encode (video-only .avi/.mp4, muxed a/v .mp4), decode (native, resized,
// cfr-resampled, audio), the space-to-depth repack (masked and unmasked,
// against a direct index loop), and the failure paths (missing file, bad
// stream, bad repack shape). Any leak, heap error, or UB aborts with a
// nonzero exit.
//
// Build + run (see tests/test_torch_host.py::test_native_runtime_sanitizers):
//   g++ -std=c++17 -g -O1 -fsanitize=address,undefined \
//       decoder.cc repack.cc media_sanity.cc -o media_sanity \
//       -lavformat -lavcodec -lavutil -lswscale -lswresample
//   ./media_sanity <workdir>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
struct JegalVideo {
  uint8_t* data;
  int64_t nframes;
  int width;
  int height;
  double fps;
};
struct JegalAudio {
  int16_t* data;
  int64_t nsamples;
  int sample_rate;
};
JegalVideo* jegal_decode_video(const char*, int, int, double);
void jegal_free_video(JegalVideo*);
JegalAudio* jegal_decode_audio(const char*, int);
void jegal_free_audio(JegalAudio*);
int jegal_encode_video(const char*, const uint8_t*, int64_t, int, int, double);
int jegal_encode_av(const char*, const uint8_t*, int64_t, int, int, double,
                    const int16_t*, int64_t, int);
int jegal_s2d_repack(const uint8_t*, int64_t, int, int, const int32_t*,
                     uint8_t*);
}

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      std::exit(1);                                                       \
    }                                                                     \
  } while (0)

int main(int argc, char** argv) {
  const std::string dir = argc > 1 ? argv[1] : ".";
  const int T = 20, H = 48, W = 64, SR = 16000;

  std::vector<uint8_t> rgb(static_cast<size_t>(T) * H * W * 3);
  for (size_t i = 0; i < rgb.size(); ++i) rgb[i] = (i * 2654435761u) >> 24;
  std::vector<int16_t> pcm(SR * T / 25);
  for (size_t i = 0; i < pcm.size(); ++i)
    pcm[i] = static_cast<int16_t>(8000 * std::sin(2 * M_PI * 440 * i / SR));

  const std::string avi = dir + "/sanity.avi";
  const std::string mp4 = dir + "/sanity.mp4";
  const std::string av = dir + "/sanity_av.mp4";
  CHECK(jegal_encode_video(avi.c_str(), rgb.data(), T, W, H, 25.0) == 0);
  CHECK(jegal_encode_video(mp4.c_str(), rgb.data(), T, W, H, 25.0) == 0);
  CHECK(jegal_encode_av(av.c_str(), rgb.data(), T, W, H, 25.0, pcm.data(),
                        static_cast<int64_t>(pcm.size()), SR) == 0);

  // decode: native, resized, cfr-resampled
  for (const auto& path : {avi, mp4, av}) {
    JegalVideo* v = jegal_decode_video(path.c_str(), 0, 0, 0.0);
    CHECK(v && v->nframes == T && v->width == W && v->height == H);
    jegal_free_video(v);
    v = jegal_decode_video(path.c_str(), 32, 24, 12.5);
    CHECK(v && v->width == 32 && v->height == 24 && v->nframes >= T / 2 - 1);
    jegal_free_video(v);
  }
  // a width whose RGB24 row is no multiple of swscale's SIMD step, decoded
  // at its native size (the destination of the scale must not be overrun)
  {
    const int OW = 107, OH = 92, OT = 4;
    std::vector<uint8_t> odd(static_cast<size_t>(OT) * OH * OW * 3);
    for (size_t i = 0; i < odd.size(); ++i) odd[i] = (i * 40503u) >> 8;
    const std::string odd_avi = dir + "/sanity_odd.avi";
    CHECK(jegal_encode_video(odd_avi.c_str(), odd.data(), OT, OW, OH,
                             25.0) == 0);
    JegalVideo* v = jegal_decode_video(odd_avi.c_str(), 0, 0, 0.0);
    CHECK(v && v->nframes == OT && v->width == OW && v->height == OH);
    jegal_free_video(v);
  }

  JegalAudio* a = jegal_decode_audio(av.c_str(), SR);
  CHECK(a && a->sample_rate == SR);
  CHECK(std::llabs(a->nsamples - static_cast<int64_t>(pcm.size())) <= 1024);
  jegal_free_audio(a);
  a = jegal_decode_audio(av.c_str(), 8000);  // resample path
  CHECK(a && a->sample_rate == 8000);
  jegal_free_audio(a);

  // failure paths must not leak or crash
  CHECK(jegal_decode_video((dir + "/missing.avi").c_str(), 0, 0, 0.0) == nullptr);
  CHECK(jegal_decode_audio(avi.c_str(), SR) == nullptr);  // no audio stream
  const std::string junk = dir + "/junk.bin";
  if (FILE* f = std::fopen(junk.c_str(), "wb")) {
    std::fwrite(rgb.data(), 1, 1024, f);
    std::fclose(f);
    CHECK(jegal_decode_video(junk.c_str(), 0, 0, 0.0) == nullptr);
  }

  // repack: every output byte against its source index, the rows above
  // each frame's cut zeroed; then the refused shapes
  const int RH = 9, RW = 12, RT = 3;
  std::vector<uint8_t> frames(static_cast<size_t>(RT) * RH * RW * 3);
  for (size_t i = 0; i < frames.size(); ++i)
    frames[i] = static_cast<uint8_t>(i * 37 + 11);
  const int32_t cuts[RT] = {0, 4, RH + 5};
  std::vector<uint8_t> planar(static_cast<size_t>(RT) * RH * RW * 3);
  for (int masked = 0; masked < 2; ++masked) {
    CHECK(jegal_s2d_repack(frames.data(), RT, RH, RW,
                           masked ? cuts : nullptr, planar.data()) == 0);
    for (int t = 0; t < RT; ++t)
      for (int h = 0; h < RH; ++h)
        for (int w = 0; w < RW; ++w)
          for (int c = 0; c < 3; ++c) {
            const size_t src =
                ((static_cast<size_t>(t) * RH + h) * RW + w) * 3 + c;
            const int q = ((h % 3) * 3 + w % 3) * 3 + c;
            const size_t dst =
                ((static_cast<size_t>(t) * (RH / 3) + h / 3) * 27 + q) *
                    (RW / 3) + w / 3;
            const bool cut = masked && h < cuts[t];
            CHECK(planar[dst] == (cut ? 0 : frames[src]));
          }
  }
  CHECK(jegal_s2d_repack(frames.data(), RT, RH - 1, RW, nullptr,
                         planar.data()) != 0);
  CHECK(jegal_s2d_repack(frames.data(), RT, RH, RW - 1, nullptr,
                         planar.data()) != 0);
  CHECK(jegal_s2d_repack(frames.data(), -1, RH, RW, nullptr,
                         planar.data()) != 0);

  std::puts("media_sanity OK");
  return 0;
}
