// The port's native media runtime: libav-based video/audio decode and
// encode (a copy of the JAX package's host/csrc/decoder.cc, so that the
// port stands alone; its space-to-depth repack lives in repack.cc, which
// builds without libav).
//
// Replaces the reference's decord VideoReader (C++ wheel) and `ffmpeg`
// subprocess shell-outs (reference inference_embs.py:10-11,136,450-451;
// preprocess/inference_preprocess.py:439-455) with an in-process C++
// library exposed over a C ABI for ctypes.
//
//   * jegal_decode_video: demux+decode a container's first video stream to
//     packed RGB24, optionally rescaled (swscale, bilinear) and resampled to
//     a constant target fps (nearest-frame cfr sampling, the effect of the
//     reference's `ffmpeg -r 25`).
//   * jegal_decode_audio: first audio stream to mono s16 at a target rate
//     (swresample) — the effect of `ffmpeg -ac 1 -ar 16000 pcm_s16le`.
//
// Build: see jegal_torch/host/media.py (g++ -O2 -shared -fPIC ...
// -lavformat -lavcodec -lavutil -lswscale -lswresample, into
// build/jegal_torch_host/ at the repository root).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct StreamCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;

  ~StreamCtx() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  // type: AVMEDIA_TYPE_VIDEO / AVMEDIA_TYPE_AUDIO
  bool open(const char* path, AVMediaType type) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return false;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return false;
    stream_index = av_find_best_stream(fmt, type, -1, -1, nullptr, 0);
    if (stream_index < 0) return false;
    const AVStream* st = fmt->streams[stream_index];
    const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) return false;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return false;
    if (avcodec_parameters_to_context(dec, st->codecpar) < 0) return false;
    if (avcodec_open2(dec, codec, nullptr) < 0) return false;
    return true;
  }
};

}  // namespace

extern "C" {

struct JegalVideo {
  uint8_t* data;   // nframes * h * w * 3, packed RGB24
  int64_t nframes;
  int width;
  int height;
  double fps;      // output fps (target, or stream average)
};

struct JegalAudio {
  int16_t* data;   // mono s16
  int64_t nsamples;
  int sample_rate;
};

// Decode the first video stream. target_w/target_h <= 0 keeps native size;
// target_fps <= 0 keeps the native (possibly variable) frame sequence.
// Returns nullptr on failure.
JegalVideo* jegal_decode_video(const char* path, int target_w, int target_h,
                               double target_fps) {
  StreamCtx sc;
  if (!sc.open(path, AVMEDIA_TYPE_VIDEO)) return nullptr;
  AVStream* st = sc.fmt->streams[sc.stream_index];

  const int out_w = target_w > 0 ? target_w : sc.dec->width;
  const int out_h = target_h > 0 ? target_h : sc.dec->height;
  if (out_w <= 0 || out_h <= 0) return nullptr;
  const size_t frame_bytes = static_cast<size_t>(out_w) * out_h * 3;

  // swscale writes whole SIMD vectors, so it can overrun a packed RGB24
  // row whose width is not a multiple of its step (past a frame's last row
  // that is past the buffer: 107x92 corrupted the heap). It scales into a
  // scratch image with 64-byte aligned, padded rows; each row is copied out.
  uint8_t* scratch[4] = {nullptr, nullptr, nullptr, nullptr};
  int scratch_linesize[4] = {0, 0, 0, 0};
  if (av_image_alloc(scratch, scratch_linesize, out_w, out_h,
                     AV_PIX_FMT_RGB24, 64) < 0)
    return nullptr;
  const size_t row_bytes = static_cast<size_t>(out_w) * 3;

  SwsContext* sws = nullptr;
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  std::vector<uint8_t> frames;   // contiguous RGB24 frames
  std::vector<double> times;     // presentation time of each decoded frame
  const double tb = av_q2d(st->time_base);
  double native_fps = av_q2d(st->avg_frame_rate);
  if (!(native_fps > 0)) native_fps = 25.0;

  auto push_frame = [&](AVFrame* f) {
    sws = sws_getCachedContext(sws, f->width, f->height,
                               static_cast<AVPixelFormat>(f->format), out_w,
                               out_h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                               nullptr, nullptr);
    if (!sws) return false;
    sws_scale(sws, f->data, f->linesize, 0, f->height, scratch,
              scratch_linesize);
    size_t off = frames.size();
    frames.resize(off + frame_bytes);
    for (int y = 0; y < out_h; ++y)
      std::memcpy(frames.data() + off + y * row_bytes,
                  scratch[0] + static_cast<size_t>(y) * scratch_linesize[0],
                  row_bytes);
    int64_t pts = f->best_effort_timestamp;
    times.push_back(pts == AV_NOPTS_VALUE ? times.size() / native_fps
                                          : pts * tb);
    return true;
  };

  bool ok = true;
  while (ok && av_read_frame(sc.fmt, pkt) >= 0) {
    if (pkt->stream_index == sc.stream_index) {
      if (avcodec_send_packet(sc.dec, pkt) >= 0) {
        while (avcodec_receive_frame(sc.dec, frame) >= 0) {
          if (!push_frame(frame)) { ok = false; break; }
        }
      }
    }
    av_packet_unref(pkt);
  }
  // flush
  if (ok && avcodec_send_packet(sc.dec, nullptr) >= 0) {
    while (avcodec_receive_frame(sc.dec, frame) >= 0) {
      if (!push_frame(frame)) { ok = false; break; }
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (sws) sws_freeContext(sws);
  av_freep(&scratch[0]);

  const int64_t n_decoded = static_cast<int64_t>(times.size());
  if (!ok || n_decoded == 0) return nullptr;

  auto* out = static_cast<JegalVideo*>(std::malloc(sizeof(JegalVideo)));
  out->width = out_w;
  out->height = out_h;

  if (target_fps > 0) {
    // constant-fps resample: for each output tick pick the latest decoded
    // frame whose pts <= tick time (ffmpeg -r duplication/drop behavior).
    const double t0 = times.front();
    const double duration = times.back() - t0;
    const int64_t n_out =
        std::max<int64_t>(1, static_cast<int64_t>(duration * target_fps) + 1);
    out->data = static_cast<uint8_t*>(std::malloc(n_out * frame_bytes));
    int64_t src = 0;
    for (int64_t i = 0; i < n_out; ++i) {
      const double t = t0 + i / target_fps;
      while (src + 1 < n_decoded && times[src + 1] <= t + 1e-9) ++src;
      std::memcpy(out->data + i * frame_bytes, frames.data() + src * frame_bytes,
                  frame_bytes);
    }
    out->nframes = n_out;
    out->fps = target_fps;
  } else {
    out->data = static_cast<uint8_t*>(std::malloc(frames.size()));
    std::memcpy(out->data, frames.data(), frames.size());
    out->nframes = n_decoded;
    out->fps = native_fps;
  }
  return out;
}

void jegal_free_video(JegalVideo* v) {
  if (v) {
    std::free(v->data);
    std::free(v);
  }
}

// Decode the first audio stream to mono s16 at target_rate.
JegalAudio* jegal_decode_audio(const char* path, int target_rate) {
  StreamCtx sc;
  if (!sc.open(path, AVMEDIA_TYPE_AUDIO)) return nullptr;

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (sc.dec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &sc.dec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_S16, target_rate,
                          &in_layout, sc.dec->sample_fmt,
                          sc.dec->sample_rate, 0, nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    return nullptr;
  }

  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  std::vector<int16_t> samples;

  auto drain = [&](AVFrame* f) {
    const int max_out = swr_get_out_samples(swr, f ? f->nb_samples : 0);
    if (max_out <= 0) return true;
    std::vector<int16_t> buf(max_out);
    uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(buf.data())};
    const int got = swr_convert(swr, out_planes, max_out,
                                f ? const_cast<const uint8_t**>(f->data) : nullptr,
                                f ? f->nb_samples : 0);
    if (got < 0) return false;
    samples.insert(samples.end(), buf.begin(), buf.begin() + got);
    return true;
  };

  bool ok = true;
  while (ok && av_read_frame(sc.fmt, pkt) >= 0) {
    if (pkt->stream_index == sc.stream_index) {
      if (avcodec_send_packet(sc.dec, pkt) >= 0) {
        while (avcodec_receive_frame(sc.dec, frame) >= 0) {
          if (!drain(frame)) { ok = false; break; }
        }
      }
    }
    av_packet_unref(pkt);
  }
  if (ok && avcodec_send_packet(sc.dec, nullptr) >= 0) {
    while (avcodec_receive_frame(sc.dec, frame) >= 0) {
      if (!drain(frame)) { ok = false; break; }
    }
  }
  if (ok) drain(nullptr);  // flush the resampler

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  av_channel_layout_uninit(&in_layout);
  if (!ok || samples.empty()) return nullptr;

  auto* out = static_cast<JegalAudio*>(std::malloc(sizeof(JegalAudio)));
  out->nsamples = static_cast<int64_t>(samples.size());
  out->sample_rate = target_rate;
  out->data = static_cast<int16_t*>(std::malloc(samples.size() * sizeof(int16_t)));
  std::memcpy(out->data, samples.data(), samples.size() * sizeof(int16_t));
  return out;
}

void jegal_free_audio(JegalAudio* a) {
  if (a) {
    std::free(a->data);
    std::free(a);
  }
}

// Encode packed RGB24 frames to a video file (container from extension;
// mpeg4 for .avi — the reference's XVID writer equivalent,
// preprocess/inference_preprocess.py:374-379). Returns 0 on success.
int jegal_encode_video(const char* path, const uint8_t* rgb, int64_t nframes,
                       int width, int height, double fps) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) { avformat_free_context(fmt); return -2; }
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  if (!st || !enc) {
    if (enc) avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -2;
  }
  enc->width = width;
  enc->height = height;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->time_base = av_d2q(1.0 / fps, 100000);
  enc->framerate = av_d2q(fps, 100000);
  enc->bit_rate = static_cast<int64_t>(width) * height * 4;  // generous
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  int rc = -3;
  SwsContext* sws = nullptr;
  AVFrame* yuv = nullptr;
  AVPacket* pkt = nullptr;
  do {
    if (avcodec_open2(enc, codec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) break;
    if (avformat_write_header(fmt, nullptr) < 0) break;

    sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                         AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr,
                         nullptr);
    yuv = av_frame_alloc();
    if (!sws || !yuv) break;
    yuv->format = AV_PIX_FMT_YUV420P;
    yuv->width = width;
    yuv->height = height;
    if (av_frame_get_buffer(yuv, 0) < 0) break;
    pkt = av_packet_alloc();
    if (!pkt) break;

    auto write_packets = [&]() {
      while (avcodec_receive_packet(enc, pkt) >= 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        // explicit frame duration: the mov/mp4 muxer derives the track's
        // sample table from packet durations and silently drops a
        // zero-duration final sample on some demuxers
        if (pkt->duration == 0)
          pkt->duration = av_rescale_q(1, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(fmt, pkt);
      }
    };

    const size_t frame_bytes = static_cast<size_t>(width) * height * 3;
    bool ok = true;
    for (int64_t i = 0; i < nframes && ok; ++i) {
      const uint8_t* src_data[1] = {rgb + i * frame_bytes};
      int src_linesize[1] = {width * 3};
      av_frame_make_writable(yuv);
      sws_scale(sws, src_data, src_linesize, 0, height, yuv->data,
                yuv->linesize);
      yuv->pts = i;
      if (avcodec_send_frame(enc, yuv) < 0) ok = false;
      write_packets();
    }
    avcodec_send_frame(enc, nullptr);
    write_packets();
    av_write_trailer(fmt);
    rc = ok ? 0 : -4;
  } while (false);

  if (pkt) av_packet_free(&pkt);
  if (yuv) av_frame_free(&yuv);
  if (sws) sws_freeContext(sws);
  avcodec_free_context(&enc);
  if (fmt && !(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
    avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

// Encode packed RGB24 frames + mono s16 audio into ONE container (mpeg4
// video + AAC audio; container from extension, .mp4 expected). The native
// counterpart of the reference's audio/video merge step
// (dataset/preprocess_videos.py:503-545: ffmpeg -i crop.avi -i crop.wav ->
// merged .mp4 for visualization). Streams are fed interleaved by timestamp
// so the muxer never buffers more than ~one frame ahead. Returns 0 on
// success.
int jegal_encode_av(const char* path, const uint8_t* rgb, int64_t nframes,
                    int width, int height, double fps, const int16_t* pcm,
                    int64_t nsamples, int sample_rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* vcodec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  const AVCodec* acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  if (!vcodec || !acodec) { avformat_free_context(fmt); return -2; }

  AVStream* vst = avformat_new_stream(fmt, nullptr);
  AVStream* ast = avformat_new_stream(fmt, nullptr);
  AVCodecContext* venc = avcodec_alloc_context3(vcodec);
  AVCodecContext* aenc = avcodec_alloc_context3(acodec);
  if (!vst || !ast || !venc || !aenc) {
    if (venc) avcodec_free_context(&venc);
    if (aenc) avcodec_free_context(&aenc);
    avformat_free_context(fmt);
    return -2;
  }
  venc->width = width;
  venc->height = height;
  venc->pix_fmt = AV_PIX_FMT_YUV420P;
  venc->time_base = av_d2q(1.0 / fps, 100000);
  venc->framerate = av_d2q(fps, 100000);
  venc->bit_rate = static_cast<int64_t>(width) * height * 4;
  aenc->sample_rate = sample_rate;
  aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
  av_channel_layout_default(&aenc->ch_layout, 1);
  aenc->time_base = AVRational{1, sample_rate};
  aenc->bit_rate = 96000;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER) {
    venc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  }

  int rc = -3;
  SwsContext* sws = nullptr;
  AVFrame* yuv = nullptr;
  AVFrame* af = nullptr;
  AVPacket* pkt = nullptr;
  do {
    if (avcodec_open2(venc, vcodec, nullptr) < 0) break;
    if (avcodec_open2(aenc, acodec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(vst->codecpar, venc) < 0) break;
    if (avcodec_parameters_from_context(ast->codecpar, aenc) < 0) break;
    vst->time_base = venc->time_base;
    ast->time_base = aenc->time_base;
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) break;
    if (avformat_write_header(fmt, nullptr) < 0) break;

    sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                         AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr,
                         nullptr);
    yuv = av_frame_alloc();
    if (!sws || !yuv) break;
    yuv->format = AV_PIX_FMT_YUV420P;
    yuv->width = width;
    yuv->height = height;
    if (av_frame_get_buffer(yuv, 0) < 0) break;
    const int asamples = aenc->frame_size > 0 ? aenc->frame_size : 1024;
    af = av_frame_alloc();
    if (!af) break;
    af->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&af->ch_layout, 1);
    af->sample_rate = sample_rate;
    af->nb_samples = asamples;
    if (av_frame_get_buffer(af, 0) < 0) break;
    pkt = av_packet_alloc();
    if (!pkt) break;

    bool ok = true;
    auto write_packets = [&](AVCodecContext* enc, AVStream* st,
                             int64_t dur_tb) {
      while (true) {
        const int r = avcodec_receive_packet(enc, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) { ok = false; break; }
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        if (pkt->duration == 0)  // see jegal_encode_video note
          pkt->duration = av_rescale_q(dur_tb, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(fmt, pkt) < 0) { ok = false; break; }
      }
    };

    const size_t frame_bytes = static_cast<size_t>(width) * height * 3;
    int64_t vi = 0;      // next video frame
    int64_t apos = 0;    // next audio sample
    while (ok && (vi < nframes || apos < nsamples)) {
      const double vtime = vi / fps;
      const double atime = static_cast<double>(apos) / sample_rate;
      if (vi < nframes && (apos >= nsamples || vtime <= atime)) {
        const uint8_t* src_data[1] = {rgb + vi * frame_bytes};
        int src_linesize[1] = {width * 3};
        av_frame_make_writable(yuv);
        sws_scale(sws, src_data, src_linesize, 0, height, yuv->data,
                  yuv->linesize);
        yuv->pts = vi;
        if (avcodec_send_frame(venc, yuv) < 0) ok = false;
        write_packets(venc, vst, 1);
        ++vi;
      } else {
        const int n = static_cast<int>(
            std::min<int64_t>(asamples, nsamples - apos));
        av_frame_make_writable(af);
        float* dst = reinterpret_cast<float*>(af->data[0]);
        for (int i = 0; i < n; ++i)
          dst[i] = pcm[apos + i] / 32768.0f;
        for (int i = n; i < asamples; ++i) dst[i] = 0.0f;
        af->nb_samples = asamples;  // encoder wants full frames (AAC)
        af->pts = apos;
        if (avcodec_send_frame(aenc, af) < 0) ok = false;
        write_packets(aenc, ast, asamples);
        apos += n;
      }
    }
    if (ok) {
      avcodec_send_frame(venc, nullptr);
      write_packets(venc, vst, 1);
      avcodec_send_frame(aenc, nullptr);
      write_packets(aenc, ast, asamples);
      av_write_trailer(fmt);
    }
    rc = ok ? 0 : -4;
  } while (false);

  if (pkt) av_packet_free(&pkt);
  if (yuv) av_frame_free(&yuv);
  if (af) av_frame_free(&af);
  if (sws) sws_freeContext(sws);
  avcodec_free_context(&venc);
  avcodec_free_context(&aenc);
  if (fmt && !(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
    avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

}  // extern "C"
