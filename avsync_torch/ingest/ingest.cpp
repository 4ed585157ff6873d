// avsync_torch native ingest stage (a copy of the JAX package's
// avsync/ingest/ingest.cpp): FFmpeg/libav demux + decode for video frames
// (grayscale uint8) and audio (mono float32), exposed through a C ABI for
// ctypes (avsync_torch/ingest/native.py builds and binds it).
//
// Replaces the reference's host decode paths — cv2.VideoCapture per-frame
// loops (dataset.py:201-236), cv2 FPS probing (misalignment_detection_
// train.py:91-97), and the librosa/moviepy audio chain
// (misalignment_detection_train.py:170-197) — with one pass over the
// container: the demuxer fans packets out to both codecs, video planes are
// converted to gray8 with libswscale, and audio is resampled to mono f32 at
// the requested rate with libswresample. Python sees pinned numpy-ready
// buffers; everything downstream (crop/resize/normalize/MFCC) runs on the
// device.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Decoded {
  std::vector<uint8_t> video;  // T*H*W gray8
  int n_frames = 0;
  int height = 0;
  int width = 0;
  double fps = 0.0;
  std::vector<float> audio;  // mono f32
  int sample_rate = 0;
  char error[256] = {0};
  // optional decode-time ROI crop + resize (normalized fractions; out_w>0
  // enables). Done on the single gray8 plane with swscale — frames leave the
  // ingest stage already at model geometry, so only ~1/20 of the bytes cross
  // the host->device link.
  double crop_y0 = 0, crop_y1 = 1, crop_x0 = 0, crop_x1 = 1;
  int out_w = 0, out_h = 0;
  SwsContext* crop_sws = nullptr;
};

void set_error(Decoded* d, const char* msg) {
  std::strncpy(d->error, msg, sizeof(d->error) - 1);
}

// Drain every frame currently decodable from `ctx` and append.
int drain_video(AVCodecContext* ctx, SwsContext** sws, AVFrame* frame,
                Decoded* out, int max_frames) {
  int ret;
  while ((ret = avcodec_receive_frame(ctx, frame)) == 0) {
    if (max_frames > 0 && out->n_frames >= max_frames) {
      av_frame_unref(frame);
      continue;  // keep draining so the decoder stays healthy
    }
    bool cropping = out->out_w > 0;
    if (out->height == 0) {
      out->height = cropping ? out->out_h : frame->height;
      out->width = cropping ? out->out_w : frame->width;
    }
    int fw = frame->width, fh = frame->height;
    // Scale to the geometry latched from the first frame: a mid-stream
    // resolution change must not change the per-frame buffer stride (the
    // append below sizes by out->height*out->width).
    *sws = sws_getCachedContext(*sws, fw, fh, (AVPixelFormat)frame->format,
                                out->width, out->height, AV_PIX_FMT_GRAY8,
                                SWS_BILINEAR, nullptr, nullptr, nullptr);
    size_t off = out->video.size();
    out->video.resize(off + (size_t)out->height * out->width);
    if (!cropping) {
      uint8_t* dst_data[4] = {out->video.data() + off, nullptr, nullptr,
                              nullptr};
      int dst_linesize[4] = {out->width, 0, 0, 0};
      sws_scale(*sws, frame->data, frame->linesize, 0, fh, dst_data,
                dst_linesize);
    } else {
      // Crop directly in the decoded pixel format via per-plane pointer
      // offsets (chroma planes shifted by the format's subsampling), then
      // one sws pass: cropped YUV -> gray8 at target geometry. The full
      // frame is never materialized in gray.
      int y0 = (int)(fh * out->crop_y0), y1 = (int)(fh * out->crop_y1);
      int x0 = (int)(fw * out->crop_x0), x1 = (int)(fw * out->crop_x1);
      if (y1 <= y0) y1 = y0 + 1;
      if (x1 <= x0) x1 = x0 + 1;
      // even-align the origin so chroma offsets stay exact
      y0 &= ~1;
      x0 &= ~1;
      int cw = x1 - x0, ch = y1 - y0;
      const AVPixFmtDescriptor* desc =
          av_pix_fmt_desc_get((AVPixelFormat)frame->format);
      uint8_t* dst_data[4] = {out->video.data() + off, nullptr, nullptr,
                              nullptr};
      int dst_lin[4] = {out->out_w, 0, 0, 0};
      // Pointer-offset cropping needs byte-addressable pixels; bitstream
      // (<8-bit packed) and palettized formats get the gray-first fallback.
      bool ptr_croppable =
          desc != nullptr &&
          !(desc->flags & (AV_PIX_FMT_FLAG_BITSTREAM | AV_PIX_FMT_FLAG_PAL));
      if (ptr_croppable) {
        // Horizontal byte step per plane from the format descriptor: 1 for
        // planar 8-bit (yuv420p), 2 for 16-bit planar (p016/yuv420p16),
        // 3 for packed rgb24, 2 for yuyv422's luma plane, etc.
        size_t plane_step[4] = {0, 0, 0, 0};
        for (int c = 0; c < desc->nb_components; ++c) {
          int p = desc->comp[c].plane;
          if (p >= 0 && p < 4 && plane_step[p] == 0)
            plane_step[p] = (size_t)desc->comp[c].step;
        }
        const uint8_t* src_data[4] = {nullptr, nullptr, nullptr, nullptr};
        int src_lin[4] = {0, 0, 0, 0};
        for (int p = 0; p < 4 && frame->data[p]; ++p) {
          int hs = (p == 1 || p == 2) ? desc->log2_chroma_w : 0;
          int vs = (p == 1 || p == 2) ? desc->log2_chroma_h : 0;
          size_t step = plane_step[p] ? plane_step[p] : 1;
          src_data[p] = frame->data[p] +
                        (size_t)(y0 >> vs) * frame->linesize[p] +
                        (size_t)(x0 >> hs) * step;
          src_lin[p] = frame->linesize[p];
        }
        out->crop_sws = sws_getCachedContext(
            out->crop_sws, cw, ch, (AVPixelFormat)frame->format, out->out_w,
            out->out_h, AV_PIX_FMT_GRAY8, SWS_BILINEAR, nullptr, nullptr,
            nullptr);
        sws_scale(out->crop_sws, src_data, src_lin, 0, ch, dst_data, dst_lin);
      } else {
        // Fallback: whole frame -> gray8 once, then the crop is plain byte
        // arithmetic in gray space before the resize pass.
        std::vector<uint8_t> gray((size_t)fh * fw);
        SwsContext* to_gray = sws_getContext(
            fw, fh, (AVPixelFormat)frame->format, fw, fh, AV_PIX_FMT_GRAY8,
            SWS_BILINEAR, nullptr, nullptr, nullptr);
        if (to_gray == nullptr) return AVERROR(EINVAL);
        uint8_t* gdst[4] = {gray.data(), nullptr, nullptr, nullptr};
        int glin[4] = {fw, 0, 0, 0};
        sws_scale(to_gray, frame->data, frame->linesize, 0, fh, gdst, glin);
        sws_freeContext(to_gray);
        const uint8_t* csrc[4] = {gray.data() + (size_t)y0 * fw + x0,
                                  nullptr, nullptr, nullptr};
        int clin[4] = {fw, 0, 0, 0};
        out->crop_sws = sws_getCachedContext(
            out->crop_sws, cw, ch, AV_PIX_FMT_GRAY8, out->out_w, out->out_h,
            AV_PIX_FMT_GRAY8, SWS_BILINEAR, nullptr, nullptr, nullptr);
        sws_scale(out->crop_sws, csrc, clin, 0, ch, dst_data, dst_lin);
      }
    }
    out->n_frames++;
    av_frame_unref(frame);
  }
  return ret == AVERROR(EAGAIN) || ret == AVERROR_EOF ? 0 : ret;
}

int drain_audio(AVCodecContext* ctx, SwrContext* swr, AVFrame* frame,
                Decoded* out, int target_sr) {
  int ret;
  while ((ret = avcodec_receive_frame(ctx, frame)) == 0) {
    int max_out =
        (int)av_rescale_rnd(swr_get_delay(swr, ctx->sample_rate) +
                                frame->nb_samples,
                            target_sr, ctx->sample_rate, AV_ROUND_UP);
    size_t off = out->audio.size();
    out->audio.resize(off + max_out);
    uint8_t* dst = (uint8_t*)(out->audio.data() + off);
    int got = swr_convert(swr, &dst, max_out,
                          (const uint8_t**)frame->extended_data,
                          frame->nb_samples);
    if (got < 0) return got;
    out->audio.resize(off + got);
    av_frame_unref(frame);
  }
  return ret == AVERROR(EAGAIN) || ret == AVERROR_EOF ? 0 : ret;
}

}  // namespace

extern "C" {

namespace {

// Core decode into a pre-configured Decoded (crop fields may be set).
void run_decode(Decoded* out, const char* path, int max_frames,
                int target_sr) {
  av_log_set_level(AV_LOG_ERROR);  // silence swscaler format chatter
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) {
    set_error(out, "cannot open input");
    return;
  }
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    set_error(out, "no stream info");
    avformat_close_input(&fmt);
    return;
  }

  int vidx = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  int aidx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);

  AVCodecContext *vctx = nullptr, *actx = nullptr;
  SwsContext* sws = nullptr;
  SwrContext* swr = nullptr;

  if (vidx >= 0) {
    const AVCodec* dec =
        avcodec_find_decoder(fmt->streams[vidx]->codecpar->codec_id);
    if (dec) {
      vctx = avcodec_alloc_context3(dec);
      avcodec_parameters_to_context(vctx, fmt->streams[vidx]->codecpar);
      if (avcodec_open2(vctx, dec, nullptr) < 0) {
        avcodec_free_context(&vctx);
      } else {
        AVRational r = av_guess_frame_rate(fmt, fmt->streams[vidx], nullptr);
        out->fps = r.den ? av_q2d(r) : 0.0;
      }
    }
  }
  if (aidx >= 0) {
    const AVCodec* dec =
        avcodec_find_decoder(fmt->streams[aidx]->codecpar->codec_id);
    if (dec) {
      actx = avcodec_alloc_context3(dec);
      avcodec_parameters_to_context(actx, fmt->streams[aidx]->codecpar);
      if (avcodec_open2(actx, dec, nullptr) < 0) {
        avcodec_free_context(&actx);
      } else {
        out->sample_rate = target_sr > 0 ? target_sr : actx->sample_rate;
        AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
        swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, out->sample_rate,
                            &actx->ch_layout, actx->sample_fmt,
                            actx->sample_rate, 0, nullptr);
        if (!swr || swr_init(swr) < 0) {
          if (swr) swr_free(&swr);
          avcodec_free_context(&actx);
          out->sample_rate = 0;
        }
      }
    }
  }

  if (!vctx && !actx) {
    set_error(out, "no decodable streams");
  } else {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    while (av_read_frame(fmt, pkt) >= 0) {
      if (vctx && pkt->stream_index == vidx) {
        if (avcodec_send_packet(vctx, pkt) == 0)
          drain_video(vctx, &sws, frame, out, max_frames);
      } else if (actx && pkt->stream_index == aidx) {
        if (avcodec_send_packet(actx, pkt) == 0)
          drain_audio(actx, swr, frame, out, out->sample_rate);
      }
      av_packet_unref(pkt);
    }
    // flush decoders
    if (vctx) {
      avcodec_send_packet(vctx, nullptr);
      drain_video(vctx, &sws, frame, out, max_frames);
    }
    if (actx) {
      avcodec_send_packet(actx, nullptr);
      drain_audio(actx, swr, frame, out, out->sample_rate);
      // flush the resampler's internal delay line
      int tail = (int)swr_get_delay(swr, out->sample_rate);
      if (tail > 0) {
        size_t off = out->audio.size();
        out->audio.resize(off + tail);
        uint8_t* dst = (uint8_t*)(out->audio.data() + off);
        int got = swr_convert(swr, &dst, tail, nullptr, 0);
        out->audio.resize(off + (got > 0 ? got : 0));
      }
    }
    av_packet_free(&pkt);
    av_frame_free(&frame);
  }

  if (sws) sws_freeContext(sws);
  if (out->crop_sws) {
    sws_freeContext(out->crop_sws);
    out->crop_sws = nullptr;
  }
  if (swr) swr_free(&swr);
  if (vctx) avcodec_free_context(&vctx);
  if (actx) avcodec_free_context(&actx);
  avformat_close_input(&fmt);
}

}  // namespace

// Decode `path`. max_frames <= 0 means all frames. target_sr <= 0 keeps the
// stream's native sample rate. Returns an opaque handle (never null); check
// avs_error() for failure.
void* avs_decode(const char* path, int max_frames, int target_sr) {
  auto* out = new Decoded();
  run_decode(out, path, max_frames, target_sr);
  return out;
}

// Decode with decode-time ROI crop (normalized fractions) + resize to
// (out_w, out_h) — frames arrive at model geometry, minimizing transfer.
void* avs_decode_roi(const char* path, int max_frames, int target_sr,
                     double y0, double y1, double x0, double x1, int out_w,
                     int out_h) {
  auto* out = new Decoded();
  out->crop_y0 = y0;
  out->crop_y1 = y1;
  out->crop_x0 = x0;
  out->crop_x1 = x1;
  out->out_w = out_w;
  out->out_h = out_h;
  run_decode(out, path, max_frames, target_sr);
  return out;
}

void avs_release(void* h);  // defined below

// Batched decode executor: demux/decode `n` files concurrently on a thread
// pool (each libav context is thread-private; codecs also parallelize
// internally). Returns a malloc'd array of n handles — the data-loader
// analogue of the reference's DataLoader(num_workers=4) (`main.py:133`),
// but in native code with zero Python in the loop.
void** avs_decode_batch(const char** paths, int n, int max_frames,
                        int target_sr, int n_threads) {
  void** out = new void*[n];
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 2;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      out[i] = avs_decode(paths[i], max_frames, target_sr);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return out;
}

void** avs_decode_batch_roi(const char** paths, int n, int max_frames,
                            int target_sr, double y0, double y1, double x0,
                            double x1, int out_w, int out_h, int n_threads) {
  void** out = new void*[n];
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 2;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      out[i] = avs_decode_roi(paths[i], max_frames, target_sr, y0, y1, x0,
                              x1, out_w, out_h);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return out;
}

void avs_release_batch(void** handles, int n) {
  for (int i = 0; i < n; ++i) avs_release(handles[i]);
  delete[] handles;
}

// ---------------------------------------------------------------------------
// Demo muxer: BGR frames + mono f32 audio -> .mp4 (libx264 + aac), the exact
// artifact the reference writes with moviepy
// (misalignment_detection_demo.py:231-237: write_videofile codec='libx264',
// audio_codec='aac'). moviepy is absent here; libavcodec carries both
// encoders, so the mux is one native call.
// ---------------------------------------------------------------------------

int avs_mux_mp4(const char* path, const uint8_t* frames, int n_frames,
                int height, int width, double fps, const float* audio,
                long long n_samples, int sample_rate, char* err,
                int err_len) {
  auto fail = [&](const char* msg) {
    if (err && err_len > 0) {
      std::strncpy(err, msg, (size_t)err_len - 1);
      err[err_len - 1] = 0;
    }
    return -1;
  };
  // yuv420p requires even dimensions; crop a trailing row/col if needed
  int W = width & ~1, H = height & ~1;
  if (W <= 0 || H <= 0 || n_frames <= 0) return fail("empty video");

  AVFormatContext* oc = nullptr;
  if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path) < 0 || !oc)
    return fail("cannot allocate mp4 muxer");

  // --- video stream (libx264, yuv420p) ---------------------------------
  const AVCodec* vcodec = avcodec_find_encoder_by_name("libx264");
  if (!vcodec) vcodec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!vcodec) return fail("no h264/mpeg4 encoder");
  AVStream* vst = avformat_new_stream(oc, nullptr);
  AVCodecContext* vctx = avcodec_alloc_context3(vcodec);
  vctx->width = W;
  vctx->height = H;
  vctx->pix_fmt = AV_PIX_FMT_YUV420P;
  vctx->time_base = av_inv_q(av_d2q(fps, 100000));
  vctx->framerate = av_d2q(fps, 100000);
  vctx->gop_size = 12;
  // no B-frames: reordering cost one trailing frame through some demuxers,
  // and 3-second demo clips gain nothing from them
  vctx->max_b_frames = 0;
  if (oc->oformat->flags & AVFMT_GLOBALHEADER)
    vctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  av_opt_set(vctx->priv_data, "preset", "veryfast", 0);
  av_opt_set(vctx->priv_data, "crf", "20", 0);
  if (avcodec_open2(vctx, vcodec, nullptr) < 0) {
    avcodec_free_context(&vctx);
    avformat_free_context(oc);
    return fail("cannot open video encoder");
  }
  avcodec_parameters_from_context(vst->codecpar, vctx);
  vst->time_base = vctx->time_base;

  // --- audio stream (aac, fltp mono) ------------------------------------
  const AVCodec* acodec = nullptr;
  AVStream* ast = nullptr;
  AVCodecContext* actx = nullptr;
  bool have_audio = audio != nullptr && n_samples > 0 && sample_rate > 0;
  if (have_audio) {
    acodec = avcodec_find_encoder_by_name("aac");
    if (!acodec) acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  }
  if (have_audio && acodec) {
    ast = avformat_new_stream(oc, nullptr);
    actx = avcodec_alloc_context3(acodec);
    actx->sample_fmt = AV_SAMPLE_FMT_FLTP;
    actx->sample_rate = sample_rate;
    av_channel_layout_default(&actx->ch_layout, 1);
    actx->bit_rate = 128000;
    actx->time_base = (AVRational){1, sample_rate};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      actx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(actx, acodec, nullptr) < 0) {
      avcodec_free_context(&actx);
      actx = nullptr;
      ast = nullptr;
    } else {
      avcodec_parameters_from_context(ast->codecpar, actx);
      ast->time_base = actx->time_base;
    }
  }

  if (!(oc->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0) {
    avcodec_free_context(&vctx);
    if (actx) avcodec_free_context(&actx);
    avformat_free_context(oc);
    return fail("cannot open output file");
  }

  // Every failure past this point (including header write) routes through
  // one cleanup path that frees both codec contexts, the frames/packet,
  // closes the avio handle and frees the muxer — and every encode/write
  // call's return code is checked, so an ENOSPC mid-write surfaces as an
  // error instead of a silently truncated .mp4.
  AVPacket* pkt = av_packet_alloc();
  SwsContext* sws = nullptr;
  AVFrame* vf = nullptr;
  AVFrame* af = nullptr;
  auto cleanup = [&]() {
    if (sws) sws_freeContext(sws);
    if (vf) av_frame_free(&vf);
    if (af) av_frame_free(&af);
    if (pkt) av_packet_free(&pkt);
    avcodec_free_context(&vctx);
    if (actx) avcodec_free_context(&actx);
    if (!(oc->oformat->flags & AVFMT_NOFILE) && oc->pb) avio_closep(&oc->pb);
    avformat_free_context(oc);
  };
  auto fail_cleanup = [&](const char* msg) {
    cleanup();
    return fail(msg);
  };

  if (avformat_write_header(oc, nullptr) < 0)
    return fail_cleanup("header write failed");

  auto drain = [&](AVCodecContext* ctx, AVStream* st, int64_t dur) -> int {
    int r;
    while ((r = avcodec_receive_packet(ctx, pkt)) == 0) {
      // an unset duration leaves the mp4's last sample 0-length, which
      // ffmpeg-family demuxers then drop on decode — set it explicitly
      if (pkt->duration == 0) pkt->duration = dur;
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      int w = av_interleaved_write_frame(oc, pkt);
      av_packet_unref(pkt);
      if (w < 0) return w;
    }
    return (r == AVERROR(EAGAIN) || r == AVERROR_EOF) ? 0 : r;
  };

  // encode video: BGR24 -> yuv420p
  sws = sws_getContext(W, H, AV_PIX_FMT_BGR24, W, H, AV_PIX_FMT_YUV420P,
                       SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) return fail_cleanup("cannot create pixel converter");
  vf = av_frame_alloc();
  vf->format = AV_PIX_FMT_YUV420P;
  vf->width = W;
  vf->height = H;
  if (av_frame_get_buffer(vf, 0) < 0)
    return fail_cleanup("cannot allocate video frame");
  for (int i = 0; i < n_frames; ++i) {
    av_frame_make_writable(vf);
    const uint8_t* src[1] = {frames + (size_t)i * height * width * 3};
    int src_lin[1] = {width * 3};
    sws_scale(sws, src, src_lin, 0, H, vf->data, vf->linesize);
    vf->pts = i;
    if (avcodec_send_frame(vctx, vf) < 0 || drain(vctx, vst, 1) < 0)
      return fail_cleanup("video encode/write failed");
  }
  if (avcodec_send_frame(vctx, nullptr) < 0 || drain(vctx, vst, 1) < 0)
    return fail_cleanup("video encoder flush failed");

  // encode audio in encoder-frame-size chunks (AAC: 1024), zero-padded tail
  if (actx) {
    int fsz = actx->frame_size > 0 ? actx->frame_size : 1024;
    af = av_frame_alloc();
    af->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&af->ch_layout, 1);
    af->sample_rate = sample_rate;
    af->nb_samples = fsz;
    if (av_frame_get_buffer(af, 0) < 0)
      return fail_cleanup("cannot allocate audio frame");
    long long pos = 0;
    while (pos < n_samples) {
      av_frame_make_writable(af);
      int take = (int)((n_samples - pos) < fsz ? (n_samples - pos) : fsz);
      float* dst = (float*)af->data[0];
      std::memcpy(dst, audio + pos, sizeof(float) * take);
      if (take < fsz) std::memset(dst + take, 0, sizeof(float) * (fsz - take));
      af->pts = pos;
      if (avcodec_send_frame(actx, af) < 0 || drain(actx, ast, fsz) < 0)
        return fail_cleanup("audio encode/write failed");
      pos += take;
    }
    if (avcodec_send_frame(actx, nullptr) < 0 || drain(actx, ast, fsz) < 0)
      return fail_cleanup("audio encoder flush failed");
  }

  if (av_write_trailer(oc) < 0) return fail_cleanup("trailer write failed");
  cleanup();
  return 0;
}

const char* avs_error(void* h) {
  auto* d = (Decoded*)h;
  return d->error[0] ? d->error : nullptr;
}
int avs_n_frames(void* h) { return ((Decoded*)h)->n_frames; }
int avs_height(void* h) { return ((Decoded*)h)->height; }
int avs_width(void* h) { return ((Decoded*)h)->width; }
double avs_fps(void* h) { return ((Decoded*)h)->fps; }
int avs_n_samples(void* h) { return (int)((Decoded*)h)->audio.size(); }
int avs_sample_rate(void* h) { return ((Decoded*)h)->sample_rate; }
const uint8_t* avs_video_data(void* h) { return ((Decoded*)h)->video.data(); }
const float* avs_audio_data(void* h) { return ((Decoded*)h)->audio.data(); }
void avs_release(void* h) { delete (Decoded*)h; }

}  // extern "C"
