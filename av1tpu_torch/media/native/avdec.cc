// Copied from av1tpu/media/native/avdec.cc.
// Native source-video decoder: libavformat demux + libavcodec decode
// to planar I420 (8-bit) or I420 10-bit (uint16 LE) frames.
//
// This replaces the cv2.VideoCapture source path (engine_tpu.py
// iter_source_frames): cv2 rounds every frame through BGR at 8 bits,
// which (a) is lossy for the dominant yuv420p case and (b) cannot
// carry >8-bit mastering at all.  Decoding straight to YUV closes the
// compressed 10-bit/HDR source hole (the reference squeezed HDR10 HEVC
// through 8-bit nv12 — internal/ffmpeg/transcode.go:99-109 — which
// SURVEY SS2 flags as a defect; we decode it properly at 10 bits).
//
// C ABI only (ctypes consumer, no pybind11 in this image).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>

namespace {

struct AvDec {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *dec = nullptr;
  SwsContext *sws = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;      // decoder output
  AVFrame *conv = nullptr;       // converted output (when sws active)
  int stream_index = -1;
  int out_w = 0, out_h = 0;      // even-cropped output dims
  int out_bits = 8;              // 8 or 10 (output sample depth)
  AVPixelFormat out_fmt = AV_PIX_FMT_YUV420P;
  int64_t tb_num = 0, tb_den = 1;  // stream time_base
  bool draining = false;
  bool eof = false;
  char errbuf[256] = {0};
};

void set_err(AvDec *d, const char *msg, int averr = 0) {
  if (averr) {
    char ab[128];
    av_strerror(averr, ab, sizeof(ab));
    snprintf(d->errbuf, sizeof(d->errbuf), "%s: %s", msg, ab);
  } else {
    snprintf(d->errbuf, sizeof(d->errbuf), "%s", msg);
  }
}

}  // namespace

extern "C" {

// ctypes-called once at load: keep codec chatter out of daemon logs
void avdec_quiet(void) { av_log_set_level(AV_LOG_ERROR); }

AvDec *avdec_open(const char *path) {
  AvDec *d = new AvDec();
  int rc = avformat_open_input(&d->fmt, path, nullptr, nullptr);
  if (rc < 0) {
    set_err(d, "open_input failed", rc);
    return d;
  }
  rc = avformat_find_stream_info(d->fmt, nullptr);
  if (rc < 0) {
    set_err(d, "find_stream_info failed", rc);
    return d;
  }
  const AVCodec *codec = nullptr;
  rc = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (rc < 0 || !codec) {
    set_err(d, "no decodable video stream", rc < 0 ? rc : 0);
    return d;
  }
  d->stream_index = rc;
  AVStream *st = d->fmt->streams[d->stream_index];
  d->tb_num = st->time_base.num;
  d->tb_den = st->time_base.den ? st->time_base.den : 1;

  d->dec = avcodec_alloc_context3(codec);
  if (!d->dec || avcodec_parameters_to_context(d->dec, st->codecpar) < 0) {
    set_err(d, "codec context setup failed");
    return d;
  }
  d->dec->thread_count = 0;  // auto (1 on a 1-vCPU host; scales on real ones)
  rc = avcodec_open2(d->dec, codec, nullptr);
  if (rc < 0) {
    set_err(d, "avcodec_open2 failed", rc);
    return d;
  }
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  d->conv = av_frame_alloc();
  if (!d->pkt || !d->frame || !d->conv) {
    set_err(d, "alloc failed");
    return d;
  }
  // output geometry: even-dimension crop (reference policy
  // transcode.go:98: even dims for the encoder)
  d->out_w = d->dec->width & ~1;
  d->out_h = d->dec->height & ~1;
  if (d->out_w <= 0 || d->out_h <= 0) {
    set_err(d, "zero frame dimensions");
    return d;
  }
  const AVPixFmtDescriptor *desc = av_pix_fmt_desc_get(d->dec->pix_fmt);
  int depth = desc ? desc->comp[0].depth : 8;
  d->out_bits = depth > 8 ? 10 : 8;
  d->out_fmt = d->out_bits > 8 ? AV_PIX_FMT_YUV420P10LE : AV_PIX_FMT_YUV420P;
  return d;
}

const char *avdec_error(AvDec *d) { return d->errbuf[0] ? d->errbuf : nullptr; }
int avdec_width(AvDec *d) { return d->out_w; }
int avdec_height(AvDec *d) { return d->out_h; }
int avdec_bit_depth(AvDec *d) { return d->out_bits; }

double avdec_frame_rate(AvDec *d) {
  if (d->stream_index < 0) return 0.0;
  AVRational r = d->fmt->streams[d->stream_index]->avg_frame_rate;
  if (r.num <= 0 || r.den <= 0)
    r = d->fmt->streams[d->stream_index]->r_frame_rate;
  return (r.num > 0 && r.den > 0) ? (double)r.num / r.den : 0.0;
}

// Decode the next frame into caller-owned planar buffers.
//   y: out_h * out_w samples; u/v: (out_h/2) * (out_w/2) samples.
//   Samples are uint8 (out_bits == 8) or uint16 LE (out_bits == 10).
//   pts_ns receives the frame PTS in nanoseconds (INT64_MIN if unknown).
// Returns 1 on frame, 0 on EOF, -1 on error (see avdec_error).
int avdec_read(AvDec *d, uint8_t *y, uint8_t *u, uint8_t *v,
               int64_t *pts_ns) {
  if (d->errbuf[0]) return -1;
  if (d->eof) return 0;
  for (;;) {
    int rc = avcodec_receive_frame(d->dec, d->frame);
    if (rc == 0) break;
    if (rc == AVERROR_EOF) {
      d->eof = true;
      return 0;
    }
    if (rc != AVERROR(EAGAIN)) {
      set_err(d, "receive_frame failed", rc);
      return -1;
    }
    if (d->draining) continue;
    // feed the next packet of our stream
    for (;;) {
      rc = av_read_frame(d->fmt, d->pkt);
      if (rc == AVERROR_EOF) {
        avcodec_send_packet(d->dec, nullptr);
        d->draining = true;
        break;
      }
      if (rc < 0) {
        set_err(d, "read_frame failed", rc);
        return -1;
      }
      if (d->pkt->stream_index != d->stream_index) {
        av_packet_unref(d->pkt);
        continue;
      }
      rc = avcodec_send_packet(d->dec, d->pkt);
      av_packet_unref(d->pkt);
      if (rc < 0 && rc != AVERROR(EAGAIN)) {
        set_err(d, "send_packet failed", rc);
        return -1;
      }
      break;
    }
  }

  AVFrame *src = d->frame;
  AVFrame *out = src;
  if (src->format != d->out_fmt || src->width != d->out_w ||
      src->height != d->out_h) {
    // convert/crop to the target 4:2:0 format.  sws handles 422/444
    // chroma downsampling and high-bit-depth passthrough; the even
    // crop drops at most one source row/column.
    d->sws = sws_getCachedContext(
        d->sws, d->out_w, d->out_h, (AVPixelFormat)src->format,
        d->out_w, d->out_h, d->out_fmt, SWS_BILINEAR, nullptr, nullptr,
        nullptr);
    if (!d->sws) {
      set_err(d, "sws context failed");
      return -1;
    }
    d->conv->format = d->out_fmt;
    d->conv->width = d->out_w;
    d->conv->height = d->out_h;
    if (!d->conv->data[0]) {
      if (av_frame_get_buffer(d->conv, 0) < 0) {
        set_err(d, "conv frame alloc failed");
        return -1;
      }
    }
    sws_scale(d->sws, src->data, src->linesize, 0, d->out_h, d->conv->data,
              d->conv->linesize);
    out = d->conv;
  }

  const int bytes = d->out_bits > 8 ? 2 : 1;
  const int cw = d->out_w / 2, ch = d->out_h / 2;
  for (int r = 0; r < d->out_h; r++)
    memcpy(y + (size_t)r * d->out_w * bytes,
           out->data[0] + (size_t)r * out->linesize[0],
           (size_t)d->out_w * bytes);
  for (int r = 0; r < ch; r++) {
    memcpy(u + (size_t)r * cw * bytes,
           out->data[1] + (size_t)r * out->linesize[1], (size_t)cw * bytes);
    memcpy(v + (size_t)r * cw * bytes,
           out->data[2] + (size_t)r * out->linesize[2], (size_t)cw * bytes);
  }
  if (pts_ns) {
    int64_t pts = src->best_effort_timestamp;
    if (pts == AV_NOPTS_VALUE) {
      *pts_ns = INT64_MIN;
    } else {
      *pts_ns = (int64_t)(pts * (1000000000.0 * d->tb_num / d->tb_den));
    }
  }
  av_frame_unref(d->frame);
  return 1;
}

void avdec_close(AvDec *d) {
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->conv) av_frame_free(&d->conv);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->dec) avcodec_free_context(&d->dec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------------
// Test-fixture encoder (push I420 frames -> H.264/HEVC/... file).
//
// NOT part of the product encode path — the product encoder is the
// in-repo TPU spec-AV1 engine.  This exists so tests and tools can
// make realistic compressed *sources* (e.g. 10-bit HEVC for the
// BASELINE config #4 pipeline) without any ffmpeg binary.

namespace {

struct AvEnc {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *enc = nullptr;
  AVStream *st = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  int w = 0, h = 0, bits = 8;
  int64_t next_pts = 0;
  char errbuf[256] = {0};
};

void enc_set_err(AvEnc *e, const char *msg, int averr = 0) {
  if (averr) {
    char ab[128];
    av_strerror(averr, ab, sizeof(ab));
    snprintf(e->errbuf, sizeof(e->errbuf), "%s: %s", msg, ab);
  } else {
    snprintf(e->errbuf, sizeof(e->errbuf), "%s", msg);
  }
}

int enc_drain(AvEnc *e) {
  for (;;) {
    int rc = avcodec_receive_packet(e->enc, e->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) {
      enc_set_err(e, "receive_packet failed", rc);
      return -1;
    }
    av_packet_rescale_ts(e->pkt, e->enc->time_base, e->st->time_base);
    e->pkt->stream_index = e->st->index;
    rc = av_interleaved_write_frame(e->fmt, e->pkt);
    if (rc < 0) {
      enc_set_err(e, "write_frame failed", rc);
      return -1;
    }
  }
}

}  // namespace

AvEnc *avenc_open(const char *path, const char *codec_name, int w, int h,
                  int fps_num, int fps_den, int bit_depth, int crf) {
  AvEnc *e = new AvEnc();
  e->w = w;
  e->h = h;
  e->bits = bit_depth;
  const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) {
    enc_set_err(e, "encoder not found");
    return e;
  }
  int rc = avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
  if (rc < 0) {
    enc_set_err(e, "output context failed", rc);
    return e;
  }
  e->enc = avcodec_alloc_context3(codec);
  e->enc->width = w;
  e->enc->height = h;
  e->enc->time_base = {fps_den, fps_num};
  e->enc->framerate = {fps_num, fps_den};
  e->enc->pix_fmt =
      bit_depth > 8 ? AV_PIX_FMT_YUV420P10LE : AV_PIX_FMT_YUV420P;
  e->enc->gop_size = 50;
  e->enc->thread_count = 1;
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary *opts = nullptr;
  char crfbuf[16];
  snprintf(crfbuf, sizeof(crfbuf), "%d", crf);
  av_dict_set(&opts, "crf", crfbuf, 0);  // x264/x265 quality
  av_dict_set(&opts, "preset", "ultrafast", 0);
  av_dict_set(&opts, "x265-params", "log-level=none", 0);
  rc = avcodec_open2(e->enc, codec, &opts);
  av_dict_free(&opts);
  if (rc < 0) {
    enc_set_err(e, "avcodec_open2 failed", rc);
    return e;
  }
  e->st = avformat_new_stream(e->fmt, nullptr);
  avcodec_parameters_from_context(e->st->codecpar, e->enc);
  e->st->time_base = e->enc->time_base;
  if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
    rc = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE);
    if (rc < 0) {
      enc_set_err(e, "avio_open failed", rc);
      return e;
    }
  }
  rc = avformat_write_header(e->fmt, nullptr);
  if (rc < 0) {
    enc_set_err(e, "write_header failed", rc);
    return e;
  }
  e->pkt = av_packet_alloc();
  e->frame = av_frame_alloc();
  e->frame->format = e->enc->pix_fmt;
  e->frame->width = w;
  e->frame->height = h;
  if (av_frame_get_buffer(e->frame, 0) < 0) enc_set_err(e, "frame alloc");
  return e;
}

const char *avenc_error(AvEnc *e) { return e->errbuf[0] ? e->errbuf : nullptr; }

int avenc_write(AvEnc *e, const uint8_t *y, const uint8_t *u,
                const uint8_t *v) {
  if (e->errbuf[0]) return -1;
  const int bytes = e->bits > 8 ? 2 : 1;
  const int cw = e->w / 2, ch = e->h / 2;
  av_frame_make_writable(e->frame);
  for (int r = 0; r < e->h; r++)
    memcpy(e->frame->data[0] + (size_t)r * e->frame->linesize[0],
           y + (size_t)r * e->w * bytes, (size_t)e->w * bytes);
  for (int r = 0; r < ch; r++) {
    memcpy(e->frame->data[1] + (size_t)r * e->frame->linesize[1],
           u + (size_t)r * cw * bytes, (size_t)cw * bytes);
    memcpy(e->frame->data[2] + (size_t)r * e->frame->linesize[2],
           v + (size_t)r * cw * bytes, (size_t)cw * bytes);
  }
  e->frame->pts = e->next_pts++;
  int rc = avcodec_send_frame(e->enc, e->frame);
  if (rc < 0) {
    enc_set_err(e, "send_frame failed", rc);
    return -1;
  }
  return enc_drain(e);
}

int avenc_close(AvEnc *e) {
  if (!e) return 0;
  int ret = 0;
  if (!e->errbuf[0] && e->enc && e->fmt && e->pkt) {
    avcodec_send_frame(e->enc, nullptr);
    ret = enc_drain(e);
    if (av_write_trailer(e->fmt) < 0 && ret == 0) ret = -1;
  }
  if (e->frame) av_frame_free(&e->frame);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->enc) avcodec_free_context(&e->enc);
  if (e->fmt) {
    if (!(e->fmt->oformat->flags & AVFMT_NOFILE) && e->fmt->pb)
      avio_closep(&e->fmt->pb);
    avformat_free_context(e->fmt);
  }
  delete e;
  return ret;
}

}  // extern "C"
