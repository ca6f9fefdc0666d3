# Copied from av1tpu/media/__init__.py (without obu, which the port
# does not use: the spec engine writes OBUs with specav1/obu.py).
"""Media layer: container demux/mux and probing (no external ffmpeg).

  probe      — ProbeFile analog producing ffprobe-JSON-shaped results
               (ref: internal/metadata/probe.go:14-46,125-204)
  ebml       — EBML primitive reader/writer (Matroska's encoding layer)
  mkv        — Matroska demuxer (probe + packet/stream extraction)
  mkv_mux    — Matroska muxer (V_AV1 video + copied audio/subs + chapters)
  mp4        — ISOBMFF/MP4 demuxer (probe + sample extraction)
  ivf        — IVF container for raw AV1 streams (test/bench format)
  y4m        — YUV4MPEG2 reader/writer (uncompressed 8/10-bit sources)
  codecpriv  — codec-private (avcC/hvcC/av1C) parsing for probe
  streamcopy — stream plan and output tracks of a transcode
  avdec      — native libavcodec source decode (ctypes)
"""
