# Copied from av1tpu/media/probe.py.
"""Media probing: the ffprobe replacement.

Produces the same shapes the reference parses out of
``ffprobe -print_format json -show_streams -show_format``
(internal/metadata/probe.go:14-46): a FormatInfo, a list of StreamInfo, the
HasVideo/HasAV1 flags, the main-video-stream selection rule
(default-disposition else first, probe.go:186-196), and the scored source
classification (probe.go:199-201).

Container parsing is ours (av1tpu_torch.media.mkv / av1tpu_torch.media.mp4); no external
ffprobe process is ever spawned.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from av1tpu_torch.classify import WebSourceDecision, classify_web_source


def flexible_int(value) -> int:
    """String-or-number int shim (probe.go:49-82 FlexibleInt)."""
    if value is None:
        return 0
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if s == "":
        return 0
    return int(s)


@dataclasses.dataclass
class FormatInfo:
    """ffprobe ``format`` object subset (probe.go:25-31)."""

    format_name: str = ""
    duration: str = ""
    size: str = ""
    bit_rate: str = ""
    tags: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StreamInfo:
    """ffprobe ``streams[]`` object subset (probe.go:34-46)."""

    index: int = 0
    codec_name: str = ""
    codec_type: str = ""        # "video" | "audio" | "subtitle" | ...
    width: int = 0
    height: int = 0
    avg_frame_rate: str = ""
    r_frame_rate: str = ""
    bit_depth: int = 0          # bits_per_raw_sample
    bit_rate: str = ""
    disposition: dict = dataclasses.field(default_factory=dict)
    tags: dict = dataclasses.field(default_factory=dict)
    # --- extraction extras (not part of the ffprobe-shaped surface) ---
    codec_id: str = ""          # container-native codec id (e.g. "V_MPEG4/ISO/AVC")
    codec_private: bytes = b""  # codec init data (for stream copy)
    default_duration_ns: int = 0
    language: str = ""
    channels: int = 0
    sample_rate: float = 0.0
    # HDR/colour (ffprobe-shaped names + raw Colour payload passthrough)
    color_primaries: str = ""
    color_transfer: str = ""
    color_space: str = ""
    colour_raw: bytes = b""
    color_primaries_code: int = 0   # ISO/IEC 23001-8 code points
    color_transfer_code: int = 0
    color_matrix_code: int = 0


@dataclasses.dataclass
class ProbeResult:
    """Mirror of probe.go:14-22."""

    format: FormatInfo = dataclasses.field(default_factory=FormatInfo)
    streams: list[StreamInfo] = dataclasses.field(default_factory=list)
    has_video: bool = False
    has_av1: bool = False
    is_webrip_like: bool = False
    source_decision: Optional[WebSourceDecision] = None
    video_stream: Optional[StreamInfo] = None


def finalize_probe(file_path: str, result: ProbeResult) -> ProbeResult:
    """Stream analysis + classification (probe.go:167-202)."""
    result.has_video = False
    result.has_av1 = False
    video_streams = []
    for stream in result.streams:
        if stream.codec_type == "video":
            result.has_video = True
            video_streams.append(stream)
            if stream.codec_name == "av1":
                result.has_av1 = True
            if not stream.bit_depth:
                # derive bits_per_raw_sample from the codec init record
                # (avcC/hvcC/av1C/vpcC) the way ffprobe does — the HDR
                # gate and the job record (jobs.go:41) depend on it
                from av1tpu_torch.media import codecpriv
                stream.bit_depth = codecpriv.video_bit_depth(
                    stream.codec_name, stream.codec_id,
                    stream.codec_private)

    # Main video stream: default disposition else first (probe.go:186-196)
    result.video_stream = None
    for vs in video_streams:
        if vs.disposition and vs.disposition.get("default") == 1:
            result.video_stream = vs
            break
    if result.video_stream is None and video_streams:
        result.video_stream = video_streams[0]

    result.source_decision = classify_web_source(
        file_path, result.format, result.streams)
    result.is_webrip_like = result.source_decision.is_web_like()
    return result


class ProbeError(Exception):
    pass


def _probe_y4m(file_path: str) -> ProbeResult:
    from av1tpu_torch.media import y4m
    with open(file_path, "rb") as f:
        hdr = y4m.parse_header(f.readline(256))
    vs = StreamInfo(index=0, codec_type="video", codec_name="rawvideo",
                    width=hdr.width, height=hdr.height,
                    bit_depth=hdr.bit_depth,
                    avg_frame_rate=f"{hdr.fps_num}/{hdr.fps_den}")
    return ProbeResult(format=FormatInfo(format_name="yuv4mpegpipe"),
                       streams=[vs])


def probe_file(file_path: str) -> ProbeResult:
    """Probe a media file with our own demuxers (the ProbeFile analog).

    Dispatches on container magic: EBML (Matroska/WebM) or ISOBMFF (MP4/MOV).
    Raises ProbeError for unreadable/unrecognized files, which the scan
    pass reports as an "ffprobe failed" style skip (main.go:144-154).
    """
    try:
        with open(file_path, "rb") as f:
            head = f.read(12)
    except OSError as e:
        raise ProbeError(f"cannot read file: {e}") from e

    try:
        if head[:4] == b"\x1a\x45\xdf\xa3":  # EBML magic
            from av1tpu_torch.media import mkv
            result = mkv.probe(file_path)
        elif len(head) >= 8 and head[4:8] == b"ftyp":
            from av1tpu_torch.media import mp4
            result = mp4.probe(file_path)
        elif head[:4] == b"DKIF":  # IVF (raw AV1/VPx test container)
            from av1tpu_torch.media import ivf
            result = ivf.probe(file_path)
        elif head[:9] == b"YUV4MPEG2":  # uncompressed 8/10-bit source
            result = _probe_y4m(file_path)
        else:
            raise ProbeError("unrecognized container (not EBML/ISOBMFF/IVF)")
    except ProbeError:
        raise
    except Exception as e:
        # corrupt container internals must surface as a probe failure,
        # which the scan pass turns into a skip (main.go:144-154), not
        # a daemon crash
        raise ProbeError(f"container parse failed: {e}") from e

    try:
        result.format.size = str(os.path.getsize(file_path))
    except OSError:
        pass
    return finalize_probe(file_path, result)
