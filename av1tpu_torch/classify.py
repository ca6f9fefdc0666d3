# Copied from av1tpu/classify.py.
"""Scored web/disc source classifier.

Semantics-exact rebuild of the reference classifier
(internal/metadata/probe.go:208-394): sidecar overrides, filename/directory
token scoring, container/extension scoring, muxer tags, VFR, odd dimensions,
aspect ratio, and bits-per-pixel — same weights, same thresholds (±2.0),
same reason strings, so the explainable sidecar output is byte-identical.

Operates on the probe-result shapes from :mod:`av1tpu_torch.media.probe` (which are
ffprobe-JSON-shaped, matching probe.go:25-46).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

SOURCE_UNKNOWN = "Unknown"
SOURCE_DISC_LIKE = "DiscLike"
SOURCE_WEB_LIKE = "WebLike"

WEB_TOKENS = ["web-dl", "webrip", "webhd", "webdl", "nf", "amzn", "dsnp",
              "hmax", "hulu", "atvp", "disney", "appletv"]
DISC_TOKENS = ["bluray", "bdrip", "brrip", "remux", "uhd", "bd25", "bd50",
               "blu-ray", "bd-remux", "bd remux", "bdr"]
WEB_MUXERS = ["shaka-packager", "libwebm", "applehttp", "dash", "hls", "ffmpeg"]
DISC_MUXERS = ["mkvmerge", "libmatroska", "makemkv", "tsmuxer"]


@dataclasses.dataclass
class WebSourceDecision:
    """Mirror of probe.go:106-110."""

    source_class: str = SOURCE_UNKNOWN
    score: float = 0.0
    reasons: list[str] = dataclasses.field(default_factory=list)

    def is_web_like(self) -> bool:
        """Unknown is treated conservatively as web-like (probe.go:114-116)."""
        return self.source_class in (SOURCE_WEB_LIKE, SOURCE_UNKNOWN)

    def __str__(self) -> str:
        return (f"{self.source_class} (score: {self.score:.1f}, "
                f"reasons: {'; '.join(self.reasons)})")


def classify_web_source(file_path: str, fmt, streams) -> WebSourceDecision:
    """Classify as WebLike / DiscLike / Unknown (probe.go:208-394).

    ``fmt`` must expose .format_name, .bit_rate, .tags; ``streams`` items
    expose .codec_type, .width, .height, .avg_frame_rate, .r_frame_rate
    (see av1tpu_torch.media.probe.FormatInfo / StreamInfo).
    """
    d = WebSourceDecision()

    file_name = os.path.basename(file_path).lower()
    dir_name = os.path.dirname(file_path).lower()
    ext = os.path.splitext(file_path)[1].lower()
    format_name = (fmt.format_name or "").lower()

    # Explicit sidecar overrides (probe.go:222-232)
    base_path = file_path[: len(file_path) - len(ext)] if ext else file_path
    if os.path.exists(base_path + ".websafe"):
        return WebSourceDecision(SOURCE_WEB_LIKE, 10.0,
                                 ["override: .websafe sidecar file"])
    if os.path.exists(base_path + ".nowebsafe"):
        return WebSourceDecision(SOURCE_DISC_LIKE, -10.0,
                                 ["override: .nowebsafe sidecar file"])

    # 1. Filename/folder tokens (probe.go:236-265)
    for token in WEB_TOKENS:
        if token in file_name:
            d.score += 3.0
            d.reasons.append(f"filename: contains '{token}'")
    for token in DISC_TOKENS:
        if token in file_name:
            d.score -= 4.0
            d.reasons.append(f"filename: contains '{token}'")
    for token in WEB_TOKENS:
        if token in dir_name:
            d.score += 1.0
            d.reasons.append(f"directory: contains '{token}'")
    for token in DISC_TOKENS:
        if token in dir_name:
            d.score -= 2.0
            d.reasons.append(f"directory: contains '{token}'")

    # 2. Container & muxing info (probe.go:269-311)
    if ext in (".mp4", ".mov", ".webm"):
        d.score += 2.0
        d.reasons.append(f"extension: {ext} (web container)")
    elif ext == ".mkv":
        d.score -= 1.0
        d.reasons.append("extension: .mkv (often disc remux)")

    if format_name in ("mov,mp4,m4a,3gp,3g2,mj2", "mp4", "mov"):
        d.score += 2.5
        d.reasons.append(f"format: {format_name} (web container)")
    elif format_name.startswith("webm") and "matroska" not in format_name:
        d.score += 2.5
        d.reasons.append(f"format: {format_name} (web container)")
    elif "matroska" in format_name:
        d.score -= 1.5
        d.reasons.append("format: matroska (often disc remux)")

    tags = fmt.tags or {}
    muxing_app = (tags.get("muxing_app") or "").lower()
    writing_lib = (tags.get("writing_library") or "").lower()
    for muxer in WEB_MUXERS:
        if muxer in muxing_app or muxer in writing_lib:
            d.score += 3.0
            d.reasons.append(f"muxer: {muxer} (web-leaning)")
    for muxer in DISC_MUXERS:
        if muxer in muxing_app or muxer in writing_lib:
            d.score -= 3.0
            d.reasons.append(f"muxer: {muxer} (disc-leaning)")

    # 3. Frame rate behavior: VFR is web-like, unless matroska (probe.go:314-328)
    for stream in streams:
        if stream.codec_type != "video":
            continue
        if stream.avg_frame_rate and stream.r_frame_rate:
            if stream.avg_frame_rate != stream.r_frame_rate:
                if "matroska" not in format_name:
                    d.score += 2.5
                    d.reasons.append(
                        f"video: VFR detected (avg={stream.avg_frame_rate}, "
                        f"r={stream.r_frame_rate})")
                break

    # 4. Dimensions & aspect ratio (probe.go:331-356)
    for stream in streams:
        if stream.codec_type != "video":
            continue
        if "matroska" not in format_name:
            if stream.width > 0 and stream.width % 2 != 0:
                d.score += 1.5
                d.reasons.append(f"video: odd width {stream.width}")
            if stream.height > 0 and stream.height % 2 != 0:
                d.score += 1.5
                d.reasons.append(f"video: odd height {stream.height}")
        if stream.width > 0 and stream.height > 0:
            ar = stream.width / stream.height
            if ar < 1.3 or ar > 2.5:
                d.score += 0.5
                d.reasons.append(f"video: unusual AR {ar:.2f}")

    # 5. Bitrate vs resolution (probe.go:359-380)
    if fmt.bit_rate:
        try:
            bitrate = float(fmt.bit_rate)
        except ValueError:
            bitrate = None
        if bitrate is not None:
            for stream in streams:
                if stream.codec_type == "video" and stream.height > 0:
                    bpp = bitrate / float(stream.width * stream.height)
                    if bpp < 0.1 and stream.height >= 1080:
                        d.score += 1.0
                        d.reasons.append(
                            f"bitrate: low for resolution ({bpp:.2f} bpp)")
                    elif bpp > 0.3 and stream.height >= 1080:
                        d.score -= 1.0
                        d.reasons.append(
                            f"bitrate: high for resolution ({bpp:.2f} bpp)")
                    break

    # Thresholds: >= +2.0 WebLike, <= -2.0 DiscLike, else Unknown (probe.go:384-391)
    if d.score >= 2.0:
        d.source_class = SOURCE_WEB_LIKE
    elif d.score <= -2.0:
        d.source_class = SOURCE_DISC_LIKE
    else:
        d.source_class = SOURCE_UNKNOWN
        d.reasons.append("ambiguous: score near zero")

    return d
