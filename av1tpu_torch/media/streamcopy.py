# Copied from av1tpu/media/streamcopy.py.
"""Stream-copy planning and packet interleaving for transcode output.

Replicates the reference's ffmpeg stream-mapping semantics
(internal/ffmpeg/transcode.go:71-83): keep exactly the main video stream
(re-encoded as AV1), all audio streams except Russian-tagged ones
(languages "rus"/"ru"), all subtitle streams except Russian-tagged ones,
plus chapters and source metadata (``-map_chapters 0 -map_metadata 0``,
transcode.go:82,142).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Iterator, Optional

from av1tpu_torch.media.mkv import Packet, Track, TRACK_TYPE_AUDIO, TRACK_TYPE_SUBTITLE, TRACK_TYPE_VIDEO
from av1tpu_torch.media.probe import ProbeResult, StreamInfo

RUSSIAN_LANGS = ("rus", "ru")  # transcode.go:77-81


def is_russian(stream: StreamInfo) -> bool:
    lang = (stream.language or stream.tags.get("language") or "").lower()
    return lang in RUSSIAN_LANGS


@dataclasses.dataclass
class CopyPlan:
    """Which source streams ride along, and their output track numbers."""

    video_stream: StreamInfo                 # re-encoded, output track 1
    copied: list[StreamInfo]                 # stream-copied, tracks 2..N
    output_number: dict[int, int]            # source stream index -> out track
    dropped: list[StreamInfo]                # pruned (Russian) streams


def plan_streams(pr: ProbeResult) -> CopyPlan:
    """Build the output mapping from a probe result.

    Main video selection follows probe.go:186-196 (already resolved into
    pr.video_stream); audio/subtitle pruning follows transcode.go:71-83.
    """
    if pr.video_stream is None:
        raise ValueError("no video stream found in probe result")
    copied: list[StreamInfo] = []
    dropped: list[StreamInfo] = []
    for s in pr.streams:
        if s.codec_type not in ("audio", "subtitle"):
            continue  # attachments/data dropped (-map -0:t)
        if is_russian(s):
            dropped.append(s)
            continue
        copied.append(s)
    numbering = {pr.video_stream.index: 1}
    for i, s in enumerate(copied):
        numbering[s.index] = 2 + i
    return CopyPlan(video_stream=pr.video_stream, copied=copied,
                    output_number=numbering, dropped=dropped)


def _mkv_track_type(codec_type: str) -> int:
    return {"video": TRACK_TYPE_VIDEO, "audio": TRACK_TYPE_AUDIO,
            "subtitle": TRACK_TYPE_SUBTITLE}.get(codec_type, 0)


def output_tracks(plan: CopyPlan, width: int, height: int,
                  default_duration_ns: int,
                  mkv_codec_id_for: Optional[dict] = None) -> list[Track]:
    """Materialize the MkvWriter track list: AV1 video + copied tracks.

    ``mkv_codec_id_for`` maps source stream index → Matroska CodecID for
    containers whose native ids differ (MP4 fourccs); Matroska sources
    carry their CodecID through ``StreamInfo.codec_id``.
    """
    from av1tpu_torch.media.mp4 import NAME_TO_MKV_CODEC_ID
    tracks = [Track(number=1, track_type=TRACK_TYPE_VIDEO, codec_id="V_AV1",
                    width=width, height=height,
                    default_duration_ns=default_duration_ns,
                    # HDR/colour metadata survives the re-encode: the
                    # source's Colour element is re-emitted verbatim on
                    # the AV1 track (transcode.go:140-145 map_metadata
                    # analog for video colour)
                    colour_raw=getattr(plan.video_stream, "colour_raw",
                                       b""))]
    for s in plan.copied:
        codec_id = None
        if mkv_codec_id_for:
            codec_id = mkv_codec_id_for.get(s.index)
        if not codec_id:
            cid = s.codec_id or ""
            if cid.startswith(("V_", "A_", "S_")):
                codec_id = cid
            else:
                codec_id = NAME_TO_MKV_CODEC_ID.get(s.codec_name)
        if not codec_id:
            codec_id = "A_MS/ACM" if s.codec_type == "audio" else "S_TEXT/UTF8"
        tracks.append(Track(
            number=plan.output_number[s.index],
            track_type=_mkv_track_type(s.codec_type),
            codec_id=codec_id,
            codec_private=s.codec_private,
            language=s.language or s.tags.get("language", ""),
            default_duration_ns=s.default_duration_ns,
            sample_rate=s.sample_rate,
            channels=s.channels,
        ))
    return tracks


def interleave(*packet_iters: Iterable[Packet]) -> Iterator[Packet]:
    """Merge per-track packet streams into non-decreasing timestamp order."""
    heap = []
    iters = [iter(it) for it in packet_iters]
    for i, it in enumerate(iters):
        try:
            pkt = next(it)
            heap.append((pkt.timestamp_ns, i, pkt))
        except StopIteration:
            pass
    heapq.heapify(heap)
    while heap:
        _ts, i, pkt = heapq.heappop(heap)
        yield pkt
        try:
            nxt = next(iters[i])
            heapq.heappush(heap, (nxt.timestamp_ns, i, nxt))
        except StopIteration:
            pass
