# Copied from av1tpu/media/mkv_mux.py.
"""Matroska muxer: AV1 video (V_AV1) plus copied audio/subtitle tracks.

The write-side counterpart of av1tpu_torch.media.mkv, replacing the reference's
``-f matroska`` ffmpeg mux (transcode.go:140-145).  Emits: EBML header,
SeekHead, Info (duration patched at finalize), Tracks, optional raw
Chapters/Tags pass-through, Clusters of SimpleBlocks (BlockGroup with
BlockDuration for subtitles), and Cues indexing video keyframe clusters.

Callers feed packets in non-decreasing timestamp order (the stream-copy
pipeline interleaves by timestamp).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

from av1tpu_torch.media import ebml
from av1tpu_torch.media.mkv import (AUDIO, AUDIO_BIT_DEPTH, BLOCK, BLOCK_DURATION,
                              BLOCK_GROUP, CHANNELS, CHAPTERS, CLUSTER,
                              CLUSTER_TIMESTAMP, CODEC_ID, CODEC_PRIVATE,
                              CUES, DEFAULT_DURATION, DURATION, EBML_HEADER,
                              FLAG_DEFAULT, FLAG_FORCED, FLAG_LACING, INFO,
                              LANGUAGE, MUXING_APP, PIXEL_HEIGHT, PIXEL_WIDTH,
                              SAMPLING_FREQUENCY, SEEKHEAD, SEGMENT,
                              SIMPLE_BLOCK, TAGS, TIMESTAMP_SCALE,
                              TRACK_ENTRY, TRACK_NUMBER, TRACK_TYPE,
                              TRACK_TYPE_SUBTITLE, TRACK_TYPE_VIDEO,
                              TRACK_UID, TRACKS, VIDEO, VOID, WRITING_APP,
                              Packet, Track)

SEEK = 0x4DBB
SEEK_ID = 0x53AB
SEEK_POSITION = 0x53AC
CUE_POINT = 0xBB
CUE_TIME = 0xB3
CUE_TRACK_POSITIONS = 0xB7
CUE_TRACK = 0xF7
CUE_CLUSTER_POSITION = 0xF1

APP_NAME = "av1tpu"

# SimpleBlock relative timestamps are int16 in timestamp-scale units; keep
# clusters comfortably inside that and bounded in duration.
MAX_CLUSTER_UNITS = 30000


def _ebml_header(doctype: str = "matroska") -> bytes:
    return ebml.master(
        EBML_HEADER,
        ebml.uint_el(0x4286, 1),   # EBMLVersion
        ebml.uint_el(0x42F7, 1),   # EBMLReadVersion
        ebml.uint_el(0x42F2, 4),   # EBMLMaxIDLength
        ebml.uint_el(0x42F3, 8),   # EBMLMaxSizeLength
        ebml.string_el(0x4282, doctype),
        ebml.uint_el(0x4287, 4),   # DocTypeVersion
        ebml.uint_el(0x4285, 2),   # DocTypeReadVersion
    )


def _track_entry(t: Track) -> bytes:
    children = [
        ebml.uint_el(TRACK_NUMBER, t.number),
        ebml.uint_el(TRACK_UID, t.uid or t.number),
        ebml.uint_el(TRACK_TYPE, t.track_type),
        ebml.uint_el(FLAG_DEFAULT, 1 if t.flag_default else 0),
        ebml.uint_el(FLAG_FORCED, 1 if t.flag_forced else 0),
        ebml.uint_el(FLAG_LACING, 0),
    ]
    if t.language:
        children.append(ebml.string_el(LANGUAGE, t.language))
    children.append(ebml.string_el(CODEC_ID, t.codec_id))
    if t.default_duration_ns:
        children.append(ebml.uint_el(DEFAULT_DURATION, t.default_duration_ns))
    if t.codec_private:
        children.append(ebml.binary_el(CODEC_PRIVATE, t.codec_private))
    if t.track_type == TRACK_TYPE_VIDEO:
        video_parts = [ebml.uint_el(PIXEL_WIDTH, t.width),
                       ebml.uint_el(PIXEL_HEIGHT, t.height)]
        if getattr(t, "colour_raw", b""):
            # lossless HDR/colour passthrough: re-emit the source's
            # Colour element verbatim (primaries/transfer/matrix,
            # MaxCLL/MaxFALL, mastering display metadata)
            from av1tpu_torch.media.mkv import COLOUR
            video_parts.append(ebml.encode_id(COLOUR)
                               + ebml.encode_size(len(t.colour_raw))
                               + t.colour_raw)
        children.append(ebml.master(VIDEO, *video_parts))
    elif t.sample_rate or t.channels:
        audio = [ebml.float_el(SAMPLING_FREQUENCY, t.sample_rate or 48000.0),
                 ebml.uint_el(CHANNELS, t.channels or 2)]
        if t.audio_bit_depth:
            audio.append(ebml.uint_el(AUDIO_BIT_DEPTH, t.audio_bit_depth))
        children.append(ebml.master(AUDIO, *audio))
    return ebml.master(TRACK_ENTRY, *children)


class MkvWriter:
    """Streaming Matroska writer over a seekable binary file."""

    def __init__(self, f: BinaryIO, tracks: list[Track],
                 timestamp_scale: int = 1_000_000,
                 writing_app: str = APP_NAME,
                 chapters_payload: bytes = b"",
                 tags_payload: bytes = b""):
        self.f = f
        self.tracks = tracks
        self.scale = timestamp_scale
        self._cluster_ts: Optional[int] = None   # units
        self._cluster_start: Optional[int] = None
        self._cluster_size_pos: Optional[int] = None
        self._cues: list[tuple[int, int, int]] = []  # (time_units, track, cluster_rel_pos)
        self._video_track_numbers = {
            t.number for t in tracks if t.track_type == TRACK_TYPE_VIDEO}
        self._max_ts_units = 0

        f.write(_ebml_header())
        f.write(ebml.encode_id(SEGMENT))
        self._segment_size_pos = f.tell()
        f.write(ebml.encode_size(None))  # 8-byte unknown, patched at finalize
        self._segment_payload_start = f.tell()

        # SeekHead placeholder: fixed-size area patched at finalize (3 seeks)
        self._seekhead_pos = f.tell()
        f.write(self._seekhead_bytes(0, 0, 0))

        # Info with duration placeholder (8-byte float)
        self._info_pos = f.tell()
        info = ebml.master(
            INFO,
            ebml.uint_el(TIMESTAMP_SCALE, timestamp_scale),
            ebml.string_el(MUXING_APP, APP_NAME),
            ebml.string_el(WRITING_APP, writing_app),
            ebml.binary_el(DURATION, struct.pack(">d", 0.0)),
        )
        self._duration_payload_off = self._info_pos + len(info) - 8
        f.write(info)

        self._tracks_pos = f.tell()
        f.write(ebml.master(TRACKS, *[_track_entry(t) for t in tracks]))
        if chapters_payload:
            f.write(ebml.binary_el(CHAPTERS, chapters_payload))
        if tags_payload:
            f.write(ebml.binary_el(TAGS, tags_payload))
        self._cues_pos: Optional[int] = None

    # -- seekhead ----------------------------------------------------------
    def _seekhead_bytes(self, info_pos: int, tracks_pos: int,
                        cues_pos: int) -> bytes:
        def seek(target_id: int, pos: int) -> bytes:
            return ebml.master(
                SEEK,
                ebml.binary_el(SEEK_ID, ebml.encode_id(target_id)),
                ebml.binary_el(SEEK_POSITION, pos.to_bytes(8, "big")),
            )
        body = (seek(INFO, info_pos) + seek(TRACKS, tracks_pos)
                + seek(CUES, cues_pos))
        return ebml.master(SEEKHEAD, body)

    # -- clusters ----------------------------------------------------------
    def _close_cluster(self) -> None:
        if self._cluster_start is None:
            return
        end = self.f.tell()
        size = end - (self._cluster_size_pos + 8)
        self.f.seek(self._cluster_size_pos)
        self.f.write(ebml.encode_size(size, length=8))
        self.f.seek(end)
        self._cluster_start = None

    def _open_cluster(self, ts_units: int) -> None:
        self._close_cluster()
        self._cluster_start = self.f.tell()
        self.f.write(ebml.encode_id(CLUSTER))
        self._cluster_size_pos = self.f.tell()
        self.f.write(ebml.encode_size(None))  # patched in _close_cluster
        self.f.write(ebml.uint_el(CLUSTER_TIMESTAMP, ts_units))
        self._cluster_ts = ts_units

    def write_packet(self, pkt: Packet) -> None:
        ts_units = pkt.timestamp_ns // self.scale
        self._max_ts_units = max(self._max_ts_units, ts_units)
        is_video = pkt.track_number in self._video_track_numbers
        need_new = (
            self._cluster_start is None
            or ts_units - self._cluster_ts > MAX_CLUSTER_UNITS
            or ts_units < self._cluster_ts
            or (is_video and pkt.keyframe
                and ts_units - self._cluster_ts > 1000)
        )
        if need_new:
            self._open_cluster(ts_units)
            if is_video and pkt.keyframe:
                self._cues.append((
                    ts_units, pkt.track_number,
                    self._cluster_start - self._segment_payload_start))

        rel = ts_units - self._cluster_ts
        track_vint = ebml.encode_size(pkt.track_number)  # same encoding as size vint
        header = (track_vint + rel.to_bytes(2, "big", signed=True))
        is_sub = False
        for t in self.tracks:
            if t.number == pkt.track_number:
                is_sub = t.track_type == TRACK_TYPE_SUBTITLE
                break
        if is_sub and pkt.duration_ns > 0:
            block = ebml.binary_el(BLOCK, header + b"\x00" + pkt.data)
            dur = ebml.uint_el(BLOCK_DURATION, pkt.duration_ns // self.scale)
            self.f.write(ebml.master(BLOCK_GROUP, block + dur))
        else:
            flags = 0x80 if pkt.keyframe else 0x00
            self.f.write(ebml.binary_el(
                SIMPLE_BLOCK, header + bytes([flags]) + pkt.data))

    # -- finalize ----------------------------------------------------------
    def finalize(self, duration_seconds: Optional[float] = None) -> None:
        self._close_cluster()
        # Cues
        cues_pos = self.f.tell()
        points = []
        for time_units, track, cluster_pos in self._cues:
            points.append(ebml.master(
                CUE_POINT,
                ebml.uint_el(CUE_TIME, time_units),
                ebml.master(
                    CUE_TRACK_POSITIONS,
                    ebml.uint_el(CUE_TRACK, track),
                    ebml.uint_el(CUE_CLUSTER_POSITION, cluster_pos),
                ),
            ))
        self.f.write(ebml.master(CUES, *points))
        segment_end = self.f.tell()

        # Patch segment size
        self.f.seek(self._segment_size_pos)
        self.f.write(ebml.encode_size(
            segment_end - self._segment_payload_start, length=8))
        # Patch seekhead
        self.f.seek(self._seekhead_pos)
        self.f.write(self._seekhead_bytes(
            self._info_pos - self._segment_payload_start,
            self._tracks_pos - self._segment_payload_start,
            cues_pos - self._segment_payload_start))
        # Patch duration
        if duration_seconds is None:
            duration_seconds = self._max_ts_units * self.scale / 1e9
        self.f.seek(self._duration_payload_off)
        self.f.write(struct.pack(">d", duration_seconds * 1e9 / self.scale))
        self.f.seek(segment_end)
        self.f.flush()
