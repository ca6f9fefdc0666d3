# Copied from av1tpu/media/mkv.py.
"""Matroska/WebM demuxer: probe metadata + packet extraction.

Produces ffprobe-JSON-shaped ProbeResults (what internal/metadata/probe.go
parses) and iterates packets for stream copy.  Handles SimpleBlock and
BlockGroup/Block with all three lacing modes, unknown-size Segments and
Clusters (streamed files), and raw pass-through of Chapters/Tags payloads
for the muxer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import BinaryIO, Iterator, Optional

from av1tpu_torch.media import ebml
from av1tpu_torch.media.probe import FormatInfo, ProbeResult, StreamInfo

# --- element IDs (Matroska spec) ---
EBML_HEADER = 0x1A45DFA3
DOCTYPE = 0x4282
SEGMENT = 0x18538067
SEEKHEAD = 0x114D9B74
INFO = 0x1549A966
TIMESTAMP_SCALE = 0x2AD7B1
MUXING_APP = 0x4D80
WRITING_APP = 0x5741
DURATION = 0x4489
TITLE = 0x7BA9
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
FLAG_DEFAULT = 0x88
FLAG_FORCED = 0x55AA
FLAG_LACING = 0x9C
DEFAULT_DURATION = 0x23E383
NAME = 0x536E
LANGUAGE = 0x22B59C
LANGUAGE_IETF = 0x22B59D
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
COLOUR = 0x55B0              # HDR/colour metadata (passthrough)
COLOUR_MATRIX = 0x55B1
COLOUR_TRANSFER = 0x55BA
COLOUR_PRIMARIES = 0x55BB
AUDIO = 0xE1
SAMPLING_FREQUENCY = 0xB5
CHANNELS = 0x9F
AUDIO_BIT_DEPTH = 0x6264
CLUSTER = 0x1F43B675
CLUSTER_TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
BLOCK_DURATION = 0x9B
REFERENCE_BLOCK = 0xFB
CUES = 0x1C53BB6B
CHAPTERS = 0x1043A770
TAGS = 0x1254C367
ATTACHMENTS = 0x1941A469
VOID = 0xEC

TRACK_TYPE_VIDEO = 1
TRACK_TYPE_AUDIO = 2
TRACK_TYPE_SUBTITLE = 17

# Matroska CodecID → ffprobe codec_name (subset the daemon/classifier uses)
CODEC_ID_TO_NAME = {
    "V_MPEG4/ISO/AVC": "h264",
    "V_MPEGH/ISO/HEVC": "hevc",
    "V_AV1": "av1",
    "V_VP9": "vp9",
    "V_VP8": "vp8",
    "V_MPEG2": "mpeg2video",
    "V_MPEG1": "mpeg1video",
    "V_MS/VFW/FOURCC": "msvideo",
    "A_AAC": "aac",
    "A_AC3": "ac3",
    "A_EAC3": "eac3",
    "A_DTS": "dts",
    "A_TRUEHD": "truehd",
    "A_MLP": "mlp",
    "A_FLAC": "flac",
    "A_OPUS": "opus",
    "A_VORBIS": "vorbis",
    "A_MPEG/L3": "mp3",
    "A_MPEG/L2": "mp2",
    "A_PCM/INT/LIT": "pcm_s16le",
    "S_TEXT/UTF8": "subrip",
    "S_TEXT/ASS": "ass",
    "S_TEXT/SSA": "ssa",
    "S_HDMV/PGS": "hdmv_pgs_subtitle",
    "S_VOBSUB": "dvd_subtitle",
    "S_TEXT/WEBVTT": "webvtt",
}


class MkvError(Exception):
    pass


@dataclasses.dataclass
class Track:
    number: int = 0
    uid: int = 0
    track_type: int = 0
    codec_id: str = ""
    codec_private: bytes = b""
    default_duration_ns: int = 0
    language: str = ""
    name: str = ""
    flag_default: int = 1
    flag_forced: int = 0
    width: int = 0
    height: int = 0
    sample_rate: float = 0.0
    channels: int = 0
    audio_bit_depth: int = 0
    # HDR/colour metadata: full Colour element payload for lossless
    # passthrough, plus the three code points probe surfaces
    colour_raw: bytes = b""
    color_primaries: int = 0   # ISO/IEC 23001-8 code points
    color_transfer: int = 0
    color_matrix: int = 0

    @property
    def codec_type(self) -> str:
        return {TRACK_TYPE_VIDEO: "video", TRACK_TYPE_AUDIO: "audio",
                TRACK_TYPE_SUBTITLE: "subtitle"}.get(self.track_type, "data")


@dataclasses.dataclass
class Packet:
    track_number: int
    timestamp_ns: int
    data: bytes
    keyframe: bool = False
    duration_ns: int = 0


@dataclasses.dataclass
class MkvFile:
    doctype: str = "matroska"
    timestamp_scale: int = 1_000_000
    duration_units: float = 0.0      # in timestamp-scale units
    muxing_app: str = ""
    writing_app: str = ""
    title: str = ""
    tracks: list[Track] = dataclasses.field(default_factory=list)
    chapters_payload: bytes = b""    # raw Chapters payload for pass-through
    tags_payload: bytes = b""        # raw Tags payload for pass-through
    segment_payload_start: int = 0
    segment_end: Optional[int] = None
    first_cluster_offset: Optional[int] = None

    @property
    def duration_seconds(self) -> float:
        return self.duration_units * self.timestamp_scale / 1e9

    def track_by_number(self, number: int) -> Optional[Track]:
        for t in self.tracks:
            if t.number == number:
                return t
        return None


def _parse_track_entry(f: BinaryIO, end: int) -> Track:
    t = Track()
    for el in ebml.iter_elements(f, end):
        if el.id == TRACK_NUMBER:
            t.number = ebml.decode_uint(ebml.read_payload(f, el))
        elif el.id == TRACK_UID:
            t.uid = ebml.decode_uint(ebml.read_payload(f, el))
        elif el.id == TRACK_TYPE:
            t.track_type = ebml.decode_uint(ebml.read_payload(f, el))
        elif el.id == CODEC_ID:
            t.codec_id = ebml.decode_string(ebml.read_payload(f, el))
        elif el.id == CODEC_PRIVATE:
            t.codec_private = ebml.read_payload(f, el)
        elif el.id == DEFAULT_DURATION:
            t.default_duration_ns = ebml.decode_uint(ebml.read_payload(f, el))
        elif el.id == LANGUAGE:
            t.language = ebml.decode_string(ebml.read_payload(f, el))
        elif el.id == LANGUAGE_IETF:
            lang = ebml.decode_string(ebml.read_payload(f, el))
            if lang:
                t.language = lang
        elif el.id == NAME:
            t.name = ebml.decode_string(ebml.read_payload(f, el))
        elif el.id == FLAG_DEFAULT:
            t.flag_default = ebml.decode_uint(ebml.read_payload(f, el))
        elif el.id == FLAG_FORCED:
            t.flag_forced = ebml.decode_uint(ebml.read_payload(f, el))
        elif el.id == VIDEO:
            vid_end = el.payload_offset + (el.size or 0)
            f.seek(el.payload_offset)
            for sub in ebml.iter_elements(f, vid_end):
                if sub.id == PIXEL_WIDTH:
                    t.width = ebml.decode_uint(ebml.read_payload(f, sub))
                elif sub.id == PIXEL_HEIGHT:
                    t.height = ebml.decode_uint(ebml.read_payload(f, sub))
                elif sub.id == COLOUR:
                    t.colour_raw = ebml.read_payload(f, sub)
                    import io as _io
                    cf = _io.BytesIO(t.colour_raw)
                    for c in ebml.iter_elements(cf, len(t.colour_raw)):
                        if c.id == COLOUR_PRIMARIES:
                            t.color_primaries = ebml.decode_uint(
                                ebml.read_payload(cf, c))
                        elif c.id == COLOUR_TRANSFER:
                            t.color_transfer = ebml.decode_uint(
                                ebml.read_payload(cf, c))
                        elif c.id == COLOUR_MATRIX:
                            t.color_matrix = ebml.decode_uint(
                                ebml.read_payload(cf, c))
        elif el.id == AUDIO:
            aud_end = el.payload_offset + (el.size or 0)
            f.seek(el.payload_offset)
            for sub in ebml.iter_elements(f, aud_end):
                if sub.id == SAMPLING_FREQUENCY:
                    t.sample_rate = ebml.decode_float(ebml.read_payload(f, sub))
                elif sub.id == CHANNELS:
                    t.channels = ebml.decode_uint(ebml.read_payload(f, sub))
                elif sub.id == AUDIO_BIT_DEPTH:
                    t.audio_bit_depth = ebml.decode_uint(ebml.read_payload(f, sub))
    return t


def parse(f: BinaryIO) -> MkvFile:
    """Parse headers up to (not through) the clusters."""
    f.seek(0)
    mkv = MkvFile()
    # EBML header
    top = ebml.iter_elements(f, None)
    try:
        header = next(top)
    except StopIteration:
        raise MkvError("empty file")
    if header.id != EBML_HEADER:
        raise MkvError("not an EBML file")
    hdr_end = header.payload_offset + (header.size or 0)
    f.seek(header.payload_offset)
    for el in ebml.iter_elements(f, hdr_end):
        if el.id == DOCTYPE:
            mkv.doctype = ebml.decode_string(ebml.read_payload(f, el))
    f.seek(hdr_end)

    # Segment
    try:
        seg = next(ebml.iter_elements(f, None))
    except StopIteration:
        raise MkvError("no Segment element")
    if seg.id != SEGMENT:
        raise MkvError(f"expected Segment, got id 0x{seg.id:X}")
    mkv.segment_payload_start = seg.payload_offset
    mkv.segment_end = (None if seg.size is None
                       else seg.payload_offset + seg.size)

    f.seek(seg.payload_offset)
    for el in ebml.iter_elements(f, mkv.segment_end):
        if el.id == CLUSTER:
            mkv.first_cluster_offset = el.offset
            break  # header elements before clusters parsed; stop here
        if el.size is None:
            break
        if el.id == INFO:
            info_end = el.payload_offset + el.size
            f.seek(el.payload_offset)
            for sub in ebml.iter_elements(f, info_end):
                if sub.id == TIMESTAMP_SCALE:
                    mkv.timestamp_scale = ebml.decode_uint(
                        ebml.read_payload(f, sub))
                elif sub.id == DURATION:
                    mkv.duration_units = ebml.decode_float(
                        ebml.read_payload(f, sub))
                elif sub.id == MUXING_APP:
                    mkv.muxing_app = ebml.decode_string(
                        ebml.read_payload(f, sub))
                elif sub.id == WRITING_APP:
                    mkv.writing_app = ebml.decode_string(
                        ebml.read_payload(f, sub))
                elif sub.id == TITLE:
                    mkv.title = ebml.decode_string(ebml.read_payload(f, sub))
            f.seek(info_end)
        elif el.id == TRACKS:
            tracks_end = el.payload_offset + el.size
            f.seek(el.payload_offset)
            for sub in ebml.iter_elements(f, tracks_end):
                if sub.id == TRACK_ENTRY and sub.size is not None:
                    entry_end = sub.payload_offset + sub.size
                    f.seek(sub.payload_offset)
                    mkv.tracks.append(_parse_track_entry(f, entry_end))
                    f.seek(entry_end)
            f.seek(tracks_end)
        elif el.id == CHAPTERS:
            mkv.chapters_payload = ebml.read_payload(f, el)
        elif el.id == TAGS:
            mkv.tags_payload = ebml.read_payload(f, el)
    return mkv


def _read_block(payload: bytes, cluster_ts: int, scale: int,
                is_simple: bool, duration_units: int = 0):
    """Decode a (Simple)Block payload into packets (handles lacing)."""
    import io
    bio = io.BytesIO(payload)
    track_num, _, _ = ebml.read_vint_raw(bio)
    rel = int.from_bytes(bio.read(2), "big", signed=True)
    flags = bio.read(1)[0]
    keyframe = bool(flags & 0x80) if is_simple else True
    lacing = (flags >> 1) & 0x3
    ts_ns = (cluster_ts + rel) * scale
    dur_ns = duration_units * scale

    if lacing == 0:
        return [Packet(track_num, ts_ns, payload[bio.tell():], keyframe, dur_ns)]

    n_frames = bio.read(1)[0] + 1
    sizes: list[int] = []
    if lacing == 2:  # fixed-size
        remaining = len(payload) - bio.tell()
        size = remaining // n_frames
        sizes = [size] * n_frames
    elif lacing == 1:  # Xiph
        for _ in range(n_frames - 1):
            s = 0
            while True:
                b = bio.read(1)[0]
                s += b
                if b != 255:
                    break
            sizes.append(s)
        sizes.append(len(payload) - bio.tell() - sum(sizes))
    else:  # EBML lacing
        first, _, _ = ebml.read_vint_raw(bio)
        sizes.append(first)
        prev = first
        for _ in range(n_frames - 2):
            raw, length, _ = ebml.read_vint_raw(bio)
            # signed vint: subtract bias
            delta = raw - ((1 << (7 * length - 1)) - 1)
            prev = prev + delta
            sizes.append(prev)
        sizes.append(len(payload) - bio.tell() - sum(sizes))

    packets = []
    pos = bio.tell()
    per_frame = dur_ns // n_frames if dur_ns else 0
    for i, s in enumerate(sizes):
        packets.append(Packet(track_num, ts_ns + i * per_frame,
                              payload[pos:pos + s], keyframe, per_frame))
        pos += s
    return packets


def iter_packets(f: BinaryIO, mkv: MkvFile) -> Iterator[Packet]:
    """Iterate all packets in cluster order."""
    if mkv.first_cluster_offset is None:
        return
    f.seek(mkv.first_cluster_offset)
    scale = mkv.timestamp_scale
    while True:
        pos = f.tell()
        if mkv.segment_end is not None and pos >= mkv.segment_end:
            return
        try:
            el_id = ebml.read_element_id(f)
            size = ebml.read_size(f)
        except EOFError:
            return
        payload_offset = f.tell()
        if el_id != CLUSTER:
            if size is None:
                return
            f.seek(payload_offset + size)
            continue
        cluster_end = None if size is None else payload_offset + size
        cluster_ts = 0
        # iterate cluster children; unknown-size cluster ends at next cluster id
        while True:
            cpos = f.tell()
            if cluster_end is not None and cpos >= cluster_end:
                break
            try:
                cid = ebml.read_element_id(f)
                csize = ebml.read_size(f)
            except EOFError:
                return
            if cid in (CLUSTER, SEGMENT):  # unknown-size cluster terminated
                f.seek(cpos)
                break
            if csize is None:
                return
            cpayload = f.tell()
            if cid == CLUSTER_TIMESTAMP:
                cluster_ts = ebml.decode_uint(f.read(csize))
            elif cid == SIMPLE_BLOCK:
                yield from _read_block(f.read(csize), cluster_ts, scale, True)
            elif cid == BLOCK_GROUP:
                group_end = cpayload + csize
                block_payload = b""
                dur_units = 0
                has_ref = False
                for sub in ebml.iter_elements(f, group_end):
                    if sub.id == BLOCK:
                        block_payload = ebml.read_payload(f, sub)
                    elif sub.id == BLOCK_DURATION:
                        dur_units = ebml.decode_uint(ebml.read_payload(f, sub))
                    elif sub.id == REFERENCE_BLOCK:
                        has_ref = True
                f.seek(group_end)
                if block_payload:
                    pkts = _read_block(block_payload, cluster_ts, scale,
                                       False, dur_units)
                    for p in pkts:
                        p.keyframe = not has_ref
                        yield p
                continue
            f.seek(cpayload + csize)


# ---------------------------------------------------------------------------
# probe surface

def _frame_rate_str(default_duration_ns: int) -> str:
    """DefaultDuration → rational fps string like ffprobe ("24000/1001")."""
    if default_duration_ns <= 0:
        return ""
    fps = 1e9 / default_duration_ns
    # snap to common broadcast rates
    for num, den in ((24000, 1001), (30000, 1001), (60000, 1001),
                     (24, 1), (25, 1), (30, 1), (50, 1), (60, 1),
                     (120, 1), (15, 1), (12, 1), (10, 1)):
        if abs(fps - num / den) < 0.01:
            return f"{num}/{den}"
    frac = round(fps * 1000)
    g = math.gcd(frac, 1000)
    return f"{frac // g}/{1000 // g}"


def to_probe_result(mkv: MkvFile, total_size: int = 0) -> ProbeResult:
    fmt = FormatInfo(format_name="matroska,webm")
    dur = mkv.duration_seconds
    if dur > 0:
        fmt.duration = f"{dur:.6f}"
        if total_size > 0:
            fmt.bit_rate = str(int(total_size * 8 / dur))
    tags = {}
    if mkv.muxing_app:
        tags["muxing_app"] = mkv.muxing_app
    if mkv.writing_app:
        tags["writing_library"] = mkv.muxing_app
        tags["encoder"] = mkv.writing_app
    if mkv.title:
        tags["title"] = mkv.title
    fmt.tags = tags

    streams = []
    for i, t in enumerate(mkv.tracks):
        fr = _frame_rate_str(t.default_duration_ns)
        s = StreamInfo(
            index=i,
            codec_name=CODEC_ID_TO_NAME.get(t.codec_id,
                                            t.codec_id.lower() or "unknown"),
            codec_type=t.codec_type,
            width=t.width,
            height=t.height,
            avg_frame_rate=fr,
            r_frame_rate=fr,
            disposition={"default": 1 if t.flag_default else 0,
                         "forced": 1 if t.flag_forced else 0},
            tags=({"language": t.language} if t.language else {}),
            codec_id=t.codec_id,
            codec_private=t.codec_private,
            default_duration_ns=t.default_duration_ns,
            language=t.language,
            channels=t.channels,
            sample_rate=t.sample_rate,
        )
        if t.colour_raw:
            s.colour_raw = t.colour_raw
            s.color_primaries = _COLOR_NAMES.get(
                t.color_primaries, str(t.color_primaries or ""))
            s.color_transfer = _TRANSFER_NAMES.get(
                t.color_transfer, str(t.color_transfer or ""))
            s.color_space = _MATRIX_NAMES.get(
                t.color_matrix, str(t.color_matrix or ""))
            s.color_primaries_code = t.color_primaries
            s.color_transfer_code = t.color_transfer
            s.color_matrix_code = t.color_matrix
        streams.append(s)
    return ProbeResult(format=fmt, streams=streams)


# ISO/IEC 23001-8 code points → ffprobe names (the subset that matters
# for HDR10 detection; unknown codes fall back to their number)
_COLOR_NAMES = {1: "bt709", 9: "bt2020"}
_TRANSFER_NAMES = {1: "bt709", 16: "smpte2084", 18: "arib-std-b67"}
_MATRIX_NAMES = {1: "bt709", 9: "bt2020nc", 10: "bt2020c"}


def probe(file_path: str) -> ProbeResult:
    import os
    with open(file_path, "rb") as f:
        mkv = parse(f)
    return to_probe_result(mkv, os.path.getsize(file_path))
