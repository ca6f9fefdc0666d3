# Copied from av1tpu/media/mp4.py.
"""ISOBMFF (MP4/MOV/M4V) demuxer: probe metadata + sample extraction.

Parses moov/trak/stbl tables into per-track sample maps, producing
ffprobe-JSON-shaped ProbeResults (format_name "mov,mp4,m4a,3gp,3g2,mj2",
per-stream codec/dimensions/frame rates/disposition) and an iterator of
timestamped samples for stream copy into Matroska.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import BinaryIO, Iterator, Optional

from av1tpu_torch.media.mkv import Packet
from av1tpu_torch.media.probe import FormatInfo, ProbeResult, StreamInfo

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf",
              b"udta", b"mvex", b"moof", b"traf"}

FOURCC_TO_NAME = {
    "avc1": "h264", "avc3": "h264",
    "hvc1": "hevc", "hev1": "hevc",
    "av01": "av1",
    "vp09": "vp9", "vp08": "vp8",
    "mp4v": "mpeg4",
    "mp4a": "aac",
    "ac-3": "ac3", "ec-3": "eac3",
    "Opus": "opus", "fLaC": "flac",
    "tx3g": "mov_text", "text": "mov_text",
}

# Matroska codec ids for transmux (stream copy mp4 → mkv)
NAME_TO_MKV_CODEC_ID = {
    "h264": "V_MPEG4/ISO/AVC",
    "hevc": "V_MPEGH/ISO/HEVC",
    "av1": "V_AV1",
    "vp9": "V_VP9",
    "aac": "A_AAC",
    "ac3": "A_AC3",
    "eac3": "A_EAC3",
    "opus": "A_OPUS",
    "flac": "A_FLAC",
    "mov_text": "S_TEXT/UTF8",
}


class Mp4Error(Exception):
    pass


@dataclasses.dataclass
class Mp4Track:
    track_id: int = 0
    handler: str = ""            # vide/soun/text/sbtl/subt
    timescale: int = 0
    duration: int = 0            # in track timescale
    language: str = ""
    fourcc: str = ""
    codec_private: bytes = b""   # avcC/hvcC/av1C/esds payload
    width: int = 0
    height: int = 0
    channels: int = 0
    sample_rate: float = 0.0
    # sample tables
    sample_sizes: list = dataclasses.field(default_factory=list)
    sample_offsets: list = dataclasses.field(default_factory=list)
    sample_times: list = dataclasses.field(default_factory=list)   # dts, track units
    sample_durations: list = dataclasses.field(default_factory=list)
    sync_samples: Optional[set] = None   # None = all sync

    @property
    def codec_type(self) -> str:
        return {"vide": "video", "soun": "audio", "text": "subtitle",
                "sbtl": "subtitle", "subt": "subtitle"}.get(self.handler,
                                                            "data")

    @property
    def codec_name(self) -> str:
        return FOURCC_TO_NAME.get(self.fourcc, self.fourcc.lower() or "unknown")


@dataclasses.dataclass
class Mp4File:
    major_brand: str = ""
    timescale: int = 1000
    duration: int = 0
    tracks: list[Mp4Track] = dataclasses.field(default_factory=list)

    @property
    def duration_seconds(self) -> float:
        return self.duration / self.timescale if self.timescale else 0.0


def _iter_boxes(f: BinaryIO, end: Optional[int]) -> Iterator[tuple[bytes, int, int]]:
    """Yield (type, payload_start, payload_end) for sibling boxes."""
    while True:
        pos = f.tell()
        if end is not None and pos >= end:
            return
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        size = struct.unpack(">I", hdr[:4])[0]
        btype = hdr[4:8]
        payload_start = pos + 8
        if size == 1:
            large = f.read(8)
            if len(large) < 8:
                return
            size = struct.unpack(">Q", large)[0]
            payload_start = pos + 16
        elif size == 0:
            f.seek(0, 2)
            yield btype, payload_start, f.tell()
            return
        if size < 8:
            raise Mp4Error(f"bad box size {size}")
        yield btype, payload_start, pos + size
        f.seek(pos + size)


def _fullbox(f: BinaryIO) -> tuple[int, int]:
    data = f.read(4)
    return data[0], int.from_bytes(data[1:], "big")


def _parse_stsd(f: BinaryIO, end: int, t: Mp4Track) -> None:
    _v, _fl = _fullbox(f)
    entry_count = struct.unpack(">I", f.read(4))[0]
    for btype, pstart, pend in _iter_boxes(f, end):
        t.fourcc = btype.decode("latin-1").strip()
        f.seek(pstart)
        if t.handler == "vide":
            f.seek(pstart + 24)  # 6 reserved + 2 dref + 16 predefined/reserved
            t.width, t.height = struct.unpack(">HH", f.read(4))
            f.seek(pstart + 78)  # fixed part of VisualSampleEntry
            for sub, spstart, spend in _iter_boxes(f, pend):
                if sub in (b"avcC", b"hvcC", b"av1C", b"vpcC", b"esds"):
                    f.seek(spstart)
                    t.codec_private = f.read(spend - spstart)
                    break
        elif t.handler == "soun":
            f.seek(pstart + 8)   # 6 reserved + 2 dref
            f.read(8)            # version/revision/vendor
            t.channels, _bits = struct.unpack(">HH", f.read(4))
            f.read(4)            # predefined/reserved
            rate_fixed = struct.unpack(">I", f.read(4))[0]
            t.sample_rate = rate_fixed / 65536.0
            for sub, spstart, spend in _iter_boxes(f, pend):
                if sub in (b"esds", b"dac3", b"dec3", b"dOps", b"dfLa"):
                    f.seek(spstart)
                    t.codec_private = f.read(spend - spstart)
                    break
        break  # first entry only
    _ = entry_count


def _parse_stbl(f: BinaryIO, end: int, t: Mp4Track) -> None:
    stts: list[tuple[int, int]] = []
    ctts: list[tuple[int, int]] = []
    stsc: list[tuple[int, int]] = []   # (first_chunk, samples_per_chunk)
    stco: list[int] = []
    stsz: list[int] = []
    stss: Optional[list[int]] = None

    for btype, pstart, pend in _iter_boxes(f, end):
        f.seek(pstart)
        if btype == b"stsd":
            _parse_stsd(f, pend, t)
        elif btype == b"stts":
            _fullbox(f)
            n = struct.unpack(">I", f.read(4))[0]
            raw = f.read(8 * n)
            for i in range(n):
                cnt, delta = struct.unpack_from(">II", raw, 8 * i)
                stts.append((cnt, delta))
        elif btype == b"ctts":
            _fullbox(f)
            n = struct.unpack(">I", f.read(4))[0]
            raw = f.read(8 * n)
            for i in range(n):
                cnt, off = struct.unpack_from(">Ii", raw, 8 * i)
                ctts.append((cnt, off))
        elif btype == b"stsc":
            _fullbox(f)
            n = struct.unpack(">I", f.read(4))[0]
            raw = f.read(12 * n)
            for i in range(n):
                first, spc, _desc = struct.unpack_from(">III", raw, 12 * i)
                stsc.append((first, spc))
        elif btype in (b"stco", b"co64"):
            _fullbox(f)
            n = struct.unpack(">I", f.read(4))[0]
            if btype == b"stco":
                raw = f.read(4 * n)
                stco = [struct.unpack_from(">I", raw, 4 * i)[0]
                        for i in range(n)]
            else:
                raw = f.read(8 * n)
                stco = [struct.unpack_from(">Q", raw, 8 * i)[0]
                        for i in range(n)]
        elif btype == b"stsz":
            _fullbox(f)
            uniform, n = struct.unpack(">II", f.read(8))
            if uniform:
                stsz = [uniform] * n
            else:
                raw = f.read(4 * n)
                stsz = [struct.unpack_from(">I", raw, 4 * i)[0]
                        for i in range(n)]
        elif btype == b"stss":
            _fullbox(f)
            n = struct.unpack(">I", f.read(4))[0]
            raw = f.read(4 * n)
            stss = [struct.unpack_from(">I", raw, 4 * i)[0] for i in range(n)]

    # Expand tables into flat per-sample arrays
    t.sample_sizes = stsz
    num_samples = len(stsz)

    # dts + durations from stts
    times, durs = [], []
    dts = 0
    for cnt, delta in stts:
        for _ in range(cnt):
            times.append(dts)
            durs.append(delta)
            dts += delta
    times = times[:num_samples]
    durs = durs[:num_samples]
    t.sample_times = times
    t.sample_durations = durs

    # offsets from stsc/stco
    offsets: list[int] = []
    if stco and stsc:
        sample_idx = 0
        for ci, chunk_off in enumerate(stco):
            chunk_no = ci + 1
            spc = 0
            for first, count in stsc:
                if first <= chunk_no:
                    spc = count
                else:
                    break
            off = chunk_off
            for _ in range(spc):
                if sample_idx >= num_samples:
                    break
                offsets.append(off)
                off += stsz[sample_idx]
                sample_idx += 1
    t.sample_offsets = offsets[:num_samples]
    t.sync_samples = set(stss) if stss is not None else None


def parse(f: BinaryIO) -> Mp4File:
    f.seek(0)
    mp4 = Mp4File()
    moov_seen = False
    for btype, pstart, pend in _iter_boxes(f, None):
        if btype == b"ftyp":
            f.seek(pstart)
            mp4.major_brand = f.read(4).decode("latin-1")
        elif btype == b"moov":
            moov_seen = True
            f.seek(pstart)
            for sub, spstart, spend in _iter_boxes(f, pend):
                f.seek(spstart)
                if sub == b"mvhd":
                    version, _ = _fullbox(f)
                    if version == 1:
                        f.read(16)
                        mp4.timescale = struct.unpack(">I", f.read(4))[0]
                        mp4.duration = struct.unpack(">Q", f.read(8))[0]
                    else:
                        f.read(8)
                        mp4.timescale = struct.unpack(">I", f.read(4))[0]
                        mp4.duration = struct.unpack(">I", f.read(4))[0]
                elif sub == b"trak":
                    mp4.tracks.append(_parse_trak(f, spstart, spend))
    if not moov_seen:
        raise Mp4Error("no moov box")
    return mp4


def _parse_trak(f: BinaryIO, start: int, end: int) -> Mp4Track:
    t = Mp4Track()
    f.seek(start)
    for btype, pstart, pend in _iter_boxes(f, end):
        f.seek(pstart)
        if btype == b"tkhd":
            version, _ = _fullbox(f)
            skip = 8 + 8 if version == 1 else 4 + 4
            f.read(skip)
            t.track_id = struct.unpack(">I", f.read(4))[0]
        elif btype == b"mdia":
            for sub, spstart, spend in _iter_boxes(f, pend):
                f.seek(spstart)
                if sub == b"mdhd":
                    version, _ = _fullbox(f)
                    if version == 1:
                        f.read(16)
                        t.timescale = struct.unpack(">I", f.read(4))[0]
                        t.duration = struct.unpack(">Q", f.read(8))[0]
                    else:
                        f.read(8)
                        t.timescale = struct.unpack(">I", f.read(4))[0]
                        t.duration = struct.unpack(">I", f.read(4))[0]
                    lang = struct.unpack(">H", f.read(2))[0]
                    t.language = "".join(
                        chr(0x60 + ((lang >> s) & 0x1F)) for s in (10, 5, 0))
                    if t.language == "```":
                        t.language = ""
                elif sub == b"hdlr":
                    _fullbox(f)
                    f.read(4)
                    t.handler = f.read(4).decode("latin-1")
                elif sub == b"minf":
                    for s2, s2start, s2end in _iter_boxes(f, spend):
                        if s2 == b"stbl":
                            f.seek(s2start)
                            _parse_stbl(f, s2end, t)
    return t


def iter_packets(f: BinaryIO, mp4: Mp4File,
                 track: Mp4Track) -> Iterator[Packet]:
    """Yield this track's samples as timestamped packets (ns)."""
    scale = track.timescale or 1
    for i in range(len(track.sample_sizes)):
        if i >= len(track.sample_offsets) or i >= len(track.sample_times):
            break
        f.seek(track.sample_offsets[i])
        data = f.read(track.sample_sizes[i])
        key = track.sync_samples is None or (i + 1) in track.sync_samples
        yield Packet(
            track_number=track.track_id,
            timestamp_ns=track.sample_times[i] * 1_000_000_000 // scale,
            data=data,
            keyframe=key,
            duration_ns=(track.sample_durations[i] * 1_000_000_000 // scale
                         if i < len(track.sample_durations) else 0),
        )


# ---------------------------------------------------------------------------
# probe surface

def _rate_str(num: float, den: float) -> str:
    if den <= 0 or num <= 0:
        return ""
    g = math.gcd(int(num), int(den))
    if g:
        return f"{int(num) // g}/{int(den) // g}"
    return f"{num}/{den}"


def to_probe_result(mp4: Mp4File, total_size: int = 0) -> ProbeResult:
    fmt = FormatInfo(format_name="mov,mp4,m4a,3gp,3g2,mj2")
    dur = mp4.duration_seconds
    if dur > 0:
        fmt.duration = f"{dur:.6f}"
        if total_size > 0:
            fmt.bit_rate = str(int(total_size * 8 / dur))

    streams = []
    for i, t in enumerate(mp4.tracks):
        avg = r = ""
        if t.codec_type == "video" and t.sample_durations and t.timescale:
            n = len(t.sample_sizes)
            if t.duration > 0 and n > 0:
                # avg_frame_rate = frames / duration
                avg = _rate_str(n * t.timescale, t.duration)
            # r_frame_rate from the most common sample delta
            deltas: dict[int, int] = {}
            for d in t.sample_durations:
                deltas[d] = deltas.get(d, 0) + 1
            common = max(deltas, key=deltas.get)
            if common > 0:
                r = _rate_str(t.timescale, common)
        s = StreamInfo(
            index=i,
            codec_name=t.codec_name,
            codec_type=t.codec_type,
            width=t.width,
            height=t.height,
            avg_frame_rate=avg,
            r_frame_rate=r,
            disposition={"default": 1 if i == 0 else 0},
            tags=({"language": t.language} if t.language else {}),
            codec_id=t.fourcc,
            codec_private=t.codec_private,
            language=t.language,
            channels=t.channels,
            sample_rate=t.sample_rate,
        )
        streams.append(s)
    return ProbeResult(format=fmt, streams=streams)


def probe(file_path: str) -> ProbeResult:
    import os
    with open(file_path, "rb") as f:
        mp4 = parse(f)
    return to_probe_result(mp4, os.path.getsize(file_path))
