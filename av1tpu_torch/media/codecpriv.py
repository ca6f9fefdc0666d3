# Copied from av1tpu/media/codecpriv.py.
"""Bit-depth extraction from codec initialization payloads.

The reference's ffprobe fills ``bits_per_raw_sample`` for compressed
codecs by parsing their parameter sets; without it our HDR/10-bit gate
(engine_tpu.transcode) can only see container-level Colour metadata,
and a metadata-poor 10-bit HEVC would sail into the 8-bit decode path
and get silently mangled (VERDICT r2 Missing #2/Weak #5; jobs.go:41
records the value in the job).

Supported records (the codec_private bytes our demuxers extract):
  * avcC  — AVCDecoderConfigurationRecord (ISO 14496-15 §5.3.3): the
    first SPS NAL is Exp-Golomb parsed up to bit_depth_luma_minus8.
  * hvcC  — HEVCDecoderConfigurationRecord (ISO 14496-15 §8.3.3):
    bitDepthLumaMinus8 lives at a fixed byte offset in the record.
  * av1C  — AV1CodecConfigurationRecord (AV1-ISOBMFF §2.3): the
    high_bitdepth/twelve_bit flags in byte 2.
  * vpcC  — VP9 codec configuration: bitDepth field in byte 2 (after
    the 4-byte FullBox header our mp4 demuxer keeps in the payload).

Everything degrades to 0 ("unknown") on truncated or malformed input —
the probe keeps working, the gate then falls back to Colour metadata.
"""

from __future__ import annotations


def _strip_emulation(data: bytes) -> bytes:
    """Remove H.26x emulation-prevention bytes (00 00 03 -> 00 00)."""
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad Exp-Golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)


# profiles whose SPS carries chroma_format_idc/bit_depth (H.264 §7.3.2.1.1)
_H264_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128,
                       138, 139, 134, 135}


def _h264_sps_bit_depth(sps_nal: bytes) -> int:
    """sps_nal: one SPS NAL unit including its 1-byte header."""
    br = _BitReader(_strip_emulation(sps_nal[1:]))
    profile_idc = br.u(8)
    br.u(8)   # constraint flags + reserved
    br.u(8)   # level_idc
    br.ue()   # sps_id
    if profile_idc not in _H264_HIGH_PROFILES:
        return 8
    chroma_format_idc = br.ue()
    if chroma_format_idc == 3:
        br.u(1)  # separate_colour_plane_flag
    return br.ue() + 8  # bit_depth_luma_minus8


def _from_avcc(rec: bytes) -> int:
    if len(rec) < 8 or rec[0] != 1:
        return 0
    num_sps = rec[5] & 0x1F
    if num_sps == 0:
        return 0
    sps_len = int.from_bytes(rec[6:8], "big")
    sps = rec[8:8 + sps_len]
    if len(sps) < sps_len or not sps:
        return 0
    try:
        return _h264_sps_bit_depth(sps)
    except (IndexError, ValueError):
        return 0


def _from_hvcc(rec: bytes) -> int:
    # layout: version(1) profile(1) compat(4) constraints(6) level(1)
    # min_spatial(2) parallelism(1) chroma_format(1) bitDepthLuma(1) ...
    if len(rec) < 18 or rec[0] != 1:
        return 0
    return (rec[17] & 0x07) + 8


def _from_av1c(rec: bytes) -> int:
    if len(rec) < 3 or (rec[0] >> 7) != 1 or (rec[0] & 0x7F) != 1:
        return 0
    high = (rec[2] >> 6) & 1
    twelve = (rec[2] >> 5) & 1
    return 12 if (high and twelve) else (10 if high else 8)


def _from_vpcc(rec: bytes) -> int:
    # payload keeps the FullBox version/flags (4 bytes) our demuxer
    # reads: profile(1) level(1) bitDepth(4 bits)+subsampling...
    if len(rec) < 7:
        return 0
    return (rec[6] >> 4) & 0x0F


def _from_vp9_mkv_features(rec: bytes) -> int:
    # Matroska V_VP9 CodecPrivate: (id, length, value...) triplets;
    # feature id 3 = bit depth
    i = 0
    while i + 2 <= len(rec):
        fid, flen = rec[i], rec[i + 1]
        i += 2
        if i + flen > len(rec):
            return 0
        if fid == 3 and flen >= 1:
            return rec[i]
        i += flen
    return 0


def video_bit_depth(codec_name: str, codec_id: str,
                    codec_private: bytes) -> int:
    """Luma bit depth from the codec init record, or 0 if unknown."""
    if not codec_private:
        return 0
    name = (codec_name or "").lower()
    cid = (codec_id or "").upper()
    if name == "h264" or "ISO/AVC" in cid:
        return _from_avcc(codec_private)
    if name == "hevc" or "ISO/HEVC" in cid:
        return _from_hvcc(codec_private)
    if name == "av1" or cid == "V_AV1":
        return _from_av1c(codec_private)
    if cid == "V_VP9":
        return _from_vp9_mkv_features(codec_private)
    if name in ("vp9", "vp09"):
        return _from_vpcc(codec_private)
    return 0
