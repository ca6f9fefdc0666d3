"""Decoder of the private av1tpu profile: a port of
``av1tpu/legacy/decoder.py``.

OBU parse → frame header → native tile decode → dequant + exact inverse
transform + wavefront intra / subpel inter reconstruction → the loop
filter chain (deblock, CDEF when the header sets it, the header's
restoration preset, per tile stripe).  It runs the encoder's own
normative ops, so its output equals the encoder's recon.  It runs on
the card unless the caller asks for the CPU (``DecoderState(device=
"cpu")``, ``decode_ivf(path, device="cpu")``), as the original runs on
JAX's default device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from av1tpu_torch import device as D
from av1tpu_torch.encoder import quant
from av1tpu_torch.legacy import entropy_tile as tile_codec
from av1tpu_torch.legacy.core import inter_frame, intra_frame
from av1tpu_torch.media import obu as obu_mod
from av1tpu_torch.utils.testsrc import Frame


class DecodeError(Exception):
    pass


@dataclasses.dataclass
class DecoderState:
    seq: obu_mod.SequenceHeader | None = None
    ref: tuple | None = None     # (y, u, v) block-padded recon planes
    golden: tuple | None = None  # last keyframe recon (two_ref frames)
    device: str = "cuda"


def _padded_dims(w: int, h: int, block: int) -> tuple[int, int]:
    return -(-h // block) * block, -(-w // block) * block


def decode_frame_payload(payload: bytes, state: DecoderState) -> Frame | None:
    """Decode one temporal unit (bytes of OBUs).  Returns a Frame or None
    (e.g. pure TD/seq-header units)."""
    frame = None
    for obu_type, data in obu_mod.parse_obus(payload):
        if obu_type == obu_mod.OBU_SEQUENCE_HEADER:
            state.seq = obu_mod.SequenceHeader.parse(data)
        elif obu_type == obu_mod.OBU_FRAME:
            if state.seq is None:
                raise DecodeError("frame before sequence header")
            frame = _decode_frame(data, state)
    return frame


def _decode_frame(data: bytes, state: DecoderState) -> Frame:
    dev = D.resolve_device(state.device)
    fh, hdr_len = obu_mod.FrameHeader.parse(data)
    tile_data = data[hdr_len:]
    block = 1 << fh.luma_block_log2
    cblock = block // 2
    hp, wp = _padded_dims(fh.width, fh.height, block)
    n_blocks = (hp // block) * (wp // block)
    bd = state.seq.bit_depth if state.seq else 8
    q = fh.base_q_idx
    dc, ac = quant.dc_q(q, bd), quant.ac_q(q, bd)
    tiles = 1 << fh.tile_rows_log2
    tile_payloads = obu_mod.split_tiles(tile_data, tiles)
    bpt = n_blocks // tiles

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    if fh.frame_type == obu_mod.KEY_FRAME:
        parts = [tile_codec.decode_tile_intra(p, bpt, block, cblock)
                 for p in tile_payloads]
        skips, y_modes, uv_modes, y_lv, u_lv, v_lv = (
            np.concatenate([pt[i] for pt in parts]) for i in range(6))
        y = intra_frame.decode_plane(t(y_lv), t(y_modes), dc, ac, hp, wp,
                                     block, bd, tiles)
        uvm = t(uv_modes)
        u = intra_frame.decode_plane(t(u_lv), uvm, dc, ac, hp // 2, wp // 2,
                                     cblock, bd, tiles)
        v = intra_frame.decode_plane(t(v_lv), uvm, dc, ac, hp // 2, wp // 2,
                                     cblock, bd, tiles)
        y, u, v, _, _ = intra_frame.filter_planes(
            y, u, v, None, block, q, bd, tiles, cdef_on=fh.cdef_on,
            lr_mode=fh.lr_mode)
    else:
        if state.ref is None:
            raise DecodeError("inter frame without reference")
        if fh.two_ref and state.golden is None:
            raise DecodeError("two_ref frame without a keyframe golden")
        parts = [tile_codec.decode_tile_inter(p, bpt, block, cblock,
                                              use_refs=fh.two_ref)
                 for p in tile_payloads]
        skips, mvs, y_lv, u_lv, v_lv, refs, txs = (
            np.concatenate([pt[i] for pt in parts]) for i in range(7))
        y, u, v = inter_frame.decode_inter_frame_v2(
            t(mvs), t(y_lv), t(u_lv), t(v_lv), state.ref, dc, ac, q,
            fh.lr_mode, fh.cdef_on, hp, wp, block, bd, tiles,
            refs=t(refs) if fh.two_ref else None,
            ref2=state.golden if fh.two_ref else None, tx_syms=t(txs))

    if fh.refresh:  # non-reference frames (flash) leave state untouched
        state.ref = (y, u, v)
    if fh.frame_type == obu_mod.KEY_FRAME:
        state.golden = (y, u, v)
    h, w = fh.height, fh.width
    ch, cw = -(-h // 2), -(-w // 2)
    dtype = np.uint8 if bd == 8 else np.uint16
    return Frame(y=y[:h, :w].cpu().numpy().astype(dtype),
                 u=u[:ch, :cw].cpu().numpy().astype(dtype),
                 v=v[:ch, :cw].cpu().numpy().astype(dtype), bit_depth=bd)


def decode_ivf(path: str, device: str = "cuda") -> list[Frame]:
    """Decode all frames of an av1tpu-profile IVF file."""
    from av1tpu_torch.media import ivf
    state = DecoderState(device=device)
    frames = []
    with open(path, "rb") as f:
        ivf.read_header(f)
        for payload, _pts in ivf.iter_frames(f):
            fr = decode_frame_payload(payload, state)
            if fr is not None:
                frames.append(fr)
    return frames
