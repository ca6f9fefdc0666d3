"""The engine of the private av1tpu profile (``tpu.bitstream:
"av1tpu"``) on PyTorch: the device half of ``av1tpu/engine_tpu.py``'s
``TpuEngine`` over ``TorchEngine``'s copy of its host half.

Per frame: one packed upload of the padded planes, the keyframe
wavefront or the P-frame (``legacy.core``), then the sparse level
transfer and the native tile codec on the host (``_finalize``).  Runs of
``cfg.chunk`` P-frames go out as one chunk (at most 4 x 1920x1088
samples, the reference's cap), their frames entropy-coded on the entropy
pool.  The speed ladder: two references at speed 4 or lower, transform
selection at 5 or lower, subpel at 6 or lower, the CDEF gate and the
restoration choice at 7 or lower.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from av1tpu_torch import device as D
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.encoder import quant
from av1tpu_torch.engine import TorchEngine, _entropy_pool
from av1tpu_torch.legacy import entropy_tile as tile_codec
from av1tpu_torch.legacy.core import inter_frame, intra_frame
from av1tpu_torch.legacy.core.inter_frame import sparse_unpack_levels
from av1tpu_torch.media import obu as obu_mod


def _upload(planes, dev) -> list:
    """Padded host planes (uint8, or uint16 at 10 bits) as one flat
    host-to-device copy, split back into views on the device: uint8 at 8
    bits, int16 holding the 10-bit samples."""
    dt = np.uint8 if planes[0].dtype == np.uint8 else np.int16
    flat = np.concatenate([np.ascontiguousarray(p).view(dt).ravel()
                           for p in planes])
    t = torch.from_numpy(flat)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    out, off = [], 0
    for p in planes:
        out.append(t[off:off + p.size].reshape(p.shape))
        off += p.size
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class LegacyTorchEngine(TorchEngine):
    """Transcoder of the private av1tpu profile (see module docstring).
    ``device``: "cuda" (the default; without a card it raises) or
    "cpu"."""

    def __init__(self, cfg: Optional[TpuEncoderConfig] = None,
                 device: str = "cuda"):
        super().__init__(cfg)
        self.device = D.resolve_device(device)

    @property
    def _ref(self):
        """Reference recon planes materialized to host int32."""
        if self._ref_dev is None:
            return None
        return tuple(_host(p).astype(np.int32) for p in self._ref_dev)

    @property
    def _use_subpel(self) -> bool:
        return self.cfg.speed <= 6

    @property
    def _use_aux_filters(self) -> bool:
        return self.cfg.speed <= 7

    @property
    def _use_two_refs(self) -> bool:
        return self.cfg.speed <= 4

    @property
    def _use_tx_select(self) -> bool:
        return self.cfg.speed <= 5

    def _block_for(self, frame) -> int:
        """Luma block/transform size: tpu.block_log2 4 → 16, 5 → 32, 0
        (auto) → 32 for 720p-class frames and larger, else 16."""
        want = int(getattr(self.cfg, "block_log2", 0))
        if want in (4, 5):
            return 1 << want
        return 32 if min(frame.height, frame.width) >= 640 else 16

    def _tile_rows_for(self, hp: int, block: int) -> int:
        """Largest legal power-of-two tile-row count ≤ the configured one
        (stripes must be whole block rows; cfg: tpu.tile_rows_log2)."""
        want = 1 << max(0, int(getattr(self.cfg, "tile_rows_log2", 0)))
        rows = hp // block
        t = want
        while t > 1 and (rows % t or (hp // t) % 16 or rows // t < 1):
            t //= 2
        return max(1, t)

    @staticmethod
    def _chunk_cap(width: int, height: int, bit_depth: int) -> int:
        """K x frame-samples stays inside the reference's validated
        envelope (4 x 1080p at 8-bit): K decides when a rate controller
        sees each frame's bits, so the same cap keeps the stream the
        reference's."""
        budget = 4 * 1920 * 1088
        px = width * height * (2 if bit_depth > 8 else 1)
        return max(1, budget // max(1, px))

    def _submit(self, frame, qindex, force_key: bool = False,
                is_key: Optional[bool] = None, refresh: bool = True):
        """Dispatch one frame; returns the pending record.  refresh=False
        codes a non-reference frame (flash): the GOP reference is
        untouched."""
        if is_key is None:
            is_key = self._decide_key(frame, force_key)
        h, w = frame.height, frame.width
        bd = frame.bit_depth
        block = self._block_for(frame)
        planes = self._pad_planes(frame, block)
        tiles = self._tile_rows_for(planes[0].shape[0], block)
        qindex = int(qindex)
        dc, ac = quant.dc_q(qindex, bd), quant.ac_q(qindex, bd)
        yj, uj, vj = _upload(planes, self.device)
        if is_key:
            out = intra_frame.encode_key_frame_v2(
                yj, uj, vj, dc, ac, qindex, block, bd, tiles)
            self._ref_dev = out[5:8]
            self._golden_dev = out[5:8]  # GOP keyframe = golden ref
            two = False
        else:
            two = self._use_two_refs and self._golden_dev is not None
            out = inter_frame.encode_inter_frame_v2(
                yj, uj, vj, *self._ref_dev, dc, ac, qindex, block, bd,
                tiles, self._use_subpel, self._use_aux_filters,
                *(self._golden_dev if two else (None, None, None)),
                use_two_refs=two, use_tx_select=self._use_tx_select)
            if refresh:
                self._ref_dev = out[5:8]
        return (is_key, qindex, w, h, out, tiles, block, two, refresh)

    @staticmethod
    def _tile_payloads(is_key, skips, first, second, lvs, tiles, block,
                       refs=None, txs=None):
        """Entropy-code one frame's tile rows (contiguous block-row
        ranges)."""
        lv_y, lv_u, lv_v = lvs
        bpt = len(skips) // tiles
        payloads = []
        for t in range(tiles):
            sl = slice(t * bpt, (t + 1) * bpt)
            if is_key:
                payloads.append(tile_codec.encode_tile_intra(
                    skips[sl].astype(np.uint8), first[sl], second[sl],
                    lv_y[sl], lv_u[sl], lv_v[sl], block, block // 2))
            else:
                payloads.append(tile_codec.encode_tile_inter(
                    skips[sl].astype(np.uint8), first[sl].astype(np.int32),
                    lv_y[sl], lv_u[sl], lv_v[sl], block, block // 2,
                    refs=refs[sl] if refs is not None else None,
                    txs=txs[sl]))
        return payloads

    @staticmethod
    def _finalize(pending) -> tuple[bytes, bool]:
        """Materialize a pending frame's outputs and entropy-code them."""
        is_key, qindex, w, h, out, tiles, block, two, refresh = pending
        fh = obu_mod.FrameHeader(
            frame_type=obu_mod.KEY_FRAME if is_key else obu_mod.INTER_FRAME,
            base_q_idx=qindex, width=w, height=h,
            luma_block_log2=block.bit_length() - 1,
            tile_rows_log2=tiles.bit_length() - 1, two_ref=two,
            refresh=refresh)
        fh.lr_mode = int(out[8])
        fh.cdef_on = bool(out[9])
        first, skips = _host(out[0]), _host(out[4])
        shapes = [tuple(out[i].shape) for i in (1, 2, 3)]
        lvs = sparse_unpack_levels(_host(out[10]), _host(out[11]),
                                   _host(out[12]), shapes)
        if lvs is None:
            lvs = [_host(out[i]) for i in (1, 2, 3)]
        if is_key:
            payloads = LegacyTorchEngine._tile_payloads(
                True, skips, first, _host(out[13]), lvs, tiles, block)
        else:
            payloads = LegacyTorchEngine._tile_payloads(
                False, skips, first, None, lvs, tiles, block,
                refs=_host(out[13]) if two else None, txs=_host(out[14]))
        return obu_mod.write_frame_obu(fh, payloads), is_key

    def _submit_chunk(self, frames, qindexes):
        """K consecutive P-frames as one dispatch: one upload, the K
        frames encoded in turn on the device (frame k's recon is frame
        k+1's reference)."""
        f0 = frames[0]
        w, h, bd = f0.width, f0.height, f0.bit_depth
        block = self._block_for(f0)
        planes = [self._pad_planes(fr, block) for fr in frames]
        tiles = self._tile_rows_for(planes[0][0].shape[0], block)
        k = len(frames)
        up = _upload([np.stack([p[i] for p in planes]) for i in range(3)],
                     self.device)
        qi = [int(q) for q in qindexes]
        two = self._use_two_refs and self._golden_dev is not None
        outs = inter_frame.encode_inter_chunk_v2(
            *up, *self._ref_dev, [quant.dc_q(q, bd) for q in qi],
            [quant.ac_q(q, bd) for q in qi], qi, block, bd, tiles,
            self._use_subpel, self._use_aux_filters,
            *(self._golden_dev if two else (None, None, None)),
            use_two_refs=two, use_tx_select=self._use_tx_select)
        self._ref_dev = outs[-1][5:8]
        return (qi, w, h, outs, tiles, block, k, two)

    @staticmethod
    def _finalize_chunk(pending) -> list[tuple[bytes, bool]]:
        """Materialize a chunk and entropy-code its K frames on the entropy
        pool (each frame's tiles start from fresh CDFs, and the native
        coder releases the GIL)."""
        qindexes, w, h, outs, tiles, block, k, two = pending
        got = [(int(o[8]), bool(o[9]), _host(o[0]), _host(o[4]),
                _host(o[10]), _host(o[11]), _host(o[12]), _host(o[14]),
                _host(o[13]) if two else None) for o in outs]
        shapes = [tuple(outs[0][i].shape) for i in (1, 2, 3)]

        def encode_one(i: int) -> tuple[bytes, bool]:
            lr_mode, cdef_on, first, skips, sm, sv, sc, txs, refs = got[i]
            fh = obu_mod.FrameHeader(
                frame_type=obu_mod.INTER_FRAME, base_q_idx=qindexes[i],
                width=w, height=h, luma_block_log2=block.bit_length() - 1,
                tile_rows_log2=tiles.bit_length() - 1, two_ref=two)
            fh.lr_mode = lr_mode
            fh.cdef_on = cdef_on
            lvs = sparse_unpack_levels(sm, sv, sc, shapes)
            if lvs is None:  # rare dense frame: its full levels
                lvs = [_host(outs[i][j]) for j in (1, 2, 3)]
            payloads = LegacyTorchEngine._tile_payloads(
                False, skips, first, None, lvs, tiles, block, refs=refs,
                txs=txs)
            return obu_mod.write_frame_obu(fh, payloads), False

        return list(_entropy_pool().map(encode_one, range(k)))

    # ---- daemon surface -------------------------------------------------
    def sequence_header(self, width: int, height: int, bit_depth: int = 8,
                        source_stream=None) -> obu_mod.SequenceHeader:
        """The profile's sequence header; HDR sources carry their colour
        description through from the container probe."""
        sh = obu_mod.SequenceHeader(width=width, height=height,
                                    bit_depth=bit_depth)
        if source_stream is not None:
            sh.color_primaries = getattr(source_stream,
                                         "color_primaries_code", 0)
            sh.color_transfer = getattr(source_stream,
                                        "color_transfer_code", 0)
            sh.color_matrix = getattr(source_stream, "color_matrix_code", 0)
        return sh

    def codec_private(self, sh) -> bytes:
        """MKV CodecPrivate for the video track (av1C record)."""
        return obu_mod.av1c_record(sh)

    def _prewarm(self, width: int, height: int, bit_depth: int = 8):
        """Build, before frames flow, the CUDA kernel library (on a card)
        and the native tile library.  The JAX engine compiles its XLA
        programs here; the port has nothing to compile.  Nothing is
        encoded, so no output byte changes."""
        if self.device.type == "cuda":
            D.kernels()
            torch.empty(1, device=self.device)
        tile_codec._lib_inter()


def load_gop_state(engine: LegacyTorchEngine, ref, golden=None,
                   frame_idx: int = 0, prev_thumb=None) -> None:
    """Start ``engine`` from another engine's GOP state (the JAX
    ``TpuEngine``'s, in the parity tests): the (y, u, v) recon planes of
    the reference and of GOLDEN as host arrays, the frame index and the
    scene-cut detector's thumb."""
    dev = engine.device

    def planes(tri):
        return tuple(torch.as_tensor(np.asarray(p, np.int32), device=dev)
                     for p in tri)

    engine._ref_dev = planes(ref)
    engine._golden_dev = planes(golden) if golden is not None else None
    engine._frame_idx = int(frame_idx)
    engine._prev_thumb = prev_thumb
