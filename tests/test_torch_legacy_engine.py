"""The port's private-profile engine (``tpu.bitstream: "av1tpu"``)
against the JAX package's ``TpuEngine``, on the CPU.

``LegacyTorchEngine(device="cpu")`` and ``TpuEngine`` encode the same
frames (``testsrc2`` and ``utils/cleansrc.py`` clips, qindex 96) and
must emit the same payloads and reconstructions: one frame a dispatch
through ``encode_next``, the same clip through ``encode_stream`` in
chunks of 2, two references at speed 4, 10 bits, and 32-px blocks.  The
two packages' legacy decoders decode each other's streams to the
encoder's recon, and ``make_engine`` + ``transcode`` write the same
Matroska bytes.  Every clip of one bit depth and block size shares the
JAX programs of the first (160x96, block 16, one tile row); the
transcode's config keeps chunk=2 so that its prewarm compiles nothing
new.
"""

import numpy as np

import av1tpu.legacy.decoder as j_dec
import av1tpu.media.y4m as j_y4m
import av1tpu.utils.testsrc as j_testsrc
from av1tpu.config import TpuEncoderConfig as JConfig
from av1tpu.engine_tpu import TpuEngine
from av1tpu_torch import config as tconfig
from av1tpu_torch.daemon import engine as tengine
from av1tpu_torch.legacy import decoder as t_dec
from av1tpu_torch.legacy.engine import LegacyTorchEngine, load_gop_state
from av1tpu_torch.media import mkv as t_mkv
from av1tpu_torch.media import obu as t_obu
from av1tpu_torch.media import probe as t_probe
from av1tpu_torch.utils import cleansrc
from av1tpu_torch.utils.testsrc import Frame

W, H, Q = 160, 96, 96


def _pair(**cfg):
    return (TpuEngine(JConfig(bitstream="av1tpu", **cfg)),
            LegacyTorchEngine(tconfig.TpuEncoderConfig(bitstream="av1tpu",
                                                       **cfg),
                              device="cpu"))


def _run_next(eng, frames):
    """encode_next a frame at a time; (payloads, key flags, recons)."""
    out, recons = [], []
    for f in frames:
        out.append(eng.encode_next(f, Q))
        recons.append(eng._ref)
    return [p for p, _ in out], [k for _, k in out], recons


def _decode(mod, payloads, seq, state):
    frames = []
    for p in [seq] + payloads:
        fr = mod.decode_frame_payload(p, state)
        if fr is not None:
            frames.append(fr)
    return frames


def _assert_decodes(payloads, recons, bd=8):
    """Both packages' decoders reproduce the recon of every frame."""
    seq = t_obu.write_obu(t_obu.OBU_SEQUENCE_HEADER, t_obu.SequenceHeader(
        width=W, height=H, bit_depth=bd).write())
    for mod in (j_dec, t_dec):
        got = _decode(mod, payloads, seq, j_dec.DecoderState() if
                      mod is j_dec else t_dec.DecoderState(device="cpu"))
        assert len(got) == len(recons)
        for fr, rec in zip(got, recons):
            for plane, r in zip((fr.y, fr.u, fr.v), rec):
                np.testing.assert_array_equal(
                    plane, r[:plane.shape[0], :plane.shape[1]])


def _golden_blocks(payloads):
    """GOLDEN blocks per two_ref inter frame, read back by the port's
    tile decoder."""
    from av1tpu_torch.legacy import entropy_tile
    counts = []
    for p in payloads:
        for t, d in t_obu.parse_obus(p):
            fh, n = t_obu.FrameHeader.parse(d)
            if t != t_obu.OBU_FRAME or not fh.two_ref:
                continue
            blk = 1 << fh.luma_block_log2
            nb = (-(-fh.height // blk)) * (-(-fh.width // blk))
            refs = entropy_tile.decode_tile_inter(
                d[n:], nb, blk, blk // 2, use_refs=True)[5]
            counts.append(int(refs.sum()))
    return counts


def test_legacy_engine_matches_tpu_engine():
    """Key + 2 P at speed 6 through encode_next: the same payloads and
    recons; the P-frames again from the JAX engine's GOP state loaded
    into a fresh port engine (load_gop_state); both decoders on both
    streams; and the clip through encode_stream at chunk=2 (the key's
    boosted qindex, one chunk of 2)."""
    frames = [j_testsrc.testsrc2(W, H, i) for i in range(3)]
    jeng, teng = _pair()
    jp, jk, jr = _run_next(jeng, frames)
    tp, tk, tr = _run_next(teng, frames)
    assert jk == tk == [True, False, False]
    assert tp == jp
    for a, b in zip(jr, tr):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
    fresh = LegacyTorchEngine(tconfig.TpuEncoderConfig(bitstream="av1tpu"),
                              device="cpu")
    jeng.start_stream()
    jeng.encode_next(frames[0], Q)
    load_gop_state(fresh, jeng._ref, tuple(np.asarray(p) for p in
                                           jeng._golden_dev),
                   jeng._frame_idx, jeng._prev_thumb)
    assert [fresh.encode_next(f, Q) for f in frames[1:]] == \
        [(p, False) for p in jp[1:]]
    _assert_decodes(jp, jr)
    _assert_decodes(tp, tr)
    jeng, teng = _pair(chunk=2)
    js = list(jeng.encode_stream(frames, Q))
    ts = list(teng.encode_stream(frames, Q))
    assert [k for _, k in ts] == [True, False, False]
    assert ts == js


def test_two_references_10bit_and_32px_blocks():
    """Speed 4 (two references, transform selection) on a clean 8-frame
    clip at 160x96: scene A, five blends towards scene B under the cut
    threshold, a cut back to A and one more A frame.  The profile has no
    golden-aware scene cut, so the cut back codes as a keyframe, as in
    the reference; the blends choose GOLDEN on some blocks.  Then a
    10-bit key + P at 160x96 and a key + P at block_log2=5 (the 32-px
    path) at 192x128: the same bytes and recons."""
    frames = [cleansrc.clean_frame(W, H, 0, 0)]
    for k in range(1, 6):
        fa, fb = (cleansrc.clean_frame(W, H, k, s) for s in (0, 1))
        frames.append(Frame(*(
            (((5 - k) * pa.astype(np.int32) + k * pb.astype(np.int32) + 2)
             // 5).astype(np.uint8)
            for pa, pb in ((fa.y, fb.y), (fa.u, fb.u), (fa.v, fb.v)))))
    frames += [cleansrc.clean_frame(W, H, t, 0) for t in (6, 7)]
    jeng, teng = _pair(speed=4)
    js = list(jeng.encode_stream(frames, Q))
    ts = list(teng.encode_stream(frames, Q))
    assert [k for _, k in ts] == [True] + [False] * 5 + [True, False]
    assert ts == js
    gold = _golden_blocks([p for p, _ in ts])
    assert len(gold) == 6 and sum(gold) > 0, gold
    for bd, w, h, cfg in ((10, W, H, {}), (8, 192, 128, {"block_log2": 5})):
        clip = [j_testsrc.testsrc2(w, h, i, bd) for i in range(2)]
        jeng, teng = _pair(**cfg)
        jp, _, jr = _run_next(jeng, clip)
        tp, tk, tr = _run_next(teng, clip)
        assert tk == [True, False] and tp == jp
        for a, b in zip(jr, tr):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)
        assert teng._block_for(clip[0]) == (32 if cfg else 16)


def test_make_engine_transcode_matches_jax(tmp_path):
    """make_engine(cfg, device="cpu") with bitstream "av1tpu" builds the
    port's legacy engine, and its transcode of a 3-frame 160x96 y4m
    writes the same Matroska bytes as the JAX package's TpuEngine (both
    with chunk=2; no duration, so a constant qindex), which both
    packages' decode-verify judge alike."""
    src = str(tmp_path / "clip.y4m")
    j_y4m.write(src, [(f.y, f.u, f.v) for f in
                      (j_testsrc.testsrc2(W, H, i) for i in range(3))])
    cfg = tconfig.TranscodeConfig(tpu=tconfig.TpuEncoderConfig(
        bitstream="av1tpu", chunk=2))
    teng = tengine.make_engine(cfg, device="cpu")
    assert isinstance(teng, LegacyTorchEngine)
    assert teng.device.type == "cpu"
    jeng = TpuEngine(JConfig(bitstream="av1tpu", chunk=2))
    outs = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        outs[name] = str(tmp_path / f"out_{name}.mkv")
        eng.transcode(src, outs[name], t_probe.probe_file(src), False)
    data = [open(outs[k], "rb").read() for k in ("jax", "torch")]
    assert data[0] == data[1]
    with open(outs["torch"], "rb") as f:
        m = t_mkv.parse(f)
        video = [p for p in t_mkv.iter_packets(f, m)
                 if p.track_number == 1]
    assert len(video) == 3 and m.tracks[0].codec_private == \
        teng.codec_private(teng.sequence_header(W, H))
    assert teng.last_job_stats["encoded_frames"] == 3
    # decode-verify (libaom, where installed) judges both files alike:
    # libaom cannot read the private profile, so a daemon with
    # decode_verify on refuses either package's output
    import av1tpu.daemon.core as j_core
    from av1tpu_torch.daemon import core as t_core
    assert t_core.verify_output_av1(outs["torch"]) == \
        j_core.verify_output_av1(outs["jax"])


def test_encode_clip_matches_jax_tool(tmp_path):
    """``encode_clip --cpu --verify`` at 160x96, 3 frames: the port's tool
    (LegacyTorchEngine through encode_next, the legacy decoder) writes the
    JAX package's tool's IVF bytes and prints its lines, timing aside."""
    import contextlib
    import io
    import re

    from av1tpu.tools import encode_clip as j_clip
    from av1tpu_torch.tools import encode_clip as t_clip
    got = {}
    for name, mod in (("jax", j_clip), ("torch", t_clip)):
        out = str(tmp_path / f"{name}.ivf")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rv = mod.main(["--cpu", "--width", str(W), "--height", str(H),
                           "--frames", "3", "--out", out, "--verify"])
        assert rv == 0
        lines = [re.sub(r" in [0-9.]+s \([0-9.]+ fps\)", "", ln)
                 for ln in buf.getvalue().splitlines()]
        got[name] = (open(out, "rb").read(), lines)
    assert got["torch"] == got["jax"]
    assert got["torch"][1][0].startswith(f"encoded 3 frames (1 key) {W}x{H}")
    assert got["torch"][1][1].startswith("decoded 3 frames, Y-PSNR avg")
