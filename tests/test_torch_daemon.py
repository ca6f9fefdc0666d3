"""The port's daemon job path against the JAX package's, on the CPU.

``SpecTorchEngine.transcode`` and ``SpecTpuEngine.transcode`` share one
deterministic stand-in for ``encode_stream`` (payloads hashed from each
frame's planes and the qindex the rate control chose), so the two write
byte-identical Matroska files when their source decode, rate control,
stream copy, timestamps, spool and mux agree.  The JAX engine compiles
nothing here: its ``_prewarm`` is stubbed, and it never encodes.  The
port's real encodes run at 192x128 on the CPU: a reused engine after a
failed job, and one ``run_once`` pass through scan, transcode, size
gate, decode-verify (libaom) and atomic replace.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import time

import numpy as np
import pytest

import av1tpu.daemon.core as jcore
import av1tpu.encoder.ratectrl as jrc
import av1tpu.jobs as jjobs
import av1tpu.media.avdec as javdec
import av1tpu.media.mkv as jmkv
import av1tpu.media.mkv_mux as jmux
import av1tpu.media.probe as jprobe
import av1tpu.media.y4m as jy4m
import av1tpu.utils.testsrc as jtestsrc
import av1tpu_torch.daemon.core as tcore
import av1tpu_torch.encoder.ratectrl as trc
import av1tpu_torch.jobs as tjobs
import av1tpu_torch.media.avdec as tavdec
import av1tpu_torch.media.mkv as tmkv
import av1tpu_torch.media.probe as tprobe
import av1tpu_torch.scan as tscan
import av1tpu_torch.spec_engine as tse
import av1tpu_torch.utils.testsrc as ttestsrc
from av1tpu.spec_engine import SpecTpuEngine
from av1tpu_torch import config as tconfig
from av1tpu_torch.daemon import engine as tengine
from av1tpu_torch.daemon import main as tmain
from av1tpu_torch.spec_engine import SpecTorchEngine

VFR_PTS_MS = [0, 41, 83, 150, 191, 233, 300, 341, 383, 425]
AUDIO_PTS_MS = [0, 21, 42, 63, 84, 105, 126, 147, 168, 189, 210]


def _stub_encode_stream(self, frames, qindex):
    """Deterministic stand-in for encode_stream, shared by both engines:
    the qindex comes from the rate controller when there is one (with
    the lookahead complexity of each frame), the payload is a hash of
    the frame's planes and that qindex, and its length grows with the
    qindex so that the controller's record moves it.  ``fail_after``
    on the engine raises once after that many frames."""
    rate = qindex if hasattr(qindex, "qindex_for") else None
    keyint = max(1, self.cfg.keyint)
    ds = None
    for i, f in enumerate(frames):
        if rate is not None:
            c, ds = type(rate).frame_complexity(f.y, ds)
            q = rate.qindex_for(i, c=c, window=[c])
        else:
            q = int(qindex)
        h = hashlib.sha256(repr((q, f.bit_depth, f.y.shape)).encode())
        for p in (f.y, f.u, f.v):
            h.update(np.ascontiguousarray(p).tobytes())
        payload = h.digest() * (1 + q // 32)
        if rate is not None:
            rate.record(len(payload) * 8 * 400)
        self.stub_q.append(q)
        yield payload, i % keyint == 0
        if getattr(self, "fail_after", None) == i + 1:
            self.fail_after = None
            raise RuntimeError("synthetic interrupt")


def _engines(monkeypatch, keyint=4):
    """One engine of each package with the shared stub encoder (the
    port's is a CPU engine; neither encodes)."""
    monkeypatch.setattr(SpecTpuEngine, "_prewarm",
                        lambda self, *a, **k: None)
    out = {}
    for name, cls, kw in (("jax", SpecTpuEngine, {}),
                          ("torch", SpecTorchEngine, {"device": "cpu"})):
        eng = cls(**kw)
        eng.cfg.keyint = keyint
        eng.stub_q = []
        eng.encode_stream = _stub_encode_stream.__get__(eng)
        out[name] = eng
    return out


def _write_vfr_av_mkv(path, shift_ms):
    """A VFR video track with dummy payloads, an audio track leading it
    by 10 ms and a subtitle, all starting at ``shift_ms``."""
    tracks = [
        jmkv.Track(number=1, uid=1, track_type=jmkv.TRACK_TYPE_VIDEO,
                   codec_id="V_MPEG4/ISO/AVC", width=64, height=64,
                   default_duration_ns=41_666_666),
        jmkv.Track(number=2, uid=2, track_type=jmkv.TRACK_TYPE_AUDIO,
                   codec_id="A_AAC", language="eng"),
        jmkv.Track(number=3, uid=3, track_type=jmkv.TRACK_TYPE_SUBTITLE,
                   codec_id="S_TEXT/UTF8", language="eng"),
    ]
    pkts = [jmkv.Packet(track_number=1,
                        timestamp_ns=(t + shift_ms + 10) * 1_000_000,
                        data=b"\x00" * 16, keyframe=(i == 0),
                        duration_ns=41_666_666)
            for i, t in enumerate(VFR_PTS_MS)]
    pkts += [jmkv.Packet(track_number=2,
                         timestamp_ns=(t + shift_ms) * 1_000_000,
                         data=bytes([i]) * 8, keyframe=True,
                         duration_ns=21_000_000)
             for i, t in enumerate(AUDIO_PTS_MS)]
    pkts.append(jmkv.Packet(track_number=3,
                            timestamp_ns=(shift_ms + 100) * 1_000_000,
                            data=b"subtitle", keyframe=True,
                            duration_ns=1_000_000_000))
    with open(path, "wb") as f:
        w = jmux.MkvWriter(f, tracks)
        for p in sorted(pkts, key=lambda p: p.timestamp_ns):
            w.write_packet(p)
        w.finalize((VFR_PTS_MS[-1] + shift_ms + 60) / 1000.0)


def _fake_frames(frame_cls, n):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (64, 64)).astype(np.uint8)
    for i in range(n):
        yield frame_cls(y=np.roll(base, i, 1),
                        u=np.full((32, 32), 128, np.uint8),
                        v=np.full((32, 32), 128, np.uint8))


def _write_cv2_mp4(path, w, h, n, grain=0):
    """An mp4v MP4 written by OpenCV from testsrc2 (with seeded grain)."""
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (w, h))
    assert vw.isOpened()
    rng = np.random.default_rng(5)
    for i in range(n):
        f = jtestsrc.testsrc2(w, h, i)
        y = np.clip(f.y.astype(np.int32)
                    + rng.integers(-grain, grain + 1, f.y.shape), 0, 255)
        img = cv2.cvtColor(np.concatenate(
            [y.astype(np.uint8), f.u.reshape(-1, w), f.v.reshape(-1, w)]),
            cv2.COLOR_YUV2BGR_I420)
        vw.write(img)
    vw.release()


def _video_payloads(mkv_mod, path):
    with open(path, "rb") as f:
        m = mkv_mod.parse(f)
        v = [t for t in m.tracks if t.codec_id == "V_AV1"][0]
        return v, [bytes(p.data) for p in mkv_mod.iter_packets(f, m)
                   if p.track_number == v.number]


@pytest.mark.parametrize("case", ["vfr_mkv", "vfr_mkv_webrip", "mp4",
                                  "mp4_cv2", "y4m10", "resume"])
def test_transcode_parity_with_jax_engine(tmp_path, monkeypatch, case):
    """Under one stub encoder, both engines write byte-identical .mkv
    files: VFR Matroska with audio and subtitles (webrip off, and on with
    a start shift) and an mp4 decoded natively and through OpenCV (both
    with a duration and a size, so the lookahead rate controller's
    branch, with equal constructor arguments), a 10-bit y4m (no
    duration: a constant qindex), and a failure mid-stream then a
    resume from the spool (each package resuming the other's spool)."""
    engs = _engines(monkeypatch)
    ctor = {}
    for name, mod in (("jax", jrc), ("torch", trc)):
        base = mod.LookaheadRateController

        class Spy(base):
            def __init__(self, *a, _name=name, **k):
                ctor[_name] = (a, k)
                super().__init__(*a, **k)
        monkeypatch.setattr(mod, "LookaheadRateController", Spy)
    webrip = case == "vfr_mkv_webrip"
    if case.startswith("vfr_mkv"):
        src = str(tmp_path / "vfr.mkv")
        _write_vfr_av_mkv(src, 700 if webrip else 0)
        for eng in engs.values():
            frame_cls = (jtestsrc.Frame if isinstance(eng, SpecTpuEngine)
                         else ttestsrc.Frame)
            monkeypatch.setattr(
                eng, "iter_source_frames",
                lambda path, _c=frame_cls: _fake_frames(_c,
                                                        len(VFR_PTS_MS)))
    elif case == "y4m10":
        src = str(tmp_path / "src10.y4m")
        jy4m.write(src, [(f.y, f.u, f.v) for f in
                         (jtestsrc.testsrc2(64, 48, i, bit_depth=10)
                          for i in range(6))], bit_depth=10)
    else:
        src = str(tmp_path / "clip.mp4")
        _write_cv2_mp4(src, 96, 64, 10, grain=4)
        if case == "mp4_cv2":
            monkeypatch.setattr(javdec, "available", lambda: False)
            monkeypatch.setattr(tavdec, "available", lambda: False)
    prs = {"jax": jprobe.probe_file(src), "torch": tprobe.probe_file(src)}
    assert dataclasses.asdict(prs["jax"]) == dataclasses.asdict(prs["torch"])
    outs = {k: str(tmp_path / f"out_{k}.mkv") for k in engs}
    if case == "resume":
        for k, eng in engs.items():
            eng.fail_after = 6
            with pytest.raises(RuntimeError, match="synthetic"):
                eng.transcode(src, outs[k], prs[k], webrip)
            assert not os.path.exists(outs[k])
        spools = [open(outs[k] + ".spool", "rb").read() for k in engs]
        assert spools[0] == spools[1] and len(spools[0]) > 200
        # each package resumes the spool the other wrote
        tmp = outs["jax"] + ".spool.swap"
        os.replace(outs["jax"] + ".spool", tmp)
        os.replace(outs["torch"] + ".spool", outs["jax"] + ".spool")
        os.replace(tmp, outs["torch"] + ".spool")
    for k, eng in engs.items():
        eng.stub_q.clear()
        eng.transcode(src, outs[k], prs[k], webrip)
        assert not os.path.exists(outs[k] + ".spool")
    data = [open(outs[k], "rb").read() for k in ("jax", "torch")]
    assert data[0] == data[1]
    assert engs["torch"].stub_q == engs["jax"].stub_q
    stats = engs["torch"].last_job_stats
    assert stats["encoded_frames"] == engs["jax"].last_job_stats[
        "encoded_frames"]
    assert stats["resumed_frames"] == (6 if case == "resume" else 0)
    assert engs["torch"].stats.frames == engs["jax"].stats.frames
    v, pay = _video_payloads(tmkv, outs["torch"])
    assert len(pay) == stats["encoded_frames"] and v.codec_private
    if case == "y4m10":  # no duration: the constant-qindex branch
        assert not ctor and len(set(engs["torch"].stub_q)) == 1
    else:
        assert set(ctor) == {"jax", "torch"} and ctor["jax"] == ctor["torch"]
        assert len(set(engs["torch"].stub_q)) > 1  # the controller moved q


def _grain_y4m(path, w, h, n, seed=1):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        f = ttestsrc.testsrc2(w, h, i)
        y = np.clip(f.y.astype(np.int32) + rng.integers(-5, 6, f.y.shape),
                    0, 255).astype(np.uint8)
        frames.append((y, f.u, f.v))
    jy4m.write(path, frames)
    return frames


def test_engine_reuse_after_failed_job(tmp_path, monkeypatch):
    """A transcode whose source raises while two chunks are still on the
    dispatch worker leaves nothing behind: the next job on the same
    engine writes the bytes of a fresh engine."""
    real_chunk = tse.encode_chunk

    def slow_chunk(*a, **k):  # keep the chunks in flight
        time.sleep(0.3)
        return real_chunk(*a, **k)
    monkeypatch.setattr(tse, "encode_chunk", slow_chunk)
    cfg = dict(keyint=8, chunk=2)
    src = str(tmp_path / "clip.y4m")
    _grain_y4m(src, 192, 128, 6, seed=2)
    pr = tprobe.probe_file(src)
    eng = SpecTorchEngine(tconfig.TpuEncoderConfig(**cfg), device="cpu")
    bad = _grain_y4m(str(tmp_path / "other.y4m"), 192, 128, 21, seed=9)
    seen = {}

    def failing(path):
        for y, u, v in bad:
            yield ttestsrc.Frame(y=y, u=u, v=v)
        # the 16-frame lookahead has let 5 frames through: a key and
        # two chunks of 2, the last ones still on the worker
        seen["thunks"] = (callable(eng._ref_dev),
                          callable(eng._src_base_dev))
        raise RuntimeError("source read failed")
    monkeypatch.setattr(eng, "iter_source_frames", failing)
    with pytest.raises(RuntimeError, match="source read failed"):
        eng.transcode(src, str(tmp_path / "bad.mkv"), pr, False)
    assert seen["thunks"] == (True, True)
    monkeypatch.delattr(eng, "iter_source_frames")
    eng.transcode(src, str(tmp_path / "reused.mkv"), pr, False)
    fresh = SpecTorchEngine(tconfig.TpuEncoderConfig(**cfg), device="cpu")
    fresh.transcode(src, str(tmp_path / "fresh.mkv"), pr, False)
    reused = open(tmp_path / "reused.mkv", "rb").read()
    assert reused == open(tmp_path / "fresh.mkv", "rb").read()
    assert eng.last_job_stats["encoded_frames"] == 6


def test_run_once_real_pass(tmp_path, monkeypatch):
    """One pass of the port's daemon over a library holding a 10-frame
    192x128 mp4: the job succeeds, the source is replaced by Matroska
    whose every video packet libaom decodes, and the payloads equal a
    direct encode_stream under the same rate controller."""
    from av1tpu.conformance import aomcodec
    if not aomcodec.available():
        pytest.skip("libaom unavailable")
    lib = tmp_path / "library"
    lib.mkdir()
    src = str(lib / "clip.mp4")
    _write_cv2_mp4(src, 192, 128, 10, grain=3)
    keep = str(tmp_path / "clip_copy.mp4")
    shutil.copy(src, keep)
    orig_bytes = os.path.getsize(src)
    real_stable = tscan.check_file_stable
    monkeypatch.setattr(tscan, "check_file_stable",
                        lambda p, w: real_stable(p, 0.01))
    ctor = []

    class Spy(trc.LookaheadRateController):
        def __init__(self, *a, **k):
            ctor.append((a, k))
            super().__init__(*a, **k)
    monkeypatch.setattr(trc, "LookaheadRateController", Spy)
    cfg = tconfig.TranscodeConfig(
        library_roots=[str(lib)], min_bytes=1000,
        job_state_dir=str(tmp_path / "jobs"),
        tpu=tconfig.TpuEncoderConfig(keyint=8))
    res = tmain.run_once(cfg, engine=tengine.make_engine(cfg, device="cpu"))
    assert res.candidates == [src]
    (job,) = tjobs.load_all_jobs(cfg.job_state_dir)
    assert job.status == tjobs.STATUS_SUCCESS, job.reason
    assert job.encoded_frames == 10 and job.new_bytes < orig_bytes
    assert os.path.getsize(src) == job.new_bytes
    with open(src, "rb") as f:
        assert f.read(4) == b"\x1a\x45\xdf\xa3"
    _, pay = _video_payloads(tmkv, src)
    with aomcodec.Decoder() as d:
        for p in pay:
            (img,) = d.decode(p)
            assert img[0].shape == (128, 192)
    (args,) = ctor
    eng = tengine.make_engine(cfg, device="cpu")
    want = [p for p, _ in eng.encode_stream(
        eng.iter_source_frames(keep), trc.LookaheadRateController(
            *args[0], **args[1]))]
    assert pay == want


def test_make_engine_and_self_test(tmp_path):
    """No card: make_engine raises (for either bitstream), and the daemon
    exits 1 rather than encoding on the CPU.  Other encoders raise.  The
    legacy bitstream builds the port's LegacyTorchEngine.  A CPU engine
    asked for explicitly passes the self-test."""
    import torch

    from av1tpu_torch.legacy.engine import LegacyTorchEngine
    cfg = tconfig.TranscodeConfig()
    legacy = tconfig.TranscodeConfig(
        tpu=tconfig.TpuEncoderConfig(bitstream="av1tpu"))
    if not torch.cuda.is_available():
        with pytest.raises(tengine.EngineError, match="cuda"):
            tengine.make_engine(cfg)
        with pytest.raises(tengine.EngineError, match="cuda"):
            tengine.make_engine(legacy)
        lib = tmp_path / "lib"
        lib.mkdir()
        jy4m.write(str(lib / "clip.mkv"), [
            (f.y, f.u, f.v) for f in (jtestsrc.testsrc2(64, 64, 0),)])
        p = tmp_path / "config.json"
        p.write_text(json.dumps({"library_roots": [str(lib)],
                                 "min_bytes": 100,
                                 "job_state_dir": str(tmp_path / "jobs")}))
        assert tmain.main([str(p)]) == 1
        with open(lib / "clip.mkv", "rb") as f:  # source untouched
            assert f.read(9) == b"YUV4MPEG2"
    eng = tengine.make_engine(legacy, device="cpu")
    assert isinstance(eng, LegacyTorchEngine) and eng.device.type == "cpu"
    with pytest.raises(tengine.EngineError, match="unknown encoder"):
        tengine.make_engine(dataclasses.replace(cfg, encoder="vaapi"),
                            device="cpu")
    eng = tengine.make_engine(cfg, device="cpu")
    assert isinstance(eng, SpecTorchEngine) and eng.device.type == "cpu"
    dt = tengine.verify_engine(eng, "64x64")
    assert isinstance(dt, float) and dt > 0


class _FakeEngine:
    def __init__(self, core, out_bytes=100, fail=False):
        self.core, self.out_bytes, self.fail = core, out_bytes, fail

    def transcode(self, input_path, output_path, probe_result,
                  is_webrip_like):
        if self.fail:
            raise self.core.TranscodeError("synthetic failure", exit_code=42)
        with open(output_path, "wb") as f:
            f.write(b"\0" * self.out_bytes)


@pytest.mark.parametrize("outcome", ["success", "size_gate", "failure"])
def test_process_job_lifecycle_matches(tmp_path, outcome):
    """process_job with a fake engine leaves the original's job JSON
    (ids and timestamps aside), sidecars and file state."""
    got = {}
    for name, core, jobs in (("jax", jcore, jjobs), ("torch", tcore, tjobs)):
        d = tmp_path / name
        d.mkdir()
        src = d / "movie.mkv"
        src.write_bytes(b"\1" * 1000)
        job = jobs.new_job(str(src))
        job.original_bytes = 1000
        eng = _FakeEngine(core, out_bytes=950 if outcome == "size_gate"
                          else 500, fail=outcome == "failure")
        cfg = core.DaemonConfig(job_state_dir=str(d / "jobs"),
                                max_size_ratio=0.90,
                                stability_wait_seconds=0.01,
                                decode_verify=False)
        if outcome == "failure":
            with pytest.raises(core.TranscodeError):
                core.process_job(job, eng, None, cfg)
        else:
            core.process_job(job, eng, None, cfg)
        (path,) = [os.path.join(d / "jobs", n)
                   for n in os.listdir(d / "jobs")]
        with open(path) as f:
            rec = json.load(f)
        for k in ("id", "created_at", "started_at", "finished_at"):
            assert rec.pop(k), k
        rec = json.loads(json.dumps(rec).replace(str(d), "<dir>"))
        side = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
                if n != "jobs"}
        got[name] = (rec, side)
    assert got["torch"] == got["jax"]
    rec, side = got["torch"]
    assert rec["status"] == {"success": "success", "size_gate": "skipped",
                             "failure": "failed"}[outcome]
