"""The port's operator surfaces against the JAX package's: the av1top
dashboard, the doctor, encode_clip, quality, and the libaom encoder
half of ``conformance/aomcodec.py``.

No JAX program is compiled here: the JAX package is called for host
code only (its dashboard view, the doctor's config checks, quality's
metrics, its libaom binding).  The port's tools run on the CPU with
``--cpu``; without it and without a card they must fail and name the
missing card.  Equalities are exact: rendered lines, printed lines,
PSNR/SSIM floats, decoded planes.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import test_tui
from av1tpu.conformance import aomcodec as j_aom
from av1tpu.tools import doctor as j_doctor
from av1tpu.tools import quality as j_quality
from av1tpu.tui import metrics as j_metrics
from av1tpu.tui import model as j_model
from av1tpu.tui import view as j_view
from av1tpu_torch.conformance import aomcodec
from av1tpu_torch.media import ivf, y4m
from av1tpu_torch.specav1 import decoder
from av1tpu_torch.tools import doctor, encode_clip, quality
from av1tpu_torch.tui import main as tui_main
from av1tpu_torch.tui import metrics, model, view
from av1tpu_torch.utils import testsrc

torch.set_num_threads(1)


def _run(fn, *a):
    """(return value, stdout lines, stderr) of fn(*a)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rv = fn(*a)
    return rv, out.getvalue().splitlines(), err.getvalue()


# --- av1top -----------------------------------------------------------------

class _FixedNow:
    """datetime with a frozen now(): both renders see the same elapsed
    time for the running job."""

    real = view.datetime

    @classmethod
    def fromisoformat(cls, s):
        return cls.real.fromisoformat(s)

    @classmethod
    def now(cls, tz=None):
        return cls.real(2026, 6, 1, 12, 0, 0, tzinfo=tz)


def test_dashboard_renders_the_jax_package_view(tmp_path, monkeypatch):
    """A job directory written by the JAX package's job store renders in
    both dashboards line for line alike, the title and the accelerator
    line aside; the accelerator line shows the card's memory and name."""
    d = test_tui._seed_jobs(tmp_path)
    monkeypatch.setattr(view, "datetime", _FixedNow)
    monkeypatch.setattr(j_view, "datetime", _FixedNow)
    common = dict(cpu_percent=42.0, mem_percent=61.0, mem_used_gb=9.8,
                  mem_total_gb=16.0)
    jm = j_model.Model(jobs_dir=d, with_tpu=False)
    jm.refresh_jobs()
    jm.metrics = j_metrics.SystemMetrics(
        tpu_percent=37.5, tpu_kind="TPU v5 lite", tpu_count=1,
        tpu_hbm_used_gb=6.0, tpu_hbm_total_gb=16.0, **common)
    pm = model.Model(jobs_dir=d, with_gpu=False)
    pm.refresh_jobs()
    pm.metrics = metrics.SystemMetrics(
        gpu_percent=37.5, gpu_name="NVIDIA H100 80GB HBM3", gpu_count=1,
        gpu_mem_used_gb=6.0, gpu_mem_total_gb=16.0, **common)
    want = j_view.render(jm, width=100)
    got = view.render(pm, width=100)
    assert len(got) == len(want) and len(got) > 20
    accel = 4
    assert want[accel].startswith("  TPU  [")
    for i, (a, b) in enumerate(zip(want, got)):
        if i not in (0, accel):
            assert a == b, (i, a, b)
    assert got[0].startswith("═══ av1tpu_torch ") and len(got[0]) == 100
    assert got[accel] == ("  GPU  [" + view.render_bar(37.5) + "]  37.5%"
                          "  MEM (6.0/16.0 GB)  1x NVIDIA H100 80GB HBM3")
    assert "success 1" in "\n".join(got) and "1.9 GB" in "\n".join(got)


def test_gpu_reader_never_raises(monkeypatch):
    """read_gpu and collect never raise: with this machine's cards, with
    device enumeration raising, and with mem_get_info raising (the
    enumeration rung: name and count, no memory)."""
    n = torch.cuda.device_count()
    got = metrics.read_gpu()
    assert got[2] == n
    m = metrics.collect()
    assert m.gpu_count == n and m.mem_total_gb > 0
    if not n:
        assert got == (0.0, "", 0, 0.0, 0.0)
        pm = model.Model(jobs_dir="/nonexistent")
        pm.refresh()
        assert view.render_metrics(pm)[-1] == \
            "  GPU  [" + "░" * view.BAR_WIDTH + "]   n/a  (no device)"

    def boom(*a, **k):
        raise RuntimeError("CUDA error: unknown error")

    monkeypatch.setattr(torch.cuda, "device_count", boom)
    assert metrics.read_gpu() == (0.0, "", 0, 0.0, 0.0)
    assert metrics.collect().gpu_count == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "mem_get_info", boom)
    assert metrics.read_gpu() == (0.0, "card", 2, 0.0, 0.0)


def test_dashboard_once_prints_the_job_queue(tmp_path, capsys):
    """``python -m av1tpu_torch.tui.main cfg.json --once`` prints one
    frame of a job directory the JAX package wrote."""
    d = test_tui._seed_jobs(tmp_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"job_state_dir": d}))
    assert tui_main.main([str(cfg), "--once"]) == 0
    out = capsys.readouterr().out
    assert "JOB QUEUE" in out and "Movie.One.2021.mkv" in out
    assert "pending 3  running 1  success 1" in out


# --- doctor -----------------------------------------------------------------

def _config_file(tmp_path, kind):
    """A valid config, an unreadable one, or one whose job directory
    cannot be created (a path through a regular file)."""
    p = tmp_path / "cfg.json"
    lib = tmp_path / "lib"
    if kind == "unreadable":
        p.write_text("{not json")
        return str(p)
    jobs_dir = tmp_path / "jobs"
    if kind == "unwritable":
        (tmp_path / "afile").write_text("x")
        jobs_dir = tmp_path / "afile" / "jobs"
    p.write_text(json.dumps({"library_roots": [str(lib)],
                             "job_state_dir": str(jobs_dir),
                             "min_bytes": 1000}))
    return str(p)


@pytest.mark.parametrize("kind", ["valid", "unreadable", "unwritable"])
def test_doctor_config_checks_print_the_jax_package_lines(tmp_path, kind,
                                                          monkeypatch):
    """check_config, check_write_access and check_unit_paths print and
    return what the JAX package's do (the unreadable config leaves the
    defaults in effect, whose directories live under HOME)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    path = _config_file(tmp_path, kind)
    results = []
    for mod in (j_doctor, doctor):
        cfg_rv, cfg_out, _ = _run(mod.check_config, path)
        wr_rv, wr_out, _ = _run(mod.check_write_access, cfg_rv)
        up_rv, up_out, _ = _run(mod.check_unit_paths, cfg_rv)
        results.append((cfg_rv.to_dict(), cfg_out, wr_rv, wr_out, up_rv,
                        up_out))
    assert results[0] == results[1]
    cfg_out, wr_out = results[1][1], results[1][3]
    assert cfg_out[0].startswith(
        "[OK  ] config" if kind != "unreadable" else "[warn] config")
    assert results[1][2] is (kind != "unwritable")
    assert any(ln.startswith("[FAIL]") for ln in wr_out) is \
        (kind == "unwritable")


def test_doctor_fails_without_a_card(tmp_path):
    """No --cpu and no card: the encode smoke fails, naming the missing
    card, and the doctor exits 1; nothing encodes on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rv, out, _ = _run(doctor.main, [_config_file(tmp_path, "valid")])
    assert rv == 1 and out[-1] == "RESULT: NOT healthy"
    smoke = [ln for ln in out if "encode smoke" in ln]
    assert len(smoke) == 1 and smoke[0].startswith("[FAIL]")
    assert "no CUDA device" in smoke[0]
    assert "[warn] accelerator: torch reports no CUDA device" in out


def test_doctor_cpu_flag_is_healthy(tmp_path):
    """``doctor cfg.json --cpu``: every check passes, the smoke encodes a
    320x192 keyframe on the CPU in the default config."""
    rv, out, _ = _run(doctor.main, [_config_file(tmp_path, "valid"),
                                    "--cpu"])
    assert rv == 0 and out[-1] == "RESULT: healthy", out
    smoke = [ln for ln in out if "encode smoke" in ln]
    assert smoke[0].startswith("[OK  ] encode smoke: ")
    assert "320x192 keyframe on cpu" in smoke[0]
    assert any(ln.startswith("[OK  ] native entropy library: libav1ec_")
               for ln in out)


# --- encode_clip and quality ---------------------------------------------------

W, H, N = 64, 64, 3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """encode_clip --cpu --verify at 64x64, 3 frames: (IVF path, the
    tool's output lines, the TUs, the source frames)."""
    d = tmp_path_factory.mktemp("clip")
    out = str(d / "clip.ivf")
    rv, lines, _ = _run(encode_clip.main,
                        ["--cpu", "--width", str(W), "--height", str(H),
                         "--frames", str(N), "--out", out, "--verify"])
    assert rv == 0
    with open(out, "rb") as f:
        hdr = ivf.read_header(f)
        tus = [tu for tu, _ in ivf.iter_frames(f)]
    assert (hdr["width"], hdr["height"], hdr["num_frames"]) == (W, H, N)
    return out, lines, tus, [testsrc.testsrc2(W, H, i) for i in range(N)]


def test_encode_clip_ivf_decodes_in_port_decoder_and_libaom(clip):
    """The IVF holds N temporal units, each a temporal delimiter and a
    frame (the key's carrying the sequence header); the port's spec
    decoder decodes them, and libaom to the same planes where present;
    --verify's PSNR line is the decoder's."""
    from av1tpu_torch.specav1 import obu
    _, lines, tus, frames = clip
    assert len(tus) == N
    for i, tu in enumerate(tus):
        types = [o.type for o in obu.parse_obus(tu)]
        assert types == ([obu.OBU_TEMPORAL_DELIMITER] +
                         [obu.OBU_SEQUENCE_HEADER] * (i == 0) +
                         [obu.OBU_FRAME])
    assert lines[0].startswith(f"encoded {N} frames (1 key) {W}x{H} q=96")
    dec = decoder.decode_stream(tus)
    assert len(dec) == N
    ps = [quality.psnr(f.y, d[0]) for f, d in zip(frames, dec)]
    assert lines[1] == (f"decoded {N} frames, Y-PSNR avg "
                        f"{sum(ps) / N:.2f} dB (min {min(ps):.2f}, "
                        f"max {max(ps):.2f})")
    assert min(ps) > 30
    if aomcodec.available():
        ref = aomcodec.decode_stream(tus)
        assert len(ref) == N
        for d, r in zip(dec, ref):
            for pl in range(3):
                np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                              np.asarray(r[pl], np.int64))


def test_encode_clip_fails_without_a_card(tmp_path):
    """No --cpu and no card: exit code 1 and a message naming the
    missing card; no file is encoded."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = tmp_path / "x.ivf"
    rv, lines, err = _run(encode_clip.main,
                          ["--width", "64", "--height", "64", "--frames",
                           "2", "--out", str(out)])
    assert rv == 1 and not lines and not out.exists()
    assert "no CUDA device" in err


@pytest.mark.parametrize("bd", [8, 10])
def test_quality_metrics_equal_jax_package(bd):
    """psnr and ssim: the JAX package's floats, bit for bit."""
    rng = np.random.default_rng(11 + bd)
    top = (1 << bd) - 1
    a = rng.integers(0, top + 1, (72, 100))
    b = np.clip(a + rng.integers(-9, 10, a.shape), 0, top)
    for x, y in ((a, b), (a, a)):
        assert quality.psnr(x, y, top) == j_quality.psnr(x, y, top)
        assert quality.ssim(x, y, top) == j_quality.ssim(x, y, top)


def test_quality_json_line_for_y4m_against_ivf(clip, tmp_path):
    """quality --ref src.y4m --dist clip.ivf: the JSON line holds the
    PSNR and SSIM of the spec decoder's planes against the source."""
    path, _, tus, frames = clip
    src = str(tmp_path / "src.y4m")
    y4m.write(src, [(f.y, f.u, f.v) for f in frames])
    rv, lines, _ = _run(quality.main, ["--ref", src, "--dist", path])
    assert rv == 0 and len(lines) == 1
    got = json.loads(lines[0])
    dec = decoder.decode_stream(tus)
    per = [{"psnr": round(quality.psnr(f.y, d[0]), 3),
            "ssim": round(quality.ssim(f.y, d[0]), 5)}
           for f, d in zip(frames, dec)]
    assert got == {
        "frames": N,
        "y_psnr": round(sum(p["psnr"] for p in per) / N, 3),
        "y_ssim": round(sum(p["ssim"] for p in per) / N, 5),
        "per_frame": per}


# --- the libaom encoder half ------------------------------------------------

@pytest.fixture()
def aom():
    if not aomcodec.available():
        pytest.skip("system libaom not present")
    return aomcodec


def _gradient_frames(w, h, n):
    yy, xx = np.mgrid[0:h, 0:w]
    return [(((xx + yy + 10 * i) % 256).astype(np.uint8),
             np.full((h // 2, w // 2), 100 + i, np.uint8),
             np.full((h // 2, w // 2), 180 - i, np.uint8))
            for i in range(n)]


def test_aom_encoder_calibration_matches_jax_package(aom):
    """The encoder-config layout found by calibration is the JAX
    package's, and has the documented fields."""
    enc = aom._calibrate_enc_cfg()
    assert dataclasses.asdict(enc) == \
        dataclasses.asdict(j_aom._calibrate_enc_cfg())
    assert enc.g_w > 0 and enc.g_timebase > 0
    assert enc.rc_end_usage > 0 and enc.rc_target_bitrate > 0
    assert enc.g_lag_in_frames > 0


@pytest.mark.parametrize("case", ["8bit", "10bit", "odd"])
def test_aom_encoder_roundtrip_matches_jax_package(aom, case):
    """encode_frames gives the JAX package's binding's bytes, and the
    stream decodes to frames of the right shape and depth near the
    source (the oracle cases: 8-bit, 10-bit, odd dimensions)."""
    if case == "10bit":
        w, h, bd, cq = 96, 64, 10, 10
        yy, xx = np.mgrid[0:h, 0:w]
        frames = [(((xx * 8 + yy * 4) % 1024).astype(np.uint16),
                   np.full((h // 2, w // 2), 512, np.uint16),
                   np.full((h // 2, w // 2), 700, np.uint16))]
    else:
        w, h = (192, 128) if case == "8bit" else (130, 98)
        bd, cq = 8, 20
        frames = _gradient_frames(w, h, 3 if case == "8bit" else 1)
    kw = dict(bit_depth=bd, cq_level=cq, cpu_used=8)
    tus = aom.encode_frames(frames, w, h, **kw)
    assert tus == j_aom.encode_frames(frames, w, h, **kw)
    assert len(tus) == len(frames)
    dec = aom.decode_stream(tus)
    assert len(dec) == len(frames)
    y, u, v, got_bd = dec[0]
    assert y.shape == (h, w) and u.shape == ((h + 1) // 2, (w + 1) // 2)
    assert got_bd == bd
    tol = 8.0 if bd > 8 else 2.0
    assert np.abs(y.astype(int) - frames[0][0].astype(int)).mean() < tol


def test_aom_keyframe_replays_in_port_decoder(aom):
    """A libaom keyframe (tools outside the spec decoder's scope off)
    decodes in the port's spec decoder to libaom's own planes."""
    from test_replay_foreign import OPTS, _frames
    w, h = 192, 120
    (y, u, v), = _frames(w, h, 1, motion=(0, 0), noise=0)
    with aom.Encoder(w, h, cpu_used=9, cq_level=96, threads=1,
                     kf_max_dist=9999) as enc:
        assert all(enc.set_options(OPTS).values())
        tus = enc.encode(y, u, v) + enc.flush()
    ref = aom.decode_stream(tus)
    got = decoder.decode_stream(tus)
    assert len(got) == len(ref) == 1
    for pl in range(3):
        np.testing.assert_array_equal(np.asarray(got[0][pl], np.int64),
                                      np.asarray(ref[0][pl], np.int64))

