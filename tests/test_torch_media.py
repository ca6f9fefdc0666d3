"""The port's copies of the daemon's host modules against their originals.

``av1tpu_torch`` keeps its own copies of the container I/O, probe,
classifier, stream plan, job store, sidecars, spool, config and source
decoder of ``av1tpu``.  Each is driven here with the same inputs as its
original and must give the same results: equal dataclasses, equal
bytes on disk.  No JAX program is compiled.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

import av1tpu.classify as jclassify
import av1tpu.config as jconfig
import av1tpu.jobs as jjobs
import av1tpu.media.avdec as javdec
import av1tpu.media.ivf as jivf
import av1tpu.media.mkv as jmkv
import av1tpu.media.mkv_mux as jmux
import av1tpu.media.mp4 as jmp4
import av1tpu.media.probe as jprobe
import av1tpu.media.streamcopy as jsc
import av1tpu.media.y4m as jy4m
import av1tpu.sidecars as jside
import av1tpu.utils.spool as jspool
import av1tpu.encoder.ratectrl as jrc
import av1tpu_torch.classify as tclassify
import av1tpu_torch.config as tconfig
import av1tpu_torch.jobs as tjobs
import av1tpu_torch.media.avdec as tavdec
import av1tpu_torch.media.mkv as tmkv
import av1tpu_torch.media.mkv_mux as tmux
import av1tpu_torch.media.mp4 as tmp4
import av1tpu_torch.media.probe as tprobe
import av1tpu_torch.media.streamcopy as tsc
import av1tpu_torch.sidecars as tside
import av1tpu_torch.utils.spool as tspool
import av1tpu_torch.encoder.ratectrl as trc
from av1tpu.utils import testsrc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _write_av_mkv(mkv, mux, path, chapters=b"", tags=b""):
    """Video, English and Russian audio and a subtitle track, written by
    ``mux`` (the original's writer or the copy)."""
    tracks = [
        mkv.Track(number=1, track_type=mkv.TRACK_TYPE_VIDEO,
                  codec_id="V_MPEG4/ISO/AVC", width=320, height=240,
                  default_duration_ns=41708333,
                  codec_private=b"\x01\x64\x00\x1f\xff\xe1"),
        mkv.Track(number=2, track_type=mkv.TRACK_TYPE_AUDIO,
                  codec_id="A_AAC", language="eng", sample_rate=48000.0,
                  channels=2, codec_private=b"\x11\x90"),
        mkv.Track(number=3, track_type=mkv.TRACK_TYPE_AUDIO,
                  codec_id="A_AC3", language="rus", sample_rate=48000.0,
                  channels=6),
        mkv.Track(number=4, track_type=mkv.TRACK_TYPE_SUBTITLE,
                  codec_id="S_TEXT/UTF8", language="eng"),
    ]
    with open(path, "wb") as f:
        w = mux.MkvWriter(f, tracks, chapters_payload=chapters,
                          tags_payload=tags)
        for i in range(12):
            ts = 700_000_000 + i * 41708333
            w.write_packet(mkv.Packet(1, ts, bytes([i]) * (100 + i),
                                      keyframe=(i % 5 == 0),
                                      duration_ns=41708333))
            w.write_packet(mkv.Packet(2, ts - 10_000_000,
                                      bytes([0x40 + i]) * 20, True))
            w.write_packet(mkv.Packet(3, ts, bytes([0x60 + i]) * 30, True))
        w.write_packet(mkv.Packet(4, 900_000_000, b"Hello subtitle", True,
                                  duration_ns=2_000_000_000))
        w.finalize(1.3)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """One file of each kind the probe dispatches on, under a directory
    whose name carries no classifier token."""
    d = tmp_path_factory.mktemp("m")
    paths = {}
    paths["mkv"] = str(d / "show.mkv")
    _write_av_mkv(jmkv, jmux, paths["mkv"], chapters=b"\x45\xb9\x80",
                  tags=b"\x73\x73\x80")
    cv2 = pytest.importorskip("cv2")
    paths["mp4"] = str(d / "clip.mp4")
    w = cv2.VideoWriter(paths["mp4"], cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                        (96, 64))
    assert w.isOpened()
    for i in range(8):
        f = testsrc.testsrc2(96, 64, i)
        img = cv2.cvtColor(np.concatenate(
            [f.y, f.u.reshape(-1, 96), f.v.reshape(-1, 96)]),
            cv2.COLOR_YUV2BGR_I420)
        w.write(img)
    w.release()
    for bd in (8, 10):
        p = str(d / f"src{bd}.y4m")
        jy4m.write(p, [(f.y, f.u, f.v) for f in
                       (testsrc.testsrc2(64, 48, i, bit_depth=bd)
                        for i in range(3))], fps=(30000, 1001),
                   bit_depth=bd)
        paths[f"y4m{bd}"] = p
    paths["ivf"] = str(d / "s.ivf")
    with open(paths["ivf"], "wb") as f:
        jivf.write_header(f, 64, 48, 24, 1, 3)
        for i in range(3):
            jivf.write_frame(f, bytes([0x12, 0, i]), i)
    return paths


def test_mkv_parse_packets_and_writer_bytes(media, tmp_path):
    """Both parsers read the original writer's file alike, packet by
    packet, and the copied writer writes the same bytes."""
    with open(media["mkv"], "rb") as f:
        jm = jmkv.parse(f)
        jp = list(jmkv.iter_packets(f, jm))
    with open(media["mkv"], "rb") as f:
        tm = tmkv.parse(f)
        tp = list(tmkv.iter_packets(f, tm))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.chapters_payload and tm.tags_payload
    assert [_asdict(p) for p in tp] == [_asdict(p) for p in jp]
    assert len(tp) == 37
    out = str(tmp_path / "copy.mkv")
    _write_av_mkv(tmkv, tmux, out, chapters=b"\x45\xb9\x80",
                  tags=b"\x73\x73\x80")
    with open(out, "rb") as a, open(media["mkv"], "rb") as b:
        assert a.read() == b.read()


def test_mp4_parse_and_packets(media):
    with open(media["mp4"], "rb") as f:
        jm = jmp4.parse(f)
        jp = [[_asdict(p) for p in jmp4.iter_packets(f, jm, t)]
              for t in jm.tracks]
    with open(media["mp4"], "rb") as f:
        tm = tmp4.parse(f)
        tp = [[_asdict(p) for p in tmp4.iter_packets(f, tm, t)]
              for t in tm.tracks]
    assert [_asdict(t) for t in tm.tracks] == [_asdict(t) for t in jm.tracks]
    assert tp == jp and len(tp[0]) == 8


@pytest.mark.parametrize("kind", ["mkv", "mp4", "y4m8", "y4m10", "ivf"])
def test_probe_file_matches(media, kind):
    got = dataclasses.asdict(tprobe.probe_file(media[kind]))
    want = dataclasses.asdict(jprobe.probe_file(media[kind]))
    assert got == want
    assert got["has_video"]


def _classify_cases(d):
    """The path and probe set of tests/test_classify.py."""
    def video(width=1920, height=1080, avg="24/1", r="24/1"):
        return dict(codec_type="video", width=width, height=height,
                    avg_frame_rate=avg, r_frame_rate=r)
    (d / "Movie.BluRay.mkv").write_bytes(b"x")
    (d / "Movie.BluRay.websafe").write_text("")
    (d / "Show.WEB-DL.mp4").write_bytes(b"x")
    (d / "Show.WEB-DL.nowebsafe").write_text("")
    mp4n = "mov,mp4,m4a,3gp,3g2,mj2"
    return [
        ("Show.S01E01.WEB-DL.1080p.mp4", dict(format_name=mp4n), [video()]),
        ("Movie.2020.BluRay.REMUX.mkv",
         dict(format_name="matroska,webm",
              tags={"muxing_app": "libmatroska v1.4.9"}), [video()]),
        ("home_video.mkv", dict(format_name="matroska,webm"), [video()]),
        ("clip.m4v", dict(format_name="matroska,webm"), [video()]),
        ("Movie.BluRay.mkv", dict(format_name="matroska,webm"), [video()]),
        ("Show.WEB-DL.mp4", dict(format_name="mp4"), [video()]),
        ("c.bin", dict(format_name="mp4"), [video(avg="2997/125", r="30/1")]),
        ("c.bin", dict(format_name="matroska,webm"),
         [video(avg="2997/125", r="30/1")]),
        ("c.bin", dict(format_name="mp4"), [video(width=1919, height=801)]),
        ("c.bin", dict(format_name="mp4"), [video(width=2560, height=800)]),
        ("c.bin", dict(format_name="mp4", bit_rate="150000"), [video()]),
        ("c.bin", dict(format_name="mp4", bit_rate="700000"), [video()]),
    ]


def test_classify_web_source_matches(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    for name, fmt, streams in _classify_cases(d):
        path = str(d / name)
        want = jclassify.classify_web_source(
            path, jprobe.FormatInfo(**fmt),
            [jprobe.StreamInfo(**s) for s in streams])
        got = tclassify.classify_web_source(
            path, tprobe.FormatInfo(**fmt),
            [tprobe.StreamInfo(**s) for s in streams])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.is_web_like() == want.is_web_like()


@pytest.mark.parametrize("kind", ["mkv", "mp4"])
def test_plan_streams_and_output_tracks(media, kind):
    jp = jsc.plan_streams(jprobe.probe_file(media[kind]))
    tp = tsc.plan_streams(tprobe.probe_file(media[kind]))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    jt = jsc.output_tracks(jp, 320, 240, 41708333)
    tt = tsc.output_tracks(tp, 320, 240, 41708333)
    assert [_asdict(t) for t in tt] == [_asdict(t) for t in jt]
    if kind == "mkv":  # the Russian track is pruned
        assert [t.codec_id for t in tt] == ["V_AV1", "A_AAC", "S_TEXT/UTF8"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spool_bytes_and_cross_resume(tmp_path, writer):
    """Spool files are byte-identical, and a spool written by one
    package (with a torn tail) resumes under the other."""
    sig = {"bytes": 123, "mtime_ns": 456}
    paths = {}
    for name, mod in (("jax", jspool), ("torch", tspool)):
        p = str(tmp_path / f"{name}.spool")
        w = mod.SpoolWriter(p, sig, 96, 320, 240)
        w.append(b"frame-0", True)
        w.append(b"frame-1" * 9, False)
        w.flush()
        w.close()
        a = mod.SpoolAppender(p)
        a.append(b"frame-2", True)
        a.close()
        paths[name] = p
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        raw = a.read()
        assert raw == b.read()
    with open(paths[writer], "ab") as f:
        f.write(raw[-5:])  # a torn record
    reader = tspool if writer == "jax" else jspool
    got = reader.read_spool(paths[writer], sig, 96, 320, 240)
    assert got == [(b"frame-0", True), (b"frame-1" * 9, False),
                   (b"frame-2", True)]
    assert reader.read_spool(paths[writer], sig, 80, 320, 240) is None
    assert tspool.source_signature(paths["jax"]) == \
        jspool.source_signature(paths["jax"])


def test_save_job_and_sidecars(tmp_path):
    """Job JSON and the three sidecar texts are byte-identical."""
    files = {}
    for name, jobs, side, cls in (("jax", jjobs, jside, jclassify),
                                  ("torch", tjobs, tside, tclassify)):
        d = tmp_path / name
        (d / "jobs").mkdir(parents=True)
        src = str(d / "Movie.mkv")
        with open(src, "wb") as f:
            f.write(b"x" * 10)
        job = jobs.new_job(src)
        job.id = "0000-1111"
        job.created_at = "2026-01-02T03:04:05+00:00"
        job.status = jobs.STATUS_SUCCESS
        job.original_bytes, job.new_bytes = 1000, 512
        job.encoded_frames, job.encode_fps = 9, 1.25
        job.resolution, job.bit_depth = "1920x1080", 8
        jobs.save_job(job, str(d / "jobs"))
        side.write_why_file(src, "size gate: new 1.0 MB vs orig 1.1 MB")
        side.write_skip_marker(src)
        side.write_classification_info(src, cls.WebSourceDecision(
            cls.SOURCE_WEB_LIKE, 7.5, ["filename token: web-dl", "ext"]))
        loaded = jobs.load_all_jobs(str(d / "jobs"))
        assert [j.id for j in loaded] == ["0000-1111"]
        assert side.has_skip_marker(src)
        out = {}
        for dp, _, names in os.walk(d):
            for n in names:
                p = os.path.join(dp, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, d)] = f.read()
        files[name] = out
    # the job JSON and the classification record name the file by path
    assert files["torch"] == {
        k: v.replace(b"/jax/", b"/torch/") for k, v in files["jax"].items()}
    assert len(files["jax"]) == 5


def _configs():
    with open(os.path.join(REPO, "install", "install.sh")) as f:
        sh = f.read()
    body = re.search(r'cat > "\$CONFIG_DIR/config.json" <<EOF\n(.*?)\nEOF',
                     sh, re.S).group(1)
    install = body.replace("$DATA_DIR", "/var/lib/av1qsvd")
    return {
        "reference": json.dumps({
            "ffmpeg_url": "https://example/ffmpeg.tar.xz",
            "ffmpeg_install_dir": "/usr/local/ff",
            "library_roots": ["/media/tv", "/media/movies"],
            "min_bytes": 2147483648, "max_size_ratio": 0.90,
            "job_state_dir": "/var/lib/av1qsvd/jobs",
            "scan_interval_sec": 60}),
        "tpu_keys": json.dumps({
            "library_roots": ["/m"], "encoder": "tpu",
            "tpu": {"keyint": 60, "num_chips": 4, "unknown_key": 1}}),
        "install_sh": install,
        "not_an_object": "[1, 2]",
        "not_json": "{",
    }


@pytest.mark.parametrize("name", sorted(_configs()))
def test_load_config_matches(tmp_path, name):
    p = str(tmp_path / "config.json")
    with open(p, "w") as f:
        f.write(_configs()[name])
    try:
        want = jconfig.load_config(p).to_dict()
    except (ValueError, json.JSONDecodeError) as e:
        with pytest.raises(type(e)):
            tconfig.load_config(p)
        want = None
    if want is not None:
        got = tconfig.load_config(p)
        assert got.to_dict() == want
        assert dataclasses.asdict(got.tpu) == want["tpu"]
    got = tconfig.load_config_or_default(p).to_dict()
    assert got == jconfig.load_config_or_default(p).to_dict()
    assert tconfig.default_config().to_dict() == \
        jconfig.default_config().to_dict()
    assert tconfig.CONFIG_PATH == jconfig.CONFIG_PATH


def test_ratectrl_ladder_and_estimate(media):
    for h in (480, 720, 1079, 1080, 1440, 2160):
        q = trc.determine_quality(h)
        assert q == jrc.determine_quality(h)
        assert trc.quality_to_qindex(q) == jrc.quality_to_qindex(q)
    for q in (0, 23, 24, 25, 30, 70):
        assert trc.quality_to_qindex(q) == jrc.quality_to_qindex(q)
        assert trc.bits_per_pixel_per_frame(q) == \
            jrc.bits_per_pixel_per_frame(q)
    for kind in ("mkv", "mp4", "y4m8"):
        size = os.path.getsize(media[kind])
        assert trc.estimate_output_size(
            size, tprobe.probe_file(media[kind]), 24) == \
            jrc.estimate_output_size(size, jprobe.probe_file(media[kind]), 24)


@pytest.mark.skipif(not (javdec.available() and tavdec.available()),
                    reason="libavcodec decoder unavailable")
def test_avdec_planes_match(media):
    """The copy's decoder, built from its own sources into the port's
    build directory, decodes the mp4 to the original's planes."""
    assert os.path.dirname(tavdec._build()) == os.path.join(
        REPO, "av1tpu_torch", "_build")
    with javdec.SourceDecoder(media["mp4"]) as a, \
            tavdec.SourceDecoder(media["mp4"]) as b:
        assert (b.width, b.height, b.bit_depth, b.frame_rate) == \
            (a.width, a.height, a.bit_depth, a.frame_rate)
        fa, fb = list(a), list(b)
    assert len(fb) == len(fa) == 8
    for x, y in zip(fa, fb):
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(y, p), getattr(x, p))
        assert (y.bit_depth, y.pts_ns) == (x.bit_depth, x.pts_ns)
