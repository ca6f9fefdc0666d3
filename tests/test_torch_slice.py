"""PyTorch port (av1tpu_torch) vs the JAX package: the P-frame encoder.

Both packages encode the same seeded numpy frames from the same numpy
reference planes (handed to the port through state_from_numpy).  The
expectation is exact; where the reference decides in float32 (forward
transforms, keyframe mode RD) a summation-order near-tie may flip a
decision, so the tests require that at least 99% of blocks agree on
every decision and level, and that agreeing blocks reconstruct
identically.  At these sizes 99% means every block.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.specav1 import jax_inter
from av1tpu.utils import testsrc
from av1tpu_torch.spec_engine import state_from_numpy
from av1tpu_torch.specav1 import torch_inter

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grainy_planes(w, h, i, rng, bd=8):
    """testsrc2 + seeded grain, SB-padded like the engine pads."""
    f = testsrc.testsrc2(w, h, i, bit_depth=bd)
    mx = (1 << bd) - 1
    y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape), 0, mx)
    ph, pw = (h + 63) & ~63, (w + 63) & ~63
    dt = np.uint8 if bd == 8 else np.uint16
    return tuple(np.pad(p, ((0, (ph - h) // s), (0, (pw - w) // s)),
                        mode="edge").astype(dt)
                 for p, s in ((y, 1), (f.u, 2), (f.v, 2)))


def block_agreement(ref, got, grids, luma, chroma, gh, gw):
    """Fraction of the gh x gw 32x32 blocks on which every grid entry
    (indices ``grids``, arrays with the block index first or (gh, gw)
    leading) and every pixel of the luma/chroma planes (indices
    ``luma``/``chroma``) agree."""
    nb = gh * gw
    ok = np.ones(nb, bool)
    for i in grids:
        a, b = np.asarray(ref[i]).reshape(nb, -1), got[i].reshape(nb, -1)
        ok &= (a == b).all(1)
    for idx, n in ((luma, 32), (chroma, 16)):
        for i in idx:
            eq = (np.asarray(ref[i]) == got[i])[:gh * n, :gw * n]
            ok &= eq.reshape(gh, n, gw, n).all((1, 3)).reshape(-1)
    return ok.mean()


@pytest.mark.parametrize("w,h,bd,q", [(128, 64, 8, 96), (128, 144, 8, 96),
                                      (128, 64, 10, 255)])
def test_inter_frame_matches_jax(w, h, bd, q):
    """P-frame encoder, all 16 outputs, from the same reference planes:
    144 rows take the 16px bottom-strip path; 10-bit at qindex 255 runs
    the int32 RD costs at their largest."""
    rng = np.random.default_rng(1)
    ref = [p.astype(np.int32) for p in grainy_planes(w, h, 0, rng, bd)]
    src = grainy_planes(w, h, 3, rng, bd)
    want = jax_inter._encode_frame(*(jnp.asarray(p) for p in src),
                                   *(jnp.asarray(p) for p in ref), q, bd,
                                   th=h, tw=w)
    dt = np.uint8 if bd == 8 else np.int16
    got = torch_inter.encode_frame(
        *(torch.from_numpy(p.astype(dt)) for p in src),
        *state_from_numpy(*ref, "cpu"), q, bd, th=h, tw=w)
    got = [t.numpy() for t in got]
    assert len(got) == len(want) == 16
    for a, b in zip(want, got):
        assert np.asarray(a).shape == b.shape
    # (mv, skip, split, mv16, skip16) grids; lv/rec planes
    ph, pw = src[0].shape
    assert block_agreement(want, got, (0, 1, 11, 12, 13), (2, 5),
                           (3, 4, 6, 7), ph // 32, pw // 32) >= 0.99
    for i in (8, 9, 10, 14, 15):   # strip, cdefs, lr, refsel, lr taps
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    assert (got[0] != 0).any(), "no motion found: test content too flat"


def test_port_imports_no_jax():
    """A tiny CPU encode through av1tpu_torch loads no jax module."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from av1tpu_torch.config import TpuEncoderConfig\n"
        "from av1tpu_torch.utils.testsrc import testsrc2\n"
        "from av1tpu_torch.spec_engine import SpecTorchEngine\n"
        "cfg = TpuEncoderConfig(chunk=1, golden=False, cdef=False, "
        "lr=False)\n"
        "eng = SpecTorchEngine(cfg, device='cpu')\n"
        "fr = [testsrc2(64, 64, i) for i in range(2)]\n"
        "fr = [type(f)(y=np.clip(f.y.astype(int) + "
        "np.random.default_rng(i).integers(-6, 7, f.y.shape), 0, 255)"
        ".astype(np.uint8), u=f.u, v=f.v) for i, f in enumerate(fr)]\n"
        "out = list(eng.encode_stream(fr, 96))\n"
        "assert len(out) == 2 and out[0][1] and not out[1][1]\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")


def test_port_encode_decode_loads_no_av1tpu():
    """A clean 64x64 key + P encode on the CPU with golden on (two
    references, loop filter on), decoded by the port's own spec decoder,
    and one pass of the port's daemon (``run_once``: scan, probe,
    transcode, size gate, decode-verify, atomic replace) over a library
    holding a 64x64 y4m stream named ``.mkv``, load neither jax nor any
    module of av1tpu; nor do the operator tools, the dashboard, the
    libaom binding and the host reference encoder, which no entry point
    reaches."""
    code = (
        "import os, sys, tempfile\n"
        "import numpy as np\n"
        "from av1tpu_torch.config import TpuEncoderConfig\n"
        "from av1tpu_torch.spec_engine import SpecTorchEngine\n"
        "from av1tpu_torch.specav1 import decoder\n"
        "from av1tpu_torch.utils.cleansrc import clean_frame\n"
        "eng = SpecTorchEngine(TpuEncoderConfig(chunk=1, golden=True, "
        "cdef=False, lr=False), device='cpu')\n"
        "fr = [clean_frame(64, 64, i) for i in range(2)]\n"
        "out = list(eng.encode_stream(fr, 96))\n"
        "assert eng._gop_deblock and eng._golden_dev is not None\n"
        "dec = decoder.decode_stream([p for p, _ in out])\n"
        "assert [k for _, k in out] == [True, False] and len(dec) == 2\n"
        "for d, r in zip(dec[1], eng._ref):\n"
        "    assert np.array_equal(d, r[:d.shape[0], :d.shape[1]])\n"
        "from av1tpu_torch import config, jobs, scan\n"
        "from av1tpu_torch.daemon import engine as E, main as M\n"
        "from av1tpu_torch.media import y4m\n"
        "stable = scan.check_file_stable\n"
        "scan.check_file_stable = lambda p, w: stable(p, 0.01)\n"
        "d = tempfile.mkdtemp()\n"
        "os.mkdir(os.path.join(d, 'lib'))\n"
        "src = os.path.join(d, 'lib', 'clip.mkv')\n"
        "y4m.write(src, [(f.y, f.u, f.v) for f in fr])\n"
        "cfg = config.TranscodeConfig(library_roots=[os.path.join(d, "
        "'lib')], min_bytes=1000, job_state_dir=os.path.join(d, 'jobs'))\n"
        "M.run_once(cfg, engine=E.make_engine(cfg, device='cpu'))\n"
        "(job,) = jobs.load_all_jobs(cfg.job_state_dir)\n"
        "assert job.status == 'success' and job.encoded_frames == 2, "
        "job.reason\n"
        "assert open(src, 'rb').read(4) == b'\\x1a\\x45\\xdf\\xa3'\n"
        "from av1tpu_torch.tools import doctor, encode_clip, quality\n"
        "from av1tpu_torch.tui import main, metrics\n"
        "metrics.collect()\n"
        "assert 'av1tpu_torch.specav1.encode' not in sys.modules\n"
        "from av1tpu_torch.conformance import aomcodec\n"
        "from av1tpu_torch.specav1 import encode\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'av1tpu') or "
        "m.startswith(('jax.', 'av1tpu.')))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")


def _port_sources():
    root = os.path.join(REPO, "av1tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "k1bench.py"),
           os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for d, _, names in os.walk(root):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_no_av1tpu(path):
    """No file of the port, nor chip_smoke.py or k1bench.py, nor the
    card-only tests, imports jax or av1tpu (statically, at any depth)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for nm in names:
            top = nm.split(".")[0]
            assert top not in ("av1tpu", "jax"), \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {nm}"



def test_host_reference_encoder_is_imported_by_no_port_module():
    """specav1/encode.py is a test reference: no file of the port (nor
    chip_smoke.py or k1bench.py) imports it, so no entry point reaches
    it and nothing falls back to it."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
                names.append(node.module or "")
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert "av1tpu_torch.specav1.encode" not in names, \
                f"{os.path.relpath(path, REPO)}:{node.lineno}"

def test_engine_rejects_unported_config():
    """golden, CDEF and LR are accepted, alone and together, and so are
    the daemon's defaults themselves (chunk=8, delta_upload): they
    construct and encode a key and a full chunk of 8, and the frame
    header carries the searched CDEF strengths.  Several devices are
    accepted too (the stripe group: num_chips on the CPU, or explicit
    stripe devices); a stripe device that does not exist raises, and so
    does the retired bitstream, which is not ported."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.specav1 import headers, obu
    ok = dict(chunk=1, golden=True, cdef=False, lr=False)
    eng = SpecTorchEngine(TpuEncoderConfig(**ok), device="cpu")
    assert eng._golden and not eng._cdef and not eng._lr
    assert not SpecTorchEngine(TpuEncoderConfig(**{**ok, "golden": False}),
                               device="cpu")._golden
    for kw in (dict(cdef=True), dict(lr=True)):
        e = SpecTorchEngine(TpuEncoderConfig(**{**ok, **kw}), device="cpu")
        assert (e._cdef, e._lr) == (kw.get("cdef", False),
                                    kw.get("lr", False))
    eng = SpecTorchEngine(TpuEncoderConfig(chunk=1), device="cpu")
    assert eng._golden and eng._cdef and eng._lr
    rng = np.random.default_rng(3)
    f = testsrc.testsrc2(64, 64, 0)
    f.y[:] = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                     0, 255)
    eng.start_stream()
    pend = eng._submit(f, 96, is_key=True)
    tu = eng._finalize(pend)[0]
    obus = list(obu.parse_obus(tu))
    seq = headers.parse_sequence_header(obus[0].payload)
    hdr = headers.parse_frame_header(obus[1].payload, seq)
    c = hdr.cdef
    assert seq.enable_cdef and seq.enable_restoration
    assert [c.y_pri[0], c.y_sec[0], c.uv_pri[0], c.uv_sec[0]] == \
        pend[11][16].tolist()
    cpu = torch.device("cpu")
    assert SpecTorchEngine(TpuEncoderConfig(**ok), device="cpu")._group == ()
    assert SpecTorchEngine(TpuEncoderConfig(**{**ok, "num_chips": 2}),
                           device="cpu")._group == (cpu, cpu)
    assert SpecTorchEngine(TpuEncoderConfig(**ok), device="cpu",
                           stripe_devices=("cpu",) * 3)._group == (cpu,) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpecTorchEngine(TpuEncoderConfig(**ok), device="cpu",
                            stripe_devices=("cpu", "cuda"))
    with pytest.raises(NotImplementedError, match="bitstream"):
        SpecTorchEngine(TpuEncoderConfig(**{**ok, "bitstream": "av1tpu"}),
                        device="cpu")
    # the defaults: chunked dispatch with packed upload
    eng = SpecTorchEngine(TpuEncoderConfig(), device="cpu")
    assert eng.cfg.chunk == 8 and eng._delta_upload
    chunks = []
    submit = eng._submit_chunk
    eng._submit_chunk = lambda fr, qs: chunks.append(len(fr)) or submit(fr,
                                                                        qs)
    frames = [testsrc.testsrc2(64, 64, i) for i in range(9)]
    out = list(eng.encode_stream(frames, 96))
    assert [k for _, k in out] == [True] + [False] * 8 and chunks == [8]
    obus = list(obu.parse_obus(out[-1][0]))
    hdr = headers.parse_frame_header(obus[0].payload, seq)
    assert list(hdr.lr.frame_restoration_type) == [1, 0, 0]


def test_engine_refuses_deblocking_gop():
    """The engine used to refuse a GOP whose deblocking decision is on,
    and then CDEF; now a flat, clean source encodes with the loop filter
    (levels in the frame header, a filtered reference), and with CDEF
    and LR on after it (the searched strengths and luma WIENER
    restoration in the header), and decodes to the recon either way."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine, lf_levels
    from av1tpu_torch.specav1 import decoder, headers, obu
    flat = testsrc.testsrc2(64, 64, 0)
    flat.y[:] = 128
    lvl = lf_levels(96, 8)[0]
    for filters in (False, True):
        cfg = dict(chunk=1, golden=False, cdef=filters, lr=filters)
        eng = SpecTorchEngine(TpuEncoderConfig(**cfg), device="cpu")
        eng.start_stream()
        pend = eng._submit(flat, 96, is_key=True)
        tu = eng._finalize(pend)[0]
        assert eng._gop_deblock
        obus = list(obu.parse_obus(tu))
        seq = headers.parse_sequence_header(obus[0].payload)
        hdr = headers.parse_frame_header(obus[1].payload, seq)
        assert lvl > 0 and tuple(hdr.lf.level) == (lvl,) * 4
        assert bool(seq.enable_cdef) == bool(seq.enable_restoration) == \
            filters
        if filters:
            c = hdr.cdef
            assert [c.y_pri[0], c.y_sec[0], c.uv_pri[0], c.uv_sec[0]] == \
                pend[11][16].tolist()
            assert list(hdr.lr.frame_restoration_type) == [1, 0, 0]
        (dec,) = decoder.decode_stream([tu])
        for d, r in zip(dec, eng._ref):
            np.testing.assert_array_equal(d, r[:d.shape[0], :d.shape[1]])
    # 1080 % 32 == 24: a clean 1080p source never filters
    assert 1080 % 32 == 24 and 720 % 32 == 16 and 2160 % 32 == 16


@pytest.mark.parametrize("w,h,want", [(64, 64, True), (128, 80, True),
                                      (96, 88, False), (88, 80, False)])
def test_gop_deblock_decision_follows_geometry(w, h, want):
    """Clean content filters when the coded height is a multiple of 32,
    or 16 past one with a width that is a multiple of 16; 88 % 32 == 24
    is the 1080p case and never filters.  Grain turns it off anywhere."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine, noise_floor
    from av1tpu_torch.utils.cleansrc import clean_frame
    eng = SpecTorchEngine(TpuEncoderConfig(chunk=1, golden=True, cdef=False,
                                           lr=False), device="cpu")
    f = clean_frame(w, h, 0)
    assert noise_floor(f.y) <= 1.0
    eng.encode_keyframe(f, 96)
    assert eng._gop_deblock == want
    rng = np.random.default_rng(0)
    f.y[:] = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                     0, 255)
    eng.encode_keyframe(f, 96)
    assert not eng._gop_deblock
