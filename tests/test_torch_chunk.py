"""PyTorch port (av1tpu_torch): chunked dispatch with packed upload.

- The port's copy of ``io_pack.pack_chunk`` gives the original's outputs,
  and its torch ``unpack_chunk`` the same planes as the JAX one and as the
  raw planes, in both predictor modes, at 8 and 10 bits.
- ``encode_stream``'s chunk schedule: with the device half stubbed,
  ``SpecTorchEngine`` groups frames into dispatches, picks per-frame
  qindexes and order hints, and records bits in the same order as
  ``SpecTpuEngine``, for K = 8 and K = 1, under a constant qindex and both
  rate controllers.
- The port alone on a clean 128x144 drift: packed and raw uploads give the
  same bytes, a chunked stream the bytes of ``chunk=1``, and the port's
  decoder reproduces every frame's reconstruction.

No test here compiles a JAX frame program, and the file holds three items:
the test scheduler hands out files with more items first, so this one
starts after the JAX package's heavy files instead of before them.
"""

import numpy as np
import torch

from av1tpu.config import TpuEncoderConfig as JaxConfig
from av1tpu.encoder import io_pack as j_io_pack
from av1tpu.encoder import ratectrl as j_ratectrl
from av1tpu.spec_engine import SpecTpuEngine
from av1tpu_torch import spec_engine
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.encoder import io_pack, ratectrl
from av1tpu_torch.engine import TorchEngine
from av1tpu_torch.specav1 import decoder
from av1tpu_torch.utils import testsrc
from av1tpu_torch.utils.cleansrc import clean_frame

torch.set_num_threads(1)


def _grain(f, rng, amp):
    mx = (1 << f.bit_depth) - 1
    y = np.clip(f.y.astype(np.int32) + rng.integers(-amp, amp + 1, f.y.shape),
                0, mx).astype(f.y.dtype)
    return testsrc.Frame(y=y, u=f.u, v=f.v, bit_depth=f.bit_depth)


def _chunk_frames(kind, k, bd):
    """k + 1 padded (y, u, v) plane triples: the base, then the chunk."""
    rng = np.random.default_rng(11 + k + bd)
    if kind == "clean":
        frames = [clean_frame(128, 144, t, 0, bd) for t in range(k + 1)]
    elif kind == "grainy":  # temporal mode on luma
        frames = [_grain(testsrc.testsrc2(128, 144, t, bd), rng, 6 << (bd - 8))
                  for t in range(k + 1)]
    else:  # outliers: clean drift with hard outliers in every plane
        frames = []
        for t in range(k + 1):
            f = clean_frame(128, 144, t, 0, bd)
            mx = (1 << bd) - 1
            for p in (f.y, f.u, f.v):
                pos = rng.integers(0, p.size, 300)
                p.reshape(-1)[pos] = rng.integers(0, mx + 1, 300)
            frames.append(f)
    return [TorchEngine._pad_planes(f, 64) for f in frames]


def test_pack_chunk_copy_and_torch_unpack_match_jax():
    """pack_chunk: the copy's (nib, exc_pos, exc_val, modes) equal the
    original's on clean, grainy and outlier-heavy chunks, K = 1
    and 3, 8 and 10 bits, and both return None over the cap.  unpack:
    the port's torch inverse gives exactly the JAX inverse's planes and
    the raw planes, in both predictor modes."""
    import jax
    import jax.numpy as jnp
    # the JAX inverse runs jitted, as inside the JAX engine's chunk program
    j_unpack = jax.jit(j_io_pack.unpack_chunk,
                       static_argnames=("k", "ph", "pw", "bit_depth"))
    seen_modes = set()
    for bd in (8, 10):
        for kind in ("clean", "grainy", "outliers"):
            for k in (1, 3):
                planes = _chunk_frames(kind, k, bd)
                base, chunk = planes[0], planes[1:]
                ph, pw = base[0].shape
                cap = 4 * io_pack.CAP_PER_FRAME * k
                got = io_pack.pack_chunk(chunk, base, cap=cap, bit_depth=bd)
                want = j_io_pack.pack_chunk(chunk, base, cap=cap,
                                            bit_depth=bd)
                assert got is not None, (bd, kind, k)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                # over the cap: both give up (the port at the first frame
                # over it); at the cap: both pack, alike
                n_exc = int((got[1] < got[1].max()).sum())
                for c in sorted({0, n_exc // 2, max(n_exc - 1, 0), n_exc}):
                    a = io_pack.pack_chunk(chunk, base, cap=c, bit_depth=bd)
                    b = j_io_pack.pack_chunk(chunk, base, cap=c,
                                             bit_depth=bd)
                    assert (a is None) == (b is None) == (c < n_exc)
                    for x, y in zip(a or (), b or ()):
                        np.testing.assert_array_equal(x, y)
                nib, ep, ev, modes = got
                seen_modes.update(int(m) for m in modes)
                ev_t = ev.view(np.int16) if ev.dtype == np.uint16 else ev
                ys, us, vs = io_pack.unpack_chunk(
                    torch.from_numpy(nib), torch.from_numpy(ep),
                    torch.from_numpy(ev_t), modes,
                    *(torch.from_numpy(b.astype(np.int32)) for b in base),
                    k, ph, pw, bit_depth=bd)
                jys, jus, jvs = j_unpack(
                    jnp.asarray(nib), jnp.asarray(ep), jnp.asarray(ev),
                    jnp.asarray(modes), *(jnp.asarray(b) for b in base),
                    k=k, ph=ph, pw=pw, bit_depth=bd)
                assert ys.dtype == (torch.uint8 if bd == 8 else torch.int16)
                for i in range(k):
                    for pl, (t, j) in enumerate(((ys, jys), (us, jus),
                                                 (vs, jvs))):
                        mine = t[i].numpy().astype(np.int64)
                        np.testing.assert_array_equal(
                            mine, np.asarray(j[i]).astype(np.int64))
                        np.testing.assert_array_equal(mine, chunk[i][pl])
    assert seen_modes == {io_pack.MODE_TEMPORAL, io_pack.MODE_SPATIAL_H}
    # deep grain over the default cap: the chunk goes raw in both
    rng = np.random.default_rng(0)
    noise = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                   for s in ((64, 128), (32, 64), (32, 64)))
             for _ in range(3)]
    assert io_pack.pack_chunk(noise[1:], noise[0]) is None
    assert j_io_pack.pack_chunk(noise[1:], noise[0]) is None


# --- the chunk schedule, device half stubbed ---------------------------------

N_SCHED = 40


def _sched_frames():
    """40 frames of 64x64: a key on scene A, eleven A frames (one full
    chunk of 8 and three buffered), a one-frame flash of scene B inside
    that part-filled buffer, twelve A frames, a cut to scene C (a key;
    four buffered frames go out first), fourteen C frames (a chunk and a
    remainder of six).  Seeded texture keeps the complexities apart."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:64, 0:64]
    level = {"A": 60, "B": 190, "C": 125}
    scenes = "A" * 12 + "B" + "A" * 12 + "C" * 15
    out = []
    for i, s in enumerate(scenes):
        amp = 4 + 12 * ((i // 5) % 3)
        y = (level[s] + ((xx + 2 * i) % 16) + rng.integers(-amp, amp + 1,
                                                           (64, 64)))
        u = np.full((32, 32), 128 + 4 * (i % 3), np.uint8)
        out.append(testsrc.Frame(y=np.clip(y, 0, 255).astype(np.uint8),
                                 u=u, v=u.copy()))
    return out


def _stub(eng, frames, log):
    """Replace the device half of ``eng``: each dispatch appends what it
    was given to ``log``; a payload's size is a function of the frame
    and its qindex."""
    fid = {id(f): i for i, f in enumerate(frames)}

    def size(i, q, key):
        return int((2400 if key else 300 + 40 * (i % 9))
                   * 2.0 ** ((96 - q) / 28.8))

    def submit(frame, q, force_key=False, is_key=None, refresh=True):
        i = fid[id(frame)]
        oh = eng._order_hint & 127
        eng._order_hint += 1
        kind = "key" if is_key else ("inter" if refresh else "flash")
        eng._ref_dev = ("ref", i)
        log.append(("single", kind, i, int(q), oh))
        return (i, int(q), kind == "key")

    def submit_chunk(fr, qs):
        ids = [fid[id(f)] for f in fr]
        ohs = [(eng._order_hint + j) & 127 for j in range(len(fr))]
        eng._order_hint += len(fr)
        eng._ref_dev = ("ref", ids[-1])
        log.append(("chunk", ids, [int(q) for q in qs], ohs))
        return list(zip(ids, [int(q) for q in qs]))

    def finalize(rec):
        i, q, key = rec
        return bytes(size(i, q, key)), key

    def finalize_chunk(rec):
        return [(bytes(size(i, q, False)), False) for i, q in rec]

    eng._submit, eng._submit_chunk = submit, submit_chunk
    eng._finalize, eng._finalize_chunk = finalize, finalize_chunk


def _port_engine(**kw):
    return spec_engine.SpecTorchEngine(TpuEncoderConfig(**kw), device="cpu")


def _schedule(eng, rc_mod, rate_kind, frames):
    log = []
    _stub(eng, frames, log)
    eng.start_stream()
    if rate_kind == "const":
        rate = 96
    else:
        cls = (rc_mod.GateRateController if rate_kind == "gate"
               else rc_mod.LookaheadRateController)
        # a target under what the stream spends at the base qindex, so
        # the controller raises q as the bits come in
        rate = cls(96, target_bits=N_SCHED * 8 * 420.0,
                   total_frames=N_SCHED, keyint=120)
        record = rate.record

        def rec(bits):
            log.append(("record", bits))
            record(bits)

        rate.record = rec
    out = list(eng.encode_stream(frames, rate))
    assert len(out) == N_SCHED
    return log


def test_chunk_schedule_matches_jax_engine():
    """Dispatch groupings, kinds, per-frame qindexes, order hints and the
    order of the rate controller's records: the port's encode_stream
    against the JAX engine's, for K = 8 and K = 1, under a constant
    qindex and both controllers; under a controller the K = 8 qindexes
    differ from the K = 1 ones (the records come later), so the
    comparison is not vacuous."""
    for rate_kind in ("const", "gate", "lookahead"):
        _check_schedule(rate_kind)


def _check_schedule(rate_kind):
    frames = _sched_frames()
    logs = {}
    for K in (8, 1):
        ref = _schedule(SpecTpuEngine(JaxConfig(chunk=K)), j_ratectrl,
                        rate_kind, frames)
        mine = _schedule(_port_engine(chunk=K), ratectrl, rate_kind,
                         frames)
        assert mine == ref, (rate_kind, K)
        logs[K] = mine
    disp8 = [e for e in logs[8] if e[0] != "record"]
    kinds = [e[1] if e[0] == "single" else ("chunk", len(e[1]))
             for e in disp8]
    assert kinds == (["key"] + [("chunk", 8)] + ["inter"] * 3 + ["flash"]
                     + [("chunk", 8)] + ["inter"] * 4 + ["key"]
                     + [("chunk", 8)] + ["inter"] * 6), kinds
    assert all(e[0] == "single" for e in logs[1] if e[0] != "record")

    def qs(log):
        out = {}
        for e in log:
            if e[0] == "single":
                out[e[2]] = e[3]
            elif e[0] == "chunk":
                out.update(zip(e[1], e[2]))
        return [out[i] for i in range(N_SCHED)]

    if rate_kind == "const":
        assert qs(logs[8]) == qs(logs[1])
    else:
        assert qs(logs[8]) != qs(logs[1]), (rate_kind, qs(logs[8]))
        assert max(qs(logs[8])) > 96


# --- the port alone: packed and raw, chunked and single ----------------------

def test_chunked_packed_stream_equals_single_frame_stream(monkeypatch):
    """A clean 128x144 drift, key + one chunk of 3 + a remainder of 1:
    the packed upload engages and gives the raw upload's bytes, which
    are chunk=1's; the port's decoder reproduces every frame's
    reconstruction (each P-frame's recon taken from encode_frame)."""
    frames = [clean_frame(128, 144, t) for t in range(5)]
    packs, recons = [], []
    real_pack = io_pack.pack_chunk
    real_frame = spec_engine.torch_inter.encode_frame

    def pack_spy(*a, **k):
        r = real_pack(*a, **k)
        packs.append(None if r is None else tuple(int(m) for m in r[3]))
        return r

    def frame_spy(*a, **k):
        out = real_frame(*a, **k)
        recons.append(tuple(p.numpy().copy() for p in out[5:8]))
        return out

    monkeypatch.setattr(io_pack, "pack_chunk", pack_spy)
    monkeypatch.setattr(spec_engine.torch_inter, "encode_frame", frame_spy)
    streams = {}
    for name, kw in (("single", dict(chunk=1)),
                     ("packed", dict(chunk=3)),
                     ("raw", dict(chunk=3, delta_upload=False))):
        eng = _port_engine(**kw)
        recons.clear()
        out = list(eng.encode_stream(frames, 96))
        assert [k for _, k in out] == [True] + [False] * 4
        assert eng._gop_deblock
        streams[name] = ([p for p, _ in out],
                         [tuple(p.numpy() for p in eng._golden_dev)]
                         + list(recons))
    assert packs == [(io_pack.MODE_SPATIAL_H,) * 3], packs
    assert streams["packed"][0] == streams["raw"][0] == streams["single"][0]
    payloads, recs = streams["packed"]
    dec = decoder.decode_stream(payloads)
    assert len(dec) == len(recs) == 5
    for i, (d, r) in enumerate(zip(dec, recs)):
        for pl in range(3):
            hh, ww = d[pl].shape
            np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                          r[pl][:hh, :ww].astype(np.int64))
