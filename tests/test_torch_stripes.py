"""Multi-device tile-row stripes of the PyTorch port
(``av1tpu_torch/specav1/stripes.py``) against the JAX package's
``jax_sharded`` and against the port's own one-device encode, on the CPU.

The stripe group is the CPU repeated, as the JAX tests' virtual mesh
runs the sharded arithmetic on one host.  Every comparison is exact.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import torch_dist_ranks as R
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch import spec_engine as SE
from av1tpu_torch.specav1 import headers, obu, stripes, torch_inter
from av1tpu_torch.utils import testsrc
from av1tpu_torch.utils.cleansrc import clean_frame

CPU = torch.device("cpu")


def _smooth(h, w, seed):
    """A seeded textured plane with smooth structure and mild noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = (128 + 50 * np.sin(xx / 13.0 + seed) * np.cos(yy / 19.0 - seed)
         + 30 * np.sin((xx + yy) / 29.0) + r.integers(-4, 5, (h, w)))
    return np.clip(a, 0, 255).astype(np.uint8)


def test_stripe_plans_match_jax():
    """The copied plans (stripe_pad, sharding_ok, key_stripe_plan) and
    _tile_plan(th, chips) for chips 1-8 equal the JAX package's over
    coded heights from 64 to 2176, 1080, 720 and 2160 among them, and the
    16-px strip geometries (th % 32 == 16, both SB phases)."""
    from av1tpu import spec_engine as JE
    from av1tpu.specav1 import jax_sharded as JS
    heights = sorted(set(range(64, 2177, 56)) |
                     {144, 240, 464, 496, 720, 1080, 1088, 2160})
    for th in heights:
        ph = -(-th // 64) * 64
        for n in range(1, 9):
            assert stripes.stripe_pad(ph, n) == JS.stripe_pad(ph, n)
            assert stripes.sharding_ok(ph, th, n) == JS.sharding_ok(ph, th, n)
            got, want = SE._tile_plan(th, n), JE._tile_plan(th, n)
            assert (got[0], got[2]) == (want[0], want[2]), (th, n)
            assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]
            for trl2 in range(5):
                assert stripes.key_stripe_plan(th, ph, n, trl2) == \
                    JS.key_stripe_plan(th, ph, n, trl2), (th, n, trl2)
    # the geometries the card runs: 1080p over 2 stripes, 720p over 4
    assert stripes.key_stripe_plan(1080, 1088, 2, 2) == (640, 1280, (10,))
    assert stripes.key_stripe_plan(720, 768, 4, 2) == (192, 768, ())
    assert SE._tile_plan(512, 8)[0] == 3 and SE._tile_plan(512, 4)[0] == 2


def test_halo_window_matches_jax():
    """halo_windows against jax_sharded._halo_window inside a shard_map on
    the virtual 4-device mesh, for a luma and a chroma plane, first,
    middle and last stripe, with the row clamp and the column clamp at
    true dims below the padded ones; each window is also the one-device
    padded reference (torch_inter.prep_ref) at the stripe's rows."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from av1tpu.specav1 import jax_sharded as JS
    n = 4
    mesh = JS.make_mesh(n)
    rng = np.random.default_rng(5)
    for ph, pw, pad, th_p, tw_p in ((512, 192, 64, 464, 168),
                                    (256, 96, 32, 232, 84)):
        sh = ph // n
        plane = rng.integers(0, 1024, (ph, pw)).astype(np.int32)

        def body(r, sh=sh, pad=pad, th_p=th_p, tw_p=tw_p):
            row0 = jax.lax.axis_index("stripe") * sh
            return JS._halo_window(r, n, pad, th_p, tw_p, row0, sh)

        want = np.asarray(shard_map(
            body, mesh=mesh, in_specs=(P("stripe", None),),
            out_specs=P("stripe", None), check_rep=False)(
                JS.shard_rows(mesh, jnp.asarray(plane))))
        wh = sh + 2 * pad
        assert want.shape == (n * wh, pw + 2 * pad)
        t = torch.from_numpy(plane)
        parts = stripes.shard_rows((CPU,) * n, t)
        full = torch_inter.prep_ref(t, th_p, tw_p, pad)
        for k in range(n):
            (got,) = stripes.halo_windows((CPU,) * n, [parts], k,
                                          [(pad, th_p, tw_p, k * sh)])
            np.testing.assert_array_equal(got.numpy(),
                                          want[k * wh:(k + 1) * wh])
            torch.testing.assert_close(got, full[k * sh:k * sh + wh],
                                       rtol=0, atol=0)


def _golden_pframe():
    """The striped golden P-frame's inputs (4 stripes of 64 rows at
    256x256 padded, a 240-row coded frame) and jax_sharded's 16 outputs
    for them on the virtual mesh: (numpy planes y, u, v, LAST y, u, v,
    GOLDEN y, u, v; the JAX outputs; the arguments after the planes)."""
    from av1tpu.specav1 import jax_sharded as JS
    n, PH, PW, TH, TW, Q = 4, 256, 256, 240, 256, 90
    base = _smooth(PH + 16, PW + 16, 3)
    y = base[5:5 + PH, 3:3 + PW].copy()
    # the bottom block row straddles the coded height: its quadrants move
    # apart over a noise texture, so 16-px splits would pay there, but
    # only blocks inside the coded grid may split (the stripe's row
    # offset decides which are)
    base[PH - 64:] = np.random.default_rng(7).integers(0, 256, (80, PW + 16))
    for r, c in np.ndindex(2, PW // 16):
        dy, dx = (5, 3) if (r + c) % 2 else (1, 7)
        r0, c0 = PH - 32 + 16 * r, 16 * c
        y[r0:r0 + 16, c0:c0 + 16] = base[r0 + dy:r0 + dy + 16,
                                         c0 + dx:c0 + dx + 16]
    u = _smooth(PH // 2, PW // 2, 4)
    v = _smooth(PH // 2, PW // 2, 6)
    ref = (base[:PH, :PW].astype(np.int32), u.astype(np.int32) + 2,
           v.astype(np.int32) - 3)
    # GOLDEN holds the source itself over the lower half: those blocks
    # choose it, the upper half keeps LAST
    gld = tuple(r.copy() for r in ref)
    gld[0][PH // 2:] = y[PH // 2:]
    lf = SE.lf_levels(Q)
    mesh = JS.make_mesh(n)
    shard = [JS.shard_rows(mesh, jnp.asarray(a)) for a in (y, u, v) + ref
             + gld]
    want = JS.encode_inter_sharded(
        mesh, *shard[:6], Q, bit_depth=8, th=TH, tw=TW,
        lf_y=jnp.int32(lf[0]), lf_uv=jnp.int32(lf[1]), deblock=True,
        golden=True, gld_y=shard[6], gld_u=shard[7], gld_v=shard[8])
    return ((y, u, v) + ref + gld, [np.asarray(w) for w in want],
            ((Q, 8, TH, TW), dict(lf_y=lf[0], lf_uv=lf[1], deblock=True)))


def test_striped_inter_frame_matches_jax():
    """A striped P-frame, 4 stripes of 64 rows at 256x256 padded (a
    240-row coded frame, so the 16-px strip is coded on the gathered
    frame) with GOLDEN and deblocking on, against
    jax_sharded.encode_inter_sharded on the virtual mesh: all 16 outputs
    exact, and equal to the port's one-device encode.  The references are
    seeded smooth planes (no keyframe program is compiled).  With GOLDEN
    off, the striped frame equals the one-device one too."""
    planes, want, (args, kw) = _golden_pframe()
    n = 4
    group = (CPU,) * n
    tens = [torch.from_numpy(a) for a in planes]
    got = stripes.encode_inter_striped(
        group, *tens[:3], [stripes.shard_rows(group, p) for p in tens[3:6]],
        *args, gld=[stripes.shard_rows(group, p) for p in tens[6:]], **kw)
    one = torch_inter.encode_frame(*tens[:6], *args[:2], th=args[2],
                                   tw=args[3], gld=tens[6:], **kw)
    assert len(got) == len(want) == 16
    for i, (g, w, o) in enumerate(zip(got, want, one)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=i)
        torch.testing.assert_close(g, o, rtol=0, atol=0, msg=str(i))
    refsel = got[14]
    assert 0 < int(refsel.sum()) < refsel.numel(), "one reference only"
    assert (got[0] != 0).any(), "no motion found"
    parts = [stripes.shard_rows(group, p) for p in tens[3:6]]
    got = stripes.encode_inter_striped(group, *tens[:3], parts, *args)
    one = torch_inter.encode_frame(*tens[:6], *args[:2], th=args[2],
                                   tw=args[3])
    for i, (g, o) in enumerate(zip(got, one)):
        torch.testing.assert_close(g, o, rtol=0, atol=0, msg=str(i))


def test_striped_inter_frame_over_ranks_matches_jax(tmp_path):
    """The same golden P-frame over 4 ranks, one stripe a process joined
    over gloo (``stripes.Ranks``: halos by all-gather, outputs gathered to
    every rank): every rank's 16 outputs equal
    jax_sharded.encode_inter_sharded's on the virtual mesh."""
    planes, want, (args, kw) = _golden_pframe()
    ranks = R.run(4, "inter", tmp_path, device="cpu", planes=planes,
                  args=args, kw=kw)
    for got in ranks:
        assert len(got) == len(want) == 16
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=str(i))


def _encode(cfg, frames, n=0):
    """(payloads, recons, striped calls) of encode_stream on the CPU with
    ``num_chips = n`` (``torch_dist_ranks.spied_stream``)."""
    eng = SE.SpecTorchEngine(TpuEncoderConfig(**{**cfg, "num_chips": n}),
                             device="cpu")
    return R.spied_stream(eng, frames, 96)


def _decodes_to(payloads, recons):
    R.decodes_to(payloads, recons)


def _grainy(w, h, i):
    f = testsrc.testsrc2(w, h, i)
    rng = np.random.default_rng(i)
    y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape), 0, 255)
    return testsrc.Frame(y=y.astype(np.uint8), u=f.u, v=f.v)


def test_striped_key_and_p_equal_one_device():
    """A striped keyframe and P-frame through the engine against its
    one-device ones in the default filter chain: 2 stripes of a clean
    464-row clip (deblocking, CDEF and LR on; the 16-px strip coded on the
    gathered recon), 4 of a clean 512-row one, and 2 of a grainy 528-row
    one, whose key stripes pad the 576-row frame to 768 rows (cropped
    back) and whose last block row reads its left edge down to the
    frame's bottom clamp; every stripe is taller than its halo.  Payloads
    equal, recons equal over the coded frame."""
    for w, h, n in ((96, 464, 2), (96, 512, 4), (96, 528, 2)):
        frames = [_grainy(w, h, i) if h == 528 else clean_frame(w, h, i, 0)
                  for i in range(2)]
        one, rec1, c1 = _encode(dict(chunk=1), frames)
        got, recn, cn = _encode(dict(chunk=1), frames, n)
        assert c1 == {"key": 0, "inter": 0} and cn == {"key": 1, "inter": 1}
        assert got == one, (w, h, n)
        for fa, fb in zip(rec1, recn):
            for a, b, rows in zip(fa, fb, (h, h // 2, h // 2)):
                np.testing.assert_array_equal(a[:rows], b[:rows])
    seq = headers.parse_sequence_header(obu.parse_obus(got[0])[0].payload)
    assert seq.enable_cdef and seq.enable_restoration


def test_striped_streams_equal_one_device_streams():
    """The daemon's default config at chunk=3 on a clean 256x256 drift
    (key, a packed chunk of 3, a remainder of 1) with num_chips=4: every
    P-frame striped (4 stripes of 64 rows; the 256-row key has one tile
    row and stays on one device), payloads equal to the one-device
    engine's, decoded by the port's decoder to the recon.  With
    num_chips=8 on a 64x512 clip the tile plan takes 8 tile rows (the
    reference's _tile_plan(512, 8)), every frame stripes, keyframe
    included, and the stream decodes to the recon."""
    from av1tpu import spec_engine as JE
    frames = [clean_frame(256, 256, t, 0) for t in range(5)]
    one, _, c1 = _encode(dict(chunk=3), frames)
    got, rec, cn = _encode(dict(chunk=3), frames, 4)
    assert c1 == {"key": 0, "inter": 0} and cn == {"key": 0, "inter": 4}
    assert got == one
    _decodes_to(got, rec)
    frames = [clean_frame(64, 512, t, 0) for t in range(3)]
    got, rec, cn = _encode(dict(chunk=1), frames, 8)
    assert cn == {"key": 1, "inter": 2}
    _decodes_to(got, rec)
    seq = headers.parse_sequence_header(obu.parse_obus(got[0])[0].payload)
    for p in got:
        fr = [o for o in obu.parse_obus(p) if o.type == obu.OBU_FRAME][0]
        hdr = headers.parse_frame_header(fr.payload, seq)
        assert hdr.tile_rows_log2 == JE._tile_plan(512, 8)[0] == 3
