"""Multi-device spec-AV1 encode (port of av1tpu/specav1/jax_sharded.py, a
JAX module; stripe_pad, sharding_ok and key_stripe_plan are copies).

The spec bitstream's tile rows are the unit of device parallelism: each
stripe of a stripe group encodes one horizontal stripe of the frame, and
the host writes every stripe's tiles into one tile group.  The reference
runs one ``shard_map`` program over a ("stripe",) mesh.  Here a group is
either the devices of one process (an ordered tuple of ``torch.device``s,
one a stripe; repeats allowed), whose thread issues the stripes in order,
each under its own device, or ``Ranks``: one stripe a process of a
``torch.distributed`` process group, stripe k on rank k's card, every
rank issuing its own stripe at the same time.  Only the helpers that move
rows (``shard_rows``, the halo exchange, ``gather_rows``, ``sum_stripes``)
tell the two apart: copies between devices in one process, collectives
between ranks.

P-frames: every stripe reads the previous reconstruction through its own
padded window, built by a halo exchange (``halo_windows``: PAD boundary
rows from each vertical neighbour, then the spec's edge clamp at the true
frame dims), so motion vectors stay unrestricted across stripe edges
within the +-(PAD - 8) search clamp.  Keyframes stripe where whole tile
rows fall to each stripe (``key_stripe_plan``): tiles share no
prediction state.  The 16-px strip, deblocking, CDEF and LR filter across
stripe edges, so they run on the gathered reconstruction, as the
one-device encode runs them: on the group's first device, or on every
rank, each of which then holds the whole frame and writes the same
stream.  The stream is the one-device encode's, byte for byte, while the
tile plan is (up to 4 stripes; ``spec_engine._tile_plan``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from av1tpu_torch.specav1 import torch_inter, torch_intra
from av1tpu_torch.specav1.transforms import Quantizer

PAD = torch_inter.PAD


def stripe_pad(ph: int, n: int) -> int:
    """Padded height for n equal 32-row-aligned stripes.  Inter stripes
    are a pure compute partition (each device sees its reference stripe
    plus PAD halo rows; MVs are unrestricted within the +-(PAD-8) search
    clamp; entropy slices tile rows from the full-frame arrays on the
    host), so any 32-aligned split works: rows beyond the coded frame
    encode garbage that the host never reads."""
    unit = 32 * n
    return -(-ph // unit) * unit


def sharding_ok(ph: int, th: int, n: int) -> bool:
    """Sharding pays when every stripe has at least 2 block rows."""
    return n >= 2 and stripe_pad(ph, n) // n >= 64


def key_stripe_plan(th: int, ph: int, n: int, trl2: int):
    """Stripe plan for tile-row-parallel KEYFRAMES, or None.

    AV1 tile rows share no prediction state, so each device can run
    the intra wavefront for a contiguous run of whole tile rows with
    zero halo traffic.  Shardable when the stream's uniform tile
    spacing (trl2 from spec_engine._tile_plan, chip-count-aware;
    writer.tile_row_spans: ths = ceil(sbr / 2^trl2) superblocks per
    tile) yields stripe boundaries on tile starts: n <= 2^trl2 tiles,
    2^trl2 % n == 0.  strip_same_sb geometries (th % 64 == 48) are
    excluded: their zone-3 candidate ban applies only to the frame's
    last main row, which would diverge the stripe bodies.

    Returns (stripe_h, ph_s, local_brs): stripe pixel height, the
    total striped height (n * stripe_h >= ph; trailing rows compute
    garbage the host crops), and the tile-start block rows INSIDE a
    stripe (exclusive of 0)."""
    mi_rows = 2 * ((th + 7) >> 3)
    sbr = (mi_rows + 15) >> 4
    T = 1 << trl2
    if n < 2 or T % n or n > T:
        return None
    if th % 32 == 16 and (th // 32 * 32) % 64 == 32:
        return None  # strip_same_sb
    ths = (sbr + T - 1) >> trl2
    tpd = T // n
    stripe_h = tpd * ths * 64
    ph_s = n * stripe_h
    if ph_s < ph:
        return None
    local_brs = tuple(i * ths * 2 for i in range(1, tpd))
    return stripe_h, ph_s, local_brs


class Ranks(tuple):
    """A stripe group that spans the processes of the default
    ``torch.distributed`` group (``encoder.mesh.distributed``): stripe k
    on rank k's card.  Seen from one rank it is its own device once a
    stripe (``len`` is the stripe count, ``[0]`` where gathered outputs
    land): the rank issues only its own stripe (``local``), keeps only its
    own rows (``shard_rows``), and receives every other row it reads
    through collectives."""

    def __new__(cls, device: torch.device, n: int, rank: int):
        group = super().__new__(cls, (device,) * n)
        group.rank = rank
        return group


def on_device(dev: torch.device):
    """The context a stripe is issued in: ``dev`` as the current CUDA
    device (its current stream takes the stripe's work); nothing on the
    CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def local(group) -> list:
    """(k, device) of each stripe this process issues: every stripe of a
    one-process group, the rank's own of ``Ranks``."""
    if isinstance(group, Ranks):
        return [(group.rank, group[0])]
    return list(enumerate(group))


def shard_rows(group, plane: torch.Tensor) -> list:
    """Equal row slices of ``plane``, slice k on device group[k]; under
    ``Ranks`` only the rank's own slice (None for the others': every rank
    holds the same whole plane, as every JAX process feeds the same global
    array)."""
    sh = plane.shape[0] // len(group)
    parts = [None] * len(group)
    for k, d in local(group):
        parts[k] = plane[k * sh:(k + 1) * sh].to(d, non_blocking=True)
    return parts


def _exchange(tensors) -> list:
    """Every rank's ``tensors`` (the same shapes and dtypes on each), in
    rank order, by one all-gather of their bytes: NCCL has no int16 or
    bool, and one collective costs less than one a tensor.  Each tensor's
    run is padded to 8 bytes, so every view back is aligned."""
    runs = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        runs.append(torch.cat([b, b.new_zeros(-b.numel() % 8)]))
    flat = torch.cat(runs)
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    out = []
    for got in every:
        mine, off = [], 0
        for t, r in zip(tensors, runs):
            nb = t.numel() * t.element_size()
            mine.append(got[off:off + nb].view(t.dtype).reshape(t.shape))
            off += r.numel()
        out.append(mine)
    return out


def gather_rows(group, outs, fields) -> list:
    """Fields ``fields`` of every stripe's outputs, each concatenated in
    stripe order on group[0].  outs: the outputs of the stripes this
    process issued, in ``local``'s order.  Under ``Ranks`` one all-gather
    carries every field, and every rank holds the whole frame."""
    if isinstance(group, Ranks):
        (mine,) = outs
        every = _exchange([mine[i] for i in fields])
        return [torch.cat([e[j] for e in every]) for j in range(len(fields))]
    dev = group[0]
    return [torch.cat([o[i].to(dev, non_blocking=True) for o in outs])
            for i in fields]


def sum_stripes(group, vals) -> torch.Tensor:
    """The sum of every stripe's ``vals`` (this process's stripes', in
    ``local``'s order) on group[0]; the reference's ``psum``, an
    ``all_reduce`` under ``Ranks``."""
    dev = group[0]
    total = sum(v.to(dev) for v in vals)
    if isinstance(group, Ranks):
        dist.all_reduce(total)
    return total


def _window(own, top, bot, pad: int, th_p: int, tw_p: int, row0: int):
    """A stripe's rows with ``pad`` neighbour rows above and below (None
    at the frame's top or bottom: zeros, which the clamp never reads),
    remapped so that window cell (i, j) equals the one-device padded
    reference (``torch_inter.prep_ref``) at (row0 + i, j): row i shows
    true-ref row clamp(row0 - pad + i, 0, th_p - 1), column j column
    clamp(j - pad, 0, tw_p - 1)."""
    sh_p, pw = own.shape
    dev = own.device
    top = own.new_zeros((pad, pw)) if top is None else \
        top.to(dev, non_blocking=True)
    bot = own.new_zeros((pad, pw)) if bot is None else \
        bot.to(dev, non_blocking=True)
    win = torch.cat([top, own, bot])
    g = torch.arange(row0 - pad, row0 + sh_p + pad, device=dev)
    rows = (g.clamp(0, th_p - 1) - (row0 - pad)).clamp(0, sh_p + 2 * pad - 1)
    cols = torch.arange(-pad, pw + pad, device=dev).clamp(0, tw_p - 1)
    return win[rows[:, None], cols[None, :]]


def halo_windows(group, planes, k: int, geoms) -> list:
    """Stripe k's padded windows of several planes (the reference's
    _halo_window, a ppermute there), all through one exchange.

    planes: each plane's row slices (``shard_rows``); geoms: each plane's
    (pad, th_p, tw_p, row0), row0 being stripe k's first row.  The ``pad``
    boundary rows of each vertical neighbour come to stripe k's device:
    copied in one process, under ``Ranks`` one all-gather of every
    stripe's top and bottom rows.  Returns each plane's (sh_p + 2 * pad,
    pw + 2 * pad) window (``_window``) on stripe k's device."""
    n = len(group)
    own = [p[k] for p in planes]
    if isinstance(group, Ranks):
        every = _exchange([t for o, (pad, *_) in zip(own, geoms)
                           for t in (o[:pad], o[-pad:])])
        nbrs = [(every[k - 1][2 * j + 1] if k > 0 else None,
                 every[k + 1][2 * j] if k + 1 < n else None)
                for j in range(len(planes))]
    else:
        nbrs = [(p[k - 1][-pad:] if k > 0 else None,
                 p[k + 1][:pad] if k + 1 < n else None)
                for p, (pad, *_) in zip(planes, geoms)]
    return [_window(o, top, bot, *g)
            for o, (top, bot), g in zip(own, nbrs, geoms)]


def _windows(group, planes, k: int, row0: int, th: int, tw: int):
    """Stripe k's windows of (Y, U, V) plane triples (a reference, or
    LAST then GOLDEN), through one exchange."""
    geoms = [(PAD, th, tw, row0), (PAD // 2, th // 2, tw // 2, row0 // 2),
             (PAD // 2, th // 2, tw // 2, row0 // 2)]
    return halo_windows(group, planes, k, geoms * (len(planes) // 3))


def encode_key_striped(group, y, u, v, qindex: int, bit_depth: int, th: int,
                       tw: int, stripe_h: int, local_brs: tuple,
                       lf_y: int = 0, lf_uv: int = 0, deblock: bool = False,
                       qround: float = 0.70, cdef: bool = False,
                       cdef_damping: int = 4, lr: bool = False):
    """Tile-row-parallel keyframe (the reference's encode_key_sharded).

    y/u/v: (ph_s, pw) source planes on group[0], ph_s = n * stripe_h per
    ``key_stripe_plan``.  Each stripe device runs the whole intra
    wavefront for its tile rows (its top IS a tile start, so 'no above'
    at the stripe top is the tile boundary), clamping edge reads at its
    share of the frame's bottom; the strip and the in-loop filters run on
    the recon gathered to group[0] (to every rank under ``Ranks``).
    Returns torch_intra.encode_frame's 19-tuple at ph_s rows, equal to
    the one-device keyframe's."""
    pw = y.shape[1]
    fh8 = ((th + 7) >> 3) << 3
    parts = [shard_rows(group, p) for p in (y, u, v)]
    outs = []
    for k, d in local(group):
        row0 = k * stripe_h
        with on_device(d):
            out = torch_intra.encode_frame(
                parts[0][k], parts[1][k], parts[2][k], qindex,
                nbr=stripe_h // 32, nbc=pw // 32, bit_depth=bit_depth,
                th=stripe_h, tw=tw, tile_row_starts=local_brs, qround=qround,
                fh_clamp=min(max(fh8 - row0, 0), stripe_h))
        outs.append(out[0:15])
    dev = group[0]
    fy, fu, fv, lv_y, lv_u, lv_v, *grids = gather_rows(group, outs,
                                                       range(15))
    strip = th % 32 == 16
    # rows past the coded grid are stripe-pad garbage the one-device
    # encode never writes; zero their levels so that the sparse level pack
    # sees the same density (recon and grid garbage the host crops)
    coded_h = th if strip else 32 * ((th + 31) // 32)
    if coded_h < lv_y.shape[0]:
        lv_y[coded_h:] = 0
        lv_u[coded_h // 2:] = 0
        lv_v[coded_h // 2:] = 0
        # grid rows past the coded main grid likewise (the strip row's
        # syntax comes from strip_skip, not the 32-grid)
        gmain = th // 32 if strip else -(-th // 32)
        for g in grids:
            g[gmain:] = 0
    q = Quantizer(qindex, bit_depth, qround, dev)
    fy, fu, fv, strip_skip, cdefs, lr_choice, lr_taps = \
        torch_inter.finish_frame((y, u, v), (fy, fu, fv), (lv_y, lv_u, lv_v),
                                 grids[2], grids[4], grids[8], q, bit_depth,
                                 th, tw, lf_y=lf_y, lf_uv=lf_uv,
                                 deblock=deblock, cdef=cdef,
                                 cdef_damping=cdef_damping, lr=lr)
    return (fy, fu, fv, lv_y, lv_u, lv_v, *grids, strip_skip, cdefs,
            lr_choice, lr_taps)


# the P-frame outputs that are per block (concatenated over the stripes);
# the others (strip_skip, cdefs, lr_choice, lr_taps) come back off from
# every stripe and are made on the gathered frame
_INTER_ROWS = (0, 1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 14)


def encode_inter_striped(group, y, u, v, refs, qindex: int, bit_depth: int,
                         th: int, tw: int, lf_y: int = 0, lf_uv: int = 0,
                         deblock: bool = False, qround: float = 0.70,
                         cdef: bool = False, cdef_damping: int = 4,
                         lr: bool = False, gld=None):
    """One striped P-frame (the reference's _frame_step_sharded).

    y/u/v: (ph, pw) source planes on group[0], ph a multiple of
    32 * len(group); refs: the LAST reconstruction as row slices, one a
    stripe device (``shard_rows`` of each plane), gld the GOLDEN one
    likewise or None.  Stripe k encodes rows [k * sh, (k + 1) * sh) on
    group[k] through windows from ``halo_windows``; the outputs are
    gathered to group[0] (to every rank under ``Ranks``), where the strip
    and the in-loop filters run on the whole frame.  Returns
    torch_inter.encode_frame's 16-tuple, equal to the one-device
    encode's."""
    sh = y.shape[0] // len(group)
    src = [shard_rows(group, p) for p in (y, u, v)]
    outs = []
    for k, d in local(group):
        row0 = k * sh
        with on_device(d):
            wins = _windows(group, list(refs) + list(gld or ()), k, row0,
                            th, tw)
            ref_w, gld_w = wins[:3], wins[3:] or None
            outs.append(torch_inter.encode_frame(
                src[0][k], src[1][k], src[2][k], *ref_w, qindex, bit_depth,
                th=th, tw=tw, qround=qround, gld=gld_w, stripe=True,
                row0=row0))
    dev = group[0]
    out = [None] * 16
    for i, t in zip(_INTER_ROWS, gather_rows(group, outs, _INTER_ROWS)):
        out[i] = t
    gh, gw = y.shape[0] // 32, y.shape[1] // 32
    q = Quantizer(qindex, bit_depth, qround, dev)
    out[5], out[6], out[7], out[8], out[9], out[10], out[15] = \
        torch_inter.finish_frame((y, u, v), out[5:8], out[2:5],
                                 out[1].reshape(gh, gw),
                                 out[11].reshape(gh, gw), out[13], q,
                                 bit_depth, th, tw, lf_y=lf_y, lf_uv=lf_uv,
                                 deblock=deblock, cdef=cdef,
                                 cdef_damping=cdef_damping, lr=lr)
    return tuple(out)
