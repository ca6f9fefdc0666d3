"""Spec-AV1 engine of the PyTorch port: ``SpecTorchEngine``.

The port of ``av1tpu/spec_engine.py``'s single-device pipeline:
keyframes from ``specav1.torch_intra``, P-frames from
``specav1.torch_inter``, one at a time or K at a time as a chunk
(``encode_chunk``: one packed upload, K frame encodes, one sparse pack),
sparse level packing on the device, and the port's own native C++ tile
writer plus header/OBU writer on the host.  The output is standard AV1
in the same low-overhead framing as the JAX engine (keyframes carry
[sequence header OBU][frame OBU]).

On several devices (``num_chips`` >= 2, or an explicit tuple of stripe
devices) each frame is encoded in horizontal stripes, one a device
(``specav1.stripes``), and the stream is the one-device stream, byte for
byte, as long as the tile plan is the same (up to 4 stripes).  Under the
``AV1TPU_*`` process group (``encoder.mesh.distributed``) the stripes are
the ranks, one card a rank, each encoding its stripe at the same time
and every rank yielding the same stream.

Supported configuration: the daemon's default (``TpuEncoderConfig()``:
``chunk=8``, ``delta_upload``, ``golden``, ``cdef`` and ``lr`` on) and
each of those settings changed, 8- or 10-bit.  With
``golden`` the GOP keyframe's filtered reconstruction stays in
reference slot 1 and every P-frame block picks LAST or GOLDEN.
Deblocking is decided per GOP exactly as the JAX engine does: on for a
clean source (noise floor <= 1) whose coded height is a multiple of 32,
or 16 past one with a width that is a multiple of 16 (every 720p and
2160p file; never 1080p, where 1080 % 32 == 24), at a level derived from
each frame's qindex.  With ``cdef`` every frame carries its searched
CDEF strengths (damping from the qindex), and with ``lr`` the luma
plane's per-unit Wiener choices and taps (frame restoration types
(WIENER, NONE, NONE), 256-px units).

A chunk is packed, uploaded and issued on an ordered one-worker
dispatch thread while the caller's thread entropy-codes older
dispatches; the worker issues onto the streams that were current on the
submitting thread, one a device, so stream order keeps every later
reader behind the chunk's work.  A striped frame outside a chunk is
issued on that worker too (the caller waits for it), so that a rank's
collectives all come from one thread, in submit order.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from av1tpu_torch import device as D
from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.encoder import io_pack
from av1tpu_torch.encoder.mesh import distributed
from av1tpu_torch.engine import TorchEngine, _entropy_pool
from av1tpu_torch.specav1 import lr as _NL
from av1tpu_torch.specav1 import native
from av1tpu_torch.specav1 import obu as obu_mod
from av1tpu_torch.specav1 import (recon, stripes, torch_inter, torch_intra,
                                  torch_lr)
from av1tpu_torch.specav1 import writer as W
from av1tpu_torch.utils import spans as tracer

I32 = torch.int32

# sparse level transfer capacity (nonzero coefficients) as a fraction
# of the total coefficient count; on overflow _finalize copies the
# full planes
SPARSE_CAP_FRACTION = 32

# the writer's counts of a P-frame (native.encode_tile_rows), recorded as
# spans over its tile coding whose ``n`` is the count
MV_COUNTS = ("mv.inter_blocks", "mv.golden_blocks", "mv.signbias_flips")


def _ref_slots(golden_on: bool) -> tuple:
    """An inter frame's ref_frame_idx: GOLDEN reads slot 1 (the GOP's
    key), every other reference slot 0 (the previous frame)."""
    return (0, 0, 0, 1, 0, 0, 0) if golden_on else (0,) * 7


def _encode_inter_tiles(item, *args, **kw) -> list:
    """native.encode_tile_rows for a P-frame, its MV counts recorded."""
    t0 = tracer.begin()
    counts = np.zeros(3, np.int64)
    tiles = native.encode_tile_rows("inter", *args, counts=counts, **kw)
    for name, n in zip(MV_COUNTS, counts):
        tracer.end(name, t0, item, int(n))
    return tiles


# --- host helpers copied from av1tpu/spec_engine.py (a JAX module) ---------

def _axis_true_dims_ok(px: int, is_height: bool = False) -> bool:
    """True when an axis can be coded at its true size on the fixed
    32x32 grid (exact multiples, a >16px overhang, or a 16px height
    strip)."""
    rem = px % 32
    if px % 2:
        return False
    if rem == 0 or rem > 16:
        return True
    return is_height and rem == 16


class SpecSequenceHeader:
    """Sequence parameters for the spec bitstream (av1C + seq OBU)."""

    def __init__(self, width: int, height: int, bit_depth: int = 8,
                 color_primaries: int = 0, color_transfer: int = 0,
                 color_matrix: int = 0, enable_cdef: bool = False,
                 enable_restoration: bool = False):
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.color_primaries = color_primaries
        self.color_transfer = color_transfer
        self.color_matrix = color_matrix
        self.enable_cdef = enable_cdef
        self.enable_restoration = enable_restoration

    def seq_obu(self) -> bytes:
        cp = self.color_primaries or None
        w, h = self.width, self.height
        if not (_axis_true_dims_ok(w) and _axis_true_dims_ok(h, True)):
            w, h = (w + 63) & ~63, (h + 63) & ~63
        return W.write_sequence_header(
            w, h, bit_depth=self.bit_depth,
            color_primaries=cp,
            transfer=self.color_transfer if cp else None,
            matrix=self.color_matrix if cp else None,
            enable_cdef=self.enable_cdef,
            enable_restoration=self.enable_restoration)

    def av1c(self) -> bytes:
        hbd = 1 if self.bit_depth > 8 else 0
        b2 = (hbd << 6) | (1 << 3) | (1 << 2)
        return bytes([0x81, 0, b2, 0x00]) + self.seq_obu()


def noise_floor(y) -> float:
    """Median |horizontal second difference| on a row-subsampled grid:
    grainy sources measure >= 2, smooth/blocky content <= 1."""
    s = np.asarray(y[::8], np.int32)
    d2 = s[:, 2:] - 2 * s[:, 1:-1] + s[:, :-2]
    return float(np.median(np.abs(d2)))


def lf_levels(qindex: int, bit_depth: int = 8) -> tuple:
    """Deblocking filter level (luma, chroma) from qindex (libaom's
    q-based guess: av1_pick_filter_level's filt_guess regression, per
    bit depth; 8 or 10 bits)."""
    q = int(recon.AC_Q[bit_depth][int(qindex)])
    if bit_depth == 8:
        lvl = (q * 20723 + 1015158) >> 18
    elif bit_depth == 10:
        lvl = (q * 20723 + 4060632) >> 20
    else:
        raise ValueError(f"lf_levels: bit depth {bit_depth}")
    lvl = max(0, min(63, lvl))
    return lvl, lvl


def cdef_damping(qindex: int) -> int:
    """CDEF damping from qindex (libaom's pick_cdef heuristic:
    3 + (base_q_idx >> 6), range 3..6)."""
    return min(6, 3 + (int(qindex) >> 6))


def _lr_nru(th: int, tw: int) -> tuple:
    """(unit_rows, unit_cols) of the luma 256px restoration-unit grid."""
    return (_NL.count_units_in_frame(256, th),
            _NL.count_units_in_frame(256, tw))


def _lr_taps():
    """Tied (v == h) 6-tap rows for the static presets."""
    p = np.asarray(torch_lr.PRESETS, np.int32)
    return np.concatenate([p, p], axis=1)


def _lr_table(choice_grid, taps6):
    """(choice_grid', taps_table) for the tile writer: preset rows
    0..P-1 (tied), then one solved (v0,v1,v2,h0,h1,h2) row per RU;
    device choice P (= solved) maps to row P + ru_index."""
    P = len(torch_lr.PRESETS)
    nru = taps6.shape[0]
    tab = np.concatenate([_lr_taps(), np.asarray(taps6, np.int32)],
                         axis=0)
    idx = np.where(choice_grid == P,
                   P + np.arange(nru, dtype=np.int32).reshape(
                       choice_grid.shape),
                   choice_grid)
    return idx.astype(np.int32), tab


def _tile_plan(th: int, chips: int = 1):
    """(tile_rows_log2, spans, block_row_starts) for a coded height.

    chips > 4 raises the tile-row count so keyframe tile-row sharding
    (stripes.key_stripe_plan needs n <= 2^trl2 dividing it) and
    parallel host entropy keep one-or-more tiles per chip.  Tile rows
    cost a few bits each (per-tile CDF reset), so the bump is
    chip-count-conditioned, not default."""
    mi_rows = 2 * ((th + 7) >> 3)
    sbr = (mi_rows + 15) >> 4
    trl2 = 2 if sbr >= 8 else 0
    if chips > 4 and sbr >= 8:
        want = (chips - 1).bit_length()
        max_l2 = 0
        while (1 << (max_l2 + 1)) <= min(sbr, 64):
            max_l2 += 1
        trl2 = min(max(trl2, want), max_l2)
    spans = W.tile_row_spans(th, trl2)
    brs = tuple(mi0 // 8 for mi0, _ in spans[1:])
    return trl2, spans, brs


def _unpack_levels(maskbytes, vals, count, shapes):
    """Host inverse of pack_outputs; None when the nonzero count
    overflowed the value capacity."""
    total = sum(h * w for h, w in shapes)
    if int(count) > vals.shape[0]:
        return None
    flat = native.densify(np.asarray(maskbytes), np.asarray(vals), total)
    out = []
    off = 0
    for hh, ww in shapes:
        out.append(flat[off:off + hh * ww].reshape(hh, ww))
        off += hh * ww
    return out


# --- device side -------------------------------------------------------------

_BITS = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=I32)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """numpy.packbits of a flat bool tensor: big-endian bit order within
    each byte, zero-padded to a whole byte (native.densify reads it)."""
    n = mask.shape[0]
    pad = (-n) % 8
    m = mask.to(I32)
    if pad:
        m = torch.cat([m, m.new_zeros(pad)])
    w = _BITS.to(mask.device)
    return (m.reshape(-1, 8) * w).sum(1, dtype=I32).to(torch.uint8)


def pack_outputs(lv_y, lv_u, lv_v, grids, cap: int):
    """Sparse level packing (port of spec_engine._pack_outputs and of
    the chunk program's pack): the nonzero mask as packed bits, the
    nonzero values compacted in position order into int16[cap] by a
    cumsum, their count, and the int32 grids.  lv_*: one frame's level
    planes, or sequences of K frames' planes, flattened frame-major
    (y|u|v of frame 0, then of frame 1, ...) so that each frame's slice
    is a contiguous run."""
    if isinstance(lv_y, torch.Tensor):
        lv_y, lv_u, lv_v = (lv_y,), (lv_u,), (lv_v,)
    flat = torch.cat([p.reshape(-1) for f in zip(lv_y, lv_u, lv_v)
                      for p in f])
    mask = flat != 0
    count = mask.sum(dtype=I32)
    idx = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    # out-of-capacity and zero positions land in a dropped slot
    slot = torch.where(mask, idx, cap).clamp(max=cap).long()
    vals = torch.zeros((cap + 1,), dtype=torch.int16, device=flat.device)
    vals.scatter_(0, slot, flat.clamp(-32768, 32767).to(torch.int16))
    return packbits(mask), vals[:cap], count, grids.to(I32)


# the P-frame outputs that travel as grids, in the order _finalize and
# _finalize_chunk slice them: mv8, skip, strip_skip, cdefs, lr_choice,
# split, mv16, skip16, refsel, lr_taps
_INTER_GRIDS = (0, 1, 8, 9, 10, 11, 12, 13, 14, 15)


def _inter_grids(outs) -> torch.Tensor:
    """The grids of one or more P-frames' outputs, field-major across
    frames (each field of every frame, then the next field)."""
    return torch.cat([o[i].reshape(-1) for i in _INTER_GRIDS for o in outs])


def to_device(arr: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``: through pinned host memory and an
    asynchronous copy on the current stream when ``dev`` is CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def upload_chunk_raw(planes, dev) -> torch.Tensor:
    """K frames' padded (y, u, v) planes as one flat upload (port of the
    raw chunk upload): all Y frames, then all U, then all V; uint8 at 8
    bits, int16 holding the samples above (torch's uint16 coverage is
    thin).  On CUDA the buffer is filled in pinned host memory and
    copied asynchronously."""
    dt = torch.uint8 if planes[0][0].dtype == np.uint8 else torch.int16
    n = sum(p[pi].size for p in planes for pi in range(3))
    host = torch.empty(n, dtype=dt, pin_memory=dev.type == "cuda")
    view = host.numpy()
    off = 0
    for pi in range(3):
        for p in planes:
            view[off:off + p[pi].size] = p[pi].reshape(-1)
            off += p[pi].size
    return host.to(dev, non_blocking=True)


def unpack_planes_chunk(flat: torch.Tensor, k: int, ph: int, pw: int):
    """Views of one raw chunk upload (port of
    engine_tpu._unpack_planes_chunk): (k, ph, pw) and 2 x (k, ph/2,
    pw/2)."""
    ny = k * ph * pw
    nc = k * (ph // 2) * (pw // 2)
    return (flat[:ny].reshape(k, ph, pw),
            flat[ny:ny + nc].reshape(k, ph // 2, pw // 2),
            flat[ny + nc:ny + 2 * nc].reshape(k, ph // 2, pw // 2))


def encode_chunk(src, refs, qindexes, lfys, lfuvs, damps, *, k: int,
                 ph: int, pw: int, bit_depth: int, th: int, tw: int,
                 cap: int, deblock: bool = False, qround: float = 0.70,
                 cdef: bool = False, lr: bool = False, gld=None,
                 group=None):
    """K consecutive P-frames as one dispatch (port of
    spec_engine._encode_chunk, and with ``group`` of
    jax_sharded.encode_chunk_sharded; a Python loop stands in for
    lax.scan).

    src: the raw flat upload, or the packed one as (nib, exc_pos,
    exc_val, modes, base_y, base_u, base_v) for io_pack.unpack_chunk;
    refs: the LAST reconstruction the first frame predicts from, each
    frame's recon the next one's; qindexes, lfys, lfuvs, damps: per-frame
    ints; gld: the GOLDEN planes, the same for every frame.  With a
    stripe ``group`` every frame is a striped step
    (``stripes.encode_inter_striped``): its reference is the carried
    recon split into row slices, and gld comes as row slices already.
    Returns
    (the last recon, the packed outputs of pack_outputs over the whole
    chunk, the per-frame level planes (y, u, v lists, read on capacity
    overflow), the chunk's last source planes: the next chunk's delta
    base)."""
    if isinstance(src, tuple):
        ys, us, vs = io_pack.unpack_chunk(*src, k, ph, pw,
                                          bit_depth=bit_depth)
    else:
        ys, us, vs = unpack_planes_chunk(src, k, ph, pw)
    carry = tuple(refs)
    lvs = ([], [], [])
    kept = []
    for i in range(k):
        kw = dict(th=th, tw=tw, qround=qround, gld=gld, lf_y=int(lfys[i]),
                  lf_uv=int(lfuvs[i]), deblock=deblock, cdef=cdef,
                  cdef_damping=int(damps[i]), lr=lr)
        if group is None:
            out = torch_inter.encode_frame(
                ys[i], us[i], vs[i], *carry, int(qindexes[i]), bit_depth,
                **kw)
        else:
            out = stripes.encode_inter_striped(
                group, ys[i], us[i], vs[i],
                [stripes.shard_rows(group, p) for p in carry],
                int(qindexes[i]), bit_depth, **kw)
        carry = out[5:8]
        for j in range(3):
            lvs[j].append(out[2 + j])
        kept.append({f: out[f] for f in _INTER_GRIDS})
    pk = pack_outputs(*lvs, _inter_grids(kept), cap)
    return carry, pk, lvs, (ys[-1].clone(), us[-1].clone(), vs[-1].clone())


def state_from_numpy(ref_y, ref_u, ref_v, device) -> tuple:
    """Reference planes given as numpy arrays (for example another
    encoder's reconstruction) as the port's int32 device tensors: one
    call for the LAST planes, another for the GOLDEN ones."""
    dev = D.resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(p, np.int32)).to(dev)
                 for p in (ref_y, ref_u, ref_v))


def _upload(plane: np.ndarray, dev) -> torch.Tensor:
    # 8-bit planes travel as uint8, 10-bit as int16 (torch's uint16
    # op coverage is thin); the encoders widen to int32 on the device
    dt = np.uint8 if plane.dtype == np.uint8 else np.int16
    return torch.from_numpy(np.ascontiguousarray(plane, dt)).to(dev)


def _pad_rows(tri, ph: int, edge: bool):
    """A (y, u, v) plane triple (numpy or torch) grown to ph luma rows:
    the last row repeated (``edge``, numpy's mode="edge") or zeros."""
    d = ph - tri[0].shape[0]
    if d == 0:
        return tuple(tri)
    out = []
    for p, dp in zip(tri, (d, d // 2, d // 2)):
        if isinstance(p, np.ndarray):
            out.append(np.pad(p, ((0, dp), (0, 0)),
                              mode="edge" if edge else "constant"))
        elif edge:
            out.append(torch_inter.edge_pad(p, 0, dp, 0, 0))
        else:
            out.append(torch.cat([p, p.new_zeros((dp, p.shape[1]))]))
    return tuple(out)


def _grow(tri, ph: int, pw: int):
    """The delta-upload base planes edge-padded to the chunk's (ph, pw)
    rows, or None when the widths disagree or the base is taller (the
    host and device bases must match exactly for the mod-2^bd delta
    chain)."""
    if tri[0].shape[1] != pw or tri[0].shape[0] > ph:
        return None
    return _pad_rows(tri, ph, edge=True)


class SpecTorchEngine(TorchEngine):
    """Standard-AV1 engine on PyTorch (see module docstring)."""

    def __init__(self, cfg: Optional[TpuEncoderConfig] = None,
                 device: str = "cuda", stripe_devices=None):
        """``device``: where the one-device path runs.  ``stripe_devices``:
        the stripe group, one device a stripe, the first being ``device``
        (repeats allowed: one card, or the CPU, then runs the striped
        arithmetic); without it the group is ``cfg.num_chips`` devices
        from ``device`` on (cards capped at the visible ones; the CPU
        repeated), or under a process group every rank, one stripe a rank
        on the rank's device (``num_chips`` 0 or the world size)."""
        super().__init__(cfg)
        ranks = stripe_devices is None and distributed.active()
        self.device = (distributed.rank_device(device) if ranks
                       else D.resolve_device(device))
        c = self.cfg
        if c.bitstream != "spec":
            raise NotImplementedError(
                f"SpecTorchEngine encodes bitstream 'spec', not "
                f"{c.bitstream!r}; the private 'av1tpu' profile's engine is "
                "LegacyTorchEngine (av1tpu_torch.legacy.engine)")
        if ranks:
            world = distributed.world_size()
            if int(c.num_chips) not in (0, world):
                raise ValueError(
                    f"num_chips {c.num_chips} under a process group of "
                    f"{world} ranks: the stripes are the ranks (0 or "
                    f"{world})")
            stripe_devices = stripes.Ranks(self.device, world,
                                           distributed.rank())
        elif stripe_devices is None:
            # 0 and 1 keep one device: stripes issued from one thread are
            # slower on several cards than one card is alone (PERF.md)
            n = int(c.num_chips)
            if self.device.type == "cuda":
                first = self.device.index
                n = min(n, torch.cuda.device_count() - first)
                stripe_devices = [torch.device("cuda", first + i)
                                  for i in range(n)]
            else:
                stripe_devices = [self.device] * n
        self._group = stripe_devices if ranks else tuple(
            D.resolve_device(d) for d in stripe_devices)
        if self._group and self._group[0] != self.device:
            raise ValueError(f"the first stripe device {self._group[0]} is "
                             f"not the engine's device {self.device}")
        self._golden_parts = None  # (ph, GOLDEN row slices) when striped
        self._order_hint = 0
        # RefOrderHint per slot, as a decoder holds it after each frame
        self._slot_hints = [0] * 8
        self._dispatch = None  # ordered upload+dispatch worker (lazy)
        self._gop_deblock = False
        self._qround = float(c.qround)
        self._cdef = bool(c.cdef)
        self._lr = bool(c.lr)
        # per-block LAST/GOLDEN selection: slot 1 holds the GOP keyframe
        self._golden = bool(c.golden)
        # delta-upload base chain: the previous source frame's padded
        # planes on the host (for packing) and on the device (for
        # unpacking; a chunk's outputs carry it forward, so it is never
        # uploaded again)
        self._delta_upload = bool(c.delta_upload)
        self._src_base_host = None
        self._src_base_dev = None

    @property
    def _ref(self):
        """Reference recon planes materialized to host int32."""
        refs = self._resolve_refs()
        if refs is None:
            return None
        return tuple(p.cpu().numpy().astype(np.int32) for p in refs)

    def start_stream(self) -> None:
        # a stream that raised may have left chunks on the dispatch
        # worker; the next stream starts once they have run, so it reads
        # none of their thunks and never races them
        if self._dispatch is not None:
            self._dispatch.submit(lambda: None).result()
        super().start_stream()
        self._golden_parts = None
        self._order_hint = 0
        self._slot_hints = [0] * 8
        self._gop_deblock = False
        self._src_base_host = None
        self._src_base_dev = None

    def _dispatch_pool(self):
        if self._dispatch is None:
            from concurrent.futures import ThreadPoolExecutor
            self._dispatch = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="av1torch-dispatch")
        return self._dispatch

    def _on_worker(self, group, fn, *args, item: int = 0, n: int = 1, **kw):
        """A future of ``fn(*args, **kw)`` run on the ordered dispatch
        worker, onto the streams current on this thread, one a device of
        the engine and of ``group``, so that stream order queues every
        later reader behind its work (the current stream is per device
        and per thread).  ``item`` and ``n``: the dispatch's sequence
        number and frames, for its spans."""
        streams = [torch.cuda.current_stream(d) for d in
                   dict.fromkeys((self.device,) + (group or ()))
                   if d.type == "cuda"]

        def run():
            tracer.end("dispatch.queued", queued, item, n)
            with tracer.span("dispatch.job", item, n), \
                    contextlib.ExitStack() as on_streams:
                for st in streams:
                    on_streams.enter_context(torch.cuda.stream(st))
                return fn(*args, **kw)
        pool = self._dispatch_pool()
        queued = tracer.begin()
        return pool.submit(run)

    def _resolve_refs(self, item: int = 0):
        """The reference chain may be a thunk onto an in-flight chunk
        dispatch; resolve it to device tensors (``item``: the waiting
        dispatch's sequence number)."""
        r = self._ref_dev
        if callable(r):
            with tracer.span("wait.dispatch", item):
                r = r()
            self._ref_dev = r
        return r

    def _stripe_group(self, ph: int, th: int):
        """The stripe devices for frames of padded height ph and coded
        height th, or None for the one-device path (port of _stripe_mesh:
        at least 2 stripes of at least 2 block rows each)."""
        n = len(self._group)
        return self._group if stripes.sharding_ok(ph, th, n) else None

    def _resolve_golden(self, ph: int, group=None):
        """The GOLDEN reference (the GOP keyframe's recon) padded to the
        working height, and as row slices on the stripe devices with a
        ``group``: golden is constant between keyframes, so the split is
        made once a GOP.  None when the golden tool is off."""
        if not self._golden or self._golden_dev is None:
            return None
        if self._golden_dev[0].shape[0] != ph:
            self._golden_dev = _pad_rows(self._golden_dev, ph, edge=False)
        if group is None:
            return self._golden_dev
        if self._golden_parts is None or self._golden_parts[0] != ph:
            self._golden_parts = (ph, [stripes.shard_rows(group, p)
                                       for p in self._golden_dev])
        return self._golden_parts[1]

    def _sign_bias(self, oh: int, refresh: bool = True) -> tuple:
        """RefFrameSignBias of an inter frame with order hint ``oh``, from
        the slots' hints; a refreshing frame then takes slot 0."""
        sb = W.ref_frame_sign_bias(oh, self._slot_hints,
                                   _ref_slots(self._golden))
        if refresh:
            self._slot_hints[0] = oh
        return sb

    def _chunk_cap(self, width: int, height: int, bit_depth: int) -> int:
        """K P-frames per chunk dispatch, capped as the JAX engine caps
        them (8 x 1920x1088 samples, its validated compile envelope):
        K decides when a rate controller sees each frame's bits, so the
        same cap keeps the port's stream the reference's."""
        budget = 8 * 1920 * 1088
        px = width * height * (2 if bit_depth > 8 else 1)
        return max(1, budget // max(1, px))

    def _submit(self, frame, qindex, force_key: bool = False,
                is_key: Optional[bool] = None, refresh: bool = True):
        if is_key is None:
            is_key = self._decide_key(frame, force_key)
        if self._ref_dev is None:
            is_key = True
        item = tracer.item()
        h, w = frame.height, frame.width
        bd = frame.bit_depth
        if bd not in (8, 10):
            raise NotImplementedError(f"bit depth {bd}")
        yp, up, vp = self._pad_planes(frame, 64)
        ph, pw = yp.shape
        true_ok = _axis_true_dims_ok(w) and _axis_true_dims_ok(h, True)
        th, tw = (h, w) if true_ok else (ph, pw)
        oh = self._order_hint & 127
        self._order_hint += 1
        dev = self.device
        yj, uj, vj = (_upload(p, dev) for p in (yp, up, vp))
        # delta-upload base chain: this frame's source is the next
        # chunk's prediction base (host copy packs, device copy unpacks)
        self._src_base_host = (yp, up, vp)
        self._src_base_dev = (yj, uj, vj)
        total = ph * pw + 2 * (ph // 2) * (pw // 2)
        cap = total // SPARSE_CAP_FRACTION
        qindex = int(qindex)
        if is_key:
            # deblocking is decided per GOP: on for smooth sources, off
            # for grainy ones (the engine's own rule)
            self._gop_deblock = (noise_floor(frame.y) <= 1.0
                                 and (th % 32 == 0
                                      or (th % 32 == 16
                                          and tw % 16 == 0)))
        lfy, lfuv = lf_levels(qindex, bd) if self._gop_deblock else (0, 0)
        damp = cdef_damping(qindex) if self._cdef else None
        filters = dict(lf_y=lfy, lf_uv=lfuv, deblock=self._gop_deblock,
                       cdef=self._cdef, cdef_damping=damp or 4, lr=self._lr)
        group = self._stripe_group(ph, th)
        chips = len(group) if group else 1
        if is_key:
            trl2, _, brs = _tile_plan(th, chips)
            kplan = stripes.key_stripe_plan(th, ph, chips, trl2) \
                if group else None
            if kplan is not None:
                # tile-row-parallel keyframe: each device wavefronts its
                # own tile rows; the strip and the filters run on the
                # gathered recon, which is cropped back to ph rows
                stripe_h, ph_s, local_brs = kplan
                out = self._on_worker(
                    group, stripes.encode_key_striped,
                    group, *_pad_rows((yj, uj, vj), ph_s, edge=True),
                    qindex, bd, th, tw, stripe_h, local_brs,
                    qround=self._qround, item=item, **filters).result()
                rows = (ph, ph // 2, ph // 2) * 2 + (ph // 32,) * 9
                out = tuple(o[:r] for o, r in zip(out, rows)) + out[15:]
            else:
                # the parent of the key's waves (``key.wave``)
                with tracer.span("key", item):
                    out = torch_intra.encode_frame(
                        yj, uj, vj, qindex, nbr=ph // 32, nbc=pw // 32,
                        bit_depth=bd, th=th, tw=tw, tile_row_starts=brs,
                        qround=self._qround, **filters)
            # the filtered recon is both LAST and the GOP's GOLDEN
            self._ref_dev = out[0:3]
            self._golden_dev = out[0:3]
            self._golden_parts = None
            self._slot_hints = [oh] * 8  # a shown key refreshes every slot
            grids = torch.cat([out[i].reshape(-1) for i in range(6, 19)])
            pk = pack_outputs(out[3], out[4], out[5], grids, cap)
            return ("key", qindex, w, h, th, tw, ph, pw, bd, oh, refresh,
                    out, pk, cap, lfy, lfuv, damp, self._lr, self._golden,
                    chips, item, None)
        refs = self._resolve_refs(item)
        if group:
            # stripes need ph_s = stripe_pad(ph) rows: the source is edge-
            # padded, the references zero-padded (the halo clamp never
            # reads their pad rows); the recon keeps the pad rows
            ph = stripes.stripe_pad(ph, chips)
            out = self._on_worker(
                group, stripes.encode_inter_striped,
                group, *_pad_rows((yj, uj, vj), ph, edge=True),
                [stripes.shard_rows(group, p)
                 for p in _pad_rows(refs, ph, edge=False)],
                qindex, bd, th=th, tw=tw, qround=self._qround,
                gld=self._resolve_golden(ph, group), item=item,
                **filters).result()
        else:
            out = torch_inter.encode_frame(
                yj, uj, vj, refs[0], refs[1], refs[2], qindex, bd, th=th,
                tw=tw, qround=self._qround, gld=self._resolve_golden(ph),
                **filters)
        if refresh:
            self._ref_dev = out[5:8]
        pk = pack_outputs(out[2], out[3], out[4], _inter_grids([out]), cap)
        return ("inter", qindex, w, h, th, tw, ph, pw, bd, oh, refresh,
                out, pk, cap, lfy, lfuv, damp, self._lr, self._golden, chips,
                item, self._sign_bias(oh, refresh))

    def _submit_chunk(self, frames, qindexes):
        """K P-frames as one dispatch.  Packing, upload and launch issue
        run on the ordered dispatch worker, so the main thread
        entropy-codes older dispatches meanwhile; the reference chain
        and the device delta base become thunks on the worker's future,
        resolved by every later reader."""
        f0 = frames[0]
        w, h, bd = f0.width, f0.height, f0.bit_depth
        if bd not in (8, 10):
            raise NotImplementedError(f"bit depth {bd}")
        planes = [self._pad_planes(fr, 64) for fr in frames]
        ph, pw = planes[0][0].shape
        true_ok = _axis_true_dims_ok(w) and _axis_true_dims_ok(h, True)
        th, tw = (h, w) if true_ok else (ph, pw)
        k = len(frames)
        item = tracer.item()
        ohs = [(self._order_hint + i) & 127 for i in range(k)]
        self._order_hint += k
        sbs = [self._sign_bias(oh) for oh in ohs]
        group = self._stripe_group(ph, th)
        if group:
            # chunk x stripe: each frame padded to the stripe height; the
            # chunk carries the recon at that height
            ph = stripes.stripe_pad(ph, len(group))
            planes = [_pad_rows(p, ph, edge=True) for p in planes]
        total = ph * pw + 2 * (ph // 2) * (pw // 2)
        cap = k * (total // SPARSE_CAP_FRACTION)
        ref_prev = self._ref_dev
        # golden is read on the submit thread: the keyframe that owns it
        # was submitted synchronously before this chunk, and reading it
        # inside the worker could race a later GOP's keyframe
        gld = self._resolve_golden(ph, group)
        qi = [int(q) for q in qindexes]
        dbl = self._gop_deblock
        lf = [lf_levels(q, bd) if dbl else (0, 0) for q in qi]
        damps = [cdef_damping(q) if self._cdef else None for q in qi]
        # delta upload: snapshot the base chain here (ordered with the
        # other submits) and advance its host side to this chunk's last
        # frame; the device side advances through encode_chunk's last
        # source planes (never uploaded again)
        base_host, base_dev = self._src_base_host, self._src_base_dev
        use_pack = (self._delta_upload
                    and base_host is not None and base_dev is not None)
        self._src_base_host = planes[-1]
        dev = self.device
        kw = dict(k=k, ph=ph, pw=pw, bit_depth=bd, th=th, tw=tw, cap=cap,
                  deblock=dbl, qround=self._qround, cdef=self._cdef,
                  lr=self._lr, gld=gld, group=group)

        def worker():
            refs = ref_prev() if callable(ref_prev) else ref_prev
            refs = _pad_rows(refs, ph, edge=False)
            src = None
            if use_pack:
                with tracer.span("pack"):
                    bh = _grow(base_host, ph, pw)
                    pk = (io_pack.pack_chunk(planes, bh, bit_depth=bd)
                          if bh is not None else None)
                bdev = None
                if pk is not None:
                    bdev = base_dev() if callable(base_dev) else base_dev
                    bdev = _grow(tuple(bdev), ph, pw)
                if bdev is not None:
                    nib, ep, ev, modes = pk
                    if ev.dtype == np.uint16:
                        ev = ev.view(np.int16)
                    with tracer.span("upload"):
                        src = (to_device(nib, dev), to_device(ep, dev),
                               to_device(ev, dev), modes, *bdev)
            if src is None:
                with tracer.span("upload"):
                    src = upload_chunk_raw(planes, dev)
            with tracer.span("issue", cpu=True):
                return encode_chunk(src, refs, qi, [a for a, _ in lf],
                                    [b for _, b in lf],
                                    [d or 4 for d in damps], **kw)

        fut = self._on_worker(group, worker, item=item, n=k)
        self._ref_dev = lambda: fut.result()[0]
        self._src_base_dev = lambda: fut.result()[3]
        return (qi, w, h, th, tw, ph, pw, bd, ohs, k, fut, lf, damps,
                self._lr, self._golden, len(group) if group else 1, item,
                sbs)

    @staticmethod
    def _finalize_chunk(pending) -> list:
        """Materialize a chunk and entropy-code its K frames on the
        entropy pool (copied from the JAX engine's _finalize_chunk)."""
        (qindexes, w, h, th, tw, ph, pw, bd, ohs, k, fut, lfs,
         damps, lr_on, golden_on, chips, item, sbs) = pending
        with tracer.span("wait.dispatch", item, k):
            _, pk, full = fut.result()[:3]
        rs = (w, h) if (tw, th) != (w, h) else None
        mi_cols, mi_rows = 2 * ((tw + 7) >> 3), 2 * ((th + 7) >> 3)
        gh_t, gw_t = (mi_rows + 7) // 8, (mi_cols + 7) // 8
        gh, gw = ph // 32, pw // 32
        B = gh * gw
        ntot = ph * pw + 2 * (ph // 2) * (pw // 2)
        trl2, spans, _ = _tile_plan(th, chips)
        with tracer.span("wait.card", item, k):
            maskbytes, vals, count, grids = (t.cpu().numpy() for t in pk)
        overflow = int(count) > vals.shape[0]
        if not overflow:
            flat = native.densify(maskbytes, vals, k * ntot)
        strip = (th % 32) == 16
        nsc = 2 * gw
        mv8s = grids[:k * 2 * B].reshape(k, B, 2)
        skips = grids[k * 2 * B:k * 3 * B].reshape(k, B)
        stripss = grids[k * 3 * B:k * (3 * B + nsc)].reshape(k, nsc)
        cdefss = grids[k * (3 * B + nsc):
                       k * (3 * B + nsc + 4)].reshape(k, 4)
        urows, ucols = _lr_nru(th, tw)
        nru = urows * ucols
        p0 = k * (3 * B + nsc + 4)
        lrcs = grids[p0:p0 + k * nru].reshape(k, nru)
        p0 += k * nru
        splitss = grids[p0:p0 + k * B].reshape(k, B)
        mv16ss = grids[p0 + k * B:p0 + k * 9 * B].reshape(k, B, 4, 2)
        skip16ss = grids[p0 + k * 9 * B:
                         p0 + k * 13 * B].reshape(k, B, 4)
        refselss = grids[p0 + k * 13 * B:
                         p0 + k * 14 * B].reshape(k, B)
        p1 = p0 + k * 14 * B
        lrtapss = grids[p1:p1 + k * nru * 6].reshape(k, nru, 6)

        def one(i):
            tracer.end("entropy.queued", queued, item)
            if overflow:
                ylv, ulv, vlv = (full[j][i].cpu().numpy() for j in range(3))
            else:
                fl = flat[i * ntot:(i + 1) * ntot]
                ylv = fl[:ph * pw].reshape(ph, pw)
                ulv = fl[ph * pw:ph * pw + (ph // 2) * (pw // 2)] \
                    .reshape(ph // 2, pw // 2)
                vlv = fl[ph * pw + (ph // 2) * (pw // 2):] \
                    .reshape(ph // 2, pw // 2)
            modes = (1 + 3 * refselss[i].reshape(gh, gw)[:gh_t, :gw_t]
                     ).astype(np.int32)
            tiles = _encode_inter_tiles(
                item, qindexes[i], mi_cols, mi_rows, spans,
                (modes, mv8s[i].reshape(gh, gw, 2)[:gh_t, :gw_t],
                 skips[i].reshape(gh, gw)[:gh_t, :gw_t]),
                ylv, ulv, vlv,
                strip_skip=stripss[i] if strip else None,
                lr=((256,) + _lr_table(lrcs[i].reshape(urows, ucols),
                                       lrtapss[i]))
                if lr_on else None,
                split3=(splitss[i].reshape(gh, gw)[:gh_t, :gw_t],
                        mv16ss[i].reshape(gh, gw, 4, 2)[:gh_t, :gw_t],
                        skip16ss[i].reshape(gh, gw, 4)[:gh_t, :gw_t]),
                sign_bias=sbs[i])
            ch = None
            if damps[i] is not None:
                ch = (damps[i],) + tuple(int(x) for x in cdefss[i])
            hdr = W.write_inter_frame_header(
                tw, th, qindexes[i], order_hint=ohs[i],
                ref_slots=_ref_slots(golden_on),
                render_size=rs, tile_rows_log2=trl2,
                lf_level=lfs[i][0], lf_level_uv=lfs[i][1], cdef=ch,
                lr_types=(1, 0, 0) if lr_on else None)
            hdr.byte_align()
            return obu_mod.make_obu(
                obu_mod.OBU_FRAME,
                hdr.tobytes() + W.assemble_tile_group(tiles)), False

        # frames in parallel on the entropy pool; each frame's tiles fan
        # out further on the native tile pool (distinct pools, so no
        # nested-submit deadlock)
        queued = tracer.begin()
        with tracer.span("wait.entropy", item, k):
            return list(_entropy_pool().map(one, range(k)))

    @staticmethod
    def _finalize(pending) -> tuple[bytes, bool]:
        """Materialize a pending frame and entropy-code it (header and
        tile assembly copied from the JAX engine's _finalize)."""
        (kind, qindex, w, h, th, tw, ph, pw, bd, oh, refresh, out,
         pk, cap, lfy, lfuv, cdamp, lr_on, golden_on, chips, item,
         sbias) = pending
        rs = (w, h) if (tw, th) != (w, h) else None
        mi_cols, mi_rows = 2 * ((tw + 7) >> 3), 2 * ((th + 7) >> 3)
        gh_t, gw_t = (mi_rows + 7) // 8, (mi_cols + 7) // 8
        gh, gw = ph // 32, pw // 32
        shapes = [(ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2)]
        trl2, spans, _ = _tile_plan(th, chips)
        with tracer.span("wait.card", item):
            maskbytes, vals, count, grids = (t.cpu().numpy() for t in pk)
        lvs = _unpack_levels(maskbytes, vals, count, shapes)
        strip = (th % 32) == 16
        nsc = 2 * gw
        B = gh * gw
        urows, ucols = _lr_nru(th, tw)
        nru = urows * ucols
        # layouts -- key:   [mode B][uv B][skip B][angle B][split B]
        #                   [m16 4B][uv16 4B][a16 4B][s16 4B]
        #                   [strip nsc][cdefs 4][lr nru][taps 6nru]
        #            inter: [mv8 2B][skip B][strip nsc][cdefs 4][lr nru]
        #                   [split B][mv16 8B][skip16 4B][refsel B]
        #                   [taps 6nru]
        cdef_off = (21 * B if kind == "key" else 3 * B) + nsc
        lr_arg = None
        lr_kw = {}
        if lr_on:
            lr_choice = grids[cdef_off + 4:cdef_off + 4 + nru].reshape(
                urows, ucols)
            lr_arg = (256,) + _lr_table(lr_choice,
                                        grids[-6 * nru:].reshape(nru, 6))
            lr_kw["lr_types"] = (1, 0, 0)
        cdef_hdr = None
        if cdamp is not None:
            cdef_hdr = (cdamp,) + tuple(
                int(x) for x in grids[cdef_off:cdef_off + 4])
        if kind == "key":
            if lvs is None:
                lvs = [t.cpu().numpy() for t in out[3:6]]
            lv_y, lv_u, lv_v = lvs
            ng = B
            g_mode = grids[:ng].reshape(gh, gw)
            g_uv = grids[ng:2 * ng].reshape(gh, gw)
            g_skip = grids[2 * ng:3 * ng].reshape(gh, gw)
            g_angle = grids[3 * ng:4 * ng].reshape(gh, gw)
            g_split = grids[4 * ng:5 * ng].reshape(gh, gw)
            g_m16 = grids[5 * ng:9 * ng].reshape(gh, gw, 4)
            g_uv16 = grids[9 * ng:13 * ng].reshape(gh, gw, 4)
            g_a16 = grids[13 * ng:17 * ng].reshape(gh, gw, 4)
            g_s16 = grids[17 * ng:21 * ng].reshape(gh, gw, 4)
            strip_skip = grids[21 * ng:21 * ng + nsc] if strip else None
            tiles = native.encode_tile_rows(
                "key", qindex, mi_cols, mi_rows, spans,
                (g_mode[:gh_t, :gw_t], g_uv[:gh_t, :gw_t],
                 g_skip[:gh_t, :gw_t]), lv_y, lv_u, lv_v,
                strip_skip=strip_skip, lr=lr_arg,
                angles=g_angle[:gh_t, :gw_t],
                key_split5=(g_split[:gh_t, :gw_t], g_m16[:gh_t, :gw_t],
                            g_uv16[:gh_t, :gw_t], g_a16[:gh_t, :gw_t],
                            g_s16[:gh_t, :gw_t]))
            hdr = W.write_key_frame_header(tw, th, qindex, order_hint=oh,
                                           render_size=rs,
                                           tile_rows_log2=trl2,
                                           lf_level=lfy, lf_level_uv=lfuv,
                                           cdef=cdef_hdr, **lr_kw)
            hdr.byte_align()
            seq = SpecSequenceHeader(
                w, h, bd, enable_cdef=cdamp is not None,
                enable_restoration=lr_on).seq_obu()
            payload = seq + obu_mod.make_obu(
                obu_mod.OBU_FRAME,
                hdr.tobytes() + W.assemble_tile_group(tiles))
            return payload, True
        if lvs is None:
            lvs = [t.cpu().numpy() for t in out[2:5]]
        ylv, ulv, vlv = lvs
        mv8 = grids[:2 * B].reshape(B, 2)
        skip = grids[2 * B:3 * B]
        strip_skip = grids[3 * B:3 * B + nsc] if strip else None
        tail = cdef_off + 4 + nru
        splits = grids[tail:tail + B].reshape(gh, gw)
        mvs16 = grids[tail + B:tail + 9 * B].reshape(gh, gw, 4, 2)
        skips16 = grids[tail + 9 * B:tail + 13 * B].reshape(gh, gw, 4)
        refsel = grids[tail + 13 * B:tail + 14 * B].reshape(gh, gw)
        # inter mode grid: 1 = inter/LAST, 4 = inter/GOLDEN (slot 1)
        modes = (1 + 3 * refsel[:gh_t, :gw_t]).astype(np.int32)
        tiles = _encode_inter_tiles(
            item, qindex, mi_cols, mi_rows, spans,
            (modes, mv8.reshape(gh, gw, 2)[:gh_t, :gw_t],
             skip.reshape(gh, gw)[:gh_t, :gw_t]),
            ylv, ulv, vlv, strip_skip=strip_skip, lr=lr_arg,
            split3=(splits[:gh_t, :gw_t], mvs16[:gh_t, :gw_t],
                    skips16[:gh_t, :gw_t]), sign_bias=sbias)
        hdr = W.write_inter_frame_header(
            tw, th, qindex, order_hint=oh,
            refresh_frame_flags=0x01 if refresh else 0x00,
            ref_slots=_ref_slots(golden_on),
            render_size=rs, tile_rows_log2=trl2,
            lf_level=lfy, lf_level_uv=lfuv, cdef=cdef_hdr, **lr_kw)
        hdr.byte_align()
        payload = obu_mod.make_obu(
            obu_mod.OBU_FRAME, hdr.tobytes() + W.assemble_tile_group(tiles))
        return payload, False

    # ---- daemon surface -------------------------------------------------
    def sequence_header(self, width: int, height: int, bit_depth: int = 8,
                        source_stream=None) -> SpecSequenceHeader:
        sh = SpecSequenceHeader(width, height, bit_depth,
                                enable_cdef=self._cdef,
                                enable_restoration=self._lr)
        if source_stream is not None:
            sh.color_primaries = getattr(source_stream,
                                         "color_primaries_code", 0)
            sh.color_transfer = getattr(source_stream,
                                        "color_transfer_code", 0)
            sh.color_matrix = getattr(source_stream, "color_matrix_code",
                                      0)
        return sh

    def codec_private(self, sh) -> bytes:
        return sh.av1c()

    def _prewarm(self, width: int, height: int, bit_depth: int = 8):
        """Build, before frames flow, what the first frame would
        otherwise build inside the timed path: the CUDA kernel library
        and a context on every card of the stripe group (the card's own
        with one device), and the native tile writer.  The JAX engine
        compiles its XLA programs here; the port has nothing to compile.
        Nothing is encoded, so the rate controller and the reference
        chain are untouched and no output byte changes."""
        cards = [d for d in dict.fromkeys((self.device,) + self._group)
                 if d.type == "cuda"]
        if cards:
            D.kernels()
        for d in cards:
            torch.empty(1, device=d)
        native._lib()
