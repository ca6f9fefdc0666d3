"""Runs one cell of ``BENCHMARK.json``: set-up, the measured window over
``encode_stream``, the metrics, and the comparison that decides
``correct``.

Every cell is driven by data found by name: its configuration's file,
``traffic/<traffic>.json`` (read by ``gen.py``), ``limits/<cell>.json``,
and for each of its metrics ``end_to_end/<metric>.py`` or
``layers/<metric>.py``, a reader of a ``Run`` that declares the spans it
needs (``SPANS``) and returns its number, or None where it finds nothing
to read.

The window: the engine is the daemon's (``make_engine``, ``_prewarm``,
``start_stream``), the stream ``encode_stream(frames, qindex)`` at the
configuration's fixed qindex.  Set-up is everything up to the yield of
payload ``warm_payloads`` (the GOP's key and the first chunks in a P
cell, the first key in a cut cell), which opens the window; the window
closes at the first payload yielded ``--seconds`` or more after that, and
its frames are the payloads yielded after the opening one up to the
closing one, so a rate spans whole dispatches.

The check: the reconstructions of frame 0, of the traffic's metric
frames, of one frame in ``check_every`` of the others drawn from the
seed, and of the most recent frames at the close are kept (int16 copies
on the device, taken as the encoder returns them); once the window has
closed and the program is freed, libaom decodes the stream from its
first payload and every kept frame up to the close is compared
(``reference.check_stream``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from benchmark import aomdec, gen, reference, trace
from benchmark import faults as faults_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the frames a run's seeded draw of compared frames reaches
MAX_FRAMES = 100_000

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "av1tpu")


# spans of every traced run: what the idle gaps of the breakdown are named by
LABEL_SPANS = [{"target": "engine:_submit", "name": "submit"},
               {"target": "engine:_submit_chunk", "name": "submit_chunk"},
               {"target": "av1tpu_torch.spec_engine:encode_chunk",
                "name": "encode_chunk"},
               {"target": "av1tpu_torch.encoder.io_pack:pack_chunk",
                "name": "pack"},
               {"target": "engine:_finalize", "name": "finalize"},
               {"target": "engine:_finalize_chunk", "name": "finalize"},
               {"target": "av1tpu_torch.specav1.native:encode_tile_rows",
                "name": "entropy"},
               {"target": "av1tpu_torch.specav1.torch_intra:_block_step",
                "name": "key_wave"}]


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def _load_module(path: str, kind: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, spec_root: str = ROOT) -> dict:
    """The cell's entries and data files, and its metrics' readers."""
    with open(os.path.join(spec_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    bdir = os.path.join(spec_root, bench["paths"][0])

    def data(path):
        with open(path) as f:
            return json.load(f)

    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (workload in m["workloads"] if "workloads" in m
                  else m["moves"] in names)]
    return {
        "name": workload, "chips": int(cell["chips"]),
        "config": data(os.path.join(spec_root, conf["file"])),
        "traffic": data(os.path.join(bdir, "traffic",
                                     cell["traffic"] + ".json")),
        "limits": data(os.path.join(bdir, "limits", workload + ".json")),
        "end_to_end": [(m, _load_module(os.path.join(
            bdir, "end_to_end", m["name"] + ".py"), "e2e", m["name"]))
            for m in e2e],
        "per_layer": [(m, _load_module(os.path.join(
            bdir, "layers", m["name"] + ".py"), "layer", m["name"]))
            for m in layers],
    }


class Frames:
    """Gives each frame the engine encodes its index in the stream (the
    order of the submits on the caller's thread, chunks' frames in order
    on the dispatch worker), and keeps int16 copies of the
    reconstructions that the check and the metrics read: those of
    ``keep``, and the ``ring`` most recent others."""

    def __init__(self, keep: set, ring: int, rec: trace.Recorder):
        self.keep, self.ring, self.rec = keep, ring, rec
        self.kept, self.recent = {}, OrderedDict()
        self.next = 0
        self.tls = threading.local()
        self.queue = deque()
        self.lock = threading.Lock()
        self.key_s = []  # host seconds of each key's submit

    def on_submit(self, fn, a, k):
        self.tls.idx = self.next
        self.next += 1
        t = time.perf_counter()
        try:
            out = fn(*a, **k)
        finally:
            self.tls.idx = None
        if out[0] == "key":
            self.key_s.append(time.perf_counter() - t)
        return out

    def on_submit_chunk(self, fn, a, k):
        n = len(a[0])
        with self.lock:
            self.queue.extend(range(self.next, self.next + n))
        self.next += n
        return fn(*a, **k)

    def encoder(self, sl: slice):
        """The spy of a frame encoder whose outputs ``sl`` are the
        reconstruction; only the outermost call on a thread counts."""
        def call(fn, a, k):
            depth = getattr(self.tls, "depth", 0)
            self.tls.depth = depth + 1
            try:
                out = fn(*a, **k)
            finally:
                self.tls.depth = depth
            if depth == 0:
                idx = getattr(self.tls, "idx", None)
                if idx is None:
                    with self.lock:
                        idx = self.queue.popleft()
                self._store(idx, out[sl])
            return out
        return call

    def _store(self, idx: int, planes) -> None:
        import torch
        if idx not in self.keep and not self.ring:
            return
        t0 = time.perf_counter()
        copy = tuple(p.to(torch.int16) for p in planes)
        if self.rec.profiling:  # the trace leaves these copies out
            self.rec.add("capture", t0, time.perf_counter())
        if idx in self.keep:
            self.kept[idx] = copy
            return
        self.recent[idx] = copy
        while len(self.recent) > self.ring:
            self.recent.popitem(last=False)

    def host(self, idx: int, h: int, w: int):
        """Frame idx's reconstruction on the host, cropped to h x w."""
        planes = self.kept.get(idx) or self.recent.get(idx)
        if planes is None:
            raise KeyError(f"no reconstruction kept for frame {idx}")
        return tuple(p[:hh, :ww].cpu().numpy() for p, hh, ww in
                     zip(planes, (h, h // 2, h // 2), (w, w // 2, w // 2)))


class OpCount:
    """Counts the ATen operations dispatched on the device, views left
    out: the kernel launches of a path too long for the profiler."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not getattr(func, "is_view", False) and any(
                        getattr(t, "is_cuda", False)
                        for t in (out if isinstance(out, (tuple, list))
                                  else (out,))):
                    counter.n += 1
                return out
        self.n = 0
        self.mode = Mode()


class SubWindow:
    """The traced sub-window of ``profile`` in the traffic file, from the
    yield of counted payload ``start`` to that of ``start + frames`` or
    the first yield after it by which every span named in ``spans`` has
    run whole inside the profiler that many times (the dispatches run
    ahead of the yields, so those of the first frames may have begun
    before it): torch.profiler over all of it; or, with ``waves`` [a, b), the
    profiler over those waves of the keyframe wavefront of the first
    submit in it (a whole 1080p key is too many launches to trace).  The
    run's first ``count_ops`` submits (set-up's keys) run under
    ``OpCount``."""

    def __init__(self, params: dict, rec, on_cuda: bool, traced: bool):
        self.start = int(params["start"])
        self.frames = int(params["frames"])
        self.count_ops = int(params.get("count_ops", 0))
        self.waves = params.get("waves")
        self.spans = dict(params.get("spans", {}))
        self.j_stop = self.start + self.frames  # the yield that stopped it
        self.rec, self.on_cuda, self.traced = rec, on_cuda, traced
        self.active = False
        self.wave = None
        self.cm = self.prof = None
        self.key_ops = []

    def _begin(self):
        self.cm = trace.profiled(self.rec, self.on_cuda)
        self.prof = self.cm.__enter__()

    def stop(self):
        self.active = False
        if self.cm is not None:
            cm, self.cm = self.cm, None
            cm.__exit__(None, None, None)

    def at_yield(self, j: int):
        if not self.traced:
            return
        if j == self.start:
            self.active = True
            if not self.waves:
                self._begin()
        elif self.waves:
            if j == self.start + self.frames:
                self.stop()
        elif (j >= self.start + self.frames and self.cm is not None
              and all(self.rec.count(n) >= c for n, c in self.spans.items())):
            self.j_stop = j
            self.stop()

    def done(self, j: int) -> bool:
        """Whether the window may close at counted payload j: a traced
        run's window holds its whole sub-window."""
        return not self.traced or (j >= self.start + self.frames
                                   and self.cm is None)

    def on_submit(self, fn, a, k):
        if len(self.key_ops) < self.count_ops:
            c = OpCount()
            with c.mode:
                out = fn(*a, **k)
            self.key_ops.append(c.n)
            return out
        if not (self.active and self.waves and self.wave is None
                and self.cm is None and self.prof is None):
            return fn(*a, **k)
        self.wave = 0
        try:
            return fn(*a, **k)
        finally:
            self.wave = None
            self.stop()

    def on_wave(self, fn, a, k):
        if self.wave is not None:
            if self.wave == self.waves[0]:
                self._begin()
            elif self.wave == self.waves[1]:
                self.stop()
            self.wave += 1
        return fn(*a, **k)


class Run:
    """What a metric's reader reads: the window's frames and times, the
    spans, the trace of the profiled sub-window, and the quality
    numbers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def rate(self) -> float:
        return self.frames / (self.t_close - self.t_open)

    def spans(self, name: str) -> list:
        """The host spans of ``name`` inside the window."""
        return self.recorder.window(name, self.t_open, self.t_close)


def card_power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or "n/a"."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "n/a"
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if res.returncode == 0 and lines else "n/a"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _compare(value, limit: dict) -> bool:
    return value <= limit["max"] if "max" in limit else value >= limit["min"]


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             spec_root: str = ROOT, device: str = "cuda", size=None,
             t_start: float | None = None, control: bool = False,
             faults=(), overrides=None, log=None) -> dict:
    """One run of a cell; returns the result line's object.  ``size``
    (w, h) replaces the configuration's frame size (the CPU tests' tiny
    runs); ``control`` puts the control in the program's place in the
    check; ``faults`` are ``(target, around)`` spies installed under the
    engine (the tests' broken timed paths); ``overrides`` replace keys
    of the traffic file (the tiny runs' shorter windows)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(workload, spec_root)
    import torch
    on_cuda = device == "cuda"
    if on_cuda and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"{workload} needs {cell['chips']} CUDA card(s); "
                       f"available: {torch.cuda.is_available()}, count "
                       f"{torch.cuda.device_count()}")
    from av1tpu_torch.config import TpuEncoderConfig, TranscodeConfig
    from av1tpu_torch.daemon.engine import make_engine

    cfg, tr = cell["config"], {**cell["traffic"], **(overrides or {})}
    w, h = size or (cfg["width"], cfg["height"])
    src = gen.Source(tr, w, h, seed)
    eng = make_engine(TranscodeConfig(
        encoder="tpu", tpu=TpuEncoderConfig.from_dict(cfg["tpu"])),
        device=device)
    eng._prewarm(w, h, 8)
    eng.start_stream()

    warm = int(tr["warm_payloads"])
    n_metric = int(tr["metric_frames"])
    rec = trace.Recorder()
    rng = np.random.default_rng([int(seed), 1])
    drawn = warm + 1 + np.flatnonzero(
        rng.random(MAX_FRAMES) * int(tr["check_every"]) < 1)
    frames = Frames({0} | set(range(warm, warm + n_metric + 1))
                    | set(drawn.tolist()), int(tr["ring"]), rec)
    patches = trace.Patches(eng)
    planted = list(faults) + (faults_mod.CONTROL if control else [])
    for target, around in planted:  # underneath everything the run reads
        patches.install(target, around)
    patches.install("engine:_submit", frames.on_submit)
    patches.install("engine:_submit_chunk", frames.on_submit_chunk)
    patches.install("av1tpu_torch.specav1.torch_intra:encode_frame",
                    frames.encoder(slice(0, 3)))
    patches.install("av1tpu_torch.specav1.torch_inter:encode_frame",
                    frames.encoder(slice(5, 8)))
    if traced:
        spans = {(sp["target"], sp["name"]): sp for sp in LABEL_SPANS}
        spans.update({(sp["target"], sp["name"]): sp
                      for _, mod in cell["per_layer"]
                      for sp in getattr(mod, "SPANS", ())})
        for (target, name), sp in spans.items():
            patches.install(target, rec.around(name, sp.get("info")))

    sub = SubWindow(tr["profile"], rec, on_cuda, traced)
    if traced:
        patches.install("engine:_submit", sub.on_submit)
        patches.install("av1tpu_torch.specav1.torch_intra:_block_step",
                        sub.on_wave)
    payloads, keys, times = [], [], []
    t_open = t_close = None
    try:
        stream = eng.encode_stream(iter(src), int(cfg["qindex"]))
        for payload, is_key in stream:
            now = time.perf_counter()
            payloads.append(bytes(payload))
            keys.append(bool(is_key))
            times.append(now)
            i = len(payloads) - 1
            if i == warm:
                t_open = now
            if i >= warm:
                sub.at_yield(i - warm)
            if i > warm and now >= t_open + seconds and sub.done(i - warm):
                t_close = now
                break
        stream.close()
        sub.stop()
        # the dispatches still in flight end before anything is read
        eng.start_stream()
        if on_cuda:
            torch.cuda.synchronize()
    finally:
        sub.stop()
        patches.restore()
    if t_close is None:
        raise RuntimeError("the stream ended before the window closed")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded after the window: {bad}")

    close = len(payloads) - 1
    counted = list(range(warm + 1, close + 1))
    if len(counted) < n_metric:
        raise RuntimeError(f"the window completed {len(counted)} frames, "
                           f"fewer than the traffic's {n_metric}")
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    log("key submits (s, in order): "
        + ", ".join(f"{x:.3f}" for x in frames.key_s[:4]))
    log(f"window: {len(counted)} frames in {t_close - t_open:.3f} s, "
        f"overrun {t_close - t_open - seconds:.3f} s past {seconds} s; "
        f"set-up {t_open - t_start:.3f} s ({warm + 1} payloads)")

    # what the reference reads, on the host; then the program is freed
    metric_idx = counted[:n_metric]
    compared = sorted(i for i in set(frames.kept) | set(frames.recent)
                      if i <= close)
    host = {i: frames.host(i, h, w) for i in compared}
    recorder_trace = None
    a_sub, b_sub = warm + sub.start, warm + sub.j_stop
    if sub.prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        t = time.perf_counter()
        try:
            recorder_trace = trace.Trace.from_profiler(sub.prof, path, rec)
        finally:
            os.unlink(path)
        log(f"trace: {len(recorder_trace.kernels)} kernels in "
            f"{(recorder_trace.t1 - recorder_trace.t0) / 1e6:.6f} s "
            f"profiled (the profiler took {rec.start_s:.3f} s to start); "
            f"payloads {a_sub}-{b_sub} of the stream; read in {time.perf_counter() - t:.3f} s; spans "
            f"{ {n: len(v) for n, v in recorder_trace.ranges.items()} }; "
            f"launches placed by thread: {recorder_trace.by_thread} of "
            f"{len(recorder_trace.launch)} (the others by time); trace "
            f"thread ids: {recorder_trace.thread_ids} (shares of an unmatched "
            f"id's launches that the two likeliest threads' spans hold: "
            f"{recorder_trace.shares}); markers found (start, "
            f"end): {recorder_trace.marks}; clock shift "
            f"{recorder_trace.shift:.1f} us, drift over the sub-window "
            f"{recorder_trace.drift:.1f} us")
    if sub.key_ops:
        log(f"ATen ops dispatched on the device in a key: {sub.key_ops}")
    del frames, eng, sub.prof
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # the numbers compared, each beside its limit
    sources_y = {i: src.frame(i).y for i in compared}
    verdict = reference.check_stream(payloads, host, sources_y)
    bad_frames = [i for i, n in verdict["mismatch"].items() if n]
    log(f"reference: libaom {aomdec.version()} decoded frames 0-"
        f"{compared[-1]} in {verdict['seconds']:.3f} s and compared "
        f"{len(verdict['mismatch'])} of them ({len(metric_idx)} metric "
        f"frames, {sum(i > metric_idx[-1] for i in compared)} after them); "
        f"differing: {bad_frames[:20]}")
    if "error" in verdict:
        log(f"reference: {verdict['error']}")
    psnrs = [reference.psnr_y(host[i][0], sources_y[i])
             for i in metric_idx]
    numbers = {
        "decode_mismatch_px": sum(verdict["mismatch"].values()),
        "psnr_y_min_db": min(psnrs + list(verdict["psnr_y"].values())),
        "non_key_payloads": sum(1 for k in keys if not k),
    }
    checks = {}
    ok = "error" not in verdict
    for name, lim in cell["limits"].items():
        val = numbers[name]
        checks[name] = {"value": val, "limit": lim}
        ok = ok and _compare(val, lim)

    run = Run(frames=len(counted), t_open=t_open, t_close=t_close,
              setup_s=t_open - t_start,
              bits_per_pixel=8.0 * sum(len(payloads[i]) for i in metric_idx)
              / (len(metric_idx) * w * h),
              psnr_y_db=reference.psnr_y_frames(
                  [host[i][0] for i in metric_idx],
                  [sources_y[i] for i in metric_idx]),
              recorder=rec, trace=recorder_trace, key_ops=sub.key_ops)
    readers = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for m, mod in readers:
        val = mod.read(run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    a, b = a_sub, b_sub
    if traced and b <= close and len(counted) > b - a:
        inside = (b - a) / (times[b] - times[a])
        rest = (len(counted) - (b - a)) / (
            times[close] - t_open - (times[b] - times[a]))
        log(f"rate {run.rate:.6f} frames/s over the window, spans on: "
            f"{inside:.6f} in the profiled sub-window, {rest:.6f} outside "
            "it (the tracing overhead; the --trace 0 runs give the rate "
            "without spans)")
    else:
        log(f"rate {run.rate:.6f} frames/s over the window")
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak),
           "power_limit": card_power_limit() if on_cuda else "n/a"}
    out = {"correct": bool(ok), "attempted": len(counted),
           "failed": len(bad_frames) + ("error" in verdict),
           "metrics": metrics, "device": dev}
    if traced and recorder_trace is not None:
        dev["busy_s"] = recorder_trace.busy_us() / 1e6
        dev["window_s"] = (recorder_trace.t1 - recorder_trace.t0) / 1e6
        out["breakdown"] = recorder_trace.breakdown()
    out["checks"] = checks
    return out
