"""Rank processes for the tests of the port's multi-process stripes.

``run(n, job, workdir, **inputs)`` pickles ``inputs`` into ``workdir``
and starts ranks 0..n-1 of this file (``python tests/torch_dist_ranks.py
JOB WORKDIR``), each with ``AV1TPU_COORDINATOR`` on 127.0.0.1 at a free
port, ``AV1TPU_NUM_PROCESSES`` = n and ``AV1TPU_PROCESS_ID`` = its rank,
as a user starts the daemon's ranks.  It waits for all of them, kills
the others as soon as one fails or the time is up, and returns each
rank's result in rank order.  Each job joins the process group through
the port's own entry points (``make_engine`` or
``distributed.maybe_initialize``) on ``inputs["device"]``: gloo on the
CPU, NCCL on cards.  Nothing here imports JAX, so the card-only tests
use it too.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(n: int, job: str, workdir, timeout: float = 120, **inputs) -> list:
    """Each rank's result of ``job`` over n ranks (see the module
    docstring); a rank that fails, or a run past ``timeout`` seconds,
    fails the caller with the failing rank's output."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               AV1TPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               AV1TPU_NUM_PROCESSES=str(n))
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, workdir],
        env=dict(env, AV1TPU_PROCESS_ID=str(r)), cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else 0
                logs[r].seek(0)
                raise AssertionError(
                    f"rank {r} of {n} ({job}): "
                    + (f"exit code {procs[r].returncode}" if bad else
                       f"still running after {timeout} s")
                    + "\n" + logs[r].read()[-4000:])
            time.sleep(0.05)
        for r, p in enumerate(procs):
            logs[r].seek(0)
            assert p.returncode == 0, f"rank {r}: {logs[r].read()[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for r in range(n):
        with open(os.path.join(workdir, f"result{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def spied_stream(eng, frames, q):
    """(payloads, recons, striped calls) of ``eng.encode_stream(frames,
    q)``.  Each frame's reconstruction (numpy) is captured from the
    outermost encoder call that makes it (a stripes entry, or the
    one-device encoder), and the stripes entries' calls are counted."""
    from av1tpu_torch.specav1 import stripes, torch_inter, torch_intra
    calls = {"key": 0, "inter": 0}
    recons = []
    inside = threading.local()
    real = {(stripes, "encode_key_striped"): ("key", slice(0, 3)),
            (stripes, "encode_inter_striped"): ("inter", slice(5, 8)),
            (torch_intra, "encode_frame"): (None, slice(0, 3)),
            (torch_inter, "encode_frame"): (None, slice(5, 8))}

    def spy(fn, kind, sl):
        def call(*a, **k):
            depth = getattr(inside, "depth", 0)
            inside.depth = depth + 1
            try:
                out = fn(*a, **k)
            finally:
                inside.depth = depth
            if depth == 0:
                recons.append(tuple(p.cpu().numpy().copy() for p in out[sl]))
                if kind:
                    calls[kind] += 1
            return out
        return call

    saved = {key: getattr(*key) for key in real}
    for (mod, name), (kind, sl) in real.items():
        setattr(mod, name, spy(saved[mod, name], kind, sl))
    try:
        out = list(eng.encode_stream(frames, q))
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return [p for p, _ in out], recons, calls


def decodes_to(payloads, recons):
    """The port's spec decoder reproduces every recon plane."""
    from av1tpu_torch.specav1 import decoder
    dec = decoder.decode_stream(payloads)
    assert len(dec) == len(payloads) == len(recons)
    for d, r in zip(dec, recons):
        for pl in range(3):
            hh, ww = d[pl].shape
            np.testing.assert_array_equal(np.asarray(d[pl], np.int64),
                                          r[pl][:hh, :ww].astype(np.int64))


# --- the rank side -----------------------------------------------------------

def _numpy(ts):
    return [t.cpu().numpy() for t in ts]


def _size_or_error(make):
    try:
        return len(make())
    except ValueError:
        return "ValueError"


def job_init(device):
    """maybe_initialize twice, and the groups the engine (num_chips 0, 1
    and 2) and make_mesh (0 and 2) build under it."""
    import torch.distributed as dist

    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.encoder.mesh import distributed
    from av1tpu_torch.legacy import mesh_sharding
    from av1tpu_torch.spec_engine import SpecTorchEngine
    first = distributed.maybe_initialize(device)
    again = distributed.maybe_initialize(device)
    return {"first": first, "again": again, "backend": dist.get_backend(),
            "world": distributed.world_size(), "rank": distributed.rank(),
            "device": str(distributed.rank_device(device)),
            "groups": {n: _size_or_error(lambda n=n: SpecTorchEngine(
                TpuEncoderConfig(num_chips=n), device=device)._group)
                for n in (0, 1, 2)},
            "mesh": _size_or_error(lambda: mesh_sharding.make_mesh(
                0, device)),
            "mesh2": _size_or_error(lambda: mesh_sharding.make_mesh(
                2, device))}


def job_stream(device, cfg, frames, q=96):
    """The daemon's engine (make_engine) over ``frames``: payloads,
    recons, striped calls, the stripe count and the kernels' launches."""
    from av1tpu_torch.config import TpuEncoderConfig, TranscodeConfig
    from av1tpu_torch.daemon.engine import make_engine
    from av1tpu_torch.encoder.kernels import gather, refine
    eng = make_engine(TranscodeConfig(tpu=TpuEncoderConfig(**cfg)), device)
    counters = (gather.gather_windows, gather.gather_windows2,
                refine.refine_ssd)
    for fn in counters:
        fn.launches = 0
    payloads, recons, calls = spied_stream(eng, frames, q)
    return {"payloads": payloads, "recons": recons, "calls": calls,
            "stripes": len(eng._group), "device": str(eng.device),
            "launches": [fn.launches for fn in counters]}


def job_inter(device, planes, args, kw):
    """stripes.encode_inter_striped over the ranks: planes = (y, u, v,
    LAST y, u, v, GOLDEN y, u, v) as numpy."""
    import torch

    from av1tpu_torch.encoder.mesh import distributed
    from av1tpu_torch.specav1 import stripes
    distributed.maybe_initialize(device)
    dev = distributed.rank_device(device)
    group = stripes.Ranks(dev, distributed.world_size(), distributed.rank())
    t = [torch.from_numpy(p).to(dev) for p in planes]
    out = stripes.encode_inter_striped(
        group, *t[:3], [stripes.shard_rows(group, p) for p in t[3:6]],
        *args, gld=[stripes.shard_rows(group, p) for p in t[6:]], **kw)
    return _numpy(out)


def job_mesh(device, planes, key_planes, dq, q, block):
    """The private profile's three stripe functions over make_mesh(0),
    every rank: the v1 and v2 P-frames on ``planes`` (source y, u, v, then
    the reference's), the v2 keyframe on ``key_planes``."""
    import torch

    from av1tpu_torch.encoder.mesh import distributed
    from av1tpu_torch.legacy import mesh_sharding as ms
    distributed.maybe_initialize(device)
    g = ms.make_mesh(0, device)
    p = [torch.from_numpy(a).to(g[0]) for a in planes]
    k = [torch.from_numpy(a).to(g[0]) for a in key_planes]
    outs = (ms.encode_inter_frame_sharded(*p, *dq, block, g),
            ms.encode_inter_frame_sharded_v2(*p, *dq, q, block, g),
            ms.encode_key_frame_sharded_v2(*k, *dq, q, block, g))
    return [[o if isinstance(o, int) else o.cpu().numpy() for o in out]
            for out in outs]


def _main(job: str, workdir: str) -> None:
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    result = globals()[f"job_{job}"](**inputs)
    import torch.distributed as dist
    dist.destroy_process_group()
    rank = os.environ["AV1TPU_PROCESS_ID"]
    path = os.path.join(workdir, f"result{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


if __name__ == "__main__":
    _main(*sys.argv[1:3])
