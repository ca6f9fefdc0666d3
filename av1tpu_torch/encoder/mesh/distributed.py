# Ported from av1tpu/encoder/mesh/distributed.py (jax.distributed there,
# a torch.distributed process group here).
"""Multi-process initialization.

The JAX package calls ``jax.distributed.initialize(...)`` in every
process before the first device touch, after which ``jax.devices()``
spans the whole job and its stripe mesh covers every process's devices.
Here every process joins one ``torch.distributed`` process group (NCCL
between cards, gloo on the CPU), after which a stripe group spans the
processes: stripe k on rank k's card (``specav1.stripes.Ranks``), each
rank issuing its own stripe while the others issue theirs, halos, gathers
and frame-global sums going through the group's collectives.

The daemon enables this purely through environment variables, so
single-process deployments pay nothing:

  AV1TPU_COORDINATOR=host0:8476   coordinator address (rank 0's)
  AV1TPU_NUM_PROCESSES=4          total processes in the job
  AV1TPU_PROCESS_ID=2             this process's rank

``maybe_initialize()`` is called from the engine bootstrap; without the
variables it is a no-op.  Each rank runs on one card:
``cuda:(rank % visible cards)``, or the card it is given.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("av1tpu_torch.engine")

# a rank that died or raised ends the others' pending collectives after
# this long instead of hanging them
TIMEOUT = datetime.timedelta(minutes=10)


def active() -> bool:
    """True once this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank_device(device="cuda", rank_id=None) -> torch.device:
    """The rank's device: a card given with its index as given, ``"cuda"``
    the card ``rank % visible cards``, the CPU as it is."""
    from av1tpu_torch import device as D
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            return D.resolve_device(dev)  # raises: no card
        r = rank() if rank_id is None else rank_id
        dev = torch.device("cuda", r % torch.cuda.device_count())
    return D.resolve_device(dev)


def maybe_initialize(device="cuda", backend=None) -> bool:
    """Join the process group the AV1TPU_* variables describe.  Returns
    True when multi-process mode is active; safe to call repeatedly.
    ``backend``: "nccl" for a card and "gloo" for the CPU unless given
    (gloo also carries card tensors, through the host)."""
    if active():
        return True
    coord = os.environ.get("AV1TPU_COORDINATOR")
    if not coord:
        return False
    nproc = int(os.environ.get("AV1TPU_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("AV1TPU_PROCESS_ID", "0"))
    dev = rank_device(device, pid)
    if dev.type == "cuda":
        # "cuda" now means this rank's card, for every engine and tool
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=nproc, rank=pid, timeout=TIMEOUT)
    log.info("torch.distributed initialized (%s): %d processes, rank %d "
             "on %s, coordinator %s", backend, nproc, pid, dev, coord)
    return True
