# Copied from av1tpu/daemon/engine.py (the engines are SpecTorchEngine and
# LegacyTorchEngine; the multi-process group is torch.distributed's).
"""Engine bootstrap and self-test (the EnsureFFmpeg/VerifyFFmpeg analog).

The reference downloads a static ffmpeg, verifies its version and encoder
list, and runs a live 1-frame 1280x720 synthetic encode at every daemon
start (internal/ffmpeg/binary.go:21-310).  Our engine is in-process, so
"ensure" reduces to constructing it on the requested device (the card
unless the caller asks for the CPU), and "verify" runs the same hermetic
smoke test: one synthetic 1280x720 frame through the full encode path
(binary.go:282-295 analog).

With ``tpu.num_chips`` = n >= 2 and more than one visible card, the
engine encodes each frame in tile-row stripes over up to n cards, in
this one process (``SpecTorchEngine``'s stripe group; 0, the default,
keeps one card).  With the ``AV1TPU_*`` variables set, ``make_engine``
first joins their process group (``encoder/mesh/distributed.py``, the
reference's multi-host initialization): every rank runs the same daemon
on its own card, and the stripes are the ranks, one each.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger("av1tpu_torch.engine")


class EngineError(Exception):
    """Actionable engine bootstrap/self-test failure (binary.go:313-330 analog)."""


def make_engine(cfg, device: str = "cuda"):
    """Construct the configured engine ("tpu" is the only real engine)
    on ``device``: ``SpecTorchEngine``, striped over up to
    ``cfg.tpu.num_chips`` cards where that is 2 or more (over the ranks
    under the ``AV1TPU_*`` process group), or with
    ``tpu.bitstream: "av1tpu"`` the private profile's
    ``LegacyTorchEngine``.  A missing card raises EngineError; nothing
    falls back to the CPU unless the caller asks for it."""
    from av1tpu_torch.encoder.mesh import distributed
    if cfg.encoder != "tpu":
        raise EngineError(
            f"unknown encoder '{cfg.encoder}' (this build provides 'tpu'); "
            "set \"encoder\": \"tpu\" in the config")
    try:
        # multi-process init is env-driven and a no-op in one process; it
        # runs before the first device touch, so that "cuda" is the
        # rank's card (encoder/mesh/distributed.py)
        distributed.maybe_initialize(device)
        if getattr(cfg.tpu, "bitstream", "spec") == "av1tpu":
            from av1tpu_torch.legacy.engine import LegacyTorchEngine
            return LegacyTorchEngine(cfg.tpu, device=device)
        from av1tpu_torch.spec_engine import SpecTorchEngine
        return SpecTorchEngine(cfg.tpu, device=device)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        raise EngineError(f"engine unavailable on {device!r}: {e}") from e


def verify_engine(engine, size: str = "1280x720") -> float:
    """1-frame synthetic encode self-test; returns elapsed seconds.

    Hermetic input, real hardware — the analog of the reference's
    ``-f lavfi -i testsrc2=s=1280x720:d=1 ... -c:v av1_qsv -f null -``
    startup probe (binary.go:244-310).  Raises EngineError on failure with
    an actionable message.  ``size`` is configurable (tpu.self_test_size).
    """
    from av1tpu_torch.utils.testsrc import testsrc2
    try:
        w, h = (int(x) for x in size.lower().split("x"))
    except ValueError:
        w, h = 1280, 720
    frame = testsrc2(w, h, frame_index=0)
    t0 = time.monotonic()
    try:
        payload = engine.encode_smoke_frame(frame)
    except Exception as e:
        raise EngineError(
            f"self-test encode failed: {e}; check that the card is "
            "healthy (torch.cuda.is_available()) and no other process "
            "holds it") from e
    if not payload:
        raise EngineError("self-test encode produced no bitstream")
    dt = time.monotonic() - t0
    log.info("engine self-test OK: 1 frame %dx%d in %.2fs (%d bytes)",
             w, h, dt, len(payload))
    return dt
