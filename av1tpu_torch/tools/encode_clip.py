# Copied from av1tpu/tools/encode_clip.py; it drives SpecTorchEngine and
# verifies with the port's spec decoder (see the docstring).
"""Encode a clip (synthetic or video file) to spec-AV1 IVF; optionally verify.

Usage:
  python -m av1tpu_torch.tools.encode_clip --width 320 --height 192 \
      --frames 8 --out /tmp/x.ivf [--qindex 96] [--input source.mp4] \
      [--verify] [--cpu]

Two departures from the JAX package's tool, whose engine and decoder
(the retired ``bitstream: "av1tpu"`` TpuEngine and the legacy decoder)
are not ported: frames go one at a time through
``SpecTorchEngine(TpuEncoderConfig()).encode_next`` on the card (on the
CPU with ``--cpu``; without it and without a card the tool fails), and
the IVF holds spec-AV1 temporal units, each a temporal delimiter OBU
and the frame's payload (a keyframe's payload carries the
``SpecSequenceHeader`` OBU), which ``--verify`` decodes with the port's
spec decoder.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--qindex", type=int, default=96)
    p.add_argument("--keyint", type=int, default=120)
    p.add_argument("--cpu", action="store_true",
                   help="encode on the CPU (default: the CUDA card)")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--input", help="source video (default: synthetic testsrc)")
    p.add_argument("--out", required=True)
    p.add_argument("--verify", action="store_true",
                   help="decode back and report PSNR")
    args = p.parse_args(argv)

    import numpy as np

    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.media import ivf
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.specav1 import obu as obu_mod
    from av1tpu_torch.utils.testsrc import testsrc2

    try:
        engine = SpecTorchEngine(TpuEncoderConfig(keyint=args.keyint),
                                 device="cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"encode_clip: {e}", file=sys.stderr)
        return 1
    if args.input:
        frames = []
        for i, fr in enumerate(SpecTorchEngine.iter_source_frames(
                args.input)):
            if i >= args.frames:
                break
            frames.append(fr)
    else:
        frames = [testsrc2(args.width, args.height, i)
                  for i in range(args.frames)]
    if not frames:
        print("no frames", file=sys.stderr)
        return 1
    w, h = frames[0].width, frames[0].height

    t0 = time.monotonic()
    total = 0
    with open(args.out, "wb") as f:
        ivf.write_header(f, w, h, args.fps, 1, len(frames))
        engine.start_stream()
        n_key = 0
        for i, fr in enumerate(frames):
            payload, is_key = engine.encode_next(fr, args.qindex)
            n_key += is_key
            unit = obu_mod.make_obu(obu_mod.OBU_TEMPORAL_DELIMITER,
                                    b"") + payload
            ivf.write_frame(f, unit, i)
            total += len(unit)
    dt = time.monotonic() - t0
    print(f"encoded {len(frames)} frames ({n_key} key) {w}x{h} "
          f"q={args.qindex} in {dt:.2f}s ({len(frames)/dt:.2f} fps), "
          f"{total} bytes ({total*8/len(frames)/(w*h):.4f} bpp)")

    if args.verify:
        from av1tpu_torch.specav1 import decoder
        with open(args.out, "rb") as f:
            ivf.read_header(f)
            out = decoder.decode_stream([tu for tu, _ in ivf.iter_frames(f)])
        psnrs = []
        for src, dec in zip(frames, out):
            err = src.y.astype(np.float64) - dec[0].astype(np.float64)
            mse = (err ** 2).mean()
            psnrs.append(99.0 if mse == 0 else 10 * np.log10(255 ** 2 / mse))
        print(f"decoded {len(out)} frames, Y-PSNR avg "
              f"{sum(psnrs)/len(psnrs):.2f} dB "
              f"(min {min(psnrs):.2f}, max {max(psnrs):.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
