# Copied from av1tpu/tools/encode_clip.py; it drives LegacyTorchEngine on
# the card (the CPU with --cpu) and verifies with the port's legacy decoder.
"""Encode a clip (synthetic or video file) to av1tpu IVF; optionally verify.

Usage:
  python -m av1tpu_torch.tools.encode_clip --width 320 --height 192 \
      --frames 8 --out /tmp/x.ivf [--qindex 96] [--input source.mp4] \
      [--verify] [--cpu]

Frames go one at a time through ``LegacyTorchEngine.encode_next`` (the
private av1tpu profile) on the card, or on the CPU with ``--cpu``;
without it and without a card the tool fails.  Each IVF frame is a
temporal delimiter OBU, the sequence header OBU on frame 0, and the
frame's payload; ``--verify`` decodes the file with the port's legacy
decoder on the device it encoded on and reports the Y-PSNR.
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

    from av1tpu_torch.legacy.engine import LegacyTorchEngine
    from av1tpu_torch.media import ivf, obu as obu_mod
    from av1tpu_torch.utils.testsrc import testsrc2

    try:
        engine = LegacyTorchEngine(device="cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"encode_clip: {e}", file=sys.stderr)
        return 1
    engine.cfg.keyint = args.keyint
    if args.input:
        frames = []
        for i, fr in enumerate(LegacyTorchEngine.iter_source_frames(
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
    sh = engine.sequence_header(w, h)

    t0 = time.monotonic()
    total = 0
    with open(args.out, "wb") as f:
        ivf.write_header(f, w, h, args.fps, 1, len(frames))
        engine.start_stream()
        n_key = 0
        for i, fr in enumerate(frames):
            payload, is_key = engine.encode_next(fr, args.qindex)
            n_key += is_key
            unit = obu_mod.write_obu(obu_mod.OBU_TEMPORAL_DELIMITER, b"")
            if i == 0:
                unit += obu_mod.write_obu(obu_mod.OBU_SEQUENCE_HEADER,
                                          sh.write())
            unit += payload
            ivf.write_frame(f, unit, i)
            total += len(unit)
    dt = time.monotonic() - t0
    print(f"encoded {len(frames)} frames ({n_key} key) {w}x{h} "
          f"q={args.qindex} in {dt:.2f}s ({len(frames)/dt:.2f} fps), "
          f"{total} bytes ({total*8/len(frames)/(w*h):.4f} bpp)")

    if args.verify:
        from av1tpu_torch.legacy import decoder
        out = decoder.decode_ivf(args.out, device=engine.device)
        psnrs = []
        for src, dec in zip(frames, out):
            err = src.y.astype(np.float64) - dec.y.astype(np.float64)
            mse = (err ** 2).mean()
            psnrs.append(99.0 if mse == 0 else 10 * np.log10(255 ** 2 / mse))
        print(f"decoded {len(out)} frames, Y-PSNR avg "
              f"{sum(psnrs)/len(psnrs):.2f} dB "
              f"(min {min(psnrs):.2f}, max {max(psnrs):.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
