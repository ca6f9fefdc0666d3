# Copied from av1tpu/tools/quality.py; AV1 streams decode with the port's
# spec decoder in place of the legacy decoder.
"""Quality measurement: PSNR + SSIM between a reference and an encoding.

The VMAF-parity measurement surface (BASELINE.md: equal-VMAF target;
libvmaf is unavailable in this environment, so PSNR/SSIM are the recorded
fidelity metrics).  Decodes AV1 IVF and Matroska streams with the port's
spec decoder (the av1C config OBUs first, for Matroska) and anything
else through ``TorchEngine.iter_source_frames`` (y4m, libavcodec, cv2).
Nothing here touches the card.

Usage:
  python -m av1tpu_torch.tools.quality --ref src.mp4 --dist out.mkv [--frames N]
Prints one JSON line: {"frames", "y_psnr", "y_ssim", "per_frame": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, maxval: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(maxval ** 2 / mse)


def ssim(a: np.ndarray, b: np.ndarray, maxval: float = 255.0) -> float:
    """Global-window SSIM over 8x8 blocks (mean of local SSIMs)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    h, w = a.shape
    h8, w8 = h - h % 8, w - w % 8
    ab = a[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8)
    bb = b[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8)
    mu_a = ab.mean(axis=(1, 3))
    mu_b = bb.mean(axis=(1, 3))
    var_a = ab.var(axis=(1, 3))
    var_b = bb.var(axis=(1, 3))
    cov = (ab * bb).mean(axis=(1, 3)) - mu_a * mu_b
    c1 = (0.01 * maxval) ** 2
    c2 = (0.03 * maxval) ** 2
    s = (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())


def _iter_frames(path: str):
    """Yield luma planes; AV1 MKV/IVF via the spec decoder, else the
    engine's source decoders."""
    from av1tpu_torch.media.probe import probe_file, ProbeError
    try:
        pr = probe_file(path)
        is_av1 = pr.has_av1
    except ProbeError:
        is_av1 = False
    if is_av1:
        from av1tpu_torch.media import ivf, mkv
        from av1tpu_torch.specav1 import decoder as dec_mod
        dec = dec_mod.Decoder()
        if path.lower().endswith(".ivf"):
            with open(path, "rb") as f:
                ivf.read_header(f)
                for tu, _ in ivf.iter_frames(f):
                    for fr in dec.decode_tu(tu):
                        yield fr[0]
            return
        with open(path, "rb") as f:
            m = mkv.parse(f)
            v = [t for t in m.tracks if t.codec_id == "V_AV1"][0]
            dec.decode_tu(v.codec_private[4:])
            for pkt in mkv.iter_packets(f, m):
                if pkt.track_number == v.number:
                    for fr in dec.decode_tu(pkt.data):
                        yield fr[0]
        return
    from av1tpu_torch.engine import TorchEngine
    for fr in TorchEngine.iter_source_frames(path):
        yield fr.y


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ref", required=True)
    p.add_argument("--dist", required=True)
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--maxval", type=float, default=255.0)
    args = p.parse_args(argv)

    per_frame = []
    for i, (ry, dy) in enumerate(zip(_iter_frames(args.ref),
                                     _iter_frames(args.dist))):
        if args.frames and i >= args.frames:
            break
        if ry.shape != dy.shape:
            hh = min(ry.shape[0], dy.shape[0])
            ww = min(ry.shape[1], dy.shape[1])
            ry, dy = ry[:hh, :ww], dy[:hh, :ww]
        per_frame.append({"psnr": round(psnr(ry, dy, args.maxval), 3),
                          "ssim": round(ssim(ry, dy, args.maxval), 5)})
    if not per_frame:
        print(json.dumps({"error": "no comparable frames"}))
        return 1
    print(json.dumps({
        "frames": len(per_frame),
        "y_psnr": round(sum(f["psnr"] for f in per_frame) / len(per_frame), 3),
        "y_ssim": round(sum(f["ssim"] for f in per_frame) / len(per_frame), 5),
        "per_frame": per_frame,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
