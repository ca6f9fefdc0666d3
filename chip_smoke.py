"""GPU smoke test of the PyTorch port (``av1tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    the CUDA kernels (one nvcc per source) and the port's native
              tile writer (g++), all started together, into
              av1tpu_torch/_build/
  3. kernels  K1 gather and K2 refine against their plain PyTorch versions
              at the 1080p main-path shapes, 8- and 10-bit, exact equality,
              and K2's edge cases; kernel, plain and library milliseconds
              from CUDA events, each beside its bound and roofline share
  4. slice    1 keyframe + 7 P-frames of a seeded grainy 1920x1080 8-bit
              clip through SpecTorchEngine(cfg, device="cuda").encode_stream;
              both kernels must launch; fps, bits per pixel, key/P ms
  5. conform  a 256x144 clip (1 key + 3 P, 16-px strip) decoded by the
              port's own spec decoder must equal the port's reconstruction,
              and the CPU run of the port must give the same bytes

Before the last line come a JSON object with each kernel's launch count
on the main path, error, timings and bound (per main-path shape under
"shapes"), and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 bytes/s and the int8
# tensor-core rate, the highest integer rate of the card; K2's content is
# 8-bit on the main path
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail("nvidia-smi failed: " + res.stderr.strip())
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean device ms per call of ``fn`` between two CUDA events.  The
    timed calls queue up behind a device-side sleep (about 0.1 ms per
    call), so the events see back-to-back device execution and not the
    host's launch rate, which would otherwise bound kernels this short."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, ops: int = 0) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or
    operations over the int8 peak, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def grainy_frame(w: int, h: int, i: int, rng):
    """testsrc2 plus seeded uniform grain on luma (noise_floor > 1)."""
    import numpy as np

    from av1tpu_torch.utils.testsrc import Frame, testsrc2
    f = testsrc2(w, h, i)
    y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                0, 255).astype(np.uint8)
    return Frame(y=y, u=f.u, v=f.v)


def phase_build():
    """Build the kernel library and the tile writer concurrently."""
    from av1tpu_torch import device as D
    from av1tpu_torch.encoder import entropy

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        futs = {"CUDA kernels": ex.submit(timed, D.build_kernels),
                "native tile writer": ex.submit(timed,
                                                entropy.build_library)}
    secs = {k: f.result() for k, f in futs.items()}  # raises a failed build
    D.kernels()
    entropy.load_library()
    log(f"build: {time.perf_counter() - t:.2f} s wall "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f" ({D.build_kernels()})")
    name = "?"
    with open(D.build_kernels() + ".log") as f:
        for ln in f:
            m = re.search(r"entry function '\w*?\d([a-z_]+_kernel)(\w*)'", ln)
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2))
                name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            elif "Used" in ln:
                log(f"ptxas: {name}: {ln.split('info    :')[-1].strip()}")


def k2_inputs(rng, B, n, bd, dev):
    """Regions of random pixels, blocks cut from them at a random offset
    plus noise: realistic minima."""
    import numpy as np
    import torch
    R = n + 16
    regions = rng.integers(0, 1 << bd, (B, R, R))
    oy, ox = rng.integers(0, 17, B), rng.integers(0, 17, B)
    idx = np.arange(n)
    blocks = regions[np.arange(B)[:, None, None],
                     (oy[:, None] + idx)[:, :, None],
                     (ox[:, None] + idx)[:, None, :]]
    blocks = np.clip(blocks + rng.integers(-3, 4, blocks.shape), 0,
                     (1 << bd) - 1)
    return (torch.as_tensor(blocks, dtype=torch.int32, device=dev),
            torch.as_tensor(regions, dtype=torch.int32, device=dev))


def k2_check(bt, rt, n, what):
    """K2 against refine_ssd_plain: exact SSDs and displacements."""
    import torch

    from av1tpu_torch.encoder.kernels import refine
    s1, d1 = refine.refine_ssd(bt, rt, n, 8)
    s0, d0 = refine.refine_ssd_plain(bt, rt, n, 8)
    torch.cuda.synchronize()
    err = float((s1 - s0).abs().max())
    if err or not torch.equal(d1, d0):
        fail(f"K2 {what} differs from plain (ssd err {err})")
    return err, s1, d1


def phase_k2_edges(dev):
    """K2's edge cases: the largest 10-bit SSD, all-tie regions, and
    random 8/10-bit inputs at a block count the CTA does not divide."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    for n in (32, 16):
        R = n + 16
        bt = torch.full((5, n, n), 1023, dtype=torch.int32, device=dev)
        rt = torch.zeros((5, R, R), dtype=torch.int32, device=dev)
        _, s, d = k2_check(bt, rt, n, f"n={n} all-1023 vs all-0")
        if int(s[0]) != n * n * 1023 ** 2 or not (d == -8).all():
            fail(f"K2 n={n} largest SSD: {float(s[0])} at {d[0].tolist()}")
        rt = torch.full((7, R, R), 300, dtype=torch.int32, device=dev)
        bt = torch.full((7, n, n), 41, dtype=torch.int32, device=dev)
        _, s, d = k2_check(bt, rt, n, f"n={n} constant region")
        if not (d == -8).all():
            fail(f"K2 n={n} tie did not go to k = 0")
        for bd in (8, 10):
            bt, rt = k2_inputs(rng, 4 * 37 + 3, n, bd, dev)
            k2_check(bt, rt, n, f"n={n} B=151 {bd}-bit")
        # values outside [0, 1023] take the direct path, wrap and all
        bt = torch.as_tensor(rng.integers(-40000, 40000, (6, n, n)),
                             dtype=torch.int32, device=dev)
        rt = torch.as_tensor(rng.integers(-40000, 40000, (6, R, R)),
                             dtype=torch.int32, device=dev)
        k2_check(bt, rt, n, f"n={n} out-of-range values")
    log("K2 edge cases equal to plain: largest 10-bit SSD "
        f"({32 * 32 * 1023 ** 2} at n=32), all-tie regions -> k = 0, "
        "B=151 at 8/10-bit, values outside [0, 1023]")


def phase_kernels(dev):
    """K1/K2 vs plain at every main-path shape; returns per-kernel rows."""
    import numpy as np
    import torch

    from av1tpu_torch.encoder.kernels import gather, refine
    rng = np.random.default_rng(1)
    k1_err, k1_rows = 0, []
    # luma (1088+128) x (1920+128) and chroma (544+64) x (960+64) planes
    planes = {"luma": (1216, 2048), "chroma": (608, 1024)}
    # (W, B): refine regions 48/32, qpel windows 41/25, chroma MC 23/15
    shapes = [(48, 2040), (32, 8160), (41, 2040), (25, 8160), (23, 2040),
              (15, 8160)]
    for bd in (8, 10):
        for pname, (hp, wp) in planes.items():
            plane = torch.as_tensor(rng.integers(0, 1 << bd, (hp, wp)),
                                    dtype=torch.int32, device=dev)
            for W, B in shapes:
                oy = torch.as_tensor(rng.integers(0, hp - W + 1, B),
                                     dtype=torch.int32, device=dev)
                ox = torch.as_tensor(rng.integers(0, wp - W + 1, B),
                                     dtype=torch.int32, device=dev)
                got = gather.gather_windows(plane, oy, ox, W)
                want = gather.gather_windows_plain(plane, oy, ox, W)
                oy64, ox64 = oy.long(), ox.long()

                def library():
                    return plane.unfold(0, W, 1).unfold(1, W, 1)[oy64, ox64]

                lib = library()
                torch.cuda.synchronize()
                err = int((got - want).abs().max())
                k1_err = max(k1_err, err)
                if err or not torch.equal(lib, want):
                    fail(f"K1 W={W} B={B} {pname} {bd}-bit differs ({err})")
                main = (pname == "luma" and W in (48, 32, 41, 25)) or \
                    (pname == "chroma" and W in (23, 15))
                if bd == 8 and main:
                    ms = cuda_ms(lambda: gather.gather_windows(
                        plane, oy, ox, W))
                    pms = cuda_ms(lambda: gather.gather_windows_plain(
                        plane, oy, ox, W))
                    lms = cuda_ms(library)
                    nbytes = (plane.numel() * plane.element_size() + 8 * B
                              + 4 * B * W * W)
                    bms, by = bound_ms(nbytes)
                    k1_rows.append({
                        "shape": f"{pname} W={W} B={B}", "ms": ms,
                        "plain_ms": pms, "library_ms": lms,
                        "bound_ms": bms, "bound_by": by, "share": bms / ms})
                    log(f"K1 gather {pname} W={W} B={B}: kernel {ms:.4f} ms"
                        f"  plain {pms:.4f}  library {lms:.4f}  bound "
                        f"{bms:.4f} ({by})  share {bms / ms:.3f}")
    log(f"K1 equal to plain and to the library call at all shapes, "
        f"8/10-bit (max_abs_err {k1_err})")
    k2_err, k2_rows = 0.0, []
    for bd in (8, 10):
        for n, B in ((32, 2040), (16, 8160)):
            bt, rt = k2_inputs(rng, B, n, bd, dev)
            err, _, _ = k2_check(bt, rt, n, f"n={n} B={B} {bd}-bit")
            k2_err = max(k2_err, err)
            ms = cuda_ms(lambda: refine.refine_ssd(bt, rt, n, 8))
            R = n + 16
            nbytes = 4 * B * (n * n + R * R) + 12 * B
            bms, by = bound_ms(nbytes, 3 * 289 * n * n * B)
            if bd == 8:
                pms = cuda_ms(lambda: refine.refine_ssd_plain(bt, rt, n, 8),
                              iters=5)
                k2_rows.append({
                    "shape": f"n={n} B={B}", "ms": ms, "plain_ms": pms,
                    "library_ms": None, "bound_ms": bms, "bound_by": by,
                    "share": bms / ms})
                log(f"K2 refine n={n} B={B} 8-bit: kernel {ms:.4f} ms  "
                    f"plain {pms:.4f}  library none  bound {bms:.4f} ({by})"
                    f"  share {bms / ms:.3f}")
            else:
                log(f"K2 refine n={n} B={B} 10-bit: kernel {ms:.4f} ms  "
                    f"bound {bms:.4f} ({by})  share {bms / ms:.3f}")
    log(f"K2 equal to plain at n=32/16, 8/10-bit (max_abs_err {k2_err})")
    phase_k2_edges(dev)
    return k1_err, k1_rows, k2_err, k2_rows


def phase_slice(dev_name: str):
    """1080p key + 7 P through encode_stream; returns the launch counts."""
    import numpy as np
    import torch

    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.encoder.kernels import gather, refine
    from av1tpu_torch.spec_engine import SpecTorchEngine, noise_floor
    W, H, N, Q = 1920, 1080, 8, 96
    rng = np.random.default_rng(7)
    frames = [grainy_frame(W, H, i, rng) for i in range(N)]
    nf = noise_floor(frames[0].y)
    if not nf > 1.0:
        fail(f"clip noise floor {nf} would turn deblocking on")
    cfg = TpuEncoderConfig(chunk=1, golden=False, cdef=False, lr=False)
    eng = SpecTorchEngine(cfg, device=dev_name)
    gather.gather_windows.launches = 0
    refine.refine_ssd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(eng.encode_stream(frames, Q))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather": gather.gather_windows.launches,
                "refine": refine.refine_ssd.launches}
    if eng._gop_deblock:
        fail("deblocking decision turned on for the grainy clip")
    if len(out) != N or not out[0][1] or any(k for _, k in out[1:]):
        fail(f"expected 1 key + {N - 1} P, got {[k for _, k in out]}")
    if eng._ref_dev[0].device.type != "cuda":
        fail("reference planes are not on the card")
    if launches["gather"] == 0 or launches["refine"] == 0:
        fail(f"main path did not launch both kernels: {launches}")
    bits = sum(len(p) * 8 for p, _ in out)
    bpp = bits / (N * W * H)
    log(f"slice 1080p: {N} frames in {wall:.3f} s = {N / wall:.3f} fps, "
        f"{bpp:.5f} bpp, kernel launches {launches}")
    # per-frame device time: submit (upload + encode + pack) to sync
    eng.start_stream()
    key_ms, p_ms, fin_ms, mse = None, [], [], []
    for i, f in enumerate(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pend = eng._submit(f, Q, is_key=(i == 0))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        rec_y = eng._ref[0][:H, :W].astype(np.float64)
        mse.append(np.mean((rec_y - f.y) ** 2))
        t = time.perf_counter()
        eng._finalize(pend)
        fin_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            key_ms = dt
        else:
            p_ms.append(dt)
    log(f"slice 1080p: key {key_ms:.1f} ms, P {np.mean(p_ms):.1f} ms "
        f"(min {min(p_ms):.1f}), host finalize {np.mean(fin_ms):.1f} "
        f"ms/frame, Y-PSNR {10 * np.log10(255.0 ** 2 / np.mean(mse)):.3f} "
        f"dB (key q{Q})")
    return launches


def phase_conform(dev_name: str):
    """256x144 stream: the port's spec decoder == port recon; CPU bytes
    == GPU bytes."""
    import numpy as np

    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.specav1 import decoder

    def run(device):
        rng = np.random.default_rng(3)
        frames = [grainy_frame(256, 144, i, rng) for i in range(4)]
        eng = SpecTorchEngine(TpuEncoderConfig(chunk=1, golden=False,
                                               cdef=False, lr=False),
                              device=device)
        eng.start_stream()
        payloads, recons = [], []
        for i, f in enumerate(frames):
            pend = eng._submit(f, 96, is_key=(i == 0))
            recons.append(eng._ref)
            payloads.append(eng._finalize(pend)[0])
        return payloads, recons

    payloads, recons = run(dev_name)
    dec = decoder.decode_stream(payloads)
    if len(dec) != 4:
        fail(f"spec decoder returned {len(dec)} frames")
    for i, (d, r) in enumerate(zip(dec, recons)):
        for pl in range(3):
            hh, ww = d[pl].shape
            if not np.array_equal(np.asarray(d[pl], np.int64),
                                  r[pl][:hh, :ww].astype(np.int64)):
                fail(f"decoded frame {i} plane {pl} != port recon")
    log("conformance 256x144: the port's spec decoder "
        "(av1tpu_torch.specav1.decoder) reproduces the port's recon "
        "exactly, 1 key + 3 P")
    cpu_payloads, _ = run("cpu")
    if cpu_payloads != payloads:
        fail("CPU and GPU runs of the port gave different streams")
    log("conformance 256x144: CPU plain path and GPU kernels give "
        "byte-identical streams")


def kernel_entry(name, source, replaces, launches, err, rows):
    """One kernel of the JSON line: the first (main) shape's numbers at
    the top level, every shape under "shapes"."""
    top = {k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "share", "library_ms")}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **top, "shapes": rows}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "av1tpu_torch")):
        fail("run from the root of a checkout: av1tpu_torch/ must sit next "
             "to chip_smoke.py")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    card = card_line()
    log(card)
    dev_name = "cuda"

    from av1tpu_torch import device as D
    D.resolve_device(dev_name)
    phase_build()
    k1_err, k1_rows, k2_err, k2_rows = phase_kernels(torch.device(dev_name))
    launches = phase_slice(dev_name)
    phase_conform(dev_name)

    print(json.dumps({"kernels": [
        kernel_entry("gather_windows", "av1tpu_torch/csrc/gather.cu",
                     "av1tpu/encoder/kernels/pallas_gather.py:42",
                     launches["gather"], k1_err, k1_rows),
        kernel_entry("refine_ssd", "av1tpu_torch/csrc/refine.cu",
                     "av1tpu/encoder/kernels/pallas_motion.py:28",
                     launches["refine"], k2_err, k2_rows)]}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
