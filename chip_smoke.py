"""GPU smoke test of the PyTorch port (``av1tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile | --dist]

Phases (any failure exits non-zero; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    the CUDA kernels (one nvcc per source) and the port's native
              tile writer (g++), all started together, into
              av1tpu_torch/_build/
  3. kernels  K1 gather (one plane and the two-plane LAST/GOLDEN entry,
              each also with U and V in one launch) and K2 refine against
              their plain PyTorch versions at the shapes that the 1080p and
              the 720p paths give them, and a stripe of each striped path
              (1080p over 2 stripes: 544 rows, B=1020, windows 672 x 2048;
              720p over 4: 192 rows, B=240, 320 x 1408), 8- and 10-bit,
              exact equality, and
              K2's edge cases; kernel, plain and library milliseconds from
              CUDA events at each, beside the bound and the roofline share;
              K1 at random origins and at path-like ones (the block grid
              plus vectors within the refine radius)
  4. daemon   daemon-1080p: one pass of the port's daemon,
              av1tpu_torch.daemon.main.run_once(cfg) with engine=None, as
              ``python3 -m av1tpu_torch.daemon.main cfg.json`` runs it,
              over a library holding one file: slice-1080p-chunk8's 9
              grainy 1920x1080 frames as a y4m stream named clip.mkv;
              the daemon's default config (library, min_bytes and job
              directory aside), so the engine is built on the card and
              runs its 1280x720 self-test, then scan, probe, job JSON,
              transcode in TpuEncoderConfig(), size gate,
              decode-verify and atomic replace.  The job must succeed
              with 9 frames, clip.mkv must be Matroska of the job's
              size whose V_AV1 payloads are what encode_stream yielded
              (and slice-1080p-chunk8's bytes), K1 3 + 5 and K2 3
              launches a P-frame, and the port's spec decoder must
              reproduce every frame's recon; prints the source decoders
              the machine has, the decode-verify verdict, self-test and
              transcode seconds, the job's encode_fps, the size ratio
              and each chunk's upload (packed or raw); then make_engine
              with tpu.bitstream "av1tpu" must build LegacyTorchEngine on
              the card and its 1280x720 self-test must pass
  5. ops      the operator surfaces over the daemon phase's config and
              job directory: the doctor (doctor.main([cfg])) must be
              healthy with its accelerator line naming the card and its
              320x192 keyframe smoke encoded on the card; the dashboard's
              CUDA context (av1top's reader in a process of its own:
              card-wide used bytes there less this process's); av1top
              --once (tui.main.main([cfg, "--once"])) must show the
              daemon-1080p job as a success with its savings and a GPU
              line naming the card, its total equal to mem_get_info's,
              its used memory above 0; encode_clip at 1920x1080, 4
              frames (clean testsrc2, 1 key + 3 P), as its original does
              the private av1tpu profile (LegacyTorchEngine, speed 6,
              32-px blocks, one encode_next a frame), with the launch
              counts set to 0 just before and read just after: K1 2 and
              K2 2 a P-frame, an IVF of 4 temporal units whose decode by
              the port's legacy decoder reproduces every recon, and
              quality --frames 1 on it against a y4m of its source, whose
              Y-PSNR must be recon 0's (both in a decode worker); the
              tool's fps/bpp line and key and P ms
  6. slices   through SpecTorchEngine(cfg, device="cuda").encode_stream at
              qindex 96, with the launch counts set to 0 before each:
              slice-1080p-grain   1 key + 3 P, seeded grainy 1920x1080,
                                  golden off (one reference)
              slice-1080p-golden  8 clean 1920x1080 frames, golden on: a
                                  scene, a drift away from it under the cut
                                  threshold, a cut back to it, which must
                                  code as an inter frame on GOLDEN blocks
              slice-1080p-default the grain clip in the daemon's default
                                  config, TpuEncoderConfig(chunk=1):
                                  golden, CDEF and LR on, deblocking off
              slice-720p-clean    1 key + 3 P, clean 1280x720: the GOP's
                                  deblocking decision is on (strip + loop
                                  filter + split), header levels nonzero
              slice-720p-default  the 720p clip in the default config:
                                  deblocking, CDEF and LR on the 16-px
                                  strip geometry
              slice-1080p-chunk8  the grain clip, 1 key + 8 P, in the
                                  daemon's default config exactly,
                                  TpuEncoderConfig(): one chunk of 8,
                                  whose upload falls back to raw
              slice-720p-chunk8   clean 720p drift, 1 key + 16 P, in
                                  TpuEncoderConfig(): two chunks of 8,
                                  both through the packed upload
              the first three with CDEF and LR off; every kernel of a
              path must launch (K1: 3 one-plane + 5 two-plane launches
              per golden P-frame, 7 one-plane with golden off; K2 3), and
              the port's spec decoder must reproduce every plane of every
              frame of each stream (in worker processes, while the card
              encodes the next cells); fps, bits per pixel,
              Y-PSNR, key/P ms, GOLDEN share per frame, and on the default
              paths the CDEF strengths and the share of restoration units
              on and solved per frame, held against the frame headers.
              Each chunk cell runs again through
              TpuEncoderConfig(delta_upload=False) and
              TpuEncoderConfig(chunk=1) in the same call and must give
              their bytes frame by frame; it prints per chunk the upload
              path (packed, with the plane modes, or raw), host pack ms,
              upload bytes packed against raw, submit-to-result and
              finalize ms, per run fps and peak device memory, and the
              first chunk's upload ms raw and packed
  7. stripes the multi-device stripe encode issued from this one thread,
              stripe k on card k mod the visible cards (with one card,
              stripe devices ("cuda:0",) * n: halo copies between cards
              are not exercised), with the launch counts set to 0 before
              each and read after:
              stripes-1080p-chunk8 slice-1080p-chunk8's frames in
                                  TpuEncoderConfig() over 2 stripes: a
                                  striped keyframe and one chunk of 8
                                  striped P-frames
              stripes-720p-default slice-720p-default's frames over 4
                                  stripes: the strip, deblocking, CDEF and
                                  LR on the gathered recon, middle stripes
                                  with halos on both sides
              each must give its one-device cell's payloads and recon over
              the coded frame, byte for byte, with K1 n x (3 + 5) and K2
              n x 3 launches a P-frame; key and P ms beside the one-device
              cell's
  8. legacy   the private av1tpu profile (tpu.bitstream "av1tpu",
              LegacyTorchEngine, 32-px blocks at 1080p) through
              encode_stream at qindex 96, with the launch counts set to 0
              before each and read after:
              legacy-1080p-chunk  slice-1080p-chunk8's 9 grainy frames at
                                  speed 6: a key and two chunks of 4 (the
                                  cap at 1080p), bytes equal to chunk=1's
              legacy-1080p-golden slice-1080p-golden's 8 clean frames at
                                  speed 4 (two references, transform
                                  selection), chunk=1: the cut back codes
                                  as a keyframe (the profile has no
                                  golden-aware cut), the blends choose
                                  GOLDEN on some blocks
              K1 and K2 2 launches a P-frame for each reference searched;
              every recon reproduced by the port's legacy decoder on the
              CPU (decode workers); fps, bpp, Y-PSNR, key and P ms
  9. mesh     the private profile's stripe functions
              (legacy/mesh_sharding.py) and the v1 P-frame they run, with
              the launch counts set to 0 before each and read after:
              mesh-v1-1088p  a grainy 1920x1088 v1 P-frame (16-px blocks,
                             full-pel tss_search): K1 7 (2 region gathers
                             at W=32, 4 block gathers at W=16, U+V at
                             W=8) and K2 2; decode_inter_frame gives its
                             recon
              mesh-*-1088p/n the v1 and v2 striped P-frames and the
                             striped v2 keyframe over n = 2 and 4 stripes
                             on this card, each equal to its one-device
                             function (v2: tile_rows=n); K1 7n and K2 2n
                             (v1), K1 2n and K2 2n (v2)
              and at 512x64 over 8 stripes the card's outputs equal the
              CPU's; across two cards where the machine has them
 10. dist     stripes over processes: rank processes of this script
              (--dist-rank) with AV1TPU_COORDINATOR on 127.0.0.1 at a
              free port, AV1TPU_NUM_PROCESSES and AV1TPU_PROCESS_ID, each
              joining the process group through the port's init function
              and encoding through the daemon's make_engine with
              num_chips 0 (one stripe a rank), with the launch counts set
              to 0 before and read after in each rank:
              dist-1080p-chunk8  slice-1080p-chunk8's frames in
                                 TpuEncoderConfig() over 2 ranks
              dist-720p-default  slice-720p-default's clip over 4 ranks
                                 (only with four cards)
              with two or more cards over NCCL, one card a rank; with one
              card two ranks share it over gloo (NCCL refuses two ranks on
              one card), which the run says on its own line; every rank's
              payloads and recon over the coded frame must equal the
              one-device cell's, every frame striped over the ranks, K1
              3 + 5 and K2 3 launches a P-frame in each rank (one
              stripe's share); a rank that fails fails the phase; each
              rank's key and P ms, fps and collective time (CUDA events
              and host clock around each exchange), beside the one-device
              and one-thread stripe cells'
 11. conform  256x144 streams (16-px strip) decoded by the port's own spec
              decoder must equal the port's reconstruction, and the CPU run
              of the port must give the same bytes: a grainy golden-off
              1 key + 3 P, a clean golden key A, inter B, inter A with
              the loop filter on and GOLDEN blocks, the grainy clip in
              the default config with CDEF and LR on, and a clean drift in
              the default config at chunk=3 (key, a packed chunk of 3, a
              remainder of 1) through encode_stream; and a clean 256x256
              drift at chunk=3 over 4 stripes, which must decode to its
              recon and equal its CPU run and the one-device stream; and a
              320x192 private-profile key + 3 P at chunk=3, decoded by the
              port's legacy decoder, card bytes = CPU bytes

With --dist only the build, the two one-device cells the dist phase
compares with (slice-1080p-chunk8, slice-720p-default), the stripe cells
and the dist phase run: the processes path and what it is compared with,
on a machine with several cards, in a fraction of the smoke's time; no
kernels line is printed.

With --profile, one more P-frame of each golden path runs after the
slices, timed with each in-loop filter stage (deblocking, CDEF, LR)
bracketed by synchronizes, then under torch.profiler: device-busy ms,
idle share, launches, each stage's ms and launches, the top kernels.

Before the last line come a JSON object with each kernel's launch count
on the main path, error, timings and bound (per main-path shape under
"shapes"), and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
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


# the decode worker processes (started at the first full-size decode
# check) and the checks handed to them
_decodes = {"pool": None, "jobs": []}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    if _decodes["pool"] is not None:
        _decodes["pool"].terminate()
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


# processes that run the decode checks of the full-size streams while the
# card encodes the next cells
DECODE_WORKERS = 4

# the frame sizes of the full-width paths, and the stripe counts of the
# striped ones (a stripe's kernels see its rows and its halo window); the
# kernels are held against their plain versions at the shapes each of
# them gives
SIZES = {"1080p": (1920, 1080, 1), "720p": (1280, 720, 1),
         "1080p/2 stripes": (1920, 1080, 2), "720p/4 stripes": (1280, 720, 4)}


def geometry(w: int, h: int, n: int = 1):
    """What a w x h frame, or each of its n stripes, gives the kernels:
    the padded luma and chroma plane shapes (the engine pads the frame to
    multiples of 64, then to n stripes of 32-row multiples; 64 / 32
    samples of border a side, the halo rows of a stripe's window) and the
    block count of the 32-grid; the 16-grid has four times as many."""
    from av1tpu_torch.specav1 import stripes
    ph, pw = -(-h // 64) * 64, -(-w // 64) * 64
    if n > 1:
        ph = stripes.stripe_pad(ph, n) // n
    return ({"luma": (ph + 128, pw + 128),
             "chroma": (ph // 2 + 64, pw // 2 + 64)},
            (ph // 32) * (pw // 32))


def path_origins(rng, hp, wp, W, n, B, pad):
    """Block-grid origins: each window around its n x n block (as the
    refine regions, qpel windows and MC taps sit) plus a vector within
    the refine radius (+-8 luma, +-4 chroma), clamped into the plane."""
    import numpy as np
    rows, cols = (hp - 2 * pad) // n, (wp - 2 * pad) // n
    if rows * cols != B:
        fail(f"path origins: a {rows}x{cols} grid for B={B}")
    r, c = np.mgrid[0:rows, 0:cols]
    rad = 8 if pad == 64 else 4
    v = rng.integers(-rad, rad + 1, (2, B))
    oy = r.reshape(-1) * n + pad - (W - n) // 2 + v[0]
    ox = c.reshape(-1) * n + pad - (W - n) // 2 + v[1]
    return np.clip(oy, 0, hp - W), np.clip(ox, 0, wp - W)


def touched_bytes(planes, ri, oy, ox, W) -> int:
    """The bytes a K1 call needs: the plane elements some window covers
    (per reference where a selector ri is given; planes then holds the
    LAST planes, then the GOLDEN ones), each read once, the index
    vectors and the output."""
    import torch
    P = len(planes) if ri is None else len(planes) // 2
    hp, wp = planes[0].shape
    ar = torch.arange(W, device=oy.device)
    sel = torch.zeros_like(oy) if ri is None else ri.clamp(0, 1)
    touched = torch.zeros((2, hp, wp), dtype=torch.bool, device=oy.device)
    touched[sel.long()[:, None, None], (oy.long()[:, None] + ar)[:, :, None],
            (ox.long()[:, None] + ar)[:, None, :]] = True
    B = oy.shape[0]
    return (P * int(touched.sum()) * planes[0].element_size()
            + 4 * B * (2 if ri is None else 3) + 4 * P * B * W * W)


def grainy_frame(w: int, h: int, i: int, rng):
    """testsrc2 plus seeded uniform grain on luma (noise_floor > 1)."""
    import numpy as np

    from av1tpu_torch.utils.testsrc import Frame, testsrc2
    f = testsrc2(w, h, i)
    y = np.clip(f.y.astype(np.int32) + rng.integers(-6, 7, f.y.shape),
                0, 255).astype(np.uint8)
    return Frame(y=y, u=f.u, v=f.v)


def grain_clip():
    """slice-1080p-chunk8's clip: 9 grainy 1920x1080 frames, seeded."""
    import numpy as np
    W, H, _ = SIZES["1080p"]
    rng = np.random.default_rng(7)
    return [grainy_frame(W, H, i, rng) for i in range(9)]


def clean_clip_720p():
    """slice-720p-default's clip: 4 clean 1280x720 frames of scene A."""
    from av1tpu_torch.utils.cleansrc import clean_frame
    W, H, _ = SIZES["720p"]
    return [clean_frame(W, H, i, 0) for i in range(4)]


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
    """K1/K2 vs plain at the shapes of every full-width path (SIZES), and
    their times there; returns per-kernel errors and rows."""
    import numpy as np
    import torch

    from av1tpu_torch.encoder.kernels import gather, refine
    rng = np.random.default_rng(1)
    k1_err, k1_rows, g2_err, g2_rows = 0, [], 0, []
    k2_err, k2_rows = 0.0, []
    for sname, (w, h, n_stripes) in SIZES.items():
        planes, b32 = geometry(w, h, n_stripes)
        err, rows = phase_gather1(dev, rng, sname, planes, b32)
        k1_err, k1_rows = max(k1_err, err), k1_rows + rows
        err, rows = phase_gather2(dev, rng, sname, planes, b32)
        g2_err, g2_rows = max(g2_err, err), g2_rows + rows
        for bd in (8, 10):
            for n, B in ((32, b32), (16, 4 * b32)):
                bt, rt = k2_inputs(rng, B, n, bd, dev)
                err, _, _ = k2_check(bt, rt, n, f"n={n} B={B} {bd}-bit")
                k2_err = max(k2_err, err)
                ms = cuda_ms(lambda: refine.refine_ssd(bt, rt, n, 8))
                R = n + 16
                nbytes = 4 * B * (n * n + R * R) + 12 * B
                bms, by = bound_ms(nbytes, 3 * 289 * n * n * B)
                if bd == 8:
                    pms = cuda_ms(lambda: refine.refine_ssd_plain(bt, rt, n,
                                                                  8), iters=5)
                    k2_rows.append({
                        "shape": f"{sname} n={n} B={B}", "ms": ms,
                        "plain_ms": pms, "library_ms": None, "bound_ms": bms,
                        "bound_by": by, "share": bms / ms})
                    log(f"K2 refine {sname} n={n} B={B} 8-bit: kernel "
                        f"{ms:.4f} ms  plain {pms:.4f}  library none  bound "
                        f"{bms:.4f} ({by})  share {bms / ms:.3f}")
                else:
                    log(f"K2 refine {sname} n={n} B={B} 10-bit: kernel "
                        f"{ms:.4f} ms  bound {bms:.4f} ({by})  share "
                        f"{bms / ms:.3f}")
    # the private profile's 720p shape: 32-px blocks on planes padded to
    # a multiple of 32 (736 x 1280 luma, B=920); search_v3 gathers W=48
    # regions and refines n=32 (its 1080p shape is the 1080p one above)
    hp, wp = 736 + 128, 1280 + 128
    B = (736 // 32) * (1280 // 32)
    plane = torch.as_tensor(rng.integers(0, 256, (hp, wp)),
                            dtype=torch.int32, device=dev)
    py, px = _k1_path_origins(rng, "luma", (hp, wp), 48, 32, B, dev)
    got = gather.gather_windows(plane, py, px, 48)
    want = gather.gather_windows_plain(plane, py, px, 48)
    lib = plane.unfold(0, 48, 1).unfold(1, 48, 1)[py.long(), px.long()]
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(lib, want)):
        fail(f"K1 720p legacy W=48 B={B} differs from plain")
    _k1_row(f"720p legacy luma W=48 B={B} path",
            lambda: gather.gather_windows(plane, py, px, 48),
            lambda: gather.gather_windows_plain(plane, py, px, 48),
            lambda: plane.unfold(0, 48, 1).unfold(1, 48, 1)[py.long(),
                                                            px.long()],
            _touched_bound((plane,), None, py, px, 48), k1_rows)
    bt, rt = k2_inputs(rng, B, 32, 8, dev)
    err, _, _ = k2_check(bt, rt, 32, f"720p legacy n=32 B={B}")
    k2_err = max(k2_err, err)
    ms = cuda_ms(lambda: refine.refine_ssd(bt, rt, 32, 8))
    pms = cuda_ms(lambda: refine.refine_ssd_plain(bt, rt, 32, 8), iters=5)
    bms, by = bound_ms(4 * B * (32 * 32 + 48 * 48) + 12 * B,
                       3 * 289 * 32 * 32 * B)
    k2_rows.append({"shape": f"720p legacy n=32 B={B}", "ms": ms,
                    "plain_ms": pms, "library_ms": None, "bound_ms": bms,
                    "bound_by": by, "share": bms / ms})
    log(f"K2 refine 720p legacy n=32 B={B} 8-bit: kernel {ms:.4f} ms  plain "
        f"{pms:.4f}  library none  bound {bms:.4f} ({by})  share "
        f"{bms / ms:.3f}")
    err, rows = phase_gather_mesh(dev, rng)
    k1_err, k1_rows = max(k1_err, err), k1_rows + rows
    sizes = ", ".join(SIZES)
    log(f"K1 equal to plain and to the library call at all shapes of "
        f"{sizes}, 8/10-bit, one plane and U+V in one launch (max_abs_err "
        f"{k1_err})")
    log(f"K1 two-plane equal to plain at all golden-path shapes of {sizes}, "
        "int16 and int32 planes, selector LAST / GOLDEN / mixed / out of "
        f"range, one plane and U+V in one launch (max_abs_err {g2_err})")
    log(f"K2 equal to plain at n=32/16 of {sizes}, 8/10-bit (max_abs_err "
        f"{k2_err})")
    phase_k2_edges(dev)
    return k1_err, k1_rows, k2_err, k2_rows, g2_err, g2_rows


def phase_gather_mesh(dev, rng):
    """K1 at the v1 P-frame's block gathers of a 1920x1088 frame (16-px
    blocks, B=8160): luma W=16 and U+V W=8 in one launch, both the
    runtime-width instance; exact against plain and the library call at
    8 and 10 bits, timed at path-like and random origins (8-bit)."""
    import torch

    from av1tpu_torch.encoder.kernels import gather
    worst, rows = 0, []
    B = (MESH_H // 16) * (MESH_W // 16)
    for pname, W, pad, P in (("luma", 16, 64, 1), ("chroma U+V", 8, 32, 2)):
        hp, wp = (MESH_H + 2 * pad, MESH_W + 2 * pad) if P == 1 else \
            (MESH_H // 2 + 2 * pad, MESH_W // 2 + 2 * pad)
        for bd in (10, 8):
            pl = tuple(torch.as_tensor(rng.integers(0, 1 << bd, (hp, wp)),
                                       dtype=torch.int32, device=dev)
                       for _ in range(P))
            a = pl[0] if P == 1 else pl
            stk = torch.stack(pl)
            py, px = _k1_path_origins(rng, "luma" if P == 1 else "chroma",
                                      (hp, wp), W, W, B, dev)
            oy, ox = (torch.as_tensor(rng.integers(0, lim - W + 1, B),
                                      dtype=torch.int32, device=dev)
                      for lim in (hp, wp))
            for otag, y, x in ((" path", py, px), (" rand.", oy, ox)):
                y64, x64 = y.long(), x.long()
                got = gather.gather_windows(a, y, x, W)
                want = gather.gather_windows_plain(a, y, x, W)
                lib = stk.unfold(1, W, 1).unfold(2, W, 1)[:, y64, x64]
                torch.cuda.synchronize()
                err = int((got - want).abs().max())
                worst = max(worst, err)
                if err or not torch.equal(lib.reshape(want.shape), want):
                    fail(f"K1 mesh {pname} W={W} B={B} {bd}-bit differs "
                         f"({err})")
                if bd != 8:
                    continue
                _k1_row(f"mesh 1088p {pname} W={W} B={B}{otag}",
                        lambda: gather.gather_windows(a, y, x, W),
                        lambda: gather.gather_windows_plain(a, y, x, W),
                        lambda: stk.unfold(1, W, 1).unfold(2, W, 1)[
                            :, y64, x64],
                        _touched_bound(pl, None, y, x, W), rows)
    return worst, rows


def _k1_path_origins(rng, pname, plane_shape, W, n, B, dev):
    """Path-like origins (``path_origins``) as int32 tensors on the
    card."""
    import torch
    hp, wp = plane_shape
    oy, ox = path_origins(rng, hp, wp, W, n, B, 64 if pname == "luma"
                          else 32)
    return (torch.as_tensor(oy, dtype=torch.int32, device=dev),
            torch.as_tensor(ox, dtype=torch.int32, device=dev))


def _k1_row(label, fn, plain, library, bms_by, rows):
    """Time one K1 call beside its plain version and library call."""
    ms = cuda_ms(fn)
    pms = cuda_ms(plain)
    lms = cuda_ms(library)
    bms, by = bms_by
    rows.append({"shape": label, "ms": ms, "plain_ms": pms,
                 "library_ms": lms, "bound_ms": bms, "bound_by": by,
                 "share": bms / ms})
    log(f"K1 {label}: kernel {ms:.4f} ms  plain {pms:.4f}  library "
        f"{lms:.4f}  bound {bms:.4f} ({by})  share {bms / ms:.3f}")


def _touched_bound(planes, ri, oy, ox, W):
    """The bound over the bytes the data needs (``touched_bytes``)."""
    return bound_ms(touched_bytes(planes, ri, oy, ox, W))


# K1's main-path gathers of one P-frame: (plane, W, block side n on that
# plane's grid, B as a multiple of the 32-grid's block count)
K1_ONE = [("luma", 48, 32, 1), ("luma", 32, 32, 1), ("luma", 41, 32, 1),
          ("luma", 32, 16, 4), ("luma", 25, 16, 4), ("chroma", 23, 16, 1),
          ("chroma", 15, 8, 4)]
K1_TWO = [("luma", 41, 32, 1), ("luma", 32, 16, 4), ("luma", 25, 16, 4),
          ("chroma", 23, 16, 1), ("chroma", 15, 8, 4)]


def phase_gather1(dev, rng, sname, planes, b32):
    """One-plane K1 vs plain and vs the library call at one frame size:
    refine regions 48/32, qpel windows 41/25, chroma MC 23/15 (one plane,
    and U+V in one launch as the path runs it), and the golden path's
    full-pel probe 32 at the 32-grid; 8- and 10-bit content, every shape
    on both planes, exact.  Timed at random origins (the earlier
    rows, kept so that they compare) and at path-like origins, 8-bit."""
    import torch

    from av1tpu_torch.encoder.kernels import gather
    worst, rows = 0, []
    for bd in (8, 10):
        for pname, (hp, wp) in planes.items():
            pu, pv = (torch.as_tensor(rng.integers(0, 1 << bd, (hp, wp)),
                                      dtype=torch.int32, device=dev)
                      for _ in range(2))
            for kind, W, n, k in K1_ONE:
                B = k * b32
                oy = torch.as_tensor(rng.integers(0, hp - W + 1, B),
                                     dtype=torch.int32, device=dev)
                ox = torch.as_tensor(rng.integers(0, wp - W + 1, B),
                                     dtype=torch.int32, device=dev)
                oy64, ox64 = oy.long(), ox.long()
                got = gather.gather_windows(pu, oy, ox, W)
                want = gather.gather_windows_plain(pu, oy, ox, W)
                lib = pu.unfold(0, W, 1).unfold(1, W, 1)[oy64, ox64]
                got2 = gather.gather_windows((pu, pv), oy, ox, W)
                want2 = gather.gather_windows_plain((pu, pv), oy, ox, W)
                torch.cuda.synchronize()
                err = max(int((got - want).abs().max()),
                          int((got2 - want2).abs().max()))
                worst = max(worst, err)
                if err or not torch.equal(lib, want) or \
                        not torch.equal(want2[0], want):
                    fail(f"K1 {sname} W={W} B={B} {pname} {bd}-bit differs "
                         f"({err})")
                if bd != 8 or pname != kind:
                    continue
                label = f"{sname} {pname} W={W} B={B}"
                _k1_row(label, lambda: gather.gather_windows(pu, oy, ox, W),
                        lambda: gather.gather_windows_plain(pu, oy, ox, W),
                        lambda: pu.unfold(0, W, 1).unfold(1, W, 1)[oy64,
                                                                  ox64],
                        _touched_bound((pu,), None, oy, ox, W), rows)
                py, px = _k1_path_origins(rng, pname, (hp, wp), W, n, B, dev)
                py64, px64 = py.long(), px.long()
                uv = (pu, pv)
                for tag, pl in (("", (pu,)), (" U+V", uv)):
                    if tag and kind != "chroma":
                        continue
                    a = pl[0] if len(pl) == 1 else pl
                    stk = torch.stack(pl)
                    for otag, y, x, y64, x64 in (
                            (" path", py, px, py64, px64),
                            ("", oy, ox, oy64, ox64)):
                        if not tag and not otag:
                            continue         # the random-origin row, above
                        _k1_row(
                            label + tag + otag,
                            lambda: gather.gather_windows(a, y, x, W),
                            lambda: gather.gather_windows_plain(a, y, x, W),
                            lambda: stk.unfold(1, W, 1).unfold(2, W, 1)[
                                :, y64, x64],
                            _touched_bound(pl, None, y, x, W), rows)
    return worst, rows


def phase_gather2(dev, rng, sname, planes, b32):
    """Two-plane K1 vs plain at the golden path's gathers of one frame
    size (five shapes; the chroma ones one plane and U+V in one launch):
    int16 and int32 planes, selector all LAST, all GOLDEN, mixed and out
    of range, exact.  Timed on int32 planes with a mixed selector at
    random origins (the earlier rows, kept so that they compare) and at
    path-like origins."""
    import torch

    from av1tpu_torch.encoder.kernels import gather
    worst, rows = 0, []
    for pname, W, n, k in K1_TWO:
        B = k * b32
        hp, wp = planes[pname]
        oy = torch.as_tensor(rng.integers(0, hp - W + 1, B),
                             dtype=torch.int32, device=dev)
        ox = torch.as_tensor(rng.integers(0, wp - W + 1, B),
                             dtype=torch.int32, device=dev)
        sels = {"LAST": torch.zeros(B, dtype=torch.int32, device=dev),
                "GOLDEN": torch.ones(B, dtype=torch.int32, device=dev),
                "mixed": torch.as_tensor(rng.integers(0, 2, B),
                                         dtype=torch.int32, device=dev),
                "out of range": torch.as_tensor(rng.integers(-3, 5, B),
                                                dtype=torch.int32,
                                                device=dev)}
        for bd, dtype in ((8, torch.int32), (10, torch.int32),
                          (10, torch.int16)):
            lu, lv, gu, gv = (torch.as_tensor(
                rng.integers(0, 1 << bd, (hp, wp)), dtype=dtype, device=dev)
                for _ in range(4))
            for sel, ri in sels.items():
                got = gather.gather_windows2(lu, gu, ri, oy, ox, W)
                want = gather.gather_windows2_plain(lu, gu, ri, oy, ox, W)
                got2 = gather.gather_windows2((lu, lv), (gu, gv), ri, oy, ox,
                                              W)
                want2 = gather.gather_windows2_plain((lu, lv), (gu, gv), ri,
                                                     oy, ox, W)
                torch.cuda.synchronize()
                err = max(int((got - want).abs().max()),
                          int((got2 - want2).abs().max()))
                worst = max(worst, err)
                if err or not torch.equal(want2[0], want):
                    fail(f"K1 two-plane {sname} W={W} B={B} {pname} "
                         f"{bd}-bit {dtype} {sel} differs ({err})")
            if bd != 8:
                continue
            ri = sels["mixed"]
            ri64, oy64, ox64 = ri.long(), oy.long(), ox.long()
            stk = torch.stack([lu, gu])
            if not torch.equal(stk.unfold(1, W, 1).unfold(2, W, 1)[
                    ri64, oy64, ox64], gather.gather_windows2_plain(
                        lu, gu, ri, oy, ox, W)):
                fail(f"two-plane library call differs at W={W} B={B}")
            label = f"{sname} {pname} W={W} B={B}"
            # bytes the data needs: the plane elements some window
            # covers (each once), the three index vectors, the output
            _k1_row(label,
                    lambda: gather.gather_windows2(lu, gu, ri, oy, ox, W),
                    lambda: gather.gather_windows2_plain(lu, gu, ri, oy, ox,
                                                         W),
                    lambda: stk.unfold(1, W, 1).unfold(2, W, 1)[ri64, oy64,
                                                                ox64],
                    _touched_bound((lu, gu), ri, oy, ox, W), rows)
            py, px = _k1_path_origins(rng, pname, (hp, wp), W, n, B, dev)
            py64, px64 = py.long(), px.long()
            stk2 = torch.stack([torch.stack([lu, lv]),
                                torch.stack([gu, gv])], 1)   # (2, 2, h, w)
            for tag, last, gold in (("", lu, gu), (" U+V", (lu, lv),
                                                  (gu, gv))):
                if tag and pname != "chroma":
                    continue
                s_ = stk if not tag else stk2
                for otag, y, x, y64, x64 in ((" path", py, px, py64, px64),
                                             ("", oy, ox, oy64, ox64)):
                    if not tag and not otag:
                        continue             # the random-origin row, above
                    if tag:
                        def library(y64=y64, x64=x64):
                            return s_.unfold(2, W, 1).unfold(3, W, 1)[
                                :, ri64, y64, x64]
                    else:
                        def library(y64=y64, x64=x64):
                            return s_.unfold(1, W, 1).unfold(2, W, 1)[
                                ri64, y64, x64]
                    pl = (lu, gu) if not tag else (lu, lv, gu, gv)
                    _k1_row(label + tag + otag,
                            lambda: gather.gather_windows2(last, gold, ri, y,
                                                           x, W),
                            lambda: gather.gather_windows2_plain(
                                last, gold, ri, y, x, W),
                            library, _touched_bound(pl, ri, y, x, W), rows)
    return worst, rows


def _counters():
    from av1tpu_torch.encoder.kernels import gather, refine
    return {"gather_windows": gather.gather_windows,
            "gather_windows2": gather.gather_windows2,
            "refine_ssd": refine.refine_ssd}


def run_slice(name: str, frames, golden: bool, dev_name: str, Q: int = 96,
              filters: bool = False):
    """One stream through encode_stream on the card, with the launch
    counts set to 0 just before and read just after.  Each dispatch is
    bracketed by synchronizes for the per-frame times (the host thread
    launches and entropy-codes in turn, so this costs the stream
    little).  ``filters``: the daemon's default config apart from
    chunking, TpuEncoderConfig(chunk=1) (golden, CDEF and LR on, so
    ``golden`` is True); without it CDEF and LR are off.  Returns a dict
    of what the run showed."""
    import numpy as np
    import torch

    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine

    class Timed(SpecTorchEngine):
        """Records per dispatch: kind, ms, GOLDEN share, recon planes,
        filter levels, CDEF strengths and LR choices."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rows, self.fin_ms = [], []

        def _submit(self, frame, qindex, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pend = super()._submit(frame, qindex, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            kind, out = pend[0], pend[11]
            rec = out[0:3] if kind == "key" else out[5:8]
            share = None if kind == "key" else out[14].float().mean()
            cdefs, lrc = (out[16], out[17]) if kind == "key" else \
                (out[9], out[10])
            self.rows.append((kind, ms, share,
                              tuple(p.to(torch.int16) for p in rec),
                              pend[14], pend[15], cdefs.tolist(),
                              lrc.cpu().numpy()))
            return pend

        def _finalize(self, pending):
            t = time.perf_counter()
            res = SpecTorchEngine._finalize(pending)
            self.fin_ms.append((time.perf_counter() - t) * 1e3)
            return res

    N = len(frames)
    H, W = frames[0].height, frames[0].width
    cfg = (TpuEncoderConfig(chunk=1) if filters else
           TpuEncoderConfig(chunk=1, golden=golden, cdef=False, lr=False))
    eng = Timed(cfg, device=dev_name)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(eng.encode_stream(frames, Q))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if len(out) != N or len(eng.rows) != N:
        fail(f"{name}: {len(out)} payloads for {N} frames")
    if any(t.device.type != "cuda" for t in eng._ref_dev) or \
            any(t.device.type != "cuda" for t in eng._golden_dev):
        fail(f"{name}: reference planes are not on the card")
    hp, wp = geometry(W, H)[0]["luma"]
    if tuple(eng._ref_dev[0].shape) != (hp - 128, wp - 128):
        fail(f"{name}: the engine's planes are {tuple(eng._ref_dev[0].shape)}"
             f", the kernel phase assumed {(hp - 128, wp - 128)}")
    mse = [float(np.mean((r[3][0][:H, :W].cpu().numpy().astype(np.float64)
                          - f.y) ** 2)) for r, f in zip(eng.rows, frames)]
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(mse))
    if not np.isfinite(psnr) or psnr < 28.0:
        fail(f"{name}: Y-PSNR {psnr} dB")
    keys = [k for _, k in out]
    n_p = N - sum(keys)
    key_ms = [r[1] for r in eng.rows if r[0] == "key"]
    p_ms = [r[1] for r in eng.rows if r[0] != "key"]
    shares = [None if r[2] is None else float(r[2]) for r in eng.rows]
    bpp = sum(len(p) * 8 for p, _ in out) / (N * W * H)
    log(f"{name}: {N} frames in {wall:.3f} s = {N / wall:.3f} fps, "
        f"{bpp:.5f} bpp, Y-PSNR {psnr:.3f} dB (q{Q}), key "
        f"{np.mean(key_ms):.1f} ms, P {np.mean(p_ms):.1f} ms (min "
        f"{min(p_ms):.1f}), host finalize key "
        f"{np.mean([m for m, k in zip(eng.fin_ms, keys) if k]):.1f} ms, P "
        f"{np.mean([m for m, k in zip(eng.fin_ms, keys) if not k]):.1f} ms")
    log(f"{name}: frame types {['K' if k else 'P' for k in keys]}, bytes "
        f"{[len(p) for p, _ in out]}, GOLDEN share per frame "
        f"{['-' if x is None else round(x, 4) for x in shares]}")
    log(f"{name}: launches {launches}, per P-frame "
        f"{ {k: round(v / n_p, 2) for k, v in launches.items()} }, filter "
        f"levels (y, uv) per frame {[(r[4], r[5]) for r in eng.rows]}")
    if filters:
        from av1tpu_torch.specav1 import torch_lr
        solved = len(torch_lr.PRESETS)
        lr_shares = [(round(float((r[7] >= 0).mean()), 4),
                      round(float((r[7] == solved).mean()), 4))
                     for r in eng.rows]
        log(f"{name}: CDEF strengths [y_pri, y_sec, uv_pri, uv_sec] per "
            f"frame {[r[6] for r in eng.rows]}; share of the "
            f"{eng.rows[0][7].size} restoration units on, and solved, per "
            f"frame {lr_shares}")
    return {"eng": eng, "out": out, "keys": keys, "launches": launches,
            "shares": shares, "frame": frames[-1]}


def _decode_mismatch(payloads, recons):
    """The port's spec decoder on a stream: None when every plane of
    every frame equals the reconstruction given as host arrays, else
    what differs.  Runs in a decode worker process."""
    import numpy as np

    from av1tpu_torch.specav1 import decoder
    dec = decoder.Decoder()
    for i, (tu, rec) in enumerate(zip(payloads, recons)):
        got = dec.decode_tu(bytes(tu))
        if len(got) != 1:
            return (f"the spec decoder returned {len(got)} frames for "
                    f"payload {i}")
        for pl in range(3):
            hh, ww = got[0][pl].shape
            if not np.array_equal(np.asarray(got[0][pl], np.int64),
                                  rec[pl][:hh, :ww].astype(np.int64)):
                return f"decoded frame {i} plane {pl} != port recon"
    return None


def _decode_job(payloads, recons):
    t = time.perf_counter()
    return _decode_mismatch(payloads, recons), time.perf_counter() - t


def decode_async(name: str, payloads, recons, what: str) -> None:
    """Hands a stream's decode check to a worker process (the Python
    decoder takes 11-28 s a 1080p frame), so that the card encodes the
    next cells meanwhile; ``decode_wait`` collects the verdicts."""
    if len(payloads) != len(recons):
        fail(f"{name}: {len(payloads)} payloads for {len(recons)} recons")
    host = [tuple(p.cpu().numpy() for p in r) for r in recons]
    check_async(name, what, _decode_job, [bytes(p) for p in payloads], host)


def check_async(name: str, what: str, job, *args,
                decoder: str = "spec decoder") -> None:
    """Runs ``job(*args)`` in a decode worker process; it returns (what
    differs or None, seconds[, a line to print]).  ``decoder`` names the
    decoder in the verdict line."""
    import multiprocessing
    if _decodes["pool"] is None:
        _decodes["pool"] = multiprocessing.get_context("spawn").Pool(
            DECODE_WORKERS)
    _decodes["jobs"].append((name, what, decoder, _decodes[
        "pool"].apply_async(job, args)))


def decode_wait() -> None:
    """Every decode check's verdict, in the order they were handed out;
    then the worker processes end."""
    pool = _decodes["pool"]
    if pool is None:
        return
    t = time.perf_counter()
    for name, what, decoder, job in _decodes["jobs"]:
        err, secs, *note = job.get()
        if err:
            fail(f"{name}: {err}")
        for line in note:
            log(f"{name}: {line}")
        log(f"{name}: the port's {decoder} reproduces the recon of "
            f"{what} exactly, three planes each (decode {secs:.1f} s in a "
            "worker process)")
    pool.close()
    pool.join()
    _decodes["pool"] = None
    log(f"decode checks: waited {time.perf_counter() - t:.1f} s after the "
        "last encode")


def decode_check(name: str, r: dict) -> None:
    """The port's spec decoder on the whole stream of a run: every plane
    of every frame must equal the encoder's reconstruction, which holds
    the motion vectors, the reference choice and the loop filter of the
    full-size path to a second statement of each."""
    rows = r["eng"].rows
    decode_async(name, [p for p, _ in r["out"]], [row[3] for row in rows],
                 f"all {len(rows)} frames")


def need_launches(name: str, launches: dict, kernels) -> None:
    idle = [k for k in kernels if launches[k] == 0]
    if idle:
        fail(f"{name}: the path did not launch {idle}: {launches}")


def need_k1_launches(name: str, launches: dict, n_p: int, one: int,
                     two: int) -> None:
    """K1's launches per P-frame: U and V go in one launch, so a golden
    P-frame takes 3 one-plane + 5 two-plane, one with golden off 7."""
    got = (launches["gather_windows"], launches["gather_windows2"])
    if got != (one * n_p, two * n_p):
        fail(f"{name}: K1 launches {got} over {n_p} P-frames, expected "
             f"{one} one-plane + {two} two-plane a frame")


def stream_headers(out):
    """(sequence header, [frame header]) parsed from a run's payloads."""
    from av1tpu_torch.specav1 import headers, obu
    seq, hdrs = None, []
    for payload, _ in out:
        for o in obu.parse_obus(payload):
            if o.type == obu.OBU_SEQUENCE_HEADER:
                seq = headers.parse_sequence_header(o.payload)
            elif o.type == obu.OBU_FRAME:
                hdrs.append(headers.parse_frame_header(o.payload, seq))
    return seq, hdrs


def check_filter_headers(name: str, r: dict) -> None:
    """A default-config stream: the sequence header enables CDEF and LR,
    each frame header carries the strengths the encoder searched, with
    the damping of its qindex, and luma WIENER restoration."""
    from av1tpu_torch.spec_engine import cdef_damping
    seq, hdrs = stream_headers(r["out"])
    if not (seq.enable_cdef and seq.enable_restoration):
        fail(f"{name}: sequence header enable_cdef {seq.enable_cdef}, "
             f"enable_restoration {seq.enable_restoration}")
    for i, (h, row) in enumerate(zip(hdrs, r["eng"].rows)):
        c = h.cdef
        want = list(row[6])
        got = [c.y_pri[0], c.y_sec[0], c.uv_pri[0], c.uv_sec[0]]
        damp = cdef_damping(h.base_q_idx)
        if c.bits or c.damping != damp or want != got:
            fail(f"{name}: frame {i} CDEF header {got} (bits {c.bits}, "
                 f"damping {c.damping} for {damp}) for searched strengths "
                 f"{want}")
        if list(h.lr.frame_restoration_type) != [1, 0, 0]:
            fail(f"{name}: frame {i} restoration types "
                 f"{h.lr.frame_restoration_type}")
    log(f"{name}: headers enable CDEF and LR; per-frame CDEF strengths "
        "as searched, damping from each frame's qindex, luma WIENER "
        "restoration")


def golden_clip(w: int, h: int):
    """8 clean frames: scene A, five blends towards scene B (each step
    under the scene-cut threshold), a cut back to A and one more A."""
    import numpy as np

    from av1tpu_torch.utils.cleansrc import clean_frame
    from av1tpu_torch.utils.testsrc import Frame
    frames = [clean_frame(w, h, 0, 0)]
    for k in range(1, 6):
        fa, fb = clean_frame(w, h, k, 0), clean_frame(w, h, k, 1)
        frames.append(Frame(*(
            (((5 - k) * pa.astype(np.int32) + k * pb.astype(np.int32) + 2)
             // 5).astype(np.uint8)
            for pa, pb in ((fa.y, fb.y), (fa.u, fb.u), (fa.v, fb.v)))))
    return frames + [clean_frame(w, h, 6, 0), clean_frame(w, h, 7, 0)]


def phase_slices(dev_name: str, daemon_payloads):
    """The full-size paths; returns each path's launch counts, its run
    (engine and last frame included), and what the stripe cells compare
    with (``phase_stripes``).  ``daemon_payloads``, the daemon-1080p
    pass's video payloads, must equal slice-1080p-chunk8's: the same
    frames at the same qindex in the same config."""
    from av1tpu_torch.spec_engine import noise_floor
    from av1tpu_torch.utils.cleansrc import clean_frame
    W, H, _ = SIZES["1080p"]
    counts, runs, refs = {}, {}, {}

    # one reference, grainy: the earlier slice at a smaller depth
    grain9 = grain_clip()
    frames = grain9[:4]
    if not noise_floor(frames[0].y) > 1.0:
        fail("grainy clip's noise floor is not above 1")
    r = run_slice("slice-1080p-grain", frames, False, dev_name)
    if r["keys"] != [True, False, False, False] or r["eng"]._gop_deblock:
        fail(f"slice-1080p-grain: frame types {r['keys']}, deblock "
             f"{r['eng']._gop_deblock}")
    need_launches("slice-1080p-grain", r["launches"],
                  ("gather_windows", "refine_ssd"))
    need_k1_launches("slice-1080p-grain", r["launches"], 3, 7, 0)
    decode_check("slice-1080p-grain", r)
    counts["slice-1080p-grain"] = r["launches"]

    # the same grainy clip in the daemon's default config: golden, CDEF
    # and LR on (what a grainy Blu-ray rip runs: deblocking off)
    r = run_slice("slice-1080p-default", frames, True, dev_name,
                  filters=True)
    if r["keys"] != [True, False, False, False] or r["eng"]._gop_deblock:
        fail(f"slice-1080p-default: frame types {r['keys']}, deblock "
             f"{r['eng']._gop_deblock}")
    check_filter_headers("slice-1080p-default", r)
    need_launches("slice-1080p-default", r["launches"],
                  ("gather_windows", "gather_windows2", "refine_ssd"))
    need_k1_launches("slice-1080p-default", r["launches"], 3, 3, 5)
    decode_check("slice-1080p-default", r)
    counts["slice-1080p-default"] = r["launches"]
    runs["slice-1080p-default"] = r

    # the daemon's default config exactly, TpuEncoderConfig(): the grain
    # clip's 1 key + 8 P make one full chunk of 8, which falls back to
    # the raw upload (the grain's residual outliers exceed the cap); its
    # first four payloads are slice-1080p-default's
    default_out = [p for p, _ in r["out"]]
    c = run_chunk_cell("slice-1080p-chunk8", grain9, dev_name, packed=False)
    if c["payloads"][:4] != default_out:
        fail("slice-1080p-chunk8: the first four payloads differ from "
             "slice-1080p-default's")
    decode_async("slice-1080p-chunk8", c["payloads"], c["recons"],
                 f"all {len(grain9)} frames")
    counts["slice-1080p-chunk8"] = c["launches"]
    refs["slice-1080p-chunk8"] = {**c, "name": "slice-1080p-chunk8",
                                  "frames": grain9}
    if daemon_payloads != c["payloads"]:
        fail("daemon-1080p: the daemon's payloads differ from "
             "slice-1080p-chunk8's")
    log("daemon-1080p: the daemon's 9 payloads equal slice-1080p-chunk8's "
        "byte for byte")

    # two references: scene A, five blends towards scene B (each step
    # under the scene-cut threshold), then a cut back to A
    frames = golden_clip(W, H)
    r = run_slice("slice-1080p-golden", frames, True, dev_name)
    if r["keys"] != [True] + [False] * 7:
        fail(f"slice-1080p-golden: expected one keyframe and an inter-coded "
             f"cut back, got {r['keys']}")
    sh = r["shares"][1:]
    if not any(x > 0 for x in sh) or not any(x < 1 for x in sh):
        fail(f"slice-1080p-golden: GOLDEN shares {sh}: both references "
             "must be chosen")
    if sh[5] <= 0.5:
        fail(f"slice-1080p-golden: the cut-back frame chose GOLDEN on only "
             f"{sh[5]} of its blocks")
    need_launches("slice-1080p-golden", r["launches"],
                  ("gather_windows", "gather_windows2", "refine_ssd"))
    need_k1_launches("slice-1080p-golden", r["launches"], 7, 3, 5)
    decode_check("slice-1080p-golden", r)
    counts["slice-1080p-golden"] = r["launches"]
    runs["slice-1080p-golden"] = r

    # clean 720p: 720 % 32 == 16 and 1280 % 16 == 0, so the GOP filters
    W, H, _ = SIZES["720p"]
    frames = clean_clip_720p()
    if noise_floor(frames[0].y) > 1.0:
        fail("clean 720p clip's noise floor is above 1")
    r = run_slice("slice-720p-clean", frames, True, dev_name)
    if r["keys"] != [True, False, False, False] or not r["eng"]._gop_deblock:
        fail(f"slice-720p-clean: frame types {r['keys']}, deblock "
             f"{r['eng']._gop_deblock}")
    levels = [tuple(h.lf.level) for h in stream_headers(r["out"])[1]]
    if len(levels) != 4 or not all(all(lv) for lv in levels):
        fail(f"slice-720p-clean: header filter levels {levels}")
    log(f"slice-720p-clean: deblocking on, frame-header levels {levels}")
    need_launches("slice-720p-clean", r["launches"],
                  ("gather_windows", "gather_windows2", "refine_ssd"))
    need_k1_launches("slice-720p-clean", r["launches"], 3, 3, 5)
    decode_check("slice-720p-clean", r)
    counts["slice-720p-clean"] = r["launches"]
    runs["slice-720p-clean"] = r

    # the same clip in the default config: deblock, then CDEF, then LR,
    # on the 16-px strip geometry (build_skip8's strip rows)
    r = run_slice("slice-720p-default", frames, True, dev_name, filters=True)
    if r["keys"] != [True, False, False, False] or not r["eng"]._gop_deblock:
        fail(f"slice-720p-default: frame types {r['keys']}, deblock "
             f"{r['eng']._gop_deblock}")
    levels = [tuple(h.lf.level) for h in stream_headers(r["out"])[1]]
    if len(levels) != 4 or not all(all(lv) for lv in levels):
        fail(f"slice-720p-default: header filter levels {levels}")
    check_filter_headers("slice-720p-default", r)
    need_launches("slice-720p-default", r["launches"],
                  ("gather_windows", "gather_windows2", "refine_ssd"))
    need_k1_launches("slice-720p-default", r["launches"], 3, 3, 5)
    decode_check("slice-720p-default", r)
    counts["slice-720p-default"] = r["launches"]
    runs["slice-720p-default"] = r
    refs["slice-720p-default"] = slice_ref("slice-720p-default", r, frames)

    # the default config exactly on the clean 720p drift: 1 key + 16 P,
    # two full chunks of 8, both through the packed upload
    frames = [clean_frame(W, H, i, 0) for i in range(17)]
    c = run_chunk_cell("slice-720p-chunk8", frames, dev_name, packed=True)
    decode_async("slice-720p-chunk8", c["payloads"], c["recons"],
                 f"all {len(frames)} frames")
    counts["slice-720p-chunk8"] = c["launches"]
    return counts, runs, refs


def slice_ref(name: str, r: dict, frames) -> dict:
    """What the stripe and dist cells compare with, from a run_slice
    run: its frames, payloads, recons (int16 on the card), key and mean
    P ms."""
    import numpy as np
    rows = r["eng"].rows
    return {"name": name, "frames": frames,
            "payloads": [p for p, _ in r["out"]],
            "recons": [x[3] for x in rows], "key_ms": rows[0][1],
            "p_ms": np.mean([x[1] for x in rows[1:]])}


def phase_stripes(card: str, refs: dict) -> tuple:
    """The stripe cells: the daemon's default job on a multi-card host,
    its stripes issued from one thread (all on one card where the machine
    has one).  stripes-1080p-chunk8 runs
    slice-1080p-chunk8's 9 grainy frames in TpuEncoderConfig() over 2
    stripes (a striped keyframe, two tile rows a stripe, and one raw chunk
    of 8 striped P-frames); stripes-720p-default slice-720p-default's
    clean 1 key + 3 P in TpuEncoderConfig(chunk=1) over 4 stripes (the
    strip, deblocking, CDEF and LR on the gathered recon; the middle
    stripes read halos from both sides).  Returns their launch counts, and
    each cell's run by the name of the one-device cell it equals."""
    from av1tpu_torch.config import TpuEncoderConfig
    counts, runs = {}, {}
    for name, cfg, n, ref in (
            ("stripes-1080p-chunk8", TpuEncoderConfig(), 2,
             refs["slice-1080p-chunk8"]),
            ("stripes-720p-default", TpuEncoderConfig(chunk=1), 4,
             refs["slice-720p-default"])):
        r = run_stripe_cell(name, ref["frames"], cfg, n, card, ref)
        counts[name] = r["launches"]
        runs[ref["name"]] = {**r, "name": name, "n": n}
    return counts, runs


def run_legacy(name: str, frames, cfg, dev_name: str, Q: int = 96) -> dict:
    """One stream of the private av1tpu profile through
    LegacyTorchEngine(cfg).encode_stream on the card, with the launch
    counts set to 0 just before and read just after; each dispatch
    bracketed by synchronizes (a chunk's ms is shared by its frames).
    Returns the payloads, key flags, per-frame recons (int16 on the
    card), GOLDEN shares, times and launches."""
    import numpy as np
    import torch

    from av1tpu_torch.legacy.engine import LegacyTorchEngine

    class Timed(LegacyTorchEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rows = []    # (kind, ms, GOLDEN share, recon)

        def _row(self, kind, ms, out, two):
            share = float(out[13].float().mean()) if two else None
            self.rows.append((kind, ms, share,
                              tuple(p.to(torch.int16) for p in out[5:8])))

        def _submit(self, frame, qindex, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pend = super()._submit(frame, qindex, **kw)
            torch.cuda.synchronize()
            self._row("key" if pend[0] else "inter",
                      (time.perf_counter() - t) * 1e3, pend[4], pend[7])
            return pend

        def _submit_chunk(self, frames, qindexes):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pend = super()._submit_chunk(frames, qindexes)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3 / len(frames)
            for out in pend[3]:
                self._row("chunk", ms, out, pend[7])
            return pend

    N = len(frames)
    H, W = frames[0].height, frames[0].width
    eng = Timed(cfg, device=dev_name)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(eng.encode_stream(frames, Q))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if len(out) != N or len(eng.rows) != N:
        fail(f"{name}: {len(out)} payloads, {len(eng.rows)} dispatched "
             f"frames for {N}")
    if any(t.device != eng.device for t in eng._ref_dev):
        fail(f"{name}: reference planes are not on {eng.device}")
    mse = [float(np.mean((r[3][0][:H, :W].cpu().numpy().astype(np.float64)
                          - f.y) ** 2)) for r, f in zip(eng.rows, frames)]
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(mse))
    if not np.isfinite(psnr) or psnr < 28.0:
        fail(f"{name}: Y-PSNR {psnr} dB")
    keys = [k for _, k in out]
    key_ms = [r[1] for r in eng.rows if r[0] == "key"]
    p_ms = [r[1] for r in eng.rows if r[0] != "key"]
    bpp = sum(len(p) * 8 for p, _ in out) / (N * W * H)
    log(f"{name}: {N} frames in {wall:.3f} s = {N / wall:.3f} fps, "
        f"{bpp:.5f} bpp, Y-PSNR {psnr:.3f} dB (q{Q}), key "
        f"{np.mean(key_ms):.1f} ms, P {np.mean(p_ms):.1f} ms (min "
        f"{min(p_ms):.1f}) | speed {cfg.speed}, chunk {cfg.chunk}, "
        f"dispatches {[r[0] for r in eng.rows]}")
    log(f"{name}: frame types {['K' if k else 'P' for k in keys]}, bytes "
        f"{[len(p) for p, _ in out]}, GOLDEN share per frame "
        f"{['-' if r[2] is None else round(r[2], 4) for r in eng.rows]}")
    n_p = N - sum(keys)
    log(f"{name}: launches {launches}, per P-frame "
        f"{ {k: round(v / n_p, 2) for k, v in launches.items()} }")
    return {"eng": eng, "out": out, "keys": keys, "launches": launches,
            "payloads": [p for p, _ in out], "recons": [r[3] for r in
                                                        eng.rows],
            "shares": [r[2] for r in eng.rows], "wall": wall}


def _legacy_mismatch(payloads, recons, w: int, h: int) -> str | None:
    """The port's legacy decoder (av1tpu_torch.legacy.decoder, on the
    CPU) on a private-profile stream: None when every plane of every frame
    equals the reconstruction given as host arrays, else what differs."""
    import numpy as np

    from av1tpu_torch.legacy import decoder
    from av1tpu_torch.media import obu
    state = decoder.DecoderState(device="cpu")
    seq = obu.write_obu(obu.OBU_SEQUENCE_HEADER,
                        obu.SequenceHeader(width=w, height=h).write())
    if decoder.decode_frame_payload(seq, state) is not None:
        return "the sequence header decoded to a frame"
    for i, (p, rec) in enumerate(zip(payloads, recons)):
        fr = decoder.decode_frame_payload(bytes(p), state)
        for pl, got in enumerate((fr.y, fr.u, fr.v)):
            hh, ww = got.shape
            if not np.array_equal(got.astype(np.int64),
                                  rec[pl][:hh, :ww].astype(np.int64)):
                return f"legacy-decoded frame {i} plane {pl} != port recon"
    return None


def _legacy_decode_job(payloads, recons, w, h):
    t = time.perf_counter()
    return _legacy_mismatch(payloads, recons, w, h), time.perf_counter() - t


def legacy_decode_async(name: str, r: dict, w: int, h: int) -> None:
    host = [tuple(p.cpu().numpy() for p in rec) for rec in r["recons"]]
    check_async(name, f"all {len(host)} frames", _legacy_decode_job,
                [bytes(p) for p in r["payloads"]], host, w, h,
                decoder="legacy decoder (on the CPU)")


def phase_legacy(dev_name: str) -> dict:
    """The private av1tpu profile (tpu.bitstream "av1tpu") on the card:
    legacy-1080p-chunk, slice-1080p-chunk8's 9 grainy frames at speed 6
    in two chunks of 4 (the cap at 1080p), bytes equal to chunk=1's; and
    legacy-1080p-golden, slice-1080p-golden's 8 clean frames at speed 4
    (two references, transform selection) and chunk=1.  K1 and K2 launch
    twice a P-frame for each reference searched.  Each stream decodes to
    its recon in the port's legacy decoder on the CPU (decode workers).
    Returns the launch counts by path."""
    from av1tpu_torch.config import TpuEncoderConfig
    W, H, _ = SIZES["1080p"]
    grain9 = grain_clip()
    t0 = time.perf_counter()
    counts = {}
    r = run_legacy("legacy-1080p-chunk", grain9,
                   TpuEncoderConfig(bitstream="av1tpu", chunk=8), dev_name)
    if [row[0] for row in r["eng"].rows] != ["key"] + ["chunk"] * 8 or \
            r["keys"] != [True] + [False] * 8:
        fail(f"legacy-1080p-chunk: dispatches "
             f"{[x[0] for x in r['eng'].rows]}, frame types {r['keys']} "
             "(a key, two chunks of 4)")
    for k in ("gather_windows", "refine_ssd"):
        if r["launches"][k] != 2 * 8:
            fail(f"legacy-1080p-chunk: {k} launches {r['launches']}, "
                 "expected 2 a P-frame (one reference)")
    legacy_decode_async("legacy-1080p-chunk", r, W, H)
    counts["legacy-1080p-chunk"] = r["launches"]
    one = run_legacy("legacy-1080p-chunk1", grain9,
                     TpuEncoderConfig(bitstream="av1tpu", chunk=1),
                     dev_name)
    if one["payloads"] != r["payloads"]:
        fail("legacy-1080p-chunk: chunked bytes differ from chunk=1's")
    log("legacy-1080p-chunk: two chunks of 4 give chunk=1's 9 payloads "
        "byte for byte")
    frames = golden_clip(W, H)
    g = run_legacy("legacy-1080p-golden", frames,
                   TpuEncoderConfig(bitstream="av1tpu", chunk=1, speed=4),
                   dev_name)
    # the profile has no golden-aware scene cut (the reference's
    # TpuEngine neither): the cut back to scene A codes as a keyframe
    if g["keys"] != [True] + [False] * 5 + [True, False]:
        fail(f"legacy-1080p-golden: frame types {g['keys']}")
    sh = [x for x in g["shares"] if x is not None]
    if len(sh) != 6 or not any(x > 0 for x in sh):
        fail(f"legacy-1080p-golden: GOLDEN shares {g['shares']}")
    for k in ("gather_windows", "refine_ssd"):
        if g["launches"][k] != 4 * 6:
            fail(f"legacy-1080p-golden: {k} launches {g['launches']}, "
                 "expected 4 a P-frame (two references)")
    legacy_decode_async("legacy-1080p-golden", g, W, H)
    counts["legacy-1080p-golden"] = g["launches"]
    log(f"legacy: phase {time.perf_counter() - t0:.1f} s on the main "
        "thread")
    return counts


class Recons(list):
    """Each frame's reconstruction in dispatch order, and how many frames
    went through each stripes entry (``striped``)."""

    def __init__(self):
        super().__init__()
        self.striped = {"key": 0, "inter": 0}


@contextlib.contextmanager
def capture_recons():
    """Collects each frame's reconstruction (int16 copies on the
    device) in dispatch order while the block runs, from the outermost
    encoder call that makes it, wherever it is called (on the caller's
    thread or on the chunk dispatch worker): the keyframe or P-frame
    encoder, or a stripes entry, which calls them once a stripe and
    returns the frame."""
    import threading

    import torch

    from av1tpu_torch.specav1 import stripes, torch_inter, torch_intra
    recons = Recons()
    inside = threading.local()
    entries = {(torch_intra, "encode_frame"): (None, slice(0, 3)),
               (torch_inter, "encode_frame"): (None, slice(5, 8)),
               (stripes, "encode_key_striped"): ("key", slice(0, 3)),
               (stripes, "encode_inter_striped"): ("inter", slice(5, 8))}
    real = {key: getattr(*key) for key in entries}

    def spy(fn, kind, sl):
        def call(*a, **k):
            depth = getattr(inside, "depth", 0)
            inside.depth = depth + 1
            try:
                out = fn(*a, **k)
            finally:
                inside.depth = depth
            if depth == 0:
                recons.append(tuple(p.to(torch.int16) for p in out[sl]))
                if kind:
                    recons.striped[kind] += 1
            return out
        return call

    for (mod, name), (kind, sl) in entries.items():
        setattr(mod, name, spy(real[mod, name], kind, sl))
    try:
        yield recons
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def run_chunk_cell(name: str, frames, dev_name: str, packed: bool,
                   Q: int = 96) -> dict:
    """One stream in the daemon's default config exactly,
    TpuEncoderConfig() (chunk=8, delta_upload, golden, CDEF and LR on),
    with the launch counts set to 0 just before and read just after, and
    then through TpuEncoderConfig(delta_upload=False) and
    TpuEncoderConfig(chunk=1) in the same call: the bytes must agree
    frame by frame.  No dispatch is bracketed by
    synchronizes.  Per chunk: whether its upload was packed (``packed``
    says which every chunk must take), the host pack ms, the upload bytes
    packed against raw, submit-to-result ms (submit until the chunk's
    device work has ended, its wait behind older dispatches included),
    finalize ms; per run: fps over the stream and over its P-frames
    (first P submit to last payload), peak device memory (above what the
    earlier runs still hold); and the first chunk's upload alone, raw and
    packed."""
    import numpy as np
    import torch

    from av1tpu_torch import spec_engine
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.encoder import io_pack

    class Timed(spec_engine.SpecTorchEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first_p, self.sub_t, self.res_ms = None, [], []
            self.fin_ms = {"key": [], "single": [], "chunk": []}
            self.key_ms = []

        def _submit(self, frame, qindex, **kw):
            if kw.get("is_key"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                pend = super()._submit(frame, qindex, **kw)
                torch.cuda.synchronize()
                self.key_ms.append((time.perf_counter() - t) * 1e3)
                return pend
            if self.first_p is None:
                self.first_p = time.perf_counter()
            return super()._submit(frame, qindex, **kw)

        def _submit_chunk(self, frames, qindexes):
            t = time.perf_counter()
            if self.first_p is None:
                self.first_p = t
            self.sub_t.append(t)
            return super()._submit_chunk(frames, qindexes)

        def _finalize(self, pending):
            t = time.perf_counter()
            res = super()._finalize(pending)
            self.fin_ms["key" if res[1] else "single"].append(
                (time.perf_counter() - t) * 1e3)
            return res

        def _finalize_chunk(self, pending):
            i = len(self.res_ms)
            pending[10].result()
            issued[i]["event"].synchronize()
            t = time.perf_counter()
            self.res_ms.append((t - self.sub_t[i]) * 1e3)
            res = super()._finalize_chunk(pending)
            self.fin_ms["chunk"].append((time.perf_counter() - t) * 1e3)
            return res

    real_pack, real_chunk = io_pack.pack_chunk, spec_engine.encode_chunk
    packs, issued = [], []

    def pack_spy(planes, base, cap=None, bit_depth=8):
        t = time.perf_counter()
        res = real_pack(planes, base, cap, bit_depth)
        packs.append(((time.perf_counter() - t) * 1e3,
                      None if res is None else sum(a.nbytes for a in res),
                      sum(p.nbytes for tri in planes for p in tri),
                      None if res is None else
                      ["spatial-H" if m == io_pack.MODE_SPATIAL_H
                       else "temporal" for m in res[3]]))
        return res

    def chunk_spy(src, *a, **k):
        res = real_chunk(src, *a, **k)
        ev = torch.cuda.Event()
        ev.record()
        issued.append({"packed": isinstance(src, tuple), "event": ev})
        return res

    N = len(frames)
    H, W = frames[0].height, frames[0].width
    runs = {}
    counters = _counters()
    for label, cfg in (("chunk=8", TpuEncoderConfig()),
                       ("chunk=8 raw", TpuEncoderConfig(delta_upload=False)),
                       ("chunk=1", TpuEncoderConfig(chunk=1))):
        eng = Timed(cfg, device=dev_name)
        packs.clear()
        issued.clear()
        for fn in counters.values():
            fn.launches = 0
        io_pack.pack_chunk, spec_engine.encode_chunk = pack_spy, chunk_spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        try:
            with capture_recons() as recons:
                t0 = time.perf_counter()
                out = list(eng.encode_stream(frames, Q))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        finally:
            io_pack.pack_chunk, spec_engine.encode_chunk = real_pack, \
                real_chunk
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[label] = dict(
            label=label, eng=eng, out=out, recons=recons, launches=launches,
            fps=N / (t1 - t0), p_fps=(N - 1) / (t1 - eng.first_p),
            peak=torch.cuda.max_memory_allocated() - held, packs=list(packs),
            issued=[c["packed"] for c in issued])
    c8, c8r, c1 = runs["chunk=8"], runs["chunk=8 raw"], runs["chunk=1"]
    keys = [k for _, k in c8["out"]]
    n_p = N - sum(keys)
    if keys != [True] + [False] * (N - 1):
        fail(f"{name}: frame types {keys}")
    if len(c8["recons"]) != N:
        fail(f"{name}: {len(c8['recons'])} recons for {N} frames")
    k = c8["eng"].cfg.chunk
    if len(c8["issued"]) != n_p // k or c1["issued"]:
        fail(f"{name}: {len(c8['issued'])} chunk dispatches with chunk=8, "
             f"{len(c1['issued'])} with chunk=1, for {n_p} P-frames")
    for other in (c8r, c1):
        if [p for p, _ in c8["out"]] != [p for p, _ in other["out"]]:
            bad = [i for i, (a, b) in enumerate(zip(c8["out"], other["out"]))
                   if a[0] != b[0]]
            fail(f"{name}: chunk=8 and {other['label']} streams differ at "
                 f"frames {bad}")
    if c8["issued"] != [packed] * len(c8["issued"]):
        fail(f"{name}: chunk uploads packed {c8['issued']}, expected "
             f"{packed} for every chunk")
    if c8r["packs"] or any(c8r["issued"]):
        fail(f"{name}: delta_upload=False packed a chunk")
    need_launches(name, c8["launches"],
                  ("gather_windows", "gather_windows2", "refine_ssd"))
    need_k1_launches(name, c8["launches"], n_p, 3, 5)
    if c8["launches"]["refine_ssd"] != 3 * n_p:
        fail(f"{name}: K2 launches {c8['launches']['refine_ssd']} over {n_p} "
             "P-frames, expected 3 a frame")
    mse = [float(np.mean((r[0][:H, :W].cpu().numpy().astype(np.float64)
                          - f.y) ** 2)) for r, f in zip(c8["recons"], frames)]
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(mse))
    if not np.isfinite(psnr) or psnr < 28.0:
        fail(f"{name}: Y-PSNR {psnr} dB")
    bpp = sum(len(p) * 8 for p, _ in c8["out"]) / (N * W * H)
    log(f"{name}: TpuEncoderConfig() (chunk=8, delta_upload, golden, CDEF, "
        f"LR), {N} frames (1 key + {n_p} P, {len(c8['issued'])} chunk(s) of "
        f"{k}): {bpp:.5f} bpp, Y-PSNR {psnr:.3f} dB (q{Q}); bytes equal "
        f"TpuEncoderConfig(delta_upload=False)'s and "
        f"TpuEncoderConfig(chunk=1)'s frame by frame")
    for i, ((pms, pbytes, rbytes, modes), pk) in enumerate(
            zip(c8["packs"], c8["issued"])):
        log(f"{name}: chunk {i}: upload "
            f"{f'packed {modes}' if pk else 'raw'}, host "
            f"pack {pms:.1f} ms, upload bytes "
            f"{'-' if pbytes is None else pbytes} packed against {rbytes} "
            f"raw; submit-to-result {c8['eng'].res_ms[i]:.1f} ms, finalize "
            f"{c8['eng'].fin_ms['chunk'][i]:.1f} ms")
    for label, rr in runs.items():
        fm = rr["eng"].fin_ms
        per_p = (f"{np.mean(fm['chunk']) / k:.1f} ms a P-frame in a chunk"
                 if fm["chunk"] else
                 f"{np.mean(fm['single']):.1f} ms a P-frame")
        log(f"{name}: {label}: {N} frames at {rr['fps']:.4f} fps, P-frames "
            f"at {rr['p_fps']:.3f} fps (first P submit to last payload), "
            f"finalize key {np.mean(fm['key']):.1f} ms, {per_p}, peak "
            f"device memory {rr['peak'] / 2 ** 20:.1f} MiB")
    # the upload alone, outside the stream: the first chunk's planes raw,
    # and packed against the key's source, host to device, best of 3
    planes = [Timed._pad_planes(f, 64) for f in frames[:k + 1]]
    dev = torch.device(dev_name)

    def best_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return min(times)

    raw_ms = best_ms(lambda: spec_engine.upload_chunk_raw(planes[1:], dev))
    pk = real_pack(planes[1:], planes[0])
    packed_ms = ("none (over the cap)" if pk is None else "%.3f ms"
                 % best_ms(lambda: [spec_engine.to_device(a, dev)
                                    for a in pk[:3]]))
    log(f"{name}: chunk 0's upload alone, host to device through pinned "
        f"memory (best of 3, synchronized): raw {raw_ms:.3f} ms, packed "
        f"{packed_ms}")
    log(f"{name}: launches {c8['launches']}, per P-frame "
        f"{ {kk: round(v / n_p, 2) for kk, v in c8['launches'].items()} }")
    return {"payloads": [p for p, _ in c8["out"]], "recons": c8["recons"],
            "launches": c8["launches"], "key_ms": c8["eng"].key_ms[0],
            "p_ms": np.mean(c8["eng"].res_ms) / k}


def time_dispatches(eng):
    """Times ``eng``'s dispatches into eng.key_ms and eng.p_ms: keys and
    single P-frames as their submit bracketed by synchronizes, a chunk's
    P-frames as its submit-to-result ms over its length (wrapping the
    instance's methods, so that an engine from the daemon's make_engine
    can be timed too)."""
    import torch
    eng.key_ms, eng.p_ms = [], []
    sub_t = []
    submit, submit_chunk = eng._submit, eng._submit_chunk
    finalize_chunk = eng._finalize_chunk

    def _submit(frame, qindex, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pend = submit(frame, qindex, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        (eng.key_ms if pend[0] == "key" else eng.p_ms).append(ms)
        return pend

    def _submit_chunk(frames, qindexes):
        sub_t.append(time.perf_counter())
        return submit_chunk(frames, qindexes)

    def _finalize_chunk(pending):
        t0 = sub_t.pop(0)
        pending[10].result()
        torch.cuda.synchronize()
        k = pending[9]
        eng.p_ms += [(time.perf_counter() - t0) * 1e3 / k] * k
        return finalize_chunk(pending)

    eng._submit, eng._submit_chunk = _submit, _submit_chunk
    eng._finalize_chunk = _finalize_chunk
    return eng


def run_stripe_cell(name: str, frames, cfg, n: int, card: str, ref: dict,
                    Q: int = 96) -> dict:
    """One stream through encode_stream with n stripes issued from this
    one thread, stripe k on card k mod the visible cards (all on one card
    where the machine has one: the striped arithmetic, halo windows and
    gathers, with every copy between stripes on that card), with the
    launch counts set to 0 just before and read just after.  Its payloads
    and its recon over the coded frame must equal ``ref``'s, the same
    frames' one-device cell; K1 must launch n x (3 + 5) and K2 n x 3
    times a P-frame.  Prints key and P ms beside the one-device cell's
    (``time_dispatches``) and returns them with the launch counts."""
    import numpy as np
    import torch

    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.specav1 import stripes

    N = len(frames)
    H, W = frames[0].height, frames[0].width
    cards = torch.cuda.device_count()
    group = tuple(f"cuda:{k % cards}" for k in range(n))
    eng = time_dispatches(SpecTorchEngine(cfg, device=group[0],
                                          stripe_devices=group))
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with capture_recons() as recons:
        t0 = time.perf_counter()
        out = list(eng.encode_stream(frames, Q))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    keys = [k for _, k in out]
    n_p = N - sum(keys)
    payloads = [p for p, _ in out]
    if payloads != ref["payloads"]:
        bad = [i for i, (a, b) in enumerate(zip(payloads, ref["payloads"]))
               if a != b]
        fail(f"{name}: payloads differ from the one-device cell's at frames "
             f"{bad} of {N}")
    if recons.striped != {"key": sum(keys), "inter": n_p} or \
            len(recons) != N:
        fail(f"{name}: {recons.striped} striped of {N} frames ({len(recons)} "
             "recons)")
    for i, (a, b) in enumerate(zip(recons, ref["recons"])):
        for pl, (pa, pb) in enumerate(zip(a, b)):
            hh, ww = (H, W) if pl == 0 else (H // 2, W // 2)
            if not torch.equal(pa[:hh, :ww], pb[:hh, :ww]):
                fail(f"{name}: frame {i} plane {pl}: the recon differs from "
                     "the one-device cell's")
    need_k1_launches(name, launches, n_p, 3 * n, 5 * n)
    if launches["refine_ssd"] != 3 * n * n_p:
        fail(f"{name}: K2 launches {launches['refine_ssd']} over {n_p} "
             f"P-frames, expected {3 * n} a frame")
    sh = stripes.stripe_pad(-(-H // 64) * 64, n) // n
    across = (f"halo copies across {min(cards, n)} cards" if cards > 1
              else "cross-card halo copies: not exercised (one card)")
    log(f"{name}: {n} stripes of {sh} rows from one thread on {group}, {N} "
        f"frames (1 key + {n_p} P): payloads and recon over the coded frame "
        f"equal {ref['name']}'s, byte for byte; every frame striped "
        f"({recons.striped}); {across}")
    log(f"{name}: key {np.mean(eng.key_ms):.1f} ms, P {np.mean(eng.p_ms):.1f} "
        f"ms a frame (one device, {ref['name']}: key {ref['key_ms']:.1f} ms, P "
        f"{ref['p_ms']:.1f} ms), {N} frames in {wall:.3f} s = "
        f"{N / wall:.4f} fps | {card}")
    log(f"{name}: launches {launches}, per P-frame "
        f"{ {k: round(v / n_p, 2) for k, v in launches.items()} } (expected "
        f"{n} x (3 + 5) K1, {n} x 3 K2)")
    return {"launches": launches, "key_ms": np.mean(eng.key_ms),
            "p_ms": np.mean(eng.p_ms), "devices": group}


def _device_events(prof):
    """(device-busy ms, device launches, device rows) of a
    torch.profiler run."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows), rows)


def phase_profile(runs: dict) -> None:
    """One more P-frame per path run with golden on: its time with each
    in-loop filter stage (deblocking, CDEF, LR) bracketed by
    synchronizes, then the same frame under torch.profiler for the
    device-busy time and the launches, and each stage alone under the
    profiler on the inputs it had in that frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from av1tpu_torch.specav1 import loopfilter, torch_cdef, torch_lr
    stages = {"loop filter": (loopfilter, "deblock_frame"),
              "CDEF": (torch_cdef, "cdef_search_apply"),
              "LR": (torch_lr, "lr_search_apply")}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def submit(eng, frame):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng._submit(frame, 96, is_key=False, refresh=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    for name, r in runs.items():
        eng, frame = r["eng"], r["frame"]
        spent, calls, orig = {}, {}, {}
        for st, (mod, attr) in stages.items():
            orig[st] = getattr(mod, attr)

            def timed(*a, _st=st, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = orig[_st](*a, **k)
                torch.cuda.synchronize()
                spent[_st] = spent.get(_st, 0.0) + \
                    (time.perf_counter() - t) * 1e3
                calls[_st] = (a, k)
                return res

            setattr(mod, attr, timed)
        try:
            ms = min(submit(eng, frame) for _ in range(3))
        finally:
            for st, (mod, attr) in stages.items():
                setattr(mod, attr, orig[st])
        with profile(activities=acts) as prof:
            submit(eng, frame)
        busy, launches, rows = _device_events(prof)
        if not busy > 0:
            fail(f"{name}: the profiler saw no device time")
        parts = []
        for st in stages:
            if st not in calls:
                continue
            a, k = calls[st]
            with profile(activities=acts) as p2:
                orig[st](*a, **k)
                torch.cuda.synchronize()
            sb, sl, _ = _device_events(p2)
            parts.append(f"{st} {spent[st] / 3:.1f} ms ({sl} launches, "
                         f"device busy {sb:.2f} ms)")
        log(f"profile {name}: P-frame {ms:.1f} ms (best of 3), device busy "
            f"{busy:.2f} ms, idle share {1 - busy / ms:.3f}, {launches} "
            "device launches" + ("; of it " + ", ".join(parts) if parts
                                 else ""))
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:6]:
            log(f"profile {name}:   {e.self_device_time_total / 1e3:.3f} ms "
                f"x{e.count}  {e.key[:90]}")


def phase_conform(dev_name: str):
    """256x144 streams: the port's spec decoder == port recon; CPU bytes
    == GPU bytes.  A grainy golden-off clip, a clean golden one (key A,
    inter B, inter A; frame types pinned) that turns the loop filter on
    and must choose GOLDEN blocks, the grainy clip in the default config
    (golden, CDEF and LR on), whose filters must turn on, a clean drift at
    chunk=3, and a 256x256 drift at chunk=3 over 4 stripes."""
    import numpy as np

    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.spec_engine import SpecTorchEngine
    from av1tpu_torch.specav1 import decoder
    from av1tpu_torch.utils.cleansrc import clean_frame

    def run(device, kind):
        if kind == "clean":
            frames = [clean_frame(256, 144, 0, 0), clean_frame(256, 144, 5, 1),
                      clean_frame(256, 144, 1, 0)]
        else:
            rng = np.random.default_rng(3)
            frames = [grainy_frame(256, 144, i, rng) for i in range(4)]
        cfg = (TpuEncoderConfig(chunk=1) if kind == "default" else
               TpuEncoderConfig(chunk=1, golden=kind == "clean", cdef=False,
                                lr=False))
        eng = SpecTorchEngine(cfg, device=device)
        eng.start_stream()
        payloads, recons, n_golden, cdefs, lr_on = [], [], 0, [], 0
        for i, f in enumerate(frames):
            pend = eng._submit(f, 96, is_key=(i == 0))
            out = pend[11]
            if i:
                n_golden += int(out[14].sum())
            c, lrc = (out[16], out[17]) if i == 0 else (out[9], out[10])
            cdefs.append(c.tolist())
            lr_on += int((lrc >= 0).sum())
            recons.append(eng._ref)
            payloads.append(eng._finalize(pend)[0])
        return payloads, recons, n_golden, eng._gop_deblock, cdefs, lr_on

    what = {"grainy": "grainy, golden off",
            "clean": "clean, golden on, loop filter on",
            "default": "grainy, default config: golden, CDEF and LR on"}
    for kind in ("grainy", "clean", "default"):
        payloads, recons, n_golden, deblock, cdefs, lr_on = run(dev_name,
                                                                kind)
        if deblock != (kind == "clean") or \
                bool(n_golden) != (kind == "clean"):
            fail(f"conformance ({what[kind]}): deblock {deblock}, GOLDEN "
                 f"blocks {n_golden}")
        if (kind == "default") != (any(map(any, cdefs)) and lr_on > 0):
            fail(f"conformance ({what[kind]}): CDEF strengths {cdefs}, "
                 f"{lr_on} restoration units on")
        dec = decoder.decode_stream(payloads)
        if len(dec) != len(payloads):
            fail(f"spec decoder returned {len(dec)} frames")
        for i, (d, r) in enumerate(zip(dec, recons)):
            for pl in range(3):
                hh, ww = d[pl].shape
                if not np.array_equal(np.asarray(d[pl], np.int64),
                                      r[pl][:hh, :ww].astype(np.int64)):
                    fail(f"conformance ({what[kind]}): decoded frame {i} "
                         f"plane {pl} != port recon")
        log(f"conformance 256x144 ({what[kind]}): the port's spec decoder "
            "(av1tpu_torch.specav1.decoder) reproduces the port's recon "
            f"exactly, {len(payloads)} frames, {n_golden} GOLDEN blocks, "
            f"CDEF strengths {cdefs}, {lr_on} restoration units on")
        if run("cpu", kind)[0] != payloads:
            fail(f"conformance ({what[kind]}): CPU and GPU runs of the port "
                 "gave different streams")
        log(f"conformance 256x144 ({what[kind]}): CPU plain path and GPU "
            "kernels give byte-identical streams")

    # chunked dispatch: the clean drift in the default config at chunk=3
    # (key, one chunk of 3 through the packed upload, a remainder of 1)
    from av1tpu_torch.encoder import io_pack
    frames = [clean_frame(256, 144, t, 0) for t in range(5)]
    streams = {}
    real_pack = io_pack.pack_chunk
    for device in (dev_name, "cpu"):
        packs = []

        def pack_spy(*a, **k):
            res = real_pack(*a, **k)
            packs.append(res is not None)
            return res

        eng = SpecTorchEngine(TpuEncoderConfig(chunk=3), device=device)
        io_pack.pack_chunk = pack_spy
        try:
            with capture_recons() as recons:
                out = list(eng.encode_stream(frames, 96))
        finally:
            io_pack.pack_chunk = real_pack
        if packs != [True] or [k for _, k in out] != [True] + [False] * 4:
            fail(f"conformance (chunk=3, {device}): packed uploads {packs}, "
                 f"frame types {[k for _, k in out]}")
        streams[device] = [p for p, _ in out]
        if device == dev_name:
            err = _decode_mismatch(streams[device], [
                tuple(p.cpu().numpy() for p in r) for r in recons])
            if err:
                fail(f"conformance (chunk=3): {err}")
    if streams[dev_name] != streams["cpu"]:
        fail("conformance (chunk=3): CPU and GPU runs of the port gave "
             "different streams")
    log("conformance 256x144 (clean, default config at chunk=3: key, a "
        "packed chunk of 3, a remainder of 1): the port's spec decoder "
        "reproduces the recon of all 5 frames, and the CPU plain path and "
        "the GPU kernels give byte-identical streams")

    # stripes: a clean 256x256 drift at chunk=3 over 4 stripes of 64 rows
    # (the 256-row key has one tile row, so it stays on one device)
    frames = [clean_frame(256, 256, t, 0) for t in range(5)]
    streams = {}
    for device, n in ((dev_name, 1), (dev_name, 4), ("cpu", 4)):
        eng = SpecTorchEngine(TpuEncoderConfig(chunk=3), device=device,
                              stripe_devices=(device,) * n)
        with capture_recons() as recons:
            out = list(eng.encode_stream(frames, 96))
        if recons.striped != {"key": 0, "inter": 4 if n > 1 else 0}:
            fail(f"conformance (256x256, {n} stripes, {device}): "
                 f"{recons.striped} striped")
        streams[device, n] = [p for p, _ in out]
        if (device, n) == (dev_name, 4):
            err = _decode_mismatch(streams[device, n], [
                tuple(p.cpu().numpy() for p in r) for r in recons])
            if err:
                fail(f"conformance (256x256, 4 stripes): {err}")
    if not (streams[dev_name, 4] == streams["cpu", 4] == streams[dev_name, 1]):
        fail("conformance (256x256, 4 stripes): the GPU and CPU striped "
             "streams and the GPU one-device stream are not all equal")
    log("conformance 256x256 (clean, default config at chunk=3, 4 stripes on "
        "each P-frame): the port's spec decoder reproduces the recon of all 5 "
        "frames, and the CPU plain path and the GPU kernels give the "
        "one-device stream byte for byte")


def conform_legacy(dev_name: str) -> None:
    """A 320x192 private-profile key + 3 P at chunk=3 (a key, one chunk
    of 3): the card's bytes equal the CPU's and the port's legacy
    decoder reproduces the card's recon."""
    from av1tpu_torch.config import TpuEncoderConfig
    from av1tpu_torch.utils.testsrc import testsrc2
    frames = [testsrc2(320, 192, i) for i in range(4)]
    cfg = TpuEncoderConfig(bitstream="av1tpu", chunk=3)
    r = run_legacy("conform-legacy-320x192", frames, cfg, dev_name)
    if [row[0] for row in r["eng"].rows] != ["key"] + ["chunk"] * 3:
        fail(f"conformance (legacy): dispatches {r['eng'].rows}")
    host = [tuple(p.cpu().numpy() for p in rec) for rec in r["recons"]]
    err = _legacy_mismatch(r["payloads"], host, 320, 192)
    if err:
        fail(f"conformance (legacy): {err}")
    from av1tpu_torch.legacy.engine import LegacyTorchEngine
    cpu = [p for p, _ in LegacyTorchEngine(cfg, device="cpu").encode_stream(
        frames, 96)]
    if cpu != r["payloads"]:
        fail("conformance (legacy): CPU and GPU runs of the port gave "
             "different streams")
    log("conformance 320x192 (private av1tpu profile, chunk=3: a key and "
        "a chunk of 3): the port's legacy decoder reproduces the recon of "
        "all 4 frames, and the CPU plain path and the GPU kernels give "
        "byte-identical streams")


# the stripe functions' frame: 1920x1088 (1080 rows are not a multiple of
# 16 x the stripe count), 16-px blocks, over 2 and 4 stripes on one card
MESH_W, MESH_H = 1920, 1088


def _mesh_planes(frames, dev):
    """(y, u, v) of the current frame and of the reference as int32
    tensors on ``dev``."""
    import torch
    return [torch.as_tensor(p.astype("int32"), device=dev)
            for f in frames[::-1] for p in (f.y, f.u, f.v)]


def _mesh_pads(ry, ru, rv):
    from av1tpu_torch.encoder.kernels import motion
    from av1tpu_torch.encoder.kernels.restoration import edge_pad
    return (motion.pad_ref(ry), edge_pad(ru, motion.CHROMA_PAD,
                                         motion.CHROMA_PAD),
            edge_pad(rv, motion.CHROMA_PAD, motion.CHROMA_PAD))


def _same(a, b) -> bool:
    """Two output tuples equal element by element (tensors on any device,
    ints, bools)."""
    import torch
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        tx, ty = (torch.as_tensor(t).cpu().to(torch.int64) for t in (x, y))
        if tx.shape != ty.shape or not torch.equal(tx, ty):
            return False
    return True


def _mesh_run(name, fn, counts=None):
    """fn() between synchronizes, the launch counts set to 0 just before
    and read just after; (result, ms, launches)."""
    import torch
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    if counts is not None:
        counts[name] = launches
    return out, ms, launches


def phase_mesh(dev_name: str, card: str) -> dict:
    """The private profile's stripe functions (legacy/mesh_sharding.py)
    and the v1 P-frame they run, on the card:
    mesh-v1-1088p     a grainy 1920x1088 P-frame (16-px blocks) through
                      inter_frame.encode_inter_frame: K1 7 (2 region
                      gathers at W=32, 4 block gathers at W=16, U+V at
                      W=8) and K2 2; decode_inter_frame gives its recon
    mesh-*-1088p/n    encode_inter_frame_sharded (v1),
                      encode_inter_frame_sharded_v2 and
                      encode_key_frame_sharded_v2 over n = 2 and 4
                      stripes, every stripe on this card: each equal to
                      its one-device function (v1; v2 with tile_rows=n)
    mesh-512x64       the v1 frame and the three stripe functions over 8
                      stripes at 512x64: the card's outputs equal the CPU's
    Across two cards where the machine has them.  Returns the launch
    counts of the paths that launch K1 and K2."""
    import numpy as np
    import torch

    from av1tpu_torch.encoder import quant
    from av1tpu_torch.legacy import mesh_sharding as M
    from av1tpu_torch.legacy.core import inter_frame as IF
    from av1tpu_torch.legacy.core import intra_frame as KF
    from av1tpu_torch.utils.testsrc import testsrc2
    t0 = time.perf_counter()
    dev = torch.device(dev_name)
    q = 96
    dc, ac = quant.dc_q(q), quant.ac_q(q)
    counts = {}
    rng = np.random.default_rng(11)
    frames = [grainy_frame(MESH_W, MESH_H, i, rng) for i in range(2)]
    cur_ref = _mesh_planes(frames, dev)
    pads = _mesh_pads(*cur_ref[3:])

    def v1():
        return IF.encode_inter_frame(*cur_ref[:3], *pads, dc, ac, 16)
    v1()                                     # first call: warm-up
    one_v1, ms, launches = _mesh_run("mesh-v1-1088p", v1, counts)
    if launches != {"gather_windows": 7, "gather_windows2": 0,
                    "refine_ssd": 2}:
        fail(f"mesh-v1-1088p: launches {launches}, expected K1 7 (2 at W=32, "
             "4 at W=16, U+V at W=8) and K2 2")
    mvs = one_v1[0]
    dec = IF.decode_inter_frame(*one_v1[:4], *pads, dc, ac, MESH_H, MESH_W, 16)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(dec, one_v1[4:])):
        fail("mesh-v1-1088p: decode_inter_frame differs from the encoder's "
             "recon")
    mse = float(((one_v1[4].double() - cur_ref[0].double()) ** 2).mean())
    log(f"mesh-v1-1088p: v1 P-frame {MESH_W}x{MESH_H} n=16 q{q}: {ms:.1f} ms, "
        f"launches {launches}, {int((mvs != 0).any(1).sum())} of "
        f"{mvs.shape[0]} blocks moved, Y-PSNR "
        f"{10 * np.log10(255.0 ** 2 / mse):.3f} dB, decode = recon | {card}")

    y8 = [torch.as_tensor(p, device=dev) for f in frames[::-1]
          for p in (f.y, f.u, f.v)]
    for n in (2, 4):
        group = (dev,) * n
        tag = f"1088p/{n}"
        sh_v1, ms_s, l1 = _mesh_run(f"mesh-v1-{tag}", lambda: (
            M.encode_inter_frame_sharded(*cur_ref, dc, ac, 16, group)),
            counts)
        if not _same(sh_v1[:7], one_v1) or \
                l1["gather_windows"] != 7 * n or l1["refine_ssd"] != 2 * n:
            fail(f"mesh-v1-{tag}: striped v1 differs from one device or "
                 f"launches {l1} (expected K1 {7 * n}, K2 {2 * n})")
        one_p, ms_p1, _ = _mesh_run("", lambda: IF.encode_inter_frame_v2(
            *y8, dc, ac, q, 16, 8, n))
        sh_p, ms_p, lp = _mesh_run(f"mesh-p-{tag}", lambda: (
            M.encode_inter_frame_sharded_v2(*y8, dc, ac, q, 16, group)),
            counts)
        want = [one_p[i] for i in range(10)] + [one_p[14]]
        if not _same(sh_p, want) or lp["gather_windows"] != 2 * n or \
                lp["refine_ssd"] != 2 * n:
            fail(f"mesh-p-{tag}: striped v2 P-frame differs from "
                 f"encode_inter_frame_v2(tile_rows={n}) or launches {lp} "
                 f"(expected K1 {2 * n}, K2 {2 * n})")
        one_k, ms_k1, _ = _mesh_run("", lambda: KF.encode_key_frame_v2(
            *y8[:3], dc, ac, q, 16, 8, n))
        sh_k, ms_k, lk = _mesh_run("", lambda: (
            M.encode_key_frame_sharded_v2(*y8[:3], dc, ac, q, 16, group)))
        want = [one_k[i] for i in range(10)] + [one_k[13]]
        if not _same(sh_k, want):
            fail(f"mesh-key-{tag}: striped keyframe differs from "
                 f"encode_key_frame_v2(tile_rows={n})")
        log(f"mesh-{tag}: {n} stripes on one card equal one device: v1 P "
            f"{ms_s:.1f} ms (one device {ms:.1f}), v2 P {ms_p:.1f} ms (one "
            f"device {ms_p1:.1f}; lr_mode {sh_p[8]}, cdef_on "
            f"{bool(sh_p[9])}), key {ms_k:.1f} ms (one device {ms_k1:.1f}; "
            f"lr_mode {sh_k[8]}, cdef_on {bool(sh_k[9])}); launches v1 {l1}, "
            f"v2 P {lp}, key {lk} | {card}")

    # card = CPU at the CPU tests' shape
    small = [testsrc2(64, 512, i) for i in range(2)]
    for where in ("cuda", "cpu"):
        d = torch.device(dev_name if where == "cuda" else "cpu")
        cr = _mesh_planes(small, d)
        p8 = [torch.as_tensor(p, device=d) for f in small[::-1]
              for p in (f.y, f.u, f.v)]
        g = (d,) * 8
        res = (IF.encode_inter_frame(*cr[:3], *_mesh_pads(*cr[3:]), dc, ac,
                                     16),
               M.encode_inter_frame_sharded(*cr, dc, ac, 16, g),
               M.encode_inter_frame_sharded_v2(*p8, dc, ac, q, 16, g),
               M.encode_key_frame_sharded_v2(*p8[:3], dc, ac, q, 16, g))
        if where == "cuda":
            card_res = res
    if not all(_same(a, b) for a, b in zip(card_res, res)):
        fail("mesh-512x64: the card's outputs differ from the CPU's")
    log("mesh-512x64: the v1 frame and the three stripe functions over 8 "
        "stripes give the CPU's outputs on the card")

    if torch.cuda.device_count() >= 2:
        two = (torch.device("cuda", 0), torch.device("cuda", 1)) * 2
        sh2 = M.encode_inter_frame_sharded_v2(*y8, dc, ac, q, 16, two)
        if not _same(sh2, M.encode_inter_frame_sharded_v2(
                *y8, dc, ac, q, 16, (dev,) * 4)):
            fail("mesh: 4 stripes across two cards differ from one card")
        log("mesh: 4 stripes alternating two cards equal one card")
    else:
        log("mesh: one card visible; stripes across cards not run")
    log(f"mesh: phase {time.perf_counter() - t0:.1f} s | {card}")
    return counts


# the dist phase's cells: the one-device cell each must equal, its
# config (TpuEncoderConfig's keywords), its clip, its rank count
DIST_CELLS = {
    "dist-1080p-chunk8": ("slice-1080p-chunk8", {}, grain_clip, 2),
    "dist-720p-default": ("slice-720p-default", {"chunk": 1},
                          clean_clip_720p, 4)}
# a dist cell's ranks must end within this long (they are killed after)
DIST_LIMIT_S = 300


def recon_digests(recons, h: int, w: int) -> list:
    """SHA-256 of each recon plane over the coded frame (int16 bytes)."""
    import hashlib
    return [[hashlib.sha256(p[:hh, :ww].contiguous().cpu().numpy()
                            .tobytes()).hexdigest()
             for p, (hh, ww) in zip(fr, ((h, w), (h // 2, w // 2),
                                         (h // 2, w // 2)))]
            for fr in recons]


def dist_rank(name: str, backend: str, work: str) -> int:
    """One rank of a dist cell, in a process of its own (``chip_smoke.py
    --dist-rank NAME BACKEND DIR`` with the AV1TPU_* variables set): the
    process group joined through the port's init function with
    ``backend`` given explicitly, the daemon's engine from make_engine on
    this rank's card with its self-test (a 320x192 key, which does not
    stripe: the warm-up every daemon rank makes), then, from a fresh
    stream as the daemon starts each file, the cell's clip
    through encode_stream with the launch counts set to 0 just before
    and read just after, each dispatch timed (``time_dispatches``) and
    each collective of the stripe transport bracketed by CUDA events on
    the rank's stream and by the host clock.  Writes what it saw to
    DIR/rank<r>.pkl."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from av1tpu_torch.config import TpuEncoderConfig, TranscodeConfig
    from av1tpu_torch.daemon import engine as engine_mod
    from av1tpu_torch.encoder.mesh import distributed
    from av1tpu_torch.specav1 import stripes
    t_start = time.perf_counter()
    distributed.maybe_initialize("cuda", backend=backend)
    _, cfg, clip, _ = DIST_CELLS[name]
    frames = clip()
    eng = engine_mod.make_engine(TranscodeConfig(
        tpu=TpuEncoderConfig(**cfg)))
    engine_mod.verify_engine(eng, "320x192")
    eng.start_stream()  # as the daemon's transcode starts each file
    time_dispatches(eng)
    real_exchange = stripes._exchange
    coll = {"events": [], "host_ms": 0.0, "bytes": 0}

    def timed_exchange(tensors):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t = time.perf_counter()
        ev[0].record()
        out = real_exchange(tensors)
        ev[1].record()
        coll["host_ms"] += (time.perf_counter() - t) * 1e3
        coll["events"].append(ev)
        coll["bytes"] += sum(x.numel() * x.element_size() for x in tensors)
        return out

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    stripes._exchange = timed_exchange
    torch.cuda.synchronize()
    ready = time.perf_counter() - t_start
    try:
        with capture_recons() as recons:
            t0 = time.perf_counter()
            out = list(eng.encode_stream(frames, 96))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        stripes._exchange = real_exchange
    res = {"rank": distributed.rank(), "world": distributed.world_size(),
           "backend": dist.get_backend(), "device": str(eng.device),
           "stripes": len(eng._group), "payloads": [p for p, _ in out],
           "striped": dict(recons.striped),
           "digests": recon_digests(recons, frames[0].height,
                                    frames[0].width),
           "launches": {k: fn.launches for k, fn in counters.items()},
           "key_ms": float(np.mean(eng.key_ms)),
           "p_ms": float(np.mean(eng.p_ms)), "wall": wall, "ready": ready,
           "coll_ms": [a.elapsed_time(b) for a, b in coll["events"]],
           "coll_host_ms": coll["host_ms"], "coll_bytes": coll["bytes"]}
    path = os.path.join(work, f"rank{res['rank']}.pkl")
    with open(path, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


def run_dist_cell(name: str, n: int, backend: str, card: str, refs: dict,
                  threads: dict) -> dict:
    """n rank processes of ``name`` (``dist_rank``) on 127.0.0.1 at a free
    port, each with AV1TPU_COORDINATOR, AV1TPU_NUM_PROCESSES and
    AV1TPU_PROCESS_ID set as a user sets them for the daemon's ranks.
    The first rank to fail fails the phase (the others are killed), as
    does a run past DIST_LIMIT_S.  Every rank's payloads must equal the
    one-device cell's, its recons over the coded frame too (by digest),
    every frame striped over the n ranks, and its K1 / K2 launches must
    be one stripe's share: 3 + 5 and 3 a P-frame.  Prints each rank's key
    and P ms and fps, beside the one-device cell's and the one-thread
    stripe cell's (``phase_stripes``), and its collectives' time.
    Returns rank 0's launch counts."""
    import pickle
    import socket
    import tempfile

    import torch
    ref_name, _, _, _ = DIST_CELLS[name]
    ref = refs[ref_name]
    frames = ref["frames"]
    H, W = frames[0].height, frames[0].width
    n_p = len(frames) - 1
    want = recon_digests(ref["recons"], H, W)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="av1torch-dist-")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, AV1TPU_COORDINATOR=f"127.0.0.1:{port}",
               AV1TPU_NUM_PROCESSES=str(n))
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(n)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", name,
         backend, work], cwd=HERE, env=dict(env, AV1TPU_PROCESS_ID=str(r)),
        stdout=fh, stderr=subprocess.STDOUT) for r, fh in enumerate(logs)]
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            late = time.perf_counter() - t0 > DIST_LIMIT_S
            if bad or late:
                r = bad[0] if bad else 0
                logs[r].seek(0)
                fail(f"{name}: rank {r} of {n} "
                     + (f"exited with {procs[r].returncode}" if bad else
                        f"still running after {DIST_LIMIT_S} s")
                     + ":\n" + logs[r].read()[-6000:])
            time.sleep(0.1)
        phase_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode:
                logs[r].seek(0)
                fail(f"{name}: rank {r} exited with {p.returncode}:\n"
                     + logs[r].read()[-6000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    res = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(work)
    one = threads.get(ref_name)
    for x in res:
        r = x["rank"]
        if (x["world"], x["backend"], x["stripes"]) != (n, backend, n):
            fail(f"{name}: rank {r}: world {x['world']}, backend "
                 f"{x['backend']}, {x['stripes']} stripes")
        if x["payloads"] != ref["payloads"]:
            bad = [i for i, (a, b) in enumerate(zip(x["payloads"],
                                                    ref["payloads"]))
                   if a != b]
            fail(f"{name}: rank {r}'s payloads differ from {ref_name}'s at "
                 f"frames {bad} of {len(frames)}")
        if x["digests"] != want:
            fail(f"{name}: rank {r}'s recons differ from {ref_name}'s")
        if x["striped"] != {"key": 1, "inter": n_p}:
            fail(f"{name}: rank {r} striped {x['striped']} of "
                 f"{len(frames)} frames")
        need_k1_launches(f"{name} rank {r}", x["launches"], n_p, 3, 5)
        if x["launches"]["refine_ssd"] != 3 * n_p:
            fail(f"{name}: rank {r}: K2 launches "
                 f"{x['launches']['refine_ssd']} over {n_p} P-frames, "
                 "expected one stripe's 3 a frame")
    devices = [x["device"] for x in res]
    if backend == "nccl" and len(set(devices)) != n:
        fail(f"{name}: ranks on {devices}: NCCL needs one card a rank")
    log(f"{name}: {n} ranks ({backend}) on {devices}, {len(frames)} frames "
        f"(1 key + {n_p} P): every rank's payloads and recon over the coded "
        f"frame equal {ref_name}'s, byte for byte; every frame striped over "
        f"the ranks; K1 3 + 5 and K2 3 launches a P-frame on each rank (one "
        f"stripe's share); {phase_s:.1f} s from the first rank's start to "
        "the last rank's end")
    for x in res:
        # the key's gather is the first collective (the communicator is
        # set up in it); each P-frame then makes two, its halos and its
        # outputs' gather
        first, rest = x["coll_ms"][0], x["coll_ms"][1:]
        log(f"{name}: rank {x['rank']} on {x['device']}: key "
            f"{x['key_ms']:.1f} ms, P {x['p_ms']:.1f} ms a frame, "
            f"{len(frames)} frames in {x['wall']:.3f} s = "
            f"{len(frames) / x['wall']:.4f} fps (engine ready "
            f"{x['ready']:.1f} s after the rank's start); collectives "
            f"(CUDA events around each on the rank's stream: transfer and "
            f"waiting for the other ranks): {len(x['coll_ms'])} exchanges of "
            f"{x['coll_bytes'] / 2 ** 20:.1f} MiB, {sum(x['coll_ms']):.1f} ms "
            f"({x['coll_host_ms']:.1f} ms on the host): the key's gather "
            f"{first:.1f} ms, the P-frames' {len(rest)} {sum(rest):.1f} ms = "
            f"{sum(rest) / n_p:.2f} ms a P-frame (max {max(rest):.2f} ms "
            f"an exchange), {sum(rest) / n_p / x['p_ms']:.1%} of its P ms "
            f"| {card}")
    log(f"{name}: one device ({ref_name}): key {ref['key_ms']:.1f} ms, P "
        f"{ref['p_ms']:.1f} ms a frame"
        + (f"; {one['n']} stripes from one thread on {one['devices']} "
           f"({one['name']}): key {one['key_ms']:.1f} ms, P "
           f"{one['p_ms']:.1f} ms a frame" if one else "")
        + f" | {card}")
    return res[0]["launches"]


def phase_dist(card: str, refs: dict, threads: dict) -> dict:
    """Stripes over processes: the AV1TPU_* process group, one stripe a
    rank (``run_dist_cell``).  With two or more cards, NCCL, one card a
    rank: dist-1080p-chunk8 (slice-1080p-chunk8's frames in
    TpuEncoderConfig(), num_chips 0 = every rank) over 2 ranks and, with
    four cards, dist-720p-default (slice-720p-default's clip) over 4.
    With one card NCCL cannot hold two ranks on it, so two ranks share it
    over gloo, which carries the card tensors through the host.  Returns
    the cells' launch counts."""
    import torch
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    cells = [("dist-1080p-chunk8", 2)]
    if cards >= 4:
        cells.append(("dist-720p-default", 4))
    print(f"dist backend: {backend}, ranks "
          f"{' and '.join(str(n) for _, n in cells)}, {cards} card(s)",
          flush=True)
    if backend == "gloo":
        log("dist: one card: two ranks share it over gloo (NCCL refuses two "
            "ranks on one card); collectives between cards over NCCL, and "
            "dist-720p-default over 4 ranks, need more cards and are not "
            "run here")
    elif cards < 4:
        log(f"dist: {cards} cards: dist-720p-default over 4 ranks needs 4 "
            "cards and is not run here")
    return {name: run_dist_cell(name, n, backend, card, refs, threads)
            for name, n in cells}


def source_decoders() -> str:
    """Which source decoders this machine has: the system's libavcodec
    (``ldconfig -p``), the port's native decoder built on it, and cv2."""
    import importlib.util

    from av1tpu_torch.media import avdec
    try:
        res = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True, timeout=60)
        libs = sorted({ln.split()[0] for ln in res.stdout.splitlines()
                       if "avcodec" in ln})
    except OSError as e:
        libs = [f"ldconfig failed: {e}"]
    return (f"libavcodec {libs or 'none'}, the port's native decoder "
            f"{'available' if avdec.available() else 'unavailable'}, cv2 "
            f"{'importable' if importlib.util.find_spec('cv2') else 'absent'}")


def phase_daemon(card: str) -> dict:
    """daemon-1080p: one pass of the port's daemon, run_once(cfg) with
    engine=None, exactly as ``python3 -m av1tpu_torch.daemon.main``
    runs it: the engine is built on the card and passes its 1280x720
    self-test, then the library is scanned, the file probed and
    classified, its job written, transcoded in TpuEncoderConfig()
    (chunk=8, delta_upload, golden, CDEF, LR), size-gated,
    decode-verified and atomically replaced.  The library holds one file:
    the 9 grainy 1920x1080 frames of slice-1080p-chunk8 as a y4m stream
    named clip.mkv (the scan filters by extension; probe and source
    decode dispatch on the y4m magic, the one source the daemon decodes
    on a machine without cv2 or libavcodec).  The launch counts are set
    to 0 just before the pass and read just after.  Its directory (the
    library and the job directory) stays for the ops phase; ``main``
    removes it at the end."""
    import logging
    import tempfile

    import torch

    from av1tpu_torch import config, jobs
    from av1tpu_torch.daemon import core
    from av1tpu_torch.daemon import engine as engine_mod
    from av1tpu_torch.daemon import main as daemon_main
    from av1tpu_torch.encoder import io_pack
    from av1tpu_torch.media import mkv, y4m
    name = "daemon-1080p"
    W, H, _ = SIZES["1080p"]
    frames = grain_clip()
    root = tempfile.mkdtemp(prefix="av1torch-daemon-")
    lib = os.path.join(root, "library")
    os.makedirs(lib)
    src = os.path.join(lib, "clip.mkv")
    y4m.write(src, [(f.y, f.u, f.v) for f in frames])
    orig = os.path.getsize(src)
    log(f"{name}: source decoders on this machine: {source_decoders()}")
    log(f"{name}: library {lib}: clip.mkv, a y4m stream of {len(frames)} "
        f"grainy {W}x{H} frames, {orig} bytes")
    cfg = config.default_config()
    cfg.library_roots = [lib]
    cfg.min_bytes = 1000
    cfg.job_state_dir = os.path.join(root, "jobs")
    if cfg.tpu != config.TpuEncoderConfig():
        fail(f"{name}: the tpu section is not the default: {cfg.tpu}")

    seen = {"engines": [], "selftest": [], "verify": [], "payloads": [],
            "packs": [], "transcode": []}
    real = {"make": engine_mod.make_engine, "self": engine_mod.verify_engine,
            "verify": core.verify_output_av1, "pack": io_pack.pack_chunk}

    def make_spy(*a, **k):
        eng = real["make"](*a, **k)
        seen["engines"].append(eng)
        stream, transcode = eng.encode_stream, eng.transcode

        def encode_stream(*sa, **sk):
            for payload, key in stream(*sa, **sk):
                seen["payloads"].append(payload)
                yield payload, key

        def timed_transcode(*ta, **tk):
            seen["first_recon"] = len(recons)
            torch.cuda.synchronize()
            t = time.perf_counter()
            transcode(*ta, **tk)
            torch.cuda.synchronize()
            seen["transcode"].append(time.perf_counter() - t)

        eng.encode_stream, eng.transcode = encode_stream, timed_transcode
        return eng

    def selftest_spy(eng, size="1280x720"):
        try:
            dt = real["self"](eng, size)
        except Exception as e:
            seen["selftest"].append(e)
            raise
        seen["selftest"].append(dt)
        return dt

    def verify_spy(path, *a, **k):
        res = real["verify"](path, *a, **k)
        seen["verify"].append(res)
        return res

    def pack_spy(*a, **k):
        res = real["pack"](*a, **k)
        seen["packs"].append(res is not None)
        return res

    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(f"{name}: [%(name)s] %(message)s"))
    pkg_log = logging.getLogger("av1tpu_torch")
    pkg_log.addHandler(handler)
    pkg_log.setLevel(logging.INFO)
    counters = _counters()
    engine_mod.make_engine, engine_mod.verify_engine = make_spy, selftest_spy
    core.verify_output_av1, io_pack.pack_chunk = verify_spy, pack_spy
    try:
        with capture_recons() as recons:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = daemon_main.run_once(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        engine_mod.make_engine, engine_mod.verify_engine = real["make"], \
            real["self"]
        core.verify_output_av1, io_pack.pack_chunk = real["verify"], \
            real["pack"]
        pkg_log.removeHandler(handler)
    if len(seen["engines"]) != 1:
        fail(f"{name}: {len(seen['engines'])} engines built")
    eng = seen["engines"][0]
    if eng.device.type != "cuda":
        fail(f"{name}: the daemon's engine runs on {eng.device}")
    if len(seen["selftest"]) != 1 or not isinstance(seen["selftest"][0],
                                                     float):
        fail(f"{name}: self-test {seen['selftest']}")
    if result.candidates != [src]:
        fail(f"{name}: scan candidates {result.candidates}, skipped "
             f"{[(s.path, s.reason) for s in result.skipped]}")
    found = jobs.load_all_jobs(cfg.job_state_dir)
    if len(found) != 1:
        fail(f"{name}: {len(found)} job records")
    job = found[0]
    if job.status != jobs.STATUS_SUCCESS or job.encoded_frames != 9:
        fail(f"{name}: job {job.status} ({job.reason!r}), "
             f"{job.encoded_frames} frames encoded")
    size = os.path.getsize(src)
    with open(src, "rb") as f:
        magic = f.read(4)
    if magic != b"\x1a\x45\xdf\xa3" or size != job.new_bytes:
        fail(f"{name}: clip.mkv begins {magic!r}, {size} bytes, the job "
             f"says {job.new_bytes}")
    with open(src, "rb") as f:
        m = mkv.parse(f)
        video = [t for t in m.tracks if t.codec_id == "V_AV1"]
        if len(video) != 1:
            fail(f"{name}: tracks {[t.codec_id for t in m.tracks]}")
        muxed = [bytes(p.data) for p in mkv.iter_packets(f, m)
                 if p.track_number == video[0].number]
    if muxed != seen["payloads"] or len(muxed) != 9:
        fail(f"{name}: {len(muxed)} muxed video payloads differ from the "
             f"{len(seen['payloads'])} that encode_stream yielded")
    n_p = len(muxed) - 1
    need_launches(name, launches,
                  ("gather_windows", "gather_windows2", "refine_ssd"))
    need_k1_launches(name, launches, n_p, 3, 5)
    if launches["refine_ssd"] != 3 * n_p:
        fail(f"{name}: K2 launches {launches['refine_ssd']} over {n_p} "
             "P-frames, expected 3 a frame")
    stream_recons = recons[seen["first_recon"]:]
    decode_async(name, muxed, stream_recons, f"all {len(muxed)} frames of "
                 "the replaced file")
    ok, why = seen["verify"][0] if len(seen["verify"]) == 1 else (False, "?")
    if not ok:
        fail(f"{name}: decode-verify {seen['verify']}")
    verdict = ("libaom decoded the leading packets" if why.startswith(
        "decoded") else "no independent decoder (libaom absent): "
        "soft pass")
    log(f"{name}: job success, 9 frames, clip.mkv replaced by Matroska "
        f"({size} bytes, its V_AV1 payloads are encode_stream's); "
        f"decode-verify: {verdict} ({why})")
    log(f"{name}: self-test {seen['selftest'][0]:.3f} s "
        f"({cfg.tpu.self_test_size} key) | "
        f"{card}")
    log(f"{name}: transcode wall {seen['transcode'][0]:.3f} s, run_once "
        f"wall {wall:.3f} s (scan, self-test, 10 s stability wait, "
        f"transcode, gate, verify, replace) | {card}")
    log(f"{name}: job encode_fps {job.encode_fps:.4f} | {card}")
    log(f"{name}: size ratio {size / orig:.6f} ({size} / {orig} bytes) | "
        f"{card}")
    log(f"{name}: chunk uploads "
        f"{['packed' if x else 'raw' for x in seen['packs']]} | {card}")
    log(f"{name}: launches {launches}, per P-frame "
        f"{ {k: round(v / n_p, 2) for k, v in launches.items()} }")
    # the private profile: make_engine builds LegacyTorchEngine on the card
    # and its self-test encodes the 1280x720 key there
    from av1tpu_torch.legacy.engine import LegacyTorchEngine
    lcfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, bitstream="av1tpu"))
    leng = engine_mod.make_engine(lcfg)
    if not isinstance(leng, LegacyTorchEngine) or \
            leng.device.type != "cuda":
        fail(f"{name}: make_engine with bitstream 'av1tpu' built "
             f"{type(leng).__name__} on {getattr(leng, 'device', '?')}")
    torch.cuda.synchronize()
    dt = engine_mod.verify_engine(leng, lcfg.tpu.self_test_size)
    torch.cuda.synchronize()
    log(f"{name}: make_engine with tpu.bitstream 'av1tpu' built "
        f"LegacyTorchEngine on {leng.device}; its self-test "
        f"({lcfg.tpu.self_test_size} key) {dt:.3f} s | {card}")
    return {"launches": launches, "payloads": muxed, "cfg": cfg,
            "root": root, "job": job}



def _captured(fn, *args):
    """(return value, stdout lines) of fn(*args)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rv = fn(*args)
    return rv, buf.getvalue().splitlines()


def _clip_job(ivf_path: str, recons, y4m_path: str, want_psnr: float):
    """In a decode worker: the port's legacy decoder on encode_clip's IVF
    (the private av1tpu profile) must reproduce every recon; then
    ``quality --frames 1`` on the IVF against the source y4m must give
    recon 0's Y-PSNR."""
    import numpy as np

    from av1tpu_torch.legacy import decoder
    from av1tpu_torch.tools import quality
    t = time.perf_counter()
    frames = decoder.decode_ivf(ivf_path, device="cpu")
    err = None if len(frames) == len(recons) else \
        f"legacy decoder gave {len(frames)} frames for {len(recons)}"
    for i, (fr, rec) in enumerate(zip(frames, recons)):
        for pl, got in enumerate((fr.y, fr.u, fr.v)):
            hh, ww = got.shape
            if err is None and not np.array_equal(
                    got.astype(np.int64), rec[pl][:hh, :ww].astype(np.int64)):
                err = f"legacy-decoded frame {i} plane {pl} != port recon"
    rc, out = _captured(quality.main, ["--ref", y4m_path, "--dist", ivf_path,
                                       "--frames", "1", "--cpu"])
    res = json.loads(out[-1]) if rc == 0 and out else {}
    if err is None and (res.get("frames") != 1
                        or res.get("y_psnr") != want_psnr):
        err = (f"quality --frames 1 gave rc {rc}, {out}; recon 0's Y-PSNR "
               f"is {want_psnr}")
    return err, time.perf_counter() - t, f"quality --frames 1: {out[-1:]}"


def phase_ops(card: str, daemon: dict) -> dict:
    """ops: the operator surfaces on the card, over the daemon phase's
    config (written to a file, as a user passes it) and job directory.
    The doctor, av1top's reader in a process of its own (the size of
    the CUDA context that mem_get_info opens there), av1top --once, and
    encode_clip at 1920x1080 (the private av1tpu profile,
    LegacyTorchEngine.encode_next) with the launch counts set to 0 just
    before and read just after; its stream's decode by the legacy
    decoder and quality's Y-PSNR are checked in a decode worker."""
    import numpy as np
    import torch

    from av1tpu_torch import engine as engine_mod
    from av1tpu_torch.media import ivf, y4m
    from av1tpu_torch.tools import doctor, encode_clip, quality
    from av1tpu_torch.tui import main as tui_main
    from av1tpu_torch.tui import view
    from av1tpu_torch.utils.testsrc import testsrc2
    name = "ops"
    root, job = daemon["root"], daemon["job"]
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(daemon["cfg"].to_dict(), f)
    card_name = torch.cuda.get_device_name(0)

    rc, out = _captured(doctor.main, [cfg_path])
    for line in out:
        log(f"{name}: doctor: {line}")
    accel = [ln for ln in out if "] accelerator:" in ln]
    smoke = [ln for ln in out if "] encode smoke:" in ln]
    if rc != 0 or out[-1] != "RESULT: healthy":
        fail(f"{name}: doctor exit {rc}, {out[-1:]}")
    if len(accel) != 1 or not accel[0].startswith("[OK  ]") or \
            card_name not in accel[0]:
        fail(f"{name}: doctor's accelerator line {accel}")
    m = re.search(r"keyframe on cuda:\d+, ([0-9.]+) s\)$",
                  smoke[0] if len(smoke) == 1 else "")
    if not m or not smoke[0].startswith("[OK  ]"):
        fail(f"{name}: doctor's encode smoke {smoke}")
    log(f"{name}: doctor encode smoke (320x192 key, kernels built) "
        f"{m.group(1)} s | {card}")

    # av1top's reader in a process of its own: card-wide used bytes
    # there, less this process's, is the CUDA context mem_get_info opens
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info(0)
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", "import json\n"
         "from av1tpu_torch.tui import metrics\n"
         "print(json.dumps(metrics.read_gpu()))"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t
    if res.returncode != 0:
        fail(f"{name}: av1top's reader in a process of its own: "
             f"{res.stdout}{res.stderr}")
    _, sub_name, _, sub_used, _ = json.loads(res.stdout.splitlines()[-1])
    ctx = sub_used * 1024 ** 3 - (total - free0)
    free1 = torch.cuda.mem_get_info(0)[0]
    if sub_name != card_name or ctx <= 0:
        fail(f"{name}: the dashboard's process read {sub_name!r}, a context "
             f"of {ctx} bytes")
    log(f"{name}: the dashboard's CUDA context (mem_get_info in a process "
        f"of its own): {ctx / 2 ** 20:.1f} MiB ({int(ctx)} bytes), released "
        f"at exit: {free1 == free0}; the reader's process took {secs:.1f} s "
        f"| {card}")

    rc, lines = _captured(tui_main.main, [cfg_path, "--once"])
    for line in lines:
        log(f"{name}: av1top --once | {line}")
    text = "\n".join(lines)
    gpu = [re.match(r"  GPU  \[[█░]+\] +([0-9.]+)%  MEM \(([0-9.]+)/"
                    r"([0-9.]+) GB\)  (\d+)x (.+)$", ln) for ln in lines]
    gpu = [g for g in gpu if g]
    want_total = f"{torch.cuda.mem_get_info(0)[1] / 1024 ** 3:.1f}"
    saved = view.humanize_bytes(job.original_bytes - job.new_bytes)
    if rc != 0 or len(gpu) != 1:
        fail(f"{name}: av1top --once exit {rc}, GPU lines {gpu}")
    used, tot, cnt, gname = (float(gpu[0].group(2)), gpu[0].group(3),
                             int(gpu[0].group(4)), gpu[0].group(5))
    if gname != card_name or tot != want_total or used <= 0 or \
            cnt != torch.cuda.device_count():
        fail(f"{name}: av1top's GPU line {gpu[0].group(0)!r}: the card is "
             f"{card_name!r} with {want_total} GB")
    if "success 1" not in text or f"total saved: {saved}" not in text or \
            not re.search(r"^  success +clip\.mkv ", text, re.M):
        fail(f"{name}: av1top does not show the daemon-1080p job as a "
             f"success saving {saved}")

    W, H, _ = SIZES["1080p"]
    ivf_path = os.path.join(root, "clip.ivf")
    real_next = engine_mod.TorchEngine.encode_next
    ms = []
    counters = _counters()
    recons = []

    def timed_next(eng, frame, qindex):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_next(eng, frame, qindex)
        torch.cuda.synchronize()
        ms.append(((time.perf_counter() - t) * 1e3, res[1]))
        recons.append(tuple(p.to(torch.int16) for p in eng._ref_dev))
        return res

    engine_mod.TorchEngine.encode_next = timed_next
    try:
        for fn in counters.values():
            fn.launches = 0
        rc, out = _captured(encode_clip.main, [
            "--width", str(W), "--height", str(H), "--frames", "4",
            "--out", ivf_path])
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        engine_mod.TorchEngine.encode_next = real_next
    for line in out:
        log(f"{name}: encode_clip: {line} | {card}")
    with open(ivf_path, "rb") as f:
        hdr = ivf.read_header(f)
        tus = [tu for tu, _ in ivf.iter_frames(f)]
    keys = [k for _, k in ms]
    if rc != 0 or len(tus) != 4 or keys != [True, False, False, False] or \
            (hdr["width"], hdr["height"]) != (W, H) or len(recons) != 4:
        fail(f"{name}: encode_clip exit {rc}, {len(tus)} TUs, frame types "
             f"{keys}, {len(recons)} recons, header {hdr}")
    # the private profile at speed 6, one reference: search_v3's K1 and
    # K2 twice a P-frame
    if launches != {"gather_windows": 6, "gather_windows2": 0,
                    "refine_ssd": 6}:
        fail(f"{name}: launches {launches} over 3 P-frames, expected K1 2 "
             "and K2 2 a frame")
    log(f"{name}: encode_clip {W}x{H}: key {ms[0][0]:.1f} ms, P "
        f"{np.mean([t for t, _ in ms[1:]]):.1f} ms (min "
        f"{min(t for t, _ in ms[1:]):.1f}), LegacyTorchEngine.encode_next "
        f"with host entropy, bracketed by synchronizes | {card}")
    log(f"{name}: launches {launches}, per P-frame "
        f"{ {k: round(v / 3, 2) for k, v in launches.items()} }")
    frames = [testsrc2(W, H, i) for i in range(4)]
    src = os.path.join(root, "clip_source.y4m")
    y4m.write(src, [(f.y, f.u, f.v) for f in frames])
    rec0 = recons[0][0].cpu().numpy()[:H, :W]
    want = round(quality.psnr(frames[0].y, rec0), 3)
    host = [tuple(p.cpu().numpy() for p in r) for r in recons]
    check_async(name, "all 4 frames of encode_clip's IVF (quality's "
                f"Y-PSNR is recon 0's, {want} dB)", _clip_job, ivf_path,
                host, src, want, decoder="legacy decoder (on the CPU)")
    return {"launches": launches}


def kernel_entry(name, source, replaces, counts, err, rows):
    """One kernel of the JSON line: the first (1080p) shape's numbers at
    the top level, every shape of every frame size under "shapes", each
    labelled with its size; "launches" is the count
    of the two-reference 1080p path, every path's under
    "launches_by_path"."""
    launches = counts["slice-1080p-golden"][name]
    by_path = {path: c[name] for path, c in counts.items()}
    top = {k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "share", "library_ms")}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **top, "launches_by_path": by_path, "shapes": rows}


def dist_refs(dev_name: str) -> dict:
    """The one-device cells the dist phase compares with, alone:
    slice-1080p-chunk8 (run_chunk_cell) and slice-720p-default
    (run_slice), as phase_slices runs them."""
    grain9 = grain_clip()
    c = run_chunk_cell("slice-1080p-chunk8", grain9, dev_name, packed=False)
    frames = clean_clip_720p()
    r = run_slice("slice-720p-default", frames, True, dev_name, filters=True)
    return {"slice-1080p-chunk8": {**c, "name": "slice-1080p-chunk8",
                                   "frames": grain9},
            "slice-720p-default": slice_ref("slice-720p-default", r, frames)}


def main() -> int:
    if sys.argv[1:2] == ["--dist-rank"]:
        return dist_rank(*sys.argv[2:5])
    t_start = time.perf_counter()
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
    if "--dist" in sys.argv[1:]:
        refs = dist_refs(dev_name)
        phase_dist(card, refs, phase_stripes(card, refs)[1])
        log(f"smoke --dist: {time.perf_counter() - t_start:.1f} s from start "
            "to the last check")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    k1_err, k1_rows, k2_err, k2_rows, g2_err, g2_rows = phase_kernels(
        torch.device(dev_name))
    daemon = phase_daemon(card)
    ops = phase_ops(card, daemon)
    counts, runs, refs = phase_slices(dev_name, daemon["payloads"])
    counts["daemon-1080p"] = daemon["launches"]
    counts["encode_clip"] = ops["launches"]
    stripe_counts, threads = phase_stripes(card, refs)
    counts.update(stripe_counts)
    counts.update(phase_legacy(dev_name))
    counts.update(phase_mesh(dev_name, card))
    counts.update(phase_dist(card, refs, threads))
    if "--profile" in sys.argv[1:]:
        phase_profile(runs)
    phase_conform(dev_name)
    conform_legacy(dev_name)
    decode_wait()
    shutil.rmtree(daemon["root"])
    log(f"smoke: {time.perf_counter() - t_start:.1f} s from start to the "
        "last check")

    print(json.dumps({"kernels": [
        kernel_entry("gather_windows", "av1tpu_torch/csrc/gather.cu",
                     "av1tpu/encoder/kernels/pallas_gather.py:42",
                     counts, k1_err, k1_rows),
        kernel_entry("gather_windows2", "av1tpu_torch/csrc/gather.cu",
                     "av1tpu/encoder/kernels/pallas_gather.py:145",
                     counts, g2_err, g2_rows),
        kernel_entry("refine_ssd", "av1tpu_torch/csrc/refine.cu",
                     "av1tpu/encoder/kernels/pallas_motion.py:28",
                     counts, k2_err, k2_rows)]}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
