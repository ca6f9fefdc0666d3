"""The comparison that decides ``correct``: libaom, the reference AV1
decoder (``aomdec.py``), against what the timed path produced.

libaom decodes the stream from its first payload, each P-frame from its
own decoded references, and every compared frame's decoded planes must
equal, sample for sample over the coded frame, the program's
reconstruction of that frame: an AV1 encoder's reconstruction is what
every decoder reproduces from its payload, and what the encoder's next
frames predict from.  It also measures the decoded frames' luma PSNR
against the benchmark's own source frames.

Nothing here imports the program, and every number is worked out in
this file's arithmetic.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark import aomdec

# libaom's threads: the check runs once the program's work has ended
THREADS = min(8, os.cpu_count() or 1)


def psnr_y(a: np.ndarray, b: np.ndarray) -> float:
    """Luma PSNR in dB of 8-bit planes a against b (inf when equal)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def psnr_y_frames(recons, sources) -> float:
    """Luma PSNR over several frames together: from the mean squared
    error of all their samples."""
    sse, n = 0.0, 0
    for a, b in zip(recons, sources):
        d = a.astype(np.float64) - b.astype(np.float64)
        sse += float(np.sum(d * d))
        n += d.size
    return float("inf") if sse == 0 else 10.0 * np.log10(
        255.0 ** 2 * n / sse)


def mismatch(got, recon) -> int:
    """Samples of the decoded planes ``got`` that differ from the
    reconstruction's over the coded frame, all planes."""
    n = 0
    for pl in range(3):
        a = np.asarray(got[pl], np.int64)
        hh, ww = a.shape
        b = np.asarray(recon[pl][:hh, :ww], np.int64)
        if a.shape != b.shape:
            raise ValueError(f"plane {pl}: decoded {a.shape}, "
                             f"reconstruction {b.shape}")
        n += int(np.count_nonzero(a != b))
    return n


def check_stream(payloads: list, recons: dict, sources_y: dict) -> dict:
    """libaom decodes ``payloads`` (one temporal unit each, the stream
    from its first) up to the last frame of ``recons`` ({index: (y, u,
    v)}), and compares each of those frames with the reconstruction.
    Returns ``mismatch`` {index: differing samples}, ``psnr_y`` {index:
    decoded luma against ``sources_y``}, ``seconds``, and ``error`` where
    the decoder refused the stream."""
    t = time.perf_counter()
    out = {"mismatch": {}, "psnr_y": {}}
    last = max(recons)
    try:
        with aomdec.Decoder(threads=THREADS) as dec:
            for i in range(last + 1):
                got = dec.decode(bytes(payloads[i]), read=i in recons)
                if len(got) != 1:
                    raise ValueError(f"payload {i} shows {len(got)} frames")
                if i in recons:
                    out["mismatch"][i] = mismatch(got[0], recons[i])
                    out["psnr_y"][i] = psnr_y(got[0][0], sources_y[i])
    except Exception as e:  # the verdict names what failed
        out["error"] = f"{type(e).__name__}: {e}"
    out["seconds"] = time.perf_counter() - t
    return out
