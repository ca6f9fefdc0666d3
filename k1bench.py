"""Device times of K1 (``av1tpu_torch/csrc/gather.cu``) at the gathers
of the 1080p and 720p P-frame paths and of their stripes
(``chip_smoke.SIZES``), to compare two checkouts on one card.

    python3 k1bench.py [--tree DIR] [--gap]

``--tree`` names the checkout whose ``av1tpu_torch`` is imported (by
default the one this file is in), so that a parent and a change can be
timed in turns in one call (parent, change, change, parent).  Only the
public wrappers are called; where a checkout has no U+V form, the U and
V windows of a chroma shape are two launches.  The timing, the plane
geometry, the path-like origins and the byte bound are
``chip_smoke.py``'s.  ``--gap`` also times the B=8160 luma shapes
through the one-plane entry and through the two-plane entry with the
selector all LAST, all GOLDEN and mixed.

One JSON object a line, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

import chip_smoke as cs


def shapes(b32: int):
    """The K1 gathers of one P-frame: (label, entry, plane, W, n, B, P,
    launches per golden P, launches with golden off); n is the block
    side on that plane's grid."""
    b16 = 4 * b32
    return [
        ("refine regions", "one", "luma", 48, 32, b32, 1, 2, 2),
        ("gather_blocks", "one", "luma", 32, 32, b32, 1, 1, 0),
        ("qpel 32", "both", "luma", 41, 32, b32, 1, 1, 1),
        ("split refine 16", "both", "luma", 32, 16, b16, 1, 1, 1),
        ("qpel 16", "both", "luma", 25, 16, b16, 1, 1, 1),
        ("chroma MC 16", "both", "chroma", 23, 16, b32, 2, 1, 1),
        ("chroma MC 8", "both", "chroma", 15, 8, b16, 2, 1, 1),
    ]


def emit(**row):
    print(json.dumps(row), flush=True)


def bench(gather, dev, uv: bool) -> None:
    """Every main-path gather at random and at path-like origins."""
    for sname, (w, h, n_stripes) in cs.SIZES.items():
        geo, b32 = cs.geometry(w, h, n_stripes)
        rng = np.random.default_rng(1)
        for label, entry, pname, W, n, B, P, lg, lo in shapes(b32):
            hp, wp = geo[pname]
            pl = [torch.as_tensor(rng.integers(0, 256, (hp, wp)),
                                  dtype=torch.int32, device=dev)
                  for _ in range(2 * P)]
            ri = torch.as_tensor(rng.integers(0, 2, B), dtype=torch.int32,
                                 device=dev)
            last, gold = pl[:P], pl[P:]
            for kind in ("random", "path"):
                if kind == "random":
                    oy = rng.integers(0, hp - W + 1, B)
                    ox = rng.integers(0, wp - W + 1, B)
                else:
                    oy, ox = cs.path_origins(rng, hp, wp, W, n, B,
                                             64 if pname == "luma" else 32)
                oy, ox = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                          for a in (oy, ox))
                for two in ((False, True) if entry == "both" else (False,)):
                    if uv or P == 1:
                        a = last[0] if P == 1 else tuple(last)
                        g = gold[0] if P == 1 else tuple(gold)
                        fn = ((lambda: gather.gather_windows2(
                            a, g, ri, oy, ox, W)) if two else
                            (lambda: gather.gather_windows(a, oy, ox, W)))
                    else:
                        fn = ((lambda: [gather.gather_windows2(
                            last[j], gold[j], ri, oy, ox, W)
                            for j in range(P)]) if two else
                            (lambda: [gather.gather_windows(last[j], oy, ox,
                                                            W)
                                      for j in range(P)]))
                    ms = cs.cuda_ms(fn)
                    bms = cs.bound_ms(cs.touched_bytes(
                        pl if two else last, ri if two else None, oy, ox,
                        W))[0]
                    # golden on: a "both" shape runs the two-plane entry;
                    # golden off: every shape runs the one-plane entry
                    emit(size=sname, shape=label, W=W, B=B, P=P,
                         entry="two-plane" if two else "one-plane",
                         origins=kind, ms=ms, bound_ms=bms, share=bms / ms,
                         launches_golden=lg if two or entry == "one" else 0,
                         launches_off=0 if two else lo)


def gap(gather, dev) -> None:
    """The B=8160 luma shapes through the one-plane entry and the
    two-plane entry with the selector all LAST, all GOLDEN and mixed,
    in turns, at random origins."""
    geo, b32 = cs.geometry(*cs.SIZES["1080p"])
    hp, wp = geo["luma"]
    rng = np.random.default_rng(2)
    p0, p1 = (torch.as_tensor(rng.integers(0, 256, (hp, wp)),
                              dtype=torch.int32, device=dev)
              for _ in range(2))
    B = 4 * b32
    for W in (32, 25):
        oy, ox = (torch.as_tensor(rng.integers(0, n - W + 1, B),
                                  dtype=torch.int32, device=dev)
                  for n in (hp, wp))
        sels = {"LAST": torch.zeros(B, dtype=torch.int32, device=dev),
                "GOLDEN": torch.ones(B, dtype=torch.int32, device=dev),
                "mixed": torch.as_tensor(rng.integers(0, 2, B),
                                         dtype=torch.int32, device=dev)}
        for rep in range(2):
            emit(gap="one-plane", W=W, B=B, rep=rep, ms=cs.cuda_ms(
                lambda: gather.gather_windows(p0, oy, ox, W)))
            for name, ri in sels.items():
                emit(gap=f"two-plane {name}", W=W, B=B, rep=rep,
                     ms=cs.cuda_ms(lambda: gather.gather_windows2(
                         p0, p1, ri, oy, ox, W)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--gap", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from av1tpu_torch.encoder.kernels import gather
    uv = hasattr(gather, "_as_planes")       # the U+V form of the wrappers
    dev = torch.device("cuda")
    emit(card=cs.card_line(), tree=tree, uv_one_launch=uv)
    bench(gather, dev, uv)
    if args.gap:
        gap(gather, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
