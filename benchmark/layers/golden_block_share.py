"""golden_block_share (P-frame encoder): of the inter blocks the window's
P-frames code, the share that predicts from GOLDEN (the program's
``mv.golden_blocks`` and ``mv.inter_blocks`` counters: spans over each
P-frame's tile coding whose ``n`` is the frame's count)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    golden = program.window(run, "mv.golden_blocks")
    inter = sum(s.n for s in program.window(run, "mv.inter_blocks"))
    if not golden or not inter:
        return None
    return sum(s.n for s in golden) / inter
