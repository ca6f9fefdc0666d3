"""signbias_flips_per_pframe (entropy): MV candidates that the tile
writer's extra search negated because their reference's sign bias
differs from the block's (spec 7.10.2.12), per P-frame of the window (the
program's ``mv.signbias_flips`` counter: a span over each P-frame's tile
coding whose ``n`` is the frame's count)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    flips = program.window(run, "mv.signbias_flips")
    return sum(s.n for s in flips) / len(flips) if flips else None
