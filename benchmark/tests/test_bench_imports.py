"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole, so ``av1tpu_torch`` passes), and the
reference imports nothing of the program."""

import ast
import os

from benchmark import harness

BDIR = os.path.join(harness.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "av1tpu"}
# the reference's side: the decoder, the sources, the comparison
REFERENCE = ("reference.py", "aomdec.py", "gen.py", "frozen")


def top_names(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(under=BDIR):
    for d, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_walk_flags_whole_names_only():
    assert top_names("import av1tpu.spec_engine\nfrom jax import numpy")\
        & FORBIDDEN == {"av1tpu", "jax"}
    assert not top_names("import av1tpu_torch.engine\n"
                         "from av1tpu_torch import device") & FORBIDDEN


def test_benchmark_imports_no_jax():
    for path in sources():
        with open(path) as f:
            bad = top_names(f.read()) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for part in REFERENCE:
        p = os.path.join(BDIR, part)
        for path in ([p] if p.endswith(".py") else sources(p)):
            with open(path) as f:
                names = top_names(f.read())
            assert "av1tpu_torch" not in names, path
