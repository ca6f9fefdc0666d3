"""Switches the program's tracer on as it is imported: by the harness, as
it installs ``program.ON`` in a traced run (``program.py``)."""

from benchmark import program


def on():
    """The attribute ``program.ON`` names; importing this module is what
    counts, and nothing calls it."""


program.switch_on()
