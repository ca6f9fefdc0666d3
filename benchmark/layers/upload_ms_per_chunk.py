"""upload_ms_per_chunk (upload): the dispatch worker's host time of each
chunk's upload (the program's ``upload`` spans: the packed arrays'
copies, or ``upload_chunk_raw``), per chunk dispatch of the window."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    up = program.window(run, "upload")
    return program.ms(up) / len(up) if up else None
