# Copied from av1tpu/scan.py.
"""File-stability check (ref: internal/scan/scan.go:13-33).

Stat the file, wait, stat again; stable iff the size is unchanged.  Used by
the job lifecycle to avoid transcoding a file that is still being copied in
(daemon.go:59 calls this with a 10 s wait).
"""

from __future__ import annotations

import os
import time


def check_file_stable(file_path: str, wait_seconds: float) -> bool:
    """True if file size is unchanged across a wait_seconds window.

    Raises OSError if the file cannot be stat'd (mirrors the error return
    of scan.go:16-18,24-28).
    """
    size0 = os.stat(file_path).st_size
    time.sleep(wait_seconds)
    size1 = os.stat(file_path).st_size
    return size0 == size1
