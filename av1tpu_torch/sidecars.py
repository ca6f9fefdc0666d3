# Copied from av1tpu/sidecars.py.
"""Sidecar files: explainable on-filesystem metrics.

Byte-compatible with the reference's namespaced sidecar conventions:
``.av1qsvd-why.txt`` (probe.go:396-402), ``.av1qsvd-classification.txt``
(probe.go:405-423), and the ``.av1qsvd-skip`` permanent skip marker
(cmd/av1d/main.go:104-114, daemon.go:142-143).
"""

from __future__ import annotations

import os
from typing import Optional

from av1tpu_torch.classify import WebSourceDecision

SKIP_SUFFIX = ".av1qsvd-skip"
WHY_SUFFIX = ".av1qsvd-why.txt"
CLASSIFICATION_SUFFIX = ".av1qsvd-classification.txt"


def _base_path(file_path: str) -> str:
    ext = os.path.splitext(file_path)[1]
    return file_path[: len(file_path) - len(ext)] if ext else file_path


def skip_marker_path(file_path: str) -> str:
    return _base_path(file_path) + SKIP_SUFFIX


def has_skip_marker(file_path: str) -> bool:
    return os.path.exists(skip_marker_path(file_path))


def write_skip_marker(file_path: str) -> None:
    """daemon.go:142-143 writes the literal payload "skip"."""
    with open(skip_marker_path(file_path), "w", encoding="utf-8") as f:
        f.write("skip")


def write_why_file(file_path: str, reason: str) -> None:
    """probe.go:398-402."""
    with open(_base_path(file_path) + WHY_SUFFIX, "w", encoding="utf-8") as f:
        f.write(reason)


def write_classification_info(file_path: str,
                              decision: Optional[WebSourceDecision]) -> None:
    """probe.go:405-423 — exact line format."""
    if decision is None:
        return
    lines = [
        f"Source Classification: {decision.source_class}",
        f"Score: {decision.score:.1f}",
        "",
        "Reasons:",
    ]
    for reason in decision.reasons:
        lines.append(f"  - {reason}")
    path = _base_path(file_path) + CLASSIFICATION_SUFFIX
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
