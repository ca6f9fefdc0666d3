# Copied from av1tpu/jobs.py.
"""Job model and persistence.

Byte-compatible with the reference job schema and file layout
(internal/jobs/jobs.go:16-79): one pretty-printed JSON file per job at
``<jobs_dir>/<id>.json``, field order and omitempty semantics identical to
Go's ``encoding/json`` marshaling of the reference ``Job`` struct
(jobs.go:25-46).  The daemon and the TUI communicate exclusively through
these files (SURVEY.md §1 "key structural fact"), so this schema is the
system's true internal API.
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid
from datetime import datetime, timezone
from typing import Optional

# 5-state machine (jobs.go:16-22)
STATUS_PENDING = "pending"
STATUS_RUNNING = "running"
STATUS_SUCCESS = "success"
STATUS_FAILED = "failed"
STATUS_SKIPPED = "skipped"

ALL_STATUSES = (STATUS_PENDING, STATUS_RUNNING, STATUS_SUCCESS,
                STATUS_FAILED, STATUS_SKIPPED)


def now_rfc3339() -> str:
    """Current local time as RFC3339 with offset (Go time.Time JSON shape)."""
    return datetime.now().astimezone().isoformat()


def _zero_time() -> str:
    """Go's zero time.Time marshals to this."""
    return "0001-01-01T00:00:00Z"


@dataclasses.dataclass
class Job:
    """Mirror of the reference Job struct (jobs.go:25-46).

    Timestamps are kept as RFC3339 strings (the JSON wire form) rather than
    datetime objects so round-trips are byte-faithful.
    """

    id: str = ""
    source_path: str = ""
    output_path: str = ""                    # omitempty
    created_at: str = ""                     # always marshaled
    started_at: Optional[str] = None         # omitempty (pointer in Go)
    finished_at: Optional[str] = None        # omitempty
    status: str = STATUS_PENDING
    reason: str = ""                         # omitempty
    original_bytes: int = 0                  # omitempty
    new_bytes: int = 0                       # omitempty
    estimated_bytes: int = 0                 # omitempty
    is_webrip_like: bool = False             # always marshaled
    source_codec: str = ""                   # omitempty
    resolution: str = ""                     # omitempty
    bit_depth: int = 0                       # omitempty
    frame_rate: str = ""                     # omitempty
    container: str = ""                      # omitempty
    video_codec: str = ""                    # omitempty (never written by daemon; TUI-only read, SURVEY §2)
    audio_streams: int = 0                   # omitempty
    subtitle_streams: int = 0                # omitempty
    # --- additive telemetry (no reference counterpart; SURVEY §5 tracing) ---
    encoded_frames: int = 0                  # omitempty
    encode_fps: float = 0.0                  # omitempty
    resumed_frames: int = 0                  # omitempty
    qround: float = 0.0                      # omitempty (quantizer knob)
    progress_frames: int = 0                 # omitempty (live, running jobs)
    total_frames: int = 0                    # omitempty

    def to_dict(self) -> dict:
        """JSON object with reference field order + omitempty behavior."""
        d: dict = {}
        d["id"] = self.id
        d["source_path"] = self.source_path
        if self.output_path:
            d["output_path"] = self.output_path
        d["created_at"] = self.created_at or _zero_time()
        if self.started_at:
            d["started_at"] = self.started_at
        if self.finished_at:
            d["finished_at"] = self.finished_at
        d["status"] = self.status
        if self.reason:
            d["reason"] = self.reason
        if self.original_bytes:
            d["original_bytes"] = self.original_bytes
        if self.new_bytes:
            d["new_bytes"] = self.new_bytes
        if self.estimated_bytes:
            d["estimated_bytes"] = self.estimated_bytes
        d["is_webrip_like"] = self.is_webrip_like
        if self.source_codec:
            d["source_codec"] = self.source_codec
        if self.resolution:
            d["resolution"] = self.resolution
        if self.bit_depth:
            d["bit_depth"] = self.bit_depth
        if self.frame_rate:
            d["frame_rate"] = self.frame_rate
        if self.container:
            d["container"] = self.container
        if self.video_codec:
            d["video_codec"] = self.video_codec
        if self.audio_streams:
            d["audio_streams"] = self.audio_streams
        if self.subtitle_streams:
            d["subtitle_streams"] = self.subtitle_streams
        if self.encoded_frames:
            d["encoded_frames"] = self.encoded_frames
        if self.encode_fps:
            d["encode_fps"] = round(self.encode_fps, 2)
        if self.resumed_frames:
            d["resumed_frames"] = self.resumed_frames
        if self.qround:
            d["qround"] = self.qround
        if self.progress_frames:
            d["progress_frames"] = self.progress_frames
        if self.total_frames:
            d["total_frames"] = self.total_frames
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Job":
        return cls(
            id=d.get("id", "") or "",
            source_path=d.get("source_path", "") or "",
            output_path=d.get("output_path", "") or "",
            created_at=d.get("created_at", "") or "",
            started_at=d.get("started_at") or None,
            finished_at=d.get("finished_at") or None,
            status=d.get("status", "") or "",
            reason=d.get("reason", "") or "",
            original_bytes=int(d.get("original_bytes", 0) or 0),
            new_bytes=int(d.get("new_bytes", 0) or 0),
            estimated_bytes=int(d.get("estimated_bytes", 0) or 0),
            is_webrip_like=bool(d.get("is_webrip_like", False)),
            source_codec=d.get("source_codec", "") or "",
            resolution=d.get("resolution", "") or "",
            bit_depth=int(d.get("bit_depth", 0) or 0),
            frame_rate=d.get("frame_rate", "") or "",
            container=d.get("container", "") or "",
            video_codec=d.get("video_codec", "") or "",
            audio_streams=int(d.get("audio_streams", 0) or 0),
            subtitle_streams=int(d.get("subtitle_streams", 0) or 0),
            encoded_frames=int(d.get("encoded_frames", 0) or 0),
            encode_fps=float(d.get("encode_fps", 0.0) or 0.0),
            resumed_frames=int(d.get("resumed_frames", 0) or 0),
            qround=float(d.get("qround", 0.0) or 0.0),
            progress_frames=int(d.get("progress_frames", 0) or 0),
            total_frames=int(d.get("total_frames", 0) or 0),
        )


def new_job(source_path: str) -> Job:
    """Fresh pending job with UUID id (jobs.go:49-57)."""
    return Job(
        id=str(uuid.uuid4()),
        source_path=source_path,
        created_at=now_rfc3339(),
        status=STATUS_PENDING,
        is_webrip_like=False,
    )


def save_job(job: Job, jobs_dir: str) -> None:
    """Write ``<jobs_dir>/<id>.json`` pretty-printed (jobs.go:61-79)."""
    os.makedirs(jobs_dir, exist_ok=True)
    path = os.path.join(jobs_dir, job.id + ".json")
    data = json.dumps(job.to_dict(), indent=2)
    with open(path, "w", encoding="utf-8") as f:
        f.write(data)


def load_all_jobs(jobs_dir: str) -> list[Job]:
    """Tolerant bulk load; skips unreadable/corrupt files (jobs.go:83-123)."""
    if not os.path.isdir(jobs_dir):
        return []
    out: list[Job] = []
    try:
        entries = sorted(os.listdir(jobs_dir))
    except OSError:
        return []
    for name in entries:
        if not name.endswith(".json"):
            continue
        path = os.path.join(jobs_dir, name)
        if os.path.isdir(path):
            continue
        try:
            with open(path, "rb") as f:
                d = json.load(f)
            if not isinstance(d, dict):
                continue
            out.append(Job.from_dict(d))
        except (OSError, ValueError):
            continue
    return out


def find_job_by_source_path(all_jobs: list[Job], source_path: str) -> Optional[Job]:
    """First job whose source_path matches (jobs.go:126-133)."""
    for job in all_jobs:
        if job.source_path == source_path:
            return job
    return None
