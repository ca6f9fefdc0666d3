# Copied from av1tpu/tui/model.py (with_tpu as with_gpu).
"""Dashboard state (ref: internal/tui/model.go, update.go).

The Elm-style model: jobs reloaded from the job-state directory each tick
(the daemon and TUI share no IPC — the JSON dir is the API, SURVEY.md §1),
plus system metrics.  Jobs sort newest-first (update.go:74-82).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from av1tpu_torch import jobs
from av1tpu_torch.tui import metrics as metrics_mod


@dataclasses.dataclass
class Model:
    jobs_dir: str
    all_jobs: list = dataclasses.field(default_factory=list)
    metrics: metrics_mod.SystemMetrics = dataclasses.field(
        default_factory=metrics_mod.SystemMetrics)
    last_refresh: float = 0.0
    with_gpu: bool = True

    def refresh_jobs(self) -> None:
        js = jobs.load_all_jobs(self.jobs_dir)
        js.sort(key=lambda j: j.created_at or "", reverse=True)
        self.all_jobs = js
        self.last_refresh = time.time()

    def refresh_metrics(self) -> None:
        self.metrics = metrics_mod.collect(with_gpu=self.with_gpu)

    def refresh(self) -> None:
        self.refresh_jobs()
        self.refresh_metrics()

    # -- derived views -----------------------------------------------------

    def counts_by_status(self) -> dict[str, int]:
        counts = {s: 0 for s in jobs.ALL_STATUSES}
        for j in self.all_jobs:
            counts[j.status] = counts.get(j.status, 0) + 1
        return counts

    def active_job(self) -> Optional[jobs.Job]:
        for j in self.all_jobs:
            if j.status == jobs.STATUS_RUNNING:
                return j
        return None

    def total_savings_bytes(self) -> int:
        return sum(j.original_bytes - j.new_bytes for j in self.all_jobs
                   if j.status == jobs.STATUS_SUCCESS and j.new_bytes)
