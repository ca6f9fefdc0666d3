# Copied from av1tpu/tui/view.py; the accelerator line reads the card
# (SystemMetrics' gpu_* fields), and the title names the port.
"""Dashboard rendering (ref: internal/tui/view.go).

Pure string rendering — returns lines, so the whole layout is unit
testable without a terminal.  Layout mirrors the reference's btop-style
panels: title bar, SYSTEM METRICS (CPU/MEM/GPU bars with threshold
coloring), QUEUE SUMMARY, ACTIVE JOB detail, JOB QUEUE table with
truncation + "… N more jobs", status bar (view.go:70-119).
"""

from __future__ import annotations

import os
from datetime import datetime

from av1tpu_torch import jobs
from av1tpu_torch.tui.model import Model

BAR_WIDTH = 24


def humanize_bytes(n: float) -> str:
    """view.go:466-528 style sizes."""
    if n <= 0:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TB"


def humanize_duration(seconds: float) -> str:
    if seconds < 0:
        return "-"
    s = int(seconds)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    if h:
        return f"{h}h{m:02d}m{s:02d}s"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"


def render_bar(percent: float, width: int = BAR_WIDTH) -> str:
    """Unicode block bar (view.go:144-177)."""
    pct = max(0.0, min(100.0, percent))
    filled = int(pct / 100.0 * width)
    return "█" * filled + "░" * (width - filled)


def _elapsed_of(job: jobs.Job) -> float:
    if not job.started_at:
        return -1
    try:
        t0 = datetime.fromisoformat(job.started_at)
        t1 = (datetime.fromisoformat(job.finished_at)
              if job.finished_at else datetime.now(t0.tzinfo))
        return (t1 - t0).total_seconds()
    except ValueError:
        return -1


def render_metrics(m: Model) -> list[str]:
    mt = m.metrics
    lines = ["SYSTEM METRICS"]
    lines.append(f"  CPU  [{render_bar(mt.cpu_percent)}] {mt.cpu_percent:5.1f}%")
    lines.append(f"  MEM  [{render_bar(mt.mem_percent)}] {mt.mem_percent:5.1f}%"
                 f"  ({mt.mem_used_gb:.1f}/{mt.mem_total_gb:.1f} GB)")
    if mt.gpu_count:
        lines.append(
            f"  GPU  [{render_bar(mt.gpu_percent)}] {mt.gpu_percent:5.1f}%"
            f"  MEM ({mt.gpu_mem_used_gb:.1f}/{mt.gpu_mem_total_gb:.1f} GB)"
            f"  {mt.gpu_count}x {mt.gpu_name}")
    else:
        lines.append("  GPU  [" + "░" * BAR_WIDTH + "]   n/a  (no device)")
    return lines


def render_summary(m: Model) -> list[str]:
    c = m.counts_by_status()
    savings = m.total_savings_bytes()
    return [
        "QUEUE SUMMARY",
        (f"  pending {c['pending']}  running {c['running']}  "
         f"success {c['success']}  failed {c['failed']}  "
         f"skipped {c['skipped']}"),
        f"  total saved: {humanize_bytes(savings)}",
    ]


def render_active_job(m: Model) -> list[str]:
    """ACTIVE JOB panel (view.go:220-297)."""
    j = m.active_job()
    if j is None:
        return ["ACTIVE JOB", "  (idle)"]
    pct_est = ""
    if j.estimated_bytes and j.original_bytes:
        sav = (1 - j.estimated_bytes / j.original_bytes) * 100
        pct_est = f" (~{sav:.0f}% savings)"
    lines = [
        "ACTIVE JOB",
        f"  file:       {os.path.basename(j.source_path)}",
        f"  resolution: {j.resolution or '-'}   codec: "
        f"{j.source_codec or '-'}"
        + (f" {j.bit_depth}bit" if j.bit_depth else ""),
        f"  fps:        {j.frame_rate or '-'}   container: "
        f"{j.container or '-'}",
        f"  streams:    {j.audio_streams} audio, {j.subtitle_streams} subs",
        f"  size:       {humanize_bytes(j.original_bytes)} → est "
        f"{humanize_bytes(j.estimated_bytes)}{pct_est}",
        f"  elapsed:    {humanize_duration(_elapsed_of(j))}   type: "
        f"{'web-like' if j.is_webrip_like else 'disc-like'}",
    ]
    if j.progress_frames:
        if j.total_frames:
            pct = 100.0 * j.progress_frames / j.total_frames
            lines.append(f"  progress:   [{render_bar(pct)}] "
                         f"{j.progress_frames}/{j.total_frames} "
                         f"({pct:.0f}%)")
        else:
            lines.append(f"  progress:   {j.progress_frames} frames")
    if j.encode_fps:
        lines.append(f"  encode:     {j.encode_fps:.2f} fps"
                     + (f"  ({j.resumed_frames} frames resumed)"
                        if j.resumed_frames else ""))
    return lines


def render_job_table(m: Model, max_rows: int = 12,
                     width: int = 100) -> list[str]:
    """JOB QUEUE table (view.go:300-341)."""
    lines = ["JOB QUEUE"]
    header = (f"  {'STATUS':<8} {'FILE':<32} {'RES':<10} {'CODEC':<6} "
              f"{'SIZE':<9} {'NEW':<9} {'FPS':<6} {'WHEN':<17}")
    lines.append(header[:width])
    shown = m.all_jobs[:max_rows]
    for j in shown:
        name = os.path.basename(j.source_path)
        if len(name) > 31:
            name = name[:28] + "..."
        when = (j.created_at or "")[:16].replace("T", " ")
        fps = f"{j.encode_fps:.1f}" if j.encode_fps else "-"
        row = (f"  {j.status:<8} {name:<32} {j.resolution or '-':<10} "
               f"{(j.source_codec or '-')[:6]:<6} "
               f"{humanize_bytes(j.original_bytes):<9} "
               f"{humanize_bytes(j.new_bytes):<9} {fps:<6} {when:<17}")
        lines.append(row[:width])
    more = len(m.all_jobs) - len(shown)
    if more > 0:
        lines.append(f"  … {more} more jobs")
    return lines


def render_status_bar(m: Model) -> str:
    c = m.counts_by_status()
    total = len(m.all_jobs)
    return (f" {total} jobs | {c['success']} done | {c['pending']} queued "
            f"| q:quit r:refresh")


def render(m: Model, width: int = 100) -> list[str]:
    """Full frame: all panels (view.go:70-119)."""
    title = " av1tpu_torch — AV1 transcoding daemon on CUDA "
    pad = max(0, width - len(title))
    lines = ["═" * 3 + title + "═" * max(0, pad - 3)]
    lines += render_metrics(m)
    lines.append("")
    lines += render_summary(m)
    lines.append("")
    lines += render_active_job(m)
    lines.append("")
    lines += render_job_table(m, width=width)
    lines.append("")
    lines.append(render_status_bar(m))
    return lines
