# Copied from av1tpu/tui/metrics.py, with read_tpu as read_gpu and the
# SystemMetrics fields tpu_percent, tpu_kind, tpu_count, tpu_hbm_used_gb,
# tpu_hbm_total_gb as gpu_percent, gpu_name, gpu_count, gpu_mem_used_gb,
# gpu_mem_total_gb (collect's with_tpu as with_gpu).
"""System + accelerator metrics readers (ref: internal/tui/gpu.go, update.go).

CPU and memory come from /proc (the gopsutil analog); the accelerator
panel reads the CUDA card with gpu.go's multi-fallback ladder: (a)
``torch.cuda.mem_get_info`` (card-wide used and total bytes, every
process's allocations included), (b) device enumeration only, (c)
unavailable.  Readers never raise — the dashboard degrades to zeros
like the reference's GPU fallbacks (gpu.go:16-51); it shows "n/a" and
computes nothing.  ``mem_get_info`` opens a CUDA context on card 0 in
the dashboard's own process, which the used bytes then include.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional


@dataclasses.dataclass
class SystemMetrics:
    cpu_percent: float = 0.0
    mem_percent: float = 0.0
    mem_used_gb: float = 0.0
    mem_total_gb: float = 0.0
    gpu_percent: float = 0.0        # device memory occupancy %
    gpu_name: str = ""
    gpu_count: int = 0
    gpu_mem_used_gb: float = 0.0
    gpu_mem_total_gb: float = 0.0


_last_cpu: Optional[tuple[float, float]] = None  # (busy, total)


def read_cpu_percent() -> float:
    """CPU busy% from /proc/stat deltas (cpu.Percent analog)."""
    global _last_cpu
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [float(x) for x in parts[1:9]]
        idle = vals[3] + vals[4]           # idle + iowait
        total = sum(vals)
        busy = total - idle
        if _last_cpu is None:
            _last_cpu = (busy, total)
            return 0.0
        db = busy - _last_cpu[0]
        dt = total - _last_cpu[1]
        _last_cpu = (busy, total)
        return 100.0 * db / dt if dt > 0 else 0.0
    except (OSError, ValueError, IndexError):
        return 0.0


def read_mem() -> tuple[float, float, float]:
    """(percent, used_gb, total_gb) from /proc/meminfo."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = float(rest.split()[0])  # kB
        total = info.get("MemTotal", 0.0)
        avail = info.get("MemAvailable", total)
        used = total - avail
        pct = 100.0 * used / total if total else 0.0
        return pct, used / (1024 ** 2), total / (1024 ** 2)
    except (OSError, ValueError, IndexError):
        return 0.0, 0.0, 0.0


def read_gpu() -> tuple[float, str, int, float, float]:
    """(mem_pct, name, count, used_gb, total_gb) of card 0; zeros when
    no card.

    Fallback ladder (gpu.go analog): mem_get_info → enumeration → none.
    """
    try:
        import torch
        count = torch.cuda.device_count()
        if not count:
            return 0.0, "", 0, 0.0, 0.0
        name = torch.cuda.get_device_name(0)
        try:
            free, total = torch.cuda.mem_get_info(0)
            used = float(total - free)
            if total > 0:
                return (100.0 * used / total, name, count,
                        used / (1024 ** 3), total / (1024 ** 3))
        except Exception:
            pass
        return 0.0, name, count, 0.0, 0.0
    except Exception:
        return 0.0, "", 0, 0.0, 0.0


def collect(with_gpu: bool = True) -> SystemMetrics:
    m = SystemMetrics()
    m.cpu_percent = read_cpu_percent()
    m.mem_percent, m.mem_used_gb, m.mem_total_gb = read_mem()
    if with_gpu:
        (m.gpu_percent, m.gpu_name, m.gpu_count,
         m.gpu_mem_used_gb, m.gpu_mem_total_gb) = read_gpu()
    return m
