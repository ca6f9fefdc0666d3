# Copied from av1tpu/daemon/main.py.
"""Daemon entry: single scan pass + sequential job processing.

Mirrors cmd/av1d/main.go end to end: config load with default fallback
(main.go:23-28), engine bootstrap + self-test with degraded-start tolerance
(main.go:37-56), job load (main.go:68-73), library walk with the exact filter
ladder — extension, ``.av1qsvd-skip`` marker, already-success job, min size,
probe failure, not-video, already-AV1 (main.go:98-182) — job create/reset and
metadata fill (main.go:184-249), then one-at-a-time processing of pending
jobs (main.go:291-349).  The external loop is the service manager's restart
policy, exactly like the reference (SURVEY.md §1 control-flow surprise).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

from av1tpu_torch import config as config_mod
from av1tpu_torch import jobs, sidecars
from av1tpu_torch.daemon import core
from av1tpu_torch.encoder import ratectrl
from av1tpu_torch.media import probe as probe_mod

log = logging.getLogger("av1tpu_torch.av1d")

MEDIA_EXTENSIONS = (".mkv", ".mp4", ".m4v")  # main.go:98-101


@dataclasses.dataclass
class SkippedFile:  # main.go:463-466
    path: str
    reason: str


@dataclasses.dataclass
class ScanResult:
    candidates: list[str]
    skipped: list[SkippedFile]
    new_jobs: list[jobs.Job]


def scan_library(cfg: config_mod.TranscodeConfig,
                 existing_jobs: list[jobs.Job]) -> ScanResult:
    """One walk over every library root, applying the reference filter ladder."""
    candidates: list[str] = []
    skipped: list[SkippedFile] = []
    new_jobs: list[jobs.Job] = []

    def skip(path: str, reason: str) -> None:
        log.info("  -> Skipped: %s", reason)
        skipped.append(SkippedFile(path, reason))
        sidecars.write_why_file(path, reason)

    for root in cfg.library_roots:
        log.info("Scanning library root: %s", root)
        if not os.path.isdir(root):
            log.warning("Error accessing %s: not a directory", root)
            continue
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                ext = os.path.splitext(name)[1].lower()
                if ext not in MEDIA_EXTENSIONS:  # main.go:98-101
                    continue
                try:
                    size = os.path.getsize(path)
                except OSError as e:
                    log.warning("Error accessing %s: %s", path, e)
                    continue
                log.info("Found media file: %s (ext: %s, size: %.2f GB)",
                         path, ext, size / (1024 ** 3))

                # Skip marker (main.go:104-114)
                if sidecars.has_skip_marker(path):
                    skip(path, "marked with .av1qsvd-skip")
                    continue

                # Existing success job (main.go:117-127)
                existing = jobs.find_job_by_source_path(existing_jobs, path)
                if existing is not None and existing.status == jobs.STATUS_SUCCESS:
                    log.info("  -> Skipped: already successfully transcoded "
                             "(job %s)", existing.id)
                    continue

                # Min size (main.go:130-139); note <=, not <
                if size <= cfg.min_bytes:
                    skip(path, "file < 2GB (size: %d bytes, %.2f GB)"
                         % (size, size / (1024 ** 3)))
                    continue

                # Probe (main.go:142-154)
                try:
                    pr = probe_mod.probe_file(path)
                except probe_mod.ProbeError as e:
                    skip(path, f"probe failed: {e}")
                    continue

                if not pr.has_video:  # main.go:157-166
                    skip(path, "not a video")
                    continue
                if pr.has_av1:  # main.go:173-182
                    skip(path, "already av1")
                    continue

                # Create or update job (main.go:184-249)
                if existing is not None:
                    job = existing
                    if job.status in (jobs.STATUS_SKIPPED, jobs.STATUS_FAILED,
                                      jobs.STATUS_RUNNING):
                        # RUNNING at scan time is an orphan of a killed
                        # daemon (the process is single-threaded): reset
                        # it so the GOP spool resumes the encode.  The
                        # reference leaves such jobs stuck forever
                        # (main.go:191 resets only skipped/failed) —
                        # intentional improvement, enabled by the
                        # spool checkpoint the exec'd-ffmpeg design
                        # cannot have (SURVEY §5 checkpoint/resume).
                        log.info("  -> Resetting old %s job to pending for "
                                 "re-evaluation", job.status)
                        job.status = jobs.STATUS_PENDING
                        job.reason = ""
                        job.started_at = None
                        job.finished_at = None
                else:
                    job = jobs.new_job(path)

                job.original_bytes = size
                job.is_webrip_like = pr.is_webrip_like
                vs = pr.video_stream
                if vs is not None:
                    job.source_codec = vs.codec_name
                    job.resolution = f"{vs.width}x{vs.height}"
                    job.bit_depth = vs.bit_depth
                    job.frame_rate = vs.avg_frame_rate or vs.r_frame_rate

                job.audio_streams = sum(
                    1 for s in pr.streams if s.codec_type == "audio")
                job.subtitle_streams = sum(
                    1 for s in pr.streams if s.codec_type == "subtitle")
                job.container = pr.format.format_name

                quality = 24
                if vs is not None:
                    quality = ratectrl.determine_quality(vs.height)
                job.estimated_bytes = ratectrl.estimate_output_size(
                    size, pr, quality)

                try:
                    jobs.save_job(job, cfg.job_state_dir)
                except OSError as e:
                    log.error("Failed to save job for %s: %s", path, e)
                    continue

                candidates.append(path)
                new_jobs.append(job)
                if pr.source_decision is not None:
                    log.info("  -> ACCEPTED: %s (source: %s, score: %.1f, "
                             "codec: %s, resolution: %s)", path,
                             pr.source_decision.source_class,
                             pr.source_decision.score,
                             job.source_codec, job.resolution)
                    sidecars.write_classification_info(path, pr.source_decision)

    return ScanResult(candidates, skipped, new_jobs)


def process_pending(cfg: config_mod.TranscodeConfig, engine,
                    existing_jobs: list[jobs.Job],
                    new_jobs: list[jobs.Job]) -> int:
    """Sequential one-at-a-time job processing (main.go:291-349).

    ``engine`` may be None, in which case the TPU engine is constructed
    (with startup self-test) only when there is work to do — the in-process
    engine has no download step, so unlike EnsureFFmpeg there is nothing to
    bootstrap on an idle pass.
    """
    pending = [j for j in existing_jobs if j.status == jobs.STATUS_PENDING]
    pending += [j for j in new_jobs if j.status == jobs.STATUS_PENDING]
    if not pending:
        log.info("No pending jobs to process")
        return 0

    if engine is None:
        engine = _make_engine(cfg)
    log.info("Processing %d pending jobs...", len(pending))
    daemon_cfg = core.DaemonConfig(
        job_state_dir=cfg.job_state_dir,
        max_size_ratio=cfg.max_size_ratio,
    )
    processed = 0
    for job in pending:
        log.info("Processing job %s: %s", job.id, job.source_path)
        # Re-probe for fresh metadata (main.go:316-326)
        try:
            pr = probe_mod.probe_file(job.source_path)
        except probe_mod.ProbeError as e:
            log.error("Failed to probe file %s: %s", job.source_path, e)
            job.status = jobs.STATUS_FAILED
            job.reason = f"probe failed: {e}"
            jobs.save_job(job, cfg.job_state_dir)
            continue
        job.is_webrip_like = pr.is_webrip_like

        try:
            core.process_job(job, engine, pr, daemon_cfg)
        except Exception as e:
            log.error("Job %s failed: %s", job.id, e)
            continue
        processed += 1

        if job.status == jobs.STATUS_SUCCESS:
            savings = ((job.original_bytes - job.new_bytes)
                       / job.original_bytes * 100 if job.original_bytes else 0)
            log.info("Job succeeded: %s - savings: %.1f%%",
                     job.source_path, savings)
        elif job.status == jobs.STATUS_SKIPPED:
            log.info("Job skipped: %s - reason: %s", job.source_path, job.reason)
        elif job.status == jobs.STATUS_FAILED:
            log.info("Job failed: %s - reason: %s", job.source_path, job.reason)
    log.info("Finished processing jobs")
    return processed


def run_once(cfg: config_mod.TranscodeConfig, engine=None) -> ScanResult:
    """One full daemon pass: load jobs, scan, process.  Testable core of main()."""
    existing = jobs.load_all_jobs(cfg.job_state_dir)
    log.info("Loaded %d existing jobs", len(existing))

    if not cfg.library_roots:
        log.info("No library roots configured.")
        return ScanResult([], [], [])

    result = scan_library(cfg, existing)

    log.info("=== Scan Summary ===")
    log.info("Candidates (queued as jobs): %d", len(result.candidates))
    log.info("Skipped files: %d", len(result.skipped))

    process_pending(cfg, engine, existing, result.new_jobs)
    return result


def _make_engine(cfg: config_mod.TranscodeConfig):
    """Engine bootstrap + startup self-test (EnsureFFmpeg analog, main.go:37-56).

    A self-test failure degrades to a warning and the daemon proceeds — the
    engine is re-exercised during actual transcoding, matching the
    reference's QSV-test tolerance.
    """
    from av1tpu_torch.daemon import engine as engine_mod
    eng = engine_mod.make_engine(cfg)
    if not cfg.tpu.self_test:
        return eng
    try:
        engine_mod.verify_engine(eng, cfg.tpu.self_test_size)
    except Exception as e:
        log.warning("Warning: engine self-test failed during startup: %s", e)
        log.warning("Daemon will start anyway - engine will be exercised "
                    "during transcoding")
    return eng


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(filename)s:%(lineno)d: %(message)s",
        stream=sys.stderr,
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = argv[0] if argv else config_mod.CONFIG_PATH
    try:
        cfg = config_mod.load_config(config_path)
    except Exception as e:
        log.info("Failed to load config from %s, using defaults: %s",
                 config_path, e)
        cfg = config_mod.default_config()
    log.info("Using config: Job state dir: %s", cfg.job_state_dir)
    log.info("Library roots configured: %d", len(cfg.library_roots))
    for i, root in enumerate(cfg.library_roots):
        log.info("  [%d] %s", i + 1, root)
    log.info("Min file size: %d bytes (%.2f GB)", cfg.min_bytes,
             cfg.min_bytes / (1024 ** 3))
    try:
        run_once(cfg)
    except Exception as e:  # log.Fatalf analog (main.go:54)
        log.error("Fatal: %s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
