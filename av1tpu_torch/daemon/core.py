# Copied from av1tpu/daemon/core.py.
"""Job lifecycle: stability → running → transcode → size gate → atomic replace.

Semantics-exact rebuild of internal/daemon/daemon.go: the gate math
(daemon.go:18-21), the two-rename atomic replace with the ``<base>.av1-tmp.mkv``
temp-name convention (daemon.go:25-53), and the full ProcessJob state machine
with its failure paths and sidecar writes (daemon.go:57-182).  The encode
engine is injected (the reference injects the ffmpeg binary path; we inject a
Transcoder), so the lifecycle is testable with a fake engine.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Protocol

from av1tpu_torch import jobs, scan, sidecars

log = logging.getLogger("av1tpu_torch.daemon")

TMP_SUFFIX = ".av1-tmp.mkv"  # daemon.go:33,86
STABILITY_WAIT_SECONDS = 10.0  # daemon.go:59


class TranscodeError(Exception):
    """Engine-reported transcode failure (analog of a non-zero ffmpeg exit)."""

    def __init__(self, message: str, exit_code: int = 1):
        super().__init__(message)
        self.exit_code = exit_code


class Transcoder(Protocol):
    """The encode engine interface (the box that replaces the exec'd ffmpeg).

    The reference's equivalent surface is ffmpeg.TranscodeArgs +
    ffmpeg.RunTranscode (transcode.go:17,194); here the engine consumes the
    probe result directly and writes the finished Matroska file at
    output_path, raising TranscodeError on failure.
    """

    def transcode(self, input_path: str, output_path: str,
                  probe_result, is_webrip_like: bool) -> None: ...


@dataclasses.dataclass
class DaemonConfig:
    """Subset of config needed for job processing (daemon.go:185-188)."""

    job_state_dir: str
    max_size_ratio: float
    stability_wait_seconds: float = STABILITY_WAIT_SECONDS
    # decode the output's first GOP with the independent system AV1
    # decoder before atomically replacing the source (protects user
    # media; disable only for fake-engine tests)
    decode_verify: bool = True


def verify_output_av1(path: str, max_packets: int = 8) -> tuple[bool, str]:
    """Decode the leading video packets of the output MKV with the
    independent system AV1 decoder (libaom).  Returns (ok, reason).

    Soft-passes when no independent decoder is present — the gate must
    never block on a missing oracle, only on a failing one."""
    try:
        from av1tpu_torch.conformance import aomcodec
        if not aomcodec.available():
            log.warning("decode-verify: libaom unavailable; skipping")
            return True, "no independent decoder"
        from av1tpu_torch.media import mkv
        with open(path, "rb") as f:
            m = mkv.parse(f)
            video = [t for t in m.tracks if t.codec_id.startswith("V_")]
            if not video or video[0].codec_id != "V_AV1":
                return False, f"video track is not V_AV1"
            num = video[0].number
            dec = aomcodec.Decoder()
            got = 0
            for pkt in mkv.iter_packets(f, m):
                if pkt.track_number != num:
                    continue
                dec.decode(bytes(pkt.data))
                got += 1
                if got >= max_packets:
                    break
        if got == 0:
            return False, "no decodable video packets"
        return True, f"decoded {got} packets"
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"


def check_size_gate(orig_bytes: int, new_bytes: int, max_ratio: float) -> bool:
    """True iff new_bytes <= orig_bytes * max_ratio (daemon.go:18-21)."""
    return float(new_bytes) <= float(orig_bytes) * max_ratio


def tmp_output_path(source_path: str) -> str:
    """``<dir>/<base>.av1-tmp.mkv`` (daemon.go:82-87)."""
    d = os.path.dirname(source_path)
    base = os.path.basename(source_path)
    stem = os.path.splitext(base)[0]
    return os.path.join(d, stem + TMP_SUFFIX)


def atomic_replace_file(original_path: str, new_path: str) -> None:
    """Two-rename atomic replace (daemon.go:25-53).

    Renames new_path to the ``.av1-tmp.mkv`` name beside the original (no-op
    if already there), verifies it exists, then renames over the original.
    Both renames are same-filesystem by construction.
    """
    tmp_path = tmp_output_path(original_path)
    if new_path != tmp_path:
        os.rename(new_path, tmp_path)
    if not os.path.exists(tmp_path):
        raise FileNotFoundError(f"temp file does not exist: {tmp_path}")
    os.rename(tmp_path, original_path)


def _fail(job: jobs.Job, cfg: DaemonConfig, reason: str) -> None:
    job.status = jobs.STATUS_FAILED
    job.reason = reason
    job.finished_at = jobs.now_rfc3339()
    jobs.save_job(job, cfg.job_state_dir)


def process_job(job: jobs.Job, engine: Transcoder, probe_result,
                cfg: DaemonConfig) -> None:
    """Full job lifecycle (daemon.go:57-182).

    Mutates and persists ``job``; raises only on unexpected internal errors.
    Size-gate rejection and unstable files are not errors (skipped status).
    """
    # Stability check (daemon.go:59-71)
    try:
        stable = scan.check_file_stable(job.source_path,
                                        cfg.stability_wait_seconds)
    except OSError as e:
        raise OSError(f"failed to check file stability: {e}") from e
    if not stable:
        reason = "file still copying"
        job.status = jobs.STATUS_SKIPPED
        job.reason = reason
        job.finished_at = jobs.now_rfc3339()
        sidecars.write_why_file(job.source_path, reason)
        return

    # Mark running (daemon.go:74-79)
    job.status = jobs.STATUS_RUNNING
    job.started_at = jobs.now_rfc3339()
    jobs.save_job(job, cfg.job_state_dir)

    # Output path (daemon.go:82-87)
    output_path = tmp_output_path(job.source_path)
    job.output_path = output_path

    # Run transcode (daemon.go:101-112); the engine's gate-aware rate
    # control needs the gate ratio (the reference's ffmpeg had no such
    # feedback — ICQ only)
    if hasattr(engine, "gate_ratio") or hasattr(engine, "cfg"):
        try:
            engine.gate_ratio = cfg.max_size_ratio
        except AttributeError:
            pass

    def _progress(done: int, total: int) -> None:
        """Live per-job progress into the job JSON (SURVEY §5: the
        reference filtered ffmpeg's progress lines out entirely)."""
        job.progress_frames = done
        job.total_frames = total
        jobs.save_job(job, cfg.job_state_dir)

    try:
        engine.progress_cb = _progress
    except AttributeError:
        pass
    try:
        engine.transcode(job.source_path, output_path, probe_result,
                         job.is_webrip_like)
    except TranscodeError as e:
        _fail(job, cfg, f"engine exit code {e.exit_code}: {e}")
        sidecars.write_why_file(job.source_path, job.reason)
        if os.path.exists(output_path):
            os.remove(output_path)
        raise
    except Exception as e:  # engine bug — same cleanup path
        _fail(job, cfg, f"engine error: {e}")
        sidecars.write_why_file(job.source_path, job.reason)
        if os.path.exists(output_path):
            os.remove(output_path)
        raise

    # Per-job encode telemetry (additive; SURVEY §5 tracing)
    stats = getattr(engine, "last_job_stats", None)
    if stats:
        job.encoded_frames = int(stats.get("encoded_frames", 0))
        job.encode_fps = float(stats.get("encode_fps", 0.0))
        job.resumed_frames = int(stats.get("resumed_frames", 0))
        job.qround = float(stats.get("qround", 0.0))
    job.progress_frames = 0  # final record drops the live counter
    job.total_frames = 0

    # Stat output (daemon.go:115-126)
    try:
        job.new_bytes = os.stat(output_path).st_size
    except OSError as e:
        _fail(job, cfg, f"failed to stat output file: {e}")
        if os.path.exists(output_path):
            os.remove(output_path)
        raise

    # Size gate (daemon.go:129-149)
    if not check_size_gate(job.original_bytes, job.new_bytes,
                           cfg.max_size_ratio):
        reason = ("size gate: new %.1f MB vs orig %.1f MB (>%.0f%%)" % (
            job.new_bytes / (1024 * 1024),
            job.original_bytes / (1024 * 1024),
            cfg.max_size_ratio * 100))
        job.status = jobs.STATUS_SKIPPED
        job.reason = reason
        job.finished_at = jobs.now_rfc3339()
        sidecars.write_why_file(job.source_path, reason)
        sidecars.write_skip_marker(job.source_path)
        os.remove(output_path)
        jobs.save_job(job, cfg.job_state_dir)
        return

    # Decode-verify gate (beyond the reference: before irreversibly
    # replacing the user's file, prove the output is standard AV1 by
    # decoding its first GOP with the independent system decoder.
    # The reference trusted its encoder; we verify the artifact.)
    ok, why = (verify_output_av1(output_path) if cfg.decode_verify
               else (True, "disabled"))
    if not ok:
        _fail(job, cfg, f"output failed AV1 decode verification: {why}")
        sidecars.write_why_file(job.source_path, job.reason)
        os.remove(output_path)
        jobs.save_job(job, cfg.job_state_dir)
        raise TranscodeError(job.reason)

    # Atomic replace (daemon.go:154-162)
    try:
        atomic_replace_file(job.source_path, output_path)
    except OSError as e:
        _fail(job, cfg, f"failed to replace file: {e}")
        if os.path.exists(output_path):
            os.remove(output_path)
        raise

    # Verify (daemon.go:165-172)
    if not os.path.exists(job.source_path):
        _fail(job, cfg, "replaced file verification failed: file missing")
        raise FileNotFoundError(job.source_path)

    # Success (daemon.go:176-179)
    job.status = jobs.STATUS_SUCCESS
    job.finished_at = jobs.now_rfc3339()
    jobs.save_job(job, cfg.job_state_dir)
