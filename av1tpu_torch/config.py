# Copied from av1tpu/config.py.
"""Daemon configuration.

Byte-compatible with the reference config schema (internal/config/config.go:10-18):
seven JSON keys — ffmpeg_url, ffmpeg_install_dir, library_roots, min_bytes,
max_size_ratio, job_state_dir, scan_interval_sec — loaded from
/etc/av1qsvd/config.json with silent fallback to defaults
(cmd/av1d/main.go:23-28).  Additive-only TPU keys are namespaced so a
reference config file loads unchanged: ``encoder`` selects the engine
("tpu" default here; the reference's implied value is "vaapi"), and
``tpu`` holds engine tuning knobs.

``TpuEncoderConfig`` keeps the JAX package's field names and defaults;
the port's engine accepts the subset that ``SpecTorchEngine`` checks at
construction.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

CONFIG_PATH = "/etc/av1qsvd/config.json"


@dataclasses.dataclass
class TpuEncoderConfig:
    """TPU engine tuning (additive; no reference counterpart)."""

    keyint: int = 120          # GOP length in frames
    # bitstream: "spec" emits standard AV1 (default; decodable by any
    # player); "av1tpu" is the round-1 private profile (debug only)
    bitstream: str = "spec"
    block_log2: int = 0        # 4=16px, 5=32px, 0=auto (32 at HD+)
    tile_rows_log2: int = 0    # extra tile rows (sharding raises this)
    num_chips: int = 0         # n >= 2: stripes on n devices; 0, 1: one
    # (under the AV1TPU_* process group: 0 = one stripe a rank)
    speed: int = 6             # 0 (slowest/best) .. 9 (fastest)
    chunk: int = 8             # P-frames batched per device dispatch
    # quantizer rounding offset (deadzone: floor(|c|/q + 1 - qround)).
    # Normative for the emitted bits, so it lives in config and is
    # recorded per job; 0.70 is the measured RD knee (BASELINE.md).
    qround: float = 0.70
    # in-loop CDEF (spec 7.15): frame strengths searched on-device by
    # SSE vs source; the (0,0) candidate keeps the filter off when it
    # does not help.  The reference's av1_vaapi emits CDEF
    # (internal/ffmpeg/transcode.go:119-123; BASELINE config #4).
    cdef: bool = True
    # in-loop Wiener loop restoration (spec 7.17): per-RU preset taps
    # searched on-device by SSE vs source; RUs stay off unless the
    # filter pays for its syntax.  BASELINE config #4 names loop
    # restoration alongside CDEF.
    lr: bool = True
    # per-block LAST/GOLDEN reference selection: slot 1 holds the GOP
    # keyframe, and each 32-block (with its SPLIT quadrants) may code
    # against it when that beats the previous frame by a rate-aware
    # margin (occlusion reveals, flashes, grain accumulation).  The
    # reference's av1_vaapi uses multi-reference prediction inside
    # ffmpeg (internal/ffmpeg/transcode.go:119-123).
    golden: bool = True
    # lossless source-upload packing (encoder/io_pack.py): per-plane
    # delta + 4-bit nibbles roughly halve the H2D bytes per chunk on
    # typical content; chunks whose residual outliers exceed the cap
    # fall back to the raw upload automatically.  Bit-identical output
    # either way (tests/test_io_pack.py).
    delta_upload: bool = True
    lowres_decode: bool = False
    # startup self-test frame (VerifyFFmpeg analog is 1280x720;
    # binary.go:282-295). Smaller sizes cut first-compile cost on
    # platforms where the XLA compile cache is ineffective.
    self_test: bool = True
    self_test_size: str = "1280x720"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TpuEncoderConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class TranscodeConfig:
    """Mirror of the reference TranscodeConfig (config.go:10-18)."""

    ffmpeg_url: str = ""
    ffmpeg_install_dir: str = ""
    library_roots: list[str] = dataclasses.field(default_factory=list)
    min_bytes: int = 2 * 1024 * 1024 * 1024      # 2 GiB (config.go:36)
    max_size_ratio: float = 0.90                  # config.go:37
    job_state_dir: str = ""
    scan_interval_sec: int = 60                   # config.go:39 (never read; kept for parity)
    # --- additive TPU keys (not in reference) ---
    encoder: str = "tpu"
    tpu: TpuEncoderConfig = dataclasses.field(default_factory=TpuEncoderConfig)

    def to_dict(self) -> dict[str, Any]:
        d = {
            "ffmpeg_url": self.ffmpeg_url,
            "ffmpeg_install_dir": self.ffmpeg_install_dir,
            "library_roots": self.library_roots,
            "min_bytes": self.min_bytes,
            "max_size_ratio": self.max_size_ratio,
            "job_state_dir": self.job_state_dir,
            "scan_interval_sec": self.scan_interval_sec,
            "encoder": self.encoder,
            "tpu": dataclasses.asdict(self.tpu),
        }
        return d


def default_config() -> TranscodeConfig:
    """Defaults mirroring config.go:21-41 (paths keep the av1qsvd data dir)."""
    home = os.path.expanduser("~") or "."
    data_dir = os.path.join(home, ".local", "share", "av1qsvd")
    return TranscodeConfig(
        ffmpeg_url="",  # no external engine to download; the TPU engine is in-process
        ffmpeg_install_dir=os.path.join(data_dir, "ffmpeg"),
        library_roots=[],
        min_bytes=2 * 1024 * 1024 * 1024,
        max_size_ratio=0.90,
        job_state_dir=os.path.join(data_dir, "jobs"),
        scan_interval_sec=60,
    )


def load_config(path: str) -> TranscodeConfig:
    """Load config JSON; raises on missing/invalid file (config.go:46-58).

    Callers fall back to default_config(), matching cmd/av1d/main.go:24-28.
    Unknown keys are ignored; missing keys keep Go zero values (empty/0),
    matching encoding/json semantics.
    """
    with open(path, "rb") as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"config root must be an object, got {type(raw)}")
    cfg = TranscodeConfig(
        ffmpeg_url=raw.get("ffmpeg_url", "") or "",
        ffmpeg_install_dir=raw.get("ffmpeg_install_dir", "") or "",
        library_roots=list(raw.get("library_roots") or []),
        min_bytes=int(raw.get("min_bytes", 0) or 0),
        max_size_ratio=float(raw.get("max_size_ratio", 0.0) or 0.0),
        job_state_dir=raw.get("job_state_dir", "") or "",
        scan_interval_sec=int(raw.get("scan_interval_sec", 0) or 0),
        encoder=raw.get("encoder", "tpu") or "tpu",
        tpu=TpuEncoderConfig.from_dict(raw.get("tpu") or {}),
    )
    return cfg


def load_config_or_default(path: str = CONFIG_PATH) -> TranscodeConfig:
    try:
        return load_config(path)
    except (OSError, ValueError, TypeError, json.JSONDecodeError):
        return default_config()
