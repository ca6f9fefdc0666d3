# Copied from av1tpu/tools/doctor.py; check_tpu became check_gpu, and the
# encode smoke runs SpecTorchEngine on the card (or on the CPU with --cpu).
"""Environment diagnostics — the consolidated analog of the reference's
shell triage suite (check_arc_requirements.sh, check_gpu_access.sh,
check_lxc_mounts.sh, fix_gpu_permissions.sh, test_av1d_write.sh,
verify_service_config.sh, … — SURVEY.md §2 #14).

Checks, in order: config validity, job/library path write access, the
native tile writer's build, CUDA card visibility and the CUDA compiler,
and a live 1-frame encode smoke on the card (the QSV self-test analog),
which builds the kernels at first use.  Exit code 0 iff all critical
checks pass.  ``--cpu`` (alias ``--no-tpu``) asks for the smoke on the
CPU; without it and without a card the smoke fails, naming the missing
card.  Usage:  python -m av1tpu_torch.tools.doctor [config.json] [--cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile


def _result(name: str, ok: bool, detail: str = "", critical: bool = True):
    mark = "OK  " if ok else ("FAIL" if critical else "warn")
    print(f"[{mark}] {name}" + (f": {detail}" if detail else ""))
    return ok or not critical


def check_config(path):
    from av1tpu_torch import config as config_mod
    try:
        cfg = config_mod.load_config(path)
        ok = True
        detail = (f"{len(cfg.library_roots)} roots, jobs dir "
                  f"{cfg.job_state_dir}")
    except Exception as e:
        cfg = config_mod.default_config()
        ok = False
        detail = f"unreadable ({e}); defaults in effect"
    _result("config", ok, detail, critical=False)
    return cfg


def check_write_access(cfg) -> bool:
    """test_av1d_write.sh analog: service-user write access to the dirs."""
    ok_all = True
    for label, d in [("job_state_dir", cfg.job_state_dir)] + [
            (f"library_root[{i}]", r) for i, r in
            enumerate(cfg.library_roots)]:
        if not d:
            continue
        try:
            os.makedirs(d, exist_ok=True)
            with tempfile.NamedTemporaryFile(dir=d, prefix=".av1tpu-wtest",
                                             delete=True):
                pass
            ok = True
            detail = d
        except OSError as e:
            ok = False
            detail = f"{d}: {e}"
        ok_all &= _result(f"write access {label}", ok, detail)
    return ok_all


def check_unit_paths(cfg) -> bool:
    """verify_service_config.sh analog: under ProtectSystem=strict the
    unit's ReadWritePaths must cover every library root, or job temp
    outputs (`<base>.av1-tmp.mkv`) cannot be written next to media."""
    unit = "/etc/systemd/system/av1d.service"
    if not os.path.exists(unit) or not cfg.library_roots:
        return True  # nothing installed / nothing to cover
    rw: list[str] = []
    with open(unit) as f:
        for line in f:
            line = line.strip()
            if line.startswith("ReadWritePaths="):
                rw.extend(line.split("=", 1)[1].split())
    missing = [r for r in cfg.library_roots
               if not any(os.path.commonpath([r, p]) == p
                          for p in rw if os.path.isabs(p))]
    return _result(
        "unit ReadWritePaths", not missing,
        "all library roots covered" if not missing else
        f"NOT covered: {missing} — rerun install/install.sh")


def check_native() -> bool:
    try:
        from av1tpu_torch.encoder import entropy
        lib = entropy.load_library()
        return _result("native entropy library", True,
                       f"{os.path.basename(lib._name)} loaded")
    except Exception as e:
        return _result("native entropy library", False, str(e))


def check_gpu() -> bool:
    """check_gpu_access.sh analog: CUDA card visibility, and the nvcc
    that builds the kernels at first use."""
    try:
        import torch

        from av1tpu_torch import device as D
        n = torch.cuda.device_count()
        if not n:
            return _result("accelerator", False,
                           "torch reports no CUDA device", critical=False)
        names = {torch.cuda.get_device_name(i) for i in range(n)}
        major, minor = torch.cuda.get_device_capability(0)
        try:
            nvcc = D._nvcc()
        except RuntimeError:
            nvcc = None
        return _result("accelerator", nvcc is not None,
                       f"{n}x {', '.join(sorted(names))} (sm_{major}{minor}),"
                       f" nvcc {nvcc or 'not found'}", critical=False)
    except Exception as e:
        return _result("accelerator", False, str(e), critical=False)


def check_encode_smoke(device: str = "cuda") -> bool:
    """VerifyFFmpeg analog: live 1-frame synthetic encode on ``device``
    (small shape; the daemon's own startup test uses the full 1280x720
    frame)."""
    try:
        import time

        from av1tpu_torch.config import TpuEncoderConfig
        from av1tpu_torch.spec_engine import SpecTorchEngine
        from av1tpu_torch.utils.testsrc import testsrc2
        t = time.perf_counter()
        eng = SpecTorchEngine(TpuEncoderConfig(), device=device)
        payload = eng.encode_keyframe(testsrc2(320, 192, 0), 96)
        dt = time.perf_counter() - t
        return _result("encode smoke", len(payload) > 0,
                       f"{len(payload)} bytes (320x192 keyframe on "
                       f"{eng.device}, {dt:.2f} s)")
    except Exception as e:
        return _result("encode smoke", False, str(e))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # --cpu (encode_clip's flag) or --no-tpu: the smoke on the CPU
    no_tpu = "--no-tpu" in argv or "--cpu" in argv
    argv = [a for a in argv if a not in ("--no-tpu", "--cpu")]
    unknown = [a for a in argv if a.startswith("-")]
    if unknown:
        print(f"doctor: unknown flag(s) {unknown}; "
              "usage: doctor [--cpu|--no-tpu] [config.json]")
        return 2
    from av1tpu_torch import config as config_mod
    path = argv[0] if argv else config_mod.CONFIG_PATH

    print(f"av1tpu_torch doctor — config: {path}")
    cfg = check_config(path)
    ok = True
    ok &= check_write_access(cfg)
    ok &= check_unit_paths(cfg)
    ok &= check_native()
    check_gpu()
    ok &= check_encode_smoke("cpu" if no_tpu else "cuda")
    print("RESULT:", "healthy" if ok else "NOT healthy")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
