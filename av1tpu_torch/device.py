"""Device choice, numeric flags, and the CUDA kernel library.

Devices are explicit: callers name ``"cuda"`` or ``"cpu"``; asking for
CUDA where there is none raises.  Nothing here falls back from one to
the other.

The hand-written kernels (``csrc/*.cu``) compile with ``nvcc``, one
process per source in parallel, into one plain-C shared library loaded
through ``ctypes``.  The build happens at
first use, from the package's own sources, into ``_build/`` next to this
file, keyed on a content hash of the sources and flags (checkouts do not
preserve mtimes), so a fresh checkout builds everything on its first
kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def set_numeric_flags() -> None:
    """Full-precision float32 everywhere: the encoder's forward
    transforms and RD costs are float32 products, and TF32 (cuDNN's
    default) would change which coefficients quantize to which level."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The torch.device for an explicit ``"cuda"``/``"cpu"`` request; a
    card without an index is the current one (``cuda:N`` then)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but torch "
                               "reports no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(dev)!r} requested but torch "
                               f"reports {torch.cuda.device_count()} CUDA "
                               "device(s)")
    set_numeric_flags()
    return dev


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR)
                  if n.endswith((".cu", ".cuh")))


def _src_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> str:
    """Compile the kernel library if its content hash is not built yet;
    returns the library path.  Each source compiles in its own ``nvcc``,
    all started together, then one link; ``ptxas``'s register and
    shared-memory report lands beside the library (``.log``)."""
    path = os.path.join(BUILD_DIR, f"libav1tpu_kernels_{_src_hash()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    nvcc = _nvcc()
    srcs = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    logs = [pr.communicate()[0] for pr in procs]
    failed = [f"{p}:\n{log}" for p, pr, log in zip(srcs, procs, logs)
              if pr.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    for o in objs:
        os.remove(o)
    with open(path + ".log", "w") as f:
        f.write("\n".join(logs))
    os.replace(tmp, path)
    return path


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernels())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            # four plane pointers, P, dtype, hp, wp, ri, oy, ox, B, W,
            # out, stream
            lib.av1_gather_windows.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               ci, vp, vp, vp, ci, ci, vp,
                                               vp]
            lib.av1_gather_windows.restype = ci
            lib.av1_refine_ssd.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
            lib.av1_refine_ssd.restype = ci
            _lib = lib
        return _lib


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def stream_ptr(dev: torch.device) -> int:
    """The current stream of card ``dev`` (not of the current card), as
    the pointer a kernel's C entry takes."""
    return torch.cuda.current_stream(dev).cuda_stream
