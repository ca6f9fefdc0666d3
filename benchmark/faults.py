"""Faults and the control, planted underneath the timed path, for the
tests and the chip runs that show the comparison deciding ``correct``
fails them (``run.py --fault NAME``, ``run.py --control 1``; never in a
measured run).  Each is a ``(target, around)`` spy for
``harness.run_cell(faults=...)``."""

from __future__ import annotations


def _state_unchanged(fn, a, k):
    # a P-frame step that hands back its reference as its reconstruction
    out = fn(*a, **k)
    return tuple(out[:5]) + (a[3], a[4], a[5]) + tuple(out[8:])


def _key_unchanged(fn, a, k):
    # a key step that leaves its reconstruction at its zero start
    import torch
    out = fn(*a, **k)
    return tuple(torch.zeros_like(p) for p in out[:3]) + tuple(out[3:])


def _half_left_out(fn, a, k):
    # a chunk dispatch that encodes its first half twice
    frames, qs = list(a[0]), list(a[1])
    half = len(frames) // 2
    return fn(frames[:half] * 2 + frames[2 * half:], qs, **k)


def _flip(payload: bytes) -> bytes:
    b = bytearray(payload)
    b[len(b) * 2 // 3] ^= 0x5A
    return bytes(b)


def _altered_chunk(fn, a, k):
    return [(_flip(p), key) for p, key in fn(*a, **k)]


def _altered_single(fn, a, k):
    p, key = fn(*a, **k)
    return _flip(p), key


# the faults a P cell can have, and those of a cell of keys
P_FAULTS = {
    "state_unchanged": ("av1tpu_torch.specav1.torch_inter:encode_frame",
                        _state_unchanged),
    "half_left_out": ("engine:_submit_chunk", _half_left_out),
    "answer_altered": ("engine:_finalize_chunk", _altered_chunk),
}
KEY_FAULTS = {
    "key_state_unchanged": ("av1tpu_torch.specav1.torch_intra:encode_frame",
                            _key_unchanged),
    "key_answer_altered": ("engine:_finalize", _altered_single),
}
FAULTS = {**P_FAULTS, **KEY_FAULTS}


def _bf16_coefficients(fn, a, k):
    # the inverse transform fed its dequantized coefficients rounded
    # through bfloat16
    import torch
    dq = a[0].to(torch.bfloat16).to(a[0].dtype)
    return fn(dq, *a[1:], **k)


# the control: the program's reconstructions computed from bfloat16
# coefficients, in the key and in the P-frames
CONTROL = [(f"av1tpu_torch.specav1.{mod}:{fn}", _bf16_coefficients)
           for mod, fn in (("torch_inter", "inv_tx2d_add"),
                           ("torch_intra", "inv_tx2d_add"),
                           ("torch_intra", "inv_tx2d_add_mixed"))]
