"""Device selection and float32 precision for the port.

Every entry point of the port takes ``device=`` and defaults to
``"cuda"``. :func:`resolve_device` turns that argument into a
``torch.device`` and raises when it names a card that is not there, so a
host with no card runs the plain versions only when the caller asks for
``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev


@contextlib.contextmanager
def exact_float32():
    """Full float32 for cuDNN convolutions and matmuls inside the block.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and moves calibration maxima across power-of-two
    boundaries (and so the frac bits of a plan); matmuls default to full
    float32 and are pinned there too."""
    cudnn = torch.backends.cudnn
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
