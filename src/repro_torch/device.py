"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for `device`; raises instead of falling back to the CPU.

    `cuda` and `cpu` are accepted, and `meta` (shapes without storage, for
    the dry run of `launch/dryrun.py`).  Asking for CUDA on a machine without
    it is an error: the caller must pass `device="cpu"` to run the plain path.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or 'meta'")
    return dev
