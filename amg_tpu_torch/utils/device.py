"""Where the port's entry points put their tensors.

The port is written for the card: an entry point given no ``device`` runs
on ``"cuda"``. Without a CUDA device it raises instead of moving to the
CPU, so a run can never report CPU work as the card's; the CPU is used
only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"``, and raises
    when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: amg_tpu_torch runs on the card by default; "
            "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
