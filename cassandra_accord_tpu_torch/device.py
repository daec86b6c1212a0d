"""Where the device tier runs: one resolver for ``LocalConfig.device``.

The default is the card.  The CPU is used only when the caller asks for it
(``device="cpu"`` or ``ACCORD_DEVICE=cpu``): a missing card is an error, never
a silent move to the CPU, so a run that claims the device tier really ran
the CUDA kernels.
"""
from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """The torch device named by ``name`` ("cuda", "cuda:N", "cpu" or a
    ``torch.device``).
    Raises when a CUDA device is named and CUDA is not available."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be cuda[:N] or cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "ask for device='cpu' (ACCORD_DEVICE=cpu) to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
