"""Where the port's entry points put their tensors.

The port runs on the CUDA card unless the caller asks for the CPU:
``resolve(None)`` is ``cuda``, and with no card it raises instead of
running on the host behind the caller's back.
"""
from __future__ import annotations

import subprocess

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises ``RuntimeError`` when ``device`` is ``None`` and no card is
    available: pass ``device="cpu"`` to run on the host."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" to run on the host")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
