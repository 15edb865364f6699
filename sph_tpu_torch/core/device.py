"""Where the port's entry points put their tensors.

The port runs on the CUDA card unless the caller asks for the CPU:
``resolve(None)`` is ``cuda``, and with no card it raises instead of
running on the host behind the caller's back.
"""
from __future__ import annotations

import functools
import subprocess

import numpy as np
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


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """``values`` (numbers or tuples of them) as a tensor on ``device``,
    built once: the first call copies them from the host, which on a card
    waits for it; every later call returns the same tensor.  No caller may
    write into it.  A substep's constants come from here, so that no
    substep copies from the host (a copy that waits would also break the
    capture of ``engine.step.run_substeps``)."""
    return torch.tensor(values, dtype=dtype, device=device)


def filled(values, device) -> torch.Tensor:
    """Host numbers (a number or an array of them) as a float32 tensor on
    ``device``, each written there by a fill: nothing is copied from the
    host, so a frame that makes one does not wait for the device."""
    vals = np.asarray(values, dtype=np.float64)
    out = [torch.full((), float(v), dtype=torch.float32, device=device)
           for v in vals.reshape(-1)]
    return out[0] if vals.ndim == 0 else torch.stack(out).reshape(vals.shape)
