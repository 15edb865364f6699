"""The expand prototype on the card (counterpart of
``scripts/proto_bfly_kernel.py``).

    python -m sph_tpu_torch.app.proto_expand

Makes the script's synthetic inputs from seed 0 with numpy: NROW rows,
row y holding between MAXR/2 and MAXR elements, each with F = 8 payload
fields and a target slot, ascending and unique, in [0, S).  It runs
``expand_kernel`` (``csrc/micro.cu``, the counterpart of the script's
Pallas ``_kernel``) on them, checks the result bit-equal against the
script's numpy oracle (``:111-116``), and prints its time per call (CUDA
events over 20 calls after one warm-up).  NROW, S and MAXR default to 64,
4096 and 1024 and are read, as in the script, from ``PROTO_NROW``,
``PROTO_S`` and ``PROTO_MAXR``.  It needs a CUDA card: with none it raises
(``core.device.resolve``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from sph_tpu_torch.app.microbench import time_ms
from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.native import build

F = 8          # payload fields
WIDTH = 128    # columns of a row of the input: F payload, the target, pad
SEED = 0


def sizes():
    """(NROW, S, MAXR) from the environment, as the script reads them."""
    return (int(os.environ.get("PROTO_NROW", 64)),
            int(os.environ.get("PROTO_S", 4096)),
            int(os.environ.get("PROTO_MAXR", 1024)))


def synth(nrow: int, s: int, maxr: int, seed: int = SEED):
    """The script's inputs (``:78-92``): starts [nrow + 1] int32, rows
    [n + maxr, 128] float32, and each row's targets."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(int(maxr * 0.5), maxr, nrow)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n = int(starts[-1])
    rows = np.zeros((n + maxr, WIDTH), np.float32)
    targets = []
    for y in range(nrow):
        t = np.sort(rng.choice(s, counts[y], replace=False))
        targets.append(t)
        sl = slice(starts[y], starts[y + 1])
        rows[sl, :F] = rng.standard_normal((counts[y], F)).astype(np.float32)
        rows[sl, F] = t
    return starts, rows, targets


def oracle(starts, rows, targets, s: int) -> np.ndarray:
    """The script's numpy oracle (``:111-116``): [nrow, F, s], holes -1."""
    nrow = len(targets)
    ref = np.full((nrow, F, s), -1.0, np.float32)
    for y in range(nrow):
        sl = slice(starts[y], starts[y + 1])
        ref[y, :, targets[y]] = rows[sl, :F]
    return ref


def expand_plain(starts: torch.Tensor, rows: torch.Tensor,
                 slots: int) -> torch.Tensor:
    """Plain torch version of ``expand_kernel``: out [nrow, F, slots],
    out[y, :, target_j] = rows[j, :F] for row y's elements j, -1 in every
    other slot."""
    nrow = starts.shape[0] - 1
    n = int(starts[-1])
    y = torch.repeat_interleave(
        torch.arange(nrow, device=rows.device),
        (starts[1:] - starts[:-1]).long())
    out = torch.full((nrow, F, slots), -1.0, dtype=torch.float32,
                     device=rows.device)
    out[y[:, None], torch.arange(F, device=rows.device)[None, :],
        rows[:n, F].long()[:, None]] = rows[:n, :F]
    return out


def expand(starts: torch.Tensor, rows: torch.Tensor,
           slots: int) -> torch.Tensor:
    """``expand_kernel`` on CUDA tensors, the plain version on CPU ones."""
    if rows.device.type == "cpu":
        return expand_plain(starts, rows, slots)
    if rows.device.type != "cuda":
        raise ValueError(f"expand takes CUDA or CPU tensors, got "
                         f"{rows.device}")
    nrow = starts.shape[0] - 1
    if rows.dim() != 2 or rows.shape[1] <= F:
        raise ValueError(f"rows has shape {tuple(rows.shape)}, expected "
                         f"[*, > {F}]")
    # the kernel loads a payload as two float4: each row must start on 16
    # bytes, so the width is refused, not loaded as scalars, where it is
    # not a multiple of 4
    if rows.shape[1] % 4:
        raise ValueError(f"rows has width {rows.shape[1]}: the kernel takes "
                         f"a multiple of 4")
    if rows.data_ptr() % 16:
        raise ValueError("rows does not start on a 16-byte boundary")
    if nrow * slots >= 2**31 // F:
        raise ValueError(f"{nrow} x {slots} slots overflow the kernel's "
                         f"int32 indexing")
    build.check_tensor("starts", starts, torch.int32, (nrow + 1,),
                       rows.device)
    build.check_tensor("rows", rows, torch.float32, rows.shape, rows.device)
    out = torch.empty(nrow, F, slots, dtype=torch.float32,
                      device=rows.device)
    err = build.library().sph_expand(
        starts.data_ptr(), rows.data_ptr(), nrow, F, slots, rows.shape[1],
        out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream)
    build.launched("expand", err)
    return out


def main() -> dict:
    """Run, check and time the expand at the script's sizes; returns
    {"elements", "rows", "slots", "ms"}."""
    nrow, s, maxr = sizes()
    dev = resolve(None)
    starts, rows, targets = synth(nrow, s, maxr)
    st = torch.as_tensor(starts, device=dev)
    rw = torch.as_tensor(rows, device=dev)
    out = expand(st, rw, s)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  oracle(starts, rows, targets, s))
    n = int(starts[-1])
    print(f"proto expand OK — {n} elements, {nrow} rows, S={s}")
    ms = time_ms(lambda: expand(st, rw, s))
    print(f"card: {ms:.4f} ms/call ({nrow} rows x {s} slots) on "
          f"{torch.cuda.get_device_name(dev)}")
    return {"elements": n, "rows": nrow, "slots": s, "ms": ms}


if __name__ == "__main__":
    main()
