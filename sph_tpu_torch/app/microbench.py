"""Micro-benchmarks on the card (counterpart of ``scripts/microbench.py``):
the smoke kernel, then the costs of a sort, a scatter, two gathers and a
transpose at N particles and C cells.

    python -m sph_tpu_torch.app.microbench [N] [C]

N defaults to 1,000,000 and C to 2,400,000, as in the script.  The smoke
kernel (``csrc/micro.cu``, the counterpart of the script's Pallas
``smoke_kernel``) runs first on a [256, 512] array of ones and must equal
its plain version (8 everywhere); each timing is then printed in ms per
iteration, from CUDA events around 20 iterations after one warm-up.  It
needs a CUDA card: with none it raises (``core.device.resolve``).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.native import build

K = 8          # ranks per cell, as the script
REPS = 20


def smoke_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``smoke_kernel``: o = 0, then o += 2x four
    times, as the TPU grid's four visits of each block do."""
    o = torch.zeros_like(x)
    for _ in range(4):
        o = o + x * 2.0
    return o


def smoke(x: torch.Tensor) -> torch.Tensor:
    """``smoke_kernel`` on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return smoke_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"smoke takes CUDA or CPU tensors, got {x.device}")
    if x.numel() >= 2**31:
        raise ValueError(f"{x.numel()} values overflow the kernel's int32 "
                         f"indexing")
    build.check_tensor("x", x, torch.float32, x.shape, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x does not start on a 16-byte boundary: the "
                         "kernel loads float4")
    out = torch.empty_like(x)
    err = build.library().sph_smoke(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.launched("smoke", err)
    return out


def time_ms(fn, reps: int = REPS) -> float:
    """Device time per call from CUDA events, after one warm-up call; the
    card sleeps while the host enqueues, so launch overhead is hidden."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timings(n: int, c: int, dev) -> dict:
    """ms per iteration of the script's six operations (``:76-142``), on
    the script's inputs made from seed 0."""
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(np.sort(rng.integers(0, c, n)).astype(np.int32),
                           device=dev)
    fields = torch.as_tensor(np.stack(
        [rng.standard_normal(n).astype(np.float32) for _ in range(8)]),
        device=dev)                                         # [8, N]
    ranks = torch.as_tensor(rng.integers(0, K, n).astype(np.int32),
                            device=dev)
    k64, r64 = keys.long(), ranks.long()

    def sort9():
        _, idx = torch.sort(keys, stable=True)
        return fields[:, idx]

    packed = fields.t().contiguous()                        # [N, 8]
    init = torch.zeros(c * K + 1, 8, device=dev)
    slot = torch.where(r64 < K, k64 * K + r64, c * K)
    out = {"sort 9 ops": time_ms(sort9),
           "sort 2 ops (key,idx)": time_ms(
               lambda: torch.sort(keys, stable=True)),
           "scatter packed asc [N,8]": time_ms(
               lambda: init.index_put((slot,), packed))}
    del init
    table = torch.zeros(c * K, 11, device=dev)
    asc = torch.clamp_max(k64 * K + r64, c * K - 1)         # key-major
    rand = torch.clamp_max(r64 * c + k64, c * K - 1)        # rank-major
    out["gather [N,11] key-major"] = time_ms(lambda: table[asc])
    out["gather [N,11] rank-major"] = time_ms(lambda: table[rand])
    del table
    t = packed[:, None, :].expand(n, 2, 8).reshape(2 * n, 8)
    big = torch.cat([t] * max(1, (c * K) // (2 * n)), 0)    # ~[C*K, 8]
    out["transpose [C*K,8]->[8,C*K]"] = time_ms(
        lambda: big.t().contiguous())
    return out


def main(argv=None) -> dict:
    """Run the smoke check and print the timings; returns them (ms)."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    c = int(argv[1]) if len(argv) > 1 else 2_400_000
    dev = resolve(None)
    print(f"torch {torch.__version__} on {torch.cuda.get_device_name(dev)} "
          f"N={n} C={c}", file=sys.stderr)

    x = torch.ones((256, 512), dtype=torch.float32, device=dev)
    o = smoke(x)
    print("smoke:", o[:1, :4].cpu().numpy(), "(expect 8s)")
    if not torch.equal(o, smoke_plain(x)):
        raise AssertionError("smoke_kernel differs from its plain version")

    out = timings(n, c, dev)
    for name, ms in out.items():
        print(f"{name:28s} {ms:8.2f} ms/iter")
    return out


if __name__ == "__main__":
    main()
