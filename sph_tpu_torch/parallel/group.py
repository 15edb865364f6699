"""Ranks over ``torch.distributed``: start them, join them, move rows
between them (the counterpart of ``make_mesh`` / ``make_mesh_slabs``,
``sph_tpu/parallel/domain.py:36-40``, ``slabs.py:57-61``, and of
``__graft_entry__``'s re-exec into a clean process).

The JAX package runs one SPMD program over a mesh of devices; the port runs
one process a rank.  :func:`launch` starts ``world`` rank processes of a
module (``python -m ...``) with :func:`add_rank_args`' options and returns
their exit codes and the files they wrote; each rank calls
:func:`init_from_args` (or :func:`init`) and gets a :class:`Group`.

A :class:`Group` moves rows addressed by destination rank: the ranks first
trade their per-destination counts (one ``[world]`` integer tensor through
``all_to_all_single``, the one host wait of a transfer), then the rows with
``input_split_sizes`` / ``output_split_sizes``.  The messages have no fixed
size, because the port's cell engine has no per-cell capacity (ROADMAP
R17); the JAX package ships fixed-capacity buffers instead
(``slabs.py:64-103``).  That one transport serves the halo, the +-1
migration, the router and ``gather_global``.

Backends: NCCL between cards, one rank a card (NCCL refuses two ranks of a
communicator on one device, so more ranks than cards raises); gloo between
CPU processes, or between processes that share a card.  Gloo's collectives
take host tensors, so with gloo a CUDA tensor is staged through host memory
for the transfer while the compute stays on the card.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import time
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from sph_tpu_torch.core.device import resolve

BACKENDS = ("gloo", "nccl")
# A collective that waits longer than this for a peer raises: a rank that
# died must not leave the others blocked until the backend's own 30 minutes.
COLLECTIVE_TIMEOUT_S = 300

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Splits(NamedTuple):
    """Rows a rank sends to and receives from each rank, on the host."""
    send: List[int]
    recv: List[int]


class Group:
    """A set of ranks and the device of this rank's tensors.

    ``waits`` counts the transfers that waited for the device from the host
    (a count brought to the host, or a CUDA tensor staged for gloo)."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: torch.device, pg=None):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = device
        self.pg = pg                    # None: the default group
        self.waits = 0

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend can read it."""
        if self.staged:
            self.waits += 1
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def splits(self, counts: torch.Tensor) -> Splits:
        """Trade ``counts`` [world] (rows this rank sends to each rank) for
        the rows each rank sends here; both on the host."""
        send = self._out(counts.to(torch.int64))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.pg)
        if self.device.type == "cuda" and not self.staged:
            self.waits += 1             # the counts' copy to the host
        both = torch.cat([send, recv]).tolist()
        return Splits(both[:self.world], both[self.world:])

    def exchange(self, rows: torch.Tensor, splits: Splits) -> torch.Tensor:
        """Send ``rows`` [sum(splits.send), ...], grouped by destination rank
        in rank order; return the rows received, grouped by source rank in
        rank order, [sum(splits.recv), ...]."""
        if rows.shape[0] != sum(splits.send):
            raise ValueError(f"{rows.shape[0]} rows to send, the splits say "
                             f"{sum(splits.send)}")
        src = self._out(rows.contiguous())
        out = torch.empty((sum(splits.recv), *rows.shape[1:]),
                          dtype=rows.dtype, device=src.device)
        dist.all_to_all_single(out, src, output_split_sizes=splits.recv,
                               input_split_sizes=splits.send, group=self.pg)
        return self._back(out)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each), concatenated along
        dim 0 in rank order."""
        src = self._out(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.pg)
        return self._back(torch.cat(parts))

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``."""
        src = self._out(t.clone())
        dist.all_reduce(src, group=self.pg)
        return self._back(src)

    def subgroup(self, world: int) -> Optional["Group"]:
        """The group of ranks ``0 .. world-1``, for those ranks; None for
        the others.  Every rank of this group must call it."""
        pg = dist.new_group(list(range(world)), backend=self.backend)
        if self.rank >= world:
            return None
        return Group(self.rank, world, self.backend, self.device, pg)


def init(rank: int, world: int, backend: str, init_method: str,
         device=None) -> Group:
    """Join the ``world`` ranks as ``rank`` and return the group.  The
    tensors of a rank live on ``core.device.resolve(device)`` (the card by
    default); an NCCL rank takes card ``rank`` and needs a card of its own.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}, expected one of {BACKENDS}")
    dev = resolve(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors: pass a CUDA device")
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"NCCL needs a card a rank: {world} ranks, {cards} cards "
                f"(ranks that share a card run gloo)")
        dev = torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return Group(rank, world, backend, dev)


def close() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def add_rank_args(parser: argparse.ArgumentParser) -> None:
    """The options :func:`launch` passes to each rank."""
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--backend", choices=BACKENDS, required=True)
    parser.add_argument("--device", default=None)
    parser.add_argument("--init-method", required=True)
    parser.add_argument("--out", required=True)


def init_from_args(ns: argparse.Namespace) -> Group:
    """A rank process's start: one torch thread (the ranks share the
    host's cores), then :func:`init`."""
    torch.set_num_threads(1)
    return init(ns.rank, ns.world, ns.backend, ns.init_method, ns.device)


class Launch(NamedTuple):
    codes: List[int]          # each rank's exit code, rank order
    files: List[str]          # the new files in ``out`` (no logs)
    logs: List[str]           # each rank's stdout + stderr, rank order


def launch(module: str, world: int, args: Sequence[str], out: str,
           backend: str = "gloo", device: Optional[str] = None,
           timeout: float = 600.0) -> Launch:
    """Run ``python -m module *args`` as ``world`` ranks, rank r with
    ``--rank r --world world --backend --device --init-method --out``, the
    rendezvous a file in ``out``.  Returns when every rank has exited; once
    a rank fails, or at ``timeout`` seconds, the others are killed.  Each
    rank's output goes to ``out/rank<r>.log``."""
    os.makedirs(out, exist_ok=True)
    rdv = os.path.join(out, "rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    before = set(os.listdir(out))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", module, *args, "--rank", str(r),
                   "--world", str(world), "--backend", backend,
                   "--init-method", f"file://{rdv}", "--out", out]
            if device is not None:
                cmd += ["--device", device]
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=_REPO, env=env,
                                              stdout=log,
                                              stderr=subprocess.STDOUT))
        end = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    skip = before | {os.path.basename(f) for f in logs} | {"rendezvous"}
    files = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f not in skip)
    return Launch([p.returncode for p in procs], files, logs)


def check(result: Launch) -> Launch:
    """Raise, with the failing ranks' output, unless every rank exited 0."""
    bad = [r for r, c in enumerate(result.codes) if c != 0]
    if bad:
        tails = []
        for r in bad:
            with open(result.logs[r]) as f:
                tails.append(f"--- rank {r} (exit {result.codes[r]}) ---\n"
                             + f.read()[-4000:])
        raise RuntimeError("ranks failed: " + ", ".join(map(str, bad))
                           + "\n" + "\n".join(tails))
    return result
