"""The rank program: run saved global states on the ranks.

    python -m sph_tpu_torch.parallel.run JOBS.json --rank R --world W \\
        --backend gloo|nccl [--device cpu|cuda] --init-method file://... \\
        --out DIR

started by ``group.launch`` (``tests/test_torch_{slabs,parallel}.py``,
``dryrun.py``, ``chip_smoke.py`` phase ``parallel``).  ``JOBS.json`` is a
list of jobs, each run on every rank in turn:

- ``name``: the stem of what the job writes;
- ``engine``: ``"slab"`` (``slabs.py``) or ``"gather"`` (``domain.py``);
- ``input``: an ``.npz`` of the global run (:func:`save_input`): the state,
  params and buffers as numpy, keys ``state.<field>``, ``params.<field>``,
  ``buffers.<field>``;
- ``config``: the ``SimConfig`` fields;
- ``checkpoints``: ascending substep counts; at each, rank 0 writes the
  gathered global state to ``DIR/<name>_<k>.npz`` with ``recycled``, the
  rows the emitters respawned on every rank;
- ``ranks`` (optional): run on ranks ``0 .. ranks-1`` only.

Each rank of a job writes ``DIR/<name>_rank<r>.json``: its rows, its
launches of each kernel and its ms and host waits a substep over each
span between checkpoints (CUDA events on the card, the host clock on the
CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Mapping

import numpy as np
import torch

from sph_tpu_torch.core import convert
from sph_tpu_torch.core.params import SimConfig
from sph_tpu_torch.neighbors import cells, sweeps
from sph_tpu_torch.parallel import domain, group as G, slabs


def save_input(path: str, state: Mapping[str, np.ndarray],
               params: Mapping[str, np.ndarray],
               buffers: Mapping[str, np.ndarray]) -> str:
    """Write a global run for a job's ``input``."""
    arrays = {f"{k}.{f}": np.asarray(v)
              for k, d in (("state", state), ("params", params),
                           ("buffers", buffers))
              for f, v in d.items()}
    np.savez(path, **arrays)
    return path


def load_input(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    with np.load(path) as z:
        out: Dict[str, Dict[str, np.ndarray]] = {
            "state": {}, "params": {}, "buffers": {}}
        for key in z.files:
            part, field = key.split(".", 1)
            out[part][field] = z[key]
    return out


def config_of(fields: Mapping) -> SimConfig:
    d = dict(fields)
    for k in ("grid_dims", "terrain_res"):
        if k in d:
            d[k] = tuple(d[k])
    return SimConfig(**d)


def _launch_counts() -> Dict[str, int]:
    return {**cells.LAUNCHES, **sweeps.LAUNCHES}


class _Clock:
    """ms over a span of work: CUDA events on the card, else the host
    clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def run_job(job: Mapping, group: G.Group, out: str) -> None:
    ranks = job.get("ranks", group.world)
    g = group if ranks == group.world else group.subgroup(ranks)
    if g is None:
        return
    run = load_input(job["input"])
    config = config_of(job["config"])
    slab = job["engine"] == "slab"
    scfg = slabs.make_slab_config(config, g.world) if slab else None
    state, params, buffers = convert.shard_from_numpy(
        run["state"], run["params"], run["buffers"], g.rank, g.world, scfg,
        device=g.device)
    dt = params.dt
    cells.reset_launches()
    sweeps.reset_launches()
    clock = _Clock(g.device)
    stats: Dict[str, List] = {"rows": [], "ms_per_substep": [],
                              "waits_per_substep": []}
    done = 0
    aux = slabs.prepare(state, params, dt, scfg, g) if slab else None
    for k in job["checkpoints"]:
        waits = g.waits
        clock.start()
        for _ in range(k - done):
            if slab:
                state, buffers = slabs.substep(state, params, buffers, dt,
                                               config, scfg, g, aux)
            else:
                state, buffers = domain.substep(state, params, buffers, dt,
                                                config, g)
        ms = clock.stop()
        stats["ms_per_substep"].append(ms / max(k - done, 1))
        stats["waits_per_substep"].append((g.waits - waits)
                                          / max(k - done, 1))
        stats["rows"].append(state.n)
        done = k
        whole = convert.gathered_to_numpy(state, g)
        total = slabs.recycled(buffers, g)
        if whole is not None:
            np.savez(os.path.join(out, f"{job['name']}_{k}.npz"),
                     recycled=np.int64(total),
                     **{f"state.{f}": v for f, v in whole.items()})
    stats["launches"] = _launch_counts()
    with open(os.path.join(out, f"{job['name']}_rank{g.rank}.json"),
              "w") as f:
        json.dump(stats, f)


def read_state(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's global state (numpy, by field) and ``recycled``."""
    with np.load(path) as z:
        out = {k.split(".", 1)[1]: z[k] for k in z.files
               if k.startswith("state.")}
        out["recycled"] = int(z["recycled"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jobs")
    G.add_rank_args(ap)
    ns = ap.parse_args(argv)
    group = G.init_from_args(ns)
    try:
        if group.device.type == "cuda":
            from sph_tpu_torch.native import build
            build.library()
        with open(ns.jobs) as f:
            jobs = json.load(f)
        for job in jobs:
            run_job(job, group, ns.out)
    finally:
        G.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
