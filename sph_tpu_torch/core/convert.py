"""Carry a state or parameter set across from numpy.

Each ``*_from_numpy`` function takes a dict of numpy arrays, one per field
of ``FluidParams`` / ``ParticleState`` / ``SceneBuffers`` (the field names
are those of the ``sph_tpu`` structures), and returns the port's object
on ``device``
(the CUDA card unless the caller names another, ``core.device.resolve``);
:func:`to_numpy` is the reverse.  :func:`shard_from_numpy` gives one rank
its part of a global run, and :func:`gathered_to_numpy` brings the ranks'
rows back as one global state.
The tests use them to feed the JAX package and the port the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.core.params import FluidParams
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.engine.step import SceneBuffers
from sph_tpu_torch.parallel import domain, slabs
from sph_tpu_torch.parallel.group import Group


def _fields(cls, d: Mapping[str, np.ndarray]):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [k for k in names if k not in d]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return names


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iub":
        a = a.astype(np.int32)
    return torch.as_tensor(np.array(a, order="C"), device=device)


def params_from_numpy(d: Mapping[str, np.ndarray], device=None) -> FluidParams:
    device = resolve(device)
    vals = {k: _tensor(d[k], device) for k in _fields(FluidParams, d)
            if k != "shape_type"}
    return FluidParams(shape_type=int(np.asarray(d["shape_type"])), **vals)


def buffers_from_numpy(d: Mapping[str, np.ndarray],
                       device=None) -> SceneBuffers:
    """The JAX package's four scene buffers; the fountain's uint32 seed is
    held in int64, and the port's count of respawned rows starts at 0
    unless ``d`` has one."""
    device = resolve(device)
    return SceneBuffers(
        terrain=_tensor(d["terrain"], device),
        stencil_targets=_tensor(d["stencil_targets"], device),
        stencil_count=_tensor(d["stencil_count"], device),
        fountain_seed=torch.as_tensor(
            np.asarray(d["fountain_seed"]).astype(np.int64), device=device),
        recycled=torch.as_tensor(
            np.asarray(d.get("recycled", 0)).astype(np.int64),
            device=device))


def state_from_numpy(d: Mapping[str, np.ndarray], device=None) -> ParticleState:
    device = resolve(device)
    return ParticleState(**{k: _tensor(d[k], device)
                            for k in _fields(ParticleState, d)})


def to_numpy(obj) -> Dict[str, np.ndarray]:
    """A ``ParticleState``, ``FluidParams`` or ``SceneBuffers`` as a dict of
    numpy arrays, one per field (the reverse of the functions above)."""
    return {f.name: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


def shard_from_numpy(state: Mapping[str, np.ndarray],
                     params: Mapping[str, np.ndarray],
                     buffers: Mapping[str, np.ndarray], rank: int, world: int,
                     scfg: Optional["slabs.SlabConfig"] = None, device=None
                     ) -> Tuple[ParticleState, FluidParams, SceneBuffers]:
    """Rank ``rank``'s (state, params, buffers) of a global run given as
    numpy: the rows of its slab when ``scfg`` is given (the slab engine,
    ``slabs.shard_by_slab``), else its contiguous block of rows (the gather
    engine, ``domain.shard_state``).  Params and buffers are whole on every
    rank."""
    st = state_from_numpy(state, device)
    p = params_from_numpy(params, device)
    b = buffers_from_numpy(buffers, device)
    if scfg is None:
        return domain.shard_state(st, rank, world), p, b
    return slabs.shard_by_slab(st, p, scfg, rank), p, b


def gathered_to_numpy(state: ParticleState, group: Group,
                      root: int = 0) -> Optional[Dict[str, np.ndarray]]:
    """Every rank's rows as one global state in numpy on ``root``, ordered
    by ``orig_id`` (``slabs.gather_global``); None on the other ranks."""
    out = slabs.gather_global(state, group, root)
    return None if out is None else to_numpy(out)
