"""The output check: what the timed frames produced, held to the plain
reference.

Each frame is an answer: the state after its substeps, from the state
before them.  A sample of the window's frames, drawn from the seed, is
checked once the window has closed: the reference runs the same substeps
from the same input state (the port's own state before that frame, which
is all a frame starts from) and the two outputs are compared row by row,
matched by ``orig_id``.  The numbers compared, each against its limit in
``limits/<cell>.json``:

- ``pos_apart``, ``vel_apart``: the share of the valid rows (fluid and
  ghost) whose position, or velocity, differs in a component by more than
  the row tolerance of the limits file.  Not the widest gap: in a sound
  frame a few rows of a splash part by far more than rounding (a pair
  nearly on top of each other turns the direction of its pressure force,
  a row within rounding of a wall is reflected on one side only), and
  their neighbours' densities follow;
- ``foam_gap``: the widest gap in foam over the valid rows.  Foam feeds
  nothing back into the motion, so only this number sees the foam of
  reassembly.  Rows aerate only where they are both below the rest density
  and moving, so in a settled cell it reads 0 on both sides and a cell
  whose readings never aerate leaves it out of its limits;
- ``order_breaks``: rows of the port's output that follow a row the
  reference's stable sort puts after them, counted over every row but the
  fluid rows that lie, in the reference's output, within the row tolerance
  for positions of a plane between two cells (in the box's frame).  The
  check lets such a row's position differ by that much, so it may sit in
  either cell and anywhere in the sort.  A row resting on a wall is one:
  the grid starts one h outside the walls, and in a rotated box the last
  bit of its box-local coordinate, which rounding anywhere in the substep
  moves, picks its cell;
- ``px_apart`` (export only): the share of the frame's pixels where a
  channel differs by more than one level between the port's image and the
  reference's image of the port's own output state, for each sampled frame
  and for the PNG file of the last frame, read back;
- ``start_rows_apart``: rows of the port's state before the first frame
  that differ from the rows the harness made (exact).

A cell compares the numbers its limits file names.  The control puts the
reference computed in the next lower precision in the port's place: the
transforms' matrix products in TF32, the export in bfloat16.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import sph, splat

Numbers = Dict[str, float]


def _aligned(st: sph.State) -> sph.State:
    """``st`` with its rows in ``orig_id`` order."""
    inv = torch.empty_like(st["orig_id"], dtype=torch.long)
    inv[st["orig_id"].long()] = torch.arange(len(inv), device=inv.device)
    return {k: v[inv] for k, v in st.items()}


def _row_gaps(a: torch.Tensor, b: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """Each row's largest absolute difference over its components."""
    d = (a[rows].float() - b[rows].float()).abs()
    return d.reshape(len(rows), -1).amax(dim=1)


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def order_breaks(out: sph.State, ref: sph.State, frame: sph.Frame,
                 tol: float) -> float:
    """Rows of ``out`` that follow a row that ``ref`` puts after them, over
    the rows but the fluid rows of ``ref`` within ``tol`` of a plane
    between two of ``frame``'s cells."""
    fluid = (ref["valid"] > 0) & (ref["ghost"] == 0)
    loose = torch.empty_like(fluid)
    loose[ref["orig_id"].long()] = fluid & (
        frame.cell_plane_gap(ref["pos"]) <= tol)
    rank = torch.empty_like(ref["orig_id"], dtype=torch.long)
    rank[ref["orig_id"].long()] = torch.arange(len(rank), device=rank.device)
    ids = out["orig_id"].long()
    seq = rank[ids[~loose[ids]]]
    return float((seq[1:] < seq[:-1]).sum())


def compare_states(out: sph.State, ref: sph.State, tol: Dict[str, float],
                   frame: sph.Frame, box_half=None) -> Numbers:
    """The numbers of one frame's output ``out`` against the reference's
    ``ref`` (both [N] rows of the same ids, ``ref`` from ``frame``);
    ``tol`` holds each row's tolerance for ``pos`` and ``vel``.  With
    ``box_half``, also the distance from the box's nearest face of the row
    with the widest velocity gap (a reading for the look at the gaps,
    compared with no limit)."""
    out = {k: v.to(ref["pos"].device) for k, v in out.items()}
    a, b = _aligned(out), _aligned(ref)
    rows = torch.nonzero(b["valid"] > 0).squeeze(1)
    dpos = _row_gaps(a["pos"], b["pos"], rows)
    dvel = _row_gaps(a["vel"], b["vel"], rows)
    # a NaN row counts as apart; the widest gaps of position, velocity and
    # density are readings for the look at the numbers, compared with no
    # limit
    nums = {"pos_gap": _max(dpos), "vel_gap": _max(dvel),
            "rho_gap": _max(_row_gaps(a["density"], b["density"], rows)),
            "foam_gap": _max(_row_gaps(a["foam"], b["foam"], rows)),
            "pos_apart": float((~(dpos <= tol["pos"])).float().mean()),
            "vel_apart": float((~(dvel <= tol["vel"])).float().mean()),
            "order_breaks": order_breaks(out, ref, frame, tol["pos"])}
    if box_half is not None and len(rows):
        half = torch.tensor(box_half, dtype=torch.float32,
                            device=dvel.device)
        p = b["pos"][rows[int(torch.argmax(dvel))]]
        nums["vel_worst_wall"] = float((half - p.abs()).min())
    return nums


def px_apart(img: np.ndarray, ref: np.ndarray) -> float:
    """Share of pixels where a channel differs by more than one level."""
    if img.shape != ref.shape:
        return 1.0
    d = np.abs(img.astype(np.int16) - ref.astype(np.int16)).max(axis=-1)
    return float(np.mean(d > 1))


def start_rows_apart(state: sph.State, made: sph.State) -> float:
    """Rows of ``state`` that differ in any field from ``made``."""
    apart = torch.zeros(len(made["pos"]), dtype=torch.bool,
                        device=made["pos"].device)
    for k, v in made.items():
        w = state[k].to(v.device)
        if w.shape != v.shape:
            return float(len(apart))
        diff = w != v
        apart |= diff.reshape(len(apart), -1).any(dim=1)
    return float(apart.sum())


def worst(rows: List[Numbers]) -> Numbers:
    """The largest reading of each number over the frames' ``rows``; a NaN
    is the worst reading there is."""
    out: Numbers = {}
    for r in rows:
        for k, v in r.items():
            out[k] = v if k not in out or not v <= out[k] else out[k]
    return out


def _image(cfg: dict, export: dict, st: sph.State, low: bool) -> np.ndarray:
    if export["drive"] != "speed" or int(export["palette"]) != 1:
        raise ValueError("the reference splat colours speed on palette 1")
    host = {k: st[k].detach().cpu().numpy()
            for k in ("pos", "vel", "valid", "ghost")}
    return splat.render(
        host["pos"], host["vel"], (host["valid"] > 0) & (host["ghost"] == 0),
        cfg["box_half"], float(export["radius_h"]) * float(cfg["h"]),
        int(export["width"]), int(export["height"]), low=low)


def frame_numbers(cfg: dict, traffic: dict, tol: Dict[str, float], samples,
                  device, png: Optional[np.ndarray] = None,
                  control: bool = False, diagnose: bool = False
                  ) -> List[Numbers]:
    """The numbers of each sampled frame.  ``samples`` are (input state,
    output state, image or None) of the port's frames, as field dicts;
    ``png`` is the last frame's PNG file read back, held to the reference's
    image of the last sample's output; ``tol`` each row's tolerance (the
    limits file's ``row_tolerance``).  With ``control`` the reference in
    the next lower precision takes the port's place."""
    frame = sph.Frame(cfg, device)
    low = sph.Frame(cfg, device, low=True) if control else None
    export = traffic.get("export")
    n = int(traffic["substeps"])
    rows = []
    for i, (inp, out, img) in enumerate(samples):
        ref = frame.run(inp, n)
        nums = compare_states(low.run(inp, n) if control else out, ref,
                              tol, frame,
                              cfg["box_half"] if diagnose else None)
        del ref
        if export:
            # the frame of the port's own output state: the render is
            # judged apart from the physics
            want = _image(cfg, export, out, False)
            got = _image(cfg, export, out, True) if control else img
            nums["px_apart"] = px_apart(got, want)
            if png is not None and i == len(samples) - 1:
                nums["px_apart"] = max(nums["px_apart"],
                                       px_apart(png, want))
        rows.append(nums)
    return rows


def verdict(numbers: Numbers, limits: Dict[str, float]) -> List[tuple]:
    """(name, value, limit, within) for every number that has a limit; a
    limit whose number is missing, or a NaN, is not within."""
    return [(k, numbers.get(k, float("nan")), lim,
             bool(numbers.get(k, float("nan")) <= lim))
            for k, lim in sorted(limits.items())]
