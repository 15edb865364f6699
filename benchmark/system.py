"""The system under test: the port ``sph_tpu_torch``, driven through its
public entry points.  This is the one module of the harness that imports
the port, and it takes from it only the system, its kernel names, its
spans and its counters.

A frame is the configuration's prologue where it names one (``prologue``:
the wave kick ``physics.impulses.wave_impulse``, launched by the host
before the frame program, as ``app/configs.frame_prologue`` does), then
``sph_tpu_torch.engine.step.run_substeps`` with the traffic's substeps (on
the card, the frame program of ``engine/graph.py``: captured at the first
frame, replayed after), then, where the traffic exports, the state
rendered by ``viz.splat.render_frame`` and written by
``viz.splat.save_png``.  The configuration's ``emit_rows`` (false unless
it says so) is the port's ``SimConfig.emit_rows``: the force sweep's
emitted-row transport.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark.reference.sph import FIELDS, wave_prologue
from sph_tpu_torch.core import params as P
from sph_tpu_torch.core import state as S
from sph_tpu_torch.engine import step
from sph_tpu_torch.native import build
from sph_tpu_torch.physics import impulses
from sph_tpu_torch.utils import trace
from sph_tpu_torch.viz import palettes
from sph_tpu_torch.viz import splat
from sph_tpu_torch.viz.camera import fit_camera

# the configuration file's keys that are FluidParams fields
PARAMS = ("h", "rest_density", "gas_constant", "viscosity", "gravity",
          "surface_tension", "dt", "foam_gen", "foam_vel_ref", "box_center",
          "box_half", "box_euler_deg", "wall_restitution", "wall_friction",
          "ghost_face_active")
DRIVES = {"height": palettes.DRIVE_HEIGHT, "speed": palettes.DRIVE_SPEED,
          "pressure": palettes.DRIVE_PRESSURE,
          "density": palettes.DRIVE_DENSITY}


class System:
    """The port built for one configuration and traffic mix on one
    device, from the rows the harness made."""

    def __init__(self, cfg: dict, traffic: dict, rows: Dict[str, np.ndarray],
                 device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.substeps = int(traffic["substeps"])
        self.export = traffic.get("export")
        self.cfg = cfg
        if cfg.get("shape", "box") != "box":
            raise ValueError("the harness builds box containers")
        self.params = P.FluidParams.default(
            device=self.device, shape_type=P.SHAPE_BOX,
            **{k: cfg[k] for k in PARAMS}).derive_mass()
        self.state0 = S.state_from_spawn(
            S.SpawnResult(count=len(rows["pos"]), **rows), device=self.device)
        dims = P.compute_grid_dims(P.SHAPE_BOX, np.asarray(cfg["box_half"]),
                                   np.asarray(cfg["box_euler_deg"]),
                                   cfg["h"], cap=int(cfg["grid_cap"]))
        self.sim = P.SimConfig(n=self.state0.n, grid_dims=dims,
                               neighbor_impl=step.engine(cfg["engine"]),
                               emit_rows=bool(cfg.get("emit_rows", False)))
        self.wave = self._wave(wave_prologue(cfg))
        self.buffers = step.SceneBuffers.create(self.sim, device=self.device)
        if self.export:
            self.viz = palettes.VizParams(
                palette_id=int(self.export["palette"]),
                color_drive=DRIVES[self.export["drive"]],
                height_min=-float(cfg["box_half"][1]),
                height_max=float(cfg["box_half"][1]))
            self.camera = fit_camera(np.asarray(cfg["box_half"], np.float32))

    def _wave(self, prologue):
        """The wave kick's arguments as tensors on the device, built once,
        so no frame copies them from the host; None without a
        prologue."""
        if prologue is None:
            return None
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                     device=self.device)
        amplitude = (float(prologue["strength"]) * float(self.params.dt)
                     * self.substeps)
        return {"amplitude": f32(amplitude),
                "wavelength": f32(float(prologue["wavelength"])),
                "phase": f32(float(prologue["phase"])),
                "direction": f32([float(x) for x in prologue["direction"]])}

    def prologue(self, state):
        """The frame's prologue: the wave kick, once a frame before its
        substeps.  Only for a configuration that names one
        (``self.wave``)."""
        return impulses.wave_impulse(state, **self.wave)

    def build(self) -> float:
        """Build (or load) the port's native libraries; the seconds it
        took.  A checkout builds them at its first run only."""
        t0 = time.perf_counter()
        if self.cuda:
            build.library()
        if self.export:
            build.splat_library()
        return time.perf_counter() - t0

    def frame(self, state):
        return step.run_substeps(state, self.params, self.buffers,
                                 self.params.dt, self.substeps, self.sim)[0]

    @staticmethod
    def trace(on: bool) -> None:
        """Switch the port's spans (``sph.*``) on or off."""
        trace.enable(on)

    @staticmethod
    def counters() -> Dict[str, int]:
        """The port's counters as they stand."""
        return trace.counters()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def render(self, state) -> np.ndarray:
        e = self.export
        return splat.render_frame(
            state, self.viz, self.camera, width=int(e["width"]),
            height=int(e["height"]),
            particle_radius=float(e["radius_h"]) * float(self.cfg["h"]))

    @staticmethod
    def save(img: np.ndarray, path: str) -> None:
        splat.save_png(img, path)

    @staticmethod
    def fields(state) -> Dict[str, torch.Tensor]:
        return {f: getattr(state, f) for f in FIELDS}
