"""Build ``csrc/*.cu`` with nvcc, and the host C++ of ``native/`` (the
splat and triangle rasterizers, the audio core) with g++, and load them
with ctypes.

Counterpart of ``sph_tpu/native/__init__.py:23-51``, with no fallback:
a missing compiler or a failed build raises.  Each library is built at
first use into ``sph_tpu_torch/_build/``, named by a hash of its sources
and flags, so an edited source builds anew and an unchanged one is
loaded as it is.  Each ``.cu`` is compiled by its own ``nvcc``, all at
once, and the objects are then linked into one shared library.  The
kernel wrappers share its input check and its launch count
(:func:`check_tensor`, :func:`launched`): every kernel launch is counted
there, as the ``utils/trace`` counter ``launches.<kernel>``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

from sph_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# the host libraries' flags, as sph_tpu/native/__init__.py:34
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


CELL_MAX_WIDE, CELL_MAX_NARROW = 4, 12


class CellColumnsC(ctypes.Structure):
    """ctypes mirror of ``SphCellColumns`` in ``csrc/cells.h``: the columns
    that one cell-table launch moves, [*, 3] ones and [*] ones."""
    _fields_ = [("wide_in", ctypes.c_void_p * CELL_MAX_WIDE),
                ("wide_out", ctypes.c_void_p * CELL_MAX_WIDE),
                ("narrow_in", ctypes.c_void_p * CELL_MAX_NARROW),
                ("narrow_out", ctypes.c_void_p * CELL_MAX_NARROW),
                ("wide_stride", ctypes.c_int * CELL_MAX_WIDE),
                ("narrow_stride", ctypes.c_int * CELL_MAX_NARROW),
                ("n_wide", ctypes.c_int), ("n_narrow", ctypes.c_int)]


class ContainerParamsC(ctypes.Structure):
    """ctypes mirror of ``SphContainerParams`` in ``csrc/container.h``: the
    device pointers of the FluidParams fields the container pass reads."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "center", "half", "euler_deg", "aux", "restitution", "friction",
        "rest_density", "foam_gen", "foam_vel_ref", "face_active", "trefoil")]


class ContainerRowsC(ctypes.Structure):
    """ctypes mirror of ``SphContainerRows`` in ``csrc/container.h``: the
    columns read, their strides in floats, and the columns written (null:
    not written)."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "pos", "vel", "acc", "density", "pressure", "foam", "ghost", "valid",
        "face", "npos", "nvel", "nacc", "rho", "pres")]
        + [(f"{name}_stride", ctypes.c_int) for name in (
            "pos", "vel", "acc", "density", "pressure", "foam", "npos",
            "nvel", "nacc", "rho", "pres")]
        + [(f"out_{name}", ctypes.c_void_p) for name in (
            "pos", "vel", "acc", "density", "pressure", "foam")])


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR)
                   if f.endswith((".cu", ".cuh", ".h")))
    return [os.path.join(CSRC_DIR, f) for f in names]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the kernels cannot be built")


def library_path() -> str:
    """Build the shared library if it is not built yet; return its path."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libsph_sweeps_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cus]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                for s, o in zip(cus, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in jobs]
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(jobs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (``csrc/*.cu``: the cell table, the cell
    engine's sweeps, the container pass, the all-pairs kernels and the
    micro-kernels) with its C signatures declared."""
    lib = ctypes.CDLL(library_path())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sph_cell_table.argtypes = [p, p, i, i, ctypes.POINTER(CellColumnsC),
                                   p, p]
    lib.sph_cell_table.restype = i
    # the sweep params are a device pointer (csrc/sweeps.h), the grid dims
    # three ints
    lib.sph_density.argtypes = [p, p, p, p, p, i, p, p, p, p, p, i, i, i, p,
                                p, p, i, p]
    lib.sph_density.restype = i
    # the force sweeps' last argument, the tile counter, is a device
    # pointer that may be null
    lib.sph_force_xsph.argtypes = [p, p, i, p, p, i, p, p, i, p, i, i, i, p,
                                   p, p, p, p]
    lib.sph_force_xsph.restype = i
    lib.sph_force_xsph_emit.argtypes = [p, p, i, p, p, i, p, p, i, p, i, i,
                                        i, p, p, p]
    lib.sph_force_xsph_emit.restype = i
    lib.sph_container.argtypes = [ctypes.POINTER(ContainerRowsC),
                                  ctypes.POINTER(ContainerParamsC), i, i, i,
                                  i, i, p]
    lib.sph_container.restype = i
    lib.sph_brute_density.argtypes = [p, p, i, p, p, p]
    lib.sph_brute_density.restype = i
    lib.sph_brute_force.argtypes = [p, p, p, p, p, i, p, p, p, p, p]
    lib.sph_brute_force.restype = i
    lib.sph_smoke.argtypes = [p, p, i, p]
    lib.sph_smoke.restype = i
    lib.sph_expand.argtypes = [p, p, i, i, i, i, p, p]
    lib.sph_expand.restype = i
    return lib


def host_library_path(name: str) -> str:
    """Build ``native/<name>.cpp`` with g++ if it is not built yet; return
    the shared library's path."""
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: {name}.cpp cannot be "
                           f"built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, src, "-o", lib]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def splat_library() -> ctypes.CDLL:
    """The host painter-splat rasterizers (``native/splat_raster.cpp``:
    the particle splats and the SSFR water's first pass) with their C
    signatures declared."""
    lib = ctypes.CDLL(host_library_path("splat_raster"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.splat_raster.argtypes = [i, p, p, p, p, i, i, p, i, p, p, i, p, p]
    lib.splat_raster.restype = None
    lib.ssfr_splat.argtypes = [i, p, p, p, p, p, f, i, i, p, p, p]
    lib.ssfr_splat.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def tri_library() -> ctypes.CDLL:
    """The host triangle rasterizer (``native/tri_raster.cpp``) with its C
    signature declared."""
    lib = ctypes.CDLL(host_library_path("tri_raster"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rasterize_tris.argtypes = [p, p, i, i, p, p, p, p, p, p, p,
                                   ctypes.c_int64]
    lib.rasterize_tris.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def audio_library() -> ctypes.CDLL:
    """The host band-split and envelope core (``native/audio_dsp.cpp``)
    with its C signature declared."""
    lib = ctypes.CDLL(host_library_path("audio_dsp"))
    p, i64, f = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.sph_audio_analyze.argtypes = [p, i64, p, i64, f, f, f, f, p, p, p, p]
    lib.sph_audio_analyze.restype = None
    return lib


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is what a kernel takes: ``device``, ``dtype``,
    ``shape`` and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launched(name: str, err: int) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error; else
    count it as ``launches.<name>``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    trace.count(f"launches.{name}")
