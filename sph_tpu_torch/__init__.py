"""sph_tpu_torch — the SPH engine of ``sph_tpu`` in PyTorch, with CUDA
kernels written by hand for the NVIDIA H100 (``sm_90a``).

``sph_tpu/`` (JAX/XLA/Pallas) is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

    core/       FluidParams, SimConfig, ParticleState, spawn, numpy import
    physics/    smoothing kernels, pointwise SPH math, all-pairs oracle,
                box container
    neighbors/  cell keys, sort and cell ranges; the density and
                force + XSPH sweeps (CUDA kernel + plain torch version)
    csrc/       the CUDA C++ sources of the sweep kernels
    native/     nvcc build + ctypes loading of csrc/
    engine/     substep composition and the substep loop
    app/        the bench configurations

The engine has no learnable weights: state and parameters are dataclasses
of tensors, every function takes its device from its inputs, and nothing
here imports JAX.
"""

__version__ = "0.1.0"
