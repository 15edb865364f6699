"""force_roofline (%, layer: sweeps' kernels; moves
particle_steps_per_s): the share of its roofline that the force kernel
(``csrc/sweeps.cu`` ``force_xsph_kernel``: pressure, viscosity, surface
tension, gravity, integration, XSPH and the CFL cap) reaches in the
traced slice.

The work each substep needs, for every fluid row over its sources within
h (other fluid rows, and ghosts on an active face): bytes, a fluid row
reads its position, velocity, density and cell key and writes its new
position, velocity and acceleration; a ghost row reads its position; each
cell's fluid range is read once, and its ghost range where the
configuration has ghosts.  Operations: 43 a pair for the force terms
(difference 3, squared distance 5, root 1, h - r 1, gradient 3, m/rho 1,
pressure term 4, viscosity weight 2, colour weight 1, three sums 6 + 9 +
6, Laplacian sum 1), 24 a pair for the XSPH pass (difference 3, squared
distance 5, h^2 - r^2 1, weight 3, mass weight 2, sum 9, norm 1), 70 a
row (pressure, surface tension, acceleration, integration, XSPH apply,
speed cap).

    bytes/substep = fluid * (4 * 12 + 4 + 3 * 12) + ghosts * 12
                    + (cells + 1) * 4 * (2 if ghosts else 1)
    ops/substep   = (43 + 24) * pairs(force) + 70 * fluid
    roofline = substeps * max(bytes / bandwidth, ops / float32 peak)
               / (device seconds of the kernel in the slice)

Pairs (self excluded) are counted by the harness's plain count
(``reference/pairs.py``) on the state the traced slice ends with; the
XSPH pass's pairs, taken at the moved positions, are counted as the same.
"""
from benchmark import peaks

KERNEL = "force_xsph_kernel"
BYTES_PER_FLUID_ROW = 12 + 12 + 4 + 4 + 3 * 12
BYTES_PER_GHOST_ROW = 12
BYTES_PER_CELL_RANGE = 4
OPS_PER_PAIR = 43 + 24
OPS_PER_ROW = 70


def read(sl):
    seconds, launches = sl.kernel(KERNEL)
    if launches == 0 or seconds <= 0.0:
        return None
    c, pairs = sl.counts, sl.pairs()
    ranges = 2 if c["ghosts"] else 1
    work = (c["fluid"] * BYTES_PER_FLUID_ROW
            + c["ghosts"] * BYTES_PER_GHOST_ROW
            + (c["num_cells"] + 1) * BYTES_PER_CELL_RANGE * ranges)
    ops = OPS_PER_PAIR * pairs["force"] + OPS_PER_ROW * c["fluid"]
    return 100.0 * sl.substeps * peaks.bound_s(work, ops) / seconds
