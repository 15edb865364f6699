"""density_roofline (%, layer: sweeps' kernels; moves
particle_steps_per_s): the share of its roofline that the density kernel
(``csrc/sweeps.cu`` ``density_kernel``) reaches in the traced slice.

The work each substep needs: for every fluid row, the poly6 sum over its
sources within h (fluid rows, itself included, and ghosts on an active
face), floored, and its pressure.  Bytes: a fluid row reads its position
and cell key and writes its density and pressure; a ghost row reads its
position; each cell's fluid range is read once, and its ghost range where
the configuration has ghosts.  Operations: 12 a pair within h (difference
3, squared distance 5, h^2 - r^2 1, cube 2, sum 1), 6 a fluid row (scale
2, floor 1, pressure 2, clamp 1).

    bytes/substep = fluid * (12 + 4 + 4 + 4) + ghosts * 12
                    + (cells + 1) * 4 * (2 if ghosts else 1)
    ops/substep   = 12 * pairs(density) + 6 * fluid
    roofline = substeps * max(bytes / bandwidth, ops / float32 peak)
               / (device seconds of the kernel in the slice)

Pairs are counted by the harness's plain count (``reference/pairs.py``)
on the state the traced slice ends with.
"""
from benchmark import peaks

KERNEL = "density_kernel"
BYTES_PER_FLUID_ROW = 12 + 4 + 4 + 4
BYTES_PER_GHOST_ROW = 12
BYTES_PER_CELL_RANGE = 4
OPS_PER_PAIR = 12
OPS_PER_ROW = 6


def read(sl):
    seconds, launches = sl.kernel(KERNEL)
    if launches == 0 or seconds <= 0.0:
        return None
    c, pairs = sl.counts, sl.pairs()
    ranges = 2 if c["ghosts"] else 1
    work = (c["fluid"] * BYTES_PER_FLUID_ROW
            + c["ghosts"] * BYTES_PER_GHOST_ROW
            + (c["num_cells"] + 1) * BYTES_PER_CELL_RANGE * ranges)
    ops = OPS_PER_PAIR * pairs["density"] + OPS_PER_ROW * c["fluid"]
    return 100.0 * sl.substeps * peaks.bound_s(work, ops) / seconds
