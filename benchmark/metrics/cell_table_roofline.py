"""cell_table_roofline (%, layer: neighbour structure; moves
particle_steps_per_s): the share of its roofline that the cell table
kernel (``csrc/cells.cu`` ``cell_table_kernel``) reaches in the traced
slice.

The work each substep needs: every row of the configuration (fluid and
ghost) moved to its sorted place, and each cell's range.  A row reads its
key and its place in the order and its state (pos, vel, acc 3 x 12 bytes;
density, pressure, foam, ghost, active, face, colour group, valid, id 9 x
4 bytes) once, and writes its state once; each cell's bound is written
once.  No floating-point operation.

    bytes/substep = rows * (4 + 4 + 2 * 72) + (cells + 1) * 4
    roofline = substeps * bytes / HBM bandwidth / (device seconds of every
               launch of the kernel in the slice)

A launch that builds the static ghost table once a frame counts as time
with no work of its own: the ghosts never move.
"""
from benchmark import peaks

KERNEL = "cell_table_kernel"
BYTES_PER_ROW = 4 + 4 + 2 * (3 * 12 + 9 * 4)
BYTES_PER_CELL = 4


def read(sl):
    seconds, launches = sl.kernel(KERNEL)
    if launches == 0 or seconds <= 0.0:
        return None
    c = sl.counts
    work = ((c["fluid"] + c["ghosts"]) * BYTES_PER_ROW
            + (c["num_cells"] + 1) * BYTES_PER_CELL)
    return 100.0 * sl.substeps * peaks.bound_s(work, 0.0) / seconds
