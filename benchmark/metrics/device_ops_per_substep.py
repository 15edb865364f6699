"""device_ops_per_substep (ops/substep, layer: substep loop; moves
particle_steps_per_s): device operations (kernels, copies, fills) in the
traced slice over the substeps it ran.  Each is a node of the frame
program or a launch around it, with a gap of its own."""


def read(sl):
    if not sl.device_ops or sl.substeps == 0:
        return None
    return len(sl.device_ops) / sl.substeps
