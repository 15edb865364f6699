"""aux_host_ms (ms/frame, layer: frame program; moves
particle_steps_per_s): the host's wall time in the port's span
``sph.neighbor_aux`` (``engine/step.neighbor_aux``: the per-frame aux
built outside the frame program, the ghost structure among it), summed
over the traced slice and divided by its frames.

    aux_host_ms = 1e3 * sum(sph.neighbor_aux seconds) / frames

None where the slice holds no such span (the port's spans off, or a path
without the aux)."""

SPAN = "sph.neighbor_aux"


def read(sl):
    s = sl.span_seconds(SPAN)
    return 1e3 * sum(s) / sl.frames if s and sl.frames else None
