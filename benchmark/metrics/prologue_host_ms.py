"""prologue_host_ms (ms/frame, layer: frame prologue; moves
particle_steps_per_s): the host's wall time in the port's span
``sph.impulse.wave`` (``physics/impulses.wave_impulse``: the wave kick,
eager torch operations that the host launches once a frame before the
frame program), summed over the traced slice and divided by its frames.

    prologue_host_ms = 1e3 * sum(sph.impulse.wave seconds) / frames

None where the slice holds no such span (the port's spans off, a port
without it, a configuration without a prologue)."""

SPAN = "sph.impulse.wave"


def read(sl):
    s = sl.span_seconds(SPAN)
    if not s or not sl.frames:
        return None
    return 1e3 * sum(s) / sl.frames
