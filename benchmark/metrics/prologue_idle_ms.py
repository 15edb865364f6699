"""prologue_idle_ms (ms/frame, layer: frame prologue; moves
particle_steps_per_s): the card's idle time in the traced slice while the
innermost span the host was in is the port's ``sph.impulse.wave`` (the
wave kick that the host launches once a frame before the frame program),
divided by the slice's frames: the idle that the kick's launches leave.

    prologue_idle_ms = 1e3 * sum(idle seconds whose innermost span is
                                 sph.impulse.wave) / frames

Busy intervals and spans come from the same trace (``trace.idle_gaps``).
None where the slice holds no such span (the port's spans off, a port
without it, a configuration without a prologue)."""

SPAN = "sph.impulse.wave"


def read(sl):
    if not sl.frames or not any(n == SPAN for n, _, _ in sl.spans):
        return None
    return 1e3 * sl.idle_gaps().get(SPAN, 0.0) / sl.frames
