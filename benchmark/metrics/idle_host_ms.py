"""idle_host_ms (ms/frame, layer: device; moves particle_steps_per_s):
the card's idle time in the traced slice while the host was inside one of
the port's spans (``sph.*``, the innermost span the host was in at each
moment of a gap), divided by the slice's frames: the idle that the port's
own host work leaves, as against the harness's.

    idle_host_ms = 1e3 * sum(idle seconds whose innermost span is sph.*)
                   / frames

Busy intervals and spans come from the same trace (``trace.idle_gaps``).
None where the slice holds none of the port's spans."""
from benchmark import trace


def read(sl):
    if not sl.frames or not any(n.startswith(trace.PORT_SPANS)
                                for n, _, _ in sl.spans):
        return None
    idle = sum(v for k, v in sl.idle_gaps().items()
               if k.startswith(trace.PORT_SPANS))
    return 1e3 * idle / sl.frames
