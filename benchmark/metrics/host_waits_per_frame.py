"""host_waits_per_frame (waits/frame, layer: frame program; moves
particle_steps_per_s): the port's counter ``host_waits`` (the frame path's
own device-to-host waits: the ghost check of ``neighbors/sweeps.prepare``,
the ``nonzero`` of ``neighbors/cells.ghost_sort``), as it moved over the
traced slice, divided by the slice's frames.  Each wait stops the host
until the card has caught up, so the next launches queue behind it.

    host_waits_per_frame = delta(host_waits) / frames

None where the slice holds no counters (the port's were not read)."""

COUNTER = "host_waits"


def read(sl):
    if sl.counters is None or not sl.frames:
        return None
    return sl.counters.get(COUNTER, 0) / sl.frames
