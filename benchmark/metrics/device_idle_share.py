"""device_idle_share (fraction, layer: device; moves
particle_steps_per_s): the share of the traced slice's wall time in which
no operation ran on the card, 1 - (union of the device operations'
intervals) / (the slice's wall time), both from the same trace."""


def read(sl):
    if sl.window_s <= 0.0:
        return None
    return 1.0 - sl.busy_s / sl.window_s
