"""``device_idle_share.train``: the share of the traced stretch of training
in which no operation ran on the card (1 minus the union of the device's
operation intervals over the stretch), in percent."""


def read(run):
    tr = run.traced
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
