"""device_idle.learn: the share of the traced window in which no kernel,
copy or fill ran on the card, in percent."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.intervals:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
