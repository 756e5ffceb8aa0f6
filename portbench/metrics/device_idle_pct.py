"""Share of the traced window in which no operation ran on the card: 100
x (1 - the union of the device's activity intervals / the window)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.busy:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
