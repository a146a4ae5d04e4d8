"""Share of the device-only traced part of the window in which no operation
ran on the card: one minus the union of all device intervals over that
part's host-clock length, in percent (``trace.TracedWindow``)."""


def read(r):
    if not r.busy_s or not r.window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
