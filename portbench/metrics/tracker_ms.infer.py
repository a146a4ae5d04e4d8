"""Card milliseconds per sequence inside the tracker span (the coarse and
fine trackers, their encoders, correlation sampling and the score)."""


def read(r):
    s = r.trace.span_device_s("tracker")
    return None if s is None or not r.sequences else s * 1e3 / r.sequences
