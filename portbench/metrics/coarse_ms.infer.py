"""Card milliseconds per sequence inside the program's span
``tracker.coarse``: the coarse encoder and tracker with the input's resize
(``r.program``: ``portbench.spans.ProgramReading``)."""


def read(r):
    p = getattr(r, "program", None)
    s = None if p is None else p.span_device_s("tracker.coarse")
    return None if s is None or not r.sequences else s * 1e3 / r.sequences
