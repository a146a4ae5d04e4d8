"""Card milliseconds per train step inside the program's span
``train.optimizer``: the clip, AdamW and the scheduler (``r.program``:
``portbench.spans.ProgramReading``)."""


def read(r):
    p = getattr(r, "program", None)
    s = None if p is None else p.span_device_s("train.optimizer")
    return None if s is None or not r.units else s * 1e3 / r.units
