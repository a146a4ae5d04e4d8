"""Milliseconds per train step of the device-only part in which the card
was idle and the host inside one of the program's spans: the idle gaps
whose start falls inside a span (``r.program``:
``portbench.spans.ProgramReading``)."""


def read(r):
    p = getattr(r, "program", None)
    s = None if p is None else p.program_idle_s()
    return None if s is None or not p.device_units else s * 1e3 / p.device_units
