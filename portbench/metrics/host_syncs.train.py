"""Host synchronisations per train step issued inside the program's spans,
counted by the full part's recording (``r.program``:
``portbench.spans.ProgramReading``)."""


def read(r):
    p = getattr(r, "program", None)
    return None if p is None or not r.units else p.host_syncs() / r.units
