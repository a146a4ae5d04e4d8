"""Share of their roofline that the port's kernels reach: the least time of
every ``comet::`` operator call in the traced window (its operations and
bytes from its shapes, ``portbench/reference/flops.py``) over the card time
of the kernels it launched, in percent."""


def read(r):
    got = r.trace.operator_roofline()
    return None if got is None else 100.0 * got[0] / got[1]
