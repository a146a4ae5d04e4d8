"""Share of their roofline that the port's kernels reach in a train step:
the least time of every ``comet::`` operator call of the traced window and
of each attention operator's registered backward (from the shapes,
``portbench/reference/flops.py``) over the card time of the kernels each
launched, in percent."""

from portbench.reference.flops import bound_s


def read(r):
    least = device = 0.0
    got = r.trace.operator_roofline()
    if got is not None:
        least, device = got
    for i, work in enumerate(r.backward_work):
        t = r.trace.span_device_s(f"vjp.{i}")
        if work is not None and t:
            least += bound_s(work[0], work[1], work[2])[0]
            device += t
    return 100.0 * least / device if device > 0 else None
