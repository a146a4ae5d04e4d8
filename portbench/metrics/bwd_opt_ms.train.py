"""Card milliseconds per train step outside the forward's span: the
backward (the operators' registered backwards included) and the clip and
AdamW."""


def read(r):
    if not r.units:
        return None
    step = r.trace.span_device_s("request")
    fwd = r.trace.span_device_s("forward")
    return None if step is None or fwd is None else (step - fwd) * 1e3 / r.units
