"""Card milliseconds per sequence inside the camera span (the DINOv2 ViT,
the aggregator, trajectory fusion, the trunk and the heads)."""


def read(r):
    s = r.trace.span_device_s("camera")
    return None if s is None or not r.sequences else s * 1e3 / r.sequences
