"""The device's idle share of the traced window: 1 - (the union of its
kernels', copies' and sets' intervals) / (the window), in per cent."""


def read(rec):
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
