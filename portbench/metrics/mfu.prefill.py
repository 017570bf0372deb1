"""The whole prefill's share of the peak: the least time of each request's
work (model FLOPs at 989 TFLOP/s, or its weight bytes at 3.35 TB/s) over
the window."""


def read(w):
    return w.mfu()
