"""K4's share of its roofline: the products over the pairs that the causal
mask and the window keep, over K4's kernel time."""


def read(w):
    return w.roofline("k4", "attention K4-K6")
