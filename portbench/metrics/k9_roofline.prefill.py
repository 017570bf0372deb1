"""K9's share of its roofline in the prefill: the kept assignments' products
and each hit expert's weights once, over K9's kernel time."""


def read(w):
    return w.roofline("k9", "expert products K9")
