"""Share of the traced window in which no device operation ran."""


def read(w):
    return w.idle()
