"""Launches of the port's hand-written kernels (the wrappers' own
``launches`` counters) over the window, per item issued in it.  Exact:
a route that falls to a plain PyTorch path shows here."""


def read(r):
    if not r.issued or not r.launches:
        return None
    return sum(r.launches.values()) / r.issued
