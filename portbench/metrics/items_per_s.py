"""Items whose completion falls in the window, over the window's
seconds."""


def read(r):
    return len(r.latencies) / r.seconds if r.latencies else None
