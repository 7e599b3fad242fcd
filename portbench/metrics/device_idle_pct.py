"""100 x (1 - the union of all device activity (kernels, copies, sets)
within the traced window / the window's length).  The profiler's host
cost a call is in it, so it compares traced runs with traced runs;
``untraced_idle_pct`` is the share without the profiler."""


def read(r):
    if r.trace is None or r.trace.window is None or not r.trace.device:
        return None
    lo, hi = r.trace.window
    return 100.0 * (1.0 - r.trace.busy_s(lo, hi) / (hi - lo))
