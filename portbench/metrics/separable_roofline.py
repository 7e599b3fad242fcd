"""The separable calls' share of their roofline: the sum of their bounds
(``bounds/``, from each call's shapes and arguments) over the device time
of every operation launched inside their spans, whatever its name, in
percent."""


def read(r):
    if r.trace is None or r.trace.window is None:
        return None
    return r.trace.roofline_pct("separable", r.bounds.get("separable", {}))
