"""The card's idle share in the untraced window, in percent: 100 x (1 -
items completed a second there x device seconds an item).  An item's
device seconds are those of every operation launched inside its calls'
spans in the traced window, over the items issued there: the profiler
slows the host, not the card's operations, so this is the idle share of
a run without it.  Where the card is saturated it reads near 0, on
either side of it by the two windows' difference in device time."""


def read(r):
    if r.trace is None or r.trace.window is None or not r.traced_items \
            or not r.latencies:
        return None
    device_s = sum(r.trace.call_device_s().values())
    if device_s <= 0.0:
        return None
    rate = len(r.latencies) / r.seconds
    return 100.0 * (1.0 - rate * device_s / r.traced_items)
