"""Mean host milliseconds spent issuing an item's calls (the port's
wrappers, planning and launches, and the event record), the wait on its
completion left out.  Read in the untraced window (a traced run measures
one before its traced window), so the profiler's own cost a call is not
in it."""


def read(r):
    if not r.issued:
        return None
    return r.host_issue_s / r.issued * 1e3
