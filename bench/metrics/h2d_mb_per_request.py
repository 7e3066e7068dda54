"""Device: megabytes copied from host to device per page request, over
the profiled sub-window (the copies' device records over the requests
that ended at the edge inside it)."""


def read(run):
    p = run.profile
    if p is None:
        return None
    n = run.requests_between(run.profile_t0, run.profile_t1)
    if not n:
        return None
    return p["h2d_bytes"] / 1e6 / n
