"""Batching front end: milliseconds from a request's arrival at
``AsyncBrTPFServer.handle`` to the start of the flush that serves it,
mean over the batched requests whose flush began in the window."""


def read(run):
    if run.instruments is None or not run.waits:
        return None
    return 1e3 * sum(run.waits) / len(run.waits)
