"""Kernels: kept rows the selector's launches copied back from the card
per page request the origin server handled in the window (the
selector's ``CudaWork.rows_back``, counted in its ``collect`` phase, over
the server's ``Counters.num_requests``). None where the port counts no
such rows."""


def read(run):
    if "rows_back" not in run.cuda or not run.server_requests:
        return None
    return run.cuda["rows_back"] / run.server_requests
