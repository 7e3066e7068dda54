"""Selectors and store: CUDA kernel launches per page request the origin
server handled in the window (the selector's ``CudaWork.launches`` over
the server's ``Counters.num_requests``)."""


def read(run):
    if not run.server_requests:
        return None
    return run.cuda["launches"] / run.server_requests
