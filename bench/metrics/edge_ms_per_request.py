"""Serving edge: milliseconds per page request spent in the transport and
ASGI app outside the front end (the ``edge`` span around
``AsgiTransport.handle`` minus its child ``front`` span around
``AsyncBrTPFServer.handle``), over requests that ended in the window."""


def read(run):
    edge = run.window_spans("edge")
    if not edge:
        return None
    front = run.window_spans("front")
    own = sum(b - a for a, b in edge) - sum(b - a for a, b in front)
    return 1e3 * own / len(edge)
