"""Origin server: milliseconds per flush in ``BrTPFServer.handle_batch``
(selectors, kernel launches, and the copies back), mean over the
flushes that ended in the window."""


def read(run):
    spans = run.window_spans("handle_batch")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
