"""Batching front end: requests per flush in the window, from the front
end's ``BatchStats`` (requests served by the resident-page fast path
are not batched and not counted)."""


def read(run):
    if not run.batch["flushes"]:
        return None
    return run.batch["requests"] / run.batch["flushes"]
