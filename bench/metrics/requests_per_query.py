"""Client: page requests per query, over the queries that ended in the
window (complete or stopped at the request budget), from each query's
``ExecutionResult.num_requests``."""


def read(run):
    if not run.queries:
        return None
    return sum(q["requests"] for q in run.queries) / len(run.queries)
