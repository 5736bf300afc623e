"""dedup_policy_ms: the benchmark's span around
``resolve_duplicates(policy)`` and a synchronise, per staged job."""


def read(run):
    return run.span_ms("resolve_duplicates")
