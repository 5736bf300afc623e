"""index_build_ms: the benchmark's span around ``index_on(key)`` and a
synchronise, per staged job."""


def read(run):
    return run.span_ms("index_on")
