"""launches_per_query: kernels run on the card in the profiled window
over the queries completed in it (device trace)."""


def read(run):
    if run.trace is None or not run.profiled_units:
        return None
    n = run.trace.kernel_count()
    return n / run.profiled_units if n else None
