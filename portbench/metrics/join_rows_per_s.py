"""join_rows_per_s: fact-table rows read by every query completed in the
window, over the window's seconds (host clock)."""


def read(run):
    return run.rows / run.window_s if run.window_s > 0 and run.rows else None
