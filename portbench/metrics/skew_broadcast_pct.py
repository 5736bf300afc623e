"""skew_broadcast_pct: the rows the partitioned probe's hot-key tier
answered by broadcast, over the rows the partitioned probe took (the
``rows_broadcast`` and ``rows_repartitioned`` counts on the program's
collected ``join:skew`` records), over the staged queries.  A run in
which no probe took the hot-key tier gives nothing to read."""


def read(run):
    from csvplus_tpu_torch.utils.observe import telemetry

    got = [(r.extra["rows_broadcast"], r.extra["rows_repartitioned"])
           for r in telemetry.records if r.stage == "join:skew"]
    total = sum(b + p for b, p in got)
    return 100.0 * sum(b for b, _ in got) / total if total and run.staged_units else None
