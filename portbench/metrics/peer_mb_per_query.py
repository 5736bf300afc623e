"""peer_mb_per_query: the megabytes (1e6 bytes) the program copied
between two distinct cards (the ``peer_bytes`` count on its collected
stages: the exchange, replicated tables, re-layouts and assemblies), per
staged query.  A program that counts nothing there, or whose devices
share one card, gives nothing to read."""


def read(run):
    from csvplus_tpu_torch.utils.observe import telemetry

    got = [r.extra["peer_bytes"] for r in telemetry.records if "peer_bytes" in r.extra]
    return sum(got) / 1e6 / run.staged_units if got and run.staged_units else None
