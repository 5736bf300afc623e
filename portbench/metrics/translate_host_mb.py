"""translate_host_mb: the megabytes (1e6 bytes) the join's probe
translation sends up from host memory (the ``h2d_bytes`` count on the
program's collected ``join:translate`` stages: a host translation
table, 4 bytes a probe-dictionary entry), per staged query.  A
translation cached or computed on the card moves it to 0.  A program
that counts nothing there gives nothing to read."""


def read(run):
    from csvplus_tpu_torch.utils.observe import telemetry

    got = [r.extra["h2d_bytes"] for r in telemetry.records
           if r.stage == "join:translate" and "h2d_bytes" in r.extra]
    return sum(got) / 1e6 / run.staged_units if got and run.staged_units else None
