"""dedup_host_mb: the megabytes (1e6 bytes) a policy dedup moves through
host memory, the run-start flags copied down (``d2h_bytes`` on
``dedup:run-starts``) and the kept positions copied up (``h2d_bytes`` on
``dedup:select``), over the program's collected stages, per staged job."""


def read(run):
    from csvplus_tpu_torch.utils.observe import telemetry

    got = [v for r in telemetry.records if r.stage.startswith("dedup:")
           for k, v in r.extra.items() if k in ("d2h_bytes", "h2d_bytes")]
    return sum(got) / 1e6 / run.staged_units if got and run.staged_units else None
