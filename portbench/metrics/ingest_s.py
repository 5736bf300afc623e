"""ingest_s: the benchmark's span around set-up's ``on_device()`` of the
fact file, ended by a synchronise."""


def read(run):
    got = run.spans.get("ingest")
    return got[0] if got else None
