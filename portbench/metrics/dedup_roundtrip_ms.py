"""dedup_roundtrip_ms: the program's stages ``dedup:run-starts`` and
``dedup:select`` (collected, so barriered), the policy dedup's host
round trip, per staged job."""


def read(run):
    return run.stage_ms("dedup:run-starts", "dedup:select")
