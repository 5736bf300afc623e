"""join_gather_ms: the program's stages ``join:expand`` and
``join:merge`` (collected, so barriered), per staged query."""


def read(run):
    return run.stage_ms("join:expand", "join:merge")
