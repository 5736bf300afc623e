"""join_translate_ms: the program's stage ``join:translate`` (collected,
so barriered), summed over the traced window's staged queries, per
query."""


def read(run):
    return run.stage_ms("join:translate")
