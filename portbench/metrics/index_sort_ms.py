"""index_sort_ms: the program's stage ``index:sort`` (collected, so
barriered), the key sort and its gathers, per staged job."""


def read(run):
    return run.stage_ms("index:sort")
