"""exchange_ms: the program's stage ``join:all_to_all`` (collected, so
barriered), the partitioned probe's exchange: route and scatter, the
key shuffle between the devices, the owners' search, the answers' way
back and the hot-key merge, every capacity attempt of it, per staged
query."""


def read(run):
    return run.stage_ms("join:all_to_all")
