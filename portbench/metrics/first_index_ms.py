"""first_index_ms: the benchmark's span around ``index_on(key)`` and a
synchronise in set-up's first job, the first that meets the freshly
ingested table: it sorts the key's deferred lane dictionary (streamed
ingest leaves its union unsorted) before the key itself.  What a user
who deduplicates a freshly ingested file pays once per file."""


def read(run):
    got = run.spans.get("first:index_on")
    return 1e3 * got[0] if got else None
