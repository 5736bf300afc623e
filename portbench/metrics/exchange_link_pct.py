"""exchange_link_pct: the rate at which the program's copies between
cards ran, as a share of one card's NVLink rate in one direction.

The bytes are the program's own count of what a query copies between
distinct cards (``peer_bytes`` on the collected stages, per staged
query); the time is the device time of the profiled window's
peer-to-peer copies (``Memcpy PtoP``), summed and taken per profiled
query.  Copies that run at once on several links add their times, so
the share cannot pass what one link in one direction carries.  With no
peer-to-peer copy in the trace there is nothing to read.

:data:`LINK_BYTES_PER_S`: NVLink 4 on the H100 SXM, 450 GB/s per
direction (NVIDIA's H100 data sheet: 900 GB/s of NVLink bandwidth in
all, 18 links at 25 GB/s each way).
"""

COPY = "Memcpy PtoP"
LINK_BYTES_PER_S = 450e9


def read(run):
    from csvplus_tpu_torch.utils.observe import telemetry

    if run.trace is None or not run.profiled_units or not run.staged_units:
        return None
    seconds, count = run.trace.kernel_seconds(COPY)
    got = [r.extra["peer_bytes"] for r in telemetry.records if "peer_bytes" in r.extra]
    if not count or seconds <= 0 or not got:
        return None
    per_query = sum(got) / run.staged_units
    return 100.0 * per_query / LINK_BYTES_PER_S / (seconds / run.profiled_units)
