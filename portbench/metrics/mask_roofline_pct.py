"""mask_roofline_pct: the filter's least time over the mask kernel's
device time, both summed over the profiled window.

The least time of one filter is its bytes over the card's memory rate:
each of the k filtered columns read once as int32 codes and one byte of
mask written per row, (4 k + 1) n for n fact rows.  That count is fixed
here, whatever implements the filter; with no ``fused_mask_kernel`` in
the trace there is nothing to read.
"""

from portbench.peaks import peak

KERNEL = "fused_mask_kernel"


def read(run):
    rate = peak(run.card, "hbm_bytes_per_s")
    if run.trace is None or rate is None or not run.facts.get("filter_columns"):
        return None
    seconds, count = run.trace.kernel_seconds(KERNEL)
    if not count or seconds <= 0:
        return None
    least = run.profiled_units * (4 * run.facts["filter_columns"] + 1) * run.fact_rows / rate
    return 100.0 * least / seconds
