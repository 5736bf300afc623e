"""The partitioned join's tier-choice predicate.

A one-function copy of ``csvplus_tpu/parallel/pjoin.py``: the plan
verifier's placement rule asks it whether a probe would take the
range-partitioned all-to-all tier, so the static model and the executor
share one threshold.  The tier itself (and the executor's call of this
predicate) comes with the multi-GPU slice; on one card no stream is
sharded, so it answers False for every probe the port runs.
"""

from __future__ import annotations


def partition_tier_selected(
    n_keys: int, *, full_width: bool = True, stream_sharded: bool = True,
    min_keys: "int | None" = None,
) -> bool:
    """A full-width probe of at least ``min_keys`` build keys by a
    mesh-sharded stream takes the partitioned tier; anything else
    broadcasts the build side."""
    if min_keys is None:
        from ..ops.join import DeviceIndex

        min_keys = DeviceIndex.PARTITION_MIN_KEYS
    return bool(full_width and stream_sharded and int(n_keys) >= int(min_keys))
