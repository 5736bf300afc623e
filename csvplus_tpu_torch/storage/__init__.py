"""Mutable indexes: durable LSM delta tiers behind the lookup engine.

Port of ``csvplus_tpu/storage/``.  An :class:`~csvplus_tpu_torch.index.Index`
is a frozen sorted materialization; this package opens the write workload
without touching it: appended rows land as small **sorted delta tiers**
(each an ordinary Index built through the ingest + ``create_index``
path), deletes land as **tombstones** that shadow older tiers, lookups
probe base + deltas through the tiers' own ``bounds_many`` and stitch the
results per probe, and a **compactor** folds tiers with a stable
searchsorted multi-way merge in numpy (one upload per merged column, no
kernel) that swaps in atomically under readers (epoch-snapshotted tier
sets; the probe path takes no lock): everything into the base each pass,
level by level under the size-ratio policy, or as observed read
amplification (``readamp``) asks.

Read pruning: every sealed row tier carries min/max key fences and a
seeded Bloom filter (:mod:`~csvplus_tpu_torch.storage.prune`), consulted
on the host to shortlist tiers before any bounds pass; results are the
same with it on or off, and checkpointed bases persist their summaries as
``prune-*.flt`` sidecars.

Durability: construct with ``directory=`` (or recover with
``MutableIndex.open``) and every append/delete writes one checksummed
record to a segmented write-ahead log before it becomes visible, fsynced
per ``CSVPLUS_WAL_SYNC``; full merges checkpoint the base and swap
``MANIFEST.json`` atomically, so a crash at any point recovers state
checksum-equal to replaying the acked logical stream.  The files are the
reference's: either package opens a directory the other wrote.

* :mod:`~csvplus_tpu_torch.storage.lsm` — :class:`DeltaTier`,
  :class:`TierSet`, :class:`MutableIndex`, :func:`rebuild_reference`,
  :func:`index_checksums`.
* :mod:`~csvplus_tpu_torch.storage.compact` — the merge, the size-ratio
  planner and the :class:`Compactor` thread.
* :mod:`~csvplus_tpu_torch.storage.wal` — the write-ahead log.
* :mod:`~csvplus_tpu_torch.storage.manifest` — the recovery manifest.
"""

from .compact import Compactor, merge_tiers, merge_units, plan_compaction
from .lsm import (
    DeltaTier,
    MutableIndex,
    ReadAmpTracker,
    TierSet,
    index_checksums,
    rebuild_reference,
)
from .manifest import MANIFEST_NAME, ManifestError, read_manifest, write_manifest
from .prune import PruneDirectory, TierPruner, build_pruner, load_pruner, write_pruner
from .wal import Wal, WalError, wal_sync_mode

__all__ = [
    "Compactor",
    "DeltaTier",
    "MANIFEST_NAME",
    "ManifestError",
    "MutableIndex",
    "PruneDirectory",
    "ReadAmpTracker",
    "TierPruner",
    "TierSet",
    "Wal",
    "WalError",
    "build_pruner",
    "index_checksums",
    "load_pruner",
    "merge_tiers",
    "merge_units",
    "plan_compaction",
    "read_manifest",
    "rebuild_reference",
    "wal_sync_mode",
    "write_manifest",
]
