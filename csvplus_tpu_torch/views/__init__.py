"""Live materialized views: incremental maintenance of verified plans
over mutable indexes.

Port of ``csvplus_tpu/views/``.  See :mod:`.view` for the maintenance
machinery and :mod:`.rules` for the delta-rule gate deciding which plan
shapes are registrable.  The serving integration (registration on the
LookupServer, refresh ordered after the cycle's writes, per-view metric
cells) lives in :mod:`csvplus_tpu_torch.serve`.
"""

from .rules import DELTA_OPS, ViewRejected, check_view_plan
from .view import MaterializedView, ViewSnapshot, reroot_plan

__all__ = [
    "DELTA_OPS",
    "MaterializedView",
    "ViewRejected",
    "ViewSnapshot",
    "check_view_plan",
    "reroot_plan",
]
