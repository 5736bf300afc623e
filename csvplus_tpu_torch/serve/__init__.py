"""Serving: the verified-plan executable cache (:mod:`.plancache`).

The reference's point-lookup server, admission control and serving
metrics are not ported yet (``ROADMAP.md``)."""

from .plancache import PlanCache, PlanRejected, plan_cache_key

__all__ = ["PlanCache", "PlanRejected", "plan_cache_key"]
