"""Seeded deterministic fault injection.

Copy of ``csvplus_tpu/resilience/faults.py``.  A process-global
:class:`FaultPlan` arms **injection sites**.  The port threads five:

* ``serve:dispatch`` — top of a dispatch cycle in the
  :class:`~csvplus_tpu_torch.serve.coalesce.LookupServer` dispatcher.  A
  ``delay`` fault here is an artificial straggler; a ``fatal`` raise is
  a dispatcher death (the hardening turns it into a typed
  :class:`~csvplus_tpu_torch.resilience.retry.ServerCrashed` for every
  pending and future request).
* ``serve:bounds`` — immediately before the coalesced batch's device
  lookup.  A ``device`` raise here is a transient device failure the
  retry/breaker machinery must absorb.
* ``exec:device`` — inside
  :func:`~csvplus_tpu_torch.columnar.exec.execute_plan_view`, before the
  stage loop, so a whole plan execution fails (and is re-executed by
  the retry wrapper from the cached executable).
* ``ingest:worker`` — top of the streamed tier's scan+encode worker
  (``native/scanner.py:_scan_encode_chunk``).  A ``crash`` raise kills
  one worker's chunk; the chunk is re-run (it is pure over the
  immutable stream context), so the worker count stays unobservable,
  and each recovery counts ``ingest.worker_recovered``.
* ``ingest:read`` — before each readahead ``f.read`` of the streamed
  tier's chunk cutter.  An ``io`` raise is an I/O error mid-file,
  surfaced as a :class:`~csvplus_tpu_torch.errors.DataSourceError` with
  the absolute 1-based record number.

* ``storage:compact``, ``storage:wal-write``, ``storage:manifest-swap``
  and ``storage:prune-sidecar`` — the mutable indexes' crash windows
  (:mod:`csvplus_tpu_torch.storage`): compaction entry and pre-swap, each
  WAL write and segment seal, either side of the manifest's rename and of
  the prune sidecar's write.

:data:`SITES` also names the reference's views site (``views:refresh``),
so a plan valid there is valid here; its module is not ported yet and
nothing fires it.

The disarmed path is one module-global ``None`` check per site
(:func:`inject`).

Determinism: firing decisions depend only on the plan (specs + seed)
and each site's HIT COUNTER, never on wall time or thread identity —
two runs of the same workload under the same plan inject identically,
and the same as the reference's.  Probability-mode specs draw from a
per-spec ``random.Random`` seeded from ``(plan seed, spec index, site)``.

Arming: :func:`install` / :func:`active` in-process, or the
``CSVPLUS_FAULTS`` environment variable (JSON, parsed at import)::

    CSVPLUS_FAULTS='{"seed": 7, "faults": [
        {"site": "serve:bounds", "at": [0, 2], "error": "device"},
        {"site": "serve:dispatch", "kind": "delay", "every": 5,
         "delay_s": 0.01}]}'

Thread model: :meth:`FaultPlan.fire` is the one mutating entry point
(hit counters, fire counts) and takes the plan lock — it is called
concurrently from the serve dispatcher and submitters.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

from ..errors import CsvPlusError
from ..utils.env import env_str

__all__ = [
    "SITES",
    "FaultPlan",
    "FaultSpec",
    "InjectedDeviceError",
    "InjectedFatalError",
    "InjectedIOError",
    "InjectedWorkerCrash",
    "active",
    "current",
    "deactivate",
    "inject",
    "install",
    "plan_from_env",
]

#: Every injection site name the reference threads (see the module docstring).
SITES = (
    "serve:dispatch",
    "serve:bounds",
    "exec:device",
    "ingest:worker",
    "ingest:read",
    "storage:compact",
    "storage:wal-write",
    "storage:manifest-swap",
    "storage:prune-sidecar",
    "views:refresh",
)


class InjectedDeviceError(CsvPlusError):
    """Transient device failure (the RESOURCE_EXHAUSTED shape): the
    retry/breaker machinery must absorb it."""


class InjectedWorkerCrash(CsvPlusError):
    """Transient death of one staged ingest worker: its chunk must be
    re-executed with the reassembler none the wiser."""


class InjectedIOError(CsvPlusError, OSError):
    """I/O failure mid-read: data-shaped, never retried — surfaced as a
    row-numbered :class:`~csvplus_tpu_torch.errors.DataSourceError`."""


class InjectedFatalError(CsvPlusError):
    """Unrecoverable failure: must surface typed to the caller (or, at
    the dispatcher site, fail every pending future as ServerCrashed)."""


_ERROR_TYPES = {
    "device": InjectedDeviceError,
    "crash": InjectedWorkerCrash,
    "io": InjectedIOError,
    "fatal": InjectedFatalError,
}


class FaultSpec:
    """One armed fault: a site plus a deterministic firing schedule.

    Exactly one of *at* (explicit 0-based hit indices), *every* (every
    Nth hit, starting at hit 0), or *p* (per-hit probability from the
    plan-seeded rng) selects WHEN it fires; *kind* selects WHAT happens
    — ``"raise"`` (an ``error`` from ``device``/``crash``/``io``/
    ``fatal``) or ``"delay"`` (sleep *delay_s*, the straggler shape).
    *max_fires* bounds total firings of this spec.
    """

    __slots__ = ("site", "kind", "error", "at", "every", "p", "max_fires", "delay_s")

    def __init__(
        self,
        site: str,
        *,
        kind: str = "raise",
        error: str = "device",
        at: Optional[Sequence[int]] = None,
        every: Optional[int] = None,
        p: Optional[float] = None,
        max_fires: Optional[int] = None,
        delay_s: float = 0.0,
    ):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (one of {SITES})")
        if kind not in ("raise", "delay"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if kind == "raise" and error not in _ERROR_TYPES:
            raise ValueError(
                f"unknown fault error {error!r} (one of {sorted(_ERROR_TYPES)})"
            )
        if sum(x is not None for x in (at, every, p)) > 1:
            raise ValueError("give at most one of at/every/p")
        self.site = site
        self.kind = kind
        self.error = error
        self.at = frozenset(int(i) for i in at) if at is not None else None
        self.every = int(every) if every is not None else None
        self.p = float(p) if p is not None else None
        self.max_fires = int(max_fires) if max_fires is not None else None
        self.delay_s = float(delay_s)

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSpec":
        d = dict(d)
        site = d.pop("site")
        return cls(site, **d)


class FaultPlan:
    """Monitor owning the per-site hit counters and firing decisions.

    Every armed :func:`inject` call lands in :meth:`fire`, which bumps
    the site's hit counter under the plan lock, asks each matching spec
    whether this hit is due, and then (outside the lock) sleeps or
    raises.  :meth:`snapshot` exports hit and fire counts for the chaos
    artifact.
    """

    def __init__(
        self,
        specs: Sequence[Union[FaultSpec, Dict]],
        seed: int = 0,
    ):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
            for s in specs
        ]
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._spec_fires = [0] * len(self.specs)
        # per-spec rng so probability specs are deterministic and
        # independent of each other and of call interleaving across specs
        self._rngs = [
            random.Random(f"{self.seed}:{i}:{s.site}")
            for i, s in enumerate(self.specs)
        ]

    def fire(self, site: str) -> None:
        """One armed hit at *site*: deterministically decide, then act.
        Raises the spec's injected error or sleeps its delay; a hit no
        spec claims returns immediately."""
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            chosen: Optional[FaultSpec] = None
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if (
                    spec.max_fires is not None
                    and self._spec_fires[i] >= spec.max_fires
                ):
                    continue
                if spec.at is not None:
                    due = hit in spec.at
                elif spec.every is not None:
                    due = spec.every > 0 and hit % spec.every == 0
                elif spec.p is not None:
                    due = self._rngs[i].random() < spec.p
                else:
                    due = True
                if due:
                    self._spec_fires[i] += 1
                    self._fired[site] = self._fired.get(site, 0) + 1
                    chosen = spec
                    break
        if chosen is None:
            return
        # armed firings are rare by construction — record each one in
        # the flight ring so a post-mortem dump names the firing site
        # (imported here, not at module top: obs is a heavier package
        # than this leaf module and the disarmed path never needs it)
        from ..obs import flight as _flight

        _flight.note(
            "fault:fired", site=site, fault_kind=chosen.kind,
            error=chosen.error if chosen.kind == "raise" else None,
            hit=hit,
        )
        if chosen.kind == "delay":
            time.sleep(chosen.delay_s)
            return
        raise _ERROR_TYPES[chosen.error](
            f"injected {chosen.error} fault at {site} (hit {hit})"
        )

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """JSON-safe injection accounting: per-site armed hits and how
        many actually fired."""
        with self._lock:
            return {"hits": dict(self._hits), "fired": dict(self._fired)}


# The process-global armed plan.  None = disarmed; the inject() fast
# path is one global load + None check (the zero-overhead discipline).
_PLAN: Optional[FaultPlan] = None
_INSTALL_LOCK = threading.Lock()


def inject(site: str) -> None:
    """The hook every injection site calls.  Disarmed: one global
    check.  Armed: route to the plan's deterministic :meth:`fire`."""
    plan = _PLAN
    if plan is not None:
        plan.fire(site)


def install(plan: Optional[FaultPlan]) -> None:
    """Arm *plan* process-wide (None disarms)."""
    global _PLAN
    with _INSTALL_LOCK:
        _PLAN = plan


def deactivate() -> None:
    """Disarm fault injection."""
    install(None)


def current() -> Optional[FaultPlan]:
    """The armed plan, or None."""
    return _PLAN


@contextlib.contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Arm *plan* for the duration of the block, then disarm."""
    install(plan)
    try:
        yield plan
    finally:
        deactivate()


def plan_from_env(env=None) -> Optional[FaultPlan]:
    """Parse ``CSVPLUS_FAULTS`` (JSON: either a list of spec dicts or
    ``{"seed": N, "faults": [...]}``) into a plan, or None when unset."""
    raw = env_str("CSVPLUS_FAULTS", env=env)
    if not raw:
        return None
    obj = json.loads(raw)
    if isinstance(obj, list):
        return FaultPlan(obj)
    return FaultPlan(obj.get("faults", []), seed=int(obj.get("seed", 0)))


# arm from the environment at import so a subprocess started with
# CSVPLUS_FAULTS set injects without code changes
_PLAN = plan_from_env()
