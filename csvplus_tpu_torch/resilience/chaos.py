"""The chaos gate: a seeded fault-injection differential over the port's
recovery ladder (the port of the root ``chaos.py``, ``make chaos``).

Ten cases run seeded fault schedules against the four workload shapes —
serve load, K-worker streamed ingest, the 8-shard mesh join, and the
mutable index's compactor, WAL and views — and hold recovery to the
differential contract:

* where recovery is possible (transient device faults within the retry
  budget, the breaker's host oracle, crashed ingest workers) the results
  must equal the fault-free run's bitwise, with no binary built or loaded
  again on the retry path (:class:`~..obs.recompile.RecompileWatch`);
* where it is not (fatal faults, a dispatcher crash, I/O errors) the
  failure must surface as its typed error: ``ServerCrashed`` for every
  pending future within 1 s of a dispatcher crash, a row-numbered
  ``DataSourceError`` for source I/O; never a hang or a silent wrong
  answer.  Every case runs under a watchdog (:func:`with_timeout`), so a
  hang is a failed case, not a stuck gate;
* a dispatcher crash and a ``views:refresh`` crash each leave a flight
  dump that parses and names the firing fault site;
* the disarmed injection hooks cost at most 1 % of a served request.

The cases, their fault schedules (sites, ``at`` lists, ``every``,
errors, seeds) and their outcome keys are the reference's.  Every case
takes a *device* (``"cuda"`` by default; ``"cpu"`` only when asked, and
``"cuda"`` with no card raises) and its sizes, whose defaults are the
reference's; ``chip_smoke.py`` (phase 17) passes the state its earlier
phases built at BASELINE sizes.  On a CUDA device each case also checks
what the CPU cannot show (:class:`DeviceChecks`): every mask and pack
launch inside it is replayed against the kernel's plain version, and a
case whose contract is recovery must leave the allocated device bytes
within 1 MiB of their reading after the fault-free run.

Run it as ``python -m csvplus_tpu_torch.resilience.chaos [--device cuda]
[--case-timeout S] [--out PATH]``: diagnostics go to stderr, stdout gets
one compact JSON line, the full record goes only to ``--out``, and the
exit status is 1 when any case fails.  The WAL crash matrix runs this
module as its child process (``--wal-child``)."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

#: Watchdog bound per case, seconds (``--case-timeout``): a case that
#: cannot finish inside this is a hang.
CASE_TIMEOUT_S = 120.0
#: Disarmed-hook budget: the serve path's injection sites may cost at
#: most this share of one served request.
OVERHEAD_BUDGET_PCT = 1.0
#: How far the allocated device bytes may end above their reading after
#: the fault-free run once a recovered case dropped its results.
MEMORY_SLACK_BYTES = 1 << 20
#: Seconds any single future, drain or child may take before the case fails.
WAIT_S = 30.0

CASES = (
    "serve_retry",
    "serve_degrade",
    "dispatcher_crash",
    "ingest_crash_recovery",
    "ingest_read_fault_typed",
    "mesh_join_under_ingest_faults",
    "storage_compact_crash",
    "wal_crash_matrix",
    "view_refresh_crash",
    "disarmed_overhead",
)


def _log(msg: str) -> None:
    sys.stderr.write(msg + "\n")


def with_timeout(name: str, fn: Callable[[], dict], timeout: float = CASE_TIMEOUT_S,
                 log: Callable[[str], None] = _log) -> dict:
    """Run one case on a daemon thread under the watchdog and return its
    record; a timeout or an escaping exception is a recorded failure,
    never a hang of the gate itself."""
    box: dict = {}

    def run():
        try:
            box["result"] = fn()
        except BaseException as e:  # recorded and failed: the gate must finish
            box["error"] = f"{type(e).__name__}: {e}"

    t0 = time.perf_counter()
    th = threading.Thread(target=run, name=f"chaos-{name}", daemon=True)
    th.start()
    th.join(timeout)
    elapsed = time.perf_counter() - t0
    if th.is_alive():
        rec = {"ok": False, "error": f"timeout after {timeout}s (hang)"}
    elif "error" in box:
        rec = {"ok": False, "error": box["error"]}
    else:
        rec = dict(box["result"])
        rec.setdefault("ok", True)
    rec["seconds"] = round(elapsed, 3)
    status = "ok" if rec["ok"] else f"FAIL ({rec.get('error', 'contract')})"
    log(f"chaos[{name}]: {status} in {elapsed:.2f}s")
    return rec


def _device(device) -> "object":
    """*device* as a torch device; ``"cuda"`` with no card raises."""
    from ..columnar.table import resolve_device

    return resolve_device(device)


def _is_cuda(device) -> bool:
    return _device(device).type == "cuda"


def _quiet(msg: str) -> None:
    return None


# ---- what a CUDA device adds to every case ----------------------------------


class DeviceChecks:
    """The checks a case makes beyond the reference's on a CUDA device.

    Inside ``with DeviceChecks(device):`` every call to the mask and the
    pack kernels' wrappers is recorded (``obs/replay.py``); each
    :meth:`reading` first replays the records so far against the plain
    versions, bitwise, and drops them, then collects garbage and reads
    ``torch.cuda.memory_allocated``.  A recovery case takes
    :meth:`mark_oracle` after its fault-free run and :meth:`mark_faulted`
    after its faulted run has dropped its results; :attr:`ok` is False
    when the second reading is more than :data:`MEMORY_SLACK_BYTES` above
    the first.  The launches each kernel made for the case itself (not
    for the replays) add up in :attr:`launches`.  *audit* (default: on a
    CUDA device) turns the recording off for a caller that records the
    same calls itself; *memory* (default: on a CUDA device) the
    readings."""

    def __init__(self, device, audit: Optional[bool] = None, memory: Optional[bool] = None):
        self.device = _device(device)
        cuda = self.device.type == "cuda"
        self.audit = cuda if audit is None else bool(audit)
        self.memory = cuda if memory is None else bool(memory) and cuda
        self.before: Optional[int] = None
        self.after: Optional[int] = None
        self.launches = {"mask": 0, "pack": 0}
        self.replayed = {"mask": 0, "pack": 0}
        self.max_abs_err = 0
        self._stack: Optional[contextlib.ExitStack] = None
        self._masks: List = []
        self._packs: List = []
        self._marks = (0, 0)

    def _counts(self):
        from ..ops import mask as M
        from ..ops import parse as P

        return M.launches, P.launches

    def __enter__(self) -> "DeviceChecks":
        if self.audit:
            from ..obs import replay

            self._stack = contextlib.ExitStack()
            self._stack.enter_context(replay.recorded_mask_calls(self._masks))
            self._stack.enter_context(replay.recorded_pack_calls(self._packs))
            self._marks = self._counts()
        return self

    def __exit__(self, *exc) -> None:
        if self._stack is None:
            return
        try:
            if exc[0] is None:
                self.flush()
        finally:
            self._masks.clear()
            self._packs.clear()
            self._stack.close()
            self._stack = None

    def flush(self) -> None:
        """Replay every call recorded so far against the plain versions
        (raises on a difference) and drop the records."""
        if not self.audit:
            return
        from ..obs import replay

        mask_now, pack_now = self._counts()
        pack_launches = pack_now - self._marks[1]
        self.launches["mask"] += mask_now - self._marks[0]
        self.launches["pack"] += pack_launches
        m = replay.check_path_masks(self._masks, "chaos mask calls", log=_quiet)
        p = replay.check_path_packs(self._packs, "chaos pack calls", pack_launches,
                                    self.device.type, log=_quiet)
        self.replayed["mask"] += m["cases"]
        self.replayed["pack"] += p["cases"]
        self.max_abs_err = max(self.max_abs_err, m["max_abs_err"], p["max_abs_err"])
        self._marks = self._counts()  # the replays' own launches are not the case's

    def reading(self) -> Optional[int]:
        """Replay and drop the records, collect garbage, and read the
        allocated device bytes (None off a CUDA device)."""
        self.flush()
        gc.collect()
        if not self.memory:
            return None
        import torch

        torch.cuda.synchronize(self.device)
        return int(torch.cuda.memory_allocated(self.device))

    def mark_oracle(self) -> None:
        self.before = self.reading()

    def mark_faulted(self) -> None:
        self.after = self.reading()

    @property
    def ok(self) -> bool:
        if self.before is None or self.after is None:
            return True
        return self.after - self.before <= MEMORY_SLACK_BYTES

    def record(self) -> dict:
        out = {"device": str(self.device)}
        if self.memory:
            out["memory"] = {"allocated_after_oracle": self.before,
                             "allocated_after_faulted": self.after,
                             "ok": self.ok}
        if self.audit:
            out["kernel_replay"] = {"launches": dict(self.launches),
                                    "replayed": dict(self.replayed),
                                    "max_abs_err": self.max_abs_err}
        return out


def _finish(rec: dict, chk: DeviceChecks) -> dict:
    """Fold the device checks into a case record."""
    rec["device_checks"] = chk.record()
    rec["ok"] = bool(rec["ok"]) and chk.ok
    return rec


# ---- serving ----------------------------------------------------------------


def build_index(n: int = 20_000, device="cuda"):
    """The reference's served index: ``id = "c" + str(i * 7 % 3n)`` (all
    distinct), ``v = str(i)``, ``index_on("id")`` on *device*."""
    import numpy as np

    from .. import take
    from ..columnar.table import DeviceTable

    _device(device)
    ids = np.arange(n, dtype=np.int64) * 7 % (n * 3)
    t = DeviceTable.from_pylists(
        {
            "id": np.char.add("c", ids.astype(np.str_)).tolist(),
            "v": np.arange(n).astype(np.str_).tolist(),
        },
        device=device,
    )
    return take(t).index_on("id").sync(), ids


def probes_of(ids, n: int, seed: int = 0) -> List[str]:
    """*n* seeded probes over ``c<id>``, every 17th a miss."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ps = [f"c{int(v)}" for v in rng.choice(ids, n)]
    ps[::17] = ["nope"] * len(ps[::17])
    return ps


@contextlib.contextmanager
def running(srv):
    """Start *srv* and stop it on exit with a bounded drain."""
    srv.start()
    try:
        yield srv
    finally:
        srv.stop(timeout=WAIT_S)


def closed_loop(srv, probes, clients: int, timeout: float) -> "tuple[float, list]":
    """*clients* closed-loop clients, one request in flight each, the next
    submitted from the completion callback (on the dispatcher thread);
    returns (seconds, every request's rows in probe order).  A failed
    request raises."""
    per = len(probes) // clients
    results = [None] * (per * clients)
    remaining = [per * clients]
    errors = []
    done = threading.Event()

    def make_cb(slot: int, pos: int):
        def cb(fut):
            if fut.error is not None:
                errors.append(fut.error)
                done.set()
                return
            results[slot * per + pos] = fut.value
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
            elif pos + 1 < per:
                srv.submit(probes[slot * per + pos + 1], callback=make_cb(slot, pos + 1))
        return cb

    t0 = time.perf_counter()
    for c in range(clients):
        srv.submit(probes[c * per], callback=make_cb(c, 0))
    if not done.wait(timeout):
        raise AssertionError(f"closed loop: {remaining[0]} requests still open after {timeout}s")
    secs = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"closed loop: a request failed: {errors[0]!r}")
    return secs, results


def _serve_all(srv, probes, clients: int) -> list:
    """Every probe's rows: all submitted at once (the reference's load),
    or from *clients* closed-loop clients."""
    if clients:
        return closed_loop(srv, probes, clients, timeout=10 * WAIT_S)[1]
    return [f.result(timeout=WAIT_S) for f in [srv.submit(p) for p in probes]]


def _plan_rows(table) -> list:
    from .. import take

    return [dict(r) for r in take(table).to_rows()]


def case_serve_retry(idx, ids, *, device="cuda", n_probes: int = 600, clients: int = 0,
                     plan=None, audit: Optional[bool] = None) -> dict:
    """Transient device faults on the coalesced lookup (``serve:bounds``
    at hits 0, 2 and 5): absorbed by retries, results bitwise equal to
    serial fault-free ``find`` calls, no binary loaded again.  *clients*
    > 0 serves the probes from that many closed-loop clients.  *plan*
    (a plan root) adds one ``submit_plan`` retried past an
    ``exec:device`` fault, whose rows must equal its fault-free run's."""
    from ..obs.recompile import RecompileWatch
    from ..serve import LookupServer
    from . import faults
    from .faults import FaultPlan
    from .retry import RetryPolicy

    chk = DeviceChecks(device, audit)
    probes = probes_of(ids, n_probes, seed=1)
    if clients:  # each client sends the same number of requests
        probes = probes[: len(probes) // clients * clients]
    serial = [idx.find(p).to_rows() for p in probes]
    plan_rec = None
    with chk, running(LookupServer(idx)) as srv:
        srv.retry_policy = RetryPolicy(max_attempts=3, base_s=1e-4, cap_s=1e-3)
        for f in [srv.submit(p) for p in probes[:50]]:  # warm off-watch
            f.result(timeout=WAIT_S)
        plan_want = None
        if plan is not None:
            plan_want = _plan_rows(srv.submit_plan(plan).result(timeout=WAIT_S))
        chk.mark_oracle()
        with RecompileWatch(plancache=srv.plancache if plan is not None else None) as w:
            with faults.active(
                FaultPlan(
                    [{"site": "serve:bounds", "at": [0, 2, 5], "error": "device"}],
                    seed=9,
                )
            ) as fplan:
                got = _serve_all(srv, probes, clients)
            if plan is not None:
                retried0 = srv.snapshot()["retried"]
                with faults.active(
                    FaultPlan([{"site": "exec:device", "at": [0], "error": "device"}])
                ) as pplan:
                    plan_got = _plan_rows(srv.submit_plan(plan).result(timeout=WAIT_S))
                plan_rec = {
                    "bitwise_equal": plan_got == plan_want,
                    "rows": len(plan_want),
                    "retried": srv.snapshot()["retried"] - retried0,
                    "injections": pplan.snapshot(),
                }
                del plan_got
        w.assert_zero("chaos serve retries")
        equal = got == serial
        del got
        chk.mark_faulted()
        snap = srv.snapshot()
    ok = equal and snap["retried"] >= 1 and snap["failed"] == 0
    if plan_rec is not None:
        ok = ok and plan_rec["bitwise_equal"] and plan_rec["retried"] >= 1
    rec = {
        "ok": ok,
        "bitwise_equal": equal,
        "requests": len(probes),
        "recompile_observable": w.observable(),
        "injections": fplan.snapshot(),
        "metrics": {k: snap[k] for k in ("retried", "degraded", "failed")},
    }
    if plan_rec is not None:
        rec["plan"] = plan_rec
    return _finish(rec, chk)


def case_serve_degrade(idx, ids, *, device="cuda", n_probes: int = 300, above_cap=None,
                       audit: Optional[bool] = None) -> dict:
    """Retries exhaust under a 100 % device-fault schedule: the breaker
    trips onto the host oracle (bitwise parity), then half-open probing
    recovers the device path once faults stop.  *above_cap* ``(index,
    probes)``, an index over ``POINT_MIRROR_MAX_KEYS`` cells (which has
    no host oracle, by design): under the same schedule every request
    fails with its own typed error, the breaker stays closed, nothing is
    degraded, and the disarmed server answers as the index does."""
    from ..ops.join import DeviceIndex
    from ..serve import LookupServer
    from . import faults
    from .degrade import CircuitBreaker
    from .faults import FaultPlan
    from .retry import RetryPolicy

    chk = DeviceChecks(device, audit)
    probes = probes_of(ids, n_probes, seed=2)
    serial = [idx.find(p).to_rows() for p in probes]
    big = None
    if above_cap is not None:
        big_idx, big_probes = above_cap
        big_serial = [big_idx.find(p).to_rows() for p in big_probes]
    with chk:
        chk.mark_oracle()
        with running(LookupServer(idx)) as srv:
            srv.retry_policy = RetryPolicy(max_attempts=2, base_s=1e-4, cap_s=1e-3)
            srv.breaker = CircuitBreaker(threshold=2, cooldown_s=0.05)
            with faults.active(
                FaultPlan([{"site": "serve:bounds", "every": 1, "error": "device"}])
            ) as plan:
                futs = [srv.submit(p) for p in probes]
                got = [f.result(timeout=WAIT_S) for f in futs]
            snap = srv.snapshot()
            opened = srv.breaker.state == "open"
            time.sleep(0.06)  # cooldown: the next route is the half-open probe
            again = [srv.submit(p) for p in probes[:20]]
            recovered = [f.result(timeout=WAIT_S) for f in again] == serial[:20]
            closed = srv.breaker.state == "closed"
        equal = got == serial
        del got, futs, again
        if above_cap is not None:
            big = _above_cap(big_idx, big_probes, big_serial, DeviceIndex)
        chk.mark_faulted()
    ok = (equal and snap["failed"] == 0 and snap["degraded"] >= len(probes)
          and opened and recovered and closed)
    rec = {
        "ok": ok if big is None else ok and big["ok"],
        "bitwise_equal_degraded": equal,
        "breaker_opened": opened,
        "breaker_recovered": closed,
        "injections": plan.snapshot(),
        "metrics": {k: snap[k] for k in ("retried", "degraded", "failed")},
    }
    if big is not None:
        rec["above_cap"] = big
    return _finish(rec, chk)


def _above_cap(idx, probes, serial, DeviceIndex) -> dict:
    """:func:`case_serve_degrade`'s leg over the mirror cap."""
    from ..serve import LookupServer
    from . import faults
    from .degrade import CircuitBreaker
    from .faults import FaultPlan, InjectedDeviceError
    from .retry import RetryPolicy

    table = idx._impl.dev.table
    over = table.nrows * len(table.columns) > DeviceIndex.POINT_MIRROR_MAX_KEYS
    typed = 0
    with running(LookupServer(idx)) as srv:
        srv.retry_policy = RetryPolicy(max_attempts=2, base_s=1e-4, cap_s=1e-3)
        srv.breaker = CircuitBreaker(threshold=2, cooldown_s=0.05)
        with faults.active(
            FaultPlan([{"site": "serve:bounds", "every": 1, "error": "device"}])
        ) as plan:
            for f in [srv.submit(p) for p in probes]:
                try:
                    f.result(timeout=WAIT_S)
                except InjectedDeviceError:
                    typed += 1
        snap = srv.snapshot()
        breaker = srv.breaker.snapshot()
        recovered = [f.result(timeout=WAIT_S) for f in [srv.submit(p) for p in probes]] == serial
    return {
        "ok": over and typed == len(probes) and snap["degraded"] == 0
        and breaker["state"] == "closed" and breaker["opened_total"] == 0 and recovered,
        "over_cap": over,
        "requests": len(probes),
        "typed_failures": typed,
        "breaker": breaker,
        "recovered": recovered,
        "injections": plan.snapshot(),
        "metrics": {k: snap[k] for k in ("retried", "degraded", "failed")},
    }


@contextlib.contextmanager
def _flight_dir():
    """Point the crash flight recorder at a fresh directory for one case,
    restoring ``CSVPLUS_FLIGHT_DIR`` after it."""
    from ..utils.env import env_override

    d = tempfile.mkdtemp(prefix="chaos_flight_")
    with env_override({"CSVPLUS_FLIGHT_DIR": d}):
        yield d


def flight_evidence(flight_dir: str, site: str, timeout_s: float = 10.0) -> dict:
    """Parse every flight dump a crash window left in *flight_dir* and
    report whether one names *site* as a fired fault in its timeline.
    Waits out the crash thread's write: futures unblock before the dump
    finishes."""
    deadline = time.perf_counter() + timeout_s
    names: list = []
    while not names and time.perf_counter() < deadline:
        names = sorted(
            f for f in os.listdir(flight_dir)
            if f.startswith("csvplus_flight.") and f.endswith(".json")
        )
        if not names:
            time.sleep(0.01)
    parsed = 0
    named = False
    reasons = []
    for name in names:
        try:
            with open(os.path.join(flight_dir, name)) as f:
                payload = json.load(f)
        except (OSError, ValueError) as err:
            reasons.append(f"unparseable: {type(err).__name__}")
            continue
        parsed += 1
        reasons.append(payload.get("reason"))
        for ev in payload.get("events", ()):
            if ev.get("kind") == "fault:fired" and ev.get("site") == site:
                named = True
    return {
        "ok": bool(names) and parsed == len(names) and named,
        "dumps": len(names),
        "parsed": parsed,
        "reasons": reasons,
        "names_fault_site": named,
    }


def case_dispatcher_crash(idx, ids, *, device="cuda", n_requests: int = 16) -> dict:
    """A fatal fault in the dispatcher: every pending future fails with
    typed ``ServerCrashed`` in under a second; later submits fail fast at
    admission; the flight recorder leaves a parseable dump that names the
    firing fault site."""
    from ..serve import LookupServer
    from . import faults
    from .faults import FaultPlan
    from .retry import ServerCrashed

    _device(device)
    with _flight_dir() as flight_dir:
        srv = LookupServer(idx, tick_us=20_000)  # hold the doomed batch open
        srv.start()
        try:
            with faults.active(
                FaultPlan([{"site": "serve:dispatch", "at": [0], "error": "fatal"}])
            ) as plan:
                futs = []
                for v in ids[:n_requests]:
                    try:
                        futs.append(srv.submit(f"c{int(v)}"))
                    except ServerCrashed:
                        break
                t0 = time.perf_counter()
                typed = 0
                other = []
                for f in futs:
                    try:
                        f.result(timeout=1.0)
                    except ServerCrashed:
                        typed += 1
                    except BaseException as e:  # counted: the case then fails
                        other.append(type(e).__name__)
                unblock_s = time.perf_counter() - t0
            try:
                srv.submit(f"c{int(ids[0])}")
                post_typed = False
            except ServerCrashed:
                post_typed = True
            flight = flight_evidence(flight_dir, "serve:dispatch")
            rec = {
                "ok": bool(futs)
                and typed == len(futs)
                and unblock_s < 1.0
                and post_typed
                and flight["ok"],
                "pending_futures": len(futs),
                "typed_failures": typed,
                "unblock_seconds": round(unblock_s, 4),
                "post_crash_submit_typed": post_typed,
                "flight": flight,
                "injections": plan.snapshot(),
            }
            if other:
                rec["untyped_failures"] = other
            return rec
        finally:
            srv.stop(timeout=WAIT_S)


# ---- K-worker streamed ingest -----------------------------------------------


def chaos_csv(root: str, rows: int = 2000) -> str:
    """The reference's ingest file: ``k,v`` with ``k<i>,v<3i>``."""
    path = os.path.join(root, "chaos_ingest.csv")
    with open(path, "w") as f:
        f.write("k,v\n")
        for i in range(rows):
            f.write(f"k{i},v{i * 3}\n")
    return path


def stream_fold(path: str, workers: int, chunk_bytes: int = 512):
    """One staged-pipeline run folded to a comparable value: every
    chunk's names, encoded columns and record count, or the exception's
    type and message with the chunks emitted before it."""
    import numpy as np

    from .. import DataSourceError, from_file
    from ..native import scanner as native

    out = []
    try:
        for names, encoded, n in native.stream_encoded_chunks(
            from_file(path), path, chunk_bytes=chunk_bytes, workers=workers
        ):
            chunk = {}
            for c, enc in encoded.items():
                if len(enc) == 3 and enc[0] == "int":
                    chunk[c] = ("typed", enc[1], enc[2].tolist())
                else:
                    chunk[c] = (
                        "dict",
                        [bytes(x) for x in enc[0].tolist()],
                        np.asarray(enc[1]).tolist(),
                    )
            out.append((tuple(names), chunk, n))
    except DataSourceError as e:
        return ("exc", type(e).__name__, str(e), out)
    return ("ok", out)


def _stream_env(chunk_bytes: int, extra: dict) -> dict:
    return {"CSVPLUS_STREAM_MIN_BYTES": "1", "CSVPLUS_STREAM_CHUNK_BYTES": str(chunk_bytes),
            "CSVPLUS_INGEST_WORKERS": None, **extra}


def place(path: str, device, env: dict):
    """``from_file(path).on_device(device)`` under *env*, folded to
    ``("ok", positional checksums, rows, tier, K)`` or the typed error's
    ``("exc", type, message)``; the placed table is dropped."""
    from .. import DataSourceError, from_file
    from ..utils.checksum import checksum_device_table
    from ..utils.env import env_override

    with env_override(env):
        try:
            table = from_file(path).on_device(device).plan.table
        except DataSourceError as e:
            return ("exc", type(e).__name__, str(e))
    sums = checksum_device_table(table, positional=True)
    return ("ok", sums, table.nrows, table.ingest_tier,
            (table.ingest_seconds or {}).get("workers"))


def _placed_legs(workers: Sequence[int], device_parse: bool) -> list:
    # typed lanes off: every column then reaches the device chunk encoder
    legs = [("device-parse", {"CSVPLUS_DEVICE_PARSE": "1", "CSVPLUS_TYPED_LANES": "0"})] \
        if device_parse else []
    return legs + [(f"K={k}", {"CSVPLUS_DEVICE_PARSE": "0", "CSVPLUS_INGEST_WORKERS": str(k)})
                   for k in workers]


def case_ingest_crash_recovery(tmp_root: str, *, device="cuda", path: Optional[str] = None,
                               rows: int = 2000, chunk_bytes: int = 512,
                               workers: Sequence[int] = (1, 2, 4), placed: bool = False,
                               want_sums: Optional[dict] = None,
                               audit: Optional[bool] = None) -> dict:
    """Crashed scan+encode workers (``ingest:worker`` at hits 1, 3, 4 and
    9) re-run their chunks: the output equals the fault-free run's
    bitwise for every K.  By default (the reference's shape) the host
    pipeline's chunk stream is compared, chunk by chunk.  *placed*
    compares placed tables instead, by positional checksums (and against
    *want_sums* when given): first the device-parse tier with typed lanes
    off (its chunk encoder forces K = 1 and sends every column of each
    re-run chunk through the pack kernel), then ``CSVPLUS_DEVICE_PARSE=0``
    at each K in *workers*."""
    from ..ops import parse as P
    from . import faults
    from .faults import FaultPlan

    chk = DeviceChecks(device, audit)
    path = path or chaos_csv(tmp_root, rows)

    def schedule():
        return FaultPlan(
            [{"site": "ingest:worker", "at": [1, 3, 4, 9], "error": "crash"}], seed=5)

    per_k = {}
    if not placed:
        _device(device)
        oracle = stream_fold(path, workers=1, chunk_bytes=chunk_bytes)
        ok = oracle[0] == "ok" and len(oracle[1]) > 4
        for k in workers:
            with faults.active(schedule()) as plan:
                got = stream_fold(path, workers=k, chunk_bytes=chunk_bytes)
            snap = plan.snapshot()
            per_k[str(k)] = {"bitwise_equal": got == oracle, "injections": snap}
            ok = ok and got == oracle and snap["fired"].get("ingest:worker", 0) >= 1
        return {"ok": ok, "chunks": len(oracle[1]), "per_workers": per_k}

    legs = _placed_legs(workers, device_parse=True)
    with chk:
        p0 = P.launches
        oracle = place(path, device, _stream_env(chunk_bytes, legs[0][1]))
        oracle_pack = P.launches - p0
        chk.mark_oracle()
        ok = oracle[0] == "ok" and (want_sums is None or oracle[1] == want_sums)
        for name, env in legs:
            p0 = P.launches
            with faults.active(schedule()) as plan:
                got = place(path, device, _stream_env(chunk_bytes, env))
            snap = plan.snapshot()
            placed_ok = got[0] == "ok"
            per_k[name] = {"bitwise_equal": got[:3] == oracle[:3],
                           "tier": got[3] if placed_ok else None,
                           "workers": got[4] if placed_ok else None,
                           "pack_launches": P.launches - p0, "injections": snap}
            ok = ok and got[:3] == oracle[:3] and snap["fired"].get("ingest:worker", 0) >= 1
            del got
        chk.mark_faulted()
    if _is_cuda(device):  # the re-run chunks went through the pack kernel
        ok = ok and per_k["device-parse"]["pack_launches"] == oracle_pack > 0
    ok = ok and per_k["device-parse"]["workers"] == 1
    return _finish({"ok": ok, "rows": oracle[2] if oracle[0] == "ok" else None,
                    "oracle_equal": want_sums is None or oracle[1] == want_sums,
                    "per_workers": per_k}, chk)


def case_ingest_read_fault_typed(tmp_root: str, *, device="cuda", path: Optional[str] = None,
                                 rows: int = 2000, chunk_bytes: int = 512,
                                 workers: Sequence[int] = (1, 2), placed: bool = False,
                                 audit: Optional[bool] = None) -> dict:
    """An unrecoverable read I/O fault (``ingest:read`` at hit 2)
    surfaces as a row-numbered ``DataSourceError`` with the same outcome
    (message, and the chunks emitted before it) for every K, never a
    partial silent stream.  *placed* ingests onto *device* instead
    (``CSVPLUS_DEVICE_PARSE=0`` at each K in *workers*): the same error
    at every K, and no table."""
    from . import faults
    from .faults import FaultPlan

    chk = DeviceChecks(device, audit, memory=False)
    path = path or chaos_csv(tmp_root, rows)
    outcomes = {}
    with chk:
        for k in workers:
            with faults.active(
                FaultPlan([{"site": "ingest:read", "at": [2], "error": "io"}])
            ) as plan:
                if placed:
                    outcomes[k] = place(path, device, _stream_env(
                        chunk_bytes, {"CSVPLUS_DEVICE_PARSE": "0",
                                      "CSVPLUS_INGEST_WORKERS": str(k)}))
                else:
                    _device(device)
                    outcomes[k] = stream_fold(path, workers=k, chunk_bytes=chunk_bytes)
            snap = plan.snapshot()
    first = outcomes[workers[0]]
    typed = first[0] == "exc" and first[1] == "DataSourceError"
    same = all(o == first for o in outcomes.values())
    rec = {
        "ok": typed and same,
        "typed": typed,
        "k_independent": same,
        "error": first[2] if typed else None,
        "injections": snap,
    }
    return _finish(rec, chk)


# ---- the mesh join ----------------------------------------------------------


def _mesh_files(tmp_root: str) -> "tuple[str, str]":
    cust_path = os.path.join(tmp_root, "cust.csv")
    with open(cust_path, "w") as f:
        f.write("id,name\n")
        for i in range(120):
            f.write(f"u{i},name{i % 12}\n")
    orders_path = os.path.join(tmp_root, "orders.csv")
    with open(orders_path, "w") as f:
        f.write("oid,cust_id,amount\n")
        for i in range(4000):
            f.write(f"o{i},u{(i * 13) % 120},{i % 97}\n")
    return orders_path, cust_path


def case_mesh_join_under_ingest_faults(tmp_root: str, *, device="cuda", shards: int = 8,
                                       orders: Optional[str] = None,
                                       customers: Optional[str] = None,
                                       products: Optional[str] = None,
                                       chunk_bytes: int = 4096,
                                       audit: Optional[bool] = None) -> dict:
    """The sharded join (``models.workloads.sharded_join`` on a mesh of
    *shards* shards, all on *device*) under crashing ingest workers
    (``ingest:worker`` at hits 1 and 2, seed 11) in its streamed build:
    the recovered join equals the fault-free run's bitwise, and no array
    is assembled on one device.  By default (the reference's shape) 4,000
    orders join 120 customers and the rows are compared; given
    *orders*, *customers* (``id,name``) and *products* (``prod_id,...``)
    files, the three-way join ``orders.join(cust, "cust_id").join(prod)``
    is compared by positional checksums."""
    from .. import from_file, take
    from ..models import workloads as W
    from ..parallel import mesh as MM
    from ..utils.checksum import checksum_device_table
    from ..utils.env import env_override
    from . import faults
    from .faults import FaultPlan

    chk = DeviceChecks(device, audit)
    dev = str(_device(device))
    mesh = MM.make_mesh(shards, devices=[dev] * shards)
    three_way = orders is not None
    if not three_way:
        orders, customers = _mesh_files(tmp_root)

    def run_join():
        src = W.sharded_join(from_file(orders), cust, shards=shards, mesh=mesh)
        if not three_way:
            return [dict(r) for r in src.to_rows()]
        src = src.join(prod)
        table = src.to_device_table()
        return (table.nrows, checksum_device_table(table, positional=True))

    a0 = MM.assemblies["count"]
    env = {"CSVPLUS_STREAM_CHUNK_BYTES": str(chunk_bytes), "CSVPLUS_STREAM_MIN_BYTES": "1"}
    with chk:
        if three_way:  # the dimensions ingested on the device, as a user's are
            cust = from_file(customers).on_device(device).unique_index_on("id")
            prod = from_file(products).on_device(device).unique_index_on("prod_id")
        else:
            cust = take(from_file(customers)).unique_index_on("id")
            cust.on_device(device)
        with env_override(env):
            oracle = run_join()
            chk.mark_oracle()
            with faults.active(
                FaultPlan(
                    [{"site": "ingest:worker", "at": [1, 2], "error": "crash"}],
                    seed=11,
                )
            ) as plan:
                got = run_join()
            equal = got == oracle
            del got
            chk.mark_faulted()
    snap = plan.snapshot()
    n_rows = oracle[0] if three_way else len(oracle)
    assembled = MM.assemblies["count"] - a0
    return _finish({
        "ok": equal
        and (n_rows > 0 if three_way else n_rows == 4000)
        and snap["fired"].get("ingest:worker", 0) >= 1
        and assembled == 0,
        "bitwise_equal": equal,
        "rows": n_rows,
        "shards": shards,
        "assemblies": assembled,
        "injections": snap,
    }, chk)


# ---- storage: the compactor, the WAL -----------------------------------------


def case_storage_compact_crash(*, device="cuda", mi=None, key: str = "k",
                               probes: Optional[Sequence] = None, serve: bool = False,
                               audit: Optional[bool] = None) -> dict:
    """A compactor crash (``storage:compact`` fatal at entry, then in the
    pre-swap window) leaves the tier set intact (same epoch, same deltas,
    same answers), and the disarmed retry compacts to full rebuild
    parity.  By default (the reference's shape) an 800-row index gets two
    delta tiers; given *mi* (its key column *key*, a ``v`` column, and
    *probes*), two delta tiers are appended to it.  *serve* reads every
    answer through a ``LookupServer`` over the index while it crashes."""
    from ..row import Row
    from ..serve import LookupServer
    from ..source import take_rows
    from ..storage import MutableIndex, index_checksums, rebuild_reference
    from . import faults
    from .faults import FaultPlan, InjectedFatalError

    chk = DeviceChecks(device, audit)
    if mi is None:
        mi = MutableIndex.create(
            take_rows([Row({"k": f"k{i % 41:03d}", "v": f"v{i}"}) for i in range(800)]),
            ["k"],
            ingest_device=str(_device(device)),
        )
        probes = [(f"k{i:03d}",) for i in range(0, 41, 3)] + [("n5",), ("zz",)]
    mi.append_rows([{key: f"n{j}", "v": "x"} for j in range(30)])
    mi.append_rows([{key: f"m{j}", "v": "y"} for j in range(20)])
    probes = list(probes)

    with contextlib.ExitStack() as stack:
        stack.enter_context(chk)
        srv = stack.enter_context(running(LookupServer(indexes={"mut": mi}))) if serve else None

        def answers():
            if srv is not None:
                return [[dict(r) for r in srv.lookup(*p, index="mut", deadline_s=WAIT_S)]
                        for p in probes]
            return [[dict(r) for r in b] for b in mi.find_rows_many(probes)]

        before = answers()
        epoch0, deltas0 = mi.epoch, mi.delta_count
        chk.mark_oracle()
        injections = {}
        intact = True
        for hit, label in ((0, "at_entry"), (1, "pre_swap")):
            with faults.active(
                FaultPlan(
                    [{"site": "storage:compact", "at": [hit], "error": "fatal"}],
                    seed=13,
                )
            ) as plan:
                try:
                    mi.compact_once()
                    crashed = False
                except InjectedFatalError:
                    crashed = True
                injections[label] = plan.snapshot()
            after = answers()
            intact = (
                intact
                and crashed
                and mi.epoch == epoch0
                and mi.delta_count == deltas0
                and after == before
            )
            del after
        chk.mark_faulted()
        # the disarmed retry compacts clean, bitwise equal to the rebuild
        stats = mi.compact_once()
        parity = index_checksums(mi.tiers().base) == index_checksums(rebuild_reference(mi))
        same = answers() == before
    return _finish({
        "ok": intact and stats is not None and parity and same,
        "tier_set_intact_after_crashes": intact,
        "retry_compacted_deltas": None if stats is None else stats["deltas"],
        "rebuild_parity": parity,
        "served": serve,
        "injections": injections,
    }, chk)


#: window name -> (fault spec or None, expected acked ops, expected WAL
#: records replayed on recovery): the reference's crash matrix.  Hit
#: indices follow the WAL-write budget of :data:`WAL_OPS`.
CRASH_WINDOWS = {
    "wal_append": ({"site": "storage:wal-write", "at": [2], "error": "fatal"}, 2, 2),
    "wal_delete": ({"site": "storage:wal-write", "at": [3], "error": "fatal"}, 3, 3),
    "segment_seal": ({"site": "storage:wal-write", "at": [4], "error": "fatal"}, 4, 4),
    "manifest_pre_rename": (
        {"site": "storage:manifest-swap", "at": [0], "error": "fatal"}, 4, 4),
    "manifest_post_rename": (
        {"site": "storage:manifest-swap", "at": [1], "error": "fatal"}, 4, 0),
    "sidecar_pre_write": (
        {"site": "storage:prune-sidecar", "at": [0], "error": "fatal"}, 4, 4),
    "sidecar_post_write": (
        {"site": "storage:prune-sidecar", "at": [1], "error": "fatal"}, 4, 4),
    "torn_tail": (None, 7, 3),
}

#: The fixed logical op list the WAL child plays.  ``compact`` is a
#: marker, not a logical op.  WAL-write hits: op0 rows -> 0, op1 del ->
#: 1, op2 rows -> 2, op3 del -> 3, compact seals the segment -> 4, then
#: 5, 6, 7.
WAL_OPS = [
    {"op": "rows", "rows": [{"k": f"a{j:02d}", "v": f"x{j}", "w": "aw"} for j in range(12)]},
    {"op": "del", "key": ["k003"]},
    {"op": "rows", "rows": [{"k": "k003", "v": "reborn", "w": "rw"},
                            {"k": "a05", "v": "dup", "w": "dw"}]},
    {"op": "del", "key": ["a07"]},
    {"op": "compact"},
    {"op": "rows", "rows": [{"k": f"b{j:02d}", "v": f"y{j}", "w": "bw"} for j in range(8)]},
    {"op": "del", "key": ["b02"]},
    {"op": "rows", "rows": [{"k": "b02", "v": "back", "w": "zw"}]},
]

WAL_PROBES = [("k003",), ("a05",), ("b02",), ("zz",)]


def wal_base(n: int = 400, device="cpu"):
    """The crash matrix's base tier: ``k = k%03d`` over 37 keys a 400
    rows (the reference's 400 rows at the default), ``v``, ``w``; an
    index on ``k`` built on *device*."""
    import numpy as np

    from .. import take
    from ..columnar.table import DeviceTable

    i = np.arange(n)
    keys = 37 * max(1, n // 400)
    cols = {"k": [f"k{j:03d}" for j in (i % keys).tolist()],
            "v": np.char.add("v", i.astype(np.str_)).tolist(),
            "w": np.char.add("w", (i % 5).astype(np.str_)).tolist()}
    return take(DeviceTable.from_pylists(cols, device=str(_device(device)))).index_on("k").sync()


def wal_replay(acked_ops, *, mode: str = "append", base_rows: int = 400, device="cpu",
               base=None):
    """A fresh memory-only index fed exactly the acked logical stream:
    the truth a recovered directory must equal.  *base* (an index from
    :func:`wal_base`, which the replay leaves as it is) saves building
    one."""
    from ..storage import MutableIndex

    mi = MutableIndex(base if base is not None else wal_base(base_rows, device), mode=mode,
                      ingest_device=str(_device(device)))
    for op in acked_ops:
        if op["op"] == "rows":
            mi.append_rows(op["rows"])
        elif op["op"] == "del":
            mi.delete(tuple(op["key"]))
    return mi


def wal_child(workdir: str, acked_path: str, *, device="cpu", base_rows: int = 400,
              mode: str = "append", tear: bool = False) -> None:
    """The crash child: build a durable index in *workdir*, play
    :data:`WAL_OPS`, and record every acked op to *acked_path*; a fault
    armed through ``CSVPLUS_FAULTS`` kills an op mid-flight.  *tear*
    appends a torn partial frame to the active segment after the ops.
    Exits 3 when an op crashed, else 0, skipping interpreter teardown."""
    from ..storage import MutableIndex

    acked = []
    crashed = None
    try:
        mi = MutableIndex(wal_base(base_rows, device), mode=mode,
                          ingest_device=str(_device(device)), directory=workdir)
        for op in WAL_OPS:
            if op["op"] == "compact":
                mi.compact_once()  # not a logical op: never acked
            elif op["op"] == "rows":
                mi.append_rows(op["rows"])
                acked.append(op)
            else:
                mi.delete(tuple(op["key"]))
                acked.append(op)
    except Exception as exc:  # the armed crash window fires here
        crashed = f"{type(exc).__name__}: {exc}"
    if tear:
        # dying mid write(2): a frame header promising 64 bytes with
        # garbage behind it, on the active segment
        segs = sorted(n for n in os.listdir(workdir)
                      if n.startswith("wal-") and n.endswith(".log"))
        with open(os.path.join(workdir, segs[-1]), "ab") as f:
            f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefTORN")
            f.flush()
            os.fsync(f.fileno())
    with open(acked_path, "w") as f:
        json.dump({"ops": acked, "crashed": crashed}, f)
        f.flush()
        os.fsync(f.fileno())
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(3 if crashed else 0)


def start_wal_child(root: str, fault, *, device="cpu", base_rows: int = 400,
                    mode: str = "append", tear: bool = False) -> "tuple":
    """Start one crash child under ``CSVPLUS_WAL_SYNC=always`` with
    *fault* armed, its stderr in ``<root>/child.err``; returns
    ``(process, workdir, acked_path)``."""
    from ..utils.env import environ_with

    os.makedirs(root, exist_ok=True)
    workdir = os.path.join(root, "idx")
    acked_path = os.path.join(root, "acked.json")
    env = environ_with({
        "CSVPLUS_WAL_SYNC": "always",
        "CSVPLUS_FAULTS": None if fault is None else json.dumps({"faults": [fault]}),
    })
    cmd = [sys.executable, "-m", f"{__package__}.chaos", "--wal-child", workdir, acked_path,
           "--device", str(device), "--base-rows", str(base_rows), "--mode", mode]
    if tear:
        cmd.append("--tear")
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(root, "child.err"), "w") as err:
        proc = subprocess.Popen(cmd, env=env, cwd=pkg_parent, stdout=subprocess.DEVNULL,
                                stderr=err)
    return proc, workdir, acked_path


def _index_sums(mi) -> dict:
    from ..storage import index_checksums

    return index_checksums(mi.to_index())


def case_wal_crash_matrix(tmp_root: str, *, device="cuda", base_rows: int = 400,
                          timeout: float = CASE_TIMEOUT_S,
                          audit: Optional[bool] = None) -> dict:
    """The crash-restart matrix: a child process plays :data:`WAL_OPS`
    over a durable index of *base_rows* rows on *device* under
    ``CSVPLUS_WAL_SYNC=always`` and dies in each window of
    :data:`CRASH_WINDOWS` (an injected fatal at every fsync boundary of
    the write path, or a torn final frame).  Each directory, reopened on
    *device*, must recover checksums bitwise equal to a memory-only
    replay of exactly the acked ops, the reference's counts of acked ops
    and replayed records, the same answers, and no binary loaded again
    on the recovered index.  The children run at once (the reference
    runs them one by one; each takes seconds to import torch)."""
    from ..obs.recompile import RecompileWatch
    from ..storage import MutableIndex

    chk = DeviceChecks(device, audit)
    dev = str(_device(device))
    windows: Dict[str, dict] = {}
    names = sorted(CRASH_WINDOWS)
    replays: Dict[str, "tuple"] = {}
    base = None
    with chk:
        chk.mark_oracle()
        started = [(name, start_wal_child(
            os.path.join(tmp_root, f"wal-{name}"), CRASH_WINDOWS[name][0], device=dev,
            base_rows=base_rows, tear=(name == "torn_tail"))) for name in names]
        for name, (proc, workdir, acked_path) in started:
            fault, n_acked, n_replay = CRASH_WINDOWS[name]
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            rec: dict = {"exit": proc.returncode}
            try:
                with open(acked_path) as f:
                    acked = json.load(f)
                mi = MutableIndex.open(workdir, ingest_device=dev)
                key = json.dumps(acked["ops"])
                if key not in replays:
                    if base is None:
                        base = wal_base(base_rows, dev)
                    ref = wal_replay(acked["ops"], device=dev, base=base)
                    replays[key] = (_index_sums(ref), [[dict(r) for r in b]
                                                       for b in ref.find_rows_many(WAL_PROBES)])
                    del ref
                want_sums, want_answers = replays[key]
                mi.find_rows_many(WAL_PROBES)  # warm-up
                with RecompileWatch() as w:
                    got = mi.find_rows_many(WAL_PROBES)
                rec.update(
                    crashed=acked["crashed"] is not None,
                    acked=len(acked["ops"]),
                    recovered_records=mi.recovered_records,
                    truncated_bytes=mi.recovery_info["truncated_bytes"],
                    parity=_index_sums(mi) == want_sums,
                    answers=[[dict(r) for r in b] for b in got] == want_answers,
                    warm_recompiles=sum(w.delta().values()),
                )
                mi.close()
                del mi, got
                rec["ok"] = bool(
                    proc.returncode == (3 if fault is not None else 0)
                    and rec["crashed"] == (fault is not None)
                    and rec["acked"] == n_acked
                    and rec["recovered_records"] == n_replay
                    and rec["parity"]
                    and rec["answers"]
                    and rec["warm_recompiles"] == 0
                )
            except Exception as exc:  # a window that cannot recover at all
                rec["ok"] = False
                rec["error"] = f"{type(exc).__name__}: {exc}"
                with open(os.path.join(os.path.dirname(workdir), "child.err")) as f:
                    rec["stderr_tail"] = f.read()[-500:]
            windows[name] = rec
        replays.clear()
        base = None
        chk.mark_faulted()
    return _finish({
        "ok": all(v["ok"] for v in windows.values()),
        "windows_total": len(windows),
        "windows_failed": sorted(k for k, v in windows.items() if not v["ok"]),
        "windows": windows,
    }, chk)


# ---- views: the refresh crash window ----------------------------------------


def _view_setup(device):
    """The reference's view deployment: 1,500 orders, 40 customers, 12
    products, the three-way join as the view's plan."""
    from .. import plan as P
    from ..index import create_index
    from ..row import Row
    from ..source import take_rows
    from ..storage import MutableIndex

    n_cust, n_prod = 40, 12

    def order(i):
        return Row({
            "oid": f"o{i:05d}",
            "cust_id": f"c{i % n_cust:03d}",
            "prod_id": f"p{i % n_prod:03d}",
        })

    dev = str(_device(device))
    mi = MutableIndex.create(take_rows([order(i) for i in range(1500)]), ["oid"],
                             ingest_device=dev)
    cust = create_index(
        take_rows([Row({"cust_id": f"c{i:03d}", "name": f"n{i:03d}"}) for i in range(n_cust)]),
        ["cust_id"],
    )
    cust.on_device(dev)
    prod = create_index(
        take_rows([Row({"prod_id": f"p{i:03d}", "label": f"l{i:03d}"}) for i in range(n_prod)]),
        ["prod_id"],
    )
    prod.on_device(dev)
    root = P.Join(P.Join(P.Scan(None), cust, ("cust_id",)), prod, ("prod_id",))
    return mi, root, [order(2000)]


def case_view_refresh_crash(*, device="cuda", target: Optional[dict] = None,
                            audit: Optional[bool] = None) -> dict:
    """A fatal fault at the top of the view-refresh pass inside a
    serving write cycle: the prior snapshot stays live, the events stay
    queued, the dispatcher survives, and the disarmed retry converges
    back to from-scratch parity; the crash leaves a flight dump naming
    the ``views:refresh`` site.  By default (the reference's shape) it
    builds a 1,500-order index and registers the three-way join view on a
    fresh server; *target* runs it on a started server instead:
    ``{"server", "view" (its name), "index", "append" (rows), "delete"
    (a live key), "lookup" (a live key)}``."""
    from ..serve import LookupServer
    from . import faults
    from .faults import FaultPlan

    chk = DeviceChecks(device, audit)
    with contextlib.ExitStack() as stack:
        flight_dir = stack.enter_context(_flight_dir())
        stack.enter_context(chk)
        if target is None:
            mi, root, rows = _view_setup(device)
            srv = stack.enter_context(running(LookupServer(indexes={"orders": mi})))
            name, index = "enriched", "orders"
            view = srv.register_view(name, root, source=index)
            target = {"append": rows, "delete": "o00007", "lookup": "o00005"}
        else:
            srv, name, index = target["server"], target["view"], target["index"]
            view = srv.view(name)
        base_cs = view.checksums()
        snap0, epoch0 = view.snapshot(), view.epoch
        chk.mark_oracle()
        with faults.active(
            FaultPlan(
                [{"site": "views:refresh", "at": [0], "error": "fatal"}],
                seed=17,
            )
        ) as plan:
            # the write cycle lands its tier and tombstone, then its
            # refresh pass crashes (caught by the dispatcher's sweep)
            fa = srv.submit_append(target["append"], index=index)
            fd = srv.submit_delete((target["delete"],), index=index)
            acked = (fa.result(timeout=WAIT_S) == len(target["append"])
                     and fd.result(timeout=WAIT_S) == 1)
            deadline = time.perf_counter() + WAIT_S
            failures = 0
            while time.perf_counter() < deadline:
                cell = srv.snapshot()["by_view"].get(name, {})
                failures = int(cell.get("failures", 0))
                if failures:
                    break
                time.sleep(0.01)
            # the prior snapshot is still the live one, the events queued
            intact = (
                view.snapshot() is snap0
                and view.epoch == epoch0
                and view.checksums() == base_cs
                and view.pending >= 1
            )
            injections = plan.snapshot()
        del snap0
        # the dispatcher lives: this lookup's cycle also retries the (now
        # disarmed) refresh and drains the queue
        alive = srv.lookup(target["lookup"], index=index, deadline_s=WAIT_S) != []
        deadline = time.perf_counter() + WAIT_S
        while view.pending and time.perf_counter() < deadline:
            time.sleep(0.01)
        converged = view.pending == 0
        parity = view.checksums() == view.recompute_checksums()
        resurrect_gone = view.read(target["delete"]) == []
        cell = srv.snapshot()["by_view"][name]
        flight = flight_evidence(flight_dir, "views:refresh")
        chk.mark_faulted()
    return _finish({
        "ok": acked
        and failures >= 1
        and intact
        and alive
        and converged
        and parity
        and resurrect_gone
        and injections["fired"].get("views:refresh", 0) == 1
        and flight["ok"],
        "write_futures_acked": acked,
        "refresh_failures_recorded": failures,
        "prior_snapshot_intact": intact,
        "dispatcher_alive": alive,
        "retry_converged": converged,
        "from_scratch_parity": parity,
        "flight": flight,
        "injections": injections,
        "view_cell": {k: cell[k] for k in ("refreshes", "events", "failures", "epoch")},
    }, chk)


# ---- the disarmed hooks' cost -------------------------------------------------


def case_disarmed_overhead(idx, ids, *, device="cuda", n_probes: int = 2000,
                           reps: int = 200_000, n_isolated: int = 64) -> dict:
    """The disarmed ``inject()`` fast path priced against served requests
    in both regimes its two serve-path sites (``serve:dispatch``,
    ``serve:bounds``, once per dispatch cycle each) run in: coalesced
    (the per-cycle cost amortized over the mean batch, against the
    amortized per-request time) and isolated (both sites against one warm
    submit-to-result round trip).  The serve path is fully warmed (one
    pass over every probe) before anything is timed."""
    from ..serve import LookupServer
    from . import faults

    _device(device)
    assert faults.current() is None
    t0 = time.perf_counter()
    for _ in range(reps):
        faults.inject("serve:bounds")
    per_call_s = (time.perf_counter() - t0) / reps

    probes = probes_of(ids, n_probes, seed=3)
    sites_per_cycle = 2  # serve:dispatch + serve:bounds
    with running(LookupServer(idx)) as srv:
        for f in [srv.submit(p) for p in probes]:  # full warm pass
            f.result(timeout=WAIT_S)
        ticks_before = srv.snapshot()["ticks"]
        t0 = time.perf_counter()
        for f in [srv.submit(p) for p in probes]:
            f.result(timeout=WAIT_S)
        per_request_s = (time.perf_counter() - t0) / len(probes)
        cycles = max(1, srv.snapshot()["ticks"] - ticks_before)
        mean_batch = len(probes) / cycles
        iso = probes[:n_isolated]
        t0 = time.perf_counter()
        for p in iso:
            srv.submit(p).result(timeout=WAIT_S)
        iso_rt_s = (time.perf_counter() - t0) / len(iso)

    pct_coalesced = 100.0 * sites_per_cycle * per_call_s / (mean_batch * per_request_s)
    pct_isolated = 100.0 * sites_per_cycle * per_call_s / iso_rt_s
    pct = max(pct_coalesced, pct_isolated)
    return {
        "ok": pct <= OVERHEAD_BUDGET_PCT,
        "per_call_ns": round(per_call_s * 1e9, 2),
        "per_request_us": round(per_request_s * 1e6, 2),
        "isolated_rt_us": round(iso_rt_s * 1e6, 2),
        "mean_batch": round(mean_batch, 1),
        "sites_per_cycle": sites_per_cycle,
        "overhead_pct_coalesced": round(pct_coalesced, 4),
        "overhead_pct_isolated": round(pct_isolated, 4),
        "overhead_pct": round(pct, 4),
        "budget_pct": OVERHEAD_BUDGET_PCT,
    }


# ---- the gate -----------------------------------------------------------------


def run_gate(device="cuda", timeout: float = CASE_TIMEOUT_S,
             log: Callable[[str], None] = _log) -> Dict[str, dict]:
    """The ten cases at the reference's sizes on *device*, each under
    the watchdog; returns name -> record."""
    _device(device)
    idx, ids = build_index(device=device)
    cases: Dict[str, dict] = {}
    with tempfile.TemporaryDirectory(prefix="csvplus-chaos-") as tmp:
        runs = {
            "serve_retry": lambda: case_serve_retry(idx, ids, device=device),
            "serve_degrade": lambda: case_serve_degrade(idx, ids, device=device),
            "dispatcher_crash": lambda: case_dispatcher_crash(idx, ids, device=device),
            "ingest_crash_recovery": lambda: case_ingest_crash_recovery(tmp, device=device),
            "ingest_read_fault_typed": lambda: case_ingest_read_fault_typed(tmp, device=device),
            "mesh_join_under_ingest_faults": lambda: case_mesh_join_under_ingest_faults(
                tmp, device=device),
            "storage_compact_crash": lambda: case_storage_compact_crash(device=device),
            "wal_crash_matrix": lambda: case_wal_crash_matrix(
                tmp, device=device, timeout=timeout),
            "view_refresh_crash": lambda: case_view_refresh_crash(device=device),
            "disarmed_overhead": lambda: case_disarmed_overhead(idx, ids, device=device),
        }
        for name in CASES:
            cases[name] = with_timeout(name, runs[name], timeout, log)
    return cases


def summary(cases: Dict[str, dict], device) -> dict:
    """The gate's compact line: the reference's keys plus ``device``."""
    failed = sorted(k for k, v in cases.items() if not v.get("ok"))
    return {
        "metric": "chaos_cases_passed",
        "value": len(cases) - len(failed),
        "cases_total": len(cases),
        "failed": failed,
        "overhead_pct": cases.get("disarmed_overhead", {}).get("overhead_pct"),
        "device": str(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The chaos gate: seeded fault injection "
                                             "against the port's recovery ladder.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case-timeout", type=float, default=CASE_TIMEOUT_S)
    ap.add_argument("--out", help="write the full record to this file")
    ap.add_argument("--wal-child", nargs=2, metavar=("WORKDIR", "ACKED"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--base-rows", type=int, default=400, help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="append", help=argparse.SUPPRESS)
    ap.add_argument("--tear", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.wal_child:
        wal_child(*args.wal_child, device=args.device, base_rows=args.base_rows,
                  mode=args.mode, tear=args.tear)
        return 0  # not reached: the child exits itself

    from ..obs.memory import host_header
    from ..utils.observe import telemetry

    dev = _device(args.device)
    _log(f"chaos: device={dev}")
    telemetry.enabled = True
    telemetry.reset()
    try:
        cases = run_gate(args.device, args.case_timeout)
    finally:
        counters = dict(telemetry.counters)
        telemetry.enabled = False
    compact = summary(cases, dev)
    if args.out:
        record = {**compact, "case_timeout_s": args.case_timeout, **host_header(),
                  "cases": cases, "telemetry_counters": counters}
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, default=str)
            f.write("\n")
        _log(f"chaos: record written to {args.out}")
    print(json.dumps(compact), flush=True)
    if compact["failed"]:
        _log(f"chaos FAIL: {', '.join(compact['failed'])}")
        return 1
    _log(f"chaos ok: {len(cases)}/{len(cases)} cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
