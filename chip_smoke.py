#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``csvplus_tpu_torch``) on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--seed S] [--profile]

Phases; any failure raises, exits non-zero and prints no result line:

1. Device: the card's name, and its name and power limit from nvidia-smi;
   the host's CPU count.
2. Build: ``csrc/mask.cu`` and ``csrc/parse.cu`` with nvcc for sm_90a
   and the native CSV scanner ``native/scanner.cpp`` with g++, all three
   started together; prints the seconds.
3. Mask kernel against its plain PyTorch version on the card, bitwise:
   seeded codes with ~5 % absent cells at n = 10,000,003 (ragged on
   purpose) for k in {1, 2, 8} columns, both modes, IN-lists of 1 and 50
   targets, and at n = 1000; at both sizes also pipeline (b)'s shape
   (k = 2 "any", 50 + 1 targets), a column 4 bytes off 16-byte alignment
   (the kernel's row-at-a-time path), an IN-list too long to stage in
   shared memory (its global-memory path), and typed value lanes
   (arbitrary int32: negative values and targets, +-(2^31 - 1), a target
   absent from the column).  Times the kernel (device time per call, see
   ``_timed``), its bound, the plain version and, for the single-column
   IN-list, ``torch.isin``.
3b. The field-pack kernel (``csrc/parse.cu``, the device dictionary
   encode's gather-and-pack) against its plain version on the card,
   bitwise: 10,000,019 seeded fields of 0 to 4 * lanes bytes at lanes 2, 4
   and 8, the last field ending at the buffer's last byte.  Times the
   kernel, its bound and the plain version at phase 4's ``order_id``
   column (10M fields, 2 lanes; no PyTorch call computes this function),
   and the seconds of each step of ``encode_column_device`` there.
4. Main path at 10M orders, through the public API on "cuda", in two
   legs: the default, where all three files must take the
   ``device-parsed`` tier (every column a dictionary column, the pack
   kernel launched once per column), and ``CSVPLUS_DEVICE_PARSE=0``:
   northstar-shaped CSVs written from the seed (orders
   ``order_id,cust_id,prod_id,qty`` x 10,000,000, customers ``id,name``
   x 100,000, products ``prod_id,product,price`` x 1,000);
   ``from_file(...).on_device("cuda")`` for all three, which must take the
   ``native-encoded`` ingest tier (the file is under the streamed tier's
   256 MiB) with the four orders columns as typed int32 lanes.  In each
   leg:
   ``unique_index_on`` for both build sides, then
   (a) ``filter(Not(Like{prod_id, qty})).join(cust, "cust_id").join(prod)``
   (b) ``filter(Any(Like prod_id p1..p50, Like qty 7))`` with the same joins.
   Each result is held against a numpy oracle built from the generated
   arrays: row count, positional checksums of every column, first rows.
   The mask kernel's launch count must rise, the result must lie on the
   card, and the orders columns keep their kind (no typed column demoted)
   in the cold and warm runs of either pipeline.  Prints each leg's ingest
   seconds and warm (a) / (b), and, in the native leg, warm (a) with the
   executor's verifier hook on and off (``CSVPLUS_VERIFY=0``), and the
   hook alone.
5. The streamed main path at 50M orders (BASELINE config 4's row count in
   phase 4's layout, ~1.2 GB of CSV): the file must be at least 256 MiB
   and take the ``streamed`` tier with four typed orders columns, under
   the default (the device chunk encoder, which forces K = 1; four typed
   columns never reach it) and again with ``CSVPLUS_DEVICE_PARSE=0`` at
   the automatic worker count, with equal positional checksums of every
   column in both runs and against the oracle; pipelines (a) and (b),
   cold then warm, against the oracle, with mask launches and no
   demotion; ``(b).to_csv_file`` of all eight
   columns and ``(b).top(100000).to_json_file`` equal, byte for byte
   (size and sha256), to files numpy builds from the oracle.  Prints the
   ingest seconds and rows/s per K with the scan-wait / place split, the
   chunk count, the peak device memory after ingest, the join times and
   the sinks' seconds and MB/s.
6. Device-lane dictionaries at their default threshold: ``order_id,cust,
   qty`` x 14,000,000 with ``order_id = ord-%08d`` (a seeded
   permutation), ~315 MB, so 14M distinct ids pass
   ``CSVPLUS_DICT_DEVICE_MIN_DISTINCT`` (4M) mid-file.  ``order_id`` must
   ingest as an unsorted lane column and stay unsorted through a
   positional checksum and a ``top(3)``; ``unique_index_on("order_id")``
   sorts the union on the card (once); a ``Like`` filter finds its row;
   a seeded probe file of 1,000,000 refs (~9 % absent) joined onto the
   index, and the ``to_csv`` of that join (the lazy host unpack of the
   lane dictionary), equal their oracles.
7. The streamed tier's host dictionaries: ``region,sku,tag`` x
   13,000,000 (~291 MB), ``region`` 12 words (uint8 code uploads),
   ``sku`` 5,000 values (uint16), ``tag`` typed ``t<n>`` up to the middle
   of the file and zero-padded ``t%04d`` after it, so it demotes mid-file
   (its typed chunks come back from the card and are re-encoded) and ships
   uint16 codes.  Each column must be a host dictionary equal to the
   oracle's sorted union, with positional checksums and a two-column
   ``Like`` filter equal to the oracle's.
8. The plan cache, on phase 5's 50M-order tables: pipelines (a), (b)
   and the unfiltered join (c) built as plans and run through a fresh
   ``csvplus_tpu_torch.serve.PlanCache`` per leg, "cascaded"
   (``CSVPLUS_MULTIWAY=0``, ``CSVPLUS_FUSE=0``) and "fused" (the
   defaults), cold (admission: verify + optimize) then warm (a hit).
   Every run equals the oracle and lies on the card; the legs are
   bitwise equal; ``optimize_failed`` is 0; the fusion decisions equal
   the reference's (``PLANCACHE_DECISIONS``); the mask kernel launches in
   both legs; the fused leg runs ``multiway_join`` and
   ``multiway_join_selected``.  Then ``except_`` of a unique index of a
   seeded subset of 100 product ids against its oracle.  Prints each
   run's admission, cold and warm seconds, the peak device memory over
   the inputs, the recipe and the expansion paths.
9. Point lookups and the serving tier (after phase 8, on the card):
   (s1) BASELINE config 2 at its published size, ``bench_serve.py``'s
   layout as a 1,000,000-row CSV (``cust_id = c<i*7 % 3n>``, all
   distinct; ``v = <i>``): ``unique_index_on("cust_id")`` (the host
   mirror tier), 10,000 uniform probes through a loop of single ``find``
   calls and through ``find_many``, 60,000 through ``LookupServer`` from
   32 callback-chained closed-loop clients.  (s2) phase 5's 50M-order
   table: ``unique_index_on("order_id")`` and ``index_on("cust_id")``,
   both over the 16M-key mirror cap (bounds from ``torch.searchsorted`` on
   the card, rows from one device gather per batch, no host mirror);
   60,000 ``order_id`` probes (1 % absent) through the server; 1,000
   plans ``cust_idx.find(c).filter(Any(Like prod_id p1..p50))`` through
   ``submit_plan``, 500 cold then 500 warm (all hits, nothing lowered).
   Every answer equals a numpy oracle; the server never retries or
   degrades and its breaker never opens; the plans launch the mask
   kernel, and their results lie on the card.  Prints the index build
   seconds, lookups/s of each route, p50/p99 and the mean batch, plans/s
   and the peak device memory over the inputs.
10. BASELINE config 4 at its published size ("IndexOn(non-unique
   key).ResolveDuplicates — group/dedup over 50M rows with 10% dup
   rate"): ``order_id,cust_id,qty,ts`` x 50,000,000 (~1.5 GB, the
   streamed tier), 45,000,000 distinct ``order_id = o%08d`` (a
   lane-dictionary column) and 5,000,000 rows re-using a seeded draw of
   them, ``cust_id`` over 100,000 customers, ``qty`` 1-100, ``ts`` the
   row number.  (i) ``index_on("order_id")`` then
   ``resolve_duplicates("first")``, and on a fresh index ``"last"``;
   (ii) on a fresh index the callback keeping each order's latest
   version (max ``ts``); (iii) ``write_to`` of (ii)'s index and
   ``load_index`` on the card.  Each result equals a numpy oracle (row
   count, positional checksums of every column, index order = the key's
   byte order); the index stays device-lazy on the card after each
   dedup; the callback runs once per duplicate group; the reload equals
   the written index, keeps ``order_id`` as lanes (no host dictionary)
   and answers 10,000 ``find_many`` probes (1 % absent) as the oracle.
   Prints seconds and rows/s per step and the index file's size.
11. BASELINE config 1 on the card: ``from_file(people).on_device()
   .filter(Like{name: Amelia}).map(SetValue(name, Julia))
   .to_csv_file(out, "name", "surname")`` over 10,000,000 people in the
   test corpus's layout; the file byte-equal (size, sha256) to numpy's.
12. Mutable indexes (``csvplus_tpu_torch.storage``): a durable
   ``MutableIndex`` on the card over BASELINE config 2's 1M-row layout
   (phase 9's (s1) file, ``index_on("cust_id")``), its WAL in the data
   directory, in ``bench_delta.py``'s shape: batches of 2,000 fresh keys
   to 16 delta tiers, interleaved deletes, a leveled fold, a full merge
   under two readers probing without a pause (as the bench runs them),
   a CSV appended with ``append_csv`` (on the card by default), and one
   more full merge with no reader running.  After each step
   the tier set's positional checksums equal the port's
   ``rebuild_reference`` and a numpy oracle of the logical stream;
   ``MutableIndex.open`` recovers a WAL tail written after the
   checkpoint checksum-equal; ``LookupServer`` ``append`` /
   ``delete`` acks read back as the oracle; no kernel is built or loaded
   in the phase.  Prints append rows/s, ``find`` p50/p99 at 0, 4 and 16
   tiers, the compactions' seconds and the readers' p99 during the merge.
13. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Phases 6, 7, 10 and 11 run under the default too (the device-parse tier
and the streamed tier's device chunk encoder); their pack kernel
launches are counted (set to 0 before each path, read after) and listed
per path.

Phases 4-9 and 11 also hold the mask kernel's wrapper against its plain
version, bitwise, on the inputs of every call their filters made
(recorded during the path's run and replayed after its launch count was
read).  Phases 4, 6, 7, 10 and 11 hold what the pack kernel returned in
each of their launches (the path's own buffers, strided columns and
streamed chunks, recorded during the run) against the plain version on
the same inputs, bitwise, after the path's launch count was read.

Stage tables (``telemetry.collect()``; stage, records, rows in and out,
milliseconds, share of the window, counters, host-sync elements) are
printed for one warm pipeline (a) at 10M (phase 4, which also prints
warm (a) with telemetry off and on, medians of seven, and checks that
the run synchronizes nowhere with it off), the 50M streamed ingest at
the automatic K (phase 5), one served batch of 32 lookups (phase 9,
(s2)) and phase 10's callback dedup.

Writes its CSVs under ``.chip_smoke_data/`` beside this file and removes
them at the end.  Needs one card; imports nothing of JAX or csvplus_tpu.
Phases 4-12 run on the CPU too, at a small size, as a rehearsal:
``run_main_path``, ``run_streamed_path`` (with phases 8 and 9 at its
end), ``run_lane_path``, ``run_host_dict_path``, ``run_plancache_path``,
``run_serving_path``, ``run_dedup_path``, ``run_config1_path`` and
``run_storage_path`` with ``device="cpu"`` (set ``CSVPLUS_DEVICE_PARSE=1``
to take the tier the card takes by default).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_ORDERS = 10_000_000  # BASELINE.json config 3
N_ORDERS_STREAMED = 50_000_000  # BASELINE.json config 4's row count
N_LANE_ROWS = 14_000_000  # over CSVPLUS_DICT_DEVICE_MIN_DISTINCT's 4M
N_PROBE_REFS = 1_000_000
N_HOST_DICT_ROWS = 13_000_000  # ~291 MB: over the streamed tier's threshold
STREAM_MIN_BYTES = 256 << 20  # the streamed tier's default threshold
N_CUST = 100_000
N_PROD = 1_000
MASK_ROWS = 10_000_003
PACK_ROWS = 10_000_019  # the field-pack kernel's bitwise check, ragged on purpose
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 issue rate: 132 SMs x 64 INT32 lanes per SM (NVIDIA H100
# Tensor Core GPU Architecture whitepaper) at the 1.98 GHz boost clock that
# gives the data sheet's 67 TFLOP/s fp32 (132 x 128 lanes x 2 x 1.98e9).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# More targets than the kernel stages in shared memory (MAX_STAGED in
# csrc/mask.cu): such an IN-list is read from global memory.
LONG_IN_LIST = 12_300
I32_MAX = 2**31 - 1
ORDERS_COLS = ("order_id", "cust_id", "prod_id", "qty")
_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 3: the mask kernel against its plain version ---------------------


def _timed(fn, reps: int = 20, batches: int = 5) -> float:
    """Device milliseconds per call of *fn*: the median over *batches* of
    the mean of *reps* back-to-back calls between two CUDA events.  Each
    batch is queued behind a GPU spin (``torch.cuda._sleep``) long enough
    for the host to enqueue every call, so the events bracket device work
    only, not the host's Python time per call (which exceeds a 10M-row
    mask's device time and would otherwise idle the card between calls)."""
    import torch

    fn()  # warm: lazy loads, allocator
    means = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU cycles
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        means.append(a.elapsed_time(b) / reps)
    return float(np.median(means))


def _bound_ms(n: int, targets) -> "tuple[float, str]":
    """Least time for the mask on this card: (4k + 1) n bytes over the
    memory rate, or 2 n * sum|T_j| int32 operations (a compare and an OR
    per target) over the int32 issue rate, whichever is larger."""
    t_bytes = (4 * len(targets) + 1) * n / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * sum(len(t) for t in targets) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mask_vs_plain(cols, targets, nrows: int, mode: str, what: str) -> int:
    """The mask kernel's wrapper against its plain version on the same
    inputs; raises unless they are bitwise equal, else returns the max
    abs error (0)."""
    import torch

    from csvplus_tpu_torch.ops import mask as M

    got = M.fused_equality_mask(cols, targets, nrows, mode)
    want = M.fused_equality_mask_plain(cols, targets, mode)
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if nrows else 0
    if not torch.equal(got, want):
        raise AssertionError(f"mask kernel != plain at {what}")
    return err


@contextlib.contextmanager
def recorded_mask_calls():
    """Record the inputs of every call the filter makes to the mask
    kernel's wrapper inside the block; the wrapper still runs (and counts
    its launches) as usual."""
    from csvplus_tpu_torch.ops import filter as F

    calls = []
    wrapper = F.fused_equality_mask

    def record(cols, targets, nrows, mode="all"):
        calls.append((list(cols), targets, nrows, mode))
        return wrapper(cols, targets, nrows, mode=mode)

    F.fused_equality_mask = record
    try:
        yield calls
    finally:
        F.fused_equality_mask = wrapper


def check_path_masks(calls, label: str) -> dict:
    """Hold the wrapper against its plain version, bitwise, on the inputs
    of each recorded call: the path's own columns, targets and mode.  Run
    after the path's launch count was read, so these launches are not
    the path's."""
    worst = 0
    shapes = set()
    for cols, targets, nrows, mode in calls:
        per_col = tuple(len(t) if isinstance(t, (list, tuple)) else 1 for t in targets)
        shape = f"n={nrows} k={len(cols)} {mode} targets={list(per_col)}"
        worst = max(worst, _mask_vs_plain(cols, targets, nrows, mode, f"{label} {shape}"))
        shapes.add(shape)
    log(f"{label}: mask kernel == plain version, bitwise, in the path's {len(calls)} "
        f"calls ({'; '.join(sorted(shapes))})")
    return {"cases": len(calls), "max_abs_err": worst}


@contextlib.contextmanager
def recorded_pack_calls(calls=None):
    """Record the inputs and the output of every call the device encode
    makes to the pack kernel's wrapper inside the block (appended to
    *calls* when given); the wrapper still runs (and counts its launches)
    as usual.  The records hold the path's buffers until they are checked."""
    from csvplus_tpu_torch.ops import parse as P

    calls = [] if calls is None else calls
    wrapper = P.pack_field_lanes

    def record(data, starts, lens, lanes):
        out = wrapper(data, starts, lens, lanes)
        calls.append((data, starts, lens, lanes, out))
        return out

    P.pack_field_lanes = record
    try:
        yield calls
    finally:
        P.pack_field_lanes = wrapper


def check_path_packs(calls, label: str, launches: int, device: str) -> dict:
    """Hold what the pack kernel's wrapper returned in each recorded call
    against the plain version on the same inputs (the path's own buffers,
    strided columns and chunks), bitwise; on the card each call is one of
    the path's *launches*.  No kernel is launched here.  Drops the
    records as it goes."""
    import torch

    from csvplus_tpu_torch.ops import parse as P

    n_calls = len(calls)
    if device == "cuda" and n_calls != launches:
        raise AssertionError(f"{label}: {n_calls} recorded pack calls, {launches} launches")
    worst = 0
    shapes = set()
    while calls:
        data, starts, lens, lanes, out = calls.pop()
        want = P.pack_field_lanes_plain(data, starts, lens, lanes)
        if out.shape != want.shape or not torch.equal(out, want):
            raise AssertionError(f"{label}: pack kernel != plain at m={starts.shape[0]} "
                                 f"lanes={lanes}")
        if out.numel():
            worst = max(worst, int((out.to(torch.int64) - want.to(torch.int64)).abs().max()))
        shapes.add(lanes)
    log(f"{label}: pack kernel == plain version, bitwise, in the path's {n_calls} calls "
        f"(lanes {sorted(shapes)})")
    return {"cases": n_calls, "max_abs_err": worst}


def check_mask_kernel(seed: int) -> dict:
    import torch

    from csvplus_tpu_torch.ops import mask as M

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def codes(n: int, k: int, hi: int = 1000):
        out = []
        for _ in range(k):
            c = torch.randint(0, hi, (n,), generator=g, device=dev, dtype=torch.int32)
            c[torch.rand(n, generator=g, device=dev) < 0.05] = -1
            out.append(c)
        return out

    def typed(n: int, k: int):
        """k typed value-lane columns: int32 in [-1000, 1000) with ~1 %
        of cells at +(2^31 - 1) and ~1 % at -(2^31 - 1)."""
        out = []
        for _ in range(k):
            c = torch.randint(-1000, 1000, (n,), generator=g, device=dev, dtype=torch.int32)
            r = torch.rand(n, generator=g, device=dev)
            c[r < 0.01] = I32_MAX
            c[r > 0.99] = -I32_MAX
            out.append(c)
        return out

    def unaligned(n: int):
        """One contiguous column 4 bytes past a 16-byte boundary."""
        buf = codes(n + 1, 1)[0]
        return buf[1:]

    worst = 0
    cases = []

    def check(name, cols, targets, mode):
        nonlocal worst
        n = cols[0].shape[0]
        worst = max(worst, _mask_vs_plain(cols, targets, n, mode, f"n={n} {name} {mode}"))
        cases.append((n, name, mode))

    for n in (MASK_ROWS, 1000):
        for k in (1, 2, 8):
            cols = codes(n, k)
            for mode in ("all", "any"):
                for t in (1, 50):
                    targets = [list(range(7 * j, 7 * j + t)) for j in range(k)]
                    check(f"k={k} T={t}", cols, targets, mode)
        # pipeline (b)'s shape: a 50-target IN-list and one target
        check("k=2 T=50+1", codes(n, 2), [list(range(1, 51)), [7]], "any")
        # not 16-byte aligned: the row-at-a-time path, alone and beside
        # an aligned column
        skew = unaligned(n)
        if skew.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned column came out aligned")
        for mode in ("all", "any"):
            check("k=1 unaligned", [skew], [[3, 5]], mode)
            check("k=2 unaligned", [codes(n, 1)[0], skew], [[7], [3]], mode)
        # more targets than fit in shared memory: the global-memory path
        wide = codes(n, 1, hi=2 * LONG_IN_LIST + 1000)
        check("k=1 long IN-list", wide, [list(range(0, 2 * LONG_IN_LIST, 2))], "any")
        # typed value lanes: any int32 is a value, none means "absent"
        lanes = typed(n, 2)
        for mode in ("all", "any"):
            check("typed negative", lanes, [[-7], [-1, -999]], mode)
            check("typed +-(2^31-1)", lanes, [[I32_MAX], [-I32_MAX, I32_MAX]], mode)
            check("typed absent target", lanes, [[123_456_789], [5000, -5000]], mode)
    log(f"mask kernel == plain version, bitwise, in {len(cases)} cases")

    timings = []
    n = MASK_ROWS
    for k, mode, t in [(2, "all", 1), (2, "any", 50), (8, "all", 1), (1, "any", 50)]:
        cols = codes(n, k)
        targets = [list(range(7 * j, 7 * j + t)) for j in range(k)]
        ms = _timed(lambda: M.fused_equality_mask(cols, targets, n, mode))
        plain_ms = _timed(lambda: M.fused_equality_mask_plain(cols, targets, mode))
        bound, by = _bound_ms(n, targets)
        lib_ms = None
        if k == 1:
            tt = torch.tensor(targets[0], dtype=torch.int32, device=dev)
            lib_ms = _timed(lambda: torch.isin(cols[0], tt))
        row = {"n": n, "k": k, "mode": mode, "targets_per_col": t, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms}
        timings.append(row)
        log("mask timing " + json.dumps(row))
    return {"max_abs_err": worst, "cases": len(cases), "timings": timings}


# -- phase 3b: the field-pack kernel against its plain version --------------


def _pack_bound_ms(m: int, lanes: int, field_bytes: int) -> "tuple[float, str]":
    """Least time for the pack on this card: each field's start and length
    (8 bytes) and its own bytes read once and 4 * lanes bytes written, or
    3 int32 operations (a load-select, a shift, an OR) per output byte
    over the int32 issue rate, whichever is larger."""
    t_bytes = (m * (8 + 4 * lanes) + field_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * m * 4 * lanes / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ids_buffer(n: int, prefix: bytes = b"o") -> "tuple[bytes, np.ndarray, np.ndarray]":
    """Phase 4's ``order_id`` column alone: ``o<i>`` for i < n, one per
    line, and each field's start and length."""
    digits = _digits(np.arange(n))
    lens = (len(prefix) + (digits != 0).sum(axis=1)).astype(np.int32)
    data = _lines([_lit(n, prefix), digits, _lit(n, b"\n")])
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64) + 1)
    return data, starts, lens


def check_pack_kernel(seed: int) -> dict:
    """The field-pack kernel (``csrc/parse.cu``) against its plain version
    on the card, bitwise: seeded bytes (no NUL) cut into *PACK_ROWS*
    fields of 0 to 4 * lanes bytes (ragged on purpose), lanes 2, 4 and 8,
    the last field ending at the buffer's last byte.  Then its time, its
    bound and the plain version's at the main path's shape (phase 4's
    ``order_id``: 10M fields of 2-8 bytes, 2 lanes), and the seconds of
    each step of ``encode_column_device`` on that column."""
    import torch

    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.ops.lanes import lanes_for_width

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 21)
    m = PACK_ROWS
    cases = []
    worst = 0
    for lanes in (2, 4, 8):
        lens = rng.integers(0, 4 * lanes + 1, m).astype(np.int32)
        lens[-1] = 4 * lanes  # the widest field ends the buffer
        starts = np.zeros(m, np.int64)
        starts[1:] = np.cumsum(lens[:-1].astype(np.int64) + 1)
        n = int(starts[-1] + lens[-1])
        data = torch.from_numpy(rng.integers(1, 256, n, dtype=np.uint8)).to(dev)
        st = torch.from_numpy(starts.astype(np.int32)).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        got = P.pack_field_lanes(data, st, ln, lanes)
        want = P.pack_field_lanes_plain(data, st, ln, lanes)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"pack kernel != plain at lanes={lanes}, m={m}")
        worst = max(worst, err)
        cases.append({"lanes": lanes, "m": m, "bytes": n})
        del data, st, ln, got, want
    log(f"pack kernel == plain version, bitwise, at lanes 2, 4 and 8 (m = {m:,}, fields of "
        f"0-4*lanes bytes, the last ending at the buffer's last byte)")

    raw, starts, lens = _ids_buffer(N_ORDERS)
    data = P.upload_bytes(raw, dev)
    st = torch.from_numpy(starts.astype(np.int32)).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    lanes = lanes_for_width(int(lens.max()))
    ms = _timed(lambda: P.pack_field_lanes(data, st, ln, lanes))
    plain_ms = _timed(lambda: P.pack_field_lanes_plain(data, st, ln, lanes), reps=3, batches=3)
    bound, by = _pack_bound_ms(N_ORDERS, lanes, int(lens.sum()))
    timing = {"m": N_ORDERS, "lanes": lanes, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": by, "library_ms": None}
    log("pack timing " + json.dumps(timing))

    # encode_column_device on that column, step by step (host clock, each
    # step ending in a synchronize)
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    step("upload_s", lambda: P.upload_bytes(raw, dev))
    words = step("pack_s", lambda: P.pack_field_lanes(data, st, ln, lanes))
    codes, n_uniq, first = step("sort_rank_s", lambda: P.encode_lanes(words))
    k = int(n_uniq)
    lanes_host = step("download_s", lambda: words.index_select(
        1, first[:k].to(torch.int64)).cpu().numpy())
    dictionary = step("dictionary_s", lambda: P.dictionary_from_lanes(
        lanes_host, int(lens.max())))
    t0 = time.perf_counter()
    enc = P.encode_column_device(data, starts, lens)
    torch.cuda.synchronize()
    steps["encode_column_device_s"] = time.perf_counter() - t0
    if k != N_ORDERS or not np.array_equal(enc[0], dictionary) \
            or not torch.equal(enc[1], codes):
        raise AssertionError("encode_column_device of the order ids != its steps")
    want_d = np.sort(np.char.add(b"o", np.arange(N_ORDERS).astype("S")))
    if not np.array_equal(dictionary, want_d):
        raise AssertionError("the order ids' dictionary != numpy's sorted ids")
    log("encode_column_device of 10M order ids, seconds per step " + json.dumps(steps))
    return {"max_abs_err": worst, "cases": cases, "timing": timing, "encode_steps": steps}


# -- phase 4: the main path --------------------------------------------------


def _fnv32(values: np.ndarray) -> np.ndarray:
    """32-bit FNV-1a of each entry of an 'S' array (the oracle's own)."""
    n = values.size
    width = values.dtype.itemsize
    mat = np.frombuffer(values.tobytes(), dtype=np.uint8).reshape(n, width)
    lens = np.char.str_len(values)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(width):
            h = np.where(i < lens, (h ^ mat[:, i]) * _FNV_PRIME, h)
    return h


def _fnv32_mat(mat: np.ndarray) -> np.ndarray:
    """:func:`_fnv32` of the rows of a NUL-padded (n, width) byte matrix."""
    h = np.full(mat.shape[0], _FNV_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(mat.shape[1]):
            col = mat[:, i]
            h = np.where(col != 0, (h ^ col) * _FNV_PRIME, h)
    return h


def _positional_sum(hashes: np.ndarray) -> int:
    w = 2 * np.arange(hashes.size, dtype=np.uint32) + np.uint32(1)
    with np.errstate(over="ignore"):
        return int(np.add.reduce(hashes.astype(np.uint32) * w, dtype=np.uint32))


def _sbytes(prefix: bytes, ints: np.ndarray) -> np.ndarray:
    return np.char.add(prefix, ints.astype("S"))


# -- CSV and JSON bytes from numpy: NUL-padded byte matrices, one row per
# line, whose NULs are dropped (no CSV byte written here is NUL) ----------


def _digits(v: np.ndarray, width: int = 0) -> np.ndarray:
    """(n, w) uint8 decimal digits of the nonnegative ints *v*, left
    aligned and NUL padded; ``width`` > 0 gives exactly that many digits,
    zero filled (``%0*d``).  Rows of each digit count are filled
    together, least significant digit first (one divmod a digit)."""
    v = np.asarray(v, dtype=np.int64)
    w = width or max(len(str(int(v.max()))) if v.size else 1, 1)
    if v.size and int(v.max()) >= 10**w:
        raise ValueError("value too wide")

    def fixed(x: np.ndarray, d: int) -> np.ndarray:
        out = np.empty((x.size, d), np.uint8)
        for k in range(d - 1, -1, -1):
            x, r = np.divmod(x, 10)
            out[:, k] = r + 48
        return out

    if width:
        return fixed(v, w)
    out = np.zeros((v.size, w), np.uint8)
    nd = np.ones(v.shape, np.int64)
    for k in range(1, w):
        nd += v >= 10**k
    for d in range(1, w + 1):
        rows = np.flatnonzero(nd == d)
        if rows.size:
            out[rows, :d] = fixed(v[rows], d)
    return out


def _smat(values: np.ndarray) -> np.ndarray:
    """An 'S' array as its NUL-padded (n, itemsize) byte matrix."""
    return np.frombuffer(values.tobytes(), np.uint8).reshape(values.size, values.dtype.itemsize)


def _lit(n: int, b: bytes) -> np.ndarray:
    return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))


def _lines(pieces) -> bytes:
    mat = np.hstack(pieces)
    flat = mat.ravel()
    return flat[flat != 0].tobytes()


def _fnv_affix(prefix: bytes, v: np.ndarray) -> np.ndarray:
    """FNV-1a of ``prefix + decimal(v)`` per row, for nonnegative ints."""
    n = v.size
    return _fnv32_mat(np.hstack([_lit(n, prefix), _digits(v)]) if prefix else _digits(v))


def generate(root: Path, n_orders: int, seed: int, name: str = "orders.csv") -> dict:
    """Write the three CSVs and return the arrays they were made from."""
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, N_CUST, n_orders)
    prod = rng.integers(0, N_PROD, n_orders)
    qty = rng.integers(1, 101, n_orders)
    ci = np.arange(N_CUST)
    pi = np.arange(N_PROD)
    price = np.array([f"{(i % 9900) / 100 + 0.99:.2f}".encode() for i in pi])
    cols = {
        "cust": {"id": _sbytes(b"c", ci), "name": _sbytes(b"name", ci % 9973)},
        "prod": {"prod_id": _sbytes(b"p", pi), "product": _sbytes(b"prod", pi),
                 "price": price},
    }
    paths = {"orders": root / name, "cust": root / "customers.csv",
             "prod": root / "products.csv"}
    with open(paths["cust"], "wb") as f:
        f.write(b"id,name\n")
        f.write(b"\n".join(np.char.add(np.char.add(cols["cust"]["id"], b","),
                                       cols["cust"]["name"]).tolist()) + b"\n")
    with open(paths["prod"], "wb") as f:
        f.write(b"prod_id,product,price\n")
        p = cols["prod"]
        f.write(b"\n".join(np.char.add(np.char.add(np.char.add(p["prod_id"], b","),
                                                   np.char.add(p["product"], b",")),
                                       p["price"]).tolist()) + b"\n")
    with open(paths["orders"], "wb") as f:
        f.write(b"order_id,cust_id,prod_id,qty\n")
        chunk = 2_000_000
        for lo in range(0, n_orders, chunk):
            hi = min(lo + chunk, n_orders)
            m = hi - lo
            f.write(_lines([
                _lit(m, b"o"), _digits(np.arange(lo, hi)), _lit(m, b",c"), _digits(cust[lo:hi]),
                _lit(m, b",p"), _digits(prod[lo:hi]), _lit(m, b","), _digits(qty[lo:hi]),
                _lit(m, b"\n"),
            ]))
    return {"paths": paths, "cust": cust, "prod": prod, "qty": qty, "cols": cols,
            "n": n_orders}


def oracle(data: dict, keep: np.ndarray, columns) -> "tuple[int, dict, list]":
    """(row count, positional checksums, first 3 rows) of the filtered
    3-table join: every order matches one customer and one product, so
    the result is the surviving orders in stream order."""
    rows = np.flatnonzero(keep)
    cust, prod, qty = data["cust"][rows], data["prod"][rows], data["qty"][rows]
    c, p = data["cols"]["cust"], data["cols"]["prod"]
    qty_s = np.arange(101).astype("S")
    values = {
        "order_id": lambda sel: _sbytes(b"o", rows[sel]),
        "cust_id": lambda sel: c["id"][cust[sel]],
        "id": lambda sel: c["id"][cust[sel]],
        "name": lambda sel: c["name"][cust[sel]],
        "prod_id": lambda sel: p["prod_id"][prod[sel]],
        "product": lambda sel: p["product"][prod[sel]],
        "price": lambda sel: p["price"][prod[sel]],
        "qty": lambda sel: qty_s[qty[sel]],
    }
    tables = {
        "cust_id": (_fnv32(c["id"]), cust), "id": (_fnv32(c["id"]), cust),
        "name": (_fnv32(c["name"]), cust),
        "prod_id": (_fnv32(p["prod_id"]), prod), "product": (_fnv32(p["product"]), prod),
        "price": (_fnv32(p["price"]), prod), "qty": (_fnv32(qty_s), qty),
    }
    sums = {}
    for col in columns:
        if col == "order_id":
            hashes = _order_id_hashes(data)[rows]
        else:
            htab, idx = tables[col]
            hashes = htab[idx]
        sums[col] = _positional_sum(hashes)
    head = slice(0, 3)
    first = [
        {col: values[col](head)[i].decode() for col in columns}
        for i in range(min(3, rows.size))
    ]
    return int(rows.size), sums, first


def _order_id_hashes(data: dict) -> np.ndarray:
    """FNV-1a of every order's ``o<row>`` id (made once per data set)."""
    if "order_id_hashes" not in data:
        data["order_id_hashes"] = _fnv_affix(b"o", np.arange(data["n"]))
    return data["order_id_hashes"]


def ingest_oracle(data: dict) -> dict:
    """Positional checksums of the four orders columns as written."""
    qty_s = np.arange(101).astype("S")
    return {
        "order_id": _positional_sum(_order_id_hashes(data)),
        "cust_id": _positional_sum(_fnv32(data["cols"]["cust"]["id"])[data["cust"]]),
        "prod_id": _positional_sum(_fnv32(data["cols"]["prod"]["prod_id"])[data["prod"]]),
        "qty": _positional_sum(_fnv32(qty_s)[data["qty"]]),
    }


def profile_pipelines(srcs) -> None:
    """One warm run of each pipeline under ``torch.profiler``: the device
    time by kernel and the device's busy share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, src in srcs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            src.to_device_table()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same time again
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.device_time_total for e in events)
        log(f"profile pipeline {name}: window {wall_us:.0f} us, {len(events)} device "
            f"event kinds, device busy {busy_us:.0f} us "
            f"({100 * busy_us / wall_us:.1f} % of the window)")
        top = sorted(events, key=lambda e: -e.device_time_total)
        for e in top[:12] + [e for e in top[12:] if "fused_mask" in e.key]:
            log(f"  {e.device_time_total:10.1f} us  x{e.count:<4d} {e.key[:90]}")


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _pipelines(data: dict) -> dict:
    import csvplus_tpu_torch as T

    return {
        "a": (
            T.Not(T.Like({"prod_id": "p0", "qty": "1"})),
            ~((data["prod"] == 0) & (data["qty"] == 1)),
        ),
        "b": (
            T.Any(*[T.Like({"prod_id": f"p{i}"}) for i in range(1, 51)], T.Like({"qty": "7"})),
            ((data["prod"] >= 1) & (data["prod"] <= 50)) | (data["qty"] == 7),
        ),
    }


def _index_dims(data: dict, device: str):
    import csvplus_tpu_torch as T

    dims = {k: T.from_file(str(data["paths"][k])).on_device(device) for k in ("cust", "prod")}
    return dims, dims["cust"].unique_index_on("id"), dims["prod"].unique_index_on("prod_id")


def run_pipelines(orders, cust, prod, data: dict, device: str, label: str,
                  typed_lanes: bool = True) -> dict:
    """Drive pipelines (a) and (b) over *orders*, cold then warm, and hold
    each against the oracle.  The mask kernel's count is set to 0 just
    before and read just after; the launches and the orders-side
    demotions of that run are checked.  *typed_lanes*: the orders columns are
    typed value lanes (and must stay so), else dictionary columns (the
    device-parse tier's)."""
    from csvplus_tpu_torch.columnar import typed
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    pipelines = _pipelines(data)
    n_orders = data["n"]
    with recorded_mask_calls() as calls:
        M.launches = 0  # the path's run starts here
        typed.demotions.clear()
        results = {}
        srcs = {}
        for name, (pred, _) in pipelines.items():
            src = srcs[name] = orders.filter(pred).join(cust, "cust_id").join(prod)
            times = []
            for _ in range(2):  # cold, then warm
                t0 = time.perf_counter()
                table = src.to_device_table()
                _sync(device)
                times.append(time.perf_counter() - t0)
            results[name] = (table, src.top(3).to_rows(), times)
        launches = M.launches  # ... and ends here
    main_demotions = list(typed.demotions)

    out = {"pipelines": {}, "srcs": srcs}
    for name, (table, first_rows, times) in results.items():
        cols = sorted(table.columns)
        n_want, want_sums, want_first = oracle(data, pipelines[name][1], cols)
        if table.nrows != n_want:
            raise AssertionError(f"{label} pipeline {name}: {table.nrows} rows, oracle {n_want}")
        for c in table.columns.values():
            if c.storage.device.type != device:
                raise AssertionError(f"{label} pipeline {name}: result column on {c.storage.device}")
        got_sums = checksum_device_table(table, cols, positional=True)
        if got_sums != want_sums:
            raise AssertionError(
                f"{label} pipeline {name}: checksums {got_sums} != oracle {want_sums}")
        if [dict(r) for r in first_rows] != want_first:
            raise AssertionError(
                f"{label} pipeline {name}: first rows {first_rows} != {want_first}")
        out["pipelines"][name] = {"rows_out": table.nrows, "join_cold_s": times[0],
                                  "join_warm_s": times[1],
                                  "rows_per_s_warm": n_orders / times[1]}
        log(f"{label} pipeline {name}: {table.nrows:,} rows == oracle (count, positional "
            f"checksums of {len(cols)} columns, first rows); filter+join cold "
            f"{times[0]:.3f}s, warm {times[1]:.3f}s ({n_orders / times[1]:,.0f} rows/s)")
    # the orders side keeps its kind end to end: in the ingested table and
    # in both pipelines' results, after the checksums and top(3)
    for where, cols in [("ingested orders", orders.plan.table.columns)] + [
        (f"pipeline {name} result", res[0].columns) for name, res in results.items()
    ]:
        for c in ORDERS_COLS:
            if typed_lanes and (cols[c].kind != "int" or cols[c]._demoted is not None):
                raise AssertionError(f"{label} {where}: column {c} was demoted")
            if not typed_lanes and cols[c].kind != "str":
                raise AssertionError(f"{label} {where}: column {c} is {cols[c].kind}")
    out["main_demotions"] = [(p.decode(), n) for p, n in main_demotions]
    if main_demotions:
        raise AssertionError(f"{label}: the main path demoted typed columns: {main_demotions}")
    out["launches"] = launches
    log(f"{label} main path: mask kernel launches {launches}")
    if launches <= 0 and device == "cuda":
        raise AssertionError(f"{label}: the main path never launched the mask kernel")
    out["mask_check"] = check_path_masks(calls, label)
    out["tables"] = {name: res[0] for name, res in results.items()}
    return out


def _default_parse_env(device: str) -> dict:
    """The environment of a path's default run: nothing on the card, where
    the device-parse tier is on by default; ``CSVPLUS_DEVICE_PARSE=1`` in
    a CPU rehearsal, where the default is off."""
    return {} if device == "cuda" else {"CSVPLUS_DEVICE_PARSE": "1"}


#: Phase 4's legs: the default (the device-parse tier on the card) and the
#: native tier with the tier turned off.
MAIN_LEGS = {"device-parsed": None, "native-encoded": {"CSVPLUS_DEVICE_PARSE": "0"}}


def run_main_path(
    n_orders: int, seed: int, device: str, workdir: Path, profile: bool = False
) -> dict:
    """Phase 4: drive both pipelines through the public API on *device*
    and hold them against the oracle, in two legs: the default, where all
    three files must take the ``device-parsed`` tier (every column a
    dictionary column, the pack kernel launched once per column), and
    ``CSVPLUS_DEVICE_PARSE=0``, where they take ``native-encoded`` with the
    orders columns as typed lanes and no demotion.  Returns each leg's
    launches and times; *profile* adds a ``torch.profiler`` breakdown of
    one more warm run of the native leg."""
    t0 = time.perf_counter()
    data = generate(workdir, n_orders, seed)
    log(f"generated {n_orders:,} orders in {time.perf_counter() - t0:.1f}s")
    out = {"rows": n_orders, "cpu_count": os.cpu_count(), "legs": {}}
    for leg, env in MAIN_LEGS.items():
        with _env_set(_default_parse_env(device) if env is None else env):
            out["legs"][leg] = _main_leg(data, device, leg, profile)
        gc.collect()  # the leg's tables; a source and its run function form a cycle
    return out


def _main_leg(data: dict, device: str, leg: str, profile: bool) -> dict:
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.columnar import typed
    from csvplus_tpu_torch.ops import parse as P

    n_orders = data["n"]
    typed.demotions.clear()
    with recorded_pack_calls() as pack_calls:
        P.launches = 0  # the leg's ingest starts here
        t0 = time.perf_counter()
        orders = T.from_file(str(data["paths"]["orders"])).on_device(device)
        _sync(device)
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        dims, cust, prod = _index_dims(data, device)
        _sync(device)
        t_index = time.perf_counter() - t0
        pack_launches = P.launches  # ... and ends here
    tiers = {"orders": orders.plan.table.ingest_tier,
             **{k: src.plan.table.ingest_tier for k, src in dims.items()}}
    if set(tiers.values()) != {leg}:
        raise AssertionError(f"ingest tiers {tiers}, expected {leg} for all three")
    kinds = {c: orders.plan.table.columns[c].kind for c in ORDERS_COLS}
    want_kind = "int" if leg == "native-encoded" else "str"
    if set(kinds.values()) != {want_kind}:
        raise AssertionError(f"orders column kinds {kinds}, expected {want_kind} for all four")
    n_cols = sum(len(src.plan.table.columns) for src in (orders, *dims.values()))
    want_packs = n_cols if leg == "device-parsed" and device == "cuda" else 0
    if pack_launches != want_packs:
        raise AssertionError(f"{leg}: {pack_launches} pack kernel launches, expected "
                             f"{want_packs} (one per column of at most 32 bytes)")
    pack_check = check_path_packs(pack_calls, f"[{leg}] ingest", pack_launches, device)
    index_demotions = list(typed.demotions)
    log(f"[{leg}] ingest {t_ingest:.2f}s ({n_orders / t_ingest:,.0f} rows/s) on the "
        f"{tiers['orders']} tier, orders columns {kinds}; pack kernel launches "
        f"{pack_launches} for {n_cols} columns; index build (ingest, sort, unique check of "
        f"both dimensions) {t_index:.2f}s; host CPUs {os.cpu_count()}")
    scan_s = None
    if leg == "device-parsed":
        # the tier's host part alone: the numpy separator scan of the
        # orders file (after the ingest, so its seconds are not in it)
        raw = data["paths"]["orders"].read_bytes()
        t0 = time.perf_counter()
        P._offsets_np(np.frombuffer(raw, np.uint8), ord(","), raw.endswith(b"\n"))
        scan_s = time.perf_counter() - t0
        del raw
        log(f"[{leg}] the numpy separator scan of the orders file alone: {scan_s:.2f}s")

    run = run_pipelines(orders, cust, prod, data, device, f"10M {leg}",
                        typed_lanes=leg == "native-encoded")
    out = {"ingest_s": t_ingest, "index_s": t_index, "ingest_tiers": tiers,
           "separator_scan_s": scan_s,
           "pipelines": run["pipelines"], "launches": run["launches"],
           "pack_launches": pack_launches, "pack_check": pack_check,
           "mask_check": run["mask_check"], "demotions": {"index_build": [(p.decode(), n) for p, n in index_demotions],
                         "main_path": run["main_demotions"]}}
    log(f"[{leg}] demotions (prefix, rows): index builds {out['demotions']['index_build']}, "
        f"main path {out['demotions']['main_path']}")
    src_a = run["srcs"]["a"]
    _, out["stage_table"] = stage_table(f"[{leg}] warm pipeline (a) at {n_orders:,} orders",
                                        lambda: (src_a.to_device_table(), _sync(device)))
    if leg == "native-encoded":  # the costs earlier slices measured, on their tier
        out["verifier"] = verifier_cost(src_a, device)
        out["telemetry_cost"] = telemetry_cost(src_a, device)
        if profile:
            profile_pipelines(run["srcs"])
    return out


def verifier_cost(src, device: str, reps: int = 7) -> dict:
    """The plain API's warm pipeline (a) with the executor's verifier hook
    on (the default) and off (``CSVPLUS_VERIFY=0``), alternating, and the
    hook alone (``verify_before_lower`` of the plan).  Run after the
    path's launch count was read."""
    from csvplus_tpu_torch.analysis.verify import verify_before_lower

    times = {"on": [], "off": []}
    for _ in range(reps):
        for mode in ("on", "off"):
            with _env_set({} if mode == "on" else {"CSVPLUS_VERIFY": "0"}):
                t0 = time.perf_counter()
                src.to_device_table()
                _sync(device)
                times[mode].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(200):
        verify_before_lower(src.plan)
    hook_s = (time.perf_counter() - t0) / 200
    out = {"warm_on_s": float(np.median(times["on"])), "warm_off_s": float(np.median(times["off"])),
           "hook_s": hook_s, "runs_s": times}
    log(f"verifier hook: warm (a) median {out['warm_on_s'] * 1e3:.2f} ms with it, "
        f"{out['warm_off_s'] * 1e3:.2f} ms without (CSVPLUS_VERIFY=0), {reps} runs each, "
        f"alternating; verify_before_lower alone {hook_s * 1e6:.1f} us")
    return out


# -- phase 5: the streamed main path -----------------------------------------


def _ingest_streamed(path: str, device: str, env: dict) -> tuple:
    """``from_file(path).on_device(device)`` under *env* (with
    ``CSVPLUS_INGEST_WORKERS`` unset: the automatic K); (source,
    seconds)."""
    import csvplus_tpu_torch as T

    with _env_set({"CSVPLUS_INGEST_WORKERS": None, **env}):
        t0 = time.perf_counter()
        src = T.from_file(path).on_device(device)
        _sync(device)
        return src, time.perf_counter() - t0


def _sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _same_file(got: Path, want: bytes, what: str) -> None:
    import hashlib

    size, digest = got.stat().st_size, _sha256(got)
    if size != len(want) or digest != hashlib.sha256(want).hexdigest():
        raise AssertionError(f"{what}: {size} bytes sha256 {digest[:16]}, oracle "
                             f"{len(want)} bytes sha256 {hashlib.sha256(want).hexdigest()[:16]}")


SINK_COLS = ("order_id", "cust_id", "prod_id", "qty", "id", "name", "product", "price")


def _result_fields(data: dict, rows: np.ndarray) -> dict:
    """The byte matrices of pipeline (b)'s result columns for *rows*."""
    cust, prod, qty = data["cust"][rows], data["prod"][rows], data["qty"][rows]
    n = rows.size
    cid = np.hstack([_lit(n, b"c"), _digits(cust)])
    return {
        "order_id": np.hstack([_lit(n, b"o"), _digits(rows)]),
        "cust_id": cid, "id": cid,
        "name": np.hstack([_lit(n, b"name"), _digits(cust % 9973)]),
        "prod_id": np.hstack([_lit(n, b"p"), _digits(prod)]),
        "product": np.hstack([_lit(n, b"prod"), _digits(prod)]),
        "price": _smat(data["cols"]["prod"]["price"])[prod],
        "qty": _digits(qty),
    }


def csv_oracle(data: dict, keep: np.ndarray, columns) -> bytes:
    rows = np.flatnonzero(keep)
    fields = _result_fields(data, rows)
    pieces = []
    for i, c in enumerate(columns):
        pieces.append(fields[c])
        pieces.append(_lit(rows.size, b"," if i < len(columns) - 1 else b"\n"))
    return ",".join(columns).encode() + b"\n" + _lines(pieces)


def json_oracle(data: dict, keep: np.ndarray, limit: int) -> bytes:
    """Go json.Encoder's bytes: ``[`` objects with sorted keys, each
    followed by a newline, separated by commas ``]``."""
    rows = np.flatnonzero(keep)[:limit]
    fields = _result_fields(data, rows)
    n = rows.size
    pieces = []
    for i, c in enumerate(sorted(fields)):
        pieces.append(_lit(n, (b',{"' if i == 0 else b',"') + c.encode() + b'":"'))
        pieces.append(fields[c])
        pieces.append(_lit(n, b'"'))
    pieces.append(_lit(n, b"}\n"))
    return b"[" + _lines(pieces)[1:] + b"]"


def run_streamed_path(n_orders: int, seed: int, device: str, workdir: Path,
                      serve: "dict | None" = None) -> dict:
    """Phase 5: the streamed ingest tier at *n_orders*, both pipelines and
    both file sinks, held against numpy oracles; then phases 8 and 9 on
    its tables (*serve* sizes phase 9, see :func:`run_serving_path`)."""
    import torch

    from csvplus_tpu_torch.columnar import typed
    from csvplus_tpu_torch.native.scanner import _ingest_workers
    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    t0 = time.perf_counter()
    data = generate(workdir, n_orders, seed + 1, name="orders_streamed.csv")
    path = data["paths"]["orders"]
    size = path.stat().st_size
    log(f"generated {n_orders:,} orders ({size:,} bytes) in {time.perf_counter() - t0:.1f}s")
    if size < STREAM_MIN_BYTES and device == "cuda":
        raise AssertionError(f"{size} bytes is under the streamed tier's {STREAM_MIN_BYTES}")
    want_ingest = ingest_oracle(data)

    out = {"rows": n_orders, "bytes": size, "ingest": {}}
    sums_by_leg = {}
    orders = None
    # the default first (on the card the device chunk encoder, which forces
    # K = 1), then CSVPLUS_DEVICE_PARSE=0 at the automatic K; each run's
    # peak device memory is its own
    legs = {"default": _default_parse_env(device), "auto": {"CSVPLUS_DEVICE_PARSE": "0"}}
    for leg, env in legs.items():
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        P.launches = 0  # the leg's ingest starts here
        if leg == "auto":
            (src, secs), out["stage_table_ingest"] = stage_table(
                f"streamed ingest of {n_orders:,} orders at K = auto",
                lambda: _ingest_streamed(str(path), device, env))
        else:
            src, secs = _ingest_streamed(str(path), device, env)
        pack_launches = P.launches  # ... and ends here
        table = src.plan.table
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        kinds = {c: table.columns[c].kind for c in ORDERS_COLS}
        if table.ingest_tier != "streamed" or set(kinds.values()) != {"int"}:
            raise AssertionError(f"tier {table.ingest_tier}, kinds {kinds}: expected the "
                                 "streamed tier with four typed orders columns")
        acct = table.ingest_seconds
        k = acct["workers"]
        want_k = 1 if leg == "default" else _ingest_workers()
        if k != want_k:
            raise AssertionError(f"{leg} ran {k} workers, expected {want_k}")
        if pack_launches:  # typed columns never reach the encoder
            raise AssertionError(f"{leg}: {pack_launches} pack launches on four typed columns")
        sums = checksum_device_table(table, list(ORDERS_COLS), positional=True)
        if sums != want_ingest:
            raise AssertionError(f"{leg}: ingested checksums {sums} != oracle {want_ingest}")
        sums_by_leg[leg] = sums
        row = {"workers": k, "seconds": secs, "rows_per_s": n_orders / secs,
               "scan_wait_s": acct["scan_wait"], "place_s": acct["place"],
               "chunks": acct["chunks"], "peak_device_bytes": peak,
               "pack_launches": pack_launches, "env": env}
        out["ingest"][leg] = row
        log(f"streamed ingest [{leg}] K={k}: {secs:.2f}s ({n_orders / secs:,.0f} rows/s), "
            f"scan-wait {acct['scan_wait']:.2f}s, place {acct['place']:.2f}s, "
            f"{acct['chunks']} chunks, peak device memory {peak}, pack launches "
            f"{pack_launches}; tier {table.ingest_tier}, kinds {kinds}, checksums == oracle")
        if leg == "auto":
            orders = src
        del src, table
        gc.collect()  # a source and its run function form a cycle
    if sums_by_leg["default"] != sums_by_leg["auto"]:
        raise AssertionError(f"checksums differ between the legs: {sums_by_leg}")

    typed.demotions.clear()
    dims, cust, prod = _index_dims(data, device)
    run = run_pipelines(orders, cust, prod, data, device, "50M")
    out["pipelines"] = run["pipelines"]
    out["launches"] = run["launches"]
    out["mask_check"] = run["mask_check"]

    pipelines = _pipelines(data)
    b_src = run["srcs"]["b"]
    csv_path = workdir / "b.csv"
    t0 = time.perf_counter()
    b_src.to_csv_file(str(csv_path), *SINK_COLS)
    t_csv = time.perf_counter() - t0
    _same_file(csv_path, csv_oracle(data, pipelines["b"][1], SINK_COLS), "(b).to_csv_file")
    csv_bytes = csv_path.stat().st_size
    json_path = workdir / "b.json"
    t0 = time.perf_counter()
    b_src.top(100_000).to_json_file(str(json_path))
    t_json = time.perf_counter() - t0
    _same_file(json_path, json_oracle(data, pipelines["b"][1], 100_000),
               "(b).top(100000).to_json_file")
    json_bytes = json_path.stat().st_size
    out["sinks"] = {"csv_s": t_csv, "csv_bytes": csv_bytes, "csv_mb_per_s": csv_bytes / t_csv / 1e6,
                    "json_s": t_json, "json_bytes": json_bytes,
                    "json_mb_per_s": json_bytes / t_json / 1e6}
    log(f"sinks: (b).to_csv_file {csv_bytes:,} bytes in {t_csv:.2f}s "
        f"({csv_bytes / t_csv / 1e6:.1f} MB/s), (b).top(100000).to_json_file "
        f"{json_bytes:,} bytes in {t_json:.2f}s ({json_bytes / t_json / 1e6:.1f} MB/s); "
        "both == oracle bytes (size, sha256)")
    csv_path.unlink()
    json_path.unlink()
    del run, b_src
    gc.collect()  # phase 5's results; a source and its run function form a cycle
    out["plancache"] = run_plancache_path(orders, cust, prod, data, device)
    out["serving"] = run_serving_path(orders, data, device, workdir, seed, **(serve or {}))
    return out


# -- phase 6: device-lane dictionaries ---------------------------------------


def run_lane_path(n_rows: int, n_refs: int, seed: int, device: str, workdir: Path,
                  lane_threshold: "int | None" = None) -> dict:
    """Phase 6: a high-cardinality ``order_id`` that switches to
    device-lane dictionaries mid-file; *lane_threshold* (None: the
    default) sets ``CSVPLUS_DICT_DEVICE_MIN_DISTINCT`` for a small
    rehearsal."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.columnar import table as TB
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    rng = np.random.default_rng(seed + 2)
    ids = rng.permutation(n_rows)
    cust = rng.integers(0, N_CUST, n_rows)
    qty = rng.integers(1, 101, n_rows)
    path = workdir / "highcard.csv"
    t0 = time.perf_counter()
    id_mat = lambda v: np.hstack([_lit(v.size, b"ord-"), _digits(v, 8)])  # noqa: E731
    with open(path, "wb") as f:
        f.write(b"order_id,cust,qty\n")
        for lo in range(0, n_rows, 2_000_000):
            hi = min(lo + 2_000_000, n_rows)
            m = hi - lo
            f.write(_lines([id_mat(ids[lo:hi]), _lit(m, b",c"), _digits(cust[lo:hi]),
                            _lit(m, b","), _digits(qty[lo:hi]), _lit(m, b"\n")]))
    size = path.stat().st_size
    refs = rng.integers(0, n_rows + n_rows // 10, n_refs)
    probe = workdir / "refs.csv"
    with open(probe, "wb") as f:
        f.write(b"ref,note\n")
        f.write(_lines([id_mat(refs), _lit(n_refs, b",n"), _digits(np.arange(n_refs)),
                        _lit(n_refs, b"\n")]))
    log(f"generated {n_rows:,} high-cardinality rows ({size:,} bytes) and "
        f"{n_refs:,} probe refs in {time.perf_counter() - t0:.1f}s")
    if size < STREAM_MIN_BYTES and device == "cuda":
        raise AssertionError(f"{size} bytes is under the streamed tier's {STREAM_MIN_BYTES}")

    qty_s = np.arange(101).astype("S")
    want = {"order_id": _positional_sum(_fnv32_mat(id_mat(ids))),
            "cust": _positional_sum(_fnv_affix(b"c", cust)),
            "qty": _positional_sum(_fnv32(qty_s)[qty])}
    old = os.environ.get("CSVPLUS_DICT_DEVICE_MIN_DISTINCT")
    if lane_threshold is not None:
        os.environ["CSVPLUS_DICT_DEVICE_MIN_DISTINCT"] = str(lane_threshold)
    pack_calls: list = []
    try:
        TB.lane_sorts.clear()
        P.launches = 0  # the path's device encodes start here
        t0 = time.perf_counter()
        with recorded_pack_calls(pack_calls):
            src = T.from_file(str(path)).on_device(device)
            _sync(device)
        t_ingest = time.perf_counter() - t0
    finally:
        if lane_threshold is not None:
            if old is None:
                os.environ.pop("CSVPLUS_DICT_DEVICE_MIN_DISTINCT")
            else:
                os.environ["CSVPLUS_DICT_DEVICE_MIN_DISTINCT"] = old
    table = src.plan.table
    col = table.columns["order_id"]

    def unsorted(where: str) -> None:
        if col.dev_dictionary is None or col._dictionary is not None or col._dev_dict_sorted \
                or TB.lane_sorts:
            raise AssertionError(f"{where}: order_id is not an unsorted lane column "
                                 f"(lane sorts {TB.lane_sorts})")

    if table.ingest_tier != "streamed":
        raise AssertionError(f"tier {table.ingest_tier}, expected streamed")
    unsorted("after ingest")
    slots = col.dict_size
    t0 = time.perf_counter()
    sums = checksum_device_table(table, ["order_id", "cust", "qty"], positional=True)
    t_sum = time.perf_counter() - t0
    if sums != want:
        raise AssertionError(f"checksums {sums} != oracle {want}")
    unsorted("after the checksum")
    top = src.top(3).to_device_table()
    top_want = {"order_id": _positional_sum(_fnv32_mat(id_mat(ids[:3]))),
                "cust": _positional_sum(_fnv_affix(b"c", cust[:3])),
                "qty": _positional_sum(_fnv32(qty_s)[qty[:3]])}
    if checksum_device_table(top, ["order_id", "cust", "qty"], positional=True) != top_want:
        raise AssertionError("top(3) checksums != oracle")
    unsorted("after top(3)")
    log(f"lane column: ingest {t_ingest:.2f}s ({n_rows / t_ingest:,.0f} rows/s) on the "
        f"{table.ingest_tier} tier, {table.ingest_seconds['chunks']} chunks, order_id "
        f"{len(col.dev_dictionary)} lanes x {slots:,} unsorted slots; positional checksum "
        f"{t_sum:.3f}s == oracle; top(3) == oracle; still unsorted")

    t0 = time.perf_counter()
    idx = src.unique_index_on("order_id")
    _sync(device)
    t_index = time.perf_counter() - t0
    if len(TB.lane_sorts) != 1 or not col._lane_state.sorted:
        raise AssertionError(f"unique_index_on made lane sorts {TB.lane_sorts}, expected one")

    target = int(ids[n_rows // 2])
    with recorded_mask_calls() as calls:
        M.launches = 0  # the lane path's filter starts here
        t0 = time.perf_counter()
        hit = src.filter(T.Like({"order_id": f"ord-{target:08d}"})).to_rows()
        t_filter = time.perf_counter() - t0
        launches = M.launches
    want_hit = [{"order_id": f"ord-{target:08d}", "cust": f"c{cust[n_rows // 2]}",
                 "qty": str(qty[n_rows // 2])}]
    if [dict(r) for r in hit] != want_hit:
        raise AssertionError(f"Like filter found {hit}, oracle {want_hit}")
    if launches <= 0 and device == "cuda":
        raise AssertionError("the lane path's filter never launched the mask kernel")
    mask_check = check_path_masks(calls, "lane path")

    # the join: each probe ref that exists matches one row
    pos = np.empty(n_rows, np.int64)
    pos[ids] = np.arange(n_rows)
    found = refs < n_rows
    rows = np.flatnonzero(found)
    brow = pos[refs[rows]]
    t0 = time.perf_counter()
    with recorded_pack_calls(pack_calls):
        probe_src = T.from_file(str(probe)).on_device(device)
    joined = probe_src.join(idx, "ref")
    jt = joined.to_device_table()
    _sync(device)
    t_join = time.perf_counter() - t0
    pack_launches = P.launches  # ... and end here (the probe file's ingest included)
    if pack_launches <= 0 and device == "cuda":
        raise AssertionError("the lane path never launched the pack kernel")
    pack_check = check_path_packs(pack_calls, "lane path", pack_launches, device)
    jwant = {"ref": _positional_sum(_fnv32_mat(id_mat(refs[rows]))),
             "order_id": _positional_sum(_fnv32_mat(id_mat(refs[rows]))),
             "note": _positional_sum(_fnv_affix(b"n", rows)),
             "cust": _positional_sum(_fnv_affix(b"c", cust[brow])),
             "qty": _positional_sum(_fnv32(qty_s)[qty[brow]])}
    got = checksum_device_table(jt, list(jwant), positional=True)
    if jt.nrows != rows.size or got != jwant:
        raise AssertionError(f"join: {jt.nrows} rows, checksums {got}; oracle "
                             f"{rows.size} rows, {jwant}")
    csv_path = workdir / "joined.csv"
    cols = ("ref", "order_id", "cust", "qty", "note")
    t0 = time.perf_counter()
    joined.to_csv_file(str(csv_path), *cols)
    t_csv = time.perf_counter() - t0
    m = rows.size
    fields = {"ref": id_mat(refs[rows]), "order_id": id_mat(refs[rows]),
              "cust": np.hstack([_lit(m, b"c"), _digits(cust[brow])]),
              "qty": _digits(qty[brow]), "note": np.hstack([_lit(m, b"n"), _digits(rows)])}
    pieces = []
    for i, c in enumerate(cols):
        pieces += [fields[c], _lit(m, b"," if i < len(cols) - 1 else b"\n")]
    _same_file(csv_path, ",".join(cols).encode() + b"\n" + _lines(pieces), "joined.to_csv_file")
    csv_bytes = csv_path.stat().st_size
    csv_path.unlink()
    log(f"lane column: unique_index_on sorted the union on {device} once ({t_index:.2f}s, "
        f"{TB.lane_sorts[0]:,} slots); Like filter 1 row == oracle ({t_filter:.3f}s, mask "
        f"launches {launches}); join of {n_refs:,} refs {t_join:.2f}s -> {m:,} rows == oracle; "
        f"to_csv_file {csv_bytes:,} bytes in {t_csv:.2f}s == oracle bytes; pack kernel "
        f"launches {pack_launches} (K={table.ingest_seconds['workers']})")
    return {"rows": n_rows, "bytes": size, "ingest_s": t_ingest, "checksum_s": t_sum,
            "slots_unsorted": slots, "index_s": t_index, "filter_s": t_filter,
            "join_s": t_join, "join_rows": m, "csv_s": t_csv, "csv_bytes": csv_bytes,
            "launches": launches, "pack_launches": pack_launches, "pack_check": pack_check,
            "workers": table.ingest_seconds["workers"], "mask_check": mask_check}


# -- phase 7: the streamed tier's host dictionaries ---------------------------

REGIONS = np.array([b"north", b"south", b"east", b"west", b"north-east", b"north-west",
                    b"south-east", b"south-west", b"central", b"islands", b"overseas",
                    b"online"])
N_SKUS = 5_000
N_TAGS = 1_000


def run_host_dict_path(n_rows: int, seed: int, device: str, workdir: Path) -> dict:
    """Phase 7: the streamed tier's host-dictionary branch.  ``region``
    (12 words) ships uint8 codes, ``sku`` (``sku<n>x``, 5,000 values)
    uint16 codes; ``tag`` is ``t<n>`` (typed) in the first half and
    ``t%04d`` (not canonical, so a dictionary) from the middle on, so it
    demotes mid-file: its typed chunks come back from the card and are
    re-encoded, and every chunk then ships uint16 codes.  All three merge
    to sorted host unions with the codes remapped on the card."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    rng = np.random.default_rng(seed + 3)
    region = rng.integers(0, REGIONS.size, n_rows)
    sku = rng.integers(0, N_SKUS, n_rows)
    tag = rng.integers(0, N_TAGS, n_rows)
    half = n_rows // 2
    path = workdir / "hostdict.csv"
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(b"region,sku,tag\n")
        for lo in range(0, n_rows, 2_000_000):
            hi = min(lo + 2_000_000, n_rows)
            m = hi - lo
            canon = np.zeros((m, 4), np.uint8)  # "t<v>", NUL padded to 4 digits
            digits = _digits(tag[lo:hi])
            canon[:, : digits.shape[1]] = digits
            tags = np.where((np.arange(lo, hi) < half)[:, None], canon, _digits(tag[lo:hi], 4))
            f.write(_lines([_smat(REGIONS)[region[lo:hi]], _lit(m, b",sku"), _digits(sku[lo:hi]),
                            _lit(m, b"x,t"), tags, _lit(m, b"\n")]))
    size = path.stat().st_size
    log(f"generated {n_rows:,} host-dictionary rows ({size:,} bytes) in "
        f"{time.perf_counter() - t0:.1f}s")
    if size < STREAM_MIN_BYTES and device == "cuda":
        raise AssertionError(f"{size} bytes is under the streamed tier's {STREAM_MIN_BYTES}")

    skus = np.char.add(_sbytes(b"sku", np.arange(N_SKUS)), b"x")
    tags_canon = _sbytes(b"t", np.arange(N_TAGS))
    tags_pad = np.char.add(b"t", np.char.zfill(np.arange(N_TAGS).astype("S"), 4))
    first = np.arange(n_rows) < half
    hashes = {"region": _fnv32(REGIONS)[region], "sku": _fnv32(skus)[sku],
              "tag": np.where(first, _fnv32(tags_canon)[tag], _fnv32(tags_pad)[tag])}
    want_dicts = {
        "region": np.unique(REGIONS[np.unique(region)]),
        "sku": np.unique(skus[np.unique(sku)]),
        "tag": np.unique(np.concatenate([tags_canon[np.unique(tag[:half])],
                                         tags_pad[np.unique(tag[half:])]])),
    }
    cols = list(hashes)

    with recorded_pack_calls() as pack_calls:
        P.launches = 0  # the path's device encodes start here
        t0 = time.perf_counter()
        src = T.from_file(str(path)).on_device(device)
        _sync(device)
        t_ingest = time.perf_counter() - t0
    table = src.plan.table
    if table.ingest_tier != "streamed":
        raise AssertionError(f"tier {table.ingest_tier}, expected streamed")
    for c in cols:
        col = table.columns[c]
        if col.kind != "str" or col.dev_dictionary is not None:
            raise AssertionError(f"column {c}: kind {col.kind}, expected a host dictionary")
        if not np.array_equal(col.dictionary, want_dicts[c]):
            raise AssertionError(f"column {c}: dictionary != the oracle's sorted union")
    sums = checksum_device_table(table, cols, positional=True)
    want = {c: _positional_sum(h) for c, h in hashes.items()}
    if sums != want:
        raise AssertionError(f"checksums {sums} != oracle {want}")
    acct = table.ingest_seconds
    log(f"host dictionaries: ingest {t_ingest:.2f}s ({n_rows / t_ingest:,.0f} rows/s) on the "
        f"{table.ingest_tier} tier, K={acct['workers']}, scan-wait {acct['scan_wait']:.2f}s, "
        f"place {acct['place']:.2f}s, {acct['chunks']} chunks; dictionaries of "
        f"{[len(want_dicts[c]) for c in cols]} entries == oracle; checksums == oracle")

    # a filter over the widened uint8 and uint16 codes: the region and the
    # zero-padded tag of a row in the second half
    i = 3 * n_rows // 4
    with recorded_mask_calls() as calls:
        M.launches = 0  # the filter starts here
        t0 = time.perf_counter()
        hit = src.filter(T.Like({"region": REGIONS[region[i]].decode(),
                                 "tag": f"t{tag[i]:04d}"})).to_device_table()
        _sync(device)
        t_filter = time.perf_counter() - t0
        launches = M.launches
    rows = np.flatnonzero((region == region[i]) & (tag == tag[i]) & ~first)
    hwant = {c: _positional_sum(h[rows]) for c, h in hashes.items()}
    got = checksum_device_table(hit, cols, positional=True)
    if hit.nrows != rows.size or got != hwant:
        raise AssertionError(f"filter: {hit.nrows} rows, checksums {got}; oracle "
                             f"{rows.size} rows, {hwant}")
    pack_launches = P.launches  # ... and end here
    if launches <= 0 and device == "cuda":
        raise AssertionError("the host-dictionary filter never launched the mask kernel")
    if pack_launches <= 0 and device == "cuda":
        raise AssertionError("the host-dictionary path never launched the pack kernel")
    mask_check = check_path_masks(calls, "host-dictionary path")
    pack_check = check_path_packs(pack_calls, "host-dictionary path", pack_launches, device)
    log(f"host dictionaries: filter {rows.size:,} rows == oracle ({t_filter:.3f}s, mask "
        f"launches {launches}); pack kernel launches {pack_launches}")
    return {"rows": n_rows, "bytes": size, "ingest_s": t_ingest,
            "scan_wait_s": acct["scan_wait"], "place_s": acct["place"],
            "chunks": acct["chunks"], "workers": acct["workers"], "filter_s": t_filter,
            "filter_rows": int(rows.size), "launches": launches,
            "pack_launches": pack_launches, "pack_check": pack_check,
            "mask_check": mask_check}


# -- phase 8: the plan cache, cascaded and fused -----------------------------

#: What the plan cache decides for each shape of this phase, as
#: ``(fused, fused_chains, fusion_refused)`` of a cache that admitted only
#: that shape: the reference's decisions, established on the CPU in
#: ``tests/test_torch_plancache.py`` at this phase's dimension tables,
#: predicates and distinct counts, with 2,000,000 orders.  The filtered
#: pipelines fuse the filter and both joins into one FusedProbe
#: (``multiway_join_selected``); the unfiltered join (c) becomes one
#: MultiwayJoin (``multiway_join``); the cascaded leg fuses nothing.
PLANCACHE_DECISIONS = {
    "cascaded": {"a": (0, 0, 0), "b": (0, 0, 0), "c": (0, 0, 0)},
    "fused": {"a": (1, 1, 0), "b": (1, 1, 0), "c": (1, 0, 0)},
}
PLANCACHE_LEGS = {"cascaded": {"CSVPLUS_MULTIWAY": "0", "CSVPLUS_FUSE": "0"}, "fused": {}}
N_EXCEPT_PRODUCTS = 100  # a seeded subset of the 1,000 product ids


@contextlib.contextmanager
def _env_set(values: dict):
    """Set environment variables inside the block (a value of None unsets
    it), restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _table_sums(table, device: str, what: str) -> dict:
    """Positional checksums of every column, after checking the columns
    lie on *device*."""
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    for c in table.columns.values():
        if c.storage.device.type != device:
            raise AssertionError(f"{what}: result column on {c.storage.device}")
    return checksum_device_table(table, sorted(table.columns), positional=True)


def _check_oracle(table, sums: dict, want: tuple, what: str) -> None:
    n_want, want_sums, want_first = want
    if table.nrows != n_want:
        raise AssertionError(f"{what}: {table.nrows} rows, oracle {n_want}")
    if sums != want_sums:
        raise AssertionError(f"{what}: checksums {sums} != oracle {want_sums}")
    import torch

    first = table.to_rows(torch.arange(min(3, table.nrows)))
    if [dict(r) for r in first] != want_first:
        raise AssertionError(f"{what}: first rows {first} != {want_first}")


def run_plancache_path(orders, cust, prod, data: dict, device: str, label: str = "50M") -> dict:
    """Phase 8: pipelines (a) and (b) and the unfiltered join (c), built
    as plans and run through a fresh ``PlanCache`` per leg — "cascaded"
    (``CSVPLUS_MULTIWAY=0``, ``CSVPLUS_FUSE=0``, set before admission)
    and "fused" (the defaults) — cold (admission: verify + optimize) then
    warm (a hit).  Every run is held against the numpy oracle; the legs
    must be bitwise equal, the rewriter must never fail, the fusion
    decisions must be the reference's, the mask kernel must launch in
    both legs and the fused leg must run ``multiway_join`` and
    ``multiway_join_selected``.  Then one ``except_`` of a unique index
    of a seeded product subset, against its oracle."""
    import torch

    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import join as J
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.serve import PlanCache

    cuda = device == "cuda"
    cases = {name: (orders.filter(pred).join(cust, "cust_id").join(prod).plan, keep)
             for name, (pred, keep) in _pipelines(data).items()}
    cases["c"] = (orders.join(cust, "cust_id").join(prod).plan, np.ones(data["n"], dtype=bool))
    t0 = time.perf_counter()
    oracles = {}
    for name, (plan, keep) in cases.items():
        cols = sorted(set(ORDERS_COLS) | {"id", "name", "prod_id", "product", "price"})
        oracles[name] = oracle(data, keep, cols)
    log(f"{label} plan cache: oracles of {sorted(cases)} in {time.perf_counter() - t0:.1f}s")

    out = {"legs": {}}
    sums_by_leg = {}
    with recorded_mask_calls() as calls:
        for leg, env in PLANCACHE_LEGS.items():
            with _env_set(env):
                cache = PlanCache()
                M.launches = 0  # this leg's run starts here
                J.expand_paths.clear()
                runs = {}
                sums_by_leg[leg] = {}
                for name, (plan, _) in cases.items():
                    gc.collect()
                    if cuda:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    exe = cache.executable_for(plan)  # a miss: verify + optimize
                    t_admit = time.perf_counter() - t0
                    hits = cache.stats()["hits"]
                    t0 = time.perf_counter()
                    cold = exe.run(plan)
                    _sync(device)
                    t_cold = time.perf_counter() - t0
                    peak = torch.cuda.max_memory_allocated() - base if cuda else None
                    cold_sums = _table_sums(cold, device, f"{label} {leg} ({name}) cold")
                    _check_oracle(cold, cold_sums, oracles[name], f"{label} {leg} ({name}) cold")
                    cold_cols = list(cold.columns)
                    del cold
                    t0 = time.perf_counter()
                    warm = cache.execute(plan)
                    _sync(device)
                    t_warm = time.perf_counter() - t0
                    if cache.stats()["hits"] != hits + 1:
                        raise AssertionError(f"{label} {leg} ({name}): the warm run missed")
                    warm_sums = _table_sums(warm, device, f"{label} {leg} ({name}) warm")
                    _check_oracle(warm, warm_sums, oracles[name], f"{label} {leg} ({name}) warm")
                    if list(warm.columns) != cold_cols:
                        raise AssertionError(f"{label} {leg} ({name}): column order changed")
                    sums_by_leg[leg][name] = (warm.nrows, cold_cols, warm_sums)
                    del warm
                    steps = [s[0] for s in exe.recipe.steps] if exe.recipe else []
                    runs[name] = {"admit_s": t_admit, "cold_run_s": t_cold, "warm_s": t_warm,
                                  "peak_device_bytes_over_inputs": peak,
                                  "recipe": steps}
                    log(f"{label} {leg} ({name}): admission {t_admit:.4f}s, cold run "
                        f"{t_cold:.3f}s, warm {t_warm:.4f}s, peak device memory "
                        f"{peak} bytes over the inputs' {base if cuda else None}; recipe "
                        f"{steps}; == oracle (count, positional checksums, first rows)")
                launches = M.launches  # ... and ends here
                st = cache.stats()
            want = [sum(d[i] for d in PLANCACHE_DECISIONS[leg].values()) for i in range(3)]
            got = [st["fused"], st["fused_chains"], st["fusion_refused"]]
            if got != want:
                raise AssertionError(f"{label} {leg}: fused/fused_chains/fusion_refused {got}, "
                                     f"the reference decides {want}")
            if st["optimize_failed"] != 0 or st["lowered"] != len(cases):
                raise AssertionError(f"{label} {leg}: plan cache stats {st}")
            if launches <= 0 and cuda:
                raise AssertionError(f"{label} {leg}: the mask kernel never launched")
            paths = dict(J.expand_paths)
            out["legs"][leg] = {"runs": runs, "stats": st, "launches": launches,
                                "expand_paths": paths}
            log(f"{label} {leg} leg: stats {st}; mask kernel launches {launches}; "
                f"expand paths {paths}")
        fused_paths = out["legs"]["fused"]["expand_paths"]
        for kind in ("multiway-", "fused-"):
            if not any(p.startswith(kind) for p in fused_paths):
                raise AssertionError(f"{label}: the fused leg never took a {kind}* path")
        if sums_by_leg["cascaded"] != sums_by_leg["fused"]:
            raise AssertionError(f"{label}: the cascaded and fused legs differ")
        log(f"{label} plan cache: the cascaded and fused legs are bitwise equal "
            "(row counts, column order, positional checksums of every column)")

        # except_: the anti-join mask on the card
        rng = np.random.default_rng(data["n"])
        subset = np.sort(rng.choice(N_PROD, N_EXCEPT_PRODUCTS, replace=False))
        prods = T.from_file(str(data["paths"]["prod"])).on_device(device)
        idx = prods.filter(T.Any(*[T.Like({"prod_id": f"p{i}"}) for i in subset])) \
            .unique_index_on("prod_id")
        M.launches = 0
        t0 = time.perf_counter()
        table = orders.except_(idx, "prod_id").to_device_table()
        _sync(device)
        t_except = time.perf_counter() - t0
        except_launches = M.launches
        keep = ~np.isin(data["prod"], subset)
        sums = _table_sums(table, device, f"{label} except_")
        _check_oracle(table, sums, oracle(data, keep, sorted(ORDERS_COLS)), f"{label} except_")
        out["except"] = {"rows_out": table.nrows, "seconds": t_except,
                         "launches": except_launches}
        log(f"{label} except_ of {N_EXCEPT_PRODUCTS} product ids: {table.nrows:,} rows == "
            f"oracle in {t_except:.3f}s")
        del table
    out["mask_check"] = check_path_masks(calls, f"{label} plan cache")
    out["launches"] = out["legs"]["fused"]["launches"]
    return out


# -- phase 9: point lookups and the serving tier ----------------------------

N_SERVE_ROWS = 1_000_000  # BASELINE.json config 2: UniqueIndexOn(id) over 1M rows
N_SERVE_FIND = 10_000
N_SERVE_REQUESTS = 60_000
N_SERVE_CLIENTS = 32
N_SERVE_PLANS = 500  # cold, then as many warm
N_PLAN_PRODUCTS = 50  # the plans' filter: Any(Like prod_id p1..p50)


def _serve_csv(workdir: Path, n: int) -> "tuple[Path, np.ndarray]":
    """``bench_serve.py``'s index layout as a CSV: ``cust_id = "c" +
    str(i * 7 % 3n)`` (all distinct) and ``v = str(i)``."""
    ids = np.arange(n, dtype=np.int64) * 7 % (3 * n)
    path = workdir / "serve.csv"
    with open(path, "wb") as f:
        f.write(b"cust_id,v\n")
        f.write(_lines([_lit(n, b"c"), _digits(ids), _lit(n, b","), _digits(np.arange(n)),
                        _lit(n, b"\n")]))
    return path, ids


#: Seconds a server's stop may take to drain before the phase fails.
STOP_TIMEOUT_S = 120.0


@contextlib.contextmanager
def _running(srv):
    """Start *srv* and stop it on exit with a bounded drain, so a stalled
    dispatcher fails the phase instead of running into the time limit."""
    srv.start()
    try:
        yield srv
    finally:
        srv.stop(timeout=STOP_TIMEOUT_S)


def _closed_loop(srv, probes, clients: int, timeout: float) -> "tuple[float, list]":
    """*clients* closed-loop clients, one request in flight each, the next
    submitted from the completion callback (on the dispatcher thread), as
    ``bench_serve.py``'s headline scenario; returns (seconds, every
    request's rows in probe order)."""
    import threading

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


def _check_rows(got, want, what: str) -> None:
    """Each request's rows against its oracle rows (dicts, in order)."""
    for i, (rows, exp) in enumerate(zip(got, want)):
        if [dict(r) for r in rows] != exp:
            raise AssertionError(f"{what}: request {i}: {[dict(r) for r in rows][:3]} != "
                                 f"{exp[:3]}")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} answers for {len(want)} requests")


def _check_server_clean(srv, what: str) -> dict:
    """The recovery ladder never engaged: no retry, no degraded lookup,
    no failure, the breaker closed and never opened."""
    snap = srv.snapshot()
    br = srv.breaker.snapshot()
    if snap["degraded"] or snap["retried"] or snap["failed"] or snap["expired"]:
        raise AssertionError(f"{what}: degraded {snap['degraded']}, retried {snap['retried']}, "
                             f"failed {snap['failed']}, expired {snap['expired']}")
    if br["state"] != "closed" or br["opened_total"] != 0:
        raise AssertionError(f"{what}: breaker {br}")
    return {"latency": snap["latency"], "batch": snap["batch"], "breaker": br,
            "degraded": snap["degraded"], "retried": snap["retried"],
            "completed": snap["completed"]}


def _served(srv, probes, want, clients: int, what: str) -> dict:
    secs, got = _closed_loop(srv, probes, clients, timeout=600.0)
    _check_rows(got, want[: len(got)], what)
    snap = _check_server_clean(srv, what)
    out = {"requests": len(got), "seconds": secs, "lookups_per_s": len(got) / secs, **snap}
    lat, batch = snap["latency"], snap["batch"]
    log(f"{what}: {len(got):,} requests from {clients} closed-loop clients in {secs:.3f}s "
        f"({len(got) / secs:,.0f} lookups/s), p50 {lat['p50_ms']} ms, p99 {lat['p99_ms']} ms, "
        f"mean batch {batch['mean']}; == oracle; degraded 0, retried 0, breaker "
        f"{snap['breaker']['state']} (opened {snap['breaker']['opened_total']})")
    return out


def _no_mirrors(idx, what: str) -> None:
    dev = idx._impl.dev
    built = [name for name, col in dev.table.columns.items()
             if getattr(col, "_codes_host", None) is not None
             or getattr(col, "_values_host", None) is not None]
    if getattr(dev, "_packed_host", None) is not None or built or not idx._impl.is_lazy:
        raise AssertionError(f"{what}: a host mirror was built (keys or columns {built})")


def run_serving_path(orders, data: dict, device: str, workdir: Path, seed: int,
                     n_rows: int = N_SERVE_ROWS, n_find: int = N_SERVE_FIND,
                     n_requests: int = N_SERVE_REQUESTS, n_plans: int = N_SERVE_PLANS,
                     clients: int = N_SERVE_CLIENTS, cap: "int | None" = None) -> dict:
    """Phase 9: point lookups and the serving tier.

    (s1) BASELINE config 2: a unique index on ``cust_id`` over *n_rows*
    rows from a CSV, under the mirror cap (host mirrors); *n_find*
    uniform probes through a loop of single ``find`` calls and through
    ``find_many``, then *n_requests* through ``LookupServer`` from
    *clients* closed-loop clients.  (s2) phase 5's *orders* table, over
    the cap: ``unique_index_on("order_id")`` and ``index_on("cust_id")``
    (bounds from the device search, rows from one gather per batch, no
    host mirror); *n_requests* ``order_id`` probes (1 % absent) through
    the server; 2 x *n_plans* plans ``cust_idx.find(c).filter(Any(Like
    prod_id p1..p50))`` through ``submit_plan``, cold then warm.  Every
    answer equals a numpy oracle; the recovery ladder must never engage;
    the mask kernel launches in the plans and replays bitwise.  *cap*
    patches ``DeviceIndex.POINT_MIRROR_MAX_KEYS`` for (s2) only (the CPU
    rehearsal's small tables)."""
    import torch

    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops.join import DeviceIndex
    from csvplus_tpu_torch.serve import LookupServer

    cuda = device == "cuda"
    rng = np.random.default_rng(seed + 9)
    out = {}
    t_phase = time.perf_counter()

    # (s1) BASELINE config 2 at its published size: the mirror tier
    path, ids = _serve_csv(workdir, n_rows)
    src = T.from_file(str(path)).on_device(device)
    t0 = time.perf_counter()
    idx = src.unique_index_on("cust_id").sync()
    t_build = time.perf_counter() - t0
    table = idx._impl.dev.table
    if table.nrows * len(table.columns) > DeviceIndex.POINT_MIRROR_MAX_KEYS:
        raise AssertionError("(s1) is over the mirror cap")

    def want_s1(sel):
        return [[{"cust_id": f"c{ids[i]}", "v": str(i)}] for i in sel]

    def fresh_lru():
        table._mirror_lru = None  # each timed pass decodes from the mirrors

    warm = rng.integers(0, n_rows, 100)
    T.to_rows_many(idx.find_many([f"c{ids[i]}" for i in warm]))  # the one-time mirror downloads
    sel = rng.integers(0, n_rows, n_find)
    probes = [f"c{ids[i]}" for i in sel]
    want = want_s1(sel)
    fresh_lru()
    t0 = time.perf_counter()
    seq = [idx.find(p).to_rows() for p in probes]
    t_seq = time.perf_counter() - t0
    _check_rows(seq, want, "(s1) sequential find")
    fresh_lru()
    t0 = time.perf_counter()
    many = T.to_rows_many(idx.find_many(probes))
    t_many = time.perf_counter() - t0
    _check_rows(many, want, "(s1) find_many")
    s1 = {"rows": n_rows, "build_s": t_build, "find_lookups_per_s": n_find / t_seq,
          "find_many_lookups_per_s": n_find / t_many}
    log(f"(s1) {n_rows:,}-row unique index on cust_id built in {t_build:.3f}s; "
        f"{n_find:,} probes: sequential find {n_find / t_seq:,.0f} lookups/s, find_many "
        f"{n_find / t_many:,.0f} lookups/s; both == oracle")
    sel = rng.integers(0, n_rows, n_requests)
    fresh_lru()
    with _running(LookupServer(idx)) as srv:
        s1["server"] = _served(srv, [f"c{ids[i]}" for i in sel], want_s1(sel), clients,
                               "(s1) server")
    out["s1"] = s1
    del src, idx, table, seq, many
    gc.collect()

    # (s2) over the cap, on phase 5's table
    old_cap = DeviceIndex.POINT_MIRROR_MAX_KEYS
    if cap is not None:
        DeviceIndex.POINT_MIRROR_MAX_KEYS = cap
    try:
        n = data["n"]
        if n <= DeviceIndex.POINT_MIRROR_MAX_KEYS:
            raise AssertionError(f"(s2) {n} keys are not over the mirror cap")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else None
        t0 = time.perf_counter()
        order_idx = orders.unique_index_on("order_id").sync()
        t_order = time.perf_counter() - t0
        t0 = time.perf_counter()
        cust_idx = orders.index_on("cust_id").sync()
        t_cust = time.perf_counter() - t0
        log(f"(s2) {n:,}-order indexes: unique_index_on(order_id) {t_order:.3f}s, "
            f"index_on(cust_id) {t_cust:.3f}s")
        cust, prod, qty = data["cust"], data["prod"], data["qty"]

        def order_row(i):
            return {"order_id": f"o{i}", "cust_id": f"c{cust[i]}", "prod_id": f"p{prod[i]}",
                    "qty": str(qty[i])}

        sel = rng.integers(0, n, n_requests)
        absent = np.arange(0, n_requests, 100)  # 1 % of the probes miss
        probes = [f"o{i}" for i in sel]
        want = [[order_row(i)] for i in sel]
        for j, k in enumerate(absent):
            probes[k] = f"o{n + j}"
            want[k] = []
        with _running(LookupServer(order_idx)) as srv:
            s2 = {"build_order_id_s": t_order, "build_cust_id_s": t_cust,
                  "server": _served(srv, probes, want, clients, "(s2) order_id server")}
        # one served batch, stage by stage: the watermark closes it at 32
        with _running(LookupServer(order_idx, tick_us=1_000_000, max_batch=32)) as srv:
            batch, s2["stage_table_batch"] = stage_table(
                "one served batch of 32 (s2) order_id lookups",
                lambda: [f.result(timeout=600.0) for f in [srv.submit(p) for p in probes[:32]]])
            _check_rows(batch, want[:32], "(s2) one served batch")
            if srv.snapshot()["batch"]["batches"] != 1:
                raise AssertionError(f"(s2) the 32 lookups ran in {srv.snapshot()['batch']}")

        # plans: a Lookup leaf under a mask-kernel filter, cold then warm
        chosen = rng.integers(0, N_CUST, 2 * n_plans)
        pred = T.Any(*[T.Like({"prod_id": f"p{i}"}) for i in range(1, N_PLAN_PRODUCTS + 1)])
        rows = np.flatnonzero(np.isin(cust, chosen))
        rows = rows[np.argsort(cust[rows], kind="stable")]  # the index's stable key order
        lo = np.searchsorted(cust[rows], chosen, side="left")
        hi = np.searchsorted(cust[rows], chosen, side="right")
        want = []
        for a, b in zip(lo, hi):
            r = rows[a:b]
            r = r[(prod[r] >= 1) & (prod[r] <= N_PLAN_PRODUCTS)]
            want.append([order_row(i) for i in r])
        t0 = time.perf_counter()
        plans = [cust_idx.find(f"c{c}").filter(pred).plan for c in chosen]
        t_find = time.perf_counter() - t0
        if not all(type(p.child).__name__ == "Lookup" for p in plans):
            raise AssertionError("(s2) a find result carries no Lookup leaf")
        passes = {}
        with recorded_mask_calls() as calls:
            with _running(LookupServer(cust_idx)) as srv:
                M.launches = 0  # the plans' run starts here
                for name, chunk in (("cold", plans[:n_plans]), ("warm", plans[n_plans:])):
                    before = srv.plancache.stats()
                    t0 = time.perf_counter()
                    futs = [srv.submit_plan(p) for p in chunk]
                    tables = [f.result(timeout=600.0) for f in futs]
                    secs = time.perf_counter() - t0
                    after = srv.plancache.stats()
                    passes[name] = {"plans": len(chunk), "seconds": secs,
                                    "plans_per_s": len(chunk) / secs,
                                    "hits": after["hits"] - before["hits"],
                                    "lowered": after["lowered"] - before["lowered"]}
                    for t in tables:
                        for c in t.columns.values():
                            if c.storage.device.type != device:
                                raise AssertionError(f"(s2) {name} plan result on "
                                                     f"{c.storage.device}")
                    lo_ = 0 if name == "cold" else n_plans
                    _check_rows([t.to_rows() for t in tables], want[lo_:lo_ + len(chunk)],
                                f"(s2) {name} plans")
                    del tables, futs
                launches = M.launches  # ... and ends here
                plans_snap = _check_server_clean(srv, "(s2) plans")
        if passes["warm"]["hits"] != n_plans or passes["warm"]["lowered"] != 0:
            raise AssertionError(f"(s2) the warm plan pass was not all hits: {passes['warm']}")
        if launches <= 0 and cuda:
            raise AssertionError("(s2) the plans never launched the mask kernel")
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        _no_mirrors(order_idx, "(s2) unique index on order_id")
        _no_mirrors(cust_idx, "(s2) index on cust_id")
        s2.update({"plan_find_s": t_find, "plans": passes, "plan_server": plans_snap,
                   "launches": launches, "peak_device_bytes_over_inputs": peak,
                   "input_device_bytes": base})
        log(f"(s2) {2 * n_plans} plans find(c).filter(Any(Like prod_id p1..p{N_PLAN_PRODUCTS})) "
            f"(finds {t_find:.2f}s): cold {passes['cold']['plans_per_s']:,.0f} plans/s, warm "
            f"{passes['warm']['plans_per_s']:,.0f} plans/s (all hits, lowered flat); mask "
            f"kernel launches {launches}; == oracle; results on {device}; no host mirror; "
            f"peak device memory {peak} bytes over the inputs' {base}")
        out["s2"] = s2
        del order_idx, cust_idx, plans
        gc.collect()
    finally:
        DeviceIndex.POINT_MIRROR_MAX_KEYS = old_cap
    out["mask_check"] = check_path_masks(calls, "serving plans")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 9 (serving) {out['seconds']:.1f}s")
    return out


# -- the stage tables ---------------------------------------------------------


def stage_table(title: str, fn) -> "tuple[object, dict]":
    """Run *fn()* under ``telemetry.collect()`` and print the merged stage
    table: each stage's rows in and out, seconds and share of the window
    (nested stages overlap: a ``Join`` row holds its ``join:*`` rows), then
    the counters and the host-sync elements.  Returns (fn's result, the
    table as a dict)."""
    from csvplus_tpu_torch.utils.observe import telemetry

    with telemetry.collect():
        t0 = time.perf_counter()
        result = fn()
        window = time.perf_counter() - t0
        merged = telemetry.merged_stages()
        counts = [r.stage for r in telemetry.records]
        counters = dict(telemetry.counters)
        syncs = telemetry.host_sync_elements
    stages = [{"stage": r.stage, "records": counts.count(r.stage), "rows_in": r.rows_in,
               "rows_out": r.rows_out, "seconds": r.seconds, "share": r.seconds / window,
               **{k: v for k, v in r.extra.items() if k.endswith("_s") and k != "per_worker_busy_s"}}
              for r in merged]
    log(f"stage table: {title}; window {window * 1e3:.3f} ms")
    log(f"  {'stage':<26} {'records':>7} {'rows in':>12} {'rows out':>12} {'ms':>11} {'share':>7}")
    for s in stages:
        extra = {k: v for k, v in s.items() if k.endswith("_s")}
        log(f"  {s['stage']:<26} {s['records']:>7} {s['rows_in']:>12,} {s['rows_out']:>12,} "
            f"{s['seconds'] * 1e3:11.3f} {100 * s['share']:6.1f}%"
            + (f"  {extra}" if extra else ""))
    log(f"  counters {counters}; host-sync elements {syncs}")
    return result, {"title": title, "window_s": window, "stages": stages,
                    "counters": counters, "host_sync_elements": syncs}


def telemetry_cost(src, device: str, reps: int = 7) -> dict:
    """Warm *src* with telemetry off and on, alternating, *reps* each:
    the medians, and the number of ``torch.cuda.synchronize`` calls the
    run itself made (off: none, there is no barrier; on: the stages'
    barriers).  Run after the path's launch count was read."""
    import torch

    from csvplus_tpu_torch.utils.observe import telemetry

    times = {"off": [], "on": []}
    syncs = {"off": 0, "on": 0}
    real_sync = torch.cuda.synchronize

    def counting_sync(*a, **k):
        syncs[mode] += 1
        return real_sync(*a, **k)

    for _ in range(reps):
        for mode in ("off", "on"):
            with telemetry.collect() if mode == "on" else contextlib.nullcontext():
                torch.cuda.synchronize = counting_sync
                try:
                    t0 = time.perf_counter()
                    src.to_device_table()
                finally:
                    torch.cuda.synchronize = real_sync
                _sync(device)
                times[mode].append(time.perf_counter() - t0)
    if syncs["off"]:
        raise AssertionError(f"telemetry off: the run synchronized {syncs['off']} times")
    if device == "cuda" and not syncs["on"]:
        raise AssertionError("telemetry on: no stage barrier synchronized")
    out = {"off_s": float(np.median(times["off"])), "on_s": float(np.median(times["on"])),
           "synchronizes": syncs, "runs_s": times}
    log(f"telemetry cost: warm (a) median {out['off_s'] * 1e3:.3f} ms off, "
        f"{out['on_s'] * 1e3:.3f} ms on (collecting, with barriers), {reps} runs each, "
        f"alternating; synchronize calls off {syncs['off']}, on {syncs['on']}")
    return out


# -- phase 10: BASELINE config 4, duplicate resolution -----------------------

N_DEDUP_ROWS = 50_000_000  # BASELINE.json config 4: 50M rows, 10 % duplicates
N_DEDUP_DISTINCT = 45_000_000
N_DEDUP_FIND = 10_000


def _dedup_data(workdir: Path, n: int, n_distinct: int, seed: int) -> dict:
    """``order_id,cust_id,qty,ts`` x *n*: *n_distinct* ids once each and
    ``n - n_distinct`` rows re-using a seeded draw of them, in a seeded
    row order; ``order_id = o%08d`` (zero-padded: a string column, whose
    byte order is the numeric order), ``cust_id = c<i>`` over 100,000
    customers, ``qty`` 1-100, ``ts`` the row number."""
    rng = np.random.default_rng(seed + 10)
    ids = rng.permutation(np.concatenate([
        np.arange(n_distinct), rng.integers(0, n_distinct, n - n_distinct)]))
    cust = rng.integers(0, N_CUST, n)
    qty = rng.integers(1, 101, n)
    path = workdir / "dedup.csv"
    with open(path, "wb") as f:
        f.write(b"order_id,cust_id,qty,ts\n")
        for lo in range(0, n, 2_000_000):
            hi = min(lo + 2_000_000, n)
            m = hi - lo
            f.write(_lines([_lit(m, b"o"), _digits(ids[lo:hi], 8), _lit(m, b",c"),
                            _digits(cust[lo:hi]), _lit(m, b","), _digits(qty[lo:hi]),
                            _lit(m, b","), _digits(np.arange(lo, hi)), _lit(m, b"\n")]))
    return {"path": path, "ids": ids, "cust": cust, "qty": qty, "n": n,
            "n_distinct": n_distinct}


def _dedup_oracle(d: dict) -> dict:
    """Index order (the key's byte order, stable), the run boundaries, and
    per-column row hashes, all from numpy."""
    ids, n = d["ids"], d["n"]
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    neq = sid[1:] != sid[:-1]
    starts = np.concatenate([[True], neq])
    ends = np.concatenate([neq, [True]])
    nd = d["n_distinct"]
    hashes = {
        "order_id": (_fnv32_mat(np.hstack([_lit(nd, b"o"), _digits(np.arange(nd), 8)])), ids),
        "cust_id": (_fnv_affix(b"c", np.arange(N_CUST)), d["cust"]),
        "qty": (_fnv32(np.arange(101).astype("S")), d["qty"]),
        "ts": (_fnv_affix(b"", np.arange(n)), None),
    }
    return {"order": order, "first": order[starts], "last": order[ends],
            "groups": int((starts & ~ends).sum()), "hashes": hashes}


def _dedup_sums(oracle: dict, rows: np.ndarray) -> dict:
    """Positional checksums of the index whose rows, in index order, are
    the file rows *rows*."""
    out = {}
    for c, (h, key) in oracle["hashes"].items():
        out[c] = _positional_sum(h[rows] if key is None else h[key[rows]])
    return out


def _check_index(idx, oracle: dict, rows: np.ndarray, device: str, what: str) -> dict:
    """The index equals the oracle (row count, positional checksums) and
    lies on the card: device-lazy, every column's tensors on *device*."""
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    impl = idx._impl
    if impl.dev is None or not impl.is_lazy:
        raise AssertionError(f"{what}: the index left the device (dev {impl.dev is not None}, "
                             f"lazy {impl.is_lazy})")
    table = impl.dev.table
    for name, c in table.columns.items():
        if c.storage.device.type != device:
            raise AssertionError(f"{what}: column {name} on {c.storage.device}")
    want = _dedup_sums(oracle, rows)
    got = checksum_device_table(table, list(want), positional=True)
    if table.nrows != rows.size or got != want:
        raise AssertionError(f"{what}: {table.nrows} rows, checksums {got}; oracle "
                             f"{rows.size} rows, {want}")
    return got


def run_dedup_path(n_rows: int, n_distinct: int, seed: int, device: str, workdir: Path,
                   n_find: int = N_DEDUP_FIND, lane_threshold: "int | None" = None) -> dict:
    """Phase 10: BASELINE config 4 through the public API.  The streamed
    ingest of *n_rows* with *n_distinct* distinct ``order_id`` values (a
    lane-dictionary column); (i) ``index_on("order_id")`` then
    ``resolve_duplicates("first")``, and on a fresh index ``"last"``;
    (ii) on a fresh index the member-returning callback that keeps each
    order's latest version (max ``ts``), under ``telemetry.collect()``;
    (iii) ``write_to`` of (ii)'s index and ``load_index`` on *device*.
    Every result equals the numpy oracle, each dedup leaves the index on
    the card, the callback runs once per duplicate group, and the reload
    builds no host dictionary and answers *n_find* ``find_many`` probes
    (1 % absent) as the oracle does.  The path runs no filter: the mask
    kernel's count is set to 0 before the ingest and read after the
    ``find_many``, and must stay 0 on the card; any recorded mask call is
    replayed against the plain version.  *lane_threshold* sets
    ``CSVPLUS_DICT_DEVICE_MIN_DISTINCT`` for a small rehearsal."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P

    t0 = time.perf_counter()
    d = _dedup_data(workdir, n_rows, n_distinct, seed)
    path = d["path"]
    size = path.stat().st_size
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = _dedup_oracle(d)
    t_oracle = time.perf_counter() - t0
    log(f"phase 10: generated {n_rows:,} rows ({size:,} bytes, {n_distinct:,} distinct ids, "
        f"{oracle['groups']:,} duplicate groups) in {t_gen:.1f}s; numpy oracle {t_oracle:.1f}s")
    if size < STREAM_MIN_BYTES and device == "cuda":
        raise AssertionError(f"{size} bytes is under the streamed tier's {STREAM_MIN_BYTES}")
    out = {"rows": n_rows, "bytes": size, "distinct": n_distinct, "groups": oracle["groups"]}

    with recorded_mask_calls() as mask_calls, recorded_pack_calls() as pack_calls:
        M.launches = 0  # the path's run starts here
        P.launches = 0
        with _env_set({} if lane_threshold is None
                      else {"CSVPLUS_DICT_DEVICE_MIN_DISTINCT": str(lane_threshold)}):
            t0 = time.perf_counter()
            src = T.from_file(str(path)).on_device(device)
            _sync(device)
            t_ingest = time.perf_counter() - t0
        path.unlink()  # on the card now
        table = src.plan.table
        kinds = {c: table.columns[c].kind for c in table.columns}
        lane = table.columns["order_id"]
        if table.ingest_tier != "streamed" or kinds != {"order_id": "str", "cust_id": "int",
                                                         "qty": "int", "ts": "int"}:
            raise AssertionError(f"tier {table.ingest_tier}, kinds {kinds}")
        if lane.dev_dictionary is None or lane._dictionary is not None:
            raise AssertionError("order_id is not a lane-dictionary column")
        out["ingest"] = {"seconds": t_ingest, "rows_per_s": n_rows / t_ingest}
        log(f"phase 10 ingest {t_ingest:.2f}s ({n_rows / t_ingest:,.0f} rows/s) on the "
            f"{table.ingest_tier} tier, kinds {kinds}, order_id a lane column "
            f"({len(lane.dev_dictionary)} lanes)")

        def build(what: str):
            t0 = time.perf_counter()
            idx = src.index_on("order_id").sync()
            secs = time.perf_counter() - t0
            _check_index(idx, oracle, oracle["order"], device, f"{what} index_on")
            out[f"index_on_{what}"] = {"seconds": secs, "rows_per_s": n_rows / secs}
            log(f"phase 10 index_on(order_id) for {what}: {secs:.2f}s ({n_rows / secs:,.0f} rows/s)"
                f"; == oracle; on {device}")
            return idx

        def dedup(idx, how, what: str, want: np.ndarray, title: "str | None" = None) -> float:
            def run():
                idx.resolve_duplicates(how)
                idx.sync()

            t0 = time.perf_counter()
            if title is None:
                run()
            else:
                _, out[f"stage_table {what}"] = stage_table(title, run)
            secs = time.perf_counter() - t0
            _check_index(idx, oracle, want, device, what)
            out[what] = {"seconds": secs, "rows_per_s": n_rows / secs, "rows_out": int(want.size)}
            log(f"phase 10 {what}: {secs:.2f}s ({n_rows / secs:,.0f} rows/s) -> {want.size:,} rows"
                f" == oracle; the index still on {device} (device-lazy)")
            return secs

        for policy in ("first", "last"):  # (i)
            idx = build(policy)
            dedup(idx, policy, f"resolve_duplicates({policy!r})", oracle[policy])
            del idx
            gc.collect()

        idx = build("callback")  # (ii)
        calls = [0]

        def latest(group):
            calls[0] += 1
            return max(group, key=lambda r: int(r["ts"]))

        dedup(idx, latest, "callback dedup", oracle["last"],
              title="phase 10 callback dedup, resolve_duplicates(latest ts)")
        if calls[0] != oracle["groups"]:
            raise AssertionError(f"the callback ran {calls[0]} times for {oracle['groups']} groups")
        out["callback dedup"]["calls"] = calls[0]
        log(f"phase 10 callback: {calls[0]:,} calls == {oracle['groups']:,} duplicate groups")
        written = _check_index(idx, oracle, oracle["last"], device, "before write_to")

        idx_path = workdir / "dedup.idx"  # (iii)
        t0 = time.perf_counter()
        idx.write_to(str(idx_path))
        t_write = time.perf_counter() - t0
        file_bytes = idx_path.stat().st_size
        del idx, src, table, lane
        gc.collect()
        t0 = time.perf_counter()
        loaded = T.load_index(str(idx_path), device=device).sync()
        t_load = time.perf_counter() - t0
        idx_path.unlink()
        got = _check_index(loaded, oracle, oracle["last"], device, "load_index")
        lcol = loaded._impl.dev.table.columns["order_id"]
        if got != written or lcol.dev_dictionary is None or lcol._dictionary is not None:
            raise AssertionError("the reloaded index differs or rebuilt the host dictionary")
        rng = np.random.default_rng(seed + 11)
        pick = rng.integers(0, n_distinct, n_find)
        absent = np.arange(0, n_find, 100)
        pick[absent] = n_distinct + absent  # 1 % of the probes miss
        last = oracle["last"]  # the kept row of id x is last[x]: every id occurs
        want = [[] if x >= n_distinct else [{
            "order_id": f"o{x:08d}", "cust_id": f"c{d['cust'][last[x]]}",
            "qty": str(d["qty"][last[x]]), "ts": str(last[x])}] for x in pick.tolist()]
        t0 = time.perf_counter()
        found = T.to_rows_many(loaded.find_many([f"o{x:08d}" for x in pick.tolist()]))
        t_find = time.perf_counter() - t0
        _check_rows(found, want, "phase 10 find_many on the reloaded index")
        launches = M.launches  # ... and ends here
        pack_launches = P.launches
    if launches and device == "cuda":
        raise AssertionError(f"config 4's dedup launched the mask kernel {launches} times")
    if pack_launches <= 0 and device == "cuda":
        raise AssertionError("config 4's ingest never launched the pack kernel")
    out["launches"] = launches
    out["pack_launches"] = pack_launches
    log(f"config 4 dedup: mask kernel launches {launches}, pack kernel launches "
        f"{pack_launches}")
    out["mask_check"] = check_path_masks(mask_calls, "config 4 dedup")
    out["pack_check"] = check_path_packs(pack_calls, "config 4 dedup", pack_launches, device)
    out["write"] = {"seconds": t_write, "bytes": file_bytes, "rows_per_s": last.size / t_write}
    out["load"] = {"seconds": t_load, "rows_per_s": last.size / t_load}
    out["find_many"] = {"probes": n_find, "seconds": t_find, "lookups_per_s": n_find / t_find}
    log(f"phase 10 write_to {t_write:.2f}s ({file_bytes:,} bytes, {last.size / t_write:,.0f} "
        f"rows/s); load_index {t_load:.2f}s ({last.size / t_load:,.0f} rows/s) == the written "
        f"index, order_id still lanes (no host dictionary); find_many of {n_find:,} probes "
        f"{t_find:.3f}s == oracle")
    del loaded
    gc.collect()
    return out


# -- phase 11: BASELINE config 1, Filter -> Map -> to_csv_file --------------

N_PEOPLE = 10_000_000
PEOPLE_NAMES = np.array([b"Amelia", b"Olivia", b"Emily", b"Ava", b"Isla",
                         b"Oliver", b"Jack", b"Harry", b"Jacob", b"Charlie"])
PEOPLE_SURNAMES = np.array([b"Smith", b"Jones", b"Taylor", b"Williams", b"Brown", b"Davies",
                            b"Evans", b"Wilson", b"Thomas", b"Roberts", b"Johnson", b"Lewis"])


def run_config1_path(n_rows: int, seed: int, device: str, workdir: Path) -> dict:
    """Phase 11: ``from_file(people).on_device().filter(Like{name: Amelia})
    .map(SetValue(name, Julia)).to_csv_file(out, "name", "surname")`` over
    *n_rows* people in the test corpus's layout (``id,name,surname,born``,
    the corpus's 10 names and 12 surnames drawn from the seed), byte-equal
    to the file numpy builds; the filter's mask calls replayed against the
    plain version."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P

    rng = np.random.default_rng(seed + 12)
    name = rng.integers(0, PEOPLE_NAMES.size, n_rows)
    surname = rng.integers(0, PEOPLE_SURNAMES.size, n_rows)
    born = 1916 + rng.integers(0, 90, n_rows)
    path = workdir / "people.csv"
    t0 = time.perf_counter()
    names_m, surnames_m = _smat(PEOPLE_NAMES), _smat(PEOPLE_SURNAMES)
    with open(path, "wb") as f:
        f.write(b"id,name,surname,born\n")
        for lo in range(0, n_rows, 2_000_000):
            hi = min(lo + 2_000_000, n_rows)
            m = hi - lo
            f.write(_lines([_digits(np.arange(lo, hi)), _lit(m, b","), names_m[name[lo:hi]],
                            _lit(m, b","), surnames_m[surname[lo:hi]], _lit(m, b","),
                            _digits(born[lo:hi]), _lit(m, b"\n")]))
    size = path.stat().st_size
    keep = name == 0  # Amelia
    m = int(keep.sum())
    want = b"name,surname\n" + _lines([_lit(m, b"Julia,"), surnames_m[surname[keep]],
                                       _lit(m, b"\n")])
    log(f"phase 11: generated {n_rows:,} people ({size:,} bytes) in "
        f"{time.perf_counter() - t0:.1f}s")
    out_path = workdir / "julia.csv"
    with recorded_mask_calls() as calls, recorded_pack_calls() as pack_calls:
        M.launches = 0  # the path's run starts here
        P.launches = 0
        t0 = time.perf_counter()
        src = T.from_file(str(path)).on_device(device)
        _sync(device)
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        src.filter(T.Like({"name": "Amelia"})).map(T.SetValue("name", "Julia")).to_csv_file(
            str(out_path), "name", "surname")
        t_pipe = time.perf_counter() - t0
        launches = M.launches  # ... and ends here
        pack_launches = P.launches
    _same_file(out_path, want, "config 1 to_csv_file")
    out_bytes = out_path.stat().st_size
    tier = src.plan.table.ingest_tier
    out_path.unlink()
    path.unlink()
    if launches <= 0 and device == "cuda":
        raise AssertionError("config 1's filter never launched the mask kernel")
    mask_check = check_path_masks(calls, "config 1")
    pack_check = check_path_packs(pack_calls, "config 1", pack_launches, device)
    log(f"phase 11 (config 1): ingest {t_ingest:.2f}s on the {tier} tier; filter -> map -> "
        f"to_csv_file {t_pipe:.2f}s ({size / t_pipe / 1e6:.1f} MB/s of input, "
        f"{m:,} rows, {out_bytes:,} bytes) == oracle bytes (size, sha256); mask kernel "
        f"launches {launches}, pack kernel launches {pack_launches}")
    return {"rows": n_rows, "bytes": size, "ingest_s": t_ingest, "ingest_tier": tier,
            "pipeline_s": t_pipe, "input_mb_per_s": size / t_pipe / 1e6,
            "rows_out": m, "out_bytes": out_bytes, "launches": launches,
            "pack_launches": pack_launches, "pack_check": pack_check,
            "mask_check": mask_check}


# -- phase 12: mutable indexes and the server's writes ------------------------

STORAGE_BATCH_ROWS = 2_000  # bench_delta.py's append batch
STORAGE_LOOKUPS = 1_500  # bench_delta.py's probes per latency scenario


class _StreamOracle:
    """The logical row stream of a mutable index in numpy: segments of
    (key, value) 'S' arrays in append order, a delete erasing its key from
    every earlier segment; :meth:`sums` gives the positional checksums of
    the stable key order, as ``index_checksums`` of a rebuild gives them."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        self.segs = [(keys, vals)]

    def append(self, keys: np.ndarray, vals: np.ndarray) -> None:
        self.segs.append((keys, vals))

    def delete(self, key: bytes) -> None:
        self.segs = [(k[k != key], v[k != key]) for k, v in self.segs]

    def rows_of(self, key: bytes) -> list:
        return [{"cust_id": key.decode(), "v": v.decode()}
                for k, vs in self.segs for v in vs[k == key]]

    def sums(self) -> dict:
        keys = np.concatenate([k for k, _ in self.segs])
        vals = np.concatenate([v for _, v in self.segs])
        order = np.argsort(keys, kind="stable")
        return {"cust_id": _positional_sum(_fnv32(keys[order])),
                "v": _positional_sum(_fnv32(vals[order]))}


def _delta_batch(start: int, n: int) -> "tuple[list, np.ndarray, np.ndarray]":
    """bench_delta.py's fresh-key rows ``d<n>`` / ``dv<n>``."""
    keys = _sbytes(b"d", np.arange(start, start + n))
    vals = _sbytes(b"dv", np.arange(start, start + n))
    rows = [{"cust_id": k.decode(), "v": v.decode()} for k, v in zip(keys, vals)]
    return rows, keys, vals


def _latencies(fn, probes) -> dict:
    lats = []
    for p in probes:
        t0 = time.perf_counter()
        fn(p)
        lats.append(time.perf_counter() - t0)
    a = np.asarray(lats)
    return {"n": len(probes), "p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p99_ms": float(np.percentile(a, 99)) * 1e3}


def run_storage_path(n_rows: int, seed: int, device: str, workdir: Path,
                     batch_rows: int = STORAGE_BATCH_ROWS,
                     n_lookups: int = STORAGE_LOOKUPS, reader_pause_s: float = 0.0) -> dict:
    """Phase 12: a durable ``MutableIndex`` on *device* over BASELINE
    config 2's layout (``_serve_csv``, *n_rows* rows, ``index_on
    ("cust_id")``), its WAL in *workdir*, in ``bench_delta.py``'s shape:
    append batches of *batch_rows* fresh keys up to 16 delta tiers,
    interleaved deletes, a leveled fold, then a full merge with two
    readers probing throughout without a pause, as the bench's
    compaction-pause scenario runs them; after recovery a CSV delta
    (``append_csv``, which must land on *device*) and a full merge with
    no reader, which shows what the readers cost the merge
    (*reader_pause_s* > 0 makes each reader sleep that long after each
    probe instead).  After each
    step the live tier set's positional checksums, the port's
    ``rebuild_reference`` and a numpy oracle of the logical stream agree;
    a tail of writes after the checkpoint is recovered by ``MutableIndex.open`` checksum-equal; then
    ``LookupServer.append`` / ``delete`` acks are read back.  No kernel is
    built or loaded in the whole phase (``RecompileWatch``)."""
    import torch

    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.obs.recompile import RecompileWatch
    from csvplus_tpu_torch.serve import LookupServer
    from csvplus_tpu_torch.storage import MutableIndex, index_checksums, rebuild_reference
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    rng = np.random.default_rng(seed + 13)
    path, ids = _serve_csv(workdir, n_rows)
    base_keys, base_vals = _sbytes(b"c", ids), np.arange(n_rows).astype("S")
    oracle = _StreamOracle(base_keys, base_vals)
    t0 = time.perf_counter()
    base = T.from_file(str(path)).on_device(device).index_on("cust_id").sync()
    wal_dir = workdir / "mutable"
    mi = MutableIndex(base, mode="append", directory=str(wal_dir))
    t_create = time.perf_counter() - t0
    path.unlink()
    out = {"rows": n_rows, "batch_rows": batch_rows, "create_s": t_create, "steps": {}}
    log(f"phase 12: durable MutableIndex over {n_rows:,} rows on {mi.device} in "
        f"{t_create:.2f}s (ingest, index_on, base write, WAL, manifest)")

    def parity(step: str, rebuild: bool = True) -> None:
        want = oracle.sums()
        merged = mi.to_index()
        if merged._impl.dev is not None:
            got = checksum_device_table(merged._impl.dev.table, ["cust_id", "v"],
                                        positional=True)
            if merged._impl.dev.table.device.type != device:
                raise AssertionError(f"{step}: the merged tiers left {device}")
        else:
            got = index_checksums(merged)
        if got != want:
            raise AssertionError(f"{step}: tier set checksums {got} != oracle {want}")
        t_r = None
        if rebuild:
            t1 = time.perf_counter()
            ref = index_checksums(rebuild_reference(mi))
            t_r = time.perf_counter() - t1
            if ref != want:
                raise AssertionError(f"{step}: rebuild_reference {ref} != oracle {want}")
        out["steps"][step] = {"deltas": mi.delta_count, "rebuild_s": t_r}
        log(f"phase 12 {step}: {mi.delta_count} delta tiers; checksums == numpy oracle"
            + (" == rebuild_reference" if rebuild else ""))

    probes = [f"c{v}" for v in rng.choice(ids, n_lookups)]
    lookups = {}
    watch = RecompileWatch().__enter__()
    mi.find_rows_many([(p,) for p in probes[:64]])
    lookups["0"] = _latencies(mi.find_rows, probes)
    append_s = 0.0
    appended = 0
    for b in range(16):
        rows, keys, vals = _delta_batch(b * batch_rows, batch_rows)
        t0 = time.perf_counter()
        mi.append_rows(rows)
        append_s += time.perf_counter() - t0
        appended += batch_rows
        oracle.append(keys, vals)
        if mi.delta_count in (4, 16):
            mi.find_rows_many([(p,) for p in probes[:64]])
            lookups[str(mi.delta_count)] = _latencies(mi.find_rows, probes)
    out["append"] = {"rows": appended, "seconds": append_s, "rows_per_s": appended / append_s}
    out["lookups"] = lookups
    log(f"phase 12 append {appended / append_s:,.0f} rows/s ({16} batches of {batch_rows:,}, "
        f"WAL fsync per batch); find p50/p99 ms at 0/4/16 tiers: "
        + ", ".join(f"{k}: {v['p50_ms']:.3f}/{v['p99_ms']:.3f}" for k, v in lookups.items()))

    # interleaved deletes (base and delta keys) and re-appends
    for i in range(4):
        for key in (base_keys[rng.integers(0, n_rows)], _sbytes(b"d", np.array([i * 37]))[0]):
            mi.delete((key.decode(),))
            oracle.delete(key)
        rows, keys, vals = _delta_batch(16 * batch_rows + 64 * i, 64)
        mi.append_rows(rows)
        oracle.append(keys, vals)
    parity("16 tiers + tombstones")
    t0 = time.perf_counter()
    step = mi.compact_step(ratio=4)
    t_fold = time.perf_counter() - t0
    if step is None or step["kind"] != "partial":
        raise AssertionError(f"the leveled fold did not run a partial merge: {step}")
    parity("leveled fold")

    # the full merge under two readers that probe without a pause, as
    # bench_delta.py's compaction-pause scenario runs them
    import threading

    n_readers = 2
    stop = threading.Event()
    started = threading.Barrier(n_readers + 1)
    per_thread: list = [[] for _ in range(n_readers)]
    errs: list = []

    def reader(slot: int) -> None:
        local = per_thread[slot]
        try:
            with torch.cuda.device(mi.device) if device == "cuda" else contextlib.nullcontext():
                started.wait(timeout=60)
                i = slot
                while not stop.is_set():
                    t1 = time.perf_counter()
                    mi.find_rows(probes[i % len(probes)])
                    local.append((t1, time.perf_counter() - t1))
                    i += n_readers
                    if reader_pause_s:
                        time.sleep(reader_pause_s)
        except BaseException as e:
            errs.append(e)
            stop.set()

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(n_readers)]
    for t in threads:
        t.start()
    started.wait(timeout=60)
    time.sleep(0.05)  # the readers reach a steady state first
    t_c0 = time.perf_counter()
    full = mi.compact_once()
    t_c1 = time.perf_counter()
    # the pass's own seconds are the merge and the new base's pruner, up to
    # the swap; the rest is the checkpoint (base file, sidecar, manifest)
    merge_parts = {"merge_and_pruner_s": full["seconds"],
                   "checkpoint_s": t_c1 - t_c0 - full["seconds"]}
    time.sleep(0.05)  # and a tail after it
    stop.set()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise AssertionError("a reader did not stop")
    if errs:
        raise errs[0]
    during = np.asarray([lat for local in per_thread for ts, lat in local
                         if t_c0 <= ts <= t_c1])
    out["compaction"] = {"leveled_fold_s": t_fold, "leveled_fold": step,
                         "full_merge_s": t_c1 - t_c0, "full_merge": full,
                         "full_merge_parts_s": merge_parts, "readers": n_readers,
                         "reader_pause_s": reader_pause_s,
                         "reads_during": int(during.size),
                         "reader_p99_ms_during": (float(np.percentile(during, 99)) * 1e3
                                                  if during.size else None)}
    parity("full merge")
    log(f"phase 12 compaction: leveled fold {t_fold:.3f}s ({step['deltas']} tiers -> 1), full "
        f"merge {t_c1 - t_c0:.3f}s ({full['rows_in']:,} -> {full['rows_out']:,} rows; "
        f"{merge_parts}) with "
        f"{during.size} reads during it, reader p99 "
        f"{out['compaction']['reader_p99_ms_during']} ms")

    # a WAL tail after the checkpoint, then recovery
    rows, keys, vals = _delta_batch(20 * batch_rows, batch_rows)
    mi.append_rows(rows)
    oracle.append(keys, vals)
    gone = base_keys[rng.integers(0, n_rows)]
    mi.delete((gone.decode(),))
    oracle.delete(gone)
    live = oracle.sums()
    mi.close()
    t0 = time.perf_counter()
    mi = MutableIndex.open(str(wal_dir), ingest_device=device)
    t_open = time.perf_counter() - t0
    if mi.recovered_records != 2:
        raise AssertionError(f"recovery replayed {mi.recovered_records} records, expected 2")
    parity("recovered")
    out["recovery"] = {"seconds": t_open, "records": mi.recovered_records, "sums": live}
    log(f"phase 12 MutableIndex.open {t_open:.2f}s, {mi.recovered_records} WAL records "
        f"replayed; checksum-equal")

    # a CSV delta through the ingest tiers, on the index's device by default
    csv_path = workdir / "delta.csv"
    ids = np.arange(40 * batch_rows, 41 * batch_rows)
    csv_path.write_bytes(b"cust_id,v\n" + _lines([
        _lit(batch_rows, b"d"), _digits(ids), _lit(batch_rows, b",dv"), _digits(ids),
        _lit(batch_rows, b"\n")]))
    t0 = time.perf_counter()
    n_csv = mi.append_csv(str(csv_path))
    t_csv = time.perf_counter() - t0
    csv_path.unlink()
    csv_tier = mi.tiers().deltas[-1].index._impl.dev
    if n_csv != batch_rows or csv_tier is None or csv_tier.table.device.type != device:
        raise AssertionError(f"append_csv: {n_csv} rows, tier on "
                             f"{None if csv_tier is None else csv_tier.table.device}")
    oracle.append(*_delta_batch(40 * batch_rows, batch_rows)[1:])
    parity("append_csv")
    # the same full merge with no reader running: what the readers cost it
    t_c0 = time.perf_counter()
    quiet = mi.compact_once()
    t_c1 = time.perf_counter()
    out["compaction"]["quiet_full_merge_s"] = t_c1 - t_c0
    out["compaction"]["quiet_full_merge"] = quiet
    out["append_csv"] = {"rows": n_csv, "seconds": t_csv}
    parity("quiet full merge")
    log(f"phase 12 append_csv of {n_csv:,} rows {t_csv:.3f}s on {device}; full merge with no "
        f"reader {t_c1 - t_c0:.3f}s ({quiet['rows_in']:,} -> {quiet['rows_out']:,} rows; "
        f"merge and pruner {quiet['seconds']:.3f}s)")

    # the server's write surface: acks, then reads back
    srv = LookupServer(indexes={"m": mi})
    with _running(srv):
        rows, keys, vals = _delta_batch(30 * batch_rows, batch_rows)
        acks = [srv.submit_append(rows, index="m").result(timeout=120)]
        oracle.append(keys, vals)
        gone = keys[7]
        acks.append(srv.submit_delete(gone.decode(), index="m").result(timeout=120))
        oracle.delete(gone)
        back = {k: srv.submit(k.decode(), index="m").result(timeout=120)
                for k in (keys[0], keys[7], keys[-1], base_keys[3])}
    if acks != [batch_rows, 1]:
        raise AssertionError(f"server acks {acks}, expected [{batch_rows}, 1]")
    for k, got in back.items():
        if [dict(r) for r in got] != oracle.rows_of(k):
            raise AssertionError(f"served rows of {k!r}: {got} != {oracle.rows_of(k)}")
    cell = srv.snapshot()["by_index"]["m"]
    if (cell["append_reqs"], cell["delete_reqs"], cell["rows_appended"]) != (1, 1, batch_rows):
        raise AssertionError(f"the server's index cell {cell}")
    parity("served writes", rebuild=False)
    watch.__exit__(None, None, None)
    recompiles = watch.delta()
    if recompiles:
        raise AssertionError(f"the storage phase built or loaded kernels: {recompiles}")
    mi.close()
    shutil.rmtree(wal_dir, ignore_errors=True)
    out["server"] = {"acks": acks, "cell": {k: cell[k] for k in (
        "append_reqs", "delete_reqs", "rows_appended", "deltas_live", "wal_records",
        "wal_fsyncs")}}
    out["recompiles"] = sum(recompiles.values())
    log(f"phase 12 server: append ack {acks[0]:,} rows, delete ack {acks[1]}, reads back == "
        f"oracle; recompiles (kernels built or loaded) in the phase: {out['recompiles']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20160914)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the warm pipelines")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from csvplus_tpu_torch.ops import mask as M

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor

    from csvplus_tpu_torch.native import scanner as S
    from csvplus_tpu_torch.ops import parse as P

    log(f"host CPUs: {os.cpu_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # both nvcc and g++ together
        builds = [pool.submit(M.build), pool.submit(P.build), pool.submit(S.build)]
        for f in builds:
            f.result()
    log(f"built {M.SOURCE.relative_to(here)} and {P.SOURCE.relative_to(here)} for sm_90a "
        f"(nvcc) and {S.SOURCE.relative_to(here)} (g++) in {time.perf_counter() - t0:.2f}s")

    mask = check_mask_kernel(args.seed)
    pack = check_pack_kernel(args.seed)

    workdir = here / ".chip_smoke_data"
    workdir.mkdir(exist_ok=True)
    try:
        main_path = run_main_path(N_ORDERS, args.seed, "cuda", workdir, args.profile)
        streamed = run_streamed_path(N_ORDERS_STREAMED, args.seed, "cuda", workdir)
        lane = run_lane_path(N_LANE_ROWS, N_PROBE_REFS, args.seed, "cuda", workdir)
        host_dict = run_host_dict_path(N_HOST_DICT_ROWS, args.seed, "cuda", workdir)
        dedup = run_dedup_path(N_DEDUP_ROWS, N_DEDUP_DISTINCT, args.seed, "cuda", workdir)
        config1 = run_config1_path(N_PEOPLE, args.seed, "cuda", workdir)
        storage = run_storage_path(N_SERVE_ROWS, args.seed, "cuda", workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    plancache = streamed.pop("plancache")
    serving = streamed.pop("serving")
    legs = main_path["legs"]
    paths = {"10M device-parsed": legs["device-parsed"],
             "10M native-encoded": legs["native-encoded"], "50M streamed": streamed,
             "50M plan cache": plancache, "serving": serving,
             "14M lane dictionary": lane, "13M host dictionary": host_dict,
             "50M config 4 dedup": dedup, "10M config 1": config1}
    path_cases = sum(p["mask_check"]["cases"] for p in paths.values())
    log(f"mask kernel == plain version, bitwise, in {mask['cases']} matrix cases and "
        f"{path_cases} calls at the paths' own shapes")
    pack_paths = [p["pack_check"] for p in paths.values() if "pack_check" in p]
    log(f"pack kernel == plain version, bitwise, in {len(pack['cases'])} matrix cases and "
        f"{sum(c['cases'] for c in pack_paths)} launches at the paths' own shapes")

    shape = mask["timings"][0]  # pipeline (a)'s shape: k = 2, "all", one target each
    kernels = [{
        "name": "fused_equality_mask",
        "route": "cuda",
        "source": "csvplus_tpu_torch/csrc/mask.cu",
        "replaces": "csvplus_tpu/ops/pallas_mask.py:41",
        # the slice's paths: BASELINE config 4's dedup (phase 10, counted in
        # launches_by_path) runs no filter, so the count is config 1's
        # Filter -> Map -> CSV (phase 11)
        "launches": config1["launches"],
        "launches_by_path": {
            **{name: p["launches"] for name, p in paths.items()},
            **{f"50M plan cache {leg}": v["launches"] for leg, v in plancache["legs"].items()},
            "50M except_": plancache["except"]["launches"]},
        "max_abs_err": max([mask["max_abs_err"]]
                           + [p["mask_check"]["max_abs_err"] for p in paths.values()]),
        "ms": shape["ms"],
        "plain_ms": shape["plain_ms"],
        "bound_ms": shape["bound_ms"],
        "bound_by": shape["bound_by"],
        "library_ms": shape["library_ms"],
        "shape": f"n={shape['n']} k={shape['k']} mode={shape['mode']}",
    }, {
        "name": "pack_field_lanes",
        "route": "cuda",
        "source": "csvplus_tpu_torch/csrc/parse.cu",
        "replaces": "csvplus_tpu/ops/parse.py:78",
        # phase 4's default leg: one launch per column of the three files
        "launches": legs["device-parsed"]["pack_launches"],
        "launches_by_path": {
            "10M device-parsed": legs["device-parsed"]["pack_launches"],
            "10M native-encoded": legs["native-encoded"]["pack_launches"],
            **{f"50M streamed {leg}": v["pack_launches"]
               for leg, v in streamed["ingest"].items()},
            "14M lane dictionary": lane["pack_launches"],
            "13M host dictionary": host_dict["pack_launches"],
            "50M config 4 dedup": dedup["pack_launches"],
            "10M config 1": config1["pack_launches"]},
        "max_abs_err": max([pack["max_abs_err"]] + [c["max_abs_err"] for c in pack_paths]),
        "ms": pack["timing"]["ms"],
        "plain_ms": pack["timing"]["plain_ms"],
        "bound_ms": pack["timing"]["bound_ms"],
        "bound_by": pack["timing"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "shape": f"m={pack['timing']['m']} lanes={pack['timing']['lanes']}",
    }]
    log("pack kernel phase " + json.dumps(pack))
    log("main path phases " + json.dumps(main_path))
    log("streamed path phases " + json.dumps(streamed))
    log("plan cache path phases " + json.dumps(plancache))
    log("serving path phases " + json.dumps(serving))
    log("lane path phases " + json.dumps(lane))
    log("host dictionary path phases " + json.dumps(host_dict))
    log("config 4 dedup path phases " + json.dumps(dedup))
    log("config 1 path phases " + json.dumps(config1))
    log("storage path phases " + json.dumps(storage))
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
