#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``csvplus_tpu_torch``) on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--seed S] [--f4] [--profile]

Phases; any failure raises, exits non-zero and prints no result line:

1. Device: the card's name, and its name and power limit from nvidia-smi;
   the host's CPU count.
2. Build: ``csrc/mask.cu`` and ``csrc/parse.cu`` with nvcc for sm_90a
   and the native CSV scanner ``native/scanner.cpp`` with g++, all three
   started together; prints the seconds, and ``ptxas -v``'s registers and
   spills for each instantiation of the mask kernel.
3. Mask kernel against its plain PyTorch version on the card, bitwise:
   seeded codes with ~5 % absent cells at n = 10,000,003 (ragged on
   purpose) for k in {1, 2, 8} columns, both modes, IN-lists of 1 and 50
   targets, and at n = 1000; at both sizes also pipeline (b)'s shape
   (k = 2 "any", 50 + 1 targets), a column 4 bytes off 16-byte alignment
   (the kernel's row-at-a-time path), 12,300 targets over a span of
   24,600 (a bitmap), spans of exactly the bitmap limit (2^16 bits) and
   one past it (a search), ~60,000 typed values spread over int32 (more
   than a block's shared memory: the search in global memory),
   duplicated unsorted targets, all three tests in one call, and typed
   value lanes (arbitrary int32: negative values and targets,
   +-(2^31 - 1), a target absent from the column).  Times the kernel at
   seven shapes (device time per call, see ``_timed``), cold (cycling
   through copies of its inputs of 150 MB or more, three times the L2)
   and warm (the same inputs back to back), beside its bound, the plain
   version and, for the single-column IN-lists, ``torch.isin``; and the
   host microseconds of one call at a serving plan's size (n = 512, k =
   2), on a table-cache hit and on a miss.
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
   to 16 delta tiers, interleaved deletes, a leveled fold, with ``--f4``
   F4's probe (``settle_f4``: the same full merge on four recovered
   clones, alone, under two readers, under two pure-Python spinners and
   under two readers at a 0.5 ms interpreter switch interval, and the
   host syncs of one ``find_rows``), a full merge
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
13. Live materialized views (``csvplus_tpu_torch.views``) in
   ``bench_view.py``'s deployment: a durable append-mode ``MutableIndex``
   of 1,000,000 orders on the card (``oid = o%08d``, ``cust_id`` striped
   over 5,000 customers, ``prod_id`` over 500 products), frozen dimension
   indexes ``cust_id -> name`` and ``prod_id -> label``, and two views
   registered on a ``LookupServer`` over it: ``orders_enriched`` (the
   three-way join) and ``orders_filtered`` (the join, ``Like`` on one
   product, a ``SetValue``; the mask kernel at a write batch's size).  A
   warm-up batch, 8 batches of 1,000 rows with a delete every third, 2,000
   ``view.read()`` probes, then 4 batches and a delete through the started
   server (each in both views by the next dispatch cycle) and the chaos
   gate's ``view_refresh_crash`` case on that server (a batch and a
   delete in one write cycle whose refresh dies of a ``views:refresh``
   fatal fault: the prior snapshot stays live until the next cycle
   applies both events, and the flight dump names the site; phase 17
   reports it).  After every step both views' checksums
   equal their from-scratch ``recompute_checksums`` and a numpy oracle of
   the acked stream; every warm refresh builds, loads and lowers nothing;
   the base, every tier and both dimensions lie on ``cuda:0``; the phase's
   spans export as a Chrome trace that validates.  Then ``certify(n=3,
   device="cuda")`` over the plan space (366 plans) after resetting the
   process-wide build-side sketches, which must be ``ok``, and
   ``diff_stage_tables`` of phase 4's two warm (a) stage tables.  Prints
   refresh ms per batch (mean, max), recompute seconds and their ratio,
   read p50/p99/max and reads/s, the server's refresh-after-write
   latency, and the mask launches with their n.
14. The flagship and the multi-device primitives.  (a) runs at the end
   of each of phase 4's legs, on its 10M orders, 100,000 customers and
   1,000 products: ``models.flagship.ThreewayJoin.build(...).run()``
   (the fused route) equal to the plain API's join on the same tables,
   bitwise, and to the numpy oracle; a run against a customers index over
   a seeded 99 % of the customers (the compaction route) likewise;
   ``step()``, ``gather_columns`` and ``_fused_direct_probe`` on the 10M
   probes against numpy; the warm ``run()`` beside the warm plain-API
   join (medians of 7).  (b)-(d) run on a mesh of 8 shards all on
   ``cuda:0`` (``make_mesh(8, devices=["cuda:0"] * 8)``): what they
   measure is the partitioned code on one card, not NVLink or scaling.
   (b) the partitioned probe over 8,000,000 sorted int32 build keys (~10 %
   of the distinct keys repeated): (b1) 100,000,000 uniform probes, ~9 %
   absent and ~0.5 % -1; (b2) 50,000,000 Zipf(1.1) probes at
   ``CSVPLUS_JOIN_SKEW_THRESHOLD=0.002`` (the hot tier must engage), then
   again with ``CSVPLUS_JOIN_SKEW=0``; (b3) 25,000,000 62-bit probes over
   4,000,000 int64 keys, uniform, then Zipf(1.1) at the same threshold
   (the wide hot tier).  Every answer equals ``np.searchsorted`` left and
   right; prints seconds (cold and warm), probes/s, capacity, retries,
   hot keys, rows broadcast, host-sync elements and peak device memory.
   (c) the sample sort: 100,000,000 int32 values and 25,000,000 62-bit
   values with the iota payload, and 10,000,000 values 90 % of them one
   value, which must retry; values equal ``np.sort`` and the permutation a
   stable ``np.argsort``; prints seconds, rows/s, capacity and retries.
   (d) ``graft.entry()``'s step on the card against numpy, and
   ``graft.dryrun_multichip(8, devices=["cuda:0"] * 8)`` with its 2-D
   part.  (e) where more than one card is visible, (b1) and (c)'s int32
   sort again over ``min(count, 8)`` distinct cards and
   ``dryrun_multichip`` over them; else it prints that it did not run.
   The calls of the ported jitted functions in phase 14 are counted and
   timed (``counted_calls``); each one's calls, its time at its largest
   shape and its byte bound are printed.  Every number names the card and
   its power limit.
15. Sharded tables behind the public API: BASELINE config 5 ("8-way
   sharded 100M-row orders.csv join"), every shard on ``cuda:0`` unless
   said otherwise.  (a) 100,000,000 orders in phase 4's layout (~2.45 GB,
   the streamed tier) through ``from_file(...).on_device(mesh=make_mesh(8,
   devices=["cuda:0"] * 8))``: the chunks land on their shards
   (``ingest:shard-assemble`` with 8 shards, pre-sharded); the plain
   ``orders.join(cust, "cust_id").join(prod)`` (the broadcast tier per
   shard: 100,000 keys are under ``PARTITION_MIN_KEYS``) against the
   oracle, cold and warm (median of 5), assembling no array;
   ``workloads.sharded_join`` equal to the join's first hop; phase 4's
   pipelines (a) and (b) (the mask kernel once per shard per filter, every
   launch replayed bitwise); ``ThreewayJoin.run()`` (fused, per shard)
   equal to the plain join.  (b) 20,000,005 orders whose ``cust_id`` is
   Zipf(1.1) over a permuted rank of 1,500,000 customers (``bench.py``'s
   layout), padded on 8 shards, with ``PARTITION_MIN_KEYS`` set to
   1,000,000 and ``CSVPLUS_JOIN_SKEW_THRESHOLD=0.002`` (the reference's
   mesh bench): the three-way join takes the partitioned tier with the
   skew tier, again with ``CSVPLUS_JOIN_SKEW=0``, and fused through
   ``PlanCache`` (one ``part_info``), each equal to the oracle.  (c), at
   the end of each phase-4 leg: the leg's 10M file on 7 shards (padded:
   the device-parse tier or the typed lanes, then ``with_sharding``),
   pipelines (a) and (b), the join against phase 14 (a)'s 99 % customers
   index (unique-partial per shard), ``ThreewayJoin.run()``'s padded branch and
   ``unique_index_on("order_id")`` through the sample sort with 1,000
   seeded ``find_many`` probes.  (d) phase 14 (d)'s dry run must list
   paths 1-5 as run.  (e) where more than one card is visible, (a)'s
   ingest and join over ``min(count, 8)`` distinct cards; else it prints
   that (e) did not run.  Prints ingest seconds, K, shard rows, join
   times, capacities, retries, hot keys, rows broadcast, host-sync
   elements, assemblies and peak device memory per leg, each beside the
   card and its power limit.
16. The analysis suite (``csvplus_tpu_torch.analysis``) on the card.
   (a) After resetting the process-wide build-side sketches,
   ``report.json_payload(device="cuda")``: its ``plans`` and
   ``plan_cert`` halves must equal ``tests/data/analyze_snapshot_torch.json``
   (made on the CPU; no placement names a device) and its lint must be
   empty; then each example plan, run on the card and on the CPU, with
   equal rows and positional checksums (their filters launch the mask
   kernel; every launch is replayed bitwise).  (b) ``plan_analysis_json``
   and ``explain_text`` at full size on plans that already ran: phase 4's
   pipeline (a) over its 10M native-encoded leg and phase 15 (a)'s
   three-way join over 100M orders on 8 shards: the verdict ``ok``, each
   scan estimated at its table's row count, the rows on the ``device``
   and ``sharded`` respectively; prints the explain text and the
   analysis's milliseconds beside the plan's warm join.  (c) Three CLI
   commands in subprocesses, started together: ``lint --json`` prints
   ``[]`` and exits 0, ``env`` prints ``docs/ENV_TORCH.md`` exactly,
   ``plan-cert --device cuda --json`` exits 0.
17. The chaos gate (``csvplus_tpu_torch.resilience.chaos``) on the state
   phases 4, 9, 12 and 13 built (``run_chaos_path``): ``serve_retry`` over
   (s1)'s 1M-row index, 20,000 probes (1 in 17 a miss) from 32
   closed-loop clients under ``serve:bounds`` faults, and one (s2) plan
   with phase 9's 50-product filter retried past an ``exec:device``
   fault (the mask kernel on the retry path); ``serve_degrade`` on the
   same index (breaker, host oracle, half-open recovery) and over the
   mirror cap on (s2)'s 50M ``order_id`` index (typed failures, the
   breaker closed); ``dispatcher_crash`` with 256 requests pending;
   ``ingest_crash_recovery`` on phase 4's 10M-order file streamed in 8
   MiB chunks, on the device-parse tier (the pack kernel on every re-run
   chunk) and at K = 1, 2 and 4 without it, each placed table's
   checksums equal to the fault-free run's and the numpy oracle's;
   ``ingest_read_fault_typed`` on the same file at K = 1 and 4; the
   three-way join of that file on 8 shards of ``cuda:0`` under crashing
   ingest workers, with no assembly; ``storage_compact_crash`` on phase
   12's durable index with two more delta tiers, served by a
   ``LookupServer`` while the compactor dies; ``wal_crash_matrix``, eight
   crash windows, each a child process on the card over a 100,000-row
   base, reopened on the card; ``view_refresh_crash`` from phase 13;
   ``disarmed_overhead`` on (s1)'s server.  Every recovery case's
   allocated device bytes must end within 1 MiB of their reading after
   the fault-free run, and every mask and pack launch inside a case is
   replayed against the plain version, bitwise.  Prints a line per case
   (outcome, seconds, both memory readings) and a summary; a failed case
   fails the run.
18. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Phases 6, 7, 10 and 11 run under the default too (the device-parse tier
and the streamed tier's device chunk encoder); their pack kernel
launches are counted (set to 0 before each path, read after) and listed
per path.

Phases 4-9, 11, 13, 16 and 17 also hold the mask kernel's wrapper against its plain
version, bitwise, on the inputs of every call their filters made
(recorded during the path's run and replayed after its launch count was
read).  Phases 4, 6, 7, 10, 11 and 17 hold what the pack kernel returned in
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
Phases 4-17 run on the CPU too, at a small size, as a rehearsal:
``run_main_path`` (with phase 14 (a) in each leg), ``run_streamed_path``
(with phases 8 and 9 at its end), ``run_lane_path``, ``run_host_dict_path``,
``run_plancache_path``, ``run_serving_path``, ``run_dedup_path``,
``run_config1_path``, ``run_storage_path``, ``run_views_path``,
``run_plancert_path``, ``run_multidevice_path``, ``run_config5_path``,
``run_analysis_path`` and ``run_chaos_path`` with ``device="cpu"`` (set ``CSVPLUS_DEVICE_PARSE=1``
to take the tier the card takes by default).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# Phase 3's long dictionary-code IN-list: 12,300 targets over a span of
# 24,600, which the kernel tests as a bitmap.
LONG_IN_LIST = 12_300
# Phase 3's wide typed IN-list: ~60,000 int32 values spread over the whole
# range, more than a block's 227 KB of shared memory holds: the kernel
# searches it in global memory.
WIDE_IN_LIST = 60_000
# Phase 3's cold timings cycle through copies of their inputs of at least
# this many bytes: three times the card's 50 MB L2.
COLD_BYTES = 150_000_000
I32_MAX = 2**31 - 1
ORDERS_COLS = ("order_id", "cust_id", "prod_id", "qty")
_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)


def log(msg: str) -> None:
    print(msg, flush=True)


def storage_device(storage):
    """A column storage's device (a row-sharded one's first shard's)."""
    from csvplus_tpu_torch.columnar.table import storage_device as _sd

    return _sd(storage)


# -- phase 3: the mask kernel against its plain version ---------------------


def _timed(fn, reps: int = 20, batches: int = 5) -> float:
    """Device milliseconds per call of *fn*: the median over *batches* of
    the mean of *reps* back-to-back calls between two CUDA events.  Each
    batch is queued behind a GPU spin (``torch.cuda._sleep``) long enough
    for the host to enqueue every call (0.1 s, or twice the host time of
    the warm call times *reps* where that is longer), so the events
    bracket device work only, not the host's Python time per call (which
    exceeds a 10M-row mask's device time and would otherwise idle the
    card between calls).  A *fn* that launches more kernels than the
    card's queue holds (the plain versions) blocks on that queue while
    the card drains it, so it too is timed with the card busy."""
    import torch

    t0 = time.perf_counter()
    fn()  # warm: lazy loads, allocator
    spin_cycles = int(max(0.1, 2 * reps * (time.perf_counter() - t0)) * 2e9)  # ~2 GHz
    means = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        means.append(a.elapsed_time(b) / reps)
    return float(np.median(means))


def _bound_ms(n: int, targets) -> "tuple[float, str]":
    """Least time for the mask on this card: (4k + 1) n bytes over the
    memory rate, or the int32 operations the function needs over the int32
    issue rate, whichever is larger.  A row needs, per column j, a search
    of its sorted IN-list (ceil(log2|T_j|) compares) and one equality
    test, and k - 1 ANDs or ORs to combine the columns; a linear scan of
    the targets is the kernel's choice, not the function's cost."""
    t_bytes = (4 * len(targets) + 1) * n / HBM_BYTES_PER_S * 1e3
    per_row = sum(math.ceil(math.log2(max(len(t), 1))) + 1 for t in targets) + len(targets) - 1
    t_ops = n * per_row / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The recording and replay of the kernels' calls live in the package
# (``csvplus_tpu_torch/obs/replay.py``), which the chaos gate shares;
# these names keep the script's own log.


def _mask_vs_plain(cols, targets, nrows: int, mode: str, what: str) -> int:
    from csvplus_tpu_torch.obs import replay

    return replay.mask_vs_plain(cols, targets, nrows, mode, what)


def recorded_mask_calls(calls=None):
    from csvplus_tpu_torch.obs import replay

    return replay.recorded_mask_calls(calls)


def check_path_masks(calls, label: str) -> dict:
    from csvplus_tpu_torch.obs import replay

    return replay.check_path_masks(calls, label, log=log)


def recorded_pack_calls(calls=None):
    from csvplus_tpu_torch.obs import replay

    return replay.recorded_pack_calls(calls)


def check_path_packs(calls, label: str, launches: int, device: str) -> dict:
    from csvplus_tpu_torch.obs import replay

    return replay.check_path_packs(calls, label, launches, device, log=log)


def _timed_cold(fn, sets, reps: int = 20, batches: int = 5) -> float:
    """:func:`_timed` of ``fn(inputs)`` cycling through *sets* of inputs,
    whose bytes together exceed the card's L2 three times over, so that no
    call finds its columns in L2, as the main path's filters find columns
    that ingest wrote long before."""
    state = {"i": 0}

    def call():
        state["i"] += 1
        return fn(sets[state["i"] % len(sets)])

    return _timed(call, reps, batches)


def _cold_copies(cols, min_bytes: int = COLD_BYTES) -> list:
    """*cols* and enough copies of them to hold at least *min_bytes*
    (at least two sets)."""
    per_set = sum(c.numel() * c.element_size() for c in cols)
    n_sets = max(2, math.ceil(min_bytes / per_set))
    return [cols] + [[c.clone() for c in cols] for _ in range(n_sets - 1)]


def _test_kinds(targets) -> list:
    """Each column's membership test in the kernel's table for *targets*."""
    from csvplus_tpu_torch.ops import mask as M

    table, _ = M.build_table(M.canonical_targets(targets))
    names = {M.KIND_ONE: "one", M.KIND_BITMAP: "bitmap", M.KIND_SEARCH: "search"}
    return [names[int(table[4 * j]) & 3] + ("/global" if table[4 * j] & M.KIND_GLOBAL else "")
            for j in range(len(targets))]


def mask_host_us(reps: int = 2_000) -> dict:
    """Host microseconds of one wrapper call at a serving plan's size
    (n = 512, k = 2, pipeline (b)'s 50 + 1 targets, "any"): on a cache hit
    (the mean of *reps* calls back to back, the card never behind), and on
    a miss (20 calls with fresh targets after the cache was emptied: the
    table's build and its pinned upload)."""
    import torch

    from csvplus_tpu_torch.ops import mask as M

    dev = torch.device("cuda")
    cols = [torch.randint(0, 100, (512,), device=dev, dtype=torch.int32) for _ in range(2)]
    targets = [list(range(1, 51)), [7]]
    M.fused_equality_mask(cols, targets, 512, "any")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        M.fused_equality_mask(cols, targets, 512, "any")
    hit = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    M.clear_table_cache()
    t0 = time.perf_counter()
    for i in range(20):
        M.fused_equality_mask(cols, [list(range(100 + i, 150 + i)), [7]], 512, "any")
    miss = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    out = {"n": 512, "k": 2, "mode": "any", "targets_per_col": [50, 1],
           "cache_hit_us": hit, "cache_miss_us": miss}
    log("mask host time " + json.dumps(out))
    return out


class MaskInputs:
    """Phase 3's seeded inputs on the card."""

    def __init__(self, seed: int, device: str = "cuda"):
        import torch

        self.torch = torch
        self.dev = torch.device(device)
        self.g = torch.Generator(device=self.dev).manual_seed(seed)
        rng = np.random.default_rng(seed)
        # the global-memory search: more typed values than a block's 227 KB
        self.wide_list = sorted(set(rng.integers(-I32_MAX - 1, I32_MAX, WIDE_IN_LIST,
                                                 endpoint=True).tolist()))
        self.limit = (-40_000, -40_000 + 65_536 - 1)  # a span of exactly 2^16 bits
        self.at_limit = list(self.limit) + rng.integers(*self.limit, 100).tolist()
        self.past_limit = self.at_limit + [self.limit[1] + 1]

    def codes(self, n: int, k: int, hi: int = 1000):
        """k code columns in [0, hi) with ~5 % absent (-1) cells."""
        torch, g, dev = self.torch, self.g, self.dev
        out = []
        for _ in range(k):
            c = torch.randint(0, hi, (n,), generator=g, device=dev, dtype=torch.int32)
            c[torch.rand(n, generator=g, device=dev) < 0.05] = -1
            out.append(c)
        return out

    def typed(self, n: int, k: int):
        """k typed value-lane columns: int32 in [-1000, 1000) with ~1 %
        of cells at +(2^31 - 1) and ~1 % at -(2^31 - 1)."""
        torch, g, dev = self.torch, self.g, self.dev
        out = []
        for _ in range(k):
            c = torch.randint(-1000, 1000, (n,), generator=g, device=dev, dtype=torch.int32)
            r = torch.rand(n, generator=g, device=dev)
            c[r < 0.01] = I32_MAX
            c[r > 0.99] = -I32_MAX
            out.append(c)
        return out

    def unaligned(self, n: int):
        """One contiguous column 4 bytes past a 16-byte boundary."""
        return self.codes(n + 1, 1)[0][1:]

    def spread(self, n: int, targets: list, lo: int = -I32_MAX - 1, hi: int = I32_MAX):
        """Typed values spread over [lo, hi), a third of them drawn from
        *targets*."""
        torch, g, dev = self.torch, self.g, self.dev
        c = torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int64)
        t = torch.tensor(targets, device=dev, dtype=torch.int64)
        pick = torch.rand(n, generator=g, device=dev) < 1 / 3
        c[pick] = t[torch.randint(0, t.numel(), (int(pick.sum()),), generator=g, device=dev)]
        return c.to(torch.int32)

    def timed_shapes(self, n: int):
        """Phase 3's timed shapes: (name, k, mode, targets, columns)."""
        def ranges(k, t):
            return [list(range(7 * j, 7 * j + t)) for j in range(k)]

        long_list = list(range(0, 2 * LONG_IN_LIST, 2))
        yield "k=2 all T=1", 2, "all", ranges(2, 1), self.codes(n, 2)
        yield "k=2 any T=50", 2, "any", ranges(2, 50), self.codes(n, 2)
        yield "k=8 all T=1", 8, "all", ranges(8, 1), self.codes(n, 8)
        yield "k=1 any T=50", 1, "any", ranges(1, 50), self.codes(n, 1)
        yield ("pipeline (b) T=50+1", 2, "any", [list(range(1, 51)), [7]],
               self.codes(n, 2))
        yield ("long IN-list T=12,300", 1, "any", [long_list],
               self.codes(n, 1, hi=2 * LONG_IN_LIST + 1000))
        yield (f"wide typed IN-list T={len(self.wide_list):,}", 1, "any", [self.wide_list],
               [self.spread(n, self.wide_list)])


def check_mask_kernel(seed: int) -> dict:
    """Phase 3: the mask kernel against its plain version, bitwise, on the
    matrix of cases; its cold and warm times at the timed shapes beside
    its bound, the plain version and ``torch.isin`` (k = 1); the host time
    of one call at a serving plan's size."""
    import torch

    from csvplus_tpu_torch.ops import mask as M

    data = MaskInputs(seed)
    codes, typed, unaligned, spread = data.codes, data.typed, data.unaligned, data.spread
    wide_list, at_limit, past_limit, limit = (data.wide_list, data.at_limit, data.past_limit,
                                              data.limit)

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
        # 12,300 targets over a span of 24,600: a bitmap
        wide = codes(n, 1, hi=2 * LONG_IN_LIST + 1000)
        check("k=1 long IN-list", wide, [list(range(0, 2 * LONG_IN_LIST, 2))], "any")
        # a span of exactly the bitmap limit (a bitmap) and one past it (a
        # search), alone and beside a one-target column
        near = spread(n, past_limit, limit[0] - 3, limit[1] + 4)
        for name, t in (("span at the bitmap limit", at_limit),
                        ("span past the bitmap limit", past_limit)):
            check(name, [near], [t], "any")
            for mode in ("all", "any"):
                check(f"{name} k=2", [near, codes(n, 1, hi=4)[0]], [t, [2]], mode)
        # ~60,000 typed values spread over int32: searched in global memory
        far = spread(n, wide_list)
        check("k=1 wide typed IN-list", [far], [wide_list], "any")
        # duplicated, unsorted targets; one, bitmap and search in one call
        dup = codes(n, 2, hi=40)
        for mode in ("all", "any"):
            check("duplicated targets", dup, [[9, 5, 5, 3, 9, 3], [7, 7, 1]], mode)
            check("one + bitmap + search", [dup[0], dup[1], far],
                  [[5], [1, 7, 30, 7], wide_list[:300] + wide_list[-300:]], mode)
        # typed value lanes: any int32 is a value, none means "absent"
        lanes = typed(n, 2)
        for mode in ("all", "any"):
            check("typed negative", lanes, [[-7], [-1, -999]], mode)
            check("typed +-(2^31-1)", lanes, [[I32_MAX], [-I32_MAX, I32_MAX]], mode)
            check("typed absent target", lanes, [[123_456_789], [5000, -5000]], mode)
    log(f"mask kernel == plain version, bitwise, in {len(cases)} cases")
    del lanes, dup, far, near, wide, skew, cols

    timings = []
    n = MASK_ROWS
    for name, k, mode, targets, cols in data.timed_shapes(n):
        sets = _cold_copies(cols)
        # a long list costs the host milliseconds a call (its key's hash)
        # and the plain version a second: fewer calls there
        few = max(len(x) for x in targets) > 100
        reps = (5, 3) if few else ()
        ms = _timed_cold(lambda cs: M.fused_equality_mask(cs, targets, n, mode), sets, *reps)
        warm_ms = _timed(lambda: M.fused_equality_mask(cols, targets, n, mode), *reps)
        plain_ms = _timed(lambda: M.fused_equality_mask_plain(cols, targets, mode),
                          *((1, 1) if few else ()))
        bound, by = _bound_ms(n, targets)
        lib_ms = None
        if k == 1:
            tt = torch.tensor(targets[0], dtype=torch.int32, device=data.dev)
            lib_ms = _timed_cold(lambda cs: torch.isin(cs[0], tt), sets, *reps)
        row = {"shape": name, "n": n, "k": k, "mode": mode,
               "targets_per_col": [len(x) for x in targets], "tests": _test_kinds(targets),
               "ms": ms, "warm_ms": warm_ms, "cold_bytes": sum(
                   c.numel() * c.element_size() for cs in sets for c in cs),
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "share": bound / ms,
               "library_ms": lib_ms}
        timings.append(row)
        log("mask timing " + json.dumps(row))
        del sets, cols
    return {"max_abs_err": worst, "cases": len(cases), "timings": timings,
            "host": mask_host_us()}


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


def _write_rows(f, n: int, lines, chunk: int = 2_000_000) -> None:
    """Write ``lines(lo, hi)`` (the bytes of rows [lo, hi)) for every
    *chunk* rows of *n*, in order: the chunks are built on a few threads
    (numpy releases the interpreter lock in its loops), at most a window
    of them held at once."""
    from concurrent.futures import ThreadPoolExecutor

    starts = list(range(0, n, chunk))
    workers = max(1, min(8, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        for w in range(0, len(starts), 2 * workers):
            window = starts[w:w + 2 * workers]
            for data in pool.map(lambda lo: lines(lo, min(lo + chunk, n)), window):
                f.write(data)


def _fnv_affix(prefix: bytes, v: np.ndarray) -> np.ndarray:
    """FNV-1a of ``prefix + decimal(v)`` per row, for nonnegative ints."""
    n = v.size
    return _fnv32_mat(np.hstack([_lit(n, prefix), _digits(v)]) if prefix else _digits(v))


def _orders_lines(lo: int, hi: int, cust, prod, qty) -> bytes:
    """Orders rows [lo, hi) in phase 4's layout: ``o<row>,c<cust>,p<prod>,<qty>``."""
    m = hi - lo
    return _lines([_lit(m, b"o"), _digits(np.arange(lo, hi)), _lit(m, b",c"),
                   _digits(cust[lo:hi]), _lit(m, b",p"), _digits(prod[lo:hi]), _lit(m, b","),
                   _digits(qty[lo:hi]), _lit(m, b"\n")])


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
        _write_rows(f, n_orders, lambda lo, hi: _orders_lines(lo, hi, cust, prod, qty))
    return {"paths": paths, "cust": cust, "prod": prod, "qty": qty, "cols": cols,
            "n": n_orders, "seed": seed}


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
        t0 = time.perf_counter()
        n_want, want_sums, want_first = oracle(data, pipelines[name][1], cols)
        t_oracle = time.perf_counter() - t0
        if table.nrows != n_want:
            raise AssertionError(f"{label} pipeline {name}: {table.nrows} rows, oracle {n_want}")
        for c in table.columns.values():
            if storage_device(c.storage).type != device:
                raise AssertionError(
                    f"{label} pipeline {name}: result column on {storage_device(c.storage)}")
        got_sums = checksum_device_table(table, cols, positional=True)
        if got_sums != want_sums:
            raise AssertionError(
                f"{label} pipeline {name}: checksums {got_sums} != oracle {want_sums}")
        if [dict(r) for r in first_rows] != want_first:
            raise AssertionError(
                f"{label} pipeline {name}: first rows {first_rows} != {want_first}")
        out["pipelines"][name] = {"rows_out": table.nrows, "join_cold_s": times[0],
                                  "join_warm_s": times[1],
                                  "rows_per_s_warm": n_orders / times[1], "oracle_s": t_oracle}
        log(f"{label} pipeline {name}: {table.nrows:,} rows == oracle (count, positional "
            f"checksums of {len(cols)} columns, first rows; oracle {t_oracle:.1f}s); filter+join "
            f"cold {times[0]:.3f}s, warm {times[1]:.3f}s ({n_orders / times[1]:,.0f} rows/s)")
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
    n_orders: int, seed: int, device: str, workdir: Path, profile: bool = False,
    stats: "dict | None" = None, card: str = "", keep: "dict | None" = None,
) -> dict:
    """Phase 4: drive both pipelines through the public API on *device*
    and hold them against the oracle, in two legs: the default, where all
    three files must take the ``device-parsed`` tier (every column a
    dictionary column, the pack kernel launched once per column), and
    ``CSVPLUS_DEVICE_PARSE=0``, where they take ``native-encoded`` with the
    orders columns as typed lanes and no demotion.  Returns each leg's
    launches and times; *profile* adds a ``torch.profiler`` breakdown of
    one more warm run of the native leg.  Each leg ends with phase 14 (a),
    the flagship on the leg's tables (:func:`run_flagship`), its calls
    counted into *stats*.  *keep* (a dict) gets the generated data for
    phase 17 under ``"orders"``."""
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    data = generate(workdir, n_orders, seed)
    if keep is not None:
        keep["orders"] = data
    log(f"generated {n_orders:,} orders in {time.perf_counter() - t0:.1f}s")
    out = {"rows": n_orders, "cpu_count": os.cpu_count(), "legs": {}}
    for leg, env in MAIN_LEGS.items():
        with _env_set(_default_parse_env(device) if env is None else env):
            out["legs"][leg] = _main_leg(data, device, leg, profile, stats, card)
        gc.collect()  # the leg's tables; a source and its run function form a cycle
    return out


def _main_leg(data: dict, device: str, leg: str, profile: bool, stats: dict, card: str) -> dict:
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
    analysis = None
    if leg == "native-encoded":  # phase 16 (b) on the plan the leg just ran
        analysis = analysis_check(run["srcs"]["a"], "device",
                                  run["pipelines"]["a"]["join_warm_s"],
                                  f"phase 16 (b) [{leg}] pipeline (a), {n_orders:,} orders",
                                  card)
    out = {"analysis": analysis, "ingest_s": t_ingest, "index_s": t_index, "ingest_tiers": tiers,
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
    out["flagship"] = run_flagship(orders, cust, prod, data, device, leg,
                                   data["paths"]["orders"].parent, stats, card)
    plain_src = orders.join(cust, "cust_id").join(prod)
    plain = plain_src.to_device_table()
    out["sharded"] = run_sharded_leg(data, cust, prod, plain_src, plain, device, leg, card)
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
        if storage_device(c.storage).type != device:
            raise AssertionError(f"{what}: result column on {storage_device(c.storage)}")
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
    request's rows in probe order).  The chaos gate's serving cases share
    it (``resilience/chaos.closed_loop``)."""
    from csvplus_tpu_torch.resilience import chaos

    return chaos.closed_loop(srv, probes, clients, timeout)


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
                     clients: int = N_SERVE_CLIENTS, cap: "int | None" = None,
                     keep: "dict | None" = None) -> dict:
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
    rehearsal's small tables).  *keep* (a dict) gets what phase 17 serves
    from: (s1)'s index and ids under ``"s1"``, and under ``"s2"`` the
    ``order_id`` index with 64 of its probes, the ``cust_id`` index's
    first plan and *cap*."""
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
    if keep is not None:
        keep["s1"] = (idx, ids)
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
        if keep is not None:
            keep["s2"] = {"order_idx": order_idx, "order_probes": probes[:64],
                          "plan": plans[0], "cap": cap}
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
        _write_rows(f, n, lambda lo, hi: _lines([
            _lit(hi - lo, b"o"), _digits(ids[lo:hi], 8), _lit(hi - lo, b",c"),
            _digits(cust[lo:hi]), _lit(hi - lo, b","), _digits(qty[lo:hi]), _lit(hi - lo, b","),
            _digits(np.arange(lo, hi)), _lit(hi - lo, b"\n")]))
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


@contextlib.contextmanager
def _spinning(n: int, body, cuda_device, device: str, pause_s: float = 0.0):
    """*n* threads that call ``body(slot, i)`` back to back (sleeping
    *pause_s* after each call when it is > 0) from 0.05 s before the block
    to 0.05 s after it; yields one list a thread of (start, seconds) per
    call, and raises a thread's error or a thread that does not stop."""
    import threading

    import torch

    stop = threading.Event()
    started = threading.Barrier(n + 1)
    per_thread: list = [[] for _ in range(n)]
    errs: list = []

    def run(slot: int) -> None:
        local = per_thread[slot]
        try:
            with torch.cuda.device(cuda_device) if device == "cuda" else contextlib.nullcontext():
                started.wait(timeout=60)
                i = slot
                while not stop.is_set():
                    t1 = time.perf_counter()
                    body(slot, i)
                    local.append((t1, time.perf_counter() - t1))
                    i += n
                    if pause_s:
                        time.sleep(pause_s)
        except BaseException as e:
            errs.append(e)
            stop.set()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    try:
        started.wait(timeout=60)
        time.sleep(0.05)  # a steady state first
        yield per_thread
        time.sleep(0.05)  # and a tail after the block
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a spinning thread did not stop")
    if errs:
        raise errs[0]


def _reader_body(mi, probes):
    """bench_delta.py's compaction-pause reader: one ``find_rows`` a call."""
    return lambda slot, i: mi.find_rows(probes[i % len(probes)])


def _python_body(slot: int, i: int) -> None:
    """A pure-Python spin of about a reader's probe's length: no device
    work, no numpy, no index; it holds the interpreter lock throughout."""
    x = 0
    for v in range(2_000):
        x += v * slot


def _calls_in(per_thread, t0: float, t1: float) -> int:
    return sum(1 for local in per_thread for ts, _ in local if t0 <= ts <= t1)


@contextlib.contextmanager
def _host_syncs(device: str):
    """Count the host synchronizations inside the block: every operation
    ``torch.cuda.set_sync_debug_mode`` warns about (an ``.item()``, a
    device-to-host copy, a ``nonzero``) and every ``torch.cuda.synchronize``.
    One thread only: the warning filter and the mode are process-wide."""
    import warnings

    import torch

    n = {"syncs": 0}
    if device != "cuda":
        yield n
        return
    real_sync = torch.cuda.synchronize

    def counting_sync(*a, **k):
        n["syncs"] += 1
        return real_sync(*a, **k)

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.synchronize = counting_sync
        try:
            yield n
        finally:
            torch.cuda.synchronize = real_sync
            torch.cuda.set_sync_debug_mode(0)
    n["syncs"] += sum(1 for w in seen if "synchroniz" in str(w.message))


def settle_f4(mi, wal_dir: Path, workdir: Path, probes, device: str,
              pause_s: float = 0.0) -> dict:
    """F4: why two spinning readers slow the storage merge.  The same full
    merge (``compact_once``: merge, pruner, checkpoint) runs on four
    clones of *mi*'s durable state, each recovered from a copy of its
    directory: (quiet) alone, counting its host syncs; (readers) under
    two readers probing without a pause, after 0.5 s of the readers alone
    for their rate with no merge; (python) under two pure-Python spinners
    that touch neither the card nor the index; (switch) under two readers
    with the interpreter's switch interval cut from 5 ms to 0.5 ms.  Also
    the host syncs and ``host_sync_elements`` of one ``find_rows`` on
    *mi*.  A merge that slows as much under pure Python as under readers,
    and less at a shorter switch interval, waits on the interpreter lock,
    not on the card."""
    from csvplus_tpu_torch.storage import MutableIndex
    from csvplus_tpu_torch.utils.observe import telemetry

    out: dict = {}
    mi.find_rows(probes[0])  # warm
    with telemetry.collect(), _host_syncs(device) as syncs:
        mi.find_rows(probes[1])
        elements = telemetry.host_sync_elements
    out["find_rows"] = {"syncs": syncs["syncs"], "host_sync_elements": elements,
                        "tiers": 1 + mi.delta_count}
    clones = {}
    for name in ("quiet", "readers", "python", "switch"):
        clones[name] = workdir / f"f4-{name}"
        shutil.copytree(wal_dir, clones[name])
    n = 2
    try:
        for name, path in clones.items():
            clone = MutableIndex.open(str(path), ingest_device=device)
            clone.find_rows(probes[0])
            load = None
            prev_switch = sys.getswitchinterval()
            if name == "python":
                load = _python_body
            elif name in ("readers", "switch"):
                load = _reader_body(clone, probes)
            with contextlib.ExitStack() as stack:
                counted = stack.enter_context(_host_syncs(device if load is None else "cpu"))
                if name == "switch":
                    sys.setswitchinterval(0.0005)
                    stack.callback(sys.setswitchinterval, prev_switch)
                per_thread = None
                if load is not None:
                    per_thread = stack.enter_context(
                        _spinning(n, load, clone.device, device, pause_s))
                    t_a = time.perf_counter()
                    time.sleep(0.5)  # the load alone: its rate with no merge
                    t_b = time.perf_counter()
                t0 = time.perf_counter()
                got = clone.compact_once()
                t1 = time.perf_counter()
            row = {"full_merge_s": t1 - t0,
                   "full_merge_parts_s": {"merge_and_pruner_s": got["seconds"],
                                          "checkpoint_s": t1 - t0 - got["seconds"]},
                   "rows_in": got["rows_in"], "rows_out": got["rows_out"]}
            if load is None:
                row["host_syncs"] = counted["syncs"]
            else:
                alone = _calls_in(per_thread, t_a, t_b) / (t_b - t_a)
                during = _calls_in(per_thread, t0, t1) / (t1 - t0)
                row.update(calls_per_s_alone=alone, calls_per_s_during=during,
                           share_during=during / alone if alone else None)
            out[name] = row
            clone.close()
    finally:
        for path in clones.values():
            shutil.rmtree(path, ignore_errors=True)
    q = out["quiet"]
    log(f"phase 12 F4: one find_rows on {out['find_rows']['tiers']} tiers made "
        f"{out['find_rows']['syncs']} host syncs ({out['find_rows']['host_sync_elements']} "
        f"counted elements); the same full merge ({q['rows_in']:,} -> {q['rows_out']:,} rows) "
        f"quiet {q['full_merge_s']:.3f}s {q['full_merge_parts_s']} with {q['host_syncs']} host "
        f"syncs; " + "; ".join(
            f"under {what} {out[name]['full_merge_s']:.3f}s {out[name]['full_merge_parts_s']}, "
            f"their calls/s {out[name]['calls_per_s_alone']:,.0f} alone, "
            f"{out[name]['calls_per_s_during']:,.0f} during it"
            for name, what in (("readers", "2 readers"), ("python", "2 pure-Python spinners"),
                               ("switch", "2 readers at a 0.5 ms switch interval"))))
    return out


def run_storage_path(n_rows: int, seed: int, device: str, workdir: Path,
                     batch_rows: int = STORAGE_BATCH_ROWS,
                     n_lookups: int = STORAGE_LOOKUPS, reader_pause_s: float = 0.0,
                     f4: bool = False, keep: "dict | None" = None) -> dict:
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
    probe instead).  Before that merge, with *f4*, :func:`settle_f4`
    splits what the readers cost it.  After each
    step the live tier set's positional checksums, the port's
    ``rebuild_reference`` and a numpy oracle of the logical stream agree;
    a tail of writes after the checkpoint is recovered by ``MutableIndex.open`` checksum-equal; then
    ``LookupServer.append`` / ``delete`` acks are read back.  No kernel is
    built or loaded in the whole phase (``RecompileWatch``).  *keep* (a
    dict) gets the open durable index and probes of its keys under
    ``"storage"`` for phase 17, which closes it."""
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

    if f4:
        out["f4"] = settle_f4(mi, wal_dir, workdir, probes, device, reader_pause_s)

    # the full merge under two readers that probe without a pause, as
    # bench_delta.py's compaction-pause scenario runs them
    n_readers = 2
    with _spinning(n_readers, _reader_body(mi, probes), mi.device, device,
                   reader_pause_s) as per_thread:
        t_c0 = time.perf_counter()
        full = mi.compact_once()
        t_c1 = time.perf_counter()
    # the pass's own seconds are the merge and the new base's pruner, up to
    # the swap; the rest is the checkpoint (base file, sidecar, manifest)
    merge_parts = {"merge_and_pruner_s": full["seconds"],
                   "checkpoint_s": t_c1 - t_c0 - full["seconds"]}
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
    if keep is not None:
        keep["storage"] = {"mi": mi, "probes": [(k.decode(),) for k in (
            base_keys[0], base_keys[3], base_keys[-1], keys[0], keys[7])] + [("n5",), ("zz",)]}
    else:
        mi.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    out["server"] = {"acks": acks, "cell": {k: cell[k] for k in (
        "append_reqs", "delete_reqs", "rows_appended", "deltas_live", "wal_records",
        "wal_fsyncs")}}
    out["recompiles"] = sum(recompiles.values())
    log(f"phase 12 server: append ack {acks[0]:,} rows, delete ack {acks[1]}, reads back == "
        f"oracle; recompiles (kernels built or loaded) in the phase: {out['recompiles']}")
    return out


# -- phase 13: live materialized views, plan-space certification, obs tools --

VIEW_ROWS = 1_000_000  # bench_view.py's source
VIEW_CUST = 5_000
VIEW_PROD = 500
VIEW_BATCH_ROWS = 1_000
VIEW_BATCHES = 8
VIEW_READS = 2_000
VIEW_SERVER_BATCHES = 4
VIEW_FILTER_PROD = 7  # orders_filtered keeps prod_id p0007


def _zf(prefix: bytes, ints: np.ndarray, width: int) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(ints.astype("S"), width))


class _ViewOracle:
    """The acked stream of the views' source in numpy: segments of
    (oid, customer number, product number) in append order, a delete
    erasing its key from every earlier segment.  :meth:`sums` gives the
    positional checksums of a view's columns over the stable key order:
    ``orders_enriched`` joins every row (all keys are in the dimensions),
    ``orders_filtered`` keeps one product and adds ``src``."""

    def __init__(self, oid: np.ndarray, cust: np.ndarray, prod: np.ndarray):
        self.segs = [(oid, cust, prod)]

    def append(self, oid, cust, prod) -> None:
        self.segs.append((oid, cust, prod))

    def delete(self, key: bytes) -> None:
        self.segs = [(o[o != key], c[o != key], p[o != key]) for o, c, p in self.segs]

    def live(self, key: bytes, prod_only: "int | None" = None) -> int:
        """Rows of *key* in the stream (of product *prod_only* only)."""
        return sum(int(((o == key) & ((p == prod_only) if prod_only is not None else True)).sum())
                   for o, _, p in self.segs)

    def sums(self, prod_only: "int | None" = None) -> dict:
        oid = np.concatenate([s[0] for s in self.segs])
        cust = np.concatenate([s[1] for s in self.segs])
        prod = np.concatenate([s[2] for s in self.segs])
        if prod_only is not None:
            keep = prod == prod_only
            oid, cust, prod = oid[keep], cust[keep], prod[keep]
        order = np.argsort(oid, kind="stable")
        oid, cust, prod = oid[order], cust[order], prod[order]
        cols = {"oid": oid, "cust_id": _zf(b"c", cust, 5), "prod_id": _zf(b"p", prod, 4),
                "name": _zf(b"nm", cust, 5), "label": _zf(b"lb", prod, 4)}
        if prod_only is not None:
            cols["src"] = np.full(oid.size, b"live", dtype="S4")
        return {c: _positional_sum(_fnv32(v)) for c, v in cols.items()}


def _view_batch(b: int, n: int) -> "tuple[list, np.ndarray, np.ndarray, np.ndarray]":
    """``bench_view.py``'s write batch *b*: fresh keys ``w%08d``, dimension
    keys round-robin from the batch's base (exactly min(n, dimension)
    distinct values per column at fixed widths)."""
    ids = np.arange(b * n, (b + 1) * n)
    oid, cust, prod = _zf(b"w", ids, 8), ids % VIEW_CUST, ids % VIEW_PROD
    rows = [{"oid": o, "cust_id": c, "prod_id": p} for o, c, p in zip(
        oid.astype(str).tolist(), _zf(b"c", cust, 5).astype(str).tolist(),
        _zf(b"p", prod, 4).astype(str).tolist())]
    return rows, oid, cust, prod


def _view_reads(view, n_reads: int) -> dict:
    """``bench_view.py``'s read scenario: *n_reads* ``view.read()`` probes
    of keys sampled from the first four live segments (seed 0)."""
    rng = np.random.default_rng(0)
    snap = view.snapshot()
    pool = [seg.keys[i][0] for seg in snap.segments[:4]
            for i in range(0, len(seg.keys), max(1, len(seg.keys) // 64))]
    probes = [pool[int(v)] for v in rng.integers(0, len(pool), n_reads)]
    view.read(probes[0])
    lats = []
    hits = 0
    t_all = time.perf_counter()
    for p in probes:
        t0 = time.perf_counter()
        hits += bool(view.read(p))  # a deleted key reads empty
        lats.append(time.perf_counter() - t0)
    dt = time.perf_counter() - t_all
    a = np.asarray(lats)
    return {"n": n_reads, "hits": hits, "seconds": dt, "reads_per_s": n_reads / dt,
            "p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p99_ms": float(np.percentile(a, 99)) * 1e3, "max_ms": float(a.max()) * 1e3}


def run_views_path(n_rows: int, seed: int, device: str, workdir: Path,
                   batch_rows: int = VIEW_BATCH_ROWS, n_batches: int = VIEW_BATCHES,
                   n_reads: int = VIEW_READS, server_batches: int = VIEW_SERVER_BATCHES) -> dict:
    """Phase 13: ``bench_view.py``'s deployment on *device*.  A durable
    append-mode ``MutableIndex`` of *n_rows* orders (``oid = o%08d``,
    ``cust_id`` striped over 5,000 customers, ``prod_id`` over 500
    products) and frozen dimension indexes ``cust_id -> name`` and
    ``prod_id -> label``; two live views registered on a ``LookupServer``
    over the source: ``orders_enriched`` (the three-way join) and
    ``orders_filtered`` (the join, a ``Like`` on one product, a ``SetValue``).
    Traffic: one warm-up batch, *n_batches* batches of *batch_rows* with a
    delete of one key of the previous batch every third batch, each warm
    refresh under ``RecompileWatch(plancache=...)`` (no binary built or
    loaded, nothing lowered); *n_reads* reads; then *server_batches*
    batches and a delete through the started server, each write in the
    views by the next dispatch cycle, and one ``views:refresh`` fault that
    leaves the prior snapshot live until the next cycle applies the event.
    After every applied step both views' checksums equal their
    ``recompute_checksums`` and the numpy oracle of the acked stream.
    Every mask call the phase made is replayed against the plain version
    after its launch count was read.  The phase runs inside a trace, whose
    spans are exported as a Chrome trace and validated."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch import plan as PL
    from csvplus_tpu_torch.columnar.table import DeviceTable
    from csvplus_tpu_torch.obs.export import export_chrome_trace, validate_chrome_trace
    from csvplus_tpu_torch.obs.recompile import RecompileWatch
    from csvplus_tpu_torch.obs.span import tracer
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.resilience import chaos
    from csvplus_tpu_torch.serve import LookupServer, PlanCache
    from csvplus_tpu_torch.storage import MutableIndex

    t0 = time.perf_counter()
    ids = np.arange(n_rows)
    oid0, cust0, prod0 = _zf(b"o", ids, 8), ids % VIEW_CUST, ids % VIEW_PROD
    table = DeviceTable.from_pylists({
        "oid": oid0.astype(str).tolist(),
        "cust_id": _zf(b"c", cust0, 5).astype(str).tolist(),
        "prod_id": _zf(b"p", prod0, 4).astype(str).tolist()}, device=device)
    wal_dir = workdir / "views"
    mi = MutableIndex(T.take(table).index_on("oid").sync(), mode="append",
                      directory=str(wal_dir))
    del table
    nc, npd = np.arange(VIEW_CUST), np.arange(VIEW_PROD)
    cust = T.take(DeviceTable.from_pylists({
        "cust_id": _zf(b"c", nc, 5).astype(str).tolist(),
        "name": _zf(b"nm", nc, 5).astype(str).tolist()}, device=device)).index_on("cust_id").sync()
    prod = T.take(DeviceTable.from_pylists({
        "prod_id": _zf(b"p", npd, 4).astype(str).tolist(),
        "label": _zf(b"lb", npd, 4).astype(str).tolist()}, device=device)).index_on("prod_id").sync()
    _sync(device)
    t_source = time.perf_counter() - t0
    oracle = _ViewOracle(oid0, cust0, prod0)
    fprod = f"p{VIEW_FILTER_PROD:04d}"
    join = PL.Join(PL.Join(PL.Scan(None), cust, ("cust_id",)), prod, ("prod_id",))
    plans = {"orders_enriched": join,
             "orders_filtered": PL.MapExpr(PL.Filter(join, T.Like({"prod_id": fprod})),
                                           T.SetValue("src", "live"))}
    filt = {"orders_enriched": None, "orders_filtered": VIEW_FILTER_PROD}
    pc = PlanCache()
    srv = LookupServer(indexes={"orders": mi}, plancache=pc)
    out = {"rows": n_rows, "batch_rows": batch_rows, "batches": n_batches,
           "source_s": t_source, "recompute_s": {n: [] for n in plans},
           "checksums_s": {n: [] for n in plans}, "refresh_ms": {n: [] for n in plans},
           "steps": 0}
    log(f"phase 13: durable MutableIndex over {n_rows:,} orders on {mi.device} and "
        f"dimensions of {VIEW_CUST:,} and {VIEW_PROD} keys in {t_source:.2f}s")

    def on_device(what: str, t) -> None:
        d = t.device
        if d.type != device or (device == "cuda" and d.index != 0):
            raise AssertionError(f"phase 13: {what} lies on {d}, not {device}:0")

    def parity(step: str) -> None:
        for name, view in views.items():
            want = oracle.sums(filt[name])
            t1 = time.perf_counter()
            got = view.checksums()
            t2 = time.perf_counter()
            ref = view.recompute_checksums()
            t3 = time.perf_counter()
            out["checksums_s"][name].append(t2 - t1)
            out["recompute_s"][name].append(t3 - t2)
            if got != ref or got != want:
                raise AssertionError(f"phase 13 {step}: {name} checksums {got}, recompute "
                                     f"{ref}, numpy oracle {want}")
        out["steps"] += 1

    with recorded_mask_calls() as calls, _env_set({"CSVPLUS_FLIGHT_DIR": str(workdir)}), \
            tracer.trace("phase 13 views") as trace:
        M.launches = 0  # the path's run starts here
        t0 = time.perf_counter()
        views = {name: srv.register_view(name, root, source="orders")
                 for name, root in plans.items()}
        out["register_s"] = time.perf_counter() - t0
        parity("registered")
        log(f"phase 13 registered {list(views)} in {out['register_s']:.2f}s "
            f"({views['orders_enriched'].snapshot().nrows:,} and "
            f"{views['orders_filtered'].snapshot().nrows:,} rows); checksums == recompute "
            f"== numpy oracle")

        def write(b: int) -> None:
            rows, o, c, p = _view_batch(b, batch_rows)
            mi.append_rows(rows)
            oracle.append(o, c, p)

        write(0)  # the warm-up batch: lowers the per-tier plans once
        for view in views.values():
            view.refresh()
        parity("warm-up")
        deletes = 0
        for b in range(1, n_batches + 1):
            write(b)
            if b % 3 == 0:
                key = _zf(b"w", np.array([(b - 1) * batch_rows]), 8)[0]
                mi.delete((key.decode(),))
                oracle.delete(key)
                deletes += 1
            with RecompileWatch(plancache=pc) as watch:
                for name, view in views.items():
                    t1 = time.perf_counter()
                    applied = view.refresh()
                    out["refresh_ms"][name].append((time.perf_counter() - t1) * 1e3)
                    if applied < 1:
                        raise AssertionError(f"phase 13 batch {b}: {name} applied nothing")
            if watch.delta():
                raise AssertionError(f"phase 13 batch {b}: warm refresh built, loaded or "
                                     f"lowered {watch.delta()}")
            parity(f"batch {b}")
        out["deletes"] = deletes
        out["reads"] = _view_reads(views["orders_enriched"], n_reads)

        # through the server: each acked write is in both views by the next cycle
        latencies = []
        with _running(srv):
            for s in range(server_batches + 1):
                if s < server_batches:
                    rows, o, c, p = _view_batch(n_batches + 1 + s, batch_rows)
                    key, present = o[-1], True
                    t1 = time.perf_counter()
                    fut = srv.submit_append(rows, index="orders")
                    ack = fut.result(timeout=120)
                    oracle.append(o, c, p)
                else:
                    key, present = o[0], False
                    t1 = time.perf_counter()
                    ack = srv.submit_delete(key.decode(), index="orders").result(timeout=120)
                    oracle.delete(key)
                if ack != (batch_rows if present else 1):
                    raise AssertionError(f"phase 13 server write {s}: ack {ack}")
                view = views["orders_enriched"]
                while bool(view.read(key.decode())) != present:
                    if time.perf_counter() - t1 > 60:
                        raise AssertionError(f"phase 13 server write {s} never reached the view")
                    time.sleep(0.0002)
                latencies.append(time.perf_counter() - t1)
                srv.submit(key.decode(), index="orders").result(timeout=120)  # the next cycle
                for name, v in views.items():
                    if v.pending or len(v.read(key.decode())) != oracle.live(key, filt[name]):
                        raise AssertionError(f"phase 13 server write {s}: {name} not fresh "
                                             f"by the next cycle")
                parity(f"server write {s}")
            # one views:refresh fault, through the chaos gate's case (phase
            # 17 reports it): a write cycle appends a batch and deletes a
            # live key, its refresh crashes, the prior snapshot stays live
            # until the next cycle applies both events; its flight dump
            # names the site.  The phase records the case's mask calls.
            gone = o[1]  # a key of the last server batch, still live
            rows, o, c, p = _view_batch(n_batches + 1 + server_batches, batch_rows)
            out["chaos_view"] = chaos.with_timeout(
                "view_refresh_crash", lambda: chaos.case_view_refresh_crash(
                    device=device, audit=False, target={
                        "server": srv, "view": "orders_enriched", "index": "orders",
                        "append": rows, "delete": gone.decode(), "lookup": o[0].decode()}),
                log=log)
            if not out["chaos_view"]["ok"]:
                raise AssertionError(f"phase 13: the refresh crash case failed: "
                                     f"{out['chaos_view']}")
            oracle.append(o, c, p)
            oracle.delete(gone)
            if views["orders_enriched"].pending or not views["orders_enriched"].read(
                    o[0].decode()):
                raise AssertionError("phase 13: the next cycle did not apply the queued event")
            parity("after the refresh fault")
            snap = srv.snapshot()
        launches = M.launches  # ... and ends here
    out["launches"] = launches
    out["server"] = {"refresh_after_write_ms": [x * 1e3 for x in latencies],
                     "cells": snap["by_view"]}
    sizes = {}
    for _, _, nrows, _ in calls:
        sizes[nrows] = sizes.get(nrows, 0) + 1
    out["mask_calls_by_n"] = {str(k): v for k, v in sorted(sizes.items())}
    if device == "cuda" and launches <= 0:
        raise AssertionError("phase 13: the views never launched the mask kernel")
    if sum(v for k, v in sizes.items() if k <= 2 * batch_rows) < 1:
        raise AssertionError("phase 13: no mask call at a write batch's size")
    out["mask_check"] = check_path_masks(calls, "1M views")

    ts = mi.tiers()
    for what, ix in [("the source's base", ts.base), ("the cust dimension", cust),
                     ("the prod dimension", prod)] + [
            (f"tier {d.seq}", d.index) for d in ts.deltas if d.index is not None]:
        for cname, col in ix._impl.dev.table.columns.items():
            on_device(f"{what}'s column {cname}", col.storage)
    cells = snap["by_view"]
    if cells["orders_enriched"]["failures"] != 1 or cells["orders_filtered"]["failures"]:
        raise AssertionError(f"phase 13: view failure cells {cells}")

    trace_dir = workdir / "trace"
    path = export_chrome_trace(str(trace_dir), [trace])
    with open(path) as f:
        events = json.load(f)
    problems = validate_chrome_trace(events)
    names = {}
    for e in events["traceEvents"]:
        if e["ph"] == "X":
            names[e["name"]] = names.get(e["name"], 0) + 1
    out["trace"] = {"events": len(events["traceEvents"]), "problems": problems,
                    "view_spans": {k: v for k, v in names.items() if k.startswith("view:")}}
    if problems or not names.get("view:refresh"):
        raise AssertionError(f"phase 13 trace: {problems or 'no view:refresh span'}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    mi.close()
    shutil.rmtree(wal_dir, ignore_errors=True)

    for name in plans:
        r = out["refresh_ms"][name]
        rec = out["recompute_s"][name]
        out.setdefault("summary", {})[name] = {
            "refresh_mean_ms": float(np.mean(r)), "refresh_max_ms": float(np.max(r)),
            "recompute_mean_s": float(np.mean(rec)),
            "incremental_speedup": float(np.mean(rec)) / (float(np.mean(r)) / 1e3),
            "checksums_mean_s": float(np.mean(out["checksums_s"][name]))}
        sm = out["summary"][name]
        log(f"phase 13 {name}: refresh {sm['refresh_mean_ms']:.3f} ms mean, "
            f"{sm['refresh_max_ms']:.3f} ms max per {batch_rows:,}-row batch; from-scratch "
            f"recompute {sm['recompute_mean_s']:.3f}s; incremental speedup "
            f"{sm['incremental_speedup']:,.1f}x; view checksums {sm['checksums_mean_s']:.3f}s")
    rd = out["reads"]
    log(f"phase 13 reads: p50 {rd['p50_ms']:.4f} ms, p99 {rd['p99_ms']:.4f} ms, max "
        f"{rd['max_ms']:.4f} ms, {rd['reads_per_s']:,.0f} reads/s ({rd['n']:,} reads, "
        f"{rd['hits']:,} found rows)")
    lat = out["server"]["refresh_after_write_ms"]
    log(f"phase 13 server: refresh-after-write {', '.join(f'{x:.2f}' for x in lat)} ms "
        f"({server_batches} batches, 1 delete); one views:refresh fault kept the prior "
        f"snapshot until the next cycle; parity after each of {out['steps']} steps; "
        f"0 warm recompiles")
    log(f"phase 13 mask kernel launches {launches}; calls by n {out['mask_calls_by_n']}; "
        f"trace {out['trace']['events']} events, {out['trace']['view_spans']}, problems "
        f"{problems}")
    return out


def run_plancert_path(n: int, device: str) -> dict:
    """``certify(n, device=...)``: the rewriter's plan space over the
    certifier's corpus on *device*, every obligation held.  The earlier
    phases' joins filled the process-wide build-side sketches, under which
    the rewriter and the certifier disagree (in the reference too), so the
    registry is reset just before the call.  Every mask call is replayed
    against the plain version after the launch count was read."""
    from csvplus_tpu_torch.analysis.plancert import certify, summary_json
    from csvplus_tpu_torch.obs.joinskew import joinskew
    from csvplus_tpu_torch.ops import mask as M

    joinskew.reset()
    with recorded_mask_calls() as calls:
        M.launches = 0  # the path's run starts here
        t0 = time.perf_counter()
        s = certify(n=n, budget_s=600.0, device=device)
        secs = time.perf_counter() - t0
        launches = M.launches  # ... and ends here
    summary = summary_json(s)
    log(f"phase 13 certify(n={n}, device={device!r}) after resetting the build-side sketch "
        f"registry: {secs:.2f}s, {json.dumps(summary)}; mask kernel launches {launches}")
    if not s.ok:
        raise AssertionError(f"certify failed:\n{s.describe()}")
    if device == "cuda" and launches <= 0:
        raise AssertionError("certify never launched the mask kernel")
    return {"summary": summary, "seconds": secs, "launches": launches,
            "mask_check": check_path_masks(calls, "plancert")}


def check_stage_diff(main_path: dict) -> dict:
    """``diff_stage_tables`` of phase 4's warm (a) stage tables, A the
    device-parsed leg, B the native-encoded leg; prints the flagged
    stages."""
    from csvplus_tpu_torch.obs.diff import diff_stage_tables

    legs = main_path["legs"]
    result = diff_stage_tables(legs["device-parsed"]["stage_table"]["stages"],
                               legs["native-encoded"]["stage_table"]["stages"])
    flagged = [(r["stage"], r["movement"], r["regressed_in"]) for r in result["flagged"]]
    log(f"phase 13 obs diff of phase 4's warm (a) stage tables (A device-parsed, B "
        f"native-encoded): flagged {flagged}; only in A {result['only_in_a']}, only in B "
        f"{result['only_in_b']}")
    return {"flagged": flagged, "only_in_a": result["only_in_a"],
            "only_in_b": result["only_in_b"]}


# -- phase 14: the flagship and the multi-device primitives -----------------

N_MD_SHARDS = 8  # BASELINE.json config 5's 8-way sharding
N_MD_KEYS = 8_000_000  # over DeviceIndex.PARTITION_MIN_KEYS (4M)
N_MD_PROBES = 100_000_000
N_MD_ZIPF = 50_000_000
N_MD_WIDE = 25_000_000
N_MD_WIDE_KEYS = 4_000_000
N_MD_SORT = 100_000_000
N_MD_SORT_WIDE = 25_000_000
N_MD_SORT_SKEW = 10_000_000
ZIPF_S = 1.1
ZIPF_THRESHOLD = "0.002"  # the reference's skew bench setting
FLAGSHIP_CUST_KEEP = 0.99

#: The reference's jitted functions this slice ports, by port module, with
#: the reference's file:line: phase 14 counts each one's calls and times
#: each call (device work drained before and after).
XLA_FUNCS = {
    "csvplus_tpu_torch.models.flagship": {
        "threeway_step": "csvplus_tpu/models/flagship.py:39",
        "gather_columns": "csvplus_tpu/models/flagship.py:59",
        "_fused_unique_join": "csvplus_tpu/models/flagship.py:69",
        "_fused_direct_probe": "csvplus_tpu/models/flagship.py:99",
    },
    "csvplus_tpu_torch.parallel.pjoin": {
        "_probe_spmd": "csvplus_tpu/parallel/pjoin.py:336",
        "_probe_spmd2": "csvplus_tpu/parallel/pjoin.py:319",
        "_probe_spmd_dev": "csvplus_tpu/parallel/pjoin.py:444",
        "_probe_spmd_dev2": "csvplus_tpu/parallel/pjoin.py:493",
        "broadcast_probe": "csvplus_tpu/parallel/pjoin.py:949",
    },
    "csvplus_tpu_torch.parallel.dsort": {
        "_dsort_spmd": "csvplus_tpu/parallel/dsort.py:190",
    },
}


def _nbytes(obj, seen: set) -> int:
    """Bytes of the distinct tensors in *obj* (tensors, ShardedRows,
    tuples, lists, dicts; anything else counts 0)."""
    import torch

    from csvplus_tpu_torch.parallel.mesh import ShardedRows

    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.data_ptr(), obj.nbytes)
        if key in seen:
            return 0
        seen.add(key)
        return obj.nbytes
    if isinstance(obj, ShardedRows):
        obj = obj.shards
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x, seen) for x in obj)
    return 0


@contextlib.contextmanager
def counted_calls(stats: dict, device: str):
    """Wrap each function of ``XLA_FUNCS`` inside the block: count its
    calls, time each call between two drains of the device, and record
    the bytes of its tensor inputs and outputs (the byte bound's
    numerator: each input read once, each output written once)."""
    import importlib

    patched = []
    for mod_name, funcs in XLA_FUNCS.items():
        mod = importlib.import_module(mod_name)
        for name in funcs:
            real = getattr(mod, name)

            def wrapper(*a, _real=real, _name=name, **k):
                _sync(device)
                t0 = time.perf_counter()
                out = _real(*a, **k)
                _sync(device)
                dt = time.perf_counter() - t0
                seen = set()
                nbytes = _nbytes(a, seen) + _nbytes(k, seen) + _nbytes(out, seen)
                st = stats.setdefault(_name, {"calls": 0, "runs": []})
                st["calls"] += 1
                st["runs"].append((nbytes, dt))
                return out

            setattr(mod, name, wrapper)
            patched.append((mod, name, real))
    try:
        yield stats
    finally:
        for mod, name, real in patched:
            setattr(mod, name, real)


def xla_rows(stats: dict) -> list:
    """One row per ported function: its calls in phase 14 and, at its
    largest shape there, the median time of those calls after the first
    (the first pays the allocator's growth) and the byte bound."""
    rows = []
    for funcs in XLA_FUNCS.values():
        for name, ref in funcs.items():
            st = stats.get(name, {"calls": 0, "runs": []})
            row = {"name": name, "replaces": ref, "launches": st["calls"], "ms": None,
                   "bound_ms": None, "bytes": None}
            if st["runs"]:
                top = max(b for b, _ in st["runs"])
                times = [dt for b, dt in st["runs"] if b == top]
                times = sorted(times[1:] or times)
                row.update(bytes=top, ms=1e3 * times[len(times) // 2],
                           bound_ms=1e3 * top / HBM_BYTES_PER_S)
            rows.append(row)
    return rows


def _wall(fn, device: str, reps: int = 7) -> float:
    """Median wall seconds of *reps* runs of *fn*, each ending in a drain
    of the device."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def _sorted_rank(values: np.ndarray) -> np.ndarray:
    """Position of each value in the byte order of *values* (the row of a
    unique index over them)."""
    rank = np.empty(values.size, np.int64)
    rank[np.argsort(values, kind="stable")] = np.arange(values.size)
    return rank


def run_flagship(orders, cust, prod, data: dict, device: str, leg: str, workdir: Path,
                 stats: dict, card: str) -> dict:
    """Phase 14 (a): config 3 through ``models.flagship`` on phase 4's
    tables.  ``ThreewayJoin.run()`` on the all-matched tables (the fused
    route) must equal the plain API's join on the same tables, bitwise,
    and the numpy oracle; a run against a customers index over a seeded
    99 % of the customers (the compaction route) likewise; ``step()``,
    ``gather_columns`` and ``_fused_direct_probe`` on the probes against
    numpy.  Prints the warm ``run()`` beside the warm plain-API join
    (medians of 7)."""
    import torch

    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.columnar.table import DeviceTable
    from csvplus_tpu_torch.models import flagship as F
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    what = f"phase 14 (a) [{leg}]"
    n = data["n"]
    c, p = data["cols"]["cust"], data["cols"]["prod"]
    rank_c, rank_p = _sorted_rank(c["id"]), _sorted_rank(p["prod_id"])
    out = {}
    with counted_calls(stats, device):
        orders_t = orders.to_device_table()
        tw = F.ThreewayJoin.build(orders_t, cust.device_table, prod.device_table)

        def fused_calls():
            return stats.get("_fused_unique_join", {}).get("calls", 0)

        before = fused_calls()
        table = tw.run()
        if fused_calls() != before + 1:
            raise AssertionError(f"{what}: run() did not take the fused route")
        plain_src = orders.join(cust, "cust_id").join(prod)
        plain = plain_src.to_device_table()
        sums = _table_sums(table, device, what)
        if sums != _table_sums(plain, device, what) or table.nrows != plain.nrows:
            raise AssertionError(f"{what}: run() != the plain API's join")
        _check_oracle(table, sums, oracle(data, np.ones(n, bool), sorted(table.columns)),
                      f"{what} run()")
        out["run_warm_s"] = _wall(tw.run, device)
        out["plain_warm_s"] = _wall(plain_src.to_device_table, device)

        # the three probe-side functions on the 10M probes, against numpy
        lo_c, lo_p, valid = tw.step()
        want_c, want_p = rank_c[data["cust"]], rank_p[data["prod"]]
        if not (np.array_equal(lo_c.cpu().numpy(), want_c)
                and np.array_equal(lo_p.cpu().numpy(), want_p) and bool(valid.all())):
            raise AssertionError(f"{what}: step() != numpy")
        d_c, d_p, d_valid = F._fused_direct_probe(
            tw.cust.direct_cum, tw.prod.direct_cum, tw.qk_cust, tw.qk_prod)
        if not (np.array_equal(d_c.cpu().numpy(), want_c)
                and np.array_equal(d_p.cpu().numpy(), want_p) and bool(d_valid.all())):
            raise AssertionError(f"{what}: _fused_direct_probe != numpy")
        name_col = tw.cust.table.columns["name"]
        (g,) = F.gather_columns(lo_c, valid, name_col.storage)
        got = checksum_device_table(DeviceTable({"name": name_col.with_storage(g)}, n,
                                                g.device), ["name"], positional=True)
        if got["name"] != _positional_sum(_fnv32(c["name"])[data["cust"]]):
            raise AssertionError(f"{what}: gather_columns != numpy")
        for _ in range(6):  # seven timed calls of each
            tw.step()
            F._fused_direct_probe(tw.cust.direct_cum, tw.prod.direct_cum, tw.qk_cust,
                                  tw.qk_prod)
            F.gather_columns(lo_c, valid, name_col.storage)

        # the compaction route: a customers index over a seeded 99 %
        rng = np.random.default_rng(data["seed"] + 14)
        kept = np.sort(rng.permutation(N_CUST)[: int(FLAGSHIP_CUST_KEEP * N_CUST)])
        path = workdir / "customers_99.csv"
        with open(path, "wb") as f:
            f.write(b"id,name\n" + b"\n".join(
                np.char.add(np.char.add(c["id"][kept], b","), c["name"][kept]).tolist()) + b"\n")
        cust99 = T.from_file(str(path)).on_device(device).unique_index_on("id")
        data["cust99"] = {"index": cust99, "kept": kept}  # phase 15 (c) joins it too
        tw99 = F.ThreewayJoin.build(orders_t, cust99.device_table, prod.device_table)
        part = tw99.run()
        keep = np.isin(data["cust"], kept)
        sums99 = _table_sums(part, device, what)
        plain99 = orders.join(cust99, "cust_id").join(prod).to_device_table()
        if sums99 != _table_sums(plain99, device, what):
            raise AssertionError(f"{what}: partial run() != the plain API's join")
        _check_oracle(part, sums99, oracle(data, keep, sorted(part.columns)),
                      f"{what} partial run()")
        out["partial_rows"] = part.nrows
        out["partial_warm_s"] = _wall(tw99.run, device)
    log(f"{what}: run() == plain join == oracle ({table.nrows:,} rows, checksums of "
        f"{len(sums)} columns, first rows); partial (99 % of customers): {part.nrows:,} rows "
        f"== plain join == oracle; step / _fused_direct_probe / gather_columns == numpy; "
        f"warm run() {out['run_warm_s']:.4f}s vs warm plain-API join {out['plain_warm_s']:.4f}s "
        f"(medians of 7), partial run() {out['partial_warm_s']:.4f}s | {card}")
    return out


def _md_keys(rng, n_keys: int, wide: bool) -> "tuple[np.ndarray, np.ndarray]":
    """(sorted build keys with ~10 % of the distinct keys repeated, the
    distinct keys).  Gaps of at least 2 leave every ``key - 1`` absent."""
    limit = (1 << 62) - 2 if wide else (1 << 31) - 2
    u = max(int(n_keys / 1.1), 1)
    uniq = np.cumsum(rng.integers(2, max(3, int(1.6 * limit / u)), u, dtype=np.int64))
    if uniq[-1] > limit:
        raise AssertionError("build keys past their width")
    rep = 1 + (rng.random(u) < 0.1) * rng.integers(1, 3, u)
    keys = np.repeat(uniq, rep)[:n_keys]
    dtype = np.int64 if wide else np.int32
    return keys.astype(dtype), uniq[uniq <= keys[-1]].astype(dtype)


def _md_probes(rng, uniq: np.ndarray, m: int, zipf: bool = False) -> np.ndarray:
    """*m* probes: uniform over the distinct keys with ~9 % absent values
    and ~0.5 % -1, or Zipf(s = 1.1) ranks over a seeded permutation of
    them."""
    if zipf:
        ranks = rng.zipf(ZIPF_S, m)
        perm = rng.permutation(uniq.size)
        return uniq[perm[(ranks - 1) % uniq.size]]
    q = uniq[rng.integers(0, uniq.size, m)]
    r = rng.random(m, dtype=np.float32)
    q[r < 0.09] -= 1
    q[r >= 0.995] = -1
    return q


def _stable_argsort(values: np.ndarray) -> np.ndarray:
    """``np.argsort(values, kind="stable")``; int32 values sort as one
    int64 key ``value << 32 | row`` (distinct keys, so any sort gives the
    stable order, and numpy's default int64 sort is several times faster
    than its stable one at 100M)."""
    if values.dtype != np.int32:
        return np.argsort(values, kind="stable")
    key = (values.astype(np.int64) << 32) | np.arange(values.size, dtype=np.int64)
    key.sort()
    return key & 0xFFFFFFFF


def _check_probe(keys: np.ndarray, q: np.ndarray, lo: np.ndarray, ct: np.ndarray,
                 what: str) -> dict:
    """Every answer against ``np.searchsorted`` left and right (over the
    sorted probes, then compared through the sort order)."""
    order = _stable_argsort(q)
    sq = q[order]
    want_lo = np.searchsorted(keys, sq, side="left")
    want_ct = np.searchsorted(keys, sq, side="right") - want_lo
    want_ct[sq < 0] = 0
    got_ct = ct[order]
    if not np.array_equal(got_ct, want_ct):
        raise AssertionError(f"{what}: counts != np.searchsorted")
    hit = want_ct > 0
    if not np.array_equal(lo[order][hit], want_lo[hit]):
        raise AssertionError(f"{what}: lower bounds != np.searchsorted")
    return {"hits": int(hit.sum()), "invalid": int((sq < 0).sum()),
            "absent": int((~hit & (sq >= 0)).sum()), "max_count": int(want_ct.max(initial=0))}


def _peak_reset(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device: str) -> "float | None":
    if device != "cuda":
        return None
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def _stage_extras(merged) -> dict:
    by = {r.stage: r.extra for r in merged}
    x = by.get("join:all_to_all", {})
    return {"capacity": x.get("capacity"), "retries": x.get("retries"),
            "hot_keys": by.get("join:skew-detect", {}).get("hot_keys", 0),
            "rows_broadcast": by.get("join:skew", {}).get("rows_broadcast", 0)}


def _probe_leg(mesh, keys: np.ndarray, q: np.ndarray, device: str, what: str,
               card: str) -> dict:
    """Partition the build keys once, probe the row-sharded *q* twice
    (cold, warm) under ``telemetry.collect()``, hold the warm answers
    against numpy.  Returns the leg's numbers."""
    from csvplus_tpu_torch.parallel import pjoin as PJ
    from csvplus_tpu_torch.parallel.mesh import shard_rows
    from csvplus_tpu_torch.utils.observe import telemetry

    wide = q.dtype == np.int64
    t0 = time.perf_counter()
    prepared = PJ.prepare_partitioned(mesh, keys)
    _sync(device)
    prep_s = time.perf_counter() - t0
    args = [shard_rows(mesh, x) for x in (PJ.split_lanes(q) if wide else (q,))]
    probe = PJ.partitioned_probe_device_wide if wide else PJ.partitioned_probe_device
    runs = []
    for _ in range(2):  # cold, then warm
        _peak_reset(device)
        with telemetry.collect():
            t0 = time.perf_counter()
            lo, ct = probe(mesh, *args, prepared)
            _sync(device)
            secs = time.perf_counter() - t0
            runs.append(dict(seconds=secs, syncs=telemetry.host_sync_elements,
                             **_stage_extras(telemetry.merged_stages())))
        runs[-1]["peak_gib"] = _peak_gib(device)
    check = _check_probe(keys, q, lo.numpy(), ct.numpy(), what)
    warm = runs[-1]
    res = {"probes": int(q.size), "keys": int(keys.size), "shards": mesh.size,
           "prepare_s": prep_s, "cold_s": runs[0]["seconds"], **warm,
           "probes_per_s": q.size / warm["seconds"], **check}
    peak = f"{warm['peak_gib']:.2f} GiB" if warm["peak_gib"] is not None else "not measured"
    log(f"{what}: {q.size:,} probes over {keys.size:,} keys on {mesh.size} shards == "
        f"np.searchsorted ({check['hits']:,} hits, {check['absent']:,} absent, "
        f"{check['invalid']:,} invalid); warm {warm['seconds']:.3f}s "
        f"({res['probes_per_s']:,.0f} probes/s), cold {runs[0]['seconds']:.3f}s, partition + "
        f"upload {prep_s:.2f}s; capacity {warm['capacity']}, retries {warm['retries']}, hot keys "
        f"{warm['hot_keys']}, rows broadcast {warm['rows_broadcast']:,}, host-sync elements "
        f"{warm['syncs']}, peak device memory {peak} | {card}")
    return res


def _sort_leg(mesh, values: np.ndarray, device: str, what: str, card: str) -> dict:
    """Sort *values* with the iota payload on the mesh, cold then warm;
    the values must equal ``np.sort`` and the permutation a stable
    ``np.argsort``."""
    import torch

    from csvplus_tpu_torch.parallel import dsort as DS
    from csvplus_tpu_torch.parallel.mesh import shard_rows
    from csvplus_tpu_torch.parallel.pjoin import split_lanes
    from csvplus_tpu_torch.utils.observe import telemetry

    wide = values.dtype == np.int64
    n = int(values.size)
    lanes = tuple(shard_rows(mesh, x) for x in (split_lanes(values) if wide else (values,)))
    iota = torch.arange(n, dtype=torch.int32, device=mesh.devices[0])
    runs = []
    for _ in range(2):
        _peak_reset(device)
        with telemetry.collect():
            t0 = time.perf_counter()
            out, perm = DS.distributed_sort_device(mesh, lanes, iota)
            _sync(device)
            runs.append({"seconds": time.perf_counter() - t0,
                         "attempts": telemetry.host_sync_elements})
        runs[-1]["peak_gib"] = _peak_gib(device)
    got = out[0].numpy().astype(np.int64) << 31 | out[1].numpy() if wide else out[0].numpy()
    order = _stable_argsort(values)
    if not np.array_equal(got, values[order]):
        raise AssertionError(f"{what}: values != np.sort")
    if not np.array_equal(perm.numpy(), order):
        raise AssertionError(f"{what}: permutation != stable np.argsort")
    warm = runs[-1]
    cap0 = DS._capacity_plan(n, mesh.size, None)[0]
    res = {"rows": n, "cold_s": runs[0]["seconds"], "seconds": warm["seconds"],
           "rows_per_s": n / warm["seconds"], "retries": warm["attempts"] - 1,
           "capacity": cap0 << (warm["attempts"] - 1), "peak_gib": warm["peak_gib"]}
    peak = f"{warm['peak_gib']:.2f} GiB" if warm["peak_gib"] is not None else "not measured"
    log(f"{what}: {n:,} {values.dtype} values on {mesh.size} shards == np.sort, permutation == "
        f"stable np.argsort; warm {warm['seconds']:.3f}s ({res['rows_per_s']:,.0f} rows/s), cold "
        f"{runs[0]['seconds']:.3f}s; capacity {res['capacity']}, retries {res['retries']}, peak "
        f"device memory {peak} | {card}")
    return res


def _entry_check(device: str) -> dict:
    """``graft.entry()``'s step on *device* against numpy."""
    from csvplus_tpu_torch import graft

    step, args = graft.entry(device)
    ck, pk, qc, qp = (a.cpu().numpy() for a in args)
    lo_c, lo_p, valid = (x.cpu().numpy() for x in step(*args))
    want_c = np.minimum(np.searchsorted(ck, qc), ck.size - 1)
    want_p = np.minimum(np.searchsorted(pk, qp), pk.size - 1)
    want_v = (ck[want_c] == qc) & (qc >= 0) & (pk[want_p] == qp) & (qp >= 0)
    if not (np.array_equal(lo_c, want_c) and np.array_equal(lo_p, want_p)
            and np.array_equal(valid, want_v)):
        raise AssertionError("graft.entry() step != numpy")
    return {"rows": int(qc.size), "valid": int(want_v.sum())}


def run_multidevice_path(seed: int, device: str, stats: dict, card: str, shards: int = N_MD_SHARDS,
                         n_keys: int = N_MD_KEYS, n_probes: int = N_MD_PROBES,
                         n_zipf: int = N_MD_ZIPF, n_wide: int = N_MD_WIDE,
                         n_wide_keys: int = N_MD_WIDE_KEYS, n_sort: int = N_MD_SORT,
                         n_sort_wide: int = N_MD_SORT_WIDE,
                         n_sort_skew: int = N_MD_SORT_SKEW) -> dict:
    """Phase 14 (b)-(e) on a mesh of *shards* shards all on *device*'s
    first device (``make_mesh(shards, devices=[...] * shards)``): the
    partitioned probe in BASELINE config 5's shape, its skew tier and its
    wide tier, the sample sort, the graft entry and its dry run, and (b1)
    again over distinct cards where more than one is visible."""
    import torch

    from csvplus_tpu_torch import graft
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.parallel.mesh import make_mesh

    first = "cuda:0" if device == "cuda" else "cpu"
    mesh = make_mesh(shards, devices=[first] * shards)
    rng = np.random.default_rng(seed + 1400)
    out = {"shards": shards, "device": first}
    M.launches = P.launches = 0  # the phase's run starts here
    with counted_calls(stats, device):
        t0 = time.perf_counter()
        keys, uniq = _md_keys(rng, n_keys, wide=False)
        q = _md_probes(rng, uniq, n_probes)
        log(f"phase 14 data: {n_keys:,} build keys, {n_probes:,} probes in "
            f"{time.perf_counter() - t0:.1f}s")
        out["b1"] = _probe_leg(mesh, keys, q, device, "phase 14 (b1) uniform", card)
        del q
        qz = _md_probes(rng, uniq, n_zipf, zipf=True)
        with _env_set({"CSVPLUS_JOIN_SKEW_THRESHOLD": ZIPF_THRESHOLD}):
            out["b2"] = _probe_leg(mesh, keys, qz, device, "phase 14 (b2) Zipf(1.1), skew tier",
                                   card)
            if not out["b2"]["hot_keys"]:
                raise AssertionError("phase 14 (b2): the hot tier never engaged")
            with _env_set({"CSVPLUS_JOIN_SKEW": "0"}):
                out["b2_naive"] = _probe_leg(mesh, keys, qz, device,
                                             "phase 14 (b2) Zipf(1.1), CSVPLUS_JOIN_SKEW=0", card)
        del qz, keys, uniq
        wkeys, wuniq = _md_keys(rng, n_wide_keys, wide=True)
        qw = _md_probes(rng, wuniq, n_wide)
        out["b3"] = _probe_leg(mesh, wkeys, qw, device, "phase 14 (b3) wide 62-bit keys", card)
        del qw
        qw = _md_probes(rng, wuniq, n_wide, zipf=True)  # the wide tier's hot path
        with _env_set({"CSVPLUS_JOIN_SKEW_THRESHOLD": ZIPF_THRESHOLD}):
            out["b3_zipf"] = _probe_leg(mesh, wkeys, qw, device,
                                        "phase 14 (b3) wide keys, Zipf(1.1), skew tier", card)
        if not out["b3_zipf"]["hot_keys"]:
            raise AssertionError("phase 14 (b3): the wide hot tier never engaged")
        del qw, wkeys, wuniq
        gc.collect()

        sort_in = rng.integers(-(2**31), 2**31 - 1, n_sort, dtype=np.int64).astype(np.int32)
        out["c1"] = _sort_leg(mesh, sort_in, device, "phase 14 (c1) int32 sample sort", card)
        del sort_in
        wide_in = rng.integers(0, 1 << 62, n_sort_wide, dtype=np.int64)
        out["c2"] = _sort_leg(mesh, wide_in, device, "phase 14 (c2) 62-bit sample sort", card)
        del wide_in
        skew_in = rng.integers(0, 1 << 30, n_sort_skew, dtype=np.int64).astype(np.int32)
        skew_in[rng.random(n_sort_skew) < 0.9] = 123_456
        out["c3"] = _sort_leg(mesh, skew_in, device, "phase 14 (c3) 90 % one value", card)
        if out["c3"]["retries"] < 1:
            raise AssertionError("phase 14 (c3): the skewed sort never retried")
        del skew_in
        gc.collect()

        out["d_entry"] = _entry_check(device)
        t0 = time.perf_counter()
        out["d_dryrun"] = graft.dryrun_multichip(shards, devices=[first] * shards)
        out["d_dryrun"]["seconds"] = time.perf_counter() - t0
        ran = [p.split()[0] for p in out["d_dryrun"]["paths"]]
        if ran != ["1", "2", "3", "3b", "3c", "4", "5"][: len(ran)] or "4" not in ran or (
                shards % 2 == 0 and shards >= 4 and "5" not in ran):
            raise AssertionError(f"phase 14 (d) / 15 (d): the dry run ran paths {ran}")
        log(f"phase 14 (d): graft.entry() step == numpy ({out['d_entry']['valid']:,} of "
            f"{out['d_entry']['rows']:,} valid); dryrun_multichip({shards}) on {first} in "
            f"{out['d_dryrun']['seconds']:.2f}s | {card}")

        count = torch.cuda.device_count() if device == "cuda" else 0
        if count > 1:
            # the same over distinct cards: every exchange crosses cards
            cards = make_mesh(min(count, shards))
            k2, u2 = _md_keys(np.random.default_rng(seed + 1401), n_keys, wide=False)
            q2 = _md_probes(np.random.default_rng(seed + 1402), u2, n_probes)
            out["e"] = {"probe": _probe_leg(
                cards, k2, q2, device, f"phase 14 (e) uniform over {cards.size} distinct cards",
                card)}
            del q2, k2, u2
            out["e"]["sort"] = _sort_leg(
                cards, rng.integers(-(2**31), 2**31 - 1, n_sort, dtype=np.int64).astype(np.int32),
                device, f"phase 14 (e) int32 sample sort over {cards.size} distinct cards", card)
            out["e"]["dryrun"] = graft.dryrun_multichip(cards.size)  # cuda:0 .. cuda:n-1
        else:
            out["e"] = None
            log(f"phase 14 (e) did not run: {count} CUDA card(s) visible, and (e) spreads (b1), "
                f"the int32 sort and the dry run over distinct cards")
    out["launches"] = {"mask": M.launches, "pack": P.launches}  # ... and ends here
    return out


# -- phase 15: sharded tables behind the public API (BASELINE config 5) -------

N_CONFIG5 = 100_000_000  # BASELINE.json config 5: "8-way sharded 100M-row orders.csv join"
C5_SHARDS = 8
C5_PADDED_SHARDS = 7  # 10,000,000 = 7 x 1,428,571 + 3: the tail is padded
N_C5_SKEW = 20_000_005  # not a multiple of 8: the skew leg's stream is padded
N_C5_SKEW_CUST = 1_500_000  # over C5_PARTITION_MIN_KEYS: the partitioned tier
C5_PARTITION_MIN_KEYS = 1_000_000  # NORTHSTAR_MESH_r08.json's env_overrides
N_C5_FIND = 1_000
C5_REPS = 5
C5_MAIN_PATH = "phase 15 (a) 100M, 8 shards"  # the slice's path in the kernels line
C5_PACK_PATH = "phase 15 (c) 10M device-parsed, 7 shards"


def _assembled() -> "tuple[int, int]":
    from csvplus_tpu_torch.parallel.mesh import assemblies

    return assemblies["count"], assemblies["bytes"]


def _shard_mesh(device: str, shards: int):
    from csvplus_tpu_torch.parallel.mesh import make_mesh

    first = "cuda:0" if device == "cuda" else "cpu"
    return make_mesh(shards, devices=[first] * shards)


def run_sharded_leg(data: dict, cust, prod, plain_src, plain_table, device: str, leg: str,
                    card: str, shards: int = C5_PADDED_SHARDS) -> dict:
    """Phase 15 (c), at the end of each phase-4 leg: the leg's 10M-order
    file through ``on_device(mesh=...)`` on *shards* shards of one device
    (the whole-file tier, then ``with_sharding``: the tail padded), the
    leg's pipelines (a) and (b), the join against phase 14 (a)'s 99 %
    customers index (unique-partial per shard), ``ThreewayJoin.run()``
    (the padded branch) and ``unique_index_on("order_id")`` (the dsort
    route, the index left sharded) with ``find_many`` on seeded ids, each
    against its oracle.  Then the unfiltered three-way join on a 1-shard
    mesh (the sharded code on one block) against *plain_src*, the same
    join on the unsharded orders (*plain_table* its result), timed in
    turn."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.models import flagship as F
    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.utils.observe import telemetry

    what = f"phase 15 (c) [{leg}]"
    n = data["n"]
    mesh = _shard_mesh(device, shards)
    _peak_reset(device)
    a0 = _assembled()
    with recorded_pack_calls() as pack_calls:
        P.launches = 0  # the sharded ingest starts here
        t0 = time.perf_counter()
        orders = T.from_file(str(data["paths"]["orders"])).on_device(mesh=mesh)
        _sync(device)
        t_ingest = time.perf_counter() - t0
        pack_launches = P.launches  # ... and ends here
    pack_check = check_path_packs(pack_calls, what, pack_launches, device)
    table = orders.plan.table
    kinds = {c: table.columns[c].kind for c in ORDERS_COLS}
    if table.ingest_tier != leg or table.mesh is not mesh or table.stored_len <= n:
        raise AssertionError(f"{what}: tier {table.ingest_tier}, mesh {table.mesh}, stored "
                             f"{table.stored_len} for {n} rows (a padded {shards}-shard table "
                             f"of the {leg} tier expected)")
    if leg == "device-parsed" and device == "cuda" and pack_launches < len(ORDERS_COLS):
        raise AssertionError(f"{what}: the pack kernel ran {pack_launches} times")
    log(f"{what}: {n:,} orders on {shards} shards of {mesh.devices[0]} in {t_ingest:.2f}s "
        f"({leg} tier, then with_sharding; shard rows {table.shard_row_counts()}, stored "
        f"{table.stored_len:,}); kinds {kinds}; pack launches {pack_launches}")
    run = run_pipelines(orders, cust, prod, data, device, what,
                        typed_lanes=leg == "native-encoded")
    out = {"ingest_s": t_ingest, "pack_launches": pack_launches, "pack_check": pack_check,
           "pipelines": run["pipelines"],
           "launches": run["launches"], "mask_check": run["mask_check"],
           "shard_rows": table.shard_row_counts()}

    # a partial join per shard: a customers index over 99 % of them
    from csvplus_tpu_torch.ops import join as TJ

    partial0 = TJ.expand_paths["unique-partial"]
    c99 = data["cust99"]
    part = orders.join(c99["index"], "cust_id").join(prod).to_device_table()
    if TJ.expand_paths["unique-partial"] != partial0 + 1:
        raise AssertionError(f"{what}: the 99 % customers join did not take unique-partial")
    _check_oracle(part, _table_sums(part, device, what),
                  oracle(data, np.isin(data["cust"], c99["kept"]), sorted(part.columns)),
                  f"{what} 99 % customers join")
    out["partial_rows"] = part.nrows
    del part

    # the flagship's padded branch
    paths0 = dict(F.run_paths)
    tw = F.ThreewayJoin.build(table, cust.device_table, prod.device_table)
    joined = tw.run()
    if F.run_paths["padded"] != paths0.get("padded", 0) + 1:
        raise AssertionError(f"{what}: ThreewayJoin.run() did not take the padded branch")
    sums = _table_sums(joined, device, what)
    if sums != _table_sums(plain_table, device, what):
        raise AssertionError(f"{what}: padded run() != the plain API's join")
    _check_oracle(joined, sums, oracle(data, np.ones(n, bool), sorted(joined.columns)),
                  f"{what} padded run()")
    out["flagship_warm_s"] = _wall(tw.run, device, reps=3)
    del joined, tw

    # the index build through the sample sort, then seeded point lookups
    t0 = time.perf_counter()
    with telemetry.collect():
        idx = orders.unique_index_on("order_id")
        _sync(device)
        stages = [r.stage for r in telemetry.records]
    t_index = time.perf_counter() - t0
    if "dsort" not in stages:
        raise AssertionError(f"{what}: the index build did not take the dsort route: {stages}")
    from csvplus_tpu_torch.parallel.mesh import ShardedRows

    itab = idx.device_table.table
    if not all(isinstance(c.storage, ShardedRows) and c.storage.mesh is mesh
               for c in itab.columns.values()):
        raise AssertionError(f"{what}: the dsort-built index is not sharded over the mesh")
    out["index_shard_rows"] = itab.shard_row_counts()
    rng = np.random.default_rng(data["seed"] + 1503)
    ids = rng.integers(0, n, N_C5_FIND)
    probes = [f"o{i}" for i in ids.tolist()]
    got = T.to_rows_many(idx.find_many(probes))
    c, p = data["cols"]["cust"], data["cols"]["prod"]
    for i, rows in zip(ids.tolist(), got):
        want = {"order_id": f"o{i}", "cust_id": c["id"][data["cust"][i]].decode(),
                "prod_id": p["prod_id"][data["prod"][i]].decode(), "qty": str(data["qty"][i])}
        if [dict(r) for r in rows] != [want]:
            raise AssertionError(f"{what}: find_many({i}) gave {rows}, want {want}")
    a1 = _assembled()
    out.update(index_s=t_index, assemblies=a1[0] - a0[0], assembled_bytes=a1[1] - a0[1],
               peak_gib=_peak_gib(device), flagship_paths=dict(F.run_paths))
    log(f"{what}: the 99 % customers join (unique-partial per shard) == oracle "
        f"({out['partial_rows']:,} rows); ThreewayJoin.run() took the padded branch == plain "
        f"join == oracle (warm "
        f"{out['flagship_warm_s']:.4f}s); unique_index_on(order_id) through dsort in "
        f"{t_index:.2f}s, the index sharded {out['index_shard_rows']}, {N_C5_FIND:,} "
        f"find_many == numpy; assemblies {out['assemblies']} ({out['assembled_bytes']:,} bytes: "
        f"the flagship's compaction ids, the sort's gather copies, the index's key and its "
        f"demotion); peak {out['peak_gib']} GiB | {card}")
    del idx, itab, orders, table

    # one shard against none: what the sharded code costs where no split
    # is needed (each timed in turn, the same join, the same card)
    one = T.from_file(str(data["paths"]["orders"])).on_device(mesh=_shard_mesh(device, 1))
    src1 = one.join(cust, "cust_id").join(prod)
    if _table_sums(src1.to_device_table(), device, what) != _table_sums(plain_table, device,
                                                                        what):
        raise AssertionError(f"{what}: the 1-shard join != the unsharded join")
    out["one_shard_ms"] = 1e3 * _wall(src1.to_device_table, device, reps=C5_REPS)
    out["unsharded_ms"] = 1e3 * _wall(plain_src.to_device_table, device, reps=C5_REPS)
    del one, src1
    log(f"{what}: the three-way join on a 1-shard mesh == the unsharded join; warm "
        f"{out['one_shard_ms']:.2f} ms against {out['unsharded_ms']:.2f} ms unsharded (median "
        f"of {C5_REPS} each) | {card}")
    return out


def zipf_data(root: Path, n_orders: int, n_cust: int, seed: int) -> dict:
    """Phase 15 (b)'s files, ``bench.py``'s Zipf fact-table layout: each
    order's ``cust_id`` a Zipf(1.1) draw over a seeded permutation of the
    customers (truncated at *n_cust* ranks), products and quantities
    uniform.  Returns the arrays in :func:`generate`'s form."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_cust)
    w = np.arange(1, n_cust + 1, dtype=np.float64) ** -ZIPF_S
    w /= w.sum()
    cust = perm[rng.choice(n_cust, size=n_orders, p=w)]
    prod = rng.integers(0, N_PROD, n_orders)
    qty = rng.integers(1, 101, n_orders)
    ci = np.arange(n_cust)
    pi = np.arange(N_PROD)
    price = np.array([f"{(i % 9900) / 100 + 0.99:.2f}".encode() for i in pi])
    cols = {"cust": {"id": _sbytes(b"c", ci), "name": _sbytes(b"name", ci % 9973)},
            "prod": {"prod_id": _sbytes(b"p", pi), "product": _sbytes(b"prod", pi),
                     "price": price}}
    paths = {"orders": root / "orders_zipf.csv", "cust": root / "customers_zipf.csv",
             "prod": root / "products_zipf.csv"}
    with open(paths["cust"], "wb") as f:
        f.write(b"id,name\n" + b"\n".join(np.char.add(np.char.add(cols["cust"]["id"], b","),
                                                       cols["cust"]["name"]).tolist()) + b"\n")
    with open(paths["prod"], "wb") as f:
        pc = cols["prod"]
        f.write(b"prod_id,product,price\n" + b"\n".join(np.char.add(np.char.add(np.char.add(
            pc["prod_id"], b","), np.char.add(pc["product"], b",")), pc["price"]).tolist())
            + b"\n")
    with open(paths["orders"], "wb") as f:
        f.write(b"order_id,cust_id,prod_id,qty\n")
        _write_rows(f, n_orders, lambda lo, hi: _orders_lines(lo, hi, cust, prod, qty))
    return {"paths": paths, "cust": cust, "prod": prod, "qty": qty, "cols": cols,
            "n": n_orders, "seed": seed}


def _timed_join(src, device: str, reps: int) -> dict:
    """Cold, then the median of *reps* warm runs of *src* (seconds), the
    result of the last run, and the columns assembled across them."""
    a0 = _assembled()
    t0 = time.perf_counter()
    table = src.to_device_table()
    _sync(device)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        del table
        t0 = time.perf_counter()
        table = src.to_device_table()
        _sync(device)
        warm.append(time.perf_counter() - t0)
    a1 = _assembled()
    return {"table": table, "cold_s": cold, "warm_s": float(np.median(warm)),
            "assemblies": a1[0] - a0[0], "assembled_bytes": a1[1] - a0[1]}


def _config5_join(orders, cust, prod, data: dict, device: str, what: str, card: str,
                  reps: int) -> dict:
    """The plain three-way join on the sharded *orders*, cold and warm,
    against the oracle; it must assemble nothing."""
    src = orders.join(cust, "cust_id").join(prod)
    run = _timed_join(src, device, reps)
    table = run.pop("table")
    sums = _table_sums(table, device, what)
    t0 = time.perf_counter()
    _check_oracle(table, sums, oracle(data, np.ones(data["n"], bool), sorted(table.columns)),
                  what)
    run["oracle_s"] = time.perf_counter() - t0
    if run["assemblies"]:
        raise AssertionError(f"{what}: the join assembled {run['assemblies']} arrays")
    n = data["n"]
    log(f"{what}: {table.nrows:,} rows == oracle (positional checksums of "
        f"{len(sums)} columns, first rows; oracle {run['oracle_s']:.1f}s); cold "
        f"{run['cold_s']:.3f}s, warm {run['warm_s']:.3f}s (median of {reps}, "
        f"{n / run['warm_s']:,.0f} rows/s); assemblies 0 | {card}")
    run.update(rows=table.nrows, sums=sums)
    return run, table


def run_config5_path(seed: int, device: str, workdir: Path, card: str,
                     n_orders: int = N_CONFIG5, shards: int = C5_SHARDS,
                     n_skew: int = N_C5_SKEW, n_skew_cust: int = N_C5_SKEW_CUST,
                     partition_min_keys: int = C5_PARTITION_MIN_KEYS,
                     reps: int = C5_REPS) -> dict:
    """Phase 15 (a), (b) and (e): BASELINE config 5 end to end through the
    public API, the shards on one device (``make_mesh(8, devices=[...] *
    8)``) unless (e) spreads them over distinct cards."""
    import torch

    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.models import flagship as F
    from csvplus_tpu_torch.models import workloads as W
    from csvplus_tpu_torch.ops import join as TJ
    from csvplus_tpu_torch.parallel.mesh import make_mesh
    from csvplus_tpu_torch.utils.observe import telemetry

    out = {}
    mesh = _shard_mesh(device, shards)
    if device == "cuda":
        log(f"phase 15 start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"(earlier phases' tables freed)")

    # (a) config 5 at its published size, streamed onto 8 shards
    t0 = time.perf_counter()
    data = generate(workdir, n_orders, seed, name="orders_c5.csv")
    out["gen_s"] = time.perf_counter() - t0
    log(f"phase 15 (a): generated {n_orders:,} orders "
        f"({data['paths']['orders'].stat().st_size / 1e9:.2f} GB) in {out['gen_s']:.1f}s")
    _peak_reset(device)
    with telemetry.collect():
        t0 = time.perf_counter()
        orders = T.from_file(str(data["paths"]["orders"])).on_device(mesh=mesh)
        _sync(device)
        t_ingest = time.perf_counter() - t0
        assemble = [r for r in telemetry.records if r.stage == "ingest:shard-assemble"]
    table = orders.plan.table
    if (table.ingest_tier != "streamed" or not table._pre_sharded or len(assemble) != 1
            or assemble[0].extra["n_shards"] != shards):
        raise AssertionError(f"phase 15 (a): tier {table.ingest_tier}, pre-sharded "
                             f"{table._pre_sharded}, shard-assemble stages {assemble}")
    secs = table.ingest_seconds
    out["ingest"] = {"seconds": t_ingest, "rows_per_s": n_orders / t_ingest,
                     "workers": secs["workers"], "chunks": secs["chunks"],
                     "scan_wait_s": secs["scan_wait"], "place_s": secs["place"],
                     "seal_s": secs.get("seal"), "shard_rows": table.shard_row_counts(),
                     "max_shard_rows": assemble[0].extra["max_shard_rows"],
                     "peak_gib": _peak_gib(device)}
    log(f"phase 15 (a): ingest {t_ingest:.2f}s ({n_orders / t_ingest:,.0f} rows/s) on the "
        f"streamed tier, K = {secs['workers']}, {secs['chunks']} chunks, scan-wait "
        f"{secs['scan_wait']:.2f}s, place {secs['place']:.2f}s, seal {secs.get('seal', 0):.2f}s; "
        f"shard rows {table.shard_row_counts()}; peak {out['ingest']['peak_gib']} GiB | {card}")
    dims, cust, prod = _index_dims(data, device)
    _peak_reset(device)
    out["join"], plain = _config5_join(orders, cust, prod, data, device,
                                       "phase 15 (a) config 5 three-way join", card, reps)
    out["join"]["peak_gib"] = _peak_gib(device)
    out["join"].pop("sums")
    src = orders.join(cust, "cust_id").join(prod)
    # the result is dropped here: held, its 8 columns of 100M rows would
    # stay live through (b)
    out["stage_table"] = stage_table(
        f"phase 15 (a) warm config 5 join, {n_orders:,} orders on {shards} shards",
        lambda: (src.to_device_table(), _sync(device)))[1]
    out["analysis"] = analysis_check(  # phase 16 (b) on the plan that just ran
        src, "sharded", out["join"]["warm_s"],
        f"phase 16 (b) config 5 three-way join, {n_orders:,} orders on {shards} shards", card)
    del src

    # workloads.sharded_join == the same join's first hop
    first_hop = orders.join(cust, "cust_id").to_device_table()
    t0 = time.perf_counter()
    sj = W.sharded_join(T.from_file(str(data["paths"]["orders"])), cust, shards,
                        mesh=mesh).to_device_table()
    _sync(device)
    out["sharded_join_s"] = time.perf_counter() - t0
    if _table_sums(sj, device, "sharded_join") != _table_sums(first_hop, device, "first hop"):
        raise AssertionError("phase 15 (a): workloads.sharded_join != the join's first hop")
    log(f"phase 15 (a): workloads.sharded_join (ingest + join) in {out['sharded_join_s']:.2f}s "
        f"== orders.join(cust)'s {first_hop.nrows:,} rows | {card}")
    del sj, first_hop

    # phase 4's pipelines on the sharded stream; their mask launches replayed
    run = run_pipelines(orders, cust, prod, data, device, "phase 15 (a) 100M 8 shards")
    out.update(pipelines=run["pipelines"], launches=run["launches"], mask_check=run["mask_check"])
    del run

    # the flagship on the sharded stream: the fused route per shard (100M
    # rows split evenly over 8 shards; a padded stream takes the padded one)
    branch = "fused" if table.stored_len == n_orders else "padded"
    paths0 = dict(F.run_paths)
    tw = F.ThreewayJoin.build(table, cust.device_table, prod.device_table)
    joined = tw.run()
    if F.run_paths[branch] != paths0.get(branch, 0) + 1:
        raise AssertionError(f"phase 15 (a): ThreewayJoin.run() did not take the {branch} route")
    if (_table_sums(joined, device, "flagship") != _table_sums(plain, device, "plain")
            or joined.nrows != plain.nrows):
        raise AssertionError("phase 15 (a): ThreewayJoin.run() != the plain join")
    out["flagship_warm_s"] = _wall(tw.run, device, reps=reps)
    out["flagship_branch"] = branch
    log(f"phase 15 (a): ThreewayJoin.run() ({branch}, per shard) == the plain join; warm "
        f"{out['flagship_warm_s']:.4f}s (median of {reps}) | {card}")
    del joined, tw

    # (e) the same join over distinct cards
    count = torch.cuda.device_count() if device == "cuda" else 0
    if count > 1:
        cards = make_mesh(min(count, shards))
        t0 = time.perf_counter()
        orders_e = T.from_file(str(data["paths"]["orders"])).on_device(mesh=cards)
        _sync(device)
        t_e = time.perf_counter() - t0
        run_e, table_e = _config5_join(
            orders_e, cust, prod, data, device,
            f"phase 15 (e) config 5 over {cards.size} distinct cards", card, reps)
        out["e"] = {"cards": cards.size, "ingest_s": t_e, **{k: v for k, v in run_e.items()
                                                             if k != "sums"}}
        del orders_e, table_e
    else:
        out["e"] = None
        log(f"phase 15 (e) did not run: {count} CUDA card(s) visible; (e) spreads (a)'s "
            f"ingest and join over distinct cards")
    del orders, table, plain, dims, cust, prod, data
    gc.collect()

    # (b) the partitioned tier end to end on a padded Zipf stream
    t0 = time.perf_counter()
    zdata = zipf_data(workdir, n_skew, n_skew_cust, seed + 1502)
    out["skew_gen_s"] = time.perf_counter() - t0
    saved = TJ.DeviceIndex.PARTITION_MIN_KEYS
    TJ.DeviceIndex.PARTITION_MIN_KEYS = partition_min_keys  # read at import: set for the leg
    try:
        with _env_set({"CSVPLUS_JOIN_SKEW_THRESHOLD": ZIPF_THRESHOLD}):
            out["b"] = _skew_leg(zdata, device, mesh, card, reps)
    finally:
        TJ.DeviceIndex.PARTITION_MIN_KEYS = saved
    out["b"]["gen_s"] = out["skew_gen_s"]
    return out


def _skew_leg(zdata: dict, device: str, mesh, card: str, reps: int) -> dict:
    """Phase 15 (b)'s runs: the plain join (the partitioned tier, skew on),
    again with ``CSVPLUS_JOIN_SKEW=0``, and fused through ``PlanCache``
    (one ``part_info``); each equal to the oracle."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.serve import PlanCache
    from csvplus_tpu_torch.utils.observe import telemetry

    n = zdata["n"]
    what = f"phase 15 (b) {n:,} Zipf orders"
    _peak_reset(device)
    t0 = time.perf_counter()
    orders = T.from_file(str(zdata["paths"]["orders"])).on_device(mesh=mesh)
    _sync(device)
    t_ingest = time.perf_counter() - t0
    table = orders.plan.table
    if table.stored_len <= n or not table._pre_sharded:
        raise AssertionError(f"{what}: stored {table.stored_len} rows, pre-sharded "
                             f"{table._pre_sharded} (a padded streamed table expected)")
    dims, cust, prod = _index_dims(zdata, device)
    want = oracle(zdata, np.ones(n, bool), sorted(
        ["order_id", "cust_id", "prod_id", "qty", "id", "name", "product", "price"]))
    out = {"ingest_s": t_ingest, "stored_rows": table.stored_len, "runs": {}}
    legs = {"skew on": ({}, False), "skew off": ({"CSVPLUS_JOIN_SKEW": "0"}, False),
            "plan cache fused": ({}, True)}
    M.launches = 0
    for leg, (env, fused) in legs.items():
        with _env_set(env):
            src = orders.join(cust, "cust_id").join(prod)
            if fused:
                cache = PlanCache()

                def fn():
                    return cache.execute(src.plan)
            else:
                def fn():
                    return src.to_device_table()
            _peak_reset(device)
            a0 = _assembled()
            with telemetry.collect():
                t0 = time.perf_counter()
                result = fn()
                _sync(device)
                cold = time.perf_counter() - t0
                recs = list(telemetry.records)
                syncs = telemetry.host_sync_elements
            warm = []
            for _ in range(reps):
                del result
                t0 = time.perf_counter()
                result = fn()
                _sync(device)
                warm.append(time.perf_counter() - t0)
            assembled = _assembled()[0] - a0[0]
        # the customers' dimension partitions; the 1,000 products stay
        # under the threshold and broadcast
        x = [r for r in recs if r.stage == "join:all_to_all"]
        skew = [r.extra for r in recs if r.stage == "join:skew"]
        probes = [r.extra.get("tier") for r in recs if r.stage == "join:probe"]
        if len(x) != 1 or probes != ["direct"]:
            raise AssertionError(f"{what} [{leg}]: {len(x)} partitioned probes and broadcast "
                                 f"tiers {probes}; one of each expected")
        if (leg != "skew off") != bool(skew):
            raise AssertionError(f"{what} [{leg}]: join:skew stages {skew}")
        sums = _table_sums(result, device, what)
        _check_oracle(result, sums, want, f"{what} [{leg}]")
        run = {"cold_s": cold, "warm_s": float(np.median(warm)), "host_sync_elements": syncs,
               "capacity": [r.extra["capacity"] for r in x],
               "retries": [r.extra["retries"] for r in x],
               "hot_keys": [s["hot_keys"] for s in skew],
               "rows_broadcast": [s["rows_broadcast"] for s in skew],
               "peak_gib": _peak_gib(device), "assemblies": assembled}
        if assembled:
            raise AssertionError(f"{what} [{leg}]: the join assembled {assembled} arrays")
        if fused:
            st = cache.stats()
            if st["fused_chains"] != 1 and st["fused"] != 1:
                raise AssertionError(f"{what} [{leg}]: the plan cache did not fuse: {st}")
            run["expand_path"] = [r.extra.get("path") for r in recs if r.stage == "join:expand"]
        out["runs"][leg] = run
        log(f"{what} [{leg}]: {result.nrows:,} rows == oracle; customers partitioned, products "
            f"broadcast ({probes[0]}), "
            f"capacity {run['capacity']}, retries {run['retries']}, hot keys {run['hot_keys']}, "
            f"rows broadcast {run['rows_broadcast']}, host-sync elements {syncs}, assemblies 0; cold "
            f"{cold:.3f}s, warm {run['warm_s']:.3f}s (median of {reps}); peak "
            f"{run['peak_gib']} GiB | {card}")
        del result
    out["launches"] = M.launches  # no filter on this leg
    log(f"{what}: ingest {t_ingest:.2f}s onto {mesh.size} shards (stored "
        f"{table.stored_len:,}: padded) | {card}")
    return out


# -- phase 16: the analysis suite on the card ---------------------------------

ANALYSIS_SNAPSHOT = Path("tests") / "data" / "analyze_snapshot_torch.json"
ENV_DOC = Path("docs") / "ENV_TORCH.md"


def analysis_check(src, placement: str, warm_s: float, what: str, card: str,
                   reps: int = 3) -> dict:
    """Phase 16 (b): ``plan_analysis_json`` and ``explain_text`` of a plan
    the path already ran, at its full size.  The verdict must be ``ok``,
    each scan's estimated rows its table's row count, and the rows'
    placement *placement*.  Prints the explain text and the analysis's
    own milliseconds (median of *reps*) beside the plan's warm join."""
    from csvplus_tpu_torch import plan as P
    from csvplus_tpu_torch.analysis.report import explain_text, plan_analysis_json

    root = src.plan
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        d = plan_analysis_json(root)
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    t0 = time.perf_counter()
    text = explain_text(what, root)
    explain_ms = (time.perf_counter() - t0) * 1e3
    cost = {row["stage"]: row for row in d["cost"]}
    scans = [(P.stage_label(i, n), n.table.nrows) for i, n in enumerate(P.linearize(root))
             if isinstance(n, P.Scan)]
    got_placement = d["row_placement"].split("(")[0]
    if not d["ok"] or not scans or got_placement != placement or any(
            cost[label]["rows"] != nrows for label, nrows in scans):
        raise AssertionError(
            f"{what}: verdict ok={d['ok']}, rows@{d['row_placement']} (want {placement}), "
            f"scans {[(label, nrows, cost[label]['rows']) for label, nrows in scans]}\n{text}")
    log(f"{what}: explain\n{text}")
    log(f"{what}: verdict ok, rows@{d['row_placement']}, scans "
        f"{[(label, nrows) for label, nrows in scans]} estimated at their row counts; "
        f"plan_analysis_json {ms:.2f} ms (median of {reps}), explain_text {explain_ms:.2f} ms, "
        f"beside the plan's warm join {warm_s * 1e3:.2f} ms | {card}")
    return {"ok": d["ok"], "row_placement": d["row_placement"], "scans": scans,
            "analysis_ms": ms, "explain_ms": explain_ms, "join_warm_ms": warm_s * 1e3,
            "rewrite": d["rewrite"].get("applied")}


def run_analysis_path(device: str, root: Path, card: str) -> dict:
    """Phase 16 (a) and (c): the analysis payload made on *device* against
    the committed snapshot (made on the CPU); then each example plan the
    payload analyzed, run on *device* and on the CPU with equal positional
    checksums (its filters launch the mask kernel; the payload executes
    only ``plan_cert``'s rewritten plans, none of which filters at n = 2),
    every mask launch replayed bitwise; then three CLI commands, started
    together in subprocesses."""
    from csvplus_tpu_torch.analysis.report import example_plans, json_payload
    from csvplus_tpu_torch.columnar.exec import execute_plan_view
    from csvplus_tpu_torch.obs.joinskew import joinskew
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    def run_plans(dev: str) -> dict:
        out = {}
        for name, plan in sorted(example_plans(dev).items()):
            table = execute_plan_view(plan).materialize()
            out[name] = (table.nrows, checksum_device_table(table, positional=True))
        return out

    t_phase = time.perf_counter()
    want = json.loads((root / ANALYSIS_SNAPSHOT).read_text(encoding="utf-8"))
    # the earlier phases' joins filled the process-wide build-side sketches,
    # which certify reads (as the reference's does): reset them first
    joinskew.reset()
    with recorded_mask_calls() as calls:
        M.launches = 0  # the path's run starts here
        t0 = time.perf_counter()
        got = json_payload(device=device)
        secs = time.perf_counter() - t0
        payload_launches = M.launches
        t0 = time.perf_counter()
        ran = run_plans(device)
        run_s = time.perf_counter() - t0
        launches = M.launches  # ... and ends here
    want_ran = run_plans("cpu")
    if ran != want_ran:
        raise AssertionError(f"phase 16 (a): the example plans on {device} {ran} != on the "
                             f"CPU {want_ran}")
    for half in ("plans", "plan_cert"):
        if got[half] != want[half]:
            raise AssertionError(f"phase 16 (a): the payload's {half!r} on {device} differs "
                                 f"from {ANALYSIS_SNAPSHOT}")
    if got["lint"]:
        raise AssertionError(f"phase 16 (a): lint findings {got['lint']}")
    if device == "cuda" and launches <= 0:
        raise AssertionError("phase 16 (a): the example plans never launched the mask kernel")
    log(f"phase 16 (a): json_payload(device={device!r}) in {secs:.2f}s: plans "
        f"{sorted(got['plans'])} and plan_cert {json.dumps(got['plan_cert'])} == "
        f"{ANALYSIS_SNAPSHOT} (made on the CPU); lint []; the example plans run on {device} "
        f"in {run_s:.2f}s == on the CPU (rows, positional checksums): "
        f"{ {k: v[0] for k, v in ran.items()} }; mask kernel launches {payload_launches} in "
        f"the payload, {launches} in all | {card}")
    out = {"payload_s": secs, "plans_run_s": run_s, "payload_launches": payload_launches,
           "launches": launches,
           "mask_check": check_path_masks(calls, "phase 16 (a) analysis payload")}

    # (c) the CLI, three commands at once
    env = dict(os.environ, PYTHONPATH=str(root))
    cmds = {
        "lint": ["lint", "--json"],
        "env": ["env"],
        "plan-cert": ["plan-cert", "--device", device, "--json"],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "csvplus_tpu_torch.analysis", *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in cmds.items()}
    res = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            res[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_s = time.perf_counter() - t0
    rc, stdout, stderr = res["lint"]
    if rc != 0 or json.loads(stdout) != []:
        raise AssertionError(f"phase 16 (c): lint --json exited {rc}: {stdout}{stderr}")
    rc, stdout, stderr = res["env"]
    if rc != 0 or stdout != (root / ENV_DOC).read_text(encoding="utf-8"):
        raise AssertionError(f"phase 16 (c): env exited {rc} or differs from {ENV_DOC}: "
                             f"{stderr}")
    rc, stdout, stderr = res["plan-cert"]
    if rc != 0 or not json.loads(stdout)["ok"]:
        raise AssertionError(f"phase 16 (c): plan-cert --device {device} exited {rc}: "
                             f"{stdout}{stderr}")
    out["plan_cert_cli"] = json.loads(stdout)
    out["cli_s"] = cli_s
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 (c): `lint --json` printed [] and exited 0; `env` printed {ENV_DOC} "
        f"exactly; `plan-cert --device {device} --json` exited 0 "
        f"({out['plan_cert_cli']['plans_total']} plans); the three together "
        f"{cli_s:.1f}s; phase 16 (a) + (c) {out['seconds']:.1f}s | {card}")
    return out


# -- phase 17: the chaos gate on the state the earlier phases built ----------

CHAOS_PATH = "phase 17 chaos gate"
CHAOS_SERVE_PROBES = 20_000  # through (s1)'s server, 1 in 17 a miss
CHAOS_PENDING = 256  # requests pending at the dispatcher crash
CHAOS_CHUNK_BYTES = 8 << 20  # ~30 chunks of phase 4's 236 MB file
CHAOS_WORKERS = (1, 2, 4)
CHAOS_READ_WORKERS = (1, 4)
CHAOS_WAL_BASE_ROWS = 100_000


def run_chaos_path(state: dict, device: str, card: str, *,
                   serve_probes: int = CHAOS_SERVE_PROBES,
                   clients: int = N_SERVE_CLIENTS, pending: int = CHAOS_PENDING,
                   chunk_bytes: int = CHAOS_CHUNK_BYTES, shards: int = C5_SHARDS,
                   wal_base_rows: int = CHAOS_WAL_BASE_ROWS,
                   workdir: "Path | None" = None) -> dict:
    """Phase 17: the chaos gate (``csvplus_tpu_torch.resilience.chaos``),
    its ten cases on what phases 4, 9, 12 and 13 left in *state*.
    (s1)'s 1M-row index serves ``serve_retry`` (*serve_probes* probes
    from *clients* closed-loop clients, and one (s2) plan with phase 9's
    filter retried past an ``exec:device`` fault), ``serve_degrade`` (and
    its leg over the mirror cap on (s2)'s 50M ``order_id`` index),
    ``dispatcher_crash`` (*pending* requests) and ``disarmed_overhead``;
    phase 4's 10M-order file is streamed in *chunk_bytes* chunks by the
    ingest cases (placed tables: the device-parse tier, then K in
    ``CHAOS_WORKERS``; checksums also against phase 4's numpy oracle) and
    joined to its customers and products on *shards* shards of *device*
    by the mesh case; phase 12's durable index crashes its compactor
    under a server; the eight WAL crash children, started together,
    build *wal_base_rows*-row bases on *device*; ``view_refresh_crash`` ran
    inside phase 13.  Each case's record carries its seconds, its device
    memory readings and its kernel replay.  Prints a line per case and a
    summary line; any failed case raises."""
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P
    from csvplus_tpu_torch.ops.join import DeviceIndex
    from csvplus_tpu_torch.resilience import chaos as G

    t_phase = time.perf_counter()
    data = state["orders"]
    paths = {k: str(v) for k, v in data["paths"].items()}
    s1_idx, s1_ids = state["s1"]
    s2 = state["s2"]
    storage = state["storage"]
    want_sums = ingest_oracle(data)
    root = Path(tempfile.mkdtemp(prefix="chaos-", dir=workdir))
    runs = {
        "serve_retry": lambda: G.case_serve_retry(
            s1_idx, s1_ids, device=device, n_probes=serve_probes, clients=clients,
            plan=s2["plan"], audit=True),
        "serve_degrade": lambda: G.case_serve_degrade(
            s1_idx, s1_ids, device=device, above_cap=(s2["order_idx"], s2["order_probes"]),
            audit=True),
        "dispatcher_crash": lambda: G.case_dispatcher_crash(
            s1_idx, s1_ids, device=device, n_requests=pending),
        "ingest_crash_recovery": lambda: G.case_ingest_crash_recovery(
            str(root), device=device, path=paths["orders"], chunk_bytes=chunk_bytes,
            workers=CHAOS_WORKERS, placed=True, want_sums=want_sums, audit=True),
        "ingest_read_fault_typed": lambda: G.case_ingest_read_fault_typed(
            str(root), device=device, path=paths["orders"], chunk_bytes=chunk_bytes,
            workers=CHAOS_READ_WORKERS, placed=True, audit=True),
        "mesh_join_under_ingest_faults": lambda: G.case_mesh_join_under_ingest_faults(
            str(root), device=device, shards=shards, orders=paths["orders"],
            customers=paths["cust"], products=paths["prod"], chunk_bytes=chunk_bytes,
            audit=True),
        "storage_compact_crash": lambda: G.case_storage_compact_crash(
            device=device, mi=storage["mi"], key="cust_id", probes=storage["probes"],
            serve=True, audit=True),
        "wal_crash_matrix": lambda: G.case_wal_crash_matrix(
            str(root), device=device, base_rows=wal_base_rows, audit=True),
        "disarmed_overhead": lambda: G.case_disarmed_overhead(s1_idx, s1_ids, device=device),
    }
    old_cap = DeviceIndex.POINT_MIRROR_MAX_KEYS
    if s2["cap"] is not None:
        DeviceIndex.POINT_MIRROR_MAX_KEYS = s2["cap"]  # the CPU rehearsal's small tables
    cases = {}
    M.launches = P.launches = 0  # the gate's run starts here
    try:
        for name in G.CASES:
            cases[name] = state["view"] if name == "view_refresh_crash" else \
                G.with_timeout(name, runs[name], log=log)
        total = {"mask": M.launches, "pack": P.launches}  # ... and ends here
    finally:
        DeviceIndex.POINT_MIRROR_MAX_KEYS = old_cap
        storage["mi"].close()
        shutil.rmtree(root, ignore_errors=True)
    launches = {"mask": 0, "pack": 0}
    replayed = {"mask": 0, "pack": 0}
    worst = 0
    for name, rec in cases.items():
        checks = rec.get("device_checks", {})
        mem = checks.get("memory")
        kr = checks.get("kernel_replay")
        if kr is not None and name != "view_refresh_crash":  # phase 13 counted its own
            for k in launches:
                launches[k] += kr["launches"][k]
                replayed[k] += kr["replayed"][k]
            worst = max(worst, kr["max_abs_err"])
        log(f"phase 17 {name}: {'ok' if rec.get('ok') else 'FAIL ' + str(rec.get('error'))} "
            f"in {rec.get('seconds')}s; device memory allocated after the fault-free run "
            f"{None if mem is None else mem['allocated_after_oracle']}, after the faulted run "
            f"{None if mem is None else mem['allocated_after_faulted']}; kernel launches "
            f"{None if kr is None else kr['launches']}, replayed "
            f"{None if kr is None else kr['replayed']} | {card}")
    summary = G.summary(cases, device)
    out = {"summary": summary, "cases": cases, "launches": launches["mask"],
           "pack_launches": launches["pack"],
           "mask_check": {"cases": replayed["mask"], "max_abs_err": worst},
           "pack_check": {"cases": replayed["pack"], "max_abs_err": worst},
           "seconds": time.perf_counter() - t_phase}
    over = cases["disarmed_overhead"]
    log(f"phase 17 summary {json.dumps(summary)}; disarmed inject() {over.get('per_call_ns')} ns "
        f"a call, {over.get('per_request_us')} us a coalesced request (mean batch "
        f"{over.get('mean_batch')}), {over.get('isolated_rt_us')} us an isolated round trip: "
        f"{over.get('overhead_pct_coalesced')} % / {over.get('overhead_pct_isolated')} %; "
        f"kernel launches {launches} (all replayed bitwise: {replayed}); "
        f"{out['seconds']:.1f}s | {card}")
    if summary["failed"]:
        raise AssertionError(f"phase 17: chaos cases failed: {summary['failed']}")
    if device == "cuda":
        if launches["mask"] < 1 or launches["pack"] < 1:
            raise AssertionError(f"phase 17: the gate launched {launches}, not both kernels")
        if replayed["mask"] < launches["mask"] or replayed["pack"] != launches["pack"]:
            raise AssertionError(f"phase 17: {replayed} replayed for {launches} launches")
        # every launch in the phase is a case's (recorded) or a replay's
        if total["mask"] != launches["mask"] + replayed["mask"] or \
                total["pack"] != launches["pack"]:
            raise AssertionError(f"phase 17: {total} launches in all, {launches} by the "
                                 f"cases and {replayed} replays")
    return out


def kernels_line(mask: dict, pack: dict, paths: dict, streamed: dict, plancache: dict,
                 multidevice: dict) -> list:
    """The ``{"kernels": [...]}`` entries: each kernel's launches on this
    slice's path (phase 15: (a)'s 100M sharded pipelines for the mask,
    (c)'s device-parsed sharded ingest for the pack) and on every path by
    name, the worst error of its bitwise checks, and its timings at the
    matrix shape."""
    shape = mask["timings"][0]  # pipeline (a)'s shape: k = 2, "all", one target each
    return [{
        "name": "fused_equality_mask",
        "route": "cuda",
        "source": "csvplus_tpu_torch/csrc/mask.cu",
        "replaces": "csvplus_tpu/ops/pallas_mask.py:41",
        # the slice's path: config 5's pipelines on 8 shards, one launch
        # per shard per filter (phase 15 (a)); every other path is in
        # launches_by_path
        "launches": paths[C5_MAIN_PATH]["launches"],
        "launches_by_path": {
            **{name: p["launches"] for name, p in paths.items()},
            **{f"50M plan cache {leg}": v["launches"] for leg, v in plancache["legs"].items()},
            "50M except_": plancache["except"]["launches"],
            "phase 14 multi-device": multidevice["launches"]["mask"]},
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
        # phase 15 (c)'s device-parsed leg: one launch per column of the
        # sharded orders file
        "launches": paths[C5_PACK_PATH]["pack_launches"],
        "launches_by_path": {
            "10M device-parsed": paths["10M device-parsed"]["pack_launches"],
            "10M native-encoded": paths["10M native-encoded"]["pack_launches"],
            **{f"50M streamed {leg}": v["pack_launches"]
               for leg, v in streamed["ingest"].items()},
            **{name: paths[name]["pack_launches"] for name in (
                "14M lane dictionary", "13M host dictionary", "50M config 4 dedup",
                "10M config 1", C5_PACK_PATH, "phase 15 (c) 10M native-encoded, 7 shards",
                CHAOS_PATH)},
            "phase 14 multi-device": multidevice["launches"]["pack"]},
        "max_abs_err": max([pack["max_abs_err"]] + [p["pack_check"]["max_abs_err"]
                                                     for p in paths.values() if "pack_check" in p]),
        "ms": pack["timing"]["ms"],
        "plain_ms": pack["timing"]["plain_ms"],
        "bound_ms": pack["timing"]["bound_ms"],
        "bound_by": pack["timing"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "shape": f"m={pack['timing']['m']} lanes={pack['timing']['lanes']}",
    }]


def ptxas_summary(report: str) -> str:
    """One line from ``ptxas -v``'s report of ``csrc/mask.cu``: each
    instantiation's registers and spill bytes (stores / loads)."""
    import re

    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"ILi(\d+)ELb([01])E", m.group(1))
            name = f"k={k.group(1)} {'all' if k.group(2) == '1' else 'any'}" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, spill {spill} B")
            name = None
    return "; ".join(out)


def build_kernels(here: Path) -> None:
    """Phase 2: nvcc builds ``csrc/mask.cu`` and ``csrc/parse.cu`` and g++
    the native scanner, all three started together; prints the seconds
    and ``ptxas -v``'s registers and spills for the mask kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from csvplus_tpu_torch.native import scanner as S
    from csvplus_tpu_torch.ops import cubuild
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.ops import parse as P

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # both nvcc and g++ together
        builds = [pool.submit(M.build), pool.submit(P.build), pool.submit(S.build)]
        mask_lib = builds[0].result()
        for f in builds[1:]:
            f.result()
    log(f"built {M.SOURCE.relative_to(here)} and {P.SOURCE.relative_to(here)} for sm_90a "
        f"(nvcc) and {S.SOURCE.relative_to(here)} (g++) in {time.perf_counter() - t0:.2f}s")
    log(f"ptxas -v, {M.SOURCE.relative_to(here)} (THREADS 256, shared memory dynamic): "
        + ptxas_summary(cubuild.ptxas_report(mask_lib)))


def _prune(workdir: Path, keep) -> None:
    """Remove everything in *workdir* but the paths in *keep*."""
    keep = {Path(p).resolve() for p in keep}
    for entry in workdir.iterdir():
        if entry.resolve() in keep:
            continue
        if entry.is_dir():
            shutil.rmtree(entry, ignore_errors=True)
        else:
            entry.unlink()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20160914)
    ap.add_argument("--f4", action="store_true",
                    help="add phase 12's probe of why readers slow the merge (~70 s)")
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

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log(f"host CPUs: {os.cpu_count()}")
    build_kernels(here)

    mask = check_mask_kernel(args.seed)
    pack = check_pack_kernel(args.seed)

    workdir = here / ".chip_smoke_data"
    workdir.mkdir(exist_ok=True)
    xla = {}  # phase 14's calls of the ported jitted functions
    state = {}  # what phase 17 runs on: phases 4, 9, 12 and 13 leave it here
    try:
        main_path = run_main_path(N_ORDERS, args.seed, "cuda", workdir, args.profile,
                                  stats=xla, card=smi, keep=state)
        streamed = run_streamed_path(N_ORDERS_STREAMED, args.seed, "cuda", workdir,
                                     serve={"keep": state})
        lane = run_lane_path(N_LANE_ROWS, N_PROBE_REFS, args.seed, "cuda", workdir)
        host_dict = run_host_dict_path(N_HOST_DICT_ROWS, args.seed, "cuda", workdir)
        dedup = run_dedup_path(N_DEDUP_ROWS, N_DEDUP_DISTINCT, args.seed, "cuda", workdir)
        config1 = run_config1_path(N_PEOPLE, args.seed, "cuda", workdir)
        storage = run_storage_path(N_SERVE_ROWS, args.seed, "cuda", workdir, f4=args.f4,
                                   keep=state)
        views = run_views_path(VIEW_ROWS, args.seed, "cuda", workdir)
        state["view"] = views["chaos_view"]
        log(f"phase 13's numbers above: {kind} | nvidia-smi: {smi}")
        plancert = run_plancert_path(3, "cuda")
        stage_diff = check_stage_diff(main_path)
        # phase 17 needs phase 4's files and phase 12's index directory
        _prune(workdir, keep=[*state["orders"]["paths"].values(), workdir / "mutable"])
        multidevice = run_multidevice_path(args.seed, "cuda", xla, smi)
        log(f"phase 15 (d): dryrun_multichip ran paths "
            f"{[p.split()[0] for p in multidevice['d_dryrun']['paths']]} (every path) | {smi}")
        gc.collect()
        torch.cuda.empty_cache()
        c5_dir = workdir / "config5"
        c5_dir.mkdir()
        try:
            config5 = run_config5_path(args.seed, "cuda", c5_dir, smi)
        finally:
            shutil.rmtree(c5_dir, ignore_errors=True)
        analysis = run_analysis_path("cuda", here, smi)
        chaos_path = run_chaos_path(state, "cuda", smi, workdir=workdir)
        del state
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    xla_table = xla_rows(xla)
    for row in xla_table:
        log(f"phase 14 torch port of {row['replaces']}: {row['name']} x{row['launches']}, "
            + (f"{row['ms']:.3f} ms at its largest shape ({row['bytes']:,} bytes, byte bound "
               f"{row['bound_ms']:.3f} ms)" if row["ms"] is not None else "not called")
            + f" | {smi}")
    plancache = streamed.pop("plancache")
    serving = streamed.pop("serving")
    legs = main_path["legs"]
    paths = {"10M device-parsed": legs["device-parsed"],
             "10M native-encoded": legs["native-encoded"], "50M streamed": streamed,
             "50M plan cache": plancache, "serving": serving,
             "14M lane dictionary": lane, "13M host dictionary": host_dict,
             "50M config 4 dedup": dedup, "10M config 1": config1, "1M views": views,
             "plancert": plancert, "phase 16 analysis": analysis, CHAOS_PATH: chaos_path}
    path_cases = sum(p["mask_check"]["cases"] for p in paths.values())
    log(f"mask kernel == plain version, bitwise, in {mask['cases']} matrix cases and "
        f"{path_cases} calls at the paths' own shapes")
    pack_paths = [p["pack_check"] for p in paths.values() if "pack_check" in p]
    log(f"pack kernel == plain version, bitwise, in {len(pack['cases'])} matrix cases and "
        f"{sum(c['cases'] for c in pack_paths)} launches at the paths' own shapes")

    for leg in legs:
        paths[f"phase 15 (c) 10M {leg}, 7 shards"] = legs[leg]["sharded"]
    paths[C5_MAIN_PATH] = config5
    kernels = kernels_line(mask, pack, paths, streamed, plancache, multidevice)
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
    log("views path phases " + json.dumps(views))
    log("plancert path phases " + json.dumps(plancert))
    log("obs stage diff " + json.dumps(stage_diff))
    log("phase 14 multi-device path " + json.dumps(multidevice))
    log("phase 14 ported jitted functions " + json.dumps(xla_table))
    log("phase 15 config 5 path " + json.dumps(config5))
    log("phase 16 analysis path " + json.dumps(analysis))
    log("phase 17 chaos path " + json.dumps(chaos_path, default=str))
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
