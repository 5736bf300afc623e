"""Entry points: the flagship step and a multi-device dry run.

Port of the repository's ``__graft_entry__.py``.

``entry(device)`` exposes the flagship fused 3-way-join probe step (the
hot step of BASELINE.json configs 3 and 5) with example args on *device*.

``dryrun_multichip(n, devices=None)`` drives the multi-device paths over
an ``n``-shard mesh (``cuda:0`` .. ``cuda:n-1`` unless *devices* places
the shards, e.g. ``["cuda:0"] * 8`` or ``["cpu"] * 8``) and checks each
against a numpy oracle:

1. data-parallel fused step: :func:`~.models.flagship.threeway_step` on
   every shard of a row-sharded stream over replicated keys;
2. the broadcast probe over the mesh;
3. the partitioned all-to-all probe (3b: the sample sort; 3c: the
   capacity retry and the hot-key short circuit, with the reference's
   bounds on the counted host syncs);
4. the public API over a row-sharded table: ``from_file(...).on_device(
   mesh=...)``, a filter, and a select + join against an index;
5. on a (2, n/2) mesh: the data-parallel step, a hierarchical count
   (a sum within each slice, then across slices), a filter pipeline over
   a table sharded on both axes, the partitioned probe and the sample
   sort.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def entry(device: str = "cuda"):
    """(the flagship forward step, example args on *device*)."""
    from .models.flagship import example_step_args, threeway_step

    return threeway_step, example_step_args(device=device)


def _dp_step(mesh, keys_c, keys_p, qk_c, qk_p):
    """The fused step on every shard: replicated keys, row-sharded probes.
    Returns the valid mask and the customer row ids on the host."""
    from .models.flagship import threeway_step
    from .parallel.mesh import replicate, shard_rows

    kc, kp = replicate(mesh, keys_c), replicate(mesh, keys_p)
    qc, qp = shard_rows(mesh, qk_c), shard_rows(mesh, qk_p)
    lo_c, valid = [], []
    for i in range(mesh.size):
        with mesh.on(i):
            a, _, v = threeway_step(kc[i], kp[i], qc.shards[i], qp.shards[i])
        lo_c.append(a.cpu().numpy())
        valid.append(v.cpu().numpy())
    return np.concatenate(valid), np.concatenate(lo_c)


def _probe_oracle(index_keys: np.ndarray, queries: np.ndarray):
    lo = np.searchsorted(index_keys, queries, side="left")
    ct = np.searchsorted(index_keys, queries, side="right") - lo
    ct[queries < 0] = 0
    return lo, ct


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run paths 1, 2, 3, 3b, 3c, 4 and (for an even n >= 4) 5 on an
    *n_devices*-shard mesh; raise on any mismatch.  Returns the paths run
    and path 3c's counted host syncs."""
    import torch

    from .parallel.dsort import distributed_sort
    from .parallel.mesh import (AXIS, SLICE_AXIS, make_mesh, make_mesh_2d, psum, replicate,
                                shard_rows)
    from .parallel.pjoin import broadcast_probe, partitioned_probe
    from .utils.observe import telemetry

    mesh = make_mesh(n_devices, devices=devices)
    n_orders = 16 * n_devices
    rng = np.random.default_rng(7)
    ran = []

    # --- path 1: data-parallel fused 3-way probe (row-sharded stream) ----
    cust_keys = np.arange(40, dtype=np.int32)
    prod_keys = np.arange(8, dtype=np.int32)
    qk_c_np = rng.integers(-2, 45, size=n_orders).astype(np.int32)
    qk_p_np = rng.integers(-1, 10, size=n_orders).astype(np.int32)
    valid, lo_c = _dp_step(mesh, cust_keys, prod_keys, qk_c_np, qk_p_np)
    want_valid = (qk_c_np >= 0) & (qk_c_np < 40) & (qk_p_np >= 0) & (qk_p_np < 8)
    if not (valid == want_valid).all():
        raise AssertionError("dp fused step mismatch")
    if not (lo_c[want_valid] == qk_c_np[want_valid]).all():
        raise AssertionError("dp fused step row ids mismatch")
    ran.append("1 dp fused step")

    # --- path 2: broadcast probe over the mesh ----------------------------
    _, bct = broadcast_probe(replicate(mesh, cust_keys), shard_rows(mesh, qk_c_np))
    if not (bct.numpy() == ((qk_c_np >= 0) & (qk_c_np < 40)).astype(np.int32)).all():
        raise AssertionError("broadcast probe mismatch")
    ran.append("2 broadcast probe")

    # --- path 3: partitioned all-to-all lookup join ------------------------
    index_keys = np.sort(rng.integers(0, 50, size=400).astype(np.int32))
    queries = rng.integers(-3, 60, size=n_orders).astype(np.int32)
    queries[queries < 0] = -1
    lo, ct = partitioned_probe(mesh, queries, index_keys)
    olo, oct_ = _probe_oracle(index_keys, queries)
    if not (ct == oct_).all() or not (lo[ct > 0] == olo[ct > 0]).all():
        raise AssertionError("all_to_all partitioned probe mismatch")
    ran.append("3 partitioned probe")

    # --- path 3b: the distributed sample sort -----------------------------
    xs = rng.integers(0, 300, size=1024).astype(np.int32)
    vals, perm = distributed_sort(mesh, xs)
    if not (vals == np.sort(xs)).all() or not (xs[perm] == vals).all():
        raise AssertionError("distributed sample-sort mismatch")
    ran.append("3b sample sort")

    # --- path 3c: capacity retry + hot-key short circuit ------------------
    # every source shard routes ALL its probes into shard 0's key range
    # with a tiny capacity: the overflow retry must fire
    skew_keys = np.arange(0, 100 * n_devices, dtype=np.int32)
    skew_q = (np.arange(64 * n_devices, dtype=np.int32) % 64).astype(np.int32)
    with telemetry.collect():
        lo, ct = partitioned_probe(mesh, skew_q, skew_keys, capacity=8)
        retry_syncs = telemetry.host_sync_elements
    sample = skew_q.size if skew_q.size >= 4 * n_devices else 0
    if retry_syncs < sample + 2:
        raise AssertionError(f"capacity retry never fired ({retry_syncs})")
    if not ((ct == 1).all() and (lo == skew_q).all()):
        raise AssertionError("retry probe mismatch")
    # a 30 %-heavy probe key: the hot-key short circuit absorbs it in ONE
    # attempt (the sample, then the overflow flag and hit count together)
    hot_q = rng.integers(0, 100 * n_devices, size=8192).astype(np.int32)
    hot_q[rng.random(8192) < 0.3] = np.int32(17)
    with telemetry.collect():
        lo, ct = partitioned_probe(mesh, hot_q, skew_keys)
        hot_syncs = telemetry.host_sync_elements
    if hot_syncs > 4096 + 2:
        raise AssertionError(f"hot-key shortcut did not absorb the skew ({hot_syncs})")
    if not ((ct == 1).all() and (lo == hot_q).all()):
        raise AssertionError("hot probe mismatch")
    ran.append("3c capacity retry + hot-key shortcut")

    # --- path 4: the public API over a row-sharded table -------------------
    import csv
    import tempfile

    from . import Like, from_file, take

    dev0 = str(mesh.devices[0])
    with tempfile.TemporaryDirectory() as td:
        pp = f"{td}/people.csv"
        with open(pp, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "name", "qty"])
            for i in range(64):
                w.writerow([str(i), f"n{i % 5}", str(i % 9)])
        host = take(from_file(pp)).filter(Like({"name": "n2"})).to_rows()
        got = from_file(pp).on_device(mesh=mesh).filter(Like({"name": "n2"})).to_rows()
        if got != host:
            raise AssertionError("sharded end-to-end pipeline mismatch")
        idx = from_file(pp).on_device(dev0).unique_index_on("id")
        joined = (from_file(pp).on_device(mesh=mesh).select_columns("id", "qty")
                  .join(idx, "id").to_rows())
        if len(joined) != 64:
            raise AssertionError("sharded join mismatch")
    ran.append("4 sharded pipeline (filter, select + join)")

    # --- path 5: 2-D (slice, chip) mesh -----------------------------------
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2 = make_mesh_2d(2, n_devices // 2, devices=devices)
        valid2, _ = _dp_step(mesh2, cust_keys, prod_keys, qk_c_np, qk_p_np)
        if not (valid2 == want_valid).all():
            raise AssertionError("2-D dp step mismatch")
        # hierarchical count: a sum within each slice, then across slices
        blocks = shard_rows(mesh2, want_valid)
        local = [b.to(torch.int32).sum() for b in blocks.shards]
        total = psum(mesh2, psum(mesh2, local, AXIS), SLICE_AXIS)
        if any(int(t.item()) != int(want_valid.sum()) for t in total):
            raise AssertionError("hierarchical sum mismatch")
        # the public API over a table sharded slice-major on both axes
        with tempfile.TemporaryDirectory() as td:
            pp = f"{td}/p2.csv"
            with open(pp, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["id", "name"])
                for i in range(48):
                    w.writerow([str(i), f"n{i % 3}"])
            host2 = take(from_file(pp)).filter(Like({"name": "n1"})).to_rows()
            got2 = from_file(pp).on_device(mesh=mesh2).filter(Like({"name": "n1"})).to_rows()
            if got2 != host2:
                raise AssertionError("2-D-mesh sharded pipeline mismatch")
        # the partitioned probe and the sample sort over (slice, chip):
        # their exchanges span both axes
        ik2 = np.sort(rng.integers(0, 5000, size=2000).astype(np.int32))
        q2 = rng.integers(-3, 6000, size=32 * n_devices).astype(np.int32)
        q2[q2 < 0] = -1
        lo2, ct2 = partitioned_probe(mesh2, q2, ik2)
        o_lo, o_ct = _probe_oracle(ik2, q2)
        if not (ct2 == o_ct).all() or not (lo2[ct2 > 0] == o_lo[ct2 > 0]).all():
            raise AssertionError("2-D partitioned probe mismatch")
        xs2 = rng.integers(0, 999, size=1024).astype(np.int32)
        v2, p2 = distributed_sort(mesh2, xs2)
        if not (v2 == np.sort(xs2)).all() or not (xs2[p2] == v2).all():
            raise AssertionError("2-D sample-sort mismatch")
        ran.append(f"5 2-D (2,{n_devices // 2}) mesh: dp step + slice/chip sum + "
                   "sharded pipeline + partitioned probe + sample sort")

    where = sorted({str(d) for d in mesh.devices})
    print(f"dryrun_multichip OK on {n_devices} shards over {where}: paths "
          + "; ".join(ran))
    return {"paths": ran, "retry_syncs": retry_syncs, "hot_syncs": hot_syncs}
