"""``sharded_join``: :mod:`.filter_join`'s query over the fact table
row-sharded over ``shards`` devices, ``fact.filter(pred).join(index,
*columns)...`` for the traffic's ``joins``, ending in
``to_device_table()``, whose result stays sharded on the devices.

Set-up re-lays the harness's resident fact table over the mesh device to
device through the program's public ``DataSource.reshard`` (the path
``on_device(shards=...)`` takes for a resident source; a program without
it stops here, in set-up) and drops the unsharded table.  The mesh is
``cuda:0`` .. ``cuda:k-1`` on the card, ``k`` times ``cpu`` on the CPU
(tests).  Set-up logs which cards reach each other directly and each
card's resident bytes; the check logs each card's peak since the window
opened.

A unit synchronises every device of the mesh before it returns (the
harness waits on the current card only), and reads what the program
counted while it ran: the tier each join's probe took, the hot keys the
partitioned tier broadcast and the bytes copied between cards.  A unit
counts as shown (``units_shown``) when its first join took the
partitioned tier with at least one hot key broadcast, its second the
replicated tier, and, over distinct cards, bytes moved between them.
The output is assembled onto one device only for the check.
"""

from __future__ import annotations

import gc
import time

from portbench.harness import log
from portbench.kinds.filter_join import Unit as FilterJoin
from portbench.units import no_span


class Unit(FilterJoin):
    KEYS = FilterJoin.KEYS | {"shards"}

    def __init__(self, env):
        super().__init__(env)
        import torch

        from csvplus_tpu_torch.parallel.mesh import make_mesh, peer_copies

        k = int(env.traffic["shards"])
        resident = env.fact
        on_card = resident.plan.table.device.type == "cuda"
        self.mesh = make_mesh(k) if on_card else make_mesh(k, devices=["cpu"] * k)
        self.cards = [d for d in self.mesh.distinct_devices if d.type == "cuda"]
        if len(self.cards) > 1:
            log("set-up: peer access " + ", ".join(
                f"{a.index}->{b.index} {torch.cuda.can_device_access_peer(a, b)}"
                for a in self.cards for b in self.cards if a != b))
        t0, b0 = time.perf_counter(), peer_copies["bytes"]
        sharded = resident.reshard(mesh=self.mesh)
        sharded.plan.table.sync()
        log(f"set-up: re-laid {self.n} {env.config['fact']} rows over {self.mesh} in "
            f"{time.perf_counter() - t0:.2f} s, {peer_copies['bytes'] - b0} bytes between "
            f"cards; shard rows {sharded.plan.table.shard_lens()}")
        env.sources[env.config["fact"]] = sharded
        resident = None
        gc.collect()
        if self.cards:
            torch.cuda.empty_cache()
        log("set-up: resident bytes per card " + self._per_card(torch.cuda.memory_allocated))
        self._calls = 0
        self._shown = 0
        self._peaks_logged = False

    def _per_card(self, fn) -> str:
        return ", ".join(f"{d}: {fn(d)}" for d in self.cards) or "none (cpu)"

    def _readings(self) -> dict:
        """The program's counters a query adds to."""
        from csvplus_tpu_torch.obs.joinskew import joinskew
        from csvplus_tpu_torch.ops.join import probe_tiers
        from csvplus_tpu_torch.parallel.mesh import peer_copies

        skew = joinskew.counters_snapshot()
        return {"partitioned": probe_tiers["partitioned"] + probe_tiers["partitioned-wide"],
                "replicated": sum(v for t, v in probe_tiers.items() if t.startswith("replicated")),
                "hot_keys": sum(c.get("hot_keys_detected", 0) for c in skew.values()),
                "peer_bytes": peer_copies["bytes"]}

    def run(self, pred: list, span=no_span):
        self._calls += 1
        if self._calls == self.env.traffic.get("warmup", 1) + 1 and self.cards:
            import torch

            for d in self.cards:  # the first unit of the window
                torch.cuda.reset_peak_memory_stats(d)
        before = self._readings()
        out = super().run(pred, span).sync()
        got = {k: v - before[k] for k, v in self._readings().items()}
        if (got["partitioned"] >= 1 and got["hot_keys"] >= 1 and got["replicated"] >= 1
                and (got["peer_bytes"] > 0 or len(self.cards) < 2)):
            self._shown += 1
        return out

    def counters(self) -> dict:
        got = self._readings()
        return {**super().counters(), "partitioned_probes": got["partitioned"],
                "replicated_probes": got["replicated"], "hot_keys": got["hot_keys"],
                "peer_mb": got["peer_bytes"] / 1e6, "units_shown": self._shown}

    def output_table(self, out):
        """The sharded result assembled onto the mesh's first device."""
        from csvplus_tpu_torch.columnar.table import DeviceTable
        from csvplus_tpu_torch.parallel.mesh import assemble

        if not self._peaks_logged and self.cards:
            import torch

            self._peaks_logged = True
            log("check: device memory peak per card since the window opened "
                + self._per_card(torch.cuda.max_memory_allocated))
        cols = {n: c.with_storage(assemble(c.storage)) for n, c in out.columns.items()}
        return DeviceTable(cols, out.nrows, out.device)
