"""``filter_join``: a query that filters the fact table and joins it
with the built indexes, ``fact.filter(pred).join(index, *columns)...``
for the traffic's ``joins``, ending in ``to_device_table()``.  It reads
every row of the fact table.  A query's predicate is drawn from the
traffic's ``filter`` spec afresh for each unit (no repeat within a run,
warm-up included), so no result cache and no cached mask table serves a
repeat."""

from __future__ import annotations

import json

import numpy as np

from portbench.check import reading
from portbench.reference.predicate import evaluate
from portbench.units import Unit as Base
from portbench.units import draw_predicate, no_span, spec_columns, to_program


class Unit(Base):
    KEYS = frozenset({"filter", "joins"})

    def __init__(self, env):
        super().__init__(env)
        t = env.traffic
        self.spec, self.joins = t["filter"], t["joins"]
        self._seen: set = set()
        self.n = env.data["n"]

    def draw(self, i: int, stream: int = 0) -> list:
        for attempt in range(1000):
            rng = np.random.default_rng([self.env.seed, 1 + stream, i, attempt])
            pred = draw_predicate(self.spec, self.env.config["domains"], rng)
            key = json.dumps(pred)
            if key not in self._seen:
                self._seen.add(key)
                return pred
        raise RuntimeError("no fresh predicate left in the drawn space")

    def run(self, pred: list, span=no_span):
        e = self.env
        src = e.fact.filter(to_program(pred, e.T))
        for name, *columns in self.joins:
            src = src.join(e.indexes[name], *columns)
        return src.to_device_table()

    def rows(self, pred: list) -> int:
        return self.n

    def facts(self) -> dict:
        return {"filter_columns": len(spec_columns(self.spec))}

    def counters(self) -> dict:
        from csvplus_tpu_torch.ops import mask

        return {"mask_launches": mask.launches}

    @staticmethod
    def output_table(out):
        return out

    def expected(self, pred: list) -> dict:
        e = self.env
        fact = e.config["fact"]
        keep = evaluate(pred, lambda c: e.ref.column_cells(e.data, fact, c), self.n)
        return e.ref.expected_filter_join(e.data, keep)

    def control(self, pred: list) -> dict:
        """The control: the reference's own result, put in the program's
        place with the stream order broken (its rows grouped by the first
        join's key, as a hash join would emit them), as readings in the
        check's terms."""
        want = self.expected(pred)
        key = self.joins[0][1] if len(self.joins[0]) > 1 else next(iter(want))
        order = np.argsort(want[key].ints, kind="stable")
        return {name: reading(col.take(order)) for name, col in want.items()}
