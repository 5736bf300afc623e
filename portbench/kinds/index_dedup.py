"""``index_dedup``: a job that indexes the resident fact table on the
traffic's ``key`` and resolves its duplicates by the traffic's
``policy``: ``fact.index_on(*key)`` then ``resolve_duplicates(policy)``.

Every job indexes the same resident table.  A lane dictionary that
streamed ingest left unsorted is sorted once, by the first job (set-up's
first warm-up unit), on the column's shared state; the ``lane_sorts``
counter shows where that sort ran."""

from __future__ import annotations

from portbench.units import Unit as Base
from portbench.units import no_span


class Unit(Base):
    KEYS = frozenset({"key", "policy"})

    def __init__(self, env):
        super().__init__(env)
        self.key = env.traffic["key"]
        self.policy = env.traffic["policy"]
        self._expected = None

    def run(self, _drawn, span=no_span, policy: "str | None" = None):
        with span("index_on"):
            idx = self.env.fact.index_on(*self.key)
        with span("resolve_duplicates"):
            idx.resolve_duplicates(policy or self.policy)
        return idx.sync()

    def rows(self, _drawn) -> int:
        return self.env.data["n"]

    def counters(self) -> dict:
        from csvplus_tpu_torch.columnar.table import lane_sorts

        return {"lane_sorts": len(lane_sorts)}

    @staticmethod
    def output_table(idx):
        return idx.device_table.table if idx.device_table is not None else None

    def expected(self, _drawn) -> dict:
        """The same for every job: worked out once."""
        if self._expected is None:
            self._expected = self.env.ref.expected_index_dedup(self.env.data, self.key,
                                                               self.policy)
        return self._expected

    def control(self, _drawn):
        """The control: the program's own other policy (``"last"`` for
        ``"first"``), whose index is judged against this one's
        reference."""
        other = {"first": "last", "last": "first"}[self.policy]
        return self.run(None, policy=other)
