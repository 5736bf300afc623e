"""The general generator of a cell's units of work.

A traffic file (``portbench/traffic/<mix>.json``) is data: its ``unit``
names a unit kind, the module ``portbench/kinds/<unit>.py``, whose
``Unit`` class reads the file's other keys.  A kind reads only the keys
it lists (``KEYS``, beside the common ``unit``, ``warmup`` and
``check_sample``), and refuses any other, so a key that no code reads
never passes for a setting.  Every unit is drawn from the run's seed and
its own number, so a seed gives the same sequence of units whatever the
timing.

A filter is drawn from a spec over the configuration's ``domains``
(``{column: {"prefix", "low", "high", "width"}}``):

* ``{"like": [c1, c2, ...]}``: one ``Like`` over those columns, one value
  drawn for each;
* ``{"not": spec}``, ``{"any": [spec, ...]}``, ``{"all": [spec, ...]}``;
* inside ``any`` or ``all``, ``{"each": {"like": c, "count": k}}``: k
  single-column ``Like``s on k distinct drawn values of c.
"""

from __future__ import annotations

import importlib
import re
from contextlib import contextmanager

import numpy as np


def seed_word(seed: int) -> int:
    """Any whole-number seed as a nonnegative word numpy accepts."""
    return int(seed) % 2**64


def draw_predicate(spec: dict, domains: dict, rng) -> list:
    """One predicate (plain data, see :mod:`.reference.predicate`)."""

    def leaf(column: str, value: int) -> list:
        d = domains[column]
        return [column, d["prefix"], int(value), d.get("width", 0)]

    def value(column: str) -> int:
        d = domains[column]
        return int(rng.integers(d["low"], d["high"]))

    if "like" in spec:
        return ["like", [leaf(c, value(c)) for c in spec["like"]]]
    if "not" in spec:
        return ["not", draw_predicate(spec["not"], domains, rng)]
    for op in ("any", "all"):
        if op in spec:
            parts = []
            for sub in spec[op]:
                if "each" in sub:
                    col, k = sub["each"]["like"], sub["each"]["count"]
                    d = domains[col]
                    picks = rng.choice(np.arange(d["low"], d["high"]), k, replace=False)
                    parts += [["like", [leaf(col, v)]] for v in picks]
                else:
                    parts.append(draw_predicate(sub, domains, rng))
            return [op, parts]
    raise ValueError(f"unknown filter spec {spec!r}")


def spec_columns(spec: dict) -> set:
    """The columns a filter spec tests."""
    if "like" in spec:
        return set(spec["like"])
    if "each" in spec:
        return {spec["each"]["like"]}
    if "not" in spec:
        return spec_columns(spec["not"])
    return set().union(*(spec_columns(s) for op in ("any", "all") for s in spec.get(op, [])))


def to_program(node: list, T):
    """The drawn predicate as the program's ``Like`` / ``Not`` / ``Any`` /
    ``All``."""
    op, arg = node
    if op == "like":
        return T.Like({c: f"{p}{v:0{w}d}" if w else f"{p}{v}" for c, p, v, w in arg})
    if op == "not":
        return T.Not(to_program(arg, T))
    parts = [to_program(p, T) for p in arg]
    return T.Any(*parts) if op == "any" else T.All(*parts)


class Env:
    """What a unit kind works with: the program's module ``T``, the
    cell's configuration and traffic, the generated data and its
    reference module, the ingested sources and the built indexes."""

    def __init__(self, T, config, traffic, data, ref, sources, indexes, seed):
        self.T, self.config, self.traffic = T, config, traffic
        self.data, self.ref = data, ref
        self.sources, self.indexes = sources, indexes
        self.seed = seed_word(seed)

    @property
    def fact(self):
        return self.sources[self.config["fact"]]




class Unit:
    """A unit kind's common part.  A kind's ``Unit`` gives ``run(drawn,
    span)`` (one unit of work, its stages inside ``span(name)``, a no-op
    context outside a traced run), ``rows(drawn)`` (the input rows it
    reads), ``expected(drawn)`` (the reference's columns),
    ``output_table(out)`` and ``control(drawn)`` (the comparison's
    control), and may override the rest."""

    #: The traffic file's keys this kind reads, beside :data:`COMMON`.
    KEYS: frozenset = frozenset()
    COMMON = frozenset({"unit", "warmup", "check_sample"})

    def __init__(self, env: Env):
        extra = set(env.traffic) - self.KEYS - self.COMMON
        if extra:
            raise ValueError(f"traffic keys {sorted(extra)} are read by no code of the "
                             f"{env.traffic['unit']!r} unit kind")
        self.env = env

    def draw(self, i: int, stream: int = 0):
        """Unit *i*'s parameters (*stream* 1: the warm-up's)."""
        return None

    def facts(self) -> dict:
        """Sizes of the work that metric readers may need, by name."""
        return {}

    def counters(self) -> dict:
        """The program's counters that this kind watches: the harness
        logs what each unit adds to them."""
        return {}


def load_kind(name: str):
    """The ``Unit`` class of ``portbench/kinds/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"bad unit kind name {name!r}")
    return importlib.import_module(f"portbench.kinds.{name}").Unit


@contextmanager
def no_span(name: str):
    """The span of a unit's stage outside a traced run: nothing."""
    yield
