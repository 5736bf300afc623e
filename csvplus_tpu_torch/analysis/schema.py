"""Abstract domain for the plan-IR static verifier.

Port of ``csvplus_tpu/analysis/schema.py``.  The lattices the verifier
(:mod:`.verify`) runs over:

* **Presence** — what the schema says about one column name at one plan
  node: every row has the cell (``PRESENT``), some rows may lack it
  (``MAYBE``), or the name is not in the schema at all (``ABSENT``).
  The host path's errors are *per streamed row* (csvplus.go:511-525):
  selecting an ``ABSENT`` column is an error only if a row actually
  streams, so the verifier weighs presence against cardinality.
* **Card** — the node's row-count lattice point: statically zero rows
  (``EMPTY``), possibly zero (``MAYBE_EMPTY``), or at least one row
  guaranteed (``NONEMPTY``).
* **lane** — the physical column representation the executor lowers
  against: dictionary codes (``"str"``) or typed affix int32 value
  lanes (``"int"``).  Placeholder columns (installed by ``SelectCols``
  of a missing name over an empty selection) are tracked explicitly.
* **Placement** — WHERE the column's backing array lives: ``host``
  (numpy), ``device`` (a torch tensor) or ``sharded`` (a row-sharded
  ``ShardedRows`` over a mesh of several shards), see
  :func:`placement_of_array`.  The lattice bottom is ``unknown`` (synthetic
  states, fakes): unknown placements are never diagnosed.

States are built from table/column *metadata* only (no device syncs — a
column whose ``has_absent`` is not yet cached is conservatively
``MAYBE``), so verification is O(plan nodes x columns).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Placement:
    """Where a column's backing array lives.  ``axes`` names the mesh
    axes a ``sharded`` array is split over (empty when the sharding
    carries no named mesh)."""

    kind: str  # "unknown" | "host" | "device" | "sharded"
    axes: Tuple[str, ...] = ()

    _RANK = {"unknown": 0, "host": 1, "device": 2, "sharded": 3}

    def __repr__(self) -> str:
        if self.kind == "sharded" and self.axes:
            return f"sharded({','.join(self.axes)})"
        return self.kind

    @property
    def known(self) -> bool:
        return self.kind != "unknown"

    @property
    def on_device(self) -> bool:
        return self.kind in ("device", "sharded")

    @property
    def is_sharded(self) -> bool:
        return self.kind == "sharded"

    @property
    def rank(self) -> int:
        return self._RANK[self.kind]


PLACE_UNKNOWN = Placement("unknown")
PLACE_HOST = Placement("host")
PLACE_DEVICE = Placement("device")


def sharded_placement(axes: Tuple[str, ...] = ()) -> Placement:
    return Placement("sharded", tuple(str(a) for a in axes))


def placement_of_array(arr) -> Placement:
    """Placement from one backing array's type (never syncs).

    The port's rule: a ``torch.Tensor`` is ``PLACE_DEVICE``, on "cuda"
    and on "cpu" alike (CPU tensors play the device in the tests, as
    single-device jax CPU arrays do in the reference); a ``ShardedRows``
    over a mesh of more than one shard is ``sharded`` over the mesh's
    axes (one shard is ``PLACE_DEVICE``); a numpy array (or any other
    object with a ``dtype``) is ``PLACE_HOST``; anything else is
    unknown.  The test is the shard count, not the device set: eight
    shards on one card are sharded, as the reference's eight devices
    are."""
    if arr is None:
        return PLACE_UNKNOWN
    if isinstance(arr, torch.Tensor):
        return PLACE_DEVICE
    mesh = getattr(arr, "mesh", None)
    if mesh is not None and hasattr(arr, "shards"):
        return sharded_placement(mesh.axis_names) if mesh.size > 1 else PLACE_DEVICE
    return PLACE_HOST if hasattr(arr, "dtype") else PLACE_UNKNOWN


def placement_of_column(column) -> Placement:
    """Placement from a live column's metadata.  An explicit
    ``column.placement`` attribute (a :class:`Placement` or kind
    string) overrides — the hook synthetic states and tests seed
    through; real columns are read from their backing arrays
    (``IntColumn.values``, or the codes of a ``StringColumn``'s
    ``_codes_state``, the same tensor whether its dictionary is a host
    array or device lanes)."""
    explicit = getattr(column, "placement", None)
    if isinstance(explicit, Placement):
        return explicit
    if isinstance(explicit, str):
        return Placement(explicit)
    if getattr(column, "kind", "str") == "int":
        return placement_of_array(getattr(column, "storage", None))
    state = getattr(column, "_codes_state", None)
    if state:
        return placement_of_array(state[0])
    return PLACE_UNKNOWN


class Presence(enum.Enum):
    PRESENT = "present"  # every row has the cell
    MAYBE = "maybe"  # some rows may lack the cell
    ABSENT = "absent"  # name not in the schema at all

    def __repr__(self) -> str:  # compact diagnostics
        return self.value


class Card(enum.Enum):
    """Row-count lattice: EMPTY <= MAYBE_EMPTY, NONEMPTY <= MAYBE_EMPTY."""

    EMPTY = "empty"  # statically zero rows
    MAYBE_EMPTY = "maybe-empty"  # could be zero
    NONEMPTY = "nonempty"  # at least one row guaranteed

    def __repr__(self) -> str:
        return self.value

    @property
    def may_be_empty(self) -> bool:
        return self is not Card.NONEMPTY

    def narrowed(self) -> "Card":
        """The cardinality after any row-dropping operator (filter,
        windowing cut, anti-join): a NONEMPTY input may come out empty,
        an EMPTY input stays empty."""
        return Card.EMPTY if self is Card.EMPTY else Card.MAYBE_EMPTY


@dataclass(frozen=True)
class ColInfo:
    """What the verifier knows about one column at one plan node."""

    lane: str  # "str" (dictionary codes) | "int" (typed int32 lanes)
    presence: Presence
    placeholder: bool = False  # 0-length stand-in from select-of-missing
    placement: Placement = PLACE_UNKNOWN

    def __repr__(self) -> str:
        tag = f"{self.lane}/{self.presence.value}"
        if self.placement.known:
            tag += f"/{self.placement!r}"
        return f"<{tag}{'/placeholder' if self.placeholder else ''}>"


@dataclass
class NodeState:
    """The abstract relation flowing OUT of one plan node."""

    schema: Dict[str, ColInfo] = field(default_factory=dict)
    card: Card = Card.MAYBE_EMPTY

    def copy(self) -> "NodeState":
        return NodeState(dict(self.schema), self.card)

    def presence(self, name: str) -> Presence:
        info = self.schema.get(name)
        return info.presence if info is not None else Presence.ABSENT

    def with_card(self, card: Card) -> "NodeState":
        return NodeState(dict(self.schema), card)

    def row_placement(self) -> Placement:
        """Where the relation's rows predominantly live: the most
        distributed known column placement (sharded > device > host).
        This is the layout the executor materializes stage outputs on,
        so it is what downstream transfer functions compare against."""
        best = PLACE_UNKNOWN
        for info in self.schema.values():
            if info.placement.rank > best.rank:
                best = info.placement
        return best


def col_info_for(column) -> ColInfo:
    """ColInfo from a live table column, using only cached metadata.

    ``IntColumn`` never holds absent cells (typed.py's representation
    contract), so typed lanes are always PRESENT.  ``StringColumn``
    presence comes from the ``_has_absent`` cache when already known;
    an uncached value stays MAYBE rather than forcing a device sync.
    """
    place = placement_of_column(column)
    if getattr(column, "kind", "str") == "int":
        return ColInfo("int", Presence.PRESENT, placement=place)
    cached = getattr(column, "_has_absent", None)
    if cached is False:
        return ColInfo("str", Presence.PRESENT, placement=place)
    if cached is True:
        return ColInfo("str", Presence.MAYBE, placement=place)
    return ColInfo("str", Presence.MAYBE, placement=place)


def scan_state(table) -> NodeState:
    """The abstract state of a ``Scan`` node's device table."""
    schema = {name: col_info_for(col) for name, col in table.columns.items()}
    nrows = int(getattr(table, "nrows", 0))
    card = Card.NONEMPTY if nrows > 0 else Card.EMPTY
    return NodeState(schema, card)


def placeholder_col() -> ColInfo:
    """The 0-length placeholder ``SelectCols`` installs for a missing
    name over an empty selection (columnar/exec.py ``_apply_select``)."""
    return ColInfo("str", Presence.MAYBE, placeholder=True)


def demoted(info: ColInfo) -> ColInfo:
    """Lane state after a typed column is demoted to dictionary codes."""
    return replace(info, lane="str") if info.lane == "int" else info
