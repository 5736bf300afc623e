"""Vectorized row predicates over columnar data.

Port of ``csvplus_tpu/ops/filter.py``.  The predicate DSL objects
(:mod:`..predicates`) are lowered: a ``Like`` becomes int32 equality
against dictionary codes, or against the value lanes of a typed column
(any int32, negative values included), and ``All``/``Any``/``Not``
become boolean algebra over those masks.  Equality terms go through the
fused mask kernel (:mod:`.mask`) in one pass over every referenced
column.

Missing-column semantics match the host path: ``Like`` on a row without
the column is false (csvplus.go:1284-1292), so ``Not(Like(...))`` over a
missing column is true for every row.
"""

from __future__ import annotations

import torch

from ..predicates import All, Any_, Like, Not
from .mask import MAX_COLS, fused_equality_mask


class UnsupportedPredicate(Exception):
    """Raised when a predicate cannot be lowered (opaque Python callable)."""


def predicate_columns(pred):
    """Ordered, de-duplicated column names referenced by *pred*, or
    ``None`` when the tree holds a node :func:`build_mask` cannot lower.
    Keep the dispatch here in sync with :func:`build_mask`."""
    out: list = []

    def visit(p) -> bool:
        if isinstance(p, Like):
            for col in p.match:
                if col not in out:
                    out.append(col)
            return True
        if isinstance(p, (All, Any_)):
            return all(visit(q) for q in p.preds)
        if isinstance(p, Not):
            return visit(p.pred)
        return False

    return out if visit(pred) else None


def _group_by_column(terms):
    """Merge (array, target) terms on the same column into
    (array, [targets...]) so an IN-list streams its column once."""
    grouped = {}
    order = []
    for codes, code in terms:
        key = id(codes)
        if key not in grouped:
            grouped[key] = (codes, [])
            order.append(key)
        grouped[key][1].append(code)
    return [grouped[k] for k in order]


def _mask_from_terms(terms, nrows: int, mode: str) -> torch.Tensor:
    """Mask over a non-empty list of equality terms, each (array, target)
    or (array, [targets...]), through the fused mask kernel,
    :data:`MAX_COLS` columns per launch.  The reference sends a single
    term to XLA, which fuses its compares; eager torch would run one op
    per target, so one term takes the kernel too (k = 1)."""
    mask = None
    for i in range(0, len(terms), MAX_COLS):
        part = terms[i : i + MAX_COLS]
        m = fused_equality_mask(
            [t[0] for t in part], [t[1] for t in part], nrows, mode=mode
        )
        mask = m if mask is None else (mask & m if mode == "all" else mask | m)
    return mask


def _column_term(c, val):
    """(storage array, target) equality term for one column, or None
    when no cell can equal *val*.  Typed columns compare their value
    lanes against the parsed constant, with no demotion; dictionary
    columns compare codes against the dictionary slot."""
    if c.kind == "int":
        v = c.equality_term(val)
        return None if v is None else (c.values, v)
    code = c.find_code(val)
    return None if code < 0 else (c.codes, code)


def _equality_terms(cols, preds):
    """Flatten predicates into (array, target) terms when every one is a
    single-column Like; terms on missing columns/values drop out (they are
    constant-false in a disjunction).  None = not flattenable."""
    terms = []
    for p in preds:
        if not isinstance(p, Like) or len(p.match) != 1:
            return None
        (col, val), = p.match.items()
        if col not in cols:
            continue
        term = _column_term(cols[col], val)
        if term is None:
            continue
        terms.append(term)
    return terms


def build_mask(cols, nrows: int, pred, device: torch.device) -> torch.Tensor:
    """Lower *pred* to a boolean mask over all *nrows* rows on *device*."""
    if isinstance(pred, Like):
        terms = []
        for col, val in pred.match.items():
            if col not in cols:
                return torch.zeros(nrows, dtype=torch.bool, device=device)
            term = _column_term(cols[col], val)
            if term is None:
                return torch.zeros(nrows, dtype=torch.bool, device=device)
            terms.append(term)
        return _mask_from_terms(terms, nrows, mode="all")
    if isinstance(pred, All):
        mask = torch.ones(nrows, dtype=torch.bool, device=device)
        for p in pred.preds:
            mask = mask & build_mask(cols, nrows, p, device)
        return mask
    if isinstance(pred, Any_):
        terms = _equality_terms(cols, pred.preds)
        if terms is not None:
            if not terms:  # every branch referenced a missing column/value
                return torch.zeros(nrows, dtype=torch.bool, device=device)
            return _mask_from_terms(_group_by_column(terms), nrows, mode="any")
        mask = torch.zeros(nrows, dtype=torch.bool, device=device)
        for p in pred.preds:
            mask = mask | build_mask(cols, nrows, p, device)
        return mask
    if isinstance(pred, Not):
        return ~build_mask(cols, nrows, pred.pred, device)
    raise UnsupportedPredicate(f"cannot lower predicate {pred!r} to device")
