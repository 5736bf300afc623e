"""The port's AST lint: rules generic linters cannot know (port of
``csvplus_tpu/analysis/astlint.py``).

The reference's framework-free rules carry over as they are, over
``csvplus_tpu_torch/``:

* **CTYPES001** — the ctypes boundary.  The C ABI's ``c_char`` takes
  EXACTLY one byte; a multi-byte encoding of a user-supplied delimiter or
  comment that reaches one raises a cryptic ``TypeError`` (or, sliced,
  silently truncates).  Every ``.encode(...)`` expression flowing into a
  ``c_char`` parameter position must be gated in the same function by a
  ``len(<that expression>) == 1`` / ``!= 1`` test or an explicit
  single-byte slice ``[0:1]``.  Positions come from the module's own
  ``argtypes``: ``lib.X.argtypes = [...]`` as in the reference, and the
  port's two other shapes, ``fn = lib.X; fn.argtypes = [...]``
  (``ops/mask.py``, ``ops/parse.py``) and a module-level signature table
  ``{"X": (restype, [argtypes])}`` applied in a loop
  (``native/scanner.py``), with ``c_char`` seen through a module alias
  (``_CH = ctypes.c_char``).
* **THREAD001** — worker purity.  In a module defining a cross-thread
  entry (:data:`_WORKER_ENTRY_NAMES`), no function reachable from it may
  mutate module-global state (or the shared context argument) except
  under a module-level ``Lock``/``RLock`` ``with`` block, a ``*lock`` /
  ``*cv`` attribute's ``with``, or into ``threading.local()`` storage.
* **LOCK001** — lock order.  Any lexically nested acquisition of two
  recognized locks is a finding unless the ordered pair is in
  :data:`LOCK001_CANONICAL_ORDER` (one entry: the views refresh pass).
* **FAULT001** — a broad ``except`` whose body is only ``pass`` /
  ``continue`` silently swallows the failure; the reference's contract
  surfaces every failure typed and row-annotated.
* **IO001** — under ``storage/``, a bare write-mode ``open()`` in a
  function that neither fsyncs nor publishes via ``os.replace`` /
  ``os.rename`` can acknowledge data that sits only in the page cache.
* **ENV001-R** — every ``os.environ`` read routes through
  ``utils/env.py``'s accessors, every variable they read is declared in
  its ``ENV_REGISTRY``, and (whole-tree half) every entry is read
  somewhere and the generated ``docs/ENV_TORCH.md`` equals
  ``render_env_md()``.

Redesigned for eager torch:

* **EAGER001** — the unfused hot loop.  A plain Python ``for`` loop in a
  hot module (``ops/``, ``columnar/typed.py``, ``columnar/table.py``)
  issuing two or more element-wise torch dispatches per iteration
  (``torch.<op>`` calls, tensor-only element-wise methods, a
  ``.to(torch.<dtype>)`` cast, and the arithmetic or bit operators over
  them) launches each op per column or shard per execution.  Everything
  in the port is eager, so the reference's "outside a jit context"
  clause falls away.  Sites kept on purpose are pinned in
  :data:`EAGER001_ALLOWED` with a written citation.
* **SYNC001** lives in :mod:`.jitlint`: an uncounted device-to-host sync
  in ``ops/``, ``columnar/``, ``parallel/`` or ``serve/``.

Not applicable: **JIT001**, **TRACE001** (here) and **RETRACE002**
(:mod:`.jitlint`) guard XLA tracing: a jitted function's tuple-of-arrays
signature, a jit wrapper built per call, a static argument derived from
device data.  Eager torch traces nothing, so none of them can fire.
**COMPILE001** keeps that premise true: any use of ``torch.compile``,
``torch.jit`` or ``torch._dynamo`` in the port is a finding, because a
tracer would bring those three rules back.

The allowance lists of the framework-free rules (``*_ALLOWED``) start
empty and stay empty; sanctioned lock nesting is an ordering fact, not a
per-site waiver.  :data:`EAGER001_ALLOWED` and :mod:`.jitlint`'s
:data:`SYNC001_ALLOWED` map ``"<file basename>:<function>"`` to a
citation; an entry with no citation, or one that no site matches over
the whole tree, is itself a finding.

Suppression: a ``# analysis: allow[CODE]`` comment on the flagged line
or on the enclosing ``def`` line.

Run over the tree with ``python -m csvplus_tpu_torch.analysis`` (no
arguments = the whole installed package tree, so a new module can never
bypass the gate).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["LintFinding", "lint_source", "lint_file", "lint_paths"]


@dataclass(frozen=True)
class LintFinding:
    code: str  # "CTYPES001" | "EAGER001" | "THREAD001" | "LOCK001" | "FAULT001" | "IO001" | "ENV001-R" | "COMPILE001" | "SYNC001"
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _c_char_aliases(tree: ast.Module) -> Set[str]:
    """Module-level names bound to ``c_char`` (``_CH = ctypes.c_char``)."""
    out: Set[str] = set()
    for stmt in tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and _is_c_char(stmt.value)
        ):
            out.add(stmt.targets[0].id)
    return out


def _is_c_char(node: ast.expr, aliases: Set[str] = frozenset()) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "c_char") or (
        isinstance(node, ast.Name) and (node.id == "c_char" or node.id in aliases)
    )


def _positions_of(elts, aliases: Set[str]) -> Tuple[int, ...]:
    return tuple(i for i, el in enumerate(elts) if _is_c_char(el, aliases))


def _c_char_positions(tree: ast.Module) -> Dict[str, Tuple[int, ...]]:
    """``{function_name: c_char argument positions}`` from the module's
    ``argtypes``: every ``<lib>.NAME.argtypes = [...]`` assignment, every
    ``fn.argtypes = [...]`` where the same function bound
    ``fn = <lib>.NAME``, and every module-level signature table
    ``{"NAME": (restype, [...])}`` whose entries a loop assigns to
    ``.argtypes``."""
    aliases = _c_char_aliases(tree)
    out: Dict[str, Tuple[int, ...]] = {}
    funcs = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for scope in [tree] + funcs:
        bound = _local_assignments(scope)
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute) and tgt.attr == "argtypes"):
                continue
            if not isinstance(node.value, (ast.List, ast.Tuple)):
                continue
            owner = tgt.value
            if isinstance(owner, ast.Name):
                owner = bound.get(owner.id)
            if not isinstance(owner, ast.Attribute):
                continue
            pos = _positions_of(node.value.elts, aliases)
            if pos:
                out[owner.attr] = pos
    # signature tables: `for name, (restype, argtypes) in TABLE.items():`
    # ... `<fn>.argtypes = argtypes`
    tables: Set[str] = set()
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.For)
            and isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Attribute)
            and node.iter.func.attr == "items"
            and isinstance(node.iter.func.value, ast.Name)
        ):
            continue
        if any(
            isinstance(sub, ast.Assign)
            and any(
                isinstance(t, ast.Attribute) and t.attr == "argtypes"
                for t in sub.targets
            )
            for sub in ast.walk(node)
        ):
            tables.add(node.iter.func.value.id)
    for stmt in tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and stmt.targets[0].id in tables
            and isinstance(stmt.value, ast.Dict)
        ):
            continue
        for key, val in zip(stmt.value.keys, stmt.value.values):
            if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
                continue
            if not (isinstance(val, ast.Tuple) and len(val.elts) == 2):
                continue
            args = val.elts[1]
            if isinstance(args, (ast.List, ast.Tuple)):
                pos = _positions_of(args.elts, aliases)
                if pos:
                    out[key.value] = pos
    return out


def _find_encode(node: ast.expr) -> Optional[ast.Call]:
    """The ``<something>.encode(...)`` call inside *node*, if any."""
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "encode"
        ):
            return sub
    return None


def _is_single_byte_slice(node: ast.expr) -> bool:
    """``X[0:1]`` — an explicit truncation to at most one byte."""
    if not (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Slice)):
        return False
    s = node.slice
    return (
        isinstance(s.lower, ast.Constant)
        and s.lower.value == 0
        and isinstance(s.upper, ast.Constant)
        and s.upper.value == 1
        and s.step is None
    )


def _len_one_guards(func: ast.AST) -> Set[str]:
    """Unparsed sources ``X`` for every ``len(X) == 1`` / ``len(X) != 1``
    comparison anywhere in *func* (either operand order)."""
    out: Set[str] = set()

    def record(len_side: ast.expr, const_side: ast.expr) -> None:
        if (
            isinstance(len_side, ast.Call)
            and isinstance(len_side.func, ast.Name)
            and len_side.func.id == "len"
            and len(len_side.args) == 1
            and isinstance(const_side, ast.Constant)
            and const_side.value == 1
        ):
            out.add(ast.unparse(len_side.args[0]))

    for node in ast.walk(func):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        if not isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
            continue
        record(node.left, node.comparators[0])
        record(node.comparators[0], node.left)
    return out


def _local_assignments(func: ast.AST) -> Dict[str, ast.expr]:
    """Simple single-target ``name = expr`` bindings in *func* (last one
    wins — good enough for the guard-resolution heuristic)."""
    out: Dict[str, ast.expr] = {}
    for node in ast.walk(func):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            out[node.targets[0].id] = node.value
    return out


class _FunctionStack(ast.NodeVisitor):
    """Visitor that tracks the enclosing function for every node."""

    def __init__(self) -> None:
        self.stack: List[ast.AST] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    @property
    def current(self) -> Optional[ast.AST]:
        return self.stack[-1] if self.stack else None


class _CtypesVisitor(_FunctionStack):
    def __init__(self, positions: Dict[str, Tuple[int, ...]], path: str):
        super().__init__()
        self.positions = positions
        self.path = path
        self.findings: List[LintFinding] = []

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in self.positions):
            return
        func = self.current
        guards = _len_one_guards(func) if func is not None else set()
        local = _local_assignments(func) if func is not None else {}
        for pos in self.positions[fn.attr]:
            if pos >= len(node.args):
                continue
            arg = node.args[pos]
            name = None
            if isinstance(arg, ast.Name):
                name = arg.id
                arg = local.get(arg.id, arg)
            enc = _find_encode(arg)
            if enc is None:
                continue
            if _is_single_byte_slice(arg):
                continue
            gate_keys = {ast.unparse(arg), ast.unparse(enc)}
            if name is not None:
                gate_keys.add(name)
            if gate_keys & guards:
                continue
            self.findings.append(
                LintFinding(
                    "CTYPES001",
                    self.path,
                    node.args[pos].lineno,
                    f"{ast.unparse(enc)} flows into c_char parameter "
                    f"{pos} of {fn.attr} without a len(...) == 1 gate "
                    "in the enclosing function",
                )
            )


# ---------------------------------------------------------------------------
# Allowance lists.  Those of the framework-free rules start EMPTY and must
# stay empty on the current tree.  EAGER001's maps "<file basename>:
# <enclosing function>" to a written citation; an entry without one, or
# one no site matches, is itself a finding.
# ---------------------------------------------------------------------------

THREAD001_ALLOWED: frozenset = frozenset()
FAULT001_ALLOWED: frozenset = frozenset()
IO001_ALLOWED: frozenset = frozenset()
LOCK001_ALLOWED: frozenset = frozenset()

#: EAGER001's pinned loops: ``"<file basename>:<function>" -> citation``
#: of why the loop stays eager (the reference site it mirrors, and the
#: ``ROADMAP.md`` perf-queue item that would fuse it).
EAGER001_ALLOWED: Dict[str, str] = {
    # -- ops/join.py ----------------------------------------------------
    "join.py:_pack_qk": (
        "ports the reference's jitted `ops/join.py:730 _pack_qk_kernel` "
        "(XLA fuses its per-key-column loop into one kernel); eager torch "
        "launches 3 ops a key column (1-3 columns); ROADMAP.md §1 perf "
        "queue: a hand kernel packing every key column in one pass"
    ),
    "join.py:_searchsorted2": (
        "ports the reference's `ops/join.py:92 _searchsorted2`, traced "
        "inside its jitted probe kernels; eager torch launches ~12 ops per "
        "bit_length(n) binary-search step; ROADMAP.md §1 perf queue: one "
        "hand kernel for the two-lane search"
    ),
    "join.py:stats": (
        "ports the reference's jitted `ops/join.py:1054 _multiway_stats` "
        "per shard of a sharded join (one loop step per build side, 2-3); "
        "ROADMAP.md §1 perf queue: fold the per-shard statistics into one "
        "kernel"
    ),
    "join.py:_multiway_stats": (
        "ports the reference's jitted `ops/join.py:1054 _multiway_stats` "
        "(one loop step per build side, 2-3); ROADMAP.md §1 perf queue: "
        "one kernel for the multiway statistics"
    ),
    "join.py:_multiway_expand": (
        "ports the reference's jitted `ops/join.py:1124 "
        "_multiway_expand_kernel` (one loop step per build side, 2-3, 7 "
        "launches each); ROADMAP.md §1 perf queue: one expansion kernel"
    ),
    # -- ops/lanes.py ---------------------------------------------------
    "lanes.py:searchsorted_lanes": (
        "ports the reference's `ops/lanes.py:114 searchsorted_lanes`, traced "
        "inside its jitted translate/union kernels; eager torch launches "
        "~4 ops a lane per bit_length(n) step; ROADMAP.md §1 perf queue: "
        "one hand kernel for the k-lane search"
    ),
    "lanes.py:_union_kernel": (
        "ports the reference's jitted `ops/lanes.py:138 _union_kernel` "
        "(`lax.sort(num_keys=n_lanes)` becomes one stable sort a lane, "
        "least significant first, ROADMAP.md ground rules); ROADMAP.md §1 "
        "perf queue: one sort over packed lanes"
    ),
    "lanes.py:_translate_kernel": (
        "ports the reference's jitted `ops/lanes.py:202 _translate_kernel` "
        "(one gather and compare a lane, 1-8 lanes); ROADMAP.md §1 perf "
        "queue: fold into the k-lane search kernel"
    ),
    # -- ops/parse.py ---------------------------------------------------
    "parse.py:_sort_lanes": (
        "ports the multi-key `lax.sort` of the reference's jitted "
        "`ops/parse.py:78 _encode_column_kernel` as one stable int64 sort a "
        "lane pair (1-4 pairs); the hand-written part, the field pack, is "
        "`csrc/parse.cu`; ROADMAP.md §1 perf queue: one sort over the "
        "packed lanes"
    ),
    # -- ops/sort.py ----------------------------------------------------
    "sort.py:sort_permutation": (
        "ports the reference's jitted `ops/sort.py:32 _sort_kernel` "
        "(`lax.sort(num_keys=k)`) as one stable sort a key column, least "
        "significant first (ROADMAP.md ground rules); ROADMAP.md §1 perf "
        "queue: one sort over a packed int64 key where the codes fit"
    ),
}

#: LOCK001's canonical lock-order table: the ONLY sanctioned nested
#: acquisitions, as ``(outer identity, inner identity)`` pairs (see
#: ``_lock_identity`` for the identity format: ``Owner.attr`` for
#: attribute locks, ``module_stem.name`` for module-level locks).  The
#: repo's concurrency discipline is CONSTANT LOCK ROUNDS — take one
#: lock, do bounded work, release, then take the next (the serving
#: metrics cycle, joinskew's registry-then-sketch sequence, the plan
#: cache's verify-outside-the-lock miss path) — so any lexical nesting of two
#: recognized locks is a finding until the pair is reviewed, documented
#: here, and ordered once for the whole repo.  Current entries:
#:
#: * ``MaterializedView._lock -> MaterializedView._qlock`` — the
#:   refresh pass (serialized by ``_lock``) dequeues tier events under
#:   the O(1) queue guard; every other ``_qlock`` use is a leaf (no
#:   lock acquired inside it), so the order is total and deadlock-free.
LOCK001_CANONICAL_ORDER: frozenset = frozenset({
    ("MaterializedView._lock", "MaterializedView._qlock"),
})

# modules whose per-column loops sit on the measured hot path
_EAGER_HOT_DIRS = ("ops",)
_EAGER_HOT_FILES = ("typed.py", "table.py")

# Cross-thread entry points whose reachable call graph must mutate
# shared state only under locks (the reference's list, carried over): the
# streamed-ingest worker, the serving tier's dispatcher loop, its
# caller-side submission path and its monitors' mutators, the
# observability entry points (telemetry, tracer, kernel registry, memory
# sampler), the fault plan and circuit breaker, the storage writers,
# compactor, WAL and prune tracker, the views' listener and refresh
# paths, and the join-skew evidence mutators.  Matching is on the bare
# name, so class METHODS with these names are entries too (the lint
# tracks ``self`` as the shared context).
_WORKER_ENTRY_NAMES = (
    "_scan_encode_chunk",
    "_dispatch_loop",
    "_enqueue",
    "on_tick",
    "on_batch",
    "on_enqueue",
    "on_shed",
    "on_complete_batch",
    "executable_for",
    "add_stage",
    "count",
    "count_sync",
    "add_span",
    "record_span",
    "drain",
    "register_kernel",
    "_sample_loop",
    "fire",
    "route",
    "on_success",
    "on_failure",
    "on_retry",
    "on_degraded",
    "on_callback_error",
    "append_rows",
    "append_table",
    "append_csv",
    "compact_once",
    "_compact_loop",
    "run_once",
    "register",
    "submit_append",
    "on_index_batch",
    "on_compact",
    "delete",
    "compact_step",
    "wal_sync",
    "append_record",
    "sync_now",
    "seal_active",
    "drop_applied",
    "on_recovered",
    "bounds_many",
    "on_lookup_batch",
    "take_window",
    "subscribe",
    "unsubscribe",
    "_on_tier_event",
    "refresh",
    "read",
    "register_view",
    "submit_delete",
    "on_view_refresh",
    "on_view_read",
    "ensure_pruner",
    "prune_directory",
    "on_join",
    "offer_build",
    "offer_build_sample",
    "on_multiway",
)

# torch's element-wise (and element-wise-shaped reduction / search) ops,
# counted as ``torch.<op>(...)`` calls
_EAGER_TRANSFORM_OPS = frozenset(
    {
        "where",
        "take",
        "take_along_dim",
        "gather",
        "index_select",
        "clamp",
        "clip",
        "searchsorted",
        "bucketize",
        "isin",
        "minimum",
        "maximum",
        "eq",
        "ne",
        "gt",
        "ge",
        "lt",
        "le",
        "bitwise_left_shift",
        "bitwise_right_shift",
        "bitwise_or",
        "bitwise_and",
        "bitwise_xor",
        "bitwise_not",
        "logical_and",
        "logical_or",
        "logical_not",
        "add",
        "sub",
        "subtract",
        "mul",
        "multiply",
        "remainder",
        "floor_divide",
        "sum",
        "cumsum",
    }
)

# the same ops as tensor METHODS, where the name is torch's alone (numpy
# arrays share ``take``/``clip``/``sum``/``cumsum``/``searchsorted``, and
# the port's columns have a ``gather``, so those count only as
# ``torch.<op>`` calls)
_EAGER_TENSOR_METHODS = frozenset(
    {
        "index_select",
        "clamp",
        "clamp_min",
        "clamp_max",
        "masked_fill",
        "eq",
        "ne",
        "gt",
        "ge",
        "lt",
        "le",
        "bitwise_left_shift",
        "bitwise_right_shift",
        "bitwise_or",
        "bitwise_and",
        "bitwise_xor",
        "bitwise_not",
        "logical_and",
        "logical_or",
        "logical_not",
    }
)

_MUTATING_METHODS = frozenset(
    {
        "append",
        "add",
        "update",
        "extend",
        "insert",
        "pop",
        "popitem",
        "remove",
        "discard",
        "clear",
        "setdefault",
        "sort",
        "reverse",
        # deque / OrderedDict mutators the serving tier's queues and
        # LRUs lean on
        "popleft",
        "appendleft",
        "move_to_end",
    }
)


def _allow_key(path: str, func: Optional[ast.AST]) -> str:
    name = getattr(func, "name", "<module>") if func is not None else "<module>"
    return f"{Path(path).name}:{name}"


def _module_level_names(tree: ast.Module) -> Set[str]:
    """Names bound at module scope (assignments, defs, imports)."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(stmt.target, ast.Name):
                out.add(stmt.target.id)
        elif isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            out.add(stmt.name)
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for a in stmt.names:
                out.add((a.asname or a.name).split(".")[0])
    return out


def _declared_globals(func: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(func):
        if isinstance(n, ast.Global):
            out.update(n.names)
    return out


def _root_name(node: ast.expr) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_hot_module(path: str) -> bool:
    p = Path(path)
    return p.name in _EAGER_HOT_FILES or any(
        d in _EAGER_HOT_DIRS for d in p.parts[:-1]
    )


def _is_torch_attr(node: Optional[ast.expr]) -> bool:
    """``torch.<name>`` (a dtype, in a cast)."""
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "torch"
    )


def _eager_counted_call(sub: ast.AST) -> bool:
    if not isinstance(sub, ast.Call) or not isinstance(sub.func, ast.Attribute):
        return False
    f = sub.func
    if f.attr == "to":
        # only a cast to a torch dtype is an element-wise dispatch; a move
        # to a device is a copy, not the unfused-loop shape
        dtype = sub.args[0] if sub.args else None
        for kw in sub.keywords:
            if kw.arg == "dtype":
                dtype = kw.value
        return _is_torch_attr(dtype)
    root = f.value
    while isinstance(root, ast.Attribute):
        root = root.value
    if isinstance(root, ast.Name) and root.id == "torch":
        return f.attr in _EAGER_TRANSFORM_OPS
    return f.attr in _EAGER_TENSOR_METHODS


_EAGER_BINOPS = (
    ast.BitOr,
    ast.BitAnd,
    ast.BitXor,
    ast.LShift,
    ast.RShift,
    ast.Add,
    ast.Sub,
    ast.Mult,
)


def _eager_score(loop: ast.For) -> int:
    """Unfused element-wise torch dispatches per loop iteration:
    ``torch.<op>`` calls, torch-only element-wise methods, dtype casts,
    and arithmetic/bit operators whose operands contain one (each eager
    ``|``/``<<``/``+`` over tensors is its own launch)."""
    count = 0
    for sub in ast.walk(loop):
        if _eager_counted_call(sub):
            count += 1
        elif isinstance(sub, ast.BinOp) and isinstance(sub.op, _EAGER_BINOPS):
            if any(_eager_counted_call(s) for s in ast.walk(sub)):
                count += 1
        elif isinstance(sub, ast.AugAssign) and isinstance(
            sub.op, _EAGER_BINOPS
        ):
            if any(_eager_counted_call(s) for s in ast.walk(sub.value)):
                count += 1
    return count


class _EagerVisitor(_FunctionStack):
    """EAGER001: eager per-column (or per-shard) loops in hot modules.
    *matched* collects the :data:`EAGER001_ALLOWED` keys that blessed a
    loop, for the whole-tree staleness check."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self.findings: List[LintFinding] = []
        self.matched: Set[str] = set()

    def visit_For(self, node: ast.For) -> None:
        score = _eager_score(node)
        if score >= 2:
            key = _allow_key(self.path, self.current)
            if key in EAGER001_ALLOWED:
                self.matched.add(key)
            else:
                self.findings.append(
                    LintFinding(
                        "EAGER001",
                        self.path,
                        node.lineno,
                        f"eager loop issues {score} unfused torch element-wise "
                        "dispatches per iteration in a hot module — make it "
                        "one op over the stacked columns (or a hand kernel), "
                        "or pin it in EAGER001_ALLOWED with its citation",
                    )
                )
        self.generic_visit(node)


def _lock_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for stmt in tree.body:
        if not (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)):
            continue
        f = stmt.value.func
        attr = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if attr in ("Lock", "RLock"):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _thread_local_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for stmt in tree.body:
        if not (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)):
            continue
        f = stmt.value.func
        if isinstance(f, ast.Attribute) and f.attr == "local":
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _thread_findings(tree: ast.Module, path: str) -> List[LintFinding]:
    """THREAD001 over one module, active only when it defines a worker
    entry (:data:`_WORKER_ENTRY_NAMES`; module-level functions AND
    methods of module-level classes match by bare name).  Walks the
    same-module call graph from each entry — through plain calls and
    through ``ctx.method(...)`` calls on a tracked context — propagating
    which parameters alias the SHARED context (the entry's first
    argument; ``self`` for a method entry), and flags any mutation of
    module-global or shared-context state outside a lock's ``with``
    block or ``threading.local()`` storage.  Recognized guards: a
    module-level ``Lock``/``RLock`` name, or an attribute of the
    tracked context / a module global whose terminal name ends in
    ``lock`` or ``cv`` (``with self._lock:``, ``with ctx._cv:`` — a
    Condition's ``with`` acquires its underlying lock)."""
    defs: Dict[str, ast.AST] = {}
    method_index: Dict[str, List[str]] = {}  # bare method name -> "Cls.m" keys
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[stmt.name] = stmt
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{stmt.name}.{sub.name}"
                    defs[q] = sub
                    method_index.setdefault(sub.name, []).append(q)
    entries = [
        name
        for name in defs
        if name.rsplit(".", 1)[-1] in _WORKER_ENTRY_NAMES
    ]
    if not entries:
        return []
    module_names = _module_level_names(tree)
    locks = _lock_names(tree)
    tlocals = _thread_local_names(tree)

    def params_of(func: ast.AST) -> List[str]:
        a = func.args
        return [p.arg for p in a.posonlyargs + a.args]

    # reachable functions with the set of parameters aliasing the shared
    # context, to a fixpoint (conservative union across call sites)
    tracked: Dict[str, Set[str]] = {}
    for e in entries:
        ps = params_of(defs[e])
        tracked[e] = {ps[0]} if ps else set()

    def propagate(callee: str, passed: Set[str], work: List[str]) -> None:
        prev = tracked.get(callee)
        if prev is None or not passed <= prev:
            tracked[callee] = (prev or set()) | passed
            work.append(callee)

    work = list(entries)
    while work:
        name = work.pop()
        func = defs[name]
        t = tracked.get(name, set())
        for sub in ast.walk(func):
            if not isinstance(sub, ast.Call):
                continue
            callees: List[Tuple[str, int]] = []  # (def key, self offset)
            if isinstance(sub.func, ast.Name) and sub.func.id in defs:
                callees.append((sub.func.id, 0))
            elif (
                isinstance(sub.func, ast.Attribute)
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id in t
            ):
                # ctx.method(...): the receiver IS the shared context —
                # resolve to every same-module class method of that name
                # (conservative when classes share a method name)
                callees.extend(
                    (q, 1) for q in method_index.get(sub.func.attr, ())
                )
            for callee, offset in callees:
                callee_params = params_of(defs[callee])
                passed: Set[str] = set()
                if offset and callee_params:
                    passed.add(callee_params[0])  # receiver binds self
                for i, a in enumerate(sub.args):
                    j = i + offset
                    if (
                        isinstance(a, ast.Name)
                        and a.id in t
                        and j < len(callee_params)
                    ):
                        passed.add(callee_params[j])
                for kw in sub.keywords:
                    if (
                        kw.arg is not None
                        and isinstance(kw.value, ast.Name)
                        and kw.value.id in t
                    ):
                        passed.add(kw.arg)
                propagate(callee, passed, work)

    findings: List[LintFinding] = []
    for name, ctx_params in tracked.items():
        func = defs[name]

        def _is_lock_expr(expr: ast.expr) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in locks
            if isinstance(expr, ast.Attribute):
                root = _root_name(expr)
                tail = expr.attr
                return root is not None and (
                    root in ctx_params or root in module_names
                ) and (tail.endswith("lock") or tail.endswith("cv"))
            return False

        spans = [
            (w.lineno, getattr(w, "end_lineno", w.lineno))
            for w in ast.walk(func)
            if isinstance(w, ast.With)
            and any(_is_lock_expr(item.context_expr) for item in w.items)
        ]
        g = _declared_globals(func)

        def lock_guarded(line: int) -> bool:
            return any(lo <= line <= hi for lo, hi in spans)

        def flag(line: int, what: str) -> None:
            if _allow_key(path, func) in THREAD001_ALLOWED:
                return
            findings.append(
                LintFinding(
                    "THREAD001",
                    path,
                    line,
                    f"`{name}` is reachable from worker entry "
                    f"`{'/'.join(sorted(entries))}` and {what} outside a "
                    "recognized lock — shared mutable state must be "
                    "lock-guarded or owned by one thread",
                )
            )

        def check_store_target(t: ast.expr, line: int) -> None:
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    check_store_target(el, line)
                return
            if isinstance(t, ast.Name):
                if t.id in g and not lock_guarded(line):
                    flag(line, f"stores module global `{t.id}`")
                return
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                root = _root_name(t)
                if root is None or root in tlocals or lock_guarded(line):
                    return
                if root in ctx_params:
                    flag(line, f"mutates the shared context `{root}`")
                elif root in g or (root in module_names and root not in defs):
                    flag(line, f"mutates module-global `{root}`")

        for sub in ast.walk(func):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    check_store_target(t, sub.lineno)
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                check_store_target(sub.target, sub.lineno)
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _MUTATING_METHODS
            ):
                root = _root_name(sub.func)
                if (
                    root is not None
                    and root not in tlocals
                    and not lock_guarded(sub.lineno)
                ):
                    if root in ctx_params:
                        flag(
                            sub.lineno,
                            f"calls `{root}.{sub.func.attr}(...)` on the "
                            "shared context",
                        )
                    elif root in module_names and root not in defs:
                        flag(
                            sub.lineno,
                            f"calls `{root}.{sub.func.attr}(...)` on a "
                            "module global",
                        )
    return findings


def _io_findings(tree: ast.Module, path: str) -> List[LintFinding]:
    """IO001, active only under ``storage/``: a bare ``open()`` with a
    write mode (``w``/``a``/``x``/``+``) in a function that neither
    fsyncs nor publishes via atomic rename leaves a durability hole —
    the data may sit in the page cache when the ack goes out, exactly
    the acked-then-lost window the WAL exists to close.  Write through
    the fsync-then-rename idiom (``wal._open_segment``,
    ``manifest.write_manifest``) or fsync in the same function."""
    if "storage" not in Path(path).parts:
        return []
    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "open"
        ):
            continue
        mode: Optional[str] = None
        if (
            len(node.args) >= 2
            and isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, str)
        ):
            mode = node.args[1].value
        for kw in node.keywords:
            if (
                kw.arg == "mode"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
            ):
                mode = kw.value.value
        if mode is None or not any(ch in mode for ch in "wax+"):
            continue
        func = _enclosing_function(tree, node.lineno)
        scope = func if func is not None else tree
        durable = any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in ("fsync", "replace", "rename")
            for sub in ast.walk(scope)
        )
        if durable:
            continue
        if _allow_key(path, func) in IO001_ALLOWED:
            continue
        findings.append(
            LintFinding(
                "IO001",
                path,
                node.lineno,
                f"open(..., {mode!r}) writes in storage/ without an "
                "fsync or atomic replace/rename in the enclosing "
                "function — an acked write may sit only in the page "
                "cache (use the fsync-then-rename idiom)",
            )
        )
    return findings


def _lock_identity(
    expr: ast.expr, module_locks: Set[str], class_name: Optional[str],
    stem: str
) -> Optional[str]:
    """A stable identity for a lock-like ``with`` context expression,
    or None when the expression is not lock-like.  Recognition matches
    THREAD001's: a module-level ``Lock``/``RLock`` name, or a name/
    attribute whose terminal name ends in ``lock`` or ``cv``.
    Identities are coarse on purpose — ``Owner.attr`` for attribute
    locks (the enclosing class for ``self``/``cls`` receivers),
    ``module_stem.name`` for module-level names — so the canonical
    order table ranks lock *classes*, not instances."""
    if isinstance(expr, ast.Name):
        if expr.id in module_locks or expr.id.endswith(("lock", "cv")):
            return f"{stem}.{expr.id}"
        return None
    if isinstance(expr, ast.Attribute) and expr.attr.endswith(("lock", "cv")):
        root = _root_name(expr)
        if root in ("self", "cls") and class_name is not None:
            return f"{class_name}.{expr.attr}"
        return f"{root or '?'}.{expr.attr}"
    return None


def _lock_findings(tree: ast.Module, path: str) -> List[LintFinding]:
    """LOCK001: lexically nested acquisition of two recognized locks —
    a ``with <lock>`` inside another ``with <lock>`` span (including two
    lock items in ONE ``with``, acquired left to right) — where the
    ordered ``(outer, inner)`` pair is not in
    :data:`LOCK001_CANONICAL_ORDER`.  Two code paths nesting the same
    pair of locks in opposite orders deadlock under contention; the
    repo-wide rule is one documented order or no nesting at all.  Lock
    registry covered: every module-level ``Lock``/``RLock`` plus the
    ``*lock``/``*cv`` attribute convention — the serve dispatcher,
    storage writer/compactor, views refresh, and obs plane monitors all
    follow it.  Nested ``def``/``lambda`` bodies do not execute under
    the enclosing ``with``, so the held-set resets there."""
    module_locks = _lock_names(tree)
    stem = Path(path).stem
    findings: List[LintFinding] = []

    def flag(outer: str, outer_line: int, inner: str, line: int) -> None:
        func = _enclosing_function(tree, line)
        if _allow_key(path, func) in LOCK001_ALLOWED:
            return
        findings.append(
            LintFinding(
                "LOCK001",
                path,
                line,
                f"acquires `{inner}` while holding `{outer}` (taken at "
                f"line {outer_line}) and the pair is not in the "
                "canonical lock order table "
                "(LOCK001_CANONICAL_ORDER) — nested orders must be "
                "documented once repo-wide or restructured into "
                "sequential lock rounds",
            )
        )

    def visit(node: ast.AST, held, class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                visit(child, [], class_name)
            elif isinstance(child, ast.ClassDef):
                visit(child, held, child.name)
            elif isinstance(child, (ast.With, ast.AsyncWith)):
                now = list(held)
                for item in child.items:
                    ident = _lock_identity(
                        item.context_expr, module_locks, class_name, stem)
                    if ident is None:
                        continue
                    for outer, outer_line in now:
                        if (outer, ident) not in LOCK001_CANONICAL_ORDER:
                            flag(outer, outer_line, ident, child.lineno)
                    now.append((ident, child.lineno))
                visit(child, now, class_name)
            else:
                visit(child, held, class_name)

    visit(tree, [], None)
    return findings


# ---------------------------------------------------------------------------
# ENV001-R — the configuration registry boundary.  Every ``os.environ``
# read routes through utils/env.py's registered accessors, every variable
# they read is declared in ENV_REGISTRY, and the generated
# docs/ENV_TORCH.md matches the registry byte for byte.  A knob that
# exists only at its read site is invisible to operators, and a knob the
# reference reads that the port hard-codes makes the two packages differ
# silently.
# ---------------------------------------------------------------------------

_ENV_ACCESSORS = frozenset({"env_int", "env_str", "env_float", "env_flag"})

#: The generated table of the port's knobs, relative to the repo root.
ENV_DOC = "docs/ENV_TORCH.md"


def _env_registry_names() -> Optional[frozenset]:
    """Registered variable names from the live registry module, or None
    when it cannot be imported (linting outside the package)."""
    try:
        from ..utils.env import ENV_REGISTRY
    except Exception:
        return None
    return frozenset(ENV_REGISTRY)


def _env_findings(tree: ast.Module, path: str) -> List[LintFinding]:
    """ENV001-R per-file half: direct ``os.environ``/``os.getenv`` reads
    outside utils/env.py, and accessor calls naming an unregistered (or
    non-literal) variable."""
    p = Path(path)
    if p.name == "env.py" and "utils" in p.parts:
        return []  # the one sanctioned os.environ reader
    findings: List[LintFinding] = []
    registry = _env_registry_names()
    direct_lines: Set[int] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in ("environ", "getenv")
            and isinstance(node.value, ast.Name)
            and node.value.id == "os"
        ):
            if node.lineno not in direct_lines:
                direct_lines.add(node.lineno)
                findings.append(
                    LintFinding(
                        "ENV001-R",
                        path,
                        node.lineno,
                        f"direct os.{node.attr} read — route through the "
                        "utils/env.py accessors (env_str/env_int/"
                        "env_float/env_flag) so the variable lands in "
                        f"ENV_REGISTRY and {ENV_DOC}",
                    )
                )
        elif isinstance(node, ast.Call):
            f = node.func
            fname = None
            if isinstance(f, ast.Name):
                fname = f.id.lstrip("_")
            elif isinstance(f, ast.Attribute):
                fname = f.attr.lstrip("_")
            if fname not in _ENV_ACCESSORS or not node.args:
                continue
            first = node.args[0]
            if not (
                isinstance(first, ast.Constant) and isinstance(first.value, str)
            ):
                findings.append(
                    LintFinding(
                        "ENV001-R",
                        path,
                        node.lineno,
                        f"{fname}(...) takes a computed variable name — "
                        "names must be string literals so registration "
                        "is statically checkable",
                    )
                )
            elif registry is not None and first.value not in registry:
                findings.append(
                    LintFinding(
                        "ENV001-R",
                        path,
                        node.lineno,
                        f"{fname}({first.value!r}) reads a variable not "
                        "declared in utils/env.py ENV_REGISTRY — register "
                        "it (name, kind, default, description)",
                    )
                )
    return findings


def env_global_findings() -> List[LintFinding]:
    """ENV001-R whole-tree half, run once per lint invocation over the
    installed package: stale registry entries (declared but read
    nowhere) and generated-doc drift (the committed docs/ENV_TORCH.md
    differs from ``render_env_md()``)."""
    try:
        from ..utils import env as env_mod
    except Exception:
        return []
    pkg = Path(__file__).resolve().parent.parent
    reg_path = pkg / "utils" / "env.py"
    findings: List[LintFinding] = []
    sources = [
        f.read_text(encoding="utf-8")
        for f in sorted(pkg.rglob("*.py"))
        if f != reg_path
    ]
    for name in env_mod.ENV_REGISTRY:
        quoted = (f'"{name}"', f"'{name}'")
        if not any(q in src for src in sources for q in quoted):
            findings.append(
                LintFinding(
                    "ENV001-R",
                    str(reg_path),
                    1,
                    f"ENV_REGISTRY entry {name} is read nowhere in the "
                    "package — registry drift (remove it or wire the "
                    "read through an accessor)",
                )
            )
    docs = pkg.parent / ENV_DOC
    regen = f"`python -m csvplus_tpu_torch.analysis env --write {ENV_DOC}`"
    if docs.parent.is_dir():
        rendered = env_mod.render_env_md()
        if not docs.exists():
            findings.append(
                LintFinding(
                    "ENV001-R",
                    str(docs),
                    1,
                    f"generated {ENV_DOC} is missing — write it with {regen}",
                )
            )
        elif docs.read_text(encoding="utf-8") != rendered:
            findings.append(
                LintFinding(
                    "ENV001-R",
                    str(docs),
                    1,
                    f"{ENV_DOC} drifted from utils/env.py ENV_REGISTRY "
                    f"— regenerate with {regen}",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# COMPILE001 — the no-tracer premise.  JIT001, TRACE001 and RETRACE002
# are not ported because eager torch traces nothing; a use of
# torch.compile / torch.jit / torch._dynamo would make them apply again.
# ---------------------------------------------------------------------------

_TRACER_ATTRS = frozenset({"compile", "jit", "_dynamo"})


def _compile_findings(tree: ast.Module, path: str) -> List[LintFinding]:
    """COMPILE001: ``torch.compile`` / ``torch.jit`` / ``torch._dynamo``
    named anywhere (attribute, ``import torch.jit``, ``from torch import
    compile``)."""
    lines: Set[int] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in _TRACER_ATTRS
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch"
        ):
            lines.add(node.lineno)
        elif isinstance(node, ast.Import):
            if any(
                a.name.split(".")[:2] in (["torch", t] for t in _TRACER_ATTRS)
                for a in node.names
            ):
                lines.add(node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module:
            parts = node.module.split(".")
            if parts[0] == "torch" and (
                (len(parts) > 1 and parts[1] in _TRACER_ATTRS)
                or any(a.name in _TRACER_ATTRS for a in node.names)
            ):
                lines.add(node.lineno)
    return [
        LintFinding(
            "COMPILE001",
            path,
            line,
            "torch.compile / torch.jit / torch._dynamo in the port: it "
            "traces, so the unported JIT001 / TRACE001 / RETRACE002 rules "
            "would apply again — port them first, or stay eager",
        )
        for line in sorted(lines)
    ]


_BROAD_EXCEPT_NAMES = frozenset({"Exception", "BaseException"})


def _enclosing_function(tree: ast.Module, line: int) -> Optional[ast.AST]:
    """The innermost function whose span contains *line*, or None."""
    best: Optional[ast.AST] = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end and (
                best is None or node.lineno > best.lineno
            ):
                best = node
    return best


def _fault_findings(tree: ast.Module, path: str) -> List[LintFinding]:
    """FAULT001: a broad exception handler — bare ``except``,
    ``except Exception``, ``except BaseException`` (alone or inside a
    tuple) — whose body is nothing but ``pass``/``continue``.  The
    failure is silently swallowed; the reference contract (typed,
    row-annotated, surfaced) forbids that.  Handlers that re-raise,
    wrap, return, log, or count are untouched, as are narrowly-typed
    best-effort catches."""

    def is_broad(h: ast.ExceptHandler) -> bool:
        t = h.type
        if t is None:
            return True
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        for n in elts:
            if isinstance(n, ast.Name) and n.id in _BROAD_EXCEPT_NAMES:
                return True
            if isinstance(n, ast.Attribute) and n.attr in _BROAD_EXCEPT_NAMES:
                return True
        return False

    findings: List[LintFinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not is_broad(node):
            continue
        if not all(isinstance(s, (ast.Pass, ast.Continue)) for s in node.body):
            continue
        func = _enclosing_function(tree, node.lineno)
        if _allow_key(path, func) in FAULT001_ALLOWED:
            continue
        findings.append(
            LintFinding(
                "FAULT001",
                path,
                node.lineno,
                "broad except handler silently swallows the error — "
                "re-raise, wrap via map_error, or record it to "
                "metrics/telemetry (the reference contract surfaces "
                "every failure typed and row-annotated)",
            )
        )
    return findings


def _suppressed(finding: LintFinding, lines: List[str], tree: ast.Module) -> bool:
    marker = f"analysis: allow[{finding.code}]"

    def line_has(idx: int) -> bool:
        return 0 < idx <= len(lines) and marker in lines[idx - 1]

    if line_has(finding.line):
        return True
    # any enclosing def line (a flagged closure inherits its outer
    # function's acknowledgment)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= finding.line <= end and line_has(node.lineno):
                return True
    return False


def lint_source(
    source: str,
    path: str = "<string>",
    matched_out=None,
) -> List[LintFinding]:
    """All unsuppressed findings for one module's source text.
    *matched_out* (a set, whole-tree lint only) accumulates the
    ``(allowlist name, key)`` pairs this file's sync sites and eager
    loops matched, feeding the global staleness check."""
    tree = ast.parse(source, filename=path)
    findings: List[LintFinding] = []
    positions = _c_char_positions(tree)
    if positions:
        v = _CtypesVisitor(positions, path)
        v.visit(tree)
        findings.extend(v.findings)
    if _is_hot_module(path):
        e = _EagerVisitor(path)
        e.visit(tree)
        findings.extend(e.findings)
        if matched_out is not None:
            matched_out |= {("EAGER001_ALLOWED", k) for k in e.matched}
    findings.extend(_compile_findings(tree, path))
    findings.extend(_thread_findings(tree, path))
    findings.extend(_lock_findings(tree, path))
    findings.extend(_fault_findings(tree, path))
    findings.extend(_io_findings(tree, path))
    findings.extend(_env_findings(tree, path))
    from .jitlint import jitlint_findings  # late: jitlint imports us

    findings.extend(jitlint_findings(tree, path, matched_out))
    lines = source.splitlines()
    findings = [f for f in findings if not _suppressed(f, lines, tree)]
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def lint_file(path, matched_out=None) -> List[LintFinding]:
    p = Path(path)
    return lint_source(p.read_text(encoding="utf-8"), str(p), matched_out)


def lint_paths(paths: Iterable, global_checks: bool = False) -> List[LintFinding]:
    """Lint every ``.py`` file under each path (file or directory).
    With *global_checks* (the whole-package lint run), the cross-file
    checks run once on top: the ENV001-R registry/doc drift checks and
    the allowlist staleness check of SYNC001 and EAGER001 (per-file lints
    cannot tell a stale allowance from a site they are not looking
    at)."""
    matched: set = set()
    findings: List[LintFinding] = []
    for path in paths:
        p = Path(path)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f, matched))
    if global_checks:
        from .jitlint import allowlist_global_findings

        findings.extend(env_global_findings())
        findings.extend(allowlist_global_findings(matched))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings
