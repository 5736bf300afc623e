"""SYNC001, the host-sync lint, redesigned for eager torch (counterpart of
``csvplus_tpu/analysis/jitlint.py``).

The file keeps the reference's name so a reader finds the counterpart,
but it holds no jit rule.  The reference's RETRACE002 (a static argument
of a jitted kernel derived from device data retraces per value) guards
XLA tracing; eager torch traces nothing, so it cannot fire, and
:mod:`.astlint`'s COMPILE001 keeps any tracer out of the port.

* **SYNC001** — the host-sync boundary.  In ``ops/``, ``columnar/``,
  ``parallel/`` and ``serve/``, each of these on a value the function
  provably got from torch is a device-to-host sync the caller does not
  see: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()``,
  ``float()``, ``bool()``, ``len()``, ``np.asarray()`` / ``np.array()``,
  and ``nonzero()`` without ``size=`` (its output size is read back).
  A sync is legal only when accounted: the enclosing function calls
  ``telemetry.count_sync(...)`` (the ``host_sync_elements`` ledger), or
  the site is pinned in :data:`SYNC001_ALLOWED` with a written citation.
  An entry with no citation, with a citation that neither says what it
  moves and names its accounting nor opens with ``no transfer:``, or
  that no site over the whole tree matches, is itself a finding.  The
  citation check reads words: it cannot tell whether a site moves what
  its entry says.

Provably torch, per function (intraprocedural, like the reference:
an unannotated parameter is untainted, callers are checked at their own
sites): parameters annotated ``torch.Tensor``; in a method, ``self``
attributes its class body annotates ``torch.Tensor``; results of
``torch.*`` calls (host-metadata helpers such as
``torch.device`` or ``torch.cuda.*`` excluded); results of tensor-only
methods (``.to``, ``.contiguous``, ``.index_select``, ...); methods,
subscripts, arithmetic and comparisons over such a value; names passed
positionally to a ``torch.*`` call (an argument of ``torch.cat`` IS a
tensor; the host-side arguments of uploads and shape constructors
excepted); and ``isinstance(x, torch.Tensor)`` guards.  Shape metadata
(``.shape``, ``.dtype``, ``.device``, ``.numel()``, ...) launders the
taint.

What the rule cannot prove, it does not check: a sync on a tensor
reached through an attribute the class body does not annotate (a
column's ``storage``, an index's ``dev``), through an unannotated
parameter, or through a helper's return value passes unseen.
``ROADMAP.md`` §3 "SYNC001's triage" lists such sites in the hot
modules (``exec.py:_row_id``, ``table.py:host_array`` / ``find_codes``
and others); a new one is held to the rule by review, not by the lint.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .astlint import EAGER001_ALLOWED, LintFinding, _allow_key

__all__ = [
    "SYNC001_ALLOWED",
    "jitlint_findings",
    "allowlist_global_findings",
]

#: Pinned allowlist for DELIBERATE device-to-host syncs that no
#: ``count_sync`` accounts: ``"<file basename>:<function>" -> citation``.
#: Every entry cites the reference site it mirrors (or the ``ROADMAP.md``
#: §3 "Host-sync totals" design note), says what it moves and where that
#: lands in the ``host_sync_elements`` ledger, or opens with
#: ``no transfer:`` and says why nothing moves.
SYNC001_ALLOWED: Dict[str, str] = {
    # -- columnar -------------------------------------------------------
    "exec.py:_first_true": (
        "the reference's `exec.py:_exec_stage` entry: deliberate O(1) "
        "scalar control syncs (Validate failure probe, TakeWhile/DropWhile "
        "cut index, first_missing_cell's row); moves one scalar per stage "
        "execution (one a shard, in one transfer, on a sharded mask), "
        "uncounted in host_sync_elements as the reference's"
    ),
    "exec.py:first_missing_cell": (
        "the reference's `exec.py:first_missing_cell` entry: error path "
        "only; moves a few scalar row numbers while the pipeline aborts, "
        "uncounted in host_sync_elements as the reference's"
    ),
    "ingest.py:link_rtt_ms": (
        "the reference's `ingest.py:link_rtt_ms` entry: the RTT probe IS a "
        "measured sync; moves an 8-element tensor 3 times, once per "
        "device (cached), uncounted in host_sync_elements as the "
        "reference's"
    ),
    "table.py:sharded_any": (
        "the sharded form of the reference's `table.py:has_absent` entry: "
        "moves one 0-d bool a shard, once per column (cached), uncounted "
        "in host_sync_elements as the reference's"
    ),
    "table.py:decode_codes": (
        "ROADMAP.md §3 'Slice decode': a slice decode gathers only the "
        "selected lane-dictionary slots on the card and moves them, "
        "where the reference decodes from its host dictionary; the "
        "decoded values are the answer, outside the host_sync_elements "
        "steady-state guard"
    ),
    "typed.py:dict_size": (
        "ROADMAP.md §3 'IntColumn.dict_size counts distinct values': "
        "moves one scalar (the distinct count) once per column lifetime, "
        "where the reference demotes; uncounted in host_sync_elements"
    ),
    "typed.py:_demote": (
        "the reference's `typed.py:_demote` entry: deliberate "
        "dictionary-build transfer; moves the UNIQUE values only, "
        "accounted as typed:demote stage elements, outside the "
        "host_sync_elements steady-state guard by design"
    ),
    # -- ops ------------------------------------------------------------
    "join.py:_decode_sample": (
        "the build-side sample's dictionary slots for the cost model's "
        "sketch; moves at most BUILD_SAMPLE values once per index, "
        "uncounted in host_sync_elements (the sample itself is counted "
        "by offer_build_sample's count_sync, reference "
        "`ops/join.py:398`; the reference decodes these slots from its "
        "host dictionary, ROADMAP.md §3 'Slice decode')"
    ),
    "join.py:_partitioned_for": (
        "the reference's `join.py:build` entry: moves the packed keys "
        "once per mesh (cached) for the partitioned-path preparation, "
        "outside the host_sync_elements steady-state guard; the probe "
        "path moves nothing"
    ),
    "join.py:_packed_host_mirror": (
        "the reference's `join.py:build` entry (its host key mirror serves "
        "point_bounds): moves the int32 keys once per index, at or under "
        "POINT_MIRROR_MAX_KEYS, outside the host_sync_elements "
        "steady-state guard; a lookup moves nothing"
    ),
    "join.py:_packed_i64_host": (
        "the reference's `join.py:build` entry: moves the two-lane tier's "
        "int64 keys once per index (the reference keeps them on the host "
        "from the build on), outside the host_sync_elements steady-state "
        "guard"
    ),
    "join.py:_search_packed": (
        "the reference's `join.py:point_bounds` / `point_bounds_many` "
        "entries: above the mirror cap moves 2m bound scalars per batch, "
        "which ARE the answer, uncounted in host_sync_elements as the "
        "reference's"
    ),
    "join.py:expand_matches_device": (
        "the reference's `join.py:expand_matches_device` entry: moves one "
        "O(1) total sizing the output, only when the caller passes no "
        "total (join_tables passes the one its count_sync(2) stats "
        "transfer read)"
    ),
    "join.py:_checked_probe_cols": (
        "the reference's `join.py:_checked_probe_cols` entry: error path "
        "only; moves one argmax scalar while raising DataSourceError, "
        "uncounted in host_sync_elements as the reference's"
    ),
    "lanes.py:union_device": (
        "the reference's `lanes.py:union_device` and "
        "`lanes.py:translate_lanes` entries: len() reads host lane tuples; "
        "moves one scalar (the union's size) for the output slice, "
        "uncounted in host_sync_elements as the reference's"
    ),
    "sort.py:find_adjacent_duplicate": (
        "the reference's `sort.py:find_adjacent_duplicate` entry: moves "
        "one O(1) validation scalar per index build, uncounted in "
        "host_sync_elements as the reference's"
    ),
    "sort.py:run_starts": (
        "the reference's `sort.py:run_starts` entry: the host bool "
        "run-starts mask is this helper's CONTRACT; moves n bools at "
        "index-build time, outside the host_sync_elements steady-state "
        "guard"
    ),
    # -- parallel -------------------------------------------------------
    "mesh.py:_as_tensor": (
        "no transfer: np.array runs only on a value that is NOT a tensor "
        "(the isinstance guard returns tensors first)"
    ),
    "mesh.py:relayout": (
        "no transfer: len() reads the host list of a shard's pieces"
    ),
    "pjoin.py:_search": (
        "no transfer: len() reads the lane tuple's arity (the reference's "
        "`lanes.py:translate_lanes` entry)"
    ),
    "pjoin.py:_strided_host": (
        "the strided skew sample: moves the sampled keys; its caller "
        "_detect_hot counts every element with telemetry.count_sync, as "
        "the reference's `parallel/pjoin.py:650-655` does"
    ),
}

_HOT_DIRS = ("ops", "columnar", "parallel", "serve")

# calls whose RESULT is a host value even when the argument is a device
# value: the implicit-sync sinks (np.asarray/np.array by attribute, the
# builtins by bare name, the methods on their receiver)
_SINK_NP_ATTRS = frozenset({"asarray", "array"})
_SINK_BUILTINS = frozenset({"bool", "int", "float", "len"})
_SINK_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

# attribute reads and method calls that launder taint: shape metadata
_META_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "itemsize",
     "nbytes"}
)
_META_METHODS = frozenset(
    {"numel", "dim", "size", "element_size", "data_ptr", "stride",
     "is_contiguous", "get_device", "storage_offset", "nelement"}
)

# torch attributes (the first name after ``torch.``) whose calls return
# host objects, not tensors
_HOST_TORCH_ATTRS = frozenset(
    {"cuda", "backends", "profiler", "utils", "distributed", "library",
     "device", "dtype", "iinfo", "finfo", "is_tensor", "is_floating_point",
     "get_default_dtype", "manual_seed", "Generator", "Size",
     "no_grad", "inference_mode", "set_num_threads", "get_num_threads",
     "equal", "promote_types", "result_type", "can_cast"}
)

# torch calls whose ARGUMENTS are host-side (uploads) or shapes and fill
# scalars (constructors): their result is a tensor, their arguments carry
# no evidence.  The *_like variants take a tensor and are NOT here.
_UPLOAD_OR_CTOR = frozenset(
    {"tensor", "as_tensor", "from_numpy", "frombuffer", "asarray",
     "zeros", "ones", "full", "empty", "arange", "linspace", "eye",
     "randint", "randperm", "rand", "randn", "empty_strided"}
)

# methods whose result is a tensor whatever the receiver: names numpy
# arrays and Python objects do not share
_TENSOR_ONLY_METHODS = frozenset(
    {"to", "cuda", "contiguous", "index_select", "masked_select",
     "masked_fill", "unsqueeze", "narrow", "expand", "gather", "scatter",
     "scatter_add", "scatter_reduce", "index_add", "index_copy", "index_put",
     "index_fill", "long", "short", "byte", "half", "double", "clamp",
     "clamp_min", "clamp_max", "detach", "clone", "eq", "ne", "lt", "le",
     "gt", "ge", "logical_and", "logical_or", "logical_not", "bitwise_and",
     "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift",
     "bitwise_right_shift", "new_zeros", "new_full", "new_empty",
     "new_ones", "new_tensor", "permute", "bincount", "isin",
     "nonzero_static", "unique_consecutive", "count_nonzero", "flip"}
)


def _is_hot_path(path: str) -> bool:
    return any(d in _HOT_DIRS for d in Path(path).parts[:-1])


def _torch_attr(call: ast.Call) -> Optional[str]:
    """``X`` for a call rooted at ``torch.X...``, else None."""
    f = call.func
    chain = []
    while isinstance(f, ast.Attribute):
        chain.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name) and f.id == "torch" and chain:
        return chain[-1]
    return None


def _is_torch_call(call: ast.Call) -> bool:
    """A call rooted at ``torch`` whose RESULT is a tensor."""
    attr = _torch_attr(call)
    return attr is not None and attr not in _HOST_TORCH_ATTRS


def _is_nonzero_sync(call: ast.Call) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == "nonzero"
        and not any(kw.arg == "size" for kw in call.keywords)
    )


def _sink_kind(call: ast.Call) -> Optional[Tuple[str, ast.expr, bool]]:
    """``(description, synced value, result lives on the host)`` when
    *call* is one of the sync forms, else None."""
    f = call.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr in _SINK_NP_ATTRS
        and isinstance(f.value, ast.Name)
        and f.value.id == "np"
        and call.args
    ):
        return (f"np.{f.attr}(...)", call.args[0], True)
    if isinstance(f, ast.Name) and f.id in _SINK_BUILTINS and len(call.args) == 1:
        return (f"{f.id}(...)", call.args[0], True)
    if isinstance(f, ast.Attribute) and f.attr in _SINK_METHODS and not call.args:
        return (f".{f.attr}()", f.value, True)
    if _is_nonzero_sync(call):
        if _torch_attr(call) == "nonzero":
            if call.args:
                return ("torch.nonzero(...) without size=", call.args[0], False)
            return None
        return (".nonzero() without size=", f.value, False)
    return None


_TENSOR_ANNOTATIONS = frozenset(
    {"torch.Tensor", "Optional[torch.Tensor]", "torch.Tensor | None"}
)


def _names_tensor(annotation: Optional[ast.expr]) -> bool:
    """An annotation that says ``torch.Tensor`` (or ``Optional`` of it,
    also as a string); a sequence of tensors is not one."""
    if annotation is None:
        return False
    if isinstance(annotation, ast.Constant) and isinstance(annotation.value, str):
        text = annotation.value
    else:
        text = ast.unparse(annotation)
    return text.strip() in _TENSOR_ANNOTATIONS


def _tensor_fields(tree: ast.Module) -> Dict[str, Set[str]]:
    """``{class name: attributes its body annotates as torch.Tensor}``."""
    out: Dict[str, Set[str]] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        fields = {
            st.target.id
            for st in cls.body
            if isinstance(st, ast.AnnAssign)
            and isinstance(st.target, ast.Name)
            and _names_tensor(st.annotation)
        }
        if fields:
            out[cls.name] = fields
    return out


class _Taint:
    """Per-function tensor taint over simple assignments, run to a
    fixpoint: ``dev`` holds the names provably bound to torch tensors,
    ``fields`` the ``self`` attributes the enclosing class annotates as
    tensors."""

    def __init__(self, func: ast.AST, fields: Set[str] = frozenset()) -> None:
        self.dev: Set[str] = set()
        self.fields = fields
        a = func.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if _names_tensor(arg.annotation):
                self.dev.add(arg.arg)
        self._seed_evidence(func)
        self._fixpoint(func)

    def _seed_evidence(self, func: ast.AST) -> None:
        # names bound to shape metadata (`n = keys.shape[0]`) are host ints
        # everywhere: their appearance inside a torch call is no evidence
        meta_names: Set[str] = set()
        for sub in ast.walk(func):
            if isinstance(sub, ast.Assign) and self._is_meta(sub.value):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        meta_names.add(tgt.id)
        for sub in ast.walk(func):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            # isinstance(x, torch.Tensor) marks x as a tensor
            if (
                isinstance(f, ast.Name)
                and f.id == "isinstance"
                and len(sub.args) == 2
                and isinstance(sub.args[0], ast.Name)
                and "torch" in ast.unparse(sub.args[1])
            ):
                self.dev.add(sub.args[0].id)
                continue
            if not _is_torch_call(sub) or _torch_attr(sub) in _UPLOAD_OR_CTOR:
                continue
            for a in sub.args:
                # only BARE names (also inside arithmetic, comparisons,
                # lists and starred args), not attribute roots, and not
                # the host-side arguments of a nested upload/constructor
                skip = {
                    id(n.value) for n in ast.walk(a) if isinstance(n, ast.Attribute)
                }
                for n in ast.walk(a):
                    if isinstance(n, ast.Call) and (
                        _torch_attr(n) in _UPLOAD_OR_CTOR
                        or not (_is_torch_call(n))
                    ):
                        skip.update(id(m) for m in ast.walk(n) if isinstance(m, ast.Name))
                for n in ast.walk(a):
                    if (
                        isinstance(n, ast.Name)
                        and id(n) not in skip
                        and n.id not in meta_names
                    ):
                        self.dev.add(n.id)

    @staticmethod
    def _is_meta(e: ast.expr) -> bool:
        """Provably shape metadata: ``x.shape``, ``x.shape[0]``,
        ``x.numel()``, constants."""
        if isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Attribute):
            return e.attr in _META_ATTRS
        if isinstance(e, ast.Subscript):
            return _Taint._is_meta(e.value)
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute):
            return e.func.attr in _META_METHODS
        return False

    def dev_expr(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.dev
        if isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Attribute):
            if e.attr in _META_ATTRS:
                return False
            if (
                isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and e.attr in self.fields
            ):
                return True
            return self.dev_expr(e.value)
        if isinstance(e, ast.Call):
            sink = _sink_kind(e)
            if sink is not None:
                return not sink[2]  # .cpu(), int(), ... live on the host
            if _is_torch_call(e):
                # an upload or constructor with no device= makes a host
                # tensor: reading it back moves nothing
                return _torch_attr(e) not in _UPLOAD_OR_CTOR or any(
                    kw.arg == "device" for kw in e.keywords
                )
            f = e.func
            if isinstance(f, ast.Attribute):
                if f.attr in _META_METHODS:
                    return False
                if f.attr in _TENSOR_ONLY_METHODS:
                    return True
                return self.dev_expr(f.value)
            return False
        if isinstance(e, ast.Subscript):
            return self.dev_expr(e.value)
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(self.dev_expr(x) for x in e.elts)
        if isinstance(e, ast.BinOp):
            return self.dev_expr(e.left) or self.dev_expr(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.dev_expr(e.operand)
        if isinstance(e, ast.IfExp):
            return self.dev_expr(e.body) or self.dev_expr(e.orelse)
        if isinstance(e, ast.Starred):
            return self.dev_expr(e.value)
        if isinstance(e, ast.Compare):
            # tensor <op> x is itself a bool tensor
            return self.dev_expr(e.left) or any(
                self.dev_expr(c) for c in e.comparators
            )
        return False

    def _assign(self, target: ast.expr, is_dev: bool) -> bool:
        if isinstance(target, (ast.Tuple, ast.List)):
            changed = False
            for el in target.elts:
                changed |= self._assign(el, is_dev)
            return changed
        if isinstance(target, ast.Starred):
            return self._assign(target.value, is_dev)
        if isinstance(target, ast.Name) and is_dev and target.id not in self.dev:
            self.dev.add(target.id)
            return True
        return False

    def _fixpoint(self, func: ast.AST) -> None:
        for _ in range(8):  # chains are short; 8 rounds is generous
            changed = False
            for sub in ast.walk(func):
                if isinstance(sub, ast.Assign):
                    d = self.dev_expr(sub.value)
                    for tgt in sub.targets:
                        changed |= self._assign(tgt, d)
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)) and sub.value is not None:
                    changed |= self._assign(sub.target, self.dev_expr(sub.value))
            if not changed:
                return


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _calls_count_sync(func: ast.AST) -> bool:
    for sub in ast.walk(func):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "count_sync"
        ):
            return True
    return False


def _sync_findings(tree: ast.Module, path: str) -> Tuple[List[LintFinding], Set[str]]:
    """SYNC001 over one hot-path module: the findings, and the allowlist
    keys that matched (for the staleness check)."""
    findings: List[LintFinding] = []
    matched: Set[str] = set()
    fields = _tensor_fields(tree)
    owner = {
        id(m): cls.name
        for cls in ast.walk(tree)
        if isinstance(cls, ast.ClassDef)
        for m in cls.body
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    for func in _functions(tree):
        taint = _Taint(func, fields.get(owner.get(id(func)), frozenset()))
        accounted = _calls_count_sync(func)
        nested = [
            (s.lineno, getattr(s, "end_lineno", s.lineno))
            for s in ast.walk(func)
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) and s is not func
        ]
        for sub in ast.walk(func):
            if not isinstance(sub, ast.Call):
                continue
            if any(lo <= sub.lineno <= hi for lo, hi in nested):
                continue  # the nested def is linted as its own function
            sink = _sink_kind(sub)
            if sink is None:
                continue
            desc, arg, _host = sink
            if not taint.dev_expr(arg):
                continue
            key = _allow_key(path, func)
            if key in SYNC001_ALLOWED:
                matched.add(key)
                continue
            if accounted:
                continue  # count_sync in the same scope IS the ledger
            findings.append(
                LintFinding(
                    "SYNC001",
                    path,
                    sub.lineno,
                    f"implicit device->host sync: {desc} on a torch value "
                    f"in `{getattr(func, 'name', '?')}` — account it via "
                    "telemetry.count_sync in the same function, or pin "
                    "it in SYNC001_ALLOWED with its host_sync_elements "
                    "citation",
                )
            )
    return findings, matched


_TABLES = (
    ("SYNC001_ALLOWED", "SYNC001"),
    ("EAGER001_ALLOWED", "EAGER001"),
)


def _table(name: str) -> Dict[str, str]:
    return SYNC001_ALLOWED if name == "SYNC001_ALLOWED" else EAGER001_ALLOWED


def _cites_accounting(citation: str) -> bool:
    """A SYNC001 citation either opens with ``no transfer:`` (the site
    moves nothing) or says what it ``moves`` and where that lands in the
    ``host_sync_elements`` ledger (counted by ``count_sync`` or not)."""
    if citation.lstrip().startswith("no transfer:"):
        return True
    return "moves" in citation and any(
        tok in citation for tok in ("host_sync_elements", "count_sync")
    )


def _allowlist_findings(path: str) -> List[LintFinding]:
    """Per-file meta-rule: every allowlist entry for THIS file carries a
    written citation (a SYNC001 one names its accounting, or says why no
    transfer happens).  Staleness is a whole-tree property
    (:func:`allowlist_global_findings`)."""
    findings: List[LintFinding] = []
    base = Path(path).name
    for table_name, code in _TABLES:
        for key, citation in _table(table_name).items():
            if not key.startswith(base + ":"):
                continue
            if not citation.strip():
                findings.append(
                    LintFinding(
                        code,
                        path,
                        1,
                        f"{table_name} entry `{key}` has no written "
                        "citation — unexplained allowances fail lint",
                    )
                )
            elif code == "SYNC001" and not _cites_accounting(citation):
                findings.append(
                    LintFinding(
                        code,
                        path,
                        1,
                        f"{table_name} entry `{key}` must say what it moves "
                        "and cite its host_sync_elements / count_sync "
                        "accounting (or open with `no transfer:`)",
                    )
                )
    return findings


def allowlist_global_findings(matched: Set[Tuple[str, str]]) -> List[LintFinding]:
    """Whole-tree meta-rule: every allowlist entry matched a live site
    somewhere in the tree.  *matched* holds the ``(allowlist name, key)``
    pairs gathered over every linted file; a key nothing matched is stale
    (the site it blessed was removed or renamed, and it would silently
    bless a future one under the same name)."""
    findings: List[LintFinding] = []
    for table_name, code in _TABLES:
        for key in _table(table_name):
            if (table_name, key) not in matched:
                findings.append(
                    LintFinding(
                        code,
                        key.split(":", 1)[0],
                        1,
                        f"stale {table_name} entry `{key}`: no current "
                        "site matches it — remove the allowance",
                    )
                )
    return findings


def jitlint_findings(
    tree: ast.Module,
    path: str,
    matched_out: Optional[Set[Tuple[str, str]]] = None,
) -> List[LintFinding]:
    """All SYNC001 findings (and allowlist citation findings) for one
    parsed module.  *matched_out* (the whole-tree lint) accumulates the
    ``("SYNC001_ALLOWED", key)`` pairs this file matched."""
    findings: List[LintFinding] = []
    if _is_hot_path(path):
        sync, matched = _sync_findings(tree, path)
        findings.extend(sync)
        if matched_out is not None:
            matched_out |= {("SYNC001_ALLOWED", k) for k in matched}
    findings.extend(_allowlist_findings(path))
    return findings
