"""Byte-exact Go ``encoding/json`` string/object encoding.

A copy of ``csvplus_tpu/utils/gojson.py``.

The reference's JSON sink (csvplus.go:446-475) uses a ``json.Encoder``
with ``SetIndent("", "")`` (compact) and — crucially —
``SetEscapeHTML(false)`` (csvplus.go:456), so ``&``, ``<`` and ``>``
pass through **unescaped**.  The remaining differences between Go's
encoder and Python's ``json.dumps(..., ensure_ascii=False)`` are:

* Go emits ``\\u0008`` / ``\\u000c`` for backspace / form-feed where
  Python uses the ``\\b`` / ``\\f`` shorthands;
* Go always escapes U+2028 / U+2029 (JS line separators) as
  ``\\u2028`` / ``\\u2029``; Python leaves them literal.

Everything else matches: ``\\"``, ``\\\\``, ``\\n``, ``\\r``, ``\\t``,
other control bytes as lowercase ``\\u00xx``, and non-ASCII passed
through as UTF-8.  This module implements the Go byte format exactly so
both JSON sinks (streaming and vectorized) are byte-identical to the
reference's output.
"""

from __future__ import annotations

import json

# char-ordinal -> escape sequence, exactly Go's encodeState.string
_GO_ESCAPES = {
    ord('"'): '\\"',
    ord("\\"): "\\\\",
    ord("\n"): "\\n",
    ord("\r"): "\\r",
    ord("\t"): "\\t",
    0x2028: "\\u2028",
    0x2029: "\\u2029",
}
for _c in range(0x20):
    _GO_ESCAPES.setdefault(_c, f"\\u{_c:04x}")


def go_json_string(s: str) -> str:
    """*s* as a Go-encoder JSON string literal (quotes included)."""
    return '"' + s.translate(_GO_ESCAPES) + '"'


def go_json_object(row) -> str:
    """A ``map[string]string`` as Go's encoder emits it: sorted keys,
    compact separators, Go string escaping.  Non-string values (not
    producible by the reference API, but possible via Python callbacks)
    fall back to ``json.dumps``."""
    parts = []
    for k in sorted(row):
        v = row[k]
        ev = (
            go_json_string(v)
            if isinstance(v, str)
            else json.dumps(v, ensure_ascii=False, sort_keys=True, separators=(",", ":"))
        )
        parts.append(go_json_string(k) + ":" + ev)
    return "{" + ",".join(parts) + "}"
