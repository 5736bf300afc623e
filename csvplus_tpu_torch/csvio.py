"""CSV record parsing and writing with the reference's exact semantics.

The reference delegates to Go's ``encoding/csv`` (csvplus.go:1091-1097);
Python's stdlib ``csv`` differs in comment handling, field-count policy and
error strictness, so this module implements the Go behavior directly:

* records end at ``\\n`` or ``\\r\\n``; quoted fields may span lines;
* fully blank lines are skipped; a line whose first character equals the
  comment char is skipped (checked only at record start);
* RFC-4180 quoting with ``""`` doubling; without *lazy_quotes* a bare ``"``
  in an unquoted field or a stray ``"`` in a quoted field is an error with
  Go's exact messages (``bare \" in non-quoted field`` /
  ``extraneous or missing \" in quoted-field``);
* *trim_leading_space* skips leading white space in each field;
* field-count policy is enforced by the caller
  (:mod:`csvplus_tpu_torch.reader`) with Go's ``wrong number of fields``
  message.

A copy of ``csvplus_tpu/csvio.py``: the port keeps its own copy of every
host module it needs, so it never imports the JAX package.  This
pure-Python parser is the specification of the native scanner
(:mod:`csvplus_tpu_torch.native.scanner`) and the device ingest's last
tier, taken only where the native tiers decline.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, TextIO

from .errors import CsvPlusError

ERR_BARE_QUOTE = 'bare " in non-quoted field'
ERR_QUOTE = 'extraneous or missing " in quoted-field'
ERR_FIELD_COUNT = "wrong number of fields"


class CsvParseError(CsvPlusError):
    """A malformed CSV construct; message matches Go's csv.ParseError.Err."""


def _is_space(c: str) -> bool:
    return c.isspace() and c not in "\r\n"


def parse_records(
    stream: TextIO,
    delimiter: str = ",",
    comment: Optional[str] = None,
    lazy_quotes: bool = False,
    trim_leading_space: bool = False,
) -> Iterator[List[str]]:
    """Yield one record (list of field strings) at a time from *stream*."""
    if len(delimiter) != 1:
        raise ValueError("csv delimiter must be a single character")
    if comment is not None and len(comment) != 1:
        raise ValueError("csv comment char must be a single character")

    # Split records strictly at '\n' like Go's csv reader: Python streams
    # opened with newline='' (and some user-supplied streams) treat a lone
    # '\r' as a line ending, which would corrupt fields containing bare
    # carriage returns — re-join such fragments.
    def _lf_lines():
        buf = []
        while True:
            piece = stream.readline()
            if piece == "":
                if buf:
                    yield "".join(buf)
                return
            buf.append(piece)
            if piece.endswith("\n"):
                yield "".join(buf)
                buf = []

    _gen = _lf_lines()

    def readline() -> str:
        return next(_gen, "")

    while True:
        line = readline()
        if line == "":
            return  # EOF
        # record start: skip comment lines and blank lines
        if comment is not None and line.startswith(comment):
            continue
        if line in ("\n", "\r\n"):
            continue
        yield _parse_one(line, readline, delimiter, lazy_quotes, trim_leading_space)


def _strip_eol(line: str) -> "tuple[str, bool]":
    """Remove a trailing record terminator; returns (body, had_terminator)."""
    if line.endswith("\r\n"):
        return line[:-2], True
    if line.endswith("\n"):
        return line[:-1], True
    return line, False


def _parse_one(
    line: str,
    readline,
    delimiter: str,
    lazy_quotes: bool,
    trim_leading_space: bool,
) -> List[str]:
    fields: List[str] = []
    body, _ = _strip_eol(line)
    pos = 0

    while True:  # one field per loop
        if trim_leading_space:
            while pos < len(body) and _is_space(body[pos]):
                pos += 1

        if pos < len(body) and body[pos] == '"':
            # ---- quoted field -------------------------------------------
            pos += 1
            buf: List[str] = []
            while True:
                if pos >= len(body):
                    # quoted field continues on the next line
                    nxt = readline()
                    if nxt == "":
                        if lazy_quotes:
                            fields.append("".join(buf))
                            return fields
                        raise CsvParseError(ERR_QUOTE)
                    nxt_body, _ = _strip_eol(nxt)
                    buf.append("\n")  # the line break is part of the field
                    body, pos = nxt_body, 0
                    continue
                c = body[pos]
                if c == '"':
                    if pos + 1 < len(body) and body[pos + 1] == '"':
                        buf.append('"')  # doubled quote -> literal
                        pos += 2
                        continue
                    # closing quote: must be followed by delimiter or EOL
                    pos += 1
                    if pos >= len(body):
                        fields.append("".join(buf))
                        return fields
                    if body[pos] == delimiter:
                        fields.append("".join(buf))
                        pos += 1
                        break  # next field
                    if lazy_quotes:
                        buf.append('"')
                        continue
                    raise CsvParseError(ERR_QUOTE)
                buf.append(c)
                pos += 1
        else:
            # ---- unquoted field -----------------------------------------
            start = pos
            while pos < len(body) and body[pos] != delimiter:
                if body[pos] == '"' and not lazy_quotes:
                    raise CsvParseError(ERR_BARE_QUOTE)
                pos += 1
            fields.append(body[start:pos])
            if pos >= len(body):
                return fields
            pos += 1  # skip delimiter; next field


# ---------------------------------------------------------------------------
# writer — Go csv.Writer semantics (default settings, UseCRLF=false)
# ---------------------------------------------------------------------------


def _field_needs_quotes(field: str, delimiter: str) -> bool:
    if field == "":
        return False
    if field == "\\.":
        return True  # Postgres end-of-data marker, quoted by Go too
    if delimiter in field or '"' in field or "\r" in field or "\n" in field:
        return True
    return field[0].isspace()


def write_record(out, fields: List[str], delimiter: str = ",") -> None:
    """Write one CSV record in Go csv.Writer's canonical form."""
    parts: List[str] = []
    for f in fields:
        if _field_needs_quotes(f, delimiter):
            parts.append('"' + f.replace('"', '""') + '"')
        else:
            parts.append(f)
    out.write(delimiter.join(parts))
    out.write("\n")
