"""Atomic durability manifest for a :class:`MutableIndex` directory.

Port of ``csvplus_tpu/storage/manifest.py``; the document is the
reference's, byte for byte in its fields, so either package opens a
directory the other wrote.

``MANIFEST.json`` is the single source of truth for recovery: which
persisted base tier file is current, the newest LSN folded into it
(``applied_lsn``), the visibility mode and key columns, and the WAL
segments live at the last checkpoint.  It is replaced atomically —
write to a temp name, flush, fsync, ``os.replace``, fsync the directory
— so a reader either sees the old manifest or the new one, never a torn
in-between.  The ``storage:manifest-swap`` fault site brackets the
rename in ``MutableIndex._checkpoint`` (not here): hit 0 is the
post-merge/pre-rename crash window, hit 1 the post-rename/pre-WAL-drop
window; both recover to the same logical stream.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..errors import CsvPlusError

__all__ = ["MANIFEST_NAME", "ManifestError", "read_manifest", "write_manifest"]

MANIFEST_NAME = "MANIFEST.json"
_MAGIC = "csvplus-tpu-manifest"
_VERSION = 1


class ManifestError(CsvPlusError):
    """Missing, torn, or version-incompatible MANIFEST.json."""


def manifest_doc(
    *,
    mode: str,
    key_columns: Sequence[str],
    checkpoint: int,
    base: str,
    applied_lsn: int,
    segments: Sequence[str],
    prune: Optional[str] = None,
) -> Dict[str, object]:
    """Assemble the versioned manifest document.  ``prune`` names the
    base tier's fence/filter sidecar (``prune-%08d.flt``), or None when
    the checkpoint was taken with pruning disabled — recovery then
    rebuilds summaries by scan."""
    doc: Dict[str, object] = {
        "magic": _MAGIC,
        "version": _VERSION,
        "mode": mode,
        "key_columns": list(key_columns),
        "checkpoint": int(checkpoint),
        "base": base,
        "applied_lsn": int(applied_lsn),
        "segments": list(segments),
    }
    if prune is not None:
        doc["prune"] = prune
    return doc


def write_manifest(directory: str, doc: Dict[str, object]) -> str:
    """Atomically publish *doc* as the directory's manifest."""
    final = os.path.join(directory, MANIFEST_NAME)
    tmp = final + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return final


def read_manifest(directory: str) -> Dict[str, object]:
    """Load and validate the manifest; raises :class:`ManifestError`
    when the directory has none (or an unreadable one)."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise ManifestError(
            f"{directory}: no {MANIFEST_NAME} (not a durable MutableIndex "
            f"directory — create one with MutableIndex.create(..., "
            f"directory=...))"
        ) from None
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        raise ManifestError(f"{path}: unreadable manifest ({err})") from None
    if not isinstance(doc, dict) or doc.get("magic") != _MAGIC:
        raise ManifestError(f"{path}: not a csvplus-tpu manifest")
    if doc.get("version") != _VERSION:
        raise ManifestError(
            f"{path}: unsupported manifest version {doc.get('version')}"
        )
    for field in ("mode", "key_columns", "checkpoint", "base", "applied_lsn"):
        if field not in doc:
            raise ManifestError(f"{path}: manifest missing {field!r}")
    return doc


def stale_files(directory: str, doc: Dict[str, object]) -> List[str]:
    """Leftovers a crash may strand: ``*.tmp`` staging files and base
    tier files the manifest no longer references.  WAL segments are NOT
    listed — the WAL's own ``drop_applied`` owns their lifecycle."""
    keep = {MANIFEST_NAME, str(doc["base"])}
    if doc.get("prune"):
        keep.add(str(doc["prune"]))
    out: List[str] = []
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            out.append(name)
        elif name.startswith("base-") and name not in keep:
            out.append(name)
        elif name.startswith("prune-") and name not in keep:
            out.append(name)
    return sorted(out)


def remove_stale(directory: str, doc: Dict[str, object]) -> List[str]:
    """Delete crash leftovers (janitor half of recovery); returns what
    was removed."""
    removed = stale_files(directory, doc)
    for name in removed:
        os.unlink(os.path.join(directory, name))
    if removed:
        fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return removed
