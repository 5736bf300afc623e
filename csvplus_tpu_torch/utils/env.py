"""Environment knobs: the one parser of the package's tuning variables
and escape hatches."""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """An int tuning knob; a malformed value gives *default* (a typo
    never aborts an ingest), as in the reference."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_flag(name: str) -> bool:
    """An on-by-default switch: only the value ``0`` turns it off."""
    return os.environ.get(name, "1") != "0"
