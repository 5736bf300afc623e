"""Environment knobs: the one parser of the package's tuning variables,
escape hatches and string settings (the fault plan, the flight
recorder's directory)."""

from __future__ import annotations

import os
from typing import Mapping, Optional


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


def env_str(name: str, default: Optional[str] = None,
            env: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """A string knob's raw value, or *default* when unset; *env* stands
    in for ``os.environ`` (the fault plan's explicit mapping)."""
    source = os.environ if env is None else env
    return source.get(name, default)
