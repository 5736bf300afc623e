"""Record the calls a path makes to the two hand-written kernels and hold
each against the kernel's plain version, bitwise.

``chip_smoke.py`` wraps each path it drives on the card in
:func:`recorded_mask_calls` and :func:`recorded_pack_calls`, reads the
path's launch counts (``ops.mask.launches``, ``ops.parse.launches``),
then replays the records with :func:`check_path_masks` and
:func:`check_path_packs`; the chaos gate (``resilience/chaos.py``) does
the same around each case.  The wrappers are patched on their modules,
so every thread's calls are recorded, the serving dispatcher's too.

:func:`check_path_masks` calls the mask wrapper again on each recorded
input, so its launches are not the path's: read the path's count first.
:func:`check_path_packs` launches nothing: it compares the output each
recorded pack call returned."""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, List, Optional


def _stderr(msg: str) -> None:
    sys.stderr.write(msg + "\n")


def mask_vs_plain(cols, targets, nrows: int, mode: str, what: str) -> int:
    """The mask kernel's wrapper against its plain version on the same
    inputs; raises unless they are bitwise equal, else returns the max
    abs error (0)."""
    import torch

    from ..ops import mask as M

    got = M.fused_equality_mask(cols, targets, nrows, mode)
    want = M.fused_equality_mask_plain(cols, targets, mode)
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if nrows else 0
    if not torch.equal(got, want):
        raise AssertionError(f"mask kernel != plain at {what}")
    return err


@contextlib.contextmanager
def recorded_mask_calls(calls: Optional[List] = None):
    """Record the inputs of every call the filter makes to the mask
    kernel's wrapper inside the block (appended to *calls* when given);
    the wrapper still runs (and counts its launches) as usual."""
    from ..ops import filter as F

    calls = [] if calls is None else calls
    wrapper = F.fused_equality_mask

    def record(cols, targets, nrows, mode="all"):
        calls.append((list(cols), targets, nrows, mode))
        return wrapper(cols, targets, nrows, mode=mode)

    F.fused_equality_mask = record
    try:
        yield calls
    finally:
        F.fused_equality_mask = wrapper


def check_path_masks(calls, label: str, log: Callable[[str], None] = _stderr) -> dict:
    """Hold the wrapper against its plain version, bitwise, on the inputs
    of each recorded call: the path's own columns, targets and mode.  Run
    after the path's launch count was read, so these launches are not
    the path's.  Drops the records as it goes."""
    n_calls = len(calls)
    worst = 0
    shapes = set()
    while calls:
        cols, targets, nrows, mode = calls.pop()
        per_col = tuple(len(t) if isinstance(t, (list, tuple)) else 1 for t in targets)
        shape = f"n={nrows} k={len(cols)} {mode} targets={list(per_col)}"
        worst = max(worst, mask_vs_plain(cols, targets, nrows, mode, f"{label} {shape}"))
        shapes.add(shape)
    log(f"{label}: mask kernel == plain version, bitwise, in the path's {n_calls} "
        f"calls ({'; '.join(sorted(shapes))})")
    return {"cases": n_calls, "max_abs_err": worst}


@contextlib.contextmanager
def recorded_pack_calls(calls: Optional[List] = None):
    """Record the inputs and the output of every call the device encode
    makes to the pack kernel's wrapper inside the block (appended to
    *calls* when given); the wrapper still runs (and counts its launches)
    as usual.  The records hold the path's buffers until they are checked."""
    from ..ops import parse as P

    calls = [] if calls is None else calls
    wrapper = P.pack_field_lanes

    def record(data, starts, lens, lanes):
        out = wrapper(data, starts, lens, lanes)
        calls.append((data, starts, lens, lanes, out))
        return out

    P.pack_field_lanes = record
    try:
        yield calls
    finally:
        P.pack_field_lanes = wrapper


def check_path_packs(calls, label: str, launches: int, device: str,
                     log: Callable[[str], None] = _stderr) -> dict:
    """Hold what the pack kernel's wrapper returned in each recorded call
    against the plain version on the same inputs (the path's own buffers,
    strided columns and chunks), bitwise; on the card each call is one of
    the path's *launches*.  No kernel is launched here.  Drops the
    records as it goes."""
    import torch

    from ..ops import parse as P

    n_calls = len(calls)
    if device == "cuda" and n_calls != launches:
        raise AssertionError(f"{label}: {n_calls} recorded pack calls, {launches} launches")
    worst = 0
    shapes = set()
    while calls:
        data, starts, lens, lanes, out = calls.pop()
        want = P.pack_field_lanes_plain(data, starts, lens, lanes)
        if out.shape != want.shape or not torch.equal(out, want):
            raise AssertionError(f"{label}: pack kernel != plain at m={starts.shape[0]} "
                                 f"lanes={lanes}")
        if out.numel():
            worst = max(worst, int((out.to(torch.int64) - want.to(torch.int64)).abs().max()))
        shapes.add(lanes)
    log(f"{label}: pack kernel == plain version, bitwise, in the path's {n_calls} calls "
        f"(lanes {sorted(shapes)})")
    return {"cases": n_calls, "max_abs_err": worst}
