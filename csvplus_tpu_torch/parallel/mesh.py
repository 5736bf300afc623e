"""A single-process mesh of torch devices, row-sharded values and the
collectives the partitioned probe and the sample sort need.

Port of ``csvplus_tpu/parallel/mesh.py``.  The reference is
single-controller: one Python process drives every device of a
``jax.sharding.Mesh``, and its multi-device kernels run one body per
shard under ``shard_map`` with ``lax.all_to_all`` inside.  The
counterpart here is single-process too: a :class:`Mesh` is an ordered
list of ``torch.device``s with a shape and axis names, a
:class:`ShardedRows` holds one tensor per shard, and the collectives
(:func:`all_to_all`, :func:`all_gather`, :func:`psum`) move per-shard
blocks between those devices.  The kernels run each per-shard body as
phases across all shards, with an exchange between phases.

A mesh may name one device several times (``devices=["cuda:0"] * 8``):
eight shards then share one card, and every route, exchange and retry
runs there at full size.  That is how the tests run on the CPU
(``devices=["cpu"] * 8``) and how ``chip_smoke.py`` runs on one card.
Nothing here falls back to another device: ``make_mesh(n)`` with no
``devices=`` takes ``cuda:0`` .. ``cuda:n-1`` and raises when fewer cards
are visible.

One flat data axis (:data:`AXIS`) is the natural mesh for a columnar
engine; :func:`make_mesh_2d` adds an outer :data:`SLICE_AXIS`, and rows
then split over both axes, slice-major (the reference's ``row_spec``).
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS = "shards"

#: Sharded arrays assembled onto one device in this process: ``count``
#: assemblies and their ``bytes`` — added where :func:`assemble` copies,
#: nowhere else.  The reference's own semantics put a whole array on one
#: device at a few places (the replicated sort, the flagship's
#: compaction, the rarer plan nodes); every other stage runs per shard.
#: ``chip_smoke.py`` and the tests read it.
assemblies: Counter = Counter()


def _resolve_device(device):
    from ..columnar.table import resolve_device as _resolve

    return _resolve(device)
SLICE_AXIS = "slice"


class Mesh:
    """Devices in flat shard order (slice-major on a 2-D mesh), the mesh
    shape and its axis names."""

    def __init__(self, devices: Sequence, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.devices: Tuple[torch.device, ...] = tuple(_resolve_device(d) for d in devices)
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if int(np.prod(self.shape)) != len(self.devices) or not self.devices:
            raise ValueError(f"mesh shape {self.shape} does not fit {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in first-shard order."""
        return list(dict.fromkeys(self.devices))

    def on(self, shard: int):
        """Context for work on *shard*'s device: the current CUDA device
        is per thread, so work on another card runs under
        ``torch.cuda.device``."""
        dev = self.devices[shard]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, {[str(d) for d in self.devices]})"


def _default_devices(n: Optional[int], what: str) -> List[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n is None else int(n)
    if n < 1 or n > count:
        raise RuntimeError(
            f"{what}: {n} devices requested but {count} CUDA cards are visible; pass "
            f"devices= to place several shards on one device (e.g. devices=['cuda:0'] * {n})"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over *devices* (the first *n_devices* of them), or over
    ``cuda:0`` .. ``cuda:n-1`` when no devices are given (default: every
    visible card)."""
    if devices is None:
        devices = _default_devices(n_devices, "make_mesh")
    else:
        devices = list(devices)
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"make_mesh: {n_devices} shards requested, {len(devices)} devices given")
            devices = devices[:n_devices]
    return Mesh(devices, (len(devices),), (AXIS,))


def make_mesh_2d(n_slices: int, chips_per_slice: int, devices: Optional[Sequence] = None) -> Mesh:
    """A (slice, chip) mesh: the outer axis models the links between
    slices, the inner one the links within a slice.  Rows split over both
    axes, slice-major."""
    n = n_slices * chips_per_slice
    if devices is None:
        devices = _default_devices(n, "make_mesh_2d")
    elif len(devices) < n:
        raise ValueError(f"make_mesh_2d: {n} shards requested, {len(devices)} devices given")
    return Mesh(list(devices)[:n], (n_slices, chips_per_slice), (SLICE_AXIS, AXIS))


class ShardedRows:
    """A row-sharded 1-D array: one tensor per shard, in flat shard order,
    each on its shard's device.  The logical array is their
    concatenation; shards may differ in length (an un-padded tail)."""

    def __init__(self, mesh: Mesh, shards: Sequence[torch.Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.mesh = mesh
        self.shards: Tuple[torch.Tensor, ...] = tuple(shards)

    @property
    def nrows(self) -> int:
        return sum(int(s.shape[0]) for s in self.shards)

    @property
    def shape(self) -> Tuple[int]:
        return (self.nrows,)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __len__(self) -> int:
        return self.nrows

    def numpy(self) -> np.ndarray:
        """The logical array on the host."""
        return np.concatenate([s.cpu().numpy() for s in self.shards])

    def gather(self, device=None) -> torch.Tensor:
        """The logical array as one tensor on *device* (default: the
        first shard's)."""
        dev = self.mesh.devices[0] if device is None else _resolve_device(device)
        return torch.cat([s.to(dev) for s in self.shards])

    @property
    def lens(self) -> List[int]:
        """Rows per shard."""
        return [int(s.shape[0]) for s in self.shards]

    def offsets(self) -> List[int]:
        """Logical position of each shard's first row."""
        out, acc = [], 0
        for n in self.lens:
            out.append(acc)
            acc += n
        return out

    def map(self, fn, *args) -> "ShardedRows":
        """``fn(shard, *args_i)`` per shard, under that shard's device:
        see :func:`smap`."""
        return smap(self.mesh, fn, self, *args)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))  # the caller may reuse its array


def split_even(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Blocks ``x[i*q:(i+1)*q]`` on shard i's device; a block already on
    its device is a view, not a copy."""
    q = int(x.shape[0]) // mesh.size
    return [x[i * q:(i + 1) * q].to(dev) for i, dev in enumerate(mesh.devices)]


def shard_rows(mesh: Mesh, x) -> ShardedRows:
    """Place *x* (a tensor or numpy array) row-sharded over the mesh.
    The rows must split evenly: the caller pads to a mesh multiple, as
    the reference's row sharding requires."""
    t = _as_tensor(x)
    if int(t.shape[0]) % mesh.size:
        raise ValueError(
            f"shard_rows: {int(t.shape[0])} rows do not split evenly over {mesh.size} shards; "
            "pad to a multiple of the mesh size")
    return ShardedRows(mesh, split_even(mesh, t))


def relayout(mesh: Mesh, x, lens: Sequence[int], fill: int = 0) -> List[torch.Tensor]:
    """The logical array *x* (a tensor, a :class:`ShardedRows`, or a list
    of tensors in row order, each on any device) cut into blocks of
    *lens* rows, block i on shard i's device; past the end of
    *x* the blocks fill with *fill*.  Each block is stitched from the
    pieces of *x* that overlap its range, so no full copy of *x* lands on
    one device, and a block that is already one piece on its device is
    that piece (a view, no copy)."""
    if isinstance(x, ShardedRows):
        pieces = list(zip(x.offsets(), x.shards))
    elif isinstance(x, (list, tuple)):  # arrays in row order, anywhere
        offs = np.cumsum([0] + [int(a.shape[0]) for a in x])
        pieces = list(zip(offs.tolist(), x))
    else:
        pieces = [(0, x)]
    dtype = pieces[0][1].dtype
    out = []
    t0 = 0
    for dev, n in zip(mesh.devices, lens):
        t1 = t0 + int(n)
        parts = []
        for gs, arr in pieces:
            ge = gs + int(arr.shape[0])
            lo, hi = max(gs, t0), min(ge, t1)
            if lo < hi:
                parts.append(arr[lo - gs:hi - gs].to(dev))
        got = sum(int(p.shape[0]) for p in parts)
        if got < n:
            parts.append(torch.full((int(n) - got,), fill, dtype=dtype, device=dev))
        if not parts:
            parts.append(torch.empty(0, dtype=dtype, device=dev))
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        t0 = t1
    return out


def block_lens(mesh: Mesh, n: int) -> List[int]:
    """The reference's row-sharded block layout of *n* rows: ``ceil(n /
    k)`` rows on every shard, the tail padded."""
    b = -(-int(n) // mesh.size)
    return [b] * mesh.size


def even_blocks(mesh: Mesh, x, fill: int) -> Tuple[List[torch.Tensor], int]:
    """Per-shard blocks of the logical array *x* (a tensor or
    :class:`ShardedRows`), padded at the end with *fill* to a mesh
    multiple, and its length.  A sharded array is re-cut shard to shard
    (:func:`relayout`): shards already in place are used as they are."""
    if isinstance(x, ShardedRows):
        m = x.nrows
        return relayout(mesh, x, block_lens(mesh, m), fill), m
    m = int(x.shape[0])
    pad = (-m) % mesh.size
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype, device=x.device)])
    return split_even(mesh, x), m


def unpad(shards: Sequence[torch.Tensor], m: int) -> List[torch.Tensor]:
    """The first *m* rows of an evenly sharded array padded at the end:
    the tail shards lose the padding."""
    q = int(shards[0].shape[0])
    return [s[: max(0, min(q, m - i * q))] for i, s in enumerate(shards)]


def smap(mesh: Mesh, fn, *args) -> ShardedRows:
    """``fn(*args_i)`` for every shard i, under shard i's device, as a
    :class:`ShardedRows`: a :class:`ShardedRows` argument gives its shard
    i, a tuple from :func:`replicate` its element i, any other argument
    passes as it is.  A tuple result gives a tuple of ShardedRows."""
    outs = []
    for i in range(mesh.size):
        sub = [a.shards[i] if isinstance(a, ShardedRows)
               else a[i] if isinstance(a, Replicated) else a for a in args]
        with mesh.on(i):
            outs.append(fn(*sub))
    if isinstance(outs[0], tuple):
        return tuple(ShardedRows(mesh, list(col)) for col in zip(*outs))
    return ShardedRows(mesh, outs)


class Replicated(tuple):
    """One tensor per shard of a mesh, the same values on every shard: one
    copy per distinct device (:func:`replicate`)."""


def assemble(x, device=None) -> torch.Tensor:
    """The logical array of *x* as one tensor on *device* (default: the
    first shard's), counted in :data:`assemblies` and, while telemetry
    collects, as the ``shard.assemble`` / ``shard.assemble_bytes``
    counters.  A plain tensor passes through."""
    if not isinstance(x, ShardedRows):
        return x if device is None else x.to(_resolve_device(device))
    from ..utils.observe import telemetry

    out = x.gather(device)
    nbytes = int(out.numel()) * out.element_size()
    assemblies["count"] += 1
    assemblies["bytes"] += nbytes
    telemetry.count("shard.assemble", 1)
    telemetry.count("shard.assemble_bytes", nbytes)
    return out


def replicate(mesh: Mesh, x) -> Tuple[torch.Tensor, ...]:
    """*x* on every shard's device: one copy per DISTINCT device (shards
    that share a card share one tensor), and none where *x* already lies.
    A :class:`ShardedRows` *x* is assembled once on each distinct device,
    and each of those copies counts as an :func:`assemble`."""
    if isinstance(x, ShardedRows):
        per_device = {dev: assemble(x, dev) for dev in mesh.distinct_devices}
    else:
        t = _as_tensor(x)
        per_device = {dev: t.to(dev) for dev in mesh.distinct_devices}
    return Replicated(per_device[dev] for dev in mesh.devices)


def all_to_all(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)`` over the
    whole mesh: *blocks[s]* is shard s's ``(N, ...)`` send buffer; shard d
    receives block d of every source, stacked in flat source order.  A
    copy between two cards is ordered against both cards' current
    streams (``Tensor.copy_``)."""
    n = mesh.size
    devs = mesh.devices
    if len(set(devs)) > 1:
        return _all_to_all_pairs(mesh, blocks)
    # one device: the exchange is a transpose of (source, dest) into one
    # buffer, one strided copy per source
    out = torch.empty((n, n) + tuple(blocks[0].shape[1:]), dtype=blocks[0].dtype, device=devs[0])
    for s in range(n):
        out[:, s].copy_(blocks[s])
    return list(out.unbind(0))


def _all_to_all_pairs(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`all_to_all` over several devices: one receive buffer per
    shard on its device, one copy per (source, destination) pair."""
    n = mesh.size
    devs = mesh.devices
    tail = tuple(blocks[0].shape[1:])
    recv = []
    for d in range(n):
        out = torch.empty((n,) + tail, dtype=blocks[0].dtype, device=devs[d])
        for s in range(n):
            out[s].copy_(blocks[s][d])
        recv.append(out)
    return recv


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``lax.all_gather(tiled=True)`` of small per-shard arrays: their
    concatenation in flat shard order, on every shard's device (one copy
    per distinct device)."""
    dev0 = mesh.devices[0]
    pool = torch.cat([p.to(dev0) for p in parts])
    return replicate(mesh, pool)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """``lax.psum`` over one named axis: each shard gets the sum of the
    parts of the shards that differ from it only along *axis*."""
    k = mesh.axis_names.index(axis)
    coords = [np.unravel_index(i, mesh.shape) for i in range(mesh.size)]
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(coords):
        groups.setdefault(tuple(v for j, v in enumerate(c) if j != k), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for members in groups.values():
        for i in members:
            dev = mesh.devices[i]
            total = parts[members[0]].to(dev)
            for j in members[1:]:
                total = total + parts[j].to(dev)
            out[i] = total
    return out
