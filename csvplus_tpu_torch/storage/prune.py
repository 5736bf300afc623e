"""Per-tier key fences + fingerprint filters: host-side LSM read pruning.

Port of ``csvplus_tpu/storage/prune.py``: the same hashes, filters and
sidecar format, so either package loads the other's ``prune-*.flt``.

The read-amplification cliff: without pruning every point probe against
a :class:`~csvplus_tpu_torch.storage.lsm.MutableIndex` pays one
``bounds_many`` pass PER TIER, so lookups collapse once a write burst
leaves a hundred live deltas behind.  Classic LSM read-path design
(per-run fences + Bloom filters, as in the Monkey/Dostoevsky line of
work) fixes this: at delta-seal time the encode path already holds the
packed keys, so we pay a few bits per key once and afterwards every
probe consults host-side summaries to shortlist the 1-3 tiers that can
actually contain the key before any per-tier bounds pass runs.

Two summaries per sealed tier (:class:`TierPruner`):

* **fences** — the tier's min and max full key tuple (rows are sorted,
  so these are row 0 and row n-1).  Exact for every probe width: a
  prefix probe ``p`` can match only when ``lo[:k] <= p <= hi[:k]``.
* **filter** — a seeded deterministic Bloom filter over the full-width
  keys (``CSVPLUS_LSM_FILTER_BITS`` bits/key, default 10, ``0`` means
  fences only).  Double hashing ``g_i = h1 + i*h2 (mod m)`` from one
  64-bit FNV-1a fold of per-column ``crc32`` values — the same
  arithmetic scalar (probe) and vectorized (build) side, so a present
  key can NEVER be filtered out.  Filters answer full-width probes
  only; prefix probes rely on fences.

Parity is structural, not statistical: both summaries are one-sided.  A
fence or filter rejection proves the tier holds no match, so pruning a
tier is observationally identical to probing it and reading back the
empty bounds ``(0, 0)`` — false positives cost one redundant bounds
pass and nothing else.  Everything here is plain host numpy (the DPG
cache-conscious-index lesson, arxiv cs/0308004): no device work, so
pruning never builds a kernel and never perturbs device state.

:class:`PruneDirectory` aggregates one TierSet's pruners into
concatenated numpy arrays so a probe batch tests EVERY tier's filter in
one vectorized pass instead of a Python loop over 139 tiers.

Sidecars: :func:`write_pruner` / :func:`load_pruner` persist the
summaries next to a checkpointed base (``prune-%08d.flt``, named in the
manifest) with the storage durability idiom — write tmp, fsync,
``os.replace``, directory fsync — so :meth:`MutableIndex.open` reloads
them without a rebuild scan.  A missing or corrupt sidecar degrades to
an in-memory rebuild, never to wrong answers.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.env import env_int, env_str

__all__ = [
    "DEFAULT_BITS_PER_KEY",
    "PruneDirectory",
    "TierPruner",
    "build_pruner",
    "filter_bits_per_key",
    "filter_seed",
    "load_pruner",
    "probe_hashes",
    "prune_enabled",
    "write_pruner",
]

_MASK64 = (1 << 64) - 1
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = np.uint64

DEFAULT_BITS_PER_KEY = 10
_MAX_HASHES = 6  # ln(2)*bits_per_key capped: k>6 buys <0.1% FPR
_SMALL_BATCH = 8  # below this, fence-first scalar checks beat the broadcast

_SIDECAR_MAGIC = "csvplus-tpu-prune"
_SIDECAR_VERSION = 1


def prune_enabled() -> bool:
    """``CSVPLUS_LSM_PRUNE`` — default on; ``0``/``off``/``false`` kills
    fence+filter pruning entirely (the bitwise-parity escape hatch the
    property tests diff against)."""
    return (env_str("CSVPLUS_LSM_PRUNE", "1") or "1").lower() not in (
        "0",
        "off",
        "false",
    )


def filter_bits_per_key() -> int:
    """``CSVPLUS_LSM_FILTER_BITS`` (default 10; 0 = fences only)."""
    return max(0, env_int("CSVPLUS_LSM_FILTER_BITS", DEFAULT_BITS_PER_KEY))


def filter_seed() -> int:
    """``CSVPLUS_LSM_FILTER_SEED`` — crc32 seed, fixed per process so
    every tier of one index hashes identically (the directory's
    vectorized pass requires a shared seed)."""
    return env_int("CSVPLUS_LSM_FILTER_SEED", 0x5EED) & 0xFFFFFFFF


def _n_hashes(bits_per_key: int) -> int:
    return max(1, min(_MAX_HASHES, int(round(bits_per_key * 0.6931))))


def _value_bytes(v) -> bytes:
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, bytes):
        return v
    return str(v).encode("utf-8")


def probe_hashes(values: Sequence, seed: int) -> Tuple[int, int]:
    """``(h1, h2)`` for one full-width key tuple.

    EXACTLY the arithmetic of the vectorized build path (FNV-1a fold
    over per-column ``crc32(utf8, seed)``, wrapped at 64 bits) — the
    no-false-negative guarantee rests on this equality, which
    tests/test_prune.py checks value-by-value.  Python-int arithmetic
    masked to 64 bits: identical mod 2**64 to numpy's silent uint64
    wraparound without the scalar overflow warnings."""
    h = _FNV_OFFSET
    for v in values:
        c = zlib.crc32(_value_bytes(v), seed) & 0xFFFFFFFF
        h = ((h ^ c) * _FNV_PRIME) & _MASK64
    return h & 0xFFFFFFFF, (h >> 32) | 1


def _probe_filterable(probe: Sequence) -> bool:
    # NUL bytes round-trip ambiguously through numpy 'S' dictionaries
    # (trailing-null truncation); skip the filter for such probes rather
    # than reason about encoder behavior.  Fences skip them too.
    for v in probe:
        if isinstance(v, str):
            if "\x00" in v:
                return False
        elif isinstance(v, bytes):
            if b"\x00" in v:
                return False
    return True


class TierPruner:
    """Fences + filter for ONE sorted tier.  Immutable after build."""

    __slots__ = (
        "nrows",
        "fence_lo",
        "fence_hi",
        "bits",
        "m",
        "k",
        "seed",
        "bits_per_key",
    )

    def __init__(
        self,
        nrows: int,
        fence_lo: Optional[Tuple],
        fence_hi: Optional[Tuple],
        bits: Optional[np.ndarray],
        m: int,
        k: int,
        seed: int,
        bits_per_key: int,
    ):
        self.nrows = nrows
        self.fence_lo = fence_lo  # full-width key tuples, or None
        self.fence_hi = fence_hi
        self.bits = bits  # packed uint8 bitset ((m+7)//8 bytes), or None
        self.m = m
        self.k = k
        self.seed = seed
        self.bits_per_key = bits_per_key

    def fence_excludes(self, probe: Sequence) -> bool:
        """True when the [min, max] key fence PROVES no row of this tier
        can match the (possibly prefix) probe.  Conservative: no fence,
        empty probe, or un-orderable values -> False (cannot prune)."""
        if self.nrows == 0:
            return True
        lo, hi = self.fence_lo, self.fence_hi
        if lo is None or not probe:
            return False
        k = len(probe)
        p = tuple(probe)
        if not _probe_filterable(p):
            return False
        try:
            return p < lo[:k] or p > hi[:k]
        except TypeError:
            return False  # mixed-type keys: no total order, never prune

    def filter_excludes(self, h1: int, h2: int) -> bool:
        """True when the Bloom filter proves the full-width key is
        absent.  Callers hash via :func:`probe_hashes` with this
        pruner's seed."""
        bits = self.bits
        if bits is None:
            return False
        m = self.m
        for i in range(self.k):
            pos = (h1 + i * h2) % m
            if not (bits[pos >> 3] >> (pos & 7)) & 1:
                return True
        return False

    def can_contain(self, probe: Sequence, width: int) -> bool:
        """Scalar reference predicate (the vectorized
        :meth:`PruneDirectory.pass_matrix` must agree with this — the
        property tests diff them)."""
        if self.nrows == 0:
            return False
        if self.fence_excludes(probe):
            return False
        if (
            len(probe) == width
            and self.bits is not None
            and _probe_filterable(probe)
        ):
            h1, h2 = probe_hashes(probe, self.seed)
            if self.filter_excludes(h1, h2):
                return False
        return True


# -- build ----------------------------------------------------------------


def _fence_of(impl, key_columns: Sequence[str]):
    """(lo, hi) full key tuples of a SORTED tier: rows 0 and n-1.

    Device-lazy tiers read the two fence keys from each key column's
    cached host dictionary + code mirror (two scalar lookups, zero
    device dispatch); columns without a host dictionary fall back to
    decoding exactly those two rows — never the whole table."""
    n = len(impl)
    if impl._rows is None and impl.dev is not None:
        table = impl.dev.table
        lo_vals: list = []
        hi_vals: list = []
        for c in key_columns:
            col = table.columns.get(c)
            d = getattr(col, "_dictionary", None) if col is not None else None
            if d is None or d.dtype.kind != "S":
                # lane-only or non-string dictionary: decode just the
                # two fence rows through the device path.
                sel = np.asarray([0, n - 1] if n > 1 else [0], dtype=np.int64)
                rows = table.to_rows(sel)
                first, last = rows[0], rows[-1]
                lo_vals = [first[k] for k in key_columns]
                hi_vals = [last[k] for k in key_columns]
                break
            # host mirror path: two scalar dictionary lookups, no
            # device dispatch and no full-row decode.
            codes = col.codes_host()
            lo_vals.append(d[int(codes[0])].decode("utf-8"))
            hi_vals.append(d[int(codes[n - 1])].decode("utf-8"))
        lo = tuple(lo_vals)
        hi = tuple(hi_vals)
    else:
        rows = impl.rows
        first, last = rows[0], rows[-1]
        lo = tuple(first[c] for c in key_columns)
        hi = tuple(last[c] for c in key_columns)
    if not (_probe_filterable(lo) and _probe_filterable(hi)):
        return None, None
    return lo, hi


def _row_hashes(impl, key_columns: Sequence[str], seed: int):
    """Per-row 64-bit key hashes, or None when hashing would force an
    unbounded host materialization (lane-only dictionaries).

    Device tiers hash each column's dictionary ONCE (it is tiny next to
    the row count) and gather by host-mirrored codes; host tiers fold
    row values directly.  Both paths produce bit-identical hashes to
    :func:`probe_hashes`."""
    n = len(impl)
    if impl._rows is None and impl.dev is not None:
        table = impl.dev.table
        h = np.full(n, _FNV_OFFSET, dtype=_U64)
        with np.errstate(over="ignore"):
            for c in key_columns:
                col = table.columns[c]
                if col._dictionary is None:
                    # lane-only column: .dictionary would unpack the
                    # whole dictionary to host — bounded-RSS contract
                    # says no.  Fence-only pruning for this tier.
                    return None
                d = col._dictionary
                if d.dtype.kind != "S":
                    return None
                entries = d.tolist()
                dh = np.asarray(
                    [zlib.crc32(e, seed) & 0xFFFFFFFF for e in entries]
                    or [0],
                    dtype=_U64,
                )
                codes = np.asarray(col.codes_host()[:n], dtype=np.int64)
                codes = np.clip(codes, 0, max(len(entries) - 1, 0))
                h = (h ^ dh[codes]) * _U64(_FNV_PRIME)
        return h
    rows = impl.rows
    out = np.empty(len(rows), dtype=_U64)
    for i, r in enumerate(rows):
        h = _FNV_OFFSET
        for c in key_columns:
            cc = zlib.crc32(_value_bytes(r[c]), seed) & 0xFFFFFFFF
            h = ((h ^ cc) * _FNV_PRIME) & _MASK64
        out[i] = h
    return out


def build_pruner(
    impl,
    key_columns: Sequence[str],
    *,
    bits_per_key: Optional[int] = None,
    seed: Optional[int] = None,
) -> TierPruner:
    """Build fences + filter for one sorted tier (an ``IndexImpl``).

    O(n) host work at seal time; the double-hash insert is a vectorized
    unpacked-bit scatter + ``np.packbits`` — no device round trips
    beyond the 2-row fence decode."""
    if bits_per_key is None:
        bits_per_key = filter_bits_per_key()
    if seed is None:
        seed = filter_seed()
    n = len(impl)
    if n == 0:
        return TierPruner(0, None, None, None, 0, 0, seed, bits_per_key)
    fence_lo, fence_hi = _fence_of(impl, key_columns)
    bits = None
    m = 0
    k = 0
    if bits_per_key > 0:
        h = _row_hashes(impl, key_columns, seed)
        if h is not None:
            k = _n_hashes(bits_per_key)
            m = max(8, n * bits_per_key)
            h1 = (h & _U64(0xFFFFFFFF)).astype(_U64)
            h2 = (h >> _U64(32)) | _U64(1)
            ks = np.arange(k, dtype=_U64)
            with np.errstate(over="ignore"):
                pos = (h1[:, None] + ks[None, :] * h2[:, None]) % _U64(m)
            # set bits via an unpacked byte-per-bit scatter + packbits:
            # fancy-index assignment is ~10x cheaper than the
            # np.bitwise_or.at ufunc scatter, and bitorder="little"
            # reproduces the (pos >> 3, 1 << (pos & 7)) layout exactly.
            nbytes = (m + 7) // 8
            unpacked = np.zeros(nbytes * 8, dtype=np.uint8)
            unpacked[pos.astype(np.int64).ravel()] = 1
            bits = np.packbits(unpacked, bitorder="little")
    return TierPruner(
        n, fence_lo, fence_hi, bits, m, k, seed, bits_per_key
    )


# -- per-TierSet aggregation ----------------------------------------------


class PruneDirectory:
    """One TierSet's pruners, aggregated for vectorized probing.

    Built LAZILY by ``TierSet.prune_directory()`` on the first probe
    after a swap (double-checked under the per-TierSet lock, with each
    delta's TierPruner cached on its DeltaTier so successor epochs
    reuse it) — the append path pays no per-seal scan, and every probe
    after the first touches only immutable state, the probe contract.
    Filter bitsets concatenate into one uint8 array with per-tier bit
    offsets; a probe batch then answers every
    (probe, tier) filter test in one numpy broadcast.  Tiers without a
    filter contribute a 1-byte all-ones chunk (always pass), empty
    tiers a 1-byte all-zeros chunk (never pass — exact, they hold
    nothing)."""

    __slots__ = (
        "pruners",
        "n_tiers",
        "width",
        "k",
        "seed",
        "scalar_only",
        "bits_cat",
        "m_arr",
        "off_bits",
        "empty_mask",
        "alive_mask",
        "fence_lo_b",
        "fence_hi_b",
        "fence_vec",
        "fence_unvec",
    )

    def __init__(self, pruners: Sequence[TierPruner], width: int):
        self.pruners = list(pruners)
        self.n_tiers = len(self.pruners)
        self.width = width
        self.empty_mask = np.asarray(
            [p.nrows == 0 for p in self.pruners], dtype=bool
        )
        self.alive_mask = ~self.empty_mask
        # single-column fences as byte arrays: the small-batch fast
        # path answers one probe's fence test against EVERY tier in two
        # numpy 'S' compares.  Byte order equals code-point order only
        # for NUL-free UTF-8 str fences; any other tier keeps the exact
        # Python check (fence_unvec marks them "not vector-decided").
        self.fence_lo_b = None
        self.fence_hi_b = None
        self.fence_vec = None
        self.fence_unvec = None
        if width == 1:
            los: List[bytes] = []
            his: List[bytes] = []
            vec: List[bool] = []
            for p in self.pruners:
                lo, hi = p.fence_lo, p.fence_hi
                ok = (
                    p.nrows > 0
                    and lo is not None
                    and isinstance(lo[0], str)
                    and isinstance(hi[0], str)
                    and "\x00" not in lo[0]
                    and "\x00" not in hi[0]
                )
                vec.append(ok)
                los.append(lo[0].encode("utf-8") if ok else b"")
                his.append(hi[0].encode("utf-8") if ok else b"")
            if any(vec):
                self.fence_lo_b = np.asarray(los, dtype=np.bytes_)
                self.fence_hi_b = np.asarray(his, dtype=np.bytes_)
                self.fence_vec = np.asarray(vec, dtype=bool)
                self.fence_unvec = ~self.fence_vec
        ks = {p.k for p in self.pruners if p.bits is not None}
        seeds = {p.seed for p in self.pruners}
        if len(seeds) <= 1 and len(ks) <= 1:
            # homogeneous parameters (the normal case: one process, one
            # env) -- vectorized directory
            self.scalar_only = False
            self.seed = next(iter(seeds)) if seeds else 0
            self.k = next(iter(ks)) if ks else 0
            chunks: List[np.ndarray] = []
            ms: List[int] = []
            offs: List[int] = []
            off = 0
            pass_byte = np.full(1, 0xFF, dtype=np.uint8)
            fail_byte = np.zeros(1, dtype=np.uint8)
            for p in self.pruners:
                if p.nrows == 0:
                    chunk, m = fail_byte, 8
                elif p.bits is None:
                    chunk, m = pass_byte, 8
                else:
                    chunk, m = p.bits, p.m
                offs.append(off * 8)
                ms.append(m)
                off += len(chunk)
                chunks.append(chunk)
            self.bits_cat = (
                np.concatenate(chunks)
                if chunks
                else np.zeros(0, dtype=np.uint8)
            )
            self.m_arr = np.asarray(ms, dtype=_U64)
            self.off_bits = np.asarray(offs, dtype=_U64)
        else:
            # mixed seed/k across tiers (env changed between seals of a
            # reopened index): fall back to exact per-tier scalar checks
            self.scalar_only = True
            self.seed = 0
            self.k = 0
            self.bits_cat = np.zeros(0, dtype=np.uint8)
            self.m_arr = np.zeros(0, dtype=_U64)
            self.off_bits = np.zeros(0, dtype=_U64)

    def pass_matrix(self, probes: Sequence[Sequence]) -> np.ndarray:
        """(n_probes, n_tiers) bool: True where the tier MAY contain the
        probe.  One-sided like the scalar predicate: a False entry is a
        proof of absence, a True entry just means "go do the bounds
        pass"."""
        n = len(probes)
        nt = self.n_tiers
        out = np.ones((n, nt), dtype=bool)
        if nt == 0 or n == 0:
            return out
        if n <= _SMALL_BATCH and self.fence_vec is not None:
            return self._pass_small(probes, out)
        if self.empty_mask.any():
            out[:, self.empty_mask] = False
        width = self.width
        full = [
            i
            for i, p in enumerate(probes)
            if len(p) == width and _probe_filterable(p)
        ]
        if full and self.k and not self.scalar_only:
            h1 = np.empty(len(full), dtype=_U64)
            h2 = np.empty(len(full), dtype=_U64)
            for j, i in enumerate(full):
                a, b = probe_hashes(probes[i], self.seed)
                h1[j] = a
                h2[j] = b
            ks = np.arange(self.k, dtype=_U64)
            with np.errstate(over="ignore"):
                # (n_full, n_tiers, k) global bit positions
                pos = (
                    h1[:, None, None] + ks[None, None, :] * h2[:, None, None]
                ) % self.m_arr[None, :, None] + self.off_bits[None, :, None]
            byte = self.bits_cat[(pos >> _U64(3)).astype(np.int64)]
            bit = (byte >> (pos & _U64(7)).astype(np.uint8)) & np.uint8(1)
            survives = bit.astype(bool).all(axis=2)
            out[np.asarray(full, dtype=np.int64)] &= survives
        # fences (and, under scalar_only, per-tier filters): Python
        # checks only on (probe, tier) pairs still alive
        pruners = self.pruners
        scalar_filters = self.scalar_only
        for i, p in enumerate(probes):
            if not p:
                continue
            row = out[i]
            alive = np.flatnonzero(row)
            if not alive.size:
                continue
            is_full = len(p) == width and _probe_filterable(p)
            for t in alive:
                pr = pruners[t]
                if pr.fence_excludes(p):
                    row[t] = False
                elif scalar_filters and is_full and pr.bits is not None:
                    a, b = probe_hashes(p, pr.seed)
                    if pr.filter_excludes(a, b):
                        row[t] = False
        return out

    def _pass_small(self, probes: Sequence[Sequence], out: np.ndarray):
        """Small batches route probe-by-probe through :meth:`shortlist`
        (one implementation of the fence-first scalar path) and scatter
        the survivors back into the matrix."""
        out[:] = False
        for i, p in enumerate(probes):
            sl = self.shortlist(p)
            if sl:
                out[i, sl] = True
        return out

    def shortlist(self, probe: Sequence) -> List[int]:
        """Surviving tier indices for ONE probe — the serving
        point-lookup shape, equivalent to
        ``np.flatnonzero(pass_matrix([probe])[0])`` but orders of
        magnitude cheaper: fences go FIRST (two vectorized byte
        compares decide every tier at once), then scalar filter tests
        run only on the handful of fence survivors."""
        if not probe:
            # empty probe matches every non-empty tier
            return np.flatnonzero(self.alive_mask).tolist()
        filterable = _probe_filterable(probe)
        vec_decided = None
        if (
            self.fence_vec is not None
            and filterable
            and len(probe) == 1
            and isinstance(probe[0], str)
        ):
            pb = probe[0].encode("utf-8")
            inside = self.fence_lo_b <= pb
            inside &= pb <= self.fence_hi_b
            inside |= self.fence_unvec
            inside &= self.alive_mask
            cand = np.flatnonzero(inside).tolist()
            vec_decided = self.fence_vec
        else:
            cand = np.flatnonzero(self.alive_mask).tolist()
        full = filterable and len(probe) == self.width
        pruners = self.pruners
        out: List[int] = []
        for t in cand:
            pr = pruners[t]
            if (vec_decided is None or not vec_decided[t]) and (
                pr.fence_excludes(probe)
            ):
                continue
            if full and pr.bits is not None:
                a, b = probe_hashes(probe, pr.seed)
                if pr.filter_excludes(a, b):
                    continue
            out.append(t)
        return out


# -- sidecar persistence --------------------------------------------------


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _jsonable_fence(fence: Optional[Tuple]):
    if fence is None:
        return None
    try:
        json.dumps(list(fence))
    except (TypeError, ValueError):
        return None
    return list(fence)


def write_pruner(path: str, pruner: TierPruner) -> None:
    """Persist one pruner: npz payload with a JSON meta record, written
    tmp -> fsync -> ``os.replace`` -> dir fsync (the manifest idiom, so
    a crash leaves either the old sidecar or the new one, never a torn
    file)."""
    lo = _jsonable_fence(pruner.fence_lo)
    hi = _jsonable_fence(pruner.fence_hi)
    if lo is None or hi is None:
        lo = hi = None
    meta = {
        "magic": _SIDECAR_MAGIC,
        "version": _SIDECAR_VERSION,
        "nrows": int(pruner.nrows),
        "m": int(pruner.m),
        "k": int(pruner.k),
        "seed": int(pruner.seed),
        "bits_per_key": int(pruner.bits_per_key),
        "fence_lo": lo,
        "fence_hi": hi,
        "has_filter": pruner.bits is not None,
    }
    blob = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8
    )
    bits = (
        pruner.bits
        if pruner.bits is not None
        else np.zeros(0, dtype=np.uint8)
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, meta=blob, bits=bits)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def load_pruner(path: str, *, expect_nrows: Optional[int] = None) -> TierPruner:
    """Load a sidecar written by :func:`write_pruner`.

    Raises ``ValueError`` on any structural mismatch (bad magic,
    truncated arrays, row-count disagreement with the base it claims to
    describe) — callers treat that as "rebuild by scan", never as data.
    """
    with np.load(path) as z:
        if "meta" not in z or "bits" not in z:
            raise ValueError(f"prune sidecar {path}: missing arrays")
        meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        bits = np.asarray(z["bits"], dtype=np.uint8)
    if meta.get("magic") != _SIDECAR_MAGIC:
        raise ValueError(f"prune sidecar {path}: bad magic")
    if int(meta.get("version", -1)) != _SIDECAR_VERSION:
        raise ValueError(f"prune sidecar {path}: unsupported version")
    nrows = int(meta["nrows"])
    if expect_nrows is not None and nrows != expect_nrows:
        raise ValueError(
            f"prune sidecar {path}: describes {nrows} rows, "
            f"base has {expect_nrows}"
        )
    m = int(meta["m"])
    k = int(meta["k"])
    has_filter = bool(meta.get("has_filter"))
    if has_filter:
        if bits.size != (m + 7) // 8 or m <= 0 or k <= 0:
            raise ValueError(f"prune sidecar {path}: truncated filter")
        out_bits: Optional[np.ndarray] = bits
    else:
        out_bits = None
    lo = meta.get("fence_lo")
    hi = meta.get("fence_hi")
    fence_lo = tuple(lo) if lo is not None else None
    fence_hi = tuple(hi) if hi is not None else None
    if (fence_lo is None) != (fence_hi is None):
        raise ValueError(f"prune sidecar {path}: half a fence")
    return TierPruner(
        nrows,
        fence_lo,
        fence_hi,
        out_bits,
        m,
        k,
        int(meta["seed"]),
        int(meta["bits_per_key"]),
    )
