"""Environment knobs: the one parser of the package's tuning variables,
escape hatches and string settings (the fault plan, the flight
recorder's directory), and ``ENV_REGISTRY``, the knobs the package reads
with the reference's kind, default column and description
(``csvplus_tpu/utils/env.py``)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional


@dataclass(frozen=True)
class EnvVar:
    """One registered knob: *kind* is documentation ("int", "float",
    "flag", "str", "json"), *default* the rendered default column (call
    sites own the live default value), *description* one line."""

    name: str
    kind: str
    default: str
    description: str


ENV_REGISTRY: Dict[str, EnvVar] = {}


def _env(name: str, kind: str, default: str, description: str) -> str:
    ENV_REGISTRY[name] = EnvVar(name, kind, default, description)
    return name


# -- ingest / native scanner ------------------------------------------------
_env("CSVPLUS_INGEST_WORKERS", "int", "0 (auto)",
     "Pipelined-ingest encode workers; 0 sizes from the CPU count.")
_env("CSVPLUS_STREAM_MIN_BYTES", "int", "268435456",
     "Files at or above this size take the streaming (chunked) ingest.")
_env("CSVPLUS_STREAM_CHUNK_BYTES", "int", "67108864",
     "Chunk size for the streaming scanner's mmap windows.")
_env("CSVPLUS_STREAM_PREFETCH", "int", "1",
     "Chunks scanned ahead of the encode stage in streaming ingest.")
_env("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "int", "4000000",
     "Distinct-count threshold moving dictionary builds onto device.")
_env("CSVPLUS_TYPED_LANES", "flag", "1",
     "0 disables typed int/float lanes; every column stays dictionary.")
_env("CSVPLUS_DEVICE_PARSE", "flag", "(auto)",
     "1/0 forces the on-device parse tier on/off; unset = RTT probe.")
_env("CSVPLUS_DEVICE_PARSE_MAX_RTT_MS", "float", "20.0",
     "RTT probe threshold above which device parse is disabled.")

# -- ops / parallel ---------------------------------------------------------
_env("CSVPLUS_POINT_MIRROR_MAX_KEYS", "int", "16000000",
     "Max sorted-key count mirrored to host for point lookups.")
_env("CSVPLUS_MIRROR_LRU_ROWS", "int", "65536",
     "Row budget for the host mirror LRU backing point reads.")
_env("CSVPLUS_DSORT_MIN_ROWS", "int", "1000000",
     "Sharded tables at/above this row count use distributed sample-sort.")
_env("CSVPLUS_PARTITION_MIN_KEYS", "int", "4000000",
     "Build sides at/above this key count use the partitioned join.")
_env("CSVPLUS_JOIN_SKEW", "flag", "1",
     "0 disables skew detection/broadcast tier (bitwise-parity hatch).")
_env("CSVPLUS_JOIN_SKEW_THRESHOLD", "float", "1/(2*shards)",
     "Heavy-hitter share threshold tau for the broadcast tier.")
_env("CSVPLUS_JOIN_SKEW_SAMPLE", "int", "4096",
     "Strided sample cap for skew detection (sync-accounting bound).")

# -- storage ----------------------------------------------------------------
_env("CSVPLUS_WAL_SYNC", "str", "always",
     "WAL fsync policy: always | interval | never (typos raise).")
_env("CSVPLUS_WAL_SEGMENT_BYTES", "int", "8388608",
     "WAL segment roll size in bytes.")
_env("CSVPLUS_LSM_RATIO", "int", "4",
     "LSM tier fan-out ratio for the compaction ladder.")
_env("CSVPLUS_LSM_READAMP_TARGET", "float", "4.0",
     "Read-amplification target steering compaction scheduling.")
_env("CSVPLUS_LSM_PRUNE", "flag", "1",
     "0/off/false disables fence+filter pruning (parity hatch).")
_env("CSVPLUS_LSM_FILTER_BITS", "int", "10",
     "Bloom filter bits per key for LSM run pruning.")
_env("CSVPLUS_LSM_FILTER_SEED", "int", "0x5EED",
     "Bloom filter hash seed (masked to 32 bits).")

# -- serve ------------------------------------------------------------------
_env("CSVPLUS_PLANCACHE_SIZE", "int", "256",
     "Compiled-plan LRU entries for the serve tier.")

# -- analysis / resilience / obs --------------------------------------------
_env("CSVPLUS_VERIFY", "flag", "1",
     "0 skips plan verification before lowering (escape hatch).")
_env("CSVPLUS_OPTIMIZE", "flag", "1",
     "0 disables the plan rewriter entirely.")
_env("CSVPLUS_MULTIWAY", "flag", "1",
     "0 disables the multiway-fuse rewrite (cascaded bench leg).")
_env("CSVPLUS_FUSE", "flag", "1",
     "0 disables probe-pass fusion (staged bench leg).")
_env("CSVPLUS_PLANCERT_N", "int", "3",
     "Max plan size (stages incl. leaf) the plan-space certifier enumerates.")
_env("CSVPLUS_PLANCERT_BUDGET_S", "float", "60.0",
     "Wall-clock budget for make plan-cert; exceeding it fails the run.")
_env("CSVPLUS_FAULTS", "json", "(unset)",
     "Fault-injection plan: JSON list of specs or {seed, faults}.")
_env("CSVPLUS_FLIGHT_DIR", "str", "(tempdir)",
     "Directory for flight-recorder dumps.")



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


def env_float(name: str, default: float) -> float:
    """A float tuning knob; a malformed value gives *default*."""
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default
