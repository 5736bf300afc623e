"""Host helpers: positional checksums, the relay iterator, Go JSON
encoding, and observability (per-stage telemetry, profiling)."""

from .observe import StageRecord, Telemetry, profile_to, telemetry

__all__ = ["StageRecord", "Telemetry", "telemetry", "profile_to"]
