"""Measurement helpers (positional checksums)."""
