"""Columnar device tables, ingest and the plan executor."""
