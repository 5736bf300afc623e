"""Canned workload pipelines ("model families" of this package).

* :mod:`.flagship` — the north-star 3-way lookup join
  (orders ⋈ customers ⋈ products) as one fused device step;
* :mod:`.workloads` — BASELINE.json's configs 1-4 as importable
  pipelines over the public API.
"""
