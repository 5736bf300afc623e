"""Host-side evidence: the build-side key sketches (:mod:`.sketch`) and
join counters (:mod:`.joinskew`) the cost model reads, spans
(:mod:`.span`), the flight recorder (:mod:`.flight`), memory watermarks
(:mod:`.memory`), the hand-built binaries' build/load counts
(:mod:`.recompile`) and the metric registry and telemetry plane the
serving tier owns (:mod:`.metrics`)."""
