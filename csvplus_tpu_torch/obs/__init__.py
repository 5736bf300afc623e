"""Host-side evidence the cost model reads: the build-side key sketches
(:mod:`.sketch`) and the join counters (:mod:`.joinskew`)."""
