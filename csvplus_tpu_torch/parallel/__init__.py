"""Multi-device joins.  Only the tier-choice predicate is ported so far
(:mod:`.pjoin`); the partitioned probe itself comes with the multi-GPU
slice."""
