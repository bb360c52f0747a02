"""AOI operators of the port: predicate and word layout, the plain step,
the CUDA step, event compaction, delta staging and emit fan-out."""
