"""Host utilities: per-stage timing, logging setup, profiling."""
