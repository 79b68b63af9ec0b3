"""Host utilities: per-stage timing and the step's phase spans, logging setup, scan counters."""
