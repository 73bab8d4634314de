"""Metric readers, one module a metric: ``read(run)`` takes the run's
record (the harness's ``Run.record``) and returns the metric's value, or
None where the record holds nothing to read it from."""
