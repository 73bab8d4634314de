"""Shared services of the port: channel maps, metrics and logging (copies
of the JAX package's ``utils`` modules, each citing its original) and
``tuning``, the port's kernel knobs."""
