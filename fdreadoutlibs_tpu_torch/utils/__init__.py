"""Shared services of the port: channel maps, metrics, logging (with the
``torch.profiler`` device trace), the configuration schema and
checkpoint/resume (copies of the JAX package's ``utils`` modules, each
citing its original), ``preflight`` and ``tuning``, the port's kernel
knobs."""
