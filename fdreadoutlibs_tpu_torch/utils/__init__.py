"""Shared services of the port.  Channel maps and metrics are the JAX
package's own (``fdreadoutlibs_tpu.utils.channel_map`` / ``.metrics``,
jax-free); ``tuning`` holds the port's kernel knobs."""
