"""L1 — frame formats of the port (numpy parts only).

Copies of the JAX package's jax-free format code: the JAX package's
``formats/__init__.py`` imports its jnp device unpacks, so nothing under
``fdreadoutlibs_tpu.formats`` can be imported without jax.
"""
