"""L1 — frame formats of the port (WIBEth, WIB2, ProtoWIB, DAPHNE, TDE,
SSP, variable-size payloads), the type adapters, and the Fragment/TP wire
layouts.

Copies of the JAX package's format code with torch device unpacks in place
of its jnp ones: the JAX package's ``formats/__init__.py`` imports those jnp
unpacks, so nothing under ``fdreadoutlibs_tpu.formats`` can be imported
without jax.
"""
