"""Traffic generators, one module each, found by the ``generator`` name a
traffic file gives; each offers ``Source(config, traffic, seed, device,
n_apas, ring)`` with ``batch(apa, b)``, ``slab(apa, b)`` and
``batch_ts(b)``."""
