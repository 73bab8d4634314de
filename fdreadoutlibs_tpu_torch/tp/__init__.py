"""L4 — TP buffering, TPSet windowing and raw data requests (port copies of
the JAX package's ``tp/latency_buffer``, ``readout_buffer``,
``request_handler`` and ``wib_tp_handler``)."""
