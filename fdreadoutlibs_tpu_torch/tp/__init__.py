"""L4 — TP buffering, TPSet windowing, raw data requests and fragment
recording (port copies of the JAX package's ``tp/latency_buffer``,
``readout_buffer``, ``request_handler``, ``wib_tp_handler`` and
``recorder``)."""
