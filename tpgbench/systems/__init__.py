"""Systems under test, one module per entry point of the port that a
configuration names under ``system``.

A system module gives ``n_apas(config)``, ``min_ring(config, traffic)``
(the fewest slabs an APA's ring may hold), the two facts of its frontend
that the readers need:

* ``batch_seconds(config, traffic)``: the detector seconds one APA-batch
  holds (``rtf`` multiplies by it);
* ``least_bytes(config, traffic, hits_per_batch)``: the fewest bytes the
  configuration's trigger-primitive generation must move for one batch,
  whatever implements it: samples at their wire width, the channel state
  read and written once, hit records written once
  (``tpg_roofline_share`` divides it by the card's peak);

and a ``System(config, traffic, source, device)`` with:

* ``step()``: submit the next batch; returns the APA-batches it delivered;
* ``start_window(seed)``, ``stop_window()``: bracket the measured window
  (the seed draws the runs the comparison follows); the latter returns
  its deliveries, (APA, batch);
* ``finish()``: deliver what is still in flight and wait for the device;
* ``layer_record()``: what the per-layer readers read (host timings);
* ``dropped_of(apa, b)``, ``hits_total()``: the program's counts;
* ``judge(outputs=None)``: the readings of the comparison of the
  program's outputs (or ``outputs`` in their place) with the plain
  reference, each with its limit;
* ``control_outputs(sample_mask)``: the plain reference in the
  program's place on cut samples, the control the comparison must fail.
"""
