"""L2 — the TPG kernel layer of the port.

* ``xp``     — torch namespace that runs the shared tick
  (``fdreadoutlibs_tpu.ops.step.tpg_tick``) on int32 tensors;
* ``tpg``    — the kernel wrapper ``process_window`` (hand-written CUDA
  kernel on CUDA tensors, the plain tick loop on CPU tensors) and the
  port's state layout;
* ``hits``   — on-device compaction of the kernel's slot buffers;
* ``ingest`` — the time2 feed entry point and the one-fetch compaction.

The configuration and channel-state seeding are the JAX package's jax-free
modules, re-exported here so callers of the port import only the port.
"""

from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig

__all__ = ["Algorithm", "TPGConfig", "init_chanstate", "seed_chanstate"]
