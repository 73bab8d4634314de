"""L2 — the TPG kernel layer of the port.

* ``config``, ``chanstate``, ``fixedpoint``, ``step``, ``fir``,
  ``reference`` — the port's copies of the JAX package's jax-free host
  modules: the configuration, the channel state, the shared tick
  (``step.dispatch_tick``) and the numpy oracle;
* ``xp``     — torch namespace that runs the shared tick on int32 tensors;
* ``tpg``    — the kernel wrapper ``process_window`` (hand-written CUDA
  kernels on CUDA tensors, their plain versions on CPU tensors) and the
  port's state layout;
* ``hits``   — the hit records and the on-device compaction of the
  kernel's slot buffers;
* ``ingest`` — the time2, packed-frame, fused (in-kernel unpack), words14
  and ProtoWIB entry points, the one-fetch compaction, ``collect_hits``
  and ``StreamingIngest``;
* ``scan``   — the portable backend: the shared tick in a loop over ticks
  in plain PyTorch, dense outputs and their compaction;
* ``patterns`` — the validation pattern generators (numpy).
"""

from .chanstate import init_chanstate, seed_chanstate
from .config import Algorithm, TPGConfig

__all__ = ["Algorithm", "TPGConfig", "init_chanstate", "seed_chanstate"]
