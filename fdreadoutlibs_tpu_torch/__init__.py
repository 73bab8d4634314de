"""fdreadoutlibs_tpu_torch — the PyTorch/CUDA port of ``fdreadoutlibs_tpu``.

The JAX package stays the reference; this package mirrors its module paths
so every counterpart is found by path.  It imports ``torch`` and never
``jax``: the JAX package's jax-free host modules (``ops.config``,
``ops.chanstate``, ``ops.step``, ``ops.fixedpoint``, ``ops.hits``,
``ops.reference``, ``utils.channel_map``, ``utils.metrics``, ``native``)
are imported from it, and the host modules whose JAX-package import chain
pulls in jax are carried here as copies (each cites its original).

Slice 1 ports the production APA application's main path: the time2 host
feed through the hand-written Hopper TPG kernel (``csrc/tpg_time2.cu``,
wrapped by ``ops.tpg.process_window``), on-device compaction, and the host
TP tail (``apps.apa_readout.APAReadoutApp``).
"""

__version__ = "0.1.0"
