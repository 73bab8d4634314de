"""fdreadoutlibs_tpu_torch — the PyTorch/CUDA port of ``fdreadoutlibs_tpu``.

The JAX package stays the reference; this package mirrors its module paths
so every counterpart is found by path.  It imports ``torch`` and never
``jax``, and nothing of the JAX package: every host module it needs
(configuration, channel state, the tick, the oracle, channel maps,
metrics, the native C++ codecs) is carried here as a copy that cites its
original.

Slice 1 ports the production APA application's main path: the time2 host
feed through the hand-written Hopper TPG kernel (``csrc/tpg.cu``, wrapped by
``ops.tpg.process_window``), on-device compaction, and the host TP tail
(``apps.apa_readout.APAReadoutApp``).  Slice 2 ports the per-link frame
processors (``stream.WIBEthFrameProcessor``, ``stream.WIB2FrameProcessor``)
with the packed device ingest and the FIR family on the same kernel.  Slice 3
adds the in-kernel 14-bit unpack, the APA app's packed-word feeds
(``fused_unpack``, ``words14_feed``, the plain packed feed) and
``ops.ingest.StreamingIngest``.  Slice 4 adds the two-pass FIR schedule
(K5, selected by the tuned ``fir_twopass`` knob), the ProtoWIB frontend
(``stream.WIBFrameProcessor`` with ``tp.WIBTPHandler``) and
``models.run_model``.  Slices 5 and 6 port the remaining kernel variants
and the probes; steps 2 and 3 rebuild every kernel as one warp-specialised
pipeline and port the modules: the full-detector app
(``apps.detector_readout``, with its PDS and TDE arms and the Fragment
layer), then multi-APA serving (``apps.scheduler.MultiAPAScheduler``) with
the operator surface: ``cli`` (``python -m fdreadoutlibs_tpu_torch.cli``),
``stream.emulator``, ``ops.patterns``, ``utils.config``,
``utils.checkpoint``, the scan backend (``ops.scan``) and ``entry``.
"""

__version__ = "0.1.0"
