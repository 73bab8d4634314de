"""The plain reference of the ProtoDUNE-SP ProtoWIB path, in PyTorch on
CPU int32 and int64 tensors.

It imports torch, NumPy and the standard library only: no JAX, no JAX
package and nothing of the PyTorch port.  It states anew what upstream
fdreadoutlibs' ``WIBFrameProcessor`` (``include/fdreadoutlibs/wib/
WIBFrameProcessor.hpp:443-676``) does with a link's superchunks:

* ``frames``: the 464-byte ProtoWIB frame, its 12-bit nibble codec, the
  header's timestamp and error bits, and the collection and induction
  register maps (``src/wib/tpg/FrameExpand.cpp:205-299``, as data);
* ``fir_iqr``: the FIR+IQR hit finder of the deployed AVX2 kernels, every
  channel of every link and both planes in one pass over the ticks, a
  threshold per channel, with the readout's K hit slots a chunk and its
  cap on the hits of a plane's batch;
* ``wib_tpsets``: hit -> TP assembly of the WIB frontend and the legacy
  ``WIBTPHandler``'s aligned TPSet windows.
"""
