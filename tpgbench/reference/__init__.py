"""The benchmark's plain reference of the readout chain, in NumPy.

It imports nothing but NumPy and the standard library: no JAX, no JAX
package and nothing of the PyTorch port.  It is a frozen, independent
statement of the semantics the port implements:

* ``frames``: the WIBEth frame layout (7200-byte frames, 64 ticks x 64
  channels of 14-bit samples) and its unpack;
* ``channels``: the HD APA channel map (offline channel and plane per
  link channel) read from the packaged map file beside this module;
* ``tpg``: the AbsRS trigger-primitive generator with the AVX2 kernels'
  int16 fixed-point arithmetic, the K hit slots per channel per chunk
  and the per-batch cap on compacted hits;
* ``tps``: hit -> TP assembly on offline channels and TPSet windowing.
"""
