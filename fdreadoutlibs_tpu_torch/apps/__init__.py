"""Composed applications of the port: ``apa_readout`` (one APA, time2 feed,
hand-written CUDA TPG kernel)."""
