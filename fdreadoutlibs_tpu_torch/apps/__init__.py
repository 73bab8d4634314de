"""Composed applications of the port: ``apa_readout`` (one APA on any of
its four feeds), ``pds_readout`` and ``detector_readout`` (the TPC, PDS and
TDE arms behind one request surface) and ``scheduler`` (N APAs served
round-robin through one kernel entry)."""
