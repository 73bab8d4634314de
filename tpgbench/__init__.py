"""Benchmark of ``fdreadoutlibs_tpu_torch``, the PyTorch and CUDA port:
APA readout deployments under saturating traffic on one H100.

Run one cell once (see ``harness``):

    python3 -m tpgbench --workload hd_apa_wibeth.nominal --seed 7 \\
        --seconds 51 --trace 0
"""
