"""Link-axis data parallelism over device meshes.

Counterpart of ``fdreadoutlibs_tpu/parallel/__init__.py``.  The
reference's parallelism inventory (SURVEY.md §2.7) maps to pure data
parallelism over readout links: an APA is 40 WIBEth streams x 64
channels; links split over a 1-D 'link' mesh of devices with NO
collectives in the hot loop (per-channel streaming state is embarrassingly
parallel; the only cross-channel coupling in the pipeline is hit output
compaction, which stays shard-local).  Sums over shards appear only for
monitoring aggregates.

Detector scale-out stacks a second, collective-free 'apa' mesh axis on
top: ``DetectorPipeline`` runs N independent APAs over a 2-D
('apa', 'link') mesh, one device group per APA, with the monitoring sums
over 'link' only (per-APA totals for free).
"""

from .mesh import LinkMesh, Sharded, make_apa_link_mesh, make_link_mesh  # noqa: F401
from .apa import (APAPipeline, DetectorPipeline,  # noqa: F401
                  make_apa_step, make_detector_step, state_from_jax)
