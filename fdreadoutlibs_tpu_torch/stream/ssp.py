"""SSP photon-detector processor and the TP passthrough processor.

Port copy of ``fdreadoutlibs_tpu/stream/ssp.py:1-53``
(numpy on the port's ``formats/ssp`` and ``stream/processor``); the code
is unchanged.

* :class:`SSPFrameProcessor` — header-only processor recording the last
  timestamp (include/fdreadoutlibs/ssp/SSPFrameProcessor.hpp:77-81).
* :class:`SWTriggerPrimitiveProcessor` — the no-op processor over
  TriggerPrimitive payloads that lets raw TPs flow through a link handler
  into a latency buffer (wib/SWWIBTriggerPrimitiveProcessor.hpp:36-51);
  here it forwards TP batches straight into a sink/latency buffer.
"""

from __future__ import annotations

import numpy as np

from ..formats import ssp
from .processor import TaskRawDataProcessor


class SSPFrameProcessor(TaskRawDataProcessor):

    def conf(self, config: dict) -> None:
        super().conf(config)
        self.add_preprocess_task(self.timestamp_check)

    def start(self, args=None) -> None:
        super().start(args)
        self.previous_ts = 0

    def timestamp_check(self, frames: np.ndarray) -> None:
        ts = ssp.get_timestamp(frames)
        if len(ts):
            self.previous_ts = int(ts[-1])
            self.last_processed_daq_ts = int(ts[-1])
        self.metrics.inc("num_payloads", frames.shape[0])


class SWTriggerPrimitiveProcessor(TaskRawDataProcessor):
    """Pass-through over TP structured arrays; tracks the last time_start."""

    def __init__(self, error_registry=None, tp_sink=None):
        super().__init__(error_registry)
        self.tp_sink = tp_sink

    def conf(self, config: dict) -> None:
        super().conf(config)
        self.add_postprocess_task(self.forward)

    def forward(self, tps: np.ndarray) -> None:
        if len(tps):
            self.last_processed_daq_ts = int(tps["time_start"][-1])
            self.metrics.inc("num_tps_forwarded", len(tps))
            if self.tp_sink is not None:
                self.tp_sink.try_send(tps)
