"""Task-based raw data processor model.

Port copy of ``fdreadoutlibs_tpu/stream/processor.py``: the same code apart
from imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Equivalent of ``readoutlibs::TaskRawDataProcessorModel<T>`` (SURVEY.md §2.6
item 1): an ordered pipeline of preprocess tasks (header validation,
emulator patching) and postprocess tasks (SWTPG) with a conf/start/stop/
get_info lifecycle.  Processors consume *batches* of payloads per call —
the TPU-idiomatic unit — rather than single payloads.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..utils.metrics import MetricsCollector
from .errors import FrameErrorRegistry


class TaskRawDataProcessor:
    """Base processor: registered task pipelines + lifecycle.

    Subclasses register tasks in ``conf()`` via add_preprocess_task /
    add_postprocess_task (the reference registers callbacks the same way,
    WIBEthFrameProcessor.cpp:226-232).
    """

    def __init__(self, error_registry: Optional[FrameErrorRegistry] = None):
        self.error_registry = error_registry or FrameErrorRegistry()
        self.metrics = MetricsCollector()
        self.emulator_mode = False
        self.last_processed_daq_ts = 0
        self._preprocess: list[Callable] = []
        self._postprocess: list[Callable] = []
        self._running = False

    # -- task registration ----------------------------------------------
    def add_preprocess_task(self, fn: Callable) -> None:
        self._preprocess.append(fn)

    def add_postprocess_task(self, fn: Callable) -> None:
        self._postprocess.append(fn)

    # -- lifecycle -------------------------------------------------------
    def conf(self, config: dict) -> None:
        # Re-conf REPLACES the pipeline: every subclass calls super().conf
        # first and then re-registers its tasks, so clearing here makes a
        # second conf() idempotent (without it the task lists accumulate
        # and each batch would run every check — and the state-advancing
        # TPG postprocess — twice).
        self._preprocess = []
        self._postprocess = []
        self.emulator_mode = bool(config.get("emulator_mode", False))

    def start(self, args: Optional[dict] = None) -> None:
        self._running = True
        self.metrics.reset_interval()

    def stop(self, args: Optional[dict] = None) -> None:
        self._running = False

    def get_info(self) -> dict:
        return self.metrics.get_info()

    # -- processing ------------------------------------------------------
    def process(self, batch: np.ndarray):
        """Run the full pipeline over a batch of payloads."""
        if not self._running:
            raise RuntimeError("processor not started")
        for task in self._preprocess:
            task(batch)
        for task in self._postprocess:
            task(batch)
        return batch
