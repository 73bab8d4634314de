"""L3 — frame processors of the port (WIBEth, WIB2, ProtoWIB, DAPHNE
self-triggered and stream, TDE, SSP and the TP pass-through) and the host
plumbing they use: error registry, typed non-blocking senders, the task
pipeline, source emulation and signal simulation."""

from .daphne import DAPHNEFrameProcessor, DAPHNEStreamFrameProcessor  # noqa: F401
from .protowib import WIBFrameProcessor  # noqa: F401
from .ssp import SSPFrameProcessor, SWTriggerPrimitiveProcessor  # noqa: F401
from .tde import TDEFrameProcessor  # noqa: F401
from .wib2 import WIB2FrameProcessor  # noqa: F401
from .wibeth import WIBEthFrameProcessor  # noqa: F401
