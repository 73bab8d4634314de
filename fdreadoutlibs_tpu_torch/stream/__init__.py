"""L3 — frame processors of the port (WIBEth, WIB2, ProtoWIB, DAPHNE
self-triggered and stream, TDE) and the host plumbing they use: error
registry, typed non-blocking senders, the task pipeline."""

from .daphne import DAPHNEFrameProcessor, DAPHNEStreamFrameProcessor  # noqa: F401
from .protowib import WIBFrameProcessor  # noqa: F401
from .tde import TDEFrameProcessor  # noqa: F401
from .wib2 import WIB2FrameProcessor  # noqa: F401
from .wibeth import WIBEthFrameProcessor  # noqa: F401
