"""L3 — frame processors of the port (WIBEth, WIB2) and the host plumbing
they use: error registry, typed non-blocking senders, the task pipeline."""

from .wib2 import WIB2FrameProcessor  # noqa: F401
from .wibeth import WIBEthFrameProcessor  # noqa: F401
