"""Inter-stage transport: typed, non-blocking senders.

Port copy of ``fdreadoutlibs_tpu/stream/transport.py``: the same code apart
from imports. It is carried here because importing the original pulls in jax
through its package's ``__init__``.

Equivalent of the ``iomanager::SenderConcept`` surface the reference uses
(``try_send`` with ``s_no_block``, WIBEthFrameProcessor.cpp:555,
TPCTPRequestHandler.cpp:167).  Senders here move numpy *batches* (arrays of
TPs / TPSets / frames), not single objects — one try_send per batch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable


class Sender:
    """Abstract sender: try_send returns False instead of blocking."""

    def try_send(self, item: Any) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


class QueueSender(Sender):
    """Bounded thread-safe queue sender (drops on overflow, like a full
    iomanager connection)."""

    def __init__(self, capacity: int = 1024):
        self._q: deque = deque()
        self._capacity = capacity
        self._lock = threading.Lock()
        self.sent = 0
        self.dropped = 0

    def try_send(self, item: Any) -> bool:
        with self._lock:
            if len(self._q) >= self._capacity:
                self.dropped += 1
                return False
            self._q.append(item)
            self.sent += 1
            return True

    def try_receive(self):
        with self._lock:
            return self._q.popleft() if self._q else None

    def drain(self) -> list:
        with self._lock:
            items = list(self._q)
            self._q.clear()
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class CallbackSender(Sender):
    """Delivers to a callback; failure = callback raising/returning False."""

    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn
        self.sent = 0

    def try_send(self, item: Any) -> bool:
        ok = self._fn(item)
        if ok is False:
            return False
        self.sent += 1
        return True
