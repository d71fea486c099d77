"""Batch queue — a copy of ``feathercnn_tpu/serve/batcher.py``: the Python
queue, and ``make_queue``, which returns the C++ queue
(``native.NativeBatchQueue``) unless asked for the Python one."""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PyBatchQueue", "make_queue"]


class PyBatchQueue:
    def __init__(self, item_shape, item_dtype, result_shape, result_dtype):
        self.item_shape = tuple(item_shape)
        self.item_dtype = np.dtype(item_dtype)
        self.result_shape = tuple(result_shape)
        self.result_dtype = np.dtype(result_dtype)
        self._lock = threading.Lock()
        self._cv_submit = threading.Condition(self._lock)
        self._cv_result = threading.Condition(self._lock)
        self._pending: deque = deque()
        self._results: Dict[int, np.ndarray] = {}
        self._next = 1
        self._closed = False
        self._stats = {"submitted": 0, "completed": 0, "batches": 0,
                       "max_depth": 0}

    def submit(self, item: np.ndarray) -> int:
        item = np.ascontiguousarray(item, self.item_dtype)
        with self._cv_submit:
            if self._closed:
                return 0
            ticket = self._next
            self._next += 1
            self._pending.append((ticket, item))
            self._stats["submitted"] += 1
            self._stats["max_depth"] = max(self._stats["max_depth"],
                                           len(self._pending))
            self._cv_submit.notify()
            return ticket

    def collect(self, max_batch: int, timeout_us: int = 2000
                ) -> Tuple[np.ndarray, List[int]]:
        deadline_wait = timeout_us / 1e6
        with self._cv_submit:
            while not self._pending and not self._closed:
                self._cv_submit.wait(timeout=0.1)
            if not self._pending:
                return np.empty((0,) + self.item_shape, self.item_dtype), []
            if len(self._pending) < max_batch and deadline_wait > 0:
                self._cv_submit.wait_for(
                    lambda: len(self._pending) >= max_batch or self._closed,
                    timeout=deadline_wait)
            n = min(max_batch, len(self._pending))
            items = [self._pending.popleft() for _ in range(n)]
            self._stats["batches"] += 1
        tickets = [t for t, _ in items]
        batch = np.stack([x for _, x in items])
        return batch, tickets

    def post_results(self, tickets, results: np.ndarray) -> None:
        with self._cv_result:
            for t, r in zip(tickets, results):
                self._results[t] = np.asarray(r, self.result_dtype)
                self._stats["completed"] += 1
            self._cv_result.notify_all()

    def wait_result(self, ticket: int, timeout_us: int = 10_000_000
                    ) -> Optional[np.ndarray]:
        with self._cv_result:
            ok = self._cv_result.wait_for(
                lambda: ticket in self._results or self._closed,
                timeout=timeout_us / 1e6)
            return self._results.pop(ticket, None) if ok else None

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self):
        with self._lock:
            return dict(self._stats)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cv_submit.notify_all()
            self._cv_result.notify_all()


def make_queue(item_shape, item_dtype, result_shape, result_dtype,
               prefer_native: bool = True):
    """The C++ queue (built at first use; a failed build raises), or
    the Python queue with ``prefer_native=False``."""
    if prefer_native:
        from ..native import NativeBatchQueue
        return NativeBatchQueue(item_shape, item_dtype, result_shape,
                                result_dtype)
    return PyBatchQueue(item_shape, item_dtype, result_shape, result_dtype)
