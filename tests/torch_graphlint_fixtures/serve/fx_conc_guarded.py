# -*- coding: utf-8 -*-
"""Seeded conclint regressions: reads/writes of a ``# guarded-by:``
annotated field outside its lock, and an undisciplined thread spawn
(no daemon=True, no name)."""
import threading


class LeakyCollector:
    """Follows the EventLog/SpanCollector convention — except where the
    seeded regressions say otherwise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items = []            # guarded-by: self._lock

    def add(self, item):
        with self._lock:
            self._items.append(item)

    def drain(self):
        out = list(self._items)     # VIOLATION: guarded-by
        self._items = []            # VIOLATION: guarded-by
        return out

    def _compact_locked(self):
        # *_locked convention: the caller holds the lock — exempt.
        self._items = [i for i in self._items if i is not None]

    def snapshot_documented_torn_read(self):
        # The scheduler-introspection idiom: deliberate, pragma'd.
        return len(self._items)  # graphlint: allow[guarded-by] torn read ok

    def start_worker(self):
        t = threading.Thread(target=self.drain)  # VIOLATION: thread-discipline
        return t

    def start_deferred(self):
        # The classic deferred race: the closure is DEFINED under the
        # lock but RUNS later on the worker thread without it.
        with self._lock:
            def worker():
                self._items.append('late')  # VIOLATION: guarded-by
            return threading.Thread(target=worker, name='fx-late',
                                    daemon=True)

    def start_disciplined(self):
        return threading.Thread(target=self.drain, name='fx-drain',
                                daemon=True)
