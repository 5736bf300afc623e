"""Bounded producer/consumer relay iterator.

A copy of ``csvplus_tpu/utils/relay.py``: the daemon-producer +
bounded-queue + sentinel + exception-relay pattern behind the streamed
ingest's prefetch overlap
(:func:`csvplus_tpu_torch.columnar.ingest._prefetch_iter`).
"""

from __future__ import annotations

import queue as _queue
import threading as _threading


class RelayStopped(Exception):
    """Raised inside ``emit`` when the consumer abandoned the iterator;
    producers let it propagate (or translate it) to unwind promptly."""


def relay_iter(run, maxsize: int = 2):
    """Run ``run(emit)`` on a daemon thread; yield emitted items in order.

    * ``run`` calls ``emit(item)`` once per item.  When the consumer
      abandons the returned iterator, the next ``emit`` raises
      :class:`RelayStopped`, so the producer can never stay blocked
      pinning item memory.
    * Any other exception escaping ``run`` re-raises in the consumer at
      the position it occurred.
    * Memory is bounded by ``maxsize`` queued items.
    """
    q: "_queue.Queue" = _queue.Queue(maxsize=maxsize)
    stop = _threading.Event()
    _END = object()

    def emit(item) -> None:
        while True:
            if stop.is_set():
                raise RelayStopped
            try:
                q.put(item, timeout=0.1)
                return
            except _queue.Full:
                continue

    def producer() -> None:
        try:
            run(emit)
            item = _END
        except RelayStopped:
            return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            item = e
        try:
            emit(item)
        except RelayStopped:
            pass

    t = _threading.Thread(target=producer, daemon=True, name="csvplus-relay")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a producer mid-put is never left blocked
        while t.is_alive():
            try:
                q.get_nowait()
            except _queue.Empty:
                t.join(timeout=0.05)
