#!/usr/bin/env python
"""Host IO beside the card's work in the inference commands (port of
aps_tpu/eval/pipeline.py: prefetch_iter, AsyncWriter).

A CUDA stream runs the kernels a command queues while the host goes on,
so host file IO can overlap the card's work, as it overlaps JAX's
asynchronous dispatch in aps_tpu:

  * prefetch_iter reads the next utterances on a background thread, a
    bounded number ahead, while the main thread runs the current batch;
  * AsyncWriter writes the outputs (the wav or npy encoding and the file)
    on a small thread pool.

The outputs are byte-identical to the serial loop's: the main thread
keeps the order (of the utterances it consumes, and of the scp and text
lines it writes) and hands a writer host arrays only, copied off the card
before the next batch is queued, so no worker reads memory the card still
writes. An error of the reader re-raises where the main thread consumes
the next item; an error of a writer re-raises at close(). A consumer that
stops early (an exception in its loop, or a generator it drops) stops the
producer instead of leaving it blocked on a full queue."""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

_DONE = object()


class _Failed(object):
    """The reader's exception, carried to the consuming site."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iter(it: Iterable, depth: int = 8) -> Iterator:
    """Iterate `it` on a background thread, up to `depth` items ahead."""
    items = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has gone away
        while not stop.is_set():
            try:
                items.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as exc:  # noqa: B036 - re-raised by the consumer
            put(_Failed(exc))
            return
        put(_DONE)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = items.get()
            if item is _DONE:
                return
            if isinstance(item, _Failed):
                raise item.exc
            yield item
    finally:
        stop.set()
        # a producer blocked on a full queue sees the flag within 0.1 s
        thread.join(timeout=5.0)


class AsyncWriter(object):
    """A thread pool for the outputs: submit(fn, *args) runs fn on a
    worker; close() waits for all and re-raises the first failure. As a
    context manager it closes on a normal exit, and on an error cancels
    what has not started without masking that error."""

    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []

    def submit(self, fn, *args, **kwargs) -> None:
        self._futures.append(self._pool.submit(fn, *args, **kwargs))

    def close(self) -> None:
        try:
            for fut in self._futures:
                fut.result()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._pool.shutdown(wait=True, cancel_futures=True)
        return False
