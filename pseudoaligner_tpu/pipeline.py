"""Depth-D deferral pipeline for the FIFO device queue.

The device executes its queue in order: ANY device_get waits for every
map step queued before it.  Serving loops therefore defer BOTH host
waits — the compact-output fetch (which waits on map(k)) and the
overflow re-map wait (which waits on remap(k), itself queued behind
map(k+1)) — by `depth` batches each, so the queue stays ~depth map
steps deep across both waits (the depth's effect on the H100 is not
measured yet).  This class is the single
implementation of that deferral rule; every serving loop
(emit_fastq, paired, count, multihost, bench) builds on it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable


class DepthPipeline:
    """Two-stage deferral keeping the device's FIFO queue ~depth deep.

    push(item) enters stage 0 (call it right after dispatching the
    item's map step).  Once `depth` more items are queued behind it,
    ``prepare(item, next_item)`` runs — the stage that first waits on
    the item's device outputs (next_item is the following queue entry,
    or None at end of stream).  A non-None prepare result queues for
    stage 2, and once `depth` more results are queued behind it,
    ``finish(result)`` runs — the stage that waits on second-wave
    device work (e.g. the overflow re-map dispatched by prepare).
    close() drains both stages in order.

    prepare may call drain_prepared() first to force all queued
    finishes out (order-preserving fallback paths that bypass stage 2
    and write directly), and may return None to skip stage 2 for its
    item.  Items flow strictly FIFO through both stages, so output
    order equals push order.

    Optional `render` runs between the stages on ONE worker thread:
    each prepare result is submitted to the pool immediately and
    ``finish`` receives the rendered value `depth` batches later —
    numpy/C++-heavy rendering (record formatting, paired intersection)
    overlaps the main thread's dispatch work for free (the GIL releases
    across sorts, gathers and ctypes).  A single worker preserves
    render-side mutation order (tcc counters, progress), so semantics
    equal the inline path exactly; render exceptions re-raise at the
    corresponding ordered finish.
    """

    __slots__ = ("depth", "_prepare", "_finish", "_render", "_pool",
                 "_pending", "_prepared")

    def __init__(
        self,
        depth: int,
        prepare: Callable[[Any, Any], Any],
        finish: Callable[[Any], None] | None = None,
        render: Callable[[Any], Any] | None = None,
    ):
        self.depth = max(1, int(depth))
        self._prepare = prepare
        self._finish = finish
        self._render = render
        self._pool = None
        self._pending: deque = deque()
        self._prepared: deque = deque()

    def push(self, item) -> None:
        self._pending.append(item)
        if len(self._pending) > self.depth:
            self._step()

    def _step(self) -> None:
        item = self._pending.popleft()
        nxt = self._pending[0] if self._pending else None
        st = self._prepare(item, nxt)
        if st is not None:
            if self._render is not None:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._pool = ThreadPoolExecutor(max_workers=1)
                st = self._pool.submit(self._render, st)
            self._prepared.append(st)
            if len(self._prepared) > self.depth:
                self._finish_one()

    def _finish_one(self) -> None:
        st = self._prepared.popleft()
        if self._render is not None:
            st = st.result()  # ordered; re-raises render errors in order
        self._finish(st)

    def drain_prepared(self) -> None:
        """Run every queued finish now (oldest first)."""
        while self._prepared:
            self._finish_one()

    def close(self) -> None:
        """Drain both stages in order; the pipeline is reusable after."""
        while self._pending:
            self._step()
        self.drain_prepared()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def abort(self) -> None:
        """Error-path teardown: drop queued work WITHOUT running it and
        wait out any in-flight render, so no orphan worker keeps
        mutating shared state (or holding device futures) after the
        caller has raised."""
        self._pending.clear()
        self._prepared.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


class prefetch_iter:
    """Run an iterator on a daemon thread, keeping up to `depth` items
    parsed ahead (FASTQ readers release the GIL inside the native scan,
    so the parse genuinely overlaps the serving loop's host work).  Exceptions re-raise at the consumer's next().

    close() cancels: the worker stops at its next queue handoff and is
    JOINED, so a consumer that aborts mid-stream can close the
    underlying readers afterwards without racing the worker's in-flight
    scan (call it in the caller's `finally`, before closing readers)."""

    def __init__(self, gen, depth: int = 2):
        import queue
        import threading

        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, args=(gen,), daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        import queue

        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, gen):
        try:
            for item in gen:
                if not self._put((0, item)):
                    return
            self._put((1, None))
        except BaseException as e:  # propagate readers' errors in order
            self._put((2, e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:  # iterator protocol: exhausted stays exhausted
            raise StopIteration
        kind, val = self._q.get()
        if kind == 0:
            return val
        self._done = True
        if kind == 1:
            self.close()
            raise StopIteration
        self.close()
        raise val

    def close(self, timeout: float = 10.0) -> None:
        self._done = True
        self._stop.set()
        try:  # unblock a worker parked on a full queue
            self._q.get_nowait()
        except Exception:
            pass
        self._thread.join(timeout)
        if self._thread.is_alive():
            # the join guarantee is what makes closing the underlying
            # readers safe (mmap under an in-flight native scan) —
            # block until the worker really is out, however slow the
            # current read is
            self._thread.join()
