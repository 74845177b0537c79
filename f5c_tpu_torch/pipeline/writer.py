"""Background output writer — the post-processor thread of the
reference's 3-stage pipeline (src/meth_main.c:610-742).

The emit loops hand rendered chunks (str or bytes) to a bounded queue; a
daemon thread encodes and writes them in order, so TSV emission and
disk I/O overlap the next batch's compute.  ``close()`` drains the
queue and re-raises any writer-side exception.  The thread times each
chunk's rendering (``writer.render``) and write (``writer.write``) and
counts the chunks (``writer.chunks``) in the pipeline's span recorder
(``spans.Spans``)."""

from __future__ import annotations

import queue
import threading


class AsyncWriter:
    """Order-preserving asynchronous sink over a text or binary stream."""

    _SENTINEL = object()

    def __init__(self, out, spans, max_chunks: int = 256):
        self._out = out
        self._spans = spans
        self._buffer = getattr(out, "buffer", None)
        self._q: queue.Queue = queue.Queue(maxsize=max_chunks)
        self._exc = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        sp = self._spans
        while True:
            chunk = self._q.get()
            if chunk is self._SENTINEL:
                return
            try:
                t0 = sp.now()
                if callable(chunk):
                    chunk = chunk()
                    t0 = sp.add("writer.render", t0)
                if isinstance(chunk, bytes):
                    if self._buffer is not None:
                        self._out.flush()
                        self._buffer.write(chunk)
                    else:
                        self._out.write(chunk.decode("latin1"))
                elif chunk:
                    self._out.write(chunk)
                sp.add("writer.write", t0)
                sp.count("writer.chunks", 1)
            except Exception as e:      # surfaced by close()
                self._exc = e

    def write(self, chunk):
        if self._exc is not None:
            raise self._exc
        if chunk:
            self._q.put(chunk)

    def write_lazy(self, render):
        """Queue a zero-arg callable; it renders IN the writer thread,
        so row formatting itself overlaps the next batch's compute."""
        if self._exc is not None:
            raise self._exc
        self._q.put(render)

    def close(self):
        self._q.put(self._SENTINEL)
        self._thread.join()
        if self._exc is not None:
            raise self._exc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
