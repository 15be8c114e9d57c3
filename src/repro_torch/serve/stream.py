"""StreamService: the process-level loop around :class:`StreamDriver`
(counterpart of ``repro.serve.stream``).

The driver owns the math (delta joins, standing lists, warm-started
clustering); the service owns the *process* concerns:

* resume-on-start: restore the newest valid snapshot and fast-forward
  the submission source to the driver's replay cursor, so a killed
  service relaunched over the same batch sequence lands bit-identically
  on the uninterrupted run's state (the kill-and-resume parity suite
  asserts exactly this);
* pacing: one window advance every ``pump_every`` submissions, with the
  fault injector's ``stall_batch`` able to suppress advances (queue
  pressure scenarios);
* a final drain + snapshot on shutdown, so nothing stays staged.

Submission batches are identified by their absolute index in the source
sequence — the same key the fault plan uses — which is what makes replay
after resume deterministic: batch ``i`` gets the same scripted dirt on
every run that processes it.
"""
from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.stream.driver import StreamConfig, StreamDriver
from repro_torch.stream.ingest import Records


class StreamService:
    """Long-running ingest-advance-query loop over one record source;
    ``device`` (``None`` = the card) holds the driver's standing state."""

    def __init__(self, config: StreamConfig, *, checkpoint_dir=None,
                 telemetry=None, injector=None, keep_n: int = 3,
                 device=None):
        self.driver = StreamDriver(
            config, checkpoint_dir=checkpoint_dir, telemetry=telemetry,
            injector=injector, keep_n=keep_n, device=device)
        self.injector = injector
        self.resumed = self.driver.maybe_resume()

    def run(self, batches: Iterable[Records], *,
            pump_every: int = 1, max_batches: Optional[int] = None) -> dict:
        """Feed the batch sequence through submit/advance.

        Batches whose absolute index is below the driver's replay cursor
        were already folded into the restored snapshot and are skipped —
        the resume fast-forward.  Returns the final ``stats()``.
        """
        for i, recs in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            if i < self.driver.cursor:
                continue                      # already in the snapshot
            idx = self.driver.submit(recs)
            stalled = (self.injector is not None
                       and self.injector.stall_batch(idx))
            if not stalled and (idx + 1) % pump_every == 0:
                self.driver.advance()
        if self.driver.window.queued() > 0:
            self.driver.advance()             # final drain
        if self.driver.manager is not None:
            self.driver.snapshot()
        return self.driver.stats()

    # thin passthroughs — the query surface of the service
    def query(self, obj: int) -> dict:
        return self.driver.query(obj)

    def stats(self) -> dict:
        return self.driver.stats()

    def accounting(self) -> dict:
        return self.driver.accounting()
