"""Graceful-preemption signal plumbing for the trainer (the port's own copy
of `avsync/utils/signals.py`).

Schedulers evict with SIGTERM plus a grace window; the trainer wants one
discipline: a FLAG-ONLY handler (logging from a handler can hit a
reentrant BufferedWriter write and crash the run it should be saving),
installed for the duration of the training loop *including* the final
grace-window snapshot, then restored. Under a process group the trainers
vote on the flag at each boundary (`parallel.multihost.any_process_flagged`),
so a SIGTERM to any rank stops every rank at the same batch.
"""

from __future__ import annotations

import signal
from contextlib import contextmanager


@contextmanager
def sigterm_flag(obj, attr: str = "_preempted"):
    """Install a SIGTERM handler that only sets ``obj.<attr> = True``.

    The attribute is reset to False on entry. Restoration on exit handles
    the edge cases signal.signal() forces on us:

    - not the main thread (ValueError on install — e.g. a trainer driven
      from a serving thread): nothing installed, nothing restored;
    - the previous handler was installed by C code outside the signal
      module (getsignal/signal report it as None): it CANNOT be re-passed
      to signal.signal (TypeError), so the flag handler stays installed —
      harmless (it only sets a flag on this object) and strictly better
      than crashing in a finally block or clobbering the host's handler
      with SIG_DFL.
    """
    setattr(obj, attr, False)

    def _on_term(signum, frame):
        setattr(obj, attr, True)  # flag only — reentrant-safe

    installed, prev = False, None
    try:
        prev = signal.signal(signal.SIGTERM, _on_term)
        installed = True
    except ValueError:  # not the main thread
        pass
    try:
        yield
    finally:
        if installed and prev is not None:
            signal.signal(signal.SIGTERM, prev)
