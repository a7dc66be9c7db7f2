"""Child-process supervision shared by the entry points that start
children.

Every supervisor stops its children the same way: SIGTERM, a real wait,
SIGKILL only as a last resort, and tolerance for a child that cannot be
reaped (stuck in uninterruptible device I/O) — the caller must get
control back to emit its own result or error, never an escaped
TimeoutExpired.
"""

from __future__ import annotations

import subprocess
import sys


def graceful_stop(
    p: subprocess.Popen, *, term_wait: float = 30, kill_wait: float = 10
) -> None:
    """Stop ``p`` gently; never raises."""
    if p.poll() is not None:
        return
    p.terminate()
    try:
        p.wait(term_wait)
    except subprocess.TimeoutExpired:
        p.kill()
        try:
            p.wait(kill_wait)
        except subprocess.TimeoutExpired:
            print(
                "WARNING: child unreapable after SIGKILL", file=sys.stderr
            )
