"""Lock factory: the port's copy of the production path of
tf_operator_tpu/utils/locks.py.

Concurrent modules create their locks through ``make_lock("Class.attr")``
instead of calling ``threading`` directly, so the name of each lock is
written where it is made. The reference can swap in an
instrumented lock-order checker (lockdep) under its test runner; the port
carries only the plain primitives that path returns by default.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A mutex named for the lock-order graph; a plain threading.Lock."""
    del name
    return threading.Lock()
