"""Shared thread and lock factories for every threaded subsystem.

Counterpart of ``mxnet_tpu/threads.py``.  Every package thread is created
through :func:`spawn` and named ``mxnet_tpu_torch/<subsystem>/<role>``, so
a test can assert that closing a Server leaves no package thread behind
by scanning :func:`threading.enumerate` for the prefix.  The lock
factories return the plain ``threading`` primitives; the lock-order
sanitizer hooks of the JAX package come with the observability slice.
"""
from __future__ import annotations

import threading

THREAD_PREFIX = "mxnet_tpu_torch/"


def thread_name(subsystem, role):
    """The structured name ``mxnet_tpu_torch/<subsystem>/<role>``."""
    return "%s%s/%s" % (THREAD_PREFIX, subsystem, role)


def spawn(target, subsystem, role, args=(), kwargs=None, daemon=True,
          start=True):
    """Create (and by default start) a package thread with a structured
    name.  Owners join it on their close path."""
    t = threading.Thread(target=target, args=args, kwargs=kwargs or {},
                         name=thread_name(subsystem, role), daemon=daemon)
    if start:
        t.start()
    return t


def live_package_threads():
    """Alive threads spawned through :func:`spawn` (by name prefix)."""
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX) and t.is_alive()]


def package_lock(name):
    """A ``threading.Lock``; ``name`` identifies it for the sanitizer
    that a later slice adds."""
    return threading.Lock()


def package_rlock(name):
    return threading.RLock()


def package_condition(name, lock=None):
    """A ``threading.Condition`` over a package lock (an RLock by
    default, matching ``threading.Condition()``)."""
    return threading.Condition(lock if lock is not None
                               else package_rlock(name))
