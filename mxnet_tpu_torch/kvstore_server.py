"""KVStore server bootstrap (ref: python/mxnet/kvstore_server.py).

Counterpart of ``mxnet_tpu/kvstore_server.py``.  The reference enters a
blocking server loop at import when ``DMLC_ROLE=server``
(kvstore_server.py:64-73).  The port's dist store has no server
processes (its reduction is a collective across the workers,
``kvstore/dist.py``), but launcher scripts written for the reference
still start server and scheduler roles.  Such a process parks until the
tracker that started it goes away, so ``tools/launch.py -n W -s S``
topologies run unchanged.
"""
from __future__ import annotations

import os
import sys
import time


class KVStoreServer:
    """A server that hosts nothing: the reference server's duties
    (aggregate the workers' pushes, run the optimizer, answer pulls) are
    the workers' collectives here, so it only stays alive for the job."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore
        self.init_logging = False

    def _controller(self, cmd_id, cmd_body):
        """Controller commands (the reference deserializes an optimizer
        here); the optimizer runs on the workers, so none needs acting
        on."""
        return None

    def run(self, poll_s=1.0):
        """Block until the parent process (the tracker) exits, as the
        reference blocks in ps::StartAsync."""
        ppid = os.getppid()
        while os.getppid() == ppid:
            time.sleep(poll_s)


def _init_kvstore_server_module():
    """Park a process launched in the server or scheduler role (the
    reference runs this at package import, kvstore_server.py:76)."""
    if os.environ.get("DMLC_ROLE", "worker") in ("server", "scheduler"):
        KVStoreServer().run()
        sys.exit(0)
