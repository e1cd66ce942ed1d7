"""Sweep service: a persistent multi-client campaign server.

One warm emulator engine (the plan cache of ``core.emulator`` and the
loaded kernel library) serves many concurrent sweep clients. Submitted
grid points are bucketed by their campaign ``group_key``; compatible
points FROM DIFFERENT CLIENTS coalesce into shared batched dispatches on
the overlapped executor (each on a worker's CUDA stream), and results
demultiplex back to per-client futures equal to a direct ``Campaign.run``
of the same points. Admission is bounded (a full queue is a typed
:class:`QueueFullError`, never a hang), scheduling between tenants is
weighted-fair (stride order over client virtual time), and shutdown
drains in-flight dispatches and leaves the Campaign's content-addressed
checkpoints, so an interrupted sweep resumes with nothing recomputed.

In-process::

    from repro_torch.service import SweepServer, SweepClient

    with SweepServer() as srv:            # device=None: CUDA
        cli = SweepClient(server=srv, name="alice")
        cli.submit(trace, JETSON_NANO, mode="ts", workload="mm")
        records = cli.collect()           # == Campaign.run of the points

Over a socket (one process owns the warm engine, many attach)::

    PYTHONPATH=src python -m repro_torch.service --port 7421
    ...
    cli = SweepClient(address=("127.0.0.1", 7421), name="bob")
"""
from repro_torch.service.server import (QueueFullError, ServerClosedError,
                                        ServiceConfig, SweepServer,
                                        load_pending)
from repro_torch.service.client import SweepClient

__all__ = ["SweepServer", "SweepClient", "ServiceConfig",
           "QueueFullError", "ServerClosedError", "load_pending"]
