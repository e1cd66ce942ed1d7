"""SweepClient: one tenant's handle on a :class:`SweepServer`.

Two transports behind one API:

* **In-process** (``SweepClient(server=srv)``) — calls straight into
  the server object; futures are the server's own.
* **Socket** (``SweepClient(address=(host, port))``) — speaks the
  length-prefixed pickle protocol of :mod:`repro_torch.service.net` to
  a server in another process (``python -m repro_torch.service``). Typed
  service errors (:class:`QueueFullError`, :class:`ServerClosedError`)
  are re-raised client-side with their fields intact.

The client tracks its submissions in order; :meth:`collect` returns
their records in that order — the exact list ``Campaign.run`` would
return for the same points — and clears the pending set.
"""
from __future__ import annotations

import socket
import threading
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.core.campaign import Point
from repro_torch.core.emulator import Trace
from repro_torch.core.timescale import SystemConfig
from repro_torch.service import net

__all__ = ["SweepClient"]


class SweepClient:
    """One tenant of a sweep server (in-process or over a socket).

    Args:
        server: a live :class:`SweepServer` for in-process use.
        address: ``(host, port)`` of a listening server; mutually
            exclusive with ``server``.
        name: client name (server-assigned when None); shows up in
            ``stats()["clients"]``.
        weight: fair-share weight (2.0 == twice the dispatch share of a
            1.0 client under contention).
    """

    def __init__(self, server=None,
                 address: Optional[Tuple[str, int]] = None,
                 name: Optional[str] = None, weight: float = 1.0):
        if (server is None) == (address is None):
            raise ValueError("pass exactly one of server= or address=")
        self._server = server
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._pending: List[Any] = []   # Futures (in-process) or ticket ids
        if server is not None:
            self.name = server.register(name, weight)
        else:
            self._sock = socket.create_connection(address)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.name = self._request({"op": "hello", "name": name,
                                       "weight": weight})

    # ----------------------------------------------------------- transport

    def _request(self, msg: dict) -> Any:
        with self._lock:
            if self._sock is None:
                raise ConnectionError("client is closed")
            net.send_msg(self._sock, msg)
            resp = net.recv_msg(self._sock)
        if resp is None:
            raise ConnectionError("sweep server closed the connection")
        if "err" in resp:
            raise resp["err"]
        return resp["ok"]

    # ----------------------------------------------------------- submission

    def submit(self, trace: Trace, sys: SystemConfig, mode: str = "ts",
               bloom: Optional[tuple] = None, **meta) -> None:
        """Queue one grid point (meta keys ride into its record, as in
        ``Campaign.add``). Raises the service's typed errors
        immediately on backpressure or closure — nothing is buffered
        client-side."""
        self.submit_points([Point(trace, sys, mode, bloom, meta)])

    def submit_points(self, points: Sequence[Point]) -> int:
        """Atomically queue several points; returns how many are now
        pending. All-or-nothing: on :class:`QueueFullError` none of
        ``points`` was admitted."""
        points = list(points)
        if self._server is not None:
            futs = self._server.submit_points(self.name, points)
            with self._lock:
                self._pending.extend(futs)
        else:
            tids = self._request({"op": "submit", "client": self.name,
                                  "points": points})
            with self._lock:
                self._pending.extend(tids)
        return len(self._pending)

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------- results

    def collect(self, timeout: Optional[float] = None,
                return_errors: bool = False) -> List[dict]:
        """Block for every pending point and return their records in
        submission order (equal to ``Campaign.run`` over the same
        points), clearing the pending set. A failed point raises
        its error — or, with ``return_errors=True``, appears in-place
        as the exception object. On ``timeout`` (seconds, whole-call)
        raises :class:`concurrent.futures.TimeoutError` and keeps the
        pending set intact."""
        with self._lock:
            handles = list(self._pending)
        if self._server is not None:
            out: List[Any] = []
            for fut in handles:
                try:
                    out.append(fut.result(timeout))
                except FutureTimeout:
                    raise
                except (Exception, CancelledError) as e:
                    if not return_errors:
                        raise
                    out.append(e)
        else:
            got = self._request({"op": "wait", "ids": handles,
                                 "timeout": timeout})
            if any(got[t][0] == "pending" for t in handles):
                raise FutureTimeout(
                    f"{sum(1 for t in handles if got[t][0] == 'pending')} "
                    f"point(s) still pending after {timeout}s")
            out = []
            for tid in handles:
                kind, payload = got[tid]
                if kind == "error" and not return_errors:
                    raise payload
                out.append(payload)
        with self._lock:
            self._pending = self._pending[len(handles):]
        return out

    # --------------------------------------------------------------- misc

    def stats(self) -> dict:
        """The server's stats snapshot (see ``SweepServer.stats``)."""
        if self._server is not None:
            return self._server.stats()
        return self._request({"op": "stats"})

    def close(self) -> None:
        """Drop the connection (socket mode); pending results on the
        server are abandoned. In-process clients have nothing to close."""
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def __enter__(self) -> "SweepClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
