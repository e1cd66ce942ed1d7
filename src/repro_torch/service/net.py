"""Socket transport for the sweep service.

Wire format: 4-byte big-endian length prefix + a pickled Python object
per frame, in both directions. Requests are dicts ``{"op": ..., ...}``;
responses are ``{"ok": payload}`` or ``{"err": exception}`` — the
exception instance itself rides the frame and is re-raised client-side
(the service's typed errors implement ``__reduce__`` for this). Pickle
over a socket executes arbitrary code on load: this transport is for
TRUSTED networks only, and the default bind is loopback.

Ops (all handled by :func:`_handle`, one thread per connection):

* ``hello {name, weight}`` -> registered client name
* ``submit {client, points}`` -> list of ticket ids (atomic admission,
  so a :class:`~repro_torch.service.server.QueueFullError` rejects the
  whole frame)
* ``wait {ids, timeout}`` -> ``{id: ("result", record) | ("error", exc)
  | ("pending", None)}``; resolved tickets are retired, pending ones
  stay claimable
* ``stats {}`` -> the server's stats snapshot

Records are host values (NumPy arrays, Python ints and floats): the
engine copies every output back before a future resolves, so no CUDA
tensor is ever pickled.
"""
from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Optional

__all__ = ["send_msg", "recv_msg", "serve"]

_HEADER = struct.Struct(">I")
MAX_FRAME = 1 << 30  # sanity bound; a frame this large is a protocol bug


def send_msg(sock: socket.socket, obj: Any) -> None:
    """Write one length-prefixed pickle frame."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else buf  # clean EOF only between frames
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[Any]:
    """Read one frame; None on clean EOF (peer closed between frames)."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    if len(header) < _HEADER.size:
        raise ConnectionError("truncated frame header")
    (n,) = _HEADER.unpack(header)
    if n > MAX_FRAME:
        raise ConnectionError(f"oversized frame ({n} bytes)")
    data = _recv_exact(sock, n)
    if data is None or len(data) < n:
        raise ConnectionError("truncated frame body")
    return pickle.loads(data)


def _picklable(err: BaseException) -> BaseException:
    """Some errors a dispatch surfaces refuse to pickle; degrade those to
    a RuntimeError carrying the original type name and message rather
    than killing the connection."""
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:
        return RuntimeError(f"{type(err).__name__}: {err}")


def _handle(server, conn: socket.socket) -> None:
    tickets: dict = {}
    ids = itertools.count(1)
    with conn:
        while True:
            try:
                msg = recv_msg(conn)
            except (ConnectionError, EOFError, OSError, pickle.PickleError):
                break
            if msg is None:
                break
            try:
                op = msg.get("op")
                if op == "hello":
                    resp = {"ok": server.register(msg.get("name"),
                                                  msg.get("weight", 1.0))}
                elif op == "submit":
                    futs = server.submit_points(msg["client"], msg["points"])
                    tids = [next(ids) for _ in futs]
                    tickets.update(zip(tids, futs))
                    resp = {"ok": tids}
                elif op == "wait":
                    out = {}
                    for tid in msg["ids"]:
                        fut = tickets.get(tid)
                        if fut is None:
                            out[tid] = ("error", KeyError(tid))
                            continue
                        try:
                            rec = fut.result(msg.get("timeout"))
                            out[tid] = ("result", rec)
                        except FutureTimeout:
                            out[tid] = ("pending", None)
                            continue
                        except (Exception, CancelledError) as e:
                            out[tid] = ("error", _picklable(e))
                        tickets.pop(tid, None)
                    resp = {"ok": out}
                elif op == "stats":
                    resp = {"ok": server.stats()}
                elif op == "ping":
                    resp = {"ok": "pong"}
                else:
                    resp = {"err": ValueError(f"unknown op {op!r}")}
            except Exception as e:
                resp = {"err": _picklable(e)}
            try:
                send_msg(conn, resp)
            except OSError:
                break


class _Listener:
    """Accept loop for one :class:`SweepServer`; one daemon thread per
    connection. ``close()`` stops accepting — established connections
    finish their current frame and then fail on the closed server."""

    def __init__(self, server, host: str, port: int):
        self._server = server
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()[:2]
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="repro-sweep-accept",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(target=_handle, args=(self._server, conn),
                             name="repro-sweep-conn", daemon=True).start()

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass


def serve(server, host: str = "127.0.0.1", port: int = 0) -> _Listener:
    """Bind and start accepting clients for ``server``; returns the
    listener (its ``.address`` is the bound ``(host, port)``)."""
    return _Listener(server, host, port)
