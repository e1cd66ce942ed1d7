"""SweepServer: admission, cross-client coalescing, fairness,
backpressure and graceful drain around one warm emulator engine.

Architecture (one server, one process-wide warm engine):

* **Admission** — ``submit*`` appends to the calling client's bounded
  queue under the server lock. Bounds are enforced atomically per call
  (per-client ``max_pending`` outstanding points, global ``max_queue``);
  an over-bound submission raises :class:`QueueFullError` at once —
  backpressure is a typed error, never a hang — and a closed server
  raises :class:`ServerClosedError`.
* **Fairness** — the dispatcher moves queued points into coalescing
  buckets in weighted stride order: each client carries a virtual time
  advanced by ``1/weight`` per admitted point, the lowest virtual time
  goes first, and an idle client re-entering catches up to the active
  minimum (it must not burn saved credit starving others). Under
  contention (full buckets slicing at ``max_batch``, bounded in-flight
  dispatches) a weight-2 client lands ~2x the points per dispatch slice
  of a weight-1 client, and no client starves.
* **Coalescing** — buckets key on the campaign ``group_key`` (length
  bucket, SystemConfig — policy and faults ride it — mode, Bloom shape,
  policy-table bucket), so points from DIFFERENT clients that a
  ``Campaign`` would batch together share one dispatch here too. A
  bucket flushes when it reaches ``max_batch`` or its oldest point has
  waited ``coalesce_window_s``. Flushed buckets become executor tasks
  through ``emulator.prepare_tasks``, the path ``Campaign.run`` takes,
  so the records equal a direct campaign over the same points: slot
  budgets and batch padding differ by composition, which the engine's
  ``run == run_many`` contract makes result-invariant. Each dispatch
  runs on an executor worker's CUDA stream, after what the dispatcher
  thread had queued on its own (``executor.submit_task``); only host
  records reach a future.
* **Demux** — each dispatch's finalize writes disjoint ``outs`` slots;
  completion resolves per-point futures with ``{**out, **meta}``
  records, exactly ``Campaign.run``'s merge.
* **Checkpoints** — with ``checkpoint=dir``, every completed dispatch
  saves its group results at the Campaign's content address
  (``group-<digest>.pkl`` via ``campaign._group_digest``), and a
  dispatch whose file exists is served from it with nothing launched.
  On a non-draining close the still-queued points are written as a
  ``pending-*.pkl`` manifest (:func:`load_pending`), so an interrupted
  multi-client sweep resumes: finished groups load, unfinished groups
  recompute.
* **Shutdown** — ``close(drain=True)`` (default) stops admission,
  flushes every bucket and waits for in-flight dispatches;
  ``drain=False`` fails queued points fast with
  :class:`ServerClosedError` (after writing the pending manifest) but
  still waits for in-flight dispatches — a kernel launch cannot be
  interrupted, only awaited. Live servers are closed non-draining from an
  ``atexit`` hook that runs before the executor pool poisons itself, so
  a client process that exits without ``close()`` leaves no dispatch
  thread behind.

``device`` (:class:`ServiceConfig`) is the engine's torch device; None
means CUDA, and the server raises without one.
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import hashlib
import os
import pickle
import threading
import time
import weakref
from concurrent.futures import CancelledError, Future
from typing import Dict, List, Optional, Sequence

from repro_torch.core import campaign as _campaign
from repro_torch.core import emulator, executor
from repro_torch.core.campaign import Point
from repro_torch.core.emulator import Trace
from repro_torch.core.timescale import SystemConfig
from repro_torch.kernels import ops

__all__ = ["QueueFullError", "ServerClosedError", "ServiceConfig",
           "SweepServer", "load_pending"]


class QueueFullError(RuntimeError):
    """Typed backpressure: the submission would exceed the client's
    ``max_pending`` or the server's ``max_queue`` outstanding-point
    bound. Carries enough to back off intelligently."""

    def __init__(self, client: str, requested: int, outstanding: int,
                 bound: int, scope: str):
        self.client, self.requested = client, requested
        self.outstanding, self.bound, self.scope = outstanding, bound, scope
        super().__init__(
            f"sweep-service {scope} queue full for client {client!r}: "
            f"{outstanding} outstanding + {requested} requested > "
            f"{bound} bound; drain results (collect) or raise the bound")

    def __reduce__(self):  # keep the typed fields across the socket
        return (QueueFullError, (self.client, self.requested,
                                 self.outstanding, self.bound, self.scope))


class ServerClosedError(RuntimeError):
    """The server is closed (or closing): no new submissions, and on a
    non-draining close, queued but undispatched points fail with this.
    ``checkpoint`` names the pending-manifest directory when one was
    written (resume through :func:`load_pending`)."""

    def __init__(self, msg: str, checkpoint: Optional[str] = None):
        self.checkpoint = checkpoint
        self._msg = msg
        super().__init__(msg + (f" (pending manifest in {checkpoint})"
                                if checkpoint else ""))

    def __reduce__(self):  # keep the typed fields across the socket
        return (ServerClosedError, (self._msg, self.checkpoint))


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Server knobs; defaults suit a single-host shared engine."""
    max_batch: int = 128            # points per coalesced dispatch
    coalesce_window_s: float = 0.004  # max wait for cross-client merges
    max_pending: int = 256          # per-client outstanding bound
    max_queue: int = 2048           # global outstanding bound
    max_inflight: Optional[int] = None  # concurrent dispatches (None ->
    #   executor.workers() on a card, 1 on the CPU, where the plain
    #   engine's threads would only contend for the GIL)
    checkpoint: Optional[str] = None    # group-checkpoint directory
    persistent_cache: bool = False      # load the kernel library at start
    device: Optional[str] = None        # the engine's device (None: CUDA)

    def __post_init__(self):
        for name in ("max_batch", "max_pending", "max_queue"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.coalesce_window_s < 0:
            raise ValueError(f"coalesce_window_s must be >= 0, "
                             f"got {self.coalesce_window_s}")


@dataclasses.dataclass
class _Job:
    point: Point
    future: Future
    client: str
    t_submit: float


@dataclasses.dataclass
class _Client:
    name: str
    weight: float
    vtime: float = 0.0
    queue: "collections.deque[_Job]" = dataclasses.field(
        default_factory=collections.deque)
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    outstanding: int = 0


@dataclasses.dataclass
class _Bucket:
    jobs: List[_Job]
    t_open: float


@dataclasses.dataclass
class _Dispatch:
    key: tuple
    jobs: List[_Job]
    outs: List[Optional[dict]]
    t_start: float
    n_tasks: int = 0
    n_done: int = 0
    failure: Optional[executor.TaskFailure] = None
    loaded: bool = False


def _group_label(key: tuple) -> str:
    """Stable short display label of one group key (stats dicts need
    hashable, JSON-friendly keys; the key's repr is stable: a policy
    program reprs by its table)."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:10]


def load_pending(directory: str) -> List[Point]:
    """Load every ``pending-*.pkl`` manifest a non-draining
    :meth:`SweepServer.close` left in ``directory`` and return the
    unexecuted :class:`Point` objects (submission order within each
    manifest). Feed them back through a ``Campaign`` (or a new server)
    with ``checkpoint=directory``: the finished groups load from their
    checkpoints while these recompute. Unpickles: load only manifests
    this program wrote."""
    pts: List[Point] = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("pending-") and name.endswith(".pkl"):
            with open(os.path.join(directory, name), "rb") as fh:
                pts.extend(pickle.load(fh))
    return pts


_LIVE_SERVERS: "weakref.WeakSet[SweepServer]" = weakref.WeakSet()


def _close_live_servers() -> None:
    """Close every live server without draining, at interpreter exit.
    Registered after ``executor.shutdown`` (imported above), so it runs
    first: in-flight dispatches settle before the pool is poisoned."""
    for srv in list(_LIVE_SERVERS):
        try:
            srv.close(drain=False, timeout=10.0)
        except Exception:   # exit goes on whatever one server does
            pass


atexit.register(_close_live_servers)


class SweepServer:
    """A long-lived multi-client campaign server over one warm engine.

    See the module docstring for the architecture. The in-process API
    (used by :class:`repro_torch.service.client.SweepClient` and by the
    socket layer in :mod:`repro_torch.service.net`):

    * :meth:`register` a client (name and fairness weight),
    * :meth:`submit` / :meth:`submit_points` points (a
      :class:`concurrent.futures.Future` per point, resolving to the
      record ``Campaign.run`` would give),
    * :meth:`stats` for queue depths, coalescing ratios, plan-cache
      deltas and latency percentiles,
    * :meth:`listen` to accept socket clients,
    * :meth:`close` to drain and shut down (also a context manager).
    """

    def __init__(self, config: Optional[ServiceConfig] = None, **overrides):
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = emulator.resolve_device(config.device)
        if config.persistent_cache:
            if self.device.type != "cuda":
                raise ValueError(
                    f"persistent_cache loads the CUDA kernel library; no "
                    f"kernel library exists on {self.device}")
            ops.library()   # so that no dispatch pays for nvcc
        if config.checkpoint:
            os.makedirs(config.checkpoint, exist_ok=True)

        self._cond = threading.Condition()
        self._clients: Dict[str, _Client] = {}
        self._buckets: "collections.OrderedDict[tuple, _Bucket]" = \
            collections.OrderedDict()
        self._inflight: Dict[int, _Dispatch] = {}
        self._closed = False
        self._drain = True
        self._stopped = threading.Event()
        self._listener = None          # net._Listener while listening
        self._anon = 0

        # stats (under self._cond's lock)
        self._n_dispatches = 0
        self._n_loaded = 0
        self._n_points_dispatched = 0
        self._n_client_slots = 0       # distinct clients, summed by dispatch
        self._n_policy_slots = 0       # runtime-policy points dispatched
        self._groups: Dict[str, Dict[str, int]] = {}
        self._latencies: "collections.deque[float]" = \
            collections.deque(maxlen=4096)
        cs = emulator.cache_stats()
        self._cache_base = {"hits": cs["hits"], "misses": cs["misses"]}

        self._dispatcher = threading.Thread(
            target=self._loop, name="repro-sweep-dispatch", daemon=True)
        self._dispatcher.start()
        _LIVE_SERVERS.add(self)

    # ------------------------------------------------------------- admission

    def register(self, name: Optional[str] = None,
                 weight: float = 1.0) -> str:
        """Register (or re-register) a client; returns its name. ``weight``
        sets the fair-share ratio (2.0 is twice the dispatch share of a
        1.0 client under contention). Re-registering adjusts the weight
        and keeps the counters."""
        if weight <= 0:
            raise ValueError(f"client weight must be > 0, got {weight}")
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is closed")
            if name is None:
                self._anon += 1
                name = f"client-{self._anon}"
            c = self._clients.get(name)
            if c is None:
                self._clients[name] = _Client(name=name, weight=float(weight))
            else:
                c.weight = float(weight)
            return name

    def _client(self, name: str) -> _Client:
        c = self._clients.get(name)
        if c is None:
            raise ValueError(f"unknown client {name!r}; register() first")
        return c

    def submit(self, client: str, trace: Trace, sys: SystemConfig,
               mode: str = "ts", bloom: Optional[tuple] = None,
               **meta) -> Future:
        """Submit one grid point for ``client``; returns a Future that
        resolves to the record ``Campaign.run`` would give for the same
        point (the engine's outputs merged with ``meta``). Raises
        :class:`QueueFullError` / :class:`ServerClosedError`, and
        ``ValueError`` for an invalid point (``Campaign.add``'s
        checks)."""
        emulator.check_mode(mode)
        if not isinstance(trace, Trace):
            raise ValueError(
                f"sweep-service points need a Trace, got "
                f"{type(trace).__name__} (stream points are unsupported "
                f"over the service; drive emulator.run_stream directly)")
        return self.submit_points(client, [Point(trace, sys, mode, bloom,
                                                 meta)])[0]

    def submit_points(self, client: str,
                      points: Sequence[Point]) -> List[Future]:
        """Atomic multi-point admission: either every point is admitted
        (in order) or none is and :class:`QueueFullError` says which bound
        would overflow. Stream points are refused (``ValueError``): their
        inputs are one-shot iterators that cannot be coalesced or
        checkpointed."""
        points = list(points)
        for p in points:
            if p.stream:
                raise ValueError(
                    "stream points are unsupported over the sweep service; "
                    "use Campaign(stream=True) or emulator.run_stream")
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is closed")
            c = self._client(client)
            if c.outstanding + len(points) > self.config.max_pending:
                c.rejected += len(points)
                raise QueueFullError(client, len(points), c.outstanding,
                                     self.config.max_pending, "per-client")
            total = sum(cl.outstanding for cl in self._clients.values())
            if total + len(points) > self.config.max_queue:
                c.rejected += len(points)
                raise QueueFullError(client, len(points), total,
                                     self.config.max_queue, "global")
            if c.outstanding == 0:
                # an idle client re-entering catches its virtual time up to
                # the active minimum: banked idle credit cannot starve the
                # clients that are active now
                active = [cl.vtime for cl in self._clients.values()
                          if cl.outstanding > 0]
                if active:
                    c.vtime = max(c.vtime, min(active))
            now = time.monotonic()
            futs = []
            for p in points:
                job = _Job(point=p, future=Future(), client=client,
                           t_submit=now)
                c.queue.append(job)
                futs.append(job.future)
            c.submitted += len(points)
            c.outstanding += len(points)
            self._cond.notify_all()
            return futs

    # ------------------------------------------------------------ dispatcher

    def _drain_queues_locked(self) -> None:
        """Move queued jobs into coalescing buckets in weighted stride
        order (lowest client virtual time first, +1/weight per point).
        Order within a bucket is the fair order, so when a bucket slices
        at ``max_batch`` under load, each slice carries clients in weight
        proportion."""
        now = time.monotonic()
        while True:
            eligible = [c for c in self._clients.values() if c.queue]
            if not eligible:
                return
            c = min(eligible, key=lambda cl: (cl.vtime, cl.name))
            job = c.queue.popleft()
            c.vtime += 1.0 / c.weight
            key = job.point.group_key()
            b = self._buckets.get(key)
            if b is None:
                self._buckets[key] = _Bucket(jobs=[job], t_open=now)
            else:
                b.jobs.append(job)

    def _take_flushes_locked(self, force: bool):
        """Pop the bucket slices ready to dispatch, within the in-flight
        cap. Returns (flushes, seconds until the next deadline)."""
        cap = self.config.max_inflight or (
            max(1, executor.workers()) if self.device.type == "cuda" else 1)
        now = time.monotonic()
        flushes, next_dl = [], None
        for key in list(self._buckets):
            if len(self._inflight) + len(flushes) >= cap:
                next_dl = 0.05  # check again soon; a demux notifies anyway
                break
            b = self._buckets[key]
            ripe = force or len(b.jobs) >= self.config.max_batch \
                or (now - b.t_open) >= self.config.coalesce_window_s
            if not ripe:
                dl = b.t_open + self.config.coalesce_window_s - now
                next_dl = dl if next_dl is None else min(next_dl, dl)
                continue
            slice_, rest = (b.jobs[:self.config.max_batch],
                            b.jobs[self.config.max_batch:])
            if rest:
                b.jobs = rest   # keeps t_open: the rest has waited too
                next_dl = 0.0 if next_dl is None else min(next_dl, 0.0)
            else:
                del self._buckets[key]
            flushes.append((key, slice_))
        return flushes, next_dl

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._closed and not self._drain:
                    break   # abort mode: queued work fails, never runs
                self._drain_queues_locked()
                closing = self._closed
                # drain mode flushes regardless of the window
                flushes, next_dl = self._take_flushes_locked(closing)
                if not flushes:
                    if closing and not self._buckets and not self._inflight \
                            and not any(c.queue
                                        for c in self._clients.values()):
                        break
                    timeout = 0.5 if next_dl is None \
                        else min(max(next_dl, 0.0) + 1e-4, 0.5)
                    self._cond.wait(timeout)
                    continue
            for key, jobs in flushes:
                self._dispatch(key, jobs)
        if not self._drain:
            self._abort_pending()
        self._await_inflight()
        self._stopped.set()

    def _dispatch(self, key: tuple, jobs: List[_Job]) -> None:
        """Build and launch one coalesced dispatch on the dispatcher
        thread: the plan lookups and the kernel library's build stay on
        one thread, as in ``Campaign.run``'s prepare phase, and the tasks
        wait for what this thread queued on its CUDA stream. A failure to
        prepare fails exactly this dispatch's futures, never the
        server."""
        pts = [j.point for j in jobs]
        p0 = pts[0]
        disp = _Dispatch(key=key, jobs=jobs, outs=[None] * len(pts),
                         t_start=time.monotonic())
        try:
            ckpt_path = None
            if self.config.checkpoint:
                ckpt_path = os.path.join(
                    self.config.checkpoint,
                    f"group-{_campaign._group_digest(key, pts)}.pkl")
                if os.path.exists(ckpt_path):
                    with open(ckpt_path, "rb") as fh:
                        outs = pickle.load(fh)
                    if len(outs) == len(pts) and all(
                            o is not None for o in outs):
                        disp.outs = outs
                        disp.loaded = True
                        self._finish(disp)
                        return
            blooms = None
            if p0.bloom is not None:
                same = all(p.bloom is p0.bloom for p in pts)
                blooms = p0.bloom if same else [p.bloom for p in pts]
            # runtime-policy points group apart from staged and legacy
            # ones (their group key has a policy element), so a whole
            # dispatch rides the policy tables
            pkw = {} if p0.policy is None else dict(
                policies=[p.policy for p in pts],
                policy_costs=[p.policy_cost for p in pts])
            tasks = emulator.prepare_tasks(
                [p.trace for p in pts], p0.sys, [p.mode for p in pts],
                blooms, disp.outs, device=self.device, **pkw)
            if ckpt_path is not None:
                for t in tasks:
                    t.finalize = _campaign._checkpointed(
                        t.finalize, disp.outs, ckpt_path)
            disp.n_tasks = len(tasks)
            with self._cond:
                self._inflight[id(disp)] = disp
            for t in tasks:
                executor.submit_task(t).add_done_callback(
                    lambda f, d=disp: self._task_done(d, f))
        except Exception as e:
            with self._cond:
                self._inflight.pop(id(disp), None)
            self._fail_jobs(jobs, e)

    def _task_done(self, disp: _Dispatch, fut: Future) -> None:
        """Worker-thread callback: count the dispatch's tasks down and
        demultiplex when the last one settles."""
        try:
            failure = fut.result()
        except (Exception, CancelledError) as e:
            # the pool itself failed the task or cancelled it at shutdown
            failure = executor.TaskFailure(None, "", e, 0)
        with self._cond:
            disp.n_done += 1
            if failure is not None and disp.failure is None:
                disp.failure = failure
            last = disp.n_done >= disp.n_tasks
        if last:
            self._finish(disp)

    def _finish(self, disp: _Dispatch) -> None:
        """Demultiplex one settled dispatch back to per-client futures
        and fold in its stats. The record merge (``{**out, **meta}``, with
        the meta-clash ValueError) is ``Campaign.run``'s."""
        now = time.monotonic()
        for job, out in zip(disp.jobs, disp.outs):
            if disp.failure is not None and out is None:
                job.future.set_exception(disp.failure.error)
            elif out is None:
                job.future.set_exception(RuntimeError(
                    f"dispatch {_group_label(disp.key)} finished without "
                    f"a result for client {job.client!r}"))
            else:
                clash = set(out) & set(job.point.meta)
                if clash:
                    job.future.set_exception(ValueError(
                        f"meta keys shadow emulator result fields: "
                        f"{sorted(clash)}"))
                else:
                    job.future.set_result({**out, **job.point.meta})
        with self._cond:
            self._inflight.pop(id(disp), None)
            self._n_dispatches += 1
            self._n_loaded += int(disp.loaded)
            self._n_points_dispatched += len(disp.jobs)
            self._n_client_slots += len({j.client for j in disp.jobs})
            npol = sum(1 for j in disp.jobs if j.point.policy is not None)
            self._n_policy_slots += npol
            g = self._groups.setdefault(
                _group_label(disp.key),
                {"points": 0, "dispatches": 0, "policies": 0})
            g["points"] += len(disp.jobs)
            g["dispatches"] += 1
            g["policies"] += npol
            for job in disp.jobs:
                c = self._clients.get(job.client)
                if c is not None:
                    c.completed += 1
                    c.outstanding -= 1
                self._latencies.append(now - job.t_submit)
            self._cond.notify_all()

    def _fail_jobs(self, jobs: Sequence[_Job], err: BaseException) -> None:
        for job in jobs:
            job.future.set_exception(err)
        with self._cond:
            for job in jobs:
                c = self._clients.get(job.client)
                if c is not None:
                    c.outstanding -= 1
            self._cond.notify_all()

    # --------------------------------------------------------------- close

    def _abort_pending(self) -> None:
        """Non-draining close: save the still-queued points as a pending
        manifest (when checkpointing), then fail their futures fast."""
        with self._cond:
            jobs: List[_Job] = []
            for b in self._buckets.values():
                jobs.extend(b.jobs)
            self._buckets.clear()
            for c in self._clients.values():
                jobs.extend(c.queue)
                c.queue.clear()
        ckpt = self.config.checkpoint
        if jobs and ckpt:
            path = os.path.join(ckpt, f"pending-{os.getpid()}.pkl")
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as fh:
                pickle.dump([j.point for j in jobs], fh,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        self._fail_jobs(jobs, ServerClosedError(
            f"server closed before dispatching {len(jobs)} queued "
            f"point(s)", checkpoint=ckpt if jobs else None))

    def _await_inflight(self) -> None:
        with self._cond:
            while self._inflight:
                self._cond.wait(0.1)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Shut the server down. ``drain=True`` (default) dispatches
        everything admitted and waits for it; ``drain=False`` fails queued
        points fast (writing the pending manifest when checkpointing) but
        still awaits in-flight dispatches. ``timeout`` bounds the wait for
        the dispatcher. Idempotent; afterwards every ``submit`` raises
        :class:`ServerClosedError`."""
        with self._cond:
            already = self._closed
            self._closed = True
            self._drain = self._drain and drain
            self._cond.notify_all()
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        if not already or self._dispatcher.is_alive():
            self._dispatcher.join(timeout)
        self._stopped.wait(0 if timeout is None else timeout)
        _LIVE_SERVERS.discard(self)

    def __enter__(self) -> "SweepServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # --------------------------------------------------------------- stats

    def listen(self, host: str = "127.0.0.1", port: int = 0):
        """Start accepting socket clients; returns the bound ``(host,
        port)``. See :mod:`repro_torch.service.net` for the protocol
        (length-prefixed pickle frames: trusted networks only; the
        default bind is loopback)."""
        from repro_torch.service import net
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is closed")
            if self._listener is not None:
                raise RuntimeError("server is already listening")
        self._listener = net.serve(self, host, port)
        return self._listener.address

    def stats(self) -> dict:
        """One consistent snapshot of the service: per-client and
        per-group counters, coalescing ratios (``coalesce_ratio`` is the
        mean number of DISTINCT CLIENTS per dispatch, above 1.0 when
        points of different clients share dispatches;
        ``points_per_dispatch`` the batching ratio), the plan cache's
        hit and miss deltas since the server started (``compile``, under
        the reference's name, with the cache's counters and the kernel
        library's on-disk build), and latency percentiles from submission
        to result, in ms."""
        with self._cond:
            lat = sorted(self._latencies)
            nd = self._n_dispatches

            def pct(p: float) -> float:
                if not lat:
                    return 0.0
                return lat[min(len(lat) - 1, int(p * (len(lat) - 1)))]

            out = {
                "clients": {
                    c.name: {"weight": c.weight, "submitted": c.submitted,
                             "completed": c.completed,
                             "rejected": c.rejected,
                             "queue_depth": c.outstanding}
                    for c in self._clients.values()},
                "groups": {k: dict(v) for k, v in self._groups.items()},
                "dispatches": {
                    "count": nd, "loaded_from_checkpoint": self._n_loaded,
                    "points": self._n_points_dispatched,
                    "policy_points": self._n_policy_slots,
                    "inflight": len(self._inflight),
                    "bucketed": sum(len(b.jobs)
                                    for b in self._buckets.values()),
                },
                "points_per_dispatch": (self._n_points_dispatched / nd
                                        if nd else 0.0),
                "coalesce_ratio": (self._n_client_slots / nd if nd else 0.0),
                # runtime-policy points per dispatch (a one-dispatch sweep
                # of 256 policies shows 256.0)
                "policies_per_dispatch": (self._n_policy_slots / nd
                                          if nd else 0.0),
                "rejected": sum(c.rejected for c in self._clients.values()),
                "latency_ms": {
                    "p50": round(pct(0.50) * 1e3, 3),
                    "p90": round(pct(0.90) * 1e3, 3),
                    "p99": round(pct(0.99) * 1e3, 3),
                    "n": len(lat),
                },
                "closed": self._closed,
                "device": str(self.device),
            }
        cs = emulator.cache_stats()
        out["compile"] = {
            "hits": cs["hits"] - self._cache_base["hits"],
            "misses": cs["misses"] - self._cache_base["misses"],
            "cache": {k: cs[k] for k in
                      ("hits", "misses", "evictions", "size", "capacity",
                       "lookups")},
            "persistent": cs["persistent"],
        }
        return out
