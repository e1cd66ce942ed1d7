"""Overlapped campaign executor: run prepared batch groups across a pool of
worker threads, each on a CUDA stream of its own, instead of the serial
pack -> launch -> copy-back loop.

Why threads and streams: a group's host work (padding, ``np.stack``, the
upload) is Python and NumPy; its device work is one ``slot_scan`` launch
of one warp per trace row, which occupies a few of the card's SMs; its
copy-back blocks until the scan ends. The kernel launch goes through
ctypes, which releases the GIL, and ``.cpu()`` releases it while it
waits, so while one worker waits for its group's scan another packs and
launches the next group, and on its own stream that scan runs beside the
first on the card. Torch keeps the current stream per thread: each worker
runs its task inside ``torch.cuda.stream(s)`` on a stream it keeps for
the life of the thread, and ``kernels.ops.stream_handle`` hands every
launch of that task that stream. A task starts after the work its caller
had queued on the caller's current stream (an event recorded at
submission), and every tensor of a task is allocated on its worker's
stream, so the caching allocator never hands its memory to another
stream early.

Determinism contract (the reference's):

* A :class:`GroupTask` is *prepared* on the caller's thread: grouping,
  slot budgets and the kernel library's build happen there, before any
  worker starts.
* Each task's ``finalize`` writes only its own result slots (disjoint
  indices of a shared list), so concurrent finalization needs no lock.
* Execution is bit-identical to the serial loop by construction: the same
  kernels run on the same packed arrays; only wall-clock interleaving
  changes. ``execute(tasks, serial=True)`` keeps the in-order loop on the
  caller's thread and stream.

The pool is module-level and lazily built (``REPRO_EXEC_WORKERS`` caps
it, default ``min(cpu_count, 8)``); :func:`set_workers` resizes it.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GroupTask", "StreamTask", "TaskFailure", "ExecutionError",
           "execute", "submit_task", "set_workers", "workers",
           "shutdown", "is_shutdown"]


def _host(v):
    """A task output gathered on the host (a CUDA tensor's copy-back
    blocks on the current stream only)."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class GroupTask:
    """One batch group, prepared but not yet executed.

    ``pack`` builds the group's inputs (pad, stack, upload) and returns
    ``(args, ctx)``; ``fn(*args)`` launches the group's kernels and returns
    its output tensors by field; ``finalize`` receives the gathered NumPy
    outputs plus ``ctx`` and writes per-trace records into the caller's
    result slots. ``device`` is the torch device the group runs on (a
    worker runs a CUDA group on its own stream). ``pack``, ``fn`` and
    ``finalize`` run on a worker thread in overlapped mode: keep them free
    of shared mutable state beyond the disjoint result slots.
    """
    fn: Callable[..., Any]
    pack: Callable[[], Tuple[tuple, Any]]
    finalize: Callable[[dict, Any], None]
    label: str = ""
    cost: int = 0   # relative work hint (slots * batch) for LPT order
    device: Optional[torch.device] = None

    # pack() re-pads and re-stacks from the immutable prepared traces and
    # finalize() overwrites the same disjoint slots, so a failed attempt
    # can be retried from scratch
    retryable = True

    def run(self) -> None:
        args, ctx = self.pack()                       # host: pad, stack, upload
        out = self.fn(*args)                          # device: the launches
        self.finalize({k: _host(v) for k, v in out.items()}, ctx)


def _to_host_async(out) -> tuple:
    """Start the copy of a window's outputs to the host without waiting:
    each CUDA tensor into a pinned buffer on the current stream, then an
    event. The device tensors can be dropped at once: the caching
    allocator orders their reuse after the copy on this stream."""
    hosts, stream = [], None
    for o in out:
        if isinstance(o, torch.Tensor) and o.is_cuda:
            stream = torch.cuda.current_stream(o.device)
            o = torch.empty(o.shape, dtype=o.dtype,
                            pin_memory=True).copy_(o, non_blocking=True)
        hosts.append(o)
    return tuple(hosts), None if stream is None else stream.record_event()


def _landed(pending) -> tuple:
    """The NumPy outputs of :func:`_to_host_async` once its copies are
    done. Pinned buffers are copied out, so that they go back to the host
    allocator's cache instead of staying with a consumer."""
    hosts, event = pending
    if event is None:
        return tuple(_host(h) for h in hosts)
    event.synchronize()
    return tuple(np.array(_host(h)) for h in hosts)


@dataclasses.dataclass
class StreamTask:
    """One stream group: a window loop instead of a single launch (see
    ``repro_torch.core.emulator.prepare_stream_tasks``).

    ``pack`` builds the initial carried state plus a host context;
    ``windows(ctx)`` yields one argument tuple per window (the last one
    freeze-lifted to drain the tail in place); ``fn(state, *args)`` stages
    and scans one window and returns ``(new_state, outputs)``; ``consume``
    receives each window's gathered NumPy outputs; ``finalize`` receives
    the final state. The loop is serial per task (state threads window to
    window), but host and device overlap within it, on one thread: a
    window's outputs are copied back one window behind. Its copy is queued
    right after its scan, and the loop assembles the next window (trace
    generation or file parsing, ``np.stack``, the bank check) and queues
    its scan before it waits for that copy and consumes it. So the host's
    work on windows k+1 and k-1 runs while the card scans window k, and no
    window's device outputs outlive its own step. The overlap changes
    wall-clock interleaving only, never the window sequence."""
    fn: Callable[..., Any]
    pack: Callable[[], Tuple[Any, Any]]
    windows: Callable[[Any], Any]        # ctx -> iterable of arg tuples
    consume: Callable[[tuple, Any], None]
    finalize: Callable[[Any, Any], None]
    label: str = ""
    cost: int = 0
    device: Optional[torch.device] = None

    # a failed window loop cannot be replayed: the stream iterators and
    # chunker buffers are partially consumed; never retried
    retryable = False

    def run(self) -> None:
        state, ctx = self.pack()
        behind = None       # the last window's outputs, on their way back
        windows = iter(self.windows(ctx))
        try:
            for args in windows:                    # host: assemble window
                if _SHUTDOWN.is_set():
                    raise RuntimeError(
                        f"stream task {self.label or 'task'!r} aborted: "
                        f"executor shut down")
                state, out = self.fn(state, *args)  # device: queue its scan
                ahead, out = _to_host_async(out), None
                if behind is not None:
                    self.consume(_landed(behind), ctx)
                behind = ahead
            if behind is not None:
                self.consume(_landed(behind), ctx)
        finally:
            close = getattr(windows, "close", None)
            if close is not None:   # a generator's cleanup runs now
                close()
        self.finalize(state, ctx)


def _env_int(name: str, default: int) -> int:
    """An integer environment knob; a bad value warns and falls back."""
    env = os.environ.get(name)
    if not env:
        return default
    try:
        return int(env)
    except ValueError:
        warnings.warn(f"ignoring non-integer {name}={env!r}; "
                      f"using default {default}", stacklevel=2)
        return default


def _workers_default() -> int:
    return max(1, _env_int("REPRO_EXEC_WORKERS",
                           min(os.cpu_count() or 1, 8)))


_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_WORKERS = _workers_default()
# set once, at interpreter exit (or by an explicit shutdown()): refuses
# new dispatches and stops a StreamTask at its next window
_SHUTDOWN = threading.Event()
_LOCAL = threading.local()   # a worker thread's CUDA streams, by device


def workers() -> int:
    """Current overlapped-execution worker count."""
    return _WORKERS


def set_workers(n: int) -> int:
    """Resize the worker pool; returns the previous count. ``n <= 1``
    makes :func:`execute` fall back to the serial in-order loop."""
    global _POOL, _WORKERS
    if n < 1:
        raise ValueError(f"worker count must be >= 1, got {n}")
    with _LOCK:
        old = _WORKERS
        _SHUTDOWN.clear()   # re-arm after an explicit shutdown()
        if n != _WORKERS:
            if _POOL is not None:
                _POOL.shutdown(wait=True)
                _POOL = None
            _WORKERS = n
    return old


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _SHUTDOWN.is_set():
            raise RuntimeError(
                "executor pool is shut down (interpreter exit or explicit "
                "executor.shutdown()); no further dispatches accepted")
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=_WORKERS, thread_name_prefix="repro-exec")
        return _POOL


def is_shutdown() -> bool:
    """True once the executor has been poisoned (interpreter exit or an
    explicit :func:`shutdown`); new dispatches are refused."""
    return _SHUTDOWN.is_set()


def shutdown(wait: bool = False) -> None:
    """Drain and poison the executor for process teardown.

    This runs at interpreter exit before threading joins the pool's
    (non-daemon) workers, so a long stream does not hold the exit up: it
    stops every StreamTask at its next window, cancels queued tasks that
    have not started, and lets running launches finish (a kernel cannot
    be interrupted, only awaited).
    Idempotent; :func:`set_workers` after an explicit shutdown re-arms
    the pool."""
    global _POOL
    _SHUTDOWN.set()
    with _LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=wait, cancel_futures=True)


atexit.register(shutdown)


@dataclasses.dataclass
class TaskFailure:
    """One task that did not complete: the task object, its label, the
    exception from its final attempt, and how many attempts ran (0 for a
    dispatch timeout: the attempt never settled)."""
    task: Any
    label: str
    error: BaseException
    attempts: int


class ExecutionError(RuntimeError):
    """Aggregate of every failed task in one :func:`execute` call. The
    message names every failed label and carries the first underlying
    error's text; ``failures`` holds the full records."""

    def __init__(self, failures: Sequence[TaskFailure]):
        self.failures = list(failures)
        labels = ", ".join(
            (f.label or f"task{i}") for i, f in enumerate(self.failures))
        first = self.failures[0].error
        super().__init__(
            f"{len(self.failures)} task(s) failed [{labels}]; first: "
            f"{type(first).__name__}: {first}")


def _attempt(task: Any, retries: int, backoff: float
             ) -> Optional[TaskFailure]:
    """Run one task to completion with bounded retry-with-backoff. Only
    ``task.retryable`` tasks are re-attempted (GroupTask packing is
    idempotent; a StreamTask's iterators are consumed). Returns None on
    success, else the failure record; never raises."""
    attempts = 0
    while True:
        attempts += 1
        try:
            task.run()
            return None
        except BaseException as e:
            if not getattr(task, "retryable", False) or attempts > retries:
                return TaskFailure(task, getattr(task, "label", ""),
                                   e, attempts)
            time.sleep(backoff * (2 ** (attempts - 1)))


def _cuda_device(task: Any) -> Optional[torch.device]:
    dev = getattr(task, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    dev = torch.device(dev)
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def _caller_events(tasks: Sequence[Any]) -> dict:
    """An event on the submitting thread's current stream for each CUDA
    device the tasks run on: a worker's stream waits for it, so a task
    sees everything its caller queued before the submission."""
    events = {}
    for t in tasks:
        dev = _cuda_device(t)
        if dev is not None and dev not in events:
            events[dev] = torch.cuda.current_stream(dev).record_event()
    return events


def _worker_stream(dev: torch.device) -> "torch.cuda.Stream":
    """This thread's own stream on ``dev``, made at its first task."""
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    s = streams.get(dev)
    if s is None:
        s = streams[dev] = torch.cuda.Stream(device=dev)
    return s


def _attempt_on_worker(task: Any, retries: int, backoff: float,
                       events: dict) -> Optional[TaskFailure]:
    """:func:`_attempt` on a pool thread: a CUDA task runs on the
    thread's own stream, after its caller's queued work."""
    dev = _cuda_device(task)
    if dev is None:
        return _attempt(task, retries, backoff)
    try:
        s = _worker_stream(dev)
        if dev in events:
            s.wait_event(events[dev])
        ctx = torch.cuda.stream(s)
    except BaseException as e:
        return TaskFailure(task, getattr(task, "label", ""), e, 0)
    with ctx:
        return _attempt(task, retries, backoff)


def _defaults(retries: Optional[int], backoff: Optional[float]):
    if retries is None:
        retries = max(0, _env_int("REPRO_EXEC_RETRIES", 0))
    if backoff is None:
        backoff = float(os.environ.get("REPRO_EXEC_BACKOFF_S", "") or 0.05)
    return retries, backoff


def submit_task(task: Any, retries: Optional[int] = None,
                backoff: Optional[float] = None) -> "Future":
    """Submit one prepared task to the worker pool and return its
    :class:`concurrent.futures.Future`, which resolves to ``None`` on
    success or a :class:`TaskFailure` record, never an exception (the
    :func:`execute` semantics, retries included). The task's ``finalize``
    has run by the time the future resolves ``None``. Raises
    ``RuntimeError`` after :func:`shutdown`."""
    retries, backoff = _defaults(retries, backoff)
    return _pool().submit(_attempt_on_worker, task, retries, backoff,
                          _caller_events([task]))


def execute(tasks: Sequence[Any], serial: Optional[bool] = None,
            timeout: Optional[float] = None, retries: Optional[int] = None,
            backoff: Optional[float] = None,
            raise_on_error: bool = True) -> List[TaskFailure]:
    """Run every task; overlapped across the worker pool (each worker on
    its own CUDA stream) unless ``serial`` forces the in-order loop on the
    caller's thread and stream. The default (None) takes that loop too for
    a single task, a single worker, or tasks none of which runs on a card:
    the plain engine on the CPU is thousands of small torch calls a slot,
    each taking the GIL, so its threads would contend instead of overlap
    (``serial=False`` still runs them on the pool). Execution order does
    not affect results (disjoint result slots).

    Failure isolation: a raising task never stops its siblings; every
    task settles, failures are collected into :class:`TaskFailure`
    records, and (``raise_on_error``, the default) one
    :class:`ExecutionError` naming every failed label is raised at the
    end; ``raise_on_error=False`` returns the records instead (what
    ``Campaign.run(on_error='quarantine')`` uses).

    ``retries`` (default ``REPRO_EXEC_RETRIES``, 0) re-attempts each
    *retryable* task with exponential backoff starting at ``backoff``
    seconds (default ``REPRO_EXEC_BACKOFF_S``, 0.05). ``timeout`` (default
    ``REPRO_EXEC_TIMEOUT_S``, none) bounds each task's wall time in
    overlapped mode: a task past its deadline is recorded as a
    ``TimeoutError`` failure and abandoned. Python threads cannot be
    killed, so its worker keeps running detached and may still write its
    result slots later: treat a timed-out sweep's results as tainted. In
    serial mode no second thread watches the clock, so ``timeout`` is not
    enforced."""
    tasks = list(tasks)
    retries, backoff = _defaults(retries, backoff)
    if timeout is None:
        env_t = os.environ.get("REPRO_EXEC_TIMEOUT_S")
        timeout = float(env_t) if env_t else None
    if serial is None:
        serial = len(tasks) <= 1 or _WORKERS <= 1 \
            or not any(_cuda_device(t) is not None for t in tasks)

    failures: List[TaskFailure] = []
    if serial:
        for t in tasks:
            fail = _attempt(t, retries, backoff)
            if fail is not None:
                failures.append(fail)
    else:
        # longest-processing-time first: dispatching expensive groups
        # first shortens the tail where one worker finishes a big group
        # alone (results land in disjoint slots, so order is free)
        tasks.sort(key=lambda t: t.cost, reverse=True)
        events = _caller_events(tasks)
        starts: dict = {}

        def tracked(t):
            starts[id(t)] = time.monotonic()
            return _attempt_on_worker(t, retries, backoff, events)

        pending = {_pool().submit(tracked, t): t for t in tasks}
        if timeout is None:
            for f in pending:           # block; tracked never raises
                fail = f.result()
                if fail is not None:
                    failures.append(fail)
        else:
            while pending:              # poll so deadlines fire on time
                for f in list(pending):
                    t = pending[f]
                    started = starts.get(id(t))
                    if f.done():
                        del pending[f]
                        fail = f.result()
                        if fail is not None:
                            failures.append(fail)
                    elif started is not None \
                            and time.monotonic() - started > timeout:
                        del pending[f]  # abandon; see the docstring
                        failures.append(TaskFailure(
                            t, getattr(t, "label", ""),
                            TimeoutError(
                                f"task {getattr(t, 'label', '')!r} "
                                f"exceeded the {timeout}s dispatch "
                                f"timeout"), 0))
                if pending:
                    time.sleep(0.005)

    if failures and raise_on_error:
        raise ExecutionError(failures)
    return failures
