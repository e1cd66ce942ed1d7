"""Standalone sweep-server process.

    PYTHONPATH=src python -m repro_torch.service --port 7421 \
        --checkpoint artifacts/sweep_ckpt --persistent-cache

One process owns the warm engine (plan cache, kernel library, executor
pool); any number of :class:`repro_torch.service.SweepClient` processes
attach over the socket. Also reachable as ``python -m
repro_torch.launch.serve sweep ...``. The engine runs on CUDA unless
``--device cpu`` asks for the plain PyTorch versions. Ctrl-C drains
in-flight work and exits; a second Ctrl-C aborts fast (queued points fail
typed, and with ``--checkpoint`` a pending manifest is written for
:func:`repro_torch.service.load_pending`).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.service import ServiceConfig, SweepServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Persistent multi-client sweep server (shared warm "
                    "emulator engine with cross-client coalescing)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed on start)")
    ap.add_argument("--max-batch", type=int, default=128,
                    help="points per coalesced dispatch")
    ap.add_argument("--coalesce-window-ms", type=float, default=4.0,
                    help="max wait for cross-client merges")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="per-client outstanding-point bound")
    ap.add_argument("--max-queue", type=int, default=2048,
                    help="global outstanding-point bound")
    ap.add_argument("--checkpoint", default=None,
                    help="group-checkpoint directory (resumable sweeps)")
    ap.add_argument("--persistent-cache", action="store_true",
                    help="load (or build) the CUDA kernel library before "
                         "serving, so that no dispatch pays for nvcc")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--stats-every", type=float, default=0.0, metavar="S",
                    help="print a stats line every S seconds")
    args = ap.parse_args(argv)

    cfg = ServiceConfig(
        max_batch=args.max_batch,
        coalesce_window_s=args.coalesce_window_ms / 1e3,
        max_pending=args.max_pending,
        max_queue=args.max_queue,
        checkpoint=args.checkpoint,
        persistent_cache=args.persistent_cache,
        device=args.device,
    )
    srv = SweepServer(cfg)
    host, port = srv.listen(args.host, args.port)
    print(f"sweep service listening on {host}:{port} ({srv.device})",
          flush=True)
    try:
        while True:
            time.sleep(args.stats_every or 3600.0)
            if args.stats_every:
                s = srv.stats()
                d = s["dispatches"]
                print(f"dispatches={d['count']} points={d['points']} "
                      f"coalesce_ratio={s['coalesce_ratio']:.2f} "
                      f"rejected={s['rejected']} "
                      f"p50={s['latency_ms']['p50']}ms", flush=True)
    except KeyboardInterrupt:
        print("draining in-flight dispatches (Ctrl-C again to abort)...",
              flush=True)
        try:
            srv.close(drain=True)
        except KeyboardInterrupt:
            srv.close(drain=False)
    finally:
        srv.close(drain=False)


if __name__ == "__main__":
    main()
