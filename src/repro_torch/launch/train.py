"""Training launcher: ``--arch <id>`` selects an assigned architecture.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \
      --preset tiny --steps 50 --ckpt /tmp/qwen2_run [--microbatches 4] \
      [--grad-compress] [--device cpu]

The device defaults to CUDA; ``--device cpu`` runs the plain PyTorch
path. With ``--ckpt`` a run resumes from the newest checkpoint there
(saved every 25 steps) and stops at ``--steps`` in all. Reduced presets
make any arch runnable anywhere; ``--preset full`` is the real width.
The reference runs over every local device through a mesh
(``--model-parallel``); the port trains on one device (ROADMAP Queue
A 13).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import ShardedLoader, SyntheticLM
from repro_torch.models import model_zoo
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, make_train_step

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                 vocab_size=512, head_dim=32),
    "small": dict(n_layers=6, d_model=512, n_heads=8, n_kv_heads=4, d_ff=1536,
                  vocab_size=8192, head_dim=64),
    "full": {},
}


def preset_config(arch: str, preset: str):
    """``arch``'s configuration cut to ``preset`` (attention-free
    architectures keep as many kv heads as heads)."""
    cfg = get_config(arch)
    if PRESETS[preset]:
        over = dict(PRESETS[preset])
        if cfg.attn_free:
            over["n_kv_heads"] = over["n_heads"]
        cfg = cfg.scaled(**over)
    return cfg


def main(argv=None):
    """Runs the launcher; returns the run's losses, one a step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel needs a device mesh, not ported yet (ROADMAP "
            "Queue A 13)")

    cfg = preset_config(args.arch, args.preset)
    model = model_zoo.build(cfg, s_max=args.seq)
    trainer = Trainer(model, opt.AdamWConfig(lr=args.lr, warmup=10,
                                             total_steps=max(args.steps, 100)),
                      ckpt_dir=args.ckpt, ckpt_every=25, device=args.device)
    dev = trainer.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} [{args.preset}] params={model.n_params():,} "
          f"device={name}")
    if args.microbatches > 1 or args.grad_compress:
        trainer._step_fn = make_train_step(
            model, trainer.opt_cfg, num_microbatches=args.microbatches,
            grad_compressor="int8_wire" if args.grad_compress else None)
    state, restored = trainer.restore_or_init()
    start = int(state.step)
    if restored:
        print(f"resumed from step {start}")
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    loader = ShardedLoader(src, start_step=start)
    state, hist = trainer.run(state, iter(loader), max(args.steps - start, 0),
                              log_every=10)
    if hist:
        print(f"loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
              f"stragglers={trainer.straggler_events}")
    return hist


if __name__ == "__main__":
    main()
