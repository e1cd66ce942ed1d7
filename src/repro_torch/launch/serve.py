"""Serving launcher: batched greedy generation for a dense or MoE LM.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \
      --preset tiny --batch 4 --prompt-len 128 --new 16 [--device cpu]

Weights and prompts are random, from seed 0 as in the reference. The
device defaults to CUDA.

Also fronts the sweep service (a shared multi-client campaign server):

  PYTHONPATH=src python -m repro_torch.launch.serve sweep --port 7421

which is ``python -m repro_torch.service`` (see that module for the
flags; ``--device cpu`` runs the plain PyTorch engine).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.launch.train import PRESETS, preset_config
from repro_torch.models import model_zoo
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "sweep":
        from repro_torch.service.__main__ import main as sweep_main
        sweep_main(argv[1:])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = preset_config(args.arch, args.preset)
    s_max = args.prompt_len + args.new
    model = model_zoo.build(cfg, s_max=s_max)
    params = model.init(0, device=args.device)
    engine = ServeEngine(model, params, s_max=s_max)

    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    t0 = time.perf_counter()
    outs = engine.generate_batch(prompts, args.new)
    dt = time.perf_counter() - t0
    dev = params["embed"].device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} on {name}: {args.batch}x{args.new} tokens in "
          f"{dt:.2f}s ({args.batch * args.new / dt:.1f} tok/s, "
          f"timeouts={engine.timeouts})")
    print("sample:", outs[0].tolist())


if __name__ == "__main__":
    main()
