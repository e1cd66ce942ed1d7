"""Train-step construction (mixed precision, microbatching) and the host
loop.

``make_train_step`` returns the step the launchers call; the ``Trainer``
host loop adds checkpoint/restart, straggler-aware step timing, and data
ingestion (used by examples and fault-tolerance tests). The reference
also shards the step over a device mesh (``rules``: ZeRO-1 state, the
reduce-scatter of the gradients); the port runs on one device, and a
``rules`` argument raises (ROADMAP Queue A 13).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.grad_comp import dequantize, quantize_int8
from repro_torch.models import pdefs
from repro_torch.train import optimizer as opt

_NO_MESH = ("sharding rules (a device mesh, ZeRO-1) are not ported yet "
            "(ROADMAP Queue A 13); the port trains on one device")


def _split(x, k: int, i: int):
    """Microbatch ``i`` of ``k`` of one batch entry: a slice of the
    leading axis when it divides by k, else the whole entry (the
    reference broadcasts such entries to every microbatch)."""
    x = torch.as_tensor(x)
    if x.dim() >= 1 and x.shape[0] % k == 0:
        return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
    return x


def make_train_step(model, opt_cfg: opt.AdamWConfig, rules=None,
                    compute_dtype=torch.bfloat16, grad_compressor=None,
                    num_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    The step casts the float32 masters to a ``compute_dtype`` copy whose
    leaves require grad, takes the loss's gradients in that dtype,
    upcasts them to float32 and updates ``state`` in place
    (``opt.apply_update``). ``grad_compressor`` is ``"int8_wire"`` (each
    gradient leaf quantized to int8 and back) or a callable on the
    gradient tree. ``num_microbatches > 1`` accumulates the microbatches'
    gradients in a float32 tree and divides by their count; the loss is
    their mean, the other metrics the last microbatch's.
    """
    if rules is not None:
        raise NotImplementedError(_NO_MESH)

    def grads_of(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        leaves = pdefs.tree_leaves(params)
        grads = pdefs.tree_unflatten(params,
                                     torch.autograd.grad(loss, leaves))
        if grad_compressor == "int8_wire":
            grads = pdefs.tree_map(
                lambda g: dequantize(*quantize_int8(g.float())).to(g.dtype),
                grads)
        elif grad_compressor is not None:
            grads = grad_compressor(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: opt.AdamWState, batch):
        params = pdefs.tree_map(
            lambda x: x.detach().to(compute_dtype).requires_grad_(),
            state.master)
        k = num_microbatches
        if k == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            # float32 accumulator: compute-dtype microbatch gradients are
            # upcast on add, so accumulation error does not grow with k
            grads = pdefs.tree_map(
                lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device), state.master)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(k):
                mb = {name: _split(x, k, i) for name, x in batch.items()}
                loss, metrics, g = grads_of(params, mb)
                pdefs.tree_map(lambda a, b: a.add_(b.float()), grads, g)
                del g
                lsum = lsum + loss
            grads = pdefs.tree_map(lambda a: a.div_(k), grads)
            loss = lsum / k
        del params
        grads = pdefs.tree_map(lambda g: g.float(), grads)
        new_state, om = opt.apply_update(opt_cfg, state, grads)
        metrics = dict(metrics, loss=loss, **om)
        return new_state, metrics

    return train_step


class Trainer:
    """Host loop: step timing, checkpoint/restart, straggler mitigation.

    Straggler policy: steps are timed against a deadline derived from a
    moving median; a step exceeding ``straggler_factor`` x median is
    logged and counted (on real fleets this triggers re-slicing — here it
    drives the ``on_straggler`` hook). ``device`` holds the state
    (``None`` means CUDA).
    """

    def __init__(self, model, opt_cfg, rules=None, ckpt_dir=None,
                 ckpt_every=50, straggler_factor=3.0, hooks=None,
                 device=None):
        from repro_torch.checkpoint import ckpt as ckpt_mod
        if rules is not None:
            raise NotImplementedError(_NO_MESH)
        self.model = model
        self.opt_cfg = opt_cfg
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_mod = ckpt_mod
        self.straggler_factor = straggler_factor
        self.step_times = []
        self.straggler_events = 0
        self.hooks = hooks or {}
        self._step_fn = make_train_step(model, opt_cfg)

    def init_state(self, seed=0) -> opt.AdamWState:
        params = self.model.init(seed, torch.float32, self.device)
        return opt.init_state(params)

    def restore_or_init(self, seed=0):
        if self.ckpt_dir:
            st = self.ckpt_mod.restore_latest(self.ckpt_dir)
            if st is not None:
                state = self.init_state(seed)
                return self.ckpt_mod.load_into(st, state), True
        return self.init_state(seed), False

    def run(self, state, data_iter, steps, log_every=10):
        history = []
        for i in range(steps):
            t0 = time.perf_counter()
            batch = next(data_iter)
            state, metrics = self._step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                self.straggler_events += 1
                if "on_straggler" in self.hooks:
                    self.hooks["on_straggler"](int(state.step), dt, med)
            history.append(loss)
            if log_every and i % log_every == 0:
                print(f"step {int(state.step):5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if self.ckpt_dir and int(state.step) % self.ckpt_every == 0:
                self.ckpt_mod.save(self.ckpt_dir, state, int(state.step))
        return state, history
