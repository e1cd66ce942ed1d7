"""The port's training path on the CPU, held against the JAX package on
the same seeded weights and batches: the data pipeline, ``loss_fn`` and
its gradients, AdamW steps, microbatching, int8 gradient compression,
checkpoints (each package resuming the other's), the ``Trainer`` loop
and ``launch.train``. The config is the reference train tests' tiny
qwen2 (2 layers, d_model 32, 2 heads, 2 kv heads of 16, d_ff 64, vocab
128 padded to 2048), S = 16, B = 8.

Tolerances, and why:

* ``loss_fn`` at float32: both sides run the same float32 operations,
  summed in another order by another BLAS. Loss ``rtol=1e-5``; each
  gradient leaf within ``1e-5`` of its largest magnitude (measured: at
  most 1.6e-6, at S = 1152). The key bias's gradient is not zero here:
  RoPE rotates the bias with the key, so ``q . rope(bk)`` changes along
  the keys and the softmax does not cancel it.
* AdamW steps at float32 compute: ``lr`` exact; loss and ``grad_norm``
  ``rtol=1e-5``; m and v within ``1e-4`` of each leaf's largest magnitude
  (measured: 1.0e-5). Masters within ``1e-2 * sum(lr)``: Adam divides by
  sqrt(v), so a rounding difference in a gradient element near zero
  moves its update by up to the step's lr, whatever the leaf's scale
  (measured: 5.3e-4 of sum(lr)).
* bf16 compute: autograd rounds the bf16 gradients in another order than
  XLA's fused backward. Loss ``rtol=1e-3`` (measured 5e-5), ``grad_norm``
  ``rtol=1e-2`` (measured 5.4e-4), masters within ``2 * sum(lr)``, twice
  the largest move Adam's steps make (measured 1.09).
* microbatches 4 against 1 (both the port): ``tests/test_train_infra.py``'s
  own tolerances (loss ``rtol=2e-2``; masters ``rtol=1e-1, atol=2e-3``).
* int8 quantization: exact (the same float32 division, abs-max and
  round-half-to-even). Error feedback: ``rtol=1e-4, atol=1e-5`` as the
  reference's test.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data.pipeline import ShardedLoader as JLoader
from repro.data.pipeline import SyntheticLM as JSynthetic
from repro.distributed import grad_comp as jgc
from repro.models import model_zoo as jzoo
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import make_train_step as jmake_step
from tests.conftest import tiny_cfg

from repro_torch import configs as pconfigs
from repro_torch.checkpoint import ckpt as pckpt
from repro_torch.data.pipeline import ShardedLoader, SyntheticLM
from repro_torch.distributed import grad_comp as pgc
from repro_torch.interop import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.kernels import ops as pops
from repro_torch.launch import train as plaunch
from repro_torch.models import model_zoo as pzoo
from repro_torch.models import pdefs
from repro_torch.train import optimizer as popt
from repro_torch.train.trainer import Trainer, make_train_step

torch.set_num_threads(2)

S, B = 16, 8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of each leaf's largest magnitude
MV_TOL = 1e-4            # of each leaf's largest magnitude
MASTER_LR_TOL = 1e-2     # of the summed learning rates
OCFG = dict(lr=1e-2, warmup=5, total_steps=50, clip_norm=0.05)


def _cfgs():
    jcfg = tiny_cfg("qwen2_1_5b", n_layers=2, d_model=32, n_heads=2,
                    n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=16)
    return jcfg, pconfigs.ArchConfig(**dataclasses.asdict(jcfg))


def seeded_params(jmodel, seed=0, std=0.05):
    """Every leaf of the reference's parameter tree (norm weights and
    biases too) redrawn from a seeded numpy normal, as numpy float32."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32),
        shapes)


@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = _cfgs()
    jmodel = jzoo.build(jcfg, s_max=S)
    pmodel = pzoo.build(pcfg, s_max=S)
    return jcfg, jmodel, pmodel, seeded_params(jmodel)


def jstate_of(np_params):
    return jopt.init_state(jax.tree_util.tree_map(jnp.asarray, np_params))


def pstate_of(np_params):
    return popt.init_state(lm_params_from_numpy(np_params, "cpu"))


def jbatch(b):
    return {k: jnp.asarray(np.asarray(v)) for k, v in b.items()}


def leaves_np(tree):
    return [t.detach().numpy() for t in pdefs.tree_leaves(tree)]


def jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def assert_leaves_scaled(got, want, tol, what):
    """Each leaf within ``tol`` of its largest magnitude."""
    for (name, w), g in zip(jleaves(want), leaves_np(got)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {name}")


def assert_masters(got, want, atol, what):
    for (name, w), g in zip(jleaves(want), leaves_np(got)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol,
                                   err_msg=f"{what} {name}")


# ---------------- data ----------------

def test_synthetic_lm_and_sharded_loader_match_jax():
    """Batches token for token, int32 CPU tensors; host shards and
    ``skip_to``."""
    jsrc, psrc = JSynthetic(128, 16, 8, seed=7), SyntheticLM(128, 16, 8, seed=7)
    np.testing.assert_array_equal(psrc.motifs, jsrc.motifs)
    for step in (0, 3, 11):
        jb, pb = jsrc.batch(step), psrc.batch(step)
        for k in ("tokens", "targets"):
            assert pb[k].dtype == torch.int32 and pb[k].device.type == "cpu"
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
    for host in (0, 1):
        jl = JLoader(jsrc, host_id=host, n_hosts=2, start_step=2)
        pl = ShardedLoader(psrc, host_id=host, n_hosts=2, start_step=2)
        pl.skip_to(5)
        jl.skip_to(5)
        for _ in range(2):
            jb, pb = next(jl), next(pl)
            assert pb["tokens"].shape == (4, 16)
            np.testing.assert_array_equal(pb["tokens"].numpy(),
                                          np.asarray(jb["tokens"]))
    with pytest.raises(ValueError):
        ShardedLoader(psrc, n_hosts=3)


# ---------------- loss and gradients ----------------

@pytest.mark.parametrize("batch,seq", [(8, 16), (1, 1152)])
def test_loss_fn_and_gradients_match_jax(batch, seq):
    """float32 loss and every gradient leaf. S = 16 takes ``_sdpa`` with
    the tril mask; S = 1152 takes ``_sdpa_chunked`` (query blocks of 384,
    each checkpointed) and the chunked CE over blocks of 384
    (``_block_len`` of a length that is not a multiple of 512)."""
    jcfg, pcfg = _cfgs()
    assert pzoo._block_len(seq) == jzoo._block_len(seq)
    jmodel = jzoo.build(jcfg, s_max=seq)
    pmodel = pzoo.build(pcfg, s_max=seq)
    np_params = seeded_params(jmodel)
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params), jbatch(b))
    params = pdefs.tree_map(lambda t: t.requires_grad_(),
                            lm_params_from_numpy(np_params, "cpu"))
    pl, pm = pmodel.loss_fn(params, b)
    grads = pdefs.tree_unflatten(params, torch.autograd.grad(
        pl, pdefs.tree_leaves(params)))
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=LOSS_RTOL)
    assert set(pm) == {"ce", "moe_aux", "moe_z"}
    np.testing.assert_allclose(float(pm["ce"].detach()), float(jm["ce"]),
                               rtol=LOSS_RTOL)
    assert float(pm["moe_aux"]) == 0.0 and float(pm["moe_z"]) == 0.0
    assert_leaves_scaled(grads, jg, GRAD_TOL, f"grad S={seq}")


def test_ce_loss_pad_bias_zloss_and_mask_match_jax():
    """``_ce_loss`` alone: the padded vocab's -1e9 bias, z-loss and a
    token mask, against the reference on the same logits."""
    jcfg, pcfg = _cfgs()
    rng = np.random.RandomState(2)
    logits = (rng.standard_normal((2, 5, jcfg.padded_vocab)) * 3
              ).astype(np.float32)
    targets = rng.randint(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = jzoo._ce_loss(jcfg, jnp.asarray(logits), jnp.asarray(targets),
                             None if m is None else jnp.asarray(m))
        got = pzoo._ce_loss(pcfg, torch.from_numpy(logits),
                            torch.from_numpy(targets),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------- AdamW steps ----------------

def _run_steps(tiny, compute, n, k=1, ocfg=OCFG):
    """n steps of both packages from the same state and batches."""
    jcfg, jmodel, pmodel, np_params = tiny
    jdt, pdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jstep = jax.jit(jmake_step(jmodel, jopt.AdamWConfig(**ocfg),
                               compute_dtype=jdt, num_microbatches=k))
    pstep = make_train_step(pmodel, popt.AdamWConfig(**ocfg),
                            compute_dtype=pdt, num_microbatches=k)
    js, ps = jstate_of(np_params), pstate_of(np_params)
    src = SyntheticLM(jcfg.vocab_size, S, B, seed=3)
    metrics = []
    for i in range(n):
        b = src.batch(i)
        js, jm = jstep(js, jbatch(b))
        ps, pm = pstep(ps, b)
        metrics.append((jm, pm))
    return js, ps, metrics


def test_three_fp32_steps_in_warmup_with_clipping_match_jax(tiny):
    js, ps, metrics = _run_steps(tiny, "f32", 3)
    sum_lr = 0.0
    for jm, pm in metrics:
        assert float(pm["grad_norm"]) > OCFG["clip_norm"]   # clipping on
        assert float(pm["lr"]) == float(jm["lr"]) < OCFG["lr"]   # warmup
        assert pm["lr"].dtype == torch.float32
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        sum_lr += float(pm["lr"])
    assert ps.step.dtype == torch.int32 and ps.step.dim() == 0
    assert int(ps.step) == int(js.step) == 3
    assert_leaves_scaled(ps.m, js.m, MV_TOL, "m")
    assert_leaves_scaled(ps.v, js.v, MV_TOL, "v")
    assert_masters(ps.master, js.master, MASTER_LR_TOL * sum_lr, "master")


def test_bf16_steps_match_jax_loosely(tiny):
    js, ps, metrics = _run_steps(tiny, "bf16", 3)
    for jm, pm in metrics:
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
    sum_lr = sum(float(pm["lr"]) for _, pm in metrics)
    assert_masters(ps.master, js.master, 2 * sum_lr, "bf16 master")


def test_schedule_matches_jax_past_warmup():
    for cfg in (jopt.AdamWConfig(), jopt.AdamWConfig(warmup=0,
                                                     total_steps=7)):
        pcfg = popt.AdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 50, 100, 101, 5000, 10000, 20000):
            want = float(jopt.schedule(cfg, jnp.int32(step)))
            got = popt.schedule(pcfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------- microbatching ----------------

def test_microbatches_four_against_one_and_against_jax(tiny):
    """The reference's own microbatch test on the port (bf16 compute, its
    tolerances), then 4 microbatches at float32 against JAX's 4."""
    jcfg, jmodel, pmodel, np_params = tiny
    ocfg = popt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10, clip_norm=1e9)
    batch = SyntheticLM(jcfg.vocab_size, S, B, seed=4).batch(0)
    s1, m1 = make_train_step(pmodel, ocfg, num_microbatches=1)(
        pstate_of(np_params), batch)
    s4, m4 = make_train_step(pmodel, ocfg, num_microbatches=4)(
        pstate_of(np_params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-2)
    for a, b in zip(leaves_np(s1.master), leaves_np(s4.master)):
        np.testing.assert_allclose(a, b, rtol=1e-1, atol=2e-3)

    js, ps, metrics = _run_steps(tiny, "f32", 1, k=4)
    (jm, pm), = metrics
    for k in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert_leaves_scaled(ps.m, js.m, MV_TOL, "m, 4 microbatches")
    assert_masters(ps.master, js.master, MASTER_LR_TOL * float(pm["lr"]),
                   "master, 4 microbatches")


# ---------------- gradient compression ----------------

def test_quantize_int8_exact_and_compressors_match_jax(tiny):
    rng = np.random.RandomState(5)
    arrays = [rng.standard_normal((33, 7)).astype(np.float32) * 1e-3,
              rng.standard_normal(5).astype(np.float32) * 50,
              np.zeros((4, 4), np.float32),
              np.array([0.5, -0.5, 1.5, 127.0], np.float32)]
    jquant = jax.jit(jgc.quantize_int8)
    for x in arrays:
        jq, js = jquant(jnp.asarray(x))
        pq, ps = pgc.quantize_int8(torch.from_numpy(x))
        assert pq.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        assert float(ps) == float(js)
        np.testing.assert_array_equal(pgc.dequantize(pq, ps).numpy(),
                                      np.asarray(jgc.dequantize(jq, js)))

    jcfg, jmodel, pmodel, np_params = tiny
    b = SyntheticLM(jcfg.vocab_size, S, B, seed=5).batch(0)
    params = pdefs.tree_map(lambda t: t.requires_grad_(),
                            lm_params_from_numpy(np_params, "cpu"))
    g = pdefs.tree_unflatten(params, torch.autograd.grad(
        pmodel.loss_fn(params, b)[0], pdefs.tree_leaves(params)))
    jg = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), g)
    for (name, w), got in zip(jleaves(jax.jit(jgc.simple_compressor)(jg)),
                              leaves_np(pgc.simple_compressor(g))):
        np.testing.assert_array_equal(got, w, err_msg=name)

    compress, init_ef = pgc.make_ef_compressor()
    ef = init_ef(g)
    total_true = pdefs.tree_map(torch.zeros_like, g)
    total_sent = pdefs.tree_map(torch.zeros_like, g)
    for _ in range(8):  # error feedback: accumulated update stays unbiased
        sent, ef = compress(g, ef)
        total_true = pdefs.tree_map(lambda t, x: t + x, total_true, g)
        total_sent = pdefs.tree_map(lambda t, x: t + x, total_sent, sent)
    for t, s, e in zip(leaves_np(total_true), leaves_np(total_sent),
                       leaves_np(ef)):
        np.testing.assert_allclose(t, s + e, rtol=1e-4, atol=1e-5)


def test_int8_wire_step_matches_jax(tiny):
    """One float32 step with ``grad_compressor="int8_wire"``: the
    quantized gradients make the same update as JAX's."""
    jcfg, jmodel, pmodel, np_params = tiny
    b = SyntheticLM(jcfg.vocab_size, S, B, seed=6).batch(0)
    js, jm = jax.jit(jmake_step(jmodel, jopt.AdamWConfig(**OCFG),
                                compute_dtype=jnp.float32,
                                grad_compressor="int8_wire"))(
        jstate_of(np_params), jbatch(b))
    ps, pm = make_train_step(pmodel, popt.AdamWConfig(**OCFG),
                             compute_dtype=torch.float32,
                             grad_compressor="int8_wire")(
        pstate_of(np_params), b)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=LOSS_RTOL)
    assert_masters(ps.master, js.master, MASTER_LR_TOL * float(pm["lr"]),
                   "master, int8_wire")


# ---------------- checkpoints ----------------

def test_checkpoint_leaf_names_match_jax(tiny):
    jcfg, jmodel, pmodel, np_params = tiny
    jnames = list(jckpt._flatten(jstate_of(np_params))[0])
    pnames = list(pckpt._flatten(pstate_of(np_params)))
    assert pnames == jnames and len(pnames) == 46
    assert pnames[:2] == [".step", ".master__blocks__p0__ln1"]


def test_jax_checkpoint_resumes_in_the_port_and_back(tiny, tmp_path):
    """JAX runs 3 steps and saves; the port restores, runs 3 more and
    ends where JAX's 6 straight steps end. The port's checkpoint of
    that state restores into JAX's template unchanged."""
    jcfg, jmodel, pmodel, np_params = tiny
    ocfg = dict(OCFG, warmup=2)
    src = JSynthetic(jcfg.vocab_size, S, B, seed=2)
    psrc = SyntheticLM(jcfg.vocab_size, S, B, seed=2)

    jstep = jax.jit(jmake_step(jmodel, jopt.AdamWConfig(**ocfg),
                               compute_dtype=jnp.float32),
                    donate_argnums=(0,))

    def jtrainer(d):
        tr = JTrainer(jmodel, jopt.AdamWConfig(**ocfg), ckpt_dir=d,
                      ckpt_every=1000)
        tr._step_fn = jstep
        return tr

    s_ref, _ = jtrainer(None).run(jstate_of(np_params), iter(JLoader(src)),
                                  steps=6, log_every=0)
    d = str(tmp_path / "jax")
    tr = jtrainer(d)
    s3, _ = tr.run(jstate_of(np_params), iter(JLoader(src)), steps=3,
                   log_every=0)
    jckpt.save(d, s3, int(s3.step))

    ptr = Trainer(pmodel, popt.AdamWConfig(**ocfg), ckpt_dir=d,
                  ckpt_every=1000, device="cpu")
    ptr._step_fn = make_train_step(pmodel, ptr.opt_cfg,
                                   compute_dtype=torch.float32)
    state, restored = ptr.restore_or_init()
    assert restored and int(state.step) == 3 and state.step.dtype == torch.int32
    state, _ = ptr.run(state, iter(ShardedLoader(psrc, start_step=3)),
                       steps=3, log_every=0)
    assert int(state.step) == 6
    sum_lr = sum(float(jopt.schedule(jopt.AdamWConfig(**ocfg), jnp.int32(t)))
                 for t in range(1, 7))
    assert_masters(state.master, s_ref.master, MASTER_LR_TOL * sum_lr,
                   "resumed master")
    assert_leaves_scaled(state.m, s_ref.m, MV_TOL, "resumed m")

    d2 = str(tmp_path / "port")
    pckpt.save(d2, state, 6)
    leaves = jckpt.restore_latest(d2)
    assert leaves.pop("__step__") == 6
    back = jckpt.load_into(leaves, jstate_of(np_params))
    assert int(back.step) == 6 and back.step.dtype == jnp.int32
    for (name, w), g in zip(jleaves(back), [int(state.step)] + leaves_np(
            state.master) + leaves_np(state.m) + leaves_np(state.v)):
        np.testing.assert_array_equal(w, g, err_msg=name)


def test_port_checkpoint_resume_exact(tiny, tmp_path):
    """The reference's resume test on the port alone: 6 steps straight
    against 3, save, restore, 3 (rtol 1e-5, atol 1e-6)."""
    jcfg, jmodel, pmodel, np_params = tiny
    src = SyntheticLM(jcfg.vocab_size, S, B, seed=2)
    ocfg = popt.AdamWConfig(lr=1e-3, warmup=2, total_steps=50)
    tr = Trainer(pmodel, ocfg, device="cpu")
    s_ref, _ = tr.run(tr.init_state(seed=3), iter(ShardedLoader(src)),
                      steps=6, log_every=0)
    d = str(tmp_path / "ck")
    tr2 = Trainer(pmodel, ocfg, ckpt_dir=d, ckpt_every=3, device="cpu")
    s, _ = tr2.run(tr2.init_state(seed=3), iter(ShardedLoader(src)), steps=3,
                   log_every=0)
    assert pckpt.latest_step(d) == 3      # saved by ckpt_every
    del s
    restored = pckpt.restore_latest(d)
    step0 = restored.pop("__step__")
    s2 = pckpt.load_into(restored, tr2.init_state(seed=3))
    s2, _ = tr2.run(s2, iter(ShardedLoader(src, start_step=step0)), steps=3,
                    log_every=0)
    for a, b in zip(leaves_np(s_ref.master), leaves_np(s2.master)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        bad = dict(restored)
        bad[".master__embed"] = bad[".master__embed"][:1]
        pckpt.load_into(bad, tr2.init_state(seed=3))


def test_checkpoint_crash_safety_keep_and_async_snapshot(tiny, tmp_path):
    """A half-written checkpoint is never restored; ``keep`` bounds the
    directories; an async save holds the state of its step while the
    steps after it update the same tensors in place."""
    jcfg, jmodel, pmodel, np_params = tiny
    d = str(tmp_path)
    state = pstate_of(np_params)
    pckpt.save(d, state, 5)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # simulated crash
    assert pckpt.latest_step(d) == 5
    for step in (6, 7, 8):
        pckpt.save(d, state, step, keep=2)
    assert sorted(x for x in os.listdir(d) if not x.endswith(".tmp")) == [
        "step_00000007", "step_00000008"]

    step_fn = make_train_step(pmodel, popt.AdamWConfig(**OCFG))
    src = SyntheticLM(jcfg.vocab_size, S, B, seed=8)
    for i in range(3):
        state, _ = step_fn(state, src.batch(i))
    snap = [a.copy() for a in leaves_np(state.master)]
    d2 = str(tmp_path / "async")
    th = pckpt.save(d2, state, int(state.step), async_=True)
    master_ids = [t.data_ptr() for t in pdefs.tree_leaves(state.master)]
    for i in range(3, 5):
        state, _ = step_fn(state, src.batch(i))
    assert [t.data_ptr() for t in pdefs.tree_leaves(state.master)] \
        == master_ids                       # updated in place
    th.join(timeout=30)
    assert not th.is_alive()
    restored = pckpt.restore_latest(d2)
    assert restored.pop("__step__") == 3
    back = pckpt.load_into(restored, pstate_of(np_params))
    assert int(back.step) == 3
    for a, b in zip(leaves_np(back.master), snap):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(leaves_np(state.master)[0], snap[0])


# ---------------- the loop and the launcher ----------------

def test_loss_decreases(tiny):
    jcfg, jmodel, pmodel, np_params = tiny
    src = SyntheticLM(jcfg.vocab_size, 16, 8, seed=1)
    tr = Trainer(pmodel, popt.AdamWConfig(lr=1e-2, warmup=5, total_steps=200),
                 device="cpu")
    state, hist = tr.run(tr.init_state(), iter(ShardedLoader(src)), steps=60,
                         log_every=0)
    assert hist[-1] < hist[0] * 0.85, (hist[0], hist[-1])
    assert int(state.step) == 60


def test_straggler_hook_fires(tiny):
    jcfg, jmodel, pmodel, np_params = tiny
    events = []
    src = SyntheticLM(jcfg.vocab_size, 16, 8, seed=6)

    class SlowLoader:
        def __init__(self):
            self.it, self.n = iter(ShardedLoader(src)), 0

        def __iter__(self):
            return self

        def __next__(self):
            self.n += 1
            if self.n == 9:
                time.sleep(1.0)  # injected straggler
            return next(self.it)

    tr = Trainer(pmodel, popt.AdamWConfig(), straggler_factor=3.0,
                 hooks={"on_straggler": lambda s, dt, med: events.append(s)},
                 device="cpu")
    tr.run(tr.init_state(), iter(SlowLoader()), steps=10, log_every=0)
    assert tr.straggler_events >= 1 and 9 in events


def test_launch_train_on_cpu_resumes(tmp_path, capsys):
    d = str(tmp_path / "run")
    small = ["--seq", "32", "--batch", "4"]
    hist = plaunch.main(["--arch", "qwen2_1_5b", "--preset", "tiny",
                         "--steps", "30", "--ckpt", d, "--device", "cpu"]
                        + small)
    out = capsys.readouterr().out
    assert len(hist) == 30 and hist[-1] < hist[0]
    assert "device=cpu" in out and pckpt.latest_step(d) == 25
    hist2 = plaunch.main(["--arch", "qwen2_1_5b", "--preset", "tiny",
                          "--steps", "40", "--ckpt", d, "--device", "cpu",
                          "--microbatches", "2", "--grad-compress"] + small)
    assert "resumed from step 25" in capsys.readouterr().out
    assert len(hist2) == 15 and all(np.isfinite(hist2))
    with pytest.raises(NotImplementedError, match="A 13"):
        plaunch.main(["--arch", "qwen2_1_5b", "--model-parallel", "2",
                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="A 13"):
        Trainer(None, popt.AdamWConfig(), rules=object(), device="cpu")


# ---------------- the flash guard ----------------

def test_flash_raises_under_grad_and_loss_fn_takes_plain_attention():
    """The flash wrappers raise when autograd would record them (the
    kernel has no backward), not under ``no_grad``; a model built with
    ``use_flash=True`` trains through the plain attention at S = 128 (a
    length its prefill sends to flash), with ``use_flash=False``'s
    gradients, and launches nothing."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(1, 128, 2, 16).astype(np.float32))
    kv = torch.from_numpy(rng.randn(1, 128, 1, 16).astype(np.float32))
    with pytest.raises(NotImplementedError, match="backward"):
        pops.flash_attention(q.clone().requires_grad_(), kv, kv)
    with pytest.raises(NotImplementedError, match="backward"):
        pops.flash_attention_bhsd(q[0].transpose(0, 1), kv[0].transpose(0, 1),
                                  kv[0].transpose(0, 1).requires_grad_())
    with torch.no_grad():
        pops.flash_attention(q.clone().requires_grad_(), kv, kv)
    pops.flash_attention(q, kv, kv)          # nothing requires grad

    jcfg, pcfg = _cfgs()
    np_params = seeded_params(jzoo.build(jcfg, s_max=128))
    toks = rng.randint(0, jcfg.vocab_size, (2, 129)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    grads = []
    pops.reset_launches()
    for use_flash in (True, False):
        params = pdefs.tree_map(lambda t: t.requires_grad_(),
                                lm_params_from_numpy(np_params, "cpu"))
        loss, _ = pzoo.build(pcfg, s_max=128, use_flash=use_flash).loss_fn(
            params, b)
        grads.append(torch.autograd.grad(loss, pdefs.tree_leaves(params)))
    assert pops.launches() == {n: 0 for n in pops.KERNELS}
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_remat_off_gives_the_same_gradients():
    """``build(remat=False)``: the same loss and gradients as with the
    per-group checkpoints (recomputation repeats the same operations)."""
    jcfg, pcfg = _cfgs()
    np_params = seeded_params(jzoo.build(jcfg, s_max=S))
    b = SyntheticLM(jcfg.vocab_size, S, B, seed=9).batch(0)
    out = []
    for remat in (True, False):
        params = pdefs.tree_map(lambda t: t.requires_grad_(),
                                lm_params_from_numpy(np_params, "cpu"))
        loss, _ = pzoo.build(pcfg, s_max=S, remat=remat).loss_fn(params, b)
        out.append((loss.detach(), torch.autograd.grad(
            loss, pdefs.tree_leaves(params))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-7)


def test_adamw_state_from_numpy_carries_jax_state(tiny):
    jcfg, jmodel, pmodel, np_params = tiny
    js = jax.tree_util.tree_map(np.asarray, jstate_of(np_params))
    ps = adamw_state_from_numpy(js, "cpu")
    assert isinstance(ps, popt.AdamWState) and ps.step.dtype == torch.int32
    for (name, w), g in zip(jleaves(js), [ps.step.numpy()] + leaves_np(
            ps.master) + leaves_np(ps.m) + leaves_np(ps.v)):
        np.testing.assert_array_equal(g, w, err_msg=name)
