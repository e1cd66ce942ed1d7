"""The port's MoE family on the CPU, held against the JAX package on the
same seeded inputs and weights: ``moe_apply`` (routing, capacity,
dispatch / combine, aux and z losses), serving (prefill, decode, greedy
generation, the fork) and training (``loss_fn`` and its gradients, a
JAX checkpoint resumed in the port) for granite-moe-1b-a400m and
qwen3-moe-30b-a3b at tiny widths (``tests/test_models_smoke.py``'s MoE
configs: 4 experts top-2 and 8 experts top-2, expert d_ff 64), and the
launchers on an MoE arch.

Tolerances, and why:

* ``moe_apply`` at float32 on seeded inputs: the reference sums each
  token's output over all E x C one-hot slots, the port over its k
  choices; both in float32, so ``rtol=1e-4, atol=1e-5`` as the LM's
  float32 results (``tests/test_torch_lm.py``). The aux and z losses
  ``rtol=1e-5``: a mean of float32 probabilities and of squared
  log-sum-exps.
* The exact case: integer inputs and router, so both packages compute
  the same float32 logits exactly and meet the same ties; the expert
  weights are multiples of 1/4. y agrees to ``1e-6``: only SiLU and the
  order of a 4-term sum differ, while a different kept set, slot or tie
  order moves y by O(1).
* Serving: ``tests/test_torch_lm.py``'s tolerances (float32 logits
  ``rtol=1e-4, atol=1e-5``; bf16 cache one bf16 ulp; decode logits
  ``1e-4`` of the largest; greedy tokens and forks exact).
* Training: ``tests/test_torch_train.py``'s float32 tolerances (loss
  ``rtol=1e-5``, each gradient leaf within ``1e-5`` of its largest,
  masters within ``1e-2 * sum(lr)``, m within ``1e-4`` of its largest),
  and its bf16 loss ``rtol=1e-3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import MoEConfig as JMoE
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import pad_cache_to as jpad
from repro.train import optimizer as jopt
from repro.train.trainer import make_train_step as jmake_step
from tests.conftest import tiny_cfg
from tests.test_torch_lm import (F32, assert_bf16_close, assert_logits_close,
                                 jnp32, np32, seeded_params)

from repro_torch import configs as pconfigs
from repro_torch.checkpoint import ckpt as pckpt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import ops as pops
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import model_zoo as pzoo
from repro_torch.models import moe as pmoe
from repro_torch.models import pdefs
from repro_torch.models import transformer as ptf
from repro_torch.serve.engine import ServeEngine as PEngine
from repro_torch.serve.engine import pad_cache_to as ppad
from repro_torch.train import optimizer as popt
from repro_torch.train.trainer import make_train_step

torch.set_num_threads(2)

MOE = {"granite_moe_1b_a400m": JMoE(n_experts=4, top_k=2, d_ff=64),
       "qwen3_moe_30b_a3b": JMoE(n_experts=8, top_k=2, d_ff=64)}
LOSS_RTOL, GRAD_TOL, MV_TOL, MASTER_LR_TOL = 1e-5, 1e-5, 1e-4, 1e-2


def port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["moe"] = pconfigs.MoEConfig(**d["moe"])
    return pconfigs.ArchConfig(**d)


def moe_cfg(arch, **over):
    return tiny_cfg(arch, moe=MOE[arch], **over)


def _tensors(tree):
    return lm_params_from_numpy(tree, "cpu")


# ---------------- the JAX side ----------------

S, B = 16, 8           # training batches
OCFG = dict(lr=1e-2, warmup=5, total_steps=50, clip_norm=0.05)
APPLY_S = (256, 1000, 7)
SERVE_S0, SERVE_STEPS = 128, 4
GEN_S0, GEN_NEW = 8, 6


def _apply_case(jcfg, seq):
    rng = np.random.RandomState(seq)
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(d.shape) * 0.2).astype(np.float32)
         for k, d in jmoe.moe_defs(jcfg).items()}
    return p, x


def _exact_case():
    """Small-integer x and router (exact float32 logits in both
    packages), expert weights in multiples of 1/4, groups of 8 tokens.
    In group 0 seven tokens prefer experts 0 and 1 (tied) and token 5
    experts 0 and 3, so expert 0 takes 8 choices and expert 1 seven, for
    a capacity of 5: token 5 keeps one choice, tokens 6 and 7 none. Group
    1 has a token of all-zero logits (a 4-way tie) and one with experts
    1 and 2 tied on top."""
    jcfg = tiny_cfg("granite_moe_1b_a400m", d_model=8, moe=JMoE(
        n_experts=4, top_k=2, d_ff=4, group_size=8))
    rng = np.random.RandomState(3)
    router = np.zeros((8, 4), np.float32)
    router[0] = [3, 3, -1, 0]
    router[1] = [0, 1, 1, -2]
    router[2] = [-1, 0, 2, 2]
    router[3] = [1, -1, 0, 1]
    x = np.zeros((2, 8, 8), np.float32)
    x[0, :, 0] = 1
    x[0, 5, 3] = 2
    x[1] = rng.randint(-2, 3, (8, 8))
    x[1, 2] = 0
    x[1, 5] = 0
    x[1, 5, 1] = 2
    p = {"router": router}
    for k in ("up", "gate", "down"):
        shape = jmoe.moe_defs(jcfg)[k].shape
        p[k] = (rng.randint(-4, 5, shape) / 4).astype(np.float32)
    return jcfg, p, x


def _serve_models(arch, s_max, use_flash=False):
    jcfg = moe_cfg(arch)
    jmodel = jzoo.build(jcfg, s_max=s_max, use_flash=use_flash)
    pmodel = pzoo.build(port_cfg(jcfg), s_max=s_max, use_flash=use_flash)
    np_params = seeded_params(jmodel)
    return jcfg, jmodel, pmodel, np_params


def _train_models(arch):
    jcfg = moe_cfg(arch, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                   vocab_size=128)
    jmodel = jzoo.build(jcfg, s_max=S)
    pmodel = pzoo.build(port_cfg(jcfg), s_max=S)
    return jcfg, jmodel, pmodel, seeded_params(jmodel)


def _batch(jcfg, seed=1):
    toks = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jb(b):
    return {k: jnp.asarray(np.asarray(v)) for k, v in b.items()}


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def _reference(arch):
    """One arch's JAX results for every test below."""
    out = {"apply": {}}
    jcfg = moe_cfg(arch)
    for seq in APPLY_S:
        p, x = _apply_case(jcfg, seq)
        out["apply"][seq] = jax.jit(
            lambda p, x: jmoe.moe_apply(p, jcfg, x))(p, x)

    S0, steps = SERVE_S0, SERVE_STEPS
    jcfg, jmodel, _, np_params = _serve_models(arch, S0 + steps, True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab_size,
                                              (2, S0 + steps))
    log, cache = jax.jit(jmodel.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens[:, :S0])})
    serve = {"tokens": tokens, "prefill": (log, cache), "steps": []}
    cache = jpad(cache, S0 + steps)
    jdec = jax.jit(jmodel.decode_fn)
    for t in range(steps):
        log, cache = jdec(jparams, cache,
                          jnp.asarray(tokens[:, S0 + t:S0 + t + 1]),
                          jnp.int32(S0 + t))
        serve["steps"].append(log)
    out["serve"] = serve

    jcfg, jmodel, _, np_params = _serve_models(arch, GEN_S0 + GEN_NEW)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    prompts = np.random.RandomState(9).randint(0, jcfg.vocab_size,
                                               (3, GEN_S0))
    prompts[2, :5] = 0
    eng = JEngine(jmodel, jparams, s_max=GEN_S0 + GEN_NEW)
    _, cache = eng._prefill(jparams, {"tokens": jnp.asarray(prompts[:1])})
    out["generate"] = {
        "prompts": prompts,
        "tokens": np.asarray(eng.generate_batch(prompts, GEN_NEW)),
        "cache": cache, "fork": eng.fork_cache(cache, 3, use_kernel=True)}

    jcfg, jmodel, _, np_params = _train_models(arch)
    b = _jb(_batch(jcfg))
    tp = jax.tree_util.tree_map(jnp.asarray, np_params)
    out["grad"] = jax.jit(jax.value_and_grad(jmodel.loss_fn,
                                             has_aux=True))(tp, b)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tp)
    out["loss_bf16"] = jax.jit(jmodel.loss_fn)(bf, b)[0]

    ocfg = jopt.AdamWConfig(**OCFG)
    jstep = jax.jit(jmake_step(jmodel, ocfg, compute_dtype=jnp.float32))
    src = SyntheticLM(jcfg.vocab_size, S, B, seed=4)
    st = jopt.init_state(tp)
    states = []
    for i in range(3):
        st, m = jstep(st, _jb(src.batch(i)))
        states.append((st, m))
    out["steps"] = states
    return out


@pytest.fixture(scope="module")
def ref():
    """The module's JAX compiles, made once: every JAX-side result for
    both archs."""
    return {arch: _reference(arch) for arch in sorted(MOE)}


# ---------------- the block ----------------

def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    for probs, k in (([0.1, .3, .3, .3, 0, .3], 3), ([0.25] * 40, 8),
                     ([0.0, 0.5, 0.5, 0.5, 0.5], 4)):
        p = np.asarray(probs, np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        pv, pi = pmoe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("S,M", [(256, 256), (1000, 250), (7, 7), (1, 1),
                                 (1152, 192)])
def test_group_len_is_the_references(S, M):
    assert pmoe.group_len(S, 256) == M
    assert pmoe.capacity(M, 32, 8, 1.25) == jmoe.capacity(M, 32, 8, 1.25)


@pytest.mark.parametrize("arch", sorted(MOE))
@pytest.mark.parametrize("seq", APPLY_S)
def test_moe_apply_matches_jax(ref, arch, seq):
    """y, moe_aux and moe_z at float32 on seeded inputs, groups of 256,
    250 and 7 tokens."""
    jcfg = moe_cfg(arch)
    p, x = _apply_case(jcfg, seq)
    jy, jaux = ref[arch]["apply"][seq]
    py, paux = pmoe.moe_apply(_tensors(p), port_cfg(jcfg),
                              torch.from_numpy(x))
    np.testing.assert_allclose(np32(py), jnp32(jy), **F32)
    for k in ("moe_aux", "moe_z"):
        assert paux[k].dtype == torch.float32 and paux[k].dim() == 0
        np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_moe_apply_exact_case_ties_and_drops():
    """y agrees to 1e-6 on ``_exact_case``: the kept set, the slots and
    the tie order are the reference's."""
    jcfg, p, x = _exact_case()
    C = pmoe.capacity(8, 4, 2, 1.25)
    assert C == 5
    jy, jaux = jmoe.moe_apply(p, jcfg, x)
    pcfg, tp = port_cfg(jcfg), _tensors(p)
    py, paux = pmoe.moe_apply(tp, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(np32(py), jnp32(jy), rtol=1e-6, atol=1e-6)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    r = pmoe.route(tp, pcfg, torch.from_numpy(x))
    assert r.expert_idx[0].tolist() == [[0, 1]] * 5 + [[0, 3]] + [[0, 1]] * 2
    assert r.keep[0, :, 0].tolist() == [True] * C + [False] * (8 - C)
    assert r.slot[0, :, 1].tolist() == [0, 1, 2, 3, 4, 0, 5, 6]
    assert r.keep[0, :, 1].tolist() == [True] * 6 + [False] * 2
    assert r.expert_idx[1, 2].tolist() == [0, 1]
    assert r.expert_idx[1, 5].tolist() == [1, 2]
    # tokens 6 and 7 of group 0 lost both choices and get nothing; token
    # 5 keeps its expert-3 choice at its routed gate, not renormalised
    assert not bool(py[0, 6:].any())
    assert float(r.gates[0, 5, 1]) < 0.5
    np.testing.assert_array_equal(r.gates[0, :5].numpy(), 0.5)


# ---------------- serving ----------------

@pytest.mark.parametrize("arch", sorted(MOE))
def test_prefill_and_decode_match_jax(ref, arch):
    """Prefill logits and bf16 cache on the flash route (S = 128, one
    group of 128 tokens a row), then 4 decode steps (groups of 1)."""
    S0, steps = SERVE_S0, SERVE_STEPS
    _, _, pmodel, np_params = _serve_models(arch, S0 + steps, True)
    pparams = _tensors(np_params)
    want = ref[arch]["serve"]
    tokens = want["tokens"]
    plog, pcache = pmodel.prefill_fn(pparams, {"tokens": tokens[:, :S0]})
    jlog, jcache = want["prefill"]
    np.testing.assert_allclose(np32(plog), jnp32(jlog), **F32)
    for name in ("k", "v"):
        assert_bf16_close(pcache["p0"][name], jcache["p0"][name],
                          f"prefill cache {name}")
    pcache = ppad(pcache, S0 + steps)
    for t in range(steps):
        plog, pcache = pmodel.decode_fn(
            pparams, pcache, tokens[:, S0 + t:S0 + t + 1], S0 + t)
        assert_logits_close(plog, want["steps"][t], f"decode step {t}")


@pytest.mark.parametrize("arch", sorted(MOE))
def test_generate_and_fork_match_jax(ref, arch):
    """Greedy tokens of ``generate_batch`` / ``generate`` (3 prompts of 8
    tokens, one of them mostly padding tokens 0, which take capacity as
    in the reference), then a 3-way fork of a prompt's cache bit for bit
    against the reference's fork through its Pallas kernel."""
    _, _, pmodel, np_params = _serve_models(arch, GEN_S0 + GEN_NEW)
    want = ref[arch]["generate"]
    prompts = want["prompts"]
    peng = PEngine(pmodel, _tensors(np_params), s_max=GEN_S0 + GEN_NEW)
    got = peng.generate_batch(prompts, GEN_NEW)
    np.testing.assert_array_equal(got, want["tokens"])
    assert peng.generate(prompts[1], GEN_NEW) == got[1].tolist()
    pcache = cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, want["cache"]), "cpu")
    pops.reset_launches()
    pfork = peng.fork_cache(pcache, 3)
    assert pops.launches()["rowclone_copy"] == 0
    for name in ("k", "v"):
        w = cache_from_numpy(np.asarray(want["fork"]["p0"][name]), "cpu")
        assert torch.equal(pfork["p0"][name].view(torch.int16),
                           w.view(torch.int16))


# ---------------- training ----------------

@pytest.mark.parametrize("arch", sorted(MOE))
def test_loss_fn_and_gradients_match_jax(ref, arch):
    """float32 loss, ce, moe_aux, moe_z and every gradient leaf (the
    router's through the gates, the load balance and the z-loss) against
    ``jax.value_and_grad``; the bf16 loss loosely."""
    jcfg, _, pmodel, np_params = _train_models(arch)
    b = _batch(jcfg)
    (jl, jm), jg = ref[arch]["grad"]
    params = pdefs.tree_map(lambda t: t.requires_grad_(), _tensors(np_params))
    pl, pm = pmodel.loss_fn(params, b)
    grads = torch.autograd.grad(pl, pdefs.tree_leaves(params))
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=LOSS_RTOL)
    for k in ("ce", "moe_aux", "moe_z"):
        assert float(jm[k]) > 0
        np.testing.assert_allclose(float(pm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    names = [n for n, _ in _jleaves(jg)]
    assert sum("router" in n for n in names) == 1
    for (name, w), g in zip(_jleaves(jg), grads):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)
    pl16, _ = pmodel.loss_fn(
        pdefs.tree_map(lambda t: t.detach().to(torch.bfloat16), params), b)
    np.testing.assert_allclose(float(pl16), float(ref[arch]["loss_bf16"]),
                               rtol=1e-3)


def test_forward_train_returns_the_aux_sums_and_remat_agrees():
    """``forward_train`` returns the aux losses summed over the layers,
    and the remat path gives the same loss and gradients as the plain
    one (the recompute routes as the first pass did)."""
    jcfg, _, pmodel, np_params = _train_models("granite_moe_1b_a400m")
    pcfg = pmodel.cfg
    b = _batch(jcfg, 2)
    params = _tensors(np_params)
    x = ptf.embed_tokens(params, pcfg, torch.as_tensor(b["tokens"]).long())
    _, aux = ptf.forward_train(params, pcfg, x, torch.arange(S), remat=False)
    by_layer = {"moe_aux": 0.0, "moe_z": 0.0}
    h = x
    for g in range(ptf.n_groups(pcfg)):
        h, _, a = ptf._block_seq(pcfg, ptf.layer_pattern(pcfg),
                                 ptf.group_params(params["blocks"], g), h,
                                 ptf._rope_sc(pcfg, torch.arange(S)), False,
                                 mode="train")
        by_layer = {k: by_layer[k] + float(a[k]) for k in by_layer}
    for k in by_layer:
        np.testing.assert_allclose(float(aux[k]), by_layer[k], rtol=1e-6)
    out = []
    for remat in (True, False):
        model = pzoo.build(pcfg, s_max=S, remat=remat)
        ps = pdefs.tree_map(lambda t: t.clone().requires_grad_(), params)
        loss, _ = model.loss_fn(ps, b)
        out.append((loss, torch.autograd.grad(loss, pdefs.tree_leaves(ps))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", sorted(MOE))
def test_jax_moe_checkpoint_resumes_in_the_port(ref, arch, tmp_path):
    """JAX's state after 2 float32 steps, saved by the JAX package: the
    port restores every leaf (the MoE ``router`` / ``up`` / ``gate`` /
    ``down`` of master, m and v under JAX's names) exactly, and its
    third step lands where JAX's does."""
    jcfg, _, pmodel, _ = _train_models(arch)
    (js, _), (js3, jm3) = ref[arch]["steps"][1:]
    jckpt.save(str(tmp_path), js, 2)
    leaves = pckpt.restore_latest(str(tmp_path))
    assert leaves.pop("__step__") == 2
    template = popt.init_state(pmodel.init(0, device="cpu"))
    names = list(pckpt._flatten(template))
    assert names == list(jckpt._flatten(js)[0])
    assert {".master__blocks__p0__mlp__" + k for k in
            ("router", "up", "gate", "down")} <= set(names)
    ps = pckpt.load_into(leaves, template)
    for (name, w), g in zip(_jleaves(js), [ps.step] + [
            t for n in ("master", "m", "v")
            for t in pdefs.tree_leaves(getattr(ps, n))]):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    pstep = make_train_step(pmodel, popt.AdamWConfig(**OCFG),
                            compute_dtype=torch.float32)
    ps, pm = pstep(ps, SyntheticLM(jcfg.vocab_size, S, B, seed=4).batch(2))
    np.testing.assert_allclose(float(pm["loss"]), float(jm3["loss"]),
                               rtol=LOSS_RTOL)
    ocfg = jopt.AdamWConfig(**OCFG)
    sum_lr = sum(float(jopt.schedule(ocfg, jnp.int32(t))) for t in (1, 2, 3))
    for (name, w), g in zip(_jleaves(js3.master),
                            pdefs.tree_leaves(ps.master)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=MASTER_LR_TOL * sum_lr, err_msg=name)
    for (name, w), g in zip(_jleaves(js3.m), pdefs.tree_leaves(ps.m)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=MV_TOL * np.abs(w).max(),
                                   err_msg=name)


# ---------------- structure and entry points ----------------

def test_launch_serve_and_train_on_an_moe_arch(tmp_path, capsys):
    """``launch.serve`` (a prompt of 128 takes the flash route's plain
    version) and ``launch.train`` at the tiny preset, which keeps the
    arch's experts (32, top 8)."""
    pserve.main(["--arch", "granite_moe_1b_a400m", "--preset", "tiny",
                 "--batch", "2", "--prompt-len", "128", "--new", "3",
                 "--device", "cpu"])
    assert "granite-moe-1b-a400m on cpu: 2x3 tokens" in capsys.readouterr().out
    hist = ptrain.main(["--arch", "granite_moe_1b_a400m", "--preset", "tiny",
                        "--steps", "4", "--seq", "32", "--batch", "4",
                        "--ckpt", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "granite-moe-1b-a400m [tiny]" in out and len(hist) == 4
    assert all(np.isfinite(hist))
