"""The port's dense LM serving path on the CPU, held against the JAX
package on the same seeded inputs and weights: layers, attention, the
flash and rowclone plain versions (against the Pallas kernels in
interpret mode), prefill / decode / greedy generation for four dense
architectures at tiny widths, and the KV-cache fork.

Tolerances, and why:

* float32 results (norms, RoPE, activations, attention, prefill logits):
  both sides run the same float32 operations, summed in another order by
  another BLAS, so they agree to a few float32 ulps of the operands'
  scale: ``rtol=1e-4, atol=1e-5`` (fp32 eps is 1.2e-7; the widths here
  are at most 256 terms per sum).
* the flash grid: the tolerances of ``tests/test_kernels.py`` (fp32 2e-5,
  bf16 2e-2).
* bf16 results (the KV cache, the probabilities in decode): a float32
  value within a few ulps of a bf16 rounding boundary may round to the
  neighbouring bf16 value on one side, so they agree to one bf16 ulp:
  ``rtol=2**-7``.
* decode logits read that bf16 cache and round their probabilities and
  attention output to bf16 on both sides. A one-ulp (2^-8) flip of one
  of the S cached values a probability weighs moves the attention output
  by ~2^-8 / S of its scale, so ``atol=1e-4`` of the largest logit
  (measured: below 4e-7 for all four configs).
* copies (rowclone, fork) are exact, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import model_zoo as jzoo
from repro.models import pdefs as jpdefs
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import pad_cache_to as jpad
from tests.conftest import tiny_cfg

from repro_torch import configs as pconfigs
from repro_torch.interop import (cache_from_numpy, lm_params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.kernels import ops as pops
from repro_torch.launch import serve as plaunch
from repro_torch.models import attention as pattn
from repro_torch.models import layers as pL
from repro_torch.models import model_zoo as pzoo
from repro_torch.models import pdefs as ppdefs
from repro_torch.models import transformer as ptf
from repro_torch.serve.engine import ServeEngine as PEngine
from repro_torch.serve.engine import pad_cache_to as ppad

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0 ** -7
DENSE = ("qwen3_8b", "qwen2_1_5b", "gemma_7b", "glm4_9b")
MOE = ("granite_moe_1b_a400m", "qwen3_moe_30b_a3b")


def port_cfg(jcfg):
    return pconfigs.ArchConfig(**dataclasses.asdict(jcfg))


def np32(t):
    return t.detach().float().cpu().numpy()


def jnp32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def seeded_params(jmodel, seed=0, std=0.05):
    """The reference's parameter tree with every leaf redrawn from a
    seeded numpy normal (norm weights and biases too, so ``1 + weight``
    and the qkv bias are exercised), as numpy float32."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32),
        shapes)


def assert_bf16_close(got, want, what):
    g, w = np32(got), jnp32(want)
    np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-6, err_msg=what)


def assert_logits_close(got, want, what):
    w = jnp32(want)
    np.testing.assert_allclose(np32(got), w, rtol=0,
                               atol=1e-4 * np.abs(w).max(), err_msg=what)


# ---------------- layers ----------------

def test_rms_norm_and_layer_norm_match_jax():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        np32(pL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)),
        jnp32(jL.rms_norm(x, w, 1e-6)), **F32)
    np.testing.assert_allclose(
        np32(pL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), 1e-5)),
        jnp32(jL.layer_norm(x, w, b, 1e-5)), **F32)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = pL.rms_norm(tensor_from_numpy(np.asarray(xb)), torch.from_numpy(w),
                      1e-6)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, jL.rms_norm(xb, w, 1e-6), "bf16 rms_norm")


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    """Positions up to 1040, the serving path's longest cache."""
    rng = np.random.RandomState(1)
    pos = np.array([0, 1, 7, 128, 1023, 1039], np.int32)
    js, jc = jL.rope_tables(jnp.asarray(pos), 16, theta)
    ps, pc = pL.rope_tables(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(np32(ps), jnp32(js), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np32(pc), jnp32(jc), rtol=0, atol=1e-6)
    x = rng.standard_normal((2, len(pos), 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np32(pL.apply_rope(torch.from_numpy(x), ps, pc)),
        jnp32(jL.apply_rope(x, js, jc)), rtol=0, atol=1e-5)
    # the [B, S, half] table form
    got = pL.apply_rope(torch.from_numpy(x), ps[None].expand(2, -1, -1),
                        pc[None].expand(2, -1, -1))
    want = jL.apply_rope(x, jnp.broadcast_to(js, (2,) + js.shape),
                         jnp.broadcast_to(jc, (2,) + jc.shape))
    np.testing.assert_allclose(np32(got), jnp32(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "gelu", "relu_sq"])
def test_activation_matches_jax(name):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3
    g = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3
    gate = g if name in ("swiglu", "geglu") else None
    got = pL.activation(name, torch.from_numpy(x),
                        None if gate is None else torch.from_numpy(gate))
    np.testing.assert_allclose(np32(got), jnp32(jL.activation(name, x, gate)),
                               **F32)


# ---------------- attention ----------------

def _qkv(rng, B, Sq, Sk, H, KV, hd):
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_sdpa_matches_jax(kv_dtype):
    """Causal GQA in float32, and a float32 q against a bf16 k / v (the
    decode cache): q.k promotes to float32, the probabilities round to
    bf16, the product with v stays bf16."""
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 2, 9, 9, 8, 2, 16)
    mask = np.tril(np.ones((9, 9), bool))[None, None, None]
    jk = jnp.asarray(k, kv_dtype)
    jv = jnp.asarray(v, kv_dtype)
    want = jattn._sdpa(q, jk, jv, mask, 0.25)
    got = pattn._sdpa(torch.from_numpy(q), tensor_from_numpy(np.asarray(jk)),
                      tensor_from_numpy(np.asarray(jv)),
                      torch.from_numpy(mask), 0.25)
    assert str(got.dtype).endswith(kv_dtype)
    if kv_dtype == "float32":
        np.testing.assert_allclose(np32(got), jnp32(want), **F32)
    else:
        assert_bf16_close(got, want, "bf16 sdpa")


@pytest.mark.parametrize("Sq,block", [(24, 8), (12, 8), (16, 512)])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_matches_jax(Sq, block, causal):
    """Including a length the block does not divide (12 over 8 -> 6)."""
    rng = np.random.RandomState(4)
    q, k, v = _qkv(rng, 1, Sq, Sq, 4, 2, 16)
    want = jattn._sdpa_chunked(q, k, v, causal, 0.25, block_q=block)
    got = pattn._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, 0.25,
                              block_q=block)
    np.testing.assert_allclose(np32(got), jnp32(want), **F32)


def _attn_params(cfg, rng):
    defs = jattn.attn_defs(cfg)
    return {n: (rng.standard_normal(d.shape) * 0.1).astype(np.float32)
            for n, d in defs.items()}


@pytest.mark.parametrize("arch", ["qwen3_8b", "qwen2_1_5b"])
def test_attn_apply_and_decode_match_jax(arch):
    """Prefill attention (both routes) and a decode step against a bf16
    cache; the port writes the cache in place, the reference returns an
    updated copy."""
    jcfg = tiny_cfg(arch)
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(5)
    p = _attn_params(jcfg, rng)
    pp = {n: torch.from_numpy(a) for n, a in p.items()}
    x = rng.standard_normal((2, 128, jcfg.d_model)).astype(np.float32)
    jsc = jL.rope_tables(jnp.arange(128), jcfg.resolved_head_dim,
                         jcfg.rope_theta)
    psc = pL.rope_tables(torch.arange(128), cfg.resolved_head_dim,
                         cfg.rope_theta)
    for flash in (False, True):
        jout, (jk, _) = jattn.attn_apply(p, jcfg, x, jsc, use_flash=flash)
        pout, (pk, _) = pattn.attn_apply(pp, cfg, torch.from_numpy(x), psc,
                                         use_flash=flash)
        np.testing.assert_allclose(np32(pout), jnp32(jout), **F32)
        np.testing.assert_allclose(np32(pk), jnp32(jk), **F32)

    S, pos = 12, 7
    ck = jnp.asarray(rng.standard_normal((2, S, jcfg.n_kv_heads, 16)),
                     jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal((2, S, jcfg.n_kv_heads, 16)),
                     jnp.bfloat16)
    xd = x[:, :1]
    jsc1 = jL.rope_tables(jnp.asarray([pos]), 16, jcfg.rope_theta)
    psc1 = pL.rope_tables(torch.tensor([pos]), 16, cfg.rope_theta)
    jout, (jck, jcv) = jattn.attn_decode(p, jcfg, xd, jsc1, ck, cv,
                                         jnp.int32(pos))
    pck = tensor_from_numpy(np.asarray(ck))
    pcv = tensor_from_numpy(np.asarray(cv))
    pout, (rk, rv) = pattn.attn_decode(pp, cfg, torch.from_numpy(xd), psc1,
                                       pck, pcv, pos)
    assert rk is pck and rv is pcv
    assert_bf16_close(pck, jck, "decode cache k")
    assert_bf16_close(pcv, jcv, "decode cache v")
    assert_logits_close(pout, jout, "decode attention output")
    with pytest.raises(IndexError):
        pattn.attn_decode(pp, cfg, torch.from_numpy(xd), psc1, pck, pcv, S)


# ---------------- the kernels' plain versions ----------------

@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),    # MHA
    (2, 256, 8, 2, 64),    # GQA 4:1
    (1, 256, 8, 8, 128),   # MHA hd=128
    (1, 128, 4, 1, 256),   # MQA hd=256 (gemma-style)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax_kernel(B, S, H, KV, hd, dtype,
                                                  causal):
    """The port's CPU route (the plain version) against the Pallas kernel
    in interpret mode, on the grid and tolerances of test_kernels.py."""
    rng = np.random.RandomState(B * S + H)
    q, k, v = (jnp.asarray(a, dtype) for a in _qkv(rng, B, S, S, H, KV, hd))
    want = jops.flash_attention(q, k, v, causal=causal)
    pops.reset_launches()
    got = pops.flash_attention(*(tensor_from_numpy(np.asarray(a))
                                 for a in (q, k, v)), causal=causal)
    assert pops.launches()["flash_attention"] == 0
    assert str(got.dtype).endswith(dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(np32(got), jnp32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [96, 160])
def test_flash_attention_routes_long_and_ragged_to_chunked(S, monkeypatch):
    """``attn_apply(use_flash=True)`` sends a sequence that is not a
    multiple of 128 to the chunked plain attention, as the reference's
    ``ops.flash_attention`` does, and never reaches the flash route."""
    jcfg = tiny_cfg("qwen3_8b")
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(6)
    p = _attn_params(jcfg, rng)
    x = rng.standard_normal((1, S, jcfg.d_model)).astype(np.float32)
    jsc = jL.rope_tables(jnp.arange(S), jcfg.resolved_head_dim,
                         jcfg.rope_theta)
    psc = pL.rope_tables(torch.arange(S), cfg.resolved_head_dim,
                         cfg.rope_theta)
    want, _ = jattn.attn_apply(p, jcfg, x, jsc, use_flash=True)

    def no_flash(*a, **kw):
        raise AssertionError("a ragged sequence reached the flash route")

    monkeypatch.setattr(pops, "flash_attention", no_flash)
    got, _ = pattn.attn_apply({n: torch.from_numpy(a) for n, a in p.items()},
                              cfg, torch.from_numpy(x), psc, use_flash=True)
    np.testing.assert_allclose(np32(got), jnp32(want), **F32)


@pytest.mark.parametrize("shape", [(8, 128), (64, 512), (33, 257), (1, 8192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rowclone_copy_plain_matches_jax_kernel(shape, dtype):
    x = jnp.arange(np.prod(shape)).reshape(shape).astype(dtype)
    want = np.asarray(jops.rowclone_copy(x))
    px = tensor_from_numpy(np.asarray(x))
    got = pops.rowclone_copy(px)
    assert got.data_ptr() != px.data_ptr()
    assert torch.equal(got, tensor_from_numpy(want))
    # into one slot of a wider tensor, as the fork writes its copies
    wide = torch.zeros((shape[0], 3, shape[1]), dtype=px.dtype)
    pops.rowclone_copy(px, out=wide[:, 1])
    assert torch.equal(wide[:, 1], px)
    assert not wide[:, 0].any() and not wide[:, 2].any()


# ---------------- the LM ----------------

def _models(arch, s_max, use_flash, seed=0):
    jcfg = tiny_cfg(arch)
    jmodel = jzoo.build(jcfg, s_max=s_max, use_flash=use_flash)
    pmodel = pzoo.build(port_cfg(jcfg), s_max=s_max, use_flash=use_flash)
    np_params = seeded_params(jmodel, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    pparams = lm_params_from_numpy(np_params, "cpu")
    return jcfg, jmodel, pmodel, jparams, pparams


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("use_flash", [True, False])
def test_prefill_and_decode_match_jax(arch, use_flash):
    """Prefill logits and bf16 cache (flash route at S = 128, the first
    length it takes), then 4 decode steps: logits and the cache."""
    S0, steps = 128, 4
    S = S0 + steps
    jcfg, jmodel, pmodel, jparams, pparams = _models(arch, S, use_flash)
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, S))
    jlog, jcache = jax.jit(jmodel.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens[:, :S0])})
    pops.reset_launches()
    plog, pcache = pmodel.prefill_fn(pparams, {"tokens": tokens[:, :S0]})
    assert pops.launches() == {n: 0 for n in pops.KERNELS}
    np.testing.assert_allclose(np32(plog), jnp32(jlog), **F32)
    for name in ("k", "v"):
        assert pcache["p0"][name].dtype == torch.bfloat16
        assert_bf16_close(pcache["p0"][name], jcache["p0"][name],
                          f"prefill cache {name}")
    jcache = jpad(jcache, S)
    pcache = ppad(pcache, S)
    jdec = jax.jit(jmodel.decode_fn)
    for t in range(steps):
        tok = tokens[:, S0 + t:S0 + t + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok),
                            jnp.int32(S0 + t))
        plog, pcache = pmodel.decode_fn(pparams, pcache, tok, S0 + t)
        assert_logits_close(plog, jlog, f"decode step {t}")
    for name in ("k", "v"):
        assert_bf16_close(pcache["p0"][name], jcache["p0"][name],
                          f"decoded cache {name}")


def test_prefill_decode_match_forward_train():
    """The port's own consistency (tests/test_serve_consistency.py):
    prefill + decode reproduce the full-sequence forward's logits, and
    that forward matches the reference's."""
    S0, steps = 16, 4
    S = S0 + steps
    jcfg, jmodel, pmodel, jparams, pparams = _models("qwen3_8b", S, False)
    cfg = pmodel.cfg
    tokens = np.random.RandomState(8).randint(0, jcfg.vocab_size, (1, S))
    tt = torch.from_numpy(tokens)
    h, aux = ptf.forward_train(pparams, cfg,
                               ptf.embed_tokens(pparams, cfg, tt),
                               torch.arange(S), use_flash=False)
    assert float(aux["moe_aux"]) == 0.0 and float(aux["moe_z"]) == 0.0
    full = ptf.logits_from_hidden(pparams, cfg, h)
    jh, _ = jtf.forward_train(jparams, jcfg,
                              jtf.embed_tokens(jparams, jcfg,
                                               jnp.asarray(tokens)),
                              jnp.arange(S), remat=False)
    np.testing.assert_allclose(
        np32(full), jnp32(jtf.logits_from_hidden(jparams, jcfg, jh)), **F32)
    logits, cache = pmodel.prefill_fn(pparams, {"tokens": tokens[:, :S0]})
    cache = ppad(cache, S)
    np.testing.assert_allclose(np32(logits[0, -1]), np32(full[0, S0 - 1]),
                               rtol=2e-2, atol=2e-2)
    for t in range(steps):
        logits, cache = pmodel.decode_fn(pparams, cache,
                                         tokens[:, S0 + t:S0 + t + 1], S0 + t)
        np.testing.assert_allclose(np32(logits[0, -1]), np32(full[0, S0 + t]),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma_7b"])
def test_generate_batch_and_generate_match_jax(arch):
    S0, new = 8, 6
    jcfg, jmodel, pmodel, jparams, pparams = _models(arch, S0 + new, False)
    prompts = np.random.RandomState(9).randint(0, jcfg.vocab_size, (3, S0))
    want = JEngine(jmodel, jparams, s_max=S0 + new).generate_batch(prompts,
                                                                   new)
    peng = PEngine(pmodel, pparams, s_max=S0 + new)
    got = peng.generate_batch(prompts, new)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert peng.generate(prompts[1], new) == got[1].tolist()


def test_fork_cache_matches_jax_kernel_fork():
    """The fork through the rowclone route (the plain version on the CPU)
    equals the reference's fork through its Pallas kernel, bit for bit,
    and the tiled route."""
    S = 16
    jcfg, jmodel, pmodel, jparams, pparams = _models("qwen3_8b", S, False)
    tokens = np.random.RandomState(10).randint(0, jcfg.vocab_size, (1, S))
    _, jcache = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(tokens)})
    jfork = JEngine(jmodel, jparams, s_max=S).fork_cache(jcache, 3,
                                                          use_kernel=True)
    pcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                              "cpu")
    peng = PEngine(pmodel, pparams, s_max=S)
    pops.reset_launches()
    pfork = peng.fork_cache(pcache, 3)
    assert pops.launches()["rowclone_copy"] == 0
    tiled = peng.fork_cache(pcache, 3, use_kernel=False)
    for name in ("k", "v"):
        want = cache_from_numpy(np.asarray(jfork["p0"][name]), "cpu")
        assert pfork["p0"][name].shape == (jcfg.n_layers, 3, S,
                                           jcfg.n_kv_heads, 16)
        assert torch.equal(pfork["p0"][name].view(torch.int16),
                           want.view(torch.int16))
        assert torch.equal(tiled["p0"][name].view(torch.int16),
                           want.view(torch.int16))


# ---------------- structure and entry points ----------------

@pytest.mark.parametrize("arch", DENSE + MOE)
def test_full_width_defs_match_jax(arch):
    """The full-size parameter trees agree leaf for leaf (shapes only;
    nothing is allocated)."""
    jdefs = jtf.lm_defs(get_config(arch))
    pdefs = ptf.lm_defs(pconfigs.get_config(arch))
    jl = jax.tree_util.tree_leaves_with_path(jdefs, is_leaf=jpdefs.is_def)
    pl = ppdefs.tree_leaves(pdefs)
    assert [d.shape for _, d in jl] == [d.shape for d in pl]
    assert jpdefs.count_params(jdefs) == ppdefs.count_params(pdefs)
    assert ptf.cache_specs(pconfigs.get_config(arch), 4, 1040)["p0"]["k"][0] \
        == jtf.cache_specs(get_config(arch), 4, 1040)["p0"]["k"].shape


@pytest.mark.parametrize("arch", ["rwkv6_3b", "whisper_base",
                                  "llava_next_34b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pzoo.build(pconfigs.get_config(arch), s_max=16)


@pytest.mark.parametrize("arch", MOE)
def test_moe_families_build(arch):
    """The MoE family builds at full size (definitions only: nothing is
    allocated), every layer an MoE MLP with the reference's leaves."""
    model = pzoo.build(pconfigs.get_config(arch), s_max=16)
    cfg = model.cfg
    assert ptf.layer_pattern(cfg) == (("attn", "moe"),)
    mlp = model.defs["blocks"]["p0"]["mlp"]
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    assert {k: v.shape for k, v in mlp.items()} == {
        "router": (cfg.n_layers, d, E), "up": (cfg.n_layers, E, d, f),
        "gate": (cfg.n_layers, E, d, f), "down": (cfg.n_layers, E, f, d)}
    assert model.n_params() == jzoo.build(get_config(arch),
                                          s_max=16).n_params()


@pytest.mark.parametrize("n_layers", [8, 32])
def test_hybrid_family_builds(n_layers):
    """jamba-v0.1 builds at full width (definitions only: nothing is
    allocated) with the reference's pattern, leaves, cache and parameter
    count: 13,295,235,072 at one 8-layer period, 51.57 B at full depth."""
    jcfg = get_config("jamba_v0_1_52b").scaled(n_layers=n_layers)
    model = pzoo.build(pconfigs.get_config("jamba_v0_1_52b").scaled(
        n_layers=n_layers), s_max=16)
    cfg = model.cfg
    pat = ptf.layer_pattern(cfg)
    assert pat == jtf.layer_pattern(jcfg)
    assert [mx for mx, _ in pat] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [ml for _, ml in pat] == ["dense", "moe"] * 4
    jdefs = jtf.lm_defs(jcfg)
    jl = jax.tree_util.tree_leaves_with_path(jdefs, is_leaf=jpdefs.is_def)
    pl = ppdefs.tree_leaves(model.defs)
    assert [d.shape for _, d in jl] == [d.shape for d in pl]
    assert [d.init for _, d in jl] == [d.init for d in pl]
    assert model.n_params() == jzoo.build(jcfg, s_max=16).n_params()
    if n_layers == 8:
        assert model.n_params() == 13_295_235_072
    jspecs = jtf.cache_specs(jcfg, 4, 1040)
    for pos, leaves in ptf.cache_specs(cfg, 4, 1040).items():
        assert sorted(leaves) == sorted(jspecs[pos])
        for name, (shape, dt) in leaves.items():
            assert shape == jspecs[pos][name].shape, (pos, name)
            assert str(dt)[6:] == str(jspecs[pos][name].dtype), (pos, name)


def test_loss_fn_raises_and_init_needs_a_device():
    """The flash route raises under autograd (the kernel has no backward),
    so ``loss_fn`` trains through the plain attention; ``init`` needs a
    device."""
    model = pzoo.build(port_cfg(tiny_cfg("qwen3_8b")), s_max=8)
    q = torch.zeros((1, 128, 2, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        pops.flash_attention(q, q[:, :, :1].detach(), q[:, :, :1].detach())
    toks = np.random.RandomState(0).randint(0, 512, (2, 9))
    loss, metrics = model.loss_fn(model.init(0, device="cpu"),
                                  {"tokens": toks[:, :-1],
                                   "targets": toks[:, 1:]})
    assert loss.shape == () and bool(torch.isfinite(loss))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init(0)
    params = model.init(0, device="cpu")
    cfg = model.cfg
    assert params["embed"].device.type == "cpu"
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    g1 = ptf.group_params(params["blocks"], 1)["p0"]
    assert g1["mlp"]["up"].shape == (cfg.d_model, cfg.d_ff)
    assert torch.equal(g1["ln1"], torch.zeros(cfg.d_model))


def test_launch_serve_on_cpu(capsys):
    plaunch.main(["--arch", "qwen3_8b", "--preset", "tiny", "--batch", "2",
                  "--prompt-len", "128", "--new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen3-8b on cpu: 2x3 tokens" in out
    with pytest.raises(SystemExit) as ei:   # the sweep service's parser
        plaunch.main(["sweep", "--help"])
    assert ei.value.code == 0
    assert "python -m repro_torch.service" in capsys.readouterr().out


def test_lm_params_from_numpy_defaults_to_cuda(monkeypatch):
    """``device=None`` means CUDA, as at the entry points: without a card
    it raises rather than leaving the tree on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"p0": {"k": np.zeros((1, 2), np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(tree, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_from_numpy(tree, "cuda")
    assert lm_params_from_numpy(tree, "cpu")["p0"]["k"].device.type == "cpu"
