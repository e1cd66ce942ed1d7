"""The port's mamba hybrid family on the CPU, held against the JAX package
on the same seeded inputs and weights: the mamba mixer piece by piece
(``_causal_conv``, ``_ssm_params``, ``_chunk_scan``, ``mamba_seq`` on
both scan routes, ``mamba_decode``), the selective scan's plain version,
and the tiny jamba of ``tests/test_serve_consistency.py::CASES`` (8
layers: 7 mamba and 1 attention, MoE on every second; d_state 8, chunk
8) through serving (prefill, decode, greedy generation, the fork) and
training (``loss_fn`` and its gradients, remat on and off).

Tolerances, and why:

* float32 results (the conv, dt / B / C, the scan's outputs, logits):
  ``tests/test_torch_moe.py``'s ``rtol=1e-4, atol=1e-5``. The scans run
  token by token (chunk by chunk on the plain route, over the whole
  sequence in the kernel's plain version), where the reference combines
  the same products in an ``associative_scan`` tree: a float32 result
  moves by a few ulps of its scale.
* the scan's state ``h`` is small here (|h| ~1e-3: dt ~ softplus(-4)),
  so it is held at ``rtol=1e-4`` with ``atol`` 1e-5 of its largest
  value rather than an absolute 1e-5 (measured: below 3e-7 of it). After
  decode steps it reads the bf16 conv state, where a value one bf16 ulp
  apart on the two sides (1 of 768 in a layer, a float32 conv output at
  a rounding boundary) moves that channel's next h by ~1e-4 of the
  largest (measured 9.8e-5): the decoded cache's h is held at 1e-3 of
  its largest.
* bf16 results (the k / v / conv cache): one bf16 ulp, as the LM tests.
* decode logits: ``tests/test_torch_lm.py``'s ``1e-4`` of the largest.
* training: ``tests/test_torch_moe.py``'s float32 loss ``rtol=1e-5`` and
  every gradient leaf within ``1e-5`` of its largest.
* greedy tokens and forks are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmb
from repro.models import model_zoo as jzoo
from repro.models import pdefs as jpdefs
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import pad_cache_to as jpad
from tests.conftest import tiny_cfg
from tests.test_serve_consistency import CASES
from tests.test_torch_lm import (F32, assert_bf16_close, assert_logits_close,
                                 jnp32, np32, seeded_params)

from repro_torch import configs as pconfigs
from repro_torch.interop import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.launch import train as ptrain
from repro_torch.models import mamba as pmb
from repro_torch.models import model_zoo as pzoo
from repro_torch.models import pdefs
from repro_torch.models import transformer as ptf
from repro_torch.serve.engine import ServeEngine as PEngine
from repro_torch.serve.engine import pad_cache_to as ppad

torch.set_num_threads(2)

ARCH = "jamba_v0_1_52b"
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
H_TOL = 1e-5          # the state h: atol in units of its largest value
H_DECODED_TOL = 1e-3  # h after decode steps on a bf16 conv state
SEQ, CHUNK = 20, 8    # mamba_seq: chunks of 5, the largest divisor <= 8
SERVE_S0, SERVE_STEPS = 128, 4
GEN_S0, GEN_NEW = 8, 6
S, B = 16, 4          # training batches: two chunks of 8 a layer


def jamba_cfg(**over):
    return tiny_cfg(ARCH, **{**CASES[ARCH], **over})


def port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["moe"] = pconfigs.MoEConfig(**d["moe"])
    d["ssm"] = pconfigs.SSMConfig(**d["ssm"])
    return pconfigs.ArchConfig(**d)


def _tensors(tree):
    return lm_params_from_numpy(tree, "cpu")


def assert_h_close(got, want, what, tol=H_TOL):
    w = jnp32(want)
    np.testing.assert_allclose(np32(got), w, rtol=1e-4,
                               atol=tol * np.abs(w).max(), err_msg=what)


# ---------------- inputs ----------------

def mixer_cfg(d_state):
    from repro.configs import SSMConfig
    return jamba_cfg(ssm=SSMConfig(d_state=d_state, d_conv=4, expand=2,
                                   chunk=CHUNK))


def mixer_params(jcfg, seed=0):
    """The mixer's leaves at scales that make the scan move: dt spread
    over ~0.02-3 (dt_b drawn around 4), A_log the hippo rows plus noise,
    D and the conv bias nonzero."""
    rng = np.random.RandomState(seed)
    defs = jmb.mamba_defs(jcfg)
    p = {k: (rng.standard_normal(d.shape) * 0.2).astype(np.float32)
         for k, d in defs.items()}
    p["dt_b"] = rng.uniform(2.0, 5.0, defs["dt_b"].shape).astype(np.float32)
    N = jcfg.ssm.d_state
    p["A_log"] = (np.log(np.arange(1, N + 1, dtype=np.float32))[None]
                  + 0.1 * rng.standard_normal(defs["A_log"].shape)
                  ).astype(np.float32)
    return p


def mixer_state(jcfg, batch, seed, conv_dtype=np.float32):
    rng = np.random.RandomState(seed)
    di = jcfg.ssm.expand * jcfg.d_model
    conv = rng.standard_normal((batch, jcfg.ssm.d_conv - 1, di))
    h = 0.3 * rng.standard_normal((batch, di, jcfg.ssm.d_state))
    return {"conv": np.asarray(jnp.asarray(conv, conv_dtype)),
            "h": h.astype(np.float32)}


def _x(jcfg, batch, seq, seed):
    return np.random.RandomState(seed).standard_normal(
        (batch, seq, jcfg.d_model)).astype(np.float32)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return {k: (_t(v) if isinstance(v, dict) else
                cache_from_numpy(np.asarray(v), "cpu"))
            for k, v in tree.items()}


def _serve_models(s_max, use_flash):
    jcfg = jamba_cfg()
    jmodel = jzoo.build(jcfg, s_max=s_max)
    pmodel = pzoo.build(port_cfg(jcfg), s_max=s_max, use_flash=use_flash)
    return jcfg, jmodel, pmodel, seeded_params(jmodel)


def _train_models():
    jcfg = jamba_cfg()
    jmodel = jzoo.build(jcfg, s_max=S)
    return jcfg, jmodel, seeded_params(jmodel)


def _batch(jcfg, seed=1):
    toks = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


# ---------------- the JAX side ----------------

@pytest.fixture(scope="module")
def ref():
    """Every JAX-side result of the module, computed once."""
    out = {}
    for N in (8, 16):
        jcfg = mixer_cfg(N)
        p = _j(mixer_params(jcfg))
        x = _x(jcfg, 2, SEQ, 3)
        st = mixer_state(jcfg, 2, 4)
        xd = _x(jcfg, 2, 1, 5)
        std = mixer_state(jcfg, 2, 6, conv_dtype=jnp.bfloat16)
        di = jcfg.ssm.expand * jcfg.d_model
        u = np.random.RandomState(7).standard_normal(
            (2, SEQ, di)).astype(np.float32)
        out[N] = {
            "seq": jmb.mamba_seq(p, jcfg, jnp.asarray(x)),
            "seq_state": jmb.mamba_seq(p, jcfg, jnp.asarray(x), _j(st)),
            "decode": jmb.mamba_decode(p, jcfg, jnp.asarray(xd), _j(std)),
            "params": jmb._ssm_params(p, jcfg, jnp.asarray(u)),
            "conv": jmb._causal_conv(jnp.asarray(u), p["conv_w"], p["conv_b"]),
            "conv_state": jmb._causal_conv(
                jnp.asarray(u[:, :3]), p["conv_w"], p["conv_b"],
                jnp.asarray(std["conv"])),
        }
        dA = np.exp(-np.random.RandomState(8).uniform(
            0, 3, (2, CHUNK, di, N))).astype(np.float32)
        dBu = np.random.RandomState(9).standard_normal(
            (2, CHUNK, di, N)).astype(np.float32)
        out[N]["chunk"] = jmb._chunk_scan(jnp.asarray(dA), jnp.asarray(dBu),
                                          jnp.asarray(st["h"]))

    jcfg, jmodel, _, np_params = _serve_models(SERVE_S0 + SERVE_STEPS, False)
    jparams = _j(np_params)
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab_size,
                                              (2, SERVE_S0 + SERVE_STEPS))
    log, cache = jax.jit(jmodel.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens[:, :SERVE_S0])})
    serve = {"tokens": tokens, "prefill": (log, cache), "steps": []}
    cache = jpad(cache, SERVE_S0 + SERVE_STEPS)
    jdec = jax.jit(jmodel.decode_fn)
    for t in range(SERVE_STEPS):
        log, cache = jdec(jparams, cache,
                          jnp.asarray(tokens[:, SERVE_S0 + t:][:, :1]),
                          jnp.int32(SERVE_S0 + t))
        serve["steps"].append(log)
    serve["cache"] = cache
    out["serve"] = serve

    jcfg, jmodel, _, np_params = _serve_models(GEN_S0 + GEN_NEW, False)
    jparams = _j(np_params)
    prompts = np.random.RandomState(9).randint(0, jcfg.vocab_size,
                                               (3, GEN_S0))
    eng = JEngine(jmodel, jparams, s_max=GEN_S0 + GEN_NEW)
    _, cache = eng._prefill(jparams, {"tokens": jnp.asarray(prompts[:1])})
    out["generate"] = {
        "prompts": prompts,
        "tokens": np.asarray(eng.generate_batch(prompts, GEN_NEW)),
        "cache": cache, "fork": eng.fork_cache(cache, 3, use_kernel=True)}

    jcfg, jmodel, np_params = _train_models()
    b = _j(_batch(jcfg))
    tp = _j(np_params)
    out["grad"] = jax.jit(jax.value_and_grad(jmodel.loss_fn,
                                             has_aux=True))(tp, b)
    return out


# ---------------- the mixer ----------------

def test_hippo_init_matches_jax():
    """``A_log[..., n] = log(n + 1)`` broadcast over the leading dims, as
    the reference's ``init_tree`` makes it (float32 and bf16), within
    one float32 ulp."""
    jcfg = jamba_cfg()
    defs = jmb.mamba_defs(jcfg)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = jpdefs.init_tree(jax.random.PRNGKey(0), defs, dt)
        got = pdefs.init_tree(torch.Generator().manual_seed(0),
                              pmb.mamba_defs(port_cfg(jcfg)), tdt)
        assert got["A_log"].dtype == tdt
        # float32 log(7) is one ulp apart between torch and XLA
        np.testing.assert_allclose(np32(got["A_log"]), jnp32(want["A_log"]),
                                   rtol=2.0 ** -23, atol=0)
        for k in ("D", "conv_b", "dt_b"):
            np.testing.assert_array_equal(np32(got[k]), jnp32(want[k]))


@pytest.mark.parametrize("N", [8, 16])
def test_causal_conv_matches_jax(ref, N):
    """Without a state (zeros of u's dtype) and from a bf16 state against
    float32 inputs, which both packages promote to float32."""
    jcfg = mixer_cfg(N)
    p = _tensors(mixer_params(jcfg))
    di = jcfg.ssm.expand * jcfg.d_model
    u = torch.from_numpy(np.random.RandomState(7).standard_normal(
        (2, SEQ, di)).astype(np.float32))
    y, st = pmb._causal_conv(u, p["conv_w"], p["conv_b"])
    jy, jst = ref[N]["conv"]
    np.testing.assert_allclose(np32(y), jnp32(jy), **F32)
    np.testing.assert_array_equal(np32(st), jnp32(jst))
    conv = cache_from_numpy(mixer_state(jcfg, 2, 6, jnp.bfloat16)["conv"],
                            "cpu")
    assert conv.dtype == torch.bfloat16
    y, st = pmb._causal_conv(u[:, :3], p["conv_w"], p["conv_b"], conv)
    jy, jst = ref[N]["conv_state"]
    assert st.dtype == torch.float32 and jst.dtype == jnp.float32
    np.testing.assert_allclose(np32(y), jnp32(jy), **F32)
    np.testing.assert_array_equal(np32(st), jnp32(jst))


@pytest.mark.parametrize("N", [8, 16])
def test_ssm_params_match_jax(ref, N):
    """dt (softplus as ``logaddexp(x, 0)``, here over -2..3 before the
    softplus), B and C in float32."""
    jcfg = mixer_cfg(N)
    p = _tensors(mixer_params(jcfg))
    di = jcfg.ssm.expand * jcfg.d_model
    u = torch.from_numpy(np.random.RandomState(7).standard_normal(
        (2, SEQ, di)).astype(np.float32))
    for got, want in zip(pmb._ssm_params(p, port_cfg(jcfg), u),
                         ref[N]["params"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(np32(got), jnp32(want), **F32)


def test_softplus_is_jax_softplus_past_torch_threshold():
    x = np.array([-100, -20, -1, 0, 1, 19.5, 20.5, 30, 90], np.float32)
    # XLA on the CPU flushes subnormal results (softplus(-100)) to zero
    np.testing.assert_allclose(pmb.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("N", [8, 16])
def test_chunk_scan_matches_jax(ref, N):
    """The token-by-token scan against ``associative_scan`` on one chunk
    of 8 with decays in (e^-3, 1) and a nonzero h0."""
    jcfg = mixer_cfg(N)
    di = jcfg.ssm.expand * jcfg.d_model
    dA = np.exp(-np.random.RandomState(8).uniform(
        0, 3, (2, CHUNK, di, N))).astype(np.float32)
    dBu = np.random.RandomState(9).standard_normal(
        (2, CHUNK, di, N)).astype(np.float32)
    h0 = mixer_state(jcfg, 2, 4)["h"]
    hs, hT = pmb._chunk_scan(torch.from_numpy(dA), torch.from_numpy(dBu),
                             torch.from_numpy(h0))
    jhs, jhT = ref[N]["chunk"]
    np.testing.assert_allclose(np32(hs), jnp32(jhs), **F32)
    np.testing.assert_array_equal(np32(hT), np32(hs[:, -1]))
    np.testing.assert_allclose(np32(hT), jnp32(jhT), **F32)


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_seq_matches_jax(ref, N, use_kernel, with_state):
    """S = 20 with a chunk of 8: the reference's chunk is 5 (the largest
    divisor <= 8). The plain route scans 4 chunks; the kernel route
    (its plain version here) the whole sequence. y and both states."""
    assert pmb.chunk_len(SEQ, CHUNK) == 5
    jcfg = mixer_cfg(N)
    p = _tensors(mixer_params(jcfg))
    x = torch.from_numpy(_x(jcfg, 2, SEQ, 3))
    st = _t(mixer_state(jcfg, 2, 4)) if with_state else None
    with torch.no_grad():
        y, new = pmb.mamba_seq(p, port_cfg(jcfg), x, st,
                               use_kernel=use_kernel)
    jy, jnew = ref[N]["seq_state" if with_state else "seq"]
    np.testing.assert_allclose(np32(y), jnp32(jy), **F32)
    np.testing.assert_allclose(np32(new["conv"]), jnp32(jnew["conv"]), **F32)
    assert new["h"].dtype == torch.float32
    assert float(new["h"].abs().max()) > 1e-2
    assert_h_close(new["h"], jnew["h"], "h")


@pytest.mark.parametrize("N", [8, 16])
def test_mamba_decode_matches_jax(ref, N):
    """One token from a bf16 conv state (promoted to float32 in the conv,
    as ``jnp.concatenate`` does) and a float32 h."""
    jcfg = mixer_cfg(N)
    p = _tensors(mixer_params(jcfg))
    x = torch.from_numpy(_x(jcfg, 2, 1, 5))
    st = _t(mixer_state(jcfg, 2, 6, jnp.bfloat16))
    y, new = pmb.mamba_decode(p, port_cfg(jcfg), x, st)
    jy, jnew = ref[N]["decode"]
    np.testing.assert_allclose(np32(y), jnp32(jy), **F32)
    assert new["conv"].dtype == torch.float32
    np.testing.assert_array_equal(np32(new["conv"]), jnp32(jnew["conv"]))
    assert_h_close(new["h"], jnew["h"], "h")


def test_selective_scan_plain_version_and_its_guards():
    """The plain version equals the chunked plain route's scan; the op
    raises under autograd (no backward) and the CUDA wrapper refuses a
    d_state outside {8, 16} and a CPU tensor before any launch."""
    rng = np.random.RandomState(0)
    Bt, St, di, N = 2, 13, 24, 8
    u, dt = (torch.from_numpy(rng.standard_normal((Bt, St, di)).astype(
        np.float32)) for _ in range(2))
    dt = torch.nn.functional.softplus(dt)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((Bt, St, N)).astype(
        np.float32)) for _ in range(2))
    A = -torch.exp(torch.from_numpy(rng.uniform(0, 2, (di, N)).astype(
        np.float32)))
    D = torch.from_numpy(rng.standard_normal(di).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((Bt, di, N)).astype(np.float32))
    y, hT = pops.selective_scan(u, dt, Bm, Cm, A, D, h0)
    hs, want_hT = pmb._chunk_scan(torch.exp(dt[..., None] * A),
                                  (dt * u)[..., None] * Bm[:, :, None, :], h0)
    want = torch.einsum("btdn,btn->btd", hs, Cm) + u * D
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hT, want_hT, rtol=1e-5, atol=1e-5)
    y0, h00 = pref.selective_scan_ref(u[:, :0], dt[:, :0], Bm[:, :0],
                                      Cm[:, :0], A, D, h0)
    assert y0.shape == (Bt, 0, di) and torch.equal(h00, h0)
    with pytest.raises(NotImplementedError, match="backward"):
        pops.selective_scan(u.requires_grad_(), dt, Bm, Cm, A, D, h0)
    u = u.detach()
    with pytest.raises(ValueError, match="d_state"):
        selective_scan_cuda(u, dt, Bm[..., :4].contiguous(),
                            Cm[..., :4].contiguous(),
                            A[:, :4].contiguous(), D, h0[..., :4].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(u, dt, Bm, Cm, A, D, h0)


# ---------------- serving ----------------

@pytest.mark.parametrize("use_flash", [True, False])
def test_prefill_and_decode_match_jax(ref, use_flash):
    """The tiny jamba's prefill of 128 tokens (the kernel route's plain
    versions: flash and the selective scan over the whole sequence; or
    the plain route: chunked attention and the scan in 16 chunks) against
    the reference: logits, the bf16 k / v / conv cache and the float32 h;
    then 4 decode steps and the cache they leave."""
    S0, steps = SERVE_S0, SERVE_STEPS
    _, _, pmodel, np_params = _serve_models(S0 + steps, use_flash)
    pparams = _tensors(np_params)
    want = ref["serve"]
    tokens = want["tokens"]
    plog, pcache = pmodel.prefill_fn(pparams, {"tokens": tokens[:, :S0]})
    jlog, jcache = want["prefill"]
    np.testing.assert_allclose(np32(plog), jnp32(jlog), **F32)

    def same_cache(pc, jc, what, h_tol=H_TOL):
        assert sorted(pc) == sorted(jc)
        for pos in pc:
            assert sorted(pc[pos]) == sorted(jc[pos]), pos
            for name, t in pc[pos].items():
                assert t.shape == jc[pos][name].shape, (pos, name)
                assert str(t.dtype)[6:] == str(jc[pos][name].dtype)
                if name == "h":
                    assert_h_close(t, jc[pos][name], f"{what} {pos}.h",
                                   h_tol)
                else:
                    assert_bf16_close(t, jc[pos][name], f"{what} {pos}.{name}")

    same_cache(pcache, jcache, "prefill cache")
    assert ptf.layer_pattern(pmodel.cfg)[4] == ("attn", "dense")
    assert set(pcache["p4"]) == {"k", "v"} and set(pcache["p0"]) == {
        "conv", "h"}
    pcache = ppad(pcache, S0 + steps)
    assert pcache["p0"]["h"].shape == jcache["p0"]["h"].shape
    with torch.no_grad():
        for t in range(steps):
            plog, pcache = pmodel.decode_fn(
                pparams, pcache, tokens[:, S0 + t:S0 + t + 1], S0 + t)
            assert_logits_close(plog, want["steps"][t], f"decode step {t}")
    same_cache(pcache, want["cache"], "decoded cache", H_DECODED_TOL)


def test_generate_and_fork_match_jax(ref):
    """Greedy tokens of ``generate_batch`` / ``generate`` (3 prompts of 8
    tokens), then a 3-way fork of a prompt's cache bit for bit against
    the reference's fork through its Pallas kernel: the attention k / v
    through ``rowclone_copy``'s plain version, the mamba states tiled."""
    _, _, pmodel, np_params = _serve_models(GEN_S0 + GEN_NEW, True)
    want = ref["generate"]
    prompts = want["prompts"]
    peng = PEngine(pmodel, _tensors(np_params), s_max=GEN_S0 + GEN_NEW)
    got = peng.generate_batch(prompts, GEN_NEW)
    np.testing.assert_array_equal(got, want["tokens"])
    assert peng.generate(prompts[1], GEN_NEW) == got[1].tolist()
    pcache = cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, want["cache"]), "cpu")
    assert pcache["p0"]["conv"].dtype == torch.bfloat16
    assert pcache["p0"]["h"].dtype == torch.float32
    pops.reset_launches()
    pfork = peng.fork_cache(pcache, 3)
    assert pops.launches()["rowclone_copy"] == 0
    for pos, leaves in pfork.items():
        for name, t in leaves.items():
            w = cache_from_numpy(np.asarray(want["fork"][pos][name]), "cpu")
            assert t.shape[1] == 3 and t.dtype == w.dtype
            assert torch.equal(t.view(torch.int16), w.view(torch.int16)), \
                (pos, name)


# ---------------- training ----------------

def test_loss_fn_and_gradients_match_jax(ref):
    """float32 loss, ce, moe_aux, moe_z and every gradient leaf (the mamba
    leaves' through two chunks of the scan, recomputed in the backward
    pass) against ``jax.value_and_grad``; remat on and off give the same
    loss and gradients."""
    jcfg, _, np_params = _train_models()
    b = _batch(jcfg)
    (jl, jm), jg = ref["grad"]
    out = []
    for remat in (True, False):
        model = pzoo.build(port_cfg(jcfg), s_max=S, remat=remat)
        params = pdefs.tree_map(lambda t: t.requires_grad_(),
                                _tensors(np_params))
        loss, metrics = model.loss_fn(params, b)
        out.append((loss, metrics, torch.autograd.grad(
            loss, pdefs.tree_leaves(params))))
    (pl, pm, grads), (pl2, _, grads2) = out
    assert torch.equal(pl, pl2)
    for a, c in zip(grads, grads2):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=LOSS_RTOL)
    for k in ("ce", "moe_aux", "moe_z"):
        assert float(jm[k]) > 0
        np.testing.assert_allclose(float(pm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    leaves = [(jax.tree_util.keystr(p), np.asarray(a))
              for p, a in jax.tree_util.tree_leaves_with_path(jg)]
    assert sum("A_log" in n for n, _ in leaves) == 7
    for (name, w), g in zip(leaves, grads):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_launch_presets_do_not_divide_the_jamba_period():
    """``launch.train``'s tiny and small presets have 2 and 6 layers, and
    jamba's pattern period is 8: the configuration is refused, as the
    reference's ``layer_pattern`` asserts."""
    for preset in ("tiny", "small"):
        with pytest.raises(ValueError, match="groups of 8"):
            ptrain.main(["--arch", ARCH, "--preset", preset, "--steps", "1",
                         "--device", "cpu"])
