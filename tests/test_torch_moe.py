"""Mixtures of experts in the PyTorch port against the JAX reference:
``models/moe.py`` alone, and served at the reduced deepseek-v2-lite-16b
(MLA + MoE), qwen2-moe-a2.7b and yi-6b (dense GQA, registered beside
them). The same weights (the reference's ``init_params`` carried over by
``convert.lm_params_from_reference``) and numpy-seeded inputs go through
both. The reference is imported inside the CPU tests, so that the card
tests of this file start no JAX backend.

Tolerances (float32 on both sides, products summed in different orders):
the MoE output within 1e-5 of its largest entry and the aux loss within
1e-6, with the router's choices and the keep mask equal; the server's
logits within 1e-4 of the largest |logit|, as ``test_torch_lm.py`` holds
qwen3. On the card (``-m cuda``) K2 at deepseek's latent head dim 576 is
held against its plain version at 2e-3 (float32) and 2e-2 (bfloat16),
and a float32 deepseek at full width decodes what a fresh prefill
computes within 1e-3."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe, transformer, zoo
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.server import Request, Server, ServerConfig

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b")
ARCHS = (*MOE_ARCHS, "yi-6b")
Y_TOL, AUX_TOL, LOGIT_TOL = 1e-5, 1e-6, 1e-4
F32_TOL, BF16_TOL = 2e-3, 2e-2
# Parameters in the reference's tree at full size (jax.eval_shape of its
# init_params): every layer of a MoE model is MoE, and qwen2-moe holds 64
# expert slots for its 60 experts, so both exceed ``param_count()``.
FULL_PARAMS = {"deepseek-v2-lite-16b": 16_210_324_992, "qwen2-moe-a2.7b": 15_146_059_776,
               "yi-6b": 6_061_035_520}


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _moe_cfg(**kw) -> ModelConfig:
    """The reference test file's MoE config: 6 experts in 16 slots, top-2."""
    base = dict(name="m", family="moe", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
                d_ff=64, vocab_size=128, moe=True, n_routed_experts=6, n_shared_experts=0,
                top_k=2, moe_d_ff=16, capacity_factor=8.0, dtype="float32", remat="none")
    base.update(kw)
    return ModelConfig(**base)


def _reference_routing(x, jp, cfg):
    """The reference's router choices and keep mask, by its own steps
    (``jax.lax.top_k``, the masked cumulative sum), which its ``moe_ffn``
    keeps inside."""
    import jax
    import jax.numpy as jnp

    e, k = cfg.n_routed_experts, cfg.top_k
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = xt.shape[0]
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, gate_e = jax.lax.top_k(probs, k)
    groups = max(cfg.moe_dispatch_groups, 1)
    if t % groups:
        groups = 1
    t_g = t // groups
    capacity = int(max(1, round(t_g * k / e * cfg.capacity_factor)))
    flat = gate_e.reshape(groups, t_g * k)
    pos = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(flat, e, dtype=jnp.int32), axis=1) - 1,
                              flat[..., None], axis=2)[..., 0]
    return np.asarray(gate_e), np.asarray(pos < capacity), capacity


def _skewed(jp):
    """A router that favours expert 0 and leaves the others tied."""
    jp = dict(jp)
    jp["router"] = jp["router"].at[:, :].set(0.0).at[:, 0].set(10.0)
    return jp


# (name, config, (B, S), router edit): the reduced deepseek and qwen2-moe
# shapes, the reference test file's config, ties, the half-way capacity,
# everything but one pair an expert dropped, groups, and no shared expert.
MOE_CASES = {
    "deepseek-reduced": (lambda: get_reduced("deepseek-v2-lite-16b"), (2, 7), None),
    "qwen2-moe-reduced": (lambda: get_reduced("qwen2-moe-a2.7b"), (3, 5), None),
    "reference-cfg": (lambda: _moe_cfg(), (2, 8), None),
    "skewed-ties": (lambda: _moe_cfg(), (4, 16), _skewed),
    "capacity-2.5-rounds-to-2": (lambda: get_reduced("deepseek-v2-lite-16b"), (4, 1), None),
    "capacity-factor-1e-6": (lambda: _moe_cfg(capacity_factor=1e-6, n_shared_experts=1), (2, 8),
                             None),
    "two-groups": (lambda: dataclasses.replace(get_reduced("qwen2-moe-a2.7b"),
                                               moe_dispatch_groups=2), (2, 12), None),
    "groups-not-dividing-t": (lambda: dataclasses.replace(get_reduced("qwen2-moe-a2.7b"),
                                                          moe_dispatch_groups=4), (3, 5), None),
    "no-shared-expert": (lambda: dataclasses.replace(get_reduced("deepseek-v2-lite-16b"),
                                                     n_shared_experts=0), (2, 9), None),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    """The port's router picks and keep mask equal the reference's
    (``jax.lax.top_k``'s tie order), its capacity is the reference's (2.5
    rounds half to even, to 2), y is within 1e-5 of the largest entry and
    the aux loss within 1e-6."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jax_moe

    make_cfg, shape, edit = MOE_CASES[case]
    cfg = make_cfg()
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    if edit is not None:
        jp = edit(jp)
    p = lm_params_from_reference({"ffn": _np(jp)}, device="cpu")["ffn"]
    x = np.random.default_rng(len(case)).standard_normal((*shape, cfg.d_model)).astype(np.float32)

    gate_e, keep, capacity = _reference_routing(x, jp, cfg)
    r = moe.plan(*moe.pick(torch.from_numpy(x).reshape(-1, cfg.d_model), p, cfg), cfg)
    assert r.capacity == capacity
    np.testing.assert_array_equal(r.gate_e.numpy(), gate_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if case == "capacity-2.5-rounds-to-2":
        assert capacity == 2 and not keep.all()
    if case == "skewed-ties":
        assert set(gate_e.flatten()) <= {0, 1, 2}   # the lowest indices win the ties
    if case == "capacity-factor-1e-6":
        assert capacity == 1 and keep.sum() <= cfg.n_routed_experts

    jy, jaux = jax_moe.moe_ffn(jnp.asarray(x), jp, cfg)
    y, aux = moe.moe_ffn(torch.from_numpy(x), p, cfg)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    assert _rel(y, jy) <= Y_TOL, _rel(y, jy)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


def _invariant_expert_padding():
    cfg = _moe_cfg()
    assert moe.padded_experts(cfg) == 16
    assert moe.padded_experts(get_config("qwen2-moe-a2.7b")) == 64
    assert moe.padded_experts(get_config("deepseek-v2-lite-16b")) == 64
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    assert tuple(p["gate"].shape) == (16, 32, 16) and tuple(p["down"].shape) == (16, 16, 32)
    assert tuple(p["router"].shape) == (32, 6)           # the router sees the real experts
    x = torch.randn(3, 10, 32, generator=torch.Generator().manual_seed(1))
    assert int(moe.pick(x.reshape(-1, 32), p, cfg)[1].max()) < 6


def _invariant_identical_experts_are_one_mlp():
    """Every expert the same and ample capacity: a dense MLP (gates sum to 1)."""
    cfg = _moe_cfg()
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32, "cpu")
    for name in ("gate", "up", "down"):
        p[name] = p[name][:1].expand_as(p[name]).contiguous()
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(3))
    y, aux = moe.moe_ffn(x, p, cfg)
    dense = (torch.nn.functional.silu(x @ p["gate"][0]) * (x @ p["up"][0])) @ p["down"][0]
    torch.testing.assert_close(y, dense, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(aux)


def _invariant_drops_shrink_the_output():
    cfg = _moe_cfg(capacity_factor=1e-6)
    p = moe.init_moe(torch.Generator().manual_seed(4), cfg, torch.float32, "cpu")
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(5))
    y, _ = moe.moe_ffn(x, p, cfg)
    y_full, _ = moe.moe_ffn(x, p, dataclasses.replace(cfg, capacity_factor=8.0))
    assert y.abs().mean() < y_full.abs().mean()


def _invariant_skewed_router_scores_higher_aux():
    cfg = _moe_cfg()
    p = moe.init_moe(torch.Generator().manual_seed(6), cfg, torch.float32, "cpu")
    x = torch.randn(4, 16, 32, generator=torch.Generator().manual_seed(7))
    skew = dict(p, router=torch.zeros_like(p["router"]))
    skew["router"][:, 0] = 10.0
    assert float(moe.moe_ffn(x, skew, cfg)[1]) > float(moe.moe_ffn(x, p, cfg)[1])


INVARIANTS = {f.__name__[len("_invariant_"):]: f for f in (
    _invariant_expert_padding, _invariant_identical_experts_are_one_mlp,
    _invariant_drops_shrink_the_output, _invariant_skewed_router_scores_higher_aux)}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_reference_moe_invariants_hold_on_the_port(name):
    """``tests/test_moe_encdec.py``'s MoE invariants, on the port."""
    INVARIANTS[name]()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return tree.numel() if isinstance(tree, torch.Tensor) else int(np.prod(tree.shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameters_match_reference(arch):
    """The config and the reduced config equal the reference's; the port's
    ``init_params`` gives the reference's tree shapes at the reduced size
    (each repetition of a layer group one list entry) and the reference's
    parameter count at full size (fake tensors: nothing is allocated)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo

    cfg, small = get_config(arch), get_reduced(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(small) == dataclasses.asdict(jax_get_reduced(arch))
    assert cfg.param_count() == jax_get_config(arch).param_count()
    if cfg.moe:
        assert small.n_routed_experts == 4 and small.moe_d_ff == 32
        assert small.top_k == 2 and small.n_shared_experts == 1
    jshapes = jax.eval_shape(lambda: jax_zoo.init_params(jax.random.PRNGKey(0), small))
    own = zoo.init_params(small, seed=0, device="cpu")
    n_rep = len(own["group_0"])
    want = {k: ([jax.tree_util.tree_map(lambda a: tuple(a.shape[1:]), v)] * n_rep
                if k.startswith("group_") else jax.tree_util.tree_map(lambda a: tuple(a.shape), v))
            for k, v in jshapes.items()}
    assert _shapes(own) == want
    full = jax.eval_shape(lambda: jax_zoo.init_params(jax.random.PRNGKey(0), cfg))
    assert _count(full) == FULL_PARAMS[arch]
    with FakeTensorMode():
        assert _count(zoo.init_params(cfg, device="cpu")) == FULL_PARAMS[arch]


@pytest.fixture(scope="module")
def reference_models():
    """arch -> (reference config, reference params, port config, port
    params), each reduced model built once for the module."""
    import jax

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo

    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jax_get_reduced(arch)
            jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
            built[arch] = (jcfg, jparams, get_reduced(arch),
                           lm_params_from_reference(_np(jparams), device="cpu"))
        return built[arch]
    return get


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_carries_the_moe_tree(reference_models, arch):
    """Every MoE leaf of every layer (router, experts, shared MLP) bit-equal
    to the reference's, in the dtypes the reference drew them in."""
    _, jparams, cfg, params = reference_models(arch)
    assert len(params["group_0"]) == cfg.num_layers
    for r, layer in enumerate(params["group_0"]):
        ffn, jffn = layer["b0"]["ffn"], jparams["group_0"]["b0"]["ffn"]
        assert set(ffn) == {"router", "gate", "up", "down", "shared"}
        for name in ("router", "gate", "up", "down"):
            np.testing.assert_array_equal(ffn[name].numpy(), np.asarray(jffn[name][r]))
        for name, leaf in ffn["shared"].items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jffn["shared"][name][r]))
        assert ffn["router"].dtype == torch.float32
        assert tuple(ffn["gate"].shape) == (16, cfg.d_model, cfg.moe_d_ff)


def _tap(server, to_numpy):
    """Record every prefill and decode logits the server computes."""
    seen = []
    prefill, decode = server._prefill, server._decode

    def tapped_prefill(params, batch):
        logits, caches = prefill(params, batch)
        seen.append(to_numpy(logits))
        return logits, caches

    def tapped_decode(params, caches, token, cache_len):
        logits, caches = decode(params, caches, token, cache_len)
        seen.append(to_numpy(logits))
        return logits, caches

    server._prefill, server._decode = tapped_prefill, tapped_decode
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_reference_server(reference_models, arch, monkeypatch):
    """Six requests with ragged prompts and budgets over two waves of four
    slots: the same tokens as the reference server, every prefill and
    decode step's logits within the tolerance. A MoE model's decode steps
    over four slots have capacity round(4 · 2 / 4 · 1.25) = 2, so they
    drop pairs, as the reference's do (counted on the port)."""
    from repro.runtime.server import Request as JaxRequest
    from repro.runtime.server import Server as JaxServer
    from repro.runtime.server import ServerConfig as JaxServerConfig

    jcfg, jparams, cfg, params = reference_models(arch)
    rng = np.random.default_rng(4)
    lens, budgets = [5, 9, 7, 3, 11, 6], [4, 6, 3, 5, 2, 4]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    scfg = dict(batch_slots=4, max_len=32)
    ref = JaxServer(jcfg, jparams, JaxServerConfig(**scfg))
    srv = Server(cfg, params, ServerConfig(**scfg), device="cpu")
    ref_logits = _tap(ref, lambda t: np.asarray(t, np.float32))
    got_logits = _tap(srv, lambda t: t.numpy())
    dropped = {}
    plan = moe.plan

    def counting_plan(*args):
        r = plan(*args)
        kind = "decode" if r.gate_e.shape[0] <= scfg["batch_slots"] else "prefill"
        dropped[kind] = dropped.get(kind, 0) + int((~r.keep).sum())
        return r

    monkeypatch.setattr(moe, "plan", counting_plan)
    want = ref.serve([JaxRequest(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    got = srv.serve([Request(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        np.testing.assert_array_equal(g.output, w.output)
    assert len(got_logits) == len(ref_logits) == 2 + (6 - 1) + (4 - 1)
    for i, (g, w) in enumerate(zip(got_logits, ref_logits)):
        assert _rel(g, w) <= LOGIT_TOL, (i, _rel(g, w))
    if cfg.moe:
        assert dropped.get("decode", 0) > 0, dropped


def test_prefill_and_teacher_forced_decode_match_reference(reference_models):
    """deepseek-v2-lite-16b: the prefill (latent caches of every layer) and
    six decode steps fed the reference's tokens."""
    import jax.numpy as jnp

    from repro.models import transformer as jax_transformer

    jcfg, jparams, cfg, params = reference_models("deepseek-v2-lite-16b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 11)).astype(np.int32)
    max_len = 24
    jlogits, jcaches = jax_transformer.prefill(jparams, jcfg, jnp.asarray(toks), max_len)
    logits, caches = transformer.prefill(params, cfg, torch.as_tensor(toks, dtype=torch.int64),
                                         max_len)
    assert _rel(logits, jlogits) <= LOGIT_TOL
    for r in range(cfg.num_layers):
        for name in ("ckv", "krope"):
            assert _rel(caches["group_0"][r]["b0"][name],
                        jcaches["group_0"]["b0"][name][r]) <= 1e-5, (r, name)
    cache_len = toks.shape[1]
    for step in range(6):
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
        jlogits, jcaches = jax_transformer.decode_step(jparams, jcfg, jcaches,
                                                       jnp.asarray(tok), jnp.int32(cache_len))
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 torch.as_tensor(tok, dtype=torch.int64),
                                                 cache_len)
        assert _rel(logits, jlogits) <= LOGIT_TOL, step
        cache_len += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_reduced_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["tokens"] == 3 * 4 and out["device"] == "cpu"


# --- on the card --------------------------------------------------------------

DEEPSEEK_SCALE = (128 + 64) ** -0.5      # (qk_nope_dim + qk_rope_dim) ** -0.5
# (B, Hq, Sq, Skv, causal, q_offset, v) at D = 576, Hkv = 1: deepseek's
# prefill wave, v a tensor of its own, the zero-padded latent or k itself,
# ragged lengths with q_offset, non-causal, one query.
CARD_CASES_576 = [(4, 16, 1819, 1819, True, 0, "k"), (2, 8, 333, 333, True, 0, "own"),
                  (1, 4, 77, 333, True, 256, "k"), (1, 4, 100, 611, True, 511, "padded"),
                  (2, 4, 200, 512, False, 0, "k"), (1, 3, 300, 256, False, 0, "own"),
                  (1, 2, 1, 1, True, 0, "k")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,sq,skv,causal,q_offset,v_mode", CARD_CASES_576)
def test_kernel_at_head_dim_576_matches_plain_version_on_the_card(
        dtype, b, hq, sq, skv, causal, q_offset, v_mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator().manual_seed(sq + skv)
    q = torch.randn(b, hq, sq, 576, generator=gen).to("cuda", dtype)
    k = torch.randn(b, 1, skv, 576, generator=gen).to("cuda", dtype)
    padded = torch.nn.functional.pad(k[..., :512], (0, 64))
    v = {"k": k, "padded": padded,
         "own": torch.randn(b, 1, skv, 576, generator=gen).to("cuda", dtype)}[v_mode]
    kw = dict(causal=causal, q_offset=q_offset, sm_scale=DEEPSEEK_SCALE)
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1 and got.dtype == dtype
    want = fa_ref.mha_reference(q, k, v, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if v_mode == "k":       # MLA's use: the kept columns are those of the padded latent
        want_lat = fa_ref.mha_reference(q, k, padded, **kw)[..., :512]
        torch.testing.assert_close(got[..., :512].float(), want_lat.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_full_width_float32_decode_matches_fresh_prefill_on_the_card():
    """deepseek-v2-lite-16b at full width in float32, cut to 4 layers (60
    GiB at full depth), at the no-drop capacity factor E / k (capacity =
    T, so a decode step drops what a fresh prefill drops: nothing): after
    8 teacher-forced decode steps the logits and every layer's ckv and
    krope equal a fresh prefill's over the same tokens within 1e-3 of each
    tensor's largest entry. K2 runs its float32 kernel at D = 576."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    base = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(base, dtype="float32", num_layers=4,
                              capacity_factor=base.n_routed_experts / base.top_k)
    params = zoo.init_params(cfg, seed=0)
    rng = np.random.default_rng(13)
    plen, steps, max_len = 700, 8, 1024
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, plen + steps)), device="cuda")
    kept = []
    plan = moe.plan

    def counting_plan(*args):
        r = plan(*args)
        kept.append(bool(r.keep.all()))
        return r

    moe.plan = counting_plan
    try:
        before = flash_ops.LAUNCHES
        logits, caches = transformer.prefill(params, cfg, toks[:, :plen], max_len)
        assert flash_ops.LAUNCHES == before + cfg.num_layers
        for t in range(steps):
            logits, caches = transformer.decode_step(params, cfg, caches,
                                                     toks[:, plen + t:plen + t + 1], plen + t)
        fresh_logits, fresh = transformer.prefill(params, cfg, toks, max_len)
    finally:
        moe.plan = plan
    assert all(kept) and len(kept) == cfg.num_layers * (steps + 2)
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    worst = {"logits": rel(logits, fresh_logits)}
    for r, rep in enumerate(fresh["group_0"]):
        for name, want in rep["b0"].items():
            got = caches["group_0"][r]["b0"][name][:, :plen + steps]
            worst[name] = max(worst.get(name, 0.0), rel(got, want[:, :plen + steps]))
    print(f"float32 deepseek-v2-lite-16b (4 layers), decode vs fresh prefill: {worst}")
    assert set(worst) == {"logits", "ckv", "krope"}
    assert all(v <= 1e-3 for v in worst.values()), worst
