"""zamba2-7b serving of the PyTorch port against the JAX reference, at the
reduced config (float32, 12 layers = two cycles of five Mamba2 blocks and
one attention block, d 64, 4 SSD heads of 32 with state 16, attention
head dim 16): the same weights (the reference's ``init_params`` carried
over by ``convert.lm_params_from_reference``) and the same tokens go
through both.

Tolerances: one Mamba2 mixer within 1e-5 (absolute and relative: float32
on both sides, products summed in different orders); through the 12
layers every cache entry within 1e-4 (the order differences grow to
~1.4e-5 on entries of ~0.3 by the last layers) and logits within 1e-4 of
the largest |logit|, as ``test_torch_lm.py`` holds qwen3."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.models import mamba2 as jax_mamba
from repro.models import transformer as jax_transformer
from repro.models import zoo as jax_zoo
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import Server as JaxServer
from repro.runtime.server import ServerConfig as JaxServerConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba2, transformer, zoo
from repro_torch.runtime.server import Request, Server, ServerConfig

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

ARCH = "zamba2-7b"
LOGIT_TOL = 1e-4
MIXER_TOL = 1e-5
CACHE_TOL = 1e-4


def _to_port(jparams):
    return lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def models():
    """(reference config, reference params, port config, port params)."""
    jcfg = jax_get_reduced(ARCH)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_reduced(ARCH), _to_port(jparams)


def _assert_logits_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    bound = LOGIT_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (what, np.abs(got - want).max(), bound)


def test_config_and_params_match_reference(models):
    jcfg, jparams, cfg, params = models
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_state) == (12, 64, 4, 16)
    assert mamba2._dims(cfg) == jax_mamba._dims(jcfg) == (128, 4, 32, 16)
    assert cfg.resolved_head_dim == 16
    assert len(params["group_0"]) == 2 and "group_1" not in params
    np.testing.assert_array_equal(params["group_0"][1]["b2"]["mixer"]["in_proj"].numpy(),
                                  np.asarray(jparams["group_0"]["b2"]["mixer"]["in_proj"][1]))
    own = zoo.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(params)
    ref_caches = jax_transformer.init_caches(jcfg, 3, 24)
    caches = transformer.init_caches(cfg, 3, 24, "cpu")
    for j in range(6):
        for name, want in ref_caches["group_0"]["b" + str(j)].items():
            got = caches["group_0"][1][f"b{j}"][name]
            assert tuple(got.shape) == tuple(want.shape[1:]), (j, name)


def test_conversion_keeps_each_leaf_dtype():
    """At the model dtype bf16 a Mamba2 block keeps A_log, D and dt_bias in
    float32 and the rest in bf16, and a remainder group carries over."""
    jcfg = jax_zoo.reduce_config(jax_get_config(ARCH), dtype="bfloat16", num_layers=9)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(1), jcfg)
    params = _to_port(jparams)
    assert len(params["group_0"]) == 1 and len(params["group_1"]) == 1
    assert set(params["group_1"][0]) == {"b0", "b1", "b2"}
    mixer = params["group_1"][0]["b2"]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert mixer[name].dtype == torch.bfloat16, name
    np.testing.assert_array_equal(
        mixer["conv_w"].float().numpy(),
        np.asarray(jparams["group_1"]["b2"]["mixer"]["conv_w"][0], np.float32))
    own = zoo.init_params(zoo.reduce_config(get_config(ARCH), dtype="bfloat16", num_layers=9),
                          device="cpu")
    dtypes = lambda t: jax.tree_util.tree_map(lambda a: str(a.dtype).split(".")[-1], t)
    assert dtypes(own) == dtypes(params)


@pytest.mark.parametrize("chunk", [16, 128])
def test_mamba_mixer_prefill_and_decode_match_reference(models, chunk):
    """Prefill output and final state (conv window and ssm state), then one
    decode step from that state: ragged chunks at 16, one short chunk at 128."""
    jcfg, jparams, cfg, params = models
    jcfg = dataclasses.replace(jcfg, ssm_chunk=chunk)
    cfg = dataclasses.replace(cfg, ssm_chunk=chunk)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["group_0"]["b1"]["mixer"])
    p = params["group_0"][0]["b1"]["mixer"]
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 41, cfg.d_model)).astype(np.float32)
    jy, jstate = jax_mamba.mamba_mixer(jnp.asarray(x[:, :40]), jp, jcfg, return_state=True)
    y, state = mamba2.mamba_mixer(torch.from_numpy(x[:, :40]), p, cfg, return_state=True)
    tol = dict(atol=MIXER_TOL, rtol=MIXER_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), **tol)
    jy, jstate = jax_mamba.mamba_mixer(jnp.asarray(x[:, 40:]), jp, jcfg, state=jstate)
    y, state = mamba2.mamba_mixer(torch.from_numpy(x[:, 40:]), p, cfg, state=state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), **tol)


def _assert_caches_close(caches, jcaches, tol):
    """Every layer's k, v (attention) and conv, ssm (Mamba2) entry."""
    for group, reps in caches.items():
        for r, rep in enumerate(reps):
            for block, entry in rep.items():
                for name, got in entry.items():
                    np.testing.assert_allclose(got.numpy(),
                                               np.asarray(jcaches[group][block][name][r]),
                                               atol=tol, rtol=tol,
                                               err_msg=f"{group}[{r}].{block}.{name}")


def _prefill_then_decode(jcfg, jparams, cfg, params, steps=6):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    max_len = 24
    jlogits, jcaches = jax_transformer.prefill(jparams, jcfg, jnp.asarray(toks), max_len)
    logits, caches = transformer.prefill(params, cfg, torch.as_tensor(toks, dtype=torch.int64),
                                         max_len)
    _assert_logits_close(logits, jlogits, "prefill")
    _assert_caches_close(caches, jcaches, CACHE_TOL)
    cache_len = toks.shape[1]
    for step in range(steps):
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]   # the reference's token
        jlogits, jcaches = jax_transformer.decode_step(jparams, jcfg, jcaches,
                                                       jnp.asarray(tok), jnp.int32(cache_len))
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 torch.as_tensor(tok, dtype=torch.int64),
                                                 cache_len)
        _assert_logits_close(logits, jlogits, f"decode step {step}")
        cache_len += 1
    return caches, jcaches


def test_prefill_and_teacher_forced_decode_match_reference(models):
    jcfg, jparams, cfg, params = models
    caches, jcaches = _prefill_then_decode(jcfg, jparams, cfg, params)
    _assert_caches_close(caches, jcaches, CACHE_TOL)


def test_remainder_group_matches_reference():
    """num_layers=9: one cycle (m, m, m, m, m, a), then the group (m, m, m)."""
    jcfg = jax_zoo.reduce_config(jax_get_config(ARCH), num_layers=9)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(3), jcfg)
    cfg = zoo.reduce_config(get_config(ARCH), num_layers=9)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    caches, jcaches = _prefill_then_decode(jcfg, jparams, cfg, _to_port(jparams), steps=2)
    assert set(caches["group_1"][0]) == {"b0", "b1", "b2"}
    _assert_caches_close(caches, jcaches, CACHE_TOL)


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


def test_server_matches_reference_server(models):
    """Five requests with ragged prompts (left-padded with token 0, no pad
    mask: the Mamba2 state runs over the pads in both) and budgets over two
    waves of three slots: the same tokens as the reference server, and
    every prefill and decode step's logits within the tolerance."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(3)
    lens, budgets = [5, 9, 7, 3, 11], [4, 6, 3, 5, 2]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    scfg = dict(batch_slots=3, max_len=32)
    ref = JaxServer(jcfg, jparams, JaxServerConfig(**scfg))
    srv = Server(cfg, params, ServerConfig(**scfg), device="cpu")
    ref_logits = _tap(ref, lambda t: np.asarray(t, np.float32))
    got_logits = _tap(srv, lambda t: t.numpy())
    before = flash_ops.LAUNCHES, ssd_ops.LAUNCHES
    want = ref.serve([JaxRequest(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    got = srv.serve([Request(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    assert (flash_ops.LAUNCHES, ssd_ops.LAUNCHES) == before   # the CPU runs the plain versions
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        np.testing.assert_array_equal(g.output, w.output)
    assert len(got_logits) == len(ref_logits) == 2 + (6 - 1) + (5 - 1)
    for i, (g, w) in enumerate(zip(got_logits, ref_logits)):
        _assert_logits_close(g, w, f"call {i}")


def test_launch_serve_runs_reduced_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["tokens"] == 3 * 4 and out["device"] == "cpu"


def test_flash_plain_version_at_head_dim_112():
    """zamba2's attention heads are 3,584 / 32 = 112 wide: the wrapper
    takes that head dim, and on the CPU matches the reference's
    ``mha_reference`` within the float32 kernel tolerance."""
    assert 112 in flash_ops.HEAD_DIMS
    assert get_config(ARCH).resolved_head_dim == 112
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal((1, 2, 96, 112)).astype(np.float32) for _ in range(3))
    want = jax_fa_ref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for got in (fa_ref.mha_reference(*t), flash_ops.flash_attention(*t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("feature", [{"encdec": True}, {"frontend": "vision"}])
def test_unported_block_features_raise(feature):
    """The features the port once refused on zamba2's reduced config, held
    to what the reference does with the same config: ``encdec`` with no
    encoder or decoder layer raises in both (the reference stacks zero
    layers), and a vision front end changes nothing (the same tree)."""
    jcfg = dataclasses.replace(jax_zoo.reduce_config(jax_get_config(ARCH)), **feature)
    cfg = dataclasses.replace(get_reduced(ARCH), **feature)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if cfg.encdec:
        assert cfg.enc_layers == cfg.dec_layers == 0
        with pytest.raises(TypeError):
            jax.eval_shape(lambda: jax_zoo.init_params(jax.random.PRNGKey(0), jcfg))
        with pytest.raises(ValueError, match="enc_layers"):
            zoo.init_params(cfg, device="cpu")
        return
    want = jax.eval_shape(lambda: jax_zoo.init_params(jax.random.PRNGKey(0), jcfg))
    got = zoo.init_params(cfg, device="cpu")
    assert sorted(got) == sorted(want)
    n_rep = len(got["group_0"])
    assert [jax.tree_util.tree_map(lambda a: tuple(a.shape), r) for r in got["group_0"]] == \
        [jax.tree_util.tree_map(lambda a: tuple(a.shape[1:]), want["group_0"])] * n_rep


@pytest.mark.cuda
def test_full_width_float32_decode_matches_fresh_prefill_on_the_card():
    """zamba2-7b at full width and depth in float32 on the card (K3 in 68
    prefill layers, K2 in 13): after 8 teacher-forced decode steps the
    logits, every layer's k and v and every Mamba2 layer's conv and ssm
    state equal those of a fresh prefill over the same tokens, within 1e-3
    of each tensor's largest entry. In bf16 the same comparison differs
    by up to ~0.1 from rounding alone, which ``chip_smoke.py`` bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = zoo.init_params(cfg, seed=0)
    rng = np.random.default_rng(13)
    plen, steps, max_len = 700, 8, 1024
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, plen + steps)), device="cuda")
    logits, caches = transformer.prefill(params, cfg, toks[:, :plen], max_len)
    for t in range(steps):
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 toks[:, plen + t:plen + t + 1], plen + t)
    fresh_logits, fresh = transformer.prefill(params, cfg, toks, max_len)
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    worst = {"logits": rel(logits, fresh_logits)}
    for group, reps in fresh.items():
        for r, rep in enumerate(reps):
            for block, entry in rep.items():
                for name, want in entry.items():
                    got = caches[group][r][block][name]
                    if name in ("k", "v"):
                        got, want = got[:, :, :plen + steps], want[:, :, :plen + steps]
                    kind = "kv" if name in ("k", "v") else name
                    worst[kind] = max(worst.get(kind, 0.0), rel(got, want))
    print(f"float32 zamba2-7b, decode vs fresh prefill, of the largest entry: {worst}")
    assert set(worst) == {"logits", "kv", "conv", "ssm"}
    assert all(v <= 1e-3 for v in worst.values()), worst


@pytest.mark.cuda
def test_mamba_mixer_on_the_card_matches_its_plain_route(monkeypatch):
    """One Mamba2 mixer at zamba2-7b's width (112 heads of 64, state 64,
    chunk 128) in float32 on the card, prefilling 2 x 300 tokens: the scan
    runs once through the CUDA kernels in the mixer's layout (B and C per
    batch, y written as (B, S, H, P)); the same mixer with the scan's plain
    route (B and C expanded to every head) gives the output and the ssm
    state within 3e-3 of each tensor's largest entry, the kernels'
    tolerance; the conv window is the same tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = mamba2.init_mamba(gen, cfg, torch.float32, "cuda")
    x = torch.randn(2, 300, cfg.d_model, generator=gen, device="cuda")
    before = ssd_ops.LAUNCHES
    y, state = mamba2.mamba_mixer(x, p, cfg, return_state=True)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    monkeypatch.setattr(mamba2, "ssd_scan_heads", ssd_ops._plain)
    want_y, want_state = mamba2.mamba_mixer(x, p, cfg, return_state=True)
    assert ssd_ops.LAUNCHES == before + 1
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    assert torch.isfinite(y).all() and torch.isfinite(state["ssm"]).all()
    assert rel(y, want_y) <= 3e-3 and rel(state["ssm"], want_state["ssm"]) <= 3e-3
    torch.testing.assert_close(state["conv"], want_state["conv"], rtol=0, atol=0)
