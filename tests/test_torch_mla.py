"""minicpm3-4b (multi-head latent attention) in the PyTorch port against the
JAX reference, at the reduced config (float32, 2 layers, d 64, 4 heads,
q_lora_rank 32, kv_lora_rank 16, qk_nope 16, qk_rope 8, v_head 16: the
latent head dim is 16 + 8 = 24): the same weights (the reference's
``init_params`` carried over by ``convert.lm_params_from_reference``) and
the same inputs go through both. The reference is imported inside the CPU
tests, so that the card tests of this file start no JAX backend.

Tolerances: one MLA mixer's output within 1e-5 of its largest entry and
its latent caches within 1e-6 of theirs (float32 on both sides, products
summed in different orders); K2's plain version at the latent head dims
within 2e-3 (the reference's float32 kernel tolerance); the server's
logits within 1e-4 of the largest |logit|, as ``test_torch_lm.py`` holds
qwen3. On the card (``-m cuda``) K2 at D = 288 is held against its plain
version at 2e-3 (float32) and 2e-2 (bfloat16)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mla, transformer, zoo
from repro_torch.runtime.server import Request, Server, ServerConfig

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

ARCH = "minicpm3-4b"
LOGIT_TOL = 1e-4
MIXER_TOL, CACHE_TOL = 1e-5, 1e-6
F32_TOL, BF16_TOL = 2e-3, 2e-2
BF16_BOUND = 1e-3
MLA_KEYS = {"wq_down", "q_norm", "wq_up", "wkv_down", "kv_norm", "wk_rope", "wk_up",
            "wv_up", "wo"}


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """(reference config, reference params, port config, port params)."""
    import jax

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo

    jcfg = jax_get_reduced(ARCH)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_reduced(ARCH), lm_params_from_reference(_np(jparams), device="cpu")


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_config_and_reduced_config_match_reference():
    from repro.configs import get_config as jax_get_config
    from repro.configs import get_reduced as jax_get_reduced

    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jax_get_reduced(ARCH))
    assert cfg.param_count() == jax_get_config(ARCH).param_count() == 4_073_830_400
    assert cfg.kv_lora_rank + cfg.qk_rope_dim in flash_ops.HEAD_DIMS


def test_convert_carries_the_mla_tree(models):
    """Every MLA leaf of every layer bit-equal to the reference's, with the
    shapes of the port's own ``init_params``; the caches are the
    reference's latent layout, the sequence on axis 1."""
    jcfg, jparams, cfg, params = models
    assert len(params["group_0"]) == cfg.num_layers
    for r, layer in enumerate(params["group_0"]):
        attn = layer["b0"]["attn"]
        assert set(attn) == MLA_KEYS
        for name, leaf in attn.items():
            want = jparams["group_0"]["b0"]["attn"][name]
            if isinstance(leaf, dict):
                leaf, want = leaf["scale"], want["scale"]
            assert leaf.dtype == torch.float32
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[r]))
    assert tuple(params["group_0"][0]["b0"]["attn"]["wq_up"].shape) == (32, 4, 24)
    own = zoo.init_params(cfg, seed=0, device="cpu")
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict) else
                           [shapes(x) for x in v] if isinstance(v, list) else tuple(v.shape)
                           for k, v in tree.items()}
    assert shapes(own) == shapes(params)
    caches = transformer.init_caches(cfg, 3, 24, "cpu")
    assert {k: tuple(v.shape) for k, v in caches["group_0"][0]["b0"].items()} == \
        {"ckv": (3, 24, 16), "krope": (3, 24, 8)}


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
@pytest.mark.parametrize("q_lora", [32, 0])
def test_mla_attention_matches_reference(q_lora, attn_impl):
    """One MLA mixer (q_lora_rank 32, minicpm3's form, or 0, deepseek's):
    a prefill of 13 tokens into the cache, then 3 decode steps. The
    reference's prefill runs ``mha_reference`` ("ref") or its Pallas
    kernel in interpret mode ("flash"); the port's runs K2's plain version
    with k as v."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import mla as jax_mla

    jcfg = dataclasses.replace(jax_get_reduced(ARCH), q_lora_rank=q_lora, attn_impl=attn_impl)
    cfg = dataclasses.replace(get_reduced(ARCH), q_lora_rank=q_lora)
    jp = jax_mla.init_mla(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = lm_params_from_reference({"attn": _np(jp)}, device="cpu")["attn"]
    assert set(p) == (MLA_KEYS if q_lora else MLA_KEYS - {"wq_down", "q_norm", "wq_up"} | {"wq"})
    b, plen, steps, max_len = 2, 13, 3, 24
    x = np.random.default_rng(5).standard_normal((b, plen + steps, cfg.d_model)).astype(np.float32)
    jcache = jax_mla.init_mla_cache(jcfg, b, max_len, jnp.float32)
    cache = mla.init_mla_cache(cfg, b, max_len, torch.float32, "cpu")
    for t0, t1 in [(0, plen)] + [(t, t + 1) for t in range(plen, plen + steps)]:
        kw = {} if t0 == 0 else {"cache_len": t0}
        jy, jcache = jax_mla.mla_attention(
            jnp.asarray(x[:, t0:t1]), jp, jcfg, jnp.arange(t0, t1), cache=jcache,
            **{k: jnp.int32(v) for k, v in kw.items()})
        y = mla.mla_attention(torch.from_numpy(x[:, t0:t1]), p, cfg, torch.arange(t0, t1),
                              cache=cache, **kw)
        assert _rel(y, jy) <= MIXER_TOL, (t0, _rel(y, jy))
        for name in ("ckv", "krope"):
            assert _rel(cache[name], jcache[name]) <= CACHE_TOL, (t0, name)


# Latent head dim -> (kv_lora_rank, MLA's sm_scale): the reduced configs',
# minicpm3-4b's and deepseek-v2-lite-16b's ((qk_nope + qk_rope) ** -0.5).
LATENTS = {24: (16, (16 + 8) ** -0.5), 288: (256, (64 + 32) ** -0.5),
           576: (512, (128 + 64) ** -0.5)}


@pytest.mark.parametrize("d", [24, 288, 576])
def test_flash_plain_version_at_latent_head_dims(d):
    """K2's plain version with one KV head and MLA's explicit sm_scale,
    at the reduced (16 + 8), minicpm3-4b's (256 + 32) and
    deepseek-v2-lite-16b's (512 + 64) latent head dims: against the
    reference's ``flash_attention`` (its Pallas kernel in interpret mode)
    and ``mha_reference`` within 2e-3. With k passed as v the first
    kv_lora_rank columns equal those of the zero-padded latent that the
    reference passes."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ops as jax_ops
    from repro.kernels.flash_attention import ref as jax_ref

    rank, scale = LATENTS[d]
    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, 4, 96, d)).astype(np.float32)
    k = rng.standard_normal((2, 1, 96, d)).astype(np.float32)
    v = np.pad(k[..., :rank], ((0, 0), (0, 0), (0, 0), (0, d - rank)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for causal, q_offset in ((True, 0), (True, 40), (False, 0)):
        kw = dict(causal=causal, sm_scale=scale, q_offset=q_offset)
        jq = jnp.asarray(q[:, :, :56] if q_offset else q)
        want = np.asarray(jax_ops.flash_attention(jq, jnp.asarray(k), jnp.asarray(v),
                                                  interpret=True, **kw))
        np.testing.assert_allclose(
            np.asarray(jax_ref.mha_reference(jq, jnp.asarray(k), jnp.asarray(v), **kw)),
            want, atol=F32_TOL, rtol=F32_TOL)
        sub = tq[:, :, :56] if q_offset else tq
        got = flash_ops.flash_attention(sub, tk, tv, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
        as_k = flash_ops.flash_attention(sub, tk, tk, **kw)
        np.testing.assert_allclose(as_k[..., :rank].numpy(), want[..., :rank],
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(as_k[..., :rank].numpy(), got[..., :rank].numpy(),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [48, 256, 320, 640])
def test_unbuilt_head_dims_are_refused_before_any_launch(d):
    """The wrapper's CUDA route refuses a head dim it has no kernel for
    before it loads the library:
    the check runs on any tensors, so it is held here on the CPU."""
    q, k = torch.zeros(1, 2, 8, d), torch.zeros(1, 1, 8, d)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops._launch(q, k, k, True, d ** -0.5, 0)


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


@pytest.mark.parametrize("attn_impl", ["flash", "ref"])
def test_server_matches_reference_server(models, attn_impl):
    """Five requests with ragged prompts and budgets over two waves of
    three slots: the same tokens as the reference server, and every
    prefill and decode step's logits within the tolerance."""
    from repro.runtime.server import Request as JaxRequest
    from repro.runtime.server import Server as JaxServer
    from repro.runtime.server import ServerConfig as JaxServerConfig

    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(3)
    lens, budgets = [5, 9, 7, 3, 11], [4, 6, 3, 5, 2]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    scfg = dict(batch_slots=3, max_len=32)
    ref = JaxServer(dataclasses.replace(jcfg, attn_impl=attn_impl), jparams,
                    JaxServerConfig(**scfg))
    srv = Server(cfg, params, ServerConfig(**scfg), device="cpu")
    ref_logits = _tap(ref, lambda t: np.asarray(t, np.float32))
    got_logits = _tap(srv, lambda t: t.numpy())
    before = flash_ops.LAUNCHES
    want = ref.serve([JaxRequest(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    got = srv.serve([Request(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    assert flash_ops.LAUNCHES == before        # the CPU runs the plain version
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        np.testing.assert_array_equal(g.output, w.output)
    assert len(got_logits) == len(ref_logits) == 2 + (6 - 1) + (5 - 1)
    for i, (g, w) in enumerate(zip(got_logits, ref_logits)):
        assert _rel(g, w) <= LOGIT_TOL, (i, _rel(g, w))


def test_prefill_and_teacher_forced_decode_match_reference(models):
    """The model's prefill (latent caches of every layer) and six decode
    steps fed the reference's tokens."""
    import jax.numpy as jnp

    from repro.models import transformer as jax_transformer

    jcfg, jparams, cfg, params = models
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
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


def test_bf16_mla_matches_reference_through_decode():
    """The MLA mixer in bfloat16 (the serving dtype) at the reduced config:
    a prefill of 40 tokens, then 8 decode steps, against the reference's
    mixer on the same bf16 weights and inputs. Decode rounds the scores to
    bf16 before their float32 softmax and the weights back to bf16 for the
    product with c_kv, in the reference's order. Measured on the CPU: the
    output within 9.8e-8 of its largest entry, the caches equal. Decode
    with the scores not rounded to bf16 before the softmax gives 7.8e-3,
    with the weights kept in float32 for the product with c_kv 5.3e-3; the
    bound, 1e-3 of each tensor's largest entry, sits between."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import mla as jax_mla

    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype="bfloat16")
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    jp = jax_mla.init_mla(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    p = lm_params_from_reference({"attn": _np(jp)}, device="cpu")["attn"]
    assert p["wq_up"].dtype == torch.bfloat16
    b, plen, steps, max_len = 2, 40, 8, 64
    x = np.random.default_rng(6).standard_normal((b, plen + steps, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jcache = jax_mla.init_mla_cache(jcfg, b, max_len, jnp.bfloat16)
    cache = mla.init_mla_cache(cfg, b, max_len, torch.bfloat16, "cpu")
    worst = {"y": 0.0, "ckv": 0.0, "krope": 0.0}
    for t0, t1 in [(0, plen)] + [(t, t + 1) for t in range(plen, plen + steps)]:
        kw = {} if t0 == 0 else {"cache_len": t0}
        jy, jcache = jax_mla.mla_attention(jx[:, t0:t1], jp, jcfg, jnp.arange(t0, t1),
                                           cache=jcache,
                                           **{k: jnp.int32(v) for k, v in kw.items()})
        y = mla.mla_attention(tx[:, t0:t1], p, cfg, torch.arange(t0, t1), cache=cache, **kw)
        assert y.dtype == torch.bfloat16
        worst["y"] = max(worst["y"], _rel(y, jy))
        for name in ("ckv", "krope"):
            worst[name] = max(worst[name], _rel(cache[name], jcache[name]))
    print(f"bf16 MLA mixer vs the reference, of the largest entry: {worst}")
    assert all(v <= BF16_BOUND for v in worst.values()), worst


def test_launch_serve_runs_reduced_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["tokens"] == 3 * 4 and out["device"] == "cpu"


def test_server_on_cuda_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request succeeds")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(cfg, params, ServerConfig())


# --- on the card --------------------------------------------------------------

MLA_SCALE = (64 + 32) ** -0.5      # minicpm3-4b: (qk_nope_dim + qk_rope_dim) ** -0.5
# (B, Hq, Sq, Skv, causal, q_offset, v) at D = 288, Hkv = 1: v a tensor of
# its own, the zero-padded latent, or k itself.
CARD_CASES = [(4, 40, 1819, 1819, True, 0, "k"), (2, 8, 333, 333, True, 0, "own"),
              (1, 4, 77, 333, True, 256, "k"), (1, 4, 100, 611, True, 511, "padded"),
              (2, 4, 200, 512, False, 0, "k"), (1, 3, 300, 256, False, 0, "own"),
              (1, 2, 1, 1, True, 0, "k")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,sq,skv,causal,q_offset,v_mode", CARD_CASES)
def test_kernel_at_latent_head_dim_matches_plain_version_on_the_card(
        dtype, b, hq, sq, skv, causal, q_offset, v_mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator().manual_seed(sq + skv)
    q = torch.randn(b, hq, sq, 288, generator=gen).to("cuda", dtype)
    k = torch.randn(b, 1, skv, 288, generator=gen).to("cuda", dtype)
    padded = torch.nn.functional.pad(k[..., :256], (0, 32))
    v = {"k": k, "padded": padded,
         "own": torch.randn(b, 1, skv, 288, generator=gen).to("cuda", dtype)}[v_mode]
    kw = dict(causal=causal, q_offset=q_offset, sm_scale=MLA_SCALE)
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1 and got.dtype == dtype
    want = fa_ref.mha_reference(q, k, v, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if v_mode == "k":       # MLA's use: the kept columns are those of the padded latent
        want_lat = fa_ref.mha_reference(q, k, padded, **kw)[..., :256]
        torch.testing.assert_close(got[..., :256].float(), want_lat.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 256, 320, 640])
def test_unbuilt_head_dims_raise_on_the_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k = torch.zeros(1, 2, 8, d, device="cuda"), torch.zeros(1, 1, 8, d, device="cuda")
    before = flash_ops.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dim"):
            flash_ops.flash_attention(q.to(dtype), k.to(dtype), k.to(dtype))
    assert flash_ops.LAUNCHES == before


@pytest.mark.cuda
def test_full_width_float32_decode_matches_fresh_prefill_on_the_card():
    """minicpm3-4b at full width and depth in float32 on the card (K2's
    SIMT kernel at D = 288 in 62 prefill layers): after 8 teacher-forced
    decode steps the logits and every layer's ckv and krope equal those of
    a fresh prefill over the same tokens, within 1e-3 of each tensor's
    largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = zoo.init_params(cfg, seed=0)
    rng = np.random.default_rng(13)
    plen, steps, max_len = 700, 8, 1024
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, plen + steps)), device="cuda")
    before = flash_ops.LAUNCHES
    logits, caches = transformer.prefill(params, cfg, toks[:, :plen], max_len)
    assert flash_ops.LAUNCHES == before + cfg.num_layers
    for t in range(steps):
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 toks[:, plen + t:plen + t + 1], plen + t)
    fresh_logits, fresh = transformer.prefill(params, cfg, toks, max_len)
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    worst = {"logits": rel(logits, fresh_logits)}
    for r, rep in enumerate(fresh["group_0"]):
        for name, want in rep["b0"].items():
            got = caches["group_0"][r]["b0"][name][:, :plen + steps]
            worst[name] = max(worst.get(name, 0.0), rel(got, want[:, :plen + steps]))
    print(f"float32 minicpm3-4b, decode vs fresh prefill, of the largest entry: {worst}")
    assert set(worst) == {"logits", "ckv", "krope"}
    assert all(v <= 1e-3 for v in worst.values()), worst
