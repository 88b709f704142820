"""LM serving of the PyTorch port against the JAX reference, at the reduced
qwen3-1.7b (float32, 2 layers, d 64, 4/2 heads, head dim 16): the same
weights (the reference's ``init_params`` carried over by
``convert.lm_params_from_reference``) and the same tokens go through both.

Tolerance for logits: 1e-4 of the largest |logit|. Both sides compute in
float32 but sum matrix products in different orders; over two layers that
leaves differences near 1e-6 of the logits' scale, so 1e-4 is far from
both the measured error and any real fault (a wrong mask, rope phase or
cache slot moves logits by tens of percent)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.models import zoo as jax_zoo
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import Server as JaxServer
from repro.runtime.server import ServerConfig as JaxServerConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, transformer, zoo
from repro_torch.runtime.server import Request, Server, ServerConfig

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
LOGIT_TOL = 1e-4
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def models():
    """(reference config, reference params, port config, port params)."""
    jcfg = jax_get_reduced(ARCH)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, jparams, get_reduced(ARCH), params


def _assert_logits_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    bound = LOGIT_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (what, np.abs(got - want).max(), bound)


def test_reduced_config_and_params_match_reference(models):
    jcfg, jparams, cfg, params = models
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert len(params["group_0"]) == cfg.num_layers
    np.testing.assert_array_equal(params["group_0"][1]["b0"]["attn"]["wq"].numpy(),
                                  np.asarray(jparams["group_0"]["b0"]["attn"]["wq"][1]))
    own = zoo.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(params)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "chameleon-34b", "llama3-405b"])
def test_unported_architectures_raise(arch):
    """The three architectures the port once refused: each config, reduced
    config and parameter count now equal the reference's."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jax_get_reduced(arch))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()


def test_rmsnorm_within_a_few_ulp():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 40, 16)) * 3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    want = np.asarray(jax_layers.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-6))
    got = layers.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)}, 1e-6)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=4)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_within_a_few_ulp(theta):
    """Frequencies bit-exact; rotated values within 4 ULP of the output's
    scale (x1 cos - x2 sin cancels, so near-zero outputs are held
    absolutely, not per element)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 4, 40, 16)) * 3).astype(np.float32)
    pos = np.arange(40) + 100
    np.testing.assert_array_equal(layers.rope_freqs(16, theta).numpy(),
                                  np.asarray(jax_layers.rope_freqs(16, theta)))
    want = np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * F32_EPS * np.abs(want).max())


def test_prefill_and_teacher_forced_decode_match_reference(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    max_len = 24
    jlogits, jcaches = jax_transformer.prefill(jparams, jcfg, jnp.asarray(toks), max_len)
    logits, caches = transformer.prefill(params, cfg, torch.as_tensor(toks, dtype=torch.int64),
                                         max_len)
    _assert_logits_close(logits, jlogits, "prefill")
    np.testing.assert_allclose(caches["group_0"][1]["b0"]["k"].numpy(),
                               np.asarray(jcaches["group_0"]["b0"]["k"][1]),
                               atol=1e-5, rtol=1e-5)
    cache_len = toks.shape[1]
    for step in range(6):
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]   # the reference's token
        jlogits, jcaches = jax_transformer.decode_step(jparams, jcfg, jcaches,
                                                       jnp.asarray(tok), jnp.int32(cache_len))
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 torch.as_tensor(tok, dtype=torch.int64),
                                                 cache_len)
        _assert_logits_close(logits, jlogits, f"decode step {step}")
        cache_len += 1


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
        _assert_logits_close(g, w, f"call {i}")


def test_server_on_cuda_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request succeeds")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(cfg, params, ServerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.init_params(cfg)                      # device defaults to "cuda"


def test_launch_serve_runs_reduced_on_cpu(capsys):
    """The serving CLI with the reference launcher's defaults, reduced, on the CPU."""
    launch_serve.main(["--reduced", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 6 and out["tokens"] == 6 * 8 and out["device"] == "cpu"
