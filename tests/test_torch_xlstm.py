"""xlstm-350m serving of the PyTorch port against the JAX reference, at the
reduced config (float32, 16 layers = two cycles of seven mLSTM blocks and
one sLSTM block, d 64, 4 heads of 32 with a 32 x 33 matrix memory each,
chunk 512): the same weights (the reference's ``init_params`` carried over
by ``convert.lm_params_from_reference``) and the same tokens go through
both.

Tolerances: each mixer within 1e-4, absolute and relative (float32 on both
sides; products summed in other orders and transcendentals a few ULP
apart, ~1e-6 on outputs of ~1); the plain chunked SSD scan at a wide shape
(P != N, chunk > S) within the reference kernel tests' 3e-3; through the
16 layers every cache entry within 1e-4 and logits within 1e-4 of the
largest |logit| (measured ~4e-6 of it), as ``test_torch_lm.py`` holds
qwen3. On the card, K3's wide route against its plain version within
3e-3, the kernel tolerance of ``tests/test_kernels.py``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.ssm_scan import ref as jax_ssd_ref
from repro.models import transformer as jax_transformer
from repro.models import xlstm as jax_xlstm
from repro.models import zoo as jax_zoo
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import Server as JaxServer
from repro.runtime.server import ServerConfig as JaxServerConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.kernels.ssm_scan import ref as ssd_ref
from repro_torch.kernels.ssm_scan import wide as ssd_wide
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer, xlstm, zoo
from repro_torch.runtime.server import Request, Server, ServerConfig

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

ARCH = "xlstm-350m"
LOGIT_TOL = 1e-4
MIXER_TOL = 1e-4
CACHE_TOL = 1e-4
KERNEL_TOL = 3e-3


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


def _leaves(cache):
    """(name, tensor) of one block's cache: the mLSTM's matrix memory, or
    the sLSTM's c, n and h."""
    return cache.items() if isinstance(cache, dict) else [("state", cache)]


def _assert_caches_close(caches, jcaches, tol):
    for group, reps in caches.items():
        for r, rep in enumerate(reps):
            for block, entry in rep.items():
                jentry = jcaches[group][block]
                for name, got in _leaves(entry):
                    want = jentry[name] if isinstance(jentry, dict) else jentry
                    np.testing.assert_allclose(got.numpy(), np.asarray(want[r]), atol=tol,
                                               rtol=tol, err_msg=f"{group}[{r}].{block}.{name}")


def test_config_and_params_match_reference(models):
    jcfg, jparams, cfg, params = models
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count() == 297_105_408
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_chunk) == (16, 64, 4, 512)
    assert xlstm._mdims(cfg) == jax_xlstm._mdims(jcfg) == (128, 4, 32)
    assert len(params["group_0"]) == 2 and "group_1" not in params
    np.testing.assert_array_equal(params["group_0"][1]["b7"]["mixer"]["r"].numpy(),
                                  np.asarray(jparams["group_0"]["b7"]["mixer"]["r"][1]))
    own = zoo.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(params)
    ref_caches = jax_transformer.init_caches(jcfg, 3, 24)
    caches = transformer.init_caches(cfg, 3, 24, "cpu")
    for j in range(8):
        want = ref_caches["group_0"][f"b{j}"]
        for name, got in _leaves(caches["group_0"][1][f"b{j}"]):
            w = want[name] if isinstance(want, dict) else want
            np.testing.assert_array_equal(got.numpy(), np.asarray(w[1]), err_msg=f"b{j}.{name}")


def test_conversion_keeps_each_leaf_dtype():
    """At the model dtype bf16 the mLSTM keeps its gates wi and wf and the
    sLSTM its w, r and b in float32, the rest in bf16, as the port's own
    init does."""
    jcfg = jax_zoo.reduce_config(jax_get_config(ARCH), dtype="bfloat16")
    jparams = jax_zoo.init_params(jax.random.PRNGKey(1), jcfg)
    params = _to_port(jparams)
    m, s = params["group_0"][0]["b0"]["mixer"], params["group_0"][0]["b7"]["mixer"]
    assert {k for k, t in m.items() if not isinstance(t, dict) and t.dtype == torch.float32} \
        == {"wi", "wf"}
    assert all(t.dtype == torch.float32 for t in s.values())
    assert m["wq"].dtype == torch.bfloat16 and m["norm"]["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m["wk"].float().numpy(),
        np.asarray(jparams["group_0"]["b0"]["mixer"]["wk"][0], np.float32))
    own = zoo.init_params(zoo.reduce_config(get_config(ARCH), dtype="bfloat16"), device="cpu")
    dtypes = lambda t: jax.tree_util.tree_map(lambda a: str(a.dtype).split(".")[-1], t)
    assert dtypes(own) == dtypes(params)


def _mixer_params(jparams, params, block):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["group_0"][block]["mixer"])
    return jp, params["group_0"][0][block]["mixer"]


@pytest.mark.parametrize("chunk", [16, 512])
def test_mlstm_mixer_prefill_and_decode_match_reference(models, chunk):
    """Prefill output and final state, then one decode step from that
    state: ragged chunks at 16, one short chunk at the config's 512."""
    jcfg, jparams, cfg, params = models
    jcfg = dataclasses.replace(jcfg, ssm_chunk=chunk)
    cfg = dataclasses.replace(cfg, ssm_chunk=chunk)
    jp, p = _mixer_params(jparams, params, "b1")
    x = np.random.default_rng(chunk).standard_normal((2, 41, cfg.d_model)).astype(np.float32)
    tol = dict(atol=MIXER_TOL, rtol=MIXER_TOL)
    jy, jstate = jax_xlstm.mlstm_mixer(jnp.asarray(x[:, :40]), jp, jcfg, return_state=True)
    y, state = xlstm.mlstm_mixer(torch.from_numpy(x[:, :40]), p, cfg, return_state=True)
    assert state.shape == (2, 4, 32, 33)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **tol)
    jy, jstate = jax_xlstm.mlstm_mixer(jnp.asarray(x[:, 40:]), jp, jcfg, state=jstate)
    y, state = xlstm.mlstm_mixer(torch.from_numpy(x[:, 40:]), p, cfg, state=state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **tol)


def test_slstm_mixer_prefill_and_decode_match_reference(models):
    """The recurrence over 40 steps from the initial state, its final
    {c, n, h}, then one decode step from them."""
    jcfg, jparams, cfg, params = models
    jp, p = _mixer_params(jparams, params, "b7")
    x = np.random.default_rng(7).standard_normal((2, 41, cfg.d_model)).astype(np.float32)
    tol = dict(atol=MIXER_TOL, rtol=MIXER_TOL)
    jy, jstate = jax_xlstm.slstm_mixer(jnp.asarray(x[:, :40]), jp, jcfg, return_state=True)
    y, state = xlstm.slstm_mixer(torch.from_numpy(x[:, :40]), p, cfg, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    for name in ("c", "n", "h"):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), **tol)
    assert xlstm.slstm_mixer(torch.from_numpy(x[:, :40]), p, cfg)[1] is None
    jy, jstate = jax_xlstm.slstm_mixer(jnp.asarray(x[:, 40:]), jp, jcfg, state=jstate)
    y, state = xlstm.slstm_mixer(torch.from_numpy(x[:, 40:]), p, cfg, state=state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    for name in ("c", "n", "h"):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), **tol)


@pytest.fixture(scope="module")
def bf16_models():
    """The reduced config at the model dtype bf16: (reference config,
    reference params, port config, port params)."""
    jcfg = jax_zoo.reduce_config(jax_get_config(ARCH), dtype="bfloat16")
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, zoo.reduce_config(get_config(ARCH), dtype="bfloat16"), \
        _to_port(jparams)


def _np32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _rel(got, want):
    """Largest |got - want| over the largest |want|."""
    got, want = _np32(got), _np32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_norm(got, want):
    """||got - want|| / ||want||."""
    got, want = _np32(got), _np32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("block", ["b1", "b7"])
def test_bf16_mixers_match_reference_through_decode(bf16_models, block):
    """Each mixer in bf16, prefilling 300 tokens and then 31 decode steps
    from its state, on the same bf16 inputs as the reference's: the state
    (float32 in both) within 2e-4 in norm, ||got - want|| / ||want||, after
    the prefill and after every step (measured up to 4.4e-5 for the mLSTM,
    where a bf16 projection now and then rounds one way in torch and the
    other in XLA; 1.4e-7 for the sLSTM), so that a state or gate kept in
    the wrong dtype, which float32 tests cannot see, fails: the mLSTM's
    state rounded to bf16 each step gives 9.7e-4, its gate weights 6.3e-4,
    the sLSTM's c 1.1e-3, and dividing k by sqrt(P) unrounded 4.8e-4. The
    bf16 output within 2e-2 of its largest entry (a few bf16 ULP: the
    reference's bf16 sigmoid rounds differently from torch's, about a
    third of the mLSTM's output gates by one ULP)."""
    jcfg, jparams, cfg, params = bf16_models
    jp, p = _mixer_params(jparams, params, block)
    jmix, mix = (jax_xlstm.mlstm_mixer, xlstm.mlstm_mixer) if block == "b1" \
        else (jax_xlstm.slstm_mixer, xlstm.slstm_mixer)
    x = np.random.default_rng(3).standard_normal((2, 331, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    states = lambda s: s.items() if isinstance(s, dict) else [("state", s)]

    def check(jy, jstate, y, state, what):
        assert y.dtype == torch.bfloat16
        assert _rel(y.float(), jy.astype(jnp.float32)) <= 2e-2, what
        for (name, got), (_, want) in zip(states(state), states(jstate)):
            assert got.dtype == torch.float32, (what, name)
            assert _rel_norm(got, want) <= 2e-4, (what, name, _rel_norm(got, want))

    jy, jstate = jmix(xj[:, :300], jp, jcfg, return_state=True)
    y, state = mix(xt[:, :300], p, cfg, return_state=True)
    check(jy, jstate, y, state, "prefill")
    for t in range(300, 331):
        jy, jstate = jmix(xj[:, t:t + 1], jp, jcfg, state=jstate)
        y, state = mix(xt[:, t:t + 1], p, cfg, state=state)
        check(jy, jstate, y, state, f"decode step {t - 299}")


def _model_drift(prefill, decode, params, cfg, toks, plen, leaves, steps):
    """Decode from a prefill of toks[:, :plen], teacher-forced on the rest,
    against a fresh prefill over the same tokens after each step in
    ``steps``: per kind of cache entry ("logits", "mlstm", "c", "n", "h"),
    the mean over layers and steps of ||decode - fresh|| / ||fresh||."""
    max_len = toks.shape[1]
    logits, caches = prefill(params, cfg, toks[:, :plen], max_len)
    drift = {}
    for n in range(1, max(steps) + 1):
        logits, caches = decode(params, cfg, caches, toks[:, plen + n - 1:plen + n],
                                plen + n - 1)
        if n not in steps:
            continue
        fresh_logits, fresh = prefill(params, cfg, toks[:, :plen + n], max_len)
        pairs = [("logits", logits, fresh_logits)]
        pairs += [(k[-1], v, leaves(fresh)[k]) for k, v in leaves(caches).items()]
        for name, got, want in pairs:
            got, want = _np32(got), _np32(want)
            drift.setdefault(name, []).append(np.linalg.norm(got - want) / np.linalg.norm(want))
    return {name: float(np.mean(v)) for name, v in drift.items()}


def test_bf16_decode_drifts_from_fresh_prefill_as_the_reference_does(bf16_models):
    """The reduced model in bf16 (16 blocks), 4 prompts of 600 tokens (two
    chunks, the second ragged), then 31 teacher-forced decode steps, in the
    port and in the reference: each one's decode against its own fresh
    prefill after steps 1, 4, 8, 16, 24 and 31. In bf16 the batched prefill
    and the one-token decode round differently (in both packages), and the
    difference grows with the step; the port's mean drift of each kind
    stays within 2x the reference's (0.93-1.01x here, 0.84-1.68x over nine
    seeds and two prompt lengths; the mLSTM's state rounded to bf16 each
    step gives 1.9-3.0x, so the mixer test above is the one that pins the
    dtypes)."""
    jcfg, jparams, cfg, params = bf16_models
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 631)).astype(np.int32)
    steps = (1, 4, 8, 16, 24, 31)

    def jleaves(caches):
        return {(g, r, blk, name): t[r] for g, blocks in caches.items()
                for blk, e in blocks.items() for name, t in _leaves(e)
                for r in range(t.shape[0])}

    def leaves(caches):
        return {(g, r, blk, name): t.float() for g, reps in caches.items()
                for r, rep in enumerate(reps) for blk, e in rep.items()
                for name, t in _leaves(e)}

    jdecode = jax.jit(jax_transformer.decode_step, static_argnums=1)
    want = _model_drift(lambda p, c, tk, ml: jax_transformer.prefill(p, c, jnp.asarray(tk), ml),
                        lambda p, c, caches, tk, cl: jdecode(p, c, caches, jnp.asarray(tk),
                                                             jnp.int32(cl)),
                        jparams, jcfg, toks, 600, jleaves, steps)
    got = _model_drift(
        lambda p, c, tk, ml: transformer.prefill(p, c, torch.as_tensor(tk, dtype=torch.int64),
                                                 ml),
        lambda p, c, caches, tk, cl: transformer.decode_step(
            p, c, caches, torch.as_tensor(tk, dtype=torch.int64), cl),
        params, cfg, toks, 600, leaves, steps)
    assert set(got) == set(want) == {"logits", "state", "c", "n", "h"}
    for name in want:
        assert 0 < want[name] and got[name] <= 2 * want[name], (name, got, want)


@pytest.mark.parametrize("bh,s,p,n,chunk", [(2, 300, 97, 96, 256), (3, 70, 33, 32, 512)])
def test_plain_scan_matches_reference_at_wide_shapes(bh, s, p, n, chunk):
    """The port's ``ssd_chunked_ref`` against the reference's at P != N,
    with a ragged last chunk (300 = 256 + 44) and with a chunk longer than
    S; the decode step from its final state against the reference's."""
    rng = np.random.default_rng(s + p)
    arrs = [rng.standard_normal((bh, s, p)).astype(np.float32),
            np.log(1 / (1 + np.exp(-rng.standard_normal((bh, s))))).astype(np.float32),
            (rng.standard_normal((bh, s, n)) / np.sqrt(n)).astype(np.float32),
            rng.standard_normal((bh, s, n)).astype(np.float32)]
    want_y, want_s = jax_ssd_ref.ssd_chunked_ref(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    y, st = ssd_ref.ssd_chunked_ref(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    tol = dict(atol=KERNEL_TOL, rtol=KERNEL_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **tol)
    step = [a[:, 0] for a in arrs]
    jy, js = jax_ssd_ref.ssd_decode_step(want_s, *(jnp.asarray(a) for a in step))
    y1, s1 = ssd_ref.ssd_decode_step(st, *(torch.from_numpy(a) for a in step))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), **tol)


def test_prefill_and_teacher_forced_decode_match_reference(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    max_len = 24
    jlogits, jcaches = jax_transformer.prefill(jparams, jcfg, jnp.asarray(toks), max_len)
    logits, caches = transformer.prefill(params, cfg, torch.as_tensor(toks, dtype=torch.int64),
                                         max_len)
    _assert_logits_close(logits, jlogits, "prefill")
    _assert_caches_close(caches, jcaches, CACHE_TOL)
    cache_len = toks.shape[1]
    for step in range(4):
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]   # the reference's token
        jlogits, jcaches = jax_transformer.decode_step(jparams, jcfg, jcaches,
                                                       jnp.asarray(tok), jnp.int32(cache_len))
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 torch.as_tensor(tok, dtype=torch.int64),
                                                 cache_len)
        _assert_logits_close(logits, jlogits, f"decode step {step}")
        cache_len += 1
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
    mask: the recurrent states run over the pads in both) and budgets over
    two waves of three slots: the same tokens as the reference server, and
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
    before = ssd_ops.LAUNCHES, ssd_wide.LAUNCHES
    want = ref.serve([JaxRequest(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    got = srv.serve([Request(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    assert (ssd_ops.LAUNCHES, ssd_wide.LAUNCHES) == before   # the CPU runs the plain version
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


def test_wide_route_refuses_what_it_cannot_hold():
    """On the card a shape beyond the first route goes to the wide one; a
    chunk above 512, or P or N above 1,024, is refused before any launch."""
    x = torch.zeros(1, 1, 600, 8)
    loga, bc = torch.zeros(1, 1, 600), torch.zeros(1, 1, 600, 8)
    with pytest.raises(ValueError, match="chunk 600"):
        ssd_ops._run(x, loga, bc, bc, 600, torch.empty(1, 1, 600, 8))
    wide_p = torch.zeros(1, 1, 16, 1025)
    with pytest.raises(ValueError, match="P=1025"):
        ssd_ops._run(wide_p, torch.zeros(1, 1, 16), torch.zeros(1, 1, 16, 8),
                     torch.zeros(1, 1, 16, 8), 16, torch.empty(1, 1, 16, 1025))


def test_aligned_values_give_the_same_prefill_and_decode(models, monkeypatch):
    """The mixer's values with the normaliser column on rows padded to 16
    bytes (``xlstm.values_ext``) equal ``cat([v, 1]) * i``, the layout the
    mixer built before, bit for bit, and so do a prefill and a decode step
    through either."""
    _, _, cfg, params = models
    p = params["group_0"][0]["b0"]["mixer"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    v = torch.randn(2, 21, 4, 32, generator=torch.Generator().manual_seed(1))
    i_gate = torch.rand(2, 21, 4, generator=torch.Generator().manual_seed(2))
    ext = xlstm.values_ext(v, i_gate)
    assert ssd_wide.is_aligned(ext) and ext.shape == (2, 21, 4, 33)
    assert torch.equal(ext, torch.cat([v, torch.ones(2, 21, 4, 1)], dim=-1) * i_gate[..., None])
    runs = []
    for layout in ("aligned", "cat"):
        if layout == "cat":
            monkeypatch.setattr(xlstm, "values_ext", lambda v, i: torch.cat(
                [v.float(), torch.ones(*v.shape[:3], 1)], dim=-1) * i[..., None])
        y, state = xlstm.mlstm_mixer(x, p, cfg, return_state=True)
        y1, state1 = xlstm.mlstm_mixer(x[:, :1], p, cfg, state=state)
        runs.append((y, state, y1, state1))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_aligned_copies_keep_values_and_put_rows_on_16_bytes():
    """``wide.aligned`` returns a tensor whose rows start on 16 bytes as it
    is, and copies any other into rows padded to a multiple of 4 floats."""
    base = torch.arange(2 * 5 * 3 * 16, dtype=torch.float32).reshape(2, 5, 3, 16)
    odd = torch.arange(2 * 5 * 3 * 7, dtype=torch.float32).reshape(2, 5, 3, 7)
    for t, copied in [(base[..., :13], False), (base[..., :13].transpose(1, 2), False),
                      (base[..., 1:14], True), (odd, True), (odd.transpose(1, 2), True)]:
        out = ssd_wide.aligned(t)
        assert ssd_wide.is_aligned(out) and torch.equal(out, t)
        assert (out.data_ptr() != t.data_ptr()) == copied


# --- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


# (B, H, S, P, N, chunk): the xLSTM's prefill wave (the traffic's longest
# prompt, 1,819, and 2,048), a ragged S, nine chunks
WIDE_MLSTM_CASES = [(4, 4, 1819, 513, 512, 512), (4, 4, 2048, 513, 512, 512),
                    (4, 4, 1100, 513, 512, 512), (2, 4, 4608, 513, 512, 512)]
# (BH, S, P, N, chunk): the reference's kernel test cases (tests/test_kernels.py)
REF_CASES = [(2, 64, 16, 8, 32), (4, 128, 32, 16, 32), (1, 200, 64, 32, 32),
             (3, 96, 8, 64, 32)] + [(2, 128, 16, 8, q) for q in (16, 64, 128)]


def _wide_vs_plain(xdt, loga, b, c, chunk, y=None):
    """The wide route on the card (``ops._run_wide``, so that shapes the
    first route holds go through it too) with its chunk-state scratch
    NaN-filled, against the plain route on the same tensors: y, the final
    state and the state after each chunk (``ref.ssd_chunk_state_ref`` on B
    and C expanded to every head). y is written into the given view, else
    into one of a (B, S, H, P) tensor. Returns the launches it counted."""
    bsz, h, s, p = xdt.shape
    g, n = b.shape[1], b.shape[-1]
    q = min(chunk, s)
    if y is None:
        y = torch.empty(bsz, s, h, p, device="cuda").transpose(1, 2)
    states = torch.full((bsz, h, -(-s // q), n, p), float("nan"), device="cuda")
    before = ssd_wide.LAUNCHES
    out, st = ssd_ops._run_wide(xdt, loga, b, c, q, y, states)
    torch.cuda.synchronize()
    assert out is y
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want_y, want_s = ssd_ops._plain(xdt, loga, b, c, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    torch.testing.assert_close(st, want_s, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    rep = lambda t: t.repeat_interleave(h // g, dim=1).reshape(bsz * h, s, n)
    _, _, want = ssd_ref.ssd_chunk_state_ref(xdt.reshape(bsz * h, s, p),
                                             loga.reshape(bsz * h, s), rep(b), rep(c), chunk)
    torch.testing.assert_close(states.reshape(want.shape), want, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    return ssd_wide.LAUNCHES - before


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,h,s,p,n,chunk", WIDE_MLSTM_CASES)
def test_wide_route_matches_plain_version_at_mlstm_shapes_on_the_card(bsz, h, s, p, n, chunk):
    """K3's wide route at the xLSTM's scan shape, inputs at the mLSTM's
    scale (k / sqrt(512), xdt = [v ‖ 1] i, log f = log sigmoid(N(0, 1)),
    so that exp(cum) underflows within a chunk), in the mixer's strided
    layout; ``ssd_scan_heads`` picks it by shape."""
    _card()
    from repro_torch.kernels.ssm_scan import bench

    args = bench.mlstm_inputs(torch, bsz, h, s, p, n, seed=s)
    assert _wide_vs_plain(*args, chunk) == 1
    before = ssd_ops.LAUNCHES, ssd_wide.LAUNCHES
    ssd_ops.ssd_scan_heads(*args, chunk=chunk)
    assert (ssd_ops.LAUNCHES, ssd_wide.LAUNCHES) == (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,p,n,chunk", REF_CASES)
def test_wide_route_matches_plain_version_at_reference_cases_on_the_card(bh, s, p, n, chunk):
    """The reference's kernel test cases forced through the wide route (3-D
    form: one group per row)."""
    _card()
    rng = np.random.default_rng(s + chunk)
    cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    xdt = cuda(rng.standard_normal((1, bh, s, p)))
    loga = cuda(-np.logaddexp(0, rng.standard_normal((1, bh, s))))
    b, c = cuda(rng.standard_normal((1, bh, s, n))), cuda(rng.standard_normal((1, bh, s, n)))
    assert _wide_vs_plain(xdt, loga, b, c, chunk) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,h,g,s,p,n,chunk", [
    (1, 2, 2, 700, 100, 36, 256),        # P and N not multiples of 8 or of the tile
    (1, 1, 1, 600, 1024, 1024, 512),     # the largest P and N
    (2, 8, 2, 600, 64, 128, 256),        # four heads a group: a Mamba2 shape (N 128)
    (1, 2, 2, 300, 513, 512, 512)])      # S shorter than the chunk
def test_wide_route_matches_plain_version_at_other_shapes_on_the_card(bsz, h, g, s, p, n,
                                                                      chunk):
    """The wide route at shapes it takes beside the mLSTM's, picked by
    ``ops._run`` from the shape, with the mixer's decay and distinct B and C
    per group, so that a kernel reading another head's group fails."""
    _card()
    from repro_torch.kernels.ssm_scan import bench

    args = bench.heads_inputs(torch, bsz, h, g, s, p, n, seed=s + p)
    assert _wide_vs_plain(*args, chunk) == 1
    before = ssd_ops.LAUNCHES, ssd_wide.LAUNCHES
    ssd_ops.ssd_scan_heads(*args, chunk=chunk)
    assert (ssd_ops.LAUNCHES, ssd_wide.LAUNCHES) == (before[0], before[1] + 1)


@pytest.mark.cuda
def test_wide_route_copies_unaligned_rows_on_the_card():
    """Rows that do not start on 16 bytes (xdt, b and c sliced one float in
    from wider tensors, y a view of such rows) go through ``ops._run``'s
    aligned copies; y is written into the view the caller gave."""
    _card()
    from repro_torch.kernels.ssm_scan import bench

    bsz, h, g, s, p, n, chunk = 2, 3, 3, 300, 70, 68, 128
    x, loga, b, c = bench.heads_inputs(torch, bsz, h, g, s, p + 1, n + 1, seed=5)
    xdt, b, c = x[..., 1:], b[..., 1:], c[..., 1:]
    y = torch.empty(bsz, s, h, p + 1, device="cuda").transpose(1, 2)[..., 1:]
    assert not any(ssd_wide.is_aligned(t) for t in (xdt, b, c, y))
    assert _wide_vs_plain(xdt, loga, b, c, chunk, y=y) == 1


def _chunked_float64(xdt, loga, b, c, chunk):
    """``ssd_chunked_ref``'s function in float64: (y, final state)."""
    bh, s, p = xdt.shape
    q = min(chunk, s)
    pad = lambda t: torch.nn.functional.pad(t.double(), (0, 0) * (t.dim() - 2) + (0, (-s) % q))
    x, la, bb, cc = pad(xdt), pad(loga), pad(b), pad(c)
    state = torch.zeros(bh, b.shape[-1], p, dtype=torch.float64, device=xdt.device)
    lower = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    ys = []
    for k in range(x.shape[1] // q):
        sl = slice(k * q, (k + 1) * q)
        cum = torch.cumsum(la[:, sl], dim=-1)
        decay = torch.where(lower, torch.exp(cum[:, :, None] - cum[:, None, :]),
                            torch.zeros((), dtype=torch.float64, device=xdt.device))
        ys.append(torch.einsum("zqk,zkp->zqp", torch.einsum("zqn,zkn->zqk", cc[:, sl], bb[:, sl])
                               * decay, x[:, sl])
                  + torch.einsum("zqn,znp->zqp", cc[:, sl] * torch.exp(cum)[..., None], state))
        state = torch.exp(cum[:, -1])[:, None, None] * state + torch.einsum(
            "zqn,zqp->znp", bb[:, sl] * torch.exp(cum[:, -1:, None] - cum[..., None]), x[:, sl])
    return torch.cat(ys, dim=1)[:, :s], state


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1819, 1850])
def test_wide_route_holds_a_float64_reference_on_the_card(s):
    """At the mLSTM's scan (the xLSTM's prefill wave, and that wave 31
    tokens later, as a fresh prefill in the decode check sees it) the
    route's final state is within 3e-6 and y within 1e-5 of a float64
    reference, relative to each tensor's largest entry: cum near -400 is
    summed in float64, so the decays carry no float32 rounding of cum (a
    float32 cum put the state 1.5e-5 off, and the bf16 model's decode past
    its bound from a fresh prefill)."""
    _card()
    from repro_torch.kernels.ssm_scan import bench

    args = bench.mlstm_inputs(torch, 4, 4, s, 513, 512, seed=s)
    y, st = ssd_ops.ssd_scan_heads(*args, chunk=512)
    flat = lambda t: t.reshape(16, s, -1)
    want_y, want_s = _chunked_float64(flat(args[0]), args[1].reshape(16, s), flat(args[2]),
                                      flat(args[3]), 512)
    rel = lambda got, want: ((got.double() - want).abs().max() / want.abs().max()).item()
    assert rel(st.reshape(want_s.shape), want_s) <= 3e-6
    assert rel(y.reshape(want_y.shape), want_y) <= 1e-5


@pytest.mark.cuda
def test_wide_route_chunk_states_match_plain_phases_on_the_card():
    """The state after each chunk that the wide route's state kernel chains
    (its ``states`` scratch, NaN-filled first) against the plain version of
    that phase, ``ref.ssd_chunk_state_ref``, at nine chunks of the mLSTM's
    scan."""
    _card()
    from repro_torch.kernels.ssm_scan import bench

    bsz, h, s, p, n, chunk = 1, 4, 4608, 513, 512, 512
    args = bench.mlstm_inputs(torch, bsz, h, s, p, n, seed=1)
    y = torch.empty(bsz, s, h, p, device="cuda").transpose(1, 2)
    states = torch.full((bsz, h, s // chunk, n, p), float("nan"), device="cuda")
    ssd_ops._run(*args, chunk, y, states=states)
    torch.cuda.synchronize()
    flat = lambda t: t.reshape(bsz * h, s, -1)
    _, _, want = ssd_ref.ssd_chunk_state_ref(flat(args[0]), args[1].reshape(bsz * h, s),
                                             flat(args[2]), flat(args[3]), chunk)
    torch.testing.assert_close(states.reshape(want.shape), want, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.cuda
def test_mlstm_mixer_on_the_card_matches_its_plain_route(monkeypatch):
    """One mLSTM mixer at xlstm-350m's width (4 heads, P 512 + 1, N 512,
    chunk 512) in float32 on the card, prefilling 2 x 700 tokens: the scan
    runs once through the wide route; the same mixer with the scan's plain
    route gives the output and the state within 3e-3 of each tensor's
    largest entry."""
    _card()
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = xlstm.init_mlstm(gen, cfg, torch.float32, "cuda")
    x = torch.randn(2, 700, cfg.d_model, generator=gen, device="cuda")
    before = ssd_wide.LAUNCHES
    y, state = xlstm.mlstm_mixer(x, p, cfg, return_state=True)
    torch.cuda.synchronize()
    assert ssd_wide.LAUNCHES == before + 1
    monkeypatch.setattr(xlstm, "ssd_scan_heads", ssd_ops._plain)
    want_y, want_state = xlstm.mlstm_mixer(x, p, cfg, return_state=True)
    assert ssd_wide.LAUNCHES == before + 1
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    assert rel(y, want_y) <= 3e-3 and rel(state, want_state) <= 3e-3


@pytest.mark.cuda
def test_full_width_float32_decode_matches_fresh_prefill_on_the_card():
    """xlstm-350m at full width and depth in float32 on the card (the wide
    route in 21 prefill layers): after 1, 16 and 31 teacher-forced decode
    steps (``chip_smoke.py``'s KV_CHECK_STEPS) the logits, every mLSTM state
    and every sLSTM c, n and h equal those of a fresh prefill over the same
    tokens, within 1e-3 of each tensor's largest entry, so that the drift
    the bf16 model shows over those steps is rounding."""
    _card()
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = zoo.init_params(cfg, seed=0)
    rng = np.random.default_rng(13)
    plen, checks, max_len = 700, (1, 16, 31), 1024
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, plen + max(checks))),
                           device="cuda")
    before = ssd_wide.LAUNCHES
    logits, caches = transformer.prefill(params, cfg, toks[:, :plen], max_len)
    assert ssd_wide.LAUNCHES == before + 21
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    worst = {}
    for n in range(1, max(checks) + 1):
        logits, caches = transformer.decode_step(params, cfg, caches,
                                                 toks[:, plen + n - 1:plen + n], plen + n - 1)
        if n not in checks:
            continue
        fresh_logits, fresh = transformer.prefill(params, cfg, toks[:, :plen + n], max_len)
        step = {"logits": rel(logits, fresh_logits)}
        for group, reps in fresh.items():
            for r, rep in enumerate(reps):
                for block, entry in rep.items():
                    for name, want in _leaves(entry):
                        got = dict(_leaves(caches[group][r][block]))[name]
                        step[name] = max(step.get(name, 0.0), rel(got, want))
        print(f"float32 xlstm-350m, decode step {n} vs fresh prefill, of the largest entry: "
              f"{step}")
        for name, v in step.items():
            worst[name] = max(worst.get(name, 0.0), v)
    assert set(worst) == {"logits", "state", "c", "n", "h"}
    assert all(v <= 1e-3 for v in worst.values()), worst
