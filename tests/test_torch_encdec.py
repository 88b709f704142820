"""Encoder-decoder models and front ends in the PyTorch port against the JAX
reference: seamless-m4t-large-v2 (``models/encdec.py``) reduced (2 + 2
layers, d 64, float32) from one converted parameter tree, with inputs from
numpy seeds; ``vq_token_stream``; chameleon-34b's and llama3-405b's
reduced servers.

Tolerances:
- the encoder's output, the prefill's caches and every logit within 1e-4
  of the largest magnitude (``test_torch_lm.py``'s ``LOGIT_TOL``): both
  sides run the same float32 formulas, summing products in other orders;
  a wrong mask, rope phase or cache slot moves them by tens of percent;
- ``forward_loss`` and every gradient at ``test_torch_train.py``'s
  ``LOSS_RTOL``, ``GRAD_TOL``; ``Trainer`` steps at
  ``test_torch_trainer.py``'s ``STEP_RTOL``, ``PARAM_TOL``, ``MOMENT_TOL``;
- on the card, K2 at ``FLASH_TOL`` of the plain version (the reference's
  kernel tolerances) and, without the mask, also at ``bench.SCALED_TOL`` of
  the outputs' scale.

JAX is imported inside the CPU tests only, so that the card tests run in a
process where it never starts.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_reference, opt_state_from_reference
from repro_torch.kernels.flash_attention import bench as fa_bench
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import encdec, frontend, zoo
from repro_torch.optim.optimizers import leaves
from repro_torch.runtime.server import Request, Server, ServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4                                  # of the largest magnitude
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4            # tests/test_torch_train.py
STEP_RTOL, PARAM_TOL, MOMENT_TOL = 1e-5, 1e-5, 1e-4     # tests/test_torch_trainer.py
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
FULL_PARAMS = 2_034_761_728                 # seamless-m4t-large-v2's param_count()


def _numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what="", tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (what, np.abs(got - want).max(), bound)


@pytest.fixture(scope="module")
def models():
    """(reference config, reference params, port config, port params)."""
    import jax

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo

    jcfg = jax_get_reduced(ARCH)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_reduced(ARCH), lm_params_from_reference(_numpy(jparams), "cpu")


def _frames(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_and_parameters_match_reference(models):
    """Both configs and their reduced forms equal the reference's, with its
    parameter counts; the port's own tree has the reference's shapes (each
    stacked layer one list entry); the converted tree is the reference's
    bit for bit."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo

    jcfg, jparams, cfg, params = models
    for arch in (ARCH, "chameleon-34b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jax_get_reduced(arch))
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    assert get_config(ARCH).param_count() == FULL_PARAMS
    assert (cfg.enc_layers, cfg.dec_layers, cfg.num_layers) == (2, 2, 4)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    own = zoo.init_params(cfg, seed=0, device="cpu")
    assert shapes(own) == shapes(params)
    want = jax.eval_shape(lambda: jax_zoo.init_params(jax.random.PRNGKey(0), jcfg))
    assert len(params["enc"]) == len(params["dec"]) == 2
    for stack in ("enc", "dec"):
        for i in range(2):
            assert shapes(params[stack][i]) == jax.tree_util.tree_map(
                lambda a: tuple(a.shape[1:]), want[stack])
    np.testing.assert_array_equal(params["dec"][1]["cross_attn"]["wk"].numpy(),
                                  np.asarray(jparams["dec"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(params["enc_norm"]["scale"].numpy(),
                                  np.asarray(jparams["enc_norm"]["scale"]))


@pytest.mark.parametrize("s_src", [6, 300])
def test_encode_matches_reference(models, s_src):
    """The bidirectional encoder, at 6 frames and at a ragged 300: K2's
    non-causal route refuses 300 keys in both packages' kernel wrappers (the
    reference's key tile is 256), but the reference's default route and the
    port's model layers (``ops.attend``) take every length."""
    from repro.models import encdec as jax_encdec

    jcfg, jparams, cfg, params = models
    frames = _frames(2, s_src, cfg.d_model, seed=s_src)
    want = jax_encdec.encode(jparams, jcfg, frames)
    got = encdec.encode(params, cfg, torch.from_numpy(frames))
    _close(got, want, f"encode at {s_src}")
    if s_src > fa_ops.REF_BLOCK_K:
        q = torch.zeros(1, 1, s_src, 16)
        with pytest.raises(ValueError, match="non-causal"):
            fa_ops.flash_attention(q, q, q, causal=False)


def _reference_prefill(models, frames, toks, max_len):
    from repro.models import zoo as jax_zoo
    jcfg, jparams, _, _ = models
    return jax_zoo.prefill_fn(jcfg, max_len)(jparams, {"frames": frames, "tokens": toks})


def test_prefill_logits_and_caches_match_reference(models):
    jcfg, jparams, cfg, params = models
    frames, toks, max_len = _frames(3, 7, cfg.d_model, 1), _tokens(3, 9, cfg.vocab_size, 2), 16
    jlogits, jcaches = _reference_prefill(models, frames, toks, max_len)
    logits, caches = zoo.prefill_fn(cfg, max_len)(
        params, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks).long()})
    _close(logits, jlogits, "prefill logits")
    assert len(caches) == cfg.dec_layers
    for i, layer in enumerate(caches):
        for kind in ("self", "cross"):
            for name in ("k", "v"):
                _close(layer[kind][name], np.asarray(jcaches[kind][name][i]), (i, kind, name))
        assert tuple(layer["cross"]["k"].shape) == (3, cfg.num_kv_heads, 7, 16)
        assert not layer["self"]["k"][:, :, 9:].any()          # past the prompt: untouched


def test_decode_steps_match_reference(models):
    """Three teacher-forced decode steps (the reference's argmax fed to
    both): logits and self caches within the tolerance; the cross caches
    unchanged from the prefill's, bit for bit."""
    import jax.numpy as jnp

    from repro.models import zoo as jax_zoo

    jcfg, jparams, cfg, params = models
    frames, toks, max_len = _frames(2, 11, cfg.d_model, 3), _tokens(2, 5, cfg.vocab_size, 4), 12
    jlogits, jcaches = _reference_prefill(models, frames, toks, max_len)
    logits, caches = zoo.prefill_fn(cfg, max_len)(
        params, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks).long()})
    cross = [{n: t.clone() for n, t in layer["cross"].items()} for layer in caches]
    for step in range(3):
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
        cache_len = toks.shape[1] + step
        jlogits, jcaches = jax_zoo.decode_fn(jcfg)(jparams, jcaches, jnp.asarray(tok),
                                                   jnp.int32(cache_len))
        logits, caches = zoo.decode_fn(cfg)(params, caches, torch.from_numpy(tok).long(),
                                            cache_len)
        _close(logits, jlogits, f"decode step {step}")
    for i, layer in enumerate(caches):
        for name in ("k", "v"):
            _close(layer["self"][name], np.asarray(jcaches["self"][name][i]), (i, name))
            assert torch.equal(layer["cross"][name], cross[i][name])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_loss_and_gradients_match_reference(models, remat):
    """The loss and the gradient of every leaf, without and with per-block
    checkpointing (the port's ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import zoo as jax_zoo

    jcfg, jparams, cfg, _ = models
    jcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, cfg))
    frames, toks = _frames(2, 9, cfg.d_model, 5), _tokens(2, 6, cfg.vocab_size, 6)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_zoo.loss_fn(jcfg)))(
        jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
                  "labels": jnp.asarray(labels)})
    params = lm_params_from_reference(_numpy(jparams), "cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = zoo.loss_fn(cfg)(params, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks).long(),
                                     "labels": torch.from_numpy(labels).long()})
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    got = {path: g for (path, _), g in zip(flatten(params), grads)}
    want = dict(flatten(lm_params_from_reference(_numpy(jgrads), "cpu")))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), path


def test_trainer_with_frames_matches_reference_from_one_state(tmp_path):
    """Three ``Trainer`` steps from one converted state: the frames branch
    (numpy's ``default_rng(step)``, bit-equal in both) and float32 frames
    beside int64 tokens."""
    import jax

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo
    from repro.optim.optimizers import AdamWConfig as JaxAdamWConfig
    from repro.optim.optimizers import init_opt_state as jax_init_opt_state
    from repro.runtime.trainer import Trainer as JaxTrainer
    from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig

    jcfg = jax_get_reduced(ARCH)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jax_init_opt_state(jparams, JaxAdamWConfig(moment_dtype=jcfg.opt_state_dtype))
    start = {"params": _numpy(jparams), "opt": _numpy(jopt)}
    kw = dict(steps=3, batch=2, seq_len=12, ckpt_every=100)
    jout = JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **kw)).run(
        start_state={"params": jparams, "opt": jopt})
    trainer = Trainer(get_reduced(ARCH), TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                      device="cpu")
    seen = []
    step_fn = trainer.step_fn
    trainer.step_fn = lambda p, o, batch, step: (seen.append(batch), step_fn(p, o, batch, step))[1]
    out = trainer.run(start_state={"params": lm_params_from_reference(start["params"], "cpu"),
                                   "opt": opt_state_from_reference(start["opt"], "cpu")})
    assert [sorted(b) for b in seen] == [["frames", "labels", "tokens"]] * 3
    assert seen[0]["frames"].dtype == torch.float32 and seen[0]["tokens"].dtype == torch.int64
    assert tuple(seen[2]["frames"].shape) == (2, 6, 64)
    np.testing.assert_array_equal(seen[2]["frames"].numpy(), np.random.default_rng(2).normal(
        size=(2, 6, 64)).astype(np.float32))
    for got, want in zip(out["metrics"], jout["metrics"]):
        assert got["lr"] == want["lr"]
        for k in ("loss", "gnorm"):
            assert abs(got[k] - want[k]) <= STEP_RTOL * abs(want[k]), (got, want)
    jstate = _numpy(jout["state"])
    for name, tree, tol in (("params", lm_params_from_reference(jstate["params"], "cpu"),
                             PARAM_TOL),
                            ("opt", opt_state_from_reference(jstate["opt"], "cpu"), MOMENT_TOL)):
        want, got = dict(flatten(tree)), dict(flatten(out["state"][name]))
        assert got.keys() == want.keys()
        for path, g in got.items():
            w = want[path].float().numpy()
            assert np.abs(g.detach().float().numpy() - w).max() <= tol * np.abs(w).max(), \
                (name, path)


def test_decode_matches_two_phase_prefill():
    """The reference's invariant (``tests/test_moe_encdec.py``, there within
    2e-2) on the port: prefill(t0..tn-1) + decode(tn) gives
    prefill(t0..tn)'s last logits, here within 1e-4 (float32)."""
    cfg = get_reduced(ARCH)
    params = zoo.init_params(cfg, seed=7, device="cpu")
    frames = torch.from_numpy(_frames(2, 6, cfg.d_model, 7))
    toks = torch.from_numpy(_tokens(2, 10, cfg.vocab_size, 8)).long()
    full, _ = zoo.prefill_fn(cfg, 14)(params, {"frames": frames, "tokens": toks})
    _, caches = zoo.prefill_fn(cfg, 14)(params, {"frames": frames, "tokens": toks[:, :-1]})
    step, _ = zoo.decode_fn(cfg)(params, caches, toks[:, -1:], 9)
    _close(step, full.numpy(), "decode against a two-phase prefill")


def test_encoder_is_bidirectional():
    """The reference's invariant on the port: flipping a late source frame
    changes the early encoder outputs."""
    cfg = get_reduced(ARCH)
    params = zoo.init_params(cfg, seed=8, device="cpu")
    frames = torch.from_numpy(_frames(1, 8, cfg.d_model, 9))
    flipped = frames.clone()
    flipped[0, -1] = -flipped[0, -1]
    out1, out2 = encdec.encode(params, cfg, frames), encdec.encode(params, cfg, flipped)
    assert float((out1[0, 0] - out2[0, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("seed,batch,seq,vocab,frac", [(3, 2, 37, 65536, 0.5),
                                                      (11, 4, 64, 65536, 0.25),
                                                      (0, 1, 9, 9000, 1.0)])
def test_vq_token_stream_is_bit_equal_to_reference(seed, batch, seq, vocab, frac):
    import jax

    from repro.models import frontend as jax_frontend

    want = np.asarray(jax_frontend.vq_token_stream(jax.random.PRNGKey(seed), batch, seq, vocab,
                                                   image_frac=frac))
    got = frontend.vq_token_stream(prng.PRNGKey(seed), batch, seq, vocab, image_frac=frac,
                                   device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    n_img = int(seq * frac)
    assert (got[:, :n_img] >= vocab - frontend.VQ_CODEBOOK).all()
    assert (got[:, n_img:] < vocab - frontend.VQ_CODEBOOK).all()


def test_audio_frames_and_frontend_kind():
    a = frontend.audio_frames(5, 2, 7, 16, device="cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, 7, 16)
    assert torch.equal(a, frontend.audio_frames(5, 2, 7, 16, device="cpu"))
    assert [frontend.frontend_kind(get_config(a)) for a in (ARCH, "chameleon-34b", "yi-6b")] \
        == ["audio", "vision", "none"]


def test_train_batch_and_server_refusal():
    """``train_batch`` lays an enc-dec batch out as the reference's (frames
    (B, S/2, d) float32, S/2 tokens, labels equal to the tokens); the LM
    ``Server`` refuses an enc-dec model, as the reference's does, and names
    the entry points that serve it."""
    cfg = get_reduced(ARCH)
    b = zoo.train_batch(cfg, 3, 14, seed=2, device="cpu")
    assert tuple(b["frames"].shape) == (3, 7, 64) and b["frames"].dtype == torch.float32
    assert tuple(b["tokens"].shape) == (3, 7) and torch.equal(b["labels"], b["tokens"])
    with pytest.raises(NotImplementedError, match="zoo.prefill_fn"):
        Server(cfg, None, ServerConfig(), device="cpu")


def _tap(server, to_numpy):
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


@pytest.mark.parametrize("arch", ["chameleon-34b", "llama3-405b"])
def test_server_matches_reference_server(arch):
    """chameleon's (qk-norm, GQA, a vision front end that changes nothing:
    its prompts are ``vq_token_stream`` ids, over a reduced vocabulary of
    16,384 so that the image codes fit) and llama3-405b's reduced servers:
    five requests over two waves of three slots, the same tokens as the
    reference's, every logit within the tolerance."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import zoo as jax_zoo
    from repro.runtime.server import Request as JaxRequest
    from repro.runtime.server import Server as JaxServer
    from repro.runtime.server import ServerConfig as JaxServerConfig

    vision = arch == "chameleon-34b"
    # chameleon's image codes take the top 8,192 ids: a vocabulary above that
    over = dict(vocab_size=2 * frontend.VQ_CODEBOOK) if vision else {}
    jcfg = jax_zoo.reduce_config(jax_get_config(arch), **over)
    cfg = zoo.reduce_config(get_config(arch), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jax_get_reduced(arch))
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_reference(_numpy(jparams), "cpu")
    lens, budgets = [5, 9, 7, 3, 11], [4, 6, 3, 5, 2]
    rng = np.random.default_rng(4)
    prompts = [frontend.vq_token_stream(prng.PRNGKey(i), 1, n, cfg.vocab_size, device="cpu")[0]
               .numpy().astype(np.int32) if vision
               else rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for i, n in enumerate(lens)]
    scfg = dict(batch_slots=3, max_len=32)
    ref = JaxServer(jcfg, jparams, JaxServerConfig(**scfg))
    srv = Server(cfg, params, ServerConfig(**scfg), device="cpu")
    ref_logits = _tap(ref, lambda t: np.asarray(t, np.float32))
    got_logits = _tap(srv, lambda t: t.numpy())
    want = ref.serve([JaxRequest(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    got = srv.serve([Request(i, p, b) for i, (p, b) in enumerate(zip(prompts, budgets))])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
    assert len(got_logits) == len(ref_logits) == 2 + (6 - 1) + (5 - 1)
    for i, (g, w) in enumerate(zip(got_logits, ref_logits)):
        _close(torch.from_numpy(g), w, f"call {i}")


# --- on the card ------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_seamless_prefill_launches_k2_in_every_attention_on_the_card():
    """The reduced seamless in bf16 on the card over a ragged 300-frame
    source: K2 launches once per encoder layer, decoder self-attention and
    cross-attention in a prefill (3 x 2 here; 72 at full depth) and never
    in a decode step; the logits are finite and within 5e-2 of the largest
    of the same weights' float32 plain route on the CPU (bf16 activations
    through four blocks)."""
    dev = _card()
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    params = zoo.init_params(cfg, seed=0, device=dev)
    frames = frontend.audio_frames(1, 2, 300, cfg.d_model, device=dev)
    toks = torch.from_numpy(_tokens(2, 40, cfg.vocab_size, 10)).long().to(dev)
    before = fa_ops.LAUNCHES
    logits, caches = zoo.prefill_fn(cfg, 64)(params, {"frames": frames, "tokens": toks})
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES - before == cfg.enc_layers + 2 * cfg.dec_layers
    before = fa_ops.LAUNCHES
    step, _ = zoo.decode_fn(cfg)(params, caches, toks[:, :1], 40)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before and torch.isfinite(step.float()).all()
    cpu = dataclasses.replace(cfg, dtype="float32")
    host = lambda t: t.float().cpu() if t.is_floating_point() else t.cpu()
    want, _ = zoo.prefill_fn(cpu, 64)(_map(params, host),
                                      {"frames": frames.cpu(), "tokens": toks.cpu()})
    _close(logits.cpu(), want.numpy(), "bf16 card against float32 plain", tol=5e-2)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [(2, 16, 16, 300, 1100, 64),
                                               (1, 4, 4, 77, 300, 64),
                                               (2, 8, 1, 300, 300, 128),
                                               (2, 16, 16, 2048, 1024, 64),
                                               (4, 16, 16, 2048, 4096, 64),
                                               (4, 16, 16, 4096, 4096, 64)])
def test_ragged_non_causal_attend_matches_plain_version_on_the_card(dtype, b, hq, hkv, sq, skv,
                                                                    d):
    """``ops.attend`` without the mask at key lengths the reference wrapper
    refuses (and Sq != Skv, the cross-attention's form), and at seamless's
    training cross-attention, serving cross-attention and encoder shapes:
    one launch, within FLASH_TOL of ``mha_reference`` and within
    ``bench.SCALED_TOL`` of its outputs' scale (over a thousand keys the
    outputs are as small as FLASH_TOL)."""
    dev = _card()
    gen = torch.Generator().manual_seed(sq + skv + d)
    q, k, v = (torch.randn(*s, generator=gen).to(dev, dtype)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    before = fa_ops.LAUNCHES
    got = fa_ops.attend(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    want = fa_ref.mha_reference(q, k, v, causal=False)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    rel = fa_bench.scaled_errors(got, want)
    limit = fa_bench.SCALED_TOL[str(dtype).removeprefix("torch.")]
    print(f"scaled errors (max, mean) {rel[0]:.3e}, {rel[1]:.3e} of limits {limit}")
    assert all(r <= lim for r, lim in zip(rel, limit)), (rel, limit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,skv", [(2, 16, 300, 1100), (1, 4, 77, 300)])
def test_scaled_tolerance_catches_a_ragged_tail_in_the_softmax(dtype, b, h, sq, skv):
    """``bench.SCALED_TOL``, the card check of non-causal K2, on the CPU:
    the plain version with P rounded to q's dtype for P.V, as the wgmma
    kernel rounds it (``mha_chunked``), stays within it; a softmax that
    lets the last key tile's zero-filled keys in (the fault a ragged
    non-causal tail invites) exceeds both of its limits."""
    gen = torch.Generator().manual_seed(sq + skv)
    q, k, v = (torch.randn(*s, generator=gen).to(dtype)
               for s in ((b, h, sq, 64), (b, h, skv, 64), (b, h, skv, 64)))
    want = fa_ref.mha_reference(q, k, v, causal=False)
    limit = fa_bench.SCALED_TOL[str(dtype).removeprefix("torch.")]
    rel = fa_bench.scaled_errors(fa_ref.mha_chunked(q, k, v, causal=False), want)
    assert all(r <= lim for r, lim in zip(rel, limit)), (rel, limit)
    pad = -skv % 128
    zeros = torch.zeros(b, h, pad, 64, dtype=dtype)
    faulty = fa_ref.mha_reference(q, torch.cat([k, zeros], 2), torch.cat([v, zeros], 2),
                                  causal=False)
    rel = fa_bench.scaled_errors(faulty, want)
    assert all(r > lim for r, lim in zip(rel, limit)), (rel, limit)


def test_launch_train_runs_seamless_reduced_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 4 and out["restarts"] == 0 and np.isfinite(out["last_loss"])
    assert (tmp_path / "step_00000004" / "manifest.json").exists()
