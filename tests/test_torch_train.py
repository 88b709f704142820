"""LM training in the PyTorch port against the JAX reference: the loss and
its gradients for every architecture the port runs, the MoE aux loss, the
sLSTM's custom backward and the SSD scan's gradient. The ``Trainer`` is
held in ``tests/test_torch_trainer.py``.

Tolerances (float32 throughout, reduced configs):
- ``forward_loss`` within 1e-5 relative of the reference's loss, and each
  gradient leaf within 1e-4 of that leaf's largest magnitude. Both sides
  run the same float32 formulas, summing products in different orders;
  measured 1e-7 on the loss and up to 4e-5 on a gradient (zamba2's, whose
  SSD scan sums over chunks), where a wrong mask, routing or recurrence
  moves them by tens of percent.
- The sLSTM's backward within 1e-5 of each gradient's largest magnitude
  (the reference's formulas; products summed in other orders).
- The SSD scan's gradient within 1e-5 of each gradient's largest
  magnitude: of a float64 step-by-step recurrence's everywhere, and of the
  reference's where the reference's is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.ssm_scan import ref as jax_ssd_ref
from repro.models import xlstm as jax_xlstm
from repro.models import zoo as jax_zoo
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.ssm_scan import ref as ssd_ref
from repro_torch.models import xlstm, zoo
from repro_torch.optim.optimizers import leaves

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
SLSTM_TOL = SSD_GRAD_TOL = 1e-5


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(vocab: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, 12)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    return toks, labels


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_and_gradients_match_reference(arch):
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    toks, labels = _batch(cfg.vocab_size)
    frames = {}
    if cfg.encdec:      # an encoder-decoder model also takes the source frames
        frames = {"frames": np.random.default_rng(2).standard_normal(
            (2, 7, cfg.d_model)).astype(np.float32)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_zoo.loss_fn(jcfg)))(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                  **{k: jnp.asarray(v) for k, v in frames.items()}})

    params = lm_params_from_reference(_numpy(jparams), device="cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64),
             "labels": torch.as_tensor(labels, dtype=torch.int64),
             **{k: torch.from_numpy(v) for k, v in frames.items()}}
    loss = zoo.loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, flat)

    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    got = {path: g for (path, _), g in zip(flatten(params), grads)}
    want = dict(flatten(lm_params_from_reference(_numpy(jgrads), device="cpu")))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), path


def test_moe_aux_loss_enters_the_loss():
    """qwen2-moe's loss is the cross-entropy plus 0.01 times the blocks' aux
    losses: without the aux the loss moves by exactly that much."""
    cfg = get_reduced("qwen2-moe-a2.7b")
    params = zoo.init_params(cfg, seed=0, device="cpu")
    batch = zoo.train_batch(cfg, 2, 12, seed=3, device="cpu")
    assert batch["tokens"].shape == (2, 12) and (batch["labels"][:, -1] == -1).all()
    torch.testing.assert_close(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    from repro_torch.models import moe, transformer
    auxes = []
    orig = moe.moe_ffn

    def tapped(*a, **kw):
        y, aux = orig(*a, **kw)
        auxes.append(aux)
        return y, aux

    with torch.no_grad():
        moe.moe_ffn = tapped
        try:
            loss = transformer.forward_loss(params, cfg, batch["tokens"], batch["labels"])
        finally:
            moe.moe_ffn = orig
        assert len(auxes) == cfg.num_layers and all(float(a) > 0 for a in auxes)
        x = transformer.embed(batch["tokens"], params["embed"])
        x, _ = transformer._run_groups(params, x, cfg, torch.arange(12))
        x = transformer.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        ce = transformer.cross_entropy_loss(transformer.unembed(x, params["embed"]),
                                            batch["labels"])
    aux_total = torch.zeros(())
    for a in auxes:
        aux_total = aux_total + a
    assert float(loss) == float(ce + 0.01 * aux_total)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_backward_matches_reference_custom_vjp(with_state):
    rng = np.random.default_rng(5)
    bsz, s, d = 2, 9, 6
    wx = rng.standard_normal((bsz, s, 4 * d)).astype(np.float32)
    r = (rng.standard_normal((d, 4 * d)) * 0.3).astype(np.float32)
    if with_state:
        init = [rng.standard_normal((bsz, d)).astype(np.float32) for _ in range(3)]
        init[1] = np.abs(init[1]) + 0.5
    else:
        init = [np.zeros((bsz, d), np.float32), np.full((bsz, d), 1e-6, np.float32),
                np.zeros((bsz, d), np.float32)]
    dhs = rng.standard_normal((bsz, s, d)).astype(np.float32)
    dfin = [rng.standard_normal((bsz, d)).astype(np.float32) for _ in range(3)]

    (jfin, jhs), vjp = jax.vjp(jax_xlstm._slstm_scan, jnp.asarray(wx.swapaxes(0, 1)),
                               jnp.asarray(r), tuple(jnp.asarray(a) for a in init))
    jdwx, jdr, jdinit = vjp((tuple(jnp.asarray(a) for a in dfin),
                             jnp.asarray(dhs.swapaxes(0, 1))))

    inputs = [torch.tensor(a, requires_grad=True) for a in (wx, r, *init)]
    hs, c, n, h = xlstm._SLSTMScan.apply(*inputs)
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs).swapaxes(0, 1),
                               rtol=0, atol=1e-6)
    grads = torch.autograd.grad((hs, c, n, h), inputs,
                                [torch.from_numpy(a) for a in (dhs, *dfin)])
    wants = [np.asarray(jdwx).swapaxes(0, 1), np.asarray(jdr), *map(np.asarray, jdinit)]
    for g, w in zip(grads, wants):
        assert np.abs(g.numpy() - w).max() <= SLSTM_TOL * np.abs(w).max()


def _ssd_sequential_f64(x, loga, b, c):
    """The SSD recurrence one step at a time in float64, the gradients'
    witness where nothing overflows: S_t = exp(loga_t) S_{t-1} + b_t x_t^T,
    y_t = c_t^T S_t."""
    state = x.new_zeros(x.shape[0], b.shape[-1], x.shape[-1])
    ys = []
    for t in range(x.shape[1]):
        state = torch.exp(loga[:, t])[:, None, None] * state + b[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("zn,znp->zp", c[:, t], state))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("decay", ["small", "model"])
def test_ssd_gradient_matches_reference_and_stays_finite(decay):
    """The plain SSD scan (the backward of K3's wrapper) under autograd, at
    a small decay and at the Mamba2 mixer's (~1.3 a step: exp(cum_i -
    cum_j) above a 128-step chunk's diagonal overflows in float32). Every
    gradient, loga's included, against the recurrence stepped in float64
    under autograd, where nothing overflows; and against the reference's
    ``ssd_chunked_ref`` where its gradient is finite: at the model's decay
    the reference's loga gradient is NaN (it masks after the exp: 0 *
    inf), the port's finite, since it selects the exponent before the
    exp."""
    rng = np.random.default_rng(0)
    bh, s, p, n, chunk = 2, 256, 8, 8, 128
    x, b, c = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((bh, s, p), (bh, s, n), (bh, s, n)))
    if decay == "small":
        loga = (-rng.random((bh, s)) * 0.2).astype(np.float32)
    else:
        loga = (-np.log1p(np.exp(rng.standard_normal((bh, s)))) - 0.5).astype(np.float32)
    gy = rng.standard_normal((bh, s, p)).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jax_ssd_ref.ssd_chunked_ref(*a, chunk=chunk)[0] * gy),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, loga, b, c)))
    inputs = [torch.tensor(a, requires_grad=True) for a in (x, loga, b, c)]
    y, _ = ssd_ref.ssd_chunked_ref(*inputs, chunk=chunk)
    grads = torch.autograd.grad(y, inputs, torch.from_numpy(gy))
    witness_in = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (x, loga, b, c)]
    witness = torch.autograd.grad(_ssd_sequential_f64(*witness_in), witness_in,
                                  torch.from_numpy(gy).double())
    assert all(torch.isfinite(g).all() for g in grads)
    for i, (g, w64, w) in enumerate(zip(grads, witness, map(np.asarray, jgrads))):
        w64 = w64.numpy()
        assert np.abs(g.numpy() - w64).max() <= SSD_GRAD_TOL * np.abs(w64).max(), i
        if decay == "model" and i == 1:
            assert not np.isfinite(w).all()
            continue
        assert np.abs(g.numpy() - w).max() <= SSD_GRAD_TOL * np.abs(w).max()


def test_encoder_decoder_training_raises():
    """What the reference's ``train_batch`` gives an encoder-decoder model,
    the port's gives too: frames (B, S // 2, d) float32 and S // 2 tokens
    whose labels equal the tokens (the reference draws both from one key),
    a batch ``loss_fn`` takes."""
    jcfg, cfg = jax_get_reduced("seamless-m4t-large-v2"), get_reduced("seamless-m4t-large-v2")
    want = jax_zoo.train_batch(jcfg, 3, 10, jax.random.PRNGKey(0))
    got = zoo.train_batch(cfg, 3, 10, seed=0, device="cpu")
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
    assert got["frames"].dtype == torch.float32 and want["frames"].dtype == jnp.float32
    assert np.array_equal(np.asarray(want["labels"]), np.asarray(want["tokens"]))
    assert torch.equal(got["labels"], got["tokens"])
    params = zoo.init_params(cfg, seed=0, device="cpu")
    assert torch.isfinite(zoo.loss_fn(cfg)(params, got))
