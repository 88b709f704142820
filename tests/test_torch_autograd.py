"""Gradients through the PyTorch port's kernels and custom backward passes,
held against plain autograd. No JAX here (the card tests live in this
file; ``tests/test_torch_train.py`` holds the port against the reference).

On the CPU the wrappers of K2 (``flash_attention``) and K3 (the SSD scan)
are driven with a stand-in for the kernel launch (the plain forward,
detached), so that their backward (the plain version's vector-Jacobian
product, recomputed from the saved inputs) is held bit for bit against
plain autograd; the sLSTM's custom backward against autograd through its
step loop (1e-5 of each gradient's largest magnitude: dR is one batched
product there, a sum of per-step products here); per-block remat against
none, bit for bit. On the card (``-m cuda``) the real kernels: each
wrapper's forward within the kernel's tolerance of the plain forward and
every input gradient bit-equal to the plain version's, and a training
step repeatable bit for bit with K2 launched twice per attention block.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import grad_check
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.kernels.ssm_scan import ref as ssd_ref
from repro_torch.models import transformer, xlstm, zoo
from repro_torch.optim.optimizers import leaves
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

SLSTM_TOL = 1e-5
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
SSD_TOL = 3e-3


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


@pytest.fixture()
def stand_in_flash(monkeypatch):
    """The kernel launch replaced by the plain forward (no graph), counted."""
    calls = []

    def launch(q, k, v, causal, sm_scale, q_offset):
        calls.append(v is k)
        with torch.no_grad():
            return fa_ref.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                        q_offset=q_offset)

    monkeypatch.setattr(fa_ops, "_launch", launch)
    return calls


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,q_offset,v_is_k", [
    (4, 2, 10, 10, True, 0, False), (4, 4, 7, 12, True, 5, False),
    (4, 2, 8, 16, False, 0, False), (4, 1, 9, 9, True, 0, True)])
def test_flash_wrapper_backward_is_the_plain_versions(stand_in_flash, hq, hkv, sq, skv,
                                                      causal, q_offset, v_is_k):
    gen = torch.Generator().manual_seed(hq * 100 + sq)
    q, k, v = _randn(gen, 2, hq, sq, 16), _randn(gen, 2, hkv, skv, 16), _randn(gen, 2, hkv, skv, 16)
    if v_is_k:
        v = k
    go = _randn(gen, 2, hq, sq, 16)
    runs = []
    for fn in (lambda *a: fa_ops._on_card(*a, causal, 0.3, q_offset),
               lambda *a: fa_ref.mha_reference(*a, causal=causal, sm_scale=0.3,
                                               q_offset=q_offset)):
        runs.append(grad_check._run(fn, (q, k, v), (go,), (1, 2) if v_is_k else None))
    (out, grads), (want, want_grads) = runs
    assert stand_in_flash == [v_is_k]
    assert torch.equal(out[0], want[0])
    assert len(grads) == (2 if v_is_k else 3)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_flash_attention_takes_plain_autograd_for_cpu_tensors(stand_in_flash):
    q = torch.randn(1, 2, 5, 16, requires_grad=True)
    out = fa_ops.flash_attention(q, q.detach()[:, :1], q.detach()[:, :1])
    assert stand_in_flash == [] and "PlainBackward" not in type(out.grad_fn).__name__


def _stand_in_scan(plain):
    def launch(xdt, loga, b, c, chunk):
        with torch.no_grad():
            return plain(xdt, loga, b, c, chunk=chunk)
    return launch


@pytest.mark.parametrize("form", ["heads", "3d"])
@pytest.mark.parametrize("state_grad", [False, True])
def test_scan_wrapper_backward_is_the_plain_versions(form, state_grad):
    gen = torch.Generator().manual_seed(7)
    if form == "heads":
        bsz, h, g, s, p, n = 2, 4, 2, 21, 8, 6
        xdt = _randn(gen, bsz, s, h, p).transpose(1, 2)          # the mixer's strided view
        loga = -torch.rand(bsz, s, h, generator=gen).transpose(1, 2)
        b, c = _randn(gen, bsz, g, s, n), _randn(gen, bsz, g, s, n)
        plain = ssd_ops._plain
    else:
        xdt, loga = _randn(gen, 6, 21, 8), -torch.rand(6, 21, generator=gen)
        b, c = _randn(gen, 6, 21, 6), _randn(gen, 6, 21, 6)
        plain = ssd_ref.ssd_chunked_ref
    y, st = plain(xdt, loga, b, c, chunk=8)
    gy = _randn(gen, *y.shape)
    gs = _randn(gen, *st.shape) if state_grad else None
    wrapped = grad_check._run(
        lambda *a: ssd_ops._on_card(_stand_in_scan(plain), plain, 8, *a),
        (xdt, loga, b, c), (gy, gs))
    want = grad_check._run(lambda *a: plain(*a, chunk=8), (xdt, loga, b, c), (gy, gs))
    assert all(torch.equal(a, b_) for a, b_ in zip(wrapped[0], want[0]))
    assert all(torch.equal(a, b_) for a, b_ in zip(wrapped[1], want[1]))


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_function_matches_autograd_through_the_loop(with_state):
    gen = torch.Generator().manual_seed(11)
    bsz, s, d = 3, 12, 8
    wx, r = _randn(gen, bsz, s, 4 * d), _randn(gen, d, 4 * d) * 0.3
    if with_state:
        init = [_randn(gen, bsz, d), torch.rand(bsz, d, generator=gen) + 0.5, _randn(gen, bsz, d)]
    else:
        init = [torch.zeros(bsz, d), torch.full((bsz, d), xlstm.EPS), torch.zeros(bsz, d)]
    gouts = [_randn(gen, bsz, s, d)] + [_randn(gen, bsz, d) for _ in range(3)]

    def loop(wx, r, c, n, h):
        hs = []
        for t in range(wx.shape[1]):
            c, n, h = xlstm._slstm_step(c, n, h, wx[:, t], r)
            hs.append(h)
        return torch.stack(hs, dim=1), c, n, h

    got_out, got = grad_check._run(xlstm._SLSTMScan.apply, (wx, r, *init), gouts)
    want_out, want = grad_check._run(loop, (wx, r, *init), gouts)
    for a, b in zip(got_out, want_out):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= SLSTM_TOL * b.abs().max()


def test_slstm_mixer_under_no_grad_builds_no_graph():
    cfg = get_reduced("xlstm-350m")
    params = zoo.init_params(cfg, seed=0, device="cpu")
    slstm = next(rep[b]["mixer"] for rep in params["group_0"] for b in rep if "r" in rep[b]["mixer"])
    x = torch.randn(2, 5, cfg.d_model)
    with torch.no_grad():
        y, _ = xlstm.slstm_mixer(x, slstm, cfg)
    assert y.grad_fn is None and y.shape == x.shape


def _loss_and_grads(cfg, params, batch):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = zoo.loss_fn(cfg)(params, batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b", "xlstm-350m",
                                  "deepseek-v2-lite-16b"])
def test_remat_changes_neither_loss_nor_gradients(arch):
    cfg = get_reduced(arch)
    params = zoo.init_params(cfg, seed=0, device="cpu")
    batch = zoo.train_batch(cfg, 2, 12, seed=1, device="cpu")
    loss, grads = _loss_and_grads(cfg, params, batch)
    loss_r, grads_r = _loss_and_grads(dataclasses.replace(cfg, remat="full"), params, batch)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


# --- on the card ----------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the wrappers' kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,v_is_k,sm_scale", [
    (2, 16, 8, 1024, 128, torch.bfloat16, False, None),      # qwen3-1.7b's heads
    (1, 32, 32, 300, 112, torch.bfloat16, False, None),      # zamba2-7b's head dim
    (1, 8, 1, 333, 288, torch.bfloat16, True, 96 ** -0.5),   # MLA's latent, v = k
    (1, 4, 1, 200, 576, torch.bfloat16, True, 192 ** -0.5),
    (2, 4, 2, 130, 64, torch.float32, False, None)])
def test_flash_wrapper_gradients_equal_the_plain_versions_on_the_card(b, hq, hkv, s, d, dtype,
                                                                      v_is_k, sm_scale):
    _need_card()
    gen = torch.Generator().manual_seed(s)
    q, k, v = (_randn(gen, *shape).to("cuda", dtype)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    if v_is_k:
        v = k
    go = _randn(gen, b, hq, s, d).to("cuda", dtype)
    case = grad_check.flash_case(q, k, v, go, sm_scale=sm_scale)
    assert case.launches == 1
    assert case.forward_err() <= FLASH_TOL[dtype] * max(1.0, case.plain_outputs[0].abs().max())
    assert case.grads_equal() and all(torch.isfinite(g).all() for g in case.grads)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 1, 300, 64, 64, 128),     # the first route
                                   (2, 4, 4, 260, 129, 128, 256),   # the wide route
                                   (6, 200, 64, 32, 64)])           # the 3-D form
@pytest.mark.parametrize("state_grad", [False, True])
def test_scan_wrapper_gradients_equal_the_plain_versions_on_the_card(shape, state_grad):
    _need_card()
    gen = torch.Generator().manual_seed(len(shape))
    if len(shape) == 7:
        bsz, h, g, s, p, n, chunk = shape
        xdt = _randn(gen, bsz, s, h, p).cuda().transpose(1, 2)
        loga = (-torch.rand(bsz, s, h, generator=gen) * 0.2).cuda().transpose(1, 2)
        b, c = _randn(gen, bsz, g, s, n).cuda(), _randn(gen, bsz, g, s, n).cuda()
        gy, gs = _randn(gen, bsz, h, s, p).cuda(), _randn(gen, bsz, h, n, p).cuda()
    else:
        bh, s, p, n, chunk = shape
        xdt, loga = _randn(gen, bh, s, p).cuda(), (-torch.rand(bh, s, generator=gen) * 0.2).cuda()
        b, c = _randn(gen, bh, s, n).cuda(), _randn(gen, bh, s, n).cuda()
        gy, gs = _randn(gen, bh, s, p).cuda(), _randn(gen, bh, n, p).cuda()
    case = grad_check.scan_case(xdt, loga, b, c, chunk, gy, gs if state_grad else None)
    assert case.launches == 1
    scale = max(1.0, max(o.abs().max().item() for o in case.plain_outputs))
    assert case.forward_err() <= SSD_TOL * scale
    assert case.grads_equal() and all(torch.isfinite(g).all() for g in case.grads)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b", "zamba2-7b"])
def test_training_is_repeatable_on_the_card(arch, tmp_path):
    """Two runs of three steps from one seed end on the same bits (the
    embedding's and the MoE's backward scatters included), and K2 runs
    twice per attention block and step under remat (forward and recompute).
    (The reduced MLA configs' latent head dim, 24, is not one K2 is built
    for.)"""
    _need_card()
    cfg = dataclasses.replace(get_reduced(arch), remat="full", dtype="bfloat16")
    states = []
    for i in range(2):
        before = fa_ops.LAUNCHES
        out = Trainer(cfg, TrainerConfig(steps=3, ckpt_every=100, batch=2, seq_len=64,
                                         ckpt_dir=str(tmp_path / str(i))), device="cuda").run()
        n_attn = sum(pattern.count("a") * reps for pattern, reps in transformer._groups(cfg))
        assert fa_ops.LAUNCHES - before == 2 * n_attn * 3
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["gnorm"]) for m in out["metrics"])
        states.append(out["state"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(states[0]), leaves(states[1])))
