"""Flash attention: the port's plain versions and wrapper against the JAX
reference's ``mha_reference``/``mha_chunked``, its Pallas kernel (interpret
mode) and its wrapper, on the shapes, dtypes and tolerances of the
reference's own kernel tests (2e-3 in float32, 2e-2 in bfloat16). The CUDA
kernel runs only on the card (``-m cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention import ref as jax_ref
from repro_torch.kernels.flash_attention import ops, ref

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

F32_TOL, BF16_TOL = 2e-3, 2e-2
SHAPES = [(1, 1, 128, 64), (2, 2, 256, 32), (1, 4, 512, 64)]


def _inputs(b, hq, hkv, sq, skv, d, seed, dtype="float32"):
    """numpy float32 draws, rounded to ``dtype`` the same way on both sides."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,s,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_reference_and_pallas(b, h, s, d, causal):
    (jq, jk, jv), (q, k, v) = _inputs(b, h, h, s, s, d, seed=b * 100 + h * 10 + s)
    want = jax_ref.mha_reference(jq, jk, jv, causal=causal)
    _close(ref.mha_reference(q, k, v, causal=causal), want, F32_TOL)
    _close(ref.mha_chunked(q, k, v, causal=causal),
           jax_ref.mha_chunked(jq, jk, jv, causal=causal), F32_TOL)
    _close(ops.flash_attention(q, k, v, causal=causal),
           jax_ops.flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True), F32_TOL)


def test_gqa_matches_reference_and_pallas():
    """Four query heads on two KV heads: head h reads KV head h // 2."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 4, 2, 256, 256, 32, seed=5)
    want = jax_ops.flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    _close(ops.flash_attention(q, k, v), want, F32_TOL)
    _close(ref.mha_chunked(q, k, v, block_q=96), jax_ref.mha_chunked(jq, jk, jv, block_q=96),
           F32_TOL)


def test_wrapper_ragged_causal_matches_reference_wrapper():
    (jq, jk, jv), (q, k, v) = _inputs(2, 1, 1, 384, 384, 128, seed=77)
    want = jax_ops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=True), want, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_reference_and_pallas(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 256, 256, 64, seed=0, dtype=dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    got = ops.flash_attention(q, k, v)
    assert got.dtype == q.dtype
    _close(got, jax_ops.flash_attention_pallas(jq, jk, jv, causal=True, interpret=True), tol)
    _close(ref.mha_reference(q, k, v), jax_ref.mha_reference(jq, jk, jv), tol)
    _close(ref.mha_chunked(q, k, v), jax_ref.mha_chunked(jq, jk, jv), tol)


def test_q_offset_matches_reference_and_pallas():
    """Queries placed at the end of a longer key sequence (decode with a cache)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 128, 256, 64, seed=1)
    kw = dict(causal=True, q_offset=128)
    _close(ops.flash_attention(q, k, v, **kw),
           jax_ops.flash_attention_pallas(jq, jk, jv, interpret=True, **kw), F32_TOL)
    _close(ref.mha_chunked(q, k, v, **kw), jax_ref.mha_chunked(jq, jk, jv, **kw), F32_TOL)


def test_chunked_equals_reference_long():
    (_, _, _), (q, k, v) = _inputs(1, 2, 2, 640, 640, 32, seed=2)
    np.testing.assert_allclose(ref.mha_chunked(q, k, v).numpy(),
                               ref.mha_reference(q, k, v).numpy(), atol=2e-4)


def test_non_causal_ragged_raises_in_both():
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 1, 384, 384, 64, seed=3)
    with pytest.raises(ValueError, match="non-causal"):
        jax_ops.flash_attention(jq, jk, jv, causal=False, interpret=True)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(q, k, v, causal=False)


def test_cpu_tensors_take_the_plain_route():
    (_, _, _), (q, k, v) = _inputs(1, 2, 1, 64, 64, 16, seed=4)
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before          # the CPU never reaches the kernel
    torch.testing.assert_close(got, ref.mha_reference(q, k, v), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset", [
    (1, 1, 1, 128, 128, 64, True, 0), (2, 2, 2, 256, 256, 32, False, 0),
    (2, 1, 1, 384, 384, 128, True, 0), (1, 2, 2, 128, 256, 64, True, 128),
    (2, 4, 2, 200, 200, 16, True, 0), (1, 16, 8, 1000, 1000, 128, True, 0),
    (1, 4, 4, 300, 300, 112, True, 0), (2, 2, 2, 256, 256, 112, False, 0),
    (1, 16, 8, 1819, 1819, 128, True, 0), (1, 32, 32, 1819, 1819, 112, True, 0)])
def test_kernel_matches_plain_version_on_the_card(dtype, b, hq, hkv, sq, skv, d, causal,
                                                  q_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn(*s, generator=gen).to("cuda", dtype)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
