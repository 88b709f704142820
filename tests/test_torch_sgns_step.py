"""The fused DSGL step (``kernels.sgns.ops.sgns_step``): its plain version
against the JAX reference's step, the live-row write-back against the
reference's full-buffer write-back, the live-slot selection and extent
against the reference's masks, and (``-m cuda``, on the card) the kernels
and the CUDA-graph chunk against their plain and eager versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sgns import ref as jax_ref
from repro_torch.core import dsgl
from repro_torch.kernels.sgns import ops, ref

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)


def _jax_dsgl():
    """The reference's DSGL module, imported by the tests that use it: its
    import starts a JAX backend, which on a machine whose JAX_PLATFORMS
    names the GPU would take most of the card's memory before the card
    tests of this session run."""
    from repro.core import dsgl
    return dsgl

TOL = 5e-4


def _step_inputs(s, n, d, g, w, t, k, seed):
    """Walks with -1 holes at random positions, a hub id repeated across
    walks, and in each replica a dead position (no walk has a token there)
    whose first negative is a live walk row's id."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    walks = rng.integers(0, n, (s, g, w, t)).astype(np.int32)
    walks[rng.random(walks.shape) < 0.25] = -1
    walks[rng.random(walks.shape) < 0.1] = 3                    # the hub
    negs = rng.integers(0, n, (s, g, t, k)).astype(np.int32)
    dead = t - 2
    walks[:, 0, :, dead] = -1
    negs[:, 0, dead, 0] = walks[:, 1, 0, 0] = 5                 # live row, dead negative
    return f(s, n, d), f(s, n, d), walks, negs


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("s,n,d,g,w,t,k,window,seed", [
    (1, 40, 8, 4, 2, 12, 3, 3, 0),
    (1, 30, 16, 3, 3, 10, 2, 2, 1),
    (2, 50, 8, 3, 2, 14, 4, 4, 2),
])
def test_plain_step_matches_jax_step(s, n, d, g, w, t, k, window, seed):
    jax_dsgl = _jax_dsgl()
    phi_in, phi_out, walks, negs = _step_inputs(s, n, d, g, w, t, k, seed)
    lr = 0.025
    want_in, want_out, want_loss = [], [], []
    if s == 1:
        a, b, loss = jax_dsgl.lifetime_step(jnp.asarray(phi_in[0]), jnp.asarray(phi_out[0]),
                                            jnp.asarray(walks[0]), jnp.asarray(negs[0]),
                                            jnp.float32(lr), window)
        want_in, want_out, want_loss = np.asarray(a)[None], np.asarray(b)[None], [float(loss)]
    else:
        a, b, loss = jax_dsgl._replica_step(jnp.asarray(phi_in), jnp.asarray(phi_out),
                                            jnp.asarray(walks), jnp.asarray(negs),
                                            jnp.float32(lr), window, False)
        want_in, want_out, want_loss = np.asarray(a), np.asarray(b), np.asarray(loss)
    got_in, got_out, tw, tn = _torch(phi_in, phi_out, walks, negs)
    before = ops.LAUNCHES
    loss = ops.sgns_step(got_in, got_out, tw, tn, torch.tensor([lr]), window)
    assert ops.LAUNCHES == before                  # the CPU never reaches the kernel
    assert not torch.equal(got_in, torch.from_numpy(phi_in))          # it trained
    np.testing.assert_allclose(got_in.numpy(), want_in, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=TOL)


def test_negative_at_dead_position_counts_in_denominator():
    """phi_out's duplicate count includes negatives at dead positions: the
    live row that a dead negative also names moves by delta / 2, not by
    the whole delta."""
    phi_in, phi_out, walks, negs = _step_inputs(1, 40, 8, 4, 2, 12, 3, 0)
    walks[walks == 5] = 6
    walks[0, 1, 0, 0] = 5                          # row 5: one live slot
    negs[negs == 5] = 6
    negs[0, 0, 10, 0] = 5                          # and one negative at the dead position
    assert not (walks[0, 0, :, 10] >= 0).any()
    got_in, got_out, tw, tn = _torch(phi_in, phi_out, walks, negs)
    ops.sgns_step(got_in, got_out, tw, tn, torch.tensor([0.025]), 3)
    _, d_out, _, _ = ref.lifetime_deltas_ref(*_torch(phi_in, phi_out, walks, negs),
                                             torch.tensor([0.025]), 3)
    assert d_out[0, 1, 0, 0].abs().max() > 0
    torch.testing.assert_close(got_out[0, 5], torch.from_numpy(phi_out[0, 5]) + d_out[0, 1, 0, 0] / 2,
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("s,seed", [(1, 3), (2, 4)])
def test_live_write_back_equals_full_write_back(s, seed):
    """Deltas from the lifetime update (zero in every dead slot), written
    back over the live slots only, equal the reference's write-back over
    every slot, to 1e-7."""
    jax_dsgl = _jax_dsgl()
    n, d, g, w, t, k, window = 30, 8, 4, 2, 12, 3, 3
    phi_in, phi_out, walks, negs = _step_inputs(s, n, d, g, w, t, k, seed)
    deltas = ref.lifetime_deltas_ref(*_torch(phi_in, phi_out, walks, negs),
                                     torch.tensor([0.05]), window)
    got_in, got_out = _torch(phi_in, phi_out)
    ref.write_back_ref(got_in, got_out, torch.from_numpy(walks), torch.from_numpy(negs),
                       *deltas[:3])
    for r in range(s):
        d_ctx, d_out, d_neg = (jnp.asarray(a[r].numpy()) for a in deltas[:3])
        want_in, want_out = jax_dsgl._write_back(
            jnp.asarray(phi_in[r]), jnp.asarray(phi_out[r]), jnp.maximum(walks[r], 0),
            jnp.asarray(negs[r]), jnp.asarray(walks[r] >= 0),
            d_ctx, jnp.zeros_like(d_ctx), d_out, jnp.zeros_like(d_out), d_neg,
            jnp.zeros_like(d_neg))
        np.testing.assert_allclose(got_in[r].numpy(), np.asarray(want_in), atol=1e-7, rtol=0)
        np.testing.assert_allclose(got_out[r].numpy(), np.asarray(want_out), atol=1e-7, rtol=0)


def test_extent_and_live_slots_match_reference_masks():
    """The live slots and each lifetime's extent are what the reference's
    masks give, and the reference changes no slot outside them."""
    rng = np.random.default_rng(8)
    g, w, t, d, k, window = 6, 3, 16, 8, 3, 2
    walks = rng.integers(0, 50, (1, g, w, t)).astype(np.int32)
    walks[rng.random(walks.shape) < 0.4] = -1
    walks[0, 2] = -1                                   # a lifetime with no token
    walks[0, 3, :, :5] = -1                            # one that starts late
    walks[0, 4, :, 9:] = -1                            # one that ends early
    valid, pos_live = ref.live_slots(torch.from_numpy(walks))
    np.testing.assert_array_equal(valid.numpy(), walks >= 0)
    tgt_any = (walks >= 0).any(axis=2)                 # the reference's col mask, any walk
    np.testing.assert_array_equal(pos_live.numpy(), tgt_any)
    lo, hi = ref.lifetime_extent(torch.from_numpy(walks))
    for life in range(g):
        pos = np.flatnonzero(tgt_any[0, life])
        assert (lo[0, life].item(), hi[0, life].item()) == \
            ((pos.min(), pos.max()) if pos.size else (-1, -1))

    f = lambda *shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    ctx, out, neg = f(g, w, t, d), f(g, w, t, d), f(g, t, k, d)
    got = jax_ref.sgns_lifetime_batch_ref(jnp.asarray(ctx), jnp.asarray(out), jnp.asarray(neg),
                                          jnp.asarray(walks[0] >= 0), jnp.float32(0.05), window)
    moved = lambda new, old: np.abs(np.asarray(new) - old).max(axis=-1) > 0
    assert not (moved(got[0], ctx) & (walks[0] < 0)).any()
    assert not (moved(got[1], out) & (walks[0] < 0)).any()
    assert not (moved(got[2], neg) & ~tgt_any[0][:, :, None]).any()
    assert moved(got[2], neg).any()
    assert float(got[3][2]) == 0.0


def test_chunk_graphs_need_the_card():
    """On the CPU the pipeline trains eagerly; the graph path refuses CPU
    tensors instead of running something else."""
    phi = torch.zeros(1, 10, 8)
    walks = torch.zeros(2, 1, 1, 2, 5, dtype=torch.int32)
    table = dsgl.build_alias_table(np.ones(10), 0.75, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        dsgl.ChunkGraphs().train_chunk(phi, phi.clone(), walks, table, (0, 1), [0.1, 0.1], 2, 3)


# --- on the card ----------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,d,g,w,t,k,window", [(1, 5000, 128, 64, 2, 100, 5, 10),
                                                  (2, 5000, 128, 64, 2, 100, 5, 10),
                                                  (2, 700, 96, 5, 2, 37, 5, 10),
                                                  (1, 900, 128, 7, 3, 23, 4, 5),
                                                  (1, 900, 128, 6, 2, 30, 14, 4)])
def test_cuda_step_matches_plain_version(cuda_device, s, n, d, g, w, t, k, window):
    phi_in, phi_out, walks, negs = (a.to(cuda_device) for a in
                                    _torch(*_step_inputs(s, n, d, g, w, t, k, seed=g)))
    lr = torch.tensor([0.025], device=cuda_device)
    want_in, want_out = phi_in.clone(), phi_out.clone()
    before = ops.LAUNCHES, ops.WRITEBACKS
    loss = ops.sgns_step(phi_in, phi_out, walks, negs, lr, window)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.WRITEBACKS) == (before[0] + 1, before[1] + 1)
    want_loss = ref.sgns_step_ref(want_in, want_out, walks, negs, lr, window)
    torch.testing.assert_close(phi_in, want_in, atol=TOL, rtol=TOL)
    torch.testing.assert_close(phi_out, want_out, atol=TOL, rtol=TOL)
    torch.testing.assert_close(loss, want_loss, atol=TOL, rtol=TOL)
    deltas = ops.lifetime_deltas(want_in, want_out, walks, negs, lr, window)
    for a, b in zip((deltas.d_ctx, deltas.d_out, deltas.d_neg, deltas.loss),
                    ref.lifetime_deltas_ref(want_in, want_out, walks, negs, lr, window)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_cuda_step_counts_dead_negatives(cuda_device):
    """The kernels' write-back counts a negative at a dead position: the
    live row it names moves by half its delta."""
    phi_in, phi_out, walks, negs = _step_inputs(1, 40, 128, 4, 2, 12, 3, 0)
    walks[walks == 5] = 6
    walks[0, 1, 0, 0] = 5
    negs[negs == 5] = 6
    negs[0, 0, 10, 0] = 5
    args = [a.to(cuda_device) for a in _torch(phi_in, phi_out, walks, negs)]
    lr = torch.tensor([0.025], device=cuda_device)
    d_out = ref.lifetime_deltas_ref(*args, lr, 3)[1]
    ops.sgns_step(*args, lr, 3)
    assert d_out[0, 1, 0, 0].abs().max() > 1e-4
    torch.testing.assert_close(args[1][0, 5], torch.from_numpy(phi_out[0, 5]).to(cuda_device)
                               + d_out[0, 1, 0, 0] / 2, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_graph_chunks_match_eager(cuda_device):
    """Two chunks replayed as one CUDA graph each equal two eager chunks
    from the same state."""
    s, n, d, g, w, t, k, window = 1, 4000, 128, 16, 2, 40, 5, 10
    phi_in, phi_out, walks, _ = (a.to(cuda_device) for a in
                                 _torch(*_step_inputs(s, n, d, g, w, t, k, seed=11)))
    chunk = torch.stack([walks.roll(c, dims=-1) for c in range(3)])     # (C, S, G, W, T)
    table = dsgl.build_alias_table(np.arange(n) % 20 + 1, 0.75, cuda_device)
    lrs = np.asarray([0.025, 0.02, 0.015], np.float32)
    graph_in, graph_out = phi_in.clone(), phi_out.clone()
    graphs = dsgl.ChunkGraphs()
    launches, replays = ops.LAUNCHES, dsgl.GRAPH_REPLAYS
    for key in ((0, 1), (0, 2)):
        got = graphs.train_chunk(graph_in, graph_out, chunk, table, key, lrs, window, k)
        want = dsgl.train_chunk(phi_in, phi_out, chunk, table, key, lrs, window, k)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.cuda.synchronize()
    assert dsgl.GRAPH_REPLAYS == replays + 2
    assert ops.LAUNCHES == launches + 2 * 3 + 2 * 3          # replayed + eager steps
    torch.testing.assert_close(graph_in, phi_in, atol=TOL, rtol=TOL)
    torch.testing.assert_close(graph_out, phi_out, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_cuda_graph_keeps_its_scratch(cuda_device):
    """A replay writes only where the graph owns memory: tensors of the step
    scratch's sizes, allocated and filled after the capture, are untouched
    by the next replay, and phi still equals two eager chunks."""
    s, n, d, g, w, t, k, window = 1, 4000, 128, 64, 2, 100, 5, 10
    phi_in, phi_out, walks, _ = (a.to(cuda_device) for a in
                                 _torch(*_step_inputs(s, n, d, g, w, t, k, seed=12)))
    chunk = torch.stack([walks.roll(c, dims=-1) for c in range(2)])     # (C, S, G, W, T)
    table = dsgl.build_alias_table(np.arange(n) % 20 + 1, 0.75, cuda_device)
    lrs = np.asarray([0.025, 0.02], np.float32)
    graph_in, graph_out = phi_in.clone(), phi_out.clone()
    graphs = dsgl.ChunkGraphs()
    graphs.train_chunk(graph_in, graph_out, chunk, table, (0, 1), lrs, window, k)
    torch.cuda.synchronize()
    keys = 2 * s * g * w * t + s * g * t * k
    held = [torch.full(shape, 7.0, device=cuda_device)
            for shape in ((s, g, w, t, d), (s, g, w, t, d), (s, g, t, k, d), (s * g,), (keys,),
                          (2 * keys,))]
    graphs.train_chunk(graph_in, graph_out, chunk, table, (0, 2), lrs, window, k)
    for key in ((0, 1), (0, 2)):
        dsgl.train_chunk(phi_in, phi_out, chunk, table, key, lrs, window, k)
    torch.cuda.synchronize()
    for h in held:
        assert bool((h == 7.0).all())
    torch.testing.assert_close(graph_in, phi_in, atol=TOL, rtol=TOL)
    torch.testing.assert_close(graph_out, phi_out, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_cuda_failed_step_leaves_counts_zero(cuda_device, monkeypatch):
    """A step whose write-back fails to launch raises and leaves nothing that
    later steps read: phi untouched (the write-back keeps no duplicate
    counts between steps; each step counts its own segments), and the next
    step equals its plain version."""
    s, n, d, g, w, t, k, window = 1, 300, 128, 4, 2, 12, 3, 3
    args = [a.to(cuda_device) for a in _torch(*_step_inputs(s, n, d, g, w, t, k, seed=13))]
    lr = torch.tensor([0.025], device=cuda_device)
    before = [a.clone() for a in args[:2]]
    lib = ops.LIBRARY.load()
    monkeypatch.setattr(lib, "sgns_wb_segments_launch", lambda *a: 1)
    with pytest.raises(RuntimeError, match="write-back"):
        ops.sgns_step(*args, lr, window)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(args[0], before[0]) and torch.equal(args[1], before[1])
    want = [a.clone() for a in args[:2]]
    ops.sgns_step(*args, lr, window)
    ref.sgns_step_ref(*want, *args[2:], lr, window)
    torch.testing.assert_close(args[0], want[0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(args[1], want[1], atol=TOL, rtol=TOL)


def _hub_chunk(device, s=2, n=3000, g=64, w=2, t=100, c=4, seed=21):
    """A (C, S, G, W, T) chunk in which row 7 fills a third of the walk
    slots (thousands per step) and row 8 a tenth of them."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, n, (c, s, g, w, t)).astype(np.int32)
    walks[rng.random(walks.shape) < 0.3] = 7
    walks[rng.random(walks.shape) < 0.1] = 8
    walks[rng.random(walks.shape) < 0.15] = -1
    f = lambda: torch.from_numpy((rng.standard_normal((s, n, 128)) * 0.1).astype(np.float32))
    table = dsgl.build_alias_table(np.where(np.arange(n) < 10, 5000, 3), 0.75, device)
    return f().to(device), f().to(device), torch.from_numpy(walks).to(device), table


@pytest.mark.cuda
def test_cuda_step_and_chunk_are_bit_repeatable(cuda_device):
    """The write-back adds in a fixed order: the same hub-heavy step, and
    the same chunk replayed as a CUDA graph, from the same state give
    bit-equal phi on every run, and the step equals its plain version."""
    phi_in, phi_out, chunk, table = _hub_chunk(cuda_device)
    lrs = np.asarray([0.05, 0.04, 0.03, 0.02], np.float32)
    negs = dsgl.chunk_negatives(table, (0, 5), chunk.shape, 5)
    lr = torch.tensor([0.05], device=cuda_device)
    runs = []
    for _ in range(3):
        a, b = phi_in.clone(), phi_out.clone()
        ops.sgns_step(a, b, chunk[0], negs[0], lr, 10)
        runs.append((a, b))
    want = [phi_in.clone(), phi_out.clone()]
    ref.sgns_step_ref(*want, chunk[0], negs[0], lr, 10)
    torch.cuda.synchronize()
    assert all(torch.equal(x[0], runs[0][0]) and torch.equal(x[1], runs[0][1]) for x in runs)
    torch.testing.assert_close(runs[0][0], want[0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(runs[0][1], want[1], atol=TOL, rtol=TOL)
    chunks = []
    for _ in range(2):
        a, b = phi_in.clone(), phi_out.clone()
        graphs = dsgl.ChunkGraphs()
        for key in ((0, 1), (0, 2)):
            graphs.train_chunk(a, b, chunk, table, key, lrs, 10, 5)
        chunks.append((a, b))
    torch.cuda.synchronize()
    assert torch.equal(chunks[0][0], chunks[1][0]) and torch.equal(chunks[0][1], chunks[1][1])


@pytest.mark.cuda
def test_cuda_sync_in_graph_equals_eager_sync(cuda_device):
    """Two replicas through graph chunks, the first and third ending with
    the hotness sync captured in their graph (five rows in a buffer of
    eight): phi bit-equal to the same graph chunks with the sync run after
    the replay, within 5e-4 of the eager chunks; the synced rows equal
    across the replicas, the others not."""
    from repro_torch.core.sync import hotness_sync_stacked

    phi_in, phi_out, chunk, table = _hub_chunk(cuda_device, seed=22)
    lrs = np.asarray([0.05, 0.04, 0.03, 0.02], np.float32)
    rows = torch.tensor([7, 8, 11, 500, 2999], dtype=torch.int64)
    plan = (((0, 1), True), ((0, 2), False), ((0, 3), True))
    out = {}
    for name in ("in_graph", "after", "eager"):
        a, b = phi_in.clone(), phi_out.clone()
        graphs = dsgl.ChunkGraphs()
        for key, sync in plan:
            if name == "eager":
                dsgl.train_chunk(a, b, chunk, table, key, lrs, 10, 5, sync_rows=rows, sync=sync)
            elif name == "in_graph":
                graphs.train_chunk(a, b, chunk, table, key, lrs, 10, 5, sync_rows=rows, sync=sync)
            else:
                graphs.train_chunk(a, b, chunk, table, key, lrs, 10, 5)
                if sync:
                    hotness_sync_stacked(a, b, rows.to(cuda_device))
        out[name] = (a, b)
    torch.cuda.synchronize()
    assert torch.equal(out["in_graph"][0], out["after"][0])
    assert torch.equal(out["in_graph"][1], out["after"][1])
    torch.testing.assert_close(out["in_graph"][0], out["eager"][0], atol=TOL, rtol=TOL)
    torch.testing.assert_close(out["in_graph"][1], out["eager"][1], atol=TOL, rtol=TOL)
    a = out["in_graph"][0]
    assert torch.equal(a[0, rows], a[1, rows]) and not torch.equal(a[0, 4], a[1, 4])
