"""The port's mesh layer across processes: spec resolution, the production
meshes, the hotness sync and compressed all-reduce, the GPipe pipeline,
K2's wrapper and the constrain helpers on DTensors, re-sharding between
meshes, and a (2, 2) data x model train step at grad_accum 1 and 2,
against the reference (and the port's single-process step).

One spawn of four gloo ranks (``repro_torch.dist.spawn``) runs every
multi-process case (``torch_spmd_ranks.mesh_cases``); each test asserts
its own. The ranks import neither JAX nor the reference: the parent makes
the inputs with numpy and computes the reference's outputs.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist.sharding import P
from repro_torch.dist.spawn import run_ranks

torch.set_num_threads(1)

N_ROWS, DIM = 32, 4
PIPE = dict(stages=4, micro=4, mb=2, dim=8)
ACCUMS = (1, 2)


def _reference_lm():
    """reduced yi-6b: the reference's weights and batch, as numpy."""
    import jax
    from repro.configs import get_reduced as jax_reduced
    from repro.models import zoo as jax_zoo

    cfg = jax_reduced("yi_6b")
    params = jax_zoo.init_params(jax.random.PRNGKey(0), cfg)
    batch = jax_zoo.train_batch(cfg, 4, 16, jax.random.PRNGKey(1))
    return cfg, params, batch


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    import jax

    jcfg, jparams, jbatch = _reference_lm()
    host = ranks._tree_numpy(lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                                                      "cpu"))
    starts, ends = np.array([0, 1, 2, 5, 12, 20]), np.array([1, 2, 5, 12, 20, 32])
    inputs = dict(
        replicas_in=rng.standard_normal((4, N_ROWS, DIM)).astype(np.float32),
        replicas_out=rng.standard_normal((4, N_ROWS, DIM)).astype(np.float32),
        starts=starts, ends=ends,
        grad=rng.standard_normal((4, 8, 64)).astype(np.float32),
        error=(rng.standard_normal((4, 8, 64)) * 0.1).astype(np.float32),
        pipe_w=(rng.standard_normal((PIPE["stages"], PIPE["dim"], PIPE["dim"])) * 0.3
                ).astype(np.float32),
        pipe_x=rng.standard_normal((PIPE["micro"] * PIPE["mb"], PIPE["dim"])).astype(np.float32),
        pipe_m=PIPE["micro"],
        attn={c: rng.standard_normal((2, 4, 16, 8)).astype(np.float32) for c in "qkv"},
        act=rng.standard_normal((2, 6, 8)).astype(np.float32),
        reshard_tree={"a": rng.standard_normal((4, 6)).astype(np.float32),
                      "b": [rng.standard_normal((3, 4)).astype(np.float32), np.arange(8)]},
        train=dict(cfg=get_reduced("yi-6b"), accums=ACCUMS, params=host,
                   batch={k: np.asarray(v).astype(np.int64) for k, v in jbatch.items()}))
    from repro.core.sync import sample_hotness_rows
    inputs["rows"] = sample_hotness_rows(starts, ends, np.random.default_rng(3))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spmd = pool.submit(run_ranks, ranks.mesh_cases, 4, "gloo", "cpu", 150.0, inputs)
        want = {accum: _single_process_steps(inputs["train"], jcfg, jparams, jbatch, accum)
                for accum in ACCUMS}          # while the ranks work
        return inputs, spmd.result(), want


def _single_process_steps(train: dict, jcfg, jparams, jbatch, accum: int) -> dict:
    """{"port": ..., "reference": ...}: (params, opt state, metrics) after
    step 1 of the port's single-process ``build_train_step`` and of the
    reference's on the same weights and batch, in the port's layout."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jax_steps
    from repro.optim.optimizers import init_opt_state as jax_init_opt

    from repro_torch.convert import opt_state_from_reference
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import init_opt_state

    cfg = dataclasses.replace(train["cfg"], grad_accum=accum)
    params = ranks._tree_tensor(train["params"])
    opt = init_opt_state(params, steps.default_opt(cfg))
    batch = {k: torch.from_numpy(v) for k, v in train["batch"].items()}
    port = steps.build_train_step(cfg, total_steps=10)(params, opt, batch, 1)

    jc = dataclasses.replace(jcfg, grad_accum=accum)
    jopt = jax_init_opt(jparams, jax_steps.default_opt(jc))
    jp, jo, jm = jax.jit(jax_steps.build_train_step(jc, total_steps=10))(jparams, jopt, jbatch,
                                                                      jnp.int32(1))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"port": port, "reference": (lm_params_from_reference(host(jp), "cpu"),
                                        opt_state_from_reference(host(jo), "cpu"),
                                        {k: float(v) for k, v in jm.items()})}


def test_resolve_spec_cases_match_reference(setup):
    """tests/test_dist.py's resolution cases on the port's (1, 1) host mesh,
    and the same resolutions by the reference on its own."""
    from jax.sharding import PartitionSpec as JP
    from repro.dist.sharding import resolve_spec as jax_resolve, resolve_specs as jax_resolves
    from repro.launch.mesh import make_host_mesh as jax_host_mesh

    got = setup[1][0]["resolve"]
    jm = jax_host_mesh(1, 1)
    assert got["drop_missing"] == P("data", "model") == \
        tuple(jax_resolve(JP(("pod", "data"), "model"), jm, (4, 4)))
    assert got["nondivisible"] == P("data") == tuple(jax_resolve(JP("data"), jm, (3,)))
    want = jax_resolves({"a": JP("pod", "model"), "b": {"c": JP(("pod", "data"))}}, jm)
    assert got["tree"] == {"a": P(None, "model"), "b": {"c": P("data")}}
    assert got["tree"]["a"] == tuple(want["a"]) and got["tree"]["b"]["c"] == tuple(want["b"]["c"])
    assert got["sizes"] == [1, 1, 1] and got["chips"] == 1


def test_resolution_on_a_two_by_two_mesh(setup):
    """Axes that do not divide a dim drop; a missing "pod" drops from the
    batch entry; sizes multiply, a missing axis counting 1."""
    for r in setup[1]:
        got = r["resolve22"]
        assert got["nondivisible"] == P(None, "model")
        assert got["pod_data"] == P("data", None)
        assert got["sizes"] == [2, 4]


def test_production_meshes_over_a_fake_group():
    """The (16, 16) and (2, 16, 16) meshes' axes and sizes, built over a
    "fake" process group of 512 ranks in this process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import chips, make_production_mesh

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        one = make_production_mesh(device_type="cpu")
        two = make_production_mesh(multi_pod=True, device_type="cpu")
        assert one.mesh_dim_names == ("data", "model") and tuple(one.shape) == (16, 16)
        assert two.mesh_dim_names == ("pod", "data", "model") and tuple(two.shape) == (2, 16, 16)
        assert (chips(one), chips(two)) == (256, 512)
        from repro_torch.dist.sharding import mesh_axis_size, resolve_spec
        assert mesh_axis_size(two, ("pod", "data")) == 32
        assert resolve_spec(P(("pod", "data"), "model"), one, (64, 48)) == P("data", "model")
        assert resolve_spec(P(("pod", "data"), "model"), two, (64, 40)) == \
            P(("pod", "data"), None)
    finally:
        dist.destroy_process_group()


def test_entry_points_default_to_the_card(monkeypatch):
    """``run_ranks`` and the mesh builders default to "cuda" and raise where
    there is no card (before any rank starts), as every entry point of
    the port does."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core.shard_engine import make_walk_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(ranks.staged_case, 2)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        for build in (lambda: make_walk_mesh(2), lambda: make_host_mesh(2, 1),
                      lambda: make_production_mesh()):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build()
        assert make_walk_mesh(4) is None              # too few ranks: the stacked engine
    finally:
        dist.destroy_process_group()


def test_hotness_sync_spmd_matches_replica_list_form(setup):
    """Each rank's matrices after the SPMD sync against the reference's
    ``core.sync.hotness_block_sync`` on the replica list (same sampled
    rows), and the same bytes figure; the sync writes in place."""
    import jax.numpy as jnp
    from repro.core.sync import hotness_block_sync

    inputs, results, _ = setup
    replicas = [(jnp.asarray(inputs["replicas_in"][r]), jnp.asarray(inputs["replicas_out"][r]))
                for r in range(4)]
    want, nbytes = hotness_block_sync(replicas, inputs["starts"], inputs["ends"],
                                      np.random.default_rng(3))
    for r in range(4):
        pi, po, got_bytes, in_place = results[r]["hotness"]
        np.testing.assert_allclose(pi, np.asarray(want[r][0]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(po, np.asarray(want[r][1]), rtol=1e-6, atol=1e-7)
        assert got_bytes == nbytes and in_place
        untouched = np.setdiff1d(np.arange(N_ROWS), inputs["rows"])
        np.testing.assert_array_equal(pi[untouched], inputs["replicas_in"][r][untouched])


def test_compressed_allreduce_matches_reference(setup):
    """Top-|.| with error feedback: the synced sparse part against the
    reference under ``jax.vmap(axis_name=)``, and sparse + residual equal
    to grad + error."""
    import jax
    import jax.numpy as jnp
    from repro.dist.collectives import compressed_allreduce as jax_compressed

    inputs, results, _ = setup
    synced, resid = jax.vmap(lambda g, e: jax_compressed(g, e, 0.5, "data"),
                             axis_name="data")(jnp.asarray(inputs["grad"]),
                                               jnp.asarray(inputs["error"]))
    for r in range(4):
        got_synced, got_resid = results[r]["compressed"]
        np.testing.assert_allclose(got_synced, np.asarray(synced[r]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got_resid, np.asarray(resid[r]))
    assert results[0]["pg_stats"]["collectives"] == 3
    assert results[0]["pg_stats"]["staged_bytes"] == 0          # CPU tensors: nothing staged


def test_pipeline_apply_matches_sequential_composition(setup):
    """Forward within 1e-5 and the stage weights' gradients within 1e-4 of
    the sequential composition of the four stages."""
    inputs, results, _ = setup
    w = torch.from_numpy(inputs["pipe_w"]).requires_grad_(True)
    h = torch.from_numpy(inputs["pipe_x"])
    for s in range(PIPE["stages"]):
        h = torch.tanh(h @ w[s])
    (h ** 2).sum().backward()
    for r in range(4):
        y, g = results[r]["pipeline"]
        np.testing.assert_allclose(y, h.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(g, w.grad.numpy(), atol=1e-4)


def test_k2_wrapper_and_constrain_on_dtensors(setup):
    """K2's wrapper on DTensors placed (batch, heads) runs on the local
    shards, and on (batch, sequence) gathers the sequence first: both equal
    attention on the whole tensors. ``constrain_*`` is the identity with no
    context and a redistribute under one."""
    for r in setup[1]:
        assert r["attend_dtensor"] == (True, True, True, True)
        assert r["constrain"] == (True, True, True)


def test_reshard_to_mesh_between_meshes_bit_equal(setup):
    """A tree placed on the (2, 2) mesh, read back whole and placed on a
    (4, 1) mesh: every rank's shard is its slice of the host tree (a
    one-rank "model" axis replicates), and the whole tree comes back bit
    for bit."""
    from torch.distributed.tensor import Replicate, Shard

    inputs, results, _ = setup
    a, b = inputs["reshard_tree"]["a"], inputs["reshard_tree"]["b"]
    for r in range(4):
        data, model = divmod(r, 2)
        place22, local22 = results[r]["reshard"]["22"]
        assert place22 == (Shard(0), Shard(1))
        np.testing.assert_array_equal(local22, a[2 * data:2 * data + 2, 3 * model:3 * model + 3])
        place41, local41, local_b = results[r]["reshard"]["41"]
        assert place41 == (Shard(0), Replicate())
        np.testing.assert_array_equal(local41, a[r:r + 1])
        np.testing.assert_array_equal(local_b, b[1][2 * r:2 * r + 2])
        whole = results[r]["reshard"]["whole"]
        np.testing.assert_array_equal(whole["a"], a)
        np.testing.assert_array_equal(whole["b"][0], b[0])
        np.testing.assert_array_equal(whole["b"][1], b[1])


def _assert_step_matches(got: dict, params, opt, metrics, who: str) -> None:
    """The mesh step's loss, gradient norm, updated parameters and first
    moments against another step's. Adam's first update is nearly the
    same for any gradient scale (m / sqrt(v) is sign(g)), and the clip
    divides the moments by the norm, so the norm holds the gradient's size
    and the moments ((1 - b1) times the clipped gradient) its direction,
    leaf by leaf."""
    assert abs(got["loss"] - float(metrics["loss"])) <= 1e-5, who
    assert abs(got["gnorm"] - float(metrics["gnorm"])) <= 1e-5 * float(metrics["gnorm"]), who
    for (path, x), (_, y) in zip(flatten(ranks._tree_numpy(params)), flatten(got["params"])):
        np.testing.assert_allclose(y, x, atol=1e-5, err_msg=f"{who} params {path}")
    for (path, x), (_, y) in zip(flatten(ranks._tree_numpy(opt["m"])), flatten(got["m"])):
        np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-8, err_msg=f"{who} m {path}")


@pytest.mark.parametrize("accum", ACCUMS)
def test_train_step_on_two_by_two_mesh(setup, accum):
    """The (2, 2) data x model step against the port's single-process step
    and the reference's ``build_train_step`` on the same weights and batch,
    at step 1 of a 2-step warmup (lr 1.5e-4): loss, gradient norm and
    every updated parameter within 1e-5, the first moments within 1e-4
    relative, and the parameters moved."""
    inputs, results, want = setup
    got = results[0]["train"][accum]
    _assert_step_matches(got, *want[accum]["port"], "port")
    _assert_step_matches(got, *want[accum]["reference"], "reference")
    moved = [np.abs(y - x0).max() for (_, y), (_, x0) in
             zip(flatten(got["params"]), flatten(inputs["train"]["params"]))]
    assert min(moved) > 1e-5


@pytest.mark.cuda
def test_host_staged_gloo_collectives_on_the_card():
    """Two ranks on one card over gloo: the collectives take CUDA tensors,
    stage them through the host, return them on the card, and count the
    staged bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test holds the host-staged transport on the card")
    out = run_ranks(ranks.staged_case, 2, "gloo", "cuda", 120.0, {})
    x = [np.arange(12).reshape(2, 2, 3) + 100 * r for r in range(2)]
    for r, got in enumerate(out):
        assert got["backend"] == "gloo" and got["device"] == ("cuda",) * 3
        np.testing.assert_array_equal(got["summed"], (x[0][0] + x[1][0]).astype(np.float32))
        np.testing.assert_array_equal(got["gathered"],
                                      np.stack([np.arange(6) % 2 == s for s in range(2)]))
        np.testing.assert_array_equal(got["swapped"][0], np.stack([x[s][r] for s in range(2)]))
        assert got["flags"] == [1]
        assert got["stats"]["collectives"] == 4 and got["stats"]["staged_bytes"] > 0


def _paired(ref, port, stacked=False, path=""):
    """{path: (reference spec without its stacking entry, port spec)} over
    the port's layout (per-repetition lists where the reference stacks)."""
    from jax.sharding import PartitionSpec as JP

    if isinstance(ref, JP):
        return {path: (tuple(ref)[1:] if stacked else tuple(ref), port)}
    if isinstance(port, list):
        out = {}
        for i, rep in enumerate(port):
            out.update(_paired(ref, rep, True, f"{path}/{i}"))
        return out
    assert set(ref) == set(port), (sorted(ref), sorted(port))
    out = {}
    for k in ref:
        out.update(_paired(ref[k], port[k], stacked, f"{path}/{k}"))
    return out


def _leaves_by_path(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves_by_path(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, x in enumerate(tree)
                for p, v in _leaves_by_path(x, f"{path}/{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "zamba2_7b", "xlstm_350m", "minicpm3_4b",
                                  "deepseek_v2_lite_16b", "qwen2_moe_a2_7b", "llama3_405b",
                                  "seamless_m4t_large_v2"])
def test_param_and_cache_specs_match_reference(arch):
    """Every parameter and cache leaf's spec is the reference's (whose
    stacked layers carry one more, unsharded, entry), at full size, where
    ``fsdp`` and the KV-head rule show."""
    from repro.configs import get_config as jax_config
    from repro.models import zoo as jax_zoo

    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    jcfg, cfg = jax_config(arch), get_config(arch)
    for ref, port in ((jax_zoo.param_specs(jcfg), zoo.param_specs(cfg)),
                      (jax_zoo.cache_specs(jcfg), zoo.cache_specs(cfg))):
        if isinstance(port, list):                     # encdec caches: a list per layer
            port, ref = {"layers": port}, {"layers": ref}
        pairs = _paired(ref, port)
        assert pairs and all(isinstance(p, P) and tuple(p) == r for r, p in pairs.values())


class _AxesOnly:
    """What the reference's ``resolve_spec`` reads of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape


def test_step_shardings_resolve_as_reference():
    """``train_shardings`` / ``prefill_shardings`` / ``serve_shardings`` of
    reduced yi-6b on a (2, 2) mesh over a "fake" group: every parameter's
    resolved spec is the reference's ``resolve_spec`` of its spec and
    shape, each placement follows its spec, the batch shards over "data",
    the logits over (data, model) and the 4-KV-head cache its sequence."""
    import torch.distributed as dist
    from jax.sharding import PartitionSpec as JP
    from repro.configs import get_reduced as jax_reduced
    from repro.dist.sharding import resolve_spec as jax_resolve
    from repro.models import zoo as jax_zoo
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer, zoo

    cfg = get_reduced("yi-6b")
    batch = zoo.train_batch(cfg, 4, 16, device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_host_mesh(2, 2, "cpu")
        (params_sh, opt_sh, batch_sh, _), _, (pshapes, _) = steps.train_shardings(
            cfg, mesh, {"batch": batch})
        axes = _AxesOnly({"data": 2, "model": 2})
        ref = _paired(jax_zoo.param_specs(jax_reduced("yi_6b")), zoo.param_specs(cfg))
        got, shapes = _leaves_by_path(params_sh), _leaves_by_path(pshapes)
        assert set(got) == set(ref) == set(shapes)
        for path, (r, _) in ref.items():
            sh = got[path]
            assert tuple(sh.spec) == tuple(jax_resolve(JP(*r), axes, tuple(shapes[path].shape)))
            for name, pl in zip(mesh.mesh_dim_names, sh.placements):
                dims = [d for d, e in enumerate(sh.spec) if e == name]
                assert pl == (Shard(dims[0]) if dims else Replicate()), path
        assert batch_sh["tokens"].spec == P("data", None) and opt_sh["count"].spec == P()
        (_, pre_batch_sh), (logits_sh, caches_sh), _ = steps.prefill_shardings(
            cfg, mesh, {"batch": {"tokens": batch["tokens"]}}, max_len=32)
        assert logits_sh.spec == P("data", "model")
        assert pre_batch_sh["tokens"].spec == P("data", None)
        assert caches_sh["group_0"][0]["b0"]["k"].spec == P("data", None, "model", None)
        serve_in = {"caches": transformer.init_caches(cfg, 4, 32, "cpu"),
                    "token": batch["tokens"][:, :1], "cache_len": 8}
        (_, _, token_sh, _), (serve_logits, _), _ = steps.serve_shardings(cfg, mesh, serve_in)
        assert token_sh.spec == P("data", None) and serve_logits.spec == P("data", "model")
    finally:
        dist.destroy_process_group()
