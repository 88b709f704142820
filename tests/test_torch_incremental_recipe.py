"""The reference's acceptance recipe for the incremental refresh, on the
port: rmat 2,048 at degree 10 (seed 3), ``num_shards=2``, 5% churn (seed
1). Apart from ``test_torch_incremental.py`` so that a test worker can run
it beside that file (~110 s on one CPU thread)."""

import numpy as np
import torch

from repro_torch.core.api import EmbedConfig, embed_graph, refresh_embedding
from repro_torch.core.incremental import affected_roots
from repro_torch.eval import link_prediction_auc
from repro_torch.graph.generators import churn_batch, rmat_graph, undirected_edges

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)


def test_refresh_acceptance_recipe():
    """rmat 2,048 at degree 10 (seed 3), 5% churn (seed 1), num_shards=2:
    the port re-walks <= 30% of the vertices, keeps every slot of an
    unaffected root bit-identical, and lands within 0.02 AUC of its
    scratch run on the mutated graph and of the reference's refresh."""
    from repro.core.api import EmbedConfig as JaxConfig
    from repro.core.api import embed_graph as jax_embed
    from repro.core.api import refresh_embedding as jax_refresh
    from repro.graph.generators import churn_batch as jax_churn
    from repro.graph.generators import rmat_graph as jax_rmat

    kw = dict(dim=32, epochs=1, lr=0.05, delta=1e-3, max_len=40, min_len=10, window=6,
              negatives=4)
    g = rmat_graph(2048, 10, seed=3, device="cpu")
    _, _, state = embed_graph(g, EmbedConfig(**kw), num_shards=2, return_state=True,
                              device="cpu")
    pipe = state.refresher.pipeline
    walks_before, roots_before = pipe.ring.walks.clone(), pipe._slot_root.copy()
    batch = churn_batch(g, 0.05, seed=1)
    assert batch.num_changes >= int(0.045 * len(undirected_edges(g)))
    phi1, _, stats = refresh_embedding(state, batch)
    assert stats.affected_frac <= 0.30, stats.affected_frac

    aff = state.refresher.last_affected_mask
    changed = np.concatenate([batch.insert, batch.delete])
    written = roots_before >= 0
    np.testing.assert_array_equal(
        aff, affected_roots(walks_before[torch.from_numpy(np.nonzero(written)[0])],
                            roots_before[written], changed, np.unique(changed), g.num_nodes))
    kept = torch.from_numpy(np.nonzero(written & ~aff[np.maximum(roots_before, 0)])[0])
    assert len(kept) > 0 and torch.equal(walks_before[kept], pipe.ring.walks[kept])

    g2 = state.graph
    phi_s, _ = embed_graph(g2, EmbedConfig(**kw, rng_mode="vertex"), num_shards=2,
                           device="cpu")
    auc = lambda phi: link_prediction_auc(g2, phi, np.random.default_rng(7))
    auc_refresh, auc_scratch = auc(phi1), auc(phi_s)
    assert abs(auc_refresh - auc_scratch) <= 0.02, (auc_refresh, auc_scratch)
    assert auc_refresh > 0.8

    ref_g = jax_rmat(2048, 10, seed=3)
    _, _, ref_state = jax_embed(ref_g, JaxConfig(**kw), num_shards=2, return_state=True)
    ref_phi, _, ref_stats = jax_refresh(ref_state, jax_churn(ref_g, 0.05, seed=1))
    assert abs(auc_refresh - auc(np.asarray(ref_phi))) <= 0.02
    assert abs(stats.affected_frac - ref_stats.affected_frac) <= 0.05
