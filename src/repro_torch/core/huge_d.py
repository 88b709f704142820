"""HuGE-D -- the paper's distributed baseline (section 2.3), the JAX
package's ``core/huge_d.py`` over the port's ``WalkSpec`` and
``generate_corpus``.

Same information-oriented walk as DistGER, but with the full-path
computation mechanism: H and R are recomputed from the whole path at every
step (O(L) a step, O(L^2) a walk) and cross-machine messages carry the
path (24 + 8L bytes). On the walk engine this is the ``fullpath`` info
mode; this module pins the configurations so benchmarks and tests name one
canonical baseline object.
"""

from __future__ import annotations

from repro_torch.core.corpus import Corpus, generate_corpus
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import WalkSpec


def huge_d_spec(max_len: int = 100, min_len: int = 20, mu: float = 0.995,
                reg_start: int = 16) -> WalkSpec:
    return WalkSpec(max_len=max_len, min_len=min_len, mu=mu, info_mode="fullpath",
                    reg_start=reg_start)


def distger_spec(max_len: int = 100, min_len: int = 20, mu: float = 0.995,
                 reg_start: int = 16) -> WalkSpec:
    """Production spec: suffix regression from L0 = 16 reproduces HuGE's
    reported adaptive walk lengths (~63% shorter than the routine L = 80);
    reg_start = 1 recovers the paper-literal full series."""
    return WalkSpec(max_len=max_len, min_len=min_len, mu=mu, info_mode="incom",
                    reg_start=reg_start)


def incremental_spec(max_len: int = 100, min_len: int = 20, mu: float = 0.995,
                     reg_start: int = 16) -> WalkSpec:
    """``distger_spec`` with vertex-keyed walk draws, the spec a
    refresh-capable deployment runs from day one: walks are a function of
    (key, round, source vertex), so after edge churn ``core.incremental``
    re-walks just the affected vertices, bit-identical to a from-scratch
    round on the mutated graph."""
    return WalkSpec(max_len=max_len, min_len=min_len, mu=mu, info_mode="incom",
                    reg_start=reg_start, rng_mode="vertex")


def routine_spec(fixed_len: int = 80) -> WalkSpec:
    """KnightKing-style routine configuration (L = 80, r = 10)."""
    return WalkSpec(max_len=fixed_len, info_mode="fixed", fixed_len=fixed_len)


def generate_corpus_huge_d(graph, **kwargs) -> Corpus:
    """``generate_corpus`` under ``huge_d_spec()`` and the HuGE policy
    unless ``spec`` or ``policy`` (a policy or its name) is given."""
    kwargs.setdefault("spec", huge_d_spec())
    policy = kwargs.setdefault("policy", "huge")
    if isinstance(policy, str):
        kwargs["policy"] = make_policy(policy)
    return generate_corpus(graph, **kwargs)
