"""The paper's own experiment configurations (Sec. 7.1).

The two LOD datasets are not redistributable; these are synthetic
structurally-similar stand-ins (power-law degree, Zipf labels) at the
paper's node/edge scales, plus CPU-scaled variants.  The same values as
``repro.configs.dks_paper``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DKSBenchConfig:
    """The paper's own experiment configuration (synthetic LOD stand-ins)."""

    name: str
    n_nodes: int
    n_edges: int
    vocab: int
    tau: int = 1001
    seed: int = 7


# Paper scale: sec-rdfabout runs end to end on one H100 (chip_smoke.py).
SEC_RDFABOUT = DKSBenchConfig(
    name="sec-rdfabout", n_nodes=460_451, n_edges=500_384, vocab=50_000)
BLUK_BNB = DKSBenchConfig(
    name="bluk-bnb", n_nodes=16_100_000, n_edges=46_600_000, vocab=500_000)

# CPU-scaled stand-ins.
SEC_RDFABOUT_CPU = DKSBenchConfig(
    name="sec-rdfabout-cpu", n_nodes=46_000, n_edges=50_000, vocab=5_000)
BLUK_BNB_CPU = DKSBenchConfig(
    name="bluk-bnb-cpu", n_nodes=80_000, n_edges=230_000, vocab=8_000)
