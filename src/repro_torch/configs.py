"""Configurations the port runs.

- The paper's own DKS experiment configurations (Sec. 7.1).  The two LOD
  datasets are not redistributable; these are synthetic
  structurally-similar stand-ins (power-law degree, Zipf labels) at the
  paper's node/edge scales, plus CPU-scaled variants.  The same values as
  ``repro.configs.dks_paper``.
- The decoder-only LMs the port serves and trains (:func:`get_arch`),
  dense and MoE, with the values of ``repro.configs.chatglm3_6b``,
  ``qwen15_4b``, ``command_r_plus_104b``, ``dbrx_132b`` and
  ``granite_moe_3b_a800m``.
- The DCN-v2 recommender it serves and trains (``get_arch("dcn-v2")``)
  and the recsys shapes, with the values of ``repro.configs.dcn_v2`` and
  ``repro.configs.base``.
- The GNNs it trains (``gat-cora``, ``gin-tu``, ``pna``, ``schnet``) and
  the GNN shapes, with the values of ``repro.configs.{gat_cora, gin_tu,
  pna, schnet}`` and ``repro.configs.base``.
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

DKS_CONFIGS = {c.name: c for c in (SEC_RDFABOUT, BLUK_BNB, SEC_RDFABOUT_CPU,
                                   BLUK_BNB_CPU)}


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """A Mixture-of-Experts FFN (``repro.configs.base.MoESpec``)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """A decoder-only LM, dense or MoE (``repro.configs.base.LMConfig``).
    ``remat``: under grad, each layer's activations are recomputed in the
    backward pass (``torch.utils.checkpoint``) instead of kept."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: MoESpec | None = None
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    remat: bool = True

    def scaled(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "LMConfig":
        """Reduced config: same family/topology, tiny dims (CPU tests)."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        return dataclasses.replace(
            self, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128, vocab=256, head_dim=16, moe=moe,
        )

    def param_count_analytic(self) -> int:
        """Parameters, embeddings included once (twice when untied)."""
        d, l = self.d_model, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2  # q + o
        attn += d * self.n_kv_heads * self.head_dim * 2  # k + v
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        if self.moe is not None:
            ffn = 3 * d * self.moe.d_ff_expert * self.moe.n_experts
            ffn += d * self.moe.n_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ffn + 2 * d) + embed + d


# ChatGLM3-6B [arXiv:2406.12793]: GQA with 2 KV heads, 2d-RoPE (half of
# each head's dims rotate).
CHATGLM3_6B = LMConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128, rotary_pct=0.5)
# Qwen1.5-4B: MHA with QKV bias.
QWEN15_4B = LMConfig(
    name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, head_dim=128, qkv_bias=True)
# Command R+ [hf:CohereForAI/c4ai-command-r-plus]: dense, GQA kv=8, no
# bias.  199.2 GiB of bf16 weights: one card holds it only at a cut depth.
COMMAND_R_PLUS_104B = LMConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab=256000, head_dim=128)
# DBRX [hf:databricks/dbrx-base]: MoE, 16 fine-grained experts, top-4.
# 245.1 GiB of bf16 weights: one card holds it only at a cut depth.
DBRX_132B = LMConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    moe=MoESpec(n_experts=16, top_k=4, d_ff_expert=10752))
# Granite 3.0 3B-A800M [hf:ibm-granite/granite-3.0-3b-a800m]: MoE, 40
# experts, top-8, head dim 64.  6.29 GiB of bf16 weights.
GRANITE_MOE_3B_A800M = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    moe=MoESpec(n_experts=40, top_k=8, d_ff_expert=512))


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """A DCN-v2-style recommender (``repro.configs.base.RecsysConfig``)."""

    name: str
    n_dense: int
    n_sparse: int
    embed_dim: int
    n_cross_layers: int
    mlp_dims: tuple[int, ...]
    vocab_sizes: tuple[int, ...]  # one per sparse field
    param_dtype: str = "float32"

    def smoke(self) -> "RecsysConfig":
        return dataclasses.replace(
            self, embed_dim=8, mlp_dims=(32, 16),
            vocab_sizes=tuple(min(v, 100) for v in self.vocab_sizes),
        )


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str                 # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = (
    RecsysShape("train_batch", "train", 65_536),
    RecsysShape("serve_p99", "serve", 512),
    RecsysShape("serve_bulk", "serve", 262_144),
    RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
)

# DCN-v2 [arXiv:2008.13535]: 13 dense + 26 sparse fields, embed_dim 16,
# 3 cross layers, MLP 1024-1024-512.  Vocab sizes follow the Criteo-1TB
# hashed regime: a few huge fields (10^7), a tail of small ones.
DCN_V2 = RecsysConfig(
    name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16, n_cross_layers=3,
    mlp_dims=(1024, 1024, 512),
    vocab_sizes=(
        10_000_000, 10_000_000, 5_000_000,
        1_000_000, 1_000_000, 1_000_000, 500_000, 500_000,
        100_000, 100_000, 100_000, 50_000, 50_000, 50_000, 10_000, 10_000,
        10_000, 5_000, 5_000, 1_000, 1_000, 1_000, 500, 100, 100, 50,
    ))



@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """A graph neural network (``repro.configs.base.GNNConfig``)."""

    name: str
    family: str               # "gat" | "schnet" | "gin" | "pna"
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregators: tuple[str, ...] = ("sum",)
    scalers: tuple[str, ...] = ("identity",)
    rbf: int = 0              # schnet radial basis size
    cutoff: float = 0.0
    learnable_eps: bool = False
    n_classes: int = 16
    param_dtype: str = "float32"
    mp_dtype: str = "float32"   # message passing: "bfloat16" halves the
    # edge gathers' bytes (repro's production cells)

    def smoke(self) -> "GNNConfig":
        return dataclasses.replace(self, d_hidden=min(self.d_hidden, 16),
                                   rbf=min(self.rbf, 16) if self.rbf else 0)


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str                # "full_graph" | "minibatch" | "molecule"
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    batch_graphs: int = 0


GNN_SHAPES = (
    GNNShape("full_graph_sm", "full_graph", 2_708, 10_556, d_feat=1_433),
    GNNShape("minibatch_lg", "minibatch", 232_965, 114_615_892,
             d_feat=602, batch_nodes=1_024, fanout=(15, 10)),
    GNNShape("ogb_products", "full_graph", 2_449_029, 61_859_140, d_feat=100),
    GNNShape("molecule", "molecule", 30, 64, d_feat=16, batch_graphs=128),
)

# GAT [arXiv:1710.10903]: 2 layers, d_hidden 8, 8 heads.
GAT_CORA = GNNConfig(
    name="gat-cora", family="gat", n_layers=2, d_hidden=8, n_heads=8,
    aggregators=("attn",), n_classes=7)
# GIN [arXiv:1810.00826]: 5 layers, d_hidden 64, sum aggregator, learnable
# eps.
GIN_TU = GNNConfig(
    name="gin-tu", family="gin", n_layers=5, d_hidden=64,
    aggregators=("sum",), learnable_eps=True, n_classes=2)
# PNA [arXiv:2004.05718]: 4 layers, d_hidden 75, aggregators
# mean-max-min-std, scalers identity-amplification-attenuation.
PNA = GNNConfig(
    name="pna", family="pna", n_layers=4, d_hidden=75,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"), n_classes=16)
# SchNet [arXiv:1706.08566]: 3 interactions, d_hidden 64, rbf 300, cutoff
# 10.
SCHNET = GNNConfig(
    name="schnet", family="schnet", n_layers=3, d_hidden=64, rbf=300,
    cutoff=10.0)

ARCHS = {c.name: c for c in (CHATGLM3_6B, QWEN15_4B, COMMAND_R_PLUS_104B,
                              DBRX_132B, GRANITE_MOE_3B_A800M, DCN_V2,
                              GAT_CORA, GIN_TU, PNA, SCHNET)}


def get_arch(arch_id: str) -> LMConfig | RecsysConfig | GNNConfig:
    """The configuration named ``arch_id`` in :data:`ARCHS` (the LMs,
    DCN-v2 and the GNNs); any other name raises ``KeyError``."""
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not in the port; it has "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]
