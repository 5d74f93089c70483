"""Smallest-Possible-Answer (SPA) estimation and sound exit bounds.

Paper Sec. 5.4 / Sec. 6, as in ``repro.core.spa``:

- ``split_pairs``    — the (t, a, b) keyword-set splits in popcount order;
- ``spa_cover_dp``   — the paper's cover DP over estimated path-lengths;
- ``nu_lower_bound`` — a provably sound per-keyword-set lower bound on any
  value that can newly appear in a future superstep (exit once
  ``nu[full] >= W_K``).

The DPs run over the 2^m keyword-set lattice and accept any leading batch
axes (a lane axis, for instance) on their tensor arguments.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import INF


@functools.lru_cache(maxsize=None)
def split_pairs(m: int) -> tuple[tuple[int, int, int], ...]:
    """All (t, a, b) with a ⊎ b = t, a < b, nonempty — in popcount(t) order."""
    pairs = []
    masks = sorted(range(1, 1 << m), key=lambda t: (bin(t).count("1"), t))
    for t in masks:
        a = (t - 1) & t
        while a:
            b = t ^ a
            if a < b:
                pairs.append((t, a, b))
            a = (a - 1) & t
    return tuple(pairs)


@functools.lru_cache(maxsize=None)
def submasks(u: int) -> tuple[int, ...]:
    """All nonempty submasks of u."""
    out, s = [], u
    while s:
        out.append(s)
        s = (s - 1) & u
    return tuple(out)


def nu_lower_bound(g: torch.Tensor, e_min: torch.Tensor, m: int
                   ) -> torch.Tensor:
    """Lower bound ``nu[..., t]`` on any value for keyword-set ``t`` that
    first appears at some node in a later superstep.  ``g[..., t]``: the
    global minimum for ``t`` seen so far (INF if never)."""
    nu = torch.clamp(g + e_min, max=INF)
    nu[..., 0] = INF
    for t, a, b in split_pairs(m):
        cand = torch.minimum(
            torch.minimum(nu[..., a] + g[..., b], g[..., a] + nu[..., b]),
            nu[..., a] + nu[..., b])
        nu[..., t] = torch.minimum(nu[..., t], torch.clamp(cand, max=INF))
    return nu


def spa_cover_dp(shat: torch.Tensor, m: int) -> torch.Tensor:
    """Paper Sec. 5.4 DP: cheapest cover of the full keyword set by
    keyword-sets priced at ``shat``:
    ``cost[U] = min(shat[U], min_{T ⊂ U} shat[T] + cost[U \\ T])``;
    returns ``cost[..., full]``."""
    n = 1 << m
    cost = torch.clamp(shat, max=INF)
    cost[..., 0] = 0.0
    order = sorted(range(1, n), key=lambda t: (bin(t).count("1"), t))
    for u in order:
        best = cost[..., u]
        for t in submasks(u):
            if t == u:
                continue
            best = torch.minimum(
                best, torch.clamp(shat[..., t], max=INF) + cost[..., u ^ t])
        cost[..., u] = torch.clamp(best, max=INF)
    return cost[..., (1 << m) - 1]


def spa_ratio(best_found, spa) -> torch.Tensor:
    """Paper Fig. 12: best_found / spa (>= 1 when optimality is unproven);
    0 when the answer is proven optimal (spa >= best_found); inf when
    nothing was found or the bound is degenerate."""
    best = torch.as_tensor(best_found, dtype=torch.float32)
    spa = torch.as_tensor(spa, dtype=torch.float32, device=best.device)
    return torch.where(
        (best >= INF) | (spa <= 0.0) | (spa >= INF),
        torch.full_like(best, float("inf")),
        torch.where(spa >= best, torch.zeros_like(best), best / spa))
