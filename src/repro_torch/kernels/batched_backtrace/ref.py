"""Plain torch version of the batched backtrace walk
(``csrc/batched_backtrace.cu``): every candidate of every lane walks its
obligation queue, all candidates advancing together one obligation per
round.

The walk is ``repro``'s ``answers/batched.py`` device program (``resolve``
and the cursor queue of ``one``) with the ``vmap`` written out as a batch
axis and the ``while_loop`` as a host loop over rounds that ends when no
candidate is left walking.  Every comparison is the reference's, in f32:
``x + tol``, ``Sa + Sb - x`` and ``x - w`` are single rounded adds.
"""

from __future__ import annotations

import torch

from repro_torch import INF

# Obligation kinds in the record arrays (repro.answers.batched).
PENDING, LEAF, SPLIT, EDGE, FAIL = 0, 1, 2, 3, 4
UNUSED = -1
TOL = 1e-3   # repro_torch.core.reconstruct._TOL


def _first(match: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(any, index of the first True) along the last axis of a bool
    matrix."""
    found = match.any(dim=1)
    return found, match.to(torch.int8).argmax(dim=1)


def _prefix_ok(ok: torch.Tensor) -> torch.Tensor:
    """The host scan's early ``break``: slot j counts only while every
    slot <= j passes (cumprod over the last axis)."""
    return torch.cumprod(ok.to(torch.int32), dim=-1) > 0


def batched_backtrace_ref(S: torch.Tensor, kw: torch.Tensor,
                          cand_idx: torch.Tensor, cand_val: torch.Tensor,
                          indptr: torch.Tensor, esrc: torch.Tensor,
                          ew: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                          buffer: int, degree_cap: int,
                          reads: dict | None = None
                          ) -> dict[str, torch.Tensor]:
    """Decomposition records of every candidate.

    ``S`` f32[L, Vp, 2^m, K] final lane tables; ``kw`` bool[L, m, Vp];
    ``cand_idx`` int32[L, C] flat ``root * K + slot`` cells and
    ``cand_val`` f32[L, C] their values; ``indptr`` int64[V + 1], ``esrc``
    int32[E] and ``ew`` f32[E] the host CSR (ascending neighbour order,
    at least one entry); ``pa``/``pb`` int32[2^m, P] the split pairs of
    ``split_pair_table(m)``.  Returns ``node``, ``kind``, ``child0``,
    ``child1``, ``edge_u`` (int32[L, C, buffer]) and ``fail``
    (bool[L, C]), equal to ``repro``'s records.

    ``reads`` (a dict, filled in): the flat index of every input entry
    that the host's first-match order tests, by input name, as lists of
    tensors (repeats included), and per obligation its walk (``"walk"``)
    and how many split items (p, i) and neighbours its scans took
    (:func:`_note_reads`)."""
    L, _vp, n_sets, K = S.shape
    C = cand_idx.shape[1]
    m = kw.shape[1]
    B, D = buffer, degree_cap
    dev = S.device
    n_edges = esrc.shape[0]
    n_nodes = indptr.shape[0] - 1
    tol = torch.tensor(TOL, dtype=torch.float32, device=dev)
    N = L * C
    lane_of = torch.arange(L, device=dev).repeat_interleave(C)
    root = (cand_idx.reshape(-1) // K).long()
    val = cand_val.reshape(-1)

    def slots(fill, dtype):
        return torch.full((N, B + 1), fill, dtype=dtype, device=dev)

    node, ks, vals = slots(0, torch.long), slots(0, torch.long), \
        slots(0, torch.float32)
    kind, child0, child1, edge_u = (slots(UNUSED, torch.long)
                                    for _ in range(4))
    node[:, 0], ks[:, 0], vals[:, 0], kind[:, 0] = root, n_sets - 1, val, \
        PENDING
    n = torch.ones(N, dtype=torch.long, device=dev)
    it = torch.zeros(N, dtype=torch.long, device=dev)
    fail = ~(val < INF)
    pa, pb = pa.long(), pb.long()
    bitpos = torch.arange(m, device=dev)
    off = torch.arange(D, device=dev)
    while True:
        rows = ((it < n) & ~fail).nonzero().flatten()
        if rows.numel() == 0:
            break
        at = it[rows]
        lane = lane_of[rows]
        v, s, x = node[rows, at], ks[rows, at], vals[rows, at]
        xt = x + tol
        # Leaf: zero value at a node covering every singleton of s.
        bits = (s[:, None] >> bitpos) & 1
        covered = ((bits == 0) | kw[lane[:, None], bitpos, v[:, None]]).all(1)
        leaf = (x <= tol) & covered
        # Split scan over (a-pair, i, j) in the host's order.
        a, b = pa[s], pb[s]                                    # [R, P]
        Sa = S[lane[:, None], v[:, None], a]                   # [R, P, K]
        Sb = S[lane[:, None], v[:, None], b]
        ia_ok = _prefix_ok((Sa <= xt[:, None, None]) & (Sa < INF))
        jb_ok = _prefix_ok(Sb < INF)
        close = ((Sa[..., :, None] + Sb[..., None, :])
                 - x[:, None, None, None]).abs() <= tol
        smatch = ((a > 0)[..., None, None] & ia_ok[..., :, None]
                  & jb_ok[..., None, :] & close)
        s_found, sidx = _first(smatch.reshape(len(rows), -1))
        p_i, i_i, j_i = sidx // (K * K), (sidx // K) % K, sidx % K
        r_ = torch.arange(len(rows), device=dev)
        sa, sb = a[r_, p_i], b[r_, p_i]
        sva, svb = Sa[r_, p_i, i_i], Sb[r_, p_i, j_i]
        # Edge scan over (CSR neighbour, j) in the host's order.
        vc = v.clamp(max=n_nodes)
        start = indptr[vc]
        deg = indptr[(v + 1).clamp(max=n_nodes)] - start
        ei = (start[:, None] + off).clamp(0, n_edges - 1)
        u = esrc[ei].long()                                    # [R, D]
        w = ew[ei]
        emask = (off < deg[:, None]) & (w < INF) & (w <= xt[:, None])
        Su = S[lane[:, None], u, s[:, None]]                   # [R, D, K]
        ju_ok = _prefix_ok(Su < INF)
        eclose = (Su - (x[:, None] - w)[..., None]).abs() <= tol
        e_found, eidx = _first((emask[..., None] & ju_ok & eclose)
                               .reshape(len(rows), -1))
        d_i, ej = eidx // K, eidx % K
        eu, ev = u[r_, d_i], Su[r_, d_i, ej]
        kd = torch.where(leaf, LEAF, torch.where(
            s_found, SPLIT, torch.where(e_found, EDGE, FAIL)))
        if reads is not None:
            _note_reads(reads, S.shape, m, n_nodes, rows, lane, v, s, x, tol,
                        leaf, a, b, ia_ok, jb_ok, s_found, p_i, i_i, j_i,
                        deg, ei, u, emask, ju_ok, e_found, d_i, ej)
        split, edge = kd == SPLIT, kd == EDGE
        c0n = torch.where(split, v, eu)
        c0s = torch.where(split, sa, s)
        c0v = torch.where(split, sva, ev)
        # The queue: children land behind the cursor; slot B absorbs
        # masked and overflowing writes.
        nr = n[rows]
        new_n = nr + torch.where(split, 2, torch.where(edge, 1, 0))
        fail[rows] = fail[rows] | (kd == FAIL) | (new_n > B)
        has0 = split | edge
        idx0 = torch.where(has0, nr.clamp(max=B), B)
        idx1 = torch.where(split, (nr + 1).clamp(max=B), B)
        node[rows, idx0], node[rows, idx1] = c0n, v
        ks[rows, idx0], ks[rows, idx1] = c0s, sb
        vals[rows, idx0], vals[rows, idx1] = c0v, svb
        kind[rows, idx0] = PENDING
        kind[rows, idx1] = PENDING
        kind[rows, at] = kd
        child0[rows, at] = torch.where(has0, idx0, UNUSED)
        child1[rows, at] = torch.where(split, idx1, UNUSED)
        edge_u[rows, at] = torch.where(edge, eu, UNUSED)
        n[rows] = new_n.clamp(max=B)
        it[rows] = at + 1

    def out(t):
        return t[:, :B].to(torch.int32).reshape(L, C, B)

    return {"node": out(node), "kind": out(kind), "child0": out(child0),
            "child1": out(child1), "edge_u": out(edge_u),
            "fail": fail.reshape(L, C)}


def _note_reads(reads: dict, shape, m: int, n_nodes: int, rows, lane, v, s,
                x, tol, leaf, a, b, ia_ok, jb_ok, s_found, p_i, i_i, j_i,
                deg, ei, u, emask, ju_ok, e_found, d_i, ej) -> None:
    """One round's reads in the host's first-match order (the scan of the
    plain walk above, for the walk's byte count,
    ``analysis/roofline.py::backtrace_work``):

    - leaf, where x <= tol: the mask byte of each keyword of s;
    - split, past a leaf: pairs p up to the match (all n_p without one),
      each pair's ``pa`` / ``pb`` entry; of a's row the slots up to the
      first that fails (or up to i at the match), and, where some i
      passed, of b's row the slots up to the first INF (or up to j where
      the match is at i = 0);
    - edge, past a split: the node's two offsets, then neighbours up to
      the match (the whole window without one), each neighbour's ``ew``
      and ``esrc`` entry and, where its weight passes, its row's slots up
      to the first INF (or up to j at the match)."""
    _, vp, n_sets, K = shape
    dev = v.device
    P, D = a.shape[1], ei.shape[1]

    def add(name, t):
        reads.setdefault(name, []).append(t.reshape(-1))

    bitpos = torch.arange(m, device=dev)
    bits = (((s[:, None] >> bitpos) & 1) == 1) & (x <= tol)[:, None]
    add("kw", ((lane[:, None] * m + bitpos) * vp + v[:, None])[bits])
    slots = torch.arange(K, device=dev)
    scan = ~leaf
    n_p = (a > 0).sum(1)
    ps = torch.arange(P, device=dev)
    at = (ps == p_i[:, None]) & s_found[:, None]          # the matched pair
    pm = scan[:, None] & (ps < torch.where(s_found, p_i + 1, n_p)[:, None])
    add("pa", (s[:, None] * P + ps)[pm])
    add("pb", (s[:, None] * P + ps)[pm])
    la, lb = ia_ok.sum(-1), jb_ok.sum(-1)                 # prefix lengths
    last_a = torch.where(at, i_i[:, None], la.clamp(max=K - 1))
    last_b = torch.where(at & (i_i == 0)[:, None], j_i[:, None],
                         lb.clamp(max=K - 1))
    row = (lane * vp + v) * n_sets

    def cells(sets, last, mask):
        flat = (row[:, None] + sets)[..., None] * K + slots
        return flat[mask[..., None] & (slots <= last[..., None])]

    add("S", cells(a, last_a, pm))
    add("S", cells(b, last_b, pm & (at | (la >= 1))))
    edge = scan & ~s_found
    on = edge & (v < n_nodes)
    add("indptr", torch.cat([v[on], v[on] + 1]))
    off = torch.arange(D, device=dev)
    d_lim = torch.where(e_found, d_i + 1, deg.clamp(max=D))
    dm = edge[:, None] & (off < d_lim[:, None])
    add("ew", ei[dm])
    add("esrc", ei[dm])
    atd = (off == d_i[:, None]) & e_found[:, None]
    last_u = torch.where(atd, ej[:, None], ju_ok.sum(-1).clamp(max=K - 1))
    flat = ((lane * vp)[:, None] + u) * n_sets + s[:, None]
    flat = flat[..., None] * K + slots
    add("S", flat[(dm & emask)[..., None] & (slots <= last_u[..., None])])
    add("walk", rows)
    add("split_items", torch.where(
        scan & (n_p > 0), torch.where(s_found, p_i * K + i_i + 1, n_p * K),
        0))
    add("neighbours", torch.where(edge, d_lim, 0))
