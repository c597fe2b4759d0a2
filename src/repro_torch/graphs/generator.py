"""Synthetic CircuitNet-like design generator.

Reproduces the structural statistics the paper depends on (Table 1 and
Fig. 4): two node types with |cell| ≈ 7.3k-9.8k and |net| ≈ 3.3k-9.1k per
partition, heavy-tailed ``near`` degrees (bulk 30-60, evil rows past 250),
``pin``/``pinned`` degrees of 2-6 with ``pinned = pinᵀ``, and a congestion
label that tracks local wiring density.  The numpy RNG calls are the
reference's, one for one, so a seed gives the identical design.
``scale`` shrinks the partitions for tests.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.graphs.circuit import (EDGE_SCHEMA, CircuitGraph, EdgeSet,
                                        build_circuit_graph, mean_weights)
from repro_torch.graphs.ell import pack_ell_pair

# Table 1 anchor statistics (per-partition node counts for the three designs).
TABLE1 = {
    "small": dict(n_net=(3269, 4628), n_cell=(7347, 7767), graphs=2),
    "medium": dict(n_net=(5331, 7271), n_cell=(9493, 9733), graphs=3),
    "large": dict(n_net=(5883, 9100), n_cell=(9341, 9816), graphs=4),
}


def _powerlaw_degrees(rng, n, bulk=40, tail_max=260, alpha=1.8):
    """Heavy-tailed degrees: lognormal bulk + pareto evil-row tail (Fig. 4)."""
    bulk_deg = rng.lognormal(mean=np.log(bulk), sigma=0.6, size=n)
    evil = rng.random(n) < 0.02
    tail = (rng.pareto(alpha, size=n) + 1.0) * bulk * 2.0
    deg = np.where(evil, tail, bulk_deg)
    return np.clip(deg, 1, tail_max).astype(np.int64)


def generate_partition(rng: np.random.Generator, n_cell: int, n_net: int,
                       feat_cell: int = 16, feat_net: int = 16,
                       near_bulk: int = 40) -> Tuple[Dict, np.ndarray,
                                                     np.ndarray, np.ndarray]:
    """One ~10k-node partition: COO edges, features and congestion label."""
    # near: cells on a plane, each linked to a degree budget of candidates
    # drawn from a window of its x-rank neighbours
    pos = rng.random((n_cell, 2)).astype(np.float32)
    deg = _powerlaw_degrees(rng, n_cell, bulk=near_bulk)
    dst_l, src_l = [], []
    order = np.argsort(pos[:, 0], kind="stable")
    rank_of = np.empty(n_cell, np.int64)
    rank_of[order] = np.arange(n_cell)
    for i in range(n_cell):
        d = int(deg[i])
        lo = max(rank_of[i] - 4 * d, 0)
        hi = min(rank_of[i] + 4 * d + 1, n_cell)
        cand = order[lo:hi]
        cand = cand[cand != i]
        if cand.size == 0:
            continue
        take = min(d, cand.size)
        nbrs = rng.choice(cand, size=take, replace=False)
        dst_l.append(np.full(take, i)), src_l.append(nbrs)
    near_dst = np.concatenate(dst_l)
    near_src = np.concatenate(src_l)

    # pin: each net touches 2-6 cells; (cell, net) pairs deduplicated
    fanout = rng.integers(2, 7, size=n_net)
    pin_net = np.repeat(np.arange(n_net), fanout)
    pin_cell = rng.integers(0, n_cell, size=pin_net.size)
    key = pin_cell.astype(np.int64) * n_net + pin_net
    _, uniq = np.unique(key, return_index=True)
    pin_cell, pin_net = pin_cell[uniq], pin_net[uniq]

    coo = {
        "near": (near_dst, near_src),               # dst=cell, src=cell
        "pin": (pin_net, pin_cell),                 # dst=net,  src=cell
        "pinned": (pin_cell, pin_net),              # dst=cell, src=net (pinᵀ)
    }

    # features and label: wiring density, standardised, noised, squashed
    near_deg = np.bincount(near_dst, minlength=n_cell).astype(np.float32)
    pin_deg = np.bincount(pin_cell, minlength=n_cell).astype(np.float32)
    x_cell = np.stack([pos[:, 0], pos[:, 1],
                       near_deg / near_deg.max(),
                       pin_deg / max(pin_deg.max(), 1.0)], 1)
    x_cell = np.concatenate(
        [x_cell, rng.normal(0, 0.1, (n_cell, feat_cell - 4))], 1
    ).astype(np.float32)
    net_fan = np.bincount(pin_net, minlength=n_net).astype(np.float32)
    x_net = np.concatenate(
        [net_fan[:, None] / max(net_fan.max(), 1.0),
         rng.normal(0, 0.1, (n_net, feat_net - 1))], 1).astype(np.float32)

    dens = near_deg + 2.0 * pin_deg
    dens = (dens - dens.mean()) / (dens.std() + 1e-6)
    y = (dens + rng.normal(0, 0.25, n_cell)).astype(np.float32)
    y = (1.0 / (1.0 + np.exp(-y))).astype(np.float32)
    return coo, x_cell, x_net, y


def generate_design(seed: int, size: str = "small", scale: float = 1.0,
                    feat_cell: int = 16, feat_net: int = 16,
                    n_threads: int = 3) -> List[CircuitGraph]:
    """A design = list of partitions, per Table 1 (host-side graphs)."""
    spec = TABLE1[size]
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(spec["graphs"]):
        lo_c, hi_c = spec["n_cell"]
        lo_n, hi_n = spec["n_net"]
        n_cell = max(int(rng.integers(lo_c, hi_c + 1) * scale), 16)
        n_net = max(int(rng.integers(lo_n, hi_n + 1) * scale), 8)
        coo, xc, xn, y = generate_partition(rng, n_cell, n_net,
                                            feat_cell, feat_net)
        graphs.append(pack_graph_parallel(coo, n_cell, n_net, xc, xn, y,
                                          n_threads=n_threads))
    return graphs


def pack_graph_parallel(coo, n_cell, n_net, xc, xn, y, n_threads: int = 3
                        ) -> CircuitGraph:
    """Pack the three subgraphs concurrently (paper Sec. 3.4: per-subgraph
    CPU init threads); serial when ``n_threads <= 1``."""
    if n_threads <= 1:
        return build_circuit_graph(coo, n_cell, n_net, xc, xn, y)
    sizes = {"cell": n_cell, "net": n_net}

    def pack_one(et):
        dst, src = coo[et]
        s_t, d_t = EDGE_SCHEMA[et]
        n_dst, n_src = sizes[d_t], sizes[s_t]
        adj, adj_t = pack_ell_pair(dst, src, mean_weights(dst, n_dst),
                                   n_dst, n_src)
        return et, EdgeSet(adj=adj, adj_t=adj_t)

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        edges = dict(pool.map(pack_one, list(coo)))
    return CircuitGraph(n_cell=n_cell, n_net=n_net, edges=edges,
                        x_cell=torch.as_tensor(xc), x_net=torch.as_tensor(xn),
                        y_cell=torch.as_tensor(y))
