"""Sim(3) pose-graph optimization for loop closing (port of
pilotguru_tpu/vo/posegraph.py).

Replaces Optimizer::OptimizeEssentialGraph of the reference: the graph is
small (keyframe chain + loop edges, tens of nodes), so one dense
fixed-iteration LM over the flattened [K*7] parameter vector solves it,
with forward-mode autodiff Jacobians (one solve per closure).

Conventions: node k holds S_k, the world->camera Sim(3) of keyframe k. An
edge (i, j) carries the measured relative transform M_ij ~= S_i o S_j^-1
(camera j frame -> camera i frame). Sequential edges take M from the
pre-correction poses; loop edges from the Sim(3) fit (vo/loopclosing.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pilotguru_tpu_torch.solvers.levenberg_marquardt import levenberg_marquardt
from pilotguru_tpu_torch.vo import sim3


class PoseGraphResult(NamedTuple):
    nodes7: torch.Tensor  # [K, 7] optimized Sim(3) poses
    final_loss: torch.Tensor  # []


def optimize_pose_graph(
    nodes7,  # [K, 7]
    edge_i,  # [E] int
    edge_j,  # [E] int
    edge_meas7,  # [E, 7]
    edge_valid,  # [E] bool (invalid edges weigh zero)
    num_iters: int = 30,
) -> PoseGraphResult:
    """Dense LM over all node poses; a 1e3 prior pins node 0 (rotation,
    translation and scale) to its initial pose, the gauge."""
    num_nodes = nodes7.shape[0]
    weights = edge_valid.to(nodes7.dtype)[:, None]
    edge_i, edge_j = edge_i.long(), edge_j.long()
    anchor = nodes7[0]

    def residuals(flat):
        nodes = flat.reshape(num_nodes, 7)
        rel = sim3.compose(nodes[edge_i], sim3.inverse(nodes[edge_j]))
        res = weights * sim3.error_vector(rel, edge_meas7)
        prior = 1e3 * (nodes[0] - anchor)
        return torch.cat([res.reshape(-1), prior])

    result = levenberg_marquardt(residuals, nodes7.reshape(-1), num_iters=num_iters)
    return PoseGraphResult(result.x.reshape(num_nodes, 7), result.loss)


def chain_edges(nodes7):
    """Sequential-odometry edges M_{k,k+1} = S_k o S_{k+1}^-1 of the current
    node estimates: (edge_i [K-1], edge_j [K-1], meas [K-1, 7])."""
    k = nodes7.shape[0]
    edge_i = torch.arange(0, k - 1, device=nodes7.device)
    edge_j = edge_i + 1
    meas = sim3.compose(nodes7[edge_i], sim3.inverse(nodes7[edge_j]))
    return edge_i, edge_j, meas
