"""Loop detection + closure (port of pilotguru_tpu/vo/loopclosing.py, which
replaces ORB-SLAM2's LoopClosing thread).

Candidate retrieval is exhaustive descriptor voting: the new keyframe's
descriptors are matched against every old keyframe's device-resident
descriptors, stacked a few keyframes at a time (the reference's
replace-the-DBoW2-index sweep). Verification is RANSAC-Umeyama over matched
3D-3D map points plus a reprojection polish (vo/sim3.py), and the
correction is one dense Sim(3) pose-graph solve over the keyframe chain and
the loop edge (vo/posegraph.py), after which map points are re-expressed
through their reference keyframe's correction (CorrectLoop's landmark
adjustment).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pilotguru_tpu_torch.solvers.levenberg_marquardt import levenberg_marquardt
from pilotguru_tpu_torch.vo import matching, posegraph, sim3
from pilotguru_tpu_torch.vo.pose import huber_weights, project, rotvec_to_matrix
from pilotguru_tpu_torch.vo.tracking import np_rotvec_to_matrix

# Old keyframes matched per batched call of the vote sweep: bounds the
# [batch, K, K] Hamming tables (16 MB each at 2000 features).
VOTE_BATCH = 4


def _vote_counts(cur_desc, cur_valid, kf_desc_stack, kf_valid_stack):
    """Good-match votes of the current keyframe against a [N, K, 256] stack
    of stored keyframe descriptors: [N] int64 on the stack's device."""
    votes = []
    for lo in range(0, kf_desc_stack.shape[0], VOTE_BATCH):
        m = matching.match_descriptors(
            cur_desc, kf_desc_stack[lo : lo + VOTE_BATCH],
            valid_a=cur_valid, valid_b=kf_valid_stack[lo : lo + VOTE_BATCH],
            max_distance=matching.HAMMING_LOW, ratio=0.75,
        )
        votes.append(m.valid.sum(-1))
    return torch.cat(votes)


def start_vote_sweep(tracker, kf):
    """Dispatch the candidate vote sweep without waiting for it. Returns
    (votes_dev, old_kf_ids) for detect_candidate, or None when there are no
    old keyframes. Keyframes culled before the votes are read drop out by
    kf_id (votes depend only on descriptors)."""
    config = tracker.config
    # [:-k] with k == 0 would slice to nothing; spell the bound out so
    # loop_exclude_recent == 0 means "every non-current keyframe".
    old = tracker.keyframes[: len(tracker.keyframes) - config.loop_exclude_recent]
    if not old:
        return None
    # The stored keyframes' descriptors are device-resident (uploaded once
    # per keyframe, MonocularTracker.kf_descriptors_device): the sweep moves
    # no descriptor from the host.
    descs, valids = zip(*(tracker.kf_descriptors_device(okf) for okf in old))
    cur_desc, cur_valid = tracker.kf_descriptors_device(kf)
    votes_dev = _vote_counts(cur_desc, cur_valid, torch.stack(descs), torch.stack(valids))
    return votes_dev, [okf.kf_id for okf in old]


def detect_candidate(tracker, kf, vote_handle=None) -> Optional[int]:
    """Best loop candidate index (into tracker.keyframes) or None.

    Old keyframes = all but the trailing ``loop_exclude_recent`` (those share
    covisibility with the current keyframe: matching them is tracking, not a
    loop). ``vote_handle``: a start_vote_sweep result to consume instead of
    sweeping now."""
    config = tracker.config
    if vote_handle is None:
        vote_handle = start_vote_sweep(tracker, kf)
    if vote_handle is None:
        return None
    votes_dev, old_kf_ids = vote_handle
    by_id = {okf.kf_id: okf for okf in tracker.keyframes}
    votes_all = votes_dev.cpu().numpy()
    old, votes = [], []
    for vote, kf_id in zip(votes_all, old_kf_ids):
        okf = by_id.get(kf_id)
        if okf is not None:
            old.append(okf)
            votes.append(vote)
    if not old:
        return None
    votes = np.asarray(votes)

    # Covisibility exclusion (LoopClosing::DetectLoop skips keyframes
    # connected to the current one): a keyframe sharing >= 5 map points
    # with the current one is the local neighbourhood seen slightly earlier.
    cur_pids = set(int(p) for p in kf.map_point[kf.map_point >= 0])
    for i, okf in enumerate(old):
        shared = sum(1 for p in okf.map_point[okf.map_point >= 0] if int(p) in cur_pids)
        if shared >= 5:
            votes[i] = -1

    best = int(np.argmax(votes))
    if votes[best] < config.loop_min_match_count:
        return None
    for idx, existing in enumerate(tracker.keyframes):
        if existing is old[best]:
            return idx
    return None


def refine_sim3(
    m0,  # [7] initial current-camera -> candidate-camera Sim(3)
    cand_pose6,  # [6] world -> candidate camera
    cur_pose6,  # [6] world -> current camera
    pts_cand_world,  # [P, 3] the candidate's map points
    obs_cur,  # [P, 2] their observations in the current keyframe
    pts_cur_world,  # [P, 3] the current keyframe's map points
    obs_cand,  # [P, 2] their observations in the candidate keyframe
    pair_valid,  # [P] bool
    lm_iters: int = 20,
    huber_delta: float = 0.006,
):
    """Reprojection polish of the loop transform (Optimizer::OptimizeSim3
    semantics): the candidate's points projected into the current keyframe
    through M^-1 and the current points into the candidate through M, with
    a unit prior pinning log_s to the 3D-3D fit (reprojection hardly sees
    scale when the relative translation is small)."""

    def to_cam(pose6, pts):
        return pts @ rotvec_to_matrix(pose6[:3]).T + pose6[3:]

    cand_cam = to_cam(cand_pose6, pts_cand_world)
    cur_cam = to_cam(cur_pose6, pts_cur_world)
    w = pair_valid.to(m0.dtype)

    def residuals(m):
        # A batch of one: forward-mode autodiff promotes a 0-dim float32
        # tensor combined with a Python float to float64.
        in_cur = sim3.act(sim3.inverse(m[None]), cand_cam)
        r1 = project(in_cur) - obs_cur
        in_cand = sim3.act(m[None], cur_cam)
        r2 = project(in_cand) - obs_cand
        w1 = w * huber_weights(torch.linalg.vector_norm(r1, dim=-1), huber_delta)
        w2 = w * huber_weights(torch.linalg.vector_norm(r2, dim=-1), huber_delta)
        bad = (in_cur[:, 2] <= 1e-6) | (in_cand[:, 2] <= 1e-6)
        r1 = torch.where(bad[:, None], torch.ones_like(r1), r1)
        r2 = torch.where(bad[:, None], torch.ones_like(r2), r2)
        scale_prior = 1.0 * (m[6:7] - m0[6:7])
        return torch.cat([(r1 * w1[:, None]).reshape(-1),
                          (r2 * w2[:, None]).reshape(-1), scale_prior])

    return levenberg_marquardt(residuals, m0, num_iters=lm_iters).x


def _bucket(n: int, step: int) -> int:
    return max(-(-n // step) * step, step)


def relative_sim3(tracker, kf, cand):
    """Fit the loop transform M = S_cand o S_cur^-1 from matched 3D-3D map
    points (Sim3Solver semantics): a landmark that drifted into two map
    points, one seen from each keyframe, gives one correspondence between
    their camera-frame positions. RANSAC draws from the tracker's seeded
    generator. Returns (sim7 [7] host, num_inliers) or None."""
    cur_desc, _ = tracker.kf_descriptors_device(kf)
    cand_desc, _ = tracker.kf_descriptors_device(cand)
    m = matching.match_descriptors(
        cur_desc, cand_desc,
        valid_a=tracker._t(kf.kp_valid & (kf.map_point >= 0)),
        valid_b=tracker._t(cand.kp_valid & (cand.map_point >= 0)),
        max_distance=matching.HAMMING_LOW, ratio=0.8,
    )
    idx = m.index.cpu().numpy()
    rows = np.nonzero(m.valid.cpu().numpy())[0]
    pid_cur = kf.map_point[rows]
    pid_cand = cand.map_point[idx[rows]]
    keep = (
        (pid_cur >= 0) & (pid_cand >= 0)
        & tracker.point_valid[np.clip(pid_cur, 0, None)]
        & tracker.point_valid[np.clip(pid_cand, 0, None)]
        # Self-pairs (both keypoints on the same map point) agree with the
        # drifted poses by construction and would pull the fit to identity:
        # the loop error lives in the duplicated landmarks only.
        & (pid_cur != pid_cand)
    )
    rows, pid_cur, pid_cand = rows[keep], pid_cur[keep], pid_cand[keep]
    if rows.size < tracker.config.loop_min_inliers:
        return None

    def to_cam(pose6, pts):
        return pts @ np_rotvec_to_matrix(pose6[:3]).T + pose6[3:]

    a = to_cam(kf.pose6, tracker.points[pid_cur])  # current camera frame
    b = to_cam(cand.pose6, tracker.points[pid_cand])  # candidate camera frame
    # Padded to a bucket of 64 correspondences as the reference pads them:
    # padded rows are invalid and weigh 1e-12 in the polish.
    n = _bucket(rows.size, 64)
    pa = np.zeros((n, 3))
    pb = np.zeros((n, 3))
    va = np.zeros(n, bool)
    pa[: rows.size] = a
    pb[: rows.size] = b
    va[: rows.size] = True
    fit = sim3.ransac_umeyama(
        tracker._t(pa), tracker._t(pb), tracker._t(va), generator=tracker._generator,
    )
    fit_inliers = fit.inliers.cpu().numpy()
    num_fit_inliers = int(fit_inliers.sum())
    if num_fit_inliers < tracker.config.loop_min_inliers:
        return None

    # Reprojection polish on the RANSAC inliers: image observations are far
    # tighter than triangulated positions, and the pose graph is only as
    # good as this edge.
    inl = fit_inliers[: rows.size]
    r_in = rows[inl]
    refined = refine_sim3(
        fit.sim7,
        tracker._t(cand.pose6),
        tracker._t(kf.pose6),
        tracker._t(tracker.points[pid_cand[inl]]),
        tracker._t(kf.kp_norm[r_in]),
        tracker._t(tracker.points[pid_cur[inl]]),
        tracker._t(cand.kp_norm[idx[r_in]]),
        tracker._t(np.ones(r_in.size, bool)),
    )
    return refined.cpu().numpy().astype(np.float64), num_fit_inliers


def close_loop(tracker, cur_idx: int, cand_idx: int, loop_meas7: np.ndarray):
    """Pose-graph correction (CorrectLoop + OptimizeEssentialGraph
    semantics): chain edges from the current keyframe poses plus the loop
    edge, one dense Sim(3) LM solve, then keyframe poses and map points
    updated in place."""
    kfs = tracker.keyframes
    k = len(kfs)
    nodes = tracker._t(np.stack([np.concatenate([kf.pose6, [0.0]]) for kf in kfs]))
    edge_i, edge_j, meas = posegraph.chain_edges(nodes)
    dev = nodes.device
    edge_i = torch.cat([edge_i, torch.tensor([cand_idx], device=dev)])
    edge_j = torch.cat([edge_j, torch.tensor([cur_idx], device=dev)])
    meas = torch.cat([meas, tracker._t(loop_meas7)[None]])
    valid = torch.ones(edge_i.shape[0], dtype=torch.bool, device=dev)
    corrected = posegraph.optimize_pose_graph(
        nodes, edge_i, edge_j, meas, valid, num_iters=30
    ).nodes7

    # Map points through their reference keyframe's correction
    # X' = S_new^-1(S_old(X)) (LoopClosing.cc: Swc_corrected * Scw_old * X).
    # The reference keyframe is the point's creator; the last keyframe for
    # points whose creator was culled.
    by_id = {kf.kf_id: i for i, kf in enumerate(kfs)}
    pids = np.nonzero(tracker.point_valid)[0]
    ref_idx = torch.as_tensor(
        [by_id.get(int(tracker.point_first_kf[p]), k - 1) for p in pids],
        dtype=torch.int64, device=dev,
    )
    cam = sim3.act(nodes[ref_idx], tracker._t(tracker.points[pids]))
    fixed = sim3.act(sim3.inverse(corrected[ref_idx]), cam)
    tracker.points[pids] = fixed.cpu().numpy().astype(np.float64)

    # Keyframe poses: Sim(3) -> SE(3) with the scale folded into t.
    poses6 = sim3.to_pose6(corrected).cpu().numpy().astype(np.float64)
    for i, kf in enumerate(kfs):
        kf.pose6 = poses6[i]
    # The tracker's live pose follows the corrected last keyframe.
    tracker._pose = kfs[-1].pose6.copy()


def detect_and_close(tracker, kf, vote_handle=None) -> Optional[int]:
    """LoopClosing::Run for one new keyframe. Returns the candidate
    keyframe index when a loop was accepted and the map corrected, else
    None. ``vote_handle``: an already dispatched start_vote_sweep result."""
    cand_idx = detect_candidate(tracker, kf, vote_handle)
    if cand_idx is None:
        return None
    # A closure is being attempted (rare): fold in the deferred local BA
    # first, so the fit and the correction run on refined geometry.
    tracker._apply_pending_ba()
    cand = tracker.keyframes[cand_idx]
    fit = relative_sim3(tracker, kf, cand)
    if fit is None:
        return None
    loop_meas7, _ = fit
    close_loop(tracker, len(tracker.keyframes) - 1, cand_idx, loop_meas7)
    return cand_idx
