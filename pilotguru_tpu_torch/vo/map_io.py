"""Tracker map checkpoints: the JAX package's npz format, version 2 (port
of pilotguru_tpu/vo/map_io.py), so a map saved by either package loads
into the other's tracker.

The reference's ORB-SLAM2 fork serializes its map through protobufs
(System::Serialize); here the tracker state is a few dense arrays and
keyframe records, so one compressed npz holds what resuming tracking or
relocalizing against an earlier map needs. Version 2 adds the local-mapping
state (per-point statistics, stable keyframe ids) and the keyframe-relative
frame anchors that final_trajectory rebuilds poses from; version 1 files
load with neutral defaults.

What the format does not hold, and so starts fresh in a loaded tracker:
the RANSAC generator's state, the points' and keypoints' pyramid levels and
angles (zeros, as in the JAX package), the pending initialization and the
loop-closing cooldown. A deferred local BA is folded into the saved map
(its points and keyframe poses, as ``_apply_pending_ba`` folds it), while
the saving tracker keeps it deferred: a save does not change the run it
observes. Loading drops the tracker's device mirrors of the map and of
keyframe descriptors.
"""

from __future__ import annotations

import numpy as np

from pilotguru_tpu_torch.vo.tracking import FramePose, Keyframe, MonocularTracker

FORMAT_VERSION = 2


def _folded_map(tracker: MonocularTracker):
    """(points, keyframe poses) with a deferred local BA folded in as
    ``_apply_pending_ba`` folds it, leaving the tracker as it is."""
    if tracker._pending_ba is None:
        return tracker.points, [kf.pose6 for kf in tracker.keyframes]
    window, new_poses, pids, new_points = tracker.pending_ba_update()
    folded = {id(kf): pose for kf, pose in zip(window, new_poses)}
    points = tracker.points.copy()
    points[pids] = new_points
    return points, [folded.get(id(kf), kf.pose6) for kf in tracker.keyframes]


def save_tracker_map(tracker: MonocularTracker, path: str) -> None:
    """Write map points, keyframes and the tracker's motion state to
    ``path`` (npz, format v2)."""
    points, kf_poses = _folded_map(tracker)
    frames = tracker.trajectory
    data = {
        "format_version": np.asarray(FORMAT_VERSION),
        "state": np.asarray(tracker.state),
        "points": points,
        "point_desc": np.packbits(tracker.point_desc, axis=1),
        "point_valid": tracker.point_valid,
        "point_visible": tracker.point_visible,
        "point_found": tracker.point_found,
        "point_first_kf": tracker.point_first_kf,
        "point_recent": tracker.point_recent,
        "pose": tracker._pose,
        "motion": tracker._motion,
        "next_kf_id": np.asarray(tracker._next_kf_id),
        "num_keyframes": np.asarray(len(tracker.keyframes)),
        "frame_times": np.asarray([fp.time_usec for fp in frames], np.int64),
        "frame_ids": np.asarray([fp.frame_id for fp in frames], np.int64),
        "frame_poses": (np.stack([fp.pose6 for fp in frames]) if frames
                        else np.zeros((0, 6))),
        "frame_lost": np.asarray([fp.is_lost for fp in frames], bool),
        "frame_ref_kf": np.asarray([fp.ref_kf_id for fp in frames], np.int64),
        "frame_rel": (np.stack([fp.rel6 if fp.rel6 is not None else np.zeros(6)
                                for fp in frames]) if frames else np.zeros((0, 6))),
        "frame_has_rel": np.asarray([fp.rel6 is not None for fp in frames], bool),
    }
    for i, kf in enumerate(tracker.keyframes):
        data[f"kf{i}_pose"] = kf_poses[i]
        data[f"kf{i}_kp_norm"] = kf.kp_norm
        data[f"kf{i}_desc"] = np.packbits(kf.descriptors, axis=1)
        data[f"kf{i}_valid"] = kf.kp_valid
        data[f"kf{i}_map_point"] = kf.map_point
        data[f"kf{i}_inliers"] = np.asarray(kf.num_inliers)
        data[f"kf{i}_id"] = np.asarray(kf.kf_id)
    np.savez_compressed(path, **data)


def load_tracker_map(path: str, tracker: MonocularTracker) -> MonocularTracker:
    """Restore a saved map into ``tracker``, whose camera, config, device
    and dtype stay (the reference's deserializing System constructor reuses
    a loaded vocabulary the same way). Returns the tracker."""
    loaded = np.load(path, allow_pickle=False)
    version = int(loaded["format_version"])
    if version not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported tracker map format {version}")
    points = loaded["points"]
    m = tracker.points.shape[0]
    if points.shape[0] != m:
        raise ValueError("tracker max_map_points does not match the saved map "
                         f"({m} vs {points.shape[0]})")
    tracker.points = points.copy()
    tracker.point_desc = np.unpackbits(loaded["point_desc"], axis=1)[:, :256]
    tracker.point_valid = loaded["point_valid"].copy()
    tracker._pose = loaded["pose"].copy()
    tracker._motion = loaded["motion"].copy()
    tracker.state = str(loaded["state"])
    num_frames = loaded["frame_ids"].shape[0]
    if version >= 2:
        tracker.point_visible = loaded["point_visible"].copy()
        tracker.point_found = loaded["point_found"].copy()
        tracker.point_first_kf = loaded["point_first_kf"].copy()
        tracker.point_recent = loaded["point_recent"].copy()
        tracker._next_kf_id = int(loaded["next_kf_id"])
        ref_kf, rel, has_rel = (loaded["frame_ref_kf"], loaded["frame_rel"],
                                loaded["frame_has_rel"])
    else:
        # v1: neutral statistics (visible == found, so nothing is culled for
        # a stale ratio), every point established, frames unanchored (their
        # absolute poses stand as saved).
        tracker.point_visible = tracker.point_valid.astype(np.int32)
        tracker.point_found = tracker.point_valid.astype(np.int32)
        tracker.point_first_kf = np.where(tracker.point_valid, 0, -1).astype(np.int32)
        tracker.point_recent = np.zeros(m, bool)
        tracker._next_kf_id = int(loaded["num_keyframes"])
        ref_kf = np.full(num_frames, -1, np.int64)
        rel = np.zeros((num_frames, 6))
        has_rel = np.zeros(num_frames, bool)

    tracker.trajectory = [
        FramePose(int(fid), int(ft), pose.copy(), bool(lost), ref_kf_id=int(rk),
                  rel6=r.copy() if hr else None)
        for fid, ft, pose, lost, rk, r, hr in zip(
            loaded["frame_ids"], loaded["frame_times"], loaded["frame_poses"],
            loaded["frame_lost"], ref_kf, rel, has_rel)
    ]
    tracker.keyframes = []
    for i in range(int(loaded["num_keyframes"])):
        kp_norm = loaded[f"kf{i}_kp_norm"].copy()
        k = kp_norm.shape[0]
        tracker.keyframes.append(Keyframe(
            pose6=loaded[f"kf{i}_pose"].copy(),
            kp_norm=kp_norm,
            descriptors=np.unpackbits(loaded[f"kf{i}_desc"], axis=1)[:, :256],
            kp_valid=loaded[f"kf{i}_valid"].copy(),
            map_point=loaded[f"kf{i}_map_point"].copy(),
            num_inliers=int(loaded[f"kf{i}_inliers"]),
            kf_id=int(loaded[f"kf{i}_id"]) if version >= 2 else i,
            kp_level=np.zeros(k, np.int32),
            kp_angle=np.zeros(k, np.float32),
        ))
    tracker._pending_ba = None
    tracker._kf_desc_dev.clear()
    tracker.last_track_kp_rows = np.zeros(0, np.int32)
    tracker._refresh_local_points()  # also drops the device map mirrors
    return tracker
