"""Tensor assembly for CAD-120, Bimanual Actions and MPHOI-72
(counterpart of ``tggcn/data/assembly.py``), in numpy.

Per-video raw records (as ``data/loading.py`` reads them) become the
positional input and target tuples of the 2G-GCN: features with the
geometric context (poses and object boxes with their velocities, scaled
/100 or /1000), NaN-padded in time; labels at full FPS for test data and
downsampled otherwise, -1 where missing; end-of-segment flags; the
distance tensors of distance-based attention; the steps per clip.

With a positive sigma, as stage 2 trains (``conf/models/2G-GCN_stage2.yaml``
``segmentation_loss.sigma``), the last end flag of each entity is dropped
and the flags are smoothed by a Gaussian over time; -1 marks padding and
stays -1 (``assemble_segmentation_targets``). These helpers return new
arrays and leave their inputs as they were.
"""

from typing import List, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter1d

from tggcn_torch.utils.itertools import run_length_encoding

# --------------------------------------------------------------------------
# Generic helpers
# --------------------------------------------------------------------------


def downsample(array: np.ndarray, downsampling: int) -> np.ndarray:
    """Temporal stride slice [downsampling-1::downsampling] (reference :570)."""
    return array[downsampling - 1::downsampling]


def _velocity(seq: np.ndarray, scale: float = 100.0) -> np.ndarray:
    """Per-frame forward difference * scale with zeros at the final frame."""
    velo = np.zeros_like(seq)
    if len(seq) > 1:
        velo[:-1] = (seq[1:] - seq[:-1]) * scale
    return velo


def _pad_objects(boxes: np.ndarray, max_objects: int) -> np.ndarray:
    """Zero-pad per-frame object boxes (T, O, 4) -> (T, max_objects, 4)."""
    t, o = boxes.shape[0], boxes.shape[1]
    if o == max_objects:
        return boxes
    out = np.zeros((t, max_objects, boxes.shape[2]), dtype=boxes.dtype)
    out[:, :o] = boxes
    return out


def _pad_time_features(videos: List[np.ndarray], max_len: int) -> np.ndarray:
    """Stack variable-length (T_i, ...) arrays into NaN-padded (N, max_len, ...)."""
    feature_shape = videos[0].shape[1:]
    out = np.full((len(videos), max_len) + feature_shape, np.nan, dtype=np.float32)
    for m, v in enumerate(videos):
        out[m, : v.shape[0]] = v
    return out


def segmentation_from_output_class(y: np.ndarray, segmentation_type: str = "input") -> np.ndarray:
    """Derive 0/1 end-of-segment flags from per-frame class labels.

    Reference semantics (vhoi/data_loading.py:885-896): a frame is an end
    frame (1) when the next frame's label differs; the last frame is always an
    end frame; missing (-1) labels become 1 in 'input' mode and stay -1 in
    'output' mode; interior frames are 0.
    """
    x = np.array(y, dtype=np.float32)
    original_missing = np.asarray(y) == -1.0
    x = np.where(original_missing, np.nan, x)
    end = (x[:, 1:] - x[:, :-1]) != 0.0
    end = np.concatenate([end, np.full_like(end[:, -1:], True)], axis=1)
    x[end] = 1.0
    x[~end & ~np.isnan(x)] = 0.0
    x[np.isnan(x)] = 1.0
    if segmentation_type == "output":
        x[original_missing] = -1.0
    return x


def ignore_last_step_end_flag(x: np.ndarray) -> np.ndarray:
    """(N, T) end flags with the final end flag of each example set to 0."""
    x = np.array(x)
    has_end = (x == 1.0).any(axis=1)
    last_end = x.shape[1] - 1 - np.argmax((x == 1.0)[:, ::-1], axis=1)
    rows = np.nonzero(has_end)[0]
    x[rows, last_end[rows]] = 0.0
    return x


def ignore_last_step_end_flag_general(x: np.ndarray) -> np.ndarray:
    """ignore_last_step_end_flag for each entity of (N, T, E) end flags."""
    x = np.array(x)
    for e in range(x.shape[-1]):
        x[:, :, e] = ignore_last_step_end_flag(x[:, :, e])
    return x


def smooth_segmentation(x: np.ndarray, sigma: float) -> np.ndarray:
    """End flags (N, T, ...) smoothed over time by a Gaussian of width
    sigma (zero beyond the clip), scaled by 2.5 sigma and clipped to [0, 1];
    -1 padding kept. sigma 0 returns the flags unchanged."""
    x = np.array(x)
    if sigma:
        missing = x == -1.0
        x[missing] = 0.0
        x = np.clip(gaussian_filter1d(x, sigma=sigma, axis=1, mode="constant") * 2.5 * sigma,
                    0.0, 1.0)
        x[missing] = -1.0
    return x


def anticipation_labels_from_rle(labels: np.ndarray) -> list:
    """Next-segment label per frame via RLE expansion (reference :745-757)."""
    rle = list(run_length_encoding(labels))
    out = []
    for (_, previous_length), (next_label, _) in zip(rle[:-1], rle[1:]):
        out += [next_label] * previous_length
    return out


def apply_positional_encoding(x_features: np.ndarray, dimension: int = 2048) -> np.ndarray:
    """Sin/cos positional encoding of (x, y) locations (reference :998-1016).

    Defined (but never called at runtime) by the reference; kept for API
    parity. x_features (*, 2) -> (*, dimension), dimension divisible by 4.
    """
    m = np.array([1e4], dtype=np.float32)
    indices = 4 * np.arange(0, dimension // 4, dtype=np.float32) / dimension
    factor = 1 / (m ** indices)
    result = []
    for coord_index in range(2):
        pre = x_features[..., coord_index:coord_index + 1] * factor
        result.append(np.sin(pre))
        result.append(np.cos(pre))
    return np.concatenate(result, axis=-1)


def context_features(pose_seqs: List[np.ndarray], obb_seq: np.ndarray,
                     velocity_scale: float = 100.0) -> np.ndarray:
    """Shared geometric context vector per frame.

    For each frame, [pose_i, velocity(pose_i)] for each entity pose sequence
    (T, K, 2), followed by [obb_points, velocity(obb_points)] for the padded
    object box corner points (T, P, 2). Matches the hstack/reshape layout of
    the reference loops (e.g. vhoi/data_loading.py:697-721).
    """
    parts = []
    for pose in pose_seqs + [obb_seq]:
        velo = _velocity(pose, velocity_scale)
        pv = np.concatenate([pose, velo], axis=-1)  # (T, K, 4)
        parts.append(pv.reshape(pv.shape[0], -1))
    return np.concatenate(parts, axis=-1).astype(np.float32)


# --------------------------------------------------------------------------
# CAD-120
# --------------------------------------------------------------------------

CAD120_MAX_OBJECTS = 5
BIMANUAL_MAX_OBJECTS = 9
MPHOI_MAX_OBJECTS = 4
BIMANUAL_HAND_KEYPOINTS = [0, 4, 8, 12, 16, 20]
MPHOI_BODY_KEYPOINTS = [1, 2, 4, 6, 7, 11, 13, 14, 27]


def assemble_cad120_human(data: list, downsampling: int = 1, test_data: bool = False):
    """CAD-120 human stream: ROI 2048 + pose/velocity 36 + object-box/velocity 40 = 2124.

    data items: [skeleton_feats, object_feats, skeleton_bb, objects_bb, skeleton_pose, video_data]
    (reference assemble_frame_level_recurrent_human, vhoi/data_loading.py:562-650).
    """
    xs_human = []
    max_len = 0
    for human_features, _, _, objects_bb, skeleton_pose, _ in data:
        max_len = max(max_len, human_features.shape[0])
        feats = downsample(human_features, downsampling)
        pose = downsample(skeleton_pose, downsampling) / 100.0       # (T, 9, 2)
        obb = downsample(objects_bb, downsampling) / 100.0           # (T, O, 4)
        obb = _pad_objects(obb, CAD120_MAX_OBJECTS).reshape(len(obb), 10, 2)
        ctx = context_features([pose], obb)
        xs_human.append(np.concatenate([feats, ctx], axis=-1).astype(np.float32))
    max_len_ds = max(v.shape[0] for v in xs_human)
    x_human = _pad_time_features(xs_human, max_len_ds)
    xs = [x_human]

    y_rec = np.full([len(data), max_len], -1, dtype=np.int64)
    y_pred = np.full_like(y_rec, -1)
    for m, (_, _, _, _, _, video_data) in enumerate(data):
        for segment in video_data:
            start, end = segment.start_frame, segment.end_frame
            if start is None or end is None:
                continue
            start -= 1
            end -= 1
            y_rec[m, start:end + 1] = segment.subactivity - 1
            nxt = segment.next_subactivity
            y_pred[m, start:end + 1] = nxt - 1 if nxt is not None else -1
    x_seg = segmentation_from_output_class(y_rec[:, downsampling - 1::downsampling], "input")
    xs.append(x_seg)
    if not test_data:
        y_rec = y_rec[:, downsampling - 1::downsampling]
        y_pred = y_pred[:, downsampling - 1::downsampling]
    y_seg = segmentation_from_output_class(y_rec, "output")
    return xs, [y_rec, y_pred, y_seg]


def assemble_cad120_objects(data: list, downsampling: int = 1, test_data: bool = False):
    """CAD-120 object stream (reference :899-942)."""
    xs_objects = []
    max_len = max_num_objects = 0
    for _, object_features, _, _, _, _ in data:
        max_len = max(max_len, object_features.shape[0])
        max_num_objects = max(max_num_objects, object_features.shape[1])
        xs_objects.append(downsample(object_features, downsampling))
    max_len_ds = max(v.shape[0] for v in xs_objects)
    x_objects = np.full([len(data), max_len_ds, max_num_objects, xs_objects[-1].shape[-1]],
                        np.nan, dtype=np.float32)
    x_mask = np.zeros([len(data), max_num_objects], dtype=np.float32)
    for m, x_o in enumerate(xs_objects):
        x_objects[m, : x_o.shape[0], : x_o.shape[1]] = x_o
        x_mask[m, : x_o.shape[1]] = 1.0
    xs = [x_objects, x_mask]

    y_rec = np.full([len(data), max_len, max_num_objects], -1, dtype=np.int64)
    y_pred = np.full_like(y_rec, -1)
    for m, (_, _, _, _, _, video_data) in enumerate(data):
        for segment in video_data:
            start, end = segment.start_frame, segment.end_frame
            if start is None or end is None:
                continue
            start -= 1
            end -= 1
            for object_id, affordance in segment.object_affordance.items():
                y_rec[m, start:end + 1, object_id - 1] = affordance - 1
            for object_id, affordance in segment.next_object_affordance.items():
                y_pred[m, start:end + 1, object_id - 1] = affordance - 1
    x_seg = segmentation_from_output_class(y_rec[:, downsampling - 1::downsampling], "input")
    xs.append(x_seg)
    if not test_data:
        y_rec = y_rec[:, downsampling - 1::downsampling]
        y_pred = y_pred[:, downsampling - 1::downsampling]
    y_seg = segmentation_from_output_class(y_rec, "output")
    return xs, [y_rec, y_pred, y_seg]


# --------------------------------------------------------------------------
# Bimanual Actions
# --------------------------------------------------------------------------


def assemble_bimanual_human(data: list, downsampling: int = 1, test_data: bool = False):
    """Bimanual hands stream: ROI 2048 + shared context 120 = 2168 per hand.

    data items: [lh_feats, rh_feats, obj_feats, gt, lh_bb, rh_bb, obj_bbs, lh_pose, rh_pose]
    (reference :653-766).
    """
    xs_hands = []
    max_len = 0
    kp = BIMANUAL_HAND_KEYPOINTS
    for lh, rh, _, _, _, _, objects_bb, lh_pose, rh_pose in data:
        max_len = max(max_len, lh.shape[0])
        lh_f = downsample(lh, downsampling)
        rh_f = downsample(rh, downsampling)
        lhp = downsample(lh_pose, downsampling)[:, kp] / 100.0
        rhp = downsample(rh_pose, downsampling)[:, kp] / 100.0
        obb = downsample(objects_bb, downsampling) / 100.0
        obb = _pad_objects(obb, BIMANUAL_MAX_OBJECTS).reshape(len(obb), 18, 2)
        ctx = context_features([lhp, rhp], obb)
        both = np.stack([np.concatenate([lh_f, ctx], axis=-1),
                         np.concatenate([rh_f, ctx], axis=-1)], axis=1)  # (T, 2, 2168)
        xs_hands.append(both.astype(np.float32))
    max_len_ds = max(v.shape[0] for v in xs_hands)
    x_hs = _pad_time_features(xs_hands, max_len_ds)
    xs = [x_hs]

    y_rec = np.full([len(data), max_len, 2], -1, dtype=np.int64)
    y_pred = np.full_like(y_rec, -1)
    for m, item in enumerate(data):
        gt = item[3]
        for e, hand in enumerate(["left_hand", "right_hand"]):
            y = np.asarray(gt[hand])
            y_rec[m, : len(y), e] = y
            y_p = anticipation_labels_from_rle(y)
            y_pred[m, : len(y_p), e] = y_p
    x_seg = segmentation_from_output_class(y_rec[:, downsampling - 1::downsampling], "input")
    xs.append(x_seg)
    if not test_data:
        y_rec = y_rec[:, downsampling - 1::downsampling]
        y_pred = y_pred[:, downsampling - 1::downsampling]
    y_seg = segmentation_from_output_class(y_rec, "output")
    return xs, [y_rec, y_pred, y_seg]


def assemble_entity_objects(data: list, objects_index: int = 2, downsampling: int = 1):
    """Object feature stream for bimanual/mphoi (reference :945-982)."""
    xs_objects = []
    max_num_objects = 0
    for item in data:
        objects = item[objects_index]
        max_num_objects = max(max_num_objects, objects.shape[1])
        xs_objects.append(downsample(objects, downsampling))
    max_len_ds = max(v.shape[0] for v in xs_objects)
    x_objects = np.full([len(data), max_len_ds, max_num_objects, xs_objects[-1].shape[-1]],
                        np.nan, dtype=np.float32)
    x_mask = np.zeros([len(data), max_num_objects], dtype=np.float32)
    for m, x_o in enumerate(xs_objects):
        x_objects[m, : x_o.shape[0], : x_o.shape[1]] = x_o
        x_mask[m, : x_o.shape[1]] = 1.0
    return [x_objects, x_mask]


# --------------------------------------------------------------------------
# MPHOI-72
# --------------------------------------------------------------------------


def assemble_mphoi_human(data: list, downsampling: int = 1, test_data: bool = False):
    """MPHOI humans stream: ROI 2048 + shared context 104 = 2152 per human.

    data items: [h1_feats, h2_feats, obj_feats, gt, h1_bb, h2_bb, obj_bbs, h1_pose, h2_pose]
    (reference :769-882). Pose and boxes are divided by 1000 (4K pixel space).
    """
    xs_humans = []
    max_len = 0
    kp = MPHOI_BODY_KEYPOINTS
    for h1, h2, _, _, _, _, objects_bb, h1_pose, h2_pose in data:
        max_len = max(max_len, h1.shape[0])
        h1_f = downsample(h1, downsampling)
        h2_f = downsample(h2, downsampling)
        h1p = downsample(h1_pose, downsampling)[:, kp] / 1000.0
        h2p = downsample(h2_pose, downsampling)[:, kp] / 1000.0
        obb = downsample(objects_bb, downsampling) / 1000.0
        obb = _pad_objects(obb, MPHOI_MAX_OBJECTS).reshape(len(obb), 8, 2)
        ctx = context_features([h1p, h2p], obb)
        both = np.stack([np.concatenate([h1_f, ctx], axis=-1),
                         np.concatenate([h2_f, ctx], axis=-1)], axis=1)  # (T, 2, 2152)
        xs_humans.append(both.astype(np.float32))
    max_len_ds = max(v.shape[0] for v in xs_humans)
    x_hs = _pad_time_features(xs_humans, max_len_ds)
    xs = [x_hs]

    y_rec = np.full([len(data), max_len, 2], -1, dtype=np.int64)
    y_pred = np.full_like(y_rec, -1)
    for m, item in enumerate(data):
        gt = item[3]
        for e, human in enumerate(["Human1", "Human2"]):
            y = np.asarray(gt[human])
            y_rec[m, : len(y), e] = y
            y_p = anticipation_labels_from_rle(y)
            y_pred[m, : len(y_p), e] = y_p
    x_seg = segmentation_from_output_class(y_rec[:, downsampling - 1::downsampling], "input")
    xs.append(x_seg)
    if not test_data:
        y_rec = y_rec[:, downsampling - 1::downsampling]
        y_pred = y_pred[:, downsampling - 1::downsampling]
    y_seg = segmentation_from_output_class(y_rec, "output")
    return xs, [y_rec, y_pred, y_seg]


# --------------------------------------------------------------------------
# Distance tensors (for distance-based attention)
# --------------------------------------------------------------------------


def _centroid(boxes: np.ndarray) -> np.ndarray:
    x = (boxes[..., :1] + boxes[..., 2:3]) / 2
    y = (boxes[..., 1:2] + boxes[..., 3:4]) / 2
    return np.concatenate([x, y], axis=-1)


def _pad_dists(all_dists: List[np.ndarray], max_len: int, rows: int, cols: int) -> np.ndarray:
    out = np.full([len(all_dists), max_len, rows, cols], np.nan, dtype=np.float32)
    for m, d in enumerate(all_dists):
        out[m, : d.shape[0], : d.shape[1], : d.shape[2]] = d
    return out


def assemble_cad120_human_object_distances(data: list, downsampling: int = 1) -> np.ndarray:
    """CAD-120 human-object centroid distances (reference :1019-1038).

    Note: the reference normalises only the skeleton centroid by the image
    dims (objects stay in pixel space); reproduced as-is for parity.
    """
    dims = np.array([640, 480], dtype=np.float32)
    max_len, max_num_objects = 0, 0
    all_dists = []
    for _, _, skeleton_bb, objects_bb, _, _ in data:
        skeleton_bb = downsample(skeleton_bb, downsampling)
        objects_bb = downsample(objects_bb, downsampling)
        objects_centroid = _centroid(objects_bb)
        skeleton_centroid = _centroid(skeleton_bb) / dims
        dists = np.linalg.norm(objects_centroid - np.expand_dims(skeleton_centroid, 1), ord=2, axis=-1)
        all_dists.append(np.expand_dims(dists, 1))
        max_len = max(max_len, objects_bb.shape[0])
        max_num_objects = max(max_num_objects, objects_bb.shape[1])
    return _pad_dists(all_dists, max_len, 1, max_num_objects)


def assemble_cad120_object_object_distances(data: list, downsampling: int = 1) -> np.ndarray:
    """CAD-120 object-object distances, unnormalised (reference :1112-1132)."""
    max_len, max_num_objects = 0, 0
    all_dists = []
    for _, _, _, objects_bb, _, _ in data:
        objects_bb = downsample(objects_bb, downsampling)
        centroids = _centroid(objects_bb)
        dists = np.linalg.norm(centroids[:, None, :, :] - centroids[:, :, None, :], ord=2, axis=-1)
        all_dists.append(dists)
        max_len = max(max_len, objects_bb.shape[0])
        max_num_objects = max(max_num_objects, objects_bb.shape[1])
    return _pad_dists(all_dists, max_len, max_num_objects, max_num_objects)


def assemble_pair_human_human_distances(data: list, bb_indices: Tuple[int, int], dims: np.ndarray,
                                        downsampling: int = 1) -> np.ndarray:
    """Two-entity human-human distances (reference :1041-1060, :1135-1154)."""
    i, j = bb_indices
    max_len = 0
    all_dists = []
    for item in data:
        a_bb = downsample(item[i], downsampling)
        b_bb = downsample(item[j], downsampling)
        a_c = _centroid(a_bb) / dims
        b_c = _centroid(b_bb) / dims
        all_dists.append(np.linalg.norm(a_c - b_c, ord=2, axis=-1))
        max_len = max(max_len, a_bb.shape[0])
    out = np.full([len(all_dists), max_len, 2, 2], np.nan, dtype=np.float32)
    for m, d in enumerate(all_dists):
        out[m, : d.shape[0], 0, 1] = d
        out[m, : d.shape[0], 1, 0] = d
        out[m, : d.shape[0], 0, 0] = 0.0
        out[m, : d.shape[0], 1, 1] = 0.0
    return out


def assemble_pair_human_object_distances(data: list, bb_indices: Tuple[int, int], objects_bb_index: int,
                                         dims: np.ndarray, downsampling: int = 1) -> np.ndarray:
    """Two-entity human-object distances (reference :1063-1085, :1157-1179)."""
    i, j = bb_indices
    max_len, max_num_objects = 0, 0
    a_dists, b_dists = [], []
    for item in data:
        a_c = _centroid(downsample(item[i], downsampling)) / dims
        b_c = _centroid(downsample(item[j], downsampling)) / dims
        o_c = _centroid(downsample(item[objects_bb_index], downsampling)) / dims
        a_dists.append(np.linalg.norm(o_c - np.expand_dims(a_c, 1), ord=2, axis=-1))
        b_dists.append(np.linalg.norm(o_c - np.expand_dims(b_c, 1), ord=2, axis=-1))
        max_len = max(max_len, a_dists[-1].shape[0])
        max_num_objects = max(max_num_objects, o_c.shape[1])
    out = np.full([len(a_dists), max_len, 2, max_num_objects], np.nan, dtype=np.float32)
    for m, (a_d, b_d) in enumerate(zip(a_dists, b_dists)):
        out[m, : a_d.shape[0], 0, : a_d.shape[1]] = a_d
        out[m, : b_d.shape[0], 1, : b_d.shape[1]] = b_d
    return out


def assemble_normalised_object_object_distances(data: list, objects_bb_index: int, dims: np.ndarray,
                                                downsampling: int = 1) -> np.ndarray:
    """Normalised object-object distances (reference :1088-1109, :1182-1203)."""
    max_len, max_num_objects = 0, 0
    all_dists = []
    for item in data:
        o_c = _centroid(downsample(item[objects_bb_index], downsampling)) / dims
        dists = np.linalg.norm(o_c[:, None, :, :] - o_c[:, :, None, :], ord=2, axis=-1)
        all_dists.append(dists)
        max_len = max(max_len, o_c.shape[0])
        max_num_objects = max(max_num_objects, o_c.shape[1])
    return _pad_dists(all_dists, max_len, max_num_objects, max_num_objects)


def assemble_num_steps(data: list, downsampling: int = 1) -> np.ndarray:
    """Downsampled frame counts per video, float32 (reference :1206-1212)."""
    return np.array([len(downsample(item[0], downsampling)) for item in data], dtype=np.float32)


# --------------------------------------------------------------------------
# Full per-dataset tuple assembly (positional contracts of SURVEY.md §2.4)
# --------------------------------------------------------------------------


def _expand_human_dim(tensors: list, indices: list) -> list:
    for index in indices:
        tensors[index] = np.expand_dims(tensors[index], axis=2)
    return tensors


def assemble_cad120_tensors(data: list, model_name: str, sigma: float = 0.0,
                            downsampling: int = 1, test_data: bool = False):
    """CAD-120 xs/ys tuples (reference assemble_tensors, :436-471)."""
    if model_name not in {"2G-GCN", "cad120_baseline"}:
        raise ValueError(f"{model_name} is not an option for model name.")
    xs, ys = assemble_cad120_human(data, downsampling=downsampling, test_data=test_data)
    if model_name == "2G-GCN":
        if sigma:
            ys[2] = ignore_last_step_end_flag(ys[2])
        ys[2] = smooth_segmentation(ys[2], sigma)
        ys_budget = ys[2]
        xs_objects, ys_objects = assemble_cad120_objects(data, downsampling=downsampling,
                                                         test_data=test_data)
        if sigma:
            ys_objects[2] = ignore_last_step_end_flag_general(ys_objects[2])
        ys_objects[2] = smooth_segmentation(ys_objects[2], sigma)
        ys_objects_budget = ys_objects[2]
        xs_ho_dists = assemble_cad120_human_object_distances(data, downsampling=downsampling)
        xs_oo_dists = assemble_cad120_object_object_distances(data, downsampling=downsampling)
        xs = xs[:1] + xs_objects[:2] + xs[1:] + xs_objects[2:]
        ys = ([ys_budget] + [ys_objects_budget] + ys[2:] + ys_objects[2:] +
              ys[:2] + ys_objects[:2] +
              ys[:2] + ys_objects[:2])
        xs_steps = assemble_num_steps(data, downsampling=downsampling)
        xs += [xs_ho_dists, xs_oo_dists, xs_steps]
        xs = _expand_human_dim(xs, [0, 3])
        ys = _expand_human_dim(ys, [0, 2, 4, 5, 8, 9])
    else:  # cad120_baseline
        xs_objects, ys_objects = assemble_cad120_objects(data, downsampling=downsampling,
                                                         test_data=test_data)
        xs = xs[:1] + xs_objects[:2]
        xs = _expand_human_dim(xs, [0])
        ys = ys[:1] + ys_objects[:1]
        ys = _expand_human_dim(ys, [0])
    return xs, ys


def assemble_bimanual_tensors(data: list, model_name: str, sigma: float = 0.0,
                              downsampling: int = 1, test_data: bool = False):
    """Bimanual xs/ys tuples (reference assemble_bimanual_tensors, :480-501)."""
    xs, ys = assemble_bimanual_human(data, downsampling=downsampling, test_data=test_data)
    xs_objects = assemble_entity_objects(data, objects_index=2, downsampling=downsampling)
    dims = np.array([640, 480], dtype=np.float32)
    if model_name == "2G-GCN":
        if sigma:
            ys[2] = ignore_last_step_end_flag_general(ys[2])
        ys[2] = smooth_segmentation(ys[2], sigma)
        ys_budget = ys[2]
        xs_hh = assemble_pair_human_human_distances(data, (4, 5), dims, downsampling)
        xs_ho = assemble_pair_human_object_distances(data, (4, 5), 6, dims, downsampling)
        xs_oo = assemble_normalised_object_object_distances(data, 6, dims, downsampling)
        xs_steps = assemble_num_steps(data, downsampling=downsampling)
        xs = xs[:1] + xs_objects + xs[1:] + [xs_hh, xs_ho, xs_oo, xs_steps]
        ys = [ys_budget] + ys[2:] + ys[:2]
        ys += ys[-2:]
    elif model_name == "bimanual_baseline":
        xs, ys = xs[:1], ys[:1]
        xs = xs + xs_objects
    else:
        raise ValueError(f"Bimanual code not implemented for {model_name} yet.")
    return xs, ys


def assemble_mphoi_tensors(data: list, model_name: str, sigma: float = 0.0,
                           downsampling: int = 1, test_data: bool = False):
    """MPHOI xs/ys tuples (reference assemble_mphoi_tensors, :504-522)."""
    if model_name != "2G-GCN":
        raise ValueError(f"MPHOI code not implemented for {model_name} yet.")
    xs, ys = assemble_mphoi_human(data, downsampling=downsampling, test_data=test_data)
    xs_objects = assemble_entity_objects(data, objects_index=2, downsampling=downsampling)
    dims = np.array([3840, 2160], dtype=np.float32)
    if sigma:
        ys[2] = ignore_last_step_end_flag_general(ys[2])
    ys[2] = smooth_segmentation(ys[2], sigma)
    ys_budget = ys[2]
    xs_hh = assemble_pair_human_human_distances(data, (4, 5), dims, downsampling)
    xs_ho = assemble_pair_human_object_distances(data, (4, 5), 6, dims, downsampling)
    xs_oo = assemble_normalised_object_object_distances(data, 6, dims, downsampling)
    xs_steps = assemble_num_steps(data, downsampling=downsampling)
    xs = xs[:1] + xs_objects + xs[1:] + [xs_hh, xs_ho, xs_oo, xs_steps]
    ys = [ys_budget] + ys[2:] + ys[:2]
    ys += ys[-2:]
    return xs, ys


def assemble_segmentation_targets(flags: np.ndarray, sigma: float) -> np.ndarray:
    """The targets of the segmentation loss from (N, T, E) end flags."""
    if sigma:
        flags = ignore_last_step_end_flag_general(flags)
    return smooth_segmentation(flags, sigma)
