"""Synthetic dataset generators for tests and card runs (counterpart of
``tggcn/data/synthetic.py``: the same draws from the same seed).

Produce on-disk datasets with the exact file layout the loaders expect
(JSON/pickle ground truth + per-stream feature stores, written as .npz
bundles readable by tggcn_torch.data.loading.open_store). Shapes and value ranges
mimic the real datasets (SURVEY.md §2.4) at configurable scale.
"""

import json
import os
import pickle

import numpy as np

from tggcn_torch.data.cad120classes import CAD120Video


def _write_store(npz_path: str, arrays: dict, store_format: str) -> str:
    """Write a {'vid/stream': array} feature store as .npz or zarr-v2.

    store_format='zarr' produces a real DirectoryStore (one group per video,
    reference layout per vhoi/data_loading.py:27-31) via data/zarr_lite.py,
    exercising the same on-disk format as the distributed datasets.
    """
    if store_format == "npz":
        np.savez(npz_path, **arrays)
        return npz_path
    if store_format != "zarr":
        raise ValueError(f"unknown store_format {store_format!r}")
    from tggcn_torch.data import zarr_lite

    path = npz_path[:-len(".npz")] + ".zarr"
    root = zarr_lite.create_group(path)
    for key, value in arrays.items():
        zarr_lite.write_array(root, key, value)
    return path


def _segments(rng, num_frames, num_classes, min_seg=5):
    """Random label segmentation covering [0, num_frames)."""
    labels = []
    while len(labels) < num_frames:
        seg_len = int(rng.integers(min_seg, max(min_seg + 1, num_frames // 3)))
        label = int(rng.integers(0, num_classes))
        labels += [label] * seg_len
    return labels[:num_frames]


def generate_mphoi_dataset(root_dir: str, num_videos: int = 8, min_len: int = 36,
                           max_len: int = 90, num_objects: int = 4, seed: int = 0,
                           store_format: str = "npz",
                           subject_pairs=("45", "12", "23", "13")) -> dict:
    """Synthetic MPHOI-72-shaped dataset. Returns config-style path dict.

    The default subject pairs mix the Subject45 test fold with pairs disjoint
    from subjects {4, 5} so both the group-exclusion training filter and the
    test filter keep videos. For a full 3-fold protocol run pass
    ("45", "25", "14", "23", "13", "12") so every CV fold has test videos
    AND non-overlapping training pairs.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root_dir, exist_ok=True)
    subject_pairs = list(subject_pairs)
    gt, feats, obbs, hbbs, hps = {}, {}, {}, {}, {}
    for i in range(num_videos):
        vid = f"Subject{subject_pairs[i % len(subject_pairs)]}-task-take{i}"
        t = int(rng.integers(min_len, max_len + 1))
        gt[vid] = {
            "Human1": _segments(rng, t, 13),
            "Human2": _segments(rng, t, 13),
        }
        for h in ("Human1", "Human2"):
            feats[f"{vid}/{h}"] = rng.normal(size=(t, 2048)).astype(np.float32)
            hbbs[f"{vid}/{h}"] = (rng.uniform(0, 2000, size=(t, 4))).astype(np.float32)
            hps[f"{vid}/{h}"] = (rng.uniform(0, 3000, size=(t, 28, 2))).astype(np.float32)
        feats[f"{vid}/objects"] = rng.normal(size=(t, num_objects, 2048)).astype(np.float32)
        obbs[f"{vid}/objects"] = (rng.uniform(0, 2000, size=(t, num_objects, 4))).astype(np.float32)

    paths = {
        "name": "mphoi",
        "path": os.path.join(root_dir, "MPHOI", "mphoi_ground_truth_labels.json"),
        "path_zarr": os.path.join(root_dir, "MPHOI", "faster_rcnn.npz"),
        "path_obb_zarr": os.path.join(root_dir, "MPHOI", "object_bounding_boxes.npz"),
        "path_hbb_zarr": os.path.join(root_dir, "MPHOI", "human_bounding_boxes.npz"),
        "path_hps_zarr": os.path.join(root_dir, "MPHOI", "human_pose.npz"),
    }
    os.makedirs(os.path.dirname(paths["path"]), exist_ok=True)
    with open(paths["path"], "w") as f:
        json.dump(gt, f)
    for key, arrays in (("path_zarr", feats), ("path_obb_zarr", obbs),
                        ("path_hbb_zarr", hbbs), ("path_hps_zarr", hps)):
        paths[key] = _write_store(paths[key], arrays, store_format)
    with open(os.path.join(root_dir, "MPHOI", "mphoi_action_id_to_action_name.json"), "w") as f:
        json.dump({str(i): f"action_{i}" for i in range(13)}, f)
    return paths


def generate_bimanual_dataset(root_dir: str, num_videos: int = 8, min_len: int = 36,
                              max_len: int = 90, num_objects: int = 5, seed: int = 0,
                              store_format: str = "npz") -> dict:
    """Synthetic Bimanual-Actions-shaped dataset (with a 15-FPS video mixed in)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root_dir, "BimanualActions")
    os.makedirs(base, exist_ok=True)
    gt, fps_map, feats, bbs, hps = {}, {}, {}, {}, {}
    for i in range(num_videos):
        subject = (i % 6) + 1
        vid = f"subject_{subject}-task-take{i}"
        t = int(rng.integers(min_len, max_len + 1))
        fps_map[vid] = 15 if i == 1 else 30
        gt[vid] = {
            "left_hand": _segments(rng, t, 14),
            "right_hand": _segments(rng, t, 14),
        }
        for h in ("left_hand", "right_hand"):
            feats[f"{vid}/{h}"] = rng.normal(size=(t, 2048)).astype(np.float32)
            bbs[f"{vid}/{h}"] = (rng.uniform(0, 600, size=(t, 4))).astype(np.float32)
            hps[f"{vid}/{h}"] = (rng.uniform(0, 600, size=(t, 21, 2))).astype(np.float32)
        feats[f"{vid}/objects"] = rng.normal(size=(t, num_objects, 2048)).astype(np.float32)
        bbs[f"{vid}/objects"] = (rng.uniform(0, 600, size=(t, num_objects, 4))).astype(np.float32)

    paths = {
        "name": "bimanual",
        "path": os.path.join(base, "bimacs_ground_truth_labels.json"),
        "path_zarr": os.path.join(base, "faster_rcnn.npz"),
        "path_bb_zarr": os.path.join(base, "bounding_boxes.npz"),
        "path_hp_zarr": os.path.join(base, "hands_pose.npz"),
        "video_id_to_video_fps": os.path.join(base, "bimacs_video_id_to_video_fps.json"),
    }
    with open(paths["path"], "w") as f:
        json.dump(gt, f)
    with open(paths["video_id_to_video_fps"], "w") as f:
        json.dump(fps_map, f)
    for key, arrays in (("path_zarr", feats), ("path_bb_zarr", bbs),
                        ("path_hp_zarr", hps)):
        paths[key] = _write_store(paths[key], arrays, store_format)
    with open(os.path.join(base, "bimacs_action_id_to_action_name.json"), "w") as f:
        json.dump({str(i): f"action_{i}" for i in range(14)}, f)
    return paths


def generate_cad120_dataset(root_dir: str, num_videos: int = 8, min_len: int = 36,
                            max_len: int = 90, num_objects: int = 3, seed: int = 0,
                            store_format: str = "npz") -> dict:
    """Synthetic CAD-120-shaped dataset (pickle annotations + feature store)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root_dir, "CAD-120")
    os.makedirs(base, exist_ok=True)
    subjects = ["Subject1", "Subject3", "Subject4", "Subject5"]
    data, vid_to_subject, stores = {}, {}, {}
    for i in range(num_videos):
        vid = f"{5000 + i}"
        vid_to_subject[vid] = subjects[i % len(subjects)]
        t = int(rng.integers(min_len, max_len + 1))
        video = CAD120Video()
        num_segments = max(2, t // 18)
        boundaries = np.sort(rng.choice(np.arange(2, t), size=num_segments - 1, replace=False))
        starts = np.concatenate([[1], boundaries + 1])
        ends = np.concatenate([boundaries, [t]])
        n_obj = int(rng.integers(1, num_objects + 1))
        for s, (start, end) in enumerate(zip(starts, ends)):
            segment = video[s]
            segment.start_frame = int(start)
            segment.end_frame = int(end)
            segment.subactivity = int(rng.integers(1, 11))
            segment.object_affordance = {o + 1: int(rng.integers(1, 13)) for o in range(n_obj)}
        video.from_dict_to_list()
        video.update_next_labels()
        data[vid] = video
        stores[f"{vid}/skeleton"] = rng.normal(size=(t, 2048)).astype(np.float32)
        stores[f"{vid}/objects"] = rng.normal(size=(t, n_obj, 2048)).astype(np.float32)
        stores[f"{vid}/skeleton_bounding_box"] = rng.uniform(0, 600, size=(t, 4)).astype(np.float32)
        stores[f"{vid}/objects_bounding_box"] = rng.uniform(0, 600, size=(t, n_obj, 4)).astype(np.float32)
        stores[f"{vid}/skeleton_2d_pose"] = rng.uniform(0, 600, size=(t, 9, 2)).astype(np.float32)

    dicts_dir = os.path.join(base, "dictionaries")
    os.makedirs(dicts_dir, exist_ok=True)
    paths = {
        "name": "cad120",
        "path": os.path.join(base, "cad120data.pickle"),
        "path_zarr": os.path.join(base, "features.npz"),
        # Lives in dictionaries/ so class-name files are discovered next to it
        # (reference predict.py:273).
        "video_id_to_subject_id": os.path.join(dicts_dir, "video-id_to_subject.txt"),
    }
    with open(paths["path"], "wb") as f:
        pickle.dump(data, f)
    paths["path_zarr"] = _write_store(paths["path_zarr"], stores, store_format)
    with open(paths["video_id_to_subject_id"], "w") as f:
        for vid, subject in vid_to_subject.items():
            f.write(f"{vid} {subject}\n")
    with open(os.path.join(dicts_dir, "subactivity-id_to_subactivity-name.txt"), "w") as f:
        for i in range(1, 11):
            f.write(f"{i} subactivity_{i}\n")
    with open(os.path.join(dicts_dir, "affordance-id_to_affordance-name.txt"), "w") as f:
        for i in range(1, 13):
            f.write(f"{i} affordance_{i}\n")
    paths["video_id_to_subject_id_dir"] = dicts_dir
    return paths
