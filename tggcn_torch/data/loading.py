"""Dataset loading for CAD-120, Bimanual Actions and MPHOI-72 (counterpart
of ``tggcn/data/loading.py``), in numpy.

The same file formats and splits as the JAX package: the zarr-v2 stores
(read by ``data/zarr_lite.py``) or .npz bundles, the JSON and pickle ground
truth, the leave-subject-out filters (MPHOI's group exclusion, the
Bimanual 15-FPS frame doubling) and the seed-42 train/val split. Batches
are numpy arrays; the train and eval loops move them to the model's device.

Feature scaling is ``StandardScaler``, a numpy copy of scikit-learn's
arithmetic (which the card's machine does not have): per-feature mean and
population variance over the non-NaN values, in float64, a constant
feature's scale set to 1. Run dirs written by the JAX package pickle
scikit-learn's scalers: ``ScalerUnpickler`` always reads them as this
class, whether scikit-learn is installed or not.
"""

import json
import os
import pickle
import random
import types
from typing import Optional

import numpy as np

from tggcn_torch.data import assembly, zarr_lite
from tggcn_torch.data.cad120classes import load_cad120_pickle
from tggcn_torch.utils.io import read_dictionary


class _NpzStore:
    """Read-only zarr-group-like view over an .npz bundle ('vid/stream' keys)."""

    def __init__(self, path: str):
        self._data = np.load(path, allow_pickle=False)

    def __getitem__(self, key: str):
        if key in self._data:
            return _NpzArray(self._data[key])
        return _NpzGroup(self._data, key)


class _NpzGroup:
    def __init__(self, data, prefix: str):
        self._data = data
        self._prefix = prefix

    def __getitem__(self, key: str):
        return _NpzArray(self._data[f"{self._prefix}/{key}"])


class _NpzArray:
    def __init__(self, array):
        self._array = array

    def __getitem__(self, item):
        return self._array[item]


def open_store(path: str):
    """Open a feature store: a zarr-v2 DirectoryStore (data/zarr_lite.py:
    raw and zlib chunks in Python, blosc-lz4 through native/libbloscdec.so)
    or an .npz bundle."""
    if path.endswith(".npz"):
        return _NpzStore(path)
    return zarr_lite.open_readonly(path)


def split_train_test(training_data: list, test_fraction: float = 0.2, seed: int = 42):
    """Seeded shuffle split (reference :353-359)."""
    random.seed(seed)
    random.shuffle(training_data)
    num_testing = round(len(training_data) * test_fraction)
    return training_data[num_testing:], training_data[:num_testing]


# --------------------------------------------------------------------------
# Batch iteration
# --------------------------------------------------------------------------


class ArrayDataLoader:
    """Minimal numpy replacement for DataLoader(TensorDataset(...)).

    ``dataset`` indexing mirrors TensorDataset (dataset[i] -> tuple over
    tensors for example i); iteration yields lists of per-tensor batches.
    """

    def __init__(self, tensors: list, batch_size: int, shuffle: bool, seed: int = 0):
        self.tensors = tensors
        self.batch_size = max(int(batch_size), 1)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.num_examples = len(tensors[0]) if tensors else 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order of the next iteration to (seed, epoch).

        Makes epoch order a pure function of the epoch number, so a resumed
        run sees exactly the batches the uninterrupted run would have seen.
        """
        self._epoch = int(epoch)

    class _Dataset:
        def __init__(self, tensors):
            self._tensors = tensors

        def __getitem__(self, i):
            return tuple(t[i] for t in self._tensors)

        def __len__(self):
            return len(self._tensors[0]) if self._tensors else 0

    @property
    def dataset(self):
        return self._Dataset(self.tensors)

    def __len__(self):
        return (self.num_examples + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(self.num_examples)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
            self._epoch += 1
        for start in range(0, self.num_examples, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield [t[idx] for t in self.tensors]


# --------------------------------------------------------------------------
# Feature scaling
# --------------------------------------------------------------------------


class StandardScaler:
    """scikit-learn's ``StandardScaler`` arithmetic, fit and transform:
    ``mean_`` and ``var_`` (population variance) per feature over the
    non-NaN values in float64, ``scale_`` their square root with a
    constant feature's set to 1; transform subtracts the mean and divides
    by the scale, both rounded to the input's dtype, NaN kept (as
    scikit-learn 1.9 does)."""

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x64 = np.asarray(x, dtype=np.float64)
        count = np.sum(~np.isnan(x64), axis=0)
        self.mean_ = np.nansum(x64, axis=0) / count
        centred = x64 - self.mean_
        # scikit-learn's two-pass variance with its rounding correction.
        self.var_ = (np.nansum(centred ** 2, axis=0)
                     - np.nansum(centred, axis=0) ** 2 / count) / count
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= count * eps * self.var_ + (count * self.mean_ * eps) ** 2
        scale = np.sqrt(self.var_)
        scale[constant] = 1.0
        self.scale_ = scale
        self.n_samples_seen_ = count
        self.with_mean = self.with_std = True
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        x = x.astype(x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64)
        x -= self.mean_.astype(x.dtype)
        x /= self.scale_.astype(x.dtype)
        return x


_SKLEARN_SCALER = ("sklearn.preprocessing._data", "StandardScaler")
_REFUSED = {"jax", "jaxlib", "optax", "tggcn"}


class ScalerUnpickler(pickle.Unpickler):
    """The reader of run-dir pickles: scikit-learn's StandardScaler is
    always read as this module's, so a run dir is standardised by the same
    code on every host, with or without scikit-learn; a class of JAX, optax
    or the JAX package (a JAX run's last.ckpt holds optax's state) is
    refused, since the port imports none of them."""

    def find_class(self, module, name):
        if module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"{module}.{name}: this pickle holds JAX objects (a JAX run's last.ckpt?); "
                "the port reads the JAX package's <name>.ckpt but not its optimizer state")
        if (module, name) == _SKLEARN_SCALER:
            return StandardScaler
        return super().find_class(module, name)


# The pickle module torch.load is given for a reference .tar, so that its
# scikit-learn scalers go through ScalerUnpickler too.
scaler_pickle = types.ModuleType("scaler_pickle")
scaler_pickle.Unpickler = ScalerUnpickler
scaler_pickle.load = lambda f, **kwargs: ScalerUnpickler(f, **kwargs).load()


# Model families whose human/object feature streams get standardised, and
# the checkpoint key each fitted scaler is stored under (key names are the
# checkpoint contract — eval recovers them via rundir.load_scalers()).
_SCALED_MODELS = frozenset({"2G-GCN", "bimanual_baseline", "cad120_baseline"})
_SCALED_STREAMS = (("human_scaler", 0), ("object_scaler", 1))


def fit_or_apply_scalers(x: list, model_name: str,
                         scaling_strategy: Optional[str] = None,
                         scalers: Optional[dict] = None):
    """Standardise the human/object feature tensors over the feature axis.

    Training call sites pass ``scaling_strategy`` with no ``scalers``: each
    stream gets a ``StandardScaler`` fit on its flattened ``(-1,
    features)`` view. Eval call sites pass the fitted ``scalers`` recovered
    from the training checkpoint (this module's or scikit-learn's) and
    reuse them as-is. Models outside the scaled families pass through
    untouched.
    """
    fitting = not scalers
    if fitting and scaling_strategy is None:
        return x, {}
    if model_name not in _SCALED_MODELS:
        return x, {} if fitting else scalers
    out, fitted = list(x), {}
    for key, idx in _SCALED_STREAMS:
        flat = out[idx].reshape(-1, out[idx].shape[-1])
        scaler = (scalers or {}).get(key)
        if isinstance(scaler, np.ndarray) and scaler.dtype == object:
            # Checkpoints of older JAX runs wrapped the scaler objects in
            # 0-d object arrays.
            scaler = scaler.item()
        if scaler is None:
            if scaling_strategy != "standard":
                raise ValueError(
                    f"unsupported scaling strategy {scaling_strategy!r}: only "
                    "'standard' (per-feature standardisation) is implemented")
            scaler = StandardScaler().fit(flat)
        fitted[key] = scaler
        out[idx] = scaler.transform(flat).reshape(out[idx].shape)
    return out, fitted


# --------------------------------------------------------------------------
# Data loader creation (assembly + scaling + nan_to_num)
# --------------------------------------------------------------------------


def _assemble_flat(data, model_name, dataset_name, sigma, downsampling, test_data,
                   scaling_strategy=None, scalers=None):
    if dataset_name.lower() == "cad120":
        x, y = assembly.assemble_cad120_tensors(data, model_name, sigma=sigma,
                                                downsampling=downsampling, test_data=test_data)
    elif dataset_name.lower() == "mphoi":
        x, y = assembly.assemble_mphoi_tensors(data, model_name, sigma=sigma,
                                               downsampling=downsampling, test_data=test_data)
    else:
        x, y = assembly.assemble_bimanual_tensors(data, model_name, sigma=sigma,
                                                  downsampling=downsampling, test_data=test_data)
    x, scalers = fit_or_apply_scalers(x, model_name, scaling_strategy=scaling_strategy,
                                      scalers=scalers)
    x = [np.nan_to_num(ix, copy=False, nan=0.0) for ix in x]
    return x + y, scalers


def create_data_loader(data, model_name: str, model_input_type: str, dataset_name: str,
                       batch_size: int, shuffle: bool, scaling_strategy: Optional[str] = None,
                       scalers: Optional[dict] = None, sigma: float = 0.0,
                       downsampling: int = 1, test_data: bool = False,
                       length_buckets: int = 0):
    segmentations = assemble_segmentations(data, model_name, dataset_name=dataset_name)
    if length_buckets and length_buckets > 1:
        # Length-bucketed batching: each bucket pads to its own max length
        # (bounds both padding waste and recompilation; tggcn/data/pipeline.py).
        from tggcn_torch.data.pipeline import make_bucketed_loader

        bucket_scalers = dict(scalers) if scalers else {}
        if scaling_strategy is not None and not bucket_scalers:
            # Fit the scalers once on the full (pre-bucket, globally padded)
            # set — identical statistics to the unbucketed path — then apply
            # them per bucket below.
            _, bucket_scalers = _assemble_flat(data, model_name, dataset_name,
                                               sigma, downsampling, test_data,
                                               scaling_strategy, None)
        loader = make_bucketed_loader(
            data,
            lambda bucket: _assemble_flat(
                bucket, model_name, dataset_name, sigma, downsampling, test_data,
                scaling_strategy if bucket_scalers else None, bucket_scalers)[0],
            length_buckets, batch_size=batch_size, shuffle=shuffle,
            length_fn=lambda item: len(item[0]))
        return loader, bucket_scalers, segmentations
    tensors, scalers = _assemble_flat(data, model_name, dataset_name, sigma, downsampling,
                                      test_data, scaling_strategy, scalers)
    loader = ArrayDataLoader(tensors, batch_size=batch_size, shuffle=shuffle)
    return loader, scalers, segmentations


def assemble_segmentations(data, model_name: str, dataset_name: str):
    """GT segment intervals for frame->segment eval (reference :382-401)."""
    if model_name != "2G-GCN" or dataset_name.lower() != "cad120":
        return None
    segmentations = []
    for *_, video_data in data:
        segmentations.append([])
        for segment in video_data:
            if segment.start_frame is None or segment.end_frame is None:
                continue
            segmentations[-1].append((segment.start_frame - 1, segment.end_frame - 1))
    return segmentations


# --------------------------------------------------------------------------
# Per-dataset raw loading (train/test)
# --------------------------------------------------------------------------


def _load_cad120_raw(data_path, data_path_zarr, video_id_to_subject_id, test_subject_id,
                     keep_test: bool):
    root = open_store(data_path_zarr) if data_path_zarr is not None else None
    data = load_cad120_pickle(data_path)
    out, ids = [], []
    for video_id, video_data in data.items():
        # Video 0505003751 has features but no subject: always dropped (reference :33-37).
        subject_id = video_id_to_subject_id.get(video_id)
        if subject_id is None:
            continue
        is_test = subject_id == test_subject_id
        if is_test != keep_test:
            continue
        if root is not None:
            datum = [root[video_id + "/skeleton"][:], root[video_id + "/objects"][:],
                     root[video_id + "/skeleton_bounding_box"][:],
                     root[video_id + "/objects_bounding_box"][:],
                     root[video_id + "/skeleton_2d_pose"][:],
                     video_data]
        else:
            datum = video_data
        out.append(datum)
        ids.append(video_id)
    return out, ids


def _load_bimanual_raw(data_path, data_path_zarr, data_path_bbs_zarr, data_path_hps_zarr,
                       test_subject_id, video_id_to_video_fps, keep_test: bool):
    with open(data_path, mode="rb") as f:
        data = json.load(f)
    root = open_store(data_path_zarr)
    root_bbs = open_store(data_path_bbs_zarr)
    root_hps = open_store(data_path_hps_zarr)
    out, ids = [], []
    for video_id, hands_gt in data.items():
        subject, _task, _take = video_id.split(sep="-")
        subject_id = int(subject.split(sep="_")[1])
        if (subject_id == test_subject_id) != keep_test:
            continue
        arrays = [root[video_id]["left_hand"][:], root[video_id]["right_hand"][:],
                  root[video_id]["objects"][:]]
        bbs = [root_bbs[video_id]["left_hand"][:], root_bbs[video_id]["right_hand"][:],
               root_bbs[video_id]["objects"][:]]
        hps = [root_hps[video_id]["left_hand"][:], root_hps[video_id]["right_hand"][:]]
        gt = {k: np.asarray(v) for k, v in hands_gt.items()}
        if video_id_to_video_fps[video_id] == 15:
            # Some videos were mistakenly collected at 15 FPS: double frames
            # to normalise to 30 FPS (reference :89-99).
            arrays = [np.repeat(a, repeats=2, axis=0) for a in arrays]
            bbs = [np.repeat(a, repeats=2, axis=0) for a in bbs]
            hps = [np.repeat(a, repeats=2, axis=0) for a in hps]
            gt = {k: np.repeat(v, repeats=2, axis=0) for k, v in gt.items()}
        out.append([arrays[0], arrays[1], arrays[2], gt, bbs[0], bbs[1], bbs[2], hps[0], hps[1]])
        ids.append(video_id)
    return out, ids


def _mphoi_video_excluded(video_subject_id: str, test_subject_id: str) -> bool:
    """Group-exclusion test: a video is excluded from training when any of its
    two subjects matches any test subject (reference :130-133)."""
    first_sub, second_sub = int(video_subject_id[-2]), int(video_subject_id[-1])
    first_test, second_test = int(test_subject_id[-2]), int(test_subject_id[-1])
    return ((first_sub - first_test) * (second_sub - second_test) *
            (first_sub - second_test) * (second_sub - first_test)) == 0


def _load_mphoi_raw(data_path, data_path_zarr, data_path_obbs_zarr, data_path_hbbs_zarr,
                    data_path_hps_zarr, test_subject_id, keep_test: bool):
    with open(data_path, mode="rb") as f:
        data = json.load(f)
    root = open_store(data_path_zarr)
    root_obbs = open_store(data_path_obbs_zarr)
    root_hbbs = open_store(data_path_hbbs_zarr)
    root_hps = open_store(data_path_hps_zarr)
    out, ids = [], []
    for video_id, human_gt in data.items():
        subject_id, _task, _take = video_id.split(sep="-")
        if keep_test:
            if subject_id != test_subject_id:
                continue
        else:
            if _mphoi_video_excluded(subject_id, test_subject_id):
                continue
        gt = {k: np.asarray(v) for k, v in human_gt.items()}
        out.append([root[video_id]["Human1"][:], root[video_id]["Human2"][:],
                    root[video_id]["objects"][:], gt,
                    root_hbbs[video_id]["Human1"][:], root_hbbs[video_id]["Human2"][:],
                    root_obbs[video_id]["objects"][:],
                    root_hps[video_id]["Human1"][:], root_hps[video_id]["Human2"][:]])
        ids.append(video_id)
    return out, ids


# --------------------------------------------------------------------------
# Public API (same shape as the reference's load_training_data/load_testing_data)
# --------------------------------------------------------------------------


def _dataset_name_from_path(data_path: str) -> str:
    if "BimanualActions" in data_path:
        return "bimanual"
    if "MPHOI" in data_path:
        return "mphoi"
    return "cad120"


def load_training_data(data, model_name, model_input_type, batch_size: int = 8,
                       val_fraction: float = 0.2, seed: int = 42, debug: bool = False,
                       sigma: float = 0.0):
    """Load + assemble train/val loaders (reference :160-198)."""
    data_path = data.path
    dataset_name = _dataset_name_from_path(data_path)
    test_subject_id = data.cross_validation_test_subject
    scaling_strategy = data.get("scaling_strategy", default_value=None)
    downsampling = data.get("downsampling", default_value=1)
    length_buckets = data.get("length_buckets", default_value=0)

    if dataset_name == "bimanual":
        with open(data.video_id_to_video_fps, mode="r") as f:
            fps_map = json.load(f)
        raw, _ = _load_bimanual_raw(data_path, data.path_zarr, data.path_bb_zarr,
                                    data.path_hp_zarr, test_subject_id, fps_map,
                                    keep_test=False)
    elif dataset_name == "mphoi":
        raw, _ = _load_mphoi_raw(data_path, data.path_zarr, data.path_obb_zarr,
                                 data.path_hbb_zarr, data.path_hps_zarr, test_subject_id,
                                 keep_test=False)
    else:
        video_id_to_subject_id = read_dictionary(data.video_id_to_subject_id)
        raw, _ = _load_cad120_raw(data_path, data.get("path_zarr"), video_id_to_subject_id,
                                  test_subject_id, keep_test=False)

    train_raw, val_raw = split_train_test(raw, test_fraction=val_fraction, seed=seed)
    if debug:
        train_raw = train_raw[:4]
        val_raw = val_raw[:1]
    train_loader, scalers, _ = create_data_loader(
        train_raw, model_name, model_input_type, dataset_name, batch_size=batch_size,
        shuffle=True, scaling_strategy=scaling_strategy, sigma=sigma,
        downsampling=downsampling, test_data=False, length_buckets=length_buckets)
    val_loader, _, _ = create_data_loader(
        val_raw, model_name, model_input_type, dataset_name, batch_size=max(len(val_raw), 1),
        shuffle=False, scalers=scalers, sigma=sigma, downsampling=downsampling,
        test_data=False)
    input_size = input_size_from_data_loader(train_loader, model_name, model_input_type)
    data_info = {"input_size": input_size}
    return train_loader, val_loader, data_info, scalers


def load_testing_data(data, model_name: str, model_input_type: str, batch_size: int,
                      scalers: Optional[dict] = None):
    """Load + assemble the test loader (reference :312-350).

    Test labels stay at full FPS (test_data=True) so predictions are
    upsampled at eval time.
    """
    data_path = data.path
    dataset_name = _dataset_name_from_path(data_path)
    test_subject_id = data.cross_validation_test_subject
    downsampling = data.get("downsampling", default_value=1)

    if dataset_name == "bimanual":
        with open(data.video_id_to_video_fps, mode="r") as f:
            fps_map = json.load(f)
        bb_zarr = data.get("path_bb_zarr") or os.path.join(os.path.dirname(data.path_zarr),
                                                           "bounding_boxes.zarr")
        hp_zarr = data.get("path_hp_zarr") or os.path.join(os.path.dirname(data.path_zarr),
                                                           "hands_pose.zarr")
        raw, test_ids = _load_bimanual_raw(data_path, data.path_zarr, bb_zarr, hp_zarr,
                                           test_subject_id, fps_map, keep_test=True)
    elif dataset_name == "mphoi":
        base = os.path.dirname(data.path_zarr)
        obb = data.get("path_obb_zarr") or os.path.join(base, "object_bounding_boxes.zarr")
        hbb = data.get("path_hbb_zarr") or os.path.join(base, "human_bounding_boxes.zarr")
        hps = data.get("path_hps_zarr") or os.path.join(base, "human_pose.zarr")
        raw, test_ids = _load_mphoi_raw(data_path, data.path_zarr, obb, hbb, hps,
                                        test_subject_id, keep_test=True)
    else:
        video_id_to_subject_id = read_dictionary(data.video_id_to_subject_id)
        raw, test_ids = _load_cad120_raw(data_path, data.get("path_zarr"),
                                         video_id_to_subject_id, test_subject_id,
                                         keep_test=True)

    test_loader, _, segmentations = create_data_loader(
        raw, model_name, model_input_type, dataset_name, batch_size=batch_size,
        shuffle=False, scalers=scalers, downsampling=downsampling, test_data=True)
    input_size = input_size_from_data_loader(test_loader, model_name, model_input_type)
    data_info = {"input_size": input_size}
    return test_loader, data_info, segmentations, test_ids


def determine_num_classes(model_name: str, model_input_type: str, dataset_name: str):
    """Class counts per dataset (reference :1318-1329)."""
    if model_name in {"2G-GCN", "bimanual_baseline", "cad120_baseline"}:
        if dataset_name.lower() == "bimanual":
            return 14, None
        if dataset_name.lower() == "mphoi":
            return 13, None
        return 10, 12
    if model_input_type == "human":
        return 10
    return 12


def input_size_from_data_loader(data_loader, model_name: str, model_input_type: str):
    if model_name in {"2G-GCN", "bimanual_baseline", "cad120_baseline"}:
        human_input_size = data_loader.dataset[0][0].shape[-1]
        object_input_size = data_loader.dataset[0][1].shape[-1]
        return human_input_size, object_input_size
    raise ValueError(f"{model_name} is not an option for model name.")
