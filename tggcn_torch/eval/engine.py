"""Batched inference over a trained run dir, plus label post-processing
(counterpart of ``tggcn/eval/engine.py``).

Pipeline (capability match for reference predict.py:20-202, restructured):
every stage operates on a single ``{head name: full-dataset array}`` dict —
batches are concatenated immediately after the forward loop, so upsampling,
the Bimanual 15-FPS fixup and segment summarisation are plain array
transforms instead of nested per-batch/per-head list walks.

Prediction arrays are (N, C, T, E) until the final argmax; target arrays are
(N, T, E) with -1 padding. Labels stay at full FPS on the target side; the
model runs at the downsampled rate and its outputs are stretched back by
frame repetition (reference predict.py:64-76, 95-116).
"""

from typing import Dict, List

import numpy as np

from tggcn_torch.eval.rundir import RunDir

EVAL_BATCH_SIZE = 128


def head_names(model_name: str, input_type: str, dataset_name: str) -> List[str]:
    """Output-head naming contract (reference predict.py:249-263).

    Order matches the tail of the model's output list after slicing to
    num_main_losses — position-coupled to train/losses.py ordering.
    """
    sa = ["sub-activity_recognition", "sub-activity_prediction"]
    af = ["affordance_recognition", "affordance_prediction"]
    if model_name == "2G-GCN":
        return sa + af if dataset_name == "cad120" else sa
    if model_name == "bimanual_baseline":
        return sa[:1]
    if model_name == "cad120_baseline":
        return [sa[0], af[0]]
    return sa if input_type == "human" else af


def load_run_model(run: RunDir, device=None) -> dict:
    """The test split and the trained model of a run dir: {'model',
    'params' (its init with the run's weights merged in), 'fetch', 'feed',
    'num_main' (the evaluation heads: the last num_main outputs; None,
    every output, for a baseline), 'names' (theirs), 'test_loader',
    'segmentations', 'test_ids'}."""
    import torch

    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.data.loading import determine_num_classes, load_testing_data
    from tggcn_torch.models.registry import select_model, to_device
    from tggcn_torch.train.checkpoint import load_model_weights, merge_params
    from tggcn_torch.train.losses import decide_num_main_losses

    test_loader, data_info, segmentations, test_ids = load_testing_data(
        run.cfg.data, run.model_name, run.input_type,
        batch_size=EVAL_BATCH_SIZE, scalers=run.load_scalers())
    num_classes = determine_num_classes(run.model_name, run.input_type, run.dataset_name)
    model = select_model(run.model_name, device=device, num_classes=num_classes,
                         **{**data_info, **run.cfg.parameters})
    params = model.init(torch.Generator().manual_seed(42))
    params = merge_params(params, to_device(load_model_weights(run.path, cfg=model.config),
                                            model.device))
    misc = run.misc
    return dict(
        model=model, params=params, test_loader=test_loader, segmentations=segmentations,
        test_ids=test_ids, names=head_names(run.model_name, run.input_type, run.dataset_name),
        fetch=select_model_data_fetcher(run.model_name, run.input_type,
                                        dataset_name=run.dataset_name,
                                        **{**misc, **run.cfg.parameters}),
        feed=select_model_data_feeder(run.model_name, run.input_type,
                                      dataset_name=run.dataset_name, **misc),
        num_main=decide_num_main_losses(run.model_name, run.dataset_name,
                                        {**misc, **run.cfg.parameters}))


def run_inference(run: RunDir, frame_to_segment_level: bool = False,
                  inspect_model: bool = False, device=None):
    """Forward the whole test split through the trained model, on the card
    unless ``device`` says otherwise, in batches of EVAL_BATCH_SIZE (the
    last padded, ``data/feeders.py`` ``pad_batch``), each drawing its
    Gumbel noise from a generator seeded 42 on the device.

    Returns (outputs, targets, test_ids, attentions): outputs/targets are
    {head name: array} with predictions argmaxed to label ids; attentions is
    None unless inspect_model.
    """
    import torch

    from tggcn_torch.data.feeders import num_inputs, pad_batch

    loaded = load_run_model(run, device)
    model, test_loader, names = loaded["model"], loaded["test_loader"], loaded["names"]
    test_ids, num_main = loaded["test_ids"], loaded["num_main"]
    batch_size = min(EVAL_BATCH_SIZE, test_loader.num_examples)
    collected: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    collected_targets: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    attention_batches: List[List[np.ndarray]] = []
    for batch in test_loader:
        rows = len(batch[0])
        data, target = loaded["fetch"](pad_batch(batch, batch_size, num_inputs(run.model_name)))
        output, aux = model.apply(loaded["params"], train=False, inspect_model=inspect_model,
                                  generator=torch.Generator(device=model.device).manual_seed(42),
                                  **loaded["feed"](data))
        # Only the trailing num_main heads are evaluation outputs; the rest
        # are auxiliary training signals (budget/segmentation).
        if num_main is not None:
            output, target = output[-num_main:], target[-num_main:]
        for name, out, tgt in zip(names, output, target):
            collected[name].append(out[:rows].cpu().numpy())
            collected_targets[name].append(np.asarray(tgt)[:rows])
        if inspect_model:
            attention_batches.append([a[:rows, 0].cpu().numpy()
                                      for a in aux["attention_scores"]])

    outputs = {n: np.concatenate(parts, axis=0) for n, parts in collected.items()}
    targets = {n: np.concatenate(parts, axis=0) for n, parts in collected_targets.items()}
    attentions = None
    if attention_batches:
        attentions = [np.concatenate(source, axis=0) for source in zip(*attention_batches)]

    downsampling = run.cfg.data.get("downsampling", default_value=1)
    reference_length = next(iter(targets.values())).shape[1]
    if downsampling > 1:
        outputs = {n: upsample_predictions(out, downsampling, targets[n].shape[1])
                   for n, out in outputs.items()}
        if attentions is not None:
            attentions = [_stretch_time(a, downsampling, reference_length,
                                        time_axis=1) for a in attentions]

    if run.dataset_name == "bimanual":
        import json

        with open(run.cfg.data.video_id_to_video_fps) as f:
            fps_by_video = json.load(f)
        halve = [i for i, vid in enumerate(test_ids) if fps_by_video[vid] == 15]
        outputs = {n: undouble_15fps_rows(out, halve, pad_value=-100.0,
                                          time_axis=2)
                   for n, out in outputs.items()}
        targets = {n: undouble_15fps_rows(tgt, halve, pad_value=-1,
                                          time_axis=1)
                   for n, tgt in targets.items()}

    misc = run.misc
    gt_segmentation_inputs = (misc.get("input_human_segmentation", False) and
                              misc.get("input_object_segmentation", False))
    if frame_to_segment_level and gt_segmentation_inputs:
        starts = [np.asarray([seg[0] for seg in video_segments], dtype=np.int64)
                  for video_segments in loaded["segmentations"]]
        outputs = {n: segment_level_summary(out, starts, time_axis=2)
                   for n, out in outputs.items()}
        targets = {n: segment_level_summary(tgt, starts, time_axis=1)
                   for n, tgt in targets.items()}

    outputs = {n: np.argmax(out, axis=1) for n, out in outputs.items()}
    return outputs, targets, test_ids, attentions


def upsample_predictions(predictions: np.ndarray, downsampling: int,
                         target_length: int) -> np.ndarray:
    """Stretch (N, C, T_ds, E) logits back to full FPS by frame repetition."""
    if predictions.ndim != 4:
        raise RuntimeError(
            f"Number of dimensions for output is {predictions.ndim}")
    return _stretch_time(predictions, downsampling, target_length, time_axis=2)


def _stretch_time(array: np.ndarray, factor: int, target_length: int,
                  time_axis: int) -> np.ndarray:
    """Repeat each time step `factor` times, then trim or edge-pad to length."""
    stretched = np.repeat(array, factor, axis=time_axis)
    current = stretched.shape[time_axis]
    if current >= target_length:
        index = [slice(None)] * stretched.ndim
        index[time_axis] = slice(0, target_length)
        return stretched[tuple(index)]
    pad = [(0, 0)] * stretched.ndim
    pad[time_axis] = (0, target_length - current)
    return np.pad(stretched, pad, mode="edge")


def undouble_15fps_rows(array: np.ndarray, video_indices: List[int],
                        pad_value: float, time_axis: int) -> np.ndarray:
    """Undo the loader's 15-FPS frame doubling for the given videos.

    Keeps every second frame (offset 1) of each affected video and right-pads
    the freed tail with pad_value so the array shape is unchanged
    (reference predict.py:136-156).
    """
    if not video_indices:
        return array
    array = array.copy()
    length = array.shape[time_axis]
    kept = length // 2  # len(range(1, length, 2))
    for i in video_indices:
        row = np.moveaxis(array[i], time_axis - 1, 0)
        row[:kept] = row[1::2]
        row[kept:] = pad_value
    return array


def segment_level_summary(array: np.ndarray, segment_starts: List[np.ndarray],
                          time_axis: int) -> np.ndarray:
    """Collapse frame-level labels to one entry per GT segment.

    Picks the frame at each segment start (reference predict.py:159-183) and
    right-pads every video to the maximum segment count with -1.
    """
    max_segments = max(len(starts) for starts in segment_starts)
    rows = []
    for video, starts in zip(array, segment_starts):
        picked = np.take(video, starts, axis=time_axis - 1)
        pad = [(0, 0)] * picked.ndim
        pad[time_axis - 1] = (0, max_segments - len(starts))
        rows.append(np.pad(picked, pad, constant_values=-1.0))
    return np.stack(rows, axis=0)
