"""The stage-2 MPHOI configuration of the port, its requests and its batches.

Stage 2 is the second half of the two-stage protocol (``SURVEY.md`` §3.4):
``conf/models/2G-GCN_stage2.yaml`` with ``conf/data/mphoi.yaml``, warm-started
from a stage-1 run (``tggcn_torch.train.checkpoint.merge_params``, as
``train.py:99-103`` does). The model is stage 1's (``stage1.MODEL_KWARGS``)
with its decisions filtered to local maxima above a threshold of 0.1
(``filter_discrete_updates``); nothing is imposed, so humans and objects
both decide by the 'gs' rule and both draw Gumbel noise. ``TRAIN`` is the
yaml's optimisation and misc blocks: Adam at lr 1e-4, no clipping, the
segmentation loss on with targets smoothed at sigma 4. One request or batch
has stage 1's shape (``stage1.SHAPE``). ``model_kwargs(dtype)`` and
``BENCH_DTYPE`` are stage 1's.

``FEATURE_VARIANTS`` are changes to the yaml that turn on the positional and
level-state features of the 'dot' route: the time position as a decision
input ('u') with the periodic encoding and shared level heads, and the time
position as a segment input ('s') with the embedding encoding, the segment
length and the level states concatenated before the heads.
"""

import numpy as np

from tggcn_torch.data.assembly import assemble_segmentation_targets
from tggcn_torch.models import stage1

DATASET = stage1.DATASET
SHAPE = stage1.SHAPE
NUM_SUBACTIVITIES = stage1.MODEL_KWARGS["num_classes"][0]

MODEL_KWARGS = dict(stage1.MODEL_KWARGS, filter_discrete_updates=True,
                    update_segment_threshold=0.1)

BENCH_DTYPE = stage1.BENCH_DTYPE


def model_kwargs(dtype: str = "float32") -> dict:
    """MODEL_KWARGS with the compute dtype ('float32' or 'bfloat16')."""
    return dict(MODEL_KWARGS, compute_dtype=dtype)


TRAIN = dict(
    lr=1e-4, clip=0.0,
    misc={"anticipation_loss_weight": 1.0,
          "budget_loss": {"add": False, "human_weight": 1.0, "object_weight": 1.0},
          "first_level_loss_weight": 0.0, "impose_segmentation_pattern": 0,
          "input_human_segmentation": False, "input_object_segmentation": False,
          "make_attention_distance_based": False, "multi_task_loss_learner": False,
          "pretrained": True,
          "segmentation_loss": {"add": True, "pretrain": False, "sigma": 4.0,
                                "weight": 1.0}})

FEEDER_KWARGS = dict(dataset_name="mphoi", impose_segmentation_pattern=0)

FEATURE_VARIANTS = {
    "u_periodic_shared": dict(add_time_position=True, time_position_strategy="u",
                              positional_encoding_style="p", share_level_mlps=True),
    "s_embedding_length_cat": dict(add_time_position=True, time_position_strategy="s",
                                   positional_encoding_style="e", add_segment_length=True,
                                   cat_level_states=True)}

SEGMENT_LENGTHS = (8, 40)


def make_request(rng: np.random.Generator, b: int, t: int, humans: int, objects: int) -> dict:
    """stage1.make_request with nothing imposed: humans decide too."""
    request = stage1.make_request(rng, b, t, humans, objects)
    del request["human_segmentation"]
    return request


def make_segments(rng: np.random.Generator, b: int, t: int, humans: int):
    """Segments of lengths drawn from SEGMENT_LENGTHS (the last cut at the
    clip's end) for each clip and human: (end-of-segment flags (B, T, H),
    sub-activity labels, constant within a segment and differing from the
    previous segment's, next-segment labels, -1 over the last segment),
    the flags float32, the labels int64."""
    flags = np.zeros((b, t, humans), np.float32)
    labels = np.zeros((b, t, humans), np.int64)
    following = np.full((b, t, humans), -1, np.int64)
    for i in range(b):
        for n in range(humans):
            start, label, spans = 0, -1, []
            while start < t:
                end = min(start + int(rng.integers(SEGMENT_LENGTHS[0], SEGMENT_LENGTHS[1] + 1)),
                          t)
                label = int((label + rng.integers(1, NUM_SUBACTIVITIES)) % NUM_SUBACTIVITIES
                            if label >= 0 else rng.integers(NUM_SUBACTIVITIES))
                spans.append((start, end, label))
                start = end
            for (s, e, lab), nxt in zip(spans, spans[1:] + [None]):
                flags[i, e - 1, n] = 1.0
                labels[i, s:e, n] = lab
                if nxt is not None:
                    following[i, s:e, n] = nxt[2]
    return flags, labels, following


def make_batch(rng: np.random.Generator, b: int, t: int, humans: int, objects: int) -> list:
    """One stage-2 training batch: the 8 inputs of the 2G-GCN fetcher as
    stage1.make_batch has them (the human segmentation in its place, which
    the stage-2 feeder does not read), then the six MPHOI targets: the
    segmentation targets twice (the end flags of make_segments through
    assemble_segmentation_targets at TRAIN's sigma), then the sub-activity
    labels of the frame and segment heads, recognition and anticipation."""
    x_human = rng.normal(size=(b, t, humans, 2152)).astype(np.float32)
    x_objects = rng.normal(size=(b, t, objects, 2048)).astype(np.float32)
    mask = np.ones((b, objects), dtype=np.float32)
    steps = np.full((b,), float(t), dtype=np.float32)
    dummy = np.zeros((b, 1, 1, 1), dtype=np.float32)
    flags, y_rec, y_pred = make_segments(rng, b, t, humans)
    y_seg = assemble_segmentation_targets(flags, TRAIN["misc"]["segmentation_loss"]["sigma"])
    return [x_human, x_objects, mask, flags, dummy, dummy, dummy, steps,
            y_seg, y_seg, y_rec, y_pred, y_rec, y_pred]
