"""The stage-1 MPHOI configuration of the port, its requests and its batches.

The model is ``conf/models/2G-GCN_stage1.yaml`` with ``conf/data/mphoi.yaml``
(hidden 512, gcn_node 26, input (2152, 2048)) and its configured 'gs'
decision rule; one request or batch has the ``bench.py`` MPHOI shape: B=8
clips of T=167 frames, 2 humans, 4 objects. The stage-1 feeder imposes the
human segmentation (all ones), so only the objects draw Gumbel noise.
``TRAIN`` is the yaml's optimisation and misc blocks: Adam at lr 1e-4, no
clipping, and loss weights that leave only the segment-level recognition
and anticipation losses on (the same weights as ``bench.py``'s empty misc).

The yaml computes in float32; ``bench.py`` trains it in bfloat16
(``bench.py:181``, ``compute_dtype="bfloat16"``), the dtype ``BENCH_DTYPE``
names: ``model_kwargs(dtype)`` is ``MODEL_KWARGS`` in either.

``SERVE_VARIANTS`` are the changes to the yaml that run the model's segment
scan through K5 (the set ``tools/bench_segment_modes.py`` times at this
shape), served and trained in either dtype: distance-based attention with
the GeoGCN kernel on (``dist``, which needs ``make_distances``: in a
request, or in a batch from ``make_batch(..., variant="dist")`` fed with
``feeder_kwargs("dist")``), concat (``v1``) or bilinear (``v4``) attention,
and mean pooling (``mp``).
"""

import numpy as np

DATASET = "mphoi"
SHAPE = dict(b=8, t=167, humans=2, objects=4)

MODEL_KWARGS = dict(
    input_size=(2152, 2048), num_classes=(13, None), hidden_size=512, gcn_node=26,
    message_humans_to_human=True, message_human_to_objects=True,
    message_objects_to_human=True, message_objects_to_object=True,
    message_geometry_to_objects=True, message_geometry_to_human=False,
    message_segment=True, message_type="v2", message_granularity="v1",
    message_aggregation="att", attention_style="v3",
    discrete_optimization_strategy="gs", object_segment_update_strategy="ind",
    discrete_networks_num_layers=1, update_segment_threshold=0.5, bias=True)

BENCH_DTYPE = "bfloat16"


def model_kwargs(dtype: str = "float32") -> dict:
    """MODEL_KWARGS with the compute dtype ('float32' or 'bfloat16')."""
    return dict(MODEL_KWARGS, compute_dtype=dtype)


TRAIN = dict(
    lr=1e-4, clip=0.0,
    misc={"anticipation_loss_weight": 1.0,
          "budget_loss": {"add": False, "human_weight": 1.0, "object_weight": 1.0},
          "first_level_loss_weight": 0.0, "impose_segmentation_pattern": 1,
          "input_human_segmentation": False, "input_object_segmentation": False,
          "make_attention_distance_based": False, "multi_task_loss_learner": False,
          "segmentation_loss": {"add": False, "pretrain": False, "sigma": 0.0,
                                "weight": 1.0}})

FEEDER_KWARGS = dict(dataset_name="mphoi", impose_segmentation_pattern=1)

SERVE_VARIANTS = {"dist": dict(use_pallas_geo_gcn=True), "v1": dict(attention_style="v1"),
                  "v4": dict(attention_style="v4"), "mp": dict(message_aggregation="mp")}


def make_request(rng: np.random.Generator, b: int, t: int, humans: int, objects: int) -> dict:
    """One batch of random features as numpy arrays: the last clip has half
    its objects masked, and the human segmentation is imposed."""
    mask = np.ones((b, objects), np.float32)
    mask[-1, objects // 2:] = 0.0
    return dict(
        x_human=rng.standard_normal((b, t, humans, 2152), dtype=np.float32),
        x_objects=rng.standard_normal((b, t, objects, 2048), dtype=np.float32),
        objects_mask=mask,
        human_segmentation=np.ones((b, t, humans), np.float32),
        steps_per_example=np.full((b,), float(t), np.float32))


def feeder_kwargs(variant=None) -> dict:
    """The feeder's keywords for a batch of the model or of one of
    SERVE_VARIANTS: 'dist' reads the batch's distance tensors."""
    return dict(FEEDER_KWARGS, make_attention_distance_based=variant == "dist")


def make_batch(rng: np.random.Generator, b: int, t: int, humans: int, objects: int,
               variant=None) -> list:
    """One training batch as ``bench.py`` builds it: the 8 inputs of the
    2G-GCN fetcher, then the six MPHOI targets (segmentation twice, then
    sub-activity labels for the frame and segment heads). For the 'dist'
    variant the three distance tensors (make_distances, drawn last) take the
    places the feeder reads them from; else those places hold dummies."""
    x_human = rng.normal(size=(b, t, humans, 2152)).astype(np.float32)
    x_objects = rng.normal(size=(b, t, objects, 2048)).astype(np.float32)
    mask = np.ones((b, objects), dtype=np.float32)
    steps = np.full((b,), float(t), dtype=np.float32)
    x_hseg = np.ones((b, t, humans), dtype=np.float32)
    dummy = np.zeros((b, 1, 1, 1), dtype=np.float32)
    y_seg = rng.integers(0, 2, size=(b, t, humans)).astype(np.float32)
    y_rec = rng.integers(0, 13, size=(b, t, humans)).astype(np.int64)
    dists = [dummy] * 3
    if variant == "dist":
        dists = list(make_distances(rng, b, t, humans, objects).values())
    return [x_human, x_objects, mask, x_hseg, *dists, steps,
            y_seg, y_seg, y_rec, y_rec, y_rec, y_rec]


def make_distances(rng: np.random.Generator, b: int, t: int, humans: int, objects: int) -> dict:
    """Random positive distances of one request, as the MPHOI feeder passes
    them with make_attention_distance_based: (B, T, H, H), (B, T, H, O),
    (B, T, O, O), about a fifth of them exactly 0, which distance-based
    attention masks."""
    def d(r, s):
        return np.where(rng.uniform(size=(b, t, r, s)) < 0.2, 0.0,
                        rng.uniform(0.1, 3.0, size=(b, t, r, s))).astype(np.float32)
    return dict(human_human_distances=d(humans, humans),
                human_object_distances=d(humans, objects),
                object_object_distances=d(objects, objects))
