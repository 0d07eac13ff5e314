"""The stage-1 CAD-120 configuration of the port, its requests and its batches.

The model is ``conf/models/2G-GCN_stage1.yaml`` with ``conf/data/cad120.yaml``
and the yaml's own CAD-120 settings (its comments): hidden 512, gcn_node
19, input (2124, 2048), 10 sub-activities and 12 affordances, one human and
so no humans-to-human edge, the configured 'gs' decision rule and 'ind'
objects. ``TRAIN`` is the yaml's optimisation and misc blocks at CAD-120's
batch 16 and learning rate 1e-3: Adam, no clipping, the 12 losses of the
CAD-120 bundle (``train/losses.py::select_loss``) with only the
segment-level recognition and anticipation losses weighted in. The
stage-1 feeder (``FEEDER_KWARGS``) imposes the human segmentation and, for
CAD-120, the objects' too, so a stage-1 step or request takes no decision.

One request or batch has ``SHAPE``: B=16 clips of T=167 frames (the
repository records no CAD-120 clip length; 167 is ``bench.py``'s, so a
step compares with the MPHOI one), 1 human, 5 object slots, some of them
empty (``objects_mask``), whose features and targets are zeros and -1 as
padding gives them.

The configuration has no four-edge segment level, so its segment scan is
the general one (``models/segment_general.py``): only the frame BiGRU (K1,
K2) runs a kernel, and K6 where ``SERVE_VARIANTS['dist']`` turns the GeoGCN
kernel on, with the distances CAD-120 gives, human-object and
object-object (``make_distances``).
"""

import numpy as np

DATASET = "cad120"
SHAPE = dict(b=16, t=167, humans=1, objects=5)
SUBACTIVITIES, AFFORDANCES = 10, 12

MODEL_KWARGS = dict(
    input_size=(2124, 2048), num_classes=(SUBACTIVITIES, AFFORDANCES), hidden_size=512,
    gcn_node=19, message_humans_to_human=False, message_human_to_objects=True,
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
    lr=1e-3, clip=0.0, batch_size=16,
    misc={"anticipation_loss_weight": 1.0,
          "budget_loss": {"add": False, "human_weight": 1.0, "object_weight": 1.0},
          "first_level_loss_weight": 0.0, "impose_segmentation_pattern": 1,
          "input_human_segmentation": False, "input_object_segmentation": False,
          "make_attention_distance_based": False, "multi_task_loss_learner": False,
          "segmentation_loss": {"add": False, "pretrain": False, "sigma": 0.0,
                                "weight": 1.0}})

FEEDER_KWARGS = dict(dataset_name=DATASET, impose_segmentation_pattern=1)

SERVE_VARIANTS = {"dist": dict(use_pallas_geo_gcn=True)}


def feeder_kwargs(variant=None) -> dict:
    """The feeder's keywords for a batch of the model or of its 'dist'
    variant, which reads the batch's distance tensors."""
    return dict(FEEDER_KWARGS, make_attention_distance_based=variant == "dist")


def _clips(rng: np.random.Generator, b: int, t: int, humans: int, objects: int):
    """Features and object mask of b clips: between 1 and `objects` real
    objects a clip (all of them in the first clip, one in the last), the
    empty slots' features zero."""
    counts = rng.integers(1, objects + 1, size=b)
    counts[0], counts[-1] = objects, 1
    mask = (np.arange(objects)[None, :] < counts[:, None]).astype(np.float32)
    x_human = rng.standard_normal((b, t, humans, 2124), dtype=np.float32)
    x_objects = rng.standard_normal((b, t, objects, 2048), dtype=np.float32)
    x_objects *= mask[:, None, :, None]
    return x_human, x_objects, mask


def make_request(rng: np.random.Generator, b: int, t: int, humans: int, objects: int) -> dict:
    """One request as the stage-1 feeder hands it to the model: random
    features, the object mask of _clips, both segmentations imposed."""
    x_human, x_objects, mask = _clips(rng, b, t, humans, objects)
    return dict(x_human=x_human, x_objects=x_objects, objects_mask=mask,
                human_segmentation=np.ones((b, t, humans), np.float32),
                objects_segmentation=np.ones((b, t, objects), np.float32),
                steps_per_example=np.full((b,), float(t), np.float32))


def make_batch(rng: np.random.Generator, b: int, t: int, humans: int, objects: int,
               variant=None) -> list:
    """One training batch in the CAD-120 loader's layout: the 8 inputs of
    the 2G-GCN fetcher (x_human, x_objects, objects_mask, the human and
    the object segmentation, the human-object and object-object distances,
    steps_per_example), then the 12 targets of the CAD-120 bundle
    (segmentation of humans and objects, twice; sub-activity and
    affordance labels for the frame heads, recognition then anticipation,
    and again for the segment heads), -1 in the empty object slots. For the
    'dist' variant the distances (make_distances, drawn last) take their
    places; else those places hold dummies."""
    x_human, x_objects, mask = _clips(rng, b, t, humans, objects)
    steps = np.full((b,), float(t), dtype=np.float32)
    x_hseg = np.ones((b, t, humans), dtype=np.float32)
    x_oseg = np.ones((b, t, objects), dtype=np.float32)
    empty = mask[:, None, :] == 0
    y_hseg = rng.integers(0, 2, size=(b, t, humans)).astype(np.float32)
    y_oseg = np.where(empty, -1.0, rng.integers(0, 2, size=(b, t, objects))).astype(np.float32)
    y_sub = rng.integers(0, SUBACTIVITIES, size=(b, t, humans)).astype(np.int64)
    y_aff = np.where(empty, -1, rng.integers(0, AFFORDANCES, size=(b, t, objects)))
    y_aff = y_aff.astype(np.int64)
    dummy = np.zeros((b, 1, 1, 1), dtype=np.float32)
    dists = [dummy, dummy]
    if variant == "dist":
        dists = list(make_distances(rng, b, t, humans, objects).values())
    return ([x_human, x_objects, mask, x_hseg, x_oseg, *dists, steps]
            + [y_hseg, y_oseg, y_hseg, y_oseg] + [y_sub, y_sub, y_aff, y_aff] * 2)


def make_distances(rng: np.random.Generator, b: int, t: int, humans: int, objects: int) -> dict:
    """Random positive distances of one request, as the CAD-120 feeder
    passes them with make_attention_distance_based: human-object (B, T, H,
    O) and object-object (B, T, O, O) only, about a fifth of them exactly 0,
    which distance-based attention masks."""
    def d(r, s):
        return np.where(rng.uniform(size=(b, t, r, s)) < 0.2, 0.0,
                        rng.uniform(0.1, 3.0, size=(b, t, r, s))).astype(np.float32)
    return dict(human_object_distances=d(humans, objects),
                object_object_distances=d(objects, objects))
