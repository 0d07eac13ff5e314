"""TGGCN — the 2G-GCN two-level recurrent HOI model in PyTorch.

Counterpart of ``tggcn/models/tggcn.py:52-808, 819-1214``. The port covers
every message kind (relational, non-relational generic or 'specific'), any
set of entity edges with or without segment-level messages, geometry
edges, with decisions imposed (stage-1 feeders impose the human
segmentation, and CAD-120's the objects' too) or taken by the
straight-through ('st') or Gumbel-sigmoid ('gs') estimator, optionally
filtered to local maxima (filter_discrete_updates, stage 2), 'ind', 'sah'
or 'coh' object decisions, the time-position ('s' or 'u', embedded or
periodic) and segment-length features, cat_level_states and
share_level_mlps, attention in every style, mean pooling and
inverse-distance attention from any set of distance tensors, forward and
training. A configuration or call outside these raises
NotImplementedError; it never takes another path silently.

``compute_dtype`` 'bfloat16' (or 'bf16') runs the heavy path in bfloat16 as
``tggcn``'s does (``tggcn/models/tggcn.py:387-412, 477-516, 764-790``): the
parameters are cast inside ``apply_tggcn`` from the float32 masters, so
autograd hands float32 gradients back to them, except the GeoGCN block with
its BatchNorm and the recognition and prediction heads, which stay
float32; the geometry enters the GCN in float32 and its output is cast;
the heads take float32 input; every returned output is float32; the
distance tensors are cast to bfloat16 as JAX casts them (``:483-485``). It
covers every segment mode; the GeoGCN block, K6 included, stays float32, as
in JAX's bfloat16 model.

The frame-level BiGRU runs through K1 forward and K2 backward
(``gru_sequence_autograd``). The segment scan takes one of three routes,
as JAX's kernel route does (``segment_mode``): with non-relational
generic messages on all four entity edges and segment messages on, through
K3 forward and K4 backward (``segment_scan_dot_autograd``) in 'dot' mode,
and through K5 in the modes 'v1', 'v4' and 'ext': forward only
(``segment_scan_forward``) where no gradient will be taken, else K5
forward with the gradients of the XLA fast path's counterpart
(``models/segment_fast.py``) recomputed at the saved inputs
(``segment_scan_recompute``), as JAX's custom VJP for these modes takes
them; in every other configuration through the general scan
(``models/segment_general.py``, JAX's XLA ``_segment_scan``, plain PyTorch
with autograd). With ``use_pallas_geo_gcn`` the GeoGCN block runs through
K6 (forward, with its backward recomputed as JAX's). On the CPU the
kernels take their plain PyTorch versions. The forward carries of
sliding-window streaming (``carry``, ``return_carry``,
``force_last_step_commit``, ``frame_offset``) and frame-indexed Gumbel
noise serve ``models/streaming.py``.
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch

from tggcn_torch.models.segment_fast import CELLS, EDGES, initial_states, segment_scan_fast
from tggcn_torch.models.segment_general import GENERAL_SCAN_RANGE, segment_scan_general
from tggcn_torch.nn.distributions import (GUMBEL_STRATEGIES, discrete_estimator,
                                          frame_indexed_gumbel, gumbel_noise, noise_key)
from tggcn_torch.nn.geo_gcn import apply_geo_gcn, init_geo_gcn
from tggcn_torch.nn.gru import init_bigru, init_gru_cell, run_multi_bigru
from tggcn_torch.nn.messages import (GENERIC, MEAN_POOLING, NON_RELATIONAL, RELATIONAL,
                                     SPECIFIC, compute_message_features,
                                     distance_based_attention_weights)
from tggcn_torch.nn.mlp import apply_mlp, init_bilinear, init_mlp
from tggcn_torch.nn.temporal import (assemble_segment_length_tensor, assemble_time_tensor,
                                     filter_soft_decisions, make_periodic_embedding,
                                     reorder_hidden_states)
from tggcn_torch.ops.segment_scan import (segment_scan_dot_autograd, segment_scan_forward,
                                          segment_scan_recompute)

SLICE = "the 2G-GCN slice of tggcn_torch"
# The streaming carries of K1's three forward streams, in its stream order,
# and the hash stream of each decision kind's frame-indexed noise.
FRAME_CARRIES = ("frame_human", "frame_object", "frame_geometry")
NOISE_STREAMS = {"human": 0, "object": 1}
DOT_STYLES = {"v2", "dot-product", "v3", "scaled_dot-product"}
BF16 = {"bfloat16", "bf16"}


@dataclass(frozen=True)
class TGGCNConfig:
    """The model fields of ``tggcn.models.tggcn.TGGCNConfig``, with its defaults.

    ``use_pallas_geo_gcn`` routes the GeoGCN block through K6, as it routes
    tggcn's through its TPU kernel. ``from_kwargs`` drops the fields that
    only route tggcn to its other TPU kernels or tune its scans
    (``use_pallas_gru``, ``scan_unroll``, ``remat_*``, ...), as it drops any
    unknown key: the port always runs K1-K5.
    """
    input_size: tuple
    num_classes: tuple
    hidden_size: int = 128
    discrete_networks_num_layers: int = 1
    discrete_optimization_strategy: str = "gumbel-sigmoid"
    filter_discrete_updates: bool = False
    gcn_node: int = 26
    message_humans_to_human: bool = True
    message_human_to_objects: bool = True
    message_objects_to_human: bool = True
    message_objects_to_object: bool = True
    message_geometry_to_objects: bool = True
    message_geometry_to_human: bool = False
    message_segment: bool = False
    message_type: str = "relational"
    message_granularity: str = "specific"
    message_aggregation: str = "attention"
    attention_style: str = "concat"
    object_segment_update_strategy: str = "independent"
    update_segment_threshold: float = 0.5
    add_segment_length: bool = False
    add_time_position: bool = False
    time_position_strategy: str = "s"
    positional_encoding_style: str = "embedding"
    cat_level_states: bool = False
    share_level_mlps: bool = False
    bias: bool = True
    # 'reference' reproduces the upstream raw-memory reshape of the GeoGCN
    # output (models.py:644-645); 'per_frame' gives each step its own frame's
    # node features and is not weight-compatible with 'reference'.
    geometry_flatten: str = "reference"
    compute_dtype: str = "float32"
    # 'batched' draws the Gumbel noise of a whole clip at once;
    # 'frame_indexed' draws each absolute frame's from a hash of (key,
    # frame), the same in any window (streaming; nn/distributions.py).
    gs_noise: str = "batched"
    use_pallas_geo_gcn: bool = False

    @classmethod
    def from_kwargs(cls, **kwargs):
        fields = cls.__dataclass_fields__
        clean = {}
        for k, v in kwargs.items():
            if k not in fields:
                continue
            if fields[k].type is bool or isinstance(fields[k].default, bool):
                v = bool(v)
            if k in ("input_size", "num_classes"):
                v = tuple(v)
            clean[k] = v
        return cls(**clean)

    @property
    def relational(self):
        return self.message_type in {"v1", "relational"}

    @property
    def attention(self):
        return self.message_aggregation in {"att", "attention"}

    @property
    def embedding_positional(self):
        return self.positional_encoding_style in {"e", "embedding"}

    @property
    def shared_heads(self):
        """The frame heads are the segment heads (share_level_mlps without
        cat_level_states, ``tggcn/models/tggcn.py:751``)."""
        return self.share_level_mlps and not self.cat_level_states

    def message_kwargs(self):
        return dict(message_type=self.message_type,
                    message_granularity=self.message_granularity,
                    message_aggregation=self.message_aggregation,
                    attention_style=self.attention_style)


def check_slice(cfg: TGGCNConfig) -> None:
    """Raise NotImplementedError for any configuration outside the slice."""
    def need(ok, what):
        if not ok:
            raise NotImplementedError(f"{what} is outside {SLICE}")

    need(cfg.message_type in RELATIONAL | NON_RELATIONAL, f"message_type={cfg.message_type!r}")
    need(cfg.message_granularity in GENERIC | SPECIFIC,
         f"message_granularity={cfg.message_granularity!r}")
    need(cfg.attention or cfg.message_aggregation in MEAN_POOLING,
         f"message_aggregation={cfg.message_aggregation!r}")
    need(not cfg.attention
         or cfg.attention_style in DOT_STYLES | {"v1", "concat", "v4", "general"},
         f"attention_style={cfg.attention_style!r}")
    need(cfg.object_segment_update_strategy in {"ind", "independent", "sah", "same_as_human",
                                                "coh", "conditional_on_human"},
         f"object_segment_update_strategy={cfg.object_segment_update_strategy!r}")
    need(cfg.discrete_optimization_strategy in {"st", "straight-through",
                                                "gs", "gumbel-sigmoid"},
         f"discrete_optimization_strategy={cfg.discrete_optimization_strategy!r}")
    need(cfg.gs_noise in {"batched", "frame_indexed"}, f"gs_noise={cfg.gs_noise!r}")
    need(cfg.time_position_strategy in {"s", "u"},
         f"time_position_strategy={cfg.time_position_strategy!r}")
    need(cfg.positional_encoding_style in {"e", "embedding", "p", "periodic"},
         f"positional_encoding_style={cfg.positional_encoding_style!r}")
    need(cfg.compute_dtype in {None, "float32", "f32"} | BF16,
         f"compute_dtype={cfg.compute_dtype!r}")
    need(cfg.geometry_flatten in {"reference", "per_frame"},
         f"geometry_flatten={cfg.geometry_flatten!r}")


def work_dtype(cfg: TGGCNConfig) -> Optional[torch.dtype]:
    """The compute dtype of the heavy path, or None for plain float32
    (``tggcn/models/tggcn.py:387`` ``_work_dtype``)."""
    return torch.bfloat16 if cfg.compute_dtype in BF16 else None


def cast_params_for_compute(params: dict, dtype: torch.dtype) -> dict:
    """The heavy path's parameters cast to the compute dtype
    (``tggcn/models/tggcn.py:394`` ``_cast_params_for_compute``). The GeoGCN
    block (its BatchNorm statistics must not round-trip through bfloat16)
    and the classification heads (their log-softmax sets the loss
    precision) stay float32. The casts are autograd operations on the
    masters, whose gradients stay float32."""
    def keep(name):
        return (name == "geometry_embedding_gcn" or name.endswith("_recognition_mlp")
                or name.endswith("_prediction_mlp"))

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        return tree.to(dtype) if tree.is_floating_point() else tree

    return {k: (v if keep(k) else cast(v)) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def _positional_size(cfg: TGGCNConfig) -> int:
    """The widths the time position (strategy 's') and the segment length
    add to a segment-level input."""
    h = cfg.hidden_size
    return ((h if cfg.add_time_position and cfg.time_position_strategy == "s" else 0)
            + (h if cfg.add_segment_length else 0))


def _edge_width(cfg: TGGCNConfig, flag: bool) -> int:
    """The width an entity edge adds to a segment cell's input: its frame
    message, and its segment message with message_segment."""
    return cfg.hidden_size * (1 + cfg.message_segment) if flag else 0


def _human_segment_input_size(cfg: TGGCNConfig) -> int:
    h = cfg.hidden_size
    return (h + _edge_width(cfg, cfg.message_humans_to_human)
            + (h if cfg.message_geometry_to_human else 0)
            + _edge_width(cfg, cfg.message_objects_to_human) + _positional_size(cfg))


def _object_segment_input_size(cfg: TGGCNConfig) -> int:
    h = cfg.hidden_size
    return (h + (h if cfg.message_geometry_to_objects else 0)
            + _edge_width(cfg, cfg.message_human_to_objects)
            + _edge_width(cfg, cfg.message_objects_to_object) + _positional_size(cfg))


def _init_message_params(g, cfg: TGGCNConfig, segment: bool) -> dict:
    """The parameter bundle of one edge at one level
    (``tggcn/models/tggcn.py:214`` ``_init_message_params``): a segment
    message reads states (h wide), a frame message [x, h] (2h); a pair
    [receiver, sender] twice that. Relational edges take 'g' over the pair
    and 'f'; the others 'msg' over the sender ('generic') or the pair
    ('specific') and, under attention, an attention layer for every style,
    even where the dot styles never read it: a bilinear layer for v4, else
    an MLP over the pair."""
    h, bias = cfg.hidden_size, cfg.bias
    width = h if segment else 2 * h
    if cfg.relational:
        return {"g": init_mlp(g, [2 * width, h], bias), "f": init_mlp(g, [h, h], bias)}
    msg_in = width if cfg.message_granularity in GENERIC else 2 * width
    out = {"msg": init_mlp(g, [msg_in, h], bias)}
    if cfg.attention:
        out["att"] = (init_bilinear(g, width, width, 1, bias)
                      if cfg.attention_style in {"v4", "general"}
                      else init_mlp(g, [2 * width, 1], bias))
    return out


def init_tggcn(generator: torch.Generator, cfg: TGGCNConfig) -> dict:
    """Random parameters with the keys and shapes of ``tggcn``'s init_tggcn,
    on the generator's device."""
    check_slice(cfg)
    h, bias, g = cfg.hidden_size, cfg.bias, generator
    _, object_input_size = cfg.input_size
    num_subactivities, num_affordances = cfg.num_classes
    params = {}
    if cfg.add_time_position and cfg.embedding_positional:
        params["time_position_mlp"] = init_mlp(g, [1, h], bias)
    if cfg.add_segment_length and cfg.embedding_positional:
        params["segment_length_mlp"] = init_mlp(g, [1, h], bias)
    params.update({
        "geometry_embedding_gcn": init_geo_gcn(g, cfg.gcn_node, 4, 128),
        "geometry_embedding_mlp": init_mlp(g, [cfg.gcn_node * 128, 2048, h], bias),
        "geometry_bd_rnn": init_bigru(g, h, h, bias),
        "geometry_bd_embedding_mlp": init_mlp(g, [2 * h, h], bias),
        "human_embedding_mlp": init_mlp(g, [2048, h], bias),
        "human_bd_rnn": init_bigru(g, h, h, bias),
        "human_bd_embedding_mlp": init_mlp(g, [2 * h, h], bias),
        "human_segment_rnn_fcell": init_gru_cell(g, _human_segment_input_size(cfg), h, bias),
        "human_segment_rnn_bcell": init_gru_cell(g, _human_segment_input_size(cfg), h, bias),
        "object_embedding_mlp": init_mlp(g, [object_input_size, h], bias),
        "object_bd_rnn": init_bigru(g, h, h, bias),
        "object_bd_embedding_mlp": init_mlp(g, [2 * h, h], bias),
        "object_segment_rnn_fcell": init_gru_cell(g, _object_segment_input_size(cfg), h, bias),
        "object_segment_rnn_bcell": init_gru_cell(g, _object_segment_input_size(cfg), h, bias),
    })
    for flag, name in [
        (cfg.message_humans_to_human, "h2h"),
        (cfg.message_human_to_objects, "h2o"),
        (cfg.message_objects_to_human, "o2h"),
        (cfg.message_objects_to_object, "o2o"),
        (cfg.message_geometry_to_human, "s2h"),
        (cfg.message_geometry_to_objects, "s2o"),
    ]:
        if not flag:
            continue
        params[name] = {"frame": _init_message_params(g, cfg, segment=False)}
        if cfg.message_segment and name not in ("s2h", "s2o"):
            params[name]["segment"] = _init_message_params(g, cfg, segment=True)
    # The decision MLPs read [x, h] and each frame message that is on.
    num_hidden = cfg.discrete_networks_num_layers - 1
    time_u = h if cfg.add_time_position and cfg.time_position_strategy == "u" else 0
    upd_h_in = 2 * h + h * (cfg.message_humans_to_human + cfg.message_objects_to_human
                            + cfg.message_geometry_to_human) + time_u
    params["update_human_segment_mlp"] = init_mlp(g, [upd_h_in] + [h] * num_hidden + [1], bias)
    if cfg.object_segment_update_strategy not in {"same_as_human", "sah"}:
        upd_o_in = 2 * h + h * (cfg.message_human_to_objects + cfg.message_objects_to_object
                                + cfg.message_geometry_to_objects) + time_u
        params["update_object_segment_mlp"] = init_mlp(g, [upd_o_in] + [h] * num_hidden + [1],
                                                       bias)
    label_in = 2 * h + (2 * h if cfg.cat_level_states else 0)
    for head, width in [("human_recognition_mlp", num_subactivities),
                        ("human_prediction_mlp", num_subactivities),
                        ("object_recognition_mlp", num_affordances),
                        ("object_prediction_mlp", num_affordances)]:
        if width is not None:
            params[head] = init_mlp(g, [label_in, width], bias)
    if cfg.shared_heads:
        # The frame heads read the segment heads' parameters, so both levels'
        # gradients reach one tensor (the reference aliases the modules).
        return params
    for head, width in [("human_frame_recognition_mlp", num_subactivities),
                        ("human_frame_prediction_mlp", num_subactivities),
                        ("object_frame_recognition_mlp", num_affordances),
                        ("object_frame_prediction_mlp", num_affordances)]:
        if width is not None:
            params[head] = init_mlp(g, [2 * h, width], bias)
    return params


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def apply_tggcn(params: dict, cfg: TGGCNConfig,
                x_human: torch.Tensor, x_objects: torch.Tensor,
                objects_mask: torch.Tensor,
                human_segmentation: Optional[torch.Tensor] = None,
                objects_segmentation: Optional[torch.Tensor] = None,
                human_human_distances=None, human_object_distances=None,
                object_object_distances=None, steps_per_example=None,
                train: bool = False, inspect_model: bool = False,
                use_kernels: bool = True, noise: Optional[dict] = None,
                generator: Optional[torch.Generator] = None,
                carry: Optional[dict] = None, return_carry: bool = False,
                force_last_step_commit: bool = True, frame_offset=0, shard=None):
    """Forward pass. Returns (outputs list, aux dict), laid out as
    ``tggcn.models.tggcn.apply_tggcn``'s.

    aux holds 'bn_state' (the updated BatchNorm statistics when train, else
    unchanged), 'human_decisions' (B, T, H) and 'object_decisions' (B, T, O),
    each (hard, soft) with the hard decisions the scan used (filtered with
    filter_discrete_updates), and, with
    inspect_model, 'attention_scores' [frame, segment-fwd, segment-bwd]
    each (B, H, T, O) (zeros under mean pooling). use_kernels=False runs the
    kernels' plain PyTorch versions, forward and backward, on any device, as
    a reference.

    The 'gs' decisions take their Gumbel noise from ``noise`` ({'human':
    (B, T, H, 2), 'object': (B, T, O, 2)}) where it has an entry, else draw
    it from ``generator`` (default: seed 0 on the inputs' device): the
    humans' draw and then the objects', in that order, each where it is
    needed. The draws stay on the generator's device, so a step reads
    nothing back to the host (JAX splits its key in two instead,
    ``tggcn/models/tggcn.py:467``; its numbers cannot be reproduced anyway).
    With ``gs_noise='frame_indexed'`` the generator gives one key instead,
    and the noise of absolute frame ``frame_offset + i`` is a hash of (key,
    humans or objects, that frame, the element's place in it)
    (``frame_indexed_gumbel``), so a window draws what the whole clip draws.

    Data parallelism (``shard``, a ``tggcn_torch.parallel.distributed``
    ``BatchShard``: the inputs are this process's rows of a global batch):
    the GeoGCN BatchNorm trains on the global rows' statistics, and the
    Gumbel noise drawn here is the global batch's draw (the same
    generator's, at the global shape), of which this process takes its
    rows; ``noise`` handed in is already this process's rows.

    Streaming (``tggcn/models/tggcn.py:444-446, 529-538, 700-733, 793-802``):
    ``carry`` holds forward-direction initial states, any of
    'frame_human' (B, H, h), 'frame_object' (B, O, h), 'frame_geometry'
    (B, 1, h) (K1's forward h0) and 'seg_human' (B, H, h), 'seg_object' (B,
    O, h) (the segment scan's forward h0; its backward starts from zero),
    cast to the compute dtype as JAX casts them; ``return_carry`` adds
    aux['carry_seq'], the forward states of every step under the same keys
    (B, T, E, h), the segment ones before the reorder;
    ``force_last_step_commit=False`` leaves the final step's decisions as
    taken (the forced commit is right only at a clip's true end).
    """
    check_slice(cfg)
    dists3 = (human_human_distances, human_object_distances, object_object_distances)
    mode = segment_mode(cfg, dists3)
    work = work_dtype(cfg)
    b, t, num_humans = x_human.shape[0], x_human.shape[1], x_human.shape[2]
    num_objects = x_objects.shape[2]
    hidden = cfg.hidden_size
    carry = carry or {}

    # --- Mixed precision (tggcn/models/tggcn.py:477-491) ------------------
    if work is not None:
        params = cast_params_for_compute(params, work)
        x_objects, objects_mask = x_objects.to(work), objects_mask.to(work)
        dists3 = tuple(None if d is None else d.to(work) for d in dists3)
        if cfg.add_time_position or cfg.add_segment_length:
            steps_per_example = steps_per_example.to(work)
        carry = {k: v.to(work) for k, v in carry.items()}

    # --- Geometry stream -------------------------------------------------
    x_vis, x_geometry = x_human[..., :2048], x_human[:, :, 0, 2048:]
    if work is not None:
        x_vis = x_vis.to(work)          # the geometry stays float32 for the GCN and BN
    vw = x_geometry.shape[-1]
    if vw // 4 != cfg.gcn_node:
        raise ValueError(
            f"gcn_node={cfg.gcn_node} is inconsistent with the geometry feature "
            f"width {vw} (expected gcn_node={vw // 4}; use 19 for CAD-120, "
            f"30 for Bimanual, 26 for MPHOI).")
    x_geometry = x_geometry.reshape(b, t, vw // 4, 4)
    geo_out, bn_state = apply_geo_gcn(params["geometry_embedding_gcn"], x_geometry,
                                      train=train, fused=cfg.use_pallas_geo_gcn,
                                      use_kernels=use_kernels, shard=shard)
    if cfg.geometry_flatten == "per_frame":
        geo_flat = geo_out.reshape(b, t, 1, geo_out.shape[-1] * (vw // 4))
    else:
        # Reference quirk (models.py:644-645): the (B, 128, V, T) GCN output
        # is raw-memory reshaped to (B, T, 1, 128*V), which scrambles
        # (channel, node, time) into per-"frame" blocks. Kept for parity.
        geo_flat = geo_out.permute(0, 3, 2, 1).reshape(b, t, 1, geo_out.shape[-1] * (vw // 4))
    if work is not None:
        geo_flat = geo_flat.to(work)
    x_geo_emb = apply_mlp(params["geometry_embedding_mlp"], geo_flat,
                          activations=["relu", "relu"])
    x_hum_emb = apply_mlp(params["human_embedding_mlp"], x_vis, activations=["relu"])
    x_obj_emb = apply_mlp(params["object_embedding_mlp"], x_objects, activations=["relu"])

    # --- Frame-level BiGRUs: all three streams in one kernel call ---------
    frame_xs = [x_hum_emb, x_obj_emb, x_geo_emb]
    h0s = None
    if any(k in carry for k in FRAME_CARRIES):
        h0s = [carry[k] if k in carry else x.new_zeros((b, x.shape[2], hidden))
               for k, x in zip(FRAME_CARRIES, frame_xs)]
    h_hfr, h_ofr, h_sfr = run_multi_bigru(
        [params["human_bd_rnn"], params["object_bd_rnn"], params["geometry_bd_rnn"]],
        frame_xs, h0_fwd_list=h0s, use_kernels=use_kernels)
    h_hf = apply_mlp(params["human_bd_embedding_mlp"], h_hfr, activations=["relu"])
    h_of = apply_mlp(params["object_bd_embedding_mlp"], h_ofr, activations=["relu"])
    h_sf = apply_mlp(params["geometry_bd_embedding_mlp"], h_sfr, activations=["relu"])

    # --- Positional features (tggcn/models/tggcn.py:560-570) --------------
    ignore_div = cfg.positional_encoding_style in {"p", "periodic"}

    def positional(x, mlp):
        if cfg.embedding_positional:
            return apply_mlp(params[mlp], x, activations=["relu"])
        return make_periodic_embedding(x, hidden)

    x_time_emb = None
    if cfg.add_time_position:
        x_time = assemble_time_tensor(steps_per_example, t, ignore_div)      # (T, B, 1)
        x_time_emb = positional(x_time, "time_position_mlp").permute(1, 0, 2)   # (B, T, h)

    def time_features(n):
        return x_time_emb[:, :, None, :].expand(b, t, n, hidden)

    # --- Frame-level messages (vectorised over B, T) ----------------------
    mkw = cfg.message_kwargs()
    obj_mask_bt = objects_mask[:, None, :]                      # (B, 1, O)

    def frame_msg(name, receivers, senders, mask, exclude_self=False, dists=None):
        return compute_message_features(params[name]["frame"],
                                        torch.cat(receivers, dim=-1),
                                        torch.cat(senders, dim=-1), mask,
                                        exclude_self=exclude_self, distances=dists, **mkw)

    # Each edge only where its flag is on; each distance tensor where it is
    # given (tggcn/models/tggcn.py:583-615): objects receive from the
    # humans along the swapped (B, T, O, H) tensor.
    hh_d, ho_d, oo_d = dists3
    oh_d = None if ho_d is None else ho_d.transpose(2, 3)
    hum, obj, geo = [x_hum_emb, h_hf], [x_obj_emb, h_of], [x_geo_emb, h_sf]
    m_hh = m_oh = m_sh = m_ho = m_so = m_oo = att_frame = None
    if cfg.message_humans_to_human:
        m_hh, _ = frame_msg("h2h", hum, hum, None, exclude_self=True, dists=hh_d)
    if cfg.message_objects_to_human:
        m_oh, att_frame = frame_msg("o2h", hum, obj, obj_mask_bt[:, :, None, :], dists=ho_d)
    if cfg.message_geometry_to_human:
        m_sh, _ = frame_msg("s2h", hum, geo, None)
    if cfg.message_human_to_objects:
        m_ho = frame_msg("h2o", obj, hum, None, dists=oh_d)[0] * objects_mask[:, None, :, None]
    if cfg.message_geometry_to_objects:
        m_so = frame_msg("s2o", obj, geo, None)[0] * objects_mask[:, None, :, None]
    if cfg.message_objects_to_object:
        m_oo, _ = frame_msg("o2o", obj, obj, obj_mask_bt[:, :, None, :], exclude_self=True,
                            dists=oo_d)

    # --- Decisions (vectorised over B, T, E) -------------------------------
    noise, sources = dict(noise or {}), []
    gumbel = cfg.discrete_optimization_strategy in GUMBEL_STRATEGIES
    frame_indexed = gumbel and cfg.gs_noise == "frame_indexed"

    def source(who):
        """The generator `who` draws its noise from, where noise is missing
        (None for frame-indexed noise, which this puts in noise)."""
        if not gumbel or noise.get(who) is not None:
            return None
        if not sources:
            sources.append(generator or torch.Generator(device=x_human.device).manual_seed(0))
            if frame_indexed:
                sources.append(noise_key(sources[0]))
        if not frame_indexed:
            return sources[0]
        frames = frame_offset + torch.arange(t, device=x_human.device)
        n = num_humans if who == "human" else num_objects
        noise[who] = frame_indexed_gumbel(sources[1], NOISE_STREAMS[who], frames,
                                          b if shard is None else shard.global_rows, n)
        if shard is not None:
            noise[who] = shard.take(noise[who])
        return None

    def decide(name, features, imposed, who, gate=None):
        """(hard, soft) decisions; a 'coh' gate multiplies the hard ones
        before the forced commit at the final step (reference :701-702)."""
        if imposed is not None:
            u = imposed.to(x_hum_emb.dtype)
            return u, u
        u_soft = apply_mlp(params[name], torch.cat([f for f in features if f is not None], -1),
                           activations=["relu"] * (cfg.discrete_networks_num_layers - 1)
                           + ["sigmoid"])
        drawn_from = source(who)
        if drawn_from is not None and shard is not None:
            noise[who] = shard.take(gumbel_noise((shard.global_rows,) + u_soft.shape[1:-1] + (2,),
                                                 drawn_from, u_soft.dtype))
            drawn_from = None
        hard, soft = discrete_estimator(u_soft, strategy=cfg.discrete_optimization_strategy,
                                        threshold=cfg.update_segment_threshold,
                                        noise=noise.get(who), generator=drawn_from)
        hard = hard[..., 0]
        hard = hard * gate if gate is not None else hard.clone()
        if force_last_step_commit:
            hard[:, -1, :] = 1.0
        return hard, soft[..., 0]

    time_u = cfg.add_time_position and cfg.time_position_strategy == "u"
    u_h, u_h_soft = decide("update_human_segment_mlp",
                           [x_hum_emb, h_hf, m_hh, m_oh, m_sh,
                            time_features(num_humans) if time_u else None],
                           human_segmentation, "human")
    # The human decision conditions the object decision only with one human
    # (reference models.py:741-742): 'sah' copies it, 'coh' gates by it.
    strategy = cfg.object_segment_update_strategy
    if (num_humans == 1 and objects_segmentation is None
            and strategy in {"same_as_human", "sah"}):
        u_o = u_h.expand(b, t, num_objects)
        u_o_soft = u_h_soft.expand(b, t, num_objects)
    else:
        gate = u_h if num_humans == 1 and strategy in {"conditional_on_human", "coh"} else None
        u_o, u_o_soft = decide("update_object_segment_mlp",
                               [x_obj_emb, h_of, m_ho, m_oo, m_so,
                                time_features(num_objects) if time_u else None],
                               objects_segmentation, "object", gate)

    # --- Decision filtering (tggcn/models/tggcn.py:673-677) ----------------
    u_h_used, u_o_used = u_h, u_o
    if cfg.filter_discrete_updates:
        u_h_used = filter_soft_decisions(u_h_soft, cfg.update_segment_threshold)
        u_o_used = filter_soft_decisions(u_o_soft, cfg.update_segment_threshold)

    # --- Segment-level inputs (tggcn/models/tggcn.py:679-694) --------------
    x_hs = [h_hf, m_hh, m_oh, m_sh]
    x_os = [h_of, m_ho, m_so, m_oo]
    if cfg.add_time_position and cfg.time_position_strategy == "s":
        x_hs.append(time_features(num_humans))
        x_os.append(time_features(num_objects))
    if cfg.add_segment_length:
        for xs, u_used in ((x_hs, u_h_used), (x_os, u_o_used)):
            x_sl = assemble_segment_length_tensor(u_used, steps_per_example, ignore_div)
            xs.append(positional(x_sl, "segment_length_mlp"))
    x_hs = torch.cat([x for x in x_hs if x is not None], dim=-1)
    x_os = torch.cat([x for x in x_os if x is not None], dim=-1)

    # --- Segment-level gated bidirectional scan ----------------------------
    seg_carry = (carry.get("seg_human"), carry.get("seg_object"))
    if mode is None:
        with torch.profiler.record_function(GENERAL_SCAN_RANGE):
            hx_hs, hx_os, att_seg_f, att_seg_b = segment_scan_general(
                params, cfg, x_hs, x_os, u_h_used, u_o_used, objects_mask, *dists3,
                seg_carry=seg_carry)
    else:
        hx_hs, hx_os, att_seg_f, att_seg_b = _segment_scan_fast(
            params, cfg, mode, x_hs, x_os, u_h_used, u_o_used, objects_mask, dists3,
            use_kernels, seg_carry)
    # The forward segment states before the reorder: the streaming carries.
    seg_fwd = (hx_hs[..., :hidden], hx_os[..., :hidden])

    # --- Reorder: every frame labelled with its segment's final state ------
    hx = torch.cat([hx_hs, hx_os], dim=2)                     # (B, T, H+O, 2h)
    u = torch.cat([u_h_used, u_o_used], dim=2)
    n_e = hx.shape[2]
    hx = reorder_hidden_states(hx.permute(0, 2, 1, 3).reshape(b * n_e, t, -1),
                               u.permute(0, 2, 1).reshape(b * n_e, t))
    hx = hx.reshape(b, n_e, t, -1).permute(0, 2, 1, 3)
    hx_hs, hx_os = hx[:, :, :num_humans], hx[:, :, num_humans:]
    if cfg.cat_level_states:
        hx_hs = torch.cat([hx_hs, h_hfr], dim=-1)
        hx_os = torch.cat([hx_os, h_ofr], dim=-1)

    # --- Heads -------------------------------------------------------------
    def head(name, x):
        if cfg.shared_heads:
            name = name.replace("_frame_", "_")
        if work is not None:
            x = x.float()               # heads and log-softmax in float32 (:764-765)
        out = apply_mlp(params[name], x, activations=[{"name": "logsoftmax", "dim": -1}])
        return out.permute(0, 3, 1, 2)                        # (B, C, T, E)

    outputs = ([u_h_used, u_o_used, u_h_soft, u_o_soft] if cfg.num_classes[1] is not None
               else [u_h_used, u_h_soft])
    outputs += [head("human_frame_recognition_mlp", h_hfr),
                head("human_frame_prediction_mlp", h_hfr)]
    if cfg.num_classes[1] is not None:
        outputs += [head("object_frame_recognition_mlp", h_ofr),
                    head("object_frame_prediction_mlp", h_ofr)]
    outputs += [head("human_recognition_mlp", hx_hs), head("human_prediction_mlp", hx_hs)]
    if cfg.num_classes[1] is not None:
        outputs += [head("object_recognition_mlp", hx_os), head("object_prediction_mlp", hx_os)]

    if work is not None:
        # Every output is float32 whatever the compute dtype (:786-790).
        outputs = [o.float() for o in outputs]
        if cfg.num_classes[1] is None:
            u_o_used, u_o_soft = u_o_used.float(), u_o_soft.float()
        att_frame, att_seg_f, att_seg_b = (None if a is None else a.float()
                                           for a in (att_frame, att_seg_f, att_seg_b))
    human = (outputs[0], outputs[2 if cfg.num_classes[1] is not None else 1])
    objects = (outputs[1], outputs[3]) if cfg.num_classes[1] is not None else (u_o_used,
                                                                               u_o_soft)
    aux = {"bn_state": bn_state, "human_decisions": human, "object_decisions": objects}
    if return_carry:
        aux["carry_seq"] = {**{k: x[..., :hidden] for k, x in zip(FRAME_CARRIES,
                                                                  (h_hfr, h_ofr, h_sfr))},
                            "seg_human": seg_fwd[0], "seg_object": seg_fwd[1]}
    if inspect_model:
        # (B, T, H, O) -> (B, H, T, O), as the reference stacks them. Mean
        # pooling has no frame attention: zeros, as for its segment level.
        if att_frame is None:
            att_frame = torch.zeros_like(att_seg_f)
        aux["attention_scores"] = [a.permute(0, 2, 1, 3)
                                   for a in (att_frame, att_seg_f, att_seg_b)]
    return outputs, aux


def fast_segment_scan_applicable(cfg: TGGCNConfig) -> bool:
    """Whether JAX's fast segment path applies (``tggcn/models/tggcn.py:819``
    ``_fast_segment_scan_applicable``): non-relational generic messages on
    all four entity edges, with segment messages, by attention or mean
    pooling."""
    return (cfg.message_segment and not cfg.relational
            and cfg.message_granularity in GENERIC
            and (cfg.attention or cfg.message_aggregation in MEAN_POOLING)
            and cfg.message_humans_to_human and cfg.message_objects_to_human
            and cfg.message_human_to_objects and cfg.message_objects_to_object)


def segment_mode(cfg: TGGCNConfig, dists3) -> Optional[str]:
    """The segment scan's kernel mode (``segment_scan_pallas.py:694``
    ``pallas_segment_mode``): 'ext' for mean pooling or distance-based
    attention from all three distance tensors, else 'dot', 'v1' or 'v4' by
    attention style; None, for the general scan, where the fast path does
    not apply or a partial set of distance tensors mixes computed and
    distance-based attention."""
    if not fast_segment_scan_applicable(cfg):
        return None
    if cfg.message_aggregation in MEAN_POOLING:
        return "ext"
    given = [d is not None for d in dists3]
    if any(given):
        return "ext" if all(given) else None
    if cfg.attention_style in DOT_STYLES:
        return "dot"
    return "v1" if cfg.attention_style in {"v1", "concat"} else "v4"


def collect_att(params, mode: str):
    """The segment attention parameters of 'v1' ((4, 2h) weights) or 'v4'
    ((4, h, h)), and their biases (4,), in the score order hh, oh, ho, oo
    (``segment_scan_pallas.py:729`` ``_collect_att``)."""
    ws, bs = [], []
    for edge in ("h2h", "o2h", "h2o", "o2o"):
        att = params[edge]["segment"]["att"]
        if mode == "v1":
            layer = att["layers"][0]
            w, b = layer["w"][:, 0], layer.get("b")
        else:
            w, b = att["w"][0], att.get("b")
        ws.append(w)
        bs.append(w.new_zeros(()) if b is None else b[0])
    return torch.stack(ws).contiguous(), torch.stack(bs).contiguous()


def external_att_weights(mean_pooling: bool, dists3, objects_mask, t: int, nh: int):
    """The state-independent segment attention weights of 'ext' mode
    (``segment_scan_pallas.py:750`` ``_external_att_weights``), time-major
    and packed as (T, B, E, E), E = H + O: row n < H holds [a_hh | a_oh] of
    human n, row H + o [a_ho | a_oo] of object o. Mean pooling takes uniform
    weights over the unmasked senders, distance-based attention the
    inverse-distance softmax of the (B, T, R, S) distances dists3."""
    b, no = objects_mask.shape
    dtype, dev = objects_mask.dtype, objects_mask.device
    mask_hh = (1.0 - torch.eye(nh, dtype=dtype, device=dev))[None, None]   # (1, 1, H, H)
    mask_oh = objects_mask[None, :, None, :]                               # (1, B, 1, O)
    mask_ho = torch.ones((1, 1, 1, nh), dtype=dtype, device=dev)
    mask_oo = mask_oh * (1.0 - torch.eye(no, dtype=dtype, device=dev))[None, None]
    if mean_pooling:
        def weights(mask, r, s):
            full = torch.broadcast_to(mask, (1, b, r, s))
            return torch.broadcast_to(full / torch.clamp(full.sum(-1, keepdim=True), min=1.0),
                                      (t, b, r, s))
        parts = (weights(mask_hh, nh, nh), weights(mask_oh, nh, no),
                 weights(mask_ho, no, nh), weights(mask_oo, no, no))
    else:
        hh_d, ho_d, oo_d = (d.transpose(0, 1) for d in dists3)            # (T, B, R, S)

        def weights(d, mask):
            return distance_based_attention_weights(d, torch.broadcast_to(mask, d.shape))
        parts = (weights(hh_d, mask_hh), weights(ho_d, mask_oh),
                 weights(ho_d.transpose(-1, -2), mask_ho), weights(oo_d, mask_oo))
    a_hh, a_oh, a_ho, a_oo = parts
    return torch.cat([torch.cat([a_hh, a_oh], dim=-1),
                      torch.cat([a_ho, a_oo], dim=-1)], dim=-2).contiguous()


def _scan_inputs(params, cfg: TGGCNConfig, x_hs, x_os, u_h, u_o, objects_mask,
                 seg_carry=(None, None)):
    """The kernels' inputs (see ``tggcn_torch.ops.segment_scan``): base gates
    (2, T, B, E, 3h) of both directions, time-major decisions, stacked
    weights, the object mask and the initial states (the forward ones from
    seg_carry where given, else zero)."""
    b, t, num_humans, base_h = x_hs.shape
    num_objects, base_o = x_os.shape[2], x_os.shape[-1]
    h = cfg.hidden_size
    cells_h = [params["human_segment_rnn_fcell"], params["human_segment_rnn_bcell"]]
    cells_o = [params["object_segment_rnn_fcell"], params["object_segment_rnn_bcell"]]
    zeros3 = x_hs.new_zeros(3 * h)

    def base_gates(cells, x, base):
        gi = torch.stack([x @ c["w_ih"][:base] + c.get("b_ih", zeros3) for c in cells])
        return gi.permute(0, 2, 1, 3, 4).contiguous()          # (2, T, B, E, 3h)

    def stack(cells, fn):
        return torch.stack([fn(c) for c in cells]).contiguous()

    def msg_layer(edge):
        layer = params[edge]["segment"]["msg"]["layers"][0]
        return layer["w"], layer.get("b", x_hs.new_zeros(h))

    edges = [msg_layer(e) for e in ("h2h", "h2o", "o2h", "o2o")]
    time_major = lambda u: u.permute(1, 0, 2).contiguous()      # (T, B, E)
    return (base_gates(cells_h, x_hs, base_h), base_gates(cells_o, x_os, base_o),
            time_major(u_h), time_major(u_o),
            torch.stack([w for w, _ in edges]), torch.stack([bb for _, bb in edges]),
            stack(cells_h, lambda c: c["w_ih"][base_h:]), stack(cells_o, lambda c: c["w_ih"][base_o:]),
            stack(cells_h, lambda c: c["w_hh"]), stack(cells_o, lambda c: c["w_hh"]),
            stack(cells_h, lambda c: c.get("b_hh", zeros3)),
            stack(cells_o, lambda c: c.get("b_hh", zeros3)),
            objects_mask.to(x_hs.dtype).contiguous(),
            initial_states(x_hs, num_humans, h, seg_carry[0]).contiguous(),
            initial_states(x_hs, num_objects, h, seg_carry[1]).contiguous())


def _order(h_h, h_o, att):
    """The kernels' outputs (2, T, B, E, h) and (2, T, B, H, O) as
    (hx_hs (B, T, H, 2h), hx_os (B, T, O, 2h), att fwd, att bwd (B, T, H, O))."""
    order = lambda seq: torch.cat([seq[0], seq[1]], dim=-1).permute(1, 0, 2, 3)
    return order(h_h), order(h_o), att[0].permute(1, 0, 2, 3), att[1].permute(1, 0, 2, 3)


def _k5_scan(params, cfg: TGGCNConfig, mode: str, x_hs, x_os, u_h, u_o, objects_mask, dists3,
             use_kernels: bool, seg_carry=(None, None)):
    """The scan through K5 in `mode` (its plain version with
    use_kernels=False or on the CPU), forward only."""
    args = _scan_inputs(params, cfg, x_hs, x_os, u_h, u_o, objects_mask, seg_carry)
    mean_pooling = cfg.message_aggregation in {"mp", "mean_pooling"}
    if mode == "ext":
        extra = dict(att_ext=external_att_weights(mean_pooling, dists3, args[12], x_hs.shape[1],
                                                  x_hs.shape[2]))
    else:
        w_att, b_att = collect_att(params, mode)
        extra = dict(w_att=w_att, b_att=b_att)
    h_h, h_o, att = segment_scan_forward(mode, *args, use_kernels=use_kernels, **extra)
    if mean_pooling:
        att = torch.zeros_like(att)
    return _order(h_h, h_o, att)


def flatten(tree):
    """(leaves, rebuild) of a tree of dicts and lists: rebuild(values) is the
    tree with its leaves replaced by values, in the order of leaves."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        leaves.append(x)
        return len(leaves) - 1

    spec = walk(tree)

    def rebuild(values):
        def fill(s):
            if isinstance(s, dict):
                return {k: fill(v) for k, v in s.items()}
            if isinstance(s, (list, tuple)):
                return type(s)(fill(v) for v in s)
            return values[s]
        return fill(spec)

    return leaves, rebuild


def _segment_scan_fast(params, cfg: TGGCNConfig, mode: str, x_hs, x_os, u_h, u_o,
                       objects_mask, dists3, use_kernels: bool = True, seg_carry=(None, None)):
    """Gated bidirectional segment scan of the fast path's configurations
    (non-relational generic messages on all four entity edges), both
    directions in one call: through ``segment_scan_dot_autograd`` (K3,
    K4) in 'dot' mode; else through K5 forward, with the gradients of
    ``segment_scan_fast`` (JAX's XLA fast path) recomputed at the saved
    inputs when a gradient will be taken (``segment_scan_recompute``), as
    JAX's custom VJP takes them: they reach every segment parameter, x_hs,
    x_os, the decisions u_h and u_o, the distances and the carries.
    seg_carry holds the forward direction's initial states ((B, H, h) or
    None, (B, O, h) or None). Returns (hx_hs (B,T,H,2h), hx_os (B,T,O,2h),
    att fwd, att bwd (B,T,H,O)); mean pooling records zeros for the
    attention, as JAX does."""
    if mode == "dot":
        args = _scan_inputs(params, cfg, x_hs, x_os, u_h, u_o, objects_mask, seg_carry)
        h = cfg.hidden_size
        scale = 1.0 / math.sqrt(h) if cfg.attention_style in {"v3", "scaled_dot-product"} else 1.0
        return _order(*segment_scan_dot_autograd(*args, scale, use_kernels=use_kernels))
    seg = {**{c: params[c] for c in CELLS},
           **{e: {"segment": params[e]["segment"]} for e in EDGES}}
    leaves, rebuild = flatten(seg)
    n = len(leaves)

    def split(inputs):
        return (rebuild(inputs[:n]), *inputs[n:n + 5], inputs[n + 5:n + 8], inputs[n + 8:])

    def run(*inputs):
        p, xh, xo, uh, uo, mask, d3, c2 = split(inputs)
        return _k5_scan(p, cfg, mode, xh, xo, uh, uo, mask, d3, use_kernels, c2)

    def recompute(*inputs):
        p, xh, xo, uh, uo, mask, d3, c2 = split(inputs)
        return segment_scan_fast(p, cfg, xh, xo, uh, uo, mask, *d3, seg_carry=c2)

    return segment_scan_recompute(run, recompute, *leaves, x_hs, x_os, u_h, u_o, objects_mask,
                                  *dists3, *seg_carry)
