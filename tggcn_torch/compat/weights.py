"""Weight bridges: JAX pytrees and reference state dicts -> port tensors.

The port's parameter trees have the keys of ``tggcn``'s (``params[
"human_bd_rnn"]["fwd"]["w_hh"]``, ...), so carrying a JAX tree over is a
map of its leaves (``params_from_numpy``, and back: ``params_to_numpy``); a JAX baseline tree bridges the same way.
``tggcn_params_from_torch_state_dict`` and
``baseline_params_from_torch_state_dict`` are copies, free of JAX, of
``tggcn/compat/torch_weights.py``'s loaders for reference-named state dicts
(the ``weight::`` blocks of the golden fixtures and reference checkpoints).
"""

from typing import Dict

import numpy as np
import torch

from tggcn_torch.models.tggcn import TGGCNConfig


def params_from_numpy(tree, device="cpu"):
    """A tree of dicts/lists of arrays (e.g. a JAX pytree mapped through
    ``np.asarray``) -> the same tree of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def params_to_numpy(tree):
    """The inverse of params_from_numpy: a tree of tensors -> the same tree
    of float32 numpy arrays on the host, each a copy (a snapshot of
    parameters that a train step updates in place); leaves that are not
    tensors (a checkpoint's scalers, numbers) as they are."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", torch.float32, copy=True).numpy()
    return tree


def _t(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _linear(sd, name):
    layer = {"w": _t(np.asarray(sd[f"{name}.weight"]).T)}
    if f"{name}.bias" in sd:
        layer["b"] = _t(sd[f"{name}.bias"])
    return layer


def _mlp(sd, name):
    """Sequential of Linear + activation: Linear modules sit at even indices."""
    layers = []
    idx = 0
    while f"{name}.{idx}.weight" in sd:
        layers.append(_linear(sd, f"{name}.{idx}"))
        idx += 2
    if not layers:
        raise KeyError(f"No linear layers found for MLP {name}")
    return {"layers": layers}


def _gru_cell(sd, name):
    params = {"w_ih": _t(np.asarray(sd[f"{name}.weight_ih"]).T),
              "w_hh": _t(np.asarray(sd[f"{name}.weight_hh"]).T)}
    if f"{name}.bias_ih" in sd:
        params["b_ih"] = _t(sd[f"{name}.bias_ih"])
        params["b_hh"] = _t(sd[f"{name}.bias_hh"])
    return params


def _bigru(sd, name):
    def direction(suffix):
        params = {"w_ih": _t(np.asarray(sd[f"{name}.weight_ih_l0{suffix}"]).T),
                  "w_hh": _t(np.asarray(sd[f"{name}.weight_hh_l0{suffix}"]).T)}
        if f"{name}.bias_ih_l0{suffix}" in sd:
            params["b_ih"] = _t(sd[f"{name}.bias_ih_l0{suffix}"])
            params["b_hh"] = _t(sd[f"{name}.bias_hh_l0{suffix}"])
        return params

    return {"fwd": direction(""), "bwd": direction("_reverse")}


def _bilinear(sd, name):
    params = {"w": _t(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        params["b"] = _t(sd[f"{name}.bias"])
    return params


def _conv1x1(sd, name):
    layer = {"w": _t(np.asarray(sd[f"{name}.weight"])[:, :, 0, 0].T)}
    if f"{name}.bias" in sd:
        layer["b"] = _t(sd[f"{name}.bias"])
    return layer


def _geo_gcn(sd, cfg: TGGCNConfig):
    v = cfg.gcn_node
    prefix = "geometry_embedding_gcn"
    bn = {k: _t(np.asarray(sd[f"{prefix}.joint_embed.cnn.0.bn.{k}"]).reshape(4, v).T)
          for k in ("weight", "bias", "running_mean", "running_var")}
    return {
        "bn": {"params": {"scale": bn["weight"], "bias": bn["bias"]},
               "state": {"mean": bn["running_mean"], "var": bn["running_var"]}},
        "embed1": _conv1x1(sd, f"{prefix}.joint_embed.cnn.1.cnn"),
        "embed2": _conv1x1(sd, f"{prefix}.joint_embed.cnn.3.cnn"),
        "s1": _conv1x1(sd, f"{prefix}.get_s.s1.cnn"),
        "s2": _conv1x1(sd, f"{prefix}.get_s.s2.cnn"),
        "weight": _t(sd[f"{prefix}.weight"]),
    }


# Reference message-module name stems per edge type (the reference's frame
# and segment naming is irregular, e.g. relational o2h modules are called
# human_object_*).
_EDGE_NAMES = {
    "h2h": {"rel": "human_human", "msg": "humans_to_human_message_mlp",
            "att": "humans_to_human_message_att_mlp",
            "seg_msg": "humans_to_human_segment_message_mlp",
            "seg_att": "humans_to_human_segment_message_att_mlp"},
    "h2o": {"rel": "object_human", "msg": "human_to_object_message_mlp",
            "att": "humans_to_object_message_att_mlp",
            "seg_msg": "human_to_object_segment_message_mlp",
            "seg_att": "humans_to_object_segment_message_att_mlp"},
    "o2h": {"rel": "human_object", "msg": "objects_to_human_message_mlp",
            "att": "objects_to_human_message_att_mlp",
            "seg_msg": "objects_to_human_segment_message_mlp",
            "seg_att": "objects_to_human_segment_message_att_mlp"},
    "o2o": {"rel": "object_object", "msg": "objects_to_object_message_mlp",
            "att": "objects_to_object_message_att_mlp",
            "seg_msg": "objects_to_object_segment_message_mlp",
            "seg_att": "objects_to_object_segment_message_att_mlp"},
    "s2h": {"rel": "human_geometry", "msg": "geometry_to_human_message_mlp",
            "att": "geometry_to_human_message_att_mlp",
            "seg_msg": "geometry_to_human_segment_message_mlp",
            "seg_att": "geometry_to_human_segment_message_att_mlp"},
    "s2o": {"rel": "object_geometry", "msg": "geometry_to_object_message_mlp",
            "att": "geometry_to_object_message_att_mlp",
            "seg_msg": "geometry_to_object_segment_message_mlp",
            "seg_att": "geometry_to_object_segment_message_att_mlp"},
}


def _edge_params(sd, cfg: TGGCNConfig, edge: str):
    names = _EDGE_NAMES[edge]
    out = {}
    if cfg.relational:
        out["frame"] = {"g": _mlp(sd, f"{names['rel']}_pairwise_relation_mlp"),
                        "f": _mlp(sd, f"{names['rel']}_full_relation_mlp")}
        if cfg.message_segment and f"{names['rel']}_segment_pairwise_relation_mlp.0.weight" in sd:
            out["segment"] = {"g": _mlp(sd, f"{names['rel']}_segment_pairwise_relation_mlp"),
                              "f": _mlp(sd, f"{names['rel']}_segment_full_relation_mlp")}
        return out

    def bundle(msg, att):
        params = {"msg": _mlp(sd, msg)}
        if cfg.attention:
            if cfg.attention_style in {"v4", "general"}:
                params["att"] = _bilinear(sd, att)
            elif f"{att}.0.weight" in sd:
                params["att"] = _mlp(sd, att)
        return params

    out["frame"] = bundle(names["msg"], names["att"])
    if cfg.message_segment and f"{names['seg_msg']}.0.weight" in sd:
        out["segment"] = bundle(names["seg_msg"], names["seg_att"])
    return out


def tggcn_params_from_torch_state_dict(sd: Dict[str, np.ndarray], cfg: TGGCNConfig) -> dict:
    """A reference TGGCN state_dict (numpy arrays under the reference's
    module names) -> the port's parameter tree, as CPU float32 tensors."""
    params = {
        "geometry_embedding_gcn": _geo_gcn(sd, cfg),
        "geometry_embedding_mlp": _mlp(sd, "geometry_embedding_mlp"),
        "geometry_bd_rnn": _bigru(sd, "geometry_bd_rnn"),
        "geometry_bd_embedding_mlp": _mlp(sd, "geometry_bd_embedding_mlp"),
        "human_embedding_mlp": _mlp(sd, "human_embedding_mlp"),
        "human_bd_rnn": _bigru(sd, "human_bd_rnn"),
        "human_bd_embedding_mlp": _mlp(sd, "human_bd_embedding_mlp"),
        "human_segment_rnn_fcell": _gru_cell(sd, "human_segment_rnn_fcell"),
        "human_segment_rnn_bcell": _gru_cell(sd, "human_segment_rnn_bcell"),
        "object_embedding_mlp": _mlp(sd, "object_embedding_mlp"),
        "object_bd_rnn": _bigru(sd, "object_bd_rnn"),
        "object_bd_embedding_mlp": _mlp(sd, "object_bd_embedding_mlp"),
        "object_segment_rnn_fcell": _gru_cell(sd, "object_segment_rnn_fcell"),
        "object_segment_rnn_bcell": _gru_cell(sd, "object_segment_rnn_bcell"),
        "update_human_segment_mlp": _mlp(sd, "update_human_segment_mlp"),
    }
    if "update_object_segment_mlp.0.weight" in sd:
        params["update_object_segment_mlp"] = _mlp(sd, "update_object_segment_mlp")
    for flag, edge in [
        (cfg.message_humans_to_human, "h2h"),
        (cfg.message_human_to_objects, "h2o"),
        (cfg.message_objects_to_human, "o2h"),
        (cfg.message_objects_to_object, "o2o"),
        (cfg.message_geometry_to_human, "s2h"),
        (cfg.message_geometry_to_objects, "s2o"),
    ]:
        if flag:
            params[edge] = _edge_params(sd, cfg, edge)
    for head in ["human_recognition_mlp", "human_prediction_mlp",
                 "object_recognition_mlp", "object_prediction_mlp",
                 "human_frame_recognition_mlp", "human_frame_prediction_mlp",
                 "object_frame_recognition_mlp", "object_frame_prediction_mlp",
                 "time_position_mlp", "segment_length_mlp"]:
        if f"{head}.0.weight" in sd:
            params[head] = _mlp(sd, head)
    if cfg.share_level_mlps and not cfg.cat_level_states:
        # Shared level heads carry no separate parameters; drop any frame-head
        # entries picked up from the state_dict aliases.
        for head in ["human_frame_recognition_mlp", "human_frame_prediction_mlp",
                     "object_frame_recognition_mlp", "object_frame_prediction_mlp"]:
            params.pop(head, None)
    return params


def baseline_params_from_torch_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """A reference CAD120Baseline / BimanualBaseline state_dict -> the port's
    parameter tree, as CPU float32 tensors
    (``tggcn/compat/torch_weights.py:223-235``)."""
    params = {
        "human_embedding_mlp": _mlp(sd, "human_embedding_mlp"),
        "object_embedding_mlp": _mlp(sd, "object_embedding_mlp"),
        "human_bd_rnn": _bigru(sd, "human_bd_rnn"),
        "object_bd_rnn": _bigru(sd, "object_bd_rnn"),
        "human_recognition_mlp": _mlp(sd, "human_recognition_mlp"),
    }
    if "object_recognition_mlp.0.weight" in sd:
        params["object_recognition_mlp"] = _mlp(sd, "object_recognition_mlp")
    return params
