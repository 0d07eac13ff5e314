"""CAD120Baseline / BimanualBaseline: per-entity BiGRUs and pooled messages.

Counterpart of ``tggcn/models/baselines.py`` (reference vhoi/models.py:15-175).
The entities of a kind are folded into the batch, and both kinds' BiGRUs
(humans and objects, both h wide) advance in one ``run_multi_bigru`` call:
the K1 kernel forward and the K2 kernel backward on the card, their plain
versions on the CPU or with ``use_kernels=False``. Without
``bidirectional`` only the 'fwd' cells run (K1 with no reversed stream),
as JAX's ``run_gru`` on params['fwd']; the 'bwd' cells are still made, as
JAX makes them. The baselines run in float32, as JAX runs them.
"""

from dataclasses import dataclass

import torch

from tggcn_torch.nn.gru import init_bigru, run_multi_bigru
from tggcn_torch.nn.mlp import apply_mlp, init_mlp

BASELINES = frozenset({"bimanual_baseline", "cad120_baseline"})
LOG_SOFTMAX = [{"name": "logsoftmax", "dim": -1}]


@dataclass(frozen=True)
class BaselineConfig:
    """The fields of ``tggcn.models.baselines.BaselineConfig``, with its
    defaults. ``from_kwargs`` drops every key that is not a field, as JAX's
    does, so ``compute_dtype`` (and any 2G-GCN knob in a shared
    configuration) is ignored: a baseline runs in float32."""
    input_size: tuple
    num_classes: tuple
    hidden_size: int = 128
    bidirectional: bool = True
    with_message_passing: bool = True
    bias: bool = True
    with_object_head: bool = False  # True for CAD120Baseline

    @classmethod
    def from_kwargs(cls, with_object_head=False, **kwargs):
        fields = cls.__dataclass_fields__
        clean = {k: v for k, v in kwargs.items() if k in fields}
        clean["input_size"] = tuple(clean["input_size"])
        clean["num_classes"] = tuple(clean["num_classes"])
        clean["with_object_head"] = with_object_head
        return cls(**clean)


def init_baseline(generator: torch.Generator, cfg: BaselineConfig) -> dict:
    """Random parameters with the keys and shapes of ``tggcn``'s
    init_baseline, on the generator's device."""
    human_in, object_in = cfg.input_size
    num_subactivities, num_affordances = cfg.num_classes
    h, bias, g = cfg.hidden_size, cfg.bias, generator
    params = {
        "human_embedding_mlp": init_mlp(g, [human_in, h], bias),
        "object_embedding_mlp": init_mlp(g, [object_in, h], bias),
        "human_bd_rnn": init_bigru(g, h, h, bias),
        "object_bd_rnn": init_bigru(g, h, h, bias),
    }
    rec_in = h * (2 if cfg.with_message_passing else 1) * (2 if cfg.bidirectional else 1)
    params["human_recognition_mlp"] = init_mlp(g, [rec_in, num_subactivities], bias)
    if cfg.with_object_head:
        params["object_recognition_mlp"] = init_mlp(g, [rec_in, num_affordances], bias)
    return params


def _head(params, x):
    """Log-softmax head, transposed to (B, C, T, E)."""
    return apply_mlp(params, x, activations=LOG_SOFTMAX).permute(0, 3, 1, 2)


def apply_baseline(params: dict, cfg: BaselineConfig, x_human: torch.Tensor,
                   x_objects: torch.Tensor, objects_mask: torch.Tensor,
                   use_kernels: bool = True) -> list:
    """Forward; returns the reference's output list, [y_human] or [y_human,
    y_object], each (B, C, T, E) log-probabilities. A human receives the
    mean of the real objects' states (their count clipped at 1); an object
    receives the sum of the humans' states."""
    x_h = apply_mlp(params["human_embedding_mlp"], x_human, activations=["relu"])
    x_o = apply_mlp(params["object_embedding_mlp"], x_objects, activations=["relu"])
    hx_hfr, hx_ofr = run_multi_bigru([params["human_bd_rnn"], params["object_bd_rnn"]],
                                     [x_h, x_o], use_kernels=use_kernels,
                                     bidirectional=cfg.bidirectional)
    num_humans, num_objects = x_human.shape[2], x_objects.shape[2]
    if cfg.with_message_passing:
        mask = objects_mask[:, None, :, None]
        hx_ofm = torch.sum(hx_ofr * mask, dim=2, keepdim=True)
        hx_ofm = hx_ofm / torch.clamp(torch.sum(mask, dim=2, keepdim=True), min=1.0)
        hx_h = torch.cat([hx_hfr, hx_ofm.expand(-1, -1, num_humans, -1)], dim=-1)
    else:
        hx_h = hx_hfr
    y_h = _head(params["human_recognition_mlp"], hx_h)
    if not cfg.with_object_head:
        return [y_h]
    if cfg.with_message_passing:
        hx_hfm = torch.sum(hx_hfr, dim=2, keepdim=True)
        hx_o = torch.cat([hx_ofr, hx_hfm.expand(-1, -1, num_objects, -1)], dim=-1)
    else:
        hx_o = hx_ofr
    return [y_h, _head(params["object_recognition_mlp"], hx_o)]
