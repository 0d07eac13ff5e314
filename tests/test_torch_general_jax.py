"""The general segment scan, the relational and 'specific' messages and the
init of every configuration against the JAX package on the CPU, module by
module, at hidden 8-16 and T <= 8, on the same numpy inputs from a seed.

* ``segment_scan_general`` against ``tggcn.models.tggcn._segment_scan``
  (JAX's XLA route), float32: the outputs and the gradients (autograd
  against jax.grad of the same weighted sum of the outputs) of every
  segment parameter, the inputs, the decisions and the distances, within
  atol 1e-5, for CAD-120's edges (one human, no humans-to-human edge),
  ``message_segment=False``, relational messages, 'specific' messages and
  a partial set of distance tensors; and a one-object clip, whose
  objects-to-object row has no sender left, stays finite.
* The same scan in bfloat16 against JAX's bfloat16 ``_segment_scan``:
  both run everything in bfloat16, the carried states included; the
  outputs within 1e-2 absolute (measured 7.8e-3; a float32 carry read
  1.17e-2), and at most 45% of the output elements differ from JAX's in
  any bit (measured 33% and 36%; a float32 carry read 56% and 58%).
* ``compute_message_features``, relational and 'specific', with and
  without a sender mask, with exclude_self, by attention, mean pooling and
  distances, within rtol 1e-5, atol 1e-6 (tests/test_torch_nn.py's).
* ``init_tggcn``'s tree against JAX's, in shapes, for each configuration.
* The CAD-120 stage-1 forward (``models/cad120.py``) at hidden 16, its
  'gs' decisions taken (nothing imposed) with JAX's Gumbel draws passed
  in, against JAX's apply_tggcn at rtol 1e-4, atol 1e-5 (as
  tests/test_torch_model.py holds the MPHOI forward): the one whole-model
  JAX compile of this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _jax_noise
from tggcn.models.tggcn import TGGCNConfig as JaxConfig
from tggcn.models.tggcn import _segment_scan as jax_segment_scan
from tggcn.models.tggcn import apply_tggcn as jax_apply
from tggcn.models.tggcn import init_tggcn as jax_init
from tggcn.nn import messages as jax_messages
from tggcn.nn.mlp import init_bilinear as jax_init_bilinear
from tggcn.nn.mlp import init_mlp as jax_init_mlp
from tggcn_torch.compat.weights import params_from_numpy
from tggcn_torch.models import cad120
from tggcn_torch.models.segment_general import segment_scan_general
from tggcn_torch.models.tggcn import TGGCNConfig, apply_tggcn, init_tggcn
from tggcn_torch.nn.messages import compute_message_features

CAD120 = dict(input_size=(2124, 2048), num_classes=(10, 12), hidden_size=8, gcn_node=19,
              message_humans_to_human=False, message_segment=True, message_type="v2",
              message_granularity="v1", message_aggregation="att", attention_style="v3",
              discrete_optimization_strategy="st", object_segment_update_strategy="ind")
MPHOI = dict(CAD120, input_size=(2152, 2048), num_classes=(13, None), gcn_node=26,
             message_humans_to_human=True)
# Each case: the configuration, humans, objects and the distances given.
SCANS = {
    "cad120": (CAD120, 1, 3, ()),
    "no_segment_messages": (dict(MPHOI, message_segment=False), 2, 3, ()),
    "relational": (dict(CAD120, message_type="v1", message_granularity="v2",
                        message_aggregation="mp", attention_style="v1"), 1, 3, ()),
    "specific": (dict(MPHOI, message_granularity="v2", attention_style="v1"), 2, 3, ()),
    "partial_distances": (CAD120, 1, 3, ("ho", "oo")),
}
SEGMENT_KEYS = ("human_segment_rnn_fcell", "human_segment_rnn_bcell",
                "object_segment_rnn_fcell", "object_segment_rnn_bcell")
B, T = 2, 7
ATOL = 1e-5
BF16_ATOL = 1e-2
BF16_DIFFERING = 0.45       # the share of output elements not equal to JAX's


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _segment_params(kwargs):
    """The segment scan's parameters of JAX's init: its four cells and the
    segment bundles of the entity edges, as numpy arrays."""
    params = _np(jax_init(jax.random.PRNGKey(0), JaxConfig.from_kwargs(**kwargs)))
    out = {k: params[k] for k in SEGMENT_KEYS}
    out.update({k: {"segment": v["segment"]} for k, v in params.items()
                if isinstance(v, dict) and "segment" in v})
    return out


def _scan_inputs(kwargs, nh, no, given, seed=0):
    """Seeded inputs of one scan: x_hs and x_os as wide as the cells' input
    less their segment messages, decisions that commit the last step, an
    object mask with empty slots, and the given distances (zeros among
    them)."""
    cfg = JaxConfig.from_kwargs(**kwargs)
    params = _segment_params(kwargs)
    h = cfg.hidden_size
    seg = cfg.message_segment
    msg_h = h * seg * (cfg.message_humans_to_human + cfg.message_objects_to_human)
    msg_o = h * seg * (cfg.message_human_to_objects + cfg.message_objects_to_object)
    rng = np.random.default_rng(seed)
    f_h = params["human_segment_rnn_fcell"]["w_ih"].shape[0] - msg_h
    f_o = params["object_segment_rnn_fcell"]["w_ih"].shape[0] - msg_o
    u_h = (rng.uniform(size=(B, T, nh)) > 0.4).astype(np.float32)
    u_o = (rng.uniform(size=(B, T, no)) > 0.4).astype(np.float32)
    u_h[:, -1], u_o[:, -1] = 1.0, 1.0
    mask = np.ones((B, no), np.float32)
    mask[1, 1:] = 0.0

    def dist(r, s):
        return np.where(rng.uniform(size=(B, T, r, s)) < 0.2, 0.0,
                        rng.uniform(0.1, 3.0, size=(B, T, r, s))).astype(np.float32)
    shapes = {"hh": (nh, nh), "ho": (nh, no), "oo": (no, no)}
    dists = {k: dist(*shapes[k]) if k in given else None for k in ("hh", "ho", "oo")}
    inputs = dict(x_hs=rng.normal(size=(B, T, nh, f_h)).astype(np.float32),
                  x_os=rng.normal(size=(B, T, no, f_o)).astype(np.float32),
                  u_h=u_h, u_o=u_o, objects_mask=mask)
    return cfg, params, inputs, dists


def _cotangents(outputs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in outputs]


def _jax_scan(cfg, params, inputs, dists, dtype=jnp.float32):
    cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    return jax_segment_scan(cast(params), cfg, *cast(list(inputs.values())),
                            *(None if d is None else cast(d) for d in dists.values()))


def _port_scan(kwargs, params, inputs, dists, dtype=torch.float32, grad=False):
    tensors = {k: torch.tensor(v, dtype=dtype, requires_grad=grad and k != "objects_mask")
               for k, v in inputs.items()}
    d = {k: None if v is None else torch.tensor(v, dtype=dtype, requires_grad=grad)
         for k, v in dists.items()}
    p = jax.tree_util.tree_map(lambda a: a.to(dtype).requires_grad_(grad),
                               params_from_numpy(params))
    out = segment_scan_general(p, TGGCNConfig.from_kwargs(**kwargs), *tensors.values(),
                               *d.values())
    return out, p, tensors, d


@pytest.mark.parametrize("case", list(SCANS))
def test_general_scan_matches_jax(case):
    kwargs, nh, no, given = SCANS[case]
    cfg, params, inputs, dists = _scan_inputs(kwargs, nh, no, given)
    want = _jax_scan(cfg, params, inputs, dists)
    got, p, tensors, d = _port_scan(kwargs, params, inputs, dists, grad=True)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=f"output {i}")
    cot = _cotangents(want, 1)
    diff = [k for k, v in inputs.items() if k != "objects_mask"]
    given_d = [k for k, v in dists.items() if v is not None]

    def loss(params, xs, ds):
        full = dict(inputs, **xs)
        out = jax_segment_scan(params, cfg, *full.values(),
                               *(ds.get(k, dists[k]) for k in ("hh", "ho", "oo")))
        return sum(jnp.sum(o * c) for o, c in zip(out, cot))

    g_params, g_x, g_d = jax.grad(loss, argnums=(0, 1, 2))(
        params, {k: inputs[k] for k in diff}, {k: dists[k] for k in given_d})
    sum((o * torch.tensor(c)).sum() for o, c in zip(got, cot)).backward()
    want_leaves = jax.tree_util.tree_leaves_with_path(g_params)
    got_leaves = jax.tree_util.tree_leaves(p)
    assert len(want_leaves) == len(got_leaves)
    for (path, w), g in zip(want_leaves, got_leaves):
        g = np.zeros_like(np.asarray(w)) if g.grad is None else g.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    for k in diff:
        np.testing.assert_allclose(tensors[k].grad.numpy(), np.asarray(g_x[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
    for k in given_d:
        np.testing.assert_allclose(d[k].grad.numpy(), np.asarray(g_d[k]), rtol=0, atol=ATOL,
                                   err_msg=k)


def test_general_scan_bf16_matches_jax():
    kwargs, nh, no, given = SCANS["cad120"]
    cfg, params, inputs, dists = _scan_inputs(kwargs, nh, no, ("ho", "oo"), seed=3)
    want = _jax_scan(cfg, params, inputs, dists, jnp.bfloat16)
    got, *_ = _port_scan(kwargs, params, inputs, dists, torch.bfloat16)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=0,
                                   atol=BF16_ATOL, err_msg=f"output {i}")
        differing = float(np.mean(g.float().numpy() != np.asarray(w, np.float32)))
        assert differing <= BF16_DIFFERING, (i, differing)


def test_general_scan_one_object_stays_finite():
    """A one-object clip: objects-to-object with exclude_self leaves its
    object no sender (the finite masked softmax of tggcn/nn/messages.py:30
    gives it zero weights); the outputs and gradients stay finite and
    match JAX's."""
    kwargs = dict(CAD120, message_humans_to_human=True)
    cfg, params, inputs, dists = _scan_inputs(kwargs, 1, 1, (), seed=5)
    want = _jax_scan(cfg, params, inputs, dists)
    got, p, tensors, _ = _port_scan(kwargs, params, inputs, dists, grad=True)
    sum(o.sum() for o in got).backward()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert all(bool(torch.isfinite(t.grad).all()) for t in tensors.values()
               if t.grad is not None)


# --- Messages ----------------------------------------------------------------------

def _message_params(kind, style, f, h, key=7):
    keys = jax.random.split(jax.random.PRNGKey(key), 3)
    if kind == "relational":
        return {"g": jax_init_mlp(keys[0], [2 * f, h]), "f": jax_init_mlp(keys[1], [h, h])}
    params = {"msg": jax_init_mlp(keys[0], [2 * f, h])}
    params["att"] = (jax_init_bilinear(keys[1], f, f, 1) if style == "v4"
                     else jax_init_mlp(keys[1], [2 * f, 1]))
    return params


@pytest.mark.parametrize("kind,aggregation,style,edge", [
    ("relational", "att", "v3", "masked_senders"),
    ("relational", "mp", "v1", "self_excluded"),
    ("relational", "att", "v3", "all_senders"),
    ("specific", "att", "v1", "masked_senders"),
    ("specific", "att", "v3", "self_excluded"),
    ("specific", "att", "v4", "all_senders"),
    ("specific", "mp", "v1", "masked_senders"),
    ("specific", "att", "v1", "distances"),
])
def test_messages_match_jax(kind, aggregation, style, edge):
    """Relational and 'specific' messages; a sender mask leaves the second
    batch row with no sender (a zero message, finite weights)."""
    rng = np.random.default_rng(11)
    b, t, r, f, h = 2, 3, 3, 6, 5
    params = _message_params(kind, style, f, h)
    recv = rng.normal(size=(b, t, r, f)).astype(np.float32)
    send, mask, exclude, dists = recv, None, edge == "self_excluded", None
    if edge != "self_excluded":
        send = rng.normal(size=(b, t, 4, f)).astype(np.float32)
    if edge == "masked_senders":
        mask = np.array([[1, 0, 1, 1], [0, 0, 0, 0]], np.float32)[:, None, None, :]
    if edge == "distances":
        dists = np.where(rng.uniform(size=(b, t, r, 4)) < 0.2, 0.0,
                         rng.uniform(0.1, 3.0, size=(b, t, r, 4))).astype(np.float32)
    kw = dict(message_type="v1" if kind == "relational" else "v2",
              message_granularity="v2", message_aggregation=aggregation,
              attention_style=style)
    want_msg, want_att = jax_messages.compute_message_features(
        params, recv, send, mask, exclude_self=exclude, distances=dists, **kw)
    as_t = lambda a: None if a is None else torch.tensor(a)
    got_msg, got_att = compute_message_features(
        params_from_numpy(_np(params)), as_t(recv), as_t(send), as_t(mask),
        exclude_self=exclude, distances=as_t(dists), **kw)
    np.testing.assert_allclose(got_msg.numpy(), np.asarray(want_msg), rtol=1e-5, atol=1e-6)
    assert (got_att is None) == (want_att is None)
    if got_att is not None:
        np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), rtol=1e-5, atol=1e-6)
        assert bool(torch.isfinite(got_att).all())
    if edge == "masked_senders" and kind != "relational":
        assert torch.equal(got_msg[1], torch.zeros_like(got_msg[1]))


# --- Init --------------------------------------------------------------------------

INITS = {
    "cad120_stage1": dict(cad120.MODEL_KWARGS, hidden_size=8),
    "relational_mp_sah": dict(CAD120, message_type="v1", message_granularity="v2",
                              message_aggregation="mp", object_segment_update_strategy="sah"),
    "specific_v1_features": dict(MPHOI, message_granularity="v2", attention_style="v1",
                                 add_time_position=True, add_segment_length=True,
                                 cat_level_states=True),
    "specific_v4_geometry_to_human": dict(CAD120, message_granularity="v2",
                                          attention_style="v4",
                                          message_geometry_to_human=True),
    "no_segment_messages": dict(MPHOI, message_segment=False),
    "relational_no_object_edges": dict(MPHOI, message_type="v1", message_human_to_objects=False,
                                       message_objects_to_object=False),
}


@pytest.mark.parametrize("name", list(INITS))
def test_init_matches_jax_tree(name):
    kwargs = INITS[name]
    want = jax_init(jax.random.PRNGKey(0), JaxConfig.from_kwargs(**kwargs))
    got = init_tggcn(torch.Generator().manual_seed(0), TGGCNConfig.from_kwargs(**kwargs))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes(got) == shapes(want)


# --- The CAD-120 stage-1 forward ---------------------------------------------------

def test_cad120_forward_matches_jax():
    kwargs = dict(cad120.MODEL_KWARGS, hidden_size=16)
    b, t, nh, no = 2, 6, 1, 5
    request = cad120.make_request(np.random.default_rng(4), b, t, nh, no)
    del request["human_segmentation"], request["objects_segmentation"]
    jparams = jax_init(jax.random.PRNGKey(1), JaxConfig.from_kwargs(**kwargs))
    key = jax.random.PRNGKey(2)
    want, _ = jax_apply(jparams, JaxConfig.from_kwargs(**kwargs), rng=key, **request)
    noise = _jax_noise(key, b, t, nh, no)
    with torch.no_grad():
        got, _ = apply_tggcn(params_from_numpy(_np(jparams)), TGGCNConfig.from_kwargs(**kwargs),
                             noise={k: torch.tensor(v) for k, v in noise.items()},
                             **{k: torch.tensor(v) for k, v in request.items()})
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"output {i}")
