"""The port's data-parallel train step against JAX's on the CPU.

One train step of ``tests/distributed_worker.py::build_workload``'s model
(hidden 8, 'st' decisions, the human segmentation imposed, Adam at 1e-3,
clipping at 5) from JAX's initial weights (carried across by
``tggcn_torch/compat/weights.py``): JAX's ``make_train_step`` with the
batch sharded over ``make_mesh(8)`` (one row a device) against the port's
``make_train_step`` with a mesh in two gloo processes (four rows each,
``tests/test_torch_parallel.py`` run as a script). The batch is 7 of the
workload's examples padded to 8, with -1 in some label targets, so that
the processes' counts of unmasked targets differ (the segmentation
targets keep no -1: JAX's BCE gradient is NaN at a masked 0 or 1).
Tolerances of ``tests/test_torch_train.py``'s one-step comparison: losses
rtol 1e-5, atol 1e-6; weights and BatchNorm state atol 1e-5.
"""

import os
import pickle
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import distributed_worker  # noqa: E402
import test_torch_parallel  # noqa: E402

LR, CLIP = 1e-3, 5.0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def test_two_process_step_matches_jax_mesh_step(tmp_path):
    from tggcn.parallel.mesh import make_mesh, replicate, shard_batch
    from tggcn.train.loop import make_train_step, pad_batch

    w = distributed_worker.build_workload()
    batch = [np.array(a[:7]) for a in w["train_loader"].tensors]
    for labels in batch[10:]:
        labels[0, -1] = labels[5, 1:] = -1
    batch = pad_batch(batch, 8, num_inputs=8)
    counts = [int((half != -1).sum()) for half in np.split(batch[10], 2)]
    assert counts[0] != counts[1], counts

    mesh = make_mesh(8)
    step = make_train_step(w["model"], w["feeder"], w["criterion"], w["optimizer"],
                           clip_gradient_at=CLIP, mesh=mesh)
    trainable = replicate({"model": w["params"]}, mesh)
    data, targets = w["fetcher"](shard_batch(batch, mesh))
    params = jax.tree_util.tree_map(np.asarray, w["params"])
    trainable, _, want_losses, want_raw = step(trainable, replicate(
        w["optimizer"].init(trainable), mesh), jax.random.PRNGKey(0), data, targets)

    inputs = tmp_path / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(dict(model=test_torch_parallel.MODEL, params=params, batch=batch, misc={},
                         feeder=dict(dataset_name="mphoi", impose_segmentation_pattern=1),
                         lr=LR, clip=CLIP), f)
    results = test_torch_parallel.launch({"out": str(tmp_path / "out"),
                                          "step": {"inputs": str(inputs)}})
    got = results[0]["step"]
    np.testing.assert_allclose(got["losses"], np.asarray(want_losses), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["raw"], np.asarray(want_raw), rtol=1e-5, atol=1e-6)
    got_params, want_params = _flat(got["params"]), _flat(trainable["model"])
    assert sorted(got_params) == sorted(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(got_params[k], want, rtol=0, atol=1e-5, err_msg=k)
    assert not np.allclose(got_params["/geometry_embedding_gcn/bn/state/var"], 1.0)
    other = _flat(results[1]["step"]["params"])
    assert all(np.array_equal(other[k], v) for k, v in got_params.items())
