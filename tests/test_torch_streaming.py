"""Sliding-window streaming in the port (``tggcn_torch.models.streaming``),
on the CPU and without JAX, at hidden 12 and T <= 24; after
``tests/test_streaming.py``.

* With a lookahead that reaches the stream's end, the streamed outputs
  equal the offline forward (rtol 2e-4, atol 2e-5, as the JAX package's
  test): with 'st' decisions in each segment route (K3's 'dot', K5's 'v1',
  the general scan without segment messages), and with 'gs' decisions
  drawing frame-indexed noise.
* ``process_window`` step by step equals ``run``, and the carry tracks the
  absolute frame by itself ('gs'); ``fuse_group`` 1 equals 16 bit for bit;
  bounded lookahead gives finite outputs of the stream's shape.
* Frame-indexed noise is window-invariant, depends on the key, the
  decision kind and the frame, and its Gumbel moments on 1e5 draws lie
  within 5 standard errors of Euler's gamma (mean) and pi^2/6 (variance);
  fused train steps draw what an eager step draws.
* The refusals: the 'reference' geometry flatten, 'gs' with batched noise.
* On the card (``cuda`` marker): the hash gives the same bits on CUDA as on
  the CPU, and the kernel route streams what the plain route streams.
"""

import math

import numpy as np
import pytest
import torch

from tggcn_torch.models.registry import select_model
from tggcn_torch.models.streaming import StreamingRunner
from tggcn_torch.nn.distributions import frame_indexed_gumbel, splitmix64

KW = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=12, gcn_node=26,
          message_humans_to_human=True, message_segment=True, message_type="v2",
          message_granularity="v1", message_aggregation="att", attention_style="v3",
          discrete_optimization_strategy="st", object_segment_update_strategy="ind",
          geometry_flatten="per_frame")
ROUTES = {"dot": {}, "v1": {"attention_style": "v1"}, "general": {"message_segment": False}}
GS = {"discrete_optimization_strategy": "gs", "gs_noise": "frame_indexed"}


def _model(device="cpu", **changes):
    model = select_model("2G-GCN", device=device, **{**KW, **changes})
    return model, model.init(torch.Generator().manual_seed(0))


def _inputs(t=12, b=1, num_humans=2, num_objects=2, seed=5):
    rng = np.random.default_rng(seed)
    x_human = rng.normal(size=(b, t, num_humans, 2152)).astype(np.float32)
    x_objects = rng.normal(size=(b, t, num_objects, 2048)).astype(np.float32)
    mask = np.ones((b, num_objects), dtype=np.float32)
    seg = (rng.uniform(size=(b, t, num_humans)) > 0.6).astype(np.float32)
    seg[:, -1] = 1.0
    return x_human, x_objects, mask, seg


def _offline(model, params, x_human, x_objects, mask, seg=None, seed=42):
    t = x_human.shape[1]
    outputs, _ = model.apply(params, x_human=x_human, x_objects=x_objects, objects_mask=mask,
                             human_segmentation=seg,
                             steps_per_example=np.full((1,), float(t), np.float32),
                             generator=torch.Generator().manual_seed(seed))
    return [o.numpy() for o in outputs]


def _assert_close(got, want, rtol=2e-4, atol=2e-5):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"output {i}")


@pytest.mark.parametrize("route", list(ROUTES))
def test_full_lookahead_matches_offline(route):
    model, params = _model(**ROUTES[route])
    t = 12
    x_human, x_objects, mask, seg = _inputs(t=t)
    runner = StreamingRunner(params, model.config, window=5, lookahead=t)
    _assert_close(runner.run(x_human, x_objects, mask, human_segmentation=seg),
                  _offline(model, params, x_human, x_objects, mask, seg))


def test_gs_frame_indexed_full_lookahead_matches_offline():
    model, params = _model(**GS)
    t = 12
    x_human, x_objects, mask, _ = _inputs(t=t)
    runner = StreamingRunner(params, model.config, window=5, lookahead=t, seed=42)
    _assert_close(runner.run(x_human, x_objects, mask),
                  _offline(model, params, x_human, x_objects, mask, seed=42))


def _stepwise(runner, x_human, x_objects, mask, seg, t, w, la):
    carry, got = None, None
    for start in range(0, t, w):
        end = min(start + w + la, t)
        outputs, carry = runner.process_window(
            x_human[:, start:end], x_objects[:, start:end], mask, carry=carry,
            human_segmentation=None if seg is None else seg[:, start:end], is_last=end == t)
        emit = min(w, t - start)
        keep = [o.numpy()[:, :, :emit] if o.ndim == 4 else o.numpy()[:, :emit]
                for o in outputs]
        got = keep if got is None else [np.concatenate([g, k], axis=2 if k.ndim == 4 else 1)
                                        for g, k in zip(got, keep)]
    return got, carry


@pytest.mark.parametrize("changes", [{}, GS], ids=["st", "gs"])
def test_process_window_stepwise_matches_run(changes):
    model, params = _model(**changes)
    t, w, la = 20, 6, 3
    x_human, x_objects, mask, seg = _inputs(t=t, seed=9)
    seg = None if changes else seg
    runner = StreamingRunner(params, model.config, window=w, lookahead=la, fuse_group=1)
    expected = runner.run(x_human, x_objects, mask, human_segmentation=seg)
    got, carry = _stepwise(runner, x_human, x_objects, mask, seg, t, w, la)
    assert carry["frame_offset"] == t
    assert carry["seg_human"].shape == (1, 2, 12) and carry["frame_geometry"].shape == (1, 1, 12)
    _assert_close(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("changes", [{}, GS], ids=["st", "gs"])
def test_fuse_group_does_not_change_the_outputs(changes):
    model, params = _model(**changes)
    t = 24                       # window 4, lookahead 2: 5 interior windows, then the tail
    x_human, x_objects, mask, seg = _inputs(t=t, seed=7)
    seg = None if changes else seg
    one, sixteen = (StreamingRunner(params, model.config, window=4, lookahead=2,
                                    fuse_group=g).run(x_human, x_objects, mask,
                                                      human_segmentation=seg)
                    for g in (1, 16))
    for a, b in zip(one, sixteen):
        np.testing.assert_array_equal(a, b)


def test_bounded_lookahead_runs_and_shapes():
    model, params = _model()
    t = 20
    x_human, x_objects, mask, seg = _inputs(t=t, seed=6)
    streamed = StreamingRunner(params, model.config, window=6, lookahead=3).run(
        x_human, x_objects, mask, human_segmentation=seg)
    assert streamed[0].shape == (1, t, 2) and streamed[-1].shape == (1, 13, t, 2)
    assert all(np.isfinite(s).all() for s in streamed)


def test_frame_indexed_noise_is_window_invariant():
    key = torch.tensor(7)
    full = frame_indexed_gumbel(key, 0, torch.arange(12), 2, 3)
    assert full.shape == (2, 12, 3, 2)
    for w0, w1 in [(0, 6), (6, 12), (3, 9)]:
        assert torch.equal(frame_indexed_gumbel(key, 0, torch.arange(w0, w1), 2, 3),
                           full[:, w0:w1])
    assert not torch.equal(frame_indexed_gumbel(key, 1, torch.arange(12), 2, 3), full)
    assert not torch.equal(frame_indexed_gumbel(torch.tensor(8), 0, torch.arange(12), 2, 3),
                           full)
    assert torch.unique(full).numel() == full.numel()
    # splitmix64 as a 64-bit unsigned reference computes it.
    x = torch.tensor([0, 1, 2 ** 62 + 12345, -5])
    mask = 2 ** 64 - 1

    def reference(v):
        z = (v + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return z ^ (z >> 31)

    assert [int(v) & mask for v in splitmix64(x)] == [reference(int(v) & mask) for v in x]


def test_frame_indexed_gumbel_moments():
    """1e5 draws: the mean within 5 standard errors (5 sqrt(pi^2/6 / n),
    0.020) of Euler's gamma, the variance within 5 of its standard errors
    (5 sqrt((mu4 - sigma^4) / n), with the Gumbel's excess kurtosis 12/5:
    0.055) of pi^2/6."""
    n = 100_000
    g = frame_indexed_gumbel(torch.tensor(1234), 0, torch.arange(n // 2), 1, 1).double()
    var = math.pi ** 2 / 6
    assert abs(float(g.mean()) - 0.5772156649) < 5 * math.sqrt(var / n)
    assert abs(float(g.var()) - var) < 5 * math.sqrt((2.4 + 2) * var ** 2 / n)


def test_fused_noise_stack_is_what_a_step_draws():
    """The noise stack of fused train steps for a frame-indexed model
    (``train.loop.frame_indexed_noise_stack``) is the noise an eager step
    draws from a generator of the same seed: the same outputs, bit for bit."""
    from tggcn_torch.train.loop import frame_indexed_noise_stack

    model, params = _model(**GS)
    t = 8
    x_human, x_objects, mask, _ = _inputs(t=t)
    batch = dict(x_human=x_human, x_objects=x_objects, objects_mask=mask)
    drawn, _ = model.apply(params, generator=torch.Generator().manual_seed(5), **batch)
    stack = frame_indexed_noise_stack(torch.Generator().manual_seed(5), 1, 1, t, 2, 2)
    given, _ = model.apply(params, noise={k: v[0] for k, v in stack.items()}, **batch)
    for a, b in zip(drawn, given):
        assert torch.equal(a, b)


def test_streaming_refusals():
    model, params = _model(geometry_flatten="reference")
    with pytest.raises(ValueError, match="per_frame"):
        StreamingRunner(params, model.config, window=6, lookahead=6)
    StreamingRunner(params, model.config, window=6, lookahead=6, allow_reference_geometry=True)
    model, params = _model(discrete_optimization_strategy="gs")
    with pytest.raises(ValueError, match="frame_indexed"):
        StreamingRunner(params, model.config, window=6, lookahead=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_indexed_noise_is_the_same_on_cuda(cuda):
    frames = torch.arange(1000, 1167)
    key = torch.tensor(2 ** 61 + 99)
    for stream in (0, 1):
        cpu = frame_indexed_gumbel(key, stream, frames, 8, 4)
        card = frame_indexed_gumbel(key.to(cuda), stream, frames.to(cuda), 8, 4)
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_route_streams_what_the_plain_route_streams(cuda, route):
    model, params = _model(device=cuda, **ROUTES[route])
    t = 24
    x_human, x_objects, mask, seg = _inputs(t=t)
    got, want = (StreamingRunner(params, model.config, window=8, lookahead=4,
                                 use_kernels=k).run(x_human, x_objects, mask,
                                                    human_segmentation=seg)
                 for k in (True, False))
    _assert_close(got, want, rtol=1e-4, atol=1e-4)
