"""Where the time of one frame-BiGRU call (K1) and one backward sweep (K2)
goes on the card, by kernel name; the seeded inputs that chip_smoke.py's
k1 and k2 phases also use; and cuDNN's GRU set up to compute the same
recurrence, the library yardstick of those phases.

    python -m tggcn_torch.profile_gru [--reps N] [--dtype D] [--batch B]

Builds the kernels, then runs K1 (``gru_sequence``, keeping the gates as a
train step does) and K2 (``gru_sequence_bwd``) at the MPHOI shape (T=167,
S=6 streams, the last 3 reversed, R = B x 4 rows, B=8 unless --batch,
h=512) in the IO dtype D (float32 unless --dtype), one warm-up call each,
then ``--reps`` calls of each under ``torch.profiler``. Prints one JSON
object: the card (name and power limit from nvidia-smi) and, per kernel,
the device milliseconds per call by kernel name and the launches per
call, and each kernel's card ms by CUDA events (the median of --reps calls
after a warm-up, the host's queueing hidden behind a wait on the card; K1
also keeping no gates, as a request's call).
Run as a file from another checkout's root (``PYTHONPATH=. python <this
tree>/tggcn_torch/profile_gru.py``) it times that checkout's kernels, for
turns with a parent. Needs a CUDA device.
"""

import argparse
import json
import subprocess

import torch

from tggcn_torch.models import stage1
from tggcn_torch.ops import _build
from tggcn_torch.ops import gru_sequence as ops
from tggcn_torch.profile_scan import device_ms_by_kernel
from tggcn_torch.runtime import pin_float32_numerics

STREAMS = 6          # the stage-1 BiGRU: 3 streams, two directions each


def gru_inputs(dev, gen, t, s, r, h):
    """K1's inputs (gi, w_hh, b_hh, h0), uniform from gen: gate inputs and
    initial states in (-1, 1), weights and biases within h^-1/2."""
    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).contiguous()
    return (u(t, s, r, 3 * h, bound=1.0), u(s, h, 3 * h, bound=h ** -0.5),
            u(s, 3 * h, bound=h ** -0.5), u(s, r, h, bound=1.0))


def gru_bwd_inputs(gi, w_hh, b_hh, h0, num_reverse, gen):
    """K2's inputs (gi, hprev, g, gates, w_hh): the states each step read and
    the gates of the plain forward, and a standard-normal upstream gradient
    from gen, in the IO dtype of gi."""
    out, gates = ops.gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=True)
    g = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    return gi, ops.previous_states(out, h0, num_reverse), g, gates, w_hh


def cudnn_grus(w_hh, b_hh):
    """One unidirectional torch.nn.GRU (cuDNN on the card) per stream that
    computes the recurrence of K1 for an input of gi: its input weights are
    the identity and its input bias zero, so W_ih x + b_ih = gi; W_hh and
    b_hh are the stream's (PyTorch's GRU also puts b_hn inside r * (...)).
    A yardstick only: each call also multiplies its input by the identity,
    and it needs one call per stream (several weight sets). TF32 is off.
    The GRUs take w_hh's dtype (bfloat16 for K1's and K2's bfloat16
    variants; the library then carries its state in bfloat16)."""
    pin_float32_numerics()
    s, h = w_hh.shape[0], w_hh.shape[1]
    grus = []
    for i in range(s):
        gru = torch.nn.GRU(3 * h, h).to(w_hh.device, w_hh.dtype)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(torch.eye(3 * h, device=w_hh.device))
            gru.bias_ih_l0.zero_()
            gru.weight_hh_l0.copy_(w_hh[i].T)
            gru.bias_hh_l0.copy_(b_hh[i])
        gru.requires_grad_(False)
        grus.append(gru)
    return grus


def cudnn_inputs(gi, h0, num_reverse):
    """Per stream, the time-major input of its GRU (reversed in time for the
    trailing num_reverse streams) and its initial state (1, R, h)."""
    nf = gi.shape[1] - num_reverse
    return ([(gi[:, i] if i < nf else gi[:, i].flip(0)).contiguous() for i in range(gi.shape[1])],
            [h0[i][None].contiguous() for i in range(gi.shape[1])])


def cudnn_sequence(grus, xs, h0s):
    """Each stream's GRU output (T, R, h), in its own time order."""
    return [gru(x, h)[0] for gru, x, h in zip(grus, xs, h0s)]


def cudnn_states(ys, num_reverse):
    """The states (T, S, R, h) in natural time order, as K1 returns them."""
    nf = len(ys) - num_reverse
    return torch.stack([y if i < nf else y.flip(0) for i, y in enumerate(ys)], dim=1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--batch", type=int, default=stage1.SHAPE["b"],
                        help="clips; the rows are the clips' objects")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gru: no CUDA device")
    _build.build(("gru_sequence", "gru_sequence_bwd"))
    dev = torch.device("cuda", 0)
    t, h = stage1.SHAPE["t"], stage1.MODEL_KWARGS["hidden_size"]
    r = args.batch * max(stage1.SHAPE["humans"], stage1.SHAPE["objects"])
    nr = STREAMS // 2
    gen = torch.Generator(device=dev).manual_seed(1)
    fwd = tuple(x.to(getattr(torch, args.dtype)) for x in gru_inputs(dev, gen, t, STREAMS, r, h))
    bwd = gru_bwd_inputs(*fwd, nr, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    k1 = lambda: ops.gru_sequence(*fwd, nr, keep=True)  # noqa: E731
    k1_serve = lambda: ops.gru_sequence(*fwd, nr)  # noqa: E731
    k2 = lambda: ops.gru_sequence_bwd(*bwd, nr)  # noqa: E731
    print(json.dumps({
        "card": smi, "reps": args.reps, "dtype": args.dtype,
        "shape": dict(t=t, s=STREAMS, r=r, h=h),
        "k1": device_ms_by_kernel(k1, args.reps), "k2": device_ms_by_kernel(k2, args.reps),
        "k1_ms": event_ms(k1, args.reps), "k1_serve_ms": event_ms(k1_serve, args.reps),
        "k2_ms": event_ms(k2, args.reps)}))


def event_ms(fn, reps, spin_cycles=20_000_000):
    """The median card ms of fn() by CUDA events over reps calls after a
    warm-up, each queued while the card waits spin_cycles clock cycles (so
    that the events time the card's work, not the host's queueing)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


if __name__ == "__main__":
    main()
