"""K6: the fused GeoGCN block after its BatchNorm.

Replaces the TPU kernel ``tggcn/ops/geo_gcn_pallas.py::_kernel`` (launched
by ``_geo_gcn_fused_impl`` at ``geo_gcn_pallas.py:100``). The CUDA kernel is
``csrc/geo_gcn.cu``: one launch over the N = batch * time frames, one warp
a frame and FRAMES_PER_BLOCK warps a block, V padded to 32 rows, every
product of the chain (embed 4 -> 64 -> 64 with ReLU, the similarity
projections 64 -> 128, the V x V softmax adjacency, (S h) W_out) on the
tensor cores in the 3xTF32 split (float32 accuracy); ``geo_gcn_config``
gives the launch's shape and occupancy.

``geo_gcn_plain`` is its plain version (``geo_gcn_pallas.py:24``
``geo_gcn_reference``), and the GeoGCN module's own computation after the
BatchNorm. ``geo_gcn_fused_autograd`` is the differentiable entry point: a
``torch.autograd.Function`` that runs K6 forward and, as JAX's custom VJP
does (``geo_gcn_pallas.py:61-87``), takes its backward from autograd of the
plain version, recomputed.

Shapes: x (N, V, 4), w1 (4, 64), b1 (64), w2 (64, 64), b2 (64), ws1, ws2
(64, 128), bs1, bs2 (128), w_out (64, 128) -> (N, V, 128); V <= 32.
"""

import ctypes

import torch

from tggcn_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_NODES = 32
FRAMES_PER_BLOCK = 12          # the kernel's warps, one frame each at a time
WEIGHTS = ("w1", "b1", "w2", "b2", "ws1", "bs1", "ws2", "bs2", "w_out")


def geo_gcn_plain(x, w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out):
    """Plain PyTorch version of K6: x (..., V, 4) -> (..., V, 128)."""
    h = torch.relu(torch.matmul(x, w1) + b1)
    h = torch.relu(torch.matmul(h, w2) + b2)                      # (..., V, 64)
    s1 = torch.matmul(h, ws1) + bs1                               # (..., V, 128)
    s2 = torch.matmul(h, ws2) + bs2
    adjacency = torch.softmax(torch.matmul(s1, s2.transpose(-1, -2)), dim=-1)
    return torch.matmul(torch.matmul(adjacency, h), w_out)


def _check(x, weights):
    n, v, c_in = x.shape
    shapes = dict(w1=(4, 64), b1=(64,), w2=(64, 64), b2=(64,), ws1=(64, 128), bs1=(128,),
                  ws2=(64, 128), bs2=(128,), w_out=(64, 128))
    for name, t in (("x", x), *zip(WEIGHTS, weights)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"geo_gcn_fused: {name} must be float32 on {x.device}")
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"geo_gcn_fused: {name} has shape {tuple(t.shape)}, "
                             f"want {shapes[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geo_gcn_fused: {name} must be contiguous and 16-byte aligned")
    if c_in != 4 or not 1 <= v <= MAX_NODES:
        raise ValueError(f"geo_gcn_fused: x must be (N, V, 4) with 1 <= V <= {MAX_NODES}")


def geo_gcn_fused(x, w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out):
    """(N, V, 128) GeoGCN outputs of the normalised frames x (N, V, 4); CPU
    tensors take the plain version, CUDA tensors the kernel."""
    weights = (w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out)
    _build.refuse_autograd("geo_gcn_fused", x, *weights)
    if x.device.type == "cpu":
        return geo_gcn_plain(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"geo_gcn_fused runs on CUDA or the CPU, not {x.device}")
    _check(x, weights)
    n, v, _ = x.shape
    out = torch.empty((n, v, w_out.shape[1]), device=x.device)
    if n > 0:
        fn = _build.load_library("geo_gcn").tggcn_geo_gcn_f32
        fn.argtypes = [_P] * 11 + [_I] * 2 + [_P]
        fn.restype = _I
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*[t.data_ptr() for t in (x, *weights, out)], n, v, stream)
        _build.check_launch(err, "geo_gcn_fused")
        geo_gcn_fused.launches += 1
    return out


geo_gcn_fused.launches = 0


def geo_gcn_config(n):
    """The kernel's launch over n frames on the current CUDA device: frames
    a block runs at a time, blocks, blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads a block and
    dynamic shared memory bytes, as a dict."""
    fn = _build.load_library("geo_gcn").tggcn_geo_gcn_config
    fn.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = (ctypes.c_int * 5)()
    _build.check_launch(fn(n, out), "geo_gcn config")
    return dict(zip(("frames_per_block", "blocks", "blocks_per_sm", "threads", "smem_bytes"),
                    out))


class GeoGCNFused(torch.autograd.Function):
    """K6 forward; the backward is autograd of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, use_kernels, x, *weights):
        ctx.save_for_backward(x, *weights)
        run = geo_gcn_fused if use_kernels else geo_gcn_plain
        return run(x, *weights)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = geo_gcn_plain(*inputs)
        return (None, *torch.autograd.grad(out, inputs, grad))


def geo_gcn_fused_autograd(x, w1, b1, w2, b2, ws1, bs1, ws2, bs2, w_out,
                           use_kernels: bool = True):
    """The differentiable fused GeoGCN, x (N, V, 4) -> (N, V, 128).
    use_kernels=False runs the plain version on any device (the reference)."""
    return GeoGCNFused.apply(use_kernels, x.contiguous(), w1, b1, w2, b2, ws1, bs1, ws2, bs2,
                             w_out)
