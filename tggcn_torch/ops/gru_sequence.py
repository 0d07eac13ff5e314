"""K1 and K2: the frame-level GRU over a whole sequence, S streams at once,
and its backward sweep.

Replaces the TPU kernel ``tggcn/ops/gru_pallas.py::_fwd_kernel`` (launched
at ``gru_pallas.py:147``). The CUDA kernel is ``csrc/gru_sequence.cu``, with
two routes chosen from the dtype and h before any launch (``gru_plan`` gives
the plan the source makes):

* bfloat16 at h <= 512: one launch a call. The blocks of one (stream, row
  tile) form a thread-block cluster (``csrc/gru_cluster.cuh``) that holds
  the stream's W_hh in registers for the whole sequence, exchanges the
  state through distributed shared memory and waits at one cluster barrier
  a step; its product runs on wgmma, three bfloat16 parts of the float32
  state against the bfloat16 weights, at float32 accuracy.
* float32, and bfloat16 at h > 512: one launch per time step whose blocks
  each own a tile of rows and hidden units of one stream (their r, z and n
  gate columns), so no block waits for another; the launches' order on the
  stream carries the state. Its product runs on the tensor cores in the
  3xTF32 split (``csrc/tc_gemm.cuh``), at float32 accuracy.

With ``keep`` (a gradient will be taken) K1 also writes every step's gates
(``KEPT``) for the backward; see the sources for the bounds and the designs.
The kernels take h % 4 == 0 in float32 and h % 8 == 0 in bfloat16; at any
other h >= 1 the wrappers run them at the next such width, the padded units
zero in every operand, and slice the outputs back (``gru_sequence_padded``,
``gru_sequence_bwd_padded``; ``ops/widths.py`` shows why the padded units
stay zero). At an aligned width nothing is copied.

Layout (as the JAX kernel's):
  gi    (T, S, R, 3h)  input-side gate pre-activations, x @ w_ih + b_ih
  w_hh  (S, h, 3h)     recurrent weights per stream
  b_hh  (S, 3h)        recurrent bias per stream
  h0    (S, R, h)      initial states
  ->    (T, S, R, h)   the state sequence in natural time order, and with
                       keep the gates (T, S, R, 3h)
The last ``num_reverse`` streams run backward in time (t = T-1 .. 0), so a
BiGRU's two directions run in one call without flipping any tensor.

K2 replaces ``gru_pallas.py::_bwd_kernel`` (launched at ``gru_pallas.py:167``):
``csrc/gru_sequence_bwd.cu``. Where the TPU kernel recomputes the gates
from h_prev, K2 reads the ones K1 kept. Its routes are K1's: in bfloat16 at
h <= 512 one cluster launch a call, whose blocks each take the carry
product dgh @ W_hh^T over their own gate columns and add the cluster's
partials for their units in a fixed order; otherwise one launch per step
takes the carry product (W_hh read as stored) and, in its epilogue, the
next step's gate backward, after one elementwise launch that starts the
sweep (T + 1 launches). It emits dgi, dgh and dh0; dW_hh and db_hh are
reduced outside as one product over h_prev x dgh, as the JAX custom VJP
does (``gru_pallas.py:214-217``).

``gru_sequence_autograd`` is the differentiable entry point: a
``torch.autograd.Function`` that runs K1 forward, keeping the gates, and
K2 backward (or, with ``use_kernels=False`` or on the CPU, their plain
versions); when no gradient will be taken it runs the forward alone,
keeping nothing. The wrappers ``gru_sequence`` and ``gru_sequence_bwd``
refuse to run on tensors that require grad outside it.

Both kernels take float32 or bfloat16 IO (gi, w_hh, b_hh, h0, the states;
hprev, g, dgi, dgh, dh0), all of one dtype, and pick their variant by it;
each wrapper counts the launches of its float32 kernel in ``launches`` and
of its bfloat16 kernel in ``launches_bf16``. In bfloat16, as the TPU
kernels run it (``gru_pallas.py:61-77``, ``:97-126``), the state and the
carried dL/dh stay float32: K1 carries its state in float32 (a buffer of
its own, whose slot 1 brings h0 in), not through its bfloat16 output, and
its product h @ W_hh takes the float32 state against W_hh's bfloat16
values at float32 accuracy; K2's carry product takes the float32 dgh. The
kept gates are float32 in both. Only the tensors the JAX kernels write in
their IO dtype are rounded to it.
"""

import ctypes

import torch

from tggcn_torch.ops import _build
from tggcn_torch.ops.widths import aligned, narrow, widen

_P = ctypes.c_void_p
_I = ctypes.c_int

# What K1 keeps for its backward (K2) when asked to (keep=True): one
# (T, S, R, 3h) tensor, each step's gates in this order, h wide each; hn is
# the recurrent n pre-activation h_prev @ w_hh_n + b_hh_n. n itself is not
# kept: K2 recomputes tanh(gi_n + r * hn) elementwise.
KEPT = ("r", "z", "hn")
# The gate axis of gi, w_hh, b_hh, the kept gates, dgi and dgh: three
# h-wide blocks (ops/widths.py).
GATES = ((-1, 3),)


def _step(gi, h, w_hh, b_hh):
    """One GRU step for stacked streams, gi (S, R, 3h), h (S, R, h): the new
    state and the gates (r, z, hn)."""
    gh = torch.matmul(h, w_hh) + b_hh[:, None]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h, (r, z, h_n)


def gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse: int = 0, keep: bool = False,
                       round_carry: bool = False):
    """Plain PyTorch version of K1: a Python loop over time. Returns the
    states, and with keep also the gates (KEPT). It computes in float32
    with a float32 state whatever the IO dtype and rounds only the states
    it returns to it; the gates stay float32. round_carry rounds the state
    to the IO dtype after every step, as JAX's XLA route does and the
    kernels do not: a control for the checks that hold K1 to this version."""
    io = gi.dtype
    q = _build.rounding(io) if round_carry else (lambda x: x)
    gi, w_hh, b_hh, h0 = (_build.upcast(x) for x in (gi, w_hh, b_hh, h0))
    t, s = gi.shape[0], gi.shape[1]
    nf = s - num_reverse
    out = gi.new_empty(gi.shape[:-1] + (gi.shape[-1] // 3,))
    gates = torch.empty_like(gi) if keep else None
    h = h0
    for i in range(t):
        gi_i = torch.cat([gi[i, :nf], gi[t - 1 - i, nf:]])
        h, kept = _step(gi_i, h, w_hh, b_hh)
        h = q(h)
        out[i, :nf] = h[:nf]
        out[t - 1 - i, nf:] = h[nf:]
        if keep:
            kept = torch.cat(kept, dim=-1)
            gates[i, :nf], gates[t - 1 - i, nf:] = kept[:nf], kept[nf:]
    out = out.to(io)
    return (out, gates) if keep else out


IO_DTYPES = (torch.float32, torch.bfloat16)


def _check(what, device, tensors, h, num_reverse, float32=()):
    """tensors: {name: (tensor, shape)}, contiguous, on device; the names in
    float32 are float32, the others all of one IO dtype (IO_DTYPES), which
    is returned. Any width h >= 1: the launch runs at aligned(h) (see
    gru_sequence_padded)."""
    io = tensors["gi"][0].dtype
    if io not in IO_DTYPES:
        raise ValueError(f"{what}: gi must be float32 or bfloat16, not {io}")
    for name, (x, shape) in tensors.items():
        want = torch.float32 if name in float32 else io
        if x.device != device or x.dtype != want:
            raise ValueError(f"{what}: {name} must be {want} on {device} (the IO dtype is gi's)")
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    s = tensors["gi"][0].shape[1]
    if h < 1 or not 0 <= num_reverse <= s:
        raise ValueError(f"{what}: needs a gate width 3h with h >= 1 and 0 <= num_reverse <= S")
    return io


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


PLAN_KEYS = ("cluster", "units", "rows", "smem", "clusters", "co_resident")


def gru_plan(kind, s, r, h):
    """The launch plan of K1's (kind 'fwd') or K2's ('bwd') bfloat16 kernel
    at S streams, R rows and h units, as its .cu source makes it: {cluster:
    blocks a cluster (0: the per-step route, h > 512), units: hidden units a
    block, rows: rows a cluster, smem: dynamic shared memory bytes a block,
    clusters: clusters a call, co_resident: on the cluster route the most
    clusters the current CUDA device holds at once
    (cudaOccupancyMaxActiveClusters), else -1}. Builds the library if
    needed."""
    lib = _build.load_library("gru_sequence" if kind == "fwd" else "gru_sequence_bwd")
    fn = lib.tggcn_gru_sequence_plan if kind == "fwd" else lib.tggcn_gru_sequence_bwd_plan
    fn.argtypes = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _build.check_launch(fn(s, r, h, out), f"gru_sequence {kind} plan")
    return dict(zip(PLAN_KEYS, out))


def gru_clusters(blocks, smem):
    """The most clusters of `blocks` blocks of K1's cluster kernel, each with
    smem bytes of dynamic shared memory, that the current CUDA device holds
    at once: the occupancy of plans the source does not take."""
    fn = _build.load_library("gru_sequence").tggcn_gru_sequence_clusters
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = ctypes.c_int()
    _build.check_launch(fn(blocks, smem, ctypes.byref(out)), "gru_sequence clusters")
    return out.value


def gru_sequence_padded(run, gi, w_hh, b_hh, h0, num_reverse: int = 0, keep: bool = False,
                        width=None):
    """run (K1's launch or its plain version) at the width h' (default
    aligned(h) in gi's dtype), its outputs narrowed back to h: every operand
    widened with zero units, which stay zero (``ops/widths.py``). At h' == h
    it is run itself, on the caller's tensors."""
    h = h0.shape[-1]
    hp = width or aligned(h, gi.dtype)
    if hp == h:
        return run(gi, w_hh, b_hh, h0, num_reverse, keep=keep)
    out = run(widen(gi, h, hp, GATES), widen(w_hh, h, hp, ((-2, 1),) + GATES),
              widen(b_hh, h, hp, GATES), widen(h0, h, hp), num_reverse, keep=keep)
    if keep:
        return narrow(out[0], h, hp), narrow(out[1], h, hp, GATES)
    return narrow(out, h, hp)


def gru_sequence(gi, w_hh, b_hh, h0, num_reverse: int = 0, keep: bool = False):
    """The state sequence (T, S, R, h), and with keep the gates (T, S, R,
    3h) of KEPT; CPU tensors take the plain version, CUDA tensors the
    kernel, at any h (gru_sequence_padded)."""
    _build.refuse_autograd("gru_sequence", gi, w_hh, b_hh, h0)
    if gi.device.type == "cpu":
        return gru_sequence_plain(gi, w_hh, b_hh, h0, num_reverse, keep=keep)
    if gi.device.type != "cuda":
        raise ValueError(f"gru_sequence runs on CUDA or the CPU, not {gi.device}")
    t, s, r, g3 = gi.shape
    h = g3 // 3
    _check("gru_sequence", gi.device,
           {"gi": (gi, (t, s, r, 3 * h)), "w_hh": (w_hh, (s, h, 3 * h)),
            "b_hh": (b_hh, (s, 3 * h)), "h0": (h0, (s, r, h))}, h, num_reverse)
    return gru_sequence_padded(_launch_gru_sequence, gi, w_hh, b_hh, h0, num_reverse, keep)


def _launch_gru_sequence(gi, w_hh, b_hh, h0, num_reverse, keep):
    """K1 on checked tensors at an aligned width."""
    t, s, r, g3 = gi.shape
    h = g3 // 3
    io = gi.dtype
    out = torch.empty((t, s, r, h), device=gi.device, dtype=io)
    gates = torch.empty(gi.shape, device=gi.device) if keep else None
    if t == 0:
        return (out, gates) if keep else out
    lib = _build.load_library("gru_sequence")
    ptrs = [gi.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), out.data_ptr()]
    if io == torch.float32:
        fn = lib.tggcn_gru_sequence_f32
    else:
        # The float32 state, two slots by step parity: step i reads slot
        # (i + 1) % 2 (slot 1 holds h0 for step 0) and writes slot i % 2.
        state = torch.empty((2, s, r, h), device=gi.device)
        state[1] = h0
        fn = lib.tggcn_gru_sequence_bf16
        ptrs.append(state.data_ptr())
    fn.argtypes = [_P] * (len(ptrs) + 1) + [_I] * 6 + [_P]
    fn.restype = _I
    with torch.cuda.device(gi.device):
        err = fn(*ptrs, gates.data_ptr() if keep else None, int(keep), t, s, r, h,
                 num_reverse, _stream(gi.device))
    _build.check_launch(err, "gru_sequence")
    _build.count_launch(gru_sequence, io)
    return (out, gates) if keep else out


gru_sequence.launches = gru_sequence.launches_bf16 = 0


def previous_states(out, h0, num_reverse: int = 0):
    """The state each step read, in natural time order (T, S, R, h): the
    forward streams read the step before, the reverse streams the step after."""
    nf = out.shape[1] - num_reverse
    fwd = torch.cat([h0[None, :nf], out[:-1, :nf]])
    rev = torch.cat([out[1:, nf:], h0[None, nf:]])
    return torch.cat([fwd, rev], dim=1).contiguous()


def gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse: int = 0,
                           round_carry: bool = False):
    """Plain PyTorch version of K2: (dgi, dgh, dh0) from the kept gates, by a
    Python loop that visits time opposite to the forward. It computes in
    float32 whatever the IO dtype (the carry product takes the float32
    dgh) and rounds only the outputs to it. round_carry rounds the carried
    dL/dh to the IO dtype after every step: a control, as K1's."""
    io = gi.dtype
    q = _build.rounding(io) if round_carry else (lambda x: x)
    gi, hprev, g, w_hh = (_build.upcast(x) for x in (gi, hprev, g, w_hh))
    t, s = gi.shape[0], gi.shape[1]
    nf = s - num_reverse
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    w_t = w_hh.transpose(1, 2)
    dh = hprev.new_zeros(hprev.shape[1:])
    for i in range(t):
        tf, tr = t - 1 - i, i

        def at(x):
            return torch.cat([x[tf, :nf], x[tr, nf:]])

        hp = at(hprev)
        r, z, hn = at(gates).chunk(3, dim=-1)
        n = torch.tanh(at(gi).chunk(3, dim=-1)[2] + r * hn)
        dh = dh + at(g)
        dtanh = dh * (1.0 - z) * (1.0 - n * n)
        d_ir = dtanh * hn * r * (1.0 - r)
        d_iz = dh * (hp - n) * z * (1.0 - z)
        dgi_i = torch.cat([d_ir, d_iz, dtanh], dim=-1)
        dgh_i = torch.cat([d_ir, d_iz, dtanh * r], dim=-1)
        dh = q(dh * z + torch.matmul(dgh_i, w_t))
        dgi[tf, :nf], dgi[tr, nf:] = dgi_i[:nf], dgi_i[nf:]
        dgh[tf, :nf], dgh[tr, nf:] = dgh_i[:nf], dgh_i[nf:]
    return dgi.to(io), dgh.to(io), dh.to(io)


def gru_sequence_bwd_padded(run, gi, hprev, g, gates, w_hh, num_reverse: int = 0, width=None):
    """run (K2's launch or its plain version) at the width h' (default
    aligned(h) in gi's dtype), as gru_sequence_padded: the cotangent's
    padded units are zero, so is their carry, and their dgi, dgh and dh0
    are sliced away."""
    h = hprev.shape[-1]
    hp = width or aligned(h, gi.dtype)
    if hp == h:
        return run(gi, hprev, g, gates, w_hh, num_reverse)
    dgi, dgh, dh0 = run(widen(gi, h, hp, GATES), widen(hprev, h, hp), widen(g, h, hp),
                        widen(gates, h, hp, GATES), widen(w_hh, h, hp, ((-2, 1),) + GATES),
                        num_reverse)
    return narrow(dgi, h, hp, GATES), narrow(dgh, h, hp, GATES), narrow(dh0, h, hp)


def gru_sequence_bwd(gi, hprev, g, gates, w_hh, num_reverse: int = 0):
    """(dgi (T, S, R, 3h), dgh (T, S, R, 3h), dh0 (S, R, h)) for the upstream
    gradient g (T, S, R, h), from the states each step read (hprev) and the
    gates K1 kept; CPU tensors take the plain version, CUDA tensors the
    kernel, at any h (gru_sequence_bwd_padded)."""
    _build.refuse_autograd("gru_sequence_bwd", gi, hprev, g, gates, w_hh)
    if gi.device.type == "cpu":
        return gru_sequence_bwd_plain(gi, hprev, g, gates, w_hh, num_reverse)
    if gi.device.type != "cuda":
        raise ValueError(f"gru_sequence_bwd runs on CUDA or the CPU, not {gi.device}")
    t, s, r, g3 = gi.shape
    h = g3 // 3
    _check("gru_sequence_bwd", gi.device,
           {"gi": (gi, (t, s, r, 3 * h)), "hprev": (hprev, (t, s, r, h)),
            "g": (g, (t, s, r, h)), "gates": (gates, (t, s, r, 3 * h)),
            "w_hh": (w_hh, (s, h, 3 * h))}, h, num_reverse, float32=("gates",))
    return gru_sequence_bwd_padded(_launch_gru_sequence_bwd, gi, hprev, g, gates, w_hh,
                                   num_reverse)


def _launch_gru_sequence_bwd(gi, hprev, g, gates, w_hh, num_reverse):
    """K2 on checked tensors at an aligned width."""
    t, s, r, g3 = gi.shape
    h = g3 // 3
    io = gi.dtype
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    dh0 = torch.zeros((s, r, h), device=gi.device, dtype=io)
    if t == 0:
        return dgi, dgh, dh0
    dhz = torch.empty((s, r, h), device=gi.device)
    lib = _build.load_library("gru_sequence_bwd")
    ptrs = [gi.data_ptr(), hprev.data_ptr(), g.data_ptr(), gates.data_ptr(), w_hh.data_ptr(),
            dgi.data_ptr(), dgh.data_ptr(), dhz.data_ptr(), dh0.data_ptr()]
    if io == torch.float32:
        fn = lib.tggcn_gru_sequence_bwd_f32
    else:
        # The per-step route's float32 dgh of the carry product, two slots
        # by step parity (a launch reads its step's and writes the next
        # step's); the cluster route keeps dgh and dhz on chip.
        fn = lib.tggcn_gru_sequence_bwd_bf16
        dgh32 = torch.empty((2, s, r, 3 * h), device=gi.device)
        ptrs.append(dgh32.data_ptr())
    fn.argtypes = [_P] * len(ptrs) + [_I] * 5 + [_P]
    fn.restype = _I
    with torch.cuda.device(gi.device):
        err = fn(*ptrs, t, s, r, h, num_reverse, _stream(gi.device))
    _build.check_launch(err, "gru_sequence_bwd")
    _build.count_launch(gru_sequence_bwd, io)
    return dgi, dgh, dh0


gru_sequence_bwd.launches = gru_sequence_bwd.launches_bf16 = 0


class GRUSequence(torch.autograd.Function):
    """K1 forward, keeping the gates; K2 backward; the weight gradients
    reduced outside."""

    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, h0, num_reverse, use_kernels):
        run = gru_sequence if use_kernels else gru_sequence_plain
        out, gates = run(gi, w_hh, b_hh, h0, num_reverse, keep=True)
        ctx.save_for_backward(gi, w_hh, h0, out, gates)
        ctx.num_reverse, ctx.use_kernels = num_reverse, use_kernels
        return out

    @staticmethod
    def backward(ctx, g):
        gi, w_hh, h0, out, gates = ctx.saved_tensors
        hprev = previous_states(out, h0, ctx.num_reverse)
        run = gru_sequence_bwd if ctx.use_kernels else gru_sequence_bwd_plain
        dgi, dgh, dh0 = run(gi, hprev, g.contiguous(), gates, w_hh, ctx.num_reverse)
        # In bfloat16 the products sum in float32 (runtime.py pins cuBLAS so)
        # and the result takes the weights' dtype, as gru_pallas.py:216-218.
        dw = torch.einsum("tsrh,tsrg->shg", hprev, dgh)
        return dgi, dw, dgh.sum(dim=(0, 2)), dh0, None, None


def gru_sequence_autograd(gi, w_hh, b_hh, h0, num_reverse: int = 0,
                          use_kernels: bool = True):
    """The differentiable state sequence (T, S, R, h). use_kernels=False runs
    the plain forward and backward on any device (the reference). When no
    gradient will be taken (grad disabled, or no input requires one) the
    forward keeps nothing for a backward."""
    args = (gi, w_hh, b_hh, h0)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in args)):
        run = gru_sequence if use_kernels else gru_sequence_plain
        return run(*args, num_reverse)
    return GRUSequence.apply(*args, num_reverse, use_kernels)
