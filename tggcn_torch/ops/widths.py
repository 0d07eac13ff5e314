"""Every hidden width h >= 1 on the card: K1-K5 at a width their kernels do
not take.

The kernels copy rows in 16-byte pieces (``cp.async``, TMA boxes, the
cluster route's unit slices), so each takes h % 4 == 0 in float32 and
h % 8 == 0 in bfloat16 (``ALIGN``). JAX's Pallas kernels take whole-array
blocks at any width. At another width each wrapper widens every operand to
h' = ``aligned(h, dtype)``, the next width the kernel takes, runs the
kernel there and narrows its outputs back to h: ``pad -> fn -> slice``,
with fn the kernel's launch on the card or its plain version in the tests.
At an aligned width nothing is copied: fn takes the caller's tensors.

Each h-wide block of an axis (the gates [r | z | n] of a 3h axis, the
halves of a 2h axis) gets h' - h zero columns at its end (``widen``), so
the padded units are zero in every operand: states, both axes of every
weight, biases and cotangents. They then stay exactly zero, and add exact
zeros to every real sum:

* The GRU (K1, and the scan's cells): a zero unit's gate pre-activations
  are 0 (zero weight columns and bias), so r = z = sigmoid(0) = 1/2,
  n = tanh(0 + r * 0) = 0 and h' = (1 - z) n + z 0 = 0; a committed cell's
  u h' + (1 - u) 0 = 0. Its zero weight rows keep it out of the real
  units' products.
* The scan's messages (K3, K5): a zero unit's edge message is
  relu(x W + b) with a zero weight column and bias, relu(0) = 0; the dot,
  concat and bilinear scores sum zero products over it (``scale``, 1/sqrt
  of the real h, is passed in and never recomputed from h'); the mixed
  messages are 0 there, and the message -> gate weights' zero rows keep
  them out of the gates.
* The backward sweeps (K2, K4): the cotangent is zero on the padded units
  and so is the carried dL/dh: every term of a padded unit's carry is a
  product with that zero, with a zero weight row, or with a zero state, so
  the padded units' dgi, dgh and dpre are 0 and never reach a real unit's
  carry, its message gradients or the attention's backward. Whatever the
  kernel writes for them is sliced away; the weight gradients are reduced
  outside, from the narrowed outputs.
"""

import torch

ALIGN = {torch.float32: 4, torch.bfloat16: 8}


def aligned(h: int, dtype) -> int:
    """The least width >= h that the kernels take in the IO dtype."""
    a = ALIGN.get(dtype, 1)
    return -(-h // a) * a


LAST = ((-1, 1),)          # one h-wide block on the last axis


def _split(shape, h, hp, axes):
    """(the shape with each axis of `axes` ((axis, blocks), ...) split into
    (blocks, h), the same split at hp, the dims of the h parts, the shape
    with those axes blocks * hp wide)."""
    blocks = {axis % len(shape): b for axis, b in axes}
    real, wide, dims, out = [], [], [], list(shape)
    for i, n in enumerate(shape):
        if i in blocks:
            if n != blocks[i] * h:
                raise ValueError(f"axis {i} of shape {tuple(shape)} is not {blocks[i]} x {h} wide")
            dims.append(len(real) + 1)
            real += [blocks[i], h]
            wide += [blocks[i], hp]
            out[i] = blocks[i] * hp
        else:
            real.append(n)
            wide.append(n)
    return real, wide, dims, out


def widen(x, h: int, hp: int, axes=LAST):
    """x with each axis of `axes` ((axis, blocks), ...), blocks h-wide
    blocks, widened to blocks hp-wide ones whose new columns are zero: one
    copy of x and one zeroing of the new columns an axis. x itself where
    hp == h."""
    if hp == h:
        return x
    real, wide, dims, out = _split(x.shape, h, hp, axes)
    y = x.new_empty(wide)
    index = tuple(slice(0, h) if d in dims else slice(None) for d in range(len(wide)))
    y[index].copy_(x.reshape(real))
    for d in dims:
        y.narrow(d, h, hp - h).zero_()
    return y.reshape(out)


def narrow(x, h: int, hp: int, axes=LAST):
    """The inverse of widen, one copy: the first h columns of each hp-wide
    block of each axis of `axes`, contiguous. x itself where hp == h."""
    if hp == h:
        return x
    blocks = {axis % x.dim(): b for axis, b in axes}
    shape = [b * h if (b := blocks.get(i)) else n for i, n in enumerate(x.shape)]
    _, wide, dims, _ = _split(shape, h, hp, axes)
    index = tuple(slice(0, h) if d in dims else slice(None) for d in range(len(wide)))
    return x.reshape(wide)[index].reshape(shape).contiguous()
