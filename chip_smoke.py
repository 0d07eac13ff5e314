#!/usr/bin/env python3
"""Drive tggcn_torch's stage-1 serving and training paths, in float32 and in
bfloat16 (the dtype bench.py trains in), its stage-2 training and serving
paths, its serving modes, CAD-120's stage 1 and the general segment scan's
configurations, the entry points on MPHOI, CAD-120 and Bimanual, the
baselines, sliding-window streaming, data-parallel training, the kernels
at unaligned hidden widths and the train CLI's switches on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order, each under a watchdog that ends the run with a non-zero
exit and the phase's name if the phase hangs:

  device   the card's name and power limit (nvidia-smi)
  build    the CUDA kernels from tggcn_torch/csrc, with nvcc; the wgmma
           kernels' registers, static shared memory and spills (-Xptxas
           -v) and their dynamic shared memory, and the same report of
           K1's and K2's bfloat16 cluster kernels and of K4's bfloat16
           kernels at h <= 512 (DA segb_dmsgs_att, R segb_carry_ds)
  k1       the frame-BiGRU kernel (gru_sequence) against its plain PyTorch
           version at the MPHOI shape T=167, S=6, R=32, h=512: the states
           and the gates it keeps for the backward, and the states of the
           serving run that keeps nothing; its device ms by kernel name
           (torch.profiler); the library yardstick, cuDNN's GRU set up to
           compute the same recurrence (tggcn_torch.profile_gru), against
           the plain version and timed
  k2       the frame-BiGRU backward kernel (gru_sequence_bwd) against its
           plain version at the same shape, on the gates the plain forward
           kept and a random upstream gradient; its device ms by kernel
           name, its bound beside the bound of the design that recomputed
           the gates, and the cuDNN GRU's forward and backward against the
           plain version and timed
  k3       the segment-scan kernel (segment_scan_dot) against its plain
           version at T=167, B=8, H=2, O=4, h=512, with random commit
           decisions and masked objects (one batch row has none): the
           outputs and what it keeps for the backward, and the outputs of
           the serving run that keeps nothing; then its device ms by kernel
           name (torch.profiler)
  k4       the segment-scan backward kernel (segment_scan_dot_bwd) against
           its plain version on K3's inputs, what the plain forward kept and
           random upstream gradients; its device ms by kernel name, and its
           bound beside the bound of the design that recomputed the gates,
           scores and mixing
  k5_v1, k5_v4, k5_ext
           the segment-scan kernel in its other modes (segment_scan_v1,
           _v4, _ext) against its plain version on K3's inputs and random
           attention weights (v1, v4) or the inverse-distance weights of
           seeded distances with exact zeros (ext); its device ms by kernel
           name and each phase's blocks and blocks an SM
           (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
  k6       the fused GeoGCN kernel (geo_gcn_fused) against its plain
           version over N = B * T = 1336 frames of V = 26 nodes, and both
           against the plain version in float64; its frames a block, grid
           and blocks an SM
  k1_bf16, k2_bf16, k3_bf16, k4_bf16
           the bfloat16 variants of K1-K4 (the same wrappers, on bfloat16
           inputs) against their plain bfloat16 versions at the same
           shapes, as k1-k4, with the controls of each check (see
           Tolerances); k1_bf16 and k2_bf16 time cuDNN's GRU in bfloat16
           beside them and print their cluster route: the plan (blocks a
           cluster, units a block, rows a cluster, dynamic shared memory,
           clusters the card holds at once; for K1 also an 8 x 64-unit
           plan's occupancy), the launches of a call (one), a call
           repeated bit for bit, and the calls at the predict batch of 128
           clips and a streamed window's single clip against their plain
           versions, timed; k3_bf16 and k4_bf16 print beside each product
           phase's device ms the bytes it copies from L2 a step (from the
           shapes) and the rate it reached, and k3_bf16 its phases' blocks,
           blocks an SM and dynamic shared memory; k4_bf16 prints its
           two-launch route: the plan (DA's blocks a cluster, clusters a
           step, dynamic shared memory and clusters the card holds at
           once, R's blocks and shared memory, the batch tile), the
           launches of a call (2T + 2, no segb_att), a call repeated bit for
           bit, the per-step route's outputs bit for bit, and the calls at
           a data-parallel process's 4 clips and a streamed window's 1
           against their plain versions at the MPHOI limits, timed
  k5_v1_bf16, k5_v4_bf16, k5_ext_bf16
           K5's bfloat16 variant in each mode against its plain bfloat16
           version on the k5 phases' inputs in bfloat16, with the controls
  forward  the 2G-GCN stage-1 forward at the full MPHOI width (hidden 512,
           gcn_node 26, input (2152, 2048), B=8, T=167, 2 humans, 4
           objects) on 3 seeded requests through select_model: finite
           outputs, K1 and K3 launched, and agreement with the plain path
           on the card (apply(..., use_kernels=False), which must launch
           no kernel)
  forward_bf16
           the same with compute_dtype bfloat16 (stage1.BENCH_DTYPE, the
           dtype bench.py trains in): K1's and K3's bfloat16 variants
           launched once a request; and the controls of the comparison
  train    the stage-1 train step (forward with train=True, the MPHOI loss
           bundle, backward through K2 and K4, Adam, BatchNorm write-back)
           at the same width: one step on the kernel route and one on the
           plain route from the same weights, compared loss by loss, leaf
           by leaf (gradients and updated weights); a second kernel-route
           step from the same weights, batch and noise, whose gradients
           must equal the first's bit for bit on every leaf; then 3 timed
           steps on the kernel route, each of which must launch K1-K4, and
           their peak device memory, with only that route's weights, Adam
           state and batch alive before them
  train_bf16
           the same with compute_dtype bfloat16 (float32 masters and Adam
           state): each timed step must launch the bfloat16 variants of
           K1-K4; the controls of the gradient comparison (two more plain
           steps)
  train_stage2, train_stage2_bf16
           the train and train_bf16 phases for the stage-2 model
           (tggcn_torch.models.stage2: decisions learned for humans and
           objects and filtered to local maxima at threshold 0.1, the
           segmentation loss on, stage2.make_batch), its weights a stage-1
           tree merged into its own init (merge_params; the number of
           leaves taken is printed), Gumbel noise for humans and objects
           handed to both routes, the same limits
  forward_stage2
           one stage-2 request (nothing imposed) on each route, held to the
           forward phase's limits
  forward_stage2_features
           the same for each of stage2.FEATURE_VARIANTS (the time position
           as a decision input with the periodic encoding and shared level
           heads; as a segment input with the embedding, the segment length
           and the level states concatenated)
  serve_modes
           the forward phase for each of stage1.SERVE_VARIANTS at the same
           width and shape: distance-based attention from seeded distances
           with the GeoGCN kernel on (dist: K1, K5 ext, K6), concat (v1:
           K1, K5 v1) and bilinear (v4: K1, K5 v4) attention, mean pooling
           (mp: K1, K5 ext); each against its plain route, which must
           launch nothing
  serve_modes_bf16
           the serve_modes phase with compute_dtype bfloat16, one request a
           variant: K1's and K5's bfloat16 variants (K6 float32, as in
           JAX's bfloat16 model), each held to its plain route under
           forward_bf16's limits
  train_modes, train_modes_bf16
           the train phase (in float32, in bfloat16) for each of
           stage1.SERVE_VARIANTS (one timed step each): K1 and K5 forward
           (K6 in 'dist'), K2 and the recompute backward of JAX's fast path
           (tggcn_torch/models/segment_fast.py) for K5's gradients; each
           step launches K5 once; two kernel-route steps bitwise equal;
           losses under the stage-1 limits against the plain route, the
           gradients over the whole model (MODE_TRAIN_LIMITS: float32
           within 1e-3 of the model's largest gradient; bfloat16 the norm
           of the difference within 1.15e-2 of the gradient's, with the
           controls); the recompute backward's ms per step (CUDA events
           around it: its span on the card, gaps included)
  sync_free
           one eager kernel-route train step of the bfloat16 stage-1,
           stage-2 and CAD-120 models, each drawing its Gumbel noise on the
           card, under torch.cuda.set_sync_debug_mode("error"): no call may
           synchronize
  train_fused, train_fused_bf16, train_fused_stage2_bf16
           stage 1 in float32 and bfloat16, stage 2 in bfloat16: 4 train
           steps fused into one call (tggcn_torch.train.loop.
           make_fused_train_steps: one step captured in a CUDA graph and
           replayed) against 4 eager kernel-route steps from the same
           weights, batch and Gumbel noise stack, each route with its own
           capturable Adam: losses, every leaf, Adam's moments and step
           counts, the BatchNorm state, equal bit for bit; each replay
           launches K1-K4 of the dtype as often as an eager step, counted
           by torch.profiler's kernel names (a replay runs no wrapper);
           then a 20-step window of each route with fresh noise drawn on
           the card: ms a step (host clock, one synchronize a window), busy
           ms and kernels a step over 5 profiled steps, idle share (1 -
           busy / ms a step; and of the profiled wall, which the
           profiler's own overhead raises); peak device memory
  forward_cad120, forward_cad120_bf16
           one CAD-120 stage-1 request (tggcn_torch.models.cad120: hidden
           512, gcn_node 19, B=16, T=167, 1 human, 5 object slots, some
           empty, both segmentations imposed by the stage-1 feeder) on each
           route, under the forward phases' limits; its segment scan is the
           general one (plain PyTorch), so exactly K1 launches, once
  forward_cad120_dist
           the same in float32 with CAD-120's two distance tensors
           (human-object, object-object) and the GeoGCN kernel: exactly K1
           and K6, once each
  train_cad120, train_cad120_bf16
           the train phases for the CAD-120 model (its 12-loss bundle, lr
           1e-3): each step launches exactly K1 and K2 of the dtype, with
           the bfloat16 phase's controls
  train_cad120_dist
           the train phase for the CAD-120 model with its two distance
           tensors and the GeoGCN kernel (cad120.SERVE_VARIANTS['dist']),
           float32, one timed step: K1, K2 and K6 once a step; held over
           the whole model, as every variant's step (MODE_TRAIN_LIMITS)
  train_fused_cad120_bf16
           the train_fused phase for the CAD-120 model in bfloat16 (K3 and
           K4 launched by neither route), 1 profiled step a route and
           the eager route timed over 5 steps (about 1.5 s each)
  forward_general_variants
           float32 at hidden 64, B=8, T=167, one request of each of three
           configurations of the general scan, on each route: relational
           messages with mean pooling and 'sah' objects (CAD-120, 1 human,
           5 objects), 'specific' messages with concat attention, both
           positional features and the level states concatenated
           (Bimanual, 2 hands, 9 objects), no segment messages with the
           GeoGCN BatchNorm in train mode (MPHOI, 2 humans, 4 objects);
           'st' decisions taken; exactly K1 launches, once a request
  entry_mphoi
           the entry points on a synthetic MPHOI dataset written by
           tggcn_torch.data.synthetic (2048-wide features, 2 humans, 4
           objects, 16 clips of 360-500 frames; downsampled by 3, T up to
           167): the train CLI (tggcn_torch.train.cli.main, in process) for
           2 epochs of stage 1 at the yaml's full width (hidden 512, batch
           8) in bfloat16, K1-K4 launched by each train step and K1 and K3
           by each evaluation batch; the predict CLI on the run dir it
           wrote, K1 and K3 launched once a batch; the kernel route held
           against the plain route on the same run dir (the test clips as
           one request: the forward limits, and labels equal except where
           the plain route's top-two margin lies within the bfloat16
           forward limit, counted); a batch of 128 clips timed (clips/s);
           a 1-epoch run resumed from its last.ckpt to 2 epochs, whose
           epoch-2 losses must equal the uninterrupted run's; stage 2
           warm-started from the stage-1 run dir for 1 epoch; stage 1 in
           float32 for 2 epochs. Seconds of each epoch's train steps and
           of its evaluation (the runs' scalars.jsonl) and peak device
           memory of each run
  entry_cad120, entry_bimanual
           the 2G-GCN stage 1 through the train and predict CLIs on a
           synthetic CAD-120 (5 object slots) or Bimanual dataset (16 clips
           of 360-500 frames under outputs/) at the widths the stage-1
           yaml gives the dataset (CAD-120: hidden 512, batch 16, lr 1e-3,
           gcn_node 19, one human; Bimanual: hidden 64, batch 32, lr 1e-3,
           gcn_node 30), float32, 2 epochs: each train step launches its
           route's kernels once (route_kernels: K1 and K2; the general
           scan runs CAD-120's segments, K3 and K4 Bimanual's), each
           evaluation batch the forward's, the predict CLI's once a batch;
           finite losses; seconds, epoch seconds and peak memory
  entry_baselines
           the baselines through the entry points: synthetic CAD-120 and
           Bimanual datasets (tggcn_torch.data.synthetic, the generators'
           2048-wide features, 16 clips of 360-500 frames each, downsampled
           by 3) under outputs/; the train CLI for 2 epochs of
           cad120_baseline and bimanual_baseline at the yaml's width (hidden
           128, batch 16, float32), K1 launched by each train step and each
           evaluation batch, K2 by each step; the predict CLI on each run
           dir, K1 once a batch; the kernel route held against the plain
           route on the test clips (the forward limits, and frame labels
           equal except within a top-two margin of FORWARD_ATOL, counted);
           one train step of each trained run on its first train batch on
           both routes (K1 and K2 once on the kernel route, none on the
           plain route; losses within LOSS_RTOL, every leaf's gradient
           within LEAF_GRAD_RTOL of that leaf's largest); the reference's
           two baseline fixtures (tests/golden/baseline_*) on the kernel
           route at rtol 2e-4, atol 2e-5
  stream_mphoi
           tggcn_torch.models.streaming.StreamingRunner at MPHOI's width
           (hidden 512, 2 humans, 4 objects, v3, 'st', per_frame, B=1, the
           human segmentation imposed), in float32 and in bfloat16: a
           96-frame stream in windows of 16 with the whole stream as
           lookahead against the offline forward, both on the kernel route
           (float32: the forward limits; bfloat16: rel_l2 within the
           CAD-120 bfloat16 request's 7e-5); then tools/bench_streaming.py's
           stream (2048 frames, window 128, lookahead 32, fuse_group 16):
           K1 and K3 once a window, the kernel route held against the plain
           route under the same limits, frames/s and ms a window (best of 3,
           host clock to the outputs on the host), with the stream on the
           host and on the card
  train_dp
           data-parallel training (tggcn_torch.parallel): stage 1 at the
           full MPHOI width (hidden 512, B=8, T=167, 'gs' object
           decisions), float32 then bfloat16, 3 eager steps from one init
           with each step's noise from a generator seeded seed + step: in
           one process; in a group of one NCCL process, which must equal it
           bit for bit (losses, first-step gradients, every leaf and the
           BatchNorm state after every step); and on 2 gloo processes on
           the one card (NCCL takes one device a process), 4 rows each,
           which must hold the same bits after every step, launch K1-K4 of
           the dtype once a step each, and stay within LOSS_RTOL (bfloat16:
           LOSS_RTOL_BF16) of the one process's losses and within
           LEAF_GRAD_RTOL (LEAF_GRAD_RTOL_BF16) of each leaf's largest in
           the first step's gradients, with the decision-flip check of the
           train phases (a marginal flip reruns both without its row and
           one more) and, in float32, the kink check of train_cad120: the
           processes' products see 4 rows, the one process's 8, so a ReLU
           input within rounding of 0 may fall either way. MLP kinks
           (kink_sides) and kinks inside K3 (its kept messages,
           scan_kinks) each at most KINK_FLIPS within KINK_MARGIN; with
           any, the step as it ran must hold the whole-model limit of
           MODE_TRAIN_LIMITS, the processes run again on the one process's
           side of each MLP kink, and the leaves are compared; a K3 kink
           cannot be made to take a side, so with one the rerun is held
           over the whole model (MODE_TRAIN_LIMITS, as a K5 mode's step
           whose recomputed ReLUs flip). Step ms and peak memory per
           process; then python -m tggcn_torch.train with
           resources.num_devices one above the card count must fail with
           make_mesh's ValueError
  bench_short
           python -m tggcn_torch.bench --steps 2 --best-of 1 (bfloat16, the
           full width) in a subprocess: its last line parses, carries no
           error, a positive value and a cross-check within 5%
  small    the same model at hidden 24 on the card against the plain path
           on the CPU
  widths   K1-K5 in float32 and bfloat16, forward and backward, at hidden
           widths their 16-byte copies do not all take, h = 6, 100 and 510,
           on the k phases' inputs at the MPHOI shape (B=8, T=167, 2 humans,
           4 objects; K1 and K2 S=6, R=32): the wrappers run each at the
           next width it takes (tggcn_torch/ops/widths.py), each call
           launches its kernel once (the wrapper's counter: no width reaches
           a plain version), held against its plain version at its k
           phase's limits (bfloat16 with its controls; where a control
           cannot fail at a width, WIDTH_LIMITS_BF16 holds it there); its ms
           beside the aligned h = 512 call's, and the padding's copy kernels
           a call (each widen's copy and zeroing an axis, each narrow's
           copy) with their ms (CUDA events around each). Then the
           bfloat16 stage-1 train step at hidden 510, held as train_bf16 but
           over the whole model (WIDTH_STEP_LIMITS says why), and one
           cad120_baseline epoch through the train CLI at hidden 126, held
           as entry_baselines (without the reference fixtures)
  entry_switches
           the train CLI's two switches in entry_mphoi's manner (its
           synthetic MPHOI dataset, the stage-1 yaml's full width, bfloat16,
           2 epochs): with resources.jax_profiler_dir the run leaves one
           Chrome trace, trace.rank0.json, naming kernels of K1-K4; with
           resources.debug_nans the run's losses equal the traced run's bit
           for bit; on a copy of the dataset whose one training clip has
           +inf features (the loader makes a NaN feature 0) debug_nans
           raises FloatingPointError

The model, requests and batches are tggcn_torch.models.stage1's: the
stage-1 configuration with the human segmentation imposed (as the stage-1
feeder does) and the configured 'gs' decision rule for the objects, whose
Gumbel noise is drawn once per request or batch and handed to both routes.
Weights are random from a fixed torch.Generator; inputs come from numpy
with --seed.

Times: a kernel's ms is the median of 5 calls timed by CUDA events behind a
wait on the card (cuda_ms with spin), so that it is the card's time; a
plain version's ms is the median of its calls timed by CUDA events alone,
the host's time between its many small launches included; a request's or
a train step's ms is the host's clock around it, ended by a synchronize.

Tolerances (float32): each forward kernel agrees with its plain version within 1e-4
absolute (the states lie in (-1, 1); the kernels sum float32 products in
another order than cuBLAS); each backward kernel within 1e-4 of the largest
value of each output (the carried gradient sums over the sequence). Whole
forwards agree within rtol 1e-4, atol 1e-4; train-step losses within rtol
1e-4, each gradient leaf within 1e-3 of its largest value (or of a
millionth of the model's largest gradient, where a leaf's gradient is
rounding noise: the softmax makes the GeoGCN s2 bias's exactly 0), each weight
within one learning rate (Adam's first step moves a weight by lr g / (|g| +
eps), which saturates at lr, so a gradient within rounding of zero may step
either way). A hard decision (a human's or an object's) whose soft value
lies within 1e-4 of the threshold may round the other way in the two
routes; with filtered decisions (stage 2: a local maximum of the soft
values at or above the threshold) also one whose soft value lies within
1e-4 of the neighbour it is compared with (flip_margins). Such a flip is
counted and its batch row left out of the comparison (the train step is
then run again on both routes without that row), at most one row per
request or batch. Any other flip, or a second row with flips, fails the run.
A ReLU of the model's MLPs is a hard decision at 0 too. In the CAD-120
float32 train step, held leaf by leaf, an input within KINK_MARGIN (1e-6)
of 0 in both routes that falls on the other side of it in the kernel
route is counted, at most KINK_FLIPS (4) in a step (so in at most 4 batch
rows); the kernel-route step as it ran must then hold the float32
whole-model limit of a K5 mode's step (MODE_TRAIN_LIMITS), and it is run
again taking the plain route's side at each such kink (kink_sides,
relu_inputs) before the leaves are compared. A wider flip, or a fifth,
fails. (On an H100 80GB HBM3, 700 W, at the CAD-120 width three inputs
within 2.8e-8 of 0 fell either way, in three batch rows; they moved o2h's
frame message weight gradient by 1.28e-2 of the leaf's largest, and the
whole model's by 3.5e-4 of its largest gradient. Their count bounds the
kernel route's error there: an error some tens of times larger would flip
some tens of times as many.)

Tolerances (bfloat16; the values and the readings they were set from
stand beside LIMITS_BF16): each bfloat16 forward kernel's outputs, and the
float32 tensors it keeps, within one bfloat16 ulp at the scale of each
tensor's largest value (kernel and plain version carry float32 state, but
a float32 sum in another order can round a state to the neighbouring
bfloat16, which the next step's products then read: an element-by-element
ulp does not hold, and the phase line prints both); K2-bf16 within 5e-3
and K4-bf16 within 1e-2 of each output's largest value; whole bfloat16
forwards within 6e-4, with a decision marginal within 2^-7 of the
threshold or of its neighbour (two bfloat16 ulps above 0.5); the bfloat16 train step's losses
within rtol 1e-2, each gradient leaf within 3.9e-2 of its largest; cuDNN's
bfloat16 GRU, which rounds its carried state to bfloat16, within 5e-2 of
the plain version. Beside these, each bfloat16 check runs two controls
(check_controls) and fails unless its measure (LIMITS_BF16: for K1, K3 and
K4 the norm of the difference over the norm, rel_l2) passes the plain
route with float64 sums, a correct version whose sums differ as the
kernels' do, and fails the plain route with its carried state and dL/dh
rounded to bfloat16 every step, as JAX's XLA route carries them: the line
"... carry rounded to bfloat16 ... (must fail)" shows that the check sees
that fault. The CAD-120 bfloat16 phases, whose general scan carries
bfloat16 states as JAX's XLA route does, are held by the norm of the
difference alone (LIMITS_CAD120_BF16, with the same controls): a request's
outputs within 7e-5 of their norm, a step's gradients within 8e-3 of the
model's gradient norm, and each leaf's gradient, as in the other bfloat16
steps, within 3.9e-2 of its largest. The weights after the bfloat16 step are not held apart: Adam's
first step moves each by less than lr either way, and the gradient check
bounds them.

Bounds: the bytes each kernel must move (inputs read once, outputs written
once) over the HBM rate, or its arithmetic, whichever takes longer: the
FLOPs of its float32 products at a third of the TF32 tensor-core rate (the
3xTF32 split keeps float32 accuracy), of the bfloat16 variants' products
at a third of the BF16 rate (K1, K2: a float32 state against bfloat16
weights at float32 accuracy, fastest as three BF16 products on a
three-part split of the state) or at the BF16 rate (K3, K4: bfloat16 x
bfloat16), and its other FLOPs at the float32 FMA rate. Each kernel's
phase line also gives bound_fma_ms, the same work with the products on the
FMA units.

Library: one PyTorch call that computes a kernel's function, timed beside
it and used nowhere in the port. Only K1 and K2 (and their bfloat16
variants) have one, and it takes several calls (cuDNN's GRU, one per
stream, with identity input weights): an upper bound on the library's time.

The second-to-last line is a JSON object with each kernel's launches (K1-K4
on the timed train steps, their bfloat16 variants on the timed bfloat16
train steps, K5 and K6 on the serve_modes requests), error, times and
bound (K5's bfloat16 variants on the serve_modes_bf16 request); the
last line is {"ok": true, "device": {...}}. Without a
CUDA device the script exits 1 and prints no result.
"""

import argparse
import contextlib
import faulthandler
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and TF32 (495 TFLOP/s) and BF16
# (989 TFLOP/s) FLOP/s on them. A float32 product at float32 accuracy takes
# three TF32 products (the 3xTF32 split of tc_gemm.cuh), so the least time
# of a product's FLOPs is at a third of the TF32 rate; a bfloat16 x bfloat16
# product (K3 and K4 in bfloat16) runs at the BF16 rate. A float32
# activation against a bfloat16 weight (K1 and K2 in bfloat16) at float32
# accuracy is fastest as three BF16 products, the activation split into
# three bfloat16 parts against the exact weight: a third of the BF16 rate,
# whatever split the kernel uses (K1 and K2 take two TF32 products, half
# the TF32 rate, which is slower). The rest of the arithmetic (scores,
# mixing) is at the FMA rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
PRODUCT_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12
F32_BF16_FLOP_PER_S = BF16_FLOP_PER_S / 3
KERNEL_ATOL = 1e-4
KERNEL_GRAD_RTOL = 1e-4
LIBRARY_BF16_ATOL = 5e-2            # cuDNN's GRU in bfloat16 rounds its carried state
LIBRARY_BF16_GRAD_RTOL = 5e-2
FORWARD_RTOL = FORWARD_ATOL = 1e-4
LOSS_RTOL = 1e-4
LEAF_GRAD_RTOL = 1e-3
# bfloat16, each limit set between two readings on the card (H100 80GB
# HBM3, 700 W; check_controls prints them every run): the plain route with
# float64 sums, a correct version whose sums differ from the float32 plain
# route's, below; the plain route with its carry rounded to bfloat16 every
# step, as JAX's XLA route carries it, above. Kernel route, float64 sums,
# rounded carry, as measured:
#   K1 rel_l2 2.0e-5, 2.0e-5, 2.0e-3 (all 1 bfloat16 ulp of the largest)
#   K2 max_share 3.47e-3, 1.81e-3, 7.25e-3; rel_l2 4.1e-5, 3.9e-5, 2.0e-3
#   K3 rel_l2 1.78e-3, 1.82e-3, 2.79e-3 (all 0.5 ulp of the largest)
#   K4 rel_l2 2.64e-3, 2.64e-3, 5.13e-3 (max_share 8.9e-3, 1.27e-2, 1.27e-2:
#      a correct version with other sums lies 1.27e-2 away, so K4's 1e-2
#      of each output's largest tells no rounded carry apart)
#   K5 rel_l2 v1 1.02e-3, 1.05e-3, 2.10e-3; v4 2.05e-3, 2.07e-3, 2.86e-3;
#      ext 1.00e-3, 1.00e-3, 2.09e-3
#   request max_abs 3.8e-4, 3.9e-4, 8.9e-4
#   train step gradients max_share 2.65e-2, 3.05e-2, 5.78e-2: 3.9e-2 is
#      also the worst leaf of the JAX package's bfloat16 kernels against
#      its XLA route (BASELINE.md)
GRU_GRAD_RTOL_BF16 = 5e-3
SCAN_GRAD_RTOL_BF16 = 1e-2
LOSS_RTOL_BF16 = 1e-2
LEAF_GRAD_RTOL_BF16 = 3.9e-2
FORWARD_ATOL_BF16 = 6e-4
# The measures (tensor_gaps, forward_gaps, grad_gaps) of each bfloat16
# check that its controls test (check_controls).
LIMITS_BF16 = {"k1": {"rel_l2": 2e-4}, "k2": {"max_share": GRU_GRAD_RTOL_BF16, "rel_l2": 4e-4},
               "k3": {"rel_l2": 2.25e-3}, "k4": {"rel_l2": 3.7e-3},
               "forward": {"max_abs": FORWARD_ATOL_BF16},
               "train": {"max_share": LEAF_GRAD_RTOL_BF16},
               "k5_v1": {"rel_l2": 1.5e-3}, "k5_v4": {"rel_l2": 2.4e-3},
               "k5_ext": {"rel_l2": 1.5e-3}}
# The CAD-120 bfloat16 phases (forward_cad120_bf16, train_cad120_bf16):
# the general scan carries bfloat16 states, as JAX's XLA route does, and
# through that carry the largest difference of a request (max_abs) or of a
# leaf's gradient (max_share) tells no rounded K1 carry apart. The norm of
# the difference does; the step still holds each leaf's max_share within
# LEAF_GRAD_RTOL_BF16 as well, which the kernel route meets (2.40e-2,
# 3.69e-2) and which bounds a fault confined to one small leaf. Readings, kernel / float64 sums / rounded carry (H100
# 80GB HBM3, 700 W, seeds 0 and 1):
#   request rel_l2 5.22e-5, 5.33e-5 / 5.21e-5, 5.29e-5 / 8.68e-5, 8.58e-5
#      (max_abs 7.47e-4, 7.44e-4 / 7.15e-4, 7.05e-4 / 1.08e-3, 9.87e-4)
#   step model_rel_l2 5.71e-3, 5.30e-3 / 5.66e-3, 5.30e-3 / 1.24e-2, 1.06e-2
#      (max_share 2.40e-2, 3.69e-2 / 2.77e-2, 3.69e-2 / 8.41e-2, 4.43e-2;
#      the leaves' rel_l2 reads 3.21e-2 for float64 sums, 2.64e-2 for a
#      rounded carry)
LIMITS_CAD120_BF16 = {"forward": {"rel_l2": 7e-5}, "train": {"model_rel_l2": 8e-3}}
# The train_modes phases' measures (grad_gaps) and limits, by dtype. A
# variant's gradients are the fast path's (models/segment_fast.py),
# recomputed at each route's own saved inputs, which differ by the kernels'
# rounding: in float32 a ReLU score or message that lies within that of
# its kink flips in the recompute, and in bfloat16 the recompute carries
# bfloat16 states, as JAX's does. A small leaf then moves by a large share
# of itself on a correct route: the stage-1 per-leaf measure read, at the
# MPHOI width (H100 80GB HBM3, 700 W), float32 kernel up to 1.7e-2 (v1,
# o2o's attention bias, 7e-7 of the model's largest gradient) and float64
# sums 5.0e-3 (dist), bfloat16 kernel 3.6e-2 to 0.68 and float64 sums 4.9e-2
# to 0.89. So the variants are held over the whole model, CAD-120's 'dist'
# too (train_cad120_dist; no recompute, its scan the general one): K6's
# products move every ReLU input downstream of the geometry by their
# rounding, and 11 within 1e-6 of 0 fell either way (H100 80GB HBM3, 700 W),
# beyond the KINK_FLIPS that train_cad120's route, without K6, keeps. Readings, kernel
# / float64 sums / rounded carry:
#   float32 model_share 3.3e-7 (v4) to 1.7e-4 (v1), kernel only
#   bfloat16 model_rel_l2 7.0e-3-8.8e-3 / 6.9e-3-8.7e-3 / 1.48e-2-1.73e-2
#   (model_share reads 2.4e-3-4.3e-3 for all three: it separates nothing)
MODE_TRAIN_LIMITS = {"float32": {"model_share": LEAF_GRAD_RTOL},
                     "bfloat16": {"model_rel_l2": 1.15e-2}}
GRAD_FLOOR = 1e-6
MARGINAL = 1e-4
# A ReLU input's kink in the CAD-120 float32 step (kink_sides): the margin
# and the most flips a step, from the readings (three flips, each input
# within 2.8e-8 of 0, H100 80GB HBM3, 700 W): about 36 times the
# largest input, and one flip more.
KINK_MARGIN = 1e-6
KINK_FLIPS = 4
MARGINAL_BF16 = 2.0 ** -7         # two bfloat16 ulps above 0.5: a soft decision in bfloat16
SPIN_CYCLES = 20_000_000         # about 10 ms at the H100's clock: longer than any wrapper's host time
REQUESTS = 3
TRAIN_STEPS = 3
MODE_TRAIN_STEPS = 1             # timed steps of a train_modes variant (profile_step times more)
LIBRARY = {
    "gru_sequence": "cuDNN's GRU (torch.nn.GRU, TF32 off), one call per stream with identity "
                    "input weights: an upper bound, since it also multiplies its input by the "
                    "identity",
    "gru_sequence_bwd": "cuDNN's GRU forward and backward (gradients of its inputs and "
                        "initial states), one call per stream: an upper bound, since it "
                        "includes the forward and the input products"}
NO_LIBRARY = {
    "scan": "no PyTorch call runs the gated message-passing step or its backward",
    "geo": "no PyTorch call computes the GeoGCN chain (embeddings, similarity softmax, "
           "(S h) W_out)"}

# The entry_mphoi phase's synthetic MPHOI dataset, and its batch of clips
# timed through the predict path's forward.
ENTRY_DATASET = dict(num_videos=16, min_len=360, max_len=500, num_objects=4)
ENTRY_PREDICT_BATCH = 128
FUSED_STEPS = 4                  # the fused steps held to eager ones bit for bit
FUSED_WINDOW = 20                # the timed window, bench.py's K
PROFILED_STEPS = 5               # steps of each route under torch.profiler
BENCH_SHORT_S = 300
# Kernel-name fragments of the train step's kernels (profile_step.GROUPS).
FUSED_GROUPS = ("K1", "K2", "K3", "K4")
PHASE_LIMIT_S = {"device": 60, "build": 360, "k1": 180, "k2": 180, "k3": 240, "k4": 300,
                 "k5_v1": 240, "k5_v4": 240, "k5_ext": 240, "k6": 120,
                 "k1_bf16": 180, "k2_bf16": 180, "k3_bf16": 240, "k4_bf16": 300,
                 "k5_v1_bf16": 240, "k5_v4_bf16": 240, "k5_ext_bf16": 240,
                 "serve_modes_bf16": 600, "train_modes": 900, "train_modes_bf16": 900,
                 "forward": 300, "forward_bf16": 300, "train": 420, "train_bf16": 420,
                 "train_stage2": 420, "train_stage2_bf16": 420, "forward_stage2": 180,
                 "forward_stage2_features": 300, "serve_modes": 600, "small": 180,
                 "sync_free": 240, "train_fused": 300, "train_fused_bf16": 300,
                 "train_fused_stage2_bf16": 300, "bench_short": BENCH_SHORT_S + 30,
                 "forward_cad120": 240, "forward_cad120_bf16": 240, "forward_cad120_dist": 240,
                 "train_cad120": 420, "train_cad120_bf16": 420, "train_fused_cad120_bf16": 420,
                 "forward_general_variants": 300, "entry_mphoi": 420, "entry_baselines": 300,
                 "stream_mphoi": 420, "train_cad120_dist": 420, "entry_cad120": 300,
                 "entry_bimanual": 300, "train_dp": 300, "widths": 600,
                 "entry_switches": 300}
# The kernels of the train step, and of each serving mode's segment scan.
TRAIN_KERNELS = ("gru_sequence", "gru_sequence_bwd", "segment_scan_dot", "segment_scan_dot_bwd")
K5_KERNELS = ("segment_scan_v1", "segment_scan_v4", "segment_scan_ext")
MODE_KERNEL = {"dist": "segment_scan_ext", "v1": "segment_scan_v1", "v4": "segment_scan_v4",
               "mp": "segment_scan_ext"}
K5_MODES = ("v1", "v4", "ext")
# The profiler's group (profile_step.GROUPS) of each of K1-K4's counters.
KERNEL_GROUP = {"gru_sequence": "K1", "gru_sequence_bwd": "K2", "segment_scan_dot": "K3",
                "segment_scan_dot_bwd": "K4"}
# A CAD-120 step runs about 48k kernels and takes about 1.5 s eager: its
# fused phase profiles 1 step a route and times the eager route over 5.
FUSED_PROFILED_CAD120, EAGER_WINDOW_CAD120 = 1, 5
# The general scan's configurations of forward_general_variants: the model
# (over the stage-1 yaml, hidden 64, 'st' decisions), humans, objects and
# whether the GeoGCN BatchNorm runs in train mode; after the reference
# fixtures cad120_sah_relational_mp, bimanual_extras and mphoi_train_bn.
GENERAL_VARIANTS = {
    "relational_mp_sah": (dict(input_size=(2124, 2048), num_classes=(10, 12), gcn_node=19,
                               message_humans_to_human=False, message_type="v1",
                               message_granularity="v2", message_aggregation="mp",
                               attention_style="v1", object_segment_update_strategy="sah"),
                          1, 5, False),
    "specific_v1_features": (dict(input_size=(2168, 2048), num_classes=(14, None), gcn_node=30,
                                  message_granularity="v2", attention_style="v1",
                                  add_time_position=True, add_segment_length=True,
                                  cat_level_states=True), 2, 9, False),
    "no_segment_messages_bn_train": (dict(message_segment=False), 2, 4, True),
}


@contextlib.contextmanager
def phase(name):
    print(f"phase {name}", flush=True)
    faulthandler.dump_traceback_later(PHASE_LIMIT_S[name], exit=True)
    start = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"phase {name} FAILED", flush=True)
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(f"phase {name} done in {time.perf_counter() - start:.3f} s", flush=True)


def cuda_ms(torch, fn, reps, spin=False):
    """Median milliseconds of fn() on the card, by CUDA events, after one
    warm-up. With spin the card first runs a wait of SPIN_CYCLES clock
    cycles (torch.cuda._sleep), while which the host queues the events and
    fn's launches: the events then time the card's work alone, without the
    host's time between launches (a kernel's wrapper checks and allocates
    in Python, which for a short kernel takes longer than the kernel)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(byte_count, product_flops, other_flops=0.0, product_rate=PRODUCT_FLOP_PER_S):
    """(least ms on the card, what bounds it) from bytes, the FLOPs of
    float32 products (at product_rate: 3xTF32 on the tensor cores unless
    told otherwise) and the other float32 FLOPs (at the FMA rate)."""
    t_bytes = byte_count / HBM_BYTES_PER_S
    t_ops = product_flops / product_rate + other_flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bounds(byte_count, product_flops, other_flops=0.0, product_rate=PRODUCT_FLOP_PER_S):
    """The kernel row's bound_ms and bound_by, and bound_fma_ms: the same
    work with the products on the FMA units, the rule before the port's
    products moved onto the tensor cores (kept as a note)."""
    ms, by = bound(byte_count, product_flops, other_flops, product_rate)
    fma_ms, _ = bound(byte_count, product_flops, other_flops, product_rate=F32_FLOP_PER_S)
    return dict(bound_ms=ms, bound_by=by, bound_fma_ms=fma_ms)


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check_kernel(name, got, want):
    err = max(max_err(g, w) for g, w in zip(got, want))
    if not all(bool(g.isfinite().all()) for g in got) or not err <= KERNEL_ATOL:
        raise AssertionError(f"{name}: kernel and plain version differ by {err:.3e} "
                             f"(limit {KERNEL_ATOL})")
    return err


def bf16_ulp(x):
    """The spacing of bfloat16 values at x > 0: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def check_kernel_bf16(torch, name, got, want):
    """A bfloat16 forward kernel's outputs and the float32 tensors it keeps
    against its plain version: each within one bfloat16 ulp at the scale of
    its largest value. Prints and returns the max abs error; the line also
    gives the largest error in those ulps and in ulps of each element
    itself (over the elements of at least 2^-8 of their tensor's largest)."""
    err = ulps = own = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not bool(g.isfinite().all()):
            raise AssertionError(f"{name}: an output is not finite or not {w.dtype}")
        d, a = (g.double() - w.double()).abs(), w.double().abs()
        top, e = float(a.max()), float(d.max())
        err, ulps = max(err, e), max(ulps, e / (bf16_ulp(top) or 1.0))
        big = a >= top * 2.0 ** -8
        if bool(big.any()):
            own = max(own, float((d[big] / torch.ldexp(torch.ones_like(a[big]),
                                                       torch.frexp(a[big])[1] - 8)).max()))
        if not e <= bf16_ulp(top):
            raise AssertionError(f"{name}: kernel and plain version differ by {e:.3e}, more "
                                 f"than one bfloat16 ulp of the largest value {top:.3e}")
    print(f"{name}: kernel vs plain max abs err {err:.3e}, {ulps:.3f} bfloat16 ulps of each "
          f"tensor's largest value (limit 1), {own:.3f} ulps of an element itself", flush=True)
    return err, ulps


@contextlib.contextmanager
def control(kind):
    """The plain route of K1-K4 made deliberately different, to read what a
    bfloat16 check sees. 'sums': the plain versions sum in float64 and
    round to bfloat16 at the same points, a correct version whose sums
    differ from the float32 plain versions' as the kernels' do (a check
    must pass it); 'carry': the plain versions round the carried state and
    dL/dh to bfloat16 after every step, as JAX's XLA route does and the
    kernels must not (a check must fail it)."""
    from tggcn_torch.ops import _build, gru_sequence, segment_scan

    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if kind == "sums":
        patch(_build, "upcast", lambda x: x.double())
        patch(_build, "rounding", lambda io: lambda x: x.to(io).double())
    else:
        for owner, name in ((gru_sequence, "gru_sequence_plain"),
                            (gru_sequence, "gru_sequence_bwd_plain"),
                            (segment_scan, "segment_scan_dot_plain"),
                            (segment_scan, "segment_scan_dot_bwd_plain"),
                            (segment_scan, "segment_scan_att_plain")):
            patch(owner, name, partial(getattr(owner, name), round_carry=True))
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def tensor_gaps(got, want):
    """How far the tensors got lie from want, each measure the largest over
    the tensors: max_share, the largest difference as a share of the
    tensor's largest value; ulps, the same in bfloat16 ulps of that value;
    rel_l2, the norm of the difference over the tensor's norm."""
    out = dict(max_share=0.0, ulps=0.0, rel_l2=0.0)
    for g, w in zip(got, want):
        d, w = g.double() - w.double(), w.double()
        top, e = float(w.abs().max()), float(d.abs().max())
        out["max_share"] = max(out["max_share"], e / (top or 1.0))
        out["ulps"] = max(out["ulps"], e / (bf16_ulp(top) or 1.0))
        out["rel_l2"] = max(out["rel_l2"], float(d.norm()) / (float(w.norm()) or 1.0))
    return out


def check_controls(name, gap, plain, got, want, limits):
    """A bfloat16 check's two controls (see control) against the plain
    route's outputs want: plain() reruns the plain route (reaching the
    plain versions through their modules, where control patches them),
    gap(got, want) gives the measures (tensor_gaps). Prints the kernel
    route's (got) measures and the controls'; for each measure in limits,
    the kernel route and the 'sums' control must lie within the limit and
    the 'carry' control beyond it. Returns the measures."""
    rows = {"kernel": gap(got, want)}
    for kind in ("sums", "carry"):
        with control(kind):
            rows[kind] = gap(plain(), want)
    for kind, row in rows.items():
        print(f"{name} {kind} vs plain: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()),
              flush=True)
    for key, limit in limits.items():
        kernel, sums, carry = (rows[kind][key] for kind in ("kernel", "sums", "carry"))
        print(f"{name} {key}: kernel {kernel:.4g}, float64 sums {sums:.4g} (must pass), "
              f"carry rounded to bfloat16 {carry:.4g} (must fail); limit {limit:g}", flush=True)
        if not max(kernel, sums) <= limit < carry:
            raise AssertionError(f"{name}: {key} limit {limit:g} does not lie between kernel "
                                 f"{kernel:.4g} and float64 sums {sums:.4g} below and a "
                                 f"rounded carry {carry:.4g} above")
    return {f"{kind}_{k}": v for kind, row in rows.items() for k, v in row.items()}


def run_k1(torch, dev, shape, dtype=None):
    """K1 (or, with dtype bfloat16, K1's bfloat16 variant) against its
    plain version, timed, with cuDNN's GRU in the same dtype."""
    import tggcn_torch.ops.gru_sequence as gru_ops
    from tggcn_torch.ops.gru_sequence import gru_sequence, gru_sequence_plain
    from tggcn_torch.profile_gru import (cudnn_grus, cudnn_inputs, cudnn_sequence,
                                         cudnn_states, gru_inputs)
    from tggcn_torch.profile_scan import device_ms_by_kernel

    bf16 = dtype == torch.bfloat16
    tag = "k1_bf16" if bf16 else "k1"
    t, s, r, h = shape
    args = gru_inputs(dev, torch.Generator(device=dev).manual_seed(1), t, s, r, h)
    if bf16:
        args = tuple(x.to(dtype) for x in args)
    nr = s // 2
    want, want_gates = gru_sequence_plain(*args, nr, keep=True)
    got, gates = gru_sequence(*args, nr, keep=True)
    served = gru_sequence(*args, nr)
    controls = {}
    if bf16:
        err, ulps = check_kernel_bf16(torch, "gru_sequence_bf16", [got, gates, served],
                                      [want, want_gates, want])
        controls = check_controls("gru_sequence_bf16", tensor_gaps,
                                  lambda: gru_ops.gru_sequence_plain(*args, nr, keep=True),
                                  [got, gates], [want, want_gates], LIMITS_BF16["k1"])
    else:
        err = check_kernel("gru_sequence", [got, gates, served], [want, want_gates, want])
    grus = cudnn_grus(*args[1:3])
    xs, h0s = cudnn_inputs(args[0], args[3], nr)
    lib_err = max_err(cudnn_states(cudnn_sequence(grus, xs, h0s), nr), want)
    lib_limit = LIBRARY_BF16_ATOL if bf16 else KERNEL_ATOL
    if not lib_err <= lib_limit:
        raise AssertionError(f"the cuDNN GRU and the plain version differ by {lib_err:.3e}")
    ms = cuda_ms(torch, lambda: gru_sequence(*args, nr, keep=True), 5, spin=True)
    served_ms = cuda_ms(torch, lambda: gru_sequence(*args, nr), 5, spin=True)
    plain_ms = cuda_ms(torch, lambda: gru_sequence_plain(*args, nr, keep=True), 3)
    library_ms = cuda_ms(torch, lambda: cudnn_sequence(grus, xs, h0s), 5, spin=True)
    split = device_ms_by_kernel(lambda: gru_sequence(*args, nr, keep=True), 1)
    print_split(tag, split)
    print(f"{tag} ms {ms:.3f} keeping the gates (a train step's call), {served_ms:.3f} keeping "
          f"none (a request's); library: the cuDNN GRU in {s} calls {library_ms:.3f} ms, max "
          f"abs err vs plain {lib_err:.3e}", flush=True)
    cluster = {}
    if bf16:
        again = gru_sequence(*args, nr, keep=True)
        cluster = gru_cluster_report(torch, dev, "fwd", tag, shape, split,
                                     torch.equal(again[0], got) and torch.equal(again[1], gates))
    return dict(name="gru_sequence_bf16" if bf16 else "gru_sequence", route="cuda",
                source="tggcn_torch/csrc/gru_sequence.cu",
                replaces="tggcn/ops/gru_pallas.py:147", max_abs_err=err, ms=ms,
                served_ms=served_ms, plain_ms=plain_ms, library_ms=library_ms, **controls,
                **cluster,
                **bounds(nbytes(*args, got, gates), 2.0 * t * s * r * h * 3 * h,
                         product_rate=F32_BF16_FLOP_PER_S if bf16 else PRODUCT_FLOP_PER_S))


# The rows of K1's and K2's bfloat16 calls beside the train step's (B = 8):
# entry_mphoi's predict batch of 128 clips and a streamed window's single
# clip, each with the stage-1 objects as rows.
GRU_BATCHES = (128, 1)
# A plan the source does not take, whose occupancy k1_bf16 prints beside
# the taken one's: 8 blocks of 64 units, 192 KB of weights in shared memory
# and 32 KB for the state's slices and a chunk of the state read from peers.
GRU_ALT_PLAN = dict(cluster=8, units=64, smem=(192 + 32) * 1024)


def chunked_gaps(got, want, chunk=16):
    """[(max abs error, largest |want|)] of each output pair, in float32 over
    chunks of the leading (time) axis: the predict batch's outputs are
    gigabytes, too many for float64 copies."""
    gaps = []
    for g, w in zip(got, want):
        err = top = 0.0
        for i in range(0, g.shape[0], chunk):
            gc, wc = g[i:i + chunk].float(), w[i:i + chunk].float()
            if not bool(gc.isfinite().all()):
                raise AssertionError("a kernel output is not finite")
            err = max(err, float((gc - wc).abs().max()))
            top = max(top, float(wc.abs().max()))
        gaps.append((err, top))
    return gaps


def gru_cluster_report(torch, dev, kind, tag, shape, split, repeated):
    """The bfloat16 route of K1 (kind 'fwd') or K2 ('bwd'): the plan at the
    MPHOI shape, the launches of a call (split: device_ms_by_kernel of one
    call there), whether a repeated call gave the same bits, and each
    GRU_BATCHES call against its plain version (K1 within one bfloat16 ulp
    of each output's largest value, K2 within GRU_GRAD_RTOL_BF16 of it, as
    at the MPHOI shape), timed. Raises if a check fails, a call launched
    more than one kernel of the GRU or differed on a repeat."""
    from tggcn_torch.ops.gru_sequence import (gru_clusters, gru_plan, gru_sequence,
                                              gru_sequence_bwd, gru_sequence_bwd_plain,
                                              gru_sequence_plain)
    from tggcn_torch.profile_gru import gru_bwd_inputs, gru_inputs

    t, s, r, h = shape
    nr = s // 2
    plan = gru_plan(kind, s, r, h)
    launches = sum(v["launches"] for k, v in split.items() if k.startswith("gru_"))
    out = dict(plan=plan, launches_a_call=launches, repeat_bitwise=repeated)
    if kind == "fwd":
        out["alt_plan"] = dict(GRU_ALT_PLAN, co_resident=gru_clusters(GRU_ALT_PLAN["cluster"],
                                                                      GRU_ALT_PLAN["smem"]))
    rows_per_clip = r // stage_module("stage1").SHAPE["b"]
    for b in GRU_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(b)
        fwd = tuple(x.to(torch.bfloat16) for x in gru_inputs(dev, gen, t, s, b * rows_per_clip, h))
        if kind == "fwd":
            gaps = chunked_gaps(gru_sequence(*fwd, nr, keep=True),
                                gru_sequence_plain(*fwd, nr, keep=True))
            bad = [(e, top) for e, top in gaps if not e <= bf16_ulp(top)]
            ms = cuda_ms(torch, lambda: gru_sequence(*fwd, nr, keep=True), 3, spin=True)
        else:
            args = gru_bwd_inputs(*fwd, nr, gen)
            gaps = chunked_gaps(gru_sequence_bwd(*args, nr), gru_sequence_bwd_plain(*args, nr))
            bad = [(e, top) for e, top in gaps if not e <= GRU_GRAD_RTOL_BF16 * (top or 1.0)]
            ms = cuda_ms(torch, lambda: gru_sequence_bwd(*args, nr), 3, spin=True)
        print(f"{tag} B={b}: kernel vs plain (max abs err, largest value) of each output "
              f"{[(f'{e:.3e}', f'{top:.3e}') for e, top in gaps]}", flush=True)
        if bad:
            raise AssertionError(f"{tag} B={b}: kernel and plain version differ beyond the "
                                 f"limit: {bad}")
        out[f"max_abs_err_b{b}"] = max(e for e, _ in gaps)
        out[f"ms_b{b}"] = ms
        out[f"plan_b{b}"] = gru_plan(kind, s, b * rows_per_clip, h)
    print(f"{tag} cluster route: {json.dumps(out)}", flush=True)
    if launches != 1 or not repeated:
        raise AssertionError(f"{tag}: {launches} GRU launches a call (want 1), repeat bitwise "
                             f"{repeated}")
    return out


def check_grads(name, got, want, limit=KERNEL_GRAD_RTOL):
    """(max abs error, max error relative to each output's largest value)."""
    err = rel = 0.0
    for g, w in zip(got, want):
        e = max_err(g, w)
        err, rel = max(err, e), max(rel, e / (float(w.abs().max()) or 1.0))
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{name}: the output is not finite")
    if not rel <= limit:
        raise AssertionError(f"{name} and the plain version differ by {rel:.3e} of the "
                             f"largest gradient (limit {limit})")
    return err, rel


def run_k2(torch, dev, shape, dtype=None):
    """K2 (or its bfloat16 variant) against its plain version, timed, with
    cuDNN's GRU forward and backward in the same dtype."""
    import tggcn_torch.ops.gru_sequence as gru_ops
    from tggcn_torch.ops.gru_sequence import gru_sequence_bwd, gru_sequence_bwd_plain
    from tggcn_torch.profile_gru import (cudnn_grus, cudnn_inputs, cudnn_sequence,
                                         gru_bwd_inputs, gru_inputs)
    from tggcn_torch.profile_scan import device_ms_by_kernel

    bf16 = dtype == torch.bfloat16
    tag = "k2_bf16" if bf16 else "k2"
    limit = GRU_GRAD_RTOL_BF16 if bf16 else KERNEL_GRAD_RTOL
    t, s, r, h = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    fwd = gru_inputs(dev, gen, t, s, r, h)
    if bf16:
        fwd = tuple(x.to(dtype) for x in fwd)
    nr = s // 2
    args = gru_bwd_inputs(*fwd, nr, gen)
    got = gru_sequence_bwd(*args, nr)
    want = gru_sequence_bwd_plain(*args, nr)
    err, rel = check_grads(f"gru_sequence_bwd{'_bf16' if bf16 else ''}", got, want, limit)
    controls = {}
    if bf16:
        controls = check_controls("gru_sequence_bwd_bf16", tensor_gaps,
                                  lambda: gru_ops.gru_sequence_bwd_plain(*args, nr), got, want,
                                  LIMITS_BF16["k2"])
    ms = cuda_ms(torch, lambda: gru_sequence_bwd(*args, nr), 5, spin=True)
    plain_ms = cuda_ms(torch, lambda: gru_sequence_bwd_plain(*args, nr), 3)
    split = device_ms_by_kernel(lambda: gru_sequence_bwd(*args, nr), 1)
    print_split(tag, split)
    cluster = {}
    if bf16:
        again = gru_sequence_bwd(*args, nr)
        cluster = gru_cluster_report(torch, dev, "bwd", tag, shape, split,
                                     all(torch.equal(a, b) for a, b in zip(again, got)))

    # The library's forward and backward: the cuDNN GRUs' gradients with
    # respect to their inputs (gi, through identity input weights) and
    # initial states, against the plain version's dgi and dh0.
    grus = cudnn_grus(*fwd[1:3])
    xs, h0s = cudnn_inputs(fwd[0], fwd[3], nr)
    leaves = [x.requires_grad_(True) for x in xs + h0s]
    gys = [args[2][:, i] if i < s - nr else args[2][:, i].flip(0) for i in range(s)]

    def library():
        with torch.enable_grad():
            return torch.autograd.grad(cudnn_sequence(grus, xs, h0s), leaves, gys)

    grads = library()
    dgi = torch.stack([d if i < s - nr else d.flip(0) for i, d in enumerate(grads[:s])], dim=1)
    _, lib_rel = check_grads("the cuDNN GRU's backward", [dgi, torch.cat(grads[s:])],
                             [want[0], want[2]],
                             LIBRARY_BF16_GRAD_RTOL if bf16 else KERNEL_GRAD_RTOL)
    library_ms = cuda_ms(torch, library, 5, spin=True)
    print(f"{tag} library: the cuDNN GRU's forward and backward in {s} calls {library_ms:.3f} "
          f"ms, max err vs plain {lib_rel:.3e} of the largest gradient", flush=True)
    byte_count = nbytes(*args, *got)
    rate = F32_BF16_FLOP_PER_S if bf16 else PRODUCT_FLOP_PER_S
    new = bounds(byte_count, 2.0 * t * s * r * h * 3 * h, product_rate=rate)
    # The design before K1 kept its gates: gh recomputed, two products a step.
    old = bounds(byte_count - nbytes(args[3]) + nbytes(fwd[2]), 4.0 * t * s * r * h * 3 * h,
                 product_rate=rate)
    print(f"{tag} bound {new['bound_ms']:.3f} ms ({new['bound_by']}; one product a step as "
          f"{'three BF16 products' if bf16 else '3xTF32'}, {new['bound_fma_ms']:.3f} ms on the "
          f"FMA units); with gh recomputed as before K1 kept its gates: {old['bound_ms']:.3f} "
          f"ms ({old['bound_by']}; {old['bound_fma_ms']:.3f} ms on the FMA units)", flush=True)
    return dict(name="gru_sequence_bwd_bf16" if bf16 else "gru_sequence_bwd", route="cuda",
                source="tggcn_torch/csrc/gru_sequence_bwd.cu",
                replaces="tggcn/ops/gru_pallas.py:167", max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, **controls, **cluster, **new)


def k3_flops(t, b, nh, no, h):
    """(FLOPs of the products: the four projections and the cells, depth
    2h + h; FLOPs of the scores and mixing) over both directions."""
    e = nh + no
    products = 2 * ((2 * b * nh + 2 * b * no) * h * h + b * e * 3 * h * 3 * h)
    return 2.0 * t * products, 2.0 * t * 2 * 2 * b * e * e * h


def print_split(name, split):
    """The per-phase line of a kernel: device ms per call by kernel name."""
    print(f"{name} device ms by kernel: " + ", ".join(
        f"{k} {v['ms']:.3f} ({v['launches']:g} launches)" for k, v in split.items()), flush=True)


# K3's bfloat16 product kernels on wgmma fed by TMA (csrc/wg_gemm.cuh).
WG_KERNELS = ("proj_wg", "cell_wg")
GRU_CLUSTER_KERNELS = ("gru_cluster_kernel", "gru_bwd_cluster")
# K4's bfloat16 kernels at h <= 512: DA (a cluster launch a step) and R.
K4_BF16_KERNELS = ("segb_dmsgs_att", "segb_carry_ds")
# The batches of K4's bfloat16 calls beside the train step's (B = 8): a
# data-parallel process's 4 clips and a streamed window's single clip, each
# against its plain version at LIMITS_BF16["k4"] and SCAN_GRAD_RTOL_BF16.
K4_BATCHES = (4, 1)
# K4's launches a call are counted by kernel name over this many calls and
# rounded: a profiler window in this run can miss the first kernels of its
# first call (one of each of K4's first three, on the H100), which moves a
# count a call by less than a half.
K4_COUNT_CALLS = 10


def k3_l2_bytes(b, nh, no, h):
    """The bytes K3's bfloat16 product phases (wg_gemm.cuh) copy from L2 a
    step, as TMA boxes: a proj_wg block (32 of h columns of one (edge,
    direction), up to 32 rows of the edge's sender) copies two 16-column
    weight pieces and its rows, h deep; a cell_wg block (16 units of a
    (cell, direction), up to 32 rows) three pieces and its rows, 3h deep;
    all bfloat16, 64 deep a stage. A row box is 16 rows, or 32 where the
    group has more than 16 rows."""
    out = dict(proj_wg=0, cell_wg=0)
    stages = dict(proj_wg=-(-h // 64), cell_wg=-(-2 * h // 64) + -(-h // 64))
    for kernel, pieces, width, groups in (("proj_wg", 2, 32, (nh, nh, no, no)),
                                          ("cell_wg", 3, 16, (nh, no))):
        for rows in (b * g for g in groups):
            box = 32 if rows > 16 else 16
            for row0 in range(0, rows, 32):
                boxes = -(-min(32, rows - row0) // box)
                stage = (pieces * 16 + boxes * box) * 64 * 2
                out[kernel] += 2 * -(-h // width) * stages[kernel] * stage
    return out


def k4_l2_bytes(b, nh, no, h):
    """The bytes K4's bfloat16 product phases (tc_gemm.cuh) copy from L2 a
    step, on the route of the shape (bwd_plan's rule: h <= 512 the
    two-launch route). A DA block (32 of a sender group's h columns of both
    cells, the rows of a batch tile of 32 // max(H, O) clips) copies, for
    each cell, its columns of w_msg and the tile's rows of dgi, 3h deep; a
    per-step dmsgs block (32 of 2h columns, up to 32 rows of a cell) its
    columns and rows, 3h deep; a carry block (16 units, up to 32 rows) its
    units' rows of w_hh and of the two w_from edges its cell sends, and its
    rows of dgh and dpre, 5h deep; all bfloat16 (cp.async reads nothing
    for the rows a block lacks)."""
    carry = 0
    for rows in (b * nh, b * no):
        for row0 in range(0, rows, 32):
            carry += 2 * -(-h // 16) * (16 + min(32, rows - row0)) * 5 * h * 2
    if h <= 512 and h % 8 == 0 and nh + no <= 16:
        nb, da = 32 // max(nh, no), 0
        for b0 in range(0, b, nb):
            tile = min(nb, b - b0)
            da += 2 * 2 * -(-h // 32) * (64 + tile * (nh + no)) * 3 * h * 2
        return dict(segb_dmsgs_att=da, segb_carry_ds=carry)
    dmsgs = 0
    for rows in (b * nh, b * no):
        for row0 in range(0, rows, 32):
            dmsgs += 2 * -(-2 * h // 32) * (32 + min(32, rows - row0)) * 3 * h * 2
    return dict(segb_dmsgs=dmsgs, segb_carry=carry)


def print_l2_rates(name, split, shape):
    """Beside the bfloat16 product phases' device ms: the bytes each phase
    copies from L2 a step, computed from the shapes (k3_l2_bytes,
    k4_l2_bytes), and the rate it reached."""
    t, b, nh, no, h = shape
    l2 = {**k3_l2_bytes(b, nh, no, h), **k4_l2_bytes(b, nh, no, h)}
    rows = [f"{k} {l2[k] / 1e6:.3f} MB a step, "
            f"{l2[k] * v['launches'] / (v['ms'] * 1e-3) / 1e12:.3f} TB/s"
            for k, v in split.items() if k in l2 and v["ms"] > 0]
    print(f"{name} L2 bytes a step and rate: " + "; ".join(rows), flush=True)


def ptxas_report(log, names):
    """{kernel: 'R registers, S bytes smem, X bytes spill stores, Y bytes
    spill loads'} of the kernels of a -Xptxas -v log whose mangled names
    hold one of names."""
    out, current = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if found:
            current = next((n for n in names if n in found.group(1)), None)
        elif current and "spill" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out.setdefault(current, {}).update(spill_stores=int(stores), spill_loads=int(loads))
        elif current and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(current, {}).update(registers=int(regs.group(1)),
                                               static_smem=int(smem.group(1)) if smem else 0)
    return out


def run_k3(torch, dev, shape, dtype=None):
    """K3 (or its bfloat16 variant) against its plain version, timed."""
    import tggcn_torch.ops.segment_scan as scan_ops
    from tggcn_torch.ops.segment_scan import segment_scan_dot, segment_scan_dot_plain
    from tggcn_torch.profile_scan import device_ms_by_kernel, scan_inputs

    bf16 = dtype == torch.bfloat16
    t, b, nh, no, h = shape
    args = scan_inputs(dev, torch.Generator(device=dev).manual_seed(2), t, b, nh, no, h)
    if bf16:
        args = {k: v.to(dtype) for k, v in args.items()}
    scale = 1.0 / math.sqrt(h)
    got = segment_scan_dot(**args, scale=scale)
    want = segment_scan_dot_plain(**args, scale=scale)
    served = segment_scan_dot(**args, scale=scale, keep=False)
    controls = {}
    if bf16:
        err, ulps = check_kernel_bf16(torch, "segment_scan_dot_bf16", list(got) + list(served),
                                      list(want) + list(want[:3]))
        controls = check_controls("segment_scan_dot_bf16", tensor_gaps,
                                  lambda: scan_ops.segment_scan_dot_plain(**args, scale=scale),
                                  got, want, LIMITS_BF16["k3"])
    else:
        err = check_kernel("segment_scan_dot", got, want)
        err = max(err, check_kernel("segment_scan_dot (serving)", served, want[:3]))
    ms = cuda_ms(torch, lambda: segment_scan_dot(**args, scale=scale), 5, spin=True)
    plain_ms = cuda_ms(torch, lambda: segment_scan_dot_plain(**args, scale=scale), 3)
    split = device_ms_by_kernel(lambda: segment_scan_dot(**args, scale=scale), 1)
    print_split("k3_bf16" if bf16 else "k3", split)
    if bf16:
        print_l2_rates("k3_bf16", split, shape)
        occ = scan_ops.scan_occupancy("dot", dtype, b, nh, no, h)
        print(f"k3_bf16 blocks, blocks an SM, dynamic smem: {json.dumps(occ)}", flush=True)
    return dict(name="segment_scan_dot_bf16" if bf16 else "segment_scan_dot", route="cuda",
                source="tggcn_torch/csrc/segment_scan.cu",
                replaces="tggcn/ops/segment_scan_pallas.py:268", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=None, **controls,
                **bounds(nbytes(*args.values(), *got), *k3_flops(t, b, nh, no, h),
                         product_rate=BF16_FLOP_PER_S if bf16 else PRODUCT_FLOP_PER_S))


def k4_flops(t, b, nh, no, h):
    """K4 reads the gates, attention and messages K3 kept: (FLOPs of the
    products of phases D, dmsgs = dgi @ w_msg^T, and R, the dgh and dpre
    products; FLOPs of the attention backward) over both directions."""
    e = nh + no
    products = 2 * (b * e * 3 * h * 2 * h + b * e * 5 * h * h)
    return 2.0 * t * products, 2.0 * t * 2 * 4 * b * e * e * h


def k4_flops_recompute(t, b, nh, no, h):
    """The work of the design before K3 kept its gates and attention: the
    gate products and the scores and mixing recomputed each step."""
    e = nh + no
    products, other = k4_flops(t, b, nh, no, h)
    return (products + 2.0 * t * 2 * b * e * 3 * h * 3 * h,
            other + 2.0 * t * 2 * 2 * b * e * e * h)


def run_k4(torch, dev, shape, dtype=None):
    """K4 (or its bfloat16 variant) against its plain version, timed."""
    import tggcn_torch.ops.segment_scan as scan_ops
    from tggcn_torch.ops.segment_scan import (BWD_OUTPUTS, segment_scan_dot_bwd,
                                              segment_scan_dot_bwd_plain)
    from tggcn_torch.profile_scan import bwd_inputs, device_ms_by_kernel, scan_inputs

    bf16 = dtype == torch.bfloat16
    tag = "k4_bf16" if bf16 else "k4"
    t, b, nh, no, h = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 1.0 / math.sqrt(h)
    fwd = scan_inputs(dev, gen, t, b, nh, no, h)
    if bf16:
        fwd = {k: v.to(dtype) for k, v in fwd.items()}
    args = bwd_inputs(fwd, gen, scale)
    got = segment_scan_dot_bwd(**args, scale=scale)
    want = segment_scan_dot_bwd_plain(**args, scale=scale)
    err, rel = check_grads(f"segment_scan_dot_bwd{'_bf16' if bf16 else ''}",
                           [got[k] for k in BWD_OUTPUTS], [want[k] for k in BWD_OUTPUTS],
                           SCAN_GRAD_RTOL_BF16 if bf16 else KERNEL_GRAD_RTOL)
    controls = {}
    if bf16:
        controls = check_controls(
            "segment_scan_dot_bwd_bf16", tensor_gaps,
            lambda: [scan_ops.segment_scan_dot_bwd_plain(**args, scale=scale)[k]
                     for k in BWD_OUTPUTS],
            [got[k] for k in BWD_OUTPUTS], [want[k] for k in BWD_OUTPUTS], LIMITS_BF16["k4"])
    ms = cuda_ms(torch, lambda: segment_scan_dot_bwd(**args, scale=scale), 5, spin=True)
    plain_ms = cuda_ms(torch, lambda: segment_scan_dot_bwd_plain(**args, scale=scale), 2)
    split = device_ms_by_kernel(lambda: segment_scan_dot_bwd(**args, scale=scale), 1)
    print_split(tag, split)
    route = {}
    if bf16:
        print_l2_rates(tag, split, shape)
        route = k4_route_report(torch, dev, tag, shape, args, got)
    byte_count = nbytes(*args.values(), *got.values())
    rate = BF16_FLOP_PER_S if bf16 else PRODUCT_FLOP_PER_S
    new = bounds(byte_count, *k4_flops(t, b, nh, no, h), product_rate=rate)
    old = bounds(byte_count, *k4_flops_recompute(t, b, nh, no, h), product_rate=rate)
    print(f"{tag} bound {new['bound_ms']:.3f} ms ({new['bound_by']}; products as "
          f"{'bfloat16' if bf16 else '3xTF32'}, {new['bound_fma_ms']:.3f} ms on the FMA units); "
          f"with the gates, scores and mixing recomputed as before K3 kept them: "
          f"{old['bound_ms']:.3f} ms ({old['bound_by']}; {old['bound_fma_ms']:.3f} ms on the "
          f"FMA units)", flush=True)
    return dict(name="segment_scan_dot_bwd_bf16" if bf16 else "segment_scan_dot_bwd",
                route="cuda", source="tggcn_torch/csrc/segment_scan_bwd.cu",
                replaces="tggcn/ops/segment_scan_pallas.py:546", max_abs_err=err,
                max_rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=None, **controls, **route,
                **new)


def k4_route_report(torch, dev, tag, shape, args, got):
    """K4's bfloat16 route at the MPHOI shape: the plan (bwd_plan), the
    launches of a call (by kernel name, K4_COUNT_CALLS calls), whether a
    repeated call and the per-step route (route='steps') gave the same bits
    as got, and each K4_BATCHES call against its plain version, at the
    limits of the MPHOI check (max_share SCAN_GRAD_RTOL_BF16, rel_l2
    LIMITS_BF16['k4']), timed. Raises if a check fails, or if the call made
    other than 2T + 2 launches with no segb_att."""
    from tggcn_torch.ops.segment_scan import (BWD_OUTPUTS, bwd_plan, segment_scan_dot_bwd,
                                              segment_scan_dot_bwd_plain)
    from tggcn_torch.profile_scan import bwd_inputs, device_ms_by_kernel, scan_inputs

    t, b, nh, no, h = shape
    scale = 1.0 / math.sqrt(h)
    calls = device_ms_by_kernel(lambda: segment_scan_dot_bwd(**args, scale=scale),
                                K4_COUNT_CALLS)
    launches = {k: round(v["launches"]) for k, v in calls.items()
                if k.startswith("segb_") or k == "du_sum"}
    again = segment_scan_dot_bwd(**args, scale=scale)
    steps = segment_scan_dot_bwd(**args, scale=scale, route="steps")
    out = dict(plan=bwd_plan(b, nh, no, h), launches_a_call=sum(launches.values()),
               launches_by_kernel=launches,
               repeat_bitwise=all(torch.equal(again[k], got[k]) for k in BWD_OUTPUTS),
               steps_route_bitwise=all(torch.equal(steps[k], got[k]) for k in BWD_OUTPUTS))
    del again, steps
    for nb in K4_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(50 + nb)
        fwd = {k: v.to(torch.bfloat16)
               for k, v in scan_inputs(dev, gen, t, nb, nh, no, h).items()}
        small = bwd_inputs(fwd, gen, scale)
        mine = segment_scan_dot_bwd(**small, scale=scale)
        want = segment_scan_dot_bwd_plain(**small, scale=scale)
        gaps = tensor_gaps([mine[k] for k in BWD_OUTPUTS], [want[k] for k in BWD_OUTPUTS])
        print(f"{tag} B={nb}: kernel vs plain " + ", ".join(f"{k} {v:.4g}"
                                                         for k, v in gaps.items()), flush=True)
        if not (gaps["max_share"] <= SCAN_GRAD_RTOL_BF16
                and gaps["rel_l2"] <= LIMITS_BF16["k4"]["rel_l2"]):
            raise AssertionError(f"{tag} B={nb}: kernel and plain version differ beyond the "
                                 f"limits: {gaps}")
        out[f"max_share_b{nb}"], out[f"rel_l2_b{nb}"] = gaps["max_share"], gaps["rel_l2"]
        out[f"ms_b{nb}"] = cuda_ms(torch, lambda: segment_scan_dot_bwd(**small, scale=scale), 3,
                                   spin=True)
        out[f"plan_b{nb}"] = bwd_plan(nb, nh, no, h)
    print(f"{tag} route: {json.dumps(out)}", flush=True)
    want_launches = {"segb_cell": 1, "segb_dmsgs_att": t, "segb_carry_ds": t, "du_sum": 1}
    if (launches != want_launches or not out["repeat_bitwise"]
            or not out["steps_route_bitwise"]):
        raise AssertionError(f"{tag}: launches {launches} (want {want_launches}), repeat "
                             f"bitwise {out['repeat_bitwise']}, the per-step route's bits "
                             f"{out['steps_route_bitwise']}")
    return out


def k5_flops(mode, t, b, nh, no, h):
    """K3's products and mixing, with the scores of the mode: v1 four dot
    products per entity, v4 the bilinear products of each receiver's two
    edges (a product of the projection phase) and the scores, ext none."""
    e = nh + no
    products = 2 * ((2 * b * nh + 2 * b * no) * h * h + b * e * 3 * h * 3 * h
                    + (2 * b * e * h * h if mode == "v4" else 0))
    scores = {"v1": 4 * b * e * h, "v4": b * e * e * h, "ext": 0}[mode]
    return 2.0 * t * products, 2.0 * t * 2 * (b * e * e * h + scores)


def run_k5(mode, torch, dev, shape, dtype=None):
    """K5 in `mode` (or, with dtype bfloat16, its bfloat16 variant) against
    its plain version, timed."""
    from tggcn_torch.ops import segment_scan as ops
    from tggcn_torch.profile_scan import device_ms_by_kernel, mode_inputs, scan_inputs

    bf16 = dtype == torch.bfloat16
    t, b, nh, no, h = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    args = scan_inputs(dev, gen, t, b, nh, no, h)
    extra = mode_inputs(mode, args, gen)
    if bf16:
        args = {k: v.to(dtype) for k, v in args.items()}
        extra = {k: v.to(dtype) for k, v in extra.items()}
    wrapper = getattr(ops, f"segment_scan_{mode}")
    name = wrapper.__name__ + ("_bf16" if bf16 else "")
    got = wrapper(**args, **extra)
    want = ops.segment_scan_att_plain(mode, **args, **extra)
    controls = {}
    if bf16:
        err, _ = check_kernel_bf16(torch, name, got, want)
        controls = check_controls(name, tensor_gaps,
                                  lambda: ops.segment_scan_att_plain(mode, **args, **extra),
                                  got, want, LIMITS_BF16[f"k5_{mode}"])
    else:
        err = check_kernel(wrapper.__name__, got, want)
    ms = cuda_ms(torch, lambda: wrapper(**args, **extra), 5, spin=True)
    plain_ms = cuda_ms(torch, lambda: ops.segment_scan_att_plain(mode, **args, **extra), 2)
    tag = f"k5_{mode}{'_bf16' if bf16 else ''}"
    print_split(tag, device_ms_by_kernel(lambda: wrapper(**args, **extra), 1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{tag} phases: " + ", ".join(
        f"{phase} {blocks} blocks, {per_sm} an SM ({math.ceil(blocks / (per_sm * sms))} wave(s) "
        f"on {sms} SMs), {smem} B dynamic shared memory"
        for phase, (blocks, per_sm, smem) in ops.scan_occupancy(
            mode, args["gi_h"].dtype, b, nh, no, h).items()), flush=True)
    # In bfloat16 the products (projections, cells and v4's recv @ W) are
    # bfloat16 x bfloat16; v4's second score product takes a float32 state
    # and runs, with the other scores and the mixing, at the FMA rate.
    return dict(name=name, route="cuda", source="tggcn_torch/csrc/segment_scan.cu",
                replaces="tggcn/ops/segment_scan_pallas.py:268", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=None, **controls,
                **bounds(nbytes(*args.values(), *extra.values(), *got),
                         *k5_flops(mode, t, b, nh, no, h),
                         product_rate=BF16_FLOP_PER_S if bf16 else PRODUCT_FLOP_PER_S))


def run_k6(torch, dev, shape):
    from tggcn_torch.ops.geo_gcn import geo_gcn_config, geo_gcn_fused, geo_gcn_plain

    n, v = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [(4, 64), (64,), (64, 64), (64,), (64, 128), (128,), (64, 128), (128,), (64, 128)]
    weights = [((torch.rand(sh, generator=gen, device=dev) * 2 - 1) * sh[0] ** -0.5).contiguous()
               for sh in shapes]
    x = torch.randn((n, v, 4), generator=gen, device=dev)
    got = geo_gcn_fused(x, *weights)
    plain = geo_gcn_plain(x, *weights)
    err = check_kernel("geo_gcn_fused", [got], [plain])
    # A control with float64 sums: how far the kernel and the float32 plain
    # version (cuBLAS) each lie from it.
    exact = geo_gcn_plain(x.double(), *(w.double() for w in weights))
    config = geo_gcn_config(n)
    print(f"k6: kernel vs float64 max abs err {max_err(got, exact):.3e}, plain float32 vs "
          f"float64 {max_err(plain, exact):.3e} (limit {KERNEL_ATOL} against the plain "
          f"version); {config['frames_per_block']} frames a block at a time, grid "
          f"{config['blocks']} blocks of {config['threads']} threads, {config['blocks_per_sm']} "
          f"an SM, {config['smem_bytes']} B dynamic shared memory", flush=True)
    ms = cuda_ms(torch, lambda: geo_gcn_fused(x, *weights), 5, spin=True)
    plain_ms = cuda_ms(torch, lambda: geo_gcn_plain(x, *weights), 5)
    flops = 2.0 * n * v * (4 * 64 + 64 * 64 + 2 * 64 * 128 + v * 128 + v * 64 + 64 * 128)
    return dict(name="geo_gcn_fused", route="cuda", source="tggcn_torch/csrc/geo_gcn.cu",
                replaces="tggcn/ops/geo_gcn_pallas.py:100", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=None, **bounds(nbytes(x, *weights, got), flops))


def flip_margins(torch, soft_g, soft_w, flips, threshold=0.5, filtered=False):
    """How far each flipped hard decision (flips, a bool mask) lay from
    turning out the same in both runs, from the soft decisions of both.
    Unfiltered, a decision compares its soft value with the threshold: the
    margin is that distance. Filtered (filter_discrete_updates), it also
    compares it with each neighbour's along time (zero outside the clip):
    the margin is the largest distance over the comparisons whose outcome
    differs between the runs, each distance the larger of the two runs';
    infinite where no comparison's outcome differs."""
    def comparisons(soft):
        zeros = torch.zeros_like(soft[:, :1])
        sides = [torch.full_like(soft, threshold)]
        if filtered:
            sides += [torch.cat([zeros, soft[:, :-1]], 1), torch.cat([soft[:, 1:], zeros], 1)]
        return [(soft >= side if i == 0 and filtered else soft > side, (soft - side).abs())
                for i, side in enumerate(sides)]

    margin, explained = torch.zeros_like(soft_g), torch.zeros_like(flips)
    for (c_g, d_g), (c_w, d_w) in zip(comparisons(soft_g), comparisons(soft_w)):
        margin = torch.where(c_g != c_w, torch.maximum(margin, torch.maximum(d_g, d_w)), margin)
        explained |= c_g != c_w
    # A flip no comparison explains has no margin.
    return torch.where(explained, margin, math.inf)[flips]


def decision_rows(torch, aux_g, aux_w, what, marginal=MARGINAL, threshold=0.5, filtered=False):
    """Batch rows whose hard decisions (humans' and objects') agree in both
    runs (a bool mask), the number of marginal flips and the number of rows
    left out (at most one); any flip with a margin (flip_margins) of
    marginal or more fails."""
    rows, flipped = None, 0
    for key in ("human_decisions", "object_decisions"):
        if key not in aux_g:
            continue
        hard_g, soft_g = (x.detach().cpu() for x in aux_g[key])
        hard_w, soft_w = (x.detach().cpu() for x in aux_w[key])
        flips = hard_g != hard_w
        if flips.any():
            margin = flip_margins(torch, soft_g, soft_w, flips, threshold, filtered)
            if float(margin.max()) >= marginal:
                raise AssertionError(f"{what}: {key.split('_')[0]} decisions differ away from "
                                     f"the threshold and their neighbours "
                                     f"(margin {float(margin.max()):.3e})")
        agree = ~flips.flatten(1).any(dim=1)
        rows = agree if rows is None else rows & agree
        flipped += int(flips.sum())
    dropped = int((~rows).sum())
    if dropped > 1:
        raise AssertionError(f"{what}: {dropped} batch rows have flipped decisions")
    return rows, flipped, dropped


@contextlib.contextmanager
def relu_inputs(sides=None):
    """While open, the input of every ReLU of the model's MLPs
    (tggcn_torch.nn.mlp.apply_mlp), in call order: yields the list. With
    sides (kink_sides), the ReLU of each call that has an entry passes its
    input where the entry's mask says which side of the kink to take, and
    where x > 0 elsewhere: x times that 0/1 mask, whose derivative is the
    mask."""
    from tggcn_torch.nn import mlp

    pick, seen = mlp.pick_activation, []

    def picking(activation):
        fn = pick(activation)
        if activation != "relu":
            return fn

        def relu(x):
            forced = sides[len(seen)] if sides else None
            seen.append(x.detach())
            if forced is None:
                return fn(x)
            flips, side = forced
            return x * side.where(flips, x > 0).to(x.dtype)
        return relu

    mlp.pick_activation = picking
    try:
        yield seen
    finally:
        mlp.pick_activation = pick


@contextlib.contextmanager
def scan_messages():
    """While open, the edge messages K3 keeps for K4 (m_h, m_o: each step's
    messages after their ReLU) of every call that keeps them, in call
    order: yields the list. The wrapper's launch counters carry over."""
    from tggcn_torch.ops import segment_scan

    run, seen = segment_scan.segment_scan_dot, []

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        if kwargs.get("keep"):
            seen.append(out[3:5])
        return out

    recording.launches, recording.launches_bf16 = run.launches, run.launches_bf16
    segment_scan.segment_scan_dot = recording
    try:
        yield seen
    finally:
        segment_scan.segment_scan_dot = run
        run.launches, run.launches_bf16 = recording.launches, recording.launches_bf16


def scan_kinks(torch, got, want, what, marginal=KINK_MARGIN, most=KINK_FLIPS):
    """The ReLU kinks inside K3 that two runs' kept messages (scan_messages)
    put on different sides of 0, zero in one and not in the other: a flip
    where either message lies marginal or further from 0 fails, and so do
    more than most; returns their count. K3 cannot be made to take a side."""
    flipped = 0
    for x, y in zip(got, want):
        flips = (x > 0) != (y > 0)
        if bool(flips.any()):
            margin = float(torch.maximum(x.abs(), y.abs())[flips].max())
            if margin >= marginal:
                raise AssertionError(f"{what}: a segment message of K3 flips {margin:.3e} from "
                                     f"its kink")
            flipped += int(flips.sum())
    if flipped > most:
        raise AssertionError(f"{what}: {flipped} segment messages of K3 flip at their kink "
                             f"(at most {most})")
    return flipped


def kink_sides(torch, got, want, what, marginal=KINK_MARGIN, most=KINK_FLIPS):
    """The ReLU kinks that the inputs of two runs (relu_inputs: the kernel
    route's got, the plain route's want) put on different sides of 0: a
    list by call of None or (the mask of such inputs, want's side there,
    x > 0), and their count. A ReLU is a hard decision at 0, and a float32
    input within rounding of it may fall either way, as a marginal
    decision does; a flip where either run's input lies marginal or
    further from 0 fails, and so do more than most flips."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} against {len(want)} ReLU calls")
    sides, flipped = [], 0
    for x, y in zip(got, want):
        flips = (x > 0) != (y > 0)
        if not bool(flips.any()):
            sides.append(None)
            continue
        margin = float(torch.maximum(x.abs(), y.abs())[flips].max())
        if margin >= marginal:
            raise AssertionError(f"{what}: a ReLU input of shape {tuple(x.shape)} flips "
                                 f"{margin:.3e} from its kink")
        sides.append((flips, y > 0))
        flipped += int(flips.sum())
    if flipped > most:
        raise AssertionError(f"{what}: {flipped} ReLU inputs flip at their kink (at most {most})")
    return sides, flipped


def decision_rule(cfg):
    """The keywords of decision_rows for a model configuration: its
    threshold and whether its decisions are filtered."""
    return dict(threshold=cfg.update_segment_threshold, filtered=cfg.filter_discrete_updates)


def forward_gaps(torch, got, want, rule=None):
    """tensor_gaps of the outputs of requests got against want, with
    max_abs, the largest absolute difference, over the batch rows whose
    decisions agree (as compare_forward in bfloat16, by the decision rule
    rule); every measure inf if a decision flipped with a margin."""
    pairs = []
    for (out_g, aux_g), (out_w, aux_w) in zip(got, want):
        try:
            rows, _, _ = decision_rows(torch, aux_g, aux_w, "control", MARGINAL_BF16,
                                       **(rule or {}))
        except AssertionError:
            return dict(max_abs=math.inf, max_share=math.inf, ulps=math.inf, rel_l2=math.inf)
        pairs += [(g.cpu()[rows], w.cpu()[rows]) for g, w in zip(out_g, out_w)]
    return dict(max_abs=max(max_err(g, w) for g, w in pairs),
                **tensor_gaps(*zip(*pairs)))


def compare_forward(torch, got, want, what, bf16=False, rule=None, atol_bf16=FORWARD_ATOL_BF16):
    """Max abs difference of two (outputs, aux) results of one request, the
    number of marginal decision flips and the number of batch rows left out
    of the comparison for them (at most one; decision_rows with the
    decision rule rule, decision_rule). Float32 outputs agree within rtol
    FORWARD_RTOL, atol FORWARD_ATOL; with bf16 (the bfloat16 compute dtype)
    within atol_bf16 (None: held by another measure, LIMITS_CAD120_BF16),
    and a flip is marginal within MARGINAL_BF16."""
    (out_g, aux_g), (out_w, aux_w) = got, want
    rows, flips, dropped = decision_rows(torch, aux_g, aux_w, what,
                                         MARGINAL_BF16 if bf16 else MARGINAL, **(rule or {}))
    err = 0.0
    for i, (g, w) in enumerate(zip(out_g, out_w)):
        g, w = g.cpu()[rows], w.cpu()[rows]
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: output {i} is not finite")
        if bf16:
            close = g.shape == w.shape and (atol_bf16 is None or max_err(g, w) <= atol_bf16)
        else:
            close = g.shape == w.shape and torch.allclose(g, w, rtol=FORWARD_RTOL,
                                                          atol=FORWARD_ATOL)
        if not close:
            raise AssertionError(f"{what}: output {i} differs by {max_err(g, w):.3e}")
        err = max(err, max_err(g, w))
    return err, flips, dropped


def kernel_counters():
    """Each kernel's launch counter by name: (its wrapper, the attribute
    that counts its launches). The float32 and bfloat16 variants of K1-K4
    share a wrapper and count apart."""
    from tggcn_torch.ops import segment_scan
    from tggcn_torch.ops.geo_gcn import geo_gcn_fused
    from tggcn_torch.ops.gru_sequence import gru_sequence, gru_sequence_bwd

    wrappers = {"gru_sequence": gru_sequence, "gru_sequence_bwd": gru_sequence_bwd,
                **{name: getattr(segment_scan, name) for name in (
                    "segment_scan_dot", "segment_scan_dot_bwd", "segment_scan_v1",
                    "segment_scan_v4", "segment_scan_ext")},
                "geo_gcn_fused": geo_gcn_fused}
    counters = {name: (wrapper, "launches") for name, wrapper in wrappers.items()}
    counters.update({f"{name}_bf16": (wrappers[name], "launches_bf16")
                     for name in TRAIN_KERNELS + K5_KERNELS})
    return counters


def reset_launches():
    for wrapper, attr in kernel_counters().values():
        setattr(wrapper, attr, 0)


def read_launches():
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in kernel_counters().items()}


def stage_module(stage):
    from tggcn_torch.models import cad120, stage1, stage2

    return {"stage1": stage1, "stage2": stage2, "cad120": cad120}[stage]


def route_kernels(cfg, dists3, train, bf16):
    """The kernels (counter names) one request (train=False) or one train
    step of a model configuration launches, each once, given which distance
    tensors it reads: K1 (and K2 in a step); the segment scan's by its mode
    (models/tggcn.py segment_mode): K3 (and K4) in 'dot', K5 in another
    mode, none for the general scan (plain PyTorch); of the dtype; and K6,
    float32 in either dtype, with the GeoGCN kernel on. Returns (names,
    mode)."""
    from tggcn_torch.models.tggcn import segment_mode

    mode = segment_mode(cfg, dists3)
    names = ["gru_sequence"] + (["gru_sequence_bwd"] if train else [])
    if mode == "dot":
        names += ["segment_scan_dot"] + (["segment_scan_dot_bwd"] if train else [])
    elif mode is not None:
        names.append(f"segment_scan_{mode}")
    names = {f"{name}_bf16" if bf16 else name for name in names}
    if cfg.use_pallas_geo_gcn:
        names.add("geo_gcn_fused")
    return names, mode


DIST_KEYS = ("human_human_distances", "human_object_distances", "object_object_distances")


def output_shapes(cfg, b, t, nh, no):
    """The shapes of a request's outputs: the decisions, then the frame and
    segment heads (B, classes, T, entities)."""
    sub, aff = cfg.num_classes
    if aff is None:
        return [(b, t, nh)] * 2 + [(b, sub, t, nh)] * 4
    heads = [(b, sub, t, nh)] * 2 + [(b, aff, t, no)] * 2
    return [(b, t, nh), (b, t, no)] * 2 + heads * 2


def run_forward(torch, dev, size, seed, variant=None, dtype="float32", stage="stage1",
                requests=REQUESTS):
    """Served requests of the stage-1, stage-2 or CAD-120 model, or of one
    of its SERVE_VARIANTS or FEATURE_VARIANTS, in the compute dtype, on the
    kernel route against the plain route; each kernel of the route
    (route_kernels) must launch once per request, and no other."""
    from tggcn_torch.models.registry import select_model

    module = stage_module(stage)
    b, t, nh, no = (size[k] for k in ("b", "t", "humans", "objects"))
    variants = {**getattr(module, "SERVE_VARIANTS", {}), **getattr(module, "FEATURE_VARIANTS", {})}
    change = variants[variant] if variant else {}
    model = select_model("2G-GCN", device=dev, **dict(module.model_kwargs(dtype), **change))
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)
    batches = [module.make_request(rng, b, t, nh, no) for _ in range(requests)]
    if variant == "dist":
        for batch in batches:
            batch.update(module.make_distances(rng, b, t, nh, no))
    # The Gumbel noise of each request, handed to both routes: the objects',
    # and the humans' where their segmentation is not imposed.
    noises = []
    for batch in batches:
        noises.append({})
        if "objects_segmentation" not in batch:
            noises[-1]["object"] = rng.gumbel(size=(b, t, no, 2)).astype(np.float32)
        if "human_segmentation" not in batch:
            noises[-1]["human"] = rng.gumbel(size=(b, t, nh, 2)).astype(np.float32)
    rule = decision_rule(model.config)
    bf16 = dtype == "bfloat16"
    limits = (LIMITS_CAD120_BF16 if stage == "cad120" else LIMITS_BF16)["forward"]
    # K6 is float32 in either dtype, as JAX keeps it.
    expected, _ = route_kernels(model.config, [batches[0].get(k) for k in DIST_KEYS], False,
                                bf16)

    model.apply(params, noise=noises[0], **batches[0])   # warm-up: cuBLAS, library loads
    torch.cuda.synchronize(dev)
    reset_launches()
    results, times = [], []
    for batch, noise in zip(batches, noises):
        start = time.perf_counter()
        out = model.apply(params, noise=noise, **batch)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - start) * 1e3)
        results.append(out)
    launches = read_launches()
    if launches != {name: requests if name in expected else 0 for name in launches}:
        raise AssertionError(f"the forward did not go through exactly the kernels "
                             f"{sorted(expected)} once a request: {launches}")

    want_shapes = output_shapes(model.config, b, t, nh, no)
    plain_times, wants, err, flips, dropped = [], [], 0.0, 0, 0
    for i, (batch, noise, got) in enumerate(zip(batches, noises, results)):
        if [tuple(o.shape) for o in got[0]] != want_shapes:
            raise AssertionError(f"request {i}: output shapes {[o.shape for o in got[0]]}")
        start = time.perf_counter()
        want = model.apply(params, use_kernels=False, noise=noise, **batch)
        torch.cuda.synchronize(dev)
        plain_times.append((time.perf_counter() - start) * 1e3)
        wants.append(want)
        e, f, d = compare_forward(torch, got, want, f"request {i}", bf16=bf16, rule=rule,
                                  atol_bf16=limits.get("max_abs"))
        err, flips, dropped = max(err, e), flips + f, dropped + d
    controls = {}
    if bf16:
        controls = check_controls(
            "forward_bf16", partial(forward_gaps, torch, rule=rule),
            lambda: [model.apply(params, use_kernels=False, noise=noise, **batch)
                     for batch, noise in zip(batches, noises)],
            results, wants, limits)
    after = read_launches()
    if after != launches:
        raise AssertionError(f"the plain path launched kernels: {launches} -> {after}")
    return dict(ms=statistics.median(times), plain_ms=statistics.median(plain_times),
                max_abs_err=err, flips=flips, dropped_rows=dropped, launches=launches,
                **controls)


def tensor_leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in tensor_leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in tensor_leaves(sub, f"{path}/{i}").items()}
    return {path: tree}


def grad_gaps(got, want, floor):
    """How far the gradients of the tree got lie from want's, leaf by leaf,
    each measure the largest over the leaves: max_share, a leaf's largest
    difference as a share of its largest value (or of floor, where that is
    smaller); rel_l2, the norm of a leaf's difference over its norm (or
    over floor times the square root of its size); and over the model as a
    whole: model_share, the largest difference as a share of the model's
    largest gradient, and model_rel_l2, the norm of all the differences
    over the norm of all the gradients; all inf where got is not finite."""
    got = tensor_leaves(got)
    out = dict(max_share=0.0, rel_l2=0.0)
    top = diff = norm_d = norm_w = 0.0
    for key, w in tensor_leaves(want).items():
        if w.grad is None:
            continue
        g, w = got[key].grad.double(), w.grad.double()
        if not bool(g.isfinite().all()):
            return dict(max_share=math.inf, rel_l2=math.inf, model_share=math.inf,
                        model_rel_l2=math.inf)
        d = g - w
        out["max_share"] = max(out["max_share"],
                               float(d.abs().max()) / max(float(w.abs().max()), floor))
        out["rel_l2"] = max(out["rel_l2"], float(d.norm()) / max(float(w.norm()),
                                                                floor * w.numel() ** 0.5))
        top, diff = max(top, float(w.abs().max())), max(diff, float(d.abs().max()))
        norm_d, norm_w = norm_d + float(d.norm()) ** 2, norm_w + float(w.norm()) ** 2
    out.update(model_share=diff / (top or 1.0), model_rel_l2=(norm_d / (norm_w or 1.0)) ** 0.5)
    return out


@contextlib.contextmanager
def recompute_timer(torch):
    """CUDA events around each backward of SegmentScanRecompute (K5's
    gradients, recomputed through the fast path's counterpart): yields a
    list that holds, after the block, the ms between them on the card of
    each backward, the card's span over the recompute, idle gaps included."""
    from tggcn_torch.ops.segment_scan import SegmentScanRecompute

    events, backward = [], SegmentScanRecompute.backward

    def timed(ctx, *grads):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = backward(ctx, *grads)
        end.record()
        events.append((start, end))
        return out

    SegmentScanRecompute.backward = staticmethod(timed)
    times = []
    try:
        yield times
    finally:
        SegmentScanRecompute.backward = staticmethod(backward)
        torch.cuda.synchronize()
        times.extend(start.elapsed_time(end) for start, end in events)


def run_train(torch, dev, size, seed, dtype="float32", stage="stage1", variant=None,
              hidden=None):
    """One train step of the stage-1, stage-2 or CAD-120 model (or of one of
    its SERVE_VARIANTS; at another hidden width where given) in the compute
    dtype on each route from the same weights, compared; then TRAIN_STEPS
    (MODE_TRAIN_STEPS for a variant) timed steps on the kernel route, each
    launching the route's kernels (route_kernels) once. Stage 2 starts from
    stage-1 weights merged into its own init (merge_params, as train.py
    warm-starts it) and draws Gumbel noise for humans and objects."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.nn.distributions import gumbel_noise
    from tggcn_torch.train.checkpoint import count_merged, merge_params
    from tggcn_torch.train.loop import make_train_step, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    module = stage_module(stage)
    b, t, nh, no = (size[k] for k in ("b", "t", "humans", "objects"))
    bf16 = dtype == "bfloat16"
    steps = MODE_TRAIN_STEPS if variant else TRAIN_STEPS
    what = (f"train{'_' + stage if stage != 'stage1' else ''}{'_bf16' if bf16 else ''}"
            f"{' ' + variant if variant else ''}{f' hidden {hidden}' if hidden else ''} step")
    marginal = MARGINAL_BF16 if bf16 else MARGINAL
    loss_rtol, leaf_rtol = (LOSS_RTOL_BF16, LEAF_GRAD_RTOL_BF16) if bf16 else (LOSS_RTOL,
                                                                              LEAF_GRAD_RTOL)
    change = dict(module.SERVE_VARIANTS[variant] if variant else {},
                  **({"hidden_size": hidden} if hidden else {}))
    model = select_model("2G-GCN", device=dev, **dict(module.model_kwargs(dtype), **change))
    rule = decision_rule(model.config)
    criterion, _ = select_loss("2G-GCN", "multiple", module.DATASET, module.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **(
        module.feeder_kwargs(variant) if variant else module.FEEDER_KWARGS))
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name=module.DATASET)
    data, targets = fetch(module.make_batch(np.random.default_rng(seed), b, t, nh, no,
                                            **({"variant": variant} if variant else {})))
    data = [torch.as_tensor(x, device=dev) for x in data]          # resident, as bench.py
    targets = [torch.as_tensor(y, device=dev) for y in targets]
    # K6 is float32 in either dtype; a K5 mode's gradients are recomputed.
    fed = feeder(data)
    kernels, mode = route_kernels(model.config, [fed[k] for k in DIST_KEYS], True, bf16)
    recompute = mode in K5_MODES
    # A variant's step (a K5 mode's recompute; CAD-120's 'dist', whose K6
    # moves every ReLU input downstream of the geometry by its rounding) is
    # held over the whole model: see MODE_TRAIN_LIMITS; so is a step at
    # another width: see WIDTH_STEP_LIMITS.
    whole_model = variant is not None or hidden is not None
    whole_limits = (MODE_TRAIN_LIMITS if variant else WIDTH_STEP_LIMITS).get(dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = {"object": gumbel_noise((b, t, no, 2), gen)}
    if stage == "stage2":
        noise["human"] = gumbel_noise((b, t, nh, 2), gen)
    warm = None
    if stage == "stage2":
        warm = select_model("2G-GCN", device=dev, **dict(
            stage1.model_kwargs(dtype), **({"hidden_size": hidden} if hidden else {})))

    def init():
        """The weights of a first step: stage 1's init, or stage 2's init
        with a stage-1 tree merged in."""
        if warm is None:
            return model.init(torch.Generator().manual_seed(0))
        own = model.init(torch.Generator().manual_seed(1))
        return own, merge_params(own, warm.init(torch.Generator().manual_seed(0)))

    merged = None
    if warm is not None:
        own, params = init()
        merged = (count_merged(own, params), len(tensor_leaves(own)))
        print(f"{what}: warm start took {merged[0]} of {merged[1]} leaves from a stage-1 tree",
              flush=True)
        del own, params

    # The CAD-120 float32 step, held leaf by leaf, is held with the plain
    # route's side of each marginal ReLU kink (kink_sides, at most
    # KINK_FLIPS); every other step is held as it ran.
    kinks = stage == "cad120" and not bf16 and not whole_model

    def first_step(use_kernels, rows, record=False, sides=None):
        weights = init()
        trainable = {"model": weights if warm is None else weights[1]}
        del weights
        optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=module.TRAIN["lr"])
        step = make_train_step(model, feeder, criterion, optimizer,
                               clip_gradient_at=module.TRAIN["clip"], use_kernels=use_kernels)
        batch = ([x[rows] for x in data], [y[rows] for y in targets],
                 {k: v[rows] for k, v in noise.items()})
        reset_launches()
        with relu_inputs(sides) if record or sides else contextlib.nullcontext([]) as relus:
            losses, _, aux = step(trainable, *batch[:2], noise=batch[2])
        torch.cuda.synchronize(dev)
        return dict(trainable=trainable, step=step, batch=batch, losses=losses, aux=aux,
                    launches=read_launches(), relus=relus)

    rows = torch.ones(b, dtype=torch.bool, device=dev)
    kern, plain = first_step(True, rows, kinks), first_step(False, rows, kinks)
    keep, flips, dropped = decision_rows(torch, kern["aux"], plain["aux"], what,
                                         marginal, **rule)
    if dropped:                          # run both again without the flipped row
        rows = keep.to(dev)
        kern, plain = first_step(True, rows, kinks), first_step(False, rows, kinks)
        decision_rows(torch, kern["aux"], plain["aux"], f"{what} without the flipped row",
                      marginal, **rule)
    want = tensor_leaves(plain["trainable"])
    floor = GRAD_FLOOR * max(float(w.grad.abs().max()) for w in want.values()
                             if w.grad is not None)
    held, kink_flips, unheld = kern, 0, None
    if kinks:
        sides, kink_flips = kink_sides(torch, kern.pop("relus"), plain.pop("relus"), what)
        if kink_flips:
            # The kernel route as it ran, over the whole model as a K5
            # mode's float32 step; then again, on the plain route's sides.
            unheld = grad_gaps(kern["trainable"], plain["trainable"], floor)["model_share"]
            print(f"{what}: {kink_flips} ReLU kink flips; the kernel route as it ran: largest "
                  f"difference {unheld:.3e} of the model's largest gradient", flush=True)
            limit = MODE_TRAIN_LIMITS["float32"]["model_share"]
            if not (unheld <= limit and torch.allclose(kern["losses"], plain["losses"],
                                                       rtol=loss_rtol, atol=0)):
                raise AssertionError(f"{what}: the kernel route as it ran differs beyond "
                                     f"{limit} of the model's largest gradient ({unheld:.3e}) "
                                     f"or in its losses")
            held = first_step(True, rows, sides=sides)
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain route launched kernels: {plain['launches']}")
    again = first_step(True, rows)
    grads = [(leaf.grad, tensor_leaves(again["trainable"])[key].grad)
             for key, leaf in tensor_leaves(kern["trainable"]).items() if leaf.grad is not None]
    unequal = sum(not torch.equal(a, b) for a, b in grads)
    equal_leaves = len(grads)
    print(f"{what}: two kernel-route steps from the same weights, batch and noise: "
          f"{len(grads) - unequal} of {len(grads)} gradient leaves bitwise equal", flush=True)
    if unequal:
        raise AssertionError(f"{unequal} of {len(grads)} gradient leaves differ between two "
                             "identical kernel-route steps")
    if kern["launches"] != {k: int(k in kernels) for k in kern["launches"]}:
        raise AssertionError(f"the train step did not go through exactly the kernels "
                             f"{kernels} once: {kern['launches']}")
    loss_err = max_err(held["losses"], plain["losses"])
    if (not bool(held["losses"].isfinite().all())
            or not torch.allclose(held["losses"], plain["losses"], rtol=loss_rtol, atol=0)):
        raise AssertionError(f"train step losses differ: {held['losses'].tolist()} against "
                             f"{plain['losses'].tolist()}")
    gaps = {key: grad_gaps({key: g}, {key: want[key]}, floor)
            for key, g in tensor_leaves(held["trainable"]).items() if want[key].grad is not None}
    rels = {key: gap["max_share"] for key, gap in gaps.items()}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    top = floor / GRAD_FLOOR
    print(f"{what}: largest gradient differences (share of each leaf's largest; the leaf's "
          f"rel. norm; its largest over the model's largest gradient): " + ", ".join(
              f"{k} {v:.3e} ({gaps[k]['rel_l2']:.3e}; "
              f"{float(want[k].grad.abs().max()) / top:.2e})" for k, v in worst), flush=True)
    measure = lambda got, want: grad_gaps(got["trainable"], want["trainable"], floor)
    whole = measure(held, plain)
    print(f"{what}: over the whole model: largest difference {whole['model_share']:.3e} of the "
          f"model's largest gradient, rel. norm {whole['model_rel_l2']:.3e}", flush=True)
    if whole_model:
        over = {k: whole[k] for k, limit in whole_limits.items() if not whole[k] <= limit}
        if over:
            raise AssertionError(f"gradients differ beyond {whole_limits}: {over}")
        grad_rel = whole["model_share"]
    else:
        # CAD-120 bfloat16 keeps this per-leaf limit besides the whole
        # model's norm (LIMITS_CAD120_BF16), which a fault in one small
        # leaf would hardly move.
        if not worst[0][1] <= leaf_rtol:
            raise AssertionError(f"gradients differ beyond {leaf_rtol}: "
                                 f"{[k for k, v in rels.items() if not v <= leaf_rtol]}")
        grad_rel = worst[0][1]
    weight_err = max(max_err(g.detach(), want[key].detach())
                     for key, g in tensor_leaves(held["trainable"]).items())
    # In float32 Adam's first step (lr g / (|g| + eps), which saturates at
    # lr) may move a weight whose gradient is rounding noise either way; in
    # bfloat16, and for a variant (whose near-zero gradients change sign
    # where a recomputed kink flips), the gradient check above bounds them.
    if not bf16 and not whole_model and not weight_err <= module.TRAIN["lr"]:
        raise AssertionError(f"updated weights differ by {weight_err:.3e} "
                             f"(limit one learning rate, {module.TRAIN['lr']})")
    controls = {}
    if bf16:
        limits = (whole_limits if whole_model else
                  (LIMITS_CAD120_BF16 if stage == "cad120" else LIMITS_BF16)["train"])
        controls = check_controls(what, measure, lambda: first_step(False, rows), kern, plain,
                                  limits)

    # The timed steps' peak is the step's own: of the compared runs only the
    # kernel route's weights, Adam state and batch stay alive.
    del plain, again, grads, want, held
    times = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    with recompute_timer(torch) as recompute_ms:
        for _ in range(steps):
            start = time.perf_counter()
            losses, _, _ = kern["step"](kern["trainable"], *kern["batch"][:2],
                                        noise=kern["batch"][2])
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - start) * 1e3)
            if not bool(losses.isfinite().all()):
                raise AssertionError(f"train step losses are not finite: {losses.tolist()}")
    launches = read_launches()
    if launches != {k: steps * (k in kernels) for k in launches}:
        raise AssertionError(f"a timed train step missed a kernel: {launches}")
    if len(recompute_ms) != (steps if recompute else 0):
        raise AssertionError(f"{len(recompute_ms)} recompute backwards in {steps} steps")
    return dict(ms=statistics.median(times), losses=kern["losses"].tolist(), loss_err=loss_err,
                steps=steps, recompute_ms=statistics.median(recompute_ms) if recompute_ms else None,
                whole_model=whole_model,
                grad_rel=grad_rel, weight_err=weight_err, flips=flips, kink_flips=kink_flips,
                unheld_model_share=unheld, dropped_rows=dropped,
                launches=launches, equal_leaves=equal_leaves, merged=merged, **controls,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                resident_gib=resident / 2 ** 30)


def train_setup(torch, dev, size, seed, dtype, stage):
    """The model of a stage in a dtype at the full width, its loss bundle
    and feeder, and one seeded batch resident on the card."""
    from tggcn_torch.data.feeders import select_model_data_feeder, select_model_data_fetcher
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.train.losses import select_loss

    module = stage_module(stage)
    b, t, nh, no = (size[k] for k in ("b", "t", "humans", "objects"))
    model = select_model("2G-GCN", device=dev, **module.model_kwargs(dtype))
    criterion, _ = select_loss("2G-GCN", "multiple", module.DATASET, module.TRAIN["misc"])
    feeder = select_model_data_feeder("2G-GCN", "multiple", **module.FEEDER_KWARGS)
    fetch = select_model_data_fetcher("2G-GCN", "multiple", dataset_name=module.DATASET)
    data, targets = fetch(module.make_batch(np.random.default_rng(seed), b, t, nh, no))
    return (model, module, criterion, feeder, [torch.as_tensor(x, device=dev) for x in data],
            [torch.as_tensor(y, device=dev) for y in targets])


def run_sync_free(torch, dev, size, seed):
    """One eager kernel-route train step of the bfloat16 stage-1, stage-2
    and CAD-120 models (each at its module's SHAPE, stage 1 and 2 at size),
    each drawing its Gumbel noise on the card from a generator, under
    torch.cuda.set_sync_debug_mode("error"): a synchronizing call raises. A
    warm-up step before each builds the kernels."""
    from tggcn_torch.train.loop import make_train_step, trainable_parameters

    out, dtype = {}, "bfloat16"
    for stage in ("stage1", "stage2", "cad120"):
        at = stage_module(stage).SHAPE if stage == "cad120" else size
        model, module, criterion, feeder, data, targets = train_setup(torch, dev, at, seed,
                                                                      dtype, stage)
        trainable = {"model": model.init(torch.Generator().manual_seed(0))}
        step = make_train_step(model, feeder, criterion, torch.optim.Adam(
            trainable_parameters(trainable), lr=module.TRAIN["lr"]))
        gen = torch.Generator(device=dev).manual_seed(seed)
        step(trainable, data, targets, generator=gen)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses, _, _ = step(trainable, data, targets, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(dev)
        if not bool(losses.isfinite().all()):
            raise AssertionError(f"{stage} {dtype} step losses: {losses.tolist()}")
        out[stage] = losses.tolist()
        print(f"sync_free {stage} {dtype}: an eager kernel-route step made no "
              f"synchronizing call; losses {json.dumps(out[stage])}", flush=True)
    return out


def profiled(fn):
    """fn() under torch.profiler (tggcn_torch.profile_step.profile): (host
    ms up to a synchronize, the card's busy ms, its kernel events)."""
    from tggcn_torch.profile_forward import _union_us
    from tggcn_torch.profile_step import profile, timed

    wall, events, _ = profile(lambda: timed(fn, 1)[0])
    return wall, _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3, events


def kernel_groups(events, bf16):
    """{K1-K4: launches} among events, each kernel's name checked to be the
    variant of the dtype (a bfloat16 variant's signature names
    __nv_bfloat16)."""
    from tggcn_torch.profile_step import group_of

    counts = dict.fromkeys(FUSED_GROUPS, 0)
    for e in events:
        group = group_of(e.name)
        if group in counts:
            if ("bfloat16" in e.name) != bf16:
                raise AssertionError(f"{group} launched a kernel of the other dtype: {e.name}")
            counts[group] += 1
    return counts


def run_train_fused(torch, dev, size, seed, dtype="float32", stage="stage1",
                    profiled_steps=PROFILED_STEPS, eager_window=FUSED_WINDOW):
    """FUSED_STEPS train steps fused into one call (one step captured in a
    CUDA graph, replayed) against as many eager kernel-route steps, from
    the same weights, batch and noise stack, each route with its own
    capturable Adam: losses, every leaf, Adam's state and the BatchNorm
    state must be equal bit for bit. The kernels of a replay are counted by
    the profiler (the wrappers count in Python, which a replay does not
    run): profiled_steps replays must launch K1-K4 of the dtype as often as
    as many eager steps, each group of the route's kernels (route_kernels)
    and no other. Before those, a FUSED_WINDOW-step window of the fused
    route and an eager_window-step one of the eager route, fresh noise
    drawn on the card: ms a step (host clock, one synchronize at the end);
    busy ms and idle share from the profiled steps."""
    from tggcn_torch.train.loop import (gumbel_noise_stack, make_fused_train_steps,
                                        make_train_step, trainable_parameters)

    model, module, criterion, feeder, data, targets = train_setup(torch, dev, size, seed,
                                                                  dtype, stage)
    bf16 = dtype == "bfloat16"
    k = FUSED_STEPS
    b, t, nh, no = (size[key] for key in ("b", "t", "humans", "objects"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = gumbel_noise_stack(gen, k, b, t, nh, no)
    fed = feeder(data)
    names, _ = route_kernels(model.config, [fed[key] for key in DIST_KEYS], True, bf16)
    groups = {KERNEL_GROUP[n.removesuffix("_bf16")] for n in names
              if n.removesuffix("_bf16") in KERNEL_GROUP}

    def route():
        trainable = {"model": model.init(torch.Generator().manual_seed(0))}
        return trainable, torch.optim.Adam(trainable_parameters(trainable),
                                           lr=module.TRAIN["lr"], capturable=True)

    eager, eager_opt = route()
    step = make_train_step(model, feeder, criterion, eager_opt,
                           clip_gradient_at=module.TRAIN["clip"])
    want = torch.stack([step(eager, data, targets, noise={w: v[i] for w, v in noise.items()})[0]
                        for i in range(k)])
    torch.cuda.synchronize(dev)
    tree, opt = route()
    fused = make_fused_train_steps(model, feeder, criterion, opt,
                                   clip_gradient_at=module.TRAIN["clip"])
    stack = lambda xs, n: [x.expand(n, *x.shape) for x in xs]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    got, _ = fused(tree, stack(data, k), stack(targets, k), noise_stack=noise)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - start
    captured = {name: n for name, n in read_launches().items() if n}
    fused_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not torch.equal(got, want):
        raise AssertionError(f"fused losses {got.tolist()} differ from eager {want.tolist()}")
    leaves_f, leaves_e = tensor_leaves(tree), tensor_leaves(eager)
    unequal = [key for key in leaves_e if not torch.equal(leaves_f[key], leaves_e[key])]
    params_f, params_e = trainable_parameters(tree), trainable_parameters(eager)
    moments = [(opt.state[p][key], eager_opt.state[q][key]) for p, q in zip(params_f, params_e)
               for key in ("exp_avg", "exp_avg_sq", "step")]
    unequal += [f"adam {i}" for i, (x, y) in enumerate(moments) if not torch.equal(x, y)]
    if unequal:
        raise AssertionError(f"{len(unequal)} tensors differ between {k} fused and {k} eager "
                             f"steps: {unequal[:8]}")
    print(f"train_fused {stage} {dtype}: {k} fused steps (first call {first_s:.3f} s: "
          f"warm-up, capture, replays) equal {k} eager steps bit for bit: losses, "
          f"{len(leaves_e)} leaves (BatchNorm state among them), {len(moments)} Adam tensors; "
          f"wrapper launches counted at capture {json.dumps(captured)}", flush=True)

    def run_fused(n):
        fused(tree, stack(data, n), stack(targets, n), generator=gen)

    def run_eager(n):
        for _ in range(n):
            step(eager, data, targets, generator=gen)

    result = dict(equal_leaves=len(leaves_e), equal_adam=len(moments), first_call_s=first_s,
                  fused_peak_gib=fused_peak)
    for name, run, window in (("fused", run_fused, FUSED_WINDOW),
                              ("eager", run_eager, eager_window)):   # both warm already
        torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        run(window)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - start) * 1e3 / window
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        wall, busy, events = profiled(lambda: run(profiled_steps))
        result[name] = dict(ms=ms, busy_ms=busy / profiled_steps,
                            idle=1.0 - busy / profiled_steps / ms, profiled_idle=1.0 - busy / wall,
                            launches=len(events) / profiled_steps, peak_gib=peak_gib,
                            kernels=kernel_groups(events, bf16))
    replays, steps = result["fused"]["kernels"], result["eager"]["kernels"]
    if {g for g, n in steps.items() if n} != groups or replays != steps:
        raise AssertionError(f"{profiled_steps} replays launched {replays}; "
                             f"{profiled_steps} eager steps {steps}; the route's groups {groups}")
    result.update(profiled_steps=profiled_steps, eager_window=eager_window)
    return result


def print_train_fused(name, r):
    f, e, n_prof = r["fused"], r["eager"], r["profiled_steps"]
    each = lambda kernels: json.dumps({g: n // n_prof for g, n in kernels.items()})
    print(f"{name}: K1-K4 kernels a replay {each(f['kernels'])} (an eager step "
          f"{each(e['kernels'])}); {FUSED_WINDOW}-step window: fused "
          f"{f['ms']:.3f} ms a step, eager {e['ms']:.3f} (over {r['eager_window']} steps; "
          f"host clock, one synchronize a window); over {n_prof} profiled steps: busy {f['busy_ms']:.3f} / "
          f"{e['busy_ms']:.3f} ms a step, idle share (1 - busy / ms a step) {f['idle']:.3f} / "
          f"{e['idle']:.3f} ({f['profiled_idle']:.3f} / {e['profiled_idle']:.3f} of the "
          f"profiled wall), {f['launches']:.0f} / {e['launches']:.0f} kernels a step; peak "
          f"device memory "
          f"{f['peak_gib']:.3f} / {e['peak_gib']:.3f} GiB over the window "
          f"({r['fused_peak_gib']:.3f} GiB over the capture)", flush=True)


def run_bench_short(torch):
    """python -m tggcn_torch.bench --steps 2 --best-of 1 at the full width,
    in a subprocess: its last line must parse, carry no error, a positive
    value and a cross-check within bench's 5%."""
    from tggcn_torch import bench

    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    run = subprocess.run([sys.executable, "-m", "tggcn_torch.bench", "--steps", "2",
                          "--best-of", "1"], cwd=root, capture_output=True, text=True,
                         timeout=BENCH_SHORT_S)
    lines = run.stdout.strip().splitlines()
    record = json.loads(lines[-1]) if lines else {}
    print(f"bench_short: rc {run.returncode}, last line {json.dumps(record)}", flush=True)
    deviation = record.get("crosscheck_max_dev")
    if (run.returncode != 0 or "error" in record or record.get("metric") != bench.METRIC
            or not (record.get("value") or 0) > 0
            or deviation is None or not deviation < bench.CROSSCHECK_LIMIT):
        raise AssertionError(f"tggcn_torch.bench failed: rc {run.returncode}, "
                             f"{json.dumps(record)}; stderr tail {run.stderr[-2000:]}")
    return record


def print_forward(name, r, requests):
    print(f"{name} ms per request {r['ms']:.3f} (plain path {r['plain_ms']:.3f}), max abs err "
          f"vs plain {r['max_abs_err']:.3e}, marginal decision flips {r['flips']} (batch rows "
          f"left out {r['dropped_rows']}), launches {json.dumps(r['launches'])} over "
          f"{requests} requests", flush=True)


def print_train(name, r):
    recompute = ("" if r["recompute_ms"] is None else
                 f"; recompute backward {r['recompute_ms']:.3f} ms a step (median, CUDA events)")
    of = "the model's largest gradient" if r["whole_model"] else "each leaf's largest"
    unheld = ("" if r["unheld_model_share"] is None else
              f"; unheld, {r['unheld_model_share']:.3e} of the model's largest gradient")
    print(f"{name} step ms {r['ms']:.3f} (median of {r['steps']} on the kernel route), losses "
          f"{json.dumps(r['losses'])}, kernel vs plain route: losses {r['loss_err']:.3e}, "
          f"gradients {r['grad_rel']:.3e} of {of}, weights "
          f"{r['weight_err']:.3e}; marginal decision flips {r['flips']} (batch rows left out "
          f"{r['dropped_rows']}), marginal ReLU kink flips {r['kink_flips']} (held on the "
          f"plain route's side{unheld}); launches {json.dumps(r['launches'])} over {r['steps']} "
          f"steps{recompute}; {r['equal_leaves']} gradient leaves bitwise equal in two "
          f"kernel-route steps; peak device memory {r['peak_gib']:.3f} GiB "
          f"(torch.cuda.max_memory_allocated over the timed steps, of which "
          f"{r['resident_gib']:.3f} GiB of weights, Adam state and batch held between steps)",
          flush=True)


def run_general_variants(torch, dev, seed, b=8, t=167, hidden=64):
    """One float32 request of each of GENERAL_VARIANTS at hidden 64 on the
    kernel route against the plain route, under the forward phase's limits:
    'st' decisions taken, nothing imposed, the last clip with half its
    objects masked and a shorter clip length for the positional features;
    exactly K1 launches, once a request."""
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model

    rng = np.random.default_rng(seed)
    out = {}
    for name, (change, nh, no, bn_train) in GENERAL_VARIANTS.items():
        model = select_model("2G-GCN", device=dev, **dict(
            stage1.MODEL_KWARGS, hidden_size=hidden, discrete_optimization_strategy="st",
            **change))
        params = model.init(torch.Generator().manual_seed(0))
        mask = np.ones((b, no), np.float32)
        mask[-1, no // 2:] = 0.0
        steps = np.full((b,), float(t), np.float32)
        steps[-1] = float(t // 2)
        batch = dict(
            x_human=rng.standard_normal((b, t, nh, model.config.input_size[0]), dtype=np.float32),
            x_objects=rng.standard_normal((b, t, no, 2048), dtype=np.float32),
            objects_mask=mask, steps_per_example=steps)
        expected, mode = route_kernels(model.config, [None] * 3, False, False)
        if mode is not None:
            raise AssertionError(f"{name}: segment mode {mode}, not the general scan")
        with torch.no_grad():
            model.apply(params, train=bn_train, **batch)              # warm-up
            torch.cuda.synchronize(dev)
            reset_launches()
            start = time.perf_counter()
            got = model.apply(params, train=bn_train, **batch)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - start) * 1e3
            launches = read_launches()
            start = time.perf_counter()
            want = model.apply(params, train=bn_train, use_kernels=False, **batch)
            torch.cuda.synchronize(dev)
            plain_ms = (time.perf_counter() - start) * 1e3
        if launches != {k: int(k in expected) for k in launches}:
            raise AssertionError(f"{name}: the forward did not go through exactly "
                                 f"{sorted(expected)} once: {launches}")
        if read_launches() != launches:
            raise AssertionError(f"{name}: the plain route launched kernels")
        shapes = [tuple(o.shape) for o in got[0]]
        if shapes != output_shapes(model.config, b, t, nh, no):
            raise AssertionError(f"{name}: output shapes {shapes}")
        err, flips, dropped = compare_forward(torch, got, want, name,
                                              rule=decision_rule(model.config))
        out[name] = r = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, flips=flips,
                             dropped_rows=dropped, launches=launches)
        print_forward(f"forward_general_variants {name}:", r, 1)
    return out


def run_entry_mphoi(torch, dev, seed):
    """The entry_mphoi phase (see the module's docstring): the train and
    predict CLIs of the port on a synthetic MPHOI dataset at the full
    width. Returns the numbers it measured."""
    import shutil
    import tempfile

    from tggcn_torch import predict as predict_cli
    from tggcn_torch.config import compose
    from tggcn_torch.data.loading import load_training_data
    from tggcn_torch.data.synthetic import generate_mphoi_dataset
    from tggcn_torch.eval.engine import load_run_model
    from tggcn_torch.eval.rundir import RunDir
    from tggcn_torch.train import cli

    outputs = Path(__file__).resolve().parent / "outputs"
    outputs.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="entry_mphoi_", dir=outputs))
    out = {}
    try:
        start = time.perf_counter()
        paths = generate_mphoi_dataset(str(work / "data"), seed=seed, **ENTRY_DATASET)
        out["dataset_s"] = time.perf_counter() - start

        def overrides(root, dtype="bfloat16", epochs=2, models="2G-GCN_stage1"):
            return [f"models={models}", "data=mphoi",
                    *(f"data.{k}={paths[k]}" for k in ("path", "path_zarr", "path_obb_zarr",
                                                         "path_hbb_zarr", "path_hps_zarr")),
                    "data.cross_validation_test_subject=Subject45",
                    f"parameters.compute_dtype={dtype}", f"optimization.epochs={epochs}",
                    f"logging.root_log_dir={work / root}"]

        cfg = compose(cli.CONF_DIR, overrides=overrides("stage1"))
        train_loader, val_loader, _, _ = load_training_data(
            cfg.data, "2G-GCN", "multiple", batch_size=cfg.optimization.batch_size,
            val_fraction=cfg.optimization.val_fraction)
        steps, evals = len(train_loader), len(train_loader) + len(val_loader)
        out.update(train_clips=train_loader.num_examples, val_clips=val_loader.num_examples,
                   steps_per_epoch=steps)
        del train_loader, val_loader

        def train(name, args, epochs, tag, run_steps):
            """A train CLI run: each of its train steps must launch K1-K4
            of the dtype (tag) once, each evaluation batch K1 and K3."""
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            start = time.perf_counter()
            checkpoint = cli.main(args)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - start
            launches = read_launches()
            want = {f"{k}{tag}": run_steps * epochs + evals * epochs * (k in FORWARD_KERNELS)
                    for k in TRAIN_KERNELS}
            if launches != {k: want.get(k, 0) for k in launches}:
                raise AssertionError(f"{name}: launches {launches}, not {want}")
            logging = compose(cli.CONF_DIR, overrides=args).logging
            scalars = Path(logging.root_log_dir) / "runs" / logging.checkpoint_name / "scalars.jsonl"
            records = [json.loads(line) for line in scalars.read_text().splitlines()]
            per_epoch = {tag_: [r["value"] for r in records if r["tag"] == f"perf/{tag_}"]
                         for tag_ in ("train_seconds", "eval_seconds")}
            losses = [total for total, _ in checkpoint["train_losses"]]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{name}: train losses {losses}")
            r = dict(seconds=seconds, launches={k: v for k, v in launches.items() if v},
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                     train_losses=losses, **per_epoch)
            print(f"entry_mphoi {name}: {json.dumps(r)}", flush=True)
            return checkpoint, r

        def checkpoint_name(args):
            return compose(cli.CONF_DIR, overrides=args).logging.checkpoint_name

        full, out["stage1_bf16"] = train("stage1_bf16", overrides("stage1"), 2, "_bf16", steps)
        run_dir = str(work / "stage1" / checkpoint_name(overrides("stage1")))

        # The predict CLI on the run dir: K1 and K3 once a batch.
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as report:
            predict_cli.main(["--pretrained_model_dir", run_dir])
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - start
        launches = read_launches()
        lines = report.getvalue().splitlines()
        print("entry_mphoi predict: " + "; ".join(
            f"{a} {b}" for a, b in zip(lines, lines[1:]) if b.startswith("F1@")), flush=True)
        loaded = load_run_model(RunDir(run_dir), dev)
        batches = math.ceil(loaded["test_loader"].num_examples / ENTRY_PREDICT_BATCH)
        want = {f"{k}_bf16": batches for k in FORWARD_KERNELS}
        if launches != {k: want.get(k, 0) for k in launches}:
            raise AssertionError(f"predict: launches {launches}, not {want}")
        out["predict"] = dict(seconds=seconds, launches=want,
                              test_clips=loaded["test_loader"].num_examples,
                              peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        print(f"entry_mphoi predict: {json.dumps(out['predict'])}", flush=True)
        out["held"] = hold_predict_routes(torch, dev, loaded)
        out["predict_batch"] = time_predict_batch(torch, dev, loaded)

        # Resume: a 1-epoch run named as the 2-epoch one, resumed to 2 epochs.
        name = checkpoint_name(overrides("stage1"))
        train("resume_first_epoch", overrides("resume", epochs=1)
              + [f"logging.checkpoint_name={name}"], 1, "_bf16", steps)
        resumed, _ = train("resumed", overrides("resume") + ["misc.resume=true"], 1, "_bf16",
                           steps)
        for key in ("train_losses", "val_losses"):
            if resumed[key][1] != full[key][1]:
                raise AssertionError(f"resumed epoch-2 {key} {resumed[key][1]} differ from the "
                                     f"uninterrupted run's {full[key][1]}")
        out["resume_epoch2_losses"] = full["train_losses"][1][0], full["val_losses"][1][0]
        print(f"entry_mphoi resume: epoch-2 train and val losses equal the uninterrupted "
              f"run's: {out['resume_epoch2_losses']}", flush=True)

        _, out["stage2_bf16"] = train(
            "stage2_bf16", overrides("stage2", epochs=1, models="2G-GCN_stage2")
            + [f"misc.pretrained_path={run_dir}"], 1, "_bf16", steps)
        _, out["stage1_float32"] = train("stage1_float32", overrides("float32", "float32"), 2,
                                         "", steps)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# The entry_baselines phase: each baseline's synthetic dataset (the
# generators' feature widths) and its cross-validation fold.
BASELINE_DATASETS = {
    "cad120_baseline": ("cad120", dict(num_videos=16, min_len=360, max_len=500), "Subject1",
                        ("path", "path_zarr", "video_id_to_subject_id")),
    "bimanual_baseline": ("bimanual", dict(num_videos=16, min_len=360, max_len=500), "2",
                          ("path", "path_zarr", "path_bb_zarr", "path_hp_zarr",
                           "video_id_to_video_fps")),
}
BASELINE_GOLDEN_RTOL, BASELINE_GOLDEN_ATOL = 2e-4, 2e-5   # tests/test_golden_baselines.py


def run_entry_baselines(torch, dev, seed, models=tuple(BASELINE_DATASETS), hidden=None,
                        epochs=2, golden=True):
    """The entry_baselines phase (see the module's docstring): each of the
    baselines `models` through the train and predict CLIs for `epochs` at
    its yaml's width (or `hidden`), held against the plain route, and with
    golden the reference's baseline fixtures on the kernel route. Returns
    the numbers it measured."""
    import shutil
    import tempfile

    from tggcn_torch import predict as predict_cli
    from tggcn_torch.config import compose
    from tggcn_torch.data import synthetic
    from tggcn_torch.data.feeders import num_inputs
    from tggcn_torch.data.loading import load_training_data
    from tggcn_torch.eval.engine import load_run_model
    from tggcn_torch.eval.rundir import RunDir
    from tggcn_torch.train import cli
    from tggcn_torch.train.loop import device_batches

    outputs = Path(__file__).resolve().parent / "outputs"
    outputs.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="entry_baselines_", dir=outputs))
    out = {}
    try:
        for model_name in models:
            dataset, sizes, subject, keys = BASELINE_DATASETS[model_name]
            start = time.perf_counter()
            generate = getattr(synthetic, f"generate_{dataset}_dataset")
            paths = generate(str(work / dataset), seed=seed, **sizes)
            dataset_s = time.perf_counter() - start
            args = [f"models={model_name}", f"data={dataset}",
                    *(f"data.{k}={paths[k]}" for k in keys),
                    f"data.cross_validation_test_subject={subject}",
                    f"optimization.epochs={epochs}", f"logging.root_log_dir={work / model_name}",
                    *([f"parameters.hidden_size={hidden}"] if hidden else [])]
            cfg = compose(cli.CONF_DIR, overrides=args)
            epochs, batch_size = cfg.optimization.epochs, cfg.optimization.batch_size
            train_loader, val_loader, _, _ = load_training_data(
                cfg.data, model_name, "multiple", batch_size=batch_size,
                val_fraction=cfg.optimization.val_fraction)
            steps, evals = len(train_loader), len(train_loader) + len(val_loader)
            first = next(device_batches(train_loader, batch_size, num_inputs(model_name), dev))
            del train_loader, val_loader

            # The train CLI: K1 once a forward (each step and each
            # evaluation batch), K2 once a step, float32.
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            start = time.perf_counter()
            checkpoint = cli.main(args)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - start
            launches = read_launches()
            want = {"gru_sequence": epochs * (steps + evals), "gru_sequence_bwd": epochs * steps}
            if launches != {k: want.get(k, 0) for k in launches}:
                raise AssertionError(f"{model_name} train: launches {launches}, not {want}")
            scalars = Path(cfg.logging.root_log_dir) / "runs" / cfg.logging.checkpoint_name
            records = [json.loads(line) for line in
                       (scalars / "scalars.jsonl").read_text().splitlines()]
            losses = [total for total, _ in checkpoint["train_losses"]]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{model_name}: train losses {losses}")
            r = dict(dataset_s=dataset_s, hidden=cfg.parameters.hidden_size,
                     batch=batch_size, epochs=epochs, steps_per_epoch=steps,
                     eval_batches_per_epoch=evals, seconds=seconds,
                     launches={k: v for k, v in launches.items() if v},
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                     train_losses=losses,
                     **{tag: [x["value"] for x in records if x["tag"] == f"perf/{tag}"]
                        for tag in ("train_seconds", "eval_seconds")})
            print(f"entry_baselines {model_name} train: {json.dumps(r)}", flush=True)

            # The predict CLI on the run dir: K1 once a batch.
            run_dir = str(Path(cfg.logging.root_log_dir) / cfg.logging.checkpoint_name)
            reset_launches()
            start = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as report:
                predict_cli.main(["--pretrained_model_dir", run_dir])
            torch.cuda.synchronize(dev)
            predict_s = time.perf_counter() - start
            loaded = load_run_model(RunDir(run_dir), dev)
            batches = math.ceil(loaded["test_loader"].num_examples / ENTRY_PREDICT_BATCH)
            launches = read_launches()
            if launches != {k: batches * (k == "gru_sequence") for k in launches}:
                raise AssertionError(f"{model_name} predict: launches {launches}")
            lines = report.getvalue().splitlines()
            print(f"entry_baselines {model_name} predict: " + "; ".join(
                f"{a} {b}" for a, b in zip(lines, lines[1:]) if b.startswith("F1@")), flush=True)
            r.update(predict_s=predict_s, test_clips=loaded["test_loader"].num_examples,
                     predict_batches=batches,
                     predict_launches={k: v for k, v in launches.items() if v},
                     **hold_baseline_routes(torch, dev, loaded, model_name),
                     step=hold_baseline_step(torch, dev, cfg, loaded, first, model_name))
            out[model_name] = r
        if golden:
            out["golden"] = hold_baseline_fixtures(torch, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def hold_baseline_routes(torch, dev, loaded, what):
    """The test clips of a trained baseline's run dir as one request on
    the kernel route (K1 once) and on the plain route (no launch): float32
    forward limits, and the label of every frame and entity of the
    outputs equal except where the plain route's top-two margin lies within
    FORWARD_ATOL (counted)."""
    model = loaded["model"]
    batch = next(iter(loaded["test_loader"]))
    data, _ = loaded["fetch"](batch)
    fed = loaded["feed"](data)
    reset_launches()
    start = time.perf_counter()
    got, _ = model.apply(loaded["params"], **fed)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - start) * 1e3
    want, _ = model.apply(loaded["params"], use_kernels=False, **fed)
    launches = read_launches()
    if launches != {k: int(k == "gru_sequence") for k in launches}:
        raise AssertionError(f"{what}: kernel and plain route launched {launches}")
    err = marginal = labels = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu(), w.cpu()
        if not (bool(g.isfinite().all())
                and torch.allclose(g, w, rtol=FORWARD_RTOL, atol=FORWARD_ATOL)):
            raise AssertionError(f"{what}: output {i} differs by {max_err(g, w):.3e}")
        err = max(err, max_err(g, w))
        differ = g.argmax(1) != w.argmax(1)
        top2 = w.topk(2, dim=1).values
        if bool((differ & (top2[:, 0] - top2[:, 1] > FORWARD_ATOL)).any()):
            raise AssertionError(f"{what}: a label differs between the routes beyond the "
                                 f"margin {FORWARD_ATOL}")
        labels += differ.numel()
        marginal += int(differ.sum())
    r = dict(request_ms=ms, request_clips=int(fed["x_human"].shape[0]), max_abs_err=err,
             labels=labels, marginal_label_flips=marginal)
    print(f"entry_baselines {what} kernel vs plain route: max abs err {err:.3e} (limits rtol "
          f"{FORWARD_RTOL}, atol {FORWARD_ATOL}), {marginal} of {labels} frame labels differ, "
          f"each within a top-two margin of {FORWARD_ATOL}", flush=True)
    return r


def hold_baseline_step(torch, dev, cfg, loaded, batch, what):
    """One train step of a trained baseline (the run's weights, its yaml's
    learning rate and clipping) on its first train batch, as the train
    loop pads it, on the kernel route (K1 and K2 once) and on the plain
    route (no launch), each from its own copy of the weights: the losses
    within LOSS_RTOL, and every leaf's gradient within LEAF_GRAD_RTOL of
    that leaf's largest (GRAD_FLOOR of the model's largest where that is
    larger)."""
    from tggcn_torch.compat.weights import params_from_numpy, params_to_numpy
    from tggcn_torch.train.loop import make_train_step, trainable_parameters
    from tggcn_torch.train.losses import select_loss

    model = loaded["model"]
    criterion, _ = select_loss(model.name, "multiple", cfg.data.name,
                               cfg.get("misc", default_value={}))
    data, targets = loaded["fetch"](batch)
    weights = params_to_numpy(loaded["params"])
    runs = {}
    for use_kernels in (True, False):
        trainable = {"model": params_from_numpy(weights, dev)}
        optimizer = torch.optim.Adam(trainable_parameters(trainable),
                                     lr=cfg.optimization.learning_rate)
        step = make_train_step(model, loaded["feed"], criterion, optimizer,
                               clip_gradient_at=cfg.optimization.clip_gradient_at,
                               use_kernels=use_kernels)
        reset_launches()
        losses, _, _ = step(trainable, data, targets)
        torch.cuda.synchronize(dev)
        runs[use_kernels] = dict(trainable=trainable, losses=losses, launches=read_launches())
    kern, plain = runs[True], runs[False]
    expect = {True: ("gru_sequence", "gru_sequence_bwd"), False: ()}
    for use_kernels, run in runs.items():
        if run["launches"] != {k: int(k in expect[use_kernels]) for k in run["launches"]}:
            raise AssertionError(f"{what} step (use_kernels={use_kernels}): launches "
                                 f"{run['launches']}")
    if not (bool(kern["losses"].isfinite().all())
            and torch.allclose(kern["losses"], plain["losses"], rtol=LOSS_RTOL, atol=0)):
        raise AssertionError(f"{what} step: losses {kern['losses'].tolist()} against "
                             f"{plain['losses'].tolist()}")
    want = tensor_leaves(plain["trainable"])
    floor = GRAD_FLOOR * max(float(w.grad.abs().max()) for w in want.values()
                             if w.grad is not None)
    shares = {key: grad_gaps({key: g}, {key: want[key]}, floor)["max_share"]
              for key, g in tensor_leaves(kern["trainable"]).items()
              if want[key].grad is not None}
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    print(f"entry_baselines {what} train step, kernel vs plain route, batch "
          f"{int(data[0].shape[0])}: launches {kern['launches']} (plain route "
          f"{plain['launches']}); "
          f"losses {max_err(kern['losses'], plain['losses']):.3e} apart; largest gradient "
          f"differences (share of each leaf's largest, limit {LEAF_GRAD_RTOL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst), flush=True)
    if not worst[0][1] <= LEAF_GRAD_RTOL:
        raise AssertionError(f"{what} step: gradients differ beyond {LEAF_GRAD_RTOL}: {worst}")
    return dict(leaves=len(shares), max_share=worst[0][1],
                launches={k: v for k, v in kern["launches"].items() if v})


def hold_baseline_fixtures(torch, dev):
    """tests/golden/baseline_*.npz on the kernel route (K1 once each) at
    test_golden_baselines.py's tolerance."""
    from tggcn_torch.compat.weights import baseline_params_from_torch_state_dict
    from tggcn_torch.models.baselines import BaselineConfig, apply_baseline
    from tggcn_torch.models.registry import to_device

    out = {}
    golden = Path(__file__).resolve().parent / "tests" / "golden"
    for path in sorted(golden.glob("baseline_*.npz")):
        data = np.load(path)
        part = lambda kind: {k.split("::")[1]: data[k] for k in data.files
                             if k.startswith(kind + "::")}
        inputs, weights = part("input"), part("weight")
        want = [data[f"output::{i}"] for i in range(len(part("output")))]
        cad120 = "cad120" in path.name
        cfg = BaselineConfig(input_size=(2124, 2048),
                             num_classes=(10, 12) if cad120 else (14, None), hidden_size=16,
                             with_object_head=cad120)
        params = to_device(baseline_params_from_torch_state_dict(weights), dev)
        reset_launches()
        with torch.no_grad():
            got = apply_baseline(params, cfg, *(torch.as_tensor(inputs[k], device=dev) for k in
                                                ("x_human", "x_objects", "objects_mask")))
        launches = read_launches()
        if launches != {k: int(k == "gru_sequence") for k in launches}:
            raise AssertionError(f"{path.name}: launches {launches}")
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            g = g.cpu().numpy()
            if not np.allclose(g, w, rtol=BASELINE_GOLDEN_RTOL, atol=BASELINE_GOLDEN_ATOL):
                raise AssertionError(f"{path.name}: output {i} lies {np.abs(g - w).max():.3e} "
                                     "from the reference")
            err = max(err, float(np.abs(g - w).max()))
        out[path.stem] = err
        print(f"entry_baselines {path.stem}: kernel route against the reference's outputs, "
              f"max abs err {err:.3e} (rtol {BASELINE_GOLDEN_RTOL}, atol "
              f"{BASELINE_GOLDEN_ATOL})", flush=True)
    if len(out) != 2:
        raise AssertionError(f"baseline fixtures found: {sorted(out)}")
    return out


# The stream_mphoi phase: MPHOI's width served by StreamingRunner (B=1,
# 2 humans, 4 objects), after tools/bench_streaming.py's model; a short
# stream held to the offline forward, then the tool's stream.
STREAM_KWARGS = dict(input_size=(2152, 2048), num_classes=(13, None), hidden_size=512,
                     gcn_node=26, message_humans_to_human=True, message_human_to_objects=True,
                     message_objects_to_human=True, message_objects_to_object=True,
                     message_geometry_to_objects=True, message_segment=True, message_type="v2",
                     message_granularity="v1", message_aggregation="att", attention_style="v3",
                     discrete_optimization_strategy="st", object_segment_update_strategy="ind",
                     geometry_flatten="per_frame")
STREAM_SHORT = dict(frames=96, window=16)                # lookahead: the whole stream
STREAM_LONG = dict(frames=2048, window=128, lookahead=32, fuse_group=16)
STREAM_REPS = 3
STREAM_REL_L2_BF16 = LIMITS_CAD120_BF16["forward"]["rel_l2"]


def stream_request(seed, frames, humans=2, objects=4):
    """A seeded MPHOI stream (B=1) with the human segmentation imposed, as
    the stage-1 feeder imposes it."""
    rng = np.random.default_rng(seed)
    seg = (rng.uniform(size=(1, frames, humans)) > 0.8).astype(np.float32)
    seg[:, -1] = 1.0
    return dict(x_human=rng.standard_normal((1, frames, humans, 2152), dtype=np.float32),
                x_objects=rng.standard_normal((1, frames, objects, 2048), dtype=np.float32),
                objects_mask=np.ones((1, objects), np.float32), human_segmentation=seg)


def stream_gaps(torch, got, want, what, bf16):
    """got against want (lists of stitched outputs): float32 within the
    forward limits, bfloat16 within STREAM_REL_L2_BF16 of the norm (rel_l2)."""
    got = [torch.as_tensor(np.asarray(g)) for g in got]
    want = [torch.as_tensor(np.asarray(w)) for w in want]
    if [g.shape for g in got] != [w.shape for w in want] or not all(
            bool(g.isfinite().all()) for g in got):
        raise AssertionError(f"{what}: outputs of other shapes or not finite")
    gaps = dict(max_abs=max(max_err(g, w) for g, w in zip(got, want)),
                **tensor_gaps(got, want))
    if bf16:
        ok = gaps["rel_l2"] <= STREAM_REL_L2_BF16
    else:
        ok = all(torch.allclose(g, w, rtol=FORWARD_RTOL, atol=FORWARD_ATOL)
                 for g, w in zip(got, want))
    print(f"stream_mphoi {what}: " + ", ".join(f"{k} {v:.4g}" for k, v in gaps.items())
          + (f" (limit rel_l2 {STREAM_REL_L2_BF16:g})" if bf16 else
             f" (limits rtol {FORWARD_RTOL}, atol {FORWARD_ATOL})"), flush=True)
    if not ok:
        raise AssertionError(f"stream_mphoi {what}: outside the limit: {gaps}")
    return gaps


def run_stream_mphoi(torch, dev, seed, dtype):
    """The stream_mphoi phase for one compute dtype (see the module's
    docstring). Returns the numbers it measured."""
    from tggcn_torch.models.registry import select_model
    from tggcn_torch.models.streaming import StreamingRunner

    bf16 = dtype != "float32"
    tag = "_bf16" if bf16 else ""
    model = select_model("2G-GCN", device=dev, compute_dtype=dtype, **STREAM_KWARGS)
    params = model.init(torch.Generator().manual_seed(seed))
    out = {}

    # A short stream, whole-stream lookahead: streamed equals offline.
    t, w = STREAM_SHORT["frames"], STREAM_SHORT["window"]
    request = stream_request(seed, t)
    offline, _ = model.apply(params, steps_per_example=np.full((1,), float(t), np.float32),
                             **request)
    runner = StreamingRunner(params, model.config, window=w, lookahead=t)
    reset_launches()
    streamed = runner.run(**request)
    launches = read_launches()
    windows = math.ceil(t / w)
    want = {f"gru_sequence{tag}": windows, f"segment_scan_dot{tag}": windows}
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"stream_mphoi short stream: launches {launches}, not {want}")
    out["short"] = dict(frames=t, window=w, lookahead=t, windows=windows,
                        launches={k: v for k, v in launches.items() if v}, **stream_gaps(
        torch, streamed, [o.cpu() for o in offline], f"{dtype} short stream, streamed vs "
        "offline (kernel route)", bf16))

    # tools/bench_streaming.py's stream: the kernel route timed and held
    # against the plain route.
    long = STREAM_LONG
    t = long["frames"]
    request = stream_request(seed + 1, t)
    kernel = StreamingRunner(params, model.config, window=long["window"],
                             lookahead=long["lookahead"], fuse_group=long["fuse_group"])
    plain = StreamingRunner(params, model.config, window=long["window"],
                            lookahead=long["lookahead"], fuse_group=long["fuse_group"],
                            use_kernels=False)
    got = kernel.run(**request)                                    # warm-up
    torch.cuda.synchronize(dev)
    on_card = {k: torch.as_tensor(v, device=dev) for k, v in request.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    times = {"host": [], "card": []}
    reset_launches()
    for _ in range(STREAM_REPS):
        for where, inputs in (("host", request), ("card", on_card)):
            start = time.perf_counter()
            kernel.run(**inputs)                                   # ends in a copy to the host
            times[where].append(time.perf_counter() - start)
    launches = read_launches()
    windows = math.ceil(t / long["window"])
    want = {f"gru_sequence{tag}": windows, f"segment_scan_dot{tag}": windows}
    if launches != {k: 2 * STREAM_REPS * want.get(k, 0) for k in launches}:
        raise AssertionError(f"stream_mphoi long stream: launches {launches}, not "
                             f"{2 * STREAM_REPS} x {want}")
    start = time.perf_counter()
    reference = plain.run(**request)
    plain_s = time.perf_counter() - start
    if read_launches() != launches:
        raise AssertionError("stream_mphoi: the plain route launched kernels")
    best = {k: min(v) for k, v in times.items()}
    out["long"] = dict(
        long, launches={k: v for k, v in launches.items() if v}, runs=2 * STREAM_REPS,
        windows=windows, seconds=best,
        frames_per_s={k: t / v for k, v in best.items()},
        window_ms={k: v / windows * 1e3 for k, v in best.items()}, plain_s=plain_s,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30, **stream_gaps(
            torch, got, reference, f"{dtype} long stream, kernel vs plain route", bf16))
    print(f"stream_mphoi{tag}: {t} frames, window {long['window']}, lookahead "
          f"{long['lookahead']}, fuse_group {long['fuse_group']}: inputs on the host "
          f"{out['long']['frames_per_s']['host']:.1f} frames/s, "
          f"{out['long']['window_ms']['host']:.3f} ms a window; inputs on the card "
          f"{out['long']['frames_per_s']['card']:.1f} frames/s, "
          f"{out['long']['window_ms']['card']:.3f} ms a window (best of {STREAM_REPS}, host "
          f"clock, outputs copied to the host); plain route {plain_s:.3f} s", flush=True)
    return out


def streamed_per_window(r, name):
    """A kernel's launches a streamed window, as the long stream's runs read them."""
    return r["launches"].get(name, 0) / (r["runs"] * r["windows"])


def baseline_per_call(model_name, r, name):
    """A kernel's launches in a baseline's CLI runs, as entry_baselines read
    them: a train step (K2), a forward of the train CLI (its steps and
    evaluation batches) and a predict batch (K1)."""
    if name == "gru_sequence_bwd":
        return (f", per {model_name} train step "
                f"{r['launches'].get(name, 0) / (r['epochs'] * r['steps_per_epoch']):g}")
    forwards = r["epochs"] * (r["steps_per_epoch"] + r["eval_batches_per_epoch"])
    return (f", per {model_name} train-CLI forward {r['launches'].get(name, 0) / forwards:g}"
            f", per {model_name} predict batch "
            f"{r['predict_launches'].get(name, 0) / r['predict_batches']:g}")


# K1 and K3: the kernels of a forward (an evaluation batch, a request).
FORWARD_KERNELS = ("gru_sequence", "segment_scan_dot")


def hold_predict_routes(torch, dev, loaded):
    """The test clips as one request on the kernel route and on the plain
    route, from the trained run's weights and the same Gumbel draws (a
    generator seeded 42, as the engine draws): compare_forward's bfloat16
    limits, and over each clip's frames the evaluation heads' labels equal
    except where the plain route's top-two margin lies within
    FORWARD_ATOL_BF16 (counted)."""
    model = loaded["model"]
    batch = next(iter(loaded["test_loader"]))
    data, _ = loaded["fetch"](batch)
    fed = loaded["feed"](data)

    def apply(use_kernels):
        return model.apply(loaded["params"], use_kernels=use_kernels,
                           generator=torch.Generator(device=dev).manual_seed(42), **fed)

    got, want = apply(True), apply(False)
    err, flips, dropped = compare_forward(torch, got, want, "entry_mphoi predict", bf16=True,
                                          rule=decision_rule(model.config))
    rows, _, _ = decision_rows(torch, got[1], want[1], "entry_mphoi predict", MARGINAL_BF16,
                               **decision_rule(model.config))
    steps = torch.as_tensor(np.asarray(data[7]), device="cpu").long()[rows]
    marginal = labels = 0
    for g, w in zip(got[0][-loaded["num_main"]:], want[0][-loaded["num_main"]:]):
        g, w = g.cpu()[rows], w.cpu()[rows]
        valid = (torch.arange(g.shape[2])[None, :] < steps[:, None])[..., None]
        differ = (g.argmax(1) != w.argmax(1)) & valid
        top2 = w.topk(2, dim=1).values
        margin = (top2[:, 0] - top2[:, 1])
        labels += int(valid.expand_as(differ).sum())
        if bool((differ & (margin > FORWARD_ATOL_BF16)).any()):
            raise AssertionError("entry_mphoi predict: a label differs between the routes "
                                 f"beyond the margin {FORWARD_ATOL_BF16}")
        marginal += int(differ.sum())
    r = dict(max_abs_err=err, flips=flips, dropped_rows=dropped, labels=labels,
             marginal_label_flips=marginal)
    print(f"entry_mphoi predict kernel vs plain route: max abs err {err:.3e} (limit "
          f"{FORWARD_ATOL_BF16}), marginal decision flips {flips} (batch rows left out "
          f"{dropped}), {marginal} of {labels} frame labels differ, each within a top-two "
          f"margin of {FORWARD_ATOL_BF16}", flush=True)
    return r


def time_predict_batch(torch, dev, loaded, reps=3):
    """A batch of ENTRY_PREDICT_BATCH clips (the test clips repeated) through
    the predict path's forward on the kernel route: clips/s (median of
    reps, host clock, each ended by a synchronize), peak memory, K1 and K3
    once a call."""
    from tggcn_torch.data.feeders import pad_batch

    model = loaded["model"]
    batch = next(iter(loaded["test_loader"]))
    repeat = math.ceil(ENTRY_PREDICT_BATCH / len(batch[0]))
    batch = [np.concatenate([x] * repeat)[:ENTRY_PREDICT_BATCH] for x in batch]
    data, _ = loaded["fetch"](pad_batch(batch, ENTRY_PREDICT_BATCH, 8))
    fed = {k: (None if v is None else torch.as_tensor(v, device=dev))
           for k, v in loaded["feed"](data).items()}

    def call():
        return model.apply(loaded["params"], generator=torch.Generator(device=dev).manual_seed(42),
                           **fed)

    call()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        call()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - start)
    launches = read_launches()
    if launches != {k: reps * (k in (f"{n}_bf16" for n in FORWARD_KERNELS)) for k in launches}:
        raise AssertionError(f"predict batch: launches {launches}")
    ms = statistics.median(times) * 1e3
    r = dict(batch=ENTRY_PREDICT_BATCH, t=int(fed["x_human"].shape[1]), ms=ms,
             clips_per_s=ENTRY_PREDICT_BATCH / ms * 1e3,
             peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    print(f"entry_mphoi predict batch: {json.dumps(r)}", flush=True)
    return r


# The entry_cad120 and entry_bimanual phases: each dataset's synthetic
# features (the generators' 2048-wide features, 16 clips of 360-500
# frames), its cross-validation fold and the overrides of its yaml widths
# (conf/models/2G-GCN_stage1.yaml's comments: CAD-120 hidden 512, batch 16,
# lr 1e-3, gcn_node 19, one human; Bimanual hidden 64, batch 32, lr 1e-3,
# gcn_node 30).
ENTRY_DATASETS = {
    "cad120": (dict(num_videos=16, min_len=360, max_len=500, num_objects=5), "Subject1",
               ("path", "path_zarr", "video_id_to_subject_id"),
               ["parameters.gcn_node=19", "parameters.message_humans_to_human=false",
                "optimization.batch_size=16", "optimization.learning_rate=1e-3"]),
    "bimanual": (dict(num_videos=16, min_len=360, max_len=500), "2",
                 ("path", "path_zarr", "path_bb_zarr", "path_hp_zarr", "video_id_to_video_fps"),
                 ["parameters.gcn_node=30", "parameters.hidden_size=64",
                  "optimization.batch_size=32", "optimization.learning_rate=1e-3"]),
}


def run_entry_2ggcn(torch, dev, seed, dataset):
    """The entry_cad120 or entry_bimanual phase (see the module's
    docstring): the 2G-GCN stage 1 through the train and predict CLIs on a
    synthetic dataset at the yaml's widths for the dataset, float32.
    Returns the numbers it measured."""
    import shutil
    import tempfile

    from tggcn_torch import predict as predict_cli
    from tggcn_torch.config import compose
    from tggcn_torch.data import synthetic
    from tggcn_torch.data.loading import determine_num_classes, load_training_data
    from tggcn_torch.eval.engine import load_run_model
    from tggcn_torch.eval.rundir import RunDir
    from tggcn_torch.models.tggcn import TGGCNConfig
    from tggcn_torch.train import cli

    sizes, subject, keys, widths = ENTRY_DATASETS[dataset]
    outputs = Path(__file__).resolve().parent / "outputs"
    outputs.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"entry_{dataset}_", dir=outputs))
    what = f"entry_{dataset}"
    try:
        start = time.perf_counter()
        paths = getattr(synthetic, f"generate_{dataset}_dataset")(str(work / "data"), seed=seed,
                                                                  **sizes)
        dataset_s = time.perf_counter() - start
        args = ["models=2G-GCN_stage1", f"data={dataset}", *(f"data.{k}={paths[k]}" for k in keys),
                f"data.cross_validation_test_subject={subject}", *widths,
                "optimization.epochs=2", f"logging.root_log_dir={work / 'runs'}"]
        cfg = compose(cli.CONF_DIR, overrides=args)
        epochs, batch_size = cfg.optimization.epochs, cfg.optimization.batch_size
        train_loader, val_loader, data_info, _ = load_training_data(
            cfg.data, "2G-GCN", "multiple", batch_size=batch_size,
            val_fraction=cfg.optimization.val_fraction)
        steps, evals = len(train_loader), len(train_loader) + len(val_loader)
        clips = dict(train_clips=train_loader.num_examples, val_clips=val_loader.num_examples)
        del train_loader, val_loader
        model_cfg = TGGCNConfig.from_kwargs(
            num_classes=determine_num_classes("2G-GCN", "multiple", dataset),
            **{**data_info, **cfg.parameters})
        step_kernels, _ = route_kernels(model_cfg, (None,) * 3, True, False)
        forward_kernels, _ = route_kernels(model_cfg, (None,) * 3, False, False)

        # The train CLI: each step launches the step's kernels once, each
        # evaluation batch the forward's.
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        start = time.perf_counter()
        checkpoint = cli.main(args)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - start
        launches = read_launches()
        want = {k: epochs * (steps * (k in step_kernels) + evals * (k in forward_kernels))
                for k in launches}
        if launches != want:
            raise AssertionError(f"{what} train: launches {launches}, not {want}")
        scalars = Path(cfg.logging.root_log_dir) / "runs" / cfg.logging.checkpoint_name
        records = [json.loads(line) for line in
                   (scalars / "scalars.jsonl").read_text().splitlines()]
        losses = [total for total, _ in checkpoint["train_losses"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: train losses {losses}")
        r = dict(dataset_s=dataset_s, hidden=cfg.parameters.hidden_size, batch=batch_size,
                 epochs=epochs, steps_per_epoch=steps, eval_batches_per_epoch=evals, **clips,
                 seconds=seconds, launches={k: v for k, v in launches.items() if v},
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30, train_losses=losses,
                 **{tag: [x["value"] for x in records if x["tag"] == f"perf/{tag}"]
                    for tag in ("train_seconds", "eval_seconds")})
        print(f"{what} train: {json.dumps(r)}", flush=True)

        # The predict CLI on the run dir: the forward's kernels once a batch.
        run_dir = str(Path(cfg.logging.root_log_dir) / cfg.logging.checkpoint_name)
        reset_launches()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as report:
            predict_cli.main(["--pretrained_model_dir", run_dir])
        torch.cuda.synchronize(dev)
        predict_s = time.perf_counter() - start
        launches = read_launches()
        loaded = load_run_model(RunDir(run_dir), dev)
        batches = math.ceil(loaded["test_loader"].num_examples / ENTRY_PREDICT_BATCH)
        if launches != {k: batches * (k in forward_kernels) for k in launches}:
            raise AssertionError(f"{what} predict: launches {launches}")
        lines = report.getvalue().splitlines()
        print(f"{what} predict: " + "; ".join(
            f"{a} {b}" for a, b in zip(lines, lines[1:]) if b.startswith("F1@")), flush=True)
        r.update(predict_s=predict_s, test_clips=loaded["test_loader"].num_examples,
                 predict_batches=batches,
                 predict_launches={k: v for k, v in launches.items() if v})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return r


# The train_dp phase: stage 1 at the full MPHOI width, TRAIN_STEPS eager
# steps from one init, in one process, in a group of one NCCL process, and
# on DP_RANKS gloo processes sharing the one card (NCCL takes one device a
# process); each step's noise from a generator seeded seed + step.
DP_RANKS = 2
DP_INIT_TIMEOUT_S = 240          # a gloo process's rendezvous and collectives


def leaves_digest(torch, tree):
    """sha256 of the bytes of every tensor of a tree, in tree order."""
    import hashlib

    h = hashlib.sha256()
    for x in tensor_leaves(tree).values():
        h.update(x.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_steps(torch, dev, seed, dtype, rows, mesh=None, record=False, sides=None):
    """TRAIN_STEPS eager stage-1 steps (tggcn_torch.train.loop.
    make_train_step, with the mesh where given) on the batch rows ``rows``
    of the seeded batch: each step's losses, ms, launches and a digest of
    every leaf (weights and BatchNorm state) after it; the first step's
    gradients and decisions (this process's rows), and the peak memory.
    With record, also the first step's ReLU inputs (relu_inputs) and K3's
    kept messages (scan_messages), this process's rows; with sides
    (kink_sides, this process's rows), the first step takes those sides of
    the flipped kinks."""
    from tggcn_torch.models import stage1
    from tggcn_torch.train.loop import make_train_step, trainable_parameters

    model, module, criterion, feeder, data, targets = train_setup(
        torch, dev, stage1.SHAPE, seed, dtype, "stage1")
    keep = torch.as_tensor(rows, device=dev)
    data, targets = [x[keep] for x in data], [y[keep] for y in targets]
    trainable = {"model": model.init(torch.Generator().manual_seed(0))}
    optimizer = torch.optim.Adam(trainable_parameters(trainable), lr=module.TRAIN["lr"])
    step = make_train_step(model, feeder, criterion, optimizer,
                           clip_gradient_at=module.TRAIN["clip"], mesh=mesh)
    out = dict(losses=[], ms=[], launches=[], digests=[])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    if sides:
        sides = [None if s is None else tuple(x.to(dev) for x in s) for s in sides]
    for i in range(TRAIN_STEPS):
        reset_launches()
        start = time.perf_counter()
        with (relu_inputs(sides) if i == 0 and (record or sides)
              else contextlib.nullcontext([])) as relus, \
                (scan_messages() if i == 0 and record else contextlib.nullcontext([])) as scan:
            losses, _, aux = step(trainable, data, targets,
                                  generator=torch.Generator(device=dev).manual_seed(seed + i))
        torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - start) * 1e3)
        out["launches"].append({k: v for k, v in read_launches().items() if v})
        out["losses"].append(losses.cpu())
        out["digests"].append(leaves_digest(torch, trainable))
        if i == 0:
            out["grads"] = {k: x.grad.detach().cpu() for k, x in tensor_leaves(trainable).items()
                            if x.grad is not None}
            out["aux"] = {k: tuple(x.detach().cpu() for x in aux[k])
                          for k in ("human_decisions", "object_decisions")}
            out["relus"] = [x.cpu() for x in relus] if record else None
            out["scan"] = [x.cpu() for call in scan for x in call] if record else None
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def dp_rank(rank, port, seed, dtype, rows, record, sides, out_dir):
    """One gloo process of the train_dp phase (spawned): join, run
    dp_steps with a mesh over the processes, leave its results in out_dir.
    Its own watchdog and the collectives' timeout end it if a peer hangs."""
    import os

    faulthandler.dump_traceback_later(PHASE_LIMIT_S["train_dp"], exit=True)
    os.environ["TGGCN_DIST_INIT_TIMEOUT"] = str(DP_INIT_TIMEOUT_S)
    import torch
    import torch.distributed as dist

    from tggcn_torch.parallel.distributed import maybe_initialize
    from tggcn_torch.parallel.mesh import make_mesh

    maybe_initialize(f"127.0.0.1:{port}", DP_RANKS, rank, device_type="cuda", backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    if sides:
        sides = [None if s is None else tuple(x.chunk(DP_RANKS)[rank] for x in s) for s in sides]
    out = dp_steps(torch, dev, seed, dtype, rows, make_mesh(DP_RANKS, "cuda"), record, sides)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_train_dp(torch, dev, seed, dtype):
    """The train_dp phase in one dtype (see the module's docstring).
    Returns the numbers it measured."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from tggcn_torch.models import stage1
    from tggcn_torch.parallel.distributed import maybe_initialize
    from tggcn_torch.parallel.mesh import make_mesh

    bf16 = dtype == "bfloat16"
    what = f"train_dp{'_bf16' if bf16 else ''}"
    loss_rtol, leaf_rtol = (LOSS_RTOL_BF16, LEAF_GRAD_RTOL_BF16) if bf16 else (LOSS_RTOL,
                                                                              LEAF_GRAD_RTOL)
    kernels = {f"{k}_bf16" if bf16 else k: 1 for k in TRAIN_KERNELS}
    rows = [True] * stage1.SHAPE["b"]
    # As the CAD-120 float32 step is held: a ReLU input within rounding of
    # its kink may fall either way (the processes' products see 4 rows,
    # the one process's 8).
    kinks = not bf16

    def gloo_ranks(rows, sides=None):
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(dp_rank, args=(free_port(), seed, dtype, rows, kinks, sides, tmp),
                               nprocs=DP_RANKS, join=True, start_method="spawn")
            return [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(DP_RANKS)]

    single = dp_steps(torch, dev, seed, dtype, rows, record=kinks)
    maybe_initialize(f"127.0.0.1:{free_port()}", 1, 0, device_type="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"{what}: the one-process group is {dist.get_backend()}")
        nccl = dp_steps(torch, dev, seed, dtype, rows, mesh=make_mesh(1, "cuda"))
    finally:
        dist.destroy_process_group()
    if nccl["digests"] != single["digests"] or not all(
            torch.equal(a, b) for a, b in zip(nccl["losses"], single["losses"])) or not all(
            torch.equal(g, single["grads"][k]) for k, g in nccl["grads"].items()):
        raise AssertionError(f"{what}: one NCCL process differs from one process without a "
                             f"group: losses {nccl['losses']} against {single['losses']}")
    print(f"{what}: one NCCL process equals one process bit for bit over {TRAIN_STEPS} steps "
          f"(losses, gradients, every leaf and the BatchNorm state)", flush=True)

    ranks = gloo_ranks(rows)
    aux = {k: tuple(torch.cat([r["aux"][k][i] for r in ranks]) for i in range(2))
           for k in ranks[0]["aux"]}
    keep, flips, dropped = decision_rows(torch, aux, single["aux"], what,
                                         MARGINAL_BF16 if bf16 else MARGINAL)
    if dropped:
        # A marginal flip: both sides again without its row and another,
        # so that the rows still split over the processes.
        rows = keep.tolist()
        rows[max(i for i, k in enumerate(rows) if k)] = False
        single = dp_steps(torch, dev, seed, dtype, rows, record=kinks)
        ranks = gloo_ranks(rows)
        aux = {k: tuple(torch.cat([r["aux"][k][i] for r in ranks]) for i in range(2))
               for k in ranks[0]["aux"]}
        if decision_rows(torch, aux, single["aux"], what, MARGINAL_BF16 if bf16 else MARGINAL
                         )[2]:
            raise AssertionError(f"{what}: decisions flip without the flipped row")
    for r, got in enumerate(ranks):
        if got["launches"] != [kernels] * TRAIN_STEPS:
            raise AssertionError(f"{what}: rank {r}'s steps launched {got['launches']}, not "
                                 f"{kernels} each")
        if got["digests"] != ranks[0]["digests"] or not all(
                torch.equal(a, b) for a, b in zip(got["losses"], ranks[0]["losses"])):
            raise AssertionError(f"{what}: rank {r} does not hold rank 0's bits after every step")
    got = ranks[0]
    equal_losses = all(torch.equal(a, b) for a, b in zip(got["losses"], single["losses"]))
    print(f"{what}: the processes' losses {'equal' if equal_losses else 'differ from'} one "
          f"process's bit for bit: {[x.tolist() for x in got['losses']]} against "
          f"{[x.tolist() for x in single['losses']]}", flush=True)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in single["grads"].values())

    def leaf_shares(grads):
        return {k: float((grads[k].double() - g.double()).abs().max())
                / max(float(g.abs().max()), floor) for k, g in single["grads"].items()}
    def model_share(grads):
        return max(float((grads[k].double() - g.double()).abs().max())
                   for k, g in single["grads"].items()) / (floor / GRAD_FLOOR)
    held, kink_flips, scan_flips, unheld = got, 0, 0, None
    limit = MODE_TRAIN_LIMITS["float32"]["model_share"]
    if kinks:
        relus = [torch.cat([r["relus"][i] for r in ranks]) for i in range(len(got["relus"]))]
        sides, kink_flips = kink_sides(torch, relus, single["relus"], what)
        scan = [torch.cat([r["scan"][i] for r in ranks], dim=2) for i in range(len(got["scan"]))]
        scan_flips = scan_kinks(torch, scan, single["scan"], what)
        if kink_flips or scan_flips:
            # The processes' step as it ran, over the whole model; then
            # again on the one process's side of each flipped MLP kink.
            unheld = model_share(got["grads"])
            print(f"{what}: {kink_flips} MLP and {scan_flips} K3 ReLU kink flips; the "
                  f"processes' step as it ran: largest difference {unheld:.3e} of the "
                  f"model's largest gradient", flush=True)
            if not unheld <= limit:
                raise AssertionError(f"{what}: the step as it ran differs beyond {limit} of "
                                     f"the model's largest gradient ({unheld:.3e})")
        if kink_flips:
            held = gloo_ranks(rows, sides)[0]
    loss_err = max(max_err(a, b) for a, b in zip(got["losses"], single["losses"]))
    if not all(bool(a.isfinite().all()) and torch.allclose(a, b, rtol=loss_rtol, atol=0)
               for a, b in zip(got["losses"], single["losses"])):
        raise AssertionError(f"{what}: losses {got['losses']} against one process's "
                             f"{single['losses']}")
    shares = leaf_shares(held["grads"])
    worst = max(shares, key=shares.get)
    whole = model_share(held["grads"])
    if scan_flips:
        # A kink flipped inside K3 cannot be taken to one side: the held
        # step is held over the whole model, as a K5 mode's step whose
        # recomputed ReLUs flip (MODE_TRAIN_LIMITS).
        if not whole <= limit:
            raise AssertionError(f"{what}: first-step gradients differ beyond {limit} of the "
                                 f"model's largest gradient: {whole:.3e}")
    elif not shares[worst] <= leaf_rtol:
        raise AssertionError(f"{what}: first-step gradients differ beyond {leaf_rtol} of a "
                             f"leaf's largest: {worst} {shares[worst]:.3e}")
    r = dict(ranks=DP_RANKS, rows=sum(rows), steps=TRAIN_STEPS, loss_err=loss_err,
             equal_losses=equal_losses,
             grad_share=shares[worst], grad_leaf=worst, flips=flips, dropped_rows=dropped,
             kink_flips=kink_flips, scan_kink_flips=scan_flips, unheld_model_share=unheld,
             model_share=whole,
             ms_per_rank=[statistics.median(x["ms"]) for x in ranks],
             peak_gib_per_rank=[x["peak_gib"] for x in ranks],
             single_ms=statistics.median(single["ms"]), single_peak_gib=single["peak_gib"],
             launches_per_step_per_rank=kernels,
             losses=[x.tolist() for x in got["losses"]])
    print(f"{what}: {DP_RANKS} gloo processes on one card: the same bits after every step; "
          f"against one process: losses {loss_err:.3e} (limit rtol {loss_rtol}), first-step "
          f"gradients {shares[worst]:.3e} of the leaf's largest ({worst}; limit {leaf_rtol} "
          f"where no kink flips inside K3), {whole:.3e} of the model's largest (limit {limit} "
          f"where one does); marginal ReLU kink flips: {kink_flips} in the MLPs, held on the one "
          f"process's side, {scan_flips} inside K3; "
          f"step ms per rank {r['ms_per_rank']} (one process {r['single_ms']:.3f}), peak GiB "
          f"per rank {r['peak_gib_per_rank']} (one process {r['single_peak_gib']:.3f}); "
          f"launches per step per rank {json.dumps(kernels)}", flush=True)
    return r


def run_dp_cli(torch):
    """python -m tggcn_torch.train with one device more than the host has
    must fail with make_mesh's ValueError."""
    cards = torch.cuda.device_count()
    run = subprocess.run([sys.executable, "-m", "tggcn_torch.train",
                          f"resources.num_devices={cards + 1}"], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parent)
    want = f"ValueError: Requested {cards + 1} devices, have {cards}"
    if run.returncode == 0 or want not in run.stderr:
        raise AssertionError(f"the train CLI with resources.num_devices={cards + 1}: rc "
                             f"{run.returncode}, {run.stderr[-2000:]}")
    print(f"train CLI resources.num_devices={cards + 1}: rc {run.returncode}, {want}", flush=True)


def run_small(torch, dev, seed):
    """Hidden-24 model: kernel path on the card against the plain path on the CPU."""
    from tggcn_torch.models import stage1
    from tggcn_torch.models.registry import select_model

    size = dict(b=2, t=12, humans=2, objects=4)
    kwargs = dict(stage1.MODEL_KWARGS, hidden_size=24)
    card = select_model("2G-GCN", device=dev, **kwargs)
    cpu = select_model("2G-GCN", device="cpu", **kwargs)
    rng = np.random.default_rng(seed)
    batch = stage1.make_request(rng, *size.values())
    batch.pop("human_segmentation")             # decisions by the 'gs' rule for everyone
    noise = {who: rng.gumbel(size=(size["b"], size["t"], size[n], 2)).astype(np.float32)
             for who, n in (("human", "humans"), ("object", "objects"))}
    # Both inits draw the same numbers: init_tggcn draws on the generator's
    # device (the CPU) and the model moves them to its own.
    got = card.apply(card.init(torch.Generator().manual_seed(3)), noise=noise, **batch)
    want = cpu.apply(cpu.init(torch.Generator().manual_seed(3)), noise=noise, **batch)
    return compare_forward(torch, got, want, "hidden-24 card vs CPU")


# The widths phase: the hidden widths the kernels do not all take (6 in
# both dtypes, 100 in bfloat16, 510 in both), run at the next width they
# take (tggcn_torch/ops/widths.py), each beside the aligned MPHOI width;
# the whole model's bfloat16 step at WIDTH_STEP_HIDDEN and a baseline epoch
# at WIDTH_BASELINE_HIDDEN.
WIDTHS = (6, 100, 510)
WIDTH_KERNELS = ("k1", "k2", "k3", "k4", "k5_v1", "k5_v4", "k5_ext")
WIDTH_STEP_HIDDEN, WIDTH_BASELINE_HIDDEN = 510, 126
# The bfloat16 step at WIDTH_STEP_HIDDEN is held over the whole model, as a
# K5 mode's (MODE_TRAIN_LIMITS) and with the CAD-120 bfloat16 step's limit
# (LIMITS_CAD120_BF16). A leaf's largest difference holds no correct route
# here: one small leaf (update_object_segment_mlp's bias, 8.5e-4 of the
# model's largest gradient) lies 4.76e-2 of itself from the plain route and
# 4.27e-2 from the plain route with float64 sums, and at h = 512, on the
# unpadded route, the kernel route lies 4.72e-2 from the float64 sums route
# on a leaf (LIMITS_BF16's 3.9e-2 was set from one reading at 512). Readings
# (H100 80GB HBM3, 700 W, seed 0), model_rel_l2: kernel vs plain 5.27e-3,
# kernel vs float64 sums 5.35e-3, plain vs float64 sums 5.30e-3; a rounded
# carry 1.55e-2 (seed 1) and 1.58e-2 (h = 512).
WIDTH_STEP_LIMITS = {"bfloat16": LIMITS_CAD120_BF16["train"]}
WIDTH_TIMING_REPS = 3
# The bfloat16 checks whose MPHOI limit (LIMITS_BF16, set at h = 512) a
# rounded carry stays under at a narrower width, each with a limit of its
# width between that width's readings: {(kind, h): limits}. Readings (H100
# 80GB HBM3, 700 W), kernel / float64 sums / rounded carry, rel_l2:
#   K3 h=6 5.56e-5 / 5.56e-5 / 2.21e-3 (against LIMITS_BF16's 2.25e-3)
#   K5 v4 h=6 6.9e-10 / 5.85e-5 / 2.17e-3, h=100 9.94e-4 / 1.34e-3 / 2.14e-3
#      (against 2.4e-3)
# Narrow products sum few terms, so a correct version lies closer to the
# plain one, while a carry rounded every step lies as far as at h = 512.
WIDTH_LIMITS_BF16 = {("k3", 6): {"rel_l2": 5e-4}, ("k5_v4", 6): {"rel_l2": 5e-4},
                     ("k5_v4", 100): {"rel_l2": 1.7e-3}}


def width_case(torch, dev, kind, h, dtype):
    """One of K1-K5 (kind, as WIDTH_KERNELS) at width h in dtype on the
    inputs of its k phase at the MPHOI shape: (its wrapper, the kernel's
    call, the plain version's call, the serving call and its plain
    counterpart or None). Each call returns a list of tensors; the plain
    versions are reached through their modules, where control patches
    them."""
    import tggcn_torch.ops.gru_sequence as gru_ops
    import tggcn_torch.ops.segment_scan as scan_ops
    from tggcn_torch.profile_gru import gru_bwd_inputs, gru_inputs
    from tggcn_torch.profile_scan import bwd_inputs, mode_inputs, scan_inputs

    shape = stage_module("stage1").SHAPE
    t, b, nh, no = (shape[k] for k in ("t", "b", "humans", "objects"))
    seed = {"k1": 1, "k2": 4, "k3": 2, "k4": 5}.get(kind, 6)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind in ("k1", "k2"):
        s, nr = 6, 3
        fwd = tuple(x.to(dtype) for x in gru_inputs(dev, gen, t, s, b * no, h))
        if kind == "k1":
            return (gru_ops.gru_sequence,
                    lambda: list(gru_ops.gru_sequence(*fwd, nr, keep=True)),
                    lambda: list(gru_ops.gru_sequence_plain(*fwd, nr, keep=True)),
                    lambda: [gru_ops.gru_sequence(*fwd, nr)],
                    lambda: [gru_ops.gru_sequence_plain(*fwd, nr)])
        args = gru_bwd_inputs(*fwd, nr, gen)
        return (gru_ops.gru_sequence_bwd, lambda: list(gru_ops.gru_sequence_bwd(*args, nr)),
                lambda: list(gru_ops.gru_sequence_bwd_plain(*args, nr)), None, None)
    scale = 1.0 / math.sqrt(h)
    fwd = scan_inputs(dev, gen, t, b, nh, no, h)
    if kind.startswith("k5"):
        mode = kind[3:]
        extra = {k: v.to(dtype) for k, v in mode_inputs(mode, fwd, gen).items()}
        fwd = {k: v.to(dtype) for k, v in fwd.items()}
        wrapper = getattr(scan_ops, f"segment_scan_{mode}")
        return (wrapper, lambda: list(wrapper(**fwd, **extra)),
                lambda: list(scan_ops.segment_scan_att_plain(mode, **fwd, **extra)), None, None)
    fwd = {k: v.to(dtype) for k, v in fwd.items()}
    if kind == "k3":
        return (scan_ops.segment_scan_dot,
                lambda: list(scan_ops.segment_scan_dot(**fwd, scale=scale)),
                lambda: list(scan_ops.segment_scan_dot_plain(**fwd, scale=scale)),
                lambda: list(scan_ops.segment_scan_dot(**fwd, scale=scale, keep=False)),
                lambda: list(scan_ops.segment_scan_dot_plain(**fwd, scale=scale)[:3]))
    args = bwd_inputs(fwd, gen, scale)
    outputs = lambda grads: [grads[k] for k in scan_ops.BWD_OUTPUTS]
    return (scan_ops.segment_scan_dot_bwd,
            lambda: outputs(scan_ops.segment_scan_dot_bwd(**args, scale=scale)),
            lambda: outputs(scan_ops.segment_scan_dot_bwd_plain(**args, scale=scale)), None, None)


def hold_width(torch, kind, h, name, bf16, got, want, plain):
    """got against want at the limits of kind's k phase: float32 forward
    KERNEL_ATOL, backward KERNEL_GRAD_RTOL of each output's largest;
    bfloat16 forward one ulp of each output's largest, K2 GRU_GRAD_RTOL_BF16
    and K4 SCAN_GRAD_RTOL_BF16 of it, each with its controls (LIMITS_BF16,
    or at a width where they cannot fail WIDTH_LIMITS_BF16). Returns the
    measures."""
    backward = kind in ("k2", "k4")
    if not bf16:
        if backward:
            err, rel = check_grads(name, got, want)
            return dict(max_abs_err=err, max_rel_err=rel)
        return dict(max_abs_err=check_kernel(name, got, want))
    if backward:
        err, rel = check_grads(name, got, want,
                               GRU_GRAD_RTOL_BF16 if kind == "k2" else SCAN_GRAD_RTOL_BF16)
        out = dict(max_abs_err=err, max_rel_err=rel)
    else:
        err, ulps = check_kernel_bf16(torch, name, got, want)
        out = dict(max_abs_err=err, ulps=ulps)
    limits = WIDTH_LIMITS_BF16.get((kind, h), LIMITS_BF16[kind])
    return dict(out, **check_controls(name, tensor_gaps, plain, got, want, limits))


@contextlib.contextmanager
def padding_copies(torch):
    """The padding's copies in the K1-K5 wrappers while the block runs:
    {kernels: each widen's copy and zeroing an axis and each narrow's copy
    (ops/widths.py), pairs: the CUDA events recorded around each}. The
    profiler's kernel events are not used: a window late in this run can
    miss many of them (the splits of its widths phase lost a tenth of the
    step kernels, and every kernel of some calls)."""
    import tggcn_torch.ops.gru_sequence as gru_ops
    import tggcn_torch.ops.segment_scan as scan_ops
    from tggcn_torch.ops import widths

    seen = dict(kernels=0, pairs=[])

    def timed(fn, kernels):
        def run(x, h, hp, axes=widths.LAST):
            if hp == h:
                return fn(x, h, hp, axes)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(x, h, hp, axes)
            end.record()
            seen["kernels"] += kernels(axes)
            seen["pairs"].append((start, end))
            return out
        return run

    saved = [(m, name, getattr(m, name)) for m in (gru_ops, scan_ops) for name in ("widen",
                                                                                 "narrow")]
    for m, name, fn in saved:
        setattr(m, name, timed(fn, (lambda axes: 1 + len(axes)) if name == "widen"
                               else (lambda axes: 1)))
    try:
        yield seen
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def run_widths(torch, dev, seed):
    """The widths phase (see the module's docstring). Returns its numbers."""
    from tggcn_torch.ops.widths import aligned

    aligned_h = stage_module("stage1").MODEL_KWARGS["hidden_size"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        counter = "launches_bf16" if bf16 else "launches"
        for kind in WIDTH_KERNELS:
            tag = kind + ("_bf16" if bf16 else "")
            wrapper, call, _, _, _ = width_case(torch, dev, kind, aligned_h, dtype)
            base_ms = cuda_ms(torch, call, WIDTH_TIMING_REPS, spin=True)
            del call
            rows = {}
            for h in WIDTHS:
                wrapper, call, plain, serve, serve_plain = width_case(torch, dev, kind, h, dtype)
                name = f"widths {tag} h={h}"
                before = getattr(wrapper, counter)
                with padding_copies(torch) as copies:
                    # Behind a wait on the card, so that the copies' events
                    # time the card's work, not the host's launches.
                    torch.cuda._sleep(SPIN_CYCLES)
                    got = call()
                torch.cuda.synchronize(dev)
                launches = getattr(wrapper, counter) - before
                if launches != 1:
                    raise AssertionError(f"{name}: the wrapper launched its kernel {launches} "
                                         "times, not once")
                want = plain()
                row = hold_width(torch, kind, h, name, bf16, got, want, plain)
                if serve is not None:
                    served = serve()
                    row["served_max_abs_err"] = (
                        check_kernel_bf16(torch, f"{name} serving", served, serve_plain())[0]
                        if bf16 else check_kernel(f"{name} serving", served, serve_plain()))
                del got, want
                row.update(runs_at=aligned(h, dtype),
                           ms=cuda_ms(torch, call, WIDTH_TIMING_REPS, spin=True),
                           kernel_launches_a_call=launches, copy_kernels=copies["kernels"],
                           copy_ms=sum(a.elapsed_time(b) for a, b in copies["pairs"]))
                print(f"{name} (runs at {row['runs_at']}): ms {row['ms']:.3f} (aligned "
                      f"h={aligned_h}: {base_ms:.3f}); a call launches the kernel once, as at "
                      f"h={aligned_h}, and {row['copy_kernels']} padding copy kernels, "
                      f"{row['copy_ms']:.3f} ms (CUDA events around each widen and narrow, "
                      f"behind a wait on the card)", flush=True)
                rows[h] = row
                del call, plain, serve, serve_plain
            out[tag] = dict(aligned=dict(h=aligned_h, ms=base_ms), widths=rows)
    step = run_train(torch, dev, stage_module("stage1").SHAPE, seed, dtype="bfloat16",
                     hidden=WIDTH_STEP_HIDDEN)
    print_train(f"widths train_bf16 hidden {WIDTH_STEP_HIDDEN}", step)
    out["train_bf16"] = {k: step[k] for k in ("ms", "losses", "grad_rel", "launches",
                                              "equal_leaves", "peak_gib")}
    baseline = run_entry_baselines(torch, dev, seed, models=("cad120_baseline",),
                                   hidden=WIDTH_BASELINE_HIDDEN, epochs=1, golden=False)
    out["entry_baseline"] = baseline["cad120_baseline"]
    return out


def run_entry_switches(torch, dev, seed):
    """The entry_switches phase (see the module's docstring). Returns its
    numbers."""
    import shutil
    import tempfile

    from tggcn_torch.data.synthetic import generate_mphoi_dataset
    from tggcn_torch.profile_step import group_of
    from tggcn_torch.train import cli

    outputs = Path(__file__).resolve().parent / "outputs"
    outputs.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="entry_switches_", dir=outputs))
    out = {}
    try:
        paths = generate_mphoi_dataset(str(work / "data"), seed=seed, **ENTRY_DATASET)

        def overrides(root, *extra, data=paths):
            return ["models=2G-GCN_stage1", "data=mphoi",
                    *(f"data.{k}={data[k]}" for k in ("path", "path_zarr", "path_obb_zarr",
                                                        "path_hbb_zarr", "path_hps_zarr")),
                    "data.cross_validation_test_subject=Subject45",
                    "parameters.compute_dtype=bfloat16", "optimization.epochs=2",
                    f"logging.root_log_dir={work / root}", *extra]

        def run(name, args):
            torch.cuda.synchronize(dev)
            start = time.perf_counter()
            checkpoint = cli.main(args)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - start
            print(f"entry_switches {name}: {seconds:.3f} s, train losses "
                  f"{[total for total, _ in checkpoint['train_losses']]}", flush=True)
            return checkpoint, seconds

        # The trace: one Chrome trace of the two epochs, K1-K4 among its kernels.
        trace_dir = work / "trace" / "new"
        traced, out["traced_s"] = run("jax_profiler_dir", overrides(
            "traced", f"resources.jax_profiler_dir={trace_dir}"))
        files = sorted(p.name for p in trace_dir.iterdir())
        if files != [cli.TRACE_FILE.format(rank=0)]:
            raise AssertionError(f"the trace dir holds {files}")
        trace_file = trace_dir / files[0]
        events = json.loads(trace_file.read_text())["traceEvents"]
        groups = {}
        for e in events:
            if e.get("cat") == "kernel":
                group = group_of(e.get("name", ""))
                groups[group] = groups.get(group, 0) + 1
        out["trace"] = dict(mib=trace_file.stat().st_size / 2 ** 20, events=len(events),
                            kernels_by_group=groups)
        print(f"entry_switches trace: {json.dumps(out['trace'])}", flush=True)
        missing = [g for g in FUSED_GROUPS if not groups.get(g)]
        if missing:
            raise AssertionError(f"the trace names no kernel of {missing}")

        # debug_nans on the clean dataset: the same losses, bit for bit.
        checked, out["debug_nans_s"] = run("debug_nans", overrides(
            "checked", "resources.debug_nans=true"))
        for key in ("train_losses", "val_losses"):
            if checked[key] != traced[key]:
                raise AssertionError(f"debug_nans changed the {key}: {checked[key]} against "
                                     f"{traced[key]}")
        out["losses"] = traced["train_losses"]

        # A clip whose features are +inf (the loader turns a NaN feature into
        # 0, and +inf into the largest float32, whose products overflow): the
        # first step that meets it raises.
        poisoned = generate_mphoi_dataset(str(work / "poisoned"), seed=seed, **ENTRY_DATASET)
        with np.load(poisoned["path_zarr"]) as f:
            stores = dict(f)
        stores["Subject12-task-take1/Human1"][:] = np.inf
        np.savez(poisoned["path_zarr"], **stores)
        try:
            run("debug_nans poisoned", overrides("poisoned_run", "resources.debug_nans=true",
                                                 data=poisoned))
        except FloatingPointError as e:
            out["raised"] = str(e)
        else:
            raise AssertionError("debug_nans did not raise on a clip that makes NaN losses")
        print(f"entry_switches debug_nans raised: {out['raised']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from tggcn_torch.models import stage1, stage2  # fail outside a checkout of the repository
    from tggcn_torch.ops import _build

    dev = torch.device("cuda", 0)
    with phase("device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
              flush=True)
    with phase("build"):
        seconds = _build.build()
        print(f"build seconds {json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
              flush=True)
        from tggcn_torch.ops.segment_scan import scan_occupancy

        wg = {}
        for name in _build.SOURCES:
            log = _build.library_path(name).with_suffix(".log")
            if log.exists():
                print(log.read_text().strip(), flush=True)
                wg.update(ptxas_report(log.read_text(), WG_KERNELS))
        gru = {}
        for name in ("gru_sequence", "gru_sequence_bwd"):
            gru.update(ptxas_report(_build.library_path(name).with_suffix(".log").read_text(),
                                    GRU_CLUSTER_KERNELS))
        print(f"build GRU cluster kernels (registers, static smem and spills from -Xptxas -v): "
              f"{json.dumps(gru)}", flush=True)
        if sorted(gru) != sorted(GRU_CLUSTER_KERNELS):
            raise AssertionError(f"the build log lacks a GRU cluster kernel: {sorted(gru)}")
        k4 = ptxas_report(_build.library_path("segment_scan_bwd").with_suffix(".log").read_text(),
                          K4_BF16_KERNELS)
        print(f"build K4 bfloat16 kernels (registers, static smem and spills from -Xptxas -v): "
              f"{json.dumps(k4)}", flush=True)
        if sorted(k4) != sorted(K4_BF16_KERNELS):
            raise AssertionError(f"the build log lacks a K4 bfloat16 kernel: {sorted(k4)}")
        occ = scan_occupancy("dot", torch.bfloat16, stage1.SHAPE["b"], stage1.SHAPE["humans"],
                             stage1.SHAPE["objects"], stage1.MODEL_KWARGS["hidden_size"])
        for kernel, phase_ in zip(WG_KERNELS, ("proj", "cell")):
            wg.setdefault(kernel, {})["dynamic_smem"] = occ[phase_][2]
        print(f"build wgmma kernels (registers, static smem and spills from -Xptxas -v; "
              f"dynamic smem at the MPHOI shape from the occupancy query): {json.dumps(wg)}",
              flush=True)
        if any("registers" not in v for v in wg.values()):
            raise AssertionError(f"the build log lacks a wgmma kernel: {sorted(wg)}")
    shape, hidden = stage1.SHAPE, stage1.MODEL_KWARGS["hidden_size"]
    gru_shape = (shape["t"], 6, shape["b"] * shape["objects"], hidden)
    scan_shape = (*(shape[k] for k in ("t", "b", "humans", "objects")), hidden)
    geo_shape = (shape["b"] * shape["t"], stage1.MODEL_KWARGS["gcn_node"])
    kernels = []
    bf16 = getattr(torch, stage1.BENCH_DTYPE)
    for name, run, at in (("k1", run_k1, gru_shape), ("k2", run_k2, gru_shape),
                          ("k3", run_k3, scan_shape), ("k4", run_k4, scan_shape),
                          ("k5_v1", partial(run_k5, "v1"), scan_shape),
                          ("k5_v4", partial(run_k5, "v4"), scan_shape),
                          ("k5_ext", partial(run_k5, "ext"), scan_shape),
                          ("k6", run_k6, geo_shape),
                          ("k1_bf16", partial(run_k1, dtype=bf16), gru_shape),
                          ("k2_bf16", partial(run_k2, dtype=bf16), gru_shape),
                          ("k3_bf16", partial(run_k3, dtype=bf16), scan_shape),
                          ("k4_bf16", partial(run_k4, dtype=bf16), scan_shape),
                          ("k5_v1_bf16", partial(run_k5, "v1", dtype=bf16), scan_shape),
                          ("k5_v4_bf16", partial(run_k5, "v4", dtype=bf16), scan_shape),
                          ("k5_ext_bf16", partial(run_k5, "ext", dtype=bf16), scan_shape)):
        with phase(name):
            kernels.append(run(torch, dev, at))
            print(f"{name} {json.dumps(kernels[-1])}", flush=True)
    fwd, train, train2 = {}, {}, {}
    for dtype, tag in (("float32", ""), (stage1.BENCH_DTYPE, "_bf16")):
        with phase(f"forward{tag}"):
            fwd[dtype] = r = run_forward(torch, dev, shape, args.seed, dtype=dtype)
            print_forward(f"forward{tag}", r, REQUESTS)
    for stage, into in (("stage1", train), ("stage2", train2)):
        for dtype, tag in (("float32", ""), (stage_module(stage).BENCH_DTYPE, "_bf16")):
            name = f"train{'_' + stage if stage != 'stage1' else ''}{tag}"
            with phase(name):
                into[dtype] = r = run_train(torch, dev, shape, args.seed, dtype=dtype,
                                            stage=stage)
                print_train(name, r)
    with phase("forward_stage2"):
        fwd2 = run_forward(torch, dev, shape, args.seed, stage="stage2", requests=1)
        print_forward("forward_stage2", fwd2, 1)
    with phase("forward_stage2_features"):
        for variant in stage2.FEATURE_VARIANTS:
            r = run_forward(torch, dev, shape, args.seed, variant, stage="stage2", requests=1)
            print_forward(f"forward_stage2 {variant}", r, 1)
    with phase("serve_modes"):
        served = {}
        for variant in stage1.SERVE_VARIANTS:
            served[variant] = run_forward(torch, dev, shape, args.seed, variant)
            r = served[variant]
            print_forward(f"serve {variant}:", r, REQUESTS)
    with phase("serve_modes_bf16"):
        served_bf16 = {}
        for variant in stage1.SERVE_VARIANTS:
            served_bf16[variant] = r = run_forward(torch, dev, shape, args.seed, variant,
                                                   dtype=stage1.BENCH_DTYPE, requests=1)
            print_forward(f"serve_bf16 {variant}:", r, 1)
    for dtype, tag in (("float32", ""), (stage1.BENCH_DTYPE, "_bf16")):
        with phase(f"train_modes{tag}"):
            for variant in stage1.SERVE_VARIANTS:
                r = run_train(torch, dev, shape, args.seed, dtype=dtype, variant=variant)
                print_train(f"train_modes{tag} {variant}", r)
                print(f"train_modes{tag} {variant}: per step K5 "
                      f"{r['launches'][MODE_KERNEL[variant] + tag] / r['steps']:g}, K6 "
                      f"{r['launches']['geo_gcn_fused'] / r['steps']:g} launches; recompute "
                      f"backward {r['recompute_ms']:.3f} ms of a {r['ms']:.3f} ms step",
                      flush=True)
    with phase("sync_free"):
        run_sync_free(torch, dev, shape, args.seed)
    for name, dtype, stage in (("train_fused", "float32", "stage1"),
                               ("train_fused_bf16", stage1.BENCH_DTYPE, "stage1"),
                               ("train_fused_stage2_bf16", stage2.BENCH_DTYPE, "stage2")):
        with phase(name):
            print_train_fused(name, run_train_fused(torch, dev, shape, args.seed, dtype, stage))
    cad, cad_shape = stage_module("cad120"), stage_module("cad120").SHAPE
    fwd_cad, train_cad = {}, {}
    for dtype, tag in (("float32", ""), (cad.BENCH_DTYPE, "_bf16")):
        with phase(f"forward_cad120{tag}"):
            fwd_cad[dtype] = r = run_forward(torch, dev, cad_shape, args.seed, dtype=dtype,
                                             stage="cad120", requests=1)
            print_forward(f"forward_cad120{tag}", r, 1)
    with phase("forward_cad120_dist"):
        r = run_forward(torch, dev, cad_shape, args.seed, "dist", stage="cad120", requests=1)
        print_forward("forward_cad120_dist", r, 1)
    for dtype, tag in (("float32", ""), (cad.BENCH_DTYPE, "_bf16")):
        with phase(f"train_cad120{tag}"):
            train_cad[dtype] = r = run_train(torch, dev, cad_shape, args.seed, dtype=dtype,
                                             stage="cad120")
            print_train(f"train_cad120{tag}", r)
    with phase("train_cad120_dist"):
        r = run_train(torch, dev, cad_shape, args.seed, stage="cad120", variant="dist")
        print_train("train_cad120_dist", r)
    with phase("train_fused_cad120_bf16"):
        print_train_fused("train_fused_cad120_bf16",
                          run_train_fused(torch, dev, cad_shape, args.seed, cad.BENCH_DTYPE,
                                          "cad120", profiled_steps=FUSED_PROFILED_CAD120,
                                          eager_window=EAGER_WINDOW_CAD120))
    with phase("forward_general_variants"):
        run_general_variants(torch, dev, args.seed)
    with phase("entry_mphoi"):
        entry = run_entry_mphoi(torch, dev, args.seed)
        print(f"entry_mphoi {json.dumps(entry)}", flush=True)
    for dataset in ENTRY_DATASETS:
        with phase(f"entry_{dataset}"):
            r = run_entry_2ggcn(torch, dev, args.seed, dataset)
            print(f"entry_{dataset} {json.dumps(r)}", flush=True)
    with phase("entry_baselines"):
        baselines = run_entry_baselines(torch, dev, args.seed)
        print(f"entry_baselines {json.dumps(baselines)}", flush=True)
    with phase("stream_mphoi"):
        stream = {dtype: run_stream_mphoi(torch, dev, args.seed, dtype)
                  for dtype in ("float32", stage1.BENCH_DTYPE)}
        print(f"stream_mphoi {json.dumps(stream)}", flush=True)
    with phase("train_dp"):
        dp = {dtype: run_train_dp(torch, dev, args.seed, dtype)
              for dtype in ("float32", stage1.BENCH_DTYPE)}
        print(f"train_dp {json.dumps(dp)}", flush=True)
        run_dp_cli(torch)
    with phase("bench_short"):
        run_bench_short(torch)
    # K1-K4's launches are the stage-1 train steps' (of their dtype); K5's
    # and K6's the serving modes' (K5's bfloat16 variant's the bfloat16 ones).
    for k in kernels:
        base = k["name"].removesuffix("_bf16")
        if base in TRAIN_KERNELS:
            dtype = "bfloat16" if k["name"].endswith("_bf16") else "float32"
            k["launches"] = train[dtype]["launches"][k["name"]]
            per = (f"per {dtype} train step {k['launches'] / TRAIN_STEPS:g}, per {dtype} "
                   f"stage-2 train step {train2[dtype]['launches'][k['name']] / TRAIN_STEPS:g}, "
                   f"per {dtype} stage-1 request {fwd[dtype]['launches'][k['name']] / REQUESTS:g}, "
                   f"per {dtype} CAD-120 train step "
                   f"{train_cad[dtype]['launches'][k['name']] / TRAIN_STEPS:g}, per {dtype} "
                   f"CAD-120 request {fwd_cad[dtype]['launches'][k['name']]:g}, per {dtype} "
                   f"streamed window {streamed_per_window(stream[dtype]['long'], k['name']):g}, "
                   f"per {dtype} data-parallel step on each of {dp[dtype]['ranks']} processes "
                   f"{dp[dtype]['launches_per_step_per_rank'][k['name']]:g}")
            if dtype == "float32" and base in ("gru_sequence", "gru_sequence_bwd"):
                per += "".join(baseline_per_call(name, baselines[name], k["name"])
                               for name in BASELINE_DATASETS)
        else:
            pool, n = (served_bf16, 1) if k["name"].endswith("_bf16") else (served, REQUESTS)
            k["launches"] = sum(r["launches"][k["name"]] for r in pool.values())
            per = "per request " + ", ".join(
                f"{v} {r['launches'][k['name']] / n:g}" for v, r in pool.items())
        kind = ("gru" if k["name"].startswith("gru") else
                "geo" if k["name"].startswith("geo") else "scan")
        library = (f"library_ms {k['library_ms']:.3f}: {LIBRARY[base]}"
                   if k["library_ms"] is not None else f"library_ms none: {NO_LIBRARY[kind]}")
        print(f"kernel {k['name']}: kernel_ms {k['ms']:.3f} plain_ms {k['plain_ms']:.3f} "
              f"bound_ms {k['bound_ms']:.3f} ({k['bound_by']}; {k['bound_fma_ms']:.3f} with the "
              f"products on the FMA units) launches {per}; {library}", flush=True)
    with phase("small"):
        err, flips, dropped = run_small(torch, dev, args.seed)
        print(f"hidden-24 card vs CPU: max abs err {err:.3e}, marginal flips {flips} "
              f"(batch rows left out {dropped})", flush=True)
    with phase("widths"):
        print(f"widths {json.dumps(run_widths(torch, dev, args.seed))}", flush=True)
    with phase("entry_switches"):
        print(f"entry_switches {json.dumps(run_entry_switches(torch, dev, args.seed))}",
              flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
