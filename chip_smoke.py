#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mft_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``--kernels-only`` stops after phase 3;
``--mesh-scaling`` builds the kernels, then runs only the eval's mesh on 1, 2, 4, ... of the visible
cards; ``--pipeline`` builds the kernels, then runs only the synthetic pipeline at the JAX script's
defaults: see phase 7; ``--distributed``, on four cards, builds the kernels, then runs only the
data-parallel dry run, ``mft_tpu_torch.parallel.dryrun --full`` over nccl at world 2 and 4: see
phase 4).  It needs a
CUDA card, ``nvcc`` (CUDA_HOME, default /usr/local/cuda) and nothing else
of the JAX package; it imports no ``jax``.  Phases, any failure exits
non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``mft_tpu_torch/kernels/csrc``
   (one nvcc per source, started together) and print the build seconds and
   the ptxas resource report;
3. hold every kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (random inputs from a seeded generator),
   with the stated tolerance, and time both: the GNN edge kernel (the main
   path's three widths, the training path's B = 16 graphs at the same
   widths with the op's gradient there and its plain backward's device time,
   the 50-shot paths' N = 130 graphs (eval B = 15, train_50 B = 16 with its
   gradient and plain backward) and ragged shapes; device time by
   the profiler beside the wrapper's CUDA-event time, the function's bound
   beside the work of its tensor-core route and the f32 bound, the kernel
   against the plain emulation of its own three-term split, a planted
   one-term bf16 fault, the HGMMA count of its library, cuBLAS's f32 product
   on the materialized edges as a yardstick), and the fused inner
   scan (one step's gradients, the update rule
   step by step on both lanes of a two-lane call, a 20-step scan with f32
   and bf16 carry on one and two lanes with planted faults beside it to
   show what its bound catches; each of the seven tensor-core products of a
   step alone against the plain product, timed beside the PyTorch
   convolution call, with a planted fault of its own; one step's gradients
   by the tensor-core route against the FMA route; the full 500-step scan
   with the host's enqueue time, the device time per kernel and the step's
   L2 traffic beside it; then the same checks on the 50-shot bank of 5000
   rows, the first steps gathering its last rows, and the 5000-step scan
   timed beside its bound; then the scan on the five lanes of an
   ``--eval_batch 5`` call, each with its own 500-row bank and schedule: the
   update rule step by step on every lane, 20-step scans against the bound
   with planted lane faults (lane 0 on its neighbour's bank or schedule), and
   the 500-step five-lane scan timed beside one lane; the same checks and
   timing on the benchmark cells' 20 lanes, with each lane of a 20-step call
   bit for bit against its single-lane call; and the edge kernel on
   a lane batch's B = 75 graphs at N = 30 and N = 130); and the scan at the
   synthetic pipeline's geometry (ResNet10's final block at 64 px, 4x4x256 ->
   2x2x512, 20 rows a step) under the bf16 rules and their planted faults;
4. check the eval on the card against the same eval on the CPU at a small
   size (strict f32 with the eager inner loop; then the fused scan on the
   card against its plain version on the CPU; then the faithful
   ``bn_mode='minibatch'`` eval), few inner steps; then three episodes as
   one lane batch on the card against the same episodes one at a time on
   the CPU (64 px, strict f32 eager, then the fused scan; each beside a
   planted fault, BN statistics over all lanes, that it must catch), and
   the same in the faithful ``--bn_mode minibatch`` (eager, 0 and 1 inner
   epochs, beside its own planted fault: the trunk's BN statistics pooled
   over the lanes); then one
   step of each training stage (baseline, episodic GnnNet with the edge
   kernel, the meta fine-tune with a fixed inner schedule, the 50-shot
   GnnNet step of ``cli.train_50``) on the card against the CPU at 64 px:
   loss, gradients, updates, running stats; DampNet's steps and eval member,
   and DampNet's ``nofinetune`` (with the probe) and ``--unsupervised``
   compositions as a three-lane batch on the card against each episode
   alone on the CPU (64 px; a planted fault, one probe head init shared by
   all lanes, must fail);
   then the other backbones: one ResNet10_FW episodic GnnNet step with its
   FWT noise drawn once on the host and fed to both devices (its noise
   strengths' updates exactly 0 on both; the noise dropped on the final
   block, planted on the card, must fail), and a ResNet18 lane batch against
   its episodes alone on the CPU (its identity shortcuts dropped, planted,
   must fail); then an nccl process group of world 1 in this process: one
   episodic GnnNet step of two episodes (224 px) and one ``--method all
   --inner_scan fused`` lane batch through the group path, each bit-equal
   to the ``group=None`` path, with both kernels launched on it.
   ``--distributed`` runs the dry run at world 2 and 4 instead, one rank a
   card: every training step (one episode a rank) held against the same
   step of the whole batch on one card with this phase's rules (loss,
   gradients, 99.9 % of the update elements, stats) beside two planted
   faults that must break them (the gradients summed over the ranks, not
   divided by the world; the baseline's BN over the ranks with a rank-local
   backward), every rank's trees bit-equal, the eval's and the live
   DampNet eval's scores equal to one card's, the edge kernel exactly 3
   times a local GnnNet episode and the scan once a rank's lane batch;
   each step's seconds beside one card's and the all-reduce's share;
5. drive the main path through ``mft_tpu_torch.cli.finetune.main`` at full
   width — ``--method all --use_pallas --inner_scan fused``, ResNet10 at
   224 px, 5-way 5-shot, 15 queries, ``gen_examples=17``,
   ``fine_tune_epoch=5`` — on the synthetic dataset with seeded random
   checkpoints (baseline@400, gnnnet_aug@600 5-shot and 50-shot, protonet@400
   ``.tar`` files), with every
   kernel launch count set to 0 just before and read just after (these
   drives pass ``--eval_batch 1``, one episode a batch); then two
   episodes with the eager inner loop (``--inner_scan eager``), so that the
   seconds per episode of both stand side by side from one host; then two
   episodes of the strict f32 numerics (``--dtype float32
   --inner_param_dtype float32``); then one more episode of the main path
   under ``torch.profiler`` to see both kernels' symbols on the device
   timeline and to print where the time goes (per eval phase, per kernel,
   idle share); then the 50-shot main path through
   ``mft_tpu_torch.cli.finetune_50`` (the same flags, 2 episodes, launch
   counts set to 0 before and read after, both must be above 0; then two
   episodes and one profiled of its GNN member alone, ``--method
   gnnnet``), the faithful 5-shot eval (``--bn_mode minibatch``,
   strict f32, 2 episodes; its profile is the lanes' below) and a ``--method protonet``
   eval (2 episodes), each with its seconds per episode and peak memory;
   then the episode lanes of ``--eval_batch 5`` (the JAX driver's default):
   the fused main path for 15 episodes (three batches, the first the warm-up;
   launch counts set to 0 before and read after: the scan once a batch, the
   edge kernel three times a batch) and one profiled batch; the faithful
   eval (``--bn_mode minibatch``, strict f32) for two batches, the first the
   warm-up (the edge kernel three times a batch, the scan never), beside its
   ``--eval_batch 1`` drive, and one profiled batch; the eval engine's
   knobs, each for two batches (the first the warm-up) timed against its
   default (``--inner_gather epoch``, ``--inner_carry flat`` and
   ``--fanout_group_pass 6`` on the fused lanes, ``--ensemble_fuse lane``
   on the eager ones); two batches with ``--inner_scan eager`` and two
   with ``--freeze_backbone``; and one 50-shot batch through
   ``cli.finetune_50`` (its time includes the warm-up); then the other
   backbones at ``--eval_batch 5`` from their own seeded checkpoints:
   ResNet10_FW ``--inner_scan fused`` (both kernels' launches counted and
   above 0) and ResNet18 ``--inner_scan eager`` (the edge kernel's) for two
   batches each, ResNet34 eager for one (its warm-up included), each with
   one more batch under the profiler (idle share, kernel times); then the
   interop and mesh phase: the seeded baseline and GnnNet checkpoints
   written again as JAX-layout ``.ckpt`` files into a directory without a
   ``.tar``, two ``--eval_batch 5`` batches from there (launch counts set to
   0 before and read after) whose scores must equal, bit for bit, the same
   batches from the ``.tar`` files (run twice for their rerun spread; the
   lane rule of phase 4 where the reruns differ), ``import_ckpt`` then
   ``export_ckpt`` with every tensor bit-equal to the seeded originals, a
   DampNet-sized ``.ckpt`` written and read onto the card (seconds), a mesh
   of two shards on ``cuda:0`` (global batch 10, launch counts, seconds per
   episode) against the unsharded batches, and the native decoder's backend
   (and, where it is native, its host seconds on 480 JPEGs beside PIL's);
6. drive the training path through ``mft_tpu_torch.cli.train.main`` at full
   width on the synthetic dataset (baseline, batch 16; episodic GnnNet
   ``--train_aug --use_pallas``; ``--fine_tune`` resumed from its
   checkpoint; ``cli.train_50`` GnnNet), with the launch counts set to 0
   before each stage and read after, seconds per step, peak device memory
   and one profiled step per stage, then ResNet10_FW episodic GnnNet
   ``--train_aug --use_pallas`` (its noise strengths checked unchanged in
   the checkpoint) and ResNet18 baseline the same way; ``cli.save_features``
   over the synthetic split with that ResNet18 checkpoint, and ``cli.test``
   on those features without and with ``--adaptation``, with seconds for
   each; then one ``--method all`` eval episode from the checkpoints those
   stages wrote; then the DampNet eval from its trained checkpoint (two
   episodes and a profiled one), and its live, ``--unsupervised`` and
   ``nofinetune`` compositions in strict f32 at ``--eval_batch 1`` (five
   episodes) and at ``--eval_batch 5`` (two batches), the lanes' scores held against the
   same episodes alone, launch counts exact (the edge kernel never, the scan
   once a batch in the live one), seconds per episode of both and one
   profiled lane batch each;
7. drive the synthetic pipeline (``mft_tpu_torch.examples.synthetic_pipeline``,
   the port of ``examples/synthetic_pipeline.py``: baseline pretraining ->
   episodic GnnNet -> FO-MAML fine-tune -> ``--method all`` on held-out
   classes; ResNet10, bf16, 64 px, ``--use_pallas --inner_scan fused``) cut
   short: 60 baseline steps, 12 episodic and 2 fine-tune steps of 8
   episodes, one held-out batch of 4 lanes, with the launch counts set to 0
   before and read after.  Every loss must be finite and the launches exact
   (the edge kernel 3 times an episode in the training steps and 3 times a
   lane batch, 339; the scan once a lane batch, 1); it prints each stage's
   seconds.  ``--pipeline`` runs the whole chain at the script's defaults
   (600 baseline steps, 188 episodic and 40 fine-tune steps of 8 episodes, 8
   held-out batches of 4), then the held-out eval again with the eager inner
   loop on the same trained trees, then a short chain under the profiler for
   each stage's device time and idle share; it fails unless the last 10
   episodic losses average below 0.5, every fine-tune loss is finite, the
   fused held-out accuracy is at least 80 % and the eager one within 2
   points of it, and the launches are exact (5496 edge, 8 scan).

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
the main path, max error, kernel / plain / bound times; launches on the
training path and, for the edge kernel, one training step's forward times
and its plain backward's; launches on the 50-shot main path and its times
and bounds, and train_50's; launches on the 5-lane paths and a lane
batch's times and bounds; launches on the faithful and the DampNet lane
paths; launches and the profiled batch's device time on
the ResNet10_FW, ResNet18 and ResNet34 lane paths, launches in
ResNet10_FW's training, and launches on the ``.ckpt``-driven and mesh
runs, and on the synthetic pipeline's short chain, and on the world-1
process group's path, per rank); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EPISODES = 3
#: 50-shot episodes of the main-path run (the first is the warm-up)
EPISODES_50 = 2
#: the DampNet compositions' --eval_batch 1 drives, held against the first lane batch of the same episodes
#: (strict f32, XDEV_TOL: the unsupervised forward, the nofinetune probe's SGD).  The live composition's 500 fused
#: steps with bf16 Adam moments part a lane from its episode alone by sign chaos (on one H100, in f32 on the trained
#: weights: 3.512e-02 with 17 clear argmax flips in one call, 2.231e-02 in another), so its scores are held with
#: --fine_tune_epoch 0 and its full-depth drives are timed; phase 4 holds its lanes with one inner epoch
DAMP_EPISODES = 5
#: the lane runs of phase 5: --eval_batch LANES; the episodes of each timed lane drive (three batches, the first the
#: warm-up: one steady batch moved by up to a fifth between batches on one H100's host)
LANES = 5
LANE_EPISODES = 15
#: the lanes of the benchmark's cells (--eval_batch 20): phase 3 holds the fused scan at this width too
CELL_LANES = 20
#: the other lane drives of phase 5 (each knob, eager, --ensemble_fuse lane, --freeze_backbone): two batches, the
#: first the warm-up, so that the script's new drives fit its time limit
KNOB_EPISODES = 2 * LANES
#: --fanout_group_pass of phase 5's knob timing: three trunk passes of six replica groups for the 18 of a bank
FANOUT_GROUP_PASS = 6
#: phase 4: episodes of one lane batch on the card against the same episodes alone on the CPU
XDEV_LANES = 3
#: phase 4, lanes with one inner epoch: Adam's first steps move each weight by
#: about lr whatever a gradient's size, so f32 rounding parts the card's lanes
#: from the CPU's episodes by 3.4e-3 (eager) and 4.0e-3 (fused) in the scores
#: at 64 px (measured on one H100, which also met queries whose top two scores
#: lay within that of each other and flipped).  No score may part by more than
#: XDEV_LANE_CAP, some 3x those readings and under the 3.3e-2 of the planted
#: fault (BN statistics taken over all lanes together) without inner steps;
#: so the argmax must agree wherever the CPU's top two scores lie further
#: apart than twice the cap, which no sound run can flip.  Without inner
#: steps the bound stays XDEV_TOL.  The fault is planted at both depths and
#: in both inner loops, and each check must catch it.
XDEV_LANE_CAP = 1e-2
XDEV_LANE_MARGIN = 2 * XDEV_LANE_CAP
XDEV_LANE_FAULT = "BN statistics over all lanes together"
#: phase 4's faithful lanes (--bn_mode minibatch): the planted fault pools the trunk's BN statistics over the lanes
#: (bn_groups=1, the inner step's mask repeated over the lanes' rows), in the inner steps and the embedding alike
XDEV_MINIBATCH_FAULT = "the trunk's BN statistics over all lanes together"
#: phase 4's DampNet lanes: the planted fault starts every lane's probe from lane 0's head
XDEV_PROBE_FAULT = "one probe head init shared by all lanes"
#: f32 kernel vs f32 plain product: same math, other summation order
EDGE_REL_TOL = 1e-4
#: the edge kernel vs the plain emulation of its own arithmetic (the
#: three-term bf16 split, edge_abs_diff_matmul_split_reference), as a share
#: of the output's largest value: the same exact bf16 x bf16 products summed
#: in f32 in another order, read 5e-8 to 1.4e-6 on an H100; a kernel that
#: drops or doubles a term is 1e-3 away
EDGE_SPLIT_TOL = 1e-5
#: card vs CPU eval scores (softmax sums in [0, 2]), strict f32, no inner
#: steps: the same forward (trunk, BN, GNN with the edge kernel) on both
XDEV_TOL = 1e-4
#: phase 4's DampNet lanes with the probe (``--dampnet_eval nofinetune``): the probe's 700 SGD steps on the
#: recovered projections, card lanes against CPU episodes alone in f32; no Adam, so no sign chaos: read 4.292e-06
#: on one H100, the planted shared head 1.919e-01, so XDEV_TOL holds it
XDEV_PROBE_CAP = XDEV_TOL
#: fused scan kernels vs their plain version, one step's gradients, as a
#: share of each tensor's largest gradient.  f32: the same f32 math in
#: another summation order.  bf16: y1, z1, the pooled features and every dy
#: round to bf16, and a last-bit difference in f32 before such a rounding
#: flips a bf16 ulp (2**-8 relative) of one value, which the products carry
#: on: every output channel of every tensor within FUSED_GRAD_TOL.  One
#: thing more can happen to a right bf16 kernel: a flipped ulp moves a
#: pre-activation across 0, the ReLU mask of that one (row, channel) flips
#: and adds or drops a whole term, which stays in that output channel of the
#: conv before it and of its BN.  So under bf16 at most
#: FUSED_GRAD_FLIP_CHANNELS output channels of a tensor may exceed
#: FUSED_GRAD_TOL, and none FUSED_GRAD_FLIP_TOL (a wrong term of the
#: backward is an error of about 1 in every channel)
FUSED_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
FUSED_GRAD_FLIP_CHANNELS = {"float32": 0, "bfloat16": 2}
FUSED_GRAD_FLIP_TOL = 5e-2
#: the update rule, elementwise, step by step: the scan after t + 1 steps
#: against the plain Adam update applied to the scan's own state after t
#: steps, with that step's gradients taken from the same kernels
#: (fused_step_grads) and the moments replayed from the earlier steps'.
#: Both sides see the same parameter and gradient bits, so they differ only
#: by the last bit of a division or of the bias correction: rtol 1e-5 in
#: f32; one bf16 ulp (rtol 2**-7) under a bf16 carry, where that last bit
#: can flip the final rounding or a stored moment's.  Share of elements of
#: every tensor that must agree at each of the first FUSED_REPLAY_STEPS steps,
#: on both lanes of a two-lane call (so a lane that read the other's bank,
#: schedule or moments fails here, element by element):
FUSED_REPLAY_RTOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
FUSED_REPLAY_SHARE = 0.999
FUSED_REPLAY_STEPS = 4
#: fused scan vs plain after 20 Adam steps, per tensor, as a share of the
#: distance the plain version moved.  At lr 0.01 on weights of about 0.02
#: every sign flip of a near-zero gradient is as large as the weight and
#: later steps amplify it, so two right trajectories part normwise.  How far
#: is measured in the same run: the plain version against itself with the
#: rows of every minibatch in reverse order (the same math in another
#: summation order).  The kernels may part from the plain version by at
#: most FUSED_SCAN_FLOOR_FACTOR times the worst tensor's share of that
#: floor, and never by more than FUSED_SCAN_CAP.  What such a bound can
#: catch is measured in the same run too: the plain version with a fault
#: planted through its arguments (FUSED_PLANTED_FAULTS) must part from the
#: right plain version by more than the bound, or the script fails
FUSED_SCAN_FLOOR_FACTOR = 2.5
FUSED_SCAN_CAP = 0.6
FUSED_PLANTED_FAULTS = ("moments left from another scan", "the other lane's bank")
#: one product of the fused scan's step, tensor-core kernel vs the plain f32
#: product of the same bf16 operands, as a share of the output's largest
#: value: both sides sum exact bf16 x bf16 products in f32, in another order
FUSED_PRODUCT_TOL = 1e-4
#: a fault the product check must catch: the plain weight gradient taken over
#: rows padded to the kernels' 64-row tiles with the dead rows (m >= 245) not
#: zero, which is what a kernel that did not mask them would compute
FUSED_PRODUCT_FAULT = "dead rows of the last 64-row tile not zero"
#: a short scan whose launches all fit the CUDA launch queue, so that the
#: host's time inside the C call is the enqueue alone
FUSED_ENQUEUE_STEPS = 60
#: card vs CPU, one training step of each stage at 64 px, ResNet10 at full
#: width, strict f32, the same weights, inputs and inner schedule, held with
#: the step rules of mft_tpu_torch/parallel/dryrun.py (its constants, which
#: the data-parallel dry run shares).  The loss: the same forward in another
#: summation order (cuDNN against the CPU's convolutions, the edge kernel
#: within 1e-4), relative (LOSS_RTOL).  The gradients: per tensor, the largest
#: difference within GRAD_TOL of that tensor's largest gradient plus
#: GRAD_TREE_FLOOR of the largest in the whole tree (a gradient that is zero
#: in exact arithmetic, a bias before a batch-statistics BN, is f32 noise with
#: no sign in common).  The running stats: largest difference within
#: STATS_TOL of each tensor's largest value.  The update: Adam's first step is
#: about lr * sign(g), so a gradient within noise of zero flips its element by
#: up to 2 * lr; the share of all elements whose updates agree within 1e-2 *
#: lr must reach UPDATE_SHARE (the analytically zero gradients alone, the
#: GNN's biases before its BNs, are 3.5e-4 of them)
#: widened after the first call on the card (the gradient rule alone read
#: 2.368 of its allowance in the episodic step, all of it in a tensor of
#: sums with heavy cancellation: the second Wcompute's edge weight gradient
#: sums 2700 products of both signs to 3e-3; the CPU's own f32 gradient
#: there reads 1.0 of the allowance against f64).  Each device carries its
#: own f32 error against the exact gradient, so each tensor's allowance
#: gains F32_FACTOR times the CPU's f32 error against the same step in
#: f64 on the CPU (the edge op plain in f64), measured in the same run.
#: What the wider bound still catches is shown in the same run: the card's
#: episodic step with the edge forward as one bf16 product (TRAIN_FAULT;
#: about 200 times the widened allowance in a CPU emulation) must fail it
TRAIN_FAULT = "edge forward as one bf16 product, lo terms dropped"
#: the meta fine-tune's loss, gradients and stats come after 105 inner
#: Adam(0.01) steps, each of which flips the near-zero-gradient elements the
#: two devices disagree on by up to 0.02: the two devices part further.  How
#: far is measured in the same run: the CPU's f32 step against the same step
#: in f64 on the CPU (at 64 px this read, on the CPU alone, 2.7e-3 in loss,
#: 0.30 relative L2 in the gradients, 0.19 of the update elements, 0.20 in
#: the stats: the chaos of the inner loop, not a fault).  The card may part
#: from the CPU by at most TRAIN_FT_FACTOR times that floor (never by less
#: than the bounds above allow), by at most TRAIN_FT_CAP relative in loss,
#: and in at most TRAIN_FT_DISAGREE_CAP of the update elements.  Widened
#: after the second call: the floor was the CPU against itself with the rows
#: of every inner minibatch reordered, and the card read 5.4x it in the
#: gradients (0.171) and stats (0.117), while the loss held (3.8e-4).  What
#: the wider bound still catches is shown in the same run: the card's step
#: with fo_maml_reattach dropped (TRAIN_FT_FAULT: the outer gradient never
#: reaches the adapted block; 0.58 of the update elements disagree in a CPU
#: emulation) must fail it
#: the 50-shot step (265 images) takes the backbone's ReLU decisions from the
#: card: the CPU's step replays, call by call, which elements the card's
#: ``torch.relu`` passed (ReluDecisions), so the rules above compare the
#: arithmetic at equal masks.  Why: on an H100 it read grad_worst 41.9 there,
#: the final block's conv1 and bn1 bias 42x and 23x their allowance and every
#: tensor upstream about 3.5x, the signature of one pre-activation of that
#: block's first ReLU lying within f32 rounding of 0 with cuDNN's sums and the
#: CPU's on opposite sides of it (the same reading with the edge op plain on
#: the card, so not the kernel; the CPU at 8 against 1 thread reads 0.15).
#: What the replay may hide is bounded: every element where the card's
#: decision differs from the CPU's own must lie within RELU_REACH of 0, as a
#: share of the largest input of its call (the two devices' pre-activations
#: differ by about 1e-7 of it); the planted fault is replayed the same way
#: and must still fail the rules
RELU_REACH = 1e-5
TRAIN_FT_FACTOR = 3.0
TRAIN_FT_CAP = 1e-2
TRAIN_FT_DISAGREE_CAP = 0.25
TRAIN_FT_FAULT = "fo_maml_reattach dropped, the adapted block detached"
#: the DampNet step (dampnet_full_class at its published widths) on the card
#: against the CPU, in each training mode, holds the episodic step's rules
#: above with the CPU replaying the card's ReLU decisions (ReluDecisions,
#: RELU_REACH): the backbone's, the recovery network's MLP ReLUs and, since
#: the first call on the card, the GNN's leaky ReLUs.  There DampNet's GNN
#: runs the plain edge op on the card, and 2-6 edge activations a call lay
#: within 6.3e-8 to 4.5e-6 of 0 (as a share of the call's largest) with the
#: two devices on opposite sides: grad_worst read 9.3 (plain) and 2.0
#: (recover) with each device's own decisions, 0.19 and 0.53 with the card's.
#: One rule differs: the update.  The bilinear NTN's weight gradient is an
#: outer product, a_k * p_i * x_j, so one unit k whose gradient a_k is a sum
#: that cancels to f32 noise flips the sign of a whole 512 x 512 slice of
#: elements: the recover step read 3.6e-3 of the update elements apart on the
#: first call, equal decisions or not.  How far is measured in the same run:
#: the CPU's f32 step against f64; the card may part from the CPU in at most
#: dryrun.py's UPDATE_FACTOR times that share of the update elements (and
#: never fewer than 1 - UPDATE_SHARE).  A fault per mode that the rules must
#: catch, planted on the card (DAMP_FAULTS)
DAMP_FAULTS = {"plain": "backbone features detached, the head trains alone",
               "corrupt": "fc.linear left trainable on a corrupt step",
               "recover": "mult and add swapped"}
#: full-width training stages through cli.train.main (224 px, synthetic):
#: baseline batches (480 images at batch 16), episodic and fine-tune episodes
#: (5-way 5-shot, 16 queries); the step profiled (0 is the warm-up).  The
#: prototype DampNet variant takes 5 steps: plain, then corrupt and recover
#: alternating
TRAIN_EPISODES = {"episodic": 6, "fine_tune": 4, "train50": 4, "dampnet_full_class": 4, "dampnet": 5,
                  "ResNet10_FW episodic": 4}
PROFILED_STEP = 2
#: the synthetic pipeline's scan geometry (BlockGeom fields): ResNet10's final
#: block at 64 px, 4x4x256 -> 2x2x512, 20 rows a step of 5, over a 500-row
#: bank (17 augmented replicas and the clean support three times)
FUSED_64PX = (4, 256, 512, 2, 5)
#: the lanes of the synthetic pipeline's held-out batch (its EVAL_LANES)
CHAIN_LANES = 4
#: the default run's short chain of mft_tpu_torch.examples.synthetic_pipeline
#: (its flags): 60 baseline steps of 64 images, 12 episodic and 2 fine-tune
#: steps of 8 episodes, one held-out lane batch of 4 episodes
CHAIN_SHORT = {"baseline_steps": 60, "steps": 12, "finetune_steps": 2, "eval_batches": 1}
#: --pipeline: the chain at the JAX script's defaults must reach a mean
#: episodic loss below PIPELINE_TAIL_LOSS over its last PIPELINE_TAIL steps
#: (chance is ln 5 = 1.61), a fused held-out accuracy of PIPELINE_MIN_ACC
#: percent, and the eager inner loop's accuracy on the same trained trees
#: within PIPELINE_EAGER_GAP points of it
PIPELINE_TAIL, PIPELINE_TAIL_LOSS, PIPELINE_MIN_ACC, PIPELINE_EAGER_GAP = 10, 0.5, 80.0, 2.0
#: --pipeline: each stage's profiler window inside the full run, after its
#: warm-up: (the step or batch after which it opens, the steps or batches it spans)
PIPELINE_WINDOWS = {"baseline": (300, 5), "episodic": (100, 5), "fine_tune": (20, 2), "eval": (3, 2)}
#: the 50-shot profile's flags: the GNN member alone at full depth (the driver's --method gnnnet, reading the
#: checkpoint --method all reads, gnnnet_aug at 600), the member the 50-shot geometry changes (130-node graphs, the
#: 5000-row bank, 5000 fused steps).  The --method all episode's
#: linear member runs 1000 eager steps whatever the flags (its 20 epochs over the support are fixed in the driver;
#: --gen_examples 1 cut only the GNN member's bank): under the profiler 20.5 s of its 20.8 s and 102 s of the script
#: on one H100, where the per-step picture is the 5-shot profiles'
PROFILE_50_FLAGS = ["--method", "gnnnet", "--train_aug", "--save_iter", "600"]
#: the default run's process group of world 1: episodes of its episodic GnnNet step
WORLD1_EPISODES = 2
#: --distributed: the worlds of the dry run (one rank a card) and the seconds each may take
DIST_WORLDS = (2, 4)
DIST_TIMEOUT = 480.0
#: H100 SXM published peaks (dense): f32 outside the tensor cores, bf16 in
#: the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


T0 = time.perf_counter()


def mark(label: str):
    """The seconds since the script started, after a piece of the run (where the time limit goes)."""
    print(f"[chip_smoke] {label}: done at {time.perf_counter() - T0:.1f} s", flush=True)


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, iters: int = 20) -> dict:
    """Device time per call of ``fn`` as ``torch.profiler`` sees it: kernel
    name -> microseconds, and "total".  Free of the host's launch cost, which
    a CUDA-event time of a short kernel behind a Python wrapper is not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(3):  # the first trace of a process can come back empty
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / iters for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}
        if out:
            break
    else:
        fail("the profiler recorded no device time for a kernel in three traces")
    out["total"] = sum(out.values())
    return out


def short_name(key: str) -> str:
    """A kernel's profiler key without return type, namespaces and parameter list."""
    name = key.replace("(anonymous namespace)::", "").replace("void ", "")
    depth = 0
    for i, ch in enumerate(name):  # cut at the "(" that opens the parameter list
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][-70:]
    return name[-70:]


def report_build(name: str, log: str, build_dir):
    """The ptxas resource report of one source in short (the template
    instantiations make it long): kernels compiled, most registers, any
    spill; the whole log goes to ``build_<name>.log`` beside the library."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"[{name}] ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
          f"{sum(1 for v in spills if v)} with spills")
    for line in [line for line in log.splitlines() if "warning" in line.lower()][:6]:
        print(f"[{name}] {line.strip()[:200]}")
    with open(os.path.join(build_dir, f"build_{name}.log"), "w") as f:
        f.write(log)


def edge_bound_ms(b, n, f, c, route: str = "function"):
    """Least time for one call: bytes (x, w, bias read once; out written
    once) over the memory rate, or operations over their peak.
    ``"function"``, the bound the kernel is held to: the one product
    ``|x_i - x_j| @ W`` over the real F at the bf16 tensor-core peak, the
    least work any route does.  ``"bf16x3"``, what the kernel's route does
    (a diagnostic): three bf16 products (hi*hi, hi*lo, lo*hi) with F padded
    to the wgmma's depth of 16.  ``"f32"``: the product, the edge values and
    the bias as f32 FMAs on the CUDA cores.  Returns (ms, what binds it)."""
    if route == "function":
        flops, peak = 2.0 * b * n * n * f * c, PEAK_BF16_FLOPS
    elif route == "bf16x3":
        flops, peak = 3 * 2.0 * b * n * n * (-(-f // 16) * 16) * c, PEAK_BF16_FLOPS
    else:
        flops, peak = 2.0 * b * n * n * f * c + 2.0 * b * n * n * f + b * n * n * c, PEAK_F32_FLOPS
    nbytes = 4.0 * (b * n * f + c * f + c + b * n * n * c)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sass_count(lib, op: str) -> int:
    """Lines of the built library's SASS (cuobjdump from the CUDA toolkit) that hold ``op``."""
    from mft_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=False)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed on {lib}: {res.stderr.strip()[:300]}")
    return sum(op in line for line in res.stdout.splitlines())


#: 5-shot main path: B = 15 query graphs of N = 30 nodes, the three Wcompute
#: widths F, C = 192 (one episode's three calls)
EDGE_MAIN = ((15, 30, 133, 192), (15, 30, 181, 192), (15, 30, 229, 192))
#: training path (``--method gnnnet --use_pallas``): B = n_query = 16 graphs a
#: step (cli/train.py's rule max(1, int(16*test_n_way/train_n_way))), the
#: same N, F and C; three forward calls a step, their backward plain
EDGE_TRAIN = ((16, 30, 133, 192), (16, 30, 181, 192), (16, 30, 229, 192))
#: the op's gradient on the card (kernel forward, plain backward _edge_bwd)
#: against autograd through the plain version, one fixed cotangent, as a
#: share of each gradient's largest value: the same f32 formulas on the same
#: cotangent, summed in another order over up to B*N*N = 14400 terms (about
#: 1e-6 expected), with the forward tolerance as the bound
EDGE_GRAD_TOL = 1e-4
#: a fault the gradient check must catch (emulated in plain torch on the card)
EDGE_GRAD_FAULT = "dx without its -sum_i term"
#: 50-shot main path (``cli.finetune_50``): the compressed head's graphs of
#: N = 5 * (25 + 1) = 130 nodes, B = 15, the same F and C (one episode's
#: three calls); ``cli.train_50``: B = 16 a step, forward on the kernel,
#: backward plain
EDGE_50 = ((15, 130, 133, 192), (15, 130, 181, 192), (15, 130, 229, 192))
EDGE_TRAIN50 = ((16, 130, 133, 192), (16, 130, 181, 192), (16, 130, 229, 192))
#: the lane batches of --eval_batch 5: every Wcompute takes the graphs of all
#: five episodes in one call, B = 15 * 5 = 75 (5-shot N = 30, 50-shot N = 130)
EDGE_LANES = ((75, 30, 133, 192), (75, 30, 181, 192), (75, 30, 229, 192))
EDGE_LANES50 = ((75, 130, 133, 192), (75, 130, 181, 192), (75, 130, 229, 192))
#: the synthetic pipeline (mft_tpu_torch/examples/synthetic_pipeline.py):
#: its GnnNet training and fine-tune steps run the head episode by episode on
#: B = n_query = 8 graphs, its held-out lane batches of 4 episodes on B = 15 *
#: 4 = 60 graphs
EDGE_PIPE = ((8, 30, 133, 192), (8, 30, 181, 192), (8, 30, 229, 192))
EDGE_PIPE_EVAL = ((60, 30, 133, 192), (60, 30, 181, 192), (60, 30, 229, 192))
#: besides: rows not a multiple of 64 with C and F under one tile; F a
#: multiple of 64; one graph; the three-query graphs of phase 4 (5-shot and
#: 50-shot)
EDGE_OTHER = ((3, 7, 5, 8), (15, 30, 128, 192), (1, 30, 229, 192), (3, 30, 133, 192), (3, 130, 229, 192))
#: a fault the edge check must catch: one bf16 product, the split's lo terms
#: dropped (emulated in plain torch on the card)
EDGE_FAULT = "one bf16 product, lo terms dropped"


def phase_edge_kernel(torch, dev):
    """The edge kernel against its f32 plain version at EDGE_MAIN and
    EDGE_OTHER and against the plain emulation of its own split, with device
    times (profiler) beside the wrapper's CUDA-event time, the function's
    bound beside the route's work and the f32 bound, the plain version,
    cuBLAS's f32 product on the materialized edges (yardstick only), the
    planted one-term fault, and the HGMMA count of the built library."""
    from mft_tpu_torch.kernels import build, edge_mlp

    hgmma = sass_count(build.lib_path("edge_mlp"), "HGMMA")
    print(f"edge_mlp library: {hgmma} HGMMA instructions in its SASS (tensor-core products)")
    if hgmma <= 0:
        fail("the edge kernel's library has no HGMMA instruction: its products do not run on the tensor cores")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst_abs, main = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    train, fifty, train50 = dict(main), dict(main), dict(main)  # three calls: a training step, a 50-shot episode, a train_50 step
    lanes, lanes50 = dict(main), dict(main)  # three calls of a 5-lane batch, 5-shot and 50-shot
    pipe, pipe_eval = dict(main), dict(main)  # the synthetic pipeline: an episode of a step, a 4-lane batch
    bound_by = {"bytes": 0.0, "operations": 0.0}  # the main calls' bounds, summed by what binds each
    sums = ((EDGE_MAIN, main), (EDGE_TRAIN, train), (EDGE_50, fifty), (EDGE_TRAIN50, train50), (EDGE_LANES, lanes),
            (EDGE_LANES50, lanes50), (EDGE_PIPE, pipe), (EDGE_PIPE_EVAL, pipe_eval))
    checked = EDGE_MAIN + EDGE_TRAIN + EDGE_50 + EDGE_TRAIN50 + EDGE_LANES + EDGE_LANES50 + EDGE_PIPE + EDGE_PIPE_EVAL
    for b, n, f, c in checked + EDGE_OTHER:
        label = f"edge_abs_diff_matmul B={b} N={n} F={f} C={c}"
        x = torch.randn((b, n, f), generator=gen, device=dev)
        w = torch.randn((c, f), generator=gen, device=dev) * 0.05
        bias = torch.randn((c,), generator=gen, device=dev)
        before = edge_mlp.LAUNCHES
        out = edge_mlp.edge_abs_diff_matmul(x, w, bias)
        if edge_mlp.LAUNCHES != before + 1:
            fail("edge_abs_diff_matmul did not launch its kernel on a CUDA tensor")
        ref = edge_mlp.edge_abs_diff_matmul_reference(x, w, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"edge kernel produced non-finite values at {(b, n, f, c)}")
        scale = max(float(ref.abs().max()), 1e-30)
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / scale
        emul = float((out - edge_mlp.edge_abs_diff_matmul_split_reference(x, w, bias)).abs().max()) / scale
        print(f"{label}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} (tol rel {EDGE_REL_TOL:g}); against "
              f"the plain emulation of its three-term split {emul:.3e} (tol {EDGE_SPLIT_TOL:g})")
        if not rel_err <= EDGE_REL_TOL:
            fail(f"edge kernel disagrees with its plain version at {(b, n, f, c)}: rel {rel_err:.3e}")
        if not emul <= EDGE_SPLIT_TOL:
            fail(f"edge kernel departs from its stated three-term arithmetic at {(b, n, f, c)}: {emul:.3e}")
        worst_abs = max(worst_abs, abs_err)
        if (b, n, f, c) in checked:  # the planted fault, on the same inputs
            one = edge_mlp.edge_abs_diff_matmul_split_reference(x, w, bias, terms=1)
            reading = float((one - ref).abs().max()) / scale
            caught = reading > EDGE_REL_TOL
            print(f"{label}: plain version with a planted fault ({EDGE_FAULT}): {reading:.3e} against "
                  f"{EDGE_REL_TOL:g}: {'caught' if caught else 'passes'}; the kernel {rel_err:.3e}")
            if not caught:
                fail(f"the edge check does not catch {EDGE_FAULT} at {(b, n, f, c)}")
        dev_us = device_us(lambda: edge_mlp.edge_abs_diff_matmul(x, w, bias))
        wrapper_ms = cuda_time_ms(lambda: edge_mlp.edge_abs_diff_matmul(x, w, bias))
        ms = dev_us["total"] * 1e-3
        bms, by = edge_bound_ms(b, n, f, c)
        x3_bms, x3_by = edge_bound_ms(b, n, f, c, route="bf16x3")
        f32_bms, f32_by = edge_bound_ms(b, n, f, c, route="f32")
        print(f"{label}: kernel device_ms={ms:.5f} ("
              + ", ".join(f"{short_name(k)} {v:.2f} us" for k, v in dev_us.items() if k != "total")
              + f"); wrapper's time by CUDA events {wrapper_ms:.5f} ms (host launch cost included)")
        print(f"{label}: bound_ms={bms:.5f} ({by}; one product over F at the bf16 tensor-core peak, or bytes); "
              f"the route's three bf16 products over F padded to 16 {x3_bms:.5f} ({x3_by}); f32 CUDA-core bound "
              f"{f32_bms:.5f} ({f32_by}); the kernel takes {ms / bms:.2f} x its bound")
        if (b, n, f, c) in checked:
            plain_us = device_us(lambda: edge_mlp.edge_abs_diff_matmul_reference(x, w, bias))["total"]
            e = (x[:, :, None, :] - x[:, None, :, :]).abs()
            cublas_us = device_us(lambda: torch.matmul(e, w.t()))["total"]
            del e
            print(f"{label}: plain device_ms={plain_us * 1e-3:.5f} (by CUDA events "
                  f"{cuda_time_ms(lambda: edge_mlp.edge_abs_diff_matmul_reference(x, w, bias)):.5f}); yardstick: "
                  f"cuBLAS f32 product alone on the materialized edges (torch.matmul, TF32 off) "
                  f"{cublas_us * 1e-3:.5f} ms on the device")
            for shapes, acc in sums:  # one episode's or step's three launches
                if (b, n, f, c) in shapes:
                    acc["ms"] += ms
                    acc["plain_ms"] += plain_us * 1e-3
                    acc["bound_ms"] += bms
            if (b, n, f, c) in EDGE_MAIN:
                bound_by[by] += bms
    print(f"edge_abs_diff_matmul, one episode's three calls: device {main['ms']:.5f} ms, plain {main['plain_ms']:.5f} "
          f"ms, bound {main['bound_ms']:.5f} ms ({bound_by['bytes']:.5f} of it by bytes, {bound_by['operations']:.5f} "
          f"by operations), the route's three products "
          f"{sum(edge_bound_ms(*case, route='bf16x3')[0] for case in EDGE_MAIN):.5f} ms, f32 CUDA-core bound "
          f"{sum(edge_bound_ms(*case, route='f32')[0] for case in EDGE_MAIN):.5f} ms")
    print(f"edge_abs_diff_matmul, one training step's three forward calls (B = 16): device {train['ms']:.5f} ms, plain "
          f"{train['plain_ms']:.5f} ms, bound {train['bound_ms']:.5f} ms")
    print(f"edge_abs_diff_matmul, one 50-shot episode's three calls (N = 130, B = 15): device {fifty['ms']:.5f} ms, plain "
          f"{fifty['plain_ms']:.5f} ms, bound {fifty['bound_ms']:.5f} ms; one train_50 step's three forward calls (B = 16): "
          f"device {train50['ms']:.5f} ms, plain {train50['plain_ms']:.5f} ms, bound {train50['bound_ms']:.5f} ms")
    print(f"edge_abs_diff_matmul, one {LANES}-lane batch's three calls (B = 75): N = 30 device {lanes['ms']:.5f} ms, plain "
          f"{lanes['plain_ms']:.5f} ms, bound {lanes['bound_ms']:.5f} ms; N = 130 device {lanes50['ms']:.5f} ms, plain "
          f"{lanes50['plain_ms']:.5f} ms, bound {lanes50['bound_ms']:.5f} ms")
    print(f"edge_abs_diff_matmul, the synthetic pipeline: one episode of a training step's three forward calls "
          f"(B = 8) device {pipe['ms']:.5f} ms, plain {pipe['plain_ms']:.5f} ms, bound {pipe['bound_ms']:.5f} ms; one "
          f"4-lane held-out batch's three calls (B = 60) device {pipe_eval['ms']:.5f} ms, plain "
          f"{pipe_eval['plain_ms']:.5f} ms, bound {pipe_eval['bound_ms']:.5f} ms")
    bwd_ms = phase_edge_gradient(torch, dev, edge_mlp, EDGE_TRAIN)
    bwd50_ms = phase_edge_gradient(torch, dev, edge_mlp, EDGE_TRAIN50)
    bwd_pipe_ms = phase_edge_gradient(torch, dev, edge_mlp, EDGE_PIPE)
    return {
        "name": "edge_abs_diff_matmul",
        "route": "cuda",
        "source": "mft_tpu_torch/kernels/csrc/edge_mlp.cu",
        "replaces": "mft_tpu/ops/pallas/edge_mlp.py:61",
        "max_abs_err": worst_abs,
        # one episode's three calls (F = 133, 181, 229) summed, device time
        # (W's split pass and the product kernel); plain likewise
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": max(bound_by, key=bound_by.get),
        "library_ms": None,  # no single PyTorch call computes |x_i - x_j| @ W
        # the training path (B = 16): one step's three forward calls, and the
        # plain backward (_edge_bwd) of those three calls, device time
        "ms_train": train["ms"],
        "plain_ms_train": train["plain_ms"],
        "bound_ms_train": train["bound_ms"],
        "backward_plain_ms_train": bwd_ms,
        # the 50-shot eval (N = 130, B = 15): one episode's three calls
        "ms_50": fifty["ms"],
        "plain_ms_50": fifty["plain_ms"],
        "bound_ms_50": fifty["bound_ms"],
        # train_50 (N = 130, B = 16): one step's three forward calls and their plain backward
        "ms_train50": train50["ms"],
        "bound_ms_train50": train50["bound_ms"],
        "backward_plain_ms_train50": bwd50_ms,
        # a --eval_batch 5 lane batch (B = 75): its three calls at N = 30, and at N = 130 (finetune_50)
        "ms_lanes": lanes["ms"],
        "plain_ms_lanes": lanes["plain_ms"],
        "bound_ms_lanes": lanes["bound_ms"],
        "ms_lanes50": lanes50["ms"],
        "bound_ms_lanes50": lanes50["bound_ms"],
        # the synthetic pipeline: one episode of a training step (B = 8), its three forward calls and their plain
        # backward; one held-out batch of 4 lanes (B = 60), its three calls
        "ms_pipeline": pipe["ms"],
        "plain_ms_pipeline": pipe["plain_ms"],
        "bound_ms_pipeline": pipe["bound_ms"],
        "backward_plain_ms_pipeline": bwd_pipe_ms,
        "ms_pipeline_eval": pipe_eval["ms"],
        "plain_ms_pipeline_eval": pipe_eval["plain_ms"],
        "bound_ms_pipeline_eval": pipe_eval["bound_ms"],
    }


def phase_edge_gradient(torch, dev, edge_mlp, shapes):
    """The op's gradient on the card at ``shapes`` (a training step's three
    calls; the kernel's forward, the plain backward) against autograd
    through the plain version, a planted fault beside it, and the plain
    backward's device time.  Returns the step's backward device milliseconds
    (three calls)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bwd_ms = 0.0
    for b, n, f, c in shapes:
        label = f"edge_abs_diff_matmul gradient B={b} N={n} F={f} C={c}"
        x = torch.randn((b, n, f), generator=gen, device=dev)
        w = torch.randn((c, f), generator=gen, device=dev) * 0.05
        bias = torch.randn((c,), generator=gen, device=dev)
        g = torch.randn((b, n, n, c), generator=gen, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        before = edge_mlp.LAUNCHES
        got = torch.autograd.grad(edge_mlp.edge_abs_diff_matmul(*leaves), leaves, g)
        if edge_mlp.LAUNCHES != before + 1:
            fail("edge_abs_diff_matmul with requires_grad did not launch its kernel")
        plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        want = torch.autograd.grad(edge_mlp.edge_abs_diff_matmul_reference(*plain), plain, g)
        errs = {name: float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                for name, a, r in zip(("dx", "dw", "db"), got, want)}
        d = x[:, :, None, :] - x[:, None, :, :]
        bad_dx = (torch.sign(d) * torch.matmul(g, w)).sum(dim=2)
        fault = float((bad_dx - want[0]).abs().max()) / float(want[0].abs().max())
        print(f"{label}: kernel forward + plain backward against autograd of the plain version: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol {EDGE_GRAD_TOL:g} of each gradient's largest value); planted fault ({EDGE_GRAD_FAULT}): "
              f"{fault:.3e}: {'caught' if fault > EDGE_GRAD_TOL else 'passes'}")
        if not all(math.isfinite(v) for v in errs.values()) or max(errs.values()) > EDGE_GRAD_TOL:
            fail(f"edge gradient disagrees with the plain version's at {(b, n, f, c)}: {errs}")
        if not fault > EDGE_GRAD_TOL:
            fail(f"the edge gradient check does not catch {EDGE_GRAD_FAULT}")
        us = device_us(lambda: edge_mlp._edge_bwd(x, w, g))
        bwd_ms += us["total"] * 1e-3
        print(f"{label}: plain backward (_edge_bwd, materializes [B,N,N,F]) device_ms={us['total'] * 1e-3:.5f}")
    print(f"edge_abs_diff_matmul, one training step's three plain backward calls (N = {shapes[0][1]}): device "
          f"{bwd_ms:.5f} ms")
    return bwd_ms


def fused_bound(geom, n_steps: int, carry_bytes: int, bank_bytes: int):
    """Least times for an ``n_steps`` scan of one lane, from the shapes.

    Operations: the products (forward: conv1, conv2, shortcut; backward:
    conv2's weight and input gradients, conv1's and the shortcut's weight
    gradients) over the bf16 tensor-core peak, and over the f32 CUDA-core
    peak that bounds a design without tensor cores.  Bytes the function
    must move: the parameters read once and written once, the bank rows
    that each step gathers, the schedule (idx int32, w f32) and the labels;
    the Adam moments start at zero and are no output, so they need not
    reach device memory at all.  For comparison, the traffic if parameters
    and both bf16 moments were read and written in device memory every step
    (no cache keeping the state).  Returns a dict of those figures."""
    r, ci, co, b = geom.rows, geom.c_in, geom.c_out, geom.batch
    fwd = 2.0 * r * co * (9 * ci + 9 * co + ci)
    bwd = 2.0 * r * co * (9 * co + 9 * co + 9 * ci + ci)
    n_params = 9 * ci * co + 9 * co * co + ci * co + 6 * co
    flops = (fwd + bwd) * n_steps
    nbytes = (2.0 * n_params * carry_bytes + float(n_steps) * b * geom.h_in * geom.h_in * ci * bank_bytes
              + n_steps * b * (4 + 4 + 4))
    state_bytes = float(n_params) * (2 * carry_bytes + 2 * 2 * 2) * n_steps
    return {"flops": flops, "bytes": nbytes, "ms_tc": flops / PEAK_BF16_FLOPS * 1e3,
            "ms_fma": flops / PEAK_F32_FLOPS * 1e3, "ms_bytes": nbytes / PEAK_BYTES * 1e3,
            "state_bytes": state_bytes, "ms_state": state_bytes / PEAK_BYTES * 1e3}


def fused_step_l2_bytes(geom) -> dict:
    """Bytes one step of the tensor-core design moves between L2 and the SMs,
    from the shapes and the kernels' tiling (csrc/fused_inner_scan.cu: 64 x 128
    output tiles fed by stages of 64 reduction elements, K split so that about
    128 blocks run; weight gradients in 128 x 128 tiles fed by stages of 32
    rows; bf16 operands, f32 partial sums and BN state)."""
    r, ci, co = geom.rows, geom.c_in, geom.c_out
    rc, m_tiles, n_tiles = r * co, -(-r // 64), co // 128

    def conv(k):  # operand stages read by every output tile, partial sums written
        kblocks = k // 64
        per_split = -(-kblocks // max(128 // (m_tiles * n_tiles), 1))
        splits = -(-kblocks // per_split)
        return m_tiles * n_tiles * kblocks * (64 + 128) * 64 * 2, splits * rc * 4

    c1, c2, sc = conv(9 * ci), conv(9 * co), (conv(ci)[0], rc * 4)  # the shortcut's K is not split
    products = c1[0] + sc[0] + 2 * c2[0]  # conv1, shortcut, conv2 and its input gradient
    parts = c1[1] + sc[1] + 2 * c2[1]
    wgrad = (9 * ci + 9 * co + ci) // 128 * n_tiles * -(-r // 32) * (128 + 128) * 32 * 2
    n_params = 9 * ci * co + 9 * co * co + ci * co + 6 * co
    adam = n_params * 12  # parameter and both moments, bf16, read and written
    # partial sums read back by the BN kernels; xhat x3, pre (f32) written and read; z1, dy x3 (bf16) written
    bn = parts + 2 * 4 * rc * 4 + 4 * rc * 2
    return {"products": products, "partial sums": parts, "weight gradients": wgrad, "Adam": adam, "BN": bn}


def l2_stream_rate(torch, dev, nbytes: int = 11 << 20) -> float:
    """Bytes per second of a device copy whose source and destination (22 MB
    together, the size of a lane's parameters and moments) stay in the 50 MB
    L2: the rate a streaming pass over L2-resident state can reach."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    # device time from the profiler: by CUDA events a 9 us copy reads as the host's launch rate
    return 2.0 * nbytes / (device_us(lambda: dst.copy_(src), iters=50)["total"] * 1e-6)


def conv_library_ms(torch, which, prod, geom):
    """Yardstick only: the one PyTorch call for the same convolution, bf16,
    channels-last; never called by the port."""
    import torch.nn.functional as F

    b, ci, co, s = geom.batch, geom.c_in, geom.c_out, geom.stride
    first = which.startswith("conv1") or which.startswith("conv_sc")
    k, pad = (1, 0) if which.startswith("conv_sc") else (3, 1)
    cin, stride = (ci, s) if first else (co, 1)
    nchw = lambda t: t.permute(0, 3, 1, 2)  # a channels-last view of the NHWC operand
    w4 = (prod["w"] if prod["w"] is not None else torch.zeros((k * k * cin, co), dtype=torch.bfloat16, device="cuda"))
    w4 = w4.reshape(k, k, cin, co).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    dy4 = None if prod["dy"] is None else nchw(prod["dy"].reshape(b, geom.h_out, geom.h_out, co))
    if which.endswith("_dw"):
        x4 = nchw(prod["x"])
        fn = lambda: torch.nn.grad.conv2d_weight(x4, w4.shape, dy4, stride=stride, padding=pad)
    elif which == "conv2_dx":
        fn = lambda: torch.nn.grad.conv2d_input((b, co, geom.h_out, geom.h_out), w4, dy4, stride=1, padding=1)
    else:
        x4 = nchw(prod["x"])
        fn = lambda: F.conv2d(x4, w4, stride=stride, padding=pad)
    return cuda_time_ms(fn), device_us(fn)["total"]


def phase_fused_products(torch, fis, geom, p_bf16, bank, bank_y, idx_t, w_t, failures):
    """Each of the seven products of a step alone, bf16, at the main path's
    shapes: the tensor-core kernel against the plain product of the same
    operands (those of the plain step), its time beside its operations bound
    and the PyTorch convolution call, and the planted fault."""
    f32 = {k: v.float() for k, v in p_bf16.items()}
    prods = fis.step_products_reference(f32, bank[idx_t], bank_y[idx_t], w_t, geom)
    r = geom.rows
    for which in fis.PRODUCTS:
        prod = prods[which]
        ops = [None if prod[k] is None else prod[k].contiguous() for k in ("w", "x", "dy")]
        got = fis.fused_product(which, *ops, geom)
        fma = fis.fused_product(which, *ops, geom, route="fma")
        torch.cuda.synchronize()
        scale = float(prod["out"].abs().max())
        err = float((got - prod["out"]).abs().max()) / scale
        err_fma = float((fma - prod["out"]).abs().max()) / scale
        flops = 2.0 * prod["out"].shape[0] * prod["out"].shape[1] * (r if which.endswith("_dw") else
                                                                 (prod["w"].shape[0]))
        us = cuda_time_ms(lambda: fis.fused_product(which, *ops, geom)) * 1e3
        us_fma = cuda_time_ms(lambda: fis.fused_product(which, *ops, geom, route="fma")) * 1e3
        dev = device_us(lambda: fis.fused_product(which, *ops, geom))
        dev_fma = device_us(lambda: fis.fused_product(which, *ops, geom, route="fma"))
        mma_us = sum(v for k, v in dev.items() if "_mma_kernel" in k)
        lib_ms, lib_dev_us = conv_library_ms(torch, which, prod, geom)
        bound_us = flops / PEAK_BF16_FLOPS * 1e6
        print(f"fused_product {which} bf16 library (one torch conv call, bf16 channels-last; yardstick only): "
              f"{lib_ms * 1e3:.2f} us by CUDA events, {lib_dev_us:.2f} us on the device")
        print(f"fused_product {which} bf16: tensor cores vs plain {err:.3e} of the output's max (tol "
              f"{FUSED_PRODUCT_TOL:g}), FMA route vs plain {err_fma:.3e}; on the device {mma_us:.2f} us in the product "
              f"kernel, {dev['total']:.2f} us with the sum of its K splits (FMA route {dev_fma['total']:.2f} us); "
              f"{flops / 1e9:.3f} GFLOP, bound {bound_us:.3f} us at the bf16 peak, {bound_us / mma_us:.4f} of the peak; "
              f"by CUDA events behind the Python wrapper {us:.2f} us (FMA route {us_fma:.2f} us)")
        if not (bool(torch.isfinite(got).all()) and err <= FUSED_PRODUCT_TOL and err_fma <= FUSED_PRODUCT_TOL):
            failures.append(f"product {which}")
        if which == "conv1_dw":  # the planted fault
            pieces = fis._patches3x3(fis._pad_hw(prod["x"]), geom.stride)
            pad = (r + 63) // 64 * 64 - r
            a = torch.cat([torch.cat([pc, torch.ones((pad, pc.shape[1]), dtype=pc.dtype, device=pc.device)])
                           for pc in pieces], dim=1)
            dy = torch.cat([prod["dy"], 1e-3 * torch.ones((pad, prod["dy"].shape[1]), dtype=prod["dy"].dtype,
                                                        device=prod["dy"].device)])
            faulty = fis._mm(a.t(), dy)
            reading = float((got - faulty).abs().max()) / scale
            caught = reading > FUSED_PRODUCT_TOL
            print(f"fused_product {which} bf16, plain version with a planted fault ({FUSED_PRODUCT_FAULT}; {pad} such "
                  f"rows): {reading:.3e} against {FUSED_PRODUCT_TOL:g}: {'caught' if caught else 'passes'}")
            if not caught:
                failures.append(f"the product check with {FUSED_PRODUCT_FAULT}")


#: other geometries the tensor-core kernels must take: stride 1, more rows
#: than one BN thread row (256), fewer rows than one 64-row tile, and a
#: shortcut weight (64 rows) smaller than a 128 x 128 weight-gradient tile
FUSED_OTHER_GEOMS = ((8, 64, 128, 1, 7), (6, 128, 256, 2, 3))


def phase_fused_other_geometries(torch, fis, dev, failures):
    """bf16 bank and carry at FUSED_OTHER_GEOMS: one step's gradients against
    the plain version (the bf16 rule), and two scan steps against the plain
    Adam update of the scan's own state and gradients (the replay rule)."""
    tol, allowed, rtol = FUSED_GRAD_TOL["bfloat16"], FUSED_GRAD_FLIP_CHANNELS["bfloat16"], FUSED_REPLAY_RTOL["bfloat16"]
    for dims in FUSED_OTHER_GEOMS:
        geom, span = fis.BlockGeom(*dims), 12
        gen = torch.Generator(device=dev).manual_seed(2)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        p = {k: ((randn(*shape) * (2.0 / shape[0]) ** 0.5) if k.startswith("conv")
                 else (randn(*shape) * 0.1 + (1.0 if k.endswith("_s") else 0.0))).to(torch.bfloat16)
             for k, shape in fis.param_shapes(geom).items()}
        bank = torch.relu(randn(span, geom.h_in, geom.h_in, geom.c_in)).to(torch.bfloat16)
        bank_y = torch.arange(span, device=dev) % 3
        idx = torch.stack([torch.randperm(span, generator=torch.Generator().manual_seed(t))[:geom.batch]
                           for t in range(2)]).to(dev)
        w = torch.ones((2, geom.batch), device=dev)
        w[1, -1] = 0.0
        state, mu, nu = p, *({k: torch.zeros_like(v) for k, v in p.items()} for _ in range(2))
        for t in range(2):
            got, _ = fis.fused_step_grads(state, bank, bank_y, idx[t], w[t], geom=geom)
            want, _ = fis.step_grads_reference({k: v.float() for k, v in state.items()}, bank[idx[t]], bank_y[idx[t]],
                                               w[t], geom)
            errs = {k: (got[k] - want[k]).abs().reshape(-1, want[k].shape[-1]).amax(dim=0)
                    / want[k].abs().max().clamp(min=1e-30) for k in fis.PKEYS}
            worst = max(float(e.max()) for e in errs.values())
            over = max(int((e > tol).sum()) for e in errs.values())
            after = fis.fused_inner_scan(p, bank, bank_y, idx[: t + 1], w[: t + 1], geom=geom, lr=0.01)
            mine, mu, nu = fis.adam_update_reference(state, mu, nu, got, t + 1, 0.01)
            torch.cuda.synchronize()
            close = min(float(((after[k].float() - mine[k].float()).abs() <= 1e-7 + rtol * mine[k].float().abs())
                              .float().mean()) for k in fis.PKEYS)
            print(f"fused scan at {geom}, bf16, step {t + 1}: worst gradient error / max = {worst:.3e} (tol {tol:g}, "
                  f"most channels of a tensor above it {over}, allowed {allowed}); update vs the plain Adam update of "
                  f"its own state and gradients: share within rtol {rtol:g} >= {close:.5f}")
            if not (over <= allowed and worst <= FUSED_GRAD_FLIP_TOL and close >= FUSED_REPLAY_SHARE
                    and all(bool(torch.isfinite(v).all()) for v in after.values())):
                failures.append(f"{geom} step {t + 1}")
            state = after


def phase_fused_64px(torch, fis, dev, failures) -> dict:
    """The scan at the synthetic pipeline's geometry (FUSED_64PX), with the
    bf16 bank and carry of that path, under the bf16 rules and their planted
    faults (fused_scan_checks): one step's gradients, the update rule step
    by step on two lanes, 20-step scans on one and two lanes; then on the
    CHAIN_LANES lanes of a held-out batch (fused_lane_checks), and that
    batch's 500-step scan timed against its bound."""
    from mft_tpu_torch.train.inner_loop import InnerLoopCfg, minibatch_schedule

    geom, span = fis.BlockGeom(*FUSED_64PX), 500
    p32, banks32, bank_y = fused_inputs(torch, fis, geom, span, torch.Generator(device=dev).manual_seed(3))
    idx, w = minibatch_schedule(torch.Generator().manual_seed(4), InnerLoopCfg(1, geom.batch, span), dev)
    w_masked = w.clone()
    w_masked[3, -2:] = 0.0  # one ragged minibatch among the checked steps
    fused_scan_checks(torch, fis, geom, p32, banks32, bank_y, idx, w_masked, 0.01, failures, tag=" 64 px",
                      dtypes=("bfloat16",))
    inputs = fused_lane_checks(torch, fis, dev, geom, CHAIN_LANES, 6, failures, tag=" 64 px")
    t = time_fused_lanes(torch, fis, geom, *inputs, " 64 px")
    return {"ms_pipeline_scan": t["ms"], "bound_ms_pipeline_scan": t["bound_ms"]}


def grad_errors(fis, got, want):
    """Per tensor, per output channel (the last axis): largest error as a
    share of the tensor's largest gradient."""
    return {k: (got[k] - want[k]).abs().reshape(-1, want[k].shape[-1]).amax(dim=0)
            / want[k].abs().max().clamp(min=1e-30) for k in fis.PKEYS}


def fused_scan_checks(torch, fis, geom, p32, banks32, bank_y, idx, w_masked, lr, failures, tag="",
                      dtypes=("float32", "bfloat16")) -> float:
    """The scan's kernels against the plain version on two lanes of
    ``banks32 [2, span, H, H, Ci]`` with schedule ``idx [T, B]`` (lane 1
    walks it backwards) and weights ``w_masked``, in each of ``dtypes``: one step's
    gradients (a full and a ragged minibatch), the first steps on two lanes
    replayed through the plain Adam update, 20-step scans on one and two
    lanes against the floor-based bound with its planted faults, and the
    gradients after 20 plain steps.  Appends what fails to ``failures``;
    returns the worst absolute parameter error after the 20-step scans."""
    idx2 = torch.stack([idx, torch.flip(idx, dims=(0,))])  # lane 1 walks the schedule backwards
    lane = lambda tree, l: {k: v[l] for k, v in tree.items()}
    f32 = lambda tree: {k: v.float() for k, v in tree.items()}
    worst_abs = 0.0

    def check_step_grads(name, label, p_at, t):
        """fused_step_grads against the plain version at the parameters
        ``p_at`` on lane 0's minibatch ``t``; beside it, for scale, the plain
        version against itself with the minibatch's rows in reverse order."""
        i, wt = idx[t], w_masked[t]
        got, loss = fis.fused_step_grads(p_at, banks[0], bank_y, i, wt, geom=geom)
        torch.cuda.synchronize()
        want, want_loss = fis.step_grads_reference(f32(p_at), banks[0][i], bank_y[i], wt, geom)
        ri = torch.flip(i, dims=(0,))
        other, _ = fis.step_grads_reference(f32(p_at), banks[0][ri], bank_y[ri], torch.flip(wt, dims=(0,)), geom)
        errs, own = grad_errors(fis, got, want), max(float(e.max()) for e in grad_errors(fis, other, want).values())
        finite = all(bool(torch.isfinite(v).all()) for v in got.values()) and bool(torch.isfinite(loss))
        tol, allowed = FUSED_GRAD_TOL[name], FUSED_GRAD_FLIP_CHANNELS[name]
        worst = max(float(e.max()) for e in errs.values())
        over = {k: torch.nonzero(e > tol).flatten().tolist() for k, e in errs.items() if bool((e > tol).any())}
        rest = max((float(e[e <= tol].max()) for e in errs.values() if bool((e <= tol).any())), default=float("nan"))
        print(f"fused_step_grads{tag} {name} {label}: loss {float(loss):.6f} vs plain {float(want_loss):.6f}; "
              f"worst gradient error / max = {worst:.3e}; output channels above tol {tol:g}: {over or 'none'} "
              f"(at most {allowed} per tensor, none above {FUSED_GRAD_FLIP_TOL:g}), the others' worst {rest:.3e}; "
              f"plain vs plain with the rows reversed {own:.3e}")
        if not finite or any(len(v) > allowed for v in over.values()) or (over and not worst <= FUSED_GRAD_FLIP_TOL) \
                or not abs(float(loss) - float(want_loss)) <= 1e-3 * abs(float(want_loss)):
            failures.append(f"step gradients{tag} {name} {label}")

    for name in dtypes:
        dt = getattr(torch, name)
        p = {k: v.to(dt) for k, v in p32.items()}
        banks = banks32.to(dt)
        zeros = lambda l: {k: torch.zeros_like(v[l], dtype=torch.bfloat16) for k, v in p.items()}
        # (a) one step's gradients, a full and a ragged minibatch
        check_step_grads(name, "step 0", lane(p, 0), 0)
        check_step_grads(name, "step 3 (ragged)", lane(p, 0), 3)

        # (b) the scan: the first steps on two lanes (kept for the replay
        # below), then 20 steps normwise on one lane and on two
        def plain_steps(pl, mu, nu, bank, idx_l, n_steps):
            """The plain scan step by step from any state (what
            fused_inner_scan_reference does from zero moments)."""
            for t in range(n_steps):
                g, _ = fis.step_grads_reference(f32(pl), bank[idx_l[t]], bank_y[idx_l[t]], w_masked[t], geom)
                pl, mu, nu = fis.adam_update_reference(pl, mu, nu, g, t + 1, lr)
            return pl, mu, nu

        moved_share = lambda a, b, start: {k: float((a[k].double() - b[k].double()).norm())
                                           / float((b[k].double() - start[k].double()).norm()) for k in fis.PKEYS}
        want20 = {l: fis.fused_inner_scan_reference(lane(p, l), banks[l], bank_y, idx2[l, :20], w_masked[:20],
                                                    geom=geom, lr=lr) for l in (0, 1)}
        tol20 = {}
        for l in (0, 1):  # plain vs plain with every minibatch's rows reversed: the floor, and the bound from it
            other = fis.fused_inner_scan_reference(lane(p, l), banks[l], bank_y, torch.flip(idx2[l, :20], dims=(1,)),
                                                   torch.flip(w_masked[:20], dims=(1,)), geom=geom, lr=lr)
            floor = max(moved_share(other, want20[l], lane(p, l)).values())
            tol20[l] = (floor, min(FUSED_SCAN_FLOOR_FACTOR * floor, FUSED_SCAN_CAP))
        states = {l: {0: lane(p, l)} for l in (0, 1)}  # lane -> steps -> that lane after a two-lane kernel scan
        for n_steps, lanes in [(n, 2) for n in range(1, FUSED_REPLAY_STEPS + 1)] + [(20, 1), (20, 2)]:
            before = fis.LAUNCHES
            got = fis.fused_inner_scan_lanes({k: v[:lanes] for k, v in p.items()}, banks[:lanes].contiguous(), bank_y,
                                             idx2[:lanes, :n_steps].contiguous(), w_masked[:n_steps], geom=geom, lr=lr)
            torch.cuda.synchronize()
            if fis.LAUNCHES != before + 1:
                fail("fused_inner_scan_lanes did not launch its kernels on CUDA tensors")
            for l in range(lanes):
                label = f"fused_inner_scan{tag} {name} carry, T={n_steps}, L={lanes} lane {l}"
                if not all(bool(torch.isfinite(v[l]).all()) for v in got.values()):
                    failures.append(f"{label}: not finite")
                if n_steps < 20:
                    states[l][n_steps] = lane(got, l)
                    continue
                worst_abs = max(worst_abs, max(float((got[k][l].float() - want20[l][k].float()).abs().max())
                                               for k in fis.PKEYS))
                rel = moved_share(lane(got, l), want20[l], lane(p, l))
                k_worst = max(rel, key=rel.get)
                floor, tol = tol20[l]
                print(f"{label}: worst |kernel - plain| / |plain - start| = {rel[k_worst]:.3e} ({k_worst}); "
                      f"plain vs plain in another summation order {floor:.3e}; tol {tol:.3e} "
                      f"(min of {FUSED_SCAN_FLOOR_FACTOR:g} x that and {FUSED_SCAN_CAP:g})")
                if not rel[k_worst] <= tol:
                    failures.append(label)
        # what that 20-step bound catches: the plain version of lane 1 with a fault planted through its arguments
        _, mu0, nu0 = plain_steps(lane(p, 0), zeros(0), zeros(0), banks[0], idx2[0], 20)
        planted = {"no fault": (zeros(1), zeros(1), banks[1]),
                   FUSED_PLANTED_FAULTS[0]: (mu0, nu0, banks[1]),
                   FUSED_PLANTED_FAULTS[1]: (zeros(1), zeros(1), banks[0])}
        for fault, (mu, nu, bank) in planted.items():
            faulty, _, _ = plain_steps(lane(p, 1), mu, nu, bank, idx2[1], 20)
            reading = max(moved_share(faulty, want20[1], lane(p, 1)).values())
            caught = reading > tol20[1][1]
            print(f"fused_inner_scan{tag} {name} carry, T=20, lane 1, plain version with a planted fault ({fault}): worst "
                  f"share {reading:.3e} against the bound {tol20[1][1]:.3e}: {'caught' if caught else 'passes'}")
            if caught == (fault == "no fault"):
                failures.append(f"the 20-step bound{tag} {name} with {fault}")
        # the update rule, step by step from the scan's own states, on both lanes
        rtol = FUSED_REPLAY_RTOL[name]
        for l in (0, 1):
            mu, nu = zeros(l), zeros(l)
            for t in range(FUSED_REPLAY_STEPS):
                g, _ = fis.fused_step_grads(states[l][t], banks[l], bank_y, idx2[l, t], w_masked[t], geom=geom)
                mine, mu, nu = fis.adam_update_reference(states[l][t], mu, nu, g, t + 1, lr)
                close = {k: float(((states[l][t + 1][k].float() - mine[k].float()).abs()
                                   <= 1e-7 + rtol * mine[k].float().abs()).float().mean()) for k in fis.PKEYS}
                k_worst = min(close, key=close.get)
                print(f"fused_inner_scan{tag} {name} carry, L=2 lane {l}, step {t + 1} vs the plain Adam update of its own "
                      f"state and gradients: share of elements within rtol {rtol:g} >= {close[k_worst]:.5f} "
                      f"({k_worst}) (at least {FUSED_REPLAY_SHARE:g})")
                if not close[k_worst] >= FUSED_REPLAY_SHARE:
                    failures.append(f"update rule{tag} {name} lane {l} step {t + 1}")
        # the gradients once more, where the plain 20-step scan ended: the
        # kernels on adapted weights, free of the two trajectories' parting
        check_step_grads(name, "after 20 plain steps", want20[0], 20)
    return worst_abs


def fused_inputs(torch, fis, geom, span, gen):
    """Two lanes of parameters (f32, fan-in normal convs as the backbone's
    init, BN scales near 1), two ``[span, H, H, Ci]`` banks (after a ReLU, as
    the trunk's output) and the labels, drawn from the device generator ``gen``."""
    randn = lambda *s: torch.randn(s, generator=gen, device=gen.device)
    p32 = {k: (randn(2, *shape) * (2.0 / shape[0]) ** 0.5 if k.startswith("conv")
               else randn(2, *shape) * 0.1 + (1.0 if k.endswith("_s") else 0.0))
           for k, shape in fis.param_shapes(geom).items()}
    banks32 = torch.relu(randn(2, span, geom.h_in, geom.h_in, geom.c_in))
    return p32, banks32, torch.arange(span, device=gen.device) % 5


def phase_fused_inner_scan(torch, dev):
    """The fused inner scan's kernels against the plain version on the card,
    at the main path's geometry (ResNet10's final block at 224 px: 14x14x256
    -> 7x7x512, minibatches of 5 out of a 500-row bank)."""
    from mft_tpu_torch.kernels import fused_inner_scan as fis
    from mft_tpu_torch.train.inner_loop import InnerLoopCfg, minibatch_schedule

    geom, span, lr = fis.BlockGeom(), 500, 0.01
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    shapes = fis.param_shapes(geom)
    p32, banks32, bank_y = fused_inputs(torch, fis, geom, span, gen)
    idx, w = minibatch_schedule(torch.Generator().manual_seed(1), InnerLoopCfg(5, geom.batch, span), dev)
    w_masked = w.clone()
    w_masked[3, -2:] = 0.0  # one ragged minibatch among the checked steps
    lane = lambda tree, l: {k: v[l] for k, v in tree.items()}
    f32 = lambda tree: {k: v.float() for k, v in tree.items()}
    failures = []

    # a geometry the kernels do not take is refused before any launch
    bad = fis.BlockGeom(6, 8, 16, 2, 2)
    before = fis.LAUNCHES
    try:
        fis.fused_inner_scan({k: randn(*shape) for k, shape in fis.param_shapes(bad).items()}, randn(4, 6, 6, 8),
                             bank_y[:4], idx[:1, :2] % 4, w[:1, :2], geom=bad, lr=lr)
        failures.append(f"{bad} was not refused")
    except ValueError as e:
        print(f"fused_inner_scan refuses {bad}: {str(e)[:60]}...")
    if fis.LAUNCHES != before:
        failures.append("a refused call counted as a launch")

    worst_abs = fused_scan_checks(torch, fis, geom, p32, banks32, bank_y, idx, w_masked, lr, failures)
    # (b2) the tensor-core route (a bf16 bank's own) on its own terms
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    banks = banks32.to(torch.bfloat16)
    phase_fused_products(torch, fis, geom, lane(p16, 0), banks[0], bank_y, idx[3], w_masked[3], failures)
    phase_fused_other_geometries(torch, fis, dev, failures)
    pipeline_scan = phase_fused_64px(torch, fis, dev, failures)
    tol, allowed = FUSED_GRAD_TOL["bfloat16"], FUSED_GRAD_FLIP_CHANNELS["bfloat16"]
    for label, p_at in (("bf16 carry", lane(p16, 0)), ("f32 carry, bf16 bank", lane(p32, 0))):
        # one step's gradients by both routes on the card; the f32 carry also against the plain version
        tc, tc_loss = fis.fused_step_grads(p_at, banks[0], bank_y, idx[3], w_masked[3], geom=geom)
        fma, fma_loss = fis.fused_step_grads(p_at, banks[0], bank_y, idx[3], w_masked[3], geom=geom, route="fma")
        want, _ = fis.step_grads_reference(f32(p_at), banks[0][idx[3]], bank_y[idx[3]], w_masked[3], geom)
        torch.cuda.synchronize()
        for other_name, other in (("the FMA route", fma), ("the plain version", want)):
            errs = grad_errors(fis, tc, other)
            worst = max(float(e.max()) for e in errs.values())
            over = {k: torch.nonzero(e > tol).flatten().tolist() for k, e in errs.items() if bool((e > tol).any())}
            print(f"fused_step_grads {label}, step 3 (ragged): tensor-core route vs {other_name}: worst gradient "
                  f"error / max = {worst:.3e}; output channels above tol {tol:g}: {over or 'none'} (at most {allowed} "
                  f"per tensor, none above {FUSED_GRAD_FLIP_TOL:g}); loss {float(tc_loss):.6f} vs FMA "
                  f"{float(fma_loss):.6f}")
            if any(len(v) > allowed for v in over.values()) or (over and not worst <= FUSED_GRAD_FLIP_TOL):
                failures.append(f"step gradients, tensor-core route vs {other_name}, {label}")
    if failures:
        fail("the fused inner scan disagrees with its plain version: " + ", ".join(failures))

    # (c) the full scan: 500 steps, bf16 carry and bank, one lane
    p = {k: v[0].to(torch.bfloat16) for k, v in p32.items()}
    bank = banks32[0].to(torch.bfloat16)
    n_steps = idx.shape[0]
    out = fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr)
    torch.cuda.synchronize()
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape or out[k].dtype != torch.bfloat16 or not bool(torch.isfinite(out[k]).all()):
            fail(f"the {n_steps}-step scan's {k} is not a finite bfloat16 {shape}")
    ms = cuda_time_ms(lambda: fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr), iters=3, warmup=1)
    plain_ms = cuda_time_ms(lambda: fis.fused_inner_scan_reference(p, bank, bank_y, idx, w, geom=geom, lr=lr),
                            iters=1, warmup=0)
    # where a step's device time goes, kernel by kernel (the profiler over a short scan)
    short = device_us(lambda: fis.fused_inner_scan(p, bank, bank_y, idx[:FUSED_ENQUEUE_STEPS], w[:FUSED_ENQUEUE_STEPS],
                                                   geom=geom, lr=lr), iters=2)
    per_kernel = sorted(((k, v / FUSED_ENQUEUE_STEPS) for k, v in short.items() if k != "total"), key=lambda kv: -kv[1])
    print(f"fused_inner_scan bf16 L=1, device us per step by kernel ({FUSED_ENQUEUE_STEPS}-step scans under the "
          f"profiler, {short['total'] / FUSED_ENQUEUE_STEPS:.2f} us in all): "
          + "; ".join(f"{v:.2f} {short_name(k)}" for k, v in per_kernel))
    b = fused_bound(geom, n_steps, 2, 2)
    bound_ms = max(b["ms_tc"], b["ms_bytes"])
    per_step = fis.kernels_per_step(torch.bfloat16)
    label = f"fused_inner_scan T={n_steps} bf16 L=1"
    # the host's share: seconds inside the C call (enqueue, no synchronise) beside the device's
    torch.cuda.synchronize()
    fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr)
    host_full = fis.LAST_ENQUEUE_SECONDS
    torch.cuda.synchronize()
    fis.fused_inner_scan(p, bank, bank_y, idx[:FUSED_ENQUEUE_STEPS], w[:FUSED_ENQUEUE_STEPS], geom=geom, lr=lr)
    host_short = fis.LAST_ENQUEUE_SECONDS
    torch.cuda.synchronize()
    enqueue_us = host_short / FUSED_ENQUEUE_STEPS * 1e6
    print(f"{label}: host inside the C call {host_full * 1e3:.3f} ms for {n_steps} steps (the launch queue fills, so "
          f"this follows the device); {FUSED_ENQUEUE_STEPS} steps, which fit the queue: {host_short * 1e3:.3f} ms = "
          f"{enqueue_us:.2f} us per step to enqueue against {ms / n_steps * 1e3:.2f} us per step on the device: "
          f"enqueue / device = {enqueue_us / (ms / n_steps * 1e3):.3f}")
    print(f"{label}: kernel_ms={ms:.3f} ({ms / n_steps * 1e3:.1f} us per step, {per_step} device kernels per step, "
          f"{per_step * n_steps} per call)")
    print(f"{label}: plain_ms={plain_ms:.3f} (one run of all {n_steps} steps, no warm-up)")
    print(f"{label}: {b['flops'] / 1e12:.3f} TFLOP -> bf16 tensor cores {b['ms_tc']:.3f} ms; {b['bytes'] / 1e9:.4f} GB "
          f"that must move (parameters in and out, gathered bank rows, schedule) -> {b['ms_bytes']:.3f} ms; "
          f"bound_ms={bound_ms:.3f}; the kernels take {ms / bound_ms:.1f} x that")
    print(f"{label}: f32 FMA bound of this design {b['ms_fma']:.3f} ms; the kernels reach {b['ms_fma'] / ms:.3f} of it "
          f"({b['flops'] / ms / 1e9:.2f} TFLOP/s)")
    l2 = fused_step_l2_bytes(geom)
    rate = l2_stream_rate(torch, dev)
    l2_us = sum(l2.values()) / rate * 1e6
    print(f"{label}: L2 traffic of one step of this design, from the shapes and the tiling: "
          + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in l2.items())
          + f"; {sum(l2.values()) / 1e6:.1f} MB in all -> {l2_us:.1f} us a step, {l2_us * n_steps / 1e3:.3f} ms for "
          f"{n_steps} steps at {rate / 1e12:.3f} TB/s, the rate of a 22 MB device copy that stays in L2 (measured here)")
    print(f"{label}: if no cache kept the state, parameters and both moments in and out of device memory every step "
          f"would be {b['state_bytes'] / 1e9:.2f} GB, {b['ms_state']:.3f} ms (not the bound: the state fits L2)")
    return {
        "name": "fused_inner_scan",
        "route": "cuda",
        "source": "mft_tpu_torch/kernels/csrc/fused_inner_scan.cu",
        "replaces": "mft_tpu/ops/pallas/fused_inner_scan.py:386",
        "max_abs_err": worst_abs,  # adapted parameters after the 20-step scans, worst case
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if b["ms_tc"] >= b["ms_bytes"] else "bytes",
        "library_ms": None,  # no single PyTorch call computes a 500-step adaptation scan
        **pipeline_scan,  # the synthetic pipeline's held-out batch: 4 lanes at 64 px, 500 steps
    }


#: the 50-shot bank: 20 replica groups (17 augmented + the clean support
#: three times) of 5-way 50-shot supports, one inner epoch of 1000 minibatches
#: of 5, fine_tune_epoch = 5
FUSED_SPAN_50, FUSED_STEPS_50 = 5000, 5000
#: what the 5000-row bank is checked for.  Against the plain version: the
#: bf16 bank and carry of the 50-shot main path, under the bf16 rules above
#: (their planted faults included).  The f32 rules were tried there first (on
#: an H100 80GB HBM3 at 700 W): the step holding row 4999 read 4.2e-4 in conv1's
#: gradient, because one pre-activation of the final ReLU (channel 367) lies
#: 2.8e-7 from 0 against a typical 0.96, within f32 rounding, and the kernel's
#: f32 sums put it on the other side of the ReLU from the plain version's; a
#: flip the f32 rules allow no channel for, which the data of the 500-row
#: checks happen not to hold.  What the large bank itself adds, the gather
#: of far rows, is checked exactly in both dtypes: the kernels on rows at the
#: top of the 5000-row bank give bit for bit what they give on the same rows
#: copied to the bottom of a small bank (one step's gradients and loss, and
#: a 20-step scan on two lanes); a planted fault (the small bank built from
#: the rows one above) must not.
FUSED_RELOCATE_FAULT = "the small bank built from the rows one above"


def fused_relocation_check(torch, fis, geom, p32, banks32, bank_y, idx, w, lr, failures):
    """The kernels on the large bank against the kernels on the same rows
    relocated to a small bank, bit for bit, in f32 and bf16: one step's
    gradients and loss at the first three steps (rows span-1, span-2 and
    span-3 among them), and a 20-step two-lane scan; with the planted fault
    ``FUSED_RELOCATE_FAULT`` beside it."""
    span = banks32.shape[1]
    lane = lambda tree, l: {k: v[l] for k, v in tree.items()}
    idx2 = torch.stack([idx[:20], torch.flip(idx, dims=(0,))[:20]])
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        p, banks = {k: v.to(dt) for k, v in p32.items()}, banks32.to(dt)
        for t in range(3):
            big = fis.fused_step_grads(lane(p, 0), banks[0], bank_y, idx[t], w[t], geom=geom)
            fault = torch.clamp(idx[t] + 1, max=span - 1)
            for label, rows in (("relocated", idx[t]), (FUSED_RELOCATE_FAULT, fault)):
                small = fis.fused_step_grads(lane(p, 0), banks[0][rows].contiguous(), bank_y[rows].contiguous(),
                                             torch.arange(geom.batch, device=idx.device), w[t], geom=geom)
                same = all(torch.equal(big[0][k], small[0][k]) for k in fis.PKEYS) and torch.equal(big[1], small[1])
                if label == "relocated":
                    print(f"fused_step_grads {name} step {t}, rows {idx[t].tolist()} of {span} against the same rows at "
                          f"0..{geom.batch - 1} of a {geom.batch}-row bank: {'bit for bit equal' if same else 'DIFFER'}")
                    if not same:
                        failures.append(f"relocated rows {name} step {t}")
                elif same:
                    failures.append(f"the relocation check with {FUSED_RELOCATE_FAULT} ({name} step {t})")
        rows = torch.unique(idx2)
        remap = torch.full((span,), -1, dtype=idx.dtype, device=idx.device)
        remap[rows] = torch.arange(rows.numel(), dtype=idx.dtype, device=idx.device)
        big = fis.fused_inner_scan_lanes(p, banks, bank_y, idx2, w[:20], geom=geom, lr=lr)
        small = fis.fused_inner_scan_lanes(p, banks[:, rows].contiguous(), bank_y[rows].contiguous(),
                                           remap[idx2].contiguous(), w[:20], geom=geom, lr=lr)
        same = all(torch.equal(big[k], small[k]) for k in fis.PKEYS)
        print(f"fused_inner_scan {name} carry, T=20, L=2 on {span} rows (up to {int(idx2.max())}) against the same "
              f"{rows.numel()} rows relocated to a small bank: {'bit for bit equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"relocated rows {name} 20-step scan")


def phase_fused_inner_scan_50(torch, dev):
    """The fused scan at the 50-shot bank geometry: span 5000 (the kernels
    take up to 32767 rows), the schedule's first steps gathering the last
    rows, under the bf16 checks and planted faults of the 500-row bank (two
    lanes) and the relocation check in both dtypes (FUSED_SPAN_50's note);
    then the 5000-step scan timed by CUDA events beside its bound."""
    from mft_tpu_torch.kernels import fused_inner_scan as fis
    from mft_tpu_torch.train.inner_loop import InnerLoopCfg, minibatch_schedule

    geom, span, lr = fis.BlockGeom(), FUSED_SPAN_50, 0.01
    p32, banks32, bank_y = fused_inputs(torch, fis, geom, span, torch.Generator(device=dev).manual_seed(5))
    icfg = InnerLoopCfg(FUSED_STEPS_50 * geom.batch // span, geom.batch, span)
    idx, w = minibatch_schedule(torch.Generator().manual_seed(6), icfg, dev)
    # the first checked steps gather the bank's last rows: the minibatches of
    # the first epoch that hold rows span-1, span-2, span-3 move to its front
    for pos, row in enumerate((span - 1, span - 2, span - 3)):
        at = int(torch.nonzero((idx[: icfg.steps_per_epoch] == row).any(dim=1))[0])
        if at > pos:
            idx[[pos, at]] = idx[[at, pos]]
    w_masked = w.clone()
    w_masked[3, -2:] = 0.0
    print(f"fused scan, 50-shot bank: span {span}, {idx.shape[0]} steps; rows gathered by the first 20 steps reach "
          f"{int(idx[:20].max())}")
    failures = []
    worst_abs = fused_scan_checks(torch, fis, geom, p32, banks32, bank_y, idx, w_masked, lr, failures,
                                  tag=f" (span {span})", dtypes=("bfloat16",))
    fused_relocation_check(torch, fis, geom, p32, banks32, bank_y, idx, w_masked, lr, failures)
    if failures:
        fail("the fused inner scan disagrees with its plain version on the 50-shot bank: " + ", ".join(failures))
    p = {k: v[0].to(torch.bfloat16) for k, v in p32.items()}
    bank = banks32[0].to(torch.bfloat16)
    del banks32
    out = fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        fail("the 5000-step scan's parameters are not finite")
    ms = cuda_time_ms(lambda: fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr), iters=3, warmup=1)
    b = fused_bound(geom, idx.shape[0], 2, 2)
    bound_ms = max(b["ms_tc"], b["ms_bytes"])
    label = f"fused_inner_scan T={idx.shape[0]} bf16 L=1 span {span}"
    print(f"{label}: kernel_ms={ms:.3f} ({ms / idx.shape[0] * 1e3:.1f} us per step)")
    print(f"{label}: {b['flops'] / 1e12:.3f} TFLOP -> bf16 tensor cores {b['ms_tc']:.3f} ms; {b['bytes'] / 1e9:.4f} GB "
          f"that must move -> {b['ms_bytes']:.3f} ms; bound_ms={bound_ms:.3f}; the kernels take {ms / bound_ms:.1f} x that")
    return {"ms_50": ms, "bound_ms_50": bound_ms, "max_abs_err_50": worst_abs}

#: faults the lane check must catch: lane 0's plain scan on its neighbour's bank, or on its neighbour's schedule
FUSED_LANE_FAULTS = ("lane 0 reads lane 1's bank", "lane 0 reads lane 1's schedule")


def fused_lane_checks(torch, fis, dev, geom, lanes: int, seed: int, failures, tag: str = ""):
    """The fused scan on ``lanes`` lanes at ``geom``, as a lane batch of the
    eval calls it: a 500-row bf16 bank and a schedule of its own per lane
    (5 epochs), the labels and weights shared, bf16 carry.  The update rule
    step by step on every lane (the kernels' state after 1 to
    FUSED_REPLAY_STEPS steps against the plain Adam update of its own state
    and the kernels' gradients), 20-step scans of all lanes in one call
    against the floor-based bound, and planted lane faults (lane 0 on its
    neighbour's bank, then on its neighbour's schedule) that the bound must
    catch.  Appends what fails to ``failures``; returns the inputs
    ``(params, banks, bank_y, idx, w)``."""
    from mft_tpu_torch.train.inner_loop import InnerLoopCfg, lane_schedule

    span, lr = 500, 0.01
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    p16 = {k: (randn(lanes, *shape) * (2.0 / shape[0]) ** 0.5 if k.startswith("conv")
               else randn(lanes, *shape) * 0.1 + (1.0 if k.endswith("_s") else 0.0)).to(torch.bfloat16)
           for k, shape in fis.param_shapes(geom).items()}
    banks = torch.relu(randn(lanes, span, geom.h_in, geom.h_in, geom.c_in)).to(torch.bfloat16)
    bank_y = torch.arange(span, device=dev) % 5
    idx, w = lane_schedule([torch.Generator().manual_seed(20 + l) for l in range(lanes)],
                           InnerLoopCfg(5, geom.batch, span), dev)
    lane = lambda tree, l: {k: v[l] for k, v in tree.items()}
    zeros = lambda: {k: torch.zeros_like(v[0]) for k, v in p16.items()}
    moved_share = lambda a, b, start: {k: float((a[k].double() - b[k].double()).norm())
                                       / float((b[k].double() - start[k].double()).norm()) for k in fis.PKEYS}
    tag = f"fused_inner_scan{tag} bf16 carry, L={lanes}"
    states = {l: [lane(p16, l)] for l in range(lanes)}
    for n in range(1, FUSED_REPLAY_STEPS + 1):
        got = fis.fused_inner_scan_lanes(p16, banks, bank_y, idx[:, :n].contiguous(), w[:n], geom=geom, lr=lr)
        for l in range(lanes):
            states[l].append(lane(got, l))
    rtol, worst_share = FUSED_REPLAY_RTOL["bfloat16"], 1.0
    for l in range(lanes):
        mu, nu = zeros(), zeros()
        for t in range(FUSED_REPLAY_STEPS):
            g, _ = fis.fused_step_grads(states[l][t], banks[l], bank_y, idx[l, t], w[t], geom=geom)
            mine, mu, nu = fis.adam_update_reference(states[l][t], mu, nu, g, t + 1, lr)
            close = min(float(((states[l][t + 1][k].float() - mine[k].float()).abs()
                               <= 1e-7 + rtol * mine[k].float().abs()).float().mean()) for k in fis.PKEYS)
            worst_share = min(worst_share, close)
            if not close >= FUSED_REPLAY_SHARE:
                failures.append(f"{tag}: update rule, lane {l} step {t + 1}")
    print(f"{tag}: steps 1-{FUSED_REPLAY_STEPS} of every lane vs the plain Adam update of its own state and gradients: "
          f"share of elements within rtol {rtol:g} >= {worst_share:.5f} (at least {FUSED_REPLAY_SHARE:g})")
    want20 = [fis.fused_inner_scan_reference(lane(p16, l), banks[l], bank_y, idx[l, :20], w[:20], geom=geom, lr=lr)
              for l in range(lanes)]
    got20 = fis.fused_inner_scan_lanes(p16, banks, bank_y, idx[:, :20].contiguous(), w[:20], geom=geom, lr=lr)
    tols = []
    for l in range(lanes):  # the floor: plain vs plain with every minibatch's rows reversed
        other = fis.fused_inner_scan_reference(lane(p16, l), banks[l], bank_y, torch.flip(idx[l, :20], dims=(1,)),
                                               torch.flip(w[:20], dims=(1,)), geom=geom, lr=lr)
        floor = max(moved_share(other, want20[l], lane(p16, l)).values())
        tols.append(min(FUSED_SCAN_FLOOR_FACTOR * floor, FUSED_SCAN_CAP))
        rel = max(moved_share(lane(got20, l), want20[l], lane(p16, l)).values())
        print(f"{tag}, T=20 lane {l}: worst |kernel - plain| / |plain - start| = {rel:.3e}; floor {floor:.3e}, tol "
              f"{tols[l]:.3e}")
        if not (rel <= tols[l] and all(bool(torch.isfinite(v[l]).all()) for v in got20.values())):
            failures.append(f"{tag}: 20 steps, lane {l}")
    planted = {"no fault": (banks[0], idx[0]), FUSED_LANE_FAULTS[0]: (banks[1], idx[0]),
               FUSED_LANE_FAULTS[1]: (banks[0], idx[1])}
    for fault, (bank, sched) in planted.items():
        faulty = fis.fused_inner_scan_reference(lane(p16, 0), bank, bank_y, sched[:20], w[:20], geom=geom, lr=lr)
        reading = max(moved_share(faulty, want20[0], lane(p16, 0)).values())
        caught = reading > tols[0]
        print(f"{tag}, T=20 lane 0, plain version with a planted fault ({fault}): worst share {reading:.3e} against "
              f"the bound {tols[0]:.3e}: {'caught' if caught else 'passes'}")
        if caught == (fault == "no fault"):
            failures.append(f"{tag}: the lane bound with {fault}")
    return p16, banks, bank_y, idx, w


def time_fused_lanes(torch, fis, geom, p16, banks, bank_y, idx, w, label: str) -> dict:
    """The whole scan (every step of ``idx``) on all lanes, whose steps share
    each step's grids, timed beside one lane in the same call and against
    that lane's time as many times over as there are lanes (the lanes run in
    turn); the bound is the lanes' operations or bytes."""
    lanes, n_steps, lr = banks.shape[0], idx.shape[1], 0.01
    one = cuda_time_ms(lambda: fis.fused_inner_scan_lanes({k: v[:1] for k, v in p16.items()}, banks[:1], bank_y,
                                                          idx[:1], w, geom=geom, lr=lr), iters=2, warmup=1)
    ms = cuda_time_ms(lambda: fis.fused_inner_scan_lanes(p16, banks, bank_y, idx, w, geom=geom, lr=lr), iters=2,
                      warmup=1)
    b = fused_bound(geom, n_steps, 2, 2)
    bound_ms = lanes * max(b["ms_tc"], b["ms_bytes"])
    print(f"fused_inner_scan{label} T={n_steps} bf16 L={lanes}: kernel_ms={ms:.3f}, the lanes together, against L=1 "
          f"{one:.3f} in the same call ({ms / one:.2f} x one lane's; {lanes} lanes in turn would take "
          f"{lanes * one:.3f}, {lanes * one / ms:.2f} x the lanes together); bound_ms={bound_ms:.3f} ({lanes} lanes' "
          f"{'operations' if b['ms_tc'] >= b['ms_bytes'] else 'bytes'})")
    return {"ms": ms, "bound_ms": bound_ms, "one": one}


def fused_lanes_bitwise(fis, geom, p16, banks, bank_y, idx, w, failures, n_steps: int = 20):
    """Every lane of one ``n_steps``-step call bit for bit against a call
    with that lane alone (same parameters, bank and schedule): a lane's
    tiling, split-K chunks and summation order do not depend on the lanes
    beside it.  Appends each lane that differs to ``failures``."""
    lanes, lr = banks.shape[0], 0.01
    idx, w = idx[:, :n_steps].contiguous(), w[:n_steps]
    got = fis.fused_inner_scan_lanes(p16, banks, bank_y, idx, w, geom=geom, lr=lr)
    differ = []
    for l in range(lanes):
        one = fis.fused_inner_scan_lanes({k: v[l:l + 1] for k, v in p16.items()}, banks[l:l + 1], bank_y,
                                         idx[l:l + 1], w, geom=geom, lr=lr)
        if not all(bool((got[k][l] == one[k][0]).all()) for k in fis.PKEYS):
            differ.append(l)
    print(f"fused_inner_scan bf16 carry, L={lanes}, T={n_steps}: each lane against its single-lane call: "
          f"{lanes - len(differ)} of {lanes} bit for bit" + (f" (differ: lanes {differ})" if differ else ""))
    failures += [f"fused_inner_scan L={lanes}: lane {l} differs from its single-lane call" for l in differ]


def phase_fused_lanes(torch, dev):
    """The fused scan on LANES lanes at the main path's geometry, as
    ``--eval_batch 5`` calls it, and on CELL_LANES, as the benchmark's cells
    call it (fused_lane_checks; at CELL_LANES each lane also bit for bit
    against its single-lane call); then the 500-step scan on both, whose
    steps share each step's grids, timed beside one lane."""
    from mft_tpu_torch.kernels import fused_inner_scan as fis

    failures, geom = [], fis.BlockGeom()
    inputs = fused_lane_checks(torch, fis, dev, geom, LANES, 5, failures)
    cell = fused_lane_checks(torch, fis, dev, geom, CELL_LANES, 7, failures)
    fused_lanes_bitwise(fis, geom, *cell, failures)
    if failures:
        fail(f"the fused inner scan on {LANES} and {CELL_LANES} lanes: " + ", ".join(failures))
    t = time_fused_lanes(torch, fis, geom, *inputs, "")
    tc = time_fused_lanes(torch, fis, geom, *cell, "")
    return {"ms_lanes": t["ms"], "bound_ms_lanes": t["bound_ms"], "ms_lanes_one": t["one"],
            "ms_lanes_cell": tc["ms"], "bound_ms_lanes_cell": tc["bound_ms"]}


def phase_cross_device(torch, dev):
    """One small episode on the card (edge kernel on) and on the CPU (plain
    versions), same weights, draws and schedule (one seeded generator, whose
    draws are made on the CPU for both: the replicas' augment parameters, the
    classifier init head0, the inner schedule): strict f32 with the eager
    inner loop, then bf16 Adam moments with the fused scan (its kernels on
    the card, its plain version on the CPU), then the faithful minibatch BN
    mode (strict f32, eager; the whole backbone every inner step).  Without inner steps the
    scores must agree to XDEV_TOL; with one epoch of each member the argmax
    must agree (a few Adam steps amplify rounding, since each first step
    moves every weight by about lr whatever the gradient's size)."""
    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.ops.augment import AugmentCfg
    from mft_tpu_torch.train import eval_engine as ee

    spec = EpisodeSpec(5, 5, 3)
    bcfg = bb.resnet10()
    gcfg = gn.GnnNetCfg(use_pallas=True)
    aug = AugmentCfg(image_size=32)
    g = torch.Generator().manual_seed(1)
    bp, bs = bb.init_backbone(g, bcfg)
    gp, gs = bb.init_backbone(g, bcfg)
    head = gn.init_head(g, gcfg)
    images = np.random.RandomState(2).randint(0, 256, (5, 8, 36, 36, 3), dtype=np.uint8)
    to = lambda t, d: {k: to(v, d) for k, v in t.items()} if isinstance(t, dict) else (
        [to(v, d) for v in t] if isinstance(t, list) else t.to(d))
    runs = ((0, "eager", "episode"), (1, "eager", "episode"), (0, "fused", "episode"), (1, "fused", "episode"),
            (0, "eager", "minibatch"), (1, "eager", "minibatch"))
    for epochs, mode, bn_mode in runs:
        tcfg = ee.TransferCfg(fine_tune_epochs=epochs, linear_epochs=epochs, inner_scan=mode, bn_mode=bn_mode,
                              opt_state_dtype="float32" if mode == "eager" else "bfloat16")
        program = ee.make_eval_program(method="all", bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=tcfg, aug_cfg=aug,
                                       gen_examples=1)
        scores = {}
        for d in ("cpu", dev):
            models = {"baseline": (to(bp, d), to(bs, d)), "gnn": (to(gp, d), to(gs, d), to(head, d))}
            base = torch.from_numpy(images).to(d).permute(0, 1, 4, 2, 3)
            scores[d] = program(models, base[None], [torch.Generator().manual_seed(3)])[0][0]
        diff = float((scores[dev].cpu() - scores["cpu"]).abs().max())
        agree = bool((scores[dev].cpu().argmax(1) == scores["cpu"].argmax(1)).all())
        print(f"card vs CPU eval (32 px, f32, {bn_mode} BN mode, {mode} inner loop, {epochs} inner epochs): max |d scores| "
              f"= {diff:.3e}, argmax agree = {agree}")
        if not agree or (epochs == 0 and not diff <= XDEV_TOL):
            fail(f"card eval ({bn_mode}, {mode}) disagrees with the CPU eval at {epochs} inner epochs (tol {XDEV_TOL:g} "
                 f"without steps)")

    # episode lanes: XDEV_LANES episodes as one lane batch on the card against the same episodes one at a time on
    # the CPU (64 px, so the final block sees 4x4 maps; strict f32 eager, then the fused scan's lanes)
    from unittest import mock

    from mft_tpu_torch.ops import norm

    real_bn = norm.batch_norm
    leaky_bn = lambda *a, groups=1, **k: real_bn(*a, **k)  # the planted fault: one set of statistics for all lanes

    def plant(stack):
        for mod in (bb, gn, sys.modules["mft_tpu_torch.models.gnn"]):
            stack.enter_context(mock.patch.object(mod, "batch_norm", leaky_bn))

    lane_checks(torch, dev, bcfg, gcfg, (bp, bs, gp, gs, head), XDEV_LANE_FAULT, plant, ("eager", "fused"))

    # the faithful mode's lanes: each inner step runs the trunk once on the lanes' images, each lane's BN
    # statistics its own and masked by the step's weights (the fused scan refuses this mode)
    real_trunk = bb.apply_trunk

    def pooled_trunk(p, s, x, *, sample_mask=None, bn_groups=1, **kw):  # the planted fault
        if sample_mask is not None and bn_groups > 1:
            sample_mask = sample_mask.repeat(bn_groups)
        return real_trunk(p, s, x, sample_mask=sample_mask, bn_groups=1, **kw)

    lane_checks(torch, dev, bcfg, gcfg, (bp, bs, gp, gs, head), XDEV_MINIBATCH_FAULT,
                lambda stack: stack.enter_context(mock.patch.object(bb, "apply_trunk", pooled_trunk)), ("eager",),
                bn_mode="minibatch")


def lane_checks(torch, dev, bcfg, gcfg, weights, fault: str, plant, modes, label: str = "ResNet10",
                bn_mode: str = "episode"):
    """XDEV_LANES episodes as one ``--method all`` lane batch on the card
    against the same episodes one at a time on the CPU, at 64 px (the final
    block sees 4x4 maps), strict f32, in ``bn_mode``: without inner steps
    (eager), then one epoch of each inner loop of ``modes``; each beside the
    planted ``fault``
    (``plant(stack)`` enters its patches, on the card only), which the
    rules must catch: XDEV_TOL without steps, XDEV_LANE_CAP and the argmax
    wherever the CPU's top two scores lie more than XDEV_LANE_MARGIN apart
    with one epoch.  ``weights``: ``(baseline params, stats, GNN params,
    stats, head)``, on the CPU."""
    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.ops.augment import AugmentCfg
    from mft_tpu_torch.train import eval_engine as ee

    spec = EpisodeSpec(5, 5, 3)
    bp, bs, gp, gs, head = weights
    to = lambda t, d: {k: to(v, d) for k, v in t.items()} if isinstance(t, dict) else (
        [to(v, d) for v in t] if isinstance(t, list) else t.to(d))
    aug = AugmentCfg(image_size=64)
    lanes = np.random.RandomState(4).randint(0, 256, (XDEV_LANES, 5, 8, 73, 73, 3), dtype=np.uint8)
    gens = lambda: [torch.Generator().manual_seed(10 + i) for i in range(XDEV_LANES)]
    cpu_of = {}  # the CPU's episodes alone, per (epochs, inner loop): the fault is planted on the card only
    runs = [(0, "eager", None), (0, "eager", fault)] + [(1, m, f) for m in modes for f in (None, fault)]
    for epochs, mode, planted in runs:
        tcfg = ee.TransferCfg(fine_tune_epochs=epochs, linear_epochs=epochs, inner_scan=mode, bn_mode=bn_mode,
                              opt_state_dtype="float32" if mode == "eager" else "bfloat16")
        program = ee.make_eval_program(method="all", bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=tcfg, aug_cfg=aug,
                                       gen_examples=1)
        models = {"baseline": (to(bp, dev), to(bs, dev)), "gnn": (to(gp, dev), to(gs, dev), to(head, dev))}
        with contextlib.ExitStack() as stack:
            if planted:
                plant(stack)
            card, _ = program(models, torch.from_numpy(lanes).to(dev).permute(0, 1, 2, 5, 3, 4), gens())
        models = {"baseline": (bp, bs), "gnn": (gp, gs, head)}
        base = torch.from_numpy(lanes).permute(0, 1, 2, 5, 3, 4)
        if (epochs, mode) not in cpu_of:
            cpu_of[epochs, mode] = torch.cat([program(models, base[i : i + 1], gens()[i : i + 1])[0]
                                              for i in range(XDEV_LANES)])
        cpu = cpu_of[epochs, mode]
        card = card.cpu()
        diff = float((card - cpu).abs().max())
        top2 = cpu.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > XDEV_LANE_MARGIN
        flipped = card.argmax(-1) != cpu.argmax(-1)
        desc = f"{label}: {XDEV_LANES} episodes as one lane batch on the card vs one at a time on the CPU (64 px, " \
               f"{bn_mode} BN mode, {mode} inner loop, {epochs} inner epochs" \
               f"{', planted fault: ' + planted if planted else ''})"
        print(f"{desc}: max |d scores| = {diff:.3e}; argmax differs in {int(flipped.sum())} of {flipped.numel()} "
              f"queries, {int((flipped & clear).sum())} of them among the {int(clear.sum())} whose top two CPU scores lie "
              f"more than {XDEV_LANE_MARGIN:g} apart (the CPU's top-two gaps where it differs: "
              f"{[round(float(v), 5) for v in (top2[..., 0] - top2[..., 1])[flipped]]})")
        ok = diff <= XDEV_TOL if epochs == 0 else (diff <= XDEV_LANE_CAP and not bool((flipped & clear).any()))
        if ok == bool(planted):
            fail(f"the lane check {'misses the planted fault' if planted else 'fails'}: {desc}")


def _train_step_readings(torch, stage, dev, model, data, sched=None, dtype=None, fwt_noise=None):
    """One step of ``stage`` on ``dev``: ``(loss, gradients, updates, new
    stats)`` as flat dicts of CPU tensors.  ``dtype``: cast the weights and
    inputs (f64 runs the edge op's plain version, in f64).  ``fwt_noise``:
    the episodic step's FWT draws, one list per episode (ResNet10_FW, whose
    noise strengths ``freeze_masked`` keeps out of Adam, as the driver does)."""
    from torch.utils import _pytree as pytree

    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.train import optimizers as opt
    from mft_tpu_torch.train import steps
    from mft_tpu_torch.utils.checkpoint import keyed

    bcfg, gcfg, spec, params, stats = model
    to = lambda t: t.to(dev, dtype) if dtype is not None and t.is_floating_point() else t.to(dev)
    if dtype == torch.float64 and gcfg is not None:
        gcfg = gcfg._replace(use_pallas=False)
    params, stats = pytree.tree_map(to, params), pytree.tree_map(to, stats)
    noise = None if fwt_noise is None else [[None if d is None else pytree.tree_map(to, d) for d in ep]
                                            for ep in fwt_noise]
    tx = opt.torch_adam(1e-3)
    if bcfg.block == "fwt":
        tx = opt.freeze_masked(tx, bb.fwt_trainable_mask(params))
    if sched is not None:
        sched = tuple(t.to(dev) for t in sched)
    data = tuple(to(t) for t in data) if isinstance(data, tuple) else to(data)
    if stage == "baseline":
        x, y = data
        loss_fn = lambda p: steps.baseline_loss_fn(p, stats, x, y, bcfg=bcfg)
        out = steps.baseline_train_step(params, stats, tx.init(params), x, y, bcfg=bcfg, tx=tx)
    elif stage.startswith("episodic"):
        eps = data
        loss_fn = lambda p: steps._episode_loss(p, stats, eps[0], method="gnnnet", bcfg=bcfg, gcfg=gcfg, spec=spec,
                                                fwt_noise=None if noise is None else noise[0])
        out = steps.episodic_train_step(params, stats, tx.init(params), eps, method="gnnnet", bcfg=bcfg, gcfg=gcfg,
                                        spec=spec, tx=tx, fwt_noise=noise)
    else:
        eps = data
        mcfg = steps.MetaFinetuneCfg(bn_mode="episode")
        loss_fn = lambda p: steps._meta_finetune_episode_loss(p, stats, eps[0], None, method="gnnnet", bcfg=bcfg,
                                                              gcfg=gcfg, spec=spec, mcfg=mcfg, schedule=sched)
        out = steps.meta_finetune_train_step(params, stats, tx.init(params), eps, None, method="gnnnet", bcfg=bcfg,
                                             gcfg=gcfg, spec=spec, mcfg=mcfg, tx=tx, schedule=sched)
    _, _, grads = steps._value_and_grad(loss_fn, params)
    new_p, new_s, _, m = out
    cpu = lambda t: {k: v.detach().cpu() for k, v in keyed(t).items()}
    before = cpu(params)
    return float(m["loss"]), cpu(grads), {k: v - before[k] for k, v in cpu(new_p).items()}, cpu(new_s)


class ReluDecisions:
    """Records which elements the backbone's ReLUs (``torch.relu``) pass in
    one run, or, given ``replay``, makes a run take another run's decisions,
    call by call, and records where they differ from its own: ``flips``
    holds ``(call, elements, largest |input| among them as a share of the
    call's largest |input|)``.  ``leaky``: the GNN's leaky ReLUs
    (``torch.nn.functional.leaky_relu``) too."""

    def __init__(self, torch, replay=None, leaky=False):
        self.torch, self.replay, self.masks, self.flips, self.leaky = torch, replay, [], [], leaky

    def _decide(self, x):
        own = x.detach() > 0
        if self.replay is None:
            self.masks.append(own.cpu())
            return None
        m = self.replay[len(self.masks)].to(x.device)
        self.masks.append(m)
        diff = m != own
        if bool(diff.any()):
            mag = x.detach().abs()
            self.flips.append((len(self.masks) - 1, int(diff.sum()), float(mag[diff].max() / mag.max())))
        return m

    def __enter__(self):
        from unittest import mock

        relu = self.torch.relu

        def my_relu(x):
            m = self._decide(x)
            return relu(x) if m is None else x * m.to(x.dtype)

        self._patches = [mock.patch.object(self.torch, "relu", my_relu)]
        if self.leaky:
            functional = self.torch.nn.functional
            leaky = functional.leaky_relu

            def my_leaky(x, negative_slope=0.01, inplace=False):
                m = self._decide(x)
                return leaky(x, negative_slope) if m is None else self.torch.where(m, x, x * negative_slope)

            self._patches.append(mock.patch.object(functional, "leaky_relu", my_leaky))
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()
        return False

    def within_reach(self) -> bool:
        return all(r <= RELU_REACH for _, _, r in self.flips)


def _readings_apart(a, b, floor=None):
    """How far two step readings ``(loss, gradients, updates, stats)`` part
    (``dryrun.readings_apart``: relative loss, the worst tensor's gradient
    error as a multiple of its allowance, the gradients' relative L2 over
    the whole tree, the share of update elements that differ by more than
    1e-2 * lr, the worst stats tensor as a share of its largest value).
    ``floor``: per gradient tensor, the CPU's f32 error against f64,
    F32_FACTOR of which joins that tensor's allowance."""
    from mft_tpu_torch.parallel import dryrun

    named = lambda r: dict(zip(("loss", "grads", "updates", "stats"), r))
    return dryrun.readings_apart(named(a), named(b), floor)


def _worst_tensors(a, b, floor, n: int = 4) -> str:
    """The tensors behind ``_readings_apart(a, b, floor)``'s gradient and
    update readings: the ``n`` largest gradient errors as multiples of their
    allowance, and the ``n`` tensors with the most update elements apart
    (count / size)."""
    from mft_tpu_torch.parallel import dryrun

    _, ga, ua, _ = a
    _, gb, ub, _ = b
    scale = max(float(v.abs().max()) for v in gb.values())
    ratio = {k: float((ga[k] - v).abs().max()) / (dryrun.GRAD_TOL * float(v.abs().max()) + dryrun.GRAD_TREE_FLOOR * scale
                                                  + dryrun.F32_FACTOR * floor.get(k, 0.0)) for k, v in gb.items()}
    apart = {k: int(((ua[k] - v).abs() > 1e-2 * 1e-3).sum()) for k, v in ub.items()}
    top = lambda d: sorted(d, key=lambda k: -d[k])[:n]
    return ("gradient " + ", ".join(f"{k} {ratio[k]:.3f}" for k in top(ratio)) + "; updates apart "
            + ", ".join(f"{k} {apart[k]}/{ub[k].numel()}" for k in top(apart)))


def phase_train_cross_device(torch, dev):
    """One step of each training stage (baseline; episodic GnnNet with the
    edge kernel; the meta fine-tune in the episode BN mode with a fixed inner
    schedule; the 50-shot GnnNet step of ``cli.train_50``, 130-node graphs)
    on the card against the same step on the CPU, at 64 px, ResNet10 at full
    width, strict f32.  Bounds: dryrun.py's rules, TRAIN_FT_* above (the 50-shot step under the
    episodic step's, its planted fault included)."""
    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.methods.baseline import init_classifier
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.parallel import dryrun
    from mft_tpu_torch.train.inner_loop import InnerLoopCfg, schedule_from_perms

    g = torch.Generator().manual_seed(4)
    bcfg = bb.resnet10()
    spec = EpisodeSpec(5, 5, 3)
    gcfg = gn.GnnNetCfg(use_pallas=True)
    feature, stats = bb.init_backbone(g, bcfg)
    rs = np.random.RandomState(5)
    models = {
        "baseline": (bcfg, None, None, {"feature": feature, "classifier": init_classifier(g, 512, 10)}, stats),
        "episodic": (bcfg, gcfg, spec, {"feature": feature, **gn.init_head(g, gcfg)}, stats),
    }
    models["fine_tune"] = models["episodic"]
    gcfg50 = gn.GnnNetCfg(n_support=50, support_compress=2, use_pallas=True)
    models["episodic50"] = (bcfg, gcfg50, EpisodeSpec(5, 50, 3), {"feature": feature, **gn.init_head(g, gcfg50)}, stats)
    data = {
        "baseline": (torch.from_numpy(rs.rand(16, 3, 64, 64).astype(np.float32)), torch.from_numpy(rs.randint(0, 10, 16))),
        "episodic": torch.from_numpy(rs.rand(1, 5, 8, 3, 64, 64).astype(np.float32)),
        "fine_tune": torch.from_numpy(rs.rand(1, 5, 8, 3, 64, 64).astype(np.float32)),
        "episodic50": torch.from_numpy(np.random.RandomState(6).rand(1, 5, 53, 3, 64, 64).astype(np.float32)),
    }
    icfg = InnerLoopCfg(epochs=15, batch_size=4, bank_size=spec.support_size)
    sched = schedule_from_perms(np.stack([rs.permutation(icfg.bank_size) for _ in range(icfg.epochs)]), icfg)
    for stage in ("baseline", "episodic", "fine_tune", "episodic50"):
        st = sched if stage == "fine_tune" else None
        replay = stage == "episodic50"  # the CPU takes the card's ReLU decisions (RELU_REACH's note)
        rec = ReluDecisions(torch)
        with rec if replay else contextlib.nullcontext():
            card = _train_step_readings(torch, stage, dev, models[stage], data[stage], st)
        cpu = _train_step_readings(torch, stage, "cpu", models[stage], data[stage], st)
        exact = _train_step_readings(torch, stage, "cpu", models[stage], data[stage], st, dtype=torch.float64)
        f32_floor = None
        if stage != "fine_tune":
            f32_floor = {k: float((v.double() - exact[1][k]).abs().max()) for k, v in cpu[1].items()}
        decisions = ""
        if replay:
            rep = ReluDecisions(torch, replay=rec.masks)
            with rep:
                cpu_own, cpu = cpu, _train_step_readings(torch, stage, "cpu", models[stage], data[stage], st)
            before = _readings_apart(card, cpu_own, f32_floor)
            decisions = (f"; ReLU decisions: the CPU took the card's ({len(rec.masks)} calls); they differ from its "
                         f"own at {sum(n for _, n, _ in rep.flips)} elements, (call, elements, largest |input| / "
                         f"call's largest) {rep.flips} (each must be within {RELU_REACH:g}); with its own decisions: "
                         + ", ".join(f"{k} {v:.3e}" for k, v in before.items()))
            if not rep.within_reach():
                fail(f"the card's {stage} step takes ReLU decisions the CPU's f32 rounding cannot explain: {rep.flips}")
        got = _readings_apart(card, cpu, f32_floor)
        bounds = dryrun.rule_bounds({})
        line = ""
        if stage.startswith("episodic"):  # the planted fault, on the card, the same inputs
            from unittest import mock

            from mft_tpu_torch.kernels import edge_mlp

            one = lambda x, w, b: edge_mlp.edge_abs_diff_matmul_split_reference(x, w, b, terms=1)
            rec_f = ReluDecisions(torch)
            with mock.patch.object(edge_mlp, "edge_abs_diff_matmul", one), (rec_f if replay else contextlib.nullcontext()):
                faulty_card = _train_step_readings(torch, stage, dev, models[stage], data[stage])
            cpu_f, reach_f = cpu, True
            if replay:  # the CPU replays the faulty card's decisions, as it does the right card's
                rep_f = ReluDecisions(torch, replay=rec_f.masks)
                with rep_f:
                    cpu_f = _train_step_readings(torch, stage, "cpu", models[stage], data[stage])
                reach_f = rep_f.within_reach()
            faulty = _readings_apart(faulty_card, cpu_f, f32_floor)
            caught = [k for k, v in bounds.items() if not faulty[k] <= v] + ([] if reach_f else ["ReLU decisions"])
            line = (f"; planted fault ({TRAIN_FAULT}): " + ", ".join(f"{k} {v:.3e}" for k, v in faulty.items())
                    + f": {'caught by ' + ', '.join(caught) if caught else 'passes'}")
            if not caught:
                fail(f"the training cross-device check does not catch {TRAIN_FAULT}")
        if stage == "fine_tune":
            floor = _readings_apart(cpu, exact)
            bounds = {"loss": min(TRAIN_FT_CAP, max(dryrun.LOSS_RTOL, TRAIN_FT_FACTOR * floor["loss"])),
                      "grad_worst": math.inf,
                      "grad_rel_l2": max(dryrun.GRAD_TOL, TRAIN_FT_FACTOR * floor["grad_rel_l2"]),
                      "stats": max(dryrun.STATS_TOL, TRAIN_FT_FACTOR * floor["stats"]),
                      "update_disagree": min(TRAIN_FT_DISAGREE_CAP, max(1.0 - dryrun.UPDATE_SHARE,
                                                                        TRAIN_FT_FACTOR * floor["update_disagree"]))}
            from unittest import mock

            from mft_tpu_torch.train import steps

            with mock.patch.object(steps, "fo_maml_reattach", lambda meta, adapted: adapted):
                faulty = _readings_apart(_train_step_readings(torch, stage, dev, models[stage], data[stage], st), cpu)
            caught = [k for k, v in bounds.items() if not faulty[k] <= v]
            line = ("; floor (the CPU's f32 step against f64): " + ", ".join(f"{k} {v:.3e}" for k, v in floor.items())
                    + f"; planted fault ({TRAIN_FT_FAULT}): " + ", ".join(f"{k} {v:.3e}" for k, v in faulty.items())
                    + f": {'caught by ' + ', '.join(caught) if caught else 'passes'}")
            if not caught:
                fail(f"the fine-tune cross-device check does not catch {TRAIN_FT_FAULT}")
        print(f"card vs CPU training step ({stage}, 64 px, f32): loss card {card[0]:.7f} CPU {cpu[0]:.7f}; "
              + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
              + "; bounds " + ", ".join(f"{k} {v:.3e}" for k, v in bounds.items()) + decisions + line)
        bad = [k for k, v in bounds.items() if not got[k] <= v]
        if bad:
            fail(f"the card's {stage} training step parts from the CPU's: {bad}")


def _damp_step_readings(torch, dev, model, eps, mode, corrupt_x=None, dtype=None):
    """One ``dampnet_train_step`` in ``mode`` on ``dev``: ``(loss, gradients,
    updates, new stats)`` as flat dicts of CPU tensors, as
    ``_train_step_readings`` gives them; ``dtype`` casts weights, state and
    inputs."""
    from torch.utils import _pytree as pytree

    from mft_tpu_torch.parallel import dryrun
    from mft_tpu_torch.train import optimizers as opt
    from mft_tpu_torch.train import steps
    from mft_tpu_torch.utils.checkpoint import keyed

    bcfg, dcfg, spec, params, stats, dstate = model
    to = lambda t: t.to(dev, dtype) if dtype is not None and t.is_floating_point() else t.to(dev)
    params, stats, dstate = pytree.tree_map(to, params), pytree.tree_map(to, stats), pytree.tree_map(to, dstate)
    eps = to(eps)
    cx = None if corrupt_x is None else to(corrupt_x)
    # one step with Adam; the gradients Adam was given are kept on the way
    sink = {}
    tx = dryrun.recording(opt.torch_adam(1e-3), sink)
    new_p, new_s, _, m = steps.dampnet_train_step(params, stats, tx.init(params), dstate, eps, None, tx=tx,
                                                  mode=mode, bcfg=bcfg, dcfg=dcfg, spec=spec, corrupt_x=cx)
    grads = sink["grads"]
    cpu = lambda t: {k: v.detach().cpu() for k, v in keyed(t).items()}
    before = cpu(params)
    return float(m["loss"]), cpu(grads), {k: v - before[k] for k, v in cpu(new_p).items()}, cpu(new_s)


def phase_dampnet_cross_device(torch, dev):
    """DampNet on the card against the CPU.  One ``dampnet_train_step``
    (``dampnet_full_class`` at its published widths, ResNet10, 64 px, strict
    f32) in each of the modes 'plain', 'corrupt' and 'recover', the same
    weights, prototypes and inputs; the corrupt step's corruption drawn once
    on the host (``draw_corruption``, applied to the CPU's features) and fed
    to both devices as ``corrupt_x``.  The episodic step's rules, the CPU
    replaying the card's ReLU decisions, and a planted fault per mode
    (DAMP_FAULTS) that they must catch.  Then the DampNet eval member (the
    live composition, 32 px, ``make_eval_program``) with the eager inner
    loop (f32 moments) and the fused scan: XDEV_TOL with no inner steps, the
    same argmax with one epoch."""
    from unittest import mock

    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec, flatten_episode
    from mft_tpu_torch.methods import dampnet as dn
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.ops.augment import AugmentCfg
    from mft_tpu_torch.parallel import dryrun
    from mft_tpu_torch.train import eval_engine as ee
    from mft_tpu_torch.train import steps

    g = torch.Generator().manual_seed(7)
    bcfg, spec = bb.resnet10(), EpisodeSpec(5, 5, 3)
    dcfg = dn.method_cfg("dampnet_full_class", 512, 5, 5)
    feature, stats = bb.init_backbone(g, bcfg)
    head, dstate = dn.init_dampnet(g, dcfg)
    dstate = dn.update_prototypes(dstate, torch.rand(200, 512, generator=g))
    model = (bcfg, dcfg, spec, {"feature": feature, **head}, stats, dstate)
    eps = torch.from_numpy(np.random.RandomState(8).rand(1, 5, 8, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        feats_cpu = bb.apply_backbone(feature, stats, flatten_episode(eps[0]), cfg=bcfg, train=True)[0]
    corrupt_x = dn.apply_corruption(feats_cpu, dn.draw_corruption(g, 512, prototype=False), scale_bias=True)[None]
    real_scores, real_fc_gnn, real_recovery = steps.dampnet_scores, dn._fc_gnn_scores, dn.recovery
    faults = {
        "plain": mock.patch.object(steps, "dampnet_scores",
                                   lambda p, st, z, *a, **k: real_scores(p, st, z.detach(), *a, **k)),
        "corrupt": mock.patch.object(dn, "_fc_gnn_scores",
                                     lambda p, z, c, q, freeze_head: real_fc_gnn(p, z, c, q, freeze_head=False)),
        "recover": mock.patch.object(dn, "recovery", lambda *a: real_recovery(*a)[::-1]),
    }
    for mode in ("plain", "corrupt", "recover"):
        cx = corrupt_x if mode == "corrupt" else None
        rec = ReluDecisions(torch, leaky=True)
        with rec:
            card = _damp_step_readings(torch, dev, model, eps, mode, cx)
        cpu_own = _damp_step_readings(torch, "cpu", model, eps, mode, cx)
        exact = _damp_step_readings(torch, "cpu", model, eps, mode, cx, dtype=torch.float64)
        floor = {k: float((v.double() - exact[1][k]).abs().max()) for k, v in cpu_own[1].items()}
        update_floor = _readings_apart(cpu_own, exact)["update_disagree"]
        bounds = dryrun.rule_bounds({"update_floor": update_floor})
        rep = ReluDecisions(torch, replay=rec.masks, leaky=True)
        with rep:
            cpu = _damp_step_readings(torch, "cpu", model, eps, mode, cx)
        if not rep.within_reach():
            fail(f"the card's DampNet {mode} step takes ReLU decisions the CPU's f32 rounding cannot explain: {rep.flips}")
        got = _readings_apart(card, cpu, floor)
        own = _readings_apart(card, cpu_own, floor)
        rec_f = ReluDecisions(torch, leaky=True)
        with faults[mode], rec_f:
            faulty_card = _damp_step_readings(torch, dev, model, eps, mode, cx)
        rep_f = ReluDecisions(torch, replay=rec_f.masks, leaky=True)
        with rep_f:
            cpu_f = _damp_step_readings(torch, "cpu", model, eps, mode, cx)
        faulty = _readings_apart(faulty_card, cpu_f, floor)
        caught = [k for k, v in bounds.items() if not faulty[k] <= v] + ([] if rep_f.within_reach() else ["ReLU decisions"])
        print(f"card vs CPU DampNet step (dampnet_full_class, {mode}, 64 px, f32): loss card {card[0]:.7f} CPU "
              f"{cpu[0]:.7f}; " + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
              + f"; ReLU decisions: the CPU took the card's ({len(rec.masks)} calls), differing from its own at "
              f"{sum(n for _, n, _ in rep.flips)} elements, largest |input| / call's largest "
              f"{max((r for _, _, r in rep.flips), default=0.0):.3e} (limit {RELU_REACH:g}); with its own decisions: "
              + ", ".join(f"{k} {v:.3e}" for k, v in own.items())
              + f"; update floor (the CPU's f32 step against f64) {update_floor:.3e}; bounds "
              + ", ".join(f"{k} {v:.3e}" for k, v in bounds.items())
              + f"; planted fault ({DAMP_FAULTS[mode]}): " + ", ".join(f"{k} {v:.3e}" for k, v in faulty.items())
              + f": {'caught by ' + ', '.join(caught) if caught else 'passes'}")
        if not caught:
            fail(f"the DampNet {mode} cross-device check does not catch {DAMP_FAULTS[mode]}")
        bad = [k for k, v in bounds.items() if not got[k] <= v]
        if bad:
            fail(f"the card's DampNet {mode} step parts from the CPU's: {bad}")

    # the eval member, the live composition
    spec_e = EpisodeSpec(5, 5, 3)
    images = np.random.RandomState(9).randint(0, 256, (5, 8, 36, 36, 3), dtype=np.uint8)
    to = lambda t, d: {k: to(v, d) for k, v in t.items()} if isinstance(t, dict) else (
        [to(v, d) for v in t] if isinstance(t, list) else t.to(d))
    for epochs, scan in ((0, "eager"), (1, "eager"), (0, "fused"), (1, "fused")):
        tcfg = ee.TransferCfg(fine_tune_epochs=epochs, inner_scan=scan,
                              opt_state_dtype="float32" if scan == "eager" else "bfloat16")
        program = ee.make_eval_program(method="dampnet_full_class", bcfg=bcfg, gcfg=None, spec=spec_e, tcfg=tcfg,
                                       aug_cfg=AugmentCfg(image_size=32), gen_examples=1, dcfg=dcfg)
        scores = {}
        for d in ("cpu", dev):
            models = {"dampnet": (to(feature, d), to(stats, d), to(head, d), to(dstate, d))}
            base = torch.from_numpy(images).to(d).permute(0, 1, 4, 2, 3)
            scores[d] = program(models, base[None], [torch.Generator().manual_seed(3)])[0][0]
        diff = float((scores[dev].cpu() - scores["cpu"]).abs().max())
        agree = bool((scores[dev].cpu().argmax(1) == scores["cpu"].argmax(1)).all())
        print(f"card vs CPU DampNet eval (dampnet_full_class, 32 px, f32, {scan} inner loop, {epochs} inner epochs): "
              f"max |d scores| = {diff:.3e}, argmax agree = {agree}")
        if not agree or (epochs == 0 and not diff <= XDEV_TOL):
            fail(f"the card's DampNet eval ({scan}) disagrees with the CPU's at {epochs} inner epochs")
    dampnet_lane_checks(torch, dev, bcfg, dcfg, (feature, stats, head, dstate))


def dampnet_lane_checks(torch, dev, bcfg, dcfg, weights):
    """DampNet's scoring and probe as lanes: XDEV_LANES episodes of the
    ``--dampnet_eval nofinetune`` composition (the recovery network and the
    GNN on the plain edge op once for all lanes, then one lane-stacked probe
    loop of 700 SGD steps) and of ``--unsupervised`` (no probe) as one lane
    batch on the card against the same episodes one at a time on the CPU, at
    64 px, f32; neither adapts the backbone.  The unsupervised scores must
    agree to XDEV_TOL, the probe's to XDEV_PROBE_CAP with the same argmax
    wherever the CPU's top two lie more than XDEV_LANE_MARGIN apart; the
    planted XDEV_PROBE_FAULT on the card must fail.  ``weights``: the
    backbone's params and stats, the DampNet heads and state, on the CPU."""
    from unittest import mock

    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.ops.augment import AugmentCfg
    from mft_tpu_torch.train import eval_engine as ee

    spec = EpisodeSpec(5, 5, 3)
    to = lambda t, d: {k: to(v, d) for k, v in t.items()} if isinstance(t, dict) else (
        [to(v, d) for v in t] if isinstance(t, list) else t.to(d))
    base = torch.from_numpy(np.random.RandomState(11).randint(0, 256, (XDEV_LANES, 5, 8, 73, 73, 3),
                                                               dtype=np.uint8)).permute(0, 1, 2, 5, 3, 4)
    gens = lambda: [torch.Generator().manual_seed(60 + i) for i in range(XDEV_LANES)]
    dstate = weights[3]
    unsup = (dstate["proto_mean"] * 0.9, dstate["proto_std"] * 1.1)  # an unlabeled set's statistics, made up
    real_heads = ee._draw_heads

    def shared_heads(*a, **k):  # the planted fault
        heads = real_heads(*a, **k)
        return {key: v[:1].expand_as(v).clone() for key, v in heads.items()}

    for comp in ("nofinetune", "unsupervised"):
        program = ee.make_eval_program(method="dampnet_full_class", bcfg=bcfg, gcfg=None, spec=spec,
                                       tcfg=ee.TransferCfg(), aug_cfg=AugmentCfg(image_size=64), gen_examples=1,
                                       dcfg=dcfg, dampnet_eval="nofinetune" if comp == "nofinetune" else "finetune")

        def models(d):
            m = {"dampnet": tuple(to(t, d) for t in weights)}
            if comp == "unsupervised":
                m["unsup_stats"] = tuple(t.to(d) for t in unsup)
            return m

        cpu = torch.cat([program(models("cpu"), base[i : i + 1], gens()[i : i + 1])[0] for i in range(XDEV_LANES)])
        top2 = cpu.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > XDEV_LANE_MARGIN
        for planted in ((None, XDEV_PROBE_FAULT) if comp == "nofinetune" else (None,)):
            with contextlib.ExitStack() as stack:
                if planted:
                    stack.enter_context(mock.patch.object(ee, "_draw_heads", shared_heads))
                card = program(models(dev), base.to(dev), gens())[0].cpu()
            diff = float((card - cpu).abs().max())
            flipped = card.argmax(-1) != cpu.argmax(-1)
            desc = f"DampNet {comp}: {XDEV_LANES} episodes as one lane batch on the card vs one at a time on the CPU " \
                   f"(64 px, f32{', planted fault: ' + planted if planted else ''})"
            print(f"{desc}: max |d scores| = {diff:.3e}; argmax differs in {int(flipped.sum())} of {flipped.numel()} "
                  f"queries, {int((flipped & clear).sum())} of them among the {int(clear.sum())} clear ones")
            ok = diff <= XDEV_TOL if comp == "unsupervised" else (
                diff <= XDEV_PROBE_CAP and not bool((flipped & clear).any()))
            if ok == bool(planted):
                fail(f"the DampNet lane check {'misses the planted fault' if planted else 'fails'}: {desc}")


#: phase 4's planted faults on the other backbones (each must fail its rules)
FWT_FAULT = "FWT noise dropped on the final block"
R18_FAULT = "identity shortcuts dropped"


def phase_backbones_cross_device(torch, dev):
    """The other backbones on the card against the CPU, full width, 64 px,
    strict f32: one ResNet10_FW episodic GnnNet step (the edge kernel on the
    card), its FWT noise drawn once on the host and fed to both devices,
    under the episodic step's rules (dryrun.py's, the CPU replaying the card's
    ReLU and the GNN's leaky-ReLU decisions within RELU_REACH; the update
    share against UPDATE_FACTOR times the CPU's own f32-vs-f64 share,
    as the DampNet step) and with every noise strength's update exactly 0
    on both, beside FWT_FAULT on the card, which must fail them.  Why the
    DampNet step's form: on the first call on an H100 the step read
    grad_worst 1.749 (the first Wcompute's conv4 weight, a sum of products
    of both signs behind leaky ReLUs) and 1.478e-3 of the update elements
    apart with ReLU decisions alone replayed, where the CPU's own f32 step
    reads 8.7e-4 of them apart from f64 (the noise's shifts put more
    pre-activations near 0 than ResNet10's step has);
    then a ResNet18 lane batch against its episodes alone on the CPU under
    ``lane_checks``' rules, eager (the fused scan refuses ResNet18), beside
    R18_FAULT."""
    from unittest import mock

    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.parallel import dryrun

    g = torch.Generator().manual_seed(6)
    bcfg = bb.resnet10_fw()
    gcfg = gn.GnnNetCfg(use_pallas=True)
    feature, stats = bb.init_backbone(g, bcfg)
    model = (bcfg, gcfg, EpisodeSpec(5, 5, 3), {"feature": feature, **gn.init_head(g, gcfg)}, stats)
    data = torch.from_numpy(np.random.RandomState(7).rand(1, 5, 8, 3, 64, 64).astype(np.float32))
    noise = [bb.draw_fwt_noise(g, bcfg)]
    stage = "episodic ResNet10_FW"

    def readings(dev_, fwt_noise, replay=None, dtype=None):
        rec = ReluDecisions(torch, replay=replay, leaky=True)
        with rec:
            out = _train_step_readings(torch, stage, dev_, model, data, dtype=dtype, fwt_noise=fwt_noise)
        return out, rec

    card, rec = readings(dev, noise)
    cpu_own, _ = readings("cpu", noise)
    exact, _ = readings("cpu", noise, dtype=torch.float64)
    f32_floor = {k: float((v.double() - exact[1][k]).abs().max()) for k, v in cpu_own[1].items()}
    cpu, rep = readings("cpu", noise, replay=rec.masks)
    if not rep.within_reach():
        fail(f"the card's {stage} step takes ReLU decisions the CPU's f32 rounding cannot explain: {rep.flips}")
    moved = [k for run in (card, cpu) for k, v in run[2].items() if "fwt_" in k and bool(v.any())]
    if moved:
        fail(f"the {stage} step moved the frozen noise strengths {moved}")
    floor = _readings_apart(cpu_own, exact)
    bounds = dryrun.rule_bounds({"update_floor": floor["update_disagree"]})
    got = _readings_apart(card, cpu, f32_floor)
    print(f"{stage}: the CPU's f32 step against f64: " + ", ".join(f"{k} {v:.3e}" for k, v in floor.items())
          + "; card vs CPU, worst tensors: " + _worst_tensors(card, cpu, f32_floor))
    faulty_card, rec_f = readings(dev, [noise[0][:-1] + [None]])
    cpu_f, rep_f = readings("cpu", noise, replay=rec_f.masks)
    faulty = _readings_apart(faulty_card, cpu_f, f32_floor)
    caught = [k for k, v in bounds.items() if not faulty[k] <= v] + ([] if rep_f.within_reach() else ["ReLU decisions"])
    print(f"card vs CPU training step ({stage}, 64 px, f32, the same FWT draws): loss card {card[0]:.7f} CPU "
          f"{cpu[0]:.7f}; " + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
          + "; bounds " + ", ".join(f"{k} {v:.3e}" for k, v in bounds.items())
          + f"; ReLU decisions: the CPU took the card's ({len(rec.masks)} calls), {sum(n for _, n, _ in rep.flips)} "
          f"elements differ from its own; the {sum(1 for k in card[2] if 'fwt_' in k)} noise strengths' updates 0 on "
          f"both; planted fault ({FWT_FAULT}): " + ", ".join(f"{k} {v:.3e}" for k, v in faulty.items())
          + f": {'caught by ' + ', '.join(caught) if caught else 'passes'}")
    if not caught:
        fail(f"the {stage} cross-device check does not catch {FWT_FAULT}")
    bad = [k for k, v in bounds.items() if not got[k] <= v]
    if bad:
        fail(f"the card's {stage} step parts from the CPU's: {bad}")

    r18 = bb.resnet18()
    g = torch.Generator().manual_seed(8)
    bp, bs = bb.init_backbone(g, r18)
    gp, gs = bb.init_backbone(g, r18)
    head = gn.init_head(g, gcfg)
    real_block = bb._apply_block

    def no_identity(p, s, x, half_res, ctx, cd=None, conv_groups=1, noise=None):  # the planted fault
        if "conv_sc" in p or "conv3" in p:
            return real_block(p, s, x, half_res, ctx, cd, conv_groups, noise)
        out = bb.conv2d(x, p["conv1"], stride=2 if half_res else 1, padding=1, compute_dtype=cd, groups=conv_groups)
        out, s1 = bb._bn(out, p["bn1"], s["bn1"], ctx)
        out = bb.conv2d(torch.relu(out), p["conv2"], stride=1, padding=1, compute_dtype=cd, groups=conv_groups)
        out, s2 = bb._bn(out, p["bn2"], s["bn2"], ctx)
        return torch.relu(out), {"bn1": s1, "bn2": s2}

    plant = lambda stack: stack.enter_context(mock.patch.object(bb, "_apply_block", no_identity))
    lane_checks(torch, dev, r18, gcfg, (bp, bs, gp, gs, head), R18_FAULT, plant, ("eager",), label="ResNet18")


def write_checkpoints(torch, save_dir):
    """Seeded random checkpoints in the reference .tar layout: baseline@400,
    gnnnet_aug 5-shot@600 and 50-shot@600 (the directories and epochs that
    ``--method all`` pins), and a ProtoNet backbone@400."""
    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch.convert import save_tar, to_state_dict
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb

    paths = cfg_mod.Paths(save_dir=save_dir)
    g = torch.Generator().manual_seed(0)
    bcfg = bb.resnet10()
    write_backbone_checkpoints(torch, save_dir, "ResNet10", g)
    p, s = bb.init_backbone(g, bcfg)
    head = gn.init_head(g, gn.GnnNetCfg(n_support=50, support_compress=2))
    d = cfg_mod.checkpoint_dir(paths, "miniImageNet", "ResNet10", "gnnnet", train_aug=True, n_way=5, n_shot=50)
    os.makedirs(d)
    save_tar(os.path.join(d, "600.tar"), 600, to_state_dict({"feature": p, **head}, s))
    p, s = bb.init_backbone(g, bcfg)
    d = cfg_mod.checkpoint_dir(paths, "miniImageNet", "ResNet10", "protonet", train_aug=False, n_way=5, n_shot=5)
    os.makedirs(d)
    save_tar(os.path.join(d, "400.tar"), 400, to_state_dict({"feature": p}, s))
    pj = os.path.join(save_dir, "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": save_dir}, f)
    return pj


def write_backbone_checkpoints(torch, save_dir, model: str, g):
    """Random baseline@400 and gnnnet_aug 5-shot@600 ``.tar`` files of
    ``model``, drawn from the generator ``g``: the pair ``--method all``
    reads."""
    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch.convert import save_tar, to_state_dict
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb

    paths = cfg_mod.Paths(save_dir=save_dir)
    bcfg = bb.MODEL_REGISTRY[model]()
    p, s = bb.init_backbone(g, bcfg)
    d = cfg_mod.checkpoint_dir(paths, "miniImageNet", model, "baseline", train_aug=False)
    os.makedirs(d)
    save_tar(os.path.join(d, "400.tar"), 400, to_state_dict({"feature": p}, s))
    p, s = bb.init_backbone(g, bcfg)
    head = gn.init_head(g, gn.GnnNetCfg())
    d = cfg_mod.checkpoint_dir(paths, "miniImageNet", model, "gnnnet", train_aug=True, n_way=5, n_shot=5)
    os.makedirs(d)
    save_tar(os.path.join(d, "600.tar"), 600, to_state_dict({"feature": p, **head}, s))


#: phase 5's other backbones: (model, inner loop, episodes, key of the kernels line); the fused scan takes
#: ResNet10_FW's final block (ResNet10's geometry), ResNet18/34's identity-shortcut block runs eager
BACKBONE_EVALS = (("ResNet10_FW", "fused", 2 * LANES, "fw"), ("ResNet18", "eager", 2 * LANES, "r18"),
                  ("ResNet34", "eager", LANES, "r34"))


def phase_backbone_evals(torch, kernels, finetune, rows, pj: str):
    """``--method all --use_pallas`` at full width (224 px, 5-way 5-shot, 15
    queries, ``gen_examples=17``, ``fine_tune_epoch=5``, ``--eval_batch
    5``) on each of BACKBONE_EVALS: launch counts set to 0 before and read
    after (the edge kernel three times a batch, the scan once a batch on
    ResNet10_FW and never on ResNet18/34), seconds per episode and peak
    memory (``drive``: the batches after the first; ResNet34's one batch
    includes its warm-up), then one batch under the profiler (idle share,
    the kernels' device time in the batch)."""
    for i, (model, _, _, _) in enumerate(BACKBONE_EVALS):
        write_backbone_checkpoints(torch, os.path.dirname(pj), model, torch.Generator().manual_seed(10 + i))
    common = ["--device", "cuda:0", "--method", "all", "--use_pallas", "--test_dataset", "synthetic", "--image_size",
              "224", "--gen_examples", "17", "--fine_tune_epoch", "5", "--n_shot", "5", "--eval_batch", str(LANES),
              "--paths_json", pj]
    for model, scan, episodes, key in BACKBONE_EVALS:
        argv = common + ["--model", model, "--inner_scan", scan]
        batches = episodes // LANES
        kernels.reset_launch_counts()
        steady = drive(torch, finetune, f"{model} lane path (--eval_batch {LANES} --inner_scan {scan})", argv, episodes)
        counts = kernels.launch_counts()
        want = {"edge_abs_diff_matmul": 3 * batches, "fused_inner_scan": batches if scan == "fused" else 0}
        print(f"{model} lane path kernel launches: {counts} ({batches} batches; want {want})")
        if any(counts[k] != v for k, v in want.items()):
            fail(f"the {model} lane path launched {counts}, not {want}")
        prof = phase_profile(torch, finetune, argv, steady, 3, label=f"{model}, {LANES} lanes", scan=scan == "fused",
                             episodes=LANES)
        for row in rows:
            row[f"launches_{key}"] = counts[row["name"]]
            row[f"ms_{key}"] = prof["edge_ms" if row["name"] == "edge_abs_diff_matmul" else "scan_ms"] or None
        mark(f"{model} lane eval and profile")


#: the interop and mesh phase: lane batches of each run (the first the warm-up), the main path's widths, the
#: mesh's shards on the one card (each in its own worker process), the JPEGs of the decode timing (a
#: save_features sweep's)
INTEROP_BATCHES = 2
INTEROP_WIDTHS = ["--image_size", "224", "--gen_examples", "17", "--fine_tune_epoch", "5"]
MESH_SHARDS = 2
DECODE_IMAGES = 480


def eval_scores(torch, finetune, label: str, argv, episodes: int, mesh_devices=None):
    """``episodes`` episodes through the eval driver (``mesh_devices``: its
    episode mesh), with the launch counts set to 0 before.  Returns
    ``(result, scores [episodes, q, n_way] on the CPU in episode order,
    steady seconds per episode, launch counts)``: the steady time is the
    batches after the first (warm-up) over their episodes; the counts are
    this process's and, on a wider mesh, its worker processes' summed."""
    from mft_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = finetune.main(argv + ["--iter_num", str(episodes)], mesh_devices=mesh_devices, keep_scores=True)
    counts = {k: n + res.worker_launches.get(k, 0) for k, n in kernels.launch_counts().items()}
    accs = [float(v) for v in res.accs]
    if len(accs) != episodes or len(res.scores) != episodes or not all(
            math.isfinite(v) and 0 <= v <= 100 for v in accs):
        fail(f"{label}: {len(accs)} accuracies, {len(res.scores)} score sets for {episodes} episodes: {accs}")
    scores = torch.stack(res.scores)
    if not bool(torch.isfinite(scores).all()):
        fail(f"{label}: scores not finite")
    first = round(res.batch_seconds[0] / res.seconds[0])  # the first batch's episodes
    steady = sum(res.batch_seconds[1:]) / (episodes - first) if first < episodes else res.batch_seconds[0] / first
    print(f"{label}: {episodes} episodes in {len(res.batch_seconds)} batches of {first}, seconds per batch "
          f"{[round(t, 4) for t in res.batch_seconds]} (the first includes warm-up); steady seconds/episode {steady:.4f}; "
          f"peak device memory of this process {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return res, scores, steady, counts


def scores_rule(torch, label: str, got, want, rerun_spread: float) -> str:
    """Which rule ``got`` meets against ``want``: bit-equality, which must hold
    where the same batch reruns bit for bit (``rerun_spread`` 0); else phase
    4's lane rule (no score more than XDEV_LANE_CAP away, the same argmax
    wherever ``want``'s top two lie more than XDEV_LANE_MARGIN apart)."""
    diff = float((got - want).abs().max())
    if diff == 0.0:
        return "bit-equal"
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > XDEV_LANE_MARGIN
    flipped = (got.argmax(-1) != want.argmax(-1)) & clear
    print(f"{label}: max |d scores| {diff:.3e}, {int(flipped.sum())} clear argmax flips; the same batch's own rerun "
          f"spread {rerun_spread:.3e}")
    if rerun_spread == 0.0:
        fail(f"{label}: scores differ by {diff:.3e} while the same batch reruns bit for bit")
    if diff > XDEV_LANE_CAP or bool(flipped.any()):
        fail(f"{label}: scores differ by {diff:.3e} with {int(flipped.sum())} clear argmax flips (lane rule: "
             f"{XDEV_LANE_CAP:g}, none beyond a {XDEV_LANE_MARGIN:g} gap)")
    return "phase 4's lane rule (the card's reruns are not bit-equal)"


def phase_interop_and_mesh(torch, finetune, rows, pj: str, dev):
    """The JAX checkpoint format and the episode mesh on the main path, at
    full width with ``--eval_batch 5`` (``--method all --use_pallas
    --inner_scan fused``):

    * the seeded baseline and GnnNet checkpoints written again as JAX-layout
      ``.ckpt`` files (``save_flax_checkpoint``) into a directory without a
      ``.tar``; the driver's models from both directories equal tensor for
      tensor; INTEROP_BATCHES batches from the ``.ckpt`` files (the first the
      warm-up), as many times MESH_SHARDS from the ``.tar`` files (the mesh's
      episodes), and the ``.tar`` run's first INTEROP_BATCHES again for its
      rerun spread: the ``.ckpt`` run's scores
      equal the ``.tar`` run's bit for bit (or, if the reruns differ, by
      the lane rule), its launch counts (set to 0 before, read after) the
      scan's once and the edge kernel's three times a batch;
    * ``import_ckpt`` (``.ckpt`` -> the port's ``.tar``) then ``export_ckpt``
      (-> a reference ``.tar``): every tensor bit-equal to the seeded
      original; a DampNet-sized (``dampnet_full_class``) ``.ckpt`` written
      and read onto the card, timed;
    * a mesh of MESH_SHARDS shards on ``dev`` (``cuda:0`` twice: two worker
      processes on the one card), global batch twice ``--eval_batch``, for
      INTEROP_BATCHES global batches, every
      episode against the unsharded batches of it (bit-equal, or the lane rule
      where the unsharded reruns differ), with its launch counts and
      seconds per episode beside the unsharded run's;
    * the native decode backend ``auto`` picks, and why; where it is native,
      the host seconds to decode DECODE_IMAGES JPEGs beside PIL's."""
    from mft_tpu_torch.cli import export_ckpt, import_ckpt
    from mft_tpu_torch.convert import load_tar
    from mft_tpu_torch.methods import dampnet as dn
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.train import optimizers as opt
    from mft_tpu_torch.utils import checkpoint as ckpt

    save_dir = os.path.dirname(pj)
    ckpt_root = os.path.join(save_dir, "jax_layout")
    originals = {}  # the .ckpt files and the seeded .tar each came from
    for sub in ("ResNet10_baseline", "ResNet10_gnnnet_aug_5way_5shot"):
        d = os.path.join(save_dir, "checkpoints", "miniImageNet", sub)
        for name in (n for n in os.listdir(d) if n.endswith(".tar")):
            epoch, p, s, _ = ckpt.load_checkpoint(os.path.join(d, name), bb.resnet10(), None)
            out = ckpt.save_flax_checkpoint(os.path.join(ckpt_root, "checkpoints", "miniImageNet", sub), epoch, p, s)
            originals[out] = os.path.join(d, name)
    pj_ckpt = os.path.join(ckpt_root, "paths.json")
    with open(pj_ckpt, "w") as f:
        json.dump({"save_dir": ckpt_root}, f)
    files = [n for _, _, names in os.walk(ckpt_root) for n in names]
    if any(n.endswith(".tar") for n in files):
        fail(f"the .ckpt directory holds a .tar: {files}")
    print(f"interop: {len(originals)} seeded checkpoints written as JAX-layout .ckpt files: "
          f"{sorted(os.path.relpath(k, ckpt_root) for k in originals)}")
    models = {}
    for tag, path in (("tar", pj), ("ckpt", pj_ckpt)):
        a = finetune.cfg_mod.parse_finetune_args(["--method", "all", "--paths_json", path])
        models[tag] = ckpt.keyed(finetune.build_models(a, finetune.cfg_mod.Paths.load(path), bb.resnet10(), dev))
    if sorted(models["tar"]) != sorted(models["ckpt"]) or not all(
            torch.equal(models["tar"][k], models["ckpt"][k]) for k in models["tar"]):
        fail("the eval's models from the .ckpt files differ from those of the .tar files")
    print(f"interop: the eval's {len(models['tar'])} model tensors from the .ckpt files equal the .tar files' "
          "(torch.equal)")

    argv = ["--device", str(dev), "--method", "all", "--use_pallas", "--inner_scan", "fused", "--test_dataset",
            "synthetic", "--model", "ResNet10", *INTEROP_WIDTHS, "--n_shot", "5", "--eval_batch", str(LANES)]
    episodes = INTEROP_BATCHES * LANES
    # as many episodes as the mesh below takes, so that every mesh episode, the timed ones too, has its answer
    _, tar1, tar_s, _ = eval_scores(torch, finetune, "interop: from .tar", argv + ["--paths_json", pj],
                                    INTEROP_BATCHES * MESH_SHARDS * LANES)
    _, from_ckpt, ckpt_s, counts = eval_scores(torch, finetune, "interop: from .ckpt alone",
                                               argv + ["--paths_json", pj_ckpt], episodes)
    want = {"edge_abs_diff_matmul": 3 * INTEROP_BATCHES, "fused_inner_scan": INTEROP_BATCHES}
    print(f"interop: .ckpt run kernel launches {counts} ({INTEROP_BATCHES} batches; want {want})")
    if counts != want:
        fail(f"the .ckpt-driven eval launched {counts}, not {want}")
    for row in rows:
        row["launches_ckpt"] = counts[row["name"]]
    _, tar2, _, _ = eval_scores(torch, finetune, "interop: from .tar, rerun", argv + ["--paths_json", pj], episodes)
    spread = float((tar2 - tar1[:episodes]).abs().max())
    rule = scores_rule(torch, "interop: .ckpt vs .tar scores", from_ckpt, tar1[:episodes], spread)
    print(f"interop: .ckpt-driven scores vs the .tar run's ({episodes} episodes x {tar1.shape[1]} queries): {rule}; "
          f"the .tar run's own rerun spread {spread:.3e}; seconds/episode .ckpt {ckpt_s:.4f} vs .tar {tar_s:.4f} "
          f"(same call)")
    mark("interop: the eval from .ckpt files")

    # round trips: .ckpt -> the port's .tar -> a reference .tar, against the seeded originals
    for src, orig in sorted(originals.items()):
        out = os.path.join(save_dir, "round_trip", os.path.basename(os.path.dirname(src)))
        if import_ckpt.main([src, "--model", "ResNet10", "--out_dir", out]) != 0:
            fail(f"import_ckpt {src} failed")
        imported = os.path.join(out, os.path.basename(src).replace(".ckpt", ".tar"))
        ref = imported.replace(".tar", ".reference.tar")
        if export_ckpt.main([imported, "--model", "ResNet10", "--out", ref]) != 0:
            fail(f"export_ckpt {imported} failed")
        _, want_sd = load_tar(orig)
        for path, extra in ((imported, {"adam"}), (ref, set())):
            blob = torch.load(path, map_location="cpu", weights_only=True)
            got = blob["state"]
            same = set(blob) == {"epoch", "state"} | extra and sorted(got) == sorted(want_sd) and all(
                got[k].dtype == want_sd[k].dtype and torch.equal(got[k], want_sd[k]) for k in want_sd)
            if not same:
                fail(f"round trip {orig} -> {src} -> {path}: not every tensor bit-equal to the original")
        print(f"interop: round trip {os.path.relpath(orig, save_dir)} -> .ckpt -> import_ckpt -> export_ckpt: "
              f"{len(want_sd)} tensors bit-equal to the seeded original")
    g = torch.Generator().manual_seed(7)
    dcfg = dn.method_cfg("dampnet_full_class", 512, 5, 5)
    feature, stats = bb.init_backbone(g, bb.resnet10())
    dparams, dstate = dn.init_dampnet(g, dcfg)
    params = {"feature": feature, **dparams}
    n_weights = sum(t.numel() for t in ckpt.keyed(params).values())
    t0 = time.perf_counter()
    path = ckpt.save_flax_checkpoint(os.path.join(save_dir, "dampnet_sized"), 0, params, stats, damp_state=dstate)
    write_s = time.perf_counter() - t0
    template = opt.torch_adam(1e-3).init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, p2, _, o2, d2 = ckpt.load_checkpoint(path, bb.resnet10(), template, device=dev,
                                            damp_template=dn.fresh_state(dcfg, device=dev))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if not (torch.equal(p2["W_R"].cpu(), params["W_R"]) and o2["t"] == 0 and set(d2) == set(dstate)):
        fail("the DampNet-sized .ckpt did not read back")
    print(f"interop: a DampNet-sized .ckpt (dampnet_full_class, {n_weights / 1e6:.1f} M weights, "
          f"{os.path.getsize(path) / 2**30:.3f} GiB with its Adam moments): written in {write_s:.3f} s, read onto the "
          f"card in {read_s:.3f} s (host clock, file in the page cache)")
    del p2, o2, d2, template, params, dparams
    os.remove(path)
    mark("interop: round trips and the DampNet-sized .ckpt")

    # the mesh: two shards on the one card against the unsharded batches of the same episodes
    argv_tar = argv + ["--paths_json", pj]
    mesh_devices = [str(dev)] * MESH_SHARDS
    res_m, mesh_scores, mesh_s, counts = eval_scores(torch, finetune, f"mesh of {mesh_devices}", argv_tar,
                                                     INTEROP_BATCHES * MESH_SHARDS * LANES, mesh_devices=mesh_devices)
    shards = INTEROP_BATCHES * MESH_SHARDS
    want = {"edge_abs_diff_matmul": 3 * shards, "fused_inner_scan": shards}
    print(f"mesh: kernel launches {counts} ({INTEROP_BATCHES} global batches of {MESH_SHARDS} shards; want {want})")
    if counts != want or len(res_m.batch_seconds) != INTEROP_BATCHES:
        fail(f"the mesh launched {counts} in {len(res_m.batch_seconds)} global batches, not {want} in "
             f"{INTEROP_BATCHES}")
    for row in rows:
        row["launches_mesh"] = counts[row["name"]]
    rule = scores_rule(torch, "mesh vs unsharded scores", mesh_scores, tar1, spread)
    print(f"mesh: {MESH_SHARDS} shards, global batch {MESH_SHARDS * LANES}, scores of all {len(tar1)} episodes "
          f"(warm-up and timed batches) vs the unsharded --eval_batch {LANES} batches: {rule}; the unsharded rerun spread "
          f"{spread:.3e}; seconds/episode mesh {mesh_s:.4f} vs unsharded {tar_s:.4f} (same call, one card)")
    mark("mesh")

    from mft_tpu_torch.data import native_decode
    from mft_tpu_torch.data.pipeline import WORKERS, decode_image

    name, why = native_decode.describe()
    print(f"decode: MFT_NATIVE_DECODE=auto picks {name}: {why}")
    if name != "native":
        print("decode: no native timing (the PIL path serves the pipeline)")
        return
    import concurrent.futures as cf
    import io

    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(11)
    img_dir = os.path.join(save_dir, "jpegs")
    os.makedirs(img_dir)
    paths = []
    grad = np.linspace(0, 255, 600, dtype=np.float32)
    for i in range(DECODE_IMAGES):  # ISIC-sized 600 x 450 photographs: a smooth field with noise
        arr = (grad[None, :, None] * 0.5 + rs.randint(0, 128, (450, 1, 3))).clip(0, 255).astype(np.uint8)
        arr = np.broadcast_to(arr, (450, 600, 3)) + rs.randint(0, 16, (450, 600, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        paths.append(os.path.join(img_dir, f"{i:04d}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(buf.getvalue())
    out = {}
    with cf.ThreadPoolExecutor(WORKERS) as pool:
        for backend in ("native", "pil", "native"):
            os.environ["MFT_NATIVE_DECODE"] = "1" if backend == "native" else "0"
            t0 = time.perf_counter()
            imgs = native_decode.decode_many(paths, 257, pool=pool, workers=WORKERS, fallback=decode_image)
            out.setdefault(backend, []).append(time.perf_counter() - t0)
            if backend == "pil":
                pil_imgs = imgs
    os.environ.pop("MFT_NATIVE_DECODE")
    if not all(np.array_equal(a, b) for a, b in zip(imgs, pil_imgs)):
        fail("the native decode differs from PIL on the timing's JPEGs")
    print(f"decode (host, {WORKERS} workers, {DECODE_IMAGES} JPEGs of 600 x 450 to 257 x 257): native "
          f"{min(out['native']):.3f} s, PIL {out['pil'][0]:.3f} s; outputs bit-identical")


#: --mesh-scaling: global batches of the widest mesh (the first the warm-up)
SCALING_BATCHES = 3


def phase_mesh_scaling(torch, finetune):
    """The eval's mesh across cards (``--mesh-scaling``): the headline eval at
    full width (``--method all --use_pallas --inner_scan fused --eval_batch
    5``) on meshes of 1, 2, 4, ... of the visible cards, each for the same
    SCALING_BATCHES global batches of the widest mesh, one card run first and
    last; every width's scores held against the one-card run's (bit-equal, or
    the lane rule where the one-card reruns differ), its launch counts
    exact, its steady episodes per second beside one card's, and the seconds
    each shard spent in its worker beside its global batch's.  The widest
    mesh runs a second time with one intra-op thread a worker (the parent's
    count, which the workers take, set to 1)."""
    n = torch.cuda.device_count()
    widths = [1]
    while widths[-1] * 2 <= n:
        widths.append(widths[-1] * 2)
    episodes = SCALING_BATCHES * widths[-1] * LANES
    threads = torch.get_num_threads()
    print(f"mesh scaling: host of {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} in this process's affinity, "
          f"{threads} intra-op threads")
    runs = [(w, threads) for w in widths] + [(widths[-1], 1), (1, threads)]
    results = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as save_dir:
        pj = write_checkpoints(torch, save_dir)
        argv = ["--device", "cuda", "--method", "all", "--use_pallas", "--inner_scan", "fused", "--test_dataset",
                "synthetic", "--model", "ResNet10", *INTEROP_WIDTHS, "--n_shot", "5", "--eval_batch", str(LANES),
                "--paths_json", pj]
        for w, t in runs:
            devices = [f"cuda:{i}" for i in range(w)]
            torch.set_num_threads(t)
            res, scores, steady, counts = eval_scores(torch, finetune, f"mesh of {devices}, {t} threads", argv,
                                                      episodes, mesh_devices=devices)
            torch.set_num_threads(threads)
            shards = episodes // LANES
            want = {"edge_abs_diff_matmul": 3 * shards, "fused_inner_scan": shards}
            if counts != want:
                fail(f"the mesh of {devices} launched {counts}, not {want}")
            if res.shard_seconds:
                steady_shards = [x for batch in res.shard_seconds[1:] for x in batch]
                print(f"mesh of {w} cards, {t} threads: seconds of a shard in its worker, steady batches: mean "
                      f"{sum(steady_shards) / len(steady_shards):.4f}, max {max(steady_shards):.4f}; of a global "
                      f"batch {sum(res.batch_seconds[1:]) / (len(res.batch_seconds) - 1):.4f}")
            results.append({"devices": w, "threads": t, "scores": scores, "steady": steady})
    one, again = results[0], results[-1]
    spread = float((again["scores"] - one["scores"]).abs().max())
    base = (one["steady"] + again["steady"]) / 2
    lines = []
    for r in results[1:-1]:
        rule = scores_rule(torch, f"mesh of {r['devices']} cards vs one card", r["scores"], one["scores"], spread)
        lines.append({"devices": r["devices"], "worker_threads": r["threads"], "seconds_per_episode": r["steady"],
                      "episodes_per_second": 1 / r["steady"], "vs_one_card": base / r["steady"], "rule": rule})
        print(f"mesh scaling: {r['devices']} cards ({r['threads']} threads a worker), global batch "
              f"{r['devices'] * LANES}: {1 / r['steady']:.4f} episodes/s against one card's {1 / one['steady']:.4f} / "
              f"{1 / again['steady']:.4f} (first / last run): {base / r['steady']:.3f} x; scores of all {episodes} "
              f"episodes vs one card: {rule}")
    print(json.dumps({"mesh_scaling": {"episodes": episodes, "one_card_seconds_per_episode":
                                       [one["steady"], again["steady"]], "one_card_rerun_spread": spread,
                                       "meshes": lines}}))


def drive(torch, finetune, label: str, argv, episodes: int) -> float:
    """``episodes`` episodes through the eval driver (in batches of its
    ``--eval_batch``); checks the accuracies, prints the peak device memory,
    and returns the steady seconds per episode: the batches after the first
    (warm-up) over their episodes, or the one batch when there is one."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = finetune.main(argv + ["--iter_num", str(episodes)])
    accs = [float(v) for v in res.accs]
    if len(accs) != episodes or not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in accs):
        fail(f"{label} accuracies out of range: {accs}")
    first = round(res.batch_seconds[0] / res.seconds[0])  # the first batch's episodes
    steady = res.seconds[first:] or res.seconds
    print(f"{label}: {episodes} episodes, accs {accs}, seconds per batch of {first} "
          f"{[round(t, 3) for t in res.batch_seconds]} (the first includes warm-up)")
    print(f"{label} steady seconds/episode = {sum(steady) / len(steady):.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    return sum(steady) / len(steady)


def trace_summary(prof, phases) -> dict:
    """Sums over the raw trace of a profile (``prof.profiler.kineto_results``),
    without building the profiler's Python event tree, which takes minutes
    for an episode of a million events: device busy microseconds (kernels,
    copies, sets; all of them, and those from the first phase range's start
    on the device, past what the driver does before its episodes), per kernel name ``(microseconds, calls)``, and per range
    named ``<phase>:<member>`` (``phases``) its host microseconds and the
    device microseconds of the kernels that start inside its span on the
    device's timeline (its device-side annotation), kernels launched from
    the C loop of the fused scan included."""
    import bisect

    from torch.autograd import DeviceType

    host, spans, kernels = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        ranged = e.is_user_annotation()
        phase = name.split(":")[0] in phases
        if e.device_type() == DeviceType.CPU:
            if ranged and phase:
                host[name] = host.get(name, 0.0) + e.duration_ns() / 1e3
        elif phase:  # a range's annotation on the device's timeline
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif not ranged:
            kernels.append((e.start_ns(), e.duration_ns() / 1e3, name))
    spans.sort()
    starts = [sp[0] for sp in spans]
    device, by_name, busy, episode = {}, {}, 0.0, 0.0
    for start, us, name in kernels:
        busy += us
        episode += us if starts and start >= starts[0] else 0.0
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, calls + 1)
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < spans[i][1]:
            device[spans[i][2]] = device.get(spans[i][2], 0.0) + us
    return {"busy_us": busy, "episode_busy_us": episode, "kernels": by_name, "host_us": host, "device_us": device}


def phase_profile(torch, finetune, argv, steady_s: float, edge_per_episode: int, label: str = "5-shot",
                  scan: bool = True, setup_before: bool = False, episodes: int = 1):
    """One more episode (or one batch of ``episodes`` lanes) of a path under
    ``torch.profiler``: the symbols of the edge kernel and (``scan``) of the
    fused scan's kernels must be on the device timeline, and the edge kernel
    launched ``edge_per_episode`` times in the profiled run.  Prints where
    the time goes: each eval phase's host and device milliseconds (the
    ``<phase>:<member>`` ranges of train/eval_engine.py), the kernels with
    the most device time, and the device's idle share, which is 1 - (device
    kernel time of the profiled run) / (steady seconds per episode without
    the profiler times its episodes; the profiler itself slows the host).
    ``setup_before``: the driver works on the device before its first
    episode (DampNet's source sweep), so the episode's device time starts
    at the first phase range."""
    from torch.profiler import ProfilerActivity, profile

    from mft_tpu_torch.train.eval_engine import PHASES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = finetune.main(argv + ["--iter_num", str(episodes)])
    steady_s *= episodes
    t = trace_summary(prof, PHASES)
    tag = f"profiler ({label})"
    busy_us, kernels = t["busy_us"], t["kernels"]
    if setup_before:  # the driver's work before its episodes (DampNet's source sweep) is no episode's
        print(f"{tag}: device time {busy_us / 1e6:.4f} s in all, {(busy_us - t['episode_busy_us']) / 1e6:.4f} s of it "
              f"before the first phase range (the driver's set-up)")
        busy_us = t["episode_busy_us"]
    if busy_us == 0:
        fail(f"the profiler recorded no device time ({label}), so it cannot show the edge kernel on the path")
    sum_of = lambda sym: [sum(v) for v in zip(*[kv for k, kv in kernels.items() if sym in k])] or [0.0, 0]
    edge_us, edge_n = sum_of("edge_abs_diff_matmul_kernel")
    if edge_per_episode and edge_us == 0:
        fail(f"the profiler traced device kernels but not the edge kernel ({label})")
    if edge_n != edge_per_episode:
        fail(f"the profiled {label} run launched the edge kernel {edge_n} times, the path {edge_per_episode}")
    if edge_per_episode:
        print(f"{tag}: edge kernel on the device timeline, {edge_n} launches, {edge_us / 1e3:.4f} ms device time in "
              f"the profiled run (W's split passes {sum_of('edge_split_w_kernel')[0] / 1e3:.4f} ms besides)")
    else:
        print(f"{tag}: no edge kernel on the device timeline, as the path has none")
    # the scan's kernels: its products on the tensor cores for a bf16 bank, on the FMA route for an f32 one
    routes = {"tensor-core": ("TagConv1ScFwd", "TagConv2Fwd", "TagConv2Dx", "TagDwAllAdam"),
              "FMA": ("conv_gemm_kernel", "conv_wgrad_kernel", "adam_kernel")}
    every = {sym: sum_of(sym)[0] for syms in routes.values() for sym in syms + ("bn_fwd_kernel", "bn_bwd_kernel")}
    ran = [r for r, syms in routes.items() if min(every[sym] for sym in syms + ("bn_fwd_kernel", "bn_bwd_kernel")) > 0]
    scan_us = {sym: every[sym] for sym in routes[ran[0]] + ("bn_fwd_kernel", "bn_bwd_kernel")} if ran else every
    if scan and not ran:
        fail(f"the profiler traced device kernels but not every kernel of the fused scan ({label}): {scan_us}")
    if not scan and max(scan_us.values()) > 0:
        fail(f"the {label} episode ran kernels of the fused scan, which its path does not use: {scan_us}")
    if scan:
        print(f"{tag}: fused scan kernels on the device timeline ({ran[0]} route), {sum(scan_us.values()) / 1e3:.3f} ms "
              f"device time in the profiled run: " + ", ".join(f"{sym} {us / 1e3:.3f}" for sym, us in scan_us.items()))
    print(f"{tag}: {'episode' if episodes == 1 else f'batch of {episodes}'} {sum(res.batch_seconds):.3f} s under the "
          f"profiler, {steady_s:.3f} s without; "
          f"device time {busy_us / 1e6:.4f} s; idle share {1.0 - busy_us / 1e6 / steady_s:.4f}")
    for name in sorted(t["host_us"], key=lambda k: -t["host_us"][k]):
        print(f"{tag} phase {name}: host {t['host_us'][name] / 1e3:.3f} ms, device "
              f"{t['device_us'].get(name, 0.0) / 1e3:.3f} ms (kernels starting inside its span on the device)")
    for name, (us, calls) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{tag} kernel {us / 1e3:10.3f} ms {calls:7d} calls  {name[:110]}")
    return {"edge_ms": edge_us / 1e3, "scan_ms": sum(scan_us.values()) / 1e3, "idle": 1.0 - busy_us / 1e6 / steady_s}


def phase_training(torch, kernels, save_dir) -> dict:
    """The three training stages at full width through
    ``mft_tpu_torch.cli.train.main`` on the synthetic dataset, ResNet10 at
    224 px, chained as the eval finds them: baseline at epoch 400 (batch 16),
    episodic GnnNet ``--train_aug --use_pallas`` (5-way 5-shot, 16 queries)
    at 599, ``--fine_tune`` resumed from 599.tar to 600; then a few steps of
    ``cli.train_50 --method gnnnet --train_aug --use_pallas`` (5-way 50-shot,
    16 queries, 130-node graphs).  Around each stage
    every launch count is set to 0 and read after; the edge kernel must run
    three times a step in the two GnnNet stages.  Per stage: seconds per step
    (the first dropped, and the profiled one), peak device memory, and for
    step PROFILED_STEP under torch.profiler its device time, idle share, the
    edge kernel's forward and its plain backward's device time.  Returns the
    launch counts of the two GnnNet stages summed, and those of train_50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mft_tpu_torch.cli import train, train_50
    from mft_tpu_torch.train import steps

    pj = os.path.join(save_dir, "paths.json")
    common = ["--device", "cuda", "--dataset", "synthetic", "--model", "ResNet10", "--image_size", "224",
              "--paths_json", pj]
    gnn = common + ["--method", "gnnnet", "--train_aug", "--use_pallas", "--n_shot", "5", "--n_query", "16"]
    stages = (
        ("baseline", common + ["--method", "baseline", "--batch_size", "16", "--start_epoch", "400", "--stop_epoch",
                               "400"]),
        ("episodic", gnn + ["--episodes_per_epoch", str(TRAIN_EPISODES["episodic"]), "--start_epoch", "599",
                            "--stop_epoch", "599"]),
        ("fine_tune", gnn + ["--fine_tune", "--episodes_per_epoch", str(TRAIN_EPISODES["fine_tune"]),
                             "--start_epoch", "600", "--stop_epoch", "600"]),
        ("train50", common + ["--method", "gnnnet", "--train_aug", "--use_pallas", "--n_query", "16",
                              "--episodes_per_epoch", str(TRAIN_EPISODES["train50"]), "--start_epoch", "0",
                              "--stop_epoch", "0"]),
    )
    damp = common + ["--n_shot", "5", "--n_query", "16", "--start_epoch", "0", "--stop_epoch", "0"]
    stages += (
        ("dampnet_full_class", damp + ["--method", "dampnet_full_class", "--train_aug", "--episodes_per_epoch",
                                       str(TRAIN_EPISODES["dampnet_full_class"])]),
        ("dampnet", damp + ["--method", "dampnet", "--episodes_per_epoch", str(TRAIN_EPISODES["dampnet"])]),
    )
    on = lambda model, argv: [model if a == "ResNet10" else a for a in argv]
    stages += (
        ("ResNet10_FW episodic", on("ResNet10_FW", gnn) + ["--episodes_per_epoch",
                                                           str(TRAIN_EPISODES["ResNet10_FW episodic"]),
                                                           "--start_epoch", "0", "--stop_epoch", "0"]),
        ("ResNet18 baseline", on("ResNet18", common) + ["--method", "baseline", "--batch_size", "16", "--start_epoch",
                                                        "0", "--stop_epoch", "0"]),
    )
    train_counts = {name: 0 for name in kernels.MODULES}
    stage_counts = {}
    for stage, argv in stages:
        trace = {}

        @contextlib.contextmanager
        def profiled():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                yield
                torch.cuda.synchronize()
            trace["events"] = prof.key_averages()

        observe = lambda _stage, _epoch, step: profiled() if step == PROFILED_STEP else contextlib.nullcontext()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = (train_50 if stage == "train50" else train).main(argv, observe_step=observe)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n = len(res.losses)
        if n <= PROFILED_STEP + 1 or not all(math.isfinite(v) for v in res.losses):
            fail(f"training stage {stage}: {n} steps, losses {res.losses}")
        steady = [t for i, t in enumerate(res.seconds) if i not in (0, PROFILED_STEP)]
        step_s = sum(steady) / len(steady)
        # DampNet's GNN takes the plain edge op, as JAX's (DampNetCfg.gnn_cfg passes no use_pallas)
        want_edge = 0 if stage.endswith("baseline") or stage.startswith("dampnet") else 3 * n
        print(f"training {stage}: {n} steps, losses {[round(v, 4) for v in res.losses]}, seconds per step "
              f"{[round(t, 4) for t in res.seconds]} (first includes warm-up, step {PROFILED_STEP} profiled)")
        print(f"training {stage} steady seconds/step = {step_s:.4f}; peak device memory "
              f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); kernel launches {counts}")
        if counts["edge_abs_diff_matmul"] != want_edge:
            fail(f"training {stage} launched the edge kernel {counts['edge_abs_diff_matmul']} times, not {want_edge} "
                 f"(three a step)")
        if counts["fused_inner_scan"] != 0:
            fail(f"training {stage} launched the fused scan, which the training path does not use")
        stage_counts[stage] = counts
        if stage == "ResNet10_FW episodic":
            check_fwt_frozen(torch, os.path.join(res.ckpt_dir, "0.tar"))
        if stage == "dampnet":
            with open(os.path.join(res.ckpt_dir, "train_log.jsonl")) as f:
                modes = [json.loads(line)["mode"] for line in f if '"mode"' in line]
            print(f"training dampnet modes {modes}")
            if not {"plain", "corrupt", "recover"} <= set(modes):
                fail(f"the prototype DampNet run did not take every training mode: {modes}")
        if stage in ("episodic", "fine_tune"):
            for name, v in counts.items():
                train_counts[name] += v
        events = trace["events"]
        on_device = [e for e in events if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)]
        busy_us = sum(e.self_device_time_total for e in on_device)
        if busy_us == 0:
            fail(f"the profiler recorded no device time in the {stage} step")
        fwd_us = sum(e.self_device_time_total for e in on_device
                     if "edge_abs_diff_matmul_kernel" in e.key or "edge_split_w_kernel" in e.key)
        for e in events:
            if e.device_type == DeviceType.CPU and e.key == steps.INNER_RANGE:
                print(f"training {stage} profiled step: range {e.key}: host {e.cpu_time_total / 1e3:.3f} ms, device "
                      f"{e.device_time_total / 1e3:.3f} ms")
        bwd = [e for e in events if e.device_type == DeviceType.CPU and e.key == "edge_abs_diff_matmul:backward"]
        bwd_us = sum(e.device_time_total for e in bwd)
        if want_edge and fwd_us == 0:
            fail(f"the profiler traced the {stage} step but not the edge kernel")
        print(f"training {stage} profiled step: device time {busy_us / 1e3:.3f} ms, idle share "
              f"{1.0 - busy_us / 1e6 / step_s:.4f} (against the steady {step_s:.4f} s a step); edge kernel forward "
              f"{fwd_us / 1e3:.4f} ms device; its plain backward {bwd_us / 1e3:.4f} ms device in "
              f"{sum(e.count for e in bwd)} calls of the edge_abs_diff_matmul:backward range")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:5]:
            print(f"training {stage} kernel {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls  {e.key[:100]}")
        mark(f"training {stage}")
    return train_counts, stage_counts


def check_fwt_frozen(torch, path: str):
    """The noise strengths a ResNet10_FW training run saved are their init
    values, bit for bit (``freeze_masked``), and its Adam state keeps no
    moments for them."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    fwt = {k: v for k, v in blob["state"].items() if k.endswith((".gamma", ".beta"))}
    moved = [k for k, v in fwt.items() if not torch.equal(v, torch.full_like(v, 0.3 if k.endswith("gamma") else 0.5))]
    in_adam = [k for k in blob.get("adam", {}).get("mu", {}) if "fwt_" in k]
    print(f"training ResNet10_FW: its {len(fwt)} noise strengths after the steps are their init values: {not moved}; "
          f"Adam moments kept for them: {len(in_adam)}")
    if len(fwt) != 14 or moved or in_adam:
        fail(f"ResNet10_FW training moved or kept Adam state for its frozen noise strengths: {moved or in_adam}")


#: cli.test episodes after cli.save_features (two --eval_batch 5 batches)
FEATURE_TEST_EPISODES = 10


def phase_feature_tools(torch, save_dir: str):
    """``cli.save_features`` over the synthetic split (480 images at 224 px,
    batches of 64) with the ResNet18 baseline checkpoint the training phase
    wrote, then ``cli.test`` on those features without and with
    ``--adaptation`` (the linear probe: 100 epochs of batch 4 a lane),
    FEATURE_TEST_EPISODES episodes each; seconds of each."""
    from mft_tpu_torch.cli import save_features
    from mft_tpu_torch.cli import test as feature_test

    common = ["--device", "cuda", "--dataset", "synthetic", "--model", "ResNet18", "--method", "baseline",
              "--paths_json", os.path.join(save_dir, "paths.json")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = save_features.main(common + ["--save_iter", "0", "--split", "novel"])
    print(f"save_features (ResNet18, 224 px): {res.n_images} images in {time.perf_counter() - t0:.3f} s "
          f"({res.seconds:.3f} s in its embedding loop)")
    if res.n_images != 480:
        fail(f"save_features embedded {res.n_images} images, not the synthetic split's 480")
    for extra in ([], ["--adaptation"]):
        t0 = time.perf_counter()
        out = feature_test.main(common + ["--n_shot", "5", "--iter_num", str(FEATURE_TEST_EPISODES), "--eval_batch",
                                          str(LANES)] + extra)
        seconds = time.perf_counter() - t0
        if len(out.accs) != FEATURE_TEST_EPISODES or not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in out.accs):
            fail(f"cli.test {' '.join(extra)}: accuracies {out.accs}")
        print(f"cli.test {' '.join(extra) or '(ProtoNet scores)'}: {FEATURE_TEST_EPISODES} episodes in {seconds:.3f} s, "
              f"seconds per batch of {LANES} {[round(t, 4) for t in out.batch_seconds]} (the first includes warm-up); "
              f"mean acc {out.mean:.2f}")


def phase_dampnet_eval(torch, kernels, finetune, rows, paths_json: str):
    """The DampNet eval from the checkpoint the training phase wrote
    (``--method dampnet_full_class --train_aug --inner_scan fused``, full
    width, its source prototypes swept from the synthetic base set first):
    2 episodes, launch counts set to 0 before and read after (the scan once
    an episode, the edge kernel never: DampNet's GNN takes the plain edge
    op), one profiled episode.  Then its three compositions (the live one,
    ``--unsupervised synthetic`` and ``--dampnet_eval nofinetune``) at
    ``--eval_batch 1`` (DAMP_EPISODES episodes) and at ``--eval_batch
    LANES`` (two batches, the first the warm-up), strict f32: the lanes'
    scores of the same episodes held against the single episodes' to
    XDEV_TOL with the same argmax wherever the single episodes' top two lie
    more than XDEV_LANE_MARGIN apart (the live composition's with no inner
    steps, in two more drives: see DAMP_EPISODES), launch counts exact (the scan once a batch in the live composition,
    never in the others; the edge kernel never), seconds per episode of
    both, peak memory, and one profiled lane batch each."""
    damp = ["--device", "cuda:0", "--method", "dampnet_full_class", "--train_aug", "--inner_scan", "fused", "--eval_batch", "1",
            "--dataset", "synthetic", "--test_dataset", "synthetic", "--model", "ResNet10", "--image_size", "224",
            "--n_shot", "5", "--gen_examples", "17", "--fine_tune_epoch", "5", "--paths_json", paths_json]
    kernels.reset_launch_counts()
    steady = drive(torch, finetune, "DampNet eval (dampnet_full_class --inner_scan fused)", damp, 2)
    counts = kernels.launch_counts()
    print(f"DampNet eval kernel launches: {counts} (the scan once an episode; the edge kernel 0: DampNet's GNN "
          f"takes the plain edge op)")
    if counts["fused_inner_scan"] != 2 or counts["edge_abs_diff_matmul"] != 0:
        fail(f"the DampNet eval launched {counts}, not the scan once an episode and the edge kernel never")
    for row in rows:
        row["launches_dampnet"] = counts[row["name"]]
    phase_profile(torch, finetune, damp, steady, 0, label="DampNet", setup_before=True)
    mark("DampNet eval and profile")
    strict = damp + ["--dtype", "float32", "--inner_param_dtype", "float32"]
    lanes = strict[: strict.index("--eval_batch")] + ["--eval_batch", str(LANES)] + strict[strict.index("--eval_batch") + 2 :]
    launches = {}
    for label, extra in (("live", []), ("unsupervised", ["--unsupervised", "synthetic"]),
                         ("nofinetune", ["--dampnet_eval", "nofinetune"])):
        _, one, steady1, counts1 = eval_scores(torch, finetune, f"DampNet eval ({label}, --eval_batch 1, strict f32)",
                                               strict + extra, DAMP_EPISODES)
        _, many, steady_l, counts_l = eval_scores(torch, finetune, f"DampNet eval ({label}, --eval_batch {LANES}, "
                                                  f"strict f32)", lanes + extra, 2 * LANES)
        scans = {"live": (DAMP_EPISODES, 2)}.get(label, (0, 0))
        print(f"DampNet eval ({label}) kernel launches: --eval_batch 1 {counts1}, --eval_batch {LANES} {counts_l}")
        if (counts1["fused_inner_scan"], counts_l["fused_inner_scan"]) != scans or counts1["edge_abs_diff_matmul"] \
                or counts_l["edge_abs_diff_matmul"]:
            fail(f"the DampNet {label} eval launched {counts1} / {counts_l}, not the scan {scans} times and the edge "
                 f"kernel never")
        for name, n in counts_l.items():
            launches[name] = launches.get(name, 0) + n
        print(f"DampNet eval ({label}): seconds/episode --eval_batch {LANES} {steady_l:.4f} vs --eval_batch 1 "
              f"{steady1:.4f} (same call, strict f32): {steady1 / steady_l:.3f} x")
        held = ""
        if label == "live":  # the scores are held without the inner steps' sign chaos (DAMP_EPISODES)
            print(f"DampNet eval (live): the full-depth lanes against the same {DAMP_EPISODES} episodes alone: max |d "
                  f"scores| {float((many[:DAMP_EPISODES] - one).abs().max()):.3e} (not held: the inner steps' chaos)")
            held, depth = " with --fine_tune_epoch 0", ["--fine_tune_epoch", "0"]
            _, one, _, _ = eval_scores(torch, finetune, f"DampNet eval (live{held}, --eval_batch 1, strict f32)",
                                       strict + extra + depth, DAMP_EPISODES)
            _, many, _, _ = eval_scores(torch, finetune, f"DampNet eval (live{held}, --eval_batch {LANES}, strict f32)",
                                        lanes + extra + depth, LANES)
        got, want = many[:DAMP_EPISODES], one
        diff = float((got - want).abs().max())
        top2 = want.topk(2, dim=-1).values
        flipped = (got.argmax(-1) != want.argmax(-1)) & ((top2[..., 0] - top2[..., 1]) > XDEV_LANE_MARGIN)
        print(f"DampNet eval ({label}{held}): the lanes' scores against the same {DAMP_EPISODES} episodes alone: max "
              f"|d scores| {diff:.3e}, {int(flipped.sum())} clear argmax flips (bound {XDEV_TOL:g}, no clear flip)")
        if diff > XDEV_TOL or bool(flipped.any()):
            fail(f"the DampNet {label} lanes part from the episodes alone by {diff:.3e}{held}")
        phase_profile(torch, finetune, lanes + extra, steady_l, 0, label=f"DampNet {label}, {LANES} lanes",
                      scan=label == "live", setup_before=True, episodes=LANES)
        mark(f"DampNet {label} lanes and profile")
    for row in rows:
        row["launches_dampnet_lanes"] = launches[row["name"]]


def phase_world1_group(torch, dev) -> dict:
    """The data-parallel path in this process: an nccl process group of
    world 1 on the card (NCCL refuses two ranks on one card), then one
    episodic GnnNet step of two episodes (ResNet10 at 224 px, 5-way 5-shot,
    16 queries, the edge kernel) and one ``--method all --use_pallas
    --inner_scan fused`` lane batch of the eval (``evaluate`` over the group), each
    through the group path and held bit for bit against the ``group=None``
    path (``parallel/dryrun.py``'s pieces, cuDNN deterministic).  Returns
    the group path's kernel launches, which must be above 0 for both
    kernels."""
    import torch.distributed as dist

    from mft_tpu_torch import kernels
    from mft_tpu_torch.parallel import distributed as pdist
    from mft_tpu_torch.parallel import dryrun

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pdist.init_process_group(0, 1, f"tcp://127.0.0.1:{dryrun.free_port()}", "cuda")
    try:
        group, sizes = dist.group.WORLD, dryrun.CUDA
        m = dryrun.seeded_model(dev, sizes, group)
        fn, params = dryrun.step_call("episodic", m, sizes, WORLD1_EPISODES, dev, None)
        want, _, alone_s = dryrun.step_readings(fn, params, None, dev)
        kernels.reset_launch_counts()
        got, _, group_s = dryrun.step_readings(fn, params, group, dev)
        launches = kernels.launch_counts()
        apart = [k for k in ("grads", "updates", "stats")
                 if not all(torch.equal(got[k][n], v) for n, v in want[k].items())]
        if got["loss"] != want["loss"] or apart:
            fail(f"the world-1 group's episodic step is not bit-equal to group=None: loss {got['loss']} vs "
                 f"{want['loss']}, {apart} apart")
        ev = dryrun.rank_eval(m, sizes, group, dev, "all", {"baseline": (m.feature, m.stats),
                                                            "gnn": (m.feature, m.stats, m.head)})
        if not torch.equal(ev["scores"], ev["ref_scores"]):
            fail(f"the world-1 group's eval scores part from one device's by "
                 f"{float((ev['scores'] - ev['ref_scores']).abs().max()):.3e}")
        for name, c in ev["launches"].items():
            launches[name] += c
        print(f"process group of world 1 (nccl): episodic GnnNet step of {WORLD1_EPISODES} episodes bit-equal to "
              f"group=None (loss {got['loss']:.7f}; {group_s:.4f} s vs {alone_s:.4f} s, first calls), one "
              f"--eval_batch {sizes.eval_lanes} lane batch's scores bit-equal to one device's; group path kernel "
              f"launches {launches} (step {3 * WORLD1_EPISODES} edge, eval {ev['launches']})")
        if min(launches.values()) == 0:
            fail(f"a kernel was never launched on the world-1 group path: {launches}")
        return launches
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic


def phase_distributed(torch) -> dict:
    """``--distributed``: ``parallel/dryrun.py --full`` over nccl at world 2
    and 4 (one rank a card; every world the visible cards allow), at
    ResNet10's width, 224 px, 5-way 5-shot, 16 queries, ``use_pallas``: one
    episode a rank through every training step, then a ``--method all
    --inner_scan fused`` lane batch a rank (and the live DampNet eval).  The
    dry run asserts its rules (``dryrun.check``: each step within phase 4's
    rules of the one-card step, the planted faults outside them, the trees
    bit-equal, the eval's scores equal, the launches exact); here each
    step's readings against its bounds, its seconds at world W beside one
    card's (the same global batch) and the all-reduce's share are printed."""
    from mft_tpu_torch.parallel import dryrun

    n = torch.cuda.device_count()
    worlds = [w for w in DIST_WORLDS if w <= n]
    if not worlds:
        fail(f"--distributed needs at least {DIST_WORLDS[0]} cards, {n} visible")
    summary = {}
    for world in worlds:
        try:
            results = dryrun.run(world, "cuda", full=True, timeout=DIST_TIMEOUT, repeats=2)
            lines = dryrun.check(results, on_card=True)
        except (AssertionError, RuntimeError, TimeoutError) as e:
            fail(f"the dry run at world {world}: {e}")
        for line in lines:
            print(line)
        r0 = results[0]
        for kind, row in r0["steps"].items():
            share = row["allreduce_seconds"] / row["seconds"]
            print(f"distributed world {world}, {kind}: {row['seconds']:.4f} s a step ({world} cards, one episode "
                  f"each) vs {row['ref_seconds']:.4f} s on one card (the same {world} episodes); all-reduce, the wait "
                  f"for the slowest rank included, {row['allreduce_seconds'] * 1e3:.3f} ms, {share:.4f} of the step; "
                  "rules: "
                  + ", ".join(f"{k} {row['apart'][k]:.3e} <= {v:.3e}" for k, v in dryrun.rule_bounds(row["apart"]).items()))
        summary[world] = {
            "seconds": {k: row["seconds"] for k, row in r0["steps"].items()},
            "one_card_seconds": {k: row["ref_seconds"] for k, row in r0["steps"].items()},
            "allreduce_ms": {k: row["allreduce_seconds"] * 1e3 for k, row in r0["steps"].items()},
            "allreduce_alone_ms": {k: ms for k, (_, ms) in r0["allreduce_alone"].items()},
            "faults": {f["kind"]: dryrun.rules_broken(f["apart"]) for f in r0["faults"]},
            "launches": [{k: row["launches"] for k, row in r["steps"].items()}
                         | {"eval": r["eval"]["launches"], "damp_eval": r["damp_eval"]["launches"]} for r in results]}
        mark(f"distributed, world {world}")
    return summary


def chain_argv(flags: dict) -> list:
    """The synthetic pipeline's argv on the card with both kernels on, at
    ``flags`` (its count flags; the script's defaults where absent)."""
    argv = ["--device", "cuda", "--use_pallas", "--inner_scan", "fused"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def chain_steps(a) -> dict:
    """Steps (batches for the eval) of each stage of the chain at flags ``a``."""
    return {"baseline": a.baseline_steps, "episodic": a.steps, "fine_tune": a.finetune_steps, "eval": a.eval_batches}


class StageWindows:
    """A ``step_hook`` of ``synthetic_pipeline.main``: in each stage of the
    run itself, ``torch.profiler`` over the steps after ``windows[stage][0]``
    (``windows[stage][1]`` of them), the device synchronized as the window
    opens and closes, so the window's host seconds are its wall time.
    ``readings[stage] = (wall seconds, profile, steps)``; ``spent[stage]``:
    the seconds the hook itself took starting and stopping the profiler,
    which the stage's seconds include; ``marks[stage]``: the host clock as
    each step or batch was enqueued."""

    def __init__(self, torch, windows):
        self.torch, self.windows, self.prof, self.t0, self.readings, self.spent = torch, windows, None, 0.0, {}, {}
        self.marks = {stage: [] for stage in windows}

    def outside(self, stage) -> tuple:
        """Median host seconds a step (enqueue to enqueue) before the window and
        after it, leaving out the steps that open or close it."""
        start, n = self.windows[stage]
        steps = [b - a for a, b in zip(self.marks[stage], self.marks[stage][1:])]  # steps[k - 1]: step k
        return statistics.median(steps[:start]), statistics.median(steps[start + n + 1:])

    def __call__(self, stage, i):
        from torch.profiler import ProfilerActivity, profile

        self.marks[stage].append(time.perf_counter())
        start, n = self.windows[stage]
        if i not in (start, start + n):
            return
        if i == start:
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.spent[stage] = self.t0 - t
            return
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        wall = t - self.t0
        self.prof.__exit__(None, None, None)
        self.readings[stage] = (wall, self.prof, n)
        self.spent[stage] += time.perf_counter() - t


def run_chain(torch, kernels, sp, argv, label: str, step_hook=None):
    """``mft_tpu_torch.examples.synthetic_pipeline.main(argv)`` with every
    launch count set to 0 before and read after.  Every loss must be finite,
    every accuracy in [0, 100], and the launches exactly what the chain's
    code gives: the edge kernel 3 times an episode in the episodic and
    fine-tune steps (their head runs episode by episode) and 3 times a
    held-out lane batch (one GNN pass for its lanes), the scan once a lane
    batch.  Prints each stage's seconds and launches and the peak memory;
    returns the result and the launch counts."""
    a = sp.parse_args(argv)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = sp.main(argv, step_hook=step_hook)
    counts = kernels.launch_counts()
    steps = chain_steps(a)
    for stage, losses in res["losses"].items():
        if len(losses) != steps[stage] or not all(math.isfinite(v) for v in losses):
            fail(f"{label}: the {stage} stage's losses are not {steps[stage]} finite values: {losses}")
    if len(res["accs"]) != a.eval_batches * sp.EVAL_LANES or not all(0.0 <= v <= 100.0 for v in res["accs"]):
        fail(f"{label}: held-out accuracies out of range: {res['accs']}")
    for stage in sp.STAGES:
        unit, units = ("batch", "batches") if stage == "eval" else ("step", "steps")
        print(f"{label} {stage}: {steps[stage]} {units} in {res['seconds'][stage]:.3f} s, "
              f"{res['seconds'][stage] / steps[stage]:.4f} s a {unit}; launches {res['launches'][stage]}")
    want = {"edge_abs_diff_matmul": 3 * (a.steps + a.finetune_steps) * sp.EPISODES + 3 * a.eval_batches,
            "fused_inner_scan": a.eval_batches}
    print(f"{label}: held-out accuracy {res['acc']:.2f}% +- {res['ci95']:.2f}% over {len(res['accs'])} episodes; "
          f"kernel launches {counts} (the code gives {want}); peak device memory "
          f"{res['peak_bytes'] / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    if counts != want:
        fail(f"{label} launched {counts}, not {want}")
    return res, counts


def phase_pipeline(torch, kernels, dev):
    """``--pipeline``: the scan at the chain's geometry, then the synthetic
    pipeline at the JAX script's defaults (600 baseline steps, 188 episodic
    and 40 fine-tune steps of 8 episodes, 8 held-out lane batches of 4) with
    both kernels; its loss curve, the held-out accuracy again with the eager
    inner loop on the same trained trees, the rules of PIPELINE_*; and each
    stage's device time and idle share in a profiler window of the run
    itself (PIPELINE_WINDOWS, after the stage's warm-up)."""
    from mft_tpu_torch.examples import synthetic_pipeline as sp
    from mft_tpu_torch.kernels import fused_inner_scan as fis

    failures = []
    phase_fused_64px(torch, fis, dev, failures)
    if failures:
        fail("the fused inner scan disagrees with its plain version at 64 px: " + ", ".join(failures))
    mark("fused scan checks, 64 px")
    windows = StageWindows(torch, PIPELINE_WINDOWS)
    res, _ = run_chain(torch, kernels, sp, chain_argv({}), "pipeline", step_hook=windows)
    ep, ft, top1 = res["losses"]["episodic"], res["losses"]["fine_tune"], res["top1"]
    mean = lambda v: sum(v) / len(v)
    print("pipeline episodic loss every 25 steps (8 episodes a step), and the mean of the 25 from there: "
          + "; ".join(f"{i}: {ep[i]:.4f} / {mean(ep[i:i + 25]):.4f}" for i in range(0, len(ep), 25)))
    for level in (1.0, 0.5):
        below = next((i for i in range(len(ep) - 9) if mean(ep[i:i + 10]) < level), None)
        print(f"pipeline: the first step whose next 10 losses average below {level}: {below} "
              f"({'never' if below is None else f'{below * 8} episodes'})")
    print("pipeline baseline top-1 every 150 steps: "
          + "; ".join(f"{i}: {top1[i]:.4f}" for i in range(0, len(top1), 150)) + f"; last {top1[-1]:.4f}")
    print("pipeline fine-tune loss every 20 steps: " + "; ".join(f"{i}: {ft[i]:.4f}" for i in range(0, len(ft), 20))
          + f"; last {ft[-1]:.4f}, mean {mean(ft):.4f}")
    tail = mean(ep[-PIPELINE_TAIL:])
    print(f"pipeline: episodic loss {ep[0]:.4f} at step 0, {tail:.4f} over the last {PIPELINE_TAIL} steps "
          f"(at most {PIPELINE_TAIL_LOSS})")
    mark("pipeline, fused")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    eager = sp.run_heldout(res["models"], device=dev, use_pallas=True, inner_scan="eager")
    counts_e = kernels.launch_counts()
    print(f"pipeline held-out, --inner_scan fused: {res['acc']:.2f}% +- {res['ci95']:.2f}% "
          f"({res['seconds']['eval']:.3f} s for {len(eager.scores)} batches); --inner_scan eager on the same trees: "
          f"{eager.mean:.2f}% +- {eager.ci95:.2f}% ({eager.seconds:.3f} s, launches {counts_e}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB)")
    if not tail < PIPELINE_TAIL_LOSS:
        failures.append(f"the episodic loss of the last {PIPELINE_TAIL} steps averages {tail:.4f}")
    if not res["acc"] >= PIPELINE_MIN_ACC:
        failures.append(f"the fused held-out accuracy is {res['acc']:.2f}%")
    if not abs(res["acc"] - eager.mean) <= PIPELINE_EAGER_GAP:
        failures.append(f"the eager accuracy {eager.mean:.2f}% is {abs(res['acc'] - eager.mean):.2f} points away")
    if counts_e["fused_inner_scan"] != 0 or counts_e["edge_abs_diff_matmul"] != 3 * len(eager.scores):
        failures.append(f"the eager eval launched {counts_e}")
    if failures:
        fail("the synthetic pipeline: " + "; ".join(failures))
    mark("pipeline, eager eval")

    full = chain_steps(sp.parse_args(chain_argv({})))
    for stage in sp.STAGES:
        if stage not in windows.readings:
            fail(f"the {stage} stage's profiler window never closed")
        wall, prof, n = windows.readings[stage]
        t = trace_summary(prof, ("pipeline",))
        unit = "batch" if stage == "eval" else "step"
        if t["busy_us"] == 0:
            fail(f"the profiler recorded no device time in the {stage} stage's window")
        device_s, host_s = t["busy_us"] / 1e6 / n, wall / n
        net = res["seconds"][stage] - windows.spent[stage]
        before, after = windows.outside(stage)
        print(f"pipeline {stage}, profiler window of {n} {unit}s after {unit} {PIPELINE_WINDOWS[stage][0]} of the run: "
              f"device {device_s:.4f} s a {unit}, host {host_s:.4f} s a {unit} (wall, device synchronized at both "
              f"ends); idle share {1.0 - device_s / host_s:.4f}; unprofiled, median host s a {unit} (enqueue to enqueue) "
              f"before the window {before:.4f} and after it {after:.4f}: device / that {device_s / before:.4f} and "
              f"{device_s / after:.4f}; the stage {net:.3f} s without the hook's own {windows.spent[stage]:.3f} s")
        for k, (us, calls) in sorted(t["kernels"].items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"pipeline {stage} window kernel {us / 1e3:10.3f} ms {calls:7d} calls  {k[:100]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import mft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py ({e})")
    from mft_tpu_torch import kernels
    from mft_tpu_torch.cli import finetune, finetune_50
    from mft_tpu_torch.kernels import build, fused_inner_scan

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {list(build.SOURCES)} "
          f"({'cached' if not logs else 'compiled ' + ', '.join(logs)})")
    for name, log in logs.items():
        report_build(name, log, build.BUILD_DIR)

    mark("build")

    if "--mesh-scaling" in sys.argv[1:]:  # the eval's mesh across every visible card, against one card
        for line in smi.stdout.strip().splitlines()[1:]:
            print(line)
        phase_mesh_scaling(torch, finetune)
        mark("mesh scaling")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    if "--distributed" in sys.argv[1:]:  # data-parallel training and eval over nccl, one rank a card
        for line in smi.stdout.strip().splitlines()[1:]:
            print(line)
        summary = phase_distributed(torch)
        print(json.dumps({"distributed": summary}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    if "--pipeline" in sys.argv[1:]:  # the synthetic pipeline at the JAX script's defaults
        phase_pipeline(torch, kernels, dev)
        mark("pipeline")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

    # 3. every kernel against its plain version
    rows = [phase_edge_kernel(torch, dev)]
    mark("edge kernel checks")
    rows.append(phase_fused_inner_scan(torch, dev))
    mark("fused scan checks, 500-row bank")
    rows[1].update(phase_fused_inner_scan_50(torch, dev))
    mark("fused scan checks, 5000-row bank")
    rows[1].update(phase_fused_lanes(torch, dev))
    mark(f"fused scan checks, {LANES} and {CELL_LANES} lanes")
    if "--kernels-only" in sys.argv[1:]:  # for work on a kernel: stop after the checks against the plain versions
        print("kernels only: stopping before the eval phases")
        return

    # 4. the eval, and one step of each training stage, on the card against the CPU
    phase_cross_device(torch, dev)
    mark("eval card vs CPU")
    phase_train_cross_device(torch, dev)
    mark("training steps card vs CPU")
    phase_dampnet_cross_device(torch, dev)
    mark("DampNet step and eval card vs CPU")
    phase_backbones_cross_device(torch, dev)
    mark("ResNet10_FW step and ResNet18 lanes card vs CPU")
    launches_world1 = phase_world1_group(torch, dev)
    mark("process group of world 1")

    # 5. the main path at full width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        pj = write_checkpoints(torch, save_dir)
        # cuda:0: one card's eval (a plain cuda would span every visible card)
        base = ["--device", "cuda:0", "--method", "all", "--use_pallas", "--test_dataset", "synthetic",
                "--model", "ResNet10", "--image_size", "224", "--gen_examples", "17", "--fine_tune_epoch", "5",
                "--paths_json", pj]
        common = base + ["--n_shot", "5", "--eval_batch", "1"]  # one episode a batch: comparable with earlier runs
        argv = common + ["--inner_scan", "fused"]
        kernels.reset_launch_counts()
        steady = drive(torch, finetune, "main path (--inner_scan fused)", argv, EPISODES)
        counts = kernels.launch_counts()
        print(f"main path kernel launches: {counts} (fused_inner_scan: one call per episode, each enqueues "
              f"{fused_inner_scan.kernels_per_step(torch.bfloat16)} device kernels per inner step)")
        for row in rows:
            row["launches"] = counts[row["name"]]
            if row["launches"] == 0:
                fail(f"kernel {row['name']} was never launched on the main path")

        # the eager inner loop in the same call, on the same host
        eager = drive(torch, finetune, "eager path (--inner_scan eager)", common + ["--inner_scan", "eager"], 2)
        print(f"seconds/episode fused {steady:.4f} vs eager {eager:.4f} (same call): eager / fused = {eager / steady:.3f}")
        # the strict-parity numerics at the same width
        drive(torch, finetune, "strict f32 path", common + ["--dtype", "float32", "--inner_param_dtype", "float32"], 2)
        phase_profile(torch, finetune, argv, steady, counts["edge_abs_diff_matmul"] // EPISODES)
        mark("5-shot eval runs and profile")

        # the 50-shot main path (cli.finetune_50): 130-node graphs, a 5000-row bank, 5000 fused steps
        argv50 = base + ["--inner_scan", "fused", "--eval_batch", "1"]
        kernels.reset_launch_counts()
        drive(torch, finetune_50, "50-shot main path (finetune_50 --inner_scan fused)", argv50, EPISODES_50)
        counts50 = kernels.launch_counts()
        print(f"50-shot main path kernel launches: {counts50}")
        for row in rows:
            row["launches_50"] = counts50[row["name"]]
            if row["launches_50"] == 0:
                fail(f"kernel {row['name']} was never launched on the 50-shot main path")
        mark("50-shot eval")
        # profiled with PROFILE_50_FLAGS, the idle share against the same flags' steady seconds
        argv50p = argv50 + PROFILE_50_FLAGS
        steady50p = drive(torch, finetune_50, "50-shot path, --method gnnnet", argv50p, 2)
        phase_profile(torch, finetune_50, argv50p, steady50p, counts50["edge_abs_diff_matmul"] // EPISODES_50,
                      label="50-shot, --method gnnnet")
        mark("50-shot profile")
        # the faithful eval: the whole backbone on every inner minibatch, strict f32
        faithful = common + ["--bn_mode", "minibatch", "--dtype", "float32", "--inner_param_dtype", "float32"]
        # (its profile is the five-lane faithful batch's below, the same path)
        steady_f = drive(torch, finetune, "faithful 5-shot eval (--bn_mode minibatch, strict f32)", faithful, 2)
        mark("faithful eval")
        # ProtoNet: the GNN member's adaptation, prototype scores; the fused scan, no edge kernel
        kernels.reset_launch_counts()
        drive(torch, finetune, "ProtoNet eval (--method protonet --inner_scan fused)",
              common + ["--method", "protonet", "--save_iter", "400", "--inner_scan", "fused"], 2)
        print(f"ProtoNet eval kernel launches: {kernels.launch_counts()}")
        mark("ProtoNet eval")

        # episode lanes: the JAX driver's default --eval_batch 5, each batch one device batch of LANES episodes
        lane_base = base + ["--n_shot", "5", "--eval_batch", str(LANES)]
        lane_argv = lane_base + ["--inner_scan", "fused"]
        batches = LANE_EPISODES // LANES
        kernels.reset_launch_counts()
        steady_l = drive(torch, finetune, f"lane path (--eval_batch {LANES} --inner_scan fused)", lane_argv,
                         LANE_EPISODES)
        counts_l = kernels.launch_counts()
        print(f"lane path kernel launches: {counts_l} ({batches} batches: the scan once a batch with {LANES} lanes, "
              f"the edge kernel three times a batch on B = {15 * LANES} graphs)")
        if counts_l["fused_inner_scan"] != batches or counts_l["edge_abs_diff_matmul"] != 3 * batches:
            fail(f"the lane path launched {counts_l}, not the scan once and the edge kernel 3 times a batch")
        for row in rows:
            row["launches_lanes"] = counts_l[row["name"]]
        print(f"seconds/episode fused, --eval_batch {LANES} {steady_l:.4f} vs --eval_batch 1 {steady:.4f} (same call): "
              f"{steady / steady_l:.3f} x")
        phase_profile(torch, finetune, lane_argv, steady_l, 3, label=f"{LANES} lanes", episodes=LANES)
        mark("5-shot lane eval and profile")
        # the faithful eval's lanes (one warm batch, one timed), beside its --eval_batch 1 drive above
        faithful_l = lane_base + ["--bn_mode", "minibatch", "--dtype", "float32", "--inner_param_dtype", "float32"]
        kernels.reset_launch_counts()
        steady_fl = drive(torch, finetune, f"faithful lane path (--eval_batch {LANES} --bn_mode minibatch, strict f32)",
                          faithful_l, 2 * LANES)
        counts_fl = kernels.launch_counts()
        print(f"faithful lane batches' kernel launches: {counts_fl} (the edge kernel three times a batch on B = "
              f"{15 * LANES} graphs; the scan never: the minibatch mode refuses it)")
        if counts_fl["edge_abs_diff_matmul"] != 3 * 2 or counts_fl["fused_inner_scan"] != 0:
            fail(f"the faithful lane batches launched {counts_fl}, not the edge kernel 3 times a batch and the scan never")
        for row in rows:
            row["launches_faithful_lanes"] = counts_fl[row["name"]]
        print(f"seconds/episode faithful, --eval_batch {LANES} {steady_fl:.4f} vs --eval_batch 1 {steady_f:.4f} (same "
              f"call): {steady_f / steady_fl:.3f} x")
        phase_profile(torch, finetune, faithful_l, steady_fl, 3, label=f"faithful, {LANES} lanes", scan=False,
                      episodes=LANES)
        mark("faithful lane eval and profile")
        # the engine's knobs, each against its default in this call: --inner_gather and --inner_carry change the
        # linear member's eager loop (the fused scan keeps the GNN member's), --fanout_group_pass the GNN bank's
        # trunk passes; --ensemble_fuse pairs two eager loops, so it is timed on the eager path below
        for flags in (["--inner_gather", "epoch"], ["--inner_carry", "flat"],
                      ["--fanout_group_pass", str(FANOUT_GROUP_PASS)]):
            knob = drive(torch, finetune, f"lane path with {' '.join(flags)} (--eval_batch {LANES} --inner_scan fused)",
                         lane_argv + flags, KNOB_EPISODES)
            print(f"knob {' '.join(flags)}: seconds/episode {knob:.4f} vs the default's {steady_l:.4f} (fused lanes, "
                  f"same call): {knob / steady_l:.3f} x")
        eager_l = drive(torch, finetune, f"lane path (--eval_batch {LANES} --inner_scan eager)",
                        lane_base + ["--inner_scan", "eager"], KNOB_EPISODES)
        print(f"seconds/episode eager, --eval_batch {LANES} {eager_l:.4f} vs --eval_batch 1 {eager:.4f} (same call): "
              f"{eager / eager_l:.3f} x")
        knob = drive(torch, finetune, f"lane path with --ensemble_fuse lane (--eval_batch {LANES} --inner_scan eager)",
                     lane_base + ["--inner_scan", "eager", "--ensemble_fuse", "lane"], KNOB_EPISODES)
        print(f"knob --ensemble_fuse lane: seconds/episode {knob:.4f} vs the default's {eager_l:.4f} (eager lanes, "
              f"same call): {knob / eager_l:.3f} x")
        mark("5-shot eager lanes and the engine's knobs")
        kernels.reset_launch_counts()
        drive(torch, finetune, f"lane path with --freeze_backbone (--eval_batch {LANES})",
              lane_argv + ["--freeze_backbone"], KNOB_EPISODES)
        counts_f = kernels.launch_counts()
        print(f"--freeze_backbone lane batches' kernel launches: {counts_f} (nothing adapts: no scan)")
        if counts_f["fused_inner_scan"] != 0 or counts_f["edge_abs_diff_matmul"] != 3 * (KNOB_EPISODES // LANES):
            fail(f"the frozen lane batches launched {counts_f}, not the edge kernel 3 times a batch and the scan never")
        kernels.reset_launch_counts()
        drive(torch, finetune_50, f"50-shot lane path (finetune_50 --eval_batch {LANES} --inner_scan fused)",
              base + ["--eval_batch", str(LANES), "--inner_scan", "fused"], LANES)
        counts_50l = kernels.launch_counts()
        print(f"50-shot lane batch kernel launches: {counts_50l}")
        for row in rows:
            row["launches_lanes50"] = counts_50l[row["name"]]
            if row["launches_lanes50"] == 0:
                fail(f"kernel {row['name']} was never launched on the 50-shot lane path")
        mark("lane evals: frozen, 50-shot")
        phase_backbone_evals(torch, kernels, finetune, rows, pj)
        phase_interop_and_mesh(torch, finetune, rows, pj, dev)

    # 6. the training path at full width, then one eval episode from the checkpoints it wrote
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as save_dir:
        with open(os.path.join(save_dir, "paths.json"), "w") as f:
            json.dump({"save_dir": save_dir}, f)
        train_counts, stage_counts = phase_training(torch, kernels, save_dir)
        print(f"training path kernel launches (episodic + fine-tune stages): {train_counts}; train_50: "
              f"{stage_counts['train50']}; dampnet_full_class: {stage_counts['dampnet_full_class']}; dampnet: "
              f"{stage_counts['dampnet']}")
        for row in rows:
            row["launches_train"] = train_counts[row["name"]]
            row["launches_train50"] = stage_counts["train50"][row["name"]]
            row["launches_train_fw"] = stage_counts["ResNet10_FW episodic"][row["name"]]
        phase_feature_tools(torch, save_dir)
        mark("save_features and test")
        # the last --dataset / --paths_json wins: the trained checkpoints' directory
        pj_trained = os.path.join(save_dir, "paths.json")
        drive(torch, finetune, "eval from the trained checkpoints", argv + ["--dataset", "synthetic", "--paths_json",
                                                                     pj_trained], 1)
        mark("training stages")
        phase_dampnet_eval(torch, kernels, finetune, rows, pj_trained)
    mark("DampNet eval")

    # 7. the synthetic pipeline's chain, cut short: baseline -> GnnNet -> FO-MAML -> held-out eval
    from mft_tpu_torch.examples import synthetic_pipeline as sp

    _, counts_chain = run_chain(torch, kernels, sp, chain_argv(CHAIN_SHORT), "short chain")
    for row in rows:
        row["launches_pipeline"] = counts_chain[row["name"]]
    mark("synthetic pipeline, short chain")

    for row in rows:
        row["launches_distributed"] = [launches_world1[row["name"]]]  # per rank of the world-1 group
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "launches_train", "ms_train", "plain_ms_train", "bound_ms_train",
             "backward_plain_ms_train", "launches_50", "ms_50", "plain_ms_50", "bound_ms_50", "launches_train50",
             "ms_train50", "bound_ms_train50", "backward_plain_ms_train50", "max_abs_err_50", "launches_dampnet",
             "launches_lanes", "ms_lanes", "plain_ms_lanes", "bound_ms_lanes", "ms_lanes_one", "ms_lanes_cell",
             "bound_ms_lanes_cell", "launches_faithful_lanes", "launches_dampnet_lanes", "launches_lanes50",
             "ms_lanes50", "bound_ms_lanes50", "launches_fw", "ms_fw", "launches_r18", "ms_r18", "launches_r34",
             "ms_r34", "launches_train_fw", "launches_ckpt", "launches_mesh", "launches_pipeline", "ms_pipeline",
             "plain_ms_pipeline", "bound_ms_pipeline", "backward_plain_ms_pipeline", "ms_pipeline_eval",
             "plain_ms_pipeline_eval", "bound_ms_pipeline_eval", "ms_pipeline_scan", "bound_ms_pipeline_scan",
             "launches_distributed"]
    # keys of a path that a kernel off that path (or a number this run does not measure) leaves null
    print(json.dumps({"kernels": [{k: row.get(k) for k in order} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
