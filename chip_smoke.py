"""On-card smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one H100.

Usage (from the root of a checkout, one visible CUDA card)::

    python3 chip_smoke.py [--report PATH]
                          [--phase attention|optimizer|module|bert|lm_f32]

Phases; any failure exits non-zero without the result lines:

1. build  — compile every kernel of ``mxnet_tpu_torch/csrc`` for sm_90a
            (one ``nvcc`` per source, in parallel) into ``build/kernels``;
            a ``flash_fwd.cu``, ``flash_bwd.cu`` or ``flash_f32.cu`` build
            that spills a register fails (the wgmma products of the first
            two read registers asynchronously).
2. kernels — each kernel against its plain PyTorch version on the same
            seeded inputs at the shapes its path gives it:
            flash-attention forward K2f (FWD_CASES, bf16: the serving
            prompts' ends S = 17 and 1500, causal S = 128, 1024, 2048,
            non-causal Sq=256, Skv=1024, the training shape B=4, H=12,
            S=2048, BERT-base's B=8 S=128 non-causal; the same bits from
            two launches; device time beside sdpa's), the f32 flash
            kernels (flash_f32.cu: K2f at F32_CASES, BERT's shape and
            causal S = 1024; K2dq and K2dkv at F32_BWD_CASES, those and
            the two ragged backward shapes; all three at head dim 32 at
            F32_D32_CASES, phase 4c's shape B=4 H=8 S=1024 causal and the
            two ragged shapes; per row at F32_ROW_REL_TOL
            of the row's absolute sum; the same bits twice; device time
            beside sdpa's in f32; the bound at PEAK_F32_3XTF32_FLOPS and,
            under its own name, at PEAK_F32_FLOPS; and the backward's
            fixed and per-64-rows device time from a sweep of the
            streamed length at BERT's grid, F32_SWEEP_TILES, and the
            resident blocks an SM of each kernel at both head dims), paged
            decode
            K4 (PAGED_CASES: B = 1 and 8 at 1, 32 and 128 pages of 16, a
            shuffled table with sentinels past each length, bf16 and int8
            pools; the pool form and the gathered form, the same bits
            twice, device time, the bound from the valid keys' bytes,
            sdpa over the gathered tensors and the old gather + transpose
            route's device time), the flash backward K2dq and K2dkv
            (BWD_CASES: the forward's shapes, the training shape B=4, H=12, S=2048, ragged causal
            S=1000, ragged non-causal Sq=200 Skv=1000 and BERT-base's
            B=8 S=128 non-causal; a second launch must give the same
            bits, and each case logs the two kernels' device time over
            sdpa backward's), the multi-tensor fused Adam step K3 (one
            launch a list: the 9 full-width parameter tensors, wd 0.01,
            t = 1 and 1000, bf16 grads and casts, an f32 grad and cast,
            f16 grads and casts; a mixed list of every grad and cast
            dtype with per-tensor lr_t and wd, 105 elements, a master
            and a grad off the 4-lane alignment; the Module MLP's 18
            shapes; one step over the 9 tensors timed by CUDA events and
            profiler device time beside ``torch.optim.Adam(fused=True)``)
            and the multi-tensor fused SGD step K1 (the 193
            trainable shapes of resnet50_v1 in one launch: momentum 0.9
            with the f32 master as out, with a bf16 out, momentum 0,
            per-tensor lr/wd, and f16 grads with an f16 out), the row
            softmax K5 forward and backward (K5_CASES: [8192, 32000] f32 and bf16, [4096, 1000] bf16,
            [64, 10] f32, [4, 12, 128, 130] f32) and the scale-bias-ReLU
            K6 (K6_CASES: [8192, 3072] f32 and bf16, [64, 500] f32,
            [4096, 1000] f32 and bf16 with NaN and -0.0 planted).  Prints
            each error against its stated
            tolerance, kernel / plain / library ms and the bound; the
            attention backward's library time (sdpa backward) and the
            kernels' are also taken as device time from torch.profiler,
            since ``torch.autograd.grad``'s host path sets a CUDA-event
            span at these sizes.  Tolerances: the
            forward and decode kernels per output row (one (b, h,
            query)): max |kernel - plain| <= ROW_REL_TOL x max |plain| of
            that row; the backward kernels the same per row of dq (b, h,
            query) and of dk, dv (b, h, key), with the row's scale floored
            at BWD_ROW_FLOOR x the tensor's largest |plain|; K3 bitwise on
            the masters, m, v and the casts; K1 bitwise on the
            masters, the momenta and the casts; K5 per row at
            K5_F32_ROW_TOL / K5_BF16_ROW_TOL (y, m and l; the backward
            against the row's largest term); K6 bitwise.
3. serve  — the full-width TransformerLM (TransformerLMConfig defaults:
            vocab 32000, d_model 768, 12 heads, d_ff 3072, 12 layers,
            max_len 2048, bf16; seeded random weights) through
            export_generation -> Server.register(generate=True) -> start:
            16 greedy requests at once (prompts of 17..1500 tokens, 32 new
            tokens each), then a short int8-KV run and a seeded sampled
            run.  Kernel launch counts and telemetry are zeroed just
            before each of the three runs and read just after: every
            prefill layer must have run the flash kernel and every decode
            layer one pool-form paged kernel of the run's page dtype, and
            nothing else.  Each greedy stream is held against the plain
            ``apply()`` with the kernel tier off, teacher-forced.  Then
            ``decode_step`` at 8 slots and 128 pages, DECODE_STEPS
            profiled steps with the pool-form route and with the gathered
            route it replaced: CUDA kernels a step, device and host ms.
4. train  — the full-width TransformerLM trained for TRAIN_STEPS steps
            on one fixed seeded batch (B=4, S=2048: 8192 tokens a step;
            targets are the inputs shifted by one) with Adam (lr 1e-3,
            multi_precision: bf16 weights over f32 masters):
            ``model.loss`` -> ``backward()`` -> one
            ``update_multi_precision`` call over the 9 parameters as lists
            (MXNet's aggregated update).  First, at the initial weights, the gradients
            of the kernel path, the plain path (tier off) and the plain
            path on an f32 copy of the weights: the kernel path's relative
            error against f32 may be at most KERNEL_VS_PLAIN_GRAD_ERR x the
            plain bf16 path's, per tensor.  Then the counted steps: launch
            counts and telemetry zeroed just before and read just after;
            each step must launch exactly 12 flash_fwd, 12 flash_bwd_dq,
            12 flash_bwd_dkv and 1 adam_step (9 ``kernels.fused_step``,
            one a tensor) and nothing else; the loss must be finite at every step and
            lower at the last than at the first.  Prints the median step
            ms over steps 5..20, tokens/s and MFU; then TRAIN_AB_PAIRS
            pairs of TRAIN_AB_STEPS steps with the list update against
            one ``update_multi_precision`` call (one K3 launch) a tensor,
            the order alternating; and the device-idle share of a
            ``torch.profiler`` window over 3 more steps.
4b. bert  — BERT-base pretraining, ``examples/bert_pretrain.py`` at its
            defaults (vocab 30522, 12 layers, d_model 768, 12 heads, d_ff
            3072, B=8, S=128, M=20 masked positions, lr 1e-4, bf16; the
            example's batch from ``np.random.RandomState(0)`` and its
            update ``w - lr * g.astype(w.dtype)``; seeded random
            weights).  The gradient gate at the initial weights (kernel
            path within KERNEL_VS_PLAIN_GRAD_ERR x the plain bf16 path's
            error against an f32 copy, per tensor, floored at
            BERT_GRAD_FLOOR); one warm-up step, then BERT_STEPS counted
            steps: exactly 12 non-causal flash_fwd, flash_bwd_dq and
            flash_bwd_dkv launches a step and nothing else, finite losses
            printed every 5 steps as the example prints them, the last
            below the first; sequences/s, tokens/s, MFU against 989
            TFLOP/s from the model FLOPs (``_bert_flops``) and the
            device-idle share of a profiled window of 3 steps.  Then the
            f32 model (BERT_F32_STEPS steps, exactly 12 flash_fwd_f32,
            flash_bwd_dq_f32 and flash_bwd_dkv_f32 launches a step) and
            the Adam route: ``Adam(multi_precision=True)`` over the 18
            tensors through one list ``update_multi_precision`` a step
            (the f32 ``mlm_bias_v`` its own master), one step bitwise
            against ``fused_adam_step_multi_plain``, then BERT_ADAM_STEPS
            counted steps of exactly one adam_step each.
4c. lm_f32 — ``bench.py`` ``transformer_kernels_config``'s f32 train row:
            TransformerLM at vocab 256, 2 layers, d_model 256, 8 heads of
            32, d_ff 512, max_len 1024, f32, seeded weights; B=4, S=1024
            seeded tokens as inputs and targets (the reference's
            ``loss(tok, tok)``); Adam lr 1e-3, wd 0, over the 9 f32
            weights (each its own master) through one list
            ``update_multi_precision`` a step.  Step-1 gradients of the
            kernel tier on and off from the same weights within
            LM32_GRAD_TOL of each tensor's largest; then LM32_STEPS
            steps with the tier on (exactly 2 flash_fwd_f32,
            flash_bwd_dq_f32 and flash_bwd_dkv_f32 and 1 adam_step a step,
            nothing else; the last loss below the first) and LM32_STEPS
            with it off (no launch), from the same weights; finite losses;
            median step ms, tokens/s and a profiled window of 3 steps a
            route, and the last step's loss delta between the routes.
5. resnet — ResNet-50 v1 (``vision.get_model("resnet50_v1",
            classes=1000)``, 25.6 M parameters in 193 trainable tensors,
            seeded Xavier weights) trained by ``SPMDTrainer`` with SGD
            (lr 0.1, momentum 0.9, wd 1e-4) at BS 128 in bf16 over f32
            masters, on one seeded synthetic batch of 224x224 images that
            stays on the card: ``bench.py`` ``one_config``.  First, at the
            initial weights, the bf16 loss against an f32 copy (within
            RESNET_BF16_LOSS_RTOL) and the per-tensor gradient error.
            After RESNET_WARMUP steps, one step's gradients applied three
            ways to clones: K1 (the trainer's route) must equal its plain
            version bit for bit and the tier-off ``SGD.step`` within
            SGD_ROUTE_TOL.  Then RESNET_STEPS counted steps, launch counts
            zeroed just before and read just after: exactly one sgd_step
            a step and no other kernel of the port; the loss finite at
            every step.  Prints the losses, the median step ms, img/s,
            MFU against 989 TFLOP/s (3 x 4.1 GFLOP an image, bench.py's
            count), peak memory, and the device-idle share of a profiled
            window over 3 more steps; then 5 timed steps each of
            ``conv.internal_layout=NHWC`` (channels_last) and the f32 row.
            Then the same net through SPMDTrainer with Adam (lr 1e-3,
            bf16 over f32 masters): one step's K3 update (one launch over
            the 193 tensors) bitwise against its plain multi version on
            the masters, m and v, and RESNET_ADAM_STEPS counted steps with
            exactly one adam_step a step, finite losses.
            ``torch.backends.cudnn.benchmark`` is on in this phase.
6. tape   — (a) the NDArray autograd tape over the registered kernel
            ops: ``attach_grad`` on seeded f32 logits [8192, 32000],
            ``loss = (mx.nd.pallas_softmax(x) * c).sum()`` under
            ``autograd.record()``, ``loss.backward()``: exactly one
            row_softmax_fwd and one row_softmax_bwd launch, ``x.grad``
            against the plain forward and backward, a second backward
            raises; outside ``record()`` one forward launch only;
            ``pallas_scale_bias_relu`` at [8192, 3072] under ``record()``
            launches one scale_bias_relu and carries no gradient;
            ``pallas_flash_attention`` (B=4 H=12 S=2048 causal bf16)
            launches one flash_fwd, and from backward() one flash_bwd_dq
            and one flash_bwd_dkv.  (b) LeNet-MNIST through
            ``gluon.Trainer`` at ``examples/gluon_mnist.py``'s defaults
            (Xavier, hybridize, SGD lr 0.02 momentum 0.9, kvstore
            "device", SoftmaxCrossEntropyLoss, Accuracy, NDArrayIter
            shuffled over 2048 synthetic digits, batch 64, 2 epochs): every
            loss finite, epoch-2 accuracy at least LENET_REF_ACC -
            LENET_ACC_SLACK, no kernel launch; prints samples/s, the
            median step ms and the device-idle share of a profiled
            window.  (c) MXNet's mixed precision: LeNet with f16
            weights through ``gluon.Trainer`` with ``multi_precision=True``,
            SGD (momentum 0.9) and Adam, F16_STEPS steps each: exactly
            one sgd_step (adam_step) a tensor a step (f16 grad, f16 cast)
            and nothing else, finite losses, each weight the f16 cast of
            its f32 master.
7. symbolic — (a) mx.rtc (K7): one ``CudaModule`` of user kernels
            (RTC_SOURCE) compiled by NVRTC for sm_90a, NVRTC's time; each
            kernel launched through ``CudaKernel.launch`` at RTC_SHAPE
            [8192, 3072] (f32, or bf16 for the bf16 kernels) and at the
            ragged RTC_RAGGED shapes, bitwise against its plain expression
            (the shared-memory row sum within ROWSUM_TOL per row); ms,
            byte bound and library ms at RTC_SHAPE; the host us of one
            ``launch`` call beside a prebuilt kernel's ctypes call; a CPU
            tensor, a CPU ctx, a dtype against the signature, an unknown
            kernel name and source that does not compile must each raise.
            (b) ``add_one`` through ``rtc.register_op``: one launch from
            ``mx.nd``, one and no history under ``autograd.record()``, one
            per ``Executor.forward`` of a ``mx.sym`` graph (op ->
            FullyConnected), whose output equals the graph over
            ``data + 1`` to 0 ulp.  (c) ``bench.py`` ``module_train_config``
            at its own size (MLP 8x128 relu + head 10, SoftmaxOutput,
            batch 64, 64 features, ``Uniform(0.05)``, Adam lr 1e-3)
            through ``Module.train_step``: both routes from the same
            parameters agree after 5 steps (MLP_AGREE_RTOL); then
            MLP_STEPS counted steps a route after 3 warm-up steps, counts
            zeroed just before and read just after: the fused route
            launches exactly one adam_step a step (K3 over the 18 tensors
            with an f32 cast; 18 ``kernels.fused_step``) and no other
            kernel of the port, the eager route none; every loss
            finite; steps/s and samples/s a route, their ratio, the
            device-idle share of a profiled window of fused steps, and
            the fused route's step timed again after that window; and a
            checkpoint saved and loaded on the card gives the same bits.
8. summary — a ``{"kernels": [...]}`` line, the card's name and power
            limit, and as the last line ``{"ok": true, "device": {...}}``.

Numerics: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False, so every f32 product
of the plain versions, of the logits readout and of the f32 ResNet row
is full f32.

``--report PATH`` writes every phase's numbers as JSON (the ResNet phase
under ``"resnet"``).

``--phase attention`` builds the flash sources (bf16 and f32) and the
paged one and runs only the flash forward, paged decode and flash
backward checks of phase 2 (with the f32 tile sweep), and prints their
report as one JSON line: the quick check after a change to an attention
kernel.

``--phase optimizer`` builds K3 and K1 and runs only their checks and
timings of phase 2 (``check_adam``, ``check_sgd``), and prints their
report as one JSON line.

``--phase bert`` builds the two bf16 flash sources, ``flash_f32.cu``
and K3, runs phase 2's flash checks at BERT's shape (bf16) and at
F32_CASES / F32_BWD_CASES (f32), then phase 4b alone, and prints its
report as one JSON line.

``--phase lm_f32`` builds ``flash_f32.cu`` and K3, runs phase 2's f32
flash checks at head dim 32 (F32_D32_CASES), then phase 4c alone, and
prints its report as one JSON line.

``--phase module`` builds the kernels and runs only phase 7(c), in a
process no earlier phase has touched, after two A/Bs of the fused step
(LRT_AB_PAIRS pairs of MLP_STEPS fused steps each, the order
alternating): Adam's ``lr_t`` cache against its reset before every
tensor's update (``lr_t_ab``), and K3's one launch a step against one
launch a tensor (``launch_ab``); and prints the phase's report as one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# H100 SXM float32 outside the tensor cores (elementwise and exp work;
# the FFMA rate of an f32 product there)
PEAK_F32_FLOPS = 67e12
# H100 SXM TF32 tensor cores; an f32-accurate product is three TF32
# products (3xTF32 split operands), so the card computes one at a third
# of the TF32 rate: the bound of the f32 flash kernels
PEAK_TF32_FLOPS = 495e12
PEAK_F32_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# Kernel vs plain version, per output row (one (b, h, query)): bf16 keeps
# 8 significant bits, so one ulp is at most 2^-7 of a value.  The two sides
# round at different points — P to bf16, the P.V sum, the row sum, the
# divide, the output — at most five half-ulp roundings between them,
# 2.5 x 2^-7 < 2^-5 of the row's largest |o|.  The limit scales with each
# row, so it stays below a typical value of what it compares: a kernel that
# drops one 64-key tile of a row over K random keys moves it by about
# sqrt(64 / K) of its size, 0.18 at K = 2048, 5.7x the limit.
ROW_REL_TOL = 2.0 ** -5
# lse is f32 statistics over the same bf16 scores summed in another order.
LSE_ATOL = 1e-3
# The f32 flash kernels (flash_f32.cu) against their plain version, per
# output row: max |kernel - plain| over the row's largest ABSOLUTE SUM,
# the sum of the magnitudes of the terms that make each output (for o:
# sum_k p |v_k| / l, the plain forward over |v|; for dq, dk, dv: |dS| |k|,
# |dS|^T |q| and p^T |dO|, with |dS| = p (|dO v^T| + |delta|) scale).
# The plain version computes in full f32 (allow_tf32 off).  The three
# kernels multiply on the tensor cores as 3xTF32: each operand split into
# two TF32 parts, big and small, and small*big + big*small + big*big
# accumulated in f32.  The
# dropped small*small term and the rounding of small are each at most
# 2^-22 of a product's magnitude, so a sum of split products is within
# 2^-20 of its absolute sum beyond the f32 accumulation's own error.  A
# sum of n f32 terms is within n 2^-24 of its absolute sum (the tensor
# cores round once per 8 products, at most 2^-23 each: (n/8 + 8) 2^-23 is
# less); n <= 1024 keys or queries here, so 2^-14 a side.  A score is a
# D-term sum (D = 32 or 64), off by at most 64 2^-24 + 2^-20 of sum|q k|
# scale, ~2^-15 at these inputs, which p = exp(s - lse) turns into a
# relative error of p of that size; expf adds two ulps.  So the two
# sides differ by under 2 (2^-14 + 2^-15 + 2^-20 + 2^-23) < 2^-12 of the
# absolute sum.  A kernel that drops one key of a 1024-key row moves it
# by ~2^-10 of the absolute sum, 4x the limit.  Single TF32 products
# (10 mantissa bits, 2^-11 relative each), what a split that does not
# happen leaves, move the scores by ~2^-8 and miss it:
# tests/test_torch_flash_f32_split.py
# emulates both on the CPU (3xTF32 ~1e-6, single TF32 1.1-4.5x the
# limit, forward and backward at head dims 64 and 32, at B=1 H=2 S=256
# causal and 64x192).
F32_ROW_REL_TOL = 2.0 ** -12
# Served greedy tokens vs the plain teacher-forced argmax: a mismatch is
# excused only where the plain top-2 logit margin is below this.  On the
# H100 the kernels move the serving path's logits by ~0.03 against the
# plain bf16 path (both sides carry bf16 round-off of the same size; see
# PERF.md), so flips are expected only below that.
LOGIT_MARGIN_TOL = 0.05
# Replaying served streams on an f32 copy of the weights: the kernel
# path's logit error may be at most this multiple of the plain bf16
# path's own error (a faulty kernel shows errors of order 1).
KERNEL_VS_PLAIN_ERR = 2.0

# Backward kernels vs their plain version, per row of dq (one (b, h,
# query)) and of dk, dv (one (b, h, key)).  The kernels round P and dS to
# bf16 as tensor-core operands (2^-9 relative each, where the plain
# version keeps f32) and both sides round the output to bf16 (the two
# results at most one ulp, 2^-7 of a value, apart): about 2^-6 of a
# row's largest value, so ROW_REL_TOL (2^-5) holds with a factor of two.
# A row whose exact value cancels to nothing (the first causal query sees
# one key with p = 1, so dS = dP - delta = 0 up to f32 noise) has no
# scale of its own: its scale is floored at BWD_ROW_FLOOR x the largest
# |plain| of the tensor.  A kernel that skips its last tile moves whole
# rows by an amount of their own size and fails by far.
BWD_ROW_FLOOR = 2.0 ** -6
# Training gradients at the initial weights, per tensor: ||kernel - f32||
# / ||f32|| may be at most this multiple of ||plain - f32|| / ||f32||
# (both bf16 paths round the same weights and activations; a faulty
# backward kernel shows errors of order 1).
KERNEL_VS_PLAIN_GRAD_ERR = 2.0

# Row softmax (K5) against its plain version, per row: max |kernel -
# plain| over the row's largest |plain|, for y and for the saved m and l.
# Both compute in f32 and differ in the order of the row sum and in
# expf's last bit: a few f32 ulps (2^-22 each) of a row's values, so
# 2^-16 holds with room.  In bf16 both round the same f32 values once;
# a sum differing in its last f32 bit can flip one rounding, one bf16 ulp
# (at most 2^-7 of the value).  A kernel that drops one 16-byte chunk of
# a row moves that row's sum by its share and misses by far more.
K5_F32_ROW_TOL = 2.0 ** -16
K5_BF16_ROW_TOL = 2.0 ** -7
# The backward dx = y (dy - dot) cancels where a row saturates (one y
# near 1): its error is stated per row against the row's largest term
# y * (|dy| + |dot|), the size of what is subtracted, at the same
# tolerances; both versions get the kernel's saved m and l.
# Scale-bias-ReLU (K6) is held bitwise: 0 differing elements, a NaN equal
# to any NaN (the two may write different NaN payloads).
SEED = 0
N_REQUESTS = 16
NEW_TOKENS = 32
KV_PAGES = 1024
TRAIN_B = 4
TRAIN_S = 2048
TRAIN_STEPS = 20
# the train phase's A/B of the update routes: pairs x steps a side
TRAIN_AB_PAIRS = 4
TRAIN_AB_STEPS = 5
TRAIN_LR = 1e-3
ADAM_WD = 0.01
SGD_WD = 1e-4
# ResNet-50 v1, bench.py one_config: BS 128, SGD lr 0.1, momentum 0.9,
# wd 1e-4, bf16 compute over f32 masters, one synthetic batch on the card
RESNET_BATCH = 128
RESNET_HW = 224
RESNET_WARMUP = 2
RESNET_STEPS = 20
# the same net through SPMDTrainer with Adam: K3's one launch over 193
# tensors
RESNET_ADAM_LR = 1e-3
RESNET_ADAM_STEPS = 5
# bench.py:59: a train step is ~3x the forward's 4.1 GFLOP per image
RESNET_FLOPS_PER_IMG = 3 * 4.1e9
# The first step's loss, bf16 path vs an f32 copy: both ends read the same
# weights and batch; bf16 keeps 8 significant bits (2^-8 a rounding), and
# 53 conv/BN layers and the 1000-way softmax compound a few roundings in
# the logits; a faulty forward moves the loss by far more.
RESNET_BF16_LOSS_RTOL = 2.0 ** -6
# K1 vs the tier-off SGD.step, per element, relative to the magnitudes of
# the update's terms: each route rounds at most 3 times (2^-24 relative
# to the terms each), so they can differ by 6 x 2^-24; the bound is
# 8 x 2^-24.  A missing or stale tensor differs by O(1).
SGD_ROUTE_TOL = 2.0 ** -21


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(torch, fn, iters=10, warmup=2):
    """Device time of ``fn()``: the CUDA kernel and copy time a
    ``torch.profiler`` window records over ``iters`` calls, divided by the
    call count.  Unlike a CUDA-event span it leaves out the gaps where the
    card waits for the host.  None when the profiler records no CUDA
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / iters if busy_us > 0 else None


def _row_rel_err(o, po, floor=0.0):
    """max over output rows of max|o - po| / max|po| within the row; the
    row's scale floored at ``floor`` x the largest |po| of the tensor."""
    o = o.float().reshape(-1, o.shape[-1])
    po = po.float().reshape(-1, po.shape[-1])
    err = (o - po).abs().amax(dim=-1)
    ref = po.abs().amax(dim=-1)
    ref = ref.clamp_min(max(floor * float(ref.max()), 1e-30))
    return float((err / ref).max())


def _bound_ms(nbytes, flops, peak=None):
    """The least time for ``nbytes`` of memory traffic and ``flops``
    operations at ``peak`` (bf16 tensor cores by default)."""
    t_b = nbytes / PEAK_HBM_BYTES
    t_f = flops / (peak or PEAK_BF16_FLOPS)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------- phase 2
#: (B, H, causal, Sq, Skv, D) of the forward checks, 12 heads of 64: the
#: serving prompts' ends (17 and 1500 tokens), causal S = 128, 1024, 2048,
#: a non-causal Sq=256 x Skv=1024, the training shape B=4 S=2048 and
#: BERT-base's B=8 S=128 (non-causal)
FWD_CASES = tuple((b, 12, c, sq, skv, 64) for b, c, sq, skv in (
    (1, True, 17, 17), (1, True, 128, 128), (1, True, 1024, 1024),
    (1, True, 1500, 1500), (1, True, 2048, 2048), (1, False, 256, 1024),
    (TRAIN_B, True, TRAIN_S, TRAIN_S), (8, False, 128, 128)))
#: (B, H, causal, Sq, Skv, D) of the f32 kernels' checks at head dim 64
#: (flash_f32.cu, forward and backward): BERT-base's shape and a causal
#: S = 1024
F32_CASES = ((8, 12, False, 128, 128, 64), (1, 12, True, 1024, 1024, 64))
#: the f32 backward's checks at head dim 64: F32_CASES and the bf16
#: backward's ragged shapes (BWD_CASES), causal 1000 = 15 x 64 + 40 and
#: non-causal Sq=200 x Skv=1000
F32_BWD_CASES = F32_CASES + ((1, 12, True, 1000, 1000, 64),
                             (1, 12, False, 200, 1000, 64))
#: the f32 kernels' checks at head dim 32, forward and backward: the
#: shape of phase 4c's f32 TransformerLM (B=4, 8 heads of 32, S=1024
#: causal), a ragged causal S=1000 and a non-causal Sq=200 x Skv=1000
F32_D32_CASES = ((4, 8, True, 1024, 1024, 32), (1, 8, True, 1000, 1000, 32),
                 (1, 8, False, 200, 1000, 32))
#: the f32 backward's fixed-cost sweep: at BERT's grid (B=8 H=12, 128
#: rows on the block side) the streamed side is 64 x n rows long
F32_SWEEP_TILES = (1, 2, 4, 8)
_DTYPES = {"bfloat16": ("bf16", 2, PEAK_BF16_FLOPS),
           "float32": ("f32", 4, PEAK_F32_3XTF32_FLOPS)}


def _ffma_bound(case, nbytes, flops):
    """Add the f32 bound at the FFMA rate (PEAK_F32_FLOPS) beside the
    3xTF32 one an f32 case's ``bound_ms`` holds."""
    case["bound_is"] = ("3xTF32: f32-accurate products at 495/3 TFLOP/s "
                        "(PEAK_F32_3XTF32_FLOPS)")
    case["bound_ffma_ms"], case["bound_ffma_by"] = _bound_ms(
        nbytes, flops, PEAK_F32_FLOPS)


def _abs_row_err(torch, o, po, scale):
    """max over output rows of max|o - po| / max(scale) within the row
    (``scale``: the row's absolute sums, F32_ROW_REL_TOL)."""
    err = (o.float() - po.float()).abs().reshape(-1, o.shape[-1]).amax(-1)
    ref = scale.float().reshape(-1, o.shape[-1]).amax(-1).clamp_min(1e-30)
    return float((err / ref).max())


def check_flash(ck, torch, F, cases=FWD_CASES, dtype="bfloat16"):
    """K2f against ``flash_attention_plain`` at ``cases`` in ``dtype``
    (bf16: flash_fwd.cu, per row at ROW_REL_TOL; f32: flash_f32.cu, per
    row at F32_ROW_REL_TOL of the row's absolute sum); a second launch
    must give the same bits.  Times: device time (the profiler) and the
    CUDA-event span of the kernel and of sdpa in the same dtype."""
    out = []
    short, esize, peak = _DTYPES[dtype]
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for B, H, causal, sq, skv, D in cases:
        q = torch.randn(B, H, sq, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, H, skv, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, H, skv, D, generator=g, device="cuda").to(dt)
        o, lse = ck.flash_attention(q, k, v, causal=causal)
        o2, lse2 = ck.flash_attention(q, k, v, causal=causal)
        po, plse = ck.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((o.float() - po.float()).abs().max())
        if dtype == "float32":
            tol = F32_ROW_REL_TOL
            row_err = _abs_row_err(torch, o, po, ck.flash_attention_plain(
                q, k, v.abs(), causal=causal)[0])
        else:
            tol = ROW_REL_TOL
            row_err = _row_rel_err(o, po)
        lse_err = float((lse - plse).abs().max())
        same = _same_bits(torch, o, o2) and bool(torch.equal(lse, lse2))
        ok = (row_err <= tol and lse_err <= LSE_ATOL and same
              and bool(torch.isfinite(o.float()).all()))
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        nbytes = esize * (2 * B * H * sq * D + 2 * B * H * skv * D) \
            + 4 * B * H * sq
        bound, by = _bound_ms(nbytes, 4 * B * H * D * pairs, peak)

        def kernel():
            return ck.flash_attention(q, k, v, causal=causal)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        case = {
            "shape": {"B": B, "H": H, "Sq": sq, "Skv": skv, "D": D,
                      "causal": causal, "dtype": dtype},
            "max_abs_err": err, "plain_max_abs": float(po.abs().max()),
            "max_row_rel_err": row_err,
            "row_rel_tol": tol, "lse_max_abs_err": lse_err,
            "lse_tol": LSE_ATOL, "same_bits_twice": same,
            "ok": ok,
            "ms_is": "device time (torch.profiler); event_ms: CUDA events",
            "ms": _device_ms(torch, kernel, iters=20),
            "event_ms": _time_ms(kernel),
            "plain_ms": _time_ms(lambda: ck.flash_attention_plain(
                q, k, v, causal=causal), iters=5, warmup=1),
            "library_ms": _device_ms(torch, sdpa, iters=20),
            "library_event_ms": _time_ms(sdpa),
            "library_computes": "scaled_dot_product_attention (device "
                                "time; no lse)",
            "bound_ms": bound, "bound_by": by}
        if short == "f32":
            _ffma_bound(case, nbytes, 4 * B * H * D * pairs)
        if case["ms"]:
            case["bound_share"] = bound / case["ms"]
            case["vs_library"] = (case["ms"] / case["library_ms"]
                                  if case["library_ms"] else None)
        _log("[kernels] flash_fwd%s %s" % ("" if short == "bf16" else "_"
                                           + short, json.dumps(case)))
        out.append(case)
    return out


#: (B, width in pages) of the paged decode checks: one and eight decode
#: slots at widths of 1, 32 and 128 pages of PAGE_SIZE (the serving
#: widths' ends and middle)
PAGED_CASES = ((1, 1), (1, 32), (1, 128), (8, 1), (8, 32), (8, 128))
PAGE_SIZE = 16


def _pool_inputs(torch, quant, B, W, g):
    """A KV_PAGES-page pool of one layer ([pool, 16, 12, 64]), a shuffled
    page table whose entries past each sequence's length are the
    sentinel (the pool size), and ragged lengths (one full width, one
    single position when B > 1)."""
    from mxnet_tpu_torch.quantization import quantize_rows
    H, D, P = 12, 64, KV_PAGES
    kp = torch.randn(P, PAGE_SIZE, H, D, generator=g, device="cuda")
    vp = torch.randn(P, PAGE_SIZE, H, D, generator=g, device="cuda")
    q = torch.randn(B, H, 1, D, generator=g, device="cuda").bfloat16()
    perm = torch.randperm(P, generator=g, device="cuda")[:B * W]
    perm = perm.reshape(B, W).int()
    lens = torch.randint(1, W * PAGE_SIZE + 1, (B,), generator=g,
                         device="cuda").int()
    lens[0] = W * PAGE_SIZE
    if B > 1:
        lens[-1] = 1
    first = torch.arange(W, device="cuda")[None, :] * PAGE_SIZE
    table = torch.where(first < lens[:, None], perm,
                        torch.full_like(perm, P))
    if quant:
        kq, ks = quantize_rows(kp)
        vq, vs = quantize_rows(vp)
        return q, kq, vq, table, lens, {"k_scale_pool": ks,
                                        "v_scale_pool": vs}
    return q, kp.bfloat16(), vp.bfloat16(), table, lens, {}


def check_paged(ck, torch, F, quant):
    """K4 at PAGED_CASES, pool form (the decode path's entry) and gathered
    form (``paged_attention``, the reference-shaped entry, over the same
    context gathered): each against ``paged_attention_pool_plain`` per
    row, a second launch giving the same bits.  Times: device time of the
    pool form, of the gathered form alone, of the route before this
    kernel read the pool (gather + transpose of K, V (and scales) +
    the gathered form), and of sdpa over the gathered tensors (bf16);
    the bound counts the bytes of the valid keys."""
    cases = []
    H, D = 12, 64
    g = torch.Generator(device="cuda").manual_seed(SEED + 1 + int(quant))
    for B, W in PAGED_CASES:
        q, kp, vp, table, lens, kw = _pool_inputs(torch, quant, B, W, g)
        K = W * PAGE_SIZE

        def pool_form():
            return ck.paged_attention_pool(q, kp, vp, table, lens, **kw)

        def gathered_inputs():
            kc, vc = ck.gather_pages(kp, table), ck.gather_pages(vp, table)
            gkw = {}
            if quant:
                gkw = {"k_scale": ck.gather_pages(kw["k_scale_pool"], table),
                       "v_scale": ck.gather_pages(kw["v_scale_pool"], table)}
            return kc, vc, gkw

        valid = torch.arange(K, device="cuda")[None, :] < lens[:, None]

        def old_route():
            kc, vc, gkw = gathered_inputs()
            return ck.paged_attention(q, kc, vc, valid, **gkw)

        o, o2 = pool_form(), pool_form()
        po = ck.paged_attention_pool_plain(q, kp, vp, table, lens, **kw)
        kc, vc, gkw = gathered_inputs()
        og, og2 = (ck.paged_attention(q, kc, vc, valid, **gkw)
                   for _ in range(2))
        torch.cuda.synchronize()
        row_err = _row_rel_err(o, po)
        g_err = _row_rel_err(og, po)
        same = _same_bits(torch, o, o2)
        g_same = _same_bits(torch, og, og2)
        ok = (row_err <= ROW_REL_TOL and g_err <= ROW_REL_TOL and same
              and g_same and bool(torch.isfinite(o.float()).all()))
        n_valid = int(lens.sum()) * H
        elem = 1 if quant else 2
        nbytes = (n_valid * D * 2 * elem + (n_valid * 2 * 4 if quant else 0)
                  + 2 * 2 * B * H * D + 4 * B * W + 4 * B)
        bound, by = _bound_ms(nbytes, 4 * D * n_valid)
        per, splits = ck.paged_splits(B * H, K)
        case = {
            "shape": {"B": B, "H": H, "pages": W, "page_size": PAGE_SIZE,
                      "K": K, "D": D, "lengths": [int(x) for x in
                                                  lens.tolist()],
                      "kv": "int8" if quant else "bfloat16",
                      "splits": splits, "keys_per_split": per},
            "max_abs_err": float((o.float() - po.float()).abs().max()),
            "max_row_rel_err": row_err, "row_rel_tol": ROW_REL_TOL,
            "same_bits_twice": same, "ok": ok,
            "ms_is": "device time (torch.profiler); event_ms: CUDA events "
                     "over back-to-back calls (the wrapper's host time at "
                     "these sizes)",
            "ms": _device_ms(torch, pool_form, iters=50),
            "event_ms": _time_ms(pool_form, iters=50),
            "plain_ms": _time_ms(lambda: ck.paged_attention_pool_plain(
                q, kp, vp, table, lens, **kw), iters=20),
            "gathered": {
                "max_row_rel_err": g_err, "same_bits_twice": g_same,
                "ms": _device_ms(torch, lambda: ck.paged_attention(
                    q, kc, vc, valid, **gkw), iters=50),
                "old_route_ms": _device_ms(torch, old_route, iters=50),
                "old_route_is": "gather + transpose of K, V%s, then the "
                                "gathered kernel (device time)"
                                % (" and scales" if quant else "")},
            "library_ms": None if quant else _device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=valid[:, None, None, :]), iters=50),
            "library_computes": "none for int8 pages" if quant else
                                "scaled_dot_product_attention over the "
                                "gathered tensors, bool mask (device time)",
            "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes}
        if case["ms"]:
            case["bound_share"] = bound / case["ms"]
        _log("[kernels] paged_decode_pool_%s %s" % (
            "int8" if quant else "bf16", json.dumps(case)))
        cases.append(case)
        del q, kp, vp, kc, vc, gkw, kw
        torch.cuda.empty_cache()
    return cases


def _sdpa_bwd_ms(torch, F, q, k, v, do, causal):
    """The library yardstick: scaled_dot_product_attention's backward
    (dq, dk and dv in one call) at the same inputs, as
    ``(device ms, CUDA-event ms)``.  The call goes through
    ``torch.autograd.grad``, whose host path (about 0.5 ms) sets a
    CUDA-event span at these sizes; the device time is the yardstick."""
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)

    def bwd():
        return torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)
    return _device_ms(torch, bwd), _time_ms(bwd)


#: (B, H, causal, Sq, Skv, D) of the backward checks, 12 heads of 64: the
#: forward's shapes, the training shape, ragged causal and non-causal
#: tiles, and BERT-base's shape (B=8, S=128, no mask)
BWD_CASES = tuple((b, 12, c, sq, skv, 64) for b, c, sq, skv in (
    (1, True, 128, 128), (1, True, 1024, 1024), (1, True, 2048, 2048),
    (1, False, 256, 1024), (TRAIN_B, True, TRAIN_S, TRAIN_S),
    (1, True, 1000, 1000), (1, False, 200, 1000), (8, False, 128, 128)))


def _same_bits(torch, x, y):
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    return bool(torch.equal(x.view(bits), y.view(bits)))


def _bwd_abs_sums(torch, q, k, v, do, lse, delta, causal):
    """The absolute sums F32_ROW_REL_TOL scales the backward by: |dS| |k|
    (dq), |dS|^T |q| (dk) and p^T |dO| (dv), with p and
    |dS| = p (|dO v^T| + |delta|) scale as the plain backward forms them."""
    B, H, S, D = q.shape
    scale = 1.0 / D ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(S, k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dp = torch.matmul(dof, vf.transpose(-1, -2)).abs()
    dsa = p * (dp + delta.reshape(B, H, S, 1).abs()) * scale
    return (torch.matmul(dsa, kf.abs()),
            torch.matmul(dsa.transpose(-1, -2), qf.abs()),
            torch.matmul(p.transpose(-1, -2), dof.abs()))


def check_flash_bwd(ck, torch, F, cases=BWD_CASES, dtype="bfloat16"):
    """K2dq and K2dkv against ``flash_attention_bwd_plain`` (same o, lse,
    delta, dO) at ``cases`` in ``dtype`` (bf16: flash_bwd.cu at
    ROW_REL_TOL with the BWD_ROW_FLOOR floor; f32: flash_f32.cu at
    F32_ROW_REL_TOL of each row's absolute sum); a second launch on the
    same inputs must give the same bits.  Each case logs the kernels'
    combined device time over sdpa backward's (same dtype).  Returns (dq
    cases, dkv cases)."""
    dq_cases, dkv_cases = [], []
    short, esize, peak = _DTYPES[dtype]
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for B, H, causal, sq, skv, D in cases:
        q, do = (torch.randn(B, H, sq, D, generator=g,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn(B, H, skv, D, generator=g,
                            device="cuda").to(dt) for _ in range(2))
        o, lse = ck.flash_attention(q, k, v, causal=causal)
        delta = ck.flash_delta(o, do)
        dq, dk, dv = ck.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, delta=delta)
        pdq, pdk, pdv = ck.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, delta=delta)
        args = (q, k, v, do, lse, delta, causal, None)
        again = (ck._launch_bwd_dq(*args),) + ck._launch_bwd_dkv(*args)
        torch.cuda.synchronize()
        shape = {"B": B, "H": H, "Sq": sq, "Skv": skv, "D": D,
                 "causal": causal, "dtype": dtype}
        pairs = B * H * (sq * (sq + 1) // 2 if causal else sq * skv)
        qbytes = esize * B * H * sq * D
        kvbytes = esize * B * H * skv * D
        if dtype == "float32":
            tol = F32_ROW_REL_TOL
            sums = _bwd_abs_sums(torch, q, k, v, do, lse, delta, causal)
        else:
            tol, sums = ROW_REL_TOL, None
        plain_ms = _time_ms(lambda: ck.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, delta=delta), iters=5,
            warmup=1)
        lib_ms, lib_event_ms = _sdpa_bwd_ms(torch, F, q, k, v, do, causal)
        pair = []
        suffix = "" if short == "bf16" else "_" + short
        for name, outs, plain, reruns, launch, nbytes, products, which, \
                found in (
                ("flash_bwd_dq" + suffix, (dq,), (pdq,), again[:1],
                 ck._launch_bwd_dq, 3 * qbytes + 2 * kvbytes + 8 * B * H * sq,
                 3, (0,), dq_cases),
                ("flash_bwd_dkv" + suffix, (dk, dv), (pdk, pdv), again[1:],
                 ck._launch_bwd_dkv,
                 2 * qbytes + 4 * kvbytes + 8 * B * H * sq, 4, (1, 2),
                 dkv_cases)):
            if sums is None:
                row_err = max(_row_rel_err(x, px, BWD_ROW_FLOOR)
                              for x, px in zip(outs, plain))
            else:
                row_err = max(_abs_row_err(torch, x, px, sums[i])
                              for x, px, i in zip(outs, plain, which))
            err = max(float((x.float() - px.float()).abs().max())
                      for x, px in zip(outs, plain))
            same = all(_same_bits(torch, x, y) for x, y in zip(outs, reruns))
            ok = (row_err <= tol and same and all(
                bool(torch.isfinite(x.float()).all()) for x in outs))
            flops = products * 2 * D * pairs
            bound, by = _bound_ms(nbytes, flops, peak)
            case = {"shape": shape, "max_abs_err": err,
                    "plain_max_abs": max(float(px.abs().max())
                                         for px in plain),
                    "max_row_rel_err": row_err, "row_rel_tol": tol,
                    "row_floor": BWD_ROW_FLOOR if sums is None else
                    "absolute sum", "same_bits_twice": same,
                    "ok": ok,
                    "ms": _time_ms(lambda: launch(*args)),
                    "device_ms": _device_ms(torch, lambda: launch(*args)),
                    "plain_ms": plain_ms, "plain_computes": "dq, dk, dv",
                    "library_ms": lib_ms, "library_event_ms": lib_event_ms,
                    "library_computes": "dq, dk, dv (sdpa backward; "
                                        "device time)",
                    "bound_ms": bound, "bound_by": by}
            if short == "f32":
                _ffma_bound(case, nbytes, flops)
            case["bound_share"] = (bound / case["device_ms"]
                                   if case["device_ms"] else None)
            _log("[kernels] %s %s" % (name, json.dumps(case)))
            found.append(case)
            pair.append(case)
        if pair[0]["device_ms"] and pair[1]["device_ms"] and lib_ms:
            both = pair[0]["device_ms"] + pair[1]["device_ms"]
            for case in pair:
                case["pair_vs_library"] = both / lib_ms
            _log("[kernels] flash backward at %s, device time: K2dq %.4f + "
                 "K2dkv %.4f = %.4f ms, sdpa backward %.4f ms (ratio %.3f)"
                 % (json.dumps(shape), pair[0]["device_ms"],
                    pair[1]["device_ms"], both, lib_ms, both / lib_ms))
    return dq_cases, dkv_cases


def sweep_flash_bwd_f32(ck, torch):
    """The f32 backward's fixed cost (launch, prologue, epilogue) and its
    cost per 64 streamed rows, by device time: at BERT's grid (B=8, H=12,
    128 rows on the block side, no mask) each kernel walks n x 64 rows of
    the streamed side (K2dq: Skv, K2dkv: Sq) for n in F32_SWEEP_TILES, and
    a least-squares line over n gives ``fixed_ms + per_64_rows_ms x n``;
    with each f32 kernel's resident blocks an SM at head dims 32 and 64
    (the occupancy API)."""
    from mxnet_tpu_torch.ops import _build
    B, H, S, D = BERT_B, 12, BERT_S, 64
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    out = {"shape": {"B": B, "H": H, "block_side": S, "D": D,
                     "causal": False, "dtype": "float32"},
           "rows_over_64": list(F32_SWEEP_TILES)}
    for name, launch in (("flash_bwd_dq_f32", ck._launch_bwd_dq),
                         ("flash_bwd_dkv_f32", ck._launch_bwd_dkv)):
        times = []
        for n in F32_SWEEP_TILES:
            sq, skv = (S, 64 * n) if name == "flash_bwd_dq_f32" \
                else (64 * n, S)
            q, do = (torch.randn(B, H, sq, D, generator=g, device="cuda")
                     for _ in range(2))
            k, v = (torch.randn(B, H, skv, D, generator=g, device="cuda")
                    for _ in range(2))
            o, lse = ck.flash_attention(q, k, v)
            args = (q, k, v, do, lse, ck.flash_delta(o, do), False, None)
            times.append(_device_ms(torch, lambda: launch(*args), iters=20))
        xs = list(F32_SWEEP_TILES)
        mx_, my = sum(xs) / len(xs), sum(times) / len(times)
        slope = (sum((x - mx_) * (y - my) for x, y in zip(xs, times))
                 / sum((x - mx_) ** 2 for x in xs))
        out[name] = {"device_ms": times, "per_64_rows_ms": slope,
                     "fixed_ms": my - slope * mx_}
    lib = _build.load("flash_f32", ck._SIGNATURES["flash_f32"])
    out["blocks_per_sm"] = {
        "%s_d%d" % (name, d): lib.mx_flash_f32_blocks_per_sm(i, d)
        for d in ck.FLASH_HEAD_DIMS[torch.float32]
        for i, name in enumerate(("flash_fwd_f32", "flash_bwd_dq_f32",
                                  "flash_bwd_dkv_f32"))}
    _log("[kernels] flash_bwd_f32 tile sweep %s" % json.dumps(out))
    return out


def _adam_shapes(cfg):
    """The 9 parameter tensors of the full-width TransformerLM."""
    L, D, H, Dh, F, V = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                         cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    return {"embed": (V, D), "pos_embed": (cfg.max_len, D),
            "final_norm": (D,), "ln1": (L, D), "wqkv": (L, D, 3, H, Dh),
            "wo": (L, H, Dh, D), "ln2": (L, D), "w1": (L, D, F),
            "w2": (L, F, D)}


def _mlp_shapes():
    """The 18 parameter shapes of the Module MLP (phase 7(c))."""
    shapes, width = [], MLP_FEAT
    for _ in range(MLP_LAYERS):
        shapes += [(MLP_WIDTH, width), (MLP_WIDTH,)]
        width = MLP_WIDTH
    return shapes + [(MLP_CLASSES, MLP_WIDTH), (MLP_CLASSES,)]


def _placed(torch, x, offset):
    """A copy of ``x`` that starts ``offset`` elements into a buffer of
    its own (offset 1 leaves it off the 4-lane alignment)."""
    buf = torch.empty(offset + x.numel(), dtype=x.dtype, device=x.device)
    y = buf[offset:].view(x.shape)
    y.copy_(x)
    return y


def _adam_list_case(ck, torch, label, ws, gs, ms, vs, lr_ts, wds, casts,
                    offsets=None):
    """K3's one launch over the list against ``fused_adam_step_multi_plain``
    on copies of the same inputs (each copy at the offset the case gives
    it), bitwise on the masters, m, v and the casts."""
    offsets = offsets or [0] * len(ws)
    sides = []
    for fn in (ck.fused_adam_step_multi, ck.fused_adam_step_multi_plain):
        w, m, v = ([_placed(torch, x, o) for x, o in zip(xs, offsets)]
                   for xs in (ws, ms, vs))
        out = [torch.empty_like(x, dtype=c) if c is not None else None
               for x, c in zip(ws, casts)]
        before = ck.LAUNCHES["adam_step"]
        fn(w, gs, m, v, lr_ts, wds, 0.9, 0.999, 1e-8, outs=out)
        sides.append((w, m, v, out, ck.LAUNCHES["adam_step"] - before))
    torch.cuda.synchronize()
    (kw, km, kv, ko, launches), (pw, pm, pv, po, plain_launches) = sides
    pairs = {"master": list(zip(kw, pw)), "m": list(zip(km, pm)),
             "v": list(zip(kv, pv)),
             "cast": [(a, b) for a, b in zip(ko, po) if a is not None]}
    diff = {k: sum(_differing(torch, x, y) for x, y in p)
            for k, p in pairs.items()}
    err = max(float((x.float() - y.float()).abs().max())
              for p in pairs.values() for x, y in p)
    case = {"case": label, "tensors": len(ws),
            "params": sum(w.numel() for w in ws), "launches": launches,
            "differing_elements": diff, "max_abs_err": err,
            "ok": sum(diff.values()) == 0 and launches == 1
            and plain_launches == 0}
    _log("[kernels] adam_step %s" % json.dumps(case))
    return case


def check_adam(ck, torch):
    """K3 (one launch over a list) against ``fused_adam_step_multi_plain``,
    bitwise on the masters, m, v and the casts: the 9 full-width
    TransformerLM tensors at t = 1 and t = 1000 with bf16 grads and casts,
    at t = 1000 with f32 grads and the f32 cast (the master itself) and
    with f16 grads and casts; a mixed list (every grad and cast dtype,
    per-tensor lr_t and wd, an element count that is not a multiple of 4,
    a master and a grad off the 4-lane alignment, which take the scalar
    loop); and the Module MLP's 18 shapes with f32 grads and the f32
    cast.  Then one step over the 9 tensors (bf16 grads and casts) by
    CUDA events and profiler device time against the plain version,
    ``torch.optim.Adam(fused=True)`` and the byte bound.  Returns (cases,
    per-step timing)."""
    from mxnet_tpu_torch.models.transformer import TransformerLMConfig
    from mxnet_tpu_torch.optimizer.optimizer import _bias_corrected_lr
    shapes = list(_adam_shapes(TransformerLMConfig()).values())
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    b1, b2, eps = 0.9, 0.999, 1e-8
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32

    def lr_t(t, lr=TRAIN_LR):
        return float(_bias_corrected_lr(lr, b1, b2, t))

    def inputs(shapes, grad_dtypes):
        ws = [torch.randn(sh, generator=g, device="cuda") * 0.02
              for sh in shapes]
        gs = [torch.randn(sh, generator=g, device="cuda").to(dt)
              for sh, dt in zip(shapes, grad_dtypes)]
        ms = [torch.randn(sh, generator=g, device="cuda") * 1e-3
              for sh in shapes]
        vs = [torch.rand(sh, generator=g, device="cuda") * 1e-6
              for sh in shapes]
        return ws, gs, ms, vs

    n = len(shapes)
    ws, gs, ms, vs = inputs(shapes, [bf16] * n)
    cases = []
    # the bf16 cast of the training path, the f32 "cast" (the master
    # itself, written once) with an f32 grad of the symbolic Module's
    # fused step, and MXNet's f16 multi_precision update
    for t, cast, gdt in ((1, bf16, bf16), (1000, bf16, bf16),
                         (1000, None, f32), (1000, f16, f16)):
        cases.append(_adam_list_case(
            ck, torch, "TransformerLM 9 tensors, t=%d, %s grads, %s cast"
            % (t, str(gdt)[6:], str(cast or f32)[6:]),
            ws, [x.to(gdt) for x in gs], ms, vs, [lr_t(t)] * n,
            [ADAM_WD] * n, [cast] * n))
    mixed = [(1000, 768), (3, 5, 7), (4099,), (2048, 100), (777, 33), (768,)]
    mw, mg, mm, mv = inputs(mixed, [bf16, f16, f32, bf16, f16, f32])
    mg[4] = _placed(torch, mg[4], 1)   # a 2-byte grad 2 bytes off
    cases.append(_adam_list_case(
        ck, torch, "mixed: grads bf16/f16/f32, casts bf16/f16/f32, "
        "per-tensor lr_t and wd, 105 elements, a master and a grad off "
        "alignment", mw, mg, mm, mv,
        [lr_t(1), lr_t(10, 5e-4), lr_t(1000), lr_t(3), lr_t(1000, 5e-4),
         lr_t(2)], [ADAM_WD, 0.0, ADAM_WD, 0.0, 1e-4, ADAM_WD],
        [bf16, f16, None, f16, bf16, bf16], offsets=[0, 0, 0, 1, 0, 0]))
    mlp = _mlp_shapes()
    pw, pg, pm, pv = inputs(mlp, [f32] * len(mlp))
    cases.append(_adam_list_case(
        ck, torch, "Module MLP 18 tensors, f32 grads, f32 cast", pw, pg, pm,
        pv, [lr_t(5, MLP_LR)] * len(mlp), [0.0] * len(mlp),
        [None] * len(mlp)))
    del mw, mg, mm, mv, pw, pg, pm, pv
    # one step over the 9 tensors, in place as on the training path
    lr_ts, wds = [lr_t(1000)] * n, [ADAM_WD] * n
    lps = [torch.empty_like(w, dtype=bf16) for w in ws]
    table = ck.LaunchTable()

    def call():
        ck.fused_adam_step_multi(ws, gs, ms, vs, lr_ts, wds, b1, b2, eps,
                                 outs=lps, table=table)
    call()
    dev, blocks = table.fill(ck.ADAM_LAYOUT, (ws, ms, vs, lps), gs, lr_ts,
                             wds)

    def launch():
        ck._launch_adam(dev, n, blocks, b1, b2, eps, ws[0])
    kernel_ms = _time_ms(launch)
    device_ms = _device_ms(torch, launch)
    call_ms = _time_ms(call)
    plain_ms = _time_ms(lambda: ck.fused_adam_step_multi_plain(
        ws, gs, ms, vs, lr_ts, wds, b1, b2, eps, outs=lps), iters=3,
        warmup=1)
    params = sum(w.numel() for w in ws)
    nbytes = params * (4 + 2 + 4 + 4 + 4 + 4 + 4 + 2)
    masters = [w.clone().requires_grad_(True) for w in ws]
    for p, gr in zip(masters, gs):
        p.grad = gr.float()
    lib = torch.optim.Adam(masters, lr=TRAIN_LR, betas=(b1, b2), eps=eps,
                           weight_decay=ADAM_WD, fused=True)
    lib_ms = _time_ms(lib.step)
    lib_device_ms = _device_ms(torch, lib.step)
    del masters, lib
    bound, by = _bound_ms(nbytes, 0)
    step = {"at": {"tensors": n, "params": params, "grad": "bfloat16",
                   "cast": "bfloat16", "blocks": blocks},
            "ms": kernel_ms, "ms_is": "K3's one launch alone, table filled "
            "(CUDA events)", "device_ms": device_ms,
            "call_ms": call_ms,
            "call_is": "fused_adam_step_multi: checks, table fill and copy, "
                       "launch (CUDA events)",
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_device_ms,
            "library_computes": "torch.optim.Adam(fused=True) over the same "
                                "f32 masters, f32 grads, no bf16 copy",
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "bound_share": bound / (device_ms or kernel_ms),
            "vs_library": (device_ms or kernel_ms)
            / (lib_device_ms or lib_ms)}
    _log("[kernels] adam_step per step %s" % json.dumps(step))
    return cases, step


def _resnet_shapes(mx, np):
    """The 193 trainable shapes of the port's resnet50_v1, read from the
    model after shape inference (one forward on the CPU)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Zero(), ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mx.cpu()))
    return [p.shape for p in net.collect_params().values()
            if p.grad_req != "null"]


def _differing(torch, x, y):
    """How many elements of x and y differ in their bits."""
    as_int = torch.int16 if x.element_size() == 2 else torch.int32
    return int((x.view(as_int) != y.view(as_int)).sum())


def check_sgd(ck, torch, mx, np):
    """K1 against ``fused_sgd_step_multi_plain`` over the 193 trainable
    tensors of resnet50_v1, one launch each case, bitwise on the masters,
    the momenta and the casts: momentum 0.9 with the f32 master as the
    out (the trainer's route), momentum 0.9 with a bf16 out, momentum 0,
    and per-tensor lr and wd that differ.  Then one step over the list
    against the plain version and ``torch.optim.SGD``.  Returns (cases,
    per-step timing)."""
    shapes = _resnet_shapes(mx, np)
    n = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ws = [torch.randn(sh, generator=g, device="cuda") * 0.05 for sh in shapes]
    gs = [torch.randn(sh, generator=g, device="cuda") for sh in shapes]
    ms = [torch.randn(sh, generator=g, device="cuda") * 0.1 for sh in shapes]
    flat = [0.1] * n, [SGD_WD] * n
    varied = ([0.1 * (1 + i % 3) / 2 for i in range(n)],
              [SGD_WD if i % 2 == 0 else 0.0 for i in range(n)])
    cases = []
    gs16 = [x.half() for x in gs]
    for label, mom, (lrs, wds), cast, grads in (
            ("momentum 0.9, f32 out (the master)", 0.9, flat, None, gs),
            ("momentum 0.9, bf16 out", 0.9, flat, torch.bfloat16, gs),
            ("momentum 0", 0.0, flat, None, gs),
            ("momentum 0.9, per-tensor lr and wd", 0.9, varied, None, gs),
            ("momentum 0.9, f16 grads, f16 out (multi_precision)", 0.9,
             flat, torch.float16, gs16)):
        kw, pw = ([w.clone() for w in ws] for _ in range(2))
        km, pm = ([m.clone() if mom else None for m in ms]
                  for _ in range(2))
        ko, po = ([torch.empty_like(w, dtype=cast) if cast else None
                   for w in ws] for _ in range(2))
        ck.fused_sgd_step_multi(kw, grads, km, lrs, wds, mom, outs=ko)
        ck.fused_sgd_step_multi_plain(pw, grads, pm, lrs, wds, mom, outs=po)
        torch.cuda.synchronize()
        pairs = {"master": list(zip(kw, pw))}
        if mom:
            pairs["momentum"] = list(zip(km, pm))
        if cast:
            pairs["%s_out" % str(cast)[len("torch."):]] = list(zip(ko, po))
        diff = {k: sum(_differing(torch, x, y) for x, y in v)
                for k, v in pairs.items()}
        err = max(float((x.float() - y.float()).abs().max())
                  for v in pairs.values() for x, y in v)
        case = {"case": label, "tensors": n, "differing_elements": diff,
                "max_abs_err": err, "ok": sum(diff.values()) == 0}
        _log("[kernels] sgd_step %s" % json.dumps(case))
        cases.append(case)
    del gs16
    # one step over the 193 tensors in place, as on the training path
    lrs, wds = flat
    table = ck.LaunchTable()
    ck.fused_sgd_step_multi(ws, gs, ms, lrs, wds, 0.9, table=table)
    dev, blocks = table.fill(ck.SGD_LAYOUT, (ws, ms, [None] * n), gs, lrs,
                             wds)
    kernel_ms = _time_ms(lambda: ck._launch_sgd(dev, n, blocks, 0.9, ws[0]))
    call_ms = _time_ms(lambda: ck.fused_sgd_step_multi(
        ws, gs, ms, lrs, wds, 0.9, table=table))
    device_ms = _device_ms(torch, lambda: ck.fused_sgd_step_multi(
        ws, gs, ms, lrs, wds, 0.9, table=table))
    plain_ms = _time_ms(lambda: ck.fused_sgd_step_multi_plain(
        ws, gs, ms, lrs, wds, 0.9), iters=3, warmup=1)
    params = sum(w.numel() for w in ws)
    nbytes = params * (4 + 4 + 4 + 4 + 4)   # read w, g, m; write w, m
    masters = [w.clone().requires_grad_(True) for w in ws]
    for p, gr in zip(masters, gs):
        p.grad = gr.clone()
    try:
        lib = torch.optim.SGD(masters, lr=0.1, momentum=0.9,
                              weight_decay=SGD_WD, fused=True)
        lib_kind = "fused=True"
    except (TypeError, RuntimeError, ValueError):
        lib = torch.optim.SGD(masters, lr=0.1, momentum=0.9,
                              weight_decay=SGD_WD, foreach=True)
        lib_kind = "foreach=True (this PyTorch has no fused SGD)"
    lib.step()   # makes the momentum buffers
    lib_ms = _time_ms(lib.step)
    lib_device_ms = _device_ms(torch, lib.step)
    bound, by = _bound_ms(nbytes, 0)
    step = {"at": {"tensors": n, "params": params, "grad": "float32",
                   "momentum": 0.9, "out": "the f32 master"},
            "ms": kernel_ms, "ms_is": "K1 launches alone, table filled",
            "call_ms": call_ms, "device_ms": device_ms,
            "call_is": "fused_sgd_step_multi: checks, table fill and copy, "
                       "launch (CUDA events; device_ms from the profiler)",
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_device_ms,
            "library_computes": "torch.optim.SGD(%s) over the same 193 f32 "
                                "tensors: the same update with lr applied "
                                "after the momentum (PyTorch's convention), "
                                "the same bytes" % lib_kind,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes}
    _log("[kernels] sgd_step per step %s" % json.dumps(step))
    return cases, step


def _term_rel_err(torch, dx, pdx, y, dy):
    """Per row: max |dx - pdx| over the row's largest term
    y * (|dy| + |sum(dy * y)|) (see K5_F32_ROW_TOL)."""
    yf = y.float().reshape(-1, y.shape[-1])
    dyf = dy.float().reshape(yf.shape)
    dot = (dyf * yf).sum(-1, keepdim=True)
    terms = (yf * (dyf.abs() + dot.abs())).amax(-1).clamp_min(1e-30)
    err = (dx.float() - pdx.float()).reshape(yf.shape).abs().amax(-1)
    return float((err / terms).max())


# K5's shapes: the TransformerLM readout (B*S = 4*2048 rows over the
# 32,000-word vocab, the reference docstring's case) in f32 and bf16,
# ImageNet's 1000 classes (a ragged width) in bf16, LeNet's logits, and
# attention scores of a leading-dims tensor at an unaligned width.
K5_CASES = (((8192, 32000), "float32"), ((8192, 32000), "bfloat16"),
            ((4096, 1000), "bfloat16"), ((64, 10), "float32"),
            ((4, 12, 128, 130), "float32"))


def check_row_softmax(ck, torch):
    """K5 forward and backward against ``row_softmax_plain`` /
    ``row_softmax_bwd_plain`` at K5_CASES (x = randn * 4, dy = randn).
    Returns (forward cases, backward cases)."""
    fwd_cases, bwd_cases = [], []
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for shape, dtype in K5_CASES:
        dt = getattr(torch, dtype)
        d = shape[-1]
        x = (torch.randn(shape, generator=g, device="cuda") * 4).to(dt)
        dy = torch.randn(shape, generator=g, device="cuda").to(dt)
        x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
        n = x2.shape[0]
        tol = K5_F32_ROW_TOL if dtype == "float32" else K5_BF16_ROW_TOL
        y, m, l = ck.row_softmax(x2)
        py, pm, pl = ck.row_softmax_plain(x2)
        dx = ck.row_softmax_bwd(x2, m, l, dy2)
        pdx = ck.row_softmax_bwd_plain(x2, m, l, dy2)
        torch.cuda.synchronize()
        size = x2.element_size()
        shp = {"shape": list(shape), "rows": n, "cols": d, "dtype": dtype}
        # forward: y, and m, l (one value a row: their error is relative
        # to themselves)
        y_err = _row_rel_err(y, py)
        ml_err = max(_row_rel_err(m, pm), _row_rel_err(l, pl))
        # f32 operations an element, an exp counted as one: max, subtract,
        # exp and add, then subtract, exp and divide
        bound, by = _bound_ms(2 * n * d * size + 2 * n * size,
                              7 * n * d, PEAK_F32_FLOPS)
        case = dict(shp, **{
            "max_abs_err": float((y.float() - py.float()).abs().max()),
            "max_row_rel_err": y_err, "ml_rel_err": ml_err,
            "row_rel_tol": tol,
            "ok": (y_err <= tol and ml_err <= tol
                   and bool(torch.isfinite(y.float()).all())),
            "ms": _time_ms(lambda: ck.row_softmax(x2)),
            "device_ms": _device_ms(torch, lambda: ck.row_softmax(x2)),
            "plain_ms": _time_ms(lambda: ck.row_softmax_plain(x2), iters=5,
                                 warmup=1),
            "library_ms": _time_ms(lambda: torch.softmax(x2, -1)),
            "library_device_ms": _device_ms(
                torch, lambda: torch.softmax(x2, -1)),
            "library_computes": "torch.softmax(x, -1) (no m, l)",
            "bound_ms": bound, "bound_by": by})
        _log("[kernels] row_softmax_fwd %s" % json.dumps(case))
        fwd_cases.append(case)
        # backward, from the kernel's saved m and l
        dx_err = _term_rel_err(torch, dx, pdx, y, dy2)
        # y rebuilt twice (3 each), the dot (2), dy - dot and the product
        bound, by = _bound_ms(3 * n * d * size + 2 * n * size, 10 * n * d,
                              PEAK_F32_FLOPS)
        case = dict(shp, **{
            "max_abs_err": float((dx.float() - pdx.float()).abs().max()),
            "max_row_rel_err": dx_err, "row_rel_tol": tol,
            "row_scale": "largest y * (|dy| + |dot|) of the row",
            "ok": (dx_err <= tol
                   and bool(torch.isfinite(dx.float()).all())),
            "ms": _time_ms(lambda: ck.row_softmax_bwd(x2, m, l, dy2)),
            "device_ms": _device_ms(
                torch, lambda: ck.row_softmax_bwd(x2, m, l, dy2)),
            "plain_ms": _time_ms(lambda: ck.row_softmax_bwd_plain(
                x2, m, l, dy2), iters=5, warmup=1),
            "library_ms": _time_ms(lambda: torch._softmax_backward_data(
                dy2, y, -1, x2.dtype)),
            "library_device_ms": _device_ms(
                torch, lambda: torch._softmax_backward_data(
                    dy2, y, -1, x2.dtype)),
            "library_computes": "torch._softmax_backward_data(dy, y) "
                                "(reads y, not x, m, l)",
            "bound_ms": bound, "bound_by": by})
        _log("[kernels] row_softmax_bwd %s" % json.dumps(case))
        bwd_cases.append(case)
        del x, dy, x2, dy2, y, m, l, py, pm, pl, dx, pdx
        torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


def _differing_nan(torch, x, y):
    """Elements of x and y that differ in their bits, a NaN equal to any
    NaN."""
    as_int = torch.int32 if x.element_size() == 4 else torch.int16
    both_nan = torch.isnan(x) & torch.isnan(y)
    return int(((x.view(as_int) != y.view(as_int)) & ~both_nan).sum())


# K6's shapes: the TransformerLM d_ff epilogue (B*S = 8192 rows of 3072)
# in f32 and bf16, LeNet's Dense(500) at BS 64, and 1000 ImageNet classes
# with NaN and -0.0 planted in x and -0.0 in the bias.
K6_CASES = (((8192, 3072), "float32", False), ((8192, 3072), "bfloat16",
                                                False),
            ((64, 500), "float32", False), ((4096, 1000), "float32", True),
            ((4096, 1000), "bfloat16", True))


def check_scale_bias_relu(ck, torch):
    """K6 against ``scale_bias_relu_plain``, bitwise, at K6_CASES."""
    cases = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for shape, dtype, special in K6_CASES:
        dt = getattr(torch, dtype)
        n, d = shape
        x = torch.randn(shape, generator=g, device="cuda").to(dt)
        s = torch.randn(d, generator=g, device="cuda").to(dt)
        b = torch.randn(d, generator=g, device="cuda").to(dt)
        if special:
            x.view(-1)[::97] = float("nan")
            x.view(-1)[5::89] = -0.0
            b[::7] = -0.0
        y = ck.scale_bias_relu(x, s, b)
        py = ck.scale_bias_relu_plain(x, s, b)
        torch.cuda.synchronize()
        diff = _differing_nan(torch, y, py)
        negzero = int((torch.signbit(y) & ~torch.isnan(y)).sum())
        size = x.element_size()
        bound, by = _bound_ms(2 * n * d * size + 2 * d * size, 3 * n * d,
                              PEAK_F32_FLOPS)
        case = {"shape": list(shape), "dtype": dtype,
                "nan_and_neg_zero": special, "differing_elements": diff,
                "negative_zeros_out": negzero,
                "max_abs_err": float((y.float() - py.float()).nan_to_num()
                                     .abs().max()),
                "ok": diff == 0 and negzero == 0,
                "ms": _time_ms(lambda: ck.scale_bias_relu(x, s, b)),
                "device_ms": _device_ms(
                    torch, lambda: ck.scale_bias_relu(x, s, b)),
                "plain_ms": _time_ms(lambda: ck.scale_bias_relu_plain(
                    x, s, b), iters=5, warmup=1),
                "library_ms": None,
                "library_computes": "none: no one PyTorch call computes it",
                "inputs_vs_l2": "repeated launches on the same %.1f MB"
                                % (2 * n * d * size / 1e6),
                "bound_ms": bound, "bound_by": by}
        _log("[kernels] scale_bias_relu %s" % json.dumps(case))
        cases.append(case)
    return cases


# ------------------------------------------------------------- phase 3
def _prompts(np, vocab):
    rng = np.random.default_rng(SEED)
    lens = np.linspace(17, 1500, N_REQUESTS).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def _teacher_forced_check(mx, model, np, torch, prompts, streams):
    """Every served token vs the plain (tier-off) argmax, teacher-forced.
    Returns (tokens checked, the plain top-2 margins of the mismatches,
    each excused as a near-tie below LOGIT_MARGIN_TOL)."""
    checked, tie_margins = 0, []
    mx.config.set("kernels.enabled", False)
    try:
        for pr, st in zip(prompts, streams):
            seq = np.concatenate([pr, st[:-1]]).astype(np.int64)
            logits = model.apply(seq[None])[0, len(pr) - 1:]
            top2 = torch.topk(logits, 2, dim=-1)
            plain = top2.indices[:, 0].cpu().numpy()
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            for i, tok in enumerate(st):
                checked += 1
                if int(tok) == int(plain[i]):
                    continue
                if margin[i] < LOGIT_MARGIN_TOL:
                    tie_margins.append(float(margin[i]))
                    continue
                raise AssertionError(
                    "served token %d at step %d of a %d-token prompt "
                    "disagrees with the plain argmax %d (margin %.4f >= "
                    "%.4f)" % (tok, i, len(pr), plain[i], margin[i],
                               LOGIT_MARGIN_TOL))
    finally:
        mx.config.unset("kernels.enabled")
    return checked, tie_margins


def _replay_logits(mx, model, np, torch, prompt, stream, quantized, tier):
    """Logits of one served stream replayed through prefill + decode_step
    (B=1, its own page pool) with the kernel tier on or off."""
    psz = 16
    pages = -(-(len(prompt) + len(stream)) // psz)
    table = np.arange(pages, dtype=np.int32)[None]
    mx.config.set("kernels.enabled", tier)
    try:
        kv = model.init_kv_pages(pages, psz, quantized=quantized)
        kv, _, lg = model.prefill(kv, prompt[None], np.asarray([len(prompt)]),
                                  table, psz, return_logits=True)
        out = [lg]
        for i, tok in enumerate(stream[:-1]):
            kv, _, lg = model.decode_step(
                kv, np.asarray([tok]), np.asarray([len(prompt) + i]), table,
                psz, return_logits=True)
            out.append(lg)
    finally:
        mx.config.unset("kernels.enabled")
    return torch.cat(out).float()


def _kernel_accuracy(mx, model, model32, np, torch, prompt, stream,
                     quantized):
    """How far the kernels move the serving path's logits: the replayed
    stream's logits with the kernel tier on and off (bf16 model), and the
    same replay on an f32 copy of the weights as the reference.  Returns
    (|on - off|, |on - f32|, |off - f32|), each a max over the stream."""
    on = _replay_logits(mx, model, np, torch, prompt, stream, quantized, True)
    off = _replay_logits(mx, model, np, torch, prompt, stream, quantized,
                         False)
    ref = _replay_logits(mx, model32, np, torch, prompt, stream, quantized,
                         False)
    return (float((on - off).abs().max()), float((on - ref).abs().max()),
            float((off - ref).abs().max()))


def _profiler_records_cuda(torch):
    """True when torch.profiler records CUDA kernels here, probed on one
    small product before any request is served in a profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x = torch.ones(64, 64, device="cuda")
            float((x @ x).sum())
    except RuntimeError:
        return False
    return any(ev.device_type == DeviceType.CUDA for ev in prof.events())


def _profile(torch, fn, top=8):
    """torch.profiler over ``fn()``: wall time, summed CUDA kernel time
    and the device's idle share, plus the ``top`` kernels that took most
    device time and every kernel of the port's by its own name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    groups = {}
    for name, t in by_name.items():
        group = next((g for g, keys in _KERNEL_GROUPS if any(
            k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + t
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
            "top_kernels_ms": [[n[:80], t] for n, t in ranked],
            "port_kernels_ms": {n[:80]: t for n, t in by_name.items()
                                if any(k in n for k in _KERNEL_GROUPS[0][1])},
            "by_group_ms": groups}


# device time by kind, matched on kernel names in this order
_KERNEL_GROUPS = (
    ("port kernels", ("flash_", "paged_", "adam_multi", "sgd_multi")),
    ("cudnn layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("gemm and convolution", ("cudnn", "xmma", "cutlass", "gemm", "sm90_",
                              "sm80_", "implicit_convolve", "wgrad",
                              "dgrad", "conv")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "Functor")),
)


def _profile_window(srv, torch, prompts):
    """The profiled serving window: 8 concurrent requests (256-token
    prompts, 16 new tokens)."""
    def run():
        futs = [srv.submit_generate("lm", pr[:256], 16)
                for pr in prompts[:8]]
        for f in futs:
            f.result(timeout=600)
    return _profile(torch, run)


def _zero_counts(torch, tt, ck):
    """Zero the launch counts and telemetry just before a counted run."""
    from mxnet_tpu_torch import rtc
    torch.cuda.synchronize()
    tt.reset()
    ck.reset_launches()
    rtc.reset_launches()


def _read_counts(torch, tt, ck, layers, paged_key):
    """Read a counted run just after it: every prefill layer ran the flash
    kernel and every decode layer the paged kernel ``paged_key``, through
    the routed wrappers, and no other kernel launched.  Returns
    (prefills, decode iterations, launches, telemetry snapshot)."""
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    snap = tt.snapshot()
    c, tm = snap["counters"], snap["timers"]
    prefills = tm.get("serving.prefill_ms", {}).get("count", 0)
    decodes = tm.get("serving.decode_step_ms", {}).get("count", 0)
    assert prefills > 0 and decodes > 0, (prefills, decodes)
    want = dict.fromkeys(launches, 0)
    want.update({"flash_fwd": prefills * layers,
                 paged_key: decodes * layers})
    assert launches == want, (launches, want)
    assert c.get("kernels.flash_attention", 0) == prefills * layers, c
    assert c.get("kernels.paged_attention", 0) == decodes * layers, c
    return prefills, decodes, launches, snap


#: the decode-step comparison: B decode slots at the widest decode width
#: (128 pages of 16), sequence lengths spread over its upper half
DECODE_B = 8
DECODE_WIDTH = 128
DECODE_STEPS = 10


def _gathered_route(ck):
    """``kernels.paged_attention_pool`` as the decode step ran it before
    the kernel read the pool: the clamped table and the mask made once a
    step, then per layer K and V (and their scales) gathered through the
    table and transposed into ``[B, H, K, D]`` copies, and the gathered
    entry of the same kernel under the mask."""
    memo = {}

    def route(q, k_pool, v_pool, page_table, lengths, scale=None,
              k_scale_pool=None, v_scale_pool=None):
        import torch
        key = (id(page_table), id(lengths))   # one step's tensors
        B, W = page_table.shape
        P, psz = k_pool.shape[:2]
        if key not in memo:
            memo.clear()
            memo[key] = (page_table.long().clamp(0, P - 1),
                         torch.arange(W * psz, device=q.device)[None, :]
                         < lengths[:, None])
        rows, valid = memo[key]

        def gather(pool):
            g = pool[rows].reshape(B, W * psz, *pool.shape[2:])
            return g.transpose(1, 2).contiguous()
        scales = {}
        if k_scale_pool is not None:
            scales = {"k_scale": gather(k_scale_pool),
                      "v_scale": gather(v_scale_pool)}
        return ck.paged_attention(q.contiguous(), gather(k_pool),
                                  gather(v_pool), valid, scale=scale,
                                  **scales)
    return route


def _decode_routes(ck, np, torch, model):
    """``model.decode_step`` at DECODE_B slots and DECODE_WIDTH pages on a
    seeded full-width pool, DECODE_STEPS profiled steps a route: the
    pool-form route (``decode_step`` as it is) and the gathered route
    (:func:`_gathered_route` in its place).  Per route: the CUDA kernels
    (and copies) the profiler records a step, the device ms and the host
    ms of a step (p50, ending in a sync), the paged launches (exactly one
    a layer a step, of the route's entry); and the two routes' logits
    agree within the served logits' margin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import kernels as tk
    cfg = model.cfg
    L, B, W, psz = cfg.num_layers, DECODE_B, DECODE_WIDTH, 16
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    kv = model.init_kv_pages(KV_PAGES, psz)
    for name in ("k", "v"):
        for li in range(L):
            kv[name][li].copy_(torch.randn(kv[name][li].shape, generator=g,
                                           device="cuda"))
    rng = np.random.default_rng(SEED + 21)
    table = rng.permutation(KV_PAGES)[:B * W].reshape(B, W).astype(np.int32)
    positions = np.linspace(W * psz // 2, W * psz - 1, B).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    # a step appends at `positions`; the same positions every step keep
    # the work equal (the appended row is rewritten in place)
    out = {"at": {"B": B, "pages": W, "page_size": psz,
                  "lengths": [int(p) + 1 for p in positions]}}
    saved = tk.paged_attention_pool
    logits = {}
    try:
        for name, route in (("pool", saved), ("gathered", _gathered_route(
                ck))):
            tk.paged_attention_pool = route

            def step():
                return model.decode_step(kv, tokens, positions, table, psz,
                                         return_logits=True)[2]
            logits[name] = step().float()
            torch.cuda.synchronize()
            host = []
            for _ in range(DECODE_STEPS):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            ck.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(DECODE_STEPS):
                    step()
                torch.cuda.synchronize()
            launches = {k: v for k, v in ck.LAUNCHES.items() if v}
            dev = [ev for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA]
            busy = sum(ev.time_range.elapsed_us() for ev in dev) / 1e3
            key = ("paged_decode_pool_bf16" if name == "pool"
                   else "paged_decode_bf16")
            assert launches.get(key) == L * DECODE_STEPS, launches
            out[name] = {"cuda_kernels_per_step": len(dev) / DECODE_STEPS,
                         "device_ms_per_step": busy / DECODE_STEPS,
                         "host_ms_p50": float(np.median(host)),
                         "paged_launches": launches[key]}
            _log("[serve] decode step, %s route %s" % (name,
                                                       json.dumps(out[name])))
    finally:
        tk.paged_attention_pool = saved
        del kv
        torch.cuda.empty_cache()
    out["logit_max_abs_diff"] = float(
        (logits["pool"] - logits["gathered"]).abs().max())
    assert out["logit_max_abs_diff"] <= LOGIT_MARGIN_TOL, out
    out["kernels_saved_per_step"] = (out["gathered"]["cuda_kernels_per_step"]
                                     - out["pool"]["cuda_kernels_per_step"])
    out["device_ms_saved_per_step"] = (out["gathered"]["device_ms_per_step"]
                                       - out["pool"]["device_ms_per_step"])
    return out


def serve(mx, ck, np, torch, workdir):
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    out = {}
    cfg = TransformerLMConfig()
    t0 = time.perf_counter()
    model = TransformerLM(cfg).init(SEED)
    nparams = sum(p.numel() for p in model.parameters())
    prefix = os.path.join(workdir, "lm")
    prefixq = os.path.join(workdir, "lmq")
    mx.deploy.export_generation(model, None, prefix, sampling=True)
    mx.deploy.export_generation(model, None, prefixq, kv_quantized=True)
    out["setup_s"] = time.perf_counter() - t0
    out["params"] = nparams
    mx.config.set("serving.kv_pages", KV_PAGES)
    srv = mx.serving.Server()
    try:
        eng = srv.register("lm", prefix, generate=True)
        engq = srv.register("lmq", prefixq, generate=True)
        srv.start()
        gp = eng.predictor
        assert gp.page_size == 16 and eng.decode_slots == 8
        assert all(r["impl"] == "paged" for r in gp.paged_routes.values())
        prompts = _prompts(np, cfg.vocab_size)
        # warm-up outside the counted run (library handles, allocator)
        srv.generate("lm", prompts[0][:64], 4, timeout=600)

        L = cfg.num_layers
        # --- the main path: counts zeroed just before, read just after
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        futs = [srv.submit_generate("lm", pr, NEW_TOKENS) for pr in prompts]
        streams = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        prefills, decodes, launches, snap = _read_counts(
            torch, tt, ck, L, "paged_decode_pool_bf16")
        tm = snap["timers"]
        assert prefills == N_REQUESTS, prefills
        assert all(len(s) == NEW_TOKENS for s in streams)
        out["greedy"] = {
            "requests": N_REQUESTS,
            "prompt_lens": [int(len(p)) for p in prompts],
            "new_tokens": NEW_TOKENS, "prefills": prefills,
            "decode_iterations": decodes, "wall_s": wall,
            "tokens_per_s": N_REQUESTS * NEW_TOKENS / wall,
            "ttft_ms_p50": tm["serving.ttft_ms"]["p50"],
            "ttft_ms_p99": tm["serving.ttft_ms"]["p99"],
            "prefill_ms_p50": tm["serving.prefill_ms"]["p50"],
            "decode_step_ms_p50": tm["serving.decode_step_ms"]["p50"],
            "decode_step_ms_p99": tm["serving.decode_step_ms"]["p99"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}
        _log("[serve] greedy %s" % json.dumps(out["greedy"]))
        checked, ties = _teacher_forced_check(mx, model, np, torch, prompts,
                                              streams)
        lens = [len(p) for p in prompts]
        pick = (lens.index(min(lens)), lens.index(max(lens)))
        model32 = TransformerLM(TransformerLMConfig(dtype=torch.float32))
        model32.load_state_dict(model.state_dict())
        acc = {}
        for quant in (False, True):
            rows = [_kernel_accuracy(mx, model, model32, np, torch,
                                     prompts[i], streams[i], quant)
                    for i in pick]
            acc[quant] = [max(r[j] for r in rows) for j in range(3)]
            # the kernel path may be no less accurate than the plain bf16
            # path, judged against the f32 weights
            assert acc[quant][1] <= KERNEL_VS_PLAIN_ERR * acc[quant][2], \
                (quant, acc[quant])
        del model32
        out["greedy"].update({
            "checked_tokens": checked, "near_ties": len(ties),
            "near_tie_max_margin": max(ties, default=0.0),
            "logit_kernel_vs_plain_bf16_kv": acc[False][0],
            "logit_err_vs_f32_kernel_bf16_kv": acc[False][1],
            "logit_err_vs_f32_plain_bf16_kv": acc[False][2],
            "logit_kernel_vs_plain_int8_kv": acc[True][0],
            "logit_err_vs_f32_kernel_int8_kv": acc[True][1],
            "logit_err_vs_f32_plain_int8_kv": acc[True][2]})
        _log("[serve] parity: %d tokens held against the plain argmax, "
             "%d near-tie(s) below margin %.3f (largest %.4f)"
             % (checked, len(ties), LOGIT_MARGIN_TOL, max(ties, default=0.0)))
        _log("[serve] logits on the serving path, max |diff|: kernel vs "
             "plain %.4f / %.4f, kernel vs f32 %.4f / %.4f, plain vs f32 "
             "%.4f / %.4f (bf16 KV / int8 KV)"
             % (acc[False][0], acc[True][0], acc[False][1], acc[True][1],
                acc[False][2], acc[True][2]))

        # --- int8 KV pages: counts zeroed just before, read just after
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        futq = [srv.submit_generate("lmq", pr, 16) for pr in prompts[:8]]
        sq = [f.result(timeout=600) for f in futq]
        wall = time.perf_counter() - t0
        prefills, decodes, launches, _ = _read_counts(
            torch, tt, ck, L, "paged_decode_pool_int8")
        assert prefills == 8, prefills
        agree = float(np.mean([np.mean(a == b[:16])
                               for a, b in zip(sq, streams[:8])]))
        out["int8"] = {"requests": 8, "new_tokens": 16, "wall_s": wall,
                       "prefills": prefills, "decode_iterations": decodes,
                       "launches": launches,
                       "token_agreement_with_bf16_kv": agree}
        _log("[serve] int8 %s" % json.dumps(out["int8"]))

        # --- seeded sampling, one seed one stream: counts zeroed just
        # before, read just after
        _zero_counts(torch, tt, ck)
        rep = [srv.generate("lm", prompts[0], 16, temperature=0.8, top_k=50,
                            top_p=0.95, seed=1234, timeout=600)
               for _ in range(2)]
        other = srv.generate("lm", prompts[0], 16, temperature=0.8,
                             top_k=50, top_p=0.95, seed=4321, timeout=600)
        prefills, decodes, launches, _ = _read_counts(
            torch, tt, ck, L, "paged_decode_pool_bf16")
        assert prefills == 3, prefills
        assert np.array_equal(rep[0], rep[1]), (rep[0], rep[1])
        out["sampling"] = {"replay_equal": True,
                           "other_seed_differs": bool(
                               not np.array_equal(rep[0], other)),
                           "prefills": prefills,
                           "decode_iterations": decodes,
                           "launches": launches}
        _log("[serve] sampling %s" % json.dumps(out["sampling"]))

        # --- one decode step, the pool-form route against the gathered
        # one, at the widest width
        out["decode_routes"] = _decode_routes(ck, np, torch, gp.model)

        # --- where a served decode step's time goes (device idle share);
        # a failure of the served requests in this window fails the run
        if _profiler_records_cuda(torch):
            out["profile"] = _profile_window(srv, torch, prompts)
        else:
            out["profile"] = {"error": "not measured: torch.profiler "
                                       "recorded no CUDA kernels"}
        _log("[serve] profile %s" % json.dumps(out["profile"]))
    finally:
        srv.stop()
        mx.config.unset("serving.kv_pages")
    return out


# ------------------------------------------------------------- phase 4
def _train_grads(mx, model, loss_of, tier):
    """Loss and f32 copies of the parameter gradients of one backward of
    ``loss_of(model)``."""
    mx.config.set("kernels.enabled", tier)
    try:
        model.zero_grad(set_to_none=True)
        loss = loss_of(model)
        loss.backward()
        grads = {n: p.grad.float().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    finally:
        mx.config.unset("kernels.enabled")
    return float(loss.detach()), grads


def _grad_gate(mx, torch, model, make32, loss_of, floor=0.0):
    """First-step gradients of ``loss_of`` on the kernel path, the plain
    path (tier off) and the plain path on an f32 copy of the weights
    (``make32()``, a model of the same config in f32); per tensor, the
    relative error of each bf16 path against f32.  The kernel path may be
    at most KERNEL_VS_PLAIN_GRAD_ERR x the plain path's error, that error
    floored at ``floor``."""
    loss_on, on = _train_grads(mx, model, loss_of, True)
    loss_off, off = _train_grads(mx, model, loss_of, False)
    model32 = make32()
    model32.load_state_dict(model.state_dict())
    model32.requires_grad_(True)
    loss32, ref = _train_grads(mx, model32, loss_of, False)
    del model32
    out = {"loss_kernel": loss_on, "loss_plain": loss_off,
           "loss_f32": loss32, "tensors": {}}
    for name, r in ref.items():
        norm = float(r.norm())
        e_on = float((on[name] - r).norm()) / norm
        e_off = float((off[name] - r).norm()) / norm
        out["tensors"][name] = {"kernel_vs_f32": e_on, "plain_vs_f32": e_off,
                                "kernel_vs_plain": float(
                                    (on[name] - off[name]).norm()) / norm}
        assert e_on <= KERNEL_VS_PLAIN_GRAD_ERR * max(e_off, floor), (
            name, e_on, e_off)
    out["floor"] = floor
    del on, off, ref
    torch.cuda.empty_cache()
    return out


def _grad_accuracy(mx, model, torch, inp, tgt):
    """The TransformerLM's gradient gate (:func:`_grad_gate`)."""
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    return _grad_gate(
        mx, torch, model,
        lambda: TransformerLM(TransformerLMConfig(dtype=torch.float32)),
        lambda m: m.loss(inp, tgt))


def train(mx, ck, np, torch):
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    cfg = TransformerLMConfig()
    model = TransformerLM(cfg).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    L = cfg.num_layers
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    inp = torch.as_tensor(toks[:, :-1], device="cuda")
    tgt = torch.as_tensor(toks[:, 1:], device="cuda")
    out = {"params": sum(p.numel() for p in params),
           "tensors": len(params), "batch": [TRAIN_B, TRAIN_S]}
    out["grad_accuracy"] = _grad_accuracy(mx, model, torch, inp, tgt)
    _log("[train] gradients at the initial weights %s"
         % json.dumps(out["grad_accuracy"]))

    opt = mx.optimizer.create("adam", learning_rate=TRAIN_LR,
                              multi_precision=True)
    states = [opt.create_state_multi_precision(i, p)
              for i, p in enumerate(params)]

    index = list(range(len(params)))

    def step(per_index=False):
        model.zero_grad(set_to_none=True)
        loss = model.loss(inp, tgt)
        loss.backward()
        if per_index:
            for i, p in enumerate(params):
                opt.update_multi_precision(i, p, p.grad, states[i])
        else:
            # MXNet's aggregated update: the whole list in one call, one
            # K3 launch
            opt.update_multi_precision(index, params,
                                       [p.grad for p in params], states)
        return loss

    def per_index():
        return step(per_index=True)

    # --- the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(torch, tt, ck)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = float(step().detach())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    c = tt.snapshot()["counters"]
    n = TRAIN_STEPS
    want = dict.fromkeys(launches, 0)
    want.update({"flash_fwd": L * n, "flash_bwd_dq": L * n,
                 "flash_bwd_dkv": L * n, "adam_step": n})
    assert launches == want, (launches, want)
    assert c.get("kernels.fused_step", 0) == len(params) * n, c
    assert c.get("kernels.flash_attention", 0) == L * n, c
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    tokens = TRAIN_B * TRAIN_S
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    matmul_params = L * (D * 3 * D + D * D + 2 * D * F_) + V * D
    product = 2 * cfg.head_dim * cfg.num_heads * TRAIN_B \
        * TRAIN_S * (TRAIN_S + 1) // 2
    # 6 x matmul params x tokens, plus 9 attention products a layer
    # (2 forward; 3 in K2dq and 4 in K2dkv, which recompute S)
    flops = 6 * matmul_params * tokens + L * 9 * product
    med = float(np.median(step_ms[4:]))
    out.update({
        "steps": n, "losses": losses, "step_ms": step_ms,
        "median_step_ms_5_20": med, "tokens_per_step": tokens,
        "tokens_per_s": tokens / (med / 1e3),
        "flops_per_step": flops, "matmul_params": matmul_params,
        "mfu_vs_989_tflops": flops / (med / 1e3) / PEAK_BF16_FLOPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches})
    _log("[train] %s" % json.dumps({k: v for k, v in out.items()
                                    if k != "grad_accuracy"}))
    out["route_ab"] = _train_route_ab(np, torch, step, per_index)
    if _profiler_records_cuda(torch):
        out["profile"] = _profile(torch, lambda: [step() for _ in range(3)],
                                  top=16)
    else:
        out["profile"] = {"error": "not measured: torch.profiler recorded "
                                   "no CUDA kernels"}
    _log("[train] profile over 3 steps %s" % json.dumps(out["profile"]))
    return out


def _train_route_ab(np, torch, step, per_index):
    """The train step with the list update (one K3 launch, "change")
    against one ``update_multi_precision`` call and one launch per
    tensor ("parent", the route before K3 took a list): TRAIN_AB_PAIRS
    pairs of TRAIN_AB_STEPS steps, the order alternating; host-clock ms
    a step, each step ending in a sync."""
    sides = {"parent": per_index, "change": step}
    ms = {"parent": [], "change": []}
    for i in range(TRAIN_AB_PAIRS):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            for _ in range(TRAIN_AB_STEPS):
                t0 = time.perf_counter()
                float(sides[side]().detach())
                torch.cuda.synchronize()
                ms[side].append((time.perf_counter() - t0) * 1e3)
    out = {"pairs": TRAIN_AB_PAIRS, "steps": TRAIN_AB_STEPS, "step_ms": ms}
    for side, v in ms.items():
        out[side] = _quartiles(np, v)
    _log("[train] route A/B %s" % json.dumps(
        {k: v for k, v in out.items() if k != "step_ms"}))
    return out


# ------------------------------------------------------------- phase 4b
#: examples/bert_pretrain.py at its defaults: BERT-base (vocab 30522, 12
#: layers, d_model 768, 12 heads, d_ff 3072), B=8 sequences of S=128 with
#: M=20 masked positions, lr 1e-4, bf16, 20 timed steps after one warm-up
BERT_B, BERT_S, BERT_M = 8, 128, 20
BERT_STEPS = 20
BERT_LR = 1e-4
#: the f32 run (--dtype float32) and the Adam route, steps each
BERT_F32_STEPS = 5
BERT_ADAM_STEPS = 5
BERT_ARGS = ("tokens", "token_types", "mlm_positions", "mlm_labels",
             "mlm_weights", "nsp_labels")
# BERT's gradient gate floors the plain bf16 path's error at one bf16 ulp
# (2^-7 of a value at most): the gradients land in bf16, so a tensor
# whose gradient is in effect one number can be off by whole ulps only.
# nsp_b's gradient is one number (its two entries sum to 0): on the H100
# the plain path landed one ulp from the f32 value (0.00667 relative)
# and the kernel path two (0.01333), while the other 17 tensors' errors
# are sums over many entries.  A faulty kernel moves gradients by their
# own size and fails by far.
BERT_GRAD_FLOOR = 2.0 ** -7


def bert_config(torch, dtype):
    """``examples/bert_pretrain.py``'s BERTConfig at its defaults: BERT-base
    (``bert_base``) with ``max_len`` the sequence length."""
    from mxnet_tpu_torch.models import bert_base
    return bert_base(max_len=BERT_S, dtype=dtype)


def bert_batch(np, torch, vocab, device="cuda"):
    """The example's synthetic batch: ``np.random.RandomState(0)`` and the
    same draws in the same order (tokens, token types, masked positions,
    their labels, the next-sentence labels); every masked weight 1."""
    rng = np.random.RandomState(0)
    B, S, M = BERT_B, BERT_S, BERT_M
    batch = dict(tokens=rng.randint(0, vocab, (B, S)),
                 token_types=rng.randint(0, 2, (B, S)),
                 mlm_positions=rng.randint(0, S, (B, M)),
                 mlm_labels=rng.randint(0, vocab, (B, M)),
                 mlm_weights=np.ones((B, M), np.float32),
                 nsp_labels=rng.randint(0, 2, (B,)))
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def example_sgd_step(params, lr):
    """The example's update, ``w - lr * g.astype(w.dtype)``, in place on
    each parameter from its ``.grad``: the Python ``lr`` takes the
    weight's dtype (JAX's weak typing), then the product and the
    difference each round once to that dtype.  (``torch._foreach_add_``
    with ``alpha=-lr`` rounds once and is not this update.)"""
    import torch
    with torch.no_grad():
        lrs = {}
        for w in params:
            key = (w.dtype, w.device)
            if key not in lrs:
                lrs[key] = torch.full((), lr, dtype=w.dtype, device=w.device)
            w.copy_(w - lrs[key] * w.grad.to(w.dtype))


def _bert_flops(cfg):
    """Model FLOPs of one pretraining step (forward and backward, the
    backward's recomputation of the scores not counted): 6 x the
    encoder's matmul parameters x tokens, 3 x the 2 attention products a
    layer (2 D S^2 B H FLOPs each), 6 x the MLM head's transform and tied
    readout x masked positions, and 6 x the pooler and NSP head x
    sequences."""
    L, D, F_, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    tokens = BERT_B * BERT_S
    encoder = L * (D * 3 * D + D * D + 2 * D * F_)
    product = 2 * cfg.head_dim * cfg.num_heads * BERT_B * BERT_S * BERT_S
    parts = {"encoder_matmuls": 6 * encoder * tokens,
             "attention": 3 * 2 * product * L,
             "mlm_head": 6 * (D * D + V * D) * BERT_B * BERT_M,
             "pooler_nsp": 6 * (D * D + 2 * D) * BERT_B}
    return sum(parts.values()), parts, encoder


def _bert_steps(np, torch, model, batch, update, steps, log_every=0):
    """``steps`` pretraining steps (loss, backward, ``update()``): the
    losses and host-clock ms a step, each step ending in a sync."""
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss = model.pretrain_loss(*(batch[k] for k in BERT_ARGS))
        loss.backward()
        update()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if log_every and (i + 1) % log_every == 0:
            _log("[bert] step %d: mlm+nsp loss %.4f" % (i + 1, losses[-1]))
    assert all(np.isfinite(losses)), losses
    return losses, step_ms


def _bert_adam_entries(torch, params, states):
    """Per tensor of the list route: (master, m, v, cast or None); an f32
    tensor is its own master."""
    out = []
    for w, s in zip(params, states):
        if w.dtype == torch.float32:
            m, v = s
            out.append((w, m, v, None))
        else:
            master, (m, v) = s
            out.append((master, m, v, w))
    return out


def _bert_adam_bitwise(ck, torch, model, batch, opt, params, states):
    """One Adam step of the list route (one K3 launch over the 18
    tensors) against ``fused_adam_step_multi_plain`` on copies of the
    same masters, moments and grads, lr_t from the optimizer's own step
    counts: bitwise on the masters, m, v and the bf16 casts."""
    model.zero_grad(set_to_none=True)
    model.pretrain_loss(*(batch[k] for k in BERT_ARGS)).backward()
    grads = [w.grad for w in params]
    entries = _bert_adam_entries(torch, params, states)
    copies = [(a.clone(), m.clone(), v.clone(),
               None if c is None else torch.empty_like(c))
              for a, m, v, c in entries]
    lr_ts = [opt._lr_t_of(opt._get_lr(i), opt._index_update_count.get(i, 0)
                          + 1) for i in range(len(params))]
    before = ck.LAUNCHES["adam_step"]
    opt.update_multi_precision(list(range(len(params))), params, grads,
                               states)
    launches = ck.LAUNCHES["adam_step"] - before
    ck.fused_adam_step_multi_plain(
        [c[0] for c in copies], [g.contiguous() for g in grads],
        [c[1] for c in copies], [c[2] for c in copies], lr_ts,
        [opt._get_wd(i) for i in range(len(params))], opt.beta1, opt.beta2,
        opt.epsilon, outs=[c[3] for c in copies])
    torch.cuda.synchronize()
    diff = {"master": 0, "m": 0, "v": 0, "cast": 0}
    for (a, m, v, c), (pa, pm, pv, pc) in zip(entries, copies):
        diff["master"] += _differing(torch, a, pa)
        diff["m"] += _differing(torch, m, pm)
        diff["v"] += _differing(torch, v, pv)
        if c is not None:
            diff["cast"] += _differing(torch, c, pc)
    out = {"tensors": len(params), "launches": launches,
           "f32_own_master": sum(c is None for *_, c in entries),
           "k3_vs_plain_differing": diff}
    assert launches == 1 and sum(diff.values()) == 0, out
    return out


def bert(mx, ck, np, torch, card):
    """BERT-base pretraining, ``examples/bert_pretrain.py`` at its
    defaults: the gradient gate at the initial weights, then the bf16
    run (one warm-up step, BERT_STEPS counted steps: 12 non-causal
    flash_fwd, flash_bwd_dq and flash_bwd_dkv launches a step and nothing
    else, finite losses, the last below the first), a profiled window of
    3 steps, the f32 run through flash_f32.cu (BERT_F32_STEPS steps) and
    the Adam route (``Adam(multi_precision=True)`` over the 18 tensors
    through the list ``update_multi_precision``: one step bitwise against
    the plain multi version, then BERT_ADAM_STEPS counted steps of one
    adam_step each).  Launch counts are zeroed just before each counted
    run and read just after."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models import BERT
    cfg = bert_config(torch, torch.bfloat16)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = BERT(cfg).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    batch = bert_batch(np, torch, cfg.vocab_size, model.device)
    flops, parts, encoder = _bert_flops(cfg)
    out = {"card": card, "batch": [BERT_B, BERT_S, BERT_M],
           "params": sum(p.numel() for p in params), "tensors": len(params),
           "setup_s": time.perf_counter() - t0}

    def loss_of(m):
        return m.pretrain_loss(*(batch[k] for k in BERT_ARGS))

    out["grad_accuracy"] = _grad_gate(
        mx, torch, model, lambda: BERT(bert_config(torch, torch.float32)),
        loss_of, floor=BERT_GRAD_FLOOR)
    _log("[bert] gradients at the initial weights %s"
         % json.dumps(out["grad_accuracy"]))

    def sgd():
        example_sgd_step(params, BERT_LR)

    warm, _ = _bert_steps(np, torch, model, batch, sgd, 1)
    # --- the main path: counts zeroed just before, read just after
    _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    losses, step_ms = _bert_steps(np, torch, model, batch, sgd, BERT_STEPS,
                                  log_every=5)
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    c = tt.snapshot()["counters"]
    n = BERT_STEPS
    assert launches == _want_launches(ck, flash_fwd=L * n,
                                      flash_bwd_dq=L * n,
                                      flash_bwd_dkv=L * n), launches
    assert c.get("kernels.flash_attention", 0) == L * n, c
    assert losses[-1] < losses[0], losses
    med = float(np.median(step_ms))
    seqs = BERT_B * n / wall
    _log("[bert] %.1f sequences/s (B=%d S=%d, %d layers, bfloat16)"
         % (seqs, BERT_B, BERT_S, L))
    out.update({
        "warmup_loss": warm[0], "steps": n, "losses": losses,
        "step_ms": step_ms, "median_step_ms": med,
        "sequences_per_s": seqs,
        "sequences_per_s_median": BERT_B / (med / 1e3),
        "tokens_per_s": BERT_B * BERT_S / (med / 1e3),
        "flops_per_step": flops, "flops_parts": parts,
        "encoder_matmul_params": encoder,
        "mfu_vs_989_tflops": flops / (med / 1e3) / PEAK_BF16_FLOPS,
        "launches": launches})
    _log("[bert] bf16 %s" % json.dumps(
        {k: v for k, v in out.items() if k != "grad_accuracy"}))
    if _profiler_records_cuda(torch):
        out["profile"] = _profile(
            torch, lambda: _bert_steps(np, torch, model, batch, sgd, 3),
            top=16)
    else:
        out["profile"] = {"error": "not measured: torch.profiler recorded "
                                   "no CUDA kernels"}
    _log("[bert] profile over 3 steps %s" % json.dumps(out["profile"]))
    del model, params
    torch.cuda.empty_cache()

    # --- the f32 run (--dtype float32): flash_f32.cu's three kernels
    model = BERT(bert_config(torch, torch.float32)).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    _zero_counts(torch, tt, ck)
    losses, step_ms = _bert_steps(np, torch, model, batch, sgd,
                                  BERT_F32_STEPS)
    launches = dict(ck.LAUNCHES)
    n = BERT_F32_STEPS
    assert launches == _want_launches(ck, flash_fwd_f32=L * n,
                                      flash_bwd_dq_f32=L * n,
                                      flash_bwd_dkv_f32=L * n), launches
    out["f32"] = {"steps": n, "losses": losses, "step_ms": step_ms,
                  "median_step_ms": float(np.median(step_ms)),
                  "launches": launches}
    _log("[bert] f32 %s" % json.dumps(out["f32"]))
    del model, params
    torch.cuda.empty_cache()

    # --- the Adam route: one K3 launch a step over the 18 tensors
    model = BERT(cfg).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    opt = mx.optimizer.create("adam", learning_rate=BERT_LR,
                              multi_precision=True)
    states = [opt.create_state_multi_precision(i, p)
              for i, p in enumerate(params)]
    index = list(range(len(params)))

    def adam():
        opt.update_multi_precision(index, params, [p.grad for p in params],
                                   states)

    routes = _bert_adam_bitwise(ck, torch, model, batch, opt, params, states)
    _log("[bert-adam] K3 vs its plain version %s" % json.dumps(routes))
    _zero_counts(torch, tt, ck)
    losses, step_ms = _bert_steps(np, torch, model, batch, adam,
                                  BERT_ADAM_STEPS)
    launches = dict(ck.LAUNCHES)
    c = tt.snapshot()["counters"]
    n = BERT_ADAM_STEPS
    assert launches == _want_launches(
        ck, flash_fwd=L * n, flash_bwd_dq=L * n, flash_bwd_dkv=L * n,
        adam_step=n), launches
    assert c.get("kernels.fused_step", 0) == len(params) * n, c
    out["adam"] = {"lr": BERT_LR, "steps": n, "losses": losses,
                   "step_ms": step_ms,
                   "median_step_ms": float(np.median(step_ms)),
                   "launches": launches,
                   "fused_step_counter": c.get("kernels.fused_step", 0),
                   "routes": routes}
    _log("[bert-adam] %s" % json.dumps(out["adam"]))
    del model, params, opt, states
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 4c
#: bench.py transformer_kernels_config's train row on the accelerator
#: (its B, H, S = 4, 8, 1024): TransformerLM at vocab 256, 2 layers,
#: d_model 256 (8 heads of 32), d_ff 512, max_len 1024, f32; seeded tokens
#: in [0, 256) as inputs and targets (the reference's ``loss(tok, tok)``);
#: Adam lr 1e-3, wd 0; LM32_STEPS steps a route from the same weights
LM32_B, LM32_S, LM32_STEPS, LM32_LR = 4, 1024, 20, 1e-3
# Step-1 gradients, tier on against tier off, per tensor: max |on - off|
# over the tensor's largest |off|.  The routes differ only in attention:
# flash_f32.cu against the plain f32 lowering.  Between a weight and the
# loss stand at most four kernel outputs (each layer's o, and dq, dk or
# dv), each within F32_ROW_REL_TOL = 2^-12 of its row's absolute sum
# (phase 2); a weight gradient is a sum over the batch's positions of
# such rows times activations, so its error is within 4 x 2^-12 of the
# matching absolute sum.  The gate states it against the tensor's
# largest gradient instead (the absolute sums are not formed here),
# which holds while a tensor's gradients do not cancel by more than the
# kernels' measured margin below 2^-12 (~25x on the H100).  A kernel that
# drops a 32-key tile moves rows by ~2^-5 of their size and fails by far.
LM32_GRAD_TOL = 2.0 ** -10


def lm32_config(torch):
    from mxnet_tpu_torch.models.transformer import TransformerLMConfig
    return TransformerLMConfig(vocab_size=256, num_layers=2, d_model=256,
                               num_heads=8, d_ff=512, max_len=LM32_S,
                               dtype=torch.float32)


def train_lm_f32(mx, ck, np, torch, card):
    """bench.py ``transformer_kernels_config``'s f32 train step: the
    gradient gate (LM32_GRAD_TOL) at the initial weights, then
    LM32_STEPS steps with the kernel tier on (flash_f32.cu at head dim 32;
    Adam over the 9 f32 weights, each its own master, through one list
    ``update_multi_precision``: one K3 launch a step) and LM32_STEPS with
    it off (plain attention, the plain update), from the same weights.
    Counts are zeroed just before each route's steps and read just after:
    tier on, exactly L flash_fwd_f32, flash_bwd_dq_f32 and
    flash_bwd_dkv_f32 and one adam_step a step; tier off, none.  Losses
    finite, the tier-on route's last below its first; median step ms,
    tokens/s and a profiled window of 3 steps a route, and the last
    step's loss delta between the routes (the reference's
    ``train_loss_delta``)."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.transformer import TransformerLM
    cfg = lm32_config(torch)
    L = cfg.num_layers
    model = TransformerLM(cfg).init(SEED)
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    tok = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (LM32_B, LM32_S)), device="cuda")
    out = {"card": card, "config": cfg.to_dict(), "head_dim": cfg.head_dim,
           "batch": [LM32_B, LM32_S], "tensors": len(params),
           "params": sum(p.numel() for p in params)}

    def loss_of(m):
        return m.loss(tok, tok)

    _, on = _train_grads(mx, model, loss_of, True)
    _, off = _train_grads(mx, model, loss_of, False)
    errs = {n: float((on[n] - off[n]).abs().max())
            / max(float(off[n].abs().max()), 1e-30) for n in names}
    out["grad_gate"] = {"tol": LM32_GRAD_TOL, "max": max(errs.values()),
                        "per_tensor": errs}
    _log("[lm-f32] step-1 gradients, tier on vs off %s"
         % json.dumps(out["grad_gate"]))
    assert max(errs.values()) <= LM32_GRAD_TOL, errs
    del on, off
    index = list(range(len(params)))
    profiled = _profiler_records_cuda(torch)
    for route, tier in (("on", True), ("off", False)):
        with torch.no_grad():
            for p, w in zip(params, start):
                p.copy_(w)
        opt = mx.optimizer.create("adam", learning_rate=LM32_LR, wd=0.0,
                                  multi_precision=True)
        states = [opt.create_state_multi_precision(i, p)
                  for i, p in enumerate(params)]

        def step():
            model.zero_grad(set_to_none=True)
            loss = loss_of(model)
            loss.backward()
            opt.update_multi_precision(index, params,
                                       [p.grad for p in params], states)
            return loss

        mx.config.set("kernels.enabled", tier)
        try:
            # --- the main path: counts zeroed just before, read just after
            _zero_counts(torch, tt, ck)
            losses, step_ms = [], []
            for _ in range(LM32_STEPS):
                t0 = time.perf_counter()
                losses.append(float(step().detach()))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(ck.LAUNCHES)
            c = tt.snapshot()["counters"]
            n = LM32_STEPS
            want = _want_launches(
                ck, flash_fwd_f32=L * n, flash_bwd_dq_f32=L * n,
                flash_bwd_dkv_f32=L * n, adam_step=n) if tier \
                else _want_launches(ck)
            assert launches == want, (route, launches)
            assert c.get("kernels.flash_attention", 0) == L * n * tier, c
            assert c.get("kernels.fused_step", 0) == \
                len(params) * n * tier, c
            assert all(np.isfinite(losses)), losses
            if tier:
                assert losses[-1] < losses[0], losses
            prof = _profile(torch, lambda: [step() for _ in range(3)],
                            top=12) if profiled else {
                "error": "not measured: torch.profiler recorded no CUDA "
                         "kernels"}
        finally:
            mx.config.unset("kernels.enabled")
        med = float(np.median(step_ms))
        out[route] = {"steps": n, "losses": losses, "step_ms": step_ms,
                      "median_step_ms": med,
                      "tokens_per_s": LM32_B * LM32_S / (med / 1e3),
                      "launches": launches, "profile": prof}
        _log("[lm-f32] tier %s %s" % (route, json.dumps(out[route])))
    out["loss_delta_last_step"] = abs(out["on"]["losses"][-1]
                                      - out["off"]["losses"][-1])
    _log("[lm-f32] %s: median step %.3f ms tier on, %.3f ms tier off; "
         "last-step loss delta %.3g"
         % (card, out["on"]["median_step_ms"], out["off"]["median_step_ms"],
            out["loss_delta_last_step"]))
    del model, params, start
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 5
def _resnet_trainer(mx, net, dtype, optimizer="sgd"):
    """``bench.py`` ``one_config``'s trainer: SGD lr 0.1, momentum 0.9,
    wd 1e-4 through SPMDTrainer on a one-device mesh; or Adam at
    RESNET_ADAM_LR."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    params = ({"learning_rate": 0.1, "momentum": 0.9, "wd": SGD_WD}
              if optimizer == "sgd" else {"learning_rate": RESNET_ADAM_LR})
    return SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer, params,
                       mesh=make_mesh({"dp": -1}), dtype=dtype)


def _state(tr):
    names = tr.fn.trainable
    return ({n: tr.params[n] for n in names},
            {n: tr.params[n] for n in tr.fn.aux})


def _bf16_vs_f32(mx, torch, net, tr, data, label):
    """The first step's loss and gradients on the bf16 path against an
    f32 copy (``dtype=None``) at the same weights and batch; nothing is
    updated."""
    tr32 = _resnet_trainer(mx, net, None)
    tr32._materialize(data)
    loss16, _, g16 = tr._loss_and_grads(*_state(tr), data, label)
    loss32, _, g32 = tr32._loss_and_grads(*_state(tr32), data, label)
    # a conv bias that feeds a BatchNorm has an exact gradient of 0: its
    # norm is floored at 1% of the largest tensor's gradient norm
    floor = 1e-2 * max(float(b.norm()) for b in g32)
    errs = sorted((float((a - b).norm()) / max(float(b.norm()), floor), n)
                  for a, b, n in zip(g16, g32, tr.fn.trainable))
    out = {"loss_bf16": float(loss16), "loss_f32": float(loss32),
           "loss_rel_diff": abs(float(loss16) - float(loss32))
           / abs(float(loss32)), "loss_rtol": RESNET_BF16_LOSS_RTOL,
           "grad_rel_err_floor": "1% of the largest gradient norm",
           "grad_rel_err_median": errs[len(errs) // 2][0],
           "grad_rel_err_max": errs[-1][0],
           "grad_rel_err_worst": [[n, e] for e, n in errs[-3:]]}
    del tr32, g16, g32
    torch.cuda.empty_cache()
    assert out["loss_rel_diff"] <= RESNET_BF16_LOSS_RTOL, out
    return out


def _sgd_routes(ck, torch, tr, data, label):
    """One step's gradients at the trainer's state, taken once and applied
    to clones of the masters and momenta three ways: the trainer's fused
    route (K1, one launch), K1's plain version, and the tier-off route
    (``SGD.step`` per tensor).  K1 must equal its plain version bit for
    bit.  ``SGD.step`` rounds ``wd * w`` and ``momentum * m`` on their own
    where K1 (and the reference's compiled step) contracts them into
    FMAs, so it may differ in the last bits: each element of the two
    routes may differ by at most SGD_ROUTE_TOL x the sum of the update's
    terms' magnitudes (|w| + |momentum * m| + |lr * g| + |lr * wd * w|)."""
    train, aux = _state(tr)
    _, _, grads = tr._loss_and_grads(train, aux, data, label)
    lrs, wds = tr._hyper()
    opt, t = tr.optimizer, tr._step_num + 1
    names = tr.fn.trainable
    w0 = [train[n].detach() for n in names]
    m0 = [tr.opt_state[n] for n in names]

    def clones():
        return [w.clone() for w in w0], [m.clone() for m in m0]
    kw, km = clones()
    opt.step_fused_multi(kw, grads, km, lrs, wds, t)
    pw, pm = clones()
    ck.fused_sgd_step_multi_plain(pw, grads, pm, lrs, wds, opt.momentum)
    sw, sm = clones()
    with torch.no_grad():
        for w, g, m, lr, wd in zip(sw, grads, sm, lrs, wds):
            nw, nm = opt.step(w, g, m, lr, wd, t)
            w.copy_(nw)
            m.copy_(nm)
    torch.cuda.synchronize()
    vs_plain = sum(_differing(torch, a, b) for a, b in zip(kw + km, pw + pm))
    vs_step, worst = 0, 0.0
    for w, m, g, lr, wd, a_w, a_m, b_w, b_m in zip(w0, m0, grads, lrs, wds,
                                                  kw, km, sw, sm):
        mag = (w.abs() + opt.momentum * m.abs() + lr * g.abs()
               + lr * wd * w.abs())
        for a, b in ((a_w, b_w), (a_m, b_m)):
            vs_step += _differing(torch, a, b)
            worst = max(worst, float(((a - b).abs() / mag.clamp_min(
                1e-30)).max()))
    out = {"tensors": len(names), "params": sum(w.numel() for w in w0),
           "k1_vs_plain_differing": vs_plain,
           "k1_vs_sgd_step_differing": vs_step,
           "k1_vs_sgd_step_worst_rel": worst,
           "route_tol": SGD_ROUTE_TOL}
    assert vs_plain == 0 and worst <= SGD_ROUTE_TOL, out
    return out


def _adam_routes(ck, torch, tr, data, label):
    """One step's gradients at the Adam trainer's state, taken once and
    applied to copies of the masters, m and v two ways: the trainer's
    fused route (K3, one launch over the 193 tensors) and
    ``fused_adam_step_multi_plain`` with each tensor's lr_t computed here
    from the trainer's lr and step.  Bitwise on the masters, m and v."""
    from mxnet_tpu_torch.optimizer.optimizer import _bias_corrected_lr
    train, aux = _state(tr)
    _, _, grads = tr._loss_and_grads(train, aux, data, label)
    lrs, wds = tr._hyper()
    opt, t = tr.optimizer, tr._step_num + 1
    names = tr.fn.trainable
    w0 = [train[n].detach() for n in names]
    s0 = [tr.opt_state[n] for n in names]

    def copies():
        return ([w.clone() for w in w0], [m.clone() for m, _ in s0],
                [v.clone() for _, v in s0])
    kw, km, kv = copies()
    before = ck.LAUNCHES["adam_step"]
    opt.step_fused_multi(kw, grads, list(zip(km, kv)), lrs, wds, t)
    launches = ck.LAUNCHES["adam_step"] - before
    pw, pm, pv = copies()
    ck.fused_adam_step_multi_plain(
        pw, grads, pm, pv,
        [float(_bias_corrected_lr(lr, opt.beta1, opt.beta2, t))
         for lr in lrs], wds, opt.beta1, opt.beta2, opt.epsilon)
    torch.cuda.synchronize()
    diff = {k: sum(_differing(torch, a, b) for a, b in zip(x, y))
            for k, x, y in (("master", kw, pw), ("m", km, pm),
                            ("v", kv, pv))}
    out = {"tensors": len(names), "params": sum(w.numel() for w in w0),
           "t": t, "launches": launches, "k3_vs_plain_differing": diff}
    assert launches == 1 and sum(diff.values()) == 0, out
    return out


def train_resnet_adam(mx, ck, np, torch, net, data, label, card):
    """ResNet-50 v1 through SPMDTrainer with Adam (RESNET_ADAM_LR, bf16
    over f32 masters, BS 128): one warm-up step, one step's update held
    bitwise against the plain multi version, then RESNET_ADAM_STEPS
    counted steps, counts zeroed just before and read just after: one
    adam_step launch a step over the 193 tensors and no other kernel of
    the port, finite losses."""
    from mxnet_tpu_torch import telemetry as tt
    tr = _resnet_trainer(mx, net, "bfloat16", optimizer="adam")
    warm, _ = _timed(np, torch, tr, data, label, 1)
    out = {"optimizer": "adam", "lr": RESNET_ADAM_LR, "dtype": "bfloat16",
           "batch": RESNET_BATCH, "tensors": len(tr.fn.trainable),
           "warmup_losses": warm}
    out["adam_routes"] = _adam_routes(ck, torch, tr, data, label)
    _log("[resnet-adam] K3 vs its plain version %s"
         % json.dumps(out["adam_routes"]))
    # --- the main path: counts zeroed just before, read just after
    _zero_counts(torch, tt, ck)
    losses, step_ms = _timed(np, torch, tr, data, label, RESNET_ADAM_STEPS)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    c = tt.snapshot()["counters"]
    assert launches == _want_launches(ck, adam_step=RESNET_ADAM_STEPS), \
        launches
    out.update({"steps": RESNET_ADAM_STEPS, "losses": losses,
                "step_ms": step_ms, "launches": launches,
                "fused_step_counter": c.get("kernels.fused_step", 0)})
    out.update(_rate(np, step_ms, card))
    _log("[resnet-adam] %s" % json.dumps(out))
    del tr
    torch.cuda.empty_cache()
    return out


def _timed(np, torch, tr, data, label, steps):
    """Losses and host-clock ms of ``steps`` steps, each ending in a sync
    (the loss read)."""
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(tr.step(data, label)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    assert all(np.isfinite(losses)), losses
    return losses, step_ms


def _rate(np, step_ms, card):
    med = float(np.median(step_ms))
    flops = RESNET_BATCH * RESNET_FLOPS_PER_IMG
    return {"median_step_ms": med,
            "img_per_s": RESNET_BATCH / (med / 1e3),
            "flops_per_step": flops,
            "mfu_vs_989_tflops": flops / (med / 1e3) / PEAK_BF16_FLOPS,
            "card": card}


def train_resnet(mx, ck, np, torch, card):
    """ResNet-50 v1 trained by SPMDTrainer at BS 128, as ``bench.py``
    ``one_config`` runs it."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon.model_zoo import vision
    # cuDNN picks each convolution's algorithm by timing it (first steps)
    torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(SEED)
    shape = (RESNET_BATCH, 3, RESNET_HW, RESNET_HW)
    data = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).cuda()
    label = torch.from_numpy(rng.randint(0, 1000, (RESNET_BATCH,))
                             .astype(np.float32)).cuda()
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(data, ctx=mx.gpu(0)))    # resolve the deferred shapes
    tr = _resnet_trainer(mx, net, "bfloat16")
    tr._materialize(data)
    out = {"setup_s": time.perf_counter() - t0, "batch": RESNET_BATCH,
           "tensors": len(tr.fn.trainable), "aux": len(tr.fn.aux),
           "params": sum(tr.params[n].numel() for n in tr.fn.trainable),
           "card": card, "cudnn_benchmark": True}
    out["bf16_vs_f32"] = _bf16_vs_f32(mx, torch, net, tr, data, label)
    _log("[resnet] first step, bf16 vs f32 %s" % json.dumps(
        out["bf16_vs_f32"]))
    warm, _ = _timed(np, torch, tr, data, label, RESNET_WARMUP)
    out["sgd_routes"] = _sgd_routes(ck, torch, tr, data, label)
    _log("[resnet] K1 vs its plain version and SGD.step %s"
         % json.dumps(out["sgd_routes"]))

    # --- the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(torch, tt, ck)
    losses, step_ms = _timed(np, torch, tr, data, label, RESNET_STEPS)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    c = tt.snapshot()["counters"]
    want = dict.fromkeys(launches, 0)
    want["sgd_step"] = RESNET_STEPS
    assert launches == want, (launches, want)
    out.update({"steps": RESNET_STEPS, "warmup_losses": warm,
                "losses": losses, "loss_fell": losses[-1] < losses[0],
                "step_ms": step_ms, "launches": launches,
                "fused_step_counter": c.get("kernels.fused_step", 0),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    out.update(_rate(np, step_ms, card))
    _log("[resnet] bf16 %s" % json.dumps(
        {k: v for k, v in out.items() if k not in ("bf16_vs_f32",
                                                     "sgd_routes")}))
    if not out["loss_fell"]:
        _log("[resnet] NOTE: the loss did not fall over the counted steps")
    if _profiler_records_cuda(torch):
        out["profile"] = _profile(
            torch, lambda: [tr.step(data, label) for _ in range(3)], top=16)
    else:
        out["profile"] = {"error": "not measured: torch.profiler recorded "
                                   "no CUDA kernels"}
    _log("[resnet] profile over 3 steps %s" % json.dumps(out["profile"]))
    del tr
    torch.cuda.empty_cache()

    # --- the reference sweep's other rows, 5 timed steps each
    for key, dtype, layout in (("nhwc_bf16", "bfloat16", "NHWC"),
                               ("f32", None, "native")):
        mx.config.set("conv.internal_layout", layout)
        try:
            other = _resnet_trainer(mx, net, dtype)
            _timed(np, torch, other, data, label, 1)
            torch.cuda.reset_peak_memory_stats()
            row_losses, row_ms = _timed(np, torch, other, data, label, 5)
        finally:
            mx.config.unset("conv.internal_layout")
        row = {"dtype": dtype or "float32", "conv_layout": layout,
               "losses": row_losses, "step_ms": row_ms,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        row.update(_rate(np, row_ms, card))
        out[key] = row
        _log("[resnet] %s %s" % (key, json.dumps(row)))
        del other
        torch.cuda.empty_cache()
    out["adam"] = train_resnet_adam(mx, ck, np, torch, net, data, label,
                                    card)
    return out


# ------------------------------------------------------------- phase 6
# The tape over K5 at the readout's full size, K6 at the d_ff epilogue's,
# and the flash op at the training shape.
TAPE_ROWS, TAPE_VOCAB = 8192, 32000
SBR_SHAPE = (8192, 3072)
# LeNet-MNIST through gluon.Trainer at examples/gluon_mnist.py's defaults
LENET_SAMPLES = 2048
LENET_BATCH = 64
LENET_EPOCHS = 2
LENET_LR = 0.02
# The reference's epoch-2 accuracy on the CPU with the same seeds (numpy
# and framework seed 0), as tests/test_torch_gluon_trainer.py
# (test_lenet_two_epochs_reach_reference_accuracy) measures it; the port
# on the card may fall short of it by LENET_ACC_SLACK (its own weights
# are drawn by its own generator).
LENET_REF_ACC = 1.0
LENET_ACC_SLACK = 0.05
LENET_PROFILE_STEPS = 5


def _want_launches(ck, **counts):
    want = dict.fromkeys(ck.LAUNCHES, 0)
    want.update(counts)
    return want


def _raises(exc, fn):
    try:
        fn()
    except exc:
        return True
    return False


def tape(mx, ck, np, torch):
    """Phase 6(a): the registered kernel ops on the NDArray tape.  Launch
    counts are zeroed just before and read just after each run."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import telemetry as tt
    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    xt = torch.randn(TAPE_ROWS, TAPE_VOCAB, generator=g, device="cuda") * 4
    ct = torch.randn(TAPE_ROWS, TAPE_VOCAB, generator=g, device="cuda")
    x, c = mx.nd.NDArray(xt), mx.nd.NDArray(ct)
    x.attach_grad()
    # (1) recorded: one forward and, from backward(), one backward launch
    _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    with autograd.record():
        loss = (mx.nd.pallas_softmax(x) * c).sum()
    loss.backward()
    torch.cuda.synchronize()
    out["record_backward_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = dict(ck.LAUNCHES)
    assert out["launches"] == _want_launches(
        ck, row_softmax_fwd=1, row_softmax_bwd=1), out["launches"]
    py, pm, pl = ck.row_softmax_plain(xt)
    pdx = ck.row_softmax_bwd_plain(xt, pm, pl, ct)
    out["grad_rel_err"] = _term_rel_err(torch, x.grad._data, pdx, py, ct)
    out["grad_rel_tol"] = K5_F32_ROW_TOL
    assert out["grad_rel_err"] <= K5_F32_ROW_TOL, out["grad_rel_err"]
    del py, pm, pl, pdx
    out["second_backward_raises"] = _raises(RuntimeError, loss.backward)
    assert out["second_backward_raises"]
    # (2) not recorded: the forward kernel alone, nothing on the tape
    _zero_counts(torch, tt, ck)
    y = mx.nd.pallas_softmax(x)
    torch.cuda.synchronize()
    out["unrecorded_launches"] = dict(ck.LAUNCHES)
    assert out["unrecorded_launches"] == _want_launches(
        ck, row_softmax_fwd=1), out["unrecorded_launches"]
    assert not y._on_tape and not y._data.requires_grad
    del x, c, xt, ct, y, loss
    torch.cuda.empty_cache()
    # (3) K6 under record(): one launch, no history, no gradient
    x6, s6, b6 = (mx.nd.NDArray(torch.randn(shape, generator=g,
                                            device="cuda"))
                  for shape in (SBR_SHAPE, SBR_SHAPE[1:], SBR_SHAPE[1:]))
    for a in (x6, s6, b6):
        a.attach_grad()
    _zero_counts(torch, tt, ck)
    with autograd.record():
        y6 = mx.nd.pallas_scale_bias_relu(x6, s6, b6)
    torch.cuda.synchronize()
    out["sbr_launches"] = dict(ck.LAUNCHES)
    assert out["sbr_launches"] == _want_launches(
        ck, scale_bias_relu=1), out["sbr_launches"]
    out["sbr_untaped"] = (not y6._on_tape and not y6._data.requires_grad
                          and _raises(ValueError, y6.backward)
                          and not any(bool(a.grad._data.any())
                                      for a in (x6, s6, b6)))
    assert out["sbr_untaped"]
    del x6, s6, b6, y6
    # (4) the flash op: one forward, and from backward() one dq and one
    # dk/dv launch, at the training shape
    q, k, v, do = (torch.randn(TRAIN_B, 12, TRAIN_S, 64, generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    qa, ka, va = (mx.nd.NDArray(t) for t in (q, k, v))
    for a in (qa, ka, va):
        a.attach_grad()
    _zero_counts(torch, tt, ck)
    with autograd.record():
        o = mx.nd.pallas_flash_attention(qa, ka, va, causal=True)
    o.backward(mx.nd.NDArray(do))
    torch.cuda.synchronize()
    out["flash_launches"] = dict(ck.LAUNCHES)
    assert out["flash_launches"] == _want_launches(
        ck, flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1), \
        out["flash_launches"]
    po, _ = ck.flash_attention_plain(q, k, v, causal=True)
    out["flash_out_row_rel_err"] = _row_rel_err(o._data.detach(), po)
    assert out["flash_out_row_rel_err"] <= ROW_REL_TOL
    assert all(bool(torch.isfinite(a.grad._data.float()).all())
               for a in (qa, ka, va))
    del q, k, v, do, qa, ka, va, o, po
    torch.cuda.empty_cache()
    _log("[tape] %s" % json.dumps(out))
    return out


def build_lenet(nn):
    """LeNet (examples/gluon_mnist.py:27)."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, 5), nn.MaxPool2D(2, 2), nn.Activation("tanh"),
            nn.Conv2D(50, 5), nn.MaxPool2D(2, 2), nn.Activation("tanh"),
            nn.Flatten(), nn.Dense(500, activation="tanh"), nn.Dense(10))
    return net


def synthetic_mnist(np, n, seed=0):
    """Class-separable synthetic digits: class k lights a kth stripe
    (examples/gluon_mnist.py:35)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.uniform(0, 0.2, (n, 1, 28, 28)).astype(np.float32)
    for i, k in enumerate(y):
        x[i, 0, 2 * k:2 * k + 3, :] += 0.8
    return x, y.astype(np.float32)


def train_lenet(mx, ck, np, torch, card):
    """Phase 6(b): LeNet-MNIST through the imperative Gluon loop,
    examples/gluon_mnist.py at its defaults."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon import nn
    mx.random.seed(SEED)
    np.random.seed(SEED)
    X, Y = synthetic_mnist(np, LENET_SAMPLES, SEED)
    it = mx.io.NDArrayIter(X, Y, batch_size=LENET_BATCH, shuffle=True)
    net = build_lenet(nn)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": LENET_LR, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()

    def one_step(batch):
        data, label = batch.data[0], batch.label[0]
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label).mean()
        loss.backward()
        trainer.step(1)
        metric.update([label], [out])
        return float(loss.asnumpy())   # the host read ends the step

    _zero_counts(torch, tt, ck)
    losses, step_ms, accs, epoch_s = [], [], [], []
    for _ in range(LENET_EPOCHS):
        metric.reset()
        it.reset()
        e0 = time.perf_counter()
        for batch in it:
            t0 = time.perf_counter()
            losses.append(one_step(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        epoch_s.append(time.perf_counter() - e0)
        accs.append(metric.get()[1])
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    steps_per_epoch = len(step_ms) // LENET_EPOCHS
    last = step_ms[-steps_per_epoch:]
    med = float(np.median(last))
    out = {"steps": len(step_ms), "batch": LENET_BATCH,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses_finite": bool(np.all(np.isfinite(losses))),
           "epoch_accuracy": accs, "reference_cpu_accuracy": LENET_REF_ACC,
           "accuracy_slack": LENET_ACC_SLACK, "launches": launches,
           "kernel_launches_expected": "none: the loss is log_softmax "
                                       "plus pick, as in the reference",
           "median_step_ms_epoch2": med,
           "samples_per_s_median": LENET_BATCH / (med / 1e3),
           "samples_per_s_epoch2": LENET_SAMPLES / epoch_s[-1],
           "first_step_ms": step_ms[0], "card": card}
    assert out["losses_finite"], losses
    assert launches == _want_launches(ck), launches
    assert accs[-1] >= LENET_REF_ACC - LENET_ACC_SLACK, accs
    it.reset()
    batches = [next(it) for _ in range(LENET_PROFILE_STEPS)]
    out["profile"] = _profile(torch, lambda: [one_step(b) for b in batches])
    out["profile"]["steps"] = LENET_PROFILE_STEPS
    _log("[lenet] %s" % json.dumps(out))
    return out


#: MXNet's usual mixed precision on LeNet: f16 weights, f32 masters in the
#: optimizer state (multi_precision=True), one Trainer a route
F16_STEPS = 5
F16_OPTS = (("sgd", {"learning_rate": LENET_LR, "momentum": 0.9,
                     "wd": 1e-4, "multi_precision": True}),
            ("adam", {"learning_rate": 1e-3, "multi_precision": True}))


def train_f16(mx, ck, np, torch):
    """Phase 6(c): LeNet with f16 weights through ``gluon.Trainer`` and
    ``multi_precision=True``, SGD (momentum 0.9) and Adam, F16_STEPS steps
    each on the card.  Every update goes through the fused kernel with an
    f16 grad and an f16 cast (K1 for SGD, K3 for Adam): counts zeroed
    just before and read just after, exactly one sgd_step (adam_step) a
    tensor a step and no other kernel, one ``kernels.fused_step`` each,
    no KernelUnsupportedError; every loss finite, and each f16 weight
    the f16 cast of its f32 master bit for bit."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon import nn
    X, Y = synthetic_mnist(np, LENET_BATCH * F16_STEPS, SEED + 5)
    out = {}
    for opt, kw in F16_OPTS:
        mx.random.seed(SEED)
        net = build_lenet(nn)
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(X[:1]))
        net.cast("float16")
        trainer = gluon.Trainer(net.collect_params(), opt, dict(kw))
        params = trainer._params   # the order of the updater's indices
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        _zero_counts(torch, tt, ck)
        for i in range(F16_STEPS):
            rows = slice(i * LENET_BATCH, (i + 1) * LENET_BATCH)
            data = mx.nd.array(X[rows], dtype="float16")
            label = mx.nd.array(Y[rows])
            with autograd.record():
                loss = loss_fn(net(data), label).mean()
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        fused = tt.snapshot()["counters"].get("kernels.fused_step", 0)
        key = "sgd_step" if opt == "sgd" else "adam_step"
        n = len(params) * F16_STEPS
        states = trainer._updaters[0].states
        cast_differs = sum(
            _differing(torch, p.data()._data, states[i][0].half())
            for i, p in enumerate(params))
        res = {"optimizer": opt, "options": kw, "tensors": len(params),
               "steps": F16_STEPS, "losses": losses, "launches": launches,
               "fused_steps": fused,
               "weight_dtypes": sorted({str(p.data()._data.dtype)
                                        for p in params}),
               "master_dtypes": sorted({str(states[i][0].dtype)
                                        for i in range(len(params))}),
               "weights_differing_from_master_cast": cast_differs}
        _log("[f16] %s" % json.dumps(res))
        assert launches == _want_launches(ck, **{key: n}), launches
        assert fused == n, fused
        assert all(np.isfinite(losses)), losses
        assert res["weight_dtypes"] == ["torch.float16"], res
        assert res["master_dtypes"] == ["torch.float32"], res
        assert cast_differs == 0, cast_differs
        out[opt] = res
    return out


# ------------------------------------------------------------- phase 7
# mx.rtc (K7): user CUDA source compiled at run time by NVRTC.  The
# counterparts of tests/test_rtc_pallas.py's user kernels (doubler, add_one,
# block_scale on a 2-D grid of row blocks), the reference MXNet's own axpy,
# a row sum staged in more than 48 KB of dynamic shared memory, a template
# reached through exports and a kernel with a bf16 scalar.  The same
# kernels, small, are in tests/test_torch_rtc.py.  --fmad=false keeps
# y + alpha * x and x * alpha + beta at two roundings, as their plain
# expressions round.
RTC_SOURCE = r"""
#include <cuda_bf16.h>

extern "C" __global__ void doubler(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

extern "C" __global__ void add_one(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

// one block per tile of blockDim.y rows x blockDim.x columns
extern "C" __global__ void block_scale(const float* x, float* y, int rows,
                                       int cols) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r < rows && c < cols) {
    long long i = (long long)r * cols + c;
    y[i] = x[i] * 4.0f;
  }
}

// the reference MXNet's rtc example: no bound, the grid covers y exactly
extern "C" __global__ void axpy(const float* x, float* y, float alpha) {
  int i = threadIdx.x + blockIdx.x * blockDim.x;
  y[i] += alpha * x[i];
}

// blockDim.y rows a block, staged in dynamic shared memory, one warp a row
extern "C" __global__ void row_sum_smem(const float* x, float* out, int rows,
                                        int cols) {
  extern __shared__ float tile[];
  const int r0 = blockIdx.x * blockDim.y;
  const int nrows = min((int)blockDim.y, rows - r0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long count = (long long)nrows * cols;
  for (long long i = tid; i < count; i += blockDim.x * blockDim.y)
    tile[i] = x[(long long)r0 * cols + i];
  __syncthreads();
  if (threadIdx.y < nrows) {
    float s = 0.0f;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      s += tile[threadIdx.y * cols + c];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) out[r0 + threadIdx.y] = s;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void scale_add(const T* x, T* y, float alpha, float beta, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = from_f32<T>(to_f32(x[i]) * alpha + beta);
}

extern "C" __global__ void bf16_mul(const __nv_bfloat16* x,
                                    __nv_bfloat16* y, __nv_bfloat16 alpha,
                                    int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __hmul(x[i], alpha);
}
"""
RTC_OPTIONS = ("--fmad=false",)
RTC_EXPORTS = ("scale_add<float>", "scale_add<__nv_bfloat16>")
RTC_SIGNATURES = {
    "doubler": "const float *x, float *y, int n",
    "add_one": "const float *x, float *y, int n",
    "block_scale": "const float *x, float *y, int rows, int cols",
    "axpy": "const float *x, float *y, float alpha",
    "row_sum_smem": "const float *x, float *out, int rows, int cols",
    "scale_add<float>": "const float *x, float *y, float alpha, float beta, "
                        "int n",
    "scale_add<__nv_bfloat16>": "const __nv_bfloat16 *x, __nv_bfloat16 *y, "
                                "float alpha, float beta, int n",
    "bf16_mul": "const __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16, int",
}
RTC_BF16 = ("scale_add<__nv_bfloat16>", "bf16_mul")
# the d_ff epilogue shape K6 is held at, and small ragged ones
RTC_SHAPE = (8192, 3072)
RTC_RAGGED = ((37, 100), (1, 1), (5, 3073))
# 8 rows of 3072 f32 = 96 KB of dynamic shared memory a block (> 48 KB)
ROWSUM_ROWS = 8
# The shared-memory row sum adds in another order than x.sum(-1).  Per
# row, |kernel - plain| <= 2^-16 x sum |x_j| (the scale of any summation
# error): reordering 3072 f32 terms moves a sum by about sqrt(3072)
# roundings of its partial sums, some 2^-18 of sum |x_j| for random rows,
# and a dropped term of typical size moves it by ~2^-11 of it.
ROWSUM_TOL = 2.0 ** -16
RTC_ALPHA, RTC_BETA = 0.3, -1.25
SBR_CALL_SHAPE = (64, 500)
HOST_CALLS = 2000
# phase 7(b): the registered add_one in front of a FullyConnected
RTC_FC_HIDDEN = 128
RTC_FORWARDS = 3
# phase 7(c): bench.py module_train_config at its own size
MLP_LAYERS, MLP_WIDTH, MLP_CLASSES = 8, 128, 10
MLP_BATCH, MLP_FEAT = 64, 64
MLP_LR = 1e-3
MLP_WARMUP = 3
MLP_STEPS = 200
MLP_PROFILE_STEPS = 10
# Both routes after 5 steps from the same parameters and batch, per
# tensor: max |fused - eager| / max |eager|.  The routes run the same
# forward and backward and differ in Adam's roundings only (K3 contracts
# three multiply-adds, Adam.step rounds each): a few f32 ulps of each
# update of ~lr, under 1e-6 of a tensor whose entries moved by ~5 lr; a
# missed or doubled update moves a tensor by ~1/5 of itself.
MLP_AGREE_STEPS = 5
MLP_AGREE_RTOL = 1e-5
LRT_AB_PAIRS = 12


def _ew(n):
    return ((n + 255) // 256,), (256,)


def _rtc_plain(torch, name, x, y0):
    """The plain PyTorch expression user kernel ``name`` computes."""
    if name == "doubler":
        return x * 2
    if name == "add_one":
        return x + 1
    if name == "block_scale":
        return x * 4
    if name == "axpy":
        return y0 + RTC_ALPHA * x
    if name == "row_sum_smem":
        return x.sum(-1)
    if name.startswith("scale_add"):
        return (x.float() * RTC_ALPHA + RTC_BETA).to(x.dtype)
    return x * torch.tensor(RTC_ALPHA, dtype=torch.bfloat16, device=x.device)


def _rtc_launch(torch, kernels, name, x, y0):
    """One launch of user kernel ``name`` on ``x`` (``y0`` the axpy
    accumulator).  Returns (output, launch thunk, bytes, the one PyTorch
    call computing the same function or None)."""
    rows, cols = x.shape
    n = rows * cols
    y = torch.empty_like(x)
    shared, lib = 0, None
    if name in ("doubler", "add_one"):
        args, (g, b) = [x, y, n], _ew(n)
        lib = (lambda: torch.mul(x, 2.0)) if name == "doubler" else \
            (lambda: torch.add(x, 1.0))
    elif name == "block_scale":
        args, g, b = [x, y, rows, cols], ((cols + 127) // 128,
                                          (rows + 3) // 4), (128, 4)
        lib = lambda: torch.mul(x, 4.0)  # noqa: E731
    elif name == "axpy":
        y = y0.clone()
        g, b = ((n // 256,), (256,)) if n % 256 == 0 else ((n,), (1,))
        args = [x, y, RTC_ALPHA]
        lib = lambda: torch.add(y0, x, alpha=RTC_ALPHA)  # noqa: E731
    elif name == "row_sum_smem":
        y = torch.empty(rows, device=x.device)
        args, g, b = [x, y, rows, cols], ((rows + ROWSUM_ROWS - 1)
                                          // ROWSUM_ROWS,), (32, ROWSUM_ROWS)
        shared = ROWSUM_ROWS * cols * 4
        lib = lambda: torch.sum(x, -1)  # noqa: E731
    elif name.startswith("scale_add"):
        args, (g, b) = [x, y, RTC_ALPHA, RTC_BETA, n], _ew(n)
        # a 0-dim f32 beta: bf16 x stays bf16, computed in f32 and rounded
        # once, as the kernel does
        beta_t = torch.tensor(RTC_BETA, device=x.device)
        lib = lambda: torch.add(beta_t, x, alpha=RTC_ALPHA)  # noqa: E731
    else:  # bf16_mul
        args, (g, b) = [x, y, RTC_ALPHA, n], _ew(n)
        a16 = torch.tensor(RTC_ALPHA, dtype=torch.bfloat16, device=x.device)
        lib = lambda: torch.mul(x, a16)  # noqa: E731

    def run():
        kernels[name].launch(args, x.device, g, b, shared)
    run()
    nbytes = x.numel() * x.element_size() + y.numel() * y.element_size() \
        * (2 if name == "axpy" else 1)
    return y, run, nbytes, lib


def _rtc_err(torch, name, y, plain, x):
    """(max |y - plain|, differing elements, within tolerance?)."""
    err = float((y.float() - plain.float()).abs().max())
    if name == "row_sum_smem":
        scale = x.abs().sum(-1) * ROWSUM_TOL
        return err, None, bool(((y - plain).abs() <= scale).all())
    diff = _differing(torch, y, plain)
    return err, diff, diff == 0


def check_rtc(mx, ck, torch):
    """Phase 7(a): the user kernels through mx.rtc against their plain
    expressions (bitwise; the row sum within ROWSUM_TOL per row) at
    RTC_SHAPE and RTC_RAGGED, the errors the API must raise, and the
    times.  Returns (report, kernels dict, module)."""
    from mxnet_tpu_torch import rtc
    rtc.reset_launches()
    out = {}
    mod = rtc.CudaModule(RTC_SOURCE, options=RTC_OPTIONS,
                         exports=RTC_EXPORTS)
    out["compile_ms"] = mod.compile_ms
    t0 = time.perf_counter()
    kernels = {name: mod.get_kernel(name, sig)
               for name, sig in RTC_SIGNATURES.items()}
    out["load_ms"] = (time.perf_counter() - t0) * 1e3
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    cases = {}
    for shape in (RTC_SHAPE,) + RTC_RAGGED:
        for name in RTC_SIGNATURES:
            dt = torch.bfloat16 if name in RTC_BF16 else torch.float32
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            y0 = torch.randn(shape, generator=g, device="cuda")
            y, run, nbytes, lib = _rtc_launch(torch, kernels, name, x, y0)
            plain = _rtc_plain(torch, name, x, y0)
            torch.cuda.synchronize()
            err, diff, ok = _rtc_err(torch, name, y, plain, x)
            case = {"shape": list(shape), "dtype": str(dt)[6:],
                    "max_abs_err": err, "differing_elements": diff,
                    "ok": ok}
            if shape == RTC_SHAPE:
                bound, by = _bound_ms(nbytes, 2 * x.numel(), PEAK_F32_FLOPS)
                case.update(
                    ms=_time_ms(run), bound_ms=bound, bound_by=by,
                    plain_ms=_time_ms(lambda: _rtc_plain(
                        torch, name, x, y0), iters=5, warmup=1),
                    library_ms=_time_ms(lib) if lib is not None else None)
            _log("[rtc] %s %s" % (name, json.dumps(case)))
            cases.setdefault(name, []).append(case)
    out["cases"] = cases
    bad = [(n, c) for n, cs in cases.items() for c in cs if not c["ok"]]
    assert not bad, bad
    # the host cost of one launch call, beside a prebuilt kernel's
    x = torch.randn(SBR_CALL_SHAPE, generator=g, device="cuda")
    y = torch.empty_like(x)
    s, b = x[0].clone(), x[1].clone()
    k = kernels["block_scale"]
    grid = ((SBR_CALL_SHAPE[1] + 127) // 128, (SBR_CALL_SHAPE[0] + 3) // 4)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / HOST_CALLS * 1e6
    out["launch_host_us"] = host_us(lambda: k.launch(
        [x, y, SBR_CALL_SHAPE[0], SBR_CALL_SHAPE[1]], x.device, grid,
        (128, 4)))
    out["prebuilt_call_host_us"] = host_us(
        lambda: ck.scale_bias_relu(x, s, b))
    out["host_us_at"] = list(SBR_CALL_SHAPE)
    # what must raise
    xs = torch.randn(RTC_RAGGED[0], generator=g, device="cuda")
    n = xs.numel()
    k = kernels["doubler"]
    out["raises"] = {
        "cpu_tensor": _raises(ValueError, lambda: k.launch(
            [xs.cpu(), torch.empty_like(xs), n], xs.device, (1,), (256,))),
        "cpu_ctx": _raises(ValueError, lambda: k.launch(
            [xs, torch.empty_like(xs), n], mx.cpu(), (1,), (256,))),
        "dtype_vs_signature": _raises(TypeError, lambda: k.launch(
            [xs.double(), torch.empty_like(xs), n], xs.device, (1,),
            (256,))),
        "unknown_kernel": _raises(KeyError, lambda: mod.get_kernel(
            "no_such_kernel", "const float *x")),
    }
    try:
        rtc.CudaModule('extern "C" __global__ void broken(float* y) '
                       '{ y[0] = undeclared_name; }')
        out["raises"]["bad_source"] = False
    except RuntimeError as exc:
        out["raises"]["bad_source"] = "undeclared_name" in str(exc)
    assert all(out["raises"].values()), out["raises"]
    out["launches"] = dict(rtc.LAUNCHES)
    _log("[rtc] %s" % json.dumps({k: v for k, v in out.items()
                                  if k != "cases"}))
    return out, kernels


def _want_rtc(ck, **per_kernel):
    """Launch counts of a run that launched only ``per_kernel`` user
    kernels."""
    return (_want_launches(ck, rtc=sum(per_kernel.values())), per_kernel)


def rtc_ops(mx, ck, torch, kernels):
    """Phase 7(b): ``add_one`` registered as an op, on the path: one launch
    from ``mx.nd``; one and no history under ``autograd.record()``; in a
    ``mx.sym`` graph (op -> FullyConnected) bound by ``simple_bind``, one
    launch per ``Executor.forward``, the output equal to the same graph
    over ``data + 1`` to 0 ulp.  Counts are zeroed just before and read
    just after each run."""
    from mxnet_tpu_torch import autograd, rtc
    from mxnet_tpu_torch import telemetry as tt
    rtc.register_op("rtc_add_one", kernels["add_one"],
                    out_shape=lambda x: (x.shape, x.dtype),
                    grid_dims=lambda x: ((x.numel() + 255) // 256,),
                    block_dims=(256,), scalars=lambda x: [x.numel()])
    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    x = mx.nd.NDArray(torch.randn(RTC_SHAPE, generator=g, device="cuda"))

    def counted(fn):
        _zero_counts(torch, tt, ck)
        res = fn()
        torch.cuda.synchronize()
        return res, (dict(ck.LAUNCHES), dict(rtc.LAUNCHES))

    y, out["nd_launches"] = counted(lambda: mx.nd.rtc_add_one(x))
    assert out["nd_launches"] == _want_rtc(ck, add_one=1), \
        out["nd_launches"]
    out["nd_differing"] = _differing(torch, y._data, x._data + 1)
    x.attach_grad()

    def recorded():
        with autograd.record():
            return mx.nd.rtc_add_one(x)
    y, out["record_launches"] = counted(recorded)
    assert out["record_launches"] == _want_rtc(ck, add_one=1)
    out["record_untaped"] = not y._on_tape and not y._data.requires_grad
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(mx.sym.rtc_add_one(data, name="plus"),
                                num_hidden=RTC_FC_HIDDEN, name="fc")
    plain = mx.sym.FullyConnected(data + 1, num_hidden=RTC_FC_HIDDEN,
                                  name="fc")
    exes = [s.simple_bind(mx.gpu(0), grad_req="null", data=RTC_SHAPE)
            for s in (net, plain)]
    w = torch.randn(RTC_FC_HIDDEN, RTC_SHAPE[1], generator=g,
                    device="cuda") * 0.02
    b = torch.randn(RTC_FC_HIDDEN, generator=g, device="cuda")
    for ex in exes:
        ex.copy_params_from({"fc_weight": w, "fc_bias": b})
    xin = torch.randn(RTC_SHAPE, generator=g, device="cuda")
    outs, out["executor_launches"] = counted(lambda: [
        exes[0].forward(data=xin)[0] for _ in range(RTC_FORWARDS)])
    assert out["executor_launches"] == _want_rtc(
        ck, add_one=RTC_FORWARDS), out["executor_launches"]
    want = exes[1].forward(data=xin)[0]
    out["executor_differing"] = sum(_differing(torch, o._data, want._data)
                                    for o in outs)
    out["executor_forwards"] = RTC_FORWARDS
    assert out["nd_differing"] == 0 and out["record_untaped"] \
        and out["executor_differing"] == 0, out
    _log("[rtc_ops] %s" % json.dumps(out))
    return out


def _mlp_symbol(mx):
    """``bench.py`` ``module_train_config``'s MLP: MLP_LAYERS x MLP_WIDTH
    FullyConnected + relu, a 10-way head, SoftmaxOutput."""
    h = mx.sym.Variable("data")
    for i in range(MLP_LAYERS):
        h = mx.sym.FullyConnected(h, num_hidden=MLP_WIDTH, name="fc%d" % i)
        h = mx.sym.Activation(h, act_type="relu", name="relu%d" % i)
    h = mx.sym.FullyConnected(h, num_hidden=MLP_CLASSES, name="head")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _mlp_module(mx, init=None):
    mod = mx.mod.Module(_mlp_symbol(mx))
    mod.bind([("data", (MLP_BATCH, MLP_FEAT))],
             [("softmax_label", (MLP_BATCH,))])
    if init is None:
        mx.random.seed(SEED)
        mod.init_params(mx.init.Uniform(0.05))
    else:
        mod.init_params(initializer=None, arg_params=init)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": MLP_LR})
    return mod


def _mlp_batch(mx, np):
    """``bench.py``'s seeded batch: MLP_BATCH x MLP_FEAT features and
    labels in [0, MLP_CLASSES)."""
    rng = np.random.RandomState(0)
    X = rng.randn(MLP_BATCH, MLP_FEAT).astype(np.float32)
    Y = (rng.rand(MLP_BATCH) * MLP_CLASSES).astype(np.float32)
    return mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(Y)])


def _mlp_timed(mx, torch, mod, route, batch):
    """(outputs, seconds) of MLP_STEPS steps, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = _mlp_steps(mx, mod, route, batch, MLP_STEPS)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def _mlp_steps(mx, mod, route, batch, n):
    """``n`` train steps under ``module.fused_step=route``; the output of
    each step (the softmax, kept for the losses)."""
    mx.config.set("module.fused_step", route)
    try:
        outs = []
        for _ in range(n):
            mod.train_step(batch)
            outs.append(mod._exec.outputs[0]._data)
        return outs
    finally:
        mx.config.unset("module.fused_step")


def train_module(mx, ck, np, torch, card, workdir):
    """Phase 7(c): ``bench.py`` ``module_train_config`` at its own size
    through ``Module.train_step``, fused and eager."""
    from mxnet_tpu_torch import telemetry as tt
    batch = _mlp_batch(mx, np)
    label = batch.label[0]._data.long().unsqueeze(1)
    out = {"mlp": "%dx%d" % (MLP_LAYERS, MLP_WIDTH), "batch": MLP_BATCH,
           "features": MLP_FEAT, "optimizer": "adam", "lr": MLP_LR,
           "card": card}
    # (1) both routes from the same parameters and batch, MLP_AGREE_STEPS
    fused = _mlp_module(mx)
    init = fused.get_params()[0]
    eager = _mlp_module(mx, init)
    _mlp_steps(mx, fused, "auto", batch, MLP_AGREE_STEPS)
    _mlp_steps(mx, eager, "off", batch, MLP_AGREE_STEPS)
    fw, ew = fused.get_params()[0], eager.get_params()[0]
    out["routes_rel_err"] = max(
        float((fw[n]._data - ew[n]._data).abs().max()
              / ew[n]._data.abs().max()) for n in fw)
    out["routes_rel_tol"] = MLP_AGREE_RTOL
    out["tensors"] = len(fw)
    assert out["tensors"] == 2 * (MLP_LAYERS + 1), out["tensors"]
    assert out["routes_rel_err"] <= MLP_AGREE_RTOL, out["routes_rel_err"]
    # (2) each route timed: warm-up, then counted steps
    for route, mod in (("fused", fused), ("eager", eager)):
        knob = "auto" if route == "fused" else "off"
        _mlp_steps(mx, mod, knob, batch, MLP_WARMUP)
        _zero_counts(torch, tt, ck)
        outs, dt = _mlp_timed(mx, torch, mod, knob, batch)
        c = tt.snapshot()["counters"]
        losses = torch.stack([-torch.log(o.gather(1, label)).mean()
                              for o in outs]).cpu().numpy()
        r = {"steps": MLP_STEPS, "steps_per_s": MLP_STEPS / dt,
             "samples_per_s": MLP_STEPS * MLP_BATCH / dt,
             "step_ms": dt / MLP_STEPS * 1e3,
             "launches": dict(ck.LAUNCHES),
             "fused_steps": c.get("fused_steps", 0),
             "eager_steps": c.get("eager_steps", 0),
             "kernels_fused_step": c.get("kernels.fused_step", 0),
             "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
             "losses_finite": bool(np.isfinite(losses).all())}
        assert r["losses_finite"], losses
        if route == "fused":
            # one K3 launch a step over the 18 tensors; one
            # kernels.fused_step per tensor
            per_step = 2 * (MLP_LAYERS + 1)
            assert r["launches"] == _want_launches(
                ck, adam_step=MLP_STEPS), r["launches"]
            assert r["kernels_fused_step"] == per_step * MLP_STEPS, r
            assert r["fused_steps"] == MLP_STEPS, r
        else:
            # f32 weights: the Updater runs update_multi_precision ->
            # update -> Adam.step, PyTorch ops only (the reference's
            # optimizer.py:240-260 route for a weight that is not f16/bf16)
            assert r["launches"] == _want_launches(ck), r["launches"]
            assert r["eager_steps"] == MLP_STEPS, r
        out[route] = r
    out["fused_over_eager"] = out["fused"]["steps_per_s"] \
        / out["eager"]["steps_per_s"]
    out["profile"] = _profile(torch, lambda: _mlp_steps(
        mx, fused, "auto", batch, MLP_PROFILE_STEPS))
    out["profile"]["steps"] = MLP_PROFILE_STEPS
    # the same fused steps once a torch.profiler window has run
    _, dt = _mlp_timed(mx, torch, fused, "auto", batch)
    out["fused_after_profile_step_ms"] = dt / MLP_STEPS * 1e3
    # (3) a checkpoint written and read back on the card: the same bits
    prefix = os.path.join(workdir, "mlp")
    fused.save_checkpoint(prefix, 1)
    sym2, arg2, aux2 = mx.model.load_checkpoint(prefix, 1)
    now = fused.get_params()[0]
    out["checkpoint_differing"] = sum(
        _differing(torch, arg2[n]._data, now[n]._data) for n in now)
    out["checkpoint_same_graph"] = sym2.tojson() == fused.symbol.tojson()
    assert out["checkpoint_differing"] == 0 and out["checkpoint_same_graph"]
    _log("[module] %s" % json.dumps(out))
    return out


def _quartiles(np, ms):
    q = np.percentile(ms, [25, 50, 75])
    return {"p25": q[0], "median": q[1], "p75": q[2]}


def _module_ab(mx, np, torch, label, attr, parent):
    """An A/B on the Module MLP's fused route: LRT_AB_PAIRS pairs of
    MLP_STEPS steps of one Module, with the optimizer's ``attr`` as it is
    ("change") and replaced by ``parent(opt, original)`` ("parent"), the
    order alternating.  Step ms each."""
    mod = _mlp_module(mx)
    batch = _mlp_batch(mx, np)
    opt = mod._optimizer
    change = getattr(opt, attr)
    sides = {"parent": parent(opt, change), "change": change}
    _mlp_steps(mx, mod, "auto", batch, MLP_WARMUP)
    ms = {"parent": [], "change": []}
    for i in range(LRT_AB_PAIRS):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            setattr(opt, attr, sides[side])
            _, dt = _mlp_timed(mx, torch, mod, "auto", batch)
            ms[side].append(dt / MLP_STEPS * 1e3)
    delattr(opt, attr)
    out = {"pairs": LRT_AB_PAIRS, "steps": MLP_STEPS, "step_ms": ms,
           "change_wins": sum(c < p for c, p in zip(ms["change"],
                                                    ms["parent"]))}
    for side, v in ms.items():
        out[side] = _quartiles(np, v)
    _log("[%s] %s" % (label, json.dumps(out)))
    return out


def lr_t_ab(mx, np, torch):
    """Adam's ``lr_t`` cache A/B: with the cache ("change") and with it
    reset before every tensor's ``lr_t`` ("parent": the bias correction
    computed 18 times a step)."""
    def uncached(opt, cached):
        def fn(*args, **kw):
            opt._lr_t = (None, None)
            return cached(*args, **kw)
        return fn
    return _module_ab(mx, np, torch, "lr_t_ab", "_lr_t_of", uncached)


def launch_ab(mx, np, torch):
    """K3's one launch a step ("change") against one ``step_fused`` call,
    one launch, per tensor ("parent": the fused route before K3 took a
    list, 18 wrapper calls a step)."""
    def per_tensor(opt, _):
        def fn(weights, grads, states, lrs, wds, t, outs=None):
            for w, g, st, lr, wd in zip(weights, grads, states, lrs, wds):
                opt.step_fused(w, g, st, lr, wd, t, out_dtype=w.dtype,
                               out=(w, w, st))
        return fn
    return _module_ab(mx, np, torch, "launch_ab", "step_fused_multi",
                      per_tensor)


def _rtc_summary(name, rtc_out, ops_out):
    """A K7 line of the kernels table: user kernel ``name`` at RTC_SHAPE,
    its launches in phase 7(a) and, for add_one, 7(b)."""
    cases = rtc_out["cases"][name]
    top = cases[0]
    launches = {"7a": rtc_out["launches"].get(name, 0), "7b": 0}
    if name == "add_one":
        launches["7b"] = sum(ops_out[k][1].get("add_one", 0) for k in (
            "nd_launches", "record_launches", "executor_launches"))
    return {"name": "rtc_" + name, "route": "cuda",
            "source": "chip_smoke.py (RTC_SOURCE), compiled at run time "
                      "by NVRTC through mxnet_tpu_torch/rtc.py",
            "replaces": "mxnet_tpu/rtc.py:70",
            "launches": sum(launches.values()),
            "launches_by_phase": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "differing_elements": None if name == "row_sum_smem" else sum(
                c["differing_elements"] for c in cases),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "at": {"shape": top["shape"], "dtype": top["dtype"]},
            "nvrtc_compile_ms": rtc_out["compile_ms"], "cases": cases}


def _summary(name, source, replaces, cases, launches):
    """One line of the kernels table; its times are those of the largest
    shape it is checked at (B=4 S=2048 causal, or K=2048)."""
    top = max(cases, key=lambda c: c["bound_ms"])
    return {"name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_row_rel_err": max(c["max_row_rel_err"] for c in cases),
            "row_rel_tol": top.get("row_rel_tol", ROW_REL_TOL),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "at": top["shape"],
            "cases": cases,
            **{k: top[k] for k in ("device_ms", "library_event_ms",
                                   "library_device_ms", "ms_is", "event_ms",
                                   "bound_share", "vs_library",
                                   "bound_bytes", "gathered", "bound_is",
                                   "bound_ffma_ms", "bound_ffma_by",
                                   "pair_vs_library")
               if k in top}}


def _k6_summary(cases, replaces, launches):
    """K6's line of the kernels table, at its largest checked shape."""
    top = max(cases, key=lambda c: c["bound_ms"])
    return {"name": "scale_bias_relu", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/scale_bias_relu.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "differing_elements": sum(c["differing_elements"]
                                      for c in cases),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "at": {"shape": top["shape"], "dtype": top["dtype"]},
            "cases": cases}


def _spill_stores(ptxas):
    """{kernel (mangled name): bytes of spill stores} from a ptxas -v
    report."""
    found = dict(re.findall(r"Function properties for (\S+)\s+\d+ bytes "
                            r"stack frame, (\d+) bytes spill stores", ptxas))
    if len(found) != ptxas.count("bytes spill stores"):
        raise AssertionError("unread ptxas spill report: %s" % ptxas)
    return found


def _write_report(path, report):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write the full report (JSON) "
                    "to this path")
    ap.add_argument("--phase", choices=("all", "attention", "optimizer",
                                        "module", "bert", "lm_f32"),
                    default="all",
                    help="attention: the flash forward and backward checks "
                    "of phase 2 alone; optimizer: phase 2's K3 and K1 "
                    "checks alone; module: phase 7(c) alone, after the "
                    "lr_t A/B; bert: the flash checks at BERT's shapes "
                    "(bf16 and f32) and phase 4b alone; lm_f32: the f32 "
                    "flash checks at head dim 32 and phase 4c alone")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    from mxnet_tpu_torch.ops import _cudart
    try:
        import ml_dtypes
        ml_dtypes_version = ml_dtypes.__version__
    except ImportError:
        ml_dtypes_version = None
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "ml_dtypes": ml_dtypes_version,
              "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "nvrtc": "%d.%d" % _cudart.nvrtc_version(),
              "nvrtc_library": _cudart._LIBS["nvrtc"]._name}
    _log("[env] %s" % json.dumps(report))

    t0 = time.perf_counter()
    built = _build.build(
        {"attention": ["flash_fwd", "flash_bwd", "flash_f32", "paged_attn"],
         "optimizer": ["adam_step", "sgd_step"],
         "bert": ["flash_fwd", "flash_bwd", "flash_f32", "adam_step"],
         "lm_f32": ["flash_f32", "adam_step"]}.get(args.phase))
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "per_source_s": {k: v["seconds"]
                                        for k, v in built.items()},
                       "ptxas": {k: v["ptxas"] for k, v in built.items()}}
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if ("registers" in line or "spill" in line
                    or "arning" in line or "wgmma" in line):
                _log("[build] %s: %s" % (name, line.strip()))
    _log("[build] %s" % json.dumps({k: v for k, v in report["build"].items()
                                    if k != "ptxas"}))
    # the bf16 flash kernels' wgmma products read registers
    # asynchronously; a spilled register under one is not safe.
    # flash_f32.cu's mma.sync products are synchronous, but a spill in
    # their main loops would cost them their speed: the same gate holds
    # its three kernels at both head dims
    for name in ("flash_fwd", "flash_bwd", "flash_f32"):
        spills = {fn: int(n) for fn, n in _spill_stores(
            built.get(name, {}).get("ptxas", "")).items()}
        if any(spills.values()):
            raise AssertionError("%s.cu spills registers: %s\n%s"
                                 % (name, spills, built[name]["ptxas"]))
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    f32_keys = ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
    if args.phase == "attention":
        report["flash_fwd"] = check_flash(ck, torch, F)
        report["paged_decode_pool_bf16"] = check_paged(ck, torch, F, False)
        report["paged_decode_pool_int8"] = check_paged(ck, torch, F, True)
        report["flash_bwd_dq"], report["flash_bwd_dkv"] = check_flash_bwd(
            ck, torch, F)
        report["flash_fwd_f32"] = check_flash(
            ck, torch, F, F32_CASES + F32_D32_CASES, "float32")
        report["flash_bwd_dq_f32"], report["flash_bwd_dkv_f32"] = \
            check_flash_bwd(ck, torch, F, F32_BWD_CASES + F32_D32_CASES,
                            "float32")
        report["flash_bwd_f32_sweep"] = sweep_flash_bwd_f32(ck, torch)
        bad = [c for key in ("flash_fwd", "paged_decode_pool_bf16",
                             "paged_decode_pool_int8", "flash_bwd_dq",
                             "flash_bwd_dkv") + f32_keys
               for c in report[key] if not c["ok"]]
        _write_report(args.report, report)
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "optimizer":
        report["adam_step"], report["adam_per_step"] = check_adam(ck, torch)
        report["sgd_step"], report["sgd_per_step"] = check_sgd(ck, torch,
                                                                mx, np)
        _write_report(args.report, report)
        bad = [c for key in ("adam_step", "sgd_step") for c in report[key]
               if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "bert":
        bert_case = ((BERT_B, 12, False, BERT_S, BERT_S, 64),)
        report["flash_fwd"] = check_flash(ck, torch, F, bert_case)
        report["flash_bwd_dq"], report["flash_bwd_dkv"] = check_flash_bwd(
            ck, torch, F, bert_case)
        report["flash_fwd_f32"] = check_flash(ck, torch, F, F32_CASES,
                                              "float32")
        report["flash_bwd_dq_f32"], report["flash_bwd_dkv_f32"] = \
            check_flash_bwd(ck, torch, F, F32_BWD_CASES, "float32")
        report["flash_bwd_f32_sweep"] = sweep_flash_bwd_f32(ck, torch)
        bad = [c for key in ("flash_fwd", "flash_bwd_dq",
                             "flash_bwd_dkv") + f32_keys
               for c in report[key] if not c["ok"]]
        if bad:
            _write_report(args.report, report)
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["bert"] = bert(mx, ck, np, torch, card)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "lm_f32":
        report["flash_fwd_f32"] = check_flash(ck, torch, F, F32_D32_CASES,
                                              "float32")
        report["flash_bwd_dq_f32"], report["flash_bwd_dkv_f32"] = \
            check_flash_bwd(ck, torch, F, F32_D32_CASES, "float32")
        bad = [c for key in f32_keys for c in report[key] if not c["ok"]]
        if bad:
            _write_report(args.report, report)
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["lm_f32"] = train_lm_f32(mx, ck, np, torch, card)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "module":
        report["lr_t_ab"] = lr_t_ab(mx, np, torch)
        report["launch_ab"] = launch_ab(mx, np, torch)
        report["module"] = train_module(mx, ck, np, torch, card, workdir)
        print(json.dumps(report))
        return 0

    flash = check_flash(ck, torch, F)
    paged = check_paged(ck, torch, F, quant=False)
    paged8 = check_paged(ck, torch, F, quant=True)
    bwd_dq, bwd_dkv = check_flash_bwd(ck, torch, F)
    flash32 = check_flash(ck, torch, F, F32_CASES + F32_D32_CASES,
                          "float32")
    bwd_dq32, bwd_dkv32 = check_flash_bwd(
        ck, torch, F, F32_BWD_CASES + F32_D32_CASES, "float32")
    report["flash_bwd_f32_sweep"] = sweep_flash_bwd_f32(ck, torch)
    adam, adam_step = check_adam(ck, torch)
    sgd, sgd_step = check_sgd(ck, torch, mx, np)
    k5f, k5b = check_row_softmax(ck, torch)
    k6 = check_scale_bias_relu(ck, torch)
    bad = [c for c in flash + paged + paged8 + bwd_dq + bwd_dkv + flash32
           + bwd_dq32 + bwd_dkv32 + adam + sgd + k5f + k5b + k6
           if not c["ok"]]
    if bad:
        raise AssertionError("kernel disagrees with its plain version: %s"
                             % json.dumps(bad))

    report["serve"] = serve(mx, ck, np, torch, workdir)
    report["train"] = train(mx, ck, np, torch)
    report["bert"] = bert(mx, ck, np, torch, card)
    report["lm_f32"] = train_lm_f32(mx, ck, np, torch, card)
    report["resnet"] = train_resnet(mx, ck, np, torch, card)
    report["tape"] = tape(mx, ck, np, torch)
    report["lenet"] = train_lenet(mx, ck, np, torch, card)
    report["f16"] = train_f16(mx, ck, np, torch)
    report["rtc"], rtc_kernels = check_rtc(mx, ck, torch)
    report["rtc_ops"] = rtc_ops(mx, ck, torch, rtc_kernels)
    report["module"] = train_module(mx, ck, np, torch, card, workdir)
    module_adam = report["module"]["fused"]["launches"]["adam_step"]
    resnet_adam = report["resnet"]["adam"]["launches"]["adam_step"]
    f16_adam = report["f16"]["adam"]["launches"]["adam_step"]
    f16_sgd = report["f16"]["sgd"]["launches"]["sgd_step"]
    launches = report["serve"]["greedy"]["launches"]
    taped = report["tape"]["launches"]
    trained = report["train"]["launches"]
    berted = report["bert"]["launches"]
    bert32 = report["bert"]["f32"]["launches"]
    bert_adam = report["bert"]["adam"]["launches"]["adam_step"]
    lm32 = report["lm_f32"]["on"]["launches"]
    pk = "mxnet_tpu/ops/pallas_kernels.py:"
    kernels = [
        _summary("flash_fwd", "flash_fwd.cu", pk + "157", flash,
                 launches["flash_fwd"]),
        _summary("flash_bwd_dq", "flash_bwd.cu", pk + "190", bwd_dq,
                 trained["flash_bwd_dq"]),
        _summary("flash_bwd_dkv", "flash_bwd.cu", pk + "220", bwd_dkv,
                 trained["flash_bwd_dkv"]),
        _summary("flash_fwd_f32", "flash_f32.cu", pk + "157", flash32,
                 bert32["flash_fwd_f32"] + lm32["flash_fwd_f32"]),
        _summary("flash_bwd_dq_f32", "flash_f32.cu", pk + "190", bwd_dq32,
                 bert32["flash_bwd_dq_f32"] + lm32["flash_bwd_dq_f32"]),
        _summary("flash_bwd_dkv_f32", "flash_f32.cu", pk + "220", bwd_dkv32,
                 bert32["flash_bwd_dkv_f32"] + lm32["flash_bwd_dkv_f32"]),
        _summary("paged_decode_pool_bf16", "paged_attn.cu", pk + "386",
                 paged, launches["paged_decode_pool_bf16"]),
        _summary("paged_decode_pool_int8", "paged_attn.cu", pk + "386",
                 paged8, report["serve"]["int8"]["launches"][
                     "paged_decode_pool_int8"]),
        {"name": "adam_step", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/adam_step.cu",
         "replaces": pk + "518",
         "launches": (trained["adam_step"] + module_adam + f16_adam
                      + resnet_adam + bert_adam + lm32["adam_step"]),
         "launches_by_path": {"train": trained["adam_step"],
                              "module_mlp": module_adam,
                              "f16_trainer": f16_adam,
                              "resnet_spmd_adam": resnet_adam,
                              "bert_adam": bert_adam,
                              "lm_f32": lm32["adam_step"]},
         "max_abs_err": max(c["max_abs_err"] for c in adam),
         "differing_elements": sum(sum(c["differing_elements"].values())
                                   for c in adam),
         "ms": adam_step["ms"], "device_ms": adam_step["device_ms"],
         "call_ms": adam_step["call_ms"],
         "plain_ms": adam_step["plain_ms"],
         "bound_ms": adam_step["bound_ms"],
         "bound_by": adam_step["bound_by"],
         "bound_share": adam_step["bound_share"],
         "library_ms": adam_step["library_ms"],
         "library_device_ms": adam_step["library_device_ms"],
         "vs_library": adam_step["vs_library"], "at": adam_step["at"],
         "cases": adam},
        {"name": "sgd_step", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/sgd_step.cu",
         "replaces": pk + "495",
         "launches": report["resnet"]["launches"]["sgd_step"] + f16_sgd,
         "launches_by_path": {"resnet": report["resnet"]["launches"][
             "sgd_step"], "f16_trainer": f16_sgd},
         "max_abs_err": max(c["max_abs_err"] for c in sgd),
         "differing_elements": sum(sum(c["differing_elements"].values())
                                   for c in sgd),
         "ms": sgd_step["ms"], "call_ms": sgd_step["call_ms"],
         "device_ms": sgd_step["device_ms"],
         "plain_ms": sgd_step["plain_ms"],
         "bound_ms": sgd_step["bound_ms"], "bound_by": sgd_step["bound_by"],
         "library_ms": sgd_step["library_ms"],
         "library_device_ms": sgd_step["library_device_ms"],
         "at": sgd_step["at"], "cases": sgd},
        _summary("row_softmax_fwd", "row_softmax.cu", pk + "66", k5f,
                 taped["row_softmax_fwd"]),
        _summary("row_softmax_bwd", "row_softmax.cu", pk + "80", k5b,
                 taped["row_softmax_bwd"]),
        _k6_summary(k6, pk + "620",
                    report["tape"]["sbr_launches"]["scale_bias_relu"]),
    ] + [_rtc_summary(name, report["rtc"], report["rtc_ops"])
         for name in RTC_SIGNATURES]
    # the bf16 flash kernels run on several paths: their launches in each
    # counted run
    kernels[0]["launches_by_path"] = {"serve_greedy": launches["flash_fwd"],
                                      "train": trained["flash_fwd"],
                                      "bert": berted["flash_fwd"]}
    for kern in kernels[1:3]:
        kern["launches_by_path"] = {"train": trained[kern["name"]],
                                    "bert": berted[kern["name"]]}
    for kern in kernels[3:6]:
        kern["launches_by_path"] = {"bert_f32": bert32[kern["name"]],
                                    "lm_f32": lm32[kern["name"]]}
    report["kernels"] = kernels
    _write_report(args.report, report)
    print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                   if k != "cases"} for s in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — report and fail the run
        import traceback
        traceback.print_exc()
        print("chip_smoke: FAILED (%s: %s)" % (type(exc).__name__, exc),
              file=sys.stderr)
        sys.exit(1)
