"""On-card smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one H100.

Usage (from the root of a checkout, one visible CUDA card)::

    python3 chip_smoke.py [--report PATH]
                          [--phase attention|optimizer|module|bert|lm_f32|
                                   generation|ops|zoo|rnn|data|ssd|
                                   predict|dist|mesh|shard|resilience|
                                   observe|cost] [--ab-csrc DIR]

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
            two ragged shapes; all three at head dim 16 at F32_D16_CASES,
            generation_config's prefill B=1 H=2 causal S = 8, 16, 32 and
            B=8 H=2 S=1024 causal; per row at F32_ROW_REL_TOL
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
            route's device time; and with an f32 query at
            PAGED_F32_CASES, generation_config's decode shapes D=16 H=2
            pages of 8, B = 4 and 8 at widths 1, 2 and 4, and the
            full-width shapes, over f32 pages and over int8 pages with
            f32 scales, per row at PAGED_F32_ROW_REL_TOL of the row's
            absolute sum, sdpa in f32 beside the f32 pages), the flash
            backward K2dq and K2dkv
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
            against the row's largest term); K6 bitwise.  Then the NaN
            cases (``check_nan``): a NaN in one q row, in key 0 of K and
            of V, and in the last row of dO, for K2f (bf16; f32 at D =
            16, 32, 64), K2dq/K2dkv in both types, K4 (bf16 and f32
            queries over their own pages and int8 pages, pool and
            gathered forms, and a row with no key) and K5f/K5b: the NaN
            positions those of the plain version, the other rows within
            the contract above; and each kernel the NaN repair changed
            timed at its PERF.md section-6 shape (SECTION6_SHAPES).
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
3b. generation — f32 serving with the tier on throughout. (a)
            ``bench.py`` ``generation_config`` as bench.py writes it: its
            f32 model (vocab 89, 2 layers, d_model 32, 2 heads of 16, d_ff
            64, context 32, pages of 8; bench.py's numpy init, seed 0,
            pos_embed x25) and its traffic (RandomState(7)): scenario 1,
            GEN_REQUESTS requests over its length mix, static batch 1
            (``GenerationPredictor.generate`` in turn) against continuous
            batching through ``Server`` at 4 slots; scenario 2, 8 x
            GEN_REQUESTS requests of a 24-token system prompt, one
            divergent token and 7 new tokens at 8 slots, an f32-page
            baseline (shared prefix off, a pool of one request) against
            int8 pages at twice the page count with shared-prefix reuse
            (the int8 artifact exported with sampling, int8 KV and decode
            batch 8).  K4's split count comes from
            ``cuda_kernels.paged_splits``: the reference's
            ``autotune.search_paged`` has no counterpart yet.  (b) the
            full-width TransformerLM in f32 (``TransformerLMConfig``
            defaults with dtype f32, seeded weights) through
            export_generation -> Server: LM32_SERVE_REQUESTS greedy
            requests at once (prompts 17..1500, LM32_SERVE_NEW new tokens)
            and a short int8-KV run.  Launch counts and telemetry are
            zeroed just before each counted run and read just after:
            every prefill layer ran flash_fwd_f32 and every decode layer
            one f32-query K4 of the run's page dtype
            (paged_decode_pool_f32 or paged_decode_pool_int8_f32q), and
            nothing else.  Every greedy stream is held against the
            tier-off plain route (prefill + decode_step over its own page
            pool of the run's dtype), teacher-forced, near-ties below
            LOGIT_MARGIN_TOL excused.  Scenario 2 must show prefix hits,
            the baseline's in-use pages peaking at its pool, the paged
            route counted on every decode layer and every page free at
            the end.  Prints tokens/s, TTFT p50/p99, decode-step p50/p99,
            the scenarios' ratios beside bench.py's "continuous > static"
            and ">= 1.5x" as predictions (not gates: host-bound timings),
            and the device-idle share of a profiled continuous burst.
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
5b. zoo   — the model zoo (``vision.get_model(name, classes=1000)`` at
            published widths, seeded Xavier weights).  (a)
            ``examples/benchmark_score.py``: each of ZOO_NETS (alexnet,
            vgg16, vgg16_bn, squeezenet1.0 at 227x227, inceptionv3 at
            299x299, densenet121, mobilenet1.0, mobilenetv2_1.0 and
            resnet50_v1) through ``functionalize`` with
            ``training=False``: its f32 logits at batch ZOO_GATE_BATCH on
            the card within ZOO_LOGIT_RTOL of the port's CPU forward from
            the same weights, then img/s at batches 1, 16 and 32 in f32
            and in bf16 (parameters and input cast), ZOO_ITERS calls
            after a warm one, ended by a forced fetch.  (b)
            ``examples/train_imagenet.py --benchmark 1`` for vgg16 and
            inceptionv3 (299x299): SPMDTrainer at BS 128, bf16 over f32
            masters, SGD lr 0.1 momentum 0.9 wd 1e-4, synthetic data on
            the card; the first step's bf16 loss against an f32 copy
            (RESNET_BF16_LOSS_RTOL), one warm step, one step's K1 update
            bitwise against its plain version on the real gradients (for
            VGG-16 also K1's time over its 32 tensors, 138 M parameters,
            beside its byte bound, the plain version and
            ``torch.optim.SGD(fused=True)``), ZOO_TRAIN_STEPS counted
            steps with exactly one sgd_step launch each and no other
            kernel of the port, finite losses (VGG-16's diverge at this
            learning rate, the reference's too: ZOO_DIVERGES records
            them); img/s, step ms, peak
            memory and the idle share of a profiled window of 3 steps.
            VGG-16's Dropout draws its mask with no synchronising call
            (``set_sync_debug_mode("error")`` set by each Dropout's
            forward pre-hook) and a profiled step copies nothing of
            ZOO_HTOD_LIMIT bytes or more to the card.
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
7b. ops    — the op library (ops/tensor, nn, misc, linalg, random_ops,
            optim_ops, spatial, signal), no kernel of the port on its
            path: (a) every OP_CASES case through ``mx.nd`` on the card
            and on the CPU from the same inputs and seeded head
            gradient, and every CONTROL_FLOW_CASES case (``foreach``,
            ``while_loop``, ``cond`` of ``mx.nd.contrib``, recording and
            not), outputs and gradients compared (EXACT_OPS bit for bit, f32 at OPS_RTOL /
            OPS_ATOL, bf16 at OPS_BF16_RTOL of the tensor's largest);
            every sampler at SAMPLER_DRAWS draws: the CPU's dtype, the
            same bits from one seed twice, mean and variance within
            SAMPLER_SIGMAS standard errors; (b) the ops at TransformerLM
            and ResNet-50 widths (OPS_* shapes) against the CPU, timed by
            CUDA events beside one PyTorch call where there is one, and
            Dropout's mask drawn on the card (kept fraction, kept values
            x / 0.9 in bf16, one seed's bits twice, no host-to-device
            copy over 1 MB in a profiled call); (c) the multi-tensor
            update ops over resnet50_v1's 193 and the TransformerLM's 9
            tensors, within OPS_UPDATE_TOL of the CPU, bf16 weights the
            casts of their masters, beside K1's and K3's call and launch
            over the same lists.  No kernel of the port launches in
            (a)-(b).
7c. rnn    — the recurrent family: (a) ``mx.nd.RNN`` on the card against
            the CPU in every mode, 1 and 2 layers, one- and
            two-directional, at T=35 B=32 I=H=650 (RNN_OP_CASES;
            outputs, states and every gradient within RNN_OP_RTOL of the
            tensor's largest; a ReLU case with units at the kink held in
            f64), then the op timed beside one ``torch.nn.LSTM`` call
            (CUDA events; the blob's repack by the profiler's groups);
            (b) ``examples/rnn_lm.py`` at LM_* (20 counted steps, no
            port kernel, a falling finite loss, tokens/s, a profiled
            window); (c) ``examples/rnn_bucketing.py`` through
            ``BucketingModule`` at BK_*, unrolled and fused: a step with
            K3 bitwise against its plain version on its real gradients,
            then BK_STEPS counted steps across the three buckets with
            exactly one adam_step launch each, step ms by bucket and a
            profiled window.  It opens with ``profiler_probe``.
7d. data   — the data pipeline and the rest of the training API: (a)
            ``examples/train_imagenet.py``'s record-file path: DATA_BATCHES
            x DATA_BATCH seeded DATA_SIDE^2 images written as NPYF
            records, ``mx.io.ImageRecordIter`` (shuffled with its seed,
            DATA_DECODE_WORKERS decode threads) into resnet50_v1 through
            ``SPMDTrainer`` SGD, bf16 over f32 masters, DATA_EPOCHS
            epochs bare and as many through ``io.DevicePrefetcher``
            (exactly one sgd_step launch a step, the two runs' losses
            equal, the prefetched batches staged on its thread: io.h2d_async
            two a batch, io.h2d_sync none), each epoch ending in
            ``save_checkpoint``; K1 bitwise against its plain version on
            the record-fed gradients; the same trainer on one device batch
            (the synthetic rate) and a profiled record-fed window; then a
            fresh trainer loads the first epoch's checkpoint and its next
            step's loss, weights and momenta must be bitwise the
            uninterrupted run's (cuDNN deterministic, no benchmark, for
            (a) and (d)); (b) ``bench.py`` ``input_pipeline_config``
            (PIPE_*: its MLP through ``SPMDTrainer`` SGD, K1 once a step)
            through ``PrefetchingIter`` and ``DevicePrefetcher``,
            samples/s of each; (c) every registered optimizer on
            ``examples/rnn_lm.py``'s model at LM_* for OPT_STEPS steps
            through ``gluon.Trainer`` with ``multi_precision`` (SGD and
            ccSGD one sgd_step, Adam one adam_step a parameter a step,
            the others none), finite losses, then one more update on the
            card against the CPU's from the same weights, gradients and
            states (bitwise; OPT_REDUCING at OPT_RTOL), and ccSGD on the
            Module MLP through ``Module.init_optimizer`` (one sgd_step a
            fused step); (d) resnet50_v1 through ``export(fmt="mxnet")``
            and ``mx.model.load_checkpoint`` into a ``SymbolBlock``:
            logits on the card bitwise the source network's.
7e. ssd    — SSD-512 and the detection ops: (a)
            ``examples/ssd_train.py --size 512`` on its synthetic batches
            (``synthetic_batch``, ``RandomState(0)``): ssd_512 over
            SSD_CLASSES classes, Xavier, ``MultiBoxLoss``,
            ``gluon.Trainer`` SGD (SSD_LR, momentum 0.9,
            ``multi_precision`` so that each f32 weight takes K1), batch
            SSD_BATCH; one step's targets on the card against the CPU's
            from the same ``cls_preds`` (DET_RTOL) and its loss against
            the CPU's from the same weights and batch (SSD_LOSS_RTOL);
            SSD_STEPS counted steps with exactly SSD_TENSORS sgd_step
            launches a step, finite losses, K1 bitwise on the last
            gradients, step ms, img/s, a profiled window and
            ``MultiBoxTarget``'s device time; (b) the same from
            SSD_REC_IMAGES NPYF detection records through
            ``mx.io.ImageDetRecordIter`` (every label batch the rows
            written, padded with -1); (c) ``net.detect`` on the inference
            batch of SSD_DETECT_BATCH (65,280 anchors): exactly one
            box_nms launch, the call's time (the median of DETECT_REPEATS
            warm calls), and the NMS kernel bitwise with its plain version
            from the same sorted rows there, at the dense end (every one
            of 65,280 rows valid; by class, and class-agnostic as
            id_index -1 gives: one segment past a block's shared memory),
            in the small cases (ties, invalid rows, topk, force_suppress,
            id_index -1, IoUs exactly at the threshold, class ids -0.0 and
            NaN) and in ``Proposal`` at PROPOSAL_* (6000 rows), each also
            with segments chunked at NMS_CHUNKED_ROWS; with its times
            (events and device time of the call, the segment sort and the
            kernel alone), the IoUs it computed beside the ones the scan
            needs, its peak scratch, a call under
            ``set_sync_debug_mode("error")``, the plain version's time and
            its bound (NMS_PAIR_OPS for each of the fewest IoUs any scan
            needs, at PEAK_F32_FLOPS); (d) every detection op of
            ``det_cases`` at its small and its realistic shape, card
            against CPU within DET_RTOL.
8. predict — one-shot serving, no kernel of its own (the reference's
            int8 products are XLA's, not Pallas'): (a) resnet50_v1 at
            full width (1000 classes, PRED_HW, f32, seeded as
            ``one_config``) through ``deploy.export_model`` ->
            ``load_model`` on the card, held against the same net's
            eager forward on the card (PRED_EAGER_TOL) and the port on
            the CPU (PRED_CPU_TOL); PRED_SEQUENTIAL batch-1 ``predict``
            calls; then a ``Server`` (PRED_MAX_BATCH, PRED_DELAY_MS)
            taking PRED_REQUESTS seeded requests of 1-4 rows from
            PRED_THREADS threads: requests/s, img/s, queue-delay p99,
            mean batch fill, dispatch p50/p99, a profiled window's idle
            share, and every served row against its batch-1 ``predict``
            (PRED_ROW_BOUND); (b) the same net calibrated (entropy,
            PRED_CALIB_BATCHES batches of PRED_BATCH), exported int8
            with PRED_EXCLUDED excluded (``quant.error_budget`` holds),
            loaded ``quantized=True`` and served the same traffic: the
            same numbers, ``measured_error``,
            ``serving.quantized_dispatches``, the ``_int_mm`` products
            equal to the recolored sites x dispatches, a profiled int8
            forward with no ``aten::convolution`` and no convolution
            kernel beyond the excluded sites', and two sites' int32
            accumulators on the card bitwise against the plain version
            on the CPU; (c) ``bench.py`` ``serving_config`` and
            ``quantized_serving_config`` through the port at their sizes
            (BENCH_SRV_*): continuous over sequential, int8 over f32.
9. dist   — scale-out and the row-sparse embedding, no kernel of its own
            (the reference's 2-bit codec and dedup are XLA ops): (a)
            ``bench.py`` ``dlrm_embedding_config`` at its sizes (DLRM_*:
            a 1,000,000 x 32 table, 256 x 8 Zipf ids) on one rank,
            sparse route and dense route, DLRM_STEPS counted steps each
            (K1 once a step; ``capacity`` rows touched a step), the
            routes' weights within DLRM_ROUTE_ATOL, untouched rows
            bitwise, a sparse step's peak memory under the table's
            bytes, samples/s over DLRM_TIMED_STEPS steps, a profiled
            window; row-sparse Adam at DLRM_SMALL_VOCAB rows (K3) card
            against CPU within DLRM_CARD_CPU_ATOL; (b) two gloo ranks
            sharing cuda:0, started by ``python -m
            mxnet_tpu_torch.launch`` running this script with
            ``--dist-worker``: the dist_sync contract on CUDA tensors,
            the vocab-sharded lookup bitwise the one-rank lookup,
            DLRM_SMALL_STEPS sharded steps within DLRM_RANKS_ATOL of one
            rank, the 2-bit compressed step on ``{"dcn": 2}`` bitwise
            card against CPU (codes and residuals), and which
            collectives gloo takes on CUDA tensors (GLOO_PROBES); (c) a
            world-size-1 ``nccl`` group (``--nccl-worker``, beside (b))
            and one ``all_reduce``.
9b. mesh  — tensor, sequence, pipeline and expert parallelism
            (``mesh_phase``): two gloo ranks on cuda:0 run (a) every
            collective of ``parallel.collectives`` on CUDA tensors with
            its route, (b) BERT-base at tp=2 (6 local heads through the
            bf16 flash kernels, phase 4b's gradient gate, the f32 model
            at 2 layers against one rank) and (e) SPMDTrainer with
            param_specs (K1 over the blocks, bitwise with one rank);
            four run (c) the TransformerLM over {dp 1, tp 2, sp 2} and
            (d) the dryrun's pipelined MoE step; one NCCL rank runs (f)
            every new module over axes of one rank, bitwise the result
            without a mesh.
9c. shard — BatchNorm over the ranks, sharded serving, BERT over sp and
            several contexts (``shard_phase``): two gloo ranks on cuda:0
            run (a) ResNet-50 over two ranks of 64 rows with BatchNorm
            over both (gradients and moving statistics against one rank,
            the statistics bitwise alike across ranks, one K1 launch a
            step a rank, an f32 run against one rank), (b) the serve
            phase's TransformerLM at tp=2 with bf16 and int8 pages (12
            K2f launches a prefill and 12 K4 launches a decode step a
            rank at 6 heads, logits against one rank teacher-forced),
            (c) BERT-base over sp=2 (phase 4b's gradient gate, 5 steps);
            then (d) placement in this process: a ctx_group graph and a
            Gluon Dense stack on gpu(0) and cpu(), a Module over
            [gpu(0), gpu(0)].
9d. resilience — the non-finite step guard, checkpoints, preemption and
            elasticity (``resilience_phase``): (a) K1 over ResNet-50's
            193 tensors and K3 over the Module MLP's 18 with the skip
            word (0: bitwise the word-less launch and the plain version;
            1: no byte written), f32 and bf16 grads, device time with and
            without the word, the all-finite reduction against the host;
            (b) ResNet-50 at BS 32 under nanguard=skip with a NaN batch,
            twice: a baseline, and a chaos run with io and ckpt_write
            faults, a CheckpointManager, a real SIGTERM, the newest file
            truncated and a new trainer resuming — losses and final
            state bitwise alike, one K1 launch a step, no write on the
            NaN step, no added synchronizing call on guarded finite
            steps; (c) the Module MLP under nanguard=abort through K3;
            (d) two gloo ranks on cuda:0 under the elastic launcher: a
            peer preemption, a coordinated checkpoint, generation 1
            resuming bitwise, a sharded checkpoint round trip at tp=2.
9f. cost  — serving and cost observability (``cost_phase``): (a) the
            full-width TransformerLM served (8 slots, 1024 pages of 16,
            16 greedy requests of 17..1500 tokens, 32 new), every new
            knob on (the exporter on port 0, the access log, SLOs, both
            sinks, the watchdog) beside off in COST_AB_PAIRS alternating
            pairs: /metrics parses, /healthz 200, one ok access record a
            request found in the Chrome trace, the serving.submit and
            serving.dispatch spans, one mx.perf record a prefill bucket
            and decode width (prefill FLOPs within COST_FLOPS_RTOL of the
            analytic count), the same launches and streams on and off,
            decode-step p50 each way; (b) the engine's loop held: the
            watchdog report holds its stall-probe snapshot, /healthz
            non-200 while held and 200 after; (c) the int8 ResNet-50 at
            quant.drift_every=4: a drift gauge a stats site, the twin's
            amaxes those of the float forward's site inputs; (d)
            mx.autotune measuring K4's keys per split, K1's and K3's
            chunk and K2f into a fresh cache, every candidate within its
            contract, the winners read back, applied and bitwise; (e)
            ``kernels.measure`` on K2f at the training shape (its FLOPs
            the analytic causal count); (f) ``perf.profile=step:2`` over
            6 TransformerLM steps: a capture folded with the span trace,
            valid step records with flops and mfu.
10. summary — a ``{"kernels": [...]}`` line, the card's name and power
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

``--phase generation`` builds ``flash_f32.cu`` and ``paged_attn.cu``,
runs phase 2's f32 flash checks at head dim 16 (F32_D16_CASES) and its
f32-query paged checks (PAGED_F32_CASES), then phase 3b alone, and
prints its report as one JSON line.

``--phase ops`` builds K1 and K3 and runs phase 7b alone, and prints
its report as one JSON line.

``--phase zoo`` builds K1 and runs phase 5b alone, and prints its report
as one JSON line.

``--phase rnn`` builds K3 and runs phase 7c alone, and prints its
report as one JSON line, then the card's line and the ok line.

``--phase ssd`` builds K1 and the NMS kernel, runs phase 2's K1
checks and phase 7e alone, and prints the kernels line of K1 and the
NMS kernel, then the card's line and the ok line.

``--phase data`` builds K1 and K3 and runs phase 7d alone, and prints
its report as one JSON line, then the card's line and the ok line.

``--phase predict`` builds nothing and runs phase 8 alone, and prints
its report as one JSON line, then the card's line and the ok line.

``--phase dist`` builds K1 and K3, runs phase 2's K3 and K1 checks and
phase 9 alone, and prints the kernels line of K3 and K1, then the card's
line and the ok line.

``--phase mesh`` builds the bf16 flash sources, ``flash_f32.cu`` and
K1, checks the flash kernels at phase 9b's per-rank shape
(MESH_FLASH_CASES, bf16 and f32) and K1 at (e)'s per-rank shapes, runs
phase 9b alone, and prints the kernels line of the six flash kernels
and K1, then the card's line and the ok line.

``--phase shard`` builds K2f, K4 and K1, checks K2f and K4 at phase
9c's per-rank serving shapes (``shard_kernel_cases``) and K1 at
ResNet-50's, runs phase 9c alone, and prints the kernels line of K2f,
both K4 variants and K1, then the card's line and the ok line.

``--phase resilience`` builds K1 and K3, runs phase 2's K3 and K1
checks and phase resilience alone, and prints the kernels line of K3 and
K1, then the card's line and the ok line.

``--phase attention --ab-csrc DIR`` also builds the kernels the NaN
repair changed from DIR (a checkout of the parent commit, unpacked under
``build/``), runs the NaN cases on them (not a gate: how many disagree
is the fault), and times each changed kernel at its section-6 shape in
both versions, in the order this, other, other, this.

``--phase cost`` builds K2f, K2dq/K2dkv, K4, K1 and K3, runs their
phase-2 checks at the serving and training shapes and phase 9f alone,
and prints the kernels line of those kernels, the card and ok lines.

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
import contextlib
import json
import math
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


_T0 = time.perf_counter()


def _log(msg):
    """A log line, stamped with the seconds since the script started."""
    print("[%7.1f s] %s" % (time.perf_counter() - _T0, msg), flush=True)


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
    card waits for the host.  A window that records no CUDA activity (the
    profiler now and then drops one) is taken again, up to three times;
    None when none of them records any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / iters
    return None


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
#: the f32 kernels' checks at head dim 16, forward and backward:
#: generation_config's prefill (B=1, 2 heads of 16, causal, its buckets
#: S = 8 and 16 and its context 32; bench.py:1153-1155) and B=8 S=1024
#: causal, past one tile of every kind
F32_D16_CASES = tuple((1, 2, True, s, s, 16) for s in (8, 16, 32)) + (
    (8, 2, True, 1024, 1024, 16),)
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


#: (B, H, width in pages, page size, D) of the bf16 paged decode checks:
#: one and eight decode slots at widths of 1, 32 and 128 pages of
#: PAGE_SIZE (the serving widths' ends and middle), 12 heads of 64
PAGE_SIZE = 16
PAGED_CASES = tuple((b, 12, w, PAGE_SIZE, 64) for b, w in (
    (1, 1), (1, 32), (1, 128), (8, 1), (8, 32), (8, 128)))
#: the f32-query paged decode checks (f32 pages, and int8 pages under an
#: f32 query): generation_config's decode shapes (2 heads of 16, pages of
#: 8, 4 and 8 slots at widths 1, 2 and 4; bench.py:1153-1155) and the
#: full-width f32 TransformerLM's (as PAGED_CASES)
PAGED_F32_CASES = tuple((b, 2, w, 8, 16) for b in (4, 8)
                        for w in (1, 2, 4)) + PAGED_CASES
#: the f32 variants against their plain version, per output row: max
#: |kernel - plain| over the row's absolute sum sum_j p_j |v_j| / l.  Both
#: sides compute in f32 (FFMA and f32 matmuls: no TF32), so they differ
#: only in summation order, a few ulps of the absolute sum: 2^-16 leaves
#: 2^8 ulps of room.  A dropped or doubled key of weight p moves a row by
#: p |v|, far above it.
PAGED_F32_ROW_REL_TOL = 2.0 ** -16
_PAGED_KINDS = {("bfloat16", False): "bf16", ("bfloat16", True): "int8",
                ("float32", False): "f32", ("float32", True): "int8_f32q"}


def _pool_inputs(torch, quant, case, g, qdtype="bfloat16"):
    """A pool of one layer ([pool, psz, H, D]; KV_PAGES pages, or B x W
    when more) in ``qdtype`` or int8 with f32 scales, a shuffled page
    table whose entries past each sequence's length are the sentinel (the
    pool size), and ragged lengths (one full width, one single position
    when B > 1)."""
    from mxnet_tpu_torch.quantization import quantize_rows
    B, H, W, psz, D = case
    P = max(KV_PAGES, B * W)
    dt = getattr(torch, qdtype)
    kp = torch.randn(P, psz, H, D, generator=g, device="cuda")
    vp = torch.randn(P, psz, H, D, generator=g, device="cuda")
    q = torch.randn(B, H, 1, D, generator=g, device="cuda").to(dt)
    perm = torch.randperm(P, generator=g, device="cuda")[:B * W]
    perm = perm.reshape(B, W).int()
    lens = torch.randint(1, W * psz + 1, (B,), generator=g,
                         device="cuda").int()
    lens[0] = W * psz
    if B > 1:
        lens[-1] = 1
    first = torch.arange(W, device="cuda")[None, :] * psz
    table = torch.where(first < lens[:, None], perm,
                        torch.full_like(perm, P))
    if quant:
        kq, ks = quantize_rows(kp)
        vq, vs = quantize_rows(vp)
        return q, kq, vq, table, lens, {"k_scale_pool": ks,
                                        "v_scale_pool": vs}
    return q, kp.to(dt), vp.to(dt), table, lens, {}


def check_paged(ck, torch, F, quant, cases=PAGED_CASES, qdtype="bfloat16"):
    """K4 at ``cases`` with a ``qdtype`` query over pages of that dtype or
    int8 (``quant``), pool form (the decode path's entry) and gathered
    form (``paged_attention``, the reference-shaped entry, over the same
    context gathered): each against ``paged_attention_pool_plain`` per
    row (bf16: ROW_REL_TOL of the row's largest |o|; f32:
    PAGED_F32_ROW_REL_TOL of the row's absolute sum), a second launch
    giving the same bits.  Times: device time of the pool form, of the
    gathered form alone, of the route before this kernel read the pool
    (gather + transpose of K, V (and scales) + the gathered form), and of
    sdpa over the gathered tensors in the query's dtype (none for int8
    pages); the bound counts the bytes of the valid keys."""
    cases_out = []
    kind = _PAGED_KINDS[(qdtype, bool(quant))]
    f32 = qdtype == "float32"
    qbytes = 4 if f32 else 2
    g = torch.Generator(device="cuda").manual_seed(
        SEED + 1 + int(quant) + 2 * int(f32))
    for case in cases:
        B, H, W, psz, D = case
        q, kp, vp, table, lens, kw = _pool_inputs(torch, quant, case, g,
                                                  qdtype)
        K = W * psz

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
        if f32:
            # the row's absolute sum: the plain version over |v| (the
            # int8 scales are positive)
            absum = ck.paged_attention_pool_plain(q, kp, vp.abs(), table,
                                                  lens, **kw)
            tol = PAGED_F32_ROW_REL_TOL
            row_err = _abs_row_err(torch, o, po, absum)
            g_err = _abs_row_err(torch, og, po, absum)
        else:
            tol = ROW_REL_TOL
            row_err = _row_rel_err(o, po)
            g_err = _row_rel_err(og, po)
        same = _same_bits(torch, o, o2)
        g_same = _same_bits(torch, og, og2)
        ok = (row_err <= tol and g_err <= tol and same and g_same
              and o.dtype == q.dtype and og.dtype == q.dtype
              and bool(torch.isfinite(o.float()).all()))
        n_valid = int(lens.sum()) * H
        elem = 1 if quant else qbytes
        nbytes = (n_valid * D * 2 * elem + (n_valid * 2 * 4 if quant else 0)
                  + 2 * qbytes * B * H * D + 4 * B * W + 4 * B)
        bound, by = _bound_ms(nbytes, 4 * D * n_valid,
                              PEAK_F32_FLOPS if f32 else None)
        per, splits = ck.paged_splits(B * H, K)
        case = {
            "shape": {"B": B, "H": H, "pages": W, "page_size": psz,
                      "K": K, "D": D, "lengths": [int(x) for x in
                                                  lens.tolist()],
                      "q": qdtype, "kv": "int8" if quant else qdtype,
                      "splits": splits, "keys_per_split": per},
            "max_abs_err": float((o.float() - po.float()).abs().max()),
            "max_row_rel_err": row_err, "row_rel_tol": tol,
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
        _log("[kernels] paged_decode_pool_%s %s" % (kind, json.dumps(case)))
        cases_out.append(case)
        del q, kp, vp, kc, vc, gkw, kw
        torch.cuda.empty_cache()
    return cases_out


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
        # the line over the points the profiler recorded
        pts = [(x, y) for x, y in zip(F32_SWEEP_TILES, times)
               if y is not None]
        slope = fixed = None
        if len(pts) >= 2:
            mx_ = sum(x for x, _ in pts) / len(pts)
            my = sum(y for _, y in pts) / len(pts)
            slope = (sum((x - mx_) * (y - my) for x, y in pts)
                     / sum((x - mx_) ** 2 for x, _ in pts))
            fixed = my - slope * mx_
        out[name] = {"device_ms": times, "per_64_rows_ms": slope,
                     "fixed_ms": fixed}
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


_RESNET_SHAPES = []


def _resnet_shapes(mx, np):
    """The 193 trainable shapes of the port's resnet50_v1, read from the
    model after shape inference (one forward on the CPU), once a
    process."""
    if _RESNET_SHAPES:
        return list(_RESNET_SHAPES)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Zero(), ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mx.cpu()))
    _RESNET_SHAPES.extend(p.shape for p in net.collect_params().values()
                          if p.grad_req != "null")
    return list(_RESNET_SHAPES)


def _differing(torch, x, y):
    """How many elements of x and y differ in their bits."""
    as_int = torch.int16 if x.element_size() == 2 else torch.int32
    return int((x.view(as_int) != y.view(as_int)).sum())


def check_sgd(ck, torch, mx, np, shapes=None):
    """K1 against ``fused_sgd_step_multi_plain`` over the 193 trainable
    tensors of resnet50_v1 (or over ``shapes``), one launch each case,
    bitwise on the masters, the momenta and the casts: momentum 0.9 with
    the f32 master as the out (the trainer's route), momentum 0.9 with a
    bf16 out, momentum 0, and per-tensor lr and wd that differ.  Then one
    step over the list against the plain version and
    ``torch.optim.SGD``.  Returns (cases, per-step timing)."""
    shapes = _resnet_shapes(mx, np) if shapes is None else shapes
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
    step = _k1_list_timing(ck, torch, ws, gs, ms, lrs, wds)
    step.update({"at": {"tensors": n, "params": step["params"],
                        "grad": "float32", "momentum": 0.9,
                        "out": "the f32 master"},
                 "ms_is": "K1 launches alone, table filled",
                 "call_is": "fused_sgd_step_multi: checks, table fill and "
                            "copy, launch (CUDA events; device_ms from the "
                            "profiler)"})
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


# ------------------------------------------------------ phase 2: NaN
#: the NaN cases of the flash kernels: (B, H, causal, S, D, dtype) —
#: both types, every f32 head dim, causal and a ragged non-causal S
NAN_FLASH_CASES = ((2, 4, True, 256, 64, "bfloat16"),
                   (2, 4, False, 200, 64, "bfloat16"),
                   (2, 4, True, 256, 64, "float32"),
                   (2, 4, False, 200, 64, "float32"),
                   (2, 4, True, 256, 32, "float32"),
                   (2, 4, True, 256, 16, "float32"))
#: the NaN cases of the paged kernel: ((B, H, pages, page size, D), query
#: dtype, int8 pages)
NAN_PAGED_CASES = tuple(((4, 4, 8, 16, 64), dt, quant)
                        for dt in ("bfloat16", "float32")
                        for quant in (False, True)) + (
    ((4, 2, 4, 8, 16), "float32", False), ((4, 2, 4, 8, 16), "float32",
                                           True))
#: the NaN cases of K5: ([rows, cols], dtype), the one-warp-a-row layout
#: (cols <= 1024) and the one-block-a-row layout
NAN_K5_CASES = (((64, 1000), "float32"), ((64, 1000), "bfloat16"),
                ((16, 4096), "float32"), ((16, 4096), "bfloat16"))
#: what the NaN cases plant (one case each): an element of one query row
#: (the last row: under the causal mask it attends every key), of key 0
#: in K and in V (every row attends key 0) and of the last row of dO.
#: Each is placed where every version's masking agrees; a NaN in V above
#: the diagonal is reported apart (``nan_v_above_diagonal``)
NAN_PLANTS = ("q", "k", "v", "do")


def _nan_rows_err(torch, got, want, scale, floor=0.0):
    """``(same NaN positions, max row error)``: the row error is max|got
    - want| over the row's largest |scale|, over the rows of ``want``
    (and ``scale``) that hold no NaN; ``floor`` x the tensor's largest
    |scale| floors a row's scale."""
    same = bool(torch.equal(torch.isnan(got.float()),
                            torch.isnan(want.float())))
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    s = scale.float().reshape(-1, scale.shape[-1]).abs()
    rows = torch.isfinite(w).all(-1) & torch.isfinite(s).all(-1)
    if not bool(rows.any()):
        return same, 0.0
    ref = s.amax(-1)
    ref = ref.clamp_min(max(floor * float(ref[rows].max()), 1e-30))
    err = ((g - w).abs().amax(-1) / ref)[rows]
    return same, float(err.max())


def _nan_plant(t, index):
    t = t.clone()
    t[index] = float("nan")
    return t


def _nan_flash_case(ck, torch, case, plant, g):
    """One flash case: forward and backward against the plain versions
    with NaN ``plant``ed (or none)."""
    B, H, causal, S, D, dtype = case
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   .to(dt) for _ in range(4))
    if plant == "q":
        q = _nan_plant(q, (0, 1, S - 1, 5))
    elif plant == "k":
        k = _nan_plant(k, (1, 2, 0, 7))
    elif plant == "v":
        v = _nan_plant(v, (0, 3, 0, 3))
    elif plant == "do":
        do = _nan_plant(do, (1, 0, S - 1, 9))
    o, lse = ck.flash_attention(q, k, v, causal=causal)
    po, plse = ck.flash_attention_plain(q, k, v, causal=causal)
    f32 = dtype == "float32"
    tol = F32_ROW_REL_TOL if f32 else ROW_REL_TOL
    scale = ck.flash_attention_plain(q, k, v.abs(), causal=causal)[0] \
        if f32 else po
    same_o, err_o = _nan_rows_err(torch, o, po, scale)
    same_lse = bool(torch.equal(torch.isnan(lse), torch.isnan(plse)))
    fin = torch.isfinite(plse)
    lse_err = float((lse - plse).abs()[fin].max()) if bool(fin.any()) \
        else 0.0
    # the backward from the plain forward's o and lse, both versions
    delta = ck.flash_delta(po, do)
    dq, dk, dv = ck.flash_attention_bwd(q, k, v, po, plse, do,
                                        causal=causal, delta=delta)
    pdq, pdk, pdv = ck.flash_attention_bwd_plain(q, k, v, po, plse, do,
                                                 causal=causal, delta=delta)
    if f32:
        sums = _bwd_abs_sums(torch, q, k, v, do, plse, delta, causal)
        bwd = [_nan_rows_err(torch, x, px, s)
               for x, px, s in zip((dq, dk, dv), (pdq, pdk, pdv), sums)]
    else:
        bwd = [_nan_rows_err(torch, x, px, px, BWD_ROW_FLOOR)
               for x, px in zip((dq, dk, dv), (pdq, pdk, pdv))]
    torch.cuda.synchronize()
    out = {"shape": {"B": B, "H": H, "S": S, "D": D, "causal": causal,
                     "dtype": dtype}, "plant": plant,
           "nan_outputs": int(torch.isnan(po.float()).sum()),
           "fwd_same_nan": same_o and same_lse, "fwd_row_err": err_o,
           "lse_err": lse_err,
           "bwd_same_nan": all(b[0] for b in bwd),
           "bwd_row_err": max(b[1] for b in bwd),
           "bwd_nan_outputs": int(sum(int(torch.isnan(x.float()).sum())
                                      for x in (pdq, pdk, pdv))),
           "tol": tol}
    out["ok"] = (out["fwd_same_nan"] and out["bwd_same_nan"]
                 and err_o <= tol and lse_err <= LSE_ATOL
                 and out["bwd_row_err"] <= tol)
    return out


def _nan_v_above_diagonal(ck, torch, g):
    """Not a gate: a NaN in V at a key the first query tiles never attend
    (key S/2, causal).  The plain version and the reference multiply the
    masked probability 0 by it and give NaN rows from the start; the
    kernels skip the tiles above the diagonal, so only the query tiles
    that reach the key's tile give NaN."""
    B, H, S, D = 1, 2, 256, 64
    q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    v = _nan_plant(v, (0, 1, S // 2, 0))
    o, _ = ck.flash_attention(q, k, v, causal=True)
    po, _ = ck.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    rows = lambda x: torch.isnan(x.float()).any(-1)[0, 1]  # noqa: E731
    kr, pr = rows(o), rows(po)
    return {"key": S // 2, "plain_nan_rows": int(pr.sum()),
            "kernel_nan_rows": int(kr.sum()),
            "first_kernel_nan_row": int(kr.nonzero()[0]) if bool(kr.any())
            else None,
            "kernel_rows_subset_of_plain": bool((kr & ~pr).sum() == 0)}


def _nan_paged_case(ck, torch, case, qdtype, quant, plant, g):
    """One paged case, pool form and gathered form against the pool
    form's plain version, with NaN ``plant``ed or, for ``plant ==
    'empty'``, one row with no key at all."""
    q, kp, vp, table, lens, kw = _pool_inputs(torch, quant, case, g, qdtype)
    B, H, W, psz, D = case
    h = min(3, H - 1)
    if plant == "q":
        q = _nan_plant(q, (1, min(2, H - 1), 0, 4))
    elif plant in ("k", "v"):
        b = 2 if plant == "k" else 0
        page = int(table[b, 0])
        if quant:
            name = "k_scale_pool" if plant == "k" else "v_scale_pool"
            kw = dict(kw, **{name: _nan_plant(kw[name], (page, 0, h))})
        elif plant == "k":
            kp = _nan_plant(kp, (page, 0, h, 3))
        else:
            vp = _nan_plant(vp, (page, 0, h, 5))
    elif plant == "empty":
        lens = lens.clone()
        lens[1] = 0
    o = ck.paged_attention_pool(q, kp, vp, table, lens, **kw)
    po = ck.paged_attention_pool_plain(q, kp, vp, table, lens, **kw)
    K = W * psz
    valid = torch.arange(K, device="cuda")[None, :] < lens[:, None]
    gkw = {}
    if quant:
        gkw = {"k_scale": ck.gather_pages(kw["k_scale_pool"], table),
               "v_scale": ck.gather_pages(kw["v_scale_pool"], table)}
    og = ck.paged_attention(q, ck.gather_pages(kp, table),
                            ck.gather_pages(vp, table), valid, **gkw)
    f32 = qdtype == "float32"
    if f32:
        tol = PAGED_F32_ROW_REL_TOL
        scale = ck.paged_attention_pool_plain(q, kp, vp.abs(), table, lens,
                                              **kw)
    else:
        tol, scale = ROW_REL_TOL, po
    same, err = _nan_rows_err(torch, o, po, scale)
    gsame, gerr = _nan_rows_err(torch, og, po, scale)
    torch.cuda.synchronize()
    out = {"shape": {"B": B, "H": H, "pages": W, "page_size": psz, "D": D,
                     "query": qdtype, "int8_pages": quant},
           "plant": plant, "nan_outputs": int(torch.isnan(po.float()).sum()),
           "same_nan": same and gsame, "row_err": max(err, gerr),
           "tol": tol}
    if plant == "empty":
        out["empty_row_err"] = float((o[1].float() - po[1].float()).abs()
                                     .max() / po[1].float().abs().max()
                                     .clamp_min(1e-30))
        out["empty_row_gathered_err"] = float(
            (og[1].float() - po[1].float()).abs().max()
            / po[1].float().abs().max().clamp_min(1e-30))
    out["ok"] = out["same_nan"] and out["row_err"] <= tol
    return out


def _nan_k5_case(ck, torch, shape, dtype, plant, g):
    """One K5 case: the forward (NaN in x) and the backward (NaN in x or
    in dy) against the plain versions."""
    dt = getattr(torch, dtype)
    x = (torch.randn(shape, generator=g, device="cuda") * 4).to(dt)
    dy = torch.randn(shape, generator=g, device="cuda").to(dt)
    if plant == "x":
        x = _nan_plant(x, (3, 17))
    else:
        dy = _nan_plant(dy, (5, 30))
    y, m, l = ck.row_softmax(x)
    py, pm, pl = ck.row_softmax_plain(x)
    dx = ck.row_softmax_bwd(x, pm, pl, dy)
    pdx = ck.row_softmax_bwd_plain(x, pm, pl, dy)
    tol = K5_F32_ROW_TOL if dtype == "float32" else K5_BF16_ROW_TOL
    same_y, err_y = _nan_rows_err(torch, y, py, py)
    same_m = bool(torch.equal(torch.isnan(m), torch.isnan(pm))
                  and torch.equal(torch.isnan(l), torch.isnan(pl)))
    same_dx, err_dx = _nan_rows_err(torch, dx, pdx, pdx, BWD_ROW_FLOOR)
    torch.cuda.synchronize()
    out = {"shape": list(shape), "dtype": dtype, "plant": plant,
           "fwd_same_nan": same_y and same_m, "fwd_row_err": err_y,
           "bwd_same_nan": same_dx, "bwd_row_err": err_dx, "tol": tol,
           "nan_rows": int(torch.isnan(py.float()).any(-1).sum())}
    out["ok"] = (out["fwd_same_nan"] and same_dx and err_y <= tol
                 and err_dx <= 2 * tol)
    return out


def check_nan(ck, torch):
    """Phase 2's NaN cases: K2f (bf16; f32 at D = 16, 32, 64), K2dq and
    K2dkv in both types, K4 (bf16, f32 and int8 pages under both queries,
    pool and gathered forms, and a row with no key) and K5f/K5b, each held
    against its plain version: the NaN positions equal, the finite rows
    within the kernel's contract.  Returns ``{"flash", "paged", "k5",
    "nan_v_above_diagonal", "ok"}``."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    out = {"flash": [], "paged": [], "k5": []}
    for case in NAN_FLASH_CASES:
        for plant in NAN_PLANTS:
            out["flash"].append(_nan_flash_case(ck, torch, case, plant, g))
    for case, qdtype, quant in NAN_PAGED_CASES:
        for plant in ("q", "k", "v", "empty"):
            out["paged"].append(_nan_paged_case(ck, torch, case, qdtype,
                                                quant, plant, g))
    for shape, dtype in NAN_K5_CASES:
        for plant in ("x", "dy"):
            out["k5"].append(_nan_k5_case(ck, torch, shape, dtype, plant, g))
    out["nan_v_above_diagonal"] = _nan_v_above_diagonal(ck, torch, g)
    bad = [c for key in ("flash", "paged", "k5") for c in out[key]
           if not c["ok"]]
    out["ok"] = not bad
    out["failed"] = bad
    _log("[nan] %d flash, %d paged, %d K5 cases, %d disagree; V above the "
         "diagonal %s" % (len(out["flash"]), len(out["paged"]),
                          len(out["k5"]), len(bad),
                          json.dumps(out["nan_v_above_diagonal"])))
    for c in bad:
        _log("[nan] disagrees %s" % json.dumps(c))
    return out


#: each kernel the NaN repair changed, at the shape of its PERF.md
#: section-6 row, with that row's device ms (NVIDIA H100 80GB HBM3, 700 W)
SECTION6_SHAPES = (
    ("flash_fwd", ("flash", (4, 12, True, 2048, 64), "bfloat16"), 0.0899),
    ("flash_fwd_f32", ("flash", (1, 12, True, 1024, 64), "float32"),
     0.0855),
    ("flash_fwd_f32_d32", ("flash", (4, 8, True, 1024, 32), "float32"),
     0.0913),
    ("flash_fwd_f32_d16", ("flash", (8, 2, True, 1024, 16), "float32"),
     0.0398),
    ("paged_decode_pool_bf16", ("paged", (8, 12, 128, 16, 64), "bfloat16",
                                False), 0.0179),
    ("paged_decode_pool_int8", ("paged", (8, 12, 128, 16, 64), "bfloat16",
                                True), 0.0212),
    ("paged_decode_pool_f32", ("paged", (8, 12, 128, 16, 64), "float32",
                               False), 0.0280),
    ("paged_decode_pool_int8_f32q", ("paged", (8, 12, 128, 16, 64),
                                     "float32", True), 0.0206),
    ("row_softmax_fwd", ("k5f", (8192, 32000), "float32"), 1.0341),
    ("row_softmax_bwd", ("k5b", (8192, 32000), "float32"), 1.7097))


def _section6_calls(ck, torch):
    """``[(name, call, section-6 ms)]``: one call of each changed kernel
    at its section-6 shape, inputs drawn once."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    calls = []
    for name, spec, ms6 in SECTION6_SHAPES:
        kind = spec[0]
        if kind == "flash":
            (B, H, causal, S, D), dtype = spec[1], spec[2]
            q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
                       .to(getattr(torch, dtype)) for _ in range(3))
            call = (lambda q=q, k=k, v=v, c=causal:
                    ck.flash_attention(q, k, v, causal=c))
        elif kind == "paged":
            q, kp, vp, table, lens, kw = _pool_inputs(torch, spec[3],
                                                      spec[1], g, spec[2])
            call = (lambda q=q, kp=kp, vp=vp, t=table, n=lens, kw=kw:
                    ck.paged_attention_pool(q, kp, vp, t, n, **kw))
        else:
            x = (torch.randn(spec[1], generator=g, device="cuda") * 4).to(
                getattr(torch, spec[2]))
            if kind == "k5f":
                call = (lambda x=x: ck.row_softmax(x))
            else:
                _, m, l = ck.row_softmax_plain(x)
                dy = torch.randn(spec[1], generator=g, device="cuda")
                call = (lambda x=x, m=m, l=l, dy=dy:
                        ck.row_softmax_bwd(x, m, l, dy))
        calls.append((name, call, ms6))
    return calls


def section6_times(ck, torch):
    """Each changed kernel's device time at its section-6 shape beside
    that row's."""
    out = {}
    for name, call, ms6 in _section6_calls(ck, torch):
        out[name] = {"device_ms": _device_ms(torch, call, iters=20),
                     "section6_device_ms": ms6}
    _log("[nan] section-6 shapes %s" % json.dumps(out))
    return out


_NAN_LIBS = ("flash_fwd", "flash_f32", "paged_attn", "row_softmax")


@contextlib.contextmanager
def _other_kernels(csrc):
    """Run the changed kernels from the sources under ``csrc`` (another
    checkout's ``mxnet_tpu_torch/csrc``, built beside this one's), then
    put this checkout's back."""
    from mxnet_tpu_torch.ops import _build
    saved = {n: _build._LIBS.pop(n) for n in _NAN_LIBS if n in _build._LIBS}
    old = _build._CSRC
    _build._CSRC = os.path.abspath(csrc)
    try:
        _build.build(list(_NAN_LIBS))
        yield
    finally:
        for n in _NAN_LIBS:
            _build._LIBS.pop(n, None)
        _build._LIBS.update(saved)
        _build._CSRC = old


def kernel_ab(ck, torch, other_csrc):
    """The NaN repair against the sources in ``other_csrc`` (the parent
    commit's): the NaN cases run on the other kernels (how many disagree
    with the plain versions: the fault), then each changed kernel's device
    time at its section-6 shape, in the order this, other, other, this,
    in one process."""
    mine = _section6_calls(ck, torch)
    with _other_kernels(other_csrc):
        theirs_nan = check_nan(ck, torch)
        theirs = _section6_calls(ck, torch)
        theirs_ms = {}
        for name, call, _ in theirs:
            theirs_ms[name] = [_device_ms(torch, call, iters=20)]
    mine_ms = {name: [_device_ms(torch, call, iters=20)]
               for name, call, _ in mine}
    with _other_kernels(other_csrc):
        for name, call, _ in _section6_calls(ck, torch):
            theirs_ms[name].append(_device_ms(torch, call, iters=20))
    for name, call, _ in mine:
        mine_ms[name].append(_device_ms(torch, call, iters=20))
    out = {"other_nan_disagreeing": [[c["shape"], c["plant"]]
                                     for c in theirs_nan["failed"]],
           "other_nan_cases_failed": len(theirs_nan["failed"]),
        "device_ms": {name: {"this": mine_ms[name],
                             "other": theirs_ms[name],
                             "section6": ms6}
                      for name, _, ms6 in mine}}
    _log("[nan] A/B against %s %s" % (other_csrc, json.dumps(out)))
    return out


# ------------------------------------------------------------- phase 3
def _prompts(np, vocab, n=N_REQUESTS):
    rng = np.random.default_rng(SEED)
    lens = np.linspace(17, 1500, n).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def _hold_stream(torch, stream, logits, what):
    """One served stream against the argmax of the plain route's
    teacher-forced ``logits [len(stream), V]``: returns the top-2 margins
    of the mismatches, each excused as a near-tie below
    LOGIT_MARGIN_TOL; any other mismatch fails, ``what`` naming it."""
    top2 = torch.topk(logits[:len(stream)].float(), 2, dim=-1)
    plain = top2.indices[:, 0].cpu().numpy()
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
    ties = []
    for i, tok in enumerate(stream):
        if int(tok) == int(plain[i]):
            continue
        if margin[i] < LOGIT_MARGIN_TOL:
            ties.append(float(margin[i]))
            continue
        raise AssertionError(
            "served token %d at step %d of %s disagrees with the plain "
            "argmax %d (margin %.4f >= %.4f)" % (
                tok, i, what, plain[i], margin[i], LOGIT_MARGIN_TOL))
    return ties


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
            checked += len(st)
            tie_margins += _hold_stream(torch, st, logits, "a %d-token "
                                        "prompt" % len(pr))
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


#: how many times a window that recorded no CUDA activity is run again
#: (late in the full run about half of the short sessions record none)
PROFILE_ATTEMPTS = 8
#: sessions of each kind ``profiler_probe`` opens
PROFILE_PROBES = 20


def _busy_ms(events):
    """The union of the events' device intervals (cuDNN runs some
    kernels of a call on more than one stream at once), in ms."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in events)
    busy, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e3


def _profile(torch, fn, top=8, attempts=PROFILE_ATTEMPTS):
    """torch.profiler over ``fn()``: wall time, the device's busy time
    and idle share, the ``top`` kernels that took most device time and
    every kernel of the port's by its own name, and device time by kind.

    Late in a long run about half of the profiler sessions that last a
    millisecond or so record no CUDA activity at all (``profiler_probe``
    measures it; in a fresh process every one does).  This script used
    to open such a session as a probe before each window and skip the
    window when the probe recorded nothing.  Now the window itself is
    the test: one that recorded no CUDA activity is run again, up to
    ``attempts`` times, and after that the result says so and carries
    no idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        if device:
            break
    else:
        return {"error": "not measured: torch.profiler recorded no CUDA "
                         "activity in %d windows" % attempts,
                "attempts": attempts, "wall_ms": wall_ms}
    by_name = {}
    for ev in device:
        by_name[ev.name] = by_name.get(ev.name, 0.0) \
            + ev.time_range.elapsed_us() / 1e3
    busy = _busy_ms(device)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    groups = {}
    for name, t in by_name.items():
        group = next((g for g, keys in _KERNEL_GROUPS if any(
            k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + t
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "kernel_ms": sum(by_name.values()),
            "idle_share": 1.0 - busy / wall_ms, "attempts": attempt,
            "top_kernels_ms": [[n[:80], t] for n, t in ranked],
            "port_kernels_ms": {n[:80]: t for n, t in by_name.items()
                                if any(k in n for k in _KERNEL_GROUPS[0][1])},
            "by_group_ms": groups}


def profiler_probe(torch, windows=PROFILE_PROBES):
    """How often a short profiler session records CUDA kernels:
    ``windows`` sessions of one small product each (the probe this
    script used to run before its profiled windows), and as many of ten
    products each, counting the kernels each recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64, 64, device="cuda")

    def kernels(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                y = x @ x
            float(y.sum())
        return sum(ev.device_type == DeviceType.CUDA
                   for ev in prof.events())

    one = [kernels(1) for _ in range(windows)]
    ten = [kernels(10) for _ in range(windows)]
    return {"windows": windows,
            "one_product_windows_with_kernels": sum(k > 0 for k in one),
            "one_product_kernels": one, "ten_product_kernels": ten}


# device time by kind, matched on kernel names in this order
_KERNEL_GROUPS = (
    ("port kernels", ("flash_", "paged_", "adam_multi", "sgd_multi",
                      "nms_segments")),
    ("cudnn layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("cudnn recurrence", ("RNN", "rnn_", "LSTM", "lstm", "GRU", "elemWise",
                          "elementWise_")),
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


def _read_counts(torch, tt, ck, layers, paged_key, flash_key="flash_fwd"):
    """Read a counted run just after it: every prefill layer ran the flash
    kernel ``flash_key`` and every decode layer the paged kernel
    ``paged_key``, through the routed wrappers, and no other kernel
    launched.  Returns (prefills, decode iterations, launches, telemetry
    snapshot)."""
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    snap = tt.snapshot()
    c, tm = snap["counters"], snap["timers"]
    prefills = tm.get("serving.prefill_ms", {}).get("count", 0)
    decodes = tm.get("serving.decode_step_ms", {}).get("count", 0)
    assert prefills > 0 and decodes > 0, (prefills, decodes)
    want = dict.fromkeys(launches, 0)
    want.update({flash_key: prefills * layers, paged_key: decodes * layers})
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
        out["profile"] = _profile_window(srv, torch, prompts)
        _log("[serve] profile %s" % json.dumps(out["profile"]))
    finally:
        srv.stop()
        mx.config.unset("serving.kv_pages")
    return out


# ------------------------------------------------------------ phase 3b
#: bench.py ``generation_config`` (bench.py:1153-1155): an f32
#: TransformerLM of vocab 89, 2 layers, d_model 32, 2 heads of 16, d_ff
#: 64, context 32, pages of 8; scenario 1 at 4 slots over GEN_MIX
#: (bench.py:1188), scenario 2 at 8 slots, a 24-token system prompt, one
#: divergent token and 7 new tokens (bench.py:1263)
GEN_VOCAB, GEN_PAGE, GEN_CTX, GEN_SLOTS = 89, 8, 32, 4
GEN_LAYERS, GEN_D, GEN_HEADS, GEN_FF = 2, 32, 2, 64
GEN_MIX = ((3, 9), (7, 6), (12, 12), (5, 8), (9, 10), (14, 7))
#: bench.py's on-chip request count; scenario 2 serves 8x as many
GEN_REQUESTS = 24
GEN_SLOTS2, GEN_SYS_LEN, GEN_DIVERGE, GEN_NEW2 = 8, 24, 1, 7
#: the full-width f32 serve: requests at once (prompts 17..1500), new
#: tokens each, then the int8-KV run's requests and new tokens
LM32_SERVE_REQUESTS = 8
LM32_SERVE_NEW = 32
LM32_SERVE_INT8 = 4
LM32_SERVE_INT8_NEW = 16


def genconf_config(torch):
    from mxnet_tpu_torch.models.transformer import TransformerLMConfig
    return TransformerLMConfig(
        vocab_size=GEN_VOCAB, num_layers=GEN_LAYERS, d_model=GEN_D,
        num_heads=GEN_HEADS, d_ff=GEN_FF, max_len=GEN_CTX,
        dtype=torch.float32)


def genconf_params(np):
    """generation_config's weights as bench.py makes them, in the
    reference's layout: N(0, 0.02) from ``default_rng(0)`` in bench.py's
    order, pos_embed x 25 (so greedy streams depend on position), the
    norms at 1."""
    prng = np.random.default_rng(0)
    L, D, H, F = GEN_LAYERS, GEN_D, GEN_HEADS, GEN_FF

    def mk(*shape):
        return prng.normal(0.0, 0.02, size=shape).astype(np.float32)
    embed = mk(GEN_VOCAB, D)
    pos_embed = mk(GEN_CTX, D) * np.float32(25.0)
    wqkv, wo = mk(L, D, 3, H, D // H), mk(L, H, D // H, D)
    w1, w2 = mk(L, D, F), mk(L, F, D)
    ones = np.ones((L, D), np.float32)
    return {"embed": embed, "pos_embed": pos_embed,
            "final_norm": np.ones((D,), np.float32),
            "layers": {"ln1": ones, "wqkv": wqkv, "wo": wo,
                       "ln2": ones.copy(), "w1": w1, "w2": w2}}


def genconf_traffic(np, requests):
    """bench.py's traffic, drawn from its one ``RandomState(7)``: scenario
    1's ``(prompt length, new tokens)`` over GEN_MIX and its prompts, then
    scenario 2's ``8 x requests`` prompts (the system prompt and one
    divergent token each).  Returns (traffic, prompts, prompts2)."""
    traffic = [GEN_MIX[i % len(GEN_MIX)] for i in range(requests)]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, GEN_VOCAB, size=p).astype(np.int32)
               for p, _ in traffic]
    sys_prompt = rng.randint(0, GEN_VOCAB, size=GEN_SYS_LEN).astype(np.int32)
    prompts2 = [np.concatenate([sys_prompt, np.asarray(
        [(i + 1) % GEN_VOCAB], np.int32)]) for i in range(8 * requests)]
    return traffic, prompts, prompts2


def _replay_plain(mx, model, np, torch, prompts, streams, psz, quantized):
    """The served streams teacher-forced through the plain route: the
    kernel tier off, ``prefill`` + ``decode_step`` over a private page pool
    (int8 when ``quantized``), all streams as one batch.  Returns
    (tokens checked, the plain top-2 margins of the mismatches, each
    excused as a near-tie below LOGIT_MARGIN_TOL)."""
    B = len(prompts)
    T = max(len(st) for st in streams)
    S = max(len(pr) for pr in prompts)
    top = model.cfg.max_len - 1
    need = -(-(S + T) // psz)
    table = np.arange(B * need, dtype=np.int32).reshape(B, need)
    tokens = np.zeros((B, S), np.int32)
    for b, pr in enumerate(prompts):
        tokens[b, :len(pr)] = pr
    lengths = np.asarray([len(pr) for pr in prompts], np.int32)
    mx.config.set("kernels.enabled", False)
    try:
        kv = model.init_kv_pages(B * need, psz, quantized=quantized)
        kv, _, lg = model.prefill(kv, tokens, lengths, table, psz,
                                  return_logits=True)
        out = [lg.float()]
        for i in range(T - 1):
            tok = np.asarray([st[i] if i < len(st) else 0
                              for st in streams], np.int32)
            # a row past its stream's end rides along; its logits are unused
            pos = np.minimum(lengths + i, top).astype(np.int32)
            kv, _, lg = model.decode_step(kv, tok, pos, table, psz,
                                          return_logits=True)
            out.append(lg.float())
    finally:
        mx.config.unset("kernels.enabled")
    logits = torch.stack(out, 1)
    ties = []
    for b, st in enumerate(streams):
        ties += _hold_stream(torch, st, logits[b], "stream %d" % b)
    return sum(len(st) for st in streams), ties


def _all_paged(predictor):
    """The artifact's per-width verdict: the kernel's own check takes
    every decode width."""
    routes = predictor.paged_routes
    assert routes and all(r["impl"] == "paged" for r in routes.values()), \
        routes


def _launch_counts(torch, ck, **want):
    """Read the launches of a counted run just after it, and hold them to
    exactly ``want`` (every other kernel: none)."""
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck, **want), (launches, want)
    return {k: v for k, v in launches.items() if v}


def _parity(mx, model, np, torch, prompts, streams, psz, quantized):
    checked, ties = _replay_plain(mx, model, np, torch, prompts, streams,
                                  psz, quantized)
    return {"checked_tokens": checked, "near_ties": len(ties),
            "near_tie_max_margin": max(ties, default=0.0)}


def _gen_static(mx, ck, np, torch, tt, model, prefix, traffic, prompts):
    """Scenario 1, static batch 1: ``GenerationPredictor.generate`` a
    request at a time, strictly in turn, after one untimed pass (as
    bench.py).  Counts zeroed just before the timed pass, read just
    after."""
    L = GEN_LAYERS
    pred = mx.deploy.load_generator(prefix)
    _all_paged(pred)
    for pr, (_, n) in zip(prompts, traffic):
        pred.generate(pr, n)
    _zero_counts(torch, tt, ck)
    starts, streams = [], []
    t0 = time.perf_counter()
    for pr, (_, n) in zip(prompts, traffic):
        starts.append((time.perf_counter() - t0) * 1e3)
        streams.append(pred.generate(pr, n))
    wall = time.perf_counter() - t0
    decodes = sum(n - 1 for _, n in traffic)
    launches = _launch_counts(torch, ck,
                              flash_fwd_f32=len(prompts) * L,
                              paged_decode_pool_f32=decodes * L)
    c = tt.snapshot()["counters"]
    assert c.get("kernels.flash_attention") == len(prompts) * L, c
    assert c.get("kernels.paged_attention") == decodes * L, c
    total = sum(n for _, n in traffic)
    return streams, {
        "requests": len(prompts), "new_tokens": total, "wall_s": wall,
        "tokens_per_s": total / wall,
        "ttft_ms_p99": float(np.percentile(np.asarray(starts), 99)),
        "ttft_is": "queue-serialisation lower bound (bench.py): the time "
                   "before a request's generate call starts",
        "decode_steps": decodes, "launches": launches}


def _gen_continuous(mx, ck, np, torch, tt, prefix, traffic, prompts):
    """Scenario 1, continuous batching: the burst through ``Server`` at
    GEN_SLOTS slots, pages never binding (bench.py's pool).  Counts zeroed
    just before, read just after; then the same burst again in a
    profiled window."""
    L = GEN_LAYERS
    mx.config.set("serving.kv_page_size", GEN_PAGE)
    mx.config.set("serving.kv_pages",
                  2 * GEN_SLOTS * -(-GEN_CTX // GEN_PAGE))
    mx.config.set("serving.decode_slots", GEN_SLOTS)
    srv = mx.serving.Server()
    try:
        srv.register("gen", prefix, generate=True)
        srv.start()
        srv.generate("gen", prompts[0], 2, timeout=600)   # warm dispatch

        def burst():
            futs = [srv.submit_generate("gen", pr, n)
                    for pr, (_, n) in zip(prompts, traffic)]
            return [f.result(timeout=600) for f in futs]
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        streams = burst()
        wall = time.perf_counter() - t0
        prefills, decodes, launches, snap = _read_counts(
            torch, tt, ck, L, "paged_decode_pool_f32", "flash_fwd_f32")
        assert prefills == len(prompts), prefills
        tm = snap["timers"]
        total = sum(n for _, n in traffic)
        out = {"requests": len(prompts), "new_tokens": total,
               "decode_slots": GEN_SLOTS, "wall_s": wall,
               "tokens_per_s": total / wall,
               "ttft_ms_p50": tm["serving.ttft_ms"]["p50"],
               "ttft_ms_p99": tm["serving.ttft_ms"]["p99"],
               "decode_step_ms_p50": tm["serving.decode_step_ms"]["p50"],
               "decode_step_ms_p99": tm["serving.decode_step_ms"]["p99"],
               "prefills": prefills, "decode_iterations": decodes,
               "launches": {k: v for k, v in launches.items() if v}}
        out["profile"] = _profile(torch, burst)
    finally:
        srv.stop()
        for knob in ("serving.kv_page_size", "serving.kv_pages",
                     "serving.decode_slots"):
            mx.config.unset(knob)
    return streams, out


def _gen_shared(mx, ck, np, torch, tt, prefix, pages, share, label,
                prompts2, paged_key):
    """Scenario 2, one run (bench.py ``shared_run``): GEN_SLOTS2 slots
    over a pool of ``pages`` pages, ``serving.shared_prefix`` = ``share``;
    the in-use gauge sampled until the pool proves full.  Counts zeroed
    just before, read just after; every page back on the free list at
    the end."""
    L = GEN_LAYERS
    mx.config.set("serving.kv_page_size", GEN_PAGE)
    mx.config.set("serving.kv_pages", pages)
    mx.config.set("serving.decode_slots", GEN_SLOTS2)
    mx.config.set("serving.shared_prefix", share)
    srv = mx.serving.Server()
    try:
        eng = srv.register(label, prefix, generate=True)
        srv.start()
        srv.generate(label, prompts2[0], 2, timeout=600)   # warm dispatch
        gauge = tt.gauge("serving.kv_pages_in_use.%s" % label)
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        futs = [srv.submit_generate(label, pr, GEN_NEW2) for pr in prompts2]
        peak = 0
        while peak < pages and not all(f.done() for f in futs):
            peak = max(peak, int(gauge.value))
            time.sleep(0.005)
        streams = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        prefills, decodes, launches, snap = _read_counts(
            torch, tt, ck, L, paged_key, "flash_fwd_f32")
        assert prefills == len(prompts2), prefills
        stats = eng.stats()
        # every page back on the free list, no shared entry left
        assert stats["kv_pages_free"] == pages and stats["active"] == 0 \
            and stats["prefix_entries"] == 0, stats
        c, tm = snap["counters"], snap["timers"]
        total = len(prompts2) * GEN_NEW2
        return streams, {
            "requests": len(prompts2), "new_tokens": total,
            "decode_slots": GEN_SLOTS2, "kv_pages": pages,
            "shared_prefix": share, "wall_s": wall,
            "tokens_per_s": total / wall,
            "ttft_ms_p50": tm["serving.ttft_ms"]["p50"],
            "ttft_ms_p99": tm["serving.ttft_ms"]["p99"],
            "kv_pages_in_use_peak": peak,
            "prefix_hits": c.get("serving.prefix_hits", 0),
            "kv_pool_exhausted": c.get("serving.kv_pool_exhausted", 0),
            "paged_kernel_iterations": c.get("kernels.paged_attention", 0),
            "prefills": prefills, "decode_iterations": decodes,
            "launches": {k: v for k, v in launches.items() if v}}
    finally:
        srv.stop()
        for knob in ("serving.kv_page_size", "serving.kv_pages",
                     "serving.decode_slots", "serving.shared_prefix"):
            mx.config.unset(knob)


def serve_genconf(mx, ck, np, torch, workdir):
    """Phase 3b(a): bench.py ``generation_config`` with its own model and
    traffic, the kernel tier on throughout."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.convert import params_from_reference
    from mxnet_tpu_torch.models.transformer import TransformerLM
    out = {}
    t0 = time.perf_counter()
    params = genconf_params(np)
    model = TransformerLM(genconf_config(torch))
    model.load_state_dict(params_from_reference(params))
    traffic, prompts, prompts2 = genconf_traffic(np, GEN_REQUESTS)
    prefix = os.path.join(workdir, "gen")
    mx.deploy.export_generation(model, params, prefix, page_size=GEN_PAGE,
                                max_context=GEN_CTX, prompt_buckets=(8, 16))
    static, out["static"] = _gen_static(mx, ck, np, torch, tt, model,
                                        prefix, traffic, prompts)
    out["static"].update(_parity(mx, model, np, torch, prompts, static,
                                 GEN_PAGE, False))
    _log("[generation] static %s" % json.dumps(out["static"]))
    cont, out["continuous"] = _gen_continuous(mx, ck, np, torch, tt, prefix,
                                              traffic, prompts)
    out["continuous"].update(_parity(mx, model, np, torch, prompts, cont,
                                     GEN_PAGE, False))
    out["continuous"]["streams_equal_static"] = sum(
        bool(np.array_equal(a, b)) for a, b in zip(cont, static))
    _log("[generation] continuous %s" % json.dumps(out["continuous"]))
    out["continuous_over_static"] = (out["continuous"]["tokens_per_s"]
                                     / out["static"]["tokens_per_s"])
    out["ttft_p99_continuous_over_static"] = (
        out["continuous"]["ttft_ms_p99"] / out["static"]["ttft_ms_p99"])

    # scenario 2: the same pool bytes, f32 pages without sharing against
    # int8 pages at twice the count with shared-prefix reuse
    spec = model.kv_spec()
    row = spec["num_layers"] * spec["num_heads"] * spec["head_dim"]
    pages_f32 = -(-(GEN_SYS_LEN + GEN_DIVERGE + GEN_NEW2) // GEN_PAGE)
    pages_int8 = 2 * pages_f32
    bytes_f32 = pages_f32 * 2 * row * GEN_PAGE * 4
    bytes_int8 = pages_int8 * (2 * row * GEN_PAGE + 2 * spec["num_layers"]
                               * spec["num_heads"] * GEN_PAGE * 4)
    assert bytes_int8 <= bytes_f32, (bytes_int8, bytes_f32)
    base_prefix = os.path.join(workdir, "gen_base")
    opt_prefix = os.path.join(workdir, "gen_opt")
    mx.deploy.export_generation(model, params, base_prefix,
                                page_size=GEN_PAGE, max_context=GEN_CTX,
                                prompt_buckets=(32,))
    mx.config.set("kernels.enabled", True)
    try:
        mx.deploy.export_generation(
            model, params, opt_prefix, page_size=GEN_PAGE,
            max_context=GEN_CTX, prompt_buckets=(32,), sampling=True,
            kv_quantized=True, decode_batch=GEN_SLOTS2)
    finally:
        mx.config.unset("kernels.enabled")
    for pfx in (base_prefix, opt_prefix):
        with open(pfx + "-meta.json") as f:
            meta = json.load(f)
        assert all(r["impl"] == "paged" for r in meta["paged"].values()), \
            meta["paged"]
    base_s, base = _gen_shared(mx, ck, np, torch, tt, base_prefix, pages_f32,
                               False, "gen_base", prompts2,
                               "paged_decode_pool_f32")
    base.update(_parity(mx, model, np, torch, prompts2, base_s, GEN_PAGE,
                        False))
    base["pool_bytes"] = bytes_f32
    # the f32 pool holds one request: the pool binds
    assert base["kv_pages_in_use_peak"] == pages_f32, base
    _log("[generation] shared_sysprompt_f32_baseline %s" % json.dumps(base))
    opt_s, opt = _gen_shared(mx, ck, np, torch, tt, opt_prefix, pages_int8,
                             True, "gen_int8_shared", prompts2,
                             "paged_decode_pool_int8_f32q")
    opt.update(_parity(mx, model, np, torch, prompts2, opt_s, GEN_PAGE,
                       True))
    opt["pool_bytes"] = bytes_int8
    assert opt["prefix_hits"] >= 1, opt
    _log("[generation] shared_sysprompt_int8_shared %s" % json.dumps(opt))
    out["shared_f32_baseline"], out["shared_int8"] = base, opt
    out["int8_shared_over_baseline"] = opt["tokens_per_s"] / base[
        "tokens_per_s"]
    out["ttft_p99_int8_over_baseline"] = opt["ttft_ms_p99"] / base[
        "ttft_ms_p99"]
    out["peak_pages_int8_over_baseline"] = (opt["kv_pages_in_use_peak"]
                                            / base["kv_pages_in_use_peak"])
    out["predictions"] = {
        "continuous > static (bench.py's gate)":
            out["continuous_over_static"] > 1.0,
        "int8 + shared >= 1.5x baseline (bench.py's gate)":
            out["int8_shared_over_baseline"] >= 1.5,
        "note": "printed, not gates: these are host-bound timings"}
    out["seconds"] = time.perf_counter() - t0
    _log("[generation] ratios %s" % json.dumps(
        {k: out[k] for k in ("continuous_over_static",
                             "ttft_p99_continuous_over_static",
                             "int8_shared_over_baseline",
                             "ttft_p99_int8_over_baseline",
                             "peak_pages_int8_over_baseline",
                             "predictions")}))
    return out


def serve_lm_f32(mx, ck, np, torch, workdir):
    """Phase 3b(b): the full-width TransformerLM in f32 through
    ``export_generation`` -> ``Server``: LM32_SERVE_REQUESTS greedy
    requests at once, then a short int8-KV run.  Counts zeroed just
    before each run and read just after; every stream held against the
    tier-off plain route, teacher-forced."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    t0 = time.perf_counter()
    cfg = TransformerLMConfig(dtype=torch.float32)
    L, psz = cfg.num_layers, 16
    model = TransformerLM(cfg).init(SEED)
    prefix = os.path.join(workdir, "lm32")
    prefixq = os.path.join(workdir, "lm32q")
    mx.deploy.export_generation(model, None, prefix, page_size=psz)
    mx.deploy.export_generation(model, None, prefixq, page_size=psz,
                                kv_quantized=True)
    out = {"setup_s": time.perf_counter() - t0}
    prompts = _prompts(np, cfg.vocab_size, LM32_SERVE_REQUESTS)
    mx.config.set("serving.kv_pages", KV_PAGES)
    srv = mx.serving.Server()
    try:
        eng = srv.register("lm32", prefix, generate=True)
        engq = srv.register("lm32q", prefixq, generate=True)
        srv.start()
        _all_paged(eng.predictor)
        _all_paged(engq.predictor)
        srv.generate("lm32", prompts[0][:64], 4, timeout=600)   # warm-up
        for label, name, n_req, new, key, quant in (
                ("greedy", "lm32", LM32_SERVE_REQUESTS, LM32_SERVE_NEW,
                 "paged_decode_pool_f32", False),
                ("int8", "lm32q", LM32_SERVE_INT8, LM32_SERVE_INT8_NEW,
                 "paged_decode_pool_int8_f32q", True)):
            _zero_counts(torch, tt, ck)
            t1 = time.perf_counter()
            futs = [srv.submit_generate(name, pr, new)
                    for pr in prompts[:n_req]]
            streams = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t1
            prefills, decodes, launches, snap = _read_counts(
                torch, tt, ck, L, key, "flash_fwd_f32")
            assert prefills == n_req, prefills
            assert all(len(st) == new for st in streams)
            tm = snap["timers"]
            run = {"requests": n_req, "new_tokens": new,
                   "prompt_lens": [int(len(p)) for p in prompts[:n_req]],
                   "wall_s": wall, "tokens_per_s": n_req * new / wall,
                   "ttft_ms_p50": tm["serving.ttft_ms"]["p50"],
                   "ttft_ms_p99": tm["serving.ttft_ms"]["p99"],
                   "decode_step_ms_p50": tm["serving.decode_step_ms"]["p50"],
                   "decode_step_ms_p99": tm["serving.decode_step_ms"]["p99"],
                   "prefills": prefills, "decode_iterations": decodes,
                   "launches": {k: v for k, v in launches.items() if v}}
            run.update(_parity(mx, model, np, torch, prompts[:n_req],
                               streams, psz, quant))
            _log("[generation] lm_f32 %s %s" % (label, json.dumps(run)))
            out[label] = run
    finally:
        srv.stop()
        mx.config.unset("serving.kv_pages")
        del model
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def generation(mx, ck, np, torch, card, workdir):
    """Phase 3b: f32 serving, bench.py generation_config (a) and the
    full-width f32 TransformerLM (b)."""
    t0 = time.perf_counter()
    out = {"card": card,
           "generation_config": serve_genconf(mx, ck, np, torch, workdir),
           "lm_f32_serve": serve_lm_f32(mx, ck, np, torch, workdir)}
    out["seconds"] = time.perf_counter() - t0
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
    out["profile"] = _profile(torch, lambda: [step() for _ in range(3)],
                              top=16)
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
    out["profile"] = _profile(
        torch, lambda: _bert_steps(np, torch, model, batch, sgd, 3), top=16)
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
                            top=12)
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
def _resnet_trainer(mx, net, dtype, optimizer="sgd", mesh=None):
    """``bench.py`` ``one_config``'s trainer: SGD lr 0.1, momentum 0.9,
    wd 1e-4 through SPMDTrainer on a one-device mesh (or ``mesh``); or
    Adam at RESNET_ADAM_LR."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    params = ({"learning_rate": 0.1, "momentum": 0.9, "wd": SGD_WD}
              if optimizer == "sgd" else {"learning_rate": RESNET_ADAM_LR})
    return SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer, params,
                       mesh=mesh or make_mesh({"dp": -1}), dtype=dtype)


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


def _timed(np, torch, tr, data, label, steps, finite=True):
    """Losses and host-clock ms of ``steps`` steps, each ending in a sync
    (the loss read); every loss finite unless ``finite`` is False."""
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(tr.step(data, label)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    assert not finite or all(np.isfinite(losses)), losses
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
    out["profile"] = _profile(
        torch, lambda: [tr.step(data, label) for _ in range(3)], top=16)
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


# ------------------------------------------------------------- phase 5b
# examples/benchmark_score.py across the zoo: (get_model name, input side).
# SqueezeNet takes its published 227x227: the reference's Pooling ignores
# pooling_convention="full", and the port's op follows it, so at 224 its
# last map is 12x12 and AvgPool2D(13) has no window.
ZOO_NETS = (("alexnet", 224), ("vgg16", 224), ("vgg16_bn", 224),
            ("squeezenet1.0", 227), ("inceptionv3", 299),
            ("densenet121", 224), ("mobilenet1.0", 224),
            ("mobilenetv2_1.0", 224), ("resnet50_v1", 224))
ZOO_BATCHES = (1, 16, 32)
ZOO_ITERS = 3
# the gate: each network's f32 logits on the card at batch 2 against the
# port's own CPU forward from the same weights.  TF32 is off, so both are
# f32 throughout; cuDNN's convolution algorithms (Winograd and FFT among
# them) and the CPU's sum in different orders over up to 121 layers:
# 1e-3 of the largest logit
ZOO_GATE_BATCH = 2
ZOO_LOGIT_RTOL = 1e-3
# examples/train_imagenet.py --benchmark 1: BS 128, bf16 over f32 masters,
# SGD lr 0.1, momentum 0.9, wd 1e-4, one warm step, then counted steps
ZOO_TRAIN = (("vgg16", 224), ("inceptionv3", 299))
ZOO_TRAIN_BATCH = 128
ZOO_TRAIN_STEPS = 10
# VGG-16 has no BatchNorm: at lr 0.1 from Xavier weights its loss leaves
# the finite numbers within the counted steps, and the reference's does
# the same from the same weights (tests/test_torch_zoo.py, slow:
# test_vgg16_divergence_belongs_to_the_configuration).  Its counted losses
# are recorded, not held finite; its warm step's must be finite
ZOO_DIVERGES = ("vgg16",)
# a Dropout mask drawn on the host would come over as one copy of at
# least 128 x 4096 bytes; the step's own copies (K1's table columns) are
# a few KB
ZOO_HTOD_LIMIT = 64 * 1024


def _zoo_net(mx, np, name, side, ctx):
    """``get_model(name, classes=1000)`` with seeded Xavier weights on
    ``ctx``, its deferred shapes resolved by one forward."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(SEED)
    net = vision.get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with ctx:
        net(mx.nd.array(np.zeros((1, 3, side, side), np.float32), ctx=ctx))
    return net


def zoo_inference(mx, np, torch, card):
    """Phase 5b (a): each ZOO_NETS network through ``functionalize`` with
    ``training=False``, as ``examples/benchmark_score.py`` scores it: f32
    logits at batch ZOO_GATE_BATCH against the CPU forward from the same
    weights (ZOO_LOGIT_RTOL), then img/s at ZOO_BATCHES in f32 and bf16
    (the f32 parameters and the input cast), ZOO_ITERS timed calls after
    one warm call, ended by a forced fetch.  No kernel of the port
    launches."""
    from mxnet_tpu_torch.parallel import functionalize
    rows = []
    for name, side in ZOO_NETS:
        t0 = time.perf_counter()
        net = _zoo_net(mx, np, name, side, mx.gpu(0))
        fn = functionalize(net)
        params = {n: v.detach() for n, v in fn.init_values().items()}
        rng = np.random.RandomState(SEED)
        x = rng.uniform(size=(ZOO_GATE_BATCH, 3, side, side)).astype(
            np.float32)
        with torch.no_grad():
            (got,), _ = fn.apply(params, (torch.from_numpy(x).cuda(),),
                                 training=False)
            with mx.cpu():
                (want,), _ = fn.apply({n: v.cpu() for n, v in
                                       params.items()},
                                      (torch.from_numpy(x),),
                                      training=False)
        got = got.float().cpu()
        err = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        row = {"network": name, "input": [3, side, side],
               "params": sum(v.numel() for n, v in params.items()
                             if n in fn.trainable),
               "logits_vs_cpu_rel_err": err, "logit_rtol": ZOO_LOGIT_RTOL,
               "finite": bool(torch.isfinite(got).all()), "img_per_s": {}}
        row["ok"] = row["finite"] and err <= ZOO_LOGIT_RTOL
        for dtype in ("float32", "bfloat16"):
            cdt = torch.bfloat16 if dtype == "bfloat16" else None
            pm = {n: v.to(cdt) if cdt is not None
                  and v.dtype == torch.float32 else v
                  for n, v in params.items()}

            def fwd(data, _pm=pm, _cdt=cdt):
                if _cdt is not None:
                    data = data.to(_cdt)
                (out,), _ = fn.apply(_pm, (data,), training=False)
                return out.float()
            for batch in ZOO_BATCHES:
                data = torch.from_numpy(rng.uniform(
                    size=(batch, 3, side, side)).astype(np.float32)).cuda()
                with torch.no_grad():
                    float(fwd(data)[0, 0])             # warm
                    t1 = time.perf_counter()
                    for _ in range(ZOO_ITERS):
                        out = fwd(data)
                    float(out[0, 0])                   # forced fetch
                    dt = time.perf_counter() - t1
                row["img_per_s"]["%s bs%d" % (dtype, batch)] = \
                    batch * ZOO_ITERS / dt
                _log("[zoo] network: %s, batch: %d, dtype: %s, %.1f img/s"
                     % (name, batch, dtype, batch * ZOO_ITERS / dt))
            del pm
        row["seconds"] = time.perf_counter() - t0
        _log("[zoo] %s" % json.dumps(row))
        rows.append(row)
        del net, fn, params
        torch.cuda.empty_cache()
    return rows


def _k1_list_timing(ck, torch, ws, gs, ms, lrs, wds):
    """K1's one launch over a whole list (in place on the given tensors):
    the launch alone by CUDA events (table filled), the call and its
    device time, the plain version, ``torch.optim.SGD`` over the same
    tensors (fused where this PyTorch has it) and the byte bound (read
    w, g, m; write w, m: 20 B an element)."""
    n = len(ws)
    table = ck.LaunchTable()
    ck.fused_sgd_step_multi(ws, gs, ms, lrs, wds, 0.9, table=table)
    dev, blocks = table.fill(ck.SGD_LAYOUT, (ws, ms, [None] * n), gs, lrs,
                             wds)
    out = {"tensors": n, "params": sum(w.numel() for w in ws)}
    out["ms"] = _time_ms(lambda: ck._launch_sgd(dev, n, blocks, 0.9,
                                                ws[0]))
    out["call_ms"] = _time_ms(lambda: ck.fused_sgd_step_multi(
        ws, gs, ms, lrs, wds, 0.9, table=table))
    out["device_ms"] = _device_ms(torch, lambda: ck.fused_sgd_step_multi(
        ws, gs, ms, lrs, wds, 0.9, table=table))
    out["plain_ms"] = _time_ms(lambda: ck.fused_sgd_step_multi_plain(
        ws, gs, ms, lrs, wds, 0.9), iters=3, warmup=1)
    masters = [w.clone().requires_grad_(True) for w in ws]
    for p, g in zip(masters, gs):
        p.grad = g.clone()
    try:
        lib = torch.optim.SGD(masters, lr=0.1, momentum=0.9,
                              weight_decay=SGD_WD, fused=True)
        kind = "fused=True"
    except (TypeError, RuntimeError, ValueError):
        lib = torch.optim.SGD(masters, lr=0.1, momentum=0.9,
                              weight_decay=SGD_WD, foreach=True)
        kind = "foreach=True (this PyTorch has no fused SGD)"
    lib.step()   # makes the momentum buffers
    out["library_ms"] = _time_ms(lib.step)
    out["library_device_ms"] = _device_ms(torch, lib.step)
    out["library_computes"] = "torch.optim.SGD(%s) over the same %d f32 " \
        "tensors: the same update with lr applied after the momentum " \
        "(PyTorch's convention), the same bytes" % (kind, n)
    out["bytes"] = out["params"] * 20
    out["bound_ms"], out["bound_by"] = _bound_ms(out["bytes"], 0)
    del masters, lib
    return out


def _dropout_step_checks(torch, tr, data, label, workdir):
    """One training step of a net with Dropout: with
    ``set_sync_debug_mode("error")`` set by a forward pre-hook of every
    Dropout layer and put back by its forward hook, so the mask draw
    itself may not synchronise; and the host-to-device copies of a
    profiled step, none of ZOO_HTOD_LIMIT bytes or more."""
    from mxnet_tpu_torch.gluon import nn as tnn
    drops = []
    tr.block.apply(lambda b: drops.append(b)
                   if isinstance(b, tnn.Dropout) else None)
    calls, errors = [0], []

    def pre(block, args):
        calls[0] += 1
        torch.cuda.set_sync_debug_mode("error")

    def post(block, args, out):
        torch.cuda.set_sync_debug_mode("default")
    handles = [h for b in drops for h in (b.register_forward_pre_hook(pre),
                                          b.register_forward_hook(post))]
    try:
        tr.step(data, label)
    except RuntimeError as exc:
        errors.append(str(exc)[:300])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for h in handles:
            h.detach()
    torch.cuda.synchronize()
    copies = _htod_copies(torch, lambda: tr.step(data, label), workdir,
                          calls=1)
    out = {"dropout_layers": len(drops), "dropout_calls": calls[0],
           "synchronizing_call_in_dropout": errors[0] if errors else None,
           "htod_copies_bytes": copies, "htod_limit": ZOO_HTOD_LIMIT}
    out["ok"] = (not errors and calls[0] == len(drops) > 0
                 and copies is not None
                 and all(c < ZOO_HTOD_LIMIT for c in copies))
    return out


def zoo_train(mx, ck, np, torch, card, name, side, workdir):
    """Phase 5b (b): ``examples/train_imagenet.py --benchmark 1 --network
    name`` through SPMDTrainer (BS ZOO_TRAIN_BATCH, bf16 over f32
    masters, SGD lr 0.1, momentum 0.9, wd 1e-4, synthetic data on the
    card): the first step's bf16 loss against an f32 copy, one warm
    step, K1 bitwise against its plain version on one step's real
    gradients (and timed over the whole list), ZOO_TRAIN_STEPS counted
    steps with exactly one sgd_step launch each and nothing else, finite
    losses (recorded only for ZOO_DIVERGES); img/s, step ms and the idle
    share of a profiled window of 3
    steps; for a net with Dropout, the mask's draw without a
    synchronising call or a host copy."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon.model_zoo import vision
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    shape = (ZOO_TRAIN_BATCH, 3, side, side)
    data = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).cuda()
    label = torch.from_numpy(rng.randint(0, 1000, (ZOO_TRAIN_BATCH,))
                             .astype(np.float32)).cuda()
    mx.random.seed(SEED)
    net = vision.get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.gpu(0):
        net(mx.nd.array(np.zeros((2, 3, side, side), np.float32),
                        ctx=mx.gpu(0)))
    tr = _resnet_trainer(mx, net, "bfloat16")
    tr._materialize(data)
    out = {"network": name, "batch": ZOO_TRAIN_BATCH, "input": [3, side,
                                                                side],
           "tensors": len(tr.fn.trainable), "aux": len(tr.fn.aux),
           "params": sum(tr.params[n].numel() for n in tr.fn.trainable),
           "largest_tensor": max(tr.params[n].numel()
                                 for n in tr.fn.trainable),
           "card": card}
    out["bf16_vs_f32"] = _bf16_vs_f32(mx, torch, net, tr, data, label)
    _log("[zoo-train] %s first step, bf16 vs f32 %s"
         % (name, json.dumps(out["bf16_vs_f32"])))
    out["warmup_losses"], _ = _timed(np, torch, tr, data, label, 1)
    out["sgd_routes"] = _sgd_routes(ck, torch, tr, data, label)
    _log("[zoo-train] %s K1 vs its plain version and SGD.step %s"
         % (name, json.dumps(out["sgd_routes"])))
    if name == "vgg16":
        train, aux = _state(tr)
        _, _, grads = tr._loss_and_grads(train, aux, data, label)
        lrs, wds = tr._hyper()
        names = tr.fn.trainable
        out["k1_list"] = _k1_list_timing(
            ck, torch, [train[n].detach().clone() for n in names], grads,
            [tr.opt_state[n].clone() for n in names], lrs, wds)
        out["k1_list"]["card"] = card
        _log("[zoo-train] K1 over VGG-16's list %s"
             % json.dumps(out["k1_list"]))
        del grads
        torch.cuda.empty_cache()

    # --- the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(torch, tt, ck)
    losses, step_ms = _timed(np, torch, tr, data, label, ZOO_TRAIN_STEPS,
                             finite=name not in ZOO_DIVERGES)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck, sgd_step=ZOO_TRAIN_STEPS), \
        launches
    med = float(np.median(step_ms))
    out["first_nonfinite_step"] = next(
        (k for k, v in enumerate(losses) if not np.isfinite(v)), None)
    out.update({"steps": ZOO_TRAIN_STEPS, "losses": losses,
                "step_ms": step_ms, "median_step_ms": med,
                "img_per_s": ZOO_TRAIN_BATCH / (med / 1e3),
                "launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    _log("[zoo-train] %s %s" % (name, json.dumps(
        {k: v for k, v in out.items() if k not in ("bf16_vs_f32",
                                                   "sgd_routes")})))
    out["profile"] = _profile(
        torch, lambda: [tr.step(data, label) for _ in range(3)], top=12)
    _log("[zoo-train] %s profile over 3 steps %s"
         % (name, json.dumps(out["profile"])))
    from mxnet_tpu_torch.gluon import nn as tnn
    has_dropout = []
    net.apply(lambda b: has_dropout.append(isinstance(b, tnn.Dropout)))
    if any(has_dropout):
        out["dropout"] = _dropout_step_checks(torch, tr, data, label,
                                              workdir)
        _log("[zoo-train] %s Dropout %s" % (name,
                                             json.dumps(out["dropout"])))
        assert out["dropout"]["ok"], out["dropout"]
    out["seconds"] = time.perf_counter() - t0
    del tr, net, data, label
    torch.cuda.empty_cache()
    return out


def zoo_phase(mx, ck, np, torch, card, workdir):
    """Phase 5b: inference across the zoo, then VGG-16 and Inception v3
    training."""
    t0 = time.perf_counter()
    out = {"inference": zoo_inference(mx, np, torch, card)}
    bad = [r for r in out["inference"] if not r["ok"]]
    if bad:
        raise AssertionError("zoo inference failed: %s" % json.dumps(bad))
    out["train"] = {name: zoo_train(mx, ck, np, torch, card, name, side,
                                    workdir)
                    for name, side in ZOO_TRAIN}
    out["seconds"] = time.perf_counter() - t0
    _log("[zoo] phase %.1f s" % out["seconds"])
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
MLP_STEPS = 100
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
        def fn(weights, grads, states, lrs, wds, t, outs=None, skip=None):
            assert skip is None     # the nanguard is off in this A/B
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


def _generation_launches(gen):
    """Launches of phase 3b's counted runs, summed per kernel, and by run
    under ``"by_run"``."""
    runs = {"static": gen["generation_config"]["static"],
            "continuous": gen["generation_config"]["continuous"],
            "shared_f32_baseline": gen["generation_config"][
                "shared_f32_baseline"],
            "shared_int8": gen["generation_config"]["shared_int8"],
            "lm_f32_greedy": gen["lm_f32_serve"]["greedy"],
            "lm_f32_int8": gen["lm_f32_serve"]["int8"]}
    out = {"by_run": {}}
    for run, res in runs.items():
        for key, n in res["launches"].items():
            out[key] = out.get(key, 0) + n
            out["by_run"].setdefault(key, {})[run] = n
    for key in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32",
                "paged_decode_pool_f32", "paged_decode_pool_int8_f32q"):
        out.setdefault(key, 0)
    return out


def _by_head_dim(cases):
    """The largest checked case at each head dim, when an attention
    kernel is checked at several: its shape and times."""
    if not all(isinstance(c["shape"], dict) and "D" in c["shape"]
               for c in cases):
        return {}
    dims = sorted({c["shape"]["D"] for c in cases})
    if len(dims) < 2:
        return {}
    out = {}
    for d in dims:
        top = max((c for c in cases if c["shape"]["D"] == d),
                  key=lambda c: c["bound_ms"])
        out[str(d)] = {k: top.get(k) for k in (
            "shape", "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_row_rel_err")}
    return {"by_head_dim": out}


def _summary(name, source, replaces, cases, launches):
    """One line of the kernels table; its times are those of the largest
    shape it is checked at (B=4 S=2048 causal, or K=2048), and, where it
    is checked at several head dims, each one's largest under
    ``by_head_dim``."""
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
               if k in top}, **_by_head_dim(cases)}


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


# ------------------------------------------------------------- phase ops
# The op library's case table: every op of ops/tensor, nn, misc, linalg,
# random_ops and optim_ops once, at the reference sweep's small shapes
# (tests/test_op_sweep.py SPECS), free of JAX so that the CPU tests hold
# the same cases against the reference.  A case is (op, inputs, attrs);
# an input is (kind, shape) built by build_inputs: rnd ~ N(0, 0.25), pos
# ~ U(0.5, 1.5), unit ~ U(-0.8, 0.8), gt1 ~ U(1.2, 2), probs (rows summing
# to 1), spd (a a^T + n I), chol (its Cholesky factor), tril (lower
# triangle of pos + 2 I), ("idx", shape, hi) integers in [0, hi) as
# float32 (MXNet's labels), ("mask", shape) 0/1, ("lit", values) a
# literal, ("scaled", kind, shape, k) k times a kind.  "@bf16" after an
# op's name runs the case on bfloat16 float inputs.
_UNARY_KINDS = {
    "rnd": ("negative", "abs", "sign", "exp", "expm1", "sin", "cos", "sinh",
            "cosh", "tanh", "arctan", "arcsinh", "degrees", "radians",
            "sigmoid", "softsign", "square", "erf", "rint", "ceil", "floor",
            "trunc", "round", "logical_not", "isnan", "isinf", "isfinite",
            "argmax_channel", "relu", "identity", "make_loss", "BlockGrad",
            "softmin", "log_softmax", "softmax", "SoftmaxActivation",
            "zeros_like", "ones_like", "transpose", "fix", "_contrib_sign_ste",
            "_contrib_div_sqrt_dim", "IdentityAttachKLSparseReg"),
    "pos": ("log", "log10", "log2", "log1p", "sqrt", "rsqrt", "cbrt",
            "rcbrt", "reciprocal", "gammaln", "gamma", "digamma",
            "L2Normalization"),
    "unit": ("arcsin", "arccos", "arctanh", "erfinv", "tan",
             "hard_sigmoid"),
    "gt1": ("arccosh",),
}
_BINARY_KINDS = {
    ("rnd", "rnd"): ("broadcast_add", "broadcast_sub", "broadcast_mul",
                     "broadcast_maximum", "broadcast_minimum",
                     "broadcast_equal", "broadcast_not_equal",
                     "broadcast_greater", "broadcast_greater_equal",
                     "broadcast_lesser", "broadcast_lesser_equal",
                     "broadcast_logical_and", "broadcast_logical_or",
                     "broadcast_logical_xor",
                     "_identity_with_attr_like_rhs"),
    ("rnd", "pos"): ("arctan2", "broadcast_div", "_scatter_elemwise_div"),
    ("pos", "pos"): ("broadcast_hypot",),
    ("pos", "rnd"): ("broadcast_power",),
}
_SCALAR_OPS = ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
               "_mul_scalar", "_div_scalar", "_rdiv_scalar",
               "_power_scalar", "_hypot_scalar", "_equal_scalar",
               "_not_equal_scalar", "_greater_scalar",
               "_greater_equal_scalar", "_lesser_scalar",
               "_lesser_equal_scalar", "_logical_and_scalar",
               "_logical_or_scalar", "_logical_xor_scalar",
               "_scatter_plus_scalar", "_scatter_minus_scalar",
               "_mod_scalar", "_maximum_scalar", "_minimum_scalar")
_M34 = (("rnd", (3, 4)),)
_V4 = ("rnd", (4,))
_SMALL = ("scaled", "rnd", (4,), 0.1)
_STATE = ("scaled", "pos", (4,), 0.01)
_ONE = ("lit", [1.0])


def _op_cases():
    cases = []
    for kind, names in _UNARY_KINDS.items():
        cases += [(n, ((kind, (3, 4)),), {}) for n in names]
    for kinds, names in _BINARY_KINDS.items():
        cases += [(n, tuple((k, (3, 4)) for k in kinds), {}) for n in names]
    cases += [(n, (("pos", (3, 4)),), {"scalar": 1.3}) for n in _SCALAR_OPS]
    cases += [("_rmod_scalar", (("gt1", (3, 4)),), {"scalar": 1.3}),
              ("_rpower_scalar", (("unit", (3, 4)),), {"scalar": 1.3})]
    cases += [(n, (("pos", (3, 4)),), {"axis": 1})
              for n in ("sum", "mean", "prod", "nansum", "nanprod",
                        "_square_sum")]
    cases += [(n, _M34, {"axis": 1})
              for n in ("max", "min", "logsumexp", "argmax", "argmin",
                        "argsort", "cumsum", "sort")]
    cases += [
        ("cumprod", (("pos", (3, 4)),), {"axis": 1}),
        ("broadcast_mod", (("scaled", "pos", (3, 4), 3.0), ("pos", (3, 4))),
         {}),
        ("_copy_to_device", _M34, {}),
        ("norm", (("pos", (3, 4)),), {"ord": 2}),
        ("moments", _M34, {"axes": (0, 1)}),
        ("clip", _M34, {"a_min": -0.3, "a_max": 0.3}),
        ("cast", _M34, {"dtype": "float16"}),
        ("amp_cast", _M34, {"dtype": "float16"}),
        ("amp_multicast", (("rnd", (3, 4)), ("rnd", (3, 4))),
         {"num_outputs": 2}),
        ("cast_storage", _M34, {"stype": "default"}),
        ("smooth_l1", _M34, {"scalar": 1.0}),
        ("topk", _M34, {"k": 2, "axis": 1}),
        ("reshape", _M34, {"shape": (4, 3)}),
        ("swapaxes", (("rnd", (2, 3, 4)),), {"dim1": 0, "dim2": 2}),
        ("flatten", (("rnd", (2, 3, 4)),), {}),
        ("expand_dims", _M34, {"axis": 1}),
        ("squeeze", (("rnd", (3, 1, 4)),), {}),
        ("broadcast_to", (("rnd", (1, 4)),), {"shape": (3, 4)}),
        ("broadcast_axis", (("rnd", (1, 4)),), {"axis": 0, "size": 3}),
        ("broadcast_like", (("rnd", (1, 4)), ("rnd", (3, 4))), {}),
        ("reshape_like", (("rnd", (3, 4)), ("rnd", (4, 3))), {}),
        ("tile", (("rnd", (2, 3)),), {"reps": (2, 2)}),
        ("repeat", (("rnd", (2, 3)),), {"repeats": 2, "axis": 1}),
        ("pad", (("rnd", (1, 1, 3, 3)),),
         {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)}),
        ("concat", (("rnd", (2, 3)), ("rnd", (2, 3))), {"dim": 1}),
        ("stack", (("rnd", (2, 3)), ("rnd", (2, 3))), {"axis": 0}),
        ("split", (("rnd", (2, 4)),), {"num_outputs": 2, "axis": 1}),
        ("_split_v2", (("rnd", (4, 6)),), {"indices": (2,), "axis": 1}),
        ("slice_axis", _M34, {"axis": 1, "begin": 1, "end": 3}),
        ("slice", _M34, {"begin": (0, 1), "end": (2, 3)}),
        ("slice_like", (("rnd", (3, 4)), ("rnd", (2, 2))), {}),
        ("_slice_index", _M34, {"key": (slice(None), slice(None, None, -2))}),
        ("reverse", _M34, {"axis": 0}),
        ("diag", (("rnd", (4, 4)),), {}),
        ("full_like", _M34, {"fill_value": 2.5}),
        ("shape_array", _M34, {}),
        ("size_array", _M34, {}),
        ("depth_to_space", (("rnd", (1, 8, 2, 2)),), {"block_size": 2}),
        ("space_to_depth", (("rnd", (1, 2, 4, 4)),), {"block_size": 2}),
        ("where", (("mask", (3, 4)), ("rnd", (3, 4)), ("rnd", (3, 4))), {}),
        ("take", (("rnd", (5, 3)), ("idx", (3,), 5)), {"axis": 0}),
        ("Embedding", (("idx", (3,), 4), ("rnd", (4, 5))),
         {"input_dim": 4, "output_dim": 5}),
        ("one_hot", (("idx", (2,), 3),), {"depth": 3}),
        ("pick", (("rnd", (3, 4)), ("idx", (3,), 4)), {"axis": 1}),
        ("gather_nd", (("rnd", (3, 4)), ("lit", [[0, 2], [1, 3]])), {}),
        ("scatter_nd", (("rnd", (2,)), ("lit", [[0, 2], [1, 3]])),
         {"shape": (3, 4)}),
        ("take_along_axis", (("rnd", (3, 4)), ("idx", (3, 1), 4)),
         {"axis": 1}),
        ("boolean_mask", (("rnd", (4, 3)), ("lit", [1, 0, 1, 1])), {}),
        ("batch_take", (("rnd", (3, 4)), ("idx", (3,), 4)), {}),
        ("shuffle", (("rnd", (4, 3)),), {}),
        ("ravel_multi_index", (("lit", [[0, 1], [1, 2]]),), {"shape": (2, 3)}),
        ("_unravel_index", (("lit", [5, 7]),), {"shape": (3, 4)}),
        ("dot", (("rnd", (3, 4)), ("rnd", (4, 2))), {}),
        ("batch_dot", (("rnd", (2, 3, 4)), ("rnd", (2, 4, 2))), {}),
        ("batch_dot_auto", (("rnd", (2, 3, 4)), ("rnd", (2, 4, 2))), {}),
        ("linalg_gemm2", (("rnd", (3, 4)), ("rnd", (4, 2))), {}),
        ("linalg_gemm", (("rnd", (3, 4)), ("rnd", (4, 2)), ("rnd", (3, 2))),
         {}),
        ("linalg_potrf", (("spd", (3, 3)),), {}),
        ("linalg_potri", (("chol", (3, 3)),), {}),
        ("linalg_trmm", (("tril", (3, 3)), ("rnd", (3, 2))), {}),
        ("linalg_trsm", (("tril", (3, 3)), ("rnd", (3, 2))), {}),
        ("linalg_syrk", (("rnd", (3, 4)),), {}),
        ("linalg_sumlogdiag", (("spd", (3, 3)),), {}),
        ("linalg_extractdiag", (("rnd", (4, 4)),), {}),
        ("linalg_makediag", (("rnd", (4,)),), {}),
        ("linalg_extracttrian", (("rnd", (3, 3)),), {}),
        ("linalg_maketrian", (("rnd", (6,)),), {}),
        ("linalg_gelqf", (("rnd", (2, 4)),), {}),
        ("linalg_syevd", (("spd", (3, 3)),), {}),
        ("linalg_inverse", (("spd", (3, 3)),), {}),
        ("linalg_det", (("spd", (3, 3)),), {}),
        ("linalg_slogdet", (("spd", (3, 3)),), {}),
        ("khatri_rao", (("rnd", (2, 3)), ("rnd", (4, 3))), {}),
        ("SequenceMask", (("rnd", (4, 2, 3)), ("lit", [2, 4])),
         {"use_sequence_length": True}),
        ("SequenceLast", (("rnd", (4, 2, 3)), ("lit", [2, 4])),
         {"use_sequence_length": True}),
        ("SequenceReverse", (("rnd", (4, 2, 3)), ("lit", [2, 4])),
         {"use_sequence_length": True}),
        ("_zeros", (), {"shape": (2, 3)}),
        ("_ones", (), {"shape": (2, 3)}),
        ("_full", (), {"shape": (2, 3), "value": 1.5}),
        ("_arange", (), {"start": 1, "stop": 7, "step": 2}),
        ("_linspace", (), {"start": 0.0, "stop": 1.0, "num": 5}),
        ("_eye", (), {"N": 3, "M": 4, "k": 1}),
        ("_zeros_without_dtype", (), {"shape": (2, 3)}),
        # nn
        ("FullyConnected", (("rnd", (2, 3)), ("rnd", (4, 3)), ("rnd", (4,))),
         {"num_hidden": 4}),
        ("Convolution", (("rnd", (1, 2, 5, 5)), ("rnd", (3, 2, 3, 3)),
                         ("rnd", (3,))), {"kernel": (3, 3), "num_filter": 3}),
        ("Deconvolution", (("rnd", (1, 2, 3, 3)), ("rnd", (2, 3, 3, 3))),
         {"kernel": (3, 3), "num_filter": 3, "no_bias": True,
          "stride": (2, 2), "pad": (1, 1), "adj": (1, 1)}),
        ("Pooling", (("rnd", (1, 2, 4, 4)),),
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"}),
        ("BatchNorm", (("rnd", (2, 3, 4, 4)), ("pos", (3,)), ("rnd", (3,)),
                       ("rnd", (3,)), ("pos", (3,))),
         {"fix_gamma": False, "training": True}),
        ("LayerNorm", (("rnd", (3, 4)), ("pos", (4,)), ("rnd", (4,))), {}),
        ("GroupNorm", (("rnd", (2, 4, 3, 3)), ("pos", (4,)), ("rnd", (4,))),
         {"num_groups": 2}),
        ("InstanceNorm", (("rnd", (2, 3, 4, 4)), ("pos", (3,)),
                          ("rnd", (3,))), {}),
        ("LRN", (("rnd", (1, 6, 3, 3)),), {"nsize": 3}),
        ("SoftmaxOutput", (("rnd", (3, 4)), ("idx", (3,), 4)), {}),
        ("softmax_cross_entropy", (("rnd", (3, 4)), ("idx", (3,), 4)), {}),
        ("Activation", _M34, {"act_type": "tanh"}),
        ("LeakyReLU", _M34, {"act_type": "leaky", "slope": 0.1}),
        ("Dropout", _M34, {"p": 0.5}),
        ("UpSampling", (("rnd", (1, 2, 3, 3)),), {"scale": 2}),
        ("CTCLoss", (("rnd", (4, 2, 5)), ("lit", [[1, 2], [2, 3]])), {}),
        ("LinearRegressionOutput", (("rnd", (3, 2)), ("rnd", (3, 2))), {}),
        ("LogisticRegressionOutput", (("rnd", (3, 2)), ("rnd", (3, 2))), {}),
        ("MAERegressionOutput", (("rnd", (3, 2)), ("rnd", (3, 2))), {}),
        ("SVMOutput", (("rnd", (3, 4)), ("idx", (3,), 4)), {}),
        # misc
        ("add_n", (("rnd", (3, 4)),) * 3, {}),
        ("_histogram", (("rnd", (40,)),), {"bin_cnt": 5}),
        ("_rnn_param_concat", (("rnd", (3, 2)), ("rnd", (4, 2))), {"dim": 0}),
        ("_sparse_retain", (("rnd", (5, 3)), ("lit", [1, 3])), {}),
        ("_scatter_set_nd", (("rnd", (4, 5)), ("rnd", (3,)),
                             ("lit", [[0, 1, 2], [1, 2, 3]])), {}),
        ("_slice_assign", (("rnd", (4, 5)), ("rnd", (2, 2))),
         {"begin": (0, 1), "end": (2, 3)}),
        ("_slice_assign_scalar", (("rnd", (4, 5)),),
         {"begin": (0, 1), "end": (2, 3), "scalar": 7.0}),
        ("_sample_unique_zipfian", (), {"range_max": 1000, "shape": (6,)}),
        ("Crop", (("rnd", (1, 2, 6, 6)),), {"h_w": (4, 4), "offset": (1, 1)}),
        ("_image_to_tensor", (("scaled", "pos", (5, 6, 3), 100.0),), {}),
        ("_image_normalize", (("pos", (3, 5, 6)),),
         {"mean": (0.5,), "std": (2.0,)}),
        ("_image_resize", (("pos", (5, 6, 3)),), {"size": (4, 3)}),
        ("_image_crop", (("pos", (6, 8, 3)),),
         {"x": 1, "y": 2, "width": 4, "height": 3}),
        ("_contrib_round_ste", (("scaled", "rnd", (3, 4), 3.0),), {}),
        ("_contrib_gradientmultiplier", _M34, {"scalar": -1.0}),
        # optim
        ("sgd_update", (_V4, _V4), {"lr": 0.1, "wd": 0.01}),
        ("sgd_mom_update", (_V4, _V4, _V4), {"lr": 0.1, "momentum": 0.9}),
    ]
    for name, n in (("mp_sgd_update", 3), ("mp_sgd_mom_update", 4),
                    ("nag_mom_update", 3), ("mp_nag_mom_update", 4),
                    ("adam_update", 4), ("ftml_update", 5),
                    ("rmsprop_update", 3), ("rmspropalex_update", 5),
                    ("ftrl_update", 4), ("signsgd_update", 2),
                    ("signum_update", 3)):
        cases.append((name, (_V4, _SMALL) + (_STATE,) * (n - 2),
                      {"lr": 0.1}))
    for name, per, extra in (("multi_sgd_update", 2, {}),
                             ("multi_sgd_mom_update", 3, {"momentum": 0.9}),
                             ("multi_mp_sgd_update", 3, {}),
                             ("multi_mp_sgd_mom_update", 4,
                              {"momentum": 0.9})):
        cases.append((name, (("rnd", (3,)),) * (2 * per),
                      dict({"lrs": (0.1, 0.2), "wds": (0.0, 0.01),
                            "num_weights": 2}, **extra)))
    cases += [
        ("multi_sum_sq", (("rnd", (3,)), ("rnd", (4,))), {"num_arrays": 2}),
        ("multi_lars", (("pos", (3,)),) * 3 + (("scaled", "pos", (3,), 0.01),),
         {"eta": 0.001}),
        ("_adamw_update", (_V4, _V4, _V4, ("pos", (4,)), _ONE), {"lr": 0.01}),
        ("_mp_adamw_update", (_V4, _V4, _V4, ("pos", (4,)), _V4, _ONE),
         {"lr": 0.01}),
        ("lamb_update_phase1", (_V4, _V4, _V4, ("pos", (4,))), {"t": 1}),
        ("lamb_update_phase2", (_V4, _V4, ("pos", (1,)), ("pos", (1,))),
         {"lr": 0.1}),
        ("_multi_adamw_update", (_V4, _V4, ("scaled", "rnd", (4,), 0.0),
                                 ("pos", (4,)), _ONE),
         {"lrs": (0.1,), "wds": (0.01,), "etas": (1.0,)}),
        ("_multi_mp_adamw_update", (_V4, _V4, ("scaled", "rnd", (4,), 0.0),
                                    ("pos", (4,)), _V4, _ONE),
         {"lrs": (0.1,), "wds": (0.01,), "etas": (1.0,)}),
        ("preloaded_multi_sgd_update", (_V4, _V4, ("lit", [0.1]),
                                        ("lit", [0.0])), {}),
        ("preloaded_multi_sgd_mom_update", (_V4, _V4, _V4, ("lit", [0.1]),
                                            ("lit", [0.0])),
         {"momentum": 0.9}),
        ("preloaded_multi_mp_sgd_update", (_V4, _V4, _V4, ("lit", [0.1]),
                                           ("lit", [0.0])), {}),
        ("preloaded_multi_mp_sgd_mom_update",
         (_V4, _V4, _V4, _V4, ("lit", [0.1]), ("lit", [0.0])),
         {"momentum": 0.9}),
        ("_sparse_adagrad_update", (("rnd", (4, 3)), ("rnd", (4, 3)),
                                    ("pos", (4, 3))), {"lr": 0.1}),
        ("_contrib_group_adagrad_update", (("rnd", (4, 3)), ("rnd", (4, 3)),
                                           ("pos", (4, 1))), {"lr": 0.1}),
        ("all_finite", _M34, {}),
        ("multi_all_finite", (("rnd", (3,)), ("rnd", (3,))), {}),
        ("reset_arrays", (("rnd", (3,)), ("rnd", (2, 2))), {}),
    ]
    # samplers: shape and dtype here; their distributions in
    # SAMPLER_CASES
    cases += [(n, (), {"shape": (50,)}) for n in RANDOM_OPS]
    cases += [(n + "_like", (("rnd", (5, 4)),), {}) for n in RANDOM_OPS
              if n != "_random_randint"]
    cases += [(n, (("pos", (3,)), ("scaled", "pos", (3,), 2.0)),
               {"shape": (4,)})
              for n in ("sample_uniform", "sample_normal", "sample_gamma",
                        "sample_generalized_negative_binomial")]
    cases += [("sample_exponential", (("pos", (3,)),), {"shape": (4,)}),
              ("sample_poisson", (("scaled", "pos", (3,), 3.0),),
               {"shape": (4,)}),
              ("sample_negative_binomial", (("lit", [2.0, 2.0, 2.0]),
                                            ("lit", [0.5, 0.5, 0.5])),
               {"shape": (4,)}),
              ("sample_multinomial", (("probs", (3, 5)),), {"shape": (4,)})]
    # the spatial and signal ops: grids in (-0.8, 0.8) and offsets in
    # (0.15, 0.45), so no sample lands on a pixel (the bilinear kink)
    cases += [
        ("GridGenerator", (("rnd", (2, 6)),),
         {"transform_type": "affine", "target_shape": (3, 3)}),
        ("GridGenerator@warp", (("scaled", "unit", (1, 2, 3, 3), 0.4),),
         {"transform_type": "warp"}),
        ("BilinearSampler", (("rnd", (1, 2, 4, 4)),
                             ("unit", (1, 2, 3, 3))), {}),
        ("SpatialTransformer", (("rnd", (2, 2, 4, 4)),
                                ("scaled", "unit", (2, 6), 0.5)),
         {"target_shape": (3, 3)}),
        ("_contrib_BilinearResize2D", (("rnd", (1, 2, 4, 4)),),
         {"height": 6, "width": 6}),
        ("_contrib_ROIAlign", (("rnd", (1, 2, 6, 6)),
                               ("lit", [[0, 0, 0, 4, 4]])),
         {"pooled_size": (2, 2), "spatial_scale": 1.0}),
        ("_contrib_DeformableConvolution",
         (("rnd", (1, 2, 5, 5)), ("scaled", "pos", (1, 18, 3, 3), 0.3),
          ("rnd", (3, 2, 3, 3))),
         {"kernel": (3, 3), "num_filter": 3, "no_bias": True}),
        ("Correlation", (("rnd", (1, 2, 5, 5)), ("rnd", (1, 2, 5, 5))),
         {"max_displacement": 1, "pad_size": 1}),
        ("_contrib_fft", (("rnd", (2, 8)),), {}),
        ("_contrib_ifft", (("rnd", (2, 16)),), {})]
    # bfloat16 forms of the ops the model widths run in bf16
    cases += [(n + "@bf16", ins, attrs) for n, ins, attrs in (
        ("LayerNorm", (("rnd", (3, 4)), ("pos", (4,)), ("rnd", (4,))), {}),
        ("softmax", _M34, {}), ("broadcast_add", _M34 * 2, {}),
        ("relu", _M34, {}), ("sum", _M34, {"axis": 1}),
        ("mp_sgd_mom_update", (_V4, _SMALL, _STATE, _V4),
         {"lr": 0.1, "momentum": 0.9, "rescale_grad": 0.5}))]
    return cases


# mx.nd.contrib's control flow, each recording (the tape's Python loop)
# and not (the reference's traced semantics: while_loop padded to
# max_iterations, cond's single output unwrapped)
CONTROL_FLOW_CASES = tuple((name, rec) for name in ("foreach", "while_loop",
                                                     "cond")
                           for rec in (True, False))
CF_MAX_ITERATIONS = 6


def control_flow_case(mx, cf, np, ctx, name, record):
    """One CONTROL_FLOW_CASES case through ``cf`` (``mx.nd.contrib`` of
    either package) on ``ctx`` from seeded inputs: the outputs, final
    states and, recording, the gradients of the inputs, as numpy arrays
    in a fixed order.  Every number is float32."""
    rng = np.random.RandomState(SEED + 17)
    data = rng.randn(5, 3).astype(np.float32)
    init = rng.uniform(0.5, 1.5, (3,)).astype(np.float32)
    with ctx:
        x = mx.nd.array(data, ctx=ctx)
        s0 = mx.nd.array(init, ctx=ctx)
        leaves = [x, s0]
        if record:
            for a in leaves:
                a.attach_grad()

        def run():
            if name == "foreach":
                def body(e, states):
                    a, b = states
                    return [e * a, e + b], [a + e * 0.5, b * 0.9]
                outs, states = cf.foreach(body, x, [s0, s0 * 2])
                return list(outs) + list(states)
            if name == "while_loop":
                def cond_fn(i, v):
                    return i < 4

                def func(i, v):
                    return [v * 2, i * 1], [i + 1, v * x[0] + 0.5]
                outs, final = cf.while_loop(
                    cond_fn, func, [mx.nd.zeros((1,), ctx=ctx), s0],
                    max_iterations=CF_MAX_ITERATIONS)
                return list(outs) + list(final)
            out = cf.cond(x.sum() > 0, lambda: [x * s0],
                          lambda: [x - s0])
            return list(out) if isinstance(out, (list, tuple)) else [out]
        if not record:
            return [o.asnumpy() for o in run()]
        with mx.autograd.record():
            outs = run()
            head = sum((o * (k + 1)).sum() for k, o in enumerate(outs))
        head.backward()
        return [o.asnumpy() for o in outs] + [a.grad.asnumpy()
                                              for a in leaves]


# the inputs a "@bf16" case runs in bfloat16 where not all float ones:
# an mp_* update's weight and gradient (its momentum and master stay f32)
BF16_INPUTS = {"mp_sgd_mom_update": (0, 1)}


RANDOM_OPS = ("_random_uniform", "_random_normal", "_random_gamma",
              "_random_exponential", "_random_poisson",
              "_random_negative_binomial",
              "_random_generalized_negative_binomial", "_random_randint")
OP_CASES = _op_cases()
# ops whose inputs after the first are index-like: their values go in as
# given, and no gradient is taken for them
INDEX_INPUTS = {"take": (1,), "Embedding": (0,), "pick": (1,),
                "gather_nd": (1,), "scatter_nd": (1,),
                "take_along_axis": (1,), "batch_take": (1,),
                "boolean_mask": (1,), "SequenceMask": (1,),
                "SequenceLast": (1,), "SequenceReverse": (1,),
                "one_hot": (0,), "SoftmaxOutput": (1,),
                "softmax_cross_entropy": (1,), "SVMOutput": (1,),
                "CTCLoss": (1,), "_sparse_retain": (1,),
                "_scatter_set_nd": (2,), "where": (0,),
                "ravel_multi_index": (0,), "_unravel_index": (0,),
                "_contrib_ROIAlign": (1,)}


def case_inputs(np, i):
    """OP_CASES[i]'s numpy inputs (seeded by the case's index) and each
    one's dtype: bfloat16 for a "@bf16" case's float inputs (those of
    BF16_INPUTS where listed), else None (the array's own, float32)."""
    case, inputs, _ = OP_CASES[i]
    op, _, form = case.partition("@")
    arrays = build_inputs(np, np.random.RandomState(SEED + i), inputs)
    low = BF16_INPUTS.get(op, tuple(
        k for k in range(len(arrays)) if k not in INDEX_INPUTS.get(op, ())))
    return arrays, [("bfloat16" if form == "bf16" and k in low else None)
                    for k in range(len(arrays))]


def build_inputs(np, rng, inputs):
    """The numpy arrays (float32) of a case's input descriptors."""
    out = []
    for d in inputs:
        kind = d[0]
        if kind == "lit":
            out.append(np.asarray(d[1], np.float32))
            continue
        if kind == "scaled":
            out.append(build_inputs(np, rng, ((d[1], d[2]),))[0]
                       * np.float32(d[3]))
            continue
        shape = d[1]
        if kind == "rnd":
            a = rng.randn(*shape) * 0.5
        elif kind == "pos":
            a = rng.uniform(0.5, 1.5, shape)
        elif kind == "unit":
            a = rng.uniform(-0.8, 0.8, shape)
        elif kind == "gt1":
            a = rng.uniform(1.2, 2.0, shape)
        elif kind == "probs":
            a = rng.uniform(0.1, 1.0, shape)
            a = a / a.sum(axis=-1, keepdims=True)
        elif kind in ("spd", "chol"):
            n = shape[-1]
            m = rng.randn(*shape)
            a = m @ np.swapaxes(m, -1, -2) + n * np.eye(n)
            if kind == "chol":
                a = np.linalg.cholesky(a)
        elif kind == "tril":
            a = np.tril(rng.uniform(0.5, 1.5, shape)) + 2 * np.eye(shape[-1])
        elif kind == "idx":
            a = rng.randint(0, d[2], shape)
        elif kind == "mask":
            a = rng.rand(*shape) > 0.5
        else:
            raise ValueError("unknown input kind %r" % (kind,))
        out.append(np.asarray(a, np.float32))
    return out


# ops whose outputs are exact (data movement, selection, comparisons,
# rounding, creation): the card's must equal the CPU's bit for bit (the
# CPU tests hold the port's to the reference's the same way)
EXACT_OPS = frozenset((
    "negative", "abs", "sign", "rint", "ceil", "floor", "trunc", "round",
    "fix", "relu", "logical_not", "isnan", "isinf", "isfinite", "clip",
    "reshape", "reshape_like", "transpose", "swapaxes", "flatten",
    "expand_dims", "squeeze", "broadcast_to", "broadcast_axis",
    "broadcast_like", "tile", "repeat", "pad", "concat", "stack", "split",
    "_split_v2", "slice", "slice_axis", "slice_like", "_slice_index",
    "reverse", "where", "diag", "zeros_like", "ones_like", "full_like",
    "shape_array", "size_array", "depth_to_space", "space_to_depth",
    "take", "Embedding", "one_hot", "pick", "gather_nd", "take_along_axis",
    "boolean_mask", "batch_take", "sort", "argsort", "topk", "argmax",
    "argmin", "argmax_channel", "max", "min", "ravel_multi_index",
    "_unravel_index", "_zeros", "_ones", "_full", "_eye", "_arange",
    "_zeros_without_dtype", "identity", "BlockGrad", "make_loss", "cast",
    "amp_cast", "amp_multicast", "cast_storage", "_copy_to_device",
    "_identity_with_attr_like_rhs", "IdentityAttachKLSparseReg",
    "_rnn_param_concat", "_sparse_retain", "_scatter_set_nd",
    "_slice_assign", "_slice_assign_scalar", "Crop", "_image_crop",
    "_contrib_round_ste", "_contrib_sign_ste",
    "_contrib_gradientmultiplier", "linalg_extractdiag", "linalg_makediag",
    "linalg_extracttrian", "linalg_maketrian", "broadcast_maximum",
    "broadcast_minimum", "broadcast_equal", "broadcast_not_equal",
    "broadcast_greater", "broadcast_greater_equal", "broadcast_lesser",
    "broadcast_lesser_equal", "broadcast_logical_and",
    "broadcast_logical_or", "broadcast_logical_xor", "_equal_scalar",
    "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
    "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
    "_logical_or_scalar", "_logical_xor_scalar", "_maximum_scalar",
    "_minimum_scalar", "Dropout", "all_finite", "multi_all_finite",
    "reset_arrays", "LinearRegressionOutput", "MAERegressionOutput",
    "SequenceMask", "SequenceLast", "SequenceReverse", "_linspace"))
# the sweep's tolerances on the card against the CPU: f32 at
# OPS_RTOL/OPS_ATOL, bf16 at OPS_BF16_RTOL of the tensor's largest value
OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
OPS_BF16_RTOL = 2.0 ** -7
# ops whose CUDA math differs from the CPU's beyond OPS_RTOL: (rtol,
# atol) and why; the phase prints each one's measured error.  None needs
# it on the H100 (erfinv, digamma and gammaln included)
OPS_CARD_LOOSE = {}
SAMPLER_DRAWS = 10 ** 6
SAMPLER_SIGMAS = 5.0


def _canon_out(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def run_op_case(mx, np, torch, ctx, op, arrays, attrs, dtypes, heads=None,
                seed=None):
    """One OP_CASES case through ``mx.nd`` on ``ctx``: the outputs and,
    for a differentiable op, the gradients of its non-index inputs under
    ``autograd.record()`` with the head gradient ``heads`` (seeded normal
    draws when None); all returned as CPU tensors."""
    from mxnet_tpu_torch.ops import registry
    reg = registry.get(op)
    idx = INDEX_INPUTS.get(op, ())
    with ctx:
        nds = [mx.nd.array(a, ctx=ctx, dtype=dt)
               for a, dt in zip(arrays, dtypes)]
        diff = [k for k in range(len(nds)) if k not in idx
                and nds[k]._data.is_floating_point()] \
            if reg.differentiable and op not in RANDOM_CASE_OPS else []
        if seed is not None:
            mx.random.seed(seed)
        if not diff:
            outs = _canon_out(registry.apply_op(reg, *nds, **attrs))
            return [o._data.detach().cpu() for o in outs], None, None
        for k in diff:
            nds[k].attach_grad()
        with mx.autograd.record():
            outs = _canon_out(registry.apply_op(reg, *nds, **attrs))
        if heads is None:
            rng = np.random.RandomState(SEED + 1)
            heads = [np.asarray(rng.randn(*o.shape) * 0.5, np.float32)
                     for o in outs]
            if op == "linalg_syevd":
                heads[0] = np.zeros_like(heads[0])   # lam's gradient only
        mx.autograd.backward(outs, [
            mx.nd.array(h, ctx=ctx, dtype=o._data.dtype)
            for h, o in zip(heads, outs)])
        return ([o._data.detach().cpu() for o in outs],
                {k: nds[k].grad._data.cpu() for k in diff}, heads)


RANDOM_CASE_OPS = frozenset(
    RANDOM_OPS + tuple(n + "_like" for n in RANDOM_OPS
                       if n != "_random_randint") + (
        "sample_uniform", "sample_normal", "sample_gamma",
        "sample_exponential", "sample_poisson", "sample_negative_binomial",
        "sample_generalized_negative_binomial", "sample_multinomial",
        "shuffle", "_sample_unique_zipfian"))


def _tol_ratio(torch, got, want, op, exact):
    """max |got - want| over its tolerance (<= 1 passes): exact outputs
    and integral ones 0 or inf; bf16 at OPS_BF16_RTOL of the tensor's
    largest value; f32 at rtol/atol (OPS_CARD_LOOSE's where listed)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if exact or not got.is_floating_point():
        same = torch.equal(got, want) or bool(
            (got.isnan() & want.isnan() | (got == want)).all())
        return 0.0 if same else float("inf")
    g, w = got.double(), want.double()
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        scale = OPS_BF16_RTOL * max(float(w.abs().max()), 1e-30)
        return float(err.max()) / scale if err.numel() else 0.0
    rtol, atol = OPS_CARD_LOOSE.get(op, (OPS_RTOL, OPS_ATOL))
    return float((err / (atol + rtol * w.abs())).max()) if err.numel() \
        else 0.0


def _syevd_view(torch, outs):
    u, lam = outs
    return [u.transpose(-1, -2) @ (lam[..., :, None] * u), lam]


def ops_sweep(mx, np, torch, dev="gpu"):
    """Phase ops (a): every OP_CASES case through ``mx.nd`` on the card
    and on the CPU from the same inputs and head gradient, outputs and
    gradients compared (samplers: shape, dtype, and the same bits from one
    seed twice)."""
    ctx = mx.gpu(0) if dev == "gpu" else mx.cpu()
    rows, t0 = [], time.perf_counter()
    for i, (case, _, attrs) in enumerate(OP_CASES):
        op = case.partition("@")[0]
        arrays, dtypes = case_inputs(np, i)
        row = {"case": case}
        if op in RANDOM_CASE_OPS:
            a, _, _ = run_op_case(mx, np, torch, ctx, op, arrays, attrs,
                                  dtypes, seed=SEED + i)
            b, _, _ = run_op_case(mx, np, torch, ctx, op, arrays, attrs,
                                  dtypes, seed=SEED + i)
            c, _, _ = run_op_case(mx, np, torch, mx.cpu(), op, arrays,
                                  attrs, dtypes, seed=SEED + i)
            row["same_bits_twice"] = all(torch.equal(x, y)
                                         for x, y in zip(a, b))
            row["shape_dtype"] = all(
                x.shape == y.shape and x.dtype == y.dtype
                for x, y in zip(a, c))
            row["ok"] = row["same_bits_twice"] and row["shape_dtype"]
            rows.append(row)
            continue
        outs, grads, heads = run_op_case(mx, np, torch, ctx, op, arrays,
                                         attrs, dtypes)
        couts, cgrads, _ = run_op_case(mx, np, torch, mx.cpu(), op, arrays,
                                       attrs, dtypes, heads=heads)
        if op == "linalg_syevd":
            outs, couts = _syevd_view(torch, outs), _syevd_view(torch, couts)
        ratios = [_tol_ratio(torch, g, w, op, op in EXACT_OPS)
                  for g, w in zip(outs, couts)]
        if len(outs) != len(couts):
            ratios.append(float("inf"))
        if grads is not None:
            ratios += [_tol_ratio(torch, grads[k], cgrads[k], op, False)
                       for k in grads]
        row["err_over_tol"] = max(ratios) if ratios else 0.0
        row["max_abs_err"] = max(
            [float((g.double() - w.double()).abs().max())
             for g, w in zip(outs, couts) if g.shape == w.shape
             and g.numel()] or [0.0])
        row["ok"] = row["err_over_tol"] <= 1.0
        if op in OPS_CARD_LOOSE or not row["ok"]:
            _log("[ops] %s" % json.dumps(row))
        rows.append(row)
    for name, rec in CONTROL_FLOW_CASES:
        got = control_flow_case(mx, mx.nd.contrib, np, ctx, name, rec)
        want = control_flow_case(mx, mx.nd.contrib, np, mx.cpu(), name, rec)
        ratios = [_tol_ratio(torch, torch.from_numpy(g), torch.from_numpy(w),
                             name, False) for g, w in zip(got, want)]
        if len(got) != len(want):
            ratios.append(float("inf"))
        row = {"case": "%s@%s" % (name, "record" if rec else "no-record"),
               "err_over_tol": max(ratios)}
        row["ok"] = row["err_over_tol"] <= 1.0
        if not row["ok"]:
            _log("[ops] %s" % json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    worst = sorted((r for r in rows if "err_over_tol" in r),
                   key=lambda r: -r["err_over_tol"])[:5]
    out = {"cases": len(rows), "failed": bad, "worst": worst,
           "seconds": time.perf_counter() - t0,
           "loosened": {op: {"tol": OPS_CARD_LOOSE[op], "rows": [
               r for r in rows if r["case"].partition("@")[0] == op]}
               for op in OPS_CARD_LOOSE}}
    _log("[ops] sweep %s" % json.dumps({k: v for k, v in out.items()
                                        if k != "loosened"}))
    return out


def _sampler_specs(np):
    """(op, attrs, parameter arrays or a like-shape, per-element (mean,
    var)) of the sampler checks at SAMPLER_DRAWS draws."""
    def nb(k, p):
        return k * (1 - p) / p, k * (1 - p) / p ** 2

    fixed = [
        ("_random_uniform", {"low": -1.0, "high": 3.0}, (1.0, 16.0 / 12)),
        ("_random_normal", {"loc": 1.0, "scale": 2.0}, (1.0, 4.0)),
        ("_random_gamma", {"alpha": 2.5, "beta": 0.5}, (1.25, 0.625)),
        ("_random_exponential", {"lam": 2.0}, (0.5, 0.25)),
        ("_random_poisson", {"lam": 4.0}, (4.0, 4.0)),
        ("_random_negative_binomial", {"k": 3, "p": 0.4}, nb(3, 0.4)),
        ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
         (2.0, 2.0 + 0.5 * 4.0)),
        ("_random_randint", {"low": -3, "high": 9}, (2.5, (144 - 1) / 12.0)),
    ]
    specs = [(n, a, None, m) for n, a, m in fixed]
    specs += [(n + "_like", a, (1000, SAMPLER_DRAWS // 1000), m)
              for n, a, m in fixed if n != "_random_randint"]
    per = [
        ("sample_uniform", ([-1.0, 2.0], [0.0, 5.0]),
         lambda lo, hi: ((lo + hi) / 2, (hi - lo) ** 2 / 12)),
        ("sample_normal", ([1.0, -2.0], [2.0, 0.5]),
         lambda m, s: (m, s * s)),
        ("sample_gamma", ([2.5, 1.0], [0.5, 2.0]),
         lambda a, b: (a * b, a * b * b)),
        ("sample_exponential", ([2.0, 0.5],), lambda lam: (1 / lam,
                                                          1 / lam ** 2)),
        ("sample_poisson", ([4.0, 0.5],), lambda lam: (lam, lam)),
        ("sample_negative_binomial", ([3.0, 1.0], [0.4, 0.7]), nb),
        ("sample_generalized_negative_binomial", ([2.0, 5.0], [0.5, 0.2]),
         lambda mu, a: (mu, mu + a * mu * mu)),
    ]
    for n, ps, mom in per:
        arrs = [np.asarray(p, np.float32) for p in ps]
        m = [mom(*[float(a[j]) for a in arrs]) for j in range(2)]
        specs.append((n, {"shape": (SAMPLER_DRAWS // 2,)}, arrs, m))
    return specs


def ops_samplers(mx, np, torch, dev="gpu", draws=None):
    """Phase ops (a), samplers: each at SAMPLER_DRAWS draws on the card;
    the dtype of the CPU's draw, the same bits from one seed twice, and
    the mean and variance within SAMPLER_SIGMAS standard errors of the
    distribution's (per parameter element for sample_*; the variance's
    error from the draws' fourth moment); sample_multinomial's class
    frequencies likewise; shuffle a permutation."""
    from mxnet_tpu_torch.ops import registry
    ctx = mx.gpu(0) if dev == "gpu" else mx.cpu()
    rows = []
    for k, (op, attrs, arg, mom) in enumerate(_sampler_specs(np)):
        attrs = dict(attrs)

        def draw(c, _op=op, _attrs=attrs, _arg=arg, _k=k):
            mx.random.seed(SEED + 100 + _k)
            with c:
                if _arg is None:
                    return registry.apply_op(
                        _op, shape=(draws or SAMPLER_DRAWS,), **_attrs
                    )._data
                if isinstance(_arg, tuple):
                    like = mx.nd.zeros(_arg, ctx=c)
                    return registry.apply_op(_op, like, **_attrs)._data
                return registry.apply_op(_op, *[mx.nd.array(a, ctx=c)
                                                for a in _arg],
                                         **_attrs)._data
        a, b = draw(ctx), draw(ctx)
        dtype_cpu = draw(mx.cpu()).dtype
        x = a.double().reshape(len(mom), -1) if isinstance(mom, list) \
            else a.double().reshape(1, -1)
        moms = mom if isinstance(mom, list) else [mom]
        n = x.shape[1]
        mean, var = x.mean(dim=1), x.var(dim=1, correction=0)
        m4 = ((x - mean[:, None]) ** 4).mean(dim=1)
        z_mean = [abs(float(mean[j]) - moms[j][0])
                  / (moms[j][1] / n) ** 0.5 for j in range(len(moms))]
        z_var = [abs(float(var[j]) - moms[j][1])
                 / max(float(m4[j] - var[j] ** 2) / n, 1e-30) ** 0.5
                 for j in range(len(moms))]
        row = {"op": op, "draws": int(a.numel()), "dtype": str(a.dtype),
               "same_bits_twice": bool(torch.equal(a, b)),
               "dtype_as_cpu": a.dtype == dtype_cpu,
               "mean_sigmas": max(z_mean), "var_sigmas": max(z_var)}
        row["ok"] = (row["same_bits_twice"] and row["dtype_as_cpu"]
                     and max(z_mean + z_var) <= SAMPLER_SIGMAS)
        rows.append(row)
    probs = np.asarray([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]],
                       np.float32)
    mx.random.seed(SEED + 200)
    with ctx:
        drawn = registry.apply_op("sample_multinomial",
                                  mx.nd.array(probs, ctx=ctx),
                                  shape=(draws or SAMPLER_DRAWS) // 2)._data
    freq = torch.stack([torch.bincount(r.long(), minlength=4)
                        for r in drawn.cpu()]).double() / drawn.shape[1]
    se = np.sqrt(probs * (1 - probs) / drawn.shape[1])
    z = float(((freq.numpy() - probs) / se).__abs__().max())
    rows.append({"op": "sample_multinomial", "draws": int(drawn.numel()),
                 "freq_sigmas": z, "ok": z <= SAMPLER_SIGMAS})
    with ctx:
        perm = registry.apply_op("shuffle", mx.nd.array(
            np.arange(4096, dtype=np.float32), ctx=ctx))._data
    rows.append({"op": "shuffle", "ok": bool(torch.equal(
        perm.sort().values.cpu(), torch.arange(4096, dtype=torch.float32)))
        and not bool(torch.equal(perm.cpu(), torch.arange(
            4096, dtype=torch.float32)))})
    for r in rows:
        _log("[ops] sampler %s" % json.dumps(r))
    return rows


# phase ops (b): the op library at model widths, card against CPU
OPS_LN_SHAPE = (8192, 768)              # TransformerLM B=4 S=2048
OPS_DROPOUT_SHAPE = (8192, 3072)        # its d_ff activation, bf16
OPS_EMBED = (32000, 768, 8192)          # vocab, width, ids
OPS_LOGITS = (8192, 32000)              # its logits
OPS_TOPK = (8, 32000, 50)               # the sampling width, k
OPS_NORM_SHAPE = (32, 256, 56, 56)      # ResNet-50's first stage, BS 32
OPS_NORM_GROUPS = 32
OPS_LABELS = (128, 1000)                # ResNet-50's labels
OPS_BMM = (48, 2048, 64)                # attention-shaped products
OPS_LINALG = (64, 128)                  # batched SPD matrices
# width outputs against the CPU: f32 within 2^-16 of the tensor's largest
# magnitude (reductions and products over thousands of terms, summed in
# another order on each side: a few f32 ulps of the largest term), bf16
# within OPS_BF16_RTOL of it; exact ops bit for bit
OPS_WIDTH_F32_TOL = 2.0 ** -16
# syevd: a backward-stable eigensolver's reconstruction U^T diag(lam) U
# is within c n eps ||A|| of A and each eigenvalue within as much of its
# own, n = 128 and eps = 2^-24; so cuSOLVER's and LAPACK's may differ by
# 2 c 2^-17 of the largest |A| (the largest eigenvalue): 2^-12 allows c
# up to 16 (the H100 measured 6.7e-5 on the reconstruction, c ~ 9, and
# 3.7e-5 on the eigenvalues)
OPS_SYEVD_TOL = 2.0 ** -12


def _width_ratio(torch, got, want, exact, tol=None):
    got = got.detach().cpu()
    want = want.detach().cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if exact or not got.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    tol = tol or (OPS_BF16_RTOL if got.dtype == torch.bfloat16
                  else OPS_WIDTH_F32_TOL)
    # in f32: the difference of two f32 values is exact to within an
    # ulp of itself, far below these tolerances
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / (tol * scale)


def _nd_call(mx, op, nds, attrs, grad_of=(), heads=None):
    """``mx.nd.<op>`` on NDArrays; with ``grad_of``, under ``record()``
    and back from ``heads`` (a list, or a function of the outputs that
    makes it): (outputs, gradients, heads)."""
    from mxnet_tpu_torch.ops import registry
    if not grad_of:
        return _canon_out(registry.apply_op(op, *nds, **attrs)), [], None
    for k in grad_of:
        nds[k].attach_grad()
    with mx.autograd.record():
        outs = _canon_out(registry.apply_op(op, *nds, **attrs))
    if callable(heads):
        heads = heads(outs)
    mx.autograd.backward(outs, heads)
    return outs, [nds[k].grad for k in grad_of], heads


def _width_case(mx, np, torch, dev, label, op, arrays, attrs, grad_of=(),
                exact=False, dtypes=None, nbytes=0, flops=0, peak=None,
                library=None, view=None, tols=None, cpu_grads=True,
                reuse=None):
    """One (b) case: ``op`` on the card and on the CPU from the same
    inputs (numpy arrays or CPU tensors) and, for ``grad_of``, the same
    seeded head gradients; outputs compared (through ``view`` where
    given, ``tols`` overriding an output's tolerance) and gradients at
    tolerance (``cpu_grads=False``: the card's backward is timed, not
    compared).  ``reuse`` (a dict) keeps the CPU outputs for a later case
    computing the same values.  The card's forward (and forward +
    backward) are timed by CUDA events, beside ``library`` (one PyTorch
    call computing the same, where there is one) and the bound of
    ``nbytes`` / ``flops``."""
    t0 = time.perf_counter()
    gctx = mx.gpu(0) if dev == "gpu" else mx.cpu()
    dtypes = dtypes or [None] * len(arrays)
    heads = []   # seeded on the CPU from the card's outputs, then shared

    def make_heads(outs, ctx):
        if not heads:
            g = torch.Generator().manual_seed(SEED + 3)
            heads.extend(torch.randn(o.shape, generator=g).to(
                o._data.dtype) for o in outs)
        return [mx.nd.array(h, ctx=ctx, dtype=h.dtype) for h in heads]
    res = {}
    for side, ctx in (("card", gctx), ("cpu", mx.cpu())):
        if side == "cpu" and reuse is not None and "cpu" in reuse:
            res[side] = reuse["cpu"]
            continue
        nds = [mx.nd.array(a, ctx=ctx, dtype=dt)
               for a, dt in zip(arrays, dtypes)]
        back = grad_of if (side == "card" or cpu_grads) else ()
        outs, grads, hd = _nd_call(mx, op, nds, attrs, back,
                                   lambda o, c=ctx: make_heads(o, c))
        outs = [o._data for o in outs]
        res[side] = (view(torch, outs) if view else outs,
                     [gr._data for gr in grads] if cpu_grads else [],
                     nds, hd)
    if reuse is not None:
        reuse["cpu"] = res["cpu"]
    tols = tols or [None] * len(res["card"][0])
    ratio = max([_width_ratio(torch, g, c, exact, t) for g, c, t in
                 zip(res["card"][0], res["cpu"][0], tols)]
                + [_width_ratio(torch, g, c, False) for g, c in
                   zip(res["card"][1], res["cpu"][1])])
    row = {"case": label, "err_over_tol": ratio, "ok": ratio <= 1.0,
           "gradients_compared": bool(grad_of) and cpu_grads}
    if dev == "gpu":
        nds, hd = res["card"][2], res["card"][3]
        plain = [x.detach() for x in nds]
        row["ms"] = _time_ms(lambda: _nd_call(mx, op, plain, attrs),
                             iters=10, warmup=2)
        if grad_of:
            row["fwd_bwd_ms"] = _time_ms(lambda: _nd_call(
                mx, op, nds, attrs, grad_of, hd), iters=5, warmup=1)
        if library is not None:
            ts = [x._data for x in plain]
            row["library_ms"] = _time_ms(lambda: library(*ts), iters=10,
                                         warmup=2)
        if nbytes or flops:
            row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, flops,
                                                         peak)
    del res
    row["seconds"] = time.perf_counter() - t0
    _log("[ops] width %s" % json.dumps(row))
    return row


def _randn(torch, shape, seed, scale=1.0):
    """Seeded normal draws on the CPU (PyTorch's generator: fast at model
    widths, where numpy's takes seconds)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        seed)) * scale


def ops_widths(mx, np, torch, dev="gpu"):
    """Phase ops (b): the op library at TransformerLM and ResNet-50
    widths, against the CPU on the same inputs."""
    import torch.nn.functional as F
    rng = np.random.RandomState(SEED + 40)
    rows = []
    n, d = OPS_LN_SHAPE
    ln_in = [_randn(torch, (n, d), SEED + 43),
             rng.uniform(0.5, 1.5, d).astype(np.float32),
             (rng.randn(d) * 0.1).astype(np.float32)]
    for dt, size in (("float32", 4), ("bfloat16", 2)):
        rows.append(_width_case(
            mx, np, torch, dev, "LayerNorm %dx%d %s" % (n, d, dt),
            "LayerNorm", ln_in, {}, grad_of=(0, 1, 2),
            dtypes=[dt, None, None], nbytes=2 * n * d * size,
            library=lambda x, g, b: F.layer_norm(x, (d,), g.to(x.dtype),
                                                 b.to(x.dtype), 1e-5)))
    rows.append(ops_dropout(mx, np, torch, dev))
    v, w, ids = OPS_EMBED
    emb_in = [rng.randint(0, v, ids).astype(np.float32),
              _randn(torch, (v, w), SEED + 44, 0.02)]
    rows.append(_width_case(
        mx, np, torch, dev, "Embedding %dx%d, %d ids" % (v, w, ids),
        "Embedding", emb_in, {"input_dim": v, "output_dim": w},
        grad_of=(1,), exact=True, nbytes=2 * ids * w * 4,
        library=lambda i, wt: F.embedding(i.long(), wt)))
    b, c = OPS_LOGITS
    logits = _randn(torch, (b, c), SEED + 45, 2.0)
    labels = rng.randint(0, c, b).astype(np.float32)
    rows.append(_width_case(
        mx, np, torch, dev, "softmax_cross_entropy %dx%d" % (b, c),
        "softmax_cross_entropy", [logits, labels], {}, grad_of=(0,),
        nbytes=b * c * 4,
        library=lambda x, y: F.cross_entropy(x, y.long(), reduction="sum")))
    rows.append(_width_case(
        mx, np, torch, dev, "log_softmax %dx%d" % (b, c), "log_softmax",
        [logits], {}, grad_of=(0,), nbytes=2 * b * c * 4))
    del logits
    r, c, k = OPS_TOPK
    tie_free = (rng.permutation(r * c).reshape(r, c) / float(r * c)
                ).astype(np.float32)
    for label, op, attrs in (("topk k=%d" % k, "topk",
                              {"k": k, "ret_typ": "both"}),
                             ("sort", "sort", {}), ("argsort", "argsort", {})):
        rows.append(_width_case(mx, np, torch, dev, "%s %dx%d" % (label, r, c),
                                op, [tie_free], attrs, exact=True,
                                nbytes=2 * r * c * 4))
    shape = OPS_NORM_SHAPE
    x = _randn(torch, shape, SEED + 46)
    gam = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    bet = (rng.randn(shape[1]) * 0.1).astype(np.float32)
    elems = int(np.prod(shape))
    rows.append(_width_case(
        mx, np, torch, dev, "GroupNorm %s, %d groups" % (
            "x".join(map(str, shape)), OPS_NORM_GROUPS), "GroupNorm",
        [x, gam, bet], {"num_groups": OPS_NORM_GROUPS}, grad_of=(0, 1, 2),
        cpu_grads=False, nbytes=2 * elems * 4,
        library=lambda t, g, bb: F.group_norm(t, OPS_NORM_GROUPS, g, bb,
                                              1e-5)))
    rows.append(_width_case(
        mx, np, torch, dev, "InstanceNorm %s" % "x".join(map(str, shape)),
        "InstanceNorm", [x, gam, bet], {}, grad_of=(0, 1, 2),
        cpu_grads=False, nbytes=2 * elems * 4,
        library=lambda t, g, bb: F.instance_norm(t, weight=g, bias=bb,
                                                 eps=1e-3)))
    del x
    nb, ncls = OPS_LABELS
    scores = rng.randn(nb, ncls).astype(np.float32)
    lab = rng.randint(0, ncls, nb).astype(np.float32)
    coords = np.stack([np.arange(nb), rng.randint(0, ncls, nb)]).astype(
        np.float32)
    for label, op, arrays, attrs in (
            ("one_hot", "one_hot", [lab], {"depth": ncls}),
            ("take", "take", [scores, lab], {"axis": 1}),
            ("pick", "pick", [scores, lab], {"axis": 1}),
            ("gather_nd", "gather_nd", [scores, coords], {})):
        rows.append(_width_case(mx, np, torch, dev,
                                "%s %dx%d" % (label, nb, ncls), op, arrays,
                                attrs, exact=True))
    bsz, seq, hd = OPS_BMM
    q = _randn(torch, (bsz, seq, hd), SEED + 47)
    kk = _randn(torch, (bsz, seq, hd), SEED + 48)
    flops = 2 * bsz * seq * seq * hd
    same = {}   # gemm2 at alpha 1 computes batch_dot's values
    for op in ("batch_dot", "linalg_gemm2"):
        rows.append(_width_case(
            mx, np, torch, dev, "%s %dx%dx%d by its transpose, f32" % (
                op, bsz, seq, hd), op, [q, kk], {"transpose_b": True},
            nbytes=(2 * bsz * seq * hd + bsz * seq * seq) * 4, flops=flops,
            peak=PEAK_F32_FLOPS, reuse=same,
            library=lambda a, bb: torch.bmm(a, bb.transpose(1, 2))))
    del same
    del q, kk
    nm, m = OPS_LINALG
    base = rng.randn(nm, m, m)
    spd = (base @ np.swapaxes(base, -1, -2) + m * np.eye(m)).astype(
        np.float32)
    chol = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    rhs = rng.randn(nm, m, m).astype(np.float32)
    for label, op, arrays in (("linalg_potrf", "linalg_potrf", [spd]),
                              ("linalg_trsm", "linalg_trsm", [chol, rhs]),
                              ("linalg_syevd", "linalg_syevd", [spd])):
        rows.append(_width_case(
            mx, np, torch, dev, "%s %dx%dx%d SPD" % (label, nm, m, m), op,
            arrays, {}, nbytes=2 * nm * m * m * 4,
            **({"view": _syevd_view, "tols": [OPS_SYEVD_TOL] * 2}
               if op == "linalg_syevd" else {})))
    return rows


def _htod_copies(torch, fn, workdir, calls=5, attempts=PROFILE_ATTEMPTS):
    """The host-to-device copies a ``torch.profiler`` window over
    ``calls`` calls of ``fn()`` records, as their byte counts (from the
    exported trace's ``bytes``; -1 where it gives none); None when no
    window of ``attempts`` records any CUDA activity (late in a long
    process a window can come back empty: see ``_profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        if device:
            break
    else:
        return None
    htod = [ev for ev in device if "HtoD" in ev.name]
    if not htod:
        return []
    path = os.path.join(workdir, "dropout_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    sizes = [int(e.get("args", {}).get("bytes", -1)) for e in events
             if "HtoD" in e.get("name", "")]
    return sizes + [-1] * (len(htod) - len(sizes))


def ops_dropout(mx, np, torch, dev="gpu", workdir=None):
    """Phase ops (b), Dropout p=0.1 in training on a [8192, 3072] bf16
    activation: the kept fraction within 5 sigma of 0.9; every kept value
    equal to x / 0.9 in bf16 (``dropout_apply`` on the CPU with the
    card's mask); two draws from one seed the same bits; and no
    host-to-device copy over 1 MB in a profiled window of calls (the
    mask is drawn on the card).  Beside it, whether a call makes a
    synchronizing CUDA call (``torch.cuda.set_sync_debug_mode``), which
    a blocking host copy would be."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.nn import dropout_apply
    t0 = time.perf_counter()
    ctx = mx.gpu(0) if dev == "gpu" else mx.cpu()
    rows, cols = OPS_DROPOUT_SHAPE
    rng = np.random.RandomState(SEED + 41)
    x = mx.nd.array(rng.randn(rows, cols).astype(np.float32) + 4.0, ctx=ctx,
                    dtype="bfloat16")

    def call():
        return mx.nd.Dropout(x, p=0.1, training=True)
    mx.random.seed(SEED + 42)
    a = call()._data
    mx.random.seed(SEED + 42)
    b = call()._data
    kept = a != 0
    n = kept.numel()
    frac = float(kept.float().mean())
    sigma = (0.9 * 0.1 / n) ** 0.5
    want = dropout_apply(x._data.cpu(), kept.cpu(), 0.9)
    row = {"case": "Dropout p=0.1 %dx%d bf16" % (rows, cols),
           "kept_fraction": frac, "kept_sigmas": abs(frac - 0.9) / sigma,
           "kept_values_equal": bool(torch.equal(a.cpu(), want)),
           "same_bits_twice": bool(torch.equal(a, b))}
    ok = (row["kept_sigmas"] <= 5.0 and row["kept_values_equal"]
          and row["same_bits_twice"])
    if dev == "gpu":
        copies = _htod_copies(torch, call, workdir or os.path.join(
            ROOT, "build", "chip_smoke"))
        row["htod_copies_bytes"] = copies
        # and without the profiler: a blocking host-to-device copy is a
        # synchronizing call, which this mode turns into an error
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
            row["synchronizing_calls"] = None
        except RuntimeError as exc:
            row["synchronizing_calls"] = str(exc)[:200]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ok = ok and copies is not None and all(0 <= c <= 2 ** 20
                                               for c in copies)
        row["ms"] = _time_ms(call)
        xt = x._data
        row["library_ms"] = _time_ms(lambda: F.dropout(xt, 0.1, True))
        row["bound_ms"], row["bound_by"] = _bound_ms(2 * n * 2, 0)
    row["ok"] = ok
    row["seconds"] = time.perf_counter() - t0
    _log("[ops] width %s" % json.dumps(row))
    return row


# phase ops (c): the multi-tensor update ops over full parameter lists
OPS_UPDATE_TOL = 2.0 ** -20


def _update_lists(np, torch, shapes, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w32 = [torch.randn(s, generator=g, device=dev) * 0.05 for s in shapes]
    grads = [(torch.randn(s, generator=g, device=dev) * 0.01).bfloat16()
             for s in shapes]
    ms = [torch.randn(s, generator=g, device=dev) * 0.001 for s in shapes]
    vs = [torch.rand(s, generator=g, device=dev) * 1e-4 for s in shapes]
    return w32, grads, ms, vs


def _update_case(mx, np, torch, dev, label, op, groups, attrs, n,
                 nbytes, k_call):
    """``op`` over ``groups`` (per tensor: its inputs; ``n`` tensors)
    through ``mx.nd`` on the card and on the CPU: every output within
    OPS_UPDATE_TOL of its tensor's largest magnitude, each bf16 weight the
    cast of its new master; timed by CUDA events beside ``k_call`` (the
    fused kernel's one call over the same list)."""
    t0 = time.perf_counter()
    ctx = mx.gpu(0) if dev == "gpu" else mx.cpu()
    flat = [t for grp in groups for t in grp]
    nds = [mx.nd.NDArray(t, ctx=ctx, dtype=t.dtype) for t in flat]
    cpu = [mx.nd.NDArray(t.cpu(), ctx=mx.cpu(), dtype=t.dtype)
           for t in flat]
    got = getattr(mx.nd, op)(*nds, **attrs)
    want = getattr(mx.nd, op)(*cpu, **attrs)
    worst = 0.0
    for g, w in zip(got, want):
        gw, ww = g._data.cpu().float(), w._data.float()
        scale = max(float(ww.abs().max()), 1e-30)
        worst = max(worst, float((gw - ww).abs().max()) / scale)
    masters = got[-n:]
    cast_ok = all(torch.equal(got[k]._data, masters[k]._data.bfloat16())
                  for k in range(n))
    row = {"case": label, "tensors": n,
           "params": sum(grp[0].numel() for grp in groups[:n]),
           "max_rel_err": worst, "weights_are_master_casts": cast_ok,
           "ok": worst <= OPS_UPDATE_TOL and cast_ok}
    del want, cpu
    if dev == "gpu":
        row["ms"] = _time_ms(lambda: getattr(mx.nd, op)(*nds, **attrs),
                             iters=5, warmup=1)
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, 0)
        if k_call is not None:
            # the fused kernel's wrapper call (checks, table fill and
            # copy, launch) and its launch alone over the filled table
            row["fused_kernel_call_ms"] = _time_ms(k_call, iters=10,
                                                   warmup=2)
            row["fused_kernel_ms"] = _time_ms(k_call.launch, iters=10,
                                              warmup=2)
    row["seconds"] = time.perf_counter() - t0
    _log("[ops] update %s" % json.dumps(row))
    return row


def ops_updates(mx, ck, np, torch, dev="gpu"):
    """Phase ops (c): ``multi_mp_sgd_mom_update`` over resnet50_v1's 193
    trainable tensors and ``_multi_mp_adamw_update`` over the full-width
    TransformerLM's 9 (bf16 weights and gradients, f32 masters and
    moments), as a custom loop calls them, each beside K1's / K3's one
    call over the same list."""
    from mxnet_tpu_torch.models.transformer import TransformerLMConfig
    tdev = "cuda" if dev == "gpu" else "cpu"
    rows = []
    shapes = _resnet_shapes(mx, np)
    w32, gs, ms, _ = _update_lists(np, torch, shapes, tdev, SEED + 50)
    ws = [w.bfloat16() for w in w32]
    n = len(shapes)
    lrs, wds = [0.1] * n, [SGD_WD] * n
    params = sum(w.numel() for w in w32)
    k_call = None
    if dev == "gpu":
        kw, km = [w.clone() for w in w32], [m.clone() for m in ms]
        kout = [w.clone() for w in ws]
        table = ck.LaunchTable()

        def k_call():
            ck.fused_sgd_step_multi(kw, gs, km, lrs, wds, 0.9, outs=kout,
                                    table=table)
        k_call()
        kdev, kblocks = table.fill(ck.SGD_LAYOUT, (kw, km, kout), gs, lrs,
                                   wds)
        k_call.launch = lambda: ck._launch_sgd(kdev, n, kblocks, 0.9, kw[0])
    rows.append(_update_case(
        mx, np, torch, dev, "multi_mp_sgd_mom_update, resnet50_v1's %d "
        "tensors" % n, "multi_mp_sgd_mom_update",
        [(w, g, m, w3) for w, g, m, w3 in zip(ws, gs, ms, w32)],
        {"lrs": lrs, "wds": wds, "momentum": 0.9, "num_weights": n}, n,
        params * (2 + 4 + 4 + 2 + 4 + 4), k_call))
    del w32, gs, ms, ws
    shapes = list(_adam_shapes(TransformerLMConfig()).values())
    w32, gs, ms, vs = _update_lists(np, torch, shapes, tdev, SEED + 51)
    ws = [w.bfloat16() for w in w32]
    n = len(shapes)
    scale = torch.ones(1, device=tdev)
    params = sum(w.numel() for w in w32)
    attrs = {"lrs": (1e-3,) * n, "wds": (ADAM_WD,) * n, "etas": (1.0,) * n,
             "num_weights": n}
    k_call = None
    if dev == "gpu":
        kw = [w.clone() for w in w32]
        km, kv = [m.clone() for m in ms], [v.clone() for v in vs]
        kout = [w.clone() for w in ws]
        table = ck.LaunchTable()

        def k_call():
            ck.fused_adam_step_multi(kw, gs, km, kv, [1e-3] * n,
                                     [ADAM_WD] * n, 0.9, 0.999, 1e-8,
                                     outs=kout, table=table)
        k_call()
        kdev, kblocks = table.fill(ck.ADAM_LAYOUT, (kw, km, kv, kout), gs,
                                   [1e-3] * n, [ADAM_WD] * n)
        k_call.launch = lambda: ck._launch_adam(kdev, n, kblocks, 0.9,
                                                0.999, 1e-8, kw[0])
    groups = [(w, g, m, v, w3) for w, g, m, v, w3 in
              zip(ws, gs, ms, vs, w32)] + [(scale,)]
    rows.append(_update_case(
        mx, np, torch, dev, "_multi_mp_adamw_update, the full-width "
        "TransformerLM's %d tensors" % n, "_multi_mp_adamw_update",
        groups, attrs, n, params * (2 + 4 + 4 + 4 + 2 + 4 + 4 + 4), k_call))
    return rows


def ops_phase(mx, ck, np, torch, dev="gpu"):
    """Phase ops: (a) the sweep and the samplers, (b) the model widths,
    (c) the update ops over full parameter lists.  No fused kernel may
    launch in (a) and (b): the op library is plain PyTorch."""
    t0 = time.perf_counter()
    if dev == "gpu":
        torch.cuda.synchronize()
    ck.reset_launches()
    out, secs = {}, {}
    for part, fn in (("sweep", ops_sweep), ("samplers", ops_samplers),
                     ("widths", ops_widths)):
        t1 = time.perf_counter()
        out[part] = fn(mx, np, torch, dev)
        secs[part] = time.perf_counter() - t1
    out["kernel_launches_in_a_b"] = sum(ck.LAUNCHES.values())
    t1 = time.perf_counter()
    out["updates"] = ops_updates(mx, ck, np, torch, dev)
    secs["updates"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = secs
    bad = (out["sweep"]["failed"]
           + [r for r in out["samplers"] + out["widths"] + out["updates"]
              if not r["ok"]])
    if bad or out["kernel_launches_in_a_b"]:
        raise AssertionError("phase ops failed: %s (kernel launches in "
                             "(a)-(b): %d)" % (json.dumps(bad),
                                               out["kernel_launches_in_a_b"]))
    _log("[ops] phase %s" % json.dumps({"seconds": out["seconds"],
                                        "part_seconds": secs,
                                        "cases": out["sweep"]["cases"]}))
    return out


# ------------------------------------------------------------ phase rnn
# examples/rnn_lm.py and examples/rnn_bucketing.py, carried over: their
# model, corpus and batching, built from whichever package is passed in
def rnn_lm_model(gluon, vocab, embed, hidden, layers, dropout=0.2):
    """``examples/rnn_lm.py``'s ``RNNModel`` over ``gluon`` (Embedding,
    Dropout, a fused ``rnn.LSTM`` of TNC layout, a Dense decoder)."""
    nn, rnn = gluon.nn, gluon.rnn

    class RNNModel(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.embedding = nn.Embedding(vocab, embed)
                self.drop = nn.Dropout(dropout)
                self.lstm = rnn.LSTM(hidden, num_layers=layers,
                                     dropout=dropout, input_size=embed)
                self.decoder = nn.Dense(vocab, flatten=False,
                                        in_units=hidden)

        def hybrid_forward(self, F, x, states):
            emb = self.drop(self.embedding(x))
            out, states = self.lstm(emb, states)
            return self.decoder(self.drop(out)), states

        def begin_state(self, batch_size, **kwargs):
            return self.lstm.begin_state(batch_size=batch_size, **kwargs)

    return RNNModel()


def lm_corpus(np, vocab, n, seed=0):
    """``examples/rnn_lm.py``'s ``synthetic_corpus``: a Markov chain
    ``t+1 = (3 t + noise) % vocab``."""
    rng = np.random.RandomState(seed)
    toks = np.zeros(n, np.int64)
    for i in range(1, n):
        toks[i] = (toks[i - 1] * 3 + rng.randint(0, 3)) % vocab
    return toks


def lm_batches(toks, batch_size, seq_len):
    """``examples/rnn_lm.py``'s ``batchify``: ([T, B] inputs, targets)."""
    n = (len(toks) - 1) // (batch_size * seq_len) * batch_size * seq_len
    x = toks[:n].reshape(batch_size, -1).T
    y = toks[1:n + 1].reshape(batch_size, -1).T
    return [(x[i:i + seq_len], y[i:i + seq_len])
            for i in range(0, x.shape[0] - seq_len + 1, seq_len)]


def bucket_corpus(np, n_sentences, vocab, seed=0):
    """``examples/rnn_bucketing.py``'s ``synthetic_corpus``: sentences of
    8, 16 or 24 tokens following ``t -> (5 t + 3) % vocab``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_sentences):
        length = int(rng.choice([8, 16, 24]))
        t = int(rng.randint(1, vocab))
        sent = [t]
        for _ in range(length - 1):
            t = (5 * t + 3) % vocab or 1
            if rng.uniform() < 0.05:
                t = int(rng.randint(1, vocab))
            sent.append(t)
        out.append(sent)
    return out


def bucket_cell(mx, hidden, layers, fused):
    """``examples/rnn_bucketing.py``'s cell: ``layers`` unrolled
    ``LSTMCell``s, or one ``FusedRNNCell`` (``--fused``)."""
    if fused:
        return mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm",
                                   prefix="lstm_")
    cell = mx.rnn.SequentialRNNCell()
    for i in range(layers):
        cell.add(mx.rnn.LSTMCell(hidden, prefix="lstm_l%d_" % i))
    return cell


def bucket_sym_gen(mx, cell, vocab, embed, hidden):
    """``examples/rnn_bucketing.py``'s ``sym_gen``: Embedding, the cell
    unrolled to the bucket's length, a Dense readout, SoftmaxOutput."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                               name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = mx.sym.FullyConnected(
            mx.sym.Reshape(outputs, shape=(-1, hidden)), num_hidden=vocab,
            name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, lab, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


#: phase rnn(a): the RNN op at the LM's widths, card against CPU
RNN_T, RNN_B, RNN_WIDTH = 35, 32, 650
RNN_OP_CASES = tuple((mode, layers, bi) for mode in (
    "lstm", "gru", "rnn_tanh", "rnn_relu") for layers in (1, 2)
    for bi in (False, True))
#: card against CPU, per tensor: max |card - cpu| over the CPU tensor's
#: largest magnitude.  Both run f32 recurrences (TF32 off) that sum each
#: 650-long product in another order (~1e-6 relative a product) and
#: carry it through 35 steps, where the gates' sigmoid/tanh damp it; the
#: gradients of the blob and the data sum 1120 such terms.  1e-4 leaves
#: a wide margin over that and is far below a wrong gate or direction.
RNN_OP_RTOL = 1e-4
#: ReLU's derivative jumps at 0: a pre-activation within f32 rounding of
#: the kink (|z| below RNN_KINK_REL of the largest |z|; the forward
#: agrees to ~1e-6) may fall on either side on the card and the CPU, and
#: its unit's gradient, carried back through the steps, then differs by
#: its whole size.  Where the CPU's own recurrence has such a unit, the
#: f32 gradients are reported, and the gradients are held to
#: RNN_OP_RTOL in f64 instead (cuDNN's f64 recurrence against the CPU's,
#: where no rounding reaches the kink).
RNN_KINK_REL = 1e-5
RNN_TIMED = (("lstm", 2, False), ("lstm", 2, True))
RNN_ITERS = 5
#: phase rnn(b): examples/rnn_lm.py at MXNet's example/rnn/word_lm width
#: (Zaremba et al. 2014 "medium" PTB): its dropout, Adam and lr
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS = 10000, 650, 650, 2
LM_BPTT, LM_BATCH, LM_DROPOUT, LM_LR = 35, 32, 0.2, 0.01
LM_TOKENS, LM_WARMUP, LM_STEPS = 40000, 3, 20
#: phase rnn(c): examples/rnn_bucketing.py at MXNet's example/rnn/
#: bucketing width, its sentence lengths 8/16/24, its Adam and lr
BK_VOCAB, BK_EMBED, BK_HIDDEN, BK_LAYERS = 10000, 200, 200, 2
BK_BATCH, BK_SENTENCES, BK_LR, BK_STEPS = 32, 800, 0.01, 20


def _rel_err(np, got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.astype(np.float64) - want).max()) / scale


def _rnn_op_run(mx, np, arrays, heads, ctx, attrs):
    """``mx.nd.RNN`` under ``record()`` on ``ctx``: outputs and the
    gradients of every input, as numpy."""
    with ctx:
        nds = [mx.nd.array(a) for a in arrays]
        for a in nds:
            a.attach_grad()
        with mx.autograd.record():
            outs = mx.nd.RNN(*nds, **attrs)
        n = 3 if attrs["mode"] == "lstm" else 2
        mx.autograd.backward(list(outs[:n]),
                             [mx.nd.array(h) for h in heads[:n]])
        return ([o.asnumpy() for o in outs],
                [a.grad.asnumpy() for a in nds])


def _rnn_op_inputs(np, mode, layers, bi, seed):
    from mxnet_tpu_torch.rnn._fused_layout import fused_rnn_param_size
    w = RNN_WIDTH
    d = 2 if bi else 1
    rng = np.random.RandomState(seed)
    n = fused_rnn_param_size(w, w, layers, mode, bi)
    # PyTorch's own recurrent init range, U(-1/sqrt(H), 1/sqrt(H))
    scale = 1.0 / np.sqrt(w)
    arrays = [rng.randn(RNN_T, RNN_B, w).astype(np.float32),
              rng.uniform(-scale, scale, n).astype(np.float32),
              (0.5 * rng.randn(layers * d, RNN_B, w)).astype(np.float32)]
    if mode == "lstm":
        arrays.append((0.5 * rng.randn(layers * d, RNN_B, w))
                      .astype(np.float32))
    heads = [rng.randn(RNN_T, RNN_B, d * w).astype(np.float32),
             rng.randn(layers * d, RNN_B, w).astype(np.float32),
             rng.randn(layers * d, RNN_B, w).astype(np.float32)]
    return arrays, heads


def _rnn_op_timing(mx, np, torch, mode, layers, bi, dev):
    """The op (forward; forward and backward) beside one ``torch.nn.LSTM``
    call over the same weights (flattened once, as the module keeps
    them), by CUDA events; and each one's device time by kind, whose
    copies are the op's repacking of the blob into cuDNN's buffer."""
    from mxnet_tpu_torch.ops.registry import get
    from mxnet_tpu_torch.rnn._fused_layout import fused_rnn_group_slices
    arrays, heads = _rnn_op_inputs(np, mode, layers, bi, 1)
    x, blob, h0, c0 = [torch.as_tensor(a, device=dev) for a in arrays]
    op = get("RNN").fn
    attrs = dict(state_size=RNN_WIDTH, num_layers=layers,
                 bidirectional=bi, mode=mode)
    lstm = torch.nn.LSTM(RNN_WIDTH, RNN_WIDTH, num_layers=layers,
                         bidirectional=bi).to(dev)
    gb = 4 * RNN_WIDTH
    groups = fused_rnn_group_slices(RNN_WIDTH, RNN_WIDTH, layers, mode, bi)
    with torch.no_grad():
        for k, (iw, ish, hw, hsh, ib, hb) in enumerate(groups):
            layer, direction = divmod(k, 2 if bi else 1)
            sfx = "_l%d%s" % (layer, "_reverse" if direction else "")
            getattr(lstm, "weight_ih" + sfx).copy_(
                blob[iw:iw + gb * ish[1]].view(ish))
            getattr(lstm, "weight_hh" + sfx).copy_(
                blob[hw:hw + gb * RNN_WIDTH].view(hsh))
            getattr(lstm, "bias_ih" + sfx).copy_(blob[ib:ib + gb])
            getattr(lstm, "bias_hh" + sfx).copy_(blob[hb:hb + gb])
    lstm.flatten_parameters()
    with torch.no_grad():
        ours = op(x, blob, h0, c0, **attrs)
        theirs = lstm(x, (h0, c0))
    agree = max(float((ours[0] - theirs[0]).abs().max()),
                float((ours[1] - theirs[1][0]).abs().max()),
                float((ours[2] - theirs[1][1]).abs().max()))
    xg = x.clone().requires_grad_(True)
    bg = blob.clone().requires_grad_(True)
    dout = torch.as_tensor(heads[0], device=dev)

    def op_fwd():
        with torch.no_grad():
            op(x, blob, h0, c0, **attrs)

    def lstm_fwd():
        with torch.no_grad():
            lstm(x, (h0, c0))

    def op_train():
        out = op(xg, bg, h0, c0, **attrs)[0]
        torch.autograd.grad(out, (xg, bg), dout)

    def lstm_train():
        out = lstm(xg, (h0, c0))[0]
        torch.autograd.grad(out, [xg] + list(lstm.parameters()), dout)

    res = {"case": [mode, layers, bi], "max_abs_vs_nn_lstm": agree}
    for name, fn in (("op_forward", op_fwd), ("nn_lstm_forward", lstm_fwd),
                     ("op_train", op_train), ("nn_lstm_train", lstm_train)):
        res[name + "_ms"] = _time_ms(fn, iters=RNN_ITERS)
        prof = _profile(torch, lambda: [fn() for _ in range(RNN_ITERS)],
                        top=6)
        res[name + "_profile"] = prof
    for run in ("forward", "train"):
        groups_op = res["op_%s_profile" % run].get("by_group_ms", {})
        groups_nn = res["nn_lstm_%s_profile" % run].get("by_group_ms", {})
        if groups_op and groups_nn:
            res["repack_device_ms_%s" % run] = (
                groups_op.get("copies and casts", 0.0)
                - groups_nn.get("copies and casts", 0.0)) / RNN_ITERS
        else:
            res["repack_device_ms_%s" % run] = "not measured"
    res["blob_bytes"] = blob.numel() * 4
    return res


def _relu_kinks(np, torch, arrays, layers, bi):
    """Pre-activations of the relu recurrence within RNN_KINK_REL of the
    largest, recomputed step by step in f64 on the host from the same
    inputs."""
    from mxnet_tpu_torch.rnn._fused_layout import fused_rnn_group_slices
    w = RNN_WIDTH
    x, blob, h0 = (torch.as_tensor(a, dtype=torch.float64)
                   for a in arrays[:3])
    d = 2 if bi else 1
    groups = fused_rnn_group_slices(w, w, layers, "rnn_relu", bi)
    zs = []
    inp = x
    for layer in range(layers):
        outs = []
        for k in range(d):
            iw, ish, hw, hsh, ib, hb = groups[layer * d + k]
            wi = blob[iw:iw + w * ish[1]].view(ish)
            wh = blob[hw:hw + w * w].view(hsh)
            proj = inp @ wi.T + blob[ib:ib + w]
            h = h0[layer * d + k]
            steps = range(RNN_T) if k == 0 else range(RNN_T - 1, -1, -1)
            seq = [None] * RNN_T
            for t in steps:
                z = proj[t] + h @ wh.T + blob[hb:hb + w]
                zs.append(z.abs().reshape(-1))
                h = torch.relu(z)
                seq[t] = h
            outs.append(torch.stack(seq))
        inp = torch.cat(outs, -1)
    z = torch.cat(zs)
    return int((z < RNN_KINK_REL * float(z.max())).sum())


def rnn_op_checks(mx, np, torch, dev="gpu"):
    """Phase rnn(a): ``mx.nd.RNN`` on the card against the CPU in every
    mode, 1 and 2 layers, one- and two-directional, at the LM's widths:
    outputs, ``h_n``, ``c_n`` and the gradients of the data, the blob and
    the states within RNN_OP_RTOL; then the op timed beside
    ``torch.nn.LSTM`` (RNN_TIMED)."""
    card = mx.gpu(0) if dev == "gpu" else mx.cpu()
    cases = []
    for k, (mode, layers, bi) in enumerate(RNN_OP_CASES):
        arrays, heads = _rnn_op_inputs(np, mode, layers, bi, k)
        attrs = dict(state_size=RNN_WIDTH, num_layers=layers,
                     bidirectional=bi, mode=mode)
        names = ("out", "h_n", "c_n", "d_data", "d_parameters", "d_state",
                 "d_state_cell")
        got_o, got_g = _rnn_op_run(mx, np, arrays, heads, card, attrs)
        want_o, want_g = _rnn_op_run(mx, np, arrays, heads, mx.cpu(), attrs)
        errs = {name: _rel_err(np, g, w) for name, g, w in zip(
            names, got_o + got_g, want_o + want_g)}
        rec = {"mode": mode, "layers": layers, "bidirectional": bi,
               "rel_err": errs, "max_rel_err": max(errs.values()),
               "finite": all(bool(np.isfinite(a).all())
                             for a in got_o + got_g)}
        gated = errs
        if mode == "rnn_relu":
            rec["kinks"] = _relu_kinks(np, torch, arrays, layers, bi)
        if rec.get("kinks"):
            wide = [a.astype(np.float64) for a in arrays]
            hw = [h.astype(np.float64) for h in heads]
            mx.config.set("numpy.enable_x64", True)
            try:
                got_o, got_g = _rnn_op_run(mx, np, wide, hw, card, attrs)
                want_o, want_g = _rnn_op_run(mx, np, wide, hw, mx.cpu(),
                                             attrs)
            finally:
                mx.config.unset("numpy.enable_x64")
            assert got_o[0].dtype == np.float64, got_o[0].dtype
            rec["rel_err_f64"] = {name: _rel_err(np, g, w) for name, g, w
                                  in zip(names, got_o + got_g,
                                         want_o + want_g)}
            gated = dict(rec["rel_err_f64"], out=errs["out"],
                         h_n=errs["h_n"])
        rec["ok"] = rec["finite"] and max(gated.values()) <= RNN_OP_RTOL
        _log("[rnn-op] %s" % json.dumps(rec))
        cases.append(rec)
    out = {"shape": {"T": RNN_T, "B": RNN_B, "I": RNN_WIDTH,
                     "H": RNN_WIDTH}, "rel_tol": RNN_OP_RTOL,
           "cases": cases}
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError("RNN op: card against CPU beyond %g: %s"
                             % (RNN_OP_RTOL, json.dumps(bad)))
    if dev == "gpu":
        out["timing"] = [_rnn_op_timing(mx, np, torch, *c, "cuda")
                         for c in RNN_TIMED]
        _log("[rnn-op] timing %s" % json.dumps(out["timing"]))
    return out


def train_rnn_lm(mx, ck, np, torch, card):
    """Phase rnn(b): ``examples/rnn_lm.py`` at LM_* (its loop: detached
    states, ``record()``, the mean cross entropy, ``backward``,
    ``gluon.Trainer.step``, the loss read back each step): LM_WARMUP
    steps, then LM_STEPS counted steps (no port kernel may launch: the
    f32 Trainer's Adam is PyTorch ops), a falling finite loss, tokens/s,
    and a profiled window of 3 steps."""
    from mxnet_tpu_torch import telemetry as tt
    toks = lm_corpus(np, LM_VOCAB, LM_TOKENS)
    batches = lm_batches(toks, LM_BATCH, LM_BPTT)
    assert len(batches) >= LM_WARMUP + LM_STEPS + 3, len(batches)
    mx.random.seed(SEED)
    model = rnn_lm_model(mx.gluon, LM_VOCAB, LM_EMBED, LM_HIDDEN,
                         LM_LAYERS, LM_DROPOUT)
    model.initialize(mx.init.Xavier())
    trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": LM_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    states = model.begin_state(LM_BATCH)
    feed = iter(batches)

    def step():
        nonlocal states
        x, y = next(feed)
        xb = mx.nd.array(x.astype(np.float32))
        yb = mx.nd.array(y.astype(np.float32))
        states = [s.detach() for s in states]
        with mx.autograd.record():
            out, states = model(xb, states)
            loss = loss_fn(out.reshape((-1, LM_VOCAB)),
                           yb.reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
        return float(loss.asnumpy())

    for _ in range(LM_WARMUP):
        step()
    _zero_counts(torch, tt, ck)
    losses, step_ms = [], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck), launches
    med = float(np.median(step_ms))
    out = {"config": {"vocab": LM_VOCAB, "embed": LM_EMBED,
                      "hidden": LM_HIDDEN, "layers": LM_LAYERS,
                      "bptt": LM_BPTT, "batch": LM_BATCH,
                      "dropout": LM_DROPOUT, "optimizer": "adam",
                      "lr": LM_LR},
           "params": sum(p.data().size for p in
                         model.collect_params().values()),
           "card": card, "steps": LM_STEPS, "losses": losses,
           "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": LM_BPTT * LM_BATCH / (med / 1e3),
           "launches": launches,
           "losses_finite": bool(np.isfinite(losses).all()),
           "loss_fell": losses[-1] < losses[0]}
    assert out["losses_finite"] and out["loss_fell"], losses
    out["profile"] = _profile(torch, lambda: [step() for _ in range(3)],
                              top=12)
    _log("[rnn-lm] %s" % json.dumps(out))
    return out


def _k3_real_step(ck, torch, mod, batch):
    """One BucketingModule step whose fused update (``step_fused_multi``,
    one K3 launch) is held bitwise against ``fused_adam_step_multi_plain``
    on copies of the same weights, moments and gradients."""
    opt = mod._buckets[mod.default_bucket_key]._optimizer
    real = opt.step_fused_multi
    seen = {}

    def spy(weights, grads, states, lrs, wds, t, outs=None, skip=None):
        assert skip is None     # the nanguard is off in this phase
        ts = t if isinstance(t, (list, tuple)) else [t] * len(weights)
        copies = [(w.clone(), s[0].clone(), s[1].clone())
                  for w, s in zip(weights, states)]
        gs = [g.clone() for g in grads]
        lr_ts = [opt._lr_t_of(lr, ti) for lr, ti in zip(lrs, ts)]
        before = ck.LAUNCHES["adam_step"]
        real(weights, grads, states, lrs, wds, t, outs)
        seen["launches"] = ck.LAUNCHES["adam_step"] - before
        ck.fused_adam_step_multi_plain(
            [c[0] for c in copies], [g.contiguous() for g in gs],
            [c[1] for c in copies], [c[2] for c in copies], lr_ts, wds,
            opt.beta1, opt.beta2, opt.epsilon)
        diff = {"weights": 0, "m": 0, "v": 0}
        for w, s, (cw, cm, cv) in zip(weights, states, copies):
            diff["weights"] += _differing(torch, w, cw)
            diff["m"] += _differing(torch, s[0], cm)
            diff["v"] += _differing(torch, s[1], cv)
        seen["differing"] = diff
        seen["tensors"] = len(weights)
        seen["elements"] = sum(w.numel() for w in weights)

    opt.step_fused_multi = spy
    try:
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
    finally:
        del opt.step_fused_multi
    assert seen.get("launches") == 1 \
        and sum(seen["differing"].values()) == 0, seen
    return seen


def _bucket_loss(np, mod, batch):
    """Mean cross entropy of the step's softmax over the non-pad labels
    (label 0 is the pad, as ``Perplexity(ignore_label=0)`` reads it)."""
    prob = mod.get_outputs()[0]._data
    lab = batch.label[0]._data.reshape(-1).long()
    keep = lab != 0
    p = prob.gather(1, lab[:, None])[:, 0]
    return float((-p[keep].log()).mean())


def train_bucketing(mx, ck, np, torch, card, fused):
    """Phase rnn(c): ``examples/rnn_bucketing.py`` at BK_* through
    ``BucketingModule`` (``--fused``: ``FusedRNNCell`` -> the ``RNN``
    op).  A step on each bucket to build them, one step with K3 bitwise
    against its plain version, then BK_STEPS counted steps across the
    three buckets: exactly one adam_step launch a step and no other
    kernel, step ms by bucket, the host time a step takes to return, the
    losses, and a profiled window of 3 steps."""
    import random as pyrandom
    from mxnet_tpu_torch import telemetry as tt
    sentences = bucket_corpus(np, BK_SENTENCES, BK_VOCAB)
    pyrandom.seed(SEED)
    np.random.seed(SEED)
    it = mx.rnn.BucketSentenceIter(sentences, BK_BATCH, invalid_label=0)
    cell = bucket_cell(mx, BK_HIDDEN, BK_LAYERS, fused)
    mod = mx.mod.BucketingModule(
        bucket_sym_gen(mx, cell, BK_VOCAB, BK_EMBED, BK_HIDDEN),
        default_bucket_key=it.default_bucket_key)
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(SEED)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": BK_LR})

    def batches():
        while True:
            for b in it:
                yield b
            it.reset()

    feed = batches()
    seen = set()
    while seen != set(it.buckets):
        b = next(feed)
        mod.train_step(b)
        seen.add(b.bucket_key)
    out = {"config": {"vocab": BK_VOCAB, "embed": BK_EMBED,
                      "hidden": BK_HIDDEN, "layers": BK_LAYERS,
                      "batch": BK_BATCH, "buckets": list(it.buckets),
                      "fused": fused, "optimizer": "adam", "lr": BK_LR},
           "card": card}
    out["k3_vs_plain"] = _k3_real_step(ck, torch, mod, next(feed))
    _zero_counts(torch, tt, ck)
    keys, losses, step_ms, host_ms = [], [], [], []
    for _ in range(BK_STEPS):
        b = next(feed)
        t0 = time.perf_counter()
        mod.train_step(b)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        keys.append(b.bucket_key)
        losses.append(_bucket_loss(np, mod, b))
    launches = dict(ck.LAUNCHES)
    c = tt.snapshot()["counters"]
    tensors = out["k3_vs_plain"]["tensors"]
    assert launches == _want_launches(ck, adam_step=BK_STEPS), launches
    assert c.get("fused_steps", 0) == BK_STEPS, c
    assert c.get("kernels.fused_step", 0) == tensors * BK_STEPS, c
    assert set(keys) == set(it.buckets), keys
    assert all(np.isfinite(losses)), losses
    by_bucket = {}
    for k, ms, hm in zip(keys, step_ms, host_ms):
        by_bucket.setdefault(k, {"step_ms": [], "host_ms": []})
        by_bucket[k]["step_ms"].append(ms)
        by_bucket[k]["host_ms"].append(hm)
    for k, rec in by_bucket.items():
        rec["median_step_ms"] = float(np.median(rec["step_ms"]))
        rec["median_host_ms"] = float(np.median(rec["host_ms"]))
        rec["tokens_per_s"] = BK_BATCH * k / (rec["median_step_ms"] / 1e3)
    out.update({"steps": BK_STEPS, "bucket_keys": keys, "losses": losses,
                "launches": launches, "tensors": tensors,
                "fused_steps": c.get("fused_steps", 0),
                "kernels_fused_step": c.get("kernels.fused_step", 0),
                "by_bucket": by_bucket,
                "host_share": float(np.sum(host_ms) / np.sum(step_ms))})
    out["profile"] = _profile(
        torch, lambda: [mod.train_step(next(feed)) for _ in range(3)],
        top=12)
    _log("[rnn-bucketing] %s %s" % ("fused" if fused else "unrolled",
                                    json.dumps(out)))
    return out


def rnn_phase(mx, ck, np, torch, card):
    """Phase rnn: the profiler probe, (a) the RNN op card against CPU and
    timed, (b) the Gluon LSTM language model, (c) the bucketed LSTM,
    unrolled and fused."""
    out = {"profiler_probe": profiler_probe(torch)}
    _log("[rnn] profiler probe %s" % json.dumps(out["profiler_probe"]))
    out["op"] = rnn_op_checks(mx, np, torch)
    out["lm"] = train_rnn_lm(mx, ck, np, torch, card)
    out["bucketing"] = {
        "unrolled": train_bucketing(mx, ck, np, torch, card, False),
        "fused": train_bucketing(mx, ck, np, torch, card, True)}
    return out


# --------------------------------------------------------------- phase data
# (a) examples/train_imagenet.py's record-file path at bench.py one_config's
# size: resnet50_v1 at BS 128, bf16 over f32 masters, SGD lr 0.1 momentum
# 0.9 wd 1e-4, DATA_EPOCHS epochs over DATA_BATCHES batches of seeded
# 256x256x3 uint8 images packed as NPYF records (the card's machine has no
# PIL), each epoch ending in a checkpoint
DATA_BATCH = 128
DATA_BATCHES = 10
DATA_SIDE = 256
DATA_SHAPE = (3, 224, 224)
DATA_EPOCHS = 2
DATA_CLASSES = 1000
DATA_DECODE_WORKERS = 4
DATA_SYNTH_STEPS = 10
# (b) bench.py input_pipeline_config: its MLP, batch, features and steps
PIPE_BATCH, PIPE_FEAT, PIPE_BATCHES, PIPE_STEPS = 64, 256, 8, 96
# (c) examples/rnn_lm.py --optimizer <name> at word_lm's width (LM_*)
OPT_STEPS = 5
OPT_PARAMS = {"sgd": {"momentum": 0.9}, "ccsgd": {"momentum": 0.9},
              "nag": {"momentum": 0.9}, "signum": {"momentum": 0.9},
              "lars": {"momentum": 0.9}, "dcasgd": {"momentum": 0.9},
              "rmsprop": {"centered": True}}
# the CPU parity test's bounds (tests/test_torch_optimizers.py): bitwise,
# but the optimizers that reduce (a norm, a row mean) at rtol 1e-6
OPT_REDUCING = ("lars", "groupadagrad")
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
# (d) the Apache-MXNet round trip: resnet50_v1 logits on this batch
EXPORT_BATCH = 8


def _npyf(np, img):
    """``recordio``'s raw image container: ``b"NPYF"`` + ``numpy.save``."""
    import io as _io
    buf = _io.BytesIO()
    np.save(buf, img)
    return b"NPYF" + buf.getvalue()


def write_records(mx, np, workdir):
    """The seeded indexed record file of phase data(a): DATA_BATCHES x
    DATA_BATCH images of DATA_SIDE^2 x 3 uint8, labels in
    [0, DATA_CLASSES), NPYF payloads."""
    d = os.path.join(workdir, "data")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "train")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    n = DATA_BATCHES * DATA_BATCH
    labels = rng.integers(0, DATA_CLASSES, n)
    w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rng.integers(0, 256, (DATA_SIDE, DATA_SIDE, 3), np.uint8)
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(labels[i]), i, 0), _npyf(np, img)))
    w.close()
    return prefix + ".rec", {"images": n, "seconds":
                             time.perf_counter() - t0,
                             "bytes": os.path.getsize(prefix + ".rec")}


def _clone_params(tr):
    return {n: v.detach().clone() for n, v in tr.params.items()}


def _record_epochs(mx, ck, torch, tt, net, rec, prefetch, workdir,
                   capture=None):
    """DATA_EPOCHS epochs of ``examples/train_imagenet.py``'s loop over
    ``mx.io.ImageRecordIter`` (shuffled with the iterator's own seed),
    bare or through ``DevicePrefetcher``; each epoch ends in
    ``save_checkpoint``.  Counts zeroed just before, read just after.
    With ``capture`` (a dict), the first step of the second epoch's
    batch, loss and resulting weights and momenta go there."""
    tr = _resnet_trainer(mx, net, "bfloat16")
    it = mx.io.ImageRecordIter(path_imgrec=rec, batch_size=DATA_BATCH,
                               data_shape=DATA_SHAPE, shuffle=True,
                               seed=SEED)
    feed = mx.io.DevicePrefetcher(it, placement=tr.batch_sharding) \
        if prefetch else it
    _zero_counts(torch, tt, ck)
    epochs, losses, ckpts = [], [], []
    for epoch in range(DATA_EPOCHS):
        if epoch:
            feed.reset()
        t0 = time.perf_counter()
        n = 0
        for batch in feed:
            loss = tr.step(batch.data[0], batch.label[0])
            losses.append(loss)
            n += 1
            if capture is not None and epoch == 1 and n == 1:
                capture.update(
                    data=batch.data[0]._data.clone(),
                    label=batch.label[0]._data.clone(),
                    loss=loss.clone(), params=_clone_params(tr),
                    momenta={k: v.clone() for k, v in tr.opt_state.items()})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = os.path.join(workdir, "data", "resnet50_v1-%s-%04d.ckpt"
                            % ("prefetch" if prefetch else "bare", epoch))
        tr.save_checkpoint(path)
        ckpts.append(path)
        epochs.append({"batches": n, "train_s": t1 - t0,
                       "checkpoint_s": time.perf_counter() - t1})
        assert n == DATA_BATCHES, (epoch, n)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    snap = tt.snapshot()
    steps = DATA_EPOCHS * DATA_BATCHES
    assert launches == _want_launches(ck, sgd_step=steps), launches
    c = snap["counters"]
    host = snap["timers"].get("io.batch_host_ms", {})
    losses = [float(x) for x in losses]
    train_s = sum(e["train_s"] for e in epochs)
    out = {"mode": "device_prefetch" if prefetch else "bare",
           "decode_workers": mx.config.get("io.decode_workers"),
           "epochs": epochs, "losses": losses,
           "losses_finite": all(map(math.isfinite, losses)),
           "launches": launches, "steps": steps,
           "img_per_s": steps * DATA_BATCH / train_s,
           "iterator_host_ms_per_batch": host.get("total", 0.0)
           / max(host.get("count", 0), 1),
           "iterator_host_ms": host,
           "h2d_async": c.get("io.h2d_async", 0),
           "h2d_sync": c.get("io.h2d_sync", 0),
           "checkpoints": ckpts}
    assert out["losses_finite"], losses
    if prefetch:
        # two arrays a batch staged on the prefetch thread; the trainer
        # never copied a batch itself
        assert out["h2d_async"] == 2 * steps and out["h2d_sync"] == 0, out
    return tr, out


def data_resnet(mx, ck, np, torch, card, workdir, synthetic=None):
    """Phase data(a): ResNet-50 fed from records, bare and through
    ``DevicePrefetcher``, then the resume gate: a fresh trainer loads the
    first epoch's checkpoint and its next step's loss, weights and
    momenta must be bitwise those of the uninterrupted run."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rec, written = write_records(mx, np, workdir)
    _log("[data] records %s" % json.dumps(written))
    # deterministic convolution algorithms: the resume gate is bitwise
    prev = (torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    mx.config.set("io.decode_workers", DATA_DECODE_WORKERS)
    try:
        mx.random.seed(SEED)
        net = vision.get_model("resnet50_v1", classes=DATA_CLASSES)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.zeros((1,) + DATA_SHAPE, ctx=mx.gpu(0)))
        capture = {}
        tr, bare = _record_epochs(mx, ck, torch, tt, net, rec, False,
                                  workdir, capture)
        _log("[data] record-fed, bare %s" % json.dumps(bare))
        data, label = capture["data"], capture["label"]
        out = {"records": written, "card": card, "bare": bare,
               "cudnn": "deterministic, no benchmark"}
        out["k1_routes"] = _sgd_routes(ck, torch, tr, data, label)
        del tr
        torch.cuda.empty_cache()
        trp, pre = _record_epochs(mx, ck, torch, tt, net, rec, True,
                                  workdir)
        out["device_prefetch"] = pre
        pre["losses_equal_bare"] = pre["losses"] == bare["losses"]
        _log("[data] record-fed, device prefetch %s" % json.dumps(pre))
        assert pre["losses_equal_bare"], (pre["losses"], bare["losses"])

        # the same trainer on one fixed device batch: the synthetic rate
        _, synth_ms = _timed(np, torch, trp, data, label, DATA_SYNTH_STEPS)
        out["synthetic_same_settings"] = _rate(np, synth_ms, card)
        out["synthetic_phase5"] = synthetic
        feed = mx.io.DevicePrefetcher(
            mx.io.ImageRecordIter(path_imgrec=rec, batch_size=DATA_BATCH,
                                  data_shape=DATA_SHAPE, shuffle=True,
                                  seed=SEED + 1),
            placement=trp.batch_sharding)

        def window():
            for _ in range(min(3, DATA_BATCHES)):
                b = next(feed)
                trp.step(b.data[0], b.label[0])
        out["profile"] = _profile(torch, window, top=12)
        _log("[data] profiled record-fed window %s"
             % json.dumps(out["profile"]))
        del trp, feed
        torch.cuda.empty_cache()

        # the resume gate
        tr2 = _resnet_trainer(mx, net, "bfloat16")
        tr2.load_checkpoint(bare["checkpoints"][0])
        loss2 = tr2.step(data, label)
        torch.cuda.synchronize()
        diff = {"loss": _differing(torch, loss2, capture["loss"]),
                "weights": sum(_differing(torch, v.detach(),
                                          capture["params"][n])
                               for n, v in tr2.params.items()),
                "momenta": sum(_differing(torch, v, capture["momenta"][n])
                               for n, v in tr2.opt_state.items())}
        out["resume"] = {"checkpoint": bare["checkpoints"][0],
                         "step": int(tr2._step_num),
                         "loss": float(loss2), "differing": diff}
        _log("[data] resume %s" % json.dumps(out["resume"]))
        assert not any(diff.values()), diff
        del tr2, capture
        torch.cuda.empty_cache()
    finally:
        mx.config.unset("io.decode_workers")
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = prev
    return out


def input_pipeline(mx, ck, np, torch, card):
    """Phase data(b): ``bench.py`` ``input_pipeline_config`` with its MLP,
    shapes and steps: the same host-prep iterator into ``SPMDTrainer``
    SGD (K1, one launch a step) through ``PrefetchingIter`` (host
    batches: the trainer copies each itself) and through
    ``DevicePrefetcher`` (staged on its thread); samples/s of each."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import SPMDTrainer
    mio = mx.io
    rng = np.random.RandomState(5)
    X = rng.randn(PIPE_BATCH * PIPE_BATCHES, PIPE_FEAT).astype(np.float32)
    Y = rng.randn(PIPE_BATCH * PIPE_BATCHES).astype(np.float32)

    class HostPrepIter(mio.DataIter):
        def __init__(self):
            super().__init__(PIPE_BATCH)
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self):
            if self.i + PIPE_BATCH > len(X):
                raise StopIteration
            lo = self.i
            self.i += PIPE_BATCH
            d = X[lo:lo + PIPE_BATCH]
            d = (d - d.mean(axis=0)) / (d.std(axis=0) + 1e-6)
            return mio.DataBatch([d.astype(np.float32)],
                                 [Y[lo:lo + PIPE_BATCH]], pad=0)

    def l2(out, label):
        return ((out - label.reshape((-1, 1))) ** 2).mean(axis=1)

    def run(device_prefetch):
        mx.config.set("io.device_prefetch", device_prefetch)
        mx.random.seed(9)
        net = nn.HybridSequential()
        net.add(nn.Dense(256, activation="relu"), nn.Dense(1))
        net.initialize(ctx=mx.gpu(0))
        tr = SPMDTrainer(net, l2, "sgd", {"learning_rate": 0.01})
        if device_prefetch:
            feed = mio.DevicePrefetcher(
                HostPrepIter(), placement=lambda: tr.batch_sharding,
                buckets="full")
        else:
            feed = mio.PrefetchingIter(HostPrepIter())
        loss = None
        for b in feed:                       # warm epoch
            loss = tr.step(b.data[0], b.label[0], pad=b.pad)
        float(loss)
        _zero_counts(torch, tt, ck)
        done = 0
        t0 = time.perf_counter()
        while done < PIPE_STEPS:
            feed.reset()
            for b in feed:
                loss = tr.step(b.data[0], b.label[0], pad=b.pad)
                done += 1
                if done >= PIPE_STEPS:
                    break
        final = float(loss)                  # the sync ends the timing
        dt = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        c = tt.snapshot()["counters"]
        assert launches == _want_launches(ck, sgd_step=PIPE_STEPS), launches
        assert math.isfinite(final), final
        return {"samples_s": PIPE_BATCH * done / dt, "steps": done,
                "launches": launches, "final_loss": final,
                "h2d_sync": c.get("io.h2d_sync", 0),
                "h2d_async": c.get("io.h2d_async", 0)}

    try:
        host = run(False)
        dev = run(True)
    finally:
        mx.config.unset("io.device_prefetch")
    assert host["h2d_sync"] == 2 * PIPE_STEPS, host
    assert dev["h2d_sync"] == 0 and dev["h2d_async"] >= 2 * PIPE_STEPS, dev
    out = {"host_prefetch": host, "device_prefetch": dev,
           "device_over_host": dev["samples_s"] / host["samples_s"],
           "batch": PIPE_BATCH, "steps": PIPE_STEPS, "card": card}
    _log("[data] input_pipeline_config %s" % json.dumps(out))
    return out


def _tree_to(torch, state, device):
    """A copy of an optimizer state tree on ``device``."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.detach().to(device, copy=True)
    return tuple(_tree_to(torch, s, device) for s in state)


def _update_on(torch, opt_blob, name, params, states, device):
    """One update of every trainable parameter by a copy of the
    optimizer, on ``device``, from copies of the same weights, gradients
    and states; the new weights."""
    import pickle
    opt = pickle.loads(opt_blob)
    if name == "sgld":
        opt._noise = torch.zeros_like        # the deterministic part only
    out = []
    for i, p in enumerate(params):
        if p.grad_req == "null":
            continue
        w = p.data()._data.detach().to(device, copy=True)
        g = p.grad()._data.detach().to(device, copy=True)
        opt.update_multi_precision(i, w, g, _tree_to(torch, states[i],
                                                     device))
        out.append(w)
    return out


def optimizers_on_lm(mx, ck, np, torch, card):
    """Phase data(c): ``examples/rnn_lm.py --optimizer <name>`` at
    word_lm's width for OPT_STEPS steps through ``gluon.Trainer`` (with
    ``multi_precision``, so an f32 weight is its own master and SGD,
    ccSGD and Adam take their fused kernels, one launch a parameter a
    step), for every registered optimizer: finite losses, the launches,
    then one more update on the card against the port's CPU update from
    the same weights, gradients and states (bitwise, or OPT_RTOL for the
    optimizers that reduce)."""
    import pickle
    from mxnet_tpu_torch import telemetry as tt
    toks = lm_corpus(np, LM_VOCAB, LM_TOKENS)
    batches = lm_batches(toks, LM_BATCH, LM_BPTT)
    names = sorted(mx.optimizer.Optimizer.opt_registry)
    out = {"steps": OPT_STEPS, "card": card, "runs": {}}
    for name in names:
        mx.random.seed(SEED)
        model = rnn_lm_model(mx.gluon, LM_VOCAB, LM_EMBED, LM_HIDDEN,
                             LM_LAYERS, LM_DROPOUT)
        model.initialize(mx.init.Xavier())
        opt = dict(OPT_PARAMS.get(name, {}), learning_rate=LM_LR,
                   multi_precision=True)
        trainer = mx.gluon.Trainer(model.collect_params(), name, opt)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        states = model.begin_state(LM_BATCH)
        nparams = len(trainer._params)
        _zero_counts(torch, tt, ck)
        losses = []
        for x, y in batches[:OPT_STEPS]:
            xb = mx.nd.array(x.astype(np.float32))
            yb = mx.nd.array(y.astype(np.float32))
            states = [s.detach() for s in states]
            with mx.autograd.record():
                o, states = model(xb, states)
                loss = loss_fn(o.reshape((-1, LM_VOCAB)),
                               yb.reshape((-1,))).mean()
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        kernel = {"sgd": "sgd_step", "ccsgd": "sgd_step",
                  "adam": "adam_step"}.get(name)
        want = _want_launches(ck, **({kernel: OPT_STEPS * nparams}
                                     if kernel else {}))
        assert launches == want, (name, launches, want)
        assert all(map(math.isfinite, losses)), (name, losses)
        # one more update, card against CPU, from the same arrays
        blob = pickle.dumps(trainer._optimizer)
        upd = trainer._updaters[0]
        card_w = _update_on(torch, blob, name, trainer._params, upd.states,
                            "cuda")
        cpu_w = _update_on(torch, blob, name, trainer._params, upd.states,
                           "cpu")
        torch.cuda.synchronize()
        differing = sum(_differing(torch, a.cpu(), b)
                        for a, b in zip(card_w, cpu_w))
        worst = max(float(((a.cpu() - b).abs() / (OPT_ATOL + OPT_RTOL
                                                  * b.abs())).max())
                    for a, b in zip(card_w, cpu_w))
        run = {"losses": losses, "launches": {k: v for k, v in
                                              launches.items() if v},
               "params": nparams, "card_vs_cpu_differing": differing,
               "card_vs_cpu_worst_over_bound": worst,
               "bound": ("rtol %g" % OPT_RTOL if name in OPT_REDUCING
                         else "bitwise")}
        out["runs"][name] = run
        _log("[data] optimizer %s %s" % (name, json.dumps(run)))
        if name in OPT_REDUCING:
            assert worst <= 1.0, (name, run)
        else:
            assert differing == 0, (name, run)
        del model, trainer, card_w, cpu_w
        torch.cuda.empty_cache()
    out["module_ccsgd"] = _module_ccsgd(mx, ck, np, torch)
    return out


def _module_ccsgd(mx, ck, np, torch):
    """ccSGD (SGD's subclass, K1) on the Module MLP through
    ``Module.init_optimizer``: OPT_STEPS fused steps, one K1 launch
    each."""
    from mxnet_tpu_torch import telemetry as tt
    mod = mx.mod.Module(_mlp_symbol(mx))
    mod.bind([("data", (MLP_BATCH, MLP_FEAT))],
             [("softmax_label", (MLP_BATCH,))])
    mx.random.seed(SEED)
    mod.init_params(mx.init.Uniform(0.05))
    mod.init_optimizer(optimizer="ccsgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    batch = _mlp_batch(mx, np)
    _zero_counts(torch, tt, ck)
    outs = _mlp_steps(mx, mod, "auto", batch, OPT_STEPS)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck, sgd_step=OPT_STEPS), launches
    fused = tt.snapshot()["counters"].get("fused_steps", 0)
    assert fused == OPT_STEPS, fused
    out = {"steps": OPT_STEPS, "launches": {"sgd_step": OPT_STEPS},
           "fused_steps": fused,
           "finite": bool(all(torch.isfinite(o).all() for o in outs))}
    assert out["finite"], out
    _log("[data] Module ccSGD %s" % json.dumps(out))
    return out


def mxnet_round_trip(mx, np, torch, workdir):
    """Phase data(d): ``resnet50_v1`` through ``export(fmt="mxnet")``
    (Apache MXNet's NNVM JSON and binary ``.params``), read back by
    ``mx.model.load_checkpoint`` into a ``SymbolBlock``: its logits on
    the card must be bitwise the source network's."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    prev = (torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        mx.random.seed(SEED + 3)
        net = vision.get_model("resnet50_v1", classes=DATA_CLASSES)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        x = mx.nd.array(np.random.RandomState(SEED).uniform(
            size=(EXPORT_BATCH,) + DATA_SHAPE).astype(np.float32),
            ctx=mx.gpu(0))
        want = net(x)._data.clone()
        prefix = os.path.join(workdir, "data", "resnet50_v1-mxnet")
        t0 = time.perf_counter()
        files = net.export(prefix, 0, fmt="mxnet")
        t1 = time.perf_counter()
        sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
        block = mx.gluon.SymbolBlock(sym, mx.sym.Variable("data"))
        params = block.collect_params()
        for n, v in list(arg.items()) + list(aux.items()):
            params[n]._load_init(v, mx.gpu(0))
        got = block(x)._data
        torch.cuda.synchronize()
        out = {"files": {os.path.basename(f): os.path.getsize(f)
                         for f in files},
               "export_s": t1 - t0, "load_s": time.perf_counter() - t1,
               "arg": len(arg), "aux": len(aux),
               "logits_shape": list(got.shape),
               "logits_differing": _differing(torch, got, want)}
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = prev
    _log("[data] Apache-MXNet round trip %s" % json.dumps(out))
    assert out["logits_differing"] == 0, out
    return out


def _data_launches(data):
    """K1's and K3's launches in phase data's counted runs, by path."""
    a, b = data["resnet_records"], data["input_pipeline"]
    c = data["optimizers"]
    sgd = {"data_records_bare": a["bare"]["launches"]["sgd_step"],
           "data_records_prefetch":
               a["device_prefetch"]["launches"]["sgd_step"],
           "data_pipeline_host": b["host_prefetch"]["launches"]["sgd_step"],
           "data_pipeline_device":
               b["device_prefetch"]["launches"]["sgd_step"],
           "data_lm_sgd": c["runs"]["sgd"]["launches"]["sgd_step"],
           "data_lm_ccsgd": c["runs"]["ccsgd"]["launches"]["sgd_step"],
           "data_module_ccsgd": c["module_ccsgd"]["launches"]["sgd_step"]}
    adam = {"data_lm_adam": c["runs"]["adam"]["launches"]["adam_step"]}
    return sgd, adam


def data_phase(mx, ck, np, torch, card, workdir, synthetic=None):
    """Phase data: (a) record-fed ResNet-50 with checkpoints and the
    resume gate, (b) input_pipeline_config, (c) the optimizers on the
    LSTM LM and ccSGD on the Module MLP, (d) the Apache-MXNet round
    trip."""
    out = {"resnet_records": data_resnet(mx, ck, np, torch, card, workdir,
                                         synthetic)}
    out["input_pipeline"] = input_pipeline(mx, ck, np, torch, card)
    out["optimizers"] = optimizers_on_lm(mx, ck, np, torch, card)
    out["mxnet_files"] = mxnet_round_trip(mx, np, torch, workdir)
    return out


# ------------------------------------------------------------- phase ssd
# examples/ssd_train.py at --size 512 (BASELINE.json config 4): ssd_512
# over 20 classes, batch 8, gluon.Trainer SGD at lr 0.05 and momentum
# 0.9, 20 counted steps; then detection on its inference batch of 2
# (65,280 anchors an image, nms_threshold 0.45, threshold 0.01)
SSD_SIZE = 512
SSD_CLASSES = 20
SSD_BATCH = 8
SSD_STEPS = 20
SSD_LR = 0.05
SSD_MOMENTUM = 0.9
#: ssd_512's trainable tensors: stem 2 x 4, stages 4 x 4, class and box
#: heads 4 x 2 each; K1 launches once for each a step
SSD_TENSORS = 40
SSD_DETECT_BATCH = 2
SSD_NMS_THRESHOLD = 0.45
SSD_THRESHOLD = 0.01
#: (b): the records the phase writes, one per image of 20 batches
SSD_REC_IMAGES = SSD_BATCH * SSD_STEPS
#: the card's loss on one step against the CPU's, from the same weights
#: and batch: the convolutions in f32 on cuDNN (TF32 off) and on the CPU
#: sum in other orders, and the 3:1 mining ranks negatives by those
#: slightly different scores, so a negative at the rank boundary may
#: swap with one of nearly the same score
SSD_LOSS_RTOL = 1e-3
#: the IoU of one pair of boxes takes 15 operations of the greedy scan
#: (4 min/max, 2 differences, 2 clips, the intersection, the union's add
#: and subtract, its floor, the quotient, the comparison and the class
#: test; each box's area is one per row, not per pair)
NMS_PAIR_OPS = 15
#: (c): warm ``net.detect`` calls timed after the counted one (median)
DETECT_REPEATS = 5
#: NMS rows of the card's small cases of (c)
NMS_SMALL_ROWS = 500
#: (c) runs every NMS case a second time with segments longer than this
#: many rows taken in chunks (the kernel's pass over big segments)
NMS_CHUNKED_ROWS = 256
#: Faster R-CNN's RPN at its VGG-16 feature map: one 600x800 image, a
#: 38x50 map at stride 16, scales (8, 16, 32) x ratios (0.5, 1, 2)
PROPOSAL_SHAPE = (1, 38, 50)
PROPOSAL_ATTRS = {"scales": (8, 16, 32), "ratios": (0.5, 1, 2),
                  "feature_stride": 16, "rpn_pre_nms_top_n": 6000,
                  "rpn_post_nms_top_n": 300, "threshold": 0.7,
                  "rpn_min_size": 16}

#: the detection ops' bound, max|got - want| / max|want| over each output,
#: both for the port against the reference on the CPU
#: (tests/test_torch_detection_ops.py) and for the card against the CPU
#: (phase ssd(d)); 0 is bitwise.  Exact: the ops whose arithmetic is
#: comparisons, selection and single IEEE operations in the same order
#: (the IoU, the anchors, max pooling, matching, NMS; their divisions by
#: constants are IEEE divisions on the card too, ``contrib.div_exact``).
#: 2^-20: an exp, log, sin or cos on the way (two libraries' f32
#: transcendentals differ in the last bits), or a bilinear tap whose
#: multiply-adds XLA contracts.  2^-18: AdaptiveAvgPooling2D's products
#: sum in another order.  2^-16: RROIAlign samples at positions rotated
#: by a cos and a sin of the map's scale (up to ~50 pixels), where an ulp
#: moves a tap by ~4e-6 of a pixel, and the map's slope carries that into
#: the output (6.7 x 2^-20 measured on the card at 300 ROIs of a 38x50
#: map).  2^-12: PSROIPooling's bin sums are differences of
#: integral-image entries, prefix sums over up to H x W values whose
#: rounding depends on the scan's order (a 38x50 map on the card).
DET_RTOL = {"box_iou": 0.0, "bipartite_matching": 0.0, "box_nms": 0.0,
            "ROIPooling": 0.0, "MultiBoxPrior": 0.0,
            "box_encode": 2.0 ** -20, "box_decode": 2.0 ** -20,
            "MultiBoxTarget": 2.0 ** -20, "MultiBoxDetection": 2.0 ** -20,
            "_contrib_AdaptiveAvgPooling2D": 2.0 ** -18,
            "_contrib_Proposal": 2.0 ** -20,
            "_contrib_PSROIPooling": 2.0 ** -12,
            "_contrib_DeformablePSROIPooling": 2.0 ** -20,
            "_contrib_RROIAlign": 2.0 ** -16}
#: outputs held bitwise whatever the op's bound: MultiBoxTarget's box
#: mask and class targets, MultiBoxDetection's class ids and scores (its
#: columns 0 and 1: the kept set), Proposal's scores, box_encode's mask
DET_EXACT_OUTPUTS = {"MultiBoxTarget": (1, 2), "box_encode": (1,),
                     "_contrib_Proposal": (1,)}
DET_EXACT_COLUMNS = {"MultiBoxDetection": 2}


def synthetic_batch(np, rng, B, size, num_classes, max_boxes=4):
    """``examples/ssd_train.py``'s synthetic batch: images with coloured
    rectangles and labels ``[cls, x1, y1, x2, y2]`` (rows of -1 past each
    image's 1 to ``max_boxes`` objects)."""
    x = rng.uniform(0, 0.3, (B, 3, size, size)).astype(np.float32)
    labels = np.full((B, max_boxes, 5), -1.0, np.float32)
    for b in range(B):
        for k in range(rng.randint(1, max_boxes + 1)):
            cls = rng.randint(0, num_classes)
            cx, cy = rng.uniform(0.2, 0.8, 2)
            w, h = rng.uniform(0.1, 0.3, 2)
            x1, y1 = max(cx - w / 2, 0.0), max(cy - h / 2, 0.0)
            x2, y2 = min(cx + w / 2, 1.0), min(cy + h / 2, 1.0)
            px = slice(int(x1 * size),
                       max(int(x2 * size), int(x1 * size) + 1))
            py = slice(int(y1 * size),
                       max(int(y2 * size), int(y1 * size) + 1))
            x[b, cls % 3, py, px] = 1.0
            labels[b, k] = [cls, x1, y1, x2, y2]
    return x, labels


def _det_boxes(np, rng, n, lo=0.0, hi=0.8, wmin=0.05, wmax=0.4):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(wmin, wmax, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _nms_rows(np, rng, b, n, classes=3, levels=0):
    """``[b, n, 6]`` rows ``[cls, score, x1, y1, x2, y2]``; with
    ``levels`` the scores take that many values, so many tie."""
    score = rng.rand(b, n, 1)
    if levels:
        score = np.floor(score * levels) / levels
    return np.concatenate(
        [rng.randint(0, classes, (b, n, 1)).astype(np.float32),
         score.astype(np.float32),
         np.stack([_det_boxes(np, rng, n) for _ in range(b)])], -1)


def _grid_rows(np, n):
    """``[1, n, 6]`` rows of integer boxes whose IoUs are exact, many
    exactly 0.5 (a 2x1 box against the 1x1 box in its corner), with tied
    scores: the threshold's own value must not suppress."""
    rows = []
    for i in range(n):
        x, y = (i % 7), (i // 7) % 5
        wide = i % 3 == 0
        rows.append([i % 2, float(8 - i % 8) / 8.0, x, y,
                     x + (2 if wide else 1), y + 1])
    return np.asarray(rows, np.float32)[None]


def _ssd_anchors(np, size=SSD_SIZE, scales=4):
    """ssd_512's anchors at ``size`` in numpy (``MultiBoxPrior``'s grid:
    maps of size/4, /8, ..., sizes 0.2 + 0.15 i, ratios 1, 2 and 0.5),
    ``(1, N, 4)``; 65,280 of them at 512."""
    out = []
    for i in range(scales):
        n = size // (4 << i)
        c = (np.arange(n) + 0.5) / n
        s = 0.2 + 0.15 * i
        wh = [(s * np.sqrt(r), s / np.sqrt(r)) for r in (1.0, 2.0, 0.5)]
        cy, cx = np.meshgrid(c, c, indexing="ij")
        for_each = [np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                             -1) for w, h in wh]
        out.append(np.stack(for_each, 2).reshape(-1, 4))
    return np.concatenate(out)[None].astype(np.float32)


def _anchor_labels(np, rng, b, m):
    lab = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        for k in range(rng.randint(1, m + 1)):
            lab[i, k, 0] = rng.randint(0, 20)
            lab[i, k, 1:] = _det_boxes(np, rng, 1, 0.1, 0.6, 0.1, 0.35)[0]
    return lab


def _softmax_rows(np, x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def det_cases(np, realistic=False):
    """The detection ops' cases ``[(label, op, arrays, attrs)]``, numpy
    only, seeded: every op of ``ops/contrib.py``'s and
    ``ops/contrib_extra.py``'s detection parts at the reference tests'
    small shapes, or (``realistic``) at the shapes SSD-512 and Faster
    R-CNN give them."""
    rng = np.random.RandomState(SEED)
    if realistic:
        anc = _ssd_anchors(np)
        N = anc.shape[1]
        lab = _anchor_labels(np, rng, SSD_BATCH, 4)
        # detection-like NMS rows: SSD's anchors moved a little, so most
        # of a class's boxes overlap a kept one, as in net.detect
        near = anc[0] + rng.randn(SSD_DETECT_BATCH, N, 4).astype(
            np.float32) * 0.01
        nms_rows = np.concatenate(
            [rng.randint(0, SSD_CLASSES + 1, (SSD_DETECT_BATCH, N, 1)),
             rng.rand(SSD_DETECT_BATCH, N, 1), near], -1).astype(np.float32)
        cls = (rng.randn(SSD_BATCH, SSD_CLASSES + 1, N) * 2).astype(
            np.float32)
        fmap = rng.randn(1, 512, 38, 50).astype(np.float32)
        rois = np.concatenate([np.zeros((300, 1), np.float32),
                               _det_boxes(np, rng, 300, 0, 500, 16, 300)],
                              1)
        A = 9
        return [
            ("iou_anchors_gt", "box_iou", [anc[0], lab[0, :, 1:]], {}),
            ("match_anchors", "bipartite_matching",
             [rng.rand(SSD_BATCH, N, 4).astype(np.float32)],
             {"threshold": 1e-12}),
            ("nms_detection_rows", "box_nms", [nms_rows],
             {"overlap_thresh": SSD_NMS_THRESHOLD, "id_index": 0}),
            ("roi_pool_300", "ROIPooling", [fmap, rois],
             {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}),
            ("prior_stage0", "MultiBoxPrior",
             [np.zeros((SSD_BATCH, 64, 128, 128), np.float32)],
             {"sizes": (0.2,), "ratios": (1.0, 2.0, 0.5)}),
            ("encode_anchors", "box_encode",
             [(rng.rand(SSD_BATCH, N) > 0.9).astype(np.float32),
              rng.randint(0, 4, (SSD_BATCH, N)).astype(np.float32),
              np.broadcast_to(anc, (SSD_BATCH, N, 4)).copy(),
              lab[:, :, 1:]], {}),
            ("decode_anchors", "box_decode",
             [(rng.randn(SSD_BATCH, N, 4) * 0.5).astype(np.float32), anc],
             {}),
            ("target_ssd512", "MultiBoxTarget", [anc, lab, cls],
             {"negative_mining_ratio": 3.0,
              "negative_mining_thresh": 0.5}),
            ("detect_ssd512", "MultiBoxDetection",
             [_softmax_rows(np, cls[:SSD_DETECT_BATCH], 1),
              (rng.randn(SSD_DETECT_BATCH, N * 4) * 0.3).astype(
                  np.float32), anc],
             {"nms_threshold": SSD_NMS_THRESHOLD,
              "threshold": SSD_THRESHOLD}),
            ("adaptive_pool", "_contrib_AdaptiveAvgPooling2D",
             [np.concatenate([fmap] * SSD_BATCH)], {"output_size": (7, 7)}),
            ("proposal_frcnn", "_contrib_Proposal",
             [rng.rand(1, 2 * A, 38, 50).astype(np.float32),
              (rng.randn(1, 4 * A, 38, 50) * 0.2).astype(np.float32),
              np.array([[600, 800, 1.0]], np.float32)], PROPOSAL_ATTRS),
            ("psroi_300", "_contrib_PSROIPooling", [fmap, rois],
             {"spatial_scale": 1.0 / 16, "output_dim": 32,
              "pooled_size": 4}),
            ("deformable_psroi_300", "_contrib_DeformablePSROIPooling",
             [fmap, rois, rng.randn(300, 2, 4, 4).astype(np.float32)],
             {"spatial_scale": 1.0 / 16, "output_dim": 32,
              "pooled_size": 4, "sample_per_part": 4, "trans_std": 0.1}),
            ("rroi_align_300", "_contrib_RROIAlign",
             [fmap, np.concatenate(
                 [np.zeros((300, 1)), rng.uniform(0, 600, (300, 2)),
                  rng.uniform(16, 200, (300, 2)),
                  rng.uniform(-90, 90, (300, 1))], 1).astype(np.float32)],
             {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}),
        ]
    data = rng.randn(2, 4, 12, 10).astype(np.float32)
    rois = np.array([[0, 1, 1, 8, 9], [1, 0, 0, 9, 11],
                     [0, 3.3, 2.2, 5.5, 4.4], [1, -2, -3, 20, 20]],
                    np.float32)
    n = 240
    anc = _det_boxes(np, rng, n)[None]
    lab = np.full((2, 3, 5), -1.0, np.float32)
    lab[0, 0] = [0, .1, .1, .5, .5]
    lab[0, 1] = [1, .3, .4, .9, .8]
    lab[1, 0] = [2, .5, .5, .7, .9]
    cls = rng.randn(2, 4, n).astype(np.float32)
    A, H, W = 9, 6, 7
    feat = rng.randn(2, 2 * 9, 10, 12).astype(np.float32)
    prois = np.array([[0, 10, 12, 60, 70], [1, 0, 0, 90, 70],
                      [0, 33.3, 22.2, 55.5, 44.4]], np.float32)
    rrois = np.array([[0, 5, 5, 4, 3, 30], [1, 6, 4, 8, 2, -45],
                      [0, 2, 3, 1, 1, 0]], np.float32)
    rows = _nms_rows(np, rng, 2, 50)
    ties = _nms_rows(np, rng, 2, 60, levels=4)
    ties[:, 10:20, 2:] = ties[:, 0:10, 2:]          # identical boxes too
    return [
        ("corner", "box_iou", [_det_boxes(np, rng, 5),
                               _det_boxes(np, rng, 7)], {}),
        ("center", "box_iou", [_det_boxes(np, rng, 5),
                               _det_boxes(np, rng, 7)],
         {"format": "center"}),
        ("descend", "bipartite_matching",
         [rng.rand(3, 6, 5).astype(np.float32)], {"threshold": 0.3}),
        ("ascend", "bipartite_matching",
         [rng.rand(3, 6, 5).astype(np.float32)],
         {"threshold": 0.3, "is_ascend": True}),
        ("topk", "bipartite_matching",
         [rng.rand(3, 6, 5).astype(np.float32)],
         {"threshold": 0.1, "topk": 2}),
        ("any_class", "box_nms", [rows], {"overlap_thresh": 0.3}),
        ("class_topk", "box_nms", [rows],
         {"overlap_thresh": 0.3, "id_index": 0, "valid_thresh": 0.2,
          "topk": 20}),
        ("force", "box_nms", [rows],
         {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True}),
        ("ties_class", "box_nms", [ties],
         {"overlap_thresh": 0.5, "id_index": 0, "valid_thresh": 0.25}),
        ("exact_half", "box_nms", [_grid_rows(np, 70)],
         {"overlap_thresh": 0.5, "id_index": 0}),
        ("exact_half_any", "box_nms", [_grid_rows(np, 70)],
         {"overlap_thresh": 0.499, "topk": 40}),
        ("bins_3x3", "ROIPooling", [data, rois],
         {"pooled_size": (3, 3), "spatial_scale": 1.0}),
        ("bins_2x4", "ROIPooling", [data, rois],
         {"pooled_size": (2, 4), "spatial_scale": 0.5}),
        ("two_sizes", "MultiBoxPrior", [data],
         {"sizes": (0.2, 0.35), "ratios": (1.0, 2.0, 0.5)}),
        ("clip_steps", "MultiBoxPrior", [data],
         {"sizes": (0.3,), "ratios": (1.0, 3.0), "clip": True,
          "steps": (0.1, 0.12), "offsets": (0.4, 0.6)}),
        ("encode", "box_encode",
         [(rng.rand(1, 20) > 0.5).astype(np.float32),
          rng.randint(0, 3, (1, 20)).astype(np.float32),
          _det_boxes(np, rng, 20)[None], _det_boxes(np, rng, 3)[None]], {}),
        ("decode", "box_decode",
         [(rng.randn(1, 20, 4) * 0.5).astype(np.float32),
          _det_boxes(np, rng, 20)[None]], {}),
        ("decode_center_clip", "box_decode",
         [(rng.randn(1, 20, 4) * 0.5).astype(np.float32),
          _det_boxes(np, rng, 20)[None]], {"clip": 0.3, "format": "center"}),
        ("no_mining", "MultiBoxTarget", [anc, lab, cls], {}),
        ("mining", "MultiBoxTarget", [anc, lab, cls],
         {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5}),
        ("per_class", "MultiBoxDetection",
         [_softmax_rows(np, cls, 1),
          (rng.randn(2, n * 4) * 0.3).astype(np.float32), anc],
         {"nms_threshold": 0.45}),
        ("force_topk", "MultiBoxDetection",
         [_softmax_rows(np, cls, 1),
          (rng.randn(2, n * 4) * 0.3).astype(np.float32), anc],
         {"nms_threshold": 0.45, "force_suppress": True, "nms_topk": 50,
          "threshold": 0.3}),
        ("adaptive", "_contrib_AdaptiveAvgPooling2D", [data],
         {"output_size": (3, 4)}),
        ("proposal", "_contrib_Proposal",
         [rng.rand(1, 2 * A, H, W).astype(np.float32),
          (rng.randn(1, 4 * A, H, W) * 0.2).astype(np.float32),
          np.array([[H * 16, W * 16, 1.0]], np.float32)],
         {"scales": (8, 16, 32), "ratios": (0.5, 1, 2),
          "rpn_pre_nms_top_n": 200, "rpn_post_nms_top_n": 30,
          "threshold": 0.7, "rpn_min_size": 4}),
        ("psroi", "_contrib_PSROIPooling", [feat, prois],
         {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3}),
        ("deformable", "_contrib_DeformablePSROIPooling",
         [feat[:, :8], prois, rng.randn(3, 2, 2, 2).astype(np.float32)],
         {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 2,
          "sample_per_part": 2, "trans_std": 0.1}),
        ("deformable_no_trans", "_contrib_DeformablePSROIPooling",
         [feat[:, :8], prois], {"spatial_scale": 0.125, "output_dim": 2,
                                "pooled_size": 2, "sample_per_part": 2,
                                "no_trans": True}),
        ("rotated", "_contrib_RROIAlign", [feat, rrois],
         {"pooled_size": (2, 3), "spatial_scale": 1.0}),
    ]


def det_compare(np, op, got, want):
    """``(ratio, differing)`` of the outputs ``got`` against ``want``
    (lists of numpy arrays): ``ratio`` is the worst max|got - want| /
    (DET_RTOL[op] x max|want|) over the outputs held to a bound (<= 1
    passes), ``differing`` the elements that differ among those held
    bitwise (0 passes)."""
    rtol = DET_RTOL[op]
    exact_outs = DET_EXACT_OUTPUTS.get(op, ())
    ratio, differing = 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (op, i, g.shape, w.shape)
        cols = DET_EXACT_COLUMNS.get(op, 0)
        if cols:
            differing += int((g[..., :cols] != w[..., :cols]).sum())
            g, w = g[..., cols:], w[..., cols:]
        if rtol == 0.0 or i in exact_outs:
            differing += int((g != w).sum())
            continue
        err = float(np.abs(g.astype(np.float64) - w).max(initial=0.0))
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
        ratio = max(ratio, err / (rtol * scale))
    return ratio, differing


def run_det_op(mx, op, arrays, attrs, ctx):
    """One op of ``det_cases`` through ``mx.nd`` on ``ctx``; its outputs
    as numpy arrays."""
    from mxnet_tpu_torch.ops.registry import apply_op, get
    with ctx:
        outs = apply_op(get(op), *[mx.nd.array(a) for a in arrays],
                        **attrs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [o.asnumpy() for o in outs]


def _nms_capture(mx, fn):
    """``fn()`` with every ``kernels.box_nms`` call's arguments recorded:
    ``(fn's result, [(coords, cls, valid, thresh)])``."""
    real = mx.kernels.box_nms
    seen = []

    def spy(coords, cls, valid, thresh):
        seen.append((coords.clone(), None if cls is None else cls.clone(),
                     valid.clone(), thresh))
        return real(coords, cls, valid, thresh)

    mx.kernels.box_nms = spy
    try:
        out = fn()
    finally:
        mx.kernels.box_nms = real
    return out, seen


def _nms_pairs(torch, cls, valid, keep):
    """The IoUs of the greedy scan: ``(needed, least)``.  ``needed``, the
    scan as the reference writes it: for each kept row, the later valid
    rows (of its class, when ``cls`` is given).  ``least``, what any scan
    must compute: each kept row against the kept rows before it, and one
    IoU for each row it suppresses, per image (and class)."""
    def later(mask):
        m = mask.to(torch.int64)
        return m.flip(-1).cumsum(-1).flip(-1) - m

    def least(mask):
        k = (keep & mask).sum(-1).to(torch.int64)
        v = (valid & mask).sum(-1).to(torch.int64)
        return int((k * (k - 1) // 2 + v - k).sum())

    if cls is None:
        return int((later(valid) * keep).sum()), least(valid)
    needed = fewest = 0
    for c in torch.unique(cls[valid]).tolist():
        same = cls == c
        needed += int((later(valid & same) * (keep & same)).sum())
        fewest += least(same)
    return needed, fewest


def _nms_check(ck, torch, label, args, timed=False):
    """The NMS kernel against its plain version on the card from the same
    sorted rows (bitwise keep masks), also with segments chunked at
    NMS_CHUNKED_ROWS rows (the big-segment pass on every case), with kept
    counts and, when ``timed``, the kernel's times (events and device
    time of the call, of its segment sort and of the kernel alone), the
    IoUs it computed beside the ones the scan needs, its peak scratch, a
    call under ``set_sync_debug_mode("error")`` (no host sync), the
    plain version's time, and the bound."""
    coords, cls, valid, thresh = args
    keep = ck.box_nms_sorted(coords, cls, valid, thresh)
    c = coords.contiguous()
    keys, perm = ck.nms_sort(cls, valid, thresh) or (None, None)
    chunked = torch.empty_like(keep)
    ck._launch_nms(c, cls, valid, keys, perm, chunked, thresh,
                   block_rows=NMS_CHUNKED_ROWS)
    plain = ck.box_nms_sorted_plain(coords, cls, valid, thresh)
    torch.cuda.synchronize()
    b, n = valid.shape
    out = {"label": label, "shape": {"B": b, "N": n},
           "class_aware": cls is not None, "threshold": thresh,
           "valid_rows": valid.sum(dim=1).tolist(),
           "kept": keep.sum(dim=1).tolist(),
           "kept_plain": plain.sum(dim=1).tolist(),
           "differing": int((keep != plain).sum()),
           "differing_chunked": int((chunked != plain).sum())}
    out["ok"] = out["differing"] == 0 and out["differing_chunked"] == 0
    out["max_abs_err"] = float(out["differing"] + out["differing_chunked"]
                               > 0)
    if not timed:
        return out
    pairs, least = _nms_pairs(torch, cls, valid, keep)
    nbytes = b * n * (16 + (4 if cls is not None else 0) + 1 + 1)
    bound, by = _bound_ms(nbytes, least * NMS_PAIR_OPS, PEAK_F32_FLOPS)
    keep2 = torch.empty_like(keep)
    computed = torch.zeros(1, dtype=torch.int64, device=coords.device)
    ck._launch_nms(c, cls, valid, keys, perm, keep2, thresh, pairs=computed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ck.box_nms_sorted(coords, cls, valid, thresh)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.box_nms_sorted(coords, cls, valid, thresh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    def call():
        ck.box_nms_sorted(coords, cls, valid, thresh)

    def sort():
        ck.nms_sort(cls, valid, thresh)

    def kernel():
        ck._launch_nms(c, cls, valid, keys, perm, keep2, thresh)

    out.update({
        "ms": _time_ms(call, iters=10),
        "device_ms": _device_ms(torch, call, iters=5),
        "sort_ms": _time_ms(sort, iters=10),
        "sort_device_ms": _device_ms(torch, sort, iters=5),
        "kernel_ms": _time_ms(kernel, iters=10),
        "kernel_device_ms": _device_ms(torch, kernel, iters=5),
        "pairs_needed": pairs, "pairs_least": least,
        "pairs_computed": int(computed.item()),
        "scratch_bytes": scratch, "no_host_sync": True,
        "kernel_keep_differing": int((keep2 != plain).sum()),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "library": "none: no one PyTorch call computes greedy NMS "
                   "(torchvision is not on the machine)"})
    out["ok"] = out["ok"] and out["kernel_keep_differing"] == 0
    t0 = time.perf_counter()
    ck.box_nms_sorted_plain(coords, cls, valid, thresh)
    torch.cuda.synchronize()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    out["bound_share"] = bound / out["ms"]
    return out


def _ssd_step(mx, net, trainer, loss_fn, x, labels):
    """One step of ``examples/ssd_train.py``'s loop; the loss (host
    float)."""
    with mx.autograd.record():
        anchors, cls_preds, box_preds = net(x)
        with mx.autograd.pause():
            bt, bm, ct = net.targets(anchors, cls_preds, labels)
        loss = loss_fn(cls_preds, box_preds, ct, bt, bm)
    loss.backward()
    trainer.step(1)
    return float(loss.asnumpy())


def _ssd_net(mx, ctx):
    from mxnet_tpu_torch.models.ssd import ssd_512
    with ctx:
        net = ssd_512(num_classes=SSD_CLASSES)
        net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _ssd_trainer(mx, net):
    # multi_precision: each f32 weight is its own master, so the Trainer's
    # SGD takes K1, one launch a tensor a step (phase data(c)'s route)
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": SSD_LR,
                             "momentum": SSD_MOMENTUM,
                             "multi_precision": True})


def _ssd_cpu_gates(mx, np, torch, net, x, labels):
    """Phase ssd(a)'s one-step gates, before that step's update: the
    card's targets against the CPU's from the same (copied) ``cls_preds``
    and labels, and the card's loss against the CPU's from the same
    weights and batch."""
    from mxnet_tpu_torch.models.ssd import MultiBoxLoss
    cpu = mx.cpu()
    loss_fn = MultiBoxLoss()
    with mx.autograd.record():
        anchors, cls_preds, box_preds = net(x)
        with mx.autograd.pause():
            bt, bm, ct = net.targets(anchors, cls_preds, labels)
        loss = float(loss_fn(cls_preds, box_preds, ct, bt, bm).asnumpy())
    with cpu:
        tc = net.targets(anchors.copyto(cpu), cls_preds.copyto(cpu),
                         labels.copyto(cpu))
    ratio, differing = det_compare(
        np, "MultiBoxTarget", [t.asnumpy() for t in (bt, bm, ct)],
        [t.asnumpy() for t in tc])
    net_cpu = _ssd_net(mx, cpu)
    with cpu:
        xc = x.copyto(cpu)
        net_cpu(xc)                      # shapes the deferred parameters
        for pc, pg in zip(net_cpu.collect_params().values(),
                          net.collect_params().values()):
            pc.set_data(pg.data().copyto(cpu))
        with mx.autograd.record():
            a, c, b = net_cpu(xc)
            with mx.autograd.pause():
                tgt = net_cpu.targets(a, c, labels.copyto(cpu))
            loss_cpu = float(loss_fn(c, b, tgt[2], tgt[0],
                                     tgt[1]).asnumpy())
    out = {"targets": {"box_target_over_bound": ratio,
                       "differing_mask_and_classes": differing,
                       "positives": int((ct.asnumpy() > 0).sum()),
                       "negatives": int((ct.asnumpy() == 0).sum())},
           "loss": loss, "loss_cpu": loss_cpu,
           "loss_rel_err": abs(loss - loss_cpu) / abs(loss_cpu),
           "loss_rtol": SSD_LOSS_RTOL}
    assert differing == 0 and ratio <= 1.0, out
    assert out["loss_rel_err"] <= SSD_LOSS_RTOL, out
    return out


def ssd_train_synthetic(mx, ck, np, torch, card):
    """Phase ssd(a): ``examples/ssd_train.py --size 512`` on its
    synthetic batches (``RandomState(0)``): the one-step gates against
    the CPU, then SSD_STEPS counted steps (K1 exactly SSD_TENSORS times a
    step and nothing else), finite losses, K1 bitwise with its plain
    version on the last step's gradients, the step time, a profiled
    window and MultiBoxTarget's device time."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.ssd import MultiBoxLoss
    mx.random.seed(SEED)
    net = _ssd_net(mx, mx.gpu())
    loss_fn = MultiBoxLoss()
    trainer = _ssd_trainer(mx, net)
    rng = np.random.RandomState(0)

    def batch():
        x, lab = synthetic_batch(np, rng, SSD_BATCH, SSD_SIZE, SSD_CLASSES)
        return mx.nd.array(x), mx.nd.array(lab)

    x, labels = batch()
    net(x)                                   # shapes the deferred params
    gates = _ssd_cpu_gates(mx, np, torch, net, x, labels)
    _ssd_step(mx, net, trainer, loss_fn, x, labels)
    ntensors = len([p for p in trainer._params if p.grad_req != "null"])
    assert ntensors == SSD_TENSORS, ntensors
    batches = [batch() for _ in range(SSD_STEPS)]
    torch.cuda.synchronize()
    _zero_counts(torch, tt, ck)
    losses, step_ms = [], []
    for x, labels in batches:
        t0 = time.perf_counter()
        losses.append(_ssd_step(mx, net, trainer, loss_fn, x, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(
        ck, sgd_step=SSD_TENSORS * SSD_STEPS), launches
    assert all(map(math.isfinite, losses)), losses
    import pickle
    blob = pickle.dumps(trainer._optimizer)
    upd = trainer._updaters[0]
    card_w = _update_on(torch, blob, "sgd", trainer._params, upd.states,
                        "cuda")
    cpu_w = _update_on(torch, blob, "sgd", trainer._params, upd.states,
                       "cpu")
    torch.cuda.synchronize()
    k1_differing = sum(_differing(torch, a.cpu(), b)
                       for a, b in zip(card_w, cpu_w))
    assert k1_differing == 0, k1_differing
    med = float(np.median(step_ms))
    x, labels = batches[-1]
    anchors, cls_preds, _ = net(x)
    torch.cuda.synchronize()
    out = {"config": {"net": "ssd_512", "classes": SSD_CLASSES,
                      "size": SSD_SIZE, "batch": SSD_BATCH,
                      "optimizer": "sgd", "lr": SSD_LR,
                      "momentum": SSD_MOMENTUM, "multi_precision": True,
                      "anchors": int(anchors.shape[1])},
           "card": card, "gates": gates, "steps": SSD_STEPS,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "img_per_s": SSD_BATCH / (med / 1e3), "launches": launches,
           "k1_tensors": ntensors,
           "k1_vs_plain_differing": k1_differing,
           "multibox_target_device_ms": _device_ms(
               torch, lambda: net.targets(anchors, cls_preds, labels)),
           "multibox_target_event_ms": _time_ms(
               lambda: net.targets(anchors, cls_preds, labels), iters=10)}
    feed = iter(batches[:3])
    out["profile"] = _profile(torch, lambda: [
        _ssd_step(mx, net, trainer, loss_fn, *next(feed)) for _ in range(3)],
        top=12)
    _log("[ssd-train] %s" % json.dumps(
        {k: v for k, v in out.items() if k != "step_ms"}))
    return out, net, rng


def write_det_records(mx, np, workdir):
    """Phase ssd(b)'s indexed detection record file: SSD_REC_IMAGES
    synthetic images as 512x512x3 uint8 NPYF payloads, each labelled
    ``[2, 5, objects...]`` (im2rec's detection layout) with its valid
    objects.  Returns the path, the rows written per image and a
    summary."""
    d = os.path.join(workdir, "ssd")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "train")
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rows = []
    for start in range(0, SSD_REC_IMAGES, SSD_BATCH):
        x, lab = synthetic_batch(np, rng, SSD_BATCH, SSD_SIZE, SSD_CLASSES)
        for b in range(SSD_BATCH):
            img = (x[b].transpose(1, 2, 0) * 255).astype(np.uint8)
            objs = lab[b][lab[b, :, 0] >= 0]
            rows.append(objs)
            flat = np.concatenate([[2.0, 5.0], objs.ravel()]).astype(
                np.float32)
            w.write_idx(start + b, mx.recordio.pack(
                mx.recordio.IRHeader(0, flat, start + b, 0),
                _npyf(np, img)))
    w.close()
    return prefix + ".rec", rows, {
        "images": SSD_REC_IMAGES, "seconds": time.perf_counter() - t0,
        "bytes": os.path.getsize(prefix + ".rec")}


def ssd_train_records(mx, ck, np, torch, card, workdir):
    """Phase ssd(b): ``examples/ssd_train.py --data-rec`` over the records
    :func:`write_det_records` wrote, through
    ``mx.io.ImageDetRecordIter``: every batch's labels equal to the rows
    written, padded with -1; SSD_STEPS counted steps (K1 exactly
    SSD_TENSORS a step) with finite losses; img/s and the iterator's host
    ms a batch."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.ssd import MultiBoxLoss
    path, rows, rec = write_det_records(mx, np, workdir)
    it = mx.io.ImageDetRecordIter(path_imgrec=path, batch_size=SSD_BATCH,
                                  data_shape=(3, SSD_SIZE, SSD_SIZE))
    width = max(len(r) for r in rows)
    assert it.provide_label[0].shape == (SSD_BATCH, width, 5), \
        it.provide_label
    mx.random.seed(SEED)
    net = _ssd_net(mx, mx.gpu())
    loss_fn = MultiBoxLoss()
    trainer = _ssd_trainer(mx, net)
    first = it.next()
    net(first.data[0])                       # shapes the deferred params
    it.reset()
    torch.cuda.synchronize()
    _zero_counts(torch, tt, ck)
    losses, iter_ms, step_ms, mismatched = [], [], [], 0
    t_all = time.perf_counter()
    for i in range(SSD_STEPS):
        t0 = time.perf_counter()
        b = it.next()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        want = np.full((SSD_BATCH, width, 5), -1.0, np.float32)
        for s in range(SSD_BATCH):
            r = rows[i * SSD_BATCH + s]
            want[s, :len(r)] = r
        mismatched += int((b.label[0].asnumpy() != want).sum())
        t1 = time.perf_counter()
        losses.append(_ssd_step(mx, net, trainer, loss_fn, b.data[0],
                                b.label[0]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    total_s = time.perf_counter() - t_all
    launches = dict(ck.LAUNCHES)
    assert mismatched == 0, mismatched
    assert launches == _want_launches(
        ck, sgd_step=SSD_TENSORS * SSD_STEPS), launches
    assert all(map(math.isfinite, losses)), losses
    out = {"records": rec, "label_width": width, "steps": SSD_STEPS,
           "losses": losses, "launches": launches,
           "label_mismatches": mismatched,
           "iter_host_ms": iter_ms,
           "median_iter_host_ms": float(np.median(iter_ms)),
           "median_step_ms": float(np.median(step_ms)),
           "img_per_s": SSD_BATCH * SSD_STEPS / total_s, "card": card}
    _log("[ssd-records] %s" % json.dumps(
        {k: v for k, v in out.items() if k != "iter_host_ms"}))
    return out


def _nms_small_cases(mx, np):
    """Phase ssd(c)'s small NMS cases through ``mx.nd.contrib.box_nms``
    on the card: ties, invalid rows, topk, force_suppress, suppression
    across classes (id_index -1), IoUs exactly at the threshold, and
    class ids -0.0 and NaN."""
    rng = np.random.RandomState(SEED + 1)
    n = NMS_SMALL_ROWS
    ties = _nms_rows(np, rng, 2, n, classes=4, levels=8)
    ties[:, n // 5:2 * (n // 5), 2:] = ties[:, :n // 5, 2:]
    rows = _nms_rows(np, rng, 3, NMS_SMALL_ROWS, classes=4)
    grid = _grid_rows(np, NMS_SMALL_ROWS)
    # class ids -0.0 beside 0.0 (one class) and NaN (a class of one row)
    odd = rows.copy()
    odd[:, ::5, 0] = -0.0
    odd[:, 3::11, 0] = np.nan
    return [("ties_class", ties, {"overlap_thresh": 0.5, "id_index": 0,
                                  "valid_thresh": 0.3}),
            ("topk", rows, {"overlap_thresh": 0.4, "id_index": 0,
                            "topk": 120}),
            ("force", rows, {"overlap_thresh": 0.4, "id_index": 0,
                             "force_suppress": True}),
            ("any_class", rows, {"overlap_thresh": 0.3}),
            ("exact_half", grid, {"overlap_thresh": 0.5, "id_index": 0}),
            ("exact_half_topk", grid, {"overlap_thresh": 0.5,
                                       "topk": 64}),
            ("signed_zero_nan_class", odd, {"overlap_thresh": 0.4,
                                            "id_index": 0})]


def ssd_detect(mx, ck, np, torch, card, net, rng):
    """Phase ssd(c): ``net.detect`` on ``examples/ssd_train.py``'s
    inference batch of 2 (65,280 anchors, 21 classes), the NMS kernel
    bitwise with its plain version from the same sorted rows there, in
    the small cases, and in ``Proposal`` at Faster R-CNN's shape (6000
    rows); the kernel's times beside its bound and the plain version's;
    and each op's output on the card against the CPU's."""
    from mxnet_tpu_torch import telemetry as tt
    x, _ = synthetic_batch(np, rng, SSD_DETECT_BATCH, SSD_SIZE, SSD_CLASSES)
    anchors, cls_preds, box_preds = net(mx.nd.array(x))
    _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    det, seen = _nms_capture(mx, lambda: net.detect(
        anchors, cls_preds, box_preds, nms_threshold=SSD_NMS_THRESHOLD,
        threshold=SSD_THRESHOLD))
    torch.cuda.synchronize()
    detect_ms = (time.perf_counter() - t0) * 1e3
    launches = {"detect": dict(ck.LAUNCHES)}
    assert launches["detect"] == _want_launches(ck, box_nms=1), launches
    assert len(seen) == 1, len(seen)
    host = det.asnumpy()
    assert np.isfinite(host).all() and host.shape == (
        SSD_DETECT_BATCH, anchors.shape[1], 6), host.shape
    cases = [_nms_check(ck, torch, "detect_ssd512", seen[0], timed=True)]
    cases[0]["detections_kept"] = (host[..., 0] >= 0).sum(axis=1).tolist()
    cases[0]["detect_first_call_ms"] = detect_ms
    warm = []
    for _ in range(DETECT_REPEATS):
        t0 = time.perf_counter()
        net.detect(anchors, cls_preds, box_preds,
                   nms_threshold=SSD_NMS_THRESHOLD, threshold=SSD_THRESHOLD)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    cases[0]["detect_call_ms"] = float(np.median(warm))
    cases[0]["detect_call_ms_each"] = warm
    # the dense end: every anchor valid (an untrained net's softmax gives
    # each one a foreground score >= 1/21 > the threshold), SSD's anchors
    # moved a little, random classes
    label, op, arrays, attrs = next(c for c in det_cases(np, True)
                                    if c[0] == "nms_detection_rows")
    _, dense = _nms_capture(mx, lambda: run_det_op(mx, op, arrays, attrs,
                                                   mx.gpu()))
    cases.append(_nms_check(ck, torch, "dense_" + label, dense[0],
                            timed=True))
    # the same rows class-agnostic (id_index -1, as force_suppress): one
    # segment of 65,280 rows an image, past a block's shared memory
    _, dense = _nms_capture(mx, lambda: run_det_op(
        mx, op, arrays, dict(attrs, id_index=-1), mx.gpu()))
    cases.append(_nms_check(ck, torch, "dense_any_class_" + label, dense[0],
                            timed=True))
    for label, rows, attrs in _nms_small_cases(mx, np):
        out, got = _nms_capture(mx, lambda: mx.nd.contrib.box_nms(
            mx.nd.array(rows), **attrs))
        cpu = run_det_op(mx, "box_nms", [rows], attrs, mx.cpu())[0]
        case = _nms_check(ck, torch, label, got[0])
        got_op = out.asnumpy()
        case["op_card_vs_cpu_differing"] = int(
            ((got_op != cpu) & ~(np.isnan(got_op) & np.isnan(cpu))).sum())
        case["ok"] = case["ok"] and case["op_card_vs_cpu_differing"] == 0
        cases.append(case)
    prng = np.random.RandomState(SEED + 2)
    b, h, w = PROPOSAL_SHAPE
    a = len(PROPOSAL_ATTRS["scales"]) * len(PROPOSAL_ATTRS["ratios"])
    prop_in = [prng.rand(b, 2 * a, h, w).astype(np.float32),
               (prng.randn(b, 4 * a, h, w) * 0.2).astype(np.float32),
               np.array([[h * 16, w * 16, 1.0]], np.float32)]
    prop_in = [mx.nd.array(v) for v in prop_in]
    _zero_counts(torch, tt, ck)
    _, got = _nms_capture(mx, lambda: mx.nd.contrib.Proposal(
        *prop_in, **PROPOSAL_ATTRS))
    torch.cuda.synchronize()
    launches["proposal"] = dict(ck.LAUNCHES)
    assert launches["proposal"] == _want_launches(ck, box_nms=1), launches
    cases.append(_nms_check(ck, torch, "proposal_frcnn", got[0],
                            timed=True))
    bad = [c for c in cases if not c["ok"]]
    for c in cases:
        _log("[ssd-nms] %s" % json.dumps(c))
    if bad:
        raise AssertionError("NMS kernel disagrees with its plain "
                             "version: %s" % json.dumps(bad))
    return {"card": card, "cases": cases,
            "launches": {k: v["box_nms"] for k, v in launches.items()}}


def ssd_ops(mx, np, torch):
    """Phase ssd(d): every detection op of ``det_cases`` at its small and
    its realistic shape, card against CPU, each within DET_RTOL (its
    bitwise outputs bitwise)."""
    out = []
    for realistic in (False, True):
        for label, op, arrays, attrs in det_cases(np, realistic):
            t0 = time.perf_counter()
            got = run_det_op(mx, op, arrays, attrs, mx.gpu())
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = run_det_op(mx, op, arrays, attrs, mx.cpu())
            ratio, differing = det_compare(np, op, got, want)
            case = {"op": op, "label": label, "realistic": realistic,
                    "shapes": [list(a.shape) for a in arrays],
                    "over_bound": ratio, "differing": differing,
                    "rtol": DET_RTOL[op], "card_s": card_s,
                    "cpu_s": time.perf_counter() - t0,
                    "ok": ratio <= 1.0 and differing == 0}
            out.append(case)
            _log("[ssd-ops] %s" % json.dumps(case))
    bad = [c for c in out if not c["ok"]]
    if bad:
        raise AssertionError("detection ops: card and CPU disagree: %s"
                             % json.dumps(bad))
    return out


def ssd_phase(mx, ck, np, torch, card, workdir):
    """Phase ssd: (a) ``examples/ssd_train.py --size 512`` synthetic, (b)
    the same from an ImageDetRecordIter, (c) detection at 512 with the
    NMS kernel against its plain version, (d) the detection ops card
    against CPU."""
    t0 = time.perf_counter()
    out = {}
    out["train"], net, rng = ssd_train_synthetic(mx, ck, np, torch, card)
    out["records"] = ssd_train_records(mx, ck, np, torch, card, workdir)
    out["detect"] = ssd_detect(mx, ck, np, torch, card, net, rng)
    out["ops"] = ssd_ops(mx, np, torch)
    out["seconds"] = time.perf_counter() - t0
    return out


def _sgd_summary(sgd, sgd_step, by_path):
    """K1's line of the kernels table: phase 2's checks (``check_sgd``)
    and its launches in each counted run of ``by_path``."""
    return {"name": "sgd_step", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/sgd_step.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:495",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in sgd),
            "differing_elements": sum(sum(c["differing_elements"].values())
                                      for c in sgd),
            **{k: sgd_step[k] for k in (
                "ms", "call_ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms", "at")},
            "cases": sgd}


def _adam_summary(adam, adam_step, by_path):
    """K3's line of the kernels table: phase 2's checks (``check_adam``)
    and its launches in each counted run of ``by_path``."""
    return {"name": "adam_step", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/adam_step.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:518",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in adam),
            "differing_elements": sum(sum(c["differing_elements"].values())
                                      for c in adam),
            **{k: adam_step[k] for k in (
                "ms", "device_ms", "call_ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "library_ms",
                "library_device_ms", "vs_library", "at")},
            "cases": adam}


def _ssd_sgd_launches(ssd):
    """K1's launches in phase ssd's two counted training runs."""
    return {"ssd_train": ssd["train"]["launches"]["sgd_step"],
            "ssd_records": ssd["records"]["launches"]["sgd_step"]}


def _ssd_summary(ssd):
    """The NMS kernel's line of the kernels table, at the detection
    call's shape (N = 65,280, batch 2), with its launches in the counted
    detection and Proposal calls of phase ssd(c)."""
    cases = ssd["detect"]["cases"]
    top = cases[0]
    by_path = {"ssd_" + k: v for k, v in ssd["detect"]["launches"].items()}
    return {"name": "box_nms", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/box_nms.cu",
            "replaces": "none (mxnet_tpu/ops/contrib.py:54, _nms_one, "
                        "plain XLA ops)",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "differing_elements": sum(c["differing"] + c["differing_chunked"]
                                      for c in cases),
            **{k: top[k] for k in (
                "ms", "device_ms", "sort_ms", "sort_device_ms", "kernel_ms",
                "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_share", "library_ms", "library", "pairs_needed",
                "pairs_least", "pairs_computed", "scratch_bytes",
                "no_host_sync", "kept")},
            "at": top["shape"],
            "detect_call_ms": top["detect_call_ms"],
            **{name: {k: case[k] for k in (
                "ms", "device_ms", "sort_ms", "kernel_ms", "kernel_device_ms",
                "plain_ms", "bound_ms", "bound_by", "bound_share",
                "pairs_needed", "pairs_least", "pairs_computed",
                "scratch_bytes", "kept", "valid_rows", "shape")}
               for name, case in (("dense", cases[1]),
                                  ("dense_any_class", cases[2]),
                                  ("proposal_6000", cases[-1]))}}


# ------------------------------------------------------- phase predict
#: ResNet-50 v1 one-shot serving (``bench.py`` ``infer_config``'s net)
PRED_HW = 224
#: the export example's and each calibration batch's rows
PRED_BATCH = 32
PRED_CALIB_BATCHES = 4
#: sequential batch-1 ``predict`` calls timed
PRED_SEQUENTIAL = 32
#: served traffic: requests of 1-4 rows from PRED_THREADS threads
PRED_REQUESTS = 128
PRED_THREADS = 8
PRED_MAX_BATCH = 32
PRED_DELAY_MS = 2.0
#: sites the int8 export excludes: the reference's set for these seeded
#: weights and calibration batches (its CPU run at batch 2 measured
#: 0.01395 relative error with none excluded, inside the 0.05 budget)
PRED_EXCLUDED = ()
#: rows the CPU forward of the port checks
PRED_CPU_ROWS = 2
#: bounds, each relative to the largest |logit| of the rows compared: the
#: predictor against the eager forward on the card (the same ops), the
#: card against the port on the CPU (f32, TF32 off: summation orders
#: only), a served row against its batch-1 predict (cuDNN and cuBLAS
#: choose kernels by batch shape) in f32 and in int8 (an activation whose
#: f32 bits differ can round to the next int8 code)
PRED_EAGER_TOL = 1e-5
PRED_CPU_TOL = 1e-4
PRED_ROW_BOUND = 1e-4
PRED_INT8_ROW_BOUND = 2.0 ** -6
#: bench.py serving_config / quantized_serving_config, at their sizes
BENCH_SRV_FEAT, BENCH_SRV_MAX_BATCH, BENCH_SRV_THREADS = 64, 16, 8
BENCH_SRV_REQUESTS = 256


def _rel_diff(np, got, want):
    """max |got - want| over the largest |want|."""
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


#: kernel-name marks of cuDNN's (and cuBLAS's) float convolutions
_CONV_KERNEL_MARKS = ("fprop", "cudnn", "implicit_convolve", "winograd",
                      "fft", "dgrad", "wgrad")


def _op_counts(torch, fn, names, attempts=PROFILE_ATTEMPTS):
    """One profiled ``fn()``: how many times each aten op of ``names`` ran
    (host-side op events) and how many device kernels carried a
    convolution's name (``_CONV_KERNEL_MARKS``; None when the profiler
    recorded no CUDA activity in ``attempts`` windows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [ev.name for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        if device:
            break
    counts = {n: 0 for n in names}
    for ev in prof.key_averages():
        if ev.key in counts:
            counts[ev.key] += ev.count
    counts["conv_kernels"] = sum(
        any(m in n.lower() for m in _CONV_KERNEL_MARKS)
        for n in device) if device else None
    return counts


def _serve_traffic(mx, np, torch, prefix, quantized, reqs, threads,
                   max_batch, delay_ms, sites=0):
    """``reqs`` through one ``Server`` from ``threads`` threads: rates,
    the serving timers, the dispatches, the int8 products on the card
    (``ops.int8.PRODUCTS``) and a profiled window; returns the report and
    the served outputs in request order."""
    from mxnet_tpu_torch import serving, telemetry as tt
    from mxnet_tpu_torch.ops import int8
    import threading
    srv = serving.Server(max_batch=max_batch, max_queue_delay_ms=delay_ms)
    srv.register("m", prefix, quantized=quantized)
    t0 = time.perf_counter()
    srv.start()
    out = {"start_s": time.perf_counter() - t0}
    try:
        srv.predict("m", reqs[0], timeout=600)      # the dispatch path
        for name in ("queue_delay_ms", "batch_fill", "dispatch_ms",
                     "request_ms"):
            tt.timer("serving." + name).reset()
        c = {k: tt.counter("serving." + k).value
             for k in ("batch_dispatches", "quantized_dispatches")}
        int8.reset_products()
        results = [None] * len(reqs)

        def worker(k):
            futs = [(i, srv.submit("m", reqs[i]))
                    for i in range(k, len(reqs), threads)]
            for i, f in futs:
                results[i] = f.result(timeout=600)

        pool = [threading.Thread(target=worker, args=(k,))
                for k in range(threads)]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        dt = time.perf_counter() - t0
        dispatches = tt.counter("serving.batch_dispatches").value \
            - c["batch_dispatches"]
        rows = sum(r.shape[0] for r in reqs)
        qd = tt.timer("serving.queue_delay_ms").stats()
        fill = tt.timer("serving.batch_fill").stats()
        disp = tt.timer("serving.dispatch_ms").stats()
        out.update({
            "requests": len(reqs), "rows": rows, "threads": threads,
            "max_batch": max_batch, "max_queue_delay_ms": delay_ms,
            "seconds": dt, "requests_per_s": len(reqs) / dt,
            "rows_per_s": rows / dt, "queue_delay_p99_ms": qd["p99"],
            "batch_fill_mean": fill["total"] / max(fill["count"], 1),
            "dispatch_ms_p50": disp["p50"], "dispatch_ms_p99": disp["p99"],
            "dispatches": dispatches,
            "quantized_dispatches": tt.counter(
                "serving.quantized_dispatches").value
            - c["quantized_dispatches"],
            "int8_products": int8.PRODUCTS["int8_mm"],
            "int8_products_plain": int8.PRODUCTS["plain"]})
        if quantized and out["int8_products"] != sites * dispatches:
            raise AssertionError(
                "int8 products %d, want %d recolored sites x %d dispatches"
                % (out["int8_products"], sites, dispatches))
        if not quantized and out["int8_products"]:
            raise AssertionError("an f32 model ran %d int8 products"
                                 % out["int8_products"])

        def window():
            futs = [srv.submit("m", r) for r in reqs[:64]]
            for f in futs:
                f.result(timeout=600)
        out["profile"] = _profile(torch, window)
    finally:
        srv.stop()
    return out, results


def _row_gap(np, pred, reqs, results):
    """The largest difference of a served row from its own batch-1
    ``predict``, relative to that row's largest |logit|."""
    worst = 0.0
    for x, got in zip(reqs, results):
        for i in range(x.shape[0]):
            worst = max(worst, _rel_diff(np, got[i:i + 1],
                                         pred.predict(x[i:i + 1])))
    return worst


def _sequential(pred, reqs):
    pred.predict(reqs[0])
    t0 = time.perf_counter()
    for r in reqs:
        pred.predict(r)
    return len(reqs) / (time.perf_counter() - t0)


def _accumulator_checks(np, torch, pred):
    """Two recolored convolution sites (the first, and the first 3x3):
    their int32 accumulator on the card (``_int_mm``) bitwise against the
    plain version on the CPU from the same int8 inputs."""
    from mxnet_tpu_torch import quantization
    from mxnet_tpu_torch.ops import int8
    rng = np.random.RandomState(SEED + 2)
    picked = []
    for name, node, _ in quantization.graph_sites(pred._graph):
        site = pred._sites.get(id(node))
        if site is None or site.op != "Convolution":
            continue
        k = tuple(site.wq.shape[2:])
        if not picked or (k == (3, 3) and len(picked) == 1):
            picked.append((name, node, site))
        if len(picked) == 2:
            break
    out = []
    for name, node, site in picked:
        a = node.attrs
        c = site.wq.shape[1] * int(a.get("num_group", 1))
        x = rng.randint(-127, 128, (2, c, 56, 56)).astype(np.int8)
        args = (a.get("stride"), a.get("pad") or 0, a.get("dilate"),
                int(a.get("num_group", 1)))
        card = int8.int8_conv(torch.from_numpy(x).cuda(), site.wq, *args)
        plain = int8.int8_conv_plain(torch.from_numpy(x), site.wq.cpu(),
                                     *args)
        same = bool(torch.equal(card.cpu(), plain))
        out.append({"site": name, "weight": list(site.wq.shape),
                    "input": list(x.shape), "bitwise": same})
        if not same:
            raise AssertionError("site %s: the card's int32 accumulator "
                                 "differs from the plain version" % name)
    return out


def _pred_net(mx, np, torch):
    """resnet50_v1 at full width on the card, seeded Xavier (as
    ``one_config``), its deferred shapes resolved."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(SEED)
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 3, PRED_HW, PRED_HW), np.float32),
                    ctx=mx.gpu(0)))
    return net


def predict_resnet(mx, np, torch, card, workdir):
    """Phase 8 (a) and (b): ResNet-50 v1 one-shot, f32 and int8."""
    from mxnet_tpu_torch import autograd, deploy, quantization
    rng = np.random.RandomState(SEED + 1)
    shape = (PRED_BATCH, 3, PRED_HW, PRED_HW)
    calib = [rng.uniform(size=shape).astype(np.float32)
             for _ in range(PRED_CALIB_BATCHES)]
    reqs = [rng.uniform(size=(n, 3, PRED_HW, PRED_HW)).astype(np.float32)
            for n in rng.randint(1, 5, PRED_REQUESTS)]
    singles = [r[:1] for r in reqs[:PRED_SEQUENTIAL]]
    out = {"card": card, "batch": PRED_BATCH, "requests": PRED_REQUESTS}
    t0 = time.perf_counter()
    net = _pred_net(mx, np, torch)
    prefix = os.path.join(workdir, "resnet50_f32")
    deploy.export_model(net, prefix, calib[0])
    pred = deploy.load_model(prefix)
    out["export_load_s"] = time.perf_counter() - t0
    x = calib[1]
    got = pred.predict(x)
    with autograd.predict_mode(), torch.no_grad():
        eager = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    cpu = deploy.load_model(prefix, device="cpu").predict(
        x[:PRED_CPU_ROWS])
    xt = torch.from_numpy(x).cuda()
    f32 = {"dynamic_batch": pred.dynamic_batch,
           "output_shape": list(got.shape),
           "finite": bool(np.isfinite(got).all()),
           "vs_eager": _rel_diff(np, got, eager),
           "vs_eager_bound": PRED_EAGER_TOL,
           "vs_cpu": _rel_diff(np, got[:PRED_CPU_ROWS], cpu),
           "vs_cpu_bound": PRED_CPU_TOL,
           "batch32_ms": _time_ms(lambda: pred.run(xt)),
           "batch32_device_ms": _device_ms(torch, lambda: pred.run(xt))}
    if not (f32["finite"] and got.shape == (PRED_BATCH, 1000)
            and f32["vs_eager"] <= PRED_EAGER_TOL
            and f32["vs_cpu"] <= PRED_CPU_TOL):
        raise AssertionError("resnet50 f32 predictor: %s" % json.dumps(f32))
    f32["sequential_requests_per_s"] = _sequential(pred, singles)
    f32["convolutions_a_forward"] = _op_counts(
        torch, lambda: pred.run(torch.from_numpy(x[:2]).cuda()),
        ("aten::convolution", "aten::_int_mm"))
    served, results = _serve_traffic(mx, np, torch, prefix, False, reqs,
                                     PRED_THREADS, PRED_MAX_BATCH,
                                     PRED_DELAY_MS)
    served["row_gap"] = _row_gap(np, pred, reqs, results)
    served["row_gap_bound"] = PRED_ROW_BOUND
    f32["served"] = served
    f32["continuous_over_sequential"] = served["requests_per_s"] \
        / f32["sequential_requests_per_s"]
    _log("[predict] f32 %s" % json.dumps(f32))
    if served["row_gap"] > PRED_ROW_BOUND:
        raise AssertionError("served f32 rows differ from batch-1 predict "
                             "by %g > %g" % (served["row_gap"],
                                             PRED_ROW_BOUND))
    out["f32"] = f32

    # (b) int8: calibrate, export with the guardrail, serve
    t0 = time.perf_counter()
    cal = quantization.calibrate(net, calib, mode="entropy")
    t1 = time.perf_counter()
    qprefix = os.path.join(workdir, "resnet50_int8")
    quantization.export_quantized(net, qprefix, cal,
                                  excluded=PRED_EXCLUDED)
    qpred = deploy.load_model(qprefix, quantized=True)
    sites = len(qpred.recolored_sites)
    q = {"calibrate_s": t1 - t0, "export_load_s": time.perf_counter() - t1,
         "sites": len(cal.sites), "recolored_sites": sites,
         "excluded": list(PRED_EXCLUDED),
         "measured_error": qpred.meta["measured_error"],
         "error_budget": qpred.meta["error_budget"]}
    qgot = qpred.predict(x)
    q["finite"] = bool(np.isfinite(qgot).all())
    q["vs_f32"] = float(np.linalg.norm(qgot - got) / np.linalg.norm(got))
    q["batch32_ms"] = _time_ms(lambda: qpred.run(xt))
    q["batch32_device_ms"] = _device_ms(torch, lambda: qpred.run(xt))
    excluded_convs = sum(1 for s in cal.sites if s["op"] == "Convolution"
                         and (s["name"] in PRED_EXCLUDED
                              or "Convolution" in PRED_EXCLUDED))
    ops = _op_counts(torch, lambda: qpred.run(xt),
                     ("aten::convolution", "aten::_int_mm"))
    q["ops_a_forward"] = ops
    if ops["aten::convolution"] != excluded_convs \
            or ops["aten::_int_mm"] != sites \
            or (excluded_convs == 0 and ops["conv_kernels"]):
        raise AssertionError(
            "int8 forward ran %s: want %d convolutions (the excluded "
            "ones), no convolution kernel when none is excluded, and %d "
            "_int_mm" % (ops, excluded_convs, sites))
    q["sequential_requests_per_s"] = _sequential(qpred, singles)
    served, results = _serve_traffic(mx, np, torch, qprefix, True, reqs,
                                     PRED_THREADS, PRED_MAX_BATCH,
                                     PRED_DELAY_MS, sites=sites)
    served["row_gap"] = _row_gap(np, qpred, reqs, results)
    served["row_gap_bound"] = PRED_INT8_ROW_BOUND
    q["served"] = served
    q["accumulators"] = _accumulator_checks(np, torch, qpred)
    q["continuous_over_sequential"] = served["requests_per_s"] \
        / q["sequential_requests_per_s"]
    q["int8_over_f32_img_per_s"] = served["rows_per_s"] \
        / out["f32"]["served"]["rows_per_s"]
    _log("[predict] int8 %s" % json.dumps(q))
    if not q["finite"] or served["quantized_dispatches"] \
            != served["dispatches"] or served["row_gap"] \
            > PRED_INT8_ROW_BOUND:
        raise AssertionError("resnet50 int8 serving: %s" % json.dumps(q))
    out["int8"] = q
    return out


def _bench_mlp(mx, seed):
    """``bench.py``'s serving MLP: 64 -> Dense(128, relu) -> Dense(16)."""
    from mxnet_tpu_torch.gluon import nn
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"), nn.Dense(16))
    net.initialize(ctx=mx.gpu(0))
    return net


def bench_serving(mx, np, torch, workdir):
    """Phase 8 (c): ``bench.py`` ``serving_config`` and
    ``quantized_serving_config`` through the port, at their sizes."""
    from mxnet_tpu_torch import deploy, quantization
    feat, cap, threads = BENCH_SRV_FEAT, BENCH_SRV_MAX_BATCH, \
        BENCH_SRV_THREADS
    n = BENCH_SRV_REQUESTS
    # serving_config: sequential batch-1 against continuous batching
    net = _bench_mlp(mx, 11)
    example = np.random.RandomState(11).uniform(size=(cap, feat)) \
        .astype(np.float32)
    prefix = os.path.join(workdir, "bench_mlp")
    deploy.export_model(net, prefix, example)
    rng = np.random.RandomState(2)
    reqs = [rng.uniform(size=(1, feat)).astype(np.float32)
            for _ in range(n)]
    pred = deploy.load_model(prefix)
    seq = _sequential(pred, reqs)
    cont, results = _serve_traffic(mx, np, torch, prefix, False, reqs,
                                   threads, cap, 2.0)
    out = {"serving_config": {
        "sequential_requests_per_s": seq, "continuous": cont,
        "continuous_over_sequential": cont["requests_per_s"] / seq,
        "row_gap": _row_gap(np, pred, reqs[:64], results[:64])}}
    # quantized_serving_config: int8 against f32 from one net
    net = _bench_mlp(mx, 13)
    rng = np.random.RandomState(3)
    calib = [rng.uniform(-1, 1, size=(cap, feat)).astype(np.float32)
             for _ in range(4)]
    fp = os.path.join(workdir, "bench_fp32")
    qp = os.path.join(workdir, "bench_int8")
    deploy.export_model(net, fp, calib[0])
    cal = quantization.calibrate(net, calib)
    quantization.export_quantized(net, qp, cal)
    qpred = deploy.load_model(qp, quantized=True)
    reqs = [rng.uniform(-1, 1, size=(1, feat)).astype(np.float32)
            for _ in range(n)]
    f32, _ = _serve_traffic(mx, np, torch, fp, False, reqs, threads, cap,
                            2.0)
    q8, _ = _serve_traffic(mx, np, torch, qp, True, reqs, threads, cap,
                           2.0, sites=len(qpred.recolored_sites))
    out["quantized_serving_config"] = {
        "fp32": f32, "int8": q8,
        "measured_error": qpred.meta["measured_error"],
        "int8_over_fp32": q8["requests_per_s"] / f32["requests_per_s"]}
    _log("[predict] bench %s" % json.dumps(
        {"continuous_over_sequential": out["serving_config"][
            "continuous_over_sequential"],
         "int8_over_fp32": out["quantized_serving_config"][
             "int8_over_fp32"]}))
    return out


def predict_phase(mx, np, torch, card, workdir):
    """Phase 8: one-shot serving (no kernel of its own)."""
    t0 = time.perf_counter()
    out = {"resnet50": predict_resnet(mx, np, torch, card, workdir),
           "bench": bench_serving(mx, np, torch, workdir)}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------- phase dist
#: ``bench.py`` ``dlrm_embedding_config`` (bench.py:617) at its own sizes
#: and seeds: a 1,000,000 x 32 f32 table (128 MB), Zipf(1.5) id batches
#: of 256 x 8 (RandomState(5)), Dense(64, relu) -> Dense(1), L2Loss,
#: SGD lr 0.05, the net seeded 9, one warm step then 8 steps
DLRM_VOCAB, DLRM_DIM, DLRM_BATCH, DLRM_SLOTS = 1_000_000, 32, 256, 8
DLRM_HIDDEN, DLRM_LR, DLRM_STEPS, DLRM_SEED = 64, 0.05, 8, 9
#: steps of the timed run (the 8 batches in turn), after the counted one:
#: 8 steps take ~20 ms, too short a window for the host clock
DLRM_TIMED_STEPS = 32
#: the reduced vocabulary of the Adam run and of the two-rank run, and
#: their step count
DLRM_SMALL_VOCAB, DLRM_SMALL_STEPS, DLRM_ADAM_LR = 100_000, 3, 0.01
#: the reference's sparse-over-dense samples/s target (bench.py's
#: docstring): recorded as a target only, never measured as a baseline
DLRM_TARGET_RATIO = 3.0
#: sparse route against dense route after DLRM_STEPS SGD steps, max
#: |difference| of any parameter: the routes round the table update
#: differently (K1 contracts ``w - lr g`` into one fma, ``step_rows``
#: rounds twice as the reference's does) and sum the row gradients in
#: different orders (the card's index_add uses atomics)
DLRM_ROUTE_ATOL = 1e-5
#: Adam on the card against Adam on the CPU after DLRM_SMALL_STEPS steps
#: (the card's GEMMs and atomics sum in other orders; K3 is bitwise its
#: plain version)
DLRM_CARD_CPU_ATOL = 1e-5
#: two gloo ranks on cuda:0 against one rank after DLRM_SMALL_STEPS SGD
#: steps (the all-reduced gradients sum the ranks' partial sums)
DLRM_RANKS_ATOL = 1e-6
#: the compressed step's exact-arithmetic model (Dense(1) over 4
#: features, dyadic inputs): codes and residuals bitwise card against CPU
DCN_FEAT, DCN_LR, DCN_STEPS = 4, 0.25, 3
DIST_WORKER_TIMEOUT_S = 600
#: the device of phase dist(b)'s ranks (a CPU rehearsal sets "cpu")
DIST_DEVICE = "cuda"
#: the collectives whose acceptance of CUDA tensors under gloo the
#: two-rank run probes (the path uses all_reduce, broadcast, all_gather
#: and barrier, each on the tensor where it lies: none is staged through
#: host memory)
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor")


def dlrm_batches(np, steps=None, vocab=None):
    """``dlrm_embedding_config``'s 8 id batches and labels, in its draw
    order (the first ``steps``; ids capped at ``vocab``)."""
    steps = DLRM_STEPS if steps is None else steps
    vocab = DLRM_VOCAB if vocab is None else vocab
    rng = np.random.RandomState(5)
    batches = [np.minimum(rng.zipf(1.5, (DLRM_BATCH, DLRM_SLOTS)), vocab)
               .astype(np.int32) - 1 for _ in range(8)]
    labels = [rng.randn(DLRM_BATCH, 1).astype(np.float32)
              for _ in range(8)]
    return batches[:steps], labels[:steps]


def dlrm_net(mx, vocab, init=None):
    """The DLRM model under a fresh name scope (so every build names its
    parameters alike), seeded, with ``init``'s values where given."""
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    nn = mx.gluon.nn
    with mx.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Embedding(vocab, DLRM_DIM, sparse_grad=True))
            net.add(nn.Flatten())
            net.add(nn.Dense(DLRM_HIDDEN, activation="relu",
                             in_units=DLRM_SLOTS * DLRM_DIM))
            net.add(nn.Dense(1, in_units=DLRM_HIDDEN))
    mx.random.seed(DLRM_SEED)
    net.initialize(mx.init.Xavier())
    if init is not None:
        for name, p in net.collect_params().items():
            p.set_data(init[name])
    return net


def _dlrm_trainer(mx, net, opt, lr, mesh=None):
    return mx.parallel.SPMDTrainer(net, mx.gluon.loss.L2Loss(), opt,
                                   {"learning_rate": lr}, mesh=mesh)


def _max_diff(torch, a, b):
    return float((a.detach().float().cpu()
                  - b.detach().float().cpu()).abs().max())


def _dlrm_route(mx, ck, np, torch, tt, init, sparse, batches, labels):
    """One route of ``dlrm_embedding_config`` on the card: a warm step on a
    throwaway trainer, then DLRM_STEPS counted steps from the initial
    weights (K1 once a step; on the sparse route ``capacity`` rows a
    step), the weights they leave, one more step's peak memory above
    the resting level, DLRM_TIMED_STEPS timed steps (samples/s and host
    ms a step: host clock around steps ending in a synchronize) and a
    profiled window of two steps (device ms a step, idle share)."""
    mx.config.set("embedding.sharded", sparse)
    try:
        net = dlrm_net(mx, DLRM_VOCAB, init)
        warm = _dlrm_trainer(mx, net, "sgd", DLRM_LR)
        warm.step(batches[0], labels[0])
        torch.cuda.synchronize()
        del warm
        tr = _dlrm_trainer(mx, net, "sgd", DLRM_LR)
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        for d, l in zip(batches, labels):
            loss = tr.step(d, l)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        counters = tt.snapshot()["counters"]
        assert launches == _want_launches(ck, sgd_step=DLRM_STEPS), launches
        cap = DLRM_BATCH * DLRM_SLOTS
        if sparse:
            for key in ("embedding.rows_touched", "embedding.gathered_rows"):
                assert counters.get(key) == cap * DLRM_STEPS, (key, counters)
        after = {n: v.detach().clone() for n, v in tr.params.items()}
        assert math.isfinite(float(loss))
        torch.cuda.empty_cache()
        resting = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.step(batches[0], labels[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resting
        t1 = time.perf_counter()
        for i in range(DLRM_TIMED_STEPS):
            tr.step(batches[i % len(batches)], labels[i % len(labels)])
        torch.cuda.synchronize()
        timed = time.perf_counter() - t1
        prof = _profile(torch, lambda: [tr.step(d, l) for d, l in
                                        zip(batches[:2], labels[:2])])
    finally:
        mx.config.unset("embedding.sharded")
    out = {"route": "sparse" if sparse else "dense", "steps": DLRM_STEPS,
           "counted_run_s": elapsed, "timed_steps": DLRM_TIMED_STEPS,
           "timed_s": timed,
           "samples_per_s": DLRM_BATCH * DLRM_TIMED_STEPS / timed,
           "host_ms_per_step": timed * 1e3 / DLRM_TIMED_STEPS,
           "launches": launches, "loss": float(loss),
           "step_peak_bytes_above_resting": peak,
           "resting_bytes": resting, "profile": prof}
    if "device_busy_ms" in prof:
        out["device_ms_per_step"] = prof["device_busy_ms"] / 2
        out["idle_share"] = prof["idle_share"]
    if sparse:
        out["rows_touched"] = counters["embedding.rows_touched"]
    return out, after


def _dlrm_adam(mx, ck, np, torch, tt, card):
    """Row-sparse Adam at DLRM_SMALL_VOCAB rows through K3 (the MLP) and
    ``Adam.step_rows`` (the table): DLRM_SMALL_STEPS steps on the card
    and on the CPU from the same weights, held within
    DLRM_CARD_CPU_ATOL."""
    batches, labels = dlrm_batches(np, DLRM_SMALL_STEPS, DLRM_SMALL_VOCAB)
    init = {n: p.data()._data.detach().clone() for n, p in dlrm_net(
        mx, DLRM_SMALL_VOCAB).collect_params().items()}
    net = dlrm_net(mx, DLRM_SMALL_VOCAB, init)
    tr = _dlrm_trainer(mx, net, "adam", DLRM_ADAM_LR)
    _zero_counts(torch, tt, ck)
    for d, l in zip(batches, labels):
        tr.step(d, l)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck, adam_step=DLRM_SMALL_STEPS), \
        launches
    with mx.cpu():
        cpu_net = dlrm_net(mx, DLRM_SMALL_VOCAB,
                           {n: v.cpu() for n, v in init.items()})
        cpu_tr = _dlrm_trainer(mx, cpu_net, "adam", DLRM_ADAM_LR,
                               mesh=mx.parallel.make_mesh({"dp": 1},
                                                          [mx.cpu()]))
        for d, l in zip(batches, labels):
            cpu_tr.step(d, l)
    err = {n.split("_", 1)[1]: _max_diff(torch, tr.params[n],
                                         cpu_tr.params[n])
           for n in tr.params}
    assert max(err.values()) <= DLRM_CARD_CPU_ATOL, err
    out = {"vocab": DLRM_SMALL_VOCAB, "steps": DLRM_SMALL_STEPS,
           "lr": DLRM_ADAM_LR, "launches": launches,
           "card_vs_cpu_max_abs": err, "bound": DLRM_CARD_CPU_ATOL,
           "card": card}
    _log("[dist-adam] %s" % json.dumps(out))
    return out


def _start_group(cmd):
    """Start ``cmd`` in a session of its own (the launcher and its
    ranks)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish_group(proc, timeout):
    """``(returncode, stdout, stderr)`` of a started group; on a timeout
    the whole session is killed and the timeout raised."""
    import signal
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def _run_group(cmd, timeout):
    return _finish_group(_start_group(cmd), timeout)


def _dist_ranks(mx, np, torch, workdir, card):
    """Phase dist(b): two gloo ranks sharing cuda:0, started by the
    port's launcher, held against one rank on the same global batches:
    the dist_sync contract on CUDA tensors, DLRM_SMALL_STEPS steps of
    the DLRM model at DLRM_SMALL_VOCAB rows with the table sharded on the
    vocab axis (lookup bitwise the one-rank lookup, weights within
    DLRM_RANKS_ATOL), a 2-bit compressed step on ``{"dcn": 2}`` whose
    codes and residuals are bitwise the same step's on the CPU, and which
    collectives gloo takes on CUDA tensors."""
    batches, labels = dlrm_batches(np, DLRM_SMALL_STEPS, DLRM_SMALL_VOCAB)
    net = dlrm_net(mx, DLRM_SMALL_VOCAB)
    init = {n: p.data()._data.detach().clone() for n, p in
            net.collect_params().items()}
    tr = _dlrm_trainer(mx, net, "sgd", DLRM_LR)
    for d, l in zip(batches, labels):
        tr.step(d, l)
    tr.sync()
    one = {n: p.data()._data.detach() for n, p in
           net.collect_params().items()}
    for r in range(2):
        stale = os.path.join(workdir, "dist_rank%d.json" % r)
        if os.path.exists(stale):
            os.remove(stale)
    path = os.path.join(workdir, "dist_inputs.npz")
    np.savez(path, **{"init/" + n: v.cpu().numpy() for n, v in init.items()})
    t0 = time.perf_counter()
    rc, out, err = _run_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--dist-worker", workdir], DIST_WORKER_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("two-rank run failed (rc %d):\n%s\n%s"
                             % (rc, out[-4000:], err[-8000:]))
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, "dist_rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    got = dict(np.load(os.path.join(workdir, "dist_params.npz")))
    err_ = {n.split("_", 1)[1]: _max_diff(torch, torch.from_numpy(got[n]),
                                          one[n]) for n in one}
    assert max(err_.values()) <= DLRM_RANKS_ATOL, err_
    backends = [line for line in err.splitlines()
                if "mxnet_tpu_torch.parallel: rank" in line]
    assert len(backends) == 2 and all("backend gloo" in b
                                      for b in backends), backends
    res = {"seconds": seconds, "ranks": ranks, "backend_lines": backends,
           "vs_one_rank_max_abs": err_, "bound": DLRM_RANKS_ATOL,
           "card": card}
    _log("[dist-ranks] %s" % json.dumps(res))
    return res


def _start_nccl():
    """Phase dist(c): a world-size-1 ``nccl`` group on cuda:0 and one
    ``all_reduce``, in a process of its own, started now (it runs beside
    phase dist(b)) and read by :func:`_dist_nccl`."""
    return time.perf_counter(), _start_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "1",
         sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--nccl-worker"])


def _dist_nccl(started):
    t0, proc = started
    rc, out, err = _finish_group(proc, DIST_WORKER_TIMEOUT_S)
    if rc != 0:
        raise AssertionError("nccl run failed (rc %d):\n%s\n%s"
                             % (rc, out[-4000:], err[-8000:]))
    line = next(line for line in out.splitlines()
                if line.startswith("NCCL_OK "))
    res = json.loads(line.split(" ", 1)[1])
    res["seconds"] = time.perf_counter() - t0
    assert res["backend"] == "nccl", res
    _log("[dist-nccl] %s" % json.dumps(res))
    return res


def dist_phase(mx, ck, np, torch, card, workdir):
    """Phase dist: (a) ``bench.py``'s ``dlrm_embedding_config`` on one
    rank, sparse and dense routes, and row-sparse Adam card against CPU;
    (b) two gloo ranks on cuda:0 through the port's launcher; (c) a
    one-card NCCL group."""
    from mxnet_tpu_torch import telemetry as tt
    t0 = time.perf_counter()
    batches, labels = dlrm_batches(np)
    init = {n: p.data()._data.detach().clone() for n, p in
            dlrm_net(mx, DLRM_VOCAB).collect_params().items()}
    runs, after = {}, {}
    for sparse in (True, False):
        key = "sparse" if sparse else "dense"
        runs[key], after[key] = _dlrm_route(mx, ck, np, torch, tt, init,
                                            sparse, batches, labels)
        _log("[dist-dlrm] %s" % json.dumps(
            {k: v for k, v in runs[key].items() if k != "profile"}))
    route_err = {n.split("_", 1)[1]: _max_diff(torch, after["sparse"][n],
                                               after["dense"][n])
                 for n in after["sparse"]}
    assert max(route_err.values()) <= DLRM_ROUTE_ATOL, route_err
    table = next(n for n in init if n.endswith("embedding0_weight"))
    dev = init[table].device
    touched = torch.from_numpy(np.unique(np.concatenate(
        [b.ravel() for b in batches]))).to(dev)
    untouched = torch.ones(DLRM_VOCAB, dtype=torch.bool, device=dev)
    untouched[touched] = False
    moved = _differing(torch, after["sparse"][table][untouched],
                       init[table][untouched])
    assert moved == 0, moved
    table_bytes = DLRM_VOCAB * DLRM_DIM * 4
    sparse_peak = runs["sparse"]["step_peak_bytes_above_resting"]
    assert sparse_peak < table_bytes, (sparse_peak, table_bytes)
    out = {"config": {"source": "bench.py dlrm_embedding_config",
                      "vocab": DLRM_VOCAB, "dim": DLRM_DIM,
                      "batch": DLRM_BATCH, "slots": DLRM_SLOTS,
                      "hidden": DLRM_HIDDEN, "optimizer": "sgd",
                      "lr": DLRM_LR, "steps": DLRM_STEPS},
           "card": card,
           "unique_ratio": float(np.mean([np.unique(b).size / b.size
                                          for b in batches])),
           "sparse": runs["sparse"], "dense": runs["dense"],
           "sparse_over_dense": runs["sparse"]["samples_per_s"]
           / runs["dense"]["samples_per_s"],
           "target_sparse_over_dense": DLRM_TARGET_RATIO,
           "target_is": "the reference's stated target, not a measured "
                        "baseline",
           "route_max_abs": route_err, "route_bound": DLRM_ROUTE_ATOL,
           "untouched_rows": int(untouched.sum()),
           "untouched_rows_moved": moved, "table_bytes": table_bytes}
    out["adam"] = _dlrm_adam(mx, ck, np, torch, tt, card)
    nccl = _start_nccl()
    try:
        out["ranks"] = _dist_ranks(mx, np, torch, workdir, card)
    except BaseException:
        _finish_group(nccl[1], DIST_WORKER_TIMEOUT_S)  # leave no process
        raise
    out["nccl"] = _dist_nccl(nccl)
    out["seconds"] = time.perf_counter() - t0
    _log("[dist] %s" % json.dumps(
        {k: v for k, v in out.items() if k not in ("sparse", "dense",
                                                   "adam", "ranks")}))
    return out


def _dist_launches(dist):
    """K1's and K3's launches in phase dist's counted runs."""
    return ({"dlrm_sparse": dist["sparse"]["launches"]["sgd_step"],
             "dlrm_dense": dist["dense"]["launches"]["sgd_step"]},
            {"dlrm_adam_100k": dist["adam"]["launches"]["adam_step"]})


def dcn_batches(np, n_ranks, steps=DCN_STEPS):
    """Dyadic features, labels and weights of the compressed step: every
    product and sum of it is exact in f32."""
    rng = np.random.RandomState(1)
    rows = 4 * n_ranks
    xs = [rng.randint(-2, 3, (rows, DCN_FEAT)).astype(np.float32) / 2
          for _ in range(steps)]
    ys = [rng.randint(-4, 5, (rows, 1)).astype(np.float32) / 4
          for _ in range(steps)]
    w = rng.randint(-8, 9, (1, DCN_FEAT)).astype(np.float32) / 8
    return xs, ys, w, np.array([0.125], np.float32)


def _probe_gloo_cuda(torch, tdist, rank):
    """Which collectives gloo runs on CUDA tensors itself: each is tried
    once on a small tensor (every rank the same calls, in order) and its
    outcome recorded."""
    found = {}
    x = torch.full((4,), float(rank + 1), device=DIST_DEVICE)
    calls = {
        "all_reduce": lambda: tdist.all_reduce(x.clone()),
        "broadcast": lambda: tdist.broadcast(x.clone(), src=0),
        "all_gather": lambda: tdist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: tdist.all_gather_into_tensor(
            torch.empty(8, device=DIST_DEVICE), x),
        "reduce_scatter_tensor": lambda: tdist.reduce_scatter_tensor(
            torch.empty(2, device=DIST_DEVICE), x)}
    for name in GLOO_PROBES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            found[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as exc:
            found[name] = "%s: %s" % (type(exc).__name__,
                                      str(exc).splitlines()[0][:160])
        tdist.barrier()
    return found


def dist_worker(workdir):
    """One rank of phase dist(b) (``--dist-worker``), on cuda:0 beside the
    other rank, in a gloo group the launcher's environment names."""
    import mxnet_tpu_torch as mx
    with (mx.gpu() if DIST_DEVICE == "cuda" else mx.cpu()):
        return _dist_worker(mx, workdir)


def _dist_worker(mx, workdir):
    import numpy as np
    import torch
    import torch.distributed as tdist
    from mxnet_tpu_torch.parallel import embedding as pemb
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    n = int(os.environ["MXTPU_NUM_PROCESSES"])
    dev = torch.device(DIST_DEVICE)
    # (1) the dist_sync contract of tests/dist_worker.py on CUDA tensors
    kv = mx.kv.create("dist_sync")    # joins the group
    assert (kv.rank, kv.num_workers) == (rank, n)
    assert mx.parallel.dist.backend() == "gloo"
    expect = float(sum(r + 1 for r in range(n)))
    for k, shp in {"3": (4, 4), "9": (2, 5, 2)}.items():
        kv.init(k, mx.nd.ones(shp))
        for _ in range(2):
            kv.push(k, mx.nd.ones(shp) * (rank + 1))
            out = mx.nd.zeros(shp)
            kv.pull(k, out=out)
            assert out._data.device.type == dev.type
            assert bool((out._data == expect).all())
    total = mx.parallel.host_allreduce(
        torch.full((3, 2), rank + 1.0, device=dev))
    assert total.device.type == dev.type and bool((total == expect).all())
    rows = 4 * n + 4
    kv.init("emb", mx.nd.zeros((rows, 3)))
    grad = torch.zeros(rows, 3, device=dev)
    grad[0] = grad[4 + rank] = rank + 1.0
    kv.push("emb", mx.nd.array(grad.cpu().numpy()))
    out = mx.nd.zeros((rows, 3))
    kv.row_sparse_pull("emb", out=out,
                       row_ids=mx.nd.array([0, 4 + rank, 4 + rank]))
    want = torch.zeros(rows, 3, device=dev)
    want[0], want[4 + rank] = expect, rank + 1.0
    assert torch.equal(out._data, want)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("c", mx.nd.zeros((6,)))
    res = torch.zeros(6, device=dev)
    g = torch.full((6,), 0.3, device=dev)
    from mxnet_tpu_torch.parallel.compression import two_bit_compress
    for _ in range(3):
        codes, res = two_bit_compress(g, res, 0.5)
        kv.push("c", mx.nd.array(g.cpu().numpy()))
        out = mx.nd.zeros((6,))
        kv.pull("c", out=out)
        assert torch.equal(out._data, n * codes.float() * 0.5)
    kv.barrier()
    # (2) the vocab-sharded lookup, bitwise the one-rank lookup
    gen = torch.Generator(device=dev).manual_seed(3)
    full = torch.randn(DLRM_SMALL_VOCAB, DLRM_DIM, device=dev,
                       generator=gen)
    full[7] = -0.0
    ids = torch.randint(0, DLRM_SMALL_VOCAB, (2048,), device=dev,
                        generator=gen)
    ids[:3] = torch.tensor([7, DLRM_SMALL_VOCAB, DLRM_SMALL_VOCAB + 5])
    uniq, _ = pemb.dedup_ids(ids, ids.numel(), DLRM_SMALL_VOCAB)
    mesh = mx.parallel.make_mesh({"dp": n})
    per = DLRM_SMALL_VOCAB // n
    got = pemb.lookup_unique(full[rank * per:(rank + 1) * per], uniq, mesh,
                             "dp")
    lookup_differing = _differing(torch, got, pemb.lookup_unique(full, uniq))
    assert lookup_differing == 0, lookup_differing
    # (3) the DLRM model at DLRM_SMALL_VOCAB over {"dp": n}, the table
    # sharded on the vocab axis, from the parent's initial weights
    inp = np.load(os.path.join(workdir, "dist_inputs.npz"))
    init = {k[len("init/"):]: torch.from_numpy(inp[k]).to(dev)
            for k in inp.files if k.startswith("init/")}
    batches, labels = dlrm_batches(np, DLRM_SMALL_STEPS, DLRM_SMALL_VOCAB)
    net = dlrm_net(mx, DLRM_SMALL_VOCAB, init)
    tr = _dlrm_trainer(mx, net, "sgd", DLRM_LR, mesh=mesh)
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launches()
    for d, l in zip(batches, labels):
        tr.step(d, l)
    torch.cuda.synchronize()
    k1 = ck.LAUNCHES["sgd_step"]
    table = next(k for k in init if k.endswith("embedding0_weight"))
    shard_rows = int(tr.params[table].shape[0])
    assert shard_rows == per, shard_rows
    tr.sync()
    if rank == 0:
        np.savez(os.path.join(workdir, "dist_params.npz"),
                 **{k: p.data()._data.detach().cpu().numpy()
                    for k, p in net.collect_params().items()})
    # (4) the 2-bit compressed step on {"dcn": n}, card and CPU
    xs, ys, w0, b0 = dcn_batches(np, n)
    mx.config.set("kvstore.grad_compress", "2bit")
    seen = {}
    try:
        for where, devices in (("card", None), ("cpu", [mx.cpu()] * n)):
            with mx.name.NameManager():
                dnet = mx.gluon.nn.HybridSequential()
                with dnet.name_scope():
                    dnet.add(mx.gluon.nn.Dense(1, in_units=DCN_FEAT))
            ctx = mx.cpu() if where == "cpu" else mx.current_context()
            dnet.initialize(ctx=ctx)
            for name, p in dnet.collect_params().items():
                p.set_data(mx.nd.array(w0 if name.endswith("weight")
                                       else b0, ctx=ctx))
            dtr = _dlrm_trainer(mx, dnet, "sgd", DCN_LR,
                                mesh=mx.parallel.make_mesh({"dcn": n},
                                                           devices))
            steps = []
            for x, y in zip(xs, ys):
                dtr.step(x, y)
                steps.append(([c.cpu() for c in dtr._dcn_codes],
                              [r.cpu() for r in
                               dtr._dcn_residuals.values()]))
            seen[where] = steps
    finally:
        mx.config.unset("kvstore.grad_compress")
    dcn_differing = 0
    for (card_codes, card_res), (cpu_codes, cpu_res) in zip(seen["card"],
                                                            seen["cpu"]):
        dcn_differing += sum(int((a != b).sum())
                             for a, b in zip(card_codes, cpu_codes))
        dcn_differing += sum(_differing(torch, a, b)
                             for a, b in zip(card_res, cpu_res))
    assert dcn_differing == 0, dcn_differing
    fired = sum(int(c.abs().sum()) for step in seen["card"]
                for c in step[0])
    # (5) which collectives gloo takes on CUDA tensors
    probes = _probe_gloo_cuda(torch, tdist, rank)
    mx.parallel.barrier()
    # each rank's own file: the ranks share the launcher's stdout
    with open(os.path.join(workdir, "dist_rank%d.json" % rank), "w") as f:
        json.dump({
            "rank": rank, "device": str(mx.parallel.dist.device()),
            "lookup_differing": lookup_differing,
            "table_shard_rows": shard_rows, "k1_launches": k1,
            "dcn_codes_residuals_differing": dcn_differing,
            "dcn_nonzero_codes": fired, "gloo_cuda": probes}, f)
    tdist.destroy_process_group()
    return 0


def nccl_worker():
    """Phase dist(c) (``--nccl-worker``): a world-size-1 group on cuda:0,
    whose backend the rule makes ``nccl``, and one ``all_reduce``."""
    import torch
    import torch.distributed as tdist
    import mxnet_tpu_torch as mx
    mx.parallel.initialize()
    x = torch.full((1024,), 3.0, device="cuda")
    tdist.all_reduce(x)       # through NCCL, not the one-rank shortcut
    torch.cuda.synchronize()
    assert bool((x == 3.0).all())
    mx.parallel.barrier()
    print("NCCL_OK " + json.dumps({
        "backend": mx.parallel.dist.backend(), "world": tdist.get_world_size(),
        "device": str(mx.parallel.dist.device()),
        "all_reduce_ok": True}), flush=True)
    tdist.destroy_process_group()
    return 0


# ------------------------------------------------------------- phase mesh
#: how long one group of phase mesh may take, start-up included
MESH_WORKER_TIMEOUT_S = 600
#: where phase mesh's ranks run (the card; "cpu" only to rehearse it)
MESH_DEVICE = "cuda"
#: (b): BERT-base at examples/bert_pretrain.py's defaults with --tp 2 on
#: two gloo ranks sharing cuda:0 (phase 4b's BERT_B/S/M, BERT_LR, seeded
#: weights and batch): MESH_BERT_STEPS counted steps after one warm-up,
#: and the f32 model at MESH_BERT32_LAYERS layers for one step
MESH_TP = 2
MESH_BERT_STEPS = 10
MESH_BERT32_LAYERS = 2
#: the dryrun's bound (``__graft_entry__.py:150-153``) for the f32 model's
#: weights after one step, mesh against one rank
MESH_F32_RTOL, MESH_F32_ATOL = 2e-4, 1e-5
#: (c): the TransformerLM at its default width over
#: ``__graft_entry__._factor_mesh(4)``, at B=2 S=1024, bf16.  Its
#: gradients at the initial weights pass phase 4b's gate form: per
#: tensor, the mesh path's relative error against the one-rank f32
#: gradients at most KERNEL_VS_PLAIN_GRAD_ERR x the one-rank plain bf16
#: path's, that error floored at one bf16 ulp (BERT_GRAD_FLOOR).  The
#: mesh path rounds to bf16 where the plain path does (each matmul's
#: output, each attention output); its tp sums add f32 roundings, far
#: below bf16's, and ring attention combines its blocks in f32, so its
#: error is of the plain path's size.  A wrong transpose (a gradient
#: doubled, a block dropped) moves a tensor by its own size.
MESH_LM_AXES = {"dp": 1, "tp": 2, "sp": 2}
MESH_LM_B, MESH_LM_S = 2, 1024


def mesh_lm_config(torch, dtype=None):
    """(c)'s TransformerLM: the default width (vocab 32000, 12 layers,
    d_model 768, 12 heads, d_ff 3072, bf16)."""
    from mxnet_tpu_torch.models.transformer import TransformerLMConfig
    return TransformerLMConfig(dtype=dtype or torch.bfloat16)


MESH_LM_LR, MESH_LM_MOMENTUM = 0.01, 0.9
#: (d): __graft_entry__._dryrun_pipeline_moe(4) at its own shapes (no
#: configuration of the repo is wider): dp 1, pp 2, ep 2, d 16, h 32, 2
#: experts a rank, 2 microbatches of B=4, top-1, capacity factor 4, SGD
#: lr 0.1.  Loss and updated parameters against the one-rank sequential
#: computation at tests/test_pipeline_moe.py:72-75's bounds.
MESH_PPMOE_AXES = {"dp": 1, "pp": 2, "ep": 2}
MESH_PPMOE_D, MESH_PPMOE_H, MESH_PPMOE_ELOC = 16, 32, 2
MESH_PPMOE_M, MESH_PPMOE_B, MESH_PPMOE_LR = 2, 4, 0.1
MESH_PPMOE_LOSS_RTOL = 1e-5
MESH_PPMOE_RTOL, MESH_PPMOE_ATOL = 1e-4, 1e-6
MESH_PPMOE_SPECS = {"gate": ("pp",), "w1": ("pp", "ep"),
                    "b1": ("pp", "ep"), "w2": ("pp", "ep"),
                    "b2": ("pp", "ep")}
#: (e): bench.py module_train_config's MLP (8 Dense layers of 128 with
#: relu, a 10-way head, batch 64 of 64 features) as a Gluon block under
#: SPMDTrainer, each hidden Dense split on its output rows over tp and
#: the head on its input columns; SGD lr 0.1 momentum 0.9 through K1
MESH_MLP_LAYERS, MESH_MLP_WIDTH, MESH_MLP_FEAT = 8, 128, 64
MESH_MLP_BATCH, MESH_MLP_CLASSES, MESH_MLP_STEPS = 64, 10, 3
#: the per-rank flash shape of (b): BERT-base's batch at 6 local heads
MESH_FLASH_CASES = ((BERT_B, 12 // MESH_TP, False, BERT_S, BERT_S, 64),)


def mesh_mlp_specs():
    """(e)'s param_specs by the names under the block's prefix, and the
    per-rank shapes of the trainable tensors in the trainer's order."""
    specs = {}
    for i in range(MESH_MLP_LAYERS):
        specs["dense%d_weight" % i] = ("tp", None)
        specs["dense%d_bias" % i] = ("tp",)
    specs["dense%d_weight" % MESH_MLP_LAYERS] = (None, "tp")
    shapes = []
    fan_in = MESH_MLP_FEAT
    for i in range(MESH_MLP_LAYERS):
        shapes += [(MESH_MLP_WIDTH // MESH_TP, fan_in),
                   (MESH_MLP_WIDTH // MESH_TP,)]
        fan_in = MESH_MLP_WIDTH
    shapes += [(MESH_MLP_CLASSES, MESH_MLP_WIDTH // MESH_TP),
               (MESH_MLP_CLASSES,)]
    return specs, shapes


def mesh_phase(mx, ck, np, torch, card, workdir):
    """Phase mesh: tensor, sequence, pipeline and expert parallelism over
    ``torch.distributed`` on the card.  Groups started by the port's
    launcher (gloo ranks share cuda:0, as in phase dist):

    - two ranks: (a) every collective of ``parallel.collectives`` on
      CUDA tensors, values and gradients, with the route each takes;
      (b) BERT-base at tp=2 (the gradient gate, MESH_BERT_STEPS counted
      steps of exactly 12 launches of each bf16 flash kernel on each
      rank, the f32 model at 2 layers one step against one rank); (e)
      SPMDTrainer with param_specs, 3 steps of one K1 launch each,
      bitwise with one rank;
    - four ranks: (c) the TransformerLM over {dp 1, tp 2, sp 2} (the
      gradient gate, the dryrun's step, no flash launch, peak memory);
      (d) the dryrun's pipelined MoE step, against the one-rank
      sequential computation here;
    - one NCCL rank: (f) every new module over axes of one rank, bitwise
      the result without a mesh.

    Before the groups, phase 4b's one-rank BERT-base rate in this
    process, for (b)'s rate to stand beside."""
    from mxnet_tpu_torch.models import BERT
    t0 = time.perf_counter()
    out = {"card": card}
    cfg = bert_config(torch, torch.bfloat16)
    model = BERT(cfg).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    batch = bert_batch(np, torch, cfg.vocab_size, model.device)
    _bert_steps(np, torch, model, batch,
                lambda: example_sgd_step(params, BERT_LR), 1)
    t1 = time.perf_counter()
    _bert_steps(np, torch, model, batch,
                lambda: example_sgd_step(params, BERT_LR), MESH_BERT_STEPS)
    out["bert_one_rank_sequences_per_s"] = \
        BERT_B * MESH_BERT_STEPS / (time.perf_counter() - t1)
    del model, params
    torch.cuda.empty_cache()
    for suite, n in (("two", 2), ("four", 4), ("nccl", 1)):
        for r in range(n):
            stale = os.path.join(workdir, "mesh_%s_rank%d.json" % (suite, r))
            if os.path.exists(stale):
                os.remove(stale)
        t1 = time.perf_counter()
        rc, so, se = _run_group(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
             sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--mesh-worker", workdir, "--mesh-suite", suite],
            MESH_WORKER_TIMEOUT_S)
        if rc != 0:
            raise AssertionError("phase mesh, %d-rank group %r failed (rc "
                                 "%d):\n%s\n%s" % (n, suite, rc, so[-4000:],
                                                   se[-8000:]))
        ranks = []
        for r in range(n):
            with open(os.path.join(workdir, "mesh_%s_rank%d.json"
                                   % (suite, r))) as f:
                ranks.append(json.load(f))
        backends = [line for line in se.splitlines()
                    if "mxnet_tpu_torch.parallel: rank" in line]
        want = "backend nccl" if suite == "nccl" else "backend gloo"
        assert len(backends) == n and all(want in b for b in backends), \
            backends
        out[suite] = {"seconds": time.perf_counter() - t1, "ranks": ranks,
                      "backend_lines": backends}
        _log("[mesh] %s %s" % (suite, json.dumps(out[suite])))
    out["bert_tp_sequences_per_s"] = out["two"]["ranks"][0]["bert"][
        "sequences_per_s"]
    out["bert_rate_is"] = (
        "two processes time-share one card and gloo stages their CUDA "
        "all-reduces through host memory, so the tp=2 rate is no scaling "
        "figure: it only shows the path runs")
    _log("[mesh-bert] %.1f sequences/s at tp=2 (two ranks sharing the "
         "card; no scaling figure), %.1f on one rank (B=%d S=%d, %d "
         "layers, bfloat16)" % (out["bert_tp_sequences_per_s"],
                                out["bert_one_rank_sequences_per_s"],
                                BERT_B, BERT_S, cfg.num_layers))
    out["ppmoe_vs_one_rank"] = _mesh_ppmoe_check(mx, np, torch, workdir)
    out["seconds"] = time.perf_counter() - t0
    return out


def _mesh_launches(mesh):
    """The kernels' launches in phase mesh's counted runs, by rank:
    {kernel: {path: count}}."""
    by = {}
    for r, rank in enumerate(mesh["two"]["ranks"]):
        for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            by.setdefault(key, {})["mesh_bert_tp2_rank%d" % r] = \
                rank["bert"]["launches"][key]
        for key in ("flash_fwd_f32", "flash_bwd_dq_f32",
                    "flash_bwd_dkv_f32"):
            by.setdefault(key, {})["mesh_bert_f32_tp2_rank%d" % r] = \
                rank["bert"]["f32"]["launches"][key]
        by.setdefault("sgd_step", {})["mesh_spmd_tp2_rank%d" % r] = \
            rank["mlp"]["launches"]["sgd_step"]
    return by


def _mesh_ppmoe_inputs(np):
    """The dryrun's pipelined MoE parameters (``np.random.RandomState(1)``
    in its draw order), inputs and targets."""
    n_pp, d, h = (MESH_PPMOE_AXES["pp"], MESH_PPMOE_D, MESH_PPMOE_H)
    e = MESH_PPMOE_ELOC * MESH_PPMOE_AXES["ep"]
    rng = np.random.RandomState(1)
    p = {"gate": rng.normal(0, 0.5, (n_pp, d, e)),
         "w1": rng.normal(0, 0.5, (n_pp, e, d, h)),
         "b1": np.zeros((n_pp, e, h)),
         "w2": rng.normal(0, 0.5, (n_pp, e, h, d)),
         "b2": np.zeros((n_pp, e, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(MESH_PPMOE_B, d)).astype(np.float32)
    t = rng.normal(size=(MESH_PPMOE_B, d)).astype(np.float32)
    return p, x, t


def _mesh_ppmoe_check(mx, np, torch, workdir):
    """(d) against the one-rank sequential computation on the card: each
    microbatch through both stages in turn, each stage's MoE with all
    its experts on one rank (the same routing: the ep ranks route the
    same tokens), the loss the mean over every microbatch, the same SGD
    step."""
    from mxnet_tpu_torch.parallel import microbatch, moe_ffn
    p, x, t = _mesh_ppmoe_inputs(np)
    mesh = mx.parallel.make_mesh({"ep": 1}, [torch.device(MESH_DEVICE)])
    params = {k: torch.tensor(v, device=MESH_DEVICE, requires_grad=True)
              for k, v in p.items()}
    xm = microbatch(torch.as_tensor(x, device=MESH_DEVICE), MESH_PPMOE_M)
    tm = microbatch(torch.as_tensor(t, device=MESH_DEVICE), MESH_PPMOE_M)
    ys = []
    for m in range(MESH_PPMOE_M):
        act = xm[m]
        for s in range(MESH_PPMOE_AXES["pp"]):
            y, _aux = moe_ffn(*(params[k][s] for k in ("gate", "w1", "b1",
                                                       "w2", "b2")),
                              act, axis_name="ep", k=1, capacity_factor=4.0,
                              mesh=mesh)
            act = act + y
        ys.append(act)
    loss = torch.mean((torch.stack(ys) - tm) ** 2)
    loss.backward()
    got = np.load(os.path.join(workdir, "mesh_ppmoe.npz"))
    out = {"loss_mesh": float(got["loss"]), "loss_one_rank": float(loss),
           "loss_rtol": MESH_PPMOE_LOSS_RTOL, "rtol": MESH_PPMOE_RTOL,
           "atol": MESH_PPMOE_ATOL, "params_max_abs": {}}
    np.testing.assert_allclose(out["loss_mesh"], out["loss_one_rank"],
                               rtol=MESH_PPMOE_LOSS_RTOL)
    with torch.no_grad():
        for k, v in params.items():
            want = (v - MESH_PPMOE_LR * v.grad).cpu().numpy()
            np.testing.assert_allclose(got["after/" + k], want,
                                       rtol=MESH_PPMOE_RTOL,
                                       atol=MESH_PPMOE_ATOL, err_msg=k)
            out["params_max_abs"][k] = float(np.abs(got["after/" + k]
                                                    - want).max())
    _log("[mesh-ppmoe] one rank %s" % json.dumps(out))
    return out


# --- the ranks of phase mesh (``--mesh-worker``)
def _ck():
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    return ck


def mesh_worker(workdir, suite):
    """One rank of phase mesh's ``suite`` group, on cuda:0; writes
    ``mesh_<suite>_rank<r>.json``."""
    import mxnet_tpu_torch as mx
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    with (mx.gpu() if MESH_DEVICE == "cuda" else mx.cpu()):
        mx.parallel.initialize()
        rank = mx.parallel.dist.rank()
        out = {"rank": rank, "device": str(mx.parallel.dist.device())}
        for part in {"two": (_mesh_probe, _mesh_bert, _mesh_mlp),
                     "four": (_mesh_lm, _mesh_ppmoe),
                     "nccl": (_mesh_one_rank,)}[suite]:
            out[part.__name__[len("_mesh_"):]] = part(mx, torch, workdir)
        mx.parallel.barrier()
    with open(os.path.join(workdir, "mesh_%s_rank%d.json" % (suite, rank)),
              "w") as f:
        json.dump(out, f)
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


def _mesh_probe(mx, torch, workdir):
    """(a) Every collective the new modules use, on CUDA tensors over two
    gloo ranks, values and gradients held; the route each takes (the
    telemetry counters ``collectives.<op>.<route>``)."""
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.parallel import collectives as coll
    tt.reset()
    mesh = mx.parallel.make_mesh({"tp": 2})
    r = mesh.axis_index("tp")
    dev = mesh.device
    x = torch.arange(8.0, device=dev) + 100 * r
    x.requires_grad_(True)
    # ppermute (batch_isend_irecv): rank r gets rank r-1's; its backward
    # sends the cotangent back
    y = coll.ppermute(x, mesh, "tp", 1)
    assert torch.equal(y.detach(), torch.arange(8.0, device=dev)
                       + 100 * (1 - r))
    (y * (r + 1)).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0 - r))
    # all_to_all (all_to_all_single): block j to rank j; its own transpose
    a = (torch.arange(8.0, device=dev) + 100 * r).reshape(2, 4)
    a.requires_grad_(True)
    b = coll.all_to_all(a, mesh, "tp")
    want = torch.stack([torch.arange(4.0, device=dev) + 4 * r,
                        torch.arange(4.0, device=dev) + 4 * r + 100])
    assert torch.equal(b.detach(), want)
    (b * (r + 1)).sum().backward()
    assert torch.equal(a.grad, torch.tensor([[1.0] * 4, [2.0] * 4],
                                            device=dev))
    # psum / copy_to (all_reduce) forward and backward
    s = torch.full((4,), r + 1.0, device=dev, requires_grad=True)
    total = coll.psum(s, mesh, "tp")
    assert torch.equal(total.detach(), torch.full_like(total, 3.0))
    c = torch.ones(4, device=dev, requires_grad=True)
    (coll.copy_to(c, mesh, "tp") * (r + 1)).sum().backward()
    assert torch.equal(c.grad, torch.full_like(c, 3.0))
    # broadcast_last (the pipeline's masked psum), shard / unshard
    # (all_gather)
    last = coll.broadcast_last(s, mesh, "tp")
    assert torch.equal(last.detach(), torch.full_like(last, 2.0))
    whole = torch.arange(12.0, device=dev).reshape(3, 4)
    blk = coll.shard(whole, mesh, (None, "tp"))
    assert torch.equal(blk, whole[:, 2 * r:2 * r + 2])
    assert torch.equal(coll.unshard(blk, mesh, (None, "tp")), whole)
    torch.cuda.synchronize()
    counters = tt.snapshot()["counters"]
    routes = {k[len("collectives."):]: v for k, v in counters.items()
              if k.startswith("collectives.")}
    want_routes = {"ppermute": "host" if dev.type == "cuda" else "native",
                   "all_to_all": "native", "all_reduce": "native",
                   "all_gather": "native"}
    for op, route in want_routes.items():
        assert routes.get("%s.%s" % (op, route), 0) > 0, (op, routes)
        assert coll.route(op, x) == route, op
    _log("[mesh-probe] rank %d routes %s" % (mesh.rank, json.dumps(routes)))
    return {"routes": want_routes, "calls": routes,
            "gloo_cuda_native": sorted(coll.GLOO_CUDA_NATIVE)}


def _mesh_grad_gate(mx, torch, whole, make_plain, make32, loss_of, floor):
    """Per tensor, the mesh path's gathered gradients ``whole`` against a
    one-rank f32 model's, beside the one-rank plain bf16 path's error:
    at most KERNEL_VS_PLAIN_GRAD_ERR x the latter, floored at
    ``floor``."""
    plain = make_plain()
    plain.requires_grad_(True)
    loss_off, off = _train_grads(mx, plain, loss_of, False)
    model32 = make32()
    model32.load_state_dict(plain.state_dict())
    model32.requires_grad_(True)
    del plain
    loss32, ref = _train_grads(mx, model32, loss_of, False)
    del model32
    out = {"loss_plain": loss_off, "loss_f32": loss32, "floor": floor,
           "tensors": {}}
    for name, r in ref.items():
        norm = float(r.norm())
        e_mesh = float((whole[name].float() - r).norm()) / norm
        e_off = float((off[name] - r).norm()) / norm
        out["tensors"][name] = {"mesh_vs_f32": e_mesh,
                                "plain_vs_f32": e_off}
        assert e_mesh <= KERNEL_VS_PLAIN_GRAD_ERR * max(e_off, floor), (
            name, e_mesh, e_off)
    torch.cuda.empty_cache()
    return out


def _gathered_grads(model, mesh):
    from mxnet_tpu_torch.parallel import collectives as coll
    specs = model.flat_specs()
    return {n: coll.unshard(p.grad.float(), mesh, specs.get(n, ()))
            for n, p in model.named_parameters()}


def _mesh_bert(mx, torch, workdir):
    """(b) BERT-base at tp=2: the gradient gate at the initial weights
    (rank 0 computes the one-rank references while rank 1 waits), then
    MESH_BERT_STEPS counted steps (counts zeroed just before, read just
    after: 12 launches of each bf16 flash kernel a step at 6 local heads
    and nothing else; finite losses, the last below the first), then the
    f32 model at 2 layers: one step, through the f32 flash kernels, its
    weights against one rank's."""
    import numpy as np
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models import BERT
    from mxnet_tpu_torch.parallel import collectives as coll
    ck = _ck()
    mesh = mx.parallel.make_mesh({"dp": 1, "tp": MESH_TP})
    cfg = bert_config(torch, torch.bfloat16)
    L = cfg.num_layers
    model = BERT(cfg, mesh=mesh).init(SEED)
    model.requires_grad_(True)
    local_heads = int(model.layers.wqkv.shape[-2])
    assert local_heads == cfg.num_heads // MESH_TP, local_heads
    params = [p for _, p in model.named_parameters()]
    batch = bert_batch(np, torch, cfg.vocab_size, model.device)

    def loss_of(m):
        return m.pretrain_loss(*(batch[k] for k in BERT_ARGS))

    model.zero_grad(set_to_none=True)
    loss_of(model).backward()
    model.allreduce_grads()
    whole = _gathered_grads(model, mesh)
    out = {"local_heads": local_heads, "mesh": dict(mesh.shape)}
    if mesh.rank == 0:
        out["grad_accuracy"] = _mesh_grad_gate(
            mx, torch, whole, lambda: BERT(cfg).init(SEED),
            lambda: BERT(bert_config(torch, torch.float32)), loss_of,
            BERT_GRAD_FLOOR)
    del whole
    model.zero_grad(set_to_none=True)
    mx.parallel.barrier()

    def sgd():
        model.allreduce_grads()
        example_sgd_step(params, BERT_LR)

    _bert_steps(np, torch, model, batch, sgd, 1)
    _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    losses, step_ms = _bert_steps(np, torch, model, batch, sgd,
                                  MESH_BERT_STEPS)
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    n = MESH_BERT_STEPS
    assert launches == _want_launches(ck, flash_fwd=L * n,
                                      flash_bwd_dq=L * n,
                                      flash_bwd_dkv=L * n), launches
    assert losses[-1] < losses[0], losses
    out.update({"steps": n, "losses": losses, "step_ms": step_ms,
                "median_step_ms": float(np.median(step_ms)),
                "sequences_per_s": BERT_B * n / wall, "launches": launches})
    del model, params
    torch.cuda.empty_cache()
    # the f32 model at 2 layers, one step, against one rank
    cfg32 = bert_config(torch, torch.float32)
    cfg32.num_layers = MESH_BERT32_LAYERS
    model = BERT(cfg32, mesh=mesh).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    _zero_counts(torch, tt, ck)
    model.zero_grad(set_to_none=True)
    loss_of(model).backward()
    sgd()
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    n32 = MESH_BERT32_LAYERS
    assert launches == _want_launches(ck, flash_fwd_f32=n32,
                                      flash_bwd_dq_f32=n32,
                                      flash_bwd_dkv_f32=n32), launches
    specs = model.flat_specs()
    with torch.no_grad():
        after = {n_: coll.unshard(p, mesh, specs.get(n_, ()))
                 for n_, p in model.named_parameters()}
    out["f32"] = {"layers": n32, "launches": launches}
    if mesh.rank == 0:
        one = BERT(cfg32).init(SEED)
        one.requires_grad_(True)
        one_params = [p for _, p in one.named_parameters()]
        loss_of(one).backward()
        example_sgd_step(one_params, BERT_LR)
        worst = {}
        for n_, p in one.named_parameters():
            diff = (after[n_] - p).abs()
            excess = diff - (MESH_F32_ATOL + MESH_F32_RTOL * p.abs())
            worst[n_] = float(diff.max())
            assert float(excess.max()) <= 0.0, (n_, worst[n_])
        out["f32"].update({"weights_max_abs_vs_one_rank": worst,
                           "rtol": MESH_F32_RTOL, "atol": MESH_F32_ATOL})
        del one, one_params
    del model, params, after
    torch.cuda.empty_cache()
    mx.parallel.barrier()
    _log("[mesh-bert] rank %d %s" % (mesh.rank, json.dumps(
        {k: v for k, v in out.items() if k != "grad_accuracy"})))
    return out


def _mesh_mlp_net(mx):
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    nn = mx.gluon.nn
    with mx.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            for _ in range(MESH_MLP_LAYERS):
                net.add(nn.Dense(MESH_MLP_WIDTH, activation="relu"))
            net.add(nn.Dense(MESH_MLP_CLASSES))
    mx.random.seed(SEED)
    net.initialize(mx.init.Xavier())
    return net


def _mesh_mlp(mx, torch, workdir):
    """(e) SPMDTrainer with param_specs over {dp 1, tp 2}: after one
    step that materializes the trainer, MESH_MLP_STEPS steps of one K1
    launch each over this rank's blocks (counts zeroed just before, read
    just after), bitwise with a one-rank trainer from the same weights
    (losses and every weight, gathered)."""
    import numpy as np
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.parallel import SPMDTrainer
    ck = _ck()
    rng = np.random.RandomState(SEED)
    # one step to materialize the trainer, then MESH_MLP_STEPS counted
    data = [rng.normal(size=(MESH_MLP_BATCH, MESH_MLP_FEAT))
            .astype(np.float32) for _ in range(MESH_MLP_STEPS + 1)]
    labels = [rng.randint(0, MESH_MLP_CLASSES, (MESH_MLP_BATCH,))
              .astype(np.float32) for _ in range(MESH_MLP_STEPS + 1)]
    specs, shapes = mesh_mlp_specs()
    mesh = mx.parallel.make_mesh({"dp": 1, "tp": MESH_TP})
    runs = {}
    for kind, m in (("tp", mesh), ("one_rank", mx.parallel.make_mesh(
            {"dp": 1}, [mesh.device]))):
        net = _mesh_mlp_net(mx)
        net(mx.nd.array(data[0]))      # the deferred shapes
        sp = {net.prefix + k: v for k, v in specs.items()} \
            if kind == "tp" else None
        tr = SPMDTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                         mesh=m, param_specs=sp)
        tr.step(data[0], labels[0])    # materialize; not counted
        _zero_counts(torch, tt, ck)
        losses = [tr.step(x, y) for x, y in zip(data[1:], labels[1:])]
        torch.cuda.synchronize()
        runs[kind] = {"launches": dict(ck.LAUNCHES), "losses": losses,
                      "whole": {n: tr._full(n) for n in tr.params},
                      "shapes": [tuple(tr.params[n].shape)
                                 for n in tr.fn.trainable]}
    tp, one = runs["tp"], runs["one_rank"]
    steps = MESH_MLP_STEPS
    assert tp["launches"] == _want_launches(ck, sgd_step=steps), \
        tp["launches"]
    assert tp["shapes"] == shapes, tp["shapes"]
    differing = sum(_differing(torch, tp["whole"][n], one["whole"][n])
                    for n in tp["whole"])
    differing += sum(_differing(torch, a, b)
                     for a, b in zip(tp["losses"], one["losses"]))
    assert differing == 0, differing
    return {"launches": tp["launches"], "counted_steps": steps,
            "losses": [float(v) for v in tp["losses"]],
            "shard_shapes": tp["shapes"],
            "differing_vs_one_rank": differing}


def _mesh_lm(mx, torch, workdir):
    """(c) The TransformerLM at its default width over {dp 1, tp 2, sp 2}
    at B=2 S=1024: the loss and gradients at the initial weights (counts
    zeroed just before, read just after: no kernel launched, the ring is
    plain), each rank's peak memory, the gradient gate (rank 0 against
    one rank), and the dryrun's momentum SGD step."""
    import numpy as np
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.transformer import TransformerLM
    ck = _ck()
    mesh = mx.parallel.make_mesh(MESH_LM_AXES)
    cfg = mesh_lm_config(torch)
    model = TransformerLM(cfg, mesh=mesh).init(SEED)
    model.requires_grad_(True)
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, cfg.vocab_size, (MESH_LM_B, MESH_LM_S + 1))
    inp = torch.as_tensor(toks[:, :-1], device=mesh.device)
    tgt = torch.as_tensor(toks[:, 1:], device=mesh.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    model.zero_grad(set_to_none=True)
    loss = model.loss(inp, tgt)
    loss.backward()
    model.allreduce_grads()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck), launches
    peak = torch.cuda.max_memory_allocated()
    out = {"mesh": dict(mesh.shape), "batch": [MESH_LM_B, MESH_LM_S],
           "loss": float(loss.detach()), "launches": launches,
           "peak_bytes": peak, "forward_backward_s": step_s,
           "routes": {k: v for k, v in tt.snapshot()["counters"].items()
                      if k.startswith("collectives.")}}
    assert np.isfinite(out["loss"]), out["loss"]
    whole = _gathered_grads(model, mesh)
    if mesh.rank == 0:
        out["grad_accuracy"] = _mesh_grad_gate(
            mx, torch, whole, lambda: TransformerLM(cfg).init(SEED),
            lambda: TransformerLM(mesh_lm_config(torch, torch.float32)),
            lambda m: m.loss(inp, tgt), BERT_GRAD_FLOOR)
    del whole
    mx.parallel.barrier()
    with torch.no_grad():
        # __graft_entry__.py:122-128, from a zero momentum
        for p in model.parameters():
            mom = MESH_LM_MOMENTUM * torch.zeros_like(p) + p.grad.to(p.dtype)
            p.copy_(p - torch.tensor(MESH_LM_LR, dtype=p.dtype,
                                     device=p.device) * mom)
    model.zero_grad(set_to_none=True)
    after = float(model.loss(inp, tgt).detach())
    assert np.isfinite(after), after
    out["loss_after_step"] = after
    del model
    torch.cuda.empty_cache()
    _log("[mesh-lm] rank %d %s" % (mesh.rank, json.dumps(
        {k: v for k, v in out.items() if k != "grad_accuracy"})))
    return out


def _mesh_ppmoe(mx, torch, workdir):
    """(d) The dryrun's pipelined MoE step over {dp 1, pp 2, ep 2}: the
    loss and the parameters after the SGD step (rank 0 writes them for
    the one-rank comparison)."""
    import numpy as np
    from mxnet_tpu_torch.parallel import collectives as coll
    from mxnet_tpu_torch.parallel import microbatch, moe_ffn, pipeline_apply
    mesh = mx.parallel.make_mesh(MESH_PPMOE_AXES)
    p, x, t = _mesh_ppmoe_inputs(np)
    dev = mesh.device
    params = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in p.items()}
    # the gate is every (dp, ep) rank's, an expert every dp rank's: their
    # gradients sum over the ranks that use them
    mine = {k: coll.shard(v, mesh, MESH_PPMOE_SPECS[k],
                          sum_axes=("dp", "ep"))[0]
            for k, v in params.items()}
    xm = coll.shard(microbatch(torch.as_tensor(x, device=dev), MESH_PPMOE_M),
                    mesh, (None, "dp"))
    tm = coll.shard(microbatch(torch.as_tensor(t, device=dev), MESH_PPMOE_M),
                    mesh, (None, "dp"))

    def stage(sp, act):
        y, _aux = moe_ffn(sp["gate"], sp["w1"], sp["b1"], sp["w2"],
                          sp["b2"], act, axis_name="ep", k=1,
                          capacity_factor=4.0, mesh=mesh)
        return act + y

    y = pipeline_apply(stage, mine, xm, axis_name="pp",
                       vary_axes=("dp", "pp", "ep"), mesh=mesh)
    loss = coll.pmean(torch.mean((y - tm) ** 2), mesh, ("dp", "ep"))
    loss.backward()
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach())}
    assert np.isfinite(out["loss"]), out
    if mesh.rank == 0:
        with torch.no_grad():
            np.savez(os.path.join(workdir, "mesh_ppmoe.npz"),
                     loss=np.float32(out["loss"]),
                     **{"after/" + k: (v - MESH_PPMOE_LR * v.grad).cpu()
                        .numpy() for k, v in params.items()})
    return out


def _mesh_one_rank(mx, torch, workdir):
    """(f) On one NCCL rank, every new module over a mesh whose axes all
    have one rank, bitwise the result without a mesh: the TransformerLM
    and BERT (loss and gradients, bf16 through the flash kernels), ring
    attention (f32), the pipeline (against its stage per microbatch),
    the MoE wrapper (against ``moe_ffn`` on the whole arrays) and
    SPMDTrainer with param_specs (against none)."""
    import torch.distributed as tdist
    from mxnet_tpu_torch.models import BERT
    from mxnet_tpu_torch.models.transformer import TransformerLM
    from mxnet_tpu_torch.parallel import (attention, microbatch, moe_ffn,
                                          moe_ffn_sharded, pipeline_sharded,
                                          ring_self_attention_sharded)
    import numpy as np
    assert tdist.get_world_size() == 1
    assert mx.parallel.dist.backend() == (
        "nccl" if MESH_DEVICE == "cuda" else "gloo")
    dev = torch.device(MESH_DEVICE)
    ones = mx.parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1, "pp": 1,
                                  "ep": 1})
    differing = {}

    def same(name, a, b):
        differing[name] = differing.get(name, 0) + _differing(
            torch, a.detach().contiguous(), b.detach().contiguous())

    def grads_of(make, loss_of):
        res = []
        for mesh in (None, ones):
            m = make(mesh)
            m.requires_grad_(True)
            loss = loss_of(m)
            loss.backward()
            res.append((loss, {n: p.grad for n, p in m.named_parameters()}))
        return res

    rng = np.random.default_rng(SEED)
    cfg = mesh_lm_config(torch)
    cfg.num_layers = 2
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, min(256, cfg.max_len) + 1)), device=dev)
    (la, ga), (lb, gb) = grads_of(
        lambda mesh: TransformerLM(cfg, mesh=mesh).init(SEED),
        lambda m: m.loss(toks[:, :-1], toks[:, 1:]))
    same("transformer_lm", la, lb)
    for n in ga:
        same("transformer_lm", ga[n], gb[n])
    bcfg = bert_config(torch, torch.bfloat16)
    bcfg.num_layers = 2
    batch = bert_batch(np, torch, bcfg.vocab_size, dev)
    (la, ga), (lb, gb) = grads_of(
        lambda mesh: BERT(bcfg, mesh=mesh).init(SEED),
        lambda m: m.pretrain_loss(*(batch[k] for k in BERT_ARGS)))
    same("bert", la, lb)
    for n in ga:
        same("bert", ga[n], gb[n])
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(2, 4, 256, 64, device=dev, generator=g)
               for _ in range(3))
    for causal in (True, False):
        same("ring_attention", attention(q, k, v, causal=causal),
             ring_self_attention_sharded(ones, q, k, v, causal=causal))
    w = torch.randn(1, 64, 64, device=dev, generator=g) * 0.1
    b = torch.randn(1, 64, device=dev, generator=g) * 0.1
    x = torch.randn(32, 64, device=dev, generator=g)

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])
    piped = pipeline_sharded(ones, stage, {"w": w, "b": b}, x, 4)
    plain = torch.cat([stage({"w": w[0], "b": b[0]}, xm)
                       for xm in microbatch(x, 4)])
    same("pipeline", piped, plain)
    gw = torch.randn(64, 4, device=dev, generator=g)
    w1 = torch.randn(4, 64, 128, device=dev, generator=g) * 0.1
    b1 = torch.zeros(4, 128, device=dev)
    w2 = torch.randn(4, 128, 64, device=dev, generator=g) * 0.1
    b2 = torch.zeros(4, 64, device=dev)
    ys, auxs = moe_ffn_sharded(ones, gw, w1, b1, w2, b2, x)
    yp, auxp = moe_ffn(gw, w1, b1, w2, b2, x, mesh=ones)
    same("moe", ys, yp)
    same("moe", auxs, auxp)
    from mxnet_tpu_torch.parallel import SPMDTrainer
    specs, _ = mesh_mlp_specs()
    data = torch.randn(MESH_MLP_BATCH, MESH_MLP_FEAT, device=dev,
                       generator=g)
    label = torch.randint(0, MESH_MLP_CLASSES, (MESH_MLP_BATCH,),
                          device=dev, generator=g).float()
    whole = []
    for sp in (None, specs):
        net = _mesh_mlp_net(mx)
        net(mx.nd.array(data.cpu().numpy()))
        tr = SPMDTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9}, mesh=ones,
                         param_specs=None if sp is None else {
                             net.prefix + n: s for n, s in sp.items()})
        for _ in range(2):
            tr.step(data, label)
        whole.append([tr._full(n) for n in tr.fn.trainable])
    for a, b in zip(*whole):
        same("spmd_param_specs", a, b)
    torch.cuda.synchronize()
    assert not any(differing.values()), differing
    return {"differing": differing}


# ------------------------------------------------------------ phase shard
#: how long phase shard's group may take, start-up included
SHARD_WORKER_TIMEOUT_S = 900
#: where phase shard's ranks run (the card; "cpu" only to rehearse it)
SHARD_DEVICE = "cuda"
SHARD_RANKS = 2
#: (a) bench.py one_config's ResNet-50 over two ranks of RESNET_BATCH / 2
#: rows with synchronised BatchNorm: the global-batch gradients at the
#: initial weights against the one-rank BS 128 run's (per tensor whose
#: f32 gradient norm is at least 1% of the largest, at most
#: KERNEL_VS_PLAIN_GRAD_ERR x the one-rank bf16 path's error against an
#: f32 copy, floored at one bf16 ulp, BERT_GRAD_FLOOR; the loss within
#: RESNET_BF16_LOSS_RTOL of the f32 copy's), the moving statistics after
#: one step against the one-rank run's (each tensor within
#: RESNET_BF16_LOSS_RTOL of its largest value) and bitwise alike on both
#: ranks; then SHARD_RESNET_STEPS counted steps of one K1 launch each a
#: rank, beside SHARD_RESNET_TIMED one-rank steps timed on rank 0 while
#: rank 1 waits; then f32 at global BS SHARD_F32_BATCH: the weights after
#: SHARD_F32_STEPS steps against the one-rank run's, per tensor relative
#: to its largest value (floored at 1% of the largest tensor's), at most
#: SHARD_F32_RTOL or KERNEL_VS_PLAIN_ERR x the most the one-rank run
#: itself moves when its batch's rows are only permuted (the same sums in
#: another order).  On the H100 the two-rank run differed by 3.8e-2 after
#: 3 steps (conv0's weight): ResNet-50 at initialization amplifies
#: rounding through its BatchNorm backward passes, so 1e-4 alone holds
#: no run that sums in another order.
SHARD_RESNET_STEPS = 10
SHARD_RESNET_TIMED = 3
SHARD_F32_BATCH = 16
SHARD_F32_STEPS = 3
SHARD_F32_RTOL = 1e-4
#: (b) the serve phase's TransformerLM (TransformerLMConfig() bf16,
#: init(SEED)) at tp=2: its N_REQUESTS prompts prefilled in one batch and
#: SHARD_DECODE_STEPS decode steps fed the one-rank run's tokens (teacher
#: forcing), bf16 pages and int8 pages; each step's logits within
#: ROW_REL_TOL of each row's largest |one-rank logit|
SHARD_TP = 2
SHARD_DECODE_STEPS = 16
#: (c) BERT-base at examples/bert_pretrain.py's defaults over sp=2: the
#: gradient gate of phase 4b at the initial weights, then
#: SHARD_BERT_STEPS finite steps
SHARD_SP = 2
SHARD_BERT_STEPS = 5
#: (d) placement: a ctx_group graph and a Gluon Dense stack on gpu(0) and
#: cpu() against one GPU context, within SHARD_PLACE_ATOL
SHARD_PLACE_ATOL = 1e-6
SHARD_PLACE_STEPS = 3
SHARD_PLACE_BATCH, SHARD_PLACE_WIDTH = 64, 256


def shard_kernel_cases(np):
    """The per-rank shapes of (b)'s kernels: K2f over the prefill of the
    N_REQUESTS prompts padded to the longest, at 6 local heads; K4 over
    their decode at that table's width."""
    s = max(len(p) for p in _prompts(np, 32000))
    width = -(-(s + SHARD_DECODE_STEPS) // PAGE_SIZE)
    heads = 12 // SHARD_TP
    return (((N_REQUESTS, heads, True, s, s, 64),),
            ((N_REQUESTS, heads, width, PAGE_SIZE, 64),))


def shard_phase(mx, ck, np, torch, card, workdir):
    """Phase shard: BatchNorm over the ranks, sharded serving, BERT over
    sp and several contexts on the card.  One group of SHARD_RANKS gloo
    ranks sharing cuda:0 (phase dist's launcher), each running
    ``chip_smoke.py --shard-worker WORKDIR``: (a) ResNet-50 data-parallel
    with synchronised BatchNorm, (b) the TransformerLM served at tp=2,
    (c) BERT-base over sp=2.  Then (d), placement, in this process."""
    t0 = time.perf_counter()
    out = {"card": card}
    for r in range(SHARD_RANKS):
        for name in ("shard_rank%d.json" % r, "shard_aux_rank%d.npz" % r):
            stale = os.path.join(workdir, name)
            if os.path.exists(stale):
                os.remove(stale)
    rc, so, se = _run_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
         str(SHARD_RANKS), sys.executable,
         os.path.join(ROOT, "chip_smoke.py"), "--shard-worker", workdir],
        SHARD_WORKER_TIMEOUT_S)
    if rc != 0:
        raise AssertionError("phase shard's group failed (rc %d):\n%s\n%s"
                             % (rc, so[-4000:], se[-8000:]))
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(workdir, "shard_rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    backends = [line for line in se.splitlines()
                if "mxnet_tpu_torch.parallel: rank" in line]
    assert len(backends) == SHARD_RANKS and all(
        "backend gloo" in b for b in backends), backends
    # the moving statistics, after one step and after the counted steps,
    # bit for bit alike on every rank
    aux = [dict(np.load(os.path.join(workdir, "shard_aux_rank%d.npz" % r)))
           for r in range(SHARD_RANKS)]
    differing = {k: int(sum(int((a[k] != aux[0][k]).sum()) for a in aux))
                 for k in aux[0]}
    assert differing and not any(differing.values()), differing
    out.update({"ranks": ranks, "backend_lines": backends,
                "aux_tensors_compared": len(differing),
                "aux_differing_elements": sum(differing.values()),
                "group_seconds": time.perf_counter() - t0})
    res = ranks[0]["resnet"]
    _log("[shard-resnet] %.1f img/s over %d ranks sharing the card (no "
         "scaling figure), %.1f img/s on one rank (BS %d, bfloat16)"
         % (res["img_per_s"], SHARD_RANKS, res["one_rank"]["img_per_s"],
            RESNET_BATCH))
    for kind in ("bf16", "int8"):
        srv = ranks[0]["serve"][kind]
        _log("[shard-serve] %s pages: %.3f ms a decode step at tp=%d (two "
             "ranks sharing the card), %.3f ms on one rank"
             % (kind, srv["decode_ms_per_step"], SHARD_TP,
                srv["one_rank_decode_ms_per_step"]))
    out["rates_are"] = (
        "two processes time-share one card and gloo stages their CUDA "
        "collectives through host memory, so no figure of this phase is a "
        "scaling figure: it only shows the path runs")
    out["placement"] = _shard_placement(mx, np, torch)
    out["seconds"] = time.perf_counter() - t0
    return out


def _shard_launches(shard):
    """The kernels' launches in phase shard's counted runs, by rank:
    {kernel: {path: count}}."""
    by = {}
    for r, rank in enumerate(shard["ranks"]):
        by.setdefault("sgd_step", {})["shard_resnet_dp2_rank%d" % r] = \
            rank["resnet"]["launches"]["sgd_step"]
        for kind, key in (("bf16", "paged_decode_pool_bf16"),
                          ("int8", "paged_decode_pool_int8")):
            srv = rank["serve"][kind]
            by.setdefault("flash_fwd", {})[
                "shard_prefill_tp2_%s_rank%d" % (kind, r)] = \
                srv["prefill_launches"]["flash_fwd"]
            by.setdefault(key, {})["shard_decode_tp2_rank%d" % r] = \
                srv["decode_launches"][key]
    return by


# --- the ranks of phase shard (``--shard-worker``)
def shard_worker(workdir):
    """One rank of phase shard's group, on cuda:0; writes
    ``shard_rank<r>.json`` and the moving statistics it holds to
    ``shard_aux_rank<r>.npz``."""
    import numpy as np
    import mxnet_tpu_torch as mx
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with (mx.gpu() if SHARD_DEVICE == "cuda" else mx.cpu()):
        mx.parallel.initialize()
        rank = mx.parallel.dist.rank()
        out = {"rank": rank, "device": str(mx.parallel.dist.device())}
        aux = {}
        for part in (_shard_resnet, _shard_serve, _shard_bert):
            t0 = time.perf_counter()
            name = part.__name__[len("_shard_"):]
            out[name] = part(mx, torch, aux)
            out[name]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            mx.parallel.barrier()
    np.savez(os.path.join(workdir, "shard_aux_rank%d.npz" % rank), **aux)
    with open(os.path.join(workdir, "shard_rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


def _shard_grads(mx, torch, tr, data, label):
    """A multi-rank trainer's loss and gradients of the global batch at
    its state: this rank's rows' share, summed over the batch ranks as
    its step sums them; nothing is updated."""
    train, aux = _state(tr)
    loss, _, grads, _, _ = tr._forward_backward(
        train, aux, {}, {}, tr._stage(data), tr._stage(label), 0, False)
    flat = torch.cat([g.reshape(-1) for g in grads])
    mx.parallel.dist.all_reduce_(flat, group=tr._batch_group())
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return float(loss), out


def _rel_norm_errs(got, want, floor_share=1e-2):
    """Per tensor ||got - want|| / ||want||, each norm floored at
    ``floor_share`` of the largest (a conv bias before a BatchNorm has a
    gradient of exactly 0)."""
    floor = floor_share * max(float(w.norm()) for w in want)
    return [float((a.float() - b.float()).norm())
            / max(float(b.norm()), floor) for a, b in zip(got, want)]


def _shard_resnet(mx, torch, aux_out):
    """(a): ResNet-50 over the ranks with synchronised BatchNorm (see
    SHARD_RESNET_STEPS)."""
    import numpy as np
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ck = _ck()
    torch.backends.cudnn.benchmark = True
    dev = mx.parallel.dist.device()
    ctx = mx.gpu(0) if dev.type == "cuda" else mx.cpu()
    rng = np.random.RandomState(SEED)
    shape = (RESNET_BATCH, 3, RESNET_HW, RESNET_HW)
    data = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(
        dev)
    label = torch.from_numpy(rng.randint(0, 1000, (RESNET_BATCH,))
                             .astype(np.float32)).to(dev)
    mx.random.seed(SEED)
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.array(data[:2], ctx=ctx))      # resolve the deferred shapes
    ranks = mx.parallel.make_mesh({"dp": SHARD_RANKS})
    one = mx.parallel.make_mesh({"dp": 1}, [dev])
    rank = ranks.rank
    tr = _resnet_trainer(mx, net, "bfloat16", mesh=ranks)
    tr._materialize(data)
    out = {"mesh": dict(ranks.shape), "rows_per_rank": RESNET_BATCH
           // SHARD_RANKS, "tensors": len(tr.fn.trainable),
           "aux": len(tr.fn.aux)}
    loss2, g2 = _shard_grads(mx, torch, tr, data, label)
    torch.cuda.empty_cache()
    tr1 = None
    if rank == 0:
        tr1 = _resnet_trainer(mx, net, "bfloat16", mesh=one)
        tr1._materialize(data)
        loss1, _, g1 = tr1._loss_and_grads(*_state(tr1), data, label)
        tr32 = _resnet_trainer(mx, net, None, mesh=one)
        tr32._materialize(data)
        loss32, _, g32 = tr32._loss_and_grads(*_state(tr32), data, label)
        del tr32
        torch.cuda.empty_cache()
        e2 = _rel_norm_errs(g2, g32)
        e1 = _rel_norm_errs(g1, g32)
        e21 = _rel_norm_errs(g2, g1)
        # a tensor whose f32 gradient is below 1% of the largest norm (a
        # conv bias before a BatchNorm, whose exact gradient is 0) holds
        # rounding noise on every path: reported, not gated
        floor = 1e-2 * max(float(g.norm()) for g in g32)
        gated = [float(g.norm()) >= floor for g in g32]
        worst = sorted((a / (KERNEL_VS_PLAIN_GRAD_ERR
                             * max(b, BERT_GRAD_FLOOR)), n, a, b)
                       for a, b, n, on in zip(e2, e1, tr.fn.trainable, gated)
                       if on)[-3:]
        loss1, loss32 = float(loss1), float(loss32)
        out["grads"] = {
            "loss_two_ranks": loss2, "loss_one_rank": loss1,
            "loss_f32": loss32, "loss_rtol": RESNET_BF16_LOSS_RTOL,
            "two_vs_f32_max": max(e2), "one_vs_f32_max": max(e1),
            "two_vs_one_max": max(e21),
            "gate": "per tensor two_vs_f32 <= %g x max(one_vs_f32, %g), "
                    "for the %d of %d tensors whose f32 gradient norm is "
                    "at least 1%% of the largest" % (
                        KERNEL_VS_PLAIN_GRAD_ERR, BERT_GRAD_FLOOR,
                        sum(gated), len(gated)),
            "worst": [[n, a, b] for _, n, a, b in worst]}
        assert abs(loss2 - loss32) <= RESNET_BF16_LOSS_RTOL * abs(loss32), \
            out["grads"]
        for n, a, b, on in zip(tr.fn.trainable, e2, e1, gated):
            assert not on or a <= KERNEL_VS_PLAIN_GRAD_ERR * max(
                b, BERT_GRAD_FLOOR), (n, a, b)
        del g1, g32
    del g2
    torch.cuda.empty_cache()
    mx.parallel.barrier()
    # one step from the initial state: the moving statistics
    tr.step(data, label)
    for n in tr.fn.aux:
        aux_out["resnet_step1/" + n] = tr.params[n].detach().cpu().numpy()
    if rank == 0:
        tr1.step(data, label)
        rel = {}
        for n in tr.fn.aux:
            a, b = tr.params[n].float(), tr1.params[n].float()
            rel[n] = float((a - b).abs().max()) / float(b.abs().max())
        out["moving_stats_vs_one_rank_max_rel"] = max(rel.values())
        out["moving_stats_rtol"] = RESNET_BF16_LOSS_RTOL
        assert max(rel.values()) <= RESNET_BF16_LOSS_RTOL, sorted(
            rel.items(), key=lambda kv: kv[1])[-3:]
        # one rank's rate, on the card alone (rank 1 waits)
        _timed(np, torch, tr1, data, label, 1)
        _, one_ms = _timed(np, torch, tr1, data, label, SHARD_RESNET_TIMED)
        out["one_rank"] = dict(_rate(np, one_ms, ""), step_ms=one_ms)
    del tr1
    torch.cuda.empty_cache()
    mx.parallel.barrier()
    # --- the main path: counts zeroed just before, read just after
    _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    losses, step_ms = _timed(np, torch, tr, data, label, SHARD_RESNET_STEPS)
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck, sgd_step=SHARD_RESNET_STEPS), \
        launches
    for n in tr.fn.aux:
        aux_out["resnet_step%d/%s" % (SHARD_RESNET_STEPS + 1, n)] = \
            tr.params[n].detach().cpu().numpy()
    out.update({"steps": SHARD_RESNET_STEPS, "losses": losses,
                "step_ms": step_ms, "launches": launches,
                "img_per_s": RESNET_BATCH * SHARD_RESNET_STEPS / wall,
                "img_per_s_is": "the global batch's images a second, both "
                                "ranks sharing one card"})
    del tr
    torch.cuda.empty_cache()
    # f32 at a small global batch: the weights after a few steps against
    # one rank's
    x, y = data[:SHARD_F32_BATCH], label[:SHARD_F32_BATCH]
    tr = _resnet_trainer(mx, net, None, mesh=ranks)
    for _ in range(SHARD_F32_STEPS):
        tr.step(x, y)
    if rank == 0:
        # one rank on the batch, and on the batch with its rows permuted:
        # the same sums in another order, the run's own rounding noise
        perm = torch.from_numpy(np.random.RandomState(SEED + 1).permutation(
            SHARD_F32_BATCH)).to(dev)
        runs = []
        for xb, yb in ((x, y), (x[perm], y[perm])):
            tr1 = _resnet_trainer(mx, net, None, mesh=one)
            for _ in range(SHARD_F32_STEPS):
                tr1.step(xb, yb)
            runs.append(tr1.params)
        one_p, perm_p = runs
        # a conv bias before a BatchNorm has a gradient of exactly 0 and
        # moves by rounding noise alone: each tensor's scale is floored at
        # 1% of the largest tensor's
        floor = 1e-2 * max(float(v.detach().abs().max())
                           for v in one_p.values())

        def rel(a, b):
            a, b = a.detach().float(), b.detach().float()
            return float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    floor)
        two = {n: rel(tr.params[n], one_p[n]) for n in one_p}
        noise = {n: rel(perm_p[n], one_p[n]) for n in one_p}
        limit = max(SHARD_F32_RTOL, KERNEL_VS_PLAIN_ERR * max(
            noise.values()))
        out["f32"] = {
            "batch": SHARD_F32_BATCH, "steps": SHARD_F32_STEPS,
            "weights_max_rel_vs_one_rank": max(two.values()),
            "one_rank_permuted_max_rel": max(noise.values()),
            "worst": sorted(two.items(), key=lambda kv: kv[1])[-3:],
            "rtol": SHARD_F32_RTOL, "limit": limit}
        assert max(two.values()) <= limit, out["f32"]
        del tr1, runs, one_p, perm_p
    del tr, net
    _log("[shard-resnet] rank %d %s" % (rank, json.dumps(
        {k: v for k, v in out.items() if k != "step_ms"})))
    return out


def _serve_inputs(np, vocab):
    """(b)'s batch: the serve phase's prompts padded to the longest, their
    lengths and a page table of distinct pages wide enough for the
    decode steps."""
    prompts = _prompts(np, vocab)
    s = max(len(p) for p in prompts)
    tokens = np.zeros((len(prompts), s), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int64)
    width = -(-(s + SHARD_DECODE_STEPS) // PAGE_SIZE)
    table = np.arange(len(prompts) * width, dtype=np.int64).reshape(
        len(prompts), width)
    return tokens, lengths, table


def _serve_run(ck, torch, tt, model, tokens, lengths, table, quant,
               feed=None, count=False):
    """Prefill and SHARD_DECODE_STEPS decode steps on a fresh pool, fed
    ``feed`` (teacher forcing) or else the model's own greedy tokens.
    Returns (logits [steps + 1, B, V] f32, the tokens fed, decode ms a
    step, and with ``count`` the launches of the prefill and of the
    decode steps)."""
    kv = model.init_kv_pages(table.size, PAGE_SIZE, quantized=quant)
    if count:
        _zero_counts(torch, tt, ck)
    kv, ids, lg = model.prefill(kv, tokens, lengths, table, PAGE_SIZE,
                                return_logits=True)
    torch.cuda.synchronize()
    pre = dict(ck.LAUNCHES) if count else None
    logits = [lg.float()]
    fed = [ids if feed is None else feed[0]]
    if count:
        _zero_counts(torch, tt, ck)
    t0 = time.perf_counter()
    for s in range(SHARD_DECODE_STEPS):
        kv, ids, lg = model.decode_step(kv, fed[-1], lengths + s, table,
                                        PAGE_SIZE, return_logits=True)
        logits.append(lg.float())
        fed.append(ids if feed is None else feed[s + 1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SHARD_DECODE_STEPS
    dec = dict(ck.LAUNCHES) if count else None
    del kv
    return torch.stack(logits), torch.stack(fed), ms, pre, dec


def _shard_serve(mx, torch, aux_out):
    """(b): the serve phase's TransformerLM at tp=2 with bf16 and int8
    pages (see SHARD_DECODE_STEPS); rank 0 runs the one-rank model first
    and hands its tokens to every rank."""
    import numpy as np
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.convert import params_to_reference, shard_params
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    ck = _ck()
    dev = mx.parallel.dist.device()
    cfg = TransformerLMConfig()
    L = cfg.num_layers
    mesh = mx.parallel.make_mesh({"dp": 1, "tp": SHARD_TP})
    one = TransformerLM(cfg, device=dev).init(SEED)
    tp = TransformerLM(cfg, mesh=mesh)
    tp.load_state_dict(shard_params(params_to_reference(one.state_dict()),
                                    tp.param_specs(), mesh))
    heads = int(tp.layers.wqkv.shape[-2])
    assert heads == cfg.num_heads // SHARD_TP, heads
    tokens, lengths, table = _serve_inputs(np, cfg.vocab_size)
    out = {"mesh": dict(mesh.shape), "local_heads": heads,
           "prompts": int(len(lengths)), "padded_to": int(tokens.shape[1])}
    for kind, quant, key in (("bf16", False, "paged_decode_pool_bf16"),
                             ("int8", True, "paged_decode_pool_int8")):
        feed = torch.zeros((SHARD_DECODE_STEPS + 1, len(lengths)),
                           dtype=torch.int64, device=dev)
        base = one_ms = None
        if mesh.rank == 0:
            base, fed, one_ms, _, _ = _serve_run(
                ck, torch, tt, one, tokens, lengths, table, quant)
            feed.copy_(fed)
        mx.parallel.dist.broadcast_(feed, src=0)
        got, _, ms, pre, dec = _serve_run(
            ck, torch, tt, tp, tokens, lengths, table, quant, feed=feed,
            count=True)
        assert pre == _want_launches(ck, flash_fwd=L), pre
        assert dec == _want_launches(
            ck, **{key: L * SHARD_DECODE_STEPS}), dec
        res = {"prefill_launches": pre, "decode_launches": dec,
               "decode_steps": SHARD_DECODE_STEPS,
               "decode_ms_per_step": ms,
               "logits_sum": float(got.double().sum())}
        if mesh.rank == 0:
            scale = base.abs().amax(dim=-1)
            ratio = float(((got - base).abs().amax(dim=-1) / scale).max())
            res.update({"one_rank_decode_ms_per_step": one_ms,
                        "max_row_rel_err_vs_one_rank": ratio,
                        "row_rel_tol": ROW_REL_TOL,
                        "argmax_agree": float((got.argmax(-1)
                                               == base.argmax(-1)).float()
                                              .mean())})
            assert ratio <= ROW_REL_TOL, res
        out[kind] = res
        del got, base
        torch.cuda.empty_cache()
    del one, tp
    _log("[shard-serve] rank %d %s" % (mesh.rank, json.dumps(out)))
    return out


def _shard_bert(mx, torch, aux_out):
    """(c): BERT-base over sp=2: phase 4b's gradient gate at the initial
    weights (rank 0 computes the one-rank references while rank 1
    waits), then SHARD_BERT_STEPS finite steps, in which no kernel
    launches (the encoder's attention is ring attention)."""
    import numpy as np
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models import BERT
    ck = _ck()
    mesh = mx.parallel.make_mesh({"dp": 1, "sp": SHARD_SP})
    cfg = bert_config(torch, torch.bfloat16)
    model = BERT(cfg, mesh=mesh).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    batch = bert_batch(np, torch, cfg.vocab_size, model.device)

    def loss_of(m):
        return m.pretrain_loss(*(batch[k] for k in BERT_ARGS))

    model.zero_grad(set_to_none=True)
    loss_of(model).backward()
    model.allreduce_grads()
    whole = _gathered_grads(model, mesh)
    out = {"mesh": dict(mesh.shape), "sequence_block": BERT_S // SHARD_SP}
    if mesh.rank == 0:
        gate = _mesh_grad_gate(
            mx, torch, whole, lambda: BERT(cfg).init(SEED),
            lambda: BERT(bert_config(torch, torch.float32)), loss_of,
            BERT_GRAD_FLOOR)
        out["grad_accuracy"] = {
            "loss_plain": gate["loss_plain"], "loss_f32": gate["loss_f32"],
            "floor": gate["floor"],
            "mesh_vs_f32_max": max(t["mesh_vs_f32"]
                                   for t in gate["tensors"].values()),
            "plain_vs_f32_max": max(t["plain_vs_f32"]
                                    for t in gate["tensors"].values())}
    del whole
    model.zero_grad(set_to_none=True)
    mx.parallel.barrier()

    def sgd():
        model.allreduce_grads()
        example_sgd_step(params, BERT_LR)

    _zero_counts(torch, tt, ck)
    losses, step_ms = _bert_steps(np, torch, model, batch, sgd,
                                  SHARD_BERT_STEPS)
    launches = dict(ck.LAUNCHES)
    assert launches == _want_launches(ck), launches
    out.update({"steps": SHARD_BERT_STEPS, "losses": losses,
                "step_ms": step_ms, "launches": launches})
    del model, params
    _log("[shard-bert] rank %d %s" % (mesh.rank, json.dumps(out)))
    return out


def _staged_symbol(mx):
    """tests/test_parity_modules.py:190's two-stage graph, at (d)'s
    width: the stage1 arguments and the graph."""
    with mx.AttrScope(ctx_group="stage1"):
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data, name="fc1",
                                    num_hidden=SHARD_PLACE_WIDTH)
        act1 = mx.sym.Activation(fc1, name="relu1", act_type="relu")
    with mx.AttrScope(ctx_group="stage2"):
        fc2 = mx.sym.FullyConnected(act1, name="fc2", num_hidden=10)
        out = mx.sym.SoftmaxOutput(fc2, name="softmax")
    return set(act1.list_arguments()), out


def _placed_symbol(mx, np, sym, stage1, g2c, x, y):
    """One training forward and backward of ``sym`` bound with ``g2c``:
    every argument and gradient on its group's device; (output,
    {name: grad}) as numpy."""
    gpu = mx.gpu(0)
    ex = sym.simple_bind(gpu, group2ctx=g2c, grad_req="write",
                         data=x.shape)
    init = np.random.RandomState(1)
    ex.copy_params_from(
        {n: mx.nd.array(init.normal(0, 0.05, a.shape).astype(np.float32),
                        ctx=mx.cpu())
         for n, a in ex.arg_dict.items() if n not in ("data",
                                                      "softmax_label")})
    o = ex.forward(is_train=True, data=mx.nd.array(x, ctx=gpu),
                   softmax_label=mx.nd.array(y, ctx=gpu))[0]
    ex.backward()
    for pool in (ex.arg_dict, ex.grad_dict):
        for name, arr in pool.items():
            if name in ("data", "softmax_label"):
                continue      # the batch follows the caller
            want = g2c["stage1" if name in stage1 else "stage2"]
            assert arr._data.device == want.torch_device, (name,
                                                           arr._data.device)
    return o.asnumpy(), {n: g.asnumpy() for n, g in ex.grad_dict.items()
                         if n not in ("data", "softmax_label")}


def _shard_placement(mx, np, torch):
    """(d): a ctx_group graph with stage1 on gpu(0) and stage2 on cpu()
    (every array on its device, forward and backward within
    SHARD_PLACE_ATOL of the all-GPU run, the wrong device refused);
    Module over [gpu(0), gpu(0)] bitwise one context; a Gluon Dense stack
    on [gpu(0), cpu()] trained SHARD_PLACE_STEPS steps with
    split_and_load within SHARD_PLACE_ATOL of one GPU context on the
    whole batch."""
    gpu, cpu = mx.gpu(0), mx.cpu()
    B, D = SHARD_PLACE_BATCH, SHARD_PLACE_WIDTH
    rng = np.random.RandomState(SEED)
    x = rng.normal(size=(B, D)).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.float32)
    out = {}
    stage1, sym = _staged_symbol(mx)
    placed = _placed_symbol(mx, np, sym, stage1,
                            {"stage1": gpu, "stage2": cpu}, x, y)
    whole = _placed_symbol(mx, np, sym, stage1,
                           {"stage1": gpu, "stage2": gpu}, x, y)
    fwd = float(np.abs(placed[0] - whole[0]).max())
    bwd = max(float(np.abs(placed[1][n] - g).max())
              for n, g in whole[1].items())
    assert fwd <= SHARD_PLACE_ATOL and bwd <= SHARD_PLACE_ATOL, (fwd, bwd)
    refused = _raises(ValueError, lambda: sym.bind(
        gpu, args={"data": mx.nd.ones((B, D), ctx=gpu),
                   "fc1_weight": mx.nd.ones((D, D), ctx=cpu)},
        group2ctx={"stage1": gpu, "stage2": cpu}, grad_req="null"))
    assert refused
    out["symbol"] = {"forward_max_abs_vs_gpu": fwd,
                     "backward_max_abs_vs_gpu": bwd,
                     "atol": SHARD_PLACE_ATOL,
                     "wrong_device_refused": refused}
    # Module over a list of contexts: one Executor on the first
    params = []
    for context in ([gpu, gpu], gpu):
        mod = mx.mod.Module(sym, context=context)
        mod.bind([("data", (B, D))], [("softmax_label", (B,))])
        mx.random.seed(SEED)
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=gpu)],
                                [mx.nd.array(y, ctx=gpu)])
        for _ in range(SHARD_PLACE_STEPS):
            mod.forward_backward(batch)
            mod.update()
        params.append(mod.get_params()[0])
    differing = sum(int((a._data != params[1][n]._data).sum())
                    for n, a in params[0].items())
    assert differing == 0, differing
    out["module_context_list_differing"] = differing
    # Gluon Parameters on two contexts
    nets = []
    for ctxs in ([gpu, cpu], [gpu]):
        nn = mx.gluon.nn
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(D, activation="relu", in_units=D))
            net.add(nn.Dense(10, in_units=D))
        mx.random.seed(SEED)
        net.initialize(mx.init.Xavier(), ctx=ctxs)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(SHARD_PLACE_STEPS):
            xs = mx.gluon.utils.split_and_load(mx.nd.array(x, ctx=gpu), ctxs)
            ys = mx.gluon.utils.split_and_load(mx.nd.array(y, ctx=gpu), ctxs)
            for xi, yi in zip(xs, ys):
                with mx.autograd.record():
                    loss = loss_fn(net(xi), yi)
                loss.backward()
            trainer.step(B)
        nets.append(net)
    worst = 0.0
    for p2, p1 in zip(nets[0].collect_params().values(),
                      nets[1].collect_params().values()):
        copies = p2.list_data()
        assert [c.context for c in copies] == [gpu, cpu]
        assert [c._data.device for c in copies] == [gpu.torch_device,
                                                    cpu.torch_device]
        assert torch.equal(copies[0]._data.cpu(), copies[1]._data.cpu())
        worst = max(worst, float((copies[0]._data - p1.data()._data).detach()
                                 .max()))
    assert worst <= SHARD_PLACE_ATOL, worst
    out["gluon"] = {"contexts": [str(gpu), str(cpu)],
                    "steps": SHARD_PLACE_STEPS,
                    "weights_max_abs_vs_one_gpu": worst,
                    "atol": SHARD_PLACE_ATOL}
    _log("[shard-placement] %s" % json.dumps(out))
    return out


# ------------------------------------------------------ phase resilience
RES_WORKER_TIMEOUT_S = 600
RES_RANKS = 2
#: (a) the all-finite reduction's planted values, at seeded positions of
#: the 193 ResNet-50 gradients (f32) and of their bf16 copies
RES_PLANTS = (("nan", "float32"), ("+inf", "float32"), ("inf", "bfloat16"))
#: (b) bench.py one_config's ResNet-50 (224^2, bf16 over f32 masters, SGD
#: lr 0.1 momentum 0.9 wd 1e-4) under SPMDTrainer at RES_BATCH, RES_STEPS
#: steps under nanguard=skip with the nan fault at RES_NAN_STEP; the chaos
#: run adds io faults (RES_IO_P a batch fetch), a CheckpointManager every
#: RES_CKPT_EVERY steps keeping RES_CKPT_KEEP, a ckpt_write fault at the
#: second save, a SIGTERM before step RES_SIGTERM_STEP, the newest
#: checkpoint truncated, and a new trainer resuming for the rest
RES_BATCH = 32
RES_STEPS = 12
RES_NAN_STEP = 5
RES_IO_P = 0.2
RES_CKPT_EVERY = 3
RES_CKPT_KEEP = 2
RES_SIGTERM_STEP = 8
#: the sync and step-time comparison: RES_AB_STEPS finite steps a window,
#: nanguard off and skip in the order off, skip, skip, off
RES_AB_STEPS = 4
#: (c) the Module MLP (phase 7(c)'s) under nanguard=abort with patience
#: RES_PATIENCE and batches RES_POISONED poisoned; the abort must land
#: within two steps of the first
RES_PATIENCE = 3
RES_POISONED = (4, 5, 6)
RES_MODULE_STEPS = 12
#: (d) the Module MLP's widths under SPMDTrainer over two gloo ranks on
#: the card, RES_ELASTIC_STEPS steps, rank 1 drawing peer_preempt at
#: RES_PEER_STEP; then a sharded checkpoint round trip at tp=2 (phase
#: 9b's MLP and specs), RES_SHARD_STEPS steps after each side
RES_ELASTIC_STEPS = 10
RES_PEER_STEP = 5
RES_ELASTIC_LR = 0.1
RES_SHARD_STEPS = 2


def _res_batches(np, torch, n, shape, classes, seed, device="cuda"):
    """``n`` seeded (data, label) batches on the card."""
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
             .to(device),
             torch.from_numpy(rng.randint(0, classes, (shape[0],))
                              .astype(np.float32)).to(device))
            for _ in range(n)]


def _res_iter(mx, batches, start=0):
    """A DataIter over device batches from ``start``: its ``__next__`` is
    the base class's, under ``call_with_retry(kind="io")``, which draws
    the io fault before the batch is taken."""
    class Batches(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=int(batches[0][0].shape[0]))
            self.i = start

        def next(self):
            if self.i >= len(batches):
                raise StopIteration
            x, y = batches[self.i]
            self.i += 1
            return mx.io.DataBatch([x], [y])
    return Batches()


def _res_state(tr):
    """Clones of a trainer's masters, momenta and moving statistics."""
    return {"params": {n: v.detach().clone() for n, v in tr.params.items()},
            "opt": {n: s.clone() for n, s in tr.opt_state.items()
                    if s is not None}}


def _res_differing(torch, a, b):
    return sum(_differing(torch, a[k][n], b[k][n])
               for k in ("params", "opt") for n in a[k])


def check_skip_word(ck, torch, mx, np):
    """(a) K1 over ResNet-50's 193 tensors and K3 over the Module MLP's
    18, with f32 grads and with bf16 grads and a bf16 cast: with the word
    0 each launch is bitwise the word-less launch and the plain version;
    with the word 1 no byte of any output changes.  Device time with and
    without the word at 193 tensors, and the all-finite reduction against
    torch.isfinite on the host for planted NaN, +Inf and bf16 Inf."""
    from mxnet_tpu_torch import resilience
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    word0 = torch.zeros((), dtype=torch.int32, device="cuda")
    word1 = torch.ones((), dtype=torch.int32, device="cuda")
    cases = []
    resnet = _resnet_shapes(mx, np)
    for kernel, shapes in (("sgd_step", resnet), ("adam_step", _mlp_shapes())):
        for gdt, cast in ((torch.float32, None),
                          (torch.bfloat16, torch.bfloat16)):
            n = len(shapes)
            ws = [torch.randn(s, generator=g, device="cuda") * 0.05
                  for s in shapes]
            gs = [torch.randn(s, generator=g, device="cuda").to(gdt)
                  for s in shapes]
            ms = [torch.randn(s, generator=g, device="cuda") * 0.01
                  for s in shapes]
            vs = [torch.rand(s, generator=g, device="cuda") * 1e-4
                  for s in shapes]
            os_ = [torch.randn(s, generator=g, device="cuda").to(cast)
                   if cast else None for s in shapes]
            runs = {}
            for label, fn, word in (
                    ("no_word", "kernel", None), ("word0", "kernel", word0),
                    ("plain0", "plain", word0), ("word1", "kernel", word1),
                    ("plain1", "plain", word1)):
                w, m, v = ([x.clone() for x in xs] for xs in (ws, ms, vs))
                o = [x.clone() if x is not None else None for x in os_]
                before = dict(ck.LAUNCHES)
                if kernel == "sgd_step":
                    f = ck.fused_sgd_step_multi if fn == "kernel" \
                        else ck.fused_sgd_step_multi_plain
                    f(w, gs, m, [0.1] * n, [SGD_WD] * n, 0.9, outs=o,
                      skip=word)
                else:
                    f = ck.fused_adam_step_multi if fn == "kernel" \
                        else ck.fused_adam_step_multi_plain
                    f(w, gs, m, v, [1e-3] * n, [0.0] * n, 0.9, 0.999, 1e-8,
                      outs=o, skip=word)
                launched = ck.LAUNCHES[kernel] - before[kernel]
                assert launched == (1 if fn == "kernel" else 0), launched
                outs = {"master": w, "m": m, "cast": [x for x in o if
                                                      x is not None]}
                if kernel == "adam_step":
                    outs["v"] = v
                runs[label] = outs
            torch.cuda.synchronize()
            orig = {"master": ws, "m": ms, "v": vs,
                    "cast": [x for x in os_ if x is not None]}

            def diff(a, b):
                return {k: sum(_differing(torch, x, y)
                               for x, y in zip(a[k], b[k])) for k in a}
            case = {"kernel": kernel, "tensors": n,
                    "grad": str(gdt)[6:], "cast": str(cast)[6:] if cast
                    else None,
                    "word0_vs_no_word": diff(runs["word0"], runs["no_word"]),
                    "word0_vs_plain": diff(runs["word0"], runs["plain0"]),
                    "word1_vs_inputs": diff(runs["word1"], orig),
                    "plain1_vs_inputs": diff(runs["plain1"], orig),
                    "no_word_changed": diff(runs["no_word"], orig)}
            case["ok"] = (not any(sum(case[k].values()) for k in (
                "word0_vs_no_word", "word0_vs_plain", "word1_vs_inputs",
                "plain1_vs_inputs"))
                and case["no_word_changed"]["master"] > 0)
            _log("[resilience] skip word %s" % json.dumps(case))
            cases.append(case)
            del ws, gs, ms, vs, os_, runs
    # device time at 193 tensors: K1 (f32 grads, the master its own out,
    # momentum 0.9) and K3 (f32 grads, no cast), the launch alone, word
    # absent, 0 and 1, interleaved in one call
    n = len(resnet)
    ws = [torch.randn(s, generator=g, device="cuda") * 0.05 for s in resnet]
    gs = [torch.randn(s, generator=g, device="cuda") for s in resnet]
    ms = [torch.randn(s, generator=g, device="cuda") * 0.01 for s in resnet]
    vs = [torch.rand(s, generator=g, device="cuda") * 1e-4 for s in resnet]
    lrs, wds = [0.1] * n, [SGD_WD] * n
    t_sgd, t_adam = ck.LaunchTable(), ck.LaunchTable()
    dsgd, bsgd = t_sgd.fill(ck.SGD_LAYOUT, (ws, ms, [None] * n), gs, lrs, wds)
    dadam, badam = t_adam.fill(ck.ADAM_LAYOUT, (ws, ms, vs, [None] * n), gs,
                               [1e-3] * n, [0.0] * n)
    timing = {"tensors": n, "params": sum(w.numel() for w in ws),
              "sgd_blocks": bsgd, "adam_blocks": badam}
    for rep in range(2):
        for label, word in (("none", None), ("word0", word0),
                            ("word1", word1)):
            for kernel, launch in (
                    ("sgd_step", lambda w=word: ck._launch_sgd(
                        dsgd, n, bsgd, 0.9, ws[0], w)),
                    ("adam_step", lambda w=word: ck._launch_adam(
                        dadam, n, badam, 0.9, 0.999, 1e-8, ws[0], w))):
                key = "%s_%s" % (kernel, label)
                dms = _device_ms(torch, launch)
                ems = _time_ms(launch)
                timing.setdefault(key + "_device_ms", []).append(dms)
                timing.setdefault(key + "_event_ms", []).append(ems)
    timing["bound_ms"] = {
        "sgd_step": _bound_ms(timing["params"] * 20, 0)[0],
        "adam_step": _bound_ms(timing["params"] * 28, 0)[0]}
    _log("[resilience] K1/K3 with and without the skip word at %d tensors "
         "%s" % (n, json.dumps(timing)))
    # the all-finite reduction against the host
    finite = []
    for what, dt in RES_PLANTS:
        xs = [x.to(getattr(torch, dt), copy=True) for x in gs]
        clean = [x.clone() for x in xs]
        word = resilience.skip_word(xs)
        host_clean = all(bool(torch.isfinite(x.cpu()).all()) for x in xs)
        kept = sum(_differing(torch, x, y) for x, y in zip(xs, clean))
        rng = np.random.RandomState(SEED + len(finite))
        t = int(rng.randint(n))
        pos = int(rng.randint(xs[t].numel()))
        xs[t].view(-1)[pos] = {"nan": float("nan"), "+inf": float("inf"),
                               "inf": float("inf")}[what]
        planted = resilience.skip_word(xs)
        host = all(bool(torch.isfinite(x.cpu()).all()) for x in xs)
        row = {"plant": what, "dtype": dt, "tensor": t, "position": pos,
               "word_clean": int(word), "host_clean_finite": host_clean,
               "word_planted": int(planted), "host_planted_finite": host,
               "finite_values_changed": kept}
        row["ok"] = (int(word) == 0 and host_clean and int(planted) == 1
                     and not host and kept == 0)
        _log("[resilience] all-finite %s" % json.dumps(row))
        finite.append(row)
    del ws, gs, ms, vs
    torch.cuda.empty_cache()
    return {"cases": cases, "timing": timing, "all_finite": finite,
            "ok": all(c["ok"] for c in cases + finite)}


def _res_chaos_run(mx, ck, np, torch, net, batches, workdir, chaos):
    """(b)'s run: the baseline (``chaos`` False) or the chaos run and its
    resume.  Returns losses, the final state, K1's launches a trainer and
    what the faults did."""
    from mxnet_tpu_torch import config, resilience
    from mxnet_tpu_torch import telemetry as tt
    spec = "nan:1@step=%d" % RES_NAN_STEP
    if chaos:
        # the ckpt_write fault's opportunities are atomic_write calls: two
        # a save (the file, its manifest), so the second save's file is
        # the third
        spec += ",io:%g,ckpt_write:1@step=3" % RES_IO_P
    config.set("resilience.nanguard", "skip")
    config.set("resilience.faults", spec)
    config.set("resilience.retry_attempts", 6)
    config.set("resilience.retry_base_s", 0.001)
    resilience.reset_nanguard()
    _zero_counts(torch, tt, ck)
    out = {"faults": spec}
    tr = _resnet_trainer(mx, net, "bfloat16")
    ckdir = os.path.join(workdir, "resilience_ckpt")
    if chaos:
        import shutil
        shutil.rmtree(ckdir, ignore_errors=True)
        mgr = mx.resilience.CheckpointManager(
            ckdir, every_n_steps=RES_CKPT_EVERY, keep=RES_CKPT_KEEP)
        assert tr.attach_checkpoint_manager(mgr) is None
        config.set("resilience.on_preempt", "save_and_exit")
    losses, nan_step = [], {}
    it = _res_iter(mx, batches)
    exited = None
    try:
        for step, batch in enumerate(it, 1):
            if chaos and step == RES_SIGTERM_STEP:
                import signal
                os.kill(os.getpid(), signal.SIGTERM)
            if step == RES_NAN_STEP and not chaos:
                before = _res_state(tr)
            loss = tr.step(batch.data[0], batch.label[0])
            losses.append(loss)
            if step == RES_NAN_STEP and not chaos:
                torch.cuda.synchronize()
                nan_step = {"differing_after_nan_step": _res_differing(
                    torch, before, _res_state(tr))}
                del before
    except SystemExit as exc:
        exited = {"code": exc.code, "at_step": tr._step_num}
    finally:
        config.set("resilience.on_preempt", "")
    torch.cuda.synchronize()
    resilience.poll_streaks(block=True)
    c = tt.snapshot()["counters"]
    out.update(nan_step)
    out["launches"] = [dict(ck.LAUNCHES)]
    out["nonfinite_steps"] = c.get("spmd.nonfinite_steps", 0)
    if not chaos:
        out.update({"losses": [float(v) for v in losses],
                    "state": _res_state(tr)})
        return out
    # the preempted run: its checkpoints, then the newest truncated and a
    # new trainer resuming from the one before
    assert exited == {"code": 0, "at_step": RES_SIGTERM_STEP}, exited
    out["exited"] = exited
    out["first_losses"] = [float(v) for v in losses]
    out["saves"] = c.get("resilience.ckpt_saves", 0)
    out["retries"] = {k: v for k, v in c.items()
                      if k.startswith("resilience.retries")}
    out["injected"] = {k: v for k, v in c.items()
                       if k.startswith("resilience.injected")}
    out["preemptions"] = c.get("resilience.preemptions", 0)
    kept = [s for s, _ in mgr.checkpoints()]
    out["checkpoints_kept"] = kept
    newest = mgr.path_for(kept[-1])
    size = os.path.getsize(newest)
    with open(newest, "r+b") as f:
        f.truncate(size // 2)
    del tr
    torch.cuda.empty_cache()
    config.set("resilience.faults", spec)   # re-arm, as a new process would
    resilience.reset_nanguard()
    ck.reset_launches()
    tr = _resnet_trainer(mx, net, "bfloat16")
    before = tt.counter("resilience.ckpt_fallbacks").value
    resumed = tr.attach_checkpoint_manager(mx.resilience.CheckpointManager(
        ckdir, every_n_steps=RES_CKPT_EVERY, keep=RES_CKPT_KEEP))
    out["resumed_at"] = resumed
    out["fallbacks"] = tt.counter("resilience.ckpt_fallbacks").value - before
    tail = []
    for batch in _res_iter(mx, batches, start=resumed):
        tail.append(tr.step(batch.data[0], batch.label[0]))
    torch.cuda.synchronize()
    resilience.poll_streaks(block=True)
    out["launches"].append(dict(ck.LAUNCHES))
    out["losses"] = out["first_losses"][:resumed] + [float(v) for v in tail]
    out["state"] = _res_state(tr)
    return out


def _res_sync_ab(mx, np, torch, net, batches):
    """Synchronizing calls and step times over RES_AB_STEPS finite steps
    with the nanguard off and at skip (order off, skip, skip, off; two
    untimed steps after each flip; cuDNN's algorithms chosen by timing, as
    in phase 5): CUDA's sync debug mode warns at every synchronizing call,
    and the warnings of each window are counted.  A last window reads
    each step's loss on the host, so its count must be at least its step
    count: the counter sees syncs."""
    import warnings
    from mxnet_tpu_torch import config, resilience
    config.set("resilience.faults", "")
    tr = _resnet_trainer(mx, net, "bfloat16")
    windows = []
    for mode in ("", "skip", "skip", "", "read"):
        config.set("resilience.nanguard", "" if mode == "read" else mode)
        resilience.reset_nanguard()
        for x, y in batches[:2]:
            tr.step(x, y)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                a.record()
                for i in range(RES_AB_STEPS):
                    x, y = batches[i % len(batches)]
                    loss = tr.step(x, y)
                    if mode == "read":
                        float(loss)
                b.record()
                host_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # the sync warnings' text; the mode's one-time notice that it is
        # a prototype is not a sync
        syncs = [str(w.message) for w in caught
                 if "synchronizing" in str(w.message)]
        windows.append({"nanguard": mode or "off",
                        "ms_per_step": a.elapsed_time(b) / RES_AB_STEPS,
                        "host_ms_per_step": host_s * 1e3 / RES_AB_STEPS,
                        "sync_warnings": len(syncs),
                        "first_sync": syncs[:2]})
        _log("[resilience] sync/step-time window %s" % json.dumps(
            windows[-1]))
    resilience.poll_streaks(block=True)
    config.set("resilience.nanguard", "")
    read = windows.pop()
    assert read["sync_warnings"] >= RES_AB_STEPS, read
    off = [w for w in windows if w["nanguard"] == "off"]
    on = [w for w in windows if w["nanguard"] == "skip"]
    return {"windows": windows, "control_window": read,
            "steps_a_window": RES_AB_STEPS,
            "extra_syncs": sum(w["sync_warnings"] for w in on)
            - sum(w["sync_warnings"] for w in off),
            "off_ms_per_step": float(np.mean([w["ms_per_step"]
                                              for w in off])),
            "skip_ms_per_step": float(np.mean([w["ms_per_step"]
                                               for w in on]))}


def res_chaos(mx, ck, np, torch, card, workdir):
    """(b): the chaos run against its baseline, bitwise; then the sync
    count and step times of the guarded finite steps."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    prev = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    # two runs that must agree bit for bit need cuDNN's deterministic
    # algorithms, the same in every trainer
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        batches = _res_batches(np, torch, RES_STEPS,
                               (RES_BATCH, 3, RESNET_HW, RESNET_HW), 1000,
                               SEED + 31)
        mx.random.seed(SEED)
        net = vision.get_model("resnet50_v1", classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.array(batches[0][0][:2], ctx=mx.gpu(0)))
        t0 = time.perf_counter()
        base = _res_chaos_run(mx, ck, np, torch, net, batches, workdir,
                              False)
        base_s = time.perf_counter() - t0
        chaos = _res_chaos_run(mx, ck, np, torch, net, batches, workdir,
                               True)
        chaos_s = time.perf_counter() - t0 - base_s
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.deterministic = False
        ab = _res_sync_ab(mx, np, torch, net, batches)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic \
            = prev
        mx.config.set("resilience.nanguard", "")
        mx.config.set("resilience.faults", "")
    loss_diff = sum(int(np.float32(a).view(np.int32)
                        != np.float32(b).view(np.int32))
                    for a, b in zip(base["losses"], chaos["losses"]))
    state_diff = _res_differing(torch, base["state"], chaos["state"])
    out = {"card": card, "batch": RES_BATCH, "steps": RES_STEPS,
           "baseline_losses": base["losses"],
           "chaos_losses": chaos["losses"],
           "losses_differing": loss_diff,
           "state_tensors": sum(len(base["state"][k]) for k in base["state"]),
           "state_differing_elements": state_diff,
           "baseline_launches": base["launches"],
           "chaos_launches": chaos["launches"],
           "baseline_nan_step_differing": base["differing_after_nan_step"],
           "baseline_nonfinite_steps": base["nonfinite_steps"],
           "chaos_nonfinite_steps": chaos["nonfinite_steps"],
           "baseline_s": base_s, "chaos_s": chaos_s, "sync_ab": ab}
    out.update({k: chaos[k] for k in (
        "exited", "saves", "retries", "injected", "preemptions",
        "checkpoints_kept", "resumed_at", "fallbacks", "faults")})
    _log("[resilience] chaos %s" % json.dumps(
        {k: v for k, v in out.items() if k != "sync_ab"}))
    assert loss_diff == 0 and state_diff == 0, (loss_diff, state_diff)
    assert np.isnan(base["losses"][RES_NAN_STEP - 1]), base["losses"]
    assert base["differing_after_nan_step"] == 0, base
    assert base["nonfinite_steps"] == 1, base["nonfinite_steps"]
    want = dict.fromkeys(base["launches"][0], 0)
    assert base["launches"] == [dict(want, sgd_step=RES_STEPS)], \
        base["launches"]
    assert chaos["launches"] == [
        dict(want, sgd_step=RES_SIGTERM_STEP),
        dict(want, sgd_step=RES_STEPS - chaos["resumed_at"])], \
        chaos["launches"]
    # saves at steps 3 and 6 (its file faulted once, retried), then the
    # preemption's at step 8; the newest truncated, restored from 6
    assert chaos["saves"] == 3 and chaos["checkpoints_kept"] == [6, 8], out
    assert chaos["retries"].get("resilience.retries.ckpt_write") == 1, out
    assert chaos["retries"].get("resilience.retries.io", 0) > 0, out
    assert chaos["resumed_at"] == 6 and chaos["fallbacks"] == 1, out
    assert ab["extra_syncs"] <= 0, ab
    return out


def res_abort(mx, ck, np, torch, card, workdir):
    """(c): the Module MLP through the fused Executor step (K3) under
    nanguard=abort: NonFiniteStepError within two steps of the first
    poisoned batch (after the forensics replay, one more K3 launch on
    copies), and the checkpoint written then holds the last good
    parameters bitwise."""
    from mxnet_tpu_torch import config, resilience
    from mxnet_tpu_torch import telemetry as tt
    config.set("resilience.nanguard", "abort")
    config.set("resilience.nanguard_patience", RES_PATIENCE)
    resilience.reset_nanguard()
    try:
        mod = _mlp_module(mx)
        good = _mlp_batch(mx, np)
        bad = mx.io.DataBatch([good.data[0] * float("nan")], good.label)
        _zero_counts(torch, tt, ck)
        last_good, raised_at = None, None
        for step in range(1, RES_MODULE_STEPS + 1):
            if step == RES_POISONED[0]:
                torch.cuda.synchronize()
                last_good = {n: v._data.clone() for n, v in
                             mod.get_params()[0].items()}
            try:
                mod.train_step(bad if step in RES_POISONED else good)
            except resilience.NonFiniteStepError as exc:
                raised_at, message = step, str(exc)
                break
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        assert raised_at is not None and \
            RES_POISONED[0] < raised_at <= RES_POISONED[0] + 2, raised_at
        prefix = os.path.join(workdir, "resilience_abort")
        mod.save_checkpoint(prefix, raised_at)
        _, arg, _ = mx.model.load_checkpoint(prefix, raised_at)
        differing = sum(_differing(torch, arg[n]._data.to(v.device), v)
                        for n, v in last_good.items())
        steps_run = raised_at - 1
        out = {"card": card, "raised_at_step": raised_at,
               "first_poisoned": RES_POISONED[0], "message": message,
               "launches": launches, "steps_run": steps_run,
               "checkpoint_differing_vs_last_good": differing,
               "nonfinite_steps": tt.counter("module.nonfinite_steps").value}
        _log("[resilience] abort %s" % json.dumps(out))
        want = dict.fromkeys(launches, 0)
        # one a step run, and the abort's forensics replay (one step on
        # copies of the weights and moments)
        want["adam_step"] = steps_run + 1
        assert launches == want, (launches, want)
        assert differing == 0, differing
        return out
    finally:
        config.set("resilience.nanguard", "")
        config.unset("resilience.nanguard_patience")
        resilience.reset_nanguard()


def res_elastic(mx, np, torch, card, workdir):
    """(d): two gloo ranks sharing the card through the port's elastic
    launcher, each running ``chip_smoke.py --resilience-worker WORKDIR``:
    generation 0 runs the uninterrupted two-rank baseline, then the
    elastic run, where rank 1 draws peer_preempt at RES_PEER_STEP and
    both ranks exit 0 there with one world-stamped checkpoint; generation
    1 resumes and finishes, bitwise the baseline, then a sharded
    checkpoint round trip at tp=2."""
    import shutil
    from mxnet_tpu_torch import resilience
    t0 = time.perf_counter()
    edir = os.path.join(workdir, "elastic")
    shutil.rmtree(edir, ignore_errors=True)
    os.makedirs(edir)
    rc, so, se = _run_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
         str(RES_RANKS), "--elastic", "--max-restarts", "1",
         "--elastic-dir", edir, sys.executable,
         os.path.join(ROOT, "chip_smoke.py"), "--resilience-worker",
         workdir], RES_WORKER_TIMEOUT_S)
    if rc != 0:
        raise AssertionError("phase resilience's elastic group failed (rc "
                             "%d):\n%s\n%s" % (rc, so[-4000:], se[-8000:]))
    recs = {}
    for gen in (0, 1):
        for r in range(RES_RANKS):
            with open(os.path.join(workdir, "res_gen%d_rank%d.json"
                                   % (gen, r))) as f:
                recs[gen, r] = json.load(f)
    ckpts = sorted(n for n in os.listdir(os.path.join(edir, "ckpt"))
                   if n.endswith(".ckpt"))
    man = resilience.verify_checkpoint(
        os.path.join(edir, "ckpt", ckpts[-1]), require_manifest=True)
    out = {"card": card, "ranks": [recs[1, r] for r in range(RES_RANKS)],
           "generation0": [recs[0, r] for r in range(RES_RANKS)],
           "checkpoints": ckpts, "manifest_world": man.get("world"),
           "manifest_step": man.get("step"),
           "restarts": se.count("re-forming the world"),
           "seconds": time.perf_counter() - t0}
    _log("[resilience] elastic %s" % json.dumps(
        {k: v for k, v in out.items() if k not in ("ranks",
                                                    "generation0")}))
    for r in range(RES_RANKS):
        g0, g1 = recs[0, r], recs[1, r]
        assert g0["exited_at_step"] == RES_PEER_STEP, g0
        assert g1["resumed_at"] == RES_PEER_STEP, g1
        assert g1["losses_differing"] == 0 and g1["params_differing"] == 0, \
            g1
        assert g1["sharded"]["differing"] == 0, g1["sharded"]
    assert ckpts == ["ckpt-%08d.ckpt" % RES_PEER_STEP], ckpts
    assert man["world"] == {"process_count": RES_RANKS,
                            "mesh": {"dp": RES_RANKS}}, man
    assert out["restarts"] == 1, se[-4000:]
    return out


def resilience_phase(mx, ck, np, torch, card, workdir):
    """Phase resilience: (a) the skip word of K1 and K3, (b) the chaos
    run of ResNet-50, (c) the abort through K3, (d) elasticity on two
    ranks."""
    t0 = time.perf_counter()
    out = {"skip_word": check_skip_word(ck, torch, mx, np)}
    if not out["skip_word"]["ok"]:
        raise AssertionError("the skip word failed: %s" % json.dumps(
            out["skip_word"]))
    out["chaos"] = res_chaos(mx, ck, np, torch, card, workdir)
    torch.cuda.empty_cache()
    out["abort"] = res_abort(mx, ck, np, torch, card, workdir)
    out["elastic"] = res_elastic(mx, np, torch, card, workdir)
    out["seconds"] = time.perf_counter() - t0
    _log("[resilience] phase seconds %.1f" % out["seconds"])
    return out


def _res_launches(res):
    """K1's and K3's launches in phase resilience's counted runs."""
    chaos = res["chaos"]
    sgd = {"resilience_chaos_baseline":
           chaos["baseline_launches"][0]["sgd_step"],
           "resilience_chaos_preempted":
           chaos["chaos_launches"][0]["sgd_step"],
           "resilience_chaos_resumed":
           chaos["chaos_launches"][1]["sgd_step"]}
    for r, rank in enumerate(res["elastic"]["ranks"]):
        sgd["resilience_elastic_gen1_rank%d" % r] = rank["launches"][
            "sgd_step"]
    adam = {"resilience_abort_module":
            res["abort"]["launches"]["adam_step"]}
    return sgd, adam


# --- the ranks of phase resilience's elastic run (``--resilience-worker``)
def resilience_worker(workdir):
    """One rank of (d), on cuda:0; writes
    ``res_gen<g>_rank<r>.json``."""
    import numpy as np
    import mxnet_tpu_torch as mx
    import torch
    from mxnet_tpu_torch import config, elastic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = elastic.generation()
    with mx.gpu():
        mx.parallel.initialize()
        rank = mx.parallel.dist.rank()
        ck = _ck()
        edir = elastic.state_dir()
        batches = _res_batches(np, torch, RES_ELASTIC_STEPS,
                               (MLP_BATCH, MLP_FEAT), MLP_CLASSES, SEED + 41,
                               device=mx.parallel.dist.device())
        rec = {"rank": rank, "generation": gen}
        base_path = os.path.join(workdir, "res_base_rank%d.pt" % rank)
        if gen == 0:
            # the uninterrupted two-rank run, with elasticity off
            config.set("elastic.dir", "")
            tr = _res_elastic_trainer(mx)
            losses = [tr.step(x, y) for x, y in batches]
            torch.save({"losses": torch.stack(losses).cpu(),
                        "params": {n: v.detach().cpu()
                                   for n, v in tr.params.items()}},
                       base_path)
            config.unset("elastic.dir")
            if rank == 1:
                config.set("resilience.faults",
                           "peer_preempt:1@step=%d" % RES_PEER_STEP)
        tr = _res_elastic_trainer(mx)
        rec["resumed_at"] = tr.attach_checkpoint_manager(
            mx.resilience.CheckpointManager(os.path.join(edir, "ckpt"),
                                            every_n_steps=0))
        start = rec["resumed_at"] or 0
        ck.reset_launches()
        losses = []
        try:
            for x, y in batches[start:]:
                losses.append(tr.step(x, y))
        except SystemExit as exc:
            rec.update({"exit_code": exc.code, "exited_at_step":
                        tr._step_num, "losses": [float(v) for v in losses]})
            _res_write(workdir, gen, rank, rec)
            elastic.stop_heartbeat()
            return 0
        torch.cuda.synchronize()
        rec["launches"] = dict(ck.LAUNCHES)
        base = torch.load(base_path)
        got = torch.stack(losses).cpu()
        rec["losses"] = [float(v) for v in got]
        rec["losses_differing"] = _differing(torch, got,
                                             base["losses"][start:])
        rec["params_differing"] = sum(
            _differing(torch, tr.params[n].detach().cpu(), v)
            for n, v in base["params"].items())
        assert rec["launches"]["sgd_step"] == RES_ELASTIC_STEPS - start, rec
        rec["sharded"] = _res_sharded(mx, np, torch, workdir)
        _res_write(workdir, gen, rank, rec)
    elastic.stop_heartbeat()
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


def _res_write(workdir, gen, rank, rec):
    with open(os.path.join(workdir, "res_gen%d_rank%d.json"
                           % (gen, rank)), "w") as f:
        json.dump(rec, f)


def _res_elastic_trainer(mx):
    """(d)'s model: the Module MLP's widths as Gluon Dense layers under
    SPMDTrainer over {dp: RES_RANKS}, SGD momentum 0.9 (K1)."""
    import mxnet_tpu_torch.name  # noqa: F401  (loaded lazily)
    from mxnet_tpu_torch.parallel import SPMDTrainer
    nn = mx.gluon.nn
    with mx.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            for _ in range(MLP_LAYERS):
                net.add(nn.Dense(MLP_WIDTH, activation="relu"))
            net.add(nn.Dense(MLP_CLASSES))
    mx.random.seed(SEED)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((2, MLP_FEAT)))     # the deferred shapes
    return SPMDTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                       {"learning_rate": RES_ELASTIC_LR, "momentum": 0.9},
                       mesh=mx.parallel.make_mesh({"dp": RES_RANKS}))


def _res_sharded(mx, np, torch, workdir):
    """A sharded checkpoint round trip at tp=2 (phase 9b's MLP and
    specs): RES_SHARD_STEPS steps, save, RES_SHARD_STEPS more; a new
    trainer loads and takes the same steps, bitwise."""
    from mxnet_tpu_torch.parallel import SPMDTrainer
    rng = np.random.RandomState(SEED + 43)
    data = [rng.normal(size=(MESH_MLP_BATCH, MESH_MLP_FEAT))
            .astype(np.float32) for _ in range(2 * RES_SHARD_STEPS)]
    labels = [rng.randint(0, MESH_MLP_CLASSES, (MESH_MLP_BATCH,))
              .astype(np.float32) for _ in range(2 * RES_SHARD_STEPS)]
    specs, _ = mesh_mlp_specs()
    mesh = mx.parallel.make_mesh({"dp": 1, "tp": MESH_TP})
    path = os.path.join(workdir, "res_sharded")

    def trainer():
        net = _mesh_mlp_net(mx)
        net(mx.nd.array(data[0]))
        return SPMDTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                           mesh=mesh, param_specs={
                               net.prefix + k: v for k, v in specs.items()})
    tr = trainer()
    for x, y in zip(data[:RES_SHARD_STEPS], labels[:RES_SHARD_STEPS]):
        tr.step(x, y)
    tr.save_checkpoint_sharded(path)
    cont = [tr.step(x, y) for x, y in zip(data[RES_SHARD_STEPS:],
                                          labels[RES_SHARD_STEPS:])]
    tr2 = trainer()
    step = tr2.load_checkpoint_sharded(path)
    again = [tr2.step(x, y) for x, y in zip(data[RES_SHARD_STEPS:],
                                            labels[RES_SHARD_STEPS:])]
    differing = sum(_differing(torch, a, b) for a, b in zip(cont, again))
    differing += sum(_differing(torch, tr.params[n], tr2.params[n])
                     for n in tr.params)
    files = sorted(os.listdir(path))
    return {"loaded_step": step, "differing": differing, "files": files,
            "shard_shapes": [tuple(tr.params[n].shape)
                             for n in tr.fn.trainable]}


# ------------------------------------------------------- phase observe
# The training side of observability (mx.telemetry, mx.tracing,
# mx.profiler, mx.numerics, mx.monitor) on the card.
#: (a) summarize on the card against its plain version on the CPU: seeded
#: tensors with planted NaN, +-Inf, f32 subnormals and values above
#: bf16's largest finite value, up to ResNet-50's parameter count
OBS_SUMMARIZE_CASES = (("float32", 25600000), ("bfloat16", 25600000),
                       ("float16", 1048576), ("float32", 4099))
#: (b) the TransformerLM as phase 4 trains it, OBS_LM_STEPS steps a run;
#: the captured run collects every second step (2, 4, 6)
OBS_LM_STEPS = 6
OBS_NAN_LAYER = 6
#: (c) ResNet-50 v1 through SPMDTrainer and K1 (bf16 over f32 masters,
#: SGD lr 0.1 momentum 0.9 wd 1e-4) at batch OBS_BATCH: capture step:2,
#: the sinks, the watchdog, nanguard=abort (patience 2) and the nan fault
#: at OBS_NAN_STEPS; then OBS_SYNC_STEPS steps a window of the sync A/B
OBS_BATCH = 32
OBS_NAN_STEPS = (4, 5)
OBS_SYNC_STEPS = 4
#: (d) bench.py numerics_overhead_config on the Module MLP: OBS_PASSES
#: interleaved off/step:10 pairs of OBS_ITERS steps, and the publish/poll
#: microbenchmark at the MLP's site count
OBS_PASSES, OBS_ITERS = 2, 30
OBS_PUBLISH_N = 2000
#: (e) one-step mx.profiler sessions (a Module MLP step each) late in the
#: run
OBS_SESSIONS = 10
#: (f) batches of the monitored fit
OBS_MONITOR_BATCHES = 3
#: (g) the watchdog's deadline; the stalled prefetch sleeps twice it
OBS_WATCHDOG_S = 1.0


def _obs_planted(np, torch, dtype, n, seed):
    """A seeded tensor of ``n`` elements on the card in ``dtype`` with NaN,
    +-Inf, f32 subnormals (f32, bf16) and values above bf16's largest
    finite one (f32) at seeded positions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 50
    vals = [float("nan")] * 8 + [float("inf")] * 6 + [float("-inf")] * 6
    if dtype in ("float32", "bfloat16"):
        vals += [1e-40, -3e-39, 5e-39, -9.5e-41, 1.1e-38]
    if dtype == "float32":
        vals += [3.4e38, -3.39e38, 3.3999e38]
    pos = np.random.RandomState(seed).choice(n, len(vals), replace=False)
    x[torch.from_numpy(pos).cuda()] = torch.tensor(vals, device="cuda")
    return x.to(getattr(torch, dtype))


def obs_summarize(np, torch):
    """(a): ``numerics.summarize`` on the card against the same function
    on the CPU: amax, amin, nonfinite and the two fractions bitwise, rms
    within 1e-6 relative; its time beside the time to read the tensor
    once."""
    from mxnet_tpu_torch import numerics
    out = []
    for i, (dtype, n) in enumerate(OBS_SUMMARIZE_CASES):
        x = _obs_planted(np, torch, dtype, n, SEED + 61 + i)
        card = numerics.summarize(x).cpu().numpy()
        cpu = numerics.summarize(x.cpu()).numpy()
        exact = [0, 1, 3, 4, 5]
        differing = [numerics.STAT_FIELDS[k] for k in exact
                     if card[k].view(np.int32) != cpu[k].view(np.int32)]
        rms_rel = abs(float(card[2]) - float(cpu[2])) / max(
            abs(float(cpu[2])), 1e-30) if np.isfinite(cpu[2]) else (
            0.0 if card[2] == cpu[2] else float("inf"))
        ms = _time_ms(lambda: numerics.summarize(x), iters=10, warmup=2)
        nbytes = x.numel() * x.element_size()
        case = {"dtype": dtype, "elements": n, "card": card.tolist(),
                "cpu": cpu.tolist(), "differing_fields": differing,
                "rms_rel_err": rms_rel, "ms": ms,
                "read_bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                "ok": not differing and rms_rel <= 1e-6}
        out.append(case)
        _log("[observe] (a) summarize %s" % json.dumps(case))
        del x
    bad = [c for c in out if not c["ok"]]
    assert not bad, bad
    assert all(c["card"][3] > 0 for c in out), out
    assert all(c["card"][5] > 0 for c in out
               if c["dtype"] != "float16"), out
    return out


def _obs_kernel_counts(torch, fn):
    """``({CUDA kernel name: launches}, launched)`` of ``fn()`` under
    torch.profiler: the kernels (not copies or sets) its device side
    recorded, and the kernel launches its host side made.  Late in a
    long process a session can miss some of its device records and
    receive records an earlier session left behind, so each window
    starts after an empty session that takes those in."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import profiler as mxprof
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts):
        pass
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    device, launched, _ = mxprof._kernel_events(prof.events())
    names = {n: len(v) for n, v in device.items()
             if not n.startswith(("Memcpy", "Memset"))}
    return names, launched


def _obs_same_kernels(torch, off_step, unc_step, attempts=PROFILE_ATTEMPTS):
    """One step of each run profiled, again until the two windows agree
    by kernel name and count and by host-side launches, up to
    ``attempts`` pairs; returns ``(agreed, kernels of the capture-off
    step, attempts, every pair's totals)``.  A window that misses
    records, or holds an earlier session's, differs from a whole one, so
    a pair that agrees shows the same kernels (the host side records
    every launch)."""
    pairs = []
    for attempt in range(1, attempts + 1):
        k_off, l_off = _obs_kernel_counts(torch, off_step)
        k_unc, l_unc = _obs_kernel_counts(torch, unc_step)
        pairs.append([sum(k_off.values()), l_off, sum(k_unc.values()),
                      l_unc])
        if k_off and k_off == k_unc and l_off == l_unc:
            return True, k_off, attempt, pairs
    return False, k_off, attempts, pairs


def obs_lm(mx, ck, np, torch):
    """(b): the full-width TransformerLM, as phase 4 trains it, twice
    from the same weights: capture off, then ``numerics.collect()`` around
    every second step.  Losses and final parameters (and the f32 masters
    and moments) bitwise equal, the 12 ``layer_out`` sites in order and
    finite, K2f/K2dq/K2dkv 12 and K3 one a step in both runs, and an
    uncaptured step's CUDA kernels by name and count those of a
    capture-off step.  Then one NaN in a weight of layer OBS_NAN_LAYER
    (``w1``): a captured forward names ``layer_out[OBS_NAN_LAYER]``
    first; the same in ``wqkv`` is recorded."""
    from mxnet_tpu_torch import numerics
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    cfg = TransformerLMConfig()
    L = cfg.num_layers
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    inp = torch.as_tensor(toks[:, :-1], device="cuda")
    tgt = torch.as_tensor(toks[:, 1:], device="cuda")

    def trainer():
        model = TransformerLM(cfg).init(SEED)
        model.requires_grad_(True)
        params = [p for _, p in model.named_parameters()]
        opt = mx.optimizer.create("adam", learning_rate=TRAIN_LR,
                                  multi_precision=True)
        states = [opt.create_state_multi_precision(i, p)
                  for i, p in enumerate(params)]
        index = list(range(len(params)))

        def step():
            model.zero_grad(set_to_none=True)
            loss = model.loss(inp, tgt)
            loss.backward()
            opt.update_multi_precision(index, params,
                                       [p.grad for p in params], states)
            return loss
        return model, params, states, step

    def leaves(states):
        out = []
        for s in states:
            if isinstance(s, (list, tuple)):
                out += leaves(s)
            elif s is not None:
                out.append(s)
        return out

    runs = {}
    for name in ("off", "capture"):
        model, params, states, step = trainer()
        ck.reset_launches()
        losses, per_step, sites = [], [], []
        for i in range(1, OBS_LM_STEPS + 1):
            before = dict(ck.LAUNCHES)
            if name == "capture" and i % 2 == 0:
                with numerics.collect() as sink:
                    loss = step()
                host = numerics.expand_stats(dict(sink))
                sites.append({"step": i, "sites": list(host),
                              "finite": all(float(v[3]) == 0
                                            for v in host.values()),
                              "amax": [float(v[0]) for v in host.values()]})
            else:
                loss = step()
            torch.cuda.synchronize()
            per_step.append({k: v - before.get(k, 0)
                             for k, v in ck.LAUNCHES.items()
                             if v - before.get(k, 0)})
            losses.append(loss.detach().clone())
        runs[name] = {"model": model, "params": params, "states": states,
                      "step": step, "losses": losses, "per_step": per_step,
                      "sites": sites}
    off, cap = runs["off"], runs["capture"]
    loss_diff = sum(_differing(torch, a, b)
                    for a, b in zip(off["losses"], cap["losses"]))
    param_diff = sum(_differing(torch, a.detach(), b.detach())
                     for a, b in zip(off["params"], cap["params"]))
    state_diff = sum(_differing(torch, a, b) for a, b in zip(
        leaves(off["states"]), leaves(cap["states"])))
    # more steps of each: an uncaptured step of the captured run against
    # one of the capture-off run, by CUDA kernel name and count; then a
    # captured one, for what a capture adds
    same, k_off, attempts, pairs = _obs_same_kernels(torch, off["step"],
                                                     cap["step"])

    def captured_step():
        with numerics.collect():
            cap["step"]()
    k_cap, _ = _obs_kernel_counts(torch, captured_step)
    def planted_first(name):
        """The first non-finite site of a captured forward with one NaN
        in weight ``name`` of layer OBS_NAN_LAYER (put back after)."""
        w = getattr(cap["model"].layers, name)[OBS_NAN_LAYER].view(-1)
        with torch.no_grad():
            old = w[0].clone()
            w[0] = float("nan")
            with numerics.collect() as sink:
                cap["model"].loss(inp, tgt)
            w[0] = old
        return numerics.first_nonfinite(numerics.expand_stats(dict(sink)))
    planted = planted_first("w1")
    # a NaN in the query projection reaches K2f as NaN query rows, which
    # its running max (fmaxf) reads as fully masked rows: zeros out
    planted_qkv = planted_first("wqkv")
    want_step = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                 "adam_step": 1}
    out = {"steps": OBS_LM_STEPS, "batch": [TRAIN_B, TRAIN_S],
           "losses": [float(v) for v in off["losses"]],
           "losses_differing": loss_diff,
           "param_elements_differing": param_diff,
           "state_elements_differing": state_diff,
           "sites": cap["sites"],
           "launches_per_step": {"off": off["per_step"],
                                 "capture": cap["per_step"]},
           "launches": {n: {k: sum(s.get(k, 0) for s in r["per_step"])
                            for k in want_step}
                        for n, r in runs.items()},
           "uncaptured_kernels_equal": same,
           "kernel_window_pairs": attempts,
           "kernel_window_totals": pairs,
           "capture_adds_kernels": sum(k_cap.values())
           - sum(k_off.values()),
           "kernels_off_step": k_off, "first_nonfinite_with_nan": planted,
           "first_nonfinite_with_nan_in_wqkv": planted_qkv}
    _log("[observe] (b) lm %s" % json.dumps(
        {k: v for k, v in out.items() if k not in (
            "kernels_off_step", "launches_per_step")}))
    assert loss_diff == 0 and param_diff == 0 and state_diff == 0, out
    for n, r in runs.items():
        assert all(s == want_step for s in r["per_step"]), (n, r["per_step"])
    want_sites = ["layer_out[%d]" % i for i in range(L)]
    assert [s["sites"] for s in cap["sites"]] == [want_sites] * 3, \
        cap["sites"]
    assert all(s["finite"] for s in cap["sites"]), cap["sites"]
    assert same, out
    assert planted == "layer_out[%d]" % OBS_NAN_LAYER, planted
    del runs, off, cap
    torch.cuda.empty_cache()
    return out


def _obs_net(mx, np, torch, batches):
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(SEED)
    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(batches[0][0][:2], ctx=mx.gpu(0)))
    return net


def _obs_abort(mx, ck, np, torch, net, batches, workdir):
    """(c)'s run: capture step:2, both sinks, the watchdog, nanguard=abort
    with patience 2 and the nan fault at OBS_NAN_STEPS, a checkpoint
    manager; the streak read after each step so the abort lands at the
    start of the step after the first poisoned one."""
    import shutil
    from mxnet_tpu_torch import config, numerics, resilience, tracing
    from mxnet_tpu_torch import telemetry as tt
    d = os.path.join(workdir, "observe")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(d, "reports"))
    jsonl = os.path.join(d, "steps.jsonl")
    trace = os.path.join(d, "spans.trace.json")
    first = OBS_NAN_STEPS[0]
    config.set("numerics.capture", "step:2")
    config.set("telemetry.sink", "jsonl:" + jsonl)
    config.set("tracing.sink", "chrome:" + trace)
    config.set("tracing.watchdog_dir", os.path.join(d, "reports"))
    config.set("tracing.watchdog", 30)
    config.set("resilience.nanguard", "abort")
    config.set("resilience.nanguard_patience", 2)
    config.set("resilience.faults", "nan:%d@step=%d"
               % (len(OBS_NAN_STEPS), first))
    resilience.reset_nanguard()
    numerics.reset()
    _zero_counts(torch, tt, ck)
    tr = _resnet_trainer(mx, net, "bfloat16")
    mgr = mx.resilience.CheckpointManager(os.path.join(d, "ckpt"),
                                          every_n_steps=0, keep=2)
    assert tr.attach_checkpoint_manager(mgr) is None
    raised_at, message, finite_launches = None, None, None
    t0 = time.perf_counter()
    try:
        for step, (x, y) in enumerate(batches, 1):
            try:
                tr.step(x, y)
            except resilience.NonFiniteStepError as exc:
                raised_at, message = step, str(exc)
                break
            resilience.poll_streaks(block=True)
            if step == first - 1:
                torch.cuda.synchronize()
                finite_launches = ck.LAUNCHES["sgd_step"]
    finally:
        for knob in ("numerics.capture", "telemetry.sink", "tracing.sink",
                     "tracing.watchdog", "tracing.watchdog_dir",
                     "resilience.nanguard", "resilience.nanguard_patience",
                     "resilience.faults"):
            config.unset(knob)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    recs = numerics.forensics_records()
    gauge = tt.snapshot()["gauges"].get("numerics.first_nonfinite_site.spmd")
    with open(jsonl) as f:
        events = [json.loads(line) for line in f]
    steps = [e for e in events if e["event"] == "step"]
    bad_records = []
    for rec in steps:
        try:
            tt.validate_step_record(rec)
        except ValueError as exc:
            bad_records.append(str(exc))
    reports = sorted(os.listdir(os.path.join(d, "reports")))
    report_ok, ring_has_forensics, report_error = False, False, None
    if len(reports) == 1:
        with open(os.path.join(d, "reports", reports[0])) as f:
            rep = json.load(f)
        try:
            tracing.validate_watchdog_report(rep)
            report_ok = True
        except ValueError as exc:
            report_error = str(exc)
        ring_has_forensics = any(
            e.get("name") == "nanguard_forensics"
            and e.get("first_nonfinite_site") == "out" for e in rep["ring"])
    xs = tracing.validate_trace_events(tracing.load_trace(trace))
    step_ids = {e["args"]["span_id"] for e in xs if e["name"] == "spmd.step"}
    shard = [e for e in xs if e["name"] == "spmd.shard_batch"]
    out = {"batch": OBS_BATCH, "raised_at_step": raised_at,
           "message": message, "seconds": seconds,
           "forensics": [{k: r[k] for k in ("source", "first_nonfinite_site",
                                            "nonfinite_sites", "sites")}
                         for r in recs],
           "gauge": gauge,
           "jsonl_forensics_events": sum(
               e["event"] == "nanguard_forensics" for e in events),
           "jsonl_numerics_events": sum(e["event"] == "numerics"
                                        for e in events),
           "step_records": len(steps), "step_records_invalid": bad_records,
           "mem_bytes": [r.get("mem_bytes") for r in steps],
           "reports": reports, "report_valid": report_ok,
           "report_error": report_error,
           "report_ring_has_forensics": ring_has_forensics,
           "span_events": len(xs), "spmd_steps_in_trace": len(step_ids),
           "shard_batch_nested": bool(shard) and all(
               e["args"]["parent_id"] in step_ids for e in shard),
           "finite_steps": first - 1,
           "finite_step_sgd_launches": finite_launches,
           "launches": launches,
           "checkpoints": [s for s, _ in mgr.checkpoints()]}
    _log("[observe] (c) abort %s" % json.dumps(out))
    assert raised_at == first + 1, out
    assert len(recs) == 1 and recs[0]["first_nonfinite_site"] == "out", out
    assert gauge == "out" and out["jsonl_forensics_events"] == 1, out
    assert report_ok and ring_has_forensics, out
    assert steps and not bad_records, out
    assert all(isinstance(m, int) and m > 0 for m in out["mem_bytes"]), out
    # the abort lands before the step's span and record open
    assert out["shard_batch_nested"] and len(step_ids) == raised_at - 1, out
    assert len(steps) == raised_at - 1, out
    assert finite_launches == first - 1, out
    assert out["checkpoints"] == [first], out
    return out


def _obs_sync_ab(mx, np, torch, net, batches, workdir):
    """(c)'s sync count and (d)'s ResNet-50 capture cost: windows of
    OBS_SYNC_STEPS finite steps with everything off and with the sinks,
    the watchdog and capture step:2 on (order off, on, on, off; two
    untimed steps after each flip).  CUDA's sync debug mode warns at every
    synchronizing call; each step's warnings are counted, and each step is
    timed by CUDA events (the card's time from the step's first launch to
    its last) and on the host."""
    import warnings
    from mxnet_tpu_torch import config, numerics
    d = os.path.join(workdir, "observe")
    tr = _resnet_trainer(mx, net, "bfloat16")
    published = []
    orig = numerics.publish

    def counting(source, step, stats):
        published.append(step)
        return orig(source, step, stats)
    numerics.publish = counting
    rows = []
    try:
        for w, mode in enumerate(("off", "on", "on", "off")):
            if mode == "on":
                config.set("numerics.capture", "step:2")
                config.set("telemetry.sink",
                           "jsonl:" + os.path.join(d, "ab%d.jsonl" % w))
                config.set("tracing.sink", "chrome:" + os.path.join(
                    d, "ab%d.trace.json" % w))
                config.set("tracing.watchdog", 30)
            for x, y in batches[:2]:
                tr.step(x, y)
            torch.cuda.synchronize()
            numerics.poll(block=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    for i in range(OBS_SYNC_STEPS):
                        x, y = batches[i % len(batches)]
                        n_pub, n_warn = len(published), len(caught)
                        a = torch.cuda.Event(enable_timing=True)
                        b = torch.cuda.Event(enable_timing=True)
                        t0 = time.perf_counter()
                        a.record()
                        tr.step(x, y)
                        b.record()
                        host_ms = (time.perf_counter() - t0) * 1e3
                        rows.append({"window": w, "mode": mode,
                                     "captured": len(published) > n_pub,
                                     "syncs": [str(m.message) for m in
                                               caught[n_warn:]
                                               if "synchroniz" in
                                               str(m.message)],
                                     "events": (a, b), "host_ms": host_ms})
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            numerics.poll(block=True)
            for knob in ("numerics.capture", "telemetry.sink",
                         "tracing.sink", "tracing.watchdog"):
                config.unset(knob)
    finally:
        numerics.publish = orig
        for knob in ("numerics.capture", "telemetry.sink", "tracing.sink",
                     "tracing.watchdog"):
            config.unset(knob)
    for r in rows:
        a, b = r.pop("events")
        r["ms"] = a.elapsed_time(b)
        r["sync_warnings"] = len(r["syncs"])
        r["syncs"] = r["syncs"][:2]

    def pick(mode, captured=None):
        return [r for r in rows if r["mode"] == mode and (
            captured is None or r["captured"] == captured)]
    off, unc, cap = pick("off"), pick("on", False), pick("on", True)
    sites = numerics.latest("spmd")
    out = {"steps_a_window": OBS_SYNC_STEPS, "rows": rows,
           "off_syncs_per_step": sum(r["sync_warnings"] for r in off)
           / len(off),
           "uncaptured_syncs_per_step": sum(r["sync_warnings"] for r in unc)
           / len(unc),
           "captured_syncs_per_step": sum(r["sync_warnings"] for r in cap)
           / len(cap),
           "captured_sites": len(sites[1]) if sites else None,
           "off_ms": float(np.median([r["ms"] for r in off])),
           "uncaptured_ms": float(np.median([r["ms"] for r in unc])),
           "captured_ms": float(np.median([r["ms"] for r in cap])),
           "off_host_ms": float(np.median([r["host_ms"] for r in off])),
           "uncaptured_host_ms": float(np.median([r["host_ms"]
                                                  for r in unc])),
           "captured_host_ms": float(np.median([r["host_ms"]
                                                for r in cap]))}
    out["captured_marginal_ms"] = out["captured_ms"] - out["uncaptured_ms"]
    out["captured_marginal_host_ms"] = out["captured_host_ms"] \
        - out["uncaptured_host_ms"]
    _log("[observe] (c) syncs and step ms %s" % json.dumps(
        {k: v for k, v in out.items() if k != "rows"}))
    assert cap and unc, rows
    assert out["uncaptured_syncs_per_step"] <= out["off_syncs_per_step"], out
    return out, tr


def obs_profiler(mx, ck, np, torch, tr, batches, workdir):
    """(e): mx.profiler's start/stop/dumps around 3 ResNet-50 steps (the
    DEVICE section names K1's kernel and the convolutions), its dump()
    merged with the span trace of the same steps by trace_merge (both
    planes), then OBS_SESSIONS one-step sessions of the Module MLP as
    they come and as many with 50 ms of idle before and after the step
    inside the session, counting the sessions that recorded CUDA
    activity and those that recorded every kernel they launched."""
    from mxnet_tpu_torch import config, profiler, trace_merge
    from mxnet_tpu_torch import telemetry as tt
    d = os.path.join(workdir, "observe")
    trace = os.path.join(d, "profiled.trace.json")
    export = os.path.join(d, "profile.json")
    profiler.set_config(filename=export)
    table, attempts = None, 0
    for attempts in range(1, PROFILE_ATTEMPTS + 1):
        config.set("tracing.sink", "chrome:" + trace)
        profiler.start()
        for x, y in batches[:3]:
            tr.step(x, y)
        profiler.stop()
        config.unset("tracing.sink")
        if not profiler.empty_session():
            table = profiler.dumps()
            break
    dev = profiler.device_op_events()
    path = profiler.dump()
    stats = trace_merge.merge_files(trace, path,
                                    os.path.join(d, "merged.trace.json"))
    with open(os.path.join(d, "merged.trace.json")) as f:
        merged = json.load(f)["traceEvents"]
    names_dev = {e.get("name", "") for e in merged
                 if e.get("pid", 0) >= trace_merge.DEVICE_PID_BASE}
    names_host = {e.get("name", "") for e in merged
                  if e.get("pid") == trace_merge.HOST_PID}
    conv = ("conv", "fprop", "dgrad", "wgrad", "implicit", "xmma")

    mod, mbatch = _mlp_module(mx), _mlp_batch(mx, np)
    for _ in range(2):
        mod.train_step(mbatch)

    def session(pad):
        torch.cuda.synchronize()
        profiler.start()
        if pad:
            time.sleep(0.05)
        mod.train_step(mbatch)
        if pad:
            torch.cuda.synchronize()
            time.sleep(0.05)
        profiler.stop()
        recorded, launched = profiler.session_kernels()
        return {"cuda": not profiler.empty_session(),
                "events": sum(len(v) for v in
                              profiler.device_op_events().values()),
                "kernels": recorded, "launched": launched}
    e0 = tt.counter("profiler.empty_sessions").value
    p0 = tt.counter("profiler.partial_sessions").value
    plain = [session(False) for _ in range(OBS_SESSIONS)]
    padded = [session(True) for _ in range(OBS_SESSIONS)]
    profiler.set_config(filename=None)
    out = {"attempts": attempts, "table_lines": (table or "").splitlines()[
        :40], "device_kernels": len(dev),
        "k1_in_device_section": any("sgd_multi" in n for n in dev),
        "conv_in_device_section": any(any(k in n.lower() for k in conv)
                                      for n in dev),
        "merge": stats, "merged_device_has_k1": any(
            "sgd_multi" in n for n in names_dev),
        "merged_host_has_step": "spmd.step" in names_host,
        "sessions": OBS_SESSIONS,
        "sessions_with_cuda": sum(s["cuda"] for s in plain),
        "padded_sessions_with_cuda": sum(s["cuda"] for s in padded),
        "empty_sessions_counted": tt.counter(
            "profiler.empty_sessions").value - e0,
        "complete_sessions": sum(s["kernels"] >= s["launched"] > 0
                                 for s in plain),
        "complete_padded_sessions": sum(s["kernels"] >= s["launched"] > 0
                                        for s in padded),
        "partial_sessions_counted": tt.counter(
            "profiler.partial_sessions").value - p0,
        "plain": plain, "padded": padded}
    _log("[observe] (e) profiler %s" % json.dumps(
        {k: v for k, v in out.items() if k not in ("plain", "padded",
                                                   "table_lines")}))
    assert table is not None, out
    assert out["k1_in_device_section"] and out["conv_in_device_section"], out
    assert "Device ops" in table, out
    assert out["merged_device_has_k1"] and out["merged_host_has_step"], out
    assert out["empty_sessions_counted"] == 2 * OBS_SESSIONS - (
        out["sessions_with_cuda"] + out["padded_sessions_with_cuda"]), out
    return out


def obs_capture_cost(mx, ck, np, torch, workdir):
    """(d): bench.py numerics_overhead_config on the card's Module MLP
    (fused Executor step, K3): interleaved off/step:10 pass pairs and one
    step:1 pass, the publish/poll host seam at the MLP's site count, and
    the step ms with the telemetry and tracing sinks off and on."""
    import statistics
    import tempfile
    from mxnet_tpu_torch import config, numerics
    from mxnet_tpu_torch import telemetry as tt
    mod = _mlp_module(mx)
    batch = _mlp_batch(mx, np)
    sync = mod._exec.arg_dict["fc0_weight"]

    def one_pass(spec, n):
        config.set("numerics.capture", spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            mod.train_step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        numerics.poll("module", block=True)
        return n / dt
    _zero_counts(torch, tt, ck)
    try:
        for spec in ("step:1", ""):
            config.set("numerics.capture", spec)
            for _ in range(3):
                mod.train_step(batch)
        ratios, off_best, on10_best = [], 0.0, 0.0
        for _ in range(OBS_PASSES):
            off = max(one_pass("", OBS_ITERS), one_pass("", OBS_ITERS))
            on10 = max(one_pass("step:10", OBS_ITERS),
                       one_pass("step:10", OBS_ITERS))
            ratios.append(on10 / off)
            off_best, on10_best = max(off_best, off), max(on10_best, on10)
        on1_best = max(one_pass("step:1", OBS_ITERS),
                       one_pass("step:1", OBS_ITERS))
        sites = len(numerics.latest("module")[1])
    finally:
        config.unset("numerics.capture")
    steps = ck.LAUNCHES["adam_step"]
    stats = {"site%d" % i: numerics.summarize(torch.ones(4, device="cuda"))
             for i in range(sites)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OBS_PUBLISH_N):
        numerics.publish("bench_numerics", i, stats)
        numerics.poll("bench_numerics")
    publish_us = (time.perf_counter() - t0) / OBS_PUBLISH_N * 1e6
    numerics.poll("bench_numerics", block=True)
    # the sinks, as module_train_config toggles them
    d = tempfile.mkdtemp(prefix="observe_sinks_", dir=workdir)
    sink_ms = {}
    for name, knob, value in (
            ("off", None, None),
            ("telemetry", "telemetry.sink", "jsonl:" + os.path.join(
                d, "steps.jsonl")),
            ("tracing", "tracing.sink", "chrome:" + os.path.join(
                d, "spans.trace.json")), ("off_again", None, None)):
        if knob:
            config.set(knob, value)
        try:
            sink_ms[name] = 1e3 / max(one_pass("", OBS_ITERS),
                                      one_pass("", OBS_ITERS))
        finally:
            if knob:
                config.unset(knob)
    off_us = 1e6 / off_best
    out = {"passes": OBS_PASSES, "iters": OBS_ITERS, "sites": sites,
           "off_step_ms": 1e3 / off_best,
           "step10_step_ms": 1e3 / on10_best,
           "step1_step_ms": 1e3 / on1_best,
           "step1_marginal_ms": 1e3 / on1_best - 1e3 / off_best,
           "publish_poll_us": publish_us,
           "overhead_pct": publish_us / (10 * off_us) * 100,
           "paired_median_pct": (1.0 / statistics.median(ratios) - 1.0)
           * 100, "pair_ratios": ratios,
           "sink_step_ms": sink_ms, "adam_step_launches": steps}
    _log("[observe] (d) capture cost %s" % json.dumps(out))
    return out


def obs_monitor(mx, ck, np, torch):
    """(f): ``fit(monitor=Monitor(1, pattern=".*weight"))`` on the Module
    MLP for OBS_MONITOR_BATCHES batches on the card, through the fused
    step and K3 (one launch a step), against the same fit on the CPU from
    the same weights: every (step, name) row within 1e-5 relative."""
    from mxnet_tpu_torch import telemetry as tt

    class Rows(mx.monitor.Monitor):
        def toc_print(self):
            self.rows = getattr(self, "rows", []) + self.toc()
    rng = np.random.RandomState(SEED + 91)
    n = OBS_MONITOR_BATCHES * MLP_BATCH
    X = rng.randn(n, MLP_FEAT).astype(np.float32)
    Y = (rng.rand(n) * MLP_CLASSES).astype(np.float32)
    init = {k: v.asnumpy() for k, v in _mlp_module(mx).get_params()[0]
            .items()}
    got = {}
    for where in ("card", "cpu"):
        ctx = mx.gpu(0) if where == "card" else mx.cpu()
        with ctx:
            mon = Rows(1, pattern=".*weight")
            mod = mx.mod.Module(_mlp_symbol(mx), context=ctx)
            it = mx.io.NDArrayIter(X, Y, batch_size=MLP_BATCH)
            if where == "card":
                _zero_counts(torch, tt, ck)
            mod.fit(it, num_epoch=1, optimizer="adam",
                    optimizer_params={"learning_rate": MLP_LR},
                    arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in init.items()}, monitor=mon)
            if where == "card":
                torch.cuda.synchronize()
                launches = dict(ck.LAUNCHES)
                fused = tt.snapshot()["counters"]["fused_steps"]
        got[where] = {(s, k): float(v) for s, k, v in mon.rows}
    rel = max(abs(got["card"][k] - v) / max(abs(v), 1e-30)
              for k, v in got["cpu"].items())
    out = {"batches": OBS_MONITOR_BATCHES, "rows": len(got["card"]),
           "same_rows": sorted(got["card"]) == sorted(got["cpu"]),
           "max_rel_err": rel, "launches": launches, "fused_steps": fused}
    _log("[observe] (f) monitor %s" % json.dumps(out))
    want = dict.fromkeys(launches, 0)
    want["adam_step"] = OBS_MONITOR_BATCHES
    assert out["same_rows"] and out["rows"] == OBS_MONITOR_BATCHES * 9, out
    assert rel <= 1e-5, out
    assert launches == want and fused == OBS_MONITOR_BATCHES, out
    return out


def obs_watchdog(mx, np, workdir):
    """(g): a data iterator that sleeps twice the deadline inside
    io.prefetch yields exactly one watchdog report, whose open spans
    include io.prefetch."""
    import shutil
    from mxnet_tpu_torch import config, tracing
    d = os.path.join(workdir, "observe", "watchdog")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)

    class Slow(mx.io.NDArrayIter):
        slept = False

        def next(self):
            if not self.slept:
                self.slept = True
                time.sleep(2 * OBS_WATCHDOG_S)
            return super().next()
    config.set("tracing.watchdog_dir", d)
    config.set("tracing.watchdog", OBS_WATCHDOG_S)
    try:
        with mx.cpu():
            got = list(mx.io.PrefetchingIter(Slow(
                data=np.zeros((4, 2), np.float32),
                label=np.zeros((4,), np.float32), batch_size=4)))
    finally:
        config.unset("tracing.watchdog")
        config.unset("tracing.watchdog_dir")
    reports = sorted(os.listdir(d))
    spans = []
    if reports:
        with open(os.path.join(d, reports[0])) as f:
            rep = tracing.validate_watchdog_report(json.load(f))
        spans = [s["name"] for s in rep["open_spans"]]
    out = {"deadline_s": OBS_WATCHDOG_S, "batches": len(got),
           "reports": reports, "open_spans": spans}
    _log("[observe] (g) watchdog %s" % json.dumps(out))
    assert len(reports) == 1 and "io.prefetch" in spans, out
    return out


def observe_phase(mx, ck, np, torch, card, workdir):
    """Phase observe: (a) summarize on the card, (b) the TransformerLM
    with and without capture, (c) ResNet-50's abort with forensics, the
    sinks and the watchdog, and the sync count, (d) the capture's cost,
    (e) mx.profiler, (f) Monitor, (g) the watchdog firing."""
    t0 = time.perf_counter()
    marks = [("start", t0)]

    def mark(name):
        marks.append((name, time.perf_counter()))
    out = {"card": card, "summarize": obs_summarize(np, torch)}
    mark("a")
    out["lm"] = obs_lm(mx, ck, np, torch)
    mark("b")
    prev = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = True
    try:
        batches = _res_batches(np, torch, 8, (OBS_BATCH, 3, RESNET_HW,
                                              RESNET_HW), 1000, SEED + 81)
        net = _obs_net(mx, np, torch, batches)
        out["abort"] = _obs_abort(mx, ck, np, torch, net, batches, workdir)
        mark("c_abort")
        out["sync_ab"], tr = _obs_sync_ab(mx, np, torch, net, batches,
                                          workdir)
        mark("c_sync_ab")
        _zero_counts(torch, mx.telemetry, ck)
        out["profiler"] = obs_profiler(mx, ck, np, torch, tr, batches,
                                       workdir)
        torch.cuda.synchronize()
        out["profiler"]["launches"] = dict(ck.LAUNCHES)
        mark("e")
        del tr, net, batches
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic \
            = prev
    torch.cuda.empty_cache()
    out["capture_cost"] = obs_capture_cost(mx, ck, np, torch, workdir)
    out["capture_cost"]["resnet50_captured_marginal_ms"] = \
        out["sync_ab"]["captured_marginal_ms"]
    out["capture_cost"]["resnet50_captured_sites"] = \
        out["sync_ab"]["captured_sites"]
    mark("d")
    out["monitor"] = obs_monitor(mx, ck, np, torch)
    mark("f")
    out["watchdog"] = obs_watchdog(mx, np, workdir)
    mark("g")
    out["part_seconds"] = {name: t - prev for (_, prev), (name, t)
                           in zip(marks, marks[1:])}
    out["seconds"] = time.perf_counter() - t0
    _log("[observe] part seconds %s" % json.dumps(out["part_seconds"]))
    _log("[observe] phase seconds %.1f" % out["seconds"])
    return out


def _observe_launches(obs):
    """Launches of K1, K2f, K2dq, K2dkv and K3 in phase observe's counted
    runs, by kernel and run."""
    lm = obs["lm"]["launches"]
    by = {k: {"observe_lm_" + run: lm[run][k] for run in lm}
          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    by["sgd_step"] = {
        "observe_resnet_abort": obs["abort"]["launches"]["sgd_step"],
        "observe_resnet_profiled": obs["profiler"]["launches"]["sgd_step"]}
    by["adam_step"] = {
        "observe_lm_" + run: lm[run]["adam_step"] for run in lm}
    by["adam_step"]["observe_mlp_capture_cost"] = \
        obs["capture_cost"]["adam_step_launches"]
    by["adam_step"]["observe_monitor"] = \
        obs["monitor"]["launches"]["adam_step"]
    return by


# ----------------------------------------------------------- phase cost
#: phase cost (a): decode-step p50 with every new knob on beside off,
#: alternating pairs
COST_AB_PAIRS = 5
#: (a)'s SLO objectives
COST_SLO = "availability=99.9,latency_p99_ms=60000"
#: (a)'s watchdog deadline (armed, never reached) and (b)'s (reached)
COST_WATCHDOG_S = 60.0
COST_STALL_WATCHDOG_S = 1.0
#: (a): a prefill's counted FLOPs against the analytic count
COST_FLOPS_RTOL = 0.02
#: (c): the int8 ResNet-50 served at drift_every=4, max batch 32, 64
#: requests of 32 rows (8 distinct batches), so 16 sampled dispatches
COST_DRIFT_EVERY = 4
COST_DRIFT_REQUESTS = 64
COST_DRIFT_DISTINCT = 8
#: (c): the twin's amaxes against the float forward's site inputs
COST_TWIN_RTOL = 1e-6
#: (d): the decode site the paged search runs at (B=8, H=12, D=64, 128
#: pages of 16)
COST_PAGED_SITE = ((DECODE_B, 12, 1, 64), (DECODE_B, 12, 128 * 16, 64))
#: (f): the TransformerLM's steps under perf.profile=step:2
COST_PROFILE_STEPS = 6


def _http(addr, path):
    """``(status, body)`` of a GET on the exporter at ``addr``."""
    import urllib.error
    import urllib.request
    url = "http://%s:%d%s" % (addr[0], addr[1], path)
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _parse_prometheus(text):
    """The samples of a Prometheus text exposition: ``{name{labels}:
    value}``; raises on a line that is neither a comment nor a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?) "
                     r"(-?[0-9.e+\-]+|NaN|[+-]Inf)$", line)
        if m is None:
            raise AssertionError("not a Prometheus sample: %r" % line)
        out[m.group(1)] = float(m.group(3).replace("Inf", "inf"))
    return out


def _cost_knobs(mx, on, files=None):
    """Every knob (a) turns on: the exporter, the access log, the SLOs,
    both sinks and the watchdog; or all of them off."""
    names = ("obs.listen", "obs.access_log", "obs.slo", "tracing.sink",
             "telemetry.sink", "tracing.watchdog")
    if not on:
        for n in names:
            mx.config.unset(n)
        return
    mx.config.set("obs.listen", "127.0.0.1:0")
    mx.config.set("obs.access_log", "jsonl:" + files["access"])
    mx.config.set("obs.slo", COST_SLO)
    mx.config.set("tracing.sink", "chrome:" + files["trace"])
    mx.config.set("telemetry.sink", "jsonl:" + files["telemetry"])
    mx.config.set("tracing.watchdog", COST_WATCHDOG_S)


def _prefill_flops(cfg, s):
    """The analytic FLOPs of one prefill at bucket ``s`` (B=1): 2 x the
    matmul parameters of the layers x tokens, the LM head at the last
    position, and causal attention (4 x head dim x heads a query-key
    pair)."""
    L, D, F_, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    per_layer = D * 3 * D + D * D + 2 * D * F_
    return (2 * per_layer * L * s + 2 * D * V
            + L * 4 * cfg.head_dim * cfg.num_heads * s * (s + 1) // 2)


def _decode_flops(cfg, b, keys):
    """The analytic FLOPs of one decode step of ``b`` rows over a page
    table of ``keys`` slots a row: 2 x the matmul parameters of the layers
    and the LM head a row, and attention over every slot of the table (the
    paged kernel's charge is its launch geometry, as a compiled program's
    static cost: mx.perf reads no length from the card)."""
    L, D, F_, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    per_layer = D * 3 * D + D * D + 2 * D * F_
    return (2 * per_layer * L * b + 2 * D * V * b
            + L * 4 * cfg.head_dim * cfg.num_heads * b * keys)


def cost_serve(mx, ck, np, torch, workdir):
    """Phase cost (a) and (b): generation serving at full width with every
    new knob on (exporter, access log, SLOs, both sinks, the watchdog)
    against the same traffic with them off, then a planted stall."""
    from mxnet_tpu_torch import obs, perf
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch import tracing
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    cdir = os.path.join(workdir, "cost")
    os.makedirs(cdir, exist_ok=True)
    # the registry holds what earlier phases counted (phase 3 serves a
    # model named "lm" too)
    perf.reset()
    cfg = TransformerLMConfig()
    L = cfg.num_layers
    model = TransformerLM(cfg).init(SEED)
    prefix = os.path.join(cdir, "lm")
    mx.deploy.export_generation(model, None, prefix)
    del model
    prompts = _prompts(np, cfg.vocab_size)
    mx.config.set("serving.kv_pages", KV_PAGES)
    srv = mx.serving.Server()
    out = {}
    try:
        eng = srv.register("lm", prefix, generate=True)
        srv.start()

        def run():
            # the engine held while the requests queue: one admission
            # order, so one launch count, whatever the host's timing
            _zero_counts(torch, tt, ck)
            with eng._held():
                futs = [srv.submit_generate("lm", pr, NEW_TOKENS)
                        for pr in prompts]
            streams = [f.result(timeout=600) for f in futs]
            prefills, decodes, launches, snap = _read_counts(
                torch, tt, ck, L, "paged_decode_pool_bf16")
            assert prefills == len(prompts), prefills
            return (streams, launches,
                    snap["timers"]["serving.decode_step_ms"]["p50"])

        # the first run counts every bucket's program (mx.perf)
        base, base_launches, _ = run()
        progs = {p["key"]: p for p in perf.programs("serving")
                 if p["key"].startswith("lm/")}
        buckets = sorted(eng._prefill)
        widths = sorted(eng._decode)
        want = {"lm/prefill-s%d" % s for s in buckets} | \
            {"lm/decode-w%d" % w for w in widths}
        assert set(progs) == want, (sorted(progs), sorted(want))
        flops = {}
        for s in buckets:
            got = progs["lm/prefill-s%d" % s]["flops"]
            ref = _prefill_flops(cfg, s)
            flops[s] = {"counted": got, "analytic": ref,
                        "rel": abs(got - ref) / ref}
            assert flops[s]["rel"] <= COST_FLOPS_RTOL, (s, flops[s])
        dflops = {}
        for w in widths:
            got = progs["lm/decode-w%d" % w]["flops"]
            ref = _decode_flops(cfg, eng.decode_slots,
                                w * eng.predictor.page_size)
            dflops[w] = {"counted": got, "analytic": ref,
                         "rel": abs(got - ref) / ref}
            assert dflops[w]["rel"] <= COST_FLOPS_RTOL, (w, dflops[w])
        out["perf_records"] = {
            "prefill_buckets": buckets, "decode_widths": widths,
            "prefill_flops": flops, "decode_flops": dflops,
            "decode_roofline": {w: progs["lm/decode-w%d" % w]["roofline"]
                                for w in widths}}
        _log("[cost] perf records %s" % json.dumps(out["perf_records"]))

        p50 = {"on": [], "off": []}
        checked = None
        for i in range(COST_AB_PAIRS):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                files = {k: os.path.join(cdir, "%s_%d.%s" % (k, i, ext))
                         for k, ext in (("access", "jsonl"),
                                        ("trace", "json"),
                                        ("telemetry", "jsonl"))}
                for path in files.values():
                    if os.path.exists(path):
                        os.remove(path)
                _cost_knobs(mx, on, files)
                try:
                    streams, launches, step_p50 = run()
                    if on and checked is None:
                        checked = _cost_checks(mx, obs, tracing, files,
                                               len(prompts))
                finally:
                    _cost_knobs(mx, False)
                p50["on" if on else "off"].append(step_p50)
                assert launches == base_launches, (on, launches,
                                                   base_launches)
                assert all(np.array_equal(a, b)
                           for a, b in zip(streams, base))
        out["checks"] = checked
        out["launches"] = base_launches
        out["decode_step_p50_ms"] = {
            "on": p50["on"], "off": p50["off"],
            "median_on": float(np.median(p50["on"])),
            "median_off": float(np.median(p50["off"]))}
        _log("[cost] serving, every new knob on beside off: decode-step "
             "p50 %s" % json.dumps(out["decode_step_p50_ms"]))
        out["stall"] = _cost_stall(mx, srv, eng, prompts, cdir)
    finally:
        _cost_knobs(mx, False)
        srv.stop()
        mx.config.unset("serving.kv_pages")
    return out


def _cost_checks(mx, obs, tracing, files, n_requests):
    """(a)'s gates on one run with every knob on: /metrics parses,
    /healthz answers 200, one valid ok access record a request whose id
    the Chrome trace holds, the serving.submit and serving.dispatch
    spans."""
    addr = obs.exporter_address()
    code, text = _http(addr, "/metrics")
    samples = _parse_prometheus(text)
    assert code == 200 and samples, code
    hcode, health = _http(addr, "/healthz")
    assert hcode == 200, (hcode, health)
    obs.flush_access_log()
    with open(files["access"]) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for r in recs:
        obs.validate_access_record(r)
    assert len(recs) == n_requests, len(recs)
    assert all(r["outcome"] == "ok" for r in recs), recs
    tracing.flush()
    events = tracing.load_trace(files["trace"])
    names = {e.get("name") for e in events}
    # the access log writes the span's trace id as a string
    traces = {str(e.get("args", {}).get("trace_id")) for e in events}
    ids = [r.get("request_id") for r in recs]
    assert all(i is not None and i in traces for i in ids), ids
    assert {"serving.submit", "serving.dispatch"} <= names, sorted(names)
    out = {"metrics_samples": len(samples),
           "slo_burn_5m": samples.get(
               'mxnet_tpu_slo_burn_rate{window="5m"}'),
           "healthz": json.loads(health)["healthy"],
           "access_records": len(recs),
           "access_flops_per_request_max": max(r.get("flops") or 0
                                               for r in recs),
           "trace_events": len(events),
           "spans": sorted(n for n in names if n and
                           n.startswith("serving."))}
    _log("[cost] knobs on: %s" % json.dumps(out))
    return out


def _cost_stall(mx, srv, eng, prompts, cdir):
    """(b): the engine's loop held with requests waiting, the watchdog at
    COST_STALL_WATCHDOG_S: its report holds the engine's stall-probe
    snapshot, /healthz answers non-200 while the loop is held and 200
    again once it runs."""
    import glob
    from mxnet_tpu_torch import obs
    wdir = os.path.join(cdir, "watchdog")
    os.makedirs(wdir, exist_ok=True)
    mx.config.set("tracing.watchdog_dir", wdir)
    mx.config.set("tracing.watchdog", COST_STALL_WATCHDOG_S)
    mx.config.set("obs.listen", "127.0.0.1:0")
    try:
        addr = obs.exporter_address()
        before = _http(addr, "/healthz")[0]
        with eng._held():
            futs = [srv.submit_generate("lm", pr[:64], 4)
                    for pr in prompts[:2]]
            time.sleep(3 * COST_STALL_WATCHDOG_S)
            during, body = _http(addr, "/healthz")
        for f in futs:
            f.result(timeout=120)
        after = None
        for _ in range(50):
            after = _http(addr, "/healthz")[0]
            if after == 200:
                break
            time.sleep(0.1)
        reports = []
        for path in sorted(glob.glob(os.path.join(
                wdir, "watchdog_report_*.json"))):
            with open(path) as f:
                rep = json.load(f)
            stalls = {k: v for k, v in (rep.get("stalls") or {}).items()
                      if k == eng._probe_name}
            if stalls:
                reports.append(stalls[eng._probe_name])
    finally:
        mx.config.unset("tracing.watchdog")
        mx.config.unset("tracing.watchdog_dir")
        mx.config.unset("obs.listen")
    reasons = json.loads(body).get("sources", {})
    out = {"healthz_before": before, "healthz_held": during,
           "healthz_after": after, "reports_with_the_probe": len(reports),
           "probe_snapshot": reports[0] if reports else None,
           "held_reasons": [r for s in reasons.values()
                            for r in s.get("reasons", [])]}
    _log("[cost] planted stall %s" % json.dumps(out))
    assert before == 200 and during != 200 and after == 200, out
    assert reports and reports[0]["queued"] + reports[0]["active"] > 0, out
    return out


def _site_inputs_float(torch, pred, x):
    """The float forward of a loaded int8 artifact's graph (its
    dequantized weights, no recoloring) with each int8 site's input
    ``|max|`` recorded by an override at the site: ``{site: amax}``."""
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.quantization import _twin_sites
    from mxnet_tpu_torch.symbol.symbol import _eval_symbol
    seen = {}

    def recorder(name, op):
        fn = registry.get(op).fn

        def call(data, *args, **attrs):
            seen[name] = float(data.float().abs().amax())
            return fn(data, *args, **attrs)
        return call
    overrides = {id(node): recorder(name, node.op)
                 for name, node in _twin_sites(pred._graph, pred.meta)}
    env = dict(pred._params)
    env[pred._input] = x
    with torch.inference_mode():
        _eval_symbol(pred._graph, env, False, overrides=overrides)
    return seen


def cost_drift(mx, np, torch, workdir):
    """Phase cost (c): the int8 ResNet-50 v1 served at
    quant.drift_every=4: a drift gauge for every stats_sites entry, and
    the twin's amaxes those of each site's input in the float forward on
    the same batch."""
    from mxnet_tpu_torch import deploy, quantization
    from mxnet_tpu_torch import telemetry as tt
    rng = np.random.RandomState(SEED + 1)
    shape = (PRED_BATCH, 3, PRED_HW, PRED_HW)
    qprefix = os.path.join(workdir, "resnet50_int8")
    t0 = time.perf_counter()
    reused = os.path.exists(qprefix + "-stats.json")
    if not reused:
        # alone, this phase makes the export phase 8 makes in a full run
        calib = [rng.uniform(size=shape).astype(np.float32)
                 for _ in range(2)]
        net = _pred_net(mx, np, torch)
        cal = quantization.calibrate(net, calib, mode="naive")
        quantization.export_quantized(net, qprefix, cal)
        del net
    export_s = time.perf_counter() - t0
    batches = [rng.uniform(size=shape).astype(np.float32)
               for _ in range(COST_DRIFT_DISTINCT)]
    mx.config.set("quant.drift_every", COST_DRIFT_EVERY)
    srv = mx.serving.Server(max_batch=PRED_MAX_BATCH,
                            max_queue_delay_ms=PRED_DELAY_MS)
    try:
        entry = srv.register("r50q", qprefix, quantized=True)
        srv.start()
        sites = list(entry.drift_sites)
        tt.reset()
        futs = [srv.submit("r50q", batches[i % COST_DRIFT_DISTINCT])
                for i in range(COST_DRIFT_REQUESTS)]
        for f in futs:
            f.result(timeout=600)
        # the batcher samples after it resolves a batch's futures: the
        # drained stop lets the last sample land
        srv.stop()
        torch.cuda.synchronize()
        snap = tt.snapshot()
        g = snap["gauges"]
        missing = [s for s in sites
                   if "quant.drift_ratio.r50q.%s" % s not in g]
        pred = entry.predictor
        x = torch.from_numpy(batches[0]).cuda()
        twin = entry.drift_call(x).cpu().numpy()
        flt = _site_inputs_float(torch, pred, x)
        rel = max(abs(float(a) - flt[s]) / max(abs(flt[s]), 1e-30)
                  for s, a in zip(sites, twin))
        tm = snap["timers"]
        out = {"reused_export": reused, "export_s": export_s,
               "stats_sites": len(sites),
               "dispatches": snap["counters"].get(
                   "serving.batch_dispatches", 0),
               "drift_samples": snap["counters"].get(
                   "serving.drift_samples", 0),
               "drift_gauges": sum(1 for k in g if k.startswith(
                   "quant.drift_ratio.r50q.")),
               "missing_gauges": missing,
               "ratio_range": [min(g["quant.drift_ratio.r50q.%s" % s]
                                   for s in sites if s not in missing),
                               max(g["quant.drift_ratio.r50q.%s" % s]
                                   for s in sites if s not in missing)],
               "twin_vs_float_max_rel": rel,
               "unsampled_dispatch_ms_p50": tm["serving.dispatch_ms"]["p50"],
               "twin_ms_p50": tm["serving.drift_ms"]["p50"]}
        out["sampled_dispatch_ms_p50"] = out["unsampled_dispatch_ms_p50"] \
            + out["twin_ms_p50"]
        _log("[cost] drift %s" % json.dumps(out))
        assert sites and not missing, out
        assert out["drift_samples"] == COST_DRIFT_REQUESTS \
            // COST_DRIFT_EVERY, out
        assert rel <= COST_TWIN_RTOL, out
    finally:
        srv.stop()
        mx.config.unset("quant.drift_every")
    return out


def cost_autotune(mx, ck, np, torch, workdir):
    """Phase cost (d): perf.autotune=measure into a fresh cache file: K4's
    keys per split at the decode site (bf16 and int8 pages), K1's chunk
    over ResNet-50's 193 tensors, K3's over the TransformerLM's, K2f's one
    configuration at the training shape; every candidate within its
    contract; then, after autotune.reset(), the winners read back from the
    file, applied (the launch configurations show them) and giving the
    same outputs."""
    from mxnet_tpu_torch import autotune as at
    from mxnet_tpu_torch.models.transformer import TransformerLMConfig
    cache = os.path.join(workdir, "cost", "autotune.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    cfg = TransformerLMConfig()
    mx.config.set("perf.autotune", "measure")
    mx.config.set("perf.autotune_cache", cache)
    out = {}
    try:
        qs, ks = COST_PAGED_SITE
        paged = {q8: at.search_paged(qs, ks, "bfloat16", q8)
                 for q8 in (False, True)}
        sgd = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        adam = mx.optimizer.Adam(learning_rate=TRAIN_LR)
        rshapes = _resnet_shapes(mx, np)
        lshapes = list(_adam_shapes(cfg).values())
        fused = {"sgd": at.search_fused(sgd, rshapes, "bfloat16",
                                        "bfloat16"),
                 "adam": at.search_fused(adam, lshapes, "bfloat16",
                                         "bfloat16")}
        attn = at.search_attention((TRAIN_B, 12, TRAIN_S, 64),
                                   (TRAIN_B, 12, TRAIN_S, 64), "bfloat16",
                                   True)
        for q8, e in paged.items():
            assert all(v <= e["tol"] for v in e["row_rel_err"].values()), e
            assert e.get("keys_per_split"), e
        for e in fused.values():
            assert all(e["bitwise"].values()) and e.get("chunk"), e
        assert attn["parity"], attn
        out["search"] = {"paged_bf16": paged[False], "paged_int8": paged[True],
                         "sgd_resnet50": fused["sgd"],
                         "adam_transformer_lm": fused["adam"],
                         "attention_train": attn}
        _log("[cost] autotune search %s" % json.dumps(out["search"]))

        # a fresh process's view: the winners from the file only
        at.reset()
        mx.config.set("perf.autotune", "auto")
        applied = {}
        ck.reset_launches()
        for q8, e in paged.items():
            q, kp, vp, table, lens, kw = at._paged_inputs(
                qs[0], qs[1], qs[3], ks[2] // 16, 16, "bfloat16", q8)
            o = mx.kernels.paged_attention_pool(q, kp, vp, table, lens, **kw)
            o_pick = ck.paged_attention_pool(q, kp, vp, table, lens,
                                             keys_per_split=e[
                                                 "keys_per_split"], **kw)
            key = "%s/keys=%d" % ("paged_decode_pool_int8" if q8 else
                                  "paged_decode_pool_bf16",
                                  e["keys_per_split"])
            applied["paged_int8" if q8 else "paged_bf16"] = {
                "keys_per_split": e["keys_per_split"],
                "launch_configs": dict(ck.LAUNCH_CONFIGS),
                "same_output": _same_bits(torch, o, o_pick)}
            assert ck.LAUNCH_CONFIGS.get(key, 0) == 2, (key,
                                                        ck.LAUNCH_CONFIGS)
            assert applied["paged_int8" if q8 else "paged_bf16"][
                "same_output"]
            ck.reset_launches()
        for name, opt, shapes, e in (("sgd", sgd, rshapes, fused["sgd"]),
                                     ("adam", adam, lshapes,
                                      fused["adam"])):
            assert mx.kernels.fused_step_enabled(opt)
            applied[name] = _cost_fused_applied(ck, torch, at, name, opt,
                                                shapes, e["chunk"])
        out["applied"] = applied
        out["cache"] = {"path": cache, "entries": len(
            json.load(open(cache))["entries"])}
        _log("[cost] autotune applied from the file %s"
             % json.dumps(out["applied"]))
    finally:
        mx.config.unset("perf.autotune")
        mx.config.unset("perf.autotune_cache")
        at.reset()
    return out


def _cost_fused_applied(ck, torch, at, kind, opt, shapes, chunk):
    """K1 (``kind`` 'sgd') or K3 over ``shapes`` through the optimizer's
    own fused step (``step_fused_multi``), whose new launch table reads
    the list's chunk from the cache file: the table carries it, one
    launch at that chunk, and the update bitwise the plain version's."""
    ws, gs, st, outs = at._fused_tensors(
        shapes, "bfloat16", "bfloat16", "adam" if kind == "adam" else
        "sgd/mom", seed=3)
    n = len(ws)
    lrs, wds = [0.01] * n, [1e-4] * n
    pw = [w.clone() for w in ws]
    ps = [[x.clone() for x in col] for col in st]
    po = [o.clone() for o in outs]
    ck.reset_launches()
    if kind == "adam":
        opt.step_fused_multi(ws, gs, list(zip(st[0], st[1])), lrs, wds, 1,
                             outs=outs)
        lr_ts = [opt._lr_t_of(lr, 1) for lr in lrs]
        ck.fused_adam_step_multi_plain(pw, gs, ps[0], ps[1], lr_ts, wds,
                                       opt.beta1, opt.beta2, opt.epsilon,
                                       outs=po)
    else:
        opt.step_fused_multi(ws, gs, st[0], lrs, wds, 1, outs=outs)
        ck.fused_sgd_step_multi_plain(pw, gs, ps[0], lrs, wds, opt.momentum,
                                      outs=po)
    torch.cuda.synchronize()
    table = opt._launch_tables[ws[0].data_ptr()]
    key = "%s_step/chunk=%d" % (kind, chunk)
    same = all(_same_bits(torch, a, b) for a, b in zip(
        ws + [x for col in st for x in col] + outs,
        pw + [x for col in ps for x in col] + po))
    out = {"chunk": chunk, "table_chunk": table.chunk,
           "launch_configs": dict(ck.LAUNCH_CONFIGS), "bitwise": same}
    assert table.chunk == chunk, out
    assert ck.LAUNCH_CONFIGS == {key: 1} and same, out
    return out


def cost_measure(mx, ck, np, torch, card):
    """Phase cost (e): ``kernels.measure`` on K2f at the training shape:
    the record's FLOPs the analytic causal count; the achieved rate
    against 989 TFLOP/s."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    B, H, S, D = TRAIN_B, 12, TRAIN_S, 64
    q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ck.reset_launches()
    (o, lse), rec = mx.kernels.measure("flash_fwd/train", ck.flash_attention,
                                       q, k, v, True)
    want = 4 * B * H * D * S * (S + 1) // 2
    launches = ck.LAUNCHES["flash_fwd"]
    ms = _device_ms(torch, lambda: ck.flash_attention(q, k, v, causal=True),
                    iters=20)
    out = {"card": card, "flops": rec["flops"], "analytic": want,
           "bytes": rec["bytes_accessed"], "roofline": rec["roofline"],
           "launches": launches, "device_ms": ms,
           "achieved_tflops": want / (ms / 1e3) / 1e12 if ms else None,
           "peak_tflops": PEAK_BF16_FLOPS / 1e12}
    out["share_of_peak"] = (out["achieved_tflops"] / out["peak_tflops"]
                            if ms else None)
    _log("[cost] kernels.measure %s" % json.dumps(out))
    assert rec["flops"] == want and launches == 1, out
    return out


def cost_profile(mx, ck, np, torch, card, workdir):
    """Phase cost (f): perf.profile=step:2 on the TransformerLM's train
    step as phase 4 trains it (a ``perf.wrap``ped step under
    ``telemetry.step_scope``), 6 steps: a profile folded with the span
    trace, and every step record's flops and mfu present and valid."""
    from mxnet_tpu_torch import perf
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch import tracing
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    cfg = TransformerLMConfig()
    L = cfg.num_layers
    pdir = os.path.join(workdir, "cost", "profile")
    os.makedirs(pdir, exist_ok=True)
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    inp = torch.as_tensor(toks[:, :-1], device="cuda")
    tgt = torch.as_tensor(toks[:, 1:], device="cuda")
    model = TransformerLM(cfg).init(SEED)
    model.requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    opt = mx.optimizer.create("adam", learning_rate=TRAIN_LR,
                              multi_precision=True)
    states = [opt.create_state_multi_precision(i, p)
              for i, p in enumerate(params)]
    index = list(range(len(params)))

    def step():
        model.zero_grad(set_to_none=True)
        loss = model.loss(inp, tgt)
        loss.backward()
        opt.update_multi_precision(index, params, [p.grad for p in params],
                                   states)
        return loss
    prog = perf.wrap(step, "gluon", "transformer_lm/train_step",
                     source="gluon", dtype="bfloat16")
    tele = os.path.join(pdir, "steps.jsonl")
    trace = os.path.join(pdir, "spans.json")
    for path in (tele, trace):
        if os.path.exists(path):
            os.remove(path)
    mx.config.set("perf.profile_dir", pdir)
    mx.config.set("tracing.sink", "chrome:" + trace)
    mx.config.set("telemetry.sink", "jsonl:" + tele)
    mx.config.set("perf.profile", "step:2")
    n0 = len(perf.captures())
    step_ms, losses = [], []
    try:
        _zero_counts(torch, tt, ck)
        for _ in range(COST_PROFILE_STEPS):
            t0 = time.perf_counter()
            with tt.step_scope("gluon", samples=TRAIN_B), \
                    tracing.span("cost.train_step", cat="cost"):
                losses.append(float(prog().detach()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
    finally:
        mx.config.unset("perf.profile")
        mx.config.unset("perf.profile_dir")
        tt.flush()
        mx.config.unset("telemetry.sink")
        mx.config.unset("tracing.sink")
    n = COST_PROFILE_STEPS
    want = dict.fromkeys(launches, 0)
    want.update({"flash_fwd": L * n, "flash_bwd_dq": L * n,
                 "flash_bwd_dkv": L * n, "adam_step": n})
    assert launches == want, (launches, want)
    caps = perf.captures()[n0:]
    metas = []
    for c in caps:
        with open(os.path.join(c, "meta.json")) as f:
            metas.append(json.load(f))
    folded = [m for m in metas if m.get("merged")]
    with open(tele) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    recs = [r for r in recs if r.get("event") == "step"
            and r.get("source") == "gluon"]
    for r in recs:
        tt.validate_step_record(r)
    tokens = TRAIN_B * TRAIN_S
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    matmul_params = L * (D * 3 * D + D * D + 2 * D * F_) + V * D
    product = 2 * cfg.head_dim * cfg.num_heads * TRAIN_B \
        * TRAIN_S * (TRAIN_S + 1) // 2
    phase4_flops = 6 * matmul_params * tokens + L * 9 * product
    # steps 2, 4 and 6: counted already and not under a profiler session
    # (steps 3 and 5 run under one, and their exits write it)
    clean = [1, 3, 5]
    med = float(np.median([step_ms[i] for i in clean]))
    out = {"card": card, "steps": n, "losses": losses, "step_ms": step_ms,
           "captures": len(caps), "folded": len(folded),
           "capture_meta": metas,
           "step_records": len(recs),
           "record_flops": [r.get("flops") for r in recs],
           "record_mfu": [r.get("mfu") for r in recs],
           "perf_flops_per_step": prog.record["flops"],
           "phase4_formula_flops": phase4_flops,
           "phase4_formula_mfu": phase4_flops / (med / 1e3)
           / PEAK_BF16_FLOPS,
           "perf_mfu_unprofiled_steps": [recs[i].get("mfu") for i in clean
                                         if i < len(recs)],
           "launches": launches}
    _log("[cost] profile %s" % json.dumps({k: v for k, v in out.items()
                                           if k != "capture_meta"}))
    assert folded, metas
    assert len(recs) == n and all(
        isinstance(r.get("flops"), (int, float)) and r["flops"] > 0
        and isinstance(r.get("mfu"), (int, float)) and r["mfu"] > 0
        for r in recs), recs
    return out


def cost_phase(mx, ck, np, torch, card, workdir):
    """Phase cost: (a) generation serving with every new knob on beside
    off and (b) a planted stall, (c) the int8 drift twin, (d) autotune
    into a fresh cache, (e) kernels.measure, (f) perf.profile on the
    TransformerLM's train step."""
    t0 = time.perf_counter()
    marks = [("start", t0)]

    def mark(name):
        marks.append((name, time.perf_counter()))
    out = {"card": card}
    out["serve"] = cost_serve(mx, ck, np, torch, workdir)
    mark("a_b")
    torch.cuda.empty_cache()
    out["drift"] = cost_drift(mx, np, torch, workdir)
    mark("c")
    torch.cuda.empty_cache()
    out["autotune"] = cost_autotune(mx, ck, np, torch, workdir)
    mark("d")
    torch.cuda.empty_cache()
    out["measure"] = cost_measure(mx, ck, np, torch, card)
    mark("e")
    out["profile"] = cost_profile(mx, ck, np, torch, card, workdir)
    mark("f")
    out["part_seconds"] = {name: t - prev for (_, prev), (name, t)
                           in zip(marks, marks[1:])}
    out["seconds"] = time.perf_counter() - t0
    _log("[cost] part seconds %s" % json.dumps(out["part_seconds"]))
    _log("[cost] phase seconds %.1f" % out["seconds"])
    return out


def _cost_launches(cost):
    """Launches of K2f, K4, K2dq, K2dkv, K1 and K3 in phase cost's counted
    runs, by kernel and run."""
    srv = cost["serve"]["launches"]
    prof = cost["profile"]["launches"]
    applied = cost["autotune"]["applied"]
    runs = 2 * COST_AB_PAIRS + 1
    return {
        "flash_fwd": {"cost_serve": srv["flash_fwd"] * runs,
                      "cost_train": prof["flash_fwd"],
                      "cost_measure": cost["measure"]["launches"]},
        "paged_decode_pool_bf16": {
            "cost_serve": srv["paged_decode_pool_bf16"] * runs,
            "cost_autotune_applied": 2},
        "paged_decode_pool_int8": {"cost_autotune_applied": 2},
        "flash_bwd_dq": {"cost_train": prof["flash_bwd_dq"]},
        "flash_bwd_dkv": {"cost_train": prof["flash_bwd_dkv"]},
        "sgd_step": {"cost_autotune_applied": sum(
            applied["sgd"]["launch_configs"].values())},
        "adam_step": {"cost_autotune_applied": sum(
            applied["adam"]["launch_configs"].values()),
            "cost_train": prof["adam_step"]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write the full report (JSON) "
                    "to this path")
    ap.add_argument("--phase", choices=("all", "attention", "optimizer",
                                        "module", "bert", "lm_f32",
                                        "generation", "ops", "zoo", "rnn",
                                        "data", "ssd", "predict",
                                        "dist", "mesh", "shard",
                                        "resilience", "observe", "cost"),
                    default="all",
                    help="attention: the flash forward and backward checks "
                    "of phase 2 alone; optimizer: phase 2's K3 and K1 "
                    "checks alone; module: phase 7(c) alone, after the "
                    "lr_t A/B; bert: the flash checks at BERT's shapes "
                    "(bf16 and f32) and phase 4b alone; lm_f32: the f32 "
                    "flash checks at head dim 32 and phase 4c alone; "
                    "generation: the f32 flash checks at head dim 16, the "
                    "f32-query paged checks and phase 3b alone; ops: "
                    "phase ops alone (the op library's sweep, model "
                    "widths and update ops); zoo: phase 5b alone (the "
                    "model zoo's inference across nine networks, and "
                    "VGG-16 and Inception v3 training through K1); rnn: "
                    "phase rnn alone (the RNN op card against CPU, the "
                    "Gluon LSTM LM, the bucketed LSTM through K3), "
                    "ending in the card and ok lines; data: phase data "
                    "alone (record-fed ResNet-50 with checkpoints and the "
                    "resume gate, input_pipeline_config, every optimizer "
                    "on the LSTM LM, the Apache-MXNet round trip), ending "
                    "in the card and ok lines; ssd: phase ssd alone "
                    "(examples/ssd_train.py at 512, synthetic and from an "
                    "ImageDetRecordIter, detection with the NMS kernel "
                    "against its plain version, the detection ops card "
                    "against CPU), ending in the kernels line for K1 and "
                    "the NMS kernel, the card and ok lines; predict: phase "
                    "8 alone (ResNet-50 served one-shot in f32 and int8, "
                    "bench.py's two serving configs; no kernel built), "
                    "ending in the card and ok lines; dist: phase dist "
                    "alone (bench.py's dlrm_embedding_config sparse and "
                    "dense, row-sparse Adam card against CPU, two gloo "
                    "ranks on the card through the port's launcher, a "
                    "one-card NCCL group), ending in the kernels line for "
                    "K1 and K3, the card and ok lines; mesh: phase 9b "
                    "alone (tensor, sequence, pipeline and expert "
                    "parallelism on gloo ranks sharing the card, one NCCL "
                    "rank), ending in the kernels line for the flash "
                    "kernels and K1, the card and ok lines; shard: phase "
                    "shard alone (ResNet-50 data-parallel with BatchNorm "
                    "over the ranks, the TransformerLM served at tp=2, "
                    "BERT-base over sp=2 on gloo ranks sharing the card, "
                    "then ctx_group placement, Module context lists and "
                    "Gluon parameters on gpu(0) and cpu()), ending in the "
                    "kernels line for K1, K2f and K4, the card and ok "
                    "lines; resilience: phase resilience alone (K1 and K3 "
                    "with the skip word, ResNet-50's chaos run against its "
                    "baseline, the nanguard abort through K3, two elastic "
                    "generations of gloo ranks sharing the card), ending "
                    "in the kernels line for K1 and K3, the card and ok "
                    "lines; observe: phase observe alone (summarize on "
                    "the card against the CPU, the TransformerLM with and "
                    "without numerics capture, ResNet-50's nanguard abort "
                    "with forensics, the sinks and the watchdog, the sync "
                    "count, the capture's cost, mx.profiler, Monitor, the "
                    "watchdog firing), ending in the kernels line for K1, "
                    "K2f, K2dq, K2dkv and K3, the card and ok lines; cost: "
                    "phase cost alone (generation serving with the "
                    "exporter, access log, SLOs, sinks and watchdog on "
                    "beside off, a planted stall, the int8 drift twin, "
                    "mx.autotune into a fresh cache, kernels.measure, "
                    "perf.profile on the TransformerLM), ending in the "
                    "kernels line for K2f, K4, K2dq, K2dkv, K1 and K3, the "
                    "card and ok lines")
    ap.add_argument("--ab-csrc", metavar="DIR",
                    help="with --phase attention: also run the NaN cases "
                    "on the kernels built from DIR (another checkout's "
                    "mxnet_tpu_torch/csrc) and time each kernel the NaN "
                    "repair changed there and here, in turns")
    ap.add_argument("--dist-worker", metavar="WORKDIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-worker", metavar="WORKDIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-suite", choices=("two", "four", "nccl"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--nccl-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--shard-worker", metavar="WORKDIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--resilience-worker", metavar="WORKDIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.nccl_worker:
        return nccl_worker()
    if args.mesh_worker:
        return mesh_worker(args.mesh_worker, args.mesh_suite)
    if args.shard_worker:
        return shard_worker(args.shard_worker)
    if args.resilience_worker:
        return resilience_worker(args.resilience_worker)
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
        {"attention": ["flash_fwd", "flash_bwd", "flash_f32", "paged_attn",
                       "row_softmax"],
         "optimizer": ["adam_step", "sgd_step"],
         "bert": ["flash_fwd", "flash_bwd", "flash_f32", "adam_step"],
         "lm_f32": ["flash_f32", "adam_step"],
         "generation": ["flash_f32", "paged_attn"],
         "ops": ["sgd_step", "adam_step"],
         "zoo": ["sgd_step"], "rnn": ["adam_step"],
         "data": ["sgd_step", "adam_step"],
         "ssd": ["sgd_step", "box_nms"], "predict": [],
         "dist": ["sgd_step", "adam_step"],
         "mesh": ["flash_fwd", "flash_bwd", "flash_f32", "sgd_step"],
         "shard": ["flash_fwd", "paged_attn", "sgd_step"],
         "resilience": ["sgd_step", "adam_step"],
         "observe": ["flash_fwd", "flash_bwd", "sgd_step",
                     "adam_step"],
         "cost": ["flash_fwd", "flash_bwd", "paged_attn", "sgd_step",
                  "adam_step"]}.get(args.phase))
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
    f32q_keys = ("paged_decode_pool_f32", "paged_decode_pool_int8_f32q")

    def check_f32q_paged():
        for key, quant in zip(f32q_keys, (False, True)):
            report[key] = check_paged(ck, torch, F, quant, PAGED_F32_CASES,
                                      "float32")
    if args.phase == "attention":
        report["flash_fwd"] = check_flash(ck, torch, F)
        report["paged_decode_pool_bf16"] = check_paged(ck, torch, F, False)
        report["paged_decode_pool_int8"] = check_paged(ck, torch, F, True)
        check_f32q_paged()
        report["flash_bwd_dq"], report["flash_bwd_dkv"] = check_flash_bwd(
            ck, torch, F)
        f32_cases = F32_CASES + F32_D32_CASES + F32_D16_CASES
        report["flash_fwd_f32"] = check_flash(ck, torch, F, f32_cases,
                                              "float32")
        report["flash_bwd_dq_f32"], report["flash_bwd_dkv_f32"] = \
            check_flash_bwd(ck, torch, F, F32_BWD_CASES + F32_D32_CASES
                            + F32_D16_CASES, "float32")
        report["flash_bwd_f32_sweep"] = sweep_flash_bwd_f32(ck, torch)
        report["nan"] = check_nan(ck, torch)
        report["section6"] = section6_times(ck, torch)
        if args.ab_csrc:
            report["kernel_ab"] = kernel_ab(ck, torch, args.ab_csrc)
        bad = [c for key in ("flash_fwd", "paged_decode_pool_bf16",
                             "paged_decode_pool_int8", "flash_bwd_dq",
                             "flash_bwd_dkv") + f32_keys + f32q_keys
               for c in report[key] if not c["ok"]] + report["nan"]["failed"]
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
    if args.phase == "generation":
        report["flash_fwd_f32"] = check_flash(ck, torch, F, F32_D16_CASES,
                                              "float32")
        report["flash_bwd_dq_f32"], report["flash_bwd_dkv_f32"] = \
            check_flash_bwd(ck, torch, F, F32_D16_CASES, "float32")
        check_f32q_paged()
        bad = [c for key in f32_keys + f32q_keys for c in report[key]
               if not c["ok"]]
        if bad:
            _write_report(args.report, report)
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["generation"] = generation(mx, ck, np, torch, card, workdir)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "zoo":
        report["zoo"] = zoo_phase(mx, ck, np, torch, card, workdir)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "ops":
        report["ops"] = ops_phase(mx, ck, np, torch)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        return 0
    if args.phase == "rnn":
        report["rnn"] = rnn_phase(mx, ck, np, torch, card)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "data":
        report["data"] = data_phase(mx, ck, np, torch, card, workdir)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "ssd":
        sgd, sgd_step = check_sgd(ck, torch, mx, np)
        bad = [c for c in sgd if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["ssd"] = ssd_phase(mx, ck, np, torch, card, workdir)
        kernels = [_sgd_summary(sgd, sgd_step, _ssd_sgd_launches(
            report["ssd"])), _ssd_summary(report["ssd"])]
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "predict":
        report["predict"] = predict_phase(mx, np, torch, card, workdir)
        _write_report(args.report, report)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "build"}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "dist":
        adam, adam_step = check_adam(ck, torch)
        sgd, sgd_step = check_sgd(ck, torch, mx, np)
        bad = [c for c in adam + sgd if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["dist"] = dist_phase(mx, ck, np, torch, card, workdir)
        dist_sgd, dist_adam = _dist_launches(report["dist"])
        kernels = [_adam_summary(adam, adam_step, dist_adam),
                   _sgd_summary(sgd, sgd_step, dist_sgd)]
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "mesh":
        mesh_sgd_shapes = mesh_mlp_specs()[1]
        flash = check_flash(ck, torch, F, MESH_FLASH_CASES)
        bwd_dq, bwd_dkv = check_flash_bwd(ck, torch, F, MESH_FLASH_CASES)
        flash32 = check_flash(ck, torch, F, MESH_FLASH_CASES, "float32")
        bwd_dq32, bwd_dkv32 = check_flash_bwd(ck, torch, F,
                                              MESH_FLASH_CASES, "float32")
        sgd, sgd_step = check_sgd(ck, torch, mx, np, mesh_sgd_shapes)
        bad = [c for c in flash + bwd_dq + bwd_dkv + flash32 + bwd_dq32
               + bwd_dkv32 + sgd if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["mesh"] = mesh_phase(mx, ck, np, torch, card, workdir)
        by = _mesh_launches(report["mesh"])
        pk = "mxnet_tpu/ops/pallas_kernels.py:"
        kernels = []
        for name, source, line, cases in (
                ("flash_fwd", "flash_fwd.cu", "157", flash),
                ("flash_bwd_dq", "flash_bwd.cu", "190", bwd_dq),
                ("flash_bwd_dkv", "flash_bwd.cu", "220", bwd_dkv),
                ("flash_fwd_f32", "flash_f32.cu", "157", flash32),
                ("flash_bwd_dq_f32", "flash_f32.cu", "190", bwd_dq32),
                ("flash_bwd_dkv_f32", "flash_f32.cu", "220", bwd_dkv32)):
            kern = _summary(name, source, pk + line, cases,
                            sum(by[name].values()))
            kern["launches_by_path"] = by[name]
            kernels.append(kern)
        kernels.append(_sgd_summary(sgd, sgd_step, by["sgd_step"]))
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    shard_flash, shard_paged = shard_kernel_cases(np)
    if args.phase == "shard":
        flash = check_flash(ck, torch, F, shard_flash)
        paged = check_paged(ck, torch, F, False, shard_paged)
        paged8 = check_paged(ck, torch, F, True, shard_paged)
        sgd, sgd_step = check_sgd(ck, torch, mx, np)
        bad = [c for c in flash + paged + paged8 + sgd if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["shard"] = shard_phase(mx, ck, np, torch, card, workdir)
        by = _shard_launches(report["shard"])
        pk = "mxnet_tpu/ops/pallas_kernels.py:"
        kernels = []
        for name, source, line, cases in (
                ("flash_fwd", "flash_fwd.cu", "157", flash),
                ("paged_decode_pool_bf16", "paged_attn.cu", "386", paged),
                ("paged_decode_pool_int8", "paged_attn.cu", "386", paged8)):
            kern = _summary(name, source, pk + line, cases,
                            sum(by[name].values()))
            kern["launches_by_path"] = by[name]
            kernels.append(kern)
        kernels.append(_sgd_summary(sgd, sgd_step, by["sgd_step"]))
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "resilience":
        adam, adam_step = check_adam(ck, torch)
        sgd, sgd_step = check_sgd(ck, torch, mx, np)
        bad = [c for c in adam + sgd if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["resilience"] = resilience_phase(mx, ck, np, torch, card,
                                                workdir)
        res_sgd, res_adam = _res_launches(report["resilience"])
        kernels = [_adam_summary(adam, adam_step, res_adam),
                   _sgd_summary(sgd, sgd_step, res_sgd)]
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "observe":
        flash = check_flash(ck, torch, F)
        bwd_dq, bwd_dkv = check_flash_bwd(ck, torch, F)
        adam, adam_step = check_adam(ck, torch)
        sgd, sgd_step = check_sgd(ck, torch, mx, np)
        bad = [c for c in flash + bwd_dq + bwd_dkv + adam + sgd
               if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["observe"] = observe_phase(mx, ck, np, torch, card, workdir)
        by = _observe_launches(report["observe"])
        pk = "mxnet_tpu/ops/pallas_kernels.py:"
        kernels = []
        for name, source, line, cases in (
                ("flash_fwd", "flash_fwd.cu", "157", flash),
                ("flash_bwd_dq", "flash_bwd.cu", "190", bwd_dq),
                ("flash_bwd_dkv", "flash_bwd.cu", "220", bwd_dkv)):
            kern = _summary(name, source, pk + line, cases,
                            sum(by[name].values()))
            kern["launches_by_path"] = by[name]
            kernels.append(kern)
        kernels += [_adam_summary(adam, adam_step, by["adam_step"]),
                    _sgd_summary(sgd, sgd_step, by["sgd_step"])]
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "cost":
        train_case = ((TRAIN_B, 12, True, TRAIN_S, TRAIN_S, 64),)
        decode_case = ((DECODE_B, 12, DECODE_WIDTH, PAGE_SIZE, 64),)
        flash = check_flash(ck, torch, F, train_case)
        paged = check_paged(ck, torch, F, False, decode_case)
        paged8 = check_paged(ck, torch, F, True, decode_case)
        bwd_dq, bwd_dkv = check_flash_bwd(ck, torch, F, train_case)
        adam, adam_step = check_adam(ck, torch)
        sgd, sgd_step = check_sgd(ck, torch, mx, np)
        bad = [c for c in flash + paged + paged8 + bwd_dq + bwd_dkv + adam
               + sgd if not c["ok"]]
        if bad:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s" % json.dumps(bad))
        report["cost"] = cost_phase(mx, ck, np, torch, card, workdir)
        by = _cost_launches(report["cost"])
        pk = "mxnet_tpu/ops/pallas_kernels.py:"
        kernels = []
        for name, source, line, cases in (
                ("flash_fwd", "flash_fwd.cu", "157", flash),
                ("flash_bwd_dq", "flash_bwd.cu", "190", bwd_dq),
                ("flash_bwd_dkv", "flash_bwd.cu", "220", bwd_dkv),
                ("paged_decode_pool_bf16", "paged_attn.cu", "386", paged),
                ("paged_decode_pool_int8", "paged_attn.cu", "386", paged8)):
            kern = _summary(name, source, pk + line, cases,
                            sum(by[name].values()))
            kern["launches_by_path"] = by[name]
            kernels.append(kern)
        kernels += [_adam_summary(adam, adam_step, by["adam_step"]),
                    _sgd_summary(sgd, sgd_step, by["sgd_step"])]
        report["kernels"] = kernels
        _write_report(args.report, report)
        print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                       if k != "cases"} for s in kernels]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "module":
        report["lr_t_ab"] = lr_t_ab(mx, np, torch)
        report["launch_ab"] = launch_ab(mx, np, torch)
        report["module"] = train_module(mx, ck, np, torch, card, workdir)
        print(json.dumps(report))
        return 0

    flash = check_flash(ck, torch, F, FWD_CASES + MESH_FLASH_CASES
                        + shard_flash)
    paged = check_paged(ck, torch, F, False, PAGED_CASES + shard_paged)
    paged8 = check_paged(ck, torch, F, True, PAGED_CASES + shard_paged)
    check_f32q_paged()
    paged32, paged8q = (report[key] for key in f32q_keys)
    bwd_dq, bwd_dkv = check_flash_bwd(ck, torch, F,
                                      BWD_CASES + MESH_FLASH_CASES)
    flash32 = check_flash(ck, torch, F,
                          F32_CASES + F32_D32_CASES + F32_D16_CASES
                          + MESH_FLASH_CASES, "float32")
    bwd_dq32, bwd_dkv32 = check_flash_bwd(
        ck, torch, F, F32_BWD_CASES + F32_D32_CASES + F32_D16_CASES
        + MESH_FLASH_CASES, "float32")
    report["flash_bwd_f32_sweep"] = sweep_flash_bwd_f32(ck, torch)
    adam, adam_step = check_adam(ck, torch)
    sgd, sgd_step = check_sgd(ck, torch, mx, np)
    sgd += check_sgd(ck, torch, mx, np, mesh_mlp_specs()[1])[0]
    k5f, k5b = check_row_softmax(ck, torch)
    k6 = check_scale_bias_relu(ck, torch)
    report["nan"] = check_nan(ck, torch)
    report["section6"] = section6_times(ck, torch)
    bad = [c for c in flash + paged + paged8 + paged32 + paged8q + bwd_dq
           + bwd_dkv + flash32 + bwd_dq32 + bwd_dkv32 + adam + sgd + k5f
           + k5b + k6 if not c["ok"]] + report["nan"]["failed"]
    if bad:
        raise AssertionError("kernel disagrees with its plain version: %s"
                             % json.dumps(bad))

    phase_seconds = report["phase_seconds"] = {}

    def timed(name, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its seconds logged and kept."""
        t = time.perf_counter()
        res = fn(*args, **kwargs)
        phase_seconds[name] = time.perf_counter() - t
        _log("[phase] %s %.1f s" % (name, phase_seconds[name]))
        return res

    report["serve"] = timed("serve", serve, mx, ck, np, torch, workdir)
    report["generation"] = timed("generation", generation, mx, ck, np,
                                 torch, card, workdir)
    report["train"] = timed("train", train, mx, ck, np, torch)
    report["bert"] = timed("bert", bert, mx, ck, np, torch, card)
    report["lm_f32"] = timed("lm_f32", train_lm_f32, mx, ck, np, torch,
                             card)
    report["resnet"] = timed("resnet", train_resnet, mx, ck, np, torch,
                             card)
    report["zoo"] = timed("zoo", zoo_phase, mx, ck, np, torch, card,
                          workdir)
    report["tape"] = timed("tape", tape, mx, ck, np, torch)
    report["lenet"] = timed("lenet", train_lenet, mx, ck, np, torch, card)
    report["f16"] = timed("f16", train_f16, mx, ck, np, torch)
    report["rtc"], rtc_kernels = timed("rtc", check_rtc, mx, ck, torch)
    report["rtc_ops"] = timed("rtc_ops", rtc_ops, mx, ck, torch,
                              rtc_kernels)
    report["module"] = timed("module", train_module, mx, ck, np, torch,
                             card, workdir)
    report["ops"] = timed("ops", ops_phase, mx, ck, np, torch)
    report["rnn"] = timed("rnn", rnn_phase, mx, ck, np, torch, card)
    report["data"] = timed("data", data_phase, mx, ck, np, torch, card,
                           workdir, synthetic={k: report["resnet"][k] for k
                                               in ("img_per_s",
                                                   "median_step_ms",
                                                   "cudnn_benchmark")})
    report["ssd"] = timed("ssd", ssd_phase, mx, ck, np, torch, card,
                          workdir)
    report["predict"] = timed("predict", predict_phase, mx, np, torch, card,
                              workdir)
    report["dist"] = timed("dist", dist_phase, mx, ck, np, torch, card,
                           workdir)
    report["mesh"] = timed("mesh", mesh_phase, mx, ck, np, torch, card,
                           workdir)
    report["shard"] = timed("shard", shard_phase, mx, ck, np, torch, card,
                            workdir)
    report["resilience"] = timed("resilience", resilience_phase, mx, ck, np,
                                 torch, card, workdir)
    report["observe"] = timed("observe", observe_phase, mx, ck, np, torch,
                              card, workdir)
    report["cost"] = timed("cost", cost_phase, mx, ck, np, torch, card,
                           workdir)
    mesh_by = _mesh_launches(report["mesh"])
    obs_by = _observe_launches(report["observe"])
    shard_by = _shard_launches(report["shard"])
    data_sgd, data_adam = _data_launches(report["data"])
    data_sgd.update(_ssd_sgd_launches(report["ssd"]))
    dist_sgd, dist_adam = _dist_launches(report["dist"])
    data_sgd.update(dist_sgd)
    data_sgd.update(mesh_by["sgd_step"])
    data_sgd.update(shard_by["sgd_step"])
    res_sgd, res_adam = _res_launches(report["resilience"])
    data_sgd.update(res_sgd)
    data_adam.update(dist_adam)
    data_adam.update(res_adam)
    data_sgd.update(obs_by["sgd_step"])
    data_adam.update(obs_by["adam_step"])
    cost_by = _cost_launches(report["cost"])
    data_sgd.update(cost_by["sgd_step"])
    data_adam.update(cost_by["adam_step"])
    module_adam = report["module"]["fused"]["launches"]["adam_step"]
    rnn_adam = {"rnn_bucketing_" + kind: run["launches"]["adam_step"]
                for kind, run in report["rnn"]["bucketing"].items()}
    resnet_adam = report["resnet"]["adam"]["launches"]["adam_step"]
    f16_adam = report["f16"]["adam"]["launches"]["adam_step"]
    f16_sgd = report["f16"]["sgd"]["launches"]["sgd_step"]
    zoo_sgd = {"zoo_" + name: run["launches"]["sgd_step"]
               for name, run in report["zoo"]["train"].items()}
    launches = report["serve"]["greedy"]["launches"]
    taped = report["tape"]["launches"]
    trained = report["train"]["launches"]
    berted = report["bert"]["launches"]
    bert32 = report["bert"]["f32"]["launches"]
    bert_adam = report["bert"]["adam"]["launches"]["adam_step"]
    lm32 = report["lm_f32"]["on"]["launches"]
    gen = _generation_launches(report["generation"])
    pk = "mxnet_tpu/ops/pallas_kernels.py:"
    kernels = [
        _summary("flash_fwd", "flash_fwd.cu", pk + "157", flash,
                 launches["flash_fwd"]),
        _summary("flash_bwd_dq", "flash_bwd.cu", pk + "190", bwd_dq,
                 trained["flash_bwd_dq"]),
        _summary("flash_bwd_dkv", "flash_bwd.cu", pk + "220", bwd_dkv,
                 trained["flash_bwd_dkv"]),
        _summary("flash_fwd_f32", "flash_f32.cu", pk + "157", flash32,
                 bert32["flash_fwd_f32"] + lm32["flash_fwd_f32"]
                 + gen["flash_fwd_f32"]),
        _summary("flash_bwd_dq_f32", "flash_f32.cu", pk + "190", bwd_dq32,
                 bert32["flash_bwd_dq_f32"] + lm32["flash_bwd_dq_f32"]),
        _summary("flash_bwd_dkv_f32", "flash_f32.cu", pk + "220", bwd_dkv32,
                 bert32["flash_bwd_dkv_f32"] + lm32["flash_bwd_dkv_f32"]),
        _summary("paged_decode_pool_bf16", "paged_attn.cu", pk + "386",
                 paged, launches["paged_decode_pool_bf16"]),
        _summary("paged_decode_pool_int8", "paged_attn.cu", pk + "386",
                 paged8, report["serve"]["int8"]["launches"][
                     "paged_decode_pool_int8"]),
        _summary("paged_decode_pool_f32", "paged_attn.cu", pk + "386",
                 paged32, gen["paged_decode_pool_f32"]),
        _summary("paged_decode_pool_int8_f32q", "paged_attn.cu", pk + "386",
                 paged8q, gen["paged_decode_pool_int8_f32q"]),
        _adam_summary(adam, adam_step, dict(
            {"train": trained["adam_step"], "module_mlp": module_adam,
             "f16_trainer": f16_adam, "resnet_spmd_adam": resnet_adam,
             "bert_adam": bert_adam, "lm_f32": lm32["adam_step"]},
            **rnn_adam, **data_adam)),
        dict(_sgd_summary(sgd, sgd_step, dict(
            {"resnet": report["resnet"]["launches"]["sgd_step"],
             "f16_trainer": f16_sgd}, **zoo_sgd, **data_sgd)),
            vgg16_list=report["zoo"]["train"]["vgg16"]["k1_list"]),
        _summary("row_softmax_fwd", "row_softmax.cu", pk + "66", k5f,
                 taped["row_softmax_fwd"]),
        _summary("row_softmax_bwd", "row_softmax.cu", pk + "80", k5b,
                 taped["row_softmax_bwd"]),
        _k6_summary(k6, pk + "620",
                    report["tape"]["sbr_launches"]["scale_bias_relu"]),
        _ssd_summary(report["ssd"]),
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
                                    "lm_f32": lm32[kern["name"]],
                                    "generation": gen[kern["name"]]}
    # phase 9b's per-rank launches beside each path's
    for kern in kernels[:6]:
        kern["launches_by_path"].update(mesh_by[kern["name"]])
    for kern in kernels[8:10]:
        kern["launches_by_path"] = gen["by_run"][kern["name"]]
    # phase shard's per-rank launches beside each path's
    kernels[0]["launches_by_path"].update(shard_by["flash_fwd"])
    # phase observe's TransformerLM runs, phase cost's runs
    for kern in kernels[:3]:
        kern["launches_by_path"].update(obs_by[kern["name"]])
        kern["launches_by_path"].update(cost_by[kern["name"]])
    for kern in kernels[6:8]:
        kern["launches_by_path"] = dict(
            {"serve": kern["launches"]}, **shard_by[kern["name"]],
            **cost_by[kern["name"]])
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
