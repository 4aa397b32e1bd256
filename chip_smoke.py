#!/usr/bin/env python3
"""Smoke run of flownet2_tpu_torch on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases (any failure raises and the script exits non-zero):

1. Card: print nvidia-smi's name and power limit; build the CUDA kernels
   from flownet2_tpu_torch/csrc and print the build time and ptxas's
   register and spill lines under each kernel's (mangled) name, then each
   instantiation of the correlation's tensor-core bodies (K1's, K5's and
   K6's, each for bf16 and half) with its registers and spills.
2. Kernels against their plain PyTorch versions on the card, TF32 off: the
   correlation (K1) and its gradient (K5 d_f1, K6 d_f2) at
   (8, 256, 48, 64), at the wide (4, 256, 48, 128), at a ragged
   (2, 40, 20, 152) and at an odd-width ragged (2, 40, 20, 75), atol/rtol
   1e-4 (K5/K6 also at the training shape (8, 256, 48, 56)); K1, K5 and K6
   at two configurations the register-tiled bodies of K1 and K5 do not
   cover (maxd 8, s2 1 and maxd 4, s2 2, at (2, 40, 20, 75)), which their
   general bodies run, 1e-4; the
   warp (K2) for one flow of +-8 px and of +-200 px
   and for two flows over one (8, 3, 384, 512) image, and the warp with
   tangents (K3, one and two flows) and its flow gradient (K4) over one
   (8, 3, 384, 448) image at +-8 px and +-200 px, each also at a ragged
   (2, 3, 100, 150), atol/rtol 1e-5; K4 also against the tangent route's
   flow gradient on the same inputs.  The row-slab correlation (K7:
   forward, d_f1, d_slab) on the top, a middle and the bottom band of 2 and
   of 4 bands of the main-path, the wide and the two ragged maps, atol/rtol
   1e-5 against its plain version, the forward and d_f1 also bit for bit
   against the same rows of K1 and K5, and the bands' d_slab summed
   against K6 at 1e-5.  The local-rows forms of K2, K3 and K4 (one and two
   flows, +-8 px and +-200 px) on the bands of 2 and of 4: bit-equal to
   the same rows of the whole-image kernels' output.  The bf16 forms:
   K1 at the main-path, the wide and the two ragged maps and at
   (2, 40, 3, 64) and (2, 40, 5, 75) (its tensor-core body; the flip rate
   is printed), and at maxd 8, s2 1 and maxd 4, s2 2 (its general body),
   K2 for one flow
   of +-8 px and of +-200 px and for two flows over the (8, 3, 384, 512)
   image and the ragged (2, 3, 100, 150) one, K5 and K6 at the training,
   the main-path, the wide and the two ragged maps, at (2, 40, 20, 150)
   (4-byte copies) and at (2, 40, 3, 64) and (2, 40, 5, 75) (their
   tensor-core bodies; their flip rates are printed), and at maxd 8, s2 1
   and maxd 4, s2 2 (their general bodies), K3 (out)
   and K4 on K3's and K4's f32 cases, each element
   within one bf16 ulp (rtol 2^-7, atol 1e-6 of the largest |out|) of the
   plain version and at most 1% of them not bit-equal; K3's float32 d1 and
   d2 at 1e-5; K4 bf16 also at one ulp of the tangent route's bf16 flow
   gradient.  The bf16 row bands: K7 bf16 (forward, d_f1, d_slab) on the
   bands of 1, 2 and 4 of the maps of K7's f32 checks and of a
   (2, 40, 5, 64) map (bands of one row, whose slabs are all halo but that
   row), every band's forward
   and d_f1 bit for bit the same rows of K1 bf16 and K5 bf16, one band's
   d_slab rows [20, 20 + H) K6 bf16's (the flip rates of the d_f1 bands
   printed), the top, a middle and the bottom
   band at one ulp of the plain version; the bf16 local-rows K2, K3 (out;
   d1, d2 float32) and K4, one and two flows at +-8 px and +-200 px, on
   the bands of 2 and of 4 (the second band of two of a 384-row image
   starts at row 192, where a bf16 ulp is 1 px), bit-equal to the same rows
   of the whole-image bf16 kernels.  The row tiles of K2, K3 and K4 (one
   and two flows, f32 and bf16) at the smooth flow the stage glue makes
   (+-8 px at (H/4, W/4), bilinear x4) at K2's and K4's shapes, and in one
   launch whose blocks take both routes (half the batch at +-8 px, whose
   windows are staged in shared memory, half at +-200 px, gathered from
   global memory), at phase 2's tolerances; K3 and K4 (two flows, f32 and
   bf16) at (2, 3, 100, 136), where a bf16 K3 thread pair straddles the
   row's end, likewise.  The warp's image gradient (plain PyTorch, F4) at
   K2's shape, one and two flows of +-8 px and +-200 px: two calls
   bit-equal, within 1e-5 (of its largest magnitude) of a float64 sum, its
   time printed.  The fp16 forms (``fp16_kernels``): every fp16 entry
   point at the bf16 forms' cases, each element within one fp16 ulp
   (rtol 2^-10, atol 1e-6 of the largest |out|) of its plain version and
   at most 1% of them not bit-equal (the flip rates of K1, K5 and K6 fp16
   printed for each body: the tensor-core bodies at maxd 20, s2 2, the
   general bodies at the others), K5 and K6 fp16 with an fp16 inf in f2
   and in f1 at the training map non-finite wherever their plain versions
   are and non-finite somewhere exactly when they are (the fp16 step's
   skip check), the extra non-finite outputs counted, K3's
   float32 d1 and d2 at 1e-5, K4 fp16 also against the tangent route's
   fp16 flow gradient, the smooth flow and both routes in one launch; K7
   fp16 on the bands of 1, 2 and 4 (forward and d_f1 bit-equal to K1 and
   K5 fp16's rows, one band's d_slab rows [20, 20 + H) K6 fp16's, the top,
   a middle and the bottom band at one ulp of the plain version); the fp16
   local-rows K2, K3 and K4 bit-equal to the whole image's rows.  The
   configurations no model uses (``cfg_kernels``, M6c): the kernels of
   ``csrc/correlation_cfg.cu`` and ``csrc/resample2d_cfg.cu`` in float32,
   bf16 and fp16 against their plain versions (f32 at 1e-4 for the
   correlation, 1e-5 for the warp; bf16 and fp16 at one ulp, at most 1%
   not bit-equal): the correlation and both gradients at (8, 256, 48, 64)
   at (21, 3, 20, 1, 2) and (20, 1, 20, 2, 2) and at (2, 40, 20, 75) at
   (2, 3, 3, 2, 1), (6, 1, 4, 1, 1) and (4, 2, 4, 1, 2); the bilinear K 2
   and K 3 warps and their flow gradients and the nearest warp (bit-equal)
   over the (8, 3, 384, 512) image at +-8 px and +-200 px and over
   (2, 3, 100, 150); every gradient's two calls bit-equal; the image
   gradient of the three warps as F4's; then the op surface
   (``ops.Correlation(21, 3, 20, 1, 2)``, ``ops.Resample2d(3)`` forward and
   backward, ``ops.Resample2d(1, bilinear=False)``) in each dtype with the
   counters set to 0 before and read after: one launch of each cfg entry
   point, no plain-op call.
3. FlowNet2 inference, seeded random weights, b8 384x512 fp32: warm-up,
   then 10 timed batches with CUDA events, with the launch counters set to
   0 just before and read just after (1 K1 and 3 K2 launches per forward,
   no plain-op call).  The output must be finite, (8, 384, 512, 2), agree
   with the same model run with the plain ops on the card, and agree on a
   small pair with the model run on the CPU, at rtol/atol 1e-3.
3b. FlowNet2 bf16 inference (``get_model(..., dtype=torch.bfloat16)``), the
   same weights and pairs: 10 timed batches counted as in phase 3 (1
   correlation_fwd_bf16, 2 resample2d_fwd_bf16 and 1
   resample2d_fwd_multi_bf16 launch per forward, nothing else, no plain-op
   call); the output finite, (8, 384, 512, 2) and bf16, and within the JAX
   package's bf16 contract (mean |d| < 0.05 (mean |ref| + 1e-3) + 5e-3) of
   the plain-op bf16 model on the card, of the fp32 model and, on the small
   pair, of the bf16 model on the CPU; under two row bands, with cuDNN
   deterministic, within the same contract of the whole-map output (printed:
   whether bit-equal).  Printed beside: the host's time to enqueue a
   forward, the model against itself with cuDNN's default algorithms, and
   against the plain-op model with deterministic ones.  The bf16 model is
   then freed (phase 7 builds it again), so that phase 4 runs beside the
   one fp32 model, as it did before.
3c. FlowNet2 fp16 inference (``get_model(..., dtype=torch.float16)``),
   phase 3's weights and pairs: 10 timed batches counted as in phase 3 (1
   correlation_fwd_fp16, 2 resample2d_fwd_fp16 and 1
   resample2d_fwd_multi_fp16 a forward, no plain-op call); the output
   finite, (8, 384, 512, 2) and fp16, within the bf16 contract of the
   plain-op fp16 model on the card, of the fp32 model and, on the small
   pair, of the fp16 model on the CPU; under two row bands, cuDNN
   deterministic, within the same contract of the whole map, that
   forward's launches exact (2 correlation_fwd_rows_fp16, 4 and 2 fp16
   K2).  Printed: ms/batch, frames/s, the peak memory and the host's time
   to enqueue a forward, and the ms/batch and the host's time beside
   phase 3b's bf16 ones.  The fp16 model is then freed.
3d. BatchNorm in low precision (``batchnorm_phase``): FlowNet2S with
   BatchNorm at b8 384x512, one MultiScale Adam step each in fp32, bf16 and
   fp16 (loss scale 1024, non-finite updates skipped), cuDNN
   deterministic: the low-precision train-mode forward (each scale in the
   compute dtype) and loss within the bf16 contract of fp32's; every
   gradient float32 and finite, no update skipped; each BatchNorm's
   running statistics float32, within 1e-5 of the update by the float64
   statistics of its own low-precision input, and within the bf16
   contract of the fp32 model's, layer by layer.
4. FlowNet2 training through StepFactory, b8 384x448 fp32, MultiScale,
   Adam 1e-4, seeded weights, random images x255 and flow x5: the first
   step's loss and every parameter's gradient against the plain-op model
   on the card (loss at rtol 1e-4, each gradient within 1e-3 of its
   tensor's largest |g| with the forward shared, all gradients within 1e-3
   in relative L2 otherwise), and a (1, 2, 64, 128, 3) step against the CPU
   (loss at 1e-4, gradients at 1e-3 in relative L2); then 2 warm-up and 10
   timed steps per warp route, in turns (K2 + K4, tangents, tangents,
   K2 + K4), the counters
   set to 0 just before each route's first block and read after it (per
   step: 1 K1, 1 K5, 1 K6 and, on the default K2 + K4 route, 2 one-flow
   and 1 two-flow K2 and K4 and no K3, on the tangent route 2 one-flow and
   1 two-flow K3 and no K2 or K4; no plain-op call).  Loss and EPE must be
   finite.  Before the timed steps, on each warp route with cuDNN
   deterministic: two backward passes over one shared forward give the
   same bits in every sub-net, and one step under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` names no op
   as nondeterministic (torch's Python warnings and its C++ log on the
   standard error; the capture first shown to name torch.histc's op);
   the same two readings with torch's own bilinear upsample backward in
   place of the port's are printed beside, and its two backward passes
   must differ in flownetc, or the check of the port's is not shown to
   see what it checks for.  The small step against the CPU is also read,
   not gated, on three more draws; on each draw, FlowNetC's first warp's
   sample point nearest an integer column is moved across it (dx by as
   few ulps as it takes) and how far that carries FlowNetC's gradients is
   printed beside their gap to the CPU and the 1e-3 gate.
4b. FlowNet2 bf16 training (``get_model(..., dtype=torch.bfloat16)``:
   float32 master weights, bf16 convolutions, glue and warps, the loss and
   Adam in float32), phase 4's weights and batch: with cuDNN deterministic
   and the forward shared, the backward kernels against the plain backward
   on both warp routes (loss bit-equal, each sub-net's gradients within
   5e-2 in relative L2, the worst tensor printed) and the routes against
   each other; the kernel model against the plain-op bf16 model (loss and
   EPE at 5e-3 relative; flownets_2, flownets_d and flownetfusion at 5e-2,
   flownetc and flownets_1 printed: two bf16 forwards put them on the
   noise line); a (1, 2, 64, 128, 3) step against the bf16 model on the
   CPU at the same gates; every gradient float32 and finite.  Then 2
   warm-up and 10 timed steps per route, in turns, counted as in phase 4
   (per step 1 correlation_fwd_bf16, 1 correlation_bwd_f1_bf16, 1
   correlation_bwd_f2_bf16 and, on the default route, 2 one-flow and 1
   two-flow resample2d_fwd_bf16 and resample2d_grad_flow_bf16, on the
   tangent route 2 one-flow and 1 two-flow resample2d_tangents_bf16; no
   f32 kernel, no plain-op call), after phase 4's determinism checks on
   the bf16 model.  The bf16 model is then freed, so that phase 5 runs as
   it did before.
4c. FlowNet2 fp16 training, phase 4's weights and batch, loss scale 1024
   (the command line's default), non-finite updates skipped: with cuDNN
   deterministic and the forward shared, the fp16 backward kernels against
   the plain backward on both warp routes (loss bit-equal, each sub-net's
   gradients within 5e-2 in relative L2, the worst tensor printed); the
   loss and EPE, unscaled, within the bf16 contract of the fp32 step's;
   the same step as two row bands on the card against the whole map (loss
   and EPE at 5e-3 relative, sub-nets at 5e-2, flownetc and flownets_1
   printed), its launches exact (2 of each K7 fp16 entry point, twice the
   step's fp16 warps); then 2 warm-up and 10 timed steps per route, in
   turns, counted as in phase 4 with the fp16 entry points, ms/step
   printed beside phase 4b's bf16 ms/step; the skipped updates printed,
   and the phase fails if every update was skipped.
5. The row-band path: with ``set_spatial_shards(2)`` the correlation runs
   as two bands against halo slabs on K7 and every warp as two bands on
   the local-rows K2, K3 and K4, all on this card in turn.  The phase 3
   model and pair: the output within 1e-5 of the whole-map model's with
   cuDNN made deterministic (printed: whether bit-equal, and how far the
   whole-map model is from itself with cuDNN's default algorithms), then 10
   timed batches with the counters set to 0 just before and read just after
   (per forward 2 K7 forward, no K1, 4 one-flow and 2 two-flow K2; no
   plain-op call); the dispatch log names the halo-slab and halo-gather
   compositions.  The phase 4 model and batch: one step's loss within 1e-4
   and all gradients within 1e-3 in relative L2 of the whole-map step's,
   then 2 warm-up and 10 timed steps, counted likewise (per step 2 of each
   K7 entry point, no K1, K5 or K6, twice phase 4's warp launches).
   FlowNet2C, seeded weights, b8 384x512: 10 timed whole-map forwards (1 K1
   each), and one MultiScale train step under two bands whose loss and EPE
   are finite and within 1e-4 of the plain-op model's.
5b. The row-band path in bf16: the bf16 model of the same weights, built
   again and freed after.  Inference b8 384x512, 10 timed batches under two
   bands and over the whole map in turns (whole, bands, bands, whole), the
   band runs counted (per forward 2 correlation_fwd_rows_bf16, 4
   resample2d_fwd_bf16, 2 resample2d_fwd_multi_bf16; no plain-op call).
   One train step b8 384x448 under two bands against the whole map, cuDNN
   deterministic: loss and EPE within 5e-3 relative, each sub-net's
   gradients within 5e-2 in relative L2 (flownetc and flownets_1 printed
   only), every gradient float32 and finite, the launches counted (2 of
   each K7 bf16 entry point, twice phase 4b's warp launches).  Then 2
   warm-up and 10 timed steps per warp route, in turns, over the whole map
   and then under two bands, each counted (the tangent route's K3 bf16 in
   place of K2 and K4).
5c. FlowNet2 trained from files on disk through the Trainer: 24 training
   and 8 validation pairs in FlyingChairs' own format (.ppm frames, .flo
   flows) at 384x512, drawn from a seeded generator, in a temporary
   directory that is removed after.  The decoder route is printed (native,
   or numpy with the build's reason; the numpy route only where the libpng
   or libjpeg headers are missing).  FlyingChairs with crops of 384x448,
   DataLoader(batch 8, shuffled, seed 0): the loader's batches/s alone,
   and two epochs through device_prefetch, every device batch bit-equal to
   its host batch.  fp32, TF32 off, cuDNN deterministic: run A,
   Trainer.fit over 2 epochs of 3 steps (MultiScale, Adam 1e-4) with
   validation at epoch 0; run B, epoch 0 into its own directory, then a new
   model, optimizer, StepFactory and Trainer resumed from its
   train-checkpoint for epoch 1: parameters, Adam's state, step count,
   best EPE and logged losses bit-equal to run A's.  Each checkpoint save
   and the restore timed, with its bytes.  Trainer.inference over the
   validation pairs: 8 .flo and 8 PNG files, the .flo files bit-equal to
   infer_step's flows, the EPE finite.  Then, with cuDNN's defaults, 2
   timed epochs of 3 steps through the Trainer in fp32 and in bf16 (after
   one epoch to warm up), ms/step with and without the loader's waits
   beside phases 4 and 4b.
5d. The command line and caffemodel import, FlowNet2 at full width, cuDNN
   deterministic for the bit-equality gates, in a temporary directory:
   a caffemodel of seeded weights (the release's V1 layout, the first
   convolutions' BGR groups reversed, ~650 MB) converted by ``python -m
   flownet2_tpu_torch.checkpoints.convert`` (exit 0, one JSON line,
   162,518,834 parameters, the converted state dict bit-equal to the
   seeded model's); ``cli.main --inference --save_flow --resume
   <converted>`` over 17 ImagesFromFolder frames at 384x512, b8 (per
   forward 1 K1, 2 one-flow and 1 two-flow K2, no plain-op call; the .flo
   files bit-equal to ``infer_step`` of the seeded model), again with
   ``--spatial_shards 2`` (K7 forward and the local-rows K2; bit-equal to
   the whole map) and with ``--precision bf16`` (the bf16 entry points;
   within the bf16 contract of the fp32 flows), with ``--precision fp16``
   and with ``--precision fp16 --spatial_shards 2`` (the fp16 entry points;
   within the bf16 contract of the fp32 flows, and the bands of the whole
   fp16 map); one ``python -m
   flownet2_tpu_torch.cli --inference`` subprocess of one batch (exit 0);
   ``cli.main`` training from FlyingChairs-format files (crops of
   384x448, b8, 2 epochs of 2 steps, validation each epoch) from a
   ``.pth.tar`` of the seeded weights (the launches of the steps and the
   validation forwards exact, no plain-op call; the final parameters and
   the logged losses bit-equal to ``Trainer.fit`` built by hand from the
   same pieces and files), then ``--resume <run>`` for a third epoch with
   cuDNN's defaults (its launches exact, the count from 4 to 6); one
   ``--precision fp16`` epoch from the same ``.pth.tar`` (its launches the
   fp16 entry points, exact; every record finite, each train record's
   ``skipped`` 0 or 1 and not all 1, the first step's loss and EPE, before
   any update, within the bf16 contract of the fp32 run's: unscaled).
   ms/step through the command line beside phases 4 and 5c, the
   conversion's seconds, inference seconds a batch.
5e. Data parallel, in fresh processes started with torchrun's variables
   (``torch.distributed.run``), after phase 5d; a global batch of phase 4's
   size (8 pairs at 384x448) drawn by numpy from its own seed, FlowNet2 of
   the seeded weights, TF32 off, cuDNN deterministic.  (a) Two ranks over
   gloo on the one card (NCCL refuses two ranks on one device), 4 pairs
   each, 3 steps of Adam 1e-4 through ``StepFactory(plan=...)``: the
   parameters bit-equal on every rank after each step (all-gathered
   digests); step 1's all-reduced gradients within 1e-6 in relative L2 of
   the mean of the ranks' own gradients of the same forward (taken by
   ``autograd.grad``, which DDP's hooks do not see); step 1's gradients
   against the one-process batch-8 step per sub-net within 1e-3 in
   relative L2 (flownetc and flownets_1 printed only) and the global loss
   within 1e-5 relative; every rank's launches a step phase 4's exactly.
   (b) One rank over NCCL, fp32 and bf16, 3 steps each: the parameters
   bit-equal to the same steps without DistributedDataParallel.  (c)
   ``cli.main`` as torchrun's one NCCL rank: training from phase 5d's files
   and ``--inference --save_flow`` bit-equal to phase 5d's parameters,
   records and flows.  ``python3 chip_smoke.py --data-parallel`` runs
   phase 5e(d) alone, on every card the environment lists (more than one):
   the cards' names, power limits and links (``nvidia-smi topo -m``,
   ``nvidia-smi nvlink --status`` and peer access); each kernel
   of the main path on every card (each wrapper picks its tensors' card)
   against its plain version, f32 and bf16; (a)'s gates over NCCL on 2 and
   on 4 cards; the plain command line on every card, which starts its own
   ranks, against the same command on one card: 2 epochs from files by
   SGD (every logged loss within 1e-4 relative, the validation loss after
   two updates apart by at most 1e-2 of what they moved it) and by Adam (step 1's loss, before any update, at
   1e-5 relative; the later gaps printed), and ``--inference --save_flow``
   of the seeded weights (every flow written once, EPE < 1e-4 against one
   card's); a failure there fails the run after the scaling table;
   the all-reduce of a step's 162,518,834 float32 gradients alone (ms and
   bus bandwidth) on 2 and 4 cards; weak scaling, FlowNet2 fp32 and bf16
   train steps at 8 pairs a card: ms/step, frames/s and efficiency against
   linear at 1, 2 and 4 cards; then phase 5f(d).
5f. Row bands across ranks (``DataParallelPlan(spatial=2)``: each rank one
   band of the height, the convolutions' halos exchanged, f2 and the warp's
   image gathered over the band's group), after phase 5e, in fresh
   processes: two ranks over gloo on the one card, FlowNet2 fp32 of the
   seeded weights, TF32 off, cuDNN deterministic.  Inference of b8 384x512
   pairs drawn by numpy from BAND_SEED, the bands and stripes gathered:
   EPE < 1e-4 against one process; one Adam 1e-4 step of phase 5e's batch
   through ``StepFactory(plan=...)``: the ranks' parameters bit-equal after
   it, the global loss within 1e-5 relative and the gradients per sub-net
   within 5e(a)'s gates of the one-process step's (flownetc and flownets_1
   printed only); each rank's launches exact (a forward: one K7 forward,
   two one-flow and one two-flow local-rows K2; a step adds one K7 d_f1
   and d_slab and the local-rows K4 likewise; no plain-op call), and the
   dispatch log names the process-group compositions of the correlation,
   the warp, the convolutions and the upsample.  Then bands of unequal
   height (granules of 64 rows): inference of b4 448x1024 pairs (MPI-Sintel
   padded) as bands of 256 and 192 rows, in fp32 (EPE < 1e-4 against one
   process) and in bf16 (the JAX package's bf16 contract of the one-process
   bf16 model), the gathered flows bit-equal on both ranks, each rank's
   launches exact; and whether gloo takes a bf16 all-reduce of CUDA
   tensors.  ``--data-parallel`` runs phase 5f(d) after 5e(d): the same
   gates over NCCL, in fp32 at spatial 2 on 2 cards, at data 2 x spatial 2
   on 4 and at spatial 4 on 4 (bands of 128, 128, 64 and 64 rows), and in
   bf16 (flows at the bf16 contract, loss at 5e-3, sub-nets at phase 5b's
   gates) at spatial 2 on 2 cards and 2 x 2 on 4, each timed (10 steps
   after 2 with cuDNN's defaults: ms/step and frames/s of the global batch
   of 8 at 384x448, beside the same step and dtype on one card without
   bands) and profiled on rank 0 by family (NCCL all-gather: the halos and
   gathers; NCCL all-reduce: DDP's gradients and the gathers' transposes);
   and the plain command with ``--spatial_shards 2`` and with
   ``--spatial_shards 4`` (crops of 384x448 in bands of 128, 128, 64, 64)
   on 4 cards, which starts 4 ranks, against one card: 2 epochs by SGD at
   5e(d)'s gates and ``--inference --save_flow`` of the seeded weights
   (EPE < 1e-4).  ``python3 chip_smoke.py --data-parallel --spatial`` runs
   phase 5f(d) alone.
6. Each kernel's time, its plain version's time, the card's bound for the
   same work and, where one PyTorch call computes the same function, that
   call's time, at the main-path shapes (K7 at one band of two; the bf16
   forms of K1, K2 at the bf16 forward's shapes and of K3, K4, K5, K6 at
   the bf16 step's, their operations at the bf16 tensor-core rate and,
   for the warps, whose bodies upcast and sum in f32, also at the f32
   rate; K7 bf16 at one band of two of the bf16 forward's and step's maps,
   likewise; the fp16 forms at the bf16 forms' shapes and fp16 bytes, their
   operations at the fp16 tensor-core rate and, for those whose bodies sum
   on the FMA pipes (the warps), also at the f32 rate, the warps beside
   ``F.grid_sample`` on fp16 tensors, whose fp16 grid's error in pixels is
   printed; the fp16 correlation kernels (K1, K5, K6 and K7's three), which
   share the bf16 tensor-core bodies, each beside its bf16 form, and the
   phase fails if K1, K5 or K6 fp16 takes more than 1.5x its bf16 form, as
   a route that stayed on the general body, ~8-10x, would), each beside
   the SM clock, the two-flow K4 (+-8 px and +-200 px at (8, 3, 384, 448))
   among them, and K3's four forms with their share of the bound beside
   their times before the row tiles; K2, K3 and K4, one and two flows, f32
   and bf16, at the smooth flow beside their times at the noise flows;
   then the one-flow K2 and K4 and their library calls with a cold L2
   cache (six input sets of 31-44 MB taken in turn); then the cfg
   kernels (``cfg_times``) in float32, bf16 and fp16, the correlation's
   three at (8, 256, 48, 64) at (21, 3, 20, 1, 2), the bilinear K 3 warp,
   its flow gradient and the nearest warp (beside ``F.grid_sample(mode=
   "nearest")``) at (8, 3, 384, 512), +-8 px, their launches those of
   phase 2's op-surface gate; the f32 correlation at (20, 1, 20, 2, 2) and
   the warps at K 2 and at +-200 px printed beside.
7. Where the device time goes: the phase 3 model and pair, 5 forwards, the
   phase 3b bf16 model, 5 forwards, and the phase 4 train step, 3 steps,
   under torch.profiler, the device time summed by kernel family and the
   device's idle share of the profiled window; the fp32 forward's
   convolution kernels by name, marked where one forward with
   cudnn.deterministic does not run them; the bf16 forward's convolution
   and NCHW<->NHWC layout-conversion kernels by name with their launches;
   then the phase 4b bf16 train step, 3 steps, by family (convolution
   forward, dgrad and wgrad, layout conversions, copies and casts, the
   port's kernels, Adam) with its layout-conversion launches a step; the
   fp32 and the bf16 step on the tangent route, 3 steps each, for K3's
   device time a step.  Raises if no device time is recorded.
8. The readings of phases 3 to 7 again, one JSON line listing the kernels
   (the rows of the kernels phase 5f's step runs also carry
   ``launches_bands_across_ranks``, a rank's launches of that step, and
   those its bands of unequal height run ``launches_unequal_bands_across_
   ranks``, a rank's launches of one such forward); the last line is the
   result.

Uses one card, the first the environment lists (``--data-parallel``: every
card it lists; with ``--spatial``, phase 5f(d) alone).  Exits non-zero,
printing no result, where no CUDA device is available or the package is
not beside this script.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

# one card: the first one the environment lists (before torch sees CUDA);
# phase 5e's multi-card part (--data-parallel) and its ranks (--rank-task)
# see the cards the environment lists
CARDS = os.environ.get("CUDA_VISIBLE_DEVICES")
FIRST_CARD = (CARDS or "0").split(",")[0]
if not {"--data-parallel", "--rank-task"} & set(sys.argv[1:2]):
    os.environ["CUDA_VISIBLE_DEVICES"] = FIRST_CARD

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = Path(__file__).resolve().parent

# Kernel families of the phase 6 profiles, by kernel name; the first match
# wins.  cuDNN's kernels include its FFT algorithm's transforms and
# pointwise complex products.
CONV = re.compile(r"conv|cudnn|gemm|xmma|sm90|sm80|implicit|wgrad|dgrad|"
                  r"fprop|winograd|fft|complex", re.I)
FAMILIES = (
    ("correlation_fwd (K1)", re.compile(r"correlation_fwd")),
    ("resample2d_fwd (K2)", re.compile(r"resample2d_fwd")),
    ("convolution", CONV),
    ("other PyTorch kernels", re.compile(r".")),
)
# The bf16 forward's families: cuDNN's NCHW <-> NHWC layout conversions
# (its bf16 kernels are NHWC; a channels_last model would not run them;
# tensorTransformGeneric is its generic layout transform) and the copies,
# the dtype casts of the parameters at each call among them, apart from
# the rest.
BF16_FAMILIES = (
    ("correlation_fwd (K1 bf16)", re.compile(r"correlation_fwd")),
    ("resample2d_fwd (K2 bf16)", re.compile(r"resample2d_fwd")),
    ("layout conversions NCHW<->NHWC",
     re.compile(r"nchwToNhwc|nhwcToNchw|tensorTransform", re.I)),
    ("convolution", CONV),
    ("copies and dtype casts", re.compile(r"copy", re.I)),
    ("other PyTorch kernels", re.compile(r".")),
)
# The bf16 train step's families: the train families with the bf16
# forward's layout conversions and casts apart.
BF16_TRAIN_FAMILIES = (
    ("correlation_fwd (K1 bf16)", re.compile(r"correlation_fwd")),
    ("correlation_bwd_f1 (K5 bf16)", re.compile(r"correlation_bwd_f1")),
    ("correlation_bwd_f2 (K6 bf16)", re.compile(r"correlation_bwd_f2")),
    ("resample2d_fwd (K2 bf16)", re.compile(r"resample2d_fwd")),
    ("resample2d_tangents (K3 bf16)", re.compile(r"resample2d_tangents")),
    ("resample2d_grad_flow (K4 bf16)", re.compile(r"resample2d_grad_flow")),
    ("optimizer (Adam)", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("layout conversions NCHW<->NHWC",
     re.compile(r"nchwToNhwc|nhwcToNchw|tensorTransform", re.I)),
    ("convolution wgrad", re.compile(r"wgrad", re.I)),
    ("convolution dgrad", re.compile(r"dgrad", re.I)),
    ("convolution forward and other cuDNN", CONV),
    ("copies and dtype casts", re.compile(r"copy", re.I)),
    ("other PyTorch kernels", re.compile(r".")),
)
TRAIN_FAMILIES = (
    ("correlation_fwd (K1)", re.compile(r"correlation_fwd")),
    ("correlation_bwd (K5, K6)", re.compile(r"correlation_bwd")),
    ("resample2d_fwd (K2)", re.compile(r"resample2d_fwd")),
    ("resample2d_tangents (K3)", re.compile(r"resample2d_tangents")),
    ("resample2d_grad_flow (K4)", re.compile(r"resample2d_grad_flow")),
    ("optimizer (Adam)", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("convolution wgrad", re.compile(r"wgrad", re.I)),
    ("convolution dgrad", re.compile(r"dgrad", re.I)),
    ("convolution forward and other cuDNN", CONV),
    ("other PyTorch kernels", re.compile(r".")),
)
# K3's times before its row tiles, in the one-pixel-a-thread form (PERF.md's
# kernel table: this script's phase 6 on an NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's
K3_BEFORE_MS = {"resample2d_tangents": 0.0443,
                "resample2d_tangents_multi": 0.0989,
                "resample2d_tangents_bf16": 0.0381,
                "resample2d_tangents_multi_bf16": 0.0844}
PROFILED_FORWARDS = 5
COLD_SETS = 6          # input sets a cold-cache timing takes in turn
PROFILED_STEPS = 3

# Published peaks: (memory bytes/s, float32 FLOP/s outside the tensor
# cores, dense bf16 tensor-core FLOP/s), from NVIDIA's data sheets; the
# first name that the card's name contains is taken.
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989e12)}

DEVICE = "cuda"
BATCH, HEIGHT, WIDTH = 8, 384, 512
TIMED_BATCHES = 10
TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH = 8, 384, 448
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
ROUTES = ("grad_flow", "tangents")
ROUTE_ROUNDS = 1
SHARDS = 2
# phase 5c: FlyingChairs-format files at FlyingChairs' size, trained on at
# phase 4's crop and batch
CHAIRS_TRAIN, CHAIRS_VAL, CHAIRS_HEIGHT, CHAIRS_WIDTH = 24, 8, 384, 512
# phase 5d: the command line on 17 frames (16 pairs, 2 batches), on 16
# training pairs (2 steps an epoch) and 8 validation pairs, from the weights
# of a caffemodel written from the seeded model
CLI_FRAMES, CLI_TRAIN, CLI_VAL, CLI_SEED = 17, 16, 8, 5
FLOWNET2_PARAMS = 162_518_834
# phase 5e: the global batch of phase 4's size, drawn by numpy from DP_SEED
# (every rank draws it alike), DP_STEPS steps a run; weak scaling times
# SCALE_STEPS steps after SCALE_WARMUP at TRAIN_BATCH pairs a card
DP_SEED, DP_STEPS = 19, 3
SCALE_STEPS, SCALE_WARMUP = 10, 2
# phase 5f: the inference pairs of phase 3's size, drawn by numpy from
# BAND_SEED (every rank draws them alike); and WIDE_BATCH pairs at
# MPI-Sintel's width, its 436 rows padded to 448: two bands of unequal
# height (256 and 192 rows), in fp32 and in bf16
BAND_SEED = 23
WIDE_BATCH, WIDE_HEIGHT, WIDE_WIDTH = 4, 448, 1024
# a collective that waits longer fails its rank, and torchrun the task
GROUP_TIMEOUT = datetime.timedelta(minutes=5)
# the sub-nets whose gradients sit on the noise line between two forwards
# that differ in the last bit (ROADMAP.md, section 3): printed, not gated
DP_GATES = {"flownetc": None, "flownets_1": None, "flownets_2": 1e-3,
            "flownets_d": 1e-3, "flownetfusion": 1e-3}
# the bf16 bands' step against one process's: phase 5b's gates (5e-2 in
# relative L2; flownetc and flownets_1 printed only)
BF16_BAND_GATES = {"flownetc": None, "flownets_1": None}
# phase 5e(d)'s command line trains with SGD at DP_CLI_LR, whose update
# scales with the gradient (Adam's first steps are about lr times its sign,
# whatever its size): each logged loss on every card within DP_CLI_RTOL of
# one card's, and the validation loss after two updates apart from one
# card's by at most DP_CLI_SHARE of how far those updates moved it
DP_CLI_LR, DP_CLI_RTOL, DP_CLI_SHARE = 3e-6, 1e-4, 1e-2
# the fp16 phases' static loss scale: the command line's --fp16_scale
# default
FP16_SCALE = 1024.0
# the fp16 kernels that run the bf16 tensor-core bodies at maxd 20, s2 2,
# and whether phase 6 gates each one's time against its bf16 form's
FP16_TENSOR_CORE_ROWS = {"correlation_fwd_fp16": True,
                         "correlation_bwd_f1_fp16": True,
                         "correlation_bwd_f2_fp16": True,
                         "correlation_fwd_rows_fp16": False,
                         "correlation_bwd_f1_rows_fp16": False,
                         "correlation_bwd_f2_rows_fp16": False}


# phase 2's maps of the correlation at the configurations no model uses
# (cfg_kernels) are normal values times this: the K 3 volume divides by
# K*K*C = 2304, and of unit maps its values reach only ~0.1, where an fp16
# subnormal step (6e-8) is half ulp_err's atol (1e-6 of the largest value)
# and two float32 sum orders part by more than it near 0; FlowNetC's
# features are of order 1 to 10
CFG_CORR_SCALE = 4.0


# The readings of the timed phases, printed where they are taken and again
# before the kernels line, so that the end of the output carries them
SUMMARY: list = []


def note(line: str) -> None:
    """Print ``line`` and keep it for the summary at the end."""
    print(line)
    SUMMARY.append(line)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def bound_ms(nbytes: float, flops: float, peaks,
             tensor_cores: bool = False):
    """The larger of the bytes' time at the memory rate and the operations'
    at the float32 rate outside the tensor cores (or, with
    ``tensor_cores``, at the dense bf16 tensor-core rate), and which."""
    bw, f32, bf16_tc = peaks
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / (bf16_tc if tensor_cores else f32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def corr_flops(b: int, c: int, h: int, w: int, slab: bool = False,
               maxd: int = 20, s2: int = 2) -> int:
    """Flops of the correlation (forward, d_f1 and d_f2 alike) that touch
    data: a shift's multiply-add counts only where its f2 row and column lie
    inside the map (the kernels skip or zero-pad the rest).  A slab holds
    every row it is read at, so with ``slab`` all row shifts count."""
    shifts = range(-(maxd // s2), maxd // s2 + 1)
    rows = (len(shifts) * h if slab
            else sum(max(0, h - s2 * abs(t)) for t in shifts))
    cols = sum(max(0, w - s2 * abs(t)) for t in shifts)
    return 2 * b * c * rows * cols


def time_ms(fn, iters: int, warmup: int = 3,
            head_start: bool = False) -> float:
    """Milliseconds per call of ``fn`` by CUDA events.  With ``head_start``
    the card first spins for some 30 ms, so that the host has queued the
    launches before the card reaches them: a kernel shorter than its
    wrapper's time on the host otherwise reads as the host's launch rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if head_start:
        torch.cuda._sleep(60_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fns, iters: int) -> float:
    """Milliseconds per call, with the head start, of calls that take the
    functions in ``fns`` in turn: each works on buffers of its own, and
    together they hold several times the 50 MB L2 cache, so that every call
    finds its inputs in device memory, as a warp finds a fresh image in a
    model."""
    return time_ms(lambda it=iter(range(1 << 62)): fns[next(it) % len(fns)](),
                   iters, warmup=len(fns), head_start=True)


def sm_clock() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def tensor_core_bodies(logs: dict) -> list:
    """ptxas's registers and spilled bytes for each instantiation of the
    correlation's tensor-core bodies (K1's, K5's and K6's, each for bf16
    and half), read from the build's logs of ``csrc/correlation_fwd.cu``
    and ``csrc/correlation_bwd.cu``."""
    lines, kernel, spill = [], "", "0"
    for lib in ("correlation_fwd", "correlation_bwd"):
        for line in logs.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                kernel, spill = line.split("'")[1], "0"
            elif "spill stores" in line:
                spill = line.split(",")[1].split()[0]
            elif "registers" in line:
                # the body's own name follows its length, the namespace
                # (correlation_fwd_cu_...) a "_N_"; the element type its
                # length
                m = re.search(r"\d(correlation_\w+?_mma_kernel)I"
                              r"\d+(\w+?)Lb([01])ELi(\d+)E", kernel)
                if m:
                    body, dtype, slab, piece = m.groups()
                    regs = line.split("Used ")[1].split()[0]
                    lines.append(
                        f"{body}<{dtype}, slab {slab}, "
                        f"{piece} a copy>: {regs} registers, {spill} bytes "
                        "spilled")
    return sorted(lines)


def max_err(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float, what: str) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol,
                                                     atol=atol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs diff {err:.3e})")
    print(f"  {what}: max abs diff {err:.3e} (rtol/atol {rtol:g}/{atol:g})")
    return err


# The low-precision element types: the bits of their significand after
# the point (one ulp is 2**-bits relative), and their short names
ULP_BITS = {torch.bfloat16: (7, "bf16"), torch.float16: (10, "fp16")}


def ulp_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """A bfloat16 or float16 kernel against its plain version (both of one
    dtype): every element within one ulp of that dtype (rtol 2**-7 for
    bf16, 2**-10 for fp16, atol 1e-6 of the largest |want|) and at most 1%
    of the elements not bit-equal."""
    torch.cuda.synchronize()
    if got.dtype not in ULP_BITS or want.dtype != got.dtype:
        raise AssertionError(f"{what}: {got.dtype} and {want.dtype}, not "
                             "one bfloat16 or float16 dtype")
    bits, short = ULP_BITS[got.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    flips = (got != want).float().mean().item()
    atol = 1e-6 * w.abs().max().item()
    print(f"  {what}: max abs diff {err:.3e}, not bit-equal {flips:.4%} "
          f"(rtol 2^-{bits}, atol {atol:.2e}; at most 1%)")
    if got.shape != want.shape or not torch.allclose(
            g, w, rtol=2.0 ** -bits, atol=atol) or flips > 0.01:
        raise AssertionError(f"{what}: {short} kernel disagrees with its "
                             "plain version")
    return err


def bf16_contract(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The JAX package's bf16 contract (tests/test_models.py,
    TestBf16Precision): mean |got - want| < 0.05 (mean |want| + 1e-3)
    + 5e-3, with the relative L2 printed."""
    g, w = got.double().cpu(), want.double().cpu()
    err = (g - w).abs().mean().item()
    limit = 0.05 * (w.abs().mean().item() + 1e-3) + 5e-3
    rel = ((g - w).norm() / w.norm()).item()
    note(f"  {what}: mean error {err:.4g} against {limit:.4g}, relative L2 "
         f"{rel:.3e}")
    if not (torch.isfinite(g).all() and err < limit):
        raise AssertionError(f"{what}: outside the bf16 contract")


def grad_errors(got: dict, want: dict):
    """(worst ratio of a tensor's max |difference| to its max |g|, that
    tensor's name, |all differences| / |all gradients| in L2)."""
    worst, worst_name, diff2, norm2 = 0.0, None, 0.0, 0.0
    for name, w in want.items():
        w = w.double().cpu()
        d = got[name].double().cpu() - w
        ratio = (d.abs().max() / w.abs().max().clamp_min(1e-30)).item()
        if ratio >= worst:
            worst, worst_name = ratio, name
        diff2 += d.square().sum().item()
        norm2 += w.square().sum().item()
    return worst, worst_name, (diff2 / max(norm2, 1e-300)) ** 0.5


def subnets_close(got: dict, want: dict, gates: dict, what: str) -> None:
    """The gradients of each sub-net (the parameter name's first part)
    within ``gates.get(sub-net, 5e-2)`` of ``want`` in relative L2; a gate
    of None only prints the reading.  The worst single tensor is printed."""
    worst, worst_name = 0.0, None
    diff2, norm2 = {}, {}
    for name, w in want.items():
        w = w.double().cpu()
        d2 = (got[name].double().cpu() - w).square().sum().item()
        n2 = w.square().sum().item()
        rel = (d2 / max(n2, 1e-300)) ** 0.5
        if rel >= worst:
            worst, worst_name = rel, name
        sub = name.split(".")[0]
        diff2[sub] = diff2.get(sub, 0.0) + d2
        norm2[sub] = norm2.get(sub, 0.0) + n2
    failed = []
    readings = []
    for sub in sorted(diff2):
        rel = (diff2[sub] / max(norm2[sub], 1e-300)) ** 0.5
        gate = gates.get(sub, 5e-2)
        readings.append(f"{sub} {rel:.3e}" + ("" if gate is not None
                                              else " (printed only)"))
        if gate is not None and rel > gate:
            failed.append(sub)
    note(f"  {what}: relative L2 {', '.join(readings)}; worst tensor "
         f"{worst:.3e} ({worst_name})")
    if failed:
        raise AssertionError(f"{what}: {failed} beyond their gates in "
                             "relative L2")


def grads_close(got: dict, want: dict, tol: float, what: str,
                per_tensor: bool = True) -> None:
    """Every gradient within ``tol`` of its tensor's largest |g| or, with
    ``per_tensor`` False, all gradients within ``tol`` in relative L2."""
    worst, name, rel = grad_errors(got, want)
    print(f"  {what}: worst tensor {worst:.3e} of its max |g| ({name}); "
          f"all {len(want)} gradients {rel:.3e} in relative L2")
    if not (worst if per_tensor else rel) <= tol:
        raise AssertionError(f"{what}: gradients differ beyond {tol:g} "
                             f"{'per tensor' if per_tensor else 'in L2'}")


def nondeterministic_ops(run) -> list:
    """The ops that torch names, while ``run()`` runs under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, as having
    no deterministic implementation ("cuBLAS" for its alert on a cuBLAS
    call): from its Python warnings and from what its C++ side writes to
    the process's standard error (where an alert raised off the Python
    thread, in the autograd engine's, goes).  Under torch 2.11 it names
    nothing for torch's bilinear upsample backward, which then runs
    deterministically and raises no alert; two backward passes over one
    forward (``backward_twice``) are what show that op's atomics."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as err, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        os.dup2(err.fileno(), 2)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        err.seek(0)
        lines = (err.read().decode(errors="replace").splitlines()
                 + [str(w.message) for w in caught])
    # "<op> does not have ..." in a warning, "... Warning: <op> does not
    # have ..." in a C++ log line
    named = set()
    for line in lines:
        text = line.split("Warning: ")[-1]
        if "does not have a deterministic implementation" in text:
            named.add(text.split()[0])
        elif "is not deterministic because it uses CuBLAS" in text:
            named.add("cuBLAS")
    return sorted(named)


def d_img_float64(r2d, g: torch.Tensor, img: torch.Tensor,
                  flows: torch.Tensor) -> torch.Tensor:
    """The warp's image gradient of ``ops/resample2d.py`` summed in float64
    by ``scatter_add_`` (whose atomics leave an order-dependent error far
    below float32's): phase 2's reference for F4."""
    batch, channels, height, width = img.shape
    out = torch.zeros(batch, channels, height * width, dtype=torch.float64,
                      device=img.device)
    for f in range(flows.shape[1]):
        a, b, x_l, x_r, y_t, y_b = r2d._sample_point(flows[:, f], height,
                                                     width)
        gf = g[:, f].reshape(batch, channels, -1).double()
        a = a.reshape(batch, 1, -1).double()
        b = b.reshape(batch, 1, -1).double()
        for yi, xi, w in ((y_t, x_l, (1 - a) * (1 - b)),
                          (y_t, x_r, a * (1 - b)),
                          (y_b, x_l, (1 - a) * b), (y_b, x_r, a * b)):
            idx = (yi * width + xi).reshape(batch, 1, -1).expand_as(gf)
            out.scatter_add_(2, idx, w * gf)
    return out.reshape(img.shape)


def profile_families(run, n: int, families, smi: str, unit: str,
                     say=print):
    """Profile ``run()`` (n repetitions of the work) and print (by ``say``)
    the device time by kernel family and the idle share of the window.
    Returns each kernel's device microseconds and its launch count over the
    window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: their self device time is the kernel's own time
    per_kernel, counts = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        # (a user annotation's device range spans the kernels inside it)
        if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    busy_ms = sum(per_kernel.values()) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    totals = {name: 0.0 for name, _ in families}
    for key, us in per_kernel.items():
        totals[next(n for n, rx in families if rx.search(key))] += us / 1e3
    say(f"  wall {wall_ms / n:.3f} ms/{unit}, device busy {busy_ms / n:.3f} "
        f"ms/{unit}, idle share {1 - busy_ms / wall_ms:.4f}  [{smi}]")
    for name, fam_ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        say(f"  {name:38s} {fam_ms / n:9.3f} ms/{unit}  "
            f"{fam_ms / busy_ms:7.2%}")
    print("  top kernels:")
    for key, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / n:9.3f} ms/{unit}  {key[:100]}")
    return per_kernel, counts


def trainer_phase(smi: str, phase4_ms: float, phase4b_ms: float) -> float:
    """Phase 5c: FlowNet2 trained from files on disk through the Trainer.
    FlyingChairs-format pairs in a temporary directory; the loader alone
    and through ``device_prefetch`` (every device batch bit-equal to its
    host batch); run A, ``Trainer.fit`` over 2 epochs of 3 fp32 steps with
    validation at epoch 0, and run B, epoch 0, then a new model, optimizer,
    StepFactory and Trainer resumed from B's train-checkpoint for epoch 1:
    bit-equal to A in parameters, Adam's state, count, best EPE and logged
    losses (cuDNN deterministic); ms/step through the Trainer in fp32 and
    bf16 with cuDNN's defaults beside phases 4 and 4b; ``Trainer.inference``
    over the validation pairs, its .flo files bit-equal to ``infer_step``'s
    flows.  Returns the fp32 ms/step through the Trainer."""
    import numpy as np
    from PIL import Image

    from flownet2_tpu_torch import native
    from flownet2_tpu_torch.checkpoints import native as ckpt
    from flownet2_tpu_torch.data import (DataLoader, DeviceLoader,
                                         FlyingChairs, device_prefetch,
                                         read_flo, write_flo)
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.train import (StepFactory, Trainer, TrainerConfig,
                                          get_optimizer)
    from flownet2_tpu_torch.train import trainer as trainer_module

    t_phase = time.perf_counter()
    print(f"phase 5c: FlowNet2 trained from FlyingChairs-format files "
          f"({CHAIRS_TRAIN} training and {CHAIRS_VAL} validation pairs, "
          f"{CHAIRS_HEIGHT}x{CHAIRS_WIDTH}) through the Trainer, crops "
          f"{TRAIN_HEIGHT}x{TRAIN_WIDTH}, batch {TRAIN_BATCH}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_5c_"))
    try:
        # -- data: FlyingChairs' own format, from a seeded generator
        rng = np.random.default_rng(0)
        for split, n in (("train", CHAIRS_TRAIN), ("val", CHAIRS_VAL)):
            (work / split).mkdir()
            for i in range(n):
                for j in (1, 2):
                    Image.fromarray(rng.integers(
                        0, 256, (CHAIRS_HEIGHT, CHAIRS_WIDTH, 3),
                        dtype=np.uint8)).save(
                            work / split / f"{i:05d}_img{j}.ppm")
                write_flo(work / split / f"{i:05d}_flow.flo",
                          rng.standard_normal(
                              (CHAIRS_HEIGHT, CHAIRS_WIDTH, 2),
                              dtype=np.float32) * 4)
        if native.available():
            decoder = "native"
        else:
            reason = native.build_error()
            lines = reason.splitlines()
            decoder = "numpy ({})".format(next(
                (line for line in lines if "error" in line), lines[0])
                .strip()[:160])
            # the numpy route only where the libpng or libjpeg headers are
            # missing (or the switch is set)
            if not any(k in reason for k in ("png.h", "jpeglib.h",
                                             native.NO_NATIVE_ENV)):
                raise AssertionError(f"the native decoders did not build: "
                                     f"{reason}")
        train_ds = FlyingChairs(root=str(work / "train"), is_cropped=True,
                                crop_size=(TRAIN_HEIGHT, TRAIN_WIDTH))
        val_ds = FlyingChairs(root=str(work / "val"))

        def loader_of(ds):
            return DataLoader(ds, batch_size=TRAIN_BATCH, shuffle=True,
                              seed=0)

        # -- the loader alone, then through device_prefetch onto the card
        loader = loader_of(train_ds)

        def two_epochs():
            for epoch in (0, 1):
                loader.set_epoch(epoch)
                yield from loader

        t0 = time.perf_counter()
        host = list(two_epochs())
        loader_s = time.perf_counter() - t0
        prefetched = list(device_prefetch(two_epochs(), device=DEVICE))
        torch.cuda.synchronize()
        same = [torch.equal(d.images.cpu(), torch.from_numpy(h.images))
                and torch.equal(d.flow.cpu(), torch.from_numpy(h.flow))
                and d.n_valid == h.n_valid
                and d.images.device.type == torch.device(DEVICE).type
                for h, d in zip(host, prefetched)]
        note(f"  phase 5c, loader: decoder route {decoder}; "
             f"{len(host) / loader_s:.2f} batches/s alone ({len(host)} "
             f"batches of {TRAIN_BATCH} pairs in {loader_s:.3f} s); "
             f"device batches bit-equal to the host batches: "
             f"{sum(same)} of {len(host)}")
        if len(prefetched) != len(host) or not all(same):
            raise AssertionError("device_prefetch: a device batch differs "
                                 "from its host batch")
        del host, prefetched

        def on_card(ds):
            return DeviceLoader(loader_of(ds), device=DEVICE)

        saves, restores = [], []

        def timed_save(directory, model, optimizer, epoch, best_epe,
                       is_best=False, tag="train-checkpoint"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = ckpt.save_checkpoint(directory, model, optimizer, epoch,
                                        best_epe, is_best, tag)
            saves.append((tag, time.perf_counter() - t,
                          (Path(path) / ckpt.STATE_FILE).stat().st_size))
            return path

        def build(save_dir, total_epochs, dtype=torch.float32):
            model = get_model("FlowNet2", device=DEVICE, seed=0, dtype=dtype)
            factory = StepFactory(model, MultiScale(),
                                  get_optimizer("Adam", 1e-4))
            trainer = Trainer(factory, TrainerConfig(
                save_dir=str(work / save_dir), total_epochs=total_epochs,
                validation_frequency=2, checkpoint_frequency=2))
            epoch_s = []
            train_epoch = trainer.train_epoch

            def timed_epoch(loader, epoch, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = train_epoch(loader, epoch, **kw)
                torch.cuda.synchronize()
                epoch_s.append(time.perf_counter() - t)
                return out

            trainer.train_epoch = timed_epoch
            return factory, trainer, epoch_s

        def records(save_dir):
            with open(work / save_dir / "run.metrics.jsonl") as f:
                return [json.loads(line) for line in f]

        def steps_of(recs):
            return [(r["step"], r["split"], r["loss"], r["epe"])
                    for r in recs]

        def train_state(factory):
            inner = factory.optimizer.inner.state_dict()["state"]
            return ([p.detach() for p in factory.model.parameters()],
                    [v for k in sorted(inner)
                     for _, v in sorted(inner[k].items())],
                    factory.optimizer.count)

        # -- run A and run B (killed after epoch 0 and resumed), fp32
        torch.backends.cudnn.deterministic = True
        with mock.patch.object(trainer_module, "save_checkpoint",
                               timed_save):
            factory_a, trainer_a, epochs_a = build("a", 2)
            trainer_a.fit(on_card(train_ds), on_card(val_ds))
            factory_b, trainer_b, _ = build("b", 1)
            trainer_b.fit(on_card(train_ds), on_card(val_ds))
            del factory_b, trainer_b
            gc.collect()
            torch.cuda.empty_cache()
            factory_b, trainer_b, _ = build("b", 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            meta = trainer_b.resume()
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t)
            trainer_b.fit(on_card(train_ds), on_card(val_ds))
        torch.backends.cudnn.deterministic = False
        pa, ma, ca = train_state(factory_a)
        pb, mb, cb = train_state(factory_b)
        equal = {
            "parameters": len(pa) == len(pb) and all(
                torch.equal(x, y) for x, y in zip(pa, pb)),
            "Adam state": len(ma) == len(mb) > 0 and all(
                torch.equal(x, y) for x, y in zip(ma, mb)),
            "step count": ca == cb == 2 * len(train_ds) // TRAIN_BATCH,
            "best EPE": trainer_a.best_epe == trainer_b.best_epe
            and math.isfinite(trainer_a.best_epe),
            "logged losses": steps_of(records("a")) == steps_of(records("b")),
        }
        rec_a = records("a")
        train_a = [r for r in rec_a if r["split"] == "train"]
        load = [r["load_s"] for r in train_a]
        note(f"  phase 5c, fp32 run B (killed after epoch 0, resumed at "
             f"epoch {meta['epoch']}) against run A: "
             + ", ".join(f"{k} bit-equal {v}" for k, v in equal.items())
             + f"; {ca} steps, best EPE {trainer_a.best_epe:.6f}, last loss "
             f"{train_a[-1]['loss']:.6f}")
        if not all(equal.values()) or not all(
                math.isfinite(r["loss"]) for r in rec_a):
            raise AssertionError(f"the resumed run differs from run A: "
                                 f"{equal}")
        note(f"  phase 5c, fp32 through the Trainer, cuDNN deterministic: "
             f"epochs {', '.join(f'{s * 1e3 / 3:.3f}' for s in epochs_a)} "
             f"ms/step (3 steps an epoch, the loader's waits included); "
             f"load_s mean {sum(load) / len(load) * 1e3:.3f} ms a batch, "
             f"first of each epoch {load[0] * 1e3:.3f}, "
             f"{load[len(load) // 2] * 1e3:.3f}  [{smi}]")
        note("  phase 5c, checkpoints: " + "; ".join(
            f"save {tag} {sec:.3f} s {size} bytes"
            for tag, sec, size in saves)
            + f"; restore {restores[0]:.3f} s")
        del factory_b, trainer_b, pb, mb

        # -- inference over the validation pairs, then ms/step with cuDNN's
        # defaults, as phases 4 and 4b time the bare step
        torch.backends.cudnn.deterministic = True
        flo_dir, png_dir = work / "flows", work / "png"
        n, means = trainer_a.inference(on_card(val_ds),
                                       save_flow_dir=str(flo_dir),
                                       visualize_dir=str(png_dir))
        (val_batch,) = list(loader_of(val_ds))
        flows = factory_a.infer_step()(
            torch.from_numpy(val_batch.images).to(DEVICE)).float().cpu()
        torch.backends.cudnn.deterministic = False
        files = sorted(os.listdir(flo_dir))
        written = [torch.from_numpy(read_flo(flo_dir / f)) for f in files]
        match = len(written) == len(flows) and all(
            torch.equal(a, b) for a, b in zip(written, flows))
        note(f"  phase 5c, inference: {n} flows, {len(files)} .flo and "
             f"{len(os.listdir(png_dir))} PNG files, bit-equal to "
             f"infer_step's flows {match}; EPE {means['epe']:.6f} over "
             f"{means['n_samples']} pairs")
        if not (match and n == len(files) == CHAIRS_VAL
                and len(os.listdir(png_dir)) == CHAIRS_VAL
                and math.isfinite(means["epe"])):
            raise AssertionError("Trainer.inference: the written flows are "
                                 "not infer_step's")
        del flows, written

        def timed_trainer(trainer, epoch_s, save_dir, epochs):
            """Train ``epochs`` through train_epoch; ms/step of the last two,
            the same less the loader's waits (load_s) and the longest
            wait, in ms."""
            loader = on_card(train_ds)
            for epoch in epochs:
                loader.set_epoch(epoch)
                trainer.train_epoch(loader, epoch)
            n = 2 * len(loader)
            load = [r["load_s"] for r in records(save_dir)
                    if r["split"] == "train"][-n:]
            wall = sum(epoch_s[-2:])
            return (wall * 1e3 / n, (wall - sum(load)) * 1e3 / n,
                    max(load) * 1e3)

        fp32 = timed_trainer(trainer_a, epochs_a, "a", (2, 3))
        del factory_a, trainer_a, pa, ma
        gc.collect()
        torch.cuda.empty_cache()
        # the bf16 model: one epoch to warm up, then two timed
        factory16, trainer16, epochs16 = build("bf16", 3, torch.bfloat16)
        bf16 = timed_trainer(trainer16, epochs16, "bf16", (0, 1, 2))
        for what, (ms, less, wait), bare, phase in (
                ("fp32", fp32, phase4_ms, "4"),
                ("bf16", bf16, phase4b_ms, "4b")):
            note(f"  phase 5c, {what} through the Trainer, cuDNN's defaults, "
                 f"2 epochs of 3 steps: {ms:.3f} ms/step, {less:.3f} less "
                 f"the loader's waits (the longest {wait:.3f} ms), against "
                 f"the bare step's {bare:.3f} (phase {phase})  [{smi}]")
        del factory16, trainer16
        gc.collect()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    note(f"  phase 5c took {time.perf_counter() - t_phase:.1f} s")
    return fp32[0]


def write_caffemodel(path: Path, state: dict, model_name: str) -> None:
    """A caffemodel in the release's V1 layout (NetParameter ``layers``)
    whose import is ``state`` (a reference-keyed state dict): each layer's
    weight, the first convolutions' BGR groups reversed, and its bias (a
    zero bias blob where the port's module has none; the import drops
    it)."""
    import numpy as np

    from flownet2_tpu_torch.checkpoints import caffe_import as ci

    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            low, v = v & 0x7F, v >> 7
            if not v:
                out.append(low)
                return bytes(out)
            out.append(low | 0x80)

    def field(number: int, payload: bytes) -> bytes:  # length-delimited
        return varint(number << 3 | 2) + varint(len(payload)) + payload

    def blob(a) -> bytes:
        dims = b"".join(varint(1 << 3) + varint(d) for d in a.shape)
        return field(7, dims) + field(5, a.astype("<f4").tobytes())

    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(field(1, b"net"))
        for kind, cprefix, tprefix in ci._MODEL_NETS[model_name]:
            first_conv, groups = ci._BGR[kind]
            for key, module, style in ci._net_table(kind, cprefix):
                mid = f"{module}.0" if style == ci.SEQ else module
                weight = state[f"{tprefix}{mid}.weight"].numpy().copy()
                if module == first_conv:
                    for lo, hi in groups:
                        weight[:, lo:hi] = weight[:, lo:hi][:, ::-1].copy()
                bias = state.get(f"{tprefix}{mid}.bias")
                bias = (np.zeros(weight.shape[1], np.float32) if bias is None
                        else bias.numpy())
                f.write(field(2, field(4, key.encode())
                              + field(6, blob(weight))
                              + field(6, blob(bias))))


def cli_phase(smi: str, phase4_ms: float, phase5c_ms: float,
              work: Path) -> dict:
    """Phase 5d: the command line and caffemodel import, FlowNet2 at full
    width.  (a) A caffemodel of the seeded model's weights (the first
    convolutions' BGR groups reversed) converted by ``python -m
    flownet2_tpu_torch.checkpoints.convert``: exit 0, one JSON line, the
    parameter count, the converted state dict bit-equal to the seeded
    model's.  (b) ``cli.main --inference --save_flow --resume <converted>``
    over 17 ImagesFromFolder frames at 384x512, b8, cuDNN deterministic:
    the launches a forward (1 K1, 2 one-flow and 1 two-flow K2, no plain-op
    call), the .flo files bit-equal to ``infer_step`` of the seeded model;
    with ``--spatial_shards 2`` (K7 forward and the local-rows K2) bit-equal
    to the whole map; with ``--precision bf16`` (the bf16 entry points)
    within the bf16 contract of the fp32 flows.  (c) ``cli.main`` training
    from FlyingChairs-format files (crops of 384x448, b8, 2 epochs of 2
    steps, validation each epoch) from a ``.pth.tar`` of the seeded weights,
    cuDNN deterministic: the launches of the steps and the validation
    forwards, no plain-op call, the final parameters bit-equal to
    ``Trainer.fit`` built by hand from the same pieces and files; then
    ``--resume <run>`` for a third epoch (cuDNN's defaults): the
    optimizer's count goes on from 4 to 6.  (d) One ``python -m
    flownet2_tpu_torch.cli --inference`` subprocess, one batch: exit 0.
    (e) ms/step through the command line beside phases 4 and 5c, inference
    seconds a batch, the phase's seconds.  Its files stay in ``work`` for
    phase 5e(c); returns what that phase needs of them."""
    import numpy as np
    from PIL import Image

    from flownet2_tpu_torch import cli, ops
    from flownet2_tpu_torch.checkpoints import load_checkpoint
    from flownet2_tpu_torch.checkpoints.native import STATE_FILE
    from flownet2_tpu_torch.data import (DataLoader, DeviceLoader,
                                         get_dataset, read_flo, write_flo)
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import stage_glue
    from flownet2_tpu_torch.train import (LRSchedule, StepFactory, Trainer,
                                          TrainerConfig, get_optimizer,
                                          optimizer_param_defaults)
    from flownet2_tpu_torch.train import trainer as trainer_module

    t_phase = time.perf_counter()
    print(f"phase 5d: the command line and caffemodel import, FlowNet2 "
          f"b{BATCH} {HEIGHT}x{WIDTH} inference and b{TRAIN_BATCH} "
          f"{TRAIN_HEIGHT}x{TRAIN_WIDTH} training")
    rng = np.random.default_rng(1)
    walls = {"train_epoch": [], "inference": []}

    def timed(name):
        """The Trainer's ``name`` method, its wall time (the card
        synchronised at both ends) kept in ``walls[name]``."""
        original = getattr(trainer_module.Trainer, name)

        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = original(self, *args, **kwargs)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t)
            return out
        return mock.patch.object(trainer_module.Trainer, name, run)

    def run_cli(save, *argv):
        """``cli.main`` in this process on the card; its launches and
        plain-op calls over the whole call."""
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_counts()
        with timed("train_epoch"), timed("inference"):
            rc = cli.main([*argv, "--device", DEVICE, "--save",
                           str(work / save)])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"cli.main {argv} returned {rc}")
        return dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)

    def check_launches(what, got, plain, want):
        print(f"  {what}: launches {got}; plain-op calls {plain}")
        if got != want or plain:
            raise AssertionError(f"{what}: launches {got} / plain calls "
                                 f"{plain}; expected {want} / {{}}")

    def flo_files(save):
        d = work / save / "inference" / "flows"
        return [torch.from_numpy(read_flo(d / f))
                for f in sorted(os.listdir(d))]

    try:
        # -- (a) a FlowNet2 caffemodel of the seeded weights, converted
        state = get_model("FlowNet2", device="cpu", seed=CLI_SEED).state_dict()
        caffemodel = work / "FlowNet2" / "FlowNet2_weights.caffemodel"
        t = time.perf_counter()
        write_caffemodel(caffemodel, state, "FlowNet2")
        write_s = time.perf_counter() - t
        nbytes = caffemodel.stat().st_size
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "flownet2_tpu_torch.checkpoints.convert",
             str(caffemodel), str(work / "ckpts")], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        convert_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"convert exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        line = json.loads(lines[-1])
        converted = line["checkpoint"]
        timing = [ln for ln in proc.stderr.splitlines()
                  if ln.startswith("convert:")]
        got = torch.load(Path(converted) / STATE_FILE, map_location="cpu",
                         weights_only=True)
        equal = (list(got["model"]) == list(state) and all(
            torch.equal(got["model"][k], v) for k, v in state.items())
            and got["optimizer"] is None)
        note(f"  phase 5d, convert: a {nbytes}-byte FlowNet2 caffemodel "
             f"(written in {write_s:.3f} s) converted in {convert_s:.3f} s "
             f"by the subprocess ({timing[0][9:] if timing else '?'}); "
             f"exit 0, {len(lines)} line, arch {line['arch']}, "
             f"{line['params']} parameters; bit-equal to the seeded model "
             f"{equal}  [{smi}]")
        if not (len(lines) == 1 and line["arch"] == "FlowNet2"
                and line["params"] == FLOWNET2_PARAMS and equal):
            raise AssertionError(f"convert: {line}, bit-equal {equal}")
        del got
        caffemodel.unlink()
        pth = work / "FlowNet2_seeded.pth.tar"
        torch.save({"arch": "FlowNet2", "epoch": 0, "best_EPE": 1e10,
                    "state_dict": state}, pth)
        del state
        gc.collect()

        # -- (b) inference through cli.main, from the converted weights
        frames = work / "frames"
        frames.mkdir()
        for i in range(CLI_FRAMES):
            Image.fromarray(rng.integers(0, 256, (HEIGHT, WIDTH, 3),
                                         dtype=np.uint8)).save(
                frames / f"{i:03d}.png")
        infer_argv = ["--inference", "--save_flow", "--model", "FlowNet2",
                      "--batch_size", str(BATCH), "--inference_dataset",
                      "ImagesFromFolder", "--inference_dataset_root",
                      str(frames), "--resume", converted]
        n_fwd = -(-(CLI_FRAMES - 1) // BATCH)
        fwd = {"correlation_fwd": 1, "resample2d_fwd": 2,
               "resample2d_fwd_multi": 1}
        cases = (("fp32", [], fwd),
                 (f"{SHARDS} bands", ["--spatial_shards", str(SHARDS)],
                  {"correlation_fwd_rows": SHARDS,
                   "resample2d_fwd": 2 * SHARDS,
                   "resample2d_fwd_multi": SHARDS}),
                 ("bf16", ["--precision", "bf16"],
                  {k + "_bf16": v for k, v in fwd.items()}),
                 ("fp16", ["--precision", "fp16"],
                  {k + "_fp16": v for k, v in fwd.items()}),
                 (f"fp16 {SHARDS} bands", ["--precision", "fp16",
                                          "--spatial_shards", str(SHARDS)],
                  {"correlation_fwd_rows_fp16": SHARDS,
                   "resample2d_fwd_fp16": 2 * SHARDS,
                   "resample2d_fwd_multi_fp16": SHARDS}))
        torch.backends.cudnn.deterministic = True
        flows, infer_s = {}, {}
        for what, extra, per_fwd in cases:
            got, plain = run_cli(f"infer {what}", *infer_argv, *extra)
            check_launches(f"phase 5d, inference {what}, {n_fwd} forwards",
                           got, plain,
                           {k: v * n_fwd for k, v in per_fwd.items()})
            flows[what] = flo_files(f"infer {what}")
            infer_s[what] = walls["inference"][-1] / n_fwd
        # infer_step of the seeded model on the same pairs
        model = get_model("FlowNet2", device=DEVICE, seed=CLI_SEED)
        infer = StepFactory(model, MultiScale(),
                            get_optimizer("Adam", 1e-4)).infer_step()
        want = []
        for batch in DataLoader(get_dataset("ImagesFromFolder",
                                            root=str(frames)),
                                BATCH, shuffle=False, drop_last=False):
            out = infer(torch.from_numpy(batch.images).to(DEVICE))
            want.extend(out.float().cpu()[:batch.n_valid or len(out)])
        del model, infer
        same = {what: len(flows[what]) == len(want) == CLI_FRAMES - 1
                and all(torch.equal(a, b) for a, b in zip(flows[what], ref))
                for what, ref in (("fp32", want),
                                  (f"{SHARDS} bands", flows["fp32"]))}
        note(f"  phase 5d, inference through cli.main, {CLI_FRAMES - 1} "
             f"pairs: .flo bit-equal to infer_step of the seeded model "
             f"{same['fp32']}; {SHARDS} bands bit-equal to the whole map "
             f"{same[f'{SHARDS} bands']}; "
             + ", ".join(f"{what} {sec:.3f} s a batch"
                         for what, sec in infer_s.items())
             + f" (the first batch's decode and the .flo writes included)"
             f"  [{smi}]")
        if not all(same.values()):
            raise AssertionError(f"cli inference: {same}")
        bf16_contract(torch.stack(flows["bf16"]), torch.stack(flows["fp32"]),
                      "phase 5d, bf16 inference through cli.main against "
                      "fp32")
        bf16_contract(torch.stack(flows["fp16"]), torch.stack(flows["fp32"]),
                      "phase 5d, fp16 inference through cli.main against "
                      "fp32")
        bands16 = torch.stack(flows[f"fp16 {SHARDS} bands"])
        bf16_contract(bands16, torch.stack(flows["fp16"]),
                      f"phase 5d, fp16 inference through cli.main, {SHARDS} "
                      "bands against the whole map")
        del want, flows, bands16

        # -- (d) the real entry point, one batch
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "flownet2_tpu_torch.cli", *infer_argv,
             "--inference_n_batches", "1", "--device", DEVICE, "--save",
             str(work / "entry")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        entry_s = time.perf_counter() - t
        written = len(os.listdir(work / "entry" / "inference" / "flows")) \
            if proc.returncode == 0 else 0
        note(f"  phase 5d, python -m flownet2_tpu_torch.cli --inference, one "
             f"batch: exit {proc.returncode} in {entry_s:.1f} s, {written} "
             f".flo files")
        if proc.returncode != 0 or written != BATCH:
            raise AssertionError(f"the entry point exited {proc.returncode}:"
                                 f" {proc.stderr[-3000:]}")

        # -- (c) training through cli.main from a .pth.tar of the weights
        chairs = work / "chairs"
        for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
            (chairs / split).mkdir(parents=True)
            for i in range(n):
                for j in (1, 2):
                    Image.fromarray(rng.integers(
                        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).save(
                            chairs / split / f"{i:05d}_img{j}.ppm")
                write_flo(chairs / split / f"{i:05d}_flow.flo",
                          rng.standard_normal((HEIGHT, WIDTH, 2),
                                              dtype=np.float32) * 4)
        train_argv = ["--model", "FlowNet2", "--batch_size", str(TRAIN_BATCH),
                      "--training_dataset", "FlyingChairs",
                      "--training_dataset_root", str(chairs / "train"),
                      "--training_dataset_is_cropped", "--crop_size",
                      str(TRAIN_HEIGHT), str(TRAIN_WIDTH),
                      "--validation_dataset", "FlyingChairs",
                      "--validation_dataset_root", str(chairs / "val"),
                      "--validation_frequency", "1"]
        steps_per_epoch = CLI_TRAIN // TRAIN_BATCH
        val_per_epoch = -(-CLI_VAL // TRAIN_BATCH)
        steps = 2 * steps_per_epoch

        def train_launches(epochs):
            """The launches of ``epochs`` epochs: their steps on the default
            warp route and their validation forwards."""
            n, n_val = epochs * steps_per_epoch, epochs * val_per_epoch
            want = ({"resample2d_tangents": 2 * n,
                     "resample2d_tangents_multi": n}
                    if stage_glue.TRAIN_WARP == "tangents" else
                    {"resample2d_fwd": 2 * n, "resample2d_fwd_multi": n,
                     "resample2d_grad_flow": 2 * n,
                     "resample2d_grad_flow_multi": n})
            want.update(correlation_fwd=n, correlation_bwd_f1=n,
                        correlation_bwd_f2=n)
            for k, v in fwd.items():
                want[k] = want.get(k, 0) + v * n_val
            return want

        n_epochs = len(walls["train_epoch"])
        got, plain = run_cli("train", *train_argv, "--total_epochs", "2",
                             "--resume_torch", str(pth))
        check_launches(f"phase 5d, training through cli.main, 2 epochs of "
                       f"{steps_per_epoch} steps and {val_per_epoch} "
                       f"validation forward(s) each", got, plain,
                       train_launches(2))
        det_epochs = walls["train_epoch"][n_epochs:]

        # Trainer.fit built by hand from the same pieces and files
        model = get_model("FlowNet2", device=DEVICE, seed=1)
        load_checkpoint(pth, model)
        factory = StepFactory(model, MultiScale(), get_optimizer(
            "Adam", 1e-4, schedule=LRSchedule(1e-4, 0, 10.0), grad_clip=None,
            **optimizer_param_defaults("Adam")))
        trainer = Trainer(factory, TrainerConfig(
            total_epochs=2, validation_frequency=1,
            save_dir=str(work / "hand")))
        kw = dict(crop_size=(TRAIN_HEIGHT, TRAIN_WIDTH),
                  inference_size=(-1, -1), seed=1, replicates=1)
        train_ds = get_dataset("FlyingChairs", root=str(chairs / "train"),
                               is_cropped=True, **kw)
        val_ds = get_dataset("FlyingChairs", root=str(chairs / "val"),
                             is_cropped=False, **kw)
        trainer.fit(
            DeviceLoader(DataLoader(train_ds, TRAIN_BATCH, shuffle=True,
                                    drop_last=True, seed=1), device=DEVICE),
            DeviceLoader(DataLoader(val_ds, TRAIN_BATCH, shuffle=False,
                                    drop_last=False, seed=1), device=DEVICE))
        saved = torch.load(work / "train" / "train-checkpoint" / STATE_FILE,
                           map_location="cpu", weights_only=True)
        hand = {k: v.cpu() for k, v in factory.model.state_dict().items()}
        equal = list(saved["model"]) == list(hand) and all(
            torch.equal(saved["model"][k], v) for k, v in hand.items())

        def records(save):
            with open(work / save / "run.metrics.jsonl") as f:
                return [(r["step"], r["split"], r["loss"], r["epe"])
                        for r in map(json.loads, f)]

        logged = records("train") == records("hand")
        count = saved["optimizer"]["count"]
        del model, factory, trainer, hand, saved
        torch.backends.cudnn.deterministic = False
        note(f"  phase 5d, training through cli.main (cuDNN deterministic): "
             f"final parameters bit-equal to Trainer.fit built by hand "
             f"{equal}, logged losses equal {logged}; {count} steps")
        if not (equal and logged and count == steps):
            raise AssertionError(f"cli training differs from Trainer.fit: "
                                 f"parameters {equal}, records {logged}, "
                                 f"count {count}")

        # --resume of the run for a third epoch, cuDNN's defaults
        n_epochs = len(walls["train_epoch"])
        got, plain = run_cli("train", *train_argv, "--total_epochs", "3",
                             "--resume", str(work / "train"))
        resumed = torch.load(work / "train" / "train-checkpoint" / STATE_FILE,
                             map_location="cpu", weights_only=True)
        steps3 = [r[0] for r in records("train") if r[1] == "train"]
        count3 = resumed["optimizer"]["count"]
        del resumed
        check_launches("phase 5d, the resumed epoch", got, plain,
                       train_launches(1))
        note(f"  phase 5d, --resume of the run for a third epoch: the count "
             f"{count} -> {count3}, train records of steps {steps3}")
        if count3 != steps + steps_per_epoch or steps3[-2:] != [
                steps + 1, steps + steps_per_epoch]:
            raise AssertionError("the resumed run does not continue the "
                                 "count")
        (epoch3,) = walls["train_epoch"][n_epochs:]

        # one fp16 epoch from the same .pth.tar (--fp16_scale's default):
        # its launches exact, every record finite and unscaled, the first
        # step's loss (before any update) within the bf16 contract of the
        # fp32 run's
        got, plain = run_cli("train fp16", *train_argv, "--total_epochs",
                             "1", "--precision", "fp16", "--resume_torch",
                             str(pth))
        check_launches("phase 5d, one fp16 training epoch", got, plain,
                       {k + "_fp16": v
                        for k, v in train_launches(1).items()})
        with open(work / "train fp16" / "run.metrics.jsonl") as f:
            logged16 = [json.loads(line) for line in f]
        train16 = [r for r in logged16 if r["split"] == "train"]
        first32 = next(r for r in records("train") if r[1] == "train")
        finite = all(math.isfinite(r["loss"]) and math.isfinite(r["epe"])
                     for r in logged16)
        val16 = [round(r["loss"], 6) for r in logged16
                 if r["split"] == "val"]
        note(f"  phase 5d, one fp16 epoch through cli.main: train losses "
             f"{[round(r['loss'], 6) for r in train16]} (step 1 in fp32 "
             f"{first32[2]:.6f}), skipped "
             f"{[r['skipped'] for r in train16]}, validation {val16}, all "
             f"finite {finite}  [{smi}]")
        if not (finite and train16 and train16[0]["step"] == 1
                and not all(r["skipped"] for r in train16)):
            raise AssertionError(f"phase 5d, fp16 training: {logged16}")
        bf16_contract(torch.tensor([train16[0]["loss"], train16[0]["epe"]]),
                      torch.tensor([first32[2], first32[3]]),
                      "phase 5d, the fp16 run's first loss and EPE against "
                      "the fp32 run's (unscaled)")

        # -- (e) timing
        note(f"  phase 5d, ms/step through the command line: "
             + ", ".join(f"{s * 1e3 / steps_per_epoch:.3f}"
                         for s in det_epochs)
             + f" (cuDNN deterministic), {epoch3 * 1e3 / steps_per_epoch:.3f} "
             f"(cuDNN's defaults, the resumed epoch), {steps_per_epoch} steps "
             f"an epoch, the loader's waits included; the bare step "
             f"{phase4_ms:.3f} (phase 4), through the Trainer "
             f"{phase5c_ms:.3f} (phase 5c)  [{smi}]")
    finally:
        torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    note(f"  phase 5d took {time.perf_counter() - t_phase:.1f} s")
    return {"work": str(work), "train_argv": train_argv,
            "infer_argv": infer_argv, "pth": str(pth), "steps": steps}


# -- phase 5e: data parallel ------------------------------------------------

def step_launches(route: str) -> dict:
    """The kernel launches of one fp32 train step on the warp route
    ``route``: phase 4's counts."""
    each = {f"correlation_{k}": 1 for k in ("fwd", "bwd_f1", "bwd_f2")}
    if route == "tangents":
        each.update(resample2d_tangents=2, resample2d_tangents_multi=1)
    else:
        each.update(resample2d_fwd=2, resample2d_fwd_multi=1,
                    resample2d_grad_flow=2, resample2d_grad_flow_multi=1)
    return each


def dp_batch():
    """Phase 5e's global batch: TRAIN_BATCH pairs at TRAIN_HEIGHT x
    TRAIN_WIDTH and their targets (as phase 4 draws them: pixels in [0,
    255), flows in [0, 5)), from a numpy generator seeded with DP_SEED, so
    that every rank draws the same."""
    import numpy as np

    rng = np.random.default_rng(DP_SEED)
    images = rng.random((TRAIN_BATCH, 2, TRAIN_HEIGHT, TRAIN_WIDTH, 3),
                        dtype=np.float32) * 255.0
    target = rng.random((TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 2),
                        dtype=np.float32) * 5.0
    return torch.from_numpy(images), torch.from_numpy(target)


def state_digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes."""
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def rank_device(backend: str) -> torch.device:
    """A rank's card: over NCCL its own (LOCAL_RANK); over gloo, where
    phase 5e(a) runs two ranks on one card, the first one."""
    from flownet2_tpu_torch import parallel

    return torch.device("cuda", 0 if backend == "gloo"
                        else parallel.local_rank())


def start_rank(cfg: dict) -> torch.device:
    """A rank's set-up: its card current, the group started from
    torchrun's variables, TF32 off, cuDNN deterministic."""
    from flownet2_tpu_torch import parallel

    dev = rank_device(cfg["backend"])
    torch.cuda.set_device(dev)
    parallel.init_distributed(backend=cfg["backend"], timeout=GROUP_TIMEOUT)
    torch.backends.cudnn.deterministic = True
    return dev


def dp_steps_rank(cfg: dict) -> None:
    """One rank of phase 5e's steps: FlowNet2 fp32 of the seeded weights,
    this rank's stripe of the global batch, DP_STEPS steps of Adam 1e-4
    through ``StepFactory(plan=...)``.  Rank 0 first takes the one-process
    step's gradients and loss on the whole batch.  Step 1 runs one forward,
    the rank's own gradients by ``autograd.grad`` (DDP's hooks do not run)
    and then the backward through DDP: the all-reduced gradients against
    the mean of the ranks' own (1e-6 in relative L2), and against the
    one-process step per sub-net (1e-3 in relative L2, flownetc and
    flownets_1 printed only), the global loss against its loss (1e-5
    relative).  After every step the ranks' parameter digests are
    all-gathered and must be one; steps 2 to DP_STEPS launch exactly phase
    4's kernels a step on every rank."""
    import torch.distributed as dist

    from flownet2_tpu_torch import ops, parallel
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import stage_glue
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    dev = start_rank(cfg)
    plan = parallel.DataParallelPlan.current(dev)
    rank, world = plan.rank, plan.world_size
    images, target = dp_batch()
    local = plan.local_batch_size(TRAIN_BATCH)
    img = images[rank * local:(rank + 1) * local].to(dev)
    tgt = target[rank * local:(rank + 1) * local].to(dev)
    loss_fn = MultiScale()
    model = get_model("FlowNet2", device=dev, seed=0)
    if rank == 0:
        model.train()
        whole = loss_fn(model(images.to(dev)), target.to(dev))[0]
        whole.backward()
        single = {n: p.grad.detach().cpu()
                  for n, p in model.named_parameters()}
        single_loss = whole.item()
        model.zero_grad(set_to_none=True)
        del whole
        torch.cuda.empty_cache()
    factory = StepFactory(model, loss_fn, get_optimizer("Adam", 1e-4),
                          plan=plan)
    names, params = zip(*model.named_parameters())
    digests = []

    def same_on_every_rank(step: int) -> None:
        got = [None] * world
        dist.all_gather_object(got, state_digest(model))
        if len(set(got)) != 1:
            raise AssertionError(f"{cfg['what']}: after step {step} the "
                                 f"ranks' parameters differ: {got}")
        digests.append(got[0][:12])

    # step 1: one forward; the rank's own gradients, then DDP's
    net = factory.net
    net.train()
    factory.optimizer.zero_grad()
    lossvalue, epevalue = loss_fn(net(img), tgt)
    own = torch.autograd.grad(lossvalue, params, retain_graph=True)
    lossvalue.backward()
    mean_own = parallel.all_reduce_sum(
        torch.cat([g.reshape(-1) for g in own])).double().div_(world)
    reduced = torch.cat([p.grad.reshape(-1) for p in params]).double()
    hook_rel = ((reduced - mean_own).norm() / mean_own.norm()).item()
    del own, mean_own, reduced
    grads = {n: p.grad.detach().cpu() for n, p in zip(names, params)}
    factory.optimizer.step()
    loss1 = float(parallel.all_reduce_sum(lossvalue.detach().clone())) / world
    del lossvalue, epevalue
    same_on_every_rank(1)

    # steps 2..DP_STEPS as the Trainer takes them, their launches counted
    step = factory.train_step()
    want = step_launches(stage_glue.TRAIN_WARP)
    for k in range(2, DP_STEPS + 1):
        ops.reset_counts()
        metrics = step(img, tgt)
        torch.cuda.synchronize()
        got, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        if got != want or plain or not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{cfg['what']}, rank {rank}, step {k}: "
                                 f"launches {got}, plain-op calls {plain}, "
                                 f"loss {float(metrics['loss'])}; expected "
                                 f"{want}")
        same_on_every_rank(k)
    if hook_rel > 1e-6:
        raise AssertionError(f"{cfg['what']}, rank {rank}: the all-reduced "
                             f"gradients are {hook_rel:.3e} from the mean of "
                             "the ranks' own in relative L2 (gate 1e-6)")
    if rank == 0:
        rel = abs(loss1 - single_loss) / abs(single_loss)
        note(f"  phase 5e{cfg['part']}, {cfg['what']}: parameters bit-equal "
             f"on every rank after each of {DP_STEPS} steps "
             f"({', '.join(digests)}); step 1's all-reduced gradients "
             f"{hook_rel:.3e} from the mean of the ranks' own in relative "
             f"L2; loss {loss1:.6f} against the one-process batch-"
             f"{TRAIN_BATCH} step's {single_loss:.6f} ({rel:.2e} relative); "
             f"launches a step {want} on every rank")
        if not rel <= 1e-5:
            raise AssertionError(f"{cfg['what']}: the global loss is {rel:.2e}"
                                 " from the one-process step's (gate 1e-5)")
        subnets_close(grads, single, DP_GATES,
                      f"phase 5e{cfg['part']}, {cfg['what']}, step 1's "
                      f"gradients against the one-process batch-{TRAIN_BATCH}"
                      " step")
    dist.destroy_process_group()


def one_rank_task(cfg: dict) -> None:
    """Phase 5e(b) and (c) in one process on the card.  (b) One rank over
    NCCL, fp32 and bf16: DP_STEPS steps through ``StepFactory(plan=...)``
    leave the parameters bit-equal to the same steps without a plan.  (c)
    ``cli.main`` under torchrun's variables (a world of one): training from
    phase 5d's files and ``--inference --save_flow`` give phase 5d's
    parameters, records and flows bit for bit."""
    import torch.distributed as dist

    from flownet2_tpu_torch import cli, parallel
    from flownet2_tpu_torch.checkpoints.native import STATE_FILE
    from flownet2_tpu_torch.data import read_flo
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    dev = start_rank(cfg)
    images, target = dp_batch()
    img, tgt = images.to(dev), target.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        states = []
        for plan in (None, parallel.DataParallelPlan.current(dev)):
            model = get_model("FlowNet2", device=dev, seed=0, dtype=dtype)
            step = StepFactory(model, MultiScale(),
                               get_optimizer("Adam", 1e-4),
                               plan=plan).train_step()
            for _ in range(DP_STEPS):
                step(img, tgt)
            states.append([t.detach().cpu()
                           for t in model.state_dict().values()])
            del model, step
            gc.collect()
            torch.cuda.empty_cache()
        equal = len(states[0]) == len(states[1]) and all(
            torch.equal(a, b) for a, b in zip(*states))
        note(f"  phase 5e(b), one rank over NCCL, {str(dtype)[6:]}: "
             f"{DP_STEPS} steps through DistributedDataParallel bit-equal to "
             f"the same steps without it {equal}")
        if not equal:
            raise AssertionError(f"phase 5e(b), {dtype}: one NCCL rank's "
                                 "steps differ from the steps without DDP")
        del states
    dist.destroy_process_group()

    # (c) the command line as the one rank of torchrun's environment
    d = cfg["cli"]
    work, out = Path(d["work"]), Path(cfg["out"])
    runs = (("train", [*d["train_argv"], "--total_epochs", "2",
                       "--resume_torch", d["pth"]]),
            ("infer", d["infer_argv"]))
    for what, argv in runs:
        rc = cli.main([*argv, "--device", DEVICE, "--save", str(out / what)])
        if rc != 0 or parallel.is_distributed():
            raise AssertionError(f"phase 5e(c): cli.main {what} returned {rc}"
                                 " or left its group running")

    def records(save):
        with open(save / "run.metrics.jsonl") as f:
            return [(r["step"], r["split"], r["loss"], r["epe"])
                    for r in map(json.loads, f)]

    got, want = (torch.load(p / "train-checkpoint" / STATE_FILE,
                            map_location="cpu", weights_only=True)["model"]
                 for p in (out / "train", work / "hand"))
    params = list(got) == list(want) and all(
        torch.equal(got[k], v) for k, v in want.items())
    logged = records(out / "train") == records(work / "hand")
    flows = [[read_flo(p / "inference" / "flows" / f) for f in sorted(
        os.listdir(p / "inference" / "flows"))]
        for p in (out / "infer", work / "infer fp32")]
    same_flows = len(flows[0]) == len(flows[1]) == CLI_FRAMES - 1 and all(
        (a == b).all() for a, b in zip(*flows))
    note(f"  phase 5e(c), the command line as torchrun's one NCCL rank: "
         f"training from phase 5d's files, final parameters bit-equal "
         f"{params}, logged losses equal {logged}; --inference --save_flow, "
         f"{len(flows[0])} flows bit-equal to phase 5d's {same_flows}")
    if not (params and logged and same_flows):
        raise AssertionError("phase 5e(c): the command line under torchrun's "
                             "environment differs from phase 5d")


def scaling_rank(cfg: dict) -> None:
    """One rank of phase 5e(d)'s weak scaling: FlowNet2 train steps at
    TRAIN_BATCH pairs on this card (the whole of phase 5e's batch), fp32
    then bf16, cuDNN's defaults; rank 0 writes the slowest rank's ms/step
    of SCALE_STEPS steps after SCALE_WARMUP.  On more than one card the
    all-reduce of a step's gradients alone is timed first."""
    import torch.distributed as dist

    from flownet2_tpu_torch import parallel
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    dev = start_rank(cfg)
    torch.backends.cudnn.deterministic = False
    plan = parallel.DataParallelPlan.current(dev)
    out = {}
    if plan.world_size > 1:
        # the all-reduce of a step's gradients alone: FLOWNET2_PARAMS float32
        grads = torch.ones(FLOWNET2_PARAMS, device=dev)
        for _ in range(2):
            dist.all_reduce(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(grads)
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        del grads
    images, target = dp_batch()
    img, tgt = images.to(dev), target.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        model = get_model("FlowNet2", device=dev, seed=0, dtype=dtype)
        step = StepFactory(model, MultiScale(), get_optimizer("Adam", 1e-4),
                           plan=plan).train_step()
        for _ in range(SCALE_WARMUP):
            step(img, tgt)
        torch.cuda.synchronize()
        parallel.barrier()
        t0 = time.perf_counter()
        for _ in range(SCALE_STEPS):
            metrics = step(img, tgt)
        torch.cuda.synchronize()
        ms = torch.tensor([(time.perf_counter() - t0) * 1e3 / SCALE_STEPS],
                          device=dev)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"weak scaling, {dtype}: non-finite loss")
        out[str(dtype)[6:]] = float(ms)
        del model, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    if plan.rank == 0:
        Path(cfg["out"]).write_text(json.dumps(out))
    dist.destroy_process_group()


# -- phase 5f: row bands across ranks -----------------------------------------

def band_launches(forward_only: bool = False, bf16: bool = False) -> dict:
    """A rank's launches of one FlowNet2 forward (``forward_only``) or
    train step on its band, default warp route, whatever the band's
    height: K7 for the correlation and the local-rows K2 and K4 (their
    ``_bf16`` forms for the bf16 model)."""
    each = {"correlation_fwd_rows": 1, "resample2d_fwd": 2,
            "resample2d_fwd_multi": 1}
    if not forward_only:
        each.update(correlation_bwd_f1_rows=1, correlation_bwd_f2_rows=1,
                    resample2d_grad_flow=2, resample2d_grad_flow_multi=1)
    return {name + ("_bf16" if bf16 else ""): n for name, n in each.items()}


def band_pairs():
    """Phase 5f's inference batch: BATCH pairs at HEIGHT x WIDTH (pixels in
    [0, 255)), from a numpy generator seeded with BAND_SEED, so that every
    rank draws the same."""
    import numpy as np

    rng = np.random.default_rng(BAND_SEED)
    return torch.from_numpy(rng.random((BATCH, 2, HEIGHT, WIDTH, 3),
                                       dtype=np.float32) * 255.0)


# the device time of a step's kernels by family, on the band path
BAND_FAMILIES = (
    ("NCCL all-gather (halos, f2 and image gathers)",
     re.compile(r"nccl.*allgather", re.I)),
    ("NCCL all-reduce (DDP's gradients, the gathers' transposes, the mean)",
     re.compile(r"nccl.*allreduce", re.I)),
    ("other NCCL", re.compile(r"nccl", re.I)),
    ("K7 (correlation rows)", re.compile(r"correlation_")),
    ("local-rows K2, K4", re.compile(r"resample2d")),
    ("convolution", CONV),
    ("other PyTorch kernels", re.compile(r".")),
)


def wide_pairs():
    """Phase 5f's wide inference batch: WIDE_BATCH pairs at WIDE_HEIGHT x
    WIDE_WIDTH (pixels in [0, 255)), from a numpy generator seeded with
    BAND_SEED + 1, so that every rank draws the same."""
    import numpy as np

    rng = np.random.default_rng(BAND_SEED + 1)
    return torch.from_numpy(rng.random(
        (WIDE_BATCH, 2, WIDE_HEIGHT, WIDE_WIDTH, 3), dtype=np.float32)
        * 255.0)


def wide_inference(plan, dev, factory, tag: str) -> dict:
    """Phase 5f's bands of unequal height: FlowNet2 inference of
    ``wide_pairs()`` (WIDE_HEIGHT rows over the plan's bands: 256 and 192
    at spatial 2) through ``StepFactory(plan=...).infer_step()``, in fp32
    (``factory``'s model) and in bf16 (the same weights), against rank 0's
    one process: fp32 within EPE 1e-4, bf16 within the JAX package's bf16
    contract of the one-process bf16 model; the gathered flows bit-equal
    on every rank; each rank's launches exactly ``band_launches(True)``
    and no plain-op call.  Returns this rank's rows and launches."""
    import torch.distributed as dist

    from flownet2_tpu_torch import ops, parallel
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops.sharding_hints import band_edges
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    pairs = wide_pairs()
    n = WIDE_BATCH // plan.data_size
    stripe = pairs[plan.data_rank * n:(plan.data_rank + 1) * n].to(dev)
    rows = plan.band_rows(WIDE_HEIGHT)
    out = {"rows": [rows.start, rows.stop], "launches": {}}
    for dtype in (None, torch.bfloat16):
        bf16 = dtype is not None
        name = "bf16" if bf16 else "fp32"
        if bf16:
            net = get_model("FlowNet2", device=dev, dtype=dtype)
            net.load_state_dict(factory.model.state_dict())
        else:
            net = factory.model
        want = None
        if plan.rank == 0:
            net.eval()
            with torch.inference_mode():
                want = net(pairs.to(dev)).float().cpu()
            torch.cuda.empty_cache()
        if bf16:
            factory = StepFactory(net, MultiScale(),
                                  get_optimizer("Adam", 1e-4), plan=plan)
        ops.reset_counts()
        t0 = time.perf_counter()
        flow = factory.infer_step()(stripe)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        if launches != (band_launches(True, bf16), {}):
            raise AssertionError(
                f"{tag}, rank {plan.rank}, {name} {WIDE_HEIGHT}x{WIDE_WIDTH}"
                f": launches {launches}; expected {band_launches(True, bf16)}")
        out["launches"][name] = launches[0]
        gathered = parallel.all_gather_batch(flow.float(), plan).cpu()
        digests = [None] * plan.world_size
        dist.all_gather_object(digests, hashlib.sha256(
            gathered.numpy().tobytes()).hexdigest())
        if len(set(digests)) != 1:
            raise AssertionError(f"{tag}: the gathered {name} flows differ "
                                 "between ranks")
        if plan.rank == 0:
            what = (f"{tag}: {name} inference b{WIDE_BATCH} {WIDE_HEIGHT}x"
                    f"{WIDE_WIDTH} as the bands of rows "
                    f"{band_edges(WIDE_HEIGHT, plan.spatial)}, gathered, "
                    "against one process")
            if bf16:
                bf16_contract(gathered, want, what)
            else:
                epe = float(torch.sqrt(((gathered - want) ** 2).sum(-1))
                            .mean())
                note(f"  {what}: EPE {epe:.3e} (largest |flow| "
                     f"{float(want.abs().max()):.2f})")
                if not epe < 1e-4:
                    raise AssertionError(f"{what}: EPE {epe:.3e} (gate "
                                         "1e-4)")
            note(f"  {tag}: {name} band inference {seconds:.3f} s (first "
                 f"call); launches a rank {launches[0]}")
        del net, flow, gathered, want
        torch.cuda.empty_cache()
    return out


def bands_rank(cfg: dict) -> None:
    """One rank of phase 5f: FlowNet2 of the seeded weights, fp32 or with
    ``cfg["dtype"]`` "bfloat16" the bf16 model, as ``cfg["spatial"]`` row
    bands across ranks (``DataParallelPlan(spatial=...)``; bands of unequal
    height where the granules of 64 rows do not divide evenly), TF32 off,
    cuDNN deterministic.  Rank 0 first takes, in one process, the inference
    of phase 5f's pairs (b BATCH, HEIGHT x WIDTH) and the step gradients of
    phase 5e's batch (b TRAIN_BATCH, TRAIN_HEIGHT x TRAIN_WIDTH).  Then
    every rank runs the inference of its band of its stripe (its launches
    exactly ``band_launches(True)``, no plain-op call); the bands and
    stripes gathered are within EPE 1e-4 of one process's (bf16: the JAX
    package's bf16 contract).  One step of Adam 1e-4 through
    ``StepFactory(plan=...)`` (its launches exactly ``band_launches()``):
    the ranks' parameters bit-equal after it (all-gathered digests), the
    global loss within 1e-5 relative (bf16: 5e-3) and the gradients per
    sub-net within DP_GATES (bf16: BF16_BAND_GATES) of the one-process
    step's in relative L2; the dispatch log names the process-group
    compositions.  With ``cfg["wide"]``, ``wide_inference``.  With
    ``cfg["timed"]`` (NCCL on several cards, or one card without bands,
    ``cfg["check"]`` False) SCALE_STEPS steps are timed after SCALE_WARMUP
    with cuDNN's defaults (the slowest rank's ms/step) and PROFILED_STEPS
    more profiled on rank 0 by kernel family.  Rank 0 writes its readings
    to ``cfg["out"]``."""
    import torch.distributed as dist

    from flownet2_tpu_torch import ops, parallel
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import sharding_hints
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    dev = start_rank(cfg)
    plan = parallel.DataParallelPlan.current(dev, spatial=cfg["spatial"],
                                             timeout=GROUP_TIMEOUT)
    rank, world, check = plan.rank, plan.world_size, cfg.get("check", True)
    bf16 = cfg.get("dtype") == "bfloat16"
    tag = f"phase {cfg['part']}, {cfg['what']}"
    images, target = dp_batch()
    pairs = band_pairs()

    def stripe(t):
        n = t.shape[0] // plan.data_size
        return t[plan.data_rank * n:(plan.data_rank + 1) * n].to(dev)

    img, tgt, pair = stripe(images), stripe(target), stripe(pairs)
    loss_fn = MultiScale()
    model = get_model("FlowNet2", device=dev, seed=0,
                      dtype=torch.bfloat16 if bf16 else None)
    out = {}
    if cfg.get("wide") and cfg["backend"] == "gloo":
        # whether this build's gloo adds bf16 CUDA tensors, as the bf16
        # band path needs
        probe = torch.ones(4, dtype=torch.bfloat16, device=dev)
        try:
            dist.all_reduce(probe, group=plan.spatial_group)
            out["gloo_bf16_all_reduce"] = f"taken, {probe.tolist()}"
        except (RuntimeError, ValueError) as e:
            out["gloo_bf16_all_reduce"] = f"refused: {str(e)[:120]}"
        if rank == 0:
            note(f"  {tag}: gloo's all-reduce of bf16 CUDA tensors "
                 f"(torch {torch.__version__}): "
                 f"{out['gloo_bf16_all_reduce']}")
    if rank == 0 and check:
        model.eval()
        with torch.inference_mode():
            want_flow = model(pairs.to(dev)).float().cpu()
        model.train()
        whole = loss_fn(model(images.to(dev)), target.to(dev))[0]
        whole.backward()
        single = {n: p.grad.detach().cpu()
                  for n, p in model.named_parameters()}
        single_loss = whole.item()
        model.zero_grad(set_to_none=True)
        del whole
        torch.cuda.empty_cache()
    factory = StepFactory(model, loss_fn, get_optimizer("Adam", 1e-4),
                          plan=plan)
    if check:
        sharding_hints.clear_dispatch_log()
        ops.reset_counts()
        flow = factory.infer_step()(pair)
        torch.cuda.synchronize()
        infer = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        flow = parallel.all_gather_batch(flow.float(), plan).cpu()
        if infer != (band_launches(True, bf16), {}):
            raise AssertionError(f"{tag}, rank {rank}: inference launches "
                                 f"{infer}; expected "
                                 f"{band_launches(True, bf16)}")
        ops.reset_counts()
        metrics = factory.train_step()(img, tgt)
        torch.cuda.synchronize()
        stepped = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        if stepped != (band_launches(bf16=bf16), {}):
            raise AssertionError(f"{tag}, rank {rank}: step launches "
                                 f"{stepped}; expected "
                                 f"{band_launches(bf16=bf16)}")
        loss1 = float(metrics["loss"])
        grads = {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()}
        got = [None] * world
        dist.all_gather_object(got, state_digest(model))
        if len(set(got)) != 1:
            raise AssertionError(f"{tag}: after the step the ranks' "
                                 f"parameters differ: {got}")
        log = sharding_hints.dispatch_log()
        want_log = {
            "correlation": f"process group(spatial={plan.spatial})+halo-slab,"
                           " kernel=cuda-rows",
            "resample2d": f"process group(spatial={plan.spatial})"
                          "+halo-gather, kernel=cuda-rows",
            "convolution": f"process group(spatial={plan.spatial})+halo rows",
            "transposed convolution":
                f"process group(spatial={plan.spatial})+halo rows",
            "upsample_bilinear":
                f"process group(spatial={plan.spatial})+halo rows"}
        if any(log.get(k) != v for k, v in want_log.items()):
            raise AssertionError(f"{tag}, rank {rank}: dispatch log {log}")
        out.update(infer_launches=infer[0], step_launches=stepped[0])
        if rank == 0:
            epe = float(torch.sqrt(((flow - want_flow) ** 2).sum(-1)).mean())
            rel = abs(loss1 - single_loss) / abs(single_loss)
            bands = [plan.band_rows(h) for h in (HEIGHT, TRAIN_HEIGHT)]
            note(f"  {tag}: inference b{BATCH} {HEIGHT}x{WIDTH}, the bands "
                 f"and stripes gathered, EPE {epe:.3e} against one process "
                 f"(largest |flow| {float(want_flow.abs().max()):.2f}); step "
                 f"b{TRAIN_BATCH} {TRAIN_HEIGHT}x{TRAIN_WIDTH}: parameters "
                 f"bit-equal on every rank ({got[0][:12]}), loss {loss1:.6f} "
                 f"against one process's {single_loss:.6f} ({rel:.2e} "
                 f"relative); rank 0's rows {bands[0]} and {bands[1]}; "
                 f"launches a rank: forward {infer[0]}, step {stepped[0]}; "
                 f"dispatch {log}")
            subnets_close(grads, single,
                          BF16_BAND_GATES if bf16 else DP_GATES,
                          f"{tag}, the step's gradients against one process")
            if bf16:
                bf16_contract(flow, want_flow, f"{tag}, the gathered bf16 "
                              "inference against one process")
            if not ((bf16 or epe < 1e-4)
                    and rel <= (5e-3 if bf16 else 1e-5)):
                raise AssertionError(f"{tag}: EPE {epe:.3e} (gate 1e-4) or "
                                     f"loss {rel:.2e} (gate "
                                     f"{5e-3 if bf16 else 1e-5:g}) from one "
                                     "process")
        del grads
    if cfg.get("wide"):
        out["wide"] = wide_inference(plan, dev, factory, tag)
    if cfg.get("timed"):
        torch.backends.cudnn.deterministic = False
        step = factory.train_step()
        for _ in range(SCALE_WARMUP):
            step(img, tgt)
        torch.cuda.synchronize()
        parallel.barrier()
        t0 = time.perf_counter()
        for _ in range(SCALE_STEPS):
            metrics = step(img, tgt)
        torch.cuda.synchronize()
        ms = torch.tensor([(time.perf_counter() - t0) * 1e3 / SCALE_STEPS],
                          device=dev)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{tag}: non-finite loss")
        out["ms"] = float(ms)
        lines = []

        def keep(line):
            lines.append(line)

        def run():
            for _ in range(PROFILED_STEPS):
                step(img, tgt)
        if rank == 0:
            per_kernel, _ = profile_families(run, PROFILED_STEPS,
                                             BAND_FAMILIES, cfg["smi"],
                                             "step", say=keep)
            totals = {}
            for key, us in per_kernel.items():
                fam = next(n for n, rx in BAND_FAMILIES if rx.search(key))
                totals[fam] = totals.get(fam, 0.0) + us / 1e3 / PROFILED_STEPS
            out["families_ms"] = totals
            # where the host's time goes: the ops by their own host time
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                run()
                host_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
            torch.cuda.synchronize()
            keep(f"host, profiled: {host_ms:.3f} ms/step; the ops by their "
                 "own host time a step:")
            for ev in sorted(prof.key_averages(),
                             key=lambda e: -e.self_cpu_time_total)[:15]:
                keep(f"  {ev.self_cpu_time_total / 1e3 / PROFILED_STEPS:9.3f}"
                     f" ms  {ev.count // PROFILED_STEPS:6d} calls  "
                     f"{ev.key[:70]}")
            out["profile"] = lines
        else:
            run()
            run()
        torch.cuda.synchronize()
    if rank == 0:
        Path(cfg["out"]).write_text(json.dumps(out))
    dist.destroy_process_group()


def bands_phase(smi: str) -> dict:
    """Phase 5f, on the one card: two ranks over gloo with CUDA tensors
    (NCCL refuses two ranks on one device) as two row bands,
    ``bands_rank``'s gates.  Returns rank 0's launches."""
    t_phase = time.perf_counter()
    print(f"phase 5f: row bands across ranks, FlowNet2 fp32, spatial 2, "
          "two gloo ranks on one card, TF32 off, cuDNN deterministic; "
          f"then fp32 and bf16 inference of {WIDE_HEIGHT}x{WIDE_WIDTH} "
          "pairs as bands of unequal height")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_5f_"))
    try:
        out = work / "f.out"
        run_task(work, "f", 2, task="bands", backend="gloo", spatial=2,
                 part="5f", what="2 ranks over gloo on one card",
                 out=str(out), smi=smi, wide=True)
        got = json.loads(out.read_text())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    note(f"  phase 5f took {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return got


def multi_card_bands(smi: str, n_cards: int, work: Path) -> None:
    """Phase 5f(d), on several cards over NCCL: ``bands_rank``'s gates and
    timings, in fp32 at spatial 2 on 2 cards, at data 2 x spatial 2 on 4
    and at spatial 4 on 4 (bands of 128, 128, 64 and 64 rows), and in bf16
    at spatial 2 on 2 cards and 2 x 2 on 4, each beside the one-card step
    of the same batch and dtype (no bands) in the same call."""
    from flownet2_tpu_torch.ops.sharding_hints import band_edges

    rows = ", ".join(str(b - a) for a, b in band_edges(TRAIN_HEIGHT, 4))
    runs = []
    for dtype in ("float32", "bfloat16"):
        runs += [(dtype, "one card, no bands", 1, 1, False)]
        runs += [(dtype, "spatial 2 on 2 cards", 2, 2, True)] \
            if n_cards >= 2 else []
        runs += [(dtype, "data 2 x spatial 2 on 4 cards", 4, 2, True)] \
            if n_cards >= 4 else []
        runs += [(dtype, f"spatial 4 on 4 cards (bands of {rows} rows)", 4,
                  4, True)] if n_cards >= 4 and dtype == "float32" else []
    got = {}
    for k, (dtype, what, world, spatial, check) in enumerate(runs):
        out = work / f"bands{k}.out"
        run_task(work, f"bands{k}", world, task="bands", backend="nccl",
                 spatial=spatial, part="5f(d)", what=f"{dtype}, {what}",
                 check=check, timed=True, out=str(out), smi=smi, dtype=dtype)
        got[dtype, what] = json.loads(out.read_text())
    for (dtype, what), r in got.items():
        base = got[dtype, "one card, no bands"]["ms"]
        note(f"  phase 5f(d), FlowNet2 {dtype} train step b{TRAIN_BATCH} "
             f"{TRAIN_HEIGHT}x{TRAIN_WIDTH} (the global batch), {what}: "
             f"{r['ms']:.3f} ms/step, {TRAIN_BATCH / r['ms'] * 1e3:.2f} "
             f"frames/s, {base / r['ms']:.3f}x the one-card step; device "
             "time a step on rank 0: " + "; ".join(
                 f"{k} {v:.3f} ms" for k, v in sorted(
                     r["families_ms"].items(), key=lambda kv: -kv[1]))
             + f"  [{smi}]")
        for line in r["profile"]:
            print(f"    {line}")


RANK_TASKS = {"steps": dp_steps_rank, "one_rank": one_rank_task,
              "scaling": scaling_rank, "bands": bands_rank}
# the script and arguments torchrun runs as each rank of run_task (the
# task's configuration file follows)
RANK_COMMAND = [str(ROOT / "chip_smoke.py"), "--rank-task"]


def rank_task(config: str) -> int:
    """``python3 chip_smoke.py --rank-task <config.json>``: one rank of a
    phase 5e or 5f task, started by the phase with torchrun's variables."""
    cfg = json.loads(Path(config).read_text())
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    RANK_TASKS[cfg["task"]](cfg)
    if os.environ["RANK"] == "0":
        Path(cfg["summary"]).write_text("\n".join(SUMMARY))
    return 0


def run_task(work: Path, name: str, world: int, env=None, **cfg) -> None:
    """Run the task ``cfg["task"]`` as ``world`` ranks (fresh processes
    started by torchrun) and keep rank 0's readings for the summary;
    raises if any rank fails."""
    path = work / f"{name}.json"
    summary = work / f"{name}.summary"
    path.write_text(json.dumps(dict(cfg, summary=str(summary))))
    summary.unlink(missing_ok=True)
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT)
    # torchrun sets one OpenMP thread where it starts several ranks: the
    # same for every world size, so that the scaling table compares alike
    env.setdefault("OMP_NUM_THREADS", "1")
    t = time.perf_counter()
    rc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={world}", *RANK_COMMAND, str(path)],
        env=env).returncode
    if rc != 0:
        raise AssertionError(f"rank task {name}: a rank exited {rc}")
    # the ranks printed these readings; the summary at the end repeats them
    if summary.exists():
        SUMMARY.extend(summary.read_text().splitlines())
    print(f"  rank task {name}: {world} rank(s) in "
          f"{time.perf_counter() - t:.1f} s")


def data_parallel_phase(smi: str, cli_run: dict) -> None:
    """Phase 5e, on the one card: (a) two ranks over gloo with CUDA tensors
    (NCCL refuses two ranks on one device), phase 5e's batch split in two,
    ``dp_steps_rank``'s gates; (b) and (c), ``one_rank_task``."""
    t_phase = time.perf_counter()
    print(f"phase 5e: data parallel, FlowNet2 b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
          f"{TRAIN_WIDTH} fp32 (bf16 in (b)), TF32 off, cuDNN deterministic,"
          " fresh processes")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_5e_"))
    try:
        run_task(work, "a", 2, task="steps", backend="gloo", part="(a)",
                 what="2 ranks over gloo on one card")
        run_task(work, "bc", 1, task="one_rank", backend="nccl",
                 cli=cli_run, out=str(work / "cli"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    note(f"  phase 5e took {time.perf_counter() - t_phase:.1f} s  [{smi}]")


def kernels_on_device(dev: torch.device) -> dict:
    """Each kernel of the main path on card ``dev`` (not the current one:
    each wrapper picks its tensors' card) against its plain version at
    phase 2's main-path shapes and tolerances, f32 and bf16: K1 at the
    inference map, K5, K6 and K7 (both bands of two) at the training map,
    K2 one and two flows at the inference image, K3 and K4 one and two
    flows at the training image, and the local-rows K2, K3, K4 on the
    bands of two bit-equal to the whole image's rows.  Returns the
    launches."""
    from flownet2_tpu_torch import ops
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import correlation_spatial as corr_sp
    from flownet2_tpu_torch.ops import resample2d as r2d

    gen = torch.Generator(device=dev).manual_seed(dev.index or 0)
    ops.reset_counts()

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flow(*shape, dtype):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * 8.0).to(dtype)

    def close(got, want, tol, what):
        if got.device != dev:
            raise AssertionError(f"{what}: output on {got.device}")
        if got.dtype == torch.bfloat16:
            ulp_err(got, want, what)
        else:
            max_err(got, want, tol, tol, what)

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{dev} {str(dtype)[6:]}"
            f1, f2 = (randn(BATCH, 256, HEIGHT // 8, WIDTH // 8, dtype=dtype)
                      for _ in range(2))
            close(corr.correlation_cuda(f1, f2, 20, 1, 20, 1, 2),
                  corr.correlation_plain(f1, f2, 20, 1, 20, 1, 2), 1e-4,
                  f"K1 {tag}")
            shape = (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8)
            f1, f2 = (randn(*shape, dtype=dtype) for _ in range(2))
            g = randn(shape[0], 21 * 21, *shape[2:], dtype=dtype)
            for k, (a, b) in enumerate(zip(
                    corr.correlation_bwd_cuda(g, f1, f2, 20, 2),
                    corr.correlation_bwd_plain(g, f1, f2, 20, 2))):
                close(a, b, 1e-4, f"K{5 + k} {tag}")
            f2p = F.pad(f2, (0, 0, 20, 20))
            rows_h = shape[2] // 2
            for off in (0, rows_h):
                rows = slice(off, off + rows_h)
                args = (g[:, :, rows].contiguous(), f1[:, :, rows].contiguous(),
                        f2p[:, :, off:off + rows_h + 40].contiguous())
                got = (corr_sp.corr_slab_cuda(*args[1:], 20, 2),
                       *corr_sp.corr_slab_bwd_cuda(*args, 20, 2))
                want = (corr_sp.corr_slab_plain(*args[1:], 20, 2),
                        *corr_sp.corr_slab_bwd_plain(*args, 20, 2))
                for part, a, b in zip(("forward", "d_f1", "d_slab"), got,
                                      want):
                    close(a, b, 1e-5, f"K7 {part}, rows from {off}, {tag}")
            img = randn(BATCH, 3, HEIGHT, WIDTH, dtype=dtype)
            fl = flow(BATCH, 2, 2, HEIGHT, WIDTH, dtype=dtype)
            close(r2d.resample2d_cuda(img, fl[:, 0].contiguous()),
                  r2d.resample2d_plain(img, fl[:, 0].contiguous()), 1e-5,
                  f"K2 one flow {tag}")
            close(r2d.resample2d_multi_cuda(img, fl),
                  r2d.resample2d_multi_plain(img, fl), 1e-5,
                  f"K2 two flows {tag}")
            img = randn(TRAIN_BATCH, 3, TRAIN_HEIGHT, TRAIN_WIDTH, dtype=dtype)
            fls = flow(TRAIN_BATCH, 2, 2, TRAIN_HEIGHT, TRAIN_WIDTH,
                       dtype=dtype)
            for n_flows in (1, 2):
                fl = fls[:, :n_flows].contiguous()
                want = r2d.resample2d_tangents_plain(img, fl)
                for part, a, b in zip(("out", "d1", "d2"),
                                      r2d.resample2d_tangents_cuda(img, fl),
                                      want):
                    close(a, b, 1e-5, f"K3 {part}, {n_flows} flow(s) {tag}")
                g = randn(*want[0].shape, dtype=dtype)
                close(r2d.resample2d_grad_flow_cuda(g, img, fl),
                      r2d.resample2d_grad_flow_plain(g, img, fl), 1e-5,
                      f"K4 {n_flows} flow(s) {tag}")
            whole = (r2d.resample2d_multi_cuda(img, fls),
                     *r2d.resample2d_tangents_cuda(img, fls),
                     r2d.resample2d_grad_flow_cuda(g, img, fls))
            rows_h = TRAIN_HEIGHT // 2
            for off in (0, rows_h):
                rows = slice(off, off + rows_h)
                fl_loc = fls[:, :, :, rows].contiguous()
                got = (r2d.resample2d_multi_cuda(img, fl_loc, off),
                       *r2d.resample2d_tangents_cuda(img, fl_loc, off),
                       r2d.resample2d_grad_flow_cuda(
                           g[:, :, :, rows].contiguous(), img, fl_loc, off))
                for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2",
                                       "K4"), got, whole):
                    if not torch.equal(a, b[:, :, :, rows]):
                        raise AssertionError(
                            f"{part} local rows from {off}, {tag}: not the "
                            "whole image's rows")
            print(f"  local-rows K2, K3, K4 on the bands of two, {tag}: "
                  "bit-equal to the whole image's rows")
    torch.cuda.synchronize(dev)
    return dict(ops.LAUNCHES)


def nonfinite_gate(f1: torch.Tensor, f2: torch.Tensor,
                   g: torch.Tensor) -> None:
    """K5 and K6 fp16 on their tensor-core bodies (maxd 20, s2 2) with one
    f2 value (read by d_f1) and one f1 value (read by d_f2) set to fp16 inf:
    each output non-finite wherever its plain version's is, some output
    non-finite exactly when some plain one is (the decision of the fp16
    step's skip check), and the outputs finite in both within one fp16 ulp.
    The bodies multiply the band's masked zeros, so an inf makes NaNs of
    its whole n-tile; the extra non-finite outputs are counted."""
    from flownet2_tpu_torch.ops import correlation as corr

    f1, f2 = f1.clone(), f2.clone()
    f2[0, f2.shape[1] // 3, f2.shape[2] // 2, 30] = float("inf")
    f1[f1.shape[0] - 1, 7, f1.shape[2] // 4 + 1, f1.shape[3] - 3] = \
        float("inf")
    got = corr.correlation_bwd_cuda(g, f1, f2, 20, 2)
    want = corr.correlation_bwd_plain(g, f1, f2, 20, 2)
    for k, (a, b) in enumerate(zip(got, want)):
        what = f"K{5 + k} fp16 d_f{1 + k} with an inf in f{2 - k}"
        bad_a, bad_b = ~torch.isfinite(a), ~torch.isfinite(b)
        n_a, n_b = int(bad_a.sum()), int(bad_b.sum())
        note(f"  {what}: {n_a} outputs non-finite, the plain version's "
             f"{n_b} ({n_a - n_b} more) of {a.numel()}")
        if bool((bad_b & ~bad_a).any()) or (n_a > 0) != (n_b > 0):
            raise AssertionError(f"{what}: finite where the plain version "
                                 "is not, or the skip check decides apart")
        ok = ~bad_a
        ulp_err(a[ok], b[ok], f"{what}, the outputs finite in both")


def fp16_kernels(dev: torch.device, errs: dict) -> None:
    """Phase 2's fp16 forms: every fp16 entry point against its plain
    version at phase 2's bf16 cases, each element within one fp16 ulp and
    at most 1% of them not bit-equal (``ulp_err``): K1, K5 and K6 at the
    main-path, training, wide and ragged maps (on their tensor-core bodies
    at maxd 20, s2 2, the ragged maps reaching the 4- and 2-byte copies;
    the general bodies at maxd 8, s2 1 and maxd 4, s2 2), the share of
    values not bit-equal noted for each kernel and body; K5 and K6 with an
    inf in f2 and in f1 at the training map (``nonfinite_gate``); K2 for one
    flow of +-8 px and of +-200 px and for two flows over the
    (8, 3, 384, 512) image and the ragged (2, 3, 100, 150) one; K3 (out;
    its float32 d1 and d2 at 1e-5) and K4 on K3's and K4's cases and at
    (2, 3, 100, 136), K4 also at one ulp of the tangent route's fp16 flow
    gradient; K2, K3 and K4 at the smooth flow and with both routes in one
    launch.  K7 fp16 (forward, d_f1, d_slab) on the bands of 1, 2 and 4:
    every band's forward and d_f1 bit-equal to the same rows of K1 and K5
    fp16, one band's d_slab rows [20, 20 + H) K6 fp16's, the top, a middle
    and the bottom band at one ulp of the plain version; the fp16
    local-rows K2, K3 and K4 (one and two flows, +-8 px and +-200 px) on
    the bands of 2 and of 4 bit-equal to the same rows of the whole-image
    fp16 kernels.  Inputs of a generator of their own; the readings go
    into ``errs`` under the counter names."""
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import correlation_spatial as corr_sp
    from flownet2_tpu_torch.ops import resample2d as r2d
    from flownet2_tpu_torch.ops import upsample

    gen = torch.Generator(device=dev).manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).half()

    def uniform(*shape, scale):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * scale).half()

    def body(maxd, s2):
        """The body an fp16 correlation kernel runs at (maxd, s2)."""
        return ("tensor-core body" if (maxd, s2) == (20, 2)
                else "general body")

    print("  fp16 kernels against their plain versions, one fp16 ulp")
    odd = (2, 40, 20, 75)
    main_map = (BATCH, 256, HEIGHT // 8, WIDTH // 8)
    train_map = (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8)
    maps = (main_map, (4, 256, 48, 128), (2, 40, 20, 152), odd,
            (2, 40, 3, 64), (2, 40, 5, 75))
    flips = {}
    for shape, maxd, s2 in ([(m, 20, 2) for m in maps]
                            + [(odd, 8, 1), (odd, 4, 2)]):
        f1, f2 = randn(*shape), randn(*shape)
        args = (maxd, 1, maxd, 1, s2)
        got = corr.correlation_cuda(f1, f2, *args)
        want = corr.correlation_plain(f1, f2, *args)
        errs.setdefault("correlation_fwd_fp16", []).append(ulp_err(
            got, want, f"K1 fp16 correlation {shape}, maxd {maxd}, s2 {s2}"))
        flips.setdefault(("K1", body(maxd, s2)), []).append(
            (got != want).float().mean().item())
    for shape, maxd, s2 in ([(m, 20, 2) for m in (train_map,) + maps
                             + ((2, 40, 20, 150),)]
                            + [(odd, 8, 1), (odd, 4, 2)]):
        f1, f2 = randn(*shape), randn(*shape)
        g = randn(shape[0], (2 * (maxd // s2) + 1) ** 2, *shape[2:])
        got = corr.correlation_bwd_cuda(g, f1, f2, maxd, s2)
        want = corr.correlation_bwd_plain(g, f1, f2, maxd, s2)
        for k, name in enumerate(("correlation_bwd_f1_fp16",
                                  "correlation_bwd_f2_fp16")):
            errs.setdefault(name, []).append(ulp_err(
                got[k], want[k], f"K{5 + k} fp16 correlation d_f{1 + k} "
                f"{shape}, maxd {maxd}, s2 {s2}"))
            kernel = f"K{5 + k}"
            flips.setdefault((kernel, body(maxd, s2)), []).append(
                (got[k] != want[k]).float().mean().item())
    for (kernel, kind), shares in flips.items():
        note(f"  {kernel} fp16 ({kind}) against its plain version: "
             f"{min(shares):.4%} to {max(shares):.4%} of the values not "
             f"bit-equal over {len(shares)} cases")
    nonfinite_gate(randn(*train_map), randn(*train_map),
                   randn(train_map[0], 21 * 21, *train_map[2:]))

    img = randn(BATCH, 3, HEIGHT, WIDTH)
    flow8 = uniform(BATCH, 2, HEIGHT, WIDTH, scale=8.0)
    flow200 = uniform(BATCH, 2, HEIGHT, WIDTH, scale=200.0)
    ragged_img = randn(2, 3, 100, 150)
    ragged_flow = uniform(2, 2, 100, 150, scale=8.0)
    for what, im, fl in (("one flow of +-8 px", img, flow8),
                         ("one flow of +-200 px", img, flow200),
                         ("one flow, (2, 3, 100, 150)", ragged_img,
                          ragged_flow)):
        errs.setdefault("resample2d_fwd_fp16", []).append(ulp_err(
            r2d.resample2d_cuda(im, fl), r2d.resample2d_plain(im, fl),
            f"K2 fp16 warp, {what}"))
    flows = torch.stack([flow8, flow200], dim=1)
    ragged_flows = torch.stack(
        [ragged_flow, uniform(2, 2, 100, 150, scale=200.0)], dim=1)
    for what, im, fl in (("two flows", img, flows),
                         ("two flows, (2, 3, 100, 150)", ragged_img,
                          ragged_flows)):
        errs.setdefault("resample2d_fwd_multi_fp16", []).append(ulp_err(
            r2d.resample2d_multi_cuda(im, fl),
            r2d.resample2d_multi_plain(im, fl), f"K2 fp16 warp, {what}"))

    # K3 and K4 at K3's and K4's cases, and at W = 136, where the last
    # column tile's first thread pair of K3's paired tangent stores has one
    # thread in the map and one past its end
    t_img = randn(TRAIN_BATCH, 3, TRAIN_HEIGHT, TRAIN_WIDTH)
    t_flows = torch.stack([
        uniform(TRAIN_BATCH, 2, TRAIN_HEIGHT, TRAIN_WIDTH, scale=px)
        for px in (8.0, 200.0)], dim=1)
    cases = [("+-8 px", t_img, t_flows[:, :1].contiguous()),
             ("+-200 px", t_img, t_flows[:, 1:].contiguous()),
             ("two flows", t_img, t_flows),
             ("(2, 3, 100, 150)", ragged_img, ragged_flow.unsqueeze(1)),
             ("two flows, (2, 3, 100, 136)", randn(2, 3, 100, 136),
              uniform(2, 2, 2, 100, 136, scale=8.0))]

    def warp_checks(what, im, fl, g):
        nflows = fl.shape[1]
        k3 = r2d._per_flow("resample2d_tangents", nflows) + "_fp16"
        got = r2d.resample2d_tangents_cuda(im, fl)
        want = r2d.resample2d_tangents_plain(im, fl)
        errs.setdefault(k3, []).append(ulp_err(
            got[0], want[0], f"K3 fp16 warp tangents out, {what}"))
        for part, a, b in zip(("d1", "d2"), got[1:], want[1:]):
            if a.dtype != torch.float32:
                raise AssertionError(f"K3 fp16 {part}: {a.dtype}")
            errs[k3].append(max_err(a, b, 1e-5, 1e-5, f"K3 fp16 warp "
                                    f"tangents {part} (float32), {what}"))
        k4 = r2d.resample2d_grad_flow_cuda(g, im, fl)
        errs.setdefault(r2d._per_flow("resample2d_grad_flow", nflows)
                        + "_fp16", []).append(ulp_err(
            k4, r2d.resample2d_grad_flow_plain(g, im, fl),
            f"K4 fp16 warp flow gradient, {what}"))
        return k4

    for what, im, fl in cases:
        g = randn(fl.shape[0], fl.shape[1], 3, *fl.shape[3:])
        k4 = warp_checks(what, im, fl, g)
        with torch.enable_grad():
            leaf = fl.clone().requires_grad_()
            (tangent_grad,) = torch.autograd.grad(
                r2d.resample2d_tangents(im, leaf), leaf, g)
        ulp_err(k4, tangent_grad, f"K4 fp16 against the tangent route's "
                f"fp16 d_flow, {what}")

    # the row tiles at the smooth flow the stage glue makes (+-8 px at
    # (H/4, W/4), bilinear x4), and in one launch whose blocks take both
    # routes (half the batch at +-8 px, half at +-200 px)
    half = BATCH // 2
    for nflows in (1, 2):
        tiles = [(f"smooth flow, {nflows} flow(s), {h}x{w}",
                  upsample.upsample_bilinear(
                      uniform(BATCH * nflows, 2, h // 4, w // 4, scale=8.0)
                      .float()).reshape(BATCH, nflows, 2, h, w).half())
                 for h, w in ((HEIGHT, WIDTH), (TRAIN_HEIGHT, TRAIN_WIDTH))]
        tiles.append((f"both routes in one launch, {nflows} flow(s)",
                      torch.cat([uniform(half, nflows, 2, HEIGHT, WIDTH,
                                         scale=8.0),
                                 uniform(BATCH - half, nflows, 2, HEIGHT,
                                         WIDTH, scale=200.0)])))
        for what, fl in tiles:
            im = randn(BATCH, 3, *fl.shape[3:])
            errs[r2d._per_flow("resample2d_fwd", nflows) + "_fp16"].append(
                ulp_err(r2d.resample2d_multi_cuda(im, fl),
                        r2d.resample2d_multi_plain(im, fl),
                        f"K2 fp16 warp, {what}"))
            warp_checks(what, im, fl, randn(BATCH, nflows, 3, *fl.shape[3:]))

    # K7 fp16 on the bands of the main paths', the wide and the ragged
    # maps and of a 5-row map (bands of one row at 4)
    names = ("correlation_fwd_rows_fp16", "correlation_bwd_f1_rows_fp16",
             "correlation_bwd_f2_rows_fp16")
    for shape in (main_map, train_map, (4, 256, 48, 128), (2, 40, 20, 152),
                  odd, (2, 40, 5, 64)):
        f1, f2 = randn(*shape), randn(*shape)
        g = randn(shape[0], 21 * 21, *shape[2:])
        whole = (corr.correlation_cuda(f1, f2, 20, 1, 20, 1, 2),
                 *corr.correlation_bwd_cuda(g, f1, f2, 20, 2))
        f2p = F.pad(f2, (0, 0, 20, 20))
        for shards in (1, 2, 4):
            local_h = shape[2] // shards
            for band in range(shards):
                off = band * local_h
                rows = slice(off, off + local_h)
                f1_loc = f1[:, :, rows].contiguous()
                g_loc = g[:, :, rows].contiguous()
                slab = f2p[:, :, off:off + local_h + 40].contiguous()
                got = (corr_sp.corr_slab_cuda(f1_loc, slab, 20, 2),
                       *corr_sp.corr_slab_bwd_cuda(g_loc, f1_loc, slab, 20,
                                                   2))
                for k in range(2):
                    if not torch.equal(got[k], whole[k][:, :, rows]):
                        raise AssertionError(
                            f"{names[k]} {shape}, band {band} of {shards}: "
                            "not the whole-map fp16 kernel's bits")
                if shards == 1 and not torch.equal(got[2][:, :, 20:-20],
                                                   whole[2]):
                    raise AssertionError(
                        f"{names[2]} {shape}, one band: rows [20, 20 + H) "
                        "not K6 fp16's bits")
                if 1 < band < shards - 1:
                    continue   # one middle band is held to the plain op
                want = (corr_sp.corr_slab_plain(f1_loc, slab, 20, 2),
                        *corr_sp.corr_slab_bwd_plain(g_loc, f1_loc, slab, 20,
                                                     2))
                for name, a, b in zip(names, got, want):
                    errs.setdefault(name, []).append(ulp_err(
                        a, b, f"K7 fp16 {name} {shape}, band {band} of "
                        f"{shards}"))
        print(f"  K7 fp16 {shape}: one band bit-equal to K1, K5, K6 fp16; "
              "the bands of 2 and of 4 bit-equal to K1, K5 fp16's rows")

    # the fp16 local-rows K2, K3, K4 against the same rows of the whole
    # image
    for what, im, fl in (
            ("K2 shape, one flow of +-8 px", img, flow8.unsqueeze(1)),
            ("K2 shape, one flow of +-200 px", img, flow200.unsqueeze(1)),
            ("K2 shape, two flows", img, flows),
            ("K3/K4 shape, one flow of +-8 px", t_img,
             t_flows[:, :1].contiguous()),
            ("K3/K4 shape, one flow of +-200 px", t_img,
             t_flows[:, 1:].contiguous()),
            ("K3/K4 shape, two flows", t_img, t_flows)):
        g = randn(fl.shape[0], fl.shape[1], 3, *fl.shape[3:])
        whole = (r2d.resample2d_multi_cuda(im, fl),
                 *r2d.resample2d_tangents_cuda(im, fl),
                 r2d.resample2d_grad_flow_cuda(g, im, fl))
        for shards in (2, 4):
            local_h = im.shape[2] // shards
            for off in range(0, im.shape[2], local_h):
                rows = slice(off, off + local_h)
                fl_loc = fl[:, :, :, rows].contiguous()
                got = (r2d.resample2d_multi_cuda(im, fl_loc, off),
                       *r2d.resample2d_tangents_cuda(im, fl_loc, off),
                       r2d.resample2d_grad_flow_cuda(
                           g[:, :, :, rows].contiguous(), im, fl_loc, off))
                for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2",
                                       "K4"), got, whole):
                    if a.dtype != b.dtype or not torch.equal(
                            a, b[:, :, :, rows]):
                        raise AssertionError(
                            f"{part} fp16 local rows [{off}, "
                            f"{off + local_h}), {what}: not the whole-image "
                            "fp16 kernel's bits")
        print(f"  K2, K3, K4 fp16 on the bands of 2 and of 4, {what}: "
              "bit-equal to the whole-image fp16 kernels' rows")


def cfg_corr_flops(b: int, c: int, h: int, w: int, pad: int, k: int,
                   maxd: int, s1: int, s2: int) -> int:
    """Flops of the correlation at any configuration (the forward and each
    gradient alike) that touch data: a tap's multiply-add of a shift counts
    only where its f1 and its f2 sample lie inside the map (the bodies
    skip or zero the others); ``corr_flops`` at K 1, s1 1, pad == maxd."""
    k_rad = (k - 1) // 2
    b_rad = k_rad + maxd
    r = maxd // s2

    def inside(n: int) -> int:
        out_n = max(0, math.ceil((n + 2 * pad - 2 * b_rad) / s1))
        return sum(1 for t in range(-r, r + 1)
                   for j in range(-k_rad, k_rad + 1) for y in range(out_n)
                   if 0 <= y * s1 + b_rad + j - pad < n
                   and 0 <= y * s1 + b_rad + j - pad + t * s2 < n)

    return 2 * b * c * inside(h) * inside(w)


def cfg_kernels(dev: torch.device, errs: dict) -> dict:
    """Phase 2's configurations no model uses (M6c): the kernels of
    ``csrc/correlation_cfg.cu`` and ``csrc/resample2d_cfg.cu`` in float32,
    bf16 and fp16 against their plain versions on the card, f32 within
    1e-4 (the correlation, as K1's general body) and 1e-5 (the warp, as
    K2), bf16 and fp16 within one ulp with at most 1% not bit-equal
    (``ulp_err``): the correlation, forward and both gradients, at
    FlowNetC's map (8, 256, 48, 64) at (pad 21, K 3, maxd 20, s1 1, s2 2)
    (441 channels at 48x64) and (20, 1, 20, 2, 2) (24x32), and at
    (2, 40, 20, 75) at (2, 3, 3, 2, 1), (6, 1, 4, 1, 1) and (4, 2, 4, 1, 2)
    (an output that shrinks, one larger than the input, even K), on maps
    of normal values times CFG_CORR_SCALE; the warp
    (bilinear K 2 and K 3, nearest) and its flow gradient over the
    (8, 3, 384, 512) image at +-8 px and +-200 px and over a ragged
    (2, 3, 100, 150) one, the nearest warp bit-equal in every dtype; two
    backward calls of each gradient bit-equal.  The image gradient
    (``_d_img``, plain PyTorch) of the three warps at +-8 px and +-200 px,
    float32: two calls bit-equal and within 1e-5 (of its largest magnitude)
    of a float64 sum, as F4's check.  Then the op surface's launch gate in
    each dtype: ``Correlation(21, 3, 20, 1, 2)(f1, f2).backward(g)``,
    ``Resample2d(3)(img, flow).backward(g)`` and ``Resample2d(1,
    bilinear=False)(img, flow).backward(g)``, with the counters set to 0
    before and read after: one launch of each cfg entry point, no plain-op
    call.  Inputs of a generator of their own; the readings go into
    ``errs`` under the counter names.  Returns the gate's launches."""
    from flownet2_tpu_torch import ops
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import resample2d as r2d

    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, scale, dtype=torch.float32):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * scale).to(dtype)

    def close(got, want, tol, what, name):
        if got.dtype == torch.float32:
            err = max_err(got, want, tol, tol, what)
        else:
            err = ulp_err(got, want, what)
        errs.setdefault(name, []).append(err)

    print("  the configurations no model uses (M6c), against their plain "
          "versions")
    main_map = (BATCH, 256, HEIGHT // 8, WIDTH // 8)
    odd = (2, 40, 20, 75)
    corr_cases = ((main_map, (21, 3, 20, 1, 2)), (main_map, (20, 1, 20, 2, 2)),
                  (odd, (2, 3, 3, 2, 1)), (odd, (6, 1, 4, 1, 1)),
                  (odd, (4, 2, 4, 1, 2)))
    warps = ((2, True), (3, True), (1, False))
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    for dtype in dtypes:
        sfx = _cuda.suffix(dtype)
        for shape, cfg in corr_cases:
            tag = f"{shape} at {cfg}, {str(dtype)[6:]}"
            f1, f2 = (randn(*shape, dtype=dtype, scale=CFG_CORR_SCALE)
                      for _ in range(2))
            out = corr.correlation_cfg_cuda(f1, f2, *cfg)
            close(out, corr.correlation_plain(f1, f2, *cfg), 1e-4,
                  f"cfg correlation {tag}", "correlation_cfg_fwd" + sfx)
            g = randn(*out.shape, dtype=dtype)
            got = corr.correlation_cfg_bwd_cuda(g, f1, f2, *cfg)
            want = corr.correlation_cfg_bwd_plain(g, f1, f2, *cfg)
            for k in range(2):
                close(got[k], want[k], 1e-4, f"cfg correlation d_f{k + 1} "
                      f"{tag}", f"correlation_cfg_bwd_f{k + 1}" + sfx)
            again = corr.correlation_cfg_bwd_cuda(g, f1, f2, *cfg)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"cfg correlation gradients {tag}: two "
                                     "calls differ")
        img = randn(BATCH, 3, HEIGHT, WIDTH, dtype=dtype)
        ragged = randn(2, 3, 100, 150, dtype=dtype)
        for im, px in ((img, 8.0), (img, 200.0), (ragged, 8.0)):
            fl = uniform(im.shape[0], 2, *im.shape[2:], scale=px, dtype=dtype)
            g = randn(*im.shape, dtype=dtype)
            for taps, bilinear in warps:
                tag = (f"{tuple(im.shape)}, +-{px:g} px, "
                       f"{f'bilinear K {taps}' if bilinear else 'nearest'}, "
                       f"{str(dtype)[6:]}")
                name = ("resample2d_cfg_fwd" + ("" if bilinear else "_nearest")
                        + sfx)
                out = r2d.resample2d_cfg_cuda(im, fl, taps, bilinear)
                want = r2d.resample2d_plain(im, fl, taps, bilinear)
                if not bilinear:
                    if not torch.equal(out, want):
                        raise AssertionError(f"cfg warp {tag}: not the plain "
                                             "version's gather")
                    errs.setdefault(name, []).append(0.0)
                    print(f"  cfg warp {tag}: bit-equal")
                    continue
                close(out, want, 1e-5, f"cfg warp {tag}", name)
                d_flow = r2d.resample2d_cfg_grad_flow_cuda(g, im, fl, taps)
                close(d_flow, r2d.resample2d_cfg_grad_flow_plain(g, im, fl,
                                                                  taps),
                      1e-5, f"cfg warp flow gradient {tag}",
                      "resample2d_cfg_grad_flow" + sfx)
                if not torch.equal(d_flow, r2d.resample2d_cfg_grad_flow_cuda(
                        g, im, fl, taps)):
                    raise AssertionError(f"cfg warp flow gradient {tag}: two "
                                         "calls differ")
        if dtype != torch.float32:
            continue
        for px in (8, 200):
            fl = uniform(BATCH, 1, 2, HEIGHT, WIDTH, scale=px)
            g = randn(BATCH, 1, 3, HEIGHT, WIDTH)
            for taps, bilinear in warps:
                what = (f"cfg warp image gradient, "
                        f"{f'bilinear K {taps}' if bilinear else 'nearest'}, "
                        f"+-{px} px")
                first = r2d._d_img(g, img, fl, 0, taps, bilinear)
                second = r2d._d_img(g, img, fl, 0, taps, bilinear)
                with torch.enable_grad():
                    leaf = img.double().requires_grad_()
                    r2d.resample2d_plain(leaf, fl[:, 0].double(), taps,
                                         bilinear).backward(g[:, 0].double())
                err = (first.double() - leaf.grad).abs().max().item()
                top = leaf.grad.abs().max().item()
                same = torch.equal(first, second)
                print(f"  {what}: two calls bit-equal {same}; max abs diff "
                      f"{err:.3e} from a float64 sum (|max| {top:.3f}; limit "
                      "1e-5 of it)")
                if not same or err > 1e-5 * top:
                    raise AssertionError(f"{what}: not a fixed sum of the "
                                         "taps")
        del leaf, first, second

    launches = {}
    for dtype in dtypes:
        sfx = _cuda.suffix(dtype)
        with torch.enable_grad():
            f1, f2 = (randn(*main_map, dtype=dtype).requires_grad_()
                      for _ in range(2))
            g = randn(BATCH, 441, *main_map[2:], dtype=dtype)
            img = randn(BATCH, 3, HEIGHT, WIDTH, dtype=dtype).requires_grad_()
            fl = uniform(BATCH, 2, HEIGHT, WIDTH, scale=8.0,
                         dtype=dtype).requires_grad_()
            gw = randn(BATCH, 3, HEIGHT, WIDTH, dtype=dtype)
            ops.reset_counts()
            ops.Correlation(21, 3, 20, 1, 2)(f1, f2).backward(g)
            ops.Resample2d(3)(img, fl).backward(gw)
            ops.Resample2d(1, bilinear=False)(img, fl).backward(gw)
            torch.cuda.synchronize(dev)
            got, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        want = {base + sfx: 1 for base in (
            "correlation_cfg_fwd", "correlation_cfg_bwd_f1",
            "correlation_cfg_bwd_f2", "resample2d_cfg_fwd",
            "resample2d_cfg_grad_flow", "resample2d_cfg_fwd_nearest")}
        finite = all(bool(torch.isfinite(t.grad).all())
                     for t in (f1, f2, img, fl))
        note(f"  op surface, {str(dtype)[6:]}: Correlation(21, 3, 20, 1, 2) "
             "and Resample2d(3) forward and backward, Resample2d(1, "
             f"bilinear=False) forward: launches {got}, plain-op calls "
             f"{plain}; gradients finite {finite}")
        if got != want or plain or not finite:
            raise AssertionError(f"op surface, {dtype}: launches {got}, "
                                 f"plain-op calls {plain}; wanted {want}, "
                                 "none, finite gradients")
        launches.update(got)
    return launches


def cfg_times(dev: torch.device, smi: str, peaks, errs: dict,
              launches: dict) -> list:
    """Phase 6's rows of the cfg kernels, in float32, bf16 and fp16: the
    correlation's three at FlowNetC's map (8, 256, 48, 64) at (21, 3, 20,
    1, 2), the bilinear K 3 warp, its flow gradient and the nearest warp
    over the (8, 3, 384, 512) image at +-8 px; each with the plain
    version's time, its bound (in-map multiply-adds, ``cfg_corr_flops``,
    and bytes; bf16 and fp16 at the tensor-core rate, and at the f32 rate
    their bodies sum at) and, for the nearest warp, ``F.grid_sample(mode=
    "nearest")``, which rounds a half pixel to even where the op rounds it
    up.  Also printed, f32: the correlation at (20, 1, 20, 2, 2) and the
    warps at K 2 and at +-200 px.  ``launches`` are the op-surface gate's
    (``cfg_kernels``).  Returns the rows of the kernels line."""
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import resample2d as r2d

    gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
    f1, f2 = randn(b, c, h, w), randn(b, c, h, w)
    img = randn(BATCH, 3, HEIGHT, WIDTH)
    fl8 = (torch.rand((BATCH, 2, HEIGHT, WIDTH), generator=gen,
                      device=dev) * 2 - 1) * 8.0
    fl200 = fl8 * 25.0
    gw = randn(BATCH, 3, HEIGHT, WIDTH)
    xs = torch.arange(WIDTH, device=dev).view(1, 1, -1)
    ys = torch.arange(HEIGHT, device=dev).view(1, -1, 1)
    grid = torch.stack([(xs + fl8[:, 0]) * (2.0 / (WIDTH - 1)) - 1.0,
                        (ys + fl8[:, 1]) * (2.0 / (HEIGHT - 1)) - 1.0], -1)
    pixels = BATCH * HEIGHT * WIDTH

    def corr_rows(cfg, dtype):
        sfx = _cuda.suffix(dtype)
        a, bb = f1.to(dtype), f2.to(dtype)
        out_h, out_w = corr._out_dims(h, w, *cfg[:4])
        disp = 2 * (cfg[2] // cfg[4]) + 1
        g = randn(b, disp * disp, out_h, out_w).to(dtype)
        size = a.element_size()
        nbytes = size * (2 * b * c * h * w + b * disp * disp * out_h * out_w)
        flops = cfg_corr_flops(b, c, h, w, *cfg)
        yield ("correlation_cfg_fwd" + sfx, "correlation.py:60",
               "correlation_cfg.cu",
               lambda: corr.correlation_cfg_cuda(a, bb, *cfg),
               lambda: corr.correlation_plain(a, bb, *cfg), None, nbytes,
               flops)
        for k, needs in ((1, (True, False)), (2, (False, True))):
            yield (f"correlation_cfg_bwd_f{k}" + sfx, "correlation.py:253",
                   "correlation_cfg.cu",
                   (lambda needs=needs: corr.correlation_cfg_bwd_cuda(
                       g, a, bb, *cfg, needs=needs)),
                   (lambda needs=needs: corr.correlation_cfg_bwd_plain(
                       g, a, bb, *cfg, needs=needs)), None, nbytes, flops)

    def warp_rows(taps, fl, dtype):
        sfx = _cuda.suffix(dtype)
        im, flow, g = img.to(dtype), fl.to(dtype), gw.to(dtype)
        size = im.element_size()
        chans = im.shape[1]
        # per output pixel ~10 flops of coordinates and weights, then 8 a
        # corner and channel (the warp: a multiply and an add) or 12 a tap
        # and channel (the flow gradient); the nearest warp ~4 a pixel
        yield ("resample2d_cfg_fwd" + sfx, "resample2d.py:101",
               "resample2d_cfg.cu",
               lambda: r2d.resample2d_cfg_cuda(im, flow, taps, True),
               lambda: r2d.resample2d_plain(im, flow, taps, True), None,
               size * pixels * (2 * chans + 2),
               pixels * (10 + 8 * taps * taps * chans))
        yield ("resample2d_cfg_grad_flow" + sfx, "resample2d.py:281",
               "resample2d_cfg.cu",
               lambda: r2d.resample2d_cfg_grad_flow_cuda(g, im, flow, taps),
               lambda: r2d.resample2d_cfg_grad_flow_plain(g, im, flow, taps),
               None, size * pixels * (2 * chans + 4),
               pixels * (10 + 12 * taps * taps * chans))
        # the library call on bf16 would take a bf16 grid (2-4 px off)
        lib = (None if dtype == torch.bfloat16 else
               lambda g16=grid.to(dtype): F.grid_sample(
                   im, g16, mode="nearest", padding_mode="border",
                   align_corners=True))
        yield ("resample2d_cfg_fwd_nearest" + sfx, "resample2d.py:124",
               "resample2d_cfg.cu",
               lambda: r2d.resample2d_cfg_cuda(im, flow, 1, False),
               lambda: r2d.resample2d_plain(im, flow, 1, False), lib,
               size * pixels * (2 * chans + 2), pixels * 4)

    kernels = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        low = dtype != torch.float32
        rows = [*corr_rows((21, 3, 20, 1, 2), dtype),
                *warp_rows(3, fl8, dtype)]
        for name, replaces, src, fn, plain, lib, nbytes, flops in rows:
            k_ms = time_ms(fn, 20, head_start=True)
            p_ms = time_ms(plain, 3, warmup=1)
            l_ms = (time_ms(lib, 50, head_start=True) if lib is not None
                    else None)
            b_ms, b_by = bound_ms(nbytes, flops, peaks, tensor_cores=low)
            note(f"  {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                 f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
                 f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                 f"{flops / 1e9:.3f} GFLOP); {launches[name]} launch a gate "
                 f"run  [{smi}; SM clock, max: {sm_clock()}]")
            extra = ({"bound_ms_f32_body": bound_ms(nbytes, flops, peaks)[0]}
                     if low else {})
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"flownet2_tpu_torch/csrc/{src}",
                "replaces": f"flownet2_tpu/ops/{replaces}",
                "launches": launches[name], "max_abs_err": max(errs[name]),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms, **extra})
    for what, rows in (
            ("at (20, 1, 20, 2, 2)", corr_rows((20, 1, 20, 2, 2),
                                               torch.float32)),
            ("at K 2 (nearest: K ignored), +-8 px",
             warp_rows(2, fl8, torch.float32)),
            ("at K 3, +-200 px", warp_rows(3, fl200, torch.float32))):
        for name, _, _, fn, _, _, nbytes, flops in rows:
            note(f"  {name} {what}: {time_ms(fn, 20, head_start=True):.4f} "
                 f"ms, bound {bound_ms(nbytes, flops, peaks)[0]:.4f} ms  "
                 f"[{smi}]")
    return kernels


def fp16_inference_phase(smi: str, model, pairs, small, plain_ops) -> dict:
    """Phase 3c: FlowNet2 fp16 inference (``get_model(...,
    dtype=torch.float16)``), phase 3's weights and pairs: TIMED_BATCHES
    timed batches, the counters set to 0 just before and read just after
    (per forward 1 correlation_fwd_fp16, 2 resample2d_fwd_fp16 and 1
    resample2d_fwd_multi_fp16, nothing else, no plain-op call); the output
    finite, fp16 and (B, H, W, 2), and within the JAX package's bf16
    contract of the plain-op fp16 model on the card (``plain_ops``), of the
    fp32 ``model`` and, on the ``small`` pair, of the fp16 model on the
    CPU; under two row bands, cuDNN deterministic, within the same contract
    of the whole map, that forward's launches exact (2
    correlation_fwd_rows_fp16, 4 resample2d_fwd_fp16, 2
    resample2d_fwd_multi_fp16).  Prints ms/batch, frames/s, the peak
    memory, the host's time to enqueue a forward and the contract's
    readings.  The fp16 model is freed at the end.  Returns the launches of
    the timed forwards and of the band forward, and the ms/batch."""
    from flownet2_tpu_torch import ops
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import sharding_hints

    print(f"phase 3c: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} fp16 (float32 "
          "parameters, fp16 convolutions, glue and warps)")
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.float16)

    def check_launches(what, got, plain, want):
        print(f"  {what}: launches {got}; plain-op calls {plain}")
        if got != want or plain:
            raise AssertionError(f"{what}: launches {got} / plain calls "
                                 f"{plain}; expected {want} / {{}}")

    with torch.inference_mode():
        for pair in pairs:
            model16(pair)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_counts()
        start.record()
        for i in range(TIMED_BATCHES):
            flow16 = model16(pairs[i % 2])
        end.record()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check_launches(f"phase 3c, {TIMED_BATCHES} fp16 forwards", launches,
                       dict(ops.PLAIN_CALLS),
                       {"correlation_fwd_fp16": TIMED_BATCHES,
                        "resample2d_fwd_fp16": 2 * TIMED_BATCHES,
                        "resample2d_fwd_multi_fp16": TIMED_BATCHES})
        ms = start.elapsed_time(end) / TIMED_BATCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if flow16.shape != (BATCH, HEIGHT, WIDTH, 2) \
                or flow16.dtype != torch.float16 \
                or not torch.isfinite(flow16).all():
            raise AssertionError(f"bad fp16 flow: {tuple(flow16.shape)} "
                                 f"{flow16.dtype}, finite="
                                 f"{torch.isfinite(flow16).all().item()}")
        note(f"  phase 3c, fp16 inference: {ms:.3f} ms/batch, "
             f"{BATCH / ms * 1e3:.2f} frames/s, peak {peak_gib:.2f} GiB "
             f"allocated; launches over {TIMED_BATCHES} forwards "
             f"{launches}  [{smi}]")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_BATCHES):
            model16(pairs[i % 2])
        host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_BATCHES
        torch.cuda.synchronize()
        note(f"  phase 3c: the host enqueues an fp16 forward in "
             f"{host_ms:.3f} ms, the card runs one in {ms:.3f} ms")

        flow16 = model16(pairs[0])
        with plain_ops():
            bf16_contract(flow16, model16(pairs[0]), "phase 3c, against the "
                          "plain-op fp16 model on the card")
        bf16_contract(flow16, model(pairs[0]), "phase 3c, against the fp32 "
                      "model of the same weights")
        cpu16 = get_model("FlowNet2", device="cpu", seed=0,
                          dtype=torch.float16)
        bf16_contract(model16(small), cpu16(small.cpu()), "phase 3c, small "
                      "pair against the fp16 model on the CPU")
        del cpu16
        # two row bands (K7 fp16 and the fp16 local-rows K2) against the
        # whole map, cuDNN deterministic
        torch.backends.cudnn.deterministic = True
        try:
            whole = model16(pairs[0])
            ops.reset_counts()
            with sharding_hints.scoped_spatial_shards(SHARDS):
                bands = model16(pairs[0])
            torch.cuda.synchronize()
            band_launches = dict(ops.LAUNCHES)
            check_launches(f"phase 3c, one fp16 forward as {SHARDS} row "
                           "bands", band_launches, dict(ops.PLAIN_CALLS),
                           {"correlation_fwd_rows_fp16": SHARDS,
                            "resample2d_fwd_fp16": 2 * SHARDS,
                            "resample2d_fwd_multi_fp16": SHARDS})
        finally:
            torch.backends.cudnn.deterministic = False
        note(f"  phase 3c, fp16 model under {SHARDS} row bands against the "
             f"whole map, cuDNN deterministic: bit-equal "
             f"{torch.equal(bands, whole)}, not bit-equal "
             f"{(bands != whole).float().mean().item():.4%}")
        bf16_contract(bands, whole, f"phase 3c, fp16 model under {SHARDS} "
                      "row bands against the whole map")
        del flow16, whole, bands
    del model16
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "band_launches": band_launches, "ms": ms,
            "host_ms": host_ms}


def batchnorm_phase(smi: str) -> None:
    """Phase 3d: BatchNorm in low precision.  FlowNet2S with BatchNorm
    (``batch_norm=True``, seeded weights) at b8 HEIGHT x WIDTH, MultiScale,
    Adam 1e-4, cuDNN deterministic: one train step in fp32, in bf16 and in
    fp16 (loss scale FP16_SCALE, non-finite updates skipped), each from
    the same weights and running statistics.  In bf16 and fp16: the
    step's train-mode forward (each scale of the tuple in the compute
    dtype) and its loss within the bf16 contract of the fp32 model's;
    every gradient float32 and finite, no update skipped; the running
    statistics float32 and, for each BatchNorm, within 1e-5 (of their
    largest magnitude) of 0.9 of their old value plus 0.1 of the float64
    mean and unbiased variance of that layer's own low-precision input in
    the step (so the statistics are float32 sums), and, each layer's mean
    and variance, within the bf16 contract of the fp32 model's after its
    step (printed: the worst share of the contract's limit)."""
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    print(f"phase 3d: FlowNet2S with BatchNorm b{BATCH} {HEIGHT}x{WIDTH}, "
          "one train step in fp32, bf16 and fp16")
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    images = torch.rand((BATCH, 2, HEIGHT, WIDTH, 3), generator=gen,
                        device=DEVICE) * 255.0
    target = torch.rand((BATCH, HEIGHT, WIDTH, 2), generator=gen,
                        device=DEVICE) * 5.0
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            model = get_model("FlowNet2S", device=DEVICE, seed=3,
                              batch_norm=True, dtype=dtype)
            norms = {n: m for n, m in model.named_modules()
                     if isinstance(m, torch.nn.BatchNorm2d)}
            before = {n: (m.running_mean.clone(), m.running_var.clone())
                      for n, m in norms.items()}
            seen, hooks = {}, []

            def stats(name):
                def hook(module, args):
                    x = args[0].detach().double()
                    seen[name] = (x.mean(dim=(0, 2, 3)),
                                  x.var(dim=(0, 2, 3), unbiased=True))
                return hook

            for n, m in norms.items():
                hooks.append(m.register_forward_pre_hook(stats(n)))
            outs = []
            hooks.append(model.register_forward_hook(
                lambda mod, args, out: outs.append(
                    [t.detach().clone() for t in out])))
            fp16 = dtype == torch.float16
            factory = StepFactory(model, MultiScale(),
                                  get_optimizer("Adam", 1e-4),
                                  loss_scale=FP16_SCALE if fp16 else 1.0,
                                  skip_nonfinite_updates=fp16)
            metrics = factory.train_step()(images, target)
            torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            bad = [n for n, p in model.named_parameters()
                   if p.grad.dtype != torch.float32
                   or not torch.isfinite(p.grad).all()]
            if bad or factory.skipped_updates:
                raise AssertionError(f"phase 3d, {dtype}: gradients not "
                                     f"float32 and finite {bad[:5]}, "
                                     f"{factory.skipped_updates} skipped")
            runs[dtype] = dict(
                out=outs[0], loss=metrics["loss"].detach(),
                stats={n: (m.running_mean.detach().clone(),
                           m.running_var.detach().clone())
                       for n, m in norms.items()},
                before=before, seen=seen)
            del model, factory, outs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    ref = runs[torch.float32]
    for dtype in (torch.bfloat16, torch.float16):
        run = runs[dtype]
        tag = f"phase 3d, {str(dtype)[6:]}"
        for k, (a, b) in enumerate(zip(run["out"], ref["out"])):
            if a.dtype != dtype:
                raise AssertionError(f"{tag}: flow{k + 2} is {a.dtype}")
            bf16_contract(a, b, f"{tag}, train-mode flow{k + 2} against "
                          "fp32")
        bf16_contract(run["loss"], ref["loss"], f"{tag}, the step's loss "
                      "against fp32")
        own, vs32, vs32_at = 0.0, 0.0, None
        for n, (mean, var) in run["stats"].items():
            if mean.dtype != torch.float32 or var.dtype != torch.float32:
                raise AssertionError(f"{tag}: {n}'s running statistics "
                                     f"are {mean.dtype}")
            old_mean, old_var = run["before"][n]
            in_mean, in_var = run["seen"][n]
            for got, old, batch, ref_stat in (
                    (mean, old_mean, in_mean, ref["stats"][n][0]),
                    (var, old_var, in_var, ref["stats"][n][1])):
                want = 0.9 * old.double() + 0.1 * batch
                top = want.abs().max().item()
                own = max(own, (got.double() - want).abs().max().item()
                          / top)
                # the bf16 contract's mean error over its limit
                ratio = ((got - ref_stat).abs().mean().item()
                         / (0.05 * (ref_stat.abs().mean().item() + 1e-3)
                            + 5e-3))
                if ratio >= vs32:
                    vs32, vs32_at = ratio, n
        note(f"  {tag}: running statistics float32, within {own:.3e} of "
             "the update by the float64 statistics of their own input "
             f"(gate 1e-5); against the fp32 model's, the bf16 contract's "
             f"mean error at {vs32:.3f} of its limit at worst ({vs32_at}); "
             f"{len(run['stats'])} BatchNorm layers  [{smi}]")
        if own > 1e-5 or vs32 >= 1.0:
            raise AssertionError(f"{tag}: running statistics beyond their "
                                 "gates")


def multi_card_cli(smi: str, n_cards: int, work: Path, spatial: int = 1,
                   wanted=("train SGD", "train Adam", "infer")) -> None:
    """The plain command on every card against the same command on one:
    ``python -m flownet2_tpu_torch.cli`` training FlowNet2 2 epochs from
    FlyingChairs-format files (16 training pairs at 384x512, crops of
    TRAIN_HEIGHT x TRAIN_WIDTH, batch TRAIN_BATCH, validation each epoch on
    8) from a ``.pth.tar`` of the seeded weights, once by SGD at DP_CLI_LR
    and once by the default Adam, then ``--inference --save_flow`` of the 8
    validation pairs from the seeded weights.  On every card the command
    starts its ranks itself.  Gates: the same records; step 1's loss (the
    forward before any update) within 1e-5 relative for both optimizers;
    the SGD run's every logged loss within DP_CLI_RTOL relative of one
    card's, and its validation loss after two updates apart from one
    card's by at most DP_CLI_SHARE of what the updates moved it (a wrong
    scale or stripe of the all-reduced update moves it elsewhere); each
    flow written once, within EPE 1e-4 of the one-card run's.  Printed: the Adam run's gaps and, for both
    optimizers, the final parameters' difference between the two runs over
    their displacement from the seeded weights per sub-net.  TF32 off, as
    everywhere in this script.  With ``spatial`` > 1 the command on every
    card takes ``--spatial_shards spatial`` (phase 5f(d): it starts
    data_ranks(batch, cards, spatial) * spatial ranks, each one band) and
    only the runs in ``wanted`` are made; the one-card runs of an earlier
    call in ``work`` are reused."""
    import numpy as np
    from PIL import Image

    from flownet2_tpu_torch.checkpoints.native import STATE_FILE
    from flownet2_tpu_torch.data import read_flo, write_flo
    from flownet2_tpu_torch.models import get_model

    rng = np.random.default_rng(CLI_SEED)
    chairs = work / "chairs"
    for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
        if (chairs / split).exists():   # written by an earlier call
            continue
        (chairs / split).mkdir(parents=True)
        for i in range(n):
            for j in (1, 2):
                Image.fromarray(rng.integers(
                    0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).save(
                        chairs / split / f"{i:05d}_img{j}.ppm")
            write_flo(chairs / split / f"{i:05d}_flow.flo",
                      rng.standard_normal((HEIGHT, WIDTH, 2),
                                          dtype=np.float32) * 4)
    pth = work / "FlowNet2_seeded.pth.tar"
    seeded = get_model("FlowNet2", device="cpu", seed=CLI_SEED).state_dict()
    torch.save({"arch": "FlowNet2", "epoch": 0, "best_EPE": 1e10,
                "state_dict": seeded}, pth)
    common = ["--model", "FlowNet2", "--batch_size", str(TRAIN_BATCH),
              "--resume_torch", str(pth)]
    train = [*common, "--total_epochs", "2",
             "--training_dataset", "FlyingChairs",
             "--training_dataset_root", str(chairs / "train"),
             "--training_dataset_is_cropped", "--crop_size",
             str(TRAIN_HEIGHT), str(TRAIN_WIDTH),
             "--validation_dataset", "FlyingChairs",
             "--validation_dataset_root", str(chairs / "val"),
             "--validation_frequency", "1"]
    runs = {"train SGD": [*train, "--optimizer", "SGD",
                          "--optimizer_lr", str(DP_CLI_LR)],
            "train Adam": train,
            "infer": [*common, "--inference", "--save_flow",
                      "--inference_dataset", "FlyingChairs",
                      "--inference_dataset_root", str(chairs / "val")]}
    # the parity configuration, TF32 off, in the command's processes too
    # (cuDNN and cuBLAS read NVIDIA_TF32_OVERRIDE): with TF32 the two runs'
    # convolutions, which cuDNN picks by batch size, differ by ~1e-3
    every = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    one = dict(every, CUDA_VISIBLE_DEVICES=FIRST_CARD)
    many = f"{n_cards} cards" + (f", --spatial_shards {spatial}"
                                 if spatial > 1 else "")
    bands = ["--spatial_shards", str(spatial)] if spatial > 1 else []
    phase = "5e(d)" if spatial == 1 else "5f(d)"
    seconds = {}
    for label, env in (("one card", one), (many, every)):
        for what in wanted:
            save = work / label / what
            if save.exists():           # the one-card run of an earlier call
                continue
            argv = runs[what] + (bands if label == many else [])
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "flownet2_tpu_torch.cli", *argv,
                 "--save", str(save)], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=900)
            seconds[label, what] = time.perf_counter() - t
            if proc.returncode != 0:
                raise AssertionError(
                    f"phase {phase}, cli {what} on {label}: exit "
                    f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                    f"{proc.stderr[-4000:]}")
            started = "starting " in proc.stderr
            if started != (label != "one card"):
                raise AssertionError(f"phase {phase}, cli {what} on {label}: "
                                     f"started ranks {started}")
            if label == many:
                print(f"  phase {phase}, cli {what} on {label}: "
                      + " ".join(line for line in proc.stderr.splitlines()
                                 if line.startswith("starting ")))

    def records(label, what):
        with open(work / label / what / "run.metrics.jsonl") as f:
            return [(r["step"], r["split"], r["loss"])
                    for r in map(json.loads, f)]

    def flows(label):
        d = work / label / "infer" / "inference" / "flows"
        return sorted(os.listdir(d)), [read_flo(d / f)
                                       for f in sorted(os.listdir(d))]

    def moved_apart(what):
        """Per sub-net, |final parameters on every card - on one card|
        over |final parameters on one card - the seeded ones| (L2)."""
        a, b = (torch.load(work / label / what / "train-checkpoint"
                           / STATE_FILE, map_location="cpu",
                           weights_only=True)["model"]
                for label in ("one card", many))
        diff2, disp2 = {}, {}
        for k, v in seeded.items():
            sub = k.split(".")[0]
            diff2[sub] = diff2.get(sub, 0.0) + float(
                (b[k].double() - a[k].double()).square().sum())
            disp2[sub] = disp2.get(sub, 0.0) + float(
                (a[k].double() - v.double()).square().sum())
        return ", ".join(
            f"{sub} {(diff2[sub] / max(disp2[sub], 1e-300)) ** 0.5:.3e}"
            for sub in sorted(diff2))

    want_steps = [(0, "val"), (1, "train"), (2, "train"), (2, "val"),
                  (3, "train"), (4, "train")]
    ok = True
    for what in (w for w in ("train SGD", "train Adam") if w in wanted):
        ra, rb = records("one card", what), records(many, what)
        rel = [abs(b[2] - a[2]) / abs(a[2]) for a, b in zip(ra, rb)]
        # the validation loss after two updates: what they moved it on one
        # card, and the cards' gap as a share of that
        moved = abs(ra[3][2] - ra[0][2]) / abs(ra[0][2])
        share = abs(rb[3][2] - ra[3][2]) / max(abs(ra[3][2] - ra[0][2]),
                                                1e-30)
        note(f"  phase {phase}, the plain command on {many} (it "
             f"started its ranks) against one card, {what}: records "
             f"{[(s, sp) for s, sp, _ in rb]}, losses "
             + ", ".join(f"{s} {sp} {b:.6f}/{a[2]:.6f} ({r:.2e})"
                         for (s, sp, b), a, r in zip(rb, ra, rel))
             + f"; the validation loss moved {moved:.2e} from step 0 to 2 "
             f"on one card, the cards' gap {share:.2e} of that; "
             f"final parameters apart over their displacement: "
             f"{moved_apart(what)}")
        ok = ok and [(s, sp) for s, sp, _ in ra] == [
            (s, sp) for s, sp, _ in rb] == want_steps and rel[1] <= 1e-5
        if what == "train SGD":
            ok = ok and max(rel) <= DP_CLI_RTOL and share <= DP_CLI_SHARE
    (names_a, fa), (names_b, fb) = flows("one card"), flows(many)
    epe = [float(np.sqrt(((a - b) ** 2).sum(-1)).mean())
           for a, b in zip(fa, fb)]
    note(f"  phase {phase}, the plain command on {many}, --inference "
         f"--save_flow of the seeded weights: {len(names_b)} flows written "
         f"once, EPE against one card's at most {max(epe):.3e}; seconds "
         + ", ".join(f"{w} on {lab} {sec:.1f}"
                     for (lab, w), sec in seconds.items()) + f"  [{smi}]")
    if not (ok and names_a == names_b == [f"{i:06d}.flo"
                                          for i in range(CLI_VAL)]
            and max(epe) < 1e-4):
        raise AssertionError(f"phase {phase}: the command line on every "
                             "card differs from one card's")


def multi_card_main() -> int:
    """``python3 chip_smoke.py --data-parallel``: phase 5e(d), on every card
    the environment lists (more than one): the cards and their links, the
    build, each kernel against its plain version on every card, phase 5e's
    step gates over NCCL on 2 and on 4 cards, the plain command line
    starting its ranks, the all-reduce alone and the weak-scaling table;
    then phase 5f(d), the row bands across cards.  With ``--spatial``
    (``--data-parallel --spatial``) only the cards, the build and phase
    5f(d)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "flownet2_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"chip_smoke --data-parallel: {n_cards} card, needs more than "
              "one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from flownet2_tpu_torch.ops import _cuda

    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi_all)
    smi = smi_all.splitlines()[0]
    topo = {}
    for what, cmd in (("nvidia-smi topo -m", ["nvidia-smi", "topo", "-m"]),
                      ("nvidia-smi nvlink --status",
                       ["nvidia-smi", "nvlink", "--status", "-i", "0"])):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
        topo[what] = " ".join((proc.stdout + proc.stderr).split())[:600]
        print(f"{what} (exit {proc.returncode}):")
        print(proc.stdout + proc.stderr)
    peers = [f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
             for i in range(n_cards) for j in range(n_cards) if i != j]
    note(f"  phase 5e(d), {n_cards} cards: {'; '.join(smi_all.splitlines())}; "
         + "; ".join(f"{k}: {v}" for k, v in topo.items())
         + f"; peer access {', '.join(peers)}")
    t0 = time.perf_counter()
    _cuda.build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    spatial_only = "--spatial" in sys.argv[2:]
    print(f"phase 5e(d): data parallel on {n_cards} cards")
    for k in range(0 if spatial_only else n_cards):
        launches = kernels_on_device(torch.device("cuda", k))
        note(f"  phase 5e(d), cuda:{k}: every main-path kernel against its "
             f"plain version, f32 and bf16; launches {launches}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_5e_"))
    cli_failure = None
    try:
        for world in () if spatial_only else (2, 4):
            if world <= n_cards:
                run_task(work, f"steps{world}", world, task="steps",
                         backend="nccl", part="(d)",
                         what=f"{world} ranks over NCCL on {world} cards")
        # a failed command-line gate fails the run after the scaling table,
        # so that one run on several cards reads everything
        try:
            if not spatial_only:
                multi_card_cli(smi, n_cards, work)
        except AssertionError as e:
            cli_failure = e
        times = {}
        for world in () if spatial_only else (1, 2, 4):
            if world <= n_cards:
                out = work / f"scaling{world}.out"
                run_task(work, f"scaling{world}", world, task="scaling",
                         backend="nccl", out=str(out))
                times[world] = json.loads(out.read_text())
        for n, t in times.items():
            if n == 1:
                continue
            ms = t.pop("allreduce_ms")
            # a ring moves 2 (n - 1) / n of the bytes through each link
            bus = 2 * (n - 1) / n * 4 * FLOWNET2_PARAMS / ms / 1e6
            note(f"  phase 5e(d), all-reduce of {FLOWNET2_PARAMS} float32 "
                 f"(a step's gradients) over NCCL on {n} card(s): {ms:.3f} "
                 f"ms, bus bandwidth {bus:.1f} GB/s  [{smi}]")
        for dtype in ("float32", "bfloat16") if times else ():
            base = times[1][dtype]
            note(f"  phase 5e(d), weak scaling, FlowNet2 {dtype} train step, "
                 f"{TRAIN_BATCH} pairs a card, {TRAIN_HEIGHT}x{TRAIN_WIDTH}, "
                 "DDP over NCCL: " + "; ".join(
                     f"{n} card(s) {t[dtype]:.3f} ms/step, "
                     f"{n * TRAIN_BATCH / t[dtype] * 1e3:.2f} frames/s, "
                     f"efficiency {base / t[dtype]:.4f}"
                     for n, t in times.items()) + f"  [{smi}]")

        # phase 5f(d): row bands across cards
        print(f"phase 5f(d): row bands across {n_cards} cards")
        multi_card_bands(smi, n_cards, work)
        if n_cards >= 4:
            try:
                multi_card_cli(smi, n_cards, work, spatial=2,
                               wanted=("train SGD", "infer"))
            except AssertionError as e:
                cli_failure = cli_failure or e
            # four bands of unequal height: 128, 128, 64, 64 rows of the
            # 384-row crops and frames
            try:
                multi_card_cli(smi, n_cards, work, spatial=4,
                               wanted=("train SGD", "infer"))
            except AssertionError as e:
                cli_failure = cli_failure or e
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("summary of the timed phases:")
    for line in SUMMARY:
        print(line)
    if cli_failure is not None:
        raise cli_failure
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n_cards}}))
    return 0


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "flownet2_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from flownet2_tpu_torch import ops
    from flownet2_tpu_torch.losses import MultiScale
    from flownet2_tpu_torch.models import flownet2 as flownet2_module
    from flownet2_tpu_torch.models import get_model
    from flownet2_tpu_torch.ops import _cuda
    from flownet2_tpu_torch.ops import correlation as corr
    from flownet2_tpu_torch.ops import correlation_spatial as corr_sp
    from flownet2_tpu_torch.ops import resample2d as r2d
    from flownet2_tpu_torch.ops import sharding_hints, stage_glue, upsample
    from flownet2_tpu_torch.train import StepFactory, get_optimizer

    backward_kernels = (
        (corr, "correlation_bwd_cuda", corr.correlation_bwd_plain),
        (corr_sp, "corr_slab_bwd_cuda", corr_sp.corr_slab_bwd_plain),
        (r2d, "resample2d_grad_flow_cuda", r2d.resample2d_grad_flow_plain))
    forward_kernels = (
        (corr, "correlation_cuda", corr.correlation_plain),
        (corr_sp, "corr_slab_cuda", corr_sp.corr_slab_plain),
        (r2d, "resample2d_cuda", r2d.resample2d_plain),
        (r2d, "resample2d_multi_cuda", r2d.resample2d_multi_plain),
        (r2d, "resample2d_tangents_cuda", r2d.resample2d_tangents_plain))

    def plain_ops(wrappers=forward_kernels + backward_kernels):
        """The given CUDA wrappers (all of them by default) replaced by
        their plain versions."""
        stack = contextlib.ExitStack()
        for mod, name, plain in wrappers:
            stack.enter_context(mock.patch.object(mod, name, plain))
        return stack

    # -- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(kind)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"peaks taken for {peak_name}: {peaks[0] / 1e12:g} TB/s, "
          f"{peaks[1] / 1e12:g} TFLOP/s f32, {peaks[2] / 1e12:g} TFLOP/s "
          "bf16 tensor cores")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    # ptxas's register and spill lines, each under the kernel they belong to
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
                print(f"  {name}: {kernel}")
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    # the tensor-core bodies, each element type beside the other
    for line in tensor_core_bodies(logs):
        note(f"  {line}")

    # -- 2. kernels against their plain versions ----------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    # the row-band checks draw from a generator of their own, so that the
    # inputs of the other phases are the ones they always had
    band_gen = torch.Generator(device=dev).manual_seed(7)
    # and so do the checks at the odd-width map
    odd_gen = torch.Generator(device=dev).manual_seed(11)
    odd_shape = (2, 40, 20, 75)

    def randn(*shape, scale=1.0, gen=gen):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    corr_args = (20, 1, 20, 1, 2)
    disp = 21
    print("phase 2: kernels against their plain versions")
    errs = {}
    # no_grad, not inference_mode: the tangent route's check below builds
    # a graph from these tensors
    with torch.no_grad():
        # the main paths' shapes, the wide (384x1024 frames) one, a ragged
        # one (a partial channel chunk and a partial column tile) and an
        # odd-width one (no 16-byte alignment of the rows)
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8),
                      (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
                      (4, 256, 48, 128), (2, 40, 20, 152), odd_shape):
            shape_gen = odd_gen if shape == odd_shape else gen
            f1, f2 = (randn(*shape, gen=shape_gen) for _ in range(2))
            if shape[3] != TRAIN_WIDTH // 8:
                errs.setdefault("correlation_fwd", []).append(max_err(
                    corr.correlation_cuda(f1, f2, *corr_args),
                    corr.correlation_plain(f1, f2, *corr_args), 1e-4, 1e-4,
                    f"K1 correlation {shape}"))
            if shape[3] == WIDTH // 8:
                continue
            g = randn(shape[0], disp * disp, *shape[2:], gen=shape_gen)
            got = corr.correlation_bwd_cuda(g, f1, f2, 20, 2)
            want = corr.correlation_bwd_plain(g, f1, f2, 20, 2)
            for k, name in enumerate(("correlation_bwd_f1",
                                      "correlation_bwd_f2")):
                errs.setdefault(name, []).append(max_err(
                    got[k], want[k], 1e-4, 1e-4,
                    f"K{5 + k} correlation d_f{1 + k} {shape}"))
        # K1's, K5's and K6's general bodies: configurations the
        # register-tiled ones do not cover
        for maxd, s2 in ((8, 1), (4, 2)):
            f1, f2 = (randn(*odd_shape, gen=odd_gen) for _ in range(2))
            other_args = (maxd, 1, maxd, 1, s2)
            errs["correlation_fwd"].append(max_err(
                corr.correlation_cuda(f1, f2, *other_args),
                corr.correlation_plain(f1, f2, *other_args), 1e-4, 1e-4,
                f"K1 correlation {odd_shape}, maxd {maxd}, s2 {s2}"))
            other_disp = 2 * (maxd // s2) + 1
            g = randn(odd_shape[0], other_disp ** 2, *odd_shape[2:],
                      gen=odd_gen)
            got = corr.correlation_bwd_cuda(g, f1, f2, maxd, s2)
            want = corr.correlation_bwd_plain(g, f1, f2, maxd, s2)
            for k, name in enumerate(("correlation_bwd_f1",
                                      "correlation_bwd_f2")):
                errs[name].append(max_err(
                    got[k], want[k], 1e-4, 1e-4,
                    f"K{5 + k} correlation d_f{1 + k} {odd_shape}, maxd "
                    f"{maxd}, s2 {s2}"))
        img = randn(BATCH, 3, HEIGHT, WIDTH)
        flow8 = uniform(BATCH, 2, HEIGHT, WIDTH, scale=8.0)
        flow200 = uniform(BATCH, 2, HEIGHT, WIDTH, scale=200.0)
        for px, flow in ((8, flow8), (200, flow200)):
            errs.setdefault("resample2d_fwd", []).append(max_err(
                r2d.resample2d_cuda(img, flow), r2d.resample2d_plain(img, flow),
                1e-5, 1e-5, f"K2 warp, one flow of +-{px} px"))
        ragged_img = randn(2, 3, 100, 150)
        ragged_flow = uniform(2, 2, 100, 150, scale=8.0)
        errs["resample2d_fwd"].append(max_err(
            r2d.resample2d_cuda(ragged_img, ragged_flow),
            r2d.resample2d_plain(ragged_img, ragged_flow), 1e-5, 1e-5,
            "K2 warp, one flow, (2, 3, 100, 150)"))
        flows = torch.stack([flow8, flow200], dim=1)
        errs["resample2d_fwd_multi"] = [max_err(
            r2d.resample2d_multi_cuda(img, flows),
            r2d.resample2d_multi_plain(img, flows), 1e-5, 1e-5,
            "K2 warp, two flows")]

        t_img = randn(TRAIN_BATCH, 3, TRAIN_HEIGHT, TRAIN_WIDTH)
        t_flows = torch.stack([
            uniform(TRAIN_BATCH, 2, TRAIN_HEIGHT, TRAIN_WIDTH, scale=px)
            for px in (8.0, 200.0)], dim=1)
        cases = [(f"+-{px} px", t_img, t_flows[:, i:i + 1].contiguous())
                 for i, px in enumerate((8, 200))]
        cases += [("two flows", t_img, t_flows),
                  ("(2, 3, 100, 150)", ragged_img, ragged_flow.unsqueeze(1))]
        for what, im, fl in cases:
            nflows = fl.shape[1]
            k3 = r2d._per_flow("resample2d_tangents", nflows)
            got = r2d.resample2d_tangents_cuda(im, fl)
            want = r2d.resample2d_tangents_plain(im, fl)
            for part, a, b in zip(("out", "d1", "d2"), got, want):
                errs.setdefault(k3, []).append(max_err(
                    a, b, 1e-5, 1e-5, f"K3 warp tangents {part}, {what}"))
            g = randn(*want[0].shape)
            k4 = r2d.resample2d_grad_flow_cuda(g, im, fl)
            errs.setdefault(r2d._per_flow("resample2d_grad_flow", nflows),
                            []).append(max_err(
                k4, r2d.resample2d_grad_flow_plain(g, im, fl), 1e-5, 1e-5,
                f"K4 warp flow gradient, {what}"))
            # the tangent route's flow gradient for the same cotangent
            with torch.enable_grad():
                leaf = fl.clone().requires_grad_()
                (tangent_grad,) = torch.autograd.grad(
                    r2d.resample2d_tangents(im, leaf), leaf, g)
            max_err(k4, tangent_grad, 1e-5, 1e-5,
                    f"K4 against the tangent route's d_flow, {what}")

        # K7 on bands of the main paths', the wide and the ragged maps: one
        # band (whose d_slab rows [20, 20 + H) are K6's bits), and the top, a
        # middle and the bottom band of 2 and 4 (12 rows < maxd 20 at 4)
        slab_names = ("correlation_fwd_rows", "correlation_bwd_f1_rows",
                      "correlation_bwd_f2_rows")
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8),
                      (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
                      (4, 256, 48, 128), (2, 40, 20, 152), odd_shape):
            shape_gen = odd_gen if shape == odd_shape else band_gen
            f1, f2 = (randn(*shape, gen=shape_gen) for _ in range(2))
            g = randn(shape[0], disp * disp, *shape[2:], gen=shape_gen)
            whole = (corr.correlation_cuda(f1, f2, *corr_args),
                     *corr.correlation_bwd_cuda(g, f1, f2, 20, 2))
            f2p = F.pad(f2, (0, 0, 20, 20))
            for shards in (1, 2, 4):
                local_h = shape[2] // shards
                d_f2p = torch.zeros_like(f2p)
                for band in range(shards):
                    off = band * local_h
                    rows = slice(off, off + local_h)
                    f1_loc = f1[:, :, rows].contiguous()
                    g_loc = g[:, :, rows].contiguous()
                    slab = f2p[:, :, off:off + local_h + 40].contiguous()
                    got = (corr_sp.corr_slab_cuda(f1_loc, slab, 20, 2),
                           *corr_sp.corr_slab_bwd_cuda(g_loc, f1_loc, slab,
                                                       20, 2))
                    d_f2p[:, :, off:off + local_h + 40] += got[2]
                    for k in range(2):
                        if not torch.equal(got[k], whole[k][:, :, rows]):
                            raise AssertionError(
                                f"{slab_names[k]} {shape}, band {band} of "
                                f"{shards}: not the whole-map kernel's bits")
                    if 1 < band < shards - 1:
                        continue   # one middle band is held to the plain op
                    want = (corr_sp.corr_slab_plain(f1_loc, slab, 20, 2),
                            *corr_sp.corr_slab_bwd_plain(g_loc, f1_loc, slab,
                                                         20, 2))
                    for name, a, b in zip(slab_names, got, want):
                        errs.setdefault(name, []).append(max_err(
                            a, b, 1e-5, 1e-5, f"K7 {name} {shape}, band "
                            f"{band} of {shards}"))
                if shards == 1:
                    if not torch.equal(d_f2p[:, :, 20:-20], whole[2]):
                        raise AssertionError(
                            f"{slab_names[2]} {shape}, one band: rows "
                            "[20, 20 + H) not the whole-map kernel's bits")
                    continue
                max_err(d_f2p[:, :, 20:-20], whole[2], 1e-5, 1e-5,
                        f"K7 d_slab summed over {shards} bands against K6 "
                        f"{shape} (forward and d_f1 bit-equal to K1, K5)")

        # the local-rows K2, K3, K4 against the same rows of the whole image
        for what, im, fl in (
                ("K2 shape, one flow of +-8 px", img, flow8.unsqueeze(1)),
                ("K2 shape, one flow of +-200 px", img, flow200.unsqueeze(1)),
                ("K2 shape, two flows", img, flows),
                ("K3/K4 shape, one flow of +-200 px", t_img,
                 t_flows[:, 1:].contiguous()),
                ("K3/K4 shape, two flows", t_img, t_flows)):
            g = randn(fl.shape[0], fl.shape[1], 3, *fl.shape[3:], gen=band_gen)
            whole = (r2d.resample2d_multi_cuda(im, fl),
                     *r2d.resample2d_tangents_cuda(im, fl),
                     r2d.resample2d_grad_flow_cuda(g, im, fl))
            for shards in (2, 4):
                local_h = im.shape[2] // shards
                for off in range(0, im.shape[2], local_h):
                    rows = slice(off, off + local_h)
                    fl_loc = fl[:, :, :, rows].contiguous()
                    got = (r2d.resample2d_multi_cuda(im, fl_loc, off),
                           *r2d.resample2d_tangents_cuda(im, fl_loc, off),
                           r2d.resample2d_grad_flow_cuda(
                               g[:, :, :, rows].contiguous(), im, fl_loc, off))
                    for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2",
                                           "K4"), got, whole):
                        if not torch.equal(a, b[:, :, :, rows]):
                            raise AssertionError(
                                f"{part} local rows [{off}, {off + local_h})"
                                f", {what}: not the whole-image kernel's "
                                "bits")
            print(f"  K2, K3, K4 on the bands of 2 and of 4, {what}: bit-equal "
                  "to the whole-image kernels' rows")

        # the bf16 forms of K1 and K2 against their plain versions (which
        # upcast, compute in f32 and round once), on inputs of their own
        # generator: the other phases' inputs stay the ones they had
        print("  bf16 kernels against their plain versions, one bf16 ulp")
        bf16_gen = torch.Generator(device=dev).manual_seed(13)
        # K1 bf16's tensor-core body at maxd 20, s2 2: C = 40 is no multiple
        # of its 16-channel k-steps, W = 152 none of its 64-column tiles
        # (16-byte copies) and 75 odd (2-byte copies), and maps of 3 and 5
        # rows end inside a block's rows; the general body at two other
        # configurations
        fwd16_cases = [(shape, 20, 2) for shape in (
            (BATCH, 256, HEIGHT // 8, WIDTH // 8), (4, 256, 48, 128),
            (2, 40, 20, 152), odd_shape, (2, 40, 3, 64), (2, 40, 5, 75))]
        fwd16_cases += [(odd_shape, 8, 1), (odd_shape, 4, 2)]
        for shape, maxd, s2 in fwd16_cases:
            f1, f2 = (randn(*shape, gen=bf16_gen).bfloat16() for _ in range(2))
            args = (maxd, 1, maxd, 1, s2)
            errs.setdefault("correlation_fwd_bf16", []).append(ulp_err(
                corr.correlation_cuda(f1, f2, *args),
                corr.correlation_plain(f1, f2, *args),
                f"K1 bf16 correlation {shape}, maxd {maxd}, s2 {s2}"))
        img16, ragged16 = img.bfloat16(), ragged_img.bfloat16()
        for what, im, fl in (("one flow of +-8 px", img16, flow8),
                             ("one flow of +-200 px", img16, flow200),
                             ("one flow, (2, 3, 100, 150)", ragged16,
                              ragged_flow)):
            fl = fl.bfloat16()
            errs.setdefault("resample2d_fwd_bf16", []).append(ulp_err(
                r2d.resample2d_cuda(im, fl), r2d.resample2d_plain(im, fl),
                f"K2 bf16 warp, {what}"))
        ragged_flows = torch.stack(
            [ragged_flow, randn(2, 2, 100, 150, gen=bf16_gen) * 200.0], dim=1)
        for what, im, fl in (("two flows", img16, flows),
                             ("two flows, (2, 3, 100, 150)", ragged16,
                              ragged_flows)):
            fl = fl.bfloat16()
            errs.setdefault("resample2d_fwd_multi_bf16", []).append(ulp_err(
                r2d.resample2d_multi_cuda(im, fl),
                r2d.resample2d_multi_plain(im, fl), f"K2 bf16 warp, {what}"))

        # the bf16 forms of K5 and K6 (their tensor-core bodies at maxd 20,
        # s2 2) at the training, the main-path, the wide and the two ragged
        # maps, at W = 150 (even, no multiple of 8: 4-byte copies) and at
        # maps of 3 and 5 rows, which end inside a block's rows (W = 75
        # odd: 2-byte copies), and at the two other configurations (the
        # general bodies)
        bwd_cases = [(shape, 20, 2) for shape in (
            (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
            (BATCH, 256, HEIGHT // 8, WIDTH // 8), (4, 256, 48, 128),
            (2, 40, 20, 152), odd_shape, (2, 40, 20, 150), (2, 40, 3, 64),
            (2, 40, 5, 75))]
        bwd_cases += [(odd_shape, 8, 1), (odd_shape, 4, 2)]
        bwd_flips = ([], [])
        for shape, maxd, s2 in bwd_cases:
            f1, f2 = (randn(*shape, gen=bf16_gen).bfloat16() for _ in range(2))
            g = randn(shape[0], (2 * (maxd // s2) + 1) ** 2, *shape[2:],
                      gen=bf16_gen).bfloat16()
            got = corr.correlation_bwd_cuda(g, f1, f2, maxd, s2)
            want = corr.correlation_bwd_plain(g, f1, f2, maxd, s2)
            for k, name in enumerate(("correlation_bwd_f1_bf16",
                                      "correlation_bwd_f2_bf16")):
                errs.setdefault(name, []).append(ulp_err(
                    got[k], want[k], f"K{5 + k} bf16 correlation d_f{1 + k} "
                    f"{shape}, maxd {maxd}, s2 {s2}"))
            if maxd == 20:
                for k in range(2):
                    bwd_flips[k].append(
                        (got[k] != want[k]).float().mean().item())
        for k, flips in enumerate(bwd_flips):
            note(f"  K{5 + k} bf16 (tensor-core body) against its plain "
                 f"version: {min(flips):.4%} to {max(flips):.4%} of the "
                 f"values not bit-equal over the {len(flips)} maxd 20 maps")
        # the bf16 forms of K3 and K4 on phase 2's K3/K4 cases: out and the
        # flow gradient at one ulp, K3's float32 d1 and d2 at 1e-5, and K4
        # against the tangent route's bf16 flow gradient
        t_img16 = t_img.bfloat16()
        for what, im, fl in cases:
            im, fl = im.bfloat16(), fl.bfloat16()
            nflows = fl.shape[1]
            k3 = r2d._per_flow("resample2d_tangents", nflows) + "_bf16"
            got = r2d.resample2d_tangents_cuda(im, fl)
            want = r2d.resample2d_tangents_plain(im, fl)
            errs.setdefault(k3, []).append(ulp_err(
                got[0], want[0], f"K3 bf16 warp tangents out, {what}"))
            for part, a, b in zip(("d1", "d2"), got[1:], want[1:]):
                if a.dtype != torch.float32:
                    raise AssertionError(f"K3 bf16 {part}: {a.dtype}")
                errs[k3].append(max_err(a, b, 1e-5, 1e-5,
                                        f"K3 bf16 warp tangents {part} "
                                        f"(float32), {what}"))
            g = randn(*want[0].shape, gen=bf16_gen).bfloat16()
            k4 = r2d.resample2d_grad_flow_cuda(g, im, fl)
            errs.setdefault(r2d._per_flow("resample2d_grad_flow", nflows)
                            + "_bf16", []).append(ulp_err(
                k4, r2d.resample2d_grad_flow_plain(g, im, fl),
                f"K4 bf16 warp flow gradient, {what}"))
            with torch.enable_grad():
                leaf = fl.clone().requires_grad_()
                (tangent_grad,) = torch.autograd.grad(
                    r2d.resample2d_tangents(im, leaf), leaf, g)
            ulp_err(k4, tangent_grad, f"K4 bf16 against the tangent route's "
                    f"bf16 d_flow, {what}")

        # the bf16 row bands: K7 bf16 (the forward, d_f1 and d_slab on K1's,
        # K5's and K6's bf16 tensor-core bodies) on the bands of the main
        # paths', the wide and the ragged maps, as the f32 K7 above, and of
        # a 5-row map, whose bands of 4 are one row each, so that 40 of the
        # 41 rows of each slab are halo: every band's forward and d_f1 the
        # same rows of K1 bf16 and K5 bf16 bit for bit, one band's d_slab
        # rows [20, 20 + H) K6 bf16's, and the top, a middle and the bottom
        # band at one ulp of the plain version (the d_f1 bands' flip rates
        # noted)
        rows16_names = tuple(n + "_bf16" for n in slab_names)
        d_f1_flips = []
        for shape in ((BATCH, 256, HEIGHT // 8, WIDTH // 8),
                      (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8),
                      (4, 256, 48, 128), (2, 40, 20, 152), odd_shape,
                      (2, 40, 5, 64)):
            f1, f2 = (randn(*shape, gen=bf16_gen).bfloat16() for _ in range(2))
            g = randn(shape[0], disp * disp, *shape[2:],
                      gen=bf16_gen).bfloat16()
            whole = (corr.correlation_cuda(f1, f2, *corr_args),
                     *corr.correlation_bwd_cuda(g, f1, f2, 20, 2))
            f2p = F.pad(f2, (0, 0, 20, 20))
            for shards in (1, 2, 4):
                local_h = shape[2] // shards
                for band in range(shards):
                    off = band * local_h
                    rows = slice(off, off + local_h)
                    f1_loc = f1[:, :, rows].contiguous()
                    g_loc = g[:, :, rows].contiguous()
                    slab = f2p[:, :, off:off + local_h + 40].contiguous()
                    got = (corr_sp.corr_slab_cuda(f1_loc, slab, 20, 2),
                           *corr_sp.corr_slab_bwd_cuda(g_loc, f1_loc, slab,
                                                       20, 2))
                    for k in range(2):
                        if not torch.equal(got[k], whole[k][:, :, rows]):
                            raise AssertionError(
                                f"{rows16_names[k]} {shape}, band {band} of "
                                f"{shards}: not the whole-map bf16 kernel's "
                                "bits")
                    if shards == 1 and not torch.equal(got[2][:, :, 20:-20],
                                                       whole[2]):
                        raise AssertionError(
                            f"{rows16_names[2]} {shape}, one band: rows "
                            "[20, 20 + H) not K6 bf16's bits")
                    if 1 < band < shards - 1:
                        continue   # one middle band is held to the plain op
                    want = (corr_sp.corr_slab_plain(f1_loc, slab, 20, 2),
                            *corr_sp.corr_slab_bwd_plain(g_loc, f1_loc, slab,
                                                         20, 2))
                    for name, a, b in zip(rows16_names, got, want):
                        errs.setdefault(name, []).append(ulp_err(
                            a, b, f"K7 bf16 {name} {shape}, band {band} of "
                            f"{shards}"))
                    d_f1_flips.append(
                        (got[1] != want[1]).float().mean().item())
            print(f"  K7 bf16 {shape}: one band bit-equal to K1, K5, K6 bf16; "
                  "the bands of 2 and of 4 bit-equal to K1, K5 bf16's rows")
        note(f"  K7 bf16 d_f1 (K5's tensor-core body) against its plain "
             f"version: {min(d_f1_flips):.4%} to {max(d_f1_flips):.4%} of the "
             f"values not bit-equal over {len(d_f1_flips)} bands")

        # the bf16 local-rows K2, K3, K4 against the same rows of the
        # whole-image bf16 kernels, at +-8 px and +-200 px, one and two
        # flows, on the bands of 2 and of 4: the second band of two of a
        # 384-row image starts at row 192, where a bf16 ulp is 1 px, so a
        # port that added the offset to the bf16 flow would fail here
        for what, im, fl in (
                ("K2 shape, one flow of +-8 px", img16, flow8.unsqueeze(1)),
                ("K2 shape, one flow of +-200 px", img16,
                 flow200.unsqueeze(1)),
                ("K2 shape, two flows", img16, flows),
                ("K3/K4 shape, one flow of +-8 px", t_img16,
                 t_flows[:, :1].contiguous()),
                ("K3/K4 shape, one flow of +-200 px", t_img16,
                 t_flows[:, 1:].contiguous()),
                ("K3/K4 shape, two flows", t_img16, t_flows)):
            fl = fl.bfloat16()
            g = randn(fl.shape[0], fl.shape[1], 3, *fl.shape[3:],
                      gen=bf16_gen).bfloat16()
            whole = (r2d.resample2d_multi_cuda(im, fl),
                     *r2d.resample2d_tangents_cuda(im, fl),
                     r2d.resample2d_grad_flow_cuda(g, im, fl))
            for shards in (2, 4):
                local_h = im.shape[2] // shards
                for off in range(0, im.shape[2], local_h):
                    rows = slice(off, off + local_h)
                    fl_loc = fl[:, :, :, rows].contiguous()
                    got = (r2d.resample2d_multi_cuda(im, fl_loc, off),
                           *r2d.resample2d_tangents_cuda(im, fl_loc, off),
                           r2d.resample2d_grad_flow_cuda(
                               g[:, :, :, rows].contiguous(), im, fl_loc, off))
                    for part, a, b in zip(("K2", "K3 out", "K3 d1", "K3 d2",
                                           "K4"), got, whole):
                        if a.dtype != b.dtype or not torch.equal(
                                a, b[:, :, :, rows]):
                            raise AssertionError(
                                f"{part} bf16 local rows [{off}, "
                                f"{off + local_h}), {what}: not the "
                                "whole-image bf16 kernel's bits")
            print(f"  K2, K3, K4 bf16 on the bands of 2 and of 4, {what}: "
                  "bit-equal to the whole-image bf16 kernels' rows")

        # the row tiles of K2 and K4 (one and two flows, f32 and bf16) at
        # the smooth flow the stage glue makes (+-8 px at (H/4, W/4),
        # bilinear x4), and in one launch whose blocks take both routes:
        # half the batch at +-8 px (the window in shared memory), half at
        # +-200 px (the image in global memory); inputs of their own
        # generator
        tile_gen = torch.Generator(device=dev).manual_seed(17)

        def tile_uniform(*shape, scale):
            return (torch.rand(shape, generator=tile_gen, device=dev) * 2
                    - 1) * scale

        def smooth_flows(b, nflows, h, w):
            coarse = tile_uniform(b * nflows, 2, h // 4, w // 4, scale=8.0)
            return upsample.upsample_bilinear(coarse).reshape(
                b, nflows, 2, h, w)

        half = BATCH // 2
        tile_cases = []
        for nflows in (1, 2):
            for h, w in ((HEIGHT, WIDTH), (TRAIN_HEIGHT, TRAIN_WIDTH)):
                tile_cases.append((f"smooth flow, {nflows} flow(s), {h}x{w}",
                                   smooth_flows(BATCH, nflows, h, w)))
            tile_cases.append((
                f"both routes in one launch, {nflows} flow(s)",
                torch.cat([tile_uniform(half, nflows, 2, HEIGHT, WIDTH,
                                        scale=8.0),
                           tile_uniform(BATCH - half, nflows, 2, HEIGHT,
                                        WIDTH, scale=200.0)])))
        for what, fl in tile_cases:
            im = randn(BATCH, 3, *fl.shape[3:], gen=tile_gen)
            g = randn(*fl.shape[:2], 3, *fl.shape[3:], gen=tile_gen)
            nflows = fl.shape[1]
            k2 = r2d._per_flow("resample2d_fwd", nflows)
            k4 = r2d._per_flow("resample2d_grad_flow", nflows)
            k3 = r2d._per_flow("resample2d_tangents", nflows)
            # K3 (f32, then bf16: out at one ulp, d1 and d2 at 1e-5)
            for dtype in (torch.float32, torch.bfloat16):
                got = r2d.resample2d_tangents_cuda(im.to(dtype), fl.to(dtype))
                want = r2d.resample2d_tangents_plain(im.to(dtype),
                                                     fl.to(dtype))
                sfx = "_bf16" if dtype == torch.bfloat16 else ""
                for part, a, b in zip(("out", "d1", "d2"), got, want):
                    errs[k3 + sfx].append(
                        ulp_err(a, b, f"K3 bf16 warp tangents {part}, {what}")
                        if a.dtype == torch.bfloat16 else
                        max_err(a, b, 1e-5, 1e-5, f"K3{sfx.replace('_', ' ')}"
                                f" warp tangents {part}, {what}"))
            errs[k2].append(max_err(
                r2d.resample2d_multi_cuda(im, fl),
                r2d.resample2d_multi_plain(im, fl), 1e-5, 1e-5,
                f"K2 warp, {what}"))
            errs[k4].append(max_err(
                r2d.resample2d_grad_flow_cuda(g, im, fl),
                r2d.resample2d_grad_flow_plain(g, im, fl), 1e-5, 1e-5,
                f"K4 warp flow gradient, {what}"))
            im, fl, g = im.bfloat16(), fl.bfloat16(), g.bfloat16()
            errs[k2 + "_bf16"].append(ulp_err(
                r2d.resample2d_multi_cuda(im, fl),
                r2d.resample2d_multi_plain(im, fl), f"K2 bf16 warp, {what}"))
            errs[k4 + "_bf16"].append(ulp_err(
                r2d.resample2d_grad_flow_cuda(g, im, fl),
                r2d.resample2d_grad_flow_plain(g, im, fl),
                f"K4 bf16 warp flow gradient, {what}"))
        print("  K2, K3 and K4 (f32, bf16) at the smooth flow and with both "
              "routes in one launch: within the tolerances")

        # K3 and K4 (f32, bf16) at W = 136: the last column tile's first
        # thread pair of a bf16 K3 row has one thread in the map and one
        # past its end (the tangents' paired stores); inputs of their own
        # generator
        pair_gen = torch.Generator(device=dev).manual_seed(19)
        im = randn(2, 3, 100, 136, gen=pair_gen)
        fl = (torch.rand((2, 2, 2, 100, 136), generator=pair_gen,
                         device=dev) * 2 - 1) * 8.0
        g = randn(2, 2, 3, 100, 136, gen=pair_gen)
        what = "two flows, (2, 3, 100, 136)"
        for dtype in (torch.float32, torch.bfloat16):
            sfx = "_bf16" if dtype == torch.bfloat16 else ""
            im_d, fl_d, g_d = im.to(dtype), fl.to(dtype), g.to(dtype)
            got = r2d.resample2d_tangents_cuda(im_d, fl_d)
            want = r2d.resample2d_tangents_plain(im_d, fl_d)
            for part, a, b in zip(("out", "d1", "d2"), got, want):
                errs["resample2d_tangents_multi" + sfx].append(
                    ulp_err(a, b, f"K3 bf16 warp tangents {part}, {what}")
                    if a.dtype == torch.bfloat16 else
                    max_err(a, b, 1e-5, 1e-5, f"K3{sfx.replace('_', ' ')} "
                            f"warp tangents {part}, {what}"))
            k4 = r2d.resample2d_grad_flow_cuda(g_d, im_d, fl_d)
            k4_plain = r2d.resample2d_grad_flow_plain(g_d, im_d, fl_d)
            errs["resample2d_grad_flow_multi" + sfx].append(
                ulp_err(k4, k4_plain, f"K4 bf16 warp flow gradient, {what}")
                if sfx else max_err(k4, k4_plain, 1e-5, 1e-5,
                                    f"K4 warp flow gradient, {what}"))

        # F4: the warp's image gradient (plain PyTorch, a fixed-order sum)
        # at K2's shape, +-8 and +-200 px, one and two flows: two calls
        # bit-equal, and within 1e-5 of a float64 sum (of its largest
        # magnitude); its time printed, not gated; inputs of their own
        # generator
        dimg_gen = torch.Generator(device=dev).manual_seed(23)
        dimg_img = randn(BATCH, 3, HEIGHT, WIDTH, gen=dimg_gen)
        for px in (8, 200):
            for nflows in (1, 2):
                dimg_flows = (torch.rand(
                    (BATCH, nflows, 2, HEIGHT, WIDTH), generator=dimg_gen,
                    device=dev) * 2 - 1) * px
                dimg_g = randn(BATCH, nflows, 3, HEIGHT, WIDTH, gen=dimg_gen)
                first = r2d._d_img(dimg_g, dimg_img, dimg_flows)
                second = r2d._d_img(dimg_g, dimg_img, dimg_flows)
                ref = d_img_float64(r2d, dimg_g, dimg_img, dimg_flows)
                err = (first.double() - ref).abs().max().item()
                top = ref.abs().max().item()
                dimg_ms = time_ms(
                    lambda: r2d._d_img(dimg_g, dimg_img, dimg_flows), 3,
                    warmup=1)
                same = torch.equal(first, second)
                print(f"  F4 warp image gradient, {nflows} flow(s) of +-{px} "
                      f"px: two calls bit-equal {same}; max abs diff "
                      f"{err:.3e} from a float64 sum (|max| {top:.3f}; "
                      f"limit 1e-5 of it); {dimg_ms:.3f} ms  [{smi}]")
                if not same or first.dtype != torch.float32 \
                        or err > 1e-5 * top:
                    raise AssertionError(f"F4 warp image gradient, {nflows} "
                                         f"flow(s) of +-{px} px: not a "
                                         "fixed sum of the taps")
        del dimg_img, dimg_flows, dimg_g, first, second, ref

        # the fp16 forms of every kernel, on inputs of their own generator
        fp16_kernels(dev, errs)
        # the configurations no model uses, and the op surface's launches
        cfg_launches = cfg_kernels(dev, errs)

    # -- 3. FlowNet2 inference ----------------------------------------------
    print(f"phase 3: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} fp32, TF32 off")
    model = get_model("FlowNet2", device=DEVICE, seed=0)
    pairs = [torch.rand((BATCH, 2, HEIGHT, WIDTH, 3), generator=gen,
                        device=dev) * 255.0 for _ in range(2)]
    with torch.inference_mode():
        for pair in pairs:
            model(pair)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_counts()
        start.record()
        for i in range(TIMED_BATCHES):
            flow = model(pairs[i % 2])
        end.record()
        torch.cuda.synchronize()
        launches, plain_calls = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        ms = start.elapsed_time(end) / TIMED_BATCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"correlation_fwd": TIMED_BATCHES,
                "resample2d_fwd": 2 * TIMED_BATCHES,
                "resample2d_fwd_multi": TIMED_BATCHES}
        print(f"  launches over {TIMED_BATCHES} forwards: {launches}; "
              f"plain-op calls: {plain_calls}")
        if launches != want or plain_calls:
            raise AssertionError(f"main path launches {launches} / plain "
                                 f"calls {plain_calls}; expected {want} / {{}}")
        if flow.shape != (BATCH, HEIGHT, WIDTH, 2) \
                or not torch.isfinite(flow).all():
            raise AssertionError(f"bad flow: {tuple(flow.shape)}, finite="
                                 f"{torch.isfinite(flow).all().item()}")
        note(f"  phase 3, fp32 inference: {ms:.3f} ms/batch, "
             f"{BATCH / ms * 1e3:.2f} frames/s, peak {peak_gib:.2f} GiB "
             f"allocated  [{smi}]")

        flow = model(pairs[0])
        with plain_ops():
            flow_plain = model(pairs[0])
            plain_model_ms = time_ms(lambda: model(pairs[0]), 3, warmup=0)
        err = (flow - flow_plain).abs().max().item()
        print(f"  against the plain-op model on the card: max abs diff "
              f"{err:.3e}, |flow| max {flow.abs().max().item():.3f}; "
              f"plain-op model {plain_model_ms:.3f} ms/batch")
        if not torch.allclose(flow, flow_plain, rtol=1e-3, atol=1e-3):
            raise AssertionError("kernel model disagrees with plain-op model")

        small = pairs[0][:1, :, :64, :128].contiguous()
        on_card = model(small).cpu()
        on_cpu = get_model("FlowNet2", device="cpu", seed=0)(small.cpu())
        err_cpu = (on_card - on_cpu).abs().max().item()
        print(f"  small pair against the model on the CPU: max abs diff "
              f"{err_cpu:.3e}")
        if not torch.allclose(on_card, on_cpu, rtol=1e-3, atol=1e-3):
            raise AssertionError("card and CPU disagree on the small pair")

    # -- 3b. FlowNet2 bf16 inference ------------------------------------------
    print(f"phase 3b: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} bf16 (float32 "
          "parameters, bf16 convolutions, glue and warps)")
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)
    with torch.inference_mode():
        for pair in pairs:
            model16(pair)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_counts()
        start.record()
        for i in range(TIMED_BATCHES):
            flow16 = model16(pairs[i % 2])
        end.record()
        torch.cuda.synchronize()
        launches16, plain16 = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        ms16 = start.elapsed_time(end) / TIMED_BATCHES
        peak16_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"correlation_fwd_bf16": TIMED_BATCHES,
                "resample2d_fwd_bf16": 2 * TIMED_BATCHES,
                "resample2d_fwd_multi_bf16": TIMED_BATCHES}
        print(f"  launches over {TIMED_BATCHES} forwards: {launches16}; "
              f"plain-op calls: {plain16}")
        if launches16 != want or plain16:
            raise AssertionError(f"bf16 path launches {launches16} / plain "
                                 f"calls {plain16}; expected {want} / {{}}")
        if flow16.shape != (BATCH, HEIGHT, WIDTH, 2) \
                or flow16.dtype != torch.bfloat16 \
                or not torch.isfinite(flow16).all():
            raise AssertionError(f"bad bf16 flow: {tuple(flow16.shape)} "
                                 f"{flow16.dtype}, finite="
                                 f"{torch.isfinite(flow16).all().item()}")
        note(f"  phase 3b, bf16 inference: {ms16:.3f} ms/batch, "
             f"{BATCH / ms16 * 1e3:.2f} frames/s, peak {peak16_gib:.2f} GiB "
             f"allocated; launches over {TIMED_BATCHES} forwards "
             f"{launches16}  [{smi}]")

        # how far the host holds the card back: the host's time to enqueue
        # a forward against the card's time for one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_BATCHES):
            model16(pairs[i % 2])
        host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_BATCHES
        torch.cuda.synchronize()
        note(f"  the host enqueues a bf16 forward in {host_ms:.3f} ms, the "
             f"card runs one in {ms16:.3f} ms (CUDA events above)")

        flow16 = model16(pairs[0])
        with plain_ops():
            bf16_contract(flow16, model16(pairs[0]),
                          "against the plain-op bf16 model on the card")
        def rel_l2(a, b):
            return ((a - b).float().norm() / b.float().norm()).item()

        # what of that is the kernels' and what cuDNN's: the model against
        # itself with cuDNN's default algorithms, and the two with
        # deterministic ones
        again = model16(pairs[0])
        print(f"  the bf16 model against itself, cuDNN's defaults: relative "
              f"L2 {rel_l2(again, flow16):.3e}")
        torch.backends.cudnn.deterministic = True
        again = model16(pairs[0])
        with plain_ops():
            plain_again = model16(pairs[0])
        torch.backends.cudnn.deterministic = False
        print(f"  against the plain-op bf16 model, cuDNN deterministic: "
              f"relative L2 {rel_l2(again, plain_again):.3e}, not bit-equal "
              f"{(again != plain_again).float().mean().item():.4%}")
        del again, plain_again
        bf16_contract(flow16, model(pairs[0]),
                      "against the fp32 model of the same weights")
        small16 = model16(small)
        bf16_contract(small16, get_model(
            "FlowNet2", device="cpu", seed=0, dtype=torch.bfloat16)(
                small.cpu()), "small pair against the bf16 model on the CPU")
        # the bf16 model under the row bands (K7 bf16 and the bf16
        # local-rows warps) against the whole map, cuDNN deterministic: the
        # same bodies in the same order, the offsets joined first
        torch.backends.cudnn.deterministic = True
        flow_whole16 = model16(pairs[0])
        with sharding_hints.scoped_spatial_shards(SHARDS):
            flow_bands16 = model16(pairs[0])
        torch.backends.cudnn.deterministic = False
        note(f"  bf16 model under {SHARDS} row bands against the whole map, "
             "cuDNN deterministic: bit-equal "
             f"{torch.equal(flow_bands16, flow_whole16)}, not bit-equal "
             f"{(flow_bands16 != flow_whole16).float().mean().item():.4%}")
        bf16_contract(flow_bands16, flow_whole16, f"bf16 model under {SHARDS} "
                      "row bands against the whole map")
        del flow16, small16, flow_whole16, flow_bands16
    # phase 4 runs as it did before phase 3b: no second model beside it
    del model16
    torch.cuda.empty_cache()

    # -- 3c. FlowNet2 fp16 inference; 3d. BatchNorm in bf16 and fp16 ----------
    fp16_run = fp16_inference_phase(smi, model, pairs, small, plain_ops)
    note(f"  phase 3c beside 3b, one call: fp16 {fp16_run['ms']:.3f} "
         f"ms/batch [bf16 {ms16:.3f}], the host enqueues a forward in "
         f"{fp16_run['host_ms']:.3f} ms [bf16 {host_ms:.3f}]  [{smi}]")
    batchnorm_phase(smi)

    # -- 4. FlowNet2 training -------------------------------------------------
    print(f"phase 4: FlowNet2 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
          f"{TRAIN_WIDTH} fp32, TF32 off, MultiScale, Adam 1e-4")
    tmodel = get_model("FlowNet2", device=DEVICE, seed=0)
    images = torch.rand((TRAIN_BATCH, 2, TRAIN_HEIGHT, TRAIN_WIDTH, 3),
                        generator=gen, device=dev) * 255.0
    target = torch.rand((TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 2),
                        generator=gen, device=dev) * 5.0
    loss_fn = MultiScale()

    def loss_and_grads(net, imgs, tgt):
        net.train()
        net.zero_grad(set_to_none=True)
        lossvalue, epevalue = loss_fn(net(imgs), tgt)
        lossvalue.backward()
        grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return lossvalue.item(), epevalue.item(), grads

    # The gradient is discontinuous in the forward's values (floor() in
    # the warps, the LeakyReLU kinks), so two forwards that differ in the
    # last bit give gradients that differ well beyond rounding.  The checks
    # are therefore: with the forward shared, the backward kernels against
    # the plain backward, per tensor; both warp routes against each other,
    # per tensor (their forwards are the same arithmetic); the plain-op
    # model in relative L2 over all gradients, its per-tensor spread printed
    # beside the kernel model's own spread from run to run.  cuDNN is made
    # deterministic for the comparisons, so that only the ops differ.
    torch.backends.cudnn.deterministic = True
    loss_k, epe_k, grads_k = loss_and_grads(tmodel, images, target)
    print(f"  first step: loss {loss_k:.6f}, EPE {epe_k:.6f}")
    for route in ROUTES:
        with mock.patch.object(stage_glue, "TRAIN_WARP", route):
            grads_r = (grads_k if route == stage_glue.TRAIN_WARP else
                       loss_and_grads(tmodel, images, target)[2])
            with plain_ops(backward_kernels):
                ops.reset_counts()
                grads_b = loss_and_grads(tmodel, images, target)[2]
                if any(k in ops.LAUNCHES for k in (
                        "correlation_bwd_f1", "correlation_bwd_f2",
                        "resample2d_grad_flow", "resample2d_grad_flow_multi")):
                    raise AssertionError(f"plain backward launched "
                                         f"{dict(ops.LAUNCHES)}")
            grads_close(grads_r, grads_b, 1e-3, f"{route} route, backward "
                        "kernels against the plain backward")
        if route != stage_glue.TRAIN_WARP:
            grads_close(grads_r, grads_k, 1e-3, f"{route} route against the "
                        f"{stage_glue.TRAIN_WARP} route")
    del grads_r, grads_b
    with plain_ops():
        ops.reset_counts()
        loss_p, epe_p, grads_p = loss_and_grads(tmodel, images, target)
        if sum(ops.LAUNCHES.values()):
            raise AssertionError(f"plain-op step launched {ops.LAUNCHES}")
    print(f"  plain-op model: loss {loss_p:.6f}, EPE {epe_p:.6f}")
    for a, b, what in ((loss_k, loss_p, "loss"), (epe_k, epe_p, "EPE")):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{what}: kernels {a} vs plain ops {b}")
    grads_close(grads_k, grads_p, 1e-3, "against the plain-op model",
                per_tensor=False)
    del grads_p
    torch.backends.cudnn.deterministic = False
    grads_1 = loss_and_grads(tmodel, images, target)[2]
    worst, name, rel = grad_errors(loss_and_grads(tmodel, images, target)[2],
                                   grads_1)
    print(f"  the kernel model against itself, cuDNN not deterministic: "
          f"worst tensor {worst:.3e} of its max |g| ({name}), {rel:.3e} in "
          f"relative L2")
    del grads_1

    small_img = images[:1, :, :64, :128].contiguous()
    small_tgt = target[:1, :64, :128].contiguous()
    cpu_model = get_model("FlowNet2", device="cpu", seed=0)
    loss_s, epe_s, grads_s = loss_and_grads(tmodel, small_img, small_tgt)
    loss_c, epe_c, grads_c = loss_and_grads(cpu_model, small_img.cpu(),
                                            small_tgt.cpu())
    print(f"  small step: loss {loss_s:.6f} / EPE {epe_s:.6f} on the card, "
          f"{loss_c:.6f} / {epe_c:.6f} on the CPU")
    for a, b, what in ((loss_s, loss_c, "small loss"),
                       (epe_s, epe_c, "small EPE")):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"{what}: card {a} vs CPU {b}")
    # in relative L2, as against the plain-op model: the card's and the
    # CPU's forwards differ in the last bit too, and a per-tensor reading
    # swings from 3e-4 to 2e-2 with the random batch
    grads_close(grads_s, grads_c, 1e-3, "small step against the CPU",
                per_tensor=False)
    # the gate holds on this draw; on other draws it has read over 1e-3,
    # with torch's upsample as with the port's (ROADMAP.md, section 3), so
    # three more are read and printed, not gated
    def subnet(grads, net="flownetc"):
        return {n: g for n, g in grads.items() if n.startswith(net + ".")}

    def across_reading(what, imgs, tgt, g_card, g_cpu):
        """Whether FlowNetC's gap to the CPU is the noise line: on the card,
        the sample point x + dx of FlowNetC's warp (the first stage glue's)
        nearest to an integer column is moved across it, dx by as few ulps
        as it takes, and FlowNetC's gradients are read again.  Printed: how
        far the move carries them (against the 1e-3 gate) beside their gap
        to the CPU.  Not gated."""
        import numpy as np

        warp = stage_glue._warp
        taken = []

        def first_warp(move):
            def run(x2, flows):
                if not taken:
                    taken.append(flows.detach().clone())
                    flows = move(flows)
                return warp(x2, flows)
            return run

        with mock.patch.object(stage_glue, "_warp", first_warp(lambda f: f)):
            before = subnet(loss_and_grads(tmodel, imgs, tgt)[2])
        dx = taken[0][0, 0, 0].cpu().numpy()
        sample = np.arange(dx.shape[1], dtype=np.float32) + dx
        y, x = np.unravel_index(
            np.argmin(np.abs(sample - np.round(sample))), sample.shape)
        edge = np.round(sample[y, x])
        side = sample[y, x] >= edge
        moved, ulps = dx[y, x], 0
        while (np.float32(x) + moved >= edge) == side:
            moved = np.nextafter(moved,
                                 np.float32(-np.inf if side else np.inf))
            ulps += 1

        def across(flows):
            flows = flows.clone()
            flows[0, 0, 0, y, x] = float(moved)
            return flows

        taken.clear()
        with mock.patch.object(stage_glue, "_warp", first_warp(across)):
            after = subnet(loss_and_grads(tmodel, imgs, tgt)[2])
        jump = grad_errors(after, before)[2]
        gap = grad_errors(g_card, g_cpu)[2]
        note(f"  phase 4, {what}: FlowNetC's gap to the CPU {gap:.3e}; its "
             f"warp's sample point at (row {y}, column {x}) moved across "
             f"column {edge:g} ({ulps} ulp of dx) moves its gradients by "
             f"{jump:.3e} in relative L2: "
             + ("more" if jump > 1e-3 else "less") + " than the 1e-3 gate")

    across_reading("the gated draw", small_img, small_tgt, subnet(grads_s),
               subnet(grads_c))
    draw_gen = torch.Generator(device=dev)
    for draw_seed in (1, 2, 3):
        draw_gen.manual_seed(draw_seed)
        draw_img = torch.rand((1, 2, 64, 128, 3), generator=draw_gen,
                              device=dev) * 255.0
        draw_tgt = torch.rand((1, 64, 128, 2), generator=draw_gen,
                              device=dev) * 5.0
        g_card = loss_and_grads(tmodel, draw_img, draw_tgt)[2]
        g_cpu = loss_and_grads(cpu_model, draw_img.cpu(),
                               draw_tgt.cpu())[2]
        by_net = {net: grad_errors(subnet(g_card, net),
                                   subnet(g_cpu, net))[2]
                  for net in ("flownetc", "flownets_1")}
        all_rel = grad_errors(g_card, g_cpu)[2]
        note(f"  phase 4, small step against the CPU, draw of seed "
             f"{draw_seed} (not gated): all gradients {all_rel:.3e} in "
             f"relative L2, flownetc {by_net['flownetc']:.3e}, "
             f"flownets_1 {by_net['flownets_1']:.3e}")
        across_reading(f"draw of seed {draw_seed}", draw_img, draw_tgt,
                   subnet(g_card), subnet(g_cpu))
    del grads_k, grads_s, grads_c, cpu_model, g_card, g_cpu, draw_img, \
        draw_tgt

    # F3: torch's bilinear upsample backward accumulates with atomic adds on
    # the card, so two backward passes over one forward gave flownetc's and
    # flownets_1's gradients other bits; the port's upsample has a fixed
    # backward (ops/upsample.py).  The capture of torch's alerts is tried on
    # an op that it names (torch.histc of floats), so that "names no op"
    # below cannot pass for a capture that sees nothing.
    histc_gen = torch.Generator(device=dev).manual_seed(23)
    histc_named = nondeterministic_ops(lambda: torch.histc(
        torch.rand(1000, generator=histc_gen, device=dev)))
    print(f"  the capture of torch's alerts names {histc_named} for "
          "torch.histc")
    if "_histc_cuda" not in histc_named:
        raise AssertionError("the capture of torch's nondeterminism alerts "
                             f"did not name torch.histc's op: {histc_named}")

    def interpolate_upsample(x, scale=4):
        """torch's own bilinear upsample, forward and backward."""
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=False)

    def backward_twice(net):
        """One forward of phase 4's batch and two backward passes over it:
        the sub-nets whose gradients are not the same bits in both."""
        net.train()
        net.zero_grad(set_to_none=True)
        lossvalue = loss_fn(net(images), target)[0]
        lossvalue.backward(retain_graph=True)
        first = {n: p.grad.clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        lossvalue.backward()
        differ = sorted({n.split(".")[0] for n, p in net.named_parameters()
                         if not torch.equal(p.grad, first[n])})
        net.zero_grad(set_to_none=True)
        return differ

    def deterministic_step(net, phase: str):
        """On each warp route, with cuDNN deterministic: two backward passes
        over one shared forward give the same bits in every sub-net, and one
        step under torch.use_deterministic_algorithms names no op; printed
        beside them, the same two readings with torch's own upsample
        backward in place of the port's."""
        torch.backends.cudnn.deterministic = True
        for route in ROUTES:
            with mock.patch.object(stage_glue, "TRAIN_WARP", route):
                differ = backward_twice(net)
                ops_named = nondeterministic_ops(
                    lambda: loss_and_grads(net, images, target))
                with mock.patch.object(flownet2_module, "upsample_bilinear",
                                       interpolate_upsample):
                    torch_differ = backward_twice(net)
                    torch_named = nondeterministic_ops(
                        lambda: loss_and_grads(net, images, target))
            note(f"  phase {phase}, {route} route, cuDNN deterministic: two "
                 "backward passes over one forward differ in "
                 f"{differ or 'no sub-net'}, a step under deterministic "
                 f"algorithms names {ops_named or 'no op'}; with torch's "
                 f"upsample backward: {torch_differ or 'no sub-net'}, "
                 f"{torch_named or 'no op'}")
            if differ or ops_named:
                raise AssertionError(
                    f"phase {phase}, {route} route: the step is not "
                    f"deterministic: {differ} differ, {ops_named} named")
            if "flownetc" not in torch_differ:
                raise AssertionError(
                    f"phase {phase}, {route} route: with torch's upsample "
                    "backward two backward passes did not differ in "
                    f"flownetc ({torch_differ}): the check did not show "
                    "that it sees the atomics it checks for")
        torch.backends.cudnn.deterministic = False

    deterministic_step(tmodel, "4")

    def timed_routes(step, phase: str, suffix: str = "", shards: int = 1):
        """TRAIN_WARMUP warm-up and TRAIN_STEPS timed steps of ``step`` on
        phase 4's batch per warp route, in turns, each route's launches
        counted over its first timed block and held to the exact counts
        (kernel names ending in ``suffix``; with ``shards`` row bands each
        kernel launched once a band, the correlation's K7 forms); prints
        ms/step and frames/s.  Returns the times by route, the launches by
        route and the peak memory in GiB."""
        route_ms = {route: [] for route in ROUTES}
        route_launches = {}
        torch.cuda.reset_peak_memory_stats()
        for route in (ROUTES + ROUTES[::-1]) * ROUTE_ROUNDS:
            with mock.patch.object(stage_glue, "TRAIN_WARP", route), \
                    sharding_hints.scoped_spatial_shards(shards):
                for _ in range(TRAIN_WARMUP):
                    step(images, target)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                ops.reset_counts()
                start.record()
                metrics = [step(images, target) for _ in range(TRAIN_STEPS)]
                end.record()
                torch.cuda.synchronize()
            route_ms[route].append(start.elapsed_time(end) / TRAIN_STEPS)
            route_launches.setdefault(route, (dict(ops.LAUNCHES),
                                              dict(ops.PLAIN_CALLS)))
            losses = torch.stack([torch.stack([m["loss"], m["epe"]])
                                  for m in metrics])
            if not torch.isfinite(losses).all():
                raise AssertionError(f"{route}: non-finite loss/EPE {losses}")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        n = TRAIN_STEPS * shards
        rows = "_rows" if shards > 1 else ""
        each = {f"correlation_{k}{rows}": n
                for k in ("fwd", "bwd_f1", "bwd_f2")}
        want_launches = {
            "tangents": dict(each, resample2d_tangents=2 * n,
                             resample2d_tangents_multi=n),
            "grad_flow": dict(each, resample2d_fwd=2 * n,
                              resample2d_fwd_multi=n,
                              resample2d_grad_flow=2 * n,
                              resample2d_grad_flow_multi=n)}
        for route in ROUTES:
            got, plain = route_launches[route]
            want = {k + suffix: v for k, v in want_launches[route].items()}
            print(f"  {route} route, launches over {TRAIN_STEPS} steps: "
                  f"{got}; plain-op calls: {plain}")
            if got != want or plain:
                raise AssertionError(f"{route} route launches {got} / plain "
                                     f"calls {plain}; expected {want} / {{}}")
        for route in ROUTES:
            times = route_ms[route]
            mean = sum(times) / len(times)
            note(f"  phase {phase}, {route} route: {mean:.3f} ms/step "
                 f"({', '.join(f'{t:.3f}' for t in times)}), "
                 f"{TRAIN_BATCH / mean * 1e3:.2f} frames/s  [{smi}]")
        print(f"  last loss {metrics[-1]['loss'].item():.6f}, EPE "
              f"{metrics[-1]['epe'].item():.6f}; peak {peak_gib:.2f} GiB "
              f"allocated")
        return route_ms, route_launches, peak_gib

    step = StepFactory(tmodel, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    route_ms, route_launches, _ = timed_routes(step, "4")
    train_launches = route_launches[stage_glue.TRAIN_WARP][0]

    # -- 4b. FlowNet2 bf16 training -------------------------------------------
    print(f"phase 4b: FlowNet2 bf16 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
          f"{TRAIN_WIDTH} (float32 master weights, bf16 convolutions, glue "
          "and warps), MultiScale, Adam 1e-4")
    # what the earlier phases leave allocated (phase 4's fp32 model,
    # gradients and Adam moments among them), so that the bf16 step's own
    # peak can be read apart
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)

    def bf16_grads(net, imgs, tgt, what):
        """loss_and_grads of the bf16 model, every gradient float32 and
        finite."""
        out = loss_and_grads(net, imgs, tgt)
        bad = [n for n, g in out[2].items()
               if g.dtype != torch.float32 or not torch.isfinite(g).all()]
        if bad:
            raise AssertionError(f"{what}: gradients not float32 and finite: "
                                 f"{bad[:5]}")
        return out

    # The bf16 gradient is held per sub-net: two bf16 forwards that differ
    # in the last bit put flownetc and flownets_1 on the noise line (a bf16
    # flow of 16-32 px has an ulp of 0.125; the warps' flow gradient jumps
    # where a sample point crosses an integer), so those two are printed
    # beside the JAX package's own bf16-against-f32 reading (1.20, 1.45 on
    # the CPU, tests/test_torch_bf16_train.py) and held only below 1.0.
    # With the forward shared every sub-net is held at 5e-2.
    torch.backends.cudnn.deterministic = True
    loss_16, epe_16, grads_16 = bf16_grads(model16, images, target,
                                           "bf16 step")
    print(f"  first step: loss {loss_16:.6f}, EPE {epe_16:.6f}")
    for route in ROUTES:
        with mock.patch.object(stage_glue, "TRAIN_WARP", route):
            loss_r, _, grads_r = (
                (loss_16, epe_16, grads_16)
                if route == stage_glue.TRAIN_WARP
                else bf16_grads(model16, images, target, f"bf16 {route}"))
            with plain_ops(backward_kernels):
                ops.reset_counts()
                loss_b, _, grads_b = bf16_grads(model16, images, target,
                                                "bf16 plain backward")
                if any(k.startswith(("correlation_bwd",
                                     "resample2d_grad_flow"))
                       for k in ops.LAUNCHES):
                    raise AssertionError(f"plain backward launched "
                                         f"{dict(ops.LAUNCHES)}")
        if loss_b != loss_r:
            raise AssertionError(f"bf16 {route}: the forward is not shared "
                                 f"(loss {loss_r} against {loss_b})")
        subnets_close(grads_r, grads_b, {}, f"bf16 {route} route, backward "
                      "kernels against the plain backward (loss bit-equal)")
        if route != stage_glue.TRAIN_WARP:
            subnets_close(grads_r, grads_16, {}, f"bf16 {route} route "
                          f"against the {stage_glue.TRAIN_WARP} route")
    del grads_r, grads_b
    with plain_ops():
        ops.reset_counts()
        loss_p, epe_p, grads_p = bf16_grads(model16, images, target,
                                            "bf16 plain-op step")
        if sum(ops.LAUNCHES.values()):
            raise AssertionError(f"plain-op step launched {ops.LAUNCHES}")
    torch.backends.cudnn.deterministic = False
    noise_line = {"flownetc": None, "flownets_1": None}
    for a, b, what in ((loss_16, loss_p, "loss"), (epe_16, epe_p, "EPE")):
        note(f"  phase 4b, {what}: kernels {a:.6f}, plain-op model {b:.6f}")
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"bf16 {what}: kernels {a} vs plain ops {b}")
    subnets_close(grads_16, grads_p, noise_line,
                  "bf16 kernel model against the plain-op bf16 model")
    del grads_p

    small16 = get_model("FlowNet2", device="cpu", seed=0,
                        dtype=torch.bfloat16)
    loss_s, epe_s, grads_s = bf16_grads(model16, small_img, small_tgt,
                                        "bf16 small step")
    loss_c, epe_c, grads_c = bf16_grads(small16, small_img.cpu(),
                                        small_tgt.cpu(), "bf16 CPU step")
    print(f"  small step: loss {loss_s:.6f} / EPE {epe_s:.6f} on the card, "
          f"{loss_c:.6f} / {epe_c:.6f} on the CPU")
    for a, b, what in ((loss_s, loss_c, "small loss"),
                       (epe_s, epe_c, "small EPE")):
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"bf16 {what}: card {a} vs CPU {b}")
    subnets_close(grads_s, grads_c, noise_line,
                  "bf16 small step against the CPU")
    del grads_16, grads_s, grads_c, small16
    deterministic_step(model16, "4b, bf16")

    step16 = StepFactory(model16, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    route16_ms, route16_launches, peak16_train_gib = timed_routes(
        step16, "4b, bf16", "_bf16")
    note(f"  phase 4b, bf16 step: peak {peak16_train_gib:.2f} GiB allocated, "
         f"{peak16_train_gib - base_gib:.2f} GiB above the {base_gib:.2f} "
         f"GiB the earlier phases leave allocated  [{smi}]")
    # how far the host holds the card back: the host's time to enqueue a
    # step against the card's time for one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step16(images, target)
    host16_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    torch.cuda.synchronize()
    note(f"  the host enqueues a bf16 step in {host16_ms:.3f} ms, the card "
         f"runs one in {min(route16_ms['grad_flow']):.3f} ms (grad_flow "
         "route, CUDA events above)")
    # phase 5 runs as it did before phase 4b: no second model beside it
    del model16, step16
    torch.cuda.empty_cache()

    # -- 4c. FlowNet2 fp16 training -------------------------------------------
    print(f"phase 4c: FlowNet2 fp16 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
          f"{TRAIN_WIDTH} (float32 master weights, fp16 convolutions, glue "
          f"and warps), MultiScale, Adam 1e-4, loss scale {FP16_SCALE:g}, "
          "non-finite updates skipped")
    modelh = get_model("FlowNet2", device=DEVICE, seed=0, dtype=torch.float16)

    def fp16_grads(net, imgs, tgt, what):
        """loss_and_grads of the fp16 model with the loss scaled by
        FP16_SCALE before the backward and the gradients divided by it
        after, as StepFactory does: the loss unscaled, every gradient
        float32 and finite."""
        net.train()
        net.zero_grad(set_to_none=True)
        lossvalue, epevalue = loss_fn(net(imgs), tgt)
        (lossvalue * FP16_SCALE).backward()
        grads = {n: p.grad.detach() / FP16_SCALE
                 for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        bad = [n for n, g in grads.items()
               if g.dtype != torch.float32 or not torch.isfinite(g).all()]
        if bad:
            raise AssertionError(f"{what}: gradients not float32 and finite: "
                                 f"{bad[:5]}")
        return lossvalue.item(), epevalue.item(), grads

    # with the forward shared, the fp16 backward kernels against the plain
    # backward on both routes, every sub-net at 5e-2 in relative L2
    torch.backends.cudnn.deterministic = True
    loss_h, epe_h, grads_h = fp16_grads(modelh, images, target, "fp16 step")
    print(f"  first step: loss {loss_h:.6f}, EPE {epe_h:.6f}")
    for route in ROUTES:
        with mock.patch.object(stage_glue, "TRAIN_WARP", route):
            loss_r, _, grads_r = (
                (loss_h, epe_h, grads_h)
                if route == stage_glue.TRAIN_WARP
                else fp16_grads(modelh, images, target, f"fp16 {route}"))
            with plain_ops(backward_kernels):
                ops.reset_counts()
                loss_b, _, grads_b = fp16_grads(modelh, images, target,
                                                "fp16 plain backward")
                if any(k.startswith(("correlation_bwd",
                                     "resample2d_grad_flow"))
                       for k in ops.LAUNCHES):
                    raise AssertionError(f"plain backward launched "
                                         f"{dict(ops.LAUNCHES)}")
        if loss_b != loss_r:
            raise AssertionError(f"fp16 {route}: the forward is not shared "
                                 f"(loss {loss_r} against {loss_b})")
        subnets_close(grads_r, grads_b, {}, f"phase 4c, fp16 {route} route, "
                      "backward kernels against the plain backward (loss "
                      "bit-equal)")
    del grads_r, grads_b
    # the loss unscaled: within the contract of the fp32 step's
    bf16_contract(torch.tensor([loss_h, epe_h]),
                  torch.tensor([loss_k, epe_k]), "phase 4c, the fp16 step's "
                  "loss and EPE against the fp32 step's")

    # the same step as two row bands on this card (K7 fp16 and the fp16
    # local-rows K2 and K4), cuDNN deterministic, against the whole map;
    # its launches exact
    ops.reset_counts()
    with sharding_hints.scoped_spatial_shards(SHARDS):
        loss_bh, epe_bh, grads_bh = fp16_grads(modelh, images, target,
                                               "fp16 band step")
    torch.cuda.synchronize()
    band_step_h = dict(ops.LAUNCHES)
    want = {"correlation_fwd_rows_fp16": SHARDS,
            "correlation_bwd_f1_rows_fp16": SHARDS,
            "correlation_bwd_f2_rows_fp16": SHARDS,
            "resample2d_fwd_fp16": 2 * SHARDS,
            "resample2d_fwd_multi_fp16": SHARDS,
            "resample2d_grad_flow_fp16": 2 * SHARDS,
            "resample2d_grad_flow_multi_fp16": SHARDS}
    print(f"  phase 4c, one fp16 step as {SHARDS} row bands: launches "
          f"{band_step_h}; plain-op calls {dict(ops.PLAIN_CALLS)}")
    if band_step_h != want or ops.PLAIN_CALLS:
        raise AssertionError(f"fp16 band step launches {band_step_h}; "
                             f"expected {want}")
    torch.backends.cudnn.deterministic = False
    for a, b, what in ((loss_bh, loss_h, "loss"), (epe_bh, epe_h, "EPE")):
        note(f"  phase 4c, fp16 {what}: {SHARDS} bands {a:.6f}, whole map "
             f"{b:.6f}")
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"fp16 {what}: bands {a} vs whole {b}")
    subnets_close(grads_bh, grads_h, BF16_BAND_GATES, f"phase 4c, fp16 step "
                  f"under {SHARDS} bands against the whole map")
    del grads_h, grads_bh

    # timed, both routes in turns, the launches exact; every update at loss
    # scale FP16_SCALE that overflowed is skipped and counted
    factory_h = StepFactory(modelh, loss_fn, get_optimizer("Adam", 1e-4),
                            loss_scale=FP16_SCALE,
                            skip_nonfinite_updates=True)
    steph = factory_h.train_step()
    routeh_ms, routeh_launches, peakh_gib = timed_routes(steph, "4c, fp16",
                                                         "_fp16")
    n_steps = len(ROUTES) * 2 * ROUTE_ROUNDS * (TRAIN_WARMUP + TRAIN_STEPS)
    note(f"  phase 4c, fp16 step: {factory_h.skipped_updates} of {n_steps} "
         f"updates skipped at loss scale {FP16_SCALE:g}; peak "
         f"{peakh_gib:.2f} GiB allocated  [{smi}]")
    note("  phase 4c beside 4b, one call, the fastest round of each route: "
         + "; ".join(f"{route} fp16 {min(routeh_ms[route]):.3f} ms/step "
                     f"[bf16 {min(route16_ms[route]):.3f}]"
                     for route in ROUTES) + f"  [{smi}]")
    if factory_h.skipped_updates >= n_steps:
        raise AssertionError("phase 4c: every fp16 update was skipped")
    del modelh, steph, factory_h
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. the row-band path ---------------------------------------------------
    print(f"phase 5: {SHARDS} row bands (K7 and the local-rows K2, K3, K4), "
          "fp32, TF32 off")

    def per_run(counts: dict, runs: int) -> dict:
        return {k: v / runs for k, v in counts.items()}

    def check_counts(what, runs, want):
        got, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        print(f"  {what}, launches over {runs} runs: {got}; plain-op calls: "
              f"{plain}")
        if per_run(got, runs) != want or plain:
            raise AssertionError(f"{what}: launches per run "
                                 f"{per_run(got, runs)} / plain calls {plain};"
                                 f" expected {want} / {{}}")
        return got

    def check_dispatch(what):
        log = sharding_hints.dispatch_log()
        print(f"  {what}, dispatch: {log}")
        if (f"bands(spatial={SHARDS})+halo-slab, kernel=cuda-rows"
                != log.get("correlation")
                or f"bands(spatial={SHARDS})+halo-gather, kernel=cuda-rows"
                != log.get("resample2d")):
            raise AssertionError(f"{what}: not the row-band compositions")

    band_fwd = {"correlation_fwd_rows": SHARDS, "resample2d_fwd": 2 * SHARDS,
                "resample2d_fwd_multi": SHARDS}
    band_step = dict(band_fwd, correlation_bwd_f1_rows=SHARDS,
                     correlation_bwd_f2_rows=SHARDS,
                     resample2d_grad_flow=2 * SHARDS,
                     resample2d_grad_flow_multi=SHARDS)
    with torch.inference_mode():
        # cuDNN's default forward algorithms differ from run to run in the
        # last bits, so the two models are compared with deterministic ones
        noise = (model(pairs[0]) - model(pairs[0])).abs().max().item()
        torch.backends.cudnn.deterministic = True
        flow_whole = model(pairs[0])
        with sharding_hints.scoped_spatial_shards(SHARDS):
            sharding_hints.clear_dispatch_log()
            flow_bands = model(pairs[0])
            check_dispatch("FlowNet2 inference")
        torch.backends.cudnn.deterministic = False
        with sharding_hints.scoped_spatial_shards(SHARDS):
            model(pairs[0])
            ops.reset_counts()
            bands_ms = time_ms(lambda: model(pairs[0]), TIMED_BATCHES,
                               warmup=0)
            band_fwd_launches = check_counts("FlowNet2 inference",
                                             TIMED_BATCHES, band_fwd)
        whole_ms = time_ms(lambda: model(pairs[0]), TIMED_BATCHES, warmup=1)
    err = (flow_bands - flow_whole).abs().max().item()
    print(f"  FlowNet2 b{BATCH} {HEIGHT}x{WIDTH}: {bands_ms:.3f} ms/batch under "
          f"{SHARDS} bands, whole-map {whole_ms:.3f} ms/batch now and "
          f"{ms:.3f} in phase 3  [{smi}]")
    print(f"  {SHARDS} bands against the whole-map model, cuDNN deterministic: "
          f"max abs diff {err:.3e}, bit-equal: "
          f"{torch.equal(flow_bands, flow_whole)}; the whole-map model against "
          f"itself with cuDNN's default algorithms: {noise:.3e}")
    if not torch.allclose(flow_bands, flow_whole, rtol=0, atol=1e-5):
        raise AssertionError("the row-band model disagrees with the "
                             "whole-map model")
    del flow_whole, flow_bands

    torch.backends.cudnn.deterministic = True
    loss_w, _, grads_w = loss_and_grads(tmodel, images, target)
    with sharding_hints.scoped_spatial_shards(SHARDS):
        sharding_hints.clear_dispatch_log()
        ops.reset_counts()
        loss_b, epe_b, grads_b = loss_and_grads(tmodel, images, target)
        check_counts("FlowNet2 loss and gradients", 1, band_step)
        check_dispatch("FlowNet2 train step")
    torch.backends.cudnn.deterministic = False
    print(f"  train step under {SHARDS} bands: loss {loss_b:.6f}, EPE "
          f"{epe_b:.6f}; whole-map loss {loss_w:.6f}")
    if not abs(loss_b - loss_w) <= 1e-4 * abs(loss_w):
        raise AssertionError(f"loss: {SHARDS} bands {loss_b} vs whole-map "
                             f"{loss_w}")
    grads_close(grads_b, grads_w, 1e-3, f"{SHARDS} bands against the "
                "whole-map step", per_tensor=False)
    del grads_w, grads_b
    metrics = []
    with sharding_hints.scoped_spatial_shards(SHARDS):
        for _ in range(TRAIN_WARMUP):
            step(images, target)
        ops.reset_counts()
        bands_step_ms = time_ms(
            lambda: metrics.append(step(images, target)), TRAIN_STEPS,
            warmup=0)
        band_step_launches = check_counts("FlowNet2 train step", TRAIN_STEPS,
                                          band_step)
    whole_step_ms = time_ms(lambda: step(images, target), TRAIN_STEPS,
                            warmup=1)
    if not all(torch.isfinite(m["loss"]) and torch.isfinite(m["epe"])
               for m in metrics):
        raise AssertionError(f"{SHARDS} bands: non-finite loss or EPE")
    phase4_ms = sum(route_ms[stage_glue.TRAIN_WARP]) / len(
        route_ms[stage_glue.TRAIN_WARP])
    print(f"  FlowNet2 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x{TRAIN_WIDTH}: "
          f"{bands_step_ms:.3f} ms/step under {SHARDS} bands, whole-map "
          f"{whole_step_ms:.3f} ms/step now and {phase4_ms:.3f} in phase 4  "
          f"[{smi}]")

    cmodel = get_model("FlowNet2C", device=DEVICE, seed=1)
    c_target = torch.rand((BATCH, HEIGHT, WIDTH, 2), generator=band_gen,
                          device=dev) * 5.0
    with torch.inference_mode():
        c_flow = cmodel(pairs[0])
        ops.reset_counts()
        c_ms = time_ms(lambda: cmodel(pairs[0]), TIMED_BATCHES, warmup=0)
        check_counts("FlowNet2C inference, whole map", TIMED_BATCHES,
                     {"correlation_fwd": 1})
    if c_flow.shape != (BATCH, HEIGHT, WIDTH, 2) \
            or not torch.isfinite(c_flow).all():
        raise AssertionError(f"bad FlowNet2C flow: {tuple(c_flow.shape)}")
    print(f"  FlowNet2C b{BATCH} {HEIGHT}x{WIDTH}: {c_ms:.3f} ms/batch  "
          f"[{smi}]")
    c_step = StepFactory(cmodel, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    with sharding_hints.scoped_spatial_shards(SHARDS):
        with plain_ops():
            ops.reset_counts()
            c_loss_p = loss_and_grads(cmodel, pairs[0], c_target)[0]
            if sum(ops.LAUNCHES.values()):
                raise AssertionError(f"plain-op FlowNet2C launched "
                                     f"{ops.LAUNCHES}")
        ops.reset_counts()
        c_metrics = c_step(pairs[0], c_target)
        torch.cuda.synchronize()
        check_counts("FlowNet2C train step", 1, {
            name: SHARDS for name in (
                "correlation_fwd_rows", "correlation_bwd_f1_rows",
                "correlation_bwd_f2_rows")})
    c_loss, c_epe = c_metrics["loss"].item(), c_metrics["epe"].item()
    print(f"  FlowNet2C train step under {SHARDS} bands, MultiScale: loss "
          f"{c_loss:.6f}, EPE {c_epe:.6f}; plain-op model's loss "
          f"{c_loss_p:.6f}")
    if not (math.isfinite(c_loss) and math.isfinite(c_epe)):
        raise AssertionError("FlowNet2C: non-finite loss or EPE")
    if not abs(c_loss - c_loss_p) <= 1e-4 * abs(c_loss_p):
        raise AssertionError(f"FlowNet2C loss: kernels {c_loss} vs plain ops "
                             f"{c_loss_p}")
    del cmodel, c_step

    # -- 5b. the row-band path in bf16 ----------------------------------------
    print(f"phase 5b: {SHARDS} row bands in bf16 (K7 bf16 and the bf16 "
          "local-rows K2, K3, K4)")
    # the bf16 model of the same weights, built again and freed after, as in
    # phases 3b and 4b
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)
    band16_fwd = {f"{k}_bf16": v for k, v in band_fwd.items()}
    band16_step = {f"{k}_bf16": v for k, v in band_step.items()}
    fwd16_ms = {1: [], SHARDS: []}
    with torch.inference_mode():
        for pair in pairs:
            model16(pair)
        # whole map and bands in turns, 10 timed batches each
        for shards in (1, SHARDS, SHARDS, 1):
            with sharding_hints.scoped_spatial_shards(shards):
                model16(pairs[0])
                sharding_hints.clear_dispatch_log()
                ops.reset_counts()
                fwd16_ms[shards].append(time_ms(lambda: model16(pairs[0]),
                                                TIMED_BATCHES, warmup=0))
                if shards > 1:
                    band16_fwd_launches = check_counts(
                        "FlowNet2 bf16 inference", TIMED_BATCHES, band16_fwd)
                    check_dispatch("FlowNet2 bf16 inference")
    whole16, bands16 = (sum(fwd16_ms[k]) / 2 for k in (1, SHARDS))
    note(f"  phase 5b, bf16 inference b{BATCH} {HEIGHT}x{WIDTH}: "
         f"{bands16:.3f} ms/batch under {SHARDS} bands "
         f"({', '.join(f'{t:.3f}' for t in fwd16_ms[SHARDS])}), "
         f"{BATCH / bands16 * 1e3:.2f} frames/s; whole map {whole16:.3f} "
         f"({', '.join(f'{t:.3f}' for t in fwd16_ms[1])}) in turns, "
         f"{ms16:.3f} in phase 3b  [{smi}]")

    # one step whole and under bands, cuDNN deterministic: the forwards are
    # the same bits, so the gradients differ by d_f2's halo sums only
    torch.backends.cudnn.deterministic = True
    loss_w, epe_w, grads_w = bf16_grads(model16, images, target,
                                        "bf16 whole-map step")
    with sharding_hints.scoped_spatial_shards(SHARDS):
        sharding_hints.clear_dispatch_log()
        ops.reset_counts()
        loss_b, epe_b, grads_b = bf16_grads(model16, images, target,
                                            "bf16 band step")
        check_counts("FlowNet2 bf16 loss and gradients", 1, band16_step)
        check_dispatch("FlowNet2 bf16 train step")
    torch.backends.cudnn.deterministic = False
    for a, b, what in ((loss_b, loss_w, "loss"), (epe_b, epe_w, "EPE")):
        note(f"  phase 5b, bf16 {what}: {SHARDS} bands {a:.6f}, whole map "
             f"{b:.6f}, bit-equal {a == b}")
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"bf16 {what}: {SHARDS} bands {a} vs whole "
                                 f"map {b}")
    subnets_close(grads_b, grads_w, noise_line, f"bf16 step under {SHARDS} "
                  "bands against the whole map, cuDNN deterministic")
    del grads_w, grads_b

    step16 = StepFactory(model16, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    whole16_step_ms = timed_routes(step16, "5b, bf16, whole map", "_bf16")[0]
    bands16_step_ms, band16_launches, peak16_bands_gib = timed_routes(
        step16, f"5b, bf16, {SHARDS} bands", "_bf16", SHARDS)
    for route in ROUTES:
        a, b = (sum(t[route]) / len(t[route])
                for t in (bands16_step_ms, whole16_step_ms))
        note(f"  phase 5b, bf16 step, {route} route: {a:.3f} ms/step under "
             f"{SHARDS} bands, {b:.3f} whole map ({a - b:+.3f} ms); peak "
             f"{peak16_bands_gib:.2f} GiB allocated under bands  [{smi}]")
    del model16, step16
    torch.cuda.empty_cache()

    # -- 5c. FlowNet2 trained from files through the Trainer --------------------
    # (phase4_ms: phase 4's mean on the default route, from phase 5)
    phase5c_ms = trainer_phase(smi, phase4_ms,
                               sum(route16_ms[stage_glue.TRAIN_WARP])
                               / len(route16_ms[stage_glue.TRAIN_WARP]))

    # -- 5d. the command line and caffemodel import -----------------------------
    cli_work = Path(tempfile.mkdtemp(prefix="chip_smoke_5d_"))
    try:
        cli_run = cli_phase(smi, phase4_ms, phase5c_ms, cli_work)

        # -- 5e. data parallel, in fresh processes --------------------------
        gc.collect()
        torch.cuda.empty_cache()
        data_parallel_phase(smi, cli_run)
    finally:
        shutil.rmtree(cli_work, ignore_errors=True)

    # -- 5f. row bands across ranks, in fresh processes ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    band_ranks = bands_phase(smi)

    # -- 6. kernel times ------------------------------------------------------
    print("phase 6: kernel times at the main-path shapes")
    rows = []
    with torch.no_grad():
        b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
        f1, f2 = randn(b, c, h, w), randn(b, c, h, w)
        k1_bytes = 4 * (2 * b * c * h * w + b * disp * disp * h * w)
        k1_flops = corr_flops(b, c, h, w)
        rows.append(("correlation_fwd", "correlation_pallas.py:83",
                     "correlation_fwd.cu",
                     lambda: corr.correlation_cuda(f1, f2, *corr_args),
                     lambda: corr.correlation_plain(f1, f2, *corr_args),
                     None, k1_bytes, k1_flops))

        b, h, w, ch = BATCH, HEIGHT, WIDTH, 3
        xs = torch.arange(w, device=dev).view(1, 1, -1)
        ys = torch.arange(h, device=dev).view(1, -1, 1)

        def grid_of(fl, xs=xs, ys=ys, h=h, w=w):
            gx = (xs + fl[:, 0]) * (2.0 / (w - 1)) - 1.0
            gy = (ys + fl[:, 1]) * (2.0 / (h - 1)) - 1.0
            return torch.stack([gx, gy], dim=-1)

        grid1 = grid_of(flow8)
        grid2 = torch.cat([grid_of(flow8), grid_of(flow200)], dim=0)
        img2 = img.unsqueeze(1).expand(b, 2, ch, h, w).reshape(2 * b, ch, h, w)
        # per output pixel ~10 flops of coordinates and weights, then 7 per
        # channel (4 multiplies, 3 adds)
        for name, nflows, fn, plain, lib, grid in (
                ("resample2d_fwd", 1,
                 lambda: r2d.resample2d_cuda(img, flow8),
                 lambda: r2d.resample2d_plain(img, flow8), img, grid1),
                ("resample2d_fwd_multi", 2,
                 lambda: r2d.resample2d_multi_cuda(img, flows),
                 lambda: r2d.resample2d_multi_plain(img, flows), img2, grid2)):
            nbytes = 4 * b * h * w * (ch + nflows * (2 + ch))
            flops = b * nflows * h * w * (10 + 7 * ch)
            rows.append((name, "resample2d_pallas.py:239", "resample2d_fwd.cu",
                         fn, plain,
                         (lambda lib=lib, grid=grid: F.grid_sample(
                             lib, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)),
                         nbytes, flops))

        # the training shapes: K5/K6 at FlowNetC's (8, 256, 48, 56), K3/K4
        # at (8, 3, 384, 448) with +-8 px flows
        b, c, h, w = TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8
        tf1, tf2 = randn(b, c, h, w), randn(b, c, h, w)
        tg = randn(b, disp * disp, h, w)
        bwd_bytes = 4 * (2 * b * c * h * w + b * disp * disp * h * w)
        bwd_flops = corr_flops(b, c, h, w)
        for name, needs, replaces in (
                ("correlation_bwd_f1", (True, False),
                 "correlation_pallas.py:449"),
                ("correlation_bwd_f2", (False, True),
                 "correlation_pallas.py:478")):
            rows.append((name, replaces, "correlation_bwd.cu",
                         (lambda needs=needs: corr.correlation_bwd_cuda(
                             tg, tf1, tf2, 20, 2, needs=needs)),
                         (lambda needs=needs: corr.correlation_bwd_plain(
                             tg, tf1, tf2, 20, 2, needs=needs)),
                         None, bwd_bytes, bwd_flops))

        b, h, w, ch = TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 3
        one, two = t_flows[:, :1].contiguous(), t_flows
        # per output pixel ~10 flops of coordinates and weights, then 17 per
        # channel (7 for out, 5 each for d1 and d2)
        for name, fl in (("resample2d_tangents", one),
                         ("resample2d_tangents_multi", two)):
            nflows = fl.shape[1]
            rows.append((name, "resample2d_pallas.py:262",
                         "resample2d_tangents.cu",
                         (lambda fl=fl: r2d.resample2d_tangents_cuda(t_img,
                                                                     fl)),
                         (lambda fl=fl: r2d.resample2d_tangents_plain(t_img,
                                                                      fl)),
                         None, 4 * b * h * w * (ch + nflows * (2 + 3 * ch)),
                         b * nflows * h * w * (10 + 17 * ch)))
        tg4 = randn(b, 1, ch, h, w)
        grid = grid_of(one[:, 0], xs=torch.arange(w, device=dev).view(1, 1, -1),
                       ys=torch.arange(h, device=dev).view(1, -1, 1), h=h, w=w)
        with torch.enable_grad():
            grid_leaf = grid.clone().requires_grad_()
            sampled = F.grid_sample(t_img, grid_leaf, mode="bilinear",
                                    padding_mode="border", align_corners=True)
        # the same function as one library call: grid_sample's backward for
        # the grid (its gradient times (W-1)/2 and (H-1)/2 is d_flow)
        rows.append(("resample2d_grad_flow", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4, t_img, one),
                     lambda: r2d.resample2d_grad_flow_plain(tg4, t_img, one),
                     lambda: torch.autograd.grad(sampled, grid_leaf, tg4[:, 0],
                                                 retain_graph=True),
                     4 * b * h * w * (2 * ch + 2 + 2),
                     b * h * w * (10 + 12 * ch)))
        # the two-flow K4 (+-8 px and +-200 px, K3's two-flow input) and,
        # as one library call, grid_sample's grid gradient over the image
        # taken once for each flow
        tg4_2 = randn(b, 2, ch, h, w, gen=tile_gen)
        t_img2 = t_img.repeat(2, 1, 1, 1)  # flow-major, as the grids
        with torch.enable_grad():
            grid_leaf2 = torch.cat([
                grid_of(two[:, k], xs=torch.arange(w, device=dev).view(
                    1, 1, -1), ys=torch.arange(h, device=dev).view(1, -1, 1),
                    h=h, w=w) for k in range(2)]).requires_grad_()
            sampled2 = F.grid_sample(t_img2, grid_leaf2, mode="bilinear",
                                     padding_mode="border",
                                     align_corners=True)
        g_by_flow = tg4_2.transpose(0, 1).reshape(2 * b, ch, h, w)
        rows.append(("resample2d_grad_flow_multi", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_2, t_img, two),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_2, t_img, two),
                     lambda: torch.autograd.grad(sampled2, grid_leaf2,
                                                 g_by_flow, retain_graph=True),
                     4 * b * h * w * (ch + 2 * (ch + 2 + 2)),
                     2 * b * h * w * (10 + 12 * ch)))

        def k7_rows(dtype=torch.float32):
            """K7's rows at one band of SHARDS: the forward at the inference
            map, the backward at the training map; d_slab does the same
            multiply-adds as d_f1 and writes the taller slab."""
            suffix = _cuda.suffix(dtype)
            for base, replaces, src, (b, c, h, w) in (
                    ("correlation_fwd_rows", "correlation_pallas.py:615",
                     "correlation_fwd.cu",
                     (BATCH, 256, HEIGHT // 8, WIDTH // 8)),
                    ("correlation_bwd_f1_rows", "correlation_pallas.py:528",
                     "correlation_bwd.cu",
                     (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8)),
                    ("correlation_bwd_f2_rows", "correlation_pallas.py:528",
                     "correlation_bwd.cu",
                     (TRAIN_BATCH, 256, TRAIN_HEIGHT // 8,
                      TRAIN_WIDTH // 8))):
                h //= SHARDS
                sf1, sslab = (randn(b, c, h, w).to(dtype),
                              randn(b, c, h + 40, w).to(dtype))
                sg = randn(b, disp * disp, h, w).to(dtype)
                sizes = {"correlation_fwd_rows": (sf1, sslab, sg),
                         "correlation_bwd_f1_rows": (sg, sslab, sf1),
                         "correlation_bwd_f2_rows": (sg, sf1, sslab)}[base]
                if base == "correlation_fwd_rows":
                    fn = lambda sf1=sf1, sslab=sslab: corr_sp.corr_slab_cuda(
                        sf1, sslab, 20, 2)
                    plain = (lambda sf1=sf1, sslab=sslab:
                             corr_sp.corr_slab_plain(sf1, sslab, 20, 2))
                else:
                    needs = (base == "correlation_bwd_f1_rows",
                             base == "correlation_bwd_f2_rows")
                    fn = (lambda sf1=sf1, sslab=sslab, sg=sg, needs=needs:
                          corr_sp.corr_slab_bwd_cuda(sg, sf1, sslab, 20, 2,
                                                     needs=needs))
                    plain = (lambda sf1=sf1, sslab=sslab, sg=sg, needs=needs:
                             corr_sp.corr_slab_bwd_plain(sg, sf1, sslab, 20,
                                                         2, needs=needs))
                rows.append((base + suffix, replaces, src, fn, plain, None,
                             sum(t.numel() * t.element_size() for t in sizes),
                             corr_flops(b, c, h, w, slab=True)))

        k7_rows()

        # the bf16 forms at the bf16 path's shapes, 2 bytes a value; the
        # operations at the card's rate for bf16 (its tensor cores), the
        # warps' also at the f32 rate that their bodies, which upcast and
        # sum in f32, can reach (bound_ms_f32_body; the correlation runs on
        # the tensor cores).  No library
        # call: F.grid_sample wants its grid in the image's dtype, and a bf16
        # grid moves the sample point 2-4 px at 512 columns
        b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
        f1_16 = randn(b, c, h, w).bfloat16()
        f2_16 = randn(b, c, h, w).bfloat16()
        rows.append(("correlation_fwd_bf16", "correlation_pallas.py:83",
                     "correlation_fwd.cu",
                     lambda: corr.correlation_cuda(f1_16, f2_16, *corr_args),
                     lambda: corr.correlation_plain(f1_16, f2_16, *corr_args),
                     None, k1_bytes // 2, k1_flops))
        b, h, w, ch = BATCH, HEIGHT, WIDTH, 3
        img16, flow16, flows16 = (t.bfloat16() for t in (img, flow8, flows))
        for name, nflows, fn, plain in (
                ("resample2d_fwd_bf16", 1,
                 lambda: r2d.resample2d_cuda(img16, flow16),
                 lambda: r2d.resample2d_plain(img16, flow16)),
                ("resample2d_fwd_multi_bf16", 2,
                 lambda: r2d.resample2d_multi_cuda(img16, flows16),
                 lambda: r2d.resample2d_multi_plain(img16, flows16))):
            rows.append((name, "resample2d_pallas.py:239", "resample2d_fwd.cu",
                         fn, plain, None,
                         2 * b * h * w * (ch + nflows * (2 + ch)),
                         b * nflows * h * w * (10 + 7 * ch)))
        # the bf16 training kernels at the bf16 step's shapes: K5 and K6
        # (tensor-core bodies) at (8, 256, 48, 56), K3 and K4 at
        # (8, 3, 384, 448) with +-8 px flows; K3's d1 and d2 are float32
        b, c, h, w = TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8
        tf1_16, tf2_16, tg_16 = (t.bfloat16() for t in (tf1, tf2, tg))
        for name, needs, replaces in (
                ("correlation_bwd_f1_bf16", (True, False),
                 "correlation_pallas.py:449"),
                ("correlation_bwd_f2_bf16", (False, True),
                 "correlation_pallas.py:478")):
            rows.append((name, replaces, "correlation_bwd.cu",
                         (lambda needs=needs: corr.correlation_bwd_cuda(
                             tg_16, tf1_16, tf2_16, 20, 2, needs=needs)),
                         (lambda needs=needs: corr.correlation_bwd_plain(
                             tg_16, tf1_16, tf2_16, 20, 2, needs=needs)),
                         None, bwd_bytes // 2, bwd_flops))
        b, h, w, ch = TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 3
        t_img16 = t_img.bfloat16()
        one16, two16 = one.bfloat16(), two.bfloat16()
        for name, fl in (("resample2d_tangents_bf16", one16),
                         ("resample2d_tangents_multi_bf16", two16)):
            nflows = fl.shape[1]
            rows.append((name, "resample2d_pallas.py:262",
                         "resample2d_tangents.cu",
                         (lambda fl=fl: r2d.resample2d_tangents_cuda(t_img16,
                                                                     fl)),
                         (lambda fl=fl: r2d.resample2d_tangents_plain(t_img16,
                                                                      fl)),
                         None,
                         2 * b * h * w * ch
                         + b * nflows * h * w * (2 * 2 + 2 * ch + 8 * ch),
                         b * nflows * h * w * (10 + 17 * ch)))
        tg4_16 = tg4.bfloat16()
        rows.append(("resample2d_grad_flow_bf16", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_16, t_img16,
                                                           one16),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_16, t_img16,
                                                            one16),
                     None, 2 * b * h * w * (2 * ch + 2 + 2),
                     b * h * w * (10 + 12 * ch)))
        tg4_2_16 = tg4_2.bfloat16()
        rows.append(("resample2d_grad_flow_multi_bf16",
                     "resample2d_pallas.py:312", "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_2_16, t_img16,
                                                           two16),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_2_16, t_img16,
                                                            two16),
                     None, 2 * b * h * w * (ch + 2 * (ch + 2 + 2)),
                     2 * b * h * w * (10 + 12 * ch)))
        # K7 bf16 (tensor-core bodies) at one band of the bf16 forward's and
        # the bf16 step's maps
        k7_rows(torch.bfloat16)

        # the fp16 forms at the shapes of the bf16 rows, 2 bytes a value,
        # on the fp32 inputs above rounded to fp16 (no generator draws but
        # K7's); their operations bound at the card's fp16 tensor-core rate
        # (bf16's on an H100) and, where the body sums in float32 on the FMA
        # pipes (all but FP16_TENSOR_CORE_ROWS), also at the f32 rate
        # (bound_ms_f32_body).  The
        # warps' library call is F.grid_sample on fp16 tensors, its grid in
        # fp16 too, which moves the sample point by up to half an fp16 ulp
        # of the normalised coordinate (printed in pixels)
        b, c, h, w = BATCH, 256, HEIGHT // 8, WIDTH // 8
        f1_h, f2_h = f1.half(), f2.half()
        rows.append(("correlation_fwd_fp16", "correlation_pallas.py:83",
                     "correlation_fwd.cu",
                     lambda: corr.correlation_cuda(f1_h, f2_h, *corr_args),
                     lambda: corr.correlation_plain(f1_h, f2_h, *corr_args),
                     None, k1_bytes // 2, k1_flops))
        b, h, w, ch = BATCH, HEIGHT, WIDTH, 3
        img_h, flow_h, flows_h = img.half(), flow8.half(), flows.half()
        grid1_h, grid2_h = grid1.half(), grid2.half()
        img2_h = img2.half()
        grid_px = max((g16.float() - g32).abs().max().item()
                      for g16, g32 in ((grid1_h, grid1), (grid2_h, grid2))
                      ) * (w - 1) / 2
        note(f"  F.grid_sample in fp16 at {w} columns: its fp16 grid moves "
             f"the sample point by up to {grid_px:.4f} px")
        for name, nflows, fn, plain, lib, grid16 in (
                ("resample2d_fwd_fp16", 1,
                 lambda: r2d.resample2d_cuda(img_h, flow_h),
                 lambda: r2d.resample2d_plain(img_h, flow_h), img_h,
                 grid1_h),
                ("resample2d_fwd_multi_fp16", 2,
                 lambda: r2d.resample2d_multi_cuda(img_h, flows_h),
                 lambda: r2d.resample2d_multi_plain(img_h, flows_h), img2_h,
                 grid2_h)):
            rows.append((name, "resample2d_pallas.py:239", "resample2d_fwd.cu",
                         fn, plain,
                         (lambda lib=lib, grid16=grid16: F.grid_sample(
                             lib, grid16, mode="bilinear",
                             padding_mode="border", align_corners=True)),
                         2 * b * h * w * (ch + nflows * (2 + ch)),
                         b * nflows * h * w * (10 + 7 * ch)))
        b, c, h, w = TRAIN_BATCH, 256, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8
        tf1_h, tf2_h, tg_h = tf1.half(), tf2.half(), tg.half()
        for name, needs, replaces in (
                ("correlation_bwd_f1_fp16", (True, False),
                 "correlation_pallas.py:449"),
                ("correlation_bwd_f2_fp16", (False, True),
                 "correlation_pallas.py:478")):
            rows.append((name, replaces, "correlation_bwd.cu",
                         (lambda needs=needs: corr.correlation_bwd_cuda(
                             tg_h, tf1_h, tf2_h, 20, 2, needs=needs)),
                         (lambda needs=needs: corr.correlation_bwd_plain(
                             tg_h, tf1_h, tf2_h, 20, 2, needs=needs)),
                         None, bwd_bytes // 2, bwd_flops))
        b, h, w, ch = TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, 3
        t_img_h, one_h, two_h = t_img.half(), one.half(), two.half()
        for name, fl in (("resample2d_tangents_fp16", one_h),
                         ("resample2d_tangents_multi_fp16", two_h)):
            nflows = fl.shape[1]
            rows.append((name, "resample2d_pallas.py:262",
                         "resample2d_tangents.cu",
                         (lambda fl=fl: r2d.resample2d_tangents_cuda(t_img_h,
                                                                     fl)),
                         (lambda fl=fl: r2d.resample2d_tangents_plain(t_img_h,
                                                                      fl)),
                         None,
                         2 * b * h * w * ch
                         + b * nflows * h * w * (2 * 2 + 2 * ch + 8 * ch),
                         b * nflows * h * w * (10 + 17 * ch)))
        tg4_h, tg4_2_h = tg4.half(), tg4_2.half()
        with torch.enable_grad():
            grid_leaf_h = grid_leaf.detach().half().requires_grad_()
            sampled_h = F.grid_sample(t_img_h, grid_leaf_h, mode="bilinear",
                                      padding_mode="border",
                                      align_corners=True)
            grid_leaf2_h = grid_leaf2.detach().half().requires_grad_()
            sampled2_h = F.grid_sample(t_img2.half(), grid_leaf2_h,
                                       mode="bilinear", padding_mode="border",
                                       align_corners=True)
        g_by_flow_h = g_by_flow.half()
        rows.append(("resample2d_grad_flow_fp16", "resample2d_pallas.py:312",
                     "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_h, t_img_h,
                                                           one_h),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_h, t_img_h,
                                                            one_h),
                     lambda: torch.autograd.grad(sampled_h, grid_leaf_h,
                                                 tg4_h[:, 0],
                                                 retain_graph=True),
                     2 * b * h * w * (2 * ch + 2 + 2),
                     b * h * w * (10 + 12 * ch)))
        rows.append(("resample2d_grad_flow_multi_fp16",
                     "resample2d_pallas.py:312", "resample2d_grad_flow.cu",
                     lambda: r2d.resample2d_grad_flow_cuda(tg4_2_h, t_img_h,
                                                           two_h),
                     lambda: r2d.resample2d_grad_flow_plain(tg4_2_h, t_img_h,
                                                            two_h),
                     lambda: torch.autograd.grad(sampled2_h, grid_leaf2_h,
                                                 g_by_flow_h,
                                                 retain_graph=True),
                     2 * b * h * w * (ch + 2 * (ch + 2 + 2)),
                     2 * b * h * w * (10 + 12 * ch)))
        # K7 fp16 (forward, d_f1 and d_slab on the tensor-core bodies) at
        # one band of the fp16 forward's and the fp16 step's maps
        k7_rows(torch.float16)

        kernels = []
        for name, replaces, src, fn, plain, lib, nbytes, flops in rows:
            k_ms = time_ms(fn, 50, head_start=True)
            p_ms = time_ms(plain, 5)
            l_ms = (time_ms(lib, 50, head_start=True) if lib is not None
                    else None)
            bf16 = name.endswith("_bf16")
            low = bf16 or name.endswith("_fp16")
            b_ms, b_by = bound_ms(nbytes, flops, peaks, tensor_cores=low)
            say = note if low else print
            say(f"  {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                f"{'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP)  [{smi}; SM clock, max: "
                f"{sm_clock()}]")
            if name in K3_BEFORE_MS:
                note(f"  {name}: {k_ms:.4f} ms, {b_ms / k_ms:.0%} of its "
                     f"bound [{K3_BEFORE_MS[name]:.4f} ms, "
                     f"{b_ms / K3_BEFORE_MS[name]:.0%}, before the row tiles]"
                     f"  [{smi}]")
            extra = {}
            if (bf16 and not name.startswith("correlation")
                    or name.endswith("_fp16")
                    and name not in FP16_TENSOR_CORE_ROWS):
                extra["bound_ms_f32_body"] = bound_ms(nbytes, flops, peaks)[0]
            route = "tangents" if "tangents" in name else "grad_flow"
            step16_k = route16_launches[route][0]
            if name in launches:      # over the phase 3 forwards
                count = launches[name]
            elif name in launches16:  # over the phase 3b forwards
                count = launches16[name]
            elif name in fp16_run["launches"]:  # over the phase 3c forwards
                count = fp16_run["launches"][name]
            elif name == "correlation_fwd_rows_fp16":  # a phase 3c band fwd
                count = fp16_run["band_launches"][name]
            elif name.endswith("_rows_fp16"):  # the phase 4c band step
                count = band_step_h[name]
            elif name.endswith("_fp16"):  # per phase 4c step
                count = routeh_launches[route][0][name] / TRAIN_STEPS
            elif name == "correlation_fwd_rows_bf16":  # phase 5b forwards
                count = band16_fwd_launches[name]
            elif name.endswith("_rows_bf16"):      # per phase 5b step
                count = band16_launches["grad_flow"][0][name] / TRAIN_STEPS
            elif bf16:                # per phase 4b step
                count = step16_k[name] / TRAIN_STEPS
            elif name == "correlation_fwd_rows":   # over the phase 5 forwards
                count = band_fwd_launches[name]
            elif name.endswith("_rows"):           # per phase 5 train step
                count = band_step_launches[name] / TRAIN_STEPS
            elif name.startswith("resample2d_tangents"):
                count = route_launches["tangents"][0][name] / TRAIN_STEPS
            else:                      # per step of the default route
                count = train_launches[name] / TRAIN_STEPS
            if name.endswith("_rows_bf16"):
                fwd = name == "correlation_fwd_rows_bf16"
                note(f"  {name}: library none; "
                     f"{count / TIMED_BATCHES if fwd else count:g} launches "
                     f"a phase 5b {'forward' if fwd else 'step'}")
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"flownet2_tpu_torch/csrc/{src}",
                "replaces": f"flownet2_tpu/ops/{replaces}",
                "launches": count, "max_abs_err": max(errs[name]),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms, **extra})
            if name in band_ranks["step_launches"]:
                # per rank, one step of phase 5f's bands across ranks
                kernels[-1]["launches_bands_across_ranks"] = \
                    band_ranks["step_launches"][name]
            wide = {**band_ranks["wide"]["launches"]["fp32"],
                    **band_ranks["wide"]["launches"]["bf16"]}
            if name in wide:
                # per rank, one forward of phase 5f's bands of 256 and 192
                # rows
                kernels[-1]["launches_unequal_bands_across_ranks"] = \
                    wide[name]
        del sampled, grid_leaf, sampled2, grid_leaf2, sampled_h, grid_leaf_h, \
            sampled2_h, grid_leaf2_h
        by_name = {k["name"]: k for k in kernels}

        # the fp16 forms on the bf16 tensor-core bodies beside their bf16
        # forms; K1's, K5's and K6's gate the dispatch: the general body
        # reads ~8-10x its bf16 form's time
        slow = []
        for name, gated in FP16_TENSOR_CORE_ROWS.items():
            h_ms = by_name[name]["ms"]
            b_ms = by_name[name[:-len("_fp16")] + "_bf16"]["ms"]
            note(f"  {name}: {h_ms:.4f} ms against its bf16 form's "
                 f"{b_ms:.4f}, {h_ms / b_ms:.3f}x"
                 f"{' (at most 1.5x)' if gated else ''}  [{smi}]")
            if gated and h_ms > 1.5 * b_ms:
                slow.append(name)
        if slow:
            raise AssertionError(f"phase 6: {slow} take more than 1.5x their "
                                 "bf16 forms: not on the tensor-core bodies")

        # K2, K3 and K4 at the smooth flow the stage glue makes (+-8 px at
        # (H/4, W/4), bilinear x4), one and two flows, f32 and bf16, beside
        # the noise flows timed above
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            suffix = _cuda.suffix(dtype)
            im, t_im = img.to(dtype), t_img.to(dtype)
            for nflows in (1, 2):
                fl = smooth_flows(BATCH, nflows, HEIGHT, WIDTH).to(dtype)
                t_fl = smooth_flows(TRAIN_BATCH, nflows, TRAIN_HEIGHT,
                                    TRAIN_WIDTH).to(dtype)
                t_g = randn(TRAIN_BATCH, nflows, 3, TRAIN_HEIGHT,
                            TRAIN_WIDTH, gen=tile_gen).to(dtype)
                for base, fn in (
                        ("resample2d_fwd", lambda im=im, fl=fl:
                         r2d.resample2d_multi_cuda(im, fl)),
                        ("resample2d_grad_flow",
                         lambda t_g=t_g, t_im=t_im, t_fl=t_fl:
                         r2d.resample2d_grad_flow_cuda(t_g, t_im, t_fl)),
                        ("resample2d_tangents", lambda t_im=t_im, t_fl=t_fl:
                         r2d.resample2d_tangents_cuda(t_im, t_fl))):
                    name = r2d._per_flow(base, nflows) + suffix
                    note(f"  {name} at the smooth flow: "
                         f"{time_ms(fn, 50, head_start=True):.4f} ms (at the "
                         f"noise flow {by_name[name]['ms']:.4f})  [{smi}]")

        # cold L2: the one-flow K2 and K4 and their library calls, each call
        # on input buffers of its own, COLD_SETS sets of them in turn
        cold = {"K2": [], "grid_sample": [], "K4": [], "grid_sample grad": []}
        for _ in range(COLD_SETS):
            im = randn(BATCH, 3, HEIGHT, WIDTH)
            fl = uniform(BATCH, 2, HEIGHT, WIDTH, scale=8.0)
            gr = grid_of(fl)
            cold["K2"].append(lambda im=im, fl=fl: r2d.resample2d_cuda(im, fl))
            cold["grid_sample"].append(lambda im=im, gr=gr: F.grid_sample(
                im, gr, mode="bilinear", padding_mode="border",
                align_corners=True))
            th, tw = TRAIN_HEIGHT, TRAIN_WIDTH
            im = randn(TRAIN_BATCH, 3, th, tw)
            fl = uniform(TRAIN_BATCH, 1, 2, th, tw, scale=8.0)
            gt = randn(TRAIN_BATCH, 1, 3, th, tw)
            cold["K4"].append(lambda im=im, fl=fl, gt=gt:
                              r2d.resample2d_grad_flow_cuda(gt, im, fl))
            with torch.enable_grad():
                leaf = grid_of(fl[:, 0], xs=torch.arange(tw, device=dev).view(
                    1, 1, -1), ys=torch.arange(th, device=dev).view(1, -1, 1),
                    h=th, w=tw).requires_grad_()
                out = F.grid_sample(im, leaf, mode="bilinear",
                                    padding_mode="border", align_corners=True)
            cold["grid_sample grad"].append(
                lambda out=out, leaf=leaf, gt=gt: torch.autograd.grad(
                    out, leaf, gt[:, 0], retain_graph=True))
        k2, k4 = by_name["resample2d_fwd"], by_name["resample2d_grad_flow"]
        warm = {"K2": k2["ms"], "grid_sample": k2["library_ms"],
                "K4": k4["ms"], "grid_sample grad": k4["library_ms"]}
        for what, fns in cold.items():
            print(f"  cold L2, {what} (one flow, {COLD_SETS} input sets in "
                  f"turn): {cold_ms(fns, 60):.4f} ms, warm {warm[what]:.4f} "
                  f"ms  [{smi}; SM clock, max: {sm_clock()}]")
        del cold

        # the kernels of the configurations no model uses
        kernels.extend(cfg_times(dev, smi, peaks, errs, cfg_launches))

    # -- 7. where the device time goes --------------------------------------
    print(f"phase 7: FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} fp32, "
          f"{PROFILED_FORWARDS} forwards under torch.profiler")
    with torch.inference_mode():
        model(pairs[0])

        def forwards():
            for _ in range(PROFILED_FORWARDS):
                model(pairs[0])

        by_kernel = profile_families(forwards, PROFILED_FORWARDS, FAMILIES,
                                     smi, "batch")[0]
        # which convolution kernels cuDNN's default algorithms run, and which
        # of them a deterministic cuDNN does not (the one forward that
        # differs from run to run, phase 5)
        torch.backends.cudnn.deterministic = True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(pairs[0])
            torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        deterministic = {ev.key for ev in prof.key_averages()
                         if ev.device_type == torch.autograd.DeviceType.CUDA}
        print("  convolution kernels of the forward, cuDNN's defaults "
              "('*': not run with cudnn.deterministic):")
        for key, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
            if CONV.search(key):
                mark = " " if key in deterministic else "*"
                print(f"   {mark}{us / 1e3 / PROFILED_FORWARDS:9.3f} ms/batch"
                      f"  {key[:160]}")
        for key in sorted(deterministic - set(by_kernel)):
            if CONV.search(key):
                print(f"    only with cudnn.deterministic: {key[:160]}")
    note(f"  phase 7, FlowNet2 b{BATCH} {HEIGHT}x{WIDTH} bf16, "
         f"{PROFILED_FORWARDS} forwards under torch.profiler")
    model16 = get_model("FlowNet2", device=DEVICE, seed=0,
                        dtype=torch.bfloat16)
    with torch.inference_mode():
        model16(pairs[0])

        def forwards16():
            for _ in range(PROFILED_FORWARDS):
                model16(pairs[0])

        by_kernel16, counts16 = profile_families(
            forwards16, PROFILED_FORWARDS, BF16_FAMILIES, smi, "batch",
            say=note)
    layout = BF16_FAMILIES[2][1]
    n_layout = sum(n for key, n in counts16.items()
                   if layout.search(key)) / PROFILED_FORWARDS
    note(f"  phase 7, bf16 forward: {n_layout:g} layout-conversion launches "
         "a forward")
    print("  the "
          "convolution and layout-conversion kernels of the bf16 forward "
          "(launches a forward):")
    for key, us in sorted(by_kernel16.items(), key=lambda kv: -kv[1]):
        if layout.search(key) or CONV.search(key):
            print(f"    {us / 1e3 / PROFILED_FORWARDS:9.3f} ms/batch "
                  f"{counts16[key] / PROFILED_FORWARDS:6g}x  {key[:150]}")
    print(f"  FlowNet2 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x{TRAIN_WIDTH}, "
          f"{PROFILED_STEPS} steps under torch.profiler "
          f"({stage_glue.TRAIN_WARP} route)")
    step(images, target)

    def steps(step=step):
        for _ in range(PROFILED_STEPS):
            step(images, target)

    profile_families(steps, PROFILED_STEPS, TRAIN_FAMILIES, smi, "step")

    def k3_per_step(step, families, dtype):
        """K3's device time a step on the tangent route, from a profile of
        PROFILED_STEPS steps."""
        with mock.patch.object(stage_glue, "TRAIN_WARP", "tangents"):
            step(images, target)
            print(f"  {dtype} train step, {PROFILED_STEPS} steps on the "
                  "tangent route under torch.profiler")
            by_kernel, counts = profile_families(
                lambda: steps(step), PROFILED_STEPS, families, smi, "step")
        k3 = [k for k in by_kernel if "resample2d_tangents" in k]
        note(f"  phase 7, {dtype} step, tangent route: K3 "
             f"{sum(by_kernel[k] for k in k3) / 1e3 / PROFILED_STEPS:.3f} "
             f"ms a step in {sum(counts[k] for k in k3) / PROFILED_STEPS:g} "
             f"launches  [{smi}]")

    k3_per_step(step, TRAIN_FAMILIES, "fp32")

    def upsample_backward_per_step(step, dtype):
        """The bilinear upsample's backward a step, the port's and torch's:
        the device time and kernel launches under the autograd engine's
        range of its node, in a profile of PROFILED_STEPS steps."""
        def under(ev):
            return (len(ev.kernels)
                    + sum(under(child) for child in ev.cpu_children))

        readings = []
        for what, patch in (
                ("the port's", contextlib.nullcontext()),
                ("torch's", mock.patch.object(
                    flownet2_module, "upsample_bilinear",
                    interpolate_upsample))):
            with patch:
                step(images, target)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    steps(step)
                    torch.cuda.synchronize()
            nodes = [ev for ev in prof.events()
                     if ev.name.startswith("autograd::engine::evaluate_"
                                           "function")
                     and "UpsampleBilinear" in ev.name]
            node_ms = sum(ev.device_time_total for ev in nodes) / 1e3
            readings.append(
                f"{what} {node_ms / PROFILED_STEPS:.3f} "
                f"ms in {len(nodes) / PROFILED_STEPS:g} calls, "
                f"{sum(under(ev) for ev in nodes) / PROFILED_STEPS:g} "
                "launches")
        note(f"  phase 7, {dtype} step, {stage_glue.TRAIN_WARP} route: the "
             f"bilinear upsample's backward a step: {'; '.join(readings)}  "
             f"[{smi}]")

    upsample_backward_per_step(step, "fp32")
    note(f"  phase 7, FlowNet2 bf16 train step b{TRAIN_BATCH} {TRAIN_HEIGHT}x"
         f"{TRAIN_WIDTH}, {PROFILED_STEPS} steps under torch.profiler "
         f"({stage_glue.TRAIN_WARP} route)")
    step16 = StepFactory(model16, loss_fn, get_optimizer("Adam", 1e-4)) \
        .train_step()
    step16(images, target)
    step_counts16 = profile_families(
        lambda: steps(step16), PROFILED_STEPS, BF16_TRAIN_FAMILIES, smi,
        "step", say=note)[1]
    n_layout = sum(n for key, n in step_counts16.items()
                   if layout.search(key)) / PROFILED_STEPS
    note(f"  phase 7, bf16 step: {n_layout:g} layout-conversion launches a "
         "step")
    k3_per_step(step16, BF16_TRAIN_FAMILIES, "bf16")
    upsample_backward_per_step(step16, "bf16")

    # -- 8. result ------------------------------------------------------------
    note(f"the script took {time.perf_counter() - t_script:.1f} s")
    print("summary of the timed phases:")
    for line in SUMMARY:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-task"]:
        sys.exit(rank_task(sys.argv[2]))
    if sys.argv[1:2] == ["--data-parallel"]:
        sys.exit(multi_card_main())
    sys.exit(main())
