#!/usr/bin/env python3
"""Smoke run of vsrlab_tpu_torch (the PyTorch / CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --pair-times [TREE]     # only the residual pair's device
                                                  # times (bf16 and fp32), for the
                                                  # package in TREE
    python3 chip_smoke.py --sampler-times [TREE]  # only the fused sampler route's
                                                  # device times, the same way
    python3 chip_smoke.py --split-rounding        # a one-process diagnostic of a split's
                                                  # bf16 gradient rounding (PERF.md)
    python3 chip_smoke.py --bvpp                  # phase 1's build, phase 2's sampler
                                                  # checks, phase 16 and the sampler's
                                                  # times at its shapes
    python3 chip_smoke.py --dp-cards              # phase 10 (c) with one rank a card
                                                  # over every visible card (NCCL),
                                                  # train.train under torchrun, phase
                                                  # 11 (a), (b) over the cards, the
                                                  # VRT train step data-parallel and
                                                  # phase 12's, 13's and 15's split
                                                  # steps
    (``--dp-rank DIR``, ``--p11-rank DIR``, ``--vrt-dp-rank DIR``,
    ``--sp-rank DIR`` and ``--vrt-sp-rank DIR`` are one rank of phase 10
    (c), of phase 11 (a), (b), of ``--dp-cards``' VRT step, of phase 12 and
    of phases 13 and 15; the script starts them)

Phases, in order; any failure exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   whether OpenCV and PIL import, then
   the kernel libraries (``residual_pair``, ``packed_gather``,
   ``bilinear_sample``, ``window_attention``) built side by side from
   ``vsrlab_tpu_torch/csrc`` (nvcc, sm_90a) into ``build/kernels/``.
2. Kernels against their plain version, fp32 with TF32 off at 1e-4, bf16
   at 2e-2 (``|a-b| <= tol + tol*|b|``): both residual-pair kernels
   (``taps``, ``im2col``) against ``residual_conv_pair_plain`` at
   ``(1,180,320,64)`` (a recurrence step), ``(10,180,320,64)`` (the
   cleaner), a ragged ``(2,13,21,64)``, the train step's ``(4,64,64,64)``
   and ``(24,64,64,64)`` (64 rows and columns: ragged tiles at both edges)
   and, in bf16, shapes that cross the
   persistent kernels' tilings (one tile exactly, one pixel more, three
   ragged frames that make three rounds of tiles), in fp32 those that
   cross the fp32 kernel's two tiles (12x16 and 12x20: exactly, one pixel
   more, fewer rows than a tile, ragged frames) and the flow trainer's
   cleaner's ``(16,48,64,64)``, each launched three
   times with bitwise-equal results; the sampler kernel
   (``bilinear_sample``) against ``bilinear_sample_plain`` at the
   alignment's 180 images of 128x128x10, a row pitch that is no multiple
   of 16 bytes (9x13x10), C = 4, C = 3 (the generic path), one row, one
   column, one pixel, BasicVSR++'s deformable taps (16 groups of 8
   channels at 180x320) and its state warps (C = 64 at 180x320), on realistic coordinates (the pixel grid plus an
   N(0, 3) residue), uniform ones, far ones (most corners outside) and, in
   zeros mode, ones with +-inf, NaN and +-1e30 among them (the result must
   be 0 there and finite everywhere), in zeros and border mode, three
   launches bitwise equal (in fp32 the kernel rounds as the plain version
   does: max error 0); the row gather (``packed_row_gather``) against
   its plain version, exactly, at the alignment shape (table ``(180,
   8001, 80)``, 16384 pixels an image) with realistic and uniform
   coordinates, at a ragged ``(3, 9, 13, 5)``, and at images smaller than
   one window (8x8x4 with 8 x-positions a row; one row; one column); the
   window attention (``window_attention``) against
   ``window_attention_plain`` at ``ATTENTION_CHECKS`` (the main path's self
   attentions at N 384 and 128, hd 20 and 30, a mutual direction's 64x64
   halves, the trunk's N 64, ``forward_rows``' 128 rows against 384 keys,
   ragged, small, hd 64) on q and k of std 2, bf16 within the card tests'
   gate (each element within ``2^-7 |plain| + 2^-8 max|plain|`` and the rms
   within ``2^-8`` of the output's, which bf16 logits fail), fp32 (TF32
   off) within 2e-5 of the largest |v|, three launches bitwise equal.
3. The RealBasicVSR path: RealBasicVSR 4x at the headline configuration (mid 64,
   30 residual blocks, 20 cleaning blocks, 3 steps, bf16), weights from a
   seeded ``torch.Generator``, serving 180x320 -> 720x1280 requests through
   the harness: ``windowed_inference`` on a 20-frame clip (two 10-frame
   windows as one batch), then ``make_stream_forward`` ``first`` (taps)
   and ``rest`` (im2col) on two consecutive windows. The wrappers count
   their launches by input shape over these three calls; each call must
   make 660 residual-pair launches. Then shapes and finite values, each
   window's kernel output against the plain version's and an fp32 run
   (``rest`` with the state ``first`` returned; gate: twice the plain bf16
   run's deviation from fp32), the frames/s of a 10-frame and a 20-frame
   request, and a torch.profiler breakdown of the 10-frame one (device ms
   of the request and of the pair kernels inside it, beside its frames/s).
   Then the same weights at ``precision: fp32`` (TF32 off): one
   ``make_forward`` 10-frame request through the fp32 pair kernel, exactly
   660 launches by shape, its output within ``FP32_REQUEST_TOL`` of the
   same model on the plain route, its frames/s, device ms and busy share.
4. The VRT path: VRT 4x at the paper configuration (13 depths, 120 x 7 +
   180 x 6 channels, 6 heads, 12 offset groups, window (6, 8, 8), bf16),
   weights from the same kind of generator with the zero-initialised offset
   heads filled (else every offset is the flow prior), serving one
   ``(1,16,256,256,3) -> (1,16,1024,1024,3)`` request through
   ``make_forward`` with the fused sampler kernel and once with the row
   gather kernel. The wrappers count their launches by shape: each request
   must make 126 (7 stages x 2 directions x 9 taps) at the four alignment
   scales (the sampler's keyed ``(180, h, w, 10, h*w)``): every sampler
   call went through a kernel; and 164 window-attention launches, by shape
   those the request's WindowAttention calls imply (read from each call's
   input by a hook, ``attention_plan``). Then shapes and finite values, both
   outputs against the plain route's (the plain sampler and the plain
   attention) and an fp32 run of it (the same gate), the frames/s of the request
   with each sampler, a torch.profiler breakdown of the fused one by
   kernel (the program's counter ``window_attention.launches`` must read
   164 over it), and its device time by module class (CUDA events around every
   forward of WindowAttention, MlpGEGLU, FlowGuidedDeformAlign and
   LayerNorm; SpyNet, the convs and the glue between them are the rest).
   Then the default TinyVRT (8 channels an offset group) on a 6-frame
   64x64 request under the same launch-count and deviation gates, a
   96x96 clip through ``tiled_forward`` (four 64x64 tiles), and a TinyVRT
   of 4 channels an offset group on a 32x32 request (C = 4 for the sampler
   kernel; both kernel samplers are also held against the four-corner one
   at its 8x8 stage's shape, where the row gather's table, at 8 x-positions
   a row, is zero-padded to one window).
5. RealBasicVSR training, the shape of the JAX bench's train leg
   (``bench.py:292-297``): batch 4 of 6-frame 64x64 LR crops, HR 256x256,
   uniform in [0, 1) from a seeded numpy generator, the headline model in
   bf16 (fp32 parameters), Adam at 1e-4, clip 1.0, through the port's own
   ``make_supervised_train_step``. cuDNN's TF32 is on for the bf16 runs
   (PyTorch's default; their fp32 convs multiply bf16 values, which TF32
   holds exactly) and off for the fp32 references. Gates: each pair kernel's
   launch plan at both training shapes, and ``ResidualPair`` (kernel
   forward, PyTorch backward) against autograd through the plain version
   there, the output and ``dx, dW1, db1, dW2, db2`` (fp32 at 1e-4; bf16 within
   twice the plain bf16 path's deviation from fp32, max and rms); one step's
   gradient of every parameter tensor with ``taps`` against ``plain`` and an
   fp32 run by the same rule, finite and nonzero outside SpyNet, zero in it;
   the main path, one step with ``taps`` then one with ``im2col``, each
   exactly 60 launches at ``(24,64,64,64)`` and 360 at ``(4,64,64,64)``; the
   loss falling over 20 steps on the batch, SpyNet unmoved; the trained
   weights served (no grad) with ``taps`` within the same gate of fp32. Then
   the step's ms and train frames/s (median of 5 after 2, host clock with
   synchronize), its peak memory and a torch.profiler breakdown by part
   (tracing the card alone), with ``taps`` (the ``plain`` yardstick's step
   is no longer timed: PERF.md holds its figures). Last,
   ``train.run`` on SyntheticVSR (8 clips of 6x256x256, batch 4, one epoch
   with eval) writes a checkpoint and a JSONL log under
   ``build/chip_smoke_train/``, and a second run restored from it with
   ``restore_opt`` (its parameters equal to those saved) trains a second
   epoch.
6. Each kernel at every input shape its paths gave it: bf16 against
   the plain version (2e-2), then its device time, the plain version's and
   one library call's (the residual pair: two bf16 channels_last
   ``F.conv2d`` plus ReLU and the add; the sampler: one ``F.grid_sample``,
   NCHW, normalised grid, align_corners, zeros; the row gather: one
   ``index_select`` of the flattened table; the window attention:
   ``F.scaled_dot_product_attention`` with bias and mask summed into one
   bf16 additive mask; timed only), each by CUDA-graph
   replay (calls captured in a graph, median of 20 replays: a launch from
   Python takes longer than many of these kernels run), and each kernel's
   share of its bound; at the training shapes also the unit's backward
   (``pair_grads``) beside its bound and autograd through the library
   forward (forward and backward to every operand); the fp32 kernel at the fp32 paths' shapes (phase 3's
   request, phase 9's cleaner) beside cuDNN with TF32 off (its
   ``library_ms``) and on (``library_tf32_ms``, for information). The sampler and the row gather run on the same
   realistic operands at each image size; beside the row gather, the
   ``take`` route's table and fields. For the residual pair also the time
   of the calls made one by one from Python and the tiling the library
   gives the launch, then the host's time for one batch-1 launch, split:
   the library's two entries, the checks, the wrappers, the module's call,
   the custom ops an exported program calls, and for one unit of a train
   step: forward, backward and their parts.
7. Serving from a checkpoint (run after phase 5; phases 8 and 6 and the JSON
   lines follow it), at the headline width: (a) run directories written by
   ``convert.write_run_dir`` from phase 3's seeded weights as numpy trees,
   with an EMA sidecar that differs: ``load_test_model`` serves the EMA
   (output bitwise equal to ``make_forward`` on a module loaded with the
   EMA state_dict), the raw weights with ``use_ema=False``, and the raw
   weights with a warning for a sidecar at a stale key; (b)
   ``evaluate_video`` on a 20-frame 180x320 LR clip (``bicubic_down`` of a
   seeded 720x1280 SyntheticVSR clip) as two windows, 660 taps launches a
   window, PSNR / SSIM within 0.05 dB / 1e-3 of the plain pair's; (c)
   ``make_forward(tile=128, tile_overlap=16)`` bitwise equal to
   ``tiled_forward`` called directly; (d) the upscale loop with
   ``stream=True`` over three windows from memory (im2col), bitwise equal to
   a ``first`` / ``rest`` chain, with its frames/s; (e) ``export_model`` at
   ``(1,4,180,320,3)`` and ``load_exported`` of the headline cut to
   ``EXPORT_DEPTH`` (6 residual and 4 cleaning blocks, 64 channels) from a
   run directory of its own (the export's trace and load grow with the
   blocks and with the frames the recurrences unroll; PERF.md gives their
   seconds): 60 taps launches a call through the custom op (48 and
   12 by shape), bitwise equal to ``make_forward``, export seconds, MB and
   frames/s beside ``make_forward``'s; (f) ``speed_bench``
   and ``param_count``; (g) a paper-configuration VRT run directory served
   by ``make_forward(tile=128)`` on ``(1,16,256,256,3)``: 126 fused-sampler
   launches a tile and the window attention's its calls imply (164 a
   tile), finite, timed once. Beside them a torch.profiler
   breakdown of the streamed loop, the exported forward and
   ``make_forward``, and one request under ``utils.profiler.trace`` (its
   Chrome trace holds kernel events and the request's span). The launches
   count into the ``kernels`` line.
8. GAN fine-tuning (run after phase 7; it restores phase 5's checkpoint),
   the shape of the JAX bench's GAN leg (``bench.py:585-647``): the headline
   RealBasicVSR (phase 3's seeded weights) and ``UNetDiscriminator(64)`` in
   bf16, ``PerceptualLoss(1e-2)`` with an fp32 VGG19, adversarial weight
   2e-5, batch 4 of 6-frame 64x64 LR, HR 256x256, Adam 1e-4 with a clip of
   1.0 on both networks, through ``train.gan.make_gan_train_step``. (a)
   Gates: one step's gradient of every G and D parameter with ``taps``
   against ``plain`` and an fp32 run (phase 5's rule), D's ``u`` / ``sigma``
   after its half against the fp32 run's (rtol 1e-5); 420 taps launches a
   step (60 at ``(24,64,64,64)``, 360 at ``(4,64,64,64)``), in an updating
   and in a frozen step; the frozen step leaves G bitwise unchanged and
   moves D and every ``u``; 20 steps with every loss finite. (b) The step's
   ms and frames/s (median of 5 after 2) with ``taps`` (``plain`` as in
   phase 5), peak memory, device ms and busy share (torch.profiler
   tracing the card alone), and the device ms of
   each part run alone: G's forward and backward, the VGG19 loss, D in the G
   half, the D half, the optimizers. (c) ``train.gan.run`` restored from
   phase 5's checkpoint (``finetune``) on SyntheticVSR at HR 256x256,
   degraded by JPEG (quality 30-95) and the codec emulator (CRF 18-35, fps
   10-30), two epochs of two steps (the first with G frozen: its checkpoint
   must equal phase 5's weights), checkpoints under
   ``build/chip_smoke_gan/``, 2,520 taps launches; ``load_test_model`` then
   serves the last checkpoint on a 10-frame 180x320 request (660 launches),
   bitwise equal to a module loaded with those weights. (d) The host ms of
   the degradation pipeline a clip at 6x64x64 and 10x180x320.
9. The flow paths (run after phase 8, before phase 6), all fp32 as the
   JAX flow models run, TF32 off for the gates, weights from seeded
   ``torch.Generator``s, under ``build/chip_smoke_flow/``: (a) the sampler's
   gradient, ``BilinearSample`` (kernel forward, ``sample_grads`` backward)
   against autograd through ``bilinear_sample_plain`` in fp64 at RAFT's level-0
   lookup ``(3072, 48, 64, 1, 49)``, the alignment's ``(180, 128, 128, 10)``
   and a three-channel warp, zeros and border, realistic, far and
   non-finite coordinates (1e-4, finite), with the backward's device time
   beside its bound and ``F.grid_sample``'s forward and backward; (b)
   ``create_flow_dataset.main`` over 3 seeded 384x512 frames with a
   surrogate ``raft-small`` checkpoint: 48 sampler launches a pair, 12 at
   each level's shape, the flows with the kernel against the plain route
   (1e-3 px), ms a pair, device ms, busy share and the lookups' share; (c)
   ``OpticalFlowConsistency`` on SR / HR clips ``(4, 6, 256, 256, 3)``: 48
   launches a branch, the SR branch's through ``BilinearSample``, the loss
   and its gradient to SR against the plain route (1e-4 of the gradient's
   largest value), ms forward and backward, peak memory; (d)
   ``train.spynet.run`` over the 6-level curriculum of
   ``conf/train/spynet.yaml`` (batch 8, Adam, cosine, clip 1) on
   ``SyntheticFlowDataset`` with 8 samples a split and one epoch a level:
   every level's checkpoint and ``final``, a resume from ``start_k = 5``
   restoring levels 0-4 as saved, ``max(k, 1)`` sampler launches a step at
   level k by shape, one level-5 step's gradients with the kernel against
   the plain route (1e-4 of each tensor's largest value), the step's ms,
   pairs/s, device ms, busy share and peak memory with TF32 off and on, the
   loader's host ms a batch apart, and a level-1 run with a cleaner (mid
   64, 20 blocks, fp32): 60 residual-pair launches a cleaner call; (e)
   ``IRRPWCNet`` on one 384x512 pair: 18 warps by shape, its flows with the
   kernel against the plain route (1e-3 px). The launches count into the
   ``kernels`` line; phase 6 times the sampler at these shapes in fp32
   and the pair at the cleaner's shape in fp32.
10. VRT training and data parallelism (run after phase 9, before phase 6):
   (a) ``+experiment=vrt`` through the port's config: the paper VRT of
   ``conf/train/model/vrt.yaml`` (``remat: true``) with its 80 blocks cut
   to ``VRT_TRAIN_DEPTHS`` (3 a Stage: two window-2 blocks, the second
   shifted, and one window-6 block; 2 a trunk RTMSA, the second shifted;
   widths, heads and offset groups kept; 30.68 M parameters at full
   depth), as in phases 11 (b), 13 and 15,
   bf16, seeded weights with the offset heads drawn, a batch of 8 clips of
   6 frames at 64x64 -> 256x256 in 4 microbatches of 2, Adam 1e-4 (0.9,
   0.99), the cosine schedule, clip 1.0, through
   ``make_supervised_train_step``. Gates: on one microbatch the SR output
   and every parameter's gradient with the ``fused`` and the ``take``
   kernels each within twice plain bf16's deviation from the fp32 plain
   route (the plain sampler and the plain attention), SpyNet's gradients
   zero, each route's launches by shape those of one forward and backward
   with every Stage recomputed (twice ``expected_vrt_launches``; the window
   attention's those its calls imply, the recompute's included); the
   window attention on its own: the fused route with the kernel against it
   with the plain version in the kernel's place, each against the fp32
   plain route (``gate_attention_grads``); the main path, one step with
   ``fused`` and one with ``take``, each exactly 4 microbatches' launches
   by shape; the
   losses finite, SpyNet bitwise unchanged. Then the step's ms and train
   frames/s (one step, after the two main-path steps; the whole step is
   not profiled), one microbatch's device ms by
   part (attention, MLP, LayerNorm and SpyNet, forward with the recompute
   and backward; the sampler kernel; ``sample_grads``; the rest), and a
   microbatch's peak memory with and without remat. (b) At every shape (a)
   gave the samplers: ``PackedRowGather`` against autograd through the
   plain gather (fp32 1e-4, bf16 2e-2 of the largest gradient) and
   ``BilinearSample`` (fp32, 1e-4), then ``gather_grads`` and
   ``sample_grads`` timed by graph replay in bf16 beside their bounds,
   ``index_select`` + ``index_add_`` and ``F.grid_sample`` forward +
   backward. (c) Two gloo ranks on the one card (subprocesses with
   torchrun's environment; NCCL refuses two ranks on one device), each
   training the headline RealBasicVSR at ``precision: fp32`` (TF32 off) on
   2 of the train leg's 4 clips for 2 steps: the ranks' parameters bitwise
   equal after each step, the first step's averaged gradient within
   ``1e-5 + 1e-4*|b|`` of this process's gradient on the 4 clips, 420 pair
   launches a step on each rank by shape; the step's ms beside one
   process's on the 4 clips, the all-reduce's ms; then a one-rank NCCL
   group and an all-reduce. (d) The phase's wall seconds.
   ``--dp-cards`` runs (c) alone with one rank a card over every visible
   card (two or more; NCCL, each rank on ``cuda:LOCAL_RANK``, the 4 clips
   split over the ranks) under the same gates, then ``python -m
   torch.distributed.run`` of ``vsrlab_tpu_torch.train.train`` on
   SyntheticVSR over those cards (the trainer's barrier after each save
   and its replica check after each epoch), then phase 11 (a) on a
   40-frame clip over ``time = N`` (one window a card) and (b) over
   ``model = 2`` (``data = N / 2``) under phase 11's gates against card 0,
   with frames/s against one card, then the ``+experiment=vrt`` step with
   the 8 clips split over the cards (one microbatch of one card's size a
   rank) beside one card's step: device ms, then the step's ms. It ends in
   the same last line with ``count`` the cards used.
11. The ``time`` and ``model`` mesh axes and the host data core (run after
   phase 10, before phase 6): two gloo ranks sharing the card (subprocesses
   with torchrun's environment, ``--p11-rank``), started once for (a) and
   (b), against this process's unsharded runs. (a) ``create_mesh({"time":
   2})`` serves windowed20 (the headline model, bf16, a ``(1,20,180,320,3)``
   clip in 2 windows of 10, one a rank) through ``windowed_inference(...,
   mesh)``: each rank's gathered result bitwise equal to this process's
   forward of each window alone (a rank runs its window at batch 1), within
   twice plain bf16's deviation of this process's windowed20 as one batch
   of 2, 660 pair launches on each rank by shape; a rank's ms beside one
   process's. (b) ``create_mesh({"model": 2})`` inside ``use_mesh``: the
   paper VRT of ``conf/train/model/vrt.yaml`` at phase 10's depth with ``head_shard_axis=
   "model"`` (3 of its 6 heads a rank) on a ``(1,6,64,64,3)`` request in
   bf16 with the fused sampler and with the row gather: within twice plain
   bf16's deviation from the fp32 plain route, the samplers' launches by
   shape those of one unsharded request, and one fp32 backward's gradients
   (remat, made whole by ``parallel.all_reduce_sharded_grads``, the train
   step's own reduction) bitwise equal on the
   two ranks and within ``1e-5 + 1e-4|b|`` of the unsharded ones; a rank's
   ms beside one
   process's. (c) ``libvsrio`` built with g++ on the card's host (a failed
   build fails the phase; whether its OpenCV half was built is printed),
   ``codec_degrade`` on the native path within 1e-5 of ``force_numpy=True``,
   and the codec's ms a level-5 flow sample, the sample's and phase 9's
   loader's ms a batch of 8, native and numpy side by side. (d) The
   phase's wall seconds. The ranks' launches count into the ``kernels``
   line.
12. Sequence-parallel training over the ``time`` axis (run after phase 11,
   before phase 6): this process's runs of the headline RealBasicVSR on the
   train leg's 4 clips of 6 frames (the eval metrics and one step's loss
   and gradients in fp32 with TF32 off; the plain route's bf16
   gradients; the bf16 step's ms, device ms and peak memory), then two
   gloo ranks sharing the card (``--sp-rank``), each holding 3 frames of
   every clip (``shard_batch_sp`` over ``create_mesh({"data": 1, "time":
   2})``), the model built with ``time_shard_axis="time"`` and each step
   ``make_supervised_train_step(model, group=mesh.mesh_group)`` inside
   ``use_mesh``: the carries of both recurrences and a halo frame each way
   handed between the ranks, gradients included. Gates: each rank's eval
   metrics within rtol 1e-5 of this process's; the fp32 step's loss within
   rtol 1e-5 and the gradients the update averaged within ``1e-5 +
   1e-4|b|`` of this process's; the bf16 step's within twice plain bf16's
   deviation from fp32 (phase 5's rule); the ranks' parameters bitwise
   equal after each step; each step's pair launches on a rank, 60 at
   ``(12,64,64,64)`` and 180 at ``(4,64,64,64)``. Then a rank's bf16 step
   ms, device ms and peak memory beside this process's. ``--dp-cards``
   runs it with one NCCL rank a card, ``data = 2 x time = 2`` on four cards
   (``time = 2`` on two), against card 0's one-process step.
13. Sequence-parallel VRT training over the ``time`` axis (run after phase
   12, before phase 6): this process's runs of the paper VRT
   (``+experiment=vrt`` at phase 10's depth, ``remat``) on one microbatch of 2 clips x 6
   frames of 64x64 (one fp32 forward and backward with TF32 off, the plain
   route's bf16 gradients, the bf16 step's ms, device ms, busy share and
   peak memory, and the peak of one step without ``remat``), then two gloo
   ranks sharing the card (``--vrt-sp-rank``), 3 frames of each clip a
   rank, the model built with ``time_shard_axis="time"``: the frames of
   every attention window that straddles the ranks, the edge LR frames and
   each Stage's edge features handed between them, gradients included.
   Gates: each rank's fp32 loss within rtol 1e-5 and the averaged fp32
   gradients within ``1e-5 + 1e-4|b|`` of this process's; the bf16 ones
   within twice the deviation from fp32 of the plain route on the ranks
   (split alike: a split rounds each rank's partial sums, so one
   process's plain bf16 is no yardstick; its ratio is printed); SpyNet's
   gradients zero; the ranks' parameters bitwise equal after each step;
   each rank's sampler launches by shape in its fp32 and bf16 steps (the
   fused kernel) and in one ``take`` step (the row gather). Then a rank's
   bf16 step ms, device ms, busy share and peak memory with and without
   ``remat`` beside this process's. ``--dp-cards`` runs it with one NCCL
   rank a card, ``data = 2 x time = 2`` on four cards.
15. VRT over ``time`` and ``model`` at once (run after phase 13, before
   phase 14): phase 13's ranks on ``create_mesh({"time": 2, "model":
   2})``, four gloo ranks sharing the card, the model built with
   ``time_shard_axis="time"`` and ``head_shard_axis="model"``: 3 frames
   of each clip and 3 of the 6 heads a rank; each model line fetches its
   windows' frames on its own time line, then splits the heads (one
   all-reduce an attention on the model line); the step
   ``make_supervised_train_step(model, group=mesh.mesh_group)`` sums the
   heads' gradients over the model line, then the updater averages over
   the mesh. Gates, against phase 13's one-process runs: phase 13's (fp32
   loss, fp32 and bf16 gradients, SpyNet's zero, parameters bitwise equal
   after each step, each step's sampler launches by shape on each rank,
   the row gather's in one ``take`` step) and each rank's heads; then one
   bf16 request through ``windowed_inference`` of a ``(1,12,64,64,3)``
   clip in windows of 6 over the same mesh (one window a time rank, its
   heads split): one window's sampler launches by shape a rank, every
   rank's result bitwise equal, within twice plain bf16's deviation from
   this process's fp32 run of the clip and of its bf16 request. A rank's
   bf16 step ms, device ms, busy share and peak memory beside phase 13's
   rank and this process. ``--dp-cards`` runs it with one NCCL rank a card
   on four cards.
14. Reference checkpoints (run after phase 13, before phase 6), at the
   headline width under ``build/chip_smoke_import/``: (a) phase 3's seeded
   weights written as a reference vsrlab RealBasicVSR checkpoint
   (``{"epoch", "model_state_dict"}``, the reference's names from a key map
   in this script, SpyNet's ``mean`` / ``std`` included), loaded by
   ``load_reference_checkpoint`` + ``load_torch_realbasicvsr`` with
   ``strict=True``: a 10-frame 180x320 request bitwise equal to phase 3's
   model, 660 taps launches; (b) the acceptance command
   (``evaluation.acceptance.main``) on a REDS4-layout folder of two
   10-frame SyntheticVSR clips, one paired (720x1280 HR and its LR), one
   HR-only at 722x1283 (cropped, LR derived): fp32 (TF32 off), ``--bf16``
   and ``--bf16 --stream`` (two windows of 5 a clip), each against the
   same model evaluated directly (``evaluate_video``, or a ``first`` /
   ``rest`` chain) as ``--published-psnr`` with a bar of 0.001 dB: exit 0,
   the pair's launches by shape as the windows predict, frames/s beside
   ``make_forward``'s; (c) phase 4's seeded paper VRT written in the
   reference's layout (Conv3d ``(O, I, 1, 3, 3)`` kernels,
   ``conv_offset.{0,2,4,6}``, trunk ``stage8``, ``optical_flow.*`` with
   ``mean`` / ``std``, every attention's ``relative_position_index``) as
   ``{"params": ...}``, imported with ``n_scale_stages=7``: phase 4's
   request bitwise equal, 126 fused launches; then ``--model vrt --bf16
   --tile 128 --window 16`` on one 16-frame 256x256 LR clip against the
   tiled model evaluated directly (``--align-chunks 0``: the alignment in
   one batch, as phase 4 runs it; the default 30 runs it one frame a chunk,
   15x the launches and ~4x the time), 126 fused launches a tile. The
   phase's wall seconds. The launches count into the ``kernels`` line.
16. BasicVSR++ (run after phase 14, before phase 6) at mmagic's
   ``basicvsr-pp_c64n7`` widths (64 channels, 7 units a branch, 16 offset
   groups, bf16, the offset heads drawn), one whole 100-frame 180x320 clip
   through ``make_forward``: the request that captures the alignments'
   CUDA graphs, a replayed one and the eager route, the kernels' counts
   zeroed before each and gated by shape (``bvpp_launches``: the pair 10
   times at 100 frames and 2,800 at one, the sampler 788 state warps, 392
   flow warps and 3,564 deformable taps at ``(16, 180, 320, 8)``; a replay
   counts its graph's launch plan), the graphed outputs bitwise the eager
   one, then frames/s of replayed requests. The launches count into the
   ``kernels`` line.
17. One JSON line ``{"kernels": [...]}``: per kernel its main-path launches
   (inference, training, serving, GAN fine-tuning, the flow paths, VRT
   training, the ranks of phases 11 to 13 and 15, phase 14's imported
   models and phase 16's BasicVSR++; the window attention's: phase 4's requests, phase 7 (g)'s tiles
   and phase 10 (a)'s steps) and,
   summed over those launches (per-launch time at each shape times that
   shape's count), ``ms``, ``plain_ms``,
   ``library_ms`` and ``bound_ms``; ``max_abs_err`` is the largest bf16
   error, beside ``max_abs_err_fp32`` (for the window attention
   ``gate_share`` and ``gate_share_fp32``, the largest share of its gate);
   ``shapes`` holds the per-launch rows
   (``dtype`` in each); for the two samplers ``backward`` holds phase 10
   (b)'s rows. Then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# the training step's shapes: the recurrences at batch 4, the cleaner at 4 x 6 frames
TRAIN_SHAPES = ((4, 64, 64, 64), (24, 64, 64, 64))
CHECK_SHAPES = ((1, 180, 320, 64), (10, 180, 320, 64), (2, 13, 21, 64)) + TRAIN_SHAPES
# bf16 only: one tile of each tiling exactly, one pixel more in H and W, and
# three ragged frames that make three rounds of the taps kernel's deep tiles
EDGE_SHAPES = ((1, 15, 30, 64), (1, 16, 31, 64), (1, 7, 30, 64), (1, 8, 16, 64), (1, 9, 17, 64),
               (3, 121, 151, 64))
# fp32: the fp32 kernel's 12x16 output tile exactly, one pixel more in H and
# W, fewer rows than a tile, five ragged frames in five rounds of tiles;
# then frames it cuts into 12x20 tiles: three ragged ones, exactly whole
# tiles and one pixel more in H and W
FP32_EDGE_SHAPES = ((1, 12, 16, 64), (1, 13, 17, 64), (1, 7, 30, 64), (5, 121, 151, 64),
                    (3, 121, 151, 64), (1, 168, 300, 64), (1, 169, 301, 64))
# the flow trainer's cleaner (16 frames of 48x64, PR 8's phase 9 shape)
CLEANER_SHAPE = (16, 48, 64, 64)
TOL = {"fp32": 1e-4, "bf16": 2e-2}
# the fp32 request's output against the plain route's, absolute, on outputs
# of about unit range: the two add each conv's products in other orders
# (~1e-6 a pair) through 30 blocks a step of a 10-step recurrence each way
FP32_REQUEST_TOL = 1e-3
# residual pairs per forward of one 10-frame window: 2 directions x 10
# steps x 30 blocks, and 3 cleaning steps x 20 blocks
LAUNCHES_PER_FORWARD = 660
# RealBasicVSR as the JAX headline builds it (bench.py:170-176)
HEADLINE = {"mid_channels": 64, "res_blocks": 30, "cleaning_blocks": 20, "cleaning_steps": 3}
# the train step (bench.py:292-297): batch 4 of 6-frame 64x64 LR crops, HR x4;
# its pair launches: the cleaner 3 x 20 at 24 frames, the recurrences 2 x 6 x 30
TRAIN_CLIP = (4, 6, 64, 64)
TRAIN_LAUNCHES = {(24, 64, 64, 64): 60, (4, 64, 64, 64): 360}
# phase 7 (e) exports the headline at this depth (its width kept) on this many frames:
# torch.export's trace and the artifact's load grow with the blocks and with the frames the
# recurrences unroll (their seconds at each size: PERF.md)
EXPORT_DEPTH = {"res_blocks": 6, "cleaning_blocks": 4}
EXPORT_FRAMES = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNELS = {
    "taps": ("residual_conv_pair", "vsrlab_tpu/ops/pallas_conv.py:86"),
    "im2col": ("residual_conv_pair_im2col", "vsrlab_tpu/ops/pallas_conv.py:185"),
}
SOURCE = "vsrlab_tpu_torch/csrc/residual_pair.cu"
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PROBE = "scripts/bench_pallas_deform_gather.py"
# name -> (source, the TPU kernel it replaces, TPU kernels of the same function)
VRT_KERNELS = {
    "bilinear_sample": ("vsrlab_tpu_torch/csrc/bilinear_sample.cu", f"{PROBE}:278", []),
    # pallas_loop, pallas_blk and pallas_take compute one function
    "packed_row_gather": ("vsrlab_tpu_torch/csrc/packed_gather.cu", f"{PROBE}:149",
                          [f"{PROBE}:202", f"{PROBE}:237"]),
    # no TPU kernel stands behind it: the JAX package leaves window attention to XLA
    # (einsum, add, softmax, einsum)
    "window_attention": ("vsrlab_tpu_torch/csrc/window_attention.cu", None, []),
}
SAMPLERS = ("bilinear_sample", "packed_row_gather")
# window-attention launches of one paper-configuration VRT forward: 7 Stages of 6 mutual
# blocks (self attention and two mutual directions) and 2 self-attention blocks, and
# 6 trunk groups of 4 self-attention blocks
VRT_ATTENTION_LAUNCHES = 7 * (6 * 3 + 2) + 6 * 4
# (name, windows, heads, nq, nk, hd, bias, masks): the main path's attentions at a
# few windows (Stages: self over (6,8,8) at hd 20, over (2,8,8) and the mutual halves;
# the trunk's (6,8,8) and (1,8,8) at hd 30; forward_rows' rows), then ragged and
# small sizes and the widest head the kernel takes
ATTENTION_CHECKS = (
    ("self384", 24, 6, 384, 384, 20, True, True), ("self384_hd30", 16, 6, 384, 384, 30, True, False),
    ("self128", 32, 6, 128, 128, 20, True, True), ("mutual64", 32, 6, 64, 64, 20, False, True),
    ("trunk64", 32, 6, 64, 64, 30, True, False), ("rows", 8, 6, 128, 384, 20, True, True),
    ("ragged", 5, 3, 50, 77, 12, True, True), ("small", 9, 2, 12, 12, 6, True, True),
    ("hd64", 4, 2, 384, 384, 64, True, True))
# (images, H, W, channels a group, x-positions a row); the first is the probe's shape
PACKED_CHECKS = ((180, 128, 128, 10, 2), (3, 9, 13, 5, 2), (24, 8, 8, 4, 8), (2, 1, 5, 3, 2),
                 (2, 4, 1, 4, 8))
# (images, H, W, C): the alignment's 128x128 stage, a row pitch that is no
# multiple of 16 bytes (W = 13), C = 4, C = 3 (the generic path), one row,
# one column, one pixel; BasicVSR++'s deformable taps (16 groups of 8
# channels at 180x320) and its state warps (C = 64)
SAMPLER_CHECKS = ((180, 128, 128, 10), (3, 9, 13, 10), (24, 8, 8, 4), (3, 9, 13, 3),
                  (2, 1, 5, 10), (2, 4, 1, 4), (1, 1, 1, 10), (16, 180, 320, 8),
                  (1, 180, 320, 64))
SAMPLER_KINDS = ("realistic", "uniform", "far", "nonfinite")
VRT_CLIP = (1, 16, 256, 256, 3)
# BasicVSR++ at mmagic's basicvsr-pp_c64n7 widths, a whole 100-frame REDS clip a request
BVPP = {"mid_channels": 64, "num_blocks": 7, "max_residue_magnitude": 10.0, "deform_groups": 16,
        "upscale": 4}
BVPP_FRAMES = 100
# phase 7: the served LR frame size (the headline's) and the tile of the tiled requests
SERVE_LR = (180, 320)
SERVE_TILE = 128
VRT_SCALES = (1, 2, 4, 8, 4, 2, 1)
VRT_GROUPS, VRT_CG, VRT_GP = 12, 10, 2


def log(msg: str) -> None:
    print(msg, flush=True)


class Laps:
    """Host seconds between marks: ``laps(label)`` closes the part since the
    previous mark; :meth:`log` prints them on one line."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), []

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.parts.append((label, round(now - self.t, 1)))
        self.t = now

    def log(self, what: str) -> None:
        log(f"  {what} took " + ", ".join(f"{k} {v:.1f}" for k, v in self.parts) + " s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def pair_operands(shape, dtype, seed, device):
    """x ~ N(0, 1); weights and biases at torch's default conv init scale."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    bound = 1.0 / (9 * c) ** 0.5
    x = torch.randn(shape, generator=g)
    w1, w2 = ((torch.rand((3, 3, c, c), generator=g) * 2 - 1) * bound for _ in range(2))
    b1, b2 = ((torch.rand((c,), generator=g) * 2 - 1) * bound for _ in range(2))
    return (x.to(device, dtype), w1.to(device, dtype), b1.to(device),
            w2.to(device, dtype), b2.to(device))


def cuda_ms(fn, reps: int, samples: int = 20, warmup: int = 3) -> float:
    """Median ms of one ``fn()`` over ``samples`` event-timed runs of ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, samples: int = 20) -> float:
    """Median device ms of one ``fn()``: ``calls`` of them captured in a CUDA
    graph, the graph replayed ``samples`` times between events. Unlike
    :func:`cuda_ms` it holds no time of the Python that launches."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(shape, dname: str = "bf16") -> tuple[float, str]:
    """Least time (ms) for one pair in ``dname`` (bf16 on the tensor cores,
    fp32 outside them): FLOPs over peak vs bytes over HBM rate."""
    b, h, w, c = shape
    item = 2 if dname == "bf16" else 4
    flops = 2 * (2 * b * h * w * c * c * 9)
    nbytes = 2 * b * h * w * c * item + 2 * 9 * c * c * item + 2 * c * 4
    peak = PEAK_BF16_FLOPS if dname == "bf16" else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_backward_bound(shape) -> tuple[float, str]:
    """Least time (ms) of one bf16 ``pair_grads``: five convolutions' FLOPs
    (conv1 recomputed, the data and weight gradients of both convs) on the
    tensor cores; ``x`` and ``g`` read once, ``dx`` written once, both
    weights read and their gradients written once, biases and theirs."""
    b, h, w, c = shape
    flops = 5 * (2 * b * h * w * c * c * 9)
    nbytes = 3 * b * h * w * c * 2 + 4 * 9 * c * c * 2 + 4 * c * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_pair(fn, ops, tol, label, repeats: int = 1) -> float:
    """max |fn - plain| on ``ops``; raises beyond ``tol + tol*|plain|``, and
    when one of ``repeats`` launches differs from the first in any bit."""
    import torch

    from vsrlab_tpu_torch.ops.residual_pair import residual_conv_pair_plain

    first = fn(*ops)
    same = all(torch.equal(fn(*ops), first) for _ in range(repeats - 1))
    got, want = first.float(), residual_conv_pair_plain(*ops).float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    e = float(err.max())
    log(f"  {label}: max|kernel-plain| = {e:.3e} (tol {tol} + {tol}*|plain|) "
        f"{'ok' if ok else 'FAIL'}"
        + (f", {repeats} launches bitwise {'equal' if same else 'DIFFERENT'}"
           if repeats > 1 else ""))
    if not ok or not same:
        raise AssertionError(f"{label} disagrees with the plain version or with itself")
    return e


def check_kernels(device):
    """Phase 2. Returns ``{formulation: {"fp32": err, "bf16": err}}``."""
    import torch

    from vsrlab_tpu_torch.ops.residual_pair import PAIR_IMPLS

    errs = {}
    for form in KERNELS:
        errs[form] = {}
        for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            shapes = CHECK_SHAPES + (EDGE_SHAPES if dname == "bf16"
                                     else FP32_EDGE_SHAPES + (CLEANER_SHAPE,))
            errs[form][dname] = max(
                check_pair(PAIR_IMPLS[form], pair_operands(shape, dtype, i, device),
                           TOL[dname], f"{form:6s} {dname} {shape}", repeats=3)
                for i, shape in enumerate(shapes))
    return errs


def time_kernel(form, launches_by_shape, device, dtype=None):
    """Phase 6 for one kernel: at each shape the main path gave it, a check
    against the plain version in the path's type (bf16; fp32 for the fp32
    request and the flow trainer's cleaner; three launches bitwise equal)
    and per-launch device times (graph replay), the time of eager calls
    from Python beside the kernel's. Returns the largest
    error and one row per shape."""
    import torch
    import torch.nn.functional as F

    from vsrlab_tpu_torch.ops.residual_pair import (
        PAIR_IMPLS, pack_weight_fragments, pair_grads, pair_launch_plan, residual_conv_pair_plain)

    dtype = dtype or torch.bfloat16
    dname = "bf16" if dtype == torch.bfloat16 else "fp32"
    err, rows = 0.0, []
    for shape, n in sorted(launches_by_shape.items()):
        x, w1, b1, w2, b2 = ops = pair_operands(shape, dtype, 7, device)
        err = max(err, check_pair(PAIR_IMPLS[form], ops, TOL[dname], f"{form:6s} {dname} {shape}",
                                  repeats=3))
        if form == "taps" and dname == "bf16":  # timed as the model calls it: the weights' kernel order laid out once
            fragments = pack_weight_fragments(w1), pack_weight_fragments(w2)
            fn = functools.partial(PAIR_IMPLS[form], *ops, fragments=fragments)
        else:
            fn = functools.partial(PAIR_IMPLS[form], *ops)
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        wc1, wc2 = (w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    for w in (w1, w2))
        bb1, bb2 = b1.to(dtype), b2.to(dtype)

        def library():
            return xc + F.conv2d(torch.relu(F.conv2d(xc, wc1, bb1, padding=1)), wc2, bb2,
                                 padding=1)

        reps = 10 if shape[0] < 10 else 3
        b_ms, b_by = bound(shape, dname)
        row = {
            "shape": list(shape),
            "dtype": dname,
            "launches": n,
            "ms": graph_ms(fn),
            "plain_ms": graph_ms(lambda: residual_conv_pair_plain(*ops)),
            "library_ms": graph_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "eager_ms": cuda_ms(fn, reps),
            "library_eager_ms": cuda_ms(library, reps),
        }
        row["share_of_bound"] = b_ms / row["ms"]
        if dname == "fp32":  # the yardstick is cuDNN with TF32 off (library_ms); TF32 on for information
            before = tf32(True)
            row["library_tf32_ms"] = graph_ms(library)
            tf32(before)
        if shape in TRAIN_SHAPES and dname == "bf16":  # the unit's backward in a train step (TF32 on, as there)
            g = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(device,
                                                                                 torch.bfloat16)
            leaves = [t.detach().requires_grad_(True) for t in (xc, wc1, bb1, wc2, bb2)]
            gc = g.permute(0, 3, 1, 2)

            def library_grads():  # autograd through the library forward, to every operand
                xl, k1, c1, k2, c2 = leaves
                out = xl + F.conv2d(torch.relu(F.conv2d(xl, k1, c1, padding=1)), k2, c2,
                                    padding=1)
                return torch.autograd.grad(out, leaves, gc)

            before = tf32(True)
            row["backward_ms"] = graph_ms(lambda: pair_grads(*ops, g))
            row["library_fwd_bwd_ms"] = graph_ms(library_grads)
            tf32(before)
            row["backward_bound_ms"], row["backward_bound_by"] = pair_backward_bound(shape)
            row["backward_share_of_bound"] = row["backward_bound_ms"] / row["backward_ms"]
        rows.append(row)
        plan = pair_launch_plan(form, shape, device, dtype)  # the library's own account, not measured
        tiling = (f"; {plan['tiles']} tiles of {plan['tile'][0]}x{plan['tile'][1]}, "
                  f"{plan['rounds']} rounds")
        log(f"  {form:6s} {dname} {shape} x{n}: kernel {row['ms']:.4f} ms "
            f"({100 * row['share_of_bound']:.1f} % of its bound, {b_ms:.4f} ms by {b_by}"
            f"{tiling}), plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms; called "
            f"one by one from Python: kernel {row['eager_ms']:.4f} ms, library "
            f"{row['library_eager_ms']:.4f} ms"
            + (f"; cuDNN with TF32 on {row['library_tf32_ms']:.4f} ms" if "library_tf32_ms" in row
               else "")
            + (f"; the unit's backward {row['backward_ms']:.4f} ms ("
               f"{100 * row['backward_share_of_bound']:.1f} % of its bound, "
               f"{row['backward_bound_ms']:.4f} ms by {row['backward_bound_by']}), autograd "
               f"through the library forward {row['library_fwd_bwd_ms']:.4f} ms"
               if "backward_ms" in row else ""))
    return err, rows


def host_us(fn, calls: int = 300) -> float:
    """Host microseconds one ``fn()`` takes to return (it waits for nothing
    on the device), median of 5 runs of ``calls``."""
    import torch

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def pair_host_split(device) -> dict:
    """Phase 5: where the host's time for one batch-1 bf16 pair launch goes.
    The two entries of the library differ on the host by the two tensor
    maps that ``taps`` encodes a launch; the module's call adds its cache
    look-up, the bare wrapper's the layout of the weights."""
    import torch

    from vsrlab_tpu_torch.nn.blocks import ResidualConv
    from vsrlab_tpu_torch.ops import residual_pair as rp

    shape = (1, 180, 320, 64)
    x, w1, b1, w2, b2 = ops = pair_operands(shape, torch.bfloat16, 7, device)
    fragments = rp.pack_weight_fragments(w1), rp.pack_weight_fragments(w2)
    out, lib = torch.empty_like(x), rp._lib()
    stream = torch.cuda.current_stream(device).cuda_stream

    def entry(form, wa, wb):
        fn = getattr(lib, rp._FUNCS[(form, torch.bfloat16)])
        args = (x.data_ptr(), wa.data_ptr(), b1.data_ptr(), wb.data_ptr(), b2.data_ptr(),
                out.data_ptr(), *shape[:3], x.device.index or 0, stream)
        return lambda: fn(*args)

    unit = ResidualConv(64, dtype=torch.bfloat16).to(device)
    with torch.inference_mode():
        split = {
            "entry_taps": host_us(entry("taps", *fragments)),
            "entry_im2col": host_us(entry("im2col", w1, w2)),
            "checks": host_us(lambda: rp._check(*ops)),
            "wrapper_taps": host_us(lambda: rp.residual_conv_pair(*ops, fragments=fragments)),
            "wrapper_taps_laying_out": host_us(lambda: rp.residual_conv_pair(*ops)),
            "wrapper_im2col": host_us(lambda: rp.residual_conv_pair_im2col(*ops)),
            "module_taps": host_us(lambda: unit(x, "taps")),
            # the same launches through the custom ops an exported program calls
            "op_taps": host_us(lambda: torch.ops.vsrlab.residual_conv_pair(*ops, *fragments)),
            "op_im2col": host_us(lambda: torch.ops.vsrlab.residual_conv_pair_im2col(*ops)),
        }
    split["tensor_maps"] = split["entry_taps"] - split["entry_im2col"]
    split["op_over_wrapper_taps"] = split["op_taps"] - split["wrapper_taps"]
    split["op_over_wrapper_im2col"] = split["op_im2col"] - split["wrapper_im2col"]
    log(f"  host time of one batch-1 pair launch, us: the library's entry {split['entry_taps']:.1f} "
        f"(taps) and {split['entry_im2col']:.1f} (im2col), so the two tensor maps "
        f"{split['tensor_maps']:.1f}; the checks {split['checks']:.1f}; the wrapper "
        f"{split['wrapper_taps']:.1f} (taps, fragments given), "
        f"{split['wrapper_taps_laying_out']:.1f} (taps, laying the weights out), "
        f"{split['wrapper_im2col']:.1f} (im2col); ResidualConv's call {split['module_taps']:.1f}; "
        f"through the custom op {split['op_taps']:.1f} (taps) and {split['op_im2col']:.1f} "
        f"(im2col), {split['op_over_wrapper_taps']:.1f} and "
        f"{split['op_over_wrapper_im2col']:.1f} more than the wrappers")
    log(json.dumps({"pair_host_us": split}))
    return split


def train_host_split(device) -> dict:
    """Phase 6: the host's time for one ``ResidualConv`` of a train step at
    batch 4, 64x64, bf16, with a gradient: the forward with ``taps`` (the
    operands and the kernel's weight order laid out from the parameters,
    then ``ResidualPair``), the forward and backward, the same with
    ``plain`` (autograd through the plain version, whose backward runs in
    C++), and the parts: ``grad_operands``, laying out the weight order
    (``fragments``), ``residual_pair`` on ready operands, ``pair_grads``
    alone; and the forward as it was before the weight order was laid out
    on each call (taken from the operand cache instead)."""
    import torch

    from vsrlab_tpu_torch.nn.blocks import ResidualConv
    from vsrlab_tpu_torch.ops.residual_pair import pack_weight_fragments, pair_grads, residual_pair

    shape = TRAIN_SHAPES[0]
    unit = ResidualConv(64, dtype=torch.bfloat16).to(device)
    x = pair_operands(shape, torch.bfloat16, 7, device)[0].requires_grad_(True)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(8)).to(device, torch.bfloat16)
    ops = unit.grad_operands(torch.bfloat16)
    fragments = unit.pair_fragments()
    plain_ops = [o.detach() for o in ops]
    before = tf32(True)
    split = {
        "forward_taps": host_us(lambda: unit(x, "taps"), 100),
        "forward_backward_taps": host_us(lambda: unit(x, "taps").backward(g), 100),
        "forward_plain": host_us(lambda: unit(x, "plain"), 100),
        "forward_backward_plain": host_us(lambda: unit(x, "plain").backward(g), 100),
        "grad_operands": host_us(lambda: unit.grad_operands(torch.bfloat16), 100),
        "fragments": host_us(lambda: tuple(pack_weight_fragments(w.detach()) for w in ops[::2]),
                             100),
        "forward_taps_cached_fragments": host_us(
            lambda: residual_pair(x, *unit.grad_operands(torch.bfloat16), "taps",
                                  unit.pair_fragments()), 100),
        "residual_pair": host_us(lambda: residual_pair(x, *ops, "taps", fragments), 100),
        "pair_grads": host_us(lambda: pair_grads(x.detach(), *plain_ops, g), 100),
    }
    tf32(before)
    log(f"  host time of one train-step unit {shape}, us: taps forward {split['forward_taps']:.1f}, "
        f"forward + backward {split['forward_backward_taps']:.1f}; plain "
        f"{split['forward_plain']:.1f} and {split['forward_backward_plain']:.1f}; parts of taps: "
        f"grad_operands {split['grad_operands']:.1f}, fragments {split['fragments']:.1f}, "
        f"residual_pair (forward) {split['residual_pair']:.1f}, pair_grads "
        f"{split['pair_grads']:.1f}; the forward with the weight order from the cache (as "
        f"before it was laid out on each call) {split['forward_taps_cached_fragments']:.1f}")
    log(json.dumps({"train_host_us": split}))
    return split


def pair_times(tree: str) -> int:
    """``--pair-times [TREE]``: only the residual pair's device time a launch
    (graph replay of ``ResidualConv``'s call, bf16, and fp32 at the fp32
    paths' shapes) at the main path's shapes, for the package in TREE (default: this checkout). Two trees of
    the port are compared by one such run each, one after the other on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(tree))
    from vsrlab_tpu_torch.nn.blocks import ResidualConv

    device = torch.device("cuda")
    log(card_line())
    unit = ResidualConv(64, dtype=torch.bfloat16).to(device)
    unit32 = ResidualConv(64).to(device)
    times = {}
    with torch.inference_mode():
        for form, batches in (("taps", (1, 2, 10, 20)), ("im2col", (1, 10))):
            for b in batches:
                x = pair_operands((b, 180, 320, 64), torch.bfloat16, 7, device)[0]
                times[f"{form} B={b}"] = graph_ms(lambda: unit(x, form))
        for shape in (CLEANER_SHAPE, (1, 180, 320, 64), (10, 180, 320, 64)):  # the fp32 kernel
            x = pair_operands(shape, torch.float32, 7, device)[0]
            times[f"fp32 {shape}"] = graph_ms(lambda: unit32(x, "taps"))
    log(json.dumps({"pair_times_ms": times, "tree": tree}))
    return 0


def realistic_operands(n, h, w, c, dtype, seed, device):
    """``n`` images ``(h, w, c)`` ~ N(0, 1) in ``dtype`` and the alignment's
    kind of sample coordinates ``(n, h, w)`` fp32: the pixel grid plus an
    N(0, 3) residue, so neighbouring pixels read neighbouring pixels. Every
    sampler yardstick at one image size runs on these same operands."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g).to(device, dtype)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ix = xs[None] + torch.randn((n, h, w), generator=g) * 3.0
    iy = ys[None] + torch.randn((n, h, w), generator=g) * 3.0
    return x, ix.to(device), iy.to(device)


def sampler_coords(n, h, w, kind, seed, device):
    """Sample coordinates ``(n, h*w)`` fp32 of one ``kind``: ``realistic``
    (see :func:`realistic_operands`), ``uniform`` over the image and a
    2-pixel margin, ``far`` (uniform over three image sizes on each side:
    most corners outside, a CTA's corner box as large as the image) or
    ``nonfinite`` (realistic, with +-inf, NaN and +-1e30 among them).
    Returns the coordinates and, for ``nonfinite``, the mask of samples
    that must come out 0."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if kind in ("realistic", "nonfinite"):
        _, ix, iy = realistic_operands(n, h, w, 1, torch.float32, seed, "cpu")
    else:
        lo, span = (-2.0, 3.0) if kind == "uniform" else (-3.0 * max(w, h), 6.0 * max(w, h))
        ix = torch.rand((n, h, w), generator=g) * (w + span) + lo
        iy = torch.rand((n, h, w), generator=g) * (h + span) + lo
    ix, iy = ix.reshape(n, -1).contiguous(), iy.reshape(n, -1).contiguous()
    bad = None
    if kind == "nonfinite":
        special = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e30, -1e30])
        ix.view(-1)[::7] = special.repeat(ix.numel() // 35 + 1)[: ix.view(-1)[::7].numel()]
        iy.view(-1)[3::11] = special.flip(0).repeat(iy.numel() // 55 + 1)[
            : iy.view(-1)[3::11].numel()]
        bad = ~(torch.isfinite(ix) & torch.isfinite(iy) & (ix.abs() < 1e29) & (iy.abs() < 1e29))
        bad = bad.to(device)
    return ix.to(device), iy.to(device), bad


def check_sampler(x, ix, iy, zeros, tol, label, bad=None) -> float:
    """max |kernel - plain| of ``bilinear_sample``; raises beyond ``tol +
    tol*|plain|``, on a non-finite output, when one of three launches differs
    from the first in any bit, or where ``bad`` marks a sample that must be 0."""
    import torch

    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    first = bs.bilinear_sample(x, ix, iy, zeros)
    same = all(torch.equal(bs.bilinear_sample(x, ix, iy, zeros), first) for _ in range(2))
    want = bs.bilinear_sample_plain(x, ix, iy, zeros).float()
    torch.cuda.synchronize()
    got = first.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    if bad is not None:
        ok = ok and bool((got[bad] == 0).all())
    e = float(err.max())
    log(f"  {label}: max|kernel-plain| = {e:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}, "
        f"3 launches bitwise {'equal' if same else 'DIFFERENT'}")
    if not ok or not same:
        raise AssertionError(f"{label} disagrees with the plain version or with itself")
    return e


def check_sampler_kernel(device) -> dict:
    """Phase 2 for ``bilinear_sample``. Returns ``{"fp32": err, "bf16": err}``."""
    import torch

    from vsrlab_tpu_torch.ops.warp import _pad_coords

    errs = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for i, (n, h, w, c) in enumerate(SAMPLER_CHECKS):
            x = torch.randn((n, h, w, c), generator=torch.Generator().manual_seed(i))
            x = x.to(device, dtype)
            for kind in SAMPLER_KINDS:
                ix, iy, bad = sampler_coords(n, h, w, kind, i, device)
                label = f"bilinear_sample {dname} {(n, h, w, c)} {kind:9s}"
                e = check_sampler(x, ix, iy, True, TOL[dname], label + " zeros ", bad)
                if kind != "nonfinite":  # border: the coordinates clamped first, no mask
                    bx, by = _pad_coords(ix, iy, h, w, "border", True)
                    e = max(e, check_sampler(x, bx, by, False, TOL[dname], label + " border"))
                errs[dname] = max(errs.get(dname, 0.0), e)
            del x
    return errs


def packed_operands(n, h, w, c, gp, dtype, realistic, seed, device):
    """The row gather's operands for ``n`` random images ``(h, w, c)``: the
    packed table and the per-pixel fields, from realistic coordinates (see
    :func:`realistic_operands`) or from ones uniform over the image and a
    2-pixel margin."""
    import torch

    from vsrlab_tpu_torch.ops.warp import packed_fields, packed_table

    if realistic:
        x, ix, iy = realistic_operands(n, h, w, c, dtype, seed, device)
    else:
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((n, h, w, c), generator=g).to(device, dtype)
        ix = (torch.rand((n, h, w), generator=g) * (w + 3) - 2).to(device)
        iy = (torch.rand((n, h, w), generator=g) * (h + 3) - 2).to(device)
    return packed_table(x, gp), packed_fields(ix, iy, h, w, gp, "zeros")


def check_gather(xf, idx, label) -> float:
    """The row gather moves bits: it must equal its plain version exactly."""
    import torch

    from vsrlab_tpu_torch.ops import packed_gather as pg

    got, want = pg.packed_row_gather(xf, idx), pg.packed_row_gather_plain(xf, idx)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    log(f"  {label}: {'equal' if ok else 'DIFFERENT'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with the plain version")
    return 0.0


def check_gather_kernel(device) -> dict:
    """Phase 2 for ``packed_row_gather``. Returns ``{"fp32": err, "bf16": err}``."""
    import torch

    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for n, h, w, c, gp in PACKED_CHECKS:
            for realistic in (True, False):
                xf, fields = packed_operands(n, h, w, c, gp, dtype, realistic, 3, device)
                check_gather(xf, fields[0], f"packed_row_gather {dname} {tuple(xf.shape)} x "
                             f"{fields[0].shape[1]} {'realistic' if realistic else 'random'}")
                del xf, fields
    return {"fp32": 0.0, "bf16": 0.0}


def sampler_window_bytes(x, ix, iy) -> int:
    """The bytes of ``x`` ``(N, H, W, C)`` that samples at ``ix``, ``iy``
    ``(N, P)`` need: per image the smaller of the image and the box of the
    corners they cover (clipped to the image; a sample with a non-finite
    coordinate reads nothing)."""
    import torch

    n, h, w, c = x.shape
    ok = torch.isfinite(ix) & torch.isfinite(iy)
    extent = []
    for coord, size in ((ix, w), (iy, h)):
        f = torch.floor(torch.where(ok, coord, 0.0))
        lo = torch.where(ok, f.clamp(0, size - 1), float(size)).amin(1)
        hi = torch.where(ok, (f + 1).clamp(0, size - 1), -1.0).amax(1)
        extent.append((hi - lo + 1).clamp(min=0))
    return int((extent[0] * extent[1]).sum()) * c * x.element_size()


def sampler_bound(name, shape, itemsize=2, image_bytes=None) -> tuple[float, str]:
    """Least time (ms) of one launch, the larger of its bytes over the HBM
    rate and its operations over the fp32 rate:

    * ``bilinear_sample``, shape ``(N, H, W, C, P)``: the image bytes the
      samples need read once (``image_bytes``, from
      :func:`sampler_window_bytes`: per image the smaller of the image and
      the corner box the samples cover; without it the whole images,
      ``N*H*W*C*itemsize``, which is what the alignment's samples cover), 8
      bytes of coordinates a sample, the output written once, against ``8 *
      N*P*C`` FLOP (four weighted corners an output element);
    * ``packed_row_gather``, shape ``(N, R, Wrow, P)``: the table read once,
      4 bytes of index a pixel, the rows written once, no arithmetic.
    """
    if name == "bilinear_sample":
        n, h, w, c, p = shape
        if image_bytes is None:
            image_bytes = n * h * w * c * itemsize
        nbytes = image_bytes + n * (8 * p + p * c * itemsize)
        flops = 8 * n * p * c
    else:
        n, r, wrow, p = shape
        nbytes, flops = n * (r * wrow * itemsize + 4 * p + p * wrow * itemsize), 0
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_sampler(launches_by_shape, device, dtype=None):
    """Phase 6 for ``bilinear_sample``: at each shape a path gave it (the
    VRT paths' in bf16, the flow paths' in fp32; realistic coordinates: the
    pixel grid plus an N(0, 3) residue where a sample grid has the image's
    shape, else RAFT's 7x7 windows around it), a check against the plain
    version, then device times by CUDA-graph replay of the kernel, the
    plain version and one ``F.grid_sample`` call (NCHW, the normalised
    grid, align_corners, zeros; timed only) on the same operands, and the
    bound from the image bytes those samples need. Returns the largest
    error and one row per shape."""
    import torch
    import torch.nn.functional as F

    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    dtype = dtype or torch.bfloat16
    dname = "bf16" if dtype == torch.bfloat16 else "fp32"
    err, rows = 0.0, []
    for shape, count in sorted(launches_by_shape.items()):
        n, h, w, c, p = shape
        if p == h * w:
            x, ix, iy = realistic_operands(n, h, w, c, dtype, h, device)
        else:
            x = torch.randn((n, h, w, c), generator=torch.Generator().manual_seed(h)).to(device,
                                                                                          dtype)
            ix, iy, _ = window_coords(n, h, w, "realistic", h, device)
        fx, fy = ix.reshape(n, -1), iy.reshape(n, -1)
        err = max(err, check_sampler(x, fx, fy, True, TOL[dname],
                                     f"bilinear_sample {dname} {shape}"))
        xc = x.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([2 * ix / (w - 1) - 1, 2 * iy / (h - 1) - 1], -1).to(dtype)
        if p != h * w:
            grid = grid[:, None]  # (N, 1, P, 2)
        b_ms, b_by = sampler_bound("bilinear_sample", shape, x.element_size(),
                                   sampler_window_bytes(x, fx, fy))
        row = {"shape": list(shape), "dtype": dname, "launches": count,
               "ms": graph_ms(lambda: bs.bilinear_sample(x, fx, fy, True)),
               "plain_ms": graph_ms(lambda: bs.bilinear_sample_plain(x, fx, fy, True), calls=3),
               "library_ms": graph_ms(
                   lambda: F.grid_sample(xc, grid, "bilinear", "zeros", align_corners=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        row["share_of_bound"] = b_ms / row["ms"]
        log(f"  bilinear_sample   {dname} {shape} x{count}: kernel {row['ms']:.4f} ms "
            f"({100 * row['share_of_bound']:.1f} % of its bound, {b_ms:.4f} ms by {b_by}), plain "
            f"{row['plain_ms']:.4f} ms, F.grid_sample {row['library_ms']:.4f} ms (graph replay)")
        rows.append(row)
        del x, ix, iy, fx, fy, xc, grid
    return err, rows


def time_gather(launches_by_shape, device):
    """Phase 5 for ``packed_row_gather``: at each shape the VRT path gave it
    (bf16, the same realistic operands as :func:`time_sampler` at that image
    size), a check against the plain version, then device times by
    CUDA-graph replay of the kernel, the plain version and one
    ``index_select`` of the flattened table (timed only), and beside them
    the torch ops of the ``take`` route that build the table and the fields.
    Returns the largest error and one row per shape."""
    import torch

    from vsrlab_tpu_torch.ops import packed_gather as pg
    from vsrlab_tpu_torch.ops.warp import packed_fields, packed_table

    rows = []
    for shape, count in sorted(launches_by_shape.items()):
        n, r, wrow, p = shape
        h = w = int(round(p ** 0.5))
        c = wrow // (4 * VRT_GP)
        x, ix, iy = realistic_operands(n, h, w, c, torch.bfloat16, h, device)
        xf, fields = packed_table(x, VRT_GP), packed_fields(ix, iy, h, w, VRT_GP, "zeros")
        idx = fields[0]
        if tuple(xf.shape) != (n, r, wrow) or idx.shape[1] != p:
            raise AssertionError(f"cannot rebuild the operands of shape {shape}")
        check_gather(xf, idx, f"packed_row_gather bf16 {shape}")
        flat = xf.reshape(-1, wrow)
        lin = (idx.long() + torch.arange(n, device=device)[:, None] * r).reshape(-1)
        b_ms, b_by = sampler_bound("packed_row_gather", shape)
        row = {"shape": list(shape), "launches": count,
               "ms": graph_ms(lambda: pg.packed_row_gather(xf, idx)),
               "plain_ms": graph_ms(lambda: pg.packed_row_gather_plain(xf, idx), calls=3),
               "library_ms": graph_ms(lambda: flat.index_select(0, lin)),
               "bound_ms": b_ms, "bound_by": b_by,
               "table_ms": graph_ms(lambda: packed_table(x, VRT_GP), calls=5),
               "fields_ms": graph_ms(lambda: packed_fields(ix, iy, h, w, VRT_GP, "zeros"),
                                     calls=5)}
        row["share_of_bound"] = b_ms / row["ms"]
        log(f"  packed_row_gather bf16 {shape} x{count}: kernel {row['ms']:.4f} ms "
            f"({100 * row['share_of_bound']:.1f} % of its bound, {b_ms:.4f} ms by {b_by}), plain "
            f"{row['plain_ms']:.4f} ms, index_select {row['library_ms']:.4f} ms; the take "
            f"route's table {row['table_ms']:.4f} ms and fields {row['fields_ms']:.4f} ms "
            "(graph replay)")
        rows.append(row)
        del x, ix, iy, xf, fields, idx, flat, lin
    return 0.0, rows


def attention_operands(b, h, nq, nk, hd, with_bias, with_masks, dtype, seed, device,
                       qk_std=2.0):
    """q, k, v as head views of one fused projection's output (B, n, 3*H*hd),
    as WindowAttention hands them over; q and k of std ``qk_std`` (logits of
    std ~4: a trained model's attention is peaked), v of std 1; bias
    uniform in +-0.5, masks of 8 window types with -100 at 30 % of the
    logits, a type a window. Returns ``(q, k, v, scale, bias, masks, tid)``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = max(nq, nk)
    qkv = torch.randn((b, n, 3 * h * hd), generator=g)
    qkv[..., :2 * h * hd] *= qk_std
    qkv = qkv.to(device, dtype)

    def heads(t, rows):
        return t[:, :rows].reshape(b, rows, h, hd).transpose(1, 2)

    q, k, v = (heads(t, r) for t, r in zip(qkv.chunk(3, -1), (nq, nk, nk)))
    bias = (torch.rand((h, nq, nk), generator=g) - 0.5).to(device) if with_bias else None
    masks = tid = None
    if with_masks:
        masks = torch.where(torch.rand((8, nq, nk), generator=g) < 0.3, -100.0, 0.0).to(device)
        tid = torch.randint(0, 8, (b,), generator=g).to(device)
    return q, k, v, hd ** -0.5, bias, masks, tid


def attention_gate(got, want, v) -> float:
    """The share of its gate that ``|got - want|`` takes (at most 1 to pass):
    bf16, the larger of each element against ``2^-7 |want| + 2^-8
    max|want|`` and the rms against ``2^-8 rms(want)`` (the card tests'
    gate, ``tests/_attention_gate.py``: the kernel's rounding reads about
    half of it, bf16 logits 1.3-6 times it); fp32, the largest element
    against ``2e-5 max|v|``."""
    import torch

    got, want = got.double(), want.double()
    d = (got - want).abs()
    if v.dtype == torch.float32:
        return float(d.max() / (2e-5 * v.abs().max()))
    elem = float((d / (2 ** -7 * want.abs() + 2 ** -8 * want.abs().max())).max())
    return max(elem, float(d.pow(2).mean().sqrt() / (2 ** -8 * want.pow(2).mean().sqrt())))


def check_attention(ops, label, repeats: int = 3) -> float:
    """The kernel on ``ops`` against the plain version; raises beyond the
    gate (:func:`attention_gate`), on a non-finite value, and when one of
    ``repeats`` launches differs from the first in any bit. Returns the
    share of the gate taken."""
    import torch

    from vsrlab_tpu_torch.ops import window_attention as owa

    first = owa.window_attention(*ops)
    same = all(torch.equal(owa.window_attention(*ops), first) for _ in range(repeats - 1))
    share = attention_gate(first, owa.window_attention_plain(*ops), ops[2])
    ok = bool(torch.isfinite(first).all()) and share <= 1
    log(f"  {label}: {100 * share:.1f} % of the gate {'ok' if ok else 'FAIL'}, {repeats} launches "
        f"bitwise {'equal' if same else 'DIFFERENT'}")
    if not ok or not same:
        raise AssertionError(f"{label} disagrees with the plain version or with itself")
    return share


def check_attention_kernel(device) -> dict:
    """Phase 2 for ``window_attention``: the kernel against the plain version
    at ``ATTENTION_CHECKS``, bf16 and fp32 (TF32 off). Returns the largest
    share of the gate by type."""
    import torch

    out = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        out[dname] = 0.0
        for i, (name, *shape) in enumerate(ATTENTION_CHECKS):
            ops = attention_operands(*shape, dtype, i, device)
            out[dname] = max(out[dname], check_attention(
                ops, f"window_attention {dname} {name} {tuple(shape)}"))
            del ops
    return out


def attention_bound(shape, itemsize=2) -> tuple[float, str]:
    """Least time (ms) of one ``window_attention`` launch, shape ``(B, H, nq,
    nk, hd, ...)``: q, k and v read and the output written once (bias and
    masks, a few MB, stay in L2) over the HBM rate, against the products
    ``4 B H nq nk hd`` FLOP (QK^T and P.V) at the bf16 tensor-core peak."""
    b, h, nq, nk, hd = shape[:5]
    nbytes = itemsize * b * h * hd * (2 * nq + 2 * nk)
    flops = 4 * b * h * nq * nk * hd
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_attention(launches_by_shape, device):
    """Phase 6 for ``window_attention``: at each shape the VRT paths gave it
    (bf16; bias and masks as its key says), a check against the plain
    version, then device times by CUDA-graph replay of the kernel (written
    into a channel slice, as the module calls it), the plain version and
    ``F.scaled_dot_product_attention`` with the bias and mask summed into
    one bf16 additive mask (the sum not timed; the library is timed only,
    the port never calls it), beside the bound. Returns the largest share
    of the gate and one row per shape."""
    import torch
    import torch.nn.functional as F

    from vsrlab_tpu_torch.ops import window_attention as owa

    err, rows = 0.0, []
    for shape, count in sorted(launches_by_shape.items(),
                               key=lambda kv: -kv[0][0] * kv[0][2] * kv[0][3]):
        b, h, nq, nk, hd, with_bias, with_masks = shape
        ops = q, k, v, scale, bias, masks, tid = attention_operands(
            *shape, torch.bfloat16, 11, device)
        label = f"window_attention bf16 {shape}"
        err = max(err, check_attention(ops, label, repeats=2))
        out = torch.empty((b, nq, 2 * h * hd), dtype=q.dtype, device=device)[:, :, h * hd:]
        add = None
        if with_bias or with_masks:
            add = torch.zeros((b, h, nq, nk), device=device)
            if with_bias:
                add += bias
            if with_masks:
                add += masks[tid][:, None]
            add = add.to(q.dtype)
        b_ms, b_by = attention_bound(shape)
        row = {"shape": list(shape), "dtype": "bf16", "launches": count,
               "ms": graph_ms(lambda: owa.window_attention(*ops, out=out)),
               "plain_ms": graph_ms(lambda: owa.window_attention_plain(*ops), calls=2, samples=5),
               "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=add, scale=scale), calls=2, samples=5),
               "bound_ms": b_ms, "bound_by": b_by}
        row["share_of_bound"] = b_ms / row["ms"]
        log(f"  {label} x{count}: kernel {row['ms']:.4f} ms ({100 * row['share_of_bound']:.1f} % "
            f"of its bound, {b_ms:.4f} ms by {b_by}), plain {row['plain_ms']:.4f} ms, SDPA "
            f"{row['library_ms']:.4f} ms (graph replay)")
        rows.append(row)
        del ops, q, k, v, bias, masks, tid, out, add
        torch.cuda.empty_cache()
    return err, rows


def sampler_times(tree: str) -> int:
    """``--sampler-times [TREE]``: only the device time of the ``fused``
    sampler's whole route (``sample_pixel_coords(impl="fused")``, everything
    it runs on the card) at the VRT request's four image sizes, bf16, on
    realistic coordinates, by graph replay, for the package in TREE (default:
    this checkout). Two trees of the port are compared by one such run each,
    one after the other on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(tree))
    from vsrlab_tpu_torch.ops.warp import sample_pixel_coords

    device = torch.device("cuda")
    log(card_line())
    n = VRT_CLIP[0] * (VRT_CLIP[1] - 1) * VRT_GROUPS
    times = {}
    for s in sorted(set(VRT_SCALES), reverse=True):
        h, w = VRT_CLIP[2] // s, VRT_CLIP[3] // s
        x, ix, iy = realistic_operands(n, h, w, VRT_CG, torch.bfloat16, h, device)
        times[f"{h}x{w}"] = graph_ms(
            lambda: sample_pixel_coords(x, ix, iy, window_group=VRT_GP, impl="fused"), calls=5)
        del x, ix, iy
    log(json.dumps({"sampler_route_ms": times, "tree": tree}))
    return 0


def module_breakdown(model, request, classes) -> dict:
    """Device ms of one ``request()`` by module class: CUDA events around
    every forward of the listed classes (which must not nest in each
    other), summed by class name; ``rest`` is what lies outside them."""
    import torch

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    starts, spans, handles = {}, [], []
    for m in model.modules():
        if isinstance(m, classes):
            handles.append(m.register_forward_pre_hook(
                lambda mod, _: starts.__setitem__(mod, event())))
            handles.append(m.register_forward_hook(
                lambda mod, _, __: spans.append((type(mod).__name__, starts.pop(mod), event()))))
    try:
        t0 = event()
        request()
        t1 = event()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {"total_ms": t0.elapsed_time(t1)}
    for name, a, b in spans:
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    out["rest"] = out["total_ms"] - sum(v for k, v in out.items() if k != "total_ms")
    return out


def seed_offset_heads(model, g):
    """Draw the zero-initialised offset / mask heads of every deformable
    alignment (std 0.05), so that offsets carry a residue of a few pixels on
    top of the flow prior and masks vary."""
    import torch

    from vsrlab_tpu_torch.models.vrt.deform import (
        FlowGuidedDeformAlign, SecondOrderDeformableAlignment)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (FlowGuidedDeformAlign, SecondOrderDeformableAlignment)):
                m.conv_offset_3.weight.normal_(0.0, 0.05, generator=g)
                m.conv_offset_3.bias.normal_(0.0, 0.05, generator=g)
    return model


def build_vrt(dtype, tiny=False, **kw):
    """Full-width VRT (or the default TinyVRT) with seeded weights, the
    offset / mask heads drawn too (:func:`seed_offset_heads`)."""
    import torch

    from vsrlab_tpu_torch.models import VRT, TinyVRT
    from vsrlab_tpu_torch.nn.blocks import init_weights

    g = torch.Generator().manual_seed(0)
    return seed_offset_heads(init_weights((TinyVRT if tiny else VRT)(upscale=4, dtype=dtype,
                                                                      **kw), g), g)


def expected_vrt_launches(clip_shape, kernel, scales=VRT_SCALES, groups=VRT_GROUPS, cg=VRT_CG,
                          gp=VRT_GP):
    """Sampler launches of one VRT forward through ``kernel``: at every
    stage 2 directions x 9 taps over ``B*(T-1)*groups`` images, keyed as the
    wrapper counts them: ``(N, H, W, C, P)`` for ``bilinear_sample``,
    ``(N, R, Wrow, P)`` for ``packed_row_gather``."""
    import collections

    b, t, h, w, _ = clip_shape
    n = b * (t - 1) * groups
    want = collections.Counter()
    for s in scales:
        hs, ws = h // s, w // s
        if kernel == "bilinear_sample":
            want[(n, hs, ws, cg, hs * ws)] += 18
        else:
            rows = (max(hs, 2) - 1) * (max(-(-ws // gp), 2) - 1)
            want[(n, rows, 4 * gp * cg, hs * ws)] += 18
    return want


def vrt_wrappers() -> dict:
    """The VRT path's kernel wrappers by name: the two samplers and the
    window attention."""
    from vsrlab_tpu_torch.ops import bilinear_sample as bs
    from vsrlab_tpu_torch.ops import packed_gather as pg
    from vsrlab_tpu_torch.ops import window_attention as owa

    return {"bilinear_sample": bs.bilinear_sample, "packed_row_gather": pg.packed_row_gather,
            "window_attention": owa.window_attention}


def reset_vrt_counts() -> None:
    from vsrlab_tpu_torch.ops import bilinear_sample as bs
    from vsrlab_tpu_torch.ops import packed_gather as pg
    from vsrlab_tpu_torch.ops import window_attention as owa

    bs.reset_launch_counts()
    pg.reset_launch_counts()
    owa.reset_launch_counts()


@contextlib.contextmanager
def attention_plan(model):
    """Yields a Counter that fills, while the region runs, with the
    window-attention launches by shape that ``model``'s WindowAttention
    calls imply, read from each call's input (``x`` (B_, N, C) and whether
    a mask came) and the module (heads, mutual or not), not from the
    kernel's counter: ``(B_, H, N, N, hd, True, masked)`` for the self
    attention, and for a mutual one each direction's halves without bias.
    A remat'd Stage's calls count again in the backward's recompute. Not
    for head-sharded or row (``forward_rows``) calls."""
    import collections

    from vsrlab_tpu_torch.models.vrt import WindowAttention

    plan = collections.Counter()

    def pre(mod, args, kwargs):
        x = args[0]
        mask = args[1] if len(args) > 1 else kwargs.get("mask")
        b, n, c = x.shape
        h, hd, masked = mod.num_heads, c // mod.num_heads, mask is not None
        plan[(b, h, n, n, hd, True, masked)] += 1
        if mod.mut_attn:
            half = n // 2
            plan[(b, h, n - half, half, hd, False, masked)] += 1
            plan[(b, h, half, n - half, hd, False, masked)] += 1

    handles = [m.register_forward_pre_hook(pre, with_kwargs=True) for m in model.modules()
               if isinstance(m, WindowAttention)]
    try:
        yield plan
    finally:
        for handle in handles:
            handle.remove()


@contextlib.contextmanager
def plain_attention():
    """The plain version in the attention kernel's place (for the yardstick
    routes: plain bf16 and fp32): the wrapper's launch computes
    ``window_attention_plain`` instead, and counts nothing."""
    from vsrlab_tpu_torch.ops import window_attention as owa

    launch = owa._launch

    def plain(q, k, v, scale, bias, masks, tid, out=None):
        y = owa.window_attention_plain(q, k, v, scale, bias, masks, tid)
        return y if out is None else out.copy_(y)

    owa._launch = plain
    try:
        yield
    finally:
        owa._launch = launch


def run_vrt_path(model, clip, device):
    """Phase 4's served requests: one ``make_forward`` request over ``clip``
    with the fused sampler kernel, then one with the row gather kernel.
    Returns both outputs and each VRT kernel's launches by shape, per
    request, with the window-attention launches each request's calls imply
    (:func:`attention_plan`); the residual pair's count is read too (it
    must stay 0)."""
    from vsrlab_tpu_torch.evaluation.harness import make_forward
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl
    from vsrlab_tpu_torch.ops import residual_pair as rp

    wrappers = vrt_wrappers()

    def counts():
        return {name: fn.launches_by_shape.copy() for name, fn in wrappers.items()}

    forward = make_forward(model, device=device)
    reset_vrt_counts()
    rp.reset_launch_counts()
    seen, calls, plans, out = counts(), {}, {}, {}
    for impl in ("fused", "take"):
        set_sampler_impl(model, impl)
        with attention_plan(model) as plans[impl]:
            out[impl] = forward(clip)
        now = counts()
        calls[impl], seen = {name: now[name] - seen[name] for name in wrappers}, now
    set_sampler_impl(model, "fused")
    pair = rp.residual_conv_pair.launches + rp.residual_conv_pair_im2col.launches
    return {**out, "calls": calls, "attention_plans": plans, "launches_by_shape": seen,
            "pair_launches": pair}


def gate_samplers(outs, plain, ref32) -> None:
    """Each output of ``outs`` (by sampler formulation) against the plain
    route's bf16 run (the plain sampler; in phase 4 also the plain
    attention) and the fp32 run; raises beyond twice the deviation of plain
    bf16 from fp32, in max or rms."""
    def dev(a, b):
        d = (a.float() - b).abs()
        return float(d.max()), float(d.pow(2).mean().sqrt())

    b_max, b_rms = dev(plain, ref32)
    log(f"  plain route bf16 vs fp32: max {b_max:.4e}, rms {b_rms:.4e}; gate: 2x that")
    for impl, out in outs.items():
        for other, ref in (("plain (bf16)", plain), ("fp32", ref32)):
            d_max, d_rms = dev(out, ref)
            log(f"  {impl} vs {other}: max {d_max:.4e} ({d_max / b_max:.2f}x), rms {d_rms:.4e} "
                f"({d_rms / b_rms:.2f}x)")
            if not (d_max <= 2 * b_max and d_rms <= 2 * b_rms):
                raise AssertionError(f"{impl} vs {other} deviates by more than twice bf16's "
                                     "own deviation")


def tiny_vrt_phase(device, card) -> None:
    """Phase 4, second part: the default TinyVRT (32 channels, 4 offset
    groups of 8 channels: 128-byte table rows) serves a 6-frame 64x64
    request with the fused kernel, held to the same launch-count and
    deviation gates, and a 96x96 clip through ``tiled_forward``."""
    import torch

    from vsrlab_tpu_torch.evaluation.harness import make_forward
    from vsrlab_tpu_torch.evaluation.tiled import tiled_forward
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl
    from vsrlab_tpu_torch.ops.warp import sample_pixel_coords

    wrappers = vrt_wrappers()
    sampler, gather = wrappers["bilinear_sample"], wrappers["packed_row_gather"]
    attention = wrappers["window_attention"]

    shape = (1, 6, 64, 64, 3)
    model = build_vrt(torch.bfloat16, tiny=True)
    forward = make_forward(model, device=device)
    g = torch.Generator().manual_seed(3)
    clip = torch.rand(shape, generator=g)
    reset_vrt_counts()
    with attention_plan(model) as plan:
        fused = forward(clip)
    got = sampler.launches_by_shape.copy()
    want = expected_vrt_launches(shape, "bilinear_sample", scales=(1, 2, 4, 2, 1), groups=4,
                                 cg=8)
    log(f"  TinyVRT {shape}: bilinear_sample launches by (N, H, W, C, P): {dict(got)}; "
        f"window_attention launches {attention.launches} by shape as its calls imply")
    if got != want or gather.launches:
        raise AssertionError(f"TinyVRT: launches {dict(got)} != expected {dict(want)}")
    if attention.launches_by_shape != plan or not plan:
        raise AssertionError(f"TinyVRT: window_attention launches "
                             f"{dict(attention.launches_by_shape)} != {dict(plan)}")
    if tuple(fused.shape) != (1, 6, 256, 256, 3) or not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"TinyVRT: shape {tuple(fused.shape)} or non-finite")
    set_sampler_impl(model, "plain")
    with plain_attention():
        plain = forward(clip).float()
        set_sampler_impl(model, "fused")
        model32 = build_vrt(None, tiny=True)
        model32.load_state_dict(model.state_dict())
        set_sampler_impl(model32, "plain")
        ref32 = make_forward(model32, device=device)(clip).float()
    gate_samplers({"fused": fused}, plain, ref32)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(clip)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(json.dumps({"tiny_vrt_fps": shape[1] / statistics.median(times), "card": card}))

    big = torch.rand((1, 6, 96, 96, 3), generator=g)
    reset_vrt_counts()
    out = tiled_forward(forward, big, tile=(64, 64), overlap=16)
    tiles = sampler.launches // sum(want.values())
    log(f"  tiled_forward (1, 6, 96, 96, 3), 64x64 tiles, overlap 16: {tuple(out.shape)}, "
        f"{tiles} tiles, {sampler.launches} sampler launches")
    if (tuple(out.shape) != (1, 6, 384, 384, 3) or not bool(torch.isfinite(out).all())
            or sampler.launches != 4 * sum(want.values())):
        raise AssertionError("tiled_forward: wrong shape, non-finite or not 4 tiles")

    # 4 channels an offset group: C = 4 for the sampler kernel, and 8
    # x-positions a table row for the row gather, so that the 8x8 stage is
    # one x-group wide and its table is padded to one window
    shape = (1, 4, 32, 32, 3)
    kw = dict(tiny=True, window_size=(2, 4, 4), deformable_groups=8)
    model = build_vrt(torch.bfloat16, **kw)
    forward = make_forward(model, device=device)
    clip = torch.rand(shape, generator=g)
    reset_vrt_counts()
    fused = forward(clip)
    got = sampler.launches_by_shape.copy()
    want = expected_vrt_launches(shape, "bilinear_sample", scales=(1, 2, 4, 2, 1), groups=8,
                                 cg=4)
    log(f"  TinyVRT, 4 channels a group, {shape}: bilinear_sample launches by "
        f"(N, H, W, C, P): {dict(got)}")
    if got != want or (24, 8, 8, 4, 64) not in got or gather.launches:
        raise AssertionError(f"TinyVRT: launches {dict(got)} != expected {dict(want)}")
    if tuple(fused.shape) != (1, 4, 128, 128, 3) or not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"TinyVRT: shape {tuple(fused.shape)} or non-finite")
    # the request's gate hardly sees its smallest stage, so the sampler is
    # also held against the four-corner one at that stage's shape
    x = torch.randn((24, 8, 8, 4), generator=g).to(device, torch.bfloat16)
    ix, iy = (torch.rand((2, 24, 8, 8), generator=g) * 11 - 2).to(device)
    want = sample_pixel_coords(x, ix, iy, impl="plain").float()
    for impl, wrapper, key in (("fused", sampler, (24, 8, 8, 4, 64)),
                               ("take", gather, (24, 7, 128, 64))):
        before = wrapper.launches_by_shape[key]
        err = (sample_pixel_coords(x, ix, iy, impl=impl).float() - want).abs()
        ok = bool((err <= TOL["bf16"] * (1 + want.abs())).all())
        log(f"  {impl} sampler on 24 images of 8x8x4 (take: one padded window a row): "
            f"max|{impl}-plain| = {float(err.max()):.3e} {'ok' if ok else 'FAIL'}")
        if not ok or wrapper.launches_by_shape[key] != before + 1:
            raise AssertionError(f"{impl} sampler disagrees or launched no kernel at 8x8x4")
    set_sampler_impl(model, "plain")
    with plain_attention():
        plain = forward(clip).float()
        model32 = build_vrt(None, **kw)
        model32.load_state_dict(model.state_dict())
        set_sampler_impl(model32, "plain")
        ref32 = make_forward(model32, device=device)(clip).float()
    gate_samplers({"fused": fused}, plain, ref32)


def vrt_phase(device, card):
    """Phase 4. Returns each sampler kernel's launches by shape."""
    import torch

    from vsrlab_tpu_torch.evaluation.harness import make_forward
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl

    model = build_vrt(torch.bfloat16, img_size=VRT_CLIP[1:4])
    log(f"  parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    clip = torch.rand(VRT_CLIP, generator=torch.Generator().manual_seed(2))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_vrt_path(model, clip, device)
    torch.cuda.synchronize()
    log(f"  served 2 requests in {time.perf_counter() - t0:.2f} s (first use included), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want_shape = (VRT_CLIP[0], VRT_CLIP[1], 4 * VRT_CLIP[2], 4 * VRT_CLIP[3], 3)
    uses = {"fused": "bilinear_sample", "take": "packed_row_gather"}
    for impl, kernel in uses.items():
        out = res[impl]
        if tuple(out.shape) != want_shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{impl}: shape {tuple(out.shape)} (want {want_shape}) "
                                 "or non-finite")
        log(f"  {impl}: {tuple(out.shape)} finite, range [{float(out.min()):.3f}, "
            f"{float(out.max()):.3f}]")
        # all 126 sampler calls at their expected shapes, the other sampler not
        # launched, and one window-attention launch for each attention the
        # request's calls imply, 164 in all
        plan = res["attention_plans"][impl]
        want = {name: {} for name in SAMPLERS} | {"window_attention": plan}
        want[kernel] = expected_vrt_launches(VRT_CLIP, kernel)
        for name, by_shape in res["calls"][impl].items():
            log(f"  {impl} request, {name} launches by shape: {dict(by_shape)}")
            if by_shape != want[name]:
                raise AssertionError(f"{impl}: {name} launches {dict(by_shape)} != expected "
                                     f"{dict(want[name])}")
        if sum(plan.values()) != VRT_ATTENTION_LAUNCHES:
            raise AssertionError(f"{impl}: {sum(plan.values())} window-attention launches, not "
                                 f"{VRT_ATTENTION_LAUNCHES}")
    if res["pair_launches"] != 0:
        raise AssertionError("the VRT path launched the residual pair")

    # the yardsticks: the plain sampler and the plain attention, in bf16 and in fp32
    forward = make_forward(model, device=device)
    set_sampler_impl(model, "plain")
    with plain_attention():
        plain = forward(clip).float()
        model32 = build_vrt(None, img_size=VRT_CLIP[1:4])
        model32.load_state_dict(model.state_dict())
        set_sampler_impl(model32, "plain")
        ref32 = make_forward(model32, device=device)(clip).float()
    del model32
    log(f"  comparison runs use the whole request {VRT_CLIP}; the plain route's attention is "
        "the plain version")
    gate_samplers({impl: res[impl] for impl in uses}, plain, ref32)
    del plain, ref32, res["fused"], res["take"]

    seconds = {}
    for impl, reps in (("fused", 3), ("take", 1), ("plain", 1)):
        set_sampler_impl(model, impl)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(clip)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        seconds[impl] = statistics.median(times)
    set_sampler_impl(model, "fused")
    fps = {impl: VRT_CLIP[1] / t for impl, t in seconds.items()}
    log(f"  frames/s on {card}: 16-frame 256x256 request, fused {fps['fused']:.3f}, take "
        f"{fps['take']:.3f}, plain {fps['plain']:.3f} (fused the median of 3, the others "
        "one request each, host clock, input upload included)")
    log(json.dumps({"vrt_fps": fps, "card": card}))
    from vsrlab_tpu_torch.utils.profiler import counters

    before = counters().get("window_attention.launches", 0)
    prof = profile_request(lambda: forward(clip), seconds["fused"],
                           ours=("bilinear_sample", "window_attention"))
    prof["window_attention_counter"] = counters().get("window_attention.launches", 0) - before
    log(json.dumps({"profile_vrt_fused": prof}))
    # the program's counter, read while the profiler collects: one launch an attention
    if prof["window_attention_counter"] != VRT_ATTENTION_LAUNCHES:
        raise AssertionError(f"the profiled request counted {prof['window_attention_counter']} "
                             f"window-attention launches, not {VRT_ATTENTION_LAUNCHES}")
    from vsrlab_tpu_torch.models.vrt import FlowGuidedDeformAlign, MlpGEGLU, WindowAttention
    from vsrlab_tpu_torch.nn.blocks import LayerNorm

    log(json.dumps({"modules_vrt_fused_ms": module_breakdown(
        model, lambda: forward(clip),
        (WindowAttention, MlpGEGLU, FlowGuidedDeformAlign, LayerNorm))}))
    return res["launches_by_shape"]


def profile_request(request, wall_s: float, top: int = 12,
                    ours=("pair_taps", "pair_im2col"), groups=(), host=True) -> dict:
    """Device time of one ``request()`` by kernel (``torch.profiler``), its
    share of ``wall_s`` (the request's unprofiled time), the time in the
    port's own kernels (names holding one of ``ours``), the top kernels and,
    with ``groups`` (``(name, substrings)`` pairs), the device ms of each
    group: a kernel counts in the first group one of whose substrings its
    name holds, else in ``other``. ``host=False`` traces the card alone,
    which a request of hundreds of thousands of kernels parses much faster."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        request()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for e in prof.key_averages():  # kernels and copies; a range annotation is no kernel
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
    total = sum(kernels.values())
    if total == 0:
        return {"device_ms": "not measured (the profiler saw no device time)"}
    own = sum(v for k, v in kernels.items() if any(tag in k for tag in ours))
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    out = {
        "wall_ms": wall_s * 1e3,
        "device_ms": total,
        "device_busy_share": total / (wall_s * 1e3),
        "own_kernels_ms": own,
        "device_ops": launches,
        "top": [{"kernel": k[:90], "ms": v, "share": v / total} for k, v in ranked],
    }
    if groups:
        out["groups_ms"] = {name: 0.0 for name, _ in groups} | {"other": 0.0}
        for k, v in kernels.items():
            name = next((g for g, tags in groups if any(t in k.lower() for t in tags)), "other")
            out["groups_ms"][name] += v
    return out


def build_model(dtype, **kw):
    import torch

    from vsrlab_tpu_torch.models import RealBasicVSR
    from vsrlab_tpu_torch.nn.blocks import init_weights

    model = RealBasicVSR(**{**HEADLINE, **kw}, dtype=dtype)
    return init_weights(model, torch.Generator().manual_seed(0))


def run_main_path(model, clip, device):
    """Phase 3's served requests: one windowed forward over ``clip``
    ``(1, 2*10, H, W, 3)`` (two windows as one batch), then ``first`` (taps)
    and ``rest`` (im2col) on its two windows. Returns the outputs, the
    state ``first`` passed to ``rest``, and each kernel's launches by input
    shape, per call and over the three."""
    from vsrlab_tpu_torch.evaluation.harness import (
        make_forward, make_stream_forward, windowed_inference)
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.ops.residual_pair import (
        PAIR_IMPLS, reset_launch_counts)

    def counts():
        return {form: PAIR_IMPLS[form].launches_by_shape.copy() for form in KERNELS}

    calls = {}
    set_pair_impl(model, "taps")
    reset_launch_counts()
    seen = counts()
    sr_windowed, n_windows = windowed_inference(make_forward(model, device=device), clip, 10)
    now = counts()
    calls["windowed"], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    first, rest = make_stream_forward(model, device)
    sr_first, state = first(clip[:, :10])
    now = counts()
    calls["first"], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    set_pair_impl(model, "im2col")
    sr_rest, _ = rest(clip[:, 10:], state)
    now = counts()
    calls["rest"], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    set_pair_impl(model, "taps")
    return {"windowed": sr_windowed, "first": sr_first, "rest": sr_rest, "state": state,
            "n_windows": n_windows, "calls": calls, "launches_by_shape": seen}


def kernel_summary(rows, err, check_errs) -> dict:
    """One kernel's entry of the ``kernels`` line from its per-shape rows:
    times and bound summed over the path's launches (per-launch value at a
    shape times that shape's count); ``library_ms`` is null where no one
    PyTorch call computes the function."""
    def total(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r["launches"] for r in rows)

    return {
        "launches": sum(r["launches"] for r in rows),
        "max_abs_err": max(err, check_errs["bf16"]),
        "max_abs_err_fp32": check_errs["fp32"],
        **{k: total(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
        "shapes": rows,
    }


def realbasicvsr_phase(device, card):
    """Phase 3. Returns each residual-pair kernel's launches by input shape."""
    import torch

    from vsrlab_tpu_torch.evaluation.harness import (
        make_forward, make_stream_forward, windowed_inference)
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl

    model = build_model(torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    clip = torch.rand((1, 20, 180, 320, 3), generator=g)
    t0 = time.perf_counter()
    res = run_main_path(model, clip, device)
    torch.cuda.synchronize()
    log(f"  served 3 requests in {time.perf_counter() - t0:.2f} s (first use included)")
    expect = {"windowed": (1, 20, 720, 1280, 3), "first": (1, 10, 720, 1280, 3),
              "rest": (1, 10, 720, 1280, 3)}
    for name, shape in expect.items():
        out = res[name]
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: shape {tuple(out.shape)} (want {shape}) or non-finite")
        log(f"  {name}: {tuple(out.shape)} finite, range [{float(out.min()):.3f}, "
            f"{float(out.max()):.3f}]")
    # each call runs one formulation: taps for windowed and first, im2col for rest
    uses = {"windowed": "taps", "first": "taps", "rest": "im2col"}
    for name, form in uses.items():
        by_shape = res["calls"][name]
        log(f"  {name} launches by input shape: "
            + ", ".join(f"{f} {dict(c)}" for f, c in by_shape.items()))
        totals = {f: sum(c.values()) for f, c in by_shape.items()}
        want = {f: LAUNCHES_PER_FORWARD if f == form else 0 for f in KERNELS}
        if totals != want:
            raise AssertionError(f"{name}: launches {totals} != {want}")
    if res["n_windows"] != 2:
        raise AssertionError(f"{res['n_windows']} windows != 2")

    # each window of the stream through the plain pair (rest from the same
    # state as the kernel's rest), and in fp32 (TF32 off)
    windows = (clip[:, :10], clip[:, 10:])
    set_pair_impl(model, "plain")
    first, rest = make_stream_forward(model, device)
    plain = (first(windows[0])[0].float(), rest(windows[1], res["state"])[0].float())
    set_pair_impl(model, "taps")
    model32 = build_model(None)
    model32.load_state_dict(model.state_dict())
    set_pair_impl(model32, "plain")
    first, rest = make_stream_forward(model32, device)
    ref0, state32 = first(windows[0])
    ref32 = (ref0.float(), rest(windows[1], state32)[0].float())

    def dev(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.pow(2).mean().sqrt())

    # gate: a path as accurate as the plain bf16 one lies within (plain vs
    # fp32) of fp32, so two such paths lie within twice that of each other
    taps, im2col = res["first"].float(), res["rest"].float()
    cases = (
        (0, "taps vs plain (bf16)", taps, plain[0]),
        (0, "taps vs fp32", taps, ref32[0]),
        (0, "windowed (batch 2) vs first (batch 1)", res["windowed"][:, :10].float(), taps),
        (1, "im2col vs plain (bf16)", im2col, plain[1]),
        (1, "im2col vs fp32", im2col, ref32[1]),
    )
    gates = [dev(plain[i], ref32[i]) for i in range(2)]
    for i, (b_max, b_rms) in enumerate(gates):
        log(f"  window {i}: plain bf16 vs fp32: max {b_max:.4e}, rms {b_rms:.4e}; gate: 2x that")
    for i, name, a, b in cases:
        b_max, b_rms = gates[i]
        d_max, d_rms = dev(a, b)
        log(f"  window {i}: {name}: max {d_max:.4e} ({d_max / b_max:.2f}x), rms {d_rms:.4e} "
            f"({d_rms / b_rms:.2f}x)")
        if not (d_max <= 2 * b_max and d_rms <= 2 * b_rms):
            raise AssertionError(f"{name} deviates by more than twice bf16's own deviation")

    forward = make_forward(model, device=device)
    requests = {
        "clip10": (10, lambda: forward(windows[0])),
        "windowed20": (20, lambda: windowed_inference(forward, clip, 10)),
    }
    fps = {}
    for name, (frames, request) in requests.items():
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fps[name] = frames / statistics.median(times)
    log(f"  frames/s on {card}: 10-frame clip {fps['clip10']:.2f}, "
        f"20-frame clip as 2 windows {fps['windowed20']:.2f} (median of 5, host clock, "
        "input upload included)")
    log(json.dumps({"fps": fps, "card": card}))
    prof = profile_request(requests["clip10"][1], 10 / fps["clip10"])
    if "own_kernels_ms" in prof:
        log(f"  clip10: {fps['clip10']:.2f} frames/s is {prof['wall_ms']:.2f} ms a request on the "
            f"host's clock; on the device {prof['device_ms']:.2f} ms, of which the residual "
            f"pair's kernels {prof['own_kernels_ms']:.2f} ms (torch.profiler, one request)")
    log(json.dumps({"profile_clip10": prof}))
    return res["launches_by_shape"], fp32_request(model32, windows[0], device, card)


def fp32_request(model32, clip, device, card):
    """Phase 3, fp32: one ``make_forward`` clip10 request of the headline
    model in fp32 (``precision: fp32``) with the ``taps`` route, TF32 off:
    660 pair launches by shape, all in the fp32 kernel; the output finite,
    of the right shape and within ``FP32_REQUEST_TOL`` of the same model on
    the plain route; frames/s (median of 5), device ms and busy share.
    Returns each kernel's launches by shape."""
    import torch

    from vsrlab_tpu_torch.evaluation.harness import make_forward
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.ops.residual_pair import reset_launch_counts

    before = tf32(False)
    forward = make_forward(model32, device=device)
    set_pair_impl(model32, "taps")
    reset_launch_counts()
    got = forward(clip)
    torch.cuda.synchronize()
    launches = pair_counts()
    gate_counts("fp32 clip10 request (taps)", launches,
                {"taps": window_launches(1, *clip.shape[2:4])})
    set_pair_impl(model32, "plain")
    want = forward(clip)
    set_pair_impl(model32, "taps")
    shape = (1, 10, 4 * clip.shape[2], 4 * clip.shape[3], 3)
    if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"fp32 request: shape {tuple(got.shape)} (want {shape}) or non-finite")
    err = float((got - want).abs().max())
    log(f"  fp32 clip10: max |kernel - plain| = {err:.3e} (tol {FP32_REQUEST_TOL}, output range "
        f"[{float(want.min()):.3f}, {float(want.max()):.3f}])")
    if not err <= FP32_REQUEST_TOL:
        raise AssertionError("the fp32 request with the kernel differs from the plain route's")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(clip)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    prof = profile_request(lambda: forward(clip), wall, ours=("pair_fp32",))
    log(f"  fp32 clip10 on {card}: {10 / wall:.2f} frames/s (median of 5, host clock, upload "
        "included)" + (f"; device {prof['device_ms']:.2f} ms (busy {100 * prof['device_busy_share']:.1f}"
                       f" %), the fp32 pair kernel {prof['own_kernels_ms']:.2f} ms (torch.profiler, "
                       "one request)" if "wall_ms" in prof else ""))
    log(json.dumps({"fp32_clip10": {"fps": 10 / wall, "max_abs_err_plain": err, "card": card,
                                    "profile": prof}}))
    tf32(before)
    return launches


def tf32(on: bool):
    """Set cuDNN's TF32 for convolutions; returns the previous setting. The
    bf16 training runs take it on (PyTorch's default): their fp32 convs (the
    plain pair, the recomputed conv1) multiply bf16 values, which TF32 holds
    exactly. fp32 references take it off."""
    import torch

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    return before


def dev(a, b):
    """``(max, rms)`` of ``|a - b|`` in fp32."""
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.pow(2).mean().sqrt())


def within_twice(label, a, b, base) -> tuple[float, float]:
    """Raises unless ``|a - b|`` lies within twice ``base``, the ``(max,
    rms)`` deviation of the plain bf16 path from fp32; returns the two ratios."""
    d_max, d_rms = dev(a, b)
    b_max, b_rms = base
    if not (d_max <= 2 * b_max and d_rms <= 2 * b_rms):
        raise AssertionError(f"{label}: max {d_max:.3e} rms {d_rms:.3e} against twice the plain "
                             f"bf16 path's max {b_max:.3e} rms {b_rms:.3e}")
    return (d_max / b_max if b_max else 0.0), (d_rms / b_rms if b_rms else 0.0)


def pair_grad_run(fn, ops, g):
    """``fn(*ops)`` on fresh leaves, backward with ``g``: the output and
    the five gradients, in fp32."""
    leaves = [t.detach().clone().requires_grad_(True) for t in ops]
    out = fn(*leaves)
    out.backward(g)
    return [out.detach().float()] + [t.grad.float() for t in leaves]


def check_pair_grad(form, shape, device) -> dict:
    """The training phase's first gate: ``ResidualPair`` (kernel forward,
    PyTorch backward) against autograd through ``residual_conv_pair_plain``,
    the same upstream gradient: output and ``dx, dW1, db1, dW2, db2``. fp32
    with TF32 off at ``1e-4 + 1e-4*|plain|``; bf16: each against an fp32 run
    within twice the plain bf16 path's deviation from it, in max and rms.
    Returns the largest fp32 error and the largest bf16 ratio."""
    import torch

    from vsrlab_tpu_torch.ops.residual_pair import residual_conv_pair_plain, residual_pair

    names = ("out", "dx", "dW1", "db1", "dW2", "db2")
    ops32 = pair_operands(shape, torch.float32, 11, device)
    g32 = torch.randn(shape, generator=torch.Generator().manual_seed(12)).to(device)
    kernel = functools.partial(residual_pair, formulation=form)
    before = tf32(False)
    got, want = pair_grad_run(kernel, ops32, g32), pair_grad_run(residual_conv_pair_plain, ops32, g32)
    err32 = 0.0
    for name, a, b in zip(names, got, want):
        e = (a - b).abs()
        if not bool((e <= TOL["fp32"] + TOL["fp32"] * b.abs()).all()):
            raise AssertionError(f"{form} fp32 {shape} {name}: max {float(e.max()):.3e}")
        err32 = max(err32, float(e.max()))
    ops16 = tuple(t.bfloat16() if t.dim() > 1 else t for t in ops32)
    tf32(True)
    got16 = pair_grad_run(kernel, ops16, g32.bfloat16())
    plain16 = pair_grad_run(residual_conv_pair_plain, ops16, g32.bfloat16())
    tf32(before)
    ratios = {n: within_twice(f"{form} bf16 {shape} {n}", a, r, dev(p, r))
              for n, a, p, r in zip(names, got16, plain16, want)}
    worst = max(max(r) for r in ratios.values())
    log(f"  ResidualPair {form:6s} {shape}: fp32 max|fn-plain| {err32:.3e} (tol 1e-4 + "
        f"1e-4*|plain|) ok; bf16 vs fp32 as a ratio of plain bf16's deviation (max, rms): "
        + ", ".join(f"{n} {r[0]:.2f} {r[1]:.2f}" for n, r in ratios.items()) + " ok")
    return {"fp32": err32, "bf16_ratio": worst}


def train_batch(device):
    """The train leg's batch: LR (4, 6, 64, 64, 3), HR x4, uniform in [0, 1)
    from a seeded numpy generator."""
    import numpy as np
    import torch

    b, t, h, w = TRAIN_CLIP
    rng = np.random.default_rng(1)
    lr = torch.from_numpy(rng.random((b, t, h, w, 3), dtype=np.float32)).to(device)
    hr = torch.from_numpy(rng.random((b, t, 4 * h, 4 * w, 3), dtype=np.float32)).to(device)
    return {"lr": lr, "hr": hr}


def step_grads(model, batch, impl):
    """The gradient of one train step's loss (no update), by parameter
    name, zeros where a parameter gets none (as the optimizer sees it)."""
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.train.step import supervised_loss

    set_pair_impl(model, impl)
    model.zero_grad(set_to_none=True)
    loss, _ = supervised_loss(model(batch["lr"]), batch)
    loss.backward()
    set_pair_impl(model, "taps")
    return {n: (p.grad if p.grad is not None else p.new_zeros(p.shape)).detach().clone()
            for n, p in model.named_parameters()}


def gate_grads(label, taps, plain, ref) -> dict:
    """Each parameter's gradient (by name) with ``taps`` against ``plain``
    and the fp32 run ``ref``, within twice plain bf16's deviation from fp32
    (max and rms); finite and nonzero outside SpyNet, zero in it
    (``train_flow: false``). Returns the worst ratios with their names."""
    import torch

    worst = {"max": (0.0, ""), "rms": (0.0, "")}
    for name in ref:
        frozen, g = ".spynet." in name, taps[name]
        if bool(g.abs().sum() > 0) == frozen or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: gradient finite and nonzero outside SpyNet, zero "
                                 f"inside it; got |g| sum {float(g.abs().sum()):.3e}")
        if frozen:
            continue
        base = dev(plain[name], ref[name])
        r = within_twice(f"{label} of {name}, taps vs fp32", g, ref[name], base)
        within_twice(f"{label} of {name}, taps vs plain", g, plain[name], base)
        for i, k in enumerate(("max", "rms")):
            worst[k] = max(worst[k], (r[i], name))
    return worst


def gate_step_grads(model, batch, device) -> dict:
    """One step of the full model: each parameter tensor's gradient with
    ``taps`` against the same step with ``plain`` and an fp32 run (TF32 off),
    by the twice-the-bf16-deviation rule; every parameter outside SpyNet
    finite and nonzero, SpyNet's zero (``train_flow: false``)."""
    before = tf32(True)
    taps, plain = step_grads(model, batch, "taps"), step_grads(model, batch, "plain")
    model32 = build_model(None).to(device)
    model32.load_state_dict(model.state_dict())
    tf32(False)
    ref = step_grads(model32, batch, "plain")
    tf32(before)
    del model32
    worst = gate_grads("gradient", taps, plain, ref)
    n = sum(1 for k in ref if ".spynet." not in k)
    log(f"  one step's gradients, {n} parameter tensors outside SpyNet: taps vs fp32 within "
        f"twice plain bf16's deviation, worst ratio max {worst['max'][0]:.2f} "
        f"({worst['max'][1]}), rms {worst['rms'][0]:.2f} ({worst['rms'][1]}); taps vs plain "
        f"within the same; SpyNet's {len(ref) - n} tensors get zero")
    return {"grad_ratio_max": worst["max"][0], "grad_ratio_rms": worst["rms"][0]}


def run_train_path(state, step, batch):
    """The training main path: one train step with ``taps``, then one with
    ``im2col``. Returns each kernel's launches by input shape, per step and
    over both."""
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.ops.residual_pair import PAIR_IMPLS, reset_launch_counts

    def counts():
        return {form: PAIR_IMPLS[form].launches_by_shape.copy() for form in KERNELS}

    calls = {}
    reset_launch_counts()
    seen = counts()
    for form in KERNELS:
        set_pair_impl(state.model, form)
        step(state, batch)
        now = counts()
        calls[form], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    set_pair_impl(state.model, "taps")
    return calls, seen


def time_steps(model, step, impl, n=10, warmup=3) -> list:
    """Host seconds of ``n`` calls of ``step()`` (a train step) after
    ``warmup``, each ended by a synchronize, with ``model``'s pair ``impl``."""
    import torch

    from vsrlab_tpu_torch.nn.blocks import set_pair_impl

    set_pair_impl(model, impl)
    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    set_pair_impl(model, "taps")
    return times


# the train step's parts by kernel name (torch.profiler), the first that matches
TRAIN_GROUPS = (
    ("pair forward", ("pair_taps", "pair_im2col")),
    ("cuDNN dgrad", ("dgrad",)),
    ("cuDNN wgrad", ("wgrad",)),
    ("tf32 convs (the recomputed conv1)", ("tf32",)),
    ("other convs", ("conv", "fprop", "implicit", "xmma", "cudnn")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
)


def e2e_trainer(device, card) -> None:
    """``train.run`` on SyntheticVSR at the headline width (HR 256x256, x4,
    6 frames, 8 clips, batch 4, one epoch with eval): a checkpoint and a
    JSONL log, then a second run restored from it with ``restore_opt``,
    whose restored parameters equal the saved ones."""
    import torch

    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
    from vsrlab_tpu_torch.core.config import Config
    from vsrlab_tpu_torch.train import train as trainer
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train")
    if os.path.isdir(root):
        import shutil

        shutil.rmtree(root)
    b, t, h, w = TRAIN_CLIP
    data = {"_target_": "SyntheticVSR", "seq": t, "height": 4 * h, "width": 4 * w, "scale": 4}
    cfg = Config.from_dict({"seed_index": 0, "train": {
        "model": {"_target_": "RealBasicVSR", **HEADLINE},
        "precision": "bf16", "optimizer": {"_target_": "adam", "lr": 1e-4},
        "gradient_clip_val": 1.0, "max_epochs": 1,
        "data": {"batch_size": b, "num_workers": 4, "datasets": {
            "train": {**data, "num_videos": 2 * b, "split": "train"},
            "val": {**data, "num_videos": b, "split": "val"}}},
        "logger": {"_target_": "Logger", "backend": "jsonl", "save_dir": f"{root}/logs",
                   "project": "chip_smoke", "id": "train"},
        "checkpoint_dir": f"{root}/ckpt"}})
    t0 = time.perf_counter()
    val = trainer.run(cfg, device)
    t1 = time.perf_counter()
    mgr = CheckpointManager(f"{root}/ckpt")
    saved = mgr.restore()[1]["params"]
    rows = open(f"{root}/logs/chip_smoke/train/metrics.jsonl").read().splitlines()
    if mgr.all_keys() != [0] or not any("Loss/Val" in r for r in rows) or not val:
        raise AssertionError(f"trainer: keys {mgr.all_keys()}, {len(rows)} log rows, val {val}")
    cfg2 = Config.from_dict(cfg.to_dict())
    cfg2.train.update({"restore": f"{root}/ckpt", "restore_opt": True, "max_epochs": 2})
    model = trainer.build_model(cfg2.train.model, "bf16").to(device)
    state = create_train_state(model, build_tx(model.parameters(), cfg2.train.optimizer))
    state, epoch, _ = trainer.restore_state(state, cfg2.train, mgr, f"{root}/ckpt",
                                            steps_per_epoch=2)
    same = all(torch.equal(v.cpu(), saved[k]) for k, v in model.state_dict().items())
    if not same or (epoch, state.step, state.tx.count) != (1, 2, 2):
        raise AssertionError(f"restore: parameters equal {same}, epoch {epoch}, step "
                             f"{state.step}, updates {state.tx.count}")
    del model, state
    t2 = time.perf_counter()
    val2 = trainer.run(cfg2, device)
    if mgr.all_keys() != [0, 1] or not val2:
        raise AssertionError(f"resumed run: keys {mgr.all_keys()}")
    log(f"  train.run: SyntheticVSR {2 * b} clips of {t}x{4 * h}x{4 * w}, batch {b}, one epoch "
        f"and eval in "
        f"{t1 - t0:.1f} s (model build and first use included): val {json.dumps(val)}; "
        f"restored with restore_opt (parameters equal to those saved, epoch 1, 2 updates), "
        f"resumed epoch in {time.perf_counter() - t2:.1f} s: val {json.dumps(val2)}")


def training_phase(device, card):
    """Phase 5. Returns each residual-pair kernel's launches by input shape
    over the training main path."""
    import torch

    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.ops.residual_pair import pair_launch_plan
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    for shape in TRAIN_SHAPES:
        for form in KERNELS:
            log(f"  pair_launch_plan {form:6s} {shape}: {pair_launch_plan(form, shape, device)}")
    laps = Laps()
    grad_checks = {form: {str(shape): check_pair_grad(form, shape, device)
                          for shape in TRAIN_SHAPES} for form in KERNELS}
    laps("the pair's gradient")
    model = build_model(torch.bfloat16).to(device).train()
    batch = train_batch(device)
    gates = gate_step_grads(model, batch, device)
    laps("the step's gradients")
    before = tf32(True)
    state = create_train_state(model, build_tx(model.parameters(), ("adam", {"lr": 1e-4}), None,
                                               1.0))
    step = make_supervised_train_step(model)
    spynet0 = {n: p.detach().clone() for n, p in model.named_parameters() if ".spynet." in n}

    calls, launches = run_train_path(state, step, batch)
    laps("the main path")
    for form, by_shape in calls.items():
        log(f"  train step ({form}) launches by input shape: "
            + ", ".join(f"{f} {dict(c)}" for f, c in by_shape.items()))
        for f in KERNELS:
            want = TRAIN_LAUNCHES if f == form else {}
            if dict(by_shape[f]) != want:
                raise AssertionError(f"train step ({form}): {f} launches {dict(by_shape[f])} "
                                     f"!= {want}")

    losses = []
    for _ in range(20):
        _, m = step(state, batch)
        losses.append(float(m["Loss"]))
    log(f"  20 steps on one batch (taps): loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(torch.equal(p, spynet0[n]) for n, p in model.named_parameters() if n in spynet0):
        raise AssertionError("SpyNet's parameters moved under train_flow: false")
    laps("20 steps")

    # the trained weights served through each pair and an fp32 run: the
    # kernel's cached weight order followed the 22 updates
    with torch.no_grad():
        sr = {}
        for impl in ("taps", "plain"):
            set_pair_impl(model, impl)
            sr[impl] = model(batch["lr"])[0].float()
        set_pair_impl(model, "taps")
        model32 = build_model(None).to(device)
        model32.load_state_dict(model.state_dict())
        set_pair_impl(model32, "plain")
        tf32(False)
        ref = model32(batch["lr"])[0].float()
        tf32(True)
        del model32
    ratio = within_twice("trained weights: taps forward vs fp32", sr["taps"], ref,
                         dev(sr["plain"], ref))
    log(f"  trained weights, no grad: taps vs fp32 at {ratio[0]:.2f}x / {ratio[1]:.2f}x (max / "
        "rms) of plain bf16's deviation")
    del sr, ref
    laps("served")

    # the plain route's step (the library yardstick) is timed no more: PERF.md holds its
    # figures, and its timing and profile were a large share of the phase
    frames = TRAIN_CLIP[0] * TRAIN_CLIP[1]
    torch.cuda.reset_peak_memory_stats()
    times = time_steps(model, lambda: step(state, batch), "taps", n=5, warmup=2)
    med = statistics.median(times)
    timing = {"taps": {"train_step_ms": med * 1e3, "train_fps": frames / med,
                       "steps_ms": [t * 1e3 for t in times],
                       "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}}
    log(f"  train step on {card}: taps {timing['taps']['train_step_ms']:.2f} ms "
        f"({timing['taps']['train_fps']:.2f} frames/s) (median of 5 after 2, host clock with "
        f"synchronize; peak memory {timing['taps']['max_memory_allocated_gib']:.2f} GiB)")
    timing["taps"]["profile"] = profile_request(
        lambda: step(state, batch), med, top=15, ours=("pair_taps",), groups=TRAIN_GROUPS,
        host=False)
    laps("timings and profiles")
    prof = timing["taps"]["profile"]
    if "own_kernels_ms" in prof:
        log(f"  taps step: {prof['wall_ms']:.2f} ms on the host's clock, {prof['device_ms']:.2f} "
            f"ms on the device (busy {100 * prof['device_busy_share']:.1f} %) in "
            f"{prof['device_ops']} kernels and copies; by part: "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["groups_ms"].items()))
    log(json.dumps({"train": {**timing, "card": card, "gates": gates, "pair_grad": grad_checks,
                              "losses": losses, "cudnn_tf32": True}}))
    tf32(before)
    del state, step, model, batch
    torch.cuda.empty_cache()
    e2e_trainer(device, card)
    laps("train.run")
    laps.log("phase 5")
    return launches


# phase 8: GAN fine-tuning at the JAX bench's GAN leg (bench.py:585-647)
GAN_ADV = 2e-5
GAN_DEGRADE = [{"_target_": "RandomJPEGCompression", "quality": [30, 95]},
               {"_target_": "RandomVideoCompression", "crf": [18, 35], "fps": [10, 30]}]
GAN_STEPS = 20


def gan_modules(device, dtype):
    """Phase 8's networks: the headline RealBasicVSR (phase 3's seeded
    weights) and ``UNetDiscriminator(64)`` (seeded) in ``dtype`` (None:
    fp32), and the perceptual VGG19 in fp32 (its default seeded init)."""
    import torch

    from vsrlab_tpu_torch.core.perceptual import PerceptualLoss
    from vsrlab_tpu_torch.models import UNetDiscriminator
    from vsrlab_tpu_torch.nn.blocks import init_weights

    disc = UNetDiscriminator(mid_channels=64, dtype=dtype)
    init_weights(disc, torch.Generator().manual_seed(1))
    return (build_model(dtype).to(device).train(), disc.to(device).train(),
            PerceptualLoss(weight=1e-2).to(device))


def gan_states(model, disc, opt=("adam", {"lr": 1e-4}), clip=1.0):
    """Train states of both networks: Adam at 1e-4 with a clip of 1.0 each,
    as the bench's GAN leg builds them."""
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state

    return (create_train_state(model, build_tx(model.parameters(), opt, None, clip)),
            create_train_state(disc, build_tx(disc.parameters(), opt, None, clip)))


def gan_step_grads(model, disc, perc, batch, impl):
    """The gradients of one GAN step (``make_gan_train_step``, updates by
    SGD at lr 0 without a clip, so no parameter moves), every G and D
    parameter by name (zeros where none came), with the D state after its
    half; the D state is put back afterwards."""
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.train.gan import make_gan_train_step

    set_pair_impl(model, impl)
    d0 = {k: v.clone() for k, v in disc.state_dict().items()}
    g, d = gan_states(model, disc, ("sgd", {"lr": 0.0}), None)
    make_gan_train_step(model, disc, perc, GAN_ADV)(g, d, batch)
    grads = {}
    for tag, net in (("G", model), ("D", disc)):
        for n, p in net.named_parameters():
            grads[f"{tag}.{n}"] = (p.grad if p.grad is not None else p.new_zeros(p.shape)).clone()
        net.zero_grad(set_to_none=True)
    stats = {k: v.clone() for k, v in disc.state_dict().items() if k.endswith((".u", ".sigma"))}
    disc.load_state_dict(d0)
    set_pair_impl(model, "taps")
    return grads, stats


def gate_gan_grads(model, disc, perc, batch, device) -> dict:
    """One GAN step's gradient of every G and D parameter tensor with
    ``taps`` against ``plain`` and an fp32 run (fp32 G and D, TF32 off) by
    phase 5's rule; every G parameter outside SpyNet and every D parameter
    finite and nonzero, SpyNet's zero. The D state after the D half against
    the fp32 run's: the power iteration reads only the fp32 weights and
    ``u``, so rtol 1e-5."""
    from vsrlab_tpu_torch.models import UNetDiscriminator

    before = tf32(True)
    taps, stats = gan_step_grads(model, disc, perc, batch, "taps")
    plain, _ = gan_step_grads(model, disc, perc, batch, "plain")
    model32 = build_model(None).to(device).train()
    model32.load_state_dict(model.state_dict())
    disc32 = UNetDiscriminator(mid_channels=64).to(device).train()
    disc32.load_state_dict(disc.state_dict())
    tf32(False)
    ref, stats32 = gan_step_grads(model32, disc32, perc, batch, "plain")
    tf32(before)
    del model32, disc32
    worst = gate_grads("GAN gradient", taps, plain, ref)
    stat_err = 0.0
    for k, v in stats.items():
        e = (v - stats32[k]).abs()
        if not bool((e <= 1e-5 * (1 + stats32[k].abs())).all()):
            raise AssertionError(f"D state {k} after the D half: max {float(e.max()):.3e} from "
                                 "the fp32 run's")
        stat_err = max(stat_err, float(e.max()))
    n_g = sum(1 for k in ref if k.startswith("G.") and ".spynet." not in k)
    log(f"  one GAN step's gradients, {n_g} G tensors outside SpyNet and "
        f"{sum(1 for k in ref if k.startswith('D.'))} D tensors: taps vs fp32 within twice plain "
        f"bf16's deviation, worst ratio max {worst['max'][0]:.2f} ({worst['max'][1]}), rms "
        f"{worst['rms'][0]:.2f} ({worst['rms'][1]}); taps vs plain within the same; SpyNet's "
        f"tensors get zero; D's u / sigma after its half within {stat_err:.2e} of fp32's")
    return {"grad_ratio_max": worst["max"][0], "grad_ratio_rms": worst["rms"][0],
            "d_state_max_err": stat_err}


def gan_parts(model, disc, perc, g, d, batch) -> dict:
    """The step's parts, each as a call of its own: G's forward and backward
    (the pixel loss), the VGG19 loss with its backward to ``sr``, D in the G
    half with its backward to ``sr``, the D half, both optimizers."""
    import torch

    from vsrlab_tpu_torch.core.losses import adversarial_loss, charbonnier_loss
    from vsrlab_tpu_torch.train.step import _resize_clip_to

    lr, hr = batch["lr"], batch["hr"]
    with torch.no_grad():
        sr0 = model(lr)[0]

    def g_fb():
        sr, lq = model(lr)
        (charbonnier_loss(sr, hr) + charbonnier_loss(lq, _resize_clip_to(hr, lq))).backward()

    def vgg():
        perc(sr0.detach().requires_grad_(True), hr).backward()

    def d_in_g():
        disc.requires_grad_(False)
        sr = sr0.detach().requires_grad_(True)
        adversarial_loss(disc(sr.flatten(0, 1)), 1.0, weight=GAN_ADV).backward()
        disc.requires_grad_(True)

    def d_half():
        loss = (adversarial_loss(disc(hr.flatten(0, 1), update_stats=True), 1.0, True)
                + adversarial_loss(disc(sr0.flatten(0, 1), update_stats=True), 0.0, True))
        loss.backward()

    def optimizers():
        g.tx.step()
        d.tx.step()

    return {"G forward and backward": g_fb, "VGG19 (perceptual)": vgg, "D in the G half": d_in_g,
            "D half": d_half, "optimizers": optimizers}


def gan_e2e(device, card) -> dict:
    """``train.gan.run`` restored from phase 5's supervised checkpoint
    (``finetune``): SyntheticVSR at HR 256x256, x4, 6 frames, degraded by
    JPEG and the codec emulator, 8 clips, batch 4, two epochs (the first
    with G frozen), checkpoints under ``build/chip_smoke_gan/``; then
    ``load_test_model`` serves the result. Returns the pair launches."""
    import shutil

    import torch

    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
    from vsrlab_tpu_torch.core.config import Config
    from vsrlab_tpu_torch.evaluation.harness import load_test_model, make_forward
    from vsrlab_tpu_torch.ops import residual_pair as rp
    from vsrlab_tpu_torch.train import gan

    here = os.path.dirname(os.path.abspath(__file__))
    src, root = f"{here}/build/chip_smoke_train/ckpt", f"{here}/build/chip_smoke_gan"
    shutil.rmtree(root, ignore_errors=True)
    b, t, h, w = TRAIN_CLIP
    data = {"_target_": "SyntheticVSR", "seq": t, "height": 4 * h, "width": 4 * w, "scale": 4}
    opt = {"_target_": "adam", "lr": 1e-4}
    cfg = Config.from_dict({"seed_index": 0, "train": {
        "model": {"_target_": "RealBasicVSR", **HEADLINE}, "precision": "bf16",
        "discriminator": {"_target_": "UNetDiscriminator", "mid_channels": 64,
                          "dtype": "bfloat16"},
        "perceptual_loss": {"_target_": "PerceptualLoss", "weight": 1e-2},
        "adversarial_loss": {"_target_": "AdversarialLoss", "weight": GAN_ADV},
        "optimizer": {"generator": opt, "discriminator": opt}, "gradient_clip_val": 1.0,
        "max_epochs": 2, "freeze_epochs": 0, "restore": src, "finetune": True,
        "data": {"batch_size": b, "num_workers": 4, "datasets": {
            "train": {**data, "num_videos": 2 * b, "split": "train",
                      "lr_augmentation": GAN_DEGRADE},
            "val": {**data, "num_videos": b, "split": "val"}}},
        "logger": {"_target_": "Logger", "backend": "jsonl", "save_dir": f"{root}/logs",
                   "project": "chip_smoke", "id": "gan"},
        "checkpoint_dir": f"{root}/ckpt"}})
    rp.reset_launch_counts()
    t0 = time.perf_counter()
    val = gan.run(cfg, device)
    run_s = time.perf_counter() - t0
    counts = pair_counts()
    # 2 steps an epoch (epoch 0 frozen: no-grad forwards), one val batch an epoch
    gate_counts("train.gan.run", counts, {"taps": {s: 6 * n for s, n in TRAIN_LAUNCHES.items()}})
    mgr = CheckpointManager(f"{root}/ckpt")
    start = CheckpointManager(src).restore()[1]["params"]
    frozen, trained = mgr.restore(0)[1]["params"], mgr.restore(1)[1]["params"]
    rows = open(f"{root}/logs/chip_smoke/gan/metrics.jsonl").read().splitlines()
    if mgr.all_keys() != [0, 1] or not val or not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"train.gan.run: keys {mgr.all_keys()}, val {val}")
    if not all(torch.equal(v, start[k]) for k, v in frozen.items()):
        raise AssertionError("the frozen epoch moved the generator restored from phase 5")
    if all(torch.equal(v, frozen[k]) for k, v in trained.items()):
        raise AssertionError("the second epoch did not train the generator")
    train_rows = [json.loads(r) for r in rows if "LossDiscriminator/Train" in r]
    if len(train_rows) != 2 or not all(math.isfinite(v) for r in train_rows for v in r.values()
                                       if isinstance(v, float)):
        raise AssertionError(f"train.gan.run logged {train_rows}")
    log(f"  train.gan.run: restored phase 5's checkpoint (finetune), SyntheticVSR {2 * b} clips "
        f"of {t}x{4 * h}x{4 * w} degraded by JPEG and the codec emulator, batch {b}, 2 epochs "
        f"(epoch 0 frozen: G bitwise equal to phase 5's) in {run_s:.1f} s (builds and first use "
        f"included); losses {json.dumps(train_rows[-1])}; val {json.dumps(val)}")

    hs, ws = SERVE_LR
    clip10 = torch.rand((1, 10, hs, ws, 3), generator=torch.Generator().manual_seed(8))
    model, _ = load_test_model(f"{root}/ckpt", device=device)
    ref = build_model(torch.bfloat16)
    ref.load_state_dict(trained)
    rp.reset_launch_counts()
    served = make_forward(model, device=device)(clip10)
    serve_counts = pair_counts()
    gate_counts("load_test_model, one request", serve_counts,
                {"taps": window_launches(1, hs, ws)})
    want = make_forward(ref, device=device)(clip10)
    if not torch.equal(served, want) or not bool(torch.isfinite(served).all()):
        raise AssertionError("the served GAN checkpoint differs from the trained weights' forward")
    log(f"  load_test_model served the fine-tuned generator: {tuple(served.shape)}, finite, "
        "bitwise equal to make_forward on a module loaded with the last checkpoint")
    del model, ref
    for form in KERNELS:
        counts[form] += serve_counts[form]
    return counts


def degradation_cost() -> dict:
    """Host ms of the GAN run's degradation pipeline (JPEG, then the codec
    emulator) on one clip, median of 5, at the step's 6x64x64 and at a
    serving window's 10x180x320, and of each stage alone."""
    import numpy as np

    from vsrlab_tpu_torch.data import SyntheticVSR, build_pipeline

    out = {}
    for t, h, w in ((TRAIN_CLIP[1], TRAIN_CLIP[2], TRAIN_CLIP[3]), (10, *SERVE_LR)):
        clip = SyntheticVSR(num_videos=1, seq=t, height=4 * h, width=4 * w, scale=4)[0][0]
        row = {}
        for name, specs in (("pipeline", GAN_DEGRADE), ("jpeg", GAN_DEGRADE[:1]),
                            ("codec", GAN_DEGRADE[1:])):
            pipe, times = build_pipeline(specs), []
            for i in range(6):
                t0 = time.perf_counter()
                pipe(clip, np.random.default_rng(i))
                times.append(time.perf_counter() - t0)
            row[f"{name}_host_ms"] = statistics.median(times[1:]) * 1e3
        out[f"{t}x{h}x{w}"] = row
    return out


def gan_phase(device, card):
    """Phase 8. Returns each residual-pair kernel's launches by input shape
    over the phase's main path."""
    import collections

    import torch

    from vsrlab_tpu_torch.ops import residual_pair as rp
    from vsrlab_tpu_torch.train.gan import make_gan_train_step

    seen = {f: collections.Counter() for f in KERNELS}
    laps = Laps()
    model, disc, perc = gan_modules(device, torch.bfloat16)
    batch = train_batch(device)
    gates = gate_gan_grads(model, disc, perc, batch, device)
    laps("gates")
    before = tf32(True)

    g, d = gan_states(model, disc)
    step = make_gan_train_step(model, disc, perc, GAN_ADV)
    rp.reset_launch_counts()
    step(g, d, batch)
    counts = pair_counts()
    gate_counts("one GAN step (taps)", counts, {"taps": TRAIN_LAUNCHES})
    for form in KERNELS:
        seen[form] += counts[form]

    frozen = make_gan_train_step(model, disc, perc, GAN_ADV, update_generator=False)
    g0 = {k: v.clone() for k, v in model.state_dict().items()}
    d0 = {k: v.clone() for k, v in disc.state_dict().items()}
    rp.reset_launch_counts()
    frozen(g, d, batch)
    counts = pair_counts()
    gate_counts("one frozen GAN step (no-grad forward)", counts, {"taps": TRAIN_LAUNCHES})
    for form in KERNELS:
        seen[form] += counts[form]
    moved = {k for k, v in disc.state_dict().items() if not torch.equal(v, d0[k])}
    if not all(torch.equal(v, g0[k]) for k, v in model.state_dict().items()):
        raise AssertionError("a frozen GAN step moved the generator")
    if not {"conv_0.weight", "conv_9.weight"} | {f"conv_{i}.u" for i in range(1, 9)} <= moved:
        raise AssertionError(f"a frozen GAN step left D (or its u) in place: moved {sorted(moved)}")
    log(f"  frozen step: G bitwise unchanged, {len(moved)} of {len(d0)} D tensors moved "
        "(weights and every u)")

    losses = []
    for _ in range(GAN_STEPS):
        _, _, m = step(g, d, batch)
        losses.append({k: float(v) for k, v in m.items()})
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"a GAN step's loss is not finite: {losses}")
    laps("the main path and the steps")
    log(f"  {GAN_STEPS} GAN steps on one batch (taps): every loss finite; Loss "
        f"{losses[0]['Loss']:.5f} -> {losses[-1]['Loss']:.5f}, LossDiscriminator "
        f"{losses[0]['LossDiscriminator']:.5f} -> {losses[-1]['LossDiscriminator']:.5f}")

    # the plain route's step is timed no more (phase 5's reason); the profiles trace the
    # card alone
    frames = TRAIN_CLIP[0] * TRAIN_CLIP[1]
    torch.cuda.reset_peak_memory_stats()
    times = time_steps(model, lambda: step(g, d, batch), "taps", n=5, warmup=2)
    med = statistics.median(times)
    timing = {"taps": {"gan_step_ms": med * 1e3, "gan_fps": frames / med,
                       "steps_ms": [x * 1e3 for x in times],
                       "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}}
    timing["taps"]["profile"] = profile_request(
        lambda: step(g, d, batch), med, top=15, ours=("pair_taps",), groups=TRAIN_GROUPS,
        host=False)
    laps("timings and profiles")
    parts = {name: profile_request(fn, 1.0, host=False)["device_ms"]
             for name, fn in gan_parts(model, disc, perc, g, d, batch).items()}
    laps("the parts")
    prof = timing["taps"]["profile"]
    log(f"  GAN step on {card}: taps {timing['taps']['gan_step_ms']:.2f} ms "
        f"({timing['taps']['gan_fps']:.2f} frames/s) (median of 5 after 2, host clock with "
        f"synchronize; peak memory {timing['taps']['max_memory_allocated_gib']:.2f} GiB)")
    if "own_kernels_ms" in prof:
        log(f"  taps GAN step: {prof['device_ms']:.2f} ms on the device (busy "
            f"{100 * prof['device_busy_share']:.1f} %) in {prof['device_ops']} kernels and "
            "copies; by part, each run alone: "
            + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in parts.items()))
    tf32(before)
    cost = degradation_cost()
    log("  degradation pipeline on the host, one clip (median of 5): " + "; ".join(
        f"{shape}: " + ", ".join(f"{k} {v:.2f}" for k, v in row.items())
        for shape, row in cost.items()))
    log(json.dumps({"gan": {**timing, "card": card, "gates": gates, "parts_device_ms": parts,
                            "losses": [losses[0], losses[-1]], "degradation": cost,
                            "cudnn_tf32": True}}))
    del g, d, step, frozen, model, disc, perc, batch
    torch.cuda.empty_cache()
    laps("the degradation")
    for form, by_shape in gan_e2e(device, card).items():
        seen[form] += by_shape
    laps("train.gan.run")
    laps.log("phase 8")
    return seen


# phase 9: the flow paths, fp32 as the JAX flow models run (dtype=None)
FLOW_PAIR = (384, 512)  # create_flow_dataset's default --height / --width
OFC_CLIP = (4, 6, 256, 256, 3)  # the GAN leg's HR clips
# conf/train/spynet.yaml's levels and batch; 8 samples a split
SPYNET_K, SPYNET_BATCH, SPYNET_SAMPLES = 6, 8, 8
CLEANER = {"mid_channels": 64, "blocks": 20}
RAFT_ITERS, RAFT_LEVELS = 12, 4


def raft_launches(n_pairs: int, h: int, w: int, forwards: int = 1) -> dict:
    """The sampler's launches by shape of ``forwards`` RAFT-small forwards
    on ``n_pairs`` pairs of ``h x w`` frames: one lookup a level a GRU
    iteration, over the 1/8-scale pixels' 7x7 windows of one channel."""
    import collections

    h8, w8 = h // 8, w // 8
    return collections.Counter({(n_pairs * h8 * w8, h8 >> i, w8 >> i, 1, 49): RAFT_ITERS * forwards
                                for i in range(RAFT_LEVELS)})


def spynet_step_launches(k: int, batch: int, steps: int = 1) -> dict:
    """The sampler's launches by shape of ``steps`` steps at level ``k``:
    the frozen pyramid's warps at levels 1 .. k-1 and the level's own, one
    warp of the three-channel frame each (``max(k, 1)`` a step)."""
    import collections

    from vsrlab_tpu_torch.models.flow import GConf

    sizes = [GConf(i).image_size for i in range(1, k)] + [GConf(k).image_size]
    return collections.Counter({(batch, h, w, 3, h * w): steps for h, w in sizes})


def irr_launches(h: int, w: int, output_level: int = 4) -> dict:
    """IRR-PWC's warps by shape on one ``h x w`` pair: at every estimated
    level (0 .. ``output_level``) both images, from level 1 also both
    feature maps (of the pyramid's channels at that level), one sampler
    call each."""
    import collections

    from vsrlab_tpu_torch.models.flow.irr import NUM_CHS

    out = collections.Counter()
    for level in range(output_level + 1):
        hh, ww = h, w
        for _ in range(len(NUM_CHS) - 1 - level):  # the pyramid's stride-2 convs
            hh, ww = -(-hh // 2), -(-ww // 2)
        out[(1, hh, ww, 3, hh * ww)] += 2
        if level:
            out[(1, hh, ww, NUM_CHS[len(NUM_CHS) - 1 - level], hh * ww)] += 2
    return out


def gate_samples(label, want) -> None:
    """Raise unless the sampler kernel's launches by shape since its last
    reset equal ``want``."""
    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    gate_counts(label, {"bilinear_sample": bs.bilinear_sample.launches_by_shape},
                {"bilinear_sample": want})


def window_coords(n, h, w, kind, seed, device, radius=3):
    """RAFT's lookup coordinates ``(n, (2r+1)^2)`` over ``n`` one-channel
    images ``(h, w)``, one for each pixel of the 1/8-scale frame (``n =
    h*w*s^2`` at the pyramid level of scale ``1/s``): that pixel over ``s``
    plus an N(0, 3/s) flow, then the window offsets (``realistic``);
    ``far``: uniform over three image sizes on each side; ``nonfinite``:
    realistic with +-inf, NaN and +-1e30 among them. Returns the
    coordinates and the mask of samples that must give 0 (nonfinite), else
    None."""
    import torch

    g = torch.Generator().manual_seed(seed)
    side = 2 * radius + 1
    if kind == "far":
        ix = torch.rand((n, side * side), generator=g) * 7 * w - 3 * w
        iy = torch.rand((n, side * side), generator=g) * 7 * h - 3 * h
    else:
        s = max(1, round((n / (h * w)) ** 0.5))
        idx = torch.arange(n)
        cx = ((idx % (w * s)).float() + torch.randn(n, generator=g) * 3) / s
        cy = ((idx // (w * s)).float() + torch.randn(n, generator=g) * 3) / s
        d = torch.linspace(-radius, radius, side)
        ix = (cx[:, None, None] + d[:, None]).expand(n, side, side).reshape(n, -1).contiguous()
        iy = (cy[:, None, None] + d[None, :]).expand(n, side, side).reshape(n, -1).contiguous()
    bad = None
    if kind == "nonfinite":
        special = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e30, -1e30])
        ix.view(-1)[::7] = special.repeat(ix.numel() // 35 + 1)[: ix.view(-1)[::7].numel()]
        iy.view(-1)[3::11] = special.flip(0).repeat(iy.numel() // 55 + 1)[
            : iy.view(-1)[3::11].numel()]
        bad = ~(torch.isfinite(ix) & torch.isfinite(iy) & (ix.abs() < 1e29) & (iy.abs() < 1e29))
        bad = bad.to(device)
    return ix.to(device), iy.to(device), bad


def sample_grad_shapes() -> tuple:
    """Phase 9 (a)'s shapes ``(N, H, W, C, P)``: RAFT's level-0 lookup on a
    ``FLOW_PAIR`` pair, the alignment's 128x128 stage, and a three-channel
    warp (the SpyNet trainer's at level 2)."""
    h8, w8 = FLOW_PAIR[0] // 8, FLOW_PAIR[1] // 8
    return ((h8 * w8, h8, w8, 1, 49), (180, 128, 128, 10, 128 * 128),
            (SPYNET_BATCH, 96, 128, 3, 96 * 128))


def sample_grad_operands(shape, kind, seed, device):
    """Phase 9 (a)'s operands at ``shape`` ``(N, H, W, C, P)``: the image
    ~ N(0, 1), coordinates of ``kind`` (RAFT windows where ``P`` is 49,
    else :func:`sampler_coords`), the output gradient ~ N(0, 1)."""
    import torch

    n, h, w, c, p = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g).to(device)
    if p == 49:
        ix, iy, bad = window_coords(n, h, w, kind, seed, device)
    else:
        ix, iy, bad = sampler_coords(n, h, w, kind, seed, device)
    gout = torch.randn((n, p, c), generator=g).to(device)
    return x, ix, iy, gout, bad


def check_sample_grad(x, ix, iy, gout, zeros, label, bad=None, tol=TOL["fp32"]) -> float:
    """``BilinearSample`` (the kernel forward, ``sample_grads`` backward)
    against autograd through ``bilinear_sample_plain`` in fp64 (the exact
    gradient: an fp32 reference's own sums of the thousands of
    border-clamped samples on an edge pixel move with the atomics' order):
    the output, ``dx`` and both coordinate gradients within ``tol +
    tol*|plain|``, finite, one kernel launch; 0 where ``bad`` marks a sample
    that must give 0."""
    import torch

    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    runs = []
    for fn, dtype in ((bs.bilinear_sample, torch.float32),
                      (bs.bilinear_sample_plain, torch.float64)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in (x, ix, iy)]
        before = bs.bilinear_sample.launches
        out = fn(*leaves, zeros)
        out.backward(gout.to(dtype))
        if bs.bilinear_sample.launches - before != (fn is bs.bilinear_sample):
            raise AssertionError(f"{label}: {bs.bilinear_sample.launches - before} launches")
        runs.append([out.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for name, a, b in zip(("out", "dx", "dix", "diy"), *runs):
        d = (a.double() - b).abs()
        ok = ok and bool(torch.isfinite(a).all()) and bool((d <= tol + tol * b.abs()).all())
        err = max(err, float(d.max()))
    if bad is not None:  # the output and both coordinate gradients 0 there
        ok = ok and all(bool((t[bad] == 0).all()) for t in (runs[0][0], runs[0][2], runs[0][3]))
    log(f"  {label}: max |grad - autograd(plain)| over out, dx, dix, diy = {err:.3e} (tol {tol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: BilinearSample disagrees with autograd through plain")
    return err


def sampler_backward_bound(shape, window_bytes, itemsize=4) -> tuple[float, str]:
    """Least time (ms) of one ``sample_grads`` with every gradient, in an
    image type of ``itemsize`` bytes: the corner windows of the image read
    once (``window_bytes``), the output gradient and the fp32 coordinates
    read, ``dx`` (the whole image) and both coordinate gradients written;
    ~16 FLOP a sample and channel (four weighted scatters, four products
    against the corners)."""
    n, h, w, c, p = shape
    nbytes = (window_bytes + n * p * c * itemsize + n * p * 8 + n * h * w * c * itemsize
              + n * p * 8)
    t_ops, t_bytes = 16 * n * p * c / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sample_grad_phase(device) -> dict:
    """Phase 9 (a): the sampler's gradient at RAFT's level-0 lookup (384x512
    frames), the alignment's 128x128 stage and a three-channel warp, zeros
    and border mode, then the backward's device time beside its bound and
    ``F.grid_sample``'s forward and backward. Returns the per-shape rows."""
    import torch
    import torch.nn.functional as F

    from vsrlab_tpu_torch.ops import bilinear_sample as bs
    from vsrlab_tpu_torch.ops.warp import _pad_coords

    rows, err = [], 0.0
    for i, shape in enumerate(sample_grad_shapes()):
        n, h, w, c, p = shape
        for kind in ("realistic", "far", "nonfinite"):
            x, ix, iy, gout, bad = sample_grad_operands(shape, kind, i, device)
            label = f"BilinearSample {shape} {kind:9s}"
            err = max(err, check_sample_grad(x, ix, iy, gout, True, label + " zeros ", bad))
            if kind != "nonfinite":  # border: the coordinates clamped first, no mask
                bx, by = _pad_coords(ix, iy, h, w, "border", True)
                err = max(err, check_sample_grad(x, bx, by, gout, False, label + " border"))
        x, ix, iy, gout, _ = sample_grad_operands(shape, "realistic", i, device)
        xc = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
        grid = torch.stack([2 * ix / (w - 1) - 1, 2 * iy / (h - 1) - 1], -1)[:, None]
        gc = gout.permute(0, 2, 1)[:, :, None].contiguous()

        def library():  # F.grid_sample forward and backward to the image
            return torch.autograd.grad(F.grid_sample(xc, grid, "bilinear", "zeros",
                                                     align_corners=True), xc, gc)

        window = sampler_window_bytes(x, ix, iy)
        b_ms, b_by = sampler_backward_bound(shape, window)
        f_ms, f_by = sampler_bound("bilinear_sample", shape, 4, window)
        row = {"shape": list(shape), "ms": graph_ms(lambda: bs.bilinear_sample(x, ix, iy, True)),
               "bound_ms": f_ms, "bound_by": f_by,
               "backward_ms": graph_ms(lambda: bs.sample_grads(x, ix, iy, True, gout), calls=5),
               "backward_image_only_ms": graph_ms(
                   lambda: bs.sample_grads(x, ix, iy, True, gout, need_coords=False), calls=5),
               "backward_bound_ms": b_ms, "backward_bound_by": b_by,
               "library_fwd_bwd_ms": graph_ms(library, calls=5)}
        log(f"  sampler fp32 {shape}: forward kernel {row['ms']:.4f} ms (bound {f_ms:.4f} by "
            f"{f_by}); backward (sample_grads) {row['backward_ms']:.4f} ms, image only "
            f"{row['backward_image_only_ms']:.4f} ms (bound {b_ms:.4f} by {b_by}); F.grid_sample "
            f"forward + backward {row['library_fwd_bwd_ms']:.4f} ms (graph replay)")
        rows.append(row)
        del x, ix, iy, gout, xc, grid, gc
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "shapes": rows}


def write_flow_frames(root, h, w, n=3, seed=0):
    """``n`` frames of one video under ``root/clip``: blurred uniform noise
    (OpenCV) moved (2, 1) px a frame, as 8-bit PNGs."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.random((h + 16, w + 16, 3)).astype(np.float32), (0, 0), 2.0)
    os.makedirs(os.path.join(root, "clip"), exist_ok=True)
    for t in range(n):
        frame = big[8 - t:8 - t + h, 8 - 2 * t:8 - 2 * t + w]
        cv2.imwrite(os.path.join(root, "clip", f"{t:04d}.png"),
                    np.clip(frame * 255.0 + 0.5, 0, 255).astype(np.uint8))
    return root


def median_ms(fn, n: int = 10, warmup: int = 3) -> float:
    """Median host ms of ``fn()`` ending in a device sync, after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return median_s(fn, n) * 1e3


def teacher_phase(device, card, root) -> dict:
    """Phase 9 (b): ``create_flow_dataset.main`` over 3 frames at its
    default 384x512 with a surrogate checkpoint, then one pair's flow with
    the kernel against the plain route, its time and profile."""
    import cv2
    import numpy as np
    import torch

    from vsrlab_tpu_torch.data import create_flow_dataset as cfd
    from vsrlab_tpu_torch.data.datasets import load_frame
    from vsrlab_tpu_torch.models.flow import RAFT
    from vsrlab_tpu_torch.nn.blocks import init_weights
    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    h, w = FLOW_PAIR
    frames = write_flow_frames(os.path.join(root, "frames"), h, w)
    ckpt = os.path.join(root, "raft-small.pth")
    raft = init_weights(RAFT(small=True, scale_factor=8), torch.Generator().manual_seed(11))
    torch.save({f"module.{k}": v for k, v in raft.state_dict().items()}, ckpt)
    out = os.path.join(root, "flows")
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    cfd.main(["--frames", frames, "--out", out, "--height", str(h), "--width", str(w),
              "--raft-ckpt", ckpt, "--device", device.type])
    cli_s = time.perf_counter() - t0
    gate_samples("create_flow_dataset (2 pairs)", raft_launches(1, h, w, forwards=2))
    files = sorted(os.listdir(out))
    saved = np.load(os.path.join(out, files[0]))["flow"]
    if len(files) != 2 or saved.shape != (h, w, 2) or not np.isfinite(saved).all():
        raise AssertionError(f"teacher flows: {files}, {saved.shape}")

    fwd = cfd.build_teacher(ckpt, device)
    pair = [cv2.resize(load_frame(os.path.join(frames, "clip", f)), (w, h))
            for f in sorted(os.listdir(os.path.join(frames, "clip")))[:2]]
    a, b = (torch.from_numpy(f[None]).to(device) for f in pair)
    flow_k = fwd(a, b)
    fwd.model.sampler_impl = "plain"
    flow_p = fwd(a, b)
    ms_plain = median_ms(lambda: fwd(a, b), n=5, warmup=1)
    fwd.model.sampler_impl = "fused"
    d_plain = float((flow_k - flow_p).abs().max())
    d_file = float((flow_k[0].cpu() - torch.from_numpy(saved)).abs().max())
    inner = flow_k[0, h // 8:-(h // 8), w // 8:-(w // 8)]
    median_flow = [float(v) for v in inner.reshape(-1, 2).median(0).values]
    log(f"  teacher: max |kernel - plain| = {d_plain:.3e} px, against the CLI's file "
        f"{d_file:.3e} px (gate 1e-3); median flow {median_flow} px (frames moved (2, 1) px; "
        "random weights)")
    if not (d_plain <= 1e-3 and d_file <= 1e-3 and bool(torch.isfinite(flow_k).all())):
        raise AssertionError("teacher flows with the kernel differ from the plain route's")
    ms = median_ms(lambda: fwd(a, b))
    prof = profile_request(lambda: fwd(a, b), ms / 1e3, top=8, ours=("bilinear_sample",))
    row = {"ms_per_pair": ms, "plain_ms_per_pair": ms_plain, "cli_s_2_pairs": cli_s,
           "max_abs_diff_plain_px": d_plain, "max_abs_diff_file_px": d_file, "profile": prof}
    if "wall_ms" in prof:
        row["lookup_share_of_device"] = prof["own_kernels_ms"] / prof["device_ms"]
        log(f"  teacher: {ms:.2f} ms a pair (plain route {ms_plain:.2f}), device "
            f"{prof['device_ms']:.2f} ms (busy {100 * prof['device_busy_share']:.1f} %), the 48 "
            f"lookups {prof['own_kernels_ms']:.3f} ms ({100 * row['lookup_share_of_device']:.1f} "
            f"%), {prof['device_ops']} kernels and copies, on {card}")
    del fwd, a, b, flow_k, flow_p
    return row


def consistency_phase(device, card) -> dict:
    """Phase 9 (c): ``OpticalFlowConsistency`` on SR and HR clips of
    ``OFC_CLIP``: 48 lookups a branch (the SR branch's through
    ``BilinearSample``), the loss and its gradient to SR against the plain
    route, its time and peak memory."""
    import torch

    from vsrlab_tpu_torch.core.losses import OpticalFlowConsistency
    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    b, t, h, w, _ = OFC_CLIP
    loss = OpticalFlowConsistency()
    g = torch.Generator().manual_seed(21)
    hr = torch.rand(OFC_CLIP, generator=g)
    sr = (hr + 0.05 * torch.randn(OFC_CLIP, generator=g)).clamp(0, 1)
    hr, sr = hr.to(device), sr.to(device)
    calls = []
    apply = bs.BilinearSample.apply
    bs.BilinearSample.apply = lambda *a: calls.append(a[0].shape) or apply(*a)
    try:  # count the lookups that run through the Function (under grad)
        bs.reset_launch_counts()
        leaf = sr.clone().requires_grad_(True)
        value = loss(leaf, hr)
        value.backward()
        value = value.detach()
        torch.cuda.synchronize()
    finally:
        del bs.BilinearSample.apply  # the inherited classmethod again
    gate_samples("OpticalFlowConsistency", raft_launches(b * (t - 1), h, w, forwards=2))
    if len(calls) != RAFT_ITERS * RAFT_LEVELS:
        raise AssertionError(f"{len(calls)} lookups under grad, not {RAFT_ITERS * RAFT_LEVELS}")
    if any(p.grad is not None for p in loss.model.parameters()):
        raise AssertionError("the frozen RAFT got a gradient")
    loss.model.sampler_impl = "plain"
    leaf_p = sr.clone().requires_grad_(True)
    value_p = loss(leaf_p, hr)
    value_p.backward()
    value_p = value_p.detach()
    loss.model.sampler_impl = "fused"
    gk, gp = leaf.grad, leaf_p.grad
    d_val = abs(float(value) - float(value_p))
    d_grad = float((gk - gp).abs().max())
    scale = float(gp.abs().max())
    ok = (d_val <= 1e-4 * abs(float(value_p)) and d_grad <= 1e-4 * scale
          and bool(torch.isfinite(gk).all()) and scale > 0)
    log(f"  OpticalFlowConsistency {OFC_CLIP}: loss {float(value):.6f} (plain {float(value_p):.6f}),"
        f" max |dSR - dSR(plain)| = {d_grad:.3e} of max {scale:.3e} (gate 1e-4 of it); "
        f"{len(calls)} lookups through BilinearSample {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("OpticalFlowConsistency with the kernel differs from the plain route")

    def step():
        x = sr.clone().requires_grad_(True)
        loss(x, hr).backward()

    ms = median_ms(step, n=5, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_request(step, ms / 1e3, top=8, ours=("bilinear_sample",))
    row = {"ms_fwd_bwd": ms, "peak_gib": peak, "loss": float(value), "max_abs_grad_diff": d_grad,
           "grad_max": scale, "profile": prof}
    log(f"  OpticalFlowConsistency forward + backward {ms:.2f} ms, peak {peak:.2f} GiB"
        + (f", device {prof['device_ms']:.2f} ms (busy {100 * prof['device_busy_share']:.1f} %),"
           f" the sampler's kernels {prof['own_kernels_ms']:.3f} ms" if "wall_ms" in prof else "")
        + f" on {card}")
    del loss, leaf, leaf_p, gk, gp, hr, sr
    torch.cuda.empty_cache()
    return row


def spynet_overrides(root, *more):
    return ["+experiment=spynet", "device=cuda", f"train.k={SPYNET_K}", "train.max_epochs=1",
            f"train.data.batch_size={SPYNET_BATCH}", "train.data.num_workers=8",
            "train.data.datasets.train={_target_: SyntheticFlowDataset, num_samples: "
            f"{SPYNET_SAMPLES}}}", f"train.checkpoint_dir={root}/spynet",
            f"core.storage_dir={root}", f"train.logger.save_dir={root}/logs", *more]


def spynet_phase(device, card, root) -> dict:
    """Phase 9 (d): ``train.spynet.run`` over the full curriculum, its
    checkpoints and a resume from ``start_k = 5``, the sampler's launch
    plan, one level-5 step's gradients with the kernel against the plain
    route, the step's time with the loader's apart, and a level-1 run with
    a cleaner."""
    import collections
    import shutil

    import torch

    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.data.loader import to_device
    from vsrlab_tpu_torch.models.spynet import SpyNetBasicModule
    from vsrlab_tpu_torch.nn.blocks import IterativeRefinement, init_weights
    from vsrlab_tpu_torch.ops import bilinear_sample as bs
    from vsrlab_tpu_torch.ops import residual_pair as rp
    from vsrlab_tpu_torch.train import spynet
    from vsrlab_tpu_torch.train.builders import build_tx

    cfg = load_config(overrides=spynet_overrides(root))
    k_max = int(cfg.train.k)
    # one train and one val batch a level: 8 samples a split, batch 8
    want = collections.Counter()
    for k in range(k_max):
        want += spynet_step_launches(k, SPYNET_BATCH, steps=2)
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    trained = spynet.run(cfg, device=device)
    run_s = time.perf_counter() - t0
    gate_samples(f"train.spynet.run, levels 0-{k_max - 1}", want)
    for k in range(k_max):
        key, payload = CheckpointManager(f"{root}/spynet/level_{k}").restore()
        if key != 0 or not all(torch.equal(v, trained[f"unit_{k}"][n])
                               for n, v in payload["params"].items()):
            raise AssertionError(f"level {k}'s checkpoint differs from its trained head")
    final = CheckpointManager(f"{root}/spynet/final").restore()[1]["params"]
    if sorted(final) != [f"unit_{k}" for k in range(k_max)]:
        raise AssertionError(f"final pyramid holds {sorted(final)}")
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    k = k_max - 1
    resumed = spynet.run(load_config(overrides=spynet_overrides(root, f"train.start_k={k}")),
                         device=device)
    resume_s = time.perf_counter() - t0
    gate_samples(f"resume at level {k}", spynet_step_launches(k, SPYNET_BATCH, steps=2))
    for i in range(k):
        if not all(torch.equal(v, trained[f"unit_{i}"][n]) for n, v in resumed[f"unit_{i}"].items()):
            raise AssertionError(f"the resumed run's level {i} differs from the saved one")
    log(f"  train.spynet.run: {k_max} levels in {run_s:.1f} s, checkpoints level_0 .. level_{k} "
        f"and final written; start_k={k} restored levels 0-{k - 1} equal to those saved "
        f"({resume_s:.1f} s)")

    train_ds, _ = spynet.load_level_data(cfg, k, k_max - 1)
    t0 = time.perf_counter()
    train_ds[0]
    sample_s = time.perf_counter() - t0
    # the loader's host time a batch, apart from the step; its batch, pre-collated
    # on the card, is the timed steps' input
    loader = spynet.FlowLoader(train_ds, batch_size=SPYNET_BATCH, num_workers=8,
                               device_put=to_device(device))
    t0 = time.perf_counter()
    (batch,) = list(loader)
    torch.cuda.synchronize()
    loader_ms = (time.perf_counter() - t0) * 1e3
    log(f"  loader at level {k} (codec emulator at CRF 34, 8 threads): {loader_ms:.1f} ms a batch of "
        f"{SPYNET_BATCH} ({1e3 * sample_s:.1f} ms a sample on one thread), on {card}'s host")
    unit = SpyNetBasicModule()
    unit.load_state_dict(trained[f"unit_{k}"])
    unit.to(device).train()
    pyramid = spynet.frozen_pyramid(cfg, k, trained, device)
    grads = {}
    for impl in ("fused", "plain"):
        pyramid.sampler_impl = impl
        unit.zero_grad(set_to_none=True)
        loss, _ = spynet.level_forward(unit, pyramid, None, k, batch)
        loss.backward()
        grads[impl] = {n: p.grad.detach().clone() for n, p in unit.named_parameters()}
    pyramid.sampler_impl = "fused"
    worst = 0.0
    for n, gk in grads["fused"].items():
        gp = grads["plain"][n]
        rel = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        worst = max(worst, rel)
        if not (rel <= 1e-4 and bool(torch.isfinite(gk).all()) and float(gp.abs().max()) > 0):
            raise AssertionError(f"level-{k} gradient of {n}: {rel:.3e} of its max")
    log(f"  level-{k} step gradients, kernel against plain route: worst {worst:.3e} of a tensor's "
        "max (gate 1e-4)")

    tx = build_tx(unit.parameters(), cfg.train.optimizer, cfg.train.get("scheduler"),
                  cfg.train.get("gradient_clip_val"))
    step = spynet.make_level_step(unit, pyramid, None, k, tx, train=True)
    bs.reset_launch_counts()
    step(batch)
    gate_samples(f"one level-{k} step", spynet_step_launches(k, SPYNET_BATCH))
    timing = {}
    for on in (False, True):
        before = tf32(on)
        ms = median_ms(lambda: step(batch))
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_request(lambda: step(batch), ms / 1e3, top=6, ours=("bilinear_sample",))
        tf32(before)
        timing["tf32" if on else "fp32"] = {"step_ms": ms, "pairs_per_s": SPYNET_BATCH / ms * 1e3,
                                            "peak_gib": peak, "profile": prof}
        log(f"  level-{k} step ({'TF32 on' if on else 'TF32 off'}): {ms:.2f} ms, "
            f"{SPYNET_BATCH / ms * 1e3:.2f} pairs/s, peak {peak:.2f} GiB"
            + (f", device {prof['device_ms']:.2f} ms (busy {100 * prof['device_busy_share']:.1f} "
               f"%), the sampler {prof['own_kernels_ms']:.3f} ms" if "wall_ms" in prof else ""))

    cleaner = init_weights(IterativeRefinement(**CLEANER), torch.Generator().manual_seed(31))
    CheckpointManager(f"{root}/cleaner").save(0, cleaner.state_dict())
    shutil.copytree(f"{root}/spynet/level_0", f"{root}/spynet_clean/level_0")
    ccfg = load_config(overrides=spynet_overrides(
        root, "train.k=2", "train.start_k=1", f"train.checkpoint_dir={root}/spynet_clean",
        f"train.cleaner_ckpt={root}/cleaner",
        f"train.cleaner={{mid_channels: {CLEANER['mid_channels']}, blocks: {CLEANER['blocks']}}}"))
    rp.reset_launch_counts()
    bs.reset_launch_counts()
    spynet.run(ccfg, device=device)
    h1, w1 = spynet.GConf(1).image_size
    # a cleaner call a step: 3 refinement steps x 20 units on both frames
    per_call = 3 * CLEANER["blocks"]
    gate_counts("level 1 with a cleaner (1 train + 1 val step)", pair_counts(),
                {"taps": collections.Counter({(2 * SPYNET_BATCH, h1, w1, CLEANER["mid_channels"]):
                                               2 * per_call})})
    gate_samples("level 1 with a cleaner", spynet_step_launches(1, SPYNET_BATCH, steps=2))
    seen = pair_counts()
    return {"run_s": run_s, "resume_s": resume_s, "grad_worst_rel": worst, "step": timing,
            "loader_ms_per_batch": loader_ms, "sample_ms_one_thread": 1e3 * sample_s,
            "cleaner_pairs": seen, "samplers": want + spynet_step_launches(k, SPYNET_BATCH, 2)
            + spynet_step_launches(1, SPYNET_BATCH, 2)}


def irr_phase(device, card, root) -> dict:
    """Phase 9 (e): ``IRRPWCNet`` (seeded) on one 384x512 pair: its warps
    by shape and its flows with the kernel against the plain route."""
    import cv2
    import torch

    from vsrlab_tpu_torch.data.datasets import load_frame
    from vsrlab_tpu_torch.models.flow import IRRPWCNet
    from vsrlab_tpu_torch.nn.blocks import init_weights
    from vsrlab_tpu_torch.ops import bilinear_sample as bs

    h, w = FLOW_PAIR
    clip = os.path.join(root, "frames", "clip")
    a, b = (torch.from_numpy(cv2.resize(load_frame(os.path.join(clip, f)), (w, h))[None]).to(device)
            for f in sorted(os.listdir(clip))[:2])
    model = init_weights(IRRPWCNet(), torch.Generator().manual_seed(13)).to(device).eval()
    bs.reset_launch_counts()
    with torch.no_grad():
        flows_k = model(a, b)
        gate_samples("IRR-PWC forward", irr_launches(h, w, model.output_level))
        model.sampler_impl = "plain"
        flows_p = model(a, b)
        model.sampler_impl = "fused"
        ms = median_ms(lambda: model(a, b), n=5, warmup=2)
    d = max(float((fk - fp).abs().max()) for fk, fp in zip(flows_k[0] + flows_k[1],
                                                          flows_p[0] + flows_p[1]))
    finite = all(bool(torch.isfinite(f).all()) for f in flows_k[0] + flows_k[1])
    log(f"  IRR-PWC {h}x{w}: {sum(irr_launches(h, w).values())} warps, max |kernel - plain| = "
        f"{d:.3e} px over both directions' 4 levels (gate 1e-3), {ms:.2f} ms a pair on {card}")
    if not (d <= 1e-3 and finite):
        raise AssertionError("IRR-PWC flows with the kernel differ from the plain route's")
    return {"max_abs_diff_plain_px": d, "ms_per_pair": ms, "samplers": irr_launches(h, w)}


def flow_phase(device, card):
    """Phase 9. Returns the sampler's launches by shape over the phase's
    main path (teacher, consistency loss, curriculum, IRR-PWC; fp32) and the
    residual pair's (the cleaner's, fp32), with the phase's record."""
    import collections
    import shutil

    import torch

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_flow")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.backends.cudnn.allow_tf32 = False
    record = {"card": card}
    log("  (a) the sampler's gradient (BilinearSample) against autograd through the plain version")
    record["sample_grads"] = sample_grad_phase(device)
    samplers = collections.Counter()
    h, w = FLOW_PAIR
    log(f"  (b) the RAFT teacher: create_flow_dataset at {h}x{w}, a surrogate raft-small")
    record["teacher"] = teacher_phase(device, card, root)
    samplers += raft_launches(1, h, w, forwards=2)
    log(f"  (c) OpticalFlowConsistency on SR / HR clips {OFC_CLIP}")
    record["consistency"] = consistency_phase(device, card)
    b, t, ch, cw, _ = OFC_CLIP
    samplers += raft_launches(b * (t - 1), ch, cw, forwards=2)
    log(f"  (d) train.spynet.run: the full curriculum (k = {SPYNET_K}, batch {SPYNET_BATCH}, one "
        "epoch a level)")
    spy = spynet_phase(device, card, root)
    samplers += spy.pop("samplers")
    pairs = spy.pop("cleaner_pairs")
    record["spynet"] = spy
    log(f"  (e) IRR-PWC on one {h}x{w} pair")
    irr = irr_phase(device, card, root)
    samplers += irr.pop("samplers")
    record["irr"] = irr
    log(json.dumps({"flow": record}, default=str))
    return samplers, pairs


def pair_counts() -> dict:
    """Each residual-pair kernel's launches by input shape so far."""
    from vsrlab_tpu_torch.ops.residual_pair import PAIR_IMPLS

    return {form: PAIR_IMPLS[form].launches_by_shape.copy() for form in KERNELS}


def gate_counts(label, got, want) -> None:
    """Raise unless the launches by shape ``got`` equal ``want`` (a dict of
    Counters by kernel; a kernel left out must not have launched)."""
    got = {k: {s: n for s, n in v.items() if n} for k, v in got.items()}
    want = {k: dict(want.get(k, {})) for k in got}
    log(f"  {label}: launches by shape {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")


def window_launches(batch: int, h: int, w: int, windows: int = 1, blocks=None,
                    frames: int = 10) -> dict:
    """One RealBasicVSR forward's pair launches by shape for ``batch`` clips
    of ``frames`` frames of ``h x w``: the recurrences at ``batch`` (each
    direction's residual blocks a frame), the cleaner at ``frames * batch``
    frames (its blocks each step); ``blocks`` overrides ``HEADLINE``'s
    depths."""
    import collections

    depth = {**HEADLINE, **(blocks or {})}
    return collections.Counter({
        (batch, h, w, 64): 2 * frames * depth["res_blocks"] * windows,
        (frames * batch, h, w, 64): depth["cleaning_blocks"] * depth["cleaning_steps"] * windows})


def write_serving_runs(model, root):
    """Run directories of the headline model's weights, written by
    ``convert.write_run_dir`` from numpy trees in the JAX package's layout:
    ``ema`` (an EMA sidecar that differs from the raw weights, at the main
    key) and ``stale`` (main key 1, sidecar at key 0). Returns the raw and
    EMA state_dicts (CPU) and the two directories."""
    import torch

    from vsrlab_tpu_torch import convert

    raw = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(3)
    ema = {k: v + 1e-3 * torch.randn(v.shape, generator=g) for k, v in raw.items()}
    cfg = {"train": {"model": {"_target_": "RealBasicVSR", **HEADLINE}, "precision": "bf16"}}
    raw_tree, ema_tree = convert.realbasicvsr_params(raw), convert.realbasicvsr_params(ema)
    dirs = {name: os.path.join(root, f"run_{name}") for name in ("ema", "stale")}
    convert.write_run_dir(dirs["ema"], raw_tree, cfg, ema_params=ema_tree)
    convert.write_run_dir(dirs["stale"], raw_tree, cfg, ema_params=ema_tree, key=0)
    convert.write_run_dir(dirs["stale"], raw_tree, cfg, key=1)
    return raw, ema, dirs


def same_weights(model, state) -> bool:
    import torch

    return all(torch.equal(v.cpu(), state[k]) for k, v in model.state_dict().items())


def median_s(fn, n: int = 5) -> float:
    """Median host seconds of ``fn()`` ending in a device sync."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def serving_phase(device, card):
    """Phase 7. Returns the residual-pair kernels' and the sampler kernels'
    launches by shape over the phase's main path, (a) to (g)."""
    import collections
    import contextlib
    import io
    import shutil

    import torch

    from vsrlab_tpu_torch import convert
    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
    from vsrlab_tpu_torch.data import SyntheticVSR
    from vsrlab_tpu_torch.evaluation import export, upscale
    from vsrlab_tpu_torch.evaluation.harness import (
        evaluate_video, load_test_model, make_forward, make_stream_forward)
    from vsrlab_tpu_torch.evaluation.params_bench import param_count, speed_bench
    from vsrlab_tpu_torch.evaluation.tiled import _tile_starts, tiled_forward
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.ops import residual_pair as rp
    from vsrlab_tpu_torch.ops.resize import bicubic_down
    from vsrlab_tpu_torch.utils import profiler

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_serve")
    shutil.rmtree(root, ignore_errors=True)
    pair_seen, sampler_seen = {f: collections.Counter() for f in KERNELS}, collections.Counter()

    def add_pairs(counts):
        for form in KERNELS:
            pair_seen[form] += counts[form]

    raw, ema, dirs = write_serving_runs(build_model(torch.bfloat16), root)
    h, w = SERVE_LR
    clip10 = torch.rand((1, 10, h, w, 3), generator=torch.Generator().manual_seed(4))

    laps = Laps()
    log("  (a) load_test_model from run directories written by convert.write_run_dir")
    model, cfg = load_test_model(dirs["ema"], device=device)
    if not same_weights(model, ema):
        raise AssertionError("load_test_model did not serve the EMA sidecar")
    ref = build_model(torch.bfloat16)
    ref.load_state_dict(ema)
    rp.reset_launch_counts()
    served = make_forward(model, device=device)(clip10)
    want = make_forward(ref, device=device)(clip10)
    counts = pair_counts()
    gate_counts("two requests", counts, {"taps": window_launches(1, h, w, 2)})
    add_pairs(counts)
    if not torch.equal(served, want):
        raise AssertionError("EMA-served output differs from a module loaded with the EMA weights")
    log(f"  EMA served: weights equal the sidecar's, output {tuple(served.shape)} bitwise equal "
        "to make_forward on a module loaded with the EMA state_dict")
    del ref, want
    raw_model, _ = load_test_model(dirs["ema"], use_ema=False, device=device)
    if not same_weights(raw_model, raw):
        raise AssertionError("use_ema=False did not serve the raw weights")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stale_model, _ = load_test_model(dirs["stale"], device=device)
    if not same_weights(stale_model, raw) or "WARNING" not in out.getvalue():
        raise AssertionError("stale sidecar: raw weights not served or no warning: "
                             f"{out.getvalue()}")
    log(f"  use_ema=False: raw weights; stale sidecar: raw weights, with: {out.getvalue().strip()}")
    del raw_model, stale_model

    laps("(a)")
    log(f"  (b) evaluate_video: a 20-frame {h}x{w} LR clip (bicubic_down of a seeded "
        f"{4 * h}x{4 * w} SyntheticVSR clip), two windows of 10 as one batch")
    hr = SyntheticVSR(num_videos=1, seq=20, height=4 * h, width=4 * w, scale=4, seed=5)[0][1][None]
    lr = bicubic_down(hr, 4)
    forward = make_forward(model, device=device)
    rp.reset_launch_counts()
    t0 = time.perf_counter()
    sr, vals = evaluate_video(forward, lr, hr, 10, ("PSNR", "SSIM"))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = pair_counts()
    gate_counts("evaluate_video", counts, {"taps": window_launches(2, h, w)})
    add_pairs(counts)
    set_pair_impl(model, "plain")
    _, plain_vals = evaluate_video(forward, lr, hr, 10, ("PSNR", "SSIM"))
    set_pair_impl(model, "taps")
    d_psnr, d_ssim = (abs(vals[k] - plain_vals[k]) for k in ("PSNR", "SSIM"))
    log(f"  PSNR {vals['PSNR']:.4f} dB, SSIM {vals['SSIM']:.5f} (plain pair: "
        f"{plain_vals['PSNR']:.4f}, {plain_vals['SSIM']:.5f}; gates 0.05 dB, 1e-3) in "
        f"{eval_s:.2f} s, sr {tuple(sr.shape)}")
    if not (all(map(math.isfinite, vals.values())) and d_psnr <= 0.05 and d_ssim <= 1e-3):
        raise AssertionError(f"evaluate_video: {vals} against plain {plain_vals}")
    del sr, hr, lr

    tile = SERVE_TILE
    laps("(b)")
    log(f"  (c) make_forward(tile={tile}, tile_overlap=16) on a 10-frame {h}x{w} clip")
    rp.reset_launch_counts()
    tiled = make_forward(model, tile=tile, tile_overlap=16, device=device)(clip10)
    counts = pair_counts()
    direct = tiled_forward(make_forward(model, device=device), clip10.to(device), (tile, tile), 16)
    n_tiles = len(_tile_starts(h, tile, tile - 16)) * len(_tile_starts(w, tile, tile - 16))
    want = {"taps": window_launches(1, tile, tile, n_tiles)}
    gate_counts(f"tiled forward ({n_tiles} tiles)", counts, want)
    add_pairs(counts)
    if not torch.equal(tiled, direct):
        raise AssertionError("tiled make_forward differs from tiled_forward called directly")
    log(f"  tiled: {tuple(tiled.shape)} bitwise equal to tiled_forward called directly")
    del tiled, direct

    laps("(c)")
    log(f"  (d) the upscale loop with stream=True: three windows of 10 frames of {h}x{w} from "
        "memory, im2col pairs")
    frames = torch.rand((30, h, w, 3), generator=torch.Generator().manual_seed(6)).numpy()
    set_pair_impl(model, "im2col")
    stream = make_stream_forward(model, device=device)
    sink = upscale.ArraySink()
    rp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upscale.upscale_frames(upscale.array_source(frames), sink, 10, stream=stream)
    stream_s = time.perf_counter() - t0
    counts = pair_counts()
    gate_counts("stream", counts, {"im2col": window_launches(1, h, w, 3)})
    add_pairs(counts)
    first, rest = make_stream_forward(model, device=device)
    chain, state = first(frames[None, :10])
    chain = [chain]
    for s in (10, 20):
        out, state = rest(frames[None, s:s + 10], state)
        chain.append(out)
    chain = torch.cat(chain, 1)[0].float().clamp(0, 1).cpu().numpy()
    if not (sink.frames() == chain).all():
        raise AssertionError("the streamed upscale differs from a first / rest chain")
    log(f"  stream: {sink.frames().shape} bitwise equal to first / rest called directly; "
        f"{30 / stream_s:.2f} frames/s through the loop (host clock, copies back included)")
    del sink, chain, state
    prof_stream = profile_request(
        lambda: upscale.upscale_frames(upscale.array_source(frames), upscale.ArraySink(), 10,
                                       stream=stream), stream_s, top=8, ours=("pair_im2col",))
    set_pair_impl(model, "taps")

    laps("(d)")
    log(f"  (e) export_model at (1, {EXPORT_FRAMES}, {h}, {w}, 3) of the headline at "
        f"{EXPORT_DEPTH} (the width kept), then load_exported")
    clip = clip10[:, :EXPORT_FRAMES]
    small = build_model(torch.bfloat16, **EXPORT_DEPTH)
    dirs["export"] = os.path.join(root, "run_export")
    convert.write_run_dir(dirs["export"], convert.realbasicvsr_params(small.state_dict()), {
        "train": {"model": {"_target_": "RealBasicVSR", **HEADLINE, **EXPORT_DEPTH},
                  "precision": "bf16"}})
    small_eager = make_forward(load_test_model(dirs["export"], device=device)[0], device=device)
    want = small_eager(clip)
    art = os.path.join(root, "headline.pt2")
    t0 = time.perf_counter()
    nbytes = export.export_model(dirs["export"], art, EXPORT_FRAMES, h, w, device=device)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exported = export.load_exported(art)
    load_s = time.perf_counter() - t0
    rp.reset_launch_counts()
    got = exported(clip)
    counts = pair_counts()
    gate_counts("exported forward", counts,
                {"taps": window_launches(1, h, w, blocks=EXPORT_DEPTH, frames=EXPORT_FRAMES)})
    add_pairs(counts)
    if not torch.equal(got, want):
        raise AssertionError("the exported forward differs from make_forward's output")
    fps = {"exported": EXPORT_FRAMES / median_s(lambda: exported(clip)),
           "make_forward": EXPORT_FRAMES / median_s(lambda: small_eager(clip))}
    log(f"  exported in {export_s:.1f} s, loaded in {load_s:.1f} s, {nbytes / 1e6:.1f} MB; "
        "bitwise equal to make_forward; frames/s on "
        f"{card}: exported {fps['exported']:.2f}, make_forward {fps['make_forward']:.2f} "
        "(median of 5, host clock, input upload included)")
    log(json.dumps({"export": {"seconds": export_s, "load_seconds": load_s, "bytes": nbytes,
                               "depth": EXPORT_DEPTH, "frames": EXPORT_FRAMES, "fps": fps,
                               "stream_fps": 30 / stream_s, "card": card}}))
    eager = make_forward(model, device=device)
    profiles = {"stream_loop_30_frames": prof_stream,
                "exported": profile_request(lambda: exported(clip), EXPORT_FRAMES / fps["exported"],
                                            top=8),
                "make_forward": profile_request(lambda: small_eager(clip),
                                                EXPORT_FRAMES / fps["make_forward"], top=8)}
    for name, prof in profiles.items():
        if "wall_ms" in prof:
            log(f"  {name}: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
                f"(busy {100 * prof['device_busy_share']:.1f} %), the pair kernels "
                f"{prof['own_kernels_ms']:.2f} ms, {prof['device_ops']} kernels and copies")
    log(json.dumps({"profile_serving": profiles, "card": card}))
    del exported, got, want, small, small_eager, clip

    laps("(e)")
    log("  (f) params bench of the headline model, and one request under utils.profiler.trace")
    stats = speed_bench(model, (1, 10, h, w, 3), n_iters=5, device=device)
    log(f"  {param_count(model)} parameters; speed_bench: {json.dumps(stats)} on {card}")
    trace_dir = os.path.join(root, "trace")
    with profiler.trace(trace_dir):
        with profiler.annotate("request"):
            eager(clip10)
        torch.cuda.synchronize()
    (trace_file,) = (os.path.join(trace_dir, f) for f in os.listdir(trace_dir))
    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    n_spans = sum(e.get("name") == "vsr::request" for e in events)
    if not n_kernels or not n_spans:
        raise AssertionError(f"trace: {n_kernels} kernel events, {n_spans} 'request' spans")
    log(f"  trace: {os.path.getsize(trace_file) / 1e6:.1f} MB Chrome trace, {n_kernels} kernel "
        f"events, the 'request' span present")
    del model, served
    torch.cuda.empty_cache()

    laps("(f)")
    log("  (g) paper-configuration VRT served tiled from a run directory")
    vrt_dir = os.path.join(root, "vrt")
    CheckpointManager(vrt_dir).save(0, build_vrt(torch.bfloat16).state_dict(), config={
        "train": {"model": {"_target_": "VRT"}, "precision": "bf16"}})
    vrt, _ = load_test_model(vrt_dir, device=device)
    vclip = torch.rand(VRT_CLIP, generator=torch.Generator().manual_seed(2))
    reset_vrt_counts()
    t0 = time.perf_counter()
    with attention_plan(vrt) as plan:
        vout = make_forward(vrt, tile=tile, tile_overlap=16, device=device)(vclip)
    torch.cuda.synchronize()
    vrt_s = time.perf_counter() - t0
    n_tiles = (len(_tile_starts(VRT_CLIP[2], tile, tile - 16))
               * len(_tile_starts(VRT_CLIP[3], tile, tile - 16)))
    per_tile = expected_vrt_launches((1, VRT_CLIP[1], tile, tile, 3), "bilinear_sample")
    counts = {name: fn.launches_by_shape.copy() for name, fn in vrt_wrappers().items()}
    gate_counts(f"VRT tiled ({n_tiles} tiles)", counts, {
        "bilinear_sample": collections.Counter({k: v * n_tiles for k, v in per_tile.items()}),
        "window_attention": plan})
    if sum(plan.values()) != VRT_ATTENTION_LAUNCHES * n_tiles:
        raise AssertionError(f"VRT tiled: {sum(plan.values())} window-attention launches, not "
                             f"{VRT_ATTENTION_LAUNCHES} a tile")
    sampler_seen += counts["bilinear_sample"]
    attention_seen = counts["window_attention"]
    want_shape = (1, VRT_CLIP[1], 4 * VRT_CLIP[2], 4 * VRT_CLIP[3], 3)
    if tuple(vout.shape) != want_shape or not bool(torch.isfinite(vout).all()):
        raise AssertionError(f"VRT tiled: shape {tuple(vout.shape)} or non-finite")
    log(f"  VRT tiled: {tuple(vout.shape)} finite, {sum(per_tile.values())} sampler launches a "
        f"tile, {VRT_CLIP[1] / vrt_s:.3f} frames/s once (first use included) on {card}")
    del vrt, vout
    torch.cuda.empty_cache()
    laps("(g)")
    laps.log("phase 7")
    return pair_seen, sampler_seen, attention_seen


# phase 10: VRT training at +experiment=vrt's shape (conf/experiment/vrt.yaml) and
# data parallelism on one card
# +experiment=vrt through the port's config: the paper VRT of conf/train/model/vrt.yaml
# (remat on), Adam 1e-4 (0.9, 0.99), the cosine schedule, clip 1.0, 4 microbatches
# the paper's 8 x 7 Stage blocks and 4 x 6 trunk blocks (80) cut to 3 and 2 (33) on the
# training and sharded paths, the widths, heads and offset groups kept: a Stage's
# residual_group1 keeps its shifted window-2 block, an RTMSA its shifted one
VRT_TRAIN_DEPTHS = (3,) * 7 + (2,) * 6
VRT_TRAIN_OVERRIDES = ("+experiment=vrt", "train.precision=bf16",
                       f"train.model.depths=[{','.join(map(str, VRT_TRAIN_DEPTHS))}]")
VRT_TRAIN_CLIP = (8, 6, 64, 64)  # the experiment's global batch of 8 clips of 6 frames, LR 64x64
VRT_TRAIN_STEPS, VRT_TRAIN_WARMUP = 1, 0  # timed after the two main-path steps, which warm it
DP_RANKS = 2
DP_STEPS = 2
DP_TOL = (1e-5, 1e-4)  # the all-reduced gradient against one process's: atol + rtol*|b|
DP_TIMEOUT = 600


def check_paper_config(tcfg) -> None:
    """Raise unless the experiment is the paper VRT (its blocks cut to
    ``VRT_TRAIN_DEPTHS``) at the batch this phase reckons with."""
    got = (tuple(tcfg.model.depths), tuple(tcfg.model.embed_dims),
           tuple(tcfg.model.num_heads), int(tcfg.model.deformable_groups),
           bool(tcfg.model.remat), int(tcfg.data.batch_size), int(tcfg.num_grad_acc))
    if got != (VRT_TRAIN_DEPTHS, (120,) * 7 + (180,) * 6, (6,) * 13, VRT_GROUPS, True,
               VRT_TRAIN_CLIP[0], 4):
        raise AssertionError(f"+experiment=vrt is not the paper configuration: {got}")


def build_train_vrt(cfg, dtype_name, device, **kw):
    """The configured VRT with seeded weights (the offset heads drawn), in
    ``dtype_name`` (``bf16`` or ``fp32``), on ``device``, in train mode;
    ``kw`` joins the model's config (``time_shard_axis``)."""
    import torch

    import vsrlab_tpu_torch.components  # noqa: F401  (fills the registry)
    from vsrlab_tpu_torch.nn.blocks import init_weights
    from vsrlab_tpu_torch.train import builders

    g = torch.Generator().manual_seed(0)
    model = builders.build_model({**cfg.train.model.to_dict(), **kw}, dtype_name)
    model = seed_offset_heads(init_weights(model, g), g)
    return model.to(device).train()


def vrt_train_batch(device):
    """``VRT_TRAIN_CLIP`` LR clips and their x4 HR, uniform in [0, 1) from a
    seeded numpy generator."""
    import numpy as np
    import torch

    b, t, h, w = VRT_TRAIN_CLIP
    rng = np.random.default_rng(10)
    lr = torch.from_numpy(rng.random((b, t, h, w, 3), dtype=np.float32)).to(device)
    hr = torch.from_numpy(rng.random((b, t, 4 * h, 4 * w, 3), dtype=np.float32)).to(device)
    return {"lr": lr, "hr": hr}


def vrt_grads(model, batch, impl, plans=None):
    """One microbatch's loss, SR output and gradient by parameter name
    (zeros where a parameter gets none), with the sampler route ``impl``;
    the VRT kernels' launches it made by kernel and shape. ``plans``, where
    given, receives the window-attention launches its calls imply
    (:func:`attention_plan`)."""
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl
    from vsrlab_tpu_torch.train.step import supervised_loss

    set_sampler_impl(model, impl)
    model.zero_grad(set_to_none=True)
    reset_vrt_counts()
    with attention_plan(model) as plan:
        out = model(batch["lr"])
        loss, _ = supervised_loss(out, batch)
        loss.backward()
    if plans is not None:
        plans.append(plan)
    launches = {k: fn.launches_by_shape.copy() for k, fn in vrt_wrappers().items()}
    grads = {n: (p.grad if p.grad is not None else p.new_zeros(p.shape)).detach().float().clone()
             for n, p in model.named_parameters()}
    set_sampler_impl(model, "fused")
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out[0].detach().float(), grads, launches


def remat_launches(clip, kernel, microbatches=1):
    """Sampler launches of ``microbatches`` forward and backward passes of a
    remat'd VRT over microbatches of ``clip``: every sampler call lies in a
    Stage, and each Stage's forward runs again in the backward."""
    import collections

    once = expected_vrt_launches(clip, kernel, groups=VRT_GROUPS, cg=VRT_CG, gp=VRT_GP)
    return collections.Counter({k: 2 * microbatches * v for k, v in once.items()})


def gate_attention_grads(kernel, plain, ref) -> dict:
    """Phase 10 (a)'s gate of the window attention in training: one
    microbatch with the fused sampler and the kernel (``kernel``, a
    :func:`vrt_grads` result) and with the plain version in the kernel's
    place (``plain``), each against the fp32 plain route ``ref`` (its SR
    output and gradients): the SR output within twice plain bf16's
    deviation in max and rms, every gradient finite with its rms within
    twice, and the median over the gradients of the max's ratio at most
    1.5. A gradient's largest element is not held to twice on its own: the
    kernel rounds P before it normalises it, the plain version after, and
    the plain version computed with the kernel's rounding point missed that
    rule on 4, 0 and 12 of 721 gradients over three seeds (max ratios up to
    4.0, rms up to 1.65); the kernel on 3, 0 and 4 (up to 3.05, rms up to
    1.66), never on the same gradients twice (PERF.md). Returns the
    ratios."""
    import torch

    ref_sr, ref = ref
    ratios = {"sr": within_twice("attention kernel SR vs fp32", kernel[1], ref_sr,
                                 dev(plain[1], ref_sr))}
    rows = []
    for name in ref:
        if name.startswith("optical_flow."):
            continue
        g = kernel[2][name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"attention kernel: {name} gradient not finite")
        (d_max, d_rms), (b_max, b_rms) = dev(g, ref[name]), dev(plain[2][name], ref[name])
        rows.append((d_max / b_max if b_max else 0.0, d_rms / b_rms if b_rms else 0.0, name))
    worst_rms = max(rows, key=lambda r: r[1])
    med_max = statistics.median(r[0] for r in rows)
    ratios.update(rms_max=worst_rms[1], rms_max_at=worst_rms[2], max_median=med_max,
                  max_max=max(r[0] for r in rows), over_twice_max=sum(r[0] > 2 for r in rows),
                  gradients=len(rows))
    log(f"  the window attention, one microbatch: kernel vs plain version, each against fp32: "
        f"SR {ratios['sr'][0]:.2f} / {ratios['sr'][1]:.2f} (max / rms); over {len(rows)} "
        f"gradients rms ratio at most {worst_rms[1]:.2f} ({worst_rms[2]}), max ratio median "
        f"{med_max:.2f}, largest {ratios['max_max']:.2f}, {ratios['over_twice_max']} over 2")
    if worst_rms[1] > 2 or med_max > 1.5:
        raise AssertionError(f"the attention kernel's gradients: rms ratio {worst_rms[1]:.2f} "
                             f"({worst_rms[2]}) over 2 or max ratio median {med_max:.2f} over 1.5")
    return ratios


def gate_vrt_grads(cfg, model, batch, device) -> dict:
    """Phase 10 (a)'s gradient gates on one microbatch: the SR output and
    every parameter's gradient with the ``fused`` and the ``take`` kernels
    (bf16) each within twice plain bf16's deviation from the fp32 plain
    route (the plain sampler and the plain attention, TF32 off), in max and
    rms; finite; SpyNet's zero (frozen); each route's launches by shape
    those of one remat'd forward and backward (the window attention's those
    its calls imply, the recompute's included); and the window attention
    on its own (:func:`gate_attention_grads`). Returns the worst ratios."""
    import torch

    mb = {k: v[: v.shape[0] // int(cfg.train.num_grad_acc)] for k, v in batch.items()}
    clip = (*mb["lr"].shape[:4], 3)
    plans = []
    runs = {impl: vrt_grads(model, mb, impl, plans) for impl in ("fused", "take", "plain")}
    plans = dict(zip(runs, plans))
    model32 = build_train_vrt(cfg, "fp32", device)
    model32.load_state_dict(model.state_dict())
    with plain_attention():  # the attention's yardsticks: the plain version in bf16 and fp32
        attention = vrt_grads(model, mb, "fused")
        before = tf32(False)
        ref_loss, ref_sr, ref, _ = vrt_grads(model32, mb, "plain")
        tf32(before)
    del model32
    torch.cuda.empty_cache()
    worst = {"attention": gate_attention_grads(runs["fused"], attention, (ref_sr, ref))}
    plain_sr, plain = runs["plain"][1], runs["plain"][2]
    for impl, kernel in (("fused", "bilinear_sample"), ("take", "packed_row_gather")):
        loss, sr, grads, launches = runs[impl]
        want = {"bilinear_sample": {}, "packed_row_gather": {}, "window_attention": plans[impl]}
        want[kernel] = remat_launches(clip, kernel)
        gate_counts(f"VRT microbatch {clip} forward and backward ({impl}, remat)", launches, want)
        if not math.isfinite(loss):
            raise AssertionError(f"{impl}: loss {loss}")
        out = within_twice(f"{impl} SR vs fp32", sr, ref_sr, dev(plain_sr, ref_sr))
        w = {"max": (out[0], "sr"), "rms": (out[1], "sr")}
        for name in ref:
            g = grads[name]
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{impl}: {name} gradient not finite")
            if name.startswith("optical_flow."):
                if bool(g.abs().sum() > 0):
                    raise AssertionError(f"{impl}: SpyNet's {name} got a gradient")
                continue
            r = within_twice(f"{impl} gradient of {name} vs fp32", g, ref[name],
                             dev(plain[name], ref[name]))
            for i, k in enumerate(("max", "rms")):
                w[k] = max(w[k], (r[i], name))
        worst[impl] = {"loss": loss, "ratio_max": w["max"], "ratio_rms": w["rms"]}
        log(f"  {impl} route, one microbatch {clip}: loss {loss:.6f} (fp32 plain "
            f"{ref_loss:.6f}); SR and {len(ref)} gradients within twice plain bf16's deviation "
            f"from fp32, worst max {w['max'][0]:.2f} ({w['max'][1]}), rms {w['rms'][0]:.2f} "
            f"({w['rms'][1]}); SpyNet's gradients zero")
    return worst


def part_breakdown(model, run, parts, units=(), methods=(), weigh=None) -> dict:
    """Device ms of one ``run()`` (forward and backward) by part, with the
    device's total and its kernel count. A part is a module class
    (``(label, class)`` pairs) or a method (``(label, object, name)``
    triples: a forward that no module call wraps): its forwards (the
    recompute of a remat'd unit included) run inside a profiler range, and
    its backward is the autograd nodes that its forward ops created
    (matched by thread and sequence number). The forwards of ``units`` (the
    remat'd module classes) run in a range too, so that a unit's recompute
    outside the parts counts as ``other`` and not as the backward node that
    asked for it. The sampler kernels' launches and the backward nodes of
    ``BilinearSample`` (``sample_grads``) and ``PackedRowGather`` count
    apart; what no part claims is ``other``. ``weigh(event)`` gives an
    event's ``(name, us)`` pairs (default: its kernels on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    handles, stack = [], []

    def enter(label):
        def pre(mod, args):
            rf = record_function(label if label == "unit::" else f"part::{label}")
            rf.__enter__()
            stack.append(rf)
        return pre

    def leave(mod, args, out):
        stack.pop().__exit__(None, None, None)

    for m in model.modules():
        label = next((lb for lb, cls in parts if isinstance(m, cls)), None)
        if label is None and isinstance(m, tuple(units)):
            label = "unit::"
        if label is not None:
            # always_call: a recompute that stops early leaves a unit by an exception
            handles += [m.register_forward_pre_hook(enter(label)),
                        m.register_forward_hook(leave, always_call=True)]

    def ranged(label, fn):
        def call(*args, **kw):
            with record_function(f"part::{label}"):
                return fn(*args, **kw)
        return call

    for label, obj, name in methods:  # an instance attribute shadows the method
        setattr(obj, name, ranged(label, getattr(obj, name)))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
        for _, obj, name in methods:
            delattr(obj, name)
    weigh = weigh or (lambda e: [(k.name, k.duration) for k in getattr(e, "kernels", [])])
    events = [e for e in prof.events() if not str(e.device_type).endswith("CUDA")]
    grad_node = "autograd::engine::evaluate_function: "

    def owner(e, fwd):
        p = e
        while p is not None:
            if p.name.startswith("part::"):
                return p.name[6:] + " forward"
            if p.name == "unit::":  # forward work of a unit outside the parts
                return None
            if p.name.startswith(grad_node):
                node = p.name[len(grad_node):]
                if node.startswith("BilinearSampleBackward"):
                    return "sample_grads"
                if node.startswith("PackedRowGatherBackward"):
                    return "gather_grads"
                thread = getattr(p, "fwd_thread", None)
                part = fwd.get((p.thread if thread is None else thread, p.sequence_nr))
                return part and part + " backward"
            p = p.cpu_parent
        return None

    fwd = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(grad_node):
            o = owner(e, {})
            if o is not None:
                fwd[(e.thread, e.sequence_nr)] = o[: -len(" forward")]
    out, kernels = {}, 0
    for e in events:
        for name, us in weigh(e):
            if "bilinear_sample" in name:
                label = "sampler forward"
            elif "packed_row_gather" in name:
                label = "gather forward"
            else:
                label = owner(e, fwd) or "other"
            out[label] = out.get(label, 0.0) + us / 1e3
            kernels += 1
    return {"parts_ms": out, "device_ms": sum(out.values()), "kernels": kernels}


def vrt_parts(model):
    """VRT's parts for :func:`part_breakdown`: the module classes, the
    remat'd units, and SpyNet's ``adjacent_pairs`` (VRT calls the method,
    not the module)."""
    from vsrlab_tpu_torch.models.vrt import RTMSA, Stage
    from vsrlab_tpu_torch.models.vrt.window_attention import MlpGEGLU, WindowAttention
    from vsrlab_tpu_torch.nn.blocks import LayerNorm

    return ((("attention", WindowAttention), ("MLP", MlpGEGLU), ("LayerNorm", LayerNorm)),
            (Stage, RTMSA), (("SpyNet", model.optical_flow, "adjacent_pairs"),))


def vrt_train_phase(device, card) -> dict:
    """Phase 10 (a). Returns the VRT kernels' launches by shape on the main
    path (one step with the fused sampler, one with the row gather)."""
    import torch

    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step, supervised_loss

    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    tcfg = cfg.train
    acc = int(tcfg.num_grad_acc)
    check_paper_config(tcfg)
    model = build_train_vrt(cfg, tcfg.precision, device)
    n_params = sum(p.numel() for p in model.parameters())
    batch = vrt_train_batch(device)
    log(f"  VRT {n_params:,} parameters, {tcfg.precision}, remat {model.remat}, batch "
        f"{tuple(batch['lr'].shape)} -> {tuple(batch['hr'].shape)} in {acc} microbatches, "
        f"{tcfg.optimizer.to_dict()}, {tcfg.scheduler.to_dict()}, clip {tcfg.gradient_clip_val}")
    tf32_before = tf32(True)
    laps = Laps()
    gates = gate_vrt_grads(cfg, model, batch, device)
    laps("gates")

    state = create_train_state(model, build_tx(model.parameters(), tcfg.optimizer,
                                               tcfg.scheduler, tcfg.gradient_clip_val))
    step = make_supervised_train_step(model, num_grad_accum=acc)
    spynet0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if n.startswith("optical_flow.")}
    mb_clip = (VRT_TRAIN_CLIP[0] // acc, *VRT_TRAIN_CLIP[1:], 3)
    # the main path: one step with the fused sampler kernel, one with the row gather
    reset_vrt_counts()
    seen = {k: fn.launches_by_shape.copy() for k, fn in vrt_wrappers().items()}
    calls, losses = {}, []
    for impl, kernel in (("fused", "bilinear_sample"), ("take", "packed_row_gather")):
        set_sampler_impl(model, impl)
        with attention_plan(model) as plan:
            _, m = step(state, batch)
        losses.append(float(m["Loss"]))
        now = {k: fn.launches_by_shape.copy() for k, fn in vrt_wrappers().items()}
        calls[impl], seen = {k: now[k] - seen[k] for k in now}, now
        want = {"bilinear_sample": {}, "packed_row_gather": {}, "window_attention": plan}
        want[kernel] = remat_launches(mb_clip, kernel, acc)
        gate_counts(f"VRT train step ({impl}, {acc} microbatches of {mb_clip}, remat)",
                    calls[impl], want)
    set_sampler_impl(model, "fused")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"VRT train step loss not finite: {losses}")
    if not all(torch.equal(p, spynet0[n]) for n, p in model.named_parameters() if n in spynet0):
        raise AssertionError("VRT's SpyNet moved: the flow net must stay frozen")
    log(f"  two steps (fused, take): losses {losses[0]:.6f}, {losses[1]:.6f}; SpyNet's "
        f"{len(spynet0)} tensors bitwise unchanged")
    laps("the main path")

    frames = VRT_TRAIN_CLIP[0] * VRT_TRAIN_CLIP[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = time_steps(model, lambda: step(state, batch), "taps", n=VRT_TRAIN_STEPS,
                       warmup=VRT_TRAIN_WARMUP)
    med = statistics.median(times)
    timing = {"step_ms": med * 1e3, "train_fps": frames / med, "steps_ms": [t * 1e3 for t in times],
              "peak_gib_remat": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  VRT train step on {card}: {timing['step_ms']:.2f} ms, {timing['train_fps']:.3f} train "
        f"frames/s (median of {VRT_TRAIN_STEPS} after {VRT_TRAIN_WARMUP}, host clock with "
        f"synchronize), peak memory {timing['peak_gib_remat']:.2f} GiB with remat")
    laps("the timed step")
    # the whole step is not profiled (its trace's kernels take longer to read than the
    # step runs); one microbatch's breakdown by part stands in for it
    mb = {k: v[: v.shape[0] // acc] for k, v in batch.items()}

    def microbatch():
        supervised_loss(model(mb["lr"]), mb)[0].backward()

    parts = part_breakdown(model, microbatch, *vrt_parts(model))
    model.zero_grad(set_to_none=True)
    laps("the breakdown")
    timing["parts_a_microbatch"] = parts
    log(f"  one microbatch's forward and backward: device {parts['device_ms']:.2f} ms in "
        f"{parts['kernels']} kernels, by part (forwards with their recompute): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(parts["parts_ms"].items(), key=lambda kv: -kv[1])))
    # the same microbatch without remat, if it fits
    model.remat = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        microbatch()
        torch.cuda.synchronize()
        timing["peak_gib_no_remat_microbatch"] = torch.cuda.max_memory_allocated() / 2**30
    except torch.cuda.OutOfMemoryError as e:
        timing["peak_gib_no_remat_microbatch"] = f"does not fit ({str(e)[:80]})"
    model.remat = True
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    microbatch()
    torch.cuda.synchronize()
    timing["peak_gib_remat_microbatch"] = torch.cuda.max_memory_allocated() / 2**30
    model.zero_grad(set_to_none=True)
    log(f"  one microbatch's forward and backward: peak memory "
        f"{timing['peak_gib_remat_microbatch']:.2f} GiB with remat, "
        f"{timing['peak_gib_no_remat_microbatch']} GiB without")
    laps("peak memory")
    laps.log("phase 10 (a)")
    log(json.dumps({"vrt_train": {**timing, "card": card, "gates": gates, "losses": losses,
                                  "parameters": n_params}}, default=str))
    tf32(tf32_before)
    del state, step, model, batch, mb
    torch.cuda.empty_cache()
    return calls


def gather_grad_bound(shape, itemsize) -> tuple[float, str]:
    """Least time (ms) of one ``gather_grads``, shape ``(N, R, Wrow, P)``:
    the output gradient's rows and the indices read once, the table's
    gradient written once; one add an element of a row."""
    n, r, wrow, p = shape
    nbytes = n * (p * wrow * itemsize + 4 * p + r * wrow * itemsize)
    t_ops, t_bytes = n * p * wrow / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_gather_grad(xf, idx, gout, tol, label) -> float:
    """``PackedRowGather`` (the kernel forward, ``gather_grads`` backward)
    against autograd through ``packed_row_gather_plain`` in fp64: the rows
    exactly, the table's gradient within ``tol`` of its largest value; one
    kernel launch."""
    import torch

    from vsrlab_tpu_torch.ops import packed_gather as pg

    leaf = xf.detach().clone().requires_grad_(True)
    before = pg.packed_row_gather.launches
    out = pg.packed_row_gather(leaf, idx)
    out.backward(gout)
    ref_leaf = xf.detach().double().requires_grad_(True)
    ref = pg.packed_row_gather_plain(ref_leaf, idx)
    ref.backward(gout.double())
    torch.cuda.synchronize()
    launched = pg.packed_row_gather.launches - before
    same = torch.equal(out.detach().double(), ref.detach())
    want = ref_leaf.grad.to(xf.dtype).double()
    e = float((leaf.grad.double() - want).abs().max())
    ok = same and launched == 1 and e <= tol * float(want.abs().max())
    log(f"  {label}: rows {'equal' if same else 'DIFFERENT'}, max |dxf - autograd(plain)| "
        f"{e:.3e} (tol {tol} x max {float(want.abs().max()):.3e}), {launched} launch "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: PackedRowGather disagrees with autograd through plain")
    return e


def backward_grad_phase(calls, device) -> dict:
    """Phase 10 (b): at every shape the training main path gave each
    sampler kernel, the gather's gradient checked in fp32 and bf16 and both
    backwards timed by graph replay (bf16, the path's type) beside their
    bounds and one library call each (``index_select`` and ``index_add_``
    for the gather; ``F.grid_sample`` forward and backward for the
    sampler); ``BilinearSample`` checked in fp32 there too. Returns the
    rows by kernel."""
    import torch
    import torch.nn.functional as F

    from vsrlab_tpu_torch.ops import bilinear_sample as bs
    from vsrlab_tpu_torch.ops import packed_gather as pg

    out = {"packed_row_gather": [], "bilinear_sample": []}
    errs = {}
    for shape in sorted(calls["take"]["packed_row_gather"]):
        n, r, wrow, p = shape
        h = w = int(round(p ** 0.5))
        c = wrow // (4 * VRT_GP)
        for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xf, fields = packed_operands(n, h, w, c, VRT_GP, dtype, True, h, device)
            if tuple(xf.shape) != (n, r, wrow) or fields[0].shape[1] != p:
                raise AssertionError(f"cannot rebuild the operands of shape {shape}")
            gout = torch.randn((n, p, wrow), generator=torch.Generator().manual_seed(p)).to(
                device, dtype)
            errs[dname] = max(errs.get(dname, 0.0), check_gather_grad(
                xf, fields[0], gout, TOL[dname], f"PackedRowGather {dname} {shape}"))
        idx = fields[0]
        flat, gflat = xf.reshape(-1, wrow), gout.reshape(-1, wrow)
        lin = (idx.long() + torch.arange(n, device=device)[:, None] * r).reshape(-1)

        def library():  # index_select forward, index_add_ backward
            flat.index_select(0, lin)
            return torch.zeros_like(flat).index_add_(0, lin, gflat)

        b_ms, b_by = gather_grad_bound(shape, 2)
        row = {"shape": list(shape), "dtype": "bf16",
               "backward_ms": graph_ms(lambda: pg.gather_grads(gout, idx, r), calls=5),
               "backward_bound_ms": b_ms, "backward_bound_by": b_by,
               "library_fwd_bwd_ms": graph_ms(library, calls=5)}
        log(f"  gather_grads bf16 {shape}: {row['backward_ms']:.4f} ms (bound {b_ms:.4f} by "
            f"{b_by}, {100 * b_ms / row['backward_ms']:.1f} %); index_select + index_add_ "
            f"{row['library_fwd_bwd_ms']:.4f} ms (graph replay)")
        out["packed_row_gather"].append(row)
        del xf, fields, gout, idx, flat, gflat, lin
    for shape in sorted(calls["fused"]["bilinear_sample"]):
        n, h, w, c, p = shape
        x32, ix, iy = realistic_operands(n, h, w, c, torch.float32, h, device)
        fx, fy = ix.reshape(n, -1), iy.reshape(n, -1)
        g32 = torch.randn((n, p, c), generator=torch.Generator().manual_seed(p)).to(device)
        errs["sampler_fp32"] = max(errs.get("sampler_fp32", 0.0), check_sample_grad(
            x32, fx, fy, g32, True, f"BilinearSample fp32 {shape} realistic zeros"))
        x, gout = x32.bfloat16(), g32.bfloat16()
        xc = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
        grid = torch.stack([2 * ix / (w - 1) - 1, 2 * iy / (h - 1) - 1], -1).to(x.dtype)
        gc = gout.reshape(n, h, w, c).permute(0, 3, 1, 2).contiguous()

        def library():  # F.grid_sample forward and backward to the image
            return torch.autograd.grad(F.grid_sample(xc, grid, "bilinear", "zeros",
                                                     align_corners=True), xc, gc)

        b_ms, b_by = sampler_backward_bound(shape, sampler_window_bytes(x, fx, fy), 2)
        row = {"shape": list(shape), "dtype": "bf16",
               "backward_ms": graph_ms(lambda: bs.sample_grads(x, fx, fy, True, gout), calls=5),
               "backward_bound_ms": b_ms, "backward_bound_by": b_by,
               "library_fwd_bwd_ms": graph_ms(library, calls=5)}
        log(f"  sample_grads bf16 {shape}: {row['backward_ms']:.4f} ms (bound {b_ms:.4f} by "
            f"{b_by}, {100 * b_ms / row['backward_ms']:.1f} %); F.grid_sample forward + backward "
            f"{row['library_fwd_bwd_ms']:.4f} ms (graph replay)")
        out["bilinear_sample"].append(row)
        del x32, x, ix, iy, fx, fy, g32, gout, xc, grid, gc
    torch.cuda.empty_cache()
    return {"rows": out, "max_abs_err": errs}


def dp_launches(batch: int, t: int = 0) -> dict:
    """One headline train step's pair launches by shape at ``batch`` clips
    of ``t`` frames (``TRAIN_CLIP``'s by default): the recurrences 2
    directions x t frames x the residual blocks at ``batch``, the
    cleaner's steps x blocks at ``batch * t`` frames."""
    _, frames, h, w = TRAIN_CLIP
    t = t or frames
    c = HEADLINE["mid_channels"]
    return {(batch, h, w, c): 2 * t * HEADLINE["res_blocks"],
            (batch * t, h, w, c): HEADLINE["cleaning_steps"] * HEADLINE["cleaning_blocks"]}


def dp_rank_main(outdir: str) -> int:
    """One rank of phase 10 (c), started by :func:`dp_phase` with torchrun's
    environment and ``outdir/spec.json`` (the device, the model, the clip,
    the steps): the headline RealBasicVSR at ``precision: fp32`` (TF32
    off) on this rank's share of the train leg's clips, Adam 1e-4, clip
    1.0, the gradients averaged over the ranks (gloo: the ranks share the
    card). Writes its record to ``outdir/rank{RANK}.json``."""
    global HEADLINE, TRAIN_CLIP
    import torch

    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.ops.residual_pair import reset_launch_counts
    from vsrlab_tpu_torch.train import builders
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    HEADLINE, TRAIN_CLIP = spec["headline"], tuple(spec["clip"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device, mesh, created = parallel.data_parallel(True, spec["device"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rank = mesh.rank
    record = {"rank": rank, "backend": torch.distributed.get_backend(), "mesh": mesh.shape,
              "device": str(device)}
    model = build_model(None).to(device).train()
    parallel.replicated(model, mesh.group)
    state = create_train_state(model, builders.build_tx(model.parameters(), ("adam",
                                                        {"lr": 1e-4}), None, 1.0,
                                                        group=mesh.group))
    step = make_supervised_train_step(model, group=mesh.group)
    batch = parallel.shard_batch({k: v.cpu() for k, v in train_batch(device).items()}, device)
    reduced = []
    reduce = builders.all_reduce_mean

    def keep(tensors, group):  # what the updater averaged, kept for the gate
        out = reduce(tensors, group)
        reduced.append([t.detach().clone() for t in out])
        return out

    builders.all_reduce_mean = keep
    reset_launch_counts()
    seen = pair_counts()
    record["steps"] = []
    for i in range(spec["steps"]):
        _, m = step(state, batch)
        now = pair_counts()
        record["steps"].append({"loss": float(m["Loss"]),
                                "launches": {f: [[list(k), v] for k, v in (now[f] - seen[f]).items()]
                                             for f in KERNELS}})
        seen = now
        parallel.assert_replicated(model, mesh.group, f"step {i} parameters")
    builders.all_reduce_mean = reduce
    record["launches"] = {f: [[list(k), v] for k, v in seen[f].items()] for f in KERNELS}
    if rank == 0:
        torch.save([g.cpu() for g in reduced[0]], os.path.join(outdir, "grads0.pt"))
    times = []
    for _ in range(3 + 5):
        sync()
        t0 = time.perf_counter()
        step(state, batch)
        sync()
        times.append(time.perf_counter() - t0)
    record["step_ms"] = statistics.median(times[3:]) * 1e3
    grads = [p.grad for p in model.parameters()]
    record["grad_elements"] = sum(g.numel() for g in grads)
    ar = []
    for _ in range(3 + 5):
        sync()
        t0 = time.perf_counter()
        parallel.all_reduce_mean(grads, mesh.group)
        sync()
        ar.append(time.perf_counter() - t0)
    record["all_reduce_ms"] = statistics.median(ar[3:]) * 1e3
    parallel.assert_replicated(model, mesh.group, "final parameters")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if created:
        torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_phase(device, card, ranks: int = DP_RANKS, per_card: bool = False) -> dict:
    """Phase 10 (c): ``ranks`` gloo ranks on the one card (``per_card``:
    NCCL ranks, one a card), started as subprocesses with torchrun's
    environment, each training the headline RealBasicVSR (fp32, TF32 off)
    on its share of the train leg's 4 clips; the gates read their records:
    parameters bitwise equal after each step (each rank checked by a
    broadcast of rank 0's), the first step's averaged gradient within
    ``DP_TOL`` of this process's gradient on the whole batch, 420 pair
    launches a step on each rank by shape. Then, on one card, one NCCL
    group of one rank and an all-reduce. Returns the ranks' pair launches
    by shape (the fp32 kernel)."""
    import collections

    import torch

    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step, supervised_loss

    before = tf32(False)
    model = build_model(None).to(device).train()
    batch = train_batch(device)
    model.zero_grad(set_to_none=True)
    supervised_loss(model(batch["lr"]), batch)[0].backward()
    whole = [(p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
             for p in model.parameters()]
    state = create_train_state(model, build_tx(model.parameters(), ("adam", {"lr": 1e-4}), None,
                                               1.0))
    step = make_supervised_train_step(model)
    single_ms = statistics.median(time_steps(model, lambda: step(state, batch), "taps", n=3,
                                             warmup=1)) * 1e3
    del state, step, model
    torch.cuda.empty_cache()

    outdir = rank_outdir("chip_smoke_dp")
    if TRAIN_CLIP[0] % ranks:
        raise ValueError(f"{TRAIN_CLIP[0]} clips do not split over {ranks} ranks")
    one_card = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    # what each rank is to report: NCCL on a card of its own, or gloo on the one card
    expect = [("nccl", f"cuda:{r}") if per_card else ("gloo", one_card) for r in range(ranks)]
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"device": "cuda" if per_card else one_card, "headline": HEADLINE,
                   "clip": TRAIN_CLIP, "steps": DP_STEPS}, f)
    records = run_ranks("--dp-rank", outdir, ranks, DP_TIMEOUT)
    launches = collections.Counter()
    want = dp_launches(TRAIN_CLIP[0] // ranks)
    for r in records:
        if (r["backend"], r["device"]) != expect[r["rank"]]:
            raise AssertionError(f"rank {r['rank']}: {r['backend']} on {r['device']}, "
                                 f"not {expect[r['rank']]}")
        for i, s in enumerate(r["steps"]):
            got = {f: {tuple(k): v for k, v in s["launches"][f]} for f in KERNELS}
            gate_counts(f"rank {r['rank']} step {i}", got, {"taps": want})
        for k, v in r["launches"]["taps"]:
            launches[tuple(k)] += v
    if any([s["loss"] for s in r["steps"]] != [s["loss"] for s in records[0]["steps"]]
           for r in records):
        raise AssertionError("the ranks' averaged losses differ")
    reduced = torch.load(os.path.join(outdir, "grads0.pt"))
    worst = 0.0
    for a, b in zip(reduced, whole):
        b = b.cpu()
        d = (a - b).abs()
        if not bool((d <= DP_TOL[0] + DP_TOL[1] * b.abs()).all()):
            raise AssertionError(f"the averaged gradient differs from one process's by "
                                 f"{float(d.max()):.3e}")
        worst = max(worst, float(d.max()))
    where = "one rank a card" if per_card else "on one card"
    log(f"  {ranks} {expect[0][0]} ranks, {where}, {card}: parameters bitwise equal after each of "
        f"{DP_STEPS} steps; the first step's averaged gradient within {DP_TOL[0]} + "
        f"{DP_TOL[1]}*|b| of one process's on the whole batch (max |a-b| {worst:.3e}); "
        f"{sum(want.values())} pair launches a step on each rank")
    log(f"  fp32 step (TF32 off): one process, batch {TRAIN_CLIP[0]}: {single_ms:.2f} ms; "
        f"{ranks} ranks {where}, {TRAIN_CLIP[0] // ranks} clips each: "
        + " / ".join(f"{r['step_ms']:.2f}" for r in records)
        + f" ms; all-reduce of {records[0]['grad_elements']:,} fp32 gradients "
        f"{records[0]['all_reduce_ms']:.2f} ms ({expect[0][0]}, host clock with synchronize)")
    if not per_card:  # the backend a user with a card a rank gets: NCCL, one rank
        backend = "nccl" if device.type == "cuda" else "gloo"
        torch.distributed.init_process_group(backend,
                                             init_method=f"tcp://localhost:{free_port()}",
                                             rank=0, world_size=1)
        try:
            t = torch.arange(6.0, device=device)
            parallel.all_reduce_mean([t], torch.distributed.group.WORLD)
            if not torch.equal(t, torch.arange(6.0, device=device)):
                raise AssertionError(f"{backend} all-reduce of one rank changed its tensor")
        finally:
            torch.distributed.destroy_process_group()
        log(f"  {backend}: a group of one rank initialised and all-reduced on {device}")
    tf32(before)
    record = {"single_step_ms": single_ms, "ranks": records, "grad_max_abs_diff": worst,
              "per_card": per_card}
    log(json.dumps({"data_parallel": {**record, "card": card}}))
    return {"taps": launches}


def dp_trainer(ranks: int, card: str) -> None:
    """``python -m torch.distributed.run --nproc_per_node ranks -m
    vsrlab_tpu_torch.train.train`` on SyntheticVSR (``+experiment=synthetic``
    at the headline's 64 channels, 64x64 HR clips, batch 4, 2 epochs), one
    rank a card: NCCL, a barrier after each rank-0 save, the trainer's
    replica check after each epoch. Gates: a clean exit, the two epochs'
    checkpoints and the validation rows of the log, each epoch's line
    printed once (rank 0 alone prints)."""
    import shutil

    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_dp_train")
    shutil.rmtree(root, ignore_errors=True)
    hr = [f"train.data.datasets.{split}.{side}=64" for split in ("train", "val")
          for side in ("height", "width")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
           "--master_port", str(free_port()), "-m", "vsrlab_tpu_torch.train.train",
           "+experiment=synthetic", "device=cuda", "train.ddp=true", "train.max_epochs=2",
           f"train.model.mid_channels={HEADLINE['mid_channels']}", *hr,
           f"train.checkpoint_dir={root}/ckpt", "train.logger.backend=jsonl",
           f"train.logger.save_dir={root}/logs", "train.logger.project=chip_smoke",
           "train.logger.id=dp"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                          timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    out = done.stdout + done.stderr
    if done.returncode != 0:
        raise AssertionError(f"torchrun train.train exited {done.returncode}:\n{out[-4000:]}")
    keys = CheckpointManager(f"{root}/ckpt").all_keys()
    rows = open(f"{root}/logs/chip_smoke/dp/metrics.jsonl").read().splitlines()
    # a line "epoch k: ..." from each rank that prints (torchrun may tag it "[rankN]:")
    epochs = [m.group(1) for m in map(re.compile(r"(?:\[rank\d+\]:)?(epoch \d+: .*)").match,
                                      done.stdout.splitlines()) if m]
    if keys != [0, 1] or sum("Loss/Val" in r for r in rows) != 2 or \
            [e.split(":")[0] for e in epochs] != ["epoch 0", "epoch 1"]:
        raise AssertionError(f"torchrun train.train: checkpoints {keys}, {len(rows)} log rows, "
                             f"epoch lines {epochs}:\n{out[-4000:]}")
    log(f"  train.train under torchrun, {ranks} NCCL ranks one a card, {card}: SyntheticVSR "
        f"batch 4 of 3x64x64, 64 channels, 2 epochs in {seconds:.1f} s (start-up and builds "
        f"included); checkpoints {keys}, each epoch printed once: {epochs}")


def dp_cards_main() -> int:
    """``--dp-cards``: phase 10 (c) with one NCCL rank a card over every
    visible card, then :func:`dp_trainer` on them; the last line as the
    whole script's, ``count`` the cards used."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --dp-cards: needs two or more CUDA GPUs", file=sys.stderr)
        return 1
    from vsrlab_tpu_torch.build import load

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = torch.cuda.device_count()
    card = card_line()
    log(f"data parallelism over {ranks} x {torch.cuda.get_device_name(0)}")
    log(card)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(load, ("residual_pair", "packed_gather", "bilinear_sample",
                                    "window_attention")))
    for lib in libs:
        log(f"  kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    t = [time.perf_counter()]
    dp_phase(torch.device("cuda"), card, ranks=ranks, per_card=True)
    t.append(time.perf_counter())
    dp_trainer(ranks, card)
    t.append(time.perf_counter())
    log(f"  the time axis (time = {ranks}, {SP_CARDS_FRAMES} frames) and the model axis (model = "
        f"2) over the cards")
    p11_cards(ranks, card)
    t.append(time.perf_counter())
    log("  the VRT +experiment=vrt step, data-parallel over the cards")
    vrt_dp_cards(ranks, card)
    t.append(time.perf_counter())
    log("  sequence-parallel training over the cards (phase 12's split step)")
    sp_cards(ranks, card)
    t.append(time.perf_counter())
    log("  sequence-parallel VRT training over the cards (phase 13's split step)")
    ref = vrt_sp_cards(ranks, card)
    t.append(time.perf_counter())
    log("  VRT over time and model at once over the cards (phase 15)")
    p15_cards(ranks, card, ref)
    t.append(time.perf_counter())
    log(f"  took {t[-1] - t[0]:.1f} s: the ranks' steps {t[1] - t[0]:.1f}, the trainer "
        f"{t[2] - t[1]:.1f}, the time and model axes {t[3] - t[2]:.1f}, the VRT step "
        f"{t[4] - t[3]:.1f}, the split step {t[5] - t[4]:.1f}, the split VRT step "
        f"{t[6] - t[5]:.1f}, phase 15 {t[7] - t[6]:.1f}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": ranks}}))
    return 0


def phase10(device, card):
    """Phase 10: VRT training at ``+experiment=vrt``'s shape (a), the
    samplers' backward at its shapes (b), data parallelism on one card (c),
    and the phase's wall seconds (d). Returns the sampler launches of (a)
    and the pair launches of (c)."""
    t = [time.perf_counter()]
    log("  (a) VRT training, paper configuration, +experiment=vrt's shape")
    calls = vrt_train_phase(device, card)
    t.append(time.perf_counter())
    log("  (b) the samplers' backward at the training shapes")
    backward = backward_grad_phase(calls, device)
    t.append(time.perf_counter())
    log("  (c) data parallelism: two gloo ranks on one card, one NCCL rank")
    dp = dp_phase(device, card)
    t.append(time.perf_counter())
    log(f"  (d) phase 10 took {t[-1] - t[0]:.1f} s: (a) {t[1] - t[0]:.1f}, (b) "
        f"{t[2] - t[1]:.1f}, (c) {t[3] - t[2]:.1f}")
    return calls, backward, dp


# phase 11: the time and model mesh axes on ranks of their own, and the host data core
SP_CLIP = (1, 20, 180, 320, 3)  # windowed20: 2 windows of 10, one a rank
SP_CARDS_FRAMES = 40  # --dp-cards: 4 windows of 10, one a card on four cards
SP_WINDOW = 10
SP_REPEATS = 3
TP_CLIP = (1, 6, 64, 64, 3)  # the paper VRT's request: 3 of its 6 heads a rank
P11_RANKS = 2
P11_TIMEOUT = 600
CODEC_TOL = 1e-5  # the native codec against the numpy path (tests/test_codec_emulator.py:92)
CODEC_SETTINGS = ((30.0, 4, True), (85.0, 8, False), (5.0, 2, True))


def sp_clip(frames: int = SP_CLIP[1]):
    """The headline request's clip (phase 3's for 20 frames), from a seeded
    generator."""
    import torch

    return torch.rand((1, frames, *SP_CLIP[2:]), generator=torch.Generator().manual_seed(1))


def tp_inputs():
    """The head-sharded VRT request and its gradient's target."""
    import torch

    g = torch.Generator().manual_seed(3)
    b, t, h, w, c = TP_CLIP
    return torch.rand(TP_CLIP, generator=g), torch.rand((b, t, 4 * h, 4 * w, c), generator=g)


def build_tp_vrt(dtype_name: str, head_shard_axis=None, **kw):
    """The paper VRT of ``conf/train/model/vrt.yaml`` (6 heads, ``remat``) at
    the training paths' depth with seeded weights, the offset heads drawn,
    in ``dtype_name``; ``kw`` joins the model's config."""
    import torch

    import vsrlab_tpu_torch.components  # noqa: F401  (fills the registry)
    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.nn.blocks import init_weights
    from vsrlab_tpu_torch.train import builders

    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    spec = {**cfg.train.model.to_dict(), "head_shard_axis": head_shard_axis, **kw}
    g = torch.Generator().manual_seed(0)
    return seed_offset_heads(init_weights(builders.build_model(spec, dtype_name), g), g)


def tp_grads(model, lr, hr, device) -> dict:
    """One fp32 forward and backward of ``model`` (fused sampler, remat) on
    ``lr``, loss the mean square error to ``hr``: the gradient by parameter
    name on ``device``, made whole and equal on the ranks of the active
    mesh's head-sharding group by ``parallel.all_reduce_sharded_grads``:
    the reduction ``make_supervised_train_step`` runs after its
    backward."""
    from vsrlab_tpu_torch.parallel import all_reduce_sharded_grads
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl

    set_sampler_impl(model.to(device).train(), "fused")
    model.zero_grad(set_to_none=True)
    sr = model(lr.to(device))[0]
    (sr - hr.to(device)).square().mean().backward()
    all_reduce_sharded_grads(model)
    grads = {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def vrt_counts() -> dict:
    """The two samplers' launches by shape so far (the ranks' gates hold
    these; the window attention is held in phases 2, 4, 6 and 10)."""
    return {k: fn.launches_by_shape.copy() for k, fn in vrt_wrappers().items() if k in SAMPLERS}


def listed(counts: dict) -> dict:
    """Launches by shape as JSON: ``{kernel: [[shape, n], ...]}``."""
    return {k: [[list(s), n] for s, n in c.items() if n] for k, c in counts.items()}


def unlisted(counts: dict) -> dict:
    import collections

    return {k: collections.Counter({tuple(s): n for s, n in v}) for k, v in counts.items()}


def p11_rank_main(outdir: str) -> int:
    """One rank of phase 11 (a) and (b) (and of ``--dp-cards``' time and model
    axes), started with torchrun's environment and ``outdir/spec.json``:
    (a) the headline RealBasicVSR serving ``spec["frames"]`` frames through
    ``windowed_inference`` over ``create_mesh({"data": -1, "time": n})``:
    its launches, its result, its ms; (b) the paper VRT with
    ``head_shard_axis="model"`` inside ``use_mesh(create_mesh({"data": -1,
    "model": 2}))``: a bf16 request with each sampler kernel (launches,
    outputs), one fp32 backward (its gradients, after ``all_reduce_sharded_grads``,
    bitwise equal on the ranks of the model group, or the rank fails).
    Writes ``outdir/rank{RANK}.json`` and its tensors beside it."""
    import torch

    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.evaluation.harness import make_forward, windowed_inference
    from vsrlab_tpu_torch.models.vrt import WindowAttention
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl
    from vsrlab_tpu_torch.ops.residual_pair import reset_launch_counts

    global HEADLINE, SP_CLIP, TP_CLIP, VRT_TRAIN_OVERRIDES
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    HEADLINE, SP_CLIP, TP_CLIP = spec["headline"], tuple(spec["sp_clip"]), tuple(spec["tp_clip"])
    VRT_TRAIN_OVERRIDES = tuple(spec["vrt_overrides"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    created = parallel.initialize_distributed(spec["device"])
    device = parallel.rank_device(spec["device"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    free = torch.cuda.empty_cache if cuda else (lambda: None)
    rank = parallel.process_index()
    record = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(device)}

    def timed(fn, n=SP_REPEATS):
        times = []
        for _ in range(1 + n):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:]) * 1e3

    # (a) the time axis: this rank's share of the windows, the whole result gathered
    mesh = parallel.create_mesh({"data": -1, "time": spec["time"]})
    model = build_model(torch.bfloat16)
    forward = make_forward(model, device=device)
    clip = sp_clip(spec["frames"])
    reset_launch_counts()
    sr, n = windowed_inference(forward, clip, SP_WINDOW, mesh)
    sync()
    record.update(time_mesh=mesh.shape, windows=n, sp_launches=listed(pair_counts()),
                  sp_shape=list(sr.shape), sp_finite=bool(torch.isfinite(sr).all()))
    torch.save(sr.cpu(), os.path.join(outdir, f"sp{rank}.pt"))
    record["sp_ms"] = timed(lambda: windowed_inference(forward, clip, SP_WINDOW, mesh))
    del model, forward, sr
    free()

    # (b) the model axis: the paper VRT's heads split over the ranks
    mesh = parallel.create_mesh({"data": -1, "model": 2})
    lr, hr = tp_inputs()
    model = build_tp_vrt("bf16", "model")
    forward = make_forward(model, device=device)
    outs = {}
    with parallel.use_mesh(mesh):
        record["heads"] = sorted({m.head_shard()[1:] for m in model.modules()
                                  if isinstance(m, WindowAttention)})
        for impl in ("fused", "take"):
            set_sampler_impl(model, impl)
            reset_vrt_counts()
            outs[impl] = forward(lr).float().cpu()
            sync()
            record[f"tp_launches_{impl}"] = listed(vrt_counts())
        set_sampler_impl(model, "fused")
        record["tp_ms"] = timed(lambda: forward(lr))
    record["model_mesh"] = mesh.shape
    torch.save(outs, os.path.join(outdir, f"tp{rank}.pt"))
    del model, forward
    free()
    model32 = build_tp_vrt("fp32", "model")
    with parallel.use_mesh(mesh):
        grads = tp_grads(model32, lr, hr, device)
    parallel.assert_replicated(list(grads.values()), mesh.axis_group("model"),
                               "head-sharded gradients")
    torch.save({k: v.cpu() for k, v in grads.items()}, os.path.join(outdir, f"grads{rank}.pt"))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if created:
        torch.distributed.destroy_process_group()
    return 0


def run_ranks(flag: str, outdir: str, ranks: int, timeout: int) -> list:
    """Start ``ranks`` processes of this script with ``flag outdir`` and
    torchrun's environment (one OpenMP thread each), wait for all, raise if
    one fails; returns each rank's ``rank{r}.json`` record."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, outdir],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"{flag} rank {rank} exited {p.returncode}:\n{out[-3000:]}"
              for rank, (p, out) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:  # every failed rank: the first to fail may not be the first listed
        raise AssertionError("\n".join(failed))
    records = []
    for rank in range(ranks):
        with open(os.path.join(outdir, f"rank{rank}.json")) as f:
            records.append(json.load(f))
    return records


def p11_spec(outdir: str, device: str, frames: int, time_axis: int) -> None:
    """Phase 11's ``spec.json`` for its ranks: the device, the clip's frames,
    the time axis's size, and the sizes this process runs with."""
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"device": device, "frames": frames, "time": time_axis, "headline": HEADLINE,
                   "sp_clip": SP_CLIP, "tp_clip": TP_CLIP, "vrt_overrides": VRT_TRAIN_OVERRIDES},
                  f)


def rank_outdir(name: str) -> str:
    """``build/<name>``, created empty: the ranks' spec and records."""
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", name)
    os.makedirs(outdir, exist_ok=True)
    for entry in os.listdir(outdir):
        os.remove(os.path.join(outdir, entry))
    return outdir


def p11_reference(device, frames: int = SP_CLIP[1]) -> dict:
    """This process's side of phase 11 (a) and (b), each unsharded: the
    headline model's forward of each 10-frame window of a ``frames``-frame
    clip alone, the clip's ``windowed_inference`` as one batch of its
    windows with the kernel, the plain pair and in fp32, and that request's
    ms; the paper VRT's request with each sampler kernel (launches by
    shape), with the plain sampler and in fp32, and one fp32 backward's
    gradients (fused sampler, remat)."""
    import torch

    from vsrlab_tpu_torch.evaluation.harness import make_forward, windowed_inference
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl, set_sampler_impl

    ref = {}
    model = build_model(torch.bfloat16)
    forward = make_forward(model, device=device)
    clip = sp_clip(frames)
    ref["windows"] = torch.cat([forward(clip[:, i:i + SP_WINDOW]).cpu()
                                for i in range(0, frames, SP_WINDOW)], 1)
    ref["batched"] = windowed_inference(forward, clip, SP_WINDOW)[0].cpu()
    times = []
    for _ in range(1 + SP_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        windowed_inference(forward, clip, SP_WINDOW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ref["windowed_ms"] = statistics.median(times[1:]) * 1e3
    set_pair_impl(model, "plain")
    ref["plain"] = windowed_inference(forward, clip, SP_WINDOW)[0].cpu()
    model32 = build_model(None)
    model32.load_state_dict(model.state_dict())
    set_pair_impl(model32, "plain")
    ref["fp32"] = windowed_inference(make_forward(model32, device=device), clip,
                                     SP_WINDOW)[0].cpu()
    del model, model32, forward
    torch.cuda.empty_cache()

    lr, hr = tp_inputs()
    model = build_tp_vrt("bf16")
    forward = make_forward(model, device=device)
    ref["vrt_launches"] = {}
    for impl in ("fused", "take"):
        set_sampler_impl(model, impl)
        reset_vrt_counts()
        ref[f"vrt_{impl}"] = forward(lr).float().cpu()
        ref["vrt_launches"][impl] = vrt_counts()
    set_sampler_impl(model, "plain")
    ref["vrt_plain"] = forward(lr).float().cpu()
    set_sampler_impl(model, "fused")
    times = []
    for _ in range(1 + SP_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ref["vrt_ms"] = statistics.median(times[1:]) * 1e3
    del model, forward
    model32 = build_tp_vrt("fp32")
    set_sampler_impl(model32, "plain")
    ref["vrt_fp32"] = make_forward(model32, device=device)(lr).float().cpu()
    ref["grads"] = {k: v.cpu() for k, v in tp_grads(model32, lr, hr, device).items()}
    del model32
    torch.cuda.empty_cache()
    return ref


def gate_p11_ranks(records, ref, outdir, per_card: bool) -> dict:
    """Phase 11's gates on the ranks' records and tensors against this
    process's unsharded runs ``ref``. Returns their pair launches
    (``taps``) and sampler launches by shape."""
    import collections

    import torch

    one_card = "cuda:0" if records[0]["device"].startswith("cuda") else "cpu"
    pairs = collections.Counter()
    samplers = {k: collections.Counter() for k in SAMPLERS}
    frames = records[0]["sp_shape"][1]
    windows = -(-frames // SP_WINDOW)
    per_rank = -(-windows // records[0]["time_mesh"]["time"])
    base = dev(ref["plain"], ref["fp32"])
    for r in records:
        k = r["rank"]
        want = ("nccl", f"cuda:{k}") if per_card else ("gloo", one_card)
        if (r["backend"], r["device"]) != want:
            raise AssertionError(f"rank {k}: {r['backend']} on {r['device']}, not {want}")
        if r["windows"] != windows or not r["sp_finite"] or r["sp_shape"] != [
                1, frames, 4 * SP_CLIP[2], 4 * SP_CLIP[3], 3]:
            raise AssertionError(f"rank {k}: {r['windows']} windows, shape {r['sp_shape']}, "
                                 f"finite {r['sp_finite']}")
        got = unlisted(r["sp_launches"])
        gate_counts(f"rank {k}: its {per_rank} window(s) of the {frames}-frame clip", got,
                    {"taps": window_launches(per_rank, *SP_CLIP[2:4])})
        pairs += got["taps"]
        sr = torch.load(os.path.join(outdir, f"sp{k}.pt"))
        if not torch.equal(sr, ref["windows"]):
            raise AssertionError(f"rank {k}: the gathered windowed{frames} differs from this "
                                 "process's forward of each window alone")
        ratio = within_twice(f"rank {k}'s windowed{frames} vs this process's batch of {windows}",
                             sr, ref["batched"], base)
        log(f"  rank {k}: windowed{frames} gathered over the time axis bitwise equal to this "
            f"process's forward of each window alone; against its batch of {windows}: "
            f"{ratio[0]:.2f}x / {ratio[1]:.2f}x plain bf16's deviation from fp32 (max / rms)")
        heads = [tuple(h) for h in r["heads"]]
        m = k % 2  # the rank's index on the model axis (model 2, the last axis)
        if heads != [(3 * m, 3 * m + 3)]:
            raise AssertionError(f"rank {k}: heads {heads}, not [{3 * m}, {3 * m + 3})")
        for impl in ("fused", "take"):
            got = unlisted(r[f"tp_launches_{impl}"])
            gate_counts(f"rank {k}: head-sharded VRT request ({impl})", got,
                        ref["vrt_launches"][impl])
            for name, by_shape in got.items():
                samplers[name] += by_shape
        outs = torch.load(os.path.join(outdir, f"tp{k}.pt"))
        gate_samplers({f"rank {k} head-sharded {impl}": out for impl, out in outs.items()},
                      ref["vrt_plain"], ref["vrt_fp32"])
        grads = torch.load(os.path.join(outdir, f"grads{k}.pt"))
        if grads.keys() != ref["grads"].keys():
            raise AssertionError(f"rank {k}: the head-sharded gradients name other parameters")
        worst = largest = 0.0
        for name, b in ref["grads"].items():
            d = (grads[name] - b).abs()
            if not bool((d <= DP_TOL[0] + DP_TOL[1] * b.abs()).all()):
                raise AssertionError(f"rank {k}: head-sharded gradient of {name} differs from "
                                     f"the unsharded one by {float(d.max()):.3e}")
            worst, largest = max(worst, float(d.max())), max(largest, float(b.abs().max()))
        log(f"  rank {k}: head-sharded fp32 gradients ({len(grads)} tensors) within "
            f"{DP_TOL[0]} + {DP_TOL[1]}*|b| of the unsharded ones: max |a-b| {worst:.3e} "
            f"(largest |b| {largest:.3e})")
    return {"taps": pairs, "samplers": samplers}


def log_p11_times(records, ref, card, where: str) -> None:
    frames = records[0]["sp_shape"][1]
    log(f"  windowed{frames} on {card}: a rank (its windows, then the gather) "
        + " / ".join(f"{r['sp_ms']:.2f}" for r in records)
        + f" ms ({frames / max(r['sp_ms'] for r in records) * 1e3:.2f} frames/s); one process, "
        f"every window as one batch: {ref['windowed_ms']:.2f} ms "
        f"({frames / ref['windowed_ms'] * 1e3:.2f} frames/s) (median of {SP_REPEATS} after 1, "
        f"host clock with synchronize; {where})")
    log(f"  VRT {TP_CLIP} bf16 fused on {card}: a rank with 3 of 6 heads "
        + " / ".join(f"{r['tp_ms']:.2f}" for r in records)
        + f" ms; one process, all heads: {ref['vrt_ms']:.2f} ms")


def codec_sample_ms(numpy_path: bool) -> dict:
    """The flow trainer's level-5 sample (phase 9's loader: 2 frames of
    768x1024, the codec at CRF 34, 12 fps), native or numpy: the codec
    emulator alone on its frames and the whole sample, on this thread
    (median of 3), and the loader's ms a batch of 8 over 8 threads (its
    first call, and the median of 3 after it)."""
    import unittest.mock

    import numpy as np

    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.data import codec_emulator, native
    from vsrlab_tpu_torch.train import spynet

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_host")
    cfg = load_config(overrides=spynet_overrides(root))
    k = SPYNET_K - 1
    train_ds, _ = spynet.load_level_data(cfg, k, k)
    frames = np.stack(train_ds[0][:2])  # the sample's two frames
    patch = (unittest.mock.patch.object(native, "_load", lambda: None) if numpy_path
             else contextlib.nullcontext())
    out = {}
    with patch:
        native.reset_counts()
        for name, fn in (("codec_ms", lambda: codec_emulator.dct_codec_roundtrip(
                             frames, codec_emulator.crf_to_quality(34), gop=12)),
                         ("sample_ms", lambda: train_ds[0])):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            out[name] = statistics.median(times) * 1e3
        times = []
        for _ in range(4):  # the first call pays the threads' first touch of their buffers
            loader = spynet.FlowLoader(train_ds, batch_size=SPYNET_BATCH, num_workers=8)
            t0 = time.perf_counter()
            list(loader)
            times.append(time.perf_counter() - t0)
        out["loader_first_ms"] = times[0] * 1e3
        out["loader_ms"] = statistics.median(times[1:]) * 1e3
        out["paths"] = native.counts()["codec_degrade"]
    want = "python" if numpy_path else "native"
    if out["paths"][want] == 0 or out["paths"]["native" if numpy_path else "python"]:
        raise AssertionError(f"the codec took the wrong path: {out['paths']}")
    out["frames"] = list(frames.shape)
    return out


def host_core_phase(card) -> dict:
    """Phase 11 (c): ``libvsrio`` built with g++ on the card's host (a
    failure fails the phase), the native codec against the numpy path at
    the JAX package's three settings within ``CODEC_TOL``, and the flow
    loader's times with each."""
    import numpy as np

    from vsrlab_tpu_torch import build
    from vsrlab_tpu_torch.data import codec_emulator, native

    lib = build.load_host("vsrio")
    opencv = native.has_opencv()
    log(f"  libvsrio built in {lib.build_seconds:.1f} s -> {lib.path.name}; its OpenCV half "
        f"(decode, bicubic, JPEG) {'built' if opencv else 'not built: no opencv4 headers'} "
        f"(headers: {build.opencv_include()})")
    rng = np.random.default_rng(0)
    base = rng.random((5, 5, 8, 3)).astype(np.float32)
    clip = np.clip(np.repeat(np.repeat(base, 5, 1), 5, 2)[:, :21, :35]
                   + 0.02 * rng.standard_normal((5, 21, 35, 3)).astype(np.float32), 0, 1)
    native.reset_counts()
    worst = 0.0
    for q, gop, sub in CODEC_SETTINGS:
        got = codec_emulator.dct_codec_roundtrip(clip, q, gop, sub)
        want = codec_emulator.dct_codec_roundtrip(clip, q, gop, sub, force_numpy=True)
        worst = max(worst, float(np.abs(got - want).max()))
    if native.counts()["codec_degrade"] != {"native": len(CODEC_SETTINGS), "python": 0}:
        raise AssertionError(f"the codec did not take the native path: {native.counts()}")
    if worst > CODEC_TOL:
        raise AssertionError(f"the native codec differs from the numpy path by {worst:.3e}")
    log(f"  codec_degrade took the native path; against force_numpy=True at {CODEC_SETTINGS}: "
        f"max |a-b| {worst:.3e} (gate {CODEC_TOL})")
    res = {"opencv": opencv, "build_s": lib.build_seconds, "max_abs_err": worst,
           "native": codec_sample_ms(False), "numpy": codec_sample_ms(True)}
    n, p = res["native"], res["numpy"]
    log(f"  flow loader's level-5 sample {tuple(n['frames'])} on {card}'s host: codec "
        f"{n['codec_ms']:.1f} ms native / {p['codec_ms']:.1f} ms numpy; the sample "
        f"{n['sample_ms']:.1f} / {p['sample_ms']:.1f} ms (one thread); the loader "
        f"{n['loader_ms']:.1f} / {p['loader_ms']:.1f} ms a batch of {SPYNET_BATCH} (8 threads; "
        f"first call {n['loader_first_ms']:.1f} / {p['loader_first_ms']:.1f} ms)")
    return res


def vrt_dp_rank_main(outdir: str) -> int:
    """One NCCL rank of ``--dp-cards``' VRT step: ``+experiment=vrt`` (the
    paper VRT, bf16, remat) on this rank's share of the experiment's 8
    clips, in microbatches of one card's size (8 / 4 clips), the gradients
    averaged over the ranks; the step's ms (median of 3 after 2) and one
    step's device ms and busy share (torch.profiler). Writes
    ``outdir/rank{RANK}.json``."""
    import torch

    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    tcfg = cfg.train
    check_paper_config(tcfg)
    device, mesh, created = parallel.data_parallel(True, "cuda")
    model = build_train_vrt(cfg, tcfg.precision, device)
    parallel.replicated(model, mesh.group)
    acc = max(1, int(tcfg.num_grad_acc) // mesh.size)
    state = create_train_state(model, build_tx(model.parameters(), tcfg.optimizer,
                                               tcfg.scheduler, tcfg.gradient_clip_val,
                                               group=mesh.group))
    step = make_supervised_train_step(model, num_grad_accum=acc, group=mesh.group)
    batch = parallel.shard_batch({k: v.cpu() for k, v in vrt_train_batch("cpu").items()}, device)
    losses = []

    def run():
        losses.append(float(step(state, batch)[1]["Loss"]))

    times = time_steps(model, run, "taps", n=3, warmup=2)
    med = statistics.median(times)
    prof = profile_request(run, med, top=5, ours=("bilinear_sample",), host=False)
    parallel.assert_replicated(model, mesh.group, "VRT parameters after the steps")
    record = {"rank": mesh.rank, "clips": int(batch["lr"].shape[0]), "microbatches": acc,
              "step_ms": med * 1e3, "steps_ms": [t * 1e3 for t in times],
              "device_ms": prof.get("device_ms"), "busy": prof.get("device_busy_share"),
              "losses": losses}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"rank {mesh.rank}: losses {losses}")
    with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(record, f)
    if created:
        torch.distributed.destroy_process_group()
    return 0


def vrt_dp_cards(ranks: int, card: str) -> None:
    """``--dp-cards`` (c): the ``+experiment=vrt`` step in one process on one
    card (8 clips in 4 microbatches) beside ``ranks`` NCCL ranks, one a
    card, each on its share in microbatches of the same size: device ms
    first (the wall time is host-bound and wanders), then the step's ms."""
    import torch

    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    device = torch.device("cuda", 0)
    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    tcfg = cfg.train
    model = build_train_vrt(cfg, tcfg.precision, device)
    state = create_train_state(model, build_tx(model.parameters(), tcfg.optimizer,
                                               tcfg.scheduler, tcfg.gradient_clip_val))
    step = make_supervised_train_step(model, num_grad_accum=int(tcfg.num_grad_acc))
    batch = vrt_train_batch(device)
    med = statistics.median(time_steps(model, lambda: step(state, batch), "taps", n=3, warmup=2))
    prof = profile_request(lambda: step(state, batch), med, top=5, ours=("bilinear_sample",),
                           host=False)
    del state, step, model, batch
    torch.cuda.empty_cache()
    records = run_ranks("--vrt-dp-rank", rank_outdir("chip_smoke_vrt_dp"), ranks, P11_TIMEOUT)
    log(f"  VRT +experiment=vrt step, {card}: one card, 8 clips in 4 microbatches: device "
        f"{prof.get('device_ms')} ms (busy {prof.get('device_busy_share')}), step {med * 1e3:.2f} "
        f"ms; {ranks} NCCL ranks, {records[0]['clips']} clips each in "
        f"{records[0]['microbatches']} microbatch(es): device "
        + " / ".join(f"{r['device_ms']}" for r in records) + " ms, step "
        + " / ".join(f"{r['step_ms']:.2f}" for r in records)
        + " ms (median of 3 after 2, host clock with synchronize); the ranks bitwise equal")
    log(json.dumps({"vrt_dp_cards": {"card": card, "one_card_step_ms": med * 1e3,
                                     "one_card_profile": prof, "ranks": records}}, default=str))


def p11_cards(ranks: int, card: str) -> None:
    """``--dp-cards`` (a), (b): phase 11's ranks with NCCL, one a card: the
    headline model on a ``SP_CARDS_FRAMES``-frame clip over ``time = ranks``
    and the paper VRT over ``model = 2`` (``data = ranks / 2``), under
    phase 11's gates against this process's runs on card 0."""
    import torch

    ref = p11_reference(torch.device("cuda", 0), SP_CARDS_FRAMES)
    torch.cuda.empty_cache()
    outdir = rank_outdir("chip_smoke_p11_cards")
    p11_spec(outdir, "cuda", SP_CARDS_FRAMES, ranks)
    records = run_ranks("--p11-rank", outdir, ranks, P11_TIMEOUT)
    gate_p11_ranks(records, ref, outdir, per_card=True)
    log_p11_times(records, ref, card, f"{ranks} NCCL ranks, one a card, against one card")
    log(json.dumps({"p11_cards": {"card": card, "ranks": records,
                                  "one_card_windowed_ms": ref["windowed_ms"],
                                  "one_card_vrt_ms": ref["vrt_ms"]}}, default=str))


def phase11(device, card):
    """Phase 11: (a) sequence-parallel serving and (b) head-sharded VRT on
    two gloo ranks sharing the card, against this process's unsharded runs;
    (c) the host data core; (d) the phase's wall seconds. Returns the
    ranks' pair and sampler launches by shape."""
    import torch

    t = [time.perf_counter()]
    log("  (a), (b): this process's unsharded runs")
    ref = p11_reference(device)
    t.append(time.perf_counter())
    log(f"  (a), (b): {P11_RANKS} gloo ranks on one card: create_mesh({{'time': 2}}) serving "
        f"windowed20, then create_mesh({{'model': 2}}) with the paper VRT's heads split")
    outdir = rank_outdir("chip_smoke_p11")
    p11_spec(outdir, f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu", SP_CLIP[1],
             P11_RANKS)
    records = run_ranks("--p11-rank", outdir, P11_RANKS, P11_TIMEOUT)
    launches = gate_p11_ranks(records, ref, outdir, per_card=False)
    log_p11_times(records, ref, card, "the ranks share the card")
    t.append(time.perf_counter())
    del ref
    torch.cuda.empty_cache()
    log("  (c) the host data core")
    host = host_core_phase(card)
    t.append(time.perf_counter())
    log(f"  (d) phase 11 took {t[-1] - t[0]:.1f} s: references {t[1] - t[0]:.1f}, the ranks "
        f"{t[2] - t[1]:.1f}, (c) {t[3] - t[2]:.1f}")
    log(json.dumps({"phase11": {"card": card, "ranks": records, "host_core": host,
                                "seconds": t[-1] - t[0]}}, default=str))
    return launches


# phase 12: sequence-parallel training of the headline RealBasicVSR over the time axis
SP_TRAIN_AXES = {"data": 1, "time": 2}  # the train leg's 6 frames, 3 a rank
SP_TRAIN_STEPS, SP_TRAIN_WARMUP = 5, 2
SP_TRAIN_TIMEOUT = 300
SP_EVAL_RTOL = 1e-5


def sp_rank_main(outdir: str) -> int:
    """One rank of phase 12 (and of ``--dp-cards``' split step), started with
    torchrun's environment and ``outdir/spec.json``: the headline
    RealBasicVSR with ``time_shard_axis="time"`` on this rank's block of
    the train leg's 4 clips (``shard_batch_sp`` over ``create_mesh(axes)``),
    each step ``make_supervised_train_step`` with ``group=mesh.mesh_group``
    inside ``use_mesh``, Adam 1e-4, clip 1.0: the eval step's metrics from
    the seeded weights (fp32, TF32 off), one fp32 step (TF32 off) and one
    bf16 step (TF32 on, as phase 5), each with its pair launches, its loss,
    the gradients the update averaged (rank 0 writes them) and the ranks'
    parameters after it checked bitwise equal; then the bf16 step's ms
    (median of ``SP_TRAIN_STEPS`` after ``SP_TRAIN_WARMUP``), its device ms
    (torch.profiler) and this rank's peak memory. Writes
    ``outdir/rank{RANK}.json``."""
    global HEADLINE, TRAIN_CLIP
    import torch

    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.ops.residual_pair import reset_launch_counts
    from vsrlab_tpu_torch.train import builders
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_eval_step, make_supervised_train_step

    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    HEADLINE, TRAIN_CLIP = spec["headline"], tuple(spec["clip"])
    torch.backends.cuda.matmul.allow_tf32 = False
    created = parallel.initialize_distributed(spec["device"])
    device = parallel.rank_device(spec["device"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = parallel.create_mesh(spec["axes"])
    group = mesh.mesh_group
    rank = mesh.rank
    record = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(device),
              "mesh": mesh.shape, "coords": mesh.coords}
    batch = parallel.shard_batch_sp(train_batch("cpu"), mesh, device)
    record["block"] = list(batch["lr"].shape)
    reduce, kept = builders.all_reduce_mean, []

    def keep(tensors, g):  # what the updater averaged, before its clip, kept for the gates
        out = reduce(tensors, g)
        kept.append([t.detach().clone() for t in out])
        return out

    builders.all_reduce_mean = keep
    steps = {}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        tf32(dtype is not None)
        model = build_model(dtype, time_shard_axis="time").to(device).train()
        state = create_train_state(model, builders.build_tx(
            model.parameters(), ("adam", {"lr": 1e-4}), None, 1.0, group=group))
        step = make_supervised_train_step(model, group=group)
        with parallel.use_mesh(mesh):
            if dtype is None:
                metrics, sr = make_eval_step(model, group=group)(None, batch)
                record["eval"] = {k: float(v) for k, v in metrics.items()}
                record["eval_finite"] = bool(torch.isfinite(sr).all())
            kept.clear()
            reset_launch_counts()
            _, m = step(state, batch)
            sync()
        record[label] = {"loss": float(m["Loss"]), "launches": listed(pair_counts())}
        parallel.assert_replicated(model, group, f"the {label} step's parameters")
        if rank == 0:
            names = [n for n, _ in model.named_parameters()]
            torch.save(dict(zip(names, (g.cpu() for g in kept[0]))),
                       os.path.join(outdir, f"grads_{label}.pt"))
        steps[label] = (model, state, step)
    builders.all_reduce_mean = reduce
    del steps["fp32"]
    model, state, step = steps.pop("bf16")
    free = torch.cuda.empty_cache if cuda else (lambda: None)
    free()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    with parallel.use_mesh(mesh):
        for _ in range(SP_TRAIN_WARMUP + SP_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            step(state, batch)
            sync()
            times.append(time.perf_counter() - t0)
        record["step_ms"] = statistics.median(times[SP_TRAIN_WARMUP:]) * 1e3
        record["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        record["profile"] = profile_request(lambda: step(state, batch), record["step_ms"] / 1e3,
                                            top=8, groups=TRAIN_GROUPS, host=False) if cuda else {}
    parallel.assert_replicated(model, group, "the timed steps' parameters")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if created:
        torch.distributed.destroy_process_group()
    return 0


def sp_train_reference(device) -> dict:
    """Phase 12's one-process runs on the train leg's 4 clips: the eval
    metrics and one step's loss and gradients in fp32 (TF32 off, through
    the fp32 pair kernel, as the ranks' fp32 step), the plain route's bf16
    gradients (with the fp32 ones, phase 5's gate), and the bf16 step's
    ms, device ms and peak memory."""
    import torch

    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import (make_eval_step, make_supervised_train_step,
                                             supervised_loss)

    batch = train_batch(device)
    before = tf32(False)
    model32 = build_model(None).to(device).train()
    metrics, _ = make_eval_step(model32)(None, batch)
    ref = {"eval": {k: float(v) for k, v in metrics.items()}}
    model32.zero_grad(set_to_none=True)
    loss = supervised_loss(model32(batch["lr"]), batch)[0]
    loss.backward()
    ref["loss32"] = float(loss.detach())
    ref["grads32"] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
                      for n, p in model32.named_parameters()}
    del model32, loss
    tf32(True)
    model = build_model(torch.bfloat16).to(device).train()
    ref["plain16"] = step_grads(model, batch, "plain")
    state = create_train_state(model, build_tx(model.parameters(), ("adam", {"lr": 1e-4}), None,
                                               1.0))
    step = make_supervised_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = time_steps(model, lambda: step(state, batch), "taps", n=SP_TRAIN_STEPS,
                       warmup=SP_TRAIN_WARMUP)
    ref["step_ms"] = statistics.median(times) * 1e3
    ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ref["profile"] = profile_request(lambda: step(state, batch), ref["step_ms"] / 1e3, top=8,
                                     groups=TRAIN_GROUPS, host=False)
    tf32(before)
    del model, state, step, batch
    torch.cuda.empty_cache()
    return ref


def sp_train_ranks(ref, axes: dict, device_spec: str, per_card: bool, card: str) -> dict:
    """Start ``axes``' ranks of :func:`sp_rank_main` and gate their records
    against ``ref``: each rank's eval metrics within ``SP_EVAL_RTOL`` of one
    process's, its fp32 loss within rtol 1e-5 and the fp32 gradients the
    update averaged within ``DP_TOL`` (``1e-5 + 1e-4|b|``) of one process's,
    the bf16 ones within twice plain bf16's deviation from fp32 (phase 5's
    rule), and each step's pair launches by shape; the ranks checked their
    parameters bitwise equal after each step. Returns the ranks' pair
    launches by shape, bf16 and fp32."""
    import collections

    import torch

    n = math.prod(axes.values())
    outdir = rank_outdir("chip_smoke_sp_train")
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"device": device_spec, "axes": axes, "headline": HEADLINE,
                   "clip": TRAIN_CLIP}, f)
    t0 = time.perf_counter()
    records = run_ranks("--sp-rank", outdir, n, SP_TRAIN_TIMEOUT)
    seconds = time.perf_counter() - t0
    one_card = "cuda:0" if device_spec.startswith("cuda") else "cpu"
    b, t = TRAIN_CLIP[0] // axes.get("data", 1), TRAIN_CLIP[1] // axes["time"]
    want = {"taps": dp_launches(b, t)}
    launches = {"bf16": collections.Counter(), "fp32": collections.Counter()}
    for r in records:
        k = r["rank"]
        expect = ("nccl", f"cuda:{k}") if per_card else ("gloo", one_card)
        if (r["backend"], r["device"]) != expect:
            raise AssertionError(f"rank {k}: {r['backend']} on {r['device']}, not {expect}")
        if r["block"] != [b, t, *TRAIN_CLIP[2:], 3] or not r["eval_finite"]:
            raise AssertionError(f"rank {k}: block {r['block']}, eval finite {r['eval_finite']}")
        for name, v in ref["eval"].items():
            if not math.isclose(r["eval"][name], v, rel_tol=SP_EVAL_RTOL):
                raise AssertionError(f"rank {k}: eval {name} {r['eval'][name]} against one "
                                     f"process's {v}")
        if not math.isclose(r["fp32"]["loss"], ref["loss32"], rel_tol=1e-5):
            raise AssertionError(f"rank {k}: fp32 loss {r['fp32']['loss']} against one "
                                 f"process's {ref['loss32']}")
        for label in ("fp32", "bf16"):
            got = unlisted(r[label]["launches"])
            gate_counts(f"rank {k} ({r['coords']}): the {label} step, {b} clips of {t} frames",
                        got, want)
            launches[label] += got["taps"]
    grads32 = torch.load(os.path.join(outdir, "grads_fp32.pt"))
    worst = 0.0
    for name, w in ref["grads32"].items():
        d = (grads32[name] - w.cpu()).abs()
        if not bool((d <= DP_TOL[0] + DP_TOL[1] * w.cpu().abs()).all()):
            raise AssertionError(f"the split fp32 gradient of {name} differs from one process's "
                                 f"by {float(d.max()):.3e}")
        worst = max(worst, float(d.max()))
    grads16 = {k: v.to(ref["plain16"][k].device)
               for k, v in torch.load(os.path.join(outdir, "grads_bf16.pt")).items()}
    ratio = gate_grads("split bf16 gradient", grads16, ref["plain16"], ref["grads32"])
    where = "one rank a card" if per_card else "sharing the card"
    log(f"  {n} {records[0]['backend']} ranks {axes} ({where}), {b} clips x {t} frames a rank: "
        f"eval metrics within rtol {SP_EVAL_RTOL} of one process's, fp32 losses within rtol "
        f"1e-5, the averaged fp32 gradients within {DP_TOL[0]} + {DP_TOL[1]}*|b| (max |a-b| "
        f"{worst:.3e}), the bf16 ones within twice plain bf16's deviation from fp32 (worst "
        f"ratio max {ratio['max'][0]:.2f}, rms {ratio['rms'][0]:.2f}); parameters bitwise equal "
        f"on the ranks after each step; {sum(want['taps'].values())} pair launches a step")
    def num(x):
        return f"{x:.2f}" if isinstance(x, float) else str(x)

    log(f"  bf16 step on {card}: a rank "
        + " / ".join(f"{r['step_ms']:.2f}" for r in records) + " ms (device "
        + " / ".join(num(r["profile"].get("device_ms")) for r in records) + " ms), peak "
        + " / ".join(num(r["peak_gib"]) for r in records)
        + f" GiB; one process on the {TRAIN_CLIP[0]} clips: {ref['step_ms']:.2f} ms (device "
        f"{num(ref['profile'].get('device_ms'))} ms), peak {num(ref['peak_gib'])} GiB (median of "
        f"{SP_TRAIN_STEPS} after {SP_TRAIN_WARMUP}, host clock with synchronize); the ranks took "
        f"{seconds:.1f} s")
    log(json.dumps({"sp_train": {"card": card, "axes": axes, "per_card": per_card,
                                 "ranks": records, "one_process": {
                                     k: ref[k] for k in ("step_ms", "peak_gib", "profile",
                                                         "eval", "loss32")},
                                 "fp32_grad_max_abs_diff": worst,
                                 "bf16_grad_ratio": ratio}}, default=str))
    return launches


def phase12(device, card) -> dict:
    """Phase 12: sequence-parallel training of the headline RealBasicVSR over
    ``time = 2`` on two gloo ranks sharing the card, against this process's
    step on the whole batch. Returns the ranks' pair launches by shape."""
    t = [time.perf_counter()]
    ref = sp_train_reference(device)
    t.append(time.perf_counter())
    one_card = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    launches = sp_train_ranks(ref, SP_TRAIN_AXES, one_card, False, card)
    t.append(time.perf_counter())
    log(f"  phase 12 took {t[2] - t[0]:.1f} s: this process's runs {t[1] - t[0]:.1f}, the ranks "
        f"and their gates {t[2] - t[1]:.1f}")
    return launches


def sp_cards(cards: int, card: str) -> None:
    """``--dp-cards``: the split step with one NCCL rank a card, ``data = 2 x
    time = 2`` on four cards or more, ``time = 2`` on two or three, under
    phase 12's gates against one card's step on the 4 clips."""
    import torch

    axes = {"data": 2, "time": 2} if cards >= 4 else dict(SP_TRAIN_AXES)
    ref = sp_train_reference(torch.device("cuda", 0))
    sp_train_ranks(ref, axes, "cuda", True, card)


# phase 13: sequence-parallel training of the paper VRT over the time axis
VRT_SP_AXES = {"data": 1, "time": 2}  # +experiment=vrt's 6 frames, 3 a rank
VRT_SP_STEPS, VRT_SP_WARMUP = 1, 0  # timed after the gated fp32, bf16 and take steps
VRT_SP_TIMEOUT = 600


def vrt_microbatch(device) -> dict:
    """One microbatch of ``+experiment=vrt``: the first ``batch / num_grad_acc``
    (2) clips of :func:`vrt_train_batch`, 6 LR frames of 64x64 and their
    256x256 HR."""
    acc = 4  # +experiment=vrt's num_grad_acc (check_paper_config)
    return {k: v[: VRT_TRAIN_CLIP[0] // acc] for k, v in vrt_train_batch(device).items()}


def split_vrt_launches(clip, kernel, rank: int, ranks: int) -> dict:
    """Sampler launches of one remat'd forward and backward of a rank's
    block of ``clip`` (``(B, T, H, W, 3)``, ``T / ranks`` frames a rank):
    at every stage 9 taps over ``B * nb * groups`` images for the backward
    direction (``nb``: the rank's frames that have a next frame in the
    clip) and 9 over ``B * nf * groups`` for the forward one, twice
    (the recompute)."""
    import collections

    b, t, h, w, _ = clip
    per = t // ranks
    nb, nf = per - (rank == ranks - 1), per - (rank == 0)
    want = collections.Counter()
    for frames in (nb, nf):
        for key, n in expected_vrt_launches((b, frames + 1, h, w, 3), kernel, groups=VRT_GROUPS,
                                            cg=VRT_CG, gp=VRT_GP).items():
            want[key] += n  # 18 a stage: 9 taps of this direction, twice (the recompute)
    return want


def vrt_sp_rank_main(outdir: str) -> int:
    """One rank of phase 13 (and of ``--dp-cards``' split VRT step), started
    with torchrun's environment and ``outdir/spec.json``: the paper VRT of
    ``+experiment=vrt`` (``remat``) built with ``time_shard_axis="time"``
    on this rank's block of one microbatch (``shard_batch_sp`` over
    ``create_mesh(axes)``), each step ``make_supervised_train_step`` with
    ``group=mesh.mesh_group`` inside ``use_mesh`` and the experiment's
    optimizer, schedule and clip: one fp32 step (TF32 off) and one bf16
    step (cuDNN's TF32 on, as phase 10) with the fused sampler, each with
    its sampler launches by shape, its loss and the gradients the update
    averaged (rank 0 writes them), the ranks' parameters checked bitwise
    equal after it; one bf16 step with the row gather (its launches);
    then the bf16 step's ms (median of ``VRT_SP_STEPS`` after
    ``VRT_SP_WARMUP``), its device ms and busy share (torch.profiler), this
    rank's peak memory with ``remat`` and, in one more step, without it
    (phase 13). With ``spec["heads"]`` (phase 15) the model also splits its
    heads over that axis (``head_shard_axis``), and with ``spec["serve"]``
    the rank then serves :func:`p15_serve_clip`
    through ``windowed_inference`` over the mesh in bf16 (its sampler
    launches, the gathered result). Writes ``outdir/rank{RANK}.json``."""
    import torch

    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.evaluation.harness import make_forward, windowed_inference
    from vsrlab_tpu_torch.models.vrt import WindowAttention
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl
    from vsrlab_tpu_torch.train import builders
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step, supervised_loss

    global VRT_TRAIN_OVERRIDES, VRT_TRAIN_CLIP
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    VRT_TRAIN_OVERRIDES, VRT_TRAIN_CLIP = tuple(spec["overrides"]), tuple(spec["clip"])
    torch.backends.cuda.matmul.allow_tf32 = False
    created = parallel.initialize_distributed(spec["device"])
    device = parallel.rank_device(spec["device"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    free = torch.cuda.empty_cache if cuda else (lambda: None)

    def peak(reset: bool = False):
        if not cuda:
            return None
        if reset:
            torch.cuda.reset_peak_memory_stats()
        return torch.cuda.max_memory_allocated() / 2**30

    mesh = parallel.create_mesh(spec["axes"])
    group, rank, heads = mesh.mesh_group, mesh.rank, spec.get("heads")
    laps = Laps()
    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    tcfg = cfg.train
    record = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(device),
              "mesh": mesh.shape, "coords": mesh.coords}
    batch = parallel.shard_batch_sp(vrt_microbatch("cpu"), mesh, device)
    record["block"] = list(batch["lr"].shape)
    reduce, kept = builders.all_reduce_mean, []

    def keep(tensors, g):  # what the updater averaged, before its clip, kept for the gates
        out = reduce(tensors, g)
        kept.append([t.detach().clone() for t in out])
        return out

    def new_step(dtype_name):
        model = build_train_vrt(cfg, dtype_name, device, time_shard_axis="time",
                                head_shard_axis=heads)
        state = create_train_state(model, builders.build_tx(
            model.parameters(), tcfg.optimizer, tcfg.scheduler, tcfg.gradient_clip_val,
            group=group))
        return model, state, make_supervised_train_step(model, group=group)

    builders.all_reduce_mean = keep
    for label in ("fp32", "bf16"):
        tf32(label == "bf16")
        model, state, step = new_step(label)
        if heads and label == "fp32":
            with parallel.use_mesh(mesh):
                record["heads"] = sorted({m.head_shard()[1:] for m in model.modules()
                                          if isinstance(m, WindowAttention)})
        if label == "bf16":  # the plain route's gradients, split alike: the bf16 gate's yardstick
            with parallel.use_mesh(mesh):
                set_sampler_impl(model, "plain")
                supervised_loss(model(batch["lr"]), batch)[0].backward()
                set_sampler_impl(model, "fused")
            plain = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in model.parameters()]
            reduce(plain, group)
            if rank == 0:
                torch.save(dict(zip([n for n, _ in model.named_parameters()],
                                    (g.cpu() for g in plain))),
                           os.path.join(outdir, "grads_plain16.pt"))
            model.zero_grad(set_to_none=True)
            del plain
        with parallel.use_mesh(mesh):
            kept.clear()
            reset_vrt_counts()
            _, m = step(state, batch)
            sync()
        record[label] = {"loss": float(m["Loss"]), "launches": listed(vrt_counts())}
        laps(label)
        parallel.assert_replicated(model, group, f"the {label} step's parameters")
        if rank == 0:
            names = [n for n, _ in model.named_parameters()]
            torch.save(dict(zip(names, (g.cpu() for g in kept[0]))),
                       os.path.join(outdir, f"grads_{label}.pt"))
        if label == "fp32":
            del model, state, step
            free()
    builders.all_reduce_mean = reduce
    with parallel.use_mesh(mesh):
        set_sampler_impl(model, "take")
        reset_vrt_counts()
        _, m = step(state, batch)
        sync()
        record["take"] = {"loss": float(m["Loss"]), "launches": listed(vrt_counts())}
        laps("take")
        set_sampler_impl(model, "fused")
        parallel.assert_replicated(model, group, "the take step's parameters")
        free()
        peak(reset=True)
        times = []
        for _ in range(VRT_SP_WARMUP + VRT_SP_STEPS):
            sync()
            t0 = time.perf_counter()
            step(state, batch)
            sync()
            times.append(time.perf_counter() - t0)
        times = times[VRT_SP_WARMUP:]
        record["step_ms"] = statistics.median(times) * 1e3
        record["steps_ms"] = [t * 1e3 for t in times]
        record["peak_gib_remat"] = peak()
        laps("timed")
        record["profile"] = profile_request(
            lambda: step(state, batch), record["step_ms"] / 1e3, top=8,
            ours=("bilinear_sample",), host=False) if cuda else {}
        laps("profile")
        if not heads:  # phase 13 (phase 15 skips it: phase 13's rank holds the figure)
            model.remat = False
            free()
            peak(reset=True)
            step(state, batch)
            sync()
            record["peak_gib_no_remat"] = peak()
    parallel.assert_replicated(model, group, "the timed steps' parameters")
    if spec.get("serve"):
        del state, step, model
        free()
        served = build_tp_vrt("bf16", heads, time_shard_axis="time")
        forward = make_forward(served, device=device)
        reset_vrt_counts()
        sr, n = windowed_inference(forward, p15_serve_clip(), P15_SERVE_WINDOW, mesh)
        sync()
        record["serve"] = {"windows": n, "shape": list(sr.shape),
                           "launches": listed(vrt_counts())}
        torch.save(sr.float().cpu(), os.path.join(outdir, f"served{rank}.pt"))
    laps("the rest")
    record["laps"] = laps.parts
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if created:
        torch.distributed.destroy_process_group()
    return 0


def vrt_sp_reference(device) -> dict:
    """Phase 13's one-process runs on the microbatch: one fp32 forward and
    backward's loss and gradients with the fused sampler (TF32 off), the
    plain route's bf16 gradients (with the fp32 ones, phase 5's gate),
    then the bf16 step's ms, device ms, busy share and peak memory with
    ``remat``, and the peak of one more step without it."""
    import torch

    from vsrlab_tpu_torch.core.config import load_config
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    tcfg = cfg.train
    check_paper_config(tcfg)
    batch = vrt_microbatch(device)
    before = tf32(False)
    model32 = build_train_vrt(cfg, "fp32", device)
    loss32, _, grads32, _ = vrt_grads(model32, batch, "fused")
    del model32
    torch.cuda.empty_cache()
    tf32(True)
    model = build_train_vrt(cfg, "bf16", device)
    ref = {"loss32": loss32, "grads32": grads32, "plain16": vrt_grads(model, batch, "plain")[2]}
    state = create_train_state(model, build_tx(model.parameters(), tcfg.optimizer,
                                               tcfg.scheduler, tcfg.gradient_clip_val))
    step = make_supervised_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = time_steps(model, lambda: step(state, batch), "taps", n=VRT_SP_STEPS,
                       warmup=VRT_SP_WARMUP)
    ref["step_ms"] = statistics.median(times) * 1e3
    ref["steps_ms"] = [t * 1e3 for t in times]
    ref["peak_gib_remat"] = torch.cuda.max_memory_allocated() / 2**30
    ref["profile"] = profile_request(lambda: step(state, batch), ref["step_ms"] / 1e3, top=8,
                                     ours=("bilinear_sample",), host=False)
    model.remat = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    ref["peak_gib_no_remat"] = torch.cuda.max_memory_allocated() / 2**30
    tf32(before)
    del model, state, step, batch
    torch.cuda.empty_cache()
    return ref


def vrt_sp_ranks(ref, axes: dict, device_spec: str, per_card: bool, card: str,
                 serve=None, beside=None) -> dict:
    """Start ``axes``' ranks of :func:`vrt_sp_rank_main` and gate their
    records against ``ref``: each rank's fp32 loss within rtol 1e-5 of one
    process's (the rank's share of the mesh's mean), the fp32 gradients the
    update averaged within ``DP_TOL`` (``1e-5 + 1e-4|b|``) of one process's,
    the bf16 ones within twice plain bf16's deviation from fp32 (phase 5's
    rule), SpyNet's zero, and each step's sampler launches by shape on
    each rank; the ranks checked their parameters bitwise equal after each
    step. Where ``axes`` has a ``model`` axis (phase 15) the heads split
    over it too (each rank's range gated), and ``serve`` (from
    :func:`p15_serve_reference`) gates the ranks' served clip: its sampler
    launches by shape, every rank's result bitwise equal (the model line's
    all-reduce gives its ranks the same sums, the time line's gather the
    same windows), within the bf16 gate of this process's request.
    ``beside`` (phase 13's records) is printed beside the ranks' times.
    Returns the ranks' sampler launches by kernel and shape (the bf16
    steps' (fused and take) and the served clip's under ``bf16``, the fp32
    step's under ``fp32``) and their records."""
    import collections

    import torch

    n = math.prod(axes.values())
    heads = "model" if axes.get("model", 1) > 1 else None
    outdir = rank_outdir("chip_smoke_vrt_tm" if heads else "chip_smoke_vrt_sp")
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"device": device_spec, "axes": axes, "overrides": VRT_TRAIN_OVERRIDES,
                   "clip": VRT_TRAIN_CLIP, "heads": heads, "serve": serve is not None}, f)
    t0 = time.perf_counter()
    records = run_ranks("--vrt-sp-rank", outdir, n, VRT_SP_TIMEOUT)
    seconds = time.perf_counter() - t0
    one_card = "cuda:0" if device_spec.startswith("cuda") else "cpu"
    clip = (*vrt_microbatch("cpu")["lr"].shape[:4], 3)
    b, t = clip[0] // axes.get("data", 1), clip[1] // axes["time"]
    launches = {"bf16": {k: collections.Counter() for k in SAMPLERS},
                "fp32": collections.Counter()}
    for r in records:
        k, coords = r["rank"], r["coords"]
        expect = ("nccl", f"cuda:{k}") if per_card else ("gloo", one_card)
        if (r["backend"], r["device"]) != expect:
            raise AssertionError(f"rank {k}: {r['backend']} on {r['device']}, not {expect}")
        if r["block"] != [b, t, *clip[2:4], 3]:
            raise AssertionError(f"rank {k}: block {r['block']}")
        if heads:
            m, nh = coords["model"], 6 // axes["model"]
            if [tuple(h) for h in r["heads"]] != [(m * nh, (m + 1) * nh)]:
                raise AssertionError(f"rank {k}: heads {r['heads']}, not [{m * nh}, "
                                     f"{(m + 1) * nh})")
        if not math.isclose(r["fp32"]["loss"], ref["loss32"], rel_tol=1e-5):
            raise AssertionError(f"rank {k}: fp32 loss {r['fp32']['loss']} against one "
                                 f"process's {ref['loss32']}")
        for label in ("fp32", "bf16", "take"):
            if not math.isfinite(r[label]["loss"]):
                raise AssertionError(f"rank {k}: the {label} step's loss {r[label]['loss']}")
        for label, kernel in (("fp32", "bilinear_sample"), ("bf16", "bilinear_sample"),
                              ("take", "packed_row_gather")):
            got = unlisted(r[label]["launches"])
            want = {name: {} for name in SAMPLERS}
            want[kernel] = split_vrt_launches((b, clip[1], *clip[2:]), kernel,
                                              coords["time"], axes["time"])
            gate_counts(f"rank {k} ({coords}): the {label} step, {b} clips of {t} frames", got,
                        want)
            if label == "fp32":
                launches["fp32"] += got["bilinear_sample"]
            else:
                launches["bf16"][kernel] += got[kernel]
    grads32 = torch.load(os.path.join(outdir, "grads_fp32.pt"))
    worst = 0.0
    for name, w in ref["grads32"].items():
        w = w.cpu()
        d = (grads32[name].float() - w).abs()
        if not bool((d <= DP_TOL[0] + DP_TOL[1] * w.abs()).all()):
            raise AssertionError(f"the split fp32 gradient of {name} differs from one process's "
                                 f"by {float(d.max()):.3e}")
        worst = max(worst, float(d.max()))
    grads16, plain16 = (torch.load(os.path.join(outdir, f"grads_{k}.pt"))
                        for k in ("bf16", "plain16"))
    rows, bad = [], []
    for name, w in ref["grads32"].items():
        g = grads16[name].to(w.device).float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"the split bf16 gradient of {name} is not finite")
        if name.startswith("optical_flow."):
            if bool(g.abs().sum() > 0):
                raise AssertionError(f"SpyNet's {name} got a gradient on the ranks")
            continue
        got, base = dev(g, w), dev(plain16[name].to(w.device), w)
        once = dev(ref["plain16"][name], w)  # one process's plain bf16: reported, not gated
        rows.append(tuple(d / b if b else 0.0 for d, b in zip(got + got, base + once)) + (name,))
        if got[0] > 2 * base[0] or got[1] > 2 * base[1]:
            bad.append(f"{name}: max {got[0]:.3e} rms {got[1]:.3e} against twice the split plain "
                       f"bf16 route's max {base[0]:.3e} rms {base[1]:.3e}")
    top = sorted(rows, reverse=True)[:3]
    once = sorted(rows, key=lambda r: -r[2])[:3]
    log("  the split bf16 gradients' deviation from fp32 over the split plain route's (max / "
        "rms), worst: " + ", ".join(f"{r[4]} {r[0]:.2f} / {r[1]:.2f}" for r in top)
        + "; over one process's plain bf16 (not gated: a split rounds each rank's sum), worst: "
        + ", ".join(f"{r[4]} {r[2]:.2f} / {r[3]:.2f}" for r in once) + f", "
        f"{sum(r[2] > 2 or r[3] > 2 for r in rows)} of {len(rows)} tensors beyond 2")
    if bad:
        raise AssertionError("the split bf16 gradients beyond twice the split plain route's "
                             "deviation from fp32: " + "; ".join(bad))
    ratio = {"max": max((r[0], r[4]) for r in rows), "rms": max((r[1], r[4]) for r in rows),
             "one_process_max": max((r[2], r[4]) for r in rows),
             "one_process_rms": max((r[3], r[4]) for r in rows),
             "one_process_beyond_2": sum(r[2] > 2 or r[3] > 2 for r in rows)}
    where = "one rank a card" if per_card else "sharing the card"
    log(f"  {n} {records[0]['backend']} ranks {axes} ({where}), {b} clips x {t} frames a rank: "
        f"the averaged fp32 gradients within {DP_TOL[0]} + {DP_TOL[1]}*|b| of one process's "
        f"(max |a-b| {worst:.3e}), the bf16 ones within twice the split plain route's deviation "
        f"from fp32 (worst ratio max {ratio['max'][0]:.2f} ({ratio['max'][1]}), rms "
        f"{ratio['rms'][0]:.2f} ({ratio['rms'][1]})); SpyNet's zero; parameters bitwise equal "
        f"on the ranks after each "
        f"step; fp32 losses " + " / ".join(f"{r['fp32']['loss']:.6f}" for r in records)
        + f" (one process {ref['loss32']:.6f}); sampler launches by shape gated on each step")

    def num(x, fmt="{:.2f}"):
        return fmt.format(x) if isinstance(x, float) else str(x)

    def prof(p):
        return (f"device {num(p.get('device_ms'))} ms, busy "
                f"{num(p.get('device_busy_share'), '{:.3f}')}")

    if serve is not None:
        gate_served(records, serve, outdir, axes)
        for r in records:
            launches["bf16"]["bilinear_sample"] += unlisted(r["serve"]["launches"])[
                "bilinear_sample"]

    def ranks_line(recs):
        return (" / ".join(f"{r['step_ms']:.2f}" for r in recs) + " ms ("
                + " / ".join(prof(r["profile"]) for r in recs) + "), peak "
                + " / ".join(num(r["peak_gib_remat"]) for r in recs) + " GiB with remat")

    log(f"  bf16 step on {card}: a rank {ranks_line(records)}"
        + ("" if heads else ", " + " / ".join(num(r["peak_gib_no_remat"]) for r in records)
           + " without")
        + (f"; phase 13's time = {VRT_SP_AXES['time']} rank {ranks_line(beside)}"
           if beside else "")
        + f"; one process on the {clip[0]} clips: {ref['step_ms']:.2f} ms "
        f"({prof(ref['profile'])}), peak {num(ref['peak_gib_remat'])} GiB with remat, "
        f"{num(ref['peak_gib_no_remat'])} without (median of {VRT_SP_STEPS} after "
        f"{VRT_SP_WARMUP}, host clock with synchronize); the ranks took {seconds:.1f} s")
    log(json.dumps({"vrt_tm_train" if heads else "vrt_sp_train": {
        "card": card, "axes": axes, "per_card": per_card, "ranks": records,
        "one_process": {k: ref[k] for k in ("step_ms", "steps_ms", "peak_gib_remat",
                                            "peak_gib_no_remat", "profile", "loss32")},
        "fp32_grad_max_abs_diff": worst, "bf16_grad_ratio": ratio}}, default=str))
    return {**launches, "records": records}


def phase13(device, card) -> dict:
    """Phase 13: sequence-parallel training of the paper VRT over ``time =
    2`` on two gloo ranks sharing the card, against this process's step on
    the same microbatch. Returns the ranks' sampler launches by shape and
    records, and this process's runs (``ref``, which phase 15 reuses)."""
    t = [time.perf_counter()]
    ref = vrt_sp_reference(device)
    t.append(time.perf_counter())
    one_card = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    out = vrt_sp_ranks(ref, VRT_SP_AXES, one_card, False, card)
    t.append(time.perf_counter())
    log(f"  phase 13 took {t[2] - t[0]:.1f} s: this process's runs {t[1] - t[0]:.1f}, the ranks "
        f"and their gates {t[2] - t[1]:.1f}")
    return {**out, "ref": ref}


# phase 15: the paper VRT split over time and model at once
P15_AXES = {"data": 1, "time": 2, "model": 2}  # 3 of a clip's 6 frames and 3 of 6 heads a rank
P15_SERVE_CLIP = (1, 12, 64, 64, 3)  # two windows of 6 frames, one a time rank
P15_SERVE_WINDOW = 6


def p15_serve_clip():
    """Phase 15's served clip, from a seeded generator."""
    import torch

    return torch.rand(P15_SERVE_CLIP, generator=torch.Generator().manual_seed(15))


def p15_serve_reference(device) -> dict:
    """This process's side of phase 15's request: the same seeded paper VRT
    (the training paths' depth, 6 heads) unsharded through
    ``windowed_inference`` of :func:`p15_serve_clip` (its two windows as one
    batch) in bf16 with the fused sampler and the plain one, and in fp32 on
    the plain route (TF32 off)."""
    import torch

    from vsrlab_tpu_torch.evaluation.harness import make_forward, windowed_inference
    from vsrlab_tpu_torch.nn.blocks import set_sampler_impl

    clip = p15_serve_clip()
    before = tf32(False)
    model = build_tp_vrt("bf16")
    forward = make_forward(model, device=device)
    ref = {"bf16": windowed_inference(forward, clip, P15_SERVE_WINDOW)[0].float().cpu()}
    set_sampler_impl(model, "plain")
    ref["plain"] = windowed_inference(forward, clip, P15_SERVE_WINDOW)[0].float().cpu()
    del model, forward
    model32 = build_tp_vrt("fp32")
    set_sampler_impl(model32, "plain")
    ref["fp32"] = windowed_inference(make_forward(model32, device=device), clip,
                                     P15_SERVE_WINDOW)[0].float().cpu()
    tf32(before)
    del model32
    torch.cuda.empty_cache()
    return ref


def gate_served(records, serve, outdir, axes) -> None:
    """Phase 15's request on the ranks: every rank served
    :func:`p15_serve_clip`'s two windows (one a time rank) with one window's
    fused-sampler launches by shape, and returns the whole clip bitwise
    equal to every other rank's (its model line first) and within twice
    plain bf16's deviation from fp32 of this process's fp32 run and of its
    bf16 request."""
    import torch

    b, t, h, w, _ = P15_SERVE_CLIP
    windows = t // P15_SERVE_WINDOW
    want = {"bilinear_sample": expected_vrt_launches(
        (b * windows // axes["time"], P15_SERVE_WINDOW, h, w, 3), "bilinear_sample",
        groups=VRT_GROUPS, cg=VRT_CG, gp=VRT_GP), "packed_row_gather": {}}
    outs = {r["rank"]: torch.load(os.path.join(outdir, f"served{r['rank']}.pt")) for r in records}
    by_time = {}
    for r in records:
        k, sr = r["rank"], outs[r["rank"]]
        if r["serve"]["windows"] != windows or r["serve"]["shape"] != [b, t, 4 * h, 4 * w, 3]:
            raise AssertionError(f"rank {k}: served {r['serve']}")
        if not bool(torch.isfinite(sr).all()):
            raise AssertionError(f"rank {k}: the served clip is not finite")
        gate_counts(f"rank {k} ({r['coords']}): its window of the served clip",
                    unlisted(r["serve"]["launches"]), want)
        first = by_time.setdefault(r["coords"]["time"], sr)
        if not torch.equal(sr, first) or not torch.equal(sr, outs[0]):
            raise AssertionError(f"rank {k}: the served clip differs from its model line's or "
                                 "rank 0's")
    base = dev(serve["plain"], serve["fp32"])
    ratio = within_twice("the ranks' served clip vs this process's bf16 request", outs[0],
                         serve["bf16"], base)
    gate_samplers({"the ranks' served clip": outs[0]}, serve["plain"], serve["fp32"])
    log(f"  windowed_inference of {P15_SERVE_CLIP} in windows of {P15_SERVE_WINDOW} over {axes}: "
        f"one window a time rank, 3 of 6 heads a model rank; every rank's clip bitwise equal, "
        f"{ratio[0]:.2f}x / {ratio[1]:.2f}x plain bf16's deviation from fp32 (max / rms) off "
        "this process's bf16 request")


def phase15(device, card, ref, beside) -> dict:
    """Phase 15: the paper VRT split over ``time = 2`` and ``model = 2`` at
    once on four gloo ranks sharing the card (3 frames of each clip and 3 of
    the 6 heads a rank), trained on phase 13's microbatch against phase
    13's one-process runs ``ref`` (phase 13's gates), then serving a clip
    over the same mesh. ``beside``: phase 13's ranks' records. Returns the
    ranks' sampler launches by shape."""
    t = [time.perf_counter()]
    serve = p15_serve_reference(device)
    t.append(time.perf_counter())
    one_card = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    out = vrt_sp_ranks(ref, P15_AXES, one_card, False, card, serve=serve, beside=beside)
    t.append(time.perf_counter())
    log(f"  phase 15 took {t[2] - t[0]:.1f} s: this process's request {t[1] - t[0]:.1f}, the "
        f"ranks and their gates {t[2] - t[1]:.1f}")
    return out


def vrt_sp_cards(cards: int, card: str) -> dict:
    """``--dp-cards``: the split VRT step with one NCCL rank a card, ``data =
    2 x time = 2`` on four cards or more, ``time = 2`` on two or three,
    under phase 13's gates against card 0's one-process step. Returns that
    step's runs."""
    import torch

    axes = {"data": 2, "time": 2} if cards >= 4 else dict(VRT_SP_AXES)
    ref = vrt_sp_reference(torch.device("cuda", 0))
    vrt_sp_ranks(ref, axes, "cuda", True, card)
    return ref


def p15_cards(cards: int, card: str, ref=None) -> None:
    """``--dp-cards``: phase 15 with one NCCL rank a card, ``time = 2 x model
    = 2`` on four cards, under its gates against card 0's one-process runs
    (``ref``: phase 13's, computed here where not given)."""
    import torch

    if cards < 4:
        log(f"  phase 15 over the cards needs four, not {cards}: skipped")
        return
    device = torch.device("cuda", 0)
    ref = ref or vrt_sp_reference(device)
    vrt_sp_ranks(ref, P15_AXES, "cuda", True, card, serve=p15_serve_reference(device))


# phase 14: reference vsrlab checkpoints through the port's importers and acceptance command
IMPORT_FRAMES = 10
IMPORT_HR_ODD = (722, 1283)  # an HR-only clip: the command crops it and derives its LR
STREAM_WINDOW = 5  # --stream: two windows a clip, the state carried from one to the next
ACCEPT_BAR, ACCEPT_SSIM = 0.001, 1e-4  # the command against the same model evaluated directly
# port name -> the reference vsrlab's, applied in order (RealBasicVSR / BasicVSR / SpyNet)
RBVSR_REFERENCE_NAMES = (
    (r"\.head\.conv\.", ".conv.0."),
    (r"\.res_blocks\.", ".res_block."),
    (r"^basicvsr\.point_conv\.", "basicvsr.point_conv.0."),
    (r"^basicvsr\.upsample\.(\d+)\.conv\.", r"basicvsr.upsample.\1.upconv."),
    (r"^basicvsr\.conv_last\.", "basicvsr.conv_last.2."),
    (r"^basicvsr\.conv_hr\.", "basicvsr.conv_last.0."),
    (r"\.convs\.(\d)\.", lambda m: f".basic_module.{2 * int(m.group(1))}."),
)
# the paper VRT's (src/vsr/models/VRT/vrt.py: seven scale stages, trunk stage8)
VRT_REFERENCE_NAMES = (
    (r"^(stage\d)\.reshape_norm\.", r"\1.reshape.1."),
    (r"^(stage\d)\.reshape_linear\.", r"\1.reshape.2."),
    (r"\.block_(\d+)\.", r".blocks.\1."),
    (r"\.conv_offset_(\d)\.", lambda m: f".conv_offset.{2 * int(m.group(1))}."),
    (r"^trunk_norm_in\.", "stage8.0.1."),
    (r"^trunk_linear_in\.", "stage8.0.2."),
    (r"^trunk_rtmsa_(\d+)\.", lambda m: f"stage8.{int(m.group(1)) - 6}."),
    (r"^conv_before_upsample\.", "conv_before_upsample.0."),
    (r"^up_conv_(\d)\.", lambda m: f"upsample.{5 * int(m.group(1))}."),
    (r"^up_conv_out\.", "upsample.10."),
    (r"\.convs\.(\d)\.", lambda m: f".basic_module.{2 * int(m.group(1))}."),
)
# the reference's (1, 3, 3) Conv3d layers, stored (O, I, 1, 3, 3)
VRT_CONV3D = ("conv_first.weight", "conv_before_upsample.0.weight", "upsample.0.weight",
              "upsample.5.weight", "upsample.10.weight", "conv_last.weight")


def reference_names(state: dict, rules) -> dict:
    """``state`` with each name rewritten by ``rules`` (``(pattern,
    replacement)`` pairs, in order); the tensors on the CPU."""
    out = {}
    for name, t in state.items():
        for pattern, rep in rules:
            name = re.sub(pattern, rep, name)
        out[name] = t.detach().cpu().clone()
    return out


def spynet_buffers(prefix: str) -> dict:
    """The reference SpyNet's ``mean`` / ``std`` buffers, which its
    checkpoints carry and the port computes itself."""
    import torch

    from vsrlab_tpu_torch.models.spynet import IMAGENET_MEAN, IMAGENET_STD

    return {f"{prefix}mean": torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
            f"{prefix}std": torch.tensor(IMAGENET_STD).view(1, 3, 1, 1)}


def reference_realbasicvsr(model) -> dict:
    """A port RealBasicVSR's weights as the reference's ``model_state_dict``."""
    sd = reference_names(model.state_dict(), RBVSR_REFERENCE_NAMES)
    sd.update(spynet_buffers("basicvsr.spynet."))
    return sd


def reference_vrt(model) -> dict:
    """A port VRT's weights as the reference's state dict: Conv3d kernels,
    the deformable conv's OIHW weight, every attention's
    ``relative_position_index``, SpyNet's ``mean`` / ``std``."""
    sd = reference_names(model.state_dict(), VRT_REFERENCE_NAMES)
    for name in VRT_CONV3D:
        sd[name] = sd[name].unsqueeze(2)
    for name in [k for k in sd if k.endswith(".pa_deform.weight")]:
        sd[name] = sd[name].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    for name, m in model.named_modules():
        if hasattr(m, "rpi"):  # WindowAttention's index, kept by the reference as a buffer
            sd.update(reference_names({f"{name}.relative_position_index": m.rpi},
                                      VRT_REFERENCE_NAMES))
    sd.update(spynet_buffers("optical_flow."))
    return sd


def write_png_frames(folder: str, frames) -> None:
    """``(T, H, W, 3)`` in [0, 1] as 8-bit PNGs (OpenCV)."""
    import cv2
    import numpy as np

    os.makedirs(folder)
    for i, f in enumerate(frames):
        bgr = np.round(np.clip(f, 0, 1)[..., ::-1] * 255).astype(np.uint8)
        if not cv2.imwrite(os.path.join(folder, f"{i:03d}.png"), bgr):
            raise AssertionError(f"cannot write {folder}")


def run_acceptance(label, argv, device) -> tuple:
    """``acceptance.main(argv)`` in this process: ``(rc, its JSON line,
    wall seconds)``; its output is logged."""
    import io

    import torch

    from vsrlab_tpu_torch.evaluation import acceptance

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = acceptance.main(list(argv) + ["--device", device.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    line = out.getvalue().strip().splitlines()[-1]
    log(f"  acceptance {label}: rc {rc}, {line}")
    return rc, json.loads(line), wall


def gate_acceptance(label, rc, res) -> None:
    """Exit 0, and PSNR and SSIM within the bars of the direct evaluation's."""
    if (rc != 0 or res.get("pass") is not True or abs(res["delta_db"]) > ACCEPT_BAR
            or abs(res["delta_ssim"]) > ACCEPT_SSIM):
        raise AssertionError(f"{label}: rc {rc}, {res}")


def direct_metrics(model, clips, window, device, stream=False) -> tuple:
    """Mean PSNR and SSIM over ``clips`` (``(lr, hr)`` pairs) of ``model``
    evaluated without the acceptance command (``evaluate_video``; with
    ``stream`` a ``make_stream_forward`` chain of ``window``-frame
    windows), and the frames/s of its requests (host clock, frames loaded,
    metrics included)."""
    import numpy as np
    import torch

    from vsrlab_tpu_torch.core.metrics import psnr, ssim
    from vsrlab_tpu_torch.evaluation.harness import (
        evaluate_video, make_forward, make_stream_forward)

    forward = make_forward(model, device=device)
    first, rest = make_stream_forward(model, device)
    vals, frames = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lr, hr in clips:
        if stream:
            lr_d = torch.as_tensor(lr).to(device)
            srs, state = [], None
            for i in range(0, lr_d.shape[1], window):
                sr, state = (first(lr_d[:, i:i + window]) if state is None
                             else rest(lr_d[:, i:i + window], state))
                srs.append(sr)
            sr = torch.cat(srs, 1).float().clamp(0.0, 1.0)
            hr_d = torch.as_tensor(hr).to(device)
            vals.append((float(psnr(sr, hr_d)), float(ssim(sr, hr_d))))
        else:
            got = evaluate_video(forward, lr, hr, window, ("PSNR", "SSIM"))[1]
            vals.append((got["PSNR"], got["SSIM"]))
        frames += lr.shape[1]
    torch.cuda.synchronize()
    fps = frames / (time.perf_counter() - t0)
    return float(np.mean([v[0] for v in vals])), float(np.mean([v[1] for v in vals])), fps


def reference_checkpoint_phase(device, card) -> dict:
    """Phase 14. Returns the residual pair's launches by shape (bf16 and
    fp32) and the fused sampler's, over the phase's main path: the
    imported models' requests and the acceptance runs."""
    import collections
    import shutil

    import numpy as np
    import torch

    from vsrlab_tpu_torch.core.torch_import import (
        load_reference_checkpoint, load_torch_realbasicvsr, load_torch_vrt)
    from vsrlab_tpu_torch.data import SyntheticVSR
    from vsrlab_tpu_torch.evaluation.harness import (
        evaluate_video, get_video, make_forward)
    from vsrlab_tpu_torch.evaluation.tiled import _tile_starts
    from vsrlab_tpu_torch.models import VRT, RealBasicVSR
    from vsrlab_tpu_torch.nn.blocks import refresh_pair_caches
    from vsrlab_tpu_torch.ops import residual_pair as rp
    from vsrlab_tpu_torch.ops.resize import resize_bicubic

    t_start = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_import")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    bf16 = collections.Counter()
    fp32 = collections.Counter()
    samplers = collections.Counter()
    h, w = SERVE_LR

    log("  (a) the headline RealBasicVSR from a reference-layout checkpoint")
    model3 = build_model(torch.bfloat16)  # phase 3's seeded weights
    ckpt = os.path.join(root, "realbasicvsr_x4.pth")
    torch.save({"epoch": 0, "model_state_dict": reference_realbasicvsr(model3)}, ckpt)
    model = RealBasicVSR(**HEADLINE, dtype=torch.bfloat16)
    model.load_state_dict(load_torch_realbasicvsr(load_reference_checkpoint(ckpt)), strict=True)
    refresh_pair_caches(model)
    clip = torch.rand((1, 20, h, w, 3), generator=torch.Generator().manual_seed(1))[:, :10]
    want = make_forward(model3, device=device)(clip)
    rp.reset_launch_counts()
    got = make_forward(model, device=device)(clip)
    torch.cuda.synchronize()
    counts = pair_counts()
    gate_counts("imported RealBasicVSR, a 10-frame request", counts,
                {"taps": window_launches(1, h, w)})
    bf16 += counts["taps"]
    if not torch.equal(got, want):
        raise AssertionError("the imported RealBasicVSR differs from phase 3's model")
    log(f"  {os.path.getsize(ckpt) / 1e6:.1f} MB checkpoint ({{'epoch', 'model_state_dict'}}), "
        f"strict load; the request {tuple(got.shape)} bitwise equal to phase 3's model")
    del model, got, want

    stamps = [time.perf_counter()]
    log(f"  (b) the acceptance command on a REDS4-layout folder: two {IMPORT_FRAMES}-frame "
        f"clips, one paired ({4 * h}x{4 * w} HR with its LR), one HR-only at "
        f"{IMPORT_HR_ODD[0]}x{IMPORT_HR_ODD[1]}")
    data = os.path.join(root, "reds4")
    lr_a, hr_a = SyntheticVSR(num_videos=1, seq=IMPORT_FRAMES, height=4 * h, width=4 * w,
                              scale=4, seed=6)[0]
    hr_b = SyntheticVSR(num_videos=1, seq=IMPORT_FRAMES, height=IMPORT_HR_ODD[0],
                        width=IMPORT_HR_ODD[1], scale=4, seed=7)[0][1]
    write_png_frames(os.path.join(data, "clip_000", "hr"), hr_a)
    write_png_frames(os.path.join(data, "clip_000", "lr"), lr_a)
    write_png_frames(os.path.join(data, "clip_001", "hr"), hr_b)
    # the same clips as the command reads them, LR derived here for the HR-only one
    hr_a, lr_a = (get_video(os.path.join(data, "clip_000", d)) for d in ("hr", "lr"))
    hr_b = np.ascontiguousarray(get_video(os.path.join(data, "clip_001", "hr"))[:, :, :4 * h,
                                                                               :4 * w])
    lr_b = resize_bicubic(torch.from_numpy(hr_b[0]).to(device), (h, w))[None]
    clips = [(lr_a, hr_a), (lr_b, hr_b)]
    model32 = build_model(None)
    base = ["--model", "realbasicvsr", "--checkpoint", ckpt, "--data", data, "--bar",
            str(ACCEPT_BAR), "--mid-channels", str(HEADLINE["mid_channels"]), "--res-blocks",
            str(HEADLINE["res_blocks"]), "--cleaning-blocks", str(HEADLINE["cleaning_blocks"])]
    runs = (  # label, extra flags, the directly evaluated model, stream, window, launches
        ("fp32", [], model32, False, IMPORT_FRAMES, fp32,
         window_launches(1, h, w, 2)),
        ("bf16", ["--bf16"], model3, False, IMPORT_FRAMES, bf16,
         window_launches(1, h, w, 2)),
        ("bf16 streamed", ["--bf16", "--stream"], model3, True, STREAM_WINDOW, bf16,
         collections.Counter({(1, h, w, 64): 2 * 2 * 60 * STREAM_WINDOW,
                              (STREAM_WINDOW, h, w, 64): 2 * 2 * 60})),
    )
    fps = {}
    for label, flags, direct_model, stream, window, seen, want in runs:
        before = tf32(False)
        direct, direct_ssim, direct_fps = direct_metrics(direct_model, clips, window, device,
                                                         stream)
        tf32(before)
        rp.reset_launch_counts()
        rc, res, wall = run_acceptance(label, base + flags + [
            "--window", str(window), "--published-psnr", str(direct), "--published-ssim",
            str(direct_ssim)], device)
        counts = pair_counts()
        gate_counts(f"acceptance {label}", counts, {"taps": want})
        seen += counts["taps"]
        gate_acceptance(f"acceptance {label}", rc, res)
        fps[label] = {"acceptance": 2 * IMPORT_FRAMES / wall, "make_forward": direct_fps,
                      "psnr": res["psnr"], "delta_db": res["delta_db"]}
        log(f"  {label}: PSNR {res['psnr']:.4f} dB against {direct:.4f} evaluated directly "
            f"(delta {res['delta_db']:+.4f}, bar {ACCEPT_BAR}); {fps[label]['acceptance']:.2f} "
            f"frames/s for the whole command (checkpoint, PNG decoding, LR derivation "
            f"included) against {direct_fps:.2f} for make_forward's requests on {card}")
    del model3, model32
    torch.cuda.empty_cache()

    stamps.append(time.perf_counter())
    log("  (c) the paper VRT from a reference-layout checkpoint ({'params': ...})")
    model4 = build_vrt(torch.bfloat16, img_size=VRT_CLIP[1:4])  # phase 4's seeded weights
    vckpt = os.path.join(root, "vrt_x4.pth")
    torch.save({"params": reference_vrt(model4)}, vckpt)
    vrt = VRT(upscale=4, img_size=VRT_CLIP[1:4], dtype=torch.bfloat16)
    vrt.load_state_dict(load_torch_vrt(load_reference_checkpoint(vckpt), n_scale_stages=7),
                        strict=True)
    vclip = torch.rand(VRT_CLIP, generator=torch.Generator().manual_seed(2))
    want = make_forward(model4, device=device)(vclip)
    reset_vrt_counts()
    got = make_forward(vrt, device=device)(vclip)
    torch.cuda.synchronize()
    counts = vrt_counts()
    gate_counts("imported VRT, the 16x256x256 request (fused)", counts,
                {"bilinear_sample": expected_vrt_launches(VRT_CLIP, "bilinear_sample")})
    samplers += counts["bilinear_sample"]
    if not torch.equal(got, want):
        raise AssertionError("the imported VRT differs from phase 4's model")
    log(f"  {os.path.getsize(vckpt) / 1e6:.1f} MB checkpoint, n_scale_stages=7, strict load; "
        f"the request {tuple(got.shape)} bitwise equal to phase 4's model")
    del vrt, got, want, vclip
    torch.cuda.empty_cache()

    tile, t = SERVE_TILE, VRT_CLIP[1]
    vdata = os.path.join(root, "vrt_data")
    vlr, vhr = SyntheticVSR(num_videos=1, seq=t, height=4 * VRT_CLIP[2], width=4 * VRT_CLIP[3],
                            scale=4, seed=8)[0]
    write_png_frames(os.path.join(vdata, "clip_000", "hr"), vhr)
    write_png_frames(os.path.join(vdata, "clip_000", "lr"), vlr)
    vclips = [tuple(get_video(os.path.join(vdata, "clip_000", d)) for d in ("lr", "hr"))]
    forward = make_forward(model4, tile=tile, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = evaluate_video(forward, *vclips[0], t, ("PSNR", "SSIM"))[1]
    torch.cuda.synchronize()
    direct_fps = t / (time.perf_counter() - t0)
    direct, direct_ssim = direct["PSNR"], direct["SSIM"]
    reset_vrt_counts()
    rc, res, wall = run_acceptance(
        "vrt bf16 tiled",
        ["--model", "vrt", "--checkpoint", vckpt, "--data", vdata, "--bar", str(ACCEPT_BAR),
         "--bf16", "--tile", str(tile), "--window", str(t), "--align-chunks", "0",
         "--published-psnr", str(direct), "--published-ssim", str(direct_ssim)], device)
    counts = vrt_counts()
    n_tiles = (len(_tile_starts(VRT_CLIP[2], tile, tile - 16))
               * len(_tile_starts(VRT_CLIP[3], tile, tile - 16)))
    per_tile = expected_vrt_launches((1, t, tile, tile, 3), "bilinear_sample")
    gate_counts(f"acceptance vrt tiled ({n_tiles} tiles)", counts, {
        "bilinear_sample": collections.Counter({k: v * n_tiles for k, v in per_tile.items()})})
    samplers += counts["bilinear_sample"]
    gate_acceptance("acceptance vrt tiled", rc, res)
    fps["vrt bf16 tiled"] = {"acceptance": t / wall, "make_forward": direct_fps,
                             "psnr": res["psnr"], "delta_db": res["delta_db"]}
    log(f"  vrt bf16 tiled: PSNR {res['psnr']:.4f} dB against {direct:.4f} evaluated directly "
        f"(delta {res['delta_db']:+.4f}), {sum(per_tile.values())} fused launches a tile; "
        f"{t / wall:.3f} frames/s for the whole command against {direct_fps:.3f} for "
        f"make_forward's tiled request on {card}")
    del model4, forward
    torch.cuda.empty_cache()
    stamps.append(time.perf_counter())
    seconds = stamps[-1] - t_start
    log(f"  phase 14 took {seconds:.1f} s: (a) {stamps[0] - t_start:.1f}, (b) "
        f"{stamps[1] - stamps[0]:.1f}, (c) {stamps[2] - stamps[1]:.1f}")
    log(json.dumps({"phase14": {"card": card, "seconds": seconds, "fps": fps}}))
    return {"bf16": bf16, "fp32": fp32, "samplers": samplers}


def split_rounding_main() -> int:
    """``--split-rounding``: where a split step's bf16 gradient error comes
    from, in one process on card 0 with no exchange: the paper VRT's bf16
    gradients (fused sampler) on one ``+experiment=vrt`` microbatch, and
    the mean of the same route's gradients on each of its clips alone,
    each against the fp32 ones (TF32 off) over plain bf16's deviation from
    them; prints how many tensors lie beyond twice and the worst ratios."""
    import torch

    from vsrlab_tpu_torch.build import load
    from vsrlab_tpu_torch.core.config import load_config

    if not torch.cuda.is_available():
        print("chip_smoke --split-rounding: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(load, ("packed_gather", "bilinear_sample")))
    log(card_line())
    device = torch.device("cuda")
    cfg = load_config(overrides=list(VRT_TRAIN_OVERRIDES))
    check_paper_config(cfg.train)
    mb = vrt_microbatch(device)
    tf32(False)
    model32 = build_train_vrt(cfg, "fp32", device)
    ref = vrt_grads(model32, mb, "fused")[2]
    del model32
    torch.cuda.empty_cache()
    tf32(True)
    model = build_train_vrt(cfg, "bf16", device)
    plain = vrt_grads(model, mb, "plain")[2]
    whole = vrt_grads(model, mb, "fused")[2]
    parts = [vrt_grads(model, {k: v[i:i + 1] for k, v in mb.items()}, "fused")[2]
             for i in range(mb["lr"].shape[0])]
    split = {k: sum(p[k] for p in parts) / len(parts) for k in whole}
    for label, grads in (("the whole microbatch", whole),
                         (f"the mean of its {len(parts)} clips taken alone", split)):
        rows = []
        for k, w in ref.items():
            if not k.startswith("optical_flow."):
                a, b = dev(grads[k], w), dev(plain[k], w)
                rows.append((a[0] / b[0] if b[0] else 0.0, a[1] / b[1] if b[1] else 0.0, k))
        beyond = sum(r[0] > 2 or r[1] > 2 for r in rows)
        rows.sort(reverse=True)
        log(f"  one process, fused, {label}: {beyond} of {len(rows)} tensors beyond twice plain "
            "bf16's deviation from fp32; worst (max / rms) "
            + ", ".join(f"{k} {a:.2f} / {b:.2f}" for a, b, k in rows[:4]))
    return 0


def bvpp_launches(t: int, h: int, w: int, widths=BVPP, extract: int = 5,
                  reconstruct: int = 5) -> tuple:
    """One BasicVSR++ request's launches by shape of the pair kernel and of
    the sampler, for one clip of ``t >= 2`` frames of ``h x w``: the pair
    ``extract`` + ``reconstruct`` times at ``t`` frames and ``num_blocks``
    times a branch step at one; the sampler once for the state warp at each
    step after a branch's first, twice more from its third step (the
    composed flow's warp of the 2-channel flow, the warp of the state two
    back), and nine taps an alignment over the offset groups (SpyNet warps
    with the plain version)."""
    import collections

    c, groups = widths["mid_channels"], widths["deform_groups"]
    hw, branches = h * w, 4
    pairs = collections.Counter({(t, h, w, c): extract + reconstruct,
                                 (1, h, w, c): branches * t * widths["num_blocks"]})
    samples = collections.Counter({(1, h, w, c, hw): branches * (2 * t - 3),
                                   (1, h, w, 2, hw): branches * (t - 2),
                                   (groups, h, w, 2 * c // groups, hw): 9 * branches * (t - 1)})
    return pairs, samples


def bvpp_phase(device, card, frames: int = BVPP_FRAMES, widths=BVPP) -> tuple:
    """BasicVSR++ at the published widths (bf16, the offset heads drawn, so
    that the taps sample off the flow) served one whole ``frames``-frame
    180x320 clip through ``make_forward``: the request that captures the
    alignments' CUDA graphs and a replayed one, each with the kernels'
    counts zeroed just before and gated by shape against
    :func:`bvpp_launches` (a replay counts its graph's launch plan), then
    the eager route (no graphs) under the same gate; the graphed outputs
    must equal the eager one bit for bit and be finite. Logs frames/s of
    replayed requests (median of 3). Returns the pair's and the sampler's
    launches by shape over the three requests."""
    import collections

    import torch

    from vsrlab_tpu_torch.evaluation.harness import make_forward
    from vsrlab_tpu_torch.models import BasicVSRPlusPlus
    from vsrlab_tpu_torch.nn.blocks import init_weights
    from vsrlab_tpu_torch.ops import bilinear_sample as bs
    from vsrlab_tpu_torch.ops.residual_pair import reset_launch_counts
    from vsrlab_tpu_torch.utils.graphs import GraphedCall

    g = torch.Generator().manual_seed(0)
    model = BasicVSRPlusPlus(**widths, dtype=torch.bfloat16)
    model = seed_offset_heads(init_weights(model, g), g)
    h, w = SERVE_LR
    clip = torch.rand((1, frames, h, w, 3), generator=g)
    forward = make_forward(model, device=device)
    pairs, samples = bvpp_launches(frames, h, w, widths)
    total_pairs, total_samples = collections.Counter(), collections.Counter()

    def request(label):
        reset_launch_counts()
        bs.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gate_counts(f"BasicVSR++ {label} request", pair_counts(), {"taps": pairs})
        gate_samples(f"BasicVSR++ {label} request", samples)
        total_pairs.update(pairs)
        total_samples.update(samples)
        log(f"  BasicVSR++ {label} request: {wall * 1e3:.1f} ms")
        return out

    graphed = [request("capturing"), request("replayed")]
    on_card = torch.device(device).type == "cuda"  # a CPU rehearsal runs eagerly throughout
    if on_card and [len(m._graphed) for m in model.deform_align.values()] != [1] * 4:
        raise AssertionError("BasicVSR++: not one graph an alignment")
    call = GraphedCall.__call__
    GraphedCall.__call__ = lambda self, *args, extra=None: self.fn(*args)
    try:
        eager = request("eager")
    finally:
        GraphedCall.__call__ = call
    same = [torch.equal(out, eager) for out in graphed]
    finite = bool(torch.isfinite(eager).all())
    log(f"  BasicVSR++ graphed outputs bitwise the eager one: {same}; finite: {finite}")
    if not all(same) or not finite:
        raise AssertionError("BasicVSR++: the graphed request differs from the eager one")
    del graphed, eager
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(clip)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"  BasicVSR++ {frames} frames {h}x{w} -> {4 * h}x{4 * w}, bf16: "
        f"{frames / statistics.median(walls):.2f} frames/s (median of 3 requests, upload in, "
        f"no copy back; {card})")
    return total_pairs, total_samples


def bvpp_main() -> int:
    """``--bvpp``: the kernels' build, the sampler's checks (phase 2's, with
    BasicVSR++'s shapes), the BasicVSR++ request (:func:`bvpp_phase`) and
    the sampler's times at its shapes."""
    import torch

    from vsrlab_tpu_torch.build import load

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)
    for name in ("residual_pair", "bilinear_sample"):
        log(f"  {name} built in {load(name).build_seconds:.1f} s")
    log(json.dumps({"bilinear_sample_checks": check_sampler_kernel(device)}))
    _, samples = bvpp_phase(device, card)
    torch.cuda.empty_cache()
    flows = {s: n for s, n in samples.items() if s[0] == 1 and s[3] == 2}
    rows = time_sampler({s: n for s, n in samples.items() if s not in flows}, device)[1]
    rows += time_sampler(flows, device, torch.float32)[1]
    log(json.dumps({"bvpp_sampler_rows": rows}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from vsrlab_tpu_torch.build import load

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    started = time.perf_counter()

    def phase(msg: str) -> None:  # a phase's header, with the seconds since the start
        log(f"{msg} [{time.perf_counter() - started:.1f} s]")

    phase("phase 1: device and build")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(card)
    for module in ("cv2", "PIL"):  # image codecs: the port's file I/O needs cv2
        try:
            found = __import__(module).__version__
        except ImportError as e:
            found = f"not importable ({e})"
        log(f"  {module}: {found}")
    # one nvcc for each source, started together
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(load, ("residual_pair", "packed_gather", "bilinear_sample",
                                    "window_attention")))
    for lib in libs:
        log(f"  kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    phase("phase 2: kernels against their plain version")
    errs = check_kernels(device)
    vrt_errs = {"bilinear_sample": check_sampler_kernel(device),
                "packed_row_gather": check_gather_kernel(device),
                "window_attention": check_attention_kernel(device)}

    phase("phase 3: RealBasicVSR path (4x, mid 64, 30+20 blocks, bf16; one fp32 request)")
    pair_launches, fp32_launches = realbasicvsr_phase(device, card)
    torch.cuda.empty_cache()

    phase("phase 4: VRT path (4x, paper configuration, 16x256x256 request, bf16)")
    vrt_launches = vrt_phase(device, card)
    torch.cuda.empty_cache()
    tiny_vrt_phase(device, card)
    torch.cuda.empty_cache()

    phase("phase 5: RealBasicVSR training (batch 4 x 6 frames, 64x64 -> 256x256, bf16)")
    for form, by_shape in training_phase(device, card).items():
        pair_launches[form] += by_shape
    torch.cuda.empty_cache()

    phase("phase 7: serving from a checkpoint (headline RealBasicVSR, paper-configuration VRT)")
    serve_pairs, serve_samplers, serve_attention = serving_phase(device, card)
    for form, by_shape in serve_pairs.items():
        pair_launches[form] += by_shape
    vrt_launches["bilinear_sample"] += serve_samplers
    vrt_launches["window_attention"] += serve_attention
    torch.cuda.empty_cache()

    phase("phase 8: GAN fine-tuning (headline G, UNet D mid 64, VGG19, batch 4 x 6 frames, "
          "64x64 -> 256x256, bf16)")
    for form, by_shape in gan_phase(device, card).items():
        pair_launches[form] += by_shape
    torch.cuda.empty_cache()

    phase("phase 9: the flow paths (RAFT teacher, OpticalFlowConsistency, the SpyNet curriculum, "
          "IRR-PWC; fp32)")
    fp32_samplers, flow_pairs = flow_phase(device, card)
    fp32_pairs = {form: flow_pairs[form] + fp32_launches[form] for form in KERNELS}
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 10: VRT training at +experiment=vrt's shape (paper configuration, batch 8 x 6 "
          "frames, 64x64 -> 256x256, 4 microbatches, remat, bf16) and data parallelism")
    vrt_train_calls, backward, dp_pairs = phase10(device, card)
    for impl, by_kernel in vrt_train_calls.items():
        for name, by_shape in by_kernel.items():
            vrt_launches[name] += by_shape
    for form, by_shape in dp_pairs.items():  # the ranks' fp32 steps
        fp32_pairs[form] += by_shape
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 11: the time and model mesh axes (two gloo ranks on the card) and the host data "
          "core")
    p11 = phase11(device, card)
    pair_launches["taps"] += p11["taps"]
    for name, by_shape in p11["samplers"].items():
        vrt_launches[name] += by_shape
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 12: sequence-parallel training over the time axis (the headline RealBasicVSR, the "
          "train leg's 4 x 6 frames split 3 a rank over two gloo ranks on the card)")
    p12 = phase12(device, card)
    pair_launches["taps"] += p12["bf16"]
    fp32_pairs["taps"] += p12["fp32"]
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 13: sequence-parallel VRT training over the time axis (the paper VRT, one "
          "microbatch of +experiment=vrt, 2 clips x 6 frames split 3 a rank over two gloo ranks on "
          "the card, remat)")
    p13 = phase13(device, card)
    for name, by_shape in p13["bf16"].items():
        vrt_launches[name] += by_shape
    fp32_samplers += p13["fp32"]
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 15: the paper VRT over time and model at once (one microbatch of "
          "+experiment=vrt, 3 frames of each clip and 3 of the 6 heads a rank, four gloo ranks "
          "on the card, remat; a clip served over the same mesh)")
    p15 = phase15(device, card, p13["ref"], p13["records"])
    for name, by_shape in p15["bf16"].items():
        vrt_launches[name] += by_shape
    fp32_samplers += p15["fp32"]
    del p13, p15
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 14: reference checkpoints (the headline RealBasicVSR and the paper VRT imported "
          "from reference-layout checkpoints, the acceptance command)")
    p14 = reference_checkpoint_phase(device, card)
    pair_launches["taps"] += p14["bf16"]
    fp32_pairs["taps"] += p14["fp32"]
    vrt_launches["bilinear_sample"] += p14["samplers"]
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    phase("phase 16: BasicVSR++ (mmagic's c64n7 widths, a whole 100-frame 180x320 clip, bf16; "
          "the alignments as CUDA graphs and eager)")
    bvpp_pairs, bvpp_samples = bvpp_phase(device, card)
    pair_launches["taps"] += bvpp_pairs
    for shape, n in bvpp_samples.items():  # the flows' warps are fp32, the features' bf16
        flow = shape[0] == 1 and shape[3] == 2
        (fp32_samplers if flow else vrt_launches["bilinear_sample"])[shape] += n
    torch.cuda.empty_cache()

    phase("phase 6: each kernel at its paths' shapes")
    kernels = []
    for form, (name, replaces) in KERNELS.items():
        err, rows = time_kernel(form, pair_launches[form], device)
        if fp32_pairs[form]:  # the fp32 request and the flow trainer's cleaner: the fp32 kernel
            rows += time_kernel(form, fp32_pairs[form], device, torch.float32)[1]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                        **kernel_summary(rows, err, errs[form])})
    timers = {"bilinear_sample": time_sampler, "packed_row_gather": time_gather,
              "window_attention": time_attention}
    for name, (source, replaces, also) in VRT_KERNELS.items():
        err, rows = timers[name](vrt_launches[name], device)
        if name == "bilinear_sample":  # the flow paths' and phase 13's fp32 launches
            rows += time_sampler(fp32_samplers, device, torch.float32)[1]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "also_replaces": also, **kernel_summary(rows, err, vrt_errs[name])})
        if name in SAMPLERS:  # phase 10 (b): the PyTorch backward at the training shapes
            kernels[-1]["backward"] = backward["rows"][name]
        else:  # the attention's check reads a share of its gate (attention_gate), no error
            kernels[-1]["gate_share"] = kernels[-1].pop("max_abs_err")
            kernels[-1]["gate_share_fp32"] = kernels[-1].pop("max_abs_err_fp32")
    pair_host_split(device)
    train_host_split(device)
    phase("the kernels line")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    tree = sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(__file__)
    if sys.argv[1:2] == ["--pair-times"]:
        sys.exit(pair_times(tree))
    if sys.argv[1:2] == ["--sampler-times"]:
        sys.exit(sampler_times(tree))
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 10 (c), started by the script
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--p11-rank"]:  # one rank of phase 11 (a), (b), started by the script
        sys.exit(p11_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--vrt-dp-rank"]:  # one rank of --dp-cards' VRT step
        sys.exit(vrt_dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sp-rank"]:  # one rank of phase 12, started by the script
        sys.exit(sp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--vrt-sp-rank"]:  # one rank of phase 13, started by the script
        sys.exit(vrt_sp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--split-rounding"]:
        sys.exit(split_rounding_main())
    if sys.argv[1:2] == ["--dp-cards"]:
        sys.exit(dp_cards_main())
    if sys.argv[1:2] == ["--bvpp"]:
        sys.exit(bvpp_main())
    sys.exit(main())
