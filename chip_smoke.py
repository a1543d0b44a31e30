#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``si_mamba_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It needs ``nvcc`` (the CUDA toolkit) and builds the kernels from
``si_mamba_tpu_torch/csrc`` into ``build/``. Phases, each fatal on failure:

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: the nine CUDA sources (K1-K11 each with its fp32 and bf16
   variants, csrc/mamba_any.cu: K1-K5 and K10/K11 at the shapes the tuned
   kernels are not built for, and csrc/ssd_xbc_bf16_sm90.cu: the bf16 K8/K9
   at the bf16 SSD presets' shapes), one ``nvcc`` each, in parallel, before
   any rank of phases 11-14 starts;
3. kernels: at the serving path's full-width shapes (B=32, L=512, d_inner=768,
   d_state=16, fp32, strided views as the mixer makes them) each kernel is
   held against its plain PyTorch version on the card and timed beside it:
   the conv forward and, for a seeded output gradient, its backward (both
   also beside ``F.conv1d(groups=D)`` + ``F.silu`` and its autograd
   backward and as CUDA-graph device time, with their plans; the backward run
   twice, bitwise equal; the forward also at B = 1, 20 and 64 at the Mamba-1
   and SSD views), the lean scan forward (also at B = 1, 20 and 64,
   the serving request sizes; each timed as back-to-back calls and as
   CUDA-graph device time), the scan forward that keeps its tile entry states (its y equal to
   the lean kernel's, its states to the plain version's) and the scan
   backward (every gradient against the plain backward, two runs bitwise
   equal);
4. SSD kernels: at the SSD mixer's shapes (B=32, L=512, chunk 256, 6 heads,
   n = p = 128, fp32): the conv forward and backward at width 1024 on the
   column view of the (32, 512, 1798) ``in_proj`` output (row stride 1798),
   then the SSD core's lean forward (also at B = 1, 20 and 64, the serving
   request sizes), its forward with states (y equal, states against the
   plain version) and its backward for a seeded output gradient (two runs
   bitwise equal), each within 1e-4 of its plain version's max and timed
   beside it as back-to-back calls and as CUDA-graph device time; their
   ``bound_ms`` at the rate their 3xTF32 tensor-core products can use (three
   TF32 products for each against the dense TF32 peak), and in the log
   beside it the bound at the fp32 rate of the CUDA cores; then the conv
   forward and backward, held and timed the same way, at the tensor-parallel
   SSD step's two contiguous conv operands on each rank (the 384-wide x shard
   and the 256-wide B|C at B=32, L=512), whose backward runs other time tiles;
4b. fused-mixer kernels: at the serving path's shapes, with xz as layer 0's
   ``in_proj`` makes it, the whole-mixer forward lean and with its chunk
   entry states (y equal, states against the plain version; the lean one
   also at B = 1, 20 and 64, as back-to-back calls and as CUDA-graph device
   time) and its
   backward for a seeded output gradient (every gradient against the plain
   backward, two runs bitwise equal), each timed beside its plain version;
   then the same interior through the per-op route (K1, the x_proj and
   dt_proj GEMMs, K2; with a gradient K1/K3 forward and K4/K5 + the GEMMs'
   autograd backward) and through ``fused_mamba_mixer``, each timed without
   a gradient, as a training forward and as the backward alone;
4c. split SSD kernels: at the tensor-parallel shard's shapes (B=32, L=512,
   chunk 256, 3 heads of 128, d_state 128; x the x conv's output, B and C the
   halves of the B|C conv's output, row stride 256, as ``ssd_mixer_tp``
   makes them) the split forward lean, with states, with the final state and
   with both (the same y from each) and the backward from 0 and seeded with a
   final-state cotangent (two runs bitwise equal), each within 1e-4 of its
   plain version's max and timed beside it as back-to-back calls and as
   CUDA-graph device time, with ``bound_ms`` at the 3xTF32 rate as in phase
   4; every variant held again at chunk 128 (4 chunks); then the lean
   forward and the backward at 6 heads on the full mixer's column groups,
   beside K8/K9 on the same block;
5. serving: a ``Predictor`` over the ModelNet40 ``PointMamba`` (12 x 384,
   L=512, seeded random weights) answers requests of 1, 20 and 64 clouds of
   1024 points; every forward must launch the conv and lean scan kernels 12
   times each and no other kernel, and its logits must match a second model
   with the plain scan (``scan_impl='seq'``) on the same card; the requests'
   peak memory is recorded;
6. profile: for each request size, the median over 10 forwards of the
   model's three pieces (``embed``: FPS, kNN, patch encoder, pos-embed;
   ``sequence``: graph, ``eigh``, SAST ordering; ``classify``: the Mamba stack
   and the head), each ended by ``torch.cuda.synchronize()`` and so including
   its launch cost; then one forward under ``torch.profiler``: device time by
   kernel name (top 8), the summed kernel and copy time, and its share of the
   forward's wall time (the device's busy share);
7. train: ``make_train_step`` over the same model at its training settings
   (drop_path 0.3, head dropout 0.5), AdamW at the timm stepped cosine
   (lr 3e-4, wd 0.05, 300 epochs with 10 of warm-up, clip 10, 2 steps an
   epoch), TRAIN_STEPS steps at batch 32 on 8192-point clouds (FPS to 1200,
   1024 kept, scale + translate). Every step must launch the conv forward and
   backward and the training scan forward and backward 12 times each and no
   other kernel, give a finite loss, and move every mixer parameter and the
   BatchNorm statistics; then an eval forward must take the lean scan again.
   p50 step time, clouds/s and peak memory are printed, then one more step
   timed as the two halves that the step composes (the input pipeline;
   forward, backward and optimizer) and one under ``torch.profiler``, which
   also gives the device time of building the in_proj output's gradient from
   its column views' gradients (autograd's slice backward and the adds)
   beside the conv backward's own;
8. gradients: one train-mode step's loss and every parameter gradient of the
   kernel path against the plain path (``scan_impl='seq'``), same weights and
   clouds, drop rates 0, at B=4, within 1e-3 of the largest gradient;
9. the SSD classifier (``mixer='ssd'``, ``scan_impl='ssd_fused'``, chunk 256:
   the ModelNet40 model with the SSD lines of
   cfgs/finetune_modelnet_ssd_fused.yaml, fp32, exact ``eigh``) through
   phases 5-8: each serving forward must launch the conv and the lean SSD
   forward 12 times each and nothing else, its logits match
   ``scan_impl='xla'``; each train step launch the conv forward and backward,
   the SSD forward with states and the SSD backward 12 times each and nothing
   else; the B=4 gradients match ``scan_impl='xla'``;
10. the whole-mixer route (the Mamba-1 model with ``scan_impl='fused'``)
   through phases 5-8: each serving forward must launch the lean fused
   forward 12 times and nothing else (neither the conv nor the scan), its
   logits match ``scan_impl='seq'``; each train step launch the fused forward
   with states and the fused backward 12 times each and nothing else, and an
   eval forward after them the lean one; the B=4 gradients match 'seq'.
11-14. the parallel paths, on 2 ranks: processes spawned on the one card with
   a ``gloo`` group (NCCL refuses two ranks on one device) over a file
   rendezvous in ``build/``. 11: the SSD classifier with its mixers over a
   2-rank model axis (3 heads a rank, weights cut from the single-process
   model's by ``shard_state_dict``) serves requests of 1, 20 and 64 clouds;
   each forward must launch the conv 24 times and the lean split forward 12
   times, nothing else (no K8), its logits match the single-process 'xla'
   model. 12: TRAIN_STEPS TP train steps at batch 32 from 8192-point clouds,
   each launching the conv forward and backward 24 times and the split
   forward with states and the split backward 12 times, nothing else, the
   same finite losses on both ranks, every parameter and statistic moved;
   then at B=4, drop rates 0, a global-norm clip at half the norm: the
   gradients gathered over the ranks match the single-process 'xla' model's.
   13: ``ssd_seq_parallel(impl='ssd_fused')`` over a 2-rank seq axis (B=32,
   L=512, 6 heads, chunk 128): the split forward with the final state once a
   rank without a gradient, with one the forward with states and final state
   and the seeded backward; y and every gradient against the single-process
   plain ``ssd_chunked``. 14: one forward of the Mamba-1 model with its
   mixers over the model axis (``scan_impl='pallas'``): the conv and the lean
   scan 12 times a rank, logits matching 'seq'. A rank that fails fails the
   script.
15. the finetune harness (before phases 11-14, in this process): the port's
   CLI (``si_mamba_tpu_torch.train.cli.main``) on a ModelNet40-format tree
   written under build/harness/ from a seed (64 train clouds, 40 test
   clouds, 8192 points with normals) with cfgs/finetune_modelnet.yaml at
   max_epoch 1: the FPS caches built on the card, then the finetune (epochs 0
   and 1 of two steps at batch 32, a validation after each; every step must
   launch the conv forward and backward and the training scan forward and
   backward 12 times each and nothing else, every eval forward the conv and
   the lean scan 12 times each; losses finite; ckpt-best.pth, ckpt-last.pth,
   config.yaml and scalars.jsonl written, the snapshot reading back to the
   config), ``--test`` of ckpt-last.pth (the last validation's accuracy and
   logits), ``--resume`` of the finished run (epoch 1 restored, no kernel
   launched) and one ``validate_vote`` of 10 passes (the eval kernels 12 x 10
   times a batch).
16. perf mode's kernels (before phase 5): the bf16 variants of K1-K5 at the
   serving path's shapes (B=32, L=512, d_inner 768; bf16 views of a bf16
   ``in_proj`` output, row stride 1536), each held against its plain version
   on the card (a bf16 output within one bf16 ulp of it, two for the scan
   backward's; fp32 outputs within 1e-4 of their max, 1e-3 for the scan
   backward's sums) and timed beside it, the conv ones also beside bf16
   ``F.conv1d(groups=D)`` + ``F.silu`` and its autograd, the conv forward and
   the lean scan also at B = 1, 20 and 64; each record carries the fp32
   kernel's time of this run;
17. perf serving and train (after phase 8): ``Predictor.from_checkpoint(
   state dict, perf=True)`` (bf16, subspace) over the ModelNet40 model serves
   1, 20 and 64 clouds; every forward launches the bf16 conv and lean scan 12
   times each and nothing else, its logits and features match 'seq' at bf16
   within PERF_LOGITS_TOL of their max; its pieces profiled as in phase 6
   (the ``sequence`` piece is the subspace solver's, phase 6's eigh's); then
   phase 7 at bf16 + subspace: every step launches the bf16 conv forward and
   backward and the bf16 training scan forward and backward 12 times each;
18. the perf preset through the CLI (after phase 15, on its tree):
   cfgs/finetune_modelnet_perf.yaml at max_epoch 0, two steps and a
   validation, launches counted, the epoch's loss finite.
19. the SSD presets' kernels (after phase 16): the bf16 K1 and K5 at the SSD
   view (row stride 1798: rows 4-byte aligned, two channels a thread for
   K1) and at the tensor-parallel operands (384 and 256 wide), then the bf16
   K8 (lean, also at B = 1, 20 and 64, and with states) and K9 on the Hopper
   bf16 body (csrc/ssd_xbc_bf16_sm90.cu, '_sm90' in their record names and
   launch counts; K9's ddt scaled by 1.05 must fail its hold), also at chunk
   64, the smallest it serves (``at_chunk64``), and at the
   tensor-parallel shard and at phase 22's shapes (a rank's 256 rows, 6
   heads, chunk 128) the bf16 K6 (lean, with states, with h_fin, with
   both; the same y from each) and K7 (from 0, seeded), each backward twice,
   bitwise equal; each against its plain version at bf16 (a bf16 output
   within 2 bf16 ulps at a floor of 2e-2 of its max, an fp32 output within
   1e-3 of its max), timed beside it with the fp32 kernel's time of this
   run, ``bound_ms`` from its bf16 bytes and its bf16 products at the dense
   bf16 peak plus its 3xTF32 ones;
20. SSD perf serving and train (after phase 9): the SSD classifier at the
   presets' settings (bf16, subspace; ``Predictor.from_checkpoint(perf=True)``)
   through phases 5-7: every forward launches the bf16 conv and lean bf16 K8
   12 times each and nothing else, logits and features within
   PERF_LOGITS_TOL of 'xla' at bf16; every step the bf16 conv forward and
   backward, K8 with states and K9 12 times each (K8 and K9 on the Hopper
   bf16 body, its '_sm90' counts); then (after phase 18)
   cfgs/finetune_modelnet_ssd_fused.yaml as the file stands through the CLI
   (one epoch of two steps and a validation) and ``--test`` of its
   ckpt-last.pth, launches counted, its accuracy the last validation's;
21. (on the two ranks, after phase 14) the SSD presets' classifier with its
   mixers over the model axis: one forward of 20 clouds (the bf16 conv 24
   and the lean bf16 K6 12 times a rank, logits against the single-process
   bf16 'xla' model), then two train steps at batch 32 (the bf16 conv forward
   and backward 24, the bf16 K6 with states and K7 12 times a rank), losses
   equal on both ranks;
22. (on the two ranks) ``ssd_seq_parallel`` at bf16 at phase 13's shapes: the
   bf16 K6 with h_fin once a rank without a gradient, with one the bf16 K6
   with states and h_fin and the seeded bf16 K7; y and every gradient
   against the same program on CPU copies of the inputs (the kernels' plain
   versions), then, for the carry across ranks, against the single-process
   bf16 split core on the card.
23. the bf16 whole-mixer kernels (after phase 4b): the bf16 K10 (lean, with
   states) and K11 at the fused perf path's shapes (B=32, L=512, d_inner
   768, dt_rank 24; xz as layer 0's bf16 in_proj makes it, the weights fp32),
   each against its plain version at bf16 (y and dxz within one bf16 ulp at
   a floor of 2e-2 of the max; h_entries and the fp32 weight gradients
   within 1e-4 of their max; K11 twice, bitwise equal) and timed beside it,
   also as CUDA-graph device time, the lean one also at 1, 20 and 64
   clouds; each record carries the fp32 kernel's times of this run;
24. K8/K9's carry entry points (after phase 23): K8 with h_fin (lean, with
   states) and the seeded K9 at the SSD shape (width 1024, 6 heads of 128,
   chunk 256, B=32, L=512), fp32 and bf16 (the bf16 ones on the Hopper bf16
   body, '_sm90'), each against its plain version
   (fp32: y, h_in, h_fin within 1e-5 of their max, gradients within 4.5e-6;
   bf16: 2 ulps at a floor of 2e-2, fp32 outputs within 1e-3) and timed
   beside it; then the path that reaches them,
   ``ssd_chunked_xbc(return_carry=True)``, at each dtype without and with a
   gradient: each carry kernel launched once, nothing else, y and h_fin the
   kernels', the total decay exp(sum of each chunk's last S);
25. fused perf serving and train (after phase 10): the whole-mixer model in
   perf mode (``Predictor.from_checkpoint(state dict, perf=True)``: bf16,
   subspace) through phases 5-7: every forward launches the lean bf16 K10 12
   times and nothing else, logits and features within PERF_LOGITS_TOL of
   'seq' at bf16; every step the bf16 K10 with states and K11 12 times each;
26. (on the two ranks, after phase 22) perf mode's Mamba-1 classifier with
   its mixers over the model axis: the tensor-parallel mixer promotes its
   bf16 input to fp32 at the fp32 weights, as the JAX package's does, so one
   forward of 20 clouds launches the fp32 conv and lean scan 12 times a
   rank (logits within PERF_LOGITS_TOL of the single-process bf16 'seq'
   model), and two train steps the fp32 conv and scan forward and backward
   12 times a rank, losses equal on both ranks;
27. the fused perf configuration through the CLI (after phase 20):
   cfgs/finetune_modelnet_perf.yaml with ``model.scan_impl: fused``, written
   on the harness tree, one epoch of two steps and a validation, then
   ``--test`` of its ckpt-last.pth, launches counted.
28. the kernels at the part-segmentation shapes (after phase 4): K1 and K5 on
   the Mamba-1 view and the SSD view, K2, K3, K4, K8 (both variants) and K9
   at B=16, L=256 (the HLT canvas of 128 groups), chunk 128 (two chunks),
   each held against its plain version at the tolerances above and timed
   beside it; the figures go into each record's ``at_seg_shape``;
29. part segmentation (after phase 27): one request of 20 clouds through a
   ``Predictor`` over the ModelNet40 classifier with the HLT ordering (the
   conv and the lean scan 12 times each, logits against 'seq'); the
   full-width seg eval forward of cfgs/part_segmentation.yaml (against
   'seq') and of cfgs/part_segmentation_ssd_fused.yaml (against 'xla') on 16
   clouds of 2048 points, both drawing the JAX evaluation's HLT tie-break,
   log-probs within 1e-3 of their max and 2e-3 relative; the SSD preset's
   block stack cut to 4 blocks (at 12 its gradient norm is inf from a
   random start) in training at the same shapes, kernels against 'xla' on
   the inputs and tap cotangent of one 'xla' train pass of the whole model,
   every stack gradient within 1e-3 of its leaf's largest, K1, K8 with
   states, K9 and K5 once a block; then both presets through
   the CLI at max_epoch 1 on a seeded tree in ShapeNetPart's layout written
   under build/seg/ (48 trainval, 32 test shapes): three steps at batch 16,
   each launching K1, K3, K4 and K5 (the SSD preset: K1, K8 with states, K9
   and K5) 12 times each and nothing else, every evaluation forward K1 and
   K2 (K1 and the lean K8) 12 times each, finite losses, the BatchNorm
   statistics and every decayed parameter moved, every parameter finite (the
   unmoved and the steps' gradient norms recorded), instance and class mIoU
   and accuracy in [0, 1], ckpt-last.pth and ckpt-best.pth written; the step
   p50, the evaluation's ms a batch and the peak memory printed.
30. the kernels at the pretraining and hardest-scan shapes (after phase 28): the fp32 K1,
   K5, K3, K4 at B=128 with L=208 (the encoder's 2 K n_vis tokens) and L=512 (the
   decoder's), K1 and K2 at the probe's B=64, L=512; the bf16 K1, K5, K8 with states and K9
   at B=128 with L=208 (K8/K9 on it padded to 256, two chunks of 128) and 512, the bf16 K1
   and lean K8 at B=64, L=512; the fp32 K1-K5 at B=32, L=1024 and K8 (both variants), K9 at
   chunk 256, nc 4; each held against its plain version (the bf16 K8 y and K9 dxbc against
   the fp64 truth, no further from it than the plain version) and timed beside it, into
   each record's ``at_pretrain_and_scan_shapes``;
31. (after phase 29) the held MAE forward: cfgs/pretrain.yaml's model at full width,
   seeded weights, 16 clouds: the eval loss with one mask and order override against
   'seq' (rtol 2e-3), the noaug features (1e-3 of max, 2e-3 relative), K1 and K2 16 and
   12 times; the orders computed on the card against the CPU's (recorded); then the
   encoder stack (12 blocks) in training at B=16, L=208 on one cotangent against 'seq',
   every gradient within 1e-4 of its leaf's largest;
32. the SVM probe's solver (``train/svm.py``) at the published probe size and class mix
   (ModelNet40's per-class train and test counts: 9843 x 768 features, 2468 test, 40
   classes; seeded class blobs), its seconds and peak allocation, and at a small size
   against the same solver on the CPU (decision values within 1e-6, predictions equal);
33. both pretraining presets (cfgs/pretrain.yaml; cfgs/pretrain_ssd_fused.yaml, bf16 +
   Jacobi) through the CLI at max_epoch 1 under build/mae/ (272 seeded ShapeNet-55 shapes
   of 8192 points, the committed ModelNet40 h5 fixtures for the probe): four steps at
   batch 128, each launching K1, K3, K4 and K5 (the bf16 K1, K8 with states, K9, K5) 16
   times and nothing else, every probe feature forward K1 and K2 (bf16 K1, lean K8) 12
   times; finite losses; the BatchNorm statistics, ``diff_sgwt.*``, ``mask_token`` and
   every decayed parameter moved; the probe accuracy in [0, 100]; ckpt-last.pth and
   ckpt-best.pth written; the step p50, clouds/s, peak, the probe's feature and solve
   seconds, and a step timed by piece (orders: grouping, graph, bases, SGWT, Sinkhorn,
   rounding; encoder; decoder with the loss; update) printed;
34. cfgs/finetune_scan_hardest.yaml through the CLI at max_epoch 1 on the committed
   ScanObjectNN-hardest fixtures, finetuned from phase 33's ckpt-last.pth through
   --finetune_model (only the head's keys missing): two steps launching K1, K3, K4, K5
   12 times each at L = 1024, every validation forward K1 and K2; then a held classifier
   forward at L = 1024 against 'seq';
35. data parallelism (after phase 14's ranks): two ranks spawned on the card, the
   default group initialised from torchrun's variables by the CLI's own
   ``maybe_initialize_distributed`` (gloo: the ranks share the card), a ('data',) mesh:
   three steps of the shipped finetune step (drop_path 0.3) of the ModelNet40 model at
   full width, each rank on its 16 rows of a global batch of 32 from 8192-point clouds,
   against the one-process step at B=32 on the same card and seed (run first by the
   parent): each rank's prepared clouds bitwise its rows of the one-process batch, the
   generator's state bitwise the same after every step, the losses within rtol 2e-4, and
   after step 3 every parameter within rtol 1e-4 / atol 2.5 x the summed learning rate and
   every BatchNorm statistic within rtol 1e-3 / atol 1e-4 (tests/test_torch_port_train.py's
   schedule and tolerances); the ranks' parameters and statistics bitwise equal after
   every step (``runner_finetune.check_replicas``); K1, K3, K4 and K5 12 times each a rank a
   step and nothing else; the step p50 and peak a rank and the gradient all-reduce alone
   (one fp32 buffer of every parameter's size, as the optimizer reduces the gradients)
   timed;
36. on each rank its eval forward at B=16 against 'seq' on the same rank (logits within
   atol 1e-3 max, rtol 2e-3), K1 and K2 12 times each;
37. the finetune CLI over the two ranks on a seeded ModelNet40 tree under build/dp/
   (cfgs/finetune_modelnet.yaml at max_epoch 1, global batch 32: two epochs of two steps,
   each K1, K3, K4, K5 12 times a rank): the ranks' losses, validations, ``--test`` of
   ckpt-last.pth (equal to the last validation), ``--resume`` with max_epoch raised to 2
   (one more epoch, from the saved generator) and a 2-pass vote over the ranks' shards, all
   equal on both ranks; rank 0 alone writes the checkpoints and the log;
38. DP x TP: four ranks, the same CLI over a (data 2, model 2) mesh with ``tp_size: 2`` and
   ``model.tp_axis: model`` (the Mamba-1 tensor-parallel mixer), one epoch of two steps: the
   losses equal on every rank, each step K1, K3, K4, K5 12 times a rank; the gathered
   ckpt-last.pth loads strict into a one-process model;
39. cfgs/part_segmentation.yaml (global batch 16: one epoch of three steps) and
   cfgs/pretrain.yaml (global batch 128: two epochs of two steps, then the SVM probe on
   every rank's features) through the CLI over the two ranks at full width, on phases 29's
   and 33's trees: each step the Mamba-1 kernels once a block; the mIoU and the probe's
   accuracy equal on both ranks;
40. the pipeline: the ModelNet40 classifier's 12 blocks over 2 stages of 6 on a 'pipe' axis
   of the two ranks, 4 microbatches of 8 clouds: the logits against the one-process model
   (atol 1e-3 max, rtol 2e-3), K1 and K2 6 x 5 ticks times a rank; one backward of the
   pipelined stack on a seeded cotangent, each stage's block gradients within 1e-3 of the
   largest of the one-process stack's. The ranks' step p50, peak memory, the gradient
   all-reduce and the ranks' walls are printed with the card; gloo ranks sharing one card
   say little of speed.
41. the kernels at the legacy MAE shapes (after phase 30): the fp32 and bf16 K1-K5 at B=128,
   L=26 (the legacy encoder's visible tokens: a partial last tile for every kernel) and
   L=64 (its decoder, the probe's noaug encoder), each held against its plain version at
   the tolerances above and timed beside it, into each record's ``at_legacy_mae_shapes``;
42. (after phase 34) the ModelNet40 classifier with ``rms_norm`` and with
   ``add_after_layer`` (the stack that re-sorts its tokens after every block) through
   phases 5 and 7: every forward launches K1 and K2 12 times each, its logits and features
   against 'seq'; every step K1, K3, K4 and K5 12 times each; the ``add_after_layer``
   model's B=4 gradients against 'seq' too;
43. the SSD classifier with ``rms_norm``: one held train-mode forward and backward at B=4
   against 'xla' (phase 8's tolerances), K1, K8 with states, K9 and K5 12 times each;
44. the permutation policy (``models/permute_policy.py``; 384 wide, G=64, k=4, its 3 blocks
   over the 512-token SAST sequence of 32 clouds, tau 1): one forward and the backward of
   the summed policy, K1, K3, K4 and K5 3 times each and nothing else, a permutation of the
   512 slots; logits (1e-3 of max, 2e-3 relative), the policy (rtol 1e-5) and every gradient
   (within GRAD_TOL of the largest) against 'seq';
45. the legacy 'MAMBA' MAE at cfgs/pretrain.yaml's width: the held eval loss (rtol 2e-3)
   and noaug features (1e-3 of max) against 'seq' on 16 clouds, K1 and K2 16 and 12 times;
   then cfgs/pretrain.yaml with ``method: MAMBA`` through the CLI as phase 33 (four steps at
   batch 128, K1, K3, K4, K5 16 times a step; the probe's feature forwards K1 and K2 12
   times), the step timed by piece (grouping, forward, update);
46. cfgs/fewshot.yaml through the CLI with --way 5 --shot 10 --fold 0 at max_epoch 0 on a
   seeded ModelNetFewshot pickle of 1024-point clouds written under build/fewshot/ (50
   train, 100 test): one step (K1, K3, K4, K5 12 times), the validation forwards (K1, K2 12
   times each), the head 5 wide, then ``--test`` of its ckpt-last.pth equal to the
   validation;
47. (after phase 46) the HTTP server: the published classifier (seeded weights) in a
   ``Predictor`` (npoints 1024, max_batch 64) behind ``serve_http.make_server`` on 127.0.0.1,
   256 requests from one client in turn, then 512 from 16 client threads (half ``.npy``,
   half JSON): K1 and K2 12 times for each coalesced batch, every reply's label and probs (1e-4)
   those of ``predict_proba`` of its cloud alone, a mean batch above 1 on ``/healthz``, the
   400 and 404 paths; p50 and p99 at 1 and 16 clients;
48. ``scan_impl='assoc'`` (the whole-sequence log-depth scan, plain PyTorch): one mixer at
   B=32, L=512, d_inner 768, y and every gradient against the kernel route, each route's
   time and peak; the 12-block classifier's logits under 'assoc' against 'auto' at B=32,
   and its forward + backward at B=8 beside the kernel route's (peaks, times);
49. (run by the two ranks of phases 11-14, after them) the Mamba-1 sequence-parallel scan at
   layer 0's operands, B=32, L=512 (256 a rank): y and every gradient against the one-rank
   plain scan, forward and forward + backward timed, no kernel launched;
50. ``--tsne`` through the CLI on phase 15's tree and ckpt-last.pth (K1 and K2 12 times a
   test batch, the t-SNE of the 80 features on the card, a PNG that decodes), the t-SNE
   alone at 2468 seeded features, ``vis_run`` of phase 33's ckpt-last.pth on 16 seeded
   clouds (K1 and K2 16 times a batch, the text dumps and PNG renders), and the host
   ``native.fps_cpu`` (built with g++) equal to the device FPS on 8 clouds of 8192 points.
51. (after phase 50) K1/K5 at conv widths 1, 2, 3 and 5 (the any-width variants) on the
   column view of xz (B=32, L=512, d_inner 768), fp32 and bf16, each against its plain
   version (fp32 1e-5 of max; bf16 one ulp, dw and db 1e-4), the backward twice, bitwise
   equal; timed at width 3 beside the plain versions and ``F.conv1d`` + ``F.silu``;
52. K2-K4 at d_state 1, 8, 12, 32 and 64 (the any-state variants), fp32 and bf16, at perf
   mode's tolerances, K3's y equal to K2's, K4 twice, bitwise equal; timed at 8 and 32;
53. K10/K11 at d_inner 1152, 1536, 2048 and 2560, d_state 8 and 32, conv widths 2 and 3
   (the global-memory variants) at B=4, L=256, fp32 and bf16, K11 twice, bitwise equal;
   timed at the trans_dim-768 classifier's shape (d_inner 1536, B=32, L=512);
54. every K8/K9 and K6/K7 entry point (lean, with states, with h_fin, with both; from 0 and
   seeded) at chunks 8, 32, 96 (L = 512 padded to 576), 512 and 1024 (L = 1024, one chunk)
   at B=32, fp32 and bf16, against their plain versions; the '_strip' (chunk 32) and
   '_long' (chunk 512) variants timed at B=8, 6 heads;
55. the paths of phases 51-54's variants: 12 ``MambaMixer`` blocks (d_model 384) at
   (d_state 8, d_conv 3) and (32, 2), fp32 and bf16, a no-grad forward and a forward and
   backward at B=32 (the any-width K1, K5 and any-state K2, K3, K4 12 times each, K1 24),
   and at B=4 the same against the plain route ('seq'): output and every gradient within
   1e-3 of max (PERF_LOGITS_TOL at bf16); the SSD cores ``ssd_chunked_xbc`` and
   ``ssd_chunked_split`` at chunks 32 and 512, each without and with a gradient and with
   ``return_carry``: every entry point's variant once;
56. the SSD classifier (fp32, eigh) at ``ssd_chunk`` 32 and 512 through phase 5's serving
   against 'xla' (K1 and the '_strip' / '_long' lean K8 12 times a forward) and
   cfgs/finetune_modelnet_ssd_fused.yaml with that chunk through the CLI (two epochs of
   two steps); the fused classifier at trans_dim 768 (d_inner 1536, dt_rank 48), fp32 and
   bf16, through the serving against 'seq' and cfgs/finetune_modelnet.yaml with
   ``scan_impl: fused`` through the CLI (the any-shape K10/K11); both part-segmentation
   presets with ``model.dtype: bfloat16`` through the CLI as phase 29's (the bf16 K1-K5, or
   K1/K5 and K8/K9, 12 times a step);
57. (after phase 56) every K8/K9 and K6/K7 entry point at the wide states JAX compiles
   (d_state, head_dim) = (256, 256), (256, 128), (128, 256) and (384, 384) at B=8, L=512,
   chunk 256, and at (256, 256) at B=32 and chunks 32, 256 and 512, fp32 and bf16, against
   their plain versions, every backward twice, bitwise equal; timed at B=32, chunk 256,
   (256, 256), 3 heads. Then the paths: 12 ``SSDMixer`` blocks (d_model 384,
   ``scan_impl='ssd_fused'``, chunk 256) at each geometry, fp32 and bf16, a no-grad
   forward and a forward and backward at B=32 (the '_wide' K8, K8 with states and K9 12
   times each, K1 24, K5 12) and at B=4 against the plain route: output and every gradient
   within 1e-3 of max (PERF_LOGITS_TOL at bf16); 12 chained
   ``ssd_chunked_xbc(return_carry=True)`` calls at (256, 256) (K8 with h_fin, with states
   and h_fin, the seeded K9); on phase 11's ranks 12 tensor-parallel ``SSDMixer`` blocks
   at (256, 128) (3 heads a rank: K6, K6 with states, K7) and 12 chained
   ``ssd_seq_parallel`` calls at (256, 256) (K6 with h_fin, with states and h_fin, the
   seeded K7), each fp32 and bf16 against the plain versions on the card;
58. ``scripts/torch_profile_train_step.py`` at its default geometry (the Mamba-1 finetune
   step, B=32, bf16) into chiprun_out/profiles/: the JAX script's keys, a positive leaf
   device time, K1, K3, K4 and K5 12 calls a step.

Each path (serving, train, perf serving, perf train, SSD serving, SSD train,
SSD perf serving, SSD perf train, fused serving, fused train, fused perf
serving, fused perf train, the carry path at fp32 and at bf16, the harness's
finetune, test and vote runs, the perf, SSD and fused perf configurations'
CLI runs and the latter two's test runs, the HLT classifier's request, the
two held seg forwards and the two seg CLI runs, the held MAE loss and feature
forwards, the MAE stack's train pass, the two pretraining CLI runs, the hardest scan's CLI
run and held forward, the rms_norm and add_after_layer classifiers' serving and train, the
SSD rms_norm classifier's held step, the policy's forward and gradient, the held legacy MAE
loss and feature forwards and its CLI run, the few-shot CLI run and its test run, the HTTP
server's 16 clients, the ``--tsne`` CLI run and ``vis_run``, phases 55-56's stacks, SSD
cores, classifiers and seg runs, phase 57's wide stacks and carry chains, and on
each rank TP SSD serving,
TP SSD train, SP, SP train, TP Mamba-1 serving, bf16 TP SSD serving and
train, bf16 SP and SP train, bf16 TP Mamba-1 serving and train, the Mamba-1 SP scan, phase 57's wide TP stacks and SP
chains at fp32 and bf16, and
rank 0's DP step, DP
forward, DP CLI run and vote, DP seg and pretraining CLI runs, pipelined forward and
backward, and DP x TP step) is driven with every launch count set to 0 just before it and
read just after. The last five
lines of standard output are the harness's record, the serving, profile,
train and gradient record of the three models (and perf mode's, the SSD
presets' and fused perf mode's serving, profile, train and CLI records, part
segmentation's, MAE pretraining's, phases 42-46's and 47-50's), the kernels' record (each one
JSON object; every kernel names its ``main_path`` and its launches on every
path, rank 0's for the parallel paths), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# The published ModelNet40 finetune model (cfgs/finetune_modelnet.yaml, model
# section), in eval mode; written out because the card's host has no pyyaml.
MODELNET40 = dict(trans_dim=384, depth=12, cls_dim=40, group_size=32, num_group=64,
                  encoder_dims=384, rms_norm=False, drop_path=0.3, drop_out=0.0,
                  method="SAST", reverse=True, knn_graph=20, k_top_eigenvectors=4,
                  alpha=100.0, smallest=True, symmetric=True, self_loop=False,
                  binary=True, matrix="laplacian", add_after_layer=False)
# The SSD classifier: the same model with the SSD lines of
# cfgs/finetune_modelnet_ssd.yaml:12 and cfgs/finetune_modelnet_ssd_fused.yaml:11,15,
# at fp32 with exact eigh (the presets' bf16 and subspace switches are perf mode).
MODELNET40_SSD = dict(MODELNET40, mixer="ssd", ssd_chunk=256, scan_impl="ssd_fused")
# The whole-mixer route: the ModelNet40 model with scan_impl 'fused' (the JAX
# package's opt-in `mamba_mixer_apply(impl='fused')`).
MODELNET40_FUSED = dict(MODELNET40, scan_impl="fused")
# Perf mode: the ModelNet40 model with cfgs/finetune_modelnet_perf.yaml's two
# switches (bf16 activations, the subspace eigensolver), which
# Predictor.from_checkpoint(perf=True) sets.
MODELNET40_PERF = dict(MODELNET40, dtype="bfloat16", spectral_method="subspace")
# The SSD presets as shipped: the SSD classifier with perf mode's two switches,
# which cfgs/finetune_modelnet_ssd.yaml inherits from finetune_modelnet_perf.yaml.
MODELNET40_SSD_PERF = dict(MODELNET40_SSD, dtype="bfloat16", spectral_method="subspace")
# Perf mode on the whole-mixer route: the fused model with perf mode's two
# switches (cfgs/finetune_modelnet_perf.yaml with model.scan_impl 'fused').
MODELNET40_FUSED_PERF = dict(MODELNET40_FUSED, dtype="bfloat16", spectral_method="subspace")
NPOINTS = 1024
REQUEST_SIZES = (1, 20, 64)
REPEATS = 5
PROFILE_REPEATS = 10
TRAIN_BATCH = 32
TRAIN_POINTS = 8192
TRAIN_STEPS = 8
PARITY_BATCH = 4
GRAD_TOL = 1e-3
# the kernels of the Mamba-1 main path: a train step's, an eval forward's
TRAIN_KERNELS = ("causal_conv1d_silu", "selective_scan_fwd_residuals", "selective_scan_bwd",
                 "causal_conv1d_silu_bwd")
EVAL_KERNELS = ("causal_conv1d_silu", "selective_scan_fwd")
# the bf16 variants of the same kernels, perf mode's (K2, K3 and K4 on the
# Hopper bf16 body, csrc/selective_scan_bf16_sm90.cu)
PERF_TRAIN_KERNELS = ("causal_conv1d_silu_bf16", "selective_scan_fwd_residuals_sm90_bf16",
                      "selective_scan_bwd_sm90_bf16", "causal_conv1d_silu_bwd_bf16")
PERF_EVAL_KERNELS = ("causal_conv1d_silu_bf16", "selective_scan_fwd_sm90_bf16")
# the bf16 SSD presets' kernels: a train step's, an eval forward's (K8 and K9
# on the Hopper bf16 body, csrc/ssd_xbc_bf16_sm90.cu, at their chunks 256 and
# 128)
SSD_PERF_TRAIN_KERNELS = ("causal_conv1d_silu_bf16", "ssd_xbc_fwd_states_sm90_bf16",
                          "ssd_xbc_bwd_sm90_bf16", "causal_conv1d_silu_bwd_bf16")
SSD_PERF_EVAL_KERNELS = ("causal_conv1d_silu_bf16", "ssd_xbc_fwd_sm90_bf16")
# the fused perf route's kernels (perf mode on scan_impl 'fused'): a train
# step's, an eval forward's
FUSED_PERF_TRAIN_KERNELS = ("fused_mixer_fwd_states_bf16", "fused_mixer_bwd_bf16")
FUSED_PERF_EVAL_KERNELS = ("fused_mixer_fwd_bf16",)
# Perf mode's logits and pooled features, kernel route against the plain one
# ('seq') on the card, within this share of their max: bf16 keeps 8
# significant bits (a rounding moves a value up to 2^-9 = 0.2 %), and the two
# routes round in other places over 12 blocks (the conv kernel reads the
# fp32 conv weights, the plain conv bf16 ones; the scans sum in other orders).
PERF_LOGITS_TOL = 5e-2

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) op/s and
# dense TF32 and bf16 tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed (CUDA events): the kernels' own time, without the
    host's cost of each call, which exceeds a small launch's device time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixer_inputs(device, batch: int = 32, length: int = 512):
    """The conv's and the scan's inputs as layer 0's mixer makes them, at
    B=batch, L=length (views into xz and x_dbl, as on the serving path)."""
    from si_mamba_tpu_torch.models.layers import MambaMixer

    mixer = MambaMixer(MODELNET40["trans_dim"], out_proj_div=MODELNET40["depth"] ** 0.5)
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((batch, length, MODELNET40["trans_dim"]),
                                             dtype=np.float32)).to(device)
    xz = x @ p["in_proj_w"]
    return mixer, p, xz


def scan_operands(device, batch: int = 32, length: int = 512) -> tuple:
    """The scan's inputs (u, dt, A, B, C, D, z, dt_bias) as layer 0's mixer
    makes them at B=batch, L=length: u the conv kernel's output, B and C
    column views of x_dbl, z the column view of xz."""
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_silu_fwd

    mixer, p, xz = mixer_inputs(device, batch, length)
    d_inner, n, dt_rank = mixer.d_inner, mixer.d_state, mixer.dt_rank
    u = causal_conv1d_silu_fwd(xz[..., :d_inner], p["conv_w"], p["conv_b"])
    x_dbl = u @ p["x_proj_w"]
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"]
    return (u, dt, -torch.exp(p["A_log"]), x_dbl[..., dt_rank:dt_rank + n],
            x_dbl[..., dt_rank + n:], p["D"], xz[..., d_inner:], p["dt_proj_b"])


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def conv_fwd_bound(B: int, L: int, C: int, W: int, size: int = 4) -> tuple[float, str]:
    """K1's bound: x read and y written (``size`` bytes an element), w and b
    (fp32) read; operations per element: the sum 2W+1, SiLU 4."""
    return bound(2 * B * L * C * size + C * (W + 1) * 4, B * L * C * (2 * W + 5))


def conv_bwd_bound(B: int, L: int, C: int, W: int) -> tuple[float, str]:
    """K5's bound: x and g read, dx written (plus w, b, dw, db); operations
    per element: s 2W+1, sigmoid 4, ds 4, dx 2W, dw and db 2W+2."""
    return bound((3 * B * L * C + 2 * C * (W + 1)) * 4, B * L * C * (6 * W + 11))


def conv_records(x, w, b, g) -> tuple[dict, dict]:
    """K1 and K5 on x (B, L, C), a column view as a mixer makes it, and a
    seeded output gradient g: each against its plain version, then timed
    beside it and beside ``F.conv1d(groups=C)`` + ``F.silu`` (for K5, the
    autograd backward of that). Returns the two records' measured fields."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    B, L, C = x.shape
    W = w.shape[1]
    where = f"width {C}, row stride {x.stride(1)}"
    y, y_ref = kc.causal_conv1d_silu_fwd(x, w, b), kc.causal_conv1d_ref(x, w, b)
    torch.cuda.synchronize()
    err1 = (y - y_ref).abs().max().item()
    if not torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"causal-conv kernel at {where} disagrees with its plain "
                             f"version: max |diff| {err1}")
    xt, w3 = x.transpose(1, 2), w[:, None, :]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bound_ms, bound_by = conv_fwd_bound(B, L, C, W)
    fwd = dict(shape=[B, L, C], row_stride=x.stride(1), max_abs_err=err1,
               plan=asdict(kc.fwd_plan(x, sms)),
               ms=time_ms(lambda: kc.causal_conv1d_silu_fwd(x, w, b), 50),
               device_ms=graph_ms(lambda: kc.causal_conv1d_silu_fwd(x, w, b), 20),
               plain_ms=time_ms(lambda: kc.causal_conv1d_ref(x, w, b), 20),
               library_ms=time_ms(lambda: F.silu(F.conv1d(xt, w3, b, padding=W - 1,
                                                          groups=C)[..., :L]), 20),
               bound_ms=bound_ms, bound_by=bound_by)

    # K5. Tolerance rel-to-max 1e-4: dw and db are sums over B*L terms, taken
    # per time tile, per block and then over the blocks, in another order than
    # the plain version's; that order is fixed, so two runs are bitwise equal.
    args = (x, w, b, g)
    got, want = kc.causal_conv1d_silu_bwd(*args), kc.causal_conv1d_silu_bwd_ref(*args)
    again = kc.causal_conv1d_silu_bwd(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"two conv backward runs at {where} on the same inputs differ")
    err5 = 0.0
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        err, rel = _rel_err(a, r)
        err5 = max(err5, err)
        if rel > 1e-4:
            raise AssertionError(f"conv backward kernel at {where}: {name} disagrees with the "
                                 f"plain backward: max |diff| {err} ({rel:.3e} of max)")
    x_lib = xt.detach().requires_grad_()
    w_lib, b_lib = (t.detach().clone().requires_grad_() for t in (w3, b))
    y_lib = F.silu(F.conv1d(x_lib, w_lib, b_lib, padding=W - 1, groups=C)[..., :L])
    bound_ms, bound_by = conv_bwd_bound(B, L, C, W)
    plan = kc.bwd_plan(x, g, W, sms)
    bwd = dict(shape=[B, L, C], row_stride=x.stride(1), max_abs_err=err5,
               plan=dict(vx=plan.vx, vg=plan.vg, tile=plan.tile),
               ms=time_ms(lambda: kc.causal_conv1d_silu_bwd(*args), 50),
               device_ms=graph_ms(lambda: kc.causal_conv1d_silu_bwd(*args), 20),
               plain_ms=time_ms(lambda: kc.causal_conv1d_silu_bwd_ref(*args), 10),
               library_ms=time_ms(lambda: torch.autograd.grad(
                   y_lib, (x_lib, w_lib, b_lib), g.transpose(1, 2), retain_graph=True), 20),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"conv at {where}: forward max |diff| {err1:.3e} ({fwd['ms']:.6f} ms, device "
        f"{fwd['device_ms']:.6f} ms, bound {fwd['bound_ms']:.6f}, library "
        f"{fwd['library_ms']:.6f}, plan {fwd['plan']}), backward {err5:.3e} (two runs "
        f"bitwise equal; {bwd['ms']:.6f} ms, device {bwd['device_ms']:.6f} ms, plan "
        f"{bwd['plan']})")
    return fwd, bwd


def conv_views(device, batch: int, dtype: torch.dtype) -> dict:
    """K1's operands at the two mixer views as layer 0's mixers make them at
    B=batch, L=512, in ``dtype`` (x @ in_proj in that dtype): the Mamba-1 xi
    (columns :768 of the 1536-wide xz) and the SSD x|B|C (columns 768:1792 of
    the 1798-wide in_proj output); the conv weight and bias fp32, as the
    kernels read them. Returns {view: (x, w, b)}."""
    from si_mamba_tpu_torch.models.layers import MambaMixer, SSDMixer

    u = torch.from_numpy(np.random.default_rng(20 + batch).standard_normal(
        (batch, 512, MODELNET40["trans_dim"]), dtype=np.float32)).to(device, dtype)
    views = {}
    for view, mixer in (("mamba1", MambaMixer(MODELNET40["trans_dim"])),
                        ("ssd", SSDMixer(MODELNET40["trans_dim"],
                                         chunk=MODELNET40_SSD["ssd_chunk"]))):
        mixer.reset_parameters(torch.Generator().manual_seed(1))
        p = {k: v.detach().to(device) for k, v in mixer.params().items()}
        d = mixer.d_inner
        xz = u @ p["in_proj_w"].to(dtype)
        cols = slice(0, d) if view == "mamba1" else slice(d, 2 * d + 2 * mixer.d_state)
        views[view] = (xz[..., cols], p["conv_w"], p["conv_b"])
    return views


def conv_at_clouds(device, dtype: torch.dtype) -> dict:
    """K1 in ``dtype`` at each serving request size at the two mixer views
    (``conv_views``), held against its plain version (fp32 within rtol 1e-5 /
    atol 1e-6; bf16 within one bf16 ulp at a floor of 1e-2 of max|y|) and
    timed as back-to-back wrapper calls (``ms``) and as device time
    (``device_ms``, CUDA-graph replays), with its plan and bound. Returns
    {view: {batch: figures}}."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"mamba1": {}, "ssd": {}}
    for batch in REQUEST_SIZES:
        for view, (x, w, b) in conv_views(device, batch, dtype).items():
            y, y_ref = kc.causal_conv1d_silu_fwd(x, w, b), kc.causal_conv1d_ref(x, w, b)
            torch.cuda.synchronize()
            where = f"{view} view at {batch} clouds, {dtype}"
            if dtype == torch.bfloat16:
                ulps = _bf16_ulps(y, y_ref, 1e-2)
                if ulps > 1:
                    raise AssertionError(f"conv forward at the {where}: {ulps:.2f} bf16 ulps "
                                         f"from its plain version")
            elif not torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"conv forward at the {where} disagrees with its plain "
                                     f"version: max |diff| {(y - y_ref).abs().max().item()}")
            out[view][batch] = dict(
                max_abs_err=(y.float() - y_ref.float()).abs().max().item(),
                plan=asdict(kc.fwd_plan(x, sms)),
                ms=time_ms(lambda: kc.causal_conv1d_silu_fwd(x, w, b), 50),
                device_ms=graph_ms(lambda: kc.causal_conv1d_silu_fwd(x, w, b), 20),
                bound_ms=conv_fwd_bound(*x.shape, w.shape[1], x.element_size())[0])
    log(f"conv forward at 1/20/64 clouds, {dtype}: " + "; ".join(
        f"{view} B={batch}: {f['ms']:.6f} ms, device {f['device_ms']:.6f} ms, plan {f['plan']}"
        for view, by_batch in out.items() for batch, f in by_batch.items()))
    return out


def tp_conv_phase(device) -> dict:
    """K1 and K5 at the two conv shapes of the tensor-parallel SSD train step
    on each of its TP ranks, B=32, L=512: the rank's x shard (d_inner / TP
    channels) and B|C (2 d_state), both contiguous as that mixer's products
    make them, with seeded weights and output gradient. Returns, by kernel
    name, the K1 and K5 figures at each width."""
    from si_mamba_tpu_torch.models.layers import SSDMixer

    mixer = SSDMixer(MODELNET40["trans_dim"])
    rng = np.random.default_rng(5)
    out = {"causal_conv1d_silu": {}, "causal_conv1d_silu_bwd": {}}
    for what, C in (("x_shard", mixer.d_inner // TP), ("bc", 2 * mixer.d_state)):
        x, g = (torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 512, C), dtype=np.float32))
                .to(device) for _ in range(2))
        w = torch.from_numpy((rng.standard_normal((C, 4)) * 0.5).astype(np.float32)).to(device)
        b = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32)).to(device)
        fwd, bwd = conv_records(x, w, b, g)
        out["causal_conv1d_silu"][what] = fwd
        out["causal_conv1d_silu_bwd"][what] = bwd
    return out


def kernel_phase(device) -> list[dict]:
    """The serving path's kernels at its shapes: K1 and K5 (with a seeded
    output gradient) on the column view of xz, K2 on K1's output."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    mixer, p, xz = mixer_inputs(device)
    xi = xz[..., :mixer.d_inner]
    B, L, D = xi.shape
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((B, L, D), dtype=np.float32))
    fwd, bwd = conv_records(xi, p["conv_w"], p["conv_b"], g.to(device))
    records = [
        dict(name="causal_conv1d_silu", route="cuda",
             source="si_mamba_tpu_torch/csrc/causal_conv.cu",
             replaces="si_mamba_tpu/ops/pallas/causal_conv_kernel.py:52",
             at_clouds=conv_at_clouds(device, torch.float32), **fwd),
        dict(name="causal_conv1d_silu_bwd", route="cuda",
             source="si_mamba_tpu_torch/csrc/causal_conv.cu",
             replaces="si_mamba_tpu/ops/pallas/causal_conv_kernel.py:58", **bwd)]

    # K2: selective scan forward, on the conv's output as on the path, at the
    # train batch and at each serving request size
    args = scan_operands(device)
    fig = scan_fwd_figures(args)
    sizes = {str(b): scan_fwd_figures(scan_operands(device, b)) for b in REQUEST_SIZES}
    records.append(dict(
        name="selective_scan_fwd", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_fwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:115", **fig,
        plain_ms=time_ms(lambda: ks.selective_scan_ref(*args[:5], D=args[5], z=args[6],
                                                       delta_bias=args[7]), 2, warmup=1),
        library_ms=None, at_request_sizes=sizes))
    log("selective scan ok: " + "; ".join(
        f"B={f['shape'][0]}: {f['ms']:.6f} ms, device {f['device_ms']:.6f} ms "
        f"({f['segments']} segments), max |diff| {f['max_abs_err']:.3e}"
        for f in (fig, *sizes.values())))
    return records


def scan_fwd_figures(args) -> dict:
    """K2 on ``args`` against its plain version (rtol 1e-4, atol 1e-5 of
    max|y|), then timed as back-to-back wrapper calls (``ms``, the host's
    cost of a call included) and as device time (``device_ms``, CUDA-graph
    replays)."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    B, L, D = args[0].shape
    n = args[2].shape[1]
    y = ks.selective_scan_fwd(*args)
    y_ref = ks.selective_scan_ref(*args[:5], D=args[5], z=args[6], delta_bias=args[7])
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    scale = y_ref.abs().max().item()
    if not torch.allclose(y, y_ref, rtol=1e-4, atol=1e-5 * scale):
        raise AssertionError(f"selective-scan kernel at B={B} disagrees with its plain "
                             f"version: max |diff| {err}, max |y| {scale}")
    # bytes: u, dt, z, B, C read once, y written once, plus A, D, dt_bias;
    # operations per (b, l, d): softplus 4, skip + gate 6, and per state 7
    # (exp, 2 mul, 2 fma) with each exp counted as one operation
    scan_bytes = (4 * B * L * D + 2 * B * L * n + D * n + 2 * D) * 4
    bound_ms, bound_by = bound(scan_bytes, B * L * D * (10 + 7 * n))
    return dict(shape=[B, L, D], max_abs_err=err,
                ms=time_ms(lambda: ks.selective_scan_fwd(*args), 20),
                device_ms=graph_ms(lambda: ks.selective_scan_fwd(*args), 20),
                segments=ks._fwd_library().selective_scan_fwd_segments(B, L, D),
                bound_ms=bound_ms, bound_by=bound_by)


def backward_kernel_phase(device, args=None) -> list[dict]:
    """The scan's training kernels at the serving path's shapes (or on
    ``args``, ``scan_operands`` at another shape), with a seeded output
    gradient: K3 (scan forward with residuals) and K4 (scan backward), each
    against its plain version, then timed as wrapper calls and as CUDA-graph
    device time."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    # K3: the scan forward that keeps its tile entry states, on the conv's output
    args = scan_operands(device) if args is None else args
    B, L, D = args[0].shape
    n = args[2].shape[1]
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((B, L, D), dtype=np.float32)).to(device)
    records = []
    y3, h3 = ks.selective_scan_fwd_residuals(*args)
    y2 = ks.selective_scan_fwd(*args)
    y_ref, h_ref = ks.selective_scan_fwd_residuals_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(y3, y2):
        raise AssertionError(f"the training scan forward's y differs from the lean "
                             f"kernel's: max |diff| {(y3 - y2).abs().max().item()}")
    err3, rel_y = _rel_err(y3, y_ref)
    err_h, rel_h = _rel_err(h3, h_ref)
    if rel_y > 1e-4 or rel_h > 1e-4:
        raise AssertionError(f"training scan forward disagrees with its plain version: "
                             f"y {err3} ({rel_y:.3e}), h_entries {err_h} ({rel_h:.3e})")
    nc = h3.shape[1]
    scan_bytes = (4 * B * L * D + 2 * B * L * n + D * n + 2 * D) * 4
    bound_ms, bound_by = bound(scan_bytes + B * nc * n * D * 4, B * L * D * (10 + 7 * n))
    records.append(dict(
        name="selective_scan_fwd_residuals", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_fwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:407",
        shape=[B, L, D], max_abs_err=max(err3, err_h),
        ms=time_ms(lambda: ks.selective_scan_fwd_residuals(*args), 20),
        device_ms=graph_ms(lambda: ks.selective_scan_fwd_residuals(*args), 20),
        plain_ms=time_ms(lambda: ks.selective_scan_fwd_residuals_ref(*args), 2, warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log(f"training scan forward ok: y == lean y; vs plain y {err3:.3e}, h_entries "
        f"{err_h:.3e} (T = {ks.CHUNK}, {nc} entries per channel)")

    # K4: scan backward, from the kernel's own h_entries. Tolerance
    # rel-to-max 1e-3: dA, dB, dC, dD and ddelta_bias are sums over channels
    # or over B*L, taken in another order than the plain version's.
    bwd_args = (*args, g, h3)
    got = ks.selective_scan_bwd(*bwd_args)
    again = ks.selective_scan_bwd(*bwd_args)
    want = ks.selective_scan_bwd_ref(*bwd_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two scan backward runs on the same inputs differ")
    err4 = 0.0
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias"),
                          got, want):
        err, rel = _rel_err(a, b)
        err4 = max(err4, err)
        if rel > 1e-3:
            raise AssertionError(f"scan backward kernel: {name} disagrees with the plain "
                                 f"backward: max |diff| {err} ({rel:.3e} of max)")
    # bytes: u, dt, z, g, B, C, h_entries (and A, D, dt_bias) read once; du,
    # ddelta, dz, dB, dC (and dA, dD, ddelta_bias) written once. Operations per
    # state element: one exp and about 19 fp32 operations; per (b, l, d) about 20.
    bwd_bytes = (7 * B * L * D + 4 * B * L * n + B * nc * n * D + 2 * D * n + 4 * D) * 4
    bound_ms, bound_by = bound(bwd_bytes, B * L * D * (20 * n + 20))
    records.append(dict(
        name="selective_scan_bwd", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_bwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:211",
        shape=[B, L, D], max_abs_err=err4,
        ms=time_ms(lambda: ks.selective_scan_bwd(*bwd_args), 20),
        device_ms=graph_ms(lambda: ks.selective_scan_bwd(*bwd_args), 20),
        plain_ms=time_ms(lambda: ks.selective_scan_bwd_ref(*bwd_args), 1, warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log(f"scan backward ok: max |diff| {err4:.3e}, two runs bitwise equal")
    return records


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    """The largest |got - want| in bf16 ulps of want (8 significant bits),
    each ulp taken at least at ``floor`` of max|want|."""
    got, want = got.float(), want.float()
    mag = torch.clamp_min(want.abs(), floor * want.abs().max().item())
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def perf_operands(device, batch: int = 32, length: int = 512):
    """Perf mode's kernel operands as layer 0's bf16 mixer makes them at
    B=batch, L=length: xz = x @ in_proj (bf16, row stride 1536), the conv's x and
    the scan's z its column views, u the bf16 conv kernel's output, B and C
    column views of x_dbl = u @ x_proj, dt = x_dbl[..., :24] @ dt_proj, all
    bf16; the conv weight and bias, A, D and dt_bias fp32. Returns (xz, conv
    weight, conv bias, scan args)."""
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_silu_fwd

    mixer, p, xz = mixer_inputs(device, batch, length)
    bf = torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (batch, length, MODELNET40["trans_dim"]), dtype=np.float32)).to(device, bf)
    xz = x @ p["in_proj_w"].to(bf)
    d_inner, n, dt_rank = mixer.d_inner, mixer.d_state, mixer.dt_rank
    u = causal_conv1d_silu_fwd(xz[..., :d_inner], p["conv_w"], p["conv_b"])
    x_dbl = u @ p["x_proj_w"].to(bf)
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"].to(bf)
    args = (u, dt, -torch.exp(p["A_log"]), x_dbl[..., dt_rank:dt_rank + n],
            x_dbl[..., dt_rank + n:], p["D"], xz[..., d_inner:], p["dt_proj_b"])
    return xz, p["conv_w"], p["conv_b"], args


def bf16_kernel_phase(device) -> list[dict]:
    """Perf mode's kernels, the bf16 variants of K1-K5, at its shapes (B=32,
    L=512, d_inner 768, d_state 16; strided bf16 views as the bf16 mixer makes
    them), each against its plain version on the same inputs and timed beside
    it: K1 and K5 also beside bf16 ``F.conv1d(groups=D)`` + ``F.silu`` and its
    autograd; K2 also at B = 1, 20 and 64; K2, K3 and K4 (the Hopper bf16
    body, h_entries every ``ks.SM90_TILE`` steps) also at the
    part-segmentation shape (``at_seg_shape``). Tolerances: a bf16 output within
    one bf16 ulp of the plain version's (both round one fp32 value; the ulp
    taken at least at 1e-2 of the output's max, 2e-2 for K4's, whose sums over
    channels and states run in other orders), two for K4's; an fp32 output
    within 1e-4 of its max (1e-3 for K4's sums over channels). Bounds count
    bf16 bytes for the bf16 operands and fp32 operations."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    xz, w, b, args = perf_operands(device)
    x = xz[..., :w.shape[0]]
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        x.shape, dtype=np.float32)).to(device, torch.bfloat16)
    records = []

    # K1 and K5, bf16 (K5 run twice, bitwise equal)
    fwd, bwd = bf16_conv_figures(x, w, b, g)
    source, replaces = ("si_mamba_tpu_torch/csrc/causal_conv.cu",
                        "si_mamba_tpu/ops/pallas/causal_conv_kernel.py:")
    records.append(dict(name="causal_conv1d_silu_bf16", route="cuda", source=source,
                        replaces=replaces + "52", dtype="bfloat16",
                        at_clouds=conv_at_clouds(device, torch.bfloat16), **fwd))
    records.append(dict(name="causal_conv1d_silu_bwd_bf16", route="cuda", source=source,
                        replaces=replaces + "58", dtype="bfloat16", **bwd))

    # K2, bf16, at the train batch and each serving request size; K3 and K4
    fig = bf16_scan_fwd_figures(args)
    sizes = {str(bq): bf16_scan_fwd_figures(perf_operands(device, bq)[3])
             for bq in REQUEST_SIZES}
    seg = mamba_bf16_at(device, SEG_BATCH, SEG_LEN, conv=False)
    source = "si_mamba_tpu_torch/csrc/selective_scan_bf16_sm90.cu"
    records.append(dict(
        name="selective_scan_fwd_sm90_bf16", route="cuda", source=source,
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:115", dtype="bfloat16", **fig,
        plain_ms=time_ms(lambda: ks.selective_scan_ref(*args[:5], D=args[5], z=args[6],
                                                       delta_bias=args[7]), 2, warmup=1),
        library_ms=None, at_request_sizes=sizes, at_seg_shape=seg["selective_scan_fwd_sm90_bf16"]))
    k3, k4 = bf16_scan_train_figures(args, g)
    records.append(dict(
        name="selective_scan_fwd_residuals_sm90_bf16", route="cuda", source=source,
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:407", dtype="bfloat16",
        library_ms=None, at_seg_shape=seg["selective_scan_fwd_residuals_sm90_bf16"], **k3))
    records.append(dict(
        name="selective_scan_bwd_sm90_bf16", route="cuda", source=source,
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:211", dtype="bfloat16",
        library_ms=None, at_seg_shape=seg["selective_scan_bwd_sm90_bf16"], **k4))
    log("bf16 scan: " + "; ".join(
        f"B={f['shape'][0]}: {f['ms']:.6f} ms, device {f['device_ms']:.6f} ms "
        f"({f['segments']} segments), max |diff| {f['max_abs_err']:.3e}"
        for f in (fig, *sizes.values())) +
        f"; with states max |diff| {k3['max_abs_err']:.3e}; backward {k4['max_abs_err']:.3e}, "
        f"two runs bitwise equal")
    return records


def _check_bf16(name, got, want, ulps=1, floor=1e-2, rel=1e-4) -> float:
    """Perf mode's kernel tolerances against the plain version: a bf16
    output within ``ulps`` bf16 ulps (each at least ``floor`` of the max), an
    fp32 output within ``rel`` of its max. Returns max |diff|."""
    if got.dtype == torch.bfloat16:
        err = _bf16_ulps(got, want, floor)
        if err > ulps:
            raise AssertionError(f"{name}: {err:.2f} bf16 ulps from the plain version")
    elif _rel_err(got, want)[1] > rel:
        raise AssertionError(f"{name}: {_rel_err(got, want)} from the plain version")
    return (got.float() - want.float()).abs().max().item()


def bf16_scan_fwd_figures(a) -> dict:
    """The bf16 K2 on ``a`` (``perf_operands``' scan args) against its plain
    version, timed as wrapper calls and as CUDA-graph device time."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    Bq, L, D = a[0].shape
    n = a[2].shape[1]
    yq = ks.selective_scan_fwd_bf16(*a)
    err = _check_bf16(f"bf16 scan forward at B={Bq}, L={L}", yq,
                      ks.selective_scan_ref(*a[:5], D=a[5], z=a[6], delta_bias=a[7]))
    scan_bytes = (4 * Bq * L * D + 2 * Bq * L * n) * 2 + (D * n + 2 * D) * 4
    bms, bby = bound(scan_bytes, Bq * L * D * (10 + 7 * n))
    return dict(shape=[Bq, L, D], max_abs_err=err,
                ms=time_ms(lambda: ks.selective_scan_fwd_bf16(*a), 20),
                device_ms=graph_ms(lambda: ks.selective_scan_fwd_bf16(*a), 20),
                segments=ks._sm90_library().scan_sm90_segments(Bq, L, D),
                bound_ms=bms, bound_by=bby)


def bf16_scan_train_figures(args, g) -> tuple[dict, dict]:
    """The bf16 K3 (its y equal to K2's, the fp32 entry states against the
    plain ones at the same tile, ``ks.entry_tile``) and K4 (two runs bitwise
    equal; a bf16 output within two ulps at a floor of 2e-2, fp32 sums within
    1e-3 of their max) on the scan args and output gradient ``g``, each timed
    beside its plain version."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    B, L, D = args[0].shape
    n = args[2].shape[1]
    tile = ks.entry_tile(args[0].dtype, n)
    y3, h3 = ks.selective_scan_fwd_residuals_bf16(*args)
    y2 = ks.selective_scan_fwd_bf16(*args)
    y_ref, h_ref = ks.selective_scan_fwd_residuals_ref(*args, tile=tile)
    torch.cuda.synchronize()
    if not torch.equal(y3, y2):
        raise AssertionError("the bf16 training scan forward's y differs from the lean one's")
    err3 = max(_check_bf16("bf16 scan forward with states: y", y3, y_ref),
               _check_bf16("bf16 scan forward with states: h_entries", h3, h_ref))
    # the bounds count the entry states the function needs, one every CHUNK
    # steps as the fp32 route writes them; the states of a body with shorter
    # tiles (ks.SM90_TILE) are its own cost, in its time and not in its bound
    nc = -(-L // ks.CHUNK)
    scan_bytes = (4 * B * L * D + 2 * B * L * n) * 2 + (D * n + 2 * D) * 4
    bound_ms, bound_by = bound(scan_bytes + B * nc * n * D * 4, B * L * D * (10 + 7 * n))
    k3 = dict(shape=[B, L, D], max_abs_err=err3,
              ms=time_ms(lambda: ks.selective_scan_fwd_residuals_bf16(*args), 20),
              device_ms=graph_ms(lambda: ks.selective_scan_fwd_residuals_bf16(*args), 20),
              plain_ms=time_ms(lambda: ks.selective_scan_fwd_residuals_ref(*args, tile=tile), 2,
                               warmup=1),
              bound_ms=bound_ms, bound_by=bound_by)
    bwd_args = (*args, g, h3)
    got = ks.selective_scan_bwd_bf16(*bwd_args)
    again = ks.selective_scan_bwd_bf16(*bwd_args)
    want = ks.selective_scan_bwd_ref(*bwd_args, tile=tile)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError("two bf16 scan backward runs on the same inputs differ")
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias")
    err4 = max(_check_bf16(f"bf16 scan backward {k}", a, r, ulps=2, floor=2e-2, rel=1e-3)
               for k, a, r in zip(names, got, want))
    # bytes: u, dt, z, g, B, C (bf16) and h_entries (fp32) read; du, ddelta,
    # dz, dB, dC (bf16) written; A, D, dt_bias, dA, dD, ddelta_bias (fp32)
    bwd_bytes = (7 * B * L * D + 4 * B * L * n) * 2 + (B * nc * n * D + 2 * D * n + 4 * D) * 4
    bound_ms, bound_by = bound(bwd_bytes, B * L * D * (20 * n + 20))
    k4 = dict(shape=[B, L, D], max_abs_err=err4,
              ms=time_ms(lambda: ks.selective_scan_bwd_bf16(*bwd_args), 20),
              device_ms=graph_ms(lambda: ks.selective_scan_bwd_bf16(*bwd_args), 20),
              plain_ms=time_ms(lambda: ks.selective_scan_bwd_ref(*bwd_args, tile=tile), 1,
                               warmup=1),
              bound_ms=bound_ms, bound_by=bound_by)
    return k3, k4


def tc_bound(bytes_moved: float, ops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel whose products run as 3xTF32
    on the tensor cores: three TF32 products for each, against the dense TF32
    peak."""
    bound_ms, bound_by = bound(bytes_moved, 3 * ops, TF32_OPS_PER_S)
    return dict(bound_ms=bound_ms, bound_by=bound_by)


def ssd_fwd_at_clouds(device) -> dict:
    """Lean K8 at each serving request size, on the conv output of layer 0's
    SSD mixer, against its plain version (rel-to-max 1e-4), timed as
    back-to-back wrapper calls (``ms``, the host's cost of a call included)
    and as device time (``device_ms``, CUDA-graph replays)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    out = {}
    for batch in REQUEST_SIZES:
        _, dth, S, _, _, xbc, D, chunk = _split_operands(device, heads=6, batch=batch)
        args = (xbc, dth, S, D, dth.shape[1] * kssd.HEAD_DIM, chunk)
        y = kssd.ssd_xbc_fwd(*args)
        y_ref = kssd.ssd_xbc_fwd_ref(*args)[0]
        torch.cuda.synchronize()
        err, rel = _rel_err(y, y_ref)
        if rel > 1e-4:
            raise AssertionError(f"SSD forward kernel at B={batch} disagrees with its plain "
                                 f"version: max |diff| {err} ({rel:.3e} of max)")
        out[batch] = dict(max_abs_err=err, ms=time_ms(lambda: kssd.ssd_xbc_fwd(*args), 20),
                          device_ms=graph_ms(lambda: kssd.ssd_xbc_fwd(*args), 20))
        log(f"ssd_xbc_fwd at {batch} clouds: {out[batch]}")
    return out


def ssd_kernel_phase(device, batch: int = 32, length: int = 512,
                     chunk: int = MODELNET40_SSD["ssd_chunk"],
                     at_clouds: bool = True) -> tuple[list[dict], dict]:
    """The SSD path's kernels at its shapes, as layer 0's SSD mixer makes its
    inputs at B=batch, L=length (32 and 512, the classifier's; the chunk its
    256): K1 and K5 at width 1024 on the column view of the (B, L, 1798)
    in_proj output, then K8 (both variants; with ``at_clouds`` lean K8 also
    at the serving request sizes) and K9 (run twice, bitwise equal) on K1's
    output. Returns the K8/K9 records and the K1/K5 figures at this shape."""
    from si_mamba_tpu_torch.models.layers import SSDMixer
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    depth = MODELNET40["depth"]
    mixer = SSDMixer(MODELNET40["trans_dim"], out_proj_div=depth ** 0.5, chunk=chunk)
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    d, n, h, chunk = mixer.d_inner, mixer.d_state, mixer.n_heads, mixer.chunk
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal((batch, length, MODELNET40["trans_dim"]),
                                             dtype=np.float32)).to(device)
    zxbcdt = u @ p["in_proj_w"]  # (B, L, 1798)
    xbc_in = zxbcdt[..., d:2 * d + 2 * n]  # width 1024, row stride 1798
    B, L, C = xbc_in.shape
    g = torch.from_numpy(rng.standard_normal((B, L, C), dtype=np.float32)).to(device)
    conv_shape = dict(zip(("causal_conv1d_silu", "causal_conv1d_silu_bwd"),
                          conv_records(xbc_in, p["conv_w"], p["conv_b"], g)))

    # K8, both variants, on K1's output
    xbc = kc.causal_conv1d_silu_fwd(xbc_in, p["conv_w"], p["conv_b"])
    dt = F.softplus(zxbcdt[..., 2 * d + 2 * n:] + p["dt_bias"])  # (B, L, h)
    A = -torch.exp(p["A_log"])
    nc = L // chunk
    dth = dt.transpose(1, 2).reshape(B, h, nc, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    args = (xbc, dth, S, p["D"], d, chunk)
    y_lean = kssd.ssd_xbc_fwd(*args)
    y, h_in = kssd.ssd_xbc_fwd_states(*args)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True)
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError(f"the SSD forward with states differs from the lean one: "
                             f"max |diff| {(y - y_lean).abs().max().item()}")
    err_y, rel_y = _rel_err(y, y_ref)
    err_h, rel_h = _rel_err(h_in, h_ref)
    if rel_y > 1e-4 or rel_h > 1e-4:
        raise AssertionError(f"SSD forward kernel disagrees with its plain version: y {err_y} "
                             f"({rel_y:.3e} of max), h_in {err_h} ({rel_h:.3e} of max)")
    # operations, the products the function needs: in every chunk the lower
    # triangle (s <= t, the rest is masked to 0) of G = C B^T, once for the
    # heads, and per head of (G (.) M)(dt x), each q(q+1)/2 * 2k; per head
    # C h_in (2qnp) in every chunk but the first, whose h_in is 0, and the
    # carry B^T (dt x T_end) (2qnp) in every chunk but the last, whose state
    # nothing reads. Bytes: xbc, dt, S, D read once, y (and h_in) written once
    q, hp = chunk, d // h
    tri = q * (q + 1)  # 2 * q(q+1)/2: the multiply-adds of a triangle, per unit of k
    fwd_ops = B * (nc * (tri * n + h * tri * hp) + (nc - 1) * h * 4 * q * n * hp)
    fwd_bytes = (B * L * (d + 2 * n) + 2 * B * h * L + h + B * L * d) * 4
    hin_bytes = B * nc * h * n * hp * 4
    records = []
    for name, fn, extra, err in (
            ("ssd_xbc_fwd", lambda: kssd.ssd_xbc_fwd(*args), 0, err_y),
            ("ssd_xbc_fwd_states", lambda: kssd.ssd_xbc_fwd_states(*args), hin_bytes,
             max(err_y, err_h))):
        records.append(dict(
            name=name, route="cuda", source="si_mamba_tpu_torch/csrc/ssd_xbc_fwd.cu",
            replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:540", max_abs_err=err,
            ms=time_ms(fn, 20), device_ms=graph_ms(fn, 20),
            plain_ms=time_ms(lambda: kssd.ssd_xbc_fwd_ref(*args, emit_states=bool(extra)), 3),
            library_ms=None, **tc_bound(fwd_bytes + extra, fwd_ops)))
    if at_clouds:
        records[0]["at_clouds"] = ssd_fwd_at_clouds(device)
    log(f"SSD forward ok: states y == lean y; vs plain y {err_y:.3e} ({rel_y:.3e} of max), "
        f"h_in {err_h:.3e} ({rel_h:.3e} of max)")

    # K9 for a seeded output gradient, from the kernel's own h_in; two runs
    # on the same inputs must be bitwise equal (no atomics)
    dy = torch.from_numpy(rng.standard_normal((B, L, d), dtype=np.float32)).to(device)
    bwd_args = (xbc, dth, S, p["D"], h_in, dy, d, chunk)
    got = kssd.ssd_xbc_bwd(*bwd_args)
    again = kssd.ssd_xbc_bwd(*bwd_args)
    want = kssd.ssd_xbc_bwd_ref(*bwd_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two SSD backward runs on the same inputs differ")
    err9, rels = 0.0, {}
    for name, a, b in zip(("dxbc", "ddt", "dS", "dD"), got, want):
        err, rels[name] = _rel_err(a, b)
        err9 = max(err9, err)
        if rels[name] > 1e-4:
            raise AssertionError(f"SSD backward kernel: {name} max |diff| {err} "
                                 f"({rels[name]:.3e} of max)")
    # operations, the products the function needs, lower triangles only: in
    # every chunk G once, per head GM^T dy and dy (dt x)^T (tri * p each), and
    # dG B and dG^T C once on dG summed over the heads (B and C are shared);
    # per head dy h_in^T (which also gives dE) and the carry (C E)^T dy
    # (2qnp each) in every chunk but the first, whose h_in is 0 and whose dh
    # nothing reads, and B dh and (dt x T_end) dh^T in every chunk but the
    # last, whose dh is 0. Bytes: xbc, dy, h_in, dt, S, D read, dxbc, ddt,
    # dS, dD written
    bwd_ops = B * (nc * (3 * tri * n + h * 2 * tri * hp) + (nc - 1) * h * 8 * q * n * hp)
    bwd_bytes = (2 * B * L * (d + 2 * n) + B * L * d + 4 * B * h * L + 2 * h) * 4 + hin_bytes
    bwd = lambda: kssd.ssd_xbc_bwd(*bwd_args)  # noqa: E731
    records.append(dict(
        name="ssd_xbc_bwd", route="cuda", source="si_mamba_tpu_torch/csrc/ssd_xbc_bwd.cu",
        replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:623", max_abs_err=err9,
        rel_err_of_max=rels, ms=time_ms(bwd, 10), device_ms=graph_ms(bwd, 10),
        plain_ms=time_ms(lambda: kssd.ssd_xbc_bwd_ref(*bwd_args), 2, warmup=1),
        library_ms=None, **tc_bound(bwd_bytes, bwd_ops)))
    log("SSD backward ok: two runs bitwise equal; " +
        ", ".join(f"{k} {v:.3e} of max" for k, v in rels.items()))
    fp32_bounds = (bound(fwd_bytes, fwd_ops), bound(fwd_bytes + hin_bytes, fwd_ops),
                   bound(bwd_bytes, bwd_ops))
    for r, (fp32_ms, fp32_by) in zip(records, fp32_bounds):
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']} at the TF32 "
            f"rate, {fp32_ms:.6f} by {fp32_by} at the fp32 rate)")
    return records, conv_shape


def _split_bounds(B, L, h, chunk, n=128, hp=128):
    """(forward ops by variant, forward bytes by variant, backward ops by
    seed, backward bytes by seed) of the split core at these shapes: the
    products the function needs, lower triangles only, nothing whose operand
    is zero (as K8/K9's bounds), with no D terms."""
    nc, q, d = L // chunk, chunk, h * hp
    tri = q * (q + 1)  # 2 * q(q+1)/2: the multiply-adds of a triangle, per unit of k
    state = 2 * q * n * hp  # one (q, n, p) product
    # C h_in in every chunk but the first (its h_in is 0); the carry
    # B^T (dt x T_end) in every chunk but the last, unless h_fin is read
    fwd_ops = {hfin: B * (nc * (tri * n + h * tri * hp)
                          + h * state * ((nc - 1) + (nc if hfin else nc - 1)))
               for hfin in (False, True)}
    base = (B * L * d + 2 * B * L * n + 2 * B * h * L + B * L * d) * 4  # x, B, C, dt, S in; y out
    hin_bytes, hfin_bytes = B * nc * h * n * hp * 4, B * h * n * hp * 4
    fwd_bytes = {(st, hf): base + (hin_bytes if st else 0) + (hfin_bytes if hf else 0)
                 for st in (False, True) for hf in (False, True)}
    # per head GM^T dy and dy (dt x)^T, once dG B and dG^T C and G; dy h_in^T
    # and the carry (C E)^T dy in every chunk but the first; B dh and
    # (dt x T_end) dh^T in every chunk but the last, unless seeded
    bwd_ops = {seed: B * (nc * (3 * tri * n + h * 2 * tri * hp)
                          + h * 2 * state * (nc - 1) + h * 2 * state * (nc if seed else nc - 1))
               for seed in (False, True)}
    bwd_base = (3 * B * L * d + 4 * B * L * n + 4 * B * h * L) * 4 + hin_bytes
    bwd_bytes = {seed: bwd_base + (hfin_bytes if seed else 0) for seed in (False, True)}
    return fwd_ops, fwd_bytes, bwd_ops, bwd_bytes


def _split_operands(device, heads: int, batch: int = 32, chunk: int = MODELNET40_SSD["ssd_chunk"],
                    dtype=torch.float32):
    """The split core's operands at B=batch, L=512 as the mixers make them
    (dt and S cut into chunks of ``chunk``, the SSD classifier's 256 unless
    given), at the activation ``dtype`` (bf16: as the bf16 mixers make them,
    matmul weights cast to bf16, the conv kernels on the fp32 conv weights of
    the full mixer and on the bf16-rounded ones of the tensor-parallel one,
    dt fp32 from the fp32 dt_raw). For
    3 heads (the tensor-parallel shard at TP = 2): x the x conv's output and
    B, C the two halves of the B|C conv's output (row stride 256), from rank
    0's shard of layer 0's SSD mixer; for 6 heads: x, B and C the column
    groups of the full mixer's (x|B|C) conv output (row stride 1024), with
    that xbc for K8/K9. Returns (x, dt, S, B, C, xbc or None, D, chunk)."""
    from si_mamba_tpu_torch.models.layers import SSDMixer
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.parallel.tensor_parallel import shard_ssd_mixer_params

    depth = MODELNET40["depth"]
    mixer = SSDMixer(MODELNET40["trans_dim"], out_proj_div=depth ** 0.5,
                     chunk=MODELNET40_SSD["ssd_chunk"])
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    full = {k: v.detach().to(device) for k, v in mixer.params().items()}
    d, n = mixer.d_inner, mixer.d_state
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, 512, MODELNET40["trans_dim"]), dtype=np.float32)).to(device, dtype)

    def wc(w):  # a matmul weight at the activation dtype
        return w.to(dtype)

    if heads == mixer.n_heads:
        zxbcdt = u @ wc(full["in_proj_w"])
        xbc = kc.causal_conv1d_silu_fwd(zxbcdt[..., d:2 * d + 2 * n], full["conv_w"],
                                        full["conv_b"])
        x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
        dt = F.softplus(zxbcdt[..., 2 * d + 2 * n:].float() + full["dt_bias"])
        A, D = -torch.exp(full["A_log"]), full["D"]
    else:
        p = shard_ssd_mixer_params(full, 0, mixer.n_heads // heads, n_heads=mixer.n_heads,
                                   d_state=n)
        x = kc.causal_conv1d_silu_fwd(u @ wc(p["in_proj_x"]), wc(p["conv_x_w"]).float(),
                                      wc(p["conv_x_b"]).float())
        bc = kc.causal_conv1d_silu_fwd(u @ wc(p["in_proj_bc"]), wc(p["conv_bc_w"]).float(),
                                       wc(p["conv_bc_b"]).float())
        Bm, Cm, xbc = bc[..., :n], bc[..., n:], None
        dt = F.softplus((u @ wc(p["in_proj_dt"])).float() + p["dt_bias"])
        A, D = -torch.exp(p["A_log"]), p["D"]
    B, L, h = dt.shape
    dth = dt.transpose(1, 2).reshape(B, h, L // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    return x, dth, S, Bm, Cm, xbc, D, chunk


SPLIT_FWD = (("ssd_split_fwd", False, False), ("ssd_split_fwd_states", True, False),
             ("ssd_split_fwd_hfin", False, True), ("ssd_split_fwd_states_hfin", True, True))
SPLIT_BWD = (("ssd_split_bwd", False), ("ssd_split_bwd_seeded", True))


def _hold_split_kernels(args, dy, dh_fin) -> tuple[dict, torch.Tensor]:
    """Every K6 and K7 variant once on ``args`` (x, dt, S, B, C, chunk), each
    against its plain version: the four forwards give the same y, and y, h_in
    and h_fin lie within 1e-4 of the plain version's max; both backwards (from
    0, and seeded with ``dh_fin``) for the output gradient ``dy`` run twice,
    bitwise equal, each gradient within 1e-4 of its max. Returns
    {name: (max |diff|, {output: its max |diff| over its max})} and K6's h_in."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    chunk = args[-1]
    y_ref, h_ref, hf_ref = kssd.ssd_split_fwd_ref(*args, emit_states=True, emit_hfin=True)
    y_lean = kssd.ssd_split_fwd(*args)
    errors, h_in = {}, None
    for name, states, hfin in SPLIT_FWD:
        out = getattr(kssd, name)(*args)
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        if not torch.equal(out[0], y_lean):
            raise AssertionError(f"{name}'s y differs from the lean forward's at chunk {chunk}: "
                                 f"max |diff| {(out[0] - y_lean).abs().max().item()}")
        errs = {"y": _rel_err(out[0], y_ref)}
        if states:
            errs["h_in"] = _rel_err(out[1], h_ref)
            h_in = out[1]
        if hfin:
            errs["h_fin"] = _rel_err(out[-1], hf_ref)
        errors[name] = errs
    for name, seeded in SPLIT_BWD:
        seed = dh_fin if seeded else None
        bwd_args = (*args[:5], h_in, dy) + ((seed,) if seeded else ()) + (chunk,)
        fn = getattr(kssd, name)
        got, again = fn(*bwd_args), fn(*bwd_args)
        want = kssd.ssd_split_bwd_ref(*args[:5], h_in, dy, chunk, dh_fin=seed)
        torch.cuda.synchronize()
        errors[name] = {}
        for key, a, a2, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, again, want):
            if not torch.equal(a, a2):
                raise AssertionError(f"{name}: {key} differs between two runs at chunk {chunk}")
            errors[name][key] = _rel_err(a, w)
    for name, errs in errors.items():
        for key, (err, rel) in errs.items():
            if rel > 1e-4:
                raise AssertionError(f"{name} at chunk {chunk}: {key} disagrees with the plain "
                                     f"version: max |diff| {err} ({rel:.3e} of max)")
    return {name: (max(e for e, _ in errs.values()), {k: r for k, (_, r) in errs.items()})
            for name, errs in errors.items()}, h_in


def split_kernel_phase(device) -> list[dict]:
    """K6 (lean, with states, with h_fin, with both) and K7 (from 0 and
    seeded with a dh_fin) at the tensor-parallel shard's shapes (B=32, L=512,
    chunk 256, 3 heads of 128, d_state 128; x, B and C strided as
    ``ssd_mixer_tp`` makes them), each against its plain version and timed
    beside it as back-to-back calls and as CUDA-graph device time; every
    variant held again at chunk 128 (4 chunks, so the carry launches run);
    then K6 lean and K7 at 6 heads on the full mixer's column groups, beside
    K8 and K9 on the same xbc."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    x, dth, S, Bm, Cm, _, _, chunk = _split_operands(device, heads=3)
    B, L, d = x.shape
    h = dth.shape[1]
    args = (x, dth, S, Bm, Cm, chunk)
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal((B, L, d), dtype=np.float32)).to(device)
    dh_fin = torch.from_numpy(0.1 * rng.standard_normal((B, h, 128, 128),
                                                        dtype=np.float32)).to(device)
    held, h_in = _hold_split_kernels(args, dy, dh_fin)
    x4, dth4, S4, B4, C4, *_ = _split_operands(device, heads=3, chunk=128)
    held4, _ = _hold_split_kernels((x4, dth4, S4, B4, C4, 128), dy, dh_fin)
    log(f"split SSD kernels ok at {h} heads, chunk {chunk} and 128: the four forwards give the "
        f"same y, two runs of each backward bitwise equal; of the max at chunk {chunk}: " +
        "; ".join(f"{k} {v[1]}" for k, v in held.items()) + "; at chunk 128: " +
        "; ".join(f"{k} {v[1]}" for k, v in held4.items()))

    fwd_ops, fwd_bytes, bwd_ops, bwd_bytes = _split_bounds(B, L, h, chunk)
    calls = {name: (lambda fn=getattr(kssd, name): fn(*args)) for name, *_ in SPLIT_FWD}
    plains = {name: (lambda st=st, hf=hf: kssd.ssd_split_fwd_ref(*args, emit_states=st,
                                                                 emit_hfin=hf))
              for name, st, hf in SPLIT_FWD}
    work = {name: (fwd_bytes[(st, hf)], fwd_ops[hf]) for name, st, hf in SPLIT_FWD}
    for name, seeded in SPLIT_BWD:
        extra = (dh_fin,) if seeded else ()
        calls[name] = lambda fn=getattr(kssd, name), extra=extra: fn(
            x, dth, S, Bm, Cm, h_in, dy, *extra, chunk)
        plains[name] = lambda seed=dh_fin if seeded else None: kssd.ssd_split_bwd_ref(
            x, dth, S, Bm, Cm, h_in, dy, chunk, dh_fin=seed)
        work[name] = (bwd_bytes[seeded], bwd_ops[seeded])
    records = []
    for name, call in calls.items():
        fwd = "fwd" in name
        records.append(dict(
            name=name, route="cuda",
            source="si_mamba_tpu_torch/csrc/ssd_xbc_" + ("fwd.cu" if fwd else "bwd.cu"),
            replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:" + ("119" if fwd else "216"),
            shape=dict(B=B, L=L, heads=h, chunk=chunk, x_row_stride=x.stride(1),
                       bc_row_stride=Bm.stride(1)),
            max_abs_err=held[name][0], rel_err_of_max=held[name][1],
            rel_err_of_max_at_chunk_128=held4[name][1],
            ms=time_ms(call, 20 if fwd else 10), device_ms=graph_ms(call, 20 if fwd else 10),
            plain_ms=time_ms(plains[name], 3 if fwd else 2, warmup=1),
            library_ms=None, **tc_bound(*work[name])))

    # K6 lean and K7 at 6 heads, beside K8 and K9 on the same (x|B|C) block
    x6, dth6, S6, B6, C6, xbc, D, _ = _split_operands(device, heads=6)
    dy6 = torch.from_numpy(rng.standard_normal((B, L, x6.shape[-1]), dtype=np.float32)).to(device)
    _, h_in6 = kssd.ssd_split_fwd_states(x6, dth6, S6, B6, C6, chunk)
    _, h_in8 = kssd.ssd_xbc_fwd_states(xbc, dth6, S6, D, x6.shape[-1], chunk)
    six = {"ssd_split_fwd_ms": time_ms(lambda: kssd.ssd_split_fwd(x6, dth6, S6, B6, C6, chunk),
                                       20),
           "ssd_xbc_fwd_ms": time_ms(lambda: kssd.ssd_xbc_fwd(xbc, dth6, S6, D, x6.shape[-1],
                                                              chunk), 20),
           "ssd_split_bwd_ms": time_ms(lambda: kssd.ssd_split_bwd(x6, dth6, S6, B6, C6, h_in6,
                                                                  dy6, chunk), 10),
           "ssd_xbc_bwd_ms": time_ms(lambda: kssd.ssd_xbc_bwd(xbc, dth6, S6, D, h_in8, dy6,
                                                              x6.shape[-1], chunk), 10)}
    for r in records:
        r["at_6_heads"] = six
        fp32_ms, fp32_by = bound(*work[r["name"]])
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']} at the TF32 "
            f"rate, {fp32_ms:.6f} by {fp32_by} at the fp32 rate)")
    log("at 6 heads (the full mixer's x|B|C block): " +
        ", ".join(f"{k} {v:.6f}" for k, v in six.items()))
    return records


def bf16_tc_bound(bytes_moved: float, bf16_ops: float, tf32x3_ops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a bf16 SSD kernel: the bytes over the
    HBM rate, or its bf16 products at the dense bf16 tensor-core peak plus the
    fp32 products it keeps as 3xTF32 (three TF32 products each) at the dense
    TF32 peak, whichever is longer."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (bf16_ops / BF16_OPS_PER_S + 3 * tf32x3_ops / TF32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
                else "operations")


def _ssd_bf16_work(B, L, h, chunk, n=128, hp=128, d_skip=False, elem=2):
    """The bf16 SSD kernels' work at these shapes, products the function needs
    (lower triangles only, nothing whose operand is 0; as ``_split_bounds``):
    {variant: (bytes, bf16 products' ops, 3xTF32 products' ops)} for the
    forward by (states, h_fin) and the backward by seed, bf16 activations at
    2 bytes (``elem``: 4 for the fp32 kernels' bytes), everything else fp32.
    At bf16 every forward product takes bf16 operands; the backward keeps
    fp32 (3xTF32) for dG B and dG^T C, the carry (C E)^T dy, B dh and
    (dt x) dh^T, and takes bf16 operands for G, GM^T dy, dy (dt x)^T and
    dy h_in^T. ``d_skip``: K8/K9's D terms (D read, dD written)."""
    nc, q, d = L // chunk, chunk, h * hp
    tri = q * (q + 1)
    state = 2 * q * n * hp
    hin, hfin = B * nc * h * n * hp * 4, B * h * n * hp * 4
    act = (2 * B * L * d + 2 * B * L * n) * elem  # x, B, C in, y out
    small = 2 * B * h * L * 4 + (h * 4 if d_skip else 0)  # dt, S (and D)
    fwd = {}
    for st in (False, True):
        for hf in (False, True):
            ops = B * (nc * (tri * n + h * tri * hp)
                       + h * state * ((nc - 1) + (nc if hf else nc - 1)))
            fwd[(st, hf)] = (act + small + (hin if st else 0) + (hfin if hf else 0), ops, 0)
    bwd = {}
    for seed in (False, True):
        bf16 = B * (nc * (tri * n + 2 * h * tri * hp) + (nc - 1) * h * state)
        tf32 = B * (nc * 2 * tri * n + (nc - 1) * h * state
                    + (nc if seed else nc - 1) * h * 2 * state)
        moved = ((3 * B * L * d + 4 * B * L * n) * elem + 4 * B * h * L * 4 + hin
                 + (hfin if seed else 0) + (2 * h * 4 if d_skip else 0))
        bwd[seed] = (moved, bf16, tf32)
    return fwd, bwd


def bf16_conv_figures(x, w, b, g) -> tuple[dict, dict]:
    """The bf16 K1 and K5 on the bf16 view x (B, L, C) and output gradient g,
    each held against its plain version (a bf16 output within one bf16 ulp at
    a floor of 1e-2 of its max, dw and db within 1e-4 of their max; K5 run
    twice, bitwise equal) and timed beside it and beside bf16
    ``F.conv1d(groups=C)`` + ``F.silu`` (K5: its autograd backward), with its
    plan and its bound (bf16 bytes, fp32 operations)."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    B, L, C = x.shape
    W = w.shape[1]
    where = f"bf16 width {C}, row stride {x.stride(1)}"
    y = kc.causal_conv1d_silu_bf16(x, w, b)
    ulps = _bf16_ulps(y, kc.causal_conv1d_ref(x, w, b), 1e-2)
    if ulps > 1:
        raise AssertionError(f"bf16 conv forward at {where}: {ulps:.2f} ulps from its plain "
                             f"version")
    xt, w3, b16 = x.transpose(1, 2), w.to(torch.bfloat16)[:, None, :], b.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bound_ms, bound_by = conv_fwd_bound(B, L, C, W, 2)
    fwd = dict(shape=[B, L, C], row_stride=x.stride(1), plan=asdict(kc.fwd_plan(x, sms)),
               max_abs_err=(y.float() - kc.causal_conv1d_ref(x, w, b).float()).abs().max().item(),
               ms=time_ms(lambda: kc.causal_conv1d_silu_bf16(x, w, b), 50),
               device_ms=graph_ms(lambda: kc.causal_conv1d_silu_bf16(x, w, b), 20),
               plain_ms=time_ms(lambda: kc.causal_conv1d_ref(x, w, b), 20),
               library_ms=time_ms(lambda: F.silu(F.conv1d(xt, w3, b16, padding=W - 1,
                                                          groups=C)[..., :L]), 20),
               bound_ms=bound_ms, bound_by=bound_by)
    args = (x, w, b, g)
    got, again = kc.causal_conv1d_silu_bwd_bf16(*args), kc.causal_conv1d_silu_bwd_bf16(*args)
    want = kc.causal_conv1d_silu_bwd_ref(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"two bf16 conv backward runs at {where} differ")
    if _bf16_ulps(got[0], want[0], 1e-2) > 1 or max(_rel_err(a, r)[1] for a, r in
                                                    zip(got[1:], want[1:])) > 1e-4:
        raise AssertionError(f"bf16 conv backward at {where} disagrees with its plain version")
    plan = kc.bwd_plan(x, g, W, sms)
    x_lib = xt.detach().requires_grad_()
    w_lib, b_lib = (t.detach().clone().requires_grad_() for t in (w3, b16))
    y_lib = F.silu(F.conv1d(x_lib, w_lib, b_lib, padding=W - 1, groups=C)[..., :L])
    bound_ms, bound_by = bound(3 * B * L * C * 2 + 2 * C * (W + 1) * 4, B * L * C * (6 * W + 11))
    bwd = dict(shape=[B, L, C], row_stride=x.stride(1),
               plan=dict(vx=plan.vx, vg=plan.vg, tile=plan.tile),
               max_abs_err=max((a.float() - r.float()).abs().max().item()
                               for a, r in zip(got, want)),
               ms=time_ms(lambda: kc.causal_conv1d_silu_bwd_bf16(*args), 50),
               device_ms=graph_ms(lambda: kc.causal_conv1d_silu_bwd_bf16(*args), 20),
               plain_ms=time_ms(lambda: kc.causal_conv1d_silu_bwd_ref(*args), 10),
               library_ms=time_ms(lambda: torch.autograd.grad(
                   y_lib, (x_lib, w_lib, b_lib), g.transpose(1, 2), retain_graph=True), 20),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"bf16 conv at {where}: forward {fwd['ms']:.6f} ms, device {fwd['device_ms']:.6f} ms "
        f"(plan {fwd['plan']}, bound {fwd['bound_ms']:.6f}, library "
        f"{fwd['library_ms']:.6f}); backward "
        f"{bwd['ms']:.6f} ms, device {bwd['device_ms']:.6f} ms (plan {bwd['plan']}, bound "
        f"{bwd['bound_ms']:.6f}), two runs bitwise equal")
    return fwd, bwd


def _hold_bf16(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The bf16 SSD kernels' tolerances against their plain versions: a bf16
    output within 2 bf16 ulps at a floor of 2e-2 of its max, an fp32 output
    (states, h_fin, ddt, dS, dD) within 1e-3 of its max. Returns max |diff|."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against the plain "
                             f"version's {want.dtype} {tuple(want.shape)}")
    if got.dtype == torch.bfloat16:
        err = _bf16_ulps(got, want, 2e-2)
        if err > 2:
            raise AssertionError(f"{name}: {err:.2f} bf16 ulps from the plain version")
    elif _rel_err(got, want)[1] > 1e-3:
        raise AssertionError(f"{name}: {_rel_err(got, want)} from the plain version")
    return (got.float() - want.float()).abs().max().item()


def _hold_split_bf16(sargs, dy, dh_fin) -> tuple[dict, dict, dict]:
    """Every bf16 K6 and K7 variant on ``sargs`` (x, dt, S, B, C, chunk),
    each held against its plain version at bf16 (``_hold_bf16``): the four
    forwards give the same y; both backwards (from 0, and seeded with
    ``dh_fin``) for the output gradient ``dy`` on the forward's h_in run
    twice, bitwise equal. Returns ({name: max |diff|}, {name: the kernel's
    call}, {name: its plain version's call}), by the fp32 kernel's name."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    x, dth, S, Bm, Cm, chunk = sargs
    y_ref, h_ref, hf_ref = kssd.ssd_split_fwd_ref(*sargs, emit_states=True, emit_hfin=True)
    y_lean = kssd.ssd_split_fwd_bf16(*sargs)
    errs, calls, plains, h_in = {}, {}, {}, None
    where = f"{dth.shape[1]} heads, L {x.shape[1]}, chunk {chunk}"
    for name, states, hfin in SPLIT_FWD:
        fn = getattr(kssd, name + "_bf16")
        out = fn(*sargs)
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        if not torch.equal(out[0], y_lean):
            raise AssertionError(f"{name}_bf16's y differs from the lean forward's at {where}")
        err = _hold_bf16(f"{name}_bf16 y at {where}", out[0], y_ref)
        if states:
            h_in = out[1]
            err = max(err, _hold_bf16(f"{name}_bf16 h_in at {where}", out[1], h_ref))
        if hfin:
            err = max(err, _hold_bf16(f"{name}_bf16 h_fin at {where}", out[-1], hf_ref))
        errs[name] = err
        calls[name] = lambda fn=fn: fn(*sargs)
        plains[name] = lambda st=states, hf=hfin: kssd.ssd_split_fwd_ref(
            *sargs, emit_states=st, emit_hfin=hf)
    for name, seeded in SPLIT_BWD:
        fn = getattr(kssd, name + "_bf16")
        call = (lambda fn=fn, extra=(dh_fin,) if seeded else (): fn(
            x, dth, S, Bm, Cm, h_in, dy, *extra, chunk))
        got, again = call(), call()
        want = kssd.ssd_split_bwd_ref(x, dth, S, Bm, Cm, h_in, dy, chunk,
                                      dh_fin=dh_fin if seeded else None)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"two {name}_bf16 runs on the same inputs differ at {where}")
        errs[name] = max(_hold_bf16(f"{name}_bf16 {k} at {where}", a, w) for k, a, w in
                         zip(("dx", "ddt", "dS", "dB", "dC"), got, want))
        calls[name] = call
        plains[name] = lambda seed=dh_fin if seeded else None: kssd.ssd_split_bwd_ref(
            x, dth, S, Bm, Cm, h_in, dy, chunk, dh_fin=seed)
    return errs, calls, plains


KEEP_FIGURES = ("shape", "row_stride", "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "plan", "kernel_err_of_max", "plain_err_of_max",
                "ulps_from_plain")  # a kernel's figures at one more shape


def _keep(figures: dict) -> dict:
    return {k: v for k, v in figures.items() if k in KEEP_FIGURES}


def _hold_bf16_truth(name: str, got: torch.Tensor, want: torch.Tensor,
                     truth: torch.Tensor) -> dict:
    """A bf16 output of a bf16 SSD kernel at the pretraining shapes, held
    against the fp64 truth (the plain version's arithmetic in float64 on the
    same bf16 inputs): its largest error must not exceed the plain version's
    by more than 1 % (plus 1e-6 of max|truth|). At B=128 the two sit on
    either side of a rounding boundary at single elements (3 bf16 ulps of the
    2e-2 floor apart at one of 33.5 M elements of K9's dxbc, each 3.0e-3 of
    max from the truth), which ``_hold_bf16``'s two ulps would call a fault;
    the distance in ulps is recorded. The reverse also occurs: the kernel's
    fp32 sums run in another order than the plain version's, so a rounded
    intermediate (bf16 dG, x dt) can fall on the other side of its boundary
    and carry one output element one rounding step past the plain version's
    largest error (K7's dB at the TP path's operands, one element). So an
    element beyond that bound passes if it is faithfully rounded: within one
    bf16 ulp of the truth, the correctly rounded value or its neighbour; such
    elements are counted (``faithful_flips``) and logged. Returns the
    figures."""
    got, want, truth = got.double(), want.double(), truth.double()
    scale = truth.abs().max().item()
    err = (got - truth).abs()
    err_k, err_p = err.max().item(), (want - truth).abs().max().item()
    beyond = err > 1.01 * err_p + 1e-6 * scale
    flips = int(beyond.sum().item())
    if flips:
        ulp = torch.exp2(torch.floor(torch.log2(truth[beyond].abs().clamp_min(1e-30))) - 7)
        if not bool((err[beyond] <= ulp).all()):
            raise AssertionError(f"{name}: {err_k / scale:.3e} of max from the fp64 truth, the "
                                 f"plain version {err_p / scale:.3e}; not faithfully rounded")
        worst = int(err.argmax().item())
        log(f"{name}: {flips} element(s) past the plain version's largest error, each within "
            f"one ulp of the truth: {err_k / scale:.4e} of max against {err_p / scale:.4e}; the "
            f"worst {got.flatten()[worst].item()!r}, the plain version "
            f"{want.flatten()[worst].item()!r}, the truth {truth.flatten()[worst].item()!r}")
    return dict(kernel_err_of_max=err_k / scale, plain_err_of_max=err_p / scale,
                faithful_flips=flips, ulps_from_plain=_bf16_ulps(got, want, 2e-2),
                max_abs_err=(got - want).abs().max().item())  # from the plain version


def _f64(args):
    return tuple(a.double() if torch.is_tensor(a) else a for a in args)


def ssd_bf16_inputs(device, batch: int, length: int, chunk: int, seed: int):
    """Layer 0's bf16 SSD mixer's kernel inputs at B=batch, L=length: its
    parameters on ``device`` and the bf16 in_proj output x @ in_proj of seeded
    x. Returns (the mixer, its parameters, zxbcdt (B, L, 1798))."""
    from si_mamba_tpu_torch.models.layers import SSDMixer

    mixer = SSDMixer(MODELNET40["trans_dim"], out_proj_div=MODELNET40["depth"] ** 0.5,
                     chunk=chunk)
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    u = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, length, MODELNET40["trans_dim"]), dtype=np.float32)).to(device, torch.bfloat16)
    return mixer, p, u @ p["in_proj_w"].to(torch.bfloat16)


def ssd_xbc_bf16_figures(args, length: int, truth: bool, train: bool = True,
                         infer: bool = True) -> dict:
    """The bf16 K8/K9 on ``args`` (xbc, dt, S, D, d_inner, chunk; xbc's rows
    from ``length`` on the mixer's padding): with ``infer`` the lean K8, with
    ``train`` K8 with states (its y equal to the lean y) and K9 (twice,
    bitwise equal, for a seeded cotangent that is 0 on the padding; a planted
    fault, its ddt scaled by 1.05, must fail the hold), each timed beside its
    plain version and held: K8's y and K9's dxbc with ``truth`` against the
    fp64 truth (``_hold_bf16_truth``), else within 2 bf16 ulps of the plain
    version; the fp32 outputs within 1e-3 of their max (``_hold_bf16``).
    Returns {kernel name: figures}, each name with the variant that ran it
    (``kssd.kernel_variant``: '_sm90', the Hopper bf16 body, at the chunks it
    serves)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    xbc, dth, S, D, d, chunk = args
    batch, L = xbc.shape[:2]
    variant = kssd.kernel_variant(chunk, (xbc.shape[-1] - d) // 2, d // dth.shape[1], xbc.dtype)

    def named(entry):
        return kssd._variant_name(entry + "_bf16", variant)

    fwd_work, bwd_work = _ssd_bf16_work(batch, L, dth.shape[1], chunk, d_skip=True)
    where = f"B={batch}, L={L}"
    out = {}

    def hold(name, got, want, exact):
        if truth:
            return _hold_bf16_truth(f"{name} at {where}", got, want, exact())
        return dict(max_abs_err=_hold_bf16(f"{name} at {where}", got, want))

    def figures(fn, plain, held, work, iters, err=0.0):
        return dict(shape=list(xbc.shape), ms=time_ms(fn, iters), device_ms=graph_ms(fn, iters),
                    plain_ms=time_ms(plain, 2, warmup=1), library_ms=None,
                    **bf16_tc_bound(*work),
                    **{**held, "max_abs_err": max(err, held["max_abs_err"])})

    def y_truth():
        return kssd.ssd_xbc_fwd_ref(*_f64(args))[0]

    if infer:
        y_lean = kssd.ssd_xbc_fwd_bf16(*args)
        held = hold("bf16 K8 y", y_lean, kssd.ssd_xbc_fwd_ref(*args)[0], y_truth)
        out[named("ssd_xbc_fwd")] = figures(lambda: kssd.ssd_xbc_fwd_bf16(*args),
                                          lambda: kssd.ssd_xbc_fwd_ref(*args), held,
                                          fwd_work[(False, False)], 20)
    if not train:
        return out
    y8, h_in = kssd.ssd_xbc_fwd_states_bf16(*args)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True)
    torch.cuda.synchronize()
    if infer and not torch.equal(y8, y_lean):
        raise AssertionError(f"the bf16 SSD forward with states differs from the lean one at "
                             f"{where}")
    held = hold("bf16 K8 y", y8, y_ref, y_truth)
    err_h = _hold_bf16(f"bf16 K8 h_in at {where}", h_in, h_ref)
    out[named("ssd_xbc_fwd_states")] = figures(
        lambda: kssd.ssd_xbc_fwd_states_bf16(*args),
        lambda: kssd.ssd_xbc_fwd_ref(*args, emit_states=True), held, fwd_work[(True, False)],
        20, err_h)
    dy = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (batch, L, d), dtype=np.float32)).to(xbc.device, torch.bfloat16)
    dy[:, length:] = 0  # the padded rows' cotangent, as the mixer's slice y[:, :l] gives
    bwd_args = (xbc, dth, S, D, h_in, dy, d, chunk)
    got, again = kssd.ssd_xbc_bwd_bf16(*bwd_args), kssd.ssd_xbc_bwd_bf16(*bwd_args)
    want = kssd.ssd_xbc_bwd_ref(*bwd_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"two bf16 SSD backward runs at {where} differ")
    held = hold("bf16 K9 dxbc", got[0], want[0],
                lambda: kssd.ssd_xbc_bwd_ref(*_f64(bwd_args))[0])
    err9 = max(_hold_bf16(f"bf16 K9 {k} at {where}", a, w)
               for k, a, w in zip(("ddt", "dS", "dD"), got[1:], want[1:]))
    try:  # a planted fault: K9's ddt scaled by 1.05 must fail its hold
        _hold_bf16(f"bf16 K9's ddt scaled by 1.05 at {where}", got[1] * 1.05, want[1])
    except AssertionError:
        pass
    else:
        raise AssertionError(f"the bf16 K9 hold passes a planted fault in ddt at {where}")
    out[named("ssd_xbc_bwd")] = figures(lambda: kssd.ssd_xbc_bwd_bf16(*bwd_args),
                                      lambda: kssd.ssd_xbc_bwd_ref(*bwd_args), held,
                                      bwd_work[False], 10, err9)
    return out


def ssd_bf16_at(device, batch: int, length: int, chunk: int, train: bool = True,
                infer: bool = True) -> dict:
    """The bf16 SSD preset's kernels as layer 0's bf16 SSD mixer makes their
    inputs at B=batch, L=length (``ssd_bf16_inputs``): the bf16 K1 (and with
    ``train`` K5) on the (x|B|C) column view at L, held as
    ``bf16_conv_figures`` holds them, then on K1's output padded to a chunk
    multiple (as the mixer pads) the bf16 K8/K9 of ``ssd_xbc_bf16_figures``
    (``train``, ``infer``), their bf16 outputs held against the fp64 truth.
    Returns {kernel name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    mixer, p, zxbcdt = ssd_bf16_inputs(device, batch, length, chunk, 40)
    d, n, h = mixer.d_inner, mixer.d_state, mixer.n_heads
    xbc_in = zxbcdt[..., d:2 * d + 2 * n]
    out = {}
    if train:
        g = torch.from_numpy(np.random.default_rng(41).standard_normal(
            xbc_in.shape, dtype=np.float32)).to(device, torch.bfloat16)
        fwd, bwd = bf16_conv_figures(xbc_in, p["conv_w"], p["conv_b"], g)
        out["causal_conv1d_silu_bf16"] = _keep(fwd)
        out["causal_conv1d_silu_bwd_bf16"] = _keep(bwd)
    else:
        conv = lambda: kc.causal_conv1d_silu_bf16(xbc_in, p["conv_w"], p["conv_b"])  # noqa: E731
        plain = lambda: kc.causal_conv1d_ref(xbc_in, p["conv_w"], p["conv_b"])  # noqa: E731
        y, y_ref = conv(), plain()
        if _bf16_ulps(y, y_ref, 1e-2) > 1:
            raise AssertionError(f"bf16 K1 at B={batch}, L={length} is more than one ulp off")
        bound_ms, bound_by = conv_fwd_bound(batch, length, xbc_in.shape[-1], 4, 2)
        out["causal_conv1d_silu_bf16"] = dict(
            shape=[batch, length, xbc_in.shape[-1]], row_stride=xbc_in.stride(1),
            max_abs_err=(y.float() - y_ref.float()).abs().max().item(), ms=time_ms(conv, 20),
            device_ms=graph_ms(conv, 20), plain_ms=time_ms(plain, 5), library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by)
    y = kc.causal_conv1d_silu_bf16(xbc_in, p["conv_w"], p["conv_b"])
    pad = (-length) % chunk
    L = length + pad
    xbc = F.pad(y, (0, 0, 0, pad))
    dt = F.pad(F.softplus(zxbcdt[..., 2 * d + 2 * n:].float() + p["dt_bias"]), (0, 0, 0, pad))
    dth = dt.transpose(1, 2).reshape(batch, h, L // chunk, chunk).contiguous()
    S = torch.cumsum(dth * -torch.exp(p["A_log"])[None, :, None, None], dim=-1)
    return out | ssd_xbc_bf16_figures((xbc, dth, S, p["D"], d, chunk), length, truth=True,
                                      train=train, infer=infer)


def ssd_bf16_kernel_phase(device) -> tuple[list[dict], dict]:
    """The SSD presets' kernels at bf16, as layer 0's bf16 SSD mixer makes
    their inputs at B=32, L=512 (x @ in_proj in bf16): the bf16 K1 and K5 at
    width 1024 on the column view of the (32, 512, 1798) in_proj output (row
    stride 1798: 3596-byte rows, not 16-byte aligned) and at the tensor-
    parallel step's two contiguous operands (the 384-wide x shard, the
    256-wide B|C); then the bf16 K8 (lean, also at B = 1, 20 and 64, and with
    states) and K9 (``ssd_xbc_bf16_figures``, a bf16 output within 2 bf16
    ulps of the plain version's), and the bf16 K6 (lean, with states, with
    h_fin, with both; the same y from each) and K7 (from 0 and seeded, each
    twice, bitwise equal) at the tensor-parallel shard (3 heads) and at the
    sequence-parallel path's shapes (SP_SHAPE: a rank's 256 rows, 6 heads,
    chunk 128; ``at_sp_shape``), each held against its plain version at bf16
    (``_hold_bf16``) and timed beside it, with ``bound_ms`` from
    ``bf16_tc_bound``. Returns (the K6-K9 records, the bf16 K1/K5 figures by
    kernel name and operand)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    bf = torch.bfloat16
    B, L = TRAIN_BATCH, 512
    # K1 and K5 at the SSD view and at the tensor-parallel operands
    mixer, p, zxbcdt = ssd_bf16_inputs(device, B, L, MODELNET40_SSD["ssd_chunk"], 14)
    d, n = mixer.d_inner, mixer.d_state
    rng = np.random.default_rng(15)
    conv = {"causal_conv1d_silu_bf16": {}, "causal_conv1d_silu_bwd_bf16": {}}
    views = {"ssd_view": (zxbcdt[..., d:2 * d + 2 * n], p["conv_w"], p["conv_b"])}
    for what, C in (("x_shard", d // TP), ("bc", 2 * n)):
        views[what] = (torch.from_numpy(rng.standard_normal((B, L, C), dtype=np.float32))
                       .to(device, bf),
                       torch.from_numpy((rng.standard_normal((C, 4)) * 0.5).astype(np.float32))
                       .to(device, bf).float(),
                       torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
                       .to(device, bf).float())
    for what, (x, w, b) in views.items():
        g = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32)).to(device, bf)
        fwd, bwd = bf16_conv_figures(x, w, b, g)
        conv["causal_conv1d_silu_bf16"][what] = fwd
        conv["causal_conv1d_silu_bwd_bf16"][what] = bwd

    def meta(name):
        fwd = "fwd" in name
        source = ("ssd_xbc_bf16_sm90.cu" if "_sm90" in name else
                  "ssd_xbc_" + ("fwd.cu" if fwd else "bwd.cu"))
        return dict(name=name, route="cuda", dtype="bfloat16",
                    source="si_mamba_tpu_torch/csrc/" + source,
                    replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:" + (
                        ("540" if fwd else "623") if name.startswith("ssd_xbc") else
                        ("119" if fwd else "216")))

    # K8 and K9 (the Hopper bf16 body at the preset's chunk 256, and at chunk
    # 64, the smallest it serves), then the lean K8 at the serving request sizes
    _, dth, S, _, _, xbc, D, chunk = _split_operands(device, heads=6, batch=B, dtype=bf)
    records = [meta(name) | f for name, f in ssd_xbc_bf16_figures(
        (xbc, dth, S, D, d, chunk), L, truth=False).items()]
    _, dth64, S64, _, _, xbc64, D64, _ = _split_operands(device, heads=6, batch=B, chunk=64,
                                                         dtype=bf)
    at64 = ssd_xbc_bf16_figures((xbc64, dth64, S64, D64, d, 64), L, truth=False)
    for r in records:
        r["at_chunk64"] = _keep(at64[r["name"]]) | {"chunk": 64}
    at_clouds = {}
    for batch in REQUEST_SIZES:
        a = _split_operands(device, heads=6, batch=batch, dtype=bf)
        a_args = (a[5], a[1], a[2], a[6], d, chunk)
        err = _hold_bf16(f"bf16 K8 at B={batch}", kssd.ssd_xbc_fwd_bf16(*a_args),
                         kssd.ssd_xbc_fwd_ref(*a_args)[0])
        at_clouds[batch] = dict(max_abs_err=err,
                                ms=time_ms(lambda: kssd.ssd_xbc_fwd_bf16(*a_args), 20),
                                device_ms=graph_ms(lambda: kssd.ssd_xbc_fwd_bf16(*a_args), 20))
    records[0]["at_clouds"] = at_clouds

    def record(name, fn, plain, err, work, **extra):
        fwd = "fwd" in name
        records.append(meta(name) | dict(
            max_abs_err=err, ms=time_ms(fn, 20 if fwd else 10),
            device_ms=graph_ms(fn, 20 if fwd else 10),
            plain_ms=time_ms(plain, 3 if fwd else 2, warmup=1), library_ms=None,
            **bf16_tc_bound(*work), **extra))

    # K6 and K7 at the tensor-parallel shard, and at the sequence-parallel
    # path's shapes: rank 0's 256 rows of the full mixer's 6 heads, chunk 128
    x, dth, S, Bm, Cm, _, _, chunk = _split_operands(device, heads=3, batch=B, dtype=bf)
    h = dth.shape[1]
    sargs = (x, dth, S, Bm, Cm, chunk)
    dy = torch.from_numpy(rng.standard_normal((B, L, x.shape[-1]), dtype=np.float32)).to(device, bf)
    dh_fin = torch.from_numpy(0.1 * rng.standard_normal((B, h, n, 128),
                                                        dtype=np.float32)).to(device)
    errs, calls, plains = _hold_split_bf16(sargs, dy, dh_fin)
    sp_l, sp_chunk, sp_h = SP_SHAPE["L"] // TP, SP_SHAPE["chunk"], SP_SHAPE["h"]
    x6, dth6, S6, B6, C6, *_ = _split_operands(device, heads=sp_h, batch=B, chunk=sp_chunk,
                                               dtype=bf)
    cut = sp_l // sp_chunk
    sp_args = (x6[:, :sp_l].contiguous(), dth6[:, :, :cut].contiguous(),
               S6[:, :, :cut].contiguous(), B6[:, :sp_l].contiguous(),
               C6[:, :sp_l].contiguous(), sp_chunk)
    sp_dy = torch.from_numpy(rng.standard_normal((B, sp_l, x6.shape[-1]), dtype=np.float32)
                             ).to(device, bf)
    sp_seed = torch.from_numpy(0.1 * rng.standard_normal((B, sp_h, n, 128),
                                                         dtype=np.float32)).to(device)
    sp_errs, sp_calls, _ = _hold_split_bf16(sp_args, sp_dy, sp_seed)
    sp_shape = dict(B=B, L=sp_l, heads=sp_h, chunk=sp_chunk)
    fwd_work, bwd_work = _ssd_bf16_work(B, L, h, chunk)
    sp_fwd_work, sp_bwd_work = _ssd_bf16_work(B, sp_l, sp_h, sp_chunk)
    for name, states, hfin in SPLIT_FWD:
        at_sp = dict(shape=sp_shape, max_abs_err=sp_errs[name],
                     ms=time_ms(sp_calls[name], 20), device_ms=graph_ms(sp_calls[name], 20),
                     **bf16_tc_bound(*sp_fwd_work[(states, hfin)]))
        record(name + "_bf16", calls[name], plains[name], errs[name],
               fwd_work[(states, hfin)], shape=dict(B=B, L=L, heads=h, chunk=chunk),
               at_sp_shape=at_sp)
    for name, seeded in SPLIT_BWD:
        at_sp = dict(shape=sp_shape, max_abs_err=sp_errs[name],
                     ms=time_ms(sp_calls[name], 10), device_ms=graph_ms(sp_calls[name], 10),
                     **bf16_tc_bound(*sp_bwd_work[seeded]))
        record(name + "_bf16", calls[name], plains[name], errs[name], bwd_work[seeded],
               shape=dict(B=B, L=L, heads=h, chunk=chunk), at_sp_shape=at_sp)
    for r in records:
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']}), max |diff| "
            f"{r['max_abs_err']:.3e}" + ("" if "at_sp_shape" not in r else
                                         f"; at the SP shape {r['at_sp_shape']}"))
    return records, conv


def ssd_carry_inputs(device, dtype) -> tuple:
    """The inputs of ``ssd_chunked_xbc`` at the SSD shape (B=32, L=512, width
    1024: 6 heads of 128, d_state 128, chunk 256) as layer 0's SSD mixer
    makes them at ``dtype`` (bf16: its matmul weight cast to bf16, the conv
    kernel on the fp32 conv weights): xbc the conv's output, dt (B, L, h)
    post-softplus fp32, A and D (h,) fp32. Returns (xbc, dt, A, D, d_inner,
    chunk)."""
    from si_mamba_tpu_torch.models.layers import SSDMixer
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    mixer = SSDMixer(MODELNET40["trans_dim"], out_proj_div=MODELNET40["depth"] ** 0.5,
                     chunk=MODELNET40_SSD["ssd_chunk"])
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    d, n = mixer.d_inner, mixer.d_state
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (TRAIN_BATCH, 512, MODELNET40["trans_dim"]), dtype=np.float32)).to(device, dtype)
    zxbcdt = u @ p["in_proj_w"].to(dtype)
    xbc = kc.causal_conv1d_silu_fwd(zxbcdt[..., d:2 * d + 2 * n], p["conv_w"], p["conv_b"])
    dt = F.softplus(zxbcdt[..., 2 * d + 2 * n:].float() + p["dt_bias"])
    return xbc, dt, -torch.exp(p["A_log"]), p["D"], d, mixer.chunk


CARRY = ("ssd_xbc_fwd_hfin", "ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd_seeded")


def ssd_carry_phase(device) -> tuple[list[dict], dict]:
    """K8/K9's carry entry points, fp32 and bf16, at the SSD shape
    (``ssd_carry_inputs``). First each kernel against its plain version and
    timed beside it: K8 with h_fin lean and with states (y bitwise K8's
    without the carry, the two h_fin bitwise equal) and the seeded K9 for a
    seeded output gradient and dh_fin (two runs bitwise equal); fp32: y, h_in
    and h_fin within 1e-5 of their max, every gradient within 4.5e-6 of its
    max (the K8/K9 rows' errors); bf16: a bf16 output within 2 ulps at a
    floor of 2e-2 of its max, every fp32 output within 1e-3 (h_fin too).
    ``bound_ms`` as K8/K9's: 3xTF32 products at fp32 (``tc_bound``), bf16 and
    3xTF32 ones at bf16 (``bf16_tc_bound``). Then the path that reaches them,
    ``ssd_chunked_xbc(return_carry=True)``, at each dtype with every launch
    count from 0: once without a gradient (the lean K8 with h_fin), once with
    one through a loss of y and h_fin (K8 with states and h_fin, the seeded
    K9); its y and h_fin bitwise the kernels' above, its total decay
    exp(sum of each chunk's last S), its gradients finite. At bf16 they run
    the Hopper bf16 body ('_sm90' in their record names and counts). Returns
    (the six records, {"ssd_carry": launches, "ssd_carry_bf16": launches})."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    records, paths = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        sfx = "_bf16" if bf16 else ""
        xbc, dt, A, D, d, chunk = ssd_carry_inputs(device, dtype)
        B, L, h = dt.shape
        dth = dt.transpose(1, 2).reshape(B, h, L // chunk, chunk).contiguous()
        S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
        args = (xbc, dth, S, D, d, chunk)
        rng = np.random.default_rng(15)
        dy = torch.from_numpy(rng.standard_normal((B, L, d), dtype=np.float32)).to(device, dtype)
        dh_fin = torch.from_numpy(0.1 * rng.standard_normal((B, h, 128, 128),
                                                            dtype=np.float32)).to(device)
        fwd_hfin, fwd_states_hfin, bwd_seeded = (getattr(kssd, n + sfx) for n in CARRY)
        variant = kssd.kernel_variant(chunk, 128, 128, dtype)  # '_sm90' at bf16
        named = {n: kssd._variant_name(n + sfx, variant) for n in CARRY}
        y_plain = kssd.ssd_xbc_fwd(*args)
        y_lean, hf_lean = fwd_hfin(*args)
        y, h_in, h_fin = fwd_states_hfin(*args)
        bwd_args = (xbc, dth, S, D, h_in, dy, dh_fin, d, chunk)
        got, again = bwd_seeded(*bwd_args), bwd_seeded(*bwd_args)
        y_ref, h_ref, hf_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True, emit_hfin=True)
        want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk, dh_fin=dh_fin)
        torch.cuda.synchronize()
        where = f"at {dtype}"
        for what, a, c in (("y", y_lean, y_plain), ("y", y, y_plain), ("h_fin", hf_lean, h_fin),
                           *(("backward", g1, g2) for g1, g2 in zip(got, again))):
            if not torch.equal(a, c):
                raise AssertionError(f"K8/K9 carry variants {where}: {what} not bitwise equal")

        def hold(name, a, w, rel):
            if bf16:
                return _hold_bf16(f"{name} {where}", a, w)
            err, r = _rel_err(a, w)
            if r > rel:
                raise AssertionError(f"{name} {where}: max |diff| {err} ({r:.3e} of max)")
            return err

        err_y = hold("K8 y", y, y_ref, 1e-5)
        err_hin, err_hf = hold("K8 h_in", h_in, h_ref, 1e-5), hold("K8 h_fin", h_fin, hf_ref, 1e-5)
        err9 = max(hold(f"seeded K9 {k}", a, w, 4.5e-6)
                   for k, a, w in zip(("dxbc", "ddt", "dS", "dD"), got, want))
        fwd_work, bwd_work = _ssd_bf16_work(B, L, h, chunk, d_skip=True, elem=xbc.element_size())

        def bound_of(work):
            moved, bf16_ops, tf32_ops = work
            return (bf16_tc_bound(moved, bf16_ops, tf32_ops) if bf16
                    else tc_bound(moved, bf16_ops + tf32_ops))

        calls = ((CARRY[0], lambda: fwd_hfin(*args),
                  lambda: kssd.ssd_xbc_fwd_ref(*args, emit_hfin=True), max(err_y, err_hf),
                  fwd_work[(False, True)]),
                 (CARRY[1], lambda: fwd_states_hfin(*args),
                  lambda: kssd.ssd_xbc_fwd_ref(*args, emit_states=True, emit_hfin=True),
                  max(err_y, err_hin, err_hf), fwd_work[(True, True)]),
                 (CARRY[2], lambda: bwd_seeded(*bwd_args),
                  lambda: kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk,
                                               dh_fin=dh_fin), err9, bwd_work[True]))
        for name, fn, plain, err, work in calls:
            fwd = "fwd" in name
            records.append(dict(
                name=named[name], route="cuda", dtype=str(dtype).removeprefix("torch."),
                source="si_mamba_tpu_torch/csrc/" + (
                    "ssd_xbc_bf16_sm90.cu" if variant == "_sm90" else
                    "ssd_xbc_" + ("fwd.cu" if fwd else "bwd.cu")),
                replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:" + ("602" if fwd else "698"),
                shape=dict(B=B, L=L, heads=h, chunk=chunk), max_abs_err=err,
                ms=time_ms(fn, 20 if fwd else 10), device_ms=graph_ms(fn, 20 if fwd else 10),
                plain_ms=time_ms(plain, 3 if fwd else 2, warmup=1), library_ms=None,
                **bound_of(work)))

        # the path: ssd_chunked_xbc(return_carry=True), as a caller would use it
        kw = dict(d_inner=d, chunk=chunk, return_carry=True)
        leaves = [t.detach().clone().requires_grad_() for t in (xbc, dt, A, D)]
        torch.cuda.synchronize()
        _reset_launch_counts()  # the carry path at this dtype
        with torch.no_grad():
            y0, dec0, hf0 = kssd.ssd_chunked_xbc(xbc, dt, A, D, **kw)
        y1, dec1, hf1 = kssd.ssd_chunked_xbc(*leaves, **kw)
        (y1.float().square().mean() + hf1.square().mean()).backward()
        torch.cuda.synchronize()
        path = "ssd_carry" + sfx
        paths[path] = _launch_counts()
        expect = _counts_expect({named[n]: 1 for n in CARRY}, 1)
        if paths[path] != expect:
            raise AssertionError(f"{path} launched {paths[path]}, expected {expect}")
        dec_want = torch.exp(S[..., -1].sum(-1))
        if not (torch.equal(y0, y_lean) and torch.equal(hf0, hf_lean) and torch.equal(y1, y)
                and torch.equal(hf1, h_fin) and torch.equal(dec0, dec1)
                and _rel_err(dec0, dec_want)[1] <= 1e-6):
            raise AssertionError(f"{path}: y / total_decay / h_fin differ from the kernels'")
        if not all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in leaves):
            raise AssertionError(f"{path}: a gradient is missing or not finite")
        log(f"{path}: launches {({k: v for k, v in paths[path].items() if v})}; y, h_fin "
            f"(shape {tuple(hf0.shape)}) and total decay as the kernels'; gradients finite")
    for r in records:
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']}), max |diff| "
            f"{r['max_abs_err']:.3e}")
    return records, paths


def per_op_interior(xz, p, dt_rank: int, n: int):
    """The mixer interior through the per-op route, as ``mamba_mixer_apply``
    runs it under 'pallas': K1 (K5 backward), the x_proj and dt_proj GEMMs,
    K2 (K3/K4 with a gradient)."""
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_silu
    from si_mamba_tpu_torch.ops.kernels.selective_scan import selective_scan_fused

    d_inner = xz.shape[-1] // 2
    xi = causal_conv1d_silu(xz[..., :d_inner], p["conv_w"], p["conv_b"])
    x_dbl = xi @ p["x_proj_w"]
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"]
    return selective_scan_fused(xi, dt, -torch.exp(p["A_log"]), x_dbl[..., dt_rank:dt_rank + n],
                                x_dbl[..., dt_rank + n:], p["D"], xz[..., d_inner:],
                                p["dt_proj_b"])


def fused_work(args) -> dict:
    """The work K10/K11 need on ``args`` (the kernels' inputs; xz in the
    activation dtype, the weights fp32): operations per (b, t), the rank-R
    pair, xi @ x_proj (2 d (R + 2n)) and dt_low @ dt_proj (2 R d), and per
    channel the conv (2W + 1), SiLU 4, softplus 4, skip and gate 6 and 7 per
    state (as K2's bound); the backward the forward's recompute, the pair's
    four products (twice the forward's pair), the scan backward (20 per state
    and 20 per channel, as K4's bound) and the conv backward (6W + 11, as
    K5's). Bytes: xz read and y written once (with states h_entries written
    once, fp32), the weights read once; the backward xz, g and h_entries read,
    dxz written, the weights read and their gradients written once."""
    from si_mamba_tpu_torch.ops.kernels.fused_mixer import CHUNK

    xz, conv_wt, x_proj, dt_proj, at = args[0], args[1], args[3], args[4], args[6]
    B, L, two_d = xz.shape
    d, W, n, r = two_d // 2, conv_wt.shape[0], at.shape[0], dt_proj.shape[0]
    act = xz.element_size()
    pair_ops = 2 * d * x_proj.shape[1] + 2 * r * d
    fwd_ops = B * L * (pair_ops + d * (2 * W + 1 + 4 + 10 + 7 * n))
    weight_bytes = sum(t.numel() for t in args[1:]) * 4
    hent_bytes = B * -(-L // CHUNK) * n * d * 4
    return dict(fwd_ops=fwd_ops, fwd_bytes=B * L * 3 * d * act + weight_bytes,
                hent_bytes=hent_bytes,
                bwd_ops=fwd_ops + B * L * (2 * pair_ops + d * (20 * n + 20 + 6 * W + 11)),
                bwd_bytes=B * L * 5 * d * act + hent_bytes + 2 * weight_bytes)


def fused_fwd_at_clouds(device) -> dict:
    """Lean K10 at each serving request size against its plain version
    (rel-to-max 1e-4), timed as back-to-back wrapper calls (``ms``, the
    host's cost of a call included) and as device time (``device_ms``,
    CUDA-graph replays), with the segment count the kernel took."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    out = {}
    for batch in REQUEST_SIZES:
        mixer, p, xz = mixer_inputs(device, batch)
        args = kfm.kernel_inputs(xz, p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"],
                                 p["dt_proj_b"], -torch.exp(p["A_log"]), p["D"],
                                 dt_rank=mixer.dt_rank, d_state=mixer.d_state)
        y = kfm.fused_mixer_fwd(*args)
        y_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK)[0]
        torch.cuda.synchronize()
        err, rel = _rel_err(y, y_ref)
        if rel > 1e-4:
            raise AssertionError(f"fused forward kernel at B={batch} disagrees with its plain "
                                 f"version: max |diff| {err} ({rel:.3e} of max)")
        out[batch] = dict(max_abs_err=err, ms=time_ms(lambda: kfm.fused_mixer_fwd(*args), 20),
                          device_ms=graph_ms(lambda: kfm.fused_mixer_fwd(*args), 20),
                          segments=kfm._fwd_library().fused_mixer_fwd_segments(
                              batch, xz.shape[1], mixer.d_inner))
        log(f"fused_mixer_fwd at {batch} clouds: {out[batch]}")
    return out


def fused_mixer_phase(device) -> tuple[list[dict], dict]:
    """K10 (lean and with states) and K11 at the serving path's shapes (B=32,
    L=512, d_inner 768, d_state 16, xz as layer 0's in_proj makes it), each
    against its plain version and timed beside it; then the same interior
    through the per-op route and through ``fused_mamba_mixer``, forward
    (no gradient), training forward and backward. Returns the three records
    and the route timings."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer, p, xz = mixer_inputs(device)
    d_inner, n, dt_rank = mixer.d_inner, mixer.d_state, mixer.dt_rank
    weights = [p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"], p["dt_proj_b"],
               -torch.exp(p["A_log"]), p["D"]]
    args = kfm.kernel_inputs(xz, *weights, dt_rank=dt_rank, d_state=n)
    B, L, _ = xz.shape
    y_lean = kfm.fused_mixer_fwd(*args)
    y, h_entries = kfm.fused_mixer_fwd_states(*args)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError(f"the fused forward with states differs from the lean one: "
                             f"max |diff| {(y - y_lean).abs().max().item()}")
    err_y, rel_y = _rel_err(y, y_ref)
    err_h, rel_h = _rel_err(h_entries, h_ref)
    if rel_y > 1e-4 or rel_h > 1e-4:
        raise AssertionError(f"fused forward kernel disagrees with its plain version: y {err_y} "
                             f"({rel_y:.3e} of max), h_entries {err_h} ({rel_h:.3e} of max)")
    work = fused_work(args)
    fwd_ops, fwd_bytes, hent_bytes = work["fwd_ops"], work["fwd_bytes"], work["hent_bytes"]
    records = []
    for name, fn, extra, err in (
            ("fused_mixer_fwd", lambda: kfm.fused_mixer_fwd(*args), 0, err_y),
            ("fused_mixer_fwd_states", lambda: kfm.fused_mixer_fwd_states(*args), hent_bytes,
             max(err_y, err_h))):
        bound_ms, bound_by = bound(fwd_bytes + extra, fwd_ops)
        records.append(dict(
            name=name, route="cuda", source="si_mamba_tpu_torch/csrc/fused_mixer_fwd.cu",
            replaces="si_mamba_tpu/ops/pallas/fused_mixer_kernel.py:243", max_abs_err=err,
            ms=time_ms(fn, 20), device_ms=graph_ms(fn, 20),
            plain_ms=time_ms(lambda: kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK,
                                                             emit_states=bool(extra)), 2, warmup=1),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            segments=kfm._fwd_library().fused_mixer_fwd_segments(B, L, d_inner)))
    log(f"fused forward ok: states y == lean y; vs plain y {err_y:.3e} ({rel_y:.3e} of max), "
        f"h_entries {err_h:.3e} ({rel_h:.3e} of max)")
    records[0]["at_clouds"] = fused_fwd_at_clouds(device)

    # K11 for a seeded output gradient, from the kernel's own h_entries.
    # Tolerance rel-to-max 1e-4: the weight gradients are sums over B*L terms,
    # per chunk and block and then over the batch, in another order than the
    # plain version's.
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, L, d_inner), dtype=np.float32)).to(device)
    bwd_args = (*args, h_entries, g)
    got = kfm.fused_mixer_bwd(*bwd_args)
    want = kfm.fused_mixer_bwd_ref(*bwd_args, chunk=kfm.CHUNK)
    again = kfm.fused_mixer_bwd(*bwd_args)
    torch.cuda.synchronize()
    err11, rels = 0.0, {}
    for name, a, w, a2 in zip(("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb",
                               "dat", "dd"), got, want, again):
        err, rels[name] = _rel_err(a, w)
        err11 = max(err11, err)
        if rels[name] > 1e-4:
            raise AssertionError(f"fused backward kernel: {name} max |diff| {err} "
                                 f"({rels[name]:.3e} of max)")
        if not torch.equal(a, a2):
            raise AssertionError(f"fused backward kernel: {name} differs between two runs")
    bound_ms, bound_by = bound(work["bwd_bytes"], work["bwd_ops"])
    records.append(dict(
        name="fused_mixer_bwd", route="cuda", source="si_mamba_tpu_torch/csrc/fused_mixer_bwd.cu",
        replaces="si_mamba_tpu/ops/pallas/fused_mixer_kernel.py:292", max_abs_err=err11,
        rel_err_of_max=rels, ms=time_ms(lambda: kfm.fused_mixer_bwd(*bwd_args), 10),
        device_ms=graph_ms(lambda: kfm.fused_mixer_bwd(*bwd_args), 10),
        plain_ms=time_ms(lambda: kfm.fused_mixer_bwd_ref(*bwd_args, chunk=kfm.CHUNK), 1,
                         warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log("fused backward ok, two runs bitwise equal: " +
        ", ".join(f"{k} {v:.3e} of max" for k, v in rels.items()))

    # the same interior through the two routes: forward without a gradient,
    # the training forward, and the backward alone (autograd.grad over the
    # graph the training forward kept), xz and every weight a leaf
    leaves = [t.detach().clone().requires_grad_() for t in (xz, *weights)]
    lp = dict(zip(("conv_w", "conv_b", "x_proj_w", "dt_proj_w", "dt_proj_b"), leaves[1:6]))
    lp["A_log"], lp["D"] = torch.log(-leaves[6]), leaves[7]
    routes = {
        "per_op": lambda: per_op_interior(leaves[0], lp, dt_rank, n),
        "fused": lambda: kfm.fused_mamba_mixer(*leaves, dt_rank=dt_rank, d_state=n)}
    timings = {}
    for route, fn in routes.items():
        with torch.no_grad():
            fwd_ms = time_ms(fn, 10)
        train_fwd_ms = time_ms(fn, 10)
        out = fn()
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 10)
        timings[route] = {"fwd_ms": fwd_ms, "train_fwd_ms": train_fwd_ms, "bwd_ms": bwd_ms}
        del out
    records[0]["per_op_route_ms"] = timings["per_op"]["fwd_ms"]
    records[1]["per_op_route_ms"] = timings["per_op"]["train_fwd_ms"]
    records[2]["per_op_route_ms"] = timings["per_op"]["bwd_ms"]
    for r in records:
        log(f"{r['name']}: {r['ms']:.6f} ms (plain {r['plain_ms']:.6f}, per-op route "
            f"{r['per_op_route_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']})")
    log(f"mixer interior, per-op route {timings['per_op']}; fused route {timings['fused']}")
    return records, timings


def fused_bf16_args(device, batch: int = 32) -> tuple:
    """K10/K11's inputs as layer 0's bf16 mixer makes them at B=batch, L=512:
    xz = x @ in_proj in bf16 (x bf16, the weight cast to bf16), every interior
    weight fp32, as ``mamba_mixer_apply(impl='fused')`` hands them over.
    Returns (the mixer, the kernels' inputs)."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer, p, _ = mixer_inputs(device, batch)
    bf = torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (batch, 512, MODELNET40["trans_dim"]), dtype=np.float32)).to(device, bf)
    return mixer, kfm.kernel_inputs(x @ p["in_proj_w"].to(bf), p["conv_w"], p["conv_b"],
                                    p["x_proj_w"], p["dt_proj_w"], p["dt_proj_b"],
                                    -torch.exp(p["A_log"]), p["D"], dt_rank=mixer.dt_rank,
                                    d_state=mixer.d_state)


def fused_bf16_kernel_phase(device) -> list[dict]:
    """The bf16 K10 (lean and with states) and K11 at the fused perf path's
    shapes (B=32, L=512, d_inner 768, d_state 16, dt_rank 24; xz as layer 0's
    bf16 in_proj makes it, the weights fp32), each against its plain version
    at bf16 and timed beside it (back-to-back calls and CUDA-graph device
    time): y and dxz within one bf16 ulp at a floor of 2e-2 of the max (both
    round one fp32 value once); h_entries and the fp32 weight gradients
    within 1e-4 of their max; the lean y equal to the states variant's; two
    K11 runs bitwise equal; the lean K10 also at 1, 20 and 64 clouds. Bounds
    count bf16 bytes for xz, g, y and dxz and fp32 operations."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    _, args = fused_bf16_args(device)
    B, L, two_d = args[0].shape

    def hold(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against the plain "
                                 f"version's {want.dtype} {tuple(want.shape)}")
        if got.dtype == torch.bfloat16:
            ulps = _bf16_ulps(got, want, 2e-2)
            if ulps > 1:
                raise AssertionError(f"{name}: {ulps:.2f} bf16 ulps from the plain version")
        elif _rel_err(got, want)[1] > 1e-4:
            raise AssertionError(f"{name}: {_rel_err(got, want)} from the plain version")
        return (got.float() - want.float()).abs().max().item()

    y_lean = kfm.fused_mixer_fwd_bf16(*args)
    y, h_entries = kfm.fused_mixer_fwd_states_bf16(*args)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError("the bf16 fused forward with states differs from the lean one")
    err_y = hold("bf16 K10 y", y, y_ref)
    err_h = hold("bf16 K10 h_entries", h_entries, h_ref)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, L, two_d // 2), dtype=np.float32)).to(device, torch.bfloat16)
    bwd_args = (*args, h_entries, g)
    got, again = kfm.fused_mixer_bwd_bf16(*bwd_args), kfm.fused_mixer_bwd_bf16(*bwd_args)
    want = kfm.fused_mixer_bwd_ref(*bwd_args, chunk=kfm.CHUNK)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError("two bf16 fused backward runs on the same inputs differ")
    names = ("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb", "dat", "dd")
    err11 = max(hold(f"bf16 K11 {k}", a, w) for k, a, w in zip(names, got, want))

    at_clouds = {}
    for batch in REQUEST_SIZES:
        _, a = fused_bf16_args(device, batch)
        err = hold(f"bf16 K10 at B={batch}", kfm.fused_mixer_fwd_bf16(*a),
                   kfm.fused_mixer_fwd_ref(*a, chunk=kfm.CHUNK)[0])
        at_clouds[batch] = dict(
            max_abs_err=err, ms=time_ms(lambda: kfm.fused_mixer_fwd_bf16(*a), 20),
            device_ms=graph_ms(lambda: kfm.fused_mixer_fwd_bf16(*a), 20),
            segments=kfm._fwd_library().fused_mixer_fwd_segments(batch, L, two_d // 2))

    work = fused_work(args)
    records = []
    for name, fn, plain, err, moved, ops in (
            ("fused_mixer_fwd_bf16", lambda: kfm.fused_mixer_fwd_bf16(*args),
             lambda: kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK), err_y,
             work["fwd_bytes"], work["fwd_ops"]),
            ("fused_mixer_fwd_states_bf16", lambda: kfm.fused_mixer_fwd_states_bf16(*args),
             lambda: kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True),
             max(err_y, err_h), work["fwd_bytes"] + work["hent_bytes"], work["fwd_ops"]),
            ("fused_mixer_bwd_bf16", lambda: kfm.fused_mixer_bwd_bf16(*bwd_args),
             lambda: kfm.fused_mixer_bwd_ref(*bwd_args, chunk=kfm.CHUNK), err11,
             work["bwd_bytes"], work["bwd_ops"])):
        fwd = "fwd" in name
        bound_ms, bound_by = bound(moved, ops)
        records.append(dict(
            name=name, route="cuda", dtype="bfloat16",
            source="si_mamba_tpu_torch/csrc/fused_mixer_" + ("fwd.cu" if fwd else "bwd.cu"),
            replaces="si_mamba_tpu/ops/pallas/fused_mixer_kernel.py:" + ("243" if fwd else "292"),
            shape=[B, L, two_d // 2], max_abs_err=err, ms=time_ms(fn, 20 if fwd else 10),
            device_ms=graph_ms(fn, 20 if fwd else 10),
            plain_ms=time_ms(plain, 2 if fwd else 1, warmup=1), library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by))
    records[0]["at_clouds"] = at_clouds
    for r in records:
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']}), max |diff| "
            f"{r['max_abs_err']:.3e}")
    log("bf16 K10 at " + "; ".join(f"{b} clouds: device {f['device_ms']:.6f} ms "
                                   f"({f['segments']} segments)" for b, f in at_clouds.items())
        + "; K11 two runs bitwise equal")
    return records


def clouds(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, NPOINTS, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def _wrappers() -> dict:
    """Every kernel wrapper of the port by its record name; each counts its
    launches in ``.launches``."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    return {"causal_conv1d_silu": kc.causal_conv1d_silu,
            "causal_conv1d_silu_bf16": kc.causal_conv1d_silu_bf16,
            "causal_conv1d_silu_bwd_bf16": kc.causal_conv1d_silu_bwd_bf16,
            "selective_scan_fwd": ks.selective_scan_fwd,
            "selective_scan_fwd_residuals": ks.selective_scan_fwd_residuals,
            "selective_scan_bwd": ks.selective_scan_bwd,
            "causal_conv1d_silu_bwd": kc.causal_conv1d_silu_bwd,
            "ssd_xbc_fwd": kssd.ssd_xbc_fwd,
            "ssd_xbc_fwd_states": kssd.ssd_xbc_fwd_states,
            "ssd_xbc_bwd": kssd.ssd_xbc_bwd,
            "fused_mixer_fwd": kfm.fused_mixer_fwd,
            "fused_mixer_fwd_states": kfm.fused_mixer_fwd_states,
            "fused_mixer_bwd": kfm.fused_mixer_bwd,
            "fused_mixer_fwd_bf16": kfm.fused_mixer_fwd_bf16,
            "fused_mixer_fwd_states_bf16": kfm.fused_mixer_fwd_states_bf16,
            "fused_mixer_bwd_bf16": kfm.fused_mixer_bwd_bf16,
            "ssd_xbc_fwd_hfin": kssd.ssd_xbc_fwd_hfin,
            "ssd_xbc_fwd_states_hfin": kssd.ssd_xbc_fwd_states_hfin,
            "ssd_xbc_bwd_seeded": kssd.ssd_xbc_bwd_seeded,
            "ssd_split_fwd": kssd.ssd_split_fwd,
            "ssd_split_fwd_states": kssd.ssd_split_fwd_states,
            "ssd_split_fwd_hfin": kssd.ssd_split_fwd_hfin,
            "ssd_split_fwd_states_hfin": kssd.ssd_split_fwd_states_hfin,
            "ssd_split_bwd": kssd.ssd_split_bwd,
            "ssd_split_bwd_seeded": kssd.ssd_split_bwd_seeded,
            **{name + "_bf16": getattr(kssd, name + "_bf16") for name in SSD_NAMES},
            # the variants at the shapes the tuned kernels are not built for
            **kc.ANY_LAUNCHES, **ks.ANY_LAUNCHES, **kfm.ANY_LAUNCHES, **kssd.VARIANT_LAUNCHES,
            # the Hopper bf16 bodies
            **ks.SM90_LAUNCHES}


# the SSD kernels' wrappers by name, each with a ``_bf16`` twin
SSD_NAMES = ("ssd_xbc_fwd", "ssd_xbc_fwd_states", "ssd_xbc_bwd", "ssd_split_fwd",
             "ssd_split_fwd_states", "ssd_split_fwd_hfin", "ssd_split_fwd_states_hfin",
             "ssd_split_bwd", "ssd_split_bwd_seeded", *CARRY)


def _launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _expect(depth: int, names) -> dict[str, int]:
    """``depth`` launches of each kernel in ``names``, none of the others."""
    return {k: (depth if k in names else 0) for k in _launch_counts()}


def serving_phase(device, base: dict = MODELNET40, plain_impl: str = "seq",
                  kernels=EVAL_KERNELS, perf: bool = False, tol: float = 1e-3):
    """Requests of REQUEST_SIZES clouds through a ``Predictor`` over the model
    of ``base``; every forward must launch each of ``kernels`` once a block and
    nothing else, and the logits and pooled features match the model with
    ``plain_impl`` within ``tol`` of their max (and 2e-3 relative; for perf
    mode ``tol`` relative too). With ``perf`` the predictor comes from
    ``Predictor.from_checkpoint(state dict, perf=True)`` (bf16, subspace).
    Returns (launches, latency record, model, requests)."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serving import Predictor

    model = PointMamba(PointMambaConfig.from_dict(base), generator=torch.Generator().manual_seed(0))
    if perf:
        predictor = Predictor.from_checkpoint(model.state_dict(), model_cfg=base, perf=True,
                                              npoints=NPOINTS, max_batch=64, device=device)
    else:
        predictor = Predictor(model, npoints=NPOINTS, max_batch=64, device=device)
    cfg = predictor.model.config
    rtol = tol if perf else 2e-3
    predictor.warmup()
    requests = {n: clouds(n, seed=n) for n in REQUEST_SIZES}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the main path: counts from 0, then only the requests
    latency, logits, forwards = {}, {}, 0
    for n, batch in requests.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = predictor.logits(batch)  # returns host numpy: synchronised
            times.append(time.perf_counter() - t0)
            forwards += -(-n // predictor.max_batch)
        if out.shape != (n, cfg.cls_dim) or not np.isfinite(out).all():
            raise AssertionError(f"bad logits for a request of {n}: {out.shape}")
        latency[n], logits[n] = times, out
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    want = _expect(cfg.depth * forwards, kernels)
    if launches != want:
        raise AssertionError(f"{forwards} forwards launched {launches}; expected {want} "
                             f"({cfg.depth} per forward of {kernels}, nothing else)")
    log(f"served {forwards} forwards ({cfg.mixer} mixer, scan_impl={cfg.scan_impl!r}, "
        f"{cfg.dtype}, {cfg.spectral_method}), peak memory {peak / 2**30:.3f} GiB; launches "
        f"{launches}")

    # the same weights through the plain path, on the same card
    plain_model = PointMamba(PointMambaConfig.from_dict({**cfg.__dict__, "scan_impl": plain_impl}))
    plain_model.load_state_dict(predictor.model.state_dict(), strict=True)
    plain = Predictor(plain_model, npoints=NPOINTS, max_batch=64, device=device)
    n_cmp = 20
    ref = plain.logits(requests[n_cmp])
    scale = float(np.abs(ref).max())
    err = float(np.abs(logits[n_cmp] - ref).max())
    if not np.allclose(logits[n_cmp], ref, atol=tol * scale, rtol=rtol):
        raise AssertionError(f"kernel logits disagree with scan_impl={plain_impl!r}: max "
                             f"|diff| {err}, max |logit| {scale}")
    with torch.inference_mode():
        pts = torch.from_numpy(requests[n_cmp]).to(device)
        feat = predictor.model(pts, return_features=True)[1].float()
        feat_ref = plain_model(pts, return_features=True)[1].float()
    feat_err = (feat - feat_ref).abs().max().item()
    feat_scale = feat_ref.abs().max().item()
    if not torch.allclose(feat, feat_ref, atol=tol * feat_scale, rtol=rtol):
        raise AssertionError(f"pooled features disagree with scan_impl={plain_impl!r}: max "
                             f"|diff| {feat_err}, max |feature| {feat_scale}")
    log(f"kernel path == scan_impl={plain_impl!r} on {n_cmp} clouds: logits max |diff| "
        f"{err:.3e} (max |logit| {scale:.3e}), features max |diff| {feat_err:.3e} "
        f"(max |feature| {feat_scale:.3e})")
    del plain, plain_model

    serving = {"logits_max_abs_diff": err, "logits_max_abs": scale,
               "max_memory_allocated_bytes": peak}
    for n, times in latency.items():
        p50 = statistics.median(times)
        serving[str(n)] = {"p50_ms": p50 * 1e3, "clouds_per_s": n / p50,
                           "latencies_ms": [t * 1e3 for t in times]}
        log(f"request of {n:2d} clouds: p50 {p50 * 1e3:.3f} ms, {n / p50:.2f} clouds/s")
    return launches, serving, predictor.model, requests


def piece_times(model, pts) -> dict[str, float]:
    """One forward through the model's own pieces, ms per piece."""
    out, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    tokens, pos, center = model.embed(pts)
    mark("embed")
    x, pos_seq = model.sequence(tokens, pos, center)
    mark("sequence")
    model.classify(x, pos_seq)
    mark("classify")
    return out


def device_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: device-side events (kernels,
    copies) only, since an operator's own row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time in a call on the card")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "top": [{"name": k[:90], "count": c, "device_ms": ms} for k, c, ms in rows[:8]]}


def view_grad_profile(fn, batch: int, length: int, full: int, widths) -> dict:
    """One call of ``fn`` (a train step) under torch.profiler with shapes: the
    device time of building the in_proj output's gradient (batch, length,
    full) from the gradients of its column views, which autograd's slice
    backward does as a zero fill of the full buffer and a copy a view
    (``aten::slice_backward`` on a (batch, length, w) gradient, w in
    ``widths``), then the adds of the full-width gradients; beside it the
    conv backward's own device time (its tile and finishing kernels). Fails
    when the step shows no such slice backward or no conv backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    views = [[batch, length, w] for w in widths]
    out = {"slice_backward": [0, 0.0], "add": [0, 0.0], "conv_bwd": [0, 0.0]}
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = [list(x) for x in (e.input_shapes or [])]
        if e.key == "aten::slice_backward" and shapes and shapes[0] in views:
            row = out["slice_backward"]
        elif e.key in ("aten::add", "aten::add_") and shapes[:2] == [[batch, length, full]] * 2:
            row = out["add"]
        elif e.device_type == DeviceType.CUDA and "causal_conv1d_silu_bwd" in e.key:
            row = out["conv_bwd"]
        else:
            continue
        row[0] += e.count
        row[1] += (e.device_time_total if e.device_type != DeviceType.CUDA
                   else e.self_device_time_total) / 1e3
    if not out["slice_backward"][0] or not out["conv_bwd"][0]:
        raise AssertionError(f"the profiled step shows no slice backward of a {views} view "
                             f"or no conv backward: {out}")
    return {k: {"count": n, "device_ms": ms} for k, (n, ms) in out.items()}


def in_proj_views(model) -> tuple[int, tuple[int, ...]]:
    """The width of the first mixer's in_proj output and the widths of the
    column views that the mixer takes of it: x and z (d_inner each) for the
    Mamba-1 mixer; z, x|B|C and dt for the SSD mixer."""
    from si_mamba_tpu_torch.models.layers import MambaMixer, SSDMixer

    mixer = next(m for m in model.modules() if isinstance(m, (MambaMixer, SSDMixer)))
    if isinstance(mixer, SSDMixer):
        widths = (mixer.d_inner, mixer.d_inner + 2 * mixer.d_state, mixer.n_heads)
    else:
        widths = (mixer.d_inner,)
    return mixer.in_proj.out_features, widths


def profile_phase(model, requests) -> dict:
    device = next(model.parameters()).device
    result = {}
    with torch.inference_mode():
        for n, batch in requests.items():
            pts = torch.from_numpy(batch).to(device)
            for _ in range(2):
                piece_times(model, pts)
            runs = [piece_times(model, pts) for _ in range(PROFILE_REPEATS)]
            med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            prof = device_profile(lambda: model(pts))
            result[str(n)] = {"piece_ms_median": med, "profile": prof}
            log(f"{n:2d} clouds: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()) +
                f"; device {prof['device_ms']:.3f} of {prof['wall_ms']:.3f} ms wall "
                f"(busy {prof['busy_share']:.3f})")
            for row in prof["top"]:
                log(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    return result


def _train_clouds(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, TRAIN_POINTS, 3)).astype(np.float32)
    pts /= np.abs(pts).max(axis=(1, 2), keepdims=True)
    return pts, rng.integers(0, MODELNET40["cls_dim"], n)


def train_phase(device, card: str, base: dict = MODELNET40, kernels=TRAIN_KERNELS,
                eval_kernels=EVAL_KERNELS, view_grads: bool = True) -> tuple[dict, dict]:
    """TRAIN_STEPS steps of the port's finetune step at the ModelNet40
    settings over the model of ``base``; every step must launch each of
    ``kernels`` once a block and nothing else, an eval forward after them
    each of ``eval_kernels``. With ``view_grads``, a profiled step measures
    how the in_proj output's gradient is assembled from its column views'
    (``view_grad_profile``). Returns (record, launches over the steps)."""
    from si_mamba_tpu_torch.data import transforms
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.train.optim import build_optimizer
    from si_mamba_tpu_torch.train.runner_finetune import (
        finetune_update,
        make_input_pipeline,
        make_train_step,
    )
    from si_mamba_tpu_torch.train.train_state import TrainState

    cfg = PointMambaConfig.from_dict(base)
    model = PointMamba(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    optimizer, schedule = build_optimizer(model, opt_type="AdamW", lr=3e-4, weight_decay=0.05,
                                          epochs=300, warmup_epochs=10, steps_per_epoch=2,
                                          grad_clip=10.0)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, NPOINTS, rotation=False)
    pts_np, labels_np = _train_clouds(TRAIN_BATCH, seed=7)
    points = torch.from_numpy(pts_np).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}

    expect = _expect(cfg.depth, kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the main path: counts from 0, then only the steps
    times, losses, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = _launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, points, labels, generator)
        loss = metrics["loss"].item()  # a host copy: synchronises
        times.append(time.perf_counter() - t0)
        now = _launch_counts()
        per_step.append({k: now[k] - before[k] for k in now})
        losses.append(loss)
        if per_step[-1] != expect:
            raise AssertionError(f"train step {len(losses)} launched {per_step[-1]}, "
                                 f"expected {expect}")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {len(losses)} gave loss {loss}")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)

    moved = {k for k, v in model.named_parameters() if not torch.equal(v.detach(), params0[k])}
    mixer_params = [k for k in params0 if ".mixer." in k]
    stuck = [k for k in mixer_params if k not in moved]
    if stuck or len(moved) < 0.9 * len(params0):
        raise AssertionError(f"parameters did not move: {sorted(set(params0) - moved)}")
    stats_stuck = [k for k, v in model.named_buffers() if k in stats0 and torch.equal(v, stats0[k])]
    if stats_stuck:
        raise AssertionError(f"BatchNorm statistics did not move: {stats_stuck}")

    # one more step as the two halves that the step composes (input pipeline,
    # then forward + backward + optimizer), each ended by a synchronise; then
    # one step under the profiler
    pieces, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        pieces[name] = (now - t) * 1e3
        t = now

    pts = make_input_pipeline(NPOINTS, rotation=False)(points, generator)
    mark("input")
    state, _ = finetune_update(state, pts, labels, generator)
    mark("update")
    prof = device_profile(lambda: step(state, points, labels, generator))
    log("train step pieces: " + ", ".join(f"{k} {v:.3f} ms" for k, v in pieces.items()) +
        f"; profiled step: device {prof['device_ms']:.3f} of {prof['wall_ms']:.3f} ms wall "
        f"(busy {prof['busy_share']:.3f})")
    for row in prof["top"]:
        log(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    views = None
    if view_grads:
        full, widths = in_proj_views(model)
        views = view_grad_profile(lambda: step(state, points, labels, generator), TRAIN_BATCH,
                                  cfg.seq_len, full, widths)
        log(f"in_proj gradient ({full} wide) from its views {widths} (device ms, count): " +
            ", ".join(f"{k} {v['device_ms']:.3f} x{v['count']}" for k, v in views.items()))

    # an eval forward after training takes the lean forward kernel again
    _reset_launch_counts()
    with torch.inference_mode():
        logits = model.eval()(points[:, :NPOINTS])
    counts = _launch_counts()
    if counts != _expect(cfg.depth, eval_kernels):
        raise AssertionError(f"an eval forward after training launched {counts}")
    if logits.shape != (TRAIN_BATCH, cfg.cls_dim) or not torch.isfinite(logits).all():
        raise AssertionError("bad eval logits after training")

    # the input pipeline's FPS (8192 -> 1200 points, a host loop) on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transforms.fps_resample(points, generator, NPOINTS, point_all=1200)
    torch.cuda.synchronize()
    fps_ms = (time.perf_counter() - t0) * 1e3

    p50 = statistics.median(times[1:])
    record = {"batch": TRAIN_BATCH, "points": TRAIN_POINTS, "steps": TRAIN_STEPS,
              "p50_step_ms": p50 * 1e3, "clouds_per_s": TRAIN_BATCH / p50,
              "step_ms": [t * 1e3 for t in times], "losses": losses,
              "lr": [schedule(i) for i in range(TRAIN_STEPS)],
              "max_memory_allocated_bytes": peak, "fps_resample_ms": fps_ms,
              "piece_ms": pieces, "profile": prof, "view_grad": views,
              "params_moved": len(moved), "params": len(params0),
              "launches_per_step": expect, "card": card}
    log(f"train ({cfg.mixer} mixer, scan_impl={cfg.scan_impl!r}, {cfg.dtype}, "
        f"{cfg.spectral_method}): {TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH}, p50 {p50 * 1e3:.3f} ms (steps 2 onward), {TRAIN_BATCH / p50:.2f} clouds/s, peak memory "
        f"{peak / 2**30:.3f} GiB, losses {['%.4f' % v for v in losses]}; "
        f"fps_resample alone {fps_ms:.3f} ms; {card}")
    log(f"train launches {launches}; {len(moved)} of {len(params0)} parameters moved")
    return record, launches


def gradient_phase(device, base: dict = MODELNET40, plain_impl: str = "seq") -> dict:
    """One train-mode forward + backward of the kernel path and of the plain
    path (``plain_impl``), same weights and clouds, drop rates 0: the loss
    and every parameter gradient. The tolerance has the form of
    tests/test_full_parity.py:541-545 (there 1.5e-2 across frameworks),
    tightened for one framework on one card: each leaf within GRAD_TOL of
    the largest gradient, dominant leaves (above a tenth of it) within
    GRAD_TOL relative. The sums of the kernels and of the plain path run in
    other orders; the worst leaf measured on the H100 was 1.3e-5 of the
    largest gradient."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.models.point_mamba import cross_entropy_loss_acc

    no_drop = {**base, "drop_path": 0.0, "cls_head_dropout": 0.0}
    model = PointMamba(PointMambaConfig.from_dict(no_drop),
                       generator=torch.Generator().manual_seed(5)).to(device)
    plain = PointMamba(PointMambaConfig.from_dict({**no_drop, "scan_impl": plain_impl})).to(device)
    plain.load_state_dict(model.state_dict(), strict=True)
    pts_np, labels_np = _train_clouds(PARITY_BATCH, seed=11)
    pts = torch.from_numpy(pts_np[:, :NPOINTS]).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    losses = {}
    for name, m in (("kernel", model), ("plain", plain)):
        per, _ = cross_entropy_loss_acc(m.train()(pts), labels)
        loss = per.mean()
        loss.backward()
        losses[name] = loss.item()
    if not np.isclose(losses["kernel"], losses["plain"], rtol=2e-4, atol=0):
        raise AssertionError(f"losses differ: {losses}")
    grads = {k: p.grad for k, p in model.named_parameters()}
    ref = {k: p.grad for k, p in plain.named_parameters()}
    gmax = max(g.abs().max().item() for g in ref.values())
    worst_leaf, worst_dominant = 0.0, 0.0
    for k, g in grads.items():
        diff = (g - ref[k]).abs().max().item()
        worst_leaf = max(worst_leaf, diff / gmax)
        if diff >= GRAD_TOL * gmax:
            raise AssertionError(f"{k}: gradient differs by {diff} (max gradient {gmax})")
        bmax = ref[k].abs().max().item()
        if bmax > 0.1 * gmax:
            worst_dominant = max(worst_dominant, diff / bmax)
            if diff / bmax >= GRAD_TOL:
                raise AssertionError(f"{k}: gradient differs by {diff / bmax:.3e} relative")
    log(f"gradients at B={PARITY_BATCH} ({base.get('mixer', 'mamba')} mixer, scan_impl="
        f"{base.get('scan_impl', 'auto')!r}, against "
        f"scan_impl={plain_impl!r}): loss kernel {losses['kernel']:.7f}, plain "
        f"{losses['plain']:.7f}; worst leaf |diff| {worst_leaf:.3e} of max gradient "
        f"{gmax:.3e}, worst dominant leaf {worst_dominant:.3e} relative")
    return {"batch": PARITY_BATCH, "plain_impl": plain_impl, "losses": losses, "max_grad": gmax,
            "worst_leaf_diff_over_max_grad": worst_leaf,
            "worst_dominant_leaf_rel_diff": worst_dominant, "leaves": len(grads)}


# ---------------------------------------------------------------------------
# the parallel paths: two ranks on the one card
# ---------------------------------------------------------------------------
# Two processes share cuda:0, so their group runs on gloo (NCCL refuses two
# ranks on one device); every collective of the port is an all_reduce, which
# gloo takes on CUDA tensors. The parent builds the kernels before the ranks
# start, and each rank saves its record under build/ for the parent.

TP = 2
# phase 13: the full SSD mixer's core (6 heads of 128, d_state 128) at B=32,
# L=512 over the 2 ranks, two chunks of 128 a rank
SP_SHAPE = dict(B=32, L=512, h=6, p=128, n=128, chunk=128)


def _counts_expect(per_forward: dict, times: int) -> dict[str, int]:
    """``times`` x the launches in ``per_forward`` of each kernel, none of the others."""
    return {k: per_forward.get(k, 0) * times for k in _launch_counts()}


def _full_state(base: dict, seed: int) -> dict:
    """The single-process model's state dict, weights from ``seed``."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    return PointMamba(PointMambaConfig.from_dict(base),
                      generator=torch.Generator().manual_seed(seed)).state_dict()


def _tp_model(base: dict, mesh, sd: dict, rank: int):
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.utils.weights import shard_state_dict

    cfg = PointMambaConfig.from_dict({**base, "tp_axis": "model"})
    model = PointMamba(cfg, mesh=mesh)
    model.load_state_dict(shard_state_dict(sd, cfg, rank, TP), strict=True)
    return model


def tp_serving_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 11: the SSD classifier with its mixers over the 2-rank model axis
    serves requests of REQUEST_SIZES clouds; every forward must launch the
    conv 24 times (x and B|C, 12 blocks) and the lean K6 12 times, nothing
    else, and the logits match the single-process 'xla' model."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serving import Predictor

    sd = _full_state(MODELNET40_SSD, seed=0)
    predictor = Predictor(_tp_model(MODELNET40_SSD, mesh, sd, rank), npoints=NPOINTS,
                          max_batch=64, device=device)
    predictor.warmup()
    requests = {n: clouds(n, seed=n) for n in REQUEST_SIZES}
    _reset_launch_counts()  # the main path: counts from 0, then only the requests
    latency, logits, forwards = {}, {}, 0
    for n, batch in requests.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = predictor.logits(batch)
            times.append(time.perf_counter() - t0)
            forwards += -(-n // predictor.max_batch)
        if out.shape != (n, MODELNET40["cls_dim"]) or not np.isfinite(out).all():
            raise AssertionError(f"bad TP logits for a request of {n}: {out.shape}")
        latency[n], logits[n] = times, out
    launches = _launch_counts()
    want = _counts_expect({"causal_conv1d_silu": 24, "ssd_split_fwd": 12}, forwards)
    if launches != want:
        raise AssertionError(f"rank {rank}: {forwards} TP forwards launched {launches}; "
                             f"expected {want}")
    plain_model = PointMamba(PointMambaConfig.from_dict({**MODELNET40_SSD, "scan_impl": "xla"}))
    plain_model.load_state_dict(sd, strict=True)
    ref = Predictor(plain_model, npoints=NPOINTS, max_batch=64, device=device).logits(
        requests[20])
    scale = float(np.abs(ref).max())
    err = float(np.abs(logits[20] - ref).max())
    if not np.allclose(logits[20], ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"rank {rank}: TP logits disagree with the single-process 'xla' "
                             f"model: max |diff| {err}, max |logit| {scale}")
    record = {"logits_max_abs_diff": err, "logits_max_abs": scale, "forwards": forwards}
    for n, times in latency.items():
        p50 = statistics.median(times)
        record[str(n)] = {"p50_ms": p50 * 1e3, "clouds_per_s": n / p50,
                          "latencies_ms": [t * 1e3 for t in times]}
    if rank == 0:
        log(f"rank 0: TP SSD serving ok, {forwards} forwards launched {launches}; " +
            ", ".join(f"{n} clouds p50 {record[str(n)]['p50_ms']:.3f} ms" for n in latency))
    return launches, record


def tp_train_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 12: TRAIN_STEPS steps of the finetune step on the TP SSD
    classifier at batch 32 from 8192-point clouds (the settings of phase 7),
    one generator seed on both ranks; every step must launch the conv
    forward and backward 24 times each and K6 with states and K7 12 times
    each, nothing else; the loss finite; every parameter and BatchNorm
    statistic moved. Then at B = 4, drop rates 0, one forward and backward
    and a global-norm clip at half the norm; the rank-local gradients go back
    for the parent to gather, rank 0's beside the single-process 'xla'
    model's."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.models.point_mamba import cross_entropy_loss_acc
    from si_mamba_tpu_torch.parallel import LOCAL_DATA, set_data_axis
    from si_mamba_tpu_torch.train.optim import build_optimizer, clip_grad_norm_
    from si_mamba_tpu_torch.train.runner_finetune import make_train_step
    from si_mamba_tpu_torch.train.train_state import TrainState

    model = _tp_model(MODELNET40_SSD, mesh, _full_state(MODELNET40_SSD, seed=0), rank).to(device)
    optimizer, _ = build_optimizer(model, opt_type="AdamW", lr=3e-4, weight_decay=0.05,
                                   epochs=300, warmup_epochs=10, steps_per_epoch=2,
                                   grad_clip=10.0, tp=model.tp_sharding())
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, NPOINTS, rotation=False)
    pts_np, labels_np = _train_clouds(TRAIN_BATCH, seed=7)
    points, labels = torch.from_numpy(pts_np).to(device), torch.from_numpy(labels_np).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}
    expect = _counts_expect({"causal_conv1d_silu": 24, "causal_conv1d_silu_bwd": 24,
                             "ssd_split_fwd_states": 12, "ssd_split_bwd": 12}, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the main path: counts from 0, then only the steps
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        before = _launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, points, labels, generator)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
        now = _launch_counts()
        got = {k: now[k] - before[k] for k in now}
        if got != expect:
            raise AssertionError(f"rank {rank}: TP train step {i + 1} launched {got}, "
                                 f"expected {expect}")
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"rank {rank}: TP train step {i + 1} gave loss {losses[-1]}")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    stuck = [k for k, v in model.named_parameters() if torch.equal(v.detach(), params0[k])]
    stats_stuck = [k for k, v in model.named_buffers() if k in stats0 and torch.equal(v, stats0[k])]
    if stuck or stats_stuck:
        raise AssertionError(f"rank {rank}: did not move: {stuck + stats_stuck}")
    p50 = statistics.median(times[1:])
    record = {"batch": TRAIN_BATCH, "points": TRAIN_POINTS, "steps": TRAIN_STEPS,
              "p50_step_ms": p50 * 1e3, "clouds_per_s": TRAIN_BATCH / p50,
              "step_ms": [t * 1e3 for t in times], "losses": losses,
              "max_memory_allocated_bytes": peak, "launches_per_step": expect}
    if rank == 0:
        log(f"rank 0: TP SSD train ok, p50 {p50 * 1e3:.3f} ms, losses {losses}")
    del state, optimizer, model

    # the gradients at B = 4 with a clip below the norm
    no_drop = {**MODELNET40_SSD, "drop_path": 0.0, "cls_head_dropout": 0.0}
    sd = _full_state(no_drop, seed=5)
    model = _tp_model(no_drop, mesh, sd, rank).to(device)
    pts_np, labels_np = _train_clouds(PARITY_BATCH, seed=11)
    pts = torch.from_numpy(pts_np[:, :NPOINTS]).to(device)
    lab = torch.from_numpy(labels_np).to(device)
    per, _ = cross_entropy_loss_acc(model.train()(pts), lab)
    per.mean().backward()
    axis, segments = model.tp_sharding()
    named = dict(model.named_parameters())
    sharded = {id(named[k]): v for k, v in segments.items()}
    norm = float(clip_grad_norm_(named.values(), float("inf"), sharded, axis))
    clip = 0.5 * norm
    clip_grad_norm_(named.values(), clip, sharded, axis)
    grads = {k: p.grad.detach().cpu() for k, p in named.items()}
    record["gradients"] = {"batch": PARITY_BATCH, "loss": per.mean().item(), "norm": norm,
                           "clip": clip}
    ref = None
    if rank == 0:
        plain = PointMamba(PointMambaConfig.from_dict({**no_drop, "scan_impl": "xla"})).to(device)
        plain.load_state_dict(sd, strict=True)
        set_data_axis(plain, LOCAL_DATA)  # the single-process model: rank 0's rows alone
        per_ref, _ = cross_entropy_loss_acc(plain.train()(pts), lab)
        per_ref.mean().backward()
        ref_norm = float(torch.nn.utils.clip_grad_norm_(plain.parameters(), clip))
        ref = {"loss": per_ref.mean().item(), "norm": ref_norm,
               "grads": {k: p.grad.detach().cpu() for k, p in plain.named_parameters()}}
    return launches, dict(record, grads=grads, reference=ref)


def sp_rank(device, rank: int) -> tuple[dict, dict, dict]:
    """Phase 13: ``ssd_seq_parallel(impl='ssd_fused')`` on 2 ranks at B=32,
    L=512 (256 a rank), 6 heads, n = p = 128, chunk 128 (two chunks a rank:
    the carry inside the kernel and the one across ranks). Without a
    gradient it must launch K6 with h_fin once a rank, with one K6 with
    states and h_fin and the seeded K7 once each; y and the gradients of x,
    dt, A, B, C and D match the single-process plain ``ssd_chunked`` on the
    card. Returns (launches without, with a gradient, record)."""
    from si_mamba_tpu_torch.ops.ssd import ssd_chunked
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import ssd_seq_parallel

    mesh = make_mesh(("seq",), (TP,))
    B, L, h, p, n, chunk = (SP_SHAPE[k] for k in ("B", "L", "h", "p", "n", "chunk"))
    rng = np.random.default_rng(13)
    host = {"x": rng.standard_normal((B, L, h, p), dtype=np.float32),
            "dt": np.log1p(np.exp(rng.standard_normal((B, L, h), dtype=np.float32) - 3.0)),
            "A": -np.exp(rng.standard_normal(h, dtype=np.float32)),
            "Bm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "Cm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "D": rng.standard_normal(h, dtype=np.float32)}
    w = torch.from_numpy(rng.standard_normal((B, L, h, p), dtype=np.float32)).to(device)
    full = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in host.items()}
    part = slice(rank * (L // TP), (rank + 1) * (L // TP))
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    local = {k: (v[:, part].contiguous() if v.dim() > 1 else v) for k, v in full.items()}

    def run():
        return ssd_seq_parallel(*(local[k] for k in names), mesh=mesh, chunk=chunk,
                                impl="ssd_fused")

    with torch.no_grad():
        run()  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()  # the no-gradient path
        y = run()
        torch.cuda.synchronize()
        fwd_launches = _launch_counts()
        fwd_ms = time_ms(run, 5)
    want = _counts_expect({"ssd_split_fwd_hfin": 1}, 1)
    if fwd_launches != want:
        raise AssertionError(f"rank {rank}: SP forward launched {fwd_launches}, expected {want}")

    leaves = {k: v.clone().requires_grad_() for k, v in local.items()}

    def train():
        for v in leaves.values():
            v.grad = None
        out = ssd_seq_parallel(*(leaves[k] for k in names), mesh=mesh, chunk=chunk,
                               impl="ssd_fused")
        torch.sum(out * w[:, part]).backward()
        return out

    _reset_launch_counts()  # the gradient path
    y_g = train()
    torch.cuda.synchronize()
    train_launches = _launch_counts()
    want = _counts_expect({"ssd_split_fwd_states_hfin": 1, "ssd_split_bwd_seeded": 1}, 1)
    if train_launches != want:
        raise AssertionError(f"rank {rank}: SP train launched {train_launches}, expected {want}")
    got = {k: v.grad.clone() for k, v in leaves.items()}
    train_ms = time_ms(train, 3)

    ref_leaves = {k: v.clone().requires_grad_() for k, v in full.items()}
    y_ref = ssd_chunked(*(ref_leaves[k] for k in names), chunk=chunk)
    torch.sum(y_ref * w).backward()
    errs = {"y": _rel_err(y, y_ref[:, part].detach()), "y_grad_path": _rel_err(
        y_g.detach(), y_ref[:, part].detach())}
    for k in names:
        want_g = ref_leaves[k].grad if k in ("A", "D") else ref_leaves[k].grad[:, part]
        errs[f"d{k}"] = _rel_err(got[k], want_g)
    bad = {k: v for k, v in errs.items() if v[1] > (1e-4 if k.startswith("y") else GRAD_TOL)}
    if bad:
        raise AssertionError(f"rank {rank}: SP disagrees with the plain chunked core: {bad}")
    if rank == 0:
        log(f"rank 0: SP ok, forward {fwd_ms:.3f} ms, forward + backward {train_ms:.3f} ms")
    return fwd_launches, train_launches, {
        "shape": dict(B=B, L=L, heads=h, chunk=chunk, ranks=TP), "fwd_ms": fwd_ms,
        "fwd_bwd_ms": train_ms, "rel_err_of_max": {k: v[1] for k, v in errs.items()}}


TP_PERF_STEPS = 2  # phase 21's and phase 26's bf16 tensor-parallel train steps


def tp_ssd_perf_rank(device, mesh, rank: int) -> tuple[dict, dict, dict]:
    """Phase 21: the SSD presets' classifier (bf16, subspace) with its mixers
    over the 2-rank model axis. One forward of 20 clouds must launch the bf16
    conv 24 times and the lean bf16 K6 12 times, nothing else, its logits
    within PERF_LOGITS_TOL of the single-process bf16 'xla' model's; then
    TP_PERF_STEPS finetune steps at batch 32 from 8192-point clouds, each
    launching the bf16 conv forward and backward 24 times and the bf16 K6
    with states and K7 12 times, nothing else, every loss finite. Returns
    (the forward's launches, the steps' launches, record)."""
    return tp_perf_rank(
        device, mesh, rank, MODELNET40_SSD_PERF, "xla", "bf16 TP SSD",
        {"causal_conv1d_silu_bf16": 24, "ssd_split_fwd_bf16": 12},
        {"causal_conv1d_silu_bf16": 24, "causal_conv1d_silu_bwd_bf16": 24,
         "ssd_split_fwd_states_bf16": 12, "ssd_split_bwd_bf16": 12})


def tp_mamba_perf_rank(device, mesh, rank: int) -> tuple[dict, dict, dict]:
    """Phase 26: perf mode's Mamba-1 classifier (bf16, subspace) with its
    mixers over the 2-rank model axis. Its tensor-parallel mixer promotes the
    bf16 input to fp32 at the fp32 weights, as the JAX package's does, so the
    fp32 kernels run: one forward of 20 clouds must launch the conv and the
    lean scan 12 times each, nothing else, its logits within PERF_LOGITS_TOL
    of the single-process bf16 'seq' model's; then TP_PERF_STEPS finetune
    steps, each launching the conv forward and backward and the training
    scan forward and backward 12 times each, nothing else, every loss
    finite. Returns (the forward's launches, the steps' launches, record)."""
    return tp_perf_rank(
        device, mesh, rank, MODELNET40_PERF, "seq", "bf16 TP Mamba-1",
        {k: 12 for k in EVAL_KERNELS}, {k: 12 for k in TRAIN_KERNELS})


def tp_perf_rank(device, mesh, rank: int, base: dict, plain_impl: str, what: str,
                 fwd_kernels: dict, step_kernels: dict) -> tuple[dict, dict, dict]:
    """The classifier of ``base`` (perf mode) with its mixers over the 2-rank
    model axis: one forward of 20 clouds must launch ``fwd_kernels`` (by
    name, the count a forward) and nothing else, its logits within
    PERF_LOGITS_TOL of the single-process model on ``plain_impl``; then
    TP_PERF_STEPS finetune steps at batch 32 from 8192-point clouds, each
    launching ``step_kernels`` and nothing else, every loss finite. Returns
    (the forward's launches, the steps' launches, record)."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.train.optim import build_optimizer
    from si_mamba_tpu_torch.train.runner_finetune import make_train_step
    from si_mamba_tpu_torch.train.train_state import TrainState

    sd = _full_state(base, seed=0)
    model = _tp_model(base, mesh, sd, rank).to(device)
    pts = torch.from_numpy(clouds(20, seed=20)).to(device)
    with torch.inference_mode():
        model.eval()(pts)  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()  # the bf16 TP serving path
        t0 = time.perf_counter()
        logits = model(pts)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_launches = _launch_counts()
    want = _counts_expect(fwd_kernels, 1)
    if fwd_launches != want:
        raise AssertionError(f"rank {rank}: {what} forward launched {fwd_launches}, "
                             f"expected {want}")
    plain = PointMamba(PointMambaConfig.from_dict({**base, "scan_impl": plain_impl}))
    plain.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        ref = plain.to(device).eval()(pts).float()
    logits = logits.float()
    scale, err = ref.abs().max().item(), (logits - ref).abs().max().item()
    if not torch.allclose(logits, ref, atol=PERF_LOGITS_TOL * scale, rtol=PERF_LOGITS_TOL):
        raise AssertionError(f"rank {rank}: {what} logits disagree with the single-process "
                             f"{plain_impl!r} model: max |diff| {err}, max |logit| {scale}")
    del plain

    model.train()
    optimizer, _ = build_optimizer(model, opt_type="AdamW", lr=3e-4, weight_decay=0.05,
                                   epochs=300, warmup_epochs=10, steps_per_epoch=2,
                                   grad_clip=10.0, tp=model.tp_sharding())
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, NPOINTS, rotation=False)
    pts_np, labels_np = _train_clouds(TRAIN_BATCH, seed=7)
    points, labels = torch.from_numpy(pts_np).to(device), torch.from_numpy(labels_np).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    expect = _counts_expect(step_kernels, 1)
    torch.cuda.synchronize()
    _reset_launch_counts()  # the bf16 TP train path
    times, losses = [], []
    for i in range(TP_PERF_STEPS):
        before = _launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, points, labels, generator)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
        now = _launch_counts()
        got = {k: now[k] - before[k] for k in now}
        if got != expect or not np.isfinite(losses[-1]):
            raise AssertionError(f"rank {rank}: {what} train step {i + 1} launched {got} "
                                 f"(expected {expect}), loss {losses[-1]}")
    train_launches = _launch_counts()
    record = {"forward_clouds": 20, "forward_ms": fwd_ms, "logits_max_abs_diff": err,
              "logits_max_abs": scale, "train_batch": TRAIN_BATCH, "train_steps": TP_PERF_STEPS,
              "step_ms": [t * 1e3 for t in times], "losses": losses}
    if rank == 0:
        log(f"rank 0: {what} ok: forward of 20 clouds {fwd_ms:.3f} ms, logits vs "
            f"{plain_impl!r} max |diff| {err:.3e} (max {scale:.3e}); steps "
            f"{record['step_ms']} ms, losses {losses}")
    return fwd_launches, train_launches, record


def sp_bf16_rank(device, rank: int) -> tuple[dict, dict, dict]:
    """Phase 22: ``ssd_seq_parallel(impl='ssd_fused')`` at bf16 (x, B, C bf16;
    dt, A, D fp32) on 2 ranks at the shapes of phase 13. Without a gradient
    it must launch the bf16 K6 with h_fin once a rank, with one the bf16 K6
    with states and h_fin and the seeded bf16 K7 once each. Held against the
    same program on CPU copies of the same inputs, where each wrapper takes
    its kernel's plain version (the rank-0 carry and the dh_fin seed the
    plain run's own): y within 1e-2 of its max, every gradient within 3e-2
    (the per-head A and D, sums over every token, within 6e-2). Then the
    carry across ranks: the same within the same tolerances of the
    single-process bf16 split core on the card over the whole sequence
    (``ssd_chunked_split``, no carry across ranks)."""
    from si_mamba_tpu_torch.ops.kernels.ssd import ssd_chunked_split
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import ssd_seq_parallel

    mesh = make_mesh(("seq",), (TP,))
    B, L, h, p, n, chunk = (SP_SHAPE[k] for k in ("B", "L", "h", "p", "n", "chunk"))
    rng = np.random.default_rng(23)
    host = {"x": rng.standard_normal((B, L, h, p), dtype=np.float32),
            "dt": np.log1p(np.exp(rng.standard_normal((B, L, h), dtype=np.float32) - 3.0)),
            "A": -np.exp(rng.standard_normal(h, dtype=np.float32)),
            "Bm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "Cm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "D": rng.standard_normal(h, dtype=np.float32)}
    w = torch.from_numpy(rng.standard_normal((B, L, h, p), dtype=np.float32)).to(device)
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    full = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        device, torch.bfloat16 if k in ("x", "Bm", "Cm") else torch.float32)
        for k, v in host.items()}
    part = slice(rank * (L // TP), (rank + 1) * (L // TP))
    local = {k: (v[:, part].contiguous() if v.dim() > 1 else v) for k, v in full.items()}
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_launch_counts()  # the bf16 no-gradient path
        y = ssd_seq_parallel(*(local[k] for k in names), mesh=mesh, chunk=chunk,
                             impl="ssd_fused")
        torch.cuda.synchronize()
        fwd_launches = _launch_counts()
    want = _counts_expect({"ssd_split_fwd_hfin_bf16": 1}, 1)
    if fwd_launches != want:
        raise AssertionError(f"rank {rank}: bf16 SP forward launched {fwd_launches}, "
                             f"expected {want}")

    def train(inputs, weight):
        leaves = {k: v.clone().requires_grad_() for k, v in inputs.items()}
        out = ssd_seq_parallel(*(leaves[k] for k in names), mesh=mesh, chunk=chunk,
                               impl="ssd_fused")
        torch.sum(out.float() * weight).backward()
        return out.detach(), {k: v.grad for k, v in leaves.items()}

    _reset_launch_counts()  # the bf16 gradient path
    _, grads = train(local, w[:, part])
    torch.cuda.synchronize()
    train_launches = _launch_counts()
    want = _counts_expect({"ssd_split_fwd_states_hfin_bf16": 1,
                           "ssd_split_bwd_seeded_bf16": 1}, 1)
    if train_launches != want:
        raise AssertionError(f"rank {rank}: bf16 SP train launched {train_launches}, "
                             f"expected {want}")
    tol = {"y": 1e-2, "dA": 6e-2, "dD": 6e-2}

    def held(what, y_ref, ref_grads, sliced):
        errs = {"y": _rel_err(y.float(), y_ref.to(device).float())}
        for k in names:
            g = ref_grads[k].to(device)
            errs[f"d{k}"] = _rel_err(grads[k].float(), (g[:, part] if sliced and k not in (
                "A", "D") else g).float())
        bad = {k: v for k, v in errs.items() if v[1] > tol.get(k, 3e-2)}
        if bad:
            raise AssertionError(f"rank {rank}: bf16 SP disagrees with {what}: {bad}")
        return {k: v[1] for k, v in errs.items()}

    cpu = {k: v.cpu() for k, v in local.items()}  # the wrappers' plain versions
    y_plain, plain_grads = train(cpu, w[:, part].cpu())
    plain = held("its plain version", y_plain, plain_grads, sliced=False)
    whole = {k: v.clone().requires_grad_() for k, v in full.items()}
    y_whole = ssd_chunked_split(*(whole[k] for k in names), chunk=chunk)
    torch.sum(y_whole.float() * w).backward()
    carry = held("the single-process split core", y_whole[:, part].detach(),
                 {k: v.grad for k, v in whole.items()}, sliced=True)
    if rank == 0:
        log(f"rank 0: bf16 SP ok, of the max against its plain version: " +
            ", ".join(f"{k} {v:.3e}" for k, v in plain.items()) + "; against the "
            "single-process split core: " + ", ".join(f"{k} {v:.3e}" for k, v in carry.items()))
    return fwd_launches, train_launches, {"rel_err_of_max_to_plain": plain,
                                          "rel_err_of_max_to_single_process": carry}


def tp_mamba_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 14: one forward of the full-width Mamba-1 model with its mixers
    over the model axis, ``scan_impl='pallas'``: K1 and K2 12 times a rank,
    nothing else; the logits match the single-process 'seq' model."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    base = {**MODELNET40, "scan_impl": "pallas"}
    sd = _full_state(base, seed=0)
    model = _tp_model(base, mesh, sd, rank).to(device).eval()
    pts = torch.from_numpy(clouds(20, seed=20)).to(device)
    with torch.inference_mode():
        model(pts)  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        logits = model(pts)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launch_counts()
    want = _counts_expect({"causal_conv1d_silu": 12, "selective_scan_fwd": 12}, 1)
    if launches != want:
        raise AssertionError(f"rank {rank}: Mamba-1 TP forward launched {launches}, "
                             f"expected {want}")
    plain = PointMamba(PointMambaConfig.from_dict({**MODELNET40, "scan_impl": "seq"}))
    plain.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        ref = plain.to(device).eval()(pts)
    scale = ref.abs().max().item()
    err = (logits - ref).abs().max().item()
    if not torch.allclose(logits, ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"rank {rank}: Mamba-1 TP logits disagree with 'seq': max |diff| "
                             f"{err}, max |logit| {scale}")
    return launches, {"clouds": 20, "forward_ms": ms, "logits_max_abs_diff": err,
                      "logits_max_abs": scale}


def parallel_rank(rank: int, rdzv: str, out_dir: str) -> None:
    """One rank of phases 11-14 and 49 (a spawned process on cuda:0, gloo
    over the loopback interface; a collective that waits 10 minutes fails)."""
    import datetime

    import torch.distributed as dist

    from si_mamba_tpu_torch.parallel import make_mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=TP,
                            timeout=datetime.timedelta(minutes=10))
    try:
        mesh = make_mesh(("model",), (TP,))
        paths, out = {}, {}
        paths["tp_ssd_serving"], out["tp_ssd_serving"] = tp_serving_rank(device, mesh, rank)
        paths["tp_ssd_train"], out["tp_ssd_train"] = tp_train_rank(device, mesh, rank)
        paths["sp"], paths["sp_train"], out["sp"] = sp_rank(device, rank)
        paths["tp_mamba_serving"], out["tp_mamba_serving"] = tp_mamba_rank(device, mesh, rank)
        paths["tp_ssd_perf_serving"], paths["tp_ssd_perf_train"], out["tp_ssd_perf"] = \
            tp_ssd_perf_rank(device, mesh, rank)
        paths["sp_bf16"], paths["sp_bf16_train"], out["sp_bf16"] = sp_bf16_rank(device, rank)
        paths["tp_mamba_perf_serving"], paths["tp_mamba_perf_train"], out["tp_mamba_perf"] = \
            tp_mamba_perf_rank(device, mesh, rank)
        torch.cuda.empty_cache()
        paths["sp_mamba"], out["sp_mamba"] = sp_mamba_rank(device, rank)
        wide_paths, out["wide"] = wide_parallel_rank(device, mesh, rank)
        paths.update(wide_paths)
        torch.save({"paths": paths, "records": out}, f"{out_dir}/parallel_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_phases(card: str) -> tuple[dict, dict]:
    """Phases 11-14 and 49 on TP = 2 ranks, spawned on the one card. Returns (each
    path's launches on rank 0, the record); fails unless both ranks ran
    every phase with the same launches and the same losses, and the
    gathered B = 4 gradients match the single-process model's."""
    import torch.multiprocessing as mp

    from si_mamba_tpu_torch.models import PointMambaConfig
    from si_mamba_tpu_torch.utils.weights import gather_state_dict

    out_dir = ROOT / "build"
    rdzv = out_dir / "parallel_rdzv"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    rdzv.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(str(rdzv), str(out_dir)), nprocs=TP,
                       start_method="spawn", join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"parallel_rank{r}.pt", weights_only=False) for r in range(TP)]
    if ranks[0]["paths"] != ranks[1]["paths"]:
        raise AssertionError(f"the ranks launched differently: {[r['paths'] for r in ranks]}")
    train = [r["records"]["tp_ssd_train"] for r in ranks]
    if train[0]["losses"] != train[1]["losses"]:  # bitwise: the ranks hold one model
        raise AssertionError(f"the ranks' losses differ: {[t['losses'] for t in train]}")
    for key in ("tp_ssd_perf", "tp_mamba_perf"):
        perf = [r["records"][key] for r in ranks]
        if perf[0]["losses"] != perf[1]["losses"]:
            raise AssertionError(f"the ranks' {key} losses differ: "
                                 f"{[t['losses'] for t in perf]}")

    cfg = PointMambaConfig.from_dict({**MODELNET40_SSD, "tp_axis": "model"})
    grads = gather_state_dict([t.pop("grads") for t in train], cfg)
    ref = train[0].pop("reference")
    train[1].pop("reference")
    g0 = train[0]["gradients"]
    if not np.isclose(g0["loss"], ref["loss"], rtol=2e-4, atol=0) or not np.isclose(
            g0["norm"], ref["norm"], rtol=1e-4):
        raise AssertionError(f"TP loss {g0['loss']} / norm {g0['norm']} against single-process "
                             f"{ref['loss']} / {ref['norm']}")
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    worst_leaf, worst_dominant = 0.0, 0.0
    for k, want in ref["grads"].items():
        diff = (grads[k] - want).abs().max().item()
        worst_leaf = max(worst_leaf, diff / gmax)
        if diff >= GRAD_TOL * gmax:
            raise AssertionError(f"TP gradient {k} differs by {diff} (max gradient {gmax})")
        bmax = want.abs().max().item()
        if bmax > 0.1 * gmax:
            worst_dominant = max(worst_dominant, diff / bmax)
    g0.update(reference_loss=ref["loss"], reference_norm=ref["norm"], max_grad=gmax,
              worst_leaf_diff_over_max_grad=worst_leaf,
              worst_dominant_leaf_rel_diff=worst_dominant)
    rec = ranks[0]["records"]
    log(f"TP SSD serving (2 ranks, gloo, one card): " + ", ".join(
        f"{n} clouds p50 {rec['tp_ssd_serving'][str(n)]['p50_ms']:.3f} ms" for n in REQUEST_SIZES)
        + f"; logits vs 'xla' max |diff| {rec['tp_ssd_serving']['logits_max_abs_diff']:.3e}")
    for r, t in enumerate(train):
        log(f"TP SSD train rank {r}: p50 {t['p50_step_ms']:.3f} ms, {t['clouds_per_s']:.2f} "
            f"clouds/s, peak {t['max_memory_allocated_bytes'] / 2**30:.3f} GiB, losses "
            f"{['%.4f' % v for v in t['losses']]}")
    log(f"TP gradients at B={PARITY_BATCH}, clipped at {g0['clip']:.4f} (norm {g0['norm']:.4f}, "
        f"single-process {ref['norm']:.4f}): worst leaf {worst_leaf:.3e} of max gradient "
        f"{gmax:.3e}, worst dominant leaf {worst_dominant:.3e} relative")
    log(f"SP: {rec['sp']}")
    log(f"Mamba-1 TP: {rec['tp_mamba_serving']}; ranks' wall {wall:.1f} s")
    log(f"bf16 TP SSD: {rec['tp_ssd_perf']}; bf16 SP: {rec['sp_bf16']}")
    log(f"bf16 TP Mamba-1: {rec['tp_mamba_perf']}")
    log(f"Mamba-1 SP scan (phase 49): {[r['records']['sp_mamba'] for r in ranks]}")
    log(f"wide-state TP and SP (phase 57): {[r['records']['wide'] for r in ranks]}")
    record = {"ranks": TP, "backend": "gloo", "wall_s": wall, "card": card,
              "tp_ssd_serving": rec["tp_ssd_serving"],
              "tp_ssd_train": {f"rank{r}": t for r, t in enumerate(train)},
              "sp": rec["sp"], "tp_mamba_serving": rec["tp_mamba_serving"],
              "tp_ssd_perf": rec["tp_ssd_perf"], "sp_bf16": rec["sp_bf16"],
              "tp_mamba_perf": rec["tp_mamba_perf"],
              "sp_mamba": {f"rank{r}": x["records"]["sp_mamba"] for r, x in enumerate(ranks)},
              "wide": {f"rank{r}": x["records"]["wide"] for r, x in enumerate(ranks)}}
    return ranks[0]["paths"], record


# phase 15: the finetune harness through its CLI, at the preset's full model
HARNESS_CLASSES = 40
HARNESS_TRAIN = 64  # two steps an epoch at the preset's total_bs 32, drop_last
HARNESS_TEST = 80  # 40 copies of one cloud, then 40 distinct clouds, each set labelled 0..39
HARNESS_FPS_CHECK = 4  # train clouds whose cached FPS is held against the CPU's
HARNESS_VOTES = 10


def write_modelnet_tree(root: Path, splits: dict, n_classes: int = HARNESS_CLASSES) -> Path:
    """A ModelNet40-format tree: ``modelnet40_shape_names.txt``, one list a
    split, and each cloud (N, 6: x y z and a normal) as comma-separated text
    under its class. ``splits``: split -> [(label, cloud), ...]."""
    names = [f"class{c:02d}" for c in range(n_classes)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    for split, clouds in splits.items():
        ids = []
        for k, (label, cloud) in enumerate(clouds):
            (root / names[label]).mkdir(exist_ok=True)
            ids.append(f"{names[label]}_{split}{k:04d}")
            np.savetxt(root / names[label] / f"{ids[-1]}.txt", cloud, fmt="%.6f", delimiter=",")
        (root / f"modelnet40_{split}.txt").write_text("\n".join(ids) + "\n")
    return root


class _LogCapture:
    """The messages of the port's logger while it is entered."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.messages.append(record.getMessage())

        self.messages, self.handler = [], Handler()
        self.logger = logging.getLogger("si_mamba_tpu_torch")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def harness_phase(device, card: str) -> tuple[dict, dict]:
    """The finetune harness through ``si_mamba_tpu_torch.train.cli.main``,
    in-process, on a ModelNet40-format tree written under build/harness/ from
    a seed: 64 train clouds (labels 0..39 in turn) and 80 test clouds: 40
    copies of one cloud labelled 0..39, so that every validation gets at
    least one right and the run saves ckpt-best, then 40 distinct clouds
    labelled 0..39, so that a fault that swaps or mixes rows shows in the
    logits; 8192 points each. The FPS cache built on the card is held against
    ``fps_indices`` on the CPU for a few train clouds. The
    experiment config is cfgs/finetune_modelnet.yaml (the published model at
    full width and depth) with max_epoch 1 and its dataset entries on the
    tree. Runs: the finetune (epochs 0 and 1, two steps each, a validation
    after each), ``--test`` of its ckpt-last.pth, ``--resume`` of the
    finished run, and one ``validate_vote`` of 10 passes. Returns (each
    run's launches, the record)."""
    import shutil
    import types

    from si_mamba_tpu_torch.data.datasets import ModelNet, fps_indices
    from si_mamba_tpu_torch.train import checkpoint as ckpt
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.config import get_config
    from si_mamba_tpu_torch.train.registry import build_model_from_cfg
    from si_mamba_tpu_torch.train.yaml_subset import load as yaml_load
    from si_mamba_tpu_torch.utils.weights import load_state_dict_file

    t_phase = time.perf_counter()
    work = ROOT / "build" / "harness"
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    def cloud():
        return rng.standard_normal((TRAIN_POINTS, 6)).astype(np.float32)

    copied = cloud()
    train_clouds = [(i % HARNESS_CLASSES, cloud()) for i in range(HARNESS_TRAIN)]
    data = write_modelnet_tree(work / "modelnet40", {
        "train": train_clouds,
        "test": [(c % HARNESS_CLASSES, copied if c < HARNESS_CLASSES else cloud())
                 for c in range(HARNESS_TEST)]})
    write_s = time.perf_counter() - t0
    (work / "modelnet40.yaml").write_text(
        f"NAME: ModelNet\nDATA_PATH: {data}\nN_POINTS: {TRAIN_POINTS}\n"
        f"NUM_CATEGORY: {HARNESS_CLASSES}\nUSE_NORMALS: FALSE\n")
    exp_cfg = work / "harness_modelnet.yaml"
    exp_cfg.write_text(f"_base_: {ROOT}/cfgs/finetune_modelnet.yaml\nmax_epoch: 1\ndataset:\n" + "".join(
        f"  {name}: {{_base_: {work}/modelnet40.yaml, others: {{subset: '{subset}'}}}}\n"
        for name, subset in (("train", "train"), ("val", "test"), ("test", "test"))))
    config = get_config(str(exp_cfg))
    if (config.model.trans_dim, config.model.depth, config.total_bs) != (384, 12, TRAIN_BATCH):
        raise AssertionError(f"the harness config is not the preset's: {config.model}")
    depth = int(config.model.depth)

    # the FPS caches (8192 of 8192 points, the preset's N_POINTS) on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for subset in ("train", "test"):
        ModelNet(str(data), subset=subset, npoints=TRAIN_POINTS, device=device)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    # the cache's points are those the CPU's FPS picks from the written text
    with open(data / f"modelnet40_train_{TRAIN_POINTS}pts_fps.dat", "rb") as f:
        cached, _ = pickle.load(f)
    t0 = time.perf_counter()
    for k in range(HARNESS_FPS_CHECK):
        written = np.loadtxt(data / f"class{k:02d}" / f"class{k:02d}_train{k:04d}.txt",
                             delimiter=",").astype(np.float32)
        rows = fps_indices(torch.from_numpy(written[None, :, :3]), TRAIN_POINTS)[0].numpy()
        if not np.array_equal(cached[k], written[rows]):
            raise AssertionError(f"train cloud {k}: the FPS cache built on the card differs from "
                                 f"fps_indices on the CPU")
    fps_check_s = time.perf_counter() - t0

    steps, validations, saves = [], [], []
    real = (rf.make_train_step, rf.validate, ckpt.save_checkpoint)

    def delta(before):
        now = _launch_counts()
        return {k: now[k] - before[k] for k in now}

    def timed_train_step(*a, **k):
        step = real[0](*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            state, metrics = step(*sa, **sk)
            loss = metrics["loss"].item()
            steps.append({"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                          "launches": delta(before)})
            return state, metrics

        return run

    def timed_validate(eval_step, state, loader, epoch=0):
        logits = []

        def recording(st, pts):
            logits.append(eval_step(st, pts))
            return logits[-1]

        torch.cuda.synchronize()
        before, t = _launch_counts(), time.perf_counter()
        acc = real[1](recording, state, loader, epoch)
        validations.append({"ms": (time.perf_counter() - t) * 1e3, "acc": acc,
                            "forwards": len(logits), "launches": delta(before),
                            "logits": torch.cat(logits).float().cpu()})
        return acc

    def timed_save(exp_dir, prefix, *a, **k):
        t = time.perf_counter()
        real[2](exp_dir, prefix, *a, **k)
        saves.append({"prefix": prefix, "ms": (time.perf_counter() - t) * 1e3})

    cwd = os.getcwd()
    os.chdir(work)  # the CLI's experiments/ tree
    rf.make_train_step, rf.validate, ckpt.save_checkpoint = timed_train_step, timed_validate, timed_save
    paths = {}
    try:
        base = ["--config", str(exp_cfg), "--device", "cuda"]
        with _LogCapture() as train_log:
            _reset_launch_counts()  # the harness's main path: the finetune run
            t0 = time.perf_counter()
            state, best = cli.main(base + ["--exp_name", "run"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            paths["harness_train"] = _launch_counts()
        exp = work / "experiments" / "harness_modelnet" / "run"
        train_val = list(validations)

        _reset_launch_counts()
        validations.clear()
        test_acc = cli.main(base + ["--exp_name", "test", "--test", "--ckpts",
                                    str(exp / "ckpt-last.pth")])
        paths["harness_eval"] = _launch_counts()
        test_val = validations[0]

        with _LogCapture() as resume_log:
            _reset_launch_counts()
            resumed, _ = cli.main(base + ["--exp_name", "run", "--resume"])
            resume_counts = _launch_counts()
    finally:
        rf.make_train_step, rf.validate, ckpt.save_checkpoint = real
        os.chdir(cwd)

    # the finetune run: 2 epochs of 2 steps, each step the train kernels once a
    # block and no other kernel; each validation forward the eval kernels
    n_steps = 2 * (HARNESS_TRAIN // TRAIN_BATCH)
    if len(steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"the finetune run took {len(steps)} steps, expected {n_steps}")
    for i, s in enumerate(steps):
        if s["launches"] != _expect(depth, TRAIN_KERNELS):
            raise AssertionError(f"harness train step {i} launched {s['launches']}")
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"harness train step {i} gave loss {s['loss']}")
    for v in train_val + [test_val]:
        if v["launches"] != _expect(depth * v["forwards"], EVAL_KERNELS):
            raise AssertionError(f"a harness validation of {v['forwards']} forwards launched "
                                 f"{v['launches']}")
    if len(train_val) != 2 or any(v["acc"] < 100.0 / HARNESS_TEST for v in train_val):
        raise AssertionError(f"validation accuracies {[v['acc'] for v in train_val]}: the "
                             f"{HARNESS_CLASSES} copies of one cloud give at least one right")
    for v in train_val:
        copies = v["logits"][:HARNESS_CLASSES]
        spread = (copies - copies[:1]).abs().max().item()
        if spread > 1e-4 * copies.abs().max().item():
            raise AssertionError(f"one batch's copies of one cloud got logits {spread} apart")
    expect_total = {k: sum(s["launches"][k] for s in steps) +
                    sum(v["launches"][k] for v in train_val) for k in _launch_counts()}
    if paths["harness_train"] != expect_total:
        raise AssertionError(f"the finetune run launched {paths['harness_train']} in all, its "
                             f"steps and validations {expect_total}")
    files = {p.name for p in exp.iterdir()}
    missing = {"ckpt-best.pth", "ckpt-last.pth", "config.yaml", "scalars.jsonl"} - files
    if missing:
        raise AssertionError(f"the finetune run did not write {missing}")
    # best (when the accuracy rose), then last, each epoch
    order, best_acc = [], 0.0
    for v in train_val:
        if v["acc"] > best_acc:
            order.append("ckpt-best")
            best_acc = v["acc"]
        order.append("ckpt-last")
    if [s["prefix"] for s in saves] != order:
        raise AssertionError(f"checkpoints saved in the order {saves}, the accuracies "
                             f"{[v['acc'] for v in train_val]} give {order}")
    best_epoch = torch.load(exp / "ckpt-best.pth", map_location="cpu", weights_only=True)["epoch"]
    if train_val[best_epoch]["acc"] != best_acc:
        raise AssertionError(f"ckpt-best.pth holds epoch {best_epoch}, the best is {best_acc}")
    with open(exp / "config.yaml") as f:
        if yaml_load(f.read()) != config:
            raise AssertionError("the config snapshot does not read back to the config")
    scalars = [json.loads(line) for line in (exp / "scalars.jsonl").read_text().splitlines()]
    tags = [(r["tag"], r["step"]) for r in scalars]
    if tags != [(t, e) for e in (0, 1) for t in ("Loss/Epoch/Loss", "LR", "Metric/ACC")]:
        raise AssertionError(f"scalars.jsonl holds {tags}")
    if not all(np.isfinite(r["value"]) for r in scalars):
        raise AssertionError(f"non-finite scalars: {scalars}")
    last_acc = [r["value"] for r in scalars if r["tag"] == "Metric/ACC"][-1]

    # --test of ckpt-last: the last validation's accuracy, and its logits
    if test_acc != last_acc:
        raise AssertionError(f"--test gave {test_acc}, the last validation {last_acc}")
    if paths["harness_eval"] != _expect(depth * test_val["forwards"], EVAL_KERNELS):
        raise AssertionError(f"--test launched {paths['harness_eval']}")
    want = train_val[-1]["logits"]
    test_diff = (test_val["logits"] - want).abs().max().item()
    if test_diff > 1e-4 * want.abs().max().item():
        raise AssertionError(f"--test logits differ from the last validation's by {test_diff}")
    if not torch.equal(test_val["logits"].argmax(-1), want.argmax(-1)):
        raise AssertionError("--test predicts other classes than the last validation")

    # --resume of the finished run restores epoch 1 and trains nothing
    payload = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)
    if payload["epoch"] != 1 or resumed.step != n_steps:
        raise AssertionError(f"--resume restored epoch {payload['epoch']}, step {resumed.step}")
    if any(resume_counts.values()) or not any("training already complete" in m
                                             for m in resume_log.messages):
        raise AssertionError(f"--resume of a finished run launched {resume_counts}: "
                             f"{resume_log.messages}")

    # one validate_vote of HARNESS_VOTES passes over the test loader
    model, _ = build_model_from_cfg(config.model, device)
    model.load_state_dict(load_state_dict_file(str(exp / "ckpt-last.pth")), strict=True)
    args = types.SimpleNamespace(device="cuda", seed=0, num_workers=4, way=-1, shot=-1, fold=-1)
    loader = cli.build_loader(config.dataset.test, args, "test", TRAIN_BATCH, False, False)
    vote_step = rf.make_vote_step(model, NPOINTS, rotation=False, times=HARNESS_VOTES)
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vote_acc = rf.validate_vote(vote_step, rf.TrainState(0, model, None), loader, seed=0)
    torch.cuda.synchronize()
    vote_ms = (time.perf_counter() - t0) * 1e3
    paths["harness_vote"] = _launch_counts()
    if paths["harness_vote"] != _expect(depth * HARNESS_VOTES * len(loader), EVAL_KERNELS):
        raise AssertionError(f"validate_vote launched {paths['harness_vote']}")

    epoch_s = [float(m.split("EpochTime = ")[1].split()[0]) for m in train_log.messages
               if "EpochTime = " in m]
    step_ms = [s["ms"] for s in steps]
    p50 = statistics.median(step_ms[1:])
    last_save = [s["ms"] for s in saves if s["prefix"] == "ckpt-last"]
    record = {"config": "cfgs/finetune_modelnet.yaml, max_epoch 1", "train_clouds": HARNESS_TRAIN,
              "test_clouds": HARNESS_TEST, "points": TRAIN_POINTS, "batch": TRAIN_BATCH,
              "data_write_s": write_s, "cache_build_s": cache_s,
              "cache_cpu_fps_check_s": fps_check_s, "finetune_run_s": run_s,
              "epoch_s": epoch_s, "step_ms": step_ms, "p50_step_ms": p50,
              "clouds_per_s": TRAIN_BATCH / (p50 / 1e3), "losses": [s["loss"] for s in steps],
              "validation_ms": [v["ms"] for v in train_val], "val_acc": [v["acc"] for v in train_val],
              "test_acc": test_acc, "test_ms": test_val["ms"], "test_logits_max_abs_diff": test_diff,
              "vote_acc": vote_acc, "vote_ms": vote_ms, "vote_passes": HARNESS_VOTES,
              "ckpt_last_bytes": (exp / "ckpt-last.pth").stat().st_size,
              "ckpt_save_ms": [(s["prefix"], s["ms"]) for s in saves],
              "ckpt_last_save_ms": last_save, "phase_s": time.perf_counter() - t_phase,
              "launches": paths, "card": card}
    log(f"harness: data written in {write_s:.1f} s, FPS caches built in {cache_s:.1f} s; "
        f"finetune {run_s:.1f} s, epochs {epoch_s} s, step p50 {p50:.3f} ms "
        f"({TRAIN_BATCH / (p50 / 1e3):.2f} clouds/s), validation "
        f"{[round(v['ms'], 3) for v in train_val]} ms; ckpt-last.pth "
        f"{record['ckpt_last_bytes']} bytes, saved in {[round(v, 3) for v in last_save]} ms; "
        f"test acc {test_acc} (= last validation), vote acc {vote_acc} in {vote_ms:.1f} ms; "
        f"phase {record['phase_s']:.1f} s; {card}")
    return paths, record


def preset_cli_phase(device, card: str, preset: str, name: str, train_kernels, eval_kernels,
                     model: dict, test: bool = False, override: dict | None = None,
                     width: int = 384, epochs: int = 1) -> tuple[dict, dict]:
    """A shipped preset through the CLI on the tree that ``harness_phase``
    wrote (its FPS caches already built): cfgs/``preset`` at max_epoch 0
    (with the model keys of ``override`` set over it, a config of its own),
    one epoch of HARNESS_TRAIN // TRAIN_BATCH steps and one validation (or
    ``epochs`` of them, max_epoch ``epochs`` - 1). The config's model must
    match ``model`` (and the published 12 x 384 width, or ``width``).
    Every step must launch each of ``train_kernels`` once a block, every
    validation forward each of ``eval_kernels``, and nothing else; the
    epoch's loss finite; ckpt-last.pth written. With ``test``, ``--test`` of
    that checkpoint, launches counted the same way, must give the last
    validation's accuracy. Returns ({name: launches[, name + '_test':
    launches]}, the record)."""
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.config import get_config

    work = ROOT / "build" / "harness"
    stem = "harness_" + (name if override else preset.removesuffix(".yaml"))
    exp_cfg = work / f"{stem}.yaml"
    exp_cfg.write_text(
        f"_base_: {ROOT}/cfgs/{preset}\nmax_epoch: {epochs - 1}\ndataset:\n" + "".join(
            f"  {split}: {{_base_: {work}/modelnet40.yaml, others: {{subset: '{subset}'}}}}\n"
            for split, subset in (("train", "train"), ("val", "test"), ("test", "test"))) +
        ("model: {" + ", ".join(f"{k}: {v}" for k, v in override.items()) + "}\n"
         if override else ""))
    config = get_config(str(exp_cfg))
    model_cfg = config.model
    got = {k: model_cfg.get(k) for k in model}
    if (model_cfg.trans_dim, model_cfg.depth, config.total_bs) != (width, 12, TRAIN_BATCH) or \
            got != model:
        raise AssertionError(f"the {preset} harness config is not the preset's: {model_cfg}")
    depth = int(model_cfg.depth)
    forwards, real = [], rf.validate

    def counting_validate(eval_step, state, loader, epoch=0):
        def recording(st, pts):
            forwards.append(pts.shape[0])
            return eval_step(st, pts)

        return real(recording, state, loader, epoch)

    exp = work / "experiments" / stem / name
    cwd = os.getcwd()
    os.chdir(work)
    rf.validate = counting_validate
    paths = {}
    try:
        _reset_launch_counts()  # the preset's path: counts from 0, then the run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = cli.main(["--config", str(exp_cfg), "--device", "cuda", "--exp_name", name])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        paths[name] = _launch_counts()
        n_forwards = len(forwards)
        if test:
            forwards.clear()
            _reset_launch_counts()  # the test run's path
            test_acc = cli.main(["--config", str(exp_cfg), "--device", "cuda", "--exp_name",
                                 name + "_test", "--test", "--ckpts", str(exp / "ckpt-last.pth")])
            paths[name + "_test"] = _launch_counts()
    finally:
        rf.validate = real
        os.chdir(cwd)
    steps = epochs * (HARNESS_TRAIN // TRAIN_BATCH)
    if state.step != steps or state.model.config.dtype != model_cfg.dtype:
        raise AssertionError(f"the {preset} run took {state.step} steps at "
                             f"{state.model.config.dtype}, expected {steps} at {model_cfg.dtype}")
    want = {k: depth * (steps * (k in train_kernels) + n_forwards * (k in eval_kernels))
            for k in paths[name]}
    if paths[name] != want:
        raise AssertionError(f"the {preset} run launched {paths[name]}; expected {want}")
    scalars = [json.loads(line) for line in (exp / "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in scalars if r["tag"] == "Loss/Epoch/Loss"]
    if len(losses) != epochs or not np.isfinite(losses).all() or \
            not (exp / "ckpt-last.pth").exists():
        raise AssertionError(f"the {preset} run logged {scalars}")
    val_acc = [r["value"] for r in scalars if r["tag"] == "Metric/ACC"]
    record = {"config": f"cfgs/{preset}, max_epoch {epochs - 1}" +
              (f", model {override}" if override else ""), "steps": steps,
              "validation_forwards": n_forwards, "run_s": run_s, "epoch_loss": losses[-1],
              "val_acc": val_acc, "launches": paths[name], "card": card}
    if test:
        want = {k: depth * len(forwards) * (k in eval_kernels) for k in paths[name + "_test"]}
        if paths[name + "_test"] != want or test_acc != val_acc[-1]:
            raise AssertionError(f"--test of the {preset} run launched {paths[name + '_test']} "
                                 f"(expected {want}) and gave {test_acc}, the last validation "
                                 f"{val_acc[-1]}")
        record.update(test_acc=test_acc, test_forwards=len(forwards),
                      test_launches=paths[name + "_test"])
    log(f"{record['config']} through the CLI: {steps} steps and {epochs} validation(s), "
        f"{n_forwards} forwards in all, in {run_s:.1f} s, epoch losses {losses}; launches "
        f"{paths[name]}; {card}"
        + (f"; --test accuracy {test_acc} over {len(forwards)} forwards" if test else ""))
    return paths, record


def perf_harness_phase(device, card: str) -> tuple[dict, dict]:
    """The perf preset through the CLI: cfgs/finetune_modelnet_perf.yaml (the
    published model, bf16, subspace) by ``preset_cli_phase``, the bf16
    Mamba-1 kernels on its path. Returns ({"perf_cli": launches}, the
    record)."""
    return preset_cli_phase(device, card, "finetune_modelnet_perf.yaml", "perf_cli",
                            PERF_TRAIN_KERNELS, PERF_EVAL_KERNELS,
                            {"dtype": "bfloat16", "spectral_method": "subspace"})


def fused_perf_cli_phase(device, card: str) -> tuple[dict, dict]:
    """The fused perf configuration through the CLI: cfgs/finetune_modelnet_perf.yaml
    (the published model, bf16, subspace) with ``model.scan_impl: fused``,
    written here (the JAX package ships no such preset), by
    ``preset_cli_phase``, then ``--test`` of its ckpt-last.pth: the bf16 K10
    with states and K11 on the training path, the lean bf16 K10 on the
    validation and test paths. Returns ({"fused_perf_cli": launches,
    "fused_perf_cli_test": launches}, the record)."""
    return preset_cli_phase(device, card, "finetune_modelnet_perf.yaml", "fused_perf_cli",
                            FUSED_PERF_TRAIN_KERNELS, FUSED_PERF_EVAL_KERNELS,
                            {"dtype": "bfloat16", "spectral_method": "subspace",
                             "scan_impl": "fused"}, test=True, override={"scan_impl": "fused"})


def ssd_preset_cli_phase(device, card: str) -> tuple[dict, dict]:
    """The SSD fused preset through the CLI: cfgs/finetune_modelnet_ssd_fused.yaml
    (the SSD classifier, bf16, subspace, 'ssd_fused', chunk 256) as the file
    stands by ``preset_cli_phase``, then ``--test`` of its ckpt-last.pth, the
    bf16 SSD kernels on both paths. Returns ({"ssd_cli": launches,
    "ssd_cli_test": launches}, the record)."""
    return preset_cli_phase(device, card, "finetune_modelnet_ssd_fused.yaml", "ssd_cli",
                            SSD_PERF_TRAIN_KERNELS, SSD_PERF_EVAL_KERNELS,
                            {"dtype": "bfloat16", "spectral_method": "subspace", "mixer": "ssd",
                             "scan_impl": "ssd_fused", "ssd_chunk": 256}, test=True)


# The part-segmentation path (cfgs/part_segmentation*.yaml: total_bs 16, 2048
# points, 128 groups of 32, the HLT canvas of L = 2 * 128 = 256 tokens; the SSD
# preset's chunk 128, two chunks)
SEG_BATCH = 16
SEG_POINTS = 2048
SEG_LEN = 256
SEG_CHUNK = 128
SEG_TRAINVAL = 48  # three steps at total_bs 16
SEG_TEST = 32  # two evaluation batches
SEG_SHAPE_POINTS = 2500  # rows a written shape, resampled to 2048 with replacement
SEG_PRESETS = {
    "part_segmentation.yaml": dict(mixer="mamba", scan_impl="auto"),
    "part_segmentation_ssd_fused.yaml": dict(mixer="ssd", scan_impl="ssd_fused"),
}
SEG_SSD_TRAIN_KERNELS = ("causal_conv1d_silu", "ssd_xbc_fwd_states", "ssd_xbc_bwd",
                         "causal_conv1d_silu_bwd")
SEG_SSD_EVAL_KERNELS = ("causal_conv1d_silu", "ssd_xbc_fwd")


def mamba_at(device, batch: int, length: int, train: bool = True, infer: bool = True) -> dict:
    """The fp32 Mamba-1 kernels at B=batch, L=length as layer 0's mixer makes
    their inputs (K1 on the xi view of the in_proj output, the scan on
    ``scan_operands``), each held against its plain version at the tolerances
    of phases 1-2 and timed beside it: K1, with ``infer`` K2, with ``train``
    K5, K3 and K4. Returns {kernel name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    mixer, p, xz = mixer_inputs(device, batch, length)
    xi = xz[..., :mixer.d_inner]
    g = torch.from_numpy(np.random.default_rng(41).standard_normal(
        xi.shape, dtype=np.float32)).to(device)
    fwd, bwd = conv_records(xi, p["conv_w"], p["conv_b"], g)
    args = scan_operands(device, batch, length)
    out = {"causal_conv1d_silu": fwd}
    if infer:
        k2 = scan_fwd_figures(args)
        k2["plain_ms"] = time_ms(lambda: ks.selective_scan_ref(
            *args[:5], D=args[5], z=args[6], delta_bias=args[7]), 2, warmup=1)
        out["selective_scan_fwd"] = k2
    if train:
        k3, k4 = backward_kernel_phase(device, args)
        out |= {"causal_conv1d_silu_bwd": bwd, "selective_scan_fwd_residuals": k3,
                "selective_scan_bwd": k4}
    return {k: _keep(r) for k, r in out.items()}


def seg_kernel_phase(device) -> dict:
    """K1-K5, K8 and K9 at the part-segmentation path's shapes, each held
    against its plain version at the tolerances of the phases above and timed
    beside it: the Mamba-1 kernels at B=16, L=256 (``mamba_at``: K1 and K5 on
    the xi view, width 768 of a 1536 row, K2, K3 and K4 on K1's output), and
    K1, K5 on the SSD x|B|C view (width 1024 of a 1798 row), K8 (both
    variants) and K9 at 6 heads, chunk 128 (two chunks). Returns {kernel name:
    {view: figures}}."""
    ssd_records, ssd_conv = ssd_kernel_phase(device, SEG_BATCH, SEG_LEN, SEG_CHUNK,
                                             at_clouds=False)
    out = {name: {"mamba1": f} for name, f in mamba_at(device, SEG_BATCH, SEG_LEN).items()}
    for name, f in ssd_conv.items():
        out[name]["ssd"] = _keep(f)
    out |= {r["name"]: {"ssd": _keep(r)} for r in ssd_records}
    log("kernels at the seg shapes (B=16, L=256): " + "; ".join(
        f"{name} {view} {f['ms']:.6f} ms (plain {f['plain_ms']:.6f}, bound "
        f"{f['bound_ms']:.6f})" for name, views in out.items() for view, f in views.items()))
    return out


def write_shapenetpart_tree(root: Path, n_trainval: int, n_test: int,
                            n_points: int = SEG_SHAPE_POINTS, seed: int = 12) -> Path:
    """A tree in ShapeNetPart's layout: ``synsetoffset2category.txt`` with the
    16 categories, ``train_test_split/shuffled_{train,val,test}_file_list.json``
    and one ``<offset>/<shape>.txt`` a shape of ``x y z nx ny nz part`` rows,
    the parts drawn from the category's; the categories taken in turn, every
    fifth trainval shape in the val list."""
    from si_mamba_tpu_torch.data.shapenetpart import SEG_CLASSES

    rng = np.random.default_rng(seed)
    names = list(SEG_CLASSES)
    offsets = {name: f"{2690000 + i:08d}" for i, name in enumerate(names)}
    (root / "train_test_split").mkdir(parents=True, exist_ok=True)
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{name}\t{off}\n" for name, off in offsets.items()))
    lists = {"train": [], "val": [], "test": []}
    for i in range(n_trainval + n_test):
        name = names[i % len(names)]
        split = "test" if i >= n_trainval else ("val" if i % 5 == 4 else "train")
        (root / offsets[name]).mkdir(exist_ok=True)
        rows = np.concatenate([rng.standard_normal((n_points, 6)),
                               rng.choice(SEG_CLASSES[name], (n_points, 1))], axis=1)
        np.savetxt(root / offsets[name] / f"shape{i:04d}.txt", rows, fmt="%.6f")
        lists[split].append(f"shape_data/{offsets[name]}/shape{i:04d}")
    for split, ids in lists.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(
            json.dumps(ids))
    return root


def partseg_cli_phase(device, card: str, preset: str, name: str, train_kernels,
                      eval_kernels, dtype: str = "float32") -> tuple[dict, dict]:
    """A shipped part-segmentation preset through ``cli.main`` on a seeded
    ShapeNetPart tree (written once under build/seg/: SEG_TRAINVAL trainval
    shapes, SEG_TEST test shapes): cfgs/``preset`` at max_epoch 1, the full
    published model (12 x 384, taps at 3, 7, 11, 128 groups of 32 of 2048
    points, HLT, total_bs 16). Every train step must launch each of
    ``train_kernels`` 12 times and nothing else, every evaluation forward each
    of ``eval_kernels`` 12 times; the steps' losses finite; every parameter
    and BatchNorm statistic moved from the seeded start; instance and class
    mIoU and accuracy in [0, 1]; ckpt-last.pth and ckpt-best.pth written.
    Returns ({name: launches}, the record: step p50, evaluation ms a batch,
    peak memory). ``dtype``: the model's activation dtype, set over the
    preset's (``model.dtype``) in the run's config."""
    from si_mamba_tpu_torch.models.segmentation import PartSegConfig
    from si_mamba_tpu_torch.train import cli, optim
    from si_mamba_tpu_torch.train import runner_seg as rs
    from si_mamba_tpu_torch.train.config import get_config
    from si_mamba_tpu_torch.train.registry import build_model_from_cfg

    work = ROOT / "build" / "seg"
    tree = work / "shapenetpart"
    t0 = time.perf_counter()
    if not (tree / "synsetoffset2category.txt").exists():
        write_shapenetpart_tree(tree, SEG_TRAINVAL, SEG_TEST)
    write_s = time.perf_counter() - t0
    if not (work / "cfgs").exists():  # the seg presets' _base_ refs are CWD-relative
        os.symlink(ROOT / "cfgs", work / "cfgs")
    exp_cfg = work / f"seg_{name}.yaml"
    exp_cfg.write_text(f"_base_: {ROOT}/cfgs/{preset}\nmax_epoch: 1\ndata_root: {tree}\n" +
                       (f"model: {{dtype: {dtype}}}\n" if dtype != "float32" else ""))
    config = get_config(str(exp_cfg))
    cfg = PartSegConfig.from_dict(config.model)
    want_model = dict(trans_dim=384, depth=12, num_group=128, group_size=32, method="HLT",
                      fetch_idx=(3, 7, 11), dtype=dtype, **SEG_PRESETS[preset])
    if {k: getattr(cfg, k) for k in want_model} != want_model or \
            (config.total_bs, config.npoints) != (SEG_BATCH, SEG_POINTS):
        raise AssertionError(f"the {preset} config is not the preset's: {cfg}")
    depth = cfg.depth
    steps, evals = [], []
    real = (rs.make_seg_train_step, rs.make_seg_eval_step)

    def delta(before):
        now = _launch_counts()
        return {k: now[k] - before[k] for k in now}

    def timed_train_step(*a, **k):
        step = real[0](*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            state, metrics = step(*sa, **sk)
            loss = metrics["loss"].item()
            steps.append({"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                          "grad_norm": float(state.optimizer.last_grad_norm),
                          "launches": delta(before)})
            return state, metrics

        return run

    def timed_eval_step(*a, **k):
        step = real[1](*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            logp = step(*sa, **sk)
            torch.cuda.synchronize()
            evals.append({"ms": (time.perf_counter() - t) * 1e3, "batch": logp.shape[0],
                          "finite": bool(torch.isfinite(logp).all()),
                          "launches": delta(before)})
            return logp

        return run

    exp = work / "experiments" / f"seg_{name}" / name
    cwd = os.getcwd()
    os.chdir(work)
    rs.make_seg_train_step, rs.make_seg_eval_step = timed_train_step, timed_eval_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()  # the preset's path: counts from 0, then the run
        t0 = time.perf_counter()
        state, best = cli.main(["--config", str(exp_cfg), "--device", "cuda", "--exp_name", name])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        rs.make_seg_train_step, rs.make_seg_eval_step = real
        os.chdir(cwd)

    n_steps = SEG_TRAINVAL // SEG_BATCH
    if len(steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"the {preset} run took {len(steps)} steps, expected {n_steps}")
    for i, s in enumerate(steps):
        if s["launches"] != _expect(depth, train_kernels) or not np.isfinite(s["loss"]):
            raise AssertionError(f"{preset} train step {i} launched {s['launches']}, loss "
                                 f"{s['loss']}")
    if [e["batch"] for e in evals] != [SEG_BATCH] * (SEG_TEST // SEG_BATCH):
        raise AssertionError(f"the {preset} evaluation ran batches {evals}")
    for e in evals:
        if e["launches"] != _expect(depth, eval_kernels) or not e["finite"]:
            raise AssertionError(f"a {preset} evaluation forward launched {e['launches']} "
                                 f"(finite log-probs: {e['finite']})")
    total = {k: sum(x["launches"][k] for x in steps + evals) for k in launches}
    if launches != total:
        raise AssertionError(f"the {preset} run launched {launches}, its steps and "
                             f"evaluation forwards {total}")
    files = {p.name for p in exp.iterdir()}
    if not {"ckpt-last.pth", "ckpt-best.pth", "config.yaml", "scalars.jsonl"} <= files:
        raise AssertionError(f"the {preset} run wrote {sorted(files)}")
    payload = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)
    metrics = payload["metrics"]
    if not all(0.0 <= metrics[k] <= 1.0 for k in ("instance_miou", "class_miou", "accuracy")):
        raise AssertionError(f"the {preset} evaluation gave {metrics}")
    # every parameter finite, every BatchNorm statistic and every decayed
    # parameter moved from the run's seeded start. One without decay may stay
    # put: at the warm-up's lr of 1e-6 Adam moves it by less than half an ulp
    # where its gradient is far below Adam's eps (1e-8), or is zero, as after
    # a step whose gradient norm is not finite (clip 10 scales by 10 / inf, as
    # optax's clip does in the JAX trainer); the record lists them
    start, _ = build_model_from_cfg(config.model, device, 0)
    start_sd = start.state_dict()
    final = payload["base_model"]
    if not all(torch.isfinite(v).all() for v in final.values()):
        raise AssertionError(f"the {preset} run left non-finite parameters")
    decays = optim.wd_mask(start)
    still = [k for k, v in final.items()
             if "num_batches_tracked" not in k and torch.equal(v, start_sd[k].cpu())]
    if [k for k in still if "running_" in k or decays.get(k, False)]:
        raise AssertionError(f"the {preset} run left {still} at their start (step gradient "
                             f"norms {[s['grad_norm'] for s in steps]})")

    step_ms = [s["ms"] for s in steps]
    p50 = statistics.median(step_ms[1:])
    eval_ms = statistics.median(e["ms"] for e in evals)
    record = {"config": f"cfgs/{preset}, max_epoch 1" +
              (f", model.dtype {dtype}" if dtype != "float32" else ""),
              "trainval_shapes": SEG_TRAINVAL,
              "test_shapes": SEG_TEST, "points": SEG_POINTS, "batch": SEG_BATCH,
              "data_write_s": write_s, "run_s": run_s, "step_ms": step_ms,
              "p50_step_ms": p50, "shapes_per_s": SEG_BATCH / (p50 / 1e3),
              "losses": [s["loss"] for s in steps],
              "grad_norms": [s["grad_norm"] for s in steps], "eval_ms_per_batch": eval_ms,
              "eval_ms": [e["ms"] for e in evals], "max_memory_allocated_bytes": peak,
              "metrics": {k: metrics[k] for k in ("instance_miou", "class_miou", "accuracy")},
              "best_instance_miou": best["instance_miou"], "unmoved": still,
              "ckpt_last_bytes": (exp / "ckpt-last.pth").stat().st_size,
              "launches": {k: v for k, v in launches.items() if v}, "card": card}
    log(f"{record['config']} through the CLI: {n_steps} steps at batch {SEG_BATCH} (p50 "
        f"{p50:.3f} ms, {record['shapes_per_s']:.2f} shapes/s), evaluation {eval_ms:.3f} ms a "
        f"batch, run {run_s:.1f} s, peak memory {peak / 2**30:.3f} GiB; losses "
        f"{record['losses']}, gradient norms {record['grad_norms']}; unmoved {still}; metrics "
        f"{record['metrics']}; launches {record['launches']}; {card}")
    return {name: launches}, record


def seg_forward_phase(device, preset: str, name: str, plain_impl: str,
                      kernels) -> tuple[dict, dict]:
    """The full-width part-segmentation eval forward (cfgs/``preset``'s model,
    seeded weights) on SEG_BATCH clouds of SEG_POINTS points, held against the
    same weights on ``plain_impl`` on the card, both drawing the JAX
    evaluation's HLT tie-break: the log-probs within 1e-3 of their max and
    2e-3 relative (the classifier's rule). The kernel forward must launch each of ``kernels`` 12
    times and nothing else. Returns ({name: launches}, the record)."""
    from si_mamba_tpu_torch.models.segmentation import PartSegConfig, PartSegModel
    from si_mamba_tpu_torch.train.config import get_config

    cfg = PartSegConfig.from_dict(get_config(str(ROOT / "cfgs" / preset)).model)
    model = PartSegModel(cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
    plain = PartSegModel(PartSegConfig.from_dict({**cfg.__dict__, "scan_impl": plain_impl}))
    plain.load_state_dict(model.state_dict(), strict=True)
    plain = plain.to(device).eval()
    rng = np.random.default_rng(31)
    pts = torch.from_numpy(rng.standard_normal((SEG_BATCH, SEG_POINTS, 3), dtype=np.float32))
    pts = (pts / pts.abs().amax(dim=(1, 2), keepdim=True)).to(device)
    onehot = torch.eye(cfg.num_categories, device=device)[
        torch.from_numpy(rng.integers(0, cfg.num_categories, SEG_BATCH))]
    with torch.inference_mode():
        torch.cuda.synchronize()
        _reset_launch_counts()  # the held forward's path
        t0 = time.perf_counter()
        got = model(pts, onehot)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launch_counts()
        want = plain(pts, onehot)
    if launches != _expect(cfg.depth, kernels):
        raise AssertionError(f"the seg eval forward ({preset}) launched {launches}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if got.shape != (SEG_BATCH, SEG_POINTS, cfg.cls_dim) or not torch.allclose(
            got, want, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"the seg eval forward ({preset}) disagrees with scan_impl="
                             f"{plain_impl!r}: max |diff| {err}, max |logp| {scale}")
    record = {"config": f"cfgs/{preset}", "plain_impl": plain_impl, "ms": ms,
              "logp_max_abs_diff": err, "logp_max_abs": scale,
              "launches": {k: v for k, v in launches.items() if v}}
    log(f"seg eval forward ({preset}) == scan_impl={plain_impl!r}: max |diff| {err:.3e} (max "
        f"|logp| {scale:.3e}), {ms:.3f} ms")
    return {name: launches}, record


# the held seg gradient: the SSD preset's model at full width, its blocks cut
# to 4 with the taps at 1, 2, 3 (the preset's widths): at 12 blocks its
# gradient norm is inf from the random start, in JAX's model as in the port's
SEG_GRAD_DEPTH = 4
SEG_GRAD_TOL = 1e-3  # of each leaf's largest gradient


def seg_grad_phase(device) -> tuple[dict, dict]:
    """The SSD seg preset's block stack in training at the seg shapes, its
    kernels held against 'xla' on the card. A train pass of the whole model
    (cfgs/part_segmentation_ssd_fused.yaml, full width, SEG_GRAD_DEPTH blocks,
    drop_path 0, seeded weights; SEG_BATCH clouds of SEG_POINTS points, one
    HLT draw and head keep mask) on 'xla' gives the stack's inputs and the
    cotangent of its taps; the kernel route's stack, same weights, takes the
    same inputs and cotangent, and its parameter and input gradients must be
    finite and within SEG_GRAD_TOL of each leaf's largest, launching each of
    SEG_SSD_TRAIN_KERNELS once a block and nothing else. The whole model's
    gradients are not compared: from a random start the head's gradients
    before each BatchNorm are small remainders of sums over B x 2048 rows,
    and move by 1e-2 of their largest when the stack's outputs move by 1e-6
    (on the CPU, and between the routes on the card), so they would measure
    that conditioning, not the kernels. Returns ({"seg_ssd_grad": launches},
    the record)."""
    from si_mamba_tpu_torch.models.segmentation import PartSegConfig, PartSegModel, nll_loss
    from si_mamba_tpu_torch.train.config import get_config

    m = dict(get_config(str(ROOT / "cfgs" / "part_segmentation_ssd_fused.yaml")).model)
    m.update(depth=SEG_GRAD_DEPTH, fetch_idx=tuple(range(1, SEG_GRAD_DEPTH)), drop_path=0.0)
    cfg = PartSegConfig.from_dict(m)
    model = PartSegModel(cfg, generator=torch.Generator().manual_seed(7))
    plain = PartSegModel(PartSegConfig.from_dict({**cfg.__dict__, "scan_impl": "xla"}))
    plain.load_state_dict(model.state_dict(), strict=True)
    model, plain = model.to(device).train(), plain.to(device).train()
    rng = np.random.default_rng(32)
    pts = torch.from_numpy(rng.standard_normal((SEG_BATCH, SEG_POINTS, 3), dtype=np.float32))
    pts = (pts / pts.abs().amax(dim=(1, 2), keepdim=True)).to(device)
    cls = torch.from_numpy(rng.integers(0, cfg.num_categories, SEG_BATCH)).to(device)
    onehot = torch.eye(cfg.num_categories, device=device)[cls]
    seg = torch.from_numpy(rng.integers(0, cfg.cls_dim, (SEG_BATCH, SEG_POINTS))).to(device)
    draws = dict(order_noise=torch.from_numpy(rng.random((SEG_BATCH, cfg.num_group),
                                                         dtype=np.float32)).to(device),
                 head_mask=torch.from_numpy(rng.random((SEG_BATCH, SEG_POINTS, 512)) < 0.5
                                            ).to(device))
    stack = {}

    def keep(module, args, taps):
        for t in (*args[:2], *taps):
            t.retain_grad()
        stack["inputs"], stack["taps"] = args[:2], taps

    hook = plain.blocks.register_forward_hook(keep)
    loss = nll_loss(plain(pts, onehot, **draws), seg)
    loss.backward()
    hook.remove()
    x, pos = (t.detach().requires_grad_() for t in stack["inputs"])
    torch.cuda.synchronize()
    _reset_launch_counts()  # the kernel stack's train pass
    torch.autograd.backward(model.blocks(x, pos), [t.grad for t in stack["taps"]])
    torch.cuda.synchronize()
    launches = _launch_counts()
    if launches != _expect(cfg.depth, SEG_SSD_TRAIN_KERNELS):
        raise AssertionError(f"the seg SSD stack's train pass launched {launches}")
    grads = {**{k: p.grad for k, p in model.blocks.named_parameters()},
             "x": x.grad, "pos": pos.grad}
    ref = {**{k: p.grad for k, p in plain.blocks.named_parameters()},
           "x": stack["inputs"][0].grad, "pos": stack["inputs"][1].grad}
    if not all(torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("the seg SSD stack's kernel gradients are not finite")
    worst, worst_key = max(((g - ref[k]).abs().max().item() / ref[k].abs().max().item(), k)
                           for k, g in grads.items())
    if not worst < SEG_GRAD_TOL:
        raise AssertionError(f"seg stack gradient {worst_key} differs from 'xla' by "
                             f"{worst:.3e} of its largest")
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
    record = {"config": f"cfgs/part_segmentation_ssd_fused.yaml, depth {cfg.depth}, taps "
                        f"{cfg.fetch_idx}, drop_path 0", "plain_impl": "xla",
              "batch": SEG_BATCH, "loss": loss.item(), "stack_grad_norm": norm,
              "worst_leaf_rel_diff": worst, "worst_leaf": worst_key, "leaves": len(grads),
              "launches": {k: v for k, v in launches.items() if v}}
    log(f"seg SSD stack gradients ({record['config']}) == 'xla': loss {record['loss']:.7f}; "
        f"stack gradient norm {norm:.4e}; worst leaf {worst_key} {worst:.3e} of its largest")
    return {"seg_ssd_grad": launches}, record


def hlt_serving_phase(device) -> tuple[dict, dict]:
    """One request of 20 clouds through a ``Predictor`` over the ModelNet40
    classifier with the HLT ordering (L = 2 * 64 = 128): the conv and the
    lean scan 12 times each and nothing else, the logits against the same
    weights on 'seq' within 1e-3 of their max and 2e-3 relative (each eval
    forward draws HLT's tie-break as ``jax.random.uniform`` of
    ``jax.random.key(0)``, so both order alike). Returns ({"hlt_serving": launches}, the record)."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serving import Predictor

    base = dict(MODELNET40, method="HLT")
    model = PointMamba(PointMambaConfig.from_dict(base), generator=torch.Generator().manual_seed(0))
    plain = PointMamba(PointMambaConfig.from_dict({**base, "scan_impl": "seq"}))
    plain.load_state_dict(model.state_dict(), strict=True)
    predictor = Predictor(model, npoints=NPOINTS, max_batch=64, device=device)
    request = clouds(20, seed=20)
    torch.cuda.synchronize()
    _reset_launch_counts()  # the HLT classifier's path
    t0 = time.perf_counter()
    logits = predictor.logits(request)
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    if launches != _expect(MODELNET40["depth"], EVAL_KERNELS):
        raise AssertionError(f"the HLT classifier's forward launched {launches}")
    ref = Predictor(plain, npoints=NPOINTS, max_batch=64, device=device).logits(request)
    scale, err = float(np.abs(ref).max()), float(np.abs(logits - ref).max())
    if logits.shape != (20, MODELNET40["cls_dim"]) or not np.allclose(
            logits, ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"HLT classifier logits disagree with 'seq': max |diff| {err}, "
                             f"max |logit| {scale}")
    log(f"HLT classifier on 20 clouds == 'seq': max |diff| {err:.3e} (max |logit| "
        f"{scale:.3e}), {ms:.3f} ms")
    return {"hlt_serving": launches}, {"ms": ms, "logits_max_abs_diff": err,
                                       "logits_max_abs": scale,
                                       "launches": {k: v for k, v in launches.items() if v}}


def seg_phases(device, card: str) -> tuple[dict, dict]:
    """The part-segmentation paths: the HLT classifier through ``Predictor``,
    the held full-width seg eval forward of both presets, the held SSD seg
    stack's train gradients, then both presets through the CLI. Returns (each path's
    launches, the record)."""
    paths, record = {}, {}
    for key, (p, r) in {
            "hlt_serving": hlt_serving_phase(device),
            "forward": seg_forward_phase(device, "part_segmentation.yaml", "seg_forward", "seq",
                                         EVAL_KERNELS),
            "ssd_forward": seg_forward_phase(device, "part_segmentation_ssd_fused.yaml",
                                             "seg_ssd_forward", "xla", SEG_SSD_EVAL_KERNELS),
            "ssd_gradients": seg_grad_phase(device),
            "cli": partseg_cli_phase(device, card, "part_segmentation.yaml", "seg_cli",
                                     TRAIN_KERNELS, EVAL_KERNELS),
            "ssd_cli": partseg_cli_phase(device, card, "part_segmentation_ssd_fused.yaml",
                                         "seg_ssd_cli", SEG_SSD_TRAIN_KERNELS,
                                         SEG_SSD_EVAL_KERNELS)}.items():
        paths.update(p)
        record[key] = r
    return paths, record


# ---------------------------------------------------------------------------
# MAE pretraining, the SVM probe and the h5 datasets (phases 30-34)
# ---------------------------------------------------------------------------

PRETRAIN_BATCH = 128  # cfgs/pretrain.yaml's total_bs
PRETRAIN_ENC_LEN = 208  # 2 K n_vis = 2 * 4 * 26 visible tokens
PRETRAIN_DEC_LEN = 512  # 2 K G
PRETRAIN_CHUNK = 128  # the pretraining SSD presets' chunk (the encoder's 208 pads to 256)
PROBE_BATCH = 64  # the SVM probe's loaders
SCAN_BATCH, SCAN_LEN, SCAN_CHUNK = 32, 1024, 256  # the hardest scan presets
PRETRAIN_SHAPES = 272  # ShapeNet-55 shapes written: two whole steps of 128 (whole: True)
PRETRAIN_SHAPE_POINTS = 8192
PRETRAIN_BLOCKS = 16  # 12 encoder + 4 decoder blocks: each kernel's launches a step
PROBE_BLOCKS = 12  # a noaug feature forward runs the encoder alone
PRETRAIN_PRESETS = {
    "pretrain.yaml": dict(mixer="mamba", scan_impl="auto", dtype="float32",
                          wavelet_solver="eigh"),
    "pretrain_ssd_fused.yaml": dict(mixer="ssd", scan_impl="ssd_fused", dtype="bfloat16",
                                    wavelet_solver="jacobi"),
}
MAE_GRAD_TOL = 1e-4  # of each leaf's largest gradient
H5_FIXTURES = ROOT / "tests" / "data" / "h5"  # scripts/torch_make_h5_fixtures.py


def mae_kernel_phase(device) -> dict:
    """Every kernel of the pretraining and hardest-scan paths at the shapes
    those paths give it, held against its plain version and timed beside it:
    the fp32 Mamba-1 K1, K5, K3, K4 at B=128 with L=208 (the encoder) and
    L=512 (the decoder) and K1, K2 at B=64, L=512 (the probe's features); the
    bf16 SSD preset's K1, K5, K8 with states and K9 at B=128 with L=208 (K8/K9
    on 256, padded to two chunks of 128) and L=512, the bf16 K1 and lean K8 at
    B=64, L=512; the fp32 K1-K5 at B=32, L=1024 (cfgs/finetune_scan_hardest.yaml)
    and K8 (both variants) and K9 at chunk 256, nc 4 (its SSD preset). Returns
    {kernel name: {view: figures}}."""
    views = {
        "pretrain_encoder": mamba_at(device, PRETRAIN_BATCH, PRETRAIN_ENC_LEN, infer=False),
        "pretrain_decoder": mamba_at(device, PRETRAIN_BATCH, PRETRAIN_DEC_LEN, infer=False),
        "probe": mamba_at(device, PROBE_BATCH, PRETRAIN_DEC_LEN, train=False),
        "pretrain_ssd_encoder": ssd_bf16_at(device, PRETRAIN_BATCH, PRETRAIN_ENC_LEN,
                                            PRETRAIN_CHUNK, infer=False),
        "pretrain_ssd_decoder": ssd_bf16_at(device, PRETRAIN_BATCH, PRETRAIN_DEC_LEN,
                                            PRETRAIN_CHUNK, infer=False),
        "probe_ssd": ssd_bf16_at(device, PROBE_BATCH, PRETRAIN_DEC_LEN, PRETRAIN_CHUNK,
                                 train=False),
        "scan_hardest": mamba_at(device, SCAN_BATCH, SCAN_LEN),
    }
    ssd_records, _ = ssd_kernel_phase(device, SCAN_BATCH, SCAN_LEN, SCAN_CHUNK, at_clouds=False)
    views["scan_hardest_ssd"] = {r["name"]: _keep(r) | {"shape": [SCAN_BATCH, SCAN_LEN,
                                                                   SCAN_CHUNK]}
                                 for r in ssd_records}
    out: dict = {}
    for view, kernels in views.items():
        for name, f in kernels.items():
            out.setdefault(name, {})[view] = f
    log("kernels at the pretraining and hardest-scan shapes: " + "; ".join(
        f"{name} {view} {f['ms']:.6f} ms (device {f.get('device_ms') or float('nan'):.6f}, "
        f"plain {f['plain_ms']:.6f}, bound {f['bound_ms']:.6f})"
        for name, views_ in out.items() for view, f in views_.items()))
    return out


def write_shapenet_tree(root: Path, n_shapes: int, n_points: int = PRETRAIN_SHAPE_POINTS,
                        n_test: int = 32, seed: int = 50) -> Path:
    """A ShapeNet-55 tree: ``ShapeNet-55/{train,test}.txt`` and one (n_points,
    3) float32 ``.npy`` a shape under ``shapenet_pc``, seeded Gaussian blobs."""
    rng = np.random.default_rng(seed)
    (root / "shapenet_pc").mkdir(parents=True, exist_ok=True)
    (root / "ShapeNet-55").mkdir(exist_ok=True)
    names = [f"{2691156 + i % 55:08d}-{i:05d}.npy" for i in range(n_shapes)]
    for name in names:
        axes = 0.3 + rng.random(3)
        np.save(root / "shapenet_pc" / name,
                (rng.standard_normal((n_points, 3)) * axes).astype(np.float32))
    (root / "ShapeNet-55" / "train.txt").write_text("\n".join(names[n_test:]) + "\n")
    (root / "ShapeNet-55" / "test.txt").write_text("\n".join(names[:n_test]) + "\n")
    return root


def mae_workdir() -> Path:
    """build/mae: a copy of cfgs/ whose dataset configs point at the seeded
    ShapeNet-55 tree written there and at the committed h5 fixtures (the
    presets' ``_base_`` refs are relative to the working directory)."""
    import shutil

    work = ROOT / "build" / "mae"
    tree = work / "ShapeNet55-34"
    if not (tree / "ShapeNet-55" / "train.txt").exists():
        write_shapenet_tree(tree, PRETRAIN_SHAPES)
    if (work / "cfgs").exists():
        shutil.rmtree(work / "cfgs")
    shutil.copytree(ROOT / "cfgs", work / "cfgs")
    dc = work / "cfgs" / "dataset_configs"
    (dc / "ShapeNet-55.yaml").write_text(
        f"NAME: ShapeNet\nDATA_PATH: {tree / 'ShapeNet-55'}\nN_POINTS: 1024\n"
        f"PC_PATH: {tree / 'shapenet_pc'}\n")
    (dc / "ModelNet40SVM.yaml").write_text(f"NAME: ModelNet40SVM\nDATA_PATH: {H5_FIXTURES}\n")
    (dc / "ScanObjectNN_hardest.yaml").write_text(
        f"NAME: ScanObjectNN_hardest\nROOT: {H5_FIXTURES / 'ScanObjectNN' / 'main_split'}\n")
    return work


def _timed_steps(module, names, calls: dict):
    """Wrap ``module``'s step makers ``names``: each step call appends {"ms",
    "launches", "out"} to ``calls[name]``, its launch counts the difference
    across the call (synchronised at both ends). Returns the originals."""
    real = {n: getattr(module, n) for n in names}

    def wrap(name):
        def make(*a, **k):
            step = real[name](*a, **k)

            def run(*sa, **sk):
                torch.cuda.synchronize()
                before, t = _launch_counts(), time.perf_counter()
                out = step(*sa, **sk)
                torch.cuda.synchronize()
                now = _launch_counts()
                calls.setdefault(name, []).append(
                    {"ms": (time.perf_counter() - t) * 1e3, "out": out,
                     "launches": {k: now[k] - before[k] for k in now}})
                return out

            return run

        return make

    for n in names:
        setattr(module, n, wrap(n))
    return real


def pretrain_breakdown(device, cfg, steps: int = 3) -> dict:
    """The pretraining step of ``cfg`` at B=128 on seeded 1024-point clouds,
    timed by piece, each piece one of ``PointMAEMamba``'s methods called as
    its ``forward`` calls them and followed by a ``torch.cuda.synchronize()``:
    grouping, graph, bases, sgwt, sinkhorn, rounding, encoder, decoder (with
    the loss), then update (backward, clip, AdamW); on the legacy 'MAMBA'
    path grouping, forward (mask, encoder, decoder, loss) and update. Medians
    over ``steps`` steps after one warm-up; the step's peak memory."""
    from si_mamba_tpu_torch.models.point_mae import PointMAEMamba
    from si_mamba_tpu_torch.ops.wavelets import wavelet_projections
    from si_mamba_tpu_torch.train import optim

    with torch.device(device):
        model = PointMAEMamba(cfg, generator=torch.Generator(device).manual_seed(3))
    optimizer, _ = optim.build_optimizer(model, lr=1e-3, weight_decay=0.05, epochs=300,
                                         warmup_epochs=10, steps_per_epoch=2, grad_clip=10.0)
    generator = torch.Generator(device).manual_seed(4)
    pts = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (PRETRAIN_BATCH, 1024, 3), dtype=np.float32)).to(device)
    rows = []
    model.train()
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(steps + 1):
        marks = []

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        mark("start")
        grouped = model.group(pts)
        mark("grouping")
        if model.legacy:
            loss = model.legacy_forward(grouped, generator=generator)
            mark("forward")
            loss.backward()
            optimizer.step()
            mark("update")
            rows.append({b[0]: (b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])})
            continue
        L = model.laplacian(grouped.center)
        mark("graph")
        PJ = wavelet_projections(L, cfg.wavelet_J, cfg.wavelet_solver)
        mark("bases")
        scores = model.scores(grouped.center, PJ, 0.5, generator)
        mark("sgwt")
        P_hat = model.soft_perm(scores)
        mark("sinkhorn")
        order_idx = model.round_perm(P_hat)
        mark("rounding")
        enc = model.encode(grouped, order_idx, P_hat,
                           model.mask(grouped.center, generator=generator), generator=generator)
        mark("encoder")
        loss = model.decode_loss(grouped, enc, generator)
        mark("decoder")
        loss.backward()
        optimizer.step()
        mark("update")
        rows.append({b[0]: (b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])})
        if not torch.isfinite(loss):
            raise AssertionError(f"the timed pretraining step's loss is {loss.item()}")
    pieces = {k: statistics.median(r[k] for r in rows[1:]) for k in rows[1]}
    pieces["step"] = sum(pieces.values())
    if not model.legacy:
        pieces["orders"] = sum(pieces[k] for k in ("graph", "bases", "sgwt", "sinkhorn",
                                                   "rounding"))
    pieces["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
    return pieces


def pretrain_cli_phase(device, card: str, preset: str, name: str, train_kernels,
                       eval_kernels, method: str | None = None) -> tuple[dict, dict]:
    """A shipped pretraining preset through ``cli.main`` (build/mae:
    PRETRAIN_SHAPES seeded ShapeNet-55 shapes of 8192 points, the committed
    ModelNet40 h5 fixtures for the SVM probe) at max_epoch 1, the published
    model (12 + 4 blocks x 384, 64 groups of 32 of 1024 points, mask 0.6, K 4,
    reverse, total_bs 128): epochs 0 and 1 of two steps, the probe after
    epoch 1. Every train step must launch each of ``train_kernels``
    PRETRAIN_BLOCKS times and nothing else, every probe feature forward each
    of ``eval_kernels`` PROBE_BLOCKS times; losses finite; the BatchNorm
    statistics, ``diff_sgwt.*``, ``mask_token`` and every decayed parameter
    moved, every parameter finite; the probe's accuracy in [0, 100];
    ckpt-last.pth and ckpt-best.pth written. Then the step timed by piece
    (``pretrain_breakdown``). ``method``: the model's method set over the
    preset's ('MAMBA': the legacy path, whose model has no ``diff_sgwt``).
    Returns ({name: launches}, the record)."""
    from si_mamba_tpu_torch.models.point_mae import PointMAEConfig
    from si_mamba_tpu_torch.train import cli, optim, svm
    from si_mamba_tpu_torch.train import runner_pretrain as rp
    from si_mamba_tpu_torch.train.config import get_config
    from si_mamba_tpu_torch.train.registry import build_model_from_cfg

    t0 = time.perf_counter()
    work = mae_workdir()
    write_s = time.perf_counter() - t0
    exp_cfg = work / f"pre_{name}.yaml"
    exp_cfg.write_text(f"_base_: cfgs/{preset}\nmax_epoch: 1\n" +
                       (f"model: {{method: {method}}}\n" if method else ""))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        config = get_config(str(exp_cfg))
    finally:
        os.chdir(cwd)
    cfg = PointMAEConfig.from_dict(config.model)
    want = dict(trans_dim=384, encoder_dims=384, depth=12, decoder_depth=4, num_group=64,
                group_size=32, mask_ratio=0.6, k_top_eigenvectors=4, reverse=True,
                drop_path_rate=0.1, loss="cdl2", **PRETRAIN_PRESETS[preset],
                method=method or "smallest_eigenvectors_seperate_learnable_tokens")
    if {k: getattr(cfg, k) for k in want} != want or \
            (config.total_bs, config.npoints) != (PRETRAIN_BATCH, 1024):
        raise AssertionError(f"the {preset} config is not the preset's: {cfg}")
    calls: dict = {}
    timings = {"features_s": [], "solve_s": []}
    real_collect, real_svm = rp.collect_features, svm.svm_accuracy

    def collect(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_collect(*a, **k)
        torch.cuda.synchronize()
        timings["features_s"].append(time.perf_counter() - t)
        return out

    def solve(*a, **k):
        t = time.perf_counter()
        out = real_svm(*a, **k)
        torch.cuda.synchronize()
        timings["solve_s"].append(time.perf_counter() - t)
        return out

    exp = work / "experiments" / f"pre_{name}" / name
    real = _timed_steps(rp, ("make_pretrain_step", "make_feature_step"), calls)
    rp.collect_features, svm.svm_accuracy = collect, solve
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()  # the preset's path: counts from 0, then the run
        t0 = time.perf_counter()
        state, best = cli.main(["--config", str(exp_cfg), "--device", "cuda", "--exp_name", name])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        for k, v in real.items():
            setattr(rp, k, v)
        rp.collect_features, svm.svm_accuracy = real_collect, real_svm
        os.chdir(cwd)

    steps, feats = calls.get("make_pretrain_step", []), calls.get("make_feature_step", [])
    n_steps = 2 * (PRETRAIN_SHAPES // PRETRAIN_BATCH)
    if len(steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"the {preset} run took {len(steps)} steps, expected {n_steps}")
    losses = [float(s["out"][1]["loss"]) for s in steps]
    for i, s in enumerate(steps):
        if s["launches"] != _expect(PRETRAIN_BLOCKS, train_kernels) or not np.isfinite(losses[i]):
            raise AssertionError(f"{preset} train step {i} launched {s['launches']}, loss "
                                 f"{losses[i]}")
    if len(feats) != 2 or any(f["launches"] != _expect(PROBE_BLOCKS, eval_kernels) or
                              not torch.isfinite(f["out"]).all() for f in feats):
        raise AssertionError(f"the {preset} probe's feature forwards: "
                             f"{[(f['launches'], f['out'].shape) for f in feats]}")
    total = {k: sum(x["launches"][k] for x in steps + feats) for k in launches}
    if launches != total:
        raise AssertionError(f"the {preset} run launched {launches}, its steps and feature "
                             f"forwards {total}")
    files = {p.name for p in exp.iterdir()}
    if not {"ckpt-last.pth", "ckpt-best.pth", "config.yaml", "scalars.jsonl"} <= files:
        raise AssertionError(f"the {preset} run wrote {sorted(files)}")
    acc = torch.load(exp / "ckpt-best.pth", map_location="cpu", weights_only=True)["metrics"]["acc"]
    if not 0.0 <= acc <= 100.0 or acc != best.acc:
        raise AssertionError(f"the {preset} probe's accuracy {acc} (best {best.acc})")
    payload = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)
    start, _ = build_model_from_cfg(config.model, device, 0)
    start_sd = start.state_dict()
    final = payload["base_model"]
    if not all(torch.isfinite(v).all() for v in final.values()):
        raise AssertionError(f"the {preset} run left non-finite parameters")
    decays = optim.wd_mask(start)
    still = [k for k, v in final.items()
             if "num_batches_tracked" not in k and torch.equal(v, start_sd[k].cpu())]
    must = [k for k in still if "running_" in k or decays.get(k, False)
            or k.startswith("diff_sgwt.") or k == "mask_token"]
    if must:
        raise AssertionError(f"the {preset} run left {must} at their start")
    del start, start_sd
    pieces = pretrain_breakdown(device, cfg)
    step_ms = [s["ms"] for s in steps]
    p50 = statistics.median(step_ms[1:])
    record = {"config": f"cfgs/{preset}, max_epoch 1" + (f", method {method}" if method else ""),
              "shapes": PRETRAIN_SHAPES,
              "batch": PRETRAIN_BATCH, "data_write_s": write_s, "run_s": run_s,
              "step_ms": step_ms, "p50_step_ms": p50,
              "clouds_per_s": PRETRAIN_BATCH / (p50 / 1e3), "losses": losses,
              "probe_acc": acc, "probe_features_s": timings["features_s"],
              "probe_solve_s": timings["solve_s"], "feature_forward_ms": [f["ms"] for f in feats],
              "max_memory_allocated_bytes": peak, "unmoved": still, "pieces_ms": pieces,
              "ckpt_last_bytes": (exp / "ckpt-last.pth").stat().st_size,
              "ckpt_last": str(exp / "ckpt-last.pth"),
              "launches": {k: v for k, v in launches.items() if v}, "card": card}
    log(f"{record['config']} through the CLI: {n_steps} steps at batch {PRETRAIN_BATCH} (p50 "
        f"{p50:.3f} ms, {record['clouds_per_s']:.2f} clouds/s), probe {acc:.2f} % (features "
        f"{timings['features_s']} s, solve {timings['solve_s']} s), run {run_s:.1f} s, peak "
        f"{peak / 2**30:.3f} GiB; losses {losses}; unmoved {still}; step pieces (ms) {pieces}; "
        f"launches {record['launches']}; {card}")
    return {name: launches}, record


def _mae_pair(device, base: dict, plain_impl: str, seed: int = 0):
    """The full-width pretraining model of ``base`` (drop_path 0) on the
    kernel route and the same weights on ``plain_impl``, both on ``device``."""
    from si_mamba_tpu_torch.models.point_mae import PointMAEConfig, PointMAEMamba

    cfg = PointMAEConfig(**{**base, "drop_path_rate": 0.0})
    model = PointMAEMamba(cfg, generator=torch.Generator().manual_seed(seed))
    plain = PointMAEMamba(PointMAEConfig(**{**cfg.__dict__, "scan_impl": plain_impl}))
    plain.load_state_dict(model.state_dict(), strict=True)
    return cfg, model.to(device), plain.to(device)


MAE_FULL = dict(trans_dim=384, encoder_dims=384, depth=12, decoder_depth=4, group_size=32,
                num_group=64, mask_ratio=0.6, k_top_eigenvectors=4, knn_graph=20, alpha=10.0)
MAE_HELD_BATCH = 16


def mae_forward_phase(device) -> tuple[dict, dict]:
    """The full-width pretraining model (cfgs/pretrain.yaml's, seeded weights)
    in eval mode on MAE_HELD_BATCH clouds of 1024 points: the loss of the
    kernel route with one mask_override and orders_override against the same
    weights on 'seq' within rtol 2e-3, the noaug features within 1e-3 of their
    max and 2e-3 relative, each kernel forward launching K1 and K2 once a
    block and nothing else; then the orders computed on the card against the
    same model's on the CPU (the fraction of (cloud, traversal) orders equal,
    recorded, not held: near-ties in P_hat follow rounding). Returns
    ({name: launches}, the record)."""
    import copy

    from si_mamba_tpu_torch.models.point_mae import random_mask

    cfg, model, plain = _mae_pair(device, MAE_FULL, "seq")
    model.eval()
    plain.eval()
    rng = np.random.default_rng(52)
    pts = torch.from_numpy(rng.standard_normal((MAE_HELD_BATCH, 1024, 3),
                                               dtype=np.float32)).to(device)
    B, K, G = MAE_HELD_BATCH, cfg.k_top_eigenvectors, cfg.num_group
    mask = random_mask(B, G, cfg.num_mask, uniform_draw=torch.from_numpy(
        rng.random((B, G), dtype=np.float32))).to(device)
    orders = torch.from_numpy(np.stack([np.stack([rng.permutation(G) for _ in range(K)])
                                        for _ in range(B)])).to(device)
    paths = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        _reset_launch_counts()  # the held loss forward
        loss = model(pts, mask_override=mask, orders_override=orders)
        torch.cuda.synchronize()
        paths["mae_forward"] = _launch_counts()
        want = plain(pts, mask_override=mask, orders_override=orders)
        _reset_launch_counts()  # the held feature forward
        feats = model(pts, noaug=True)
        torch.cuda.synchronize()
        paths["mae_features"] = _launch_counts()
        feats_ref = plain(pts, noaug=True)
        center = model.group(pts).center
        card_orders = model.orders(center)[0].cpu()
        cpu_orders = copy.deepcopy(model).cpu().orders(center.cpu())[0]
    if paths["mae_forward"] != _expect(PRETRAIN_BLOCKS, EVAL_KERNELS) or \
            paths["mae_features"] != _expect(PROBE_BLOCKS, EVAL_KERNELS):
        raise AssertionError(f"the held MAE forwards launched {paths}")
    rel = abs(loss.item() - want.item()) / abs(want.item())
    if not np.isfinite(loss.item()) or rel > 2e-3:
        raise AssertionError(f"the MAE eval loss {loss.item()} against 'seq' {want.item()}")
    scale = feats_ref.abs().max().item()
    err = (feats - feats_ref).abs().max().item()
    if feats.shape != (B, 2 * K * G, cfg.trans_dim) or not torch.allclose(
            feats, feats_ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"the MAE noaug features disagree with 'seq': max |diff| {err}, "
                             f"max {scale}")
    agree = float((card_orders == cpu_orders).all(dim=-1).float().mean())
    record = {"batch": B, "loss": loss.item(), "loss_plain": want.item(), "loss_rel_diff": rel,
              "features_max_abs_diff": err, "features_max_abs": scale,
              "orders_equal_to_cpu": agree,
              "launches": {k: {n: c for n, c in v.items() if c} for k, v in paths.items()}}
    log(f"MAE eval loss {loss.item():.7f} == 'seq' {want.item():.7f} ({rel:.3e}); noaug "
        f"features max |diff| {err:.3e} (max {scale:.3e}); orders equal to the CPU's for "
        f"{agree:.4f} of (cloud, traversal)")
    return paths, record


def mae_grad_phase(device) -> tuple[dict, dict]:
    """The pretraining encoder stack (12 Mamba-1 blocks at width 384,
    drop_path 0, seeded weights) in training at B=MAE_HELD_BATCH, L=208: one
    forward and backward on seeded inputs and one seeded cotangent on the
    kernel route against the same weights on 'seq', every parameter and
    input gradient finite and within MAE_GRAD_TOL of its leaf's largest, K1,
    K3, K4 and K5 once a block and nothing else. Returns ({"mae_stack_grad":
    launches}, the record)."""
    _, model, plain = _mae_pair(device, MAE_FULL, "seq", seed=5)
    stack, plain_stack = model.MAE_encoder.blocks.train(), plain.MAE_encoder.blocks.train()
    rng = np.random.default_rng(53)
    shape = (MAE_HELD_BATCH, PRETRAIN_ENC_LEN, MAE_FULL["trans_dim"])
    x0, pos0, cot = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
                     for _ in range(3))
    grads = {}
    for route, s in (("kernel", stack), ("plain", plain_stack)):
        x, pos = x0.clone().requires_grad_(), pos0.clone().requires_grad_()
        torch.cuda.synchronize()
        _reset_launch_counts()
        torch.autograd.backward(s(x, pos), cot)
        torch.cuda.synchronize()
        if route == "kernel":
            launches = _launch_counts()
        grads[route] = {**{k: p.grad for k, p in s.named_parameters()}, "x": x.grad,
                        "pos": pos.grad}
    if launches != _expect(MAE_FULL["depth"], TRAIN_KERNELS):
        raise AssertionError(f"the MAE encoder stack's train pass launched {launches}")
    if not all(torch.isfinite(g).all() for g in grads["kernel"].values()):
        raise AssertionError("the MAE encoder stack's kernel gradients are not finite")
    worst, worst_key = max(((g - grads["plain"][k]).abs().max().item()
                            / grads["plain"][k].abs().max().item(), k)
                           for k, g in grads["kernel"].items())
    if not worst < MAE_GRAD_TOL:
        raise AssertionError(f"MAE stack gradient {worst_key} differs from 'seq' by {worst:.3e} "
                             f"of its largest")
    record = {"batch": MAE_HELD_BATCH, "length": PRETRAIN_ENC_LEN, "plain_impl": "seq",
              "worst_leaf_rel_diff": worst, "worst_leaf": worst_key,
              "leaves": len(grads["kernel"]),
              "launches": {k: v for k, v in launches.items() if v}}
    log(f"MAE encoder stack gradients == 'seq': worst leaf {worst_key} {worst:.3e} of its "
        f"largest")
    return {"mae_stack_grad": launches}, record


# ModelNet40's official split, clouds a class in its class order (airplane ..
# xbox): 9843 train, 2468 test. The largest pair, chair and sofa, holds 1569
MODELNET40_TRAIN_COUNTS = (626, 106, 515, 173, 572, 335, 64, 197, 889, 167, 79, 138, 200, 109,
                           200, 149, 171, 155, 145, 124, 149, 284, 465, 200, 88, 231, 240, 104,
                           115, 128, 680, 124, 90, 392, 163, 344, 267, 475, 87, 103)
MODELNET40_TEST_COUNTS = (100, 50, 100, 20, 100, 100, 20, 100, 100, 20, 20, 20, 86, 20, 86, 20,
                          100, 100, 20, 20, 20, 100, 100, 86, 20, 100, 100, 20, 100, 20, 100, 20,
                          20, 100, 20, 100, 100, 100, 20, 20)


def _svm_features(train_counts, test_counts, dim: int, seed: int):
    """Seeded class blobs, ``train_counts[c]`` / ``test_counts[c]`` clouds of
    class c in a shuffled order: (train x, train y, test x, test y) as
    tensors."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((len(train_counts), dim))
    ytr = rng.permutation(np.repeat(np.arange(len(train_counts)), train_counts))
    yte = rng.permutation(np.repeat(np.arange(len(test_counts)), test_counts))
    xtr = (0.15 * centers[ytr] + rng.standard_normal((len(ytr), dim))).astype(np.float32)
    xte = (0.15 * centers[yte] + rng.standard_normal((len(yte), dim))).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (xtr, ytr, xte, yte))


def svm_phase(device) -> dict:
    """The on-card SVM probe: at the published probe's size and class mix
    (ModelNet40's per-class train and test counts, 9843 x 768 train features,
    2468 test; seeded class blobs) fitted and scored on the card, its seconds
    and the fit's peak allocation above the features; at a small size (12
    train clouds a class, 40 classes, width 64) its decision values and
    predictions against the same solver run on the CPU (float64 both: within
    1e-6, predictions equal)."""
    from si_mamba_tpu_torch.train import svm

    xtr, ytr, xte, yte = (t.to(device) for t in _svm_features(
        MODELNET40_TRAIN_COUNTS, MODELNET40_TEST_COUNTS, 768, 60))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    fit = svm.fit_ovo(xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - held
    acc = float((svm.predict(fit, xte) == yte).double().mean()) * 100
    small = _svm_features([12] * 40, [10] * 40, 64, 61)
    card = svm.fit_ovo(small[0].to(device), small[1].to(device))
    host = svm.fit_ovo(small[0], small[1])
    dec_card = svm.decision_function(card, small[2].to(device)).cpu()
    dec_host = svm.decision_function(host, small[2])
    diff = (dec_card - dec_host).abs().max().item()
    same = bool(torch.equal(svm.predict(card, small[2].to(device)).cpu(),
                            svm.predict(host, small[2])))
    if diff > 1e-6 or not same:
        raise AssertionError(f"the SVM on the card against the CPU: decision values "
                             f"{diff:.3e} apart, predictions equal: {same}")
    counts = sorted(MODELNET40_TRAIN_COUNTS)
    record = {"published_size": {"train": list(xtr.shape), "test": list(xte.shape),
                                 "classes": 40, "largest_pair": counts[-1] + counts[-2],
                                 "fit_s": fit_s, "iterations": fit["iterations"],
                                 "fit_peak_bytes": peak, "accuracy": acc},
              "small_vs_cpu": {"decision_max_abs_diff": diff, "predictions_equal": same,
                               "iterations": (card["iterations"], host["iterations"])}}
    log(f"SVM at the published probe size and class mix: fit {fit_s:.3f} s in "
        f"{fit['iterations']} iterations, peak {peak / 2**30:.3f} GiB above the features, "
        f"accuracy {acc:.2f} %; at the small size the card's decision values {diff:.3e} from "
        f"the CPU's, predictions equal")
    return record


SCAN_HARDEST = dict(MODELNET40, cls_dim=15, num_group=128, alpha=10.0, drop_path=0.1)


def scan_cli_phase(device, card: str, pretrained: str) -> tuple[dict, dict]:
    """cfgs/finetune_scan_hardest.yaml through ``cli.main`` at max_epoch 1 on
    the committed ScanObjectNN-hardest fixtures (32 train clouds: one step an
    epoch at total_bs 32; 16 test clouds), finetuning from ``pretrained`` (a
    pretraining run's ckpt-last.pth) through --finetune_model: every encoder
    key of the classifier taken from it (only the head missing); every train
    step K1, K3, K4 and K5 12 times each at L = 1024 and nothing else, every
    validation forward K1 and K2 12 times each; losses finite; ckpt-last.pth
    written. Then a held classifier forward at L = 1024 (16 clouds of 2048
    points, the kernel route against 'seq' on the card, logits within 1e-3 of
    their max and 2e-3 relative). Returns (paths, the record)."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.train import checkpoint as ckpt
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf

    work = mae_workdir()
    exp_cfg = work / "scan_hardest.yaml"
    exp_cfg.write_text("_base_: cfgs/finetune_scan_hardest.yaml\nmax_epoch: 1\n")
    calls: dict = {}
    transfers = []
    real_transfer = ckpt.transfer_pretrained

    def transfer(*a, **k):
        transfers.append(real_transfer(*a, **k))
        return transfers[-1]

    real = _timed_steps(rf, ("make_train_step", "make_eval_step"), calls)
    ckpt.transfer_pretrained = transfer
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()  # the hardest scan preset's path
        t0 = time.perf_counter()
        state, best = cli.main(["--config", str(exp_cfg), "--device", "cuda", "--exp_name",
                                "scan", "--finetune_model", pretrained, "--num_workers", "2"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        for k, v in real.items():
            setattr(rf, k, v)
        ckpt.transfer_pretrained = real_transfer
        os.chdir(cwd)
    if len(transfers) != 1:
        raise AssertionError(f"the pretrained weights were transferred {len(transfers)} times")
    missing, unexpected, mismatched = transfers[0]
    if mismatched or not missing or any(not k.startswith("cls_head_finetune.") for k in missing):
        raise AssertionError(f"finetuning from the pretraining checkpoint: missing {missing}, "
                             f"shape-mismatched {mismatched}")
    steps, evals = calls.get("make_train_step", []), calls.get("make_eval_step", [])
    if len(steps) != 2 or state.step != 2:
        raise AssertionError(f"the scan run took {len(steps)} steps, expected 2")
    losses = [float(s["out"][1]["loss"]) for s in steps]
    for i, s in enumerate(steps):
        if s["launches"] != _expect(12, TRAIN_KERNELS) or not np.isfinite(losses[i]):
            raise AssertionError(f"scan train step {i} launched {s['launches']}, loss "
                                 f"{losses[i]}")
    for e in evals:
        if e["launches"] != _expect(12, EVAL_KERNELS) or not torch.isfinite(e["out"]).all():
            raise AssertionError(f"a scan validation forward launched {e['launches']}")
    exp = work / "experiments" / "scan_hardest" / "scan"
    files = {p.name for p in exp.iterdir()}
    if not {"ckpt-last.pth", "config.yaml", "scalars.jsonl"} <= files:
        raise AssertionError(f"the scan run wrote {sorted(files)}")

    model = PointMamba(PointMambaConfig.from_dict(SCAN_HARDEST),
                       generator=torch.Generator().manual_seed(0))
    plain = PointMamba(PointMambaConfig.from_dict({**SCAN_HARDEST, "scan_impl": "seq"}))
    plain.load_state_dict(model.state_dict(), strict=True)
    model, plain = model.to(device).eval(), plain.to(device).eval()
    pts = torch.from_numpy(np.random.default_rng(54).standard_normal(
        (16, 2048, 3), dtype=np.float32)).to(device)
    with torch.inference_mode():
        torch.cuda.synchronize()
        _reset_launch_counts()  # the held L = 1024 forward
        logits = model(pts)
        torch.cuda.synchronize()
        held = _launch_counts()
        want = plain(pts)
    scale, err = want.abs().max().item(), (logits - want).abs().max().item()
    if held != _expect(12, EVAL_KERNELS) or not torch.allclose(logits, want, atol=1e-3 * scale,
                                                               rtol=2e-3):
        raise AssertionError(f"the L = 1024 classifier forward launched {held}, max |diff| "
                             f"{err} of {scale}")
    step_ms = [s["ms"] for s in steps]
    record = {"config": "cfgs/finetune_scan_hardest.yaml, max_epoch 1", "train_clouds": 32,
              "test_clouds": 16, "step_ms": step_ms, "p50_step_ms": statistics.median(step_ms),
              "eval_ms": [e["ms"] for e in evals], "losses": losses, "best_acc": best.acc,
              "run_s": run_s, "max_memory_allocated_bytes": peak,
              "transfer": {"missing": len(missing), "unexpected": len(unexpected)},
              "held_forward": {"logits_max_abs_diff": err, "logits_max_abs": scale},
              "ckpt_best": "ckpt-best.pth" in files,
              "launches": {k: v for k, v in launches.items() if v}, "card": card}
    log(f"{record['config']} through the CLI from the pretraining checkpoint ({len(missing)} "
        f"head keys missing, {len(unexpected)} unexpected): steps {step_ms} ms, losses {losses}, "
        f"validation {record['eval_ms']} ms, peak {peak / 2**30:.3f} GiB; held L = 1024 "
        f"forward max |diff| {err:.3e} of {scale:.3e}; {card}")
    return {"scan_cli": launches, "scan_forward": held}, record


def mae_phases(device, card: str) -> tuple[dict, dict]:
    """The pretraining paths: the held MAE forward and encoder-stack
    gradients, the SVM, both pretraining presets through the CLI, then the
    hardest scan preset finetuned from the first one's checkpoint. Returns
    (each path's launches, the record)."""
    paths, record = {}, {}
    p, record["forward"] = mae_forward_phase(device)
    paths.update(p)
    p, record["stack_gradients"] = mae_grad_phase(device)
    paths.update(p)
    record["svm"] = svm_phase(device)
    p, record["cli"] = pretrain_cli_phase(device, card, "pretrain.yaml", "pretrain_cli",
                                          TRAIN_KERNELS, EVAL_KERNELS)
    paths.update(p)
    p, record["ssd_cli"] = pretrain_cli_phase(device, card, "pretrain_ssd_fused.yaml",
                                              "pretrain_ssd_cli", SSD_PERF_TRAIN_KERNELS,
                                              SSD_PERF_EVAL_KERNELS)
    paths.update(p)
    p, record["scan_cli"] = scan_cli_phase(device, card, record["cli"]["ckpt_last"])
    paths.update(p)
    return paths, record


# ---------------------------------------------------------------------------
# the classifier's last options, the permutation policy, the legacy MAE and
# few-shot (phases 41-46)
# ---------------------------------------------------------------------------

LEGACY_ENC_LEN = 26  # the legacy MAE encoder's tokens: the 64 - int(0.6 * 64) visible groups
LEGACY_DEC_LEN = 64  # its decoder's [visible, mask tokens] and the probe's noaug encoder
# the ModelNet40 classifier with each of its last two options, and the SSD
# classifier with rms_norm
MODELNET40_RMS = dict(MODELNET40, rms_norm=True)
MODELNET40_ADD = dict(MODELNET40, add_after_layer=True)
MODELNET40_SSD_RMS = dict(MODELNET40_SSD, rms_norm=True)
SSD_TRAIN_KERNELS = ("causal_conv1d_silu", "ssd_xbc_fwd_states", "ssd_xbc_bwd",
                     "causal_conv1d_silu_bwd")
POLICY_BATCH, POLICY_BLOCKS, POLICY_TAU = 32, 3, 1.0
FEWSHOT_WAY, FEWSHOT_SHOT, FEWSHOT_FOLD, FEWSHOT_TEST = 5, 10, 0, 20  # cfgs/fewshot.yaml's run


def mamba_bf16_at(device, batch: int, length: int, conv: bool = True) -> dict:
    """The bf16 K1-K5 (without ``conv`` K2-K4) at B=batch, L=length on
    ``perf_operands``' views, each held against its plain version at phase
    16's tolerances and timed beside it (K1 and K5 also beside bf16
    ``F.conv1d(groups=D)`` + ``F.silu``). Returns {kernel name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    xz, w, b, args = perf_operands(device, batch, length)
    x = xz[..., :w.shape[0]]
    g = torch.from_numpy(np.random.default_rng(43).standard_normal(
        x.shape, dtype=np.float32)).to(device, torch.bfloat16)
    k2 = bf16_scan_fwd_figures(args)
    k2["plain_ms"] = time_ms(lambda: ks.selective_scan_ref(
        *args[:5], D=args[5], z=args[6], delta_bias=args[7]), 2, warmup=1)
    k3, k4 = bf16_scan_train_figures(args, g)
    out = {"selective_scan_fwd_sm90_bf16": k2, "selective_scan_fwd_residuals_sm90_bf16": k3,
           "selective_scan_bwd_sm90_bf16": k4}
    if conv:
        fwd, bwd = bf16_conv_figures(x, w, b, g)
        out |= {"causal_conv1d_silu_bf16": fwd, "causal_conv1d_silu_bwd_bf16": bwd}
    return {k: _keep(r) for k, r in out.items()}


def legacy_kernel_phase(device) -> dict:
    """K1-K5 at the legacy MAE path's shapes, B=128 (cfgs/pretrain.yaml's
    total_bs): L=26, the encoder's visible tokens in their original order,
    and L=64, its decoder and the probe's noaug encoder; neither is a
    multiple of the scan's 16-token chunk at 26, nor of K1's time tile or
    the bf16 K5's 64-token tile, so each kernel's last tile is partial. The
    fp32 kernels (the path's) through ``mamba_at``, the bf16 ones through
    ``mamba_bf16_at``, each held against its plain version and timed beside
    it. Returns {kernel name: {view: figures}}."""
    out: dict = {}
    for length in (LEGACY_ENC_LEN, LEGACY_DEC_LEN):
        view = f"legacy_L{length}"
        for name, f in (mamba_at(device, PRETRAIN_BATCH, length)
                        | mamba_bf16_at(device, PRETRAIN_BATCH, length)).items():
            out.setdefault(name, {})[view] = f
    log("kernels at the legacy MAE shapes (B=128, L=26 and 64): " + "; ".join(
        f"{name} {view} {f['ms']:.6f} ms (device {f.get('device_ms') or float('nan'):.6f}, "
        f"plain {f['plain_ms']:.6f}, bound {f['bound_ms']:.6f}, max |diff| "
        f"{f['max_abs_err']:.3e})" for name, views in out.items() for view, f in views.items()))
    return out


def ssd_rms_norm_phase(device) -> tuple[dict, dict]:
    """The SSD classifier with ``rms_norm`` (``MODELNET40_SSD_RMS``): one
    held train-mode forward and backward at B=4 (``gradient_phase`` against
    'xla', which launches nothing), its launches K1, K8 with states, K9 and
    K5 once a block and nothing else. Returns ({path: launches}, record)."""
    torch.cuda.synchronize()
    _reset_launch_counts()  # the held forward and gradient
    record = gradient_phase(device, MODELNET40_SSD_RMS, plain_impl="xla")
    torch.cuda.synchronize()
    launches = _launch_counts()
    if launches != _expect(MODELNET40["depth"], SSD_TRAIN_KERNELS):
        raise AssertionError(f"the SSD rms_norm classifier's held step launched {launches}")
    return {"ssd_rms_norm_grad": launches}, record


def policy_inputs(device, batch: int):
    """The permutation policy's inputs as the classifier would hand them: the
    ModelNet40 model's (seeded weights) tokens and positions of ``batch``
    seeded clouds in its SAST sequence (B, 2kG, C), with the eigenpairs of
    the centres' graph (eigvals (B, k), eigvecs (B, G, k))."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.models.point_mamba import spectral_eigvecs

    model = PointMamba(PointMambaConfig.from_dict(MODELNET40),
                       generator=torch.Generator().manual_seed(0)).to(device).eval()
    with torch.inference_mode():
        tokens, pos, center = model.embed(torch.from_numpy(clouds(batch, seed=61)).to(device))
        vals, vecs = spectral_eigvecs(center, model.config)
        x, pos_seq = model.sequence(tokens, pos, center, eigvecs=vecs)
    return tuple(t.clone() for t in (x, pos_seq, vals, vecs))


def policy_phase(device) -> tuple[dict, dict]:
    """The permutation policy (``models/permute_policy.py``) at the
    classifier's width: 384 wide, G=64, k=4, its 3-block stack over the
    2kG = 512-token sequence of POLICY_BATCH clouds (``policy_inputs``), tau
    1 with seeded Gumbel uniforms. One forward and the backward of the
    summed policy (its gradient reaches the stack through the logits) on the
    kernel route must launch K1, K3, K4 and K5 once a block and nothing
    else, give a permutation of the 2kG slots and a finite policy; against
    the same weights on 'seq', the logits within 1e-3 of their max (2e-3
    relative), the policy of the kernel route's permutation within rtol
    1e-5 and every parameter gradient within GRAD_TOL of the largest.
    Returns ({"policy": launches}, the record)."""
    from si_mamba_tpu_torch.models.permute_policy import PermutePolicy

    dim, G, k = MODELNET40["trans_dim"], MODELNET40["num_group"], MODELNET40["k_top_eigenvectors"]
    args = policy_inputs(device, POLICY_BATCH)
    B = POLICY_BATCH
    policy = PermutePolicy(dim, G, k, n_layer=POLICY_BLOCKS,
                           generator=torch.Generator().manual_seed(7)).to(device).train()
    plain = PermutePolicy(dim, G, k, n_layer=POLICY_BLOCKS, scan_impl="seq").to(device).train()
    plain.load_state_dict(policy.state_dict(), strict=True)
    gen = torch.Generator(device).manual_seed(8)
    uniforms = (torch.rand(B * k, G, generator=gen, device=device),
                torch.rand(B, k, generator=gen, device=device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the policy's path: one forward and its gradient
    t0 = time.perf_counter()
    perm, pol = policy(*args, POLICY_TAU, gumbel_uniform=uniforms)
    pol.sum().backward()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    if launches != _expect(POLICY_BLOCKS, TRAIN_KERNELS):
        raise AssertionError(f"the policy's forward and gradient launched {launches}")
    if not torch.equal(torch.sort(perm, dim=1).values,
                       torch.arange(k * G, device=device).expand(B, -1)) or \
            not torch.isfinite(pol).all():
        raise AssertionError("the policy's permutation or log-probability is not valid")

    from si_mamba_tpu_torch.ops.sinkhorn import plackett_luce_log_prob

    inner, outer = plain.logits(*args)
    with torch.no_grad():
        k_inner, k_outer = policy.logits(*args)
    logit_err = max((a - r).abs().max().item() for a, r in ((k_inner, inner), (k_outer, outer)))
    scale = max(inner.abs().max().item(), outer.abs().max().item())
    if not (torch.allclose(k_inner, inner, atol=1e-3 * scale, rtol=2e-3)
            and torch.allclose(k_outer, outer, atol=1e-3 * scale, rtol=2e-3)):
        raise AssertionError(f"the policy's logits disagree with 'seq': {logit_err} (max {scale})")
    order = perm.reshape(B, k, G)[..., 0] // G
    li = torch.gather(inner.reshape(B, k * G), 1, perm).reshape(B, k, G)
    pol_ref = (plackett_luce_log_prob(li).sum(1)
               + plackett_luce_log_prob(torch.gather(outer, 1, order)))
    pol_ref.sum().backward()
    pol_err = ((pol.detach() - pol_ref.detach()).abs() / pol_ref.detach().abs()).max().item()
    if pol_err > 1e-5:
        raise AssertionError(f"the policy differs from 'seq' by {pol_err:.3e} relative")
    ref = {n: p.grad for n, p in plain.named_parameters() if p.grad is not None}
    gmax = max(g.abs().max().item() for g in ref.values())
    worst = max((p.grad - ref[n]).abs().max().item() / gmax
                for n, p in policy.named_parameters() if n in ref)
    if worst >= GRAD_TOL or set(ref) != {n for n, p in policy.named_parameters()
                                         if p.grad is not None}:
        raise AssertionError(f"the policy's gradients differ from 'seq' by {worst:.3e} of the "
                             f"largest")
    record = {"batch": B, "seq_len": 2 * k * G, "blocks": POLICY_BLOCKS, "tau": POLICY_TAU,
              "forward_backward_ms": step_ms, "max_memory_allocated_bytes": peak,
              "logits_max_abs_diff": logit_err, "logits_max_abs": scale,
              "policy_rel_diff": pol_err, "worst_grad_diff_over_max": worst,
              "launches": {n: c for n, c in launches.items() if c}}
    log(f"policy (384 wide, G=64, k=4, B={B}): forward and gradient {step_ms:.3f} ms (first "
        f"call), peak {peak / 2**30:.3f} GiB; logits == 'seq' within {logit_err:.3e} (max "
        f"{scale:.3e}), policy {pol_err:.3e}, gradients {worst:.3e} of the largest; launches "
        f"{record['launches']}")
    return {"policy": launches}, record


def legacy_forward_phase(device) -> tuple[dict, dict]:
    """The legacy 'MAMBA' pretraining model at cfgs/pretrain.yaml's width
    (seeded weights) in eval mode on MAE_HELD_BATCH clouds of 1024 points:
    the loss (the mask of ``jax.random.key(0)``'s draw in both) against the
    same weights on 'seq' within rtol 2e-3, and the noaug features (B, 64,
    384) within 1e-3 of their max and 2e-3 relative; the loss forward
    launches K1 and K2 16 times (12 encoder blocks at L=26, 4 decoder blocks
    at L=64), the feature forward 12 times. Returns ({name: launches}, the
    record)."""
    cfg, model, plain = _mae_pair(device, dict(MAE_FULL, method="MAMBA"), "seq", seed=2)
    model.eval()
    plain.eval()
    pts = torch.from_numpy(np.random.default_rng(54).standard_normal(
        (MAE_HELD_BATCH, 1024, 3), dtype=np.float32)).to(device)
    paths = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        _reset_launch_counts()  # the held legacy loss forward
        loss = model(pts)
        torch.cuda.synchronize()
        paths["legacy_mae_forward"] = _launch_counts()
        want = plain(pts)
        _reset_launch_counts()  # the held legacy feature forward
        feats = model(pts, noaug=True)
        torch.cuda.synchronize()
        paths["legacy_mae_features"] = _launch_counts()
        feats_ref = plain(pts, noaug=True)
    if paths["legacy_mae_forward"] != _expect(PRETRAIN_BLOCKS, EVAL_KERNELS) or \
            paths["legacy_mae_features"] != _expect(PROBE_BLOCKS, EVAL_KERNELS):
        raise AssertionError(f"the held legacy MAE forwards launched {paths}")
    rel = abs(loss.item() - want.item()) / abs(want.item())
    if not np.isfinite(loss.item()) or rel > 2e-3:
        raise AssertionError(f"the legacy MAE eval loss {loss.item()} against 'seq' "
                             f"{want.item()}")
    scale = feats_ref.abs().max().item()
    err = (feats - feats_ref).abs().max().item()
    if feats.shape != (MAE_HELD_BATCH, cfg.num_group, cfg.trans_dim) or not torch.allclose(
            feats, feats_ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"the legacy MAE noaug features disagree with 'seq': max |diff| "
                             f"{err}, max {scale}")
    record = {"batch": MAE_HELD_BATCH, "loss": loss.item(), "loss_plain": want.item(),
              "loss_rel_diff": rel, "features_max_abs_diff": err, "features_max_abs": scale,
              "launches": {k: {n: c for n, c in v.items() if c} for k, v in paths.items()}}
    log(f"legacy MAE eval loss {loss.item():.7f} == 'seq' {want.item():.7f} ({rel:.3e}); noaug "
        f"features max |diff| {err:.3e} (max {scale:.3e})")
    return paths, record


def write_fewshot_tree(root: Path, way: int, shot: int, fold: int, n_test: int) -> Path:
    """``ModelNetFewshot/{way}way_{shot}shot/{fold}.pkl`` (the few-shot
    loader's format): ``shot`` train and ``n_test`` test clouds of 1024
    points a class, each class a seeded Gaussian blob of its own extent."""
    rng = np.random.default_rng(60 + fold)
    axes = 0.3 + rng.random((way, 3))

    def sample(c):
        return ((rng.standard_normal((1024, 3)) * axes[c]).astype(np.float32),
                np.array([c], np.int64))

    out = root / "ModelNetFewshot" / f"{way}way_{shot}shot"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{fold}.pkl", "wb") as f:
        pickle.dump({"train": [sample(c) for c in range(way) for _ in range(shot)],
                     "test": [sample(c) for c in range(way) for _ in range(n_test)]}, f)
    return root / "ModelNetFewshot"


def fewshot_cli_phase(device, card: str) -> tuple[dict, dict]:
    """cfgs/fewshot.yaml through the CLI with --way 5 --shot 10 --fold 0 at
    max_epoch 0 (the published 12 x 384 classifier, total_bs 32) on a seeded
    pickle written under build/fewshot/ (50 train, 100 test clouds of 1024
    points): one step launching K1, K3, K4 and K5 12 times each and nothing
    else, every validation forward K1 and K2 12 times; the head 5 wide
    (--way over the config's cls_dim), the loss finite, the validation
    accuracy in [0, 100]; then --test of its ckpt-last.pth, launches counted
    the same way, gives that accuracy. Returns ({name: launches}, the
    record)."""
    import shutil

    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.config import get_config

    work = ROOT / "build" / "fewshot"
    shutil.rmtree(work / "experiments", ignore_errors=True)  # a run's scalars append
    data = write_fewshot_tree(work, FEWSHOT_WAY, FEWSHOT_SHOT, FEWSHOT_FOLD, FEWSHOT_TEST)
    (work / "fewshot_ds.yaml").write_text(f"NAME: ModelNetFewShot\nDATA_PATH: {data}\n")
    exp_cfg = work / "fewshot_run.yaml"
    exp_cfg.write_text(f"_base_: {ROOT}/cfgs/fewshot.yaml\nmax_epoch: 0\ndataset:\n" + "".join(
        f"  {split}: {{_base_: {work}/fewshot_ds.yaml, others: {{subset: '{subset}'}}}}\n"
        for split, subset in (("train", "train"), ("val", "test"), ("test", "test"))))
    total_bs = int(get_config(str(exp_cfg)).total_bs)
    flags = ["--way", str(FEWSHOT_WAY), "--shot", str(FEWSHOT_SHOT), "--fold",
             str(FEWSHOT_FOLD), "--device", "cuda"]
    forwards, real = [], rf.validate

    def counting_validate(eval_step, state, loader, epoch=0):
        def recording(st, pts):
            forwards.append(pts.shape[0])
            return eval_step(st, pts)

        return real(recording, state, loader, epoch)

    exp = work / "experiments" / "fewshot_run" / "fewshot"
    cwd = os.getcwd()
    os.chdir(work)
    rf.validate = counting_validate
    paths = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()  # the few-shot run's path
        t0 = time.perf_counter()
        state, _ = cli.main(["--config", str(exp_cfg), "--exp_name", "fewshot"] + flags)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        paths["fewshot_cli"] = _launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
        n_forwards, forwards[:] = len(forwards), []
        _reset_launch_counts()  # the test run's path
        test_acc = cli.main(["--config", str(exp_cfg), "--exp_name", "fewshot_test", "--test",
                             "--ckpts", str(exp / "ckpt-last.pth")] + flags)
        paths["fewshot_cli_test"] = _launch_counts()
    finally:
        rf.validate = real
        os.chdir(cwd)
    cfg = state.model.config
    steps = FEWSHOT_WAY * FEWSHOT_SHOT // total_bs  # drop_last
    head = torch.load(exp / "ckpt-last.pth", map_location="cpu",
                      weights_only=True)["base_model"]["cls_head_finetune.8.weight"]
    if (cfg.cls_dim, tuple(head.shape), state.step) != (FEWSHOT_WAY, (FEWSHOT_WAY, 256), steps) \
            or (cfg.trans_dim, cfg.depth, cfg.num_group) != (384, 12, 64):
        raise AssertionError(f"the few-shot run: cls_dim {cfg.cls_dim}, head {tuple(head.shape)}, "
                             f"{state.step} steps, {cfg}")
    want = {k: cfg.depth * (steps * (k in TRAIN_KERNELS) + n_forwards * (k in EVAL_KERNELS))
            for k in paths["fewshot_cli"]}
    if paths["fewshot_cli"] != want:
        raise AssertionError(f"the few-shot run launched {paths['fewshot_cli']}; expected {want}")
    if paths["fewshot_cli_test"] != _expect(cfg.depth * len(forwards), EVAL_KERNELS):
        raise AssertionError(f"--test of the few-shot run launched {paths['fewshot_cli_test']}")
    scalars = [json.loads(line) for line in (exp / "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in scalars if r["tag"] == "Loss/Epoch/Loss"]
    val_acc = [r["value"] for r in scalars if r["tag"] == "Metric/ACC"]
    if len(losses) != 1 or not np.isfinite(losses).all() or len(val_acc) != 1 or \
            not 0.0 <= val_acc[0] <= 100.0 or test_acc != val_acc[0]:
        raise AssertionError(f"the few-shot run logged {scalars}; --test gave {test_acc}")
    record = {"config": "cfgs/fewshot.yaml, max_epoch 0, --way 5 --shot 10 --fold 0",
              "train_clouds": FEWSHOT_WAY * FEWSHOT_SHOT, "test_clouds": FEWSHOT_WAY * FEWSHOT_TEST,
              "steps": steps, "validation_forwards": n_forwards, "run_s": run_s,
              "epoch_loss": losses[0], "val_acc": val_acc[0], "test_acc": test_acc,
              "max_memory_allocated_bytes": peak, "head_shape": list(head.shape), "card": card}
    log(f"{record['config']} through the CLI: {steps} step and {n_forwards} validation forwards "
        f"in {run_s:.1f} s, loss {losses[0]:.4f}, acc {val_acc[0]:.2f} (--test {test_acc:.2f}), "
        f"head {tuple(head.shape)}, peak {peak / 2**30:.3f} GiB; {card}")
    return paths, record


def options_phases(device, card: str) -> tuple[dict, dict]:
    """Phases 41-46: the ModelNet40 classifier with ``rms_norm`` and with
    ``add_after_layer`` through serving (against 'seq') and TRAIN_STEPS train
    steps (the latter's B=4 gradients against 'seq' too), the SSD classifier
    with ``rms_norm`` held once, the permutation policy, the legacy MAE
    (held, then through the pretrain CLI with its probe) and few-shot through
    the CLI. Returns (each path's launches, the record)."""
    paths, record = {}, {}
    for name, base in (("rms_norm", MODELNET40_RMS), ("add_after_layer", MODELNET40_ADD)):
        paths[f"{name}_serving"], serving, model, _ = serving_phase(device, base)
        del model
        train, paths[f"{name}_train"] = train_phase(device, card, base, view_grads=False)
        record[name] = {"serving": serving, "train": train}
    record["add_after_layer"]["gradients"] = gradient_phase(device, MODELNET40_ADD)
    p, record["ssd_rms_norm_gradients"] = ssd_rms_norm_phase(device)
    paths.update(p)
    p, record["policy"] = policy_phase(device)
    paths.update(p)
    p, record["legacy_mae_forward"] = legacy_forward_phase(device)
    paths.update(p)
    p, record["legacy_mae_cli"] = pretrain_cli_phase(device, card, "pretrain.yaml",
                                                     "legacy_mae_cli", TRAIN_KERNELS,
                                                     EVAL_KERNELS, method="MAMBA")
    paths.update(p)
    p, record["fewshot_cli"] = fewshot_cli_phase(device, card)
    paths.update(p)
    return paths, record


# ---------------------------------------------------------------------------
# the last modules (phases 47-50): the HTTP server, the associative scan, the
# Mamba-1 sequence-parallel scan (run by the ranks of phases 11-14), the
# utilities
# ---------------------------------------------------------------------------

SERVE_CLIENTS = 16
SERVE_REQUESTS = 512  # from SERVE_CLIENTS threads, half .npy, half JSON
SERVE_SINGLE = 256  # one client's requests in turn (a p99 over 256 samples, not a maximum)
SERVE_DELAY_MS = 5.0  # the server's default max_delay_ms
ASSOC_EVAL_BATCH = 32  # the 12-block classifier's eval forward under 'assoc'
ASSOC_TRAIN_BATCH = 8  # its forward + backward: (b, l, d, n) fp32 tensors of every level kept
TSNE_FEATURES = 2468  # the ModelNet40 test split's clouds
TSNE_DIM = 256  # the classifier's pooled feature width
VIS_SAMPLES, VIS_BATCH = 16, 8
NATIVE_CLOUDS, NATIVE_POINTS, NATIVE_SAMPLES = 8, 8192, 1024


def _http(url: str, path: str, data: bytes | None = None, content_type: str | None = None):
    """(status, the JSON reply) of one request to the phase's server."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": content_type} if content_type else {}
    req = urllib.request.Request(url + path, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _latency(seconds) -> dict:
    ms = np.asarray(seconds) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()), "requests": int(ms.size)}


def serve_http_phase(device, card: str) -> tuple[dict, dict]:
    """Phase 47: the published classifier (12 x 384, seeded weights) in a
    ``Predictor`` (npoints 1024, max_batch 64) behind ``serve_http.make_server``
    on 127.0.0.1 (a free port, max_delay_ms 5): SERVE_SINGLE requests from
    one client in turn, then SERVE_REQUESTS from SERVE_CLIENTS threads at once
    (half ``.npy``, half JSON bodies), that run's launches counted from 0:
    K1 and K2 12 times each for every coalesced batch, nothing else. Every
    reply's label is ``predict_proba``'s of its cloud alone and its probs lie
    within 1e-4 of it; ``/healthz`` reports a mean batch above 1; a malformed
    body answers 400 and an unknown route 404. Returns ({path: launches},
    the record)."""
    import io
    import threading

    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serve_http import make_server, shutdown_server
    from si_mamba_tpu_torch.serving import Predictor

    model = PointMamba(PointMambaConfig.from_dict(MODELNET40),
                       generator=torch.Generator().manual_seed(0))
    cfg = model.config
    if (cfg.trans_dim, cfg.depth, cfg.num_group) != (384, 12, 64):
        raise AssertionError(f"the served model is not the published one: {cfg}")
    predictor = Predictor(model, npoints=NPOINTS, max_batch=64, device=device)
    predictor.warmup()
    pts = clouds(SERVE_REQUESTS, seed=47)

    def body(i):
        if i % 2:
            return json.dumps({"points": pts[i].tolist()}).encode(), "application/json"
        buf = io.BytesIO()
        np.save(buf, pts[i])
        return buf.getvalue(), "application/octet-stream"

    bodies = [body(i) for i in range(SERVE_REQUESTS)]
    server = make_server(predictor.predict_proba, host="127.0.0.1", port=0, max_batch=64,
                         max_delay_ms=SERVE_DELAY_MS)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    batcher = server.RequestHandlerClass.batcher

    def post(i):
        t = time.perf_counter()
        status, reply = _http(url, "/predict", *bodies[i])
        return status, reply, time.perf_counter() - t

    try:
        single = [post(i) for i in range(SERVE_SINGLE)]
        replies: list = [None] * SERVE_REQUESTS

        def client(c):
            for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                replies[i] = post(i)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        n_batches0, n_requests0 = batcher.n_batches, batcher.n_requests
        torch.cuda.synchronize()
        _reset_launch_counts()  # phase 47's path: the 16 clients' requests
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        n_batches = batcher.n_batches - n_batches0
        n_requests = batcher.n_requests - n_requests0
        health = _http(url, "/healthz")
        bad = _http(url, "/predict", b"not a cloud", "application/octet-stream")
        missing = _http(url, "/nope")
    finally:
        shutdown_server(server)
    failed = [r and r[:2] for r in replies + single if r is None or r[0] != 200]
    if failed:
        raise AssertionError(f"{len(failed)} requests failed: {failed[:3]}")
    if n_requests != SERVE_REQUESTS:
        raise AssertionError(f"the batcher took {n_requests} requests, not {SERVE_REQUESTS}")
    want = _expect(cfg.depth * n_batches, EVAL_KERNELS)
    if launches != want:
        raise AssertionError(f"{n_batches} coalesced batches launched {launches}; expected {want}")
    if health[0] != 200 or not health[1]["mean_batch_size"] > 1.0:
        raise AssertionError(f"/healthz: {health}")
    if bad[0] != 400 or missing[0] != 404:
        raise AssertionError(f"the error paths answered {bad} and {missing}")
    worst = 0.0
    for i, (_, reply, _) in enumerate(replies):
        alone = predictor.predict_proba(pts[i:i + 1])[0]
        err = float(np.abs(np.asarray(reply["probs"]) - alone).max())
        worst = max(worst, err)
        if reply["label"] != int(alone.argmax()) or err > 1e-4:
            raise AssertionError(f"request {i}: served {reply['label']} with probs {err} from "
                                 f"predict_proba of the cloud alone ({int(alone.argmax())})")
    record = {"one_client": _latency([r[2] for r in single]),
              "clients": SERVE_CLIENTS,
              "many_clients": _latency([r[2] for r in replies]),
              "many_clients_wall_s": wall, "requests_per_s": SERVE_REQUESTS / wall,
              "coalesced_batches": n_batches, "mean_batch_size": n_requests / n_batches,
              "healthz": health[1], "max_delay_ms": SERVE_DELAY_MS,
              "worst_prob_diff_vs_alone": worst, "card": card}
    log(f"serve_http: 1 client p50 {record['one_client']['p50_ms']:.3f} ms, p99 "
        f"{record['one_client']['p99_ms']:.3f} ms over {SERVE_SINGLE} requests; {SERVE_CLIENTS} "
        f"clients p50 {record['many_clients']['p50_ms']:.3f} ms, p99 "
        f"{record['many_clients']['p99_ms']:.3f} ms over {SERVE_REQUESTS} requests, "
        f"in {n_batches} batches (mean "
        f"{n_requests / n_batches:.2f}), "
        f"{record['requests_per_s']:.1f} requests/s; probs within {worst:.2e} of each cloud "
        f"alone; {card}")
    return {"serve_http": launches}, record


def _peak_run(device, fn) -> tuple[object, float, float]:
    """(fn(), its peak allocation above what was allocated before it in GiB,
    its wall ms to a synchronise)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, (torch.cuda.max_memory_allocated(device) - base) / 2**30, ms


def assoc_phase(device) -> dict:
    """Phase 48: ``impl='assoc'`` (the whole-sequence log-depth scan in plain
    PyTorch) against the kernel route. One mixer at B=32, L=512, d_inner 768:
    y within 1e-4 of its max and every gradient within GRAD_TOL of its max
    from 'pallas' (K1-K5); each route's wall time (the second call) and
    peak. The 12-block classifier's eval logits under 'assoc' against 'auto'
    at B=ASSOC_EVAL_BATCH (atol 1e-3 max, rtol 2e-3), and its train-mode
    forward + backward at B=ASSOC_TRAIN_BATCH beside the kernel route's: peaks
    and times. Returns the record."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.ops.selective_scan import mamba_mixer_apply

    mixer, p, _ = mixer_inputs(device)
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 512, MODELNET40["trans_dim"]),
                                             dtype=np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape), dtype=np.float32)).to(device)

    def step(impl):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        y = mamba_mixer_apply(leaves, xx, d_state=mixer.d_state, dt_rank=mixer.dt_rank,
                              impl=impl)
        torch.sum(y * g).backward()
        return y.detach(), {**{k: v.grad for k, v in leaves.items()}, "x": xx.grad}

    mix = {}
    for impl in ("pallas", "assoc"):
        step(impl)  # warm: builds, allocator
        out, peak, ms = _peak_run(device, lambda: step(impl))
        mix[impl] = {"out": out, "peak_gib": peak, "fwd_bwd_ms": ms}
    y_err = _rel_err(mix["assoc"]["out"][0], mix["pallas"]["out"][0])
    g_err = {k: _rel_err(v, mix["pallas"]["out"][1][k])[1]
             for k, v in mix["assoc"]["out"][1].items()}
    if y_err[1] > 1e-4 or max(g_err.values()) > GRAD_TOL:
        raise AssertionError(f"'assoc' mixer against 'pallas': y {y_err}, gradients {g_err}")

    model = PointMamba(PointMambaConfig.from_dict(MODELNET40),
                       generator=torch.Generator().manual_seed(0)).to(device)
    assoc = PointMamba(PointMambaConfig.from_dict({**MODELNET40, "scan_impl": "assoc"})).to(device)
    assoc.load_state_dict(model.state_dict(), strict=True)
    pts = torch.from_numpy(clouds(ASSOC_EVAL_BATCH, seed=48)).to(device)
    cls = {}
    for name, m in (("auto", model), ("assoc", assoc)):
        with torch.inference_mode():
            m.eval()(pts)  # warm
            out, peak, ms = _peak_run(device, lambda m=m: m.eval()(pts).float())
        cls[name] = {"logits": out, "eval_peak_gib": peak, "eval_ms": ms}
    ref = cls["auto"]["logits"]
    scale = ref.abs().max().item()
    err = (cls["assoc"]["logits"] - ref).abs().max().item()
    if not torch.allclose(cls["assoc"]["logits"], ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"'assoc' logits against 'auto': max |diff| {err}, max {scale}")
    labels = torch.arange(ASSOC_TRAIN_BATCH, device=device) % MODELNET40["cls_dim"]

    def train(m):
        m.train()
        m.zero_grad(set_to_none=True)
        logits = m(pts[:ASSOC_TRAIN_BATCH], generator=torch.Generator(device).manual_seed(0))
        loss = F.cross_entropy(logits.float(), labels)
        loss.backward()
        return loss.item()

    for name, m in (("auto", model), ("assoc", assoc)):
        train(m)  # warm
        loss, peak, ms = _peak_run(device, lambda m=m: train(m))
        if not np.isfinite(loss):
            raise AssertionError(f"{name}: the train loss is {loss}")
        cls[name].update(train_loss=loss, train_peak_gib=peak, train_ms=ms)
    del model, assoc
    torch.cuda.empty_cache()
    record = {"mixer": {"shape": dict(B=TRAIN_BATCH, L=512, d_inner=mixer.d_inner,
                                      d_state=mixer.d_state),
                        **{impl: {k: v for k, v in r.items() if k != "out"}
                           for impl, r in mix.items()},
                        "y_rel_err_of_max": y_err[1], "grad_rel_err_of_max": g_err},
              "classifier": {"eval_batch": ASSOC_EVAL_BATCH, "train_batch": ASSOC_TRAIN_BATCH,
                             "logits_max_abs_diff": err, "logits_max_abs": scale,
                             **{name: {k: v for k, v in r.items() if k != "logits"}
                                for name, r in cls.items()}}}
    log(f"assoc mixer (B={TRAIN_BATCH}, L=512, d_inner {mixer.d_inner}): fwd+bwd "
        f"{mix['assoc']['fwd_bwd_ms']:.1f} ms, peak {mix['assoc']['peak_gib']:.2f} GiB; 'pallas' "
        f"{mix['pallas']['fwd_bwd_ms']:.1f} ms, {mix['pallas']['peak_gib']:.2f} GiB; y "
        f"{y_err[1]:.2e}, "
        f"gradients {max(g_err.values()):.2e} of max")
    log(f"assoc classifier: eval B={ASSOC_EVAL_BATCH} {cls['assoc']['eval_ms']:.1f} ms, peak "
        f"{cls['assoc']['eval_peak_gib']:.2f} GiB ('auto' {cls['auto']['eval_ms']:.1f} ms, "
        f"{cls['auto']['eval_peak_gib']:.2f} GiB), logits {err:.2e} of {scale:.2e}; train "
        f"B={ASSOC_TRAIN_BATCH} {cls['assoc']['train_ms']:.1f} ms, peak "
        f"{cls['assoc']['train_peak_gib']:.2f} GiB ('auto' {cls['auto']['train_ms']:.1f} ms, "
        f"{cls['auto']['train_peak_gib']:.2f} GiB)")
    return record


def sp_mamba_rank(device, rank: int) -> tuple[dict, dict]:
    """Phase 49 on one of the ranks of phases 11-14:
    ``selective_scan_seq_parallel`` (each rank's half of L scanned with the
    associative scan from a zero state, one all-gather of the carries) on
    layer 0's scan operands at B=32, L=512 (256 a rank), d_inner 768, n 16;
    y within 1e-4 of its max and every gradient (A, D, the dt bias summed
    over the ranks) within GRAD_TOL of its max from the plain chunked scan of
    the whole L on one rank. The path is plain PyTorch (the JAX package's is
    XLA): no kernel launches. Returns (launches, record)."""
    from si_mamba_tpu_torch.ops.selective_scan import selective_scan_chunked
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import selective_scan_seq_parallel

    mesh = make_mesh(("seq",), (TP,))
    names = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
    seq = ("u", "delta", "B", "C", "z")
    full = {k: v.detach().contiguous() for k, v in zip(names, scan_operands(device))}
    L = full["u"].shape[1]
    part = slice(rank * (L // TP), (rank + 1) * (L // TP))
    local = {k: (v[:, part].contiguous() if k in seq else v) for k, v in full.items()}
    w = torch.from_numpy(np.random.default_rng(49).standard_normal(
        tuple(full["u"].shape), dtype=np.float32)).to(device)

    def fwd(t):
        return selective_scan_seq_parallel(t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"],
                                           z=t["z"], delta_bias=t["delta_bias"], mesh=mesh)

    with torch.no_grad():
        fwd(local)  # warm
        torch.cuda.synchronize()
        _reset_launch_counts()  # phase 49's path
        y = fwd(local)
        torch.cuda.synchronize()
        launches = _launch_counts()
        fwd_ms = time_ms(lambda: fwd(local), 5)
    leaves = {k: v.clone().requires_grad_() for k, v in local.items()}

    def train():
        for v in leaves.values():
            v.grad = None
        out = fwd(leaves)
        torch.sum(out * w[:, part]).backward()
        return out

    torch.cuda.reset_peak_memory_stats(device)
    train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    got = {k: v.grad.clone() for k, v in leaves.items()}
    train_ms = time_ms(train, 3)
    ref = {k: v.clone().requires_grad_() for k, v in full.items()}
    y_ref = selective_scan_chunked(ref["u"], ref["delta"], ref["A"], ref["B"], ref["C"],
                                   D=ref["D"], z=ref["z"], delta_bias=ref["delta_bias"])
    torch.sum(y_ref * w).backward()
    errs = {"y": _rel_err(y, y_ref[:, part].detach())}
    for k in names:
        errs[f"d{k}"] = _rel_err(got[k], ref[k].grad[:, part] if k in seq else ref[k].grad)
    bad = {k: v for k, v in errs.items() if v[1] > (1e-4 if k == "y" else GRAD_TOL)}
    if bad:
        raise AssertionError(f"rank {rank}: the Mamba-1 SP scan disagrees with one rank's: {bad}")
    if any(launches.values()):
        raise AssertionError(f"rank {rank}: the Mamba-1 SP scan launched {launches}")
    if rank == 0:
        log(f"rank 0: Mamba-1 SP scan ok, forward {fwd_ms:.3f} ms, forward + backward "
            f"{train_ms:.3f} ms, peak {peak:.2f} GiB")
    return launches, {"shape": dict(B=full["u"].shape[0], L=L, d_inner=full["u"].shape[2],
                                    d_state=full["A"].shape[1], ranks=TP),
                      "fwd_ms": fwd_ms, "fwd_bwd_ms": train_ms, "fwd_bwd_peak_gib": peak,
                      "rel_err_of_max": {k: v[1] for k, v in errs.items()}}


class _CloudSet:
    """Seeded clouds as a dataset of (points, label 0)."""

    def __init__(self, pts: np.ndarray):
        self.pts = pts

    def __len__(self) -> int:
        return len(self.pts)

    def __getitem__(self, i):
        return self.pts[i], 0


def _png_size(data: bytes) -> tuple[int, int]:
    """(width, height) of a PNG the port wrote, after checking its signature,
    every chunk's CRC and that its pixels decode to that size."""
    import struct
    import zlib

    from si_mamba_tpu_torch.utils.visualization import PNG_SIGNATURE

    if data[:8] != PNG_SIGNATURE:
        raise AssertionError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != \
                zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise AssertionError(f"bad CRC in the {kind!r} chunk")
        chunks[kind] = body
        pos += 12 + length
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    if len(zlib.decompress(chunks[b"IDAT"])) != h * (1 + 3 * w):
        raise AssertionError("the PNG's pixels do not decode to its size")
    return w, h


def utilities_phase(device, card: str, pretrain_ckpt: str) -> tuple[dict, dict]:
    """Phase 50: ``--tsne`` through the CLI (the harness config and tree of
    phase 15, its ckpt-last.pth): K1 and K2 12 times for each test batch, the
    t-SNE of the 80 features on the card, a PNG that decodes; the t-SNE alone
    at the ModelNet40 test split's size (TSNE_FEATURES seeded 256-wide
    features of 40 classes); ``vis_run`` of the pretraining CLI run's
    ckpt-last.pth over VIS_SAMPLES seeded clouds (K1 and K2 once a block for
    every batch; the text dumps and PNG renders); ``native.fps_cpu`` equal to
    the device FPS (``data/datasets.fps_indices``, the same arithmetic) on
    NATIVE_CLOUDS clouds of 8192 points. Returns ({path: launches}, the
    record)."""
    from si_mamba_tpu_torch import native
    from si_mamba_tpu_torch.data.datasets import fps_indices
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.models.point_mae import PointMAEConfig
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train.config import get_config
    from si_mamba_tpu_torch.train.runner_vis import vis_run
    from si_mamba_tpu_torch.utils import visualization as vz

    paths, record = {}, {"card": card}
    work = ROOT / "build" / "harness"
    exp_cfg = work / "harness_modelnet.yaml"
    ckpt = work / "experiments" / "harness_modelnet" / "run" / "ckpt-last.pth"
    config = get_config(str(exp_cfg))
    depth = int(config.model.depth)
    timed, real = [], vz.tsne_features

    def timed_tsne(features, labels, out_path, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(features, labels, out_path, **kw)
        timed.append({"n": int(features.shape[0]), "device": str(features.device),
                      "s": time.perf_counter() - t})
        return out

    cwd = os.getcwd()
    os.chdir(work)
    vz.tsne_features = timed_tsne
    try:
        torch.cuda.synchronize()
        _reset_launch_counts()  # phase 50's --tsne path
        t0 = time.perf_counter()
        png = cli.main(["--config", str(exp_cfg), "--device", "cuda", "--exp_name", "tsne",
                        "--tsne", "--ckpts", str(ckpt)])
        run_s = time.perf_counter() - t0
        paths["tsne_cli"] = _launch_counts()
    finally:
        vz.tsne_features = real
        os.chdir(cwd)
    forwards = -(-HARNESS_TEST // int(config.total_bs))
    if paths["tsne_cli"] != _expect(depth * forwards, EVAL_KERNELS):
        raise AssertionError(f"--tsne launched {paths['tsne_cli']} for {forwards} forwards")
    size = _png_size((work / png).read_bytes())
    if timed[0]["n"] != HARNESS_TEST or \
            torch.device(timed[0]["device"]).type != torch.device(device).type:
        raise AssertionError(f"--tsne embedded {timed}")
    record["tsne_cli"] = {"run_s": run_s, "tsne_s": timed[0]["s"], "features": timed[0]["n"],
                          "forwards": forwards, "png": list(size)}

    rng = np.random.default_rng(50)
    centers = torch.from_numpy(3.0 * rng.standard_normal((40, TSNE_DIM), dtype=np.float32))
    labels = np.arange(TSNE_FEATURES) % 40
    feats = (centers[labels] + torch.from_numpy(rng.standard_normal(
        (TSNE_FEATURES, TSNE_DIM), dtype=np.float32))).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, kl = vz.tsne_embed(feats)
    tsne_s = time.perf_counter() - t0
    if emb.shape != (TSNE_FEATURES, 2) or not np.isfinite(emb).all() or not np.isfinite(kl):
        raise AssertionError(f"the t-SNE at N={TSNE_FEATURES}: {emb.shape}, KL {kl}")
    record["tsne"] = {"features": TSNE_FEATURES, "dim": TSNE_DIM, "s": tsne_s, "kl": kl}

    exp = Path(pretrain_ckpt).parent
    os.chdir(exp.parents[2])
    try:
        mae_cfg = PointMAEConfig.from_dict(get_config(str(exp / "config.yaml")).model)
    finally:
        os.chdir(cwd)
    state = torch.load(pretrain_ckpt, map_location="cpu", weights_only=True)["base_model"]
    loader = Loader(_CloudSet(clouds(VIS_SAMPLES, seed=50)), batch_size=VIS_BATCH, prefetch=0)
    out_dir = ROOT / "build" / "vis"
    torch.cuda.synchronize()
    _reset_launch_counts()  # phase 50's vis_run path
    t0 = time.perf_counter()
    tags = vis_run(mae_cfg, state, loader, str(out_dir), max_samples=VIS_SAMPLES, seed=0,
                   device=device)
    vis_s = time.perf_counter() - t0
    paths["vis_run"] = _launch_counts()
    blocks = mae_cfg.depth + mae_cfg.decoder_depth
    if paths["vis_run"] != _expect(blocks * (VIS_SAMPLES // VIS_BATCH), EVAL_KERNELS):
        raise AssertionError(f"vis_run launched {paths['vis_run']}")
    rebuilt = np.loadtxt(out_dir / f"{tags[-1]}_full.txt", delimiter=";")
    if len(tags) != VIS_SAMPLES or rebuilt.shape[1] != 3 or not np.isfinite(rebuilt).all():
        raise AssertionError(f"vis_run dumped {tags}, {rebuilt.shape}")
    record["vis_run"] = {"samples": len(tags), "s": vis_s, "points_rebuilt": rebuilt.shape[0],
                         "png": list(_png_size((out_dir / f"{tags[-1]}_full.png").read_bytes()))}

    pts = np.random.default_rng(51).standard_normal(
        (NATIVE_CLOUDS, NATIVE_POINTS, 3)).astype(np.float32)
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = native.fps_cpu(pts, NATIVE_SAMPLES)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = fps_indices(torch.from_numpy(pts).to(device), NATIVE_SAMPLES).cpu().numpy()
    dev_s = time.perf_counter() - t0
    if not np.array_equal(host, dev):
        raise AssertionError(f"native fps_cpu differs from the device FPS in "
                             f"{int((host != dev).sum())} indices")
    record["native_fps"] = {"clouds": NATIVE_CLOUDS, "points": NATIVE_POINTS,
                            "samples": NATIVE_SAMPLES, "gxx_build_s": build_s,
                            "host_s": host_s, "device_s": dev_s}
    log(f"--tsne: {forwards} forwards, t-SNE of {HARNESS_TEST} features {timed[0]['s']:.2f} s, "
        f"PNG {size}, run {run_s:.1f} s; t-SNE of {TSNE_FEATURES} x {TSNE_DIM} on the card "
        f"{tsne_s:.2f} s (KL {kl:.3f}); vis_run {len(tags)} samples in {vis_s:.2f} s; native FPS "
        f"(built in {build_s:.2f} s) {host_s:.2f} s on the host, {dev_s:.2f} s on the card, "
        f"equal; {card}")
    return paths, record


def last_module_phases(device, card: str, pretrain_ckpt: str) -> tuple[dict, dict]:
    """Phases 47, 48 and 50 (phase 49 runs on the ranks of phases 11-14).
    Returns (each path's launches, the record)."""
    paths, record = {}, {}
    p, record["serve_http"] = serve_http_phase(device, card)
    paths.update(p)
    record["assoc"] = assoc_phase(device)
    p, record["utilities"] = utilities_phase(device, card, pretrain_ckpt)
    paths.update(p)
    return paths, record


# ---------------------------------------------------------------------------
# the kernels at the shapes their Pallas kernels compile for (phases 51-56)
# ---------------------------------------------------------------------------

ANY_SOURCE = "si_mamba_tpu_torch/csrc/mamba_any.cu"
CONV_WIDTHS = (1, 2, 3, 5)  # held alone; 3 and 2 run on the stacks' paths
SCAN_STATES = (1, 8, 12, 32, 64, 300)  # held alone; 8 and 32 run on the stacks' paths
STACKS = {"stack_n8_w3": dict(d_state=8, d_conv=3), "stack_n32_w2": dict(d_state=32, d_conv=2)}
FUSED_SHAPES = (  # (d_inner, d_state, d_conv, dt_rank) held alone; 1536 is the path's
    (1152, 16, 4, 36), (1536, 16, 4, 48), (2048, 16, 4, 64), (2560, 16, 4, 80),
    (768, 8, 4, 24), (768, 32, 4, 24), (768, 16, 2, 24), (768, 16, 3, 24))
FUSED_HOLD = dict(batch=4, length=256)  # the shapes held alone, at this size
SSD_CHUNKS = (8, 32, 96, 512, 1024)  # held alone; 32 and 512 run on the classifier's paths
SSD_HOLD_BATCH = 32
SSD_HOLD_HEADS = 1  # heads of the held cores (the classifier's 6 on the timed shapes)
SSD_CORE_BATCH = 8  # the small core paths that reach the carry and split entry points
MODELNET40_768_FUSED = dict(MODELNET40, trans_dim=768, encoder_dims=768, scan_impl="fused")
SLICE21_EPOCHS = 2  # CLI epochs of phase 56's classifiers: 4 steps on the harness tree


def _hold(name: str, got: torch.Tensor, want: torch.Tensor, rel: float, ulps: float = 1,
          floor: float = 1e-2) -> float:
    """A kernel output against its plain version: fp32 within ``rel`` of the
    max, bf16 within ``ulps`` bf16 ulps at ``floor`` of the max. Returns max |diff|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against the plain "
                             f"version's {want.dtype} {tuple(want.shape)}")
    return _check_bf16(name, got, want, ulps=ulps, floor=floor, rel=rel)


def _timed(fn, plain, iters: int = 10, plain_iters: int = 1) -> dict:
    """Eager and CUDA-graph device time of ``fn``, and the plain version's
    (no warm-up: it launches no kernel of its own)."""
    return dict(ms=time_ms(fn, iters), device_ms=graph_ms(fn, iters),
                plain_ms=time_ms(plain, plain_iters, warmup=0))


def _rand(device, *shape, scale=1.0, seed=0, dtype=torch.float32):
    return (torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))
            * scale).to(device, dtype)


def conv_any_phase(device) -> dict:
    """K1/K5's any-width variants: held alone at widths CONV_WIDTHS on the
    column view of xz (B=32, L=512, d_inner 768, row stride 1536), fp32 and
    bf16 (fp32 within 1e-5 of max; bf16 y and dx within one ulp at a floor of
    1e-2, dw and db within 1e-4), the backward twice, bitwise equal; timed at
    width 3 (the stack path's) beside the plain versions and the library's
    conv + SiLU. Returns {record name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        xz = _rand(device, 32, 512, 1536, seed=81, dtype=dtype)
        x, g = xz[..., :768], _rand(device, 32, 512, 768, seed=82, dtype=dtype)
        held, timed = {}, {}
        for W in CONV_WIDTHS:
            w, b = _rand(device, 768, W, scale=0.5, seed=W), _rand(device, 768, scale=0.1, seed=9)
            y = kc.causal_conv1d_silu_fwd(x, w, b)
            e1 = _hold(f"K1 any W={W}{sfx}", y, kc.causal_conv1d_ref(x, w, b), 1e-5)
            got = kc.causal_conv1d_silu_bwd(x, w, b, g)
            again = kc.causal_conv1d_silu_bwd(x, w, b, g)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError(f"two any-width conv backward runs (W={W}) differ")
            e5 = max(_hold(f"K5 any W={W}{sfx} {nm}", a, r, 1e-4)
                     for nm, a, r in zip(("dx", "dw", "db"), got,
                                         kc.causal_conv1d_silu_bwd_ref(x, w, b, g)))
            held[str(W)] = dict(fwd_err=e1, bwd_err=e5)
            if W == 3:
                size = x.element_size()
                xt, w3 = x.transpose(1, 2), w[:, None, :].to(dtype)
                bd_f = bound(2 * x.numel() * size + 768 * (W + 1) * 4, x.numel() * (2 * W + 5))
                bd_b = bound(3 * x.numel() * size + 2 * 768 * (W + 1) * 4, x.numel() * (6 * W + 11))
                x_lib = xt.detach().requires_grad_()
                w_lib, b_lib = w3.detach().clone().requires_grad_(), b.to(dtype).requires_grad_()
                y_lib = F.silu(F.conv1d(x_lib, w_lib, b_lib, padding=W - 1, groups=768)[..., :512])
                timed = dict(
                    fwd=dict(shape=[32, 512, 768], width=W, max_abs_err=e1,
                             bound_ms=bd_f[0], bound_by=bd_f[1],
                             library_ms=time_ms(lambda: F.silu(F.conv1d(
                                 xt, w3, b.to(dtype), padding=W - 1, groups=768)[..., :512]), 10),
                             **_timed(lambda: kc.causal_conv1d_silu_fwd(x, w, b),
                                      lambda: kc.causal_conv1d_ref(x, w, b), 20, 5)),
                    bwd=dict(shape=[32, 512, 768], width=W, max_abs_err=e5,
                             bound_ms=bd_b[0], bound_by=bd_b[1],
                             library_ms=time_ms(lambda: torch.autograd.grad(
                                 y_lib, (x_lib, w_lib, b_lib), g.transpose(1, 2),
                                 retain_graph=True), 10),
                             **_timed(lambda: kc.causal_conv1d_silu_bwd(x, w, b, g),
                                      lambda: kc.causal_conv1d_silu_bwd_ref(x, w, b, g), 20, 2)))
        out["causal_conv1d_silu_any" + sfx] = dict(timed["fwd"], held_widths=held)
        out["causal_conv1d_silu_bwd_any" + sfx] = dict(timed["bwd"], held_widths=held)
    log("any-width conv: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f}, bound {v['bound_ms']:.4f}, plain "
        f"{v['plain_ms']:.3f}, library {v['library_ms']:.4f}), held at W {v['held_widths']}"
        for k, v in out.items()))
    return out


def _scan_case(device, B, L, D, n, dtype, seed):
    u = _rand(device, B, L, D, seed=seed, dtype=dtype)
    delta = _rand(device, B, L, D, scale=0.5, seed=seed + 1, dtype=dtype)
    x_dbl = _rand(device, B, L, 24 + 2 * n, seed=seed + 2, dtype=dtype)
    A = -(torch.rand(D, n, generator=torch.Generator().manual_seed(seed)) + 0.1).to(device)
    return (u, delta, A, x_dbl[..., 24:24 + n], x_dbl[..., 24 + n:],
            _rand(device, D, seed=seed + 3), _rand(device, B, L, D, seed=seed + 4, dtype=dtype),
            _rand(device, D, scale=0.1, seed=seed + 5))


def scan_any_phase(device) -> dict:
    """K2-K4's any-state variants: held alone at d_state SCAN_STATES (B=8 at
    1, 12, 64 and 300, the last with its arrays in the global workspace,
    B=32 at 8 and 32, L=512, d_inner 768; B and C column views
    of x_dbl), fp32 and bf16, at the perf-mode tolerances (bf16 y one ulp,
    the backward's bf16 outputs two at a floor of 2e-2, fp32 outputs 1e-4 and
    the backward's sums 1e-3 of max); K3's y equal to K2's; K4 twice, bitwise
    equal; timed at d_state 8, 32 and 300. Returns {record name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        held = {}
        for n in SCAN_STATES:
            B = 32 if n in (8, 32) else 8
            args = _scan_case(device, B, 512, 768, n, dtype, seed=90 + n)
            y = ks.selective_scan_fwd(*args)
            e2 = _hold(f"K2 any n={n}{sfx}", y, ks.selective_scan_ref(
                *args[:5], D=args[5], z=args[6], delta_bias=args[7]), 1e-4)
            y3, he = ks.selective_scan_fwd_residuals(*args)
            if not torch.equal(y3, y):
                raise AssertionError(f"any-state K3's y (n={n}) differs from K2's")
            e3 = _hold(f"K3 any n={n}{sfx} h", he,
                       ks.selective_scan_fwd_residuals_ref(*args)[1], 1e-4)
            g = _rand(device, B, 512, 768, seed=95, dtype=dtype)
            got = ks.selective_scan_bwd(*args, g, he)
            if not all(torch.equal(p, q) for p, q in zip(got, ks.selective_scan_bwd(*args, g, he))):
                raise AssertionError(f"two any-state scan backward runs (n={n}) differ")
            e4 = max(_hold(f"K4 any n={n}{sfx} {nm}", a, r, 1e-3, ulps=2, floor=2e-2)
                     for nm, a, r in zip(("du", "ddt", "dA", "dB", "dC", "dD", "dz", "ddtb"),
                                         got, ks.selective_scan_bwd_ref(*args, g, he)))
            held[str(n)] = dict(k2=e2, k3=e3, k4=e4)
            if n not in (8, 32, 300):
                continue
            size, L, D = args[0].element_size(), 512, 768
            nc = -(-L // ks.CHUNK)
            fwd_bytes = (4 * B * L * D + 2 * B * L * n) * size + (D * n + 2 * D) * 4
            bwd_bytes = (7 * B * L * D + 4 * B * L * n) * size + (B * nc * n * D + 2 * D * n
                                                                  + 4 * D) * 4
            for name, fn, plain, bd, err in (
                    ("selective_scan_fwd_any", lambda: ks.selective_scan_fwd(*args),
                     lambda: ks.selective_scan_ref(*args[:5], D=args[5], z=args[6],
                                                   delta_bias=args[7]),
                     bound(fwd_bytes, B * L * D * (10 + 7 * n)), e2),
                    ("selective_scan_fwd_residuals_any",
                     lambda: ks.selective_scan_fwd_residuals(*args),
                     lambda: ks.selective_scan_fwd_residuals_ref(*args),
                     bound(fwd_bytes + B * nc * n * D * 4, B * L * D * (10 + 7 * n)), e3),
                    ("selective_scan_bwd_any", lambda: ks.selective_scan_bwd(*args, g, he),
                     lambda: ks.selective_scan_bwd_ref(*args, g, he),
                     bound(bwd_bytes, B * L * D * (20 * n + 20)), e4)):
                out.setdefault(name + sfx, {})[str(n)] = dict(
                    shape=[B, L, D], d_state=n, max_abs_err=err, bound_ms=bd[0], bound_by=bd[1],
                    library_ms=None, **_timed(fn, plain))
        for name in ("selective_scan_fwd_any", "selective_scan_fwd_residuals_any",
                     "selective_scan_bwd_any"):
            by_n = out[name + sfx]
            out[name + sfx] = dict(by_n["8"], at_d_state_32=by_n["32"],
                                   at_d_state_300=by_n["300"], held_d_states=held)
    log("any-state scan: " + "; ".join(
        f"{k} n=8 {v['ms']:.4f} ms (device {v['device_ms']:.4f}, bound {v['bound_ms']:.4f}, "
        f"plain {v['plain_ms']:.2f}), n=32 {v['at_d_state_32']['ms']:.4f} ms, n=300 "
        f"{v['at_d_state_300']['ms']:.4f} ms (device {v['at_d_state_300']['device_ms']:.4f})"
        for k, v in out.items()))
    return out


def _fused_args(device, d_inner, d_state, d_conv, dt_rank, batch, length, dtype, seed):
    """K10/K11's inputs as a freshly initialised mixer of that shape makes
    them from a seeded x."""
    from si_mamba_tpu_torch.models.layers import MambaMixer
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer = MambaMixer(d_inner // 2, d_state=d_state, d_conv=d_conv, dt_rank=dt_rank)
    mixer.reset_parameters(torch.Generator().manual_seed(seed))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    xz = (_rand(device, batch, length, d_inner // 2, seed=seed) @ p["in_proj_w"]).to(dtype)
    return kfm.kernel_inputs(xz, p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"],
                             p["dt_proj_b"], -torch.exp(p["A_log"]), p["D"], dt_rank=dt_rank,
                             d_state=d_state)


def _hold_fused(name: str, args, y_states, h, g) -> tuple[float, float]:
    """K10 (lean and with states) and K11 at ``args`` against the plain
    versions: y and h_entries within 1e-5 of max, gradients 1e-4 (bf16 one
    ulp at a floor of 2e-2); K10's two forwards' y equal, K11 twice bitwise
    equal. Returns (K10's, K11's max |diff|)."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    y = kfm.fused_mixer_fwd(*args)
    if not torch.equal(y_states, y):
        raise AssertionError(f"any-shape K10 with states at {name}: y differs")
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    e10 = max(_hold(f"K10 any {name}", y, y_ref, 1e-5, floor=2e-2),
              _hold(f"K10 any {name} h", h, h_ref, 1e-5))
    got = kfm.fused_mixer_bwd(*args, h, g)
    if not all(torch.equal(p, q) for p, q in zip(got, kfm.fused_mixer_bwd(*args, h, g))):
        raise AssertionError(f"two any-shape K11 runs at {name} differ")
    e11 = max(_hold(f"K11 any {name} {i}", a, r, 1e-4, floor=2e-2)
              for i, (a, r) in enumerate(zip(
                  got, kfm.fused_mixer_bwd_ref(*args, h, g, chunk=kfm.CHUNK))))
    return e10, e11


def fused_any_phase(device) -> dict:
    """K10/K11's any-shape variants: held alone at FUSED_SHAPES (d_inner 1152,
    1536, 2048, 2560; d_state 8 and 32; conv widths 2 and 3) at FUSED_HOLD,
    fp32 and bf16 (fp32 y and h_entries within 1e-5 of max, gradients 1e-4;
    bf16 y and dxz one ulp at a floor of 2e-2, fp32 outputs 1e-4), K11 twice,
    bitwise equal; then at the trans_dim-768 path's shape (d_inner 1536,
    dt_rank 48, B=32, L=512) held the same way against the plain versions
    and timed beside them. Returns {record name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        held = {}
        for shape in FUSED_SHAPES:
            args = _fused_args(device, *shape, FUSED_HOLD["batch"], FUSED_HOLD["length"], dtype,
                               seed=shape[0] + shape[1])
            y2, h = kfm.fused_mixer_fwd_states(*args)
            e10, e11 = _hold_fused(f"{shape}{sfx}", args, y2, h,
                                   _rand(device, *y2.shape, seed=7, dtype=dtype))
            held[str(shape)] = dict(k10=e10, k11=e11)
        args = _fused_args(device, 1536, 16, 4, 48, 32, 512, dtype, seed=15)
        work = fused_work(args)
        y, h = kfm.fused_mixer_fwd_states(*args)
        g = _rand(device, *y.shape, seed=8, dtype=dtype)
        e10, e11 = _hold_fused(f"path (1536, 16, 4, 48){sfx}", args, y, h, g)
        path = dict(k10=e10, k11=e11)
        for name, fn, plain, (nbytes, ops), key in (
                ("fused_mixer_fwd_any", lambda: kfm.fused_mixer_fwd(*args),
                 lambda: kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK),
                 (work["fwd_bytes"], work["fwd_ops"]), "k10"),
                ("fused_mixer_fwd_states_any", lambda: kfm.fused_mixer_fwd_states(*args),
                 lambda: kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True),
                 (work["fwd_bytes"] + work["hent_bytes"], work["fwd_ops"]), "k10"),
                ("fused_mixer_bwd_any", lambda: kfm.fused_mixer_bwd(*args, h, g),
                 lambda: kfm.fused_mixer_bwd_ref(*args, h, g, chunk=kfm.CHUNK),
                 (work["bwd_bytes"], work["bwd_ops"]), "k11")):
            bd = bound(nbytes, ops)
            out[name + sfx] = dict(
                shape=[32, 512, 1536], d_state=16, dt_rank=48, bound_ms=bd[0], bound_by=bd[1],
                max_abs_err=path[key], library_ms=None, held_shapes=held,
                **_timed(fn, plain, 5))
    log("any-shape fused mixer: " + "; ".join(
        f"{k} {v['ms']:.3f} ms (device {v['device_ms']:.3f}, bound {v['bound_ms']:.4f}, plain "
        f"{v['plain_ms']:.1f})" for k, v in out.items()))
    return out


SSD_ENTRIES = {  # record name: (split, forward, states, h_fin / seeded)
    "ssd_xbc_fwd": (False, True, False, False), "ssd_xbc_fwd_states": (False, True, True, False),
    "ssd_xbc_fwd_hfin": (False, True, False, True),
    "ssd_xbc_fwd_states_hfin": (False, True, True, True),
    "ssd_xbc_bwd": (False, False, None, False), "ssd_xbc_bwd_seeded": (False, False, None, True),
    "ssd_split_fwd": (True, True, False, False), "ssd_split_fwd_states": (True, True, True, False),
    "ssd_split_fwd_hfin": (True, True, False, True),
    "ssd_split_fwd_states_hfin": (True, True, True, True),
    "ssd_split_bwd": (True, False, None, False),
    "ssd_split_bwd_seeded": (True, False, None, True)}


def _ssd_inputs(device, B, L, h, chunk, dtype, seed, n=128, p=128):
    d = h * p
    xbc = _rand(device, B, L, d + 2 * n, scale=0.5, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    dth = torch.from_numpy(rng.uniform(0.0, 0.05, (B, h, L // chunk, chunk))
                           .astype(np.float32)).to(device)
    A = -torch.from_numpy(rng.uniform(0.1, 1.0, h).astype(np.float32)).to(device)
    S = torch.cumsum(dth * A[None, :, None, None], -1).contiguous()
    return (xbc, dth, S, _rand(device, h, seed=seed + 1), _rand(device, B, L, d, seed=seed + 2,
                                                               dtype=dtype),
            _rand(device, B, h, n, p, seed=seed + 3), d)


def _ssd_calls(xbc, dth, S, D, dy, dhf, d, chunk):
    """{entry name: (kernel call, plain call, the plain outputs' picker)} of
    every K8/K9 and K6/K7 entry point on these operands (K9/K7 from the
    states of K8/K6 with states). Each plain call computes what its entry
    point computes; the picker takes the entry point's outputs from the
    family's one plain call with every output (``_plain_families``)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    n = (xbc.shape[-1] - d) // 2
    x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
    h_in = kssd.ssd_xbc_fwd_states(xbc, dth, S, D, d, chunk)[1]
    hs = kssd.ssd_split_fwd_states(x, dth, S, Bm, Cm, chunk)[1]
    calls = {}
    for name, (split, fwd, states, flag) in SSD_ENTRIES.items():
        fn = getattr(kssd, name)
        if fwd and not split:
            plain = functools.partial(kssd.ssd_xbc_fwd_ref, xbc, dth, S, D, d, chunk,
                                      emit_states=states, emit_hfin=flag)
            call = functools.partial(fn, xbc, dth, S, D, d, chunk)
        elif fwd:
            plain = functools.partial(kssd.ssd_split_fwd_ref, x, dth, S, Bm, Cm, chunk,
                                      emit_states=states, emit_hfin=flag)
            call = functools.partial(fn, x, dth, S, Bm, Cm, chunk)
        elif not split:
            plain = functools.partial(kssd.ssd_xbc_bwd_ref, xbc, dth, S, D, h_in, dy, d, chunk,
                                      dh_fin=dhf if flag else None)
            call = (functools.partial(fn, xbc, dth, S, D, h_in, dy, dhf, d, chunk) if flag
                    else functools.partial(fn, xbc, dth, S, D, h_in, dy, d, chunk))
        else:
            plain = functools.partial(kssd.ssd_split_bwd_ref, x, dth, S, Bm, Cm, hs, dy, chunk,
                                      dh_fin=dhf if flag else None)
            call = (functools.partial(fn, x, dth, S, Bm, Cm, hs, dy, dhf, chunk) if flag
                    else functools.partial(fn, x, dth, S, Bm, Cm, hs, dy, chunk))
        pick = ((lambda out, st=states, hf=flag: [out[0]] + [out[1]] * st + [out[2]] * hf)
                if fwd else (lambda out: list(out)))
        calls[name] = (call, plain, pick)
    return calls, _ssd_families(xbc, dth, S, D, dy, dhf, d, chunk, h_in, hs)


def _ssd_families(xbc, dth, S, D, dy, dhf, d, chunk, h_in, hs) -> dict:
    """The plain calls with every output of each entry-point family: K8, K6
    (with states and h_fin), K9 and K7 from 0 and seeded."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    n = (xbc.shape[-1] - d) // 2
    x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
    xbc_b = (xbc, dth, S, D, h_in, dy, d, chunk)
    split_b = (x, dth, S, Bm, Cm, hs, dy, chunk)
    return {"xbc_fwd": functools.partial(kssd.ssd_xbc_fwd_ref, xbc, dth, S, D, d, chunk,
                                         emit_states=True, emit_hfin=True),
            "split_fwd": functools.partial(kssd.ssd_split_fwd_ref, x, dth, S, Bm, Cm, chunk,
                                           emit_states=True, emit_hfin=True),
            "ssd_xbc_bwd": functools.partial(kssd.ssd_xbc_bwd_ref, *xbc_b),
            "ssd_xbc_bwd_seeded": functools.partial(kssd.ssd_xbc_bwd_ref, *xbc_b, dh_fin=dhf),
            "ssd_split_bwd": functools.partial(kssd.ssd_split_bwd_ref, *split_b),
            "ssd_split_bwd_seeded": functools.partial(kssd.ssd_split_bwd_ref, *split_b,
                                                      dh_fin=dhf)}


def _family(name: str) -> str:
    split, fwd = SSD_ENTRIES[name][:2]
    return ("split_fwd" if split else "xbc_fwd") if fwd else name


def _hold_ssd(name: str, got, want, truth=None) -> float:
    """Every output of an SSD entry point against the plain version's: at
    fp32 (3xTF32 products) within 1e-4 of each output's max; at bf16 the fp32
    outputs (states, ddt, dS, dD) within 1e-3 of their max and the bf16 ones
    (y, dx, dB, dC) against ``truth``, the plain version in float64 on the
    same bf16 inputs (``_hold_bf16_truth``, as phase 30: no further from it
    than the plain version; with 64 chunks of 8 the carried states' bf16
    operands flip at rounding boundaries, 2.5 bf16 ulps at the 2e-2 floor
    apart at single elements). Returns max |diff| from the plain version."""
    got = got if isinstance(got, tuple) else (got,)
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, the plain version {len(want)}")
    err = 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        if a.dtype == torch.bfloat16:
            e = _hold_bf16_truth(f"{name} {i}", a, w, truth[i])["max_abs_err"]
        elif truth is not None:
            e = _hold_bf16(f"{name} {i}", a, w)
        else:
            e = _hold(f"{name} {i}", a, w, 1e-4)
        err = max(err, e)
    return err


def _hold_ssd_entries(ops, chunk: int, where: str) -> tuple[dict, dict]:
    """Every K8/K9 and K6/K7 entry point on ``ops`` (``_ssd_inputs``) against
    its plain version (``_hold_ssd``; at bf16 with the float64 truth).
    Returns (``_ssd_calls``' calls, {entry name: max |diff|})."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    calls, families = _ssd_calls(*ops, chunk)
    plain = {k: f() for k, f in families.items()}
    exact = None
    if ops[0].dtype == torch.bfloat16:  # the truth: the plain versions in float64
        d = ops[-1]
        x64 = [t.double() if torch.is_tensor(t) else t for t in ops]
        xbc64 = x64[0]
        n = (xbc64.shape[-1] - d) // 2
        h64 = kssd.ssd_xbc_fwd_ref(*x64[:4], d, chunk, emit_states=True)[1]
        hs64 = kssd.ssd_split_fwd_ref(xbc64[..., :d], *x64[1:3], xbc64[..., d:d + n],
                                      xbc64[..., d + n:], chunk, emit_states=True)[1]
        exact = {k: f() for k, f in _ssd_families(*x64, chunk, h64, hs64).items()}
    errs = {}
    for name, (call, _, pick) in calls.items():
        fam = _family(name)
        errs[name] = _hold_ssd(f"{name} {where}", call(), pick(plain[fam]),
                               None if exact is None else pick(exact[fam]))
    return calls, errs


def ssd_any_phase(device) -> dict:
    """Every K8/K9 and K6/K7 entry point at chunks SSD_CHUNKS (8, 32, 96 with L
    = 512 padded to 576 as the mixer pads, 512, and 1024 at L = 1024: one
    chunk), B=SSD_HOLD_BATCH, SSD_HOLD_HEADS heads of 128, d_state 128, fp32
    and bf16, each against its plain version (``_hold_ssd``); the '_strip'
    (32) and '_long' (512) variants of each entry point then timed, beside
    the plain versions, with ``bound_ms`` from the work the chunk needs (the
    strip layout's added rows are the kernel's cost, not the function's).
    Timed at B=SSD_CORE_BATCH, 6 heads of 128, L=512, the classifier's and the
    core paths' width, where every entry point is first held the same way.
    Returns {record name: figures}."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    held = {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        for chunk in SSD_CHUNKS:
            L = 1024 if chunk == 1024 else 512
            Lp = L + (-L) % chunk
            ops = _ssd_inputs(device, SSD_HOLD_BATCH, Lp, SSD_HOLD_HEADS, chunk, dtype,
                              seed=chunk)
            for name, err in _hold_ssd_entries(ops, chunk, f"chunk {chunk}{sfx}")[1].items():
                held.setdefault(name + sfx, {})[str(chunk)] = err
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        for chunk in (32, 512):
            variant = kssd.chunk_variant(chunk)
            B = SSD_CORE_BATCH
            ops = _ssd_inputs(device, B, 512, 6, chunk, dtype, seed=chunk + 1)
            calls, errs = _hold_ssd_entries(ops, chunk, f"6 heads chunk {chunk}{sfx}")
            for name in SSD_ENTRIES:
                call, plain, _ = calls[name]
                split, fwd, states, flag = SSD_ENTRIES[name]
                work_f, work_b = _ssd_bf16_work(B, 512, 6, chunk, d_skip=not split,
                                                elem=2 if sfx else 4)
                nbytes, bf, tf = work_f[(bool(states), flag)] if fwd else work_b[flag]
                bd = bf16_tc_bound(nbytes, bf, tf) if sfx else tc_bound(nbytes, bf + tf)
                out[kssd._variant_name(name + sfx, variant)] = dict(
                    shape=[B, 512, 6 * 128], chunk=chunk, max_abs_err=errs[name],
                    held_chunks=held[name + sfx], library_ms=None, **bd,
                    **_timed(call, plain, 5))
    log("SSD entry points at every chunk: " + "; ".join(
        f"{k} {v['ms']:.3f} ms (device {v['device_ms']:.3f}, bound {v['bound_ms']:.4f}, plain "
        f"{v['plain_ms']:.1f})" for k, v in out.items()))
    return out


def _stack_run(stack, inp, keep: list | None = None):
    """Each block's output added to its input; with ``keep`` each block's
    input is appended to it, its gradient retained."""
    for blk in stack:
        if keep is not None:
            if not inp.is_leaf:
                inp.retain_grad()
            keep.append(inp)
        inp = inp + blk(inp)
    return inp


def stack_phase(device, name: str, kernel, plain, dtype: torch.dtype, want: dict, *,
                batch: int, seed: int, params: bool = True, own_rule=None) -> tuple[dict, dict]:
    """A stack of mixer blocks ``kernel`` (d_model 384; each block's output
    added to its input) in ``dtype`` against ``plain``, the same blocks with
    the same weights on the plain route. The path, counted from 0 after a
    warm-up at its own batch: a no-grad forward and a forward and backward at
    B=``batch``, L=512. Its launches must be ``want`` (every other count 0),
    and the no-grad output the training one. Then at B=4 (the plain route's
    autograd keeps every step's state) the forward and one backward against
    ``plain`` on the same card: the output within 1e-3 of its max at fp32
    (PERF_LOGITS_TOL at bf16), the input's gradient and, with ``params``,
    every parameter's within 1e-3 (PERF_LOGITS_TOL) of its largest.
    ``own_rule(kernel, plain, leaves, inputs, g, tol)`` may hold leaves by a
    rule of its own: it gets every leaf as (name, the kernel route's, the
    plain route's), each block's input on the kernel stack (gradients
    retained), the output's gradient and the tolerance, and returns {leaf
    name: figures} of the leaves it held. Returns (launches, the record)."""
    tol = 1e-3 if dtype == torch.float32 else PERF_LOGITS_TOL
    x = _rand(device, batch, 512, 384, seed=seed, dtype=dtype)
    g = _rand(device, batch, 512, 384, seed=seed + 1, dtype=dtype)
    _stack_run(kernel, x.detach().requires_grad_()).backward(g)  # warm-up, not counted
    kernel.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the path: a no-grad forward, then a forward and backward
    t0 = time.perf_counter()
    with torch.no_grad():
        y_eval = _stack_run(kernel, x)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    y = _stack_run(kernel, x.detach().requires_grad_())
    y.backward(g)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"{name}: the stack launched "
                             f"{ {k: v for k, v in launches.items() if v} }; expected {want}")
    if not torch.equal(y_eval, y.detach()):
        raise AssertionError(f"{name}: the no-grad forward differs from the training forward")
    kernel.zero_grad(set_to_none=True)

    xk, xp = (x[:4].detach().requires_grad_() for _ in range(2))
    inputs = []
    y, y_ref = _stack_run(kernel, xk, inputs), _stack_run(plain, xp)
    y.backward(g[:4])
    y_ref.backward(g[:4])
    leaves = [("y", y.detach(), y_ref.detach()), ("x", xk.grad, xp.grad)]
    if params:
        leaves += [(pname, prm.grad, q.grad) for (pname, prm), q in
                   zip(kernel.named_parameters(), plain.parameters())]
    held = {} if own_rule is None else own_rule(kernel, plain, leaves, inputs, g[:4], tol)
    errs = {}
    for pname, got, ref in leaves:
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: {pname} is not finite")
        errs[pname] = _rel_err(got.float(), ref.float())[1]
        if pname not in held and errs[pname] > tol:
            raise AssertionError(f"{name}: {pname} {errs[pname]:.3e} of its max from the plain "
                                 f"route")
    rel = errs.pop("y")
    record = dict(depth=len(kernel), d_model=384, dtype=str(dtype).removeprefix("torch."),
                  batch=batch, length=512, forward_err_of_max=rel,
                  worst_grad_err_of_max=max(v for k, v in errs.items() if k not in held),
                  held_batch=4, held_by_own_rule=held, eval_ms=eval_ms, step_ms=step_ms,
                  max_memory_allocated_bytes=peak,
                  launches={k: v for k, v in launches.items() if v})
    log(f"{name}: {len(kernel)} blocks ({record['dtype']}) at B={batch}: no-grad forward "
        f"{eval_ms:.1f} ms, forward + backward {step_ms:.1f} ms, peak {peak / 2**30:.3f} GiB; at "
        f"B=4 against the plain route: forward {rel:.3e}, gradients "
        f"{record['worst_grad_err_of_max']:.3e} of max; launches {record['launches']}")
    return launches, record


def mixer_stack_phase(device, name: str, d_state: int, d_conv: int,
                      dtype: torch.dtype) -> tuple[dict, dict]:
    """``stack_phase`` on 12 ``MambaMixer`` blocks (d_model 384, ``d_state``,
    ``d_conv``) on the kernel route (``impl='auto'``: the any-width K1 and
    the any-state K2 without a gradient; K1 and K3 forward, K4 and K5
    backward with one) at B=32, against the plain route ('seq' scan, plain
    conv). Returns ({name: launches}, the record)."""
    from si_mamba_tpu_torch.models.layers import MambaMixer

    depth = 12
    blocks = [MambaMixer(384, d_state=d_state, d_conv=d_conv) for _ in range(depth)]
    for i, blk in enumerate(blocks):
        blk.reset_parameters(torch.Generator().manual_seed(200 + i))
    kernel = torch.nn.ModuleList(blocks).to(device)
    plain = torch.nn.ModuleList(MambaMixer(384, d_state=d_state, d_conv=d_conv, scan_impl="seq")
                                for _ in range(depth)).to(device)
    plain.load_state_dict(kernel.state_dict())
    sfx = _dtype_sfx(dtype)
    want = {k + sfx: depth for k in ("selective_scan_fwd_any", "selective_scan_fwd_residuals_any",
                                     "selective_scan_bwd_any", "causal_conv1d_silu_bwd_any")}
    want["causal_conv1d_silu_any" + sfx] = 2 * depth
    launches, record = stack_phase(device, name, kernel, plain, dtype, want, batch=32,
                                   seed=d_state)
    return {name: launches}, dict(record, d_state=d_state, d_conv=d_conv)


def ssd_core_path(device, name: str, chunk: int, dtype: torch.dtype) -> tuple[dict, dict]:
    """The paths that reach every SSD entry point at ``chunk`` (the
    classifier reaches only K8 lean, K8 with states and K9): the counterparts
    of ``ssd_chunked_pallas_xbc`` and ``ssd_chunked_pallas``
    (``ssd_chunked_xbc``, ``ssd_chunked_split``), each without a gradient,
    with one, and with ``return_carry`` without and with one, at
    B=SSD_CORE_BATCH, L=512, 6 heads, in ``dtype``; each entry point launched
    once and nothing else; y equal to the lean kernel's. Returns ({name:
    launches}, the record)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    xbc, dth, S, D, dy, dhf, d = _ssd_inputs(device, SSD_CORE_BATCH, 512, 6, chunk, dtype,
                                              seed=chunk + 2)
    dt = dth.reshape(SSD_CORE_BATCH, 6, 512).transpose(1, 2).contiguous()
    A = -torch.linspace(0.2, 1.0, 6, device=device)
    x = xbc[..., :d].reshape(SSD_CORE_BATCH, 512, 6, 128)
    Bm, Cm = xbc[..., d:d + 128], xbc[..., d + 128:]
    _reset_launch_counts()  # the path: the two cores' four calls each
    ys = []
    with torch.no_grad():
        ys.append(kssd.ssd_chunked_xbc(xbc, dt, A, D, d_inner=d, chunk=chunk))
        ys.append(kssd.ssd_chunked_xbc(xbc, dt, A, D, d_inner=d, chunk=chunk,
                                       return_carry=True)[0])
        kssd.ssd_chunked_split(x, dt, A, Bm, Cm, D, chunk=chunk)
        kssd.ssd_chunked_split(x, dt, A, Bm, Cm, D, chunk=chunk, return_carry=True)
    leaves = [t.detach().requires_grad_() for t in (xbc, dt)]
    y = kssd.ssd_chunked_xbc(leaves[0], leaves[1], A, D, d_inner=d, chunk=chunk)
    y.backward(dy)
    ys.append(y.detach())
    y, _, h_fin = kssd.ssd_chunked_xbc(leaves[0], leaves[1], A, D, d_inner=d, chunk=chunk,
                                       return_carry=True)
    torch.autograd.backward((y, h_fin), (dy, dhf))
    xl = x.detach().requires_grad_()
    y = kssd.ssd_chunked_split(xl, dt, A, Bm, Cm, D, chunk=chunk)
    y.backward(dy.reshape(y.shape))
    y, _, h_fin = kssd.ssd_chunked_split(xl, dt, A, Bm, Cm, D, chunk=chunk, return_carry=True)
    torch.autograd.backward((y, h_fin), (dy.reshape(y.shape), dhf))
    torch.cuda.synchronize()
    launches = _launch_counts()
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    variant = kssd.chunk_variant(chunk)
    want = {k: 0 for k in launches}
    for entry in SSD_ENTRIES:
        want[kssd._variant_name(entry + sfx, variant)] = 1
    if launches != want:
        raise AssertionError(f"{name}: the SSD cores launched {launches}; expected {want}")
    if not all(torch.equal(ys[0], t) for t in ys[1:]):
        raise AssertionError(f"{name}: the entry points' y differ")
    log(f"{name}: chunk {chunk} ({variant}), {dtype}: every SSD entry point once")
    return {name: launches}, {"chunk": chunk, "variant": variant,
                              "launches": {k: v for k, v in launches.items() if v}}


def ssd_classifier_phase(device, card: str, chunk: int) -> tuple[dict, dict]:
    """The SSD classifier (cfgs/finetune_modelnet_ssd_fused.yaml's model at
    fp32 with exact ``eigh``) at ``ssd_chunk`` ``chunk``: requests of 1, 20
    and 64 clouds through ``Predictor`` (phase 5's checks against 'xla'), then
    the preset through the CLI with ``ssd_chunk``, ``dtype: float32`` and
    ``spectral_method: eigh`` set over it, SLICE21_EPOCHS epochs of two steps. Returns
    (each path's launches, the record)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    variant = kssd.chunk_variant(chunk)
    p, serving, model, _ = serving_phase(
        device, dict(MODELNET40_SSD, ssd_chunk=chunk), plain_impl="xla",
        kernels=("causal_conv1d_silu", "ssd_xbc_fwd" + variant))
    del model
    paths = {f"ssd{chunk}_serving": p}
    p, cli_rec = preset_cli_phase(
        device, card, "finetune_modelnet_ssd_fused.yaml", f"ssd{chunk}_train",
        ("causal_conv1d_silu", "ssd_xbc_fwd_states" + variant, "ssd_xbc_bwd" + variant,
         "causal_conv1d_silu_bwd"), ("causal_conv1d_silu", "ssd_xbc_fwd" + variant),
        {"mixer": "ssd", "ssd_chunk": chunk, "dtype": "float32"},
        override={"ssd_chunk": chunk, "dtype": "float32", "spectral_method": "eigh"},
        epochs=SLICE21_EPOCHS)
    paths.update(p)
    return paths, {"serving": serving, "cli": cli_rec}


def fused768_phase(device, card: str, dtype: str) -> tuple[dict, dict]:
    """The ModelNet40 classifier with ``scan_impl: fused`` at ``trans_dim``
    768 (d_inner 1536, dt_rank 48, 80 x_dbl columns: the any-shape K10/K11) in
    ``dtype``: requests of 1, 20 and 64 clouds through ``Predictor`` against
    'seq' (1e-3 of max at fp32, PERF_LOGITS_TOL at bf16), then
    cfgs/finetune_modelnet.yaml with those keys set over it through the CLI,
    SLICE21_EPOCHS epochs of two steps at B=32. Returns (each path's launches, the record)."""
    sfx = "_bf16" if dtype == "bfloat16" else ""
    p, serving, model, _ = serving_phase(
        device, dict(MODELNET40_768_FUSED, dtype=dtype), plain_impl="seq",
        kernels=("fused_mixer_fwd_any" + sfx,), tol=PERF_LOGITS_TOL if sfx else 1e-3)
    del model
    paths = {"fused768_serving" + sfx: p}
    p, cli_rec = preset_cli_phase(
        device, card, "finetune_modelnet.yaml", "fused768_train" + sfx,
        ("fused_mixer_fwd_states_any" + sfx, "fused_mixer_bwd_any" + sfx),
        ("fused_mixer_fwd_any" + sfx,), {"scan_impl": "fused", "trans_dim": 768, "dtype": dtype},
        override={"scan_impl": "fused", "trans_dim": 768, "encoder_dims": 768, "dtype": dtype},
        width=768, epochs=SLICE21_EPOCHS)
    paths.update(p)
    return paths, {"serving": serving, "cli": cli_rec}


SLICE21_SEG = (  # preset, path name, train kernels, eval kernels: at bf16
    ("part_segmentation.yaml", "seg_bf16_cli", PERF_TRAIN_KERNELS, PERF_EVAL_KERNELS),
    ("part_segmentation_ssd_fused.yaml", "seg_ssd_bf16_cli", SSD_PERF_TRAIN_KERNELS,
     SSD_PERF_EVAL_KERNELS))


def slice21_phases(device, card: str) -> tuple[dict, dict, dict]:
    """Phases 51-56 (after phase 50): the kernels at the shapes their Pallas
    kernels compile for (51-54: conv, scan, whole mixer, SSD), then the paths
    that reach them (55: the 12-block MambaMixer stacks and the SSD core
    paths; 56: the SSD classifier at chunks 32 and 512, the fused classifier
    at trans_dim 768, both seg presets at bf16 through the CLI). Returns (the
    new kernel records' measured figures by name, each path's launches, the
    record)."""
    figures = {**conv_any_phase(device), **scan_any_phase(device), **fused_any_phase(device),
               **ssd_any_phase(device)}
    paths, record = {}, {}
    for name, kw in STACKS.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = name + ("_bf16" if dtype == torch.bfloat16 else "")
            p, record[key] = mixer_stack_phase(device, key, **kw, dtype=dtype)
            paths.update(p)
    for chunk in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"ssd_core_chunk{chunk}" + ("_bf16" if dtype == torch.bfloat16 else "")
            p, record[key] = ssd_core_path(device, key, chunk, dtype)
            paths.update(p)
    for chunk in (32, 512):
        p, record[f"ssd_chunk{chunk}"] = ssd_classifier_phase(device, card, chunk)
        paths.update(p)
    for dtype in ("float32", "bfloat16"):
        p, record["fused768" + ("_bf16" if dtype == "bfloat16" else "")] = fused768_phase(
            device, card, dtype)
        paths.update(p)
    for preset, name, train_k, eval_k in SLICE21_SEG:
        p, record[name] = partseg_cli_phase(device, card, preset, name, train_k, eval_k,
                                            dtype="bfloat16")
        paths.update(p)
    return figures, paths, record


def slice21_records(figures: dict) -> list[dict]:
    """The kernel records of the any-shape variants: each figure set with its
    route, source, the TPU kernel it replaces and the path it serves."""
    replaces = "si_mamba_tpu/ops/pallas/"
    base = {"causal_conv1d_silu_any": (ANY_SOURCE, replaces + "causal_conv_kernel.py:52"),
            "causal_conv1d_silu_bwd_any": (ANY_SOURCE, replaces + "causal_conv_kernel.py:58"),
            "selective_scan_fwd_any": (ANY_SOURCE, replaces + "selective_scan_kernel.py:115"),
            "selective_scan_fwd_residuals_any": (ANY_SOURCE,
                                                 replaces + "selective_scan_kernel.py:407"),
            "selective_scan_bwd_any": (ANY_SOURCE, replaces + "selective_scan_kernel.py:211"),
            "fused_mixer_fwd_any": (ANY_SOURCE, replaces + "fused_mixer_kernel.py:243"),
            "fused_mixer_fwd_states_any": (ANY_SOURCE, replaces + "fused_mixer_kernel.py:243"),
            "fused_mixer_bwd_any": (ANY_SOURCE, replaces + "fused_mixer_kernel.py:292")}
    ssd_src = {True: "si_mamba_tpu_torch/csrc/ssd_xbc_fwd.cu",
               False: "si_mamba_tpu_torch/csrc/ssd_xbc_bwd.cu"}
    ssd_at = {(False, True): "602", (False, False): "698", (True, True): "189",
              (True, False): "388"}
    records = []
    for name, fig in figures.items():
        stem = name.removesuffix("_bf16")
        dtype = "bfloat16" if name.endswith("_bf16") else "float32"
        if stem in base:
            source, rep = base[stem]
        else:
            entry = stem.removesuffix("_strip").removesuffix("_long")
            split, fwd = SSD_ENTRIES[entry][:2]
            source, rep = ssd_src[fwd], replaces + "ssd_kernel.py:" + ssd_at[(split, fwd)]
        records.append(dict(name=name, route="cuda", source=source, replaces=rep, dtype=dtype,
                            **fig))
    return records


def slice21_main_path(name: str) -> str:
    """The path each any-shape variant serves."""
    sfx = "_bf16" if name.endswith("_bf16") else ""
    stem = name.removesuffix("_bf16")
    if stem.startswith(("causal_conv1d", "selective_scan")):
        return "stack_n8_w3" + sfx
    if stem.startswith("fused_mixer"):
        return ("fused768_serving" if stem == "fused_mixer_fwd_any" else "fused768_train") + sfx
    chunk = 32 if stem.endswith("_strip") else 512
    entry = stem.removesuffix("_strip").removesuffix("_long")
    if not sfx and entry in ("ssd_xbc_fwd", "ssd_xbc_fwd_states", "ssd_xbc_bwd"):
        return f"ssd{chunk}_serving" if entry == "ssd_xbc_fwd" else f"ssd{chunk}_train"
    return f"ssd_core_chunk{chunk}" + sfx


# ---------------------------------------------------------------------------
# phases 57-58: K6-K9 at wide states, the paths over them, the train-step
# profiler
# ---------------------------------------------------------------------------

# (d_state, head_dim): heads at d_model 384 (d_inner 768), the shapes JAX's
# SSD kernels compile for beyond 128
WIDE_GEOMETRIES = {(256, 256): 3, (256, 128): 6, (128, 256): 3, (384, 384): 2}
WIDE_HOLD_BATCH = 8
WIDE_CHUNK = 256
WIDE_CHUNKS = (32, 256, 512)  # held at (256, 256) and B=32 too
WIDE_DEPTH = 12
WIDE_CORE_BATCH = 8  # the carry, TP and SP paths
WIDE_BATCH = 32  # the stacks' batch, and the held chunks'
WIDE_SP_CHUNK = 128  # the SP path's chunk (256 rows a rank)
WIDE_BF16_SPREAD = 1.25  # how much further from fp32 a bf16 stack leaf may lie than plain's
WIDE_PER_HEAD = ("A_log", "D", "dt_bias")  # an SSDMixer's per-head scalars
WIDE_HEAD_TOL = 2 * PERF_LOGITS_TOL  # a bf16 per-head gradient's distance from its truth
WIDE_CONTROL = (5, "dt_bias", 1.05, 1.5)  # planted faults: block, leaf, fp32 and bf16 factors
# each path's wide entry points, and the operands (B, L, heads, n, p, chunk)
# they meet there, a rank's on the TP and SP paths: each record is timed on them
WIDE_PATHS = {
    "wide_stack_n256_p256": (("ssd_xbc_fwd", "ssd_xbc_fwd_states", "ssd_xbc_bwd"),
                             (WIDE_BATCH, 512, 3, 256, 256, WIDE_CHUNK)),
    "wide_carry": (("ssd_xbc_fwd_hfin", "ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd_seeded"),
                   (WIDE_CORE_BATCH, 512, 3, 256, 256, WIDE_CHUNK)),
    "wide_tp": (("ssd_split_fwd", "ssd_split_fwd_states", "ssd_split_bwd"),
                (WIDE_CORE_BATCH, 512, 3, 256, 128, WIDE_CHUNK)),
    "wide_sp": (("ssd_split_fwd_hfin", "ssd_split_fwd_states_hfin", "ssd_split_bwd_seeded"),
                (WIDE_CORE_BATCH, 512 // 2, 3, 256, 256, WIDE_SP_CHUNK))}


def _dtype_sfx(dtype) -> str:
    return "_bf16" if dtype == torch.bfloat16 else ""


def _wide_count(entry: str, dtype, chunk: int = WIDE_CHUNK) -> str:
    """The launch count name of ``entry`` at a wide state and ``chunk``."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    return kssd._variant_name(entry + _dtype_sfx(dtype), kssd.kernel_variant(chunk, 256, 256))


def _hold_wide(ops, chunk: int, where: str) -> tuple[dict, dict]:
    """Every entry point on ``ops`` against its plain version
    (``_hold_ssd_entries``), then each backward run twice: bitwise equal."""
    calls, errs = _hold_ssd_entries(ops, chunk, where)
    for name, (split, fwd, _, _) in SSD_ENTRIES.items():
        if not fwd:
            a, b = calls[name][0](), calls[name][0]()
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name} {where}: two runs differ")
    return calls, errs


def wide_kernel_phase(device) -> dict:
    """Phase 57's kernels: every K8/K9 and K6/K7 entry point at the four wide
    geometries (WIDE_GEOMETRIES: B=WIDE_HOLD_BATCH, L=512, chunk 256) and at
    (256, 256) with 3 heads at B=32 and chunks 32, 256 and 512, fp32 and
    bf16, each against its plain version (``_hold_ssd``), every backward run
    twice, bitwise equal (a planted fault, K9's ddt scaled by 1.05, must fail
    the hold); then each path's entry points held and timed on
    the operands they meet on their path (WIDE_PATHS) beside their plain
    versions and their bounds (``_ssd_bf16_work``). Returns {record name:
    figures}."""
    held, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = _dtype_sfx(dtype)
        for (n, p), h in WIDE_GEOMETRIES.items():
            ops = _ssd_inputs(device, WIDE_HOLD_BATCH, 512, h, WIDE_CHUNK, dtype, seed=n + p,
                              n=n, p=p)
            for name, err in _hold_wide(ops, WIDE_CHUNK, f"n{n} p{p}{sfx}")[1].items():
                held.setdefault(name + sfx, {})[f"n{n}_p{p}_b{WIDE_HOLD_BATCH}"] = err
        on = {}  # operands -> (calls, errors)
        for chunk in WIDE_CHUNKS:
            geo = (WIDE_BATCH, 512, 3, 256, 256, chunk)
            ops = _ssd_inputs(device, *geo[:3], chunk, dtype, seed=chunk + 5, n=256, p=256)
            on[geo] = _hold_wide(ops, chunk, f"n256 p256 B={WIDE_BATCH} chunk {chunk}{sfx}")
            for name, err in on[geo][1].items():
                held[name + sfx][f"n256_p256_b{WIDE_BATCH}_chunk{chunk}"] = err
        call, plain, _ = on[(WIDE_BATCH, 512, 3, 256, 256, WIDE_CHUNK)][0]["ssd_xbc_bwd"]
        try:  # a planted fault: K9's ddt scaled by 1.05 must fail its hold
            _hold_bf16("K9's ddt scaled by 1.05", call()[1] * 1.05, plain()[1])
        except AssertionError:
            pass
        else:
            raise AssertionError(f"the K9{sfx} hold passes a planted fault in ddt")
        for path, (entries, geo) in WIDE_PATHS.items():
            B, L, h, n, p, chunk = geo
            if geo not in on:
                ops = _ssd_inputs(device, B, L, h, chunk, dtype, seed=L + p + chunk, n=n, p=p)
                on[geo] = _hold_wide(ops, chunk, f"{path} operands{sfx}")
            calls, errs = on[geo]
            for name in entries:
                held[name + sfx][path] = errs[name]
                split, fwd, states, flag = SSD_ENTRIES[name]
                work_f, work_b = _ssd_bf16_work(B, L, h, chunk, n=n, hp=p, d_skip=not split,
                                                elem=2 if sfx else 4)
                nbytes, bf, tf = work_f[(bool(states), flag)] if fwd else work_b[flag]
                bd = bf16_tc_bound(nbytes, bf, tf) if sfx else tc_bound(nbytes, bf + tf)
                out[_wide_count(name, dtype, chunk)] = dict(
                    entry=name, path=path + sfx, shape=[B, L, h * p], d_state=n, head_dim=p, chunk=chunk,
                    max_abs_err=errs[name], library_ms=None, held=held[name + sfx], **bd,
                    **_timed(calls[name][0], calls[name][1], 5))
    log("wide SSD entry points on their paths' operands: " + "; ".join(
        f"{k} {v['shape']} n {v['d_state']} p {v['head_dim']} chunk {v['chunk']}: {v['ms']:.3f} ms "
        f"(device {v['device_ms']:.3f}, bound {v['bound_ms']:.4f}, plain {v['plain_ms']:.1f})"
        for k, v in out.items()))
    return out


def _head_truth(blk, u, dy, rounded) -> tuple:
    """The per-head scalars' gradients of ``blk`` on its bf16 input ``u`` and
    output gradient ``dy``, in fp32 (the plain route) with the weights
    ``rounded`` to bf16 as a bf16 route reads them."""
    from si_mamba_tpu_torch.ops.ssd import ssd_mixer_apply

    prm = {k: v.detach().clone() for k, v in blk.params().items()}
    for k in rounded:
        prm[k] = prm[k].to(torch.bfloat16).float()
    for k in WIDE_PER_HEAD:
        prm[k].requires_grad_()
    out = ssd_mixer_apply(prm, u.float(), n_heads=blk.n_heads, d_state=blk.d_state,
                          chunk=blk.chunk, impl="xla")
    return torch.autograd.grad(out, [prm[k] for k in WIDE_PER_HEAD], dy.float())


def _per_head_figures(got, plain, truth, plain_truth) -> dict:
    """A per-head scalar's gradient on the kernel route beside the plain bf16
    route's, each against its truth (``_head_truth``): distances of max."""
    return dict(from_plain=_rel_err(got.double(), plain.double())[1],
                from_truth=_rel_err(got.double(), truth.double())[1],
                plain_from_truth=_rel_err(plain.double(), plain_truth.double())[1])


def _per_head_holds(fig: dict) -> bool:
    """The bf16 per-head rule: no further from the truth than twice the plain
    bf16 route, or than WIDE_HEAD_TOL."""
    return fig["from_truth"] <= max(2 * fig["plain_from_truth"], WIDE_HEAD_TOL)


def _wide_own_rule(name: str, kernel, plain, leaves, inputs, g, tol) -> dict:
    """The wide stacks' own rule (``stack_phase``'s ``own_rule``). At fp32 a
    planted fault (WIDE_CONTROL: block 5's dt_bias gradient scaled by 1.05)
    must fail the stack's tolerance. At bf16: (1) The per-head scalars'
    gradients (A_log, D, dt_bias) are held block by block, each block on its
    own inputs: the input that the kernel stack gave it and the gradient
    that reached its output there. On them the block's plain bf16 route
    gives its gradients, and the plain route at fp32 the truths: with the
    matmul weights rounded to bf16 (the kernel route's truth), and the conv
    weights too (the plain bf16 route's). The kernel route must meet
    ``_per_head_holds``. These sums pass through the gated RMSNorm's
    backward, which cancels their bulk, so both bf16 routes scatter: on an
    H100 over two weight seeds, 288 block gradients, the kernel route lay a
    median 4.9e-3 of max from its truth (9.1e-2 at most), the plain route
    5.7e-3 (1.09e-1 at most). So a 5 % fault is for the fp32 stacks and the
    kernels' own holds (ddt within 1e-3), and here a planted gross fault
    (block 5's dt_bias gradient scaled by 1.5) must fail the rule. (2) Any
    other leaf outside PERF_LOGITS_TOL of the plain route passes if it lies
    within PERF_LOGITS_TOL of the plain stack at fp32 (the same weights, the
    bf16 input's values), or no more than WIDE_BF16_SPREAD times as far from
    it as the plain bf16 stack. Returns {leaf name: figures} of every leaf
    held here."""
    block, kind, fault32, fault16 = WIDE_CONTROL
    if tol < PERF_LOGITS_TOL:
        got, want = next((a, b) for k, a, b in leaves if k == f"{block}.{kind}")
        if _rel_err(got * fault32, want)[1] <= tol:
            raise AssertionError(f"{name}: the stack's tolerance passes a planted fault")
        return {}
    held = {}
    for i, (kb, pb) in enumerate(zip(kernel, plain)):
        u = inputs[i].detach()
        dy = inputs[i + 1].grad if i + 1 < len(inputs) else g
        gp = torch.autograd.grad(pb(u), [getattr(pb, k) for k in WIDE_PER_HEAD], dy)
        tk = _head_truth(pb, u, dy, ("in_proj_w", "out_proj_w"))
        tp = _head_truth(pb, u, dy, ("in_proj_w", "out_proj_w", "conv_w", "conv_b"))
        for k, a, b, t, t_p in zip(WIDE_PER_HEAD, (getattr(kb, k).grad for k in WIDE_PER_HEAD),
                                   gp, tk, tp):
            fig = held[f"{i}.{k}"] = _per_head_figures(a, b, t, t_p)
            if not _per_head_holds(fig):
                raise AssertionError(f"{name}: block {i}'s {k} gradient on its own inputs: "
                                     f"{fig}")
            if (i, k) == (block, kind):
                fig["control"] = _per_head_figures(a * fault16, b, t, t_p)
                if _per_head_holds(fig["control"]):
                    raise AssertionError(f"{name}: the per-head rule passes a planted fault "
                                         f"{fig['control']}")
    x32 = inputs[0].detach().float().requires_grad_()
    y32 = _stack_run(plain, x32)
    truth = [y32.detach()] + list(torch.autograd.grad(y32, [x32] + list(plain.parameters()),
                                                      g.float()))
    for (pname, got, want), t in zip(leaves, truth):
        r = _rel_err(got.float(), want.float())[1]
        if pname in held or r <= PERF_LOGITS_TOL:
            continue
        ek, ep = (_rel_err(v.float(), t.float())[1] for v in (got, want))
        if ek > max(WIDE_BF16_SPREAD * ep, PERF_LOGITS_TOL):
            raise AssertionError(f"{name}: {pname} {r:.3e} of its max from the plain route; "
                                 f"from fp32 {ek:.3e}, the plain bf16 route {ep:.3e}")
        held[pname] = dict(from_plain=r, from_fp32=ek, plain_from_fp32=ep)
    heads = [v for k, v in held.items() if k.rsplit(".", 1)[-1] in WIDE_PER_HEAD]
    log(f"{name}: per-head gradients block by block, worst: from the truth "
        f"{max(v['from_truth'] for v in heads):.3e} (the plain bf16 route "
        f"{max(v['plain_from_truth'] for v in heads):.3e}), from the plain route "
        f"{max(v['from_plain'] for v in heads):.3e}; the control "
        f"{held[f'{block}.{kind}']['control']}; other leaves held against fp32: "
        f"{ {k: v for k, v in held.items() if k.rsplit('.', 1)[-1] not in WIDE_PER_HEAD} }")
    return held


def wide_stack_phase(device, name: str, n: int, p: int, dtype) -> tuple[dict, dict]:
    """``stack_phase`` on WIDE_DEPTH ``SSDMixer`` blocks (d_model 384,
    d_state ``n``, head_dim ``p``, chunk 256, ``scan_impl='ssd_fused'``) at
    B=WIDE_BATCH: K1 24 times, K5, the lean K8, K8 with states and K9 (their
    '_wide' variants) 12 times each; against the plain route
    (``scan_impl='auto'``: the plain conv and ``ssd_chunked``), at bf16 with
    ``_wide_own_rule``. Returns ({name: launches}, the record)."""
    from si_mamba_tpu_torch.models.layers import SSDMixer

    kw = dict(d_state=n, head_dim=p, chunk=WIDE_CHUNK)
    blocks = [SSDMixer(384, scan_impl="ssd_fused", **kw) for _ in range(WIDE_DEPTH)]
    for i, blk in enumerate(blocks):
        blk.reset_parameters(torch.Generator().manual_seed(400 + i))
    kernel = torch.nn.ModuleList(blocks).to(device)
    plain = torch.nn.ModuleList(SSDMixer(384, **kw) for _ in range(WIDE_DEPTH)).to(device)
    plain.load_state_dict(kernel.state_dict())
    if (blocks[0].n_heads, blocks[0].head_dim) != (WIDE_GEOMETRIES[(n, p)], p):
        raise AssertionError(f"{name}: {blocks[0].n_heads} heads of {blocks[0].head_dim}")
    sfx = _dtype_sfx(dtype)
    want = {"causal_conv1d_silu" + sfx: 2 * WIDE_DEPTH, "causal_conv1d_silu_bwd" + sfx: WIDE_DEPTH,
            **{_wide_count(e, dtype): WIDE_DEPTH
               for e in ("ssd_xbc_fwd", "ssd_xbc_fwd_states", "ssd_xbc_bwd")}}
    launches, record = stack_phase(device, name, kernel, plain, dtype, want, batch=WIDE_BATCH,
                                   seed=n + p, own_rule=functools.partial(_wide_own_rule, name))
    return {name: launches}, dict(record, d_state=n, head_dim=p, heads=blocks[0].n_heads,
                                  chunk=WIDE_CHUNK)


def wide_carry_path(device, name: str, dtype) -> tuple[dict, dict]:
    """``ssd_chunked_xbc(return_carry=True)`` at (256, 256), 3 heads,
    B=WIDE_CORE_BATCH, L=512, chunk 256, as WIDE_DEPTH chained calls (each
    call's x columns the last's plus 0.1 of its y), in ``dtype``. The path,
    counted from 0: the chain without a gradient (K8 with h_fin 12 times),
    then with one, its loss reading every call's h_fin (K8 with states and
    h_fin, and the seeded K9, 12 times each). The last y, every h_fin and the
    gradients of xbc and dt against the same chain of the plain
    ``ssd_chunked`` on the card: within 1e-3 of their max (PERF_LOGITS_TOL at
    bf16). Returns ({name: launches}, the record)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd
    from si_mamba_tpu_torch.ops.ssd import ssd_chunked

    B, h, n, chunk = WIDE_CORE_BATCH, 3, 256, WIDE_CHUNK
    xbc, dth, S, D, dy, dhf, d = _ssd_inputs(device, B, 512, h, chunk, dtype, seed=71, n=n, p=n)
    dt = dth.reshape(B, h, 512).transpose(1, 2).contiguous()
    A = -torch.linspace(0.2, 1.0, h, device=device)
    tol = 1e-3 if dtype == torch.float32 else PERF_LOGITS_TOL

    def chain(xbc0, dt0, plain: bool):
        cur, fins = xbc0, []
        for _ in range(WIDE_DEPTH):
            if plain:
                y, _, hf = ssd_chunked(cur[..., :d].reshape(B, 512, h, n), dt0, A,
                                       cur[..., d:d + n], cur[..., d + n:], D, chunk=chunk,
                                       return_carry=True)
                y = y.reshape(B, 512, d)
            else:
                y, _, hf = kssd.ssd_chunked_xbc(cur, dt0, A, D, d_inner=d, chunk=chunk,
                                                return_carry=True)
            fins.append(hf)
            cur = torch.cat([cur[..., :d] + 0.1 * y, cur[..., d:]], dim=-1)
        return y, fins

    def loss(y, fins):
        return torch.sum(y.float() * dy.float()) + sum(torch.sum(f * dhf) for f in fins)

    _reset_launch_counts()  # the path: the chain without, then with a gradient
    with torch.no_grad():
        y_eval, _ = chain(xbc, dt, False)
    leaves = [t.detach().requires_grad_() for t in (xbc, dt)]
    y, fins = chain(*leaves, False)
    loss(y, fins).backward()
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = {k: 0 for k in launches}
    for entry in ("ssd_xbc_fwd_hfin", "ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd_seeded"):
        want[_wide_count(entry, dtype)] = WIDE_DEPTH
    if launches != want:
        raise AssertionError(f"{name}: launched {({k: v for k, v in launches.items() if v})}")
    if not torch.equal(y_eval, y.detach()):
        raise AssertionError(f"{name}: the no-grad chain differs from the training chain")
    ref_leaves = [t.detach().float().requires_grad_() if dtype == torch.float32 else
                  t.detach().requires_grad_() for t in (xbc, dt)]
    y_ref, fins_ref = chain(*ref_leaves, True)
    loss(y_ref, fins_ref).backward()
    errs = {"y": _rel_err(y.detach().float(), y_ref.detach().float())[1],
            "h_fin": max(_rel_err(a.detach(), b.detach())[1] for a, b in zip(fins, fins_ref)),
            "dxbc": _rel_err(leaves[0].grad.float(), ref_leaves[0].grad.float())[1],
            "ddt": _rel_err(leaves[1].grad, ref_leaves[1].grad)[1]}
    if any(not np.isfinite(v) or v > tol for v in errs.values()):
        raise AssertionError(f"{name}: against the plain chain {errs} (tolerance {tol})")
    log(f"{name}: {WIDE_DEPTH} chained carry calls at (256, 256): {errs} of max from plain")
    return {name: launches}, {"batch": B, "heads": h, "d_state": n, "head_dim": n,
                              "chunk": chunk, "calls": WIDE_DEPTH,
                              "err_of_max": errs,
                              "launches": {k: v for k, v in launches.items() if v}}


def wide_tp_rank(device, mesh, rank: int, dtype) -> tuple[dict, dict]:
    """Phase 57 on a rank: ``stack_phase`` on WIDE_DEPTH tensor-parallel
    ``SSDMixer`` blocks (d_model 384, d_state 256, head_dim 128: 6 heads, 3 a
    rank, chunk 256, 'ssd_fused') at B=WIDE_CORE_BATCH: the conv 48 times
    (x's and B|C's, twice), its backward 24, the lean K6, K6 with states and
    K7 ('_wide') 12 times each; the output and the input's gradient against
    the single-process plain stack of the same weights. Returns (launches,
    the record)."""
    from si_mamba_tpu_torch.models.layers import SSDMixer

    kw = dict(d_state=256, head_dim=128, chunk=WIDE_CHUNK)
    tp = torch.nn.ModuleList(SSDMixer(384, scan_impl="ssd_fused", mesh=mesh, tp_axis="model",
                                      **kw) for _ in range(WIDE_DEPTH))
    full = torch.nn.ModuleList(SSDMixer(384, **kw) for _ in range(WIDE_DEPTH))
    for i in range(WIDE_DEPTH):
        tp[i].reset_parameters(torch.Generator().manual_seed(500 + i))
        full[i].reset_parameters(torch.Generator().manual_seed(500 + i))
    sfx = _dtype_sfx(dtype)
    want = {"causal_conv1d_silu" + sfx: 4 * WIDE_DEPTH,
            "causal_conv1d_silu_bwd" + sfx: 2 * WIDE_DEPTH,
            **{_wide_count(e, dtype): WIDE_DEPTH
               for e in ("ssd_split_fwd", "ssd_split_fwd_states", "ssd_split_bwd")}}
    launches, record = stack_phase(device, f"rank {rank}: wide TP", tp.to(device),
                                   full.to(device), dtype, want, batch=WIDE_CORE_BATCH, seed=61,
                                   params=False)
    return launches, dict(record, heads_a_rank=3, d_state=256, head_dim=128)


def wide_sp_rank(device, rank: int, dtype) -> tuple[dict, dict]:
    """Phase 57 on a rank: ``ssd_seq_parallel(impl='ssd_fused')`` at (256,
    256), 3 heads, B=WIDE_CORE_BATCH, L=512 (256 a rank), chunk 128, as
    WIDE_DEPTH chained calls (each call's x the last's plus 0.1 of its y) in
    ``dtype``. The path, counted from 0: the chain without a gradient (K6
    with h_fin 12 times), then with one (K6 with states and h_fin, and the
    seeded K7, 12 times each). The chain's y and the gradients of x and dt
    against the same chain of the single-process plain ``ssd_chunked`` on
    the full sequence: within 1e-3 of max (PERF_LOGITS_TOL at bf16).
    Returns ({path: launches}, the record)."""
    from si_mamba_tpu_torch.ops.ssd import ssd_chunked
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import ssd_seq_parallel

    mesh = make_mesh(("seq",), (TP,))
    B, L, h, n, chunk = WIDE_CORE_BATCH, 512, 3, 256, WIDE_SP_CHUNK
    rng = np.random.default_rng(57)
    host = {"x": 0.5 * rng.standard_normal((B, L, h, n), dtype=np.float32),
            "dt": np.log1p(np.exp(rng.standard_normal((B, L, h), dtype=np.float32) - 3.0)),
            "A": -np.exp(rng.standard_normal(h, dtype=np.float32)),
            "Bm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "Cm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "D": rng.standard_normal(h, dtype=np.float32)}
    full = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in host.items()}
    for k in ("x", "Bm", "Cm"):
        full[k] = full[k].to(dtype)
    w = _rand(device, B, L, h, n, seed=58, dtype=dtype)
    part = slice(rank * (L // TP), (rank + 1) * (L // TP))
    local = {k: (v[:, part].contiguous() if v.dim() > 1 else v) for k, v in full.items()}
    tol = 1e-3 if dtype == torch.float32 else PERF_LOGITS_TOL

    def chain(args, core):
        x = args["x"]
        for _ in range(WIDE_DEPTH):
            x = x + 0.1 * core(x, args["dt"], args["A"], args["Bm"], args["Cm"], args["D"])
        return x

    def sp(x, dt, A, Bm, Cm, D):
        return ssd_seq_parallel(x, dt, A, Bm, Cm, D, mesh=mesh, chunk=chunk, impl="ssd_fused")

    _reset_launch_counts()
    with torch.no_grad():
        y_eval = chain(local, sp)
    leaves = {k: (v.detach().requires_grad_() if k in ("x", "dt") else v)
              for k, v in local.items()}
    y = chain(leaves, sp)
    torch.sum(y.float() * w[:, part].float()).backward()
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = {k: 0 for k in launches}
    for entry in ("ssd_split_fwd_hfin", "ssd_split_fwd_states_hfin", "ssd_split_bwd_seeded"):
        want[_wide_count(entry, dtype, chunk)] = WIDE_DEPTH
    if launches != want:
        raise AssertionError(f"rank {rank}: wide SP launched "
                             f"{ {k: v for k, v in launches.items() if v} }")
    if not torch.equal(y_eval, y.detach()):
        raise AssertionError(f"rank {rank}: wide SP no-grad chain differs")
    ref = {k: (v.detach().requires_grad_() if k in ("x", "dt") else v) for k, v in full.items()}
    y_ref = chain(ref, lambda *a: ssd_chunked(*a, chunk=chunk))
    torch.sum(y_ref.float() * w.float()).backward()
    errs = {"y": _rel_err(y.detach().float(), y_ref[:, part].detach().float())[1],
            "dx": _rel_err(leaves["x"].grad.float(), ref["x"].grad[:, part].float())[1],
            "ddt": _rel_err(leaves["dt"].grad, ref["dt"].grad[:, part])[1]}
    if any(not np.isfinite(v) or v > tol for v in errs.values()):
        raise AssertionError(f"rank {rank}: wide SP against the plain chain {errs}")
    return launches, {"dtype": str(dtype).removeprefix("torch."), "batch": B, "heads": h,
                      "d_state": n, "head_dim": n, "chunk": chunk, "ranks": TP,
                      "err_of_max": errs}


def wide_parallel_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 57's tensor- and sequence-parallel paths on this rank, fp32 and
    bf16. Returns ({path: launches}, {path: record})."""
    paths, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = _dtype_sfx(dtype)
        paths["wide_tp" + sfx], out["wide_tp" + sfx] = wide_tp_rank(device, mesh, rank, dtype)
        paths["wide_sp" + sfx], out["wide_sp" + sfx] = wide_sp_rank(device, rank, dtype)
    return paths, out


def profile_script_phase(card: str) -> dict:
    """Phase 58: ``scripts/torch_profile_train_step.py`` once at its default
    geometry (the Mamba-1 finetune step, B=32, bf16, subspace) into
    chiprun_out/profiles/, through its ``main`` as its command line calls it
    (in this process: the kernels are loaded, the card is warm). Its JSON
    must hold the JAX script's keys, a positive leaf device time, and K1, K3,
    K4 and K5 (their kernels by name: K3 and K4 the Hopper bf16 body's) 12
    calls a step each. Returns the record."""
    import importlib.util

    out_dir = ROOT / "chiprun_out" / "profiles"
    spec = importlib.util.spec_from_file_location(
        "torch_profile_train_step", ROOT / "scripts" / "torch_profile_train_step.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    t0 = time.perf_counter()
    if script.main(["--out", str(out_dir)]) != 0:
        raise AssertionError("the profile script failed")
    wall = time.perf_counter() - t0
    out = json.loads((out_dir / "profile_train_step.json").read_text())
    keys = ["step_wall_ms", "leaf_device_ms_per_step", "control_flow_wrapper_ms_per_step",
            "note", "categories_ms", "top_ops_ms", "top_ops_by_category"]
    if list(out) != keys:
        raise AssertionError(f"the profile's keys are {list(out)}, the JAX script's {keys}")
    if not out["leaf_device_ms_per_step"] > 0:
        raise AssertionError(f"no device time in the profile: {out['leaf_device_ms_per_step']}")
    ops = [o for cat in out["top_ops_by_category"].values() for o in cat]
    calls = {}
    for kernel in ("causal_conv1d_silu_fwd_kernel", "::scan_fwd<true, false>(", "::scan_bwd(",
                   "causal_conv1d_silu_bwd_kernel"):
        calls[kernel] = sum(o["calls"] for o in ops if kernel in o["op"])
    if calls != dict.fromkeys(calls, 12.0):
        raise AssertionError(f"the profiled step's K1/K3/K4/K5 calls a step: {calls}")
    record = {"wall_s": wall, "card": card, "step_wall_ms": out["step_wall_ms"],
              "leaf_device_ms_per_step": out["leaf_device_ms_per_step"],
              "categories_ms": out["categories_ms"], "kernel_calls_per_step": calls}
    log(f"profile script (phase 58): step {out['step_wall_ms']} ms, leaf device "
        f"{out['leaf_device_ms_per_step']} ms a step, {out['categories_ms']}; {wall:.1f} s")
    return record


def slice22_phases(device, card: str) -> tuple[dict, dict, dict]:
    """Phases 57-58 (after phase 56; 57's parallel paths run on phase 11's
    ranks): the wide-state K6-K9 held and timed, the 12-block wide SSDMixer
    stacks at the four geometries, fp32 and bf16, and the carry path; then
    the train-step profiler. Returns (the new records' figures by name, each
    path's launches, the record)."""
    t0 = time.perf_counter()
    figures = wide_kernel_phase(device)
    paths, record, wall = {}, {}, {"kernels": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for (n, p) in WIDE_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"wide_stack_n{n}_p{p}" + _dtype_sfx(dtype)
            q, record[key] = wide_stack_phase(device, key, n, p, dtype)
            paths.update(q)
    for dtype in (torch.float32, torch.bfloat16):
        key = "wide_carry" + _dtype_sfx(dtype)
        q, record[key] = wide_carry_path(device, key, dtype)
        paths.update(q)
    wall["paths"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["profile_script"] = profile_script_phase(card)
    wall["profile_script"] = time.perf_counter() - t0
    record["wall_s"] = wall
    log(f"phases 57-58 by part (s): {wall}")
    return figures, paths, record


def slice22_records(figures: dict) -> list[dict]:
    """The kernel records of the wide-state variants, each with its route,
    source and the TPU kernel it replaces."""
    ssd_src = {True: "si_mamba_tpu_torch/csrc/ssd_xbc_fwd.cu",
               False: "si_mamba_tpu_torch/csrc/ssd_xbc_bwd.cu"}
    ssd_at = {(False, True): "602", (False, False): "698", (True, True): "189",
              (True, False): "388"}
    records = []
    for name, fig in figures.items():
        split, fwd = SSD_ENTRIES[fig["entry"]][:2]
        records.append(dict(name=name, route="cuda", source=ssd_src[fwd],
                            replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:" + ssd_at[(split, fwd)],
                            dtype="bfloat16" if name.endswith("_bf16") else "float32", **fig))
    return records


# ---------------------------------------------------------------------------
# data parallelism and the pipeline (phases 35-40): gloo ranks on the one card
# ---------------------------------------------------------------------------

DP = 2  # the data axis's ranks (DP x TP: 2 x TP = 4)
DP_STEPS = 3
# tests/test_torch_port_train.py's schedule (1e-3 after a warm-up epoch from
# 1e-6, an epoch a step), under which its tolerances hold: the steps' noise in
# the gradients of the biases that only feed a BatchNorm (exactly 0) moves the
# BatchNorm statistics by at most 2e-6 before the third update
DP_LR, DP_EPOCHS, DP_WARMUP = 1e-3, 4, 1
DP_VOTES = 2
PIPE_MICRO = 4
PIPE_BATCH = 8
DP_DEVICE = "cuda"  # the ranks' device kind (the CLI's --device)


def _dp_optimizer(model, data_axis=None, tp=None):
    from si_mamba_tpu_torch.train.optim import build_optimizer

    return build_optimizer(model, opt_type="AdamW", lr=DP_LR, weight_decay=0.05,
                           epochs=DP_EPOCHS, warmup_epochs=DP_WARMUP, steps_per_epoch=1,
                           grad_clip=10.0, tp=tp, data_axis=data_axis)[0]


def _dp_steps(model, optimizer, points, labels, device, data_axis=None, check=None) -> dict:
    """DP_STEPS steps of the shipped finetune step (FPS 8192 -> 1200, a random
    1024 of them, scale + translate, drop_path 0.3) from a generator of seed 0
    on ``device``: each step's prepared clouds (on the CPU), generator state
    and loss, its ms and launches, and the steps' launches in all (``total``,
    every count set to 0 before the first); ``check`` after each step."""
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.train_state import TrainState

    state = TrainState.create(model, optimizer)
    step = rf.make_train_step(model, NPOINTS, rotation=False, data_axis=data_axis)
    generator = torch.Generator(device=device).manual_seed(0)
    out = {"prepared": [], "generator": [], "losses": [], "ms": [], "launches": []}
    real = rf.finetune_update

    def recording(state, pts, *a, **k):
        out["prepared"].append(pts.cpu())
        return real(state, pts, *a, **k)

    rf.finetune_update = recording
    _reset_launch_counts()
    try:
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            state, m = step(state, points, labels, generator)
            loss = m["loss"].item()
            out["ms"].append((time.perf_counter() - t) * 1e3)
            now = _launch_counts()
            out["launches"].append({k: now[k] - before[k] for k in now})
            out["losses"].append(loss)
            out["generator"].append(generator.get_state().cpu())
            if check is not None:
                check()
    finally:
        rf.finetune_update = real
    out["total"] = _launch_counts()
    return out


def dp_reference(device) -> dict:
    """Phase 35's reference: the one-process step at B=32 on this card and
    seed, DP_STEPS steps; its prepared clouds, losses and final state."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    model = PointMamba(PointMambaConfig.from_dict(MODELNET40),
                       generator=torch.Generator().manual_seed(0)).to(device)
    pts, labels = _train_clouds(TRAIN_BATCH, seed=7)
    run = _dp_steps(model, _dp_optimizer(model), torch.from_numpy(pts).to(device),
                    torch.from_numpy(labels).to(device), device)
    run["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    run.pop("launches"), run.pop("total")
    return run


def _peak_gib(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 2**30


def dp_step_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phases 35-36 on one rank: the DP step at its 16 rows of the global
    batch of 32 (the ranks bitwise equal after every step), the gradient
    all-reduce alone, then the eval forward at B=16 against 'seq'."""
    import torch.distributed as dist

    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.parallel import set_data_axis
    from si_mamba_tpu_torch.train import runner_finetune as rf

    dp = mesh["data"]
    b = TRAIN_BATCH // dp.size
    rows = slice(rank * b, (rank + 1) * b)
    model = PointMamba(PointMambaConfig.from_dict(MODELNET40),
                       generator=torch.Generator().manual_seed(0)).to(device)
    set_data_axis(model, dp)
    pts, labels = _train_clouds(TRAIN_BATCH, seed=7)
    optimizer = _dp_optimizer(model, dp)
    torch.cuda.reset_peak_memory_stats(device)
    run = _dp_steps(model, optimizer, torch.from_numpy(pts[rows]).to(device),
                    torch.from_numpy(labels[rows]).to(device), device, dp,
                    check=lambda: rf.check_replicas(model, mesh))
    peak = _peak_gib(device)
    want = _expect(MODELNET40["depth"], TRAIN_KERNELS)
    for i, launches in enumerate(run["launches"]):
        if launches != want:
            raise AssertionError(f"rank {rank}: DP step {i} launched {launches}, expected {want}")
    launches = run["launches"][0]
    if run["total"] != _expect(MODELNET40["depth"] * DP_STEPS, TRAIN_KERNELS):
        raise AssertionError(f"rank {rank}: the DP steps launched {run['total']} in all")
    # the data axis's gradient all-reduce alone: every gradient, one buffer
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    times = []
    for _ in range(5):
        buf = flat.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(buf, group=dp.group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    record = {"rows": [rows.start, rows.stop], "losses": run["losses"], "step_ms": run["ms"],
              "p50_step_ms": statistics.median(run["ms"][1:]), "peak_gib": peak,
              "launches_per_step": {k: v for k, v in launches.items() if v},
              "grad_allreduce_mb": flat.numel() * 4 / 1e6,
              "grad_allreduce_ms": statistics.median(times[1:])}
    record["prepared"], record["generator"] = run["prepared"], run["generator"]
    if rank == 0:
        record["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    # phase 36: this rank's eval forward at B=16 against the plain route
    eval_pts = torch.from_numpy(clouds(TRAIN_BATCH, seed=9)[rows]).to(device)
    plain = PointMamba(PointMambaConfig.from_dict({**MODELNET40, "scan_impl": "seq"})).to(device)
    plain.load_state_dict(model.state_dict(), strict=True)
    _reset_launch_counts()
    with torch.inference_mode():
        logits = model.eval()(eval_pts)
        fwd = _launch_counts()
        ref = plain.eval()(eval_pts)
    if fwd != _expect(MODELNET40["depth"], EVAL_KERNELS):
        raise AssertionError(f"rank {rank}: the DP forward launched {fwd}")
    scale, err = ref.abs().max().item(), (logits - ref).abs().max().item()
    if not torch.allclose(logits, ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"rank {rank}: DP forward logits disagree with 'seq': max |diff| "
                             f"{err}, max |logit| {scale}")
    record["forward"] = {"batch": b, "logits_max_abs_diff": err, "logits_max_abs": scale}
    return {"dp_train": run["total"], "dp_forward": fwd}, record


def _step_recorder(module, name: str, calls: list):
    """Wrap ``module.<name>`` (a step maker): each step's loss, ms and
    launches (the counts' difference across it) appended to ``calls``.
    Returns the original."""
    real = getattr(module, name)

    def make(*a, **k):
        step = real(*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            state, m = step(*sa, **sk)
            now = _launch_counts()
            calls.append({"loss": m["loss"].item(), "ms": (time.perf_counter() - t) * 1e3,
                          "launches": {k: now[k] - before[k] for k in now}})
            return state, m

        return run

    setattr(module, name, make)
    return real


def _dp_work() -> Path:
    """build/dp: the ModelNet40 tree (the harness's sizes) and the experiment
    config of the CLI phases (cfgs/finetune_modelnet.yaml at max_epoch 1)."""
    work = ROOT / "build" / "dp"
    tree = work / "modelnet40"
    if not (tree / "modelnet40_test.txt").exists():
        rng = np.random.default_rng(21)

        def cloud():
            return rng.standard_normal((TRAIN_POINTS, 6)).astype(np.float32)

        copied = cloud()
        write_modelnet_tree(tree, {
            "train": [(i % HARNESS_CLASSES, cloud()) for i in range(HARNESS_TRAIN)],
            "test": [(c % HARNESS_CLASSES, copied if c < HARNESS_CLASSES else cloud())
                     for c in range(HARNESS_TEST)]})
    (work / "modelnet40.yaml").write_text(
        f"NAME: ModelNet\nDATA_PATH: {tree}\nN_POINTS: {TRAIN_POINTS}\n"
        f"NUM_CATEGORY: {HARNESS_CLASSES}\nUSE_NORMALS: FALSE\n")
    datasets = "dataset:\n" + "".join(
        f"  {name}: {{_base_: {work}/modelnet40.yaml, others: {{subset: '{subset}'}}}}\n"
        for name, subset in (("train", "train"), ("val", "test"), ("test", "test")))
    (work / "dp_modelnet.yaml").write_text(
        f"_base_: {ROOT}/cfgs/finetune_modelnet.yaml\nmax_epoch: 1\n{datasets}")
    (work / "dptp_modelnet.yaml").write_text(
        f"_base_: {ROOT}/cfgs/finetune_modelnet.yaml\nmax_epoch: 0\ntp_size: {TP}\n"
        f"model: {{tp_axis: model}}\n{datasets}")
    return work


def dp_cli_rank(device, rank: int) -> tuple[dict, dict]:
    """Phase 37 on one rank: the finetune CLI over the ranks (epochs 0 and 1,
    two steps each at the global batch 32), --test of its ckpt-last.pth,
    --resume with max_epoch raised to 2 (one more epoch), and the vote over
    the ranks' shards of the test split."""
    import types

    from si_mamba_tpu_torch.parallel.mesh import barrier, data_axis
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.config import get_config
    from si_mamba_tpu_torch.train.registry import build_model_from_cfg
    from si_mamba_tpu_torch.utils.weights import load_state_dict_file

    work = ROOT / "build" / "dp"
    base = ["--config", str(work / "dp_modelnet.yaml"), "--device", DP_DEVICE,
            "--num_workers", "2"]
    steps, vals = [], []
    real_step = _step_recorder(rf, "make_train_step", steps)
    real_validate = rf.validate

    def validate(*a, **k):
        vals.append(real_validate(*a, **k))
        return vals[-1]

    rf.validate = validate
    cwd = os.getcwd()
    os.chdir(work)
    paths = {}
    try:
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()
        t0 = time.perf_counter()
        state, best = cli.main(base + ["--exp_name", "run"])
        run_s = time.perf_counter() - t0
        paths["dp_cli_train"] = _launch_counts()
        peak = _peak_gib(device)
        exp = work / "experiments" / "dp_modelnet" / "run"
        val_accs = list(vals)
        test_acc = cli.main(base + ["--exp_name", "test", "--test", "--ckpts",
                                    str(exp / "ckpt-last.pth")])
        if rank == 0:  # one more epoch for --resume (it re-reads the snapshot)
            snap = exp / "config.yaml"
            snap.write_text(snap.read_text().replace("max_epoch: 1", "max_epoch: 2"))
        barrier()
        resumed, _ = cli.main(base + ["--exp_name", "run", "--resume"])
        config = get_config(str(work / "dp_modelnet.yaml"))
    finally:
        rf.make_train_step, rf.validate = real_step, real_validate
        os.chdir(cwd)
    mesh = rf.make_run_mesh(config)
    model, _ = build_model_from_cfg(config.model, device, mesh=mesh)
    model.load_state_dict(load_state_dict_file(str(exp / "ckpt-last.pth")), strict=True)
    dp = data_axis(mesh)
    args = types.SimpleNamespace(device=DP_DEVICE, seed=0, num_workers=2,
                                 shard=(dp.index, dp.size))
    loader = cli.build_loader(config.dataset.test, args, "test", TRAIN_BATCH // DP, False, False)
    vote = rf.make_vote_step(model, NPOINTS, rotation=False, times=DP_VOTES)
    _reset_launch_counts()
    vote_acc = rf.validate_vote(vote, rf.TrainState(0, model, None), loader)
    paths["dp_cli_vote"] = _launch_counts()
    depth = MODELNET40["depth"]
    for i, s in enumerate(steps):
        if s["launches"] != _expect(depth, TRAIN_KERNELS) or not np.isfinite(s["loss"]):
            raise AssertionError(f"rank {rank}: DP CLI step {i}: {s}")
    if len(steps) != 6 or state.step != 4 or resumed.step != 6:
        raise AssertionError(f"rank {rank}: DP CLI took {len(steps)} steps (state {state.step}, "
                             f"resumed {resumed.step}), expected 4 then 2 more")
    if test_acc != val_accs[1]:
        raise AssertionError(f"rank {rank}: --test gave {test_acc}, the last validation "
                             f"{val_accs[1]}")
    files = sorted(p.name for p in exp.iterdir())
    logs = [f for f in files if f.endswith(".log")]
    if not {"ckpt-best.pth", "ckpt-last.pth", "config.yaml", "scalars.jsonl"} <= set(files) \
            or any(f.endswith(".tmp") for f in files) or len(logs) != 1:  # rank 0's
        raise AssertionError(f"rank {rank}: the DP CLI run's files: {files}")
    last = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)
    if last["epoch"] != 2 or last["step"] != 6:
        raise AssertionError(f"rank {rank}: ckpt-last.pth holds epoch {last['epoch']}, step "
                             f"{last['step']}")
    record = {"losses": [s["loss"] for s in steps], "step_ms": [s["ms"] for s in steps],
              "p50_step_ms": statistics.median([s["ms"] for s in steps[1:4]]),
              "peak_gib": peak, "run_s": run_s, "val_acc": val_accs, "test_acc": test_acc,
              "vote_acc": vote_acc, "best_acc": best.acc, "files": files}
    return paths, record


def dp_seg_pretrain_rank(device, rank: int) -> tuple[dict, dict]:
    """Phase 39 on one rank: cfgs/part_segmentation.yaml (global batch 16, one
    epoch of three steps) and cfgs/pretrain.yaml (global batch 128, two epochs
    of two steps, then the SVM probe) through the CLI over the ranks, at full
    width and depth, on phases 29's and 33's trees."""
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_pretrain as rp
    from si_mamba_tpu_torch.train import runner_seg as rs
    from si_mamba_tpu_torch.train.config import get_config

    seg_work, mae_work = ROOT / "build" / "seg", ROOT / "build" / "mae"
    seg_depth = int(get_config(str(seg_work / "dp_seg.yaml")).model.depth)
    seg_steps, pre_steps, mious, probes = [], [], [], []
    real = (_step_recorder(rs, "make_seg_train_step", seg_steps),
            _step_recorder(rp, "make_pretrain_step", pre_steps), rs.evaluate_miou, rp.svm_probe)
    rs.evaluate_miou = lambda *a, **k: mious.append(real[2](*a, **k)) or mious[-1]
    rp.svm_probe = lambda *a, **k: probes.append(real[3](*a, **k)) or probes[-1]
    cwd = os.getcwd()
    paths = {}
    try:
        os.chdir(seg_work)
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()
        cli.main(["--config", str(seg_work / "dp_seg.yaml"), "--device", DP_DEVICE,
                  "--num_workers", "0", "--exp_name", "dp"])
        paths["dp_seg_cli"] = _launch_counts()
        seg_peak = _peak_gib(device)
        os.chdir(mae_work)
        tcfg = get_config(str(mae_work / "dp_pre.yaml")).model.transformer_config
        pre_blocks = int(tcfg.depth) + int(tcfg.decoder_depth)
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()
        cli.main(["--config", str(mae_work / "dp_pre.yaml"), "--device", DP_DEVICE,
                  "--num_workers", "2", "--exp_name", "dp"])
        paths["dp_pretrain_cli"] = _launch_counts()
        pre_peak = _peak_gib(device)
    finally:
        (rs.make_seg_train_step, rp.make_pretrain_step, rs.evaluate_miou,
         rp.svm_probe) = real
        os.chdir(cwd)
    for i, s in enumerate(seg_steps):
        if s["launches"] != _expect(seg_depth, TRAIN_KERNELS) or not np.isfinite(s["loss"]):
            raise AssertionError(f"rank {rank}: DP seg step {i}: {s}")
    for i, s in enumerate(pre_steps):
        if s["launches"] != _expect(pre_blocks, TRAIN_KERNELS) or not np.isfinite(s["loss"]):
            raise AssertionError(f"rank {rank}: DP pretrain step {i}: {s}")
    # whole batches of each rank's shard: the trainval shapes (one epoch), the
    # ShapeNet-55 shapes, train and test ('whole'; two epochs)
    want = ((SEG_TRAINVAL // DP) // (SEG_BATCH // DP),
            2 * ((PRETRAIN_SHAPES // DP) // (PRETRAIN_BATCH // DP)), 1, 1)
    if (len(seg_steps), len(pre_steps), len(mious), len(probes)) != want:
        raise AssertionError(f"rank {rank}: DP seg/pretrain ran {len(seg_steps)} / "
                             f"{len(pre_steps)} steps, {len(mious)} / {len(probes)} evaluations")
    return paths, {
        "seg": {"losses": [s["loss"] for s in seg_steps], "step_ms": [s["ms"] for s in seg_steps],
                "p50_step_ms": statistics.median([s["ms"] for s in seg_steps[1:]]),
                "peak_gib": seg_peak, "instance_miou": mious[0]["instance_miou"],
                "class_miou": mious[0]["class_miou"], "accuracy": mious[0]["accuracy"]},
        "pretrain": {"losses": [s["loss"] for s in pre_steps],
                     "step_ms": [s["ms"] for s in pre_steps], "peak_gib": pre_peak,
                     "probe_acc": probes[0]}}


def pipeline_rank(device, rank: int) -> tuple[dict, dict]:
    """Phase 40 on one rank: the ModelNet40 classifier (drops 0) with its 12
    blocks pipelined over 2 stages of 6, PIPE_MICRO microbatches of
    PIPE_BATCH clouds: the logits against the one-process model on this
    rank; then one backward of the pipelined stack on a seeded cotangent,
    this stage's block gradients against the one-process stack's."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.pipeline import (
        pipeline_mixer_apply,
        pipeline_pointmamba_logits,
        stack_mixer_params,
        take_stage,
    )

    mesh = make_mesh(("pipe",), (DP,))
    cfg = PointMambaConfig.from_dict({**MODELNET40, "drop_path": 0.0})
    model = PointMamba(cfg, generator=torch.Generator().manual_seed(3)).to(device).eval()
    pts = torch.from_numpy(clouds(PIPE_BATCH, seed=13)).to(device)
    _reset_launch_counts()
    with torch.no_grad():
        logits = pipeline_pointmamba_logits(model, pts, mesh=mesh, n_micro=PIPE_MICRO)
        fwd = _launch_counts()
        ref = model(pts)
    scale, err = ref.abs().max().item(), (logits - ref).abs().max().item()
    if not torch.allclose(logits, ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"rank {rank}: pipelined logits disagree: max |diff| {err}, max "
                             f"|logit| {scale}")
    ticks = PIPE_MICRO + DP - 1
    if fwd != _expect(cfg.depth // DP * ticks, EVAL_KERNELS):
        raise AssertionError(f"rank {rank}: the pipelined forward launched {fwd}")

    with torch.no_grad():
        tokens, pos, center = model.embed(pts)
        x, pos_seq = model.sequence(tokens, pos, center)
    cot = torch.from_numpy(np.random.default_rng(14).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(device)
    stacked, norm_f = stack_mixer_params(model.blocks.state_dict(), cfg.depth, DP)
    stage = take_stage(stacked, rank)
    leaves = [stage["norm_scale"], stage["norm_bias"], *stage["mixer"].values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    _reset_launch_counts()
    y = pipeline_mixer_apply(stage, norm_f, x + pos_seq, mesh=mesh, n_micro=PIPE_MICRO)
    torch.sum(y * cot).backward()
    bwd = _launch_counts()
    model.blocks.zero_grad(set_to_none=True)
    torch.sum(model.blocks(x, pos_seq) * cot).backward()
    per = cfg.depth // DP
    gmax, worst = 0.0, 0.0
    for j in range(per):
        layer = model.blocks.layers[rank * per + j]
        want = [layer.norm.weight.grad, layer.norm.bias.grad] + [
            _param_grad(layer.mixer, k) for k in stage["mixer"]]
        got = [stage["norm_scale"].grad[j], stage["norm_bias"].grad[j]] + [
            stage["mixer"][k].grad[j] for k in stage["mixer"]]
        for g, w in zip(got, want):
            gmax = max(gmax, w.abs().max().item())
            worst = max(worst, (g - w).abs().max().item())
    if worst > 1e-3 * gmax:
        raise AssertionError(f"rank {rank}: the pipelined stack's gradients differ by {worst} "
                             f"(largest {gmax})")
    return {"pipeline_forward": fwd, "pipeline_train": bwd}, {
        "stages": DP, "blocks_per_stage": per, "n_micro": PIPE_MICRO, "batch": PIPE_BATCH,
        "logits_max_abs_diff": err, "logits_max_abs": scale, "grad_max_abs_diff": worst,
        "grad_max_abs": gmax}


def _param_grad(mixer, key: str) -> torch.Tensor:
    """The gradient of the mixer parameter behind ``params()[key]``, laid out
    as ``params()`` lays it (transposed weights, the conv's taps)."""
    name = {"in_proj_w": "in_proj.weight", "conv_w": "conv1d.weight", "conv_b": "conv1d.bias",
            "x_proj_w": "x_proj.weight", "dt_proj_w": "dt_proj.weight",
            "dt_proj_b": "dt_proj.bias", "A_log": "A_log", "D": "D",
            "out_proj_w": "out_proj.weight"}[key]
    g = mixer.get_parameter(name).grad
    if key == "conv_w":
        return g[:, 0, :]
    return g.t() if key.endswith("_w") else g


def _dp_env(rank: int, world: int, port: int) -> None:
    """torchrun's variables for one rank of a launch of ``world`` on this host."""
    os.environ.update({"SI_MAMBA_MULTIHOST": "1", "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port), "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
                       "GLOO_SOCKET_IFNAME": "lo"})


def _dp_init(rank: int, world: int, port: int) -> torch.device:
    """torchrun's variables, then the CLI's own initialisation of the default
    group (its backend rule: gloo, the ranks sharing the card; a collective
    that waits 10 minutes fails). Returns the rank's device."""
    import datetime

    from si_mamba_tpu_torch.parallel import maybe_initialize_distributed
    from si_mamba_tpu_torch.parallel.mesh import rank_device

    _dp_env(rank, world, port)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if not maybe_initialize_distributed(device=DP_DEVICE,
                                        timeout=datetime.timedelta(minutes=10)):
        raise AssertionError("the default group was not initialised")
    return rank_device(DP_DEVICE)


def dp_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of phases 35-37 and 39-40 (a spawned process; the default
    group from torchrun's variables, as the CLI initialises it: gloo, since
    the ranks share the card; a collective that waits 10 minutes fails)."""
    import torch.distributed as dist

    from si_mamba_tpu_torch.parallel import make_mesh

    device = _dp_init(rank, DP, port)
    t0 = time.perf_counter()
    try:
        paths, out = {}, {"backend": dist.get_backend(), "device": str(device)}
        mesh = make_mesh(("data",), (DP,))
        p, out["step"] = dp_step_rank(device, mesh, rank)
        paths.update(p)
        out["step_wall_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        p, out["cli"] = dp_cli_rank(device, rank)
        paths.update(p)
        out["cli_wall_s"] = time.perf_counter() - t
        t = time.perf_counter()
        p, out["seg_pretrain"] = dp_seg_pretrain_rank(device, rank)
        paths.update(p)
        out["seg_pretrain_wall_s"] = time.perf_counter() - t
        t = time.perf_counter()
        p, out["pipeline"] = pipeline_rank(device, rank)
        paths.update(p)
        out["pipeline_wall_s"] = time.perf_counter() - t
        torch.save({"paths": paths, "records": out}, f"{out_dir}/dp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_tp_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase 38: the finetune CLI over DP x TP = 2 x 2 ranks (mesh
    (data 2, model 2), the Mamba-1 tensor-parallel mixer; one epoch, two steps
    at the global batch 32), launched as torchrun launches the CLI."""
    import torch.distributed as dist

    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf

    device = _dp_init(rank, DP * TP, port)
    work = ROOT / "build" / "dp"
    steps = []
    real = _step_recorder(rf, "make_train_step", steps)
    os.chdir(work)
    try:
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launch_counts()
        t0 = time.perf_counter()
        state, best = cli.main(["--config", str(work / "dptp_modelnet.yaml"), "--device",
                                DP_DEVICE,
                                "--num_workers", "2", "--exp_name", "dptp"])
        wall = time.perf_counter() - t0
        mesh = state.model.mesh
        record = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                  "mesh": [list(mesh.axis_names), list(mesh.shape)],
                  "losses": [s["loss"] for s in steps], "step_ms": [s["ms"] for s in steps],
                  "launches": [s["launches"] for s in steps], "path": _launch_counts(),
                  "peak_gib": _peak_gib(device),
                  "wall_s": wall, "val_acc": best.acc}
        torch.save(record, f"{out_dir}/dptp_rank{rank}.pt")
    finally:
        rf.make_train_step = real
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_phases(device, card: str) -> tuple[dict, dict]:
    """Phases 35-40: data parallelism on gloo ranks sharing the card, and the
    pipeline. The parent runs phase 35's one-process reference first, writes
    the CLI phases' trees and configs, then spawns the 2-rank group (phases
    35-37, 39, 40) and the 4-rank group (phase 38). Returns (each path's
    launches on rank 0, the record); fails unless every check holds."""
    import torch.multiprocessing as mp

    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    out_dir = ROOT / "build" / "dp"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ref = dp_reference(device)
    ref_s = time.perf_counter() - t0
    _dp_work()
    # the seg and pretraining trees of phases 29 and 33, and the configs over them
    seg_work, mae_work = ROOT / "build" / "seg", mae_workdir()
    tree = seg_work / "shapenetpart"
    if not (tree / "synsetoffset2category.txt").exists():
        write_shapenetpart_tree(tree, SEG_TRAINVAL, SEG_TEST)
    if not (seg_work / "cfgs").exists():
        os.symlink(ROOT / "cfgs", seg_work / "cfgs")
    (seg_work / "dp_seg.yaml").write_text(
        f"_base_: {ROOT}/cfgs/part_segmentation.yaml\nmax_epoch: 1\ndata_root: {tree}\n")
    (mae_work / "dp_pre.yaml").write_text("_base_: cfgs/pretrain.yaml\nmax_epoch: 1\n")
    torch.cuda.empty_cache()  # the ranks share the card

    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(_free_port(), str(out_dir)), nprocs=DP,
                       start_method="spawn", join=True)
    dp_wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"dp_rank{r}.pt", weights_only=False) for r in range(DP)]
    t0 = time.perf_counter()
    mp.start_processes(dp_tp_rank, args=(_free_port(), str(out_dir)), nprocs=DP * TP,
                       start_method="spawn", join=True)
    dptp_wall = time.perf_counter() - t0
    dptp = [torch.load(out_dir / f"dptp_rank{r}.pt", weights_only=False) for r in range(DP * TP)]

    # phase 35: the ranks against the one-process step
    steps = [r["records"]["step"] for r in ranks]
    b = TRAIN_BATCH // DP
    for r, s in enumerate(steps):
        for i in range(DP_STEPS):
            if not torch.equal(s["prepared"][i], ref["prepared"][i][r * b:(r + 1) * b]):
                raise AssertionError(f"rank {r}: step {i}'s prepared clouds differ from the "
                                     f"one-process step's rows")
            if not torch.equal(s["generator"][i], ref["generator"][i]):
                raise AssertionError(f"rank {r}: the generator left step {i} in another state")
        if not np.allclose(s["losses"], ref["losses"], rtol=2e-4, atol=0):
            raise AssertionError(f"rank {r}: DP losses {s['losses']} against one-process "
                                 f"{ref['losses']}")
        s.pop("prepared"), s.pop("generator")
    if steps[0]["losses"] != steps[1]["losses"]:
        raise AssertionError(f"the ranks' losses differ: {[s['losses'] for s in steps]}")
    from si_mamba_tpu_torch.train.optim import cosine_warmup_epoch_schedule

    schedule = cosine_warmup_epoch_schedule(DP_LR, DP_EPOCHS, DP_WARMUP, 1)
    lr_sum = sum(schedule(i) for i in range(DP_STEPS))
    worst_param, worst_stat = 0.0, 0.0
    for k, got in steps[0].pop("state").items():
        want = ref["state"][k]
        if "num_batches_tracked" in k:
            if not torch.equal(got, want):
                raise AssertionError(f"{k}: {got} against {want}")
            continue
        diff = (got - want).abs()
        if "running_" in k:
            ok = torch.all(diff <= 1e-4 + 1e-3 * want.abs())
            worst_stat = max(worst_stat, diff.max().item())
        else:
            ok = torch.all(diff <= 2.5 * lr_sum + 1e-4 * want.abs())
            worst_param = max(worst_param, diff.max().item())
        if not ok:
            raise AssertionError(f"{k} after {DP_STEPS} DP steps differs from the one-process "
                                 f"step's by {diff.max().item()}")
    # phase 37: the CLI ranks agree
    cli_recs = [r["records"]["cli"] for r in ranks]
    for key in ("losses", "val_acc", "test_acc", "vote_acc", "best_acc"):
        if cli_recs[0][key] != cli_recs[1][key]:
            raise AssertionError(f"the CLI ranks' {key} differ: {[c[key] for c in cli_recs]}")
    # phase 38: DP x TP
    for r, d in enumerate(dptp):
        if d["mesh"] != [["data", "model"], [DP, TP]] or d["backend"] != "gloo":
            raise AssertionError(f"DP x TP rank {r}: mesh {d['mesh']}, {d['backend']}")
        if d["losses"] != dptp[0]["losses"] or len(d["losses"]) != 2:
            raise AssertionError(f"the DP x TP ranks' losses differ: "
                                 f"{[x['losses'] for x in dptp]}")
        for i, launches in enumerate(d["launches"]):
            if launches != _expect(MODELNET40["depth"], TRAIN_KERNELS):
                raise AssertionError(f"DP x TP rank {r} step {i} launched {launches}")
    whole = torch.load(out_dir / "experiments" / "dptp_modelnet" / "dptp" / "ckpt-last.pth",
                       map_location="cpu", weights_only=True)
    one = PointMamba(PointMambaConfig.from_dict(MODELNET40))
    one.load_state_dict(whole["base_model"], strict=True)
    # phase 39: the seg and pretraining ranks agree
    sp = [r["records"]["seg_pretrain"] for r in ranks]
    for key in ("instance_miou", "class_miou", "accuracy", "losses"):
        if sp[0]["seg"][key] != sp[1]["seg"][key]:
            raise AssertionError(f"the seg ranks' {key} differ: {[s['seg'][key] for s in sp]}")
    for key in ("probe_acc", "losses"):
        if sp[0]["pretrain"][key] != sp[1]["pretrain"][key]:
            raise AssertionError(f"the pretraining ranks' {key} differ: "
                                 f"{[s['pretrain'][key] for s in sp]}")
    rec = ranks[0]["records"]
    for r, s in enumerate(steps):
        log(f"DP step rank {r} (rows {s['rows']}): p50 {s['p50_step_ms']:.3f} ms, peak "
            f"{s['peak_gib']:.3f} GiB, launches a step {s['launches_per_step']}, gradient "
            f"all-reduce of {s['grad_allreduce_mb']:.1f} MB {s['grad_allreduce_ms']:.3f} ms; "
            f"forward at B={s['forward']['batch']} against 'seq' "
            f"{s['forward']['logits_max_abs_diff']:.3e}; {card}")
    log(f"DP step against one process: losses {steps[0]['losses']} / {ref['losses']}, worst "
        f"parameter {worst_param:.3e}, worst BatchNorm statistic {worst_stat:.3e}")
    log(f"DP CLI: step p50 {cli_recs[0]['p50_step_ms']:.3f} / {cli_recs[1]['p50_step_ms']:.3f} ms, "
        f"peak {cli_recs[0]['peak_gib']:.3f} GiB, val {cli_recs[0]['val_acc']}, test "
        f"{cli_recs[0]['test_acc']}, vote {cli_recs[0]['vote_acc']}; files {cli_recs[0]['files']}")
    log(f"DP x TP CLI: losses {dptp[0]['losses']}, step ms {dptp[0]['step_ms']}, peak "
        f"{[round(d['peak_gib'], 3) for d in dptp]} GiB; its checkpoint loads strict into one "
        f"process")
    log(f"DP seg: {sp[0]['seg']}; DP pretrain: {sp[0]['pretrain']}")
    log(f"pipeline: {[r['records']['pipeline'] for r in ranks]}")
    log(f"DP walls: reference {ref_s:.1f} s, 2 ranks {dp_wall:.1f} s (step "
        f"{rec['step_wall_s']:.1f}, CLI {rec['cli_wall_s']:.1f}, seg + pretrain "
        f"{rec['seg_pretrain_wall_s']:.1f}, pipeline {rec['pipeline_wall_s']:.1f}), 4 ranks "
        f"{dptp_wall:.1f} s; gloo ranks sharing one card: their times say little of speed")
    record = {"ranks": DP, "backend": rec["backend"], "card": card,
              "reference": {"losses": ref["losses"], "step_ms": ref["ms"]},
              "step": {f"rank{r}": s for r, s in enumerate(steps)},
              "worst_param_diff": worst_param, "worst_bn_stat_diff": worst_stat,
              "cli": {f"rank{r}": c for r, c in enumerate(cli_recs)},
              "dp_tp": {f"rank{r}": {k: v for k, v in d.items() if k not in ("launches", "path")}
                        for r, d in enumerate(dptp)},
              "seg_pretrain": sp[0], "pipeline": {f"rank{r}": x["records"]["pipeline"]
                                                  for r, x in enumerate(ranks)},
              "wall_s": {"reference": ref_s, "dp_ranks": dp_wall, "dp_tp_ranks": dptp_wall,
                         **{k: rec[k] for k in ("step_wall_s", "cli_wall_s",
                                                "seg_pretrain_wall_s", "pipeline_wall_s")}}}
    paths = dict(ranks[0]["paths"])
    paths["dp_tp_train"] = dptp[0]["path"]
    return paths, record


def main() -> int:
    if not (ROOT / "si_mamba_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(si_mamba_tpu_torch/ is missing)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    from si_mamba_tpu_torch.ops.kernels.build import build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    for name, out in build().items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"{name}: {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    records = kernel_phase(device) + backward_kernel_phase(device)
    bf16_records = bf16_kernel_phase(device)
    ssd_bf16_records, bf16_conv_at = ssd_bf16_kernel_phase(device)
    for r in bf16_records:
        if r["name"] in bf16_conv_at:
            at = bf16_conv_at[r["name"]]
            r["at_ssd_shape"] = at["ssd_view"]
            r["at_tp_shapes"] = {k: at[k] for k in ("x_shard", "bc")}
    bf16_records += ssd_bf16_records
    ssd_records, conv_at_ssd_shape = ssd_kernel_phase(device)
    conv_at_tp_shapes = tp_conv_phase(device)
    for r in records:
        if r["name"] in conv_at_ssd_shape:
            r["at_ssd_shape"] = conv_at_ssd_shape[r["name"]]
            r["at_tp_shapes"] = conv_at_tp_shapes[r["name"]]
    records += ssd_records
    seg_shape = seg_kernel_phase(device)
    mae_shapes = mae_kernel_phase(device)
    legacy_shapes = legacy_kernel_phase(device)
    for r in records:
        if r["name"] in seg_shape:
            r["at_seg_shape"] = seg_shape[r["name"]]
        if r["name"] in mae_shapes:
            r["at_pretrain_and_scan_shapes"] = mae_shapes[r["name"]]
    records += split_kernel_phase(device)
    fused_records, fused_routes = fused_mixer_phase(device)
    records += fused_records
    bf16_records += fused_bf16_kernel_phase(device)
    carry_records, carry_paths = ssd_carry_phase(device)
    records += [r for r in carry_records if r["dtype"] == "float32"]
    bf16_records += [r for r in carry_records if r["dtype"] == "bfloat16"]
    fp32_of = {r["name"]: r for r in records}
    for r in bf16_records:  # the fp32 kernel's times from this run, beside
        fp32 = fp32_of[r["name"].removesuffix("_bf16").removesuffix("_sm90")]
        r["fp32_ms"], r["fp32_device_ms"] = fp32["ms"], fp32.get("device_ms")
    for r in bf16_records:
        if r["name"] in mae_shapes:
            r["at_pretrain_and_scan_shapes"] = mae_shapes[r["name"]]
    records += bf16_records
    for r in records:
        if r["name"] in legacy_shapes:
            r["at_legacy_mae_shapes"] = legacy_shapes[r["name"]]

    # the paths, each with every launch count from 0 (set inside each phase)
    paths = {}
    paths["serving"], serving, model, requests = serving_phase(device)
    profile = profile_phase(model, requests)
    del model
    train, paths["train"] = train_phase(device, card)
    grads = gradient_phase(device)
    paths["perf_serving"], perf_serving, model, requests = serving_phase(
        device, MODELNET40, plain_impl="seq", kernels=PERF_EVAL_KERNELS, perf=True,
        tol=PERF_LOGITS_TOL)
    perf_profile = profile_phase(model, requests)
    del model
    perf_train, paths["perf_train"] = train_phase(
        device, card, MODELNET40_PERF, kernels=PERF_TRAIN_KERNELS, eval_kernels=PERF_EVAL_KERNELS,
        view_grads=False)
    paths["ssd_serving"], ssd_serving, model, requests = serving_phase(
        device, MODELNET40_SSD, plain_impl="xla", kernels=("causal_conv1d_silu", "ssd_xbc_fwd"))
    ssd_profile = profile_phase(model, requests)
    del model
    ssd_train, paths["ssd_train"] = train_phase(
        device, card, MODELNET40_SSD,
        kernels=("causal_conv1d_silu", "ssd_xbc_fwd_states", "ssd_xbc_bwd",
                 "causal_conv1d_silu_bwd"),
        eval_kernels=("causal_conv1d_silu", "ssd_xbc_fwd"))
    ssd_grads = gradient_phase(device, MODELNET40_SSD, plain_impl="xla")
    paths["ssd_perf_serving"], ssd_perf_serving, model, requests = serving_phase(
        device, MODELNET40_SSD, plain_impl="xla", kernels=SSD_PERF_EVAL_KERNELS, perf=True,
        tol=PERF_LOGITS_TOL)
    ssd_perf_profile = profile_phase(model, requests)
    del model
    ssd_perf_train, paths["ssd_perf_train"] = train_phase(
        device, card, MODELNET40_SSD_PERF, kernels=SSD_PERF_TRAIN_KERNELS,
        eval_kernels=SSD_PERF_EVAL_KERNELS, view_grads=False)
    paths["fused_serving"], fused_serving, model, requests = serving_phase(
        device, MODELNET40_FUSED, plain_impl="seq", kernels=("fused_mixer_fwd",))
    fused_profile = profile_phase(model, requests)
    del model
    fused_train, paths["fused_train"] = train_phase(
        device, card, MODELNET40_FUSED, kernels=("fused_mixer_fwd_states", "fused_mixer_bwd"),
        eval_kernels=("fused_mixer_fwd",), view_grads=False)
    fused_grads = gradient_phase(device, MODELNET40_FUSED, plain_impl="seq")
    paths["fused_perf_serving"], fused_perf_serving, model, requests = serving_phase(
        device, MODELNET40_FUSED, plain_impl="seq", kernels=FUSED_PERF_EVAL_KERNELS, perf=True,
        tol=PERF_LOGITS_TOL)
    fused_perf_profile = profile_phase(model, requests)
    del model
    fused_perf_train, paths["fused_perf_train"] = train_phase(
        device, card, MODELNET40_FUSED_PERF, kernels=FUSED_PERF_TRAIN_KERNELS,
        eval_kernels=FUSED_PERF_EVAL_KERNELS, view_grads=False)
    paths.update(carry_paths)
    harness_paths, harness = harness_phase(device, card)
    paths.update(harness_paths)
    perf_cli_paths, perf_cli = perf_harness_phase(device, card)
    paths.update(perf_cli_paths)
    ssd_cli_paths, ssd_cli = ssd_preset_cli_phase(device, card)
    paths.update(ssd_cli_paths)
    fused_cli_paths, fused_cli = fused_perf_cli_phase(device, card)
    paths.update(fused_cli_paths)
    seg_paths, seg = seg_phases(device, card)
    paths.update(seg_paths)
    mae_paths, mae = mae_phases(device, card)
    paths.update(mae_paths)
    options_paths, options = options_phases(device, card)
    paths.update(options_paths)
    last_paths, last_modules = last_module_phases(device, card, mae["cli"]["ckpt_last"])
    paths.update(last_paths)
    any_figures, any_paths, any_shapes = slice21_phases(device, card)
    paths.update(any_paths)
    records += slice21_records(any_figures)
    wide_figures, wide_paths, wide_shapes = slice22_phases(device, card)
    paths.update(wide_paths)
    records += slice22_records(wide_figures)
    torch.cuda.empty_cache()  # the ranks share the card
    parallel_paths, parallel = parallel_phases(card)
    paths.update(parallel_paths)
    torch.cuda.empty_cache()
    dp_paths, dp = dp_phases(device, card)
    paths.update(dp_paths)

    # each kernel's launches on every path, and on the path it serves
    main_path = {"causal_conv1d_silu": "serving", "selective_scan_fwd": "serving",
                 "selective_scan_fwd_residuals": "train", "selective_scan_bwd": "train",
                 "causal_conv1d_silu_bwd": "train", "ssd_xbc_fwd": "ssd_serving",
                 "ssd_xbc_fwd_states": "ssd_train", "ssd_xbc_bwd": "ssd_train",
                 "fused_mixer_fwd": "fused_serving", "fused_mixer_fwd_states": "fused_train",
                 "fused_mixer_bwd": "fused_train", "ssd_split_fwd": "tp_ssd_serving",
                 "ssd_split_fwd_states": "tp_ssd_train", "ssd_split_bwd": "tp_ssd_train",
                 "ssd_split_fwd_hfin": "sp", "ssd_split_fwd_states_hfin": "sp_train",
                 "ssd_split_bwd_seeded": "sp_train", "causal_conv1d_silu_bf16": "perf_serving",
                 "selective_scan_fwd_sm90_bf16": "perf_serving",
                 "selective_scan_fwd_residuals_sm90_bf16": "perf_train",
                 "selective_scan_bwd_sm90_bf16": "perf_train",
                 "causal_conv1d_silu_bwd_bf16": "perf_train",
                 "ssd_xbc_fwd_sm90_bf16": "ssd_perf_serving",
                 "ssd_xbc_fwd_states_sm90_bf16": "ssd_perf_train",
                 "ssd_xbc_bwd_sm90_bf16": "ssd_perf_train",
                 "ssd_split_fwd_bf16": "tp_ssd_perf_serving",
                 "ssd_split_fwd_states_bf16": "tp_ssd_perf_train",
                 "ssd_split_bwd_bf16": "tp_ssd_perf_train", "ssd_split_fwd_hfin_bf16": "sp_bf16",
                 "ssd_split_fwd_states_hfin_bf16": "sp_bf16_train",
                 "ssd_split_bwd_seeded_bf16": "sp_bf16_train",
                 "fused_mixer_fwd_bf16": "fused_perf_serving",
                 "fused_mixer_fwd_states_bf16": "fused_perf_train",
                 "fused_mixer_bwd_bf16": "fused_perf_train",
                 **{n: "ssd_carry" for n in CARRY},
                 **{n + "_sm90_bf16": "ssd_carry_bf16" for n in CARRY},
                 **{name: slice21_main_path(name) for name in any_figures},
                 **{name: fig["path"] for name, fig in wide_figures.items()}}
    for r in records:
        r["kernel_ms"] = r["ms"]  # the same time under the field's older name
        r["main_path"] = main_path[r["name"]]
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in paths.items()}
        r["launches"] = r["launches_by_path"][r["main_path"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on its path")
    print(json.dumps({"harness": harness}), flush=True)
    print(json.dumps({"serving": serving, "profile": profile, "train": train,
                      "gradients": grads, "ssd": {"serving": ssd_serving, "profile": ssd_profile,
                                                  "train": ssd_train, "gradients": ssd_grads},
                      "fused": {"serving": fused_serving, "profile": fused_profile,
                                "train": fused_train, "gradients": fused_grads,
                                "mixer_interior_ms": fused_routes},
                      "perf": {"serving": perf_serving, "profile": perf_profile,
                               "train": perf_train, "cli": perf_cli},
                      "ssd_perf": {"serving": ssd_perf_serving, "profile": ssd_perf_profile,
                                   "train": ssd_perf_train, "cli": ssd_cli},
                      "fused_perf": {"serving": fused_perf_serving,
                                     "profile": fused_perf_profile, "train": fused_perf_train,
                                     "cli": fused_cli},
                      "seg": seg, "mae": mae, "options": options,
                      "last_modules": last_modules, "any_shapes": any_shapes,
                      "wide_shapes": wide_shapes,
                      "parallel": parallel,
                      "dp": dp, "card": card}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
