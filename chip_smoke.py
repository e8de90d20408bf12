#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py             # the whole smoke, one card
    python3 chip_smoke.py --profile   # also: torch.profiler over one
                                      # prefill + decode steps of the serving
                                      # path and over one step of each
                                      # training path, each after a warm-up
                                      # call (build/profile_{serve,train,
                                      # zero,long_seq,mlp_fp16,rn50,
                                      # dcgan,mha_self,mha_encdec}.txt)
    python3 chip_smoke.py --variants  # only phases 1-2, then the bf16 flash
                                      # kernels' tile variants timed against
                                      # the shipped ones (TILE_VARIANTS) and
                                      # the dense kernel's (GEMM_VARIANTS)
                                      # against it and cuBLAS; no result
                                      # line
    python3 chip_smoke.py --variants flash   # (or gemm): one study only
    python3 chip_smoke.py --seed 3    # phases 20-21's weights, data and masks

Phases, in order; any failure exits nonzero and prints no result line:

1. environment: torch/CUDA versions and the card's name and power limit
   (``nvidia-smi``); TF32 off for matmuls and cuDNN;
2. build: the CUDA kernels from ``apex_tpu_torch/csrc`` into ``build/``;
3. the forward kernels against their plain PyTorch versions on the card,
   at the serving and the training shapes, with their device time (a CUDA
   graph of 20 calls replayed between CUDA events, median of 10 replays),
   the time of one call with its host cost (CUDA events around the call,
   median of 30), the plain version's and one PyTorch library call's
   device time (the library call is a yardstick the port never calls) and
   the least time the card could take; the forward also at the
   long-sequence shape BH 64 x 4096 x 4096 x 64 bf16 (held to the plain
   version on its first 8 heads, SDPA's forward as the yardstick), and the
   bf16 forward on the edges of its tiles (``FLASH_EDGE_CASES``: Sq and Sk
   of 1, 127, 129, 200 x 333, Sk below one k tile and exactly one, causal
   with Sq != Sk, each bias shape with a dead row (the attention modules'
   (1, Sq, Sk) time mask among them), dropout, D = 32 and 128, the
   two-warpgroup kernels; five of them in fp16), checked and not timed;
3b. the same for the training path's kernels: layer-norm backward,
   cross-entropy forward, the l2norm of the flat master-sized buffer and
   the flash backward (whose dropout case also goes against autograd of
   the plain forward: the backward's mask is the forward's);
3c. the same for this slice's kernels: the ZeRO updates (Adam, LAMB stage
   1) over the BERT-large flat fp32 buffer, and the split flash backward
   (dq, dk/dv) on small cases (causal, key padding with a dead row and
   Sq != Sk, dropout against autograd of the plain forward) and at the
   long-sequence shape BH 64 x 4096 x 4096 x 64 bf16 (held to the plain
   version on its first 8 heads; the plain version's time there is CUDA
   events around one call at the full shape); the bf16 dq, dk/dv and fused
   kernels on ``FLASH_EDGE_CASES`` (the fused kernel's dk and dv must be
   the dk/dv kernel's bits, its dq partials must fill a NaN-filled (BH,
   ceil(Sk / 128), Sq, D) buffer); the two routes' dk and dv bit-equal and
   a CUDA graph of fused and dk/dv calls replaying the eager bits; and the
   fused and dk/dv kernels at D = 32, 64 and 128, timed;
4. serve parity: a 2-layer engine at BERT-large width, fp32, on the card
   and on the CPU with the same weights — prefill logits within 1e-3 and
   the same greedy tokens over 8 decode steps;
5. the serving path: a 24-layer BERT-large-width engine, bf16, ``attn_impl=
   "fast"``, random weights from a seed, serving a seeded trace of 16
   requests through ``ContinuousBatcher.run()``, with every kernel's launch
   count read around that run;
6. training parity: a 2-layer model at BERT-large width, 3 steps of
   ``train_step`` under amp O5 with the fp32 model override, FusedLAMB on
   the flat engine, flash attention and remat, on the card and on the CPU
   from the same weights — losses within 1e-4 relative, flat masters
   within 1e-4;
7. the training path: 24-layer BERT-large, bf16, amp O5 + FusedLAMB
   (``impl="fused"``), flash attention, remat, batch 8 x 512, one warm-up
   and 5 timed steps of ``apex_tpu_torch.train.train_step``, with every
   kernel's launch count read around the timed steps;
8. ZeRO parity: a 2-layer model at BERT-large width, fp32 activations, 3
   steps of ``zero_train_step`` with ``DistributedFusedLAMB(impl=
   "fused")`` and then ``DistributedFusedAdam(impl="fused")`` at world 1,
   on the card over NCCL and on the CPU over a gloo group, from the same
   weights — losses within 1e-4 relative; LAMB's master shards within
   1e-4, Adam's 3-step update within 1e-3 relative in norm (its eps 1e-8
   lets elements with near-zero gradients differ by up to lr a step);
9. the ZeRO path (the BERT example's ``--bert-large --zero --remat --attn
   fast``): 24-layer BERT-large, fp32 params, bf16 activations, synthetic
   MLM batches of 8 x 512, ``DistributedFusedLAMB(lr=1e-3, weight_decay=
   0.01, max_grad_norm=1.0, bf16_allgather=True, impl="fused")`` on a
   world-1 NCCL group, one warm-up and 5 timed steps, then one warm-up and
   3 timed steps under ``DistributedFusedAdam(lr=1e-4, impl="fused")``,
   launch counts read around each timed run; then 4 steps of Adam at lr
   1e-3 read twice, through the kernel and through ``impl="xla"``, the two
   loss trajectories within 2e-2 relative;
10. the long-sequence path (the BERT example's ``--layers 24 --d-model 1024
   --heads 16 --vocab 30592 --seq-len 4096 --batch-size 4 --attn fast
   --remat``): amp O5 + FusedLAMB as phase 7 at batch 4 x 4096, one warm-up
   and 2 timed steps; every flash backward takes the split route;
3d. (run after 3c) the fp16 slice's kernels: the fused dense + activation
   kernels at the MLP's three layer shapes (8192 x 1024 @ 1024 x 4096, 8192
   x 4096 @ 4096 x 4096, 8192 x 4096 @ 4096 x 1024) in fp16 and bf16 with
   relu, the middle shape also with sigmoid, none and no bias, on the TMA
   route's tails (M 8191 and 1, K 1000, N 136), on a misaligned x and
   ragged shapes (the mma.sync route) and in fp32; each case's route as
   ``_route`` names it (confirmed after phase 13) and a second call's bits
   equal to the first's; ``multi_tensor_scale`` over the MLP's flat
   buffer and 134,217,728 elements, fp32 and fp16 in, fp32 out, and
   ``multi_tensor_axpby`` at both sizes in fp32, each also with an inf
   injected (the flag must be set);
11. MLP fp16 parity: ``MLP([1024, 4096, 4096, 1024])`` in fp16, batch
   256, 3 steps of ``mlp_train_step`` under ``FP16_Optimizer(FusedAdam(
   impl="fused"), dynamic_loss_scale=True)``, step 2's batch carrying an
   inf, on the card and on the CPU from the same weights — the same skip
   pattern and loss scales, losses within 1e-3 relative, the 3-step update
   of the flat fp32 masters within 0.1 relative in norm;
12. the MLP fp16 path: the same at batch 8192, one warm-up and 5 timed
   steps, step time, samples/s, analytic MFU, peak memory and the step
   split into forward, backward and ``opt.step``, launch counts read
   around the timed steps; then 4 steps at lr 1e-3 as a witness of the
   optimizer's trajectory (it overshoots at this width);
13. the ``multi_tensor_applier`` path: ``multi_tensor_scale`` and
   ``multi_tensor_axpby`` through the facade over the MLP's six
   parameter-shaped tensors, each against its plain version, with the
   launch counts of the two calls;
14. ResNet-50 parity, card vs CPU, full width (64, stages 3-4-6-3, 1000
   classes), batch 8 x 224^2 x 3 from the example's synthetic pool: the
   loss and the gradients of every leaf in float64 (within 1e-9 / 1e-8
   relative), the fp32 gradients of each device against the CPU's
   float64 ones (both ~3 %: the network's own fp32 conditioning), then 3
   steps of ``resnet_train_step`` in fp32 under amp O0 + FusedAdam, step
   1's loss within 1e-5 relative and running statistics within 1e-4, the
   three losses within 5e-2;
15. the ResNet-50 path of ``examples/imagenet/main_amp.py``: config 2
   (amp O2 + ``FusedAdam(lr=1e-3)``, bf16 activations, fp16 weights, fp32
   batch norm, global batch 128 x 224^2 from a seeded copy of the
   example's learnable prototype pool built on the card), its first 3
   steps under ``cudnn.deterministic`` as a reference, then one warm-up
   (absorbing ``cudnn.benchmark``'s autotuning) and 20 timed steps: step
   time, images/s, analytic MFU (the convolutions' and fc's FLOPs counted
   from their shapes, x 3, over 989 TFLOP/s), peak memory, the skipped
   steps, a falling loss and the step split into forward, backward and
   ``amp_step``; then config 3 (``--distributed --sync-bn``:
   ``DistributedDataParallel`` and every batch norm synced over a world-1
   NCCL group), whose first 3 steps must be config 2's bits under
   ``cudnn.deterministic``, then one warm-up and 5 timed steps; around both
   timed runs each of the 13 kernels must launch 0 times;
16. the amp O1 / O4 cast table: every callable of
   ``amp/lists/torch_overrides.py`` under ``amp.autocast(bf16)`` and
   ``amp.autocast(fp16)`` on the card and on the CPU, three dtype mixes
   (all low precision, all fp32, the first fp32 and the rest low
   precision): the same output dtypes, values within 2e-2 (bf16) / 4e-3
   (fp16) of max(1, |cpu|), no torch function mode left after ``uninit``;
17. config 1, the toy DDP example (``examples/simple/distributed``'s
   defaults: 512 -> 256 -> 32, global batch 64, amp O1, ``FusedSGD(lr=0.1,
   momentum=0.9)``, ``simple_ddp_train_step`` on a world-1 NCCL group):
   card vs CPU over 3 steps (losses within 1e-3 relative, the same
   scales), then one warm-up and 100 timed steps: a falling loss, step
   time, samples/s, 0 launches of the 13 kernels;
18. config 5, DCGAN (``examples/dcgan/main_amp.py``'s defaults:
   ``DCGANConfig()``, batch 64, amp O4, two ``FusedAdam(lr=2e-4, betas=
   (0.5, 0.999))``, D with two scaled losses, G with a third): (a) card vs
   CPU at batch 8 from the same weights, the gradients of D's real loss
   and G's loss and one ``dcgan_train_step``: in float64 (gradients and
   losses 1e-6 relative: the logits stay fp32), under O0 (fp32 gradients ~0.17 %
   from float64 on both devices: the card's no farther than 1.25 x the
   CPU's + 1e-3, one step's losses within 1e-4) and under O4 (the card's
   bf16 gradients no farther from its fp32 ones than 1.25 x the CPU's +
   0.01, the devices' within 1.5 x the CPU's distance of each other,
   losses 2e-2); (b) one warm-up and
   20 timed steps: step time, images/s, peak
   memory, the D-real / D-fake / G losses, the three loss scales (1.0),
   no skipped step, 0 launches of the 13 kernels;
19. checkpoints and the resumable data plane (the imagenet example's
   ``--data`` / ``--save`` / ``--resume``): (a) ResNet-50 config 2 at
   full width under ``cudnn.deterministic``, fed by a ``ShardedLoader``
   over 4 ``.npz`` shards of 1,024 uint8 224^2 records written under
   ``build/phase19`` (~154 MB, seed 0): 6 steps straight against 3
   steps, ``CheckpointManager(keep_last=2).save`` (the loader's
   ``data_meta()`` and ``cursor(3)`` in the manifest), a state from seed
   1, ``load_latest`` -> ``resnet_resume`` -> ``seek(3)`` -> 3 steps: the
   same 6 losses and bits in weights, masters, Adam m / v / count,
   running statistics and scaler; that state through ``save_sharded`` /
   ``load_sharded`` on a world-1 NCCL group, the same bits; (b) a truncated newest checkpoint
   (``CheckpointError``, ``latest()`` the one before) and a flipped byte
   in a shard (``ShardChecksumError`` naming shard and offset); (c) the
   O5 BERT step of phase 7 at full width cut to 2 layers: 4 steps
   straight against 2 + save / load (bf16 leaves, the FusedLAMB state) +
   2, the same bits, ``ml_dtypes`` never imported, the kernels' launch
   counts; (d) save / verify / load / restore times, MB and MB/s, the
   shard scan and the loader's wait per batch;
21. (run after 19, before 20: no profiler window precedes it) fp16
   through the kernels and the slice's new modules: (a) the fp16 instance
   of #1-#7, #9 and #12's model copy against its plain version at the
   shapes its paths give it (#1 / #4 at the MHA stacks' BH 1920 x 64 x
   64 / 96 x 64 with the (B, 1, Sk) key padding and dropout 0.1 from one
   int seed; #2 / #3 on the split route at the long shape, held on its
   first 8 heads; #5 / #6 at 7,680 x 1024 and 4096 x 1024 with fp16
   gamma / beta; #7 at 32,768 x 256 and 4096 x 30,592; #9 and #12's fp16
   copy over 25,296,896 elements), each timed beside its bf16 instance,
   the plain version and the fp16 library call; (b) the MHA perf test in
   its own dtype: 18 fp16 ``SelfMultiheadAttn`` layers as 20b's, its
   first two layers held to the same layers in fp32 on the card (1e-2
   relative in norm, one int dropout seed), then forward and backward
   timed with no optimizer (1 warm-up + 10), fast then default, exactly
   18 each of #1, #4, #5 and #6 a step; (c) the byte mLSTM of Radford et
   al. 2017 (vocab 256, a 64-wide embedding, a 4096-unit mLSTM with
   weight norm on its four weights, a 4096 -> 256 decoder): card vs CPU
   in fp32 at full width, T 8 x B 4 (the loss, the final state and every
   gradient, g and v included, 1e-4 on the peak rule), then fp16 under
   ``FP16_Optimizer(FusedAdam(lr=5e-4))`` with a dynamic scale from
   2^16, batch 128 x 256 bytes of a seeded peaked Markov chain, the
   hidden state carried across steps, 1 warm-up + 3 timed steps: step
   time, bytes/s, analytic MFU, peak memory, the scales and skipped
   steps, a falling loss, exactly one #7 a step; (d) ASP on phase 7's O5
   step: 2:4 masks of ``wqkv``, ``wo``, ``w1``, ``w2`` computed on the
   card (layers 0 and 23 the CPU's bits), pruned, FusedLAMB wrapped and
   reached through amp's flat path, 1 warm-up + 3 timed steps, the bf16
   model and the fp32 master 2:4 after each, the masks recomputing to
   themselves, exactly phase 7's launches, the step beside phase 7's;
26. (run after 21, before 20: no profiler window precedes its timed
   steps) the collective schemes, the overlapped DDP buckets and zero1,
   all on a world-1 NCCL group (a collective is a copy there: this shows
   correctness, launch order and bytes, not hidden wire time): (a) each of
   fp32, bf16, int8_blockscale and adasum through ``allreduce_tree`` at
   2^16, 2^20 and 2^23 elements, equal to the plain math on the card (fp32
   and adasum the input, bf16 one rounding, int8 ``dequantize(quantize(
   x))``), the codec's codes and scales the CPU's bits on the same data,
   the metered logical and wire bytes (int8 >= 3.5x), each timed; the flat
   reduce-scatter and all-gather of each scheme at 334,233,600 elements;
   (b) the flagship DDP step (``train.build_flagship_step``: BERT-large,
   fp32 params and activations, flash attention, batch 8 x 512,
   ``FusedAdam(impl="fused", lr=1e-4)``), 1 warm-up + 4 timed steps in
   each of ``FLAGSHIP_MODES`` from the same weights: off, bucketed, zero1
   and zero1 + bucketed bit-equal in losses and parameters, the int8
   all-gather's losses within 5 % and its metered ratio >= 3.5, bucket 0
   launched before the last gradient hook, one bucketed step under
   ``set_sync_debug_mode("error")``, each mode's launches of #1 / #4 /
   #5 / #6 / #7 exactly the step's without DDP; (c) ResNet-50 config 3
   under ``APEX_TPU_OVERLAP=bucketed`` against ``off``, 1 + 3 steps each
   under ``cudnn.deterministic``: the same bits; (d) phase 9's ZeRO LAMB
   step with ``collective_scheme="int8_blockscale"`` and its
   error-feedback residual, 1 + 3 steps, against the fp32 scheme: losses
   within 5 %, the residual finite and not all zero, the same launches;
   (e) phase 5's engine and 16-request trace at ``olevel="int8"``: every
   request done, no ledger violation, compression ratio >= 3.5, #1 and #5
   launched as often as by phase 5's bf16 engine, tokens/s beside phase
   5's;
27. (run after 26, before 20) sequence, pipeline and expert parallelism
   on a world-1 NCCL group (a collective is a copy: paths, launches and
   numbers, not wire time): (a) ``ulysses_flash_attention`` at (1, 16,
   4096, 64) bf16, causal and not, bit-equal in out, dq, dk and dv to the
   flash kernels called directly, one #1 and one backward (by the fuse
   rule) a call; ``ring_attention`` and ``ulysses_attention`` at (2, 16,
   2048, 64) fp32 against plain attention, gradients included (1e-4,
   peak rule), no kernel launch; (b) ``SelfMultiheadAttn(1024, 16,
   impl="ulysses", seq_inner_impl="fast", causal=True)`` and
   ``impl="ring"`` at 64 x 120 tokens against ``impl="default"`` with
   the causal time mask (2e-3, peak rule), #1 and #4 once a call for the
   first; (c) the switch-MoE step at BERT-large's widths with 8 experts
   (1.74 B parameters) through the ep engine at world 1, fp32, 8 x 512,
   ``FusedAdam(impl="fused", lr=1e-4)``, 1 + 4 steps on one batch: a
   falling loss, a finite aux loss, exactly #1 24, #4 24, #5 49, #6 49,
   #7 1 a step, step ms, tokens/s and peak memory; (d) the sp engine (ring
   and Ulysses) at the flagship's width, 1 + 2 steps, each loss within 2e-2
   relative (or 5e-3) of phase 26's off step from the same weights,
   exactly #5 50, #6 50, #7 1 a step and no flash; (e) ``pipeline_apply``
   at one stage over 4 microbatches of the flagship batch: output and
   layer gradients within 1e-5 of their peaks of the plain stack;
28. (run after 27, before 20) the tensor-parallel family and the planner
   on a world-1 NCCL group: (a) ``_build_tp_step`` with a model axis
   of 1 at the flagship's width (plain attention and the vocab-parallel
   cross-entropy, as the JAX tp engine runs), fp32, 8 x 512, lr 1e-4, on
   phase 26's batches, 1 + 4 steps: step 0 within 1e-5 relative of phase
   26 off's, every step within 2e-2 relative (or 5e-3); then the bf16
   model copy, 1 + 4 steps: fp32 master, finite and falling; exactly #5
   50 and #6 50 a step, nothing else; the all-reduce tape equal to the
   static schedule; step ms, tokens/s, peak memory; (b) phase 5's engine
   and trace through ``InferenceEngine(mesh=)`` with a model axis of 1:
   phase 5's tokens and launches, and 8 prefills and 3 decode steps
   bit-equal to the plain engine's; (c) ``flagship_profile()`` at
   BERT-large, global batch 8, on the h100 row, ``format_plans(search())``
   at 1, 4 and 8 chips, and Plan(dp=1)'s predicted step ms and memory
   beside the measured ones;
20. the attention modules on the stack of apex's
   ``perf_test_multihead_attn.py`` (hidden 1024, 16 heads, 64 tokens):
   (a) card vs CPU, 2 layers, 8 sequences, output and every parameter's
   gradient, fp32 within 1e-4 on the peak rule, bf16 within 2e-2 (the
   output on the peak rule, the gradients relative in norm: their small
   elements carry the cancellation of bf16 sums): fast and
   default under no mask, key padding, an additive mask, a time mask and
   the causal one; fast with dropout 0.1 and an int kernel seed (the same
   counter-hash mask on both devices), encdec included; (b) 18 x
   ``SelfMultiheadAttn(1024, 16, dropout=0.1, bias=True,
   include_norm_add=True)``, 120 x 64 tokens, bf16 activations, fp32
   params, ragged key padding from ``--seed`` (default 0),
   ``FusedNovoGrad(lr=1e-2, impl="fused")`` through
   ``train.mha_train_step``, one warm-up and 10 timed steps (step time,
   tokens/s, analytic MFU, peak memory, the step's parts, a falling loss,
   exactly 18 flash forwards, fused backwards and layer norms each way a
   step, every other kernel 0), then the same with ``impl="default"``
   (the perf test's ``--ref``) and the ratio; (c) the same for 18 x
   ``EncdecMultiheadAttn(1024, 16, dropout=0.1, include_norm_add=True)``,
   64 queries against 96 encoder positions, ``FusedAdagrad(lr=1e-3,
   impl="fused")``; (d) one full-width layer under each time mask: the
   strict upper triangle reaches the kernels as a zero (1, 1, S) bias
   with ``causal=True``, any other (Sq, Sk) time mask as a (1, Sq, Sk)
   bias, each held to ``impl="default"`` on the card (2e-3);
22. the dense cases of phase 3d once more under ``torch.profiler``: the
   dense kernels it lists must be the kernels ``_route`` names (run last,
   so that no profiler session precedes the timed paths);
22b. (phases 23-25, last) the telemetry on the serving and O5 paths
   (23), the self-resuming guard (24), and the profiling layer on the
   port's own traces (25: ``pyprof.trace`` over the O5 and ZeRO LAMB
   steps decomposed per device step window, their host syncs, the per-op
   and peak-memory tables of one O5 step held to ``FlopCounterMode`` and
   the allocator, the sentinel's ``slow_step_timeline`` dump, the fleet
   view over phase 24's two ResNet-50 hosts; a trimmed trace of one step
   lands in ``chiprun_out/phase25/``);
23. one ``{"kernels": [...]}`` line: each kernel's launches from the path
   it serves (``launches_by_path`` gives every path's count, the
   ResNet-50, toy-DDP, DCGAN and phase-19 ResNet-50 paths' 0 included, the
   phase-19 BERT leg's and phases 20's and 21's counts; ``fp16`` the fp16
   instance's row of 21a), then the card's name
   and power limit, then the last line ``{"ok": true, "device": {...}}``.
   Every process group is destroyed before exit.

Tolerances: an element passes when ``|kernel - plain| <= tol *
max(1, |plain|)``, with tol = 1e-5 (layer-norm forward, cross-entropy,
fp32), 1e-4 (flash, layer-norm backward, fp32), 2e-2 (bf16: the two
versions may round one value to neighbouring bf16 numbers, 2^-8 apart
relative to the value).  Attention's outputs and the flash backward's
gradients (fused and split) may lie far below 1 (at 4096 keys the output
is ~0.02), so for them the floor of 1 drops to the tensor's largest
|plain|: ``tol * max(|plain|, min(1, max|plain|))``.  ``mean`` is held to 1e-5 and ``invvar`` and the
live rows' ``lse`` to 1e-4 relative; dead rows' lse must be exactly +1e30.
The l2norm is held to 1e-5 relative (fp32 sums in other orders) and must
repeat bit for bit.  The Adam and LAMB stage-1 kernels are held to 1e-6
relative (the same IEEE operations in the same order as the plain
version).  The scale and axpby kernels must give the plain versions' bits
and flags.  The fused dense kernel: fp32 1e-5, bf16 2e-2, fp16 4e-3 (both
versions round one fp32 value whose sums ran in other orders).  The fp16
instances of the other kernels (phase 21a and the fp16 edge cases): an
output within 5e-3 (the peak rule for attention), a gradient within 2e-3
relative in norm, fp32 results of fp16 inputs at their fp32 limits, the
fp16 model copy within 1e-3 relative.
``max_abs_err`` reports the plain absolute difference.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# the BERT-large flat fp32 buffer (FusedLAMB's, the l2norm's; the ZeRO shard
# at world 1 is the same parameters on a 128-element lattice)
FLAT_N = 334_233_600
# the long-sequence path's attention: batch, heads, sequence, head dim
LONG_SHAPE = (4, 16, 4096, 64)

# peak rates of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

LN_REPLACES = "apex_tpu/ops/layer_norm.py:52"
FLASH_REPLACES = "apex_tpu/contrib/multihead_attn/flash.py:276"
LN_BWD_REPLACES = "apex_tpu/ops/layer_norm.py:72"
FLASH_BWD_REPLACES = "apex_tpu/contrib/multihead_attn/flash.py:541"
XENT_REPLACES = "apex_tpu/contrib/xentropy/softmax_xentropy.py:56"
L2NORM_REPLACES = "apex_tpu/multi_tensor_apply/kernels.py:158"
FLASH_DQ_REPLACES = "apex_tpu/contrib/multihead_attn/flash.py:459"
FLASH_DKV_REPLACES = "apex_tpu/contrib/multihead_attn/flash.py:495"
ADAM_REPLACES = "apex_tpu/multi_tensor_apply/kernels.py:201"
LAMB1_REPLACES = "apex_tpu/multi_tensor_apply/kernels.py:243"
DENSE_REPLACES = "apex_tpu/ops/fused_mlp.py:32"
SCALE_REPLACES = "apex_tpu/multi_tensor_apply/kernels.py:120"
AXPBY_REPLACES = "apex_tpu/multi_tensor_apply/kernels.py:136"

# the fp16 MLP path (bench_kernels.py:685-690): sizes and batch
MLP_SIZES = [1024, 4096, 4096, 1024]
MLP_BATCH = 8192
# the second, larger size the flat kernels are measured at
BIG_FLAT_N = 134_217_728
DENSE_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 4e-3}
ALL_KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
               "ln_fwd", "ln_bwd", "xent_fwd", "l2norm", "adam",
               "lamb_stage1", "mt_scale", "mt_axpby", "dense_act")

# kernel launches a training step makes at 24 layers with remat, by path
# (a kernel at 0 must not launch on that path)
_LAYERS = {"flash_fwd": 48, "ln_fwd": 98, "ln_bwd": 50, "xent_fwd": 1}
TRAIN_LAUNCHES_PER_STEP = {
    "o5_lamb": dict(_LAYERS, flash_bwd=24, l2norm=1),
    "zero_lamb": dict(_LAYERS, flash_bwd=24, lamb_stage1=1, l2norm=0,
                      adam=0),
    "zero_adam": dict(_LAYERS, flash_bwd=24, adam=1, lamb_stage1=0,
                      l2norm=0),
    "long_seq": dict(_LAYERS, flash_bwd_dq=24, flash_bwd_dkv=24,
                     flash_bwd=0, l2norm=1),
    # exactly these counts, every other kernel 0 (FusedAdam's step_flat is
    # eager PyTorch, as the JAX package's is XLA)
    "mlp_fp16": dict({k: 0 for k in ALL_KERNELS}, dense_act=3, mt_scale=1),
    # ResNet-50 (configs 2 and 3): convolutions in cuDNN, batch norm, amp
    # and FusedAdam(impl="xla") eager PyTorch, as the JAX package's are XLA
    "rn50": {k: 0 for k in ALL_KERNELS},
    # the toy DDP example under O1 (config 1) and DCGAN under O4 (config 5):
    # cuBLAS / cuDNN products and eager FusedSGD / FusedAdam(impl="xla"), as
    # the JAX examples' are XLA
    "simple_ddp_o1": {k: 0 for k in ALL_KERNELS},
    "dcgan_o4": {k: 0 for k in ALL_KERNELS},
    # phase 19's O5 BERT leg at 2 layers: phase 7's counts a layer
    "ckpt_o5": dict(flash_fwd=4, ln_fwd=10, ln_bwd=6, xent_fwd=1,
                    flash_bwd=2, l2norm=1),
    # phase 20's 18-layer attention stacks with norm-add, exactly: a step
    # is one flash forward and one fused backward a layer (the dq partials,
    # 1920 x 1 x 64 x 64 fp32 ~31 MB, stay under the fuse cap) and one
    # layer norm each way; FusedNovoGrad / FusedAdagrad are eager PyTorch
    # on the flat engine, as the JAX package's are XLA; impl="default"
    # runs attention in plain PyTorch, the layer norms still in kernels
    "mha_self": dict({k: 0 for k in ALL_KERNELS}, flash_fwd=18,
                     flash_bwd=18, ln_fwd=18, ln_bwd=18),
    "mha_encdec": dict({k: 0 for k in ALL_KERNELS}, flash_fwd=18,
                       flash_bwd=18, ln_fwd=18, ln_bwd=18),
    "mha_self_default": dict({k: 0 for k in ALL_KERNELS}, ln_fwd=18,
                             ln_bwd=18),
    "mha_encdec_default": dict({k: 0 for k in ALL_KERNELS}, ln_fwd=18,
                               ln_bwd=18),
    # phase 20d: four single layers, no norm-add, each a forward and a
    # backward through the kernels (a "step" is the whole phase)
    "mha_time_mask": dict({k: 0 for k in ALL_KERNELS}, flash_fwd=4,
                          flash_bwd=4),
    # phase 21b: the 18-layer self stack in fp16, forward + backward with no
    # optimizer (a "step"), exactly; `--ref` the layer norms only
    "fp16_mha_self": dict({k: 0 for k in ALL_KERNELS}, flash_fwd=18,
                          flash_bwd=18, ln_fwd=18, ln_bwd=18),
    "fp16_mha_self_default": dict({k: 0 for k in ALL_KERNELS}, ln_fwd=18,
                                  ln_bwd=18),
    # phase 21c: the byte mLSTM, exactly: its loss is the one kernel
    # (matmuls in cuBLAS, the cells and weight norm eager PyTorch, the
    # legacy FP16_Optimizer over FusedAdam's per-leaf math)
    "rnn_lm_fp16": dict({k: 0 for k in ALL_KERNELS}, xent_fwd=1),
}
# phase 28a: the tp engine at the flagship's width, fp32 and bf16 model
# copy: plain attention and the vocab-parallel cross-entropy (the JAX tp
# engine's configuration), so the layer norms alone, each way, exactly
for _path in ("tp_train", "tp_train_bf16"):
    TRAIN_LAUNCHES_PER_STEP[_path] = dict({k: 0 for k in ALL_KERNELS},
                                          ln_fwd=50, ln_bwd=50)
# phase 21d: ASP on phase 7's step launches exactly what phase 7 does
TRAIN_LAUNCHES_PER_STEP["asp_o5_lamb"] = dict(
    {k: 0 for k in ALL_KERNELS}, **TRAIN_LAUNCHES_PER_STEP["o5_lamb"])
# numbers a later phase reads beside its own (phase 7's step for 21d)
RESULTS = {}
# paths that launch none of the 13 kernels: every kernel's line lists
# them, as it lists every path of TRAIN_LAUNCHES_PER_STEP
ZERO_PATHS = ("rn50_o2", "rn50_ddp", "simple_ddp_o1", "dcgan_o4",
              "ckpt_rn50", "guard_rn50", "ddp_collectives",
              "rn50_ddp_bucketed")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase header also gets the seconds since start."""
    if msg.startswith("== "):
        msg = f"{msg}  [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` launches, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph, the
    graph replayed between two CUDA events, median over ``reps`` replays,
    divided by ``n`` — the host's launch cost is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def check_launches(path: str, launches, steps: int,
                   exact: bool = False) -> None:
    """Every kernel of ``path`` launched at least (``exact``: exactly) its
    per-step count in ``steps`` steps; a kernel listed at 0 not at all."""
    for name, per_step in TRAIN_LAUNCHES_PER_STEP[path].items():
        got = launches.get(name, 0)
        if exact:
            require(got == steps * per_step,
                    f"{path}: {name} launched {got} times in {steps} steps, "
                    f"expected {per_step} a step")
        elif per_step == 0:
            require(got == 0, f"{path}: {name} launched {got} times in "
                    f"{steps} steps, expected none")
        else:
            require(got >= steps * per_step,
                    f"{path}: {name} launched {got} times in {steps} "
                    f"steps, expected at least {per_step} a step")


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_ok(got, ref, tol: float):
    """(all elements within tol * max(1, |ref|), max absolute error)."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= tol * ref.float().abs().clamp(min=1.0)).all())
    return ok, float(err.max())


def peak_ok(got, ref, tol: float):
    """(all elements within tol * max(|ref|, min(1, max|ref|)), max
    absolute error): :func:`scaled_ok` with its floor of 1 lowered to the
    tensor's largest value, for gradients whose values lie far below 1."""
    err = (got.float() - ref.float()).abs()
    a = ref.float().abs()
    ok = bool((err <= tol * a.clamp(min=min(1.0, float(a.max())))).all())
    return ok, float(err.max())


def rel_err(got, ref) -> float:
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def phase_environment():
    import torch
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from apex_tpu_torch.utils import build
    log("== phase 2: build")
    res = build.build()
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas: {line.strip()}")
    build.library()
    log(f"built {res.path.relative_to(HERE)} in {res.seconds:.1f} s "
        f"(cached: {res.cached})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(shape, gen, dtype, dev, scale=1.0, shift=0.0):
    import torch
    return (torch.randn(shape, generator=gen) * scale + shift).to(dev, dtype)


def check_layer_norm(dev):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.layer_norm import ln_fwd, ln_fwd_reference
    rows = []
    gen = torch.Generator().manual_seed(0)
    # (7,680 x 1024): the MHA stacks' tokens, in bf16 beside phase 21a's
    # fp16
    for n, h in ((512, 1024), (8, 1024), (4096, 1024), (7680, 1024)):
        for dtype in ("bfloat16", "float32"):
            for affine in (True, False):
                dt = getattr(torch, dtype)
                x = _randn((n, h), gen, dt, dev, 2.0, 0.5)
                w = _randn((h,), gen, dt, dev) if affine else None
                b = _randn((h,), gen, dt, dev) if affine else None
                out, mean, inv = ln_fwd(x, w, b, 1e-5)
                torch.cuda.synchronize()
                r_out, r_mean, r_inv = ln_fwd_reference(x, w, b, 1e-5)
                tol = 1e-5 if dtype == "float32" else 2e-2
                ok, err = scaled_ok(out, r_out, tol)
                m_err = float((mean - r_mean).abs().max())
                i_err = rel_err(inv, r_inv)
                require(ok and m_err <= 1e-5 and i_err <= 1e-4,
                        f"ln_fwd ({n},{h}) {dtype} affine={affine}: out err "
                        f"{err:.3g} (tol {tol}), mean {m_err:.3g}, invvar "
                        f"{i_err:.3g}")
                es = x.element_size()
                nbytes = 2 * n * h * es + 2 * n * 4 + (2 * h * es if affine
                                                       else 0)
                bms, by = bound(nbytes, 8.0 * n * h, "float32")
                ms = device_ms(lambda: ln_fwd(x, w, b, 1e-5))
                call_ms = time_ms(lambda: ln_fwd(x, w, b, 1e-5))
                pms = device_ms(lambda: ln_fwd_reference(x, w, b, 1e-5))
                lms = device_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
                l_call = time_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
                row = dict(shape=(n, h), dtype=dtype, affine=affine,
                           max_abs_err=err, tol=tol, mean_err=m_err,
                           invvar_rel_err=i_err, ms=ms, call_ms=call_ms,
                           plain_ms=pms, library_ms=lms, bound_ms=bms,
                           bound_by=by)
                rows.append(row)
                log(f"  ln_fwd ({n},{h}) {dtype:8s} affine={affine!s:5s} "
                    f"out err {err:.3g} (tol {tol}) mean {m_err:.2g} "
                    f"invvar {i_err:.2g} | kernel {ms:.5f} ms (one call "
                    f"with its host cost {call_ms:.4f} ms)  plain {pms:.5f} "
                    f"ms  F.layer_norm {lms:.5f} ms (one call {l_call:.4f} "
                    f"ms)  bound {bms:.5f} ms ({by})")
    return rows


def _flash_inputs(B, heads, sq, sk, d, kind, gen, dt, dev):
    import torch
    bh = B * heads
    q = _randn((bh, sq, d), gen, dt, dev, 1.0 / d ** 0.5)
    k = _randn((bh, sk, d), gen, dt, dev)
    v = _randn((bh, sk, d), gen, dt, dev)
    if kind == "zeros":
        bias = torch.zeros((1, 1, sk))
    elif kind == "key_pad":   # (1, 1, Sk): the last keys padded for all
        bias = torch.zeros((1, 1, sk))
        bias[..., max(1, sk - 5):] = -1e9
    elif kind == "all_dead":  # (1, 1, Sk): every key masked, every row dead
        bias = torch.full((1, 1, sk), -1e30)
    elif kind == "time_dead":  # (1, Sq, Sk): a time mask with a dead row
        bias = torch.where(torch.rand((1, sq, sk), generator=gen) < 0.3,
                           torch.full((), -1e9), torch.zeros(()))
        bias[0, sq // 2, :] = -1e30
    elif kind == "masked":  # (1, Sq, Sk): rows whose every key is -1e9
        bias = torch.zeros((1, sq, sk))
        bias[0, 4::5, 3:] = -1e9
        bias[0, :4, :] = -1e9
        bias[0, ::7, :] = -1e9
    elif kind == "batch_pad_dead":  # (B, 1, Sk): the last batch row dead
        bias = torch.zeros((B, 1, sk))
        for b_ in range(B):
            bias[b_, :, max(1, sk - 3 - 2 * b_):] = -1e9
        bias[B - 1] = -1e30
    else:   # (B, Sq, Sk): key padding per batch row plus one dead query row
        bias = torch.zeros((B, sq, sk))
        for b_ in range(B):
            bias[b_, :, max(1, sk - 7 - 5 * b_):] = -1e9
        bias[B - 1, sq // 2, :] = -1e30
    return q, k, v, bias.to(dev)


# Edge cases of the bf16 flash kernels' tiles (the forward: 128 keys a
# stage, 64 or 128 query rows a CTA; dq: 64 keys a stage; the fused and
# dk/dv kernels: 128 keys a CTA, 64 query rows a stage): held to the plain
# versions, not timed.  name, B, heads, Sq, Sk, D, bias, causal, dropout[,
# dtype: bf16 unless a case names fp16]
FLASH_EDGE_CASES = [
    ("s1", 1, 4, 1, 1, 64, "zeros", False, 0.0),
    ("s1_causal", 1, 4, 1, 1, 64, "key_pad", True, 0.0),
    ("s127", 1, 4, 127, 127, 64, "key_pad", True, 0.0),
    ("s129", 2, 2, 129, 129, 64, "batch_pad_dead", False, 0.0),
    ("s200x333", 2, 2, 200, 333, 64, "pad_dead", False, 0.0),
    ("sk_below_tile", 2, 2, 100, 40, 64, "key_pad", False, 0.0),
    ("sk_one_dq_tile", 2, 2, 130, 64, 64, "batch_pad_dead", False, 0.0),
    ("sk_one_fwd_tile", 2, 2, 130, 128, 64, "key_pad", False, 0.0),
    ("causal_sq_lt_sk", 2, 2, 200, 333, 64, "batch_pad_dead", True, 0.0),
    ("causal_sq_gt_sk", 2, 2, 333, 200, 64, "pad_dead", True, 0.0),
    ("all_dead", 1, 2, 64, 96, 64, "all_dead", False, 0.0),
    ("dropout", 2, 2, 129, 200, 64, "pad_dead", True, 0.1),
    ("d32", 2, 2, 127, 129, 32, "batch_pad_dead", True, 0.1),
    ("d128", 2, 2, 200, 333, 128, "pad_dead", False, 0.0),
    # 132+ CTAs of 128 rows: the two-warpgroup kernels
    ("wide_ragged", 2, 66, 200, 333, 64, "pad_dead", True, 0.1),
    ("wide_d32", 2, 66, 127, 100, 32, "key_pad", True, 0.0),
    ("wide_d128", 2, 66, 129, 129, 128, "batch_pad_dead", False, 0.0),
    # the edges of the 128-key tiles and of the 64-row q stages: Sk one
    # under, at and one over a key tile and one under two; Sq under one
    # stage, at one and one row over; causal with Sq != Sk across the
    # diagonal of a 128-key tile; D = 32 and 128 with dropout
    ("sk127_sq64", 2, 2, 64, 127, 64, "pad_dead", False, 0.0),
    ("sk128_sq40", 2, 2, 40, 128, 64, "batch_pad_dead", False, 0.0),
    ("sk129_sq65", 2, 2, 65, 129, 64, "key_pad", False, 0.0),
    ("sk255_causal", 2, 2, 65, 255, 64, "batch_pad_dead", True, 0.0),
    ("causal_sq300_sk130", 2, 2, 300, 130, 64, "pad_dead", True, 0.0),
    ("causal_sq130_sk300", 2, 2, 130, 300, 64, "key_pad", True, 0.0),
    ("d32_dropout_sk255", 2, 2, 130, 255, 32, "pad_dead", True, 0.1),
    ("d128_dropout_sk129", 2, 2, 65, 129, 128, "batch_pad_dead", True, 0.1),
    # a (1, Sq, Sk) bias, the attention modules' non-causal time mask, with
    # a dead row: at the MHA stack's shape with dropout, ragged, causal
    ("time_mask_mha", 2, 16, 64, 64, 64, "time_dead", False, 0.1),
    ("time_mask_ragged", 2, 2, 129, 200, 64, "time_dead", False, 0.0),
    ("time_mask_causal", 2, 3, 200, 130, 32, "time_dead", True, 0.1),
    # the fp16 instances on the same edges: ragged with dropout, the
    # two-warpgroup kernels, D = 32 and 128, the MHA stack's time mask
    ("fp16_dropout", 2, 2, 129, 200, 64, "pad_dead", True, 0.1, "float16"),
    ("fp16_wide_ragged", 2, 66, 200, 333, 64, "pad_dead", True, 0.1,
     "float16"),
    ("fp16_d32_sk255", 2, 2, 130, 255, 32, "batch_pad_dead", True, 0.1,
     "float16"),
    ("fp16_d128", 2, 2, 65, 129, 128, "batch_pad_dead", False, 0.0,
     "float16"),
    ("fp16_time_mask_mha", 2, 16, 64, 64, 64, "time_dead", False, 0.1,
     "float16"),
    # rows whose every visible key carries -1e9: the backward rebuilds P
    # from the forward's (m, log l); the fused, dq and dk/dv kernels are
    # also held to autograd of the plain forward there
    ("masked_rows", 2, 2, 129, 200, 64, "masked", False, 0.0),
    ("masked_rows_causal", 2, 2, 200, 130, 64, "masked", True, 0.1),
    ("masked_rows_wide", 2, 66, 129, 129, 64, "masked", True, 0.0),
    ("masked_rows_d128", 2, 66, 129, 129, 128, "masked", True, 0.0),
    ("fp16_masked_rows", 2, 2, 200, 130, 64, "masked", True, 0.1,
     "float16"),
    # D = 256: the scalar kernels in 16-bit
    ("d256", 2, 2, 129, 200, 256, "pad_dead", True, 0.1),
    ("d256_masked", 2, 2, 130, 129, 256, "masked", False, 0.0),
    ("fp16_d256", 2, 2, 65, 129, 256, "batch_pad_dead", False, 0.0,
     "float16"),
]


#: edge cases whose bf16 gradients are held to 2e-2 relative in norm, with
#: the peak rule's reading logged: rows with three visible keys give dS near
#: |dP|, which grows as sqrt(D); the kernels and the plain version round dS
#: to bf16 and may land on neighbouring numbers (up to 2^-7 apart
#: relative), which moves an element of dq by up to 2^-7 sum_j |dS_j|
#: |k_j|, past the peak rule's 2e-2 on a value near 1 at D = 128
NORM_RULE_CASES = {"masked_rows_d128"}


def _peak_ratios(got, ref):
    """The peak rule's readings, element by element: |got - ref| /
    max(|ref|, min(1, max|ref|)), whose max :func:`peak_ok` holds to its
    tol."""
    a = ref.float().abs()
    return (got.float() - ref.float()).abs() / a.clamp(
        min=min(1.0, float(a.max())))


def _fused_partials(args, part):
    """The fused kernel's C entry point with the caller's dq-partial buffer
    ``part`` (a check of the buffer's layout; not a counted launch)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import _launch_args
    from apex_tpu_torch.utils import build
    q, k, v, bias, causal, rate, seed, heads, stats, delta, do = args
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = build.library().apex_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        do.data_ptr(), stats.data_ptr(), delta.data_ptr(), part.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        *_launch_args(q, k, bias, causal, rate, seed, heads))
    build.check(err, "flash_bwd (partials check)")
    return dk, dv


def check_flash_edges(dev, grad: bool):
    """The bf16 and fp16 kernels on :data:`FLASH_EDGE_CASES`: the forward
    (out within 2e-2, fp16 5e-3, on the peak rule, live lse within 1e-4
    relative, its (m, log l) residual within 1e-4 relative / 1e-3, dead
    rows exact) or, with ``grad``, on the kernel forward's (m, log l),
    each held to its plain version (bf16 2e-2 on the peak rule, or in norm
    on :data:`NORM_RULE_CASES`, fp16 2e-3 relative in norm), and on the
    "masked" cases also to autograd of the
    plain forward (bf16 2e-2, fp16 2e-3 relative in norm): the split dq
    kernel, the dk/dv kernel
    and the fused kernel, whose dk and dv must be the dk/dv kernel's bits;
    and the fused kernel's dq partials, written into a NaN-filled (BH,
    ceil(Sk / BWD_K_TILE), Sq, D) buffer, must be finite everywhere (each
    block written) and sum to the wrapper's dq bit for bit."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        BWD_K_TILE, _flash_bwd_dkv, _flash_bwd_dkv_reference, _flash_bwd_dq,
        _flash_bwd_dq_reference, _flash_bwd_fused, _flash_bwd_reference,
        _flash_fwd_res, _reference_res, _xla_bwd)
    gen = torch.Generator().manual_seed(13 if grad else 12)
    for name, B, heads, sq, sk, d, kind, causal, rate, *dt in \
            FLASH_EDGE_CASES:
        dtype = getattr(torch, dt[0] if dt else "bfloat16")
        fp16 = dtype == torch.float16
        q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, gen,
                                      dtype, dev)
        out, lse, stats = _flash_fwd_res(q, k, v, bias, causal, rate, 77,
                                         heads)
        if grad:
            do = _randn(q.shape, gen, dtype, dev)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, bias, causal, rate, 77, heads, stats, delta, do)
            # over a single key the softmax is constant: dq and dk are 0 up
            # to rounding, which the peak rule would hold to itself
            rule = scaled_ok if sk == 1 else peak_ok
            if fp16:
                def rule(a, r, _tol):
                    e = norm_rel(a, r)
                    return e <= FP16_GRAD_TOL, e
            elif name in NORM_RULE_CASES:
                def rule(a, r, tol):
                    e = norm_rel(a, r)
                    return e <= tol, e
            fused = _flash_bwd_fused(*args)
            dk, dv = _flash_bwd_dkv(*args)
            errs = {}
            for gname, a, r in (
                    ("dq", _flash_bwd_dq(*args), _flash_bwd_dq_reference(*args)),
                    ("dk", dk, _flash_bwd_dkv_reference(*args)[0])):
                ok, errs[gname] = rule(a, r, 2e-2)
                require(ok, f"flash split edge {name} {gname}: err "
                        f"{errs[gname]:.3g} (tol 2e-2; fp16 "
                        f"{FP16_GRAD_TOL} in norm)")
            for gname, a, r in zip(("fused dq", "fused dk", "fused dv"),
                                   fused, _flash_bwd_reference(*args)):
                ok, errs[gname] = (peak_ok if gname == "fused dv"
                                   and not fp16 else rule)(a, r, 2e-2)
                require(ok, f"flash_bwd edge {name} {gname}: err "
                        f"{errs[gname]:.3g} (tol 2e-2; fp16 "
                        f"{FP16_GRAD_TOL} in norm)")
            require(torch.equal(dk, fused[1]) and torch.equal(dv, fused[2]),
                    f"flash edge {name}: the dk/dv kernel and the fused "
                    "kernel give different dk or dv")
            if kind == "masked":
                # autograd of the plain forward on the same inputs, in
                # norm: the kernels round P and dS to 16 bits where it
                # does not (the lse-only rebuild was 10-30x off here)
                auto = _xla_bwd(q, k, v, bias, causal, rate, 77, heads, do)
                a_tol = FP16_GRAD_TOL if fp16 else 2e-2
                for gname, a, r in (("fused dq / autograd", fused[0], auto[0]),
                                    ("fused dk / autograd", fused[1], auto[1]),
                                    ("fused dv / autograd", fused[2], auto[2]),
                                    ("dq / autograd", _flash_bwd_dq(*args),
                                     auto[0]),
                                    ("dk / autograd", dk, auto[1])):
                    errs[gname] = norm_rel(a, r)
                    require(errs[gname] <= a_tol, f"flash edge {name} "
                            f"{gname}: err {errs[gname]:.3g} in norm (tol "
                            f"{a_tol})")
            bh = B * heads
            part = torch.full((bh, -(-sk // BWD_K_TILE), sq, d), float("nan"),
                              device=dev)
            _fused_partials(args, part)
            require(bool(torch.isfinite(part).all()) and torch.equal(
                part.sum(dim=1).to(q.dtype), fused[0]),
                f"flash edge {name}: dq partials {tuple(part.shape)} not all "
                "written, or not the wrapper's dq")
            rule_text = (f"{FP16_GRAD_TOL} in norm" if fp16
                         else "2e-2 in norm" if name in NORM_RULE_CASES
                         else "2e-2, peak rule")
            if name in NORM_RULE_CASES:
                # the peak rule's readings, and which side of float64
                # autograd the kernel and the plain version lie
                ref = _flash_bwd_reference(*args)
                x64 = [t.double() for t in (q, k, v, do)]
                tru = _xla_bwd(*x64[:3], bias, causal, rate, 77, heads,
                               x64[3])
                for gname, a, r, t in (("dq", _flash_bwd_dq(*args),
                                        _flash_bwd_dq_reference(*args),
                                        tru[0]),
                                       ("fused dq", fused[0], ref[0], tru[0]),
                                       ("dk", dk, ref[1], tru[1])):
                    ratio = _peak_ratios(a, r)
                    i = int(ratio.argmax())
                    log(f"  flash_bwd edge {name} {gname}: the peak rule's "
                        f"reading {float(ratio.max()):.4g} (not gated; its "
                        f"tol 2e-2) at flat index {i}: kernel "
                        f"{float(a.flatten()[i]):.5g}, plain "
                        f"{float(r.flatten()[i]):.5g}, float64 autograd "
                        f"{float(t.flatten()[i]):.5g}; in norm from float64 "
                        f"autograd: kernel {norm_rel(a, t):.3g}, plain "
                        f"{norm_rel(r, t):.3g}")
                del ref, tru, x64
            log(f"  flash_bwd edge {name:18s} " + " ".join(
                f"{g} {e:.3g}" for g, e in errs.items()) + f" (tol "
                f"{rule_text}); dk/dv = fused bits; partials "
                f"{tuple(part.shape)} all written")
            continue
        torch.cuda.synchronize()
        r_out, r_lse, r_stats = _reference_res(q, k, v, bias, causal, rate,
                                               77, heads)
        tol = FP16_OUT_TOL if fp16 else 2e-2
        ok, err = peak_ok(out, r_out, tol)
        live = r_lse < 1e29
        l_err = rel_err(lse[live], r_lse[live]) if bool(live.any()) else 0.0
        row_live = live[..., 0]
        m_ok = not bool(row_live.any()) or scaled_ok(
            stats[..., 0][row_live], r_stats[..., 0][row_live], 1e-4)[0]
        ll_err = float((stats[..., 1] - r_stats[..., 1])[row_live].abs()
                       .max()) if bool(row_live.any()) else 0.0
        dead_ok = bool((lse[~live] == r_lse[~live]).all()) and bool(
            (out[(~live)[..., 0]] == 0).all()) and torch.equal(
            stats[~row_live], r_stats[~row_live])
        require(ok and l_err <= 1e-4 and dead_ok and m_ok and ll_err <= 1e-3,
                f"flash edge {name}: out err {err:.3g} (tol {tol}, peak "
                f"rule), lse rel err {l_err:.3g}, m ok {m_ok}, log l err "
                f"{ll_err:.3g} (tol 1e-3), dead rows ok {dead_ok}")
        log(f"  flash edge {name:18s} out err {err:.3g} (tol {tol}, peak) "
            f"lse {l_err:.2g} dead rows {int((~live).sum())}")


def check_flash_bwd_graph(dev):
    """The routes on the card: the fused route's dk and dv are the split
    route's bits (dq is summed in another order there: the peak rule), and
    a CUDA graph of 3 fused and 3 dk/dv calls replays the eager calls'
    bits."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd, _flash_bwd_dkv, _flash_bwd_fused, _flash_fwd_res)
    gen = torch.Generator().manual_seed(17)
    B, heads = 2, 66
    q, k, v, bias = _flash_inputs(B, heads, 200, 333, 64, "batch_pad_dead",
                                  gen, torch.bfloat16, dev)
    do = _randn(q.shape, gen, torch.bfloat16, dev)
    out, lse, stats = _flash_fwd_res(q, k, v, bias, True, 0.1, 3, heads)
    fused = _flash_bwd(q, k, v, bias, True, 0.1, 3, heads, out, stats, do,
                       fuse=True)
    split = _flash_bwd(q, k, v, bias, True, 0.1, 3, heads, out, stats, do,
                       fuse=False)
    ok, err = peak_ok(split[0], fused[0], 2e-2)
    require(torch.equal(fused[1], split[1]) and torch.equal(fused[2], split[2])
            and ok, f"flash routes: dk/dv bits differ or dq err {err:.3g}")
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, bias, True, 0.1, 3, heads, stats, delta, do)
    eager = _flash_bwd_fused(*args) + _flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [_flash_bwd_fused(*args) for _ in range(3)]
        got += [_flash_bwd_dkv(*args) for _ in range(3)]
    for outs in got:
        for t in outs:
            t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for outs in got[:3]
               for a, b in zip(outs, eager[:3])) and all(
        torch.equal(a, b) for outs in got[3:] for a, b in zip(outs, eager[3:]))
    require(same, "a CUDA graph of fused and dk/dv calls does not replay the "
            "eager bits")
    del graph
    log(f"  flash routes: fused dk/dv = split dk/dv bits, dq err {err:.3g} "
        "(tol 2e-2, peak rule); a CUDA graph of 3 fused + 3 dk/dv calls "
        "replays the eager bits")


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.multihead_attn.flash import (_flash_fwd,
                                                             _reference)
    rows = []
    gen = torch.Generator().manual_seed(1)
    cases = [  # name, B, heads, Sq, Sk, D, bias, causal, dropout
        ("serving", 1, 16, 512, 512, 64, "zeros", True, 0.0),
        ("training", 8, 16, 512, 512, 64, "zeros", False, 0.0),
        ("ragged_pad_dead", 2, 4, 200, 333, 64, "pad_dead", False, 0.0),
        ("dropout", 1, 16, 512, 512, 64, "zeros", True, 0.1),
        ("d128", 2, 2, 130, 130, 128, "zeros", True, 0.0),
        ("d32", 2, 2, 96, 160, 32, "pad_dead", False, 0.1),
    ]
    for name, B, heads, sq, sk, d, kind, causal, rate in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, gen, dt,
                                          dev)
            out, lse = _flash_fwd(q, k, v, bias, causal, rate, 1234, heads)
            torch.cuda.synchronize()
            r_out, r_lse = _reference(q, k, v, bias, causal, rate, 1234,
                                      heads)
            tol = 1e-4 if dtype == "float32" else 2e-2
            ok, err = peak_ok(out, r_out, tol)
            live = r_lse < 1e29
            l_err = rel_err(lse[live], r_lse[live])
            dead_ok = bool((lse[~live] == r_lse[~live]).all()) and bool(
                (out[(~live)[..., 0]] == 0).all())
            n_dead = int((~live).sum())
            require(ok and l_err <= 1e-4 and dead_ok,
                    f"flash {name} {dtype}: out err {err:.3g} (tol {tol}, peak "
                    "rule), "
                    f"lse rel err {l_err:.3g}, dead rows ok {dead_ok}")
            bh = B * heads
            es = q.element_size()
            nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * es \
                + bias.numel() * 4 + bh * sq * 4
            pairs = (sum(min(r + 1, sk) for r in range(sq)) if causal
                     else sq * sk)
            bms, by = bound(nbytes, 4.0 * d * pairs * bh, dtype)
            ms = device_ms(lambda: _flash_fwd(q, k, v, bias, causal, rate,
                                              1234, heads))
            call_ms = time_ms(lambda: _flash_fwd(q, k, v, bias, causal,
                                                 rate, 1234, heads))
            pms = device_ms(lambda: _reference(q, k, v, bias, causal, rate,
                                               1234, heads), n=5)
            lms = l_call = None
            if name in ("serving", "training"):
                q4, k4, v4 = (t.view(B, heads, -1, d) for t in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=causal, scale=1.0)
                lms, l_call = device_ms(sdpa), time_ms(sdpa)
            rows.append(dict(case=name, dtype=dtype, max_abs_err=err,
                             tol=tol, lse_rel_err=l_err, dead_rows=n_dead,
                             ms=ms, call_ms=call_ms, plain_ms=pms,
                             library_ms=lms, bound_ms=bms, bound_by=by))
            lib = (f"{lms:.5f} ms (one call {l_call:.4f} ms)"
                   if lms is not None else "n/a")
            log(f"  flash {name:15s} {dtype:8s} out err {err:.3g} (tol "
                f"{tol}) lse {l_err:.2g} dead rows {n_dead} | kernel "
                f"{ms:.5f} ms (one call with its host cost {call_ms:.4f} "
                f"ms)  plain {pms:.5f} ms  sdpa {lib}  bound {bms:.5f} ms "
                f"({by})")
    rows.append(check_flash_long(dev, gen))
    return rows


def check_flash_long(dev, gen):
    """The forward at the long-sequence shape, BH 64 x 4096 x 4096 x 64
    bf16, not causal: held to the plain version on its first 8 heads (the
    heads are independent), timed against SDPA's forward; the plain
    version's time is CUDA events around one call at the full shape."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.multihead_attn.flash import (_flash_fwd,
                                                             _reference)
    B, heads, S, d = LONG_SHAPE
    bh = B * heads
    q, k, v, bias = _flash_inputs(B, heads, S, S, d, "zeros", gen,
                                  torch.bfloat16, dev)
    out, lse = _flash_fwd(q, k, v, bias, False, 0.0, 0, heads)
    torch.cuda.synchronize()
    r_out, r_lse = _reference(q[:8], k[:8], v[:8], bias, False, 0.0, 0, 1)
    ok, err = peak_ok(out[:8], r_out, 2e-2)
    floor = 2e-2 * min(1.0, float(r_out.float().abs().max()))
    l_err = rel_err(lse[:8], r_lse)
    del r_out, r_lse
    require(ok and l_err <= 1e-4, f"flash long shape: out err {err:.3g} "
            f"(tol 2e-2), lse rel err {l_err:.3g}")
    nbytes = 4 * bh * S * d * 2 + bias.numel() * 4 + bh * S * 4
    bms, by = bound(nbytes, 4.0 * d * S * S * bh, "bfloat16")

    def kern():
        return _flash_fwd(q, k, v, bias, False, 0.0, 0, heads)
    ms = device_ms(kern)
    call_ms = time_ms(kern, reps=10, warmup=2)
    pms = time_ms(lambda: _reference(q, k, v, bias, False, 0.0, 0, heads),
                  reps=3, warmup=1)
    torch.cuda.empty_cache()
    q4, k4, v4 = (t.view(B, heads, S, d) for t in (q, k, v))
    lms = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                           scale=1.0))
    _report("flash_fwd", f"BH{bh}x{S}x{S}x{d} bf16", err,
            f"2e-2 peak rule, {floor:.3g} at least", ms, pms, lms,
            bms, by, f" lse {l_err:.2g} [one call with its host cost "
            f"{call_ms:.4f} ms; plain: one call between events]")
    return dict(case="long_seq", dtype="bfloat16", max_abs_err=err,
                tol=2e-2, lse_rel_err=l_err, dead_rows=0, ms=ms,
                call_ms=call_ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=by)


# ---------------------------------------------------------------------------
# phase 3b: the training path's kernels against their plain versions
# ---------------------------------------------------------------------------

def _report(name, case, err, tol, ms, pms, lms, bms, by, extra=""):
    lib = f"{lms:.5f} ms" if lms is not None else "n/a"
    log(f"  {name} {case} err {err:.3g} (tol {tol}){extra} | kernel "
        f"{ms:.5f} ms  plain {pms:.5f} ms  library {lib}  bound {bms:.5f} "
        f"ms ({by})")


def check_ln_bwd(dev):
    import torch
    from apex_tpu_torch.ops.layer_norm import (ln_bwd, ln_bwd_reference,
                                               ln_fwd_reference)
    rows = []
    gen = torch.Generator().manual_seed(2)
    aten_bwd = torch.ops.aten.native_layer_norm_backward
    for n, h in ((4096, 1024), (8, 1024), (7680, 1024)):
        for dtype in ("bfloat16", "float32"):
            for affine in (True, False):
                dt = getattr(torch, dtype)
                x = _randn((n, h), gen, dt, dev, 2.0, 0.5)
                g = _randn((n, h), gen, dt, dev)
                w = _randn((h,), gen, dt, dev) if affine else None
                b = _randn((h,), gen, dt, dev) if affine else None
                _, mean, inv = ln_fwd_reference(x, w, b, 1e-5)
                dx = ln_bwd(g, x, mean, inv, w)
                torch.cuda.synchronize()
                ref = ln_bwd_reference(g, x, mean, inv, w)
                tol = 1e-4 if dtype == "float32" else 2e-2
                ok, err = scaled_ok(dx, ref, tol)
                require(ok, f"ln_bwd ({n},{h}) {dtype} affine={affine}: err "
                        f"{err:.3g} (tol {tol})")
                es = x.element_size()
                nbytes = 3 * n * h * es + 2 * n * 4 + (h * es if affine
                                                       else 0)
                bms, by = bound(nbytes, 12.0 * n * h, "float32")
                ms = device_ms(lambda: ln_bwd(g, x, mean, inv, w))
                pms = device_ms(lambda: ln_bwd_reference(g, x, mean, inv, w))
                # the library backward takes its own forward's statistics
                _, a_mean, a_inv = torch.ops.aten.native_layer_norm(
                    x, [h], w, b, 1e-5)
                lms = device_ms(lambda: aten_bwd(g, x, [h], a_mean, a_inv, w,
                                                 b, [True, False, False]))
                rows.append(dict(shape=(n, h), dtype=dtype, affine=affine,
                                 max_abs_err=err, tol=tol, ms=ms,
                                 plain_ms=pms, library_ms=lms, bound_ms=bms,
                                 bound_by=by))
                _report("ln_bwd", f"({n},{h}) {dtype:8s} affine={affine!s:5s}",
                        err, tol, ms, pms, lms, bms, by)
    return rows


def check_xent(dev):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (
        _xent_fwd, _xent_fwd_reference)
    rows = []
    gen = torch.Generator().manual_seed(3)
    # BERT's (4096 x 30,592) and the byte mLSTM's (32,768 x 256)
    for n, v, dtype in ((4096, 30592, "bfloat16"), (4096, 30592, "float32"),
                        (32768, 256, "bfloat16"), (32768, 256, "float32")):
        labels = torch.randint(0, v, (n,), generator=gen).to(dev)
        labels[::16] = -1                      # padding rows
        x = _randn((n, v), gen, getattr(torch, dtype), dev, 3.0)
        for sm in (0.0, 0.1):
            loss, lse = _xent_fwd(x, labels, sm)
            torch.cuda.synchronize()
            r_loss, r_lse = _xent_fwd_reference(x, labels, sm)
            ok1, err = scaled_ok(loss, r_loss, 1e-5)
            ok2, l_err = scaled_ok(lse, r_lse, 1e-5)
            require(ok1 and ok2, f"xent ({n},{v}) {dtype} s={sm}: loss err "
                    f"{err:.3g}, lse err {l_err:.3g} (tol 1e-5)")
            bms, by = bound(n * v * x.element_size() + 8 * n + 8 * n,
                            5.0 * n * v, "float32")
            ms = device_ms(lambda: _xent_fwd(x, labels, sm))
            pms = device_ms(lambda: _xent_fwd_reference(x, labels, sm), n=5)
            lms = device_ms(lambda: F.cross_entropy(
                x, labels, reduction="none", ignore_index=-1,
                label_smoothing=sm))
            rows.append(dict(shape=(n, v), dtype=dtype, smoothing=sm,
                             max_abs_err=max(err, l_err), tol=1e-5, ms=ms,
                             plain_ms=pms, library_ms=lms, bound_ms=bms,
                             bound_by=by))
            _report("xent_fwd", f"({n},{v}) {dtype:8s} s={sm}",
                    max(err, l_err), 1e-5, ms, pms, lms, bms, by,
                    f" [{int((labels < 0).sum())} padding rows]")
    return rows


def check_l2norm(dev):
    import torch
    from apex_tpu_torch.multi_tensor_apply.kernels import (
        multi_tensor_l2norm, multi_tensor_l2norm_reference)
    rows = []
    gen = torch.Generator(device=dev).manual_seed(4)
    # the BERT-large flat master buffer, and a ragged bf16 one
    for n, dtype in ((FLAT_N, "float32"), (1_310_720, "bfloat16")):
        x = torch.randn(n, generator=gen, device=dev).to(getattr(torch,
                                                                 dtype))
        a, b = multi_tensor_l2norm(x), multi_tensor_l2norm(x)
        ref = multi_tensor_l2norm_reference(x)
        torch.cuda.synchronize()
        err = abs(a.item() - ref.item())
        require(torch.equal(a, b), f"l2norm ({n},) {dtype} does not repeat")
        require(err <= 1e-5 * ref.item(), f"l2norm ({n},) {dtype}: err "
                f"{err:.3g} of {ref.item():.6g} (tol 1e-5 relative)")
        bms, by = bound(n * x.element_size() + 4, 2.0 * n, "float32")
        ms = device_ms(lambda: multi_tensor_l2norm(x))
        pms = device_ms(lambda: multi_tensor_l2norm_reference(x), n=5)
        lms = device_ms(lambda: torch.linalg.vector_norm(x,
                                                         dtype=torch.float32))
        rows.append(dict(shape=(n,), dtype=dtype, max_abs_err=err,
                         tol="1e-5 rel", ms=ms, plain_ms=pms, library_ms=lms,
                         bound_ms=bms, bound_by=by))
        _report("l2norm", f"({n},) {dtype}", err, "1e-5 rel", ms, pms, lms,
                bms, by, " [repeats bit for bit]")
    return rows


def check_flash_bwd(dev):
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        BWD_K_TILE, _flash_bwd_fused, _flash_bwd_reference, _flash_fwd,
        _flash_fwd_res,
        _xla_bwd)
    aten = torch.ops.aten
    rows = []
    gen = torch.Generator().manual_seed(5)
    cases = [  # name, B, heads, Sq, Sk, D, bias, causal, dropout
        ("training", 8, 16, 512, 512, 64, "zeros", False, 0.0),
        ("causal", 8, 16, 512, 512, 64, "zeros", True, 0.0),
        ("ragged_pad_dead", 2, 4, 200, 333, 64, "pad_dead", False, 0.0),
        ("dropout", 8, 16, 512, 512, 64, "zeros", False, 0.1),
    ]
    for name, B, heads, sq, sk, d, kind, causal, rate in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, gen, dt,
                                          dev)
            do = _randn(q.shape, gen, dt, dev)
            out, lse, stats = _flash_fwd_res(q, k, v, bias,
                                             causal, rate, 99, heads)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)

            def kern():
                return _flash_bwd_fused(q, k, v, bias, causal, rate, 99,
                                        heads, stats, delta, do)

            def plain():
                return _flash_bwd_reference(q, k, v, bias, causal, rate, 99,
                                            heads, stats, delta, do)
            got = kern()
            torch.cuda.synchronize()
            tol = 1e-4 if dtype == "float32" else 2e-2
            errs = []
            for gname, a, r in zip(("dq", "dk", "dv"), got, plain()):
                ok, err = peak_ok(a, r, tol)
                require(ok, f"flash_bwd {name} {dtype} {gname}: err "
                        f"{err:.3g} (tol {tol})")
                errs.append(err)
            extra = ""
            if rate > 0.0 and dtype == "float32":
                # forward kernel + backward kernel against autograd of the
                # plain forward: the backward regenerates the forward's mask
                for gname, a, r in zip(("dq", "dk", "dv"), got,
                                       _xla_bwd(q, k, v, bias, causal, rate,
                                                99, heads, do)):
                    ok, err = scaled_ok(a, r, 1e-4)
                    require(ok, f"flash_bwd dropout {gname} vs autograd of "
                            f"the plain forward: err {err:.3g} (tol 1e-4)")
                extra = " [= autograd of the plain forward: masks agree]"
            bh = B * heads
            es = q.element_size()
            nbytes = 7 * bh * sq * d * es + 2 * bh * sq * 4 \
                + bias.numel() * 4
            pairs = (sum(min(r + 1, sk) for r in range(sq)) if causal
                     else sq * sk)
            bms, by = bound(nbytes, 10.0 * d * pairs * bh, dtype)
            ms = device_ms(kern)
            pms = device_ms(plain, n=3)
            nk = -(-sk // BWD_K_TILE)
            part = torch.empty((bh, nk, sq, d), dtype=torch.float32,
                               device=dev)
            sum_ms = device_ms(lambda: part.sum(dim=1).to(dt))
            lms = None
            if name in ("training", "causal") and dtype == "bfloat16":
                # SDPA's flash backward alone, on its own forward's saved
                # (out, lse), timed like the kernel
                q4, k4, v4, do4 = (t.view(B, heads, -1, d)
                                   for t in (q, k, v, do))
                (o4, lse4, cq, ck, mq, mk, rng_seed, rng_offset,
                 _) = aten._scaled_dot_product_flash_attention(
                    q4, k4, v4, 0.0, causal, False, scale=1.0)
                lms = device_ms(
                    lambda: aten._scaled_dot_product_flash_attention_backward(
                        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0,
                        causal, rng_seed, rng_offset, scale=1.0))
            rows.append(dict(case=name, dtype=dtype, max_abs_err=max(errs),
                             tol=tol, ms=ms, plain_ms=pms, library_ms=lms,
                             library="aten flash-attention backward",
                             partials_sum_ms=sum_ms, bound_ms=bms,
                             bound_by=by))
            _report("flash_bwd", f"{name:15s} {dtype:8s}", max(errs), tol, ms,
                    pms, lms, bms, by,
                    f" [of it, the dq-partial sum {sum_ms:.5f} ms]{extra}")
    return rows


# ---------------------------------------------------------------------------
# phase 3c: this slice's kernels against their plain versions
# ---------------------------------------------------------------------------



def _rel_ok(got, ref, tol):
    """(all elements within tol * |ref|, max absolute error)."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= tol * ref.float().abs() + 1e-30).all())
    return ok, float(err.max())


def check_zero_updates(dev):
    """Adam and LAMB stage 1 over the flat buffer: kernel vs plain (1e-6
    relative), device time, plain time, ``torch._fused_adamw_`` for Adam
    (LAMB stage 1 has no single library call), bound by bytes (7 fp32
    streams, 28 B an element)."""
    import torch
    from apex_tpu_torch.multi_tensor_apply import kernels
    rows = []
    gen = torch.Generator(device=dev).manual_seed(8)
    n = FLAT_N
    g = torch.randn(n, generator=gen, device=dev) * 3.0
    p = torch.randn(n, generator=gen, device=dev)
    m = torch.randn(n, generator=gen, device=dev) * 0.1
    v = torch.rand(n, generator=gen, device=dev) * 0.01
    t = 3
    adam_s = torch.tensor([[1e-3, 0.9, 0.999, 1e-8, 0.01, 1 / (1 - 0.9 ** t),
                            1 / (1 - 0.999 ** t), 0.7]], device=dev)
    lamb_s = torch.tensor([[0.9, 0.999, 1e-6, 0.01, 1 / (1 - 0.9 ** t),
                            1 / (1 - 0.999 ** t), 0.35, 1.0, 0.1]],
                          device=dev)
    for name, fn, plain, scal in (
            ("adam", kernels.fused_adam_flat,
             kernels.fused_adam_flat_reference, adam_s),
            ("lamb_stage1", kernels.fused_lamb_stage1_flat,
             kernels.fused_lamb_stage1_flat_reference, lamb_s)):
        got = fn(g, p, m, v, scal)
        torch.cuda.synchronize()
        errs = []
        for out_name, a, r in zip(("p/u", "m", "v"), got,
                                  plain(g, p, m, v, scal)):
            ok, err = _rel_ok(a, r, 1e-6)
            require(ok, f"{name} {out_name}: err {err:.3g} (tol 1e-6 "
                    "relative)")
            errs.append(err)
        del got
        bms, by = bound(28.0 * n, 15.0 * n, "float32")
        ms = device_ms(lambda: fn(g, p, m, v, scal))
        call_ms = time_ms(lambda: fn(g, p, m, v, scal), reps=10)
        pms = device_ms(lambda: plain(g, p, m, v, scal), n=2, reps=5)
        lms = None
        if name == "adam":
            # the call behind torch.optim.AdamW(fused=True), in place on
            # copies of the same buffers
            pc, mc, vc = p.clone(), m.clone(), v.clone()
            step = torch.full((), float(t), device=dev)

            def adamw():
                torch._fused_adamw_([pc], [g], [mc], [vc], [], [step],
                                    lr=1e-3, beta1=0.9, beta2=0.999,
                                    weight_decay=0.01, eps=1e-8,
                                    amsgrad=False, maximize=False)
            lms = device_ms(adamw)
            del pc, mc, vc
        torch.cuda.empty_cache()
        rows.append(dict(kernel=name, shape=(n,), dtype="float32",
                         max_abs_err=max(errs), tol="1e-6 rel", ms=ms,
                         call_ms=call_ms, plain_ms=pms, library_ms=lms,
                         library="torch._fused_adamw_" if lms else None,
                         bound_ms=bms, bound_by=by))
        lib = f"{lms:.5f} ms (torch._fused_adamw_)" if lms else "none"
        log(f"  {name} ({n},) fp32 err {max(errs):.3g} (tol 1e-6 rel) | "
            f"kernel {ms:.5f} ms (one call with its host cost "
            f"{call_ms:.4f} ms)  plain {pms:.5f} ms  library {lib}  bound "
            f"{bms:.5f} ms ({by})")
    return rows


def check_flash_split(dev):
    """The split backward's dq and dk/dv kernels: small cases against the
    plain versions (and the dropout case against autograd of the plain
    forward), then the long-sequence shape, timed."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_dkv, _flash_bwd_dkv_reference, _flash_bwd_dq,
        _flash_bwd_dq_reference, _flash_fwd, _flash_fwd_res, _xla_bwd)
    aten = torch.ops.aten
    gen = torch.Generator().manual_seed(9)
    cases = [  # name, B, heads, Sq, Sk, D, bias, causal, dropout
        ("causal", 2, 4, 256, 256, 64, "zeros", True, 0.0),
        ("ragged_pad_dead", 2, 4, 200, 333, 64, "pad_dead", False, 0.0),
        ("dropout", 2, 4, 256, 192, 64, "zeros", False, 0.1),
    ]
    for name, B, heads, sq, sk, d, kind, causal, rate in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, gen, dt,
                                          dev)
            do = _randn(q.shape, gen, dt, dev)
            out, lse, stats = _flash_fwd_res(q, k, v, bias,
                                             causal, rate, 21, heads)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, bias, causal, rate, 21, heads, stats, delta, do)
            got = (_flash_bwd_dq(*args),) + _flash_bwd_dkv(*args)
            torch.cuda.synchronize()
            ref = (_flash_bwd_dq_reference(*args),) \
                + _flash_bwd_dkv_reference(*args)
            tol = 1e-4 if dtype == "float32" else 2e-2
            errs = []
            for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
                ok, err = peak_ok(a, r, tol)
                require(ok, f"flash split {name} {dtype} {gname}: err "
                        f"{err:.3g} (tol {tol})")
                errs.append(err)
            extra = ""
            if rate > 0.0 and dtype == "float32":
                for gname, a, r in zip(("dq", "dk", "dv"), got,
                                       _xla_bwd(q, k, v, bias, causal, rate,
                                                21, heads, do)):
                    ok, err = scaled_ok(a, r, 1e-4)
                    require(ok, f"flash split dropout {gname} vs autograd "
                            f"of the plain forward: err {err:.3g}")
                extra = " [= autograd of the plain forward: masks agree]"
            log(f"  flash split {name:15s} {dtype:8s} dq/dk/dv err "
                f"{max(errs):.3g} (tol {tol}){extra}")

    # the long-sequence shape: BH 64 x 4096 x 4096 x 64 bf16, not causal
    B, heads, S, d = LONG_SHAPE
    bh = B * heads
    q, k, v, bias = _flash_inputs(B, heads, S, S, d, "zeros", gen,
                                  torch.bfloat16, dev)
    do = _randn(q.shape, gen, torch.bfloat16, dev)
    out, lse, stats = _flash_fwd_res(q, k, v, bias, False, 0.0, 0, heads)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, bias, False, 0.0, 0, heads, stats, delta, do)
    dq = _flash_bwd_dq(*args)
    dk, dv = _flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    # held to the plain version on the first 8 heads (no dropout: the
    # heads are independent), so the (Sq, Sk) fp32 matrices stay small
    sl = (q[:8], k[:8], v[:8], bias, False, 0.0, 0, 1, stats[:8], delta[:8],
          do[:8])
    err_dq = peak_ok(dq[:8], _flash_bwd_dq_reference(*sl), 2e-2)
    r_dk, r_dv = _flash_bwd_dkv_reference(*sl)
    err_dk, err_dv = peak_ok(dk[:8], r_dk, 2e-2), peak_ok(dv[:8], r_dv, 2e-2)
    del r_dk, r_dv
    require(err_dq[0] and err_dk[0] and err_dv[0],
            f"flash split long shape: dq {err_dq[1]:.3g} dk {err_dk[1]:.3g} "
            f"dv {err_dv[1]:.3g} (tol 2e-2)")
    io = 4 * bh * S * d * 2 + 2 * bh * S * 4 + bias.numel() * 4
    pairs = bh * S * S
    # SDPA's flash backward alone, for dq, dk and dv together
    q4, k4, v4, do4 = (t.view(B, heads, S, d) for t in (q, k, v, do))
    (o4, lse4, cq, ck, mq, mk, rng_seed, rng_offset,
     _) = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False,
                                                   False, scale=1.0)
    lms = device_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, False, rng_seed,
        rng_offset, scale=1.0))
    del o4, lse4
    rows = []
    for name, fn, plain, err, nbytes, flops in (
            ("flash_bwd_dq", lambda: _flash_bwd_dq(*args),
             lambda: _flash_bwd_dq_reference(*args), err_dq[1],
             io + bh * S * d * 2, 6.0 * d * pairs),
            ("flash_bwd_dkv", lambda: _flash_bwd_dkv(*args),
             lambda: _flash_bwd_dkv_reference(*args),
             max(err_dk[1], err_dv[1]), io + 2 * bh * S * d * 2,
             8.0 * d * pairs)):
        bms, by = bound(nbytes, flops, "bfloat16")
        ms = device_ms(fn)
        call_ms = time_ms(fn, reps=10, warmup=2)
        pms = time_ms(plain, reps=3, warmup=1)
        torch.cuda.empty_cache()
        rows.append(dict(kernel=name, case="long_seq", shape=(bh, S, S, d),
                         dtype="bfloat16", max_abs_err=err, tol=2e-2,
                         ms=ms, call_ms=call_ms, plain_ms=pms,
                         library_ms=lms,
                         library="aten flash-attention backward (dq, dk "
                                 "and dv together)",
                         bound_ms=bms, bound_by=by))
        _report(name, f"BH{bh}x{S}x{S}x{d} bf16", err, 2e-2, ms, pms, lms,
                bms, by, f" [one call with its host cost {call_ms:.4f} ms; "
                "plain: one call between events; library: SDPA's whole "
                "backward]")
    return rows


# the any-width and any-head-dim edges, checked and timed (phase 3e):
# layer norm at widths off the 16-byte vector, past the register paths (the
# wide path with the row in shared memory, and re-read at 65,536) and on a
# view one element into its storage; cross-entropy at vocabularies on each
# side of its instances' edges; flash attention at head dims padded to the
# 64 and 128 instances, on the forward and both backward routes
LN_EDGES = [(32768, 33), (32768, 60), (4096, 1000), (512, 12288),
            (64, 65536), ("unaligned", 4096, 1024)]
XENT_EDGES = [(4096, 64), (4096, 255), (4096, 257), (2048, 1025),
              (256, 50257)]
FLASH_PAD_EDGES = [  # name, B, heads, Sq, Sk, D, causal
    ("d48_causal", 8, 16, 512, 512, 48, True),
    ("d96", 8, 16, 512, 512, 96, False),
    # past 128: padded to the D = 256 instance (scalar FMA in every dtype)
    ("d160_causal", 2, 8, 256, 256, 160, True),
    ("d192", 2, 8, 256, 256, 192, False),
    ("d256", 4, 16, 512, 512, 256, False),
]
EDGE_DTYPES = ("float32", "bfloat16", "float16")


def _edge_row(kernel, case, dtype, err, tol, ms, pms, lms, bms, by):
    log(f"  {kernel} {case} {dtype:8s} err {err:.3g} (tol {tol}) | kernel "
        f"{ms:.5f} ms  plain {pms:.5f} ms  library "
        + (f"{lms:.5f} ms" if lms is not None else "none")
        + f"  bound {bms:.5f} ms ({by})")
    return dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=err,
                tol=tol, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=by)


def check_ln_edges(dev):
    """#5 and #6 on :data:`LN_EDGES` in fp32, bf16 and fp16, affine: out
    1e-5 / 2e-2 scaled (fp16 5e-3 on the peak rule), mean 1e-5, invvar
    1e-4 relative; dx 1e-4 / 2e-2 scaled (fp16 2e-3 relative in norm);
    each launch counted, timed beside the plain versions, ``F.layer_norm``
    and aten's backward."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.layer_norm import (ln_bwd, ln_bwd_reference,
                                               ln_fwd, ln_fwd_reference)
    from apex_tpu_torch.utils import build
    aten = torch.ops.aten
    rows = []
    gen = torch.Generator().manual_seed(46)
    for edge in LN_EDGES:
        unaligned = edge[0] == "unaligned"
        n, h = edge[-2:]
        base = (torch.randn((n, h), generator=gen) * 2.0 + 0.5,
                torch.randn((n, h), generator=gen),
                torch.randn((h,), generator=gen) * 0.1 + 1.0,
                torch.randn((h,), generator=gen) * 0.1)
        for dtype in EDGE_DTYPES:
            dt = getattr(torch, dtype)
            if unaligned:
                # each tensor one element into its storage: 2 or 4 bytes
                # off 16
                x, g, w, b = (torch.empty(t.numel() + 1, dtype=dt,
                                          device=dev)[1:].view(t.shape)
                              .copy_(t) for t in base)
                require(x.data_ptr() % 16 != 0, "unaligned edge is aligned")
            else:
                x, g, w, b = (t.to(dev, dt) for t in base)
            case = (f"({n},{h}) unaligned" if unaligned else f"({n},{h})")
            before = dict(build.LAUNCHES)
            y, mean, inv = ln_fwd(x, w, b, 1e-5)
            dx = ln_bwd(g, x, mean, inv, w)
            torch.cuda.synchronize()
            require(build.LAUNCHES["ln_fwd"] == before.get("ln_fwd", 0) + 1
                    and build.LAUNCHES["ln_bwd"] == before.get("ln_bwd", 0)
                    + 1, f"ln edge {case} {dtype}: not one launch each")
            r_y, r_mean, r_inv = ln_fwd_reference(x, w, b, 1e-5)
            if dtype == "float16":
                ok, y_err = peak_ok(y, r_y, FP16_OUT_TOL)
                y_tol = FP16_OUT_TOL
            else:
                y_tol = 1e-5 if dtype == "float32" else 2e-2
                ok, y_err = scaled_ok(y, r_y, y_tol)
            m_err = float((mean - r_mean).abs().max())
            i_err = rel_err(inv, r_inv)
            require(ok and m_err <= 1e-5 and i_err <= 1e-4,
                    f"ln_fwd edge {case} {dtype}: out err {y_err:.3g} (tol "
                    f"{y_tol}), mean {m_err:.3g}, invvar {i_err:.3g}")
            r_dx = ln_bwd_reference(g, x, mean, inv, w)
            if dtype == "float16":
                d_err, d_tol = norm_rel(dx, r_dx), FP16_GRAD_TOL
                ok = d_err <= d_tol
            else:
                d_tol = 1e-4 if dtype == "float32" else 2e-2
                ok, d_err = scaled_ok(dx, r_dx, d_tol)
            require(ok, f"ln_bwd edge {case} {dtype}: dx err {d_err:.3g} "
                    f"(tol {d_tol})")
            es = x.element_size()
            fb, fby = bound(2 * n * h * es + 2 * n * 4 + 2 * h * es,
                            8.0 * n * h, "float32")
            bb, bby = bound(3 * n * h * es + 2 * n * 4 + h * es,
                            12.0 * n * h, "float32")
            f_ms = device_ms(lambda: ln_fwd(x, w, b, 1e-5))
            f_pms = device_ms(lambda: ln_fwd_reference(x, w, b, 1e-5))
            f_lms = device_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
            b_ms = device_ms(lambda: ln_bwd(g, x, mean, inv, w))
            b_pms = device_ms(lambda: ln_bwd_reference(g, x, mean, inv, w))
            _, a_mean, a_inv = aten.native_layer_norm(x, [h], w, b, 1e-5)
            b_lms = device_ms(lambda: aten.native_layer_norm_backward(
                g, x, [h], a_mean, a_inv, w, b, [True, False, False]))
            rows.append(_edge_row("ln_fwd", case, dtype, y_err, y_tol, f_ms,
                                  f_pms, f_lms, fb, fby))
            rows.append(_edge_row("ln_bwd", case, dtype, d_err, d_tol, b_ms,
                                  b_pms, b_lms, bb, bby))
            del x, g, w, b, y, dx
        torch.cuda.empty_cache()
    return rows


def check_xent_edges(dev):
    """#7 on :data:`XENT_EDGES` in fp32, bf16 and fp16, every 16th row a
    padding row, smoothing 0.1: loss and lse 1e-5 scaled; timed beside the
    plain version and ``F.cross_entropy``."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (
        _xent_fwd, _xent_fwd_reference, _xent_plan)
    from apex_tpu_torch.utils import build
    rows = []
    gen = torch.Generator().manual_seed(47)
    for n, v in XENT_EDGES:
        labels = torch.randint(0, v, (n,), generator=gen).to(dev)
        labels[::16] = -1
        base = torch.randn((n, v), generator=gen) * 3.0
        for dtype in EDGE_DTYPES:
            dt = getattr(torch, dtype)
            x = base.to(dev, dt)
            before = build.LAUNCHES["xent_fwd"]
            loss, lse = _xent_fwd(x, labels, 0.1)
            torch.cuda.synchronize()
            require(build.LAUNCHES["xent_fwd"] == before + 1,
                    f"xent edge ({n},{v}) {dtype}: not one launch")
            r_loss, r_lse = _xent_fwd_reference(x, labels, 0.1)
            ok1, err = scaled_ok(loss, r_loss, 1e-5)
            ok2, l_err = scaled_ok(lse, r_lse, 1e-5)
            require(ok1 and ok2, f"xent edge ({n},{v}) {dtype}: loss err "
                    f"{err:.3g}, lse err {l_err:.3g} (tol 1e-5)")
            bms, by = bound(n * v * x.element_size() + 16 * n, 5.0 * n * v,
                            "float32")
            ms = device_ms(lambda: _xent_fwd(x, labels, 0.1))
            pms = device_ms(lambda: _xent_fwd_reference(x, labels, 0.1))
            lms = device_ms(lambda: F.cross_entropy(
                x, labels, reduction="none", ignore_index=-1,
                label_smoothing=0.1))
            rows.append(_edge_row(
                "xent_fwd", f"({n},{v}) {_xent_plan(v, dt)}", dtype,
                max(err, l_err), 1e-5, ms, pms, lms, bms, by))
    return rows


def check_flash_pad_edges(dev):
    """#1, #4 and #2 + #3 at head dims 48 and 96 (padded to the 64 and 128
    instances) in bf16 and fp16, and at 160, 192 and 256 (the D = 256
    instance) in fp32 too, zero bias: out on the peak rule (fp32 1e-4,
    bf16 2e-2, fp16 5e-3), live lse 1e-4 relative; dq, dk, dv on both
    routes (fp32 1e-4 and bf16 2e-2 on the peak rule, fp16 2e-3 relative
    in norm); timed beside the plain versions and SDPA's forward and
    backward (the flash backend's in 16 bits, the memory-efficient one's in
    fp32; no library call computes dq or dk/dv alone)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_dkv, _flash_bwd_dkv_reference, _flash_bwd_dq,
        _flash_bwd_dq_reference, _flash_bwd_fused, _flash_bwd_reference,
        _flash_fwd, _flash_fwd_res, _reference)
    from apex_tpu_torch.utils import build
    aten = torch.ops.aten
    rows = []
    gen = torch.Generator().manual_seed(48)
    for name, B, heads, sq, sk, d, causal in FLASH_PAD_EDGES:
        bh = B * heads
        for dtype in (("float32",) if d > 128 else ()) + ("bfloat16",
                                                          "float16"):
            dt = getattr(torch, dtype)
            fp16 = dtype == "float16"
            fp32 = dtype == "float32"
            q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, "zeros", gen,
                                          dt, dev)
            do = _randn(q.shape, gen, dt, dev)
            before = dict(build.LAUNCHES)
            out, lse, stats = _flash_fwd_res(q, k, v, bias,
                                             causal, 0.0, 0, heads)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, bias, causal, 0.0, 0, heads, stats, delta, do)
            fused = _flash_bwd_fused(*args)
            dq = _flash_bwd_dq(*args)
            dkv = _flash_bwd_dkv(*args)
            torch.cuda.synchronize()
            for kname in ("flash_fwd", "flash_bwd", "flash_bwd_dq",
                          "flash_bwd_dkv"):
                require(build.LAUNCHES[kname] == before.get(kname, 0) + 1,
                        f"flash pad {name} {dtype}: {kname} not one launch")
            require(out.shape == q.shape and all(
                t.shape == q.shape for t in fused + (dq,) + dkv),
                f"flash pad {name}: outputs not sliced back to D = {d}")
            r_out, r_lse = _reference(q, k, v, bias, causal, 0.0, 0, heads)
            o_tol = FP16_OUT_TOL if fp16 else 1e-4 if fp32 else 2e-2
            ok, o_err = peak_ok(out, r_out, o_tol)
            l_err = rel_err(lse, r_lse)
            require(ok and l_err <= 1e-4, f"flash pad {name} {dtype}: out "
                    f"err {o_err:.3g} (tol {o_tol}, peak), lse {l_err:.3g}")

            g_tol = FP16_GRAD_TOL if fp16 else 1e-4 if fp32 else 2e-2

            def grad_err(a, r):
                if fp16:
                    e = norm_rel(a, r)
                    return e <= FP16_GRAD_TOL, e
                return peak_ok(a, r, g_tol)
            ref = _flash_bwd_reference(*args)
            errs = {}
            for gname, a, r in (("fused dq", fused[0], ref[0]),
                                ("fused dk", fused[1], ref[1]),
                                ("fused dv", fused[2], ref[2]),
                                ("dq", dq, _flash_bwd_dq_reference(*args)),
                                ("dk", dkv[0], ref[1]),
                                ("dv", dkv[1], ref[2])):
                ok, errs[gname] = grad_err(a, r)
                require(ok, f"flash pad {name} {dtype} {gname}: err "
                        f"{errs[gname]:.3g} (tol {g_tol})")
            del ref
            es = q.element_size()
            pairs = (sum(min(r + 1, sk) for r in range(sq)) if causal
                     else sq * sk) * bh
            io = 4 * bh * sq * d * es + 2 * bh * sq * 4
            q4, k4, v4, do4 = (t.view(B, heads, -1, d)
                               for t in (q, k, v, do))
            if fp32:    # SDPA's flash kernels take 16-bit only
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    f_lms = device_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=causal, scale=1.0))
                (o4, lse4, rng_seed,
                 rng_offset) = aten._scaled_dot_product_efficient_attention(
                    q4, k4, v4, None, True, 0.0, causal, scale=1.0)
                b_lms = device_ms(
                    lambda: aten._scaled_dot_product_efficient_attention_backward(
                        do4, q4, k4, v4, None, o4, lse4, rng_seed, rng_offset,
                        0.0, [True, True, True, False], causal, scale=1.0))
            else:
                f_lms = device_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=1.0))
                (o4, lse4, cq, ck, mq, mk, rng_seed, rng_offset,
                 _) = aten._scaled_dot_product_flash_attention(
                    q4, k4, v4, 0.0, causal, False, scale=1.0)
                b_lms = device_ms(
                    lambda: aten._scaled_dot_product_flash_attention_backward(
                        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0,
                        causal, rng_seed, rng_offset, scale=1.0))
            del o4, lse4
            case = f"{name} BH{bh}x{sq}x{sk}x{d}"
            for kname, fn, plain, err, tol, nbytes, flops, lms in (
                    ("flash_fwd",
                     lambda: _flash_fwd(q, k, v, bias, causal, 0.0, 0, heads),
                     lambda: _reference(q, k, v, bias, causal, 0.0, 0, heads),
                     o_err, o_tol, io, 4.0 * d * pairs, f_lms),
                    ("flash_bwd", lambda: _flash_bwd_fused(*args),
                     lambda: _flash_bwd_reference(*args),
                     max(errs[g] for g in ("fused dq", "fused dk",
                                           "fused dv")), g_tol,
                     io + 3 * bh * sq * d * es, 10.0 * d * pairs, b_lms),
                    ("flash_bwd_dq", lambda: _flash_bwd_dq(*args),
                     lambda: _flash_bwd_dq_reference(*args), errs["dq"],
                     g_tol, io + bh * sq * d * es, 6.0 * d * pairs, None),
                    ("flash_bwd_dkv", lambda: _flash_bwd_dkv(*args),
                     lambda: _flash_bwd_dkv_reference(*args),
                     max(errs["dk"], errs["dv"]), g_tol,
                     io + 2 * bh * sk * d * es, 8.0 * d * pairs, None)):
                bms, by = bound(nbytes, flops, dtype)
                ms = device_ms(fn)
                pms = device_ms(plain, n=3)
                rows.append(_edge_row(kname, case, dtype, err, tol, ms, pms,
                                      lms, bms, by))
            del q, k, v, do, out, fused, dq, dkv, args
            torch.cuda.empty_cache()
    return rows


# past D = 256: the column-chunked scalar kernels (D padded to a multiple
# of 128, one CTA per 128-column output chunk), causal, the "masked" bias
# (rows whose every visible key carries -1e9), dropout 0.1
FLASH_CHUNK_EDGES = [  # name, B, heads, Sq, Sk, D
    ("d320_masked_causal", 1, 16, 256, 256, 320),
    ("d512_masked_causal", 1, 16, 256, 256, 512),
]
CHUNK_RATE, CHUNK_SEED = 0.1, 17
# the peak rule's tolerances of the chunked kernels' outputs and gradients:
# fp32 1e-4, bf16 2e-2; fp16 takes bf16's, its rounding steps being 8x
# finer (the fp16 gradients' norm rule is logged beside it)
CHUNK_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}


def _sdpa_yardstick(q4, k4, v4, mask, do4, rate):
    """SDPA's time for the same attention, forward and backward (the
    autograd backward of one call, dq, dk and dv together), CUDA events
    around each call: the memory-efficient backend where it takes the
    shape, else the math backend.  Returns (forward ms, backward ms,
    backend name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name, backend in (("sdpa_efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("sdpa_math", SDPBackend.MATH)):
        qkv = [t.detach().clone().requires_grad_(True)
               for t in (q4, k4, v4)]
        try:
            with sdpa_kernel(backend):
                def fwd():
                    return F.scaled_dot_product_attention(
                        *qkv, attn_mask=mask, dropout_p=rate, scale=1.0)
                out = fwd()
                torch.autograd.grad(out, qkv, do4, retain_graph=True)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            with torch.no_grad():
                f_ms = time_ms(fwd, reps=10, warmup=2)
            b_ms = time_ms(lambda: torch.autograd.grad(
                out, qkv, do4, retain_graph=True), reps=10, warmup=2)
        return f_ms, b_ms, name
    raise SmokeFailure("no SDPA backend takes the chunked flash edge shape")


def check_flash_chunk_edges(dev):
    """#1, #4 and #2 + #3 past D = 256 (:data:`FLASH_CHUNK_EDGES`: the
    column-chunked kernels) in fp32, bf16 and fp16: one launch each, out
    and live lse, dq, dk, dv on both backward routes on the peak rule
    (:data:`CHUNK_TOL`) against the plain versions; timed beside the
    plain versions and SDPA (:func:`_sdpa_yardstick`, its backend named;
    the dq and dk/dv rows carry SDPA's whole backward, no library call
    computing either alone)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_dkv, _flash_bwd_dkv_reference, _flash_bwd_dq,
        _flash_bwd_dq_reference, _flash_bwd_fused, _flash_bwd_reference,
        _flash_fwd, _flash_fwd_res, _head_dim_plan, _reference)
    from apex_tpu_torch.utils import build
    rows = []
    gen = torch.Generator().manual_seed(49)
    for name, B, heads, sq, sk, d in FLASH_CHUNK_EDGES:
        plan = _head_dim_plan(d)
        require(plan.route == "chunked", f"D {d}: plan {plan}")
        bh = B * heads
        for dtype in EDGE_DTYPES:
            dt = getattr(torch, dtype)
            tol = CHUNK_TOL[dtype]
            q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, "masked", gen,
                                          dt, dev)
            do = _randn(q.shape, gen, dt, dev)
            fargs = (q, k, v, bias, True, CHUNK_RATE, CHUNK_SEED, heads)
            before = dict(build.LAUNCHES)
            out, lse, stats = _flash_fwd_res(*fargs)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = fargs + (stats, delta, do)
            fused = _flash_bwd_fused(*args)
            dq = _flash_bwd_dq(*args)
            dkv = _flash_bwd_dkv(*args)
            torch.cuda.synchronize()
            for kname in ("flash_fwd", "flash_bwd", "flash_bwd_dq",
                          "flash_bwd_dkv"):
                require(build.LAUNCHES[kname] == before.get(kname, 0) + 1,
                        f"flash chunk {name} {dtype}: {kname} not one "
                        "launch")
            r_out, r_lse = _reference(*fargs)
            ok, o_err = peak_ok(out, r_out, tol)
            live = r_lse < 1e29
            l_err = rel_err(lse[live], r_lse[live])
            require(ok and l_err <= 1e-4, f"flash chunk {name} {dtype}: out "
                    f"err {o_err:.3g} (tol {tol}, peak), lse {l_err:.3g}")
            ref = _flash_bwd_reference(*args)
            errs, norms = {}, {}
            for gname, a, r in (("fused dq", fused[0], ref[0]),
                                ("fused dk", fused[1], ref[1]),
                                ("fused dv", fused[2], ref[2]),
                                ("dq", dq, _flash_bwd_dq_reference(*args)),
                                ("dk", dkv[0], ref[1]),
                                ("dv", dkv[1], ref[2])):
                ok, errs[gname] = peak_ok(a, r, tol)
                norms[gname] = norm_rel(a, r)
                require(ok, f"flash chunk {name} {dtype} {gname}: err "
                        f"{errs[gname]:.3g} (tol {tol}, peak); in norm "
                        f"{norms[gname]:.3g}")
            require(torch.equal(fused[1], dkv[0])
                    and torch.equal(fused[2], dkv[1]),
                    f"flash chunk {name} {dtype}: the fused and dk/dv "
                    "kernels' dk / dv differ")
            log(f"  flash chunk {name} {dtype}: gradients in norm "
                + ", ".join(f"{g} {e:.3g}" for g, e in norms.items()))
            del ref
            es = q.element_size()
            pairs = sum(min(r + 1, sk) for r in range(sq)) * bh
            io = 4 * bh * sq * d * es + 2 * bh * sq * 4 + sq * sk * 4
            q4, k4, v4, do4 = (t.view(B, heads, -1, d)
                               for t in (q, k, v, do))
            causal = torch.ones(sq, sk, dtype=torch.bool,
                                device=dev).triu(1)
            mask = bias[0].masked_fill(causal, float("-inf")).to(dt)
            f_lms, b_lms, lib = _sdpa_yardstick(q4, k4, v4, mask, do4,
                                                CHUNK_RATE)
            case = f"{name} BH{bh}x{sq}x{sk}x{d} ({lib})"
            for kname, fn, plain, err, nbytes, flops, lms in (
                    ("flash_fwd", lambda: _flash_fwd(*fargs),
                     lambda: _reference(*fargs), o_err, io,
                     4.0 * d * pairs, f_lms),
                    ("flash_bwd", lambda: _flash_bwd_fused(*args),
                     lambda: _flash_bwd_reference(*args),
                     max(errs[g] for g in ("fused dq", "fused dk",
                                           "fused dv")),
                     io + 3 * bh * sq * d * es, 10.0 * d * pairs, b_lms),
                    ("flash_bwd_dq", lambda: _flash_bwd_dq(*args),
                     lambda: _flash_bwd_dq_reference(*args), errs["dq"],
                     io + bh * sq * d * es, 6.0 * d * pairs, b_lms),
                    ("flash_bwd_dkv", lambda: _flash_bwd_dkv(*args),
                     lambda: _flash_bwd_dkv_reference(*args),
                     max(errs["dk"], errs["dv"]),
                     io + 2 * bh * sk * d * es, 8.0 * d * pairs, b_lms)):
                bms, by = bound(nbytes, flops, dtype)
                ms = device_ms(fn, n=5, reps=5)
                pms = device_ms(plain, n=3, reps=5)
                rows.append(_edge_row(kname, case, dtype, err, tol, ms, pms,
                                      lms, bms, by))
            del q, k, v, do, out, fused, dq, dkv, args, fargs
            torch.cuda.empty_cache()
    return rows


def check_kv_head_dims(dev):
    """The key-major kernels' instances by head dim (ptxas spills most at D
    = 128): the fused kernel at BH 128 x 512 and the dk/dv kernel at BH 64
    x 4096, D = 32, 64 and 128, bf16, each held to its plain version (dk/dv
    on its first two heads) and timed against its bound."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_dkv, _flash_bwd_dkv_reference, _flash_bwd_fused,
        _flash_bwd_reference, _flash_fwd_res)
    gen = torch.Generator().manual_seed(23)
    for kernel, B, S in (("flash_bwd", 8, 512), ("flash_bwd_dkv", 4, 4096)):
        for d in (32, 64, 128):
            heads = 16
            bh = B * heads
            q, k, v, bias = _flash_inputs(B, heads, S, S, d, "zeros", gen,
                                          torch.bfloat16, dev)
            do = _randn(q.shape, gen, torch.bfloat16, dev)
            out, lse, stats = _flash_fwd_res(q, k, v, bias,
                                             False, 0.0, 0, heads)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, bias, False, 0.0, 0, heads, stats, delta, do)
            if kernel == "flash_bwd":
                def fn():
                    return _flash_bwd_fused(*args)
                got, ref = fn(), _flash_bwd_reference(*args)
                flops = 10.0 * d * S * S * bh
            else:
                def fn():
                    return _flash_bwd_dkv(*args)
                got = tuple(t[:2] for t in fn())
                ref = _flash_bwd_dkv_reference(q[:2], k[:2], v[:2], bias,
                                               False, 0.0, 0, 1, stats[:2],
                                               delta[:2], do[:2])
                flops = 8.0 * d * S * S * bh
            err = 0.0
            for a, r in zip(got, ref):
                ok, e = peak_ok(a, r, 2e-2)
                require(ok, f"{kernel} D={d}: err {e:.3g} (tol 2e-2)")
                err = max(err, e)
            del ref
            tensors = 7 if kernel == "flash_bwd" else 6   # dq or not
            nbytes = tensors * bh * S * d * 2 + 2 * bh * S * 4 \
                + bias.numel() * 4
            bms, by = bound(nbytes, flops, "bfloat16")
            ms = device_ms(fn)
            log(f"  {kernel} BH{bh}x{S}x{S}x{d} bf16 err {err:.3g} (tol 2e-2, "
                f"peak rule) | kernel {ms:.5f} ms  bound {bms:.5f} ms ({by}), "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            del q, k, v, do, out, lse, stats, delta, args, got
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3d: the fp16 slice's kernels against their plain versions
# ---------------------------------------------------------------------------

def mlp_flat_n() -> int:
    """The MLP's flat fp32 buffer: what FP16_Optimizer unscales a step."""
    import torch
    from apex_tpu_torch.multi_tensor_apply import TreeFlattener
    shapes = [(a, b) for a, b in zip(MLP_SIZES[:-1], MLP_SIZES[1:])] \
        + [(b,) for b in MLP_SIZES[1:]]
    return TreeFlattener([torch.empty(s, device="meta")
                          for s in shapes]).total


def dense_act_cases():
    """(M, K, N, dtype, activation, bias, x offset in elements) of phase
    3d: the MLP's layer shapes (fp16, bf16), the activations and the bias
    on the middle one; tails of the TMA route (M 8191, K 1000, N 136; M 1);
    x one element into its buffer (misaligned: the mma.sync route); the
    ragged shapes K or N not a multiple of 8 (mma.sync) and fp32."""
    layers = list(zip(MLP_SIZES[:-1], MLP_SIZES[1:]))
    cases = []
    for k, n in layers:
        for dtype in ("float16", "bfloat16"):
            cases.append((MLP_BATCH, k, n, dtype, "relu", True, 0))
    k, n = layers[1]
    cases += [(MLP_BATCH, k, n, "float16", "sigmoid", True, 0),
              (MLP_BATCH, k, n, "float16", "none", True, 0),
              (MLP_BATCH, k, n, "float16", "relu", False, 0)]
    for dtype in ("float16", "bfloat16"):
        cases += [(8191, 1000, 136, dtype, "relu", True, 0),
                  (1, 1024, 4096, dtype, "sigmoid", True, 0),
                  (1000, 1000, 1000, dtype, "relu", True, 1)]
    for dtype in ("float16", "bfloat16", "float32"):
        cases += [(1000, 1000, 1000, dtype, "relu", True, 0),
                  (10, 24, 12, dtype, "sigmoid", True, 0)]
    return cases


def _dense_inputs(m, k, n, dtype, has_bias, offset, gen, dev):
    import torch
    dt = getattr(torch, dtype)
    x = torch.randn(m * k + offset, generator=gen, device=dev).to(dt)
    x = x[offset:].view(m, k)
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(dt)
    b = torch.randn(n, generator=gen, device=dev).to(dt) if has_bias else None
    return x, w, b


def check_dense_routes(dev):
    """The route :func:`_route` names for each case of
    :func:`dense_act_cases` (the inputs of phase 3d again, from its seed),
    confirmed by the profiler: one profiled call of each, after a warm-up
    round under the profiler's schedule (as in :func:`profile_window`);
    the dense kernels' device events must be the routes' kernels.  Run
    after the timed paths, so that no profiler session precedes them."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from apex_tpu_torch.ops.fused_mlp import ROUTES, _route, fused_dense_act
    log("== dense_act routes on the card")
    gen = torch.Generator(device=dev).manual_seed(13)
    calls, want = [], collections.Counter()
    for m, k, n, dtype, act, has_bias, offset in dense_act_cases():
        x, w, b = _dense_inputs(m, k, n, dtype, has_bias, offset, gen, dev)
        calls.append(lambda x=x, w=w, b=b, a=act: fused_dense_act(x, w, b, a))
        want[ROUTES[_route(x, w)]] += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        prof.step()
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    got = {k: v for k, v in port_kernel_events(prof).items()
           if k.startswith("dense_act")}
    log(f"  profiler events {got}, the route function's kernels "
        f"{dict(want)}")
    require(got == dict(want), f"dense_act kernels launched {got}, the "
            f"route function names {dict(want)}")
    del calls
    torch.cuda.empty_cache()


def check_dense_act(dev):
    """The fused dense + activation kernels on :func:`dense_act_cases`:
    kernel vs plain, the route each case takes (``_route``; the profiler
    confirms it in :func:`check_dense_routes`), a repeat call's bits,
    device times, cuBLAS (addmm + activation) as the library yardstick,
    bound by operations."""
    import torch
    from apex_tpu_torch.ops.fused_mlp import (_route, fused_dense_act,
                                              fused_dense_act_reference)
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for m, k, n, dtype, act, has_bias, offset in dense_act_cases():
        x, w, b = _dense_inputs(m, k, n, dtype, has_bias, offset, gen, dev)
        route = _route(x, w)
        out = fused_dense_act(x, w, b, act)
        torch.cuda.synchronize()
        ref = fused_dense_act_reference(x, w, b, act)
        tol = DENSE_TOL[dtype]
        ok, err = scaled_ok(out, ref, tol)
        case = (f"{m}x{k}@{k}x{n} {dtype} {act}"
                f"{'' if has_bias else ' no-bias'}"
                f"{' x+1' if offset else ''}")
        require(ok, f"dense_act {case}: err {err:.3g} (tol {tol})")
        require(torch.equal(fused_dense_act(x, w, b, act), out),
                f"dense_act {case}: a second call gave other bits")
        del out, ref
        es = x.element_size()
        bms, by = bound((m * k + k * n + m * n + (n if has_bias else 0)) * es,
                        2.0 * m * n * k, dtype)
        big = m * n * k > 1e9
        ms = device_ms(lambda: fused_dense_act(x, w, b, act))
        pms = device_ms(lambda: fused_dense_act_reference(x, w, b, act),
                        n=3 if big else 20, reps=5 if big else 10)

        def library():
            h = torch.addmm(b, x, w) if has_bias else torch.mm(x, w)
            if act == "relu":
                h.relu_()
            elif act == "sigmoid":
                h.sigmoid_()
            return h
        lms = device_ms(library)
        rows.append(dict(shape=(m, k, n), dtype=dtype, activation=act,
                         bias=has_bias, offset=offset, route=route,
                         max_abs_err=err, tol=tol, ms=ms,
                         plain_ms=pms, library_ms=lms,
                         library="torch.addmm + activation (cuBLAS)",
                         bound_ms=bms, bound_by=by,
                         tflops=2.0 * m * n * k / ms / 1e9))
        _report("dense_act", f"{case:42s} {route:4s}", err, tol, ms, pms,
                lms, bms, by, f" [{2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s]")
        del x, w, b
    torch.cuda.empty_cache()
    return rows


def check_scale_axpby(dev):
    """multi_tensor_scale (fp32 and fp16 in, fp32 out) and
    multi_tensor_axpby (fp32) over the MLP's flat buffer and 134 M
    elements: bit-identical to the plain versions with the same flag, the
    flag set by an injected inf; device times; the library yardstick for
    the scale is torch._amp_foreach_non_finite_check_and_unscale_ (what
    GradScaler.unscale_ calls), in place on a copy."""
    import torch
    from apex_tpu_torch.multi_tensor_apply import kernels
    gen = torch.Generator(device=dev).manual_seed(14)
    inv = torch.tensor(1.0 / 65536, device=dev)   # 1 / loss_scale, on the card
    rows = []
    for n in (mlp_flat_n(), BIG_FLAT_N):
        for in_dtype in ("float32", "float16"):
            x = (torch.randn(n, generator=gen, device=dev) * 100).to(
                getattr(torch, in_dtype))
            out, flag = kernels.multi_tensor_scale(x, inv, torch.float32)
            ref, rflag = kernels.multi_tensor_scale_reference(
                x, inv, torch.float32)
            torch.cuda.synchronize()
            require(torch.equal(out, ref) and int(flag) == int(rflag) == 0,
                    f"mt_scale ({n},) {in_dtype}: differs from plain or "
                    f"flagged (flag {int(flag)}, plain {int(rflag)})")
            err = float((out - ref).abs().max())
            del out, ref
            bad = x.clone()
            bad[n // 3] = float("inf")
            out, flag = kernels.multi_tensor_scale(bad, inv, torch.float32)
            torch.cuda.synchronize()
            require(int(flag) == 1 and not bool(torch.isfinite(out[n // 3])),
                    f"mt_scale ({n},) {in_dtype}: an inf did not set the flag")
            del out, bad
            bms, by = bound(n * (x.element_size() + 4), 1.0 * n, "float32")
            ms = device_ms(lambda: kernels.multi_tensor_scale(
                x, inv, torch.float32))
            pms = device_ms(lambda: kernels.multi_tensor_scale_reference(
                x, inv, torch.float32), n=3, reps=5)
            lms = None
            if in_dtype == "float32":
                buf = x.clone()
                found = torch.zeros(1, device=dev)
                inv1 = inv.reshape(1)
                lms = device_ms(
                    lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                        [buf], found, inv1))
                del buf
            rows.append(dict(kernel="mt_scale", n=n, dtype=in_dtype,
                             max_abs_err=err, tol="bit-identical", ms=ms,
                             plain_ms=pms, library_ms=lms,
                             library="torch._amp_foreach_non_finite_check_"
                                     "and_unscale_" if lms else None,
                             bound_ms=bms, bound_by=by))
            _report("mt_scale", f"({n},) {in_dtype:8s}->fp32", err,
                    "bit-identical", ms, pms, lms, bms, by,
                    " [flag set by an injected inf]")
            del x
            torch.cuda.empty_cache()
        x = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(n, generator=gen, device=dev)
        out, flag = kernels.multi_tensor_axpby(x, y, 2.0, -0.5)
        ref, rflag = kernels.multi_tensor_axpby_reference(x, y, 2.0, -0.5)
        torch.cuda.synchronize()
        require(torch.equal(out, ref) and int(flag) == int(rflag) == 0,
                f"mt_axpby ({n},): differs from plain or flagged")
        del out, ref
        y[n - 5] = float("-inf")
        _, flag = kernels.multi_tensor_axpby(x, y, 2.0, -0.5)
        require(int(flag) == 1, f"mt_axpby ({n},): an inf did not set the "
                "flag")
        y[n - 5] = 0.0
        bms, by = bound(12.0 * n, 3.0 * n, "float32")
        ms = device_ms(lambda: kernels.multi_tensor_axpby(x, y, 2.0, -0.5))
        pms = device_ms(lambda: kernels.multi_tensor_axpby_reference(
            x, y, 2.0, -0.5), n=3, reps=5)
        rows.append(dict(kernel="mt_axpby", n=n, dtype="float32",
                         max_abs_err=0.0, tol="bit-identical", ms=ms,
                         plain_ms=pms, library_ms=None, bound_ms=bms,
                         bound_by=by))
        _report("mt_axpby", f"({n},) float32 ", 0.0, "bit-identical", ms, pms,
                None, bms, by, " [flag set by an injected inf]")
        del x, y
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve parity, card vs CPU
# ---------------------------------------------------------------------------

def phase_serve_parity(dev):
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.serve import CacheConfig, InferenceEngine
    log("== phase 4: serve parity (2 layers, BERT-large width, fp32, card "
        "vs CPU)")
    cfg = bert_large_config(num_layers=2, causal=True, attn_impl="fast")
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    cache = CacheConfig(page_size=16, num_pages=40, max_ctx=512)
    W = 8
    engines = [InferenceEngine(params, cfg, cache=cache, olevel="fp32",
                               decode_width=W, device=d)
               for d in (dev, "cpu")]
    rng = np.random.default_rng(4)
    plen = 300
    tokens = np.zeros(cache.max_ctx, np.int64)
    tokens[:plen] = rng.integers(1, cfg.vocab_size, plen)
    table = np.zeros(cache.pages_per_request, np.int64)
    table[:32] = np.arange(1, 33)
    (g_first, g_last), (c_first, c_last) = (
        e.prefill(tokens, plen, table, seed=0) for e in engines)
    err = float((g_last.cpu() - c_last).abs().max())
    require(err <= 1e-3, f"prefill last-row logits differ by {err:.3g}")
    require(int(g_first) == int(c_first), "prefill greedy tokens differ")
    log(f"  prefill last-row logits max abs diff {err:.3g} (tol 1e-3)")
    cur = np.zeros(W, np.int64)
    pos = np.zeros(W, np.int64)
    tables = np.zeros((W, cache.pages_per_request), np.int64)
    cur[0], pos[0], tables[0] = int(g_first), plen, table
    zeros = np.zeros(W, np.int64)
    temps = np.zeros(W, np.float32)
    g_toks, c_toks, d_err = [], [], 0.0
    for _ in range(8):
        (gt, gl), (ct, cl) = (e.decode_step(cur, pos, tables, zeros, temps,
                                            zeros) for e in engines)
        d_err = max(d_err, float((gl[0].cpu() - cl[0]).abs().max()))
        g_toks.append(int(gt[0]))
        c_toks.append(int(ct[0]))
        cur[0], pos[0] = g_toks[-1], pos[0] + 1
    require(g_toks == c_toks, f"greedy decode tokens differ: card {g_toks} "
            f"cpu {c_toks}")
    require(d_err <= 1e-3, f"decode logits differ by {d_err:.3g}")
    log(f"  8 greedy decode tokens identical {g_toks}; decode logits max abs "
        f"diff {d_err:.3g} (tol 1e-3)")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def _trace(cfg, n=16, seed=0):
    """The bench's serve mix at full width: prompts 32-448 tokens, 16-32 new
    tokens, half greedy, half temperature 0.8 with top-k 8."""
    from apex_tpu_torch.serve import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(32, 449))
        reqs.append(Request(
            rid=f"q{i}",
            prompt=rng.integers(1, cfg.vocab_size, plen).tolist(),
            max_new_tokens=int(rng.integers(16, 33)),
            temperature=0.8 if i % 2 else 0.0, top_k=8 if i % 2 else 0,
            seed=i))
    return reqs


def phase_main_path(dev, card, profile=False):
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                      InferenceEngine, Request)
    from apex_tpu_torch.telemetry.serve_ledger import serve_violations
    from apex_tpu_torch.utils import build
    log("== phase 5: serving path (BERT-large width, 24 layers, bf16, fast "
        "attention, 16-request trace)")
    cfg = bert_large_config(causal=True, attn_impl="fast")
    t0 = time.perf_counter()
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    cache = CacheConfig(page_size=16, num_pages=257, max_ctx=512)
    eng = InferenceEngine(params, cfg, cache=cache, olevel="bf16",
                          decode_width=8, device=dev)
    del params
    torch.cuda.synchronize()
    log(f"  weights from seed 0 + engine on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    warm = ContinuousBatcher(eng)           # warm-up outside the counts
    for i in range(2):
        warm.submit(Request(rid=f"w{i}", prompt=[5 + i] * (40 + i),
                            max_new_tokens=4, seed=100 + i))
    warm.run()
    torch.cuda.synchronize()

    reqs = _trace(cfg)
    bat = ContinuousBatcher(eng)
    for r in reqs:
        bat.submit(r)
    p0, d0 = eng.prefills, eng.decode_steps
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    prefills, decodes = eng.prefills - p0, eng.decode_steps - d0

    require(len(results) == len(reqs) and all(
        r.status == "done" for r in results.values()),
        f"not every request done: "
        f"{ {k: v.status for k, v in results.items()} }")
    for r in reqs:
        toks = results[r.rid].tokens
        require(len(toks) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in toks),
            f"{r.rid}: bad tokens {toks}")
    doc = bat.ledger.snapshot(olevel="bf16", decode_width=8)
    bad = serve_violations(doc)
    require(not bad, f"serve ledger violations: {bad}")
    RESULTS["serve_tokens"] = {rid: list(r.tokens)
                               for rid, r in results.items()}
    L = cfg.num_layers
    require(prefills == len(reqs), f"{prefills} prefills for {len(reqs)} "
            "requests")
    require(launches.get("flash_fwd", 0) == L * prefills,
            f"flash_fwd launched {launches.get('flash_fwd', 0)} times, "
            f"expected {L} per prefill x {prefills}")
    require(launches.get("ln_fwd", 0) == (2 * L + 2) * (prefills + decodes),
            f"ln_fwd launched {launches.get('ln_fwd', 0)} times, expected "
            f"{2 * L + 2} per step x {prefills + decodes}")
    log(f"  {len(results)} requests done, {doc['tokens_out']} tokens, "
        f"{prefills} prefills, {decodes} decode steps, {bat.host_reads} host "
        f"reads; launches {launches}")
    lat = doc["latency_ms"]
    RESULTS["serve_wall_s"] = wall
    RESULTS["serve_tokens_per_sec"] = doc["tokens_per_sec"]
    log(f"  [{card}] tokens/s {doc['tokens_per_sec']}  TTFT p50 "
        f"{lat['ttft_p50']} ms  latency p50 {lat['p50']} ms  p99 "
        f"{lat['p99']} ms  (trace wall {wall:.3f} s)")

    # step times, after the counted run: prefill of a 448-token prompt and
    # decode steps with all 8 slots active
    S, PPR = cache.max_ctx, cache.pages_per_request
    tokens = np.zeros(S, np.int64)
    tokens[:448] = np.arange(448) % (cfg.vocab_size - 1) + 1
    table = np.arange(1, PPR + 1)
    prefill_ms = time_ms(lambda: eng.prefill(tokens, 448, table, 0),
                         reps=10, warmup=2)
    W = eng.decode_width
    tables = np.tile(table, (W, 1))
    pos = np.full(W, 460)
    ones = np.ones(W, np.int64)
    temps = np.where(np.arange(W) % 2, 0.8, 0.0).astype(np.float32)
    topks = np.where(np.arange(W) % 2, 8, 0)
    decode_ms = time_ms(lambda: eng.decode_step(ones, pos, tables, ones,
                                                temps, topks),
                        reps=20, warmup=3)
    log(f"  [{card}] median prefill (448-token prompt) {prefill_ms:.3f} ms  "
        f"median decode step (8 slots) {decode_ms:.3f} ms")
    if profile:
        def serve_steps():
            eng.prefill(tokens, 448, table, 0)
            for _ in range(4):
                eng.decode_step(ones, pos, tables, ones, temps, topks)
        profile_window(serve_steps, "serve", "one prefill and 4 decode steps")
    return launches, doc


def kernel_us(avgs) -> float:
    """Device time of a profile in us: the kernels' own events only, as the
    profiler table's footer counts it (an operator's row repeats the time
    of the kernels it launched, so summing every row counts it twice)."""
    from torch.autograd import DeviceType
    return sum(getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0)) for a in avgs
               if a.device_type == DeviceType.CUDA
               and not a.is_user_annotation)


# ---------------------------------------------------------------------------
# phase 23: the training telemetry on the serving and O5 paths
# ---------------------------------------------------------------------------

TELEMETRY_DIR = os.path.join(HERE, "build", "telemetry")
TEL_STEPS = 8
TEL_FLUSH = 4
#: the sentinel leg's steps: 4 products of this square fp32 size (~10 ms
#: on the card), the ninth step 0.5 s slower
SENTINEL_N = 4096


def _scrape(url):
    """One GET of the local metrics endpoint (no proxy)."""
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=10) as resp:
        return resp.read().decode()


def phase_telemetry(dev, card, launches_by_path):
    """(a) Phase 5's serving trace through a ``ContinuousBatcher`` with a
    registry (JSONL sink), a tracer and a scraped ``MetricsExporter``;
    (b) phase 7's O5 step with each step in ``registry.step()``, the
    metric calls under ``torch.cuda.set_sync_debug_mode("error")``,
    ``observe_amp`` a step, a ``MemoryMonitor`` and a ``GoodputLedger``,
    then as many steps with telemetry off, timed beside them; (c) a real ``torch.cuda.OutOfMemoryError`` through ``dump_oom``; (d) an
    injected slow step through the sentinel's ``torch.profiler`` capture.
    Every artifact passes the port's validators (the JAX package's
    schemas), the launch counts are phases 5 and 7's, and each flush reads
    the device once.  Runs last, so no profiler session precedes the timed
    paths."""
    import shutil
    import torch
    from apex_tpu_torch import telemetry as tel
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                      InferenceEngine, Request)
    from apex_tpu_torch.telemetry import export, goodput, memory, report
    from apex_tpu_torch.telemetry.serve_ledger import serve_violations
    from apex_tpu_torch.train import train_step
    from apex_tpu_torch.utils import build
    log("== phase 23: telemetry on the serving and O5 paths (registry, "
        "tracer, live export, memory monitor, goodput ledger, OOM dump, "
        "slow-step sentinel)")
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    os.makedirs(TELEMETRY_DIR)
    prev_tracer = tel.set_tracer(None)
    prev_reg = tel.set_default(None)
    prev_led = goodput.install(None)
    try:
        # (a) serving
        cfg = bert_large_config(causal=True, attn_impl="fast")
        params = transformer_init(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
        eng = InferenceEngine(params, cfg, cache=CacheConfig(
            page_size=16, num_pages=257, max_ctx=512), olevel="bf16",
            decode_width=8, device=dev)
        del params
        warm = ContinuousBatcher(eng)
        for i in range(2):
            warm.submit(Request(rid=f"w{i}", prompt=[5 + i] * (40 + i),
                                max_new_tokens=4, seed=100 + i))
        warm.run()
        jsonl = os.path.join(TELEMETRY_DIR, "serve.jsonl")
        with export.MetricsExporter(port=0, run_id="serve") as exp:
            reg = tel.Registry(sink=tel.JsonlSink(jsonl), flush_interval=0,
                               rank0_only=False, run_id="serve",
                               memory=False, goodput=False, exporter=exp)
            tracer = tel.Tracer(enabled=True)
            bat = ContinuousBatcher(eng, registry=reg, tracer=tracer)
            reqs = _trace(cfg)
            for r in reqs:
                bat.submit(r)
            build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = bat.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            reg.close()
            text = _scrape(exp.url)
        # the host cost of the scheduler's per-step telemetry: the
        # ledger's gauges (refreshed every step) and one span
        t0 = time.perf_counter()
        for _ in range(100):
            bat.ledger.observe(reg)
        observe_ms = (time.perf_counter() - t0) * 10
        t0 = time.perf_counter()
        for _ in range(100):
            with tracer.span("serve.decode", step=0, active=8):
                pass
        span_us = (time.perf_counter() - t0) * 1e4
        spath = bat.ledger.write(directory=TELEMETRY_DIR, olevel="bf16",
                                 decode_width=8)
        del eng, bat, warm
        torch.cuda.empty_cache()
        recs = report.load_records(jsonl, validate=True)
        require(len(results) == len(reqs) and all(
            r.status == "done" for r in results.values()),
            "telemetry serving: not every request done")
        require(not tel.records_violations(recs), "serve records off-schema")
        require(not serve_violations(json.load(open(spath))),
                "SERVE.json off-schema")
        serve_launches = launches_by_path["serve"]
        require(launches == serve_launches, f"telemetry serving launches "
                f"{launches}, phase 5's {serve_launches}")
        gauges = [ln.split()[0] for ln in text.splitlines()
                  if ln.startswith("apex_tpu_serve_")]
        require({"apex_tpu_serve_p99_ms", "apex_tpu_serve_requests_served",
                 "apex_tpu_serve_tokens_per_sec"} <= set(gauges),
                f"serve.* gauges missing from the scrape: {gauges}")
        names = [r["name"] for r in recs if r["kind"] == "event"]
        require(names.count("serve.finish") == len(reqs)
                and names.count("serve.admit") == len(reqs),
                "serve.admit / serve.finish events: one a request")
        spans = tracer.export()["traceEvents"]
        n_prefill = sum(1 for e in spans if e.get("name") == "serve.prefill")
        require(n_prefill == len(reqs), f"{n_prefill} serve.prefill spans")
        log(f"  {len(results)} requests done; {len(recs)} records, "
            f"{len(names)} events, {len(spans)} trace events; scrape "
            f"{len(text)} bytes with {len(gauges)} serve.* series; launches "
            f"phase 5's {launches}")
        log(f"  [{card}] trace wall with telemetry {wall:.3f} s, phase 5 "
            f"without {RESULTS.get('serve_wall_s', float('nan')):.3f} s "
            f"(host clock; not gated); host cost a scheduler step: the "
            f"ledger's gauges {observe_ms:.3f} ms, a span {span_us:.2f} us")

        # (b) the O5 step
        cfg = bert_large_config(attn_impl="fast", remat=True,
                                dtype=torch.bfloat16)
        params = transformer_init(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
        st = _train_state(params, None)
        del params
        batch = _batch(cfg, 8, 512, 7, dev)
        st, loss = train_step(st, batch, cfg)          # warm-up
        torch.cuda.synchronize()
        tracer = tel.Tracer(enabled=True, flight_dir=TELEMETRY_DIR)
        led = goodput.GoodputLedger()
        led.attach(tracer)
        goodput.install(led)
        tel.set_tracer(tracer)
        mon = memory.MemoryMonitor(enabled=True)
        sink = tel.JsonlSink(os.path.join(TELEMETRY_DIR, "train.jsonl"))
        reg = tel.Registry(sink=sink, flush_interval=TEL_FLUSH,
                           rank0_only=False, run_id="o5", memory=mon,
                           exporter=False)
        tel.set_default(reg)
        build.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        times, kinds = [], []
        for _ in range(TEL_STEPS):
            t0 = time.perf_counter()
            with reg.step():
                prev = st
                st, loss = train_step(st, batch, cfg)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with tel.span("metrics"):
                        reg.gauge("loss").set(loss)
                        reg.histogram("loss_hist").observe(loss)
                        reg.counter("tokens").add(8 * 512)
                        reg.gauge("loss_scale").set(st.scalers[0].loss_scale)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            kinds += tel.observe_amp(reg, prev, st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = dict(build.LAUNCHES)
        reads = reg.device_reads
        reg.close()
        peak = torch.cuda.max_memory_allocated()
        led.detach(tracer)
        gdoc = led.snapshot(status="completed")
        gpath = led.write(directory=TELEMETRY_DIR, doc=gdoc)
        # observe_amp syncs once a call (one read of the scaler's four
        # scalars), outside the registry's count: its cost on an idle card
        areg = tel.Registry(sink=tel.MemorySink(), enabled=True,
                            rank0_only=False, memory=False, goodput=False,
                            exporter=False)
        t0 = time.perf_counter()
        for _ in range(20):
            tel.observe_amp(areg, prev, st)
        amp_ms = (time.perf_counter() - t0) / 20 * 1e3
        areg.close()
        # the same step with telemetry off, just after in this phase, the
        # process defaults cleared (phase 7's steps ran minutes earlier)
        saved = (tel.set_tracer(None), tel.set_default(None),
                 goodput.install(None))
        off = []
        for _ in range(TEL_STEPS):
            t0 = time.perf_counter()
            st, loss = train_step(st, batch, cfg)
            torch.cuda.synchronize()
            off.append(time.perf_counter() - t0)
        tel.set_tracer(saved[0])
        tel.set_default(saved[1])
        goodput.install(saved[2])
        require(reads == TEL_STEPS // TEL_FLUSH and reg.device_reads == reads,
                f"registry device reads {reads} (then {reg.device_reads}) "
                f"for {TEL_STEPS // TEL_FLUSH} flushes")
        base = launches_by_path["o5_lamb"]
        require(set(launches) == set(base) and all(
            launches[k] * 5 == base[k] * TEL_STEPS for k in base),
            f"O5 launches in {TEL_STEPS} steps {launches}, phase 7's in 5 "
            f"{base}")
        require(kinds == ["steady"] * TEL_STEPS, f"scaler kinds {kinds}")
        recs = report.load_records(sink.path, validate=True)
        require(not goodput.goodput_violations(json.load(open(gpath))),
                "GOODPUT.json off-schema")
        require(gdoc["steps"] == TEL_STEPS, f"goodput steps {gdoc['steps']}")
        require(mon.history and mon.history[-1]["peak_bytes_in_use"] == peak,
                f"monitor peak {mon.history[-1] if mon.history else None} "
                f"!= max_memory_allocated {peak}")
        summ = report.summarize(recs)
        step_ms = statistics.median(times) * 1e3
        log(f"  {TEL_STEPS} steps, {reads} flushes of one device read each "
            f"(the registry's); observe_amp one read a step, outside that "
            f"count, {amp_ms:.3f} ms a call on an idle card; "
            f"goodput {gdoc['goodput_fraction']:.4f} of {gdoc['wall_ms']:.1f} "
            f"ms ({gpath}); peak {peak / 2 ** 30:.2f} GiB (monitor = "
            f"max_memory_allocated); summary step time "
            f"{summ['step_time_ms']['mean']:.2f} ms; launches phase 7's a "
            f"step")
        off_ms = statistics.median(off) * 1e3
        p7_ms = RESULTS.get("o5_lamb_step_ms", float("nan"))
        log(f"  [{card}] O5 step with telemetry {step_ms:.2f} ms (median of "
            f"{TEL_STEPS}; all {[round(t * 1e3, 2) for t in times]}); "
            f"without, just after: {off_ms:.2f} ms (all "
            f"{[round(t * 1e3, 2) for t in off]}; {step_ms / off_ms - 1:+.1%}"
            f"); phase 7 without {p7_ms:.2f} ms ({step_ms / p7_ms - 1:+.1%})"
            f" (host clock; not gated)")

        # (c) a real OOM through the post-mortem
        try:
            torch.empty(2 ** 40, dtype=torch.uint8, device=dev)
            err = None
        except Exception as e:                        # noqa: BLE001
            err = e
        require(err is not None and memory.is_oom_error(err),
                f"1 TiB allocation did not raise an OOM: {err!r}")
        opath = memory.dump_oom(tracer.recorder, step=TEL_STEPS, error=err,
                                directory=TELEMETRY_DIR, registry=reg)
        odoc = json.load(open(opath))
        require(not memory.oom_violations(odoc), "OOM dump off-schema")
        require(odoc["oom"]["requested_bytes"] == 2 ** 40,
                f"OOM requested bytes {odoc['oom']['requested_bytes']}")
        log(f"  OOM: {type(err).__name__} -> {os.path.basename(opath)}, "
            f"{len(odoc['oom']['allocations'])} live blocks, "
            f"{len(odoc['oom']['live_memory'])} monitor samples")
        del st, batch, loss, prev, err
        torch.cuda.empty_cache()

        # (d) the slow-step sentinel's one-shot profiler capture
        sent = tel.SlowStepSentinel(
            window=16, warmup=6, cooldown=4, dump_dir=TELEMETRY_DIR,
            profile_dir=os.path.join(TELEMETRY_DIR, "profile"),
            profile_steps=2)
        tracer = tel.Tracer(enabled=True, sentinel=sent)
        tel.set_tracer(tracer)
        sreg = tel.Registry(sink=tel.MemorySink(), flush_interval=0,
                            rank0_only=False, memory=False, goodput=False,
                            exporter=False)
        x = torch.randn(SENTINEL_N, SENTINEL_N, device=dev)
        for i in range(12):
            with sreg.step():
                for _ in range(4):
                    x = torch.tanh(x @ x * 1e-3)
                torch.cuda.synchronize()
                if i == 8:
                    time.sleep(0.5)              # the injected slow step
        sent.stop_capture()
        dumps = [f for f in os.listdir(TELEMETRY_DIR)
                 if f.startswith("flight-slow_step-")]
        require(sent.fires == 1 and sent.captures == 1
                and len(sent.capture_paths) == 1 and len(dumps) == 1,
                f"sentinel fires {sent.fires}, captures {sent.captures}, "
                f"dumps {dumps}")
        if not dumps:
            return
        sdoc = json.load(open(os.path.join(TELEMETRY_DIR, dumps[0])))
        require(not tel.trace.dump_violations(sdoc), "slow-step dump "
                "off-schema")
        cap = tel.trace.load_chrome(sent.capture_paths[0])
        log(f"  sentinel: fired at step {sdoc['step']}, dump {dumps[0]}, "
            f"profiler capture {os.path.basename(sent.capture_paths[0])} "
            f"with {len(cap)} complete events")
    finally:
        tel.set_tracer(prev_tracer)
        tel.set_default(prev_reg)
        goodput.install(prev_led)
        export.shutdown()


# ---------------------------------------------------------------------------
# phase 6: training parity, card vs CPU
# ---------------------------------------------------------------------------

def _train_state(params, cfg_dtype_override):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedLAMB
    return amp.initialize(
        params, FusedLAMB(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0,
                          impl="fused"),
        opt_level="O5", cast_model_type=cfg_dtype_override, verbosity=0)


def _batch(cfg, batch, seq, seed, dev):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (batch, seq),
                             generator=gen).to(dev)
            for k in ("tokens", "targets")}


def phase_train_parity(dev):
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.train import train_step
    log("== phase 6: training parity (2 layers, BERT-large width, amp O5 "
        "with the fp32 model override, FusedLAMB fused, flash, remat; card "
        "vs CPU)")
    cfg = bert_large_config(num_layers=2, attn_impl="fast", remat=True)
    params = transformer_init(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    runs = []
    for d in (dev, torch.device("cpu")):
        st = _train_state({g: {n: t.to(d) for n, t in leaves.items()}
                           for g, leaves in params.items()}, torch.float32)
        batch = _batch(cfg, 2, 128, 6, d)
        losses = []
        for _ in range(3):
            st, loss = train_step(st, batch, cfg)
            losses.append(loss.item())
        runs.append((losses, st.opt_state.master.cpu()))
    (g_loss, g_master), (c_loss, c_master) = runs
    l_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    m_err = float((g_master - c_master).abs().max())
    require(l_err <= 1e-4, f"training losses differ by {l_err:.3g} "
            f"relative (tol 1e-4): card {g_loss} cpu {c_loss}")
    require(m_err <= 1e-4, f"flat masters differ by {m_err:.3g} after 3 "
            "steps (tol 1e-4)")
    log(f"  losses card {g_loss} cpu {c_loss}: max rel diff {l_err:.3g} "
        f"(tol 1e-4); flat masters max abs diff {m_err:.3g} (tol 1e-4)")


# ---------------------------------------------------------------------------
# phase 7: the training path
# ---------------------------------------------------------------------------

def phase_train(dev, card, profile=False):
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.train import train_step
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log("== phase 7: training path (BERT-large, 24 layers, bf16, amp O5 + "
        "FusedLAMB fused, flash, remat, batch 8 x 512)")
    cfg = bert_large_config(attn_impl="fast", remat=True,
                            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    st = _train_state(params, None)
    del params
    batch = _batch(cfg, 8, 512, 7, dev)
    torch.cuda.synchronize()
    log(f"  {n_params} parameters from seed 0, amp state on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    st, loss = train_step(st, batch, cfg)          # warm-up
    losses = [loss.item()]
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        st, loss = train_step(st, batch, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(float(st.loss_scale) == 1.0, f"loss scale {float(st.loss_scale)}")
    require(st.model_params["layers"]["wqkv"].dtype == torch.bfloat16
            and st.opt_state.master.dtype == torch.float32,
            "O5 dtypes: bf16 model, fp32 flat masters")
    check_launches("o5_lamb", launches, 5)
    step_s = statistics.median(times)
    RESULTS["o5_lamb_step_ms"] = step_s * 1e3
    tokens = 8 * 512
    mfu = 8 * n_params * tokens / step_s / 989e12
    log(f"  losses {[round(l, 5) for l in losses]}; launches in 5 steps "
        f"{launches}")
    log(f"  [{card}] step {step_s * 1e3:.2f} ms (median of 5; all "
        f"{[round(t * 1e3, 2) for t in times]}), {8 / step_s:.2f} "
        f"sequences/s, {tokens / step_s:.0f} tokens/s, peak device memory "
        f"{peak / 2 ** 30:.2f} GiB, analytic MFU {100 * mfu:.2f}% "
        f"(8 x {n_params} params x {tokens} tokens / step / 989 TFLOP/s "
        f"bf16; attention's S^2 term left out)")
    fb_ms, opt_ms = split_train_step(st, batch, cfg)
    log(f"  [{card}] of a step: forward + backward {fb_ms:.2f} ms, amp_step "
        f"(unscale, flatten, l2norm, FusedLAMB flat update, skip-select, "
        f"bf16 copy) {opt_ms:.2f} ms (medians of 3)")
    if profile:
        from apex_tpu_torch.train import train_step
        profile_window(lambda: train_step(st, batch, cfg), "train",
                       expect={"flash_bwd_kv_sm90_kernel": 24})
    return launches


def split_train_step(st, batch, cfg):
    """Host-clock ms of a step's two halves, each ending in a synchronize:
    the loss and its gradients, then ``amp_step`` (the state is left as
    it was)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import transformer_loss
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    fb, opt = [], []
    for _ in range(3):
        leaves, treedef = tree_flatten(st.model_params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = transformer_loss(tree_unflatten(treedef, leaves), batch, cfg)
        grads = torch.autograd.grad(amp.scale_loss(loss, st), leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        amp.amp_step(st, tree_unflatten(treedef, list(grads)))
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        opt.append(time.perf_counter() - t1)
    return statistics.median(fb) * 1e3, statistics.median(opt) * 1e3


def port_kernel_events(prof) -> dict:
    """Device events of the port's kernels in a profile, by CUDA function
    (``build.KERNEL_FUNCTIONS`` and ``AUX_FUNCTIONS``)."""
    from torch.autograd import DeviceType
    from apex_tpu_torch.utils import build
    funcs = sorted({f for names, _ in build.KERNEL_FUNCTIONS.values()
                    for f in names} | set(build.AUX_FUNCTIONS))
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in funcs:
                if f"::{k}<" in e.name or f"::{k}(" in e.name:
                    counts[k] = counts.get(k, 0) + 1
    return counts


def profile_window(fn, name, what="training step", expect=None):
    """torch.profiler over one call of ``fn`` (``what``), after one warm-up
    call under the profiler's schedule (``--profile``): device time by
    kernel, the port's kernels' events and the device's busy share of the
    window; the table goes to ``build/profile_<name>.txt``.  The warm-up
    call is there because a profiler's first kernels can be missing from
    its trace: profiled alone, the MLP step (whose first launches are its
    three dense_act kernels) listed none of them, and the long-sequence
    step two ln_fwd kernels fewer.  ``expect``: {kernel: events} the window
    must hold."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = kernel_us(avgs)
    events = port_kernel_events(prof)
    log(f"  profile ({name}): {what} window {window_ms:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / window_ms:.1f}%); the "
        f"port's kernels' events {events}")
    for k, n in (expect or {}).items():
        require(events.get(k, 0) == n, f"profile ({name}): {events.get(k, 0)}"
                f" {k} events in the window, expected {n}")
    table_txt = avgs.table(sort_by="self_cuda_time_total", row_limit=30)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(table_txt)
    for line in table_txt.splitlines()[:36]:
        log(f"  {line}")


# ---------------------------------------------------------------------------
# phases 8-9: the ZeRO path
# ---------------------------------------------------------------------------

def _mlm_batch(cfg, batch, seq, seed, dev):
    """The BERT example's synthetic MLM batch: 15 % of the tokens masked to
    id 0, the originals as targets, weights on the masked positions."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    mask = torch.rand((batch, seq), generator=gen) < 0.15
    return {"tokens": torch.where(mask, 0, tokens).to(dev),
            "targets": tokens.to(dev),
            "weights": mask.to(torch.float32).to(dev)}


def start_process_group():
    """A world-1 NCCL default group, rendezvous through a file under
    ``build/`` (no network port)."""
    from apex_tpu_torch.parallel import initialize_distributed
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, f"zero_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    initialize_distributed(init_file=store, rank=0, world_size=1)
    return store


def phase_zero_parity(dev):
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.train import zero_train_step
    log("== phase 8: ZeRO parity (2 layers, BERT-large width, fp32, "
        "DistributedFusedLAMB and DistributedFusedAdam fused at world 1; card "
        "over NCCL vs CPU over gloo)")
    gloo = dist.new_group(backend="gloo")
    cfg = bert_large_config(num_layers=2, attn_impl="fast", remat=True)
    params = transformer_init(cfg, torch.Generator().manual_seed(2),
                              device="cpu")
    makers = (
        ("LAMB", lambda group: DistributedFusedLAMB(
            lr=1e-3, weight_decay=0.01, max_grad_norm=1.0, impl="fused",
            shard_group=group)),
        ("Adam", lambda group: DistributedFusedAdam(
            lr=1e-3, weight_decay=0.01, impl="fused", shard_group=group)))
    for name, make in makers:
        runs = []
        for d, group in ((dev, None), (torch.device("cpu"), gloo)):
            p = {g: {n: t.to(d) for n, t in leaves.items()}
                 for g, leaves in params.items()}
            opt = make(group)
            st = opt.init(p)
            p0 = st.p.cpu()
            batch = _mlm_batch(cfg, 2, 128, 10, d)
            losses = []
            for _ in range(3):
                p, st, loss = zero_train_step(p, st, batch, cfg, opt)
                losses.append(loss.item())
            runs.append((losses, st.p.cpu()))
        (g_loss, g_p), (c_loss, c_p) = runs
        l_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
        p_err = float((g_p - c_p).abs().max())
        # the 3-step update as a whole: ||card - cpu|| / ||cpu - start||
        u_err = float((g_p - c_p).norm() / (c_p - p0).norm())
        require(l_err <= 1e-4, f"ZeRO {name} losses differ by {l_err:.3g} "
                f"relative (tol 1e-4): card {g_loss} cpu {c_loss}")
        if name == "LAMB":
            require(p_err <= 1e-4, f"ZeRO LAMB master shards differ by "
                    f"{p_err:.3g} after 3 steps (tol 1e-4)")
            limit = "max abs diff tol 1e-4"
        else:
            # Adam's eps (1e-8) lets an element whose gradient is near 0,
            # its sign the rounding of two devices' GEMMs, move by up to lr
            # a step either way: elementwise the shards agree only to ~lr,
            # so the update is held as a whole
            require(u_err <= 1e-3, f"ZeRO Adam updates differ by {u_err:.3g}"
                    f" relative in norm after 3 steps (tol 1e-3; max abs "
                    f"diff {p_err:.3g})")
            limit = "update norm tol 1e-3"
        log(f"  {name}: losses card {g_loss} cpu {c_loss}: max rel diff "
            f"{l_err:.3g} (tol 1e-4); master shards max abs diff {p_err:.3g},"
            f" update diff {u_err:.3g} relative in norm ({limit})")


def _zero_run(params, opt, batch, cfg, steps, label):
    """One warm-up and ``steps`` timed ZeRO steps; (launches, losses,
    step seconds, state, params)."""
    import torch
    from apex_tpu_torch.train import zero_train_step
    from apex_tpu_torch.utils import build
    st = opt.init(params)
    params, st, loss = zero_train_step(params, st, batch, cfg, opt)
    losses = [loss.item()]
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, st, loss = zero_train_step(params, st, batch, cfg, opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(build.LAUNCHES)
    require(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{label}: loss did not fall {losses}")
    log(f"  {label}: losses {[round(l, 5) for l in losses]}; launches in "
        f"{steps} steps {launches}")
    return launches, times, st, params


def phase_zero(dev, card, profile=False):
    import torch
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.utils.pytree import tree_leaves
    log("== phase 9: ZeRO path (BERT-large, 24 layers, fp32 params, bf16 "
        "activations, remat, flash, batch 8 x 512 MLM, DistributedFusedLAMB "
        "fused + bf16 all-gather, world-1 NCCL)")
    cfg = bert_large_config(attn_impl="fast", remat=True,
                            dtype=torch.bfloat16)
    params0 = transformer_init(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params0))
    batch = _mlm_batch(cfg, 8, 512, 11, dev)
    torch.cuda.reset_peak_memory_stats()
    opt = DistributedFusedLAMB(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0,
                               bf16_allgather=True, impl="fused")
    lamb_launches, times, st, params = _zero_run(params0, opt, batch, cfg,
                                                 5, "LAMB")
    peak = torch.cuda.max_memory_allocated()
    check_launches("zero_lamb", lamb_launches, 5)
    require(st.p.dtype == torch.float32 and st.p.numel() % 128 == 0,
            "ZeRO master shard: fp32 on the 128-element lattice")
    step_s = statistics.median(times)
    tokens = 8 * 512
    mfu = 8 * n_params * tokens / step_s / 989e12
    log(f"  [{card}] LAMB step {step_s * 1e3:.2f} ms (median of 5; all "
        f"{[round(t * 1e3, 2) for t in times]}), {8 / step_s:.2f} "
        f"sequences/s, {tokens / step_s:.0f} tokens/s, analytic MFU "
        f"{100 * mfu:.2f}% (8 x {n_params} params x {tokens} tokens / step "
        f"/ 989 TFLOP/s), peak device memory {peak / 2 ** 30:.2f} GiB, "
        f"master shard {st.p.numel()} fp32")
    fb_ms, opt_ms = split_zero_step(params, st, batch, cfg, opt)
    log(f"  [{card}] of a LAMB step: forward + backward {fb_ms:.2f} ms, "
        f"opt.step (flatten, reduce-scatter, norm, stage 1 kernel, trust "
        f"ratios, select, bf16 all-gather, unflatten) {opt_ms:.2f} ms "
        f"(medians of 3)")
    if profile:
        from apex_tpu_torch.train import zero_train_step
        profile_window(lambda: zero_train_step(params, st, batch, cfg, opt),
                       "zero", expect={"flash_bwd_kv_sm90_kernel": 24})
    del st, params
    torch.cuda.empty_cache()

    # lr 1e-4: at 1e-3 the repeated-batch loss of Adam rises again by its
    # fourth step; the witness below reads that trajectory twice
    opt = DistributedFusedAdam(lr=1e-4, weight_decay=0.01, impl="fused")
    adam_launches, times, st, params = _zero_run(params0, opt, batch, cfg,
                                                 3, "Adam")
    check_launches("zero_adam", adam_launches, 3)
    step_s = statistics.median(times)
    log(f"  [{card}] Adam step {step_s * 1e3:.2f} ms (median of 3; all "
        f"{[round(t * 1e3, 2) for t in times]}), {8 / step_s:.2f} "
        f"sequences/s")
    del st, params
    torch.cuda.empty_cache()
    adam_lr_witness(params0, batch, cfg)
    return lamb_launches, adam_launches


def adam_lr_witness(params0, batch, cfg, steps=4, tol=2e-2):
    """Adam at lr 1e-3 from the same weights and batch, read twice: through
    the kernel (``impl="fused"``) and through the same math as PyTorch ops
    (``impl="xla"``).  The two trajectories must agree step by step within
    ``tol`` relative, whichever way the loss goes."""
    import torch
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.train import zero_train_step
    runs = {}
    for impl in ("fused", "xla"):
        opt = DistributedFusedAdam(lr=1e-3, weight_decay=0.01, impl=impl)
        params, st, losses = params0, opt.init(params0), []
        for _ in range(steps):
            params, st, loss = zero_train_step(params, st, batch, cfg, opt)
            losses.append(loss.item())
        runs[impl] = losses
        del params, st
        torch.cuda.empty_cache()
    fused, xla = runs["fused"], runs["xla"]
    err = max(abs(a - b) / abs(b) for a, b in zip(fused, xla))
    require(all(np.isfinite(fused + xla)) and err <= tol,
            f"Adam lr 1e-3: fused {fused} vs xla {xla}, max rel diff "
            f"{err:.3g} (tol {tol})")
    log(f"  Adam lr 1e-3, {steps} steps: fused {[round(l, 5) for l in fused]}"
        f", xla {[round(l, 5) for l in xla]}: max rel diff {err:.3g} (tol "
        f"{tol})")


def split_zero_step(params, st, batch, cfg, opt):
    """Host-clock ms of a ZeRO step's two halves, each ending in a
    synchronize: the loss and its gradients, then ``opt.step``."""
    import torch
    from apex_tpu_torch.models import transformer_loss
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    fb, op = [], []
    for _ in range(3):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = transformer_loss(tree_unflatten(treedef, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.step(st, tree_unflatten(treedef, list(grads)), params)
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        op.append(time.perf_counter() - t1)
    return statistics.median(fb) * 1e3, statistics.median(op) * 1e3


# ---------------------------------------------------------------------------
# phase 10: the long-sequence path
# ---------------------------------------------------------------------------

def phase_long_seq(dev, card, profile=False):
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import _resolve_fuse
    from apex_tpu_torch.models import TransformerConfig, transformer_init
    from apex_tpu_torch.train import train_step
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log("== phase 10: long-sequence path (24 layers, d_model 1024, 16 heads, "
        "vocab 30592, seq 4096, batch 4, bf16, amp O5 + FusedLAMB fused, "
        "flash, remat)")
    B, heads, S, d = LONG_SHAPE
    cfg = TransformerConfig(vocab_size=30592, max_len=S, num_layers=24,
                            d_model=heads * d, num_heads=heads, d_ff=4096,
                            dtype=torch.bfloat16, attn_impl="fast",
                            remat=True)
    require(not _resolve_fuse(None, B * cfg.num_heads, S, S, cfg.head_dim),
            "the long-sequence shape should take the split route")
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    st = _train_state(params, None)
    del params
    batch = _batch(cfg, B, S, 12, dev)
    st, loss = train_step(st, batch, cfg)          # warm-up
    losses = [loss.item()]
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        st, loss = train_step(st, batch, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(float(st.loss_scale) == 1.0, f"loss scale {float(st.loss_scale)}")
    check_launches("long_seq", launches, 2)
    step_s = statistics.median(times)
    tokens = B * S
    mfu = 8 * n_params * tokens / step_s / 989e12
    # attention's S^2 products: 4 B S^2 d_model a layer forward, twice that
    # backward, and the remat forward again
    attn = 16.0 * cfg.num_layers * B * S * S * cfg.d_model
    mfu_attn = (8 * n_params * tokens + attn) / step_s / 989e12
    log(f"  losses {[round(l, 5) for l in losses]}; launches in 2 steps "
        f"{launches}")
    log(f"  [{card}] step {step_s * 1e3:.2f} ms (median of 2; all "
        f"{[round(t * 1e3, 2) for t in times]}), {B / step_s:.3f} "
        f"sequences/s, {tokens / step_s:.0f} tokens/s, peak device memory "
        f"{peak / 2 ** 30:.2f} GiB, analytic MFU {100 * mfu:.2f}% (params "
        f"term only, as phase 7) / {100 * mfu_attn:.2f}% with attention's "
        f"S^2 term (16 L B S^2 d_model)")
    fb_ms, opt_ms = split_train_step(st, batch, cfg)
    log(f"  [{card}] of a step: forward + backward {fb_ms:.2f} ms, amp_step "
        f"{opt_ms:.2f} ms (medians of 3)")
    if profile:
        profile_window(lambda: train_step(st, batch, cfg), "long_seq",
                       expect={"flash_bwd_kv_sm90_kernel": 24,
                               "flash_bwd_dq_sm90_kernel": 24})
    return launches


# ---------------------------------------------------------------------------
# phases 11-13: the fp16 MLP path and the multi_tensor_applier path
# ---------------------------------------------------------------------------

def _mlp_fp16_params(dev, seed=0):
    """The MLP's weights from ``seed``, drawn on the CPU, cast to fp16 on
    ``dev``."""
    import torch
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.utils.pytree import tree_map
    mlp = MLP(MLP_SIZES, activation="relu", use_pallas=True)
    params = mlp.init(torch.Generator().manual_seed(seed), device="cpu")
    return mlp, tree_map(lambda t: t.to(dev, torch.float16), params)


def _mlp_batch(batch, seed, dev):
    """x ~ N(0, 1) in fp16, a fixed target y ~ U(0, 1) in fp32."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, MLP_SIZES[0], generator=gen).half()
    y = torch.rand(batch, MLP_SIZES[-1], generator=gen)
    return {"x": x.to(dev), "y": y.to(dev)}


def _fp16_opt(params, lr):
    from apex_tpu_torch.contrib.optimizers import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedAdam
    return FP16_Optimizer(FusedAdam(lr=lr, impl="fused"), params,
                          dynamic_loss_scale=True)


# lr of the MLP path: at 1e-3 (the JAX tests' value) Adam's first, sign-like
# step overshoots at this width; phase 12 reads that trajectory too
MLP_LR = 1e-4


def phase_mlp_parity(dev):
    import torch
    from apex_tpu_torch.train import mlp_train_step
    from apex_tpu_torch.utils.pytree import tree_map
    log(f"== phase 11: MLP fp16 parity ({MLP_SIZES}, batch 256, "
        "FP16_Optimizer(FusedAdam fused), dynamic loss scale; card vs CPU; "
        "step 2's batch carries an inf)")
    mlp, params = _mlp_fp16_params(torch.device("cpu"), seed=1)
    runs = []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        batch = _mlp_batch(256, 15, d)
        bad = dict(batch, x=batch["x"].clone())
        bad["x"][7, 9] = float("inf")
        opt = _fp16_opt(p, MLP_LR)
        start = opt.opt_state.master.cpu()
        losses, skips, scales = [], [], []
        for b in (batch, bad, batch):
            p, loss = mlp_train_step(opt, p, b, mlp)
            losses.append(loss.item())
            skips.append(opt.overflow)
            scales.append(opt.loss_scale)
        runs.append((losses, skips, scales, opt.opt_state.master.cpu(),
                     start))
    (g_l, g_s, g_sc, g_m, start), (c_l, c_s, c_sc, c_m, _) = runs
    require(g_s == c_s == [False, True, False],
            f"skip patterns: card {g_s} cpu {c_s}, expected step 2 only")
    require(g_sc == c_sc == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15],
            f"loss scales: card {g_sc} cpu {c_sc}")
    require(not np.isfinite(g_l[1]) and not np.isfinite(c_l[1]),
            f"the overflow step's loss should not be finite: {g_l} {c_l}")
    l_err = max(abs(g_l[i] - c_l[i]) / abs(c_l[i]) for i in (0, 2))
    u_err = float((g_m - c_m).norm() / (c_m - start).norm())
    require(l_err <= 1e-3, f"MLP losses differ by {l_err:.3g} relative (tol "
            f"1e-3): card {g_l} cpu {c_l}")
    # Adam's first steps are sign-like: a gradient element whose sign the
    # fp16 rounding of the two devices' activations decides moves by ~lr
    # either way, so the update is held as a whole
    require(u_err <= 0.1, f"MLP master updates differ by {u_err:.3g} "
            "relative in norm (tol 0.1)")
    log(f"  losses card {g_l} cpu {c_l}: max rel diff {l_err:.3g} (tol 1e-3);"
        f" skipped {g_s} on both; loss scales {g_sc} on both; master update "
        f"diff {u_err:.3g} relative in norm (tol 0.1), max abs "
        f"{float((g_m - c_m).abs().max()):.3g}")


def phase_mlp(dev, card, profile=False):
    import torch
    from apex_tpu_torch.train import mlp_train_step
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log(f"== phase 12: MLP fp16 path ({MLP_SIZES}, relu, batch {MLP_BATCH}, "
        f"fp16 model, FP16_Optimizer(FusedAdam(lr={MLP_LR}, impl='fused'), "
        "dynamic loss scale))")
    mlp, params = _mlp_fp16_params(dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = _mlp_batch(MLP_BATCH, 16, dev)
    # earlier phases' tensors held only by reference cycles would
    # otherwise count in this path's peak
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    opt = _fp16_opt(params, MLP_LR)
    params, loss = mlp_train_step(opt, params, batch, mlp)     # warm-up
    losses, skips = [loss.item()], [opt.overflow]
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        params, loss = mlp_train_step(opt, params, batch, mlp)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        skips.append(opt.overflow)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    kept = [l for l, s in zip(losses, skips) if not s]
    require(all(np.isfinite(kept)) and len(kept) >= 2,
            f"MLP losses {losses}, skipped {skips}")
    require(kept[-1] < kept[0], f"MLP loss did not fall: {losses}")
    require(all(p.dtype == torch.float16 for p in tree_leaves(params))
            and opt.opt_state.master.dtype == torch.float32,
            "fp16 model, fp32 flat masters")
    check_launches("mlp_fp16", launches, 5, exact=True)
    step_s = statistics.median(times)
    mfu = 6 * n_params * MLP_BATCH / step_s / 989e12
    log(f"  losses {[round(l, 5) for l in losses]}, skipped {skips}, loss "
        f"scale {opt.loss_scale}; launches in 5 steps {launches}")
    log(f"  [{card}] step {step_s * 1e3:.3f} ms (median of 5; all "
        f"{[round(t * 1e3, 3) for t in times]}), {MLP_BATCH / step_s:.0f} "
        f"samples/s, analytic MFU {100 * mfu:.2f}% (6 x {n_params} params x "
        f"{MLP_BATCH} / step / 989 TFLOP/s fp16), peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    f_ms, b_ms, o_ms = split_mlp_step(opt, params, batch, mlp)
    log(f"  [{card}] of a step: forward (3 fused dense kernels) {f_ms:.3f} "
        f"ms, backward (fp32 products, masks, casts) {b_ms:.3f} ms, opt.step "
        f"(flatten, unscale kernel, flat Adam, select, scale update, fp16 "
        f"copies) {o_ms:.3f} ms (medians of 3)")
    if profile:
        profile_window(lambda: mlp_train_step(opt, params, batch, mlp),
                       "mlp_fp16", expect={"dense_act_sm90_kernel": 3,
                                           "dense_act_mma_kernel": 0})
    del opt, params
    torch.cuda.empty_cache()
    mlp_lr_witness(dev, batch)
    return launches


def split_mlp_step(opt, params, batch, mlp):
    """Host-clock ms of a step's three parts, each ending in a
    synchronize: the forward and loss, the backward, ``opt.step`` (which
    takes the step)."""
    import torch
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    parts = []
    for _ in range(3):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mlp(tree_unflatten(treedef, leaves), batch["x"])
        loss = ((out.float() - batch["y"]) ** 2).mean()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(opt.scale_loss(loss), leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params = opt.step(tree_unflatten(treedef, list(grads)))
        torch.cuda.synchronize()
        parts.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return tuple(statistics.median(p[i] for p in parts) * 1e3
                 for i in range(3))


def mlp_lr_witness(dev, batch, steps=4):
    """The same path at lr 1e-3 from the same weights and batch: its loss
    trajectory, printed (it must stay finite where no step was skipped)."""
    import torch
    from apex_tpu_torch.train import mlp_train_step
    mlp, params = _mlp_fp16_params(dev)
    opt = _fp16_opt(params, 1e-3)
    losses, skips = [], []
    for _ in range(steps):
        params, loss = mlp_train_step(opt, params, batch, mlp)
        losses.append(loss.item())
        skips.append(opt.overflow)
    require(all(np.isfinite(l) for l, s in zip(losses, skips) if not s),
            f"MLP lr 1e-3: non-finite loss {losses}")
    log(f"  lr 1e-3 witness, {steps} steps: losses "
        f"{[round(l, 5) for l in losses]}, skipped {skips}")
    del opt, params
    torch.cuda.empty_cache()


def phase_mt_apply(dev):
    """multi_tensor_scale and multi_tensor_axpby through the
    ``multi_tensor_applier`` facade, over the MLP's six parameter-shaped
    tensors (fp16, as the model's), each against its plain version on the
    same flat buffers."""
    import torch
    from apex_tpu_torch.multi_tensor_apply import (kernels,
                                                   multi_tensor_applier)
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log("== phase 13: multi_tensor_applier path (scale 0.5, axpby 2, -0.5 "
        "over the MLP's six parameter-shaped fp16 tensors)")
    _, params = _mlp_fp16_params(dev, seed=2)
    xs = tree_leaves(params)
    gen = torch.Generator(device=dev).manual_seed(17)
    ys = [torch.randn(t.shape, generator=gen, device=dev).half() for t in xs]
    build.LAUNCHES.clear()
    (s_out, s_flag), fl = multi_tensor_applier(kernels.multi_tensor_scale,
                                               [xs], 0.5)
    (a_out, a_flag), _ = multi_tensor_applier(kernels.multi_tensor_axpby,
                                              [xs, ys], 2.0, -0.5)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    fx, fy = fl.flatten(xs), fl.flatten(ys)
    s_ref, s_rflag = kernels.multi_tensor_scale_reference(fx, 0.5)
    a_ref, a_rflag = kernels.multi_tensor_axpby_reference(fx, fy, 2.0, -0.5)
    require(torch.equal(s_out, s_ref) and int(s_flag) == int(s_rflag) == 0,
            "applier scale differs from plain")
    require(torch.equal(a_out, a_ref) and int(a_flag) == int(a_rflag) == 0,
            "applier axpby differs from plain")
    want = dict({k: 0 for k in ALL_KERNELS}, mt_scale=1, mt_axpby=1)
    for name, n in want.items():
        require(launches.get(name, 0) == n, f"mt_apply: {name} launched "
                f"{launches.get(name, 0)} times, expected {n}")
    log(f"  {len(xs)} tensors, flat {fl.total} fp32; scale and axpby "
        f"bit-identical to plain, flags 0; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phases 14-15: the imagenet example's ResNet-50 (BASELINE configs 2 and 3)
# ---------------------------------------------------------------------------

# examples/imagenet/main_amp.py: the default global batch, the image side,
# the synthetic pool's classes and noise, FusedAdam's lr
RN50_BATCH = 128
RN50_HW = 224
SYN_CLASSES = 64
SYN_NOISE = 0.08
RN50_LR = 1e-3
# timed steps of config 2 (after one warm-up): over the first ~10 the loss
# moves about its start while the first steps are skipped and Adam's
# sign-like steps settle; it falls clearly over 20
RN50_STEPS = 20


def resnet_flops(cfg, hw: int) -> float:
    """Forward FLOPs of one image: 2 x the multiply-adds of every
    convolution (output positions x kh x kw x cin x cout, "SAME" output
    sizes) and of the fc layer."""
    def conv(size, k, cin, cout, stride):
        out = -(-size // stride)
        return out, 2.0 * out * out * k * k * cin * cout

    expansion = 4 if cfg.block == "bottleneck" else 1
    size, flops = conv(hw, 7, 3, cfg.width, 2)
    size = -(-size // 2)                                # the max-pool
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * 2 ** si
        cout = cmid * expansion
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            if cfg.block == "bottleneck":
                _, f1 = conv(size, 1, cin, cmid, 1)
                out, f2 = conv(size, 3, cmid, cmid, stride)
                _, f3 = conv(out, 1, cmid, cout, 1)
                flops += f1 + f2 + f3
            else:
                out, f1 = conv(size, 3, cin, cmid, stride)
                _, f2 = conv(out, 3, cmid, cout, 1)
                flops += f1 + f2
            if stride != 1 or cin != cout:
                flops += conv(size, 1, cin, cout, stride)[1]
            size, cin = out, cout
    return flops + 2.0 * cin * cfg.num_classes


def syn_batches(dev, batch, seed, steps):
    """The example's synthetic ImageNet batches (``synthetic_batches``):
    one random image per class in a pool of 64 (pool seed 1234, as the
    example's), sampled by label with N(0, 0.08^2) noise a step, so the
    image -> label map is learnable; built on ``dev`` from seeded
    generators.  NHWC fp32 images, int64 labels."""
    import torch
    pool = torch.rand(SYN_CLASSES, RN50_HW, RN50_HW, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1234))
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(steps):
        labels = torch.randint(0, SYN_CLASSES, (batch,), device=dev,
                               generator=gen)
        noise = torch.randn(batch, RN50_HW, RN50_HW, 3, device=dev,
                            generator=gen)
        out.append((pool[labels] + SYN_NOISE * noise, labels))
    return out


def _flat_params(tree):
    import torch
    from apex_tpu_torch.utils.pytree import tree_leaves
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in tree_leaves(tree)])


def _rn50_grads(params, bn, x, y, dtype, d):
    """Logits' NLL loss and its gradients over every leaf, ``dtype``
    activations and weights on ``d`` (CPU tensors out)."""
    import torch
    from apex_tpu_torch.models import resnet50_config, resnet_apply
    from apex_tpu_torch.utils.pytree import (tree_flatten, tree_map,
                                             tree_unflatten)
    leaves, treedef = tree_flatten(tree_map(lambda t: t.to(d, dtype), params))
    leaves = [p.requires_grad_(True) for p in leaves]
    logits, _ = resnet_apply(tree_unflatten(treedef, leaves),
                             tree_map(lambda t: t.to(d, dtype), bn),
                             x.to(d, dtype), resnet50_config(dtype=dtype))
    loss = -torch.log_softmax(logits, -1).gather(1, y.to(d)[:, None]).mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), torch.cat([g.detach().double().reshape(-1).cpu()
                                   for g in grads])


def phase_rn50_parity(dev):
    """Card vs CPU from the same weights and batches.  (a) The model's
    loss and gradients in float64 (every batch norm then computes in
    float64), and the fp32 gradients of each device against the CPU's
    float64 ones.  (b) 3 steps of ``resnet_train_step`` in fp32, amp O0 +
    FusedAdam: step 1's loss and running statistics are held tight.  The
    fp32 gradients of the freshly initialised network in train mode lie
    ~3 % from the float64 ones on both devices (part (a) prints both), so
    steps 2-3, after updates from those gradients, are held to that."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet50_config, resnet_init
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import resnet_train_step
    from apex_tpu_torch.utils.pytree import tree_leaves, tree_map
    log("== phase 14: ResNet-50 parity (full width, batch 8 x "
        f"{RN50_HW}^2 x 3; card vs CPU: loss and gradients in float64 and "
        f"fp32, then 3 steps in fp32 under amp O0 + FusedAdam(lr={RN50_LR}))")
    cfg = resnet50_config()
    params, bn0 = resnet_init(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
    cpu = torch.device("cpu")
    batches = [(x.cpu(), y.cpu()) for x, y in syn_batches(cpu, 8, 21, 3)]
    x0, y0 = batches[0]
    res = {(d.type, dt): _rn50_grads(params, bn0, x0, y0, dt, d)
           for d in (dev, cpu) for dt in (torch.float64, torch.float32)}
    ref_l, ref_g = res[("cpu", torch.float64)]
    g64_l, g64_g = res[(dev.type, torch.float64)]
    l64 = abs(g64_l - ref_l) / abs(ref_l)
    d64 = float((g64_g - ref_g).norm() / ref_g.norm())
    require(l64 <= 1e-9 and d64 <= 1e-8, f"float64 loss / gradients differ "
            f"by {l64:.3g} / {d64:.3g} relative (tol 1e-9 / 1e-8 in norm)")
    e32 = {d: float((res[(d, torch.float32)][1] - ref_g).norm()
                    / ref_g.norm()) for d in (dev.type, "cpu")}
    require(max(e32.values()) <= 0.1, f"fp32 gradients lie {e32} from the "
            "float64 ones (tol 0.1 relative in norm)")
    log(f"  float64: loss {g64_l!r} card, {ref_l!r} cpu: rel diff {l64:.3g} "
        f"(tol 1e-9); gradients rel diff {d64:.3g} in norm (tol 1e-8); fp32 "
        f"gradients against the CPU's float64: card {e32[dev.type]:.4f}, "
        f"cpu {e32['cpu']:.4f} relative in norm (tol 0.1 each)")

    runs = []
    for d in (dev, cpu):
        st = amp.initialize(tree_map(lambda t: t.to(d), params),
                            FusedAdam(lr=RN50_LR), opt_level="O0",
                            verbosity=0)
        bn = tree_map(lambda t: t.to(d), bn0)
        t0 = time.perf_counter()
        losses, bn1 = [], None
        for x, y in batches:
            st, bn, loss, _ = resnet_train_step(st, bn, x.to(d), y.to(d),
                                                cfg)
            losses.append(loss.item())
            bn1 = bn1 or [t.cpu() for t in tree_leaves(bn)]
        runs.append((losses, bn1, [t.cpu() for t in tree_leaves(bn)],
                     _flat_params(st.model_params),
                     time.perf_counter() - t0))
    (g_l, g_bn1, g_bn, g_p, g_s), (c_l, c_bn1, c_bn, c_p, c_s) = runs
    start = _flat_params(params)
    l1 = abs(g_l[0] - c_l[0]) / abs(c_l[0])
    l_err = max(abs(a - b) / abs(b) for a, b in zip(g_l, c_l))
    bn1_err = max(rel_err(a, b) for a, b in zip(g_bn1, c_bn1))
    bn_err = max(rel_err(a, b) for a, b in zip(g_bn, c_bn))
    u_err = float((g_p - c_p).norm() / (c_p - start).norm())
    require(all(np.isfinite(g_l)) and l1 <= 1e-5 and bn1_err <= 1e-4,
            f"RN50 step 1 differs: loss {l1:.3g} relative (tol 1e-5), "
            f"running stats {bn1_err:.3g} (tol 1e-4)")
    require(l_err <= 5e-2, f"RN50 losses differ by {l_err:.3g} relative "
            f"(tol 5e-2): card {g_l} cpu {c_l}")
    log(f"  fp32 steps: losses card {g_l} cpu {c_l}: step 1 rel diff "
        f"{l1:.3g} (tol 1e-5), all steps {l_err:.3g} (tol 5e-2); running "
        f"stats after step 1 {bn1_err:.3g} (tol 1e-4), after 3 "
        f"{bn_err:.3g}; 3-step update diff {u_err:.3g} relative in norm "
        f"(not held: Adam's sign-like first steps move every element whose "
        f"fp32 gradient's sign differs by lr); card {g_s:.1f} s, CPU "
        f"{c_s:.1f} s")


def _rn50_steps(st, bn, batches, cfg, ddp=None, sync=False):
    """``resnet_train_step`` over ``batches``: (state, bn, losses, loss
    scales, step seconds); each step ends in a synchronize when ``sync``."""
    import torch
    from apex_tpu_torch.train import resnet_train_step
    losses, scales, times = [], [], []
    for x, y in batches:
        t0 = time.perf_counter()
        st, bn, loss, _ = resnet_train_step(st, bn, x, y, cfg, ddp=ddp)
        if sync:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        scales.append(float(st.loss_scale))
    return st, bn, losses, scales, times


def _skipped(scales, first):
    """Steps the dynamic scaler skipped: those after which the scale fell."""
    prev, out = first, []
    for s in scales:
        out.append(s < prev)
        prev = s
    return out


def _same_bits(a, b) -> bool:
    import torch
    from apex_tpu_torch.utils.pytree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def phase_rn50(dev, card, profile=False):
    """Config 2 (amp O2 + FusedAdam, one card), then config 3
    (``--distributed --sync-bn``: DistributedDataParallel and every batch
    norm synced over a world-1 NCCL group): config 3's first 3 steps must
    give config 2's bits under ``cudnn.deterministic``; both timed with
    ``cudnn.benchmark`` on, the warm-up step absorbing its autotuning.
    Returns the two paths' launch counts."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet50_config, resnet_init
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log(f"== phase 15: ResNet-50 path (main_amp.py configs 2 and 3: batch "
        f"{RN50_BATCH} x {RN50_HW}^2, amp O2 + FusedAdam(lr={RN50_LR}), "
        "bf16 activations, fp16 weights, fp32 batch norm)")
    cfg = resnet50_config(dtype=torch.bfloat16)
    params, bn0 = resnet_init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    st0 = amp.initialize(params, FusedAdam(lr=RN50_LR), opt_level="O2",
                         verbosity=0)
    del params
    batches = syn_batches(dev, RN50_BATCH, 0, 1 + RN50_STEPS)
    flops = 3 * resnet_flops(cfg, RN50_HW) * RN50_BATCH
    gc.collect()
    torch.cuda.empty_cache()

    # config 2's first 3 steps, deterministic, as the bits config 3 must give
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    ref = _rn50_steps(st0, bn0, batches[:3], cfg)

    # config 2 timed
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats()
    st, bn, losses, scales, _ = _rn50_steps(st0, bn0, batches[:1], cfg)
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    st, bn, l2, s2, times = _rn50_steps(st, bn, batches[1:], cfg, sync=True)
    launches_o2 = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses, scales = losses + l2, scales + s2
    skipped = _skipped(scales, 2.0 ** 16)
    require(all(np.isfinite(losses)), f"RN50 non-finite loss: {losses}")
    require(statistics.mean(losses[-3:]) < statistics.mean(losses[:3])
            and sum(not s for s in skipped) >= 2,
            f"RN50 loss did not fall (mean of the last 3 against the first "
            f"3): {losses}, skipped {skipped}")
    require(st.model_params["conv_init"].dtype == torch.float16
            and st.model_params["bn_init"]["scale"].dtype == torch.float32
            and st.master_params["conv_init"].dtype == torch.float32,
            "O2 dtypes: fp16 weights, fp32 batch norm and masters")
    check_launches("rn50", launches_o2, len(times), exact=True)
    step_s = statistics.median(times)
    log(f"  {n_params} parameters; losses {[round(l, 4) for l in losses]}, "
        f"loss scales {scales}, skipped {skipped} "
        f"({sum(skipped)} of {len(skipped)}); launches of the 13 kernels "
        f"in {len(times)} steps {launches_o2 or 'none'}")
    log(f"  [{card}] config 2: step {step_s * 1e3:.2f} ms (median of "
        f"{len(times)}; all {[round(t * 1e3, 2) for t in times]}), "
        f"{RN50_BATCH / step_s:.1f} images/s, analytic MFU "
        f"{100 * flops / step_s / 989e12:.2f}% ({flops / 1e12:.3f} TFLOP a "
        f"step: 3 x the convolutions' and fc's "
        f"{resnet_flops(cfg, RN50_HW) / 1e9:.3f} GFLOP an image x "
        f"{RN50_BATCH}, over 989 TFLOP/s), peak device "
        f"memory {peak / 2 ** 30:.2f} GiB; cudnn.benchmark on")
    f_ms, b_ms, o_ms = split_rn50_step(st, bn, batches[1], cfg)
    log(f"  [{card}] of a step: forward + loss {f_ms:.2f} ms, backward "
        f"{b_ms:.2f} ms, amp_step (unscale, finite check, FusedAdam on the "
        f"fp32 masters, skip-select, fp16 copies) {o_ms:.2f} ms (medians "
        "of 3)")
    if profile:
        from apex_tpu_torch.train import resnet_train_step
        x, y = batches[1]
        profile_window(lambda: resnet_train_step(st, bn, x, y, cfg),
                       "rn50")
    del st, bn
    torch.cuda.empty_cache()

    store = start_process_group()
    try:
        ddp = DistributedDataParallel()
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        got = _rn50_steps(st0, bn0, batches[:3], cfg, ddp=ddp)
        same = (got[2] == ref[2] and got[3] == ref[3]
                and _same_bits(got[0].model_params, ref[0].model_params)
                and _same_bits(got[0].master_params, ref[0].master_params)
                and _same_bits(got[1], ref[1]))
        require(same, f"config 3 at world 1 is not config 2's bits: losses "
                f"{got[2]} vs {ref[2]}, scales {got[3]} vs {ref[3]}")
        log(f"  config 3 (world-1 NCCL group, DDP, every batch norm synced) "
            f"3 steps under cudnn.deterministic: losses {got[2]}, the same "
            "bits as config 2's in losses, scales, fp16 weights, fp32 "
            "masters and running statistics")
        del got
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        st, bn, losses3, _, _ = _rn50_steps(st0, bn0, batches[:1], cfg,
                                            ddp=ddp)
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        st, bn, l3, s3, times3 = _rn50_steps(st, bn, batches[1:6], cfg,
                                             ddp=ddp, sync=True)
        launches_ddp = dict(build.LAUNCHES)
        check_launches("rn50", launches_ddp, len(times3), exact=True)
        require(all(np.isfinite(losses3 + l3)),
                f"config 3 non-finite loss: {losses3 + l3}")
        step3 = statistics.median(times3)
        log(f"  [{card}] config 3: step {step3 * 1e3:.2f} ms (median of "
            f"{len(times3)}; all {[round(t * 1e3, 2) for t in times3]}), "
            f"{RN50_BATCH / step3:.1f} images/s, analytic MFU "
            f"{100 * flops / step3 / 989e12:.2f}%; losses "
            f"{[round(l, 4) for l in losses3 + l3]}, scales {s3}; launches "
            f"of the 13 kernels {launches_ddp or 'none'}")
    finally:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    del st0, batches
    torch.cuda.empty_cache()
    return launches_o2, launches_ddp


def split_rn50_step(st, bn, batch, cfg):
    """Host-clock ms of a step's three parts, each ending in a
    synchronize: forward and loss, backward, ``amp_step`` (the state is
    left as it was)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet_apply
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    x, y = batch
    parts = []
    for _ in range(3):
        leaves, treedef = tree_flatten(st.model_params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = resnet_apply(tree_unflatten(treedef, leaves), bn, x, cfg)
        lp = torch.log_softmax(logits.float(), dim=-1)
        loss = -lp.gather(1, y[:, None]).mean()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(amp.scale_loss(loss, st), leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        amp.amp_step(st, tree_unflatten(treedef, list(grads)))
        torch.cuda.synchronize()
        parts.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return tuple(statistics.median(p[i] for p in parts) * 1e3
                 for i in range(3))


# ---------------------------------------------------------------------------
# phases 16-18: amp O1 / O4 casts, the toy DDP example (config 1) and DCGAN
# (config 5)
# ---------------------------------------------------------------------------

CAST_TOL = {"bfloat16": 2e-2, "float16": 4e-3}
# the toy data-parallel example (examples/simple/distributed): widths, global
# batch, steps, SGD
SIMPLE_DIMS = (512, 256, 32)
SIMPLE_BATCH = 64
SIMPLE_STEPS = 100
# the dcgan example: batch, timed steps, Adam
DCGAN_BATCH = 64
DCGAN_PARITY_BATCH = 8
DCGAN_STEPS = 20
DCGAN_ADAM = dict(lr=2e-4, betas=(0.5, 0.999))


def cast_calls():
    """(key, category, callable, call, input shapes, domain) for every
    callable of the port's cast lists (``amp/lists/torch_overrides.py``):
    how to call it, and on what (domain "pos": uniform(0.5, 2), "unit":
    (-0.9, 0.9), else 0.5 N(0, 1))."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.amp.lists import torch_overrides as L
    mm = ((64, 128), (128, 32))
    calls = {
        torch.dot: (None, ((256,), (256,))),
        torch.vdot: (None, ((256,), (256,))),
        torch.matmul: (None, mm), torch.mm: (None, mm),
        torch.inner: (None, ((64, 128), (32, 128))),
        torch.outer: (None, ((64,), (32,))),
        torch.tensordot: (lambda f, a, b: f(a, b, dims=1), mm),
        torch.einsum: (lambda f, a, b: f("ij,jk->ik", a, b), mm),
        torch.bmm: (None, ((4, 64, 128), (4, 128, 32))),
        F.linear: (None, ((64, 128), (32, 128))),
        F.conv1d: (None, ((4, 16, 33), (32, 16, 3))),
        F.conv2d: (None, ((4, 16, 15, 15), (32, 16, 3, 3))),
        F.conv3d: (None, ((2, 16, 7, 7, 7), (32, 16, 3, 3, 3))),
        F.conv_transpose1d: (lambda f, x, w: f(x, w, stride=2),
                             ((4, 32, 17), (32, 16, 3))),
        F.conv_transpose2d: (lambda f, x, w: f(x, w, stride=2),
                             ((4, 32, 8, 8), (32, 16, 3, 3))),
        F.conv_transpose3d: (lambda f, x, w: f(x, w, stride=2),
                             ((2, 32, 4, 4, 4), (32, 16, 3, 3, 3))),
    }
    pos = {"jnp.log", "jnp.log10", "jnp.log1p", "jnp.log2", "jnp.power",
           "jnp.float_power", "jnp.cumprod", "jnp.prod", "lax.log",
           "lax.log1p", "lax.pow", "lax.rsqrt", "jnp.divide",
           "jnp.true_divide"}
    unit = {"jnp.cosh", "jnp.sinh", "jnp.tan", "jnp.arccos", "jnp.arcsin",
            "lax.erf_inv"}
    dim0 = {"jnp.cumprod", "jnp.cumsum"}
    last = {"nn.softmax", "nn.log_softmax", "nn.logsumexp"}
    binary = {"jnp.power", "jnp.float_power", "lax.pow"}
    out = []
    for cat in ("LOW_PREC", "FP32", "CASTS", "SEQUENCE_CASTS"):
        for key, fns in getattr(L, cat).items():
            dom = "pos" if key in pos else "unit" if key in unit else "any"
            for f in fns:
                if cat == "LOW_PREC":
                    call, shapes = calls[f]
                elif cat == "SEQUENCE_CASTS":
                    call, shapes = (lambda f, a, b: f([a, b])), ((8, 6),) * 2
                elif cat == "CASTS" or key in binary:
                    call, shapes = None, ((8, 6),) * 2
                elif key in dim0:
                    call, shapes = (lambda f, x: f(x, dim=0)), ((4, 6),)
                elif key in last:
                    call, shapes = (lambda f, x: f(x, dim=-1)), ((8, 6),)
                else:
                    call, shapes = None, ((4, 6),)
                out.append((key, cat, f, call or (lambda f, *a: f(*a)),
                            shapes, dom))
    return out


def _cast_inputs(shapes, domain, seed):
    rng = np.random.default_rng(seed)
    if domain == "pos":
        return [rng.uniform(0.5, 2.0, s).astype(np.float32) for s in shapes]
    if domain == "unit":
        return [rng.uniform(-0.9, 0.9, s).astype(np.float32) for s in shapes]
    return [(0.5 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _as_cast(category, xs, low):
    """The inputs as the casts of ``category`` hand them to the function:
    the low-precision type, fp32, or the widest floating type."""
    import functools
    import torch
    if category == "LOW_PREC":
        return [x.to(low) for x in xs]
    if category == "FP32":
        return [x.float() for x in xs]
    widest = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return [x.to(widest) for x in xs]


def phase_cast_table(dev):
    """Every callable of the cast lists under ``amp.autocast(bf16)`` and
    ``amp.autocast(fp16)``, on the card and on the CPU from the same
    inputs in three dtype mixes (all low precision, all fp32, the first
    fp32 and the rest low precision).  The card's output dtype must be
    the CPU's (the CPU table is held to the JAX package's in
    ``tests/test_torch_amp_autocast.py``); its values must lie within one
    rounding of the function computed in float64 on the CPU from the
    inputs as the casts hand them over: 2e-2 (bf16) / 4e-3 (fp16) / 1e-5
    (fp32 outputs) of max(1, |ref|); booleans equal the CPU's.  The CPU's
    own low-precision results are held the same way and reported.
    ``uninit`` must leave no torch function mode."""
    import torch
    from torch.overrides import _get_current_function_mode_stack
    from apex_tpu_torch import amp
    log("== phase 16: amp O1 / O4 cast table on the card (every callable of "
        "amp/lists/torch_overrides.py, bf16 and fp16, three dtype mixes, "
        "card vs CPU)")
    cpu = torch.device("cpu")
    cases = cast_calls()
    worst, fails, n = {}, [], 0
    for low_name, low_tol in CAST_TOL.items():
        low = getattr(torch, low_name)
        for i, (key, cat, f, call, shapes, dom) in enumerate(cases):
            arrays = _cast_inputs(shapes, dom, i)
            mixes = [("low",) * len(shapes), ("f32",) * len(shapes)]
            if len(shapes) > 1:
                mixes.append(("f32",) + ("low",) * (len(shapes) - 1))
            for mix in mixes:
                outs = {}
                for d in (dev, cpu):
                    xs = [torch.from_numpy(a).to(d, low if m == "low"
                                                 else torch.float32)
                          for a, m in zip(arrays, mix)]
                    with amp.autocast(low):
                        outs[d.type] = call(f, *xs)
                xs = [torch.from_numpy(a).to(low if m == "low"
                                             else torch.float32)
                      for a, m in zip(arrays, mix)]
                ref = call(f, *[x.double()
                                for x in _as_cast(cat, xs, low)])
                got, cref = outs[dev.type], outs["cpu"]
                name = f"{key} {getattr(f, '__name__', f)} {low_name} {mix}"
                n += 1
                if got.dtype != cref.dtype or got.shape != cref.shape:
                    fails.append(f"{name}: card {got.dtype} "
                                 f"{tuple(got.shape)}, CPU {cref.dtype} "
                                 f"{tuple(cref.shape)}")
                    continue
                if cref.dtype == torch.bool:
                    if not torch.equal(got.cpu(), cref):
                        fails.append(f"{name}: booleans differ")
                    continue
                tol = 1e-5 if got.dtype == torch.float32 else low_tol
                for who, out in (("card", got), ("cpu", cref)):
                    ok, err = scaled_ok(out.cpu().double(), ref, tol)
                    w = (who, str(out.dtype).split(".")[-1])
                    worst[w] = max(worst.get(w, (0.0, ""))[0], err), \
                        name if err >= worst.get(w, (0.0, ""))[0] \
                        else worst[w][1]
                    if who == "card" and not ok:
                        fails.append(f"{name}: card max err {err:.3g} "
                                     f"(tol {tol} of max(1, |ref|))")
    for (who, dt), (err, name) in sorted(worst.items()):
        log(f"  {who} {dt} outputs: max abs err {err:.3g} against float64 "
            f"({name})")
    require(not fails, f"cast table: {len(fails)} of {n} calls failed: "
            + "; ".join(fails[:12]))
    require(not amp.is_initialized() and not _get_current_function_mode_stack(),
            "amp casts left on after the cast table")
    amp.init(torch.float16)
    amp.uninit()
    require(not _get_current_function_mode_stack(),
            "amp.uninit left a torch function mode on the stack")
    log(f"  {len(cases)} callables, {n} calls: every card dtype the CPU's, "
        "every card value within its rule; no function mode left after "
        "uninit")


def simple_example(dev):
    """The toy example's parameters (``fc1`` / ``fc2`` ``{w, b}``, He-style
    normal from torch seed 0, as the example's scale) and regression
    problem (numpy seed 0, the example's), on ``dev``."""
    import torch
    d_in, d_h, d_out = SIMPLE_DIMS
    gen = torch.Generator().manual_seed(0)
    params = {"fc1": {"w": torch.randn(d_in, d_h, generator=gen)
                      * (2.0 / d_in) ** 0.5, "b": torch.zeros(d_h)},
              "fc2": {"w": torch.randn(d_h, d_out, generator=gen)
                      * (1.0 / d_h) ** 0.5, "b": torch.zeros(d_out)}}
    rng = np.random.RandomState(0)
    X = rng.randn(SIMPLE_BATCH, d_in).astype(np.float32)
    W = rng.randn(d_in, d_out).astype(np.float32) * 0.1
    tree = {k: {n: t.to(dev) for n, t in v.items()} for k, v in
            params.items()}
    return (tree, torch.from_numpy(X).to(dev),
            torch.from_numpy(X @ W).to(dev))


def _simple_steps(dev, steps, sync=False):
    """``simple_ddp_train_step`` under amp O1 + FusedSGD(lr=0.1, momentum
    0.9) from the example's start: (state, losses, scales, step seconds)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.train import simple_ddp_train_step
    params, X, Y = simple_example(dev)
    st = amp.initialize(params, FusedSGD(lr=0.1, momentum=0.9),
                        opt_level="O1", verbosity=0)
    losses, scales, times = [], [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            st, loss = simple_ddp_train_step(st, X, Y, device=dev.type)
            if sync:
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            scales.append(float(st.loss_scale))
    finally:
        amp.uninit()
    return st, losses, scales, times


def phase_simple_ddp(dev, card):
    """BASELINE config 1 (``examples/simple/distributed``, its defaults:
    512 -> 256 -> 32, global batch 64, amp O1, FusedSGD(lr=0.1, momentum
    0.9)).  Card vs CPU from the same weights over 3 steps (the CPU with no
    group, the card on a world-1 NCCL group); then 100 steps on the card,
    timed.  Returns the path's launch counts."""
    import torch
    import torch.distributed as dist
    from torch.overrides import _get_current_function_mode_stack
    from apex_tpu_torch.utils import build
    log(f"== phase 17: the toy DDP example under amp O1 (config 1: "
        f"{' -> '.join(map(str, SIMPLE_DIMS))}, batch {SIMPLE_BATCH}, "
        f"FusedSGD(lr=0.1, momentum=0.9), world-1 NCCL group)")
    _, c_l, c_s, _ = _simple_steps(torch.device("cpu"), 3)
    store = start_process_group()
    try:
        _, g_l, g_s, _ = _simple_steps(dev, 3)
        l_err = max(abs(a - b) / abs(b) for a, b in zip(g_l, c_l))
        require(g_s == c_s and l_err <= 1e-3,
                f"config 1 card vs CPU: losses {g_l} vs {c_l} ({l_err:.3g} "
                f"relative, tol 1e-3), scales {g_s} vs {c_s}")
        log(f"  card vs CPU, 3 steps: losses {g_l} / {c_l}, max rel diff "
            f"{l_err:.3g} (tol 1e-3); loss scales {g_s} (equal)")
        _simple_steps(dev, 1)                        # warm-up
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        st, losses, scales, times = _simple_steps(dev, SIMPLE_STEPS,
                                                  sync=True)
        launches = dict(build.LAUNCHES)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    require(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
            f"config 1 loss did not fall: {losses[0]} -> {losses[-1]}")
    require(st.model_params["fc1"]["w"].dtype == torch.float32,
            "O1 keeps the model fp32")
    require(not _get_current_function_mode_stack(),
            "O1 casts left on after config 1")
    check_launches("simple_ddp_o1", launches, len(times), exact=True)
    step_s = statistics.median(times)
    log(f"  losses step 1 {losses[0]:.5f}, 20 {losses[19]:.5f}, 50 "
        f"{losses[49]:.5f}, 100 {losses[-1]:.5f}; loss scale "
        f"{scales[-1]:.0f} (skipped "
        f"{sum(_skipped(scales, 2.0 ** 16))} of {len(scales)}); launches "
        f"of the 13 kernels {launches or 'none'}")
    log(f"  [{card}] config 1: step {step_s * 1e3:.3f} ms (median of "
        f"{len(times)}; min {min(times) * 1e3:.3f}, max "
        f"{max(times) * 1e3:.3f}), {SIMPLE_BATCH / step_s:.1f} samples/s")
    return launches


def _dcgan_start(dev, level, seed=0):
    """DCGAN (``DCGANConfig()``: latent 100, 64 features, 3 x 64 x 64) and
    its two amp states (two FusedAdam, D with 2 losses) at ``level``."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import DCGANConfig, dcgan_init
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = DCGANConfig(dtype=torch.float32 if level == "O0"
                      else torch.bfloat16)
    params, bn = dcgan_init(torch.Generator().manual_seed(seed), cfg,
                            device=dev)
    sD = amp.initialize(params["disc"], FusedAdam(**DCGAN_ADAM),
                        opt_level=level, num_losses=2, verbosity=0)
    sG = amp.initialize(params["gen"], FusedAdam(**DCGAN_ADAM),
                        opt_level=level, verbosity=0)
    return cfg, sD, sG, bn


def dcgan_batch(dev, batch, seed):
    """The example's synthetic batch: images uniform in [-1, 1] NHWC and
    latents N(0, 1) (numpy ``RandomState(seed)``, as ``main_amp.py``)."""
    import torch
    rng = np.random.RandomState(seed)
    real = rng.rand(batch, 64, 64, 3).astype(np.float32) * 2.0 - 1.0
    z = rng.randn(batch, 100).astype(np.float32)
    return torch.from_numpy(real).to(dev), torch.from_numpy(z).to(dev)


def _dcgan_grads(sD, sG, bn, real, z, cfg):
    """Gradients of D's real loss over D and of G's loss over G (D fixed),
    one flat float64 CPU vector, and the two losses."""
    import torch
    from apex_tpu_torch.models import discriminator_apply, generator_apply
    from apex_tpu_torch.train import bce_logits
    from apex_tpu_torch.utils.pytree import (tree_flatten, tree_leaves,
                                             tree_unflatten)
    d_l, d_def = tree_flatten(sD.model_params)
    d_l = [p.detach().requires_grad_(True) for p in d_l]
    logits, _ = discriminator_apply({"disc": tree_unflatten(d_def, d_l)}, bn,
                                    real, cfg)
    ld = bce_logits(logits, 1.0)
    gd = torch.autograd.grad(ld, d_l)
    g_l, g_def = tree_flatten(sG.model_params)
    g_l = [p.detach().requires_grad_(True) for p in g_l]
    p = {"disc": sD.model_params, "gen": tree_unflatten(g_def, g_l)}
    imgs, bn3 = generator_apply(p, bn, z, cfg)
    logits, _ = discriminator_apply(p, bn3, imgs, cfg)
    lg = bce_logits(logits, 1.0)
    gg = torch.autograd.grad(lg, g_l)
    flat = torch.cat([g.detach().double().reshape(-1).cpu()
                      for g in list(gd) + list(gg)])
    return flat, ld.item(), lg.item()


def _dcgan_grads64(d, real, z):
    """:func:`_dcgan_grads` in float64 on ``d``, from the O0 start."""
    import dataclasses
    import torch
    from apex_tpu_torch.utils.pytree import tree_map
    cfg, sD, sG, bn = _dcgan_start(d, "O0")

    def f64(t):
        # contiguous: the CPU's float64 convolution backward refuses a
        # channels_last weight
        return t.double().contiguous()
    return _dcgan_grads(sD._replace(model_params=tree_map(f64,
                                                          sD.model_params)),
                        sG._replace(model_params=tree_map(f64,
                                                          sG.model_params)),
                        tree_map(f64, bn), real.to(d).double(),
                        z.to(d).double(),
                        dataclasses.replace(cfg, dtype=torch.float64))


def phase_dcgan_parity(dev):
    """Config 5 at full width, card vs CPU from the same weights, batch 8:
    the gradients of D's real loss over D and of G's loss over G, and one
    ``dcgan_train_step``.  In float64 the two devices' gradients and
    losses agree within 1e-6 relative (the discriminator returns fp32
    logits, as the JAX model does, so a float64 run still rounds them to
    fp32 once: 1.4e-7 in the losses on the card).  In fp32
    (O0) each device's gradients lie ~0.17 % from the CPU's float64 ones
    (the network's fp32 conditioning, measured on the CPU), so the card's
    must lie no farther than 1.25 x the CPU's + 1e-3, and one step's
    losses within 1e-4.  Under O4 the bf16 activations put each device's
    gradients ~13 % from its fp32 ones, so the card's must lie no farther
    than 1.25 x the CPU's + 0.01, the two devices' bf16 gradients within
    1.5 x the CPU's distance of each other, and the losses within 2e-2."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.train import dcgan_train_step
    from apex_tpu_torch.utils.pytree import tree_leaves
    log(f"== phase 18a: DCGAN parity (DCGANConfig(): full width; card vs "
        f"CPU, batch {DCGAN_PARITY_BATCH}; float64, O0 fp32 and O4 bf16)")
    cpu = torch.device("cpu")
    real, z = dcgan_batch(cpu, DCGAN_PARITY_BATCH, 5)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    g64 = {d.type: _dcgan_grads64(d, real, z) for d in (dev, cpu)}
    d64 = rel(g64[dev.type][0], g64["cpu"][0])
    l64 = max(abs(a - b) / abs(b) for a, b in zip(g64[dev.type][1:],
                                                  g64["cpu"][1:]))
    require(d64 <= 1e-6 and l64 <= 1e-6,
            f"DCGAN float64 card vs CPU: gradients {d64:.3g} (tol 1e-6), "
            f"losses {l64:.3g} (tol 1e-6)")
    log(f"  float64 (fp32 logits): gradients card vs CPU rel diff {d64:.3g} "
        f"in norm (tol 1e-6), losses {l64:.3g} (tol 1e-6)")
    ref = {"O0": g64["cpu"][0]}
    for level in ("O0", "O4"):
        res = {}
        for d in (dev, cpu):
            cfg, sD, sG, bn = _dcgan_start(d, level)
            grads, ld, lg = _dcgan_grads(sD, sG, bn, real.to(d), z.to(d), cfg)
            out = dcgan_train_step(sD, sG, bn, real.to(d), z.to(d), cfg,
                                   device=d.type)
            upd = torch.cat([t.detach().double().reshape(-1).cpu() for t in
                             tree_leaves(out[0].model_params)
                             + tree_leaves(out[1].model_params)])
            res[d.type] = (grads, [float(x) for x in out[3:]] + [ld, lg],
                           upd)
            if amp.is_initialized():
                amp.uninit()
        (g_g, g_l, g_p), (c_g, c_l, c_p) = res[dev.type], res["cpu"]
        d_err = rel(g_g, c_g)
        l_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(g_l, c_l))
        p_err = float((g_p - c_p).abs().max())
        if level == "O0":
            e_card, e_cpu = rel(g_g, ref["O0"]), rel(c_g, ref["O0"])
            ref = {dev.type: g_g, "cpu": c_g}
            require(e_card <= 1.25 * e_cpu + 1e-3 and l_err <= 1e-4,
                    f"DCGAN O0: fp32 gradients lie {e_card:.3g} (card) / "
                    f"{e_cpu:.3g} (CPU) from the CPU's float64 ones (card tol "
                    f"1.25 x CPU + 1e-3); losses {l_err:.3g} (tol 1e-4)")
            held = (f"fp32 gradients from the CPU's float64 ones: card "
                    f"{e_card:.3g}, CPU {e_cpu:.3g} relative in norm (card "
                    f"tol 1.25 x CPU + 1e-3), card vs CPU {d_err:.3g}; losses "
                    f"max diff {l_err:.3g} (tol 1e-4)")
        else:
            e_card, e_cpu = rel(g_g, ref[dev.type]), rel(c_g, ref["cpu"])
            require(e_card <= 1.25 * e_cpu + 0.01 and d_err <= 1.5 * e_cpu
                    and l_err <= 2e-2,
                    f"DCGAN O4: bf16 gradients lie {e_card:.3g} (card) / "
                    f"{e_cpu:.3g} (CPU) from the fp32 ones (card tol 1.25 x "
                    f"CPU + 0.01); card vs CPU {d_err:.3g} (tol 1.5 x "
                    f"{e_cpu:.3g}); losses {l_err:.3g} (tol 2e-2)")
            held = (f"bf16 gradients from the same device's fp32 ones: card "
                    f"{e_card:.3g}, CPU {e_cpu:.3g} relative in norm (card "
                    f"tol 1.25 x CPU + 0.01); card vs CPU {d_err:.3g} (tol "
                    f"1.5 x CPU's); losses max diff {l_err:.3g} (tol 2e-2)")
        log(f"  {level}: losses (D real, D fake, G) card {g_l[:3]} cpu "
            f"{c_l[:3]}; {held}; parameters after the step max |diff| "
            f"{p_err:.3g} (not held: Adam's first step moves each element "
            "by ~lr 2e-4 whatever its gradient's size)")


def phase_dcgan(dev, card, profile=False):
    """Config 5 (``examples/dcgan/main_amp.py``'s defaults: O4, batch 64,
    two FusedAdam, three loss scalers): one warm-up and 20 timed steps.
    Returns the path's launch counts."""
    import torch
    from torch.overrides import _get_current_function_mode_stack
    from apex_tpu_torch import amp
    from apex_tpu_torch.train import dcgan_train_step
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log(f"== phase 18b: DCGAN path (config 5: DCGANConfig(), batch "
        f"{DCGAN_BATCH}, amp O4, FusedAdam(lr=2e-4, betas=(0.5, 0.999)) x 2, "
        "three loss scalers)")
    torch.backends.cudnn.benchmark = True
    try:
        cfg, sD, sG, bn = _dcgan_start(dev, "O4")
        n_params = sum(p.numel() for p in tree_leaves(sD.model_params)
                       + tree_leaves(sG.model_params))
        batches = [dcgan_batch(dev, DCGAN_BATCH, s)
                   for s in range(1 + DCGAN_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        sD, sG, bn, *_ = dcgan_train_step(sD, sG, bn, *batches[0], cfg,
                                          device=dev.type)
        c0 = (int(sD.opt_state.count), int(sG.opt_state.count))
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        losses, times = [], []
        for real, z in batches[1:]:
            t0 = time.perf_counter()
            sD, sG, bn, e_r, e_f, e_g = dcgan_train_step(
                sD, sG, bn, real, z, cfg, device=dev.type)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append((e_r.item(), e_f.item(), e_g.item()))
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        scales = [float(s.loss_scale) for s in sD.scalers + sG.scalers]
        skipped = [DCGAN_STEPS - (int(sD.opt_state.count) - c0[0]),
                   DCGAN_STEPS - (int(sG.opt_state.count) - c0[1])]
        require(all(np.isfinite(losses).ravel()),
                f"DCGAN non-finite loss: {losses}")
        require(scales == [1.0, 1.0, 1.0] and skipped == [0, 0],
                f"O4: loss scales {scales} (all 1.0), skipped D / G steps "
                f"{skipped} (none)")
        require(sD.model_params["conv1"].dtype == torch.float32,
                "O4 keeps the model fp32")
        check_launches("dcgan_o4", launches, len(times), exact=True)
        step_s = statistics.median(times)
        log(f"  {n_params} parameters; losses (D real, D fake, G) step 1 "
            f"{[round(x, 4) for x in losses[0]]}, step {DCGAN_STEPS} "
            f"{[round(x, 4) for x in losses[-1]]}; loss scales D0 / D1 / G "
            f"{scales}; skipped steps D / G {skipped}; launches of the 13 "
            f"kernels {launches or 'none'}")
        log(f"  [{card}] config 5: step {step_s * 1e3:.3f} ms (median of "
            f"{len(times)}; all {[round(t * 1e3, 3) for t in times]}), "
            f"{DCGAN_BATCH / step_s:.1f} images/s, peak device memory "
            f"{peak / 2 ** 30:.3f} GiB; cudnn.benchmark on")
        if profile:
            real, z = batches[1]
            profile_window(lambda: dcgan_train_step(
                sD, sG, bn, real, z, cfg, device=dev.type), "dcgan")
    finally:
        torch.backends.cudnn.benchmark = False
        if amp.is_initialized():
            amp.uninit()
    require(not _get_current_function_mode_stack(),
            "O4 casts left on after config 5")
    return launches


# ---------------------------------------------------------------------------
# phase 19: checkpoints and the resumable data plane
# ---------------------------------------------------------------------------

# the shard set of the ResNet-50 leg: uint8 NHWC 224^2 records and int64
# labels in 4 .npz shards (~154 MB), seed 0
CKPT_RECORDS = 1024
CKPT_SHARDS = 4
# straight steps of each leg, and the step after which the resumed run
# saves, loads into a state built from another seed, and goes on
CKPT_RN50_STEPS, CKPT_RN50_SPLIT = 6, 3
CKPT_BERT_LAYERS, CKPT_BERT_STEPS, CKPT_BERT_SPLIT = 2, 4, 2


def write_image_shards(directory, records, shards, seed):
    """``shards`` ``.npz`` files of ``images`` (uint8, records x 224 x 224
    x 3) and ``labels`` (int64 in [0, 1000)), from numpy's PCG64 at
    ``seed``; returns the bytes written."""
    import shutil
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    per = records // shards
    for i in range(shards):
        np.savez(os.path.join(directory, f"shard-{i:03d}.npz"),
                 images=rng.integers(0, 256, (per, RN50_HW, RN50_HW, 3),
                                     dtype=np.uint8),
                 labels=rng.integers(0, 1000, per).astype(np.int64))
    return sum(os.path.getsize(os.path.join(directory, f))
               for f in os.listdir(directory))


def _differing(a, b):
    """The paths of the leaves of two trees whose bits differ."""
    import torch
    from apex_tpu_torch.utils.pytree import path_str, tree_leaves_with_path
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<tree structure>"]
    return [path_str(p) or "<leaf>" for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or not torch.equal(x, y)]


def _rn50_loader_steps(st, bn, loader, cfg, steps):
    """``steps`` steps of ``resnet_train_step`` over the loader's prefetched
    iteration: (state, bn, losses, the host's wait for each batch in s)."""
    from apex_tpu_torch.train import resnet_train_step
    it = iter(loader)
    losses, waits = [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            x, y = next(it)
            waits.append(time.perf_counter() - t0)
            st, bn, loss, _ = resnet_train_step(st, bn, x, y, cfg)
            losses.append(loss.item())
    finally:
        it.close()
    return st, bn, losses, waits


def phase_checkpoint(dev, card):
    """Checkpoints and the resumable data plane (the imagenet example's
    ``--data`` / ``--save`` / ``--resume`` path), three legs:

    (a) ResNet-50 config 2 at full width (main_amp.py's defaults: batch
    128 x 224^2, amp O2 + FusedAdam(lr=1e-3), bf16 activations) under
    ``cudnn.deterministic``, fed by a ``ShardedLoader`` over 4 ``.npz``
    shards of 1,024 uint8 records written under ``build/``: 6 steps
    straight, against 3 steps, ``CheckpointManager(keep_last=2).save``
    (the loader's ``data_meta()`` and ``cursor(3)`` in the manifest), a
    state built from seed 1, ``load_latest`` -> ``resnet_resume`` ->
    ``seek(3)`` -> 3 steps: the same bits in the fp16 weights, fp32
    masters, Adam's m / v / count, the running statistics and the scaler,
    and the same 6 losses; the straight run's state through
    ``save_sharded`` / ``load_sharded`` on a world-1 NCCL group, the same
    bits;
    (b) corruption: the newest checkpoint truncated (``verify`` raises
    ``CheckpointError``, ``latest()`` gives the one before it) and one
    byte of one shard flipped (``ShardChecksumError`` names the shard and
    the record offset);
    (c) the O5 BERT step of phase 7 at full width (d_model 1024, 16
    heads, vocab 30592, seq 512, batch 8), cut to 2 layers (the one cut,
    to keep the phase short): 4 steps straight against 2 + save / load
    into a state from seed 1 + 2, the same bits (the file holds bf16
    leaves and the FusedLAMB state); ``ml_dtypes`` never imported; the
    kernels' launch counts of the straight run.

    (d) prints save / verify / load / restore times, the file's size and
    MB/s, the shard scan and the loader's wait per batch while training.
    Returns the two legs' launch counts."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp, checkpoint
    from apex_tpu_torch.data import ShardChecksumError, ShardedDataset
    from apex_tpu_torch.data import open_dataset
    from apex_tpu_torch.models import (bert_large_config, resnet50_config,
                                       resnet_init, transformer_init)
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import CheckpointManager
    from apex_tpu_torch.resilience.ckpt import META_DATA_KEY
    from apex_tpu_torch.train import (resnet_checkpoint_entries,
                                      resnet_resume, resnet_sharded_batches,
                                      train_step)
    from apex_tpu_torch.utils import build
    log(f"== phase 19: checkpoints and resumable data (ResNet-50 config 2 "
        f"fed by a ShardedLoader, {CKPT_RN50_STEPS} steps straight vs "
        f"{CKPT_RN50_SPLIT} + save / load + "
        f"{CKPT_RN50_STEPS - CKPT_RN50_SPLIT}; corruption; O5 BERT at "
        f"{CKPT_BERT_LAYERS} layers, {CKPT_BERT_STEPS} vs "
        f"{CKPT_BERT_SPLIT} + {CKPT_BERT_STEPS - CKPT_BERT_SPLIT})")
    log(f"  numpy {np.__version__}")
    root = os.path.join(HERE, "build", "phase19")
    data_dir = os.path.join(root, "data")
    t0 = time.perf_counter()
    n_bytes = write_image_shards(data_dir, CKPT_RECORDS, CKPT_SHARDS, 0)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = open_dataset(data_dir)                     # writes INDEX.json
    scan_s = time.perf_counter() - t0
    require(ds.n_records == CKPT_RECORDS and len(ds.index.shards)
            == CKPT_SHARDS, f"index: {ds.n_records} records")

    # (a) ResNet-50 config 2, straight against resumed
    cfg = resnet50_config(dtype=torch.bfloat16)
    params, bn0 = resnet_init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    st0 = amp.initialize(params, FusedAdam(lr=RN50_LR), opt_level="O2",
                         verbosity=0)
    del params
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        def loader():
            return resnet_sharded_batches(data_dir, RN50_BATCH, 0,
                                          CKPT_RN50_STEPS, device=dev)
        build.LAUNCHES.clear()
        st_a, bn_a, losses_a, waits = _rn50_loader_steps(
            st0, bn0, loader(), cfg, CKPT_RN50_STEPS)
        torch.cuda.synchronize()
        launches_rn50 = dict(build.LAUNCHES)
        check_launches("rn50", launches_rn50, CKPT_RN50_STEPS, exact=True)

        ld = loader()
        st, bn, losses_b, waits_b = _rn50_loader_steps(
            st0, bn0, ld, cfg, CKPT_RN50_SPLIT)
        mgr = CheckpointManager(os.path.join(root, "rn50"), keep_last=2)
        for f in os.listdir(mgr.directory) if os.path.isdir(
                mgr.directory) else ():
            os.remove(os.path.join(mgr.directory, f))
        mgr.set_meta({META_DATA_KEY: dict(ld.data_meta(),
                                          cursor=ld.cursor(CKPT_RN50_SPLIT))})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(CKPT_RN50_SPLIT, resnet_checkpoint_entries(
            st, bn, CKPT_RN50_SPLIT))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        checkpoint.verify(path)
        verify_s = time.perf_counter() - t0
        del st, bn

        params, bn1 = resnet_init(torch.Generator().manual_seed(1), cfg,
                                  device=dev)
        st1 = amp.initialize(params, FusedAdam(lr=RN50_LR), opt_level="O2",
                             verbosity=0)
        del params
        t0 = time.perf_counter()
        step, payload, meta = mgr.load_latest(with_meta=True)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, bn, start = resnet_resume(payload, st1, bn1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del payload, st1, bn1
        ld = loader()
        require(step == start == CKPT_RN50_SPLIT
                and meta[META_DATA_KEY]["index_digest"] == ld.index_digest
                and meta[META_DATA_KEY]["cursor"] == ld.cursor(start),
                f"manifest: step {step}, start {start}, meta {meta}")
        ld.seek(start)
        st, bn, losses_c, waits_c = _rn50_loader_steps(
            st, bn, ld, cfg, CKPT_RN50_STEPS - CKPT_RN50_SPLIT)
        diff = []
        for name, x, y in (("model", st.model_params, st_a.model_params),
                           ("masters", st.master_params, st_a.master_params),
                           ("opt", st.opt_state, st_a.opt_state),
                           ("bn", bn, bn_a)):
            diff += [f"{name}/{p}" for p in _differing(x, y)]
        resumed = losses_b + losses_c
        require(resumed == losses_a and not diff
                and amp.state_dict(st) == amp.state_dict(st_a),
                f"ResNet-50 resume is not the straight run's bits: losses "
                f"{resumed} vs {losses_a}; differing leaves {diff[:8]} "
                f"({len(diff)}); scalers {amp.state_dict(st)} vs "
                f"{amp.state_dict(st_a)}")
        require(all(np.isfinite(losses_a)), f"non-finite loss {losses_a}")
        # the same state through save_sharded / load_sharded
        # (torch.distributed.checkpoint) on a world-1 NCCL group
        tree = {"model": st_a.model_params, "masters": st_a.master_params,
                "opt": st_a.opt_state, "bn": bn_a}
        store = start_process_group()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_sharded(os.path.join(root, "rn50_dcp"), tree)
            ssave_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = checkpoint.load_sharded(os.path.join(root, "rn50_dcp"),
                                          tree)
            torch.cuda.synchronize()
            sload_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
            if os.path.exists(store):
                os.remove(store)
        diff = _differing(got, tree)
        require(not diff, f"load_sharded differs from the saved state in "
                f"{diff[:8]} ({len(diff)} leaves)")
        del got, tree
        log(f"  (a) ResNet-50 config 2: losses {losses_a} straight; "
            f"{CKPT_RN50_SPLIT} + save / load (seed-1 state, seek to step "
            f"{start}) + {CKPT_RN50_STEPS - CKPT_RN50_SPLIT}: the same 6 "
            "losses and the same bits in the fp16 weights, fp32 masters, "
            "Adam m / v / count, running statistics and the scaler "
            f"({amp.state_dict(st)['loss_scaler0']})")
        mb = size / 1e6
        log(f"  [{card}] (d) the ResNet-50 checkpoint: {mb:.1f} MB; save "
            f"{save_s * 1e3:.1f} ms ({mb / save_s:.0f} MB/s, device to "
            f"host, pickle, CRC and write), verify {verify_s * 1e3:.1f} ms "
            f"({mb / verify_s:.0f} MB/s), load {load_s * 1e3:.1f} ms "
            f"({mb / load_s:.0f} MB/s, CRC and unpickle), restore_like "
            f"{restore_s * 1e3:.1f} ms (host to device into the template's "
            "dtypes and strides)")
        log(f"  [{card}] (d) the same state through save_sharded / "
            f"load_sharded (torch.distributed.checkpoint, world-1 NCCL "
            f"group): save {ssave_s * 1e3:.1f} ms ({mb / ssave_s:.0f} MB/s), "
            f"load {sload_s * 1e3:.1f} ms ({mb / sload_s:.0f} MB/s), the "
            "same bits")
        firsts = [w[0] * 1e3 for w in (waits, waits_b, waits_c)]
        rest = waits[1:] + waits_b[1:] + waits_c[1:]
        log(f"  [{card}] (d) shards: {n_bytes / 1e6:.1f} MB written in "
            f"{write_s:.2f} s; index scan (CRC32 of every shard) "
            f"{scan_s * 1e3:.1f} ms ({n_bytes / 1e6 / scan_s:.0f} MB/s); the "
            f"loader's wait per batch while training: the first batch of "
            f"each of the 3 loaders {[round(w, 2) for w in firsts]} ms "
            f"(its shards read and CRC-checked), the other {len(rest)} "
            f"median {statistics.median(rest) * 1e3:.2f} ms, max "
            f"{max(rest) * 1e3:.2f} ms")

        # (b) corruption
        path_b = mgr.save(CKPT_RN50_STEPS, resnet_checkpoint_entries(
            st, bn, CKPT_RN50_STEPS))
        with open(path_b, "r+b") as f:
            f.truncate(os.path.getsize(path_b) // 2)
        try:
            checkpoint.verify(path_b)
            err = None
        except checkpoint.CheckpointError as e:
            err = e
        require(err is not None and "truncated" in str(err),
                f"verify of a truncated checkpoint: {err!r}")
        latest = mgr.latest()
        require(latest == (CKPT_RN50_SPLIT, path),
                f"latest() after truncation: {latest}")
        log(f"  (b) truncated {os.path.basename(path_b)}: "
            f"{type(err).__name__}: {err}; latest() -> step {latest[0]}")
        shard = ds.index.shards[2]
        shard_path = ds.index.path_for(2)
        with open(shard_path, "r+b") as f:
            f.seek(os.path.getsize(shard_path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        rid = int(ds.index.starts[2]) + 5
        try:
            ShardedDataset(data_dir).gather(np.asarray([rid]))
            err = None
        except ShardChecksumError as e:
            err = e
        require(err is not None and err.shard == shard.file
                and err.offset == 5,
                f"flipped byte in {shard.file}: {err!r}")
        log(f"  (b) flipped a byte of {shard.file}: "
            f"{type(err).__name__}: {err}")
    finally:
        torch.backends.cudnn.deterministic = False
    del st, bn, st_a, bn_a, st0, bn0
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the O5 BERT step at 2 layers: bf16 leaves, the FusedLAMB state
    cfg = bert_large_config(num_layers=CKPT_BERT_LAYERS, attn_impl="fast",
                            remat=True, dtype=torch.bfloat16)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    b0 = _train_state(params, None)
    del params
    batches = [_batch(cfg, 8, 512, 20 + i, dev)
               for i in range(CKPT_BERT_STEPS)]
    build.LAUNCHES.clear()
    st, straight = b0, []
    for batch in batches:
        st, loss = train_step(st, batch, cfg)
        straight.append(loss.item())
    launches_o5 = dict(build.LAUNCHES)
    check_launches("ckpt_o5", launches_o5, CKPT_BERT_STEPS)
    st_a = st
    st, resumed = b0, []
    for batch in batches[:CKPT_BERT_SPLIT]:
        st, loss = train_step(st, batch, cfg)
        resumed.append(loss.item())
    bpath = os.path.join(root, "bert_o5.ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(bpath, step=CKPT_BERT_SPLIT, model=st.model_params,
                    masters=st.master_params, opt=st.opt_state,
                    amp=amp.state_dict(st))
    bsave_s = time.perf_counter() - t0
    params = transformer_init(cfg, torch.Generator().manual_seed(1),
                              device=dev)
    st = _train_state(params, None)
    del params
    t0 = time.perf_counter()
    payload = checkpoint.load(bpath)
    bload_s = time.perf_counter() - t0
    require(payload["masters"] is None and st.master_params is None,
            "O5 + FusedLAMB(fused): the masters live in the flat state")
    st = amp.load_state_dict(st._replace(
        model_params=checkpoint.restore_like(st.model_params,
                                             payload["model"]),
        opt_state=checkpoint.restore_like(st.opt_state, payload["opt"])),
        payload["amp"])
    for batch in batches[CKPT_BERT_SPLIT:]:
        st, loss = train_step(st, batch, cfg)
        resumed.append(loss.item())
    diff = ([f"model/{p}" for p in _differing(st.model_params,
                                               st_a.model_params)]
            + [f"opt/{p}" for p in _differing(st.opt_state, st_a.opt_state)])
    require(resumed == straight and not diff,
            f"O5 BERT resume is not the straight run's bits: losses "
            f"{resumed} vs {straight}; differing leaves {diff[:8]} "
            f"({len(diff)} of the model and FusedLAMB state)")
    require("ml_dtypes" not in sys.modules, "ml_dtypes was imported")
    require(st.model_params["layers"]["wqkv"].dtype == torch.bfloat16,
            "O5: bf16 model")
    bmb = os.path.getsize(bpath) / 1e6
    log(f"  (c) O5 BERT, {CKPT_BERT_LAYERS} layers at full width: losses "
        f"{straight}; {CKPT_BERT_SPLIT} + save / load (bf16 model leaves, "
        f"FusedLAMBState) + {CKPT_BERT_STEPS - CKPT_BERT_SPLIT}: the same "
        "losses and bits in every model and FusedLAMB leaf; ml_dtypes not "
        f"imported; launches in {CKPT_BERT_STEPS} steps {launches_o5}")
    log(f"  [{card}] (d) the BERT checkpoint: {bmb:.1f} MB; save "
        f"{bsave_s * 1e3:.1f} ms ({bmb / bsave_s:.0f} MB/s), load "
        f"{bload_s * 1e3:.1f} ms ({bmb / bload_s:.0f} MB/s)")
    del st, st_a, b0, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches_rn50, launches_o5


# ---------------------------------------------------------------------------
# phase 20: the attention modules (the reference's MHA perf-test stack)
# ---------------------------------------------------------------------------

# apex's perf_test_multihead_attn.py defaults: hidden 1024, 16 heads, 64
# tokens, up to 120 sequences, 18 layers, dropout 0.1, --norm-add --biases
MHA_E, MHA_H, MHA_LAYERS, MHA_SEQS, MHA_SQ = 1024, 16, 18, 120, 64
# the encoder-decoder stack's encoder positions
MHA_SK = 96
MHA_STEPS = 10
# the mask kinds of the parity phase
MHA_MASKS = ("none", "key_pad", "additive", "time", "causal")


def _mha_mask(kind, b, sq, sk, gen, dev):
    """(keyword, mask) of one mask kind on ``dev``: ragged key padding (no
    row fully padded), an additive key mask, a random time mask with its
    first key kept, the strict upper triangle; None for "none"."""
    import torch
    if kind == "none":
        return None, None
    if kind in ("key_pad", "additive"):
        lens = torch.randint(sk // 2, sk + 1, (b,), generator=gen)
        pad = torch.arange(sk)[None, :] >= lens[:, None]
        if kind == "additive":
            return "key_padding_mask", torch.where(
                pad, torch.full((), -1e9), torch.randn(b, sk, generator=gen)
            ).to(dev)
        return "key_padding_mask", pad.to(dev)
    if kind == "time":
        m = torch.rand(sq, sk, generator=gen) < 0.3
        m[:, 0] = False
        return "attn_mask", m.to(dev)
    return "attn_mask", torch.ones(sq, sk, dtype=torch.bool).triu(1).to(dev)


def _mha_stack(module, layers, dev, seed, impl="fast", **kw):
    """``layers`` attention modules at the perf test's width, weights from
    ``seed`` (the same on every device)."""
    import torch
    from torch import nn
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    cls = SelfMultiheadAttn if module == "self" else EncdecMultiheadAttn
    gen = torch.Generator().manual_seed(seed)
    return nn.ModuleList(cls(MHA_E, MHA_H, impl=impl, generator=gen,
                             device=dev, **kw) for _ in range(layers))


def _mha_batch(module, seqs, dtype, dev, seed, mask="key_pad"):
    """{"query", "target"[, "key"], mask}: seeded normal activations in
    ``dtype`` and a mask over the keys."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    sk = MHA_SQ if module == "self" else MHA_SK
    batch = {"query": torch.randn(MHA_SQ, seqs, MHA_E, generator=gen
                                  ).to(dev, dtype),
             "target": torch.randn(MHA_SQ, seqs, MHA_E, generator=gen
                                   ).to(dev, dtype)}
    if module == "encdec":
        batch["key"] = torch.randn(sk, seqs, MHA_E, generator=gen).to(
            dev, dtype)
    name, m = _mha_mask(mask, seqs, MHA_SQ, sk, gen, dev)
    if name is not None:
        batch[name] = m
    return batch


def _mha_grads(stack, batch, dropout_rng=None):
    """(output, {name: grad}) of sum(out * target) through ``stack``."""
    from apex_tpu_torch.train import mha_apply
    x = mha_apply(stack, batch, dropout_rng=dropout_rng)
    (x.float() * batch["target"].float()).sum().backward()
    return x.detach(), {n: p.grad for n, p in stack.named_parameters()}


def phase_mha_parity(dev):
    """(a) 2 layers at full width, 8 sequences x 64, card vs CPU."""
    import torch
    log("== phase 20a: attention modules, card vs CPU (2 layers, E 1024, "
        "16 heads, 8 x 64 tokens; fp32 1e-4 peak rule, bf16 2e-2: the "
        "output on the peak rule, the gradients in norm)")
    cases = [("self", impl, kind, torch.float32, None)
             for impl in ("fast", "default") for kind in MHA_MASKS]
    cases += [("self", "fast", "key_pad", torch.float32, 1234),
              ("encdec", "fast", "key_pad", torch.float32, 1234),
              ("encdec", "fast", "time", torch.float32, None),
              ("self", "fast", "key_pad", torch.bfloat16, None),
              ("encdec", "fast", "key_pad", torch.bfloat16, None),
              ("encdec", "default", "key_pad", torch.bfloat16, None)]
    for module, impl, kind, dtype, seed in cases:
        # norm-add everywhere but where the reference refuses it (an
        # additive mask) or where its residual dropout would draw from
        # each device's own generator (the dropout cases)
        kw = dict(dropout=0.1, include_norm_add=kind != "additive"
                  and seed is None)
        if module == "self":
            kw.update(bias=True, mask_additive=kind == "additive")
        runs = []
        for d in (dev, torch.device("cpu")):
            stack = _mha_stack(module, 2, d, 5, impl, **kw)
            batch = _mha_batch(module, 8, dtype, d, 6, kind)
            runs.append(_mha_grads(stack, batch, dropout_rng=seed))
        (g_out, g_grads), (c_out, c_grads) = runs
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        ok, err = peak_ok(g_out.cpu(), c_out, tol)
        require(ok, f"mha parity {module} {impl} {kind} {dtype}: out err "
                f"{err:.3g} (tol {tol}, peak rule)")
        g_err = g_rel = 0.0
        for n, cg in c_grads.items():
            gg = g_grads[n].cpu()
            rel = float((gg - cg).norm() / cg.norm())
            g_rel = max(g_rel, rel)
            g_err = max(g_err, float((gg - cg).abs().max()))
            if dtype == torch.float32:
                g_ok, _ = peak_ok(gg, cg, tol)
            else:
                # bf16 activations: a weight's gradient sums hundreds of
                # rounded products of either sign, so its small elements
                # carry the cancellation; bf16 is held in norm
                g_ok = rel <= tol
            require(g_ok, f"mha parity {module} {impl} {kind} {dtype}: "
                    f"grad {n} max err {float((gg - cg).abs().max()):.3g}, "
                    f"{rel:.3g} relative in norm (tol {tol})")
        rule = "peak rule" if dtype == torch.float32 else "in norm"
        log(f"  {module:6s} {impl:7s} {kind:8s} {str(dtype)[6:]:8s} "
            f"{'dropout 0.1, seed ' + str(seed) if seed else 'no dropout':24s}"
            f" out err {err:.3g}; grads max err {g_err:.3g}, max "
            f"{g_rel:.3g} relative in norm (tol {tol}, {rule})")


def mha_step_flops(module, seqs) -> float:
    """Analytic FLOPs of one training step of the stack: the forward's
    products (projections 2·T·E·E' each, QK^T and PV 2·B·Sq·Sk·E each) x 3
    for forward + backward, x layers."""
    tq = MHA_SQ * seqs
    if module == "self":
        fwd = 8 * tq * MHA_E ** 2 + 4 * seqs * MHA_SQ * MHA_SQ * MHA_E
    else:
        tk = MHA_SK * seqs
        fwd = (4 * tq * MHA_E ** 2 + 4 * tk * MHA_E ** 2
               + 4 * seqs * MHA_SQ * MHA_SK * MHA_E)
    return 3.0 * fwd * MHA_LAYERS


def _mha_timed(stack, opt, batch, label, path, card, module, gen):
    """One warm-up and MHA_STEPS timed steps of ``mha_train_step``: the
    launches of the timed steps, the losses and the median step time."""
    import torch
    from apex_tpu_torch.train import mha_params, mha_train_step
    from apex_tpu_torch.utils import build
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = opt.init(mha_params(stack))
    st, loss = mha_train_step(stack, opt, st, batch, dropout_rng=gen)
    losses = [loss.item()]
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    times = []
    for _ in range(MHA_STEPS):
        t0 = time.perf_counter()
        st, loss = mha_train_step(stack, opt, st, batch, dropout_rng=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{label}: loss did not fall {losses}")
    check_launches(path, launches, MHA_STEPS, exact=True)
    step_s = statistics.median(times)
    tokens = MHA_SQ * batch["query"].shape[1]
    flops = mha_step_flops(module, batch["query"].shape[1])
    log(f"  {label}: losses {[round(l, 4) for l in losses]}; launches in "
        f"{MHA_STEPS} steps {launches}")
    log(f"  [{card}] {label}: step {step_s * 1e3:.3f} ms (median of "
        f"{MHA_STEPS}; all {[round(t * 1e3, 3) for t in times]}), "
        f"{tokens / step_s:.0f} tokens/s, analytic MFU "
        f"{100 * flops / step_s / 989e12:.2f}% ({flops / 1e12:.3f} TFLOP a "
        f"step / 989 TFLOP/s bf16), peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return launches, step_s, st


def split_mha_step(stack, opt, st, batch, gen):
    """Host-clock ms of a ``mha_train_step``'s three parts, split by its
    ``mark`` hook, each part ending in a synchronize: the forward and
    loss, the backward, ``opt.step`` with the copy into the modules
    (medians of 3 steps, which the modules keep).  Returns the ms and
    the state after the steps."""
    import torch
    from apex_tpu_torch.train import mha_train_step
    parts = []
    for _ in range(3):
        stamps = []

        def mark():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        mark()
        st, _ = mha_train_step(stack, opt, st, batch, dropout_rng=gen,
                               mark=mark)
        mark()
        parts.append([b - a for a, b in zip(stamps, stamps[1:])])
    return [statistics.median(p[i] for p in parts) * 1e3
            for i in range(3)], st


def check_mha_kernels(dev, card, module, batch):
    """The stack's kernels at its own shapes against their plain versions
    on the same inputs, and timed: the forward (#1) and fused backward
    (#4) in bf16 at BH = 16 x sequences, the batch's key padding as a
    (B, 1, Sk) bias, dropout 0.1 (2e-2 on the peak rule, lse 1e-4
    relative), beside SDPA's flash forward and backward at the same shapes
    (no mask, no dropout: its flash route takes neither); the layer norm's
    forward (#5) and backward (#6) at (tokens, E) bf16 with bf16 gamma /
    beta, as the modules cast them (2e-2 scaled, mean 1e-5, invvar 1e-4
    relative)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_fused, _flash_bwd_reference, _flash_fwd, _flash_fwd_res,
        _reference)
    from apex_tpu_torch.ops.layer_norm import (ln_bwd, ln_bwd_reference,
                                               ln_fwd, ln_fwd_reference)
    aten = torch.ops.aten
    B = batch["query"].shape[1]
    sq, sk, d, bh = MHA_SQ, (MHA_SQ if module == "self" else MHA_SK), \
        MHA_E // MHA_H, MHA_H * batch["query"].shape[1]
    gen = torch.Generator().manual_seed(21)
    q = _randn((bh, sq, d), gen, torch.bfloat16, dev, d ** -0.5)
    k, v, do = (_randn(s_, gen, torch.bfloat16, dev)
                for s_ in ((bh, sk, d), (bh, sk, d), (bh, sq, d)))
    bias = torch.where(batch["key_padding_mask"], torch.full((), -1e30,
                       device=dev), torch.zeros((), device=dev)
                       ).reshape(B, 1, sk).contiguous()
    args = (q, k, v, bias, False, 0.1, 5, MHA_H)
    out, lse, stats = _flash_fwd_res(*args)
    torch.cuda.synchronize()
    r_out, r_lse = _reference(*args)
    ok, f_err = peak_ok(out, r_out, 2e-2)
    live = r_lse < 1e29
    l_err = rel_err(lse[live], r_lse[live])
    require(ok and l_err <= 1e-4 and bool(live.all()),
            f"flash_fwd at the {module} stack's shape: out err {f_err:.3g} "
            f"(tol 2e-2, peak rule), lse rel err {l_err:.3g}, every row "
            f"live {bool(live.all())}")
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    got = _flash_bwd_fused(*args, stats, delta, do)
    torch.cuda.synchronize()
    b_err = 0.0
    for gname, a, r in zip(("dq", "dk", "dv"), got,
                           _flash_bwd_reference(*args, stats, delta, do)):
        ok, err = peak_ok(a, r, 2e-2)
        require(ok, f"flash_bwd at the {module} stack's shape: {gname} err "
                f"{err:.3g} (tol 2e-2, peak rule)")
        b_err = max(b_err, err)
    del got, r_out, r_lse
    f_ms = device_ms(lambda: _flash_fwd(*args))
    b_ms = device_ms(lambda: _flash_bwd_fused(*args, stats, delta, do))
    q4, k4, v4, do4 = (t.view(B, MHA_H, -1, d) for t in (q, k, v, do))
    (o4, lse4, cq, ck, mq, mk, rs, ro,
     _) = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False,
                                                   False, scale=1.0)
    lf_ms = device_ms(lambda: aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, False, False, scale=1.0))
    lb_ms = device_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, False, rs, ro,
        scale=1.0))
    fb, fby = bound((2 * bh * sq * d + 2 * bh * sk * d) * 2 + bias.numel() * 4
                    + bh * sq * 4, 4.0 * d * sq * sk * bh, "bfloat16")
    bb, bby = bound(7 * bh * sq * d * 2 + 2 * bh * sq * 4 + bias.numel() * 4,
                    10.0 * d * sq * sk * bh, "bfloat16")
    log(f"  [{card}] kernels at the {module} stack's shape (BH {bh} x {sq} x "
        f"{sk} x {d} bf16, (B, 1, Sk) bias, dropout 0.1): flash_fwd "
        f"{f_ms:.5f} ms, err {f_err:.3g}, lse {l_err:.3g} (SDPA's flash "
        f"forward {lf_ms:.5f} ms, bound {fb:.5f} ms ({fby})); flash_bwd "
        f"{b_ms:.5f} ms, err {b_err:.3g} (SDPA's flash backward "
        f"{lb_ms:.5f} ms, bound {bb:.5f} ms ({bby}))")
    rows = MHA_SQ * B
    x = _randn((rows, MHA_E), gen, torch.bfloat16, dev)
    g = _randn((rows, MHA_E), gen, torch.bfloat16, dev)
    w = _randn((MHA_E,), gen, torch.bfloat16, dev, 0.1, 1.0)
    b = _randn((MHA_E,), gen, torch.bfloat16, dev, 0.1)
    y, mean, inv = ln_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    r_y, r_mean, r_inv = ln_fwd_reference(x, w, b, 1e-5)
    ok, n_err = scaled_ok(y, r_y, 2e-2)
    m_err = float((mean - r_mean).abs().max())
    i_err = rel_err(inv, r_inv)
    require(ok and m_err <= 1e-5 and i_err <= 1e-4,
            f"ln_fwd at ({rows},{MHA_E}) bf16: out err {n_err:.3g} (tol "
            f"2e-2), mean {m_err:.3g}, invvar {i_err:.3g}")
    dx = ln_bwd(g, x, r_mean, r_inv, w)
    torch.cuda.synchronize()
    ok, d_err = scaled_ok(dx, ln_bwd_reference(g, x, r_mean, r_inv, w), 2e-2)
    require(ok, f"ln_bwd at ({rows},{MHA_E}) bf16: err {d_err:.3g} (tol "
            "2e-2)")
    lnf_ms = device_ms(lambda: ln_fwd(x, w, b, 1e-5))
    lnb_ms = device_ms(lambda: ln_bwd(g, x, r_mean, r_inv, w))
    log(f"  [{card}] layer norm at the {module} stack's shape ({rows} x "
        f"{MHA_E} bf16): ln_fwd {lnf_ms:.5f} ms, err {n_err:.3g}, mean "
        f"{m_err:.2g}, invvar {i_err:.2g}; ln_bwd {lnb_ms:.5f} ms, err "
        f"{d_err:.3g} (tol 2e-2)")
    return dict(fwd_ms=f_ms, bwd_ms=b_ms, sdpa_fwd_ms=lf_ms,
                sdpa_bwd_ms=lb_ms, fwd_bound_ms=fb, bwd_bound_ms=bb,
                ln_fwd_ms=lnf_ms, ln_bwd_ms=lnb_ms)


def phase_mha_stack(dev, card, module, seed, profile=False):
    """(b) / (c): the 18-layer stack, fast then default, trained by
    FusedNovoGrad (self) or FusedAdagrad (encdec) on the flat engine;
    ``profile``: a profiler window over one fast step after both are
    timed."""
    import torch
    from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
    from apex_tpu_torch.train import mha_train_step
    if module == "self":
        log(f"== phase 20b: self-attention stack ({MHA_LAYERS} x "
            f"SelfMultiheadAttn({MHA_E}, {MHA_H}, dropout=0.1, bias=True, "
            f"include_norm_add=True), {MHA_SEQS} x {MHA_SQ} tokens, bf16 "
            "activations, fp32 params, FusedNovoGrad(lr=1e-2, impl='fused'))")
        kw = dict(dropout=0.1, bias=True, include_norm_add=True)
        make_opt = lambda: FusedNovoGrad(lr=1e-2, impl="fused")  # noqa: E731
    else:
        log(f"== phase 20c: encoder-decoder stack ({MHA_LAYERS} x "
            f"EncdecMultiheadAttn({MHA_E}, {MHA_H}, dropout=0.1, "
            f"include_norm_add=True), {MHA_SEQS} x {MHA_SQ} queries against "
            f"{MHA_SK} encoder positions, bf16 activations, fp32 params, "
            "FusedAdagrad(lr=1e-3, impl='fused'))")
        kw = dict(dropout=0.1, include_norm_add=True)
        # Adagrad's first step moves every weight by ~lr: at 1e-2 the
        # 18-layer stack diverges within 5 steps, at 1e-3 it falls
        make_opt = lambda: FusedAdagrad(lr=1e-3, impl="fused")  # noqa: E731
    batch = _mha_batch(module, MHA_SEQS, torch.bfloat16, dev, seed)
    pad = batch["key_padding_mask"]
    log(f"  key padding from seed {seed}: keys kept per sequence "
        f"{int((~pad).sum(1).min())}..{int((~pad).sum(1).max())} of "
        f"{pad.shape[1]}")
    check_mha_kernels(dev, card, module, batch)
    results, kept = {}, None
    for impl in ("fast", "default"):
        t0 = time.perf_counter()
        stack = _mha_stack(module, MHA_LAYERS, dev, seed, impl, **kw)
        n_params = sum(p.numel() for p in stack.parameters())
        log(f"  {impl}: {n_params} parameters from seed {seed} in "
            f"{time.perf_counter() - t0:.1f} s")
        gen = torch.Generator().manual_seed(seed + 1)
        path = f"mha_{module}" + ("" if impl == "fast" else "_default")
        opt = make_opt()
        results[impl] = _mha_timed(stack, opt, batch, f"{module} {impl}",
                                   path, card, module, gen)
        if impl == "fast":
            (f_ms, b_ms, o_ms), st = split_mha_step(
                stack, opt, results[impl][2], batch, gen)
            log(f"  [{card}] of a fast step: forward + loss {f_ms:.3f} ms, "
                f"backward {b_ms:.3f} ms, opt.step + copy-back {o_ms:.3f} ms "
                "(medians of 3)")
            if profile:
                kept = (stack, opt, st, gen)
        del stack, opt
        results[impl] = results[impl][:2]
    ratio = results["default"][1] / results["fast"][1]
    log(f"  [{card}] {module}: impl='default' (the perf test's --ref) "
        f"{results['default'][1] * 1e3:.3f} ms / impl='fast' "
        f"{results['fast'][1] * 1e3:.3f} ms = {ratio:.3f}x")
    if kept is not None:
        stack, opt, st, gen = kept
        profile_window(lambda: mha_train_step(stack, opt, st, batch,
                                              dropout_rng=gen),
                       f"mha_{module}",
                       expect={"flash_fwd_sm90_kernel": MHA_LAYERS,
                               "flash_bwd_kv_sm90_kernel": MHA_LAYERS})
        del stack, opt, st, kept
    gc.collect()
    torch.cuda.empty_cache()
    return results["fast"][0], results["default"][0]


def phase_mha_time_masks(dev, card):
    """(d) one full-width layer under each time mask: the routes the
    kernels are sent, each held to impl='default' on the card."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn import modules
    from apex_tpu_torch.utils import build
    log("== phase 20d: one full-width layer under each time mask, fast vs "
        "default on the card (fp32, 2e-3 peak rule)")
    seen = []
    real = modules.flash_attention

    def spy(q, k, v, bias, seed, causal, *rest):
        seen.append((tuple(bias.shape), bool(causal),
                     float(bias.abs().max())))
        return real(q, k, v, bias, seed, causal, *rest)

    cases = [("self", "causal", ((1, 1, MHA_SQ), True, 0.0)),
             ("self", "time", ((1, MHA_SQ, MHA_SQ), False, None)),
             ("encdec", "causal", ((1, MHA_SQ, MHA_SK), False, None)),
             ("encdec", "time", ((1, MHA_SQ, MHA_SK), False, None))]
    build.LAUNCHES.clear()
    modules.flash_attention = spy
    try:
        for module, kind, want in cases:
            kw = dict(bias=True) if module == "self" else {}
            outs = []
            for impl in ("fast", "default"):
                stack = _mha_stack(module, 1, dev, 9, impl, **kw)
                batch = _mha_batch(module, MHA_SEQS, torch.float32, dev, 10,
                                   kind)
                outs.append(_mha_grads(stack, batch))
            shape, causal, bmax = seen[-1]
            require(shape == want[0] and causal == want[1]
                    and (want[2] is None or bmax == want[2]),
                    f"{module} {kind}: the kernels got bias {shape}, causal "
                    f"{causal} (max |bias| {bmax}), expected {want}")
            (f_out, f_g), (d_out, d_g) = outs
            ok, err = peak_ok(f_out, d_out, 2e-3)
            require(ok, f"{module} {kind}: fast vs default out err {err:.3g}")
            g_err = 0.0
            for n in d_g:
                g_ok, e = peak_ok(f_g[n], d_g[n], 2e-3)
                g_err = max(g_err, e)
                require(g_ok, f"{module} {kind}: fast vs default grad {n} "
                        f"err {e:.3g}")
            log(f"  {module:6s} {kind:6s}: kernels got bias {shape}, causal "
                f"{causal}; fast vs default out err {err:.3g}, grads max "
                f"err {g_err:.3g} (tol 2e-3)")
    finally:
        modules.flash_attention = real
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check_launches("mha_time_mask", launches, 1, exact=True)
    return launches


# ---------------------------------------------------------------------------
# phase 21: fp16 through the kernels, the byte mLSTM, ASP on the O5 step
# ---------------------------------------------------------------------------

# phase 21c: the byte mLSTM of Radford et al. 2017 (vocab 256, a 64-wide
# embedding, 4096 units), batch 128 x truncation 256
RNN_VOCAB, RNN_EMB, RNN_HIDDEN, RNN_BATCH, RNN_T = 256, 64, 4096, 128, 256

# the fp16 limits, set before the first card run: an output element within
# 5e-3 on the peak rule (fp16's steps are 2^-11 relative, so both versions'
# rounding of one fp32 value to neighbouring fp16 numbers stays far
# inside), a gradient within 2e-3 relative in norm (its small elements
# carry the cancellation of sums of rounded products, which a norm
# averages out); the fp32 results of fp16 inputs (lse, the loss, the l2
# norm) keep their fp32 limits
FP16_OUT_TOL = 5e-3
FP16_GRAD_TOL = 2e-3
# the flat buffers of the fp16 l2norm and of Adam's fp16 model copy
FP16_FLAT_N = 25_296_896


def norm_rel(got, ref) -> float:
    """|got - ref| / |ref| in norm, in fp32."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def _by_dtype(make, dtypes=("float16", "bfloat16")):
    """{dtype: make(torch dtype)} over ``dtypes``."""
    import torch
    return {dt: make(getattr(torch, dt)) for dt in dtypes}


def _fp16_row(kernel, case, err, tol, ms, bf16_ms, pms, lms, library, bms,
              by, extra=""):
    lib = f"{lms:.5f} ms ({library})" if lms is not None else "none"
    log(f"  {kernel} {case} fp16 err {err:.3g} (tol {tol}){extra} | kernel "
        f"{ms:.5f} ms, bf16 instance {bf16_ms:.5f} ms  plain {pms:.5f} ms  "
        f"library {lib}  bound {bms:.5f} ms ({by})")
    return dict(kernel=kernel, case=case, dtype="float16", max_abs_err=err,
                tol=tol, ms=ms, bf16_ms=bf16_ms, plain_ms=pms,
                library_ms=lms, library=library, bound_ms=bms, bound_by=by)


def check_fp16_flash(dev, module):
    """#1 and #4 in fp16 at an MHA stack's shape (BH 1920 x 64 x Sk x 64,
    Sk 64 for the self stack, 96 for the encdec one), with the stack's
    (B, 1, Sk) key-padding bias and dropout 0.1 from one int seed: the
    forward's output on the peak rule, lse 1e-4 relative, the fused
    backward's dq, dk and dv in norm; timed beside the bf16 instances,
    the plain versions and SDPA's flash forward and backward (no mask, no
    dropout)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_fused, _flash_bwd_reference, _flash_fwd, _flash_fwd_res,
        _reference)
    aten = torch.ops.aten
    B, sq, d = MHA_SEQS, MHA_SQ, MHA_E // MHA_H
    sk = MHA_SQ if module == "self" else MHA_SK
    bh = B * MHA_H
    gen = torch.Generator().manual_seed(41)
    lens = torch.randint(sk // 2, sk + 1, (B,), generator=gen)
    bias = torch.where(torch.arange(sk)[None, :] >= lens[:, None],
                       torch.full((), -1e30), torch.zeros(())
                       ).reshape(B, 1, sk).to(dev)
    base = [torch.randn(s_, generator=gen) for s_ in
            ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))]
    base[0] = base[0] * d ** -0.5

    def inputs(dt):
        q, k, v, do = (t.to(dev, dt) for t in base)
        args = (q, k, v, bias, False, 0.1, 5, MHA_H)
        out, lse, stats = _flash_fwd_res(*args)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        return args, out, lse, stats, delta, do

    ins = _by_dtype(inputs)
    args, out, lse, stats, delta, do = ins["float16"]
    torch.cuda.synchronize()
    r_out, r_lse = _reference(*args)
    ok, f_err = peak_ok(out, r_out, FP16_OUT_TOL)
    l_err = rel_err(lse, r_lse)
    require(ok and l_err <= 1e-4 and bool((r_lse < 1e29).all()),
            f"fp16 flash_fwd at the {module} stack's shape: out err "
            f"{f_err:.3g} (tol {FP16_OUT_TOL}, peak rule), lse rel err "
            f"{l_err:.3g}")
    got = _flash_bwd_fused(*args, stats, delta, do)
    torch.cuda.synchronize()
    ref = _flash_bwd_reference(*args, stats, delta, do)
    b_err = 0.0
    for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
        require(bool(torch.isfinite(a).all()), f"fp16 flash_bwd {module} "
                f"{gname}: not finite")
        rel = norm_rel(a, r)
        require(rel <= FP16_GRAD_TOL, f"fp16 flash_bwd at the {module} "
                f"stack's shape: {gname} {rel:.3g} relative in norm (tol "
                f"{FP16_GRAD_TOL})")
        b_err = max(b_err, rel)
    del got, ref, r_out, r_lse
    times = {}
    for dt, (a_, o_, l_, st_, de_, do_) in ins.items():
        times[dt] = (device_ms(lambda: _flash_fwd(*a_)),
                     device_ms(lambda: _flash_bwd_fused(*a_, st_, de_,
                                                        do_)))
    f_pms = device_ms(lambda: _reference(*args), n=5)
    b_pms = device_ms(lambda: _flash_bwd_reference(*args, stats, delta, do),
                      n=5)
    q4, k4, v4, do4 = (t.view(B, MHA_H, -1, d) for t in
                       (args[0], args[1], args[2], do))
    (o4, lse4, cq, ck, mq, mk, rs, ro,
     _) = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False,
                                                   False, scale=1.0)
    lf = device_ms(lambda: aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, False, False, scale=1.0))
    lb = device_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, False, rs, ro,
        scale=1.0))
    fb, fby = bound((2 * bh * sq * d + 2 * bh * sk * d) * 2
                    + bias.numel() * 4 + bh * sq * 4,
                    4.0 * d * sq * sk * bh, "float16")
    bb, bby = bound(4 * bh * sq * d * 2 + 3 * bh * sk * d * 2
                    + 2 * bh * sq * 4 + bias.numel() * 4,
                    10.0 * d * sq * sk * bh, "float16")
    case = f"{module} BH{bh}x{sq}x{sk}x{d}"
    rows = [_fp16_row("flash_fwd", case, f_err, FP16_OUT_TOL,
                      times["float16"][0], times["bfloat16"][0], f_pms, lf,
                      "SDPA flash forward, no mask, no dropout", fb, fby,
                      f", lse {l_err:.2g}"),
            _fp16_row("flash_bwd", case, b_err, FP16_GRAD_TOL,
                      times["float16"][1], times["bfloat16"][1], b_pms, lb,
                      "SDPA flash backward, no mask, no dropout", bb, bby,
                      " in norm")]
    return rows


def check_fp16_flash_split(dev):
    """#2 and #3 in fp16 on the split route at the long-sequence shape (BH
    64 x 4096 x 4096 x 64, past the fuse cap): held to the plain versions
    on the first 8 heads in norm, timed beside the bf16 instances; the
    plain time is that of the first 8 heads, SDPA's flash backward (dq, dk
    and dv together) the library time."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_dkv, _flash_bwd_dkv_reference, _flash_bwd_dq,
        _flash_bwd_dq_reference, _flash_fwd, _flash_fwd_res, _resolve_fuse)
    aten = torch.ops.aten
    B, heads, S, d = LONG_SHAPE
    bh = B * heads
    require(not _resolve_fuse(None, bh, S, S, d), "the long shape fuses")
    gen = torch.Generator().manual_seed(43)
    bias = torch.zeros((1, 1, S), device=dev)
    base = [torch.randn(s_, generator=gen) for s_ in ((bh, S, d),) * 4]
    base[0] = base[0] * d ** -0.5

    def inputs(dt):
        q, k, v, do = (t.to(dev, dt) for t in base)
        out, lse, stats = _flash_fwd_res(q, k, v, bias, False, 0.0, 0, heads)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        return (q, k, v, bias, False, 0.0, 0, heads, stats, delta, do)

    ins = _by_dtype(inputs)
    args = ins["float16"]
    dq = _flash_bwd_dq(*args)
    dk, dv = _flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    q, k, v, _, _, _, _, _, stats, delta, do = args
    sl = (q[:8], k[:8], v[:8], bias, False, 0.0, 0, 1, stats[:8], delta[:8],
          do[:8])
    r_dk, r_dv = _flash_bwd_dkv_reference(*sl)
    errs = {"dq": norm_rel(dq[:8], _flash_bwd_dq_reference(*sl)),
            "dk": norm_rel(dk[:8], r_dk), "dv": norm_rel(dv[:8], r_dv)}
    del r_dk, r_dv, dq, dk, dv
    for gname, e in errs.items():
        require(e <= FP16_GRAD_TOL, f"fp16 flash split long shape {gname}: "
                f"{e:.3g} relative in norm (tol {FP16_GRAD_TOL})")
    q4, k4, v4, do4 = (t.view(B, heads, S, d) for t in (q, k, v, do))
    (o4, lse4, cq, ck, mq, mk, rs, ro,
     _) = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False,
                                                   False, scale=1.0)
    lms = device_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, False, rs, ro,
        scale=1.0))
    del o4, lse4
    io = 4 * bh * S * d * 2 + 2 * bh * S * 4
    pairs = bh * S * S
    rows = []
    for name, fn, plain, err, nbytes, flops in (
            ("flash_bwd_dq", _flash_bwd_dq, _flash_bwd_dq_reference,
             errs["dq"], io + bh * S * d * 2, 6.0 * d * pairs),
            ("flash_bwd_dkv", _flash_bwd_dkv, _flash_bwd_dkv_reference,
             max(errs["dk"], errs["dv"]), io + 2 * bh * S * d * 2,
             8.0 * d * pairs)):
        ms = {dt: device_ms(lambda a=a: fn(*a), n=5, reps=5)
              for dt, a in ins.items()}
        pms = time_ms(lambda: plain(*sl), reps=3, warmup=1)
        torch.cuda.empty_cache()
        bms, by = bound(nbytes, flops, "float16")
        rows.append(_fp16_row(
            name, f"long BH{bh}x{S}x{S}x{d}", err, FP16_GRAD_TOL,
            ms["float16"], ms["bfloat16"], pms, lms,
            "SDPA flash backward: dq, dk and dv together", bms, by,
            " in norm [plain: the first 8 heads]"))
    return rows


def check_fp16_layer_norm(dev):
    """#5 and #6 in fp16 with fp16 gamma / beta at (7,680 x 1024), the MHA
    stacks' tokens, and (4096 x 1024): out on the peak rule, mean 1e-5,
    invvar 1e-4 relative, dx in norm; beside the bf16 instances,
    ``F.layer_norm`` and aten's backward in fp16."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.layer_norm import (ln_bwd, ln_bwd_reference,
                                               ln_fwd, ln_fwd_reference)
    aten = torch.ops.aten
    rows = []
    gen = torch.Generator().manual_seed(44)
    for n, h in ((MHA_SQ * MHA_SEQS, MHA_E), (4096, 1024)):
        base = (torch.randn((n, h), generator=gen) * 2.0 + 0.5,
                torch.randn((n, h), generator=gen),
                torch.randn((h,), generator=gen) * 0.1 + 1.0,
                torch.randn((h,), generator=gen) * 0.1)
        ins = _by_dtype(lambda dt: tuple(t.to(dev, dt) for t in base))
        x, g, w, b = ins["float16"]
        y, mean, inv = ln_fwd(x, w, b, 1e-5)
        torch.cuda.synchronize()
        r_y, r_mean, r_inv = ln_fwd_reference(x, w, b, 1e-5)
        ok, y_err = peak_ok(y, r_y, FP16_OUT_TOL)
        m_err = float((mean - r_mean).abs().max())
        i_err = rel_err(inv, r_inv)
        require(ok and m_err <= 1e-5 and i_err <= 1e-4,
                f"fp16 ln_fwd ({n},{h}): out err {y_err:.3g} (tol "
                f"{FP16_OUT_TOL}, peak rule), mean {m_err:.3g}, invvar "
                f"{i_err:.3g}")
        dx = ln_bwd(g, x, r_mean, r_inv, w)
        torch.cuda.synchronize()
        d_err = norm_rel(dx, ln_bwd_reference(g, x, r_mean, r_inv, w))
        require(d_err <= FP16_GRAD_TOL, f"fp16 ln_bwd ({n},{h}): {d_err:.3g} "
                f"relative in norm (tol {FP16_GRAD_TOL})")
        f_ms = {dt: device_ms(lambda a=a: ln_fwd(a[0], a[2], a[3], 1e-5))
                for dt, a in ins.items()}
        b_ms = {dt: device_ms(lambda a=a: ln_bwd(a[1], a[0], r_mean, r_inv,
                                                 a[2]))
                for dt, a in ins.items()}
        f_pms = device_ms(lambda: ln_fwd_reference(x, w, b, 1e-5))
        b_pms = device_ms(lambda: ln_bwd_reference(g, x, r_mean, r_inv, w))
        lf = device_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
        _, a_mean, a_inv = aten.native_layer_norm(x, [h], w, b, 1e-5)
        lb = device_ms(lambda: aten.native_layer_norm_backward(
            g, x, [h], a_mean, a_inv, w, b, [True, False, False]))
        fb, fby = bound(2 * n * h * 2 + 2 * n * 4 + 2 * h * 2, 8.0 * n * h,
                        "float32")
        bb, bby = bound(3 * n * h * 2 + 2 * n * 4 + h * 2, 12.0 * n * h,
                        "float32")
        rows.append(_fp16_row("ln_fwd", f"({n},{h})", y_err, FP16_OUT_TOL,
                              f_ms["float16"], f_ms["bfloat16"], f_pms, lf,
                              "F.layer_norm", fb, fby,
                              f", mean {m_err:.2g}, invvar {i_err:.2g}"))
        rows.append(_fp16_row("ln_bwd", f"({n},{h})", d_err, FP16_GRAD_TOL,
                              b_ms["float16"], b_ms["bfloat16"], b_pms, lb,
                              "aten native_layer_norm_backward", bb, bby,
                              " in norm"))
    return rows


def check_fp16_xent(dev):
    """#7 with fp16 logits at the mLSTM's (32,768 x 256) and BERT's (4096 x
    30,592): the fp32 loss and lse held as the other dtypes' (1e-5 scaled);
    beside the bf16 instance and ``F.cross_entropy`` in fp16."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (
        _xent_fwd, _xent_fwd_reference)
    rows = []
    gen = torch.Generator().manual_seed(45)
    for n, v in ((RNN_BATCH * RNN_T, RNN_VOCAB), (4096, 30592)):
        labels = torch.randint(0, v, (n,), generator=gen).to(dev)
        base = torch.randn((n, v), generator=gen) * 3.0
        ins = _by_dtype(lambda dt: base.to(dev, dt))
        x = ins["float16"]
        loss, lse = _xent_fwd(x, labels, 0.0)
        torch.cuda.synchronize()
        r_loss, r_lse = _xent_fwd_reference(x, labels, 0.0)
        ok1, err = scaled_ok(loss, r_loss, 1e-5)
        ok2, l_err = scaled_ok(lse, r_lse, 1e-5)
        require(ok1 and ok2, f"fp16 xent ({n},{v}): loss err {err:.3g}, lse "
                f"err {l_err:.3g} (tol 1e-5)")
        ms = {dt: device_ms(lambda a=a: _xent_fwd(a, labels, 0.0))
              for dt, a in ins.items()}
        pms = device_ms(lambda: _xent_fwd_reference(x, labels, 0.0), n=5)
        lms = device_ms(lambda: F.cross_entropy(x, labels, reduction="none"))
        bms, by = bound(n * v * 2 + 16 * n, 5.0 * n * v, "float32")
        rows.append(_fp16_row("xent_fwd", f"({n},{v})", max(err, l_err),
                              1e-5, ms["float16"], ms["bfloat16"], pms, lms,
                              "F.cross_entropy", bms, by))
    return rows


def check_fp16_flat(dev):
    """#9 on an fp16 flat buffer (1e-5 relative, bit-repeatable) and #12's
    fp16 model copy (its fp32 outputs 1e-6 relative as ever, the copy
    within one fp16 step, 1e-3 relative), each of FP16_FLAT_N elements,
    beside the bf16 instance, ``torch.linalg.vector_norm`` and
    ``torch._fused_adamw_`` in fp16."""
    import torch
    from apex_tpu_torch.multi_tensor_apply import kernels
    rows = []
    n = FP16_FLAT_N
    gen = torch.Generator(device=dev).manual_seed(46)
    base = torch.randn(n, generator=gen, device=dev)
    ins = _by_dtype(lambda dt: base.to(dt))
    x = ins["float16"]
    a, b = kernels.multi_tensor_l2norm(x), kernels.multi_tensor_l2norm(x)
    ref = kernels.multi_tensor_l2norm_reference(x)
    torch.cuda.synchronize()
    err = abs(a.item() - ref.item())
    require(torch.equal(a, b) and err <= 1e-5 * ref.item(),
            f"fp16 l2norm ({n},): err {err:.3g} of {ref.item():.6g} (tol 1e-5 "
            f"relative), repeats {torch.equal(a, b)}")
    ms = {dt: device_ms(lambda t=t: kernels.multi_tensor_l2norm(t))
          for dt, t in ins.items()}
    pms = device_ms(lambda: kernels.multi_tensor_l2norm_reference(x), n=5)
    lms = device_ms(lambda: torch.linalg.vector_norm(x, dtype=torch.float32))
    bms, by = bound(2 * n + 4, 2.0 * n, "float32")
    rows.append(_fp16_row("l2norm", f"({n},)", err / ref.item(), "1e-5 rel",
                          ms["float16"], ms["bfloat16"], pms, lms,
                          "torch.linalg.vector_norm", bms, by,
                          " [repeats bit for bit]"))
    g = torch.randn(n, generator=gen, device=dev) * 3.0
    m = torch.randn(n, generator=gen, device=dev) * 0.1
    v = torch.rand(n, generator=gen, device=dev) * 0.01
    t = 3
    scal = torch.tensor([[1e-3, 0.9, 0.999, 1e-8, 0.01, 1 / (1 - 0.9 ** t),
                          1 / (1 - 0.999 ** t), 0.7]], device=dev)
    got = kernels.fused_adam_flat(g, base, m, v, scal,
                                  model_dtype=torch.float16)
    torch.cuda.synchronize()
    want = kernels.fused_adam_flat_reference(g, base, m, v, scal,
                                             model_dtype=torch.float16)
    errs = []
    for out_name, a_, r_, tol in zip(("p", "m", "v", "fp16 copy"), got, want,
                                     (1e-6, 1e-6, 1e-6, 1e-3)):
        ok, e = _rel_ok(a_, r_, tol)
        require(ok and a_.dtype == r_.dtype, f"fp16 adam {out_name}: err "
                f"{e:.3g} (tol {tol} relative), dtype {a_.dtype}")
        errs.append(e)
    del got, want
    ms = {dt: device_ms(lambda d_=getattr(torch, dt): kernels.fused_adam_flat(
        g, base, m, v, scal, model_dtype=d_)) for dt in ins}
    pms = device_ms(lambda: kernels.fused_adam_flat_reference(
        g, base, m, v, scal, model_dtype=torch.float16), n=2, reps=5)
    # the call behind torch.optim.AdamW(fused=True) on fp16 parameters,
    # gradients and moments (no fp32 master): the yardstick
    p16, g16, m16, v16 = (t_.half() for t_ in (base, g, m, v))
    step = torch.full((), float(t), device=dev)

    def adamw():
        torch._fused_adamw_([p16], [g16], [m16], [v16], [], [step], lr=1e-3,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False)
    lms = device_ms(adamw)
    del p16, g16, m16, v16
    bms, by = bound(30.0 * n, 15.0 * n, "float32")
    rows.append(_fp16_row("adam", f"({n},) fp16 model copy", max(errs),
                          "1e-6 rel (copy 1e-3 rel)", ms["float16"],
                          ms["bfloat16"], pms, lms,
                          "torch._fused_adamw_, all fp16", bms, by))
    torch.cuda.empty_cache()
    return rows


def phase_fp16_kernels(dev, card):
    """(a) every fp16 instance against its plain version at the shapes its
    paths give it, timed beside the bf16 instance."""
    import torch
    log(f"== phase 21a: fp16 kernels vs plain versions on the card [{card}] "
        f"(outputs {FP16_OUT_TOL} on the peak rule, gradients "
        f"{FP16_GRAD_TOL} relative in norm, fp32 results of fp16 inputs at "
        "their fp32 limits)")
    rows = check_fp16_flash(dev, "self") + check_fp16_flash(dev, "encdec")
    torch.cuda.empty_cache()
    rows += check_fp16_flash_split(dev)
    torch.cuda.empty_cache()
    rows += check_fp16_layer_norm(dev) + check_fp16_xent(dev)
    rows += check_fp16_flat(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_fp16_mha(dev, card, seed):
    """(b) the reference's MHA perf test in its own dtype: the 18-layer
    self stack in fp16 (``.half()``), forward and backward timed with no
    optimizer, fast then default; first, its first two layers in fp16
    against the same layers in fp32 on the card."""
    import torch
    from apex_tpu_torch.train import mha_apply
    from apex_tpu_torch.utils import build
    kw = dict(dropout=0.1, bias=True, include_norm_add=True)
    log(f"== phase 21b: the MHA perf test in fp16 ({MHA_LAYERS} x "
        f"SelfMultiheadAttn({MHA_E}, {MHA_H}, dropout=0.1, bias=True, "
        f"include_norm_add=True), {MHA_SEQS} x {MHA_SQ} tokens, fp16 "
        "parameters and activations, forward + backward, no optimizer)")
    # the first two layers, fp16 against fp32 on the card: one int dropout
    # seed gives both dtypes the same attention and residual masks
    batch32 = _mha_batch("self", MHA_SEQS, torch.float32, dev, seed)
    runs = {}
    for dt in (torch.float32, torch.float16):
        stack = _mha_stack("self", 2, dev, seed, "fast", **kw).to(dt)
        batch = {k: (v.to(dt) if v.is_floating_point() else v)
                 for k, v in batch32.items()}
        runs[dt] = _mha_grads(stack, batch, dropout_rng=1234)
        del stack
    (o16, g16), (o32, g32) = runs[torch.float16], runs[torch.float32]
    errs = {"out": norm_rel(o16, o32)}
    errs.update({n: norm_rel(g16[n], g32[n]) for n in g32})
    worst = max(errs, key=errs.get)
    require(errs[worst] <= 1e-2 and bool(torch.isfinite(o16).all()),
            f"fp16 MHA layers 0-1 vs fp32: {worst} {errs[worst]:.3g} "
            "relative in norm (tol 1e-2)")
    log(f"  layers 0-1, fp16 vs fp32 on the card (dropout 0.1, int seed): "
        f"out {errs['out']:.3g}, gradients max {errs[worst]:.3g} ({worst}) "
        "relative in norm (tol 1e-2)")
    del runs, batch32
    batch = _mha_batch("self", MHA_SEQS, torch.float16, dev, seed)
    gen_g = torch.Generator().manual_seed(seed + 2)
    grads = torch.randn(batch["query"].shape, generator=gen_g).to(
        dev, torch.float16)
    results = {}
    for impl in ("fast", "default"):
        stack = _mha_stack("self", MHA_LAYERS, dev, seed, impl, **kw).half()
        gen = torch.Generator().manual_seed(seed + 1)
        path = "fp16_mha_self" + ("" if impl == "fast" else "_default")
        fwd, bwd = [], []
        for i in range(1 + MHA_STEPS):
            for p in stack.parameters():
                p.grad = None
            if i == 1:
                build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mha_apply(stack, batch, dropout_rng=gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out.backward(grads)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i:
                fwd.append((t1 - t0) * 1e3)
                bwd.append((t2 - t1) * 1e3)
        launches = dict(build.LAUNCHES)
        check_launches(path, launches, MHA_STEPS, exact=True)
        require(bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(p.grad).all()) for p in stack.parameters()),
            f"fp16 MHA {impl}: non-finite output or gradient")
        f_ms, b_ms = statistics.median(fwd), statistics.median(bwd)
        results[impl] = (f_ms, b_ms, launches)
        log(f"  [{card}] {impl}: forward {f_ms:.3f} ms, backward "
            f"{b_ms:.3f} ms (medians of {MHA_STEPS} after 1 warm-up; "
            f"forward all {[round(t, 3) for t in fwd]}); launches in "
            f"{MHA_STEPS} steps {launches}")
        del stack, out
    fast = results["fast"][0] + results["fast"][1]
    ref = results["default"][0] + results["default"][1]
    log(f"  [{card}] fp16 self stack: impl='default' (the perf test's "
        f"--ref) {ref:.3f} ms / impl='fast' {fast:.3f} ms = "
        f"{ref / fast:.3f}x (forward + backward)")
    gc.collect()
    torch.cuda.empty_cache()
    return results["fast"][2], results["default"][2]


def markov_bytes(batch, length, seed):
    """(batch, length) int64 bytes from a seeded order-1 Markov chain over
    256 symbols whose rows are peaked (Dirichlet(0.05): a few likely
    successors each), so a byte model's loss can fall below ln 256."""
    import torch
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(rng.dirichlet(np.full(RNN_VOCAB, 0.05), RNN_VOCAB), 1)
    out = np.empty((batch, length), np.int64)
    out[:, 0] = rng.integers(0, RNN_VOCAB, batch)
    u = rng.random((batch, length))
    for t in range(1, length):
        row = cdf[out[:, t - 1]]
        out[:, t] = np.minimum((row < u[:, t:t + 1]).sum(1), RNN_VOCAB - 1)
    return torch.from_numpy(out)


def rnn_lm_step_flops(batch, t, emb=RNN_EMB, hidden=RNN_HIDDEN,
                      vocab=RNN_VOCAB) -> float:
    """Analytic FLOPs of one byte-mLSTM step: a timestep's products
    2·B·(E·4H + E·H + H·H + H·4H), x T, plus the decoder's 2·T·B·H·V,
    x 3 for forward + backward."""
    per_t = 2.0 * batch * (emb * 4 * hidden + emb * hidden + hidden * hidden
                           + hidden * 4 * hidden)
    return 3.0 * (per_t * t + 2.0 * t * batch * hidden * vocab)


def phase_rnn_lm(dev, card, seed):
    """(c) the byte mLSTM at full width: card-vs-CPU parity in fp32 (T 8,
    B 4), then fp16 training under the legacy FP16_Optimizer, batch 128 x
    truncation 256, the hidden state carried across steps, 1 warm-up + 3
    timed steps."""
    import torch
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import (rnn_lm_init, rnn_lm_loss,
                                      rnn_lm_train_step)
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import (tree_flatten, tree_map,
                                             tree_unflatten)
    log(f"== phase 21c: the byte mLSTM (vocab {RNN_VOCAB}, embedding "
        f"{RNN_EMB}, mLSTM {RNN_HIDDEN} with weight norm, decoder "
        f"{RNN_HIDDEN} -> {RNN_VOCAB}; fp16 + FP16_Optimizer(FusedAdam("
        f"lr=5e-4)), dynamic loss scale; batch {RNN_BATCH} x {RNN_T})")
    t0 = time.perf_counter()
    params, spec, rnn = rnn_lm_init(torch.Generator().manual_seed(seed),
                                    vocab=RNN_VOCAB, emb=RNN_EMB,
                                    hidden=RNN_HIDDEN, device="cpu")
    data = markov_bytes(4, 9, seed)
    runs = []
    for d in (dev, torch.device("cpu")):
        p_d = tree_map(lambda p: p.to(d), params)
        leaves, treedef = tree_flatten(p_d)
        leaves = [p.requires_grad_(True) for p in leaves]
        loss, finals = rnn_lm_loss(
            tree_unflatten(treedef, leaves), spec,
            {"tokens": data[:, :-1].t().to(d),
             "targets": data[:, 1:].t().to(d)}, rnn)
        grads = torch.autograd.grad(loss, leaves)
        runs.append(([loss.detach().cpu()]
                     + [h.detach().cpu() for h in finals[0]],
                     [g.cpu() for g in grads]))
        del p_d, leaves, grads
    (c_out, c_g), (r_out, r_g) = runs
    o_err = max(peak_ok(a, b, 1e-4)[1] for a, b in zip(c_out, r_out))
    require(all(peak_ok(a, b, 1e-4)[0] for a, b in zip(c_out, r_out)),
            f"byte mLSTM card vs CPU: loss / final state err {o_err:.3g} "
            "(tol 1e-4, peak rule)")
    g_err = 0.0
    for a, b in zip(c_g, r_g):
        ok, e = peak_ok(a, b, 1e-4)
        require(ok, f"byte mLSTM card vs CPU: a gradient err {e:.3g} (tol "
                "1e-4, peak rule)")
        g_err = max(g_err, e)
    log(f"  parity, fp32, full width, T 8 x B 4: loss {float(r_out[0]):.6f}, "
        f"loss and final (h, c) max err {o_err:.3g}, {len(c_g)} gradients "
        f"(g and v included) max err {g_err:.3g} (tol 1e-4, peak rule) "
        f"[{time.perf_counter() - t0:.1f} s]")
    del runs, c_g, r_g
    n_params = sum(p.numel() for p in tree_flatten(params)[0])
    params = tree_map(lambda p: p.to(dev, torch.float16), params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # apex amp's first dynamic scale (2^16): the legacy 2^32 start would
    # skip the first ~16 steps of this run
    opt = FP16_Optimizer(FusedAdam(lr=5e-4), params, dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 16})
    steps = 4
    data = markov_bytes(RNN_BATCH, steps * RNN_T + 1, seed + 1).to(dev)
    hx, losses, times, scales, skipped = None, [], [], [], 0
    for s in range(steps):
        if s == 1:
            build.LAUNCHES.clear()
        chunk = data[:, s * RNN_T:(s + 1) * RNN_T + 1].t()
        batch = {"tokens": chunk[:-1], "targets": chunk[1:], "hx": hx}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, loss, hx = rnn_lm_train_step(opt, params, spec, batch,
                                             rnn=rnn)
        torch.cuda.synchronize()
        if s:
            times.append(time.perf_counter() - t1)
        losses.append(loss.item())
        scales.append(opt.loss_scale)
        skipped += int(opt.overflow)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"byte mLSTM: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"byte mLSTM: loss did not fall {losses}")
    require(params["rnn"]["layer0"]["w_hh"]["weight_v"].dtype == torch.float16
            and opt.master_params["rnn"]["layer0"]["w_hh"]["weight_g"].dtype
            == torch.float32, "byte mLSTM: fp16 model, fp32 masters")
    check_launches("rnn_lm_fp16", launches, steps - 1, exact=True)
    step_s = statistics.median(times)
    flops = rnn_lm_step_flops(RNN_BATCH, RNN_T)
    log(f"  {n_params} parameters from seed {seed}; losses "
        f"{[round(l, 4) for l in losses]} (ln 256 = 5.5452); loss scale "
        f"{scales}, {skipped} skipped steps; launches in {steps - 1} steps "
        f"{launches}")
    log(f"  [{card}] step {step_s * 1e3:.2f} ms (median of {steps - 1}; all "
        f"{[round(t * 1e3, 2) for t in times]}), "
        f"{RNN_BATCH * RNN_T / step_s:.0f} bytes/s, analytic MFU "
        f"{100 * flops / step_s / 989e12:.2f}% ({flops / 1e12:.3f} TFLOP a "
        f"step / 989 TFLOP/s fp16), peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    del params, opt, data, hx
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _two_four(w, axis=-2) -> bool:
    """Every aligned group of 4 along ``axis`` has at most 2 nonzeros."""
    g = w.movedim(axis, -1).reshape(-1, 4)
    return bool(((g != 0).sum(-1) <= 2).all())


def phase_asp(dev, card):
    """(d) ASP on phase 7's O5 step: masks computed on the card over the
    fp32 parameters before ``amp.initialize`` (layers 0 and 23 held to the
    CPU's masks bit for bit), pruned, the wrapped FusedLAMB reaching
    ``SparseOptimizer.step_flat`` through amp's flat path; 1 warm-up + 3
    timed steps, every eligible leaf 2:4 after each."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.contrib.sparsity import ASP, create_mask
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import train_step
    from apex_tpu_torch.utils import build
    names = ("wqkv", "wo", "w1", "w2")
    log("== phase 21d: ASP 2:4 on the O5 step (BERT-large, 24 layers, bf16, "
        "FusedLAMB fused with the clip, flash, remat, batch 8 x 512; "
        f"allowed layers {names})")
    cfg = bert_large_config(attn_impl="fast", remat=True,
                            dtype=torch.bfloat16)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    asp = ASP(allowed_layer_names=names).init_model_for_pruning(params)
    want = {f"layers/{n}" for n in names}
    got = sorted(asp._eligible_paths)
    require(set(got) == want, f"ASP eligible {got}, expected {sorted(want)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = asp.compute_sparse_masks(params)
    torch.cuda.synchronize()
    mask_ms = (time.perf_counter() - t0) * 1e3
    for n in names:
        for i in (0, cfg.num_layers - 1):
            cpu = create_mask(params["layers"][n][i].cpu())
            require(torch.equal(masks["layers"][n][i].cpu(), cpu),
                    f"ASP mask layers/{n}[{i}]: card and CPU differ")
    params = asp.prune(params, masks)
    opt = asp.wrap_optimizer(FusedLAMB(lr=1e-3, weight_decay=0.01,
                                       max_grad_norm=1.0, impl="fused"),
                             masks)
    torch.cuda.reset_peak_memory_stats()
    st = amp.initialize(params, opt, opt_level="O5", verbosity=0)
    del params
    require(st.master_params is None and st.opt_state.master is not None,
            "ASP O5: the masters are not the flat fused state")
    batch = _batch(cfg, 8, 512, 7, dev)
    fl = opt.flattener
    losses, times = [], []
    for s in range(4):
        if s == 1:
            build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, loss = train_step(st, batch, cfg)
        torch.cuda.synchronize()
        if s:
            times.append(time.perf_counter() - t1)
        losses.append(loss.item())
        master = fl.unflatten(st.opt_state.master)
        for n in names:
            require(st.model_params["layers"][n].dtype == torch.bfloat16
                    and _two_four(st.model_params["layers"][n])
                    and _two_four(master["layers"][n]),
                    f"ASP step {s}: layers/{n} is not 2:4 (bf16 model or fp32 "
                    "master)")
        del master
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"ASP O5: non-finite loss {losses}")
    check_launches("asp_o5_lamb", launches, 3, exact=True)
    again = asp.compute_sparse_masks(fl.unflatten(st.opt_state.master))
    for n in names:
        require(torch.equal(again["layers"][n], masks["layers"][n]),
                f"ASP: the masks of the pruned layers/{n} do not recompute "
                "to themselves")
    step_ms = statistics.median(times) * 1e3
    o5 = RESULTS.get("o5_lamb_step_ms")
    log(f"  masks on the card in {mask_ms:.1f} ms; layers 0 and 23 = the "
        f"CPU's bits; after every step the bf16 model and the fp32 master "
        f"2:4; the masks recompute to themselves; losses "
        f"{[round(l, 5) for l in losses]}; launches in 3 steps {launches}")
    log(f"  [{card}] step {step_ms:.2f} ms (median of 3; all "
        f"{[round(t * 1e3, 2) for t in times]}) beside phase 7's "
        + (f"{o5:.2f} ms" if o5 is not None else "(not run)")
        + f"; peak device memory {peak / 2 ** 30:.2f} GiB")
    del st, opt, masks, again, fl
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# --variants: the bf16 flash kernels' tile variants, timed against each other
# ---------------------------------------------------------------------------

# Edits of the sources, each a (file under csrc/, old, new) triple whose old
# text must match once: one consumer warpgroup (64-row query tiles)
# everywhere, two (128-row) everywhere, and a lone producer warp with no
# setmaxnreg split in place of the producer warpgroup; for the key-major
# kernels (fused, dk/dv) 128-row q stages instead of 64, and 3 stages
# instead of 2.  The shipped query-major kernels take two warpgroups where
# ceil(Sq / 128) x BH >= 132, else one; the key-major ones two stages of 64
# rows.
_ATTN, _COMMON = "sm90_attn.cuh", "sm90_common.cuh"
TILE_VARIANTS = {
    "c1": [(_ATTN, ">= 132 ? 2 : 1;", ">= 132 ? 1 : 1;")],
    "c2": [(_ATTN, ">= 132 ? 2 : 1;", ">= 132 ? 2 : 2;")],
    "lone_warp": [
        (_ATTN, "kThreads = 128 * (C + 1);", "kThreads = 128 * C + 32;"),
        (_COMMON, 'asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" '
         '::: "memory");', ""),
        (_COMMON, 'asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n" '
         '::: "memory");', ";")],
    "q128": [(_ATTN, "kKvStageRows = 64;", "kKvStageRows = 128;")],
    "s3": [(_ATTN, "kKvStages = 2;", "kKvStages = 3;")],
}
# kernel, B, heads, S (= Sq = Sk), causal: the serving prefill, the O5
# training and the long-sequence shapes (dq also at the serving shape, where
# the grid is small; the fused kernel at the training shape, dk/dv at the
# long one, where the paths take them)
VARIANT_SHAPES = [
    ("flash_fwd", 1, 16, 512, True),
    ("flash_fwd", 8, 16, 512, False),
    ("flash_fwd", 4, 16, 4096, False),
    ("flash_bwd_dq", 1, 16, 512, True),
    ("flash_bwd_dq", 4, 16, 4096, False),
    ("flash_bwd", 8, 16, 512, False),
    ("flash_bwd_dkv", 4, 16, 4096, False),
]


# Edits of csrc/fused_mlp.cu's TMA + wgmma kernel, whose shipped choice is
# 128 x 256 tiles, 3 stages (with the 64 KB output buffer, 4 do not fit),
# clusters of 2 CTAs sharing w's tile by multicast and bands of 8 tile
# groups: no cluster (every CTA loads its own tile of w); 128 x 128 tiles
# with 3, then 4 stages of 32 KB; 2 stages; the groups walked row by row.
_MLP = "fused_mlp.cu"
_BN128 = (_MLP, "constexpr int kSmBN = 256;", "constexpr int kSmBN = 128;")
GEMM_VARIANTS = {
    "c1": [(_MLP, "constexpr int kSmCluster = 2;",
            "constexpr int kSmCluster = 1;")],
    "bn128": [_BN128],
    "bn128_s4": [_BN128, (_MLP, "constexpr int kSmStages = 3;",
                          "constexpr int kSmStages = 4;")],
    "s2": [(_MLP, "constexpr int kSmStages = 3;",
            "constexpr int kSmStages = 2;")],
    "g1": [(_MLP, "constexpr int kSmGroupM = 8;",
            "constexpr int kSmGroupM = 1;")],
}


def _build_variant(name, edits):
    import shutil
    from pathlib import Path
    from apex_tpu_torch.utils import build
    d = Path(HERE) / "build" / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    for source, old, new in edits:
        path = d / source
        text = path.read_text()
        require(text.count(old) == 1, f"variant {name}: {old!r} does not "
                f"match once in {source}")
        path.write_text(text.replace(old, new))
    return build.build(d)


def study_gemm_variants(dev, rounds: int = 3):
    """Each variant of :data:`GEMM_VARIANTS` built from an edited copy of
    the sources (in parallel), then the device time of every variant and
    of cuBLAS (``torch.addmm`` + ``relu_``) at the MLP's three layer shapes
    in fp16 (relu, bias), ``rounds`` rounds of all in turn; each variant's
    output is compared with the shipped kernel's."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from apex_tpu_torch.ops.fused_mlp import _route, fused_dense_act
    from apex_tpu_torch.utils import build
    log("== variants: the TMA + wgmma dense kernel's tiles, stages and order")
    libs = {"shipped": build.library()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(GEMM_VARIANTS)) as ex:
        futs = {n: ex.submit(_build_variant, n, e)
                for n, e in GEMM_VARIANTS.items()}
        for n, f in futs.items():
            res = f.result()
            for line in res.log.splitlines():
                if "spill" in line:
                    log(f"  {n} ptxas: {line.strip()}")
            libs[n] = build.load(res.path)
    log(f"  built {len(GEMM_VARIANTS)} variants in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(37)
    shapes = list(zip(MLP_SIZES[:-1], MLP_SIZES[1:]))
    ins = [_dense_inputs(MLP_BATCH, k, n, "float16", True, 0, gen, dev)
           for k, n in shapes]
    require(all(_route(x, w) == "sm90" for x, w, _ in ins),
            "the layers' route")
    times, diff = {}, {}
    shipped = build._LIB
    try:
        ref = [fused_dense_act(*a, "relu") for a in ins]
        for n, lib in libs.items():
            build._LIB = lib
            for i, a in enumerate(ins):
                diff[(i, n)] = float((fused_dense_act(*a, "relu").float()
                                      - ref[i].float()).abs().max())
        for _ in range(rounds):
            for n, lib in libs.items():
                build._LIB = lib
                for i, a in enumerate(ins):
                    times.setdefault((i, n), []).append(device_ms(
                        lambda a=a: fused_dense_act(*a, "relu")))
            for i, (x, w, b) in enumerate(ins):
                times.setdefault((i, "cuBLAS"), []).append(device_ms(
                    lambda x=x, w=w, b=b: torch.addmm(b, x, w).relu_()))
    finally:
        build._LIB = shipped
    for i, (k, n) in enumerate(shapes):
        flops = 2.0 * MLP_BATCH * k * n
        for name in [*libs, "cuBLAS"]:
            ts = times[(i, name)]
            med = statistics.median(ts)
            d = f"; output vs shipped: max |diff| {diff[(i, name)]:.3g}" \
                if name in libs else ""
            log(f"  dense_act {MLP_BATCH}x{k}@{k}x{n} fp16 relu {name:9s} "
                f"median {med:.5f} ms ({flops / med / 1e9:.1f} TFLOP/s), "
                f"rounds {[round(t, 5) for t in ts]}{d}")
    return times


def study_variants(dev, rounds: int = 3):
    """Each variant of :data:`TILE_VARIANTS` built from an edited copy of the
    sources (in parallel), then every variant's device time at each of
    :data:`VARIANT_SHAPES`, ``rounds`` rounds of all variants in turn (the
    spread between rounds is the noise a gain must beat); each variant's
    output is compared with the shipped kernels'."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _flash_bwd_dkv, _flash_bwd_dq, _flash_bwd_fused, _flash_fwd,
        _flash_fwd_res)
    from apex_tpu_torch.utils import build
    log("== variants: bf16 flash tile variants")
    libs = {"shipped": build.library()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(TILE_VARIANTS)) as ex:
        futs = {n: ex.submit(_build_variant, n, e)
                for n, e in TILE_VARIANTS.items()}
        for n, f in futs.items():
            res = f.result()
            for line in res.log.splitlines():
                if "flash" in line and ("registers" in line or "spill" in line):
                    log(f"  {n} ptxas: {line.strip()}")
            libs[n] = build.load(res.path)
    log(f"  built {len(TILE_VARIANTS)} variants in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(31)
    calls = []
    for kernel, B, heads, S, causal in VARIANT_SHAPES:
        q, k, v, bias = _flash_inputs(B, heads, S, S, 64, "zeros", gen,
                                      torch.bfloat16, dev)
        if kernel == "flash_fwd":
            calls.append(lambda q=q, k=k, v=v, b=bias, c=causal, h=heads:
                         _flash_fwd(q, k, v, b, c, 0.0, 0, h)[0])
            continue
        do = _randn(q.shape, gen, torch.bfloat16, dev)
        out, lse, stats = _flash_fwd_res(q, k, v, bias, causal, 0.0, 0, heads)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        args = (q, k, v, bias, causal, 0.0, 0, heads, stats, delta, do)
        fn = {"flash_bwd_dq": _flash_bwd_dq, "flash_bwd": _flash_bwd_fused,
              "flash_bwd_dkv": _flash_bwd_dkv}[kernel]
        calls.append(lambda a=args, f=fn: f(*a))
    times, diff = {}, {}
    shipped = build._LIB

    def outs(x):
        return x if isinstance(x, tuple) else (x,)
    try:
        ref = [outs(fn()) for fn in calls]
        for n, lib in libs.items():
            build._LIB = lib
            for i, fn in enumerate(calls):
                diff[(i, n)] = max(float((a.float() - r.float()).abs().max())
                                   for a, r in zip(outs(fn()), ref[i]))
        for _ in range(rounds):
            for n, lib in libs.items():
                build._LIB = lib
                for i, fn in enumerate(calls):
                    times.setdefault((i, n), []).append(device_ms(fn))
    finally:
        build._LIB = shipped
    for i, (kernel, B, heads, S, causal) in enumerate(VARIANT_SHAPES):
        for n in libs:
            ts = times[(i, n)]
            log(f"  {kernel} BH{B * heads}x{S}x{S}x64 bf16"
                f"{' causal' if causal else ''} {n:9s} median "
                f"{statistics.median(ts):.5f} ms, rounds "
                f"{[round(t, 5) for t in ts]}; output vs shipped: max "
                f"|diff| {diff[(i, n)]:.3g}")
    return times


# ---------------------------------------------------------------------------
# phase 24: the self-resuming training guard
# ---------------------------------------------------------------------------

GUARD_DIR = os.path.join(HERE, "build", "phase24")
GUARD_RN50_STEPS, GUARD_SAVE_EVERY, GUARD_CHECK_EVERY = 12, 4, 2
GUARD_NATIVE_RECORDS = 256
GUARD_BERT_LAYERS, GUARD_BERT_STEPS = 2, 8
#: phase 24's two ResNet-50 hosts for phase 25's fleet view
FLEET_HOSTS_DIR = os.path.join(GUARD_DIR, "hosts")


def _guard_spans(tracer) -> dict:
    """Seconds spent in each of the guard's checkpoint spans."""
    out = {}
    for e in tracer.export()["traceEvents"]:
        if e.get("ph") == "X" and e["name"] in ("ckpt.write", "ckpt.restore",
                                                "guard.backoff"):
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def _keep_host(name, rep, flight_reason=None):
    """A run dir for phase 25's fleet view: ``rep``'s ``GOODPUT.json`` and
    the flight dumps of ``flight_reason`` (the guard writes both into the
    shared flight dir, one run after another)."""
    import shutil
    require(rep.goodput is not None, f"{name}: the guard wrote no goodput")
    d = os.path.join(FLEET_HOSTS_DIR, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "GOODPUT.json"), "w") as f:
        json.dump(rep.goodput, f, indent=1)
    flights = os.path.join(GUARD_DIR, "flight")
    for f in sorted(os.listdir(flights)) if flight_reason else ():
        if f.startswith(f"flight-{flight_reason}-"):
            shutil.copy(os.path.join(flights, f), d)


def _guarded_rn50(st, bn, cfg, batches, ckpt, steps, **kw):
    """The imagenet ``--auto-resume`` entry at phase 24's cadence:
    (amp_state, bn_state, report, status, guard)."""
    from apex_tpu_torch.train import (resnet_auto_resume_guard,
                                      resnet_guarded_run)
    g = resnet_auto_resume_guard(cfg, steps, ckpt_dir=ckpt,
                                 save_every=GUARD_SAVE_EVERY,
                                 print_freq=GUARD_CHECK_EVERY, log=None,
                                 **kw)
    out = resnet_guarded_run(st, bn, g, batches, steps, log=log)
    require(g.host_reads == g.health_checks + out[2].checkpoints,
            f"guard reads {g.host_reads} != checks {g.health_checks} + "
            f"snapshots {out[2].checkpoints}")
    return out + (g,)


def phase_guard(dev, card):
    """The self-resuming ``TrainGuard`` on the card, three legs:

    (a) ResNet-50 config 2 at full width (batch 128 x 224^2, amp O2 +
    FusedAdam, bf16 activations, ``cudnn.deterministic``) through the
    imagenet ``--auto-resume`` entry (``train.resnet_auto_resume_guard`` /
    ``resnet_guarded_run``: a save every 4 steps, a check every 2) over the
    example's step-addressable synthetic batches: 12 steps unguarded; 12
    guarded with ``preempt@6`` (status 3), then a rerun from a seed-1
    state that resumes (status 0); 12 with ``nan@5x3`` (exactly one
    rollback).  Both guarded runs end on the unguarded run's bits, and
    every guard's host reads are its checks plus its snapshots.  A real
    ``SIGTERM`` raised mid-run preempts, and the previous handler comes
    back.  The checkpoint write, restore and backoff seconds and the
    GOODPUT.json fraction of the guarded runs are printed.
    (b) the same path over the native prefetch ring on memmapped ``.npy``
    files under ``build/``: the ring is built (``native_available``) and
    hands out pinned tensors; 4 steps complete; ``loader_stall@3:1.5``
    with ``wait_timeout`` 0.5 raises ``LoaderStallError``; a needed
    rollback raises ``GuardAbort``.
    (c) phase 19's O5 BERT leg (full width, 2 layers, FusedLAMB) under
    ``train.o5_guard_step``: 8 steps clean and 8 with ``nan@3x3`` (one
    rollback to step 0, 6 steps replayed), the final state bitwise the
    clean run's, the launches exactly phase 7's a layer times the steps
    run, replays included; between checks the guard's own code runs under
    ``set_sync_debug_mode("error")``.  Returns the legs' launch counts."""
    import shutil
    import signal
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.data import (ArraySource, LoaderStallError,
                                     NativeLoader, native_available)
    from apex_tpu_torch.models import (bert_large_config, resnet50_config,
                                       resnet_init, transformer_init)
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import (GuardAbort, GuardConfig,
                                           TrainGuard, faults)
    from apex_tpu_torch.telemetry import trace
    from apex_tpu_torch.train import (o5_guard_step, resnet_guard_batches,
                                      resnet_synthetic_batch_at,
                                      resnet_train_step)
    from apex_tpu_torch.utils import build
    log(f"== phase 24: the training guard (ResNet-50 config 2, "
        f"{GUARD_RN50_STEPS} steps: unguarded, preempt@6 + resume, "
        f"nan@5x3 + rollback, a real SIGTERM; the native ring; O5 BERT at "
        f"{GUARD_BERT_LAYERS} layers with nan@3x3)")
    shutil.rmtree(GUARD_DIR, ignore_errors=True)
    os.makedirs(GUARD_DIR)
    t_phase = time.perf_counter()

    # (a) ResNet-50 config 2 over the synthetic step-addressable batches
    cfg = resnet50_config(dtype=torch.bfloat16)

    def start(seed):
        params, bn = resnet_init(torch.Generator().manual_seed(seed), cfg,
                                 device=dev)
        return amp.initialize(params, FusedAdam(lr=RN50_LR),
                              opt_level="O2", verbosity=0), bn

    cache = {}

    def batches(step):
        # the example's batch of ``step``, made once: still step-addressable
        if step not in cache:
            cache[step] = resnet_synthetic_batch_at(RN50_BATCH, 0, step,
                                                    device=dev)
        return cache[step]
    require(callable(resnet_guard_batches(None, "python", RN50_BATCH, 0,
                                          GUARD_RN50_STEPS, device=dev)),
            "the synthetic source is not step-addressable")
    tracer = trace.Tracer(enabled=True,
                          flight_dir=os.path.join(GUARD_DIR, "flight"))
    prev_tracer = trace.set_tracer(tracer)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    build.LAUNCHES.clear()
    try:
        st0, bn0 = start(0)
        st, bn = st0, bn0
        for i in range(GUARD_RN50_STEPS):
            st, bn, _, _ = resnet_train_step(st, bn, *batches(i), cfg)
        ref = (st, bn)
        torch.cuda.synchronize()
        ck = os.path.join(GUARD_DIR, "rn50_preempt")
        plan = faults.parse("preempt@6")
        *_, rep1, code1, g1 = _guarded_rn50(st0, bn0, cfg, batches, ck,
                                            GUARD_RN50_STEPS, plan=plan)
        require(code1 == 3 and rep1.status == "preempted"
                and rep1.final_step == 6, f"preempt@6: {rep1}")
        st1, bn1 = start(1)
        st, bn, rep2, code2, g2 = _guarded_rn50(st1, bn1, cfg, batches, ck,
                                                GUARD_RN50_STEPS, plan=plan)
        del st1, bn1
        diff = _differing((st.model_params, st.master_params, st.opt_state,
                           bn), (ref[0].model_params, ref[0].master_params,
                                 ref[0].opt_state, ref[1]))
        require(code2 == 0 and rep2.resumed_from == 6 and not diff
                and amp.state_dict(st) == amp.state_dict(ref[0]),
                f"preempt + resume is not the unguarded run's bits: "
                f"{rep2}; differing {diff[:8]} ({len(diff)})")
        _keep_host("rn50_preempt_resume", rep2, "preempt")
        ck = os.path.join(GUARD_DIR, "rn50_nan")
        st, bn, rep3, code3, g3 = _guarded_rn50(
            st0, bn0, cfg, batches, ck, GUARD_RN50_STEPS,
            plan=faults.parse("nan@5x3"))
        diff = _differing((st.model_params, st.master_params, st.opt_state,
                           bn), (ref[0].model_params, ref[0].master_params,
                                 ref[0].opt_state, ref[1]))
        require(code3 == 0 and rep3.rollbacks == 1
                and rep3.faults_injected == 3 and not diff
                and amp.state_dict(st) == amp.state_dict(ref[0]),
                f"nan@5x3: {rep3}; differing {diff[:8]} ({len(diff)})")
        del st, bn
        launches_rn50 = dict(build.LAUNCHES)
        check_launches("rn50", launches_rn50, 1, exact=True)
        spans = _guard_spans(tracer)
        fraction = (rep3.goodput or {}).get("goodput_fraction")
        require(rep3.goodput_path is not None
                and os.path.exists(rep3.goodput_path),
                f"GOODPUT.json not written: {rep3.goodput_path}")
        # a real SIGTERM, delivered from inside the batch source at step 2
        before = signal.getsignal(signal.SIGTERM)

        def signalling(step):
            if step == 2:
                signal.raise_signal(signal.SIGTERM)
            return batches(step)
        *_, rep4, code4, _ = _guarded_rn50(
            st0, bn0, cfg, signalling, os.path.join(GUARD_DIR, "rn50_sig"),
            4)
        require(code4 == 3 and rep4.status == "preempted"
                and signal.getsignal(signal.SIGTERM) is before,
                f"SIGTERM: {rep4}, handler restored "
                f"{signal.getsignal(signal.SIGTERM) is before}")
        log(f"  (a) ResNet-50 config 2: preempt@6 -> status {code1}, "
            f"resumed from {rep2.resumed_from} -> status {code2}; nan@5x3 -> "
            f"{rep3.rollbacks} rollback; both the unguarded run's bits; "
            f"SIGTERM at step 2 -> {rep4.status} at {rep4.final_step}, "
            f"handler restored; reads = checks + snapshots: "
            f"{[(g.host_reads, g.health_checks) for g in (g1, g2, g3)]}, "
            f"checkpoints {[r.checkpoints for r in (rep1, rep2, rep3)]}")
        log(f"  [{card}] (a) the guard's checkpoint writes "
            f"{spans.get('ckpt.write', 0.0):.3f} s, restores "
            f"{spans.get('ckpt.restore', 0.0):.3f} s, backoff "
            f"{spans.get('guard.backoff', 0.0):.3f} s over the guarded "
            f"runs; GOODPUT.json fraction of the nan@5x3 run {fraction}")
        del ref, cache
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the native ring over memmapped .npy files
        require(native_available(), "the native prefetch ring did not build")
        npy = os.path.join(GUARD_DIR, "npy")
        os.makedirs(npy)
        rng = np.random.default_rng(24)
        np.save(os.path.join(npy, "images.npy"), rng.random(
            (GUARD_NATIVE_RECORDS, RN50_HW, RN50_HW, 3), dtype=np.float32))
        np.save(os.path.join(npy, "labels.npy"), rng.integers(
            0, 1000, GUARD_NATIVE_RECORDS).astype(np.int32))
        src = ArraySource(
            data=np.load(os.path.join(npy, "images.npy"), mmap_mode="r"),
            labels=np.load(os.path.join(npy, "labels.npy"), mmap_mode="r"))
        x, y = next(iter(NativeLoader(src, batch_size=RN50_BATCH, steps=1)))
        require(x.is_pinned() and y.is_pinned()
                and x.shape == (RN50_BATCH, RN50_HW, RN50_HW, 3),
                f"native batch: pinned {x.is_pinned()}, {tuple(x.shape)}")

        def native(steps, timeout=None):
            b = resnet_guard_batches(npy, "native", RN50_BATCH, 0, steps,
                                     device=dev, wait_timeout=timeout)
            require(not callable(b), "the native source is step-addressable")
            return b
        *_, rep5, code5, _ = _guarded_rn50(
            st0, bn0, cfg, native(4), os.path.join(GUARD_DIR, "native_a"), 4)
        require(code5 == 0, f"native run: {rep5}")
        _keep_host("rn50_clean", rep5)
        prev_plan = faults.install(faults.parse("loader_stall@3:1.5"))
        try:
            _guarded_rn50(st0, bn0, cfg, native(6, 0.5),
                          os.path.join(GUARD_DIR, "native_b"), 6)
            stall = None
        except LoaderStallError as e:
            stall = e
        finally:
            faults.install(prev_plan)
        require(stall is not None, "loader_stall@3:1.5 did not raise")
        try:
            _guarded_rn50(st0, bn0, cfg, native(8),
                          os.path.join(GUARD_DIR, "native_c"), 8,
                          plan=faults.parse("nan@1x4"))
            abort = None
        except GuardAbort as e:
            abort = e
        require(abort is not None and "plain iterator" in str(abort),
                f"a rollback on the native source: {abort!r}")
        log(f"  (b) native ring (native_available True, pinned batches): 4 "
            f"steps {rep5.status}; loader_stall@3:1.5 with wait_timeout 0.5 "
            f"-> {type(stall).__name__}: {stall}; a needed rollback -> "
            f"{type(abort).__name__}")
    finally:
        torch.backends.cudnn.deterministic = False
        trace.set_tracer(prev_tracer)
    del st0, bn0
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the O5 BERT leg under the guard
    bcfg = bert_large_config(num_layers=GUARD_BERT_LAYERS, attn_impl="fast",
                             remat=True, dtype=torch.bfloat16)
    params = transformer_init(bcfg, torch.Generator().manual_seed(0),
                              device=dev)
    b0 = _train_state(params, None)
    del params
    bbatches = []
    for i in range(GUARD_BERT_STEPS):
        b = _batch(bcfg, 8, 512, 40 + i, dev)
        b["weights"] = torch.ones_like(b["tokens"],    # a float leaf
                                       dtype=torch.float32)
        bbatches.append(b)
    inner = o5_guard_step(bcfg)
    window = {"on": False}

    def step(state, batch):
        # the guard's own code between two step calls that no check
        # separates runs with any host sync raising
        torch.cuda.set_sync_debug_mode(0)
        out = inner(state, batch)
        if window["on"]:
            torch.cuda.set_sync_debug_mode("error")
        return out

    def bsource(i):
        window["on"] = (i + 1) % GUARD_CHECK_EVERY != 0 \
            and i + 1 < GUARD_BERT_STEPS
        return bbatches[i]

    def run(name, plan):
        build.LAUNCHES.clear()
        g = TrainGuard(step, GuardConfig(
            ckpt_dir=os.path.join(GUARD_DIR, name), enabled=True,
            save_every_steps=GUARD_BERT_STEPS,
            check_every=GUARD_CHECK_EVERY, backoff_seconds=0.25),
            plan=plan)
        try:
            st, rep = g.run(b0, bsource, GUARD_BERT_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(g.host_reads == g.health_checks + rep.checkpoints,
                f"O5 {name}: reads {g.host_reads} != checks "
                f"{g.health_checks} + snapshots {rep.checkpoints}")
        return st, rep, dict(build.LAUNCHES)
    st_clean, rep_c, launches_clean = run("o5_clean", None)
    st, rep_n, launches_nan = run("o5_nan", faults.parse("nan@3x3"))
    steps_run = GUARD_BERT_STEPS + 6      # rollback to 0 at the check at 6
    require(rep_c.status == rep_n.status == "completed"
            and rep_n.rollbacks == 1, f"O5 guard: {rep_c}, {rep_n}")
    check_launches("ckpt_o5", launches_clean, GUARD_BERT_STEPS, exact=True)
    check_launches("ckpt_o5", launches_nan, steps_run, exact=True)
    diff = ([f"model/{p}" for p in _differing(st.model_params,
                                               st_clean.model_params)]
            + [f"opt/{p}" for p in _differing(st.opt_state,
                                              st_clean.opt_state)])
    require(not diff and amp.state_dict(st) == amp.state_dict(st_clean),
            f"O5 nan@3x3 + rollback is not the clean guarded run's bits: "
            f"{diff[:8]} ({len(diff)})")
    # does the step itself sync?  (one step under the error mode)
    torch.cuda.set_sync_debug_mode("error")
    try:
        inner(st, bbatches[0])
        step_syncs = "no"
    except RuntimeError as e:
        step_syncs = f"yes ({str(e).splitlines()[0][:80]})"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"  (c) O5 BERT, {GUARD_BERT_LAYERS} layers at full width: clean "
        f"{GUARD_BERT_STEPS} steps and nan@3x3 ({rep_n.rollbacks} rollback, "
        f"{steps_run} steps run) end on the same bits; launches exactly "
        f"phase 7's a layer x steps run: {launches_nan}; the guard's code "
        f"between checks ran under set_sync_debug_mode('error'); the step "
        f"itself syncs: {step_syncs}")
    del st, st_clean, b0, bbatches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [{card}] phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return launches_rn50, launches_nan


# ---------------------------------------------------------------------------
# phase 25: the profiling layer on the port's own traces
# ---------------------------------------------------------------------------

PROFILE_DIR = os.path.join(HERE, "build", "phase25")
PROFILE_OUT = os.path.join(HERE, "chiprun_out", "phase25")
PROFILE_STEPS = 4
#: the sentinel leg's steps, the slow one and its sleep
SENT_STEPS, SENT_SLOW, SENT_SLEEP_S = 12, 8, 0.5


def _traced_steps(step, n, log_dir, warmup=None):
    """One ``pyprof.trace`` over a warm-up call (``warmup``, default
    ``step``, under ``pyprof.annotate("warmup")``: a session's first
    kernels can be missing from its trace, two of the O5 step's ln_fwd
    were in a whole smoke) and ``n`` calls of ``step``, each under
    ``pyprof.annotate("train.step")``; (events, decomposition, launches
    counted around the ``n`` calls)."""
    import torch
    from apex_tpu_torch import pyprof
    from apex_tpu_torch.telemetry import timeline
    from apex_tpu_torch.utils import build
    torch.cuda.synchronize()
    with pyprof.trace(log_dir):
        with pyprof.annotate("warmup"):
            (warmup or step)()
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        for _ in range(n):
            with pyprof.annotate("train.step"):
                step()
    launches = dict(build.LAUNCHES)
    events = timeline.load_events(log_dir)
    return events, timeline.decompose(events), launches


def _check_windows(what, events, decomp, n):
    """Each step's device window is busy + idle within 0.1 ms; returns
    the per-step rows (one device)."""
    from apex_tpu_torch.telemetry import timeline
    require(decomp["devices"] == ["GPU:0"] and decomp["n_steps"] == n,
            f"{what}: devices {decomp['devices']}, {decomp['n_steps']} "
            f"device step windows, expected one card and {n}")
    windows = timeline.step_windows(events)
    rows = []
    for s, (_, t0, t1) in zip(decomp["steps"], windows):
        d = s["devices"]["GPU:0"]
        require(abs(d["busy_ms"] + d["idle_ms"] - s["dur_ms"]) <= 0.1,
                f"{what} step {s['step']}: busy {d['busy_ms']} + idle "
                f"{d['idle_ms']} != window {s['dur_ms']} ms")
        work = [e for e in events if e.get("cat") in timeline.DEVICE_CATS
                and t0 <= e["ts"] < t1]
        rows.append(dict(d, step=s["step"], dur_ms=s["dur_ms"],
                         work_ms=sum(e["dur"] for e in work) / 1e3,
                         streams=len({(e["pid"], e["tid"]) for e in work})))
    return rows


def _trim_trace(events, path):
    """The device work of the first device step window (and the step
    ranges, host and device) as a small Chrome trace: the CPU tests'
    fixture of a full-width O5 step."""
    import gzip
    from apex_tpu_torch.telemetry import timeline
    _, t0, t1 = timeline.step_windows(events)[0]
    first = next(e["args"].get("External id") for e in events
                 if e.get("cat") == "gpu_user_annotation"
                 and e["ts"] == t0)
    keep = []
    for e in events:
        cat = e.get("cat")
        if cat in timeline.DEVICE_CATS and t0 <= e["ts"] < t1:
            args = {k: e["args"][k] for k in ("device", "stream")
                    if k in e["args"]}
        elif (e["name"] == "train.step"
              and cat in ("gpu_user_annotation", "user_annotation")
              and e["args"].get("External id") == first):
            args = {"External id": first}
        else:
            continue
        keep.append({"ph": "X", "cat": cat, "name": e["name"],
                     "pid": e["pid"], "tid": e["tid"], "ts": e["ts"],
                     "dur": e["dur"], "args": args})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": keep}, f)
    return len(keep)


def _sync_sites(fn):
    """The host syncs of one ``fn()``, under
    ``torch.cuda.set_sync_debug_mode("warn")``: (message, the innermost
    frame of the port or the smoke, as file:line) each."""
    import traceback
    import warnings
    import torch
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "apex_tpu_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        at = frames[-1] if frames else None
        sites.append((str(message).splitlines()[0][:80],
                      f"{os.path.relpath(at.filename, HERE)}:{at.lineno} "
                      f"({at.line})" if at else f"{filename}:{lineno}"))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def phase_profiling(dev, card):
    """The profiling layer (``pyprof``, ``telemetry.attrib`` /
    ``timeline`` / ``fleet``, memory's static half) on the port's own
    paths: (a) phase 7's O5 step, a warm-up step and 4 steps inside
    ``pyprof.trace``, decomposed per device step window (each window busy
    + idle, its compute the sum of its kernels' durations on one stream,
    its hand-kernel launches by name exactly phase 7's a step), and its
    host syncs under ``set_sync_debug_mode("warn")``; (b) phase 9's ZeRO
    LAMB step on a world-1 NCCL group the same way, the decomposition fed
    to a ``GoodputLedger`` whose ``GOODPUT.json`` passes
    ``goodput_violations``; (c) ``attrib.op_table`` over one O5 step: its
    blas FLOPs ``FlopCounterMode``'s count of the same step, its kernel
    rows phase 7's launches, beside ``pyprof.prof.cost_report``; (d)
    ``memory.memory_model`` over one O5 step: params and optimizer
    classes the state's bytes, the peak within 5 % of the allocator's;
    (e) phase 23's sentinel case (12 fp32 4096^2 steps, a 0.5 s stall in
    the ninth and, so that the one-shot capture opened by the ninth holds
    them, in the tenth and eleventh), whose capture now dumps a
    ``slow_step_timeline`` with >= 450 ms of device idle in a stalled
    step; (f)
    ``fleet.build_fleet`` over phase 24's two ResNet-50 hosts.
    Runs after phase 24 and before the kernels line: no timed path
    follows a profiler session."""
    import shutil
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from apex_tpu_torch import telemetry as tel
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.pyprof import prof
    from apex_tpu_torch.telemetry import (attrib, fleet, goodput, memory,
                                          timeline)
    from apex_tpu_torch.train import train_step, zero_train_step
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    log("== phase 25: the profiling layer on the port's traces (pyprof "
        "trace, device timeline, per-op and memory attribution, the "
        "sentinel's timeline dump, the fleet view)")
    t_phase = time.perf_counter()
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    os.makedirs(PROFILE_OUT, exist_ok=True)
    o5 = {k: v for k, v in TRAIN_LAUNCHES_PER_STEP["o5_lamb"].items() if v}

    # (a) the O5 step's device timeline
    cfg = bert_large_config(attn_impl="fast", remat=True,
                            dtype=torch.bfloat16)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    box = {"st": _train_state(params, None)}
    del params
    batch = _batch(cfg, 8, 512, 7, dev)

    def o5_step():
        box["st"], _ = train_step(box["st"], batch, cfg)
    o5_step()                                           # warm-up
    syncs = _sync_sites(o5_step)
    events, decomp, launches = _traced_steps(
        o5_step, PROFILE_STEPS, os.path.join(PROFILE_DIR, "o5"))
    rows = _check_windows("O5", events, decomp, PROFILE_STEPS)
    traced = timeline.port_launches(events)
    for s, got in traced.items():
        require(got == o5, f"O5 step {s}: the trace's hand-kernel launches "
                f"{got}, phase 7's a step {o5}")
    require(all(launches.get(k, 0) == v * PROFILE_STEPS
                for k, v in o5.items()),
            f"O5 launches counted around the traced steps {launches}")
    for r in rows:
        require(r["comm_ms"] == 0.0 and r["streams"] == 1
                and abs(r["compute_ms"] - r["work_ms"]) <= 0.1,
                f"O5 step {r['step']}: comm {r['comm_ms']} ms on "
                f"{r['streams']} streams, compute {r['compute_ms']} ms vs "
                f"its kernels' {r['work_ms']:.3f} ms")
        log(f"  [{card}] (a) O5 step {r['step']}: device window "
            f"{r['dur_ms']:.3f} ms = compute {r['compute_ms']:.3f} + idle "
            f"{r['idle_ms']:.3f} ms (collective {r['comm_ms']:.3f}, exposed "
            f"{r['exposed_comm_ms']:.3f}); its kernels' durations on "
            f"{r['streams']} stream sum to {r['work_ms']:.3f} ms")
    n = _trim_trace(events, os.path.join(PROFILE_OUT,
                                         "o5_step_trace.json.gz"))
    with open(os.path.join(PROFILE_OUT, "o5_timeline.json"), "w") as f:
        json.dump(decomp, f)
    log(f"  (a) hand-kernel launches a step, by kernel name in the trace: "
        f"{traced[0]} (phase 7's); host syncs of one step: {len(syncs)}"
        + "".join(f"\n    sync: {m} at {at}" for m, at in syncs)
        + f"\n  (a) trimmed trace of step 0 ({n} events) for the CPU tests")
    require(not syncs, f"the O5 step syncs the host at {syncs}")

    # (c) the per-op table of one step, beside FlopCounterMode's count
    st = box["st"]
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    table = attrib.op_table(train_step, st, batch, cfg)
    op_s = time.perf_counter() - t0
    fc = FlopCounterMode(display=False)
    with fc:
        train_step(st, batch, cfg)
    blas = table["by_class"]["blas"]["flops"]
    kernel_rows = {}
    for r in table["rows"]:
        if r["class"] == "other" and r["opcode"] in build.KERNEL_FUNCTIONS:
            kernel_rows[r["opcode"]] = kernel_rows.get(r["opcode"], 0) + 1
    require(blas == fc.get_total_flops() and blas > 0,
            f"attrib blas flops {blas} != FlopCounterMode's "
            f"{fc.get_total_flops()}")
    require(kernel_rows == o5, f"attrib's kernel rows {kernel_rows}, "
            f"phase 7's launches a step {o5}")
    rep = prof.cost_report(train_step, st, batch, cfg)
    step_ms = RESULTS.get("o5_lamb_step_ms")
    log(f"  (c) op table of one O5 step ({len(table['rows'])} rows, recorded "
        f"in {op_s:.1f} s): blas {blas:.6g} FLOPs = FlopCounterMode's; kernel "
        f"rows {kernel_rows}")
    for line in attrib.format_op_table(table, top=20).splitlines():
        log(f"    {line}")
    for line in prof.format_report(rep).splitlines():
        log(f"    {line}")
    if step_ms:
        log(f"  [{card}] (c) roofline projection {rep['projected_ms']:.3f} ms "
            f"beside phase 7's measured step {step_ms:.2f} ms "
            f"({100 * rep['projected_ms'] / step_ms:.1f}%)")

    # (d) memory's static half over one step
    mtab = memory.memory_table(train_step, st, batch, cfg)
    model = memory.memory_model(table=mtab)

    def nbytes(tree):
        seen = {}
        for _, t in attrib.keyed_tensors(tree, "x"):
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
        return sum(seen.values())
    p_bytes = nbytes(st.model_params)
    o_bytes = nbytes((st.opt_state, st.scalers, st.master_params))
    stats = mtab["stats"]
    rel = abs(mtab["peak_bytes"] - stats["call_peak_bytes"]) \
        / stats["call_peak_bytes"]
    for line in memory.format_memory_table(mtab, top=8).splitlines():
        log(f"    {line}")
    log(f"  [{card}] (d) sweep peak {mtab['peak_bytes']} B, allocator's "
        f"call peak {stats['call_peak_bytes']} B (peak "
        f"{stats['peak_bytes']} - before {stats['allocated_before']} + "
        f"arguments {stats['argument_bytes']}): {100 * rel:.3f} % apart; "
        f"the allocator just after the sweep's peak op "
        f"{stats['allocated_at_peak_op_bytes']} B; params {p_bytes} B (bf16 "
        f"model), optimizer {o_bytes} B (fp32 master, m, v, scaler)")
    require(model["params_bytes"] == p_bytes
            and model["optimizer_bytes"] == o_bytes,
            f"memory classes params {model['params_bytes']} optimizer "
            f"{model['optimizer_bytes']}, the state's {p_bytes} / {o_bytes}")
    require(rel <= 0.05, f"sweep peak {mtab['peak_bytes']} vs the "
            f"allocator's {stats['call_peak_bytes']}: {100 * rel:.2f} %")
    require(memory.get_attribution() is model, "memory_model did not "
            "register its attribution")
    memory.set_attribution(None)
    del box, st, batch, table, mtab, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the ZeRO LAMB step's timeline, fed to a goodput ledger
    store = start_process_group()
    try:
        params = transformer_init(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
        opt = DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
                                   max_grad_norm=1.0, bf16_allgather=True,
                                   impl="fused")
        zbox = {"p": params, "st": opt.init(params)}
        del params
        mbatch = _mlm_batch(cfg, 8, 512, 11, dev)
        def zero_warm():
            zbox["p"], zbox["st"], _ = zero_train_step(
                zbox["p"], zbox["st"], mbatch, cfg, opt)
        zero_warm()
        tracer = tel.Tracer(enabled=True)
        led = goodput.GoodputLedger()
        led.attach(tracer)
        count = {"i": 0}

        def zero_step():
            # the ledger's productive step spans, on the host's clock
            with tracer.span("train.step", step=count["i"]):
                zbox["p"], zbox["st"], _ = zero_train_step(
                    zbox["p"], zbox["st"], mbatch, cfg, opt)
                torch.cuda.synchronize()
            count["i"] += 1
        zevents, zdecomp, zlaunches = _traced_steps(
            zero_step, PROFILE_STEPS, os.path.join(PROFILE_DIR, "zero"),
            warmup=zero_warm)
        led.set_decomposition(zdecomp)
        led.detach(tracer)
        gdoc = led.snapshot(status="completed")
        gpath = led.write(directory=os.path.join(PROFILE_DIR, "zero"),
                          doc=gdoc)
        zrows = _check_windows("ZeRO", zevents, zdecomp, PROFILE_STEPS)
        zero = {k: v for k, v in
                TRAIN_LAUNCHES_PER_STEP["zero_lamb"].items() if v}
        for s, got in timeline.port_launches(zevents).items():
            require(got == zero, f"ZeRO step {s}: traced launches {got}, "
                    f"phase 9's {zero}")
        require(all(zlaunches.get(k, 0) == v * PROFILE_STEPS
                    for k, v in zero.items()),
                f"ZeRO launches counted around the traced steps "
                f"{zlaunches}")
        bad = goodput.goodput_violations(json.load(open(gpath)))
        require(not bad and gdoc["steps"] == PROFILE_STEPS,
                f"ZeRO GOODPUT.json: {bad}, steps {gdoc['steps']}")
        for r in zrows:
            log(f"  [{card}] (b) ZeRO LAMB step {r['step']}: window "
                f"{r['dur_ms']:.3f} ms, compute {r['compute_ms']:.3f}, "
                f"collective {r['comm_ms']:.3f}, exposed "
                f"{r['exposed_comm_ms']:.3f}, idle {r['idle_ms']:.3f} ms")
        classes = gdoc["classes"]
        log(f"  (b) world 1: {zdecomp['totals']['comm_ms']} ms of NCCL "
            f"kernels (one rank copies, it does not reduce); GOODPUT.json "
            f"passes goodput_violations: productive "
            f"{classes['productive']['ms']:.1f} ms, exposed_comm "
            f"{classes['exposed_comm']['ms']:.3f} ms, idle "
            f"{classes['idle']['ms']:.1f} ms of {gdoc['wall_ms']:.1f} ms")
        del zbox, opt, mbatch
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) phase 23's sentinel case: the capture now dumps its timeline.
    # The sentinel fires on the slow step's time, after it ran, and
    # captures the next two, so the stall lasts three steps (the ninth
    # fires, the tenth and eleventh are captured: a session's first
    # kernels can be missing from its trace, as they were in a whole
    # smoke, and with them the first window's start), and it sits between
    # a step's launches: a device window spans its first to last kernel
    from apex_tpu_torch import pyprof
    sdir = os.path.join(PROFILE_DIR, "sentinel")
    sent = tel.SlowStepSentinel(
        window=16, warmup=6, cooldown=4, dump_dir=sdir,
        profile_dir=os.path.join(sdir, "profile"), profile_steps=2)
    tracer = tel.Tracer(enabled=True, sentinel=sent)
    prev_tracer = tel.set_tracer(tracer)
    sreg = tel.Registry(sink=tel.MemorySink(), flush_interval=0,
                        rank0_only=False, memory=False, goodput=False,
                        exporter=False)
    try:
        x = torch.randn(SENTINEL_N, SENTINEL_N, device=dev)
        for i in range(SENT_STEPS):
            with sreg.step(), pyprof.annotate("train.step"):
                for j in range(4):
                    x = torch.tanh(x @ x * 1e-3)
                    if j == 1 and SENT_SLOW <= i <= SENT_SLOW + 2:
                        torch.cuda.synchronize()
                        time.sleep(SENT_SLEEP_S)    # the injected stall
                torch.cuda.synchronize()
        sent.stop_capture()
    finally:
        tel.set_tracer(prev_tracer)
    dumps = sorted(f for f in os.listdir(sdir)
                   if f.startswith("flight-slow_step_timeline-"))
    require(sent.fires == 1 and len(dumps) == 1,
            f"sentinel fires {sent.fires}, timeline dumps {dumps}")
    tdoc = json.load(open(os.path.join(sdir, dumps[0])))
    require(not tel.trace.dump_violations(tdoc), "slow_step_timeline dump "
            "off-schema")
    tsteps = tdoc["timeline"]["decomposition"]["steps"]
    idle = [s["devices"]["GPU:0"]["idle_ms"] for s in tsteps]
    require(idle and max(idle) >= 450.0, f"the captured stalled steps' "
            f"device idle {idle} ms, expected >= 450 (a {SENT_SLEEP_S} s "
            f"sleep)")
    log(f"  [{card}] (e) sentinel fired at step {SENT_SLOW}; its capture "
        f"({len(tsteps)} device step windows) dumped {dumps[0]}: idle "
        f"{[round(v, 3) for v in idle]} ms a window, compute "
        f"{[round(s['devices']['GPU:0']['compute_ms'], 3) for s in tsteps]}")

    # (f) the fleet view over phase 24's two ResNet-50 hosts
    hosts = [os.path.join(FLEET_HOSTS_DIR, h)
             for h in ("rn50_clean", "rn50_preempt_resume")]
    doc, ftrace = fleet.build_fleet(hosts)
    fpath = fleet.write_fleet(doc, os.path.join(PROFILE_DIR, "fleet"),
                              ftrace)
    require(not fleet.fleet_violations(json.load(open(fpath))),
            "FLEET.json off-schema")
    resumed = doc["per_host"]["rn50_preempt_resume"]
    own = json.load(open(os.path.join(hosts[1], "GOODPUT.json")))
    require(resumed["goodput_source"] == "artifact"
            and resumed["goodput"] == own
            and resumed["flight_dumps"] >= 1,
            f"the resumed host's goodput {resumed['goodput_source']}, "
            f"{resumed['flight_dumps']} flight dumps")
    for line in fleet.format_fleet(doc).splitlines():
        log(f"    {line}")
    log(f"  (f) FLEET.json passes fleet_violations; the resumed host's "
        f"goodput {own['goodput_fraction']:.4f} read from its GOODPUT.json")
    took = time.perf_counter() - t_phase
    log(f"  [{card}] phase 25 took {took:.1f} s")


# ---------------------------------------------------------------------------
# phase 26: the collective schemes, the overlapped DDP buckets and zero1
# ---------------------------------------------------------------------------

# the JAX collectives leg's sizes on the TPU (bench.py:694), elements
COLL_SIZES = (2 ** 16, 2 ** 20, 2 ** 23)
COLL_SCHEMES = ("fp32", "bf16", "int8_blockscale", "adasum")
# the flagship DDP step's modes (parallel.plan.build_flagship_step's knobs)
FLAGSHIP_MODES = (
    ("off", {}),
    ("bucketed", {"overlap": "bucketed"}),
    ("zero1", {"update_sharding": "zero1"}),
    ("zero1_bucketed", {"update_sharding": "zero1", "overlap": "bucketed"}),
    ("zero1_int8", {"update_sharding": "zero1",
                    "allgather_scheme": "int8_blockscale"}),
)
FLAGSHIP_BATCH = (8, 512)
FLAGSHIP_LR = 1e-4
FLAGSHIP_STEPS = 4
# the five kernels the flagship step launches (#1, #4, #5, #6, #7)
FLAGSHIP_KERNELS = ("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd", "xent_fwd")


def _metered(fn):
    """(fn's result, the port registry's readings over the call)."""
    from apex_tpu_torch.telemetry import events
    from apex_tpu_torch.telemetry.registry import MemorySink, Registry
    reg = Registry(sink=MemorySink(), flush_interval=0, rank0_only=False)
    events.set_default(reg)
    try:
        out = fn()
        vals = reg.read()
    finally:
        events.set_default(None)
    return out, vals


def _plain_scheme(x, scheme):
    """What one rank's value becomes through ``scheme`` at world 1."""
    import torch
    from apex_tpu_torch.parallel import collectives as C
    if scheme == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if scheme == "int8_blockscale":
        q, s = C.quantize_blockscale(x.reshape(-1))
        return C.dequantize_blockscale(q, s, x.numel()).reshape(x.shape)
    return x


def check_collectives(dev, card):
    """26a: each scheme through ``allreduce_tree`` at ``COLL_SIZES`` and
    through the flat reduce-scatter / all-gather at ``FLAT_N``, held to the
    plain math on the card; the codec's codes and scales against the CPU's
    on the same data; the metered bytes."""
    import torch
    from apex_tpu_torch.parallel import allreduce_tree
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.utils import build
    rows = []
    build.LAUNCHES.clear()
    for n in COLL_SIZES:
        x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(dev)
        qg, sg = C.quantize_blockscale(x)
        qc, sc = C.quantize_blockscale(x.cpu())
        require(torch.equal(qg.cpu(), qc) and torch.equal(
            sg.cpu().view(torch.int32), sc.view(torch.int32)),
            f"int8 codec at {n}: the card's codes / scales are not the "
            "CPU's bits")
        times = {}
        for s in COLL_SCHEMES:
            out, vals = _metered(lambda: allreduce_tree(
                {"g": x}, scheme=s, min_compress_bytes=0)["g"])
            want = _plain_scheme(x, s)
            require(torch.equal(out, want), f"allreduce_tree {s} at {n}: "
                    f"max diff {float((out - want).abs().max()):.3g} from "
                    "the plain math (world 1: exact)")
            logical = vals.get("ddp.allreduce_bytes")
            wire = vals.get("ddp.allreduce_compressed_bytes")
            require(logical == 4 * n and wire == C.wire_bytes(s, n),
                    f"allreduce_tree {s} at {n}: metered {logical} logical "
                    f"/ {wire} wire bytes, expected {4 * n} / "
                    f"{C.wire_bytes(s, n)}")
            if s == "int8_blockscale":
                ratio = logical / wire
                require(ratio >= 3.5, f"int8 ratio {ratio:.3f} < 3.5")
            times[s] = time_ms(lambda: allreduce_tree(
                {"g": x}, scheme=s, min_compress_bytes=0), reps=10,
                warmup=2)
            rows.append(dict(op="allreduce_tree", n=n, scheme=s,
                             logical=logical, wire=wire, ms=times[s]))
        log(f"  [{card}] allreduce_tree at {n}: " + ", ".join(
            f"{s} {times[s]:.4f} ms" for s in COLL_SCHEMES)
            + f" (CUDA events, median of 10; exact to the plain math; int8 "
            f"ratio {4 * n / C.wire_bytes('int8_blockscale', n):.3f}; the "
            f"codec's bits are the CPU's)")
        del x, qg, sg
    x = torch.randn(FLAT_N, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    for s in COLL_SCHEMES:
        spec = C.resolve(s)
        shard, _ = C.reduce_scatter_flat(x, None, spec)
        require(torch.equal(shard, _plain_scheme(x, s)),
                f"reduce_scatter_flat {s} at {FLAT_N}: not the plain math")
        rs_ms = time_ms(lambda: C.reduce_scatter_flat(x, None, spec),
                        reps=5, warmup=1)
        del shard
        if s == "adasum":
            try:
                C.allgather_flat(x, None, spec)
                require(False, "allgather_flat adasum did not raise")
            except ValueError:
                pass
            ag_ms, wire, dt = None, None, None
        else:
            full, wire, dt = C.allgather_flat(x, None, spec)
            require(torch.equal(full, _plain_scheme(x, s))
                    and wire == C.wire_bytes(s, FLAT_N) if s != "fp32"
                    else torch.equal(full, x) and wire == 4 * FLAT_N,
                    f"allgather_flat {s} at {FLAT_N}: not the plain math or "
                    f"{wire} wire bytes")
            del full
            ag_ms = time_ms(lambda: C.allgather_flat(x, None, spec),
                            reps=5, warmup=1)
        rows.append(dict(op="flat", n=FLAT_N, scheme=s, rs_ms=rs_ms,
                         ag_ms=ag_ms, ag_wire=wire, ag_dtype=dt))
        log(f"  [{card}] {s} at {FLAT_N}: reduce_scatter_flat "
            f"{rs_ms:.3f} ms, allgather_flat "
            f"{'raises (no meaning)' if ag_ms is None else f'{ag_ms:.3f} ms'}"
            f"{'' if wire is None else f', {wire} wire bytes ({dt})'}")
    del x
    torch.cuda.empty_cache()
    require(not any(build.LAUNCHES.values()), f"the collectives launched "
            f"port kernels: {dict(build.LAUNCHES)}")
    return rows


def _flagship_tokens(cfg, dev, n):
    import torch
    gen = torch.Generator().manual_seed(26)
    return [torch.randint(0, cfg.vocab_size, FLAGSHIP_BATCH,
                          generator=gen).to(dev) for _ in range(n)]


def _no_ddp_step(cfg, params, tokens):
    """The flagship step without DDP: the loss, ``torch.autograd.grad``,
    ``step_flat`` and the overflow select; for the launch reference."""
    import torch
    from apex_tpu_torch.models import transformer_loss
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_map, \
        tree_unflatten
    opt = FusedAdam(lr=FLAGSHIP_LR, impl="fused")
    state = opt.init(params)

    def step(params, state, toks):
        leaves, td = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = transformer_loss(tree_unflatten(td, leaves),
                                {"tokens": toks, "targets": toks}, cfg)
        grads = torch.autograd.grad(loss, leaves)
        fl = opt.flattener_for(params)
        flat = fl.flatten(tree_unflatten(td, list(grads)))
        ok = torch.isfinite(flat).all()
        new = opt.step_flat(state, flat)
        state = tree_map(lambda a, b: torch.where(ok, a, b), new, state)
        return fl.unflatten(state.master, like=params), state, loss

    return step, state


def phase_flagship_ddp(dev, card):
    """26b: the flagship DDP step at full width in each of
    ``FLAGSHIP_MODES`` from the same weights."""
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.train import build_flagship_step
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    cfg = bert_large_config(attn_impl="fast")
    params0 = transformer_init(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params0))
    toks = _flagship_tokens(cfg, dev, 1 + FLAGSHIP_STEPS)

    # the launches a step makes without DDP
    step, state = _no_ddp_step(cfg, params0, toks)
    p, state, _ = step(params0, state, toks[0])
    build.LAUNCHES.clear()
    p, state, _ = step(p, state, toks[1])
    torch.cuda.synchronize()
    ref_launches = dict(build.LAUNCHES)
    del p, state
    for k in ALL_KERNELS:
        require((ref_launches.get(k, 0) > 0) == (k in FLAGSHIP_KERNELS),
                f"the flagship step without DDP launched {k} "
                f"{ref_launches.get(k, 0)} times; expected only "
                f"{FLAGSHIP_KERNELS}")
    log(f"  the step without DDP: launches a step {ref_launches}")

    runs, launches = {}, {}
    for name, kw in FLAGSHIP_MODES:
        torch.cuda.empty_cache()
        (carry, step) = build_flagship_step(cfg, ddp_kwargs=kw,
                                            params=params0, lr=FLAGSHIP_LR,
                                            device=dev)
        carry, loss = step(carry, toks[0])
        losses = [loss.item()]
        if name == "bucketed":
            # one more step with every host sync an error: the hooked
            # backward, the buckets' waits and the update make none
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                warm, _ = step(carry, toks[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            del warm
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        times = []

        def timed():
            nonlocal carry
            out = []
            for t in toks[1:]:
                t0 = time.perf_counter()
                carry, l = step(carry, t)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                out.append(l.item())
            return out

        more, vals = _metered(timed)
        losses += more
        launches[name] = dict(build.LAUNCHES)
        require(all(np.isfinite(losses)), f"flagship {name}: non-finite "
                f"loss {losses}")
        for k in ALL_KERNELS:
            require(launches[name].get(k, 0)
                    == FLAGSHIP_STEPS * ref_launches.get(k, 0),
                    f"flagship {name}: {k} launched "
                    f"{launches[name].get(k, 0)} times in {FLAGSHIP_STEPS} "
                    f"steps, the step without DDP {ref_launches.get(k, 0)}")
        eng = step.ddp.last_reduction
        extra = ""
        if name == "bucketed":
            require(eng is not None, "bucketed: no hooked reduction ran")
            ev = eng.events
            last_hook = max(i for i, (kind, _) in enumerate(ev)
                            if kind == "hook")
            first = ev.index(("launch", 0))
            require(first < last_hook and eng.launch_log == list(
                range(len(eng.buckets))),
                f"bucketed: bucket 0 launched at event {first}, the last "
                f"hook at {last_hook}; launch order {eng.launch_log}")
            order = _hook_order(eng)
            extra = (f"; {len(eng.buckets)} buckets (sizes "
                     f"{[b.elems for b in eng.buckets]}), launched in order,"
                     f" bucket 0 at event {first} of {len(ev)}, the last "
                     f"hook at {last_hook}, then {order[1]} of the "
                     f"{order[3]} hooks of later buckets; no host sync "
                     "under set_sync_debug_mode('error')")
        if name == "zero1_int8":
            ratio = vals["ddp.param_allgather_bytes"] / \
                vals["ddp.param_allgather_compressed_bytes"]
            require(ratio >= 3.5, f"zero1 int8 all-gather ratio {ratio:.3f}")
            extra = f"; int8 all-gather ratio {ratio:.3f} (metered)"
        if name.startswith("zero1"):
            extra += (f"; opt state per replica "
                      f"{vals['ddp.opt_state_bytes_per_replica'] / 2 ** 30:.3f}"
                      " GiB")
        ms = statistics.median(times) * 1e3
        runs[name] = (losses, carry[0], ms, times)
        RESULTS[f"flagship_{name}_ms"] = ms
        RESULTS[f"flagship_{name}_losses"] = losses
        log(f"  [{card}] {name}: step {ms:.2f} ms (median of "
            f"{FLAGSHIP_STEPS}; all {[round(t * 1e3, 2) for t in times]}), "
            f"{FLAGSHIP_BATCH[0] * FLAGSHIP_BATCH[1] / ms * 1e3:.0f} "
            f"tokens/s; losses {[round(l, 6) for l in losses]}{extra}")
        del carry, step
    base_l, base_p = runs["off"][0], runs["off"][1]
    for name in ("bucketed", "zero1", "zero1_bucketed"):
        require(runs[name][0] == base_l and _same_bits(runs[name][1],
                                                       base_p),
                f"flagship {name} is not off's bits: losses {runs[name][0]}"
                f" vs {base_l}")
    err = max(abs(a - b) / abs(b) for a, b in zip(runs["zero1_int8"][0],
                                                  base_l))
    int8_l = runs["zero1_int8"][0]
    require(err <= 0.05, f"zero1 int8 all-gather losses {int8_l} vs fp32 "
            f"{base_l}: {err:.3g} relative (tol 5e-2)")
    log(f"  off, bucketed, zero1 and zero1 + bucketed: the same losses and "
        f"parameter bits after {1 + FLAGSHIP_STEPS} steps; zero1 int8 "
        f"all-gather losses within {err:.3g} relative of fp32 (tol 5e-2); "
        f"{n_params} parameters, fp32, batch {FLAGSHIP_BATCH[0]} x "
        f"{FLAGSHIP_BATCH[1]}, FusedAdam(lr={FLAGSHIP_LR}, impl='fused')")
    del runs, params0
    torch.cuda.empty_cache()
    return {f"ddp_flagship_{k}": v for k, v in launches.items()}


def _hook_order(eng):
    """(bucket 0's launch event, the hooks of later buckets' leaves that
    fired after it, the events, those later leaves) of a hooked backward:
    a hook after bucket 0's launch is backward work that bucket 0's
    all-reduce can overlap."""
    ev = eng.events
    first = ev.index(("launch", 0))
    later = {i for b in eng.buckets[1:] for i in b.leaf_ids}
    after = sum(1 for kind, i in ev[first:] if kind == "hook" and i in later)
    return first, after, len(ev), len(later)


def phase_rn50_overlap(dev, card):
    """26c: ResNet-50 config 3 under ``APEX_TPU_OVERLAP=bucketed`` against
    ``off`` from the same weights, 1 + 3 steps each under
    ``cudnn.deterministic``: the same bits."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet50_config, resnet_init
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel import overlap
    from apex_tpu_torch.utils import build
    cfg = resnet50_config(dtype=torch.bfloat16)
    params, bn0 = resnet_init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    st0 = amp.initialize(params, FusedAdam(lr=RN50_LR), opt_level="O2",
                         verbosity=0)
    del params
    batches = syn_batches(dev, RN50_BATCH, 0, 4)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    runs, launches = {}, {}
    try:
        for mode in ("off", "bucketed"):
            os.environ[overlap.ENV_KNOB] = mode
            ddp = DistributedDataParallel()
            st, bn, losses, scales, _ = _rn50_steps(st0, bn0, batches[:1],
                                                    cfg, ddp=ddp)
            build.LAUNCHES.clear()
            torch.cuda.synchronize()
            st, bn, l2, s2, times = _rn50_steps(st, bn, batches[1:], cfg,
                                                ddp=ddp, sync=True)
            launches[mode] = dict(build.LAUNCHES)
            check_launches("rn50", launches[mode], len(times), exact=True)
            eng = ddp.last_reduction
            require((eng is not None) == (mode == "bucketed"),
                    f"config 3 {mode}: hooked reduction {eng}")
            order = None
            if eng is not None:
                order = _hook_order(eng)
                require(order[1] > 0 and eng.launch_log == list(
                    range(len(eng.buckets))),
                    f"config 3 bucketed: launch order {eng.launch_log}; "
                    f"{order[1]} hooks of later buckets followed bucket "
                    "0's launch")
            runs[mode] = (losses + l2, scales + s2, st, bn, times,
                          None if eng is None else (len(eng.buckets),
                                                    order))
    finally:
        os.environ.pop(overlap.ENV_KNOB, None)
        torch.backends.cudnn.deterministic = False
    off, on = runs["off"], runs["bucketed"]
    require(off[0] == on[0] and off[1] == on[1]
            and _same_bits(off[2].model_params, on[2].model_params)
            and _same_bits(off[2].master_params, on[2].master_params)
            and _same_bits(off[3], on[3]),
            f"config 3 bucketed is not off's bits: losses {on[0]} vs "
            f"{off[0]}")
    for mode, r in runs.items():
        ms = statistics.median(r[4]) * 1e3
        RESULTS[f"rn50_ddp_{mode}_ms"] = ms
        log(f"  [{card}] config 3 {mode}: step {ms:.2f} ms (median of "
            f"{len(r[4])}, cudnn.deterministic; all "
            f"{[round(t * 1e3, 2) for t in r[4]]})"
            + ("" if r[5] is None else
               f", {r[5][0]} buckets launched in order, bucket 0 at event "
               f"{r[5][1][0]} of {r[5][1][2]}, then {r[5][1][1]} of the "
               f"{r[5][1][3]} hooks of later buckets"))
    log(f"  config 3 bucketed = off bit for bit over 4 steps: losses "
        f"{[round(l, 5) for l in on[0]]}, scales, fp16 weights, fp32 "
        "masters, running statistics")
    del runs, st0, bn0, batches
    torch.cuda.empty_cache()
    return {"rn50_ddp_bucketed": launches["bucketed"]}


def phase_zero_int8(dev, card):
    """26d: phase 9's ZeRO LAMB step with the int8 reduce-scatter and its
    error-feedback residual, 1 + 3 steps, against the fp32 scheme from
    the same weights."""
    import torch
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.train import zero_train_step
    from apex_tpu_torch.utils import build
    cfg = bert_large_config(attn_impl="fast", remat=True,
                            dtype=torch.bfloat16)
    params0 = transformer_init(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    batch = _mlm_batch(cfg, 8, 512, 11, dev)
    runs = {}
    for name, scheme in (("fp32", None), ("int8", "int8_blockscale")):
        opt = DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
                                   max_grad_norm=1.0, bf16_allgather=True,
                                   impl="fused", collective_scheme=scheme)
        st = opt.init(params0)
        res = opt.init_residual(params0) if scheme else None

        def one(params, st, res):
            if res is None:
                p, s, l = zero_train_step(params, st, batch, cfg, opt)
                return p, s, l, None
            return zero_train_step(params, st, batch, cfg, opt,
                                   residual=res)

        p, st, loss, res = one(params0, st, res)
        losses = [loss.item()]
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        times = []

        def timed():
            nonlocal p, st, res
            for _ in range(3):
                t0 = time.perf_counter()
                p, st, l, res = one(p, st, res)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(l.item())

        _, vals = _metered(timed)
        runs[name] = (losses, dict(build.LAUNCHES), times, vals, res)
        check_launches("zero_lamb", runs[name][1], 3)
        del p, st, opt
        torch.cuda.empty_cache()
    (fl, flaunch, ft, fv, _), (il, ilaunch, it, iv, res) = runs["fp32"], \
        runs["int8"]
    err = max(abs(a - b) / abs(b) for a, b in zip(il, fl))
    require(err <= 0.05, f"ZeRO int8 losses {il} vs fp32 {fl}: {err:.3g} "
            "relative (tol 5e-2)")
    require(bool(torch.isfinite(res).all()) and bool((res != 0).any()),
            "ZeRO int8 residual: not finite, or all zero")
    require(ilaunch == flaunch, f"ZeRO int8 launches {ilaunch} != fp32 "
            f"{flaunch}")
    ratio = iv["zero.reduce_scatter_bytes"] / \
        iv["zero.reduce_scatter_compressed_bytes"]
    require(ratio >= 3.5, f"ZeRO int8 reduce-scatter ratio {ratio:.3f}")
    for name, r in runs.items():
        ms = statistics.median(r[2]) * 1e3
        RESULTS[f"zero_lamb_{name}_ms"] = ms
        log(f"  [{card}] ZeRO LAMB {name} reduce-scatter: step {ms:.2f} ms "
            f"(median of 3; all {[round(t * 1e3, 2) for t in r[2]]}); "
            f"losses {[round(l, 5) for l in r[0]]}")
    log(f"  int8 losses within {err:.3g} relative of fp32 (tol 5e-2); "
        f"reduce-scatter ratio {ratio:.3f} (metered); residual finite, "
        f"|r| max {float(res.abs().max()):.3g}, not all zero; launches "
        f"{ilaunch} = the fp32 scheme's")
    del params0, res, runs
    torch.cuda.empty_cache()
    return {"zero_lamb_int8": ilaunch}


def phase_serve_int8(dev, card, serve_ref=None):
    """26e: phase 5's engine and trace at ``olevel="int8"``.  ``serve_ref``
    is phase 5's (launches, tokens/s); None runs the bf16 engine here."""
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                      InferenceEngine, Request)
    from apex_tpu_torch.telemetry.serve_ledger import serve_violations
    from apex_tpu_torch.utils import build
    cfg = bert_large_config(causal=True, attn_impl="fast")
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    cache = CacheConfig(page_size=16, num_pages=257, max_ctx=512)
    out = {}
    for olevel in (("int8",) if serve_ref else ("bf16", "int8")):
        eng = InferenceEngine(params, cfg, cache=cache, olevel=olevel,
                              decode_width=8, device=dev)
        warm = ContinuousBatcher(eng)
        for i in range(2):
            warm.submit(Request(rid=f"w{i}", prompt=[5 + i] * (40 + i),
                                max_new_tokens=4, seed=100 + i))
        warm.run()
        bat = ContinuousBatcher(eng)
        reqs = _trace(cfg)
        for r in reqs:
            bat.submit(r)
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        results = bat.run()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        require(all(r.status == "done" for r in results.values())
                and len(results) == len(reqs),
                f"int8 serving: not every request done")
        doc = bat.ledger.snapshot(olevel=olevel, decode_width=8,
                                  compression_ratio=eng.compression_ratio)
        bad = serve_violations(doc)
        require(not bad, f"{olevel} serve ledger violations: {bad}")
        out[olevel] = (launches, doc, eng.compression_ratio, len(results))
        del eng, warm, bat
        torch.cuda.empty_cache()
    del params
    ref_launches, ref_tps = serve_ref if serve_ref else (
        out["bf16"][0], out["bf16"][1]["tokens_per_sec"])
    launches, doc, ratio, n_done = out["int8"]
    require(ratio >= 3.5, f"int8 compression ratio {ratio:.3f} < 3.5")
    for k in ("flash_fwd", "ln_fwd"):
        require(launches.get(k, 0) == ref_launches.get(k, 0) > 0,
                f"int8 serving launched {k} {launches.get(k, 0)} times, "
                f"the bf16 engine {ref_launches.get(k, 0)}")
    lat = doc["latency_ms"]
    log(f"  [{card}] int8 serving: {n_done} requests done, compression ratio {ratio:.3f} (ledger "
        f"{doc['compression_ratio']}), tokens/s {doc['tokens_per_sec']} "
        f"against bf16's {ref_tps}; TTFT p50 {lat['ttft_p50']} ms, latency "
        f"p50 {lat['p50']} ms, p99 {lat['p99']} ms; launches {launches} "
        "= the bf16 engine's")
    RESULTS["serve_int8_tokens_per_sec"] = doc["tokens_per_sec"]
    return {"serve_int8": launches}


def phase_collectives(dev, card, serve_ref=None):
    """Phase 26 (after 21, before 20): (a)-(e) on a world-1 NCCL group,
    destroyed before it returns.  Returns its paths' launch counts."""
    import torch.distributed as dist
    log("== phase 26: collective schemes (fp32 / bf16 / int8 block-scale / "
        "Adasum), the flagship DDP step in 5 modes, ResNet-50 config 3 "
        "under the overlap knob, ZeRO LAMB with int8, int8 serving "
        "(world-1 NCCL: a collective is a copy; correctness, launch order "
        "and bytes, not hidden wire time)")
    store = start_process_group()
    launches = {}
    try:
        log("  -- 26a: the schemes, the codec and the meters")
        RESULTS["collective_rows"] = check_collectives(dev, card)
        launches["ddp_collectives"] = {}
        log("  -- 26b: the flagship DDP step (BERT-large, fp32, batch 8 x "
            "512, FusedAdam fused, lr 1e-4)")
        launches.update(phase_flagship_ddp(dev, card))
        log("  -- 26c: ResNet-50 config 3, APEX_TPU_OVERLAP bucketed vs off")
        launches.update(phase_rn50_overlap(dev, card))
        log("  -- 26d: ZeRO LAMB (phase 9) with the int8 reduce-scatter")
        launches.update(phase_zero_int8(dev, card))
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    log("  -- 26e: int8 serving (phase 5's engine and trace)")
    launches.update(phase_serve_int8(dev, card, serve_ref))
    return launches


# ---------------------------------------------------------------------------
# phase 27: sequence, pipeline and expert parallelism, the MoE step and the
# sp engine at world 1
# ---------------------------------------------------------------------------

# (a) the long-sequence Ulysses-flash shape and the ring / Ulysses shape
SEQ_FLASH_SHAPE = (1, 16, 4096, 64)
SEQ_PLAIN_SHAPE = (2, 16, 2048, 64)
SEQ_PLAIN_TOL = 1e-4
# (c) the switch-MoE flagship: BERT-large's widths, 8 experts
MOE_CFG = dict(vocab_size=30592, max_len=512, num_layers=24, d_model=1024,
               num_heads=16, d_ff=4096, num_experts=8, capacity_factor=1.25,
               attn_impl="fast")
MOE_STEPS = 4
# (c) one MoE FFN layer's fp32 card gradients against float64, and the
# band of |z| / sum |x_i w_i| inside which fp32 may flip relu's mask: 5x
# sqrt(1024) * 2^-24, a 1024-term dot product's typical rounding
MOE_GRAD_TOL = 1e-4
MOE_KINK_BAND = 1e-5
# (d) the sp engine's first loss against phase 26's, relative
SP_STEP0_TOL = 1e-5
# (e) the pipeline's microbatches of the flagship batch
PIPE_MICRO = 4
PIPE_TOL = 1e-5

TRAIN_LAUNCHES_PER_STEP.update({
    # 27c: a step is one flash forward and one fused backward a layer,
    # two layer norms a layer each way plus the head's, the loss; the MoE
    # FFN, the router and FusedAdam's step_flat are cuBLAS / eager PyTorch
    "moe_ep": dict({k: 0 for k in ALL_KERNELS}, flash_fwd=24, flash_bwd=24,
                   ln_fwd=49, ln_bwd=49, xent_fwd=1),
    # 27d: the sequence core replaces attention: no flash; the embedding's,
    # two a layer and the head's layer norms each way, the loss
    "sp_ring": dict({k: 0 for k in ALL_KERNELS}, ln_fwd=50, ln_bwd=50,
                    xent_fwd=1),
    "sp_ulysses": dict({k: 0 for k in ALL_KERNELS}, ln_fwd=50, ln_bwd=50,
                       xent_fwd=1),
})


def _plain_attention(q, k, v, causal):
    import torch
    s = (q @ k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    if causal:
        S = s.shape[-1]
        keep = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _fwd_bwd(fn, q, k, v, cot):
    """(out, dq, dk, dv) of sum(fn(q, k, v) * cot)."""
    import torch
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    dq, dk, dv = torch.autograd.grad((out.float() * cot.float()).sum(),
                                     (q, k, v))
    return out.detach(), dq, dk, dv


def check_seq_ops(dev, card):
    """27a: Ulysses-flash bit-equal to the flash kernels called directly
    at (1, 16, 4096, 64) bf16; ring and Ulysses against plain attention at
    (2, 16, 2048, 64) fp32 under the peak rule.  Returns (timing rows,
    the Ulysses-flash calls' launches)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn.flash import (
        _resolve_fuse, flash_attention)
    from apex_tpu_torch.parallel import (ring_attention, ulysses_attention,
                                         ulysses_flash_attention)
    from apex_tpu_torch.utils import build
    gen = torch.Generator().manual_seed(27)
    B, H, S, D = SEQ_FLASH_SHAPE
    q, k, v, cot = (torch.randn(SEQ_FLASH_SHAPE, generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    fused = _resolve_fuse(None, B * H, S, S, D)
    bwd = "flash_bwd" if fused else "flash_bwd_dq"
    scale = D ** -0.5

    def direct(q, k, v, causal):
        out = flash_attention(
            (q * scale).reshape(B * H, S, D), k.reshape(B * H, S, D),
            v.reshape(B * H, S, D),
            torch.zeros((1, 1, S), dtype=torch.float32, device=dev),
            causal=causal, heads=H)
        return out.reshape(B, H, S, D)

    rows, uf_launches = [], {}
    for causal in (False, True):
        build.LAUNCHES.clear()
        got = _fwd_bwd(lambda q, k, v: ulysses_flash_attention(
            q, k, v, axis_name=None, causal=causal), q, k, v, cot)
        torch.cuda.synchronize()
        seen = dict(build.LAUNCHES)
        for name, n in seen.items():
            uf_launches[name] = uf_launches.get(name, 0) + n
        want = {"flash_fwd": 1, bwd: 1}
        if not fused:
            want["flash_bwd_dkv"] = 1
        require(seen == want, f"ulysses-flash causal={causal}: launches "
                f"{seen}, expected {want}")
        ref = _fwd_bwd(lambda q, k, v: direct(q, k, v, causal), q, k, v,
                       cot)
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            require(torch.equal(a, b), f"ulysses-flash causal={causal}: "
                    f"{name} is not the direct flash call's bits (max diff "
                    f"{(a.float() - b.float()).abs().max().item():.3g})")
        u_ms = time_ms(lambda: _fwd_bwd(lambda q, k, v:
                                         ulysses_flash_attention(
                                             q, k, v, axis_name=None,
                                             causal=causal), q, k, v, cot),
                       reps=10, warmup=2)
        d_ms = time_ms(lambda: _fwd_bwd(lambda q, k, v: direct(
            q, k, v, causal), q, k, v, cot), reps=10, warmup=2)
        log(f"  [{card}] ulysses-flash {SEQ_FLASH_SHAPE} bf16 causal="
            f"{causal}: out, dq, dk, dv bit-equal to the direct flash call;"
            f" launches {seen} ({'fused' if fused else 'split'} backward); "
            f"fwd+bwd {u_ms:.2f} ms vs direct {d_ms:.2f} ms (CUDA events, "
            "median of 10)")
        rows.append(dict(case=f"ulysses_flash_causal{int(causal)}",
                         ms=u_ms, direct_ms=d_ms))
    del q, k, v, cot
    gen = torch.Generator().manual_seed(28)
    q, k, v, cot = (torch.randn(SEQ_PLAIN_SHAPE, generator=gen).to(dev)
                    for _ in range(4))
    for causal in (False, True):
        ref = _fwd_bwd(lambda q, k, v: _plain_attention(q, k, v, causal),
                       q, k, v, cot)
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            build.LAUNCHES.clear()
            got = _fwd_bwd(lambda q, k, v: fn(q, k, v, axis_name=None,
                                              causal=causal), q, k, v, cot)
            torch.cuda.synchronize()
            require(not build.LAUNCHES, f"{name}: launched "
                    f"{dict(build.LAUNCHES)}")
            errs = []
            for part, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
                ok, err = peak_ok(a, b, SEQ_PLAIN_TOL)
                require(ok, f"{name} causal={causal}: {part} err {err:.3g} "
                        f"(peak rule, tol {SEQ_PLAIN_TOL})")
                errs.append(err)
            ms = time_ms(lambda: _fwd_bwd(lambda q, k, v: fn(
                q, k, v, axis_name=None, causal=causal), q, k, v, cot),
                reps=10, warmup=2)
            log(f"  [{card}] {name} {SEQ_PLAIN_SHAPE} fp32 causal={causal}:"
                f" out/dq/dk/dv max err {[f'{e:.3g}' for e in errs]} vs "
                f"plain attention (peak rule, tol {SEQ_PLAIN_TOL}); fwd+bwd "
                f"{ms:.2f} ms (CUDA events, median of 10)")
            rows.append(dict(case=f"{name}_causal{int(causal)}", ms=ms,
                             max_abs_err=max(errs)))
    del q, k, v, cot, ref, got
    torch.cuda.empty_cache()
    return rows, uf_launches


def check_seq_mha(dev, card):
    """27b: SelfMultiheadAttn impl="ulysses" (flash inner) and "ring",
    causal, at the MHA stack's tokens, held to impl="default" under the
    causal time mask (phase 20d's 2e-3 peak rule).  Returns the Ulysses
    module's launches."""
    import torch
    from apex_tpu_torch.utils import build
    batch = _mha_batch("self", MHA_SEQS, torch.float32, dev, 10, "causal")
    ref_out, ref_g = _mha_grads(_mha_stack("self", 1, dev, 9, "default"),
                                batch)
    plain = {k: v for k, v in batch.items() if k != "attn_mask"}
    for impl, kw, want in (
            ("ulysses", dict(seq_inner_impl="fast"),
             {"flash_fwd": 1, "flash_bwd": 1}),
            ("ring", {}, {})):
        stack = _mha_stack("self", 1, dev, 9, impl, causal=True,
                           seq_parallel_axis=None, **kw)
        build.LAUNCHES.clear()
        out, g = _mha_grads(stack, plain)
        torch.cuda.synchronize()
        seen = dict(build.LAUNCHES)
        require(seen == want, f"MHA {impl}: launches {seen}, expected "
                f"{want}")
        if impl == "ulysses":
            mha_launches = seen
        ok, err = peak_ok(out, ref_out, 2e-3)
        require(ok, f"MHA {impl} vs default out err {err:.3g}")
        g_err = 0.0
        for n in ref_g:
            g_ok, e = peak_ok(g[n], ref_g[n], 2e-3)
            g_err = max(g_err, e)
            require(g_ok, f"MHA {impl} vs default grad {n} err {e:.3g}")
        log(f"  [{card}] SelfMultiheadAttn(1024, 16, impl={impl!r}"
            f"{', seq_inner_impl=fast' if kw else ''}, causal=True), "
            f"{MHA_SQ} x {MHA_SEQS} tokens: out err {err:.3g}, grads max err "
            f"{g_err:.3g} vs impl='default' + causal time mask (tol 2e-3); "
            f"launches {seen}")
    torch.cuda.empty_cache()
    return mha_launches


def _plain_switch_ffn(x, router, w_in, w_out, expert, capacity):
    """A top-1 switch FFN written apart from the port's one-hot products:
    each expert gathers its queue (the first ``capacity`` of its tokens in
    order), runs relu(x w_in) w_out and scales it by the chosen softmax
    probability; a token past capacity gets 0.  ``expert`` (T,) is the
    routing decision.  Returns (out, the load-balancing aux loss)."""
    import torch
    T, E = x.shape[0], router.shape[1]
    probs = torch.softmax(x @ router, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    out = torch.zeros_like(x)
    for e in range(E):
        idx = torch.nonzero(expert == e)[:, 0][:capacity]
        y = torch.relu(x[idx] @ w_in[e]) @ w_out[e]
        out = out.index_put((idx,), y * gate[idx, None])
    frac = torch.bincount(expert, minlength=E).to(x.dtype) / T
    return out, E * (frac * probs.mean(dim=0)).sum()


def _relu_kink_allowance(x, w_in, w_out, expert, cot, gate, capacity):
    """float64 bounds on what relu's kink may move in an fp32 run's dx and
    w_in gradients: where a pre-activation z lies within MOE_KINK_BAND of
    the scale of its products (sum |x_i w_i|), fp32 rounding may give it
    the other sign, so its derivative mask may flip, adding or dropping
    |dL/dh| |w_in| in dx and |x| |dL/dh| in dw_in.  Returns (dx bound,
    dw_in bound, ambiguous elements)."""
    import torch
    dx, dw_in, n_amb = torch.zeros_like(x), torch.zeros_like(w_in), 0
    for e in range(w_in.shape[0]):
        idx = torch.nonzero(expert == e)[:, 0][:capacity]
        xe = x[idx]
        amb = (xe @ w_in[e]).abs() <= MOE_KINK_BAND * (xe.abs()
                                                       @ w_in[e].abs())
        d_h = ((cot[idx] * gate[idx, None]) @ w_out[e].T).abs() * amb
        dx[idx] = d_h @ w_in[e].abs().T
        dw_in[e] = xe.abs().T @ d_h
        n_amb += int(amb.sum())
    return dx, dw_in, n_amb


def check_moe_layer_grads(dev, card, lyr, cfg):
    """27c: one MoE layer's FFN (``moe_ffn`` with the step's trained
    layer-0 weights, fp32 on the card) against :func:`_plain_switch_ffn`
    in float64, on the step's token count: output, aux loss and the
    gradients of sum(out * cot) + T aux (the token count T weighs the
    aux term's router gradient to the gate's order) in x, the router,
    w_in and w_out, each element within MOE_GRAD_TOL of its float64 peak.  dx and dw_in
    may also carry what relu's kink moves at the pre-activations fp32 can
    put on its other side (:func:`_relu_kink_allowance`); the others are
    continuous there.  The routing decision is the fp32 logits' argmax in
    both, so a near-tie cannot split them."""
    import torch
    from apex_tpu_torch.parallel import moe_ffn
    T = FLAGSHIP_BATCH[0] * FLAGSHIP_BATCH[1]
    gen = torch.Generator().manual_seed(30)
    x, cot = (torch.randn(T, cfg.d_model, generator=gen).to(dev)
              for _ in range(2))
    names = ("router", "w_in", "w_out")
    expert = torch.softmax(x @ lyr["router"].float(), dim=-1).argmax(-1)
    capacity = max(int(cfg.capacity_factor * T / cfg.num_experts), 1)

    def run(fn, dtype):
        ins = [x.to(dtype).requires_grad_(True)] + [
            lyr[n].detach().to(dtype).requires_grad_(True) for n in names]
        out, aux = fn(*ins)
        g = torch.autograd.grad((out * cot.to(dtype)).sum() + T * aux, ins)
        return [out.detach(), aux.detach()] + list(g)

    got = run(lambda *a: moe_ffn(*a, axis_name=None,
                                 capacity_factor=cfg.capacity_factor),
              torch.float32)
    want = run(lambda *a: _plain_switch_ffn(*a, expert, capacity),
               torch.float64)
    x64, r64, wi64, wo64 = (t.detach().double() for t in
                            [x] + [lyr[n] for n in names])
    gate = torch.softmax(x64 @ r64, dim=-1).gather(1, expert[:, None])[:, 0]
    kink_dx, kink_dw_in, n_amb = _relu_kink_allowance(
        x64, wi64, wo64, expert, cot.double(), gate, capacity)
    kinks = {"dx": kink_dx, "dw_in": kink_dw_in}
    errs, used = {}, {}
    for part, a, b in zip(("out", "aux", "dx") + tuple(f"d{n}" for n in
                                                       names), got, want):
        diff = (a.double() - b).abs()
        peak = float(b.abs().max())
        allow = MOE_GRAD_TOL * peak + kinks.get(part, 0.0)
        worst = float((diff - allow).max())
        require(worst <= 0, f"MoE layer {part}: err {float(diff.max()):.3g}"
                f" passes its allowance by {worst:.3g} (tol {MOE_GRAD_TOL} "
                f"of the float64 peak {peak:.3g}, plus the kink bound)")
        errs[part] = float(diff.max()) / peak
        used[part] = int((diff > MOE_GRAD_TOL * peak).sum())
    over = int((torch.bincount(expert, minlength=cfg.num_experts)
                - capacity).clamp(min=0).sum())
    log(f"  [{card}] MoE layer 0 FFN, {T} tokens (capacity {capacity}, "
        f"{over} past it), fp32 vs a float64 gather-based switch FFN: max "
        f"err of the peak {({k: f'{v:.3g}' for k, v in errs.items()})} "
        f"(tol {MOE_GRAD_TOL}); {n_amb} pre-activations within the kink "
        f"band {MOE_KINK_BAND}, elements past the tol inside their kink "
        f"bound {used}")
    RESULTS["moe_layer_grad_errs"] = errs
    del got, want, kinks, kink_dx, kink_dw_in
    torch.cuda.empty_cache()


def phase_moe(dev, card):
    """27c: the switch-MoE step at full width through the ep engine at
    world 1 (the dp-MoE twin)."""
    import torch
    from apex_tpu_torch.models import (MoETransformerConfig,
                                       moe_transformer_apply)
    from apex_tpu_torch.parallel import Plan, create_mesh, spmd
    from apex_tpu_torch.utils import build
    from apex_tpu_torch.utils.pytree import tree_leaves
    # remat stays off: the step peaks under the 75 GB it would be turned
    # on past (PERF.md section 4)
    cfg = MoETransformerConfig(**MOE_CFG)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = create_mesh({"data": 1})
    t0 = time.perf_counter()
    carry, step, info = spmd._build_ep_step(
        cfg, mesh, Plan(dp=1), FLAGSHIP_BATCH[0], FLAGSHIP_LR, True, None, 0,
        dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(carry[0]))
    n_expert = sum(l[k].numel() for l in carry[0]["layers"]
                   for k in ("w_in", "w_out"))
    # one batch every step, as the JAX engine tests train each family;
    # check_moe_layer_grads below holds the step's gradients apart from
    # the loss's fall (PERF.md section 4)
    toks = _flagship_tokens(cfg, dev, 1)[0]
    carry, loss = step(carry, toks)
    losses = [loss.item()]
    build.LAUNCHES.clear()
    times = []
    for _ in range(MOE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, loss = step(carry, toks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(loss.item())
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the forward and backward alone (no update): where the peak sits
    torch.cuda.reset_peak_memory_stats()
    step.grads_of(carry[0], toks)
    grads_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, aux = moe_transformer_apply(carry[0], toks, cfg)
    aux = aux.item()
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"MoE: losses {losses} not finite and falling")
    require(np.isfinite(aux), f"MoE: aux loss {aux}")
    check_launches("moe_ep", launches, MOE_STEPS, exact=True)
    check_moe_layer_grads(dev, card, carry[0]["layers"][0], cfg)
    ms = statistics.median(times) * 1e3
    tok_s = FLAGSHIP_BATCH[0] * FLAGSHIP_BATCH[1] / ms * 1e3
    RESULTS.update(moe_step_ms=ms, moe_tokens_per_s=tok_s,
                   moe_peak_gib=peak / 2 ** 30,
                   moe_grads_peak_gib=grads_peak / 2 ** 30)
    log(f"  [{card}] MoE {n_params} parameters ({n_expert} in the experts),"
        f" fp32, remat off, batch {FLAGSHIP_BATCH[0]} x "
        f"{FLAGSHIP_BATCH[1]}, FusedAdam(lr={FLAGSHIP_LR}, impl='fused'): "
        f"step {ms:.2f} ms (median of {MOE_STEPS}; all "
        f"{[round(t * 1e3, 2) for t in times]}), {tok_s:.0f} tokens/s, "
        f"peak {peak / 2 ** 30:.2f} GiB allocated (the forward and "
        f"backward alone {grads_peak / 2 ** 30:.2f}), build {init_s:.1f} s; "
        f"losses {[round(l, 6) for l in losses]}, aux {aux:.6f}; launches "
        f"a step {({k: v // MOE_STEPS for k, v in launches.items()})}; "
        f"engine {info['engine']}, experts {info['experts']}")
    del carry, step
    torch.cuda.empty_cache()
    return launches


def phase_sp_engine(dev, card):
    """27d: the sp engine at world 1 at the flagship's width, ring and
    Ulysses, held to phase 26's off flagship step from the same weights."""
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.parallel import Plan, create_mesh, spmd
    from apex_tpu_torch.utils import build
    cfg = bert_large_config(attn_impl="fast")
    ref = RESULTS["flagship_off_losses"]
    toks = _flagship_tokens(cfg, dev, 3)
    mesh = create_mesh({"data": 1, "seq": 1})
    launches = {}
    for strategy in ("ring", "ulysses"):
        torch.cuda.empty_cache()
        params0 = transformer_init(cfg, torch.Generator().manual_seed(0),
                                   device=dev)
        carry, step, info = spmd._build_sp_step(
            cfg, mesh, Plan(dp=1, sp_strategy=strategy), FLAGSHIP_BATCH[0],
            FLAGSHIP_LR, True, params0, 0, dev)
        carry, loss = step(carry, toks[0])
        losses = [loss.item()]
        build.LAUNCHES.clear()
        times = []
        for t in toks[1:]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            carry, loss = step(carry, t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(loss.item())
        path = f"sp_{strategy}"
        launches[path] = dict(build.LAUNCHES)
        check_launches(path, launches[path], 2, exact=True)
        # step 0 is one forward from the same weights: only the attention
        # core's order of operations differs
        require(abs(losses[0] - ref[0]) <= SP_STEP0_TOL * abs(ref[0]),
                f"sp {strategy} step 0: loss {losses[0]} vs the flagship "
                f"step's {ref[0]} (tol {SP_STEP0_TOL} relative)")
        for i, (a, b) in enumerate(zip(losses, ref)):
            require(abs(a - b) <= max(2e-2 * abs(b), 5e-3),
                    f"sp {strategy} step {i}: loss {a} vs the flagship "
                    f"step's {b}")
        ms = statistics.median(times) * 1e3
        RESULTS[f"sp_{strategy}_ms"] = ms
        log(f"  [{card}] sp {strategy} (engine {info['engine']}): step "
            f"{ms:.2f} ms (median of 2; all "
            f"{[round(t * 1e3, 2) for t in times]}); losses "
            f"{[round(l, 6) for l in losses]} vs phase 26 off "
            f"{[round(l, 6) for l in ref[:3]]} (step 0 tol {SP_STEP0_TOL} "
            f"relative, then 2e-2 relative or 5e-3); wire {info['sp_wire']['logical_bytes']} B a step "
            "(static schedule)")
        del carry, step, params0
    torch.cuda.empty_cache()
    return launches


def check_pipeline_s1(dev, card):
    """27e: pipeline_apply with the flagship's 24 layers as one stage
    over 4 microbatches of the 8 x 512 batch, against the plain stack."""
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.models.transformer import block, embed
    from apex_tpu_torch.parallel import create_mesh, pipeline_apply
    cfg = bert_large_config(attn_impl="fast")
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    mesh = create_mesh({"pipe": 1})
    toks = _flagship_tokens(cfg, dev, 1)[0]
    B, S = FLAGSHIP_BATCH
    with torch.no_grad():
        x = embed(params, toks, params["embed"]["pos"][:S][None], cfg)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(29)
                      ).to(dev)
    names = sorted(params["layers"])

    def stage_fn(lp, h):
        for i in range(cfg.num_layers):
            h = block(h, {k: v[i] for k, v in lp.items()}, cfg)
        return h

    def run(pipe):
        lp = {k: params["layers"][k].detach().requires_grad_(True)
              for k in names}
        if pipe:
            out = pipeline_apply(stage_fn, lp, x.reshape(
                PIPE_MICRO, B // PIPE_MICRO, S, cfg.d_model),
                axis_name=mesh.group("pipe")).reshape(x.shape)
        else:
            out = stage_fn(lp, x)
        grads = torch.autograd.grad((out * cot).sum(), [lp[k] for k in
                                                        names])
        return out.detach(), dict(zip(names, grads))

    ms_pipe = time_ms(lambda: run(True), reps=1, warmup=0)
    p_out, p_g = run(True)
    r_out, r_g = run(False)
    worst = float((p_out - r_out).abs().max() / r_out.abs().max())
    require(worst <= PIPE_TOL, f"pipeline S=1 output err {worst:.3g} of the "
            f"peak (tol {PIPE_TOL})")
    g_worst = 0.0
    for k in names:
        e = float((p_g[k] - r_g[k]).abs().max() / r_g[k].abs().max())
        g_worst = max(g_worst, e)
        require(e <= PIPE_TOL, f"pipeline S=1 grad {k} err {e:.3g} of the "
                f"peak (tol {PIPE_TOL})")
    log(f"  [{card}] pipeline_apply S=1, {cfg.num_layers} layers, M="
        f"{PIPE_MICRO} of {B} x {S}: output err {worst:.3g}, layer grads max"
        f" err {g_worst:.3g} of their peaks vs the plain stack (tol "
        f"{PIPE_TOL}); fwd+bwd {ms_pipe:.1f} ms (CUDA events, one run)")
    del params, p_out, p_g, r_out, r_g
    torch.cuda.empty_cache()


def phase_parallel(dev, card):
    """Phase 27 (after 26, before 20): (a)-(e) on a world-1 NCCL group,
    destroyed before it returns.  Returns its paths' launch counts."""
    import torch.distributed as dist
    log("== phase 27: sequence / pipeline / expert parallelism, the MoE step"
        " and the sp engine (world-1 NCCL: a collective is a copy; paths, "
        "launches and numbers, not wire time)")
    store = start_process_group()
    launches = {}
    try:
        log("  -- 27a: Ulysses-flash at 4096 tokens, ring and Ulysses vs "
            "plain attention")
        RESULTS["seq_rows"], launches["ulysses_flash"] = check_seq_ops(
            dev, card)
        log("  -- 27b: SelfMultiheadAttn impl='ulysses' / 'ring'")
        launches["mha_ulysses"] = check_seq_mha(dev, card)
        log("  -- 27c: the switch-MoE step at full width (ep engine, world "
            "1)")
        launches["moe_ep"] = phase_moe(dev, card)
        log("  -- 27d: the sp engine at the flagship's width, ring and "
            "Ulysses")
        launches.update(phase_sp_engine(dev, card))
        log("  -- 27e: pipeline_apply at S=1 over the flagship's layers")
        check_pipeline_s1(dev, card)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return launches


# ---------------------------------------------------------------------------
# phase 28: the tensor-parallel family and the planner at world 1
# ---------------------------------------------------------------------------

TP_STEPS = 4
TP_STEP0_TOL = 1e-5
TP_PLAN_CHIPS = (1, 4, 8)


def phase_tp_train(dev, card):
    """28a: ``_build_tp_step`` with a model axis of 1 at the
    flagship's width, on phase 26's batches, fp32 then the bf16 model
    copy."""
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.parallel import Plan, create_mesh, spmd
    from apex_tpu_torch.utils import build
    cfg = bert_large_config(attn_impl="fast")
    ref = RESULTS["flagship_off_losses"]
    toks = _flagship_tokens(cfg, dev, 1 + TP_STEPS)
    mesh = create_mesh({"data": 1, "model": 1})
    launches = {}
    for amp in (None, "bfloat16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params0 = transformer_init(cfg, torch.Generator().manual_seed(0),
                                   device=dev)
        t0 = time.perf_counter()
        carry, step, info = spmd._build_tp_step(
            cfg, mesh, Plan(dp=1), FLAGSHIP_BATCH[0], FLAGSHIP_LR, True,
            params0, 0, dev, amp_dtype=amp)
        del params0
        build_s = time.perf_counter() - t0
        carry, loss = step(carry, toks[0])
        losses = [loss.item()]
        build.LAUNCHES.clear()
        times = []
        for t in toks[1:]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            carry, loss = step(carry, t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(loss.item())
        path = "tp_train" if amp is None else "tp_train_bf16"
        launches[path] = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(path, launches[path], TP_STEPS, exact=True)
        require(step.cfg.attn_impl == "default"
                and step.cfg.xent_impl == "xla",
                f"tp engine ran attn {step.cfg.attn_impl}, xent "
                f"{step.cfg.xent_impl}")
        tape = info["collectives"]["all-reduce"]
        require(tape == info["metered"]["all-reduce"]
                and tape["logical_bytes"] == info["tp_wire"]["logical_bytes"]
                and tape["count"] == info["tp_wire"]["count"],
                f"tp tape {tape} vs the schedule {info['tp_wire']}")
        master = carry[1].master
        require(master.dtype == torch.float32,
                f"tp {path}: master {master.dtype}")
        require(all(np.isfinite(losses)), f"tp {path}: losses {losses}")
        if amp is None:
            require(abs(losses[0] - ref[0]) <= TP_STEP0_TOL * abs(ref[0]),
                    f"tp step 0: loss {losses[0]} vs phase 26 off's "
                    f"{ref[0]} (tol {TP_STEP0_TOL} relative)")
            for i, (a, b) in enumerate(zip(losses, ref)):
                require(abs(a - b) <= max(2e-2 * abs(b), 5e-3),
                        f"tp step {i}: loss {a} vs phase 26 off's {b}")
            cmp = (f" vs phase 26 off {[round(l, 6) for l in ref]} (step 0 "
                   f"tol {TP_STEP0_TOL} relative, then 2e-2 relative or "
                   "5e-3)")
        else:
            require(losses[-1] < losses[0],
                    f"tp bf16 model copy: losses {losses} not falling")
            cmp = " (finite and falling; master fp32)"
        ms = statistics.median(times) * 1e3
        tok_s = FLAGSHIP_BATCH[0] * FLAGSHIP_BATCH[1] / ms * 1e3
        RESULTS[f"{path}_ms"] = ms
        RESULTS[f"{path}_peak_bytes"] = peak
        log(f"  [{card}] tp engine ({info['engine']}, model axis 1, "
            f"amp_dtype {info['amp_dtype']}): step {ms:.2f} ms (median of "
            f"{TP_STEPS}; all {[round(t * 1e3, 2) for t in times]}), "
            f"{tok_s:.0f} tokens/s, peak {peak / 2 ** 30:.2f} GiB allocated,"
            f" build {build_s:.1f} s; losses {[round(l, 6) for l in losses]}"
            f"{cmp}; all-reduce tape {tape['count']} calls, "
            f"{tape['logical_bytes']} B a step (copies at world 1; the "
            f"layers' {info['tp_wire']['parts']['layers']} B = 4 L blocks);"
            f" launches a step "
            f"{({k: v // TP_STEPS for k, v in launches[path].items()})}")
        del carry, step
    torch.cuda.empty_cache()
    return launches


def phase_tp_serve(dev, card, serve_launches):
    """28b: phase 5's engine and trace through ``InferenceEngine(mesh=)``
    with a model axis of 1: the tokens of phase 5, its launches, and the
    plain engine's logits bit for bit."""
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.parallel import create_mesh
    from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                      InferenceEngine, Request)
    from apex_tpu_torch.telemetry.serve_ledger import serve_violations
    from apex_tpu_torch.utils import build
    cfg = bert_large_config(causal=True, attn_impl="fast")
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    cache = CacheConfig(page_size=16, num_pages=257, max_ctx=512)
    mesh = create_mesh({"data": 1, "model": 1})
    eng = InferenceEngine(params, cfg, cache=cache, olevel="bf16",
                          decode_width=8, device=dev, mesh=mesh)
    require(eng.tp_group is not None
            and eng.k_pool.shape[3] == cfg.num_heads,
            f"tp engine pools {tuple(eng.k_pool.shape)}")
    warm = ContinuousBatcher(eng)
    for i in range(2):
        warm.submit(Request(rid=f"w{i}", prompt=[5 + i] * (40 + i),
                            max_new_tokens=4, seed=100 + i))
    warm.run()
    bat = ContinuousBatcher(eng)
    for r in _trace(cfg):
        bat.submit(r)
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    doc = bat.ledger.snapshot(olevel="bf16", decode_width=8)
    require(not serve_violations(doc), "tp serve ledger violations")
    got = {rid: list(r.tokens) for rid, r in results.items()}
    require(got == RESULTS["serve_tokens"],
            "tp engine's tokens differ from phase 5's: "
            f"{[k for k in got if got[k] != RESULTS['serve_tokens'].get(k)]}")
    for k in ALL_KERNELS:
        require(launches.get(k, 0) == serve_launches.get(k, 0),
                f"tp serving launched {k} {launches.get(k, 0)} times, phase "
                f"5 {serve_launches.get(k, 0)}")
    del warm, bat
    # the logits: the plain engine and the tp one on the same inputs
    plain = InferenceEngine(params, cfg, cache=cache, olevel="bf16",
                            decode_width=8, device=dev)
    del params
    S, PPR = cache.max_ctx, cache.pages_per_request
    tokens = np.zeros(S, np.int64)
    tokens[:448] = np.arange(448) % (cfg.vocab_size - 1) + 1
    # each slot its own pages (slots sharing a page write it in no fixed
    # order once their sampled tokens differ), each prefilled
    tables = np.arange(1, 8 * PPR + 1).reshape(8, PPR)
    temps = np.where(np.arange(8) % 2, 0.8, 0.0).astype(np.float32)
    topks = np.where(np.arange(8) % 2, 8, 0)
    outs = []
    for e in (plain, eng):
        steps = [(int(f), l) for f, l in (
            e.prefill(tokens, 448, tables[w], w) for w in range(8))]
        cur = np.array([t for t, _ in steps])
        pos = np.full(8, 448)
        for _ in range(3):
            tok, lg = e.decode_step(cur, pos, tables, np.arange(8), temps,
                                    topks)
            steps.append((tok.cpu().tolist(), lg))
            cur, pos = tok.cpu().numpy(), pos + 1
        outs.append(steps)
    same = all(a[0] == b[0] and torch.equal(a[1], b[1])
               for a, b in zip(*outs))
    require(same, "tp engine at model axis 1: tokens or logits not the "
            "plain engine's bits")
    lat = doc["latency_ms"]
    log(f"  [{card}] tp serving (model axis 1, bf16): {len(got)} requests, "
        f"tokens = phase 5's; tokens/s {doc['tokens_per_sec']} (phase 5 "
        f"{RESULTS.get('serve_tokens_per_sec')}), TTFT p50 "
        f"{lat['ttft_p50']} ms, p99 {lat['p99']} ms, trace wall {wall:.3f} "
        f"s; launches {launches} = phase 5's; 8 448-token prefills and 3 "
        "decode steps (8 slots, half sampled): tokens and logits bit-equal "
        "to the plain engine's")
    RESULTS["tp_serve_tokens_per_sec"] = doc["tokens_per_sec"]
    del eng, plain
    torch.cuda.empty_cache()
    return launches


def phase_planner(dev, card):
    """28c: the cost model on the card: the BERT-large profile at global
    batch 8 (h100 row), the ranked plans for 1, 4 and 8 chips, and
    Plan(dp=1)'s prediction beside the measured flagship step."""
    import torch
    from apex_tpu_torch.parallel import plan as P
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prof, cfg, gb = P.flagship_profile(device=dev)
    prof_s = time.perf_counter() - t0
    RESULTS["flagship_profile"] = prof      # phase 29's re-plans
    require(prof.platform == "h100" or "H100" not in card,
            f"profile platform {prof.platform} on {card}")
    log(f"  profiled {prof.name} (global batch {gb}, seq {cfg.max_len}, "
        f"attn {cfg.attn_impl}) on {prof.platform} in {prof_s:.1f} s: "
        f"{prof.flops / 1e12:.3f} TFLOP, {prof.bytes_accessed / 1e9:.1f} GB "
        f"a step, peak {prof.peak_hbm_bytes / 2 ** 30:.2f} GiB (the sweep)")
    for chips in TP_PLAN_CHIPS:
        ranked = P.search(prof, chips)
        require(ranked, f"no feasible plan at {chips} chips")
        for line in P.format_plans(ranked, chips=chips, top=6).splitlines():
            log("    " + line)
    p1 = P.predict(prof, P.Plan(dp=1))
    meas_ms = RESULTS["flagship_off_ms"]
    tp_ms = RESULTS["tp_train_ms"]
    tp_peak = RESULTS["tp_train_peak_bytes"]
    require(np.isfinite(p1.predicted_step_ms) and p1.predicted_step_ms > 0
            and p1.predicted_hbm_bytes > 0,
            f"Plan(dp=1) prediction {p1.predicted_step_ms} ms, "
            f"{p1.predicted_hbm_bytes} B")
    RESULTS["plan_dp1_predicted_ms"] = p1.predicted_step_ms
    RESULTS["plan_dp1_predicted_hbm"] = p1.predicted_hbm_bytes
    log(f"  [{card}] Plan(dp=1): predicted {p1.predicted_step_ms:.3f} ms "
        f"(train {p1.breakdown['train_ms']:.3f}, update "
        f"{p1.breakdown['update_ms']:.3f}) against phase 26 off's measured "
        f"{meas_ms:.2f} ms (flash attention; x"
        f"{meas_ms / p1.predicted_step_ms:.2f}) and 28a's {tp_ms:.2f} ms "
        f"(the profiled configuration: plain attention; x"
        f"{tp_ms / p1.predicted_step_ms:.2f}); predicted HBM "
        f"{p1.predicted_hbm_bytes / 2 ** 30:.2f} GiB against 28a's measured "
        f"peak {tp_peak / 2 ** 30:.2f} GiB (x"
        f"{tp_peak / p1.predicted_hbm_bytes:.3f})")


def phase_tensor_parallel(dev, card, serve_launches):
    """Phase 28 (after 27, before 20): (a)-(c) on a world-1 NCCL group,
    destroyed before it returns.  Returns its paths' launch counts."""
    import torch.distributed as dist
    log("== phase 28: the tensor-parallel family (model axis 1) and the "
        "planner (world-1 NCCL: a collective is a copy)")
    t0 = time.perf_counter()
    store = start_process_group()
    try:
        log("  -- 28a: the tp engine at the flagship's width, fp32 and the "
            "bf16 model copy")
        launches = phase_tp_train(dev, card)
        log("  -- 28b: phase 5's serving through InferenceEngine(mesh=)")
        launches["tp_serve"] = phase_tp_serve(dev, card, serve_launches)
        log("  -- 28c: the cost model and search on the card")
        phase_planner(dev, card)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    log(f"  phase 28 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 29: elastic resume and the run controller
# ---------------------------------------------------------------------------

ELASTIC_DIR = os.path.join(HERE, "build", "phase29")
#: leg (a): phase 26's flagship step cut to phase 19's depth, zero1 with the
#: int8 error-feedback reduce-scatter (the JAX elastic harness's knobs)
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_PREEMPT = 2, 8, 5
ELASTIC_SCHEME = "int8_blockscale:min_bytes=0"
#: the worlds the step-4 checkpoint is imported from: 8 (the total of world
#: 1, so only the residual collapses) and 7 (another total, so the master
#: and the moments re-chunk; the quarantine's resize)
ELASTIC_FROM_WORLDS = (8, 7)
#: the host round trip's live residual rows (of the 8-way stack)
ROUNDTRIP_LIVE_ROWS = 4
#: leg (b)'s goodput floor: between the clean O5 step's windows (the step
#: and its check are productive, ~1.0) and the degraded ones (a 20 ms sleep
#: beside a step of ~20 ms, ~0.5); the JAX chaos test's 0.5 sits on the
#: degraded value when the step is a real one
CONTROL_FLOOR = 0.9
# the flagship step at 2 layers: phase 26's counts a layer (one flash
# forward and backward, two layer norms each way) plus the embedding's and
# the head's norms and the loss
TRAIN_LAUNCHES_PER_STEP["elastic_flagship"] = dict(
    {k: 0 for k in ALL_KERNELS}, flash_fwd=2, flash_bwd=2, ln_fwd=6,
    ln_bwd=6, xent_fwd=1)
# leg (b): phase 24c's O5 BERT step, exactly
TRAIN_LAUNCHES_PER_STEP["control_o5"] = dict(
    {k: 0 for k in ALL_KERNELS}, **TRAIN_LAUNCHES_PER_STEP["ckpt_o5"])


def _to_world(payload, kinds, layout, world):
    """A world-1 checkpoint payload as an N-way one, by a numpy re-chunk
    written out here (the JAX elastic test's ``_import_canonical`` idiom,
    not the elastic code): each flat-shard field's used prefix padded to
    ``layout["flat_total"]``, the residual stacked to ``world`` rows with
    row 0 holding it."""
    out = []
    for h, kind in zip(payload["leaves"], kinds):
        h = np.asarray(h)
        if kind in ("shard", "stack"):
            v = np.zeros((layout["flat_total"],), h.dtype)
            v[:layout["used"]] = h[:layout["used"]]
            if kind == "stack":
                v = np.concatenate([v[None], np.zeros(
                    (world - 1, v.shape[0]), h.dtype)])
            h = v
        out.append(h)
    return {"step": payload["step"], "leaves": out}


def _elastic_leg(dev, card, profile):
    """29a: the zero1 + int8-EF flagship under the guard, uninterrupted and
    with ``preempt@5``; its step-4 checkpoint as world-8 and world-7
    manifests; each resume at world 1 refused without elastic, resharded
    to 1 with it, and steps 5-8 bitwise the uninterrupted run's."""
    import shutil
    import torch
    import apex_tpu_torch.elastic as elastic
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.parallel import plan as P
    from apex_tpu_torch.resilience import (CheckpointManager, GuardConfig,
                                           TrainGuard,
                                           WorldSizeMismatchError, faults,
                                           guard)
    from apex_tpu_torch.telemetry import events
    from apex_tpu_torch.telemetry.registry import MemorySink, Registry
    from apex_tpu_torch.train import flagship_guard_step
    from apex_tpu_torch.utils import build
    cfg = bert_large_config(num_layers=ELASTIC_LAYERS, attn_impl="fast")
    params0 = transformer_init(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    toks = _flagship_tokens(cfg, dev, ELASTIC_STEPS)

    def run(name, plan=None):
        state, step, layout, shards = flagship_guard_step(
            cfg, ddp_kwargs={"collective_scheme": ELASTIC_SCHEME},
            params=params0, lr=FLAGSHIP_LR, device=dev)
        g = TrainGuard(step, GuardConfig(
            ckpt_dir=os.path.join(ELASTIC_DIR, name), save_every_steps=2,
            check_every=2, enabled=True, world_size=1,
            ckpt_meta={"plan": P.Plan(dp=1).knobs(), "layout": layout}),
            plan=plan, state_shards=shards,
            shard_group=step.weight_update.group)
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        state, rep = g.run(state, lambda i: toks[i], ELASTIC_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(g.host_reads == g.health_checks + rep.checkpoints
                and g.gathers == 0, f"29a {name}: reads {g.host_reads}, "
                f"checks {g.health_checks}, snapshots {rep.checkpoints}, "
                f"gathers {g.gathers}")
        return state, rep, dict(build.LAUNCHES), (step, layout, shards), secs

    st_a, rep_a, launch_a, (step, layout1, shards), secs_a = run("clean")
    require(rep_a.status == "completed", f"29a clean: {rep_a}")
    check_launches("elastic_flagship", launch_a, ELASTIC_STEPS, exact=True)
    _, rep_b, launch_b, _, _ = run("preempt", faults.parse(
        f"preempt@{ELASTIC_PREEMPT}"))
    require(rep_b.status == "preempted"
            and rep_b.final_step == ELASTIC_PREEMPT, f"29a preempt: {rep_b}")
    check_launches("elastic_flagship", launch_b, ELASTIC_PREEMPT, exact=True)

    # the step-4 checkpoint as world-8 and world-7 manifests, re-chunked
    # in numpy: at 2 layers the world-8 total is the world-1 one, so only
    # the 7-way import re-chunks the master and the moments
    ck = ELASTIC_PREEMPT - 1
    payload = checkpoint.load(CheckpointManager(os.path.join(
        ELASTIC_DIR, "preempt")).path_for(ck))
    kinds = guard._leaf_kinds(st_a, shards)
    require(kinds.count("shard") == 3 and kinds.count("stack") == 1,
            f"29a kinds {kinds}")

    def resume(wdir):
        state, step_r, layout, sh = flagship_guard_step(
            cfg, ddp_kwargs={"collective_scheme": ELASTIC_SCHEME},
            params=params0, lr=FLAGSHIP_LR, device=dev)
        g = TrainGuard(step_r, GuardConfig(
            ckpt_dir=wdir, save_every_steps=2, check_every=2,
            enabled=True, world_size=1,
            ckpt_meta={"plan": P.Plan(dp=1).knobs(), "layout": layout}),
            state_shards=sh, shard_group=step_r.weight_update.group)
        build.LAUNCHES.clear()
        state, rep = g.run(state, lambda i: toks[i], ELASTIC_STEPS)
        torch.cuda.synchronize()
        return state, rep, dict(build.LAUNCHES)

    la = guard._leaves(st_a)
    names = ["params"] * (len(la) - 5) + ["count", "m", "v", "master",
                                          "residual"]
    require(bool(la[-1].abs().max() > 0), "29a: the EF residual is zero")
    done, launch_r = [], {}
    for w in ELASTIC_FROM_WORLDS:
        layout_w = step.weight_update.layout_meta(params0, w)
        require(layout_w["used"] == layout1["used"],
                f"29a layouts {layout1} / {layout_w}")
        wdir = os.path.join(ELASTIC_DIR, f"w{w}")
        CheckpointManager(wdir, meta={
            "world_size": w, "plan": P.Plan(dp=w).knobs(),
            "layout": layout_w,
        }).save(ck, _to_world(payload, kinds, layout_w, w))
        try:
            resume(wdir)
            refused = None
        except WorldSizeMismatchError as e:
            refused = e
        require(refused is not None and (refused.saved_world,
                                         refused.live_world) == (w, 1),
                f"29a: the world-{w} manifest at world 1 without elastic "
                f"gave {refused!r}")
        reg = Registry(sink=MemorySink(), flush_interval=0, rank0_only=False)
        prev = events.set_default(reg)
        er = elastic.install(profile=profile)
        try:
            st_r, rep_r, launch_r[w] = resume(wdir)
        finally:
            elastic.uninstall()
            events.set_default(prev)
        ev = {r["name"]: r["fields"] for r in reg.flush()
              if r.get("kind") == "event"}
        require(rep_r.status == "completed" and rep_r.resumed_from == ck
                and rep_r.resharded_from == w,
                f"29a elastic resume from {w}: {rep_r}")
        # the flat fields re-chunk where the totals differ; the residual
        # stack always collapses onto its one live row
        fields = 1 + 3 * (layout_w["flat_total"] != layout1["flat_total"])
        require(er.last_plan is not None and er.last_plan.chips == 1
                and ev["elastic.replan"]["chips"] == 1
                and ev["elastic.reshard"]["fields_resharded"] == fields,
                f"29a replan {er.last_plan}, events {ev}")
        check_launches("elastic_flagship", launch_r[w], ELASTIC_STEPS - ck,
                       exact=True)
        lr_ = guard._leaves(st_r)
        diff = [n for n, x, y in zip(names, la, lr_)
                if x.dtype != y.dtype or not torch.equal(x, y)]
        require(not diff and len(la) == len(lr_),
                f"29a: the {w} -> 1 resume is not the uninterrupted run's "
                f"bits in {diff}")
        done.append((w, layout_w["flat_total"], fields,
                     ev["elastic.reshard"]["seconds"],
                     ev["elastic.replan"]["seconds"],
                     ev["elastic.replan"]["candidates"],
                     er.last_plan.describe()))
        del st_r, lr_
        shutil.rmtree(wdir, ignore_errors=True)
    del payload
    require(any(f == 4 for _, _, f, *_ in done),
            "29a: no import re-chunked the master and the moments")
    RESULTS["elastic_reshard_s"] = {w: r for w, _, _, r, *_ in done}
    RESULTS["elastic_replan_s"] = {w: r for w, _, _, _, r, *_ in done}
    log(f"  (a) [{card}] flagship {ELASTIC_LAYERS} layers, fp32, "
        f"{FLAGSHIP_BATCH[0]} x {FLAGSHIP_BATCH[1]}, zero1 + "
        f"{ELASTIC_SCHEME} EF, a save every 2, a check every 2: "
        f"{ELASTIC_STEPS} steps in {secs_a:.1f} s; preempt@"
        f"{ELASTIC_PREEMPT}; the step-{ck} checkpoint (flat_total "
        f"{layout1['flat_total']}, used {layout1['used']}) as world-w "
        f"manifests, each refused at world 1 without elastic and, with "
        f"elastic.install, resharded w -> 1 and re-planned for 1 chip; "
        + "; ".join(
            f"w {w}: flat_total {tot}, reshard {r:.3f} s ({f} fields), "
            f"replan {q * 1e3:.2f} ms ({c} candidates, winner {d})"
            for w, tot, f, r, q, c, d in done)
        + f"; steps {ck + 1}-{ELASTIC_STEPS} end on the uninterrupted "
        f"run's parameters, moments and residual bit for bit; launches a "
        f"run {launch_a} / {launch_b} / {launch_r}")
    del st_a, params0
    return launch_a


def _reshard_roundtrip(card):
    """29a, on the host: the canonical flat of the 24-layer flagship
    (``FLAT_N``, the JAX flagship's count) 8 -> 4 -> 8 and 8 -> 7 -> 8
    through ``reshard_payload``: master, two moments and the residual
    stack, bitwise.  The totals at 8 and 4 agree, so the first round trip
    passes the fields through; the total at 7 differs, so the second
    re-chunks them."""
    import torch
    import apex_tpu_torch.elastic as elastic
    from apex_tpu_torch.multi_tensor_apply.flattener import LANE
    used = FLAT_N
    tot = {w: -(-used // (LANE * w)) * LANE * w for w in (8, 7, 4)}
    rng = np.random.default_rng(29)

    def fill(out):
        # a fresh random 4 MB block tiled over the used prefix (drawing all
        # 334 M values would cost seconds of the phase's time)
        out[:used] = np.resize(rng.random(1 << 20, dtype=np.float32), used)
    fields = [np.zeros((tot[8],), np.float32) for _ in range(3)]
    res = np.zeros((8, tot[8]), np.float32)
    for a in fields + [res[r] for r in range(ROUNDTRIP_LIVE_ROWS)]:
        fill(a)
    # the collapse, written out here: the live rows summed in order (the
    # zero rows add +0.0 to non-negative sums, which changes no bit)
    want = np.zeros((used,), np.float32)
    for r in range(ROUNDTRIP_LIVE_ROWS):
        want = want + res[r, :used]

    def meta(w):
        return {"world_size": w,
                "layout": {"flat_total": tot[w], "used": used}}

    def tmpl(w):
        return [torch.empty((tot[w],), device="meta") for _ in range(3)] \
            + [torch.empty((w, tot[w]), device="meta")]

    def collapsed(r, w):
        return (r.shape == (w, tot[w]) and np.array_equal(r[0, :used], want)
                and not np.any(r[0, used:]) and not np.any(r[1:]))

    def hop(payload, a, b):
        """One reshard a -> b, timed, with the bytes it reads and writes:
        the residual stacks, and the fields where the totals differ."""
        t0 = time.perf_counter()
        out = elastic.reshard_payload(tmpl(b), payload, meta(a), b,
                                      emit=lambda *x, **k: None)
        secs = time.perf_counter() - t0
        moved = payload["leaves"][3].nbytes + out["leaves"][3].nbytes
        if tot[a] != tot[b]:
            moved += sum(x.nbytes for x in payload["leaves"][:3]) + sum(
                x.nbytes for x in out["leaves"][:3])
        return out, secs, moved / secs / 1e9

    start = {"step": 0, "leaves": fields + [res]}
    rows = []
    for mid_w in (4, 7):
        mid, s1, gb1 = hop(start, 8, mid_w)
        back, s2, gb2 = hop(mid, mid_w, 8)
        ok_fields = all(np.array_equal(a, b) for a, b in zip(
            fields, back["leaves"][:3]))
        ok_res = (collapsed(mid["leaves"][3], mid_w)
                  and collapsed(back["leaves"][3], 8))
        require(ok_fields and ok_res, f"29a round trip 8 -> {mid_w} -> 8: "
                f"fields bitwise {ok_fields}, residual collapse bitwise "
                f"{ok_res}")
        rows.append((mid_w, s1, gb1, s2, gb2))
        del mid, back
    RESULTS["roundtrip"] = rows
    log(f"  (a) host round trips of the flagship's canonical flat ({used} "
        f"elements; totals {tot[8]} at 8, {tot[7]} at 7, {tot[4]} at 4): "
        f"master, m, v and the residual stack ({ROUNDTRIP_LIVE_ROWS} live "
        f"rows of 8, {res.nbytes / 1e9:.2f} GB); "
        + "; ".join(
            f"8 -> {w} in {s1:.2f} s ({g1:.2f} GB/s read + written), "
            f"{w} -> 8 in {s2:.2f} s ({g2:.2f} GB/s), the fields "
            f"{'re-chunked' if tot[w] != tot[8] else 'passed through'}"
            for w, s1, g1, s2, g2 in rows)
        + "; the fields bitwise, the residual rows summed onto row 0 and "
        "kept bit for bit")
    del start, fields, res, want


def _control_leg(dev, card, profile):
    """29b: the controller on phase 24c's O5 BERT leg.  Returns (the
    enabled clean run's launches, the degrade run's CONTROL.json)."""
    import torch
    from apex_tpu_torch.control import (ControlConfig, RunController,
                                        control_violations,
                                        default_policies, load_artifact)
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.resilience import (CheckpointManager, GuardConfig,
                                           TrainGuard, faults, guard)
    from apex_tpu_torch.telemetry import trace
    from apex_tpu_torch.train import o5_guard_step
    from apex_tpu_torch.utils import build
    bcfg = bert_large_config(num_layers=GUARD_BERT_LAYERS, attn_impl="fast",
                             remat=True, dtype=torch.bfloat16)
    params = transformer_init(bcfg, torch.Generator().manual_seed(0),
                              device=dev)
    b0 = _train_state(params, None)
    del params
    bbatches = []
    for i in range(GUARD_BERT_STEPS):
        b = _batch(bcfg, 8, 512, 40 + i, dev)
        b["weights"] = torch.ones_like(b["tokens"], dtype=torch.float32)
        bbatches.append(b)
    inner = o5_guard_step(bcfg)
    window = {"on": False}

    def step(state, batch):
        # between two step calls that no check separates, the guard's and
        # the controller's code run with any host sync raising
        torch.cuda.set_sync_debug_mode(0)
        out = inner(state, batch)
        if window["on"]:
            torch.cuda.set_sync_debug_mode("error")
        return out

    def bsource(i):
        window["on"] = (i + 1) % GUARD_CHECK_EVERY != 0 \
            and i + 1 < GUARD_BERT_STEPS
        return bbatches[i]

    win_ms = []

    def watched(ctl):
        """The controller's window under the error mode, timed."""
        real = ctl.on_window

        def on_window(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                win_ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.set_sync_debug_mode(0)
        ctl.on_window = on_window
        return ctl

    def run(name, ctl=None, plan=None, world=None, traced=False):
        d = os.path.join(ELASTIC_DIR, name)
        g = TrainGuard(step, GuardConfig(
            ckpt_dir=d, enabled=True, save_every_steps=GUARD_BERT_STEPS,
            check_every=GUARD_CHECK_EVERY, backoff_seconds=0.25,
            world_size=world, flight_dir=d), plan=plan, controller=ctl)
        prev = trace.set_tracer(trace.Tracer(enabled=True, flight_dir=d)
                                if traced else None)
        build.LAUNCHES.clear()
        try:
            st, rep = g.run(b0, bsource, GUARD_BERT_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            trace.set_tracer(prev)
        torch.cuda.synchronize()
        require(g.host_reads == g.health_checks + rep.checkpoints,
                f"29b {name}: reads {g.host_reads} != checks "
                f"{g.health_checks} + snapshots {rep.checkpoints}")
        check_launches("control_o5", dict(build.LAUNCHES), rep.final_step,
                       exact=True)
        return st, rep, g, dict(build.LAUNCHES)

    st_n, rep_n, g_n, _ = run("none")
    off = RunController(ControlConfig(enabled=False))
    st_o, rep_o, g_o, _ = run("off", off)
    require(_same_bits(guard._leaves(st_n), guard._leaves(st_o))
            and g_o.host_reads == g_n.host_reads and rep_o.control is None
            and off.windows == 0,
            f"29b: the disabled controller is not the controller-free run "
            f"(reads {g_o.host_reads} / {g_n.host_reads})")
    on = watched(RunController(ControlConfig(enabled=True)))
    st_e, rep_e, g_e, launches = run("on", on, traced=True)
    require(rep_e.status == "completed" and rep_e.control["decisions"] == []
            and on.windows == GUARD_BERT_STEPS // GUARD_CHECK_EVERY
            and _same_bits(guard._leaves(st_n), guard._leaves(st_e)),
            f"29b: the enabled controller on a clean run: {rep_e.control}")
    clean_ms = list(win_ms)
    win_ms.clear()
    deg = watched(RunController(ControlConfig(
        enabled=True, max_actions=1, profile=profile),
        default_policies(goodput_floor=CONTROL_FLOOR)))
    _, rep_d, _, _ = run("degrade", deg, faults.parse(
        "goodput_degrade@2x20:0.02"), world=1, traced=True)
    doc = load_artifact(rep_d.control_path)
    acted = [r for r in doc["decisions"] if r["outcome"] == "acted"]
    require(len(acted) == 1 and acted[0]["action"] == "replan_reshard"
            and control_violations(doc) == []
            and rep_d.goodput["classes"]["reshard"]["ms"] > 0,
            f"29b goodput_degrade: decisions {doc['decisions']}, reshard "
            f"{rep_d.goodput['classes']['reshard']}")
    degrade_ms = list(win_ms)
    win_ms.clear()
    strag = watched(RunController(ControlConfig(enabled=True,
                                                max_actions=2)))
    _, rep_s, _, _ = run("straggler", strag,
                         faults.parse("straggler@2x40:4.0"), world=8)
    meta = CheckpointManager(os.path.join(ELASTIC_DIR, "straggler")
                             ).load_latest(with_meta=True)[2]
    q = [r for r in rep_s.control["decisions"] if r["outcome"] == "acted"]
    require(rep_s.status == "preempted" and rep_s.resize_to == 7
            and len(q) == 1 and q[0]["action"] == "quarantine"
            and q[0]["detail"] == {"device": "d0", "from_world": 8,
                                   "to_world": 7}
            and meta["control"] == {"quarantined_device": "d0",
                                    "resize_to": 7},
            f"29b straggler: {rep_s.status}, resize_to {rep_s.resize_to}, "
            f"decisions {rep_s.control['decisions']}, manifest "
            f"{meta.get('control')}")
    RESULTS["control_window_ms"] = statistics.median(clean_ms)
    log(f"  (b) [{card}] O5 BERT {GUARD_BERT_LAYERS} layers at full width, "
        f"{GUARD_BERT_STEPS} steps, a check every {GUARD_CHECK_EVERY}: the "
        f"disabled controller ends on the controller-free run's bits with "
        f"its {g_n.host_reads} reads; the enabled one with "
        f"default_policies() takes no action in {on.windows} windows, "
        f"reads {g_e.host_reads} = checks {g_e.health_checks} + snapshots "
        f"{rep_e.checkpoints}, the guard's and the controller's code "
        f"between checks under set_sync_debug_mode('error'), "
        f"{statistics.median(clean_ms):.3f} ms a window (median; all "
        f"{[round(x, 3) for x in clean_ms]}); goodput_degrade@2x20:0.02 "
        f"(floor {CONTROL_FLOOR}): {[(r['step'], r['action'], r['outcome'], round(r['value'], 3)) for r in doc['decisions']]},"
        f" reshard {rep_d.goodput['classes']['reshard']['ms']:.3f} ms in "
        f"GOODPUT.json, windows {[round(x, 3) for x in degrade_ms]} ms; "
        f"straggler@2x40:4.0 at a stamped world of 8 (the fault's eight "
        f"synthetic rows on one card): quarantine of {q[0]['detail']} at "
        f"step {q[0]['step']}, {rep_s.status} at {rep_s.final_step} with "
        f"resize_to {rep_s.resize_to}, manifest control {meta['control']}")
    del st_n, st_o, st_e, b0, bbatches
    return launches, rep_d.control_path


def phase_elastic_control(dev, card, profile):
    """Phase 29 (after 28, before 20): (a) elastic resume at full width on
    a world-1 NCCL group, and the host round trip of the flagship's flat;
    (b) the run controller on the O5 BERT leg; (c) the ``control`` CLI on
    (b)'s artifact.  ``profile`` is phase 28c's flagship profile.  Returns
    the legs' launch counts."""
    import shutil
    import torch
    import torch.distributed as dist
    log("== phase 29: elastic resume (the zero1 + int8-EF flagship, "
        "8 -> 1 and 7 -> 1) and the run controller (O5 BERT)")
    t0 = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    launches = {}
    store = start_process_group()
    try:
        launches["elastic_flagship"] = _elastic_leg(dev, card, profile)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    gc.collect()
    torch.cuda.empty_cache()
    _reshard_roundtrip(card)
    gc.collect()
    launches["control_o5"], ctl_path = _control_leg(dev, card, profile)
    gc.collect()
    torch.cuda.empty_cache()
    r = subprocess.run([sys.executable, "-m", "apex_tpu_torch.telemetry",
                        "control", ctl_path], cwd=HERE, capture_output=True,
                       text=True, timeout=300)
    require(r.returncode == 0 and "control ledger" in r.stdout,
            f"29c: the control CLI exited {r.returncode}: "
            f"{r.stdout[-400:]} {r.stderr[-400:]}")
    log(f"  (c) python -m apex_tpu_torch.telemetry control "
        f"{os.path.relpath(ctl_path, HERE)}: exit 0, "
        f"{r.stdout.strip().splitlines()[0]}")
    log(f"  [{card}] phase 29 took {time.perf_counter() - t0:.1f} s")
    return launches


def _kernel_entry(name, source, replaces, row, launches_by_path, path):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches_by_path[path].get(name, 0),
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                path=path,
                launches_by_path={p: c.get(name, 0)
                                  for p, c in launches_by_path.items()
                                  if c.get(name, 0) or p in ZERO_PATHS
                                  or p in TRAIN_LAUNCHES_PER_STEP
                                  or p.startswith("tp_")})


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    profile = "--profile" in argv
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_environment()
    phase_build()
    if "--variants" in argv:
        which = argv[argv.index("--variants") + 1:][:1]
        if which != ["gemm"]:
            study_variants(dev)
        if which != ["flash"]:
            study_gemm_variants(dev)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    log("== phase 3: forward kernels vs plain versions on the card")
    ln_rows = check_layer_norm(dev)
    flash_rows = check_flash(dev)
    check_flash_edges(dev, grad=False)
    log("== phase 3b: training kernels vs plain versions on the card")
    ln_bwd_rows = check_ln_bwd(dev)
    xent_rows = check_xent(dev)
    l2_rows = check_l2norm(dev)
    fb_rows = check_flash_bwd(dev)
    log("== phase 3c: ZeRO update and split flash-backward kernels vs plain "
        "versions on the card")
    zero_rows = check_zero_updates(dev)
    split_rows = check_flash_split(dev)
    check_flash_edges(dev, grad=True)
    check_flash_bwd_graph(dev)
    check_kv_head_dims(dev)
    torch.cuda.empty_cache()
    log("== phase 3d: fused dense, multi-tensor scale and axpby kernels vs "
        "plain versions on the card")
    dense_rows = check_dense_act(dev)
    flat_rows = check_scale_axpby(dev)
    log("== phase 3e: layer norm at any width, cross-entropy at its "
        "instances' edges, flash attention at head dims 48, 96, 160, 192, "
        "256, 320 and 512, vs plain versions on the card")
    edge_rows = (check_ln_edges(dev) + check_xent_edges(dev)
                 + check_flash_pad_edges(dev) + check_flash_chunk_edges(dev))
    torch.cuda.empty_cache()
    phase_serve_parity(dev)
    serve_launches, serve_doc = phase_main_path(dev, card, profile)
    phase_train_parity(dev)
    launches = {"serve": serve_launches,
                "o5_lamb": phase_train(dev, card, profile)}
    torch.cuda.empty_cache()
    import torch.distributed as dist
    store = start_process_group()
    try:
        phase_zero_parity(dev)
        launches["zero_lamb"], launches["zero_adam"] = phase_zero(
            dev, card, profile)
        torch.cuda.empty_cache()
        launches["long_seq"] = phase_long_seq(dev, card, profile)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    torch.cuda.empty_cache()
    phase_mlp_parity(dev)
    launches["mlp_fp16"] = phase_mlp(dev, card, profile)
    launches["mt_apply"] = phase_mt_apply(dev)
    phase_rn50_parity(dev)
    launches["rn50_o2"], launches["rn50_ddp"] = phase_rn50(dev, card,
                                                           profile)
    torch.cuda.empty_cache()
    phase_cast_table(dev)
    launches["simple_ddp_o1"] = phase_simple_ddp(dev, card)
    phase_dcgan_parity(dev)
    launches["dcgan_o4"] = phase_dcgan(dev, card, profile)
    torch.cuda.empty_cache()
    launches["ckpt_rn50"], launches["ckpt_o5"] = phase_checkpoint(dev, card)
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    fp16_rows = phase_fp16_kernels(dev, card)
    launches["fp16_mha_self"], launches["fp16_mha_self_default"] = \
        phase_fp16_mha(dev, card, seed)
    launches["rnn_lm_fp16"] = phase_rnn_lm(dev, card, seed)
    launches["asp_o5_lamb"] = phase_asp(dev, card)
    torch.cuda.empty_cache()
    launches.update(phase_collectives(
        dev, card, (serve_launches, serve_doc["tokens_per_sec"])))
    torch.cuda.empty_cache()
    launches.update(phase_parallel(dev, card))
    torch.cuda.empty_cache()
    launches.update(phase_tensor_parallel(dev, card, serve_launches))
    torch.cuda.empty_cache()
    launches.update(phase_elastic_control(dev, card,
                                          RESULTS["flagship_profile"]))
    torch.cuda.empty_cache()
    phase_mha_parity(dev)
    launches["mha_self"], launches["mha_self_default"] = phase_mha_stack(
        dev, card, "self", seed, profile)
    launches["mha_encdec"], launches["mha_encdec_default"] = \
        phase_mha_stack(dev, card, "encdec", seed, profile)
    launches["mha_time_mask"] = phase_mha_time_masks(dev, card)
    check_dense_routes(dev)
    phase_telemetry(dev, card, launches)
    launches["guard_rn50"], launches["guard_o5"] = phase_guard(dev, card)
    phase_profiling(dev, card)

    def pick(rows, **want):
        return next(r for r in rows
                    if all(r.get(k) == v for k, v in want.items()))

    bf16 = "bfloat16"
    csrc = "apex_tpu_torch/csrc/"
    kernels = [
        _kernel_entry("flash_fwd", csrc + "flash_fwd.cu", FLASH_REPLACES,
                      pick(flash_rows, case="training", dtype=bf16),
                      launches, "o5_lamb"),
        _kernel_entry("flash_bwd", csrc + "flash_bwd.cu", FLASH_BWD_REPLACES,
                      pick(fb_rows, case="training", dtype=bf16), launches,
                      "o5_lamb"),
        _kernel_entry("ln_fwd", csrc + "layer_norm.cu", LN_REPLACES,
                      pick(ln_rows, shape=(4096, 1024), dtype=bf16,
                           affine=True), launches, "o5_lamb"),
        _kernel_entry("ln_bwd", csrc + "layer_norm.cu", LN_BWD_REPLACES,
                      pick(ln_bwd_rows, shape=(4096, 1024), dtype=bf16,
                           affine=True), launches, "o5_lamb"),
        _kernel_entry("xent_fwd", csrc + "xentropy.cu", XENT_REPLACES,
                      pick(xent_rows, shape=(4096, 30592), dtype=bf16,
                           smoothing=0.0), launches,
                      "o5_lamb"),
        _kernel_entry("l2norm", csrc + "multi_tensor.cu", L2NORM_REPLACES,
                      pick(l2_rows, dtype="float32"), launches, "o5_lamb"),
        _kernel_entry("lamb_stage1", csrc + "multi_tensor.cu",
                      LAMB1_REPLACES, pick(zero_rows, kernel="lamb_stage1"),
                      launches, "zero_lamb"),
        _kernel_entry("adam", csrc + "multi_tensor.cu", ADAM_REPLACES,
                      pick(zero_rows, kernel="adam"), launches, "zero_adam"),
        _kernel_entry("flash_bwd_dq", csrc + "flash_bwd.cu",
                      FLASH_DQ_REPLACES,
                      pick(split_rows, kernel="flash_bwd_dq"), launches,
                      "long_seq"),
        _kernel_entry("flash_bwd_dkv", csrc + "flash_bwd.cu",
                      FLASH_DKV_REPLACES,
                      pick(split_rows, kernel="flash_bwd_dkv"), launches,
                      "long_seq"),
        _kernel_entry("dense_act", csrc + "fused_mlp.cu", DENSE_REPLACES,
                      pick(dense_rows, shape=(MLP_BATCH, 4096, 4096),
                           dtype="float16", activation="relu", bias=True),
                      launches, "mlp_fp16"),
        _kernel_entry("mt_scale", csrc + "multi_tensor.cu", SCALE_REPLACES,
                      pick(flat_rows, kernel="mt_scale", n=mlp_flat_n(),
                           dtype="float32"), launches, "mlp_fp16"),
        _kernel_entry("mt_axpby", csrc + "multi_tensor.cu", AXPBY_REPLACES,
                      pick(flat_rows, kernel="mt_axpby", n=mlp_flat_n()),
                      launches, "mt_apply"),
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on its path "
                f"{k['path']}")
        # the fp16 instance at phase 21a's first shape for this kernel
        row = next((r for r in fp16_rows if r["kernel"] == k["name"]), None)
        if row is not None:
            k["fp16"] = {key: row[key] for key in (
                "case", "max_abs_err", "ms", "bf16_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")}
        # phase 3e's rows of this kernel (widths, vocabularies, head dims)
        edges = [{key: r[key] for key in (
            "case", "dtype", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")} for r in edge_rows
            if r["kernel"] == k["name"]]
        if edges:
            k["edges"] = edges
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
