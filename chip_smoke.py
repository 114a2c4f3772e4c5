#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``leftrefill_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the kernel phases one line per kernel shape):
1. set-up: the card's name and power limit, versions, the kernel build (its
   time, and ptxas's registers, spills and barriers with the dynamic shared
   memory of each instantiation of the flash forward, the bf16 and int8
   convs, the int8 proj_out GEMM, the two flash backward kernels and the
   GEGLUs' up and down kernels, bf16 and int8, and the registers of K4's,
   K7's and K8's);
2. each bf16 kernel (K1 flash forward, K2 3x3 conv, K3 fused GEGLU) at every
   shape one full-width bf16 UNet forward gives it, against its plain
   PyTorch version (relative L2 <= 1e-2), timed with CUDA events beside its
   bound and the library call where one exists, with the share of the bound
   it reaches and its factor to the library call (as at every kernel site
   below; K3, KI3 and KI1, which no single call computes, beside their
   yardsticks: the cuBLAS composition of the same function, the two int8
   products alone, and KI1's int8 product on a pre-built im2col,
   ``tools.COMPOSED``), and K3's and KI3's launch plan
   (``mlp.geglu_plan``) equal to the launchers'; two launches of K3 at its
   largest site bit-equal; then off the main path, against the plain
   versions: the flash
   kernel's head-dim-128 instantiation, the flash kernel at 1088 tokens (a
   key and a query tail past a multiple of 128), and K2 at 72 input
   channels (a channel tail past a multiple of 64);
2p. the timing probes of the JAX package's scripts (tools only, no serving
   or training path runs them): P1 (the int8-Q.K^T flash forward, with and
   without its int8 P.V), every built K1 variant of P2-P4 (exp, clamp, lse
   and 128 or 256 query rows a block) at the CFG-batch-2 attention shapes
   (2, 5, 8192), (2, 10, 2048) and (2, 20, 512), head dim 64, and P5 (the
   no-op) on its [8, 128] tile, each wrapper once a site with the counts
   read just after (the probes' own path), then each output held to its
   plain version: o within relative L2 1e-3 (the bf16 exp within 8e-3 and
   farther than 1e-3 from the fp32 exp), the lse within 1e-4 absolute, P1
   with its int8 P.V per element within the steps that p / l * 127 ties
   at .5 can move, P1's q, k (and v) codes and scales on the card equal to
   the CPU's, P5 bit-equal; the
   identity-exp variant held on non-negative q and k (its o is defined only
   where the row sum of min(s, 75) is positive) and timed on normal draws;
   each kernel in device ms beside its bound, its plain version and SDPA
   where one call computes the same function (the fp32-exp clamped
   variants), or ``x + 1`` (P5); the 512-row block refused by the kernel's
   entry (no counterpart: 1056 threads);
3. one full-width bf16 UNet forward (CFG batch 2, 64x128 latent, cfg_dup
   and the cross-attention K/V cache on) through the kernels against the
   same forward through the plain versions (relative L2 <= 3e-2);
4. bf16 serving: two 512x1024 requests (DDIM-50, eta 1, CFG 2.5, batch 1,
   each with its own seed) on the full-width SD2-inpainting bundle with
   random weights; the outputs are checked and the kernel launch counts must
   be 33 conv, 15 flash and 16 GEGLU per UNet forward;
2i. JAX's unfused int8 configuration (``fused=False``, the same fp weights
   quantized): each int8 kernel (KI1 3x3 conv, KI2 proj_out GEMM + residual,
   KI3 GEGLU) at every shape one full-width int8 forward gives it, against
   its plain version, each within 1 bf16 ulp per element, timed, and two
   launches of KI3 at its largest site bit-equal, KI1's and KI2's launch
   plans at each site (``quant.conv3x3_int8_plan``: tile, K split over a
   thread cluster, patch, shared memory; ``quant.dense_int8_res_plan``:
   tile, K split, shared memory) equal to the launchers'; then off the main
   path: KI1's fp32 output arm equal to its plain version, KI2 at 1000 rows
   (a ragged row tile) and K = 320 (a 64-byte K tail) and at 200 rows (K
   split over a 2-block cluster) within 1 ulp, and KI3
   at a 1280-wide requant chunk (a cluster of 10 blocks, past the portable
   8) and din = 320 within 1 ulp;
3i. that full-width int8 forward through the kernels against the same
   forward with KI1-KI3 through their plain versions (relative L2 <= 3e-2;
   K1 stays on its kernel in both), and, for information, against the
   forward with every kernel plain and against the bf16 forward of phase 3;
5. unfused int8 serving: two 512x1024 requests (DPM-Solver++(2M) 15 steps,
   CFG 2.5, batch 1) after a warm-up request, checked as in phase 4, with 47
   KI1, 11 KI2, 16 KI3 and 15 K1 launches per UNet forward;
2f. JAX's default int8 configuration (the fused prologues, the same int8
   weights): K4 (GN affine + SiLU + per-tensor quantize, with its scale, in
   one launch), K7 (LayerNorm + per-row quantize) and K8 (GN affine +
   per-pixel quantize) at every shape one full-width fused int8 forward
   gives them, against their plain versions (int8 values at most one step
   apart on at most 1e-3 of the elements, scales within 8 fp32 ulps, a bf16
   output within one bf16 ulp of its largest value), timed; K4 at its
   largest site captured in a CUDA graph and replayed, bit-equal to its
   eager launch; then K7 and K8 with their bf16 output, off the main path;
3f. that fused forward with K4, K7 and K8 against the same forward with the
   three routed to their plain versions (KI1-KI3 and K1 on their kernels in
   both), block by block with each block fed the kernels' input to it:
   every block within 2e-2 of its max|out|, the transformers together
   within 3e-3 rel L2 (end to end within 3e-2 where every block is equal);
   for information the end-to-end difference and the fused against the
   unfused forward;
5f. fused int8 serving: two 512x1024 DPM-Solver++(2M)-15 requests after a
   warm-up, checked as in phase 5, with 44 K4, 47 KI1, 48 K7, 16 K8, 11
   KI2, 16 KI3 and 15 K1 launches per UNet forward, and no per-tensor scale
   computed outside K4 (``quant.silu_scale`` refused while they run);
2m. the flash kernel at the multi-view joint self-attention shapes (64x64
   views, CFG 2 scene rows): V=4, 16384 tokens (the JAX package's
   streaming-K/V kernel K11 takes it) and V=2, 8192 tokens, against the
   query-chunked plain version (relative L2 <= 1e-2), timed;
3m. one full-width V=4 multi-view bf16 UNet forward (8 rows of 64x64
   views, the K/V cache on, no cfg_dup): its 16 flash (five at 16384
   tokens), 33 conv and 16 GEGLU sites, each kernel at each of their shapes
   against its plain version as in phase 2, then the forward through the
   kernels against the plain versions (relative L2 <= 3e-2);
6. multi-view serving: V=4 scenes of 512x512 views (DDIM-50, eta 1, CFG
   2.5), a short warm-up scene, then two scenes with their own seeds: finite
   output, the unmasked views and view 0 outside its hole returned as they
   were, different outputs for different seeds, and the launch counts of
   phase 3m per forward; seconds per scene.
2t. the flash-attention backward kernels (dq: K12 + K14; dk/dv: K13) at
   every shape a full-width train step gives them (1-reference batch 8:
   8192/2048/512 tokens; the V=4 scene: 16384 (K14's path in JAX), 4096,
   1024 and 256 tokens), on seeded normal inputs (every 16th query row's
   logits past the clamp at 75), with o and lse from K1: dq, dk and dv each
   within relative L2 1e-2 of the plain version, outside the rows that a
   score within 1e-3 of the clamp reaches (there the envelope mask steps,
   and the two versions' sums may round to its two sides), and over every
   row once each such score's term is put on the kernel's side; timed
   beside the bound and the backward of ``scaled_dot_product_attention``;
   then both off the main path, held the same way: at head dim 128, at
   1088 tokens (a 64-row tail past a multiple of 128) and at 576 queries
   against 1216 keys (Nq != Nk, both with tails); and two launches of each
   at the 8192-token site must give bit-equal outputs (no atomics); then
   K3 at every GEGLU site of both train steps (the forward and the remat
   recompute launch each), held and timed as in phase 2, and two launches
   at the 65536-row site bit-equal;
7. 1-reference prompt-tuning training at full width (remat on, the released
   AdamW: lr 3e-5, weight decay 0.01): batch 8 of seeded 512x1024 canvases,
   a warm-up step, then three timed steps with the launches per step of
   every kernel checked; the loss finite, the prompt table moved, every
   other parameter bit-unchanged; then at batch 2 one step's prompt-table
   gradient through the kernels against the same step with every kernel
   routed to its plain version (relative L2 <= 5e-2);
8. V=4 multi-view prompt-tuning training: one scene of four 512x512 views a
   step, the view-0 loss, a warm-up step and two timed steps with their
   launches checked; the loss finite and the table moved.
2n. novel-view synthesis (``build_sd2_nvs_bundle``, refinement branch on):
   K1, K2 and K3 at every shape one full-width NVS forward gives them (CFG
   batch 2 of 32x64 latents, cfg_dup, the K/V cache, c_input), held and
   timed as in phase 2, the shapes four poses in one request add (CFG batch
   8) and the K2 shapes the separator columns add (use_sep: the 65- and
   33-wide levels), with K1's and K3's refusal of the use_sep sequences (no
   multiples of 128) printed;
3n. that NVS forward through the kernels against the plain versions
   (relative L2 <= 3e-2), with use_sep off and on, its launches per
   forward pinned (``tools.PER_FORWARD_NVS``, ``PER_FORWARD_NVS_SEP``);
9. NVS serving through ``NVSTask.log_images`` (DDIM-50, eta 1, CFG 2.5)
   after a warm-up: two 256x512 requests at batch 1 with their own seeds and
   one at batch 4 (four target poses of one reference, from
   ``get_relative_pose`` of seeded cameras, one noise draw shared by the
   rows): finite output in [-1, 1], different seeds and different poses
   give different views, the launches per forward of phase 3n (at batch 4
   K3 also takes the middle block's 256 rows); seconds per request;
9s. ``structure_ddim_sample``, 10 steps, Tm 3 (batch 3 in the guided phase,
   no cfg_dup): finite, launches counted;
9l. a LoRA adapter (default targets, rank 16, scale 1, seeded non-zero ups)
   swapped into the NVS UNet by ``LoraAdapterStore``: a 10-step request
   that differs from the base's, then the base restored and the same request
   bit-equal to the first; then the fused int8 1-reference bundle with an
   adapter merged into its fp32 master and requantized (the master checked
   to requantize to the bundle's weights): one UNet forward with the pinned
   int8 launch counts.
10. novel-view-synthesis training through the port's training CLI
   (``leftrefill_torch.cli.train.main``, in-process) at full width: the
   shipped model YAML with LoRA (rank 16, default targets), the refinement
   branch and the pruned save on, the shipped training YAML (batch 16,
   AdamW 1e-4, weight decay 0.01) pointed at seeded synthetic renders the
   phase writes (64 objects of 12 RGBA 256x256 views and their cameras, 4
   validation objects with mask files), ``--max_steps 4 --no_restore`` with
   one validation batch (DDIM-10) and the step-0 image log (DDIM-10): the
   run ends with 0, every step's loss is finite and its kernel launches
   are ``tools.PER_TRAIN_STEP_NVS`` (the first step's backward sites
   ``tools.TRAIN_SITES_NVS``), every trainable group (prompt table,
   relative-pose MLP, LoRA down and up, refinement branch) moved and every
   other parameter is bit-unchanged, ``ckpts/last.pt`` holds exactly the
   NVS-filtered keys with the LoRA factors; then ``--restore --max_steps 6``
   starts from those weights at step 4 and takes two steps; seconds per
   step (the median after the first), peak memory, validation PSNR/SSIM;
2tn. the kernels at every site that train step recorded: K1 (o within
   relative L2 1e-2, and the lse the backward reads within 1e-3 absolute),
   K12 and K13 held as in phase 2t beside SDPA's backward, K2 and K3 held
   and timed as in phase 2, and K3's gradient (dx, dW1 through
   ``geglu_vjp_math``) within relative L2 1e-2 of autograd through
   ``geglu_plain``;
10g. at batch 2 (two validation items, one row's prompt dropped by the CFG
   draws), one step's gradient of each trainable group of the trained
   model through the kernels against the same step with every kernel routed
   to its plain version (relative L2 <= 5e-2 each).
11. the serving and evaluation entry points of 1-reference inpainting:
   (11a) the JPEG fixtures of ``tests/fixtures/jpeg`` read by
   ``data.image_io.imread`` (no OpenCV on the card's machine) equal to OpenCV's
   decodes stored beside them (PNGs; the 1600x1200 4:2:0 photo by its
   SHA-256), with the seconds to decode that photo; (11b) an experiment
   directory (``configs/ref_inpainting.yaml``, a seeded prompt checkpoint
   saved through ``CheckpointManager``) served by
   ``serving.gradio_app.initialize_model`` (random weights, no SD file):
   ``predict`` twice at 512 (DDIM-50, eta 1, CFG 2.5) on the JPEG fixtures
   and a 1-bit palette-PNG mask, the second timed, its launches
   ``tools.PER_FORWARD_BF16`` x 50, its output bit-equal to
   ``inpaint_right_half`` called on ``predict``'s canvas with the same
   seed, and within one level of the target outside the hole; (11c) the same
   with ``quantized=True`` and DPM++(2M) at 15 steps, launches
   ``tools.PER_FORWARD_INT8`` x 15; (11d) ``cli.sample.main`` in process
   writes a 512x512 PNG; (11e) ``cli.test.main`` on two pair directories
   the phase writes (test_size 512, DDIM-10, ``--limit 2``, LPIPS from a
   file of seeded weights), then ``--multiview`` on one V=4 scene of
   ``configs/multiview_ref_inpainting.yaml`` (view_num 4), launches
   ``tools.PER_FORWARD_MV4`` x 10: finite PSNR, SSIM and LPIPS in the
   metrics files, PSNR below 60 dB (only the views with a hole scored: a
   reference view would read 120 dB), the grids and reference strips
   written.
12. 1-reference prompt tuning through the training CLI on MegaDepth-format
   data (``cli.train.main`` in process): the shipped
   ``ref_inpainting_training_config.yaml`` (batch 8, AdamW 3e-5, weight
   decay 0.01) and model YAML at full width (no remat, as JAX's CLI), their
   copies edited only where listed (the data paths, pointed at a seeded
   synthetic tree the phase writes with ``tools.write_megadepth_scenes``:
   2 scenes of 14 1600x1200 JPEG photos, 155 pairs a scene inside the
   overlap filter (the sampler's 150) and 12 outside, match pickles, mask
   lists, 4 validation pair directories; ``val_batches: 1``,
   ``val_ddim_steps: 10``, ``log_ddim_steps: 10``), ``--max_steps 4
   --no_restore`` then ``--restore --max_steps 6``: the CLI returns 0, every
   loss is finite, every step's launches are ``tools.PER_TRAIN_STEP_CLI``
   and the first step's backward sites ``tools.TRAIN_SITES``, the prompt
   table moved and every other parameter is bit-unchanged,
   ``ckpts/last.pt`` holds exactly the ``prompt_only_filter`` keys, the
   resumed run starts at step 4 from them; seconds per step (the median
   after the first; the loader's decode threads run beside the steps),
   the seconds between steps once the prefetched batches are used (the
   data path's pace), peak memory, validation PSNR/SSIM;
12g. a batch of 2 from that CLI's own loader (its dataset, sampler and
   tokenizer): one step's prompt-table gradient through the kernels against
   the same step with every kernel routed to its plain version (relative
   L2 <= 5e-2);
12m. the same as 12 for ``multiview_ref_inpainting_training_config.yaml``
   at view_num 4 (one scene of four 512x512 views a step, the view-0 loss,
   K1 and K14's dq at 16384 tokens): launches
   ``tools.PER_TRAIN_STEP_CLI_MV4``, sites ``tools.TRAIN_SITES_MV4``.
13. the remaining samplers, ``log_images``' diagnostic rows, the
   cross-attention maps and ``multi_cond_sample`` at full width (the bf16
   bundle of ``configs/ref_inpainting.yaml`` through ``build_task``, random
   weights from seed 0, a 512x1024 canvas, batch 1): (13d)
   ``RefInpaintTask.log_images`` at its defaults (DDIM-50, eta 0, g 9) with
   the diffusion, denoise and progressive rows (50 + 1000 CFG-doubled
   forwards: the denoise row is pred's own DDIM loop; launches
   ``tools.PER_FORWARD_BF16`` each): each row [S, 1, 512, 1024, 3] finite
   in [-1, 1], the denoise row's last latent bit-equal to the one "pred"
   decoded, each row's seconds and the peak memory; (13s) PLMS-50 (51
   forwards), DDIM-50 at eta 1 with the reference half renoised from the
   canvas's latent, temperature 0.5 and a per-step guidance schedule, and
   ``ddim_encode`` over 25 steps then ``ddim_decode`` from 25, each with its
   launches and seconds; then one step each of DDPM (t 500), PLMS at order
   1 (the Heun step) and up to order 4, encode and decode: every model call
   of the step, on the input the kernels' run gave it, through the kernels
   and through the plain versions, the model outputs ([uncond; cond])
   within relative L2 3e-2 (the guided outputs printed beside them); (13a)
   ``collect_attention_maps`` on one CFG-batch forward (cfg_dup, the K/V
   cache): 16 maps [2, Nq, 77] whose rows sum to 1 within
   1e-3, each map's departure from the uniform 1/77 within relative L2 3e-2
   of the plain versions', the UNet output bit-equal
   to the forward without the collector; (13m)
   ``MultiViewRefInpaintTask.multi_cond_sample`` with K = 2 conditionings
   of one V=4 scene (the same target view, other reference views), DDIM-10,
   CFG 2.5: launches ``tools.PER_FORWARD_MV4`` each, finite, seconds.
14. the parallel paths (``leftrefill_torch.parallel``), each rank a process
   on the one card over gloo (``tools.dryrun.run_ranks``, rank bodies in
   ``tools/parallel_smoke.py``), the bf16 bundle of
   ``configs/ref_inpainting.yaml`` at full width, random weights, seed 0:
   (14b) a 512x1024 request with the CFG batch split over 2 ranks, bf16
   DDIM-50 eta 1 then fused int8 DPM++(2M)-15, CFG 2.5: each rank's UNet
   rows at two steps against the same rows run alone at batch 1 (relative
   L2 <= 1e-3; read: equal), the ranks' canvases bit-equal, launches per
   rank ``PER_FORWARD_BF16`` x 50 and ``PER_FORWARD_INT8`` x 15, the
   canvas against the one-rank request and both seconds per request
   printed; (14v) the V=4 forward (8 rows of 512x512 views) with the views
   split over 2 view ranks, 4, and 2 data x 2 view: each rank's rows
   against the one-rank forward's (phase 3m's limit, 3e-2), launches
   ``PER_FORWARD_MV4_VIEW_RANK`` and K1 at ``VIEW_RANK_SITES`` (Nq != Nk)
   a rank, K1 held and timed at those sites as in phase 2; (14t) phase 7's
   step over 2 ranks x batch 4 against 1 rank x batch 8 on the same global
   draws: the averaged prompt gradient within 5e-2, the ranks' tables
   bit-equal, ``PER_TRAIN_STEP`` a rank, then the step through an NCCL
   group of one; (14c) ``python -m torch.distributed.run --nproc_per_node 2
   -m leftrefill_torch.cli.train --nchip 2`` (through ``parallel_smoke
   cli``, which records each rank) on phase 12's synthetic tree, batch 4 a
   rank, 2 steps and one validation batch at DDIM-10: the ranks' tables
   bit-equal after each step, ``PER_TRAIN_STEP_CLI`` a step, only rank 0
   writing checkpoints and grids; seconds a step and between steps.
15. the model options that no shipped config sets, at full width, random
   weights: (15q) the fused int8 1-reference request with the int8 VAE
   decoder (``initialize_model(quantized=True, quant_vae=True)`` on an
   experiment directory built as phase 11's, ``predict`` 512x1024, batch 1, DPM++(2M)-15,
   CFG 2.5): launches ``tools.PER_FORWARD_INT8`` x 15 +
   ``tools.PER_DECODE_VAE8``, the output outside the hole within a level of
   the target; KI1 (within 1 bf16 ulp) and K2 (relative L2 <= 1e-2) at
   each of the decode's sites against their plain versions, timed as in
   phase 2; the decode of the canvas's latent through the kernels against
   the plain versions (relative L2 <= 3e-2), beside it the same decode with
   one KI1 site's weight scale dropped (a wrong kernel: it must read above
   three times the limit), and the int8 decode's PSNR against the bf16
   decoder's of the same fp32 weights; (15d) deep-prompt tuning through the
   training CLI on phase 12's synthetic tree: the shipped YAMLs with
   ``deep_prompt: True`` in the embedder and the data config (16 layers x
   50 prompt tokens), batch 8, ``--max_steps 2 --no_restore``, one
   validation batch at DDIM-10: per-layer tokens [8, 16, 77], launches
   ``tools.PER_TRAIN_STEP_CLI`` a step and backward sites
   ``tools.TRAIN_SITES``, only the deep table moved, every layer's rows;
   the deep table's gradient on a batch of 2 from the CLI's loader through
   the kernels against the plain versions (relative L2 <= 5e-2); a
   full-width forward under a deep context of 16 distinct slices against
   the plain versions (<= 3e-2), beside it the control, the same forward
   with the slices reversed, which must read above three times the limit;
   (15u) the option UNets (one CFG forward at 64x128, the K/V cache and
   cfg_dup, launches pinned): (A) ``tools.UNET_A`` (scale-shift norms) in
   bf16 (kernels vs plain <= 3e-2, K2 at every site) and fused int8
   (teacher-forced as phase 3f, KI1 at every site, each of the 22 K4 sites
   whose fold carries the scale-shift (one per ResBlock) held on its own
   inputs: int8 values at most one step apart on at most 1e-3 of them);
   (B) ``tools.UNET_B`` (five heads of 64, 128 and 256 channels, 1x1 conv
   projections, no resample convs) in bf16 (<= 3e-2, K1 at D = 128 at every
   such site within 1e-2).
16. the real-weights runbook and the quality studies, at full width on
   random weights: (16r) ``python -m leftrefill_torch.tools.runbook
   --synthetic --full_width`` in-process (stand-ins at the width of
   ``configs/ref_inpainting.yaml``, a 2.6 GB fp16 checkpoint, deleted after
   the run): the convert stage's accounting (nothing missing but the prompt
   table, nothing of another shape or unexpected, the 12 schedule buffers
   and the 3 EMA keys skipped as recomputed, the two text-tower keys as
   other), the parity stage on the loaded weights (the sampler's CFG UNet
   call through the kernels against the plain versions in bf16, and the
   fused int8 bundle's UNet call, teacher-forced block by block, and its
   int8 VAE decode; each within relative L2 3e-2), the
   evaluation CLI's PSNR, SSIM and LPIPS finite (DDIM-10), the A/B of bf16,
   fused int8 and int8 + int8 VAE decoder on 2 pairs at DDIM-10 with finite
   cross-PSNRs and launches per variant pinned (2 x (10 x
   ``PER_FORWARD_BF16`` / ``_INT8`` (+ ``PER_DECODE_VAE8``))); (16q) the
   four studies of ``tools/quality.py`` at full width, each printing its
   JSON line with launches pinned: int8 (the eps sweep of the bf16 and
   fused int8 UNets from fp32 at five timesteps, a DDIM-50 request in each),
   mv (the same on the V=2 UNet, 2-view DDIM-50 scenes; then K1-K3 at every
   site of its forward against their plain versions, timed as in phase 2),
   solver (547 CFG forwards: DDIM-200, -50, DPM++(2M)-20, -15, -12 at eta 0,
   DDIM-50 and -200 at eta 1, one x_T), vae8 (one 64x128 latent through the
   fp32, bf16 and int8 decoders); the int8 study's sweep again at t = 500
   with every kernel routed to its plain version: each kernel path's mean
   eps deviation from fp32 at most 1.5 times the plain path's plus 1e-3,
   and a wrong K1 (its output rows reversed) above that limit; both
   forwards timed, kernels and plain versions.
The line before the last is a JSON summary of the fourteen kernels; the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before them.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REL_L2 = {"flash_fwd": 1e-2, "flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2, "conv3x3": 1e-2,
          "geglu": 1e-2}  # kernel vs plain
# exact int32 sums and the plain version's fp32 operations in its order (KI3:
# the same erff, so the requant of h agrees too); 1 ulp leaves room for a
# contracted multiply-add, which the kernels avoid
ULPS = {"conv3x3_int8": 1, "dense_int8_res": 1, "geglu_int8": 1}
# the fused prologues: K4 and K8 repeat their plain versions' fp32 operations,
# K7 sums each row in another order than PyTorch's reductions, which moves
# its mean and scale by a few ulps and a normalized value near zero by many
# of its own (tiny) ulps: int8 values at most one step apart on at most 1e-3
# of them, scales within 8 fp32 ulps, the bf16 output within one bf16 ulp of
# its largest value
STEP_SHARE, SCALE_ULPS, NORM_MAX_REL = 1e-3, 8, 2.0**-8
BF16_NAMES, INT8_NAMES = ("flash_fwd", "conv3x3", "geglu"), ("conv3x3_int8", "dense_int8_res", "geglu_int8")
PROLOGUES = ("affine_silu_quant", "ln_quant", "gn_quant")
UNET_REL_L2 = 3e-2  # 16 transformer blocks and 22 res blocks of rounding
# the prompt table's gradient through the kernels against the plain versions:
# the forward's rounding differences (rel L2 ~1.6e-2 at the UNet output) and
# the backward's, through every layer after the first cross-attention
PROMPT_GRAD_REL_L2 = 5e-2
BWD_NAMES = ("flash_bwd_dq", "flash_bwd_dkv")
# K1's lse at the train step's shapes: fp32 sums over up to 2048 keys in
# another order than the plain version's, at |lse| up to ~83 (an fp32 ulp
# there is 7.6e-6)
LSE_TRAIN_ABS = 1e-3
NVS_TRAIN_BATCH, NVS_OBJECTS, NVS_VAL_OBJECTS = 16, 64, 4
BLOCK_MAX_REL, TRANSFORMERS_L2 = 2e-2, 3e-3  # teacher-forced blocks (tests/test_torch_quant_unet_fused.py)
VIEWS = 4
KERNELS = {
    "flash_fwd": ("leftrefill_torch/csrc/flash_fwd.cu",
                  "leftrefill_tpu/ops/flash_attention.py:211 (K1) and leftrefill_tpu/ops/flash_attention.py:252 (K11)"),
    "flash_bwd_dq": ("leftrefill_torch/csrc/flash_bwd.cu",
                     "leftrefill_tpu/ops/flash_attention.py:418 (K12) and leftrefill_tpu/ops/flash_attention.py:456 (K14)"),
    "flash_bwd_dkv": ("leftrefill_torch/csrc/flash_bwd.cu", "leftrefill_tpu/ops/flash_attention.py:506 (K13)"),
    "conv3x3": ("leftrefill_torch/csrc/conv3x3.cu", "leftrefill_tpu/ops/conv.py:181"),
    "geglu": ("leftrefill_torch/csrc/geglu.cu", "leftrefill_tpu/ops/mlp.py:86"),  # and csrc/geglu.cuh
    "conv3x3_int8": ("leftrefill_torch/csrc/conv3x3_int8.cu",
                     "leftrefill_tpu/ops/quant.py:390 and leftrefill_tpu/ops/quant.py:277"),
    "dense_int8_res": ("leftrefill_torch/csrc/dense_int8_res.cu", "leftrefill_tpu/ops/quant.py:106"),
    "geglu_int8": ("leftrefill_torch/csrc/geglu_int8.cu", "leftrefill_tpu/ops/mlp.py:204"),
    "affine_silu_quant": ("leftrefill_torch/csrc/quant_prologue.cu", "leftrefill_tpu/ops/quant.py:603"),
    "ln_quant": ("leftrefill_torch/csrc/quant_prologue.cu", "leftrefill_tpu/ops/quant.py:682"),
    "gn_quant": ("leftrefill_torch/csrc/quant_prologue.cu", "leftrefill_tpu/ops/quant.py:758"),
    "flash_int8": ("leftrefill_torch/csrc/flash_int8.cu", "scripts/tpu_r3_attnprobe.py:124 (P1)"),
    "flash_variant": ("leftrefill_torch/csrc/flash_fwd.cu",
                      "scripts/tpu_r3_attnprobe2.py:75 (P2), scripts/tpu_r5_headpack.py:118 (P3) and "
                      "scripts/tpu_r5_attn_ab.py:80 (P4)"),
    "noop": ("leftrefill_torch/csrc/noop.cu", "scripts/tpu_r3_overhead.py:62 (P5)"),
}
# the probes' sites: the CFG-batch-2 attention shapes of the main path (B, H, N) and P5's tile
PROBE_SHAPES = ((2, 5, 8192), (2, 10, 2048), (2, 20, 512))
PROBE_TILE = (8, 128)
PROBE_KERNEL = {"flash_int8": "flash_int8_kernel", "flash_variant": "flash_fwd_kernel", "noop": "noop_kernel"}
# P1's q drawn with std 3: at std 1 and 8192 keys p / l * 127 stays below 0.5
# for almost every key, so the int8 P.V's codes would be nearly all 0
P1_Q_STD = 3.0
# the probes against their plain versions.  The fp32-exp variants, the
# identity and P1 without pv_int8 compute their plain versions' functions up to
# fp32 sums in another order and __expf's last bits (read 6e-5 to 2.5e-4):
# o within PROBE_REL_L2, where a neighbouring function (the bf16 exp, an
# exact Q K^T for the int8 one) reads several 1e-3, and the lse within
# LSE_ABS of its ~9 (rows a few 1e-2 apart).  The bf16 exp takes 2^(bf16(s
# log2 e)) where its plain version, the script's, takes exp(bf16(s)): two
# bf16 roundings of different arguments (read 6.3e-3 to 6.5e-3), held at
# BF16_EXP_REL_L2 and, so that an fp32 exp cannot pass for it, farther than
# PROBE_REL_L2 from the fp32-exp plain version.  P1 with pv_int8 has integer
# P V sums: they equal the plain version's except where p / l * 127 lies
# within p1_tie(Nk) of a .5 step boundary, so o is held per element to the
# int8 steps those ties can move and the bf16 roundings of both outputs (two
# each: of the sum / 127, then of its product with the bf16 v scale, each
# within 2^-8 of the value: together within 2^-7 (1 + 2^-7) of the output).
PROBE_REL_L2, BF16_EXP_REL_L2, LSE_ABS = 1e-3, 8e-3, 1e-4


def p1_tie(nk: int) -> float:
    """The most p / l * 127 can differ, relatively, between P1's kernel and
    its plain version, in fp32 units: the kernel's row sum adds Nk / 4 values
    in sequence in each lane and then 2 across lanes (torch's sum is nearer),
    __expf is within 2 + 1.173 |x| units of exp(x) for x <= 75 (torch's
    within 1), and the division and the * 127 round once each on both sides."""
    return (nk // 4 + 2 + 91 + 1 + 4) * 2.0**-24


# off the main path, held to the plain versions in phase 2
OFF_PATH = (("flash_fwd", (2, 5, 1024, 1024, 128)), ("flash_fwd", (2, 5, 1088, 1088, 64)),
            ("conv3x3", (2, 32, 64, 72, 64)))
# KI2 off the main path, held to the plain version in phase 2i: 1000 rows (a
# ragged row tile) and K = 320 (a 64-byte K tail); 200 rows, whose few tiles
# split K over a 2-block cluster (no UNet site does)
OFF_PATH_DENSE = ((1000, 320, 640), (200, 1280, 640))
# the backward kernels off the main path, held to the plain versions in phase
# 2t: head dim 128, a 64-row tail past a multiple of 128, Nq != Nk with tails
OFF_PATH_BWD = ((2, 5, 1024, 1024, 128), (2, 5, 1088, 1088, 64), (2, 5, 576, 1216, 64))


def ptxas_report(log: str, kernel: str) -> list[str]:
    """ptxas's report (``-Xptxas -v`` in the build log) for each template
    instantiation of ``kernel``: registers, barriers, stack and spills."""
    lines, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = entry.group(1) if kernel in entry.group(1) else None
            if current:
                args = ",".join(re.findall(r"L[ib](\d+)E", current))
                lines.append(f"{kernel}<{args}>:")
        elif current and ("stack frame" in line or "Used" in line):
            lines[-1] += " " + line.split(":", 1)[-1].strip() + ";"
    return lines


def check_plan(name: str, shape: tuple) -> str:
    """K3's or KI3's launch plan as ``mlp.geglu_plan`` mirrors it, held to
    the launchers' own (down tile and shared memory); returns its reading."""
    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.ops import mlp

    lib = kernels.library()
    int8 = name == "geglu_int8"
    tile, smem = (lib.lr_geglu_int8_tile, lib.lr_geglu_int8_smem) if int8 else (lib.lr_geglu_tile, lib.lr_geglu_smem)
    plan = mlp.geglu_plan(*shape[:4], torch.cuda.get_device_properties(0).multi_processor_count,
                          chunk=shape[4] if int8 else None)
    up, down = plan["up"], plan["down"]
    bn = tile(shape[0], shape[3])
    if (bn, smem(0, 0), smem(1, bn)) != (down["tile"][1], up["smem"], down["smem"]):
        raise SystemExit(f"{name} {shape}: the plan mirror {plan} differs from the launcher's "
                         f"(tile {bn}, shared memory {smem(0, 0)} / {smem(1, bn)})")
    return (f"up_grid={up['grid'] or 'persistent'} up_items={up['items']} up_cluster={up['cluster']} "
            f"down_tile={down['tile']} down_grid={down['grid']} smem={up['smem']}/{down['smem']}")


def check_conv_int8_plan(shape: tuple) -> str:
    """KI1's launch plan as ``quant.conv3x3_int8_plan`` mirrors it, held to
    the launcher's own (``lr_conv3x3_int8_plan``); returns its reading."""
    import ctypes

    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.ops import quant

    got = (ctypes.c_int * 5)()
    kernels.check(kernels.library().lr_conv3x3_int8_plan(*shape, ctypes.addressof(got)), "conv3x3_int8 plan")
    plan = quant.conv3x3_int8_plan(*shape, torch.cuda.get_device_properties(0).multi_processor_count)
    if tuple(got) != (plan["tile"][1], plan["splits"], *plan["patch"], plan["smem"]):
        raise SystemExit(f"conv3x3_int8 {shape}: the plan mirror {plan} differs from the launcher's {tuple(got)}")
    return (f"tile={plan['tile']} patch={plan['patch']} grid={plan['grid']} cluster={plan['cluster']} "
            f"smem={plan['smem']}")


def check_dense_int8_plan(shape: tuple) -> str:
    """KI2's launch plan as ``quant.dense_int8_res_plan`` mirrors it, held
    to the launcher's own (``lr_dense_int8_res_plan``); returns its reading."""
    import ctypes

    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.ops import quant

    got = (ctypes.c_int * 4)()
    kernels.check(kernels.library().lr_dense_int8_res_plan(*shape, ctypes.addressof(got)), "dense_int8_res plan")
    plan = quant.dense_int8_res_plan(*shape, torch.cuda.get_device_properties(0).multi_processor_count)
    if tuple(got) != (*plan["tile"], plan["splits"], plan["smem"]):
        raise SystemExit(f"dense_int8_res {shape}: the plan mirror {plan} differs from the launcher's {tuple(got)}")
    return f"tile={plan['tile']} grid={plan['grid']} cluster={plan['cluster']} smem={plan['smem']}"


def check_graph_replay(name: str, shape: tuple, gen, label: str) -> None:
    """One launch of a kernel captured in a CUDA graph and replayed gives the
    bits of an eager launch on the same inputs."""
    import torch

    from leftrefill_torch import tools

    site = tools.site_args(name, shape, gen)
    run = tools.KERNEL_FNS[name][0]
    eager = run(*site)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run(*site)
    graph.replay()
    torch.cuda.synchronize()
    pairs = list(zip(eager, captured)) if isinstance(eager, tuple) else [(eager, captured)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise SystemExit(f"phase {label} {name} {shape}: the CUDA-graph replay differs from the eager launch")
    print(f"phase {label} {name} shape={shape}: captured in a CUDA graph, replayed bit-equal to the eager launch")


def check_bit_equal(name: str, shape: tuple, gen, label: str) -> None:
    """Two launches of one kernel on the same inputs give the same bits."""
    import torch

    from leftrefill_torch import tools

    site = tools.site_args(name, shape, gen)
    first, second = (tools.KERNEL_FNS[name][0](*site) for _ in range(2))
    if not torch.equal(first, second):
        raise SystemExit(f"phase {label} {name} {shape}: two launches differ")
    print(f"phase {label} {name} shape={shape}: two launches bit-equal")


def compare(name: str, got, ref) -> tuple[str, float]:
    """Hold one kernel output to its plain version's; returns (the bound's
    reading, max abs difference) or exits."""
    import torch

    from leftrefill_torch.tools import bf16_ulps, rel_l2

    if name in PROLOGUES:  # xq; (xq, scale); or (xn, xq, scales)
        (gn, gq, gs), (rn, rq, rs) = ((None, o, None) if not isinstance(o, tuple) else o if len(o) == 3
                                      else (None, *o) for o in (got, ref))
        steps = (gq.to(torch.int32) - rq.to(torch.int32)).abs()
        share = float((steps > 0).float().mean())
        if int(steps.max()) > 1 or share > STEP_SHARE:
            raise SystemExit(f"{name}: int8 values {int(steps.max())} steps apart on {share:.2e} of them")
        reading = f"steps<=1 on {share:.2e}"
        if gs is not None:
            ulp = torch.nextafter(rs.abs(), torch.full_like(rs, float("inf"))) - rs.abs()
            ulps = float(((gs - rs).abs() / ulp).max())
            if ulps > SCALE_ULPS:
                raise SystemExit(f"{name}: scales {ulps:.0f} ulps apart")
            reading += f" scale_ulps={ulps:.0f}"
        if gn is not None:
            d = float((gn.float() - rn.float()).abs().max() / rn.float().abs().max())
            if d > NORM_MAX_REL:
                raise SystemExit(f"{name}: bf16 output {d:.3e} of its max apart ({bf16_ulps(gn, rn)} ulps)")
            reading += f" norm_max_rel={d:.3e} norm_ulps={bf16_ulps(gn, rn)}"
        return reading, float(steps.max())
    if isinstance(got, tuple):  # dk and dv: each held to the bound
        readings = [compare(name, g, r) for g, r in zip(got, ref)]
        return " ".join(r for r, _ in readings), max(m for _, m in readings)
    if not torch.isfinite(got).all():
        raise SystemExit(f"{name}: non-finite output")
    err, mae = rel_l2(got, ref), float((got.float() - ref.float()).abs().max())
    if name in ULPS:
        ulps = bf16_ulps(got, ref)
        if ulps > ULPS[name]:
            raise SystemExit(f"{name}: {ulps} bf16 ulps from the plain version > {ULPS[name]}")
        return f"ulps={ulps} rel_l2={err:.3e}", mae
    if err > REL_L2[name]:
        raise SystemExit(f"{name}: rel L2 {err:.3e} > {REL_L2[name]}")
    return f"rel_l2={err:.3e}", mae


def compare_backward(name: str, site: tuple, got, ref) -> tuple[str, float]:
    """Hold a backward kernel's dq, or dk and dv, to the plain version's
    outside the rows that a score within a rounding of the clamp at 75
    reaches (``tools.clamp_straddles``: dq's query rows and dk's key rows of
    those scores; dv does not see the mask), each within ``REL_L2``.  Also
    reads every row: as they are, and with each straddling score's dS term
    put on the side of the clamp the kernel's row shows
    (``tools.kernel_side``); the latter must hold too, which locates every
    difference past the bound at those scores.  Returns (the readings, max
    abs difference of the held rows) or exits."""
    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.tools import rel_l2

    q, _, _, _, _, _, heads, scale = site
    idx, s = tools.clamp_straddles(q, site[1], heads, scale)
    dq_term, dk_term, kept = tools.straddle_terms(*site, idx, s)
    d = q.shape[2] // heads
    if name == "flash_bwd_dq":
        parts = [("dq", got, ref, idx[:, 2], dq_term)]
    else:
        parts = [("dk", got[0], ref[0], idx[:, 3], dk_term), ("dv", got[1], ref[1], None, None)]
    readings, mae = [f"straddling_scores={len(idx)}"], 0.0
    for label, g, r, rows, terms in parts:
        if not torch.isfinite(g).all():
            raise SystemExit(f"{name} {label}: non-finite output")
        gm, rm = g.float().clone(), r.float().clone()
        if rows is not None:
            for b, n, h in zip(idx[:, 0].tolist(), rows.tolist(), idx[:, 1].tolist()):
                gm[b, n, h * d:(h + 1) * d] = rm[b, n, h * d:(h + 1) * d] = 0.0
        err, every = rel_l2(gm, rm), rel_l2(g, r)
        reading = f"{label}_rel_l2={err:.3e}"
        if rows is not None:
            side, moved = tools.kernel_side(g, r, idx[:, 0], rows, idx[:, 1], terms, kept)
            at_side = rel_l2(g, side)
            reading += (f" (rows out: {len(set(zip(idx[:, 0].tolist(), rows.tolist(), idx[:, 1].tolist())))}) "
                        f"{label}_rel_l2_every_row={every:.3e} terms_on_the_other_side={len(moved)} "
                        f"{label}_rel_l2_kernel_side={at_side:.3e}")
            if moved:  # each moved score: the plain version's fp32 sum and the fp64 one, in fp32 ulps of 75
                exact = tools.exact_scores(q, site[1], heads, scale, idx[moved])
                reading += " moved=" + ",".join(
                    f"{tuple(idx[i].tolist())}:plain_s={float(s[i]):.7f}({(float(s[i]) - 75) / 2**-17:+.1f}ulp)"
                    f"/fp64_s={float(e):.9f}({(float(e) - 75) / 2**-17:+.2f}ulp)"
                    for i, e in zip(moved, exact))
            err = max(err, at_side)
        if err > REL_L2[name]:
            raise SystemExit(f"{name}: {reading} > {REL_L2[name]}")
        readings.append(reading)
        mae = max(mae, float((gm - rm).abs().max()))
    return " ".join(readings), mae


def check_site(name: str, shape: tuple, gen, n_sites: int, report: dict, label: str) -> None:
    """One kernel site: kernel against plain version, both timed with the
    library call where one exists, the bound beside them."""
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.tools import cuda_ms

    site = tools.site_args(name, shape, gen)
    run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
    got, ref = run(), plain()
    torch.cuda.synchronize()
    reading, mae = compare_backward(name, site, got, ref) if name in BWD_NAMES else compare(name, got, ref)
    ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
    library = tools.library_fn(name, site)
    # a composition of calls (tools.COMPOSED) is a yardstick, not a library time
    composed = name in tools.COMPOSED
    library_ms = None if library is None else cuda_ms(library, 20)
    composition_ms, library_ms = (library_ms, None) if composed else (None, library_ms)
    bound, bound_by = tools.bound_ms(name, shape)
    if name == "conv3x3":  # the launch plan's output channels per block
        reading += f" channels_per_block={kernels.library().lr_conv3x3_tile(*shape[:3], shape[4])}"
    if name == "conv3x3_int8":
        reading += " " + check_conv_int8_plan(shape)
    elif name == "dense_int8_res":
        reading += " " + check_dense_int8_plan(shape)
    elif composed:
        reading += " " + check_plan(name, shape)
    print(f"phase {label} {name} shape={shape} sites={n_sites} {reading} max_abs_err={mae:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
          f"bound_share={bound / ms:.3f} library_ms={'none' if library_ms is None else f'{library_ms:.4f}'}"
          f"{'' if library_ms is None else f' kernel_over_library={ms / library_ms:.2f}'}"
          f"{'' if composition_ms is None else f' composition_ms={composition_ms:.4f} kernel_over_composition={ms / composition_ms:.2f}'}")
    r = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                 "library_ms": None if library_ms is None else 0.0, "sites": 0,
                                 "bound_ops_ms": 0.0, **({"composition_ms": 0.0} if composed else {})})
    r["max_abs_err"] = max(r["max_abs_err"], mae)
    r["ms"] += n_sites * ms
    r["plain_ms"] += n_sites * plain_ms
    r["bound_ms"] += n_sites * bound
    r["bound_ops_ms"] += n_sites * bound * (bound_by == "operations")
    if library_ms is not None:
        r["library_ms"] += n_sites * library_ms
    if composition_ms is not None:
        r["composition_ms"] += n_sites * composition_ms
    r["sites"] += n_sites


def probe_sites(gen) -> list:
    """Phase 2p's sites: (kernel, shape, the arguments it is held on, those it
    is timed on), every probe at every ``PROBE_SHAPES`` shape and P5 on its
    tile (``tools.site_args``: normal draws; P1's q with std ``P1_Q_STD``;
    the identity-exp variant held on |q| and |k|)."""
    from leftrefill_torch import tools
    from leftrefill_torch.ops import probes

    sites = []
    for b, h, n in PROBE_SHAPES:
        for pv_int8 in (False, True):
            shape = (b, h, n, n, 64, pv_int8)
            q, *rest = tools.site_args("flash_int8", shape, gen)
            args = ((q.float() * P1_Q_STD).to(q.dtype), *rest)
            sites.append(("flash_int8", shape, args, args))
        for variant in probes.built_variants():
            shape = (b, h, n, n, 64, *variant)
            args = tools.site_args("flash_variant", shape, gen)
            held = (args[0].abs(), args[1].abs(), *args[2:]) if variant[0] == "identity" else args
            sites.append(("flash_variant", shape, held, args))
    args = tools.site_args("noop", PROBE_TILE, gen)
    sites.append(("noop", PROBE_TILE, args, args))
    return sites


def p1_tie_bound(q, k, v, scale: float):
    """Per element of P1's pv_int8 output, the most it can move between two
    computations of p / l that differ by a relative p1_tie(Nk): the int8 P V sums
    over the keys whose p / l * 127 lies that close to a .5 step boundary, of
    |vq|, times the (bf16) v scale over 127."""
    import torch

    from leftrefill_torch.ops import probes

    qi, sq, ki, sk, vq, sv = probes.int8_operands(q, k, v, True)
    kt, va = ki.to(torch.float32).transpose(-1, -2), vq.to(torch.float32).abs()
    tie, out, chunk = p1_tie(ki.shape[1]), [], 1024
    for q0 in range(0, qi.shape[1], chunk):
        rows = slice(q0, q0 + chunk)
        p, l = probes.int8_probs(qi[:, rows], sq[:, rows], kt, sk, scale)
        r = p / l * 127.0
        out.append(torch.matmul(((r - r.floor() - 0.5).abs() <= tie * r).to(torch.float32), va))
    return (torch.cat(out, dim=1) * (sv.to(torch.bfloat16).float() / 127.0)).reshape(q.shape)


def compare_probe(name: str, shape: tuple, held: tuple, got, ref) -> tuple[str, float]:
    """Hold one probe's output to its plain version's (PROBE_REL_L2 or
    BF16_EXP_REL_L2, LSE_ABS, or P1's per-element tie bound); returns (the
    reading, max abs difference) or exits."""
    import torch

    from leftrefill_torch.ops import probes
    from leftrefill_torch.tools import rel_l2

    (o, lse), (ro, rlse) = (x if isinstance(x, tuple) else (x, None) for x in (got, ref))
    if not (torch.isfinite(o).all() and o.shape == ro.shape):
        raise SystemExit(f"phase 2p {name} {shape}: non-finite output or shape {tuple(o.shape)}")
    err, diff = rel_l2(o, ro), (o.float() - ro.float()).abs()
    reading = f"rel_l2={err:.3e}"
    if name == "flash_int8" and shape[5]:
        q, k, v, scale, _ = held
        bound = p1_tie_bound(q, k, v, scale)
        allowed = bound + 2.0**-7 * (1 + 2.0**-7) * (o.float().abs() + ro.float().abs())
        over = diff > allowed
        if over.any():
            raise SystemExit(f"phase 2p {name} {shape}: {int(over.sum())} values past the tie bound, by up to "
                             f"{float((diff - allowed).max()):.3e} (tie bound there {bound[over].tolist()[:8]}, "
                             f"differences {diff[over].tolist()[:8]}, v scale {float(held[2].float().abs().max()) / 127:.3e})")
        reading += (f" tie_rows_share={float((bound.amax(-1) > 0).float().mean()):.2e} "
                    f"most_of_bound={float((diff / allowed.clamp_min(1e-30)).max()):.3f} "
                    f"moved_share={float((diff > 0).float().mean()):.2e} (limit: the tie bound)")
    elif name == "flash_variant" and shape[5] == "bf16":
        q, k, v, scale, _, clamp, lse_store, rows = held
        f32 = probes.flash_variant_plain(q, k, v, scale, exp="f32", clamp=clamp, lse=lse_store, rows=rows)
        err_f32 = rel_l2(o, f32[0] if lse_store else f32)
        if not (PROBE_REL_L2 < err_f32 and err <= BF16_EXP_REL_L2):
            raise SystemExit(f"phase 2p {name} {shape}: rel L2 {err:.3e} (limit {BF16_EXP_REL_L2}), "
                             f"{err_f32:.3e} from the fp32 exp (must pass {PROBE_REL_L2})")
        reading += f" rel_l2_from_fp32_exp={err_f32:.3e}"
    elif err > PROBE_REL_L2:
        raise SystemExit(f"phase 2p {name} {shape}: rel L2 {err:.3e} > {PROBE_REL_L2}")
    if lse is not None:
        lse_err = float((lse - rlse).abs().max())
        if not lse_err <= LSE_ABS:
            raise SystemExit(f"phase 2p {name} {shape}: lse max abs {lse_err:.3e} > {LSE_ABS}")
        reading += f" lse_max_abs={lse_err:.3e}"
    return reading, float(diff.max())


def check_probe(name: str, shape: tuple, held: tuple, timed_args: tuple, got, report: dict) -> None:
    """One probe site: the kernel's output (from the probes' run) against its
    plain version, then the kernel timed in device ms beside its bound, its
    plain version and the library call where one exists."""
    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.ops import probes
    from leftrefill_torch.tools import cuda_ms
    from leftrefill_torch.tools.library_baselines import device_ms

    run, plain = tools.KERNEL_FNS[name]
    ref = plain(*held)
    torch.cuda.synchronize()
    if name == "noop":
        if not torch.equal(got, ref):
            raise SystemExit(f"phase 2p noop {shape}: differs from x + 1")
        reading, mae = "bit-equal", 0.0
    else:
        reading, mae = compare_probe(name, shape, held, got, ref)
    if name == "flash_int8":  # the quantization on the card against the CPU's, on the same inputs
        q, k, v, _, pv_int8 = held
        card = probes.int8_operands(q, k, v, pv_int8)
        cpu = probes.int8_operands(q.cpu(), k.cpu(), v.cpu(), pv_int8)
        if not all(a is None and b is None or torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
            raise SystemExit(f"phase 2p flash_int8 {shape}: the card's codes or scales differ from the CPU's")
        reading += f" codes_and_scales=equal_to_cpu o_nonzero_share={float((ref != 0).float().mean()):.3f}"
    if name == "flash_variant" and shape[5] == "identity":
        reading += " (held on |q|, |k|; timed on normal draws)"
    ms = device_ms(functools.partial(run, *timed_args), 5, kernel=PROBE_KERNEL[name])
    plain_ms = cuda_ms(functools.partial(plain, *timed_args), 1, warmup=0)
    library = tools.library_fn(name, timed_args)
    library_ms = None if library is None else device_ms(library, 5)
    bound, bound_by = tools.bound_ms(name, shape)
    print(f"phase 2p {name} shape={shape} {reading} max_abs_err={mae:.3e} kernel_device_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}) bound_share={bound / ms:.3f} library_ms="
          f"{'none' if library_ms is None else f'{library_ms:.4f} kernel_over_library={ms / library_ms:.2f}'}",
          flush=True)
    r = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_ops_ms": 0.0,
                                 "library_ms": None, "ms_where_library": None, "sites": []})
    r["max_abs_err"] = max(r["max_abs_err"], mae)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += bound
    r["bound_ops_ms"] += bound * (bound_by == "operations")
    if library_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
        r["ms_where_library"] = (r["ms_where_library"] or 0.0) + ms
    r["sites"].append({"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "library_ms": library_ms, "max_abs_err": mae})


def check_probes(gen, launches: dict) -> dict:
    """Phase 2p: the probes' path (each wrapper once a site, the counts set to
    0 just before and read just after into ``launches["probes"]``), then each
    site held and timed (``check_probe``); returns the per-kernel report."""
    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.ops import probes

    sites = probe_sites(gen)
    tools.reset_launches()
    outs = [tools.KERNEL_FNS[name][0](*held) for name, _, held, _ in sites]
    torch.cuda.synchronize()
    launches["probes"] = tools.launches()
    want = {n: sum(1 for site in sites if site[0] == n) for n in tools.PROBES}
    if launches["probes"] != {n: want.get(n, 0) for n in launches["probes"]}:
        raise SystemExit(f"phase 2p: launches {launches['probes']}, expected {want} and no other")
    print(f"phase 2p probes' path: launches={want}", flush=True)
    report = {}
    for (name, shape, held, timed_args), got in zip(sites, outs):
        check_probe(name, shape, held, timed_args, got, report)
    del outs
    q, k, v, scale = sites[0][2][:4]
    try:
        probes.flash_variant(q, k, v, scale, exp="bf16", lse=False, rows=512)
    except RuntimeError as e:
        print(f"phase 2p flash_variant rows=512 (the scripts' blk_q 512): refused by the kernel's entry ({e}); "
              f"no counterpart: 8 consumer warpgroups of 64 rows and a producer warp are 1056 threads > 1024")
    else:
        raise SystemExit("phase 2p: a 512-row variant was launched; none is built")
    return report


def check_kernels(sites: dict, gen, report: dict, label: str, names) -> None:
    """Every site of the kernels ``names`` in one forward's ``sites``
    ({(kernel, shape): launches}, from ``tools.unet_sites``)."""
    for (name, shape), n_sites in sorted(sites.items()):
        if name in names:
            check_site(name, shape, gen, n_sites, report, label)


def check_sites(report: dict, per_forward: dict, label: str) -> None:
    for name, n in per_forward.items():
        got = report.get(name, {}).get("sites", 0)
        if got != n:
            raise SystemExit(f"{label} {name}: {got} sites per forward, expected {n}")


def check_forward(unet, x, tsteps, ctx, kv, label: str, names, cfg_dup: bool = True, **kwargs):
    """One full-width forward through the kernels against the same forward
    with the kernels ``names`` routed to their plain versions (``kwargs``:
    the NVS UNet's c_input)."""
    import torch

    from leftrefill_torch import kernels
    from leftrefill_torch.tools import cuda_ms, rel_l2

    fwd = lambda: unet(x, tsteps, ctx, cross_kv=kv, cfg_dup=cfg_dup, **kwargs)
    out_k = fwd()
    with kernels.plain_kernels(names):
        out_p = fwd()
        plain_fwd_ms = cuda_ms(fwd, 1)
    kern_fwd_ms = cuda_ms(fwd, 3)
    err = rel_l2(out_k, out_p)
    if not (out_k.shape == (*x.shape[:3], 4) and torch.isfinite(out_k).all() and err <= UNET_REL_L2):
        raise SystemExit(f"{label} UNet forward: rel L2 {err:.3e} > {UNET_REL_L2} or bad output")
    return out_k, out_p, err, kern_fwd_ms, plain_fwd_ms


def serve(model, sampler: str, steps: int, per_forward: dict, label: str) -> dict:
    """Two timed requests after a warm-up; the canvases and the launch counts
    per UNet forward are checked.  Returns the launch counts."""
    import torch

    from leftrefill_torch import tools

    pipe = tools.serving_pipeline(model, sampler=sampler, steps=steps)
    image, mask = tools.request_canvas()
    pipe(image, mask, torch.Generator("cuda").manual_seed(99))  # warm-up request
    torch.cuda.synchronize()
    tools.reset_launches()
    outs, secs = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        outs.append(pipe(image, mask, torch.Generator("cuda").manual_seed(seed)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = tools.launches()
    forwards = 2 * steps  # one CFG-doubled UNet forward per step (DDIM and DPM++(2M) alike)
    img = torch.as_tensor(image, device="cuda")
    for o in outs:
        if o.shape != (1, 512, 1024, 3) or not torch.isfinite(o).all():
            raise SystemExit(f"{label}: request output has the wrong shape or is not finite")
        if not torch.equal(o[:, :, :512], img[:, :, :512]):
            raise SystemExit(f"{label}: left half of the canvas is not the input")
    if torch.equal(outs[0], outs[1]):
        raise SystemExit(f"{label}: two seeds gave the same canvas")
    check_launches(launches, per_forward, forwards, label)
    print(f"{label}: seconds_per_request={[round(s, 3) for s in secs]} launches={launches} "
          f"unet_forwards={forwards}")
    return launches


def check_launches(launches: dict, per_forward: dict, forwards: int, label: str) -> None:
    for name, n in per_forward.items():
        if launches[name] != n * forwards:
            raise SystemExit(f"{label}: {name} {launches[name]} launches, expected {n} x {forwards}")


def serve_multiview(model, per_forward: dict, label: str) -> dict:
    """A short warm-up scene, then two V-view scenes of DDIM-50 with their
    own seeds; outputs and launch counts per forward checked."""
    import torch

    from leftrefill_torch import tools

    images, masks = tools.multiview_scene(VIEWS)
    tools.multiview_pipeline(model, VIEWS, steps=2)(images, masks, torch.Generator("cuda").manual_seed(99))
    torch.cuda.synchronize()
    pipe = tools.multiview_pipeline(model, VIEWS, steps=50)
    tools.reset_launches()
    outs, secs = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        outs.append(pipe(images, masks, torch.Generator("cuda").manual_seed(seed)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = tools.launches()
    img, keep = torch.as_tensor(images, device="cuda"), torch.as_tensor(masks, device="cuda") == 0
    for o in outs:
        if o.shape != images.shape or not torch.isfinite(o).all():
            raise SystemExit(f"{label}: scene output has the wrong shape or is not finite")
        if not torch.equal(o[keep.expand_as(o)], img[keep.expand_as(img)]):
            raise SystemExit(f"{label}: a view changed where its mask is 0")
    if torch.equal(outs[0], outs[1]):
        raise SystemExit(f"{label}: two seeds gave the same views")
    check_launches(launches, per_forward, 2 * pipe.ddim_steps, label)
    print(f"{label}: seconds_per_scene={[round(s, 3) for s in secs]} launches={launches} "
          f"unet_forwards={2 * pipe.ddim_steps}")
    return launches


def train_steps(step, state, batch, steps: int, per_step: dict, sites: dict, label: str):
    """A warm-up step with its backward kernel sites recorded and checked
    against ``sites``, then ``steps`` timed steps with their kernel launches
    checked against ``per_step``.  Returns (state, the losses, seconds per
    timed step, the timed steps' launches)."""
    import torch
    from collections import Counter

    from leftrefill_torch import kernels, tools

    gen = torch.Generator("cuda").manual_seed(7)
    with kernels.record_sites() as recorded:
        state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    for name in BWD_NAMES:
        got = dict(Counter(shape for n, shape in recorded if n == name))
        if got != sites:
            raise SystemExit(f"{label}: {name} sites per step {got}, expected {sites}")
    losses = [float(metrics["loss"])]
    tools.reset_launches()
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))  # reads the loss back: the step has ended
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = tools.launches()
    check_launches(launches, per_step, steps, label)
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"{label}: non-finite loss {losses}")
    return state, losses, secs, launches


def nvs_phases(gen, launches: dict) -> tuple[dict, dict]:
    """Phases 2n, 3n, 9, 9s and 9l (the novel-view-synthesis slice): the
    launch counts of its paths go into ``launches``; returns the per-kernel
    reports of the NVS forward's sites, of the sites the separator columns
    add and of those four poses in one request add."""
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.diffusion.structure_ddim import structure_ddim_sample
    from leftrefill_torch.models.lora import default_target, init_lora
    from leftrefill_torch.models.nvs import NVSUnetModel
    from leftrefill_torch.ops import attention, mlp
    from leftrefill_torch.ops.quant import quantize_params_like
    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle, build_sd2_nvs_bundle, fill_random_
    from leftrefill_torch.runtime import LoraAdapterStore
    from leftrefill_torch.tasks import NVSTask

    t0 = time.perf_counter()
    bundle = build_sd2_nvs_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), refinement=True)
    with torch.device("meta"):
        sep_unet = NVSUnetModel(dtype=torch.bfloat16, use_sep=True)
    sep_unet = sep_unet.to_empty(device="cuda").eval()
    fill_random_(sep_unet, torch.Generator("cuda").manual_seed(0))
    model, unet = bundle.model, bundle.model.unet
    task = NVSTask(bundle)
    req = tools.nvs_request(bundle.tokenizer, 1)
    torch.cuda.synchronize()
    print(f"phase 2n set-up: NVS bundle (73 prompt tokens, hybrid-refine, refinement branch on, refinement_alpha="
          f"{float(model.refinement_alpha.detach()):.4f}) and the use_sep UNet (separator widths "
          f"{sep_unet._sep_channel_set()}) in {time.perf_counter() - t0:.1f} s")

    # ---- phase 2n: K1, K2, K3 at the NVS forward's shapes ------------------
    report, sep_report, b4_report = {}, {}, {}
    with torch.inference_mode():
        cond = task.build_cond(req)
        uc = model.cond_stage_model(torch.as_tensor(task.uncond_tokens(1), device="cuda").long())
        z = torch.randn((1, 32, 64, 4), generator=gen, device="cuda")
        x = torch.cat([z, cond.c_concat], dim=-1).to(torch.bfloat16).repeat(2, 1, 1, 1)  # the CFG halves equal
        ts = torch.full((2,), 981, dtype=torch.long, device="cuda")
        ctx, c_input = torch.cat([uc, cond.c_crossattn]), cond.c_input.repeat(2, 1, 1, 1)
        kv, sep_kv = unet.cross_kv(ctx), sep_unet.cross_kv(ctx)
        sites = tools.unet_sites(unet, x, ts, ctx, kv, True, c_input=c_input)
        check_kernels(sites, gen, report, "2n", BF16_NAMES)
        check_sites(report, {n: tools.PER_FORWARD_NVS[n] for n in BF16_NAMES}, "nvs")
        sep_sites = tools.unet_sites(sep_unet, x, ts, ctx, sep_kv, True, c_input=c_input)
        per_forward = {n: sum(c for (name, _), c in sep_sites.items() if name == n) for n in tools.LAUNCH_COUNTERS}
        if per_forward != tools.PER_FORWARD_NVS_SEP:
            raise SystemExit(f"phase 2n use_sep: sites per forward {per_forward}")
        # the shapes four poses in one request add (CFG batch 8)
        sites4 = tools.unet_sites(unet, x.repeat(4, 1, 1, 1), ts.repeat(4), ctx.repeat(4, 1, 1), unet.cross_kv(
            ctx.repeat(4, 1, 1)), True, c_input=c_input.repeat(4, 1, 1, 1))
        check_kernels({k: c for k, c in sites4.items() if k not in sites}, gen, b4_report, "2n batch 4", BF16_NAMES)
        # the shapes the separator columns add (K2 at the 65- and 33-wide levels)
        check_kernels({k: c for k, c in sep_sites.items() if k not in sites}, gen, sep_report, "2n use_sep",
                      BF16_NAMES)
        probe = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="cuda")  # noqa: E731
        refused = [n for n in (2080, 528) if not attention.flash_qualifies(probe(2, n, 320), probe(2, n, 320), 5)]
        refused_rows = [r for r, d in ((4160, 320), (1056, 640), (272, 1280))
                        if not mlp.geglu_fused_qualifies(probe(r, d), d, 4 * d, d)]
        if refused != [2080, 528] or refused_rows != [4160, 1056, 272]:
            raise SystemExit(f"phase 2n use_sep: K1 refuses {refused} tokens, K3 {refused_rows} rows")
        print(f"phase 2n use_sep: K1 refuses the {refused}-token sequences and K3 the {refused_rows}-row sites "
              f"(no multiples of 128: the exact softmax and the plain GEGLU run there, as in JAX); "
              f"sites per forward { {k: v for k, v in per_forward.items() if v} }")
        for r, d in ((4160, 320), (1056, 640), (272, 1280)):  # the plan mirror where K3 is refused
            print(f"phase 2n use_sep geglu plan at {(r, d, 4 * d, d)} (not launched): "
                  f"{check_plan('geglu', (r, d, 4 * d, d))}")

        # ---- phase 3n: the full-width NVS forward, kernels vs plain --------
        for label, u, kv_, want in (("use_sep=False", unet, kv, tools.PER_FORWARD_NVS),
                                    ("use_sep=True", sep_unet, sep_kv, tools.PER_FORWARD_NVS_SEP)):
            _, _, err, kern_ms, plain_ms = check_forward(u, x, ts, ctx, kv_, f"nvs {label}", kernels.NAMES,
                                                         c_input=c_input)
            tools.reset_launches()
            u(x, ts, ctx, cross_kv=kv_, cfg_dup=True, c_input=c_input)
            torch.cuda.synchronize()
            got = tools.launches()
            if got != want:
                raise SystemExit(f"phase 3n {label}: launches per forward {got}, expected {want}")
            print(f"phase 3n unet forward [2,32,64,9] bf16 NVS {label} cfg_dup cross_kv c_input: rel_l2={err:.3e} "
                  f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f} "
                  f"launches={ {k: v for k, v in got.items() if v} }")
        del sep_unet, sep_kv

    # ---- phase 9: NVS serving at 256x512 -----------------------------------
    label = "phase 9 serving NVS 256x512 bf16 ddim50 eta1 cfg2.5"
    serve_kw = dict(ddim_steps=50, ddim_eta=1.0, unconditional_guidance_scale=2.5)
    task.log_images(req, **{**serve_kw, "ddim_steps": 2}, generator=torch.Generator("cuda").manual_seed(99))
    torch.cuda.synchronize()
    tools.reset_launches()
    outs, secs = [], []
    for seed in (1, 2):
        t0 = time.perf_counter()
        outs.append(task.log_images(req, **serve_kw, generator=torch.Generator("cuda").manual_seed(seed))["pred"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches["nvs_ddim50"] = tools.launches()
    check_launches(launches["nvs_ddim50"], tools.PER_FORWARD_NVS, 100, label)
    # four target poses of one reference in one call; one x_T and one noise
    # draw shared by the four rows, so the rows differ by their pose alone
    req4 = tools.nvs_request(bundle.tokenizer, 4)
    g4 = torch.Generator("cuda").manual_seed(3)
    x4 = torch.randn((1, 32, 64, 4), generator=g4, device="cuda").repeat(4, 1, 1, 1)
    noise4 = lambda i, shape: torch.randn((1, *shape[1:]), generator=g4, device="cuda").repeat(shape[0], 1, 1, 1)  # noqa: E731
    tools.reset_launches()
    t0 = time.perf_counter()
    out4 = task.log_images(req4, **serve_kw, x_T=x4, noise_fn=noise4)["pred"]
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    launches["nvs_ddim50_4poses"] = tools.launches()
    check_launches(launches["nvs_ddim50_4poses"], tools.PER_FORWARD_NVS_B4, 50, label)
    for o, b in ((outs[0], 1), (outs[1], 1), (out4, 4)):
        if o.shape != (b, 256, 512, 3) or not torch.isfinite(o).all() or float(o.abs().max()) > 1.0:
            raise SystemExit(f"{label}: output {tuple(o.shape)} not finite or outside [-1, 1]")
    if torch.equal(outs[0], outs[1]):
        raise SystemExit(f"{label}: two seeds gave the same view")
    pose_gaps = [float((out4[i] - out4[j]).abs().max()) for i in range(4) for j in range(i + 1, 4)]
    if min(pose_gaps) == 0:
        raise SystemExit(f"{label}: two poses gave the same view")
    print(f"{label}: seconds_per_request={[round(x, 3) for x in secs[:2]]} (batch 1) {secs[2]:.3f} (batch 4, four "
          f"poses) min_pose_gap={min(pose_gaps):.3e} launches={launches['nvs_ddim50']} (100 forwards), "
          f"{launches['nvs_ddim50_4poses']} (50 forwards, CFG batch 8: K3 also at the middle block's 256 rows)")

    # ---- phase 9s: the structure sampler, 10 steps, Tm 3 -------------------
    with torch.inference_mode():
        cond = task.build_cond(req)
        tokens = torch.as_tensor(req["tokens"], device="cuda").long()
        simple = Conditioning(cond.c_concat, model.cond_stage_model(tokens), cond.c_input)  # the prompt without the pose
        uncond = Conditioning(cond.c_concat, uc, cond.c_input)
        kv3 = model.cross_attention_kv(torch.cat([uncond.c_crossattn, cond.c_crossattn, simple.c_crossattn]))
        kv1 = model.cross_attention_kv(simple.c_crossattn)
        apply_fn = lambda x_, t_, c_: model.apply_model(x_, t_, c_, cross_kv=kv3 if x_.shape[0] == 3 else kv1)  # noqa: E731
        tools.reset_launches()
        t0 = time.perf_counter()
        zs = structure_ddim_sample(apply_fn, model.schedule, model.schedule.ddim_tables(10, eta=1.0), cond, simple,
                                   (1, 32, 64, 4), uncond=uncond, guidance_scale=2.5, cond_weight=0.5, Tm=3,
                                   generator=torch.Generator("cuda").manual_seed(4), device="cuda")
        pred = model.decode_first_stage(zs).float()
        torch.cuda.synchronize()
        launches["nvs_structure_ddim10"] = tools.launches()
        if not torch.isfinite(pred).all():
            raise SystemExit("phase 9s: non-finite output")
        check_launches(launches["nvs_structure_ddim10"], tools.PER_FORWARD_NVS, 10, "phase 9s")
        print(f"phase 9s structure_ddim 10 steps Tm=3 (7 guided steps at batch 3, 3 at batch 1, no cfg_dup): "
              f"seconds={time.perf_counter() - t0:.3f} launches={launches['nvs_structure_ddim10']}")
        del kv3, kv1

    # ---- phase 9l: a LoRA adapter swapped in and out -----------------------
    label = "phase 9l NVS LoRA ddim10"
    g = torch.Generator("cuda").manual_seed(5)
    lora = init_lora(unet, rank=16, target=default_target, generator=g)
    for pack in lora.values():  # init's ups are zero: a trained adapter's are not
        pack["up"] = 0.01 * torch.randn(pack["up"].shape, generator=g, device="cuda")
    store = LoraAdapterStore(unet, keep=2)
    store.add("style", lora)
    short = dict(serve_kw, ddim_steps=10)
    request = lambda: task.log_images(req, **short, generator=torch.Generator("cuda").manual_seed(3))["pred"]  # noqa: E731
    tools.reset_launches()
    base = request()
    t0 = time.perf_counter()
    store.use("style")
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    adapted = request()
    t0 = time.perf_counter()
    store.use(None)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    again = request()
    launches["nvs_lora_ddim10"] = tools.launches()
    check_launches(launches["nvs_lora_ddim10"], tools.PER_FORWARD_NVS, 30, label)
    if torch.equal(adapted, base) or not torch.isfinite(adapted).all():
        raise SystemExit(f"{label}: the adapter's request equals the base's or is not finite")
    if not (torch.equal(again, base) and all(torch.equal(v, store.base[k]) for k, v in unet.state_dict().items())):
        raise SystemExit(f"{label}: the base request after the swap back differs from the first "
                         f"(max abs {float((again - base).abs().max()):.3e})")
    print(f"{label}: {len(lora)} sites rank 16 scale 1, merge+swap {swap_s:.3f} s, swap back {restore_s:.3f} s; "
          f"adapter vs base max_abs={float((adapted - base).abs().max()):.3e}; base again bit-equal; "
          f"launches={launches['nvs_lora_ddim10']}")
    del store, lora, task, bundle, model, unet

    # the fused int8 1-reference bundle: merge into its fp master, requantize
    t0 = time.perf_counter()
    qmodel = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), quant=True)
    master = build_sd2_inpaint_bundle("cuda", torch.float32, torch.Generator("cuda").manual_seed(0)).unet.state_dict()
    qunet = qmodel.unet
    store = LoraAdapterStore(qunet, master_unet=master)
    qlora = init_lora(qunet, rank=16, target=default_target, generator=g)
    for pack in qlora.values():
        pack["up"] = 0.01 * torch.randn(pack["up"].shape, generator=g, device="cuda")
    store.add("style", qlora)
    # the master is the one the int8 weights came from: requantized, it gives them back
    requant = quantize_params_like(qunet, master)
    if not all(torch.equal(requant[k], v) for k, v in store.base.items() if v.dtype == torch.int8 or
               k.endswith("weight_scale")):
        raise SystemExit("phase 9l int8: the fp32 master does not requantize to the bundle's int8 weights")
    x, tsteps, ctx = tools.unet_inputs(gen)
    with torch.inference_mode():
        qkv = qunet.cross_kv(ctx)
        out_base = qunet(x, tsteps, ctx, cross_kv=qkv, cfg_dup=True)
        store.use("style")
        qkv = qunet.cross_kv(ctx)
        tools.reset_launches()
        out_lora = qunet(x, tsteps, ctx, cross_kv=qkv, cfg_dup=True)
        torch.cuda.synchronize()
        launches["int8_lora_forward"] = tools.launches()
    if launches["int8_lora_forward"] != tools.PER_FORWARD_INT8:
        raise SystemExit(f"phase 9l int8: launches {launches['int8_lora_forward']}, expected {tools.PER_FORWARD_INT8}")
    if not torch.isfinite(out_lora).all() or torch.equal(out_lora, out_base):
        raise SystemExit("phase 9l int8: the adapted forward is not finite or equals the base's")
    n_int8 = sum(v.dtype == torch.int8 for v in qunet.state_dict().values())
    print(f"phase 9l int8 fused 1-reference UNet: adapter merged into the fp32 master and requantized "
          f"({n_int8} int8 weights), bundles and merge in {time.perf_counter() - t0:.1f} s; one forward "
          f"[2,64,128,9] launches={ {k: v for k, v in launches['int8_lora_forward'].items() if v} } "
          f"rel_l2_vs_base={tools.rel_l2(out_lora, out_base):.3e}")
    del store, qlora, master, requant, qmodel, qunet, qkv
    return report, sep_report, b4_report


def _edit(text: str, old: str, new: str, count: int = 1, label: str = "phase 10") -> str:
    """``text`` with its ``count`` occurrences of ``old`` replaced (fails otherwise)."""
    if text.count(old) != count:
        raise SystemExit(f"{label}: {old!r} occurs {text.count(old)} times in a shipped YAML, expected {count}")
    return text.replace(old, new)


def recording_steps(make_train_step, runs: list):
    """A stand-in for ``trainer.make_train_step`` that the training CLI
    calls: each run appends {"model", "cond_builder", "before" (the state
    before its first step), "steps"} to ``runs``, each step {"s" (its
    seconds), "start" (its clock at the start), "loss", "launches" (its
    kernel launches, the counts set to 0 just before it), "sites" (its
    kernel sites), "tokens" (its batch's token shape)}."""
    import torch

    from leftrefill_torch import kernels, tools

    def recording(model, tx, **kw):
        step = make_train_step(model, tx, **kw)
        run = {"model": model, "cond_builder": kw.get("cond_builder"), "steps": []}
        runs.append(run)

        def wrapped(state, batch, generator):
            if not run["steps"]:
                run["before"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
            torch.cuda.synchronize()
            tools.reset_launches()
            t1 = time.perf_counter()
            with kernels.record_sites() as sites:
                state, metrics = step(state, batch, generator)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            run["steps"].append({"s": time.perf_counter() - t1, "start": t1, "loss": loss,
                                 "launches": tools.launches(), "sites": list(sites),
                                 "tokens": tuple(batch["tokens"].shape)})
            return state, metrics

        return wrapped

    return recording


def nvs_training_phases(gen, launches: dict) -> dict:
    """Phases 10, 2tn and 10g (novel-view-synthesis training): the train
    steps' launches go into ``launches``; returns the per-kernel reports of
    the train step's sites."""
    import shutil
    import statistics
    import tempfile

    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.cli import train as cli
    from leftrefill_torch.data.datasets import NVS_OBJDataset
    from leftrefill_torch.data.loader import collate
    from leftrefill_torch.ops import flash_attention, mlp
    from leftrefill_torch.train import compute_loss, trainer
    from leftrefill_torch.train.checkpoints import nvs_prompt_filter
    from leftrefill_torch.tools import cuda_ms, rel_l2

    root = tempfile.mkdtemp(prefix="nvs_train_")
    try:
        t0 = time.perf_counter()
        paths = tools.write_nvs_renders(root, NVS_OBJECTS, views=12, size=256, seed=0, val_masks=NVS_VAL_OBJECTS)
        model_yaml = (ROOT / "configs" / "novel_view_synthesis.yaml").read_text()
        for old, new in (("do_lora: False", "do_lora: true"), ("use_input_refinement: False", "use_input_refinement: true"),
                         ("save_prompt_only: False", "save_prompt_only: true"),
                         ('mask_file_path: "./data/obj_test_masks"', f"mask_file_path: '{paths['mask_file_path']}'")):
            model_yaml = _edit(model_yaml, old, new)
        Path(root, "model.yaml").write_text(model_yaml)
        train_yaml = (ROOT / "configs" / "nvs_training_config.yaml").read_text()
        for old, new in (("model_config: './configs/novel_view_synthesis.yaml'", f"model_config: '{root}/model.yaml'"),
                         ("datapath: './data/objaverse/views_release'", f"datapath: '{paths['datapath']}'"),
                         ("train_list: 'dataloaders/lists/obj_train.txt'", f"train_list: '{paths['train_list']}'"),
                         ("val_list: 'dataloaders/lists/obj_test.txt'", f"val_list: '{paths['val_list']}'"),
                         ("batch_size: 16", f"batch_size: {NVS_TRAIN_BATCH}")):
            train_yaml = _edit(train_yaml, old, new)
        train_yaml += "val_batches: 1\nval_ddim_steps: 10\nlog_ddim_steps: 10\n"
        Path(root, "train.yaml").write_text(train_yaml)
        print(f"phase 10 set-up: {NVS_OBJECTS} objects x 12 RGBA 256x256 renders and {NVS_VAL_OBJECTS} validation "
              f"masks written in {time.perf_counter() - t0:.1f} s; model YAML with do_lora, use_input_refinement "
              f"and save_prompt_only on; training YAML batch {NVS_TRAIN_BATCH}", flush=True)

        runs = []
        make_train_step = trainer.make_train_step
        recording = recording_steps(make_train_step, runs)
        exp = Path(root, "ck", "nvs")
        base_args = ["--config_file", str(Path(root, "train.yaml")), "--exp_name", "nvs", "--save_path",
                     str(Path(root, "ck"))]
        trainer.make_train_step = recording
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = cli.main(base_args + ["--no_restore", "--max_steps", "4"])
            first_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            saved = torch.load(exp / "ckpts" / "last.pt", map_location="cuda", weights_only=True)
            t0 = time.perf_counter()
            rc2 = cli.main(base_args + ["--restore", "--max_steps", "6"])
            second_s = time.perf_counter() - t0
        finally:
            trainer.make_train_step = make_train_step
        if rc or rc2 or len(runs) != 2:
            raise SystemExit(f"phase 10: the CLI returned {rc} and {rc2} after {len(runs)} runs")
        first, second = runs
        steps = first["steps"] + second["steps"]
        losses = [st["loss"] for st in steps]
        if len(first["steps"]) != 4 or len(second["steps"]) != 2 or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"phase 10: steps {len(first['steps'])} and {len(second['steps'])}, losses {losses}")
        launches["nvs_train_b16"] = {n: sum(st["launches"][n] for st in steps) for n in tools.LAUNCH_COUNTERS}
        for i, st in enumerate(steps):
            if st["launches"] != tools.PER_TRAIN_STEP_NVS:
                raise SystemExit(f"phase 10: step {i} launches {st['launches']}, expected {tools.PER_TRAIN_STEP_NVS}")
        sites = collections.Counter(first["steps"][0]["sites"])
        for name in BWD_NAMES:
            got = {shape: c for (n, shape), c in sites.items() if n == name}
            if got != tools.TRAIN_SITES_NVS:
                raise SystemExit(f"phase 10: {name} sites {got}, expected {tools.TRAIN_SITES_NVS}")
        # what moved: each trainable group, and nothing else
        model = first["model"]
        after = model.state_dict()
        trainable = {n for n, p in model.named_parameters() if p.requires_grad}
        groups = {"prompt table": "special_embeddings", "relative-pose MLP": "rel_pos_model", "LoRA down": "lora.down",
                  "LoRA up": "lora.up", "refinement branch": "refine"}
        moved = {g: [n for n in trainable if key in n and not torch.equal(first["before"][n], after[n])]
                 for g, key in groups.items()}
        members = {g: [n for n in trainable if key in n] for g, key in groups.items()}
        changed_frozen = [n for n in after if n not in trainable and not torch.equal(first["before"][n], after[n])]
        if any(not members[g] or not moved[g] for g in groups) or changed_frozen or \
                set().union(*members.values()) != trainable:
            raise SystemExit(f"phase 10: groups moved {({g: len(v) for g, v in moved.items()})} of "
                             f"{({g: len(v) for g, v in members.items()})}; frozen changed {changed_frozen[:5]}")
        want = {k for k in after if nvs_prompt_filter(tuple(k.split(".")))}
        if set(saved) != want or not any(k.startswith("lora.") for k in saved):
            raise SystemExit(f"phase 10: ckpts/last.pt holds {len(saved)} keys, the NVS filter {len(want)}")
        restored = second["before"]
        if not all(torch.equal(restored[k], v) for k, v in saved.items()):
            raise SystemExit("phase 10: the resumed run did not start from the saved weights")
        manifest = json.loads((exp / "ckpts" / "manifest.json").read_text())
        records = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
        val = [r for r in records if "val/psnr" in r]
        if manifest["last"]["step"] != 6 or len(val) != 2 or not all(math.isfinite(r["val/psnr"]) for r in val):
            raise SystemExit(f"phase 10: manifest {manifest}, validation records {val}")
        secs = [st["s"] for st in steps]
        print(f"phase 10 training NVS b{NVS_TRAIN_BATCH} 256x512 LoRA r16 + refinement, AdamW(1e-4, wd 0.01) "
              f"through leftrefill_torch.cli.train: seconds_per_step={[round(x, 3) for x in secs]} "
              f"median_after_first={statistics.median(secs[1:4]):.3f} losses={[round(x, 5) for x in losses]} "
              f"launches_per_step={({n: c for n, c in steps[0]['launches'].items() if c})} "
              f"peak_mem_gib={peak:.1f} cli_seconds={first_s:.1f}+{second_s:.1f} "
              f"trainable={sum(after[n].numel() for n in trainable)} groups_moved="
              f"{({g: f'{len(moved[g])}/{len(members[g])}' for g in groups})} frozen_unchanged={len(after) - len(trainable)} "
              f"ckpt_keys={len(saved)} resumed_at_step=4 val={[(r['step'], round(r['val/psnr'], 3), round(r['val/ssim'], 4)) for r in val]}",
              flush=True)

        # ---- phase 2tn: the kernels at every site of that train step -----
        report = {}
        for (name, shape), n_sites in sorted(sites.items()):
            if name in ("flash_fwd", "conv3x3", "geglu"):
                with torch.inference_mode():
                    check_site(name, shape, gen, n_sites, report, "2tn")
            else:
                check_site(name, shape, gen, n_sites, report, "2tn")
            if name == "flash_fwd":
                site = tools.site_args(name, shape, gen)
                err = float((flash_attention.flash_forward(*site)[1] - flash_attention.flash_forward_plain(*site)[1])
                            .abs().max())
                if err > LSE_TRAIN_ABS:
                    raise SystemExit(f"phase 2tn flash_fwd {shape}: lse {err:.3e} from the plain version's")
                print(f"phase 2tn flash_fwd shape={shape}: lse_max_abs={err:.3e} (limit {LSE_TRAIN_ABS})")
            if name == "geglu":
                x, w1, b1, w2, b2 = tools.site_args(name, shape, gen)
                g_out = torch.randn((x.shape[0], w2.shape[0]), generator=gen, device="cuda").to(x.dtype)
                grads = []
                for fn in (mlp._GEGLU.apply, mlp.geglu_plain):
                    xi, wi = x.detach().requires_grad_(True), w1.detach().requires_grad_(True)
                    grads.append(torch.autograd.grad(fn(xi, wi, b1, w2, b2), (xi, wi), g_out))
                errs = [rel_l2(a, b) for a, b in zip(*grads)]
                if max(errs) > REL_L2["geglu"] or not all(torch.isfinite(a).all() for a in grads[0]):
                    raise SystemExit(f"phase 2tn geglu {shape}: dx, dW1 rel L2 {errs} > {REL_L2['geglu']}")
                print(f"phase 2tn geglu shape={shape}: VJP dx_rel_l2={errs[0]:.3e} dw1_rel_l2={errs[1]:.3e} "
                      f"(geglu_vjp_math after K3 against autograd through geglu_plain, limit {REL_L2['geglu']})")
        for name, n in tools.PER_TRAIN_STEP_NVS.items():
            if report.get(name, {}).get("sites", 0) != n:
                raise SystemExit(f"phase 2tn {name}: {report.get(name, {}).get('sites', 0)} sites, expected {n}")

        # ---- phase 10g: each group's gradient, kernels against plain -----
        task = first["cond_builder"].__self__
        ds = NVS_OBJDataset(paths["datapath"], paths["val_list"], mode="val", img_size=256,
                            mask_file_path=paths["mask_file_path"], repeat_sp_token=73, sp_token="<special-token>")
        small = {k: v for k, v in collate([ds[0], ds[1]], task.tokenizer).items() if k != "txt"}
        g2 = torch.Generator("cuda").manual_seed(11)
        t_fix = torch.randint(0, 1000, (2,), generator=g2, device="cuda")
        noise = torch.randn((2, 32, 64, 4), generator=g2, device="cuda").to(torch.bfloat16)
        draws = torch.tensor([0.5, 0.05], device="cuda")  # the second row's prompt is dropped (rate 0.15)

        def group_grads():
            model.zero_grad(set_to_none=True)
            compute_loss(model, small, t_fix, noise, cond_builder=task.cond_builder, cfg_draws=draws)[0].backward()
            torch.cuda.synchronize()
            return {g: torch.cat([model.get_parameter(n).grad.float().flatten() for n in sorted(members[g])])
                    for g in groups}

        grad_k = group_grads()
        with kernels.plain_kernels():
            grad_p = group_grads()
        model.zero_grad(set_to_none=True)
        errs = {g: rel_l2(grad_k[g], grad_p[g]) for g in groups}
        if any(not (torch.isfinite(grad_k[g]).all() and grad_k[g].abs().max() > 0 and errs[g] <= PROMPT_GRAD_REL_L2)
               for g in groups):
            raise SystemExit(f"phase 10g: gradients through the kernels against the plain versions {errs} "
                             f"(limit {PROMPT_GRAD_REL_L2}) or zero / non-finite")
        print(f"phase 10g gradients b2 t={t_fix.tolist()} cfg_draws={draws.tolist()}: kernels vs plain versions "
              + " ".join(f"{g.replace(' ', '_')}_rel_l2={e:.3e}" for g, e in errs.items())
              + f" (limit {PROMPT_GRAD_REL_L2})", flush=True)
        del model, first, second, runs, grad_k, grad_p
        return report
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serving_phases(launches: dict) -> None:
    """Phases 11a-11e: the JPEG fixtures, ``predict`` bf16 and int8, and the
    two CLIs in process; each path's launches go into ``launches``."""
    import hashlib
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.cli import sample as sample_cli, test as test_cli
    from leftrefill_torch.data.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE, imread, read_png, resize
    from leftrefill_torch.eval.lpips import ALEX
    from leftrefill_torch.serving import gradio_app
    from leftrefill_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    fixtures = ROOT / "tests" / "fixtures" / "jpeg"
    # ---- 11a: the JPEG fixtures against OpenCV's stored decodes -------------
    manifest = json.loads((fixtures / "manifest.json").read_text())
    for name, entry in manifest.items():
        t0 = time.perf_counter()
        img = imread(str(fixtures / name), IMREAD_COLOR)
        secs = time.perf_counter() - t0
        if list(img.shape) != entry["shape"] or hashlib.sha256(img.tobytes()).hexdigest() != entry["sha256"]:
            raise SystemExit(f"phase 11a {name}: the decode differs from OpenCV's (shape {img.shape})")
        if "png" in entry and not np.array_equal(img, read_png(str(fixtures / entry["png"]))):
            raise SystemExit(f"phase 11a {name}: the decode differs from {entry['png']}")
        print(f"phase 11a {name} {tuple(img.shape)}: bit-equal to OpenCV's decode; decode_seconds={secs:.3f}",
              flush=True)

    root = tempfile.mkdtemp(prefix="serving_")
    try:
        exp = Path(root, "exp")
        exp.mkdir()
        shutil.copy(ROOT / "configs" / "ref_inpainting.yaml", exp / "model_config.yaml")
        table = 0.02 * torch.randn((50, 1024), generator=torch.Generator().manual_seed(5))
        CheckpointManager(str(exp / "ckpts")).save_last(100, {"cond_stage_model.special_embeddings.weight": table})
        reference = imread(str(fixtures / "baseline_420.jpg"), IMREAD_COLOR)
        source = imread(str(fixtures / "progressive_420.jpg"), IMREAD_COLOR)
        mask = imread(str(fixtures / "mask_palette.png"), IMREAD_GRAYSCALE)

        # ---- 11b / 11c: predict, bf16 DDIM-50 and fused int8 DPM++(2M)-15 ---
        for label, key, kw, steps, per_forward in (
                ("11b", "predict_bf16_ddim50", dict(), 50, tools.PER_FORWARD_BF16),
                ("11c", "predict_int8_dpm15", dict(quantized=True, sampler="dpm++2m"), 15, tools.PER_FORWARD_INT8)):
            t0 = time.perf_counter()
            pipe = gradio_app.initialize_model(str(exp), **kw)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            if not torch.equal(pipe.model.cond_stage_model.special_embeddings.weight.float().cpu(),
                               table.to(pipe.model.cond_stage_model.special_embeddings.weight.dtype).float()):
                raise SystemExit(f"phase {label}: the prompt checkpoint was not restored")
            request = dict(ddim_steps=steps, num_samples=1, scale=2.5, seed=7, img_size=512)
            gradio_app.predict(pipe, reference, source, mask, **{**request, "seed": 6})  # the first request
            torch.cuda.synchronize()
            tools.reset_launches()
            t0 = time.perf_counter()
            out = gradio_app.predict(pipe, reference, source, mask, **request)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches[key] = tools.launches()
            check_launches(launches[key], per_forward, steps, f"phase {label}")
            image, full_mask = gradio_app.request_canvas(reference, source, mask, 1, 512)
            variant = gradio_app.pipeline_variant(pipe, steps, 2.5)
            g = torch.Generator("cuda").manual_seed(7)
            x_T = torch.randn((1, 64, 128, 4), generator=g, device="cuda")
            direct = variant.inpaint_right_half(image, full_mask, g, x_T=x_T)
            direct = np.clip((direct[0, :512, :512] + 1) * 127.5, 0, 255).astype(np.uint8)
            if out[0].shape != (512, 512, 3) or not np.array_equal(out[0], direct):
                raise SystemExit(f"phase {label}: predict's output differs from inpaint_right_half's")
            keep = full_mask[0, :, 512:, 0] == 0
            target = resize(source, (512, 512), 3)
            off = int(np.abs(out[0][keep].astype(int) - target[keep].astype(int)).max())
            if off > 1 or keep.all() or not keep.any():
                raise SystemExit(f"phase {label}: outside the hole the output is {off} levels from the target")
            print(f"phase {label} predict 512 {kw.get('sampler', 'ddim')}{steps} "
                  f"{'int8 fused' if kw.get('quantized') else 'bf16'} eta1 cfg2.5 (JPEG reference and target, "
                  f"palette-PNG mask): initialize_model_seconds={init_s:.1f} request_seconds={secs:.3f} "
                  f"launches={ {k: v for k, v in launches[key].items() if v} } unet_forwards={steps}; bit-equal to "
                  f"inpaint_right_half; outside the hole within {off} level of the target", flush=True)
            del pipe, variant
            torch.cuda.empty_cache()

        # ---- 11d: cli.sample ------------------------------------------------
        t0 = time.perf_counter()
        out_png = Path(root, "sample.png")
        if sample_cli.main(["--model_path", str(exp), "--reference", str(fixtures / "baseline_420.jpg"),
                            "--source", str(fixtures / "exif_orientation_6.jpg"), "--mask",
                            str(fixtures / "mask_palette.png"), "--out", str(out_png), "--ddim_steps", "10"]) != 0:
            raise SystemExit("phase 11d: cli.sample returned nonzero")
        shape = read_png(str(out_png)).shape
        if shape != (512, 512, 3):
            raise SystemExit(f"phase 11d: cli.sample wrote {shape}")
        print(f"phase 11d cli.sample DDIM-10: wrote a {shape} PNG in {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()

        # ---- 11e: cli.test, 1-reference with LPIPS, then V=4 multi-view -----
        pairs = Path(root, "pairs")
        for i, (src, tgt) in enumerate((("baseline_420.jpg", "progressive_420.jpg"),
                                        ("baseline_444.jpg", "exif_orientation_6.jpg"))):
            d = pairs / f"{i:04d}"
            d.mkdir(parents=True)
            shutil.copy(fixtures / src, d / "source.jpg")
            shutil.copy(fixtures / tgt, d / "target.jpg")
            for j, extra in enumerate(("grey.jpg", "baseline_444.jpg", "baseline_420.jpg")):
                shutil.copy(fixtures / extra, d / f"source_{j + 1}.jpg")
            shutil.copy(fixtures / "mask_palette.png", d / "mask.png")
        g = torch.Generator().manual_seed(0)
        torch.save({f"lin{i}.model.1.weight": torch.rand((1, ch, 1, 1), generator=g)
                    for i, (ch, _, _, _) in enumerate(ALEX)}, Path(root, "lpips.pth"))
        mv = Path(root, "mv")
        mv.mkdir()
        yaml = (ROOT / "configs" / "multiview_ref_inpainting.yaml").read_text()
        if yaml.count("view_num: 2") != 4:
            raise SystemExit("phase 11e: the multi-view YAML's view_num lines changed")
        (mv / "model_config.yaml").write_text(yaml.replace("view_num: 2", f"view_num: {VIEWS}"))
        common = ["--test_path", str(pairs), "--test_size", "512", "--ddim_steps", "10", "--limit", "2",
                  "--output_path", str(Path(root, "out")), "--metric_output", str(Path(root, "metrics"))]
        for label, args, key, per_forward, files in (
                ("1-reference", ["--model_path", str(exp), "--exp_name", "ref", "--lpips_weights",
                                 str(Path(root, "lpips.pth"))], "cli_test_1ref_ddim10", tools.PER_FORWARD_BF16,
                 ["000000.png", "000001.png"]),
                (f"--multiview V={VIEWS}", ["--model_path", str(mv), "--exp_name", "mv", "--multiview",
                                            "--lpips_weights", str(Path(root, "lpips.pth"))],
                 "cli_test_mv4_ddim10", tools.PER_FORWARD_MV4,
                 ["000000.png", "000000_ref0.png", "000000_ref1.png", "000000_ref2.png",
                  "000001.png", "000001_ref0.png", "000001_ref1.png", "000001_ref2.png"])):
            t0 = time.perf_counter()
            tools.reset_launches()
            if test_cli.main(args + common) != 0:
                raise SystemExit(f"phase 11e {label}: cli.test returned nonzero")
            torch.cuda.synchronize()
            launches[key] = tools.launches()
            check_launches(launches[key], per_forward, 2 * 10, f"phase 11e {label}")  # 2 batches x 10 steps
            name = args[args.index("--exp_name") + 1]
            metrics = dict(line.strip().split(":") for line in Path(root, "metrics", f"{name}_512.txt").open())
            written = sorted(p.name for p in Path(root, "out", f"{name}_512").iterdir())
            if metrics.keys() != {"PSNR", "SSIM", "LPIPS"} or not all(math.isfinite(float(v)) for v in metrics.values()):
                raise SystemExit(f"phase 11e {label}: metrics {metrics}")
            if float(metrics["PSNR"]) >= 60:  # a reference view (no hole) reads 120 dB: V=4's mean would be >= 90
                raise SystemExit(f"phase 11e {label}: PSNR {metrics['PSNR']} is not the target views' alone")
            if written != files:
                raise SystemExit(f"phase 11e {label}: wrote {written}")
            print(f"phase 11e cli.test {label} test_size 512 DDIM-10 2 batches: {metrics} files={written} "
                  f"launches={ {k: v for k, v in launches[key].items() if v} } seconds={time.perf_counter() - t0:.1f}",
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11 total seconds={time.perf_counter() - t_phase:.1f}", flush=True)


# phases 12 and 12m: the synthetic MegaDepth tree (every image the 1600x1200
# photo), and the CLI runs' steps
MD_SCENES, MD_IMAGES, MD_TRAIN_PAIRS, MD_OTHER_PAIRS = 2, 14, 155, 12
MD_STEPS, MD_RESUMED_STEPS = 4, 2


def megadepth_yamls(root: str, paths: dict, name: str, label: str, train_edits: tuple = (),
                    model_edits: tuple = ()) -> list[str]:
    """Copies of the shipped ``configs/<name>_training_config.yaml`` and model
    YAML (the multi-view one at VIEWS views) pointed at the tree (and edited
    by ``train_edits`` and ``model_edits``, (old, new) pairs), in ``root``;
    returns the CLI's ``--config_file``/``--exp_name``/``--save_path``
    arguments."""
    mv = name.startswith("multiview")
    model_yaml = (ROOT / "configs" / f"{name}.yaml").read_text()
    model_yaml = _edit(model_yaml, 'match_path: "./data/matching_results"', f"match_path: '{paths['match_path']}'",
                       label=label)
    for old, new in model_edits:
        model_yaml = _edit(model_yaml, old, new, label=label)
    if mv:
        model_yaml = _edit(model_yaml, "view_num: 2", f"view_num: {VIEWS}", 4, label)
    Path(root, f"{name}.yaml").write_text(model_yaml)
    train_yaml = (ROOT / "configs" / f"{name}_training_config.yaml").read_text()
    image_path, train_pair = (("'./data/4-extended_image_path_dict.pkl'", "'./data/4-extended_fixed_train_pair.pkl'")
                              if mv else ("'data/megadepth_0.4_0.7/image_dict.pkl'",
                                          "'data/megadepth_0.4_0.7/new_train_pairs.pkl'"))
    for old, new in ((f"model_config: './configs/{name}.yaml'", f"model_config: '{root}/{name}.yaml'"),
                     (f"image_path: {image_path}", f"image_path: '{paths['image_path']}'"),
                     (f"train_pair: {train_pair}", f"train_pair: '{paths['mv_train_pair' if mv else 'train_pair']}'"),
                     ("val_image_path: 'data/megadepth_0.4_0.7/match_test_image_pairs'",
                      f"val_image_path: '{paths['val_image_path']}'"),
                     ("'./data/irregular_mask/irregular_lama_mask_list.txt'", f"'{paths['train_mask_path'][0]}'"),
                     ("'./data/coco_mask/coco_mask_list.txt'", f"'{paths['train_mask_path'][1]}'"),
                     ("val_mask_path: './data/test_mask_100'", f"val_mask_path: '{paths['val_mask_path']}'")):
        train_yaml = _edit(train_yaml, old, new, label=label)
    for old, new in train_edits:
        train_yaml = _edit(train_yaml, old, new, label=label)
    train_yaml += "val_batches: 1\nval_ddim_steps: 10\nlog_ddim_steps: 10\n"
    Path(root, f"{name}_train.yaml").write_text(train_yaml)
    return ["--config_file", str(Path(root, f"{name}_train.yaml")), "--exp_name", name, "--save_path",
            str(Path(root, "ck"))]


def megadepth_cli_run(root: str, paths: dict, name: str, label: str) -> dict:
    """``cli.train.main`` in process on ``megadepth_yamls``' copies:
    ``--no_restore --max_steps MD_STEPS``, then ``--restore`` for
    MD_RESUMED_STEPS more.  Returns the runs' records, the loaders the CLI
    built, the peak memory and the experiment directory."""
    import torch

    from leftrefill_torch.cli import train as cli
    from leftrefill_torch.data import loader
    from leftrefill_torch.train import trainer

    args = megadepth_yamls(root, paths, name, label)
    runs, loaders = [], []
    make_train_step, data_loader = trainer.make_train_step, loader.DataLoader

    class Recorded(data_loader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append(self)

    trainer.make_train_step, loader.DataLoader = recording_steps(make_train_step, runs), Recorded
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(args + ["--no_restore", "--max_steps", str(MD_STEPS)])
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        exp = Path(root, "ck", name)
        saved = torch.load(exp / "ckpts" / "last.pt", map_location="cuda", weights_only=True)
        t0 = time.perf_counter()
        rc2 = cli.main(args + ["--restore", "--max_steps", str(MD_STEPS + MD_RESUMED_STEPS)])
        second_s = time.perf_counter() - t0
    finally:
        trainer.make_train_step, loader.DataLoader = make_train_step, data_loader
    if rc or rc2 or len(runs) != 2:
        raise SystemExit(f"{label}: the CLI returned {rc} and {rc2} after {len(runs)} runs")
    return {"runs": runs, "loaders": loaders, "peak": peak, "exp": exp, "saved": saved,
            "cli_s": (first_s, second_s)}


def check_megadepth_run(out: dict, per_step: dict, sites_want: dict, label: str) -> dict:
    """Phase 12's checks on one CLI pair of runs (its docstring); returns the
    summed launches and prints the readings."""
    import statistics

    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.train.checkpoints import prompt_only_filter

    first, second = out["runs"]
    steps = first["steps"] + second["steps"]
    losses = [st["loss"] for st in steps]
    if len(first["steps"]) != MD_STEPS or len(second["steps"]) != MD_RESUMED_STEPS or \
            not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: steps {len(first['steps'])} and {len(second['steps'])}, losses {losses}")
    for i, st in enumerate(steps):
        if st["launches"] != per_step:
            raise SystemExit(f"{label}: step {i} launches {st['launches']}, expected {per_step}")
    sites = collections.Counter(first["steps"][0]["sites"])
    for name in BWD_NAMES:
        got = {shape: c for (n, shape), c in sites.items() if n == name}
        if got != sites_want:
            raise SystemExit(f"{label}: {name} sites {got}, expected {sites_want}")
    model = first["model"]
    after = model.state_dict()
    changed = sorted(k for k in after if not torch.equal(first["before"][k], after[k]))
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    table = "cond_stage_model.special_embeddings.weight"
    if changed != [table] or trainable != [table]:
        raise SystemExit(f"{label}: changed {changed[:5]}, trainable {trainable[:5]} (only the prompt table may)")
    want = {k for k in after if prompt_only_filter(tuple(k.split(".")))}
    if set(out["saved"]) != want or want != {table}:
        raise SystemExit(f"{label}: ckpts/last.pt holds {sorted(out['saved'])}, the prompt filter {sorted(want)}")
    if not torch.equal(second["before"][table], out["saved"][table]):
        raise SystemExit(f"{label}: the resumed run did not start from the saved prompt table")
    exp = out["exp"]
    manifest = json.loads((exp / "ckpts" / "manifest.json").read_text())
    records = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if "val/psnr" in r]
    if manifest["last"]["step"] != MD_STEPS + MD_RESUMED_STEPS or len(val) != 2 or \
            not all(math.isfinite(r["val/psnr"]) and math.isfinite(r["val/ssim"]) for r in val):
        raise SystemExit(f"{label}: manifest {manifest}, validation records {val}")
    if not (exp / "samples" / "gs-000000_e-000000_train.png").exists():
        raise SystemExit(f"{label}: no step-0 image log")
    secs = [st["s"] for st in steps]
    # the data path: in the first run, from the third step on, the loader's
    # batches come no faster than they are decoded (the two prefetched ones
    # and the step-0 image log are behind it).  The steps themselves run
    # beside the loader's decode threads, which hold the GIL
    intervals = [b["start"] - a["start"] for a, b in zip(first["steps"][1:], first["steps"][2:])]
    print(f"{label} through leftrefill_torch.cli.train: seconds_per_step={[round(x, 3) for x in secs]} "
          f"median_after_first={statistics.median(secs[1:MD_STEPS]):.3f} "
          f"seconds_between_steps={[round(x, 3) for x in intervals]} "
          f"losses={[round(x, 5) for x in losses]} launches_per_step={({n: c for n, c in per_step.items() if c})} "
          f"peak_mem_gib={out['peak']:.1f} cli_seconds={out['cli_s'][0]:.1f}+{out['cli_s'][1]:.1f} "
          f"ckpt_keys={sorted(out['saved'])} resumed_at_step={MD_STEPS} "
          f"val={[(r['step'], round(r['val/psnr'], 3), round(r['val/ssim'], 4)) for r in val]}", flush=True)
    return {n: sum(st["launches"][n] for st in steps) for n in tools.LAUNCH_COUNTERS}


def megadepth_training_phases(launches: dict) -> None:
    """Phases 12, 12m and 12g: prompt tuning through the training CLI on
    MegaDepth-format data; each run's step launches go into ``launches``."""
    import shutil
    import tempfile

    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.data.loader import DataLoader
    from leftrefill_torch.train import compute_loss
    from leftrefill_torch.tools import rel_l2

    root = tempfile.mkdtemp(prefix="megadepth_train_")
    try:
        t0 = time.perf_counter()
        paths = tools.write_megadepth_scenes(root, MD_SCENES, MD_IMAGES, seed=0, train_pairs_per_scene=MD_TRAIN_PAIRS,
                                             other_pairs_per_scene=MD_OTHER_PAIRS, images=tools.MEGADEPTH_IMAGES[:1],
                                             mask_size=512)
        print(f"phase 12 set-up: {MD_SCENES} scenes x {MD_IMAGES} 1600x1200 JPEG photos, {MD_TRAIN_PAIRS} pairs a "
              f"scene with overlaps in [0.4, 0.7] and {MD_OTHER_PAIRS} outside, match pickles and mask lists, 4 "
              f"validation pair directories, written in {time.perf_counter() - t0:.1f} s; the YAML copies' edits: "
              "the data paths, val_batches 1, val_ddim_steps 10, log_ddim_steps 10 (multi-view: view_num "
              f"{VIEWS})", flush=True)

        # ---- phase 12: 1-reference prompt tuning through the CLI -------------
        ref = megadepth_cli_run(root, paths, "ref_inpainting", "phase 12")
        launches["cli_train_1ref_b8"] = check_megadepth_run(
            ref, tools.PER_TRAIN_STEP_CLI, tools.TRAIN_SITES,
            "phase 12 training 1-reference b8 512x1024 no remat AdamW(3e-5, wd 0.01)")

        # ---- phase 12g: a CLI batch's prompt gradient, kernels vs plain ------
        train_loader = ref["loaders"][0]
        small_loader = DataLoader(train_loader.dataset, 2, sampler=train_loader.sampler,
                                  tokenizer=train_loader.tokenizer)
        small = {k: v for k, v in next(iter(small_loader)).items() if k != "txt"}
        model = ref["runs"][0]["model"]
        table = model.cond_stage_model.special_embeddings.weight

        def prompt_grad():  # t and the noise drawn from the same seed each time
            table.grad = None
            compute_loss(model, small, generator=torch.Generator(table.device).manual_seed(11))[0].backward()
            torch.cuda.synchronize()
            return table.grad.clone()

        grad_k = prompt_grad()
        with kernels.plain_kernels():
            grad_p = prompt_grad()
        table.grad = None
        err = rel_l2(grad_k, grad_p)
        if not (torch.isfinite(grad_k).all() and grad_k.abs().max() > 0 and err <= PROMPT_GRAD_REL_L2):
            raise SystemExit(f"phase 12g: prompt-table gradient through the kernels rel L2 {err:.3e} from the plain "
                             f"versions' (limit {PROMPT_GRAD_REL_L2}) or zero / non-finite")
        print(f"phase 12g prompt-table gradient on a batch of 2 from the CLI's loader (mask means "
              f"{[round(float(m.mean()), 3) for m in small['mask']]}): kernels vs plain versions "
              f"rel_l2={err:.3e} (limit {PROMPT_GRAD_REL_L2}) grad_norm={float(grad_k.norm()):.4e}", flush=True)
        del ref, model, table, grad_k, grad_p, small_loader, train_loader
        torch.cuda.empty_cache()

        # ---- phase 12m: V=4 multi-view prompt tuning through the CLI ---------
        mv = megadepth_cli_run(root, paths, "multiview_ref_inpainting", "phase 12m")
        launches["cli_train_mv4"] = check_megadepth_run(
            mv, tools.PER_TRAIN_STEP_CLI_MV4, tools.TRAIN_SITES_MV4,
            f"phase 12m training V={VIEWS} 512x512 views, one scene a step, view-0 loss, no remat")
        del mv
        torch.cuda.empty_cache()

        # ---- phase 15d: deep-prompt tuning through the CLI on the same tree --
        phase_15d(root, paths, launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phases 13d, 13s, 13a, 13m: the remaining samplers, log_images' diagnostic
# rows, the cross-attention maps and multi_cond_sample (the SD2 bundle, 512x1024)
SAMPLER_STEP_REL_L2 = UNET_REL_L2  # a sampler step's model outputs, kernels vs plain (phase 3's bound)
ROW_STEPS = {"diffusion_row": 6, "denoise_row": 8, "progressive_row": 5}
MAP_ROW_SUM_ABS = 1e-3


def recording_apply(apply_fn, calls: list):
    """``apply_fn`` that appends ((x, t, c), output) of each call to ``calls``."""
    def run(x, t, c):
        out = apply_fn(x, t, c)
        calls.append(((x, t, c), out))
        return out

    return run


def sampler_phases(launches: dict) -> None:
    """Phases 13d, 13s, 13a and 13m (module docstring); each main path's
    launches go into ``launches``."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from leftrefill_torch import kernels, tasks, tools
    from leftrefill_torch.config import build_model_from_config
    from leftrefill_torch.diffusion import ddim, samplers_extra
    from leftrefill_torch.diffusion.core import Conditioning
    from leftrefill_torch.eval.attn_vis import collect_attention_maps
    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer
    from leftrefill_torch.ops.layers import nearest_resize
    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle
    from leftrefill_torch.tools import rel_l2

    t_phase = time.perf_counter()
    bundle = build_model_from_config(str(ROOT / "configs" / "ref_inpainting.yaml"), dtype=torch.bfloat16,
                                     device="cuda")
    task = tasks.build_task(bundle, "cuda")
    task.init_params(torch.Generator("cuda").manual_seed(0))
    m = task.model
    image, mask = tools.request_canvas()
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": task.prompt_tokens(" ".join(bundle.special_tokens))}

    # ---- 13d: log_images with every diagnostic row --------------------------
    secs, results = [], []

    def timed(fn, name, keep=False):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs.append((name, time.perf_counter() - t0))
            if keep:
                results.append(out)
            return out
        return run

    patched = {"ddim_sample": tasks.ddim_sample, "ddpm_sample": tasks.ddpm_sample}
    tasks.ddim_sample = timed(patched["ddim_sample"], "ddim", keep=True)
    tasks.ddpm_sample = timed(patched["ddpm_sample"], "ddpm")
    m.encode_first_stage = timed(m.encode_first_stage, "encode")
    m.decode_first_stage = timed(m.decode_first_stage, "decode")
    torch.cuda.reset_peak_memory_stats()
    tools.reset_launches()
    try:
        t0 = time.perf_counter()
        log = task.log_images(batch, plot_diffusion_rows=True, plot_denoise_rows=True, plot_progressive_rows=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        tasks.ddim_sample, tasks.ddpm_sample = patched["ddim_sample"], patched["ddpm_sample"]
        del m.encode_first_stage, m.decode_first_stage
    launches["log_images_rows_ddim50_g9"] = tools.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    forwards = 50 + m.schedule.num_timesteps  # the denoise row is pred's own DDIM loop (g != 0)
    check_launches(launches["log_images_rows_ddim50_g9"], tools.PER_FORWARD_BF16, forwards, "phase 13d")
    # calls in order: the cond's encode, pred's DDIM (with its intermediates)
    # and decode, the diffusion row's encode and decode, the denoise row's
    # decode, the DDPM loop and its decode
    names = [n for n, _ in secs]
    want = ["encode", "ddim", "decode", "encode", "decode", "decode", "ddpm", "decode"]
    if names != want:
        raise SystemExit(f"phase 13d: calls {names}, expected {want}")
    s = [v for _, v in secs]
    rows_s = {"pred": s[1] + s[2], "diffusion_row": s[3] + s[4], "denoise_row (its decode)": s[5],
              "progressive_row": s[6] + s[7]}
    for k, n in ROW_STEPS.items():
        row = log[k]
        if tuple(row.shape) != (n, 1, 512, 1024, 3) or not torch.isfinite(row).all() or float(row.abs().max()) > 1:
            raise SystemExit(f"phase 13d: {k} {tuple(row.shape)}, finite {bool(torch.isfinite(row).all())}")
    (z_pred, inter), = results
    if not torch.equal(inter["x_inter"][-1], z_pred):
        raise SystemExit("phase 13d: the denoise row's last latent differs from the one pred decoded")
    print(f"phase 13d log_images 512x1024 bf16 DDIM-50 eta0 g9 + diffusion, denoise and progressive rows: "
          f"seconds={ {k: round(v, 3) for k, v in rows_s.items()} } (DDPM loop {s[6]:.3f}, its decode "
          f"{s[7]:.3f}) total_seconds={total:.3f} peak_mem_gib={peak:.1f} unet_forwards={forwards} launches="
          f"{ {k: v for k, v in launches['log_images_rows_ddim50_g9'].items() if v} }; rows finite in [-1, 1]; the "
          f"denoise row's last x_inter bit-equal to pred's latent", flush=True)
    del log, results, inter
    torch.cuda.empty_cache()

    # ---- 13s: PLMS, DDIM with renoise/temperature/ucg, DDIM inversion -------
    dev, shape, g = "cuda", (1, 64, 128, 4), 2.5
    apply_fn = lambda x, t, c: m.apply_model(x, t, c)
    gen = torch.Generator(dev).manual_seed(21)
    with torch.inference_mode():
        t_ = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
        cond = m.build_inpaint_cond(t_(batch["tokens"], torch.long), t_(mask), t_(batch["masked_image"]))
        uc = Conditioning(cond.c_concat, m.get_learned_conditioning(t_(task.uncond_tokens(1), torch.long)))
        z0 = m.encode_first_stage(t_(image)).to(torch.float32)
        known = 1.0 - nearest_resize(t_(mask), shape[1:3])  # the reference half: renoised from x0
        x_T = torch.randn(shape, generator=gen, device=dev)
        tables0, tables1 = m.schedule.ddim_tables(50), m.schedule.ddim_tables(50, eta=1.0)
        ucg = np.linspace(7.5, 1.5, 50)
        for label, n_fwd, fn in (
                ("plms50", 51, lambda: samplers_extra.plms_sample(apply_fn, m.schedule, tables0, cond, shape, uc, g,
                                                                  x_T=x_T)),
                ("ddim50_renoise_t0.5_ucg", 50, lambda: ddim.ddim_sample(
                    apply_fn, m.schedule, tables1, cond, shape, uncond=uc, guidance_scale=g, x_T=x_T, generator=gen,
                    mask=known, x0=z0, temperature=0.5, ucg_schedule=ucg)),
                ("ddim_encode25_decode25", 50, lambda: ddim.ddim_decode(
                    apply_fn, m.schedule, tables0, ddim.ddim_encode(apply_fn, tables0, z0, cond, 25, uc, g), cond, 25,
                    uc, g))):
            torch.cuda.synchronize()
            tools.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches[f"sampler_{label}"] = tools.launches()
            check_launches(launches[f"sampler_{label}"], tools.PER_FORWARD_BF16, n_fwd, f"phase 13s {label}")
            if out.shape != shape or not torch.isfinite(out).all():
                raise SystemExit(f"phase 13s {label}: output {tuple(out.shape)} or not finite")
            extra = ""
            if label.startswith("ddim_encode"):
                extra = f" round trip rel_l2 to the encoded canvas {rel_l2(out, z0):.3e} (random weights)"
            print(f"phase 13s {label} 512x1024 bf16 cfg{g}: seconds={sec:.3f} unet_forwards={n_fwd} launches="
                  f"{ {k: v for k, v in launches[f'sampler_{label}'].items() if v} }{extra}", flush=True)

        # one step of each: every model call of the step, on the input the
        # kernels' run gave it, through the kernels and through the plain
        # versions; the model outputs compared (a step's latent weighs the
        # model output by as little as 0.012, which would hide a wrong one).
        # The guided output is printed beside them: guidance at 2.5 scales
        # up the two CFG halves' differences, past the forward's bound
        t_mid = 500
        noisy = m.q_sample(z0, torch.full((1,), t_mid, device=dev), torch.randn(shape, generator=gen, device=dev))
        noise = torch.randn(shape, generator=gen, device=dev)
        tabs = samplers_extra.ddpm_tables(m.schedule, dev)
        mid = ddim.sub_tables(tables0, 24, 25)  # timestep 481
        noisy_mid = m.q_sample(z0, torch.full((1,), int(mid.timesteps[0]), device=dev),
                               torch.randn(shape, generator=gen, device=dev))
        steps = {
            f"ddpm t={t_mid}": lambda fn: samplers_extra.ddpm_step(fn, tabs, noisy, t_mid, cond, uc, g, False, noise),
            "plms order 1 (Heun, t=981 and 0)": lambda fn: samplers_extra.plms_sample(
                fn, m.schedule, ddim.sub_tables(tables0, 49, 50), cond, shape, uc, g, x_T=x_T),
            # four entries from t=981: Heun's two calls, orders 2, 3 and 4
            "plms to order 4 (t=981..801)": lambda fn: samplers_extra.plms_sample(
                fn, m.schedule, ddim.sub_tables(tables0, 46, 50), cond, shape, uc, g, x_T=x_T),
            "ddim_encode step 0": lambda fn: ddim.ddim_encode(fn, tables0, z0, cond, 1, uc, g),
            "ddim_decode step t=481": lambda fn: ddim.ddim_decode(fn, m.schedule, mid, noisy_mid, cond, 1, uc, g),
        }
        guide = lambda o: (lambda u, c: u + g * (c - u))(*o.float().chunk(2))
        errs, guided, n_calls = {}, {}, {}
        for name, step in steps.items():
            calls = []
            step(recording_apply(apply_fn, calls))
            with kernels.plain_kernels():
                plain = [apply_fn(*args) for args, _ in calls]
            errs[name] = max(rel_l2(out, p) for (_, out), p in zip(calls, plain))
            guided[name] = max(rel_l2(guide(out), guide(p)) for (_, out), p in zip(calls, plain))
            n_calls[name] = len(calls)
            del calls, plain
        worst = max(errs.values())
        if not worst <= SAMPLER_STEP_REL_L2:
            raise SystemExit(f"phase 13s: model outputs kernels vs plain {errs} > {SAMPLER_STEP_REL_L2}")
        fmt = lambda d: {k: f"{v:.3e}" for k, v in d.items()}
        print(f"phase 13s one step each, every model call ([uncond; cond]) on the kernels' run's input, kernels vs "
              f"plain versions, max rel_l2: {fmt(errs)} (calls {n_calls}; limit {SAMPLER_STEP_REL_L2}); for "
              f"information, the guided outputs (cfg{g}): {fmt(guided)}", flush=True)

        # ---- 13a: the cross-attention maps of one CFG-batch forward ---------
        x, tsteps, ctx = tools.unet_inputs(gen)
        kv = m.unet.cross_kv(ctx)
        fwd_out = []
        hook = m.unet.register_forward_hook(lambda mod, i, o: fwd_out.append(o))
        tools.reset_launches()
        t0 = time.perf_counter()
        try:
            maps = collect_attention_maps(m.unet, x, tsteps, ctx, cross_kv=kv, cfg_dup=True)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        sec = time.perf_counter() - t0
        launches["attention_maps_forward"] = tools.launches()
        check_launches(launches["attention_maps_forward"], tools.PER_FORWARD_BF16, 1, "phase 13a")
        plain_out = m.unet(x, tsteps, ctx, cross_kv=kv, cfg_dup=True)
        with kernels.plain_kernels():
            maps_p = collect_attention_maps(m.unet, x, tsteps, ctx, cross_kv=kv, cfg_dup=True)
        sums = max(float((v.sum(-1) - 1).abs().max()) for v in maps.values())
        # each row's departure from the uniform 1/77 (a near-uniform row of
        # the wrong q or k would be within a few percent of the right one)
        dev_u = lambda v: v - 1.0 / v.shape[-1]
        map_err = max(rel_l2(dev_u(maps[k]), dev_u(maps_p[k])) for k in maps)
        tokens = sorted({v.shape[1] for v in maps.values()})
        if (len(maps) != 16 or maps.keys() != maps_p.keys() or sums > MAP_ROW_SUM_ABS
                or not all(torch.isfinite(v).all() and v.shape[-1] == 77 for v in maps.values())):
            raise SystemExit(f"phase 13a: {len(maps)} maps, rows sum to 1 within {sums:.3e}")
        if not map_err <= UNET_REL_L2:
            raise SystemExit(f"phase 13a: maps through the kernels rel L2 {map_err:.3e} from the plain versions'")
        if not torch.equal(fwd_out[0], plain_out):
            raise SystemExit("phase 13a: the UNet output differs with the collector on")
        print(f"phase 13a collect_attention_maps [2,64,128,9] bf16 cfg_dup cross_kv: {len(maps)} maps [2, Nq, 77] "
              f"at Nq {tokens}, rows sum to 1 within {sums:.2e}, kernels vs plain max rel_l2 of (map - 1/77)="
              f"{map_err:.3e} (limit "
              f"{UNET_REL_L2}), the UNet output bit-equal with the collector off; seconds={sec:.3f} launches="
              f"{ {k: v for k, v in launches['attention_maps_forward'].items() if v} }", flush=True)
    del bundle, task, m, cond, uc, maps, maps_p, kv
    torch.cuda.empty_cache()

    # ---- 13m: multi_cond_sample, K = 2 conditionings of one V=4 scene -------
    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), view_num=VIEWS)
    tok, _, prompts = build_multiview_prompt_tokenizer(VIEWS)
    mv_task = tasks.MultiViewRefInpaintTask(SimpleNamespace(model=model, tokenizer=tok, view_num=VIEWS,
                                                            concat_target=False), "cuda")
    with torch.inference_mode():
        images, masks = tools.multiview_scene(VIEWS, seed=0)
        conds, unconds = [], []
        tokens = torch.as_tensor(tok.tokenize(prompts), dtype=torch.long, device="cuda")
        null = torch.as_tensor(np.repeat(tok.tokenize(""), VIEWS, axis=0), dtype=torch.long, device="cuda")
        for k in range(2):  # the same target view 0, other reference views
            imgs = tools.multiview_scene(VIEWS, seed=k)[0]
            imgs[:, 0] = images[:, 0]
            im, mk = (torch.as_tensor(a[0], device="cuda") for a in (imgs, masks))
            c = model.build_inpaint_cond(tokens, mk, im * (mk < 0.5))
            conds.append(c)
            unconds.append(Conditioning(c.c_concat, model.get_learned_conditioning(null)))
        stack = lambda cs: Conditioning(torch.stack([c.c_concat for c in cs]), torch.stack([c.c_crossattn for c in cs]))
        mv_shape = (VIEWS, 64, 64, 4)
        torch.cuda.synchronize()
        tools.reset_launches()
        t0 = time.perf_counter()
        z = mv_task.multi_cond_sample(stack(conds), stack(unconds), mv_shape, 2.5, ddim_steps=10,
                                      generator=torch.Generator("cuda").manual_seed(31))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    launches["multi_cond_mv4_k2_ddim10"] = tools.launches()
    check_launches(launches["multi_cond_mv4_k2_ddim10"], tools.PER_FORWARD_MV4, 10, "phase 13m")
    if tuple(z.shape) != mv_shape or not torch.isfinite(z).all():
        raise SystemExit(f"phase 13m: output {tuple(z.shape)} or not finite")
    print(f"phase 13m multi_cond_sample K=2 V={VIEWS} 512x512 views bf16 DDIM-10 cfg2.5 (UNet batch "
          f"{2 * 2 * VIEWS} rows): seconds={sec:.3f} output {tuple(z.shape)} finite launches="
          f"{ {k: v for k, v in launches['multi_cond_mv4_k2_ddim10'].items() if v} }", flush=True)
    del model, mv_task, conds, unconds
    torch.cuda.empty_cache()
    print(f"phase 13 total seconds={time.perf_counter() - t_phase:.1f}", flush=True)


# phase 14: the parallel paths, each rank a process on the one card (gloo)
ROW_REL_L2 = 1e-3  # 14b: a rank's UNet rows against the same rows run alone at batch 1 (read: equal)
# 14v: phase 3m's limit (its forward's, UNET_REL_L2).  Each rank's query rows
# meet every view's keys, but a rank's middle block has 128 (2 view ranks)
# or 64 (4) queries, below K1's 256: the exact softmax where the one-rank
# forward's 256 take K1, a rounding difference the random-weight UNet
# spreads as it does phase 3's (1.6e-2 there)
VIEW_REL_L2 = UNET_REL_L2
CLI_DP_STEPS, CLI_DP_BATCH = 2, 4  # 14c: the shipped batch of 8 over 2 ranks
RANK_TIMEOUT = 600


def _rank_counts(arr) -> dict:
    from leftrefill_torch import tools

    return dict(zip(tools.LAUNCH_COUNTERS, (int(c) for c in arr)))


def _summed(arrays) -> dict:
    import numpy as np

    return _rank_counts(np.sum(arrays, axis=0))


def _ranks(work: str, body: str, world: int, **kwargs) -> list:
    from leftrefill_torch.tools.dryrun import run_ranks

    return run_ranks(f"leftrefill_torch.tools.parallel_smoke:{body}", world, work, kwargs, device="cuda",
                     timeout=RANK_TIMEOUT)


def phase_14b(work: str, launches: dict) -> None:
    """A CFG-parallel request over 2 ranks, bf16 then fused int8."""
    import numpy as np

    from leftrefill_torch import tools

    t0 = time.perf_counter()
    res = _ranks(work, "cfg_request", 2)
    for arm, steps, per_forward, label in (("bf16", 50, tools.PER_FORWARD_BF16, "bf16 ddim50 eta1"),
                                           ("int8", 15, tools.PER_FORWARD_INT8, "int8 fused dpm++2m15")):
        want = {n: c * steps for n, c in per_forward.items()}
        for r, o in enumerate(res):
            if _rank_counts(o[f"{arm}/launches"]) != want:
                raise SystemExit(f"phase 14b {arm}: rank {r} launches {_rank_counts(o[f'{arm}/launches'])}, "
                                 f"expected {want}")
            rows = o[f"{arm}/row_rel_l2"]
            if int(o[f"{arm}/calls"]) != steps or len(rows) != 4 or not rows.max() <= ROW_REL_L2:
                raise SystemExit(f"phase 14b {arm}: rank {r}, {int(o[f'{arm}/calls'])} UNet calls, its rows against "
                                 f"the rows alone rel L2 {rows} (limit {ROW_REL_L2})")
        images = [o[f"{arm}/image"] for o in res]
        if not (np.isfinite(images[0]).all() and np.array_equal(images[0], images[1])):
            raise SystemExit(f"phase 14b {arm}: the ranks' canvases differ or are not finite")
        rows = [[f"{e:.3e}" for e in o[f"{arm}/row_rel_l2"]] for o in res]
        swapped = np.concatenate([o[f"{arm}/swapped_rel_l2"] for o in res])
        print(f"phase 14b CFG-parallel request 512x1024 {label} cfg2.5 b1 over 2 ranks (gloo, one card): the "
              f"ranks' UNet rows at calls 0 and {steps // 2} against the same rows alone at batch 1 rel_l2={rows} "
              f"(limit {ROW_REL_L2}; the uncond and cond rows swapped read {swapped.min():.3f}-{swapped.max():.3f}); "
              f"ranks' canvases bit-equal; launches per rank {({n: c for n, c in want.items() if c})} ({steps} "
              f"forwards); for information: rel_l2 against the one-rank request "
              f"{float(res[0][f'{arm}/vs_one_rank_rel_l2']):.3e}, seconds_per_request "
              f"split={[round(float(o[f'{arm}/s_split']), 3) for o in res]} "
              f"one_rank={float(res[0][f'{arm}/s_one_rank']):.3f} (the ranks share the card: no speed-up "
              f"claimed), peak_gib={[round(float(o[f'{arm}/peak_gib']), 1) for o in res]}", flush=True)
    launches["14b"] = _summed([o[f"{arm}/launches"] for o in res for arm in ("bf16", "int8")])
    print(f"phase 14b seconds={time.perf_counter() - t0:.1f}", flush=True)


def phase_14v(work: str, launches: dict) -> dict:
    """The V=4 forward with the views split over (view 2), (view 4) and
    (data 2, view 2) ranks; K1 at the ranks' Nq != Nk sites held and timed.
    Returns K1's reports by layout."""
    import torch

    from leftrefill_torch import tools

    t0 = time.perf_counter()
    reports = {}
    runs = {2: _ranks(work, "view_forward", 2, layouts=[[1, 2]]),
            4: _ranks(work, "view_forward", 4, layouts=[[1, 4], [2, 2]])}
    gen = torch.Generator("cuda").manual_seed(14)
    for (n_data, n_view), path in (((1, 2), "14v2"), ((1, 4), "14v4"), ((2, 2), "14vd")):
        key, res = f"{n_data}x{n_view}", runs[n_data * n_view]
        want_sites = tools.VIEW_RANK_SITES[(n_data, n_view)]
        for r, o in enumerate(res):
            got = _rank_counts(o[f"{key}/launches"])
            sites = collections.Counter(tuple(int(v) for v in row[:5]) for row in o[f"{key}/k1_sites"])
            if got != tools.PER_FORWARD_MV4_VIEW_RANK or sites != collections.Counter(want_sites):
                raise SystemExit(f"phase 14v {key}: rank {r} launches {got}, K1 sites {dict(sites)}")
            if not float(o[f"{key}/rel_l2"]) <= VIEW_REL_L2:
                raise SystemExit(f"phase 14v {key}: rank {r} rel L2 {float(o[f'{key}/rel_l2']):.3e} from the "
                                 f"one-rank forward's rows (limit {VIEW_REL_L2})")
        launches[path] = _summed([o[f"{key}/launches"] for o in res])
        errs = [f"{float(o[f'{key}/rel_l2']):.3e}" for o in res]
        control = min(float(o[f"{key}/reversed_rel_l2"]) for o in res)
        ms = [round(float(o[f"{key}/ms"]), 2) for o in res]
        print(f"phase 14v V=4 forward [8,64,64,9] bf16, views over ({n_data} data, {n_view} view) ranks, "
              f"{int(res[0][f'{key}/rows'])} rows a rank: rel_l2 against the one-rank forward's rows={errs} "
              f"(limit {VIEW_REL_L2}; the rank's rows reversed read {control:.3f}); launches per rank "
              f"{({n: c for n, c in tools.PER_FORWARD_MV4_VIEW_RANK.items() if c})}, K1 sites (b, h, nq, nk, d) "
              f"{want_sites}; forward_ms per rank={ms} (the ranks share the card)", flush=True)
        reports[key] = {}
        for shape, n in sorted(want_sites.items()):
            check_site("flash_fwd", shape, gen, n, reports[key], f"14v {key}")
    print(f"phase 14v seconds={time.perf_counter() - t0:.1f} peak_gib="
          f"{[round(float(o['peak_gib']), 1) for o in runs[4]]}", flush=True)
    return reports


def phase_14t(work: str, launches: dict) -> None:
    """Phase 7's step over 2 gloo ranks x 4 against 1 rank x 8, then through
    an NCCL group of one."""
    import numpy as np
    import torch

    from leftrefill_torch import tools

    t0 = time.perf_counter()
    ref = _ranks(work, "train_step", 1, reference=True)[0]
    dp = _ranks(work, "train_step", 2, reference=False)
    one, nccl, gloo = "one_rank", "group_nccl_1", "group_gloo_2"
    want = dict(tools.PER_TRAIN_STEP)
    for who, o, arm in (("one rank", ref, one), ("nccl", ref, nccl), ("rank 0", dp[0], gloo),
                        ("rank 1", dp[1], gloo)):
        if _rank_counts(o[f"{arm}/launches"]) != want:
            raise SystemExit(f"phase 14t {who}: launches {_rank_counts(o[f'{arm}/launches'])}, expected {want}")
    grad = torch.from_numpy(ref[f"{one}/grad"])
    errs = [tools.rel_l2(torch.from_numpy(o[f"{gloo}/grad"]), grad) for o in dp]
    nccl_err = tools.rel_l2(torch.from_numpy(ref[f"{nccl}/grad"]), grad)
    if not (np.array_equal(dp[0][f"{gloo}/table"], dp[1][f"{gloo}/table"]) and max(errs) <= PROMPT_GRAD_REL_L2
            and nccl_err <= PROMPT_GRAD_REL_L2 and grad.abs().max() > 0):
        raise SystemExit(f"phase 14t: averaged gradient rel L2 {errs}, the NCCL step's {nccl_err:.3e} (limit "
                         f"{PROMPT_GRAD_REL_L2}), or the ranks' tables differ")
    launches["14t"] = _summed([o[f"{gloo}/launches"] for o in dp] + [ref[f"{nccl}/launches"]])
    print(f"phase 14t prompt-tuning step (phase 7's: remat, AdamW 3e-5, wd 0.01), 2 gloo ranks x batch 4 against "
          f"1 rank x batch 8 on the same global draws: averaged prompt gradient rel_l2={[f'{e:.3e}' for e in errs]} "
          f"(limit {PROMPT_GRAD_REL_L2}; a gradient that is not averaged reads ~1); ranks' tables after the step "
          f"bit-equal, {float(np.abs(dp[0][f'{gloo}/table'] - ref[f'{one}/table']).max()):.3e} from the one-rank "
          f"table; an NCCL group of one rel_l2={nccl_err:.3e}; launches per rank "
          f"{({n: c for n, c in want.items() if c})}; losses one_rank={float(ref[f'{one}/loss']):.5f} "
          f"ranks={[round(float(o[f'{gloo}/loss']), 5) for o in dp]}; seconds_per_step "
          f"one_rank={float(ref[f'{one}/s']):.3f} nccl={float(ref[f'{nccl}/s']):.3f} "
          f"ranks={[round(float(o[f'{gloo}/s']), 3) for o in dp]}; peak_gib one_rank="
          f"{float(ref[f'{one}/peak_gib']):.1f} ranks={[round(float(o[f'{gloo}/peak_gib']), 1) for o in dp]}; "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)


def phase_14c(work: str, launches: dict) -> None:
    """``leftrefill_torch.cli.train --nchip 2`` under torchrun on the
    synthetic MegaDepth tree (its ranks through ``parallel_smoke cli``)."""
    import os
    import subprocess

    import numpy as np
    import torch

    from leftrefill_torch import tools

    t0 = time.perf_counter()
    root = Path(work, "megadepth")
    paths = tools.write_megadepth_scenes(str(root), MD_SCENES, MD_IMAGES, seed=0, train_pairs_per_scene=MD_TRAIN_PAIRS,
                                         other_pairs_per_scene=MD_OTHER_PAIRS, images=tools.MEGADEPTH_IMAGES[:1],
                                         mask_size=512)
    args = megadepth_yamls(str(root), paths, "ref_inpainting", "phase 14c",
                           (("batch_size: 8", f"batch_size: {CLI_DP_BATCH}"),))
    out = Path(work, "cli")
    out.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m",
           "leftrefill_torch.tools.parallel_smoke", "cli", str(out), "--", *args, "--nchip", "2", "--no_restore",
           "--max_steps", str(CLI_DP_STEPS)]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
                          timeout=RANK_TIMEOUT)
    if proc.returncode != 0:
        raise SystemExit(f"phase 14c: torchrun returned {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-5000:]}")
    res = [np.load(out / f"rank{r}.npz") for r in range(2)]
    want = dict(tools.PER_TRAIN_STEP_CLI)
    for r, o in enumerate(res):
        if int(o["rc"]) or len(o["step_s"]) != CLI_DP_STEPS or any(_rank_counts(c) != want for c in o["launches"]):
            raise SystemExit(f"phase 14c: rank {r} rc {int(o['rc'])}, {len(o['step_s'])} steps, launches "
                             f"{[_rank_counts(c) for c in o['launches']]}")
    saved = torch.load(root / "ck" / "ref_inpainting" / "ckpts" / "last.pt", weights_only=True)
    table = saved["cond_stage_model.special_embeddings.weight"].float().numpy()
    writes = [(int(o["saves"]), int(o["grids"])) for o in res]
    if not (np.array_equal(res[0]["tables"], res[1]["tables"]) and np.array_equal(table, res[0]["tables"][-1])
            and writes[0][0] == 1 and writes[1] == (0, 0)):
        raise SystemExit(f"phase 14c: the ranks' tables differ after a step, or the checkpoint is not rank 0's "
                         f"last table, or the ranks' (checkpoints, grids) written {writes}")
    launches["14c"] = _summed([c for o in res for c in o["launches"]])
    backend = re.search(r"backend (\w+)", proc.stdout + proc.stderr)
    print(f"phase 14c torchrun --nproc_per_node 2 -m leftrefill_torch.cli.train --nchip 2 (backend "
          f"{backend.group(1) if backend else 'not printed'}) on the synthetic MegaDepth tree, batch {CLI_DP_BATCH} a "
          f"rank ({2 * CLI_DP_BATCH} a step), {CLI_DP_STEPS} steps, one validation batch at DDIM-10: ranks' tables "
          f"bit-equal after each step, only rank 0 wrote checkpoints and sample grids ((checkpoints, grids) by rank "
          f"{writes}); launches per step {({n: c for n, c in want.items() if c})}; seconds_per_step="
          f"{[[round(float(x), 3) for x in o['step_s']] for o in res]} data_seconds_between_steps="
          f"{[round(float(o['start'][1] - o['start'][0] - o['step_s'][0]), 3) for o in res]} "
          f"cli_seconds={[round(float(o['cli_s']), 1) for o in res]} peak_gib="
          f"{[round(float(o['peak_gib']), 1) for o in res]} seconds={time.perf_counter() - t0:.1f}", flush=True)


def parallel_phases(launches: dict) -> dict:
    """Phases 14b, 14v, 14t and 14c (module docstring); each path's launches,
    summed over its ranks, go into ``launches``.  Returns K1's reports at the
    view ranks' Nq != Nk sites, by layout."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="parallel_")
    try:
        phase_14b(work, launches)
        reports = phase_14v(work, launches)
        phase_14t(work, launches)
        phase_14c(work, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 14 seconds={time.perf_counter() - t0:.1f}", flush=True)
    return reports


# ---- phase 15: the model options that no shipped config sets ---------------
WRONG_FACTOR = 3  # a wrong kernel's reading (15q's dropped weight scale) over the decode's limit
DEEP_CONTROL_FACTOR = 3  # 15d's reversed slices over the deep forward's limit


def phase_15q(launches: dict, gen) -> dict:
    """Phase 15q (the docstring): the fused int8 request with the int8 VAE
    decoder; returns the report of KI1's and K2's decode sites."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.data.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE, imread, resize
    from leftrefill_torch.models.autoencoder import AutoencoderKL
    from leftrefill_torch.serving import gradio_app
    from leftrefill_torch.tools import rel_l2
    from leftrefill_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    fixtures = ROOT / "tests" / "fixtures" / "jpeg"
    label = "phase 15q"
    root = tempfile.mkdtemp(prefix="int8_vae_")
    try:
        exp = Path(root, "exp")  # phase 11's experiment directory
        exp.mkdir()
        shutil.copy(ROOT / "configs" / "ref_inpainting.yaml", exp / "model_config.yaml")
        table = 0.02 * torch.randn((50, 1024), generator=torch.Generator().manual_seed(5))
        CheckpointManager(str(exp / "ckpts")).save_last(100, {"cond_stage_model.special_embeddings.weight": table})
        reference = imread(str(fixtures / "baseline_420.jpg"), IMREAD_COLOR)
        source = imread(str(fixtures / "progressive_420.jpg"), IMREAD_COLOR)
        mask = imread(str(fixtures / "mask_palette.png"), IMREAD_GRAYSCALE)
        t0 = time.perf_counter()
        pipe = gradio_app.initialize_model(str(exp), quantized=True, quant_vae=True, sampler="dpm++2m")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        model, vae = pipe.model, pipe.model.first_stage_model
        if not (vae.quant_decoder and vae.decoder.mid.block_1.conv1.weight.dtype == torch.int8
                and model.unet.input_blocks[1][0].in_layers[2].weight.dtype == torch.int8):
            raise SystemExit(f"{label}: the served UNet or decoder is not the int8 one")
        request = dict(ddim_steps=15, num_samples=1, scale=2.5, seed=7, img_size=512)
        gradio_app.predict(pipe, reference, source, mask, **{**request, "seed": 6})  # the first request
        torch.cuda.synchronize()
        tools.reset_launches()
        t0 = time.perf_counter()
        out = gradio_app.predict(pipe, reference, source, mask, **request)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = tools.launches()
        want = {n: 15 * tools.PER_FORWARD_INT8[n] + tools.PER_DECODE_VAE8[n] for n in tools.LAUNCH_COUNTERS}
        if got != want:
            raise SystemExit(f"{label}: request launches {got}, expected {want}")
        launches["15q_predict_int8_vae_dpm15"] = got
        image, full_mask = gradio_app.request_canvas(reference, source, mask, 1, 512)
        keep = full_mask[0, :, 512:, 0] == 0
        target = resize(source, (512, 512), 3)
        off = int(np.abs(out[0][keep].astype(int) - target[keep].astype(int)).max())
        if out[0].shape != (512, 512, 3) or off > 1 or keep.all() or not keep.any():
            raise SystemExit(f"{label}: output {out[0].shape}, outside the hole {off} levels from the target")
        print(f"{label} predict 512 dpm++2m15 int8 fused UNet + int8 VAE decoder eta1 cfg2.5: "
              f"initialize_model_seconds={init_s:.1f} request_seconds={secs:.3f} "
              f"launches={ {k: v for k, v in got.items() if v} } (15 forwards x PER_FORWARD_INT8 + one decode "
              f"x PER_DECODE_VAE8); outside the hole within {off} level of the target", flush=True)

        # the decode of the canvas's latent: its sites, then the whole decode, kernels vs plain versions
        report = {}
        with torch.inference_mode():
            z = model.encode_first_stage(torch.as_tensor(image, device="cuda"))
            decode = lambda: model.decode_first_stage(z)  # noqa: E731
            with kernels.record_sites() as recorded:
                decode()
            sites = collections.Counter(recorded)
            per_decode = {n: sum(c for (k, _), c in sites.items() if k == n) for n in tools.LAUNCH_COUNTERS}
            if per_decode != tools.PER_DECODE_VAE8:
                raise SystemExit(f"{label}: decode sites {per_decode}, expected {tools.PER_DECODE_VAE8}")
            check_kernels(sites, gen, report, "15q int8 VAE decode", ("conv3x3_int8", "conv3x3"))
            out_k = decode()
            with kernels.plain_kernels(("conv3x3_int8", "conv3x3")):
                out_p = decode()
            dec_ms = tools.cuda_ms(decode, 3)
        err = rel_l2(out_k, out_p)
        # a wrong kernel: KI1's weight scale dropped at one site (64x128, 512 -> 512; the block's
        # second conv, whose output meets the residual: the first one's feeds a GroupNorm,
        # which takes most of a scale back out)
        conv = vae.decoder.mid.block_1.conv2
        kept = conv.weight_scale.detach().clone()
        with torch.no_grad():
            conv.weight_scale.fill_(1.0)
            wrong = rel_l2(model.decode_first_stage(z), out_p)
            conv.weight_scale.copy_(kept)
        if not (torch.isfinite(out_k).all() and err <= UNET_REL_L2 < WRONG_FACTOR * UNET_REL_L2 < wrong):
            raise SystemExit(f"{label}: the int8 decode through the kernels reads rel L2 {err:.3e} from the plain "
                             f"versions' (limit {UNET_REL_L2}), the wrong kernel's {wrong:.3e} (must read above "
                             f"{WRONG_FACTOR * UNET_REL_L2})")
        # the bf16 decoder of the same fp32 weights
        fp_vae = gradio_app.load_experiment(str(exp), None, gradio_app.INIT_SEED, "cuda",
                                            torch.float32).bundle.model.first_stage_model
        with torch.device("meta"):
            bf16_vae = AutoencoderKL(vae.ddconfig, vae.embed_dim, dtype=torch.bfloat16)
        bf16_vae = bf16_vae.to_empty(device="cuda").eval()
        bf16_vae.load_state_dict(fp_vae.state_dict(), strict=True)
        del fp_vae
        with torch.inference_mode():
            ref = bf16_vae.decode(z / model.scale_factor).float().clamp(-1, 1)
        mse = float(((out_k.float().clamp(-1, 1) - ref) ** 2).mean())
        psnr = 10 * math.log10(4.0 / mse)  # images in [-1, 1]: a peak-to-peak of 2
        print(f"{label} int8 VAE decode of the canvas's latent [1,64,128,4] -> [1,512,1024,3]: kernels vs plain "
              f"versions rel_l2={err:.3e} (limit {UNET_REL_L2}); a wrong kernel (KI1's weight scale dropped at "
              f"decoder.mid.block_1.conv2) reads rel_l2={wrong:.3e}; PSNR against the bf16 decoder of the same "
              f"weights {psnr:.2f} dB; decode_ms={dec_ms:.2f}; sites={per_decode}", flush=True)
        del pipe, model, vae, bf16_vae
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 15q total seconds={time.perf_counter() - t_phase:.1f}", flush=True)
    return report


def phase_15d(root: str, paths: dict, launches: dict) -> None:
    """Phase 15d (the docstring): deep-prompt tuning through the CLI on phase
    12's tree ``root``."""
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.cli import train as cli
    from leftrefill_torch.data import loader
    from leftrefill_torch.data.loader import DataLoader
    from leftrefill_torch.tools import rel_l2
    from leftrefill_torch.train import compute_loss, trainer

    label = "phase 15d"
    t_phase = time.perf_counter()
    work = Path(root, "deep")
    work.mkdir()
    args = megadepth_yamls(str(work), paths, "ref_inpainting", label, model_edits=(
        ("deep_prompt: False", "deep_prompt: True"),
        ('      sp_token: "<special-token>"', '      sp_token: "<special-token>"\n      deep_prompt: True')))
    runs, loaders = [], []
    make_train_step, data_loader = trainer.make_train_step, loader.DataLoader

    class Recorded(data_loader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append(self)

    trainer.make_train_step, loader.DataLoader = recording_steps(make_train_step, runs), Recorded
    try:
        t0 = time.perf_counter()
        rc = cli.main(args + ["--no_restore", "--max_steps", "2"])
        cli_s = time.perf_counter() - t0
    finally:
        trainer.make_train_step, loader.DataLoader = make_train_step, data_loader
    if rc or len(runs) != 1:
        raise SystemExit(f"{label}: the CLI returned {rc} after {len(runs)} runs")
    run = runs[0]
    steps, model = run["steps"], run["model"]
    losses = [st["loss"] for st in steps]
    if len(steps) != 2 or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: {len(steps)} steps, losses {losses}")
    for i, st in enumerate(steps):
        if st["launches"] != tools.PER_TRAIN_STEP_CLI or st["tokens"] != (8, 16, 77):
            raise SystemExit(f"{label}: step {i} launches {st['launches']}, tokens {st['tokens']}")
    sites = collections.Counter(steps[0]["sites"])
    for name in BWD_NAMES:
        got = {shape: c for (n, shape), c in sites.items() if n == name}
        if got != tools.TRAIN_SITES:
            raise SystemExit(f"{label}: {name} sites {got}, expected {tools.TRAIN_SITES}")
    key = "cond_stage_model.special_embeddings.weight"
    after = model.state_dict()
    changed = sorted(k for k in after if not torch.equal(run["before"][k], after[k]))
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    moved = (after[key].float() - run["before"][key].float()).abs().amax(dim=1).reshape(16, 50).amax(dim=1)
    if changed != [key] or trainable != [key] or tuple(after[key].shape) != (800, 1024) or not bool((moved > 0).all()):
        raise SystemExit(f"{label}: changed {changed[:5]}, trainable {trainable[:5]}, table "
                         f"{tuple(after[key].shape)}, moved per layer {moved.tolist()}")
    exp = Path(str(work), "ck", "ref_inpainting")
    val = [r for r in (json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines())
           if "val/psnr" in r]
    if len(val) != 1 or not math.isfinite(val[0]["val/psnr"]):
        raise SystemExit(f"{label}: validation records {val}")
    launches["15d_cli_train_deep_b8"] = {n: sum(st["launches"][n] for st in steps) for n in tools.LAUNCH_COUNTERS}
    print(f"{label} deep-prompt tuning (16 layers x 50 prompt tokens, table (800, 1024)) b8 512x1024 through "
          f"leftrefill_torch.cli.train: seconds_per_step={[round(st['s'], 3) for st in steps]} "
          f"losses={[round(x, 5) for x in losses]} tokens={steps[0]['tokens']} launches_per_step="
          f"{ {n: c for n, c in tools.PER_TRAIN_STEP_CLI.items() if c} } every layer's rows moved (min "
          f"{float(moved.min()):.3e}) val_psnr={val[0]['val/psnr']:.3f} cli_seconds={cli_s:.1f}", flush=True)

    # the deep table's gradient on a batch of 2 from the CLI's loader, kernels vs plain versions
    train_loader = loaders[0]
    small_loader = DataLoader(train_loader.dataset, 2, sampler=train_loader.sampler, tokenizer=train_loader.tokenizer)
    small = {k: v for k, v in next(iter(small_loader)).items() if k != "txt"}
    table = model.cond_stage_model.special_embeddings.weight

    def deep_grad():  # t and the noise drawn from the same seed each time
        table.grad = None
        compute_loss(model, small, generator=torch.Generator(table.device).manual_seed(11))[0].backward()
        torch.cuda.synchronize()
        return table.grad.clone()

    grad_k = deep_grad()
    with kernels.plain_kernels():
        grad_p = deep_grad()
    table.grad = None
    err = rel_l2(grad_k, grad_p)
    if not (torch.isfinite(grad_k).all() and grad_k.abs().max() > 0 and err <= PROMPT_GRAD_REL_L2):
        raise SystemExit(f"{label}: deep-table gradient through the kernels rel L2 {err:.3e} from the plain "
                         f"versions' (limit {PROMPT_GRAD_REL_L2}) or zero / non-finite")
    layers_hit = int((grad_k.abs().amax(dim=1).reshape(16, 50).amax(dim=1) > 0).sum())
    print(f"{label} deep-table gradient on a batch of 2 from the CLI's loader (tokens "
          f"{tuple(small['tokens'].shape)}): kernels vs plain versions rel_l2={err:.3e} (limit "
          f"{PROMPT_GRAD_REL_L2}) grad_norm={float(grad_k.norm()):.4e} layers_with_a_gradient={layers_hit}/16",
          flush=True)

    # a full-width forward under a deep context of 16 distinct slices
    gen = torch.Generator("cuda").manual_seed(15)
    unet = model.unet
    with torch.inference_mode():
        x, tsteps, _ = tools.unet_inputs(gen)
        ctx = torch.randn((2, 16, 77, 1024), generator=gen, device="cuda")
        kv = unet.cross_kv(ctx)
        _, out_p, err, kern_ms, plain_ms = check_forward(unet, x, tsteps, ctx, kv, label, kernels.NAMES)
        rev = ctx.flip(1)
        control = rel_l2(unet(x, tsteps, rev, cross_kv=unet.cross_kv(rev), cfg_dup=True), out_p)
    if control <= DEEP_CONTROL_FACTOR * UNET_REL_L2:
        raise SystemExit(f"{label}: the forward with the slices reversed reads {control:.3e}, not above "
                         f"{DEEP_CONTROL_FACTOR * UNET_REL_L2}: the transformers do not read their own slices")
    print(f"{label} unet forward [2,64,128,9] bf16 cfg_dup cross_kv under a deep context [2,16,77,1024]: "
          f"kernels vs plain versions rel_l2={err:.3e} (limit {UNET_REL_L2}); the control, the slices reversed, "
          f"reads rel_l2={control:.3e}; kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f}; phase "
          f"seconds={time.perf_counter() - t_phase:.1f}", flush=True)
    del model, unet, runs, loaders, train_loader, small_loader, table, grad_k, grad_p
    torch.cuda.empty_cache()


def option_unet(options: dict, quant: bool):
    """The full-width UNet with ``options`` on the card in bf16 (``quant``:
    the fused int8 one), its fp32 weights drawn from seed 0 (and quantized
    per output channel), as ``build_sd2_inpaint_bundle`` builds its UNet."""
    import torch

    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.ops.quant import quantize_params_like
    from leftrefill_torch.pipeline import fill_random_

    with torch.device("meta"):
        fp, unet = UNetModel(dtype=torch.float32, **options), UNetModel(dtype=torch.bfloat16, quant=quant, **options)
    fp, unet = fp.to_empty(device="cuda"), unet.to_empty(device="cuda")
    fill_random_(fp, torch.Generator("cuda").manual_seed(0))
    unet.load_state_dict(quantize_params_like(unet, fp.state_dict()) if quant else fp.state_dict(), strict=True)
    return unet.eval()


def scale_shift_k4_sites(fwd, expected: int) -> dict:
    """Every K4 site of one fused int8 forward whose GroupNorm fold carries a
    scale-shift, on its own inputs: the kernel against its plain version
    (phase 2f's bound), timed as in ``check_site``.  Fails unless there are
    ``expected`` such sites.  Returns the report."""
    from leftrefill_torch import tools
    from leftrefill_torch.ops import quant
    from leftrefill_torch.tools import cuda_ms

    captured = []
    fused = quant.gn_silu_conv3x3_int8

    def recording(x, gamma, beta, w, w_scale, bias, **kw):
        if kw.get("scale_shift") is not None:
            a, bb = quant.gn_affine_ab(*quant.gn_moments(x), gamma, beta, kw["num_groups"], kw["eps"], None,
                                       kw["scale_shift"])
            captured.append((x.clone(), a, bb))
        return fused(x, gamma, beta, w, w_scale, bias, **kw)

    quant.gn_silu_conv3x3_int8 = recording
    try:
        fwd()
    finally:
        quant.gn_silu_conv3x3_int8 = fused
    if len(captured) != expected:
        raise SystemExit(f"phase 15u unet_a_int8: {len(captured)} K4 sites fold a scale-shift, expected {expected}")
    r = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None, "sites": 0,
         "bound_ops_ms": 0.0}
    for i, (x, a, bb) in enumerate(captured):
        run, plain = (functools.partial(fn, x, a, bb) for fn in (quant.silu_quant_op, quant.silu_quant_plain))
        reading, mae = compare("affine_silu_quant", run(), plain())
        ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
        bound, _ = tools.bound_ms("affine_silu_quant", tuple(x.shape))
        print(f"phase 15u unet_a_int8 affine_silu_quant scale-shift site {i} shape={tuple(x.shape)} {reading} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} (bytes) "
              f"bound_share={bound / ms:.3f}")
        r["max_abs_err"] = max(r["max_abs_err"], mae)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound
        r["sites"] += 1
    return {"affine_silu_quant": r}


def phase_15u(launches: dict, gen) -> dict:
    """Phase 15u (the docstring): the option UNets at full width; returns the
    reports of their kernel sites by UNet."""
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.models.unet import ResBlock
    from leftrefill_torch.tools import cuda_ms

    t_phase = time.perf_counter()
    reports = {}
    x, tsteps, ctx = tools.unet_inputs(gen)
    for key, options, quant, per_forward in (("unet_a_bf16", tools.UNET_A, False, tools.PER_FORWARD_UNET_A),
                                             ("unet_a_int8", tools.UNET_A, True, tools.PER_FORWARD_UNET_A_INT8),
                                             ("unet_b_bf16", tools.UNET_B, False, tools.PER_FORWARD_UNET_B)):
        label = f"phase 15u {key}"
        site_label = label[len("phase "):]  # check_site prints its own "phase "
        unet = option_unet(options, quant)
        report = {}
        with torch.inference_mode():
            kv = unet.cross_kv(ctx)
            sites = tools.unet_sites(unet, x, tsteps, ctx, kv)
            per_site = {n: sum(c for (k, _), c in sites.items() if k == n) for n in tools.LAUNCH_COUNTERS}
            if per_site != per_forward:
                raise SystemExit(f"{label}: sites per forward {per_site}, expected {per_forward}")
            tools.reset_launches()
            unet(x, tsteps, ctx, cross_kv=kv, cfg_dup=True)
            torch.cuda.synchronize()
            launches["15u_" + key] = tools.launches()
            check_launches(launches["15u_" + key], per_forward, 1, label)
            if not quant:
                # K2 at every site of (A), its ResBlocks scale-shifted; K1 at every site of (B), D = 128 among them
                check_kernels(sites, gen, report, site_label,
                              ("conv3x3",) if key == "unet_a_bf16" else ("flash_fwd",))
                _, _, err, kern_ms, plain_ms = check_forward(unet, x, tsteps, ctx, kv, label, kernels.NAMES)
                print(f"{label} unet forward [2,64,128,9] {options} cfg_dup cross_kv: rel_l2={err:.3e} (limit "
                      f"{UNET_REL_L2}) kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f} sites="
                      f"{ {n: c for n, c in per_site.items() if c} }", flush=True)
            else:
                check_kernels(sites, gen, report, site_label, ("conv3x3_int8",))
                fwd = lambda: unet(x, tsteps, ctx, cross_kv=kv, cfg_dup=True)  # noqa: E731
                # the second stack of every ResBlock, all of them fused at full width
                n_res = sum(isinstance(m, ResBlock) and m.use_scale_shift_norm for m in unet.modules())
                reports["unet_a_int8_scale_shift_k4"] = scale_shift_k4_sites(fwd, n_res)
                errs, e2e = tools.teacher_forced(unet, fwd, PROLOGUES)
                worst = max(errs.items(), key=lambda kv_: kv_[1][2])
                st = [e for e in errs.values() if e[0] == "SpatialTransformer"]
                st_l2 = (sum((e[1] * e[3]) ** 2 for e in st) / sum(e[3] ** 2 for e in st)) ** 0.5
                exact = all(e[1] == 0 for e in errs.values())
                if worst[1][2] > BLOCK_MAX_REL or st_l2 > TRANSFORMERS_L2 or (exact and e2e > UNET_REL_L2):
                    raise SystemExit(f"{label}: block {worst[0]} max rel {worst[1][2]:.3e} > {BLOCK_MAX_REL}, or "
                                     f"the transformers' rel L2 {st_l2:.3e} > {TRANSFORMERS_L2}, or end to end "
                                     f"{e2e:.3e}")
                print(f"{label} unet forward [2,64,128,9] {options} fused int8 cfg_dup cross_kv, K4/K7/K8 vs "
                      f"their plain versions teacher-forced ({len(errs)} blocks): max_block_max_rel="
                      f"{worst[1][2]:.3e} ({worst[0]}) transformers_rel_l2={st_l2:.3e} blocks_equal="
                      f"{sum(e[1] == 0 for e in errs.values())}/{len(errs)} kernels_ms={cuda_ms(fwd, 3):.2f}; for "
                      f"information: rel_l2_end_to_end={e2e:.3e} sites={ {n: c for n, c in per_site.items() if c} }",
                      flush=True)
        reports[key] = report
        del unet, kv
        torch.cuda.empty_cache()
    print(f"phase 15u total seconds={time.perf_counter() - t_phase:.1f}", flush=True)
    return reports


# ---- phase 16: the real-weights runbook and the quality studies ------------
# 16r: the runbook's synthetic A/B on the card, its first pairs at DDIM-10
AB_PAIRS, AB_STEPS = 2, 10
# 16q's gate: each kernel path's mean eps deviation from fp32 at t = QUALITY_T
# within QUALITY_FACTOR times the plain path's plus QUALITY_SLACK (the kernels
# and their plain versions round at the same points; a wrong kernel moves the
# output by its own scale, far past the bf16 or int8 noise)
QUALITY_T, QUALITY_FACTOR, QUALITY_SLACK = 500, 1.5, 1e-3


def phase_16r(launches: dict) -> dict:
    """Phase 16r (the docstring): the runbook's dry run on full-width
    stand-ins; returns its report."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from leftrefill_torch import tools
    from leftrefill_torch.tools import runbook

    t_phase = time.perf_counter()
    label = "phase 16r"
    out = tempfile.mkdtemp(prefix="runbook_")
    try:
        rc = runbook.main(["--synthetic", "--full_width", "--out", out, "--limit", str(AB_PAIRS)])
        with open(Path(out, "report.json")) as f:
            report = json.load(f)
        ckpt_gb = Path(out, "synthetic", "sd_stand_in.ckpt").stat().st_size / 1e9
    finally:
        shutil.rmtree(out, ignore_errors=True)  # the 2.6 GB checkpoint with it
    torch.cuda.empty_cache()
    if rc != 0 or list(report) != list(runbook.STAGES) or not all(r["ok"] for r in report.values()):
        raise SystemExit(f"{label}: the runbook exited {rc}: {json.dumps(report)[:2000]}")
    conv, par, ev, ab = (report[k] for k in ("convert", "parity", "eval", "ab"))
    recomputed = len(runbook.SCHEDULE_BUFFERS) + len(runbook.EMA_KEYS)
    if conv["missing"] or conv["shape_mismatch"] or conv["unexpected"] or conv["skipped_other"] != len(
            runbook.SKIPPED_EXTRA) or conv["skipped_recomputed"] != recomputed:
        raise SystemExit(f"{label}: convert accounting {conv}")
    readings = {k: v["rel_l2"] for k, v in par.items() if isinstance(v, dict)}
    if sorted(readings) != ["bf16_unet", "int8_decode", "int8_unet_blocks"] or not all(
            par[k]["finite"] and v <= runbook.PARITY_REL_L2 for k, v in readings.items()):
        raise SystemExit(f"{label}: parity {par}")
    if not ({"PSNR", "SSIM", "LPIPS"} <= set(ev) and all(np.isfinite(ev[k]) for k in ("PSNR", "SSIM", "LPIPS"))):
        raise SystemExit(f"{label}: eval metrics {ev}")
    cross = {o: ab[f"cross_psnr_bf16_vs_{o}_db"] for o in ("int8", "int8+vae8")}
    if ab["pairs"] != AB_PAIRS or ab["ddim_steps"] != AB_STEPS or not all(np.isfinite(v) for v in cross.values()):
        raise SystemExit(f"{label}: A/B {ab}")
    none = dict.fromkeys(tools.LAUNCH_COUNTERS, 0)
    for name, per_forward, decode in (("bf16", tools.PER_FORWARD_BF16, none), ("int8", tools.PER_FORWARD_INT8, none),
                                      ("int8+vae8", tools.PER_FORWARD_INT8, tools.PER_DECODE_VAE8)):
        got = {n: ab["launches"][name].get(n, 0) for n in tools.LAUNCH_COUNTERS}
        want = {n: AB_PAIRS * (AB_STEPS * per_forward[n] + decode[n]) for n in tools.LAUNCH_COUNTERS}
        if got != want:
            raise SystemExit(f"{label} A/B {name}: launches {got}, expected {want}")
        launches[f"16r_ab_{name}"] = got
    print(f"{label} runbook --synthetic --full_width (configs/ref_inpainting.yaml, a {ckpt_gb:.2f} GB fp16 stand-in "
          f"checkpoint, deleted): stage seconds { {k: r['seconds'] for k, r in report.items()} }; convert "
          f"{conv['loaded_keys']} keys skipped={conv['skipped']} ({conv['skipped_recomputed']} schedule buffers and EMA, "
          f"{conv['skipped_other']} other) missing={conv['missing']} shape_mismatch="
          f"{conv['shape_mismatch']} unexpected={conv['unexpected']}; parity kernels vs plain at t={par['t']} "
          f"{ {k: f'{v:.3e}' for k, v in readings.items()} } (limit {runbook.PARITY_REL_L2}; the int8 UNet block by "
          f"block, worst {par['int8_unet_blocks']['block']}, end to end {par['int8_unet_blocks']['end_to_end_rel_l2']:.3e} "
          f"for information); eval DDIM-{ev['ddim_steps']} PSNR={ev['PSNR']} SSIM={ev['SSIM']} LPIPS={ev['LPIPS']}; "
          f"A/B {AB_PAIRS} pairs DDIM-{AB_STEPS}: bf16 {ab['bf16']} int8 {ab['int8']} int8+vae8 {ab['int8+vae8']} "
          f"cross_psnr_db {cross}; launches per variant {AB_PAIRS} x ({AB_STEPS} x PER_FORWARD_BF16 / _INT8 "
          f"(+ PER_DECODE_VAE8))", flush=True)
    print(f"phase 16r total seconds={time.perf_counter() - t_phase:.1f}", flush=True)
    return report


def phase_16q(launches: dict, gen) -> dict:
    """Phase 16q (the docstring): the four quality studies at full width, the
    int8 study's gate against the plain path and a wrong K1; returns the
    report of K1-K3 at the V=2 forward's sites."""
    import torch

    from leftrefill_torch import kernels, tools
    from leftrefill_torch.ops import flash_attention as fa
    from leftrefill_torch.pipeline import fill_random_
    from leftrefill_torch.tools import cuda_ms, quality

    t_phase = time.perf_counter()
    arch = quality.FULL
    g = torch.Generator("cuda").manual_seed(0)

    def summed(*parts):
        return {n: sum(k * per[n] for k, per in parts) for n in tools.LAUNCH_COUNTERS}

    def run(key, fn, want):
        tools.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        got = tools.launches()
        if got != want:
            raise SystemExit(f"phase 16q {key}: launches {got}, expected {want}")
        launches["16q_" + key] = got
        print(f"phase 16q {key} ", end="")
        quality.emit(result, "full", "cuda")
        return result

    # int8: the eps sweep (5 forwards an arm) and two DDIM-50 requests
    bundles = quality.int8_bundles(arch, quality.draw_state(arch, g), "cuda")
    x, ctx = quality.eps_inputs(arch, g)
    n = len(quality.TIMESTEPS) + 50
    run("int8", lambda: quality.int8_study("cuda", g, arch, bundles=bundles, draws={"x": x, "ctx": ctx}),
        summed((n, tools.PER_FORWARD_BF16), (n, tools.PER_FORWARD_INT8)))
    ref, arms = bundles["fp32"].unet, {"bf16": bundles["bf16"].unet, "int8": bundles["int8"].unet}
    kern = quality.eps_sweep(ref, arms, x, ctx, (QUALITY_T,))[0]
    with kernels.plain_kernels():
        plain = quality.eps_sweep(ref, arms, x, ctx, (QUALITY_T,))[0]
    tt = torch.full((x.shape[0],), QUALITY_T, dtype=torch.long, device="cuda")
    fwd_ms = {}
    with torch.inference_mode():
        for arm, unet in arms.items():
            fwd_ms[arm] = cuda_ms(lambda u=unet: u(x, tt, ctx), 3)
            with kernels.plain_kernels():
                fwd_ms[arm + "_plain"] = cuda_ms(lambda u=unet: u(x, tt, ctx), 1)
    flash = fa.flash_attention
    fa.flash_attention = lambda *a: flash(*a).flip(1)  # a wrong K1: each sequence's output rows reversed
    try:
        wrong = quality.eps_sweep(ref, arms, x, ctx, (QUALITY_T,))[0]
    finally:
        fa.flash_attention = flash
    for arm in arms:
        limit = QUALITY_FACTOR * plain[arm]["mean_rel"] + QUALITY_SLACK
        if not kern[arm]["mean_rel"] <= limit < wrong[arm]["mean_rel"]:
            raise SystemExit(f"phase 16q int8 gate {arm}: the kernels' mean eps deviation from fp32 "
                             f"{kern[arm]['mean_rel']:.4e}, limit {limit:.4e} ({QUALITY_FACTOR} x the plain path's "
                             f"{plain[arm]['mean_rel']:.4e} + {QUALITY_SLACK}), the wrong K1's {wrong[arm]['mean_rel']:.4e} "
                             "(must read above the limit)")
    print(f"phase 16q int8 gate at t={QUALITY_T}: mean eps deviation from fp32 (max) kernels / plain versions / a wrong "
          f"K1 (rows reversed): " + "; ".join(
              f"{arm} {kern[arm]['mean_rel']:.4e} ({kern[arm]['max_rel']:.4e}) / {plain[arm]['mean_rel']:.4e} "
              f"({plain[arm]['max_rel']:.4e}) / {wrong[arm]['mean_rel']:.4e}" for arm in arms)
          + f" (limit {QUALITY_FACTOR} x plain + {QUALITY_SLACK}); forward ms [2,64,128,9] kernels / plain: "
          + "; ".join(f"{arm} {fwd_ms[arm]:.2f} / {fwd_ms[arm + '_plain']:.2f}" for arm in arms), flush=True)
    del bundles, ref, arms
    torch.cuda.empty_cache()

    # mv: the V=2 eps sweep and two 2-view DDIM-50 scenes; then K1-K3 at the V=2 forward's sites (its
    # 64x128 views launch what the V=4 forward of 64x64 views does, PER_FORWARD_MV4)
    run("mv", lambda: quality.mv_study("cuda", g, arch),
        summed((n, tools.PER_FORWARD_MV4), (n, tools.PER_FORWARD_MV2_INT8)))
    torch.cuda.empty_cache()
    report = {}
    mv = quality.bundle(arch, "cuda", torch.bfloat16, view_num=2)
    fill_random_(mv, g)
    x2, ctx2 = quality.eps_inputs(arch, g, 2)
    with torch.inference_mode():
        sites = tools.unet_sites(mv.unet, x2, tt, ctx2, None, cfg_dup=False)
        check_kernels(sites, gen, report, "16q mv2 forward", BF16_NAMES)
    check_sites(report, {k: tools.PER_FORWARD_MV4[k] for k in BF16_NAMES}, "phase 16q mv2 forward")
    del mv
    torch.cuda.empty_cache()

    # solver: 547 CFG-doubled forwards (seven runs from one x_T); vae8: one int8 decode
    run("solver", lambda: quality.solver_study("cuda", g, arch),
        summed((sum(s for _, s, _ in quality.SOLVER_RUNS.values()), tools.PER_FORWARD_BF16)))
    torch.cuda.empty_cache()
    run("vae8", lambda: quality.vae8_study("cuda", g, arch), summed((1, tools.PER_DECODE_VAE8)))
    torch.cuda.empty_cache()
    print(f"phase 16q total seconds={time.perf_counter() - t_phase:.1f}", flush=True)
    return report


def main() -> int:
    if not (ROOT / "leftrefill_torch" / "csrc").is_dir():
        print("chip_smoke.py: the leftrefill_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3

    # ---- phase 1: set-up ---------------------------------------------------
    from leftrefill_torch import kernels, tools
    from leftrefill_torch.ops import quant
    from leftrefill_torch.tools import cuda_ms, rel_l2
    from leftrefill_torch.tools.library_baselines import geglu_sites

    print(tools.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"phase 1 setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built from leftrefill_torch/csrc "
          f"in {time.perf_counter() - t0:.1f} s -> {kernels.library_path().relative_to(ROOT)}; "
          f"tf32 off")
    log = (kernels.library_path().parent / "build.log").read_text()
    for kernel, smem_of in (("flash_fwd_kernel", lib.lr_flash_fwd_smem), ("conv3x3_kernel", lib.lr_conv3x3_smem),
                            ("flash_bwd_dq_kernel", lib.lr_flash_bwd_dq_smem),
                            ("flash_bwd_dkv_kernel", lib.lr_flash_bwd_dkv_smem),
                            ("geglu_up_kernel", lambda n: lib.lr_geglu_smem(0, 0)),
                            ("geglu_down_kernel", lambda n: lib.lr_geglu_smem(1, n)),
                            ("geglu_int8_up_kernel", lambda n: lib.lr_geglu_int8_smem(0, 0)),
                            ("geglu_int8_down_kernel", lambda n: lib.lr_geglu_int8_smem(1, n)),
                            ("conv3x3_int8_kernel", quant.conv3x3_int8_smem),
                            ("dense_int8_res_kernel", None), ("affine_silu_quant_kernel", lambda n: 0),
                            ("ln_quant_kernel", lambda n: "8 C (gamma, beta)"), ("gn_quant_kernel", lambda n: 0),
                            ("flash_int8_kernel", lib.lr_flash_int8_smem), ("noop_kernel", lambda n: 0)):
        for line in ptxas_report(log, kernel):
            n = re.search(r"<(\d*)", line).group(1)
            rows = re.search(r",(\d+)>", line)  # a flash forward's query rows a block, its last argument
            if kernel == "dense_int8_res_kernel":  # <rows, columns> of the tile
                smem = quant.dense_int8_res_smem(*map(int, re.search(r"<(\d+),(\d+)>", line).groups()))
            elif kernel == "flash_fwd_kernel" and n == "64":
                smem = lib.lr_flash_fwd_variant_smem(int(rows.group(1)))
            else:
                smem = smem_of(int(n or 0))
            print(f"phase 1 ptxas {line}; dynamic shared memory {smem} bytes")

    from leftrefill_torch.pipeline import build_sd2_inpaint_bundle

    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0))
    unet = model.unet
    gen = torch.Generator("cuda").manual_seed(1)
    x, tsteps, ctx = tools.unet_inputs(gen)
    report = {}
    launches = {}

    # ---- phase 2: each bf16 kernel at the UNet forward's own shapes --------
    with torch.inference_mode():
        kv = unet.cross_kv(ctx)
        sites_bf16 = tools.unet_sites(unet, x, tsteps, ctx, kv, True)
        check_kernels(sites_bf16, gen, report, "2", BF16_NAMES)
        # off the main path: head dim 128, and the key/query and channel tails
        for name, shape in OFF_PATH:
            site = tools.site_args(name, shape, gen)
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            reading, _ = compare(name, run(), plain())
            print(f"phase 2 {name} shape={shape} (off the main path) {reading} "
                  f"kernel_ms={cuda_ms(run, 5):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
        check_sites(report, {n: tools.PER_FORWARD_BF16[n] for n in BF16_NAMES}, "bf16")
        check_bit_equal("geglu", max(s for n, s in sites_bf16 if n == "geglu"), gen, "2")

        # ---- phase 2p: the timing probes (tools only) -----------------------
        report.update(check_probes(gen, launches))

        # ---- phase 3: the full-width UNet forward, kernels vs plain --------
        out_bf16, _, err, kern_ms, plain_ms = check_forward(unet, x, tsteps, ctx, kv, "bf16", kernels.NAMES)
        print(f"phase 3 unet forward [2,64,128,9] bf16 cfg_dup cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f}")

    # ---- phase 4: serving two 512x1024 bf16 requests -----------------------
    launches["bf16_ddim50"] = serve(model, "ddim", 50, tools.PER_FORWARD_BF16,
                                    "phase 4 serving 512x1024 bf16 ddim50 eta1 cfg2.5 b1")
    del model, unet, kv

    # ---- phase 2i: the unfused int8 UNet's kernels at their own shapes -----
    t0 = time.perf_counter()
    qmodel = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), quant=True)
    umodel = tools.unfused_twin(qmodel)
    torch.cuda.synchronize()
    print(f"phase 2i int8 bundle: the seed-0 fp32 weights quantized per output channel "
          f"in {time.perf_counter() - t0:.1f} s; fused and unfused UNets on the same int8 weights")
    qunet, uunet = qmodel.unet, umodel.unet
    with torch.inference_mode():
        qkv = uunet.cross_kv(ctx)
        sites_int8 = tools.unet_sites(uunet, x, tsteps, ctx, qkv, True)
        check_kernels(sites_int8, gen, report, "2i", INT8_NAMES)
        check_sites(report, {n: tools.PER_FORWARD_INT8_UNFUSED[n] for n in INT8_NAMES}, "int8")
        check_bit_equal("geglu_int8", max(s for n, s in sites_int8 if n == "geglu_int8"), gen, "2i")
        # KI2 off the main path: ragged row tiles, a K tail, a cluster split of K
        for shape in OFF_PATH_DENSE:
            site = tools.site_args("dense_int8_res", shape, gen)
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS["dense_int8_res"])
            reading, _ = compare("dense_int8_res", run(), plain())
            print(f"phase 2i dense_int8_res shape={shape} (off the main path) {reading} "
                  f"{check_dense_int8_plan(shape)} kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
        # KI3 off the main path: a 1280-wide requant chunk (the up kernel's
        # cluster of 10 blocks) over a din of 320 (a 64-byte K tail)
        shape = (128, 320, 1280, 320, 1280)
        site = tools.site_args("geglu_int8", shape, gen)
        run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS["geglu_int8"])
        reading, _ = compare("geglu_int8", run(), plain())
        print(f"phase 2i geglu_int8 shape={shape} (off the main path) {reading} {check_plan('geglu_int8', shape)} "
              f"kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
        # KI1's fp32 output arm (an fp32 int8 model), off the main path
        shape = (2, 32, 64, 640, 640)
        site = (*tools.site_args("conv3x3_int8", shape, gen), torch.float32)
        run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS["conv3x3_int8"])
        got, ref = run(), plain()
        if not (got.dtype == ref.dtype == torch.float32 and torch.equal(got, ref)):
            raise SystemExit(f"conv3x3_int8 fp32 {shape}: differs from the plain version "
                             f"(max abs {float((got - ref).abs().max()):.3e})")
        print(f"phase 2i conv3x3_int8 fp32 shape={shape} (off the main path) equal to the plain version "
              f"kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")

        # ---- phase 3i: the full-width unfused int8 forward, kernels vs plain
        # the int8 kernels routed to their plain versions, K1 on its kernel in
        # both forwards: any rounding difference (K1's ~2e-4 a call) moves
        # int8 values by a step, which the following quantized stages spread
        # to the int8 noise level; with K1 routed too the difference is shown
        out_unfused, _, err, kern_ms, plain_ms = check_forward(uunet, x, tsteps, ctx, qkv, "int8", INT8_NAMES)
        with kernels.plain_kernels():
            out_all_plain = uunet(x, tsteps, ctx, cross_kv=qkv, cfg_dup=True)
        print(f"phase 3i unet forward [2,64,128,9] int8 unfused cfg_dup cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f}; for information: "
              f"rel_l2_with_k1_plain_too={rel_l2(out_unfused, out_all_plain):.3e} "
              f"rel_l2_vs_bf16_forward={rel_l2(out_unfused, out_bf16):.3e}")
        del out_all_plain

    # ---- phase 5: serving two 512x1024 unfused int8 requests ---------------
    launches["int8_unfused_dpm15"] = serve(umodel, "dpm++2m", 15, tools.PER_FORWARD_INT8_UNFUSED,
                                           "phase 5 serving 512x1024 int8 unfused dpm++2m15 cfg2.5 b1")
    del umodel, uunet

    # ---- phase 2f: the fused prologues at the fused forward's shapes -------
    with torch.inference_mode():
        sites_fused = tools.unet_sites(qunet, x, tsteps, ctx, qkv, True)
        check_kernels(sites_fused, gen, report, "2f", PROLOGUES)
        check_sites(report, {n: tools.PER_FORWARD_INT8[n] for n in PROLOGUES}, "int8 fused")
        # K4's cooperative launch (a grid barrier) inside a CUDA graph
        check_graph_replay("affine_silu_quant", max((s for n, s in sites_fused if n == "affine_silu_quant"),
                                                    key=math.prod), gen, "2f")
        # K7 and K8 writing their bf16 output too, off the main path
        for name, shape in (("ln_quant", (16384, 320, True)), ("gn_quant", (2, 64, 128, 320, True))):
            site = tools.site_args(name, shape, gen)
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            reading, _ = compare(name, run(), plain())
            print(f"phase 2f {name} shape={shape} (off the main path) {reading} "
                  f"kernel_ms={cuda_ms(run, 20):.4f} plain_ms={cuda_ms(plain, 5):.4f}")

        # ---- phase 3f: the fused forward, K4/K7/K8 vs their plain versions --
        fwd = lambda: qunet(x, tsteps, ctx, cross_kv=qkv, cfg_dup=True)
        errs, e2e = tools.teacher_forced(qunet, fwd, PROLOGUES)
        worst = max(errs.items(), key=lambda kv_: kv_[1][2])
        st = [e for e in errs.values() if e[0] == "SpatialTransformer"]
        st_l2 = (sum((e[1] * e[3]) ** 2 for e in st) / sum(e[3] ** 2 for e in st)) ** 0.5
        exact = all(e[1] == 0 for e in errs.values())
        if worst[1][2] > BLOCK_MAX_REL or st_l2 > TRANSFORMERS_L2 or (exact and e2e > UNET_REL_L2):
            raise SystemExit(f"phase 3f: block {worst[0]} max rel {worst[1][2]:.3e} > {BLOCK_MAX_REL}, or the "
                             f"transformers' rel L2 {st_l2:.3e} > {TRANSFORMERS_L2}, or end to end {e2e:.3e}")
        out_fused = fwd()
        kern_ms = cuda_ms(fwd, 3)
        print(f"phase 3f unet forward [2,64,128,9] int8 fused cfg_dup cross_kv, teacher-forced blocks "
              f"({len(errs)}): max_block_max_rel={worst[1][2]:.3e} ({worst[0]}) transformers_rel_l2={st_l2:.3e} "
              f"blocks_equal={sum(e[1] == 0 for e in errs.values())}/{len(errs)} kernels_ms={kern_ms:.2f}; "
              f"for information: rel_l2_end_to_end={e2e:.3e} rel_l2_vs_unfused_forward={rel_l2(out_fused, out_unfused):.3e}")
        del out_fused, out_unfused, out_bf16, qkv

    # ---- phase 5f: serving two 512x1024 fused int8 requests ----------------
    # K4 computes its own scale: the eager one (K4's plain version's) must not run
    def refused(*args):
        raise SystemExit("phase 5f: quant.silu_scale ran on the main path")

    silu_scale, quant.silu_scale = quant.silu_scale, refused
    try:
        launches["int8_fused_dpm15"] = serve(qmodel, "dpm++2m", 15, tools.PER_FORWARD_INT8,
                                             "phase 5f serving 512x1024 int8 fused dpm++2m15 cfg2.5 b1")
    finally:
        quant.silu_scale = silu_scale
    del qmodel, qunet

    # ---- phase 2m: the flash kernel at the multi-view joint shapes ---------
    multiview = {}
    with torch.inference_mode():
        for views in (4, 2):
            shape = (2, 5, 4096 * views, 4096 * views, 64)
            mv_report = {}
            check_site("flash_fwd", shape, gen, 1, mv_report, f"2m V={views}")
            multiview[f"V{views}_{shape[2]}_tokens"] = {k: mv_report["flash_fwd"][k] for k in
                                                       ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}

    # ---- phase 3m: one full-width V=4 multi-view forward, kernels vs plain --
    mvmodel = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0),
                                       view_num=VIEWS)
    mvunet = mvmodel.unet
    with torch.inference_mode():
        xm, tm, cm = tools.unet_inputs(gen, rows=2 * VIEWS, hw=(64, 64))
        mkv = mvunet.cross_kv(cm)
        sites = tools.unet_sites(mvunet, xm, tm, cm, mkv, cfg_dup=False)
        per_forward = {n: sum(c for (name, _), c in sites.items() if name == n) for n in tools.LAUNCH_COUNTERS}
        joint = sum(c for (name, shape), c in sites.items() if name == "flash_fwd" and shape[3] == 4096 * VIEWS)
        if per_forward != tools.PER_FORWARD_MV4 or joint != 5:
            raise SystemExit(f"phase 3m: sites per forward {per_forward}, {joint} at {4096 * VIEWS} tokens")
        # every site of the V=4 forward, the joint attentions' and the
        # 8-row convs' and GEGLUs' shapes that the 1-reference path lacks
        mv_forward = {}
        check_kernels(sites, gen, mv_forward, "3m", BF16_NAMES)
        _, _, err, kern_ms, plain_ms = check_forward(mvunet, xm, tm, cm, mkv, "multiview", kernels.NAMES,
                                                     cfg_dup=False)
        print(f"phase 3m unet forward [{2 * VIEWS},64,64,9] bf16 multi-view V={VIEWS} cross_kv: rel_l2={err:.3e} "
              f"kernels_ms={kern_ms:.2f} plain_versions_ms={plain_ms:.2f} sites={per_forward}")
        del mkv

    # ---- phase 6: multi-view serving, V=4 ----------------------------------
    launches["multiview_v4_ddim50"] = serve_multiview(mvmodel, tools.PER_FORWARD_MV4,
                                                      f"phase 6 serving V={VIEWS} 512x512 views bf16 ddim50 eta1 cfg2.5")

    del mvmodel, mvunet

    # ---- phase 2t: the flash backward kernels at the train steps' shapes ---
    # (outside inference mode: the library time is SDPA's autograd backward)
    mv_train = {}
    for shape, n_sites in sorted(tools.TRAIN_SITES.items()):
        for name in BWD_NAMES:
            check_site(name, shape, gen, n_sites, report, "2t 1-reference")
    for shape, n_sites in sorted(tools.TRAIN_SITES_MV4.items()):
        for name in BWD_NAMES:
            check_site(name, shape, gen, n_sites, mv_train, f"2t V={VIEWS}")
    # off the main path: head dim 128, the 64-row tails, Nq != Nk
    for shape in OFF_PATH_BWD:
        site = tools.site_args("flash_bwd_dq", shape, gen)
        for name in BWD_NAMES:
            run, plain = (functools.partial(fn, *site) for fn in tools.KERNEL_FNS[name])
            reading, _ = compare_backward(name, site, run(), plain())
            print(f"phase 2t {name} shape={shape} (off the main path) {reading} "
                  f"kernel_ms={cuda_ms(run, 5):.4f} plain_ms={cuda_ms(plain, 5):.4f}")
    # determinism: no block writes another's rows, so two launches agree bit for bit
    shape = max(tools.TRAIN_SITES, key=lambda sh: sh[2])
    site = tools.site_args("flash_bwd_dq", shape, gen)
    for name in BWD_NAMES:
        first, second = (tools.KERNEL_FNS[name][0](*site) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (first, second)))):
            raise SystemExit(f"phase 2t {name} {shape}: two launches differ")
        print(f"phase 2t {name} shape={shape}: two launches bit-equal")
    del site, first, second
    # K3 at the train steps' GEGLU sites: the forward and the remat recompute
    train_geglu = {}
    with torch.inference_mode():
        for views, key in ((None, "train_1ref_b8"), (VIEWS, "train_mv4")):
            train_geglu[key] = {}
            for shape, n_sites in geglu_sites(views, True, False):
                check_site("geglu", shape, gen, n_sites, train_geglu[key], f"2t {key}")
            if train_geglu[key]["geglu"]["sites"] != tools.PER_TRAIN_STEP["geglu"]:
                raise SystemExit(f"phase 2t {key}: {train_geglu[key]['geglu']['sites']} GEGLU sites a step")
        check_bit_equal("geglu", max(s for s, _ in geglu_sites(None, True, False)), gen, "2t")

    # ---- phase 7: 1-reference prompt-tuning training at full width --------
    from leftrefill_torch.models.clip import init_prompt_table
    from leftrefill_torch.train import OptimizerConfig, compute_loss, create_train_state, make_train_step, view_options

    t0 = time.perf_counter()
    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0), remat=True)
    tok, sp, init = tools.prompt_tokenizer()
    init_prompt_table(model.cond_stage_model, tok, sp, init)
    state, tx = create_train_state(model, OptimizerConfig())  # the released optimizer: AdamW 3e-5, wd 0.01
    table = model.cond_stage_model.special_embeddings.weight
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = tools.training_batch(8)
    torch.cuda.synchronize()
    print(f"phase 7 set-up: remat bundle, prompt table {tuple(table.shape)} {table.dtype} initialised from "
          f"its init text, {sum(p.numel() for p in model.parameters() if p.requires_grad)} trainable of "
          f"{sum(p.numel() for p in model.parameters())} parameters, in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, launches["train_1ref_b8"] = train_steps(
        make_train_step(model, tx, *view_options(model)), state, batch, 3, tools.PER_TRAIN_STEP,
        tools.TRAIN_SITES, "phase 7 training")
    after = model.state_dict()
    changed = sorted(k for k in before if not torch.equal(before[k], after[k]))
    if changed != ["cond_stage_model.special_embeddings.weight"]:
        raise SystemExit(f"phase 7: parameters changed by training: {changed[:5]} (only the prompt table may)")
    per_step = {n: c // 3 for n, c in launches["train_1ref_b8"].items() if c}
    print(f"phase 7 training 1-reference b8 512x1024 remat AdamW(3e-5, wd 0.01): seconds_per_step="
          f"{[round(x, 3) for x in secs]} losses={[round(x, 5) for x in losses]} launches_per_step={per_step} "
          f"table_moved_max_abs={float((after[changed[0]].float() - before[changed[0]].float()).abs().max()):.3e} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del before, after

    # one step's prompt-table gradient at batch 2, kernels against plain versions
    small = {k: v[:2] for k, v in batch.items()}
    g2 = torch.Generator("cuda").manual_seed(11)
    t_fix = torch.randint(0, 1000, (2,), generator=g2, device="cuda")
    noise = torch.randn((2, 64, 128, 4), generator=g2, device="cuda").to(torch.bfloat16)

    def prompt_grad():
        table.grad = None
        compute_loss(model, small, t_fix, noise)[0].backward()
        torch.cuda.synchronize()
        return table.grad.clone()

    grad_k = prompt_grad()
    with kernels.plain_kernels():
        grad_p = prompt_grad()
    table.grad = None
    err = rel_l2(grad_k, grad_p)
    if not (torch.isfinite(grad_k).all() and grad_k.abs().max() > 0 and err <= PROMPT_GRAD_REL_L2):
        raise SystemExit(f"phase 7: prompt-table gradient through the kernels rel L2 {err:.3e} from the plain "
                         f"versions' (limit {PROMPT_GRAD_REL_L2}) or zero / non-finite")
    print(f"phase 7 prompt-table gradient b2 t={t_fix.tolist()}: kernels vs plain versions rel_l2={err:.3e} "
          f"(limit {PROMPT_GRAD_REL_L2}) grad_norm={float(grad_k.norm()):.4e}")
    del model, state, tx, table, grad_k, grad_p, batch, small

    # ---- phase 8: V=4 multi-view prompt-tuning training --------------------
    model = build_sd2_inpaint_bundle("cuda", torch.bfloat16, torch.Generator("cuda").manual_seed(0),
                                     view_num=VIEWS, remat=True)
    state, tx = create_train_state(model, OptimizerConfig())
    table = model.cond_stage_model.special_embeddings.weight
    start = table.detach().clone()
    reduced, view_num = view_options(model)
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, launches["train_mv4"] = train_steps(
        make_train_step(model, tx, reduced, view_num), state, tools.multiview_training_batch(VIEWS), 2,
        tools.PER_TRAIN_STEP_MV4, tools.TRAIN_SITES_MV4, "phase 8 training")
    moved = float((table.detach() - start).abs().max())
    if not moved > 0:
        raise SystemExit("phase 8: the prompt table did not move")
    per_step = {n: c // 2 for n, c in launches["train_mv4"].items() if c}
    print(f"phase 8 training V={VIEWS} 512x512 views, view-0 loss (view_reduced={reduced}), table "
          f"{tuple(table.shape)}: seconds_per_step={[round(x, 3) for x in secs]} losses={[round(x, 5) for x in losses]} "
          f"launches_per_step={per_step} table_moved_max_abs={moved:.3e} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del model, state, tx, table

    # ---- phases 2n, 3n, 9, 9s, 9l: novel-view synthesis --------------------
    nvs_forward, nvs_sep, nvs_b4 = nvs_phases(gen, launches)

    # ---- phases 10, 2tn, 10g: novel-view-synthesis training ----------------
    nvs_train = nvs_training_phases(gen, launches)

    # ---- phases 11a-11e: the serving and evaluation entry points -----------
    serving_phases(launches)

    # ---- phases 12, 12g, 12m: prompt tuning through the CLI on MegaDepth ----
    megadepth_training_phases(launches)

    # ---- phases 13d, 13s, 13a, 13m: samplers, rows, maps, multi-cond --------
    sampler_phases(launches)

    # ---- phases 14b, 14v, 14t, 14c: the parallel paths, ranks on the card ---
    view_reports = parallel_phases(launches)

    # ---- phases 15q, 15u: the int8 VAE decoder, the option UNets -----------
    # (15d ran with phase 12's tree)
    option_reports = {"int8_vae_decode": phase_15q(launches, gen), **phase_15u(launches, gen)}

    # ---- phases 16r, 16q: the runbook and the quality studies, full width --
    phase_16r(launches)
    option_reports["quality_mv2_forward"] = phase_16q(launches, gen)

    entries = []
    for name, (source, replaces) in KERNELS.items():
        rep = report[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        if name in tools.PROBES:  # tools only: launched on the probes' path, on no main path
            entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                            "launches": by_path["probes"], "launches_by_path": by_path,
                            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                            "bound_ms": rep["bound_ms"],
                            "bound_by": "operations" if 2 * rep["bound_ops_ms"] > rep["bound_ms"] else "bytes",
                            "library_ms": rep["library_ms"], "ms_where_library": rep["ms_where_library"],
                            "ms_unit": "device", "sites": rep["sites"]})
            continue
        tag = {"flash_fwd": " (K1, K11)", "flash_bwd_dq": " (K12, K14)", "flash_bwd_dkv": " (K13)"}.get(name, "")
        entry = {"name": name + tag, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": rep["max_abs_err"], "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                 "bound_ms": rep["bound_ms"],
                 "bound_by": "operations" if 2 * rep["bound_ops_ms"] > rep["bound_ms"] else "bytes",
                 "library_ms": rep["library_ms"],
                 ("sites_per_train_step" if name in BWD_NAMES else "sites_per_forward"): rep["sites"]}
        if name in mv_train:  # the V=4 train step's sites, held and timed in phase 2t
            entry["multiview_v4_train_step"] = {k: mv_train[name][k] for k in
                                                ("sites", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
            entry["max_abs_err"] = max(entry["max_abs_err"], mv_train[name]["max_abs_err"])
        if name in tools.COMPOSED:  # the yardstick: a composition of calls, not one library call
            entry["composition_ms"] = rep["composition_ms"]
        if name == "geglu":  # the train steps' sites, held and timed in phase 2t
            for key, rep_t in train_geglu.items():
                entry[key] = {k: rep_t["geglu"][k] for k in
                              ("sites", "ms", "plain_ms", "bound_ms", "composition_ms", "max_abs_err")}
                entry["max_abs_err"] = max(entry["max_abs_err"], rep_t["geglu"]["max_abs_err"])
        if name in mv_forward:  # the V=4 forward's sites, held and timed in phase 3m
            entry["multiview_v4_forward"] = {k: mv_forward[name][k] for k in
                                             ("sites", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                                              "composition_ms") if k in mv_forward[name]}
            entry["max_abs_err"] = max(entry["max_abs_err"], mv_forward[name]["max_abs_err"])
        for key, rep_n in (("nvs_forward", nvs_forward), ("nvs_use_sep_forward_added_sites", nvs_sep),
                           ("nvs_4poses_forward_added_sites", nvs_b4), ("nvs_train_step_b16", nvs_train)):
            if name in rep_n:  # the NVS forward's sites (and those use_sep adds), phase 2n
                entry[key] = {k: rep_n[name][k] for k in ("sites", "ms", "plain_ms", "bound_ms", "library_ms",
                                                          "max_abs_err", "composition_ms") if k in rep_n[name]}
                entry["max_abs_err"] = max(entry["max_abs_err"], rep_n[name]["max_abs_err"])
        for key, rep_o in option_reports.items():
            if name in rep_o:  # the sites phase 15 adds: the int8 decode's, the option UNets'
                entry[key] = {k: rep_o[name][k] for k in ("sites", "ms", "plain_ms", "bound_ms", "library_ms",
                                                          "max_abs_err", "composition_ms") if k in rep_o[name]}
                entry["max_abs_err"] = max(entry["max_abs_err"], rep_o[name]["max_abs_err"])
        if name == "flash_fwd":
            entry["multiview_joint_attention"] = multiview
            # one rank's share of the view-split V=4 forward: Nq != Nk (phase 14v)
            entry["view_rank_forward"] = {key: {k: rep_v["flash_fwd"][k] for k in
                                                ("sites", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
                                          for key, rep_v in view_reports.items()}
            entry["max_abs_err"] = max(entry["max_abs_err"], *(r["flash_fwd"]["max_abs_err"]
                                                               for r in view_reports.values()))
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
