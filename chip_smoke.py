#!/usr/bin/env python3
"""Drive the PyTorch port of RALF's sample and training paths (every fusion mode), of the
baselines' sample and training paths (the GANs' adversarial training among them), of the
feature towers, of the offline builders and image metrics, and of the dataset build's
saliency and inpainting nets, on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which must pass:

  1. device   the card's name and power limit; TF32 off for matmuls and convolutions
  2. build    nvcc builds every kernel of ralf_tpu_torch/ops/csrc (sm_90a), in parallel
  3. kernels  each kernel (K1-K11) against its plain PyTorch version at the
              paths' shapes (K1 also at ICVT's E=200, Dh=25: its image encoder,
              and its GA encoder at S=10 with a key mask), in bf16 and
              fp32 (K9 on the probe's int8 slab and its views), with its
              time beside the plain version's, one
              PyTorch library call's (for K5 and K6 an unfused sequence) and
              the least time the card could take; K8 also over the decode's
              6 distinct cache sets in turn (past the L2); then K1, K5 and K6's
              gradients through their autograd.Functions at the main shapes
              (K1 also at FIDNet's training shape with its key mask)
              against torch.autograd.grad of the reference their backward
              recomputes, in bf16 and fp32; and batched_lsa, the exact assignment
              of the GANs' matching (no Pallas counterpart: JAX's is XLA
              while-loops), equal to its plain version at B=32 and 128, n=10,
              on random and tie-heavy costs; and K10, the cross-attention with
              S != M (no Pallas counterpart: JAX's is XLA einsums), at the
              denoising decoder's shape in the benchmark's requests of 1024
              canvases and this script's of 128, with and without a key mask;
              and K11, ResNet's eval-mode BatchNorm with its residual add and
              ReLU in one pass (no Pallas counterpart: XLA fuses it), at the
              largest call of the benchmark's requests (layer1's last
              BatchNorm with its residual) and the stem's, beside the unfused
              sequence the port ran before it
  4. check    the full-width RALF in fp32 on the card against the same weights on
              the CPU (plain versions): gallery features, encode_memory, greedy
              tokens of every decode configuration (shared memory through K2, K3
              and K4; per-layer cross K/V through K7 and K8), and the per-layer
              decode against the shared one (the same function); then the same
              model with the fused encoder (every MultiHeadAttention's
              use_qkv_folded, K6, and FeedForward's use_pallas, K5): gallery
              features, encode_memory and greedy tokens, card against CPU
  5. slice    the full-width RALF in bf16 answers requests of 128 canvases:
              3 in each of the two uncond configurations (the CLI default,
              bf16 shared memory through K2; the bench configuration,
              kv_quant + self_quant through K3), one more of each
              under torch.profiler for the device's busy share; one per task
              (uncond, c, cwh, partial, refinement, relation with the retry
              decode, gt) with kv_quant + self_quant + q8_mxu (K4), and the
              uncond one once more under torch.profiler; one through
              the per-layer cross K/V (K7) and one with it in int8 (K8, and
              once more under torch.profiler); then
              the plain autoreg family answers one (K2).  Then the fused
              encoder: 3 CLI-default requests (and one profiled) with both
              flags on every module (K6 for the 12 encoder self-attentions,
              K5 for the image encoder's 6 FFNs; K1 none), one of the autoreg
              family, and one full FIDNet forward over the gallery (K6 for its
              4 + 4 post-LN layers).  Each is checked for forced tokens, legal
              tokens and finite layouts, and its launch counts are read around it
  6. stream   K9, the stream probe of scripts/probe_dma_rate.py: 9 distinct
              [2048, 680, 256] int8 slabs (one to warm up, 8 timed) and their
              int16, int32, bit-30-cleared f32 and bf16 views; GB/s per view
              and its share of 3.35 TB/s, and distinct outputs
  7. cli      (right after the kernels phase) the entry points a user runs, in this
              process: a job dir written
              by the port's build_config("ralf") at full width in bf16 (random
              weights from seed 0 as ckpt_final.npz, the synthetic splits of
              512 gallery and 64 test canvases), then cli.inference on the 64
              canvases in one batch of 64 for 2 seeds with --cond c (K1 for
              the encoders and FIDNet's gallery table, K2) and with --cond
              uncond --kv-quant --self-quant (K1, K3), exact launch counts read
              around each; 64 records a pickle with coordinates in [0, 1] and
              no violated constraint of task c; one canvas through
              single_image_batch; then cli.evaluate on the c pickles on the
              card (FIDNet, K1) and on the CPU: JAX's score keys, finite
              scores, the heuristic metrics equal within 1e-5 relative
  8. fid_train FIDNet's training at full width (d_model 256, 4 heads, 4+4 layers,
              FFN 128, fp32): one step on the card against the CPU from the same
              weights and fake/real draws (the loss and its three terms, each
              subtree's update); FIDNetTrainer.fit at batch 64 on the synthetic
              pku10 train split for 4 epochs of 8 steps: exactly 8 K1 launches a
              step (its deterministic encoder's 4 layers at S=11 and decoder's 4
              at S=10, forward and backward), finite losses, ms per step,
              samples/s, peak memory, one profiled step; then cli.fid_train
              --synthetic --debug and cli.evaluate --fidnet-dir on the cli phase's
              c pickles: the GT features cached under the tag trained, finite
              FID, precision, recall, density and coverage, K1 counted exactly
  9. zoo      MaskGIT, LayoutDM, VQDiffusion and RA-LayoutDM at their presets'
              full width (random weights from seed 0; the diffusion presets' kmeans
              vocabulary fitted on the synthetic train split): each of the four in
              fp32 on the card against the CPU on one batch (encode_memory, RA's
              with its neighbours; one denoising step's logits; deterministic
              tokens of task c and, for layoutdm, relation); then in bf16
              requests of 128 canvases, 2 uncond per preset
              and maskgit c, layoutdm c, refinement and relation, RA-LayoutDM's
              top-16 from the 256-canvas gallery: legal tokens (no MASK left; VQDiffusion
              may put any token anywhere, so with random weights its layouts hold
              no whole element and the fp32 check above carries it), the given
              tokens in place, finite layouts,
              distinct uncond outputs, exactly 6 K1 launches a MaskGIT request (the
              image encoder), 306 a LayoutDM or VQDiffusion one (6 more a denoising
              step, 50 steps) and 310 a RA-LayoutDM one (FIDNet's 4), and K10 6 a
              step of each (the decoder's cross-attention: MaskGIT 60, the
              diffusion presets 300), ms per request,
              one layoutdm request profiled; then cli.inference --cond c on a
              layoutdm job dir (64 test canvases, one batch; no violated
              constraint, K1 306, K10 300) and cli.evaluate on its pickle on the card (K1 8)
  10. baselines CGL-GAN, DS-GAN (each also with retrieval), ICVT and the
              retriever at their presets' full width (random weights from seed
              0): each in fp32 on the card against the CPU on 8 canvases (the
              GANs' logits and boxes within 1e-3, labels; ICVT's image memory and
              its tokens under one fixed z; the retriever's layouts exactly);
              then in bf16 requests of 128 canvases, 2 uncond per preset and
              cglgan c and refinement, dsgan c (its reorder), the _ra presets'
              top-16 from the 256-canvas gallery: legal layouts, exactly 6 K1
              launches a CGL-GAN request (the image encoder), 10 a CGL-GAN-RA
              one (FIDNet's 4), none a DS-GAN one, 4 a DS-GAN-RA one, 6 an ICVT
              one, every one at head width 25, none a retriever one; ms per
              request, one cglgan and one icvt request profiled; then
              cli.inference on a cglgan, an icvt and a retriever job dir (the
              last written by cli.train; 64 test canvases in one batch, 2 seeds)
              and cli.evaluate on the cglgan pickles on the card (K1 12)
  11. train   one train step of the full-width fp32 RALF (dropout 0, batch 4)
              on the card against the CPU: loss, each subtree's update, the
              frozen FIDNet, BatchNorm's statistics; Trainer.fit at the ralf
              preset's size (fp32, batch 32, dropout 0.1, the 512/64 synthetic
              splits, retrieval in the train split) for 4 steps and, resumed
              from its step checkpoint, 4 more: exactly 4 K1 launches a step
              (FIDNet), 16 a validation batch, finite losses, the resume's
              steps and meta, ms per step, samples/s, peak memory and one step
              under torch.profiler; then cli.train --debug in this process and
              cli.inference --cond c on its checkpoint (fp32; K1 16, K2 300)
  12. zoo_train  MaskGIT, LayoutDM, VQDiffusion, RA-LayoutDM and ICVT as their
              presets make them: one train step in fp32 (dropout 0, batch 4) on
              the card against the CPU with the same draws (loss, each subtree's
              update, the frozen layout_encoder of RA's FIDNet and of ICVT,
              BatchNorm's statistics); for icvt Trainer.fit at
              the preset's training size (fp32, batch 32, dropout 0.1, the 512/64
              synthetic splits) for 4 steps and 4 more resumed: exactly 0 K1
              launches a step and 12 a validation batch, finite losses, ms per step, samples/s, peak memory, one
              profiled step; then for all five cli.train --debug and
              cli.inference on its checkpoint (--cond c, icvt uncond): files,
              launches (a step 0 or 4, a validation batch 6, 12, 12, 16, 12),
              coordinates in [0, 1], no violation
  13. gan_train  CGL-GAN, DS-GAN and their RA variants as their presets make
              them: one GAN step (generator step, then discriminator step) in
              fp32 (dropout 0, adv_weight 1, batch 4) on the card against the
              CPU (both losses, each subtree's update of both nets, the frozen
              layout_encoders, BatchNorm's statistics, the assignment by the
              targets it gives); for dsgan GANTrainer.fit_gan at
              the training size (fp32, batch 32, dropout 0.1, adv_weight 1) for 4
              GAN steps (cglgan_ra's runs in bf16_train): exactly 0 K1 launches a
              generator and a discriminator step, one batched_lsa a generator step,
              finite losses, ms per GAN step and per step apart, samples/s, peak
              memory, one profiled GAN step; then for all four cli.train --debug
              (K1 20, 36, 0, 16; batched_lsa 2) and cli.inference on its
              checkpoint (K1 6, 10, 0, 4): files, coordinates in [0, 1], no
              violation
  14. bf16_train  training at model.dtype=bfloat16 (fp32 parameters, the steps
              under autocast): one full-width RALF train step (batch 4) on the card
              against the CPU's bf16 step (loss 1e-2 relative, each subtree's update
              by cosine >= 0.95, norm ratio 0.9-1.1, BatchNorm's statistics' change);
              Trainer.fit of ralf as the train phase's (batch 32, 4 steps and 4
              resumed; K1 4 a step, 16 a validation batch), its parameters,
              statistics and AdamW moments fp32, its ms per step, samples/s, peak
              memory, busy share and share of bf16 tensor-core GEMMs and
              convolutions printed beside the fp32 fit's; GANTrainer.fit_gan of
              cglgan_ra (4 GAN steps; K1 8 and 10, one batched_lsa a generator
              step) and DS-GAN refused (fp32 only, as in JAX); then cli.train
              --debug model.dtype=bfloat16 -> cli.inference for ralf and cglgan:
              exact launches, fp32 checkpoints
  15. fusion  (after the slice phase) RALF's six other fusion modes at full width
              (flag_concat_crossattn, crossattn, concat, adapter, pre_encoder,
              post_encoder; random weights from seed 0): per mode one bf16 request
              of 128 canvases in the CLI default, exactly K1 12 (18 for
              post_encoder's modality encoder; pre_encoder's image encoder at
              S=676) and K2 300, forced and legal tokens, finite layouts, ms per
              request; then in fp32 encode_memory and greedy tokens of 2 canvases
              on the card against the same weights on the CPU
  16. towers  (after the stream phase) each feature tower at full size in fp32
              (VGG16 at 224, InceptionV3 at 299, CLIP's ViT-B/16 and DreamSim at
              224, AlexNet's LPIPS taps at 224; seeded random weights, no
              checkpoint): card against CPU within 1e-4 of the largest magnitude on
              2 canvases, and ms per batch of 64 350x240 canvases, resize included
  17. builders (after the fid_train phase) cli.build_caches on the synthetic
              debug splits (64/16/16): --what retrieval --backbone dreamsim, then
              with --rerank mmr and --rerank lpips (tables' shapes, neighbours in
              the gallery and never the canvas itself, the lpips tables a reorder
              of the dreamsim ones and equal to the CPU's lpips_rerank of the same
              candidates, gallery features that tell the canvases apart), --what
              clusters and --what relationships (the pickles); s per call (toy
              size, host-bound); then cli.evaluate --image-metrics on the cli
              phase's c pickles beside the same call without it and the same call
              with --device cpu: JAX's keys, positive image_fid and R_shm equal to
              the CPU's (IMAGE_TOL), the other scores unchanged, K1 12 each on the
              card
  18. preprocess (after the builders phase) the dataset build's nets, fp32, random
              weights drawn to flax's laws from seed 0 (the saliency nets with random
              BatchNorm statistics, so that a map spans a range): ISNet at 1024^2 and
              BASNet at 256^2, batch 4, through cli.saliency's array function
              (`saliency_maps`), then big-lama through `inpaint` (its weights traced
              into a TorchScript file first) on 8 canvases of PKU's raw 750x513 with
              masks from `box_union_mask`: ms per batch, images/s, peak memory, one
              profiled batch each; one canvas card against CPU (the raw maps within
              1e-4 with their range printed, LaMa within 3e-4 at 256x256)
  19. mesh    (right after the cli phase) the multi-GPU layer (ralf_tpu_torch/parallel/)
              on the one card: the full-width RALF in fp32 (seed 0) samples a
              request of 128 canvases (task uncond, greedy, top-16 of the 256-canvas
              gallery) over 2 spawned ranks over gloo with CUDA tensors (NCCL takes
              one rank a device; `mesh_rank`), 64 rows each: the first-step
              logits within 1e-5 of world 1's and the tokens equal on every row
              whose top-two margin stays above 1e-4 (near-tie rows counted), no
              collective in the program and one all-gather a request, exactly K1 12
              and K2 300 a rank (on the kernels line); sharded_topk over a gallery
              of CGL's train split's 60,548 rows at the dreamsim width (2304) split
              over a gallery axis of 2, against the card's exact_topk and the fp64
              top-16 on the CPU (in the worker); then over NCCL at world 1
              cli.inference --mesh on against --mesh off on the cli phase's job
              (greedy and top_p: equal pickles, launches, one all-gather a request)
              and one fp32 data-parallel train step at batch 32 against the
              single-process step (`compare_step`), its collectives all-reduces
              only; ms per request and per step beside the single-process path's
  20. report  one JSON line of the kernels, the nvidia-smi line, and last
              {"ok": true, "device": {...}}

The card-against-CPU checks of phases 4, 9-15 (`reference_check`, `fusion_check`,
`zoo_check`, `baseline_check` and the train, zoo_train, gan_train and bf16_train
phases' one-step checks) run in one spawned worker process (`worker`, `Checks`), as
do the towers' CPU outputs and the builders' CPU cli.evaluate: the phases here are
host-bound on one thread and the checks mostly CPU work, so the two run side by side.
A check's output is printed, and its failures counted, at the end (`Checks.wait`);
the worker's K1 shapes join K1_LAUNCHED.

Every launch count above reads K11 as well (eval-mode BatchNorm, residual add and
ReLU in one pass): one a BatchNorm of each image encoder's ResNet forward in eval mode
with grad off (53 for ResNet50, 20 for ResNet18; `k11_forward`), so a request, a
validation batch, a GAN's discriminator step (the generator's prediction) and each
cli.inference batch take it, a train step and a GAN's generator step none; the towers
phase's InceptionV3 94 a forward, the preprocess phase's nets none (their maps are NCHW
on the card: K11_TOWER, K11_PREPROCESS); the towers and preprocess phases count them too.

Every configuration is chosen here explicitly (q8_mxu is an argument of the
package's decodes); no environment variable selects a kernel, so that each
kernel keeps a path of its own.

It exits non-zero, and prints no result line, when CUDA is absent or any
check fails.  It imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import io
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense tensor-core bf16 and int8; fp32 FMA off the tensor cores
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# (atol, rtol) kernel vs plain; K9's integer views add 1e-5 * sum|x| of the row
TOL = {"bfloat16": (1e-3, 2**-7), "float32": (1e-5, 1e-4), "int8": (0.0, 0.0),
       "int16": (0.0, 0.0), "int32": (0.0, 0.0)}
AGREE = 0.99  # least share of equal greedy tokens, card against CPU (or K7 against K2)

KERNELS = {  # name: (id, the TPU kernel it replaces, source), in the order of the ids
    "encoder_attention": ("K1", "ralf_tpu/ops/pallas/encoder_attention.py:213",
                          "ralf_tpu_torch/ops/csrc/encoder_attention.cu"),
    "decode_shared_attention": ("K2", "ralf_tpu/ops/pallas/decode_attention.py:115",
                                "ralf_tpu_torch/ops/csrc/decode_attention.cu"),
    "decode_shared_attention_q8": ("K3", "ralf_tpu/ops/pallas/decode_attention.py:198",
                                   "ralf_tpu_torch/ops/csrc/decode_attention.cu"),
    "decode_shared_attention_q8mxu": ("K4", "ralf_tpu/ops/pallas/decode_attention.py:294",
                                      "ralf_tpu_torch/ops/csrc/decode_attention.cu"),
    "fused_ffn": ("K5", "ralf_tpu/ops/pallas/encoder_ffn.py:118",
                  "ralf_tpu_torch/ops/csrc/encoder_ffn.cu"),
    "encoder_self_attention": ("K6", "ralf_tpu/ops/pallas/encoder_attention.py:283",
                               "ralf_tpu_torch/ops/csrc/encoder_attention.cu"),
    "decode_attention": ("K7", "ralf_tpu/ops/pallas/decode_attention.py:46",
                         "ralf_tpu_torch/ops/csrc/decode_attention.cu"),
    "decode_attention_q8": ("K8", "ralf_tpu/ops/pallas/decode_attention.py:382",
                            "ralf_tpu_torch/ops/csrc/decode_attention.cu"),
    "stream_sum": ("K9", "scripts/probe_dma_rate.py:46", "ralf_tpu_torch/ops/csrc/stream_sum.cu"),
    # replaces no Pallas kernel: JAX's exact assignment is XLA while-loops
    "batched_lsa": ("LSA", "ralf_tpu/ops/assignment.py:99",
                    "ralf_tpu_torch/ops/csrc/assignment.cu"),
    # replaces no Pallas kernel: JAX's cross-attention with S != M is XLA einsums
    "cross_attention": ("K10", "ralf_tpu/models/nn.py MultiHeadAttention (einsums)",
                        "ralf_tpu_torch/ops/csrc/cross_attention.cu"),
    # replaces no Pallas kernel: XLA fuses the JAX package's BatchNorm, residual add and ReLU
    "batchnorm_act": ("K11", "ralf_tpu/models/resnet.py BatchNorm (XLA)",
                      "ralf_tpu_torch/ops/csrc/batchnorm_act.cu"),
}
LIBRARY = {  # what library_ms times: one PyTorch call, or for K5 and K6 an unfused sequence
    "encoder_attention": "F.scaled_dot_product_attention",
    "decode_shared_attention": "F.scaled_dot_product_attention",
    "fused_ffn": "sequence: F.linear -> relu -> F.linear",
    "encoder_self_attention": "sequence: F.linear to qkv -> F.scaled_dot_product_attention",
    "decode_attention": "F.scaled_dot_product_attention on k_t.transpose(-1, -2)",
    "stream_sum": "torch.sum(x, dims, dtype=torch.float32)",
    "batched_lsa": "none (scipy's linear_sum_assignment runs on the host)",
    "cross_attention": "F.scaled_dot_product_attention on the heads' views",
    "batchnorm_act": "sequence: models.resnet.eval_plain (scale and shift, x * s + t, + r, relu)",
}
# the main path's case of each kernel; else bfloat16
MAIN_DTYPE = {"stream_sum": "int8", "batched_lsa": "int32"}
TASKS = ("uncond", "c", "cwh", "partial", "refinement", "relation", "gt")
N_REQUESTS, BATCH, GALLERY, RETRIES = 3, 128, 256, 8
CLI_BATCH, CLI_SEEDS = 64, 2  # the cli phase: the non-debug synthetic test split, one batch
CLI_CONFIG = ["model.dtype=bfloat16", "synthetic_data=true"]  # the ralf preset's full width
SCORE_KEYS = ["validity", "alignment-LayoutGAN++", "overlap-LayoutGAN++", "overlay",
              "underlay_effectiveness_loose", "underlay_effectiveness_strict", "occlusion",
              "unreadability", "utilization", "precision", "recall", "density", "coverage",
              "fid"]  # scores_all.json of the JAX package's cli.evaluate, in its order
HEURISTIC_KEYS = SCORE_KEYS[:9]
NAN_ALLOWED = {"overlay", "underlay_effectiveness_loose",  # no sample with two non-underlays,
               "underlay_effectiveness_strict"}           # or with an underlay: JAX's NaN
STREAM_SHAPE, STREAM_SLABS = (2048, 680, 256), 9  # scripts/probe_dma_rate.py main()
# the train phase: the ralf preset's batch; train steps per fit call (4, then 4 more resumed)
TRAIN_BATCH, TRAIN_STEPS = 32, 4
# K1 in the train phase's eval steps (fp32) and the bf16_train phase's (bf16): the
# image encoder (S=330) and the constraint encoder of tasks uncond (Lc=4) and c (Lc=23)
# at batch 32; CGL-GAN-RA's image encoders in its GAN steps take the first
TRAIN_K1_SHAPES = ((32, 330, 8, False), (32, 4, 8, True), (32, 23, 8, True))
TRAIN_CLI_BATCH = 8  # cli.train --debug: 64/16 canvases, 2 steps and 2 val batches of 8
# the zoo phase's fp32 card-vs-CPU check: each preset, the tasks whose deterministic
# tokens it compares
ZOO_CHECK = {"maskgit": ("c",), "layoutdm": ("c", "relation"), "vqdiffusion": ("c",),
             "layoutdm_ra": ("c",)}
# the zoo phase: per preset, ZOO_REQUESTS uncond requests of ZOO_BATCH canvases, then one
# request per task listed, over the GALLERY-canvas gallery (RA-LayoutDM's retrieval)
ZOO_SERVE = {"maskgit": ("c",), "layoutdm": ("c", "refinement", "relation"),
             "vqdiffusion": (), "layoutdm_ra": ()}
ZOO_REQUESTS, ZOO_BATCH = 2, 128
# the baselines phase: per preset, BASELINE_REQUESTS uncond requests of BASELINE_BATCH
# canvases, then one request per task listed (the generator's task, set for it), over
# the GALLERY-canvas gallery; the fp32 card-vs-CPU check on BASELINE_CHECK canvases
BASELINE_SERVE = {"cglgan": ("c", "refinement"), "cglgan_ra": (), "dsgan": ("c",),
                  "dsgan_ra": (), "icvt": (), "retriever": ()}
BASELINE_REQUESTS, BASELINE_BATCH, BASELINE_CHECK = 2, 128, 8
BASELINE_CLI = ("cglgan", "icvt", "retriever")  # cli.inference job dirs; cli.evaluate on the first
# K1 at ICVT's image encoder: E=200, H=8, Dh=25 (padded to 32) at a request, the cli's
# batch and the fp32 check's
K1_PADDED_SHAPES = ((BASELINE_BATCH, 330, 8, 200), (CLI_BATCH, 330, 8, 200),
                    (BASELINE_CHECK, 330, 8, 200))
# and at ICVT's GA encoder in a validation batch of the zoo_train phase: S=10, with the
# layout's key mask
K1_PADDED_MASKED_SHAPES = ((TRAIN_BATCH, 10, 8, 200),)
# the zoo_train phase, per preset: exact K1 launches of a train step (RA-LayoutDM's FIDNet,
# 4 layers in eval mode; every other encoder takes the einsum path in train mode), of a
# validation batch (the image encoder's 6 self-attentions, the denoising decoder's 6,
# RA-LayoutDM's FIDNet 4, ICVT's GA encoder 6), and of cli.inference on one batch (the zoo
# and baselines phases' counts: 50 denoising steps of 6)
ZOO_TRAIN = {"maskgit": (0, 6, 6), "layoutdm": (0, 12, 306), "vqdiffusion": (0, 12, 306),
             "layoutdm_ra": (4, 16, 310), "icvt": (0, 12, 6)}
# the same phase's exact K10 launches of a validation batch (the decoder's 6
# cross-attentions over the memory; ICVT's attention pooling of its GA encoder) and of
# cli.inference on one batch (`k10_request`'s); a train step takes none (train mode)
ZOO_TRAIN_K10 = {"maskgit": (6, 60), "layoutdm": (6, 300), "vqdiffusion": (6, 300),
                 "layoutdm_ra": (6, 300), "icvt": (1, 0)}
ZOO_STEP_BATCH = 4  # the one-step check's canvases
# the presets whose Trainer.fit runs at the training size: ICVT (the clip over its frozen
# embedding's gradient, the GA encoder's K1). The other four's fits took 78 s and more of
# a 723 s run on one H100, whose budget is about 600-650 s; their steps share the same
# trainer and backbone, and RA-LayoutDM's frozen FIDNet takes K1 in every step as RALF's
# does in the train and bf16_train phases' fits (RA-LayoutDM's fit went for the time of
# the fid_train and bf16_train phases)
ZOO_TRAIN_FIT = ("icvt",)
# the gan_train phase, per preset: exact K1 launches of a generator step (the
# discriminator's 4 encoder layers in eval mode; RA's FIDNet 4 more), of a discriminator
# step (the generator's 6 encoder layers in eval mode, DS-GAN's none; RA's FIDNet 4), and
# of cli.inference on one batch (the baselines phase's counts); one batched_lsa launch a
# generator step
GAN_TRAIN = {"cglgan": (4, 6, 6), "cglgan_ra": (8, 10, 10), "dsgan": (0, 0, 0),
             "dsgan_ra": (4, 4, 4)}
# exact K10 launches of a discriminator step and of cli.inference on one batch: CGL-GAN's
# generator decoder (6 layers) in eval mode under no_grad; a generator step takes none
# (the discriminator's decoder runs with grad on: the einsum path)
GAN_TRAIN_K10 = {"cglgan": 6, "cglgan_ra": 6, "dsgan": 0, "dsgan_ra": 0}
RALF_K10_EVAL = 6  # a RALF validation batch: the teacher-forced decoder's 6 cross-attentions
# K11 launches of one forward in eval mode with grad off on the card, one a BatchNorm that
# K11 takes: a ResNet trunk by its blocks a stage (ResNet50: the stem, 16 blocks x 3 and 4
# downsamples; ResNet18: 1 + 8 x 2 + 3), the image encoder of every generator (`k11_forward`);
# a tower's (InceptionV3's 94 BasicConvs; the other towers hold no BatchNorm); the dataset
# build's nets none: their maps reach every BatchNorm NCHW-contiguous on the card (ISNet and
# BASNet from their inputs on, LaMa from its reflect padding on), so they take the plain
# path (`bn.eval.plain`). A train step takes none (train mode); a GAN's generator step none
# (the discriminator runs in eval mode with grad on), its discriminator step the generator's
# prediction in eval mode
K11_TRUNK = {(3, 4, 6, 3): 53, (2, 2, 2, 2): 20}
K11_TOWER = {"inception": 94}
K11_PREPROCESS = {"isnet": 0, "basnet": 0, "lama": 0}
K11_R50 = K11_TRUNK[(3, 4, 6, 3)]  # every preset's image encoder (GeneratorConfig.backbone)
GAN_STEP_BATCH = 4  # the one-step check's canvases
# the presets whose fit_gan runs at the training size in fp32: DS-GAN (its discriminator,
# the LSTM); CGL-GAN-RA's (its discriminator, retrieval) runs in the bf16_train phase
GAN_TRAIN_FIT = ("dsgan",)
# the fid_train phase: FIDNet's training batch (the CLI's default), the fit's epochs over
# the 512-canvas synthetic train split (8 steps each), and K1 a step: 4 encoder layers at
# S = 11 (CLS and 10 elements), 4 decoder layers at S = 10, each with its key mask
FID_BATCH, FID_EPOCHS, FID_K1_STEP = 64, 4, 8
# K1 in fp32 at FIDNet's decoder in a step (its encoder's (64, 11) is among the shapes of
# both dtypes); FIDNet trains in fp32 only
FID_K1_SHAPES = ((FID_BATCH, 10, 4, True),)
# (dtype, B, S, E, H, masked) of every K1 case held against the plain version, and of
# every K1 launch on the paths after the kernels phase (`record_k1_shapes`): `main` holds
# each launched one the kernels phase did not at the end
K1_COMPARED: set = set()
K1_LAUNCHED: set = set()
FIT_FIGURES: dict = {}  # the ralf fit's figures by dtype: the train and bf16_train phases'
# batched_lsa in the kernels phase: (B, n) of a generator step at the training batch and
# at a request's batch, the max_seq_length of the presets
LSA_SHAPES = ((TRAIN_BATCH, 10), (BASELINE_BATCH, 10))
# the fp32 operations of a Dijkstra step on one column: cur's 2 subtractions, the compare
# with minv, the masked min, and the potentials' and minv's updates
LSA_OPS_PER_COLUMN = 6
# the fusion phase: RALF's six fusion ablations (the final architecture is the slice's);
# per mode the exact K1 launches of a CLI-default request of 128 canvases (the image
# encoder's 6 layers, at S = 2M+K = 676 in pre_encoder, and the constraint encoder's 6;
# post_encoder's modality encoder 6 more at S = M+K = 346) and K2's 300 (6 layers x 50
# steps over the shared bf16 memory of 2M+K+Lc, 2M+Lc or M+K+Lc tokens)
FUSION = {"flag_concat_crossattn": 12, "crossattn": 12, "concat": 12, "adapter": 12,
          "pre_encoder": 12, "post_encoder": 18}
FUSION_CHECK = 2  # canvases of the fp32 card-vs-CPU check
# the towers phase: each feature tower's kind (its input size in models/towers.py) and
# the canvases of its card-vs-CPU check and of its timed batch; limit: JAX's tower tests'
TOWERS = ("vgg", "inception", "clip", "dreamsim", "lpips_alex")
TOWER_CHECK, TOWER_BATCH, TOWER_TOL = 2, 64, 1e-4
# the builders phase: cli.build_caches on the synthetic debug splits (64/16/16 canvases),
# top-16 tables; the LPIPS rerank of each split's top-4 (every candidate canvas is made
# on the host again: 16 ms each)
BUILD_TOP_K, LPIPS_TOP_K = 16, 4
# the preprocess phase: each saliency net at its CLI's size and batch, LaMa on PKU's raw
# canvases (H x W) in inpaint's default batch; the card-vs-CPU limits: the towers' 1e-4
# on the raw maps, JAX's LaMa test's 3e-4 (tests/test_lama.py); a map's least range, so
# that the comparison is not one of constants
SALIENCY_BATCH, SALIENCY_TOL, SALIENCY_RANGE = 4, 1e-4, 0.05
LAMA_HW, LAMA_BATCH, LAMA_CHECK_HW, LAMA_TOL = (750, 513), 8, (256, 256), 3e-4
PREPROCESS_TIMED = 5  # calls timed after a warm-up (median)
IMAGE_KEYS = ["image_precision", "image_recall", "image_density", "image_coverage",
              "image_fid", "R_shm"]  # cli.evaluate --image-metrics, after SCORE_KEYS
# card against CPU, relative: the towers agree within about 1e-6 of their largest
# feature (the towers phase); FID's matrix square root may amplify that, R_shm is a
# mean of distances; prdc counts neighbours and is exact unless two distances tie
IMAGE_TOL = {"image_fid": 1e-3, "R_shm": 1e-4}
# the mesh phase: a request of MESH_BATCH canvases over MESH_WORLD ranks on the one card
# (gloo), fp32, against world 1; the gallery-sharded top-k over CGL's train split
# (60,548 canvases) at the dreamsim backbone's width (3 x 768), from a seeded draw
MESH_BATCH, MESH_WORLD = 128, 2
MESH_GALLERY, MESH_WIDTH, MESH_TOP_K, MESH_SEED = 60548, 3 * 768, 16, 7
MESH_LOGITS_TOL = 1e-5  # first-step logits, world 2 against world 1 (fp32)
MESH_MARGIN = 1e-4  # a row whose top-two logit margin at some step is below this may flip
MESH_TIMED = 3  # requests and train steps timed each way


class Failures(list):
    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.append(what)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times, ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters():
    """The launch counter of every kernel wrapper, by kernel id."""
    from ralf_tpu_torch.ops import assignment as asg
    from ralf_tpu_torch.ops import batchnorm_act as bna
    from ralf_tpu_torch.ops import cross_attention as xa
    from ralf_tpu_torch.ops import decode_attention as da
    from ralf_tpu_torch.ops import encoder_attention as ea
    from ralf_tpu_torch.ops import encoder_ffn as ef
    from ralf_tpu_torch.ops import stream_sum as ss

    return {kid: next(getattr(m, n) for m in (ea, ef, da, ss, asg, xa, bna) if hasattr(m, n))
            for n, (kid, _, _) in KERNELS.items()}


def k11_forward(gen) -> int:
    """K11 launches of one eval-mode forward of the generator's image
    encoder with grad off on the card: K11_TRUNK of each ResNet trunk its
    model holds (the generator's alone: a GAN's discriminator is apart);
    none for the retriever."""
    from ralf_tpu_torch.models.resnet import ResNetTrunk

    core = getattr(gen, "core", None)
    if core is None:
        return 0
    return sum(K11_TRUNK[tuple(m.depths)] for m in core.modules() if isinstance(m, ResNetTrunk))


class LaunchCounter:
    """Runs a call with every kernel's launch counter at 0 just before it and
    returns (its result, its launches by kernel id) read just after;
    `totals` sums the launches over the counted calls."""

    def __init__(self) -> None:
        self.count = counters()
        self.totals = dict.fromkeys(self.count, 0)

    def __call__(self, run):
        for c in self.count.values():
            c.launches = 0
        out = run()
        n = {k: c.launches for k, c in self.count.items()}
        for k, v in n.items():
            self.totals[k] += v
        return out, n


def record_k1_shapes() -> None:
    """From now on, add the (dtype, B, S, E, H, masked) of every K1 launch to
    K1_LAUNCHED; the launch itself and its count are unchanged."""
    from ralf_tpu_torch.ops import encoder_attention as ea

    launch = ea._launch_encoder_attention

    def recorded(q, k, v, nhead, key_bias):
        K1_LAUNCHED.add((str(q.dtype).split(".")[1], *q.shape, nhead, key_bias is not None))
        return launch(q, k, v, nhead, key_bias)

    ea._launch_encoder_attention = recorded


def set_fused_encoder(module, on: bool) -> None:
    """The fused encoder: K6 for every self-attention, K5 for every FFN with
    S >= 16 (the JAX modules' use_qkv_folded and use_pallas fields)."""
    from ralf_tpu_torch.models.nn import FeedForward, MultiHeadAttention

    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.use_qkv_folded = on
        elif isinstance(m, FeedForward):
            m.use_pallas = on


def k1_one_flip(torch, q, k, v, nhead: int, bias):
    """K1 in bf16 rounds each normalised p to bf16, as its plain version does,
    from fp32 scores summed in another order (and 1/l multiplied where the
    plain version divides), so a p near a bf16 midpoint may round the other
    way in one of the two.  The reorder bound of p_j, relative, is
    4 max_j r_j + (S + 8) 2^-24 with r_j = Dh 2^-24 sum_i |q_i k_ji| (the
    scores' fp32 sums; the row max and the sum l each add their error once
    more; expf, 1/l and the sum's order the rest).  Returns explain(out,
    outside): for each element outside the tolerance, whether out comes
    within it of the output of the exact p (fp64) rounded to bf16 with at
    most one p_j, lying within its bound of a midpoint, rounded the other
    way; and the largest share of its bound that an explained element used."""
    B, S, E = q.shape
    Dh = E // nhead
    atol, rtol = TOL["bfloat16"]
    u = 2.0**-24

    def explain(out, outside):
        b, s, e = outside.nonzero(as_tuple=True)
        if not 0 < b.numel() <= 4096:  # none, or too many to be roundings
            return torch.zeros(b.numel(), dtype=torch.bool, device=q.device), 0.0
        cols = (e // Dh * Dh)[:, None] + torch.arange(Dh, device=q.device)  # [n, Dh]
        qh = q[b, s].gather(1, cols).double()                                # [n, Dh]
        kh = k[b].gather(2, cols[:, None, :].expand(-1, S, -1)).double()     # [n, S, Dh]
        vcol = v[b, :, e].double()                                           # [n, S]
        w = torch.ones(b.numel(), S, device=q.device) if bias is None else torch.exp(bias[b])
        w = w.double()
        sc = torch.einsum("nd,nsd->ns", qh, kh)
        kept_any = w.amax(-1, keepdim=True) > 0
        sc = torch.where(kept_any, sc, 0.0)
        m = torch.where(kept_any, torch.where(w > 0, sc, -torch.inf).amax(-1, keepdim=True), 0.0)
        p = torch.exp(torch.clamp(sc - m, max=0.0)) * torch.where(kept_any, w, 1.0)
        p = p / p.sum(-1, keepdim=True)                                      # exact p, [n, S]
        r = Dh * u * torch.einsum("nd,nsd->ns", qh.abs(), kh.abs())
        r = torch.where(w > 0, r, 0.0).amax(-1, keepdim=True)
        rel = 4 * r + (S + 8) * u
        pb16 = p.to(torch.bfloat16)
        pb = pb16.double()
        step = torch.sign(p - pb).to(torch.int16)  # toward p: the nearer other neighbour
        other = (pb16.view(torch.int16) + step).view(torch.bfloat16).double()
        share = (p - (pb + other) / 2).abs() / (rel * p).clamp_min(1e-300)
        cand = (step != 0) & (p > 0) & (share <= 1)
        base = (pb * vcol).sum(-1, keepdim=True)
        options = torch.cat([base, base + (other - pb) * vcol], -1).to(torch.bfloat16).double()
        used = torch.cat([torch.zeros_like(base), share], -1)
        allowed = torch.cat([torch.ones_like(base, dtype=torch.bool), cand], -1)
        got = out[b, s, e].double()[:, None]
        near = allowed & ((got - options).abs() <= atol + rtol * options.abs())
        ok = near.any(-1)
        needed = torch.where(near, used, torch.inf).amin(-1)
        return ok, float(torch.where(ok, needed, 0.0).max())

    return explain


def plain_gradients(torch, name: str, ins, gout, nhead: int = 0, key_bias=None):
    """The gradients of K1's, K5's or K6's plain version (`name` as in
    KERNELS) at `ins` for the output gradient `gout`, by torch.autograd.grad,
    and for each the allowance of a gradient that computes the same
    function in another way: atol + rtol A + F, with (atol, rtol) the
    forward's tolerance.  A >= |gradient| is the backward run on absolute
    values (every product |a||b|, softmax's p (dp - sum p dp) as
    p (|dp| + sum p |dp|)), so rtol A is the forward's rtol where the terms
    of a gradient do not cancel and grows only where they do: the sums over
    every row of a weight's gradient, and K5's plain b1 and W2 gradients,
    which add the fused tail's b1 W2^T back (a difference of sums that each
    exceed the result).  F is K5's only: a hidden unit whose h lies within
    rounding reach of -b1 (2^(1-p) |h| for the dtype's p-bit rounding of h,
    plus E 2^-23 sum|x||w1| for the fp32 sums' order) may be on in the plain
    version, which compares fp32 h with -b1, and off in one that rounds
    h + b1, so its terms are allowed whole."""
    f32 = [t.detach().float() for t in ins]
    g = gout.float()
    dt = ins[0].dtype
    atol, rtol = TOL[str(dt).split(".")[1]]
    from ralf_tpu_torch.ops import encoder_attention as ea
    from ralf_tpu_torch.ops import encoder_ffn as ef

    def abs_attention(q, k, v):
        B, S, E = q.shape
        qh, kh, vh, gh = (t.reshape(B, S, nhead, E // nhead) for t in (q, k, v, g))
        sc = torch.einsum("bshd,bmhd->bhsm", qh, kh)
        if key_bias is not None:
            kb = key_bias.float()
            sc = sc + (kb[:, :, None, :] if kb.dim() == 3 else kb[:, None, None, :])
        p = torch.softmax(sc, dim=-1)
        adp = torch.einsum("bshd,bmhd->bhsm", gh.abs(), vh.abs())
        adl = p * (adp + (p * adp).sum(-1, keepdim=True))
        out = (torch.einsum("bhsm,bmhd->bshd", adl, kh.abs()),
               torch.einsum("bhsm,bshd->bmhd", adl, qh.abs()),
               torch.einsum("bhsm,bshd->bmhd", p, gh.abs()))
        return [t.reshape(B, S, E) for t in out]

    flip = None
    if name == "encoder_attention":
        plain = lambda q, k, v: ea.encoder_attention_plain(q, k, v, nhead, key_bias)  # noqa: E731
        scale = abs_attention(*f32)
    elif name == "encoder_self_attention":
        plain = lambda x, w: ea.encoder_self_attention_plain(x, w, nhead, key_bias)  # noqa: E731
        x, w = f32
        E = x.shape[-1]
        qkv = x @ w.t()
        aqkv = torch.cat(abs_attention(qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:]), -1)
        scale = [aqkv @ w.abs(), torch.einsum("bso,bsi->oi", aqkv, x.abs())]
    else:
        plain = ef.fused_ffn_plain
        x, w1, b1, w2, _ = f32
        E = x.shape[-1]
        h = x @ w1.t()
        on = h > -b1
        bits = {torch.float32: 24, torch.bfloat16: 8}[dt]
        reach = 2.0**(1 - bits) * h.abs() + E * 2.0**-23 * (x.abs() @ w1.abs().t())
        near = ((h + b1).abs() <= reach).float()
        adg = g.abs() @ w2.abs()
        adh = adg * on
        rows = lambda a, b: torch.einsum("bsi,bsj->ij", a, b)  # noqa: E731
        scale = [adh @ w1.abs(), rows(adh, x.abs()), (adg * (2 - on.float())).sum((0, 1)),
                 rows(g.abs(), torch.maximum(h, -b1).abs() + b1.abs()), g.abs().sum((0, 1))]
        fn = adg * near
        flip = [fn @ w1.abs(), rows(fn, x.abs()), fn.sum((0, 1)), None, None]
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(plain(*leaves), leaves, gout)
    allow = [atol + rtol * a + (0.0 if flip is None or flip[i] is None else flip[i])
             for i, a in enumerate(scale)]
    return want, allow


def k1_case(torch, g, dev, dtype, B: int, S: int, H: int, masked: bool, E: int) -> tuple:
    """K1's case of `kernel_cases` at one (dtype, shape), on inputs drawn from
    `g`, added to K1_COMPARED."""
    import torch.nn.functional as F

    from ralf_tpu_torch.ops import encoder_attention as ea

    dn, isz, Dh = str(dtype).split(".")[1], torch.tensor([], dtype=dtype).element_size(), E // H
    K1_COMPARED.add((dn, B, S, E, H, masked))
    q, k, v = (torch.randn(B, S, E, generator=g, device=dev) for _ in range(3))
    q = (q * Dh**-0.5).to(dtype)
    k, v = k.to(dtype), v.to(dtype)
    bias = None
    if masked:  # random key-padding masks; every 3rd row fully masked
        keep = torch.rand(B, S, generator=g, device=dev) > 0.3
        keep[::3] = False
        bias = torch.where(keep, 0.0, -1e9).float()
    q4, k4, v4 = (t.view(B, S, H, Dh).transpose(1, 2) for t in (q, k, v))
    m4 = None if bias is None else bias[:, None, None, :].to(dtype)
    return (
        "encoder_attention", f"B={B} S={S} E={E} H={H} Dh={Dh} mask={masked}", dn,
        lambda: ea.encoder_attention(q, k, v, H, bias),
        lambda: ea.encoder_attention_plain(q, k, v, H, bias),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=1.0),
        4 * B * S * E * isz + (4 * B * S if masked else 0), 4 * B * S * S * E, dn,
        k1_one_flip(torch, q, k, v, H, bias) if dtype == torch.bfloat16 else 0.0,
    )


def kernel_cases(torch, dev):
    """(kernel name, case label, dtype, kernel call, plain call, library call or
    None, bytes, ops, op type of the peak, extra tolerance or, for K1 in bf16,
    the test that explains each element outside the tolerance)."""
    import torch.nn.functional as F

    from ralf_tpu_torch.models import resnet
    from ralf_tpu_torch.ops import assignment as asg
    from ralf_tpu_torch.ops import batchnorm_act as bna
    from ralf_tpu_torch.ops import cross_attention as xa
    from ralf_tpu_torch.ops import decode_attention as da
    from ralf_tpu_torch.ops import encoder_attention as ea
    from ralf_tpu_torch.ops import encoder_ffn as ef
    from ralf_tpu_torch.ops import stream_sum as ss

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        # K1: image encoder, constraint encoder (task uncond; relation's S=89),
        # FIDNet (Dh=64), and the largest S the wrapper takes (key tiles streamed);
        # then the cli phase's: a batch of 64 (constraint S=23 for task c, S=4
        # uncond), the single canvas, FIDNet over its 512-canvas gallery and a batch
        # (FIDNet at the train step's B*K = 512 is among them); then the zoo's:
        # the diffusion decoders' self-attention (S = L = 50, no mask) at a request
        # of 128 and the cli's batch of 64, RA-LayoutDM's FIDNet over B*K = 2048;
        # the fusion phase's pre_encoder (S = 2M+K = 676) and post_encoder modality
        # encoder (S = M+K = 346) at a request of 128; then the train and bf16_train phases' encoders at batch 32 (constraint
        # lengths of uncond and c; CGL-GAN-RA's image encoders); in fp32 also FIDNet's
        # decoder in a fid_train step (its encoder's (64, 11) is the cli's batch
        # above); last ICVT's image encoder, E=200 and Dh=25, padded to 32 in the
        # kernel, and its GA encoder (S=10, key mask)
        k1_shapes = ((128, 330, 8, False), (1, 330, 8, False), (128, 4, 8, True),
                     (128, 89, 8, True), (256, 11, 4, True), (1, 11, 4, True),
                     (16, 1024, 8, False), (64, 330, 8, False), (64, 23, 8, True),
                     (64, 4, 8, True), (1, 4, 8, True), (512, 11, 4, True), (64, 11, 4, True),
                     (128, 50, 8, False), (64, 50, 8, False), (2048, 11, 4, True),
                     (128, 676, 8, False), (128, 346, 8, False))
        k1_shapes = tuple(shape + (256,) for shape in k1_shapes + TRAIN_K1_SHAPES + (
            FID_K1_SHAPES if dtype == torch.float32 else ()))
        k1_shapes += tuple((B, S, H, False, E) for B, S, H, E in K1_PADDED_SHAPES)
        k1_shapes += tuple((B, S, H, True, E) for B, S, H, E in K1_PADDED_MASKED_SHAPES)
        cases += [k1_case(torch, g, dev, dtype, *shape) for shape in k1_shapes]
        # K2, K3, K4 also at the wrapper's largest M (K2: slices streamed; K3,
        # K4: slices of 512 tokens) and K3, K4 at a small M (CTAs with no token);
        # K2, K3 also at the cli phase's batch of 64 (the mesh phase's rows a rank of
        # a request of 128 over 2; uncond and c's memories) and its single canvas, and
        # in fp32 at the train phase's cli.inference batch (16 canvases, task c)
        k2_shapes = ((128, 680), (128, 677), (128, 4096), (128, 5), (64, 680), (64, 699),
                     (1, 680))
        for B, M in k2_shapes + (((16, 699),) if dtype == torch.float32 else ()):
            H, E = 8, 256
            qt = (torch.randn(B, H, E, generator=g, device=dev) / 16).to(dtype)
            memf = torch.randn(B, M, E, generator=g, device=dev)
            mem = memf.to(dtype)
            if M != 5:
                cases.append((
                    "decode_shared_attention", f"B={B} M={M}", dn,
                    lambda qt=qt, mem=mem: da.decode_shared_attention(qt, mem),
                    lambda qt=qt, mem=mem: da.decode_shared_attention_plain(qt, mem),
                    lambda qt=qt, mem=mem: F.scaled_dot_product_attention(
                        qt[:, None], mem[:, None], mem[:, None], scale=1.0),
                    B * M * E * isz + 2 * B * H * E * isz, 4 * B * H * M * E, dn, 0.0,
                ))
            mi, ms = da.quantize_shared_memory(memf)
            cases.append((
                "decode_shared_attention_q8", f"B={B} M={M}", dn,
                lambda qt=qt, mi=mi, ms=ms: da.decode_shared_attention_q8(qt, mi, ms),
                lambda qt=qt, mi=mi, ms=ms: da.decode_shared_attention_q8_plain(qt, mi, ms),
                None, B * M * E + 4 * B * M + 2 * B * H * E * isz, 4 * B * H * M * E, dn, 0.0,
            ))
            if B != 128:
                continue
            # K4: int8 contractions; one flipped quantised probability moves an
            # output by at most its row's scale ps
            cases.append((
                "decode_shared_attention_q8mxu", f"B={B} M={M}", dn,
                lambda qt=qt, mi=mi, ms=ms: da.decode_shared_attention_q8mxu(qt, mi, ms),
                lambda qt=qt, mi=mi, ms=ms: da.decode_shared_attention_q8mxu_plain(qt, mi, ms),
                None, B * M * E + 4 * B * M + 2 * B * H * E * isz, 4 * B * H * M * E, "int8",
                da.q8mxu_probs(qt, mi, ms)[1],
            ))
            if M in (4096, 5):
                continue
            Dh = E // H
            q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
            k_t, v_t = (torch.randn(B, H, Dh, M, generator=g, device=dev).to(dtype)
                        for _ in range(2))
            cases.append((
                "decode_attention", f"B={B} H={H} Dh={Dh} M={M}", dn,
                lambda q=q, k_t=k_t, v_t=v_t: da.decode_attention(q, k_t, v_t),
                lambda q=q, k_t=k_t, v_t=v_t: da.decode_attention_plain(q, k_t, v_t),
                lambda q=q, k_t=k_t, v_t=v_t: F.scaled_dot_product_attention(
                    q[:, :, None], k_t.transpose(-1, -2), v_t.transpose(-1, -2)),
                2 * B * H * Dh * M * isz + 2 * B * H * Dh * isz, 4 * B * H * Dh * M, dn, 0.0,
            ))
            cached = da.quantize_kv(k_t, v_t)
            k8_bytes = 2 * B * H * Dh * M + 8 * B * H + B * H * Dh * 2 * isz
            cases.append((  # the kernel's arithmetic is fp32 on an fp32 query
                "decode_attention_q8", f"B={B} H={H} Dh={Dh} M={M}", dn,
                lambda q=q, c=cached: da.decode_attention_q8(q, *c),
                lambda q=q, c=cached: da.decode_attention_q8_plain(q, *c),
                None, k8_bytes, 4 * B * H * Dh * M, "float32", 0.0,
            ))
            if M == 680:
                # the decode's 6 layers: 6 distinct cache sets in turn (268 MB, past
                # the 50 MB L2 that one set of 44.6 MB fits in); the plain
                # version takes the set of the kernel's last call
                sets = [cached] + [da.quantize_kv(*(torch.randn(B, H, Dh, M, generator=g,
                                                                device=dev) for _ in range(2)))
                                   for _ in range(5)]
                turn = {"i": 0, "last": cached}

                def rotated(q=q, sets=sets, turn=turn):
                    turn["last"] = sets[turn["i"] % len(sets)]
                    turn["i"] += 1
                    return da.decode_attention_q8(q, *turn["last"])

                cases.append((
                    "decode_attention_q8", f"B={B} H={H} Dh={Dh} M={M} 6 sets in turn", dn,
                    rotated, lambda q=q, turn=turn: da.decode_attention_q8_plain(q, *turn["last"]),
                    None, k8_bytes, 4 * B * H * Dh * M, "float32", 0.0,
                ))
        # K5 at the image encoder's FFN, then the constraint encoder's longest (relation)
        for B, S in ((128, 330), (128, 89)):
            E, Fh = 256, 1024
            x = torch.randn(B, S, E, generator=g, device=dev).to(dtype)
            w1 = (torch.randn(Fh, E, generator=g, device=dev) * E**-0.5).to(dtype)
            w2 = (torch.randn(E, Fh, generator=g, device=dev) * Fh**-0.5).to(dtype)
            b1, b2 = (torch.randn(n, generator=g, device=dev).to(dtype) for n in (Fh, E))
            # the output rounds twice, T(T(o) + T(tail)): a flip of either moves
            # it by rtol * |o| or rtol * |out|, and |o| <= |out| + |tail|
            twice = TOL[dn][1] * (ef.fused_ffn_plain(x, w1, b1, w2, b2).float().abs()
                                  + ef.ffn_tail(b1, w2, b2).abs())
            cases.append((
                "fused_ffn", f"B={B} S={S} E={E} F={Fh}", dn,
                lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ef.fused_ffn(x, w1, b1, w2, b2),
                lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ef.fused_ffn_plain(x, w1, b1, w2, b2),
                lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: F.linear(F.relu(F.linear(x, w1, b1)),
                                                                 w2, b2),
                2 * B * S * E * isz + 2 * E * Fh * isz + Fh * isz + 4 * E, 4 * B * S * E * Fh,
                dn, twice,
            ))
        # K6: the image encoder (per-head logits of bq), the constraint encoder
        # with key padding, FIDNet (Dh=64) with every 3rd row fully masked
        for B, S, H, keys in ((128, 330, 8, False), (128, 89, 8, True), (256, 11, 4, True)):
            E, Dh = 256, 256 // H
            x = torch.randn(B, S, E, generator=g, device=dev).to(dtype)
            wqkv = torch.randn(3 * E, E, generator=g, device=dev) * E**-0.5
            wqkv[:E] *= Dh**-0.5
            wqkv = wqkv.to(dtype)
            kb = torch.randn(B, H, S, generator=g, device=dev)
            if keys:
                keep = torch.rand(B, S, generator=g, device=dev) > 0.3
                keep[::3] = False
                kb = kb + torch.where(keep, 0.0, -1e9)[:, None, :]

            def sdpa(x=x, wqkv=wqkv, kb=kb, H=H, Dh=Dh):
                qkv = F.linear(x, wqkv).view(x.shape[0], x.shape[1], 3, H, Dh)
                q, k, v = qkv.permute(2, 0, 3, 1, 4)
                return F.scaled_dot_product_attention(q, k, v, attn_mask=kb[:, :, None, :]
                                                      .to(x.dtype), scale=1.0)

            # bf16: q, k, v are rounded after fp32 sums in another order; one
            # flipped rounding of a p or a v moves an output by <= 2^-8 max_j |v_j|
            v_max = (x.float() @ wqkv[2 * E:].float().t()).abs().amax(dim=1, keepdim=True)
            cases.append((
                "encoder_self_attention", f"B={B} S={S} H={H} Dh={Dh} key_mask={keys}", dn,
                lambda x=x, wqkv=wqkv, H=H, kb=kb: ea.encoder_self_attention(x, wqkv, H, kb),
                lambda x=x, wqkv=wqkv, H=H, kb=kb: ea.encoder_self_attention_plain(x, wqkv, H, kb),
                sdpa, 2 * B * S * E * isz + 3 * E * E * isz + 4 * B * H * S,
                2 * B * S * E * 3 * E + 4 * B * S * S * E, dn,
                2**-8 * v_max if dtype == torch.bfloat16 else 0.0,
            ))
        # K10: the denoising decoder's cross-attention in the benchmark's requests of
        # 1024 canvases (the main row), in this script's of 128, and with a key bias
        for B, keys in ((1024, False), (128, False), (128, True)):
            S, M, E, H = 50, 330, 256, 8
            Dh = E // H
            q = torch.randn(B, S, E, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(B, M, E, generator=g, device=dev).to(dtype) for _ in range(2))
            kb = None
            if keys:
                keep = torch.rand(B, M, generator=g, device=dev) > 0.3
                keep[::3] = False
                kb = torch.where(keep, 0.0, -1e9).float()

            def sdpa(q=q, k=k, v=v, kb=kb, H=H, Dh=Dh):
                heads = [t.view(t.shape[0], t.shape[1], H, Dh).transpose(1, 2) for t in (q, k, v)]
                mask = None if kb is None else kb[:, None, None, :].to(q.dtype)
                return F.scaled_dot_product_attention(*heads, attn_mask=mask, scale=Dh**-0.5)

            # bf16: p rounded before normalisation (online softmax) where the plain
            # version rounds it after: <= 2^-8 max_j |v_j| of the (row, head)
            v_max = v.float().reshape(B, M, H, Dh).abs().amax(dim=(1, 3))
            v_max = v_max[:, None, :, None].expand(B, 1, H, Dh).reshape(B, 1, E)
            cases.append((
                "cross_attention", f"B={B} S={S} M={M} H={H} Dh={Dh} key_mask={keys}", dn,
                lambda q=q, k=k, v=v, kb=kb, H=H, Dh=Dh: xa.cross_attention(q, k, v, H, kb,
                                                                             Dh**-0.5),
                lambda q=q, k=k, v=v, kb=kb, H=H, Dh=Dh: xa.cross_attention_plain(q, k, v, H, kb,
                                                                                   Dh**-0.5),
                sdpa, (2 * B * S * E + 2 * B * M * E) * isz + (4 * B * M if keys else 0),
                4 * B * S * M * E, dn, 2**-8 * v_max if dtype == torch.bfloat16 else 0.0,
            ))
        # K11: ResNet50's largest BatchNorm call in the benchmark's requests of 1024
        # canvases at 350x240 (layer1's bn3 with its residual and ReLU: the main row),
        # then the stem's (ReLU, no residual); fp32 at this script's batch of 128
        for (C, H, W), residual in (((256, 88, 60), True), ((64, 175, 120), False)):
            B = 1024 if dtype == torch.bfloat16 else 128
            x, r = (torch.randn(B, H, W, C, generator=g, device=dev).to(dtype)
                    .permute(0, 3, 1, 2) for _ in range(2))
            r = r if residual else None
            w, b, m = (torch.randn(C, generator=g, device=dev) for _ in range(3))
            params = (1 + 0.2 * w, 0.2 * b, 0.3 * m, 0.5 + torch.rand(C, generator=g, device=dev))
            params = tuple(t.to(dtype) for t in params)
            n = x.numel()
            cases.append((
                "batchnorm_act", f"[{B}, {C}, {H}, {W}] residual={residual} relu=True", dn,
                lambda x=x, r=r, p=params: bna.batchnorm_act(x, *p, 1e-5, r, True),
                lambda x=x, r=r, p=params: bna.batchnorm_act_plain(x, *p, 1e-5, r, True),
                # the module's plain path: the unfused eval sequence the card ran before K11
                lambda x=x, r=r, p=params: resnet.eval_plain(x, *p, 1e-5, r, True),
                (3 if residual else 2) * n * isz + 4 * C * isz,
                (3 if residual else 2) * n, "float32", 0.0,
            ))
    # the exact assignment: random costs first (the main row), then ties in every
    # row (small integers) with one row of all equal costs, exactly equal to the plain
    # version; the bound counts the Dijkstra steps these costs take
    for (B, n), kind in [(shape, kind) for shape in LSA_SHAPES for kind in ("random", "ties")]:
        if kind == "random":
            cost = torch.randn(B, n, n, generator=g, device=dev)
        else:
            cost = torch.randint(0, 3, (B, n, n), generator=g, device=dev).float()
            cost[0] = 1.0
        steps = asg.batched_lsa_plain(cost.cpu(), return_steps=True)[1]
        cases.append((
            "batched_lsa", f"B={B} n={n} {kind}", "int32",
            lambda c=cost: asg.batched_lsa(c), lambda c=cost: asg.batched_lsa_plain(c), None,
            4 * B * n * n + 4 * B * n, LSA_OPS_PER_COLUMN * (n + 1) * steps, "float32", 0.0,
        ))
    # K9 on one slab of the stream probe and its views (int8 first: the main row)
    B = STREAM_SHAPE[0]
    slab = torch.randint(-127, 128, STREAM_SHAPE, generator=g, device=dev, dtype=torch.int8)
    for view in STREAM_VIEWS:
        x = stream_view(torch, slab, view)
        dims = tuple(range(1, x.dim()))
        scale = x.float().abs().sum(dims)  # fp32 sums in another order: 1e-5 of sum|x|
        cases.append((
            "stream_sum", f"{list(x.shape)} {view}", view,
            lambda x=x: ss.stream_sum(x), lambda x=x: ss.stream_sum_plain(x),
            lambda x=x, dims=dims: torch.sum(x, dims, dtype=torch.float32),
            x.numel() * x.element_size() + 4 * B, x.numel(), "float32",
            0.0 if view == "int8" else 1e-5 * scale,
        ))
    return cases


STREAM_VIEWS = ("int8", "int16", "int32", "float32", "bfloat16")


def stream_view(torch, slab, view: str):
    """scripts/probe_dma_rate.py's views of one int8 slab [B, M, E]: itself,
    int16 and int32 bitcasts, the f32 bitcast with bit 30 of every word
    cleared (no NaN or Inf pattern), and a bf16 copy (twice the bytes)."""
    if view == "float32":
        return (slab.view(torch.int32) & ~(1 << 30)).view(torch.float32)
    if view == "bfloat16":
        return slab.bfloat16()
    return slab.view(getattr(torch, view))


def run_kernel_checks(torch, dev, fails: Failures, cases=None) -> dict:
    """Check and time every case (`kernel_cases`'s unless given); returns the
    main-shape bf16 row of each kernel."""
    main_rows = {}
    extra_names = {"encoder_attention": "; in bf16 else one flipped rounding of a p",
                   "decode_shared_attention_q8mxu": " + ps",
                   "fused_ffn": " + rtol*(|ref| + |tail|)",
                   "encoder_self_attention": " + 2^-8*max|v| in bf16",
                   "cross_attention": " + 2^-8*max|v| in bf16",
                   "stream_sum": " + 1e-5*sum|x|"}
    for name, label, dn, kern, plain, lib, nbytes, ops, op_type, extra in (
            kernel_cases(torch, dev) if cases is None else cases):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        atol, rtol = TOL[dn]
        outside = err > atol + (0.0 if callable(extra) else extra) + rtol * ref.float().abs()
        unexplained, flips = int(outside.sum()), ""
        if callable(extra) and unexplained:  # each must be one flipped rounding
            explained, share = extra(out, outside)
            flips = (f"; {unexplained} outside, {int(explained.sum())} of them at most one "
                     f"flipped p (using {share:.3f} of its reorder bound)")
            unexplained -= int(explained.sum())
        ok = bool(torch.isfinite(out.float()).all()) and unexplained == 0
        row = {
            "max_abs_err": float(err.max()),
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": None if lib is None else time_ms(lib), "library": LIBRARY.get(name),
        }
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, op_type)
        fails.check(ok, f"{name} {label} {dn}: max_abs_err {row['max_abs_err']:.3e} "
                        f"(tol {atol} + {rtol}*|ref|{extra_names.get(name, '')}){flips}")
        print(f"  {name} {label} {dn}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']} ms ({row['library']}), bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})", flush=True)
        if dn == MAIN_DTYPE.get(name, "bfloat16") and name not in main_rows:
            main_rows[name] = row  # the first case in its main dtype is the main path's shape
    return main_rows


def build_gallery_and_batches(gen, dev, n_requests: int, batch: int, gallery_size: int,
                              image_dtype=np.uint8):
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    hw = gen.image_hw
    gallery = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=gallery_size,
                                     seed=1, image_hw=hw)
    retriever = Retriever.build(gallery, device=dev)
    feats = gen.precompute_retrieved_feats(retriever.layouts)
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=n_requests * batch,
                                seed=0, image_hw=hw)
    loader = RetrievalAugmentedLoader(
        BatchLoader(ds, batch, shuffle=False, image_dtype=image_dtype), retriever,
        top_k=gen.top_k, feats_table=feats)
    return retriever, feats, list(loader)


def layer_decode(torch, decoder, memory, token_mask, forced, tok, sampling, generator=None,
                 shared=False, kv_quant=False, margins=False):
    """The decode loop written against TokenDecoder's own methods (stack.cross_kv,
    embed_step, stack.step, head), as a user of the decoder writes it: the way
    to the per-layer cross K/V of cross_kv(shared=False), which ar_decode does
    not offer.  Returns (tokens [B, L], the first step's logits [B, V]) and with
    `margins` each row's least top-two margin of the logits it sampled from."""
    from ralf_tpu_torch.core.sampling import NEG_INF, sample

    B, dev, L = memory.shape[0], memory.device, tok.max_token_length
    with torch.inference_mode():
        cache = decoder.stack.init_cache(B, L, dtype=decoder.emb.weight.dtype, device=dev)
        cross = decoder.stack.cross_kv(memory, kv_quant, shared=shared,
                                       dtype=decoder.emb.weight.dtype)
        forced = torch.as_tensor(np.asarray(forced), device=dev).long()
        pos, vocab = torch.arange(L, device=dev), torch.arange(token_mask.shape[1], device=dev)
        keep = torch.zeros((B, L), dtype=torch.bool, device=dev)
        prev = torch.full((B,), tok.bos_id, dtype=torch.long, device=dev)
        toks, first = [], None
        least = torch.full((B,), float("inf"), device=dev)
        for t in range(L):
            keep[:, t] = prev != tok.pad_id
            x = decoder.stack.step(decoder.embed_step(prev, t), t, cache, cross,
                                   keep & (pos <= t)[None], None)
            logits = decoder.head(x)[:, 0].float()
            first = logits if first is None else first
            logits = torch.where(token_mask[t][None], logits, NEG_INF)
            f = forced[:, t]
            only_f = torch.where(vocab[None] == f[:, None], 0.0, NEG_INF)
            logits = torch.where((f >= 0)[:, None], only_f, logits)
            if margins:
                top2 = logits.topk(2, dim=-1).values
                least = torch.minimum(least, top2[:, 0] - top2[:, 1])
            prev = sample(logits, sampling, generator)
            toks.append(prev)
        if margins:
            return torch.stack(toks, 1), first, least
        return torch.stack(toks, 1), first


def reference_check(torch, tok, fails: Failures) -> None:
    """fp32 full-width RALF: kernels on the card vs plain versions on the CPU."""
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    t0 = time.perf_counter()
    cfg = GeneratorConfig(dtype=torch.float32)
    gens = {d: RALFGenerator(tok, cfg, "uncond", device=d, seed=0) for d in ("cuda", "cpu")}
    feats, conds, mems = {}, {}, {}
    for d, gen in gens.items():
        _, feats[d], batches = build_gallery_and_batches(gen, d, 1, 2, 64, np.float32)
        conds[d], _ = gen.build_condition(batches[0], np.random.default_rng(0), task="c")
        mems[d] = gen.encode_memory(conds[d]).cpu()
    f_err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
    fails.check(f_err < 1e-3, f"check: FIDNet gallery features card vs CPU max_abs_err {f_err:.3e} (tol 1e-3)")
    m_err = float((mems["cuda"] - mems["cpu"]).abs().max())
    fails.check(m_err < 1e-3, f"check: encode_memory card vs CPU max_abs_err {m_err:.3e} (tol 1e-3), "
                              f"memory {tuple(mems['cpu'].shape)}")
    greedy = SamplingConfig(name="deterministic")
    forced = build_forced_tokens(conds["cpu"], tok)

    def agreement(a, b):
        return float((a.cpu() == b.cpu()).float().mean())

    # shared memory through ar_decode: K2, K3, and K4 (int8 contractions)
    for kvq, sq, mxu, least in ((False, False, False, 1.0), (True, True, False, 1.0),
                                (True, True, True, AGREE)):
        toks = {d: gens[d].decode(mems["cpu"].to(d), forced, greedy, kv_quant=kvq,
                                  self_quant=sq, q8_mxu=mxu) for d in gens}
        same = agreement(toks["cuda"], toks["cpu"])
        fails.check(same >= least, f"check: greedy tokens card vs CPU kv_quant={kvq} "
                                   f"self_quant={sq} q8_mxu={mxu}: {same:.4f} equal (least {least})")
    # per-layer cross K/V through the decoder's own methods: K7, and K8 with kv_quant
    token_mask = {d: gens[d].token_mask for d in gens}
    per_layer = {(d, kvq): layer_decode(torch, gens[d].core.decoder, mems["cpu"].to(d),
                                        token_mask[d], forced, tok, greedy, kv_quant=kvq)
                 for d in gens for kvq in (False, True)}
    for kvq in (False, True):
        same = agreement(per_layer[("cuda", kvq)][0], per_layer[("cpu", kvq)][0])
        fails.check(same >= AGREE, f"check: per-layer cross K/V (K{8 if kvq else 7}) greedy tokens "
                                   f"card vs CPU kv_quant={kvq}: {same:.4f} equal (least {AGREE})")
    # the per-layer decode (K7) and the shared one (K2) compute the same function
    shared = layer_decode(torch, gens["cuda"].core.decoder, mems["cpu"].cuda(), token_mask["cuda"],
                          forced, tok, greedy, shared=True)
    l_err = float((per_layer[("cuda", False)][1] - shared[1]).abs().max())
    same = agreement(per_layer[("cuda", False)][0], shared[0])
    fails.check(l_err <= 1e-3 and same >= AGREE,
                f"check: per-layer (K7) vs shared (K2) decode on the card: first-step logits "
                f"max_abs_err {l_err:.3e} (tol 1e-3), greedy tokens {same:.4f} equal (least {AGREE})")

    # the fused encoder on every module: K6 for every self-attention (FIDNet's
    # too), K5 for the FFNs with S >= 16 (the image encoder's; task c's
    # constraint encoder, Lc = 23)
    fused_mems, fused_feats = {}, {}
    for d, gen in gens.items():
        set_fused_encoder(gen.core, True)
        _, fused_feats[d], _ = build_gallery_and_batches(gen, d, 1, 2, 64, np.float32)
        fused_mems[d] = gen.encode_memory(conds[d]).cpu()
    f_err = float(np.abs(fused_feats["cuda"] - fused_feats["cpu"]).max())
    fails.check(f_err < 1e-3, f"check: fused encoder, FIDNet gallery features card vs CPU "
                              f"max_abs_err {f_err:.3e} (tol 1e-3)")
    m_err = float((fused_mems["cuda"] - fused_mems["cpu"]).abs().max())
    u_err = float((fused_mems["cuda"] - mems["cuda"]).abs().max())
    fails.check(m_err < 1e-3, f"check: fused encoder, encode_memory card vs CPU max_abs_err "
                              f"{m_err:.3e} (tol 1e-3; {u_err:.3e} from the unfused memory)")
    toks = {d: gens[d].decode(fused_mems["cpu"].to(d), forced, greedy) for d in gens}
    same = agreement(toks["cuda"], toks["cpu"])
    fails.check(same >= AGREE, f"check: fused encoder, greedy tokens card vs CPU: {same:.4f} "
                               f"equal (least {AGREE})")
    print(f"  check phase {time.perf_counter() - t0:.1f} s", flush=True)


def run_slice(torch, tok, fails: Failures) -> dict:
    """Full-width bf16 requests of 128 canvases; returns the launches of each
    kernel summed over the counted requests (warm-ups and profiles excluded)."""
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.eval.violations import calculate_violation
    from ralf_tpu_torch.models.autoreg import AutoregGenerator
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    t0 = time.perf_counter()
    cfg = GeneratorConfig(dtype=torch.bfloat16)
    gen = RALFGenerator(tok, cfg, "uncond", top_k=16, device="cuda", seed=0)
    count = counters()
    count["K1"].launches = 0
    retriever, feats, batches = build_gallery_and_batches(gen, "cuda", N_REQUESTS, BATCH, GALLERY)
    fails.check(count["K1"].launches == 4 and feats.shape == (GALLERY, 256)
                and bool(np.isfinite(feats).all()),
                f"slice: gallery table {feats.shape} from {count['K1'].launches} "
                "K1 launches (4 FIDNet layers)")
    print(f"  slice set-up {time.perf_counter() - t0:.1f} s", flush=True)
    sampling = SamplingConfig(name="top_p", top_p=0.9, temperature=1.0)
    L = tok.max_token_length
    counted = LaunchCounter()
    k11 = k11_forward(gen)  # the image encoder's BatchNorms, once a request

    def check_request(label, cond, toks, layout, n, expect):
        """Forced tokens in place, legal tokens, finite layouts, and exactly the
        expected launches (every other kernel 0)."""
        forced = torch.as_tensor(build_forced_tokens(cond, tok), device=toks.device)
        forced_ok = bool((toks[forced >= 0] == forced[forced >= 0]).all())
        legal = bool(gen.token_mask[torch.arange(L, device=toks.device)[None, :], toks].all())
        geo_ok = all(bool(torch.isfinite(layout.geo(k)).all()) for k in
                     ("center_x", "center_y", "width", "height"))
        want = {**dict.fromkeys(count, 0), **expect}
        fails.check(n == want and forced_ok and legal and geo_ok and tuple(toks.shape) == (BATCH, L),
                    f"slice {label}: launches {n} (want {want}), forced tokens in place={forced_ok}, "
                    f"tokens legal={legal}, layouts decoded (finite={geo_ok}, "
                    f"{int(layout.mask.sum())} elements)")

    def uncond_requests(label, kvq, sq, expect):
        """A warm-up, N_REQUESTS counted requests (encode and decode timed
        apart) with distinct outputs, and one more under torch.profiler."""

        def request(batch, seed):
            cond, _ = gen.build_condition(batch, np.random.default_rng(seed))
            forced = build_forced_tokens(cond, tok)
            torch.cuda.synchronize()
            a = time.perf_counter()
            mem = gen.encode_memory(cond)
            torch.cuda.synchronize()
            b = time.perf_counter()
            toks = gen.decode(mem, forced, sampling,
                              torch.Generator(device="cuda").manual_seed(seed), kvq, sq)
            torch.cuda.synchronize()
            c = time.perf_counter()
            return cond, mem, toks, tok.decode(toks), b - a, c - b

        request(batches[0], 99)  # warm-up, outside the counted run
        outs = []
        for i, batch in enumerate(batches):
            (cond, mem, toks, layout, t_enc, t_dec), n = counted(lambda: request(batch, i))
            check_request(f"{label} request {i} (memory {tuple(mem.shape)})", cond, toks, layout,
                          n, expect)
            print(f"  {label} request {i}: encode {t_enc * 1e3:.1f} ms, "
                  f"decode {t_dec * 1e3:.1f} ms, {BATCH / (t_enc + t_dec):.1f} layouts/s", flush=True)
            outs.append(toks.cpu().numpy().tobytes())
        fails.check(len(set(outs)) == N_REQUESTS, f"slice {label}: the {N_REQUESTS} requests "
                                                  "give distinct outputs")
        profile_request(torch, label, lambda: request(batches[0], 7))

    # the two uncond configurations
    uncond_requests("cli-default", False, False, {"K1": 12, "K2": 300, "K11": k11})
    uncond_requests("bench", True, True, {"K1": 12, "K3": 300, "K11": k11})

    # one request per task, kv_quant + self_quant + q8_mxu (K4), through sample()
    for i, task in enumerate(TASKS):
        def sample_task():
            cond, _ = gen.build_condition(batches[0], np.random.default_rng(100 + i), task=task)
            torch.cuda.synchronize()
            a = time.perf_counter()
            layout, toks = gen.sample(cond, sampling, torch.Generator(device="cuda").manual_seed(i),
                                      return_tokens=True, max_retries=RETRIES, kv_quant=True,
                                      self_quant=True, q8_mxu=True)
            torch.cuda.synchronize()
            return cond, layout, toks, time.perf_counter() - a

        (cond, layout, toks, dt), n = counted(sample_task)
        steps = RETRIES * L if task == "relation" else L  # the retry decode: R attempts per element
        check_request(f"task {task} (constraint length {cond.const_seq.shape[1]})", cond, toks,
                      layout, n, {"K1": 12, "K4": 6 * steps, "K11": k11})
        v = calculate_violation(cond, toks, layout, tok)
        print(f"  task {task}: {dt * 1e3:.1f} ms, {BATCH / dt:.1f} layouts/s; violations "
              f"{v['viorated']}/{v['total']} = {v['viorated'] / v['total']:.4f}", flush=True)
        if task == "uncond":  # K4's share of a task request's device time
            profile_request(torch, "task uncond (q8_mxu)", sample_task)

    # the per-layer cross K/V, in bf16 (K7) and int8 (K8), through the decoder's methods
    for kvq, kernel in ((False, "K7"), (True, "K8")):
        def per_layer():
            cond, _ = gen.build_condition(batches[0], np.random.default_rng(200))
            torch.cuda.synchronize()
            a = time.perf_counter()
            mem = gen.encode_memory(cond)
            toks, _ = layer_decode(torch, gen.core.decoder, mem, gen.token_mask,
                                   build_forced_tokens(cond, tok), tok, sampling,
                                   torch.Generator(device="cuda").manual_seed(3), kv_quant=kvq)
            torch.cuda.synchronize()
            return cond, toks, time.perf_counter() - a

        (cond, toks, dt), n = counted(per_layer)
        check_request(f"per-layer cross K/V kv_quant={kvq}", cond, toks, tok.decode(toks), n,
                      {"K1": 12, kernel: 300, "K11": k11})
        print(f"  per-layer kv_quant={kvq}: {dt * 1e3:.1f} ms, {BATCH / dt:.1f} layouts/s", flush=True)
        if kvq:  # K8's share of a per-layer int8 request's device time
            profile_request(torch, "per-layer int8 (K8)", per_layer)

    # the plain autoreg family, CLI default configuration (K2)
    ar = AutoregGenerator(tok, cfg, "uncond", device="cuda", seed=0)

    def autoreg():
        cond, _ = ar.build_condition(batches[0], np.random.default_rng(300))
        return cond, *ar.sample(cond, sampling, torch.Generator(device="cuda").manual_seed(4),
                                return_tokens=True)

    (cond, layout, toks), n = counted(autoreg)
    check_request("autoreg uncond", cond, toks, layout, n,
                  {"K1": 12, "K2": 300, "K11": k11_forward(ar)})

    # the fused encoder: K6 for the 6 + 6 self-attentions, K5 for the image
    # encoder's 6 FFNs (the uncond constraint, Lc = 4, stays under S >= 16)
    fused = {"K5": 6, "K6": 12, "K2": 300, "K11": k11}
    set_fused_encoder(gen.core, True)
    uncond_requests("fused-encoder", False, False, fused)
    set_fused_encoder(ar.core, True)
    (cond, layout, toks), n = counted(autoreg)
    check_request("fused-encoder autoreg uncond", cond, toks, layout, n, fused)

    # FIDNet's full forward over the gallery: K6 for its 4 encoder and 4
    # decoder layers (S = 11 and 10, Dh = 64; a layout with no element
    # makes a fully masked decoder row)
    from ralf_tpu_torch.core.layout import Layout
    from ralf_tpu_torch.models.fidnet import FIDNetV3

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fid = FIDNetV3(tok.N_label, max_bbox=tok.max_seq_length)
    fid = fid.to(device="cuda", dtype=torch.bfloat16).eval()
    set_fused_encoder(fid, True)
    layouts = Layout.fromdict(retriever.layouts, device="cuda")

    def fidnet():
        with torch.inference_mode():
            out = fid(layouts)
        torch.cuda.synchronize()
        return out

    (disc, cls, box), n = counted(fidnet)
    S = tok.max_seq_length
    shapes = [tuple(t.shape) for t in (disc, cls, box)]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (disc, cls, box))
    want = {**dict.fromkeys(count, 0), "K6": 8}
    fails.check(n == want and finite and shapes == [(GALLERY,), (GALLERY, S, tok.N_label),
                                                    (GALLERY, S, 4)],
                f"slice fused-encoder FIDNet forward over the gallery: launches {n} (want {want}), "
                f"outputs {shapes}, finite={finite}, "
                f"{int((~layouts.mask.any(1)).sum())} layouts with no element")
    print(f"  slice phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def run_stream(torch, fails: Failures) -> int:
    """K9 as scripts/probe_dma_rate.py runs it: per view of the slabs, one
    call on a slab of its own to warm up, then 8 calls on 8 distinct slabs
    between two CUDA events; returns K9's launches."""
    from ralf_tpu_torch.ops import stream_sum as ss

    t0 = time.perf_counter()
    B, M, E = STREAM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(1)
    slabs = [torch.randint(-127, 128, STREAM_SHAPE, generator=g, device="cuda", dtype=torch.int8)
             for _ in range(STREAM_SLABS)]
    count = counters()
    for c in count.values():
        c.launches = 0
    for view in STREAM_VIEWS:
        xs = [stream_view(torch, s, view) for s in slabs]
        nbytes = xs[0].numel() * xs[0].element_size()
        ss.stream_sum(xs[0])
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        outs = [ss.stream_sum(x) for x in xs[1:]]
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / len(outs)
        rate = nbytes / (ms * 1e-3)
        distinct = len({o.cpu().numpy().tobytes() for o in outs}) == len(outs)
        fails.check(distinct, f"stream {view} {list(xs[0].shape)}: {ms:.4f} ms/call, "
                              f"{rate / 1e9:.1f} GB/s = {100 * rate / HBM_BYTES_PER_S:.1f}% of "
                              f"3.35 TB/s ({nbytes / 1e6:.1f} MB per call); the "
                              f"{len(outs)} outputs distinct={distinct}")
        del xs, outs
        torch.cuda.empty_cache()
    n = {k: c.launches for k, c in count.items()}
    want = {**dict.fromkeys(count, 0), "K9": 5 * STREAM_SLABS}
    fails.check(n == want, f"stream: launches {n} (want {want})")
    print(f"  stream phase {time.perf_counter() - t0:.1f} s", flush=True)
    return n["K9"]


def tensor_core_gemm(name: str) -> bool:
    """A library kernel that runs a GEMM or a convolution on the bf16 tensor
    cores, by its name: cuBLAS's nvjet kernels (tensor cores only; with TF32
    off no fp32 GEMM takes them) and cuBLAS/cuDNN/CUTLASS kernels that name
    bf16 and a GEMM or convolution.  The port's own kernels (ralf::) are not
    counted."""
    n = name.lower()
    return not name.startswith("ralf::") and ("nvjet" in n or "bf16" in n and any(
        m in n for m in ("gemm", "conv", "fprop", "dgrad", "wgrad", "tensorop")))


def profile_request(torch, label: str, run) -> dict:
    """One more request (or train step) under torch.profiler, inside the
    benchmark's marked window and read by its reader (`benchmark/lib/trace.py`,
    straight from Kineto's records: `key_averages()` builds a Python event for
    each of a request's some 200 thousand host and device records first, about
    20 s a request, where this takes about 1): the device's busy share of the
    window as the union of the device operations' intervals
    (`benchmark/costs/idle.py`; a sum of their durations counts overlaps twice
    and can pass 100%), the share of the device time in bf16 tensor-core
    GEMMs and convolutions (`tensor_core_gemm`), the operations that take
    most of it and the port's own kernels below those, each with its share
    of the device time, and the host ranges by name (the port's spans,
    `utils/tracing.py`, and the optimizer's own record).  For information;
    it checks nothing.  Returns {"wall_ms", "kernel_ms", "busy", "launches",
    "tensor_core_share"} (empty without device time)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.lib import trace as trace_mod

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace_mod.WINDOW):
            run()
            torch.cuda.synchronize()
    t = time.perf_counter()
    tr = trace_mod.read(torch, prof, 1)
    if not tr.ops:
        print(f"  {label} profile: no device time recorded (busy share not measured)", flush=True)
        return {}
    kernels: dict = collections.defaultdict(lambda: [0.0, 0])
    for s0, e0, name in tr.ops:
        kernels[name][0] += (e0 - s0) / 1e3
        kernels[name][1] += 1
    spans: dict = collections.defaultdict(float)
    for s0, e0, name in tr.host:
        if name != trace_mod.WINDOW:
            spans[name] += (e0 - s0) / 1e6
    rows = [(us, n, key) for key, (us, n) in kernels.items()]
    device_us = sum(r[0] for r in rows)
    busy = tr.busy_s / tr.window_s
    tc = sum(r[0] for r in rows if tensor_core_gemm(r[2])) / device_us
    print(f"  {label} profile: window {tr.window_s * 1e3:.1f} ms, device {tr.busy_s * 1e3:.1f} ms "
          f"busy ({100 * busy:.1f}%, {device_us / 1e3:.1f} ms summed), {len(tr.ops)} launches, "
          f"{100 * tc:.1f}% of the device time in bf16 tensor-core GEMMs and convolutions"
          + "".join(f"; span {key} {ms:.2f} ms" for key, ms in sorted(spans.items()))
          + f" (records read in {time.perf_counter() - t:.1f} s)", flush=True)
    ranked = sorted(rows, reverse=True)
    for us, n, key in ranked[:8] + [r for r in ranked[8:] if "ralf::" in r[2]]:
        print(f"    {us / 1e3:8.2f} ms {100 * us / device_us:5.2f}% {n:6d}x {key[:90]}", flush=True)
    return {"wall_ms": tr.window_s * 1e3, "kernel_ms": device_us / 1e3, "busy": busy,
            "launches": len(tr.ops), "tensor_core_share": tc}


def run_cli(torch, fails: Failures, smi: list, tmp: str, overrides=tuple(CLI_CONFIG)) -> dict:
    """The inference and evaluation entry points on the card, the job dir in
    `tmp/job` (its c pickles `tmp/job/out_c`, which the fid_train phase
    evaluates once more); returns the launches of each kernel summed over
    the counted calls."""
    from ralf_tpu_torch.cli import evaluate, inference
    from ralf_tpu_torch.config import build_config, build_datasets, build_generator, build_tokenizer
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.utils.weights import export_params, save_params_npz

    t0 = time.perf_counter()
    counted = LaunchCounter()

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    card = smi[0] if smi else torch.cuda.get_device_name(0)
    job = os.path.join(tmp, "job")
    cfg = build_config("ralf", [*overrides, f"cache_dir={tmp}/cache"])
    cfg.save(job)
    tok = build_tokenizer(cfg)
    gen = build_generator(cfg, tok, device="cuda")
    save_params_npz(os.path.join(job, "ckpt_final.npz"), *export_params(gen.core))
    train_ds, _, test_ds = build_datasets(cfg)
    n_test, L = len(test_ds), tok.max_token_length
    print(f"  cli job dir: ralf, d_model {gen.cfg.d_model}, {gen.cfg.nhead} heads, "
          f"{gen.cfg.num_encoder_layers}+{gen.cfg.num_decoder_layers} layers, FFN "
          f"{gen.cfg.dim_feedforward}, {gen.cfg.backbone}, {gen.image_hw}, top-{gen.top_k}, "
          f"{gen.cfg.dtype}; splits {len(train_ds)} / {n_test}", flush=True)
    # two seeds: the second times the configuration warm; K1 4 for FIDNet's
    # gallery table, then per seed 12 for the encoders and 6 * L decode steps, and
    # the image encoder's K11 (the test split is one batch)
    k11 = k11_forward(gen)
    per_call = {"K1": 4 + CLI_SEEDS * 12, "decode": CLI_SEEDS * 6 * L, "K11": CLI_SEEDS * k11}
    runs = {"c": (["--cond", "c"], want(K1=per_call["K1"], K2=per_call["decode"],
                                        K11=per_call["K11"])),
            "uncond-int8": (["--cond", "uncond", "--kv-quant", "--self-quant"],
                            want(K1=per_call["K1"], K3=per_call["decode"], K11=per_call["K11"]))}
    for label, (extra, expect) in runs.items():
        out_dir = os.path.join(job, f"out_{label}")
        argv = ["--job-dir", job, "--num-seeds", str(CLI_SEEDS), "--batch-size",
                str(CLI_BATCH), "--out-dir", out_dir, *extra]
        t_call = time.perf_counter()
        summary, n = counted(lambda: inference.main(argv))
        t_call = time.perf_counter() - t_call
        for seed in range(CLI_SEEDS):
            with open(os.path.join(out_dir, f"test_{seed}.pkl"), "rb") as f:
                records = pickle.load(f)["results"]
            with open(os.path.join(out_dir, f"test_{seed}_violation.csv")) as f:
                total, violated, rate = list(csv.reader(f))[1]
            coords = [v for r in records for k in ("center_x", "center_y", "width", "height")
                      for v in r[k]]
            in_unit = all(0.0 <= v <= 1.0 for v in coords)
            ok_rate = label != "c" or (float(rate) == 0.0 and int(total) > 0)
            fails.check(len(records) == n_test and in_unit and ok_rate,
                        f"cli inference {label} seed {seed}: {len(records)} records (want "
                        f"{n_test}), {len(coords)} coordinates in [0, 1]={in_unit}, "
                        f"violations {violated}/{total} = {rate}")
            ms, per_s = summary["ms_per_sample"][seed], summary["layouts_per_s"][seed]
            print(f"  cli inference {label} seed {seed}: {ms:.3f} ms per sample, "
                  f"{per_s:.1f} layouts/s (batch {CLI_BATCH}; {card})", flush=True)
        fails.check(n == expect, f"cli inference {label}: launches {n} (want {expect})")
        timed = sum(summary["ms_per_sample"].values()) * n_test / 1e3
        print(f"  cli inference {label}: the call {t_call:.2f} s, its timed loops {timed:.2f} s, "
              f"set-up (config, splits, retrieval, gallery table, batches) and writing "
              f"{t_call - timed:.2f} s", flush=True)

    # one canvas of the split through the single-canvas path
    from ralf_tpu_torch.cli.inference import load_generator_params, single_image_batch

    load_generator_params(gen, job, "final")
    retriever = Retriever.build(train_ds, cache_dir=cfg.cache_dir,
                                dataset_name=cfg.dataset.name, device="cuda")

    def single():
        feats = gen.precompute_retrieved_feats(retriever.layouts)
        batch = single_image_batch(test_ds.get_images(np.arange(1)), cfg, retriever,
                                   gen.top_k, feats)
        cond, _ = gen.build_condition(batch, np.random.default_rng(0), task="uncond")
        with torch.inference_mode():
            return gen.sample(cond, SamplingConfig(name="deterministic"), return_tokens=True)

    (layout, toks), n = counted(single)
    finite = all(bool(torch.isfinite(layout.geo(k)).all())
                 for k in ("center_x", "center_y", "width", "height"))
    fails.check(n == want(K1=4 + 12, K2=6 * L, K11=k11) and tuple(toks.shape) == (1, L)
                and finite,
                f"cli single canvas: launches {n}, tokens {tuple(toks.shape)}, "
                f"{int(layout.mask.sum())} elements, finite={finite}")

    # evaluation of the c pickles on the card and on the CPU
    scores = {}
    for device in ("cuda", "cpu"):
        argv = ["--input-dir", os.path.join(job, "out_c"), "--job-dir", job, "--device",
                device, "--cache-dir", os.path.join(tmp, f"eval_{device}")]
        with contextlib.redirect_stdout(io.StringIO()):  # its JSON dump; checked below
            scores[device], n = counted(lambda: evaluate.main(argv))
        if device == "cuda":  # FIDNet over the GT layouts, then each seed's
            fails.check(n == want(K1=4 * (1 + CLI_SEEDS)),
                        f"cli evaluate on the card: launches {n}")
    got = scores["cuda"]
    bad = [k for k in SCORE_KEYS if not math.isfinite(got[k]["mean"]) and k not in NAN_ALLOWED]
    fails.check(list(got) == SCORE_KEYS and not bad,
                f"cli evaluate: keys {list(got)} (want JAX's {SCORE_KEYS}); not finite: {bad}")
    pairs = {k: (got[k]["mean"], scores["cpu"][k]["mean"]) for k in HEURISTIC_KEYS}
    nan_apart = [k for k, (a, b) in pairs.items() if math.isnan(a) != math.isnan(b)]
    rel = {k: abs(a - b) / max(abs(b), 1e-12) for k, (a, b) in pairs.items()
           if not (math.isnan(a) or math.isnan(b))}
    worst = max(rel.values())
    fails.check(not nan_apart and worst <= 1e-5,
                f"cli evaluate: heuristic metrics card vs CPU, NaN on one side only: "
                f"{nan_apart}; worst relative difference {worst:.3e} (tol 1e-5)")
    print("  cli scores on the card: " + ", ".join(
        f"{k} {v['mean']:.6g}" for k, v in got.items()), flush=True)
    print(f"  cli phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def write_kmeans_centers(cfg, dataset) -> None:
    """Fit the kmeans vocabulary of the diffusion presets on a split's
    geometry and write it where build_tokenizer reads it (the cache's
    `{dataset}_kmeans_train_clusters.pkl`, `{key}-{bins}` per geometry key)."""
    from ralf_tpu_torch.cache import kmeans_clusters_path
    from ralf_tpu_torch.core.bucketizer import fit_kmeans_1d
    from ralf_tpu_torch.core.layout import GEO_KEYS

    lay = dataset.get_layouts(np.arange(len(dataset)))
    n_bin = cfg.tokenizer.get("num_bin", 128)
    centers = {f"{k}-{n_bin}": fit_kmeans_1d(lay[k][lay["mask"]], n_bin, n_iters=10)
               for k in GEO_KEYS}
    path = kmeans_clusters_path(cfg.cache_dir, cfg.dataset.name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(centers, f)


def zoo_generator(experiment: str, tmp: str, device: str, overrides=()):
    """(config, generator) of a preset at the preset's full width (random
    weights from seed 0), the diffusion presets' kmeans vocabulary fitted on
    the synthetic train split."""
    from ralf_tpu_torch.config import build_config, build_generator, build_tokenizer

    cfg = build_config(experiment, ["synthetic_data=true", f"cache_dir={tmp}/cache", *overrides])
    write_vocabulary(cfg)
    return cfg, build_generator(cfg, build_tokenizer(cfg), device=device)


def write_vocabulary(cfg) -> None:
    """The kmeans centers a diffusion preset's tokenizer reads from the cache
    dir, fitted on the config's synthetic train split (no-op for the others)."""
    from ralf_tpu_torch.config import build_datasets

    if cfg.tokenizer is not None and cfg.tokenizer.get("geo_quantization") == "kmeans":
        write_kmeans_centers(cfg, build_datasets(cfg)[0])


def zoo_batches(gen, cfg, n_requests: int, batch: int, gallery_size: int, image_dtype=np.uint8):
    """Requests of `batch` canvases (the synthetic set, seed 0) in the preset's
    element order; with retrieval, each canvas's top-k of a synthetic
    gallery (seed 1) ride on the batch."""
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    hw = (cfg.dataset.image_h, cfg.dataset.image_w)
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=n_requests * batch,
                                seed=0, image_hw=hw)
    loader = BatchLoader(ds, batch, shuffle=False, transforms=cfg.transforms,
                         image_dtype=image_dtype, seed=0)
    if getattr(gen, "with_retrieval", False):
        gallery = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=gallery_size,
                                         seed=1, image_hw=hw)
        loader = RetrievalAugmentedLoader(loader, Retriever.build(gallery, device=gen.device),
                                          top_k=gen.top_k)
    return list(loader)


def zoo_check(torch, fails: Failures, tmp: str, overrides=()) -> None:
    """Full-width fp32 maskgit, layoutdm, vqdiffusion and layoutdm_ra, card
    against CPU on the same weights and the same batch (RA's neighbours
    retrieved once, on the CPU): encode_memory (RA's with FIDNet over the
    B*K neighbours, the adapter, cross-attention and fusion head), one
    denoising step's logits, deterministic tokens."""
    from ralf_tpu_torch.core.sampling import SamplingConfig

    greedy = SamplingConfig(name="deterministic", temperature=0.0)
    for exp, tasks in ZOO_CHECK.items():
        built = {d: zoo_generator(exp, tmp, d, ("model.dtype=float32", *overrides))
                 for d in ("cuda", "cpu")}
        gens = {d: g for d, (_, g) in built.items()}
        batch = zoo_batches(gens["cpu"], built["cpu"][0], 1, 2, GALLERY, np.float32)[0]
        conds = {d: g.build_condition(batch, np.random.default_rng(0), task=tasks[0])[0]
                 for d, g in gens.items()}
        if exp == "maskgit":
            mems = {d: g.encode_memory(conds[d]).cpu() for d, g in gens.items()}
            seq = gens["cpu"].user_tokens(conds["cpu"])[0]
            with torch.inference_mode():
                logits = {d: g.core.decoder(seq.to(g.device), mems["cpu"].to(g.device),
                                            causal=False).cpu() for d, g in gens.items()}
        else:
            with torch.inference_mode():
                prepared = {d: g.prepare_sample(conds[d]) for d, g in gens.items()}
                mems = {d: g.core.encode_memory(prepared[d]["image"],
                                                prepared[d].get("retrieved")).cpu()
                        for d, g in gens.items()}
                L = gens["cpu"].tokenizer.max_token_length
                x_t = torch.full((2, L), gens["cpu"].diffusion.mask_id, dtype=torch.long)
                logits = {d: g.core.decoder(x_t.to(g.device), mems["cpu"].to(g.device),
                                            torch.full((2,), 25, device=g.device)).cpu()
                          for d, g in gens.items()}
        m_err = float((mems["cuda"] - mems["cpu"]).abs().max())
        l_err = float((logits["cuda"] - logits["cpu"]).abs().max())
        fails.check(m_err < 1e-3 and l_err < 1e-3,
                    f"zoo check {exp}: encode_memory {tuple(mems['cpu'].shape)} card vs CPU "
                    f"max_abs_err {m_err:.3e}, one step's logits {tuple(logits['cpu'].shape)} "
                    f"{l_err:.3e} (tol 1e-3)")
        for task in tasks:
            toks = {}
            for d, g in gens.items():
                cond, _ = g.build_condition(batch, np.random.default_rng(1), task=task)
                toks[d] = g.sample(cond, greedy, return_tokens=True)[1].cpu()
            same = float((toks["cuda"] == toks["cpu"]).float().mean())
            fails.check(same >= AGREE, f"zoo check {exp} task {task}: deterministic tokens card "
                                       f"vs CPU {same:.4f} equal (least {AGREE})")


def zoo_k1(gen) -> int:
    """K1 launches of one request: the image encoder's layers, the diffusion
    decoder's self-attention at every denoising step (MaskGIT's decoder
    attends with a bias and takes none), and RA-LayoutDM's 4 FIDNet layers."""
    denoise = 0 if not hasattr(gen, "diffusion") else gen.cfg.num_decoder_layers * gen.num_timesteps
    return gen.cfg.num_encoder_layers + denoise + (4 if getattr(gen, "with_retrieval", False) else 0)


def k10_request(gen) -> int:
    """K10 launches of one sampling request: the decoder's cross-attention over
    the image memory at each layer and step (the diffusion models' denoising
    steps, MaskGIT's unmasking steps, CGL-GAN's one pass); none for RALF and
    autoreg (K2 decodes), DS-GAN, ICVT (its own concat cross-attention) and
    the retriever."""
    from ralf_tpu_torch.models.cgl_gan import CGLGANGenerator
    from ralf_tpu_torch.models.dsgan import DSGANGenerator
    from ralf_tpu_torch.models.maskgit import MaskGITGenerator

    if hasattr(gen, "diffusion") or isinstance(gen, MaskGITGenerator):
        return gen.cfg.num_decoder_layers * gen.num_timesteps
    if isinstance(gen, CGLGANGenerator) and not isinstance(gen, DSGANGenerator):
        return gen.cfg.num_decoder_layers
    return 0


def run_zoo(torch, fails: Failures, smi: list, checks, overrides=()) -> dict:
    """MaskGIT, LayoutDM, VQDiffusion and RA-LayoutDM on the card: the fp32
    check against the CPU, requests of ZOO_BATCH canvases in bf16 with exact
    K1 counts, one profiled request, then cli.inference and cli.evaluate on
    a layoutdm job dir; returns the launches of each kernel summed over the
    counted calls.  `overrides` cut the models for a rehearsal without a
    card; the script passes none."""
    from ralf_tpu_torch.cli import evaluate, inference
    from ralf_tpu_torch.utils.weights import export_params, save_params_npz

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    with tempfile.TemporaryDirectory() as tmp:
        checks.run("zoo_check", tmp=tmp, overrides=overrides)

        for exp, tasks in ZOO_SERVE.items():
            cfg, gen = zoo_generator(exp, tmp, "cuda", ("model.dtype=bfloat16", *overrides))
            tok, L, k1 = gen.tokenizer, gen.tokenizer.max_token_length, zoo_k1(gen)
            k10, k11 = k10_request(gen), k11_forward(gen)
            batches = zoo_batches(gen, cfg, ZOO_REQUESTS, ZOO_BATCH, GALLERY)
            token_mask = torch.as_tensor(tok.token_mask, device=gen.device)
            pos = torch.arange(L, device=gen.device)[None, :]

            def request(batch, task, seed):
                cond, _ = gen.build_condition(batch, np.random.default_rng(seed), task=task)
                torch.cuda.synchronize()
                a = time.perf_counter()
                layout, toks = gen.sample(cond, cfg.sampling,
                                          torch.Generator(device=gen.device).manual_seed(seed),
                                          return_tokens=True)
                torch.cuda.synchronize()
                return cond, layout, toks, time.perf_counter() - a

            request(batches[0], "uncond", 99)  # warm-up, outside the counted runs
            outs = []
            for i, (task, batch) in enumerate([("uncond", b) for b in batches]
                                              + [(t, batches[0]) for t in tasks]):
                (cond, layout, toks, dt), n = counted(lambda: request(batch, task, i))
                no_mask = not bool((toks == tok.name_to_id("mask")).any())
                # VQDiffusion replaces over the whole vocabulary: a slot may hold another
                # attribute's token (its element then decodes as invalid), never MASK
                legal = no_mask and (exp == "vqdiffusion" or bool(token_mask[pos, toks].all()))
                kept = True
                if cond.seq is not None:
                    known = torch.as_tensor(np.asarray(cond.seq_mask), device=gen.device)
                    given = torch.as_tensor(np.asarray(cond.seq), device=gen.device)
                    kept = bool((toks[known] == given[known]).all())
                finite = all(bool(torch.isfinite(layout.geo(k)).all())
                             for k in ("center_x", "center_y", "width", "height"))
                fails.check(n == want(K1=k1, K10=k10, K11=k11) and legal and kept and finite
                            and tuple(toks.shape) == (ZOO_BATCH, L),
                            f"zoo {exp} {task} request {i}: launches {n} (want K1 {k1}, K10 "
                            f"{k10}, K11 {k11}), tokens "
                            f"legal={legal}, given tokens in place={kept}, layouts finite="
                            f"{finite} ({int(layout.mask.sum())} elements)")
                print(f"  zoo {exp} {task} request {i}: {dt * 1e3:.1f} ms, "
                      f"{ZOO_BATCH / dt:.1f} layouts/s ({card})", flush=True)
                if task == "uncond":
                    outs.append(toks.cpu().numpy().tobytes())
            fails.check(len(set(outs)) == len(outs), f"zoo {exp}: the {len(outs)} uncond "
                                                     "requests give distinct outputs")
            if exp == "layoutdm":
                profile_request(torch, "zoo layoutdm uncond",
                                lambda: request(batches[0], "uncond", 7))
            del gen
            torch.cuda.empty_cache()
        print(f"  zoo serve {time.perf_counter() - t0:.1f} s", flush=True)

        # the entry points: a layoutdm job dir, cli.inference --cond c on the
        # 64-canvas test split in one batch, then cli.evaluate on the card
        job = os.path.join(tmp, "job")
        cfg, gen = zoo_generator("layoutdm", tmp, "cuda",
                                 ("model.dtype=bfloat16", *overrides))
        cfg.save(job)
        save_params_npz(os.path.join(job, "ckpt_final.npz"), *export_params(gen.core))
        k1, k10, k11 = zoo_k1(gen), k10_request(gen), k11_forward(gen)
        del gen
        out_dir = os.path.join(job, "out_c")
        argv = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size",
                str(CLI_BATCH), "--out-dir", out_dir]
        summary, n = counted(lambda: inference.main(argv))
        with open(os.path.join(out_dir, "test_0.pkl"), "rb") as f:
            records = pickle.load(f)["results"]
        with open(os.path.join(out_dir, "test_0_violation.csv")) as f:
            total, violated, rate = list(csv.reader(f))[1]
        fails.check(n == want(K1=k1, K10=k10, K11=k11) and len(records) == CLI_BATCH
                    and float(rate) == 0.0 and int(total) > 0,
                    f"zoo cli.inference layoutdm --cond c: launches {n} (want K1 {k1}, K10 {k10}, "
                    f"K11 {k11}), "
                    f"{len(records)} records, violations {violated}/{total}, "
                    f"{summary['ms_per_sample'][0]:.3f} ms per sample ({card})")
        argv = ["--input-dir", out_dir, "--job-dir", job, "--device", "cuda",
                "--cache-dir", os.path.join(tmp, "eval")]
        with contextlib.redirect_stdout(io.StringIO()):
            scores, n = counted(lambda: evaluate.main(argv))
        bad = [k for k in SCORE_KEYS if not math.isfinite(scores[k]["mean"])
               and k not in NAN_ALLOWED]
        fails.check(n == want(K1=8) and list(scores) == SCORE_KEYS and not bad,
                    f"zoo cli.evaluate on the card: launches {n} (want K1 8), keys "
                    f"{list(scores) == SCORE_KEYS}, not finite: {bad}")
    print(f"  zoo phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def baseline_k1(gen) -> int:
    """K1 launches of one request: the image encoder's layers (CGL-GAN, ICVT;
    DS-GAN's image path has no transformer) and the RA variants' 4 FIDNet
    layers; the retriever none."""
    from ralf_tpu_torch.models.dsgan import DSGANGenerator

    if not hasattr(gen, "core") or isinstance(gen, DSGANGenerator):
        layers = 0
    else:
        layers = gen.cfg.num_encoder_layers
    return layers + (4 if getattr(gen, "with_retrieval", False) else 0)


@contextlib.contextmanager
def k1_head_widths():
    """The head width of each K1 launch made inside the block (the kernel
    launcher wrapped to record E / nhead; the launch counter is untouched)."""
    from ralf_tpu_torch.ops import encoder_attention as ea

    launch, widths = ea._launch_encoder_attention, []

    def recording(q, k, v, nhead, key_bias):
        widths.append(q.shape[-1] // nhead)
        return launch(q, k, v, nhead, key_bias)

    ea._launch_encoder_attention = recording
    try:
        yield widths
    finally:
        ea._launch_encoder_attention = launch


def baseline_check(torch, fails: Failures, tmp: str, overrides=()) -> None:
    """Each of the six presets in fp32, card against CPU on the same weights
    and BASELINE_CHECK canvases (the same numpy seed; RA's neighbours
    retrieved once, on the CPU): the GANs' logits and boxes within 1e-3 and
    their labels at least AGREE equal; ICVT's image memory within 1e-3 and its
    layouts' tokens under one fixed z at least AGREE equal; the retriever's
    layouts exactly."""
    for exp in BASELINE_SERVE:
        built = {d: zoo_generator(exp, tmp, d, ("model.dtype=float32", *overrides))
                 for d in ("cuda", "cpu")}
        gens = {d: g for d, (_, g) in built.items()}
        cfg = built["cpu"][0]
        batch = zoo_batches(gens["cpu"], cfg, 1, BASELINE_CHECK, GALLERY, np.float32)[0]
        if exp == "retriever":
            lay = {d: g.sample(batch).numpy() for d, g in gens.items()}
            same = all(np.array_equal(lay["cuda"][k], lay["cpu"][k]) for k in lay["cpu"])
            fails.check(same, f"baselines check {exp}: top-1 layouts card vs CPU equal={same}")
            continue
        if exp == "icvt":
            d_model = gens["cpu"].cfg.d_model
            z = torch.randn((BASELINE_CHECK, 1, d_model), generator=torch.Generator().manual_seed(0))
            with torch.inference_mode():
                mems = {d: g.core.encode_image(torch.as_tensor(batch["image"], device=g.device))
                        .cpu() for d, g in gens.items()}
            lay = {d: g.sample(batch, np.random.default_rng(0), z=z.to(g.device)).numpy()
                   for d, g in gens.items()}
            tokens = {d: np.stack([lay[d][k] for k in ("label", "center_x", "center_y", "width",
                                                       "height", "mask")]) for d in lay}
            m_err = float((mems["cuda"] - mems["cpu"]).abs().max())
            same = float((tokens["cuda"] == tokens["cpu"]).mean())
            fails.check(m_err < 1e-3 and same >= AGREE,
                        f"baselines check {exp}: image memory {tuple(mems['cpu'].shape)} card vs "
                        f"CPU max_abs_err {m_err:.3e} (tol 1e-3); tokens under one z {same:.4f} "
                        f"equal (least {AGREE})")
            continue
        inputs, _ = gens["cpu"].preprocess(batch, np.random.default_rng(0))
        outs = {d: [t.float().cpu() for t in g._forward(inputs)] for d, g in gens.items()}
        l_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
        b_err = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
        same = float((outs["cuda"][0].argmax(-1) == outs["cpu"][0].argmax(-1)).float().mean())
        fails.check(l_err < 1e-3 and b_err < 1e-3 and same >= AGREE,
                    f"baselines check {exp}: logits {tuple(outs['cpu'][0].shape)} card vs CPU "
                    f"max_abs_err {l_err:.3e}, boxes {b_err:.3e} (tol 1e-3); labels {same:.4f} "
                    f"equal (least {AGREE})")
        del gens, built
        torch.cuda.empty_cache()


def run_baselines(torch, fails: Failures, smi: list, checks, overrides=()) -> dict:
    """CGL-GAN, DS-GAN (each with and without retrieval), ICVT and the
    retriever on the card: the fp32 check against the CPU, bf16 requests of
    BASELINE_BATCH canvases with exact K1 counts (ICVT's all at head width
    25), one profiled request of CGL-GAN and of ICVT, then cli.inference on a
    cglgan, an icvt and a retriever job dir (the last written by cli.train)
    and cli.evaluate on the cglgan pickles on the card; returns the launches
    of each kernel summed over the counted calls.  `overrides` cut the
    models for a rehearsal without a card; the script passes none."""
    from ralf_tpu_torch.cli import evaluate, inference
    from ralf_tpu_torch.cli import train as cli_train
    from ralf_tpu_torch.utils.weights import export_params, save_params_npz

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    with tempfile.TemporaryDirectory() as tmp:
        checks.run("baseline_check", tmp=tmp, overrides=overrides)

        for exp, tasks in BASELINE_SERVE.items():
            cfg, gen = zoo_generator(exp, tmp, "cuda", ("model.dtype=bfloat16", *overrides))
            k1, k10, k11 = baseline_k1(gen), k10_request(gen), k11_forward(gen)
            batches = zoo_batches(gen, cfg, BASELINE_REQUESTS, BASELINE_BATCH, GALLERY)

            def request(batch, task, seed):
                gen.task = task  # the job's auxiliary_task
                torch.cuda.synchronize()
                a = time.perf_counter()
                layout = gen.sample(batch, np.random.default_rng(seed))
                torch.cuda.synchronize()
                return layout, time.perf_counter() - a

            request(batches[0], "uncond", 99)  # warm-up, outside the counted runs
            for i, (task, batch) in enumerate([("uncond", b) for b in batches]
                                              + [(t, batches[0]) for t in tasks]):
                with k1_head_widths() as widths:
                    (layout, dt), n = counted(lambda: request(batch, task, i))
                geo = torch.stack([layout.geo(k).float() for k in
                                   ("center_x", "center_y", "width", "height")])
                legal = bool(((geo >= 0) & (geo <= 1)).all()) and bool(
                    (layout.label[layout.mask] < cfg.dataset.num_labels).all())
                dh_ok = exp != "icvt" or widths == [25] * k1
                fails.check(n == want(K1=k1, K10=k10, K11=k11) and legal and dh_ok
                            and tuple(layout.mask.shape) == (BASELINE_BATCH,
                                                             cfg.dataset.max_seq_length),
                            f"baselines {exp} {task} request {i}: launches {n} (want K1 {k1}, "
                            f"K10 {k10}, K11 {k11}), "
                            f"K1 head widths {sorted(set(widths))}, layouts legal={legal} "
                            f"({int(layout.mask.sum())} elements)")
                print(f"  baselines {exp} {task} request {i}: {dt * 1e3:.1f} ms, "
                      f"{BASELINE_BATCH / dt:.1f} layouts/s ({card})", flush=True)
            if exp in ("cglgan", "icvt"):
                profile_request(torch, f"baselines {exp} uncond",
                                lambda: request(batches[0], "uncond", 7))
            del gen
            torch.cuda.empty_cache()
        print(f"  baselines serve {time.perf_counter() - t0:.1f} s", flush=True)

        # the entry points: cli.inference on the 64-canvas test split in one batch for
        # CLI_SEEDS seeds; the retriever's job dir written by cli.train
        out_dirs = {}
        for exp in BASELINE_CLI:
            job = os.path.join(tmp, f"job_{exp}")
            if exp == "retriever":
                argv = ["--experiment", "retriever", "--synthetic", "--job-dir", job,
                        "--cache-dir", f"{tmp}/cache", *overrides]
                with contextlib.redirect_stdout(io.StringIO()):
                    cli_train.main(argv)
                k1 = k10 = k11 = 0
                fails.check(sorted(os.listdir(job)) == ["config.json"],
                            f"baselines cli.train --experiment retriever writes {os.listdir(job)}")
            else:
                cfg, gen = zoo_generator(exp, tmp, "cuda", ("model.dtype=bfloat16",
                                                                 *overrides))
                cfg.save(job)
                save_params_npz(os.path.join(job, "ckpt_final.npz"), *export_params(gen.core))
                k1, k10, k11 = baseline_k1(gen), k10_request(gen), k11_forward(gen)
                del gen
            out_dirs[exp] = os.path.join(job, "out")
            argv = ["--job-dir", job, "--num-seeds", str(CLI_SEEDS), "--batch-size",
                    str(CLI_BATCH), "--out-dir", out_dirs[exp]]
            with k1_head_widths() as widths:
                summary, n = counted(lambda: inference.main(argv))
            records = []
            for seed in range(CLI_SEEDS):
                with open(os.path.join(out_dirs[exp], f"test_{seed}.pkl"), "rb") as f:
                    records.append(pickle.load(f)["results"])
            coords = [x for rec in records for r in rec for k in ("center_x", "center_y",
                                                                  "width", "height") for x in r[k]]
            legal = all(0.0 <= x <= 1.0 for x in coords) and len(coords) > 0
            dh_ok = exp != "icvt" or set(widths) == {25}
            fails.check(n == want(K1=k1 * CLI_SEEDS, K10=k10 * CLI_SEEDS, K11=k11 * CLI_SEEDS)
                        and legal and dh_ok
                        and [len(r) for r in records] == [CLI_BATCH] * CLI_SEEDS,
                        f"baselines cli.inference {exp}: launches {n} (want K1 "
                        f"{k1 * CLI_SEEDS}, K10 {k10 * CLI_SEEDS}, K11 {k11 * CLI_SEEDS}), "
                        f"records {[len(r) for r in records]}, coordinates "
                        f"in [0, 1]={legal}, " + ", ".join(
                            f"seed {s} {ms:.3f} ms per sample" for s, ms in
                            summary["ms_per_sample"].items()) + f" ({card})")
        argv = ["--input-dir", out_dirs["cglgan"], "--job-dir", os.path.join(tmp, "job_cglgan"),
                "--device", "cuda", "--cache-dir", os.path.join(tmp, "eval")]
        with contextlib.redirect_stdout(io.StringIO()):
            scores, n = counted(lambda: evaluate.main(argv))
        bad = [k for k in SCORE_KEYS if not math.isfinite(scores[k]["mean"])
               and k not in NAN_ALLOWED]
        k1 = 4 * (1 + CLI_SEEDS)  # FIDNet over the ground truth, then each seed's pickle
        fails.check(n == want(K1=k1) and list(scores) == SCORE_KEYS and not bad,
                    f"baselines cli.evaluate cglgan on the card: launches {n} (want K1 {k1}), "
                    f"keys {list(scores) == SCORE_KEYS}, not finite: {bad}")
    print(f"  baselines phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def run_backward_checks(torch, dev, fails: Failures) -> None:
    """K1, K5 and K6 carry gradients through their autograd.Function: the
    kernel's forward (one launch a call), and a backward that recomputes the
    reference JAX's custom_vjp differentiates (ops' `attention_reference`,
    `self_attention_reference`, `ffn_reference`).  At the main shapes in
    bf16 and fp32, the Function's gradients against torch.autograd.grad of
    the plain version on the same inputs, within the forward's tolerance
    taken against the sums each gradient adds up (`plain_gradients`).  K1's
    main case has no mask and K6's key bias is finite: no row is fully masked,
    where the plain version and JAX's reference part ways.  K1 also at
    FIDNet's training shape (64, 11, 256, H=4) with its key mask, the CLS
    column always kept, as every fid_train step takes it."""
    from ralf_tpu_torch.ops import encoder_attention as ea
    from ralf_tpu_torch.ops import encoder_ffn as ef

    g = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    B, S, E, H, Fh = 128, 330, 256, 8, 1024
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        kb = rand(B, H, S)  # K6's per-head key logits, as bq gives them
        cases = (
            ("encoder_attention", [rand(B, S, E, scale=(E // H) ** -0.5), rand(B, S, E),
                                   rand(B, S, E)],
             lambda q, k, v: ea.encoder_attention(q, k, v, H), None),
            ("fused_ffn", [rand(B, S, E), rand(Fh, E, scale=E ** -0.5), rand(Fh),
                           rand(E, Fh, scale=Fh ** -0.5), rand(E)], ef.fused_ffn, None),
            ("encoder_self_attention", [rand(B, S, E), rand(3 * E, E, scale=E ** -0.5)],
             lambda x, w: ea.encoder_self_attention(x, w, H, kb), kb),
        )
        Bf, Sf, Hf = FID_BATCH, 11, 4
        keep = torch.rand(Bf, Sf, generator=g, device=dev) > 0.3
        keep[:, 0] = True  # the CLS token
        fid_bias = torch.where(keep, 0.0, -1e9)
        cases += (("encoder_attention", [rand(Bf, Sf, E, scale=(E // Hf) ** -0.5),
                                         rand(Bf, Sf, E), rand(Bf, Sf, E)],
                   lambda q, k, v: ea.encoder_attention(q, k, v, Hf, fid_bias), fid_bias),)
        for name, raw, function, key_bias in cases:
            ins = [t.to(dtype).requires_grad_() for t in raw]
            count = counters()[KERNELS[name][0]]
            before = count.launches
            out = function(*ins)
            launched = count.launches - before
            gout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
            got = torch.autograd.grad(out, ins, gout)
            heads = Hf if key_bias is fid_bias else H
            want, allow = plain_gradients(torch, name, ins, gout, heads, key_bias)
            ok, worst, used = launched == 1 and out.grad_fn is not None, 0.0, 0.0
            for a, b, tol in zip(got, want, allow):
                err = (a.float() - b.float()).abs()
                ok &= bool(torch.isfinite(a.float()).all()) and bool((err <= tol).all())
                worst = max(worst, float(err.max()))
                used = max(used, float((err / tol).max()))
            torch.cuda.synchronize()
            shape = "FIDNet's (64, 11, 256, H=4, key mask)" if key_bias is fid_bias else "the main"
            fails.check(ok, f"backward {name} {dn} at {shape} shape: {launched} kernel launch in "
                            f"the forward; gradients of {len(ins)} inputs against the plain "
                            f"version's max_abs_err {worst:.3e}, at most {used:.3f} of the "
                            f"allowance (forward tol {TOL[dn]} against the sums)")
            del ins, out, got, want, allow


def train_step_check(torch, tok, fails: Failures, tmp: str, model: dict,
                     dtype: str = "float32") -> None:
    """One train step of RALF (`model`'s fields over the full width; dropout
    0, batch 4) on the card and on the CPU from the same seeded weights and
    the same batch, in fp32 or in bf16 (fp32 parameters, autocast on both
    devices), with every Linear's and Conv2d's output in the dtype on both.
    At bf16 the subtrees' gradients go to `compare_step` too, and the same
    step runs in fp32 on the card from the same weights, whose loss against
    the CPU's bf16 one is printed: what a card step that did not run in
    bf16 would show."""
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
    from ralf_tpu_torch.utils.weights import export_params, load_jax_params

    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=64, seed=0)
    loader = RetrievalAugmentedLoader(BatchLoader(ds, 4, shuffle=False),
                                      Retriever.build(ds, device="cpu"), 16, is_train_split=True)
    batch = next(iter(loader))  # one host batch, fed to each run
    out, grads = {}, {}
    runs = [("cuda", dtype), ("cpu", dtype)] + ([("cuda", "float32")] if dtype != "float32" else [])
    for d, dt in runs:
        cfg = GeneratorConfig(**{**model, "dtype": getattr(torch, dt), "dropout": 0.0})
        gen = RALFGenerator(tok, cfg, "uncond", device=d, seed=0)
        trainer = Trainer(gen, TrainConfig(job_dir=os.path.join(tmp, f"step_{d}_{dt}")))
        if dt != dtype:  # the bf16 runs' weights (their seeded ones, rounded to bf16)
            load_jax_params(gen.core, *out["cuda"][1])
        before = export_params(gen.core)
        state = trainer.init_state()
        inputs, targets = gen.preprocess(batch, np.random.default_rng(0))
        seen, hooks = {}, []
        for m in gen.core.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                hooks.append(m.register_forward_hook(
                    lambda mod, args, y, kind=type(m).__name__:
                    seen.setdefault(kind, set()).add(str(y.dtype).split(".")[1])))
        try:
            loss = float(trainer.train_step(state, inputs, targets)["loss"])
        finally:
            for h in hooks:
                h.remove()
        fails.check(seen == {"Linear": {dt}, "Conv2d": {dt}},
                    f"train step {dt} on {d}: Linear and Conv2d outputs {seen} (want {dt})")
        if dt == dtype:
            out[d] = (loss, before, export_params(gen.core))
            by_key: dict = {}
            for n, prm in gen.core.named_parameters():
                if prm.grad is not None:  # not the frozen layout_encoder's
                    by_key.setdefault(n.split(".")[0], []).append(prm.grad.float().cpu().ravel())
            grads[d] = {k: torch.cat(v).numpy() for k, v in by_key.items()}
        else:
            lp = out["cpu"][0]
            print(f"  train step {dtype}: the same step in {dt} on the card, loss {loss:.7f} vs "
                  f"the CPU's {dtype} {lp:.7f}, relative {abs(loss - lp) / abs(lp):.2e} "
                  f"(the {dtype} step's tolerance {STEP_TOL[dtype][0]})", flush=True)
        del gen, trainer, state
    compare_step(fails, f"train step {dtype}", out, dtype,
                 grads if dtype == "bfloat16" else None)


def _flat(tree):
    """A subtree's leaves (or a leaf such as flag_emb) as one vector, in path order."""
    if not isinstance(tree, dict):
        return np.ravel(tree)
    return np.concatenate([np.ravel(a) for _, a in sorted(_leaves(tree))])


# one step card vs CPU: (loss rtol, least cosine of a subtree's update -- at bf16 a
# small subtree's gradient --, its norm ratio's range); bf16's loss rtol sits above its
# card-vs-CPU readings (1.2e-5 to 5.4e-5 at the full width on an H100, PERF.md), its
# cosine and ratio are tests/test_torch_port_bf16_train.py's limits against JAX; that the
# steps ran in bf16 is `train_step_check`'s dtype hooks' to show
STEP_TOL = {"float32": (1e-4, 0.99, (0.97, 1.03)), "bfloat16": (1e-3, 0.95, (0.9, 1.1))}
FEW = 64  # a subtree of fewer elements is held by its gradient at bf16 (`compare_step`)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(a @ b / max(float(np.linalg.norm(a)) * float(np.linalg.norm(b)), 1e-30))


def compare_step(fails: Failures, label: str, out: dict, dtype: str = "float32",
                 grads: dict | None = None, sides: str = "card vs CPU") -> None:
    """One train step on the card against the CPU from the same weights and
    batch, out = {device: (loss, params before, (params, batch_stats) after)}:
    the loss and each top-level subtree's update within STEP_TOL[dtype]
    (fp32: the loss within 1e-4 relative, cosine > 0.99 and norm ratio
    0.97-1.03); every leaf under a `layout_encoder` (frozen by name: FIDNet,
    ICVT's GT-layout embedding) unmoved on both; BatchNorm's running
    statistics within 1e-6 + 1e-4*|CPU| (bf16: their change by cosine >
    0.99 and norm ratio 0.97-1.03, as the CPU test holds them to JAX's).
    With `grads` ({device: {subtree: its gradient as one vector}}, bf16)
    both are printed, and a subtree of fewer than FEW elements is held by its
    gradient: AdamW's first step moves each element by about lr whatever its
    gradient's size, so an element whose gradient sits at bf16's rounding
    noise steps either way, which a few elements' update cosine cannot
    average out (RALF's 2-element flag_emb).  A larger subtree is held by
    its update: its gradient's norm is dominated by a few elements whose
    bf16 sums differ by device (ResNet50's, through train-mode BatchNorm)."""
    (lc, before, (pc, sc)), (lp, _, (pp, sp)) = out["cuda"], out["cpu"]
    loss_rtol, cos_min, (lo, hi) = STEP_TOL[dtype]
    rel = abs(lc - lp) / abs(lp)
    fails.check(rel <= loss_rtol, f"{label} {sides}: loss {lc:.7f} vs {lp:.7f}, relative "
                                  f"{rel:.2e} (tol {loss_rtol})")
    start, ends = dict(_leaves(before[0])), (dict(_leaves(pc)), dict(_leaves(pp)))
    frozen = sorted(k for k in start if "/layout_encoder/" in f"/{k}")
    if frozen:
        moved = [k for k in frozen for end in ends if not np.array_equal(end[k], start[k])]
        fails.check(not moved, f"{label}: the frozen layout_encoder ({len(frozen)} leaves) did "
                               f"not move, card or CPU (moved: {moved[:3]})")
    for key in sorted(before[0]):
        if key == "layout_encoder":
            continue
        d_c, d_p = _flat(pc[key]) - _flat(before[0][key]), _flat(pp[key]) - _flat(before[0][key])
        what, note = "update", ""
        if grads is not None:
            g_c, g_p = grads["cuda"][key], grads["cpu"][key]
            other = "gradient"
            if g_c.size < FEW:
                what, other, d_c, d_p, g_c, g_p = "gradient", "update", g_c, g_p, d_c, d_p
            note = (f"; {other} cosine {_cosine(g_c, g_p):.5f}, norm ratio "
                    f"{np.linalg.norm(g_c) / max(float(np.linalg.norm(g_p)), 1e-30):.5f} (not held)")
        norm_p = float(np.linalg.norm(d_p))
        cos, ratio = _cosine(d_c, d_p), float(np.linalg.norm(d_c)) / max(norm_p, 1e-30)
        fails.check(cos >= cos_min and lo < ratio < hi,
                    f"{label} {sides}, {what} of {key}: cosine {cos:.5f} (>= {cos_min}), "
                    f"norm ratio {ratio:.5f} ({lo}-{hi}), CPU norm {norm_p:.3e}{note}")
    if not sp:  # no BatchNorm (FIDNet)
        return
    if dtype == "bfloat16":
        d_c, d_p = _flat(sc) - _flat(before[1]), _flat(sp) - _flat(before[1])
        cos = float(d_c @ d_p / (np.linalg.norm(d_c) * np.linalg.norm(d_p)))
        ratio = float(np.linalg.norm(d_c) / np.linalg.norm(d_p))
        fails.check(cos > 0.99 and 0.97 < ratio < 1.03,
                    f"{label} {sides}: BatchNorm statistics' change, cosine {cos:.6f} "
                    f"(> 0.99), norm ratio {ratio:.5f} (0.97-1.03)")
        return
    worst = max(float((np.abs(_flat(sc[k]) - _flat(sp[k])) /
                       (1e-6 + 1e-4 * np.abs(_flat(sp[k])))).max()) for k in sp)
    fails.check(worst <= 1.0, f"{label} {sides}: BatchNorm running statistics within "
                              f"1e-6 + 1e-4*|CPU| (worst element uses {worst:.3f} of it)")


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def run_fit(torch, fails: Failures, counted: LaunchCounter, label: str, gen, cfg, loaders,
            val_size: int, k1_step: int, k1_eval: int, card: str, k10_eval: int = 0,
            k11_eval: int = 0):
    """Trainer.fit of `gen` (cfg.train: one epoch, a step checkpoint every
    TRAIN_STEPS) for TRAIN_STEPS steps over `loaders()`, then as many more
    resumed from its step checkpoint, each train step and validation batch
    timed and its launches read: exactly k1_step K1 launches a step and
    k1_eval K1, k10_eval K10 and k11_eval K11 a validation batch (none in a
    train step), finite losses, the resume's steps and meta;
    it prints ms per step, samples/s, ms between step starts, validation ms
    a batch and peak memory, then profiles one more step.  Returns (the
    trainer, its state, {"ms", "samples_per_s", "peak_gib"} and the
    profile's figures)."""
    from ralf_tpu_torch.train.trainer import Trainer

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    job = cfg.train.job_dir
    trainer = Trainer(gen, cfg.train)
    records = {"train": [], "eval": []}
    count = counters()

    def instrumented(kind, inner):
        def step(state, inputs, targets):
            n0 = {k: c.launches for k, c in count.items()}
            torch.cuda.synchronize()
            a = time.perf_counter()
            m = inner(state, inputs, targets)
            loss = float(m["loss"])  # waits for the step
            b = time.perf_counter()
            records[kind].append({"step": state.step, "loss": loss, "s": b - a, "start": a,
                                  "n": {k: c.launches - n0[k] for k, c in count.items()}})
            return m
        return step

    inner_train = trainer.train_step
    trainer.train_step = instrumented("train", inner_train)
    trainer.eval_step = instrumented("eval", trainer.eval_step)
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    _, n1 = counted(lambda: trainer.fit(*loaders(), num_steps_cap=TRAIN_STEPS))
    t_fit1 = time.perf_counter() - t_fit
    first = len(records["train"])
    state, n2 = counted(lambda: trainer.fit(*loaders(), num_steps_cap=2 * TRAIN_STEPS,
                                            resume=True))
    t_fit2 = time.perf_counter() - t_fit - t_fit1
    peak = torch.cuda.max_memory_allocated()
    steps, evals = records["train"], records["eval"]
    # validation batches a call: the split's, under each call's num_steps_cap
    n_val = [min(val_size // TRAIN_BATCH, cap) for cap in (TRAIN_STEPS, 2 * TRAIN_STEPS)]
    fails.check(all(r["n"] == want(K1=k1_step) for r in steps) and len(steps) == 2 * TRAIN_STEPS,
                f"{label}: {len(steps)} train steps, launches per step "
                f"{sorted({str(r['n']) for r in steps})} (want K1 {k1_step})")
    fails.check(all(r["n"] == want(K1=k1_eval, K10=k10_eval, K11=k11_eval) for r in evals)
                and len(evals) == sum(n_val),
                f"{label}: {len(evals)} validation batches ({n_val} in the two calls), launches "
                f"per batch {sorted({str(r['n']) for r in evals})} (want K1 {k1_eval}, K10 "
                f"{k10_eval}, K11 {k11_eval})")
    fails.check([n1, n2] == [want(K1=k1_step * TRAIN_STEPS + k1_eval * v, K10=k10_eval * v,
                                  K11=k11_eval * v) for v in n_val],
                f"{label}: launches a call {n1}, {n2} (want {k1_step} x {TRAIN_STEPS} steps + "
                f"K1 {k1_eval}, K10 {k10_eval} and K11 {k11_eval} x {n_val} validation batches)")
    losses = [r["loss"] for r in steps + evals]
    fails.check(all(math.isfinite(x) for x in losses),
                f"{label}: every loss finite ({', '.join(f'{x:.4f}' for x in losses)})")
    with open(os.path.join(job, "ckpt_step_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(job, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    resumed = [r["step"] for r in steps]
    fails.check(resumed == list(range(1, 2 * TRAIN_STEPS + 1)) and first == TRAIN_STEPS
                and state.step == 2 * TRAIN_STEPS
                and meta == {"epoch": 1, "step_in_epoch": 2 * TRAIN_STEPS,
                             "global_step": 2 * TRAIN_STEPS}
                and len(recs) == 2 and all(math.isfinite(r["val_loss"]) for r in recs),
                f"{label} resume: the first call ends at step {steps[first - 1]['step']}, the "
                f"resumed one takes steps {resumed[first:]} (global step {state.step}); "
                f"ckpt_step_meta.json {meta}; metrics.jsonl {recs}")
    timed = [r["s"] for r in steps[1:first] + steps[first + 1:]]  # steps 2-4 and 6-8
    ms = 1e3 * statistics.median(timed)
    loop = [b["start"] - a["start"] for a, b in zip(steps, steps[1:]) if b["step"] != first + 1]
    loop_ms = 1e3 * statistics.median(loop[1:])
    print(f"  {label}: {ms:.2f} ms per train step (median of steps 2-4 and 6-8: "
          f"{', '.join(f'{1e3 * x:.2f}' for x in timed)}), {TRAIN_BATCH / ms * 1e3:.1f} "
          f"samples/s; {loop_ms:.2f} ms between step starts (loader, retrieval gather and "
          f"preprocess included), {TRAIN_BATCH / loop_ms * 1e3:.1f} samples/s; "
          f"validation {1e3 * statistics.median(r['s'] for r in evals):.2f} ms a batch; "
          f"peak memory {peak / 2**30:.2f} GiB; calls {t_fit1:.1f} s and {t_fit2:.1f} s; "
          f"{dtype_name(torch, gen.cfg.dtype)}, batch {TRAIN_BATCH}, {card}", flush=True)
    batch = next(iter(loaders()[0]))
    inputs, targets = gen.preprocess(batch, np.random.default_rng(0))
    prof = profile_request(torch, f"{label} train step", lambda: inner_train(state, inputs, targets))
    figures = {"ms": ms, "samples_per_s": TRAIN_BATCH / ms * 1e3, "peak_gib": peak / 2**30}
    return trainer, state, {**figures, **prof}


def dtype_name(torch, dtype) -> str:
    return str(dtype or torch.float32).split(".")[1]


def run_train(torch, tok, fails: Failures, smi: list, checks, overrides=()) -> dict:
    """Training on the card: the one-step check against the CPU, Trainer.fit
    at the ralf preset's size and its resume, then cli.train -> cli.inference;
    returns the launches of each kernel summed over the counted calls.
    `overrides` (dotted config keys, `model.*` among them) cut the model
    for a rehearsal without a card; the script passes none."""
    from ralf_tpu_torch.cli import inference
    from ralf_tpu_torch.cli import train as cli_train
    from ralf_tpu_torch.config import build_config, build_datasets, build_generator, build_tokenizer
    from ralf_tpu_torch.data.dataset import BatchLoader
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    with tempfile.TemporaryDirectory() as tmp:
        checks.run("train_step_check", tok=tok, tmp=tmp,
                   model=build_config("ralf", list(overrides)).model)

        # Trainer.fit at the ralf preset's size: full width, fp32, batch 32,
        # dropout 0.1, the non-debug synthetic splits, retrieval in the train split
        job = os.path.join(tmp, "fit")
        cfg = build_config("ralf", ["synthetic_data=true", f"cache_dir={tmp}/cache",
                                    f"train.job_dir={job}", "train.epochs=1",
                                    f"train.save_every_steps={TRAIN_STEPS}", *overrides])
        gen = build_generator(cfg, build_tokenizer(cfg), device="cuda")
        train_ds, val_ds, _ = build_datasets(cfg)
        retriever = Retriever.build(train_ds, cache_dir=cfg.cache_dir,
                                    dataset_name=cfg.dataset.name, device="cuda")
        top_k = gen.top_k
        tables = {"train": retriever.precompute_table(train_ds, top_k, is_train_split=True),
                  "val": retriever.precompute_table(val_ds, top_k, is_train_split=False)}

        def loaders():
            tl = BatchLoader(train_ds, TRAIN_BATCH, transforms=cfg.transforms, seed=cfg.train.seed)
            vl = BatchLoader(val_ds, TRAIN_BATCH, shuffle=False, transforms=cfg.transforms,
                             seed=cfg.train.seed)
            return (RetrievalAugmentedLoader(tl, retriever, top_k, table=tables["train"]),
                    RetrievalAugmentedLoader(vl, retriever, top_k, table=tables["val"]))

        print(f"  fit set-up (config, model, splits {len(train_ds)}/{len(val_ds)}, retrieval "
              f"tables) {time.perf_counter() - t0:.1f} s", flush=True)
        # K1: FIDNet's 4 layers over the B*K = 512 retrieved layouts a step, and in
        # eval mode the 6 + 6 encoder self-attentions too
        trainer, state, FIT_FIGURES["fp32"] = run_fit(
            torch, fails, counted, "fit", gen, cfg, loaders, len(val_ds), 4, 4 + 6 + 6, card,
            RALF_K10_EVAL, K11_R50)
        del trainer, state, gen
        torch.cuda.empty_cache()

        # the entry points: cli.train --debug at full width on the card, then
        # cli.inference on its ckpt_final.npz in the job's dtype (fp32)
        job = os.path.join(tmp, "cli")
        argv = ["--experiment", "ralf", "--synthetic", "--debug", "--batch-size",
                str(TRAIN_CLI_BATCH), "--job-dir", job, "--cache-dir", os.path.join(tmp, "cli_cache"),
                *overrides]
        t_call = time.perf_counter()
        _, n = counted(lambda: cli_train.main(argv))
        t_call = time.perf_counter() - t_call
        files = [f for f in ("config.json", "metrics.jsonl", "ckpt_final.npz", "ckpt_final_opt.pt",
                             "ckpt_best.npz") if os.path.exists(os.path.join(job, f))]
        # 2 steps, 2 validation batches
        expect = want(K1=2 * 4 + 2 * 16, K10=2 * RALF_K10_EVAL, K11=2 * K11_R50)
        fails.check(n == expect and len(files) == 5,
                    f"cli.train --debug: launches {n} (want {expect}); wrote {files}; {t_call:.1f} s")
        out_dir = os.path.join(job, "out_c")
        argv = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size", "16",
                "--out-dir", out_dir]
        summary, n = counted(lambda: inference.main(argv))
        L = tok.max_token_length
        expect = want(K1=4 + 12, K2=6 * L, K11=K11_R50)  # FIDNet's gallery table; one batch of 16
        with open(os.path.join(out_dir, "test_0.pkl"), "rb") as f:
            records_c = pickle.load(f)["results"]
        with open(os.path.join(out_dir, "test_0_violation.csv")) as f:
            total, violated, rate = list(csv.reader(f))[1]
        coords = [v for r in records_c for k in ("center_x", "center_y", "width", "height")
                  for v in r[k]]
        fails.check(n == expect and len(records_c) == 16 and all(0 <= v <= 1 for v in coords)
                    and float(rate) == 0.0 and int(total) > 0,
                    f"cli.inference on the trained checkpoint (fp32, --cond c): launches {n} "
                    f"(want {expect}), {len(records_c)} records, violations {violated}/{total}, "
                    f"{summary['ms_per_sample'][0]:.3f} ms per sample")
    print(f"  train phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


@contextlib.contextmanager
def cpu_draws():
    """The zoo's training draws (MaskGIT's mask, the diffusion's Gumbel
    uniforms, ICVT's eps) made by a CPU generator whatever the model's
    device, then moved there: a CUDA generator draws other numbers from one
    seed, and the one-step check gives the card and the CPU the same draws."""
    from ralf_tpu_torch.models import diffusion, icvt, maskgit

    saved = maskgit.draw_loss_mask, diffusion.gumbel_uniforms, icvt.seeded_normal
    maskgit.draw_loss_mask = lambda ratio, T, seed: saved[0](ratio.cpu(), T, seed).to(ratio.device)
    diffusion.gumbel_uniforms = lambda shape, seed, device: saved[1](shape, seed, "cpu").to(device)
    icvt.seeded_normal = lambda shape, seed, device: saved[2](shape, seed, "cpu").to(device)
    try:
        yield
    finally:
        maskgit.draw_loss_mask, diffusion.gumbel_uniforms, icvt.seeded_normal = saved


def zoo_step_check(torch, fails: Failures, tmp: str, preset: str, overrides=()) -> None:
    """One train step of a zoo preset at full width in fp32 (dropout 0,
    ZOO_STEP_BATCH canvases) on the card and on the CPU, from the same seeded
    weights, the same host batch and the same draws (`cpu_draws`)."""
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
    from ralf_tpu_torch.utils.weights import export_params

    over = ("model.dtype=float32", "model.dropout=0.0", *overrides)
    built = {d: zoo_generator(preset, tmp, d, over) for d in ("cuda", "cpu")}
    cfg, cpu_gen = built["cpu"]
    batch = zoo_batches(cpu_gen, cfg, 1, ZOO_STEP_BATCH, GALLERY, np.float32)[0]
    out = {}
    with cpu_draws():
        for d, (_, gen) in built.items():
            before = export_params(gen.core)
            trainer = Trainer(gen, TrainConfig(job_dir=os.path.join(tmp, f"step_{preset}_{d}")))
            state = trainer.init_state()
            inputs, targets = gen.preprocess(batch, np.random.default_rng(0))
            loss = float(trainer.train_step(state, inputs, targets)["loss"])
            out[d] = (loss, before, export_params(gen.core))
    compare_step(fails, f"zoo_train {preset} step", out)


def run_zoo_train(torch, fails: Failures, smi: list, checks, overrides=()) -> dict:
    """Training MaskGIT, LayoutDM, VQDiffusion, RA-LayoutDM and ICVT on the
    card: per preset the one-step check against the CPU, Trainer.fit at the
    preset's training size and its resume (ZOO_TRAIN_FIT's presets), then
    cli.train --debug -> cli.inference; returns the launches of each kernel
    summed over the counted calls.  `overrides` cut the models for a rehearsal without a
    card; the script passes none."""
    from ralf_tpu_torch.cli import inference
    from ralf_tpu_torch.cli import train as cli_train
    from ralf_tpu_torch.config import build_config, build_datasets
    from ralf_tpu_torch.data.dataset import BatchLoader
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    for preset, (k1_step, k1_eval, k1_infer) in ZOO_TRAIN.items():
        k10_eval, k10_infer = ZOO_TRAIN_K10[preset]
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            checks.run("zoo_step_check", tmp=tmp, preset=preset, overrides=overrides)
            if preset in ZOO_TRAIN_FIT:
                # Trainer.fit at the preset's training size: full width, fp32, batch
                # 32, dropout 0.1, the non-debug synthetic splits (RA-LayoutDM's
                # neighbours from the train split)
                job = os.path.join(tmp, "fit")
                cfg, gen = zoo_generator(preset, tmp, "cuda", (
                    f"train.job_dir={job}", "train.epochs=1",
                    f"train.save_every_steps={TRAIN_STEPS}", *overrides))
                train_ds, val_ds, _ = build_datasets(cfg)
                tables, retriever = {}, None
                if getattr(gen, "with_retrieval", False):
                    retriever = Retriever.build(train_ds, device="cuda")
                    tables = {
                        "train": retriever.precompute_table(train_ds, gen.top_k,
                                                            is_train_split=True),
                        "val": retriever.precompute_table(val_ds, gen.top_k,
                                                          is_train_split=False)}

                def loaders():
                    kw = dict(transforms=cfg.transforms, seed=cfg.train.seed)
                    tl = BatchLoader(train_ds, TRAIN_BATCH, **kw)
                    vl = BatchLoader(val_ds, TRAIN_BATCH, shuffle=False, **kw)
                    if retriever is None:
                        return tl, vl
                    return (RetrievalAugmentedLoader(tl, retriever, gen.top_k,
                                                     table=tables["train"]),
                            RetrievalAugmentedLoader(vl, retriever, gen.top_k,
                                                     table=tables["val"]))

                trainer, state, _ = run_fit(torch, fails, counted, f"zoo_train {preset} fit",
                                            gen, cfg, loaders, len(val_ds), k1_step, k1_eval,
                                            card, k10_eval, K11_R50)
                del trainer, state, gen
                torch.cuda.empty_cache()
            t_fit = time.perf_counter() - t

            # the entry points: cli.train --debug on the card, then cli.inference on
            # its ckpt_final.npz (--cond c; icvt serves uncond only), one batch of 16
            cache = os.path.join(tmp, "cli_cache")
            write_vocabulary(build_config(preset, ["synthetic_data=true", "debug=true",
                                                   f"cache_dir={cache}", *overrides]))
            job = os.path.join(tmp, "cli")
            argv = ["--experiment", preset, "--synthetic", "--debug", "--batch-size",
                    str(TRAIN_CLI_BATCH), "--job-dir", job, "--cache-dir", cache, *overrides]
            _, n = counted(lambda: cli_train.main(argv))
            files = [f for f in ("config.json", "metrics.jsonl", "ckpt_final.npz",
                                 "ckpt_final_opt.pt", "ckpt_best.npz")
                     if os.path.exists(os.path.join(job, f))]
            # 2 steps, 2 validation batches of 8
            expect = want(K1=2 * k1_step + 2 * k1_eval, K10=2 * k10_eval, K11=2 * K11_R50)
            fails.check(n == expect and len(files) == 5,
                        f"zoo_train {preset} cli.train --debug: launches {n} (want {expect}); "
                        f"wrote {files}")
            cond = "uncond" if preset == "icvt" else "c"
            out_dir = os.path.join(job, f"out_{cond}")
            argv = ["--job-dir", job, "--cond", cond, "--num-seeds", "1", "--batch-size", "16",
                    "--out-dir", out_dir]
            summary, n = counted(lambda: inference.main(argv))
            with open(os.path.join(out_dir, "test_0.pkl"), "rb") as f:
                records = pickle.load(f)["results"]
            coords = [v for r in records for k in ("center_x", "center_y", "width", "height")
                      for v in r[k]]
            violations = "not checked (uncond)"
            clean = True
            if cond == "c":
                with open(os.path.join(out_dir, "test_0_violation.csv")) as f:
                    total, violated, rate = list(csv.reader(f))[1]
                clean = float(rate) == 0.0 and int(total) > 0
                violations = f"{violated}/{total}"
            # VQDiffusion replaces over the whole vocabulary: two steps' weights may
            # leave no whole element (the zoo phase's note), so it may decode none
            decoded = bool(coords) or preset == "vqdiffusion"
            fails.check(n == want(K1=k1_infer, K10=k10_infer, K11=K11_R50) and len(records) == 16
                        and clean and decoded and all(0 <= v <= 1 for v in coords),
                        f"zoo_train {preset} cli.inference on the trained checkpoint (fp32, "
                        f"--cond {cond}): launches {n} (want K1 {k1_infer}, K10 {k10_infer}, "
                        f"K11 {K11_R50}), "
                        f"{len(records)} "
                        f"records, {len(coords) // 4} elements with coordinates in [0, 1], "
                        f"violations {violations}, {summary['ms_per_sample'][0]:.3f} ms per "
                        f"sample")
        torch.cuda.empty_cache()
        print(f"  zoo_train {preset} {time.perf_counter() - t:.1f} s (fit {t_fit:.1f} s)",
              flush=True)
    print(f"  zoo_train phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def gan_step_check(torch, fails: Failures, tmp: str, preset: str, overrides=()) -> None:
    """One GAN step (the generator step, then the discriminator step) of a
    GAN preset at full width in fp32 (dropout 0, adv_weight 1,
    GAN_STEP_BATCH canvases) on the card and on the CPU, from the same seeded
    weights of both nets and the same host batch: both losses, each
    subtree's update of both nets, the frozen layout_encoder leaves,
    BatchNorm's statistics (the discriminator's of its real pass), and the
    assignment by the target it gives each query, exactly (the padded
    no-object slots are equal targets whose tied columns costs an ulp apart
    may order otherwise)."""
    from ralf_tpu_torch.train.gan_trainer import GANTrainer
    from ralf_tpu_torch.train.trainer import TrainConfig
    from ralf_tpu_torch.utils.weights import export_params

    over = ("model.dtype=float32", "model.dropout=0.0", *overrides)
    built = {d: zoo_generator(preset, tmp, d, over) for d in ("cuda", "cpu")}
    cfg, cpu_gen = built["cpu"]
    batch = zoo_batches(cpu_gen, cfg, 1, GAN_STEP_BATCH, GALLERY, np.float32)[0]
    out = {}
    for d, (_, gen) in built.items():
        gen.init_disc()
        before = export_params(gen.core), export_params(gen.disc)
        trainer = GANTrainer(gen, TrainConfig(job_dir=os.path.join(tmp, f"gan_step_{preset}_{d}")))
        state, dis = trainer.init_states()
        gen.adv_weight = 1.0
        inputs, targets = gen.device_batch(*gen.preprocess(batch, np.random.default_rng(0)))
        gm = trainer.gen_step(state, dis, inputs, targets)
        dm = trainer.dis_step(dis, state, inputs, targets)
        packed = targets["packed"].cpu()
        rows = torch.arange(packed.shape[0])[:, None]
        out[d] = {"g": float(gm["loss"]), "d": float(dm["loss_d"]), "before": before,
                  "match": gm["match"].cpu(), "matched": packed[rows, gm["match"].cpu().long()],
                  "after": (export_params(gen.core), export_params(gen.disc))}
        del trainer, state, dis, gen
    compare_step(fails, f"gan_train {preset} generator step",
                 {d: (o["g"], o["before"][0], o["after"][0]) for d, o in out.items()})
    compare_step(fails, f"gan_train {preset} discriminator step",
                 {d: (o["d"], o["before"][1], o["after"][1]) for d, o in out.items()})
    same = torch.equal(out["cuda"]["matched"], out["cpu"]["matched"])
    same_idx = torch.equal(out["cuda"]["match"], out["cpu"]["match"])
    fails.check(same, f"gan_train {preset} assignment card vs CPU: the matched targets equal="
                      f"{same} (indices equal={same_idx})")
    del built
    torch.cuda.empty_cache()


def run_gan_fit(torch, fails: Failures, counted: LaunchCounter, preset: str, tmp: str,
                k1_gen: int, k1_dis: int, card: str, overrides=()) -> None:
    """GANTrainer.fit_gan of a preset at its training size (full width, fp32
    or `overrides`' dtype, TRAIN_BATCH, dropout 0.1, the non-debug synthetic train split, the RA
    variants' neighbours from it) for TRAIN_STEPS GAN steps with adv_weight
    forced to 1 (the first epoch's ramp gives 0), each generator and
    discriminator step timed and its launches read: exactly k1_gen K1
    launches and one batched_lsa a generator step, k1_dis K1 and
    GAN_TRAIN_K10's K10 and the generator's K11 a discriminator step, finite losses; it prints ms per GAN step (and each
    step apart), samples/s, peak memory, then profiles one more GAN step."""
    from ralf_tpu_torch.config import build_datasets
    from ralf_tpu_torch.data.dataset import BatchLoader
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.train.gan_trainer import GANTrainer

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    k10_dis = GAN_TRAIN_K10[preset]
    cfg, gen = zoo_generator(preset, tmp, "cuda", (f"train.job_dir={tmp}/fit_{preset}",
                                                    "train.epochs=1", *overrides))
    label = f"{'bf16_train' if gen.cfg.dtype == torch.bfloat16 else 'gan_train'} {preset} fit"
    k11_dis = k11_forward(gen)  # the generator's prediction in eval mode under no_grad
    train_ds = build_datasets(cfg)[0]
    loader = BatchLoader(train_ds, TRAIN_BATCH, transforms=cfg.transforms, seed=cfg.train.seed)
    if gen.with_retrieval:
        retriever = Retriever.build(train_ds, device="cuda")
        table = retriever.precompute_table(train_ds, gen.top_k, is_train_split=True)
        loader = RetrievalAugmentedLoader(loader, retriever, gen.top_k, table=table)
    gen.update_per_epoch = lambda *_: setattr(gen, "adv_weight", 1.0)
    trainer = GANTrainer(gen, cfg.train)
    records = {"gen": [], "dis": []}
    count = counters()

    def instrumented(kind, inner, key):
        def step(*args):
            n0 = {k: c.launches for k, c in count.items()}
            torch.cuda.synchronize()
            a = time.perf_counter()
            loss = float(inner(*args)[key])  # waits for the step
            b = time.perf_counter()
            records[kind].append({"loss": loss, "s": b - a,
                                  "n": {k: c.launches - n0[k] for k, c in count.items()}})
            return {key: torch.tensor(loss)}
        return step

    inner_gen, inner_dis = trainer.gen_step, trainer.dis_step
    trainer.gen_step = instrumented("gen", inner_gen, "loss")
    trainer.dis_step = instrumented("dis", inner_dis, "loss_d")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    (state, dis), n = counted(lambda: trainer.fit_gan(loader, num_steps_cap=TRAIN_STEPS))
    t = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    gens, diss = records["gen"], records["dis"]
    fails.check(len(gens) == len(diss) == TRAIN_STEPS
                and all(r["n"] == want(K1=k1_gen, LSA=1) for r in gens)
                and all(r["n"] == want(K1=k1_dis, K10=k10_dis, K11=k11_dis) for r in diss)
                and n == want(K1=(k1_gen + k1_dis) * TRAIN_STEPS, LSA=TRAIN_STEPS,
                              K10=k10_dis * TRAIN_STEPS, K11=k11_dis * TRAIN_STEPS),
                f"{label}: {len(gens)} GAN steps, launches per generator step "
                f"{sorted({str(r['n']) for r in gens})} (want K1 {k1_gen}, LSA 1), per "
                f"discriminator step {sorted({str(r['n']) for r in diss})} (want K1 {k1_dis}, "
                f"K10 {k10_dis}, K11 {k11_dis}); "
                f"a call {n}")
    losses = [r["loss"] for r in gens + diss]
    with open(os.path.join(cfg.train.job_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    fails.check(all(math.isfinite(x) for x in losses) and len(recs) == 1
                and gen.adv_weight == 1.0,
                f"{label}: every loss finite ({', '.join(f'{x:.4f}' for x in losses)}); "
                f"metrics.jsonl {recs}")
    g_ms = [1e3 * r["s"] for r in gens[1:]]  # steps 2-4
    d_ms = [1e3 * r["s"] for r in diss[1:]]
    ms = statistics.median(a + b for a, b in zip(g_ms, d_ms))
    print(f"  {label}: {ms:.2f} ms per GAN step (median of steps 2-4), generator step "
          f"{statistics.median(g_ms):.2f} ms ({', '.join(f'{x:.2f}' for x in g_ms)}), "
          f"discriminator step {statistics.median(d_ms):.2f} ms "
          f"({', '.join(f'{x:.2f}' for x in d_ms)}), {TRAIN_BATCH / ms * 1e3:.1f} samples/s; "
          f"peak memory {peak / 2**30:.2f} GiB; fit_gan call {t:.1f} s; "
          f"{dtype_name(torch, gen.cfg.dtype)}, batch {TRAIN_BATCH}, {card}", flush=True)
    batch = next(iter(loader))
    inputs, targets = gen.device_batch(*gen.preprocess(batch, np.random.default_rng(0)))

    def gan_step():
        inner_gen(state, dis, inputs, targets)
        inner_dis(dis, state, inputs, targets)

    profile_request(torch, f"{label} GAN step", gan_step)
    del trainer, state, dis, gen


def run_gan_train(torch, fails: Failures, smi: list, checks, overrides=()) -> dict:
    """Training CGL-GAN, DS-GAN and their RA variants on the card: per preset
    the one-step check against the CPU, GANTrainer.fit_gan at the training
    size (GAN_TRAIN_FIT's presets), then cli.train --debug ->
    cli.inference; returns the launches of each kernel summed over the
    counted calls.  `overrides` cut the models for a rehearsal without a
    card; the script passes none."""
    from ralf_tpu_torch.cli import inference
    from ralf_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    for preset, (k1_gen, k1_dis, k1_infer) in GAN_TRAIN.items():
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            checks.run("gan_step_check", tmp=tmp, preset=preset, overrides=overrides)
            if preset in GAN_TRAIN_FIT:
                run_gan_fit(torch, fails, counted, preset, tmp, k1_gen, k1_dis, card, overrides)
                torch.cuda.empty_cache()
            t_fit = time.perf_counter() - t

            # the entry points: cli.train --debug on the card (2 GAN steps of
            # TRAIN_CLI_BATCH canvases, no validation), then cli.inference on its
            # ckpt_final.npz, one batch of 16
            job = os.path.join(tmp, "cli")
            argv = ["--experiment", preset, "--synthetic", "--debug", "--batch-size",
                    str(TRAIN_CLI_BATCH), "--job-dir", job, "--cache-dir",
                    os.path.join(tmp, "cli_cache"), *overrides]
            _, n = counted(lambda: cli_train.main(argv))
            files = sorted(os.listdir(job))
            expect = want(K1=2 * (k1_gen + k1_dis), LSA=2, K10=2 * GAN_TRAIN_K10[preset],
                          K11=2 * K11_R50)
            fails.check(n == expect and files == [
                "ckpt_final.npz", "ckpt_final_dis.npz", "ckpt_final_dis_opt.pt",
                "ckpt_final_opt.pt", "config.json", "metrics.jsonl"],
                f"gan_train {preset} cli.train --debug: launches {n} (want {expect}); wrote "
                f"{files}")
            out_dir = os.path.join(job, "out_c")
            argv = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size", "16",
                    "--out-dir", out_dir]
            summary, n = counted(lambda: inference.main(argv))
            with open(os.path.join(out_dir, "test_0.pkl"), "rb") as f:
                records = pickle.load(f)["results"]
            with open(os.path.join(out_dir, "test_0_violation.csv")) as f:
                total, violated, rate = list(csv.reader(f))[1]
            coords = [v for r in records for k in ("center_x", "center_y", "width", "height")
                      for v in r[k]]
            k10 = GAN_TRAIN_K10[preset]
            fails.check(n == want(K1=k1_infer, K10=k10, K11=K11_R50) and len(records) == 16
                        and float(rate) == 0.0 and all(0 <= v <= 1 for v in coords),
                        f"gan_train {preset} cli.inference on the trained checkpoint (fp32, "
                        f"--cond c): launches {n} (want K1 {k1_infer}, K10 {k10}, K11 "
                        f"{K11_R50}), "
                        f"{len(records)} records, "
                        f"{len(coords) // 4} elements with coordinates in [0, 1], violations "
                        f"{violated}/{total}, {summary['ms_per_sample'][0]:.3f} ms per sample")
        torch.cuda.empty_cache()
        print(f"  gan_train {preset} {time.perf_counter() - t:.1f} s (fit {t_fit:.1f} s)",
              flush=True)
    print(f"  gan_train phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals

def fid_step_check(torch, fails: Failures, batch, num_labels: int, S: int) -> None:
    """One FIDNet train step (fp32, full width, FID_BATCH layouts) on the card
    and on the CPU from the same seeded weights and the same fake/real draws:
    the loss and its three terms within 1e-4 relative, each subtree's update
    (`compare_step`), and exactly 8 K1 launches on the card."""
    from ralf_tpu_torch.train.fid_trainer import FIDNetTrainer, generate_fake_and_real
    from ralf_tpu_torch.utils.weights import export_params

    lay, is_real = generate_fake_and_real(batch["layout"], np.random.default_rng(0))
    out, terms = {}, {}
    count = counters()["K1"]
    for d in ("cuda", "cpu"):
        trainer = FIDNetTrainer(num_labels, S, device=d)
        model, opt = trainer.init(0)
        model.eval()
        before = export_params(model)
        n0 = count.launches
        loss, aux = trainer.step(model, opt, lay, is_real)
        launched = count.launches - n0
        out[d] = (float(loss), before, export_params(model))
        terms[d] = {k: float(v) for k, v in aux.items()}
        if d == "cuda":
            fails.check(launched == FID_K1_STEP, f"fid_train step on the card: {launched} K1 "
                                                 f"launches (want {FID_K1_STEP})")
    rel = {k: abs(terms["cuda"][k] - terms["cpu"][k]) / abs(terms["cpu"][k]) for k in terms["cpu"]}
    fails.check(max(rel.values()) <= 1e-4, f"fid_train step card vs CPU: terms {terms['cuda']} "
                                           f"vs {terms['cpu']}, relative {rel} (tol 1e-4)")
    compare_step(fails, "fid_train step", out)


def run_fid_train(torch, fails: Failures, smi: list, cli_job: str) -> dict:
    """FIDNet's training on the card (fp32, d_model 256, 4 heads, 4+4 layers,
    FFN 128): the one-step check against the CPU, FIDNetTrainer.fit at
    batch FID_BATCH on the synthetic pku10 train split for FID_EPOCHS
    epochs (exactly 8 K1 launches a step, finite losses, ms per step,
    samples/s, peak memory, one profiled step), then cli.fid_train
    --synthetic --debug and cli.evaluate --fidnet-dir on the cli phase's c
    pickles (`cli_job`); returns the launches summed over the counted calls."""
    from ralf_tpu_torch.cli import evaluate, fid_train
    from ralf_tpu_torch.config import FrameworkConfig, build_datasets
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig
    from ralf_tpu_torch.train.fid_trainer import FIDNetTrainer, generate_fake_and_real

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    data = FrameworkConfig(dataset=DatasetConfig(name="pku10"), synthetic_data=True).dataset
    train_ds = build_datasets(FrameworkConfig(dataset=data, synthetic_data=True))[0]

    def loader():
        return BatchLoader(train_ds, FID_BATCH, with_images=False)

    fid_step_check(torch, fails, next(iter(loader())), data.num_labels, data.max_seq_length)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = FIDNetTrainer(data.num_labels, data.max_seq_length,
                                job_dir=os.path.join(tmp, "fit"), device="cuda")
        records = []
        inner = trainer.step
        count = counters()

        def step(*args):
            n0 = {k: c.launches for k, c in count.items()}
            torch.cuda.synchronize()
            a = time.perf_counter()
            loss, aux = inner(*args)
            value = float(loss)  # waits for the step
            records.append({"loss": value, "s": time.perf_counter() - a,
                            "n": {k: c.launches - n0[k] for k, c in count.items()}})
            return loss, aux

        trainer.step = step
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model, n = counted(lambda: trainer.fit(loader(), epochs=FID_EPOCHS))
        t = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        per_epoch = len(train_ds) // FID_BATCH
        fails.check(len(records) == FID_EPOCHS * per_epoch
                    and all(r["n"] == want(K1=FID_K1_STEP) for r in records)
                    and n == want(K1=FID_K1_STEP * len(records)),
                    f"fid_train fit: {len(records)} steps ({FID_EPOCHS} epochs of {per_epoch}), "
                    f"launches per step {sorted({str(r['n']) for r in records})} (want K1 "
                    f"{FID_K1_STEP}: 4 encoder layers at S=11, 4 decoder layers at S=10); a call "
                    f"{n}")
        losses = [r["loss"] for r in records]
        fails.check(all(math.isfinite(x) for x in losses)
                    and os.path.exists(os.path.join(tmp, "fit", "fidnet_ckpt.npz")),
                    f"fid_train fit: every loss finite (first {losses[0]:.4f}, last "
                    f"{losses[-1]:.4f}); fidnet_ckpt.npz written")
        ms = 1e3 * statistics.median(r["s"] for r in records[1:])
        print(f"  fid_train fit: {ms:.2f} ms per step (median of steps 2-{len(records)}), "
              f"{FID_BATCH / ms * 1e3:.1f} samples/s; peak memory "
              f"{peak / 2**30:.3f} GiB; fit call {t:.1f} s; fp32, batch {FID_BATCH}, {card}",
              flush=True)
        lay, is_real = generate_fake_and_real(next(iter(loader()))["layout"],
                                              np.random.default_rng(1))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
        profile_request(torch, "fid_train step", lambda: inner(model, opt, lay, is_real))
        del model, opt

        # the entry points: cli.fid_train --synthetic --debug (10 epochs of one batch
        # of 64), then cli.evaluate --fidnet-dir on the cli phase's c pickles
        d = os.path.join(tmp, "cli")
        _, n = counted(lambda: fid_train.main(["--synthetic", "--debug", "--job-dir", d]))
        fails.check(n == want(K1=10 * FID_K1_STEP)
                    and os.path.exists(os.path.join(d, "fidnet_ckpt.npz")),
                    f"fid_train cli.fid_train --debug: launches {n} (want K1 {10 * FID_K1_STEP}); "
                    f"fidnet_ckpt.npz written")
        cache = os.path.join(tmp, "eval_trained")
        argv = ["--input-dir", os.path.join(cli_job, "out_c"), "--job-dir", cli_job,
                "--fidnet-dir", d, "--cache-dir", cache]
        with contextlib.redirect_stdout(io.StringIO()):  # its JSON dump; checked below
            scores, n = counted(lambda: evaluate.main(argv))
        cached = sorted(os.listdir(cache))
        keys = ("fid", "precision", "recall", "density", "coverage")
        bad = [k for k in keys if not math.isfinite(scores[k]["mean"])]
        fails.check(n == want(K1=4 * (1 + CLI_SEEDS)) and not bad
                    and cached == ["eval_gt_features_pku10_test_trained.npz"],
                    f"fid_train cli.evaluate --fidnet-dir on the cli phase's c pickles: launches "
                    f"{n} (want K1 {4 * (1 + CLI_SEEDS)}), GT features cached as {cached}; "
                    + ", ".join(f"{k} {scores[k]['mean']:.6g}" for k in keys))
    print(f"  fid_train phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def run_bf16_train(torch, tok, fails: Failures, smi: list, checks, overrides=()) -> dict:
    """bf16 training (fp32 parameters, autocast) on the card: one full-width
    RALF train step against the CPU's at the CPU test's bf16 tolerance;
    Trainer.fit of ralf at batch 32 (as the train phase's fp32 fit, its
    figures printed beside that one's); GANTrainer.fit_gan of cglgan_ra
    (DS-GAN trains in fp32 only, as in JAX: its refusal is checked); then
    cli.train --debug model.dtype=bfloat16 -> cli.inference for ralf and
    cglgan, the checkpoints fp32.  Returns the launches summed over the
    counted calls."""
    from ralf_tpu_torch.cli import inference
    from ralf_tpu_torch.cli import train as cli_train
    from ralf_tpu_torch.config import build_config, build_datasets, build_generator, build_tokenizer
    from ralf_tpu_torch.data.dataset import BatchLoader
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.train.gan_trainer import GANTrainer
    from ralf_tpu_torch.train.trainer import TrainConfig
    from ralf_tpu_torch.utils.weights import load_params_npz

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    bf16 = ("model.dtype=bfloat16", *overrides)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    with tempfile.TemporaryDirectory() as tmp:
        checks.run("train_step_check", tok=tok, tmp=tmp,
                   model=build_config("ralf", list(overrides)).model, dtype="bfloat16")

        job = os.path.join(tmp, "fit")
        cfg = build_config("ralf", ["synthetic_data=true", f"cache_dir={tmp}/cache",
                                    f"train.job_dir={job}", "train.epochs=1",
                                    f"train.save_every_steps={TRAIN_STEPS}", *bf16])
        gen = build_generator(cfg, build_tokenizer(cfg), device="cuda")
        train_ds, val_ds, _ = build_datasets(cfg)
        retriever = Retriever.build(train_ds, device="cuda")
        tables = {"train": retriever.precompute_table(train_ds, gen.top_k, is_train_split=True),
                  "val": retriever.precompute_table(val_ds, gen.top_k, is_train_split=False)}

        def loaders():
            tl = BatchLoader(train_ds, TRAIN_BATCH, transforms=cfg.transforms, seed=cfg.train.seed)
            vl = BatchLoader(val_ds, TRAIN_BATCH, shuffle=False, transforms=cfg.transforms,
                             seed=cfg.train.seed)
            return (RetrievalAugmentedLoader(tl, retriever, gen.top_k, table=tables["train"]),
                    RetrievalAugmentedLoader(vl, retriever, gen.top_k, table=tables["val"]))

        trainer, state, FIT_FIGURES["bf16"] = run_fit(
            torch, fails, counted, "bf16_train fit", gen, cfg, loaders, len(val_ds), 4,
            4 + 6 + 6, card, RALF_K10_EVAL, K11_R50)
        low = [n for n, t in list(gen.core.named_parameters()) + list(gen.core.named_buffers())
               if t.is_floating_point() and t.dtype != torch.float32]
        moments = {t.dtype for s in state.optimizer.opt.state.values() for k, t in s.items()
                   if k != "step"}
        fails.check(not low and moments == {torch.float32},
                    f"bf16_train fit: parameters and BatchNorm statistics fp32 (not: {low[:3]}), "
                    f"AdamW's moments {moments}")
        del trainer, state, gen
        torch.cuda.empty_cache()
        keys = ("ms", "samples_per_s", "peak_gib", "busy", "tensor_core_share")
        for dt in ("fp32", "bf16"):
            fig = FIT_FIGURES.get(dt, {})
            print(f"  ralf train step {dt}: " + ", ".join(
                f"{k} {fig[k]:.4g}" for k in keys if k in fig) + f"; batch {TRAIN_BATCH}, {card}",
                flush=True)

        run_gan_fit(torch, fails, counted, "cglgan_ra", tmp, *GAN_TRAIN["cglgan_ra"][:2], card,
                    bf16)
        torch.cuda.empty_cache()
        try:
            GANTrainer(zoo_generator("dsgan", tmp, "cuda", bf16)[1],
                       TrainConfig(job_dir=os.path.join(tmp, "dsgan")))
            refused = "nothing"
        except ValueError as e:
            refused = str(e)
        fails.check("float32 only" in refused, f"bf16_train dsgan: refused ({refused})")

        # the entry points: cli.train --debug model.dtype=bfloat16, then
        # cli.inference on its checkpoint (bf16, the job's dtype), one batch of 16
        L = tok.max_token_length
        runs = {"ralf": (want(K1=2 * 4 + 2 * 16, K10=2 * RALF_K10_EVAL, K11=2 * K11_R50),
                         want(K1=4 + 12, K2=6 * L, K11=K11_R50)),
                "cglgan": (want(K1=2 * sum(GAN_TRAIN["cglgan"][:2]), LSA=2,
                                K10=2 * GAN_TRAIN_K10["cglgan"], K11=2 * K11_R50),
                           want(K1=GAN_TRAIN["cglgan"][2], K10=GAN_TRAIN_K10["cglgan"],
                                K11=K11_R50))}
        for preset, (expect_train, expect_infer) in runs.items():
            job = os.path.join(tmp, f"cli_{preset}")
            argv = ["--experiment", preset, "--synthetic", "--debug", "--batch-size",
                    str(TRAIN_CLI_BATCH), "--job-dir", job, "--cache-dir",
                    os.path.join(tmp, "cli_cache"), *bf16]
            _, n = counted(lambda: cli_train.main(argv))
            trees = load_params_npz(os.path.join(job, "ckpt_final.npz"))
            dtypes = {str(a.dtype) for tree in trees for _, a in _leaves(tree)}
            fails.check(n == expect_train and dtypes == {"float32"},
                        f"bf16_train {preset} cli.train --debug model.dtype=bfloat16: launches "
                        f"{n} (want {expect_train}); checkpoint dtypes {dtypes}")
            out_dir = os.path.join(job, "out_c")
            argv = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size", "16",
                    "--out-dir", out_dir]
            summary, n = counted(lambda: inference.main(argv))
            with open(os.path.join(out_dir, "test_0.pkl"), "rb") as f:
                records = pickle.load(f)["results"]
            coords = [v for r in records for k in ("center_x", "center_y", "width", "height")
                      for v in r[k]]
            fails.check(n == expect_infer and len(records) == 16
                        and all(0 <= v <= 1 for v in coords),
                        f"bf16_train {preset} cli.inference on the bf16-trained checkpoint "
                        f"(bf16, --cond c): launches {n} (want {expect_infer}), {len(records)} "
                        f"records, {len(coords) // 4} elements with coordinates in [0, 1], "
                        f"{summary['ms_per_sample'][0]:.3f} ms per sample")
    print(f"  bf16_train phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def fusion_check(torch, tok, fails: Failures) -> None:
    """RALF's six other fusion modes at full width in fp32: encode_memory and
    greedy tokens on the card against the same weights on the CPU for
    FUSION_CHECK canvases."""
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    greedy = SamplingConfig(name="deterministic")
    check = check_retriever = None
    for mode in FUSION:
        gens = {d: RALFGenerator(tok, GeneratorConfig(dtype=torch.float32), "uncond", top_k=16,
                                 fusion=mode, device=d, seed=0) for d in ("cuda", "cpu")}
        if check is None:  # the check's gallery and canvases, made once, as reference_check's
            check_retriever, _, (check,) = build_gallery_and_batches(
                gens["cpu"], "cpu", 1, FUSION_CHECK, 64, np.float32)
        mems, conds = {}, {}
        for d, g in gens.items():
            b = dict(check)
            table = g.precompute_retrieved_feats(check_retriever.layouts)
            b["retrieved"] = {**b["retrieved"], "feats": table[b["retrieved_indices"]]}
            conds[d], _ = g.build_condition(b, np.random.default_rng(1), task="c")
            mems[d] = g.encode_memory(conds[d]).cpu()
        forced = build_forced_tokens(conds["cpu"], tok)
        toks = {d: g.decode(mems["cpu"].to(g.device), forced, greedy).cpu() for d, g in gens.items()}
        err = float((mems["cuda"] - mems["cpu"]).abs().max())
        same = float((toks["cuda"] == toks["cpu"]).float().mean())
        fails.check(err < 1e-3 and same >= AGREE,
                    f"fusion {mode} fp32: encode_memory card vs CPU max_abs_err {err:.3e} (tol "
                    f"1e-3), memory {tuple(mems['cpu'].shape)}; greedy tokens {same:.4f} equal "
                    f"(least {AGREE})")
        del gens
        torch.cuda.empty_cache()


def run_fusion(torch, tok, fails: Failures, smi: list, checks) -> dict:
    """RALF's six other fusion modes at full width: per mode one bf16 request
    of BATCH canvases in the CLI-default configuration (exact K1 and K2
    launches, forced and legal tokens, finite layouts, ms); `fusion_check`
    (fp32, card against CPU) through `checks`; returns the counted
    launches."""
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    t0 = time.perf_counter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    counted = LaunchCounter()
    checks.run("fusion_check", tok=tok)
    sampling = SamplingConfig(name="top_p", top_p=0.9, temperature=1.0)
    L = tok.max_token_length
    retriever = batches = None
    for mode, k1 in FUSION.items():
        gen = RALFGenerator(tok, GeneratorConfig(dtype=torch.bfloat16), "uncond", top_k=16,
                            fusion=mode, device="cuda", seed=0)
        if retriever is None:
            retriever, _, batches = build_gallery_and_batches(gen, "cuda", 1, BATCH, GALLERY)
        batch = dict(batches[0])
        feats = gen.precompute_retrieved_feats(retriever.layouts)
        batch["retrieved"] = {**batch["retrieved"], "feats": feats[batch["retrieved_indices"]]}

        def request(seed):
            cond, _ = gen.build_condition(batch, np.random.default_rng(seed))
            forced = build_forced_tokens(cond, tok)
            torch.cuda.synchronize()
            a = time.perf_counter()
            mem = gen.encode_memory(cond)
            toks = gen.decode(mem, forced, sampling,
                              torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            return cond, mem, toks, time.perf_counter() - a

        request(99)  # warm-up, outside the counted run
        (cond, mem, toks, dt), n = counted(lambda: request(0))
        want = {**dict.fromkeys(counted.count, 0), "K1": k1, "K2": 6 * L, "K11": k11_forward(gen)}
        forced = torch.as_tensor(build_forced_tokens(cond, tok), device=toks.device)
        forced_ok = bool((toks[forced >= 0] == forced[forced >= 0]).all())
        legal = bool(gen.token_mask[torch.arange(L, device=toks.device)[None, :], toks].all())
        layout = tok.decode(toks)
        finite = all(bool(torch.isfinite(layout.geo(k)).all())
                     for k in ("center_x", "center_y", "width", "height"))
        fails.check(n == want and forced_ok and legal and finite
                    and tuple(toks.shape) == (BATCH, L),
                    f"fusion {mode}: memory {tuple(mem.shape)}, launches {n} (want {want}), "
                    f"forced tokens in place={forced_ok}, tokens legal={legal}, layouts finite="
                    f"{finite} ({int(layout.mask.sum())} elements)")
        print(f"  fusion {mode}: {dt * 1e3:.1f} ms per request of {BATCH} (encode and decode; "
              f"bf16, {card})", flush=True)
        del gen
        torch.cuda.empty_cache()
    print(f"  fusion phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals



def mesh_gallery(n: int, queries: int) -> tuple[np.ndarray, np.ndarray]:
    """(the mesh phase's gallery features [n, MESH_WIDTH], L2-normalized as a
    Retriever normalizes them, and `queries` queries), from MESH_SEED on the host."""
    rng = np.random.default_rng(MESH_SEED)
    g = rng.standard_normal((n, MESH_WIDTH), dtype=np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    q = rng.standard_normal((queries, MESH_WIDTH), dtype=np.float32)
    return g, q / np.linalg.norm(q, axis=-1, keepdims=True)


def mesh_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of the mesh phase's world of MESH_WORLD on the one card, over
    gloo with CUDA tensors (NCCL takes one rank a device): the fp32 RALF's
    MeshSampler on the request of workdir/request.pkl (its rows' first-step
    logits too) and `sharded_topk` over the gallery's rows split on a gallery
    axis; its results to workdir/rank{rank}.pkl."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    try:
        record_k1_shapes()
        out = mesh_rank_work(torch, rank, world, workdir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mesh_rank_work(torch, rank: int, world: int, workdir: str) -> dict:
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.parallel.decode import MeshSampler, make_decode_mesh
    from ralf_tpu_torch.parallel.mesh import GALLERY_AXIS, batch_rows, counting, make_mesh, take_rows
    from ralf_tpu_torch.retrieval.retriever import sharded_topk

    with open(os.path.join(workdir, "request.pkl"), "rb") as f:
        spec = pickle.load(f)
    cond, dev, B = spec["cond"], spec["device"], spec["batch"]

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10, num_bin=128))
    gen = RALFGenerator(tok, GeneratorConfig(**spec["model"]), "uncond", device=dev, seed=0)
    checksum = float(sum(float(p.double().sum()) for p in gen.core.parameters()))
    greedy = SamplingConfig(name="deterministic")
    mesh = make_decode_mesh()
    sampler = MeshSampler(gen, mesh, greedy)
    counted = LaunchCounter()
    sampler.sample_tokens(cond)  # warm-up
    times = []
    for _ in range(MESH_TIMED):
        sync()
        t = time.perf_counter()
        toks, launches = counted(lambda: sampler.sample_tokens(cond))
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    program, request = sampler.counts
    lo, hi = batch_rows(mesh, B)
    local = take_rows(cond, np.arange(lo, hi), B)
    first = layer_decode(torch, gen.core.decoder, gen.encode_memory(local), gen.token_mask,
                         build_forced_tokens(local, tok), tok, greedy, shared=True)[1]
    # the gallery's rows over a gallery axis of `world` ranks, zero-padded
    g, q = mesh_gallery(spec["gallery"], B)
    per = -(-g.shape[0] // world)
    shard = np.zeros((per, g.shape[1]), np.float32)
    part = g[rank * per:(rank + 1) * per]
    shard[:len(part)] = part
    del g, part
    gmesh = make_mesh((1, world))
    shard_t, q_t = torch.from_numpy(shard).to(dev), torch.from_numpy(q).to(dev)
    topk_ms = []
    for _ in range(1 + MESH_TIMED):
        sync()
        t = time.perf_counter()
        with counting() as topk_counts:
            idx = sharded_topk(gmesh, GALLERY_AXIS, q_t, shard_t, MESH_TOP_K,
                               n_valid=spec["gallery"])
        sync()
        topk_ms.append((time.perf_counter() - t) * 1e3)
    return {"tokens": toks.cpu().numpy(), "first": first.cpu().numpy(), "rows": (lo, hi),
            "launches": launches, "program": dict(program), "request": dict(request),
            "ms": times, "checksum": checksum, "topk": idx.cpu().numpy(),
            "topk_counts": dict(topk_counts), "topk_ms": topk_ms[1:], "k1": set(K1_LAUNCHED)}


def mesh_topk_check(torch, fails: Failures, got: np.ndarray, gallery: int) -> None:
    """The mesh phase's sharded top-k against the exact top-k of the same
    gallery and queries in fp64 on the CPU: equal indices on every query
    whose fp64 scores around the k-th do not lie within 1e-5 (the card's fp32
    products over MESH_WIDTH can swap such neighbours)."""
    g, q = mesh_gallery(gallery, got.shape[0])
    scores = q.astype(np.float64) @ g.astype(np.float64).T
    order = np.argsort(-scores, axis=1, kind="stable")[:, :MESH_TOP_K + 1]
    top = np.take_along_axis(scores, order, axis=1)
    tied = (np.diff(-top, axis=1) < 1e-5).any(axis=1)
    same = (got == order[:, :MESH_TOP_K]).all(axis=1)
    fails.check(bool(same[~tied].all()),
                f"mesh: sharded_topk over {gallery} x {MESH_WIDTH} on {MESH_WORLD} ranks "
                f"against the fp64 top-{MESH_TOP_K} on the CPU: {int(same[~tied].sum())} of "
                f"{int((~tied).sum())} queries equal; {int(tied.sum())} with near-tied scores "
                f"(within 1e-5; {int(same[tied].sum())} of them equal too)")


def run_mesh(torch, tok, fails: Failures, smi: list, checks, cli_job: str, dev: str = "cuda",
             model=None, batch: int = MESH_BATCH, gallery: int = MESH_GALLERY) -> dict:
    """The multi-GPU layer on the one card: world 2 over gloo (`mesh_rank`,
    spawned) against world 1 in fp32; then over NCCL at world 1,
    cli.inference --mesh on against --mesh off and one data-parallel fp32
    train step against the single-process one.  Returns the launches of each
    kernel summed over the counted calls, the ranks' requests among them.
    `dev`, `model` (GeneratorConfig fields), `batch` and `gallery` cut it for
    a rehearsal without a card; the script passes none."""
    import multiprocessing

    import torch.distributed as dist

    from ralf_tpu_torch.cli import inference
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.parallel import mesh as pmesh
    from ralf_tpu_torch.retrieval.retriever import Retriever, exact_topk
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
    from ralf_tpu_torch.utils.weights import export_params

    t0 = time.perf_counter()
    counted = LaunchCounter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    greedy = SamplingConfig(name="deterministic")
    model = {"dtype": torch.float32, **(model or {})}
    with tempfile.TemporaryDirectory() as tmp:
        # world 2: a request of 128 canvases, task uncond, fp32; its condition from the host
        gen = RALFGenerator(tok, GeneratorConfig(**model), "uncond", device=dev, seed=0)
        _, _, batches = build_gallery_and_batches(gen, dev, 1, batch, GALLERY)
        cond, _ = gen.build_condition(batches[0], np.random.default_rng(0), task="uncond")
        with open(os.path.join(tmp, "request.pkl"), "wb") as f:
            pickle.dump({"cond": cond, "device": dev, "model": model, "batch": batch,
                         "gallery": gallery}, f)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, MESH_WORLD, tmp)) for r in range(MESH_WORLD)]
        for p in procs:
            p.start()
        # meanwhile world 1: the same program's tokens, first-step logits and margins
        with torch.inference_mode():
            memory = gen.encode_memory(cond)
            forced = build_forced_tokens(cond, tok)
            want = gen.decode(memory, forced, greedy).cpu().numpy()
            _, first, least = layer_decode(torch, gen.core.decoder, memory, gen.token_mask, forced,
                                           tok, greedy, shared=True, margins=True)
        first, least = first.cpu().numpy(), least.cpu().numpy()
        checksum = float(sum(float(p.double().sum()) for p in gen.core.parameters()))
        g, q = mesh_gallery(gallery, batch)
        exact = exact_topk(torch.from_numpy(q).to(dev), torch.from_numpy(g).to(dev),
                           MESH_TOP_K).cpu().numpy()
        del g
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.terminate()
        codes = [p.exitcode for p in procs]
        single_ms = []  # world 1's request, the card free again
        for _ in range(MESH_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.inference_mode():
                gen.decode(gen.encode_memory(cond), build_forced_tokens(cond, tok), greedy)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t) * 1e3)
        print(f"  mesh world 1: {', '.join(f'{x:.2f}' for x in single_ms)} ms a request of {batch} "
              f"(single process, fp32; {card})", flush=True)
        del gen, memory
        fails.check(codes == [0] * MESH_WORLD, f"mesh: world {MESH_WORLD} ranks over gloo with "
                                               f"CUDA tensors exited {codes}")
        if codes == [0] * MESH_WORLD:
            ranks = []
            for r in range(MESH_WORLD):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
            mesh_world2(torch, fails, card, ranks, counted, checksum, want, first, least, exact)
            checks.run("mesh_topk_check", got=ranks[0]["topk"], gallery=gallery)
        torch.cuda.empty_cache()

        # world 1 over NCCL: cli.inference --mesh on against --mesh off on the cli
        # phase's job (bf16, batches of CLI_BATCH, task c), greedy and top_p
        with open(os.path.join(cli_job, "config.json")) as f:
            config = json.load(f)
        for name in ("deterministic", "top_p"):
            job = os.path.join(tmp, f"job_{name}")
            os.makedirs(job)
            with open(os.path.join(job, "config.json"), "w") as f:
                json.dump({**config, "sampling": {**config["sampling"], "name": name}}, f)
            per, records = {}, {}
            for mesh in ("off", "on"):
                out = os.path.join(job, f"out_{mesh}")
                argv = ["--job-dir", job, "--params", os.path.join(cli_job, "ckpt_final.npz"),
                        "--cond", "c", "--num-seeds", "1", "--batch-size", str(CLI_BATCH),
                        "--mesh", mesh, "--out-dir", out]
                with pmesh.counting() as coll:
                    summary, n = counted(lambda: inference.main(argv))
                with open(os.path.join(out, "test_0.pkl"), "rb") as f:
                    records[mesh] = pickle.load(f)["results"]
                per[mesh] = (summary["ms_per_sample"][0] * CLI_BATCH, dict(coll), n)
            fails.check(records["on"] == records["off"] and per["on"][2] == per["off"][2]
                        and per["on"][1].get("all_gather") == 1,
                        f"mesh: cli.inference --mesh on (world 1, NCCL) against --mesh off, "
                        f"{name}: {len(records['on'])} records equal={records['on'] == records['off']}, "
                        f"launches {per['on'][2]} and {per['off'][2]}, collectives {per['on'][1]} "
                        f"(one all-gather a request of {CLI_BATCH})")
            print(f"  mesh cli {name}: {per['on'][0]:.2f} ms a request of {CLI_BATCH} with --mesh on, "
                  f"{per['off'][0]:.2f} ms with --mesh off ({card})", flush=True)

        # world 1 over NCCL: one fp32 data-parallel train step at batch 32 against the
        # single-process step, from the same seeded weights and batch
        _, made = pmesh.init_distributed(dev)
        try:
            mesh = pmesh.make_mesh()
            ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=64, seed=0)
            loader = RetrievalAugmentedLoader(BatchLoader(ds, TRAIN_BATCH, shuffle=False),
                                              Retriever.build(ds, device=dev), 16,
                                              is_train_split=True)
            step_batch = next(iter(loader))
            out, ms, colls = {}, {}, {}
            for label, m in (("mesh", mesh), ("single", None)):
                gen = RALFGenerator(tok, GeneratorConfig(**{**model, "dropout": 0.0}), "uncond",
                                    device=dev, seed=0)
                trainer = Trainer(gen, TrainConfig(job_dir=os.path.join(tmp, f"step_{label}")), m)
                before = export_params(gen.core)
                state = trainer.init_state()
                inputs, targets = gen.preprocess(step_batch, np.random.default_rng(0))
                with pmesh.counting() as coll:
                    loss, n = counted(lambda: float(trainer.train_step(state, inputs, targets)["loss"]))
                out["cuda" if m is not None else "cpu"] = (loss, before, export_params(gen.core))
                colls[label] = dict(coll)
                times = []
                for _ in range(MESH_TIMED):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    trainer.train_step(state, inputs, targets)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
                ms[label] = times
                del gen, trainer, state
                torch.cuda.empty_cache()
            compare_step(fails, "mesh: data-parallel train step (world 1, NCCL, fp32, batch "
                         f"{TRAIN_BATCH})", out, "float32", sides="against the single process")
            try:
                pmesh.assert_dp_train_hlo(collections.Counter(colls["mesh"]), expect_sync=False)
                ok = colls["mesh"].get("all_reduce", 0) >= 1 and not colls["single"]
            except AssertionError:
                ok = False
            fails.check(ok, f"mesh: a train step's collectives {colls['mesh']} (all-reduces only; "
                            f"the single process {colls['single']})")
            print(f"  mesh train step: {', '.join(f'{x:.2f}' for x in ms['mesh'])} ms with the mesh "
                  f"(world 1), {', '.join(f'{x:.2f}' for x in ms['single'])} ms single-process "
                  f"(fp32, batch {TRAIN_BATCH}; {card})", flush=True)
        finally:
            if made:
                dist.destroy_process_group()
    print(f"  mesh phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def mesh_world2(torch, fails: Failures, card: str, ranks: list, counted: LaunchCounter,
                checksum: float, want: np.ndarray, first: np.ndarray, least: np.ndarray,
                exact: np.ndarray) -> None:
    """The world-2 ranks' results against world 1's (`run_mesh`)."""
    toks = ranks[0]["tokens"]
    same_weights = all(r["checksum"] == checksum for r in ranks)
    got_first = np.concatenate([r["first"] for r in ranks])
    err = float(np.abs(got_first - first).max())
    ties = least <= MESH_MARGIN
    equal_rows = (toks == want).all(axis=1)
    fails.check(same_weights and err <= MESH_LOGITS_TOL and bool(equal_rows[~ties].all())
                and all(np.array_equal(r["tokens"], toks) for r in ranks),
                f"mesh: RALF fp32 greedy, a request of {len(toks)} over {MESH_WORLD} ranks (gloo, "
                f"rows {[r['rows'] for r in ranks]}) against world 1: weights equal={same_weights}, "
                f"first-step logits max_abs_err {err:.3e} (tol {MESH_LOGITS_TOL}), rows with equal "
                f"tokens {int(equal_rows[~ties].sum())} of {int((~ties).sum())} clear of a near tie; "
                f"{int(ties.sum())} near-tie rows (a top-two margin <= {MESH_MARGIN}), "
                f"{int(equal_rows[ties].sum())} of them equal")
    for r, rank in enumerate(ranks):
        ok = (rank["program"] == {} and rank["request"] == {"all_gather": 1}
              and rank["launches"]["K1"] == 12 and rank["launches"]["K2"] == 6 * want.shape[1]
              and rank["launches"]["K11"] == K11_R50)
        fails.check(ok, f"mesh: rank {r}: a request's collectives {rank['request']}, in the "
                        f"program {rank['program']}; launches {rank['launches']} (want K1 12, K2 "
                        f"{6 * want.shape[1]}, K11 {K11_R50} at {len(toks) // MESH_WORLD} rows)")
        for k, v in rank["launches"].items():
            counted.totals[k] += v
        K1_LAUNCHED.update(rank["k1"])
        print(f"  mesh rank {r}: {', '.join(f'{x:.2f}' for x in rank['ms'])} ms a request of "
              f"{len(toks)} (its {len(toks) // MESH_WORLD} rows; 2 ranks on one card, gloo; "
              f"{card})", flush=True)
    topk = ranks[0]["topk"]
    same = (topk == exact).all(axis=1)
    fails.check(all(np.array_equal(r["topk"], topk) for r in ranks)
                and all(r["topk_counts"] == {"all_gather": 1} for r in ranks),
                f"mesh: sharded_topk over a gallery of {MESH_WIDTH}-wide rows on a gallery axis "
                f"of {MESH_WORLD}: the ranks agree, one all-gather each; {int(same.sum())} of "
                f"{len(topk)} queries equal the card's exact_topk over the whole gallery "
                f"(held exactly against fp64 in the worker)")
    print(f"  mesh sharded_topk: {', '.join(f'{x:.2f}' for x in ranks[0]['topk_ms'])} ms for "
          f"{len(topk)} queries, top-{MESH_TOP_K} ({card})", flush=True)


WORKER_THREADS = 4  # the worker's torch threads, of the host's 8 cores


def _worker_init() -> None:
    import torch

    torch.set_num_threads(WORKER_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record_k1_shapes()


def worker():
    """One spawned process beside this one for the CPU halves that need no
    card (the towers' outputs, the builders' CPU cli.evaluate) and for the
    card-against-CPU checks of the phases (`Checks`): the phases are
    host-bound on one thread, the checks mostly CPU work, so they run side
    by side.  Its kernel libraries are the ones `_build.build_all` built."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_worker_init)


def check_in_worker(name: str, kwargs: dict) -> tuple[list, str, set]:
    """Run the check `name` of this script, `name(torch, fails=..., **kwargs)`,
    in the worker, with a `tmp` of its own (the phase's may be gone by then):
    (its failures, a check that raised among them with its traceback; its
    printed output; the K1 shapes the worker has launched)."""
    import torch

    fails = Failures()
    out = io.StringIO()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        if "tmp" in kwargs:
            kwargs = {**kwargs, "tmp": tmp}
        try:
            globals()[name](torch, fails=fails, **kwargs)
        except Exception:  # the worker's boundary: the check fails, its output is kept
            fails.check(False, f"{name} raised:\n{traceback.format_exc()}")
        torch.cuda.empty_cache()
        print(f"  {name} {time.perf_counter() - t:.1f} s in the worker", flush=True)
    return list(fails), out.getvalue(), set(K1_LAUNCHED)


class Checks:
    """Where the phases' card-against-CPU checks run: in the worker `pool`
    (`worker`), submitted when a phase reaches its check and read by `wait`
    (each one's output printed in submission order, its failures and K1
    shapes taken over), or here at once without a pool (a rehearsal)."""

    def __init__(self, fails: Failures, pool=None) -> None:
        self.fails, self.pool, self.pending = fails, pool, []

    def run(self, name: str, **kwargs) -> None:
        if self.pool is None:
            import torch

            globals()[name](torch, fails=self.fails, **kwargs)
        else:
            self.pending.append(self.pool.submit(check_in_worker, name, kwargs))

    def wait(self) -> None:
        t = time.perf_counter()
        for future in self.pending:
            failures, text, shapes = future.result()
            print(text, end="", flush=True)
            self.fails.extend(failures)
            K1_LAUNCHED.update(shapes)
        print(f"checks: waited {time.perf_counter() - t:.1f} s for the worker", flush=True)
        self.pending = []


def cpu_tower_outputs(kinds) -> tuple[dict, float]:
    """(each tower's outputs on the CPU for the first TOWER_CHECK canvases of
    `tower_canvases()`, seeded random weights as on the card; the seconds);
    run in the worker."""
    from ralf_tpu_torch.models.towers import build_feature_fn
    from ralf_tpu_torch.retrieval.lpips import make_lpips_fns

    t = time.perf_counter()
    canvases = tower_canvases()[:TOWER_CHECK]
    out = {}
    with tempfile.TemporaryDirectory() as empty:  # no checkpoints: seeded random towers
        for kind in kinds:
            fn = (make_lpips_fns(empty, device="cpu")[0] if kind == "lpips_alex"
                  else build_feature_fn(kind, empty, "cpu"))
            res = fn(canvases)
            out[kind] = [a.float().numpy() for a in (res if isinstance(res, list) else [res])]
            del fn
    return out, time.perf_counter() - t


def tower_canvases() -> np.ndarray:
    return np.random.default_rng(0).random((TOWER_BATCH, 350, 240, 3), dtype=np.float32)


def cpu_image_metrics(cli_job: str) -> tuple[dict, dict, float]:
    """cli.evaluate --image-metrics --device cpu on a copy of the cli phase's
    c pickles (its own input and cache dirs in the job's parent), run in the
    worker: (its scores; the kernels it launched there; the seconds)."""
    import shutil

    from ralf_tpu_torch.cli import evaluate

    t = time.perf_counter()
    parent = os.path.dirname(cli_job)
    inputs = shutil.copytree(os.path.join(cli_job, "out_c"), os.path.join(parent, "cpu_out_c"))
    argv = ["--input-dir", inputs, "--job-dir", cli_job, "--cache-dir",
            os.path.join(parent, "cpu_eval_cache"), "--image-metrics", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        scores, n = LaunchCounter()(lambda: evaluate.main(argv))
    return scores, n, time.perf_counter() - t


def run_towers(torch, fails: Failures, smi: list, cpu) -> dict:
    """Each feature tower at full size in fp32 (TF32 off): the card against
    the same random weights on the CPU on TOWER_CHECK canvases, within
    TOWER_TOL of the largest magnitude, with exactly K11_TOWER's K11
    launches, and ms per batch of TOWER_BATCH 350x240 canvases on the card
    (the resize included).  `cpu` is the future of
    `cpu_tower_outputs(TOWERS)`, which the worker computes while the card
    runs the phases before this one.  Returns the counted launches."""
    from ralf_tpu_torch.models.towers import TOWER_SPECS, build_feature_fn
    from ralf_tpu_torch.retrieval.lpips import make_lpips_fns

    t0 = time.perf_counter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    counted = LaunchCounter()
    canvases = tower_canvases()
    on_card = torch.from_numpy(canvases).cuda()
    cpu_out, cpu_s = cpu.result()
    print(f"  towers: the CPU's outputs took {cpu_s:.1f} s in the worker, waited for "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as empty:  # no checkpoints: seeded random towers
        for kind in TOWERS:
            fn = (make_lpips_fns(empty, device="cuda")[0] if kind == "lpips_alex"
                  else build_feature_fn(kind, empty, "cuda"))
            res, n = counted(lambda: fn(canvases[:TOWER_CHECK]))
            out = [t.float().cpu() for t in (res if isinstance(res, list) else [res])]
            ref = [torch.from_numpy(a) for a in cpu_out[kind]]
            errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-8))
                    for a, b in zip(out, ref)]
            finite = all(bool(torch.isfinite(a).all()) for a in out)
            k11 = K11_TOWER.get(kind, 0)
            fails.check(finite and len(out) == len(ref) and max(errs) < TOWER_TOL
                        and n == {**dict.fromkeys(n, 0), "K11": k11},
                        f"towers {kind}: card vs CPU relative max error {max(errs):.3e} (tol "
                        f"{TOWER_TOL}), outputs {[tuple(a.shape) for a in out]}, launches {n} "
                        f"(want K11 {k11})")
            ms = time_ms(lambda: fn(on_card), iters=5, warmup=2)
            size = 224 if kind == "lpips_alex" else TOWER_SPECS[kind][1]
            print(f"  towers {kind}: {ms:.2f} ms per batch of {TOWER_BATCH} (350x240 -> "
                  f"{size}, fp32; {card})", flush=True)
            del fn
            torch.cuda.empty_cache()
    print(f"  towers phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def run_builders(torch, fails: Failures, smi: list, cli_job: str, cpu_eval) -> dict:
    """cli.build_caches on the synthetic debug splits (64/16/16): retrieval
    with the dreamsim backbone, then reranked by mmr and by lpips (AlexNet;
    its rows against the CPU's lpips_rerank of the same candidates), then the
    clusters and the relationships; then cli.evaluate --image-metrics on the
    cli phase's c pickles (`cli_job`) against the same call without the flag
    and the same call on the CPU, `cpu_eval`, the future of
    `cpu_image_metrics(cli_job)`, which the worker runs from the cli phase's
    end; returns the counted launches."""
    from ralf_tpu_torch import cache as cache_mod
    from ralf_tpu_torch.cli import build_caches, evaluate
    from ralf_tpu_torch.config import FrameworkConfig, build_datasets
    from ralf_tpu_torch.core.layout import GEO_KEYS
    from ralf_tpu_torch.core.relationships import RelLoc, RelSize
    from ralf_tpu_torch.data.dataset import DatasetConfig
    from ralf_tpu_torch.retrieval.lpips import lpips_rerank

    t0 = time.perf_counter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    counted = LaunchCounter()
    none = dict.fromkeys(counted.totals, 0)
    sizes = {"train": 64, "val": 16, "test": 16}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "cache")
        common = ["--synthetic", "--debug", "--cache-dir", cache]
        tables = {}
        for label, k, extra, key in (
                ("dreamsim", BUILD_TOP_K, [], "dreamsim"),
                ("dreamsim --rerank mmr", BUILD_TOP_K // 2, ["--rerank", "mmr"], "dreamsim"),
                ("dreamsim --rerank lpips", LPIPS_TOP_K, ["--rerank", "lpips"], "lpips")):
            top_k = 2 * k if extra[1:] == ["mmr"] else k
            t = time.perf_counter()
            _, n = counted(lambda: build_caches.main(
                ["--what", "retrieval", "--backbone", "dreamsim", "--top-k", str(top_k),
                 *common, *extra]))
            t = time.perf_counter() - t
            got = {s: cache_mod.load_retrieval_table(cache, "pku10", s, key, k) for s in sizes}
            shapes_ok = all(got[s] is not None and got[s].shape == (m, k) for s, m in sizes.items())
            inside = shapes_ok and all(((t_ >= 0) & (t_ < 64)).all() for t_ in got.values())
            no_self = shapes_ok and not (got["train"] == np.arange(64)[:, None]).any()
            tables[label] = got
            fails.check(shapes_ok and inside and no_self and n == none,
                        f"builders build_caches --what retrieval {label}: tables "
                        f"{[None if v is None else v.shape for v in got.values()]}, neighbours "
                        f"in the gallery={inside}, never the canvas itself={no_self}, "
                        f"launches {n}")
            print(f"  builders build_caches {label}: {t:.2f} s ({card})", flush=True)
        # each lpips row reorders its dreamsim top-4 (the k=16 table's first 4), and
        # the CPU's lpips_rerank of the same candidates gives the card's rows
        base, lp = tables["dreamsim"], tables["dreamsim --rerank lpips"]
        reorder = all(sorted(a) == sorted(b[:LPIPS_TOP_K]) for s in sizes
                      for a, b in zip(lp[s], base[s]))
        feats = np.load(os.path.join(cache, "pku10_dreamsim_gallery_features.npz"))["features"]
        unit = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        least = float((unit @ unit.T).min())  # the towers tell the canvases apart
        splits = build_datasets(FrameworkConfig(dataset=DatasetConfig(name="pku10"),
                                                synthetic_data=True, debug=True))
        t = time.perf_counter()
        cpu = {s: lpips_rerank(ds.get_images, base[s][:, :LPIPS_TOP_K], splits[0].get_images,
                               cache_dir=cache, device="cpu") for s, ds in zip(sizes, splits)}
        t = time.perf_counter() - t
        moved = sum(int((lp[s] != base[s][:, :LPIPS_TOP_K]).any(1).sum()) for s in sizes)
        differ = sum(int((cpu[s] != lp[s]).any(1).sum()) for s in sizes)
        fails.check(reorder and differ == 0 and least < 1 - 1e-3 and feats.shape == (64, 2304)
                    and bool(np.isfinite(feats).all()),
                    f"builders: each lpips row a reorder of its dreamsim top-4={reorder} ("
                    f"{moved} of 96 rows reordered); the CPU's lpips_rerank of the same "
                    f"candidates differs in {differ} rows ({t:.1f} s); gallery features "
                    f"{feats.shape}, least cosine {least:.6f}")
        for what in ("clusters", "relationships"):
            t = time.perf_counter()
            build_caches.main(["--what", what, *common])
            print(f"  builders build_caches --what {what}: {time.perf_counter() - t:.2f} s",
                  flush=True)
        with open(cache_mod.kmeans_clusters_path(cache, "pku10"), "rb") as f:
            clusters = pickle.load(f)
        want_keys = [f"{g}-{2**i}" for g in GEO_KEYS for i in range(1, 9)]
        sorted_ok = all(np.all(np.diff(v) >= 0) and len(v) == int(k.split("-")[1])
                        for k, v in clusters.items())
        rels = cache_mod.load_relationships(cache, "pku10")
        kinds = [c[2] for clauses in rels.values() for c in clauses]
        fails.check(list(clusters) == want_keys and sorted_ok and len(rels) == 64 and kinds
                    and all(isinstance(r, (RelLoc, RelSize)) for r in kinds),
                    f"builders: {len(clusters)} kmeans vocabularies (sorted={sorted_ok}), "
                    f"relation clauses of {len(rels)} samples ({len(kinds)} clauses)")

        # cli.evaluate --image-metrics on the cli phase's c pickles, beside the same call
        # without the flag (its other scores must not move) and the same call on the CPU
        scores = {}
        for label, extra in (("plain", []), ("image-metrics", ["--image-metrics"])):
            argv = ["--input-dir", os.path.join(cli_job, "out_c"), "--job-dir", cli_job,
                    "--cache-dir", os.path.join(tmp, f"eval_{len(scores)}"), *extra]
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                scores[label], n = counted(lambda: evaluate.main(argv))
            t = time.perf_counter() - t
            # --image-metrics: InceptionV3 over the real and the fake canvases of each
            # seed's pickle (one chunk of CLI_BATCH)
            k11 = 2 * CLI_SEEDS * K11_TOWER["inception"] if extra else 0
            fails.check(n == {**none, "K1": 4 * (1 + CLI_SEEDS), "K11": k11},
                        f"builders cli.evaluate {label}: launches {n} (want K1 "
                        f"{4 * (1 + CLI_SEEDS)}, K11 {k11})")
            print(f"  builders cli.evaluate {label}: {t:.2f} s ({card})", flush=True)
        t = time.perf_counter()
        cpu, n, cpu_s = cpu_eval.result()
        fails.check(n == none, f"builders cli.evaluate image-metrics --device cpu: launches {n}")
        print(f"  builders cli.evaluate image-metrics --device cpu: {cpu_s:.2f} s in the "
              f"worker, waited for {time.perf_counter() - t:.2f} s", flush=True)
        got = scores["image-metrics"]
        positive = all(got[k]["mean"] > 0 for k in ("image_fid", "R_shm"))
        same = all(json.dumps(got[k]) == json.dumps(v) for k, v in scores["plain"].items())
        errs = {k: abs(got[k]["mean"] - cpu[k]["mean"]) / max(abs(cpu[k]["mean"]), 1e-12)
                for k in IMAGE_KEYS}
        fails.check(list(got) == SCORE_KEYS + IMAGE_KEYS and positive and same
                    and all(errs[k] < IMAGE_TOL.get(k, 1e-6) for k in IMAGE_KEYS),
                    f"builders cli.evaluate --image-metrics: keys {list(got)[len(SCORE_KEYS):]} "
                    f"after JAX's {len(SCORE_KEYS)} (want {IMAGE_KEYS}), image_fid "
                    f"{got['image_fid']['mean']:.6g}, R_shm {got['R_shm']['mean']:.6g}, the other "
                    f"scores unchanged={same}; card vs CPU relative errors "
                    + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                    + f" (limits {IMAGE_TOL}, else 1e-6)")
    print(f"  builders phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def randomize_bn(torch, module, seed: int) -> None:
    """Every BatchNorm's statistics and affine drawn from a seeded CPU
    generator (tests/test_lama.py's `_randomize_bn` laws): with flax's initial
    ones (mean 0, var 1, scale 1, bias 0) BatchNorm is the identity, and a
    random saliency map spans too little to test."""
    from ralf_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                m.weight.copy_(1.0 + torch.randn(n, generator=g) * 0.2)
                m.bias.copy_(torch.randn(n, generator=g) * 0.2)


def random_layouts(n: int, rng: np.random.Generator, max_elements: int = 10):
    """A Layout of `n` canvases with 1..max_elements boxes each, drawn with numpy."""
    from ralf_tpu_torch.core.layout import Layout

    count = rng.integers(1, max_elements + 1, n)
    mask = np.arange(max_elements)[None, :] < count[:, None]
    shape = (n, max_elements)
    return Layout.fromdict({"label": rng.integers(0, 3, shape) * mask,
                            "center_x": rng.uniform(0.1, 0.9, shape) * mask,
                            "center_y": rng.uniform(0.1, 0.9, shape) * mask,
                            "width": rng.uniform(0.05, 0.4, shape) * mask,
                            "height": rng.uniform(0.03, 0.2, shape) * mask, "mask": mask})


def measure_batch(torch, label: str, run, card: str, unit: str, n: int) -> None:
    """ms per call of `run` on the card (median of PREPROCESS_TIMED after a
    warm-up), n / that as items/s, peak memory of one call, and one call
    under torch.profiler (device ms, busy share, launches); printed."""
    run()
    torch.cuda.synchronize()
    ms = time_ms(run, iters=PREPROCESS_TIMED, warmup=0)
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_request(torch, f"preprocess {label}", run)
    print(f"  preprocess {label}: {ms:.2f} ms per batch of {n} {unit}, {1e3 * n / ms:.2f} "
          f"{unit}/s, peak memory {peak:.3f} GiB (fp32; {card})", flush=True)


def run_preprocess(torch, fails: Failures, smi: list) -> dict:
    """The offline dataset build's nets on the card, fp32, TF32 off, random
    weights drawn to flax's laws from seed 0, the saliency nets' with random
    BatchNorm statistics (`randomize_bn`): ISNet (1024^2) and BASNet (256^2)
    through cli.saliency's array function on SALIENCY_BATCH canvases, then
    LaMa (BIG_LAMA) through
    `inpaint` on LAMA_BATCH canvases of PKU's raw LAMA_HW with masks from
    `box_union_mask`, its weights written as TorchScript first; each with ms
    per batch, items/s, peak memory and one profiled batch, one canvas
    card against CPU (the raw maps within SALIENCY_TOL, with their range
    printed; LaMa at LAMA_CHECK_HW within LAMA_TOL), and K11_PREPROCESS's
    K11 launches a forward.  Returns the counted launches."""
    import copy

    from ralf_tpu_torch.cli import saliency
    from ralf_tpu_torch.models.towers import seeded
    from ralf_tpu_torch.preprocess.inpainting import box_union_mask, inpaint
    from ralf_tpu_torch.preprocess.lama import BIG_LAMA, LamaGenerator

    t0 = time.perf_counter()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    counted = LaunchCounter()
    rng = np.random.default_rng(0)

    def want(**launches):
        return {**dict.fromkeys(counted.totals, 0), **launches}

    for model in ("isnet", "basnet"):
        size = saliency.SIZES[model]
        cpu_net = saliency.build_net(model, device="cpu")
        randomize_bn(torch, cpu_net, 0)
        card_net = copy.deepcopy(cpu_net).cuda()
        imgs = rng.random((SALIENCY_BATCH, size, size, 3), dtype=np.float32)
        # one canvas, card against CPU, on the raw maps (the min-max would amplify noise)
        card_map, n = counted(lambda: saliency.raw_maps(card_net, model, imgs[:1]))
        one = {"cpu": saliency.raw_maps(cpu_net, model, imgs[:1]).numpy()[0],
               "cuda": card_map.cpu().numpy()[0]}
        err = float(np.abs(one["cuda"] - one["cpu"]).max())
        span = float(one["cpu"].max() - one["cpu"].min())
        maps = saliency.saliency_maps(card_net, model, imgs)
        k11 = K11_PREPROCESS[model]
        fails.check(err < SALIENCY_TOL and span > SALIENCY_RANGE and maps.shape == (
            SALIENCY_BATCH, size, size) and bool(np.isfinite(maps).all())
                    and maps.min() >= 0 and maps.max() <= 1 and n == want(K11=k11),
                    f"preprocess {model}: launches {n} (want K11 {k11}); "
                    f"raw map card vs CPU max_abs_err {err:.3e} (tol "
                    f"{SALIENCY_TOL}) at {size}^2, the CPU map's range {one['cpu'].min():.4f}-"
                    f"{one['cpu'].max():.4f} ({span:.4f}, least {SALIENCY_RANGE}); normalised "
                    f"maps {maps.shape} in [{maps.min():.3f}, {maps.max():.3f}]")
        measure_batch(torch, f"{model} ({size}^2)",
                      lambda: saliency.saliency_maps(card_net, model, imgs), card, "images",
                      SALIENCY_BATCH)
        del cpu_net, card_net
        torch.cuda.empty_cache()

    H, W = LAMA_HW
    images = rng.integers(0, 256, (LAMA_BATCH, H, W, 3), dtype=np.uint8)
    masks = box_union_mask(random_layouts(LAMA_BATCH, rng), H, W)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "big-lama.pt")
        # flax's laws alone: with random BatchNorm statistics the 18 residual blocks grow
        # the stream to about 1e5 and fp32's own error (against fp64) to 2e-4
        gen = seeded(lambda: LamaGenerator(BIG_LAMA)).eval()
        example = (torch.rand(1, 3, 64, 64), torch.zeros(1, 1, 64, 64))
        torch.jit.trace(gen, example, check_trace=False).save(path)
        del gen
        t = time.perf_counter()
        out, n = counted(lambda: inpaint(images, masks, path, batch_size=LAMA_BATCH))
        t = time.perf_counter() - t
        keep = masks == 0
        k11 = K11_PREPROCESS["lama"]  # one batch: one forward
        fails.check(out.shape == (LAMA_BATCH, H, W, 3) and bool(np.isfinite(out).all())
                    and out.min() >= 0 and out.max() <= 1 and n == want(K11=k11)
                    and bool(np.allclose(out[keep], images[keep] / 255.0, atol=1e-6)),
                    f"preprocess lama: launches {n} (want K11 {k11}); "
                    f"inpaint of {LAMA_BATCH} canvases {H}x{W} (masks cover "
                    f"{100 * (~keep).mean():.1f}%) -> {out.shape} in [{out.min():.3f}, "
                    f"{out.max():.3f}], unmasked pixels kept; the call {t:.2f} s (load, pad to "
                    f"8, run, crop)")
        h, w = LAMA_CHECK_HW
        hole = box_union_mask(random_layouts(1, rng), h, w)
        one = {d: inpaint(images[:1, :h, :w], hole, path, device=d) for d in ("cpu", "cuda")}
        err = float(np.abs(one["cuda"] - one["cpu"]).max())
        pred = one["cpu"][hole > 0]
        live = float(((pred > 0.01) & (pred < 0.99)).mean())  # the rest sigmoid saturates
        fails.check(err < LAMA_TOL and 0.05 < (hole > 0).mean() < 0.95 and live > 0.01,
                    f"preprocess lama: inpaint card vs CPU max_abs_err {err:.3e} (tol "
                    f"{LAMA_TOL}) on one canvas at {h}x{w}, its mask {100 * (hole > 0).mean():.1f}%"
                    f" of the canvas, {100 * live:.1f}% of the masked values inside (0.01, 0.99)")
        # the generator inpaint builds from the file, timed on the padded batch
        from ralf_tpu_torch.preprocess.lama import build_generator, load_lama_params, pad_to_modulo

        gen = build_generator(load_lama_params(path)).cuda()
        x, m = (torch.from_numpy(pad_to_modulo(a)[0]).cuda().permute(0, 3, 1, 2)
                for a in (images / np.float32(255.0), (masks > 127)[..., None].astype(np.float32)))

        def batch():
            with torch.inference_mode():
                return gen(x, m)

        measure_batch(torch, f"lama ({H}x{W} padded to {x.shape[2]}x{x.shape[3]})", batch,
                      card, "images", LAMA_BATCH)
        del gen, x, m
        torch.cuda.empty_cache()
    print(f"  preprocess phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counted.totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
    from ralf_tpu_torch.ops import _build

    t_start = time.perf_counter()
    fails = Failures()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t:.1f} s for {list(_build.SOURCES)}", flush=True)

    # the worker (`worker`) computes the towers' CPU outputs from here, the builders' CPU
    # cli.evaluate from the cli phase's end, and the card-against-CPU checks (`Checks`)
    # beside the phases that submit them; leaving the block stops it
    with worker() as pool:
        checks = Checks(fails, pool)
        towers_cpu = pool.submit(cpu_tower_outputs, TOWERS)
        dev = torch.device("cuda")
        main_rows = run_kernel_checks(torch, dev, fails)
        run_backward_checks(torch, dev, fails)
        record_k1_shapes()
        tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10,
                                                      num_bin=128))
        checks.run("reference_check", tok=tok)
        with tempfile.TemporaryDirectory() as cli_tmp:
            launches = run_cli(torch, fails, smi, cli_tmp)
            cli_job = os.path.join(cli_tmp, "job")
            for kid, n in run_mesh(torch, tok, fails, smi, checks, cli_job).items():
                launches[kid] += n
            cpu_eval = pool.submit(cpu_image_metrics, cli_job)
            for kid, n in run_slice(torch, tok, fails).items():
                launches[kid] += n
            for kid, n in run_fusion(torch, tok, fails, smi, checks).items():
                launches[kid] += n
            launches["K9"] += run_stream(torch, fails)
            for kid, n in run_towers(torch, fails, smi, towers_cpu).items():
                launches[kid] += n
            for kid, n in run_fid_train(torch, fails, smi, cli_job).items():
                launches[kid] += n
            for kid, n in run_builders(torch, fails, smi, cli_job, cpu_eval).items():
                launches[kid] += n
        for kid, n in run_preprocess(torch, fails, smi).items():
            launches[kid] += n
        for kid, n in run_zoo(torch, fails, smi, checks).items():
            launches[kid] += n
        for kid, n in run_baselines(torch, fails, smi, checks).items():
            launches[kid] += n
        for kid, n in run_train(torch, tok, fails, smi, checks).items():
            launches[kid] += n
        for kid, n in run_zoo_train(torch, fails, smi, checks).items():
            launches[kid] += n
        for kid, n in run_gan_train(torch, fails, smi, checks).items():
            launches[kid] += n
        for kid, n in run_bf16_train(torch, tok, fails, smi, checks).items():
            launches[kid] += n
        checks.wait()

    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[kid], **main_rows[n]} for n, (kid, rep, src) in KERNELS.items()]
    for k in kernels:
        fails.check(k["launches"] > 0, f"{k['name']} launched {k['launches']} times on its paths")
    # K1 against its plain version at every (dtype, shape) the paths launched
    # that the kernels phase did not hold (the card-vs-CPU checks' small
    # batches, the tasks' constraint lengths, ...)
    unheld = sorted(K1_LAUNCHED - K1_COMPARED)
    print(f"K1 at the paths' shapes: {len(K1_LAUNCHED)} launched, {len(unheld)} not held in "
          f"the kernels phase, held now", flush=True)
    g = torch.Generator(device=dev).manual_seed(1)
    run_kernel_checks(torch, dev, fails, [
        k1_case(torch, g, dev, getattr(torch, dn), B, S, H, masked, E)
        for dn, B, S, E, H, masked in unheld])
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed: {fails}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi[0] if smi else name)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase that raised fails the run
        traceback.print_exc()
        sys.exit(1)
