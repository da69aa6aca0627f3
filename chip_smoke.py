#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pfst_tpu_torch``) on one
NVIDIA Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. the card: CUDA present, compute capability 9.0, name and power limit;
2. build the CUDA kernels from ``pfst_tpu_torch/ops/csrc`` (nvcc, sm_90a,
   cached under ``build/pfst_tpu_torch/``);
3. each kernel against its plain PyTorch version at the path's shapes
   (SeasonNet's (16, 512, 32, 32) cosine, the UDA family's
   (2, 1024, 128, 128) and FMDAAdaptor's (2, 2048, 128, 128) gaussian,
   phase 20's UNet (1, 64, 512, 512) and HRNet (1, 270, 128, 128)
   gaussian, both types, among them),
   with its median time (per call, and on the device in a CUDA graph of
   ten launches), the plain version's and the memory/compute bound;
3b. the similarity's backward kernel against autograd of the plain
   forward and against the plain gather backward, at the training shape
   (2, 512, 64, 64), both similarity types, fp32 and bf16 input, with
   its time per call and on the device, and at SeasonNet's training shape
   (16, 512, 32, 32) and the UDA family's (2, 1024, 128, 128); then at
   small general geometries
   (k 3, 5, 7; d 1, 2, 33; odd W), checked only; two launches on the
   same inputs must be bitwise equal;
4. the serving path at full width: the Pots->Vaih DeepLabV3+ R50-D8 leaf
   config with seeded random weights answers 1024x1024 requests
   (``make_inference_fn`` -> ``_finalize_views`` -> labels, then
   ``make_state_fn`` -> ``sim_feat`` through the kernel), with the kernel
   launch counts read around this phase only;
5. card against CPU on one 512x512 image with TF32 off;
6. informational: fused inference + pseudo-labels at batch 24, 512x512, in
   fp32 and bf16 autocast;
7. training at full width: ``build_train_model`` -> ``PFGST.init_state``
   -> ``make_train_step``, AdamW from the config, steps on seeded
   synthetic batches of 2 x 512x512 crops, in fp32 (TF32 convolutions, the
   default) and in bf16 autocast, with the kernels' launches per step read
   around each run, the EMA teacher checked, s/iter, the host's time
   until each step returns (its enqueue), and the caching allocator's
   retries (``num_alloc_retries``) and the garbage collector's
   collections in the run;
8. one training step card against CPU, 2 x 128x128 crops, full width and
   depth, dropout off, TF32 off: log vars and student gradients;
3c. (run after 3b) each flash-attention kernel (forward, dK/dV, dQ)
   against its plain version at the ViT's shapes (1 and 2 x 12 x 1025 x
   64, fp32 and bf16, read through the strides of the block's qkv
   layout), the microbench's (8 x 12 x {1024, 4096} x 64 bf16), an
   edge case (1 x 2 x 17 x 64, fp32 and bf16: N inside one tile), and
   phase 20's (2 x 16 x 2305 x 64: ViT-L at 768^2, one valid key in the
   last block; 2 x 12 x 1043 x 64: Segmenter's decoder; keys shorter
   than the queries, N_k = 256: MiT-B0's and PCPVT-S's stage 0, 2 x 1 x
   16384 x {32, 64}, and a middle MiT-B0 stage, 2 x 5 x 1024 x 32), with
   the median times of the kernel (per
   call, and on the device in a CUDA graph of ten launches), the plain
   version and SDPA (per call, and on the device: its forward, and its
   backward alone), and the bound; then with the library's bias ``ab``
   (``FLASH_AB_CASES``): BEiT-B's (2, 12, 1601, 64) with its table
   shared by the batch and Swin-T's first stage (722, 3, 49, 32) with the
   shift mask, fp32 and bf16, timed beside SDPA given the bias as a float
   mask, and random asymmetric biases at three small geometries; then
   keys shorter and longer than the queries, checked only (N_k in {1, 4,
   49, 130} under N_q in {17, 200, 1000}, and 300 against 17; d 32, 64,
   128; with a random (B, H, N_q, N_k) bias and without); O, LSE, dQ, dK,
   dV and dab held to the plain versions, two launches bitwise equal;
9. ViT-B/16 UPerNet serving at full width (``upernet_vit-b16_ln_mln``,
   seeded weights): 512x512 requests through ``make_inference_fn`` ->
   ``_finalize_views`` and ``make_state_fn`` -> ``sim_feat``, with the
   flash and similarity launches read around this phase only;
10. ViT card against CPU on one 256x256 image (``img_size=256``), TF32
   off;
11. ViT supervised training at full width: ``build_algorithm`` ->
   ``SupervisedTrainer.init_state`` -> ``make_train_step`` with AdamW and
   the ``adamw_40k`` schedule, 2 x 512x512 crops, fp32 and bf16 autocast,
   launches per step and s/iter; then one step card against CPU at 2 x
   128x128 (``img_size=128``), dropout off, TF32 off;
12. the attention microbench (``tools/attn_microbench_torch.py``) at its
   default shapes;
13. the leaf config's user path at full width on packed synthetic data
   (``tools/make_synthetic_data_torch.py``, ``tools/pack_dataset_torch.py``:
   8 Potsdam-like and 8 + 2 Vaihingen-like 1024x1024 tiles):
   ``train_segmentor`` for 30 iterations (batch 2 of 512x512 crops from the
   source and target pipelines, 4 loader threads, uint8 wire, AdamW
   ``adamw_40k`` over 30 iterations with its warmup scaled to them and
   20x the learning rate, so that 30 iterations from random weights learn,
   checkpoints at 15 and 30, whole-image 1024x1024 eval to mIoU at 30);
   a second run resumed from the checkpoint at 15, which must restore the
   state bitwise and take run A's 16th batch first; ``tools/test_torch.py``
   on the checkpoint at 30, whose mIoU must equal the in-loop one within
   0.01 points; the source decode loss of iterations 26-30 below that of
   1-5; 2 similarity forward and 1 backward launches an iteration; then
   s/iter, the loader stall and the pipelines' host ms per sample beside
   phase 7's bare step;
14. the Inria and SeasonNet leaf configs' user path at full width, each on
   a synthetic tree (``tools/make_synthetic_data_torch.py --layout inria``:
   3 1024x1024 tiles of each of the five cities, packed; ``--layout
   season_net``: 64 spring and 64 fall 120x120 uint16 TIFFs to train on,
   16 fall to evaluate, decoded from disk): ``train_segmentor`` for 30
   iterations at the config's batch and crop (2 x 512^2; 16 x 128^2), at
   phase 13's learning rate and scaled warmup, an eval at 30 with the test
   set pointed at the validation set, then ``tools/test_torch.py`` on the
   checkpoint, whose mIoU must equal the in-loop one within 0.01 points;
   every loss finite; 2 similarity forward and 1 backward launches an
   iteration (their shapes recorded); for Inria the source decode loss of
   iterations 26-30 below that of 1-5; for SeasonNet the loss printed and
   the per-channel range of its images as stored, read, clip-normalized
   and batched (ROADMAP C2); s/iter, the loader stall, the pipelines' host
   ms per sample and the image read ms per tile;
15. the rest of the UDA family at full width, each algorithm the leaf
   config with ``uda`` replaced by its JAX golden trace's config at
   ``feat_level`` 2 with the leaf config's blur and jitter probability
   (``uda_variants``): DACS, DACS with the feature distance and
   ``grad_mag``, PFST, PFSTV4, PGST, PGSTTRG, PGSTV4, PGSTMixFeat, FMDA and
   FMDAMix through ``build_algorithm`` -> ``init_state`` ->
   ``make_train_step`` for 2 warm-up and 3 timed steps on phase 7's batches
   (PFSTV4's with a clean view and its metas), PFSTV2 and PFSTV3 one step
   each: every log var finite, the similarity launches by shape as the
   step's code implies, s/iter beside phase 7's bare PFGST step; PGST and
   FMDA card against CPU as phase 8; PFSTV4 through
   ``tools/train_torch.py`` for 12 iterations on phase 13's packs with
   ``KeepOriImage`` in the target pipeline: every loss finite, the
   teacher run on ``target_img_ori``, its replayed logits and level-2 map
   equal to ``torch.rot90`` / ``torch.flip`` of the unreplayed ones by the
   batch's metas;
16. the domain-adaptor family at full width on the leaf model (its
   DeepLabV3+ R50-D8 and FCN auxiliary head, 6 classes; ``adaptor_variants``):
   DomainAdaptor, DomainAdaptorAdv (its discriminator, and the reference's
   generator / discriminator optimizer dict), DomainAdaptorV2 with
   EntropyLoss, FMDAAdaptor with FeatSimLoss on a synthetic level-3 map
   (2, 2048, 64, 64) and FMDAAdaptorV2 on a synthetic similarity map, and
   PFGST with LocalPseudoFeatLoss and PseudoLabelLoss as its aux losses,
   each through ``build_algorithm`` -> ``init_state`` -> ``make_train_step``
   for 2 warm-up and 3 timed steps on phase 7's batches: every log var
   finite, the student (and the discriminator) moved, the similarity
   launches by shape as the step's code implies, s/iter beside phase 7's
   bare PFGST step; DomainAdaptorAdv card against CPU as phase 8, under
   phase 15's limit; DomainAdaptor on a ``MultiDomainDataset`` of phase 13's
   packs through ``tools/train_torch.py`` for 6 iterations with an eval,
   a run resumed from its checkpoint at 3 (restored bitwise), and
   ``tools/test_torch.py`` on the last checkpoint to the in-loop mIoU;
(13b, run after 13) the source-only config (``BASELINE.json``'s config 2)
   and the Vaih->Pots PFGST config through ``train_segmentor`` on phase
   13's packs for 10 iterations each, an eval and ``tools/test_torch.py``
   on the checkpoint with equal mIoU within 0.01 points, every loss finite,
   their similarity launches;
17. the two-phase pseudo-label workflow at full width on phase 13's packs:
   the source-only config through ``train_segmentor`` with
   ``PseudoLabelingHookV4`` in ``custom_hooks``, which labels the 2
   Vaihingen validation tiles (level-3 features saved) from the latest
   checkpoint and halts the loop at its ``trigger_iter``; then
   ``tools/gen_pseudo_labels_torch.py`` on the halted checkpoint over the
   8 Vaihingen train tiles (no features) and the 2 validation tiles
   (``--save-feats --feat-levels 3 --mean-sim 0.6``); every file read back
   with the port's HDF5 reader (keys, shapes, dtypes, thresholds rising
   within [0, log C], finite sigmas), each ``gaussian_sim_feat_3`` against
   the plain version on the stored float16 features, the similarity
   forward launched once a tile with features at (1, 2048, 128, 128), the
   generator's seconds a tile by part; ``DomainAdaptor`` through
   ``train_segmentor`` with its Vaihingen branch labelled by
   ``LoadAnnotationsPseudoLabelsV2`` on the train corpus (the first
   batch's target labels the loader's, every loss finite);
   ``tools/compute_class_stats_torch.py`` on the Potsdam packs and the
   leaf config with ``rare_class_sampling`` through ``train_segmentor``
   (the classes drawn, the PFGST step's launches); ``similarity_histogram``
   on one batch of decoded features, cosine and gaussian, against the
   plain version (a value may change bins only within 1e-6 of an edge);
18. the hooks and writing predictions out, at full width on phase 13's
   packs: the Pots->Vaih leaf config through ``train_segmentor`` for 12
   iterations with ``TensorboardLoggerHook(interval=4)``,
   ``WandbHookSeg(interval=4)`` (through a stand-in ``wandb`` module that
   records what the hook gives it, so nothing reaches W&B's service; the
   step collects its visualisation states) and
   ``ProfilerHook(start_iter=4, num_steps=3)``: the event file decodes
   with every record's CRCs, and its scalars at iterations 4, 8 and 12
   equal the loop's log vars; the W&B payloads at 4, 8 and 12 hold the
   log vars and two 64x64 density maps copied from the card (the seg-mask
   triplets, full-resolution images beside head-resolution predictions,
   left out as the JAX hook leaves them); the trace holds CUDA kernel
   events, among
   them ``neighborhood_sim_kernel`` twice and ``neighborhood_sim_bwd_kernel``
   once for each profiled iteration, and its ten costliest device ops for
   one iteration are printed; the ``vis|`` states have the JAX step's
   shapes (in NCHW) and dtypes and lie on the card; the same 12
   iterations without the hooks (no ``collect_vis``), for s/iter with and
   without; ``tools/test_torch.py --format-only`` on the checkpoint writes
   one PNG for each tile of the test set (phase 13's: 8 Vaihingen tiles
   of 1024^2), each decoding to the label map ``single_gpu_test`` returns
   for it;
19. the transformer backbones with a relative-position bias at full
   width (``upernet_{beit,mae,swin}.py``, seeded weights): BEiT-B and
   MAE-B at 640^2 and Swin-T at 512^2 each answer 3 requests (logits ->
   labels, then ``make_state_fn``'s similarity; 24 flash forwards a
   request, all with ``ab``) and take 5 supervised steps at batch 2 with
   AdamW and the configs' drop path, in fp32 and then, on the same
   weights, in bf16 autocast (12 launches of each flash kernel a step,
   every table moved); BEiT, MAE and Swin card against CPU as phase 11 (128^2, BEiT at img_size 128, the
   same drop-path masks on both sides, every table with a non-zero
   gradient unless drop path dropped its branch for both images); BEiT
   UPerNet through ``train_segmentor`` on phase 13's packs (the
   source-only config's data, 512^2 crops, img_size 512, 6 classes) for
   10 iterations with a slide-mode evaluation (512^2 windows, stride 341)
   of the 1024^2 tiles, and ``tools/test_torch.py`` on its checkpoint;
20. A13's defs on the ViT and the ResNet at full width, each
   from its ``configs/_base_/models`` config as it stands with seeded
   weights (``A13_MODELS``): SETR naive, PUP and MLA (ViT-L/16) at
   768^2, Segmenter (ViT-B/16, 19 classes) and DPT (ViT-B/16, its 14^2
   position table resized to the grid) at 512^2, PSPNet (ResNetV1c-101,
   14 bands), Semantic FPN and ANN (both defs), SegFormer (MiT-B0: 8
   attention layers, keys on a 16^2 grid) and Twins PCPVT-S under
   UPerNet and Semantic FPN (16 attention layers, N_k = 16^2) at 512^2
   each, at the depth of the card-against-CPU checks below, answer 3
   requests (logits -> labels, then ``make_state_fn``'s
   similarity on the decoded features, at 1/4 of the request, 1/1 for
   SETR-PUP, 1/8 for PSPNet and ANN, 1/16 for Segmenter; 2 x the
   attention layers of flash forwards a request) and take 5 supervised
   steps at batch 2 with AdamW in fp32 and then, on the same weights, in
   bf16 autocast (each flash kernel once an attention layer a step);
   Segmenter, SETR-PUP, ANN, SegFormer and Twins-FPN card against CPU as
   phase 11 (128^2, TF32 off; MiT's stage 0 there: 32^2 queries, 4^2
   keys); then the CNN backbones' twelve defs the same way at 512^2, with
   no attention: UNet under FCN, DeepLabV3 and PSPNet (slide-mode
   requests, 256^2 windows at stride 170; features at 1/1), HRNet-W18
   under FCN and ConvNeXt-B under UPerNet (1/4), MobileNetV3-large under
   LR-ASPP (1/2), Fast-SCNN, CGNet, ERFNet, BiSeNetV1 (R18) and BiSeNetV2
   (1/8), and ICNet (ResNetV1c-50, 1/16); then the attention and
   context heads' twelve defs on the ResNetV1c-50 the same way at 512^2
   (features at 1/8): DANet (its steps with the PAM and CAM branch
   losses), NonLocal, GCNet, DNL, APCNet, DMNet, EMANet (its bases
   moving-averaged), ISANet, CCNet, PSANet (97^2 masks), EncNet (its
   steps with the SE loss) and FastFCN (JPU and PSP head);
   UNet-DeepLabV3, HRNet, ConvNeXt (drop path off there), LR-ASPP,
   ICNet, DANet, EncNet, EMANet, CCNet and PSANet card against CPU (the
   heads' 0-d ``gamma``s at 0.1 there; every card-against-CPU step of
   this phase at reduced depth, widths unchanged: ViTs of 2 layers (4 for
   SETR-PUP's four taps), one block a stage of the ResNets, MiT, PCPVT
   and ConvNeXt, one a branch of HRNet, one conv a UNet stage); then the
   cascades, K-Net and STDC
   the same way at 512^2: OCRNet on HRNet-W18 (features at 1/4) and on
   the ResNetV1c-50-D8 (1/8), PointRend on the ResNet-50 FPN (1/4; its
   requests refine the 2048 most uncertain coarse logits, its steps take
   the point loss), K-Net (1/8; three attention layers a forward on the
   flash kernels: 6 forwards a request, 3 launches of each kernel a step;
   its steps with the four stages' losses) and STDC (1/8; its steps with
   the OHEM-weighted CE and the boundary head's CE and Dice); OCRNet-R50,
   PointRend, K-Net and STDC card against CPU; ResNeXt-50 (32x4d),
   ResNeSt-50 and the timm name ``resnest50d`` each in place of the leaf
   config's ResNetV1c under its DeepLabV3+ head, one 512^2 request each;
   ``OHEMPixelSampler`` alone card against CPU at STDC's settings on
   2 x 19 x 512^2 logits, with its threshold and without (equal weights
   but at ties with the k-th value); phase 20's line gives each def's
   wall seconds and peak allocation;
21. quantization at full width: (a) every int8 layer of the qat leaf
   config's DeepLabV3+ R50-D8 on a 512^2 request, a Dense at ViT-B's MLP
   and ResNeXt-50's grouped layer-4 conv: the card route's int32 sums
   equal the float64 plain version on the same int8 operands on the
   card, element for element; (b) int8 serving card against CPU (TF32
   off, the CPU's calibrated scales) and (c) the QAT step card against
   CPU (128^2), each held as another rounding of the same program, since
   the int8 program turns any fp32 difference upstream of a quantizer
   into flipped int8 values downstream: (b)'s logit gap at most twice
   the CPU's int8-against-fp32 gap and its argmax disagreement at most
   twice the CPU int8's with fp32; (c) at phase 11's bounds or twice the
   CPU's own 1-vs-8-thread readings, whichever is larger; (d) the qat leaf
   config through ``train_segmentor`` on phase 13's packs (6 iterations,
   int8 evals in the loop, dynamic and with the scales of
   ``tools/calibrate_int8_torch.py``), each scored by ``tools/
   test_torch.py --quant-int8`` within 0.01 mIoU points; (e) ``tools/
   int8_microbench_torch.py`` (fp32, bf16 and int8 patches/s at batch 24
   of 512^2) and ``tools/benchmark_torch.py`` once;
22. data parallelism (``pfst_tpu_torch/parallel``): (a) the leaf
   config's PFGST step at full width (2 x 512^2) through
   ``make_sharded_train_step`` over an NCCL group of one rank, 3 steps
   against the plain step (twice) from the same state and generators,
   with PyTorch's deterministic algorithms on: each synchronisation
   leaves its inputs bitwise, and parameters, BN buffers and log vars
   equal the plain step's bitwise (where the plain step repeats itself
   bitwise; both max differences and any op without a deterministic
   kernel printed); (b) two gloo ranks sharing the card (``init_distributed``
   from torchrun's variables, this file with ``--ddp-rank``) against the
   same two ranks on the CPU, at 2 x 128^2 a rank, TF32 off: the PFGST
   step and OCRNet-R50-D8 with its norms made ``SyncBN`` (the
   reference's) under the supervised trainer, the first step's averaged
   log vars and gradients within phase 11's bounds beside the CPU's own
   1-vs-N-thread gap, and after each of 3 card steps the two ranks'
   modules bitwise equal; (c) ``tools/train_torch.py --launcher
   pytorch`` under torchrun with 2 gloo ranks on phase 13's packs (6
   iterations at full width, an evaluation through ``multi_gpu_test`` at
   the last): every logged loss finite, only rank 0's files in the work
   dir, 2 similarity forward and 1 backward launches a rank an
   iteration, the in-loop histograms equal ``single_gpu_test``'s on the
   checkpoint and ``tools/test_torch.py --launcher pytorch``'s mIoU
   equal to its, s/iter of the two processes sharing one GPU beside
   phase 13's;
23. the sharded modes on two gloo ranks sharing the card (this file with
   ``--gspmd-rank``, started before phase 22 and run beside it; the
   operations gloo stages through pinned host memory printed): (a) tensor parallelism, ``upernet_vit-b16_ln_mln`` at
   512^2, batch 2, tp 2 (6 heads a rank on the flash kernels), 3 fp32
   steps and one bf16 step against the single-process steps on the card
   (TF32 off): log vars within rtol 1e-3 and step 1's gradients within
   phase 11's bounds, the model ranks' replicated leaves bitwise equal
   after every step; (b) ZeRO-1 and ZeRO-3, the leaf config's PFGST step
   at 512^2 with one image a data rank against the single-process step at
   batch 2 (dropout off), phase 11's bounds, the AdamW moments' (and at
   level 3 the student's and teacher's) bytes a rank against whole, each
   run's peak allocation, the similarity launches a rank; (c) spatial
   inference of a 1024^2 request of the leaf config over the two ranks
   against the whole-image forward (logits within 1e-4 of the largest,
   labels equal where the top-2 margin exceeds that), then
   ``tools/test_torch.py --spatial 2 --launcher pytorch`` under torchrun
   on phase 13's packs with ``single_gpu_test``'s mIoU; (d) GPipe of
   ViT-B's 12 blocks as 2 stages of 6 at (4, 1025, 768) in 4
   microbatches against the blocks in sequence (output, input and
   parameter gradients within 1e-4 of the largest), and the MoE of 2
   ViT-B MLP experts on 1025 tokens a rank at ample capacity against the
   dense computation (1e-5) and at capacity factor 0.5 (the dropped
   tokens zero); (e) spatially sharded training, the leaf config's PFGST
   step at 1024x512 (twice the leaf's crop height), batch 2, SGD at a
   constant rate, sp 2: two steps, each from the single-process step's
   state, within phase 11's bounds of it (log vars, gradients, the
   changes of the parameters, BN statistics and EMA), the ranks bitwise
   equal, each rank's peak allocation below the single-process step's,
   2 + 1 similarity launches a rank a step; then ``tools/train_torch.py
   --sp 2 --launcher pytorch`` under torchrun for 2 iterations (beside
   (c)'s CLI): every rank's student equal to the checkpoint, which loads
   into the single-process port;
then a ``[phases]`` line with each phase's wall seconds, one
``{"kernels": [...]}`` line and the ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
import collections
import concurrent.futures
import contextlib
import copy
import gc
import glob
import importlib.util
import json
import os
import os.path as osp
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import types

import numpy as np
import torch
import torch.nn.functional as F

from pfst_tpu_torch.apis import (_finalize_views, build_algorithm,
                                 init_segmentor, make_inference_fn,
                                 make_state_fn, train_segmentor)
from pfst_tpu_torch.core import (build_optimizer, build_optimizers,
                                 load_checkpoint, restore_state)
from pfst_tpu_torch.core.checkpoint import state_dict_of
from pfst_tpu_torch.datasets import build_dataset
from pfst_tpu_torch.datasets.pipelines import ClipNormalize, imread
from pfst_tpu_torch.native import hostaug
from pfst_tpu_torch.models import build_train_model
from pfst_tpu_torch.models.backbones.beit import \
    relative_position_index as beit_index
from pfst_tpu_torch.models.backbones.beit import table_bias
from pfst_tpu_torch.models.backbones.swin import attn_mask as swin_mask
from pfst_tpu_torch.models.backbones.swin import \
    relative_position_index as swin_index
from pfst_tpu_torch.ops import neighborhood_sim as sim_module
from pfst_tpu_torch.ops import quant
from pfst_tpu_torch.ops import (build, cuda_flash_attention,
                                cuda_flash_attention_backward,
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq,
                                cuda_neighborhood_similarity,
                                cuda_neighborhood_similarity_backward,
                                torch_attention, torch_attention_backward,
                                torch_neighborhood_similarity,
                                torch_neighborhood_similarity_backward)
from pfst_tpu_torch.utils import Config

T_START = time.time()   # after the imports
PHASE_S = {}            # wall seconds of each phase, for the [phases] line
ROOT = osp.dirname(osp.abspath(__file__))
LEAF = osp.join(ROOT, 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')
VIT = osp.join(ROOT, 'configs', '_base_', 'models',
               'upernet_vit-b16_ln_mln.py')
SOURCE_ONLY = osp.join(ROOT, 'configs', 'pfst',
                       'source_only_pots_irrg_deeplabv3plus_r50-d8.py')
VAIH2POTS = osp.join(ROOT, 'configs', 'pfst',
                     'pfst_vaih_irrg2pots_irrg_deeplabv3plus_r50-d8.py')
ADAMW_40K = osp.join(ROOT, 'configs', '_base_', 'schedules',
                     'adamw_40k.py')
MICROBENCH = osp.join(ROOT, 'tools', 'attn_microbench_torch.py')
TOOLS = osp.join(ROOT, 'tools')
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor-core), dense
# bf16 and TF32 tensor-core peaks; fp32-accurate products on the tensor
# cores take three TF32 products each (3xTF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = 495e12 / 3
SIM_TOL = 1e-5
SIM_K, SIM_D, SIGMA = 3, 2, 30.0
# the PFGST loss's similarity at the SeasonNet config: 16 x 128^2 crops
# give decoded features (16, 512, 32, 32) (stride 4, downscale=1)
SEASON_NET_SIM_SHAPE = (16, 512, 32, 32)
# the similarity in the UDA family's losses (phase 15): the backbone's
# level-2 map (R50-D8 layer 3, 1024 channels at stride 8) nearest-resized
# to the head's logits (stride 4) at 2 x 512^2 crops
UDA_SIM_SHAPE = (2, 1024, 128, 128)
# (shape, sim_type): serving (1024^2 request, make_state_fn), the PFGST
# training loss (2 x 512^2 crops, pfgst_loss.py:95-109), the ViT
# UPerNet's decoded features at a 512^2 request, the SeasonNet config's
# training loss and the UDA family's (PFGST's and PFST's losses cosine, the
# adaptive one gaussian), and FMDAAdaptor's FeatSimLoss on a level-3 map
# (gaussian, phase 16)
FMDA_SIM_SHAPE = (2, 2048, 128, 128)
# and the pseudo-label generator's second pass (phase 17): one 1024^2
# tile's level-3 map, gaussian
PL_SIM_SHAPE = (1, 2048, 128, 128)
# and the two decoded-feature shapes of phase 20 farthest from the
# kernel's design: UNet's at stride 1 of a 512^2 request (262k pixels of
# 64 channels, 4 channels a warp) and HRNet-W18's at stride 4 (270
# channels, not a multiple of 16)
A13_SIM_SHAPES = ((1, 64, 512, 512), (1, 270, 128, 128))
SIM_CASES = [((1, 512, 128, 128), 'gaussian'), ((2, 512, 64, 64), 'cosine'),
             ((1, 768, 128, 128), 'gaussian'),
             (SEASON_NET_SIM_SHAPE, 'cosine'), (UDA_SIM_SHAPE, 'cosine'),
             (UDA_SIM_SHAPE, 'gaussian'), (FMDA_SIM_SHAPE, 'gaussian'),
             (PL_SIM_SHAPE, 'gaussian'), (A13_SIM_SHAPES[0], 'gaussian'),
             (A13_SIM_SHAPES[1], 'gaussian')]
# the similarity kernels' general geometry, small: (shape (B, C, H, W), k,
# d), each for both similarity types and input types: W past a 32-pixel
# segment, odd W (unaligned bf16 pairs), d = 2 with W a multiple of 8
# (the compile-time geometry), C leaving warps without channels or with a
# ragged last stage, k = 7 (8 warps a block) and d > 32 (windows side by
# side)
SIM_GEOMETRY_CASES = [((2, 20, 9, 37), 3, 1),
                      ((1, 70, 11, 64), 3, 2),
                      ((1, 8, 12, 40), 5, 1),
                      ((1, 20, 10, 33), 5, 2),
                      ((2, 36, 7, 48), 5, 2),
                      ((1, 12, 9, 20), 7, 1),
                      ((1, 10, 9, 24), 7, 2),
                      ((1, 3, 37, 70), 3, 33)]
# flash attention: (shape (B, heads, N, d), dtype, layout[, N_k]). 'qkv':
# q, k, v are the strided views of the ViT block's (B, N, 3, heads, d)
# projection, or with N_k (keys and values shorter or longer than the
# queries), of MiT's (B, N, heads, d) query and (B, N_k, 2, heads, d)
# key-value projections; 'contiguous': the microbench's separate (B,
# heads, N, d) tensors
FLASH_CASES = [((1, 12, 1025, 64), torch.float32, 'qkv'),
               ((1, 12, 1025, 64), torch.bfloat16, 'qkv'),
               ((2, 12, 1025, 64), torch.float32, 'qkv'),
               ((2, 12, 1025, 64), torch.bfloat16, 'qkv'),
               ((8, 12, 1024, 64), torch.bfloat16, 'contiguous'),
               ((8, 12, 4096, 64), torch.bfloat16, 'contiguous'),
               ((1, 2, 17, 64), torch.float32, 'qkv'),
               ((1, 2, 17, 64), torch.bfloat16, 'qkv'),
               # phase 20: ViT-L at 768^2 (one valid key in the last
               # block) and Segmenter's decoder, 32^2 patches + 19 classes
               ((2, 16, 2305, 64), torch.float32, 'qkv'),
               ((2, 16, 2305, 64), torch.bfloat16, 'qkv'),
               ((2, 12, 1043, 64), torch.float32, 'qkv'),
               ((2, 12, 1043, 64), torch.bfloat16, 'qkv'),
               # phase 20: K-Net's attention between its 19 kernels (8
               # heads over the 512-wide embedding), in a step's batch
               ((2, 8, 19, 64), torch.float32, 'qkv'),
               ((2, 8, 19, 64), torch.bfloat16, 'qkv')] + [
    # phase 20's spatial-reduction attention at 512^2, N_k = 16^2: MiT-B0
    # and PCPVT-S stage 0 (128^2 queries, sr 8), a middle MiT-B0 stage
    # (32^2 queries, 5 heads, sr 2)
    (shape, dtype, 'qkv', 256)
    for shape in ((2, 1, 16384, 32), (2, 1, 16384, 64), (2, 5, 1024, 32))
    for dtype in (torch.float32, torch.bfloat16)]
FLASH_FWD_TOL, FLASH_LSE_TOL, FLASH_BWD_TOL = 2e-5, 1e-5, 1e-4
# flash attention with the library's bias ab (``flash_bias``): (shape,
# dtype, layout, bias, timed). BEiT-B at 640^2 (N = 40 x 40 + 1, its table
# shared by the batch) and Swin-T's first stage at 512^2 with the shift
# mask (2 images of 19 x 19 windows of 49 tokens, d = 32), timed; random
# asymmetric biases at small general geometries, checked only; then
# (with a sixth entry, N_k) keys shorter and longer than the queries,
# checked only, with a random (B, H, N, N_k) bias and without (None)
FLASH_AB_CASES = [((2, 12, 1601, 64), torch.float32, 'qkv', 'beit', True),
                  ((2, 12, 1601, 64), torch.bfloat16, 'qkv', 'beit', True),
                  ((722, 3, 49, 32), torch.float32, 'qkv', ('swin', 133),
                   True),
                  ((722, 3, 49, 32), torch.bfloat16, 'qkv', ('swin', 133),
                   True)] + [
    (shape, dtype, layout, bias, False)
    for shape, layout, bias in (((2, 2, 17, 64), 'qkv', 'random'),
                                ((1, 3, 130, 32), 'qkv', 'shared'),
                                ((2, 1, 200, 128), 'contiguous', 'strided'))
    for dtype in (torch.float32, torch.bfloat16)] + [
    ((b, h, n, d), dtype, 'qkv', bias, False, nk)
    for i, (nk, n) in enumerate([(nk, n) for nk in (1, 4, 49, 130)
                                 for n in (17, 200, 1000)] + [(300, 17)])
    for b, h, d in [((2, 2, 64), (1, 3, 32), (2, 1, 128))[(i + i // 3) % 3]]
    for bias in ('random', None)
    for dtype in (torch.float32, torch.bfloat16)]
# phase 19: the transformer backbones with a relative-position bias
BEIT = osp.join(ROOT, 'configs', '_base_', 'models', 'upernet_beit.py')
MAE = osp.join(ROOT, 'configs', '_base_', 'models', 'upernet_mae.py')
SWIN = osp.join(ROOT, 'configs', '_base_', 'models', 'upernet_swin.py')
TF_MODELS = {'beit': (BEIT, (640, 640)), 'mae': (MAE, (640, 640)),
             'swin': (SWIN, (512, 512))}
TF_LAYERS = 12          # attention layers: BEiT-B, MAE-B, Swin-T (2+2+6+2)
N_TF_REQUESTS = 3
TF_TRAIN_STEPS = 5      # 3 warm-ups, then the median of 2
TF_CHECK_HW = (128, 128)
TF_LOOP_CROP, TF_LOOP_STRIDE = 512, 341     # slide-mode eval of 1024^2 tiles
# phase 20: A13's defs on the ViT and the ResNet: (request and crop size,
# attention layers a forward: the backbone's and Segmenter's decoder's,
# stride of the decoded features that the similarity kernel reads)
A13_MODELS = {'setr_naive': ((768, 768), 24, 4),
              'setr_pup': ((768, 768), 24, 1),
              'setr_mla': ((768, 768), 24, 4),
              'segmenter_vit-b16_mask': ((512, 512), 14, 16),
              'dpt_vit-b16': ((512, 512), 12, 4),
              'pspnet_r50-d8': ((512, 512), 0, 8),
              'fpn_r50': ((512, 512), 0, 4),
              'ann_r50-d8': ((512, 512), 0, 8),
              'annnet_r50-d8': ((512, 512), 0, 8),
              'segformer_mit-b0': ((512, 512), 8, 4),
              'twins_pcpvt-s_upernet': ((512, 512), 16, 4),
              'twins_pcpvt-s_fpn': ((512, 512), 16, 4),
              'fcn_unet_s5-d16': ((512, 512), 0, 1),
              'deeplabv3_unet_s5-d16': ((512, 512), 0, 1),
              'pspnet_unet_s5-d16': ((512, 512), 0, 1),
              'fcn_hr18': ((512, 512), 0, 4),
              'upernet_convnext': ((512, 512), 0, 4),
              'lraspp_m-v3-d8': ((512, 512), 0, 2),
              'fast_scnn': ((512, 512), 0, 8),
              'cgnet': ((512, 512), 0, 8),
              'erfnet_fcn': ((512, 512), 0, 8),
              'bisenetv1_r18-d32': ((512, 512), 0, 8),
              'bisenetv2': ((512, 512), 0, 8),
              'icnet_r50-d8': ((512, 512), 0, 16),
              **{name: ((512, 512), 0, 8) for name in (
                  'danet_r50-d8', 'nonlocal_r50-d8', 'gcnet_r50-d8',
                  'dnl_r50-d8', 'apcnet_r50-d8', 'dmnet_r50-d8',
                  'emanet_r50-d8', 'isanet_r50-d8', 'ccnet_r50-d8',
                  'psanet_r50-d8', 'encnet_r50-d8',
                  'fastfcn_r50-d32_jpu_psp')},
              # the cascades, K-Net (3 attention layers, one a stage) and
              # STDC
              'ocrnet_hr18': ((512, 512), 0, 4),
              'ocrnet_r50-d8': ((512, 512), 0, 8),
              'pointrend_r50': ((512, 512), 0, 4),
              'knet_s3_fcn': ((512, 512), 3, 8),
              'stdc': ((512, 512), 0, 8)}
A13_CHECKED = ('segmenter_vit-b16_mask', 'setr_pup', 'ann_r50-d8',
               'segformer_mit-b0', 'twins_pcpvt-s_fpn',
               'deeplabv3_unet_s5-d16', 'fcn_hr18', 'upernet_convnext',
               'lraspp_m-v3-d8', 'icnet_r50-d8', 'danet_r50-d8',
               'encnet_r50-d8', 'emanet_r50-d8', 'ccnet_r50-d8',
               'psanet_r50-d8', 'ocrnet_r50-d8', 'pointrend_r50',
               'knet_s3_fcn', 'stdc')
# phase 20: the last three backbones (A17), each in place of the leaf
# config's ResNetV1c under its DeepLabV3+ head, at output stride 8 where
# the backbone takes strides (one 512^2 forward each)
A17_BACKBONES = {
    'resnext50_32x4d': dict(type='ResNeXt', depth=50, groups=32,
                            base_width=4, strides=(1, 2, 1, 1),
                            dilations=(1, 1, 2, 4), contract_dilation=True),
    'resnest50': dict(type='ResNeSt', depth=50, radix=2,
                      strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                      contract_dilation=True),
    'timm_resnest50d': dict(type='TIMMBackbone', model_name='resnest50d')}
# phase 20: OHEM alone card against CPU, at STDC's settings and a step's
# logits (2 x 19 x 512^2)
OHEM_SHAPE, OHEM_CFG = (2, 19, 512, 512), dict(thresh=0.7, min_kept=10000)
# backbone settings of the card-against-CPU step: ConvNeXt-B's drop path
# (0.4 over 36 blocks) would drop some branch for both images of the batch
A13_CHECK_BACKBONE = {'upernet_convnext': dict(drop_path_rate=0.0)}
# phase 20's requests, steps and card-against-CPU checks run at this
# depth, every width as the def has it: ViTs of CHECK_VIT_LAYERS layers or
# as many as they tap (the last taps kept), one block a stage of
# ResNet-50/101, MiT, PCPVT and ConvNeXt, one block a branch of HRNet, one
# conv a UNet stage (``_check_depth``, ``_shallow_resnets``)
CHECK_VIT_LAYERS = 2
MODEL_DEFS = osp.join(ROOT, 'configs', '_base_', 'models')
# phase 21: the qat leaf config, (a)'s and (b)'s request, (c)'s crops and
# (d)'s iterations with their resume point
QAT_LEAF_NAME = 'qat_source_only_pots_irrg_deeplabv3plus_r50-d8'
QAT_LEAF = osp.join(ROOT, 'configs', 'pfst', f'{QAT_LEAF_NAME}.py')
QUANT_HW, QUANT_CHECK_HW = (512, 512), (128, 128)
QUANT_LOOP_ITERS, QUANT_RESUME = 6, 3
# phase 21 (b), (c): how many roundings' worth of difference the card's
# int8 and QAT results may show against the CPU's (``_quant_card_vs_cpu``)
QUANT_ROUNDINGS = 2.0
# the ViT configs' input normalization (ImageNet mean/std, RGB)
VIT_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
VIT_LAYERS = 12
N_VIT_REQUESTS = 4
VIT_HW, VIT_CHECK_HW, VIT_TRAIN_CHECK_HW = (512, 512), (256, 256), (128, 128)
VIT_TRAIN_STEPS = 8
N_REQUESTS = 6
REQUEST_HW = (1024, 1024)
BATCH, PATCH, THRESHOLD = 24, 512, 0.98
# the PFGST loss's similarity at the leaf config: 2 x 512^2 crops give
# decoded features (2, 512, 64, 64), cosine, k3 d2 (pfgst_loss.py:183-184)
BWD_SHAPE = (2, 512, 64, 64)
BWD_SHAPES = (BWD_SHAPE, SEASON_NET_SIM_SHAPE, UDA_SIM_SHAPE)
TRAIN_HW, TRAIN_STEPS, TRAIN_WARMUP = (512, 512), 8, 3
# phase 15: steps per algorithm (the first UDA_WARMUP untimed) and
# PFSTV4's iterations through the loop
UDA_STEPS, UDA_WARMUP, UDA_LOOP_ITERS = 5, 2, 12
# phase 16: FMDA's feature map in the batch (level 3 of R50-D8, 2048
# channels at stride 8 of a 512^2 crop, tools/gen_pseudo_labels.py:43) and
# its similarity at the logits' size; the DomainAdaptor loop's iterations
# and its resume point; phase 13b's iterations of each shipped config
ADAPTOR_FEAT_SHAPE = (2, 2048, 64, 64)
ADAPTOR_LOOP_ITERS, ADAPTOR_LOOP_RESUME = 6, 3
CONFIG_LOOP_ITERS = 10
# phase 17: the source-only run the pseudo-labelling hook halts (at
# PL_TRIGGER of PL_TRAIN_ITERS), the DomainAdaptor iterations on the corpus
# and the rare-class-sampling loop's iterations; the ratio the adaptor's
# loader keeps, the sigma search's target, the entropy thresholds' ratios,
# the RCS settings (DAFormer's) and the histogram's edge allowance
PL_TRAIN_ITERS, PL_TRIGGER, PL_ADAPT_ITERS, PL_RCS_ITERS = 12, 10, 4, 4
PL_RATIO, PL_MEAN_SIM, PL_NUM_CLASSES = 0.5, 0.6, 6
PL_RATIOS = (0.01, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5)
PL_RCS = dict(class_temp=0.01, min_crop_ratio=0.5, min_pixels=3000)
PL_HIST_EDGE = 1e-6
# isprs_data's Vaihingen tiles: train, validation
PL_TRAIN_TILES, PL_VAL_TILES = 8, 2
# phase 18: iterations of each run, the TensorBoard / W&B / log interval,
# the profiler's window (the iterations after HOOK_PROF_START), and the
# JAX step's visualisation states at the leaf config's batch 2 of 512^2
# crops (head logits at 1/4, the PFGST loss's downscale 0.5): name ->
# ((shape in the JAX step's NHWC, dtype kind), ...)
HOOK_ITERS, HOOK_INTERVAL, HOOK_PROF_START, HOOK_PROF_STEPS = 12, 4, 4, 3
_SEG_MASK = (((2, 512, 512, 3), 'f'), ((2, 512, 512), 'i'),
             ((2, 128, 128), 'i'))
HOOK_VIS = {'vis|seg_mask_src': _SEG_MASK, 'vis|seg_mask_mix': _SEG_MASK,
            'vis|density_sim_feat': (((2, 512, 512, 3), 'f'),
                                     ((2, 64, 64, 1), 'f'),
                                     ((2, 64, 64, 1), 'b'))}
# phase 15's card-vs-CPU norm limit as a multiple of the CPU's own
# 1-vs-N-thread gap, where that gap exceeds 1e-3: on the H100 the card's
# gap ran 1.26-1.37x the CPU's own for PFGST, PGST and FMDA
UDA_SELF_GAP_SCALE = 2.0
# the loss weights of the JAX golden traces (tests/test_pfgst_loss.py,
# tests/test_pfst_loss.py, tests/test_feat_sim_loss.py)
PFGST_WEIGHTS = {'src_pos': 0.1, 'src_neg': 0.1, 'sim_pos': 0.1,
                 'sim_neg': 0.1, 'src_pos_std': 0.1, 'src_neg_std': 0.1}
PFST_WEIGHTS = {'src_pos': 0.3, 'src_neg': 0.7, 'sim_pos': 0.5,
                'sim_neg': 1.3}
FS_WEIGHTS = {'src_pos': 0.3, 'src_neg': 0.2, 'sim_pos': 0.5,
              'sim_neg': 0.4}
CHECK_HW = (128, 128)
# the last BN scale of each residual block in the card-against-CPU step
RESIDUAL_SCALE = 0.25
# the card-against-CPU steps' learned residual scalars (DANet's PAM and
# CAM, CCNet): at their initial 0 their branches' convs get no gradient;
# at 0.25 the fp32 step itself is ill-conditioned (the CPU's gradient
# norm 4.7e-4 to 1.6e-3 off fp64 for DANet, 6.9e-4 for CCNet), at 0.1
# within 1.4e-4 (tools/grad_conditioning_torch.py)
GAMMA_SCALE = 0.1
# phase 13: iterations of run A, the checkpoint run B resumes from, the
# iterations whose source decode losses are compared, the samples timed
# per pipeline
LOOP_ITERS, LOOP_RESUME, LOOP_WINDOW, LOOP_SAMPLES = 30, 15, 5, 8
LOOP_MIOU_TOL = 1e-4    # 0.01 points of mIoU
# the learning rate of phase 13 against the config's 6e-5: from random
# weights, 30 iterations at 6e-5 do not lower the source loss beyond what
# the crops' class mix moves it by (it fell in 4 runs of 7 on the H100),
# at 6e-4 in 9 of 10, at 1.2e-3 in 4 of 4, by 0.42-0.54
LOOP_LR_SCALE = 20
# phase 14: the Inria and SeasonNet leaf configs, each on a synthetic tree
# written by tools/make_synthetic_data_torch.py with these arguments
# (Inria: 3 1024^2 tiles of each of its 5 cities, packed; SeasonNet: 64
# spring and 64 fall 120^2 uint16 TIFFs to train on, 16 fall to evaluate,
# read from disk), LOOP_ITERS iterations at LOOP_LR_SCALE each
EO_CONFIGS = {
    'inria': ('pfst_inria_da_deeplabv3plus_r50-d8.py',
              ['--layout', 'inria', '--num-train', '3', '--num-val', '1']),
    'season_net': ('pfst_season_net_sp2fa_deeplabv3plus_r50-d8.py',
                   ['--layout', 'season_net', '--size', '120',
                    '--num-train', '64', '--num-val', '16'])}

# phase 22: (a) PFGST steps over an NCCL group of one rank, (b) steps of
# the two gloo ranks on the card (the CPU's take one), (c) the train CLI's
# iterations under torchrun; the def whose norms (b) makes SyncBN (the
# reference's norm there); each process's time limit
DDP_STEPS, DDP_CARD_STEPS, DDP_ITERS = 3, 3, 6
DDP_SYNC_BN_DEF = osp.join(ROOT, 'configs', '_base_', 'models',
                           'ocrnet_r50-d8.py')
DDP_TIMEOUT_S = 300


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, reps):
    """Median of ``reps`` launches, each timed with its own CUDA events,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=20, calls=10):
    """Device time of ``fn``: a CUDA graph that captured ``calls`` calls
    back to back is replayed ``reps`` times; the mean time per call. The
    host path of the call is out of the way, and so is most of a replay's
    own launch cost (about 1 us on the H100, which a graph of one call
    would add to each)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this smoke test runs on the card')
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f'needs a Hopper card (sm_90), got sm_{cap}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device_count {torch.cuda.device_count()}')
    return card


def phase_build():
    """Both CUDA sources and the data pipeline's host kernels at once, one
    compiler each."""
    t0 = time.time()
    names = ('neighborhood_sim', 'flash_attention')
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(hostaug.lib)
        paths = list(pool.map(build.build, names))
        host.result()
    for name, path in zip(names, paths):
        build.load(name)
        log(f'[build] {osp.relpath(path, ROOT)}')
    log(f'[build] {osp.relpath(hostaug.library_path(), ROOT)}')
    log(f'[build] {len(names) + 1} libraries in {time.time() - t0:.1f} s')


def sim_bound(shape, dtype, sim_type):
    """Least time on the card: each input byte read once and each output
    byte written once (for cosine the per-pixel norms too, which the
    training path saves) over the HBM rate, against the fp32 operations
    (cosine: dot and |n|^2, 2 FMAs per neighbor-channel, plus |c|^2;
    gaussian: a subtract and an FMA) over the fp32 peak."""
    b, c, h, w = shape
    k2 = SIM_K * SIM_K
    nbytes = b * c * h * w * torch.finfo(dtype).bits // 8 + b * k2 * h * w * 4
    if sim_type == 'cosine':
        nbytes += b * h * w * 4
    per_px = k2 * c * 4 + 2 * c if sim_type == 'cosine' else k2 * c * 3
    flops = b * h * w * per_px
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def sim_errors(x, kernel_size, dilation, sim_type, sigma=SIGMA):
    """The forward kernel on ``x`` as its path calls it (the cosine,
    training, case also saves the per-pixel norms) against the plain
    version: the max |kernel - plain| and the norms' error against
    ``x.norm``, relative where the norm exceeds 1; ``ok`` when both are
    within ``SIM_TOL`` (a NaN fails)."""
    cosine = sim_type == 'cosine'
    out = cuda_neighborhood_similarity(x, kernel_size, dilation, sim_type,
                                       sigma, with_norms=cosine)
    ref = torch_neighborhood_similarity(x, kernel_size, dilation, sim_type,
                                        sigma)
    norm_err = 0.0
    if cosine:
        out, norms = out
        norm_ref = x.float().norm(dim=1)
        norm_err = float(((norms - norm_ref).abs()
                          / norm_ref.clamp(min=1.0)).max())
    err = float((out - ref).abs().max())
    return dict(max_abs_err=err, norm_rel_err=norm_err,
                ok=err <= SIM_TOL and norm_err <= SIM_TOL)


def phase_kernel_vs_plain():
    """Each forward case against its plain version (``sim_errors``), with
    its median time per call (the wrapper's host path included), its
    device time (``graph_ms``), the plain version's time and the
    bound."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape, sim_type in SIM_CASES:
        cosine = sim_type == 'cosine'
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to('cuda', dtype)

            def kernel():
                return cuda_neighborhood_similarity(
                    x, SIM_K, SIM_D, sim_type, SIGMA, with_norms=cosine)
            err = sim_errors(x, SIM_K, SIM_D, sim_type)
            torch.cuda.synchronize()
            ok = err.pop('ok')
            ms = cuda_time_ms(kernel, 30)
            device_ms = graph_ms(kernel)
            plain_ms = cuda_time_ms(lambda: torch_neighborhood_similarity(
                x, SIM_K, SIM_D, sim_type, SIGMA), 20)
            bound_ms, bound_by = sim_bound(shape, dtype, sim_type)
            case = dict(shape=list(shape), dtype=str(dtype).split('.')[-1],
                        sim_type=sim_type, **err, ms=ms, device_ms=device_ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
            log(f'[kernel] neighborhood_sim {case}')
            if not ok:
                raise AssertionError(f'kernel disagrees with its plain '
                                     f'version: {case}')
            cases.append(case)
    return cases


def sim_bwd_bound(shape, dtype, sim_type):
    """Least time of the backward: x read and grad_x written in x's type,
    sim and dL/dsim (and the cosine norms) read in fp32, over the HBM
    rate, against the fp32 operations of the gather (k*k FMAs, 2 k*k
    flops, per input element) over the fp32 peak."""
    b, c, h, w = shape
    k2 = SIM_K * SIM_K
    nbytes = 2 * b * c * h * w * torch.finfo(dtype).bits // 8 + \
        2 * b * k2 * h * w * 4
    if sim_type == 'cosine':
        nbytes += b * h * w * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = b * h * w * 2 * k2 * c / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def sim_bwd_errors(x, g, kernel_size, dilation, sim_type, sigma=SIGMA):
    """The backward kernel on ``x`` and dL/dsim ``g`` as the training path
    launches it (grad_x in x's type; sim and, for cosine, the norms from
    the forward kernel) against autograd of the plain forward and the
    plain gather backward, both in fp32 on the same input values. Limit
    per element: 1e-5 * max(1, max|ref|), plus for a bf16 grad_x its
    rounding, 2^-8 |ref|; a NaN fails, and so does a second launch on the
    same inputs that is not bitwise equal to the first. ``max_abs_err``
    is the raw max |kernel - autograd|. Returns the errors and the
    callables that phase 3b times: the kernel, autograd of the plain
    forward and the plain gather backward."""
    args = (kernel_size, dilation, sim_type, sigma)
    if sim_type == 'cosine':
        sim, norms = cuda_neighborhood_similarity(x, *args, with_norms=True)
    else:
        sim, norms = cuda_neighborhood_similarity(x, *args), None
    xf = x.float().requires_grad_()
    sim_ref = torch_neighborhood_similarity(xf, *args)
    (auto,) = torch.autograd.grad(sim_ref, xf, g, retain_graph=True)
    plain = torch_neighborhood_similarity_backward(
        xf.detach(), sim_ref.detach(), g, *args)

    def kernel():
        return cuda_neighborhood_similarity_backward(x, sim, g, *args,
                                                     norms=norms)
    out, again = kernel(), kernel()
    limit = 1e-5 * max(1.0, float(auto.abs().max()))
    rounding = 2.0**-8 if x.dtype == torch.bfloat16 else 0.0
    outf = out.float()
    excess = max(float(((outf - ref).abs() - rounding * ref.abs()).max())
                 for ref in (auto, plain))
    repeat = bool(torch.equal(out, again))
    err = dict(max_abs_err=float((outf - auto).abs().max()),
               err_beyond_rounding=excess, limit=limit,
               repeat_bitwise_equal=repeat,
               ok=excess <= limit and repeat
               and bool(torch.isfinite(outf).all()))
    fns = dict(kernel=kernel,
               plain=lambda: torch.autograd.grad(sim_ref, xf, g,
                                                 retain_graph=True),
               gather=lambda: torch_neighborhood_similarity_backward(
                   xf.detach(), sim_ref.detach(), g, *args))
    return err, fns


def phase_backward_vs_plain():
    """The backward kernel against its plain versions (``sim_bwd_errors``)
    at the training shapes (the ISPRS and Inria configs' and SeasonNet's),
    both similarity types and input types, with its
    time per call and on the device, the plain versions' times and the
    bound; then at the small general geometries of
    ``SIM_GEOMETRY_CASES``, checked only."""
    gen = torch.Generator().manual_seed(2)
    cases = []
    for shape in BWD_SHAPES:
        b, _, h, w = shape
        for sim_type in ('cosine', 'gaussian'):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=gen).to('cuda', dtype)
                g = torch.randn((b, SIM_K**2, h, w), generator=gen).cuda()
                err, fns = sim_bwd_errors(x, g, SIM_K, SIM_D, sim_type)
                torch.cuda.synchronize()
                ok = err.pop('ok')
                ms = cuda_time_ms(fns['kernel'], 30)
                device_ms = graph_ms(fns['kernel'])
                plain_ms = cuda_time_ms(fns['plain'], 20)
                gather_ms = cuda_time_ms(fns['gather'], 20)
                bound_ms, bound_by = sim_bwd_bound(shape, dtype, sim_type)
                case = dict(shape=list(shape),
                            dtype=str(dtype).split('.')[-1],
                            sim_type=sim_type, **err, ms=ms,
                            device_ms=device_ms, plain_ms=plain_ms,
                            plain_gather_ms=gather_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
                log(f'[kernel] neighborhood_sim backward {case}')
                if not ok:
                    raise AssertionError(f'backward kernel disagrees with '
                                         f'the plain version: {case}')
                cases.append(case)
                del fns
    geometry = []
    for shape, k, d in SIM_GEOMETRY_CASES:
        for sim_type in ('cosine', 'gaussian'):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=gen).to('cuda', dtype)
                g = torch.randn((shape[0], k * k, *shape[2:]),
                                generator=gen).cuda()
                err, _ = sim_bwd_errors(x, g, k, d, sim_type)
                ok = err.pop('ok')
                case = dict(shape=list(shape), k=k, d=d, sim_type=sim_type,
                            dtype=str(dtype).split('.')[-1], **err)
                if not ok:
                    raise AssertionError(f'backward kernel disagrees with '
                                         f'the plain version: {case}')
                geometry.append(case)
    log(f'[kernel] neighborhood_sim backward: {len(geometry)} general-'
        f'geometry cases within their limits, repeat launches bitwise '
        f'equal; max excess '
        f'{max(c["err_beyond_rounding"] - c["limit"] for c in geometry):.2e}'
        f' beyond the limit')
    return cases, geometry


def _flash_inputs(shape, dtype, layout, gen, nk=None):
    """q (B, H, N, d) and k, v (B, H, N_k, d) on the card (``nk`` None:
    N_k = N), in the case's layout (``FLASH_CASES``)."""
    b, h, n, d = shape
    if layout == 'qkv' and nk is None:
        qkv = torch.randn((b, n, 3, h, d), generator=gen).to('cuda', dtype)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    if layout == 'qkv':
        q = torch.randn((b, n, h, d), generator=gen).to('cuda', dtype)
        kv = torch.randn((b, nk, 2, h, d), generator=gen).to('cuda', dtype)
        return (q.transpose(1, 2), *kv.permute(2, 0, 3, 1, 4).unbind(0))
    return [torch.randn((b, h, m, d), generator=gen).to('cuda', dtype)
            for m in (n, nk or n, nk or n)]


def flash_bias(kind, shape, gen, device='cuda', nk=None):
    """An fp32 ``ab`` for a (B, H, N, D) case (against N_k = ``nk`` keys,
    N where None), in the kernels' order (added
    before the scale, so a model's bias over the scale), as the path gives
    it or random and asymmetric, the cases that show a layout slip:

    * 'beit': a BEiT table of normal draws through its relative-position
      index (N = Wh Ww + 1 on a square grid), (1, H, N, N): one table
      for every image, read with batch stride 0;
    * ('swin', hp): Swin's (N = 49) table bias plus the shift mask of an
      hp x hp padded grid, (B, H, 49, 49) over B / (hp / 7)^2 images;
    * 'shared': normal draws, (1, H, N, N_k); 'random': (B, H, N, N_k);
      'strided': 'random' read through a row stride of N_k + 3."""
    b, h, n, d = shape
    nk = nk or n
    scale = d**-0.5
    if kind == 'beit':
        side = int(round((n - 1)**0.5))
        index = torch.from_numpy(beit_index(side, side))
        table = torch.randn(((2 * side - 1)**2 + 3, h), generator=gen)
        ab = (table_bias(table, index) / scale)[None]
    elif isinstance(kind, tuple) and kind[0] == 'swin':
        hp = kind[1]
        table = torch.randn((13**2, h), generator=gen)
        bias = table_bias(table, torch.from_numpy(swin_index(7)))
        mask = torch.from_numpy(swin_mask(hp, hp, 7, 3))
        ab = ((bias[None] + mask[:, None]) / scale).repeat(
            b // mask.shape[0], 1, 1, 1)
    elif kind == 'shared':
        ab = torch.randn((1, h, n, nk), generator=gen) / scale
    elif kind == 'random':
        ab = torch.randn((b, h, n, nk), generator=gen) / scale
    elif kind == 'strided':
        ab = (torch.randn((b, h, n, nk + 3), generator=gen) / scale)[..., :nk]
    else:
        raise ValueError(f'unknown bias {kind}')
    return ab.to(device)


def flash_bounds(shape, dtype, ab_batches=None, nk=None):
    """Least times (ms, bound_by) of the forward, dK/dV and dQ kernels'
    functions for q of ``shape`` (B, H, N, d) against N_k = ``nk`` keys
    (N where None): each input read once and each output written once over the
    HBM rate, against the operations over the peak of the input type:
    bf16 at the tensor cores' 989 TFLOP/s; fp32 at 495 / 3 = 165 TFLOP/s,
    the tensor cores' rate for fp32-accurate products as 3xTF32, which is
    above the CUDA cores' 67, so no fp32 kernel can read faster than its
    bound. Forward:
    4 B H N N_k d flops (S = Q K^T and P V). The whole backward needs
    10 B H N N_k d (S recomputed, dP = dO V^T, dV, dK, dQ: 2 each), split
    6 : 4 here, dK/dV taking S, dV and dK and dQ taking dP and dQ. Bytes
    (q, O, dO, dQ of N rows, LSE and Di of N values; k, v, dK, dV of N_k
    rows): forward q, k, v, O and the fp32 LSE; dK/dV q, k, v, dO, LSE
    and Di in, dK and dV out; dQ the same inputs, dQ out. With a bias
    (``ab_batches``: the distinct batch slices of ``ab``, 1 for one table
    shared by every batch, else B) each kernel also reads the fp32 ab
    once, ``ab_batches * H * N * N_k * 4`` bytes, and dQ writes the fp32
    dab, ``B * H * N * N_k * 4``; its additions are not counted (N N_k
    against the products' 4 N N_k d a head)."""
    b, h, n, d = shape
    nk = nk or n
    elt = torch.finfo(dtype).bits // 8
    peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
            else TF32X3_FLOP_PER_S)
    mq, mk = b * h * n * d * elt, b * h * nk * d * elt
    stat = b * h * n * 4
    bias = 0 if ab_batches is None else ab_batches * h * n * nk * 4
    dab = 0 if ab_batches is None else b * h * n * nk * 4
    work = {'fwd': (2 * mq + 2 * mk + stat + bias, 4),
            'dkv': (2 * mq + 4 * mk + 2 * stat + bias, 6),
            'dq': (3 * mq + 2 * mk + 2 * stat + bias + dab, 4)}
    out = {}
    for kernel, (nbytes, per) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = per * b * h * n * nk * d / peak
        out[kernel] = (max(t_bytes, t_ops) * 1e3,
                       'bytes' if t_bytes >= t_ops else 'operations')
    return out


def flash_allowances(qf, kf, vf, gf, o, lse, scale, ab=None):
    """What bf16 kernels may differ by from the fp32 plain versions beyond
    the fp32 limits, propagated from the roundings they share with the
    TPU kernel: ``(O, dQ, dK, dV, dab)``, each shaped like its output,
    from the fp32 inputs' values, the plain fp32 ``o`` and ``lse``, dL/dO
    ``gf`` and the bias ``ab`` (None for none; dab's allowance then 0).
    eps = 2^-8 bounds one rounding to bf16 (2^-9 to nearest, doubled for
    the fp32 sums around it):

    * P rounded before P V: eps P|V| (O);
    * P^T rounded before P^T dO: eps P^T|dO| (dV);
    * dS^T s rounded before (dS^T s) Q: eps s |dS|^T |Q| (dK);
    * dS s rounded before (dS s) K: eps s |dS| |K| (dQ);
    * the bf16 O that Di = rowsum(dO O) reads (the library's backward
      reads its bf16 O too): |dDi| <= eps rowsum|O dO|, reaching dQ as
      s |dDi| P|K|, dK as s P^T(|dDi| |Q|) and the fp32 dab = s dS as
      s P |dDi|.

    ab adds no rounding of its own: it is fp32 on both sides. Each
    output's own rounding, eps |ref|, is ``flash_excess``'s."""
    eps = 2.0**-8
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(s * scale - lse[..., None]) if ab is None else \
        torch.exp((s + ab) * scale - lse[..., None])
    del s
    ddi = eps * (o.abs() * gf.abs()).sum(-1, keepdim=True)
    al_dab = 0.0 if ab is None else scale * p * ddi
    al_o = eps * torch.matmul(p, vf.abs())
    al_dq = scale * ddi * torch.matmul(p, kf.abs())
    al_dv = eps * torch.matmul(p.transpose(-1, -2), gf.abs())
    al_dk = scale * torch.matmul(p.transpose(-1, -2), ddi * qf.abs())
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds_abs = p.mul_(dp.sub_((o * gf).sum(-1, keepdim=True))).abs_()
    del dp
    al_dk += eps * scale * torch.matmul(ds_abs.transpose(-1, -2), qf.abs())
    al_dq += eps * scale * torch.matmul(ds_abs, kf.abs())
    return al_o, al_dq, al_dk, al_dv, al_dab


def flash_excess(got, ref, rounding, allowance):
    """max(|got - ref| - rounding |ref| - allowance): how far ``got`` lies
    beyond its own rounding and the propagated allowance; a NaN counts as
    infinitely far (Python's ``max`` over floats would skip it)."""
    return float(((got.float() - ref).abs() - rounding * ref.abs()
                  - allowance).nan_to_num(nan=float('inf')).max())


def flash_errors(q, k, v, g, scale, ab=None, repeat=False):
    """The three flash kernels on (q, k, v), the fp32 bias ``ab`` (or
    None) and dL/dO ``g`` against the plain versions, with the limits of
    phase 3c. Returns ``(o, lse, errors)``; ``errors`` holds each excess
    beyond its allowance next to its limit, the raw max |kernel - ref| of
    O and of dQ, dK, dV against autograd and, for bf16 input, for
    information, the max |kernel - plain| with the plain versions run in
    bf16. With ``ab``: dab (fp32, per batch) against the plain backward's
    and, summed over the batch where ``ab`` has one, against autograd's
    gradient of ``ab``, within dQ's ``FLASH_BWD_TOL * max(1, max|ref|)``
    beyond the propagated Di rounding. With ``repeat``: a second
    forward and backward must be bitwise equal to the first."""
    bf16 = q.dtype == torch.bfloat16
    rounding = 2.0**-8 if bf16 else 0.0
    o, lse = cuda_flash_attention(q, k, v, scale, ab)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ref, ref_lse = torch_attention(qf, kf, vf, scale, return_lse=True, ab=ab)
    spread = (flash_allowances(qf, kf, vf, gf, ref, ref_lse, scale, ab)
              if bf16 else (0.0,) * 5)
    err = dict(fwd_err=float((o.float() - ref).abs().max()),
               fwd_excess=flash_excess(o, ref, rounding, spread[0]),
               fwd_limit=FLASH_FWD_TOL * max(1.0, float(ref.abs().max())),
               lse_err=float(((lse - ref_lse).abs()
                              / ref_lse.abs().clamp(min=1.0)).max()))
    grads = cuda_flash_attention_backward(q, k, v, o, lse, g, scale, ab)
    xs = [t.clone().requires_grad_() for t in (qf, kf, vf)]
    if ab is not None:
        xs.append(ab.clone().requires_grad_())
    auto = torch.autograd.grad(
        torch_attention(*xs[:3], scale, ab=xs[3] if ab is not None
                        else None), xs, gf)
    plain = torch_attention_backward(qf, kf, vf, ref, ref_lse, gf, scale, ab)
    err['bwd_limit'] = FLASH_BWD_TOL * max(1.0, max(float(a.abs().max())
                                                    for a in auto[:3]))
    err['bwd_excess'] = max(
        flash_excess(got, r, rounding, e)
        for got, a, pl, e in zip(grads[:3], auto, plain, spread[1:4])
        for r in (a, pl))
    for name, got, a in zip(('dq_err', 'dk_err', 'dv_err'), grads, auto):
        err[name] = float((got.float() - a).abs().max())
    ok_dab = True
    if ab is not None:
        dab, al = grads[3], spread[4]
        shared = ab.shape[0] == 1 and dab.shape[0] > 1
        summed = dab.sum(0, keepdim=True) if shared else dab
        al_summed = al.sum(0, keepdim=True) if shared and bf16 else al
        err['dab_limit'] = FLASH_BWD_TOL * max(1.0,
                                               float(auto[3].abs().max()))
        err['dab_excess'] = max(flash_excess(dab, plain[3], 0.0, al),
                                flash_excess(summed, auto[3], 0.0,
                                             al_summed))
        err['dab_err'] = float((summed - auto[3]).abs().max())
        ok_dab = err['dab_excess'] <= err['dab_limit']
    del spread, auto, plain, xs
    if bf16:
        po, plse = torch_attention(q, k, v, scale, return_lse=True, ab=ab)
        err['fwd_err_plain_bf16'] = float((o.float() - po.float()).abs()
                                          .max())
        err['bwd_err_plain_bf16'] = max(
            float((a.float() - b.float()).abs().max()) for a, b in zip(
                grads[:3], torch_attention_backward(q, k, v, po, plse, g,
                                                    scale, ab)))
    if repeat:
        o2, lse2 = cuda_flash_attention(q, k, v, scale, ab)
        again = cuda_flash_attention_backward(q, k, v, o2, lse2, g, scale,
                                              ab)
        err['repeat_bitwise_equal'] = bool(
            torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(grads, again)))
        del o2, lse2, again
    err['ok'] = (err['fwd_excess'] <= err['fwd_limit']
                 and err['lse_err'] <= FLASH_LSE_TOL
                 and err['bwd_excess'] <= err['bwd_limit'] and ok_dab
                 and err.get('repeat_bitwise_equal', True))
    return o, lse, err


def sdpa_backward_ms(out, g):
    """Device time of SDPA's backward alone: the backward node that
    autograd would call for ``out`` (whichever backend SDPA chose), called
    directly under ``graph_ms``, so the forward stays outside the timed
    graph."""
    node = out.grad_fn

    def backward():
        with torch.no_grad():
            return node(g)
    return graph_ms(backward)


def phase_flash_vs_plain():
    """Each flash kernel against its plain version on the same inputs, as
    the path launches it (bf16 or fp32, q, k, v through their strides).

    Forward: O within ``FLASH_FWD_TOL * max(1, max|ref|)`` of the plain
    forward in fp32 on the same input values (fp32 sums in another
    order), plus for a bf16 O its rounding 2^-8 |ref|; LSE within
    ``FLASH_LSE_TOL * max(1, |ref|)``, elementwise: relative where |LSE|
    >= 1 and absolute below, where P = exp(S - LSE) sees the absolute
    error (at N_k = 1 the LSE is the one score q.k s, which may lie near
    0, where a relative bound measures only the cancellation in q.k).
    Backward: dQ, dK, dV against autograd of
    the plain fp32 forward and against ``torch_attention_backward``, on
    the same values and a random dL/dO, within ``FLASH_BWD_TOL * max(1,
    max|ref|)``: sums of N = 256 to 16384 fp32 terms in another order
    (the fp32 kernels measured <= 8.1e-6 as 3xTF32, <= 6.9e-7 as fp32
    FMAs on the CUDA cores). For bf16 input, each output's own
    rounding, 2^-8 |ref|, and the roundings that ``flash_allowances``
    propagates: P (forward), P^T and dS^T s (dK/dV), dS s (dQ), and the
    bf16 O that Di reads. ``max_abs_err`` is the raw max |kernel - ref|.
    SDPA is timed per call (forward; forward's autograd backward) and on
    the device (``library_device_ms``: forward, and its backward node
    alone)."""
    gen = torch.Generator().manual_seed(4)
    cases = []
    for shape, dtype, layout, *nk in FLASH_CASES:
        nk = nk[0] if nk else None
        q, k, v = _flash_inputs(shape, dtype, layout, gen, nk)
        g = torch.randn(shape, generator=gen).to('cuda', dtype)
        scale = shape[-1]**-0.5
        o, lse, err = flash_errors(q, k, v, g, scale)
        gf = g.float()
        di = (o.float() * gf).sum(-1).contiguous()
        ms = {'fwd': cuda_time_ms(lambda: cuda_flash_attention(
                  q, k, v, scale), 10),
              'dkv': cuda_time_ms(lambda: cuda_flash_attention_bwd_dkv(
                  q, k, v, g, lse, di, scale), 10),
              'dq': cuda_time_ms(lambda: cuda_flash_attention_bwd_dq(
                  q, k, v, g, lse, di, scale), 10)}
        device_ms = {
            'fwd': graph_ms(lambda: cuda_flash_attention(q, k, v, scale)),
            'dkv': graph_ms(lambda: cuda_flash_attention_bwd_dkv(
                q, k, v, g, lse, di, scale)),
            'dq': graph_ms(lambda: cuda_flash_attention_bwd_dq(
                q, k, v, g, lse, di, scale))}
        plain_fwd_ms = cuda_time_ms(lambda: torch_attention(q, k, v, scale),
                                    5)
        plain_bwd_ms = cuda_time_ms(lambda: torch_attention_backward(
            q, k, v, o, lse, g, scale), 5)
        lib_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 10)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*xs, scale=scale)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, xs, g, retain_graph=True), 10)
        lib_device_ms = {
            'fwd': graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale)),
            'bwd': sdpa_backward_ms(lib_out, g)}
        lib_bwd_op = lib_out.grad_fn.name()
        del xs, lib_out, di, o, lse
        bounds = flash_bounds(shape, dtype, nk=nk)
        ok = err.pop('ok')
        case = dict(shape=list(shape), kv_len=k.shape[2],
                    dtype=str(dtype).split('.')[-1],
                    layout=layout, **err, ms=ms, device_ms=device_ms,
                    plain_fwd_ms=plain_fwd_ms,
                    plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                    library_bwd_ms=lib_bwd_ms,
                    library_device_ms=lib_device_ms,
                    library_bwd_op=lib_bwd_op,
                    bound_ms={kk: b[0] for kk, b in bounds.items()},
                    bound_by={kk: b[1] for kk, b in bounds.items()})
        log(f'[kernel] flash_attention {case}')
        if not ok:
            raise AssertionError(f'flash kernels disagree with the plain '
                                 f'versions: {case}')
        cases.append(case)
        del q, k, v, g, gf
        torch.cuda.empty_cache()
    return cases


def phase_flash_bias_vs_plain():
    """Phase 3c with the bias, and keys shorter or longer than the
    queries: each flash kernel against its plain version on
    ``FLASH_AB_CASES``, O, LSE, dQ, dK, dV and (with a bias) dab within
    phase 3c's limits (``flash_errors``), two launches bitwise equal; the
    BEiT and
    Swin shapes timed as phase 3c times, with SDPA given the same bias as
    a float ``attn_mask`` (``ab * scale`` in q's type, after the scale
    where SDPA adds it; its backward with the mask's gradient) as the
    library's time, and the bound with ab's and dab's bytes."""
    gen = torch.Generator().manual_seed(19)
    cases = []
    for shape, dtype, layout, bias, timed, *nk in FLASH_AB_CASES:
        nk = nk[0] if nk else None
        q, k, v = _flash_inputs(shape, dtype, layout, gen, nk)
        g = torch.randn(shape, generator=gen).to('cuda', dtype)
        ab = None if bias is None else flash_bias(bias, shape, gen, nk=nk)
        scale = shape[-1]**-0.5
        o, lse, err = flash_errors(q, k, v, g, scale, ab, repeat=True)
        ok = err.pop('ok')
        case = dict(shape=list(shape), kv_len=k.shape[2],
                    dtype=str(dtype).split('.')[-1], layout=layout,
                    bias=str(bias),
                    ab_shape=None if ab is None else list(ab.shape), **err)
        if timed:
            case.update(_flash_bias_times(q, k, v, g, o, lse, ab, scale))
            bounds = flash_bounds(shape, dtype, ab.shape[0])
            case['bound_ms'] = {kk: b[0] for kk, b in bounds.items()}
            case['bound_by'] = {kk: b[1] for kk, b in bounds.items()}
        log(f'[kernel] flash_attention with ab {bias} {case}')
        if not ok:
            raise AssertionError(f'flash kernels with ab disagree with the '
                                 f'plain versions: {case}')
        cases.append(case)
        del q, k, v, g, ab, o, lse
        torch.cuda.empty_cache()
    return cases


def _flash_bias_times(q, k, v, g, o, lse, ab, scale):
    di = (o.float() * g.float()).sum(-1).contiguous()
    launch = {
        'fwd': lambda: cuda_flash_attention(q, k, v, scale, ab),
        'dkv': lambda: cuda_flash_attention_bwd_dkv(q, k, v, g, lse, di,
                                                    scale, ab),
        'dq': lambda: cuda_flash_attention_bwd_dq(q, k, v, g, lse, di, scale,
                                                  ab)}
    out = dict(ms={kk: cuda_time_ms(fn, 10) for kk, fn in launch.items()},
               device_ms={kk: graph_ms(fn) for kk, fn in launch.items()},
               plain_fwd_ms=cuda_time_ms(lambda: torch_attention(
                   q, k, v, scale, ab=ab), 3),
               plain_bwd_ms=cuda_time_ms(lambda: torch_attention_backward(
                   q, k, v, o, lse, g, scale, ab), 3))
    mask = (ab * scale).to(q.dtype).expand(q.shape[0], -1, -1, -1)
    out['library_fwd_ms'] = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=scale), 10)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    mx = mask.detach().requires_grad_()
    lib_out = F.scaled_dot_product_attention(*xs, attn_mask=mx, scale=scale)
    out['library_bwd_ms'] = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, xs + [mx], g, retain_graph=True), 10)
    out['library_device_ms'] = {
        'fwd': graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)),
        'bwd': sdpa_backward_ms(lib_out, g)}
    out['library_bwd_op'] = lib_out.grad_fn.name()
    return out


def _flash_counts():
    return (cuda_flash_attention.launches,
            cuda_flash_attention_bwd_dkv.launches,
            cuda_flash_attention_bwd_dq.launches)


def _reset_counts():
    cuda_flash_attention.launches = 0
    cuda_flash_attention_bwd_dkv.launches = 0
    cuda_flash_attention_bwd_dq.launches = 0
    cuda_neighborhood_similarity.launches = 0
    cuda_neighborhood_similarity_backward.launches = 0


def _request(cfg, seed, hw):
    """A normalized request image (the test pipeline's Normalize on a
    seeded random uint8 image of as many bands as the normalization
    has), NCHW on the card."""
    norm = cfg.img_norm_cfg
    img = np.random.RandomState(seed).randint(
        0, 256, (*hw, len(norm['mean'])), np.uint8)
    img = img.astype(np.float32)
    if norm.get('to_rgb'):
        img = img[..., ::-1]
    img = (img - np.asarray(norm['mean'], np.float32)) / \
        np.asarray(norm['std'], np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        img.transpose(2, 0, 1)[None]))


def phase_serving(cfg, model):
    infer = make_inference_fn(model)
    state_fn = make_state_fn(model)     # sim_cfg defaults: k3 d2 gaussian
    num_classes = model.num_classes
    imgs = [_request(cfg, seed, REQUEST_HW) for seed in range(N_REQUESTS)]
    torch.cuda.synchronize()
    cuda_neighborhood_similarity.launches = 0
    times = []
    for i, img in enumerate(imgs):
        t0 = time.time()
        img = img.cuda()
        logits = infer(img)
        labels = _finalize_views(model, [logits], [{'flip': False}],
                                 REQUEST_HW)
        states = state_fn(img)
        sim = states['sim_feat'].cpu()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        if labels.shape != REQUEST_HW or not (
                0 <= labels.min() and labels.max() < num_classes):
            raise AssertionError(f'request {i}: bad labels {labels.shape} '
                                 f'{labels.min()}..{labels.max()}')
        h, w = REQUEST_HW[0] // 8, REQUEST_HW[1] // 8
        if tuple(sim.shape) != (1, SIM_K**2, h, w) or \
                not torch.isfinite(sim).all() or \
                not (0 <= float(sim.min()) and float(sim.max()) <= 1):
            raise AssertionError(f'request {i}: bad sim_feat {sim.shape}')
        if not torch.isfinite(logits).all():
            raise AssertionError(f'request {i}: non-finite logits')
    launches = cuda_neighborhood_similarity.launches
    log(f'[serve] {N_REQUESTS} requests of {REQUEST_HW}: ms per request '
        f'{[round(t, 1) for t in times]}, kernel launches {launches}, '
        f'last sim_feat mean {float(sim.mean()):.6f}')
    if launches < 1:
        raise AssertionError('the serving path never launched the kernel')
    return launches, times


def phase_card_vs_cpu(cfg, model):
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = copy.deepcopy(model).cpu()
        img = _request(cfg, 100, (PATCH, PATCH))
        card_logits = make_inference_fn(model)(img.cuda()).cpu()
        cpu_logits = make_inference_fn(cpu_model)(img)
        # the serving default (gaussian, sigma 30) and cosine, which does
        # not saturate on the large features of random weights
        sims = {}
        for sim_type in ('gaussian', 'cosine'):
            sim_cfg = dict(sim_type=sim_type)
            sims[sim_type] = (
                make_state_fn(model, sim_cfg)(img.cuda())['sim_feat'].cpu(),
                make_state_fn(cpu_model, sim_cfg)(img)['sim_feat'])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    scale = float(cpu_logits.abs().max())
    logit_err = float((card_logits - cpu_logits).abs().max())
    agree = float((card_logits.argmax(1) == cpu_logits.argmax(1))
                  .float().mean())
    sim_err = max(float((card - cpu).abs().max())
                  for card, cpu in sims.values())
    sim_mean = {k: round(float(cpu.abs().mean()), 6)
                for k, (_, cpu) in sims.items()}
    log(f'[card-vs-cpu] 512x512: logit err {logit_err:.3e} '
        f'(limit {1e-3 * scale:.3e}), argmax agreement {agree:.6f}, '
        f'sim_feat err {sim_err:.3e} (mean |sim| {sim_mean})')
    if not (logit_err <= 1e-3 * scale and agree >= 0.999
            and sim_err <= 1e-4):
        raise AssertionError('card and CPU disagree')


def phase_pseudo_label(cfg, model, card):
    """Informational: the fused inference + pseudo-label pass of
    ``bench.py:50-61`` at batch 24, 512x512."""
    bf16_cfg = cfg.copy()
    bf16_cfg.model['dtype'] = 'bfloat16'
    bf16_model = init_segmentor(bf16_cfg)
    bf16_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((BATCH, 3, PATCH, PATCH), generator=gen).cuda()

    @torch.inference_mode()
    def fused(m):
        logits, _ = m.encode_decode(img)
        probs = torch.softmax(logits.float(), dim=1)
        pseudo_prob, pseudo_label = probs.max(dim=1)
        quality = (pseudo_prob >= THRESHOLD).float().mean()
        return pseudo_label, pseudo_prob, quality

    for name, m in (('fp32', model), ('bf16', bf16_model)):
        for _ in range(2):
            fused(m)
        torch.cuda.synchronize()
        steps, t0 = 5, time.time()
        for _ in range(steps):
            fused(m)
        torch.cuda.synchronize()
        rate = steps * BATCH / (time.time() - t0)
        log(f'[pseudo-label] {name} batch {BATCH} {PATCH}^2: '
            f'{rate:.2f} patches/s on {card}')


def _train_batch(cfg, seed, hw, device='cuda'):
    """A synthetic training batch on ``device`` (the card): source, target
    and strong target images (seeded uint8 noise, normalized as the
    pipeline does) and a source label map of 6 classes in 32x32 blocks with
    a band of 255 (the ignore label) across the top."""
    rs = np.random.RandomState(seed)
    norm = cfg.img_norm_cfg
    mean = np.asarray(norm['mean'], np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(norm['std'], np.float32).reshape(1, 3, 1, 1)

    def image():
        img = rs.randint(0, 256, (2, 3, *hw)).astype(np.float32)
        return torch.from_numpy((img - mean) / std).to(device)

    cells = rs.randint(0, 6, (2, hw[0] // 32, hw[1] // 32))
    gt = cells.repeat(32, axis=1).repeat(32, axis=2)
    gt[:, :hw[0] // 16] = 255
    return dict(img=image(),
                gt_semantic_seg=torch.from_numpy(gt).to(device),
                target_img=image(), target_img_strong_aug=image())


def _train_setup(cfg, device='cuda'):
    algo = build_train_model(cfg, device=device)
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizers(cfg.optimizer, cfg.get('lr_config'),
                          cfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    norm = cfg.img_norm_cfg
    return algo, state, algo.make_train_step(norm['mean'], norm['std'])


def _train_run(cfg, name, card):
    """TRAIN_STEPS steps at full width; returns (s/iter, launches of the
    forward and the backward kernel in the run)."""
    algo, state, step = _train_setup(cfg)
    gen = torch.Generator().manual_seed(3)
    probe = 'decode_head.conv_seg.weight'
    start = state.student.get_parameter(probe).detach().clone()
    torch.cuda.synchronize()
    retries = torch.cuda.memory_stats().get('num_alloc_retries', 0)
    collections = sum(g['collections'] for g in gc.get_stats())
    cuda_neighborhood_similarity.launches = 0
    cuda_neighborhood_similarity_backward.launches = 0
    times, enqueue = [], []
    for i in range(TRAIN_STEPS):
        batch = _train_batch(cfg, 1000 + i, TRAIN_HW)
        if i == 1:
            a = min(1.0 - 1.0 / (state.step + 1.0), algo.alpha)
            teacher0 = state.teacher.get_parameter(probe).detach().clone()
            student0 = state.student.get_parameter(probe).detach().clone()
        torch.cuda.synchronize()
        t0 = time.time()
        state, log_vars = step(state, batch, gen)
        enqueue.append(time.time() - t0)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        vals = {k: float(v) for k, v in log_vars.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f'[train {name}] step {i}: non-finite log '
                                 f'vars {vals}')
        if i == 1:
            want = teacher0 * a + student0 * (1.0 - a)
            got = state.teacher.get_parameter(probe)
            if not torch.allclose(got, want, rtol=1e-6, atol=1e-7):
                raise AssertionError(f'[train {name}] teacher is not the EMA '
                                     f'a={a}: max |diff| '
                                     f'{float((got - want).abs().max())}')
    launches = (cuda_neighborhood_similarity.launches,
                cuda_neighborhood_similarity_backward.launches)
    retries = torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries
    collections = sum(g['collections'] for g in gc.get_stats()) - collections
    moved = float((state.student.get_parameter(probe).detach() - start)
                  .abs().max())
    s_iter = statistics.median(times[TRAIN_WARMUP:])
    log(f'[train {name}] {TRAIN_STEPS} steps, batch 2 of {TRAIN_HW}: s/iter '
        f'{[round(t, 5) for t in times]}, median after {TRAIN_WARMUP} '
        f'warm-ups {s_iter:.4f} s on {card}; kernel launches fwd '
        f'{launches[0]} bwd {launches[1]}; host enqueue ms '
        f'{[round(t * 1e3, 1) for t in enqueue]}; allocator retries '
        f'{retries}; garbage collections {collections}; '
        f'student moved {moved:.3e}; '
        f'last log vars {json.dumps({k: round(v, 6) for k, v in vals.items()})}')
    if launches != (2 * TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f'[train {name}] expected {2 * TRAIN_STEPS} '
                             f'forward and {TRAIN_STEPS} backward kernel '
                             f'launches, got {launches}')
    if not moved > 0:
        raise AssertionError(f'[train {name}] the student did not change')
    return s_iter, launches


def phase_train(cfg, card):
    """Training at full width, fp32 (TF32 convolutions, the default) and
    bf16 autocast."""
    results = {}
    for name, dtype in (('fp32', None), ('bf16', 'bfloat16')):
        tcfg = cfg.copy()
        if dtype:
            tcfg.model['dtype'] = dtype
        results[name] = _train_run(tcfg, name, card)
        torch.cuda.empty_cache()
    return results


def _scale_residual(state, scale):
    """The last BN scale of every residual block set to ``scale`` (in the
    student and the teacher). At the JAX package's init (BN scales 1) the
    step's gradients are ill-conditioned in fp32: the CPU with one thread
    and with eight disagrees by more than the check's limits allow. A
    smaller nonzero scale tames that while every branch still gets a
    gradient."""
    with torch.no_grad():
        for m in state.student.modules():
            names = getattr(m, 'norm_names', None) or (
                [m.norm2_name] if hasattr(m, 'norm2_name') else [])
            if names:
                getattr(m, names[-1]).weight.fill_(scale)
        if state.teacher is not None:
            state.teacher.load_state_dict(state.student.state_dict())


def _nonzero_gammas(state, value):
    """Every 0-d ``gamma`` of the student set to ``value``, as
    ``_scale_residual`` sets the residual blocks' last BN scale."""
    with torch.no_grad():
        for name, p in state.student.named_parameters():
            if name.rsplit('.', 1)[-1] == 'gamma' and p.ndim == 0:
                p.fill_(value)


def _grad_groups(state):
    """The student's gradients (left on the parameters by the step) in
    fp64 on the CPU, by group: the stem, each ResNet stage, each head."""
    groups = {}
    for name, p in state.student.named_parameters():
        if p.requires_grad:
            parts = name.split('.')
            key = '.'.join(parts[:2]) if parts[0] == 'backbone' else parts[0]
            groups.setdefault(key, []).append(p.grad.double().cpu())
    return groups


def _cos_and_gap(a, b):
    cos = float(a @ b / (a.norm() * b.norm()))
    return cos, float(abs(a.norm() - b.norm()) / b.norm())


def phase_train_card_vs_cpu(cfg, tag='[train card-vs-cpu]',
                            self_gap_scale=None):
    """One step on the card and on the CPU from the same weights (the last
    BN scale of each residual block at ``RESIDUAL_SCALE``), batch and
    draws, dropout off, TF32 off: log vars within rtol 1e-3 (atol 1e-5);
    the student's gradients with cosine similarity >= 0.9999 and norms
    within 1e-3, over all parameters; every parameter tensor gets a
    nonzero gradient. Printed beside them: cosine and norm gap per group,
    and the same two readings for the CPU step with one thread against
    the CPU step with all of them, the step's own fp32 conditioning; with
    ``self_gap_scale`` the norm limit is the larger of 1e-3 and that
    multiple of this CPU gap (``_check_train_sides``)."""
    tcfg = cfg.copy()
    tcfg.model['decode_head']['dropout_ratio'] = 0.0
    tcfg.model['auxiliary_head']['dropout_ratio'] = 0.0
    batch = {k: v.cpu() for k, v in _train_batch(cfg, 7, CHECK_HW).items()}
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    sides = {}
    try:
        for side, device, n in (('card', 'cuda', threads),
                                ('cpu', 'cpu', threads), ('cpu1', 'cpu', 1)):
            torch.set_num_threads(n)
            _, state, step = _train_setup(tcfg, device)
            _scale_residual(state, RESIDUAL_SCALE)
            _, log_vars = step(state, {k: v.to(device)
                                       for k, v in batch.items()},
                               torch.Generator().manual_seed(5))
            sides[side] = ({k: float(v) for k, v in log_vars.items()},
                           _grad_groups(state))
    finally:
        torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    _check_train_sides(sides, threads,
                       f'{tag} {CHECK_HW}, residual scale '
                       f'{RESIDUAL_SCALE}', self_gap_scale)


def _check_train_sides(sides, threads, tag, self_gap_scale=None,
                       allowed_zero=0, roundings=None):
    """Card step against the CPU step (``sides``: log vars and gradient
    groups of 'card', 'cpu' and 'cpu1', the CPU with one thread): log vars
    within rtol 1e-3 (atol 1e-5); gradients with cosine similarity >=
    0.9999 and norms within 1e-3 over all parameters; no parameter tensor
    with a zero gradient. With ``self_gap_scale`` the norm limit is the
    larger of 1e-3 and ``self_gap_scale`` times the CPU's own 1-vs-N-thread
    norm gap: a step whose fp32 gradient norm the CPU itself reproduces
    only to more than 1e-3 (ROADMAP C6) is held to a multiple of that.
    ``allowed_zero``: parameter tensors a side may leave at a zero gradient
    (those under a residual branch that drop path dropped for every
    sample; the caller names and checks them). ``roundings`` (phase 21's
    QAT step, whose fake quantization makes any fp32 difference upstream
    of a quantizer another rounding, ``_quant_card_vs_cpu``): each limit
    is the larger of phase 11's and ``roundings`` times the CPU's own
    reading at another thread count (a log var's relative gap, 1 -
    cosine, the norm gap; the largest over the 'cpu<n>' sides, 1, 2 and 4
    threads against N). Returns the readings."""
    (card_lv, card_g), (cpu_lv, cpu_g) = sides['card'], sides['cpu']
    cpu1_g = sides['cpu1'][1]
    others = [v for k, v in sides.items() if k.startswith('cpu') and
              k != 'cpu']

    def lv_limit(k):
        own = max(abs(lv[k] - cpu_lv[k]) for lv, _ in others) / max(
            abs(cpu_lv[k]), 1e-30)
        return 1e-3 if roundings is None else max(1e-3, roundings * own)

    bad = {k: (card_lv[k], cpu_lv[k]) for k in cpu_lv
           if not abs(card_lv[k] - cpu_lv[k]) <= 1e-5 + lv_limit(k) *
           abs(cpu_lv[k])}
    zero = sum(int(not g.any()) for side in (card_g, cpu_g)
               for gs in side.values() for g in gs)
    per_group = {k: [round(v, 8) for v in _cos_and_gap(
        torch.cat([g.flatten() for g in card_g[k]]),
        torch.cat([g.flatten() for g in cpu_g[k]]))] for k in cpu_g}
    flat = {k: torch.cat([g.flatten() for gs in side.values() for g in gs])
            for k, side in (('card', card_g), ('cpu', cpu_g),
                            ('cpu1', cpu1_g))}
    cos, norm_rel = _cos_and_gap(flat['card'], flat['cpu'])
    self_cos, self_gap = _cos_and_gap(flat['cpu1'], flat['cpu'])
    norm_limit = 1e-3 if self_gap_scale is None else max(
        1e-3, self_gap_scale * self_gap)
    cos_limit = 0.9999
    if roundings is not None:
        own = [_cos_and_gap(torch.cat([g.flatten() for gs in o[1].values()
                                       for g in gs]), flat['cpu'])
               for o in others]
        norm_limit = max(norm_limit, roundings * max(g for _, g in own))
        cos_limit = min(cos_limit,
                        1 - roundings * max(1 - c for c, _ in own))
    log(f'{tag}: '
        f'log vars {len(cpu_lv)} compared, {len(bad)} outside rtol 1e-3; '
        f'gradient cosine {cos:.8f}, norm rel diff {norm_rel:.3e}; '
        f'parameter tensors with a zero gradient {zero}; per group '
        f'[cosine, norm gap] {json.dumps(per_group)}; loss card '
        f'{card_lv["loss"]:.6f} cpu {cpu_lv["loss"]:.6f}; CPU 1 thread '
        f'against {threads}: gradient cosine {self_cos:.8f}, norm rel diff '
        f'{self_gap:.3e}; norm limit {norm_limit:.3e}'
        + (f'; zero gradients allowed {allowed_zero} a side'
           if allowed_zero else '')
        + ('' if roundings is None else
           f'; {roundings} roundings of the CPU at 1, 2 and 4 threads: '
           f'cosine limit {cos_limit:.8f}, log var rtol '
           f'{json.dumps({k: float(f"{lv_limit(k):.3e}") for k in cpu_lv})}'))
    if bad or set(card_lv) != set(cpu_lv) or zero != 2 * allowed_zero or \
            not (
            cos >= cos_limit and norm_rel <= norm_limit):
        raise AssertionError(f'card and CPU training disagree: {bad}')
    return dict(outside=len(bad), cosine=round(cos, 8),
                norm_gap=float(f'{norm_rel:.3e}'),
                cpu_norm_gap=float(f'{self_gap:.3e}'), zero=zero)


def vit_config(img_size=VIT_HW[0], dtype=None):
    """The ViT-B/16 UPerNet config at full width and depth, for inputs of
    ``img_size`` (no position-embedding resize), with the ViT configs'
    input normalization."""
    cfg = Config.fromfile(VIT)
    cfg.img_norm_cfg = dict(VIT_NORM)
    cfg.model['backbone']['img_size'] = img_size
    if dtype:
        cfg.model['dtype'] = dtype
    return cfg


def phase_vit_serving(cfg, model):
    """512x512 requests: logits -> labels, then the feature state through
    the similarity kernel. Per request: 2 x 12 flash forwards (the two
    full forwards of make_inference_fn and make_state_fn), 1 similarity
    forward, no backward."""
    infer = make_inference_fn(model)
    state_fn = make_state_fn(model)
    imgs = [_request(cfg, 200 + seed, VIT_HW)
            for seed in range(N_VIT_REQUESTS)]
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for i, img in enumerate(imgs):
        t0 = time.time()
        img = img.cuda()
        logits = infer(img)
        labels = _finalize_views(model, [logits], [{'flip': False}], VIT_HW)
        sim = state_fn(img)['sim_feat'].cpu()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        h, w = VIT_HW[0] // 4, VIT_HW[1] // 4
        if labels.shape != VIT_HW or not (
                0 <= labels.min() and labels.max() < model.num_classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f'ViT request {i}: bad output')
        if tuple(sim.shape) != (1, SIM_K**2, h, w) or \
                not torch.isfinite(sim).all() or \
                not (0 <= float(sim.min()) and float(sim.max()) <= 1):
            raise AssertionError(f'ViT request {i}: bad sim_feat '
                                 f'{tuple(sim.shape)}')
    counts = _flash_counts()
    sim_launches = cuda_neighborhood_similarity.launches
    warm = statistics.median(times[1:])
    log(f'[vit serve] {N_VIT_REQUESTS} requests of {VIT_HW}: ms per '
        f'request {[round(t, 2) for t in times]}, warm median {warm:.2f}; '
        f'flash launches fwd/dkv/dq {counts}, similarity {sim_launches}')
    want = (2 * VIT_LAYERS * N_VIT_REQUESTS, 0, 0)
    if counts != want or sim_launches != N_VIT_REQUESTS:
        raise AssertionError(f'ViT serving launched flash {counts} (want '
                             f'{want}) and similarity {sim_launches}')
    return dict(flash=counts, sim=sim_launches, ms=times, warm_ms=warm)


def phase_vit_card_vs_cpu():
    """One 256x256 image, the model built at img_size 256, TF32 off:
    logits within 1e-3 max|logit|, argmax agreement >= 99.9 %."""
    cfg = vit_config(VIT_CHECK_HW[0])
    model = init_segmentor(cfg)
    cpu_model = copy.deepcopy(model).cpu()
    img = _request(cfg, 300, VIT_CHECK_HW)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_logits = make_inference_fn(model)(img.cuda()).cpu()
        cpu_logits = make_inference_fn(cpu_model)(img)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    scale = float(cpu_logits.abs().max())
    err = float((card_logits - cpu_logits).abs().max())
    agree = float((card_logits.argmax(1) == cpu_logits.argmax(1))
                  .float().mean())
    log(f'[vit card-vs-cpu] {VIT_CHECK_HW}: logit err {err:.3e} (limit '
        f'{1e-3 * scale:.3e}), argmax agreement {agree:.6f}')
    if not (err <= 1e-3 * scale and agree >= 0.999):
        raise AssertionError('ViT card and CPU disagree')


def _with_adamw_40k(cfg, dropout=True):
    """``cfg`` with the ``adamw_40k`` schedule (AdamW, poly with linear
    warmup, 40k iterations) composed in; ``dropout=False`` turns every
    head's dropout off (a list of auxiliary heads too)."""
    sched = Config.fromfile(ADAMW_40K)
    for key in ('optimizer', 'optimizer_config', 'lr_config', 'runner'):
        cfg[key] = sched[key]
    if not dropout:
        for head in _head_cfgs(cfg.model):
            head['dropout_ratio'] = 0.0
    return cfg


def _head_cfgs(model):
    """Every head config of ``model``: the decode head (a cascade's stages,
    K-Net's generate head too) and the auxiliary heads."""
    heads = []
    for node in (model['decode_head'], model.get('auxiliary_head') or []):
        heads += node if isinstance(node, list) else [node]
    return heads + [h['kernel_generate_head'] for h in heads
                    if h.get('kernel_generate_head')]


def _vit_train_cfg(img_size, dtype=None, dropout=True):
    """The ViT config with the ``adamw_40k`` schedule composed in."""
    return _with_adamw_40k(vit_config(img_size, dtype), dropout)


def _vit_train_setup(cfg, device='cuda'):
    algo = build_algorithm(cfg, device=device)
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizer(cfg.optimizer, cfg.get('lr_config'),
                         cfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    norm = cfg.img_norm_cfg
    return algo, state, algo.make_train_step(norm['mean'], norm['std'])


def _vit_batch(cfg, seed, hw, device='cuda'):
    """2 seeded uint8-noise images of the normalization's bands,
    normalized, and labels of the config's classes in 32x32 blocks with a
    band of 255 across the top, on ``device``."""
    rs = np.random.RandomState(seed)
    norm = cfg.img_norm_cfg
    mean = np.asarray(norm['mean'], np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(norm['std'], np.float32).reshape(1, -1, 1, 1)
    img = rs.randint(0, 256, (2, mean.shape[1], *hw)).astype(np.float32)
    num_classes = _head_cfgs(cfg.model)[0]['num_classes']
    cells = rs.randint(0, num_classes, (2, hw[0] // 32, hw[1] // 32))
    gt = cells.repeat(32, axis=1).repeat(32, axis=2)
    gt[:, :hw[0] // 16] = 255
    return dict(img=torch.from_numpy((img - mean) / std).to(device),
                gt_semantic_seg=torch.from_numpy(gt).to(device))


def _vit_train_run(name, dtype, card):
    """VIT_TRAIN_STEPS steps at full width on 2 x 512^2 crops; returns
    (s/iter, flash launches (fwd, dkv, dq) in the run)."""
    cfg = _vit_train_cfg(VIT_HW[0], dtype)
    _, state, step = _vit_train_setup(cfg)
    gen = torch.Generator().manual_seed(3)
    probe = 'decode_head.conv_seg.weight'
    start = state.student.get_parameter(probe).detach().clone()
    batches = [_vit_batch(cfg, 2000 + i, VIT_HW)
               for i in range(VIT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.time()
        state, log_vars = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        vals = {k: float(v) for k, v in log_vars.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f'[vit train {name}] step {i}: non-finite '
                                 f'log vars {vals}')
    counts = _flash_counts()
    moved = float((state.student.get_parameter(probe).detach() - start)
                  .abs().max())
    s_iter = statistics.median(times[TRAIN_WARMUP:])
    log(f'[vit train {name}] {VIT_TRAIN_STEPS} steps, batch 2 of {VIT_HW}: '
        f's/iter {[round(t, 4) for t in times]}, median after '
        f'{TRAIN_WARMUP} warm-ups {s_iter:.4f} s on {card}; flash launches '
        f'fwd/dkv/dq {counts}; moved {moved:.3e}; last log vars '
        f'{json.dumps({k: round(v, 6) for k, v in vals.items()})}')
    if counts != (VIT_LAYERS * VIT_TRAIN_STEPS,) * 3:
        raise AssertionError(f'[vit train {name}] expected '
                             f'{VIT_LAYERS} launches of each flash kernel '
                             f'per step, got {counts}')
    if not moved > 0:
        raise AssertionError(f'[vit train {name}] the model did not change')
    return s_iter, counts


def phase_vit_train(card):
    results = {}
    for name, dtype in (('fp32', None), ('bf16', 'bfloat16')):
        results[name] = _vit_train_run(name, dtype, card)
        torch.cuda.empty_cache()
    return results


def phase_vit_train_card_vs_cpu():
    """One supervised step on the card and on the CPU from the same
    weights and batch at 2 x 128^2 (img_size 128), dropout off, TF32 off,
    held as phase 8 holds the PFGST step."""
    _supervised_card_vs_cpu(
        _vit_train_cfg(VIT_TRAIN_CHECK_HW[0], dropout=False),
        VIT_TRAIN_CHECK_HW, '[vit train card-vs-cpu]')


def _supervised_card_vs_cpu(cfg, hw, tag, ctx=contextlib.nullcontext,
                            roundings=None):
    """One supervised step of ``cfg`` (dropout off) on the card and on
    the CPU (all threads, and one) from the same weights and batch at 2 x
    ``hw``, TF32 off, each step inside ``ctx()`` (phase 21's QAT
    context), held by ``_check_train_sides`` (with ``roundings``), its
    readings returned; a
    ResNet's residual blocks end at phase 8's BN scale
    (``_scale_residual``), and the heads' 0-d ``gamma``s are
    ``GAMMA_SCALE`` (``_nonzero_gammas``)."""
    batch = {k: v.cpu() for k, v in _vit_batch(cfg, 7, hw).items()}
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    sides = {}
    runs = [('card', 'cuda', threads), ('cpu', 'cpu', threads),
            ('cpu1', 'cpu', 1)]
    if roundings is not None:
        runs += [(f'cpu{n}', 'cpu', n) for n in (2, 4) if n < threads]
    try:
        for side, device, n in runs:
            torch.set_num_threads(n)
            _, state, step = _vit_train_setup(cfg, device)
            _scale_residual(state, RESIDUAL_SCALE)
            _nonzero_gammas(state, GAMMA_SCALE)
            with ctx():
                _, log_vars = step(state, {k: v.to(device)
                                           for k, v in batch.items()},
                                   torch.Generator().manual_seed(5))
            sides[side] = ({k: float(v) for k, v in log_vars.items()},
                           _grad_groups(state))
            del state, step
    finally:
        torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    return _check_train_sides(sides, threads, f'{tag} {hw}',
                              roundings=roundings)


def phase_microbench():
    """``tools/attn_microbench_torch.py`` at its default shapes."""
    spec = importlib.util.spec_from_file_location('attn_microbench_torch',
                                                  MICROBENCH)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    log('[microbench] shape, mode, naive / flash / library (SDPA) '
        'best/median ms, bf16')
    return bench.bench_rows()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(TOOLS, f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _loop_config(pots, vaih):
    """The leaf config on the synthetic roots: log every iteration,
    checkpoints every LOOP_RESUME, eval at LOOP_ITERS, ``adamw_40k``'s
    AdamW and poly schedule with the learning rate LOOP_LR_SCALE times the
    config's and the warmup (1500 of 40000) scaled to the run, and the
    test set pointed at the validation set so the two evaluations
    compare."""
    cfg = Config.fromfile(LEAF)
    warmup = round(cfg.lr_config['warmup_iters'] * LOOP_ITERS
                   / cfg.runner['max_iters'])
    cfg.merge_from_dict({
        'data.train.source.data_root': pots,
        'data.train.target.data_root': vaih,
        'data.val.data_root': vaih, 'data.test.data_root': vaih,
        'data.test.img_dir': cfg.data.val.img_dir,
        'data.test.ann_dir': cfg.data.val.ann_dir,
        'log_config.interval': 1,
        'checkpoint_config.interval': LOOP_RESUME,
        'evaluation.interval': LOOP_ITERS,
        'lr_config.warmup_iters': warmup,
        'optimizer.lr': cfg.optimizer['lr'] * LOOP_LR_SCALE})
    return cfg


def _pipeline_ms(cfg):
    """Host ms per sample of the source and target pipelines, each run
    alone in this thread on LOOP_SAMPLES samples."""
    from pfst_tpu_torch.apis.train import apply_device_normalize
    ds = build_dataset(apply_device_normalize(cfg.copy())
                       .data['train'])
    out = {}
    for name, sub in (('source', ds.source), ('target', ds.target)):
        times = []
        for i in range(LOOP_SAMPLES):
            t0 = time.perf_counter()
            sub[i % len(sub)]
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def _sim_counts():
    return (cuda_neighborhood_similarity.launches,
            cuda_neighborhood_similarity_backward.launches)


def _check_launches(name, counts, iters):
    if counts != (2 * iters, iters):
        raise AssertionError(f'[loop] {name}: expected {2 * iters} forward '
                             f'and {iters} backward similarity launches, '
                             f'got {counts}')


def _check_restored(cfg, path, resume=LOOP_RESUME, iters=LOOP_ITERS):
    """A state restored from ``path`` as ``train_segmentor`` restores it
    equals what the file holds, bitwise: the modules (student, teacher or
    discriminator), each optimizer's moments, step, LR schedule,
    accumulator and counters, and the step."""
    ckpt = load_checkpoint(path)
    algo = build_algorithm(cfg)
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizers(cfg.optimizer, cfg.get('lr_config'), iters,
                          opt_cfg.get('grad_clip'))
    state = restore_state(algo.init_state(torch.Generator().manual_seed(0),
                                          tx), ckpt)
    got, want = state_dict_of(state), ckpt['state_dict']
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    if got.keys() != want.keys():
        bad.append('key sets differ')
    n_moments = 0
    for opt, saved in ((state.optimizer, ckpt),
                       (getattr(state, 'disc_optimizer', None),
                        ckpt.get('disc_optimizer'))):
        if opt is None:
            continue
        opt_state = opt.optimizer.state_dict()['state']
        n_moments += sum(len(v) for v in opt_state.values())
        for i, entry in saved['optimizer']['state'].items():
            for k, v in entry.items():
                if not torch.equal(opt_state[i][k].cpu(), v):
                    bad.append(f'optimizer {i} {k}')
        if opt.scheduler.state_dict()['last_epoch'] != \
                saved['scheduler']['last_epoch'] or \
                opt.extra_state()['mini_step'] != \
                saved['optimizer_extra']['mini_step']:
            bad.append('schedule or accumulator')
    if state.step != resume:
        bad.append(f'step {state.step}')
    if bad:
        raise AssertionError(f'[loop] restore of {path} differs: {bad[:8]}')
    del state, algo
    torch.cuda.empty_cache()
    return len(want), n_moments


def isprs_data(root):
    """Phase 13's synthetic packs under ``root``: 8 Potsdam-like and 8 + 2
    Vaihingen-like 1024x1024 tiles; returns (pots, vaih, seconds)."""
    t0 = time.time()
    pots, vaih = osp.join(root, 'pots'), osp.join(root, 'vaih')
    synth, pack = (_tool('make_synthetic_data_torch'),
                   _tool('pack_dataset_torch'))
    synth.main(['-o', pots, '--num-train', '8', '--num-val', '0'])
    synth.main(['-o', vaih, '--num-train', '8', '--num-val', '2',
                '--seed', '1'])
    pack.main([root, '--recursive'])
    return pots, vaih, time.time() - t0


def phase_loop(card, bare_s_iter, data):
    """Phase 13: the leaf config through its entry points on the card, on
    the packs of ``isprs_data``."""
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix='pfst_loop_')
    try:
        pots, vaih, t_data = data
        cfg = _loop_config(pots, vaih)
        host_ms = _pipeline_ms(cfg)

        runs = {}
        for name, kwargs in (
                ('A', {}),
                ('B', dict(resume_from=osp.join(root, 'A',
                                                f'iter_{LOOP_RESUME}.pth'),
                           validate=False))):
            hist = []
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.time()
            train_segmentor(cfg.copy(), work_dir=osp.join(root, name),
                            max_iters_override=LOOP_ITERS, seed=0,
                            history=hist, **kwargs)
            torch.cuda.synchronize()
            runs[name] = dict(hist=hist, wall=time.time() - t0,
                              counts=_sim_counts())
            torch.cuda.empty_cache()
        a, b = runs['A']['hist'], runs['B']['hist']
        _check_launches('run A', runs['A']['counts'], LOOP_ITERS)
        _check_launches('run B', runs['B']['counts'],
                        LOOP_ITERS - LOOP_RESUME)
        n_tensors, n_moments = _check_restored(
            cfg, osp.join(root, 'A', f'iter_{LOOP_RESUME}.pth'))
        batches_a = {h['iter']: h['indices'] for h in a if h['kind'] ==
                     'batch'}
        first_b = next(h for h in b if h['kind'] == 'batch')
        if first_b['iter'] != LOOP_RESUME + 1 or \
                first_b['indices'] != batches_a[LOOP_RESUME + 1]:
            raise AssertionError(f'[loop] run B began with batch {first_b}, '
                                 f'run A took {batches_a[LOOP_RESUME + 1]}')

        loop_miou = next(h['metrics']['mIoU'] for h in a
                         if h['kind'] == 'eval')
        cfg_path = osp.join(root, 'loop_config.py')
        cfg.dump(cfg_path)
        t0 = time.time()
        res = _tool('test_torch').main([
            cfg_path, osp.join(root, 'A', f'iter_{LOOP_ITERS}.pth'),
            '--eval', 'mIoU'])
        t_test = time.time() - t0
        if abs(res['mIoU'] - loop_miou) > LOOP_MIOU_TOL + 1e-12:
            raise AssertionError(f'[loop] tools/test_torch.py mIoU '
                                 f'{res["mIoU"]} != in-loop {loop_miou}')

        logs = {h['iter']: h for h in a if h['kind'] == 'log'}
        loss = [logs[i]['log_vars']['decode.loss_ce']
                for i in range(1, LOOP_ITERS + 1)]
        first = statistics.mean(loss[:LOOP_WINDOW])
        last = statistics.mean(loss[-LOOP_WINDOW:])
        if not (np.isfinite(loss).all() and last < first):
            raise AssertionError(f'[loop] source decode loss did not fall: '
                                 f'{first:.4f} -> {last:.4f} ({loss})')
        times = [logs[i]['time'] for i in range(LOOP_WINDOW + 1,
                                                LOOP_ITERS + 1)]
        stall = [logs[i]['data'] for i in range(LOOP_WINDOW + 1,
                                                LOOP_ITERS + 1)]
        out = dict(
            s_iter_min=min(times), s_iter_median=statistics.median(times),
            s_iter_max=max(times), data_stall_median=statistics.median(stall),
            data_stall_max=max(stall), bare_step_s_iter=bare_s_iter,
            host_ms_per_sample=host_ms, loss_first=first, loss_last=last,
            miou_loop=loop_miou, miou_test=res['mIoU'],
            launches=runs['A']['counts'], launches_b=runs['B']['counts'],
            wall_a=runs['A']['wall'], wall_b=runs['B']['wall'],
            data_s=t_data, test_s=t_test)
        log(f'[loop] data: 18 tiles written and packed in {t_data:.1f} s; '
            f'restore of iter {LOOP_RESUME} bitwise ({n_tensors} tensors, '
            f'{n_moments} optimizer state tensors); run B began with run '
            f'A\'s batch {LOOP_RESUME + 1} {first_b["indices"]}')
        log(f'[loop] mIoU in the loop {loop_miou} / tools/test_torch.py '
            f'{res["mIoU"]} ({t_test:.1f} s); source decode loss '
            f'iterations 1-{LOOP_WINDOW} {first:.4f} -> '
            f'{LOOP_ITERS - LOOP_WINDOW + 1}-{LOOP_ITERS} {last:.4f}; '
            f'similarity launches run A {runs["A"]["counts"]} run B '
            f'{runs["B"]["counts"]}')
        log(f'[loop] s/iter past iteration {LOOP_WINDOW}: min '
            f'{out["s_iter_min"]:.4f} median {out["s_iter_median"]:.4f} max '
            f'{out["s_iter_max"]:.4f} (per iteration '
            f'{[round(t, 4) for t in times]}); bare step (phase 7, fp32) '
            f'{bare_s_iter:.4f} on {card}')
        log(f'[loop] data stall s/iter: median {out["data_stall_median"]:.4f}'
            f' max {out["data_stall_max"]:.4f} '
            f'({[round(t, 4) for t in stall]}); host ms per sample alone: '
            f'source {host_ms["source"]:.1f}, target {host_ms["target"]:.1f}; '
            f'run A {runs["A"]["wall"]:.1f} s, run B {runs["B"]["wall"]:.1f} '
            f's, phase {time.time() - t_phase:.1f} s')
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


class _ShapeRecorder:
    """Stands in for a kernel wrapper in its module, counting the input
    shapes and dtypes it is called with; its ``launches`` is the wrapper's
    own, so the wrapper's count goes on as before."""

    def __init__(self, fn):
        self.fn = fn
        self.shapes = collections.Counter()

    def __call__(self, x, *args, **kwargs):
        self.shapes[(tuple(x.shape), str(x.dtype).split('.')[-1])] += 1
        return self.fn(x, *args, **kwargs)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def _sim_shapes():
    """The shapes each similarity kernel is called with inside the
    block."""
    names = ('cuda_neighborhood_similarity',
             'cuda_neighborhood_similarity_backward')
    recorders = {n: _ShapeRecorder(getattr(sim_module, n)) for n in names}
    for n, r in recorders.items():
        setattr(sim_module, n, r)
    try:
        yield {n.split('_', 1)[1]: r.shapes for n, r in recorders.items()}
    finally:
        for n, r in recorders.items():
            setattr(sim_module, n, r.fn)


def _eo_config(name, root):
    """A leaf config of phase 14 on its synthetic tree: log every
    iteration, a checkpoint and an eval at LOOP_ITERS, ``adamw_40k`` with
    the learning rate LOOP_LR_SCALE times the config's and the warmup
    scaled to the run, and the test set pointed at the validation set."""
    cfg = Config.fromfile(osp.join(ROOT, 'configs', 'pfst',
                                   EO_CONFIGS[name][0]))
    warmup = round(cfg.lr_config['warmup_iters'] * LOOP_ITERS
                   / cfg.runner['max_iters'])
    cfg.merge_from_dict({
        'data.train.source.data_root': root,
        'data.train.target.data_root': root, 'data.val.data_root': root,
        'log_config.interval': 1, 'checkpoint_config.interval': LOOP_ITERS,
        'evaluation.interval': LOOP_ITERS, 'lr_config.warmup_iters': warmup,
        'optimizer.lr': cfg.optimizer['lr'] * LOOP_LR_SCALE})
    cfg.data['test'] = copy.deepcopy(cfg.data['val'])
    return cfg


def _read_ms(dataset):
    """Median ms of ``imread`` (the pipeline's colour read: a pack, or the
    file's decoder) per image of ``dataset``, over up to LOOP_SAMPLES."""
    times = []
    for info in dataset.img_infos[:LOOP_SAMPLES]:
        t0 = time.perf_counter()
        imread(info['filename'])
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _channel_ranges(cfg, n):
    """Per channel, the (min, max) of the source's first file as stored,
    as read (8-bit) and after the config's ClipNormalize, and over ``n``
    samples of the pipeline's output images, which the train step
    takes."""
    ds = build_dataset(cfg.data['train']).source
    path = ds.img_infos[0]['filename']
    raw, read = imread(path, unchanged=True), imread(path)
    clipped = ClipNormalize(**cfg.img_norm_cfg)(dict(img=read))['img']
    imgs = np.stack([ds[i % len(ds)]['img'] for i in range(n)])

    def ranges(a, axis):
        return [[float(v) for v in pair] for pair in
                zip(a.min(axis=axis), a.max(axis=axis))]
    return dict(stored=ranges(raw, (0, 1)), read=ranges(read, (0, 1)),
                clip_normalized=ranges(clipped, (0, 1)),
                batch=ranges(imgs, (0, 2, 3)))


def _eo_run(name, card):
    """One leaf config of phase 14 through ``train_segmentor`` and
    ``tools/test_torch.py``; returns its numbers."""
    t0 = time.time()
    root = tempfile.mkdtemp(prefix=f'pfst_{name}_')
    try:
        _tool('make_synthetic_data_torch').main(['-o', root]
                                                + EO_CONFIGS[name][1])
        if name == 'inria':
            _tool('pack_dataset_torch').main([root, '--recursive'])
        t_data = time.time() - t0
        cfg = _eo_config(name, root)
        host_ms = _pipeline_ms(cfg)
        ds = build_dataset(cfg.data['train'])
        read_ms = _read_ms(ds.source)
        batch = cfg.data['samples_per_gpu']
        ranges = _channel_ranges(cfg, batch) if name == 'season_net' \
            else None
        hist = []
        torch.cuda.synchronize()
        _reset_counts()
        t_run = time.time()
        with _sim_shapes() as shapes:
            train_segmentor(cfg.copy(), work_dir=osp.join(root, 'run'),
                            max_iters_override=LOOP_ITERS, seed=0,
                            history=hist)
        torch.cuda.synchronize()
        counts, wall = _sim_counts(), time.time() - t_run
        _check_launches(name, counts, LOOP_ITERS)
        logs = {h['iter']: h for h in hist if h['kind'] == 'log'}
        bad = [(i, k) for i, h in logs.items()
               for k, v in h['log_vars'].items() if not np.isfinite(v)]
        if len(logs) != LOOP_ITERS or bad:
            raise AssertionError(f'[eo] {name}: {len(logs)} log lines, '
                                 f'non-finite losses {bad[:8]}')
        loop_miou = next(h['metrics']['mIoU'] for h in hist
                         if h['kind'] == 'eval')
        cfg_path = osp.join(root, 'config.py')
        cfg.dump(cfg_path)
        t_test = time.time()
        res = _tool('test_torch').main([
            cfg_path, osp.join(root, 'run', f'iter_{LOOP_ITERS}.pth'),
            '--eval', 'mIoU'])
        t_test = time.time() - t_test
        if abs(res['mIoU'] - loop_miou) > LOOP_MIOU_TOL + 1e-12:
            raise AssertionError(f'[eo] {name}: tools/test_torch.py mIoU '
                                 f'{res["mIoU"]} != in-loop {loop_miou}')
        loss = [logs[i]['log_vars']['decode.loss_ce']
                for i in range(1, LOOP_ITERS + 1)]
        first = statistics.mean(loss[:LOOP_WINDOW])
        last = statistics.mean(loss[-LOOP_WINDOW:])
        if name == 'inria' and not last < first:
            raise AssertionError(f'[eo] {name}: source decode loss did not '
                                 f'fall: {first:.4f} -> {last:.4f} ({loss})')
        window = range(LOOP_WINDOW + 1, LOOP_ITERS + 1)
        times = [logs[i]['time'] for i in window]
        stall = [logs[i]['data'] for i in window]
        out = dict(
            s_iter_min=min(times), s_iter_median=statistics.median(times),
            s_iter_max=max(times), s_iter_mean=statistics.mean(times),
            data_stall_median=statistics.median(stall),
            data_stall_max=max(stall), host_ms_per_sample=host_ms,
            read_ms_per_tile=read_ms, loss_first=first, loss_last=last,
            miou_loop=loop_miou, miou_test=res['mIoU'], launches=counts,
            shapes={k: {str(s): n for s, n in v.items()}
                    for k, v in shapes.items()},
            channel_ranges=ranges, batch=batch, wall=wall, data_s=t_data,
            test_s=t_test)
        log(f'[eo] {name}: data written in {t_data:.1f} s; mIoU in the loop '
            f'{loop_miou} / tools/test_torch.py {res["mIoU"]} '
            f'({t_test:.1f} s); similarity launches {counts} in '
            f'{LOOP_ITERS} iterations, at {out["shapes"]}')
        log(f'[eo] {name}: source decode loss iterations 1-{LOOP_WINDOW} '
            f'{first:.4f} -> {LOOP_ITERS - LOOP_WINDOW + 1}-{LOOP_ITERS} '
            f'{last:.4f} (per iteration {[round(v, 4) for v in loss]})')
        if ranges is not None:
            log(f'[eo] {name}: per-channel (min, max) of the first source '
                f'file as stored {ranges["stored"]}, as read (8-bit) '
                f'{ranges["read"]}, after ClipNormalize '
                f'{ranges["clip_normalized"]}, and of a batch of {batch} '
                f'pipeline outputs {ranges["batch"]} (ROADMAP C2: '
                f'ClipNormalize takes the 8-bit read against the raw-scale '
                f'mean/std)')
        log(f'[eo] {name}: s/iter past iteration {LOOP_WINDOW}: min '
            f'{out["s_iter_min"]:.4f} median {out["s_iter_median"]:.4f} max '
            f'{out["s_iter_max"]:.4f} mean {out["s_iter_mean"]:.4f} (per '
            f'iteration {[round(t, 4) for t in times]}) at batch {batch}; '
            f'data stall s/iter '
            f'median {out["data_stall_median"]:.4f} max '
            f'{out["data_stall_max"]:.4f}; host ms per sample alone: source '
            f'{host_ms["source"]:.2f}, target {host_ms["target"]:.2f}; image '
            f'read ms per tile {read_ms:.3f} '
            f'({"TIFF decode" if name == "season_net" else "pack"}); run '
            f'{wall:.1f} s on {card}')
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_eo(card):
    """Phase 14: the Inria and SeasonNet leaf configs through their entry
    points on the card."""
    out = {}
    for name in EO_CONFIGS:
        out[name] = _eo_run(name, card)
        torch.cuda.empty_cache()
    return out


def uda_variants(leaf_uda):
    """Phase 15's algorithms: each the config of its JAX golden trace
    (``tests/test_*_golden_trace.py::_uda_cfg``; DACS's that of
    ``tests/test_uda_golden_trace.py::test_dacs_one_iteration_golden_trace``)
    with ``feat_level`` 2, the reference default, and the leaf config's
    ``blur`` and jitter probability."""
    base = dict(alpha=0.999, pseudo_threshold=0.35,
                pseudo_weight_ignore_top=0, pseudo_weight_ignore_bottom=0,
                imnet_feature_dist_lambda=0, mix='class',
                blur=leaf_uda['blur'], color_jitter_strength=0.2,
                color_jitter_probability=leaf_uda['color_jitter_probability'],
                trg_loss_weight=1.0)
    pfgst = dict(type='PFGSTLoss', kernel_size=3, dilation=2, top_k=3,
                 weights=PFGST_WEIGHTS, sim_type='cosine', feat_level=2,
                 detach_unfold=True, downscale=None)
    pfst = dict(type='PFSTLoss', kernel_size=3, dilation=2, top_k=3,
                weights=PFST_WEIGHTS, sim_type='cosine', feat_level=2)
    fs = dict(type='AdaptiveFeatSimLoss', kernel_size=3, dilation=1, top_k=2,
              weights=FS_WEIGHTS, sigma=5.0, sim_type='gaussian',
              feat_level=2, apply_ignore=True)
    return {
        'DACS': dict(base, type='DACS'),
        'DACS-fdist': dict(base, type='DACS', imnet_feature_dist_lambda=0.005,
                           imnet_feature_dist_classes=[2, 3],
                           print_grad_magnitude=True),
        'PFST': dict(base, type='PFST', aux_losses=[pfst]),
        'PFSTV2': dict(base, type='PFSTV2', aux_losses=[pfst]),
        'PFSTV3': dict(base, type='PFSTV3', aux_losses=[pfst]),
        'PFSTV4': dict(base, type='PFSTV4', trg_loss_weight=0.5, feat_level=2,
                       aux_losses=[dict(pfst, weights=PFGST_WEIGHTS,
                                        sigma=30.0)]),
        'PGST': dict(base, type='PGST', feat_level=2, aux_losses=[pfgst]),
        'PGSTTRG': dict(base, type='PGSTTRG', aux_losses=[fs]),
        'PGSTV4': dict(base, type='PGSTV4', trg_loss_weight=0.5, feat_level=2,
                       aux_losses=[pfgst]),
        'PGSTMixFeat': dict(base, type='PGSTMixFeat', feat_level=2,
                            aux_losses=[fs]),
        'FMDA': dict(base, type='FMDA', aux_losses=[fs]),
        'FMDAMix': dict(base, type='FMDAMix', feat_level=2,
                        aux_losses=[pfgst])}


def uda_expected_launches(name):
    """Similarity launches (forward, backward) per step that the step's
    code implies: PFST's loss takes the teacher's map only; PFGST's and
    the adaptive loss take the teacher's and the student's source map, and
    the latter carries the gradient; DACS has no similarity loss."""
    if name.startswith('DACS'):
        return 0, 0
    if name.startswith('PFST'):
        return 1, 0
    return 2, 1


def _uda_cfg(cfg, uda):
    ucfg = cfg.copy()
    ucfg['uda'] = copy.deepcopy(uda)
    return ucfg


def _replay_batch(cfg, seed):
    """Phase 7's batch plus a clean target view (another of its images)
    and its replay metas for PFSTV4: sample 0 rotated once and flipped
    vertically, sample 1 rotated three times and flipped horizontally."""
    batch = _train_batch(cfg, seed, TRAIN_HW)
    return dict(batch, target_img_ori=_train_batch(
        cfg, seed + 500, TRAIN_HW)['target_img'], **{
        k: torch.tensor(v, dtype=torch.int32).to(batch['img'].device)
        for k, v in (('rotate_k', [1, 3]), ('flip_vertical', [1, 0]),
                     ('flip_horizontal', [0, 1]))})


def _uda_step_run(cfg, name, uda, steps):
    """``build_algorithm`` -> ``init_state`` -> ``make_train_step`` for
    ``steps`` steps (the first UDA_WARMUP untimed) on phase 7's batches;
    returns s/iter, the similarity kernels' input shapes counted over the
    run, and the last log vars."""
    ucfg = _uda_cfg(cfg, uda)
    algo = build_algorithm(ucfg)
    opt_cfg = ucfg.get('optimizer_config') or {}
    tx = build_optimizer(ucfg.optimizer, ucfg.get('lr_config'),
                         ucfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    norm = ucfg.img_norm_cfg
    step = algo.make_train_step(norm['mean'], norm['std'])
    gen = torch.Generator().manual_seed(3)
    times = []
    with _sim_shapes() as shapes:
        for i in range(steps):
            batch = _replay_batch(cfg, 1000 + i) if name == 'PFSTV4' \
                else _train_batch(cfg, 1000 + i, TRAIN_HW)
            torch.cuda.synchronize()
            t0 = time.time()
            state, log_vars = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            vals = {k: float(v) for k, v in log_vars.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f'[uda {name}] step {i}: non-finite '
                                     f'log vars {vals}')
        shapes = {k: dict(v) for k, v in shapes.items()}
    s_iter = statistics.median(times[UDA_WARMUP:]) if steps > UDA_WARMUP \
        else times[-1]
    del state, algo
    torch.cuda.empty_cache()
    return s_iter, shapes, vals


def _check_uda_launches(name, shapes, steps):
    fwd, bwd = uda_expected_launches(name)
    want = {'neighborhood_similarity':
            {(UDA_SIM_SHAPE, 'float32'): fwd * steps} if fwd else {},
            'neighborhood_similarity_backward':
            {(UDA_SIM_SHAPE, 'float32'): bwd * steps} if bwd else {}}
    if shapes != want:
        raise AssertionError(f'[uda {name}] similarity launches by shape '
                             f'{shapes}, the step implies {want}')


class _ReplayRecorder:
    """Records PFSTV4's first teacher forward (its input and outputs) and
    the replayed outputs with the batch's metas, through the class, so that
    the loop's own algorithm records them."""

    def __init__(self, cls):
        self.cls, self.rec = cls, {}
        self.forward, self.mix = cls.teacher_forward, cls.teacher_and_mix

    def __enter__(self):
        rec, forward, mix = self.rec, self.forward, self.mix

        def teacher_forward(algo, state, img):
            out = forward(algo, state, img)
            if 'raw' not in rec:
                rec['input'] = img
                rec['raw'] = (out[0].clone(), out[1][2].clone())
            return out

        def teacher_and_mix(algo, state, batch, *args, **kwargs):
            out = mix(algo, state, batch, *args, **kwargs)
            if 'replayed' not in rec:
                rec['batch'] = {k: batch[k] for k in (
                    'target_img_ori', 'rotate_k', 'flip_vertical',
                    'flip_horizontal')}
                rec['replayed'] = (out['ema_logits'].clone(),
                                   out['ema_feats'][2].clone())
            return out

        self.cls.teacher_forward = teacher_forward
        self.cls.teacher_and_mix = teacher_and_mix
        return rec

    def __exit__(self, *exc):
        self.cls.teacher_forward = self.forward
        self.cls.teacher_and_mix = self.mix


def _check_replay(rec):
    """The teacher ran on ``target_img_ori``, and its replayed logits and
    level-2 map are, sample by sample, ``torch.rot90`` / ``torch.flip`` of
    the unreplayed ones by that batch's metas, exactly."""
    if rec.get('input') is not rec['batch']['target_img_ori']:
        raise AssertionError('[uda loop] the teacher did not run on '
                             'target_img_ori')
    metas = {k: rec['batch'][k].tolist() for k in (
        'rotate_k', 'flip_vertical', 'flip_horizontal')}
    for raw, got, what in zip(rec['raw'], rec['replayed'],
                              ('logits', 'level-2 map')):
        for i in range(raw.shape[0]):
            want = torch.rot90(raw[i], metas['rotate_k'][i], dims=(1, 2))
            if metas['flip_vertical'][i]:
                want = want.flip(1)
            if metas['flip_horizontal'][i]:
                want = want.flip(2)
            if not torch.equal(got[i], want):
                raise AssertionError(f'[uda loop] replayed teacher {what} of '
                                     f'sample {i} is not the rot90/flip of '
                                     f'its metas {metas}')
    return metas


def _uda_loop(data, uda, card):
    """PFSTV4 through ``tools/train_torch.py`` -> ``train_segmentor`` for
    UDA_LOOP_ITERS iterations on phase 13's packs: the leaf config's
    target pipeline with ``KeepOriImage`` after ``RandomCrop``, collecting
    the snapshot and its metas."""
    from pfst_tpu_torch.models.uda import PFSTV4
    pots, vaih, _ = data
    cfg = _uda_cfg(_loop_config(pots, vaih), uda)
    target = cfg.data['train']['target']['pipeline']
    crop = next(i for i, t in enumerate(target) if t['type'] == 'RandomCrop')
    target.insert(crop + 1, dict(type='KeepOriImage'))
    target[-1]['keys'] = list(target[-1]['keys']) + [
        'ori_img', 'rotate_k', 'flip_vertical', 'flip_horizontal']
    root = tempfile.mkdtemp(prefix='pfst_uda_loop_')
    steps = []
    make_step = PFSTV4.make_train_step

    def recording_step(algo, *args, **kwargs):
        step = make_step(algo, *args, **kwargs)

        def run(state, batch, generator, premix=None):
            state, log_vars = step(state, batch, generator, premix)
            steps.append(log_vars)
            return state, log_vars
        return run

    try:
        path = osp.join(root, 'pfstv4.py')
        cfg.dump(path)
        torch.cuda.synchronize()
        _reset_counts()
        PFSTV4.make_train_step = recording_step
        t0 = time.time()
        with _ReplayRecorder(PFSTV4) as rec:
            _tool('train_torch').main([
                path, '--work-dir', osp.join(root, 'work'), '--no-validate',
                '--max-iters', str(UDA_LOOP_ITERS), '--cfg-options',
                f'checkpoint_config.interval={UDA_LOOP_ITERS}'])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _sim_counts()
    finally:
        PFSTV4.make_train_step = make_step
        shutil.rmtree(root, ignore_errors=True)
    losses = [{k: float(v) for k, v in lv.items()} for lv in steps]
    bad = [(i, k) for i, lv in enumerate(losses) for k, v in lv.items()
           if not np.isfinite(v)]
    if len(losses) != UDA_LOOP_ITERS or bad:
        raise AssertionError(f'[uda loop] {len(losses)} iterations, '
                             f'non-finite {bad}')
    metas = _check_replay(rec)
    want = tuple(n * UDA_LOOP_ITERS for n in uda_expected_launches('PFSTV4'))
    if counts != want:
        raise AssertionError(f'[uda loop] similarity launches {counts}, the '
                             f'step implies {want}')
    last = {k: round(v, 5) for k, v in losses[-1].items()}
    log(f'[uda loop] PFSTV4 through tools/train_torch.py: '
        f'{UDA_LOOP_ITERS} iterations in {wall:.1f} s on {card}, every loss '
        f'finite (last {json.dumps(last)}); '
        f'the teacher ran on target_img_ori, and its replayed logits '
        f'{tuple(rec["replayed"][0].shape)} and level-2 map '
        f'{tuple(rec["replayed"][1].shape)} equal rot90/flip of the '
        f'unreplayed ones by the batch\'s metas {metas}, exactly; '
        f'similarity launches {counts}')
    return dict(wall=wall, launches=counts)


def phase_uda(card, cfg, bare_s_iter, data):
    """Phase 15: the rest of the UDA family at full width."""
    t_phase = time.time()
    variants = uda_variants(cfg.uda)
    out, fwd, bwd = {}, 0, 0
    for name, uda in variants.items():
        steps = 1 if name in ('PFSTV2', 'PFSTV3') else UDA_STEPS
        s_iter, shapes, vals = _uda_step_run(cfg, name, uda, steps)
        _check_uda_launches(name, shapes, steps)
        per_step = {kernel: {f'{list(shape)} {dtype}': n / steps
                             for (shape, dtype), n in by_shape.items()}
                    for kernel, by_shape in shapes.items()}
        fwd += sum(shapes['neighborhood_similarity'].values())
        bwd += sum(shapes['neighborhood_similarity_backward'].values())
        extra = {k: round(vals[k], 6) for k in ('loss_imnet_feat_dist',
                                                'grad_mag') if k in vals}
        if name == 'DACS-fdist' and set(extra) != {'loss_imnet_feat_dist',
                                                   'grad_mag'}:
            raise AssertionError(f'[uda {name}] log vars {sorted(vals)}')
        out[name] = dict(s_iter=s_iter, steps=steps, launches=per_step,
                         **extra)
        log(f'[uda {name}] {steps} steps, batch 2 of {TRAIN_HW}: s/iter '
            f'{s_iter:.4f}' + (f' (median after {UDA_WARMUP} warm-ups)'
                               if steps > UDA_WARMUP else ' (one step)') +
            f'; bare PFGST step (phase 7, fp32) {bare_s_iter:.4f} on {card}; '
            f'similarity launches per step {json.dumps(per_step)}'
            + (f'; {json.dumps(extra)}' if extra else ''))
    for name in ('PGST', 'FMDA'):
        # the limit on the norm gap follows the step's own fp32 floor
        # where that exceeds phase 8's 1e-3 (FMDA's CPU gap reads 1.06e-3)
        phase_train_card_vs_cpu(_uda_cfg(cfg, variants[name]),
                                f'[uda {name} card-vs-cpu]',
                                self_gap_scale=UDA_SELF_GAP_SCALE)
    loop = _uda_loop(data, variants['PFSTV4'], card)
    fwd += loop['launches'][0]
    bwd += loop['launches'][1]
    log(f'[uda] phase 15 in {time.time() - t_phase:.1f} s')
    return dict(algorithms=out, loop=loop, launches=(fwd, bwd))


def adaptor_variants(cfg):
    """Phase 16's algorithms on the leaf model (its DeepLabV3+ R50-D8 and
    FCN auxiliary head, 6 classes): the five domain adaptors with the
    losses of ``tests/test_torch_domain_adaptor.py::ADAPTORS`` (the
    discriminator at its default width, ndf 64; FMDA's ``FeatSimLoss``
    gaussian on one level-3 map, ``tools/gen_pseudo_labels.py:43``), the
    adversarial one with the reference's optimizer dict (the config's
    AdamW for the generator, Adam 1e-4 for the discriminator); and PFGST
    with ``LocalPseudoFeatLoss`` on level 2 of the backbone's maps and
    ``PseudoLabelLoss`` as its aux losses. Each value is the config's
    ``(model, uda, optimizer)``."""
    seg = {k: v for k, v in cfg.to_dict()['model'].items() if k != 'type'}
    adv = dict(
        discriminator=dict(type='FCDiscriminator', num_in_channels=6),
        gen_losses=[dict(type='AdvLoss', net_type='gen',
                         weights={'loss_gen': 0.02})],
        disc_losses=[dict(type='AdvLoss', net_type='disc',
                          weights={'loss_disc_src': 0.5,
                                   'loss_disc_trg': 0.5})])
    opt = cfg.to_dict()['optimizer']
    leaf = cfg.to_dict()['model']
    pseudo = [dict(type='LocalPseudoFeatLoss', top_k=3, dilation=SIM_D,
                   kernel_size=SIM_K, sim_type='cosine', feat_level=2,
                   weights={'src_pos': 0.1, 'src_neg': 0.1, 'sim_pos': 0.1}),
              dict(type='PseudoLabelLoss', weights={'loss_pseudo': 0.5})]
    return {
        'DomainAdaptor': (dict(seg, type='DomainAdaptor', weight_trg=0.5),
                          None, opt),
        'DomainAdaptorAdv': (dict(seg, type='DomainAdaptorAdv', **adv), None,
                             dict(generator=opt, discriminator=dict(
                                 type='Adam', lr=1e-4, betas=(0.9, 0.99)))),
        'DomainAdaptorV2': (dict(seg, type='DomainAdaptorV2', aux_losses=[
            dict(type='EntropyLoss', weights={'loss_ent': 0.05})]), None,
            opt),
        'FMDAAdaptor': (dict(seg, type='FMDAAdaptor', loss_sim_feat=dict(
            type='FeatSimLoss', top_k=2, dilation=1, kernel_size=SIM_K,
            sigmas=[5.0], weights=[[0.5, 0.3]], sim_type='gaussian')),
            None, opt),
        'FMDAAdaptorV2': (dict(seg, type='FMDAAdaptorV2', loss_sim_feat=dict(
            type='FeatSimLossV2', top_k=2, dilation=1, kernel_size=SIM_K,
            weights=[[0.5, 0.3]])), None, opt),
        'PFGST-pseudo': (leaf, dict(cfg.to_dict()['uda'],
                                    use_decoded_feats=False,
                                    aux_losses=pseudo), opt)}


def adaptor_expected_shapes(name):
    """Similarity launches by (shape, dtype) per step that the step's code
    implies: FMDA's ``FeatSimLoss`` takes the level-3 map of the batch,
    resized to the logits, without a gradient; ``LocalPseudoFeatLoss``
    the teacher's and the student's level-2 maps, the latter with its
    gradient; the other adaptors' losses take no similarity."""
    if name == 'FMDAAdaptor':
        return {(FMDA_SIM_SHAPE, 'float32'): 1}, {}
    if name == 'PFGST-pseudo':
        return ({(UDA_SIM_SHAPE, 'float32'): 2},
                {(UDA_SIM_SHAPE, 'float32'): 1})
    return {}, {}


def _variant_cfg(cfg, variant):
    model, uda, opt = variant
    vcfg = cfg.copy()
    vcfg['model'] = copy.deepcopy(model)
    vcfg['uda'] = copy.deepcopy(uda)
    vcfg['optimizer'] = copy.deepcopy(opt)
    return vcfg


def _adaptor_batch(cfg, name, seed):
    """Phase 7's batch with target labels, and for FMDA the maps it reads
    (seeded normal draws) with the replay metas of ``_replay_batch``:
    V1 a level-3 feature map (2, 2048, 64, 64), V2 a 9-tap similarity map
    at the logits' size."""
    batch = _train_batch(cfg, seed, TRAIN_HW)
    batch['target_gt_semantic_seg'] = _train_batch(
        cfg, seed + 500, TRAIN_HW)['gt_semantic_seg']
    if name.startswith('FMDA'):
        gen = torch.Generator().manual_seed(seed)
        shape = ADAPTOR_FEAT_SHAPE if name == 'FMDAAdaptor' else \
            (2, SIM_K * SIM_K, *FMDA_SIM_SHAPE[2:])
        key = 'target_feat' if name == 'FMDAAdaptor' else 'target_sim_feat'
        batch[key] = torch.randn(shape, generator=gen).cuda()
        batch.update({k: torch.tensor(v, dtype=torch.int32).cuda()
                      for k, v in (('rotate_k', [1, 3]),
                                   ('flip_vertical', [1, 0]),
                                   ('flip_horizontal', [0, 1]))})
    return batch


def _params_of(module):
    return torch.cat([p.detach().flatten() for p in module.parameters()])


def _adaptor_step_run(vcfg, name, steps):
    """``build_algorithm`` -> ``init_state`` -> ``make_train_step`` for
    ``steps`` steps (the first UDA_WARMUP untimed); returns s/iter, the
    similarity kernels' input shapes over the run, the last log vars and
    how far the student (and the discriminator) moved."""
    algo = build_algorithm(vcfg)
    opt_cfg = vcfg.get('optimizer_config') or {}
    tx = build_optimizers(vcfg.optimizer, vcfg.get('lr_config'),
                          vcfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    disc = getattr(state, 'discriminator', None)
    start = [_params_of(m) for m in (state.student, disc) if m is not None]
    norm = vcfg.img_norm_cfg
    step = algo.make_train_step(norm['mean'], norm['std'])
    gen = torch.Generator().manual_seed(3)
    times = []
    with _sim_shapes() as shapes:
        for i in range(steps):
            batch = _adaptor_batch(vcfg, name, 1000 + i)
            torch.cuda.synchronize()
            t0 = time.time()
            state, log_vars = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            vals = {k: float(v) for k, v in log_vars.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f'[adaptor {name}] step {i}: non-finite '
                                     f'log vars {vals}')
        shapes = {k: dict(v) for k, v in shapes.items()}
    moved = [float((_params_of(m) - s).abs().max()) for m, s in zip(
        (state.student, disc), start)]
    del state, algo
    torch.cuda.empty_cache()
    return statistics.median(times[UDA_WARMUP:]), shapes, vals, moved


def _adaptor_loop_config(pots, vaih):
    """The source-only config as a ``DomainAdaptor`` (``weight_trg`` 0.5)
    on a ``MultiDomainDataset`` of phase 13's Potsdam and Vaihingen packs
    (both through the source pipeline, with their labels), at phase 13's
    learning rate and scaled warmup: checkpoints every
    ADAPTOR_LOOP_RESUME, an eval on the Vaihingen validation tiles at
    ADAPTOR_LOOP_ITERS, which the test set points at too."""
    cfg = _config_loop_config(SOURCE_ONLY, ADAPTOR_LOOP_ITERS, pots, vaih)
    model = cfg.to_dict()['model']
    model.update(type='DomainAdaptor', weight_trg=0.5)
    cfg['model'] = model
    train = cfg.to_dict()['data']['train']
    cfg.data['train'] = dict(type='MultiDomainDataset', datasets=[
        train, dict(train, data_root=vaih)])
    cfg.merge_from_dict({
        'checkpoint_config.interval': ADAPTOR_LOOP_RESUME})
    return cfg


def _adaptor_loop(data, card):
    """``DomainAdaptor`` through ``tools/train_torch.py`` ->
    ``train_segmentor``: run A for ADAPTOR_LOOP_ITERS iterations with an
    eval, run B resumed from A's checkpoint at ADAPTOR_LOOP_RESUME; the
    restored state equal to the file bitwise; ``tools/test_torch.py`` on
    A's last checkpoint to the in-loop mIoU; every loss finite; no
    similarity launch (its losses take none)."""
    from pfst_tpu_torch.apis import train as train_api
    from pfst_tpu_torch.models.segmentors import DomainAdaptor
    pots, vaih, _ = data
    cfg = _adaptor_loop_config(pots, vaih)
    root = tempfile.mkdtemp(prefix='pfst_adaptor_loop_')
    steps, evals = [], []
    make_step, evaluate = DomainAdaptor.make_train_step, \
        train_api.evaluate_during_train
    own = 'make_train_step' in vars(DomainAdaptor)

    def recording_step(algo, *args, **kwargs):
        step = make_step(algo, *args, **kwargs)

        def run(state, batch, generator):
            if not steps:
                steps.append(sorted(batch))
            state, log_vars = step(state, batch, generator)
            steps.append(log_vars)
            return state, log_vars
        return run

    def recording_eval(*args, **kwargs):
        evals.append(evaluate(*args, **kwargs))
        return evals[-1]

    try:
        path = osp.join(root, 'adaptor.py')
        cfg.dump(path)
        torch.cuda.synchronize()
        _reset_counts()
        DomainAdaptor.make_train_step = recording_step
        train_api.evaluate_during_train = recording_eval
        t0 = time.time()
        train = _tool('train_torch')
        train.main([path, '--work-dir', osp.join(root, 'A'),
                    '--max-iters', str(ADAPTOR_LOOP_ITERS)])
        ckpt = osp.join(root, 'A', f'iter_{ADAPTOR_LOOP_RESUME}.pth')
        train.main([path, '--work-dir', osp.join(root, 'B'), '--no-validate',
                    '--resume-from', ckpt,
                    '--max-iters', str(ADAPTOR_LOOP_ITERS)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _sim_counts()
        n_tensors, _ = _check_restored(cfg, ckpt, ADAPTOR_LOOP_RESUME,
                                       ADAPTOR_LOOP_ITERS)
        t_test = time.time()
        res = _tool('test_torch').main([
            path, osp.join(root, 'A', f'iter_{ADAPTOR_LOOP_ITERS}.pth'),
            '--eval', 'mIoU'])
        t_test = time.time() - t_test
    finally:
        if own:
            DomainAdaptor.make_train_step = make_step
        else:
            del DomainAdaptor.make_train_step
        train_api.evaluate_during_train = evaluate
        shutil.rmtree(root, ignore_errors=True)
    keys, losses = steps[0], [{k: float(v) for k, v in lv.items()}
                              for lv in steps[1:]]
    want = ADAPTOR_LOOP_ITERS * 2 - ADAPTOR_LOOP_RESUME
    bad = [(i, k) for i, lv in enumerate(losses) for k, v in lv.items()
           if not np.isfinite(v)]
    if len(losses) != want or bad or 'trg.decode.loss_ce' not in losses[0] \
            or 'dom2_img' not in keys:
        raise AssertionError(f'[adaptor loop] {len(losses)} iterations of '
                             f'{want}, batch keys {keys}, non-finite {bad}')
    if counts != (0, 0):
        raise AssertionError(f'[adaptor loop] similarity launches {counts}')
    loop_miou = evals[0]['mIoU']
    if len(evals) != 1 or abs(res['mIoU'] - loop_miou) > LOOP_MIOU_TOL + 1e-12:
        raise AssertionError(f'[adaptor loop] tools/test_torch.py mIoU '
                             f'{res["mIoU"]} != in-loop {evals}')
    last = {k: round(v, 5) for k, v in losses[ADAPTOR_LOOP_ITERS - 1].items()}
    log(f'[adaptor loop] DomainAdaptor on a MultiDomainDataset through '
        f'tools/train_torch.py: run A {ADAPTOR_LOOP_ITERS} iterations, run B '
        f'resumed at {ADAPTOR_LOOP_RESUME} (restore bitwise, {n_tensors} '
        f'tensors), {wall:.1f} s on {card}; batch keys {keys}; every loss '
        f'finite (A\'s last {json.dumps(last)}); mIoU in the loop '
        f'{loop_miou} / tools/test_torch.py {res["mIoU"]} ({t_test:.1f} s); '
        f'similarity launches {counts}')
    return dict(wall=wall, miou_loop=loop_miou, miou_test=res['mIoU'])


def phase_adaptors(card, cfg, bare_s_iter, data):
    """Phase 16: the domain-adaptor family at full width."""
    t_phase = time.time()
    out, fwd, bwd = {}, 0, 0
    variants = adaptor_variants(cfg)
    for name, variant in variants.items():
        vcfg = _variant_cfg(cfg, variant)
        s_iter, shapes, vals, moved = _adaptor_step_run(vcfg, name, UDA_STEPS)
        want_f, want_b = adaptor_expected_shapes(name)
        want = {'neighborhood_similarity': {k: n * UDA_STEPS
                                            for k, n in want_f.items()},
                'neighborhood_similarity_backward': {
                    k: n * UDA_STEPS for k, n in want_b.items()}}
        if shapes != want:
            raise AssertionError(f'[adaptor {name}] similarity launches by '
                                 f'shape {shapes}, the step implies {want}')
        if not all(m > 0 for m in moved):
            raise AssertionError(f'[adaptor {name}] max |change| of the '
                                 f'student (and discriminator) {moved}')
        fwd += sum(shapes['neighborhood_similarity'].values())
        bwd += sum(shapes['neighborhood_similarity_backward'].values())
        per_step = {kernel: {f'{list(shape)} {dtype}': n / UDA_STEPS
                             for (shape, dtype), n in by_shape.items()}
                    for kernel, by_shape in shapes.items()}
        out[name] = dict(s_iter=s_iter, launches=per_step, moved=moved)
        log(f'[adaptor {name}] {UDA_STEPS} steps, batch 2 of {TRAIN_HW}: '
            f's/iter {s_iter:.4f} (median after {UDA_WARMUP} warm-ups); bare '
            f'PFGST step (phase 7, fp32) {bare_s_iter:.4f} on {card}; '
            f'similarity launches per step {json.dumps(per_step)}; max '
            f'|change| student' + (' / discriminator' if len(moved) > 1
                                   else '') +
            f' {[f"{m:.3e}" for m in moved]}; last log vars '
            f'{json.dumps({k: round(v, 6) for k, v in vals.items()})}')
    phase_train_card_vs_cpu(_variant_cfg(cfg, variants['DomainAdaptorAdv']),
                            '[adaptor DomainAdaptorAdv card-vs-cpu]',
                            self_gap_scale=UDA_SELF_GAP_SCALE)
    loop = _adaptor_loop(data, card)
    log(f'[adaptor] phase 16 in {time.time() - t_phase:.1f} s')
    return dict(algorithms=out, loop=loop, launches=(fwd, bwd))


def _config_loop_config(path, iters, train_root, eval_root, target_root=None,
                        eval_split='val'):
    """A shipped config on phase 13's packs: the train data at
    ``train_root`` (with ``target_root`` the UDA pair's target), the
    validation and test sets at ``eval_root``'s ``eval_split``, log every
    iteration, a checkpoint and an eval at ``iters``, phase 13's learning
    rate and scaled warmup."""
    cfg = Config.fromfile(path)
    warmup = round(cfg.lr_config['warmup_iters'] * iters
                   / cfg.runner['max_iters'])
    train = 'data.train.source' if target_root else 'data.train'
    updates = {
        f'{train}.data_root': train_root,
        'log_config.interval': 1, 'checkpoint_config.interval': iters,
        'evaluation.interval': iters, 'lr_config.warmup_iters': warmup,
        'optimizer.lr': cfg.optimizer['lr'] * LOOP_LR_SCALE}
    if target_root:
        updates['data.train.target.data_root'] = target_root
    for key in ('val', 'test'):
        updates.update({f'data.{key}.data_root': eval_root,
                        f'data.{key}.img_dir': f'img_dir/{eval_split}',
                        f'data.{key}.ann_dir': f'ann_dir/{eval_split}'})
    cfg.merge_from_dict(updates)
    return cfg


def _config_run(card, name, cfg, uda):
    """One config through ``train_segmentor`` for CONFIG_LOOP_ITERS
    iterations with an eval, then ``tools/test_torch.py`` on its
    checkpoint: every loss finite, equal mIoU within 0.01 points, the
    similarity launches of its step (2 forward and 1 backward an
    iteration with the PFGST loss, none without)."""
    root = tempfile.mkdtemp(prefix=f'pfst_{name}_')
    try:
        hist = []
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        train_segmentor(cfg.copy(), work_dir=osp.join(root, 'run'),
                        max_iters_override=CONFIG_LOOP_ITERS, seed=0,
                        history=hist)
        torch.cuda.synchronize()
        wall, counts = time.time() - t0, _sim_counts()
        want = (2 * CONFIG_LOOP_ITERS, CONFIG_LOOP_ITERS) if uda else (0, 0)
        if counts != want:
            raise AssertionError(f'[configs] {name}: similarity launches '
                                 f'{counts}, the step implies {want}')
        logs = {h['iter']: h for h in hist if h['kind'] == 'log'}
        bad = [(i, k) for i, h in logs.items()
               for k, v in h['log_vars'].items() if not np.isfinite(v)]
        if len(logs) != CONFIG_LOOP_ITERS or bad:
            raise AssertionError(f'[configs] {name}: {len(logs)} log lines, '
                                 f'non-finite losses {bad[:8]}')
        loop_miou = next(h['metrics']['mIoU'] for h in hist
                         if h['kind'] == 'eval')
        cfg_path = osp.join(root, 'config.py')
        cfg.dump(cfg_path)
        res = _tool('test_torch').main([
            cfg_path, osp.join(root, 'run', f'iter_{CONFIG_LOOP_ITERS}.pth'),
            '--eval', 'mIoU'])
        if abs(res['mIoU'] - loop_miou) > LOOP_MIOU_TOL + 1e-12:
            raise AssertionError(f'[configs] {name}: tools/test_torch.py '
                                 f'mIoU {res["mIoU"]} != in-loop {loop_miou}')
        times = [logs[i]['time'] for i in range(LOOP_WINDOW + 1,
                                                CONFIG_LOOP_ITERS + 1)]
        loss = [round(logs[i]['log_vars']['decode.loss_ce'], 4)
                for i in range(1, CONFIG_LOOP_ITERS + 1)]
        log(f'[configs] {name}: {CONFIG_LOOP_ITERS} iterations through '
            f'train_segmentor in {wall:.1f} s on {card}, every loss finite '
            f'(decode loss {loss}); mIoU in the loop {loop_miou} / '
            f'tools/test_torch.py {res["mIoU"]}; similarity launches '
            f'{counts}; s/iter past iteration {LOOP_WINDOW}: median '
            f'{statistics.median(times):.4f}')
        return dict(wall=wall, launches=counts, miou_loop=loop_miou,
                    miou_test=res['mIoU'],
                    s_iter_median=statistics.median(times))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_loop_configs(card, data):
    """Phase 13b: the source-only config (``BASELINE.json``'s config 2) and
    the Vaih->Pots PFGST config through ``train_segmentor`` on phase 13's
    packs: the former trains on the Potsdam tiles and is scored on the
    Vaihingen validation tiles, the latter adapts Vaihingen to Potsdam
    and is scored on the Potsdam tiles."""
    pots, vaih, _ = data
    out = {
        'source_only': _config_run(card, 'source_only', _config_loop_config(
            SOURCE_ONLY, CONFIG_LOOP_ITERS, pots, vaih), False),
        'vaih2pots': _config_run(card, 'vaih2pots', _config_loop_config(
            VAIH2POTS, CONFIG_LOOP_ITERS, vaih, pots, target_root=pots,
            eval_split='train'), True)}
    torch.cuda.empty_cache()
    return out

def _pl_history(hist, kind):
    return [h['iter'] for h in hist if h['kind'] == kind]


def _pl_hook_run(data, root):
    """The source-only config through ``train_segmentor`` with
    ``PseudoLabelingHookV4`` in ``custom_hooks`` (the validation tiles,
    level-3 features, ``trigger_iter`` PL_TRIGGER of PL_TRAIN_ITERS) and a
    checkpoint at the iteration before it: the loop must halt at
    PL_TRIGGER with the halted state checkpointed, the hook having
    labelled from the checkpoint before it. Returns the config, the halted
    checkpoint, the hook's corpus, the similarity launches by shape and
    the seconds."""
    pots, vaih, _ = data
    cfg = _config_loop_config(SOURCE_ONLY, PL_TRAIN_ITERS, pots, vaih)
    corpus = osp.join(root, 'hook_corpus')
    cfg.merge_from_dict({'checkpoint_config.interval': PL_TRIGGER - 1})
    cfg['custom_hooks'] = [dict(
        type='PseudoLabelingHookV4', out_dir=corpus, split='val',
        save_feats=True, feat_levels=(3,), target_mean_sim=PL_MEAN_SIM,
        trigger_iter=PL_TRIGGER)]
    hist = []
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    with _sim_shapes() as shapes:
        train_segmentor(cfg.copy(), work_dir=osp.join(root, 'source_only'),
                        max_iters_override=PL_TRAIN_ITERS, validate=False,
                        seed=0, history=hist)
        torch.cuda.synchronize()
    wall = time.time() - t0
    want = list(range(1, PL_TRIGGER + 1))
    got = {k: _pl_history(hist, k) for k in ('batch', 'halt', 'checkpoint')}
    if got != {'batch': want, 'halt': [PL_TRIGGER],
               'checkpoint': [PL_TRIGGER - 1, PL_TRIGGER]}:
        raise AssertionError(f'[pseudo] the hook did not halt the loop at '
                             f'{PL_TRIGGER}: {got}')
    bad = [(h['iter'], k) for h in hist if h['kind'] == 'log'
           for k, v in h['log_vars'].items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f'[pseudo] source-only losses non-finite {bad}')
    return cfg, osp.join(root, 'source_only', f'iter_{PL_TRIGGER}.pth'), \
        corpus, {k: dict(v) for k, v in shapes.items()}, wall


def _pl_sweep(cfg_path, ckpt, out, extra):
    """``tools/gen_pseudo_labels_torch.py`` on the card; its summary, the
    similarity launches by shape and the seconds."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    with _sim_shapes() as shapes:
        summary = _tool('gen_pseudo_labels_torch').main(
            [cfg_path, ckpt, '--out-dir', out, *extra])
        torch.cuda.synchronize()
    return summary, {k: dict(v) for k, v in shapes.items()}, \
        time.time() - t0


def _pl_check_shapes(name, shapes, n_feat_tiles):
    want = {'neighborhood_similarity':
            {(PL_SIM_SHAPE, 'float32'): n_feat_tiles} if n_feat_tiles
            else {}, 'neighborhood_similarity_backward': {}}
    if shapes != want:
        raise AssertionError(f'[pseudo] {name}: similarity launches by shape '
                             f'{shapes}, one a tile with features implies '
                             f'{want}')


def _pl_check_corpus(name, out, n_tiles, feats):
    """Every file of a corpus read back with the port's reader: keys,
    shapes and dtypes as the JAX tool writes them, thresholds rising with
    the ratio within [0, log C], finite sigmas, and each similarity map
    against the plain version on the same stored float16 features, to the
    float16 rounding of the stored map (plus SIM_TOL). Returns the sigma
    and the largest excess over that allowance."""
    from pfst_tpu_torch.datasets.pipelines import read_h5
    files = sorted(f for f in os.listdir(out) if f.endswith('.h5'))
    with open(osp.join(out, 'sigmas.json')) as f:
        sigmas = json.load(f)
    sigma = sigmas[str(PL_MEAN_SIM)]
    if len(files) != n_tiles or not all(np.isfinite(v)
                                        for v in sigmas.values()):
        raise AssertionError(f'[pseudo] {name}: {len(files)} files of '
                             f'{n_tiles}, sigmas {sigmas}')
    c, log_c = PL_NUM_CLASSES, float(np.log(PL_NUM_CLASSES))
    want = {'seg_logits': ((c,) + REQUEST_HW, 'float16'),
            **{f'thre@{r}': ((c,), 'float32') for r in PL_RATIOS}}
    if feats:
        h, w = PL_SIM_SHAPE[2:]
        want.update(feats_3=((h, w, PL_SIM_SHAPE[1]), 'float16'),
                    gaussian_sim_feat_3=((h, w, SIM_K * SIM_K), 'float16'))
    excess = -1.0
    for f in files:
        arrays = read_h5(osp.join(out, f))
        got = {k: (v.shape, str(v.dtype)) for k, v in arrays.items()}
        if got != want:
            raise AssertionError(f'[pseudo] {name}/{f}: {got} != {want}')
        thre = np.stack([arrays[f'thre@{r}'] for r in PL_RATIOS])
        fin = np.isfinite(thre)
        if not (fin == fin[:1]).all() or not fin[0].any() or \
                (np.diff(np.where(fin, thre, 0), axis=0) < 0).any() or \
                thre[fin].min() < 0 or thre[fin].max() > log_c + 1e-5:
            raise AssertionError(f'[pseudo] {name}/{f}: thresholds {thre}')
        if feats:
            x = torch.from_numpy(arrays['feats_3'].astype(np.float32)).cuda()
            plain = torch_neighborhood_similarity(
                x.permute(2, 0, 1)[None].contiguous(), SIM_K, SIM_D,
                'gaussian', sigma)[0].permute(1, 2, 0).cpu().numpy()
            stored = arrays['gaussian_sim_feat_3']
            allowed = np.spacing(np.abs(stored)).astype(np.float32) / 2 \
                + SIM_TOL
            err = np.abs(stored.astype(np.float32) - plain)
            excess = max(excess, float((err - allowed).max()))
            if excess > 0:
                raise AssertionError(f'[pseudo] {name}/{f}: the stored '
                                     f'similarity map is {err.max():.3e} '
                                     f'off the plain version')
    return sigma, excess


def _pl_adaptor_run(data, corpus, root):
    """``DomainAdaptor`` (phase 16's loop config) through
    ``train_segmentor`` for PL_ADAPT_ITERS iterations, its Vaihingen branch
    labelled by ``LoadAnnotationsPseudoLabelsV2`` on the corpus of the
    Vaihingen train tiles: the loader ran for the Vaihingen samples, the
    first batch's target labels are values the loader gave (not all 255),
    every loss finite, no similarity launch."""
    from pfst_tpu_torch.datasets.pipelines import \
        LoadAnnotationsPseudoLabelsV2 as Loader
    from pfst_tpu_torch.models.segmentors import DomainAdaptor
    pots, vaih, _ = data
    cfg = _adaptor_loop_config(pots, vaih)
    train = cfg.to_dict()['data']['train']
    target = copy.deepcopy(train['datasets'][1])
    pipe = target['pipeline']
    i = next(i for i, t in enumerate(pipe) if t['type'] == 'LoadAnnotations')
    pipe[i] = dict(type='LoadAnnotationsPseudoLabelsV2',
                   pseudo_labels_dir=corpus, pseudo_ratio=PL_RATIO)
    train['datasets'][1] = target
    cfg.data['train'] = train
    first, make_step = [], DomainAdaptor.make_train_step
    own = 'make_train_step' in vars(DomainAdaptor)

    def recording_step(algo, *args, **kwargs):
        step = make_step(algo, *args, **kwargs)

        def run(state, batch, generator):
            if not first:
                first.append(batch['dom2_gt_semantic_seg'].cpu().numpy())
            return step(state, batch, generator)
        return run

    loaded, load = [], Loader.__call__

    def recording_load(loader, results):
        results = load(loader, results)
        loaded.append(results['gt_semantic_seg'])
        return results

    hist = []
    try:
        DomainAdaptor.make_train_step = recording_step
        Loader.__call__ = recording_load
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        train_segmentor(cfg, work_dir=osp.join(root, 'adaptor'),
                        max_iters_override=PL_ADAPT_ITERS, validate=False,
                        seed=0, history=hist)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        Loader.__call__ = load
        if own:
            DomainAdaptor.make_train_step = make_step
        else:
            del DomainAdaptor.make_train_step
    counts = _sim_counts()
    logs = [h['log_vars'] for h in hist if h['kind'] == 'log']
    labels = first[0]
    values = sorted(int(v) for v in np.unique(labels))
    kept = float((labels != 255).mean())
    given = set(int(v) for lab in loaded for v in np.unique(lab))
    loader_kept = float(np.mean([(lab != 255).mean() for lab in loaded]))
    if len(loaded) < 2 * PL_ADAPT_ITERS or not set(values) <= given:
        raise AssertionError(f'[pseudo] the loader ran {len(loaded)} times '
                             f'giving {sorted(given)}; the first batch\'s '
                             f'target labels {values}')
    if len(logs) != PL_ADAPT_ITERS or not all(
            np.isfinite(v) for lv in logs for v in lv.values()) or \
            'trg.decode.loss_ce' not in logs[0]:
        raise AssertionError(f'[pseudo] adaptor losses {logs}')
    if not set(values) <= set(range(PL_NUM_CLASSES)) | {255} or kept == 0:
        raise AssertionError(f'[pseudo] the first batch\'s target labels '
                             f'{values} (kept {kept:.3f}) are not the '
                             f'corpus loader\'s')
    if counts != (0, 0):
        raise AssertionError(f'[pseudo] adaptor similarity launches {counts}')
    return dict(wall=wall, values=values, kept=kept, loads=len(loaded),
                loader_values=sorted(given), loader_kept=loader_kept,
                last={k: round(v, 5) for k, v in logs[-1].items()})


def _pl_rcs_run(data, root):
    """``tools/compute_class_stats_torch.py`` on the Potsdam packs, then
    the leaf config with ``rare_class_sampling`` (PL_RCS) through
    ``train_segmentor`` for PL_RCS_ITERS iterations: the classes drawn,
    every loss finite, the PFGST step's similarity launches."""
    from pfst_tpu_torch.datasets.uda_dataset import UDADataset
    pots, vaih, _ = data
    cfg = _loop_config(pots, vaih)
    path = osp.join(root, 'leaf.py')
    cfg.dump(path)
    t0 = time.time()
    stats, per_class = _tool('compute_class_stats_torch').main(
        [path, '--split', 'train', '--branch', 'source'])
    t_stats = time.time() - t0
    cfg.merge_from_dict({'data.train.rare_class_sampling': PL_RCS})
    drawn, draw = collections.Counter(), UDADataset.draw_rcs_class

    def recording_draw(ds):
        c = draw(ds)
        drawn[int(c)] += 1
        return c

    hist = []
    try:
        UDADataset.draw_rcs_class = recording_draw
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        train_segmentor(cfg, work_dir=osp.join(root, 'rcs'),
                        max_iters_override=PL_RCS_ITERS, validate=False,
                        seed=0, history=hist)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        UDADataset.draw_rcs_class = draw
    counts = _sim_counts()
    logs = [h['log_vars'] for h in hist if h['kind'] == 'log']
    if len(logs) != PL_RCS_ITERS or not all(
            np.isfinite(v) for lv in logs for v in lv.values()):
        raise AssertionError(f'[pseudo] RCS loop losses {logs}')
    if sum(drawn.values()) < 2 * PL_RCS_ITERS:
        raise AssertionError(f'[pseudo] RCS drew {dict(drawn)}')
    _check_launches('rcs', counts, PL_RCS_ITERS)
    return dict(stats_s=t_stats, wall=wall, drawn=dict(sorted(drawn.items())),
                images=len(stats), classes=sorted(per_class), launches=counts)


def _hist_bins(v, edges):
    """Each value's bin as ``np.histogram`` counts it, -1 outside."""
    idx = np.searchsorted(edges, v, side='right') - 1
    idx[v == edges[-1]] = len(edges) - 2
    idx[(v < edges[0]) | (v > edges[-1])] = -1
    return idx


def _pl_histogram(cfg, ckpt, sigma):
    """``similarity_histogram`` on the decoded features of one batch (the
    two Vaihingen validation tiles) on the card, cosine and gaussian at
    the corpus's sigma: its counts equal the kernel's values binned, and
    every value the plain version bins otherwise lies within
    PL_HIST_EDGE of a bin edge. Returns the launches and the results."""
    from pfst_tpu_torch.apis.test import normalize_views
    from pfst_tpu_torch.core.hooks import similarity_histogram
    model = init_segmentor(cfg, ckpt)
    device = next(model.parameters()).device
    ds = build_dataset({**cfg.data['val'], 'test_mode': True})
    views = []
    for i in range(len(ds)):
        s = ds[i]
        views += normalize_views(s['img'][:1], s['img_metas'][:1], device)
    with torch.inference_mode():
        _, st = model.encode_decode(torch.cat(views))
    feats = st['decoded_features'].contiguous()
    del model
    out, launches = {}, 0
    for name, sg in (('cosine', None), ('gaussian', sigma)):
        before = cuda_neighborhood_similarity.launches
        hist, edges = similarity_histogram(feats, SIM_K, SIM_D, sg)
        launches += cuda_neighborhood_similarity.launches - before
        kern = cuda_neighborhood_similarity(
            feats, SIM_K, SIM_D, name, sg or SIGMA).cpu().numpy().ravel()
        plain = torch_neighborhood_similarity(
            feats, SIM_K, SIM_D, name, sg or SIGMA).cpu().numpy().ravel()
        if not np.array_equal(np.histogram(kern, bins=len(hist),
                                           range=(-1.0, 1.0))[0], hist):
            raise AssertionError(f'[pseudo] histogram {name}: counts are not '
                                 f'the kernel\'s values binned')
        moved = _hist_bins(kern, edges) != _hist_bins(plain, edges)
        dist = np.abs(plain[:, None] - edges[None, [0, -1]]).min(1)
        grid = (plain.astype(np.float64) + 1.0) * (len(hist) / 2.0)
        dist = np.minimum(dist, np.abs(grid - np.round(grid))
                          * (2.0 / len(hist)))
        near = dist <= PL_HIST_EDGE
        if (moved & ~near).any():
            raise AssertionError(f'[pseudo] histogram {name}: '
                                 f'{int((moved & ~near).sum())} values binned '
                                 f'otherwise than the plain version, away '
                                 f'from an edge')
        plain_hist = np.histogram(plain, bins=len(hist), range=(-1.0, 1.0))[0]
        out[name] = dict(shape=list(feats.shape), values=int(kern.size),
                         counted=int(hist.sum()), moved=int(moved.sum()),
                         near_edge=int(near.sum()), l1_vs_plain=int(
                             np.abs(hist - plain_hist).sum()))
    return launches, out


def phase_pseudo_labels(card, data, cases):
    """Phase 17: the two-phase pseudo-label workflow at full width."""
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix='pfst_pseudo_')
    try:
        cfg, ckpt, hook_corpus, hook_shapes, t_hook = _pl_hook_run(data, root)
        _pl_check_shapes('hook sweep', hook_shapes, PL_VAL_TILES)
        _pl_check_corpus('hook sweep', hook_corpus, PL_VAL_TILES, True)
        cfg_path = osp.join(root, 'source_only.py')
        cfg.dump(cfg_path)
        train_corpus = osp.join(root, 'train_corpus')
        s_train, shapes, t_train = _pl_sweep(
            cfg_path, ckpt, train_corpus, [
                '--split', 'test', '--cfg-options',
                'data.test.img_dir=img_dir/train',
                'data.test.ann_dir=ann_dir/train'])
        _pl_check_shapes('train sweep', shapes, 0)
        _pl_check_corpus('train sweep', train_corpus, PL_TRAIN_TILES, False)
        val_corpus = osp.join(root, 'val_corpus')
        s_val, shapes, t_val = _pl_sweep(
            cfg_path, ckpt, val_corpus, [
                '--split', 'val', '--save-feats', '--feat-levels', '3',
                '--mean-sim', str(PL_MEAN_SIM)])
        _pl_check_shapes('val sweep', shapes, PL_VAL_TILES)
        sigma, excess = _pl_check_corpus('val sweep', val_corpus,
                                         PL_VAL_TILES, True)
        adaptor = _pl_adaptor_run(data, train_corpus, root)
        rcs = _pl_rcs_run(data, root)
        hist_launches, hists = _pl_histogram(cfg, ckpt, sigma)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    case = next(c for c in cases if c['shape'] == list(PL_SIM_SHAPE)
                and c['dtype'] == 'float32')

    def per_tile(summary):
        return {k: round(statistics.median(v), 4)
                for k, v in summary['times'].items() if v}

    fwd = 2 * PL_VAL_TILES + hist_launches + rcs['launches'][0]
    bwd = rcs['launches'][1]
    log(f'[pseudo] PseudoLabelingHookV4 halted the source-only loop at '
        f'iteration {PL_TRIGGER} of {PL_TRAIN_ITERS} ({t_hook:.1f} s, its '
        f'sweep of {PL_VAL_TILES} validation tiles included) and left '
        f'{PL_VAL_TILES} files; similarity launches by shape {hook_shapes}')
    log(f'[pseudo] tools/gen_pseudo_labels_torch.py on {card}: '
        f'{PL_TRAIN_TILES} Vaihingen train tiles {REQUEST_HW} without '
        f'features in {t_train:.1f} s, s a tile {per_tile(s_train)}; '
        f'{PL_VAL_TILES} validation tiles with level-3 features in '
        f'{t_val:.1f} s, s a tile {per_tile(s_val)} (infer: the model; '
        f'entropy: the histograms; write: the first file; sim: read back '
        f'and the similarity map; rewrite: the final file)')
    log(f'[pseudo] corpus read back with the port\'s reader: keys, shapes, '
        f'dtypes, thresholds and sigmas as the JAX tool writes them; sigma '
        f'@ {PL_MEAN_SIM} = {sigma:.6f}; gaussian_sim_feat_3 against the '
        f'plain version on the stored features: largest excess over '
        f'float16 rounding + {SIM_TOL} {excess:.3e}; kernel at '
        f'{list(PL_SIM_SHAPE)} gaussian fp32: call {case["ms"]:.4f} ms, '
        f'device {case["device_ms"]:.4f} ms, bound {case["bound_ms"]:.4f} ms '
        f'({case["bound_by"]}), plain {case["plain_ms"]:.3f} ms, '
        f'max_abs_err {case["max_abs_err"]:.2e} on {card}')
    log(f'[pseudo] DomainAdaptor on the corpus (pseudo_ratio {PL_RATIO}) '
        f'through train_segmentor: {PL_ADAPT_ITERS} iterations in '
        f'{adaptor["wall"]:.1f} s; the loader ran {adaptor["loads"]} times '
        f'(labels {adaptor["loader_values"]}, {adaptor["loader_kept"]:.3f} '
        f'kept on average); first batch target labels '
        f'{adaptor["values"]} ({adaptor["kept"]:.3f} kept), every loss '
        f'finite (last {json.dumps(adaptor["last"])})')
    log(f'[pseudo] rare-class sampling: class stats of {rcs["images"]} '
        f'Potsdam tiles in {rcs["stats_s"]:.1f} s (classes '
        f'{rcs["classes"]}); {PL_RCS_ITERS} PFGST iterations with {PL_RCS} '
        f'in {rcs["wall"]:.1f} s, classes drawn {rcs["drawn"]}, similarity '
        f'launches {rcs["launches"]}')
    log(f'[pseudo] similarity_histogram on the card: {json.dumps(hists)}')
    log(f'[pseudo] phase 17 in {time.time() - t_phase:.1f} s; similarity '
        f'launches forward {fwd}, backward {bwd}')
    return dict(launches=(fwd, bwd), hook_shapes=hook_shapes,
                times_train=per_tile(s_train), times_val=per_tile(s_val),
                sigma=sigma, adaptor=adaptor, rcs=rcs, hists=hists)


class _WandbStandIn(types.ModuleType):
    """A ``wandb`` module that records what it is given."""

    def __init__(self):
        super().__init__('wandb')
        self.logged = []

    def init(self, **kwargs):
        pass

    def log(self, payload, step=None):
        self.logged.append((step, payload))

    def finish(self):
        pass

    @staticmethod
    def Image(array):
        return ('image', np.asarray(array))

    @staticmethod
    def Histogram(array):
        return ('histogram', np.asarray(array))


def _check_wandb(wandb, hist):
    """The payloads at each log iteration: the log vars, and two density
    maps at the PFGST loss's resolution (64x64), finite."""
    logs = {h['iter']: h['log_vars'] for h in hist if h['kind'] == 'log'}
    density_hw = HOOK_VIS['vis|density_sim_feat'][1][0][1:3]
    steps = [step for step, _ in wandb.logged]
    if steps != list(range(HOOK_INTERVAL, HOOK_ITERS + 1, HOOK_INTERVAL)):
        raise AssertionError(f'[hooks] W&B logged at {steps}')
    for step, payload in wandb.logged:
        bad = [k for k, v in logs[step].items()
               if np.float32(payload.get(k)) != np.float32(v)]
        images = sorted(k for k in payload if k.startswith('vis|'))
        shapes = {payload[k][1].shape for k in images}
        if bad or images != ['vis|density_sim_feat/0',
                             'vis|density_sim_feat/1'] or \
                shapes != {density_hw} or not all(
                    np.isfinite(payload[k][1]).all() for k in images):
            raise AssertionError(f'[hooks] W&B payload at {step}: log vars '
                                 f'{bad} differ, images {images} {shapes}')
    return len(logs[steps[-1]]), images


class _VisProbe:
    """A hook that records, at its one iteration, the shape (in the JAX
    step's NHWC), dtype kind and device of every part of the step's
    visualisation states."""

    def __init__(self, at_iter):
        self.at_iter = at_iter
        self.seen = None
        self.calls = 0

    def before_run(self, ctx):
        pass

    def after_train_iter(self, ctx, log_vars, vis_states=None):
        self.calls += vis_states is not None
        if ctx['iter'] != self.at_iter or vis_states is None:
            return
        self.seen = {
            name: [(tuple(t.permute(0, 2, 3, 1).shape if t.dim() == 4
                          else t.shape),
                    'b' if t.dtype == torch.bool else
                    'f' if t.is_floating_point() else 'i', t.device.type)
                   for t in value] for name, value in vis_states.items()}

    def after_eval(self, ctx, metrics):
        pass

    def after_run(self, ctx):
        pass


def _trace_breakdown(path, steps):
    """From a Chrome trace: the kernel events' names, and the device ops
    (kernels, copies, sets) by total ms over the window, per step."""
    from pfst_tpu_torch.core.hooks.loggers import trace_kernels
    kernels = trace_kernels(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    ms = collections.Counter()
    for e in events:
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            ms[e['name']] += e['dur'] / 1e3 / steps
    spans = [(e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    window_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    return [e['name'] for e in kernels], ms, window_ms


def _hook_run(cfg, root, name, probe=None):
    """``train_segmentor`` for HOOK_ITERS iterations with ``cfg``'s hooks;
    returns (history, wall s, similarity launches)."""
    from pfst_tpu_torch.core.hooks import HOOKS
    if probe is not None:
        HOOKS.register_module(name='_VisProbe', force=True)(
            lambda: probe)
    hist = []
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    train_segmentor(cfg.copy(), work_dir=osp.join(root, name),
                    max_iters_override=HOOK_ITERS, seed=0, validate=False,
                    history=hist)
    torch.cuda.synchronize()
    wall, counts = time.time() - t0, _sim_counts()
    torch.cuda.empty_cache()
    _check_launches(f'hooks run {name}', counts, HOOK_ITERS)
    return hist, wall, counts


def _check_events(root, hist):
    """The run's one event file: every CRC holds, and the scalars at each
    log iteration equal the loop's log vars as float32."""
    from pfst_tpu_torch.core.hooks.tb_events import read_events
    paths = glob.glob(osp.join(root, 'tb', 'events.out.tfevents.*'))
    if len(paths) != 1:
        raise AssertionError(f'[hooks] expected one event file, got {paths}')
    events = read_events(paths[0])
    logs = {h['iter']: h['log_vars'] for h in hist if h['kind'] == 'log'}
    steps = [e['step'] for e in events[1:]]
    want = list(range(HOOK_INTERVAL, HOOK_ITERS + 1, HOOK_INTERVAL))
    if events[0]['file_version'] != 'brain.Event:2' or steps != want:
        raise AssertionError(f'[hooks] event file: version '
                             f'{events[0]["file_version"]}, steps {steps}')
    for e in events[1:]:
        got = dict(e['scalars'])
        ref = logs[e['step']]
        bad = [k for k in ref if got.get(k) != np.float32(ref[k])]
        if bad or got.keys() != ref.keys():
            raise AssertionError(f'[hooks] scalars at {e["step"]} differ '
                                 f'from the log vars: {bad}')
    return paths[0], len(events), {i: round(logs[i]['loss'], 6)
                                   for i in want}


def _check_vis(probe):
    if probe.seen is None or probe.calls != HOOK_ITERS:
        raise AssertionError(f'[hooks] the step gave visualisation states '
                             f'in {probe.calls} of {HOOK_ITERS} iterations')
    for name, parts in HOOK_VIS.items():
        got = probe.seen.get(name)
        if got is None or [g[:2] for g in got] != list(parts) or \
                any(g[2] != 'cuda' for g in got):
            raise AssertionError(f'[hooks] {name}: {got}, expected {parts} '
                                 f'on the card')
    if sorted(probe.seen) != sorted(HOOK_VIS):
        raise AssertionError(f'[hooks] vis states {sorted(probe.seen)}')


def _check_format_only(cfg, root, ckpt):
    """``tools/test_torch.py --format-only``: one PNG a tile of the test
    set (``_loop_config`` points it at the validation set), each the
    label map ``single_gpu_test`` returned for it."""
    from pfst_tpu_torch.datasets.pipelines.png import read_png
    cfg_path = osp.join(root, 'hooks_config.py')
    cfg.dump(cfg_path)
    out = osp.join(root, 'format')
    t0 = time.time()
    results = _tool('test_torch').main([cfg_path, ckpt, '--format-only',
                                        '--imgfile-prefix', out])
    t_test = time.time() - t0
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    files = sorted(os.listdir(out))
    names = sorted(osp.splitext(osp.basename(i['filename']))[0] + '.png'
                   for i in dataset.img_infos)
    if files != names or len(results) != len(dataset):
        raise AssertionError(f'[hooks] --format-only wrote {files} for '
                             f'{names}, {len(results)} results')
    for info, pred in zip(dataset.img_infos, results):
        name = osp.splitext(osp.basename(info['filename']))[0] + '.png'
        png = read_png(osp.join(out, name), 'unchanged')
        if png.dtype != np.uint8 or not np.array_equal(png, pred):
            raise AssertionError(f'[hooks] {name} differs from its label '
                                 f'map')
    return files, t_test


def phase_hooks(card, data):
    """Phase 18: the logging and profiling hooks, the visualisation states
    and ``--format-only`` at full width."""
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix='pfst_hooks_')
    try:
        pots, vaih, _ = data
        base = _loop_config(pots, vaih)
        base.merge_from_dict({
            'log_config.interval': HOOK_INTERVAL,
            'checkpoint_config.interval': HOOK_ITERS})
        cfg = base.copy()
        cfg.merge_from_dict({
            'log_config.hooks': [
                dict(type='TextLoggerHook', by_epoch=False),
                dict(type='TensorboardLoggerHook', interval=HOOK_INTERVAL)],
            'custom_hooks': [
                dict(type='WandbHookSeg', interval=HOOK_INTERVAL),
                dict(type='ProfilerHook', start_iter=HOOK_PROF_START,
                     num_steps=HOOK_PROF_STEPS),
                dict(type='_VisProbe')]})
        probe, wandb = _VisProbe(HOOK_PROF_START), _WandbStandIn()
        saved = sys.modules.get('wandb')
        sys.modules['wandb'] = wandb
        try:
            hist_a, wall_a, counts_a = _hook_run(cfg, root, 'A', probe)
        finally:
            if saved is None:
                del sys.modules['wandb']
            else:
                sys.modules['wandb'] = saved
        wandb_keys = _check_wandb(wandb, hist_a)
        hist_b, wall_b, counts_b = _hook_run(base, root, 'B')
        event_path, n_events, losses = _check_events(osp.join(root, 'A'),
                                                     hist_a)
        _check_vis(probe)
        traces = glob.glob(osp.join(root, 'A', 'profile', '*.json'))
        if len(traces) != 1:
            raise AssertionError(f'[hooks] expected one trace, got {traces}')
        names, device_ms, window_ms = _trace_breakdown(traces[0],
                                                       HOOK_PROF_STEPS)
        fwd = sum('neighborhood_sim_kernel' in n for n in names)
        bwd = sum('neighborhood_sim_bwd_kernel' in n for n in names)
        if (fwd, bwd) != (2 * HOOK_PROF_STEPS, HOOK_PROF_STEPS):
            raise AssertionError(f'[hooks] the trace names the similarity '
                                 f'kernels {fwd} and {bwd} times, expected '
                                 f'{2 * HOOK_PROF_STEPS} and '
                                 f'{HOOK_PROF_STEPS}')
        files, t_test = _check_format_only(
            base, root, osp.join(root, 'A', f'iter_{HOOK_ITERS}.pth'))
        trace_mb = osp.getsize(traces[0]) / 2**20
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def windows(hist):
        return {h['iter']: round(h['time'], 4) for h in hist
                if h['kind'] == 'log'}

    busy = sum(device_ms.values())
    top = device_ms.most_common(10)
    log(f'[hooks] {HOOK_ITERS} iterations with TensorboardLoggerHook, '
        f'WandbHookSeg (a stand-in wandb: {wandb_keys[0]} scalars and '
        f'{wandb_keys[1]} a payload) and ProfilerHook in {wall_a:.1f} s; '
        f'event file: {n_events} records, CRCs hold, loss by iteration '
        f'{losses} = the log vars; vis states {json.dumps(probe.seen)}')
    log(f'[hooks] trace of iterations {HOOK_PROF_START + 1}-'
        f'{HOOK_PROF_START + HOOK_PROF_STEPS} ({trace_mb:.1f} MiB): '
        f'{len(names)} kernel events, neighborhood_sim_kernel {fwd}, '
        f'neighborhood_sim_bwd_kernel {bwd}; device busy {busy:.3f} ms an '
        f'iteration of a window of {window_ms / HOOK_PROF_STEPS:.3f} ms '
        f'(first to last device op), on {card}')
    log('[hooks] costliest device ops an iteration (ms): ' + json.dumps(
        [[n[:90], round(t, 4)] for n, t in top]))
    log(f'[hooks] s/iter by log window, collect_vis and hooks on '
        f'{windows(hist_a)}, off {windows(hist_b)} (run B '
        f'{wall_b:.1f} s); similarity launches A {counts_a} B {counts_b}')
    log(f'[hooks] tools/test_torch.py --format-only: {files} decode to '
        f'single_gpu_test\'s label maps ({t_test:.1f} s); phase 18 in '
        f'{time.time() - t_phase:.1f} s')
    return dict(launches=(counts_a[0] + counts_b[0],
                          counts_a[1] + counts_b[1]),
                s_iter_vis=windows(hist_a), s_iter_plain=windows(hist_b),
                top=top, busy_ms=busy, window_ms=window_ms / HOOK_PROF_STEPS)


def model_config(path, img_size=None, dropout=True):
    """The model def at ``path`` at full width and depth with the
    ``adamw_40k`` schedule and the ViT configs' input normalization (for
    a backbone of other than 3 bands, such as PSPNet's 14, a per-band one
    of as many), its backbone at ``img_size`` where given (BEiT's and
    MAE's tables follow the patch grid); ``dropout=False`` turns every
    head's off."""
    cfg = Config.fromfile(path)
    bands = cfg.model['backbone'].get('in_channels', 3)
    cfg.img_norm_cfg = dict(VIT_NORM) if bands == 3 else dict(
        mean=[100.0 + 5 * i for i in range(bands)],
        std=[50.0 + 2 * i for i in range(bands)])
    if img_size:
        cfg.model['backbone']['img_size'] = img_size
    return _with_adamw_40k(cfg, dropout)


def tf_config(name, img_size=None, dropout=True):
    """A phase-19 UPerNet (``TF_MODELS``), BEiT and MAE at ``img_size``
    (default: the request size), Swin as it stands."""
    path, hw = TF_MODELS[name]
    return model_config(path, None if name == 'swin' else img_size or hw[0],
                        dropout)


def _tf_serving(name, cfg, model, hw, layers=TF_LAYERS, stride=4,
                tag='transformers'):
    """N_TF_REQUESTS requests as phase 9 serves them: logits -> labels,
    then the feature state through the similarity kernel, on the decoded
    features at 1/``stride`` of the request; 2 x ``layers`` flash
    forwards and 1 similarity forward a request."""
    infer, state_fn = make_inference_fn(model), make_state_fn(model)
    imgs = [_request(cfg, 900 + seed, hw) for seed in range(N_TF_REQUESTS)]
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for i, img in enumerate(imgs):
        t0 = time.time()
        img = img.cuda()
        logits = infer(img)
        labels = _finalize_views(model, [logits], [{'flip': False}], hw)
        st = state_fn(img)
        sim = st['sim_feat'].cpu()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        if labels.shape != hw or not (
                0 <= labels.min() and labels.max() < model.num_classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f'[{tag} serve {name}] request {i}: '
                                 f'bad output')
        if tuple(sim.shape) != (1, SIM_K**2, hw[0] // stride,
                                hw[1] // stride) or \
                not torch.isfinite(sim).all():
            raise AssertionError(f'[{tag} serve {name}] request {i}: '
                                 f'bad sim_feat {tuple(sim.shape)}')
    counts, sims = _flash_counts(), cuda_neighborhood_similarity.launches
    warm = statistics.median(times[1:])
    log(f'[{tag} serve {name}] {N_TF_REQUESTS} requests of {hw}: ms '
        f'per request {[round(t, 2) for t in times]}, warm median '
        f'{warm:.2f}; flash launches fwd/dkv/dq {counts}, similarity {sims} '
        f'on features {tuple(st["decoded_features"].shape)}')
    want = (2 * layers * N_TF_REQUESTS, 0, 0)
    if counts != want or sims != N_TF_REQUESTS:
        raise AssertionError(f'[{tag} serve {name}] launched flash '
                             f'{counts} (want {want}) and similarity {sims}')
    return dict(flash=counts, sim=sims, ms=times, warm_ms=warm,
                sim_shape=list(st['decoded_features'].shape))


def _tf_tables(module):
    return {n: p for n, p in module.named_parameters()
            if n.endswith('relative_position_bias_table')}


def _train_runs(cfg, hw, layers, tag, card, watch):
    """TF_TRAIN_STEPS supervised steps at full width, batch 2 of ``hw``,
    in fp32 and then, on the same train state, in bf16 autocast (the
    segmentor's ``dtype``, which a config's ``model.dtype`` sets): one
    weight initialisation for both. ``watch(student)`` names the
    parameters that must move. Returns {'fp32': (s/iter, flash launches),
    'bf16': ...}."""
    _, state, step = _vit_train_setup(cfg)
    out = {}
    for kind, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        state.student.dtype = dtype
        state, out[kind] = _train_steps(state, step, cfg, hw, layers,
                                        f'{tag} {kind}', card,
                                        watch(state.student))
        torch.cuda.empty_cache()
    return out


def _train_steps(state, step, cfg, hw, layers, tag, card, watch):
    """The steps of one type; fails on non-finite log vars, on other than
    ``layers`` launches of each flash kernel a step, and where a parameter
    of ``watch`` (name -> parameter) did not move. Returns (state,
    (s/iter, flash launches))."""
    gen = torch.Generator().manual_seed(3)
    start = {n: p.detach().clone() for n, p in watch.items()}
    batches = [_vit_batch(cfg, 4000 + i, hw) for i in range(TF_TRAIN_STEPS)]
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.time()
        state, log_vars = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        vals = {k: float(v) for k, v in log_vars.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f'[{tag}] step {i}: non-finite log vars '
                                 f'{vals}')
    counts = _flash_counts()
    still = [n for n, p in watch.items() if torch.equal(p, start[n])]
    s_iter = statistics.median(times[TRAIN_WARMUP:])
    log(f'[{tag}] {TF_TRAIN_STEPS} steps, batch 2 of {hw}: s/iter '
        f'{[round(t, 4) for t in times]}, median after {TRAIN_WARMUP} '
        f'warm-ups {s_iter:.4f} s on {card}; flash launches fwd/dkv/dq '
        f'{counts}; moved {len(watch) - len(still)} of {len(watch)} watched '
        f'parameters; last log vars '
        f'{json.dumps({k: round(v, 6) for k, v in vals.items()})}')
    if counts != (layers * TF_TRAIN_STEPS,) * 3:
        raise AssertionError(f'[{tag}] expected {layers} launches of each '
                             f'flash kernel a step, got {counts}')
    if not watch or still:
        raise AssertionError(f'[{tag}] parameters that did not move: '
                             f'{still or "none watched"}')
    return state, (s_iter, counts)


def _tf_watch(student):
    """Phase 19's watched parameters: every relative-position table, one
    an attention layer."""
    tables = _tf_tables(student)
    if len(tables) != TF_LAYERS:
        raise AssertionError(f'{len(tables)} relative-position tables, '
                             f'want {TF_LAYERS}')
    return tables


def _branch_params(backbone, masks):
    """The parameter-name prefixes under residual branches that drop path
    dropped for every sample of the batch (``masks`` as ``backbone`` drew
    them, one a block): their gradients are zero, on the card as on the
    CPU."""
    if hasattr(backbone, 'stages'):     # Swin
        blocks = [f'backbone.stages.{i}.blocks.{j}.'
                  for i, stage in enumerate(backbone.stages)
                  for j in range(len(stage.blocks))]
        branch = (('attn.', 'norm1.'), ('ffn.', 'norm2.'))
    else:
        blocks = [f'backbone.layers.{i}.' for i in range(len(backbone.layers))]
        branch = (('attn.', 'ln1.', 'gamma_1'), ('ffn.', 'ln2.', 'gamma_2'))
    out = []
    for prefix, keep in zip(blocks, masks):
        for b in range(2):
            if keep is not None and not bool(keep[b].any()):
                out += [prefix + p for p in branch[b]]
    return tuple(out)


def _tf_card_vs_cpu(name):
    """Phase 11's check for an A13 model: one supervised step on the card
    and on the CPU from the same weights and batch at 2 x 128^2 (BEiT at
    img_size 128), dropout off, TF32 off, the configs' drop path with the
    same masks on both sides (drawn on the CPU from the step's seed;
    recorded and compared); every relative-position table gets a non-zero
    gradient where its branch was kept."""
    from pfst_tpu_torch.models.backbones import beit as beit_mod
    from pfst_tpu_torch.models.backbones import swin as swin_mod
    cfg = tf_config(name, img_size=TF_CHECK_HW[0], dropout=False)
    batch = {k: v.cpu() for k, v in _vit_batch(cfg, 7, TF_CHECK_HW).items()}
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    draw = beit_mod.drop_path_masks
    drawn = {}
    sides, zero_tables = {}, {}
    try:
        for side, device, n in (('card', 'cuda', threads),
                                ('cpu', 'cpu', threads), ('cpu1', 'cpu', 1)):
            torch.set_num_threads(n)

            def record(*args, side=side):
                drawn[side] = draw(*args)
                return drawn[side]
            beit_mod.drop_path_masks = swin_mod.drop_path_masks = record
            _, state, step = _vit_train_setup(cfg, device)
            _, log_vars = step(state, {k: v.to(device)
                                       for k, v in batch.items()},
                               torch.Generator().manual_seed(5))
            sides[side] = ({k: float(v) for k, v in log_vars.items()},
                           _grad_groups(state))
            zero_tables[side] = sorted(
                n for n, p in _tf_tables(state.student).items()
                if not p.grad.any())
            if side == 'card':
                card_grads = {n: p.grad for n, p in
                              state.student.named_parameters()}
                backbone = state.student.backbone
    finally:
        beit_mod.drop_path_masks = swin_mod.drop_path_masks = draw
        torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    same = all(
        (a is None and b is None) or (a is not None and b is not None
                                      and torch.equal(a.cpu(), b.cpu()))
        for other in ('cpu', 'cpu1')
        for a, b in zip(drawn['card'], drawn[other]))
    dropped = _branch_params(backbone, drawn['card'])
    zero = sorted(n for n, g in card_grads.items() if not g.any())
    expected = sorted(n for n in card_grads if n.startswith(dropped))
    want_tables = [n for n in expected
                   if n.endswith('relative_position_bias_table')]
    tag = f'[transformers card-vs-cpu {name}] {TF_CHECK_HW}'
    log(f'{tag}: drop-path masks equal on both sides {same}; branches '
        f'dropped for the whole batch {len(dropped) // 2}; tables with a '
        f'zero gradient card {zero_tables["card"]} cpu '
        f'{zero_tables["cpu"]}')
    if not same or zero != expected or any(
            zero_tables[s] != want_tables for s in sides):
        raise AssertionError(f'{tag}: masks equal {same}, zero gradients '
                             f'{zero[:6]} (expected {expected[:6]})')
    _check_train_sides(sides, threads, tag, allowed_zero=len(expected))


def _tf_loop(card, data):
    """BEiT UPerNet through ``train_segmentor`` on phase 13's packs: the
    source-only config with its model replaced by ``upernet_beit.py`` at
    img_size 512 (its 512^2 crops) and 6 classes, evaluated in slide mode
    (512^2 windows, stride 341) on the 1024^2 Vaihingen validation tiles,
    then ``tools/test_torch.py`` on the checkpoint (``_config_run``); 12
    launches of each flash kernel an iteration, and forwards for the
    evaluations."""
    pots, vaih, _ = data
    cfg = _config_loop_config(SOURCE_ONLY, CONFIG_LOOP_ITERS, pots, vaih)
    model = Config.fromfile(BEIT).model
    model['backbone']['img_size'] = TF_LOOP_CROP
    for head in ('decode_head', 'auxiliary_head'):
        model[head]['num_classes'] = 6
    model['test_cfg'] = dict(mode='slide',
                             crop_size=(TF_LOOP_CROP, TF_LOOP_CROP),
                             stride=(TF_LOOP_STRIDE, TF_LOOP_STRIDE))
    cfg.model = model
    out = _config_run(card, 'beit_upernet', cfg, False)
    counts = _flash_counts()
    log(f'[transformers loop] flash launches fwd/dkv/dq {counts} in '
        f'{CONFIG_LOOP_ITERS} iterations, two slide-mode evaluations')
    if counts[1:] != (TF_LAYERS * CONFIG_LOOP_ITERS,) * 2 or \
            counts[0] <= counts[1]:
        raise AssertionError(f'[transformers loop] flash launches {counts}')
    out['flash'] = counts
    return out


def phase_transformers(card, data, ab_cases):
    """Phase 19: BEiT-B, MAE-B (640^2) and Swin-T (512^2) UPerNet at full
    width: requests, supervised steps in fp32 and then bf16 autocast,
    BEiT, MAE and Swin card against CPU, BEiT through the loop; the flash
    kernels run with the tables' ab throughout."""
    t0 = time.time()
    serve, train = {}, {}
    for name, (_, hw) in TF_MODELS.items():
        cfg = tf_config(name)
        model = init_segmentor(cfg)
        serve[name] = _tf_serving(name, cfg, model, hw)
        del model
        torch.cuda.empty_cache()
        for tag, run in _train_runs(cfg, hw, TF_LAYERS,
                                    f'transformers train {name}', card,
                                    _tf_watch).items():
            train[(name, tag)] = run
    for name in ('beit', 'mae', 'swin'):
        _tf_card_vs_cpu(name)
    loop = _tf_loop(card, data)
    kernel_ms = {c['bias']: {k: (c['device_ms'][k], c['bound_ms'][k])
                             for k in ('fwd', 'dkv', 'dq')}
                 for c in ab_cases if c['dtype'] == 'float32'
                 and 'device_ms' in c}
    launches = [sum(r['flash'][i] for r in serve.values())
                + sum(t[1][i] for t in train.values()) + loop['flash'][i]
                for i in range(3)]
    log(f'[transformers] warm ms per request ' + ', '.join(
        f'{n} {r["warm_ms"]:.2f}' for n, r in serve.items())
        + '; s/iter batch 2 ' + ', '.join(
            f'{n} {t} {v[0]:.4f}' for (n, t), v in train.items())
        + f'; fp32 device ms per kernel (and bound) {kernel_ms}; flash '
        f'launches fwd/dkv/dq {launches}; phase {time.time() - t0:.1f} s '
        f'on {card}')
    return dict(serve=serve, train=train, loop=loop, launches=launches)


def _a13_watch(student):
    """Phase 20's watched parameter: the decode head's first."""
    name, p = next(iter(student.decode_head.named_parameters()))
    return {f'decode_head.{name}': p}


def phase_a13_heads(card):
    """Phase 20: A13's defs, every width as it stands and at the
    card-against-CPU checks' depth (``_check_depth``, ``_shallow_resnets``),
    on the ViT (SETR naive, PUP and MLA with ViT-L
    at 768^2; Segmenter and DPT with ViT-B at 512^2), on the ResNet
    (PSPNet, Semantic FPN, ANN at 512^2), on MiT-B0 (SegFormer), on
    Twins PCPVT-S (UPerNet, Semantic FPN) and on the CNN backbones (UNet,
    HRNet, ConvNeXt, MobileNetV3, the real-time nets) at 512^2, the
    attention and context heads on the ResNet-50-D8 (DANet, NonLocal,
    GCNet, DNL, APCNet, DMNet, EMANet, ISANet, CCNet, PSANet, EncNet) and
    FastFCN's JPU at 512^2, and the cascades (OCRNet on HRNet and the
    ResNet, PointRend), K-Net and STDC at 512^2, each from its config as
    it stands with seeded weights: requests (logits -> labels, then the
    feature state through the similarity kernel), supervised steps in fp32
    and bf16 autocast (DANet's, EncNet's, the cascades', K-Net's and
    STDC's with their extra losses), each def's wall seconds and peak
    allocation; ``A13_CHECKED`` card against CPU (``A13_CHECK_BACKBONE``'s
    settings there, the heads' 0-d ``gamma``s at ``GAMMA_SCALE``);
    ``A17_BACKBONES`` under the leaf config's head, one request each;
    ``OHEMPixelSampler`` alone card against CPU. Every attention layer on the
    flash kernels (MiT's and PCPVT's with keys shorter than the queries,
    K-Net's between its kernels)."""
    t0 = time.time()
    serve, train, def_s, def_gb = {}, {}, {}, {}
    for name, (hw, layers, stride) in A13_MODELS.items():
        t_def = time.time()
        torch.cuda.reset_peak_memory_stats()
        cfg = model_config(osp.join(MODEL_DEFS, f'{name}.py'))
        # at the card-against-CPU checks' depth, every width as it stands:
        # the backbone's attention layers go, the head's stay
        backbone = cfg.model['backbone']
        layers -= _attention_blocks(backbone)
        _check_depth(backbone)
        layers += _attention_blocks(backbone)
        with _shallow_resnets():
            model = init_segmentor(cfg)
            serve[name] = _tf_serving(name, cfg, model, hw, layers, stride,
                                      'a13')
            del model
            torch.cuda.empty_cache()
            for tag, run in _train_runs(cfg, hw, layers,
                                        f'a13 train {name}', card,
                                        _a13_watch).items():
                train[(name, tag)] = run
        def_s[name] = round(time.time() - t_def, 1)
        def_gb[name] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    a17 = {}
    for name, backbone in A17_BACKBONES.items():
        t_def = time.time()
        a17[name] = _a17_serving(card, name, backbone)
        def_s[name] = round(time.time() - t_def, 1)
    checked = {}
    for name in A13_CHECKED:
        t_def = time.time()
        # phase 11's check (a ResNet's blocks at phase 8's BN scale)
        cfg = model_config(osp.join(MODEL_DEFS, f'{name}.py'), dropout=False)
        cfg.model['backbone'].update(A13_CHECK_BACKBONE.get(name, {}))
        _check_depth(cfg.model['backbone'])
        with _shallow_resnets():
            checked[name] = _supervised_card_vs_cpu(
                cfg, TF_CHECK_HW, f'[a13 card-vs-cpu {name}]')
        def_s[f'{name} card-vs-cpu'] = round(time.time() - t_def, 1)
    t_def = time.time()
    ohem = _ohem_card_vs_cpu(card)
    def_s['ohem card-vs-cpu'] = round(time.time() - t_def, 1)
    launches = [sum(r['flash'][i] for r in serve.values())
                + sum(t[1][i] for t in train.values()) for i in range(3)]
    log('[a13] warm ms per request ' + ', '.join(
        f'{n} {r["warm_ms"]:.2f}' for n, r in serve.items())
        + '; s/iter batch 2 ' + ', '.join(
            f'{n} {t} {v[0]:.4f}' for (n, t), v in train.items())
        + f'; flash launches fwd/dkv/dq {launches}, similarity '
        f'{sum(r["sim"] for r in serve.values())}; wall s a def (requests '
        f'and steps) and a check {json.dumps(def_s)}; peak GiB allocated '
        f'a def {json.dumps(def_gb)}; STDC card against CPU '
        f'{json.dumps(checked["stdc"])}; phase {time.time() - t0:.1f} s on '
        f'{card}')
    return dict(serve=serve, train=train, launches=launches, a17=a17,
                ohem=ohem, checked=checked)


def _attention_blocks(backbone):
    """The attention layers a forward of ``backbone`` (a config) runs: a
    ViT's layers, MiT's and PCPVT's blocks; none in a CNN."""
    kind = backbone['type']
    if kind == 'VisionTransformer':
        return backbone['num_layers']
    if kind in ('MixVisionTransformer', 'MiT'):
        return sum(backbone['num_layers'])
    if kind == 'PCPVT':
        return sum(backbone['depths'])
    return 0


def _check_depth(backbone):
    """``backbone`` (a config) at the card-against-CPU steps' depth, its
    widths as they are: a ViT of CHECK_VIT_LAYERS layers (or as many as it
    taps) tapping its last ones, one block a stage of MiT, PCPVT and
    ConvNeXt, one block a branch of HRNet, one conv a UNet stage; other
    backbones as they stand (ResNets: ``_shallow_resnets``)."""
    kind = backbone['type']
    if kind == 'VisionTransformer':
        n = len(backbone.get('out_indices', (11,)))
        layers = max(n, CHECK_VIT_LAYERS)
        backbone.update(num_layers=layers, out_indices=tuple(
            range(layers - n, layers)))
    elif kind == 'UNet':
        # one conv a stage of the encoder's num_stages and the decoder's
        stages = backbone.get('num_stages', 5)
        backbone['enc_num_convs'] = (1,) * stages
        backbone['dec_num_convs'] = (1,) * (stages - 1)
    elif kind in ('MixVisionTransformer', 'MiT'):
        backbone['num_layers'] = (1,) * len(backbone['num_layers'])
    elif 'depths' in backbone:
        backbone['depths'] = (1,) * len(backbone['depths'])
    elif kind == 'ConvNeXt':
        from pfst_tpu_torch.models.backbones.convnext import ARCH
        spec = dict(ARCH[backbone['arch']])
        backbone['arch'] = dict(spec, depths=(1,) * len(spec['depths']))
    elif kind == 'HRNet':
        for stage in backbone['extra'].values():
            stage['num_blocks'] = (1,) * len(stage['num_blocks'])


@contextlib.contextmanager
def _shallow_resnets():
    """ResNet-50 and -101 (their bottleneck widths) with one block a stage
    while the context is open."""
    from pfst_tpu_torch.models.backbones.resnet import ResNet
    saved = ResNet.arch_settings
    ResNet.arch_settings = {**saved, **{
        d: (saved[d][0], (1,) * len(saved[d][1])) for d in (50, 101)}}
    try:
        yield
    finally:
        ResNet.arch_settings = saved


def _a17_serving(card, name, backbone):
    """One full-width 512^2 request of the leaf config's DeepLabV3+ with
    ``backbone`` in place of its ResNetV1c: logits -> labels."""
    cfg = Config.fromfile(LEAF)
    cfg.model['backbone'] = dict(backbone,
                                 norm_cfg=cfg.model['backbone']['norm_cfg'])
    model = init_segmentor(cfg)
    img = _request(cfg, 1700, (PATCH, PATCH)).cuda()
    infer = make_inference_fn(model)
    torch.cuda.synchronize()
    t0 = time.time()
    logits = infer(img)
    labels = _finalize_views(model, [logits], [{'flip': False}],
                             (PATCH, PATCH))
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    if labels.shape != (PATCH, PATCH) or not torch.isfinite(logits).all():
        raise AssertionError(f'[a17 serve {name}] bad output')
    log(f'[a17 serve {name}] {backbone["type"]} under the leaf config\'s '
        f'DeepLabV3+ head, {n_params} parameters: one {PATCH}^2 request '
        f'{ms:.1f} ms (first use), logits {tuple(logits.shape)} finite on '
        f'{card}')
    return dict(ms=ms, params=n_params)


def _ohem_logits(rs, gt, c):
    """Logits a trained net might give: the label's class ahead by 0-6,
    so the gt probabilities spread over (0, 1) (``tests/
    test_torch_cascade_knet_stdc.py::_trained_logits``), NCHW."""
    logits = rs.randn(*gt.shape, c)
    safe = np.where(gt == 255, 0, gt)
    np.put_along_axis(logits, safe[..., None],
                      rs.uniform(0.0, 6.0, gt.shape + (1,)), axis=-1)
    return np.ascontiguousarray(logits.astype(np.float32).transpose(
        0, 3, 1, 2))


def _ohem_card_vs_cpu(card):
    """``OHEMPixelSampler`` alone on the card against the CPU at
    ``OHEM_SHAPE`` with STDC's ``min_kept``, with its ``thresh`` and
    without: the weights equal, but where a pixel's value ties the k-th
    one to the last bit on one side (a C2 difference, counted), and the
    threshold deciding for some but not all valid pixels."""
    from pfst_tpu_torch.core.seg import OHEMPixelSampler
    b, c, h, w = OHEM_SHAPE
    rs = np.random.RandomState(13)
    gt = rs.randint(0, c, (b, h, w))
    gt[:, :h // 16] = 255
    logits = torch.from_numpy(_ohem_logits(rs, gt, c))
    label = torch.from_numpy(gt)
    out = {}
    for thresh in (OHEM_CFG['thresh'], None):
        sampler = OHEMPixelSampler(thresh=thresh,
                                   min_kept=OHEM_CFG['min_kept'])
        got = sampler.sample(logits.cuda(), label.cuda()).cpu()
        want = sampler.sample(logits, label)
        valid = label != 255
        kept = float(want[valid].mean())
        differ = int((got != want).sum())
        # the CPU's cut of each image (the sampler's own formula): a pixel
        # whose value lies within 4 fp32 ulps of it is a tie
        safe = torch.where(valid, label, 0)[:, None]
        n_px, k = h * w, OHEM_CFG['min_kept']
        if thresh is not None:
            v = torch.softmax(logits, dim=1).gather(1, safe)[:, 0]
            flat = torch.where(valid, v, torch.inf).reshape(b, -1)
            idx = (valid.reshape(b, -1).sum(1) - 1).clamp(0, k)
            cut = flat.sort(1).values.gather(1, idx[:, None])[:, 0] \
                .clamp(min=thresh)
        else:
            v = -F.log_softmax(logits, dim=1).gather(1, safe)[:, 0]
            flat = torch.where(valid, v, -torch.inf).reshape(b, -1)
            cut = flat.sort(1).values[:, n_px - k]
        near = (v - cut[:, None, None]).abs() <= \
            4 * torch.finfo(torch.float32).eps * cut.abs()[:, None, None]
        ties = int(((got != want) & near).sum())
        out[str(thresh)] = dict(kept=kept, differ=differ, ties=ties)
        if not (0 < kept < 1) or differ != ties:
            raise AssertionError(f'[ohem card-vs-cpu] thresh {thresh}: '
                                 f'{differ} weights differ ({ties} ties), '
                                 f'valid share kept {kept}')
    log(f'[ohem card-vs-cpu] {OHEM_SHAPE}, min_kept '
        f'{OHEM_CFG["min_kept"]}: thresh {OHEM_CFG["thresh"]} / None: '
        f'valid share kept {out[str(OHEM_CFG["thresh"])]["kept"]:.6f} / '
        f'{out["None"]["kept"]:.6f}, weights that differ '
        f'{out[str(OHEM_CFG["thresh"])]["differ"]} / {out["None"]["differ"]}'
        f' (ties at the k-th value, C2: '
        f'{out[str(OHEM_CFG["thresh"])]["ties"]} / {out["None"]["ties"]}) '
        f'on {card}')
    return out


# ------------------------------------------------------------------ phase 21
def _quant_geometry(conv, qw, geom):
    """A conv's or Dense's geometry as phase 21 prints it."""
    if not conv:
        return f'dense K={qw.shape[1]}'
    o, cg, kh, kw = qw.shape
    (s, _), _, (d, _), g = geom
    kind = 'depthwise' if g > 1 and cg == 1 else 'grouped' if g > 1 \
        else f'{kh}x{kw}'
    return f'{kind} K={cg * kh * kw} s{s} d{d}'


def _exact_observer(held):
    """``int8_inference``'s observer for phase 21 (a): each layer's sums
    from the card route against the float64 plain version on the same int8
    operands, on the card; ``held`` gets path -> (geometry, elements,
    elements that differ)."""
    def observe(path, conv, qx, qw, geom, sums):
        plain = quant.plain_int_conv2d(qx, qw, *geom) if conv \
            else quant.plain_int_linear(qx, qw)
        if sums.dtype != torch.int32 or sums.device.type != 'cuda':
            raise AssertionError(f'[quant] {path}: sums {sums.dtype} on '
                                 f'{sums.device}, not the card route')
        held[path] = (_quant_geometry(conv, qw, geom), sums.numel(),
                      int((sums.double() != plain).sum()))
    return observe


def _quant_exact(card):
    """Phase 21 (a): every quantized layer of the leaf model on one
    QUANT_HW request (dynamic scales), a Dense at ViT-B's MLP and
    ResNeXt-50 32x4d's layer-4 grouped conv at 512^2 D8: the card route's
    int32 sums equal the float64 plain version's, element for element."""
    cfg = Config.fromfile(QAT_LEAF)
    model = init_segmentor(cfg)
    img = _request(cfg, 2100, QUANT_HW).cuda()
    held = {}
    before = dict(quant.launches)
    with torch.inference_mode():
        # the layer set: the paths a calibration records
        layers = quant.calibrate_act_scales(model.inference_logits, [img])
        with quant.int8_inference(observer=_exact_observer(held)):
            logits, _ = model.inference_logits(img)
    routed = {k: quant.launches[k] - before[k] for k in before}
    if not torch.isfinite(logits).all() or set(held) != set(layers) or \
            sum(routed.values()) != len(held):
        raise AssertionError(f'[quant] leaf model: {len(held)} layers of '
                             f'{len(layers)}, route launches {routed}')
    gen = torch.Generator(device='cuda').manual_seed(21)

    def r8(*shape):
        return torch.randint(-127, 128, shape, device='cuda', generator=gen,
                             dtype=torch.int8)

    extra = {'dense (1, 1025, 768) -> 3072': (False, r8(1, 1025, 768),
                                              r8(3072, 768), None),
             'resnext layer4 grouped (1, 1024, 64, 64), 32 groups, d4': (
                 True, r8(1, 1024, 64, 64), r8(1024, 32, 3, 3),
                 ((1, 1), (4, 4), (4, 4), 32))}
    for name, (conv, qx, qw, geom) in extra.items():
        sums = quant.cuda_int_conv2d(qx, qw, *geom) if conv \
            else quant.int_linear(qx, qw)
        _exact_observer(held)(name, conv, qx, qw, geom, sums)
    geoms = sorted({g for g, _, _ in held.values()})
    bad = {p: d for p, (_, _, d) in held.items() if d}
    log(f'[quant exact] {len(held) - len(extra)} quantized layers of the '
        f'leaf model at {QUANT_HW} (route launches {routed}) and '
        f'{list(extra)}: {sum(n for _, n, _ in held.values())} int32 sums '
        f'against float64 on the card, {sum(bad.values())} differ; '
        f'geometries {geoms} on {card}')
    if bad:
        raise AssertionError(f'[quant] int32 sums differ from float64: {bad}')
    return model, cfg, img


def _qx_recorder(store):
    def observe(path, conv, qx, qw, geom, sums):
        store.setdefault(path, []).append(qx.cpu())
    return observe


def _quant_card_vs_cpu(card, model, cfg, img):
    """Phase 21 (b): int8 serving of the leaf model on the card against
    int8 on the CPU (all threads, and one), TF32 off, with the CPU's
    calibrated scales. The int8 program amplifies any fp32 difference
    upstream of a quantizer: a BN output one ulp off on the card moves an
    input across a rounding boundary, the flipped int8 value moves the
    next layer's inputs, and so on (on the H100 the first 2 flips at the
    second stem conv, 20 % of all ``qx`` by the head; with BN folded the
    first flip comes later and as many follow; ``PERF.md`` §6), while the
    CPU repeats itself across thread counts. So the card's int8 output is another
    rounding of the same fp32 program, and it is held to that: its logit
    gap to the CPU's int8 at most ``QUANT_ROUNDINGS`` times the CPU's own
    int8-against-fp32 gap, and its argmax disagreement with the CPU's
    int8 at most ``QUANT_ROUNDINGS`` times the CPU int8's with fp32. The
    exactness of the card route itself is (a)'s."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    try:
        cpu_model = copy.deepcopy(model).cpu()
        x = img.cpu()
        with torch.inference_mode():
            scales = quant.calibrate_act_scales(cpu_model.inference, [x])
            fp32 = cpu_model.inference_logits(x)[0]
            qx = {'card': {}, 'cpu': {}, 'cpu1': {}}
            with quant.int8_inference(scales,
                                      observer=_qx_recorder(qx['cpu'])):
                cpu = cpu_model.inference_logits(x)[0]
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with quant.int8_inference(scales,
                                          observer=_qx_recorder(qx['cpu1'])):
                    cpu1 = cpu_model.inference_logits(x)[0]
            finally:
                torch.set_num_threads(threads)
            with quant.int8_inference(scales,
                                      observer=_qx_recorder(qx['card'])):
                on_card = model.inference_logits(img)[0].cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old

    def flips(side):
        return sum(int((a != b).sum()) for p in qx['cpu']
                   for a, b in zip(qx[side][p], qx['cpu'][p]))

    def disagree(a, b):
        return float((a.argmax(1) != b.argmax(1)).float().mean())

    own = float((cpu - fp32).abs().max())
    own_dis = disagree(cpu, fp32)
    gap = float((on_card - cpu).abs().max())
    dis = disagree(on_card, cpu)
    differ, self_differ = flips('card'), flips('cpu1')
    total = sum(a.numel() for v in qx['cpu'].values() for a in v)
    first = next((p for p in qx['cpu'] if any(
        (a != b).any() for a, b in zip(qx['card'][p], qx['cpu'][p]))), None)
    log(f'[quant card-vs-cpu] {QUANT_HW}, {len(scales)} calibrated scales: '
        f'int8 logit gap card against CPU {gap:.3e} (limit '
        f'{QUANT_ROUNDINGS} x the CPU\'s int8 against fp32 gap {own:.3e}), '
        f'argmax agreement {1 - dis:.6f} (CPU int8 against fp32 '
        f'{1 - own_dis:.6f}); qx elements that differ {differ} of {total}, '
        f'the first at {first}; the CPU with 1 thread against all: logit '
        f'gap {float((cpu1 - cpu).abs().max()):.3e}, qx elements that '
        f'differ {self_differ} ({time.time() - t0:.1f} s) on {card}')
    if not (gap <= QUANT_ROUNDINGS * own and
            dis <= QUANT_ROUNDINGS * own_dis):
        raise AssertionError('[quant] card and CPU int8 disagree beyond '
                             'another rounding')
    return dict(gap=gap, own=own, agree=1 - dis, own_agree=1 - own_dis,
                qx_differ=differ, qx_total=total)


def _quant_loop(card, data):
    """Phase 21 (d): the qat leaf config through ``train_segmentor`` on
    phase 13's packs, scored as int8 in the loop and by the CLIs: run A
    QUANT_LOOP_ITERS iterations (checkpoints at QUANT_RESUME and the end,
    an int8 eval with dynamic scales at the end); ``tools/
    calibrate_int8_torch.py`` on its last checkpoint; run B resumed from
    QUANT_RESUME with those scales in ``evaluation.act_scales``;
    ``tools/test_torch.py --quant-int8`` (with ``--act-scales`` for B) on
    each run's last checkpoint within 0.01 mIoU points of its loop."""
    pots, vaih, _ = data
    root = tempfile.mkdtemp(prefix='pfst_qat_')
    try:
        cfg = _config_loop_config(QAT_LEAF, QUANT_LOOP_ITERS, pots, vaih)
        cfg.merge_from_dict({'evaluation.quant_int8': True,
                             'checkpoint_config.interval': QUANT_RESUME})
        scales_path = osp.join(root, 'scales.json')
        out, losses = {}, {}
        for name in ('A', 'B'):
            run_cfg = cfg.copy()
            kwargs = {}
            if name == 'B':
                with open(scales_path) as f:
                    run_cfg.merge_from_dict({'evaluation.act_scales':
                                             json.load(f)})
                kwargs['resume_from'] = osp.join(
                    root, 'A', f'iter_{QUANT_RESUME}.pth')
            hist = []
            before = sum(quant.launches.values())
            t0 = time.time()
            train_segmentor(run_cfg, work_dir=osp.join(root, name),
                            max_iters_override=QUANT_LOOP_ITERS, seed=0,
                            history=hist, **kwargs)
            wall = time.time() - t0
            logs = [h for h in hist if h['kind'] == 'log']
            losses[name] = [round(h['log_vars']['decode.loss_ce'], 4)
                            for h in logs]
            if not logs or not all(np.isfinite(v) for h in logs
                                   for v in h['log_vars'].values()):
                raise AssertionError(f'[quant loop] run {name}: non-finite '
                                     f'losses {losses[name]}')
            loop_miou = next(h['metrics']['mIoU'] for h in hist
                             if h['kind'] == 'eval')
            routed = sum(quant.launches.values()) - before
            ckpt = osp.join(root, name, f'iter_{QUANT_LOOP_ITERS}.pth')
            cfg_path = osp.join(root, f'{name}.py')
            run_cfg.dump(cfg_path)
            if name == 'A':
                _tool('calibrate_int8_torch').main(
                    [cfg_path, ckpt, '-o', scales_path, '-n', '2'])
            args = [cfg_path, ckpt, '--eval', 'mIoU', '--quant-int8'] + (
                ['--act-scales', scales_path] if name == 'B' else [])
            res = _tool('test_torch').main(args)
            out[name] = dict(loop=loop_miou, cli=res['mIoU'], wall=wall,
                             routed=routed)
            if abs(res['mIoU'] - loop_miou) > LOOP_MIOU_TOL + 1e-12 or \
                    not routed:
                raise AssertionError(f'[quant loop] run {name}: CLI int8 '
                                     f'mIoU {res["mIoU"]} != in-loop '
                                     f'{loop_miou} (route launches '
                                     f'{routed})')
        log(f'[quant loop] {QAT_LEAF_NAME} through train_segmentor, batch 2 '
            f'of {TRAIN_HW}, every loss finite (decode loss A {losses["A"]},'
            f' B {losses["B"]}); int8 mIoU in the loop / tools/'
            f'test_torch.py --quant-int8: A (dynamic scales) '
            f'{out["A"]["loop"]} / {out["A"]["cli"]}, B (calibrated by '
            f'tools/calibrate_int8_torch.py) {out["B"]["loop"]} / '
            f'{out["B"]["cli"]}; wall s A {out["A"]["wall"]:.1f}, B '
            f'{out["B"]["wall"]:.1f} on {card}')
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_quant(card, data):
    """Phase 21: quantization on the card (int8 inference, QAT,
    calibration), at full width: (a) every quantized layer's int32 sums
    against float64, (b) int8 serving card against CPU, (c) the QAT step
    card against CPU (both held as another rounding of the same program,
    ``QUANT_ROUNDINGS``), (d) the qat leaf config through its entry points,
    (e) ``tools/int8_microbench_torch.py`` and ``tools/benchmark_torch.py``
    once."""
    t0 = time.time()
    out = {}
    model, cfg, img = _quant_exact(card)
    out['card_vs_cpu'] = _quant_card_vs_cpu(card, model, cfg, img)
    del model
    torch.cuda.empty_cache()
    t1 = time.time()
    qcfg = Config.fromfile(QAT_LEAF)
    for head in _head_cfgs(qcfg.model):
        head['dropout_ratio'] = 0.0
    out['qat_step'] = _supervised_card_vs_cpu(
        qcfg, QUANT_CHECK_HW, '[quant qat card-vs-cpu]',
        ctx=quant.qat_context_from_cfg(qcfg), roundings=QUANT_ROUNDINGS)
    t2 = time.time()
    out['loop'] = _quant_loop(card, data)
    t3 = time.time()
    out['microbench'] = _tool('int8_microbench_torch').main(
        ['--steps', '2', '--reps', '2'])
    bench = _tool('benchmark_torch').main(
        [QAT_LEAF, '--num-images', '20', '--warmup', '3'])
    out['fps'] = bench['fps']
    rows = {r['variant']: r for r in out['microbench']}
    log(f'[quant] fused program batch 24 of 512^2, patches/s: '
        + ', '.join(f'{v} {r["patches_per_sec"]:.2f}' for v, r in
                    rows.items())
        + '; a 1024^2 request, median ms: '
        + ', '.join(f'{v} {r["request_ms"]:.2f}' for v, r in rows.items())
        + f'; int8 max softmax gap {rows["int8"]["max_softmax_gap"]:.4f}, '
        f'argmax agreement {rows["int8"]["argmax_agreement"]:.4f}; '
        f'tools/benchmark_torch.py {bench["fps"]:.2f} fps at 512^2; wall s '
        f'exact + card-vs-cpu {t1 - t0:.1f}, qat step {t2 - t1:.1f}, loop '
        f'{t3 - t2:.1f}, tools {time.time() - t3:.1f}; phase '
        f'{time.time() - t0:.1f} s on {card}')
    return out


def _flash_entries(cases, serve, train, ab_cases, tf, a13, gspmd):
    """The kernels-line entries of the three flash kernels: times of the
    ViT serving shape (forward) and training shape (backward), fp32; the
    launches of phases 9, 11, 19, 20 and 23 (each tensor-parallel rank's,
    each GPipe stage's); and the cases with the bias
    (``ab_cases``, phase 3c), with their times, bounds and SDPA's with
    the same bias as a float mask."""
    fwd = next(c for c in cases if c['shape'] == [1, 12, 1025, 64]
               and c['dtype'] == 'float32')
    bwd = next(c for c in cases if c['shape'] == [2, 12, 1025, 64]
               and c['dtype'] == 'float32')
    lib = 'jax/experimental/pallas/ops/tpu/flash_attention.py'
    steps = VIT_TRAIN_STEPS * len(train)
    rows = []
    for i, (name, kernel, line, case) in enumerate((
            ('flash_attention', 'fwd', 589, fwd),
            ('flash_attention_bwd_dkv', 'dkv', 941, bwd),
            ('flash_attention_bwd_dq', 'dq', 1287, bwd))):
        train_launches = sum(t[1][i] for t in train.values())
        errs = [c['fwd_err'] if i == 0 else
                max(c['dk_err'], c['dv_err']) if i == 1 else c['dq_err']
                for c in cases]
        rows.append(dict(
            name=name, route='cuda',
            source='pfst_tpu_torch/ops/csrc/flash_attention.cu',
            replaces=f'{lib}:{line}',
            called_from='tools/attn_microbench.py:30',
            launches=serve['flash'][i] + train_launches
            + tf['launches'][i] + a13['launches'][i]
            + sum(f[i] for f in gspmd['tp_flash'] + gspmd['pipe_flash']),
            launches_tp_per_rank=[f[i] for f in gspmd['tp_flash']],
            launches_pipe=[f[i] for f in gspmd['pipe_flash']],
            launches_vit=serve['flash'][i] + train_launches,
            launches_transformers=tf['launches'][i],
            launches_a13=a13['launches'][i],
            launches_per_a13_request={
                n: r['flash'][i] / N_TF_REQUESTS
                for n, r in a13['serve'].items() if r['flash'][0]},
            launches_per_a13_step={
                n: t[1][i] / TF_TRAIN_STEPS
                for (n, tag), t in a13['train'].items()
                if tag == 'fp32' and t[1][0]},
            launches_per_transformer_request=tf['serve']['beit']['flash'][i]
            / N_TF_REQUESTS,
            launches_per_transformer_step=sum(
                t[1][i] for t in tf['train'].values())
            / (TF_TRAIN_STEPS * len(tf['train'])),
            launches_per_request=serve['flash'][i] / N_VIT_REQUESTS,
            launches_per_train_step=train_launches / steps,
            max_abs_err=max(errs + [c['fwd_err'] if i == 0 else max(
                c['dk_err'], c['dv_err']) if i == 1 else max(
                    c['dq_err'], c.get('dab_err', 0.0)) for c in ab_cases]),
            max_abs_err_fp32=max(e for e, c in zip(errs, cases)
                                 if c['dtype'] == 'float32'),
            ms=case['ms'][kernel], device_ms=case['device_ms'][kernel],
            plain_ms=case['plain_fwd_ms'] if i == 0
            else case['plain_bwd_ms'],
            bound_ms=case['bound_ms'][kernel],
            bound_by=case['bound_by'][kernel],
            library_ms=case['library_fwd_ms'] if i == 0
            else case['library_bwd_ms'],
            library_device_ms=case['library_device_ms'][
                'fwd' if i == 0 else 'bwd'],
            library_bwd_op=case['library_bwd_op'],
            timed_at=case['shape'],
            cases=[{k: c[k] for k in ('shape', 'kv_len', 'dtype', 'layout')}
                   | {'ms': c['ms'][kernel],
                      'device_ms': c['device_ms'][kernel],
                      'bound_ms': c['bound_ms'][kernel],
                      'plain_ms': c['plain_fwd_ms'] if i == 0
                      else c['plain_bwd_ms'],
                      'library_device_ms': c['library_device_ms'][
                          'fwd' if i == 0 else 'bwd']} for c in cases],
            ab_cases=[{k: c[k] for k in ('shape', 'kv_len', 'dtype', 'layout',
                                         'bias', 'ab_shape')}
                      | _ab_case_entry(c, kernel, i) for c in ab_cases]))
    return rows


def _ab_case_entry(c, kernel, i):
    err = (c['fwd_err'] if i == 0 else max(c['dk_err'], c['dv_err'])
           if i == 1 else max(c['dq_err'], c.get('dab_err', 0.0)))
    out = dict(max_abs_err=err,
               repeat_bitwise_equal=c['repeat_bitwise_equal'])
    if 'ms' in c:
        out.update(
            ms=c['ms'][kernel], device_ms=c['device_ms'][kernel],
            bound_ms=c['bound_ms'][kernel], bound_by=c['bound_by'][kernel],
            plain_ms=c['plain_fwd_ms'] if i == 0 else c['plain_bwd_ms'],
            library_ms=c['library_fwd_ms'] if i == 0
            else c['library_bwd_ms'],
            library_device_ms=c['library_device_ms'][
                'fwd' if i == 0 else 'bwd'])
    return out


# ------------------------------- phase 22 ----------------------------------
def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _state_tensors(state):
    """Every parameter and buffer of the state's modules, by name."""
    from pfst_tpu_torch.parallel.mesh import state_modules
    return {f'{i}.{k}': v.detach().clone()
            for i, m in enumerate(state_modules(state))
            for k, v in m.state_dict().items()}


@contextlib.contextmanager
def _sync_probe(module):
    """Wrap the synchronisation calls of ``module``'s step
    (``average_gradients``, ``average_log_vars``, ``average_buffers``) so
    that each records whether it left its inputs bitwise as they were (a
    gradient it filled in must be zeros): at a world size of 1 every one
    must."""
    names = ('average_gradients', 'average_log_vars', 'average_buffers')
    inner = {n: getattr(module, n) for n in names}
    calls = []

    def gradients(params, group):
        params = list(params)
        before = [None if p.grad is None else p.grad.clone() for p in params]
        inner['average_gradients'](params, group)
        calls.append(('average_gradients', all(
            torch.equal(p.grad, b) if b is not None else not p.grad.any()
            for p, b in zip(params, before))))

    def log_vars(values, group):
        out = inner['average_log_vars'](values, group)
        calls.append(('average_log_vars', out.keys() == values.keys() and all(
            torch.equal(out[k], v) for k, v in values.items())))
        return out

    def buffers(mod, group):
        before = [b.clone() for b in mod.buffers()]
        inner['average_buffers'](mod, group)
        calls.append(('average_buffers', all(
            torch.equal(a, b) for a, b in zip(mod.buffers(), before))))

    for n, fn in zip(names, (gradients, log_vars, buffers)):
        setattr(module, n, fn)
    try:
        yield calls
    finally:
        for n, fn in inner.items():
            setattr(module, n, fn)


def _max_diff(a, b):
    """The largest absolute difference over two runs' tensors (0 where
    bitwise equal)."""
    return max(float((a[k].double() - b[k].double()).abs().max())
               if a[k].is_floating_point() else
               float((a[k] != b[k]).any()) for k in a)


def _ddp_run(cfg, group, pfgst_module):
    """DDP_STEPS steps of the leaf config's PFGST step from its seeded
    state, through ``make_sharded_train_step`` over ``group`` or, without
    one, the plain step: the modules and log vars after them, the
    synchronisation calls' probe records, the similarity launches."""
    from pfst_tpu_torch.parallel import make_sharded_train_step
    algo, state, step = _train_setup(cfg)
    if group is not None:
        norm = cfg.img_norm_cfg
        step = make_sharded_train_step(algo, norm['mean'], norm['std'],
                                       group)
    gen = torch.Generator().manual_seed(3)
    logs = {}
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    with _sync_probe(pfgst_module) as calls:
        for i in range(DDP_STEPS):
            state, log_vars = step(state, _train_batch(cfg, 1000 + i,
                                                       TRAIN_HW), gen)
            logs.update({f'{i}.{k}': v.detach().clone()
                         for k, v in log_vars.items()})
    torch.cuda.synchronize()
    out = dict(tensors={**_state_tensors(state), **logs}, calls=calls,
               counts=_sim_counts(), wall=time.time() - t0)
    del algo, state, step
    torch.cuda.empty_cache()
    return out


def _ddp_world_one(cfg, card):
    """(a): DDP_STEPS steps of the leaf config's PFGST step at full width
    through ``make_sharded_train_step`` over an NCCL group of one rank,
    against the plain step twice, from the same state, batches and
    generator, with PyTorch's deterministic algorithms wherever it has
    them (the ops it has none for are printed). Every synchronisation
    call of the sharded step must leave its inputs bitwise as they were,
    and its parameters, buffers and log vars must equal the plain step's
    bitwise whenever the plain step repeats itself bitwise."""
    import warnings
    import torch.distributed as dist
    from pfst_tpu_torch.models.uda import pfgst as pfgst_module
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{_free_port()}', rank=0, world_size=1)
    runs = {}
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter('always')
            for name in ('plain', 'plain again', 'sharded'):
                runs[name] = _ddp_run(cfg, dist.group.WORLD
                                      if name == 'sharded' else None,
                                      pfgst_module)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            old[:2]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])
    nondeterministic = sorted({
        m.group(1) if m else str(w.message)[:72] for w in seen
        if 'determinis' in str(w.message) for m in [re.search(
            r'(\S+) does not have a deterministic implementation',
            str(w.message))]})
    plain, again, sharded = (runs[k] for k in ('plain', 'plain again',
                                                'sharded'))
    repeat = _max_diff(plain['tensors'], again['tensors'])
    gap = _max_diff(plain['tensors'], sharded['tensors'])
    identity = [ok for _, ok in sharded['calls']]
    log(f'[ddp] (a) NCCL, world size 1, {DDP_STEPS} PFGST steps at batch 2 '
        f'of {TRAIN_HW}: {len(identity)} synchronisation calls, '
        f'{sum(identity)} left their inputs bitwise; sharded against plain '
        f'max |diff| {gap:.3e} over {len(plain["tensors"])} tensors and log '
        f'vars, plain against plain {repeat:.3e}; ops without a '
        f'deterministic implementation {nondeterministic}; similarity '
        f'launches {sharded["counts"]}; wall s plain {plain["wall"]:.1f} '
        f'sharded {sharded["wall"]:.1f} on {card}')
    if len(identity) != 3 * DDP_STEPS or not all(identity):
        raise AssertionError(f'[ddp] (a) a synchronisation at world size 1 '
                             f'changed its inputs: {sharded["calls"]}')
    if sharded['counts'] != (2 * DDP_STEPS, DDP_STEPS):
        raise AssertionError(f'[ddp] (a) similarity launches '
                             f'{sharded["counts"]}')
    if repeat == 0 and gap != 0:
        raise AssertionError(f'[ddp] (a) the sharded step at world size 1 '
                             f'is not the plain step: max |diff| {gap}')
    return dict(bitwise=gap == 0, plain_repeats=repeat == 0,
                max_diff=gap, plain_max_diff=repeat,
                nondeterministic=nondeterministic,
                launches=sharded['counts'])


def _to_sync_bn(node):
    """``node`` (a model config) with every ``BN`` norm made ``SyncBN``."""
    if isinstance(node, dict):
        if node.get('type') == 'BN':
            return dict(node, type='SyncBN')
        return {k: _to_sync_bn(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_sync_bn(v) for v in node)
    return node


def _ddp_rank_setup(kind, device, group):
    """A rank's algorithm, state and group step for (b): the leaf config's
    PFGST (dropout off), or the OCRNet-R50-D8 def with its norms made
    ``SyncBN`` under the supervised trainer with SGD; the last BN scale of
    each residual block at RESIDUAL_SCALE."""
    if kind == 'pfgst':
        cfg = Config.fromfile(LEAF)
        cfg.model['decode_head']['dropout_ratio'] = 0.0
        cfg.model['auxiliary_head']['dropout_ratio'] = 0.0
        algo, state, _ = _train_setup(cfg, device)
    else:
        cfg = Config.fromfile(LEAF)
        model = _to_sync_bn(Config.fromfile(DDP_SYNC_BN_DEF).model)
        for head in _head_cfgs(model):
            head['dropout_ratio'] = 0.0
        algo = build_algorithm(dict(model=model), device=device)
        state = algo.init_state(torch.Generator().manual_seed(0),
                                build_optimizer(dict(type='SGD', lr=1e-2)))
    _scale_residual(state, RESIDUAL_SCALE)
    norm = cfg.img_norm_cfg
    return cfg, state, algo.make_train_step(norm['mean'], norm['std'],
                                            group=group)


def _replicas_equal(state, group):
    """Whether every rank of ``group`` holds rank 0's modules bitwise."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel.mesh import state_modules
    flat = torch.cat([t.detach().reshape(-1).double()
                      for m in state_modules(state)
                      for t in list(m.parameters()) + list(m.buffers())])
    ref = flat.clone()
    dist.broadcast(ref, 0, group=group)
    ok = torch.tensor([float(torch.equal(ref, flat))], device=flat.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    return bool(ok.item())


def ddp_rank_main(spec_path):
    """A rank of phase 22 (b), started by ``_ddp_ranks`` with torchrun's
    variables: it joins the gloo group with ``init_distributed``, takes
    ``steps`` steps of each kind on its shard (2 of CHECK_HW a rank, TF32
    off) and checks after each that the ranks hold the same modules;
    rank 0 saves the first step's log vars and averaged gradients."""
    import torch.distributed as dist
    from pfst_tpu_torch.apis.train import step_generator
    from pfst_tpu_torch.parallel import init_distributed
    from pfst_tpu_torch.parallel.sync_bn import SyncBatchNorm
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec['threads'])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = init_distributed('pytorch', 'gloo', spec['device'])
    rank = dist.get_rank()
    out = {}
    for kind in ('pfgst', 'sync_bn'):
        cfg, state, step = _ddp_rank_setup(kind, device, dist.group.WORLD)
        n_sync = sum(isinstance(m, SyncBatchNorm)
                     for m in state.student.modules())
        equal = []
        for i in range(spec['steps']):
            batch = _train_batch(cfg, 700 + 10 * i + rank, CHECK_HW, device)
            if kind == 'sync_bn':
                batch = {k: batch[k] for k in ('img', 'gt_semantic_seg')}
            state, log_vars = step(state, batch, step_generator(5, i, rank))
            if i == 0:
                first = ({k: float(v) for k, v in log_vars.items()},
                         {k: [g.float() for g in v] for k, v in
                          _grad_groups(state).items()})
            equal.append(_replicas_equal(state, dist.group.WORLD))
        out[kind] = dict(log_vars=first[0], grads=first[1], equal=equal,
                         sync_bn_layers=n_sync)
        del state, step
    if rank == 0:
        torch.save(out, spec['out'])
    dist.barrier()
    dist.destroy_process_group()


def _ddp_ranks(root, name, device, threads, steps):
    """Start two ranks of ``ddp_rank_main`` (this file, torchrun's
    variables, ``LOCAL_RANK`` 0 for both so they share ``cuda:0``)."""
    spec = dict(device=device, threads=threads, steps=steps,
                out=osp.join(root, f'{name}.pt'))
    path = osp.join(root, f'{name}.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE='2',
                   LOCAL_RANK='0', MASTER_ADDR='localhost',
                   MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads))
        procs.append(subprocess.Popen(
            [sys.executable, osp.abspath(__file__), '--ddp-rank', path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, spec['out']


def _wait(procs, what, timeout=DDP_TIMEOUT_S):
    """Wait for ``procs``; any that fails, or outlasts ``timeout``, fails
    the phase with its output (all are stopped)."""
    try:
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            if out is None and hasattr(p, 'log_path'):
                with open(p.log_path) as f:
                    out = f.read()
            outs.append(out)
            if p.returncode != 0:
                raise AssertionError(f'[ddp] {what}: a process exited '
                                     f'{p.returncode}:\n{out[-6000:]}')
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _ddp_card_vs_cpu(card):
    """(b): two gloo ranks sharing the card against the same two ranks on
    the CPU (with its threads split between them, and with one thread
    each), from the same weights, shards and draws: the PFGST step and
    the OCRNet ``SyncBN`` step, the first step's averaged log vars and
    gradients within phase 11's bounds; after every step on the card the
    ranks' modules bitwise equal."""
    root = tempfile.mkdtemp(prefix='pfst_ddp_b_')
    threads = max(torch.get_num_threads() // 2, 1)
    try:
        t0 = time.time()
        groups = {side: _ddp_ranks(root, side, device, n, steps)
                  for side, device, n, steps in (
                      ('card', 'cuda', threads, DDP_CARD_STEPS),
                      ('cpu', 'cpu', threads, 1), ('cpu1', 'cpu', 1, 1))}
        for side, (procs, _) in groups.items():
            _wait(procs, f'(b) {side} ranks')
        wall = time.time() - t0
        res = {side: torch.load(path, weights_only=False)
               for side, (_, path) in groups.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {}
    for kind in ('pfgst', 'sync_bn'):
        sides = {side: (r[kind]['log_vars'],
                        {k: [g.double() for g in v]
                         for k, v in r[kind]['grads'].items()})
                 for side, r in res.items()}
        card_res = res['card'][kind]
        tag = (f'[ddp] (b) {kind}, 2 ranks of 2 x {CHECK_HW} (card: gloo, '
               f'both on cuda:0; CPU: {threads} threads a rank, cpu1 one)')
        out[kind] = _check_train_sides(sides, threads, tag)
        log(f'[ddp] (b) {kind}: ranks bitwise equal after each of '
            f'{DDP_CARD_STEPS} card steps {card_res["equal"]}; SyncBN '
            f'layers {card_res["sync_bn_layers"]}')
        if not all(card_res['equal']) or len(card_res['equal']) != \
                DDP_CARD_STEPS:
            raise AssertionError(f'[ddp] (b) {kind}: the card ranks '
                                 f'diverged: {card_res["equal"]}')
        if (kind == 'sync_bn') != (card_res['sync_bn_layers'] > 0):
            raise AssertionError(f'[ddp] (b) {kind}: '
                                 f'{card_res["sync_bn_layers"]} SyncBN '
                                 f'layers')
    log(f'[ddp] (b) wall {wall:.1f} s for the three pairs of ranks on '
        f'{card}')
    return out


DDP_DRIVER = '''
"""Run a tool of the port under torchrun and record, for phase 22 (c),
the similarity kernels' launches and the loop's evaluations."""
import os, sys
root, tool, out = sys.argv[1:4]
sys.path[:0] = [root, os.path.join(root, 'tools')]
import importlib
import torch
import torch.distributed as dist
from pfst_tpu_torch.apis import train as train_api
from pfst_tpu_torch.ops import (cuda_neighborhood_similarity as fwd,
                                cuda_neighborhood_similarity_backward as bwd)
evals = []
inner = train_api.multi_gpu_test


def recording(*args, **kwargs):
    results = inner(*args, **kwargs)
    evals.append(results)
    return results


train_api.multi_gpu_test = recording
fwd.launches = bwd.launches = 0
result = importlib.import_module(tool).main(sys.argv[4:])
# test_torch's metrics on rank 0 (train_torch's is the train state, whose
# student's SHA-256 each rank keeps)
keep = tool == 'test_torch' and dist.get_rank() == 0
digest = None
if tool == 'train_torch':
    import hashlib
    h = hashlib.sha256()
    sd = result.student.state_dict()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    digest = h.hexdigest()
torch.save(dict(launches=(fwd.launches, bwd.launches), evals=evals,
                result=result if keep else None, digest=digest),
           f'{out}.rank{dist.get_rank()}')
dist.destroy_process_group()
'''


def _torchrun(root, tool, args, tag):
    """``tool`` (train_torch or test_torch) with ``--launcher pytorch``
    under torchrun, 2 processes on this card; each rank's record."""
    return _torchrun_wait(*_torchrun_start(root, tool, args), tag)


def _torchrun_start(root, tool, args):
    """``_torchrun``'s process, started in ``root``; (process, the
    records' path)."""
    driver = osp.join(root, 'ddp_driver.py')
    with open(driver, 'w') as f:
        f.write(DDP_DRIVER)
    out = osp.join(root, f'{tool}.record')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         '2', '--master_port', str(_free_port()), driver, ROOT, tool, out,
         *args, '--launcher', 'pytorch', '--cfg-options',
         'dist_params.backend=gloo'], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, out


def _torchrun_wait(proc, out, tag):
    """Each rank's record of a ``_torchrun_start`` process, and its
    output."""
    text = _wait([proc], tag)[0]
    return [torch.load(f'{out}.rank{r}', weights_only=False)
            for r in range(2)], text


def _ddp_cli(card, data, loop_s_iter):
    """(c): ``tools/train_torch.py --launcher pytorch`` under torchrun with
    two gloo ranks on phase 13's packs (the leaf config at full width,
    DDP_ITERS iterations, one evaluation through ``multi_gpu_test`` at the
    end), then ``tools/test_torch.py --launcher pytorch`` on its
    checkpoint."""
    from pfst_tpu_torch.apis.train import _build_val
    from pfst_tpu_torch.apis import single_gpu_test
    root = tempfile.mkdtemp(prefix='pfst_ddp_c_')
    try:
        pots, vaih, _ = data
        cfg = _loop_config(pots, vaih)
        cfg.merge_from_dict({'checkpoint_config.interval': DDP_ITERS,
                             'evaluation.interval': DDP_ITERS})
        cfg_path = osp.join(root, 'ddp_config.py')
        cfg.dump(cfg_path)
        work = osp.join(root, 'work')
        t0 = time.time()
        train, text = _torchrun(root, 'train_torch', [
            cfg_path, '--work-dir', work, '--seed', '0', '--max-iters',
            str(DDP_ITERS)], '(c) train_torch under torchrun')
        t_train = time.time() - t0
        ckpt = osp.join(work, f'iter_{DDP_ITERS}.pth')
        files = sorted(os.listdir(work))
        with open(osp.join(work, 'train.log')) as f:
            train_log = f.read()
        iters = {int(m.group(1)): m for m in re.finditer(
            r'Iter \[(\d+)/\d+\] time: ([\d.]+)s data: [\d.]+s  (.*)',
            train_log)}
        values = [float(v) for m in iters.values()
                  for v in re.findall(r': ([^,]+)', m.group(3))]
        s_iter = statistics.median(float(iters[i].group(2))
                                   for i in range(3, DDP_ITERS + 1))
        expected = {'train.log', 'ddp_config.py', f'iter_{DDP_ITERS}.pth'}
        stamped = [f for f in files if f not in expected]
        if sorted(iters) != list(range(1, DDP_ITERS + 1)) or \
                not np.isfinite(values).all():
            raise AssertionError(f'[ddp] (c) the log lines: {sorted(iters)}, '
                                 f'finite {np.isfinite(values).all()}')
        if not expected <= set(files) or len(stamped) != 1 or \
                not stamped[0].endswith('.log') or \
                train_log.count('entering train loop') != 1:
            raise AssertionError(f'[ddp] (c) the work dir is not rank 0\'s '
                                 f'alone: {files}')
        for r, rec in enumerate(train):
            if rec['launches'] != (2 * DDP_ITERS, DDP_ITERS) or \
                    len(rec['evals']) != 1:
                raise AssertionError(f'[ddp] (c) rank {r}: similarity '
                                     f'launches {rec["launches"]}, '
                                     f'{len(rec["evals"])} evaluations')
        t0 = time.time()
        test, _ = _torchrun(root, 'test_torch', [
            cfg_path, ckpt, '--eval', 'mIoU'], '(c) test_torch under torchrun')
        t_test = time.time() - t0
        val = _build_val(cfg)
        model = init_segmentor(cfg, ckpt)
        single = single_gpu_test(model, val['loader'], pre_eval=True,
                                 progress=False)
        del model
        torch.cuda.empty_cache()
        loop = train[0]['evals'][0]
        same = len(loop) == len(single) and all(
            all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(a, b)) for a, b in zip(loop, single))
        miou = val['dataset'].evaluate(single, metric='mIoU')['mIoU']
        cli_miou = test[0]['result']['mIoU']
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f'[ddp] (c) train_torch --launcher pytorch, 2 gloo ranks sharing '
        f'one GPU, {DDP_ITERS} iterations of batch 2 a rank at full width: '
        f'{t_train:.1f} s; every logged loss finite; similarity launches a '
        f'rank {[r["launches"] for r in train]}; the work dir {files}; '
        f'in-loop multi_gpu_test histograms equal single_gpu_test\'s on '
        f'the checkpoint {same} ({len(single)} images); mIoU '
        f'single_gpu_test {miou} / test_torch --launcher pytorch '
        f'{cli_miou} ({t_test:.1f} s)')
    log(f'[ddp] (c) s/iter median past iteration 2 for two processes '
        f'sharing one GPU (not a multi-GPU speed) {s_iter:.4f}, beside '
        f'phase 13\'s single-process loop {loop_s_iter:.4f} on {card}')
    if not same or cli_miou != miou:
        raise AssertionError(f'[ddp] (c) multi_gpu_test / test_torch '
                             f'disagree with single_gpu_test: histograms '
                             f'{same}, mIoU {cli_miou} != {miou}')
    return dict(s_iter=s_iter, launches=[r['launches'] for r in train],
                miou=miou)


def phase_ddp(card, data, loop_s_iter):
    """Phase 22: data parallelism on the card, (a), (b) and (c)."""
    a = _ddp_world_one(Config.fromfile(LEAF), card)
    b = _ddp_card_vs_cpu(card)
    c = _ddp_cli(card, data, loop_s_iter)
    return dict(a=a, b=b, c=c)


# ------------------------------- phase 23 ----------------------------------
# (a) tensor parallelism: fp32 steps, then one bf16 step, of the ViT-B
# UPerNet at VIT_HW, batch 2; (b) ZeRO: the leaf config's PFGST step at
# TRAIN_HW, one image a data rank; (c) spatial inference of a REQUEST_HW
# request; (d) GPipe of ViT-B's 12 blocks as 2 stages of 6 at PIPE_SHAPE
# in PIPE_MB microbatches, and the MoE of 2 ViT-B MLP experts on MOE_TOKENS
# tokens a rank
GSPMD_TP_STEPS = 3
# a batch of 4: the 4 microbatches must divide it
PIPE_SHAPE, PIPE_MB, PIPE_BLOCKS = (4, 1025, 768), 4, 12
MOE_TOKENS = 1025
GSPMD_TIMEOUT_S = 600
# (c): the logits' bound, against the largest |logit|, and the top-2
# margin below which a pixel's label is not compared
SPATIAL_LOGIT_TOL, SPATIAL_MARGIN = 1e-4, 1e-4
# (e) spatially sharded training: the leaf config's PFGST step on crops
# twice the leaf's height, batch 2 (the leaf's samples_per_gpu), each of
# the two ranks a block of 512 rows; SP_TRAIN_STEPS fp32 steps; the
# torchrun run's iterations
SP_TRAIN_HW, SP_TRAIN_STEPS, SP_CLI_ITERS = (1024, 512), 2, 2
# (e): acc_seg's budget, in points: an argmax over near-tied logits may
# flip a few of its 2 x 1024 x 512 pixels (the JAX test's 0.5)
SP_ACC_POINTS = 0.5


def _whole_grads(state):
    """The student's whole gradients by ``_grad_groups``' groups (fp64 on
    the CPU): a ZeRO shard's gathered over the data ranks, a
    tensor-parallel shard's over the model ranks; collective."""
    from pfst_tpu_torch.parallel import comm
    from pfst_tpu_torch.parallel import tp as tp_mod
    sh = state.sharding
    groups = {}
    for name, p in state.student.named_parameters():
        if not p.requires_grad:
            continue
        q = getattr(p, 'zero_shard', None)
        g = p.grad if q is None else q.grad
        if q is not None and sh.layout.n_data > 1:
            g = comm.all_gather(g, sh.layout.data, p.zero_dim)
        if getattr(p, 'tp_dim', None) is not None:
            g = tp_mod._whole(g, p.tp_kind, p.tp_dim, sh.layout.model)
        parts = name.split('.')
        key = '.'.join(parts[:2]) if parts[0] == 'backbone' else parts[0]
        groups.setdefault(key, []).append(g.double().cpu())
    return groups


def _grad_reading(got, want):
    """(cosine, norm gap) of two gradient groups' concatenations."""
    a = torch.cat([g.flatten() for gs in got.values() for g in gs])
    b = torch.cat([g.flatten() for gs in want.values() for g in gs])
    return _cos_and_gap(a, b)


def _lv_gap(got, want):
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in want)


def _model_ranks_agree(state, layout):
    """Whether the model ranks of a data index hold the student's
    replicated leaves bitwise alike."""
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1).double()
                      for p in state.student.parameters()
                      if getattr(p, 'tp_dim', None) is None])
    ref = flat.clone()
    dist.broadcast(ref, dist.get_global_rank(layout.model, 0),
                   group=layout.model)
    ok = torch.tensor([float(torch.equal(ref, flat))], device=flat.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _gspmd_tp(rank):
    """(a) on this rank: rank 0 first takes the single-process steps (the
    reference), then both take the tp 2 steps from the same weights,
    batch and generators."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel import tp as tp_mod
    from pfst_tpu_torch.parallel import zero
    cfg = _vit_train_cfg(VIT_HW[0], dropout=False)
    batch = _vit_batch(cfg, 23, VIT_HW)
    out = {}

    def run(state, step):
        logs, grads = [], None
        for i in range(GSPMD_TP_STEPS + 1):
            if i == GSPMD_TP_STEPS:
                state.student.dtype = torch.bfloat16
            state, lv = step(state, batch, torch.Generator().manual_seed(
                40 + i))
            logs.append({k: float(v) for k, v in lv.items()})
            if i == 0:
                grads = _grad_groups(state) if layout is None else \
                    _whole_grads(state)
            if layout is not None:
                agree.append(_model_ranks_agree(state, layout))
        return logs, grads

    agree = []
    if rank == 0:
        layout = None
        _, state, step = _vit_train_setup(cfg)
        out['ref'] = run(state, step)
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    layout = tp_mod.get_2d_groups(2)
    algo, state, _ = _vit_train_setup(cfg)
    state = tp_mod.shard_state(state, layout)
    norm = cfg.img_norm_cfg
    step = tp_mod.make_tp_train_step(algo, norm['mean'], norm['std'],
                                     state.sharding)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    out['tp'] = run(state, step)
    torch.cuda.synchronize()
    out.update(wall=time.time() - t0, flash=_flash_counts(), agree=agree,
               heads=sorted({m.tp_heads for m in state.student.modules()
                             if hasattr(m, 'tp_heads')}))
    del state, step, algo
    torch.cuda.empty_cache()
    return out


def _gspmd_zero(rank):
    """(b) on this rank: rank 0 the single-process PFGST step at batch 2,
    then both ranks ZeRO-1 and ZeRO-3 steps on one image each, from the
    same weights, batch and generator; the memory audit and each run's
    peak allocation."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel import zero
    cfg = Config.fromfile(LEAF)
    for head in _head_cfgs(cfg.model):
        head['dropout_ratio'] = 0.0
    batch = _train_batch(cfg, 1900, TRAIN_HW)
    out = {}
    if rank == 0:
        _, state, step = _train_setup(cfg)
        _scale_residual(state, RESIDUAL_SCALE)
        state, lv = step(state, batch, torch.Generator().manual_seed(3))
        out['ref'] = ({k: float(v) for k, v in lv.items()},
                      _grad_groups(state))
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    mine = {k: v[rank:rank + 1] for k, v in batch.items()}
    for level in (1, 3):
        torch.cuda.reset_peak_memory_stats()
        algo, state, _ = _train_setup(cfg)
        _scale_residual(state, RESIDUAL_SCALE)
        state = zero.shard_state(state, zero.get_data_layout(), level)
        norm = cfg.img_norm_cfg
        step = zero.make_zero_train_step(algo, norm['mean'], norm['std'],
                                         state.sharding)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        state, lv = step(state, mine, torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _sim_counts()
        audit = dict(opt=zero.opt_state_bytes(state.optimizer),
                     params=zero.tree_bytes(state.student),
                     teacher=zero.tree_bytes(state.teacher))
        out[level] = dict(log_vars={k: float(v) for k, v in lv.items()},
                          grads=_whole_grads(state), counts=counts,
                          audit=audit, wall=wall,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, step, algo
        torch.cuda.empty_cache()
    return out


def _gspmd_spatial(rank):
    """(c) on this rank: the leaf model's whole-image logits (rank 0, the
    reference), then the request sharded over the two ranks."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel.spatial import spatial_inference
    cfg = Config.fromfile(LEAF)
    model = init_segmentor(cfg)
    img = _request(cfg, 2300, REQUEST_HW).cuda()
    out = {}
    with torch.inference_mode():
        if rank == 0:
            out['whole'] = model.inference_logits(img)[0].float().cpu()
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        logits = spatial_inference(model, img, softmax=False)
        torch.cuda.synchronize()
    out.update(logits=logits.cpu(), wall=time.time() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model
    torch.cuda.empty_cache()
    return out


def _delta_groups(before, after):
    """The change of every floating-point tensor from ``before`` to
    ``after`` (``_state_tensors``), fp64 on the CPU, by group: the
    student's parameters, its running statistics, the teacher's (EMA)
    parameters."""
    groups = {}
    for k, v in after.items():
        if not v.is_floating_point():
            continue
        module = 'student' if k.startswith('0.') else 'teacher'
        kind = 'stats' if 'running_' in k else 'params'
        if module == 'teacher' and kind == 'stats':
            continue
        groups.setdefault(f'{module} {kind}', []).append(
            (v.double() - before[k].double()).cpu())
    return groups


def _ranks_bitwise_equal(state):
    """Whether every rank holds the state's modules bitwise alike: each
    module's ``_digest``, all-gathered."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel.mesh import state_modules
    mine = [_digest(m.state_dict()) for m in state_modules(state)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return all(d == every[0] for d in every)


def _load_state_tensors(state, tensors):
    """The state's modules loaded from ``_state_tensors``' dict."""
    from pfst_tpu_torch.parallel.mesh import state_modules
    for i, m in enumerate(state_modules(state)):
        m.load_state_dict({k[len(f'{i}.'):]: v for k, v in tensors.items()
                           if k.startswith(f'{i}.')})


def _peak_sites(snapshot, top=8):
    """The blocks alive at the largest allocated total of a
    ``torch.cuda.memory._snapshot`` trace, summed by the first frame of
    the port that allocated them: [(GiB, site)], largest first."""
    trace = snapshot['device_traces'][torch.cuda.current_device()]
    live, cur, peak, at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e['action'] == 'alloc':
            live[e['addr']] = e
            cur += e['size']
            if cur > peak:
                peak, at = cur, i
        elif e['action'] == 'free_completed' and e['addr'] in live:
            cur -= live.pop(e['addr'])['size']
    live = {}
    for e in trace[:at + 1]:
        if e['action'] == 'alloc':
            live[e['addr']] = e
        elif e['action'] == 'free_completed':
            live.pop(e['addr'], None)
    sites = collections.Counter()
    for e in live.values():
        frames = e.get('frames') or []
        ours = [f for f in frames if 'pfst_tpu_torch' in f['filename']]
        f = (ours or frames or [None])[0]
        sites['?' if f is None else f'{osp.relpath(f["filename"], ROOT)}:'
              f'{f["line"]} {f["name"]}'] += e['size']
    return [(round(n / 2**30, 3), site) for site, n in sites.most_common(top)]


def _gspmd_spatial_train(rank):
    """(e) on this rank: rank 0 first takes SP_TRAIN_STEPS single-process
    PFGST steps on the global batch of SP_TRAIN_HW (the reference), with
    each step's starting state, gradients and changes, and its peak
    allocation; then both ranks take the spatial steps at sp 2
    (``parallel.spatial.make_spatial_train_step``) on their blocks, with
    the same batch and generators, each step from the single-process
    step's starting state (rank 0's, broadcast); their peaks, their
    similarity launches by shape and whether they end bitwise alike. A
    step from the same state is compared: this step's fp32 rounding grows
    ten-fold over a step (the CPU tests' reading). SGD at a constant
    rate, as the JAX test of the mode steps: an adaptive optimizer's
    first steps take the sign of each gradient, which makes a parameter
    of a near-zero gradient move by its full step on rounding alone."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel import broadcast_state, spatial
    cfg = Config.fromfile(LEAF)
    cfg.optimizer = dict(type='SGD', lr=0.01)
    # a constant rate: the leaf's warm-up starts at 1e-6 of it, where a
    # step moves the parameters by less than their fp32 spacing
    cfg.lr_config = None
    batch = _train_batch(cfg, 2400, SP_TRAIN_HW)
    norm = cfg.img_norm_cfg
    out = {}

    def run(state, step, data, starts=None):
        """Each step's (log vars, gradient groups, changes), the starting
        states, and each step's memory: (its peak allocation, its peak
        above what was allocated just before it, the allocation sites
        alive at the last step's peak on rank 0); with ``starts`` each
        step begins from rank 0's ``starts[i]``."""
        steps, begun, memory = [], [], []
        for i in range(SP_TRAIN_STEPS):
            if starts is not None:
                if rank == 0:
                    _load_state_tensors(state, starts[i])
                broadcast_state(state, dist.group.WORLD)
            before = _state_tensors(state)
            begun.append({k: v.cpu() for k, v in before.items()})
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sites = rank == 0 and i == SP_TRAIN_STEPS - 1
            if sites:
                torch.cuda.memory._record_memory_history(max_entries=400000)
            state, lv = step(state, data, torch.Generator().manual_seed(
                60 + i))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            if sites:
                snapshot = torch.cuda.memory._snapshot()
                torch.cuda.memory._record_memory_history(enabled=None)
            memory.append((peak / 2**30, (peak - base) / 2**30,
                           _peak_sites(snapshot) if sites else None))
            steps.append(({k: float(v) for k, v in lv.items()},
                          _grad_groups(state),
                          _delta_groups(before, _state_tensors(state))))
        return steps, begun, memory

    ref, starts = None, None
    if rank == 0:
        _, state, step = _train_setup(cfg)
        _scale_residual(state, RESIDUAL_SCALE)
        t0 = time.time()
        ref, starts, memory = run(state, step, batch)
        out.update(ref_logs=[r[0] for r in ref], ref_wall=time.time() - t0,
                   ref_memory=memory)
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    layout = spatial.get_spatial_layout(2)
    algo, state, _ = _train_setup(cfg)
    _scale_residual(state, RESIDUAL_SCALE)
    step = spatial.make_spatial_train_step(algo, norm['mean'], norm['std'],
                                           layout)
    blocks = spatial.shard_spatial_batch(batch, layout)
    del batch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    with _sim_shapes() as shapes:
        got, _, memory = run(state, step, blocks,
                               starts or [None] * SP_TRAIN_STEPS)
    if ref is not None:
        # each step's gradients and changes against the single-process
        # step's from the same state, by group; a group neither step
        # changed (the teacher at step 1: the EMA copies the student it
        # already equals) is named instead
        out['readings'], out['unchanged'] = [], []
        for i, (g, r) in enumerate(zip(got, ref)):
            step_readings = {'gradients': _grad_reading(g[1], r[1])}
            for k, want in r[2].items():
                a = torch.cat([d.flatten() for d in g[2][k]])
                b = torch.cat([d.flatten() for d in want])
                if not a.any() and not b.any():
                    out['unchanged'].append(f'step {i + 1} {k}')
                else:
                    step_readings[k] = _cos_and_gap(a, b)
            out['readings'].append(step_readings)
    out.update(logs=[g[0] for g in got], wall=time.time() - t0,
               memory=memory, counts=_sim_counts(),
               shapes={k: {f'{shape} {dtype}': n
                           for (shape, dtype), n in v.items()}
                       for k, v in shapes.items()},
               block=tuple(blocks['img'].shape),
               agree=_ranks_bitwise_equal(state))
    del got, ref, starts, state, step, algo, blocks
    torch.cuda.empty_cache()
    return out


def _vit_blocks(n, seed):
    from pfst_tpu_torch.models.backbones.vit import ViTBlock
    g = torch.Generator().manual_seed(seed)
    blocks = [ViTBlock(PIPE_SHAPE[2], 12, 4) for _ in range(n)]
    with torch.no_grad():
        for b in blocks:
            for name, p in b.named_parameters():
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g)
                        if name.startswith('ln') and name.endswith('weight')
                        else 0.02 * torch.randn(p.shape, generator=g))
    return [b.cuda() for b in blocks]


def _gspmd_pipe_moe(rank):
    """(d) on this rank: GPipe of 12 ViT-B blocks as 2 stages of 6, and the
    MoE of 2 ViT-B MLP experts at ample capacity and at capacity factor
    0.5; rank 0 then runs the references (the blocks in sequence, the
    dense per-token computation)."""
    import torch.distributed as dist
    from pfst_tpu_torch.models.backbones.vit import FFN
    from pfst_tpu_torch.parallel.ep import moe_apply
    from pfst_tpu_torch.parallel.pp import gpipe_apply, stack_stage_params
    group = dist.group.WORLD
    blocks = _vit_blocks(PIPE_BLOCKS, 51)
    per = PIPE_BLOCKS // 2
    stage = torch.nn.Sequential(*blocks[:per])
    names = [n for n, _ in stage.named_parameters()]
    stages = [dict(zip(names, [p for b in blocks[s * per:(s + 1) * per]
                               for p in b.parameters()])) for s in range(2)]
    stacked = {k: v.detach().clone().requires_grad_()
               for k, v in stack_stage_params(stages).items()}
    g = torch.Generator().manual_seed(52)
    x = torch.randn(PIPE_SHAPE, generator=g).cuda()
    w = torch.randn(PIPE_SHAPE, generator=g).cuda()

    def block_fn(params, act):
        return torch.func.functional_call(stage, params, (act,))

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    xs = x.clone().requires_grad_()
    out = gpipe_apply(block_fn, stacked, xs, group, PIPE_MB)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    res = dict(pipe_wall=time.time() - t0, pipe_flash=_flash_counts())
    mine = {k: v.grad[rank].cpu() for k, v in stacked.items()}
    if rank == 0:
        seq = x.clone().requires_grad_()
        y = seq
        for b in blocks:
            y = b(y)
        (y * w).sum().backward()
        want = [{k: p.grad.cpu() for k, p in zip(
            names, [p for b in blocks[s * per:(s + 1) * per]
                    for p in b.parameters()])} for s in range(2)]
        res['pipe'] = dict(out=_rel(out, y), dx=_rel(xs.grad, seq.grad))
        res['pipe_grads'] = [max(_rel(mine_k, want[0][k])
                                 for k, mine_k in mine.items())]
        res['pipe_other'] = want[1]
    else:
        res['pipe_mine'] = mine
    # the MoE: ViT-B's MLP as the experts
    ffns = [FFN(768, 3072).cuda() for _ in range(2)]
    with torch.no_grad():
        for f in ffns:
            for p in f.parameters():
                p.copy_(0.02 * torch.randn(p.shape, generator=g).cuda())
    fnames = [n for n, _ in ffns[0].named_parameters()]
    experts = stack_stage_params([dict(f.named_parameters()) for f in ffns])
    experts = {k: v.detach() for k, v in experts.items()}
    gate = torch.randn(768, 2, generator=g).cuda()
    tokens = torch.randn(2 * MOE_TOKENS, 768, generator=g).cuda()
    mine_x = tokens[rank * MOE_TOKENS:(rank + 1) * MOE_TOKENS]

    def expert(params, t):
        return torch.func.functional_call(ffns[0], params, (t,))

    with torch.no_grad():
        ample = moe_apply(expert, experts, mine_x, gate, group, 4.0)
        tight = moe_apply(expert, experts, mine_x, gate, group, 0.5)
        probs = torch.softmax(mine_x @ gate, dim=-1)
        idx = probs.argmax(dim=-1)
        dense = torch.stack([f(mine_x) for f in ffns])
        want = dense[idx, torch.arange(len(idx))] * probs.gather(
            1, idx[:, None])
        kept = torch.zeros(len(idx), dtype=torch.bool, device=idx.device)
        cap = int(0.5 * MOE_TOKENS / 2)
        for e in range(2):
            kept[(idx == e).nonzero()[:cap, 0]] = True
    res['moe'] = dict(ample=_rel(ample, want),
                      tight_kept=_rel(tight[kept], want[kept]),
                      tight_dropped=float(tight[~kept].abs().max())
                      if (~kept).any() else 0.0,
                      dropped=int((~kept).sum()), fnames=fnames)
    del blocks, stage, stacked, ffns
    torch.cuda.empty_cache()
    return res


def _rel(a, b):
    """max |a - b| over max |b|."""
    return float((a.detach().float() - b.detach().float()).abs().max()
                 / b.detach().float().abs().max())


def gspmd_rank_main(spec_path):
    """A rank of phase 23, started by ``_gspmd_ranks`` with torchrun's
    variables (both ranks on ``cuda:0``, gloo): (a)-(d) in turn, TF32 off;
    rank 0 saves the readings."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel import comm, init_distributed
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the model ranks compute the replicated leaves alike only with the
    # deterministic kernels (phase 22 (a): the plain step repeats itself
    # bitwise only with them)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    init_distributed('pytorch', 'gloo', 'cuda')
    rank = dist.get_rank()
    phase_build()
    out = dict(staged=comm.staged_operations(dist.group.WORLD, 'cuda'))
    for name, fn in (('tp', _gspmd_tp), ('zero', _gspmd_zero),
                     ('spatial', _gspmd_spatial),
                     ('pipe_moe', _gspmd_pipe_moe),
                     ('spatial_train', _gspmd_spatial_train)):
        t0 = time.time()
        out[name] = fn(rank)
        out[name]['part_s'] = time.time() - t0
        dist.barrier()
    if rank == 1:
        torch.save({'pipe_mine': out['pipe_moe'].pop('pipe_mine'),
                    'tp_flash': out['tp']['flash'],
                    'zero_counts': {lv: out['zero'][lv]['counts']
                                    for lv in (1, 3)},
                    'audit': {lv: out['zero'][lv]['audit']
                              for lv in (1, 3)},
                    'peak': {lv: out['zero'][lv]['peak_gib']
                             for lv in (1, 3)},
                    'pipe_flash': out['pipe_moe']['pipe_flash'],
                    'logits': out['spatial']['logits'],
                    'sp_train': {k: out['spatial_train'][k] for k in (
                        'logs', 'counts', 'memory', 'block', 'agree')}},
                   spec['out'] + '.rank1')
    dist.barrier()
    if rank == 0:
        torch.save(out, spec['out'])
    dist.destroy_process_group()


def _gspmd_ranks(root):
    """Two ranks of ``gspmd_rank_main`` sharing the card, started: (their
    processes, the results' path). Their output goes to a file (nothing
    reads a pipe while phase 22 runs beside them)."""
    spec = dict(out=osp.join(root, 'gspmd.pt'))
    path = osp.join(root, 'gspmd.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE='2',
                   LOCAL_RANK='0', MASTER_ADDR='localhost',
                   MASTER_PORT=str(port),
                   CUBLAS_WORKSPACE_CONFIG=':4096:8')
        with open(osp.join(root, f'rank{rank}.log'), 'w') as out:
            proc = subprocess.Popen(
                [sys.executable, osp.abspath(__file__), '--gspmd-rank',
                 path], cwd=ROOT, env=env, stdout=out,
                stderr=subprocess.STDOUT, text=True)
        proc.log_path = out.name
        procs.append(proc)
    return procs, spec['out']


def _check_tp(res, card):
    ref_logs, ref_grads = res['tp_ref']
    logs, grads = res['tp']
    gaps = [_lv_gap(got, want) for got, want in zip(logs[:GSPMD_TP_STEPS],
                                                     ref_logs)]
    cos, gap = _grad_reading(grads, ref_grads)
    bf16_gap = _lv_gap(logs[-1], ref_logs[-1])
    flash = [res['tp_flash'], res['tp_flash1']]
    log(f'[gspmd] (a) tp 2, upernet_vit-b16_ln_mln at {VIT_HW}, batch 2, '
        f'two gloo ranks sharing the card (heads a rank {res["tp_heads"]}): '
        f'{GSPMD_TP_STEPS} fp32 steps against the single-process steps, '
        f'log vars largest relative gap a step {[f"{g:.2e}" for g in gaps]}; '
        f'step 1 gradients cosine {cos:.8f}, norm gap {gap:.3e}; the bf16 '
        f'step\'s log vars largest relative gap {bf16_gap:.2e}; replicated '
        f'leaves bitwise equal on the model ranks after each step '
        f'{res["tp_agree"]}; flash launches fwd/dkv/dq a rank {flash}; '
        f'{res["tp_wall"]:.2f} s for the 4 steps on {card}')
    if max(gaps) > 1e-3 or cos < 0.9999 or gap > 1e-3 or \
            not all(res['tp_agree']) or not all(
                np.isfinite(list(lv.values())).all() for lv in logs):
        raise AssertionError('[gspmd] (a) tensor parallelism is not the '
                             'single-process step')
    want = 12 * (GSPMD_TP_STEPS + 1)
    if any(tuple(f) != (want, want, want) for f in flash):
        raise AssertionError(f'[gspmd] (a) flash launches {flash}, '
                             f'{want} of each expected a rank')
    return flash


def _check_zero(res, card):
    ref_lv, ref_grads = res['zero_ref']
    readings = {}
    for level in (1, 3):
        r = res['zero'][level]
        cos, gap = _grad_reading(r['grads'], ref_grads)
        lv_gap = _lv_gap(r['log_vars'], ref_lv)
        audit = [r['audit'], res['audit1'][level]]
        readings[level] = dict(lv_gap=lv_gap, cos=cos, gap=gap,
                               counts=[r['counts'],
                                       res['zero_counts1'][level]],
                               opt_bytes=[a['opt'] for a in audit],
                               params_bytes=[a['params'] for a in audit],
                               teacher_bytes=[a['teacher'] for a in audit],
                               peak_gib=[round(r['peak_gib'], 2),
                                         round(res['peak1'][level], 2)],
                               wall=r['wall'])
        log(f'[gspmd] (b) ZeRO-{level}, the leaf config\'s PFGST step at '
            f'{TRAIN_HW}, one image a data rank, against the single-process '
            f'step at batch 2: log vars largest relative gap {lv_gap:.2e}; '
            f'gradients cosine {cos:.8f}, norm gap {gap:.3e}; AdamW moments '
            f'bytes stored / whole a rank {readings[level]["opt_bytes"]}; '
            f'student {readings[level]["params_bytes"]}; teacher '
            f'{readings[level]["teacher_bytes"]}; peak GiB allocated a rank '
            f'{readings[level]["peak_gib"]}; similarity launches fwd/bwd a '
            f'rank {readings[level]["counts"]}; step {r["wall"]:.2f} s on '
            f'{card}')
        if lv_gap > 1e-3 or cos < 0.9999 or gap > 1e-3:
            raise AssertionError(f'[gspmd] (b) ZeRO-{level} is not the '
                                 f'single-process step')
        if any(tuple(c) != (2, 1) for c in readings[level]['counts']):
            raise AssertionError(f'[gspmd] (b) similarity launches '
                                 f'{readings[level]["counts"]}')
        opt = readings[level]['opt_bytes']
        if not all(s < 0.6 * w for s, w in opt) or (level == 3 and not all(
                s < 0.6 * w for s, w in readings[level]['params_bytes'])):
            raise AssertionError(f'[gspmd] (b) ZeRO-{level} did not shard: '
                                 f'{readings[level]}')
    return readings


def _check_spatial(res, card):
    whole = res['spatial_whole']
    scale = float(whole.abs().max())
    out = {}
    for r, logits in enumerate((res['spatial_logits'],
                                res['spatial_logits1'])):
        err = float((logits - whole).abs().max())
        top2 = whole.topk(2, dim=1).values
        margin = (top2[:, 0] - top2[:, 1]) > SPATIAL_MARGIN * scale
        agree = bool((logits.argmax(1) == whole.argmax(1))[margin].all())
        out[r] = dict(err=err, undecided=int((~margin).sum()), agree=agree)
    log(f'[gspmd] (c) spatial inference of a {REQUEST_HW} request of the '
        f'leaf config over two gloo ranks (stripes of 512 rows): logits '
        f'largest |diff| a rank {[o["err"] for o in out.values()]} against '
        f'the whole-image forward (largest |logit| {scale:.4f}); labels '
        f'equal where the top-2 margin exceeds {SPATIAL_MARGIN} of it '
        f'{[o["agree"] for o in out.values()]}, pixels below that margin '
        f'{out[0]["undecided"]}; {res["spatial_wall"]:.2f} s, peak GiB '
        f'{res["spatial_peak"]:.2f} a rank on {card}')
    if any(o['err'] > SPATIAL_LOGIT_TOL * scale or not o['agree']
           for o in out.values()):
        raise AssertionError(f'[gspmd] (c) spatial inference: {out}')
    return out


def _check_spatial_train(res, card):
    """(e): each spatial step within phase 11's bounds of the
    single-process step from the same state: its log vars within rtol
    1e-3 (atol 1e-5), acc_seg within SP_ACC_POINTS; its gradients, and the
    changes it made to the student's parameters, its running statistics
    and the teacher's (EMA) parameters, each with cosine >= 0.9999 and
    norms within 1e-3 of the single-process step's; both ranks
    bitwise alike; each rank's peak allocation below the single-process
    step's; 2 forward and 1 backward similarity launches a step a rank."""
    sp = res['sp']
    ranks = [sp, res['sp1']]
    gaps, bad = [], {}
    for got, want in zip(sp['logs'], sp['ref_logs'], strict=True):
        gaps.append(_lv_gap(got, want))
        for k, v in want.items():
            limit = SP_ACC_POINTS if 'acc' in k else 1e-5 + 1e-3 * abs(v)
            if abs(got[k] - v) > limit:
                bad[k] = (got[k], v)
    readings = {f'step {i + 1} {k}': [round(x, 8) for x in r]
                for i, step in enumerate(sp['readings'])
                for k, r in step.items()}
    # each step's peak allocation, and its peak above what was allocated
    # just before it, a rank and single-process; the last (warm) step's
    # allocation sites on rank 0 and single-process
    peaks = [round(max(m[0] for m in r['memory']), 2) for r in ranks]
    ref_peak = round(max(m[0] for m in sp['ref_memory']), 2)
    step_peaks = [[round(m[1], 2) for m in r['memory']] for r in ranks]
    ref_step_peaks = [round(m[1], 2) for m in sp['ref_memory']]
    warm = [p[-1] / ref_step_peaks[-1] for p in step_peaks]
    counts = [tuple(r['counts']) for r in ranks]
    want_counts = (2 * SP_TRAIN_STEPS, SP_TRAIN_STEPS)
    log(f'[gspmd] (e) spatially sharded training, the leaf config\'s PFGST '
        f'step at {SP_TRAIN_HW} (twice the leaf\'s crop height), batch 2, '
        f'SGD, sp 2 over two gloo ranks sharing the card (blocks '
        f'{sp["block"]} a rank): {SP_TRAIN_STEPS} fp32 steps, each against '
        f'the single-process step from the same state on the same batch, '
        f'log vars largest relative gap a step {[f"{g:.2e}" for g in gaps]}, outside the '
        f'bounds {bad}; [cosine, norm gap] {json.dumps(readings)}; '
        f'unchanged on both sides {sp["unchanged"]}; ranks '
        f'bitwise equal {[r["agree"] for r in ranks]}; peak GiB allocated '
        f'a rank {peaks} against the single-process step\'s {ref_peak} '
        f'(ratio {[round(p / ref_peak, 3) for p in peaks]}); each step\'s '
        f'peak above what was allocated before it {step_peaks} against '
        f'{ref_step_peaks} GiB, the warm step\'s ratio '
        f'{[round(w, 3) for w in warm]}; alive at the warm step\'s peak by '
        f'site (GiB), rank 0 {sp["memory"][-1][2]}, single-process '
        f'{sp["ref_memory"][-1][2]}; '
        f'similarity launches fwd/bwd a rank {counts}, by shape '
        f'{json.dumps(sp["shapes"])}; {sp["wall"]:.2f} s for the steps a '
        f'rank (two processes on one card, not the mode\'s speed), '
        f'single-process {sp["ref_wall"]:.2f} s, on {card}')
    if bad or not all(c >= 0.9999 and g <= 1e-3
                      for c, g in readings.values()):
        raise AssertionError('[gspmd] (e) the spatial steps are not the '
                             'single-process steps')
    if not all(r['agree'] for r in ranks) or \
            not all(p < ref_peak for p in peaks) or \
            any(c != want_counts for c in counts):
        raise AssertionError(f'[gspmd] (e) ranks alike '
                             f'{[r["agree"] for r in ranks]}, peaks {peaks} '
                             f'against {ref_peak}, launches {counts}')
    return dict(gaps=gaps, readings=readings, peak_gib=peaks,
                ref_peak_gib=ref_peak, step_peak_gib=step_peaks,
                ref_step_peak_gib=ref_step_peaks, warm_ratio=warm,
                counts=counts,
                shapes=sp['shapes'], wall=sp['wall'],
                ref_wall=sp['ref_wall'])


def _spatial_train_cli_start(data):
    """(e): ``tools/train_torch.py --sp 2 --launcher pytorch`` under
    torchrun on phase 13's packs, SP_CLI_ITERS iterations, no evaluation,
    started (beside (c)'s CLI); ``_spatial_train_cli`` waits for it."""
    root = tempfile.mkdtemp(prefix='pfst_sp_train_')
    pots, vaih, _ = data
    cfg = _loop_config(pots, vaih)
    cfg.merge_from_dict({'checkpoint_config.interval': SP_CLI_ITERS})
    cfg_path = osp.join(root, 'sp_config.py')
    cfg.dump(cfg_path)
    work = osp.join(root, 'work')
    started = _torchrun_start(root, 'train_torch', [
        cfg_path, '--work-dir', work, '--seed', '0', '--max-iters',
        str(SP_CLI_ITERS), '--no-validate', '--sp', '2'])
    return dict(root=root, cfg=cfg, work=work, started=started,
                t0=time.time())


def _spatial_train_cli(card, run):
    """(e): the ``--sp 2`` run of ``_spatial_train_cli_start`` waited
    for: both ranks end with the state rank 0 wrote, and the checkpoint
    loads into the single-process port, whose forward on a request is
    finite."""
    cfg = run['cfg']
    try:
        train, _ = _torchrun_wait(*run['started'],
                                  '(e) train_torch --sp 2 under torchrun')
        wall = time.time() - run['t0']
        ckpt = osp.join(run['work'], f'iter_{SP_CLI_ITERS}.pth')
        saved = torch.load(ckpt, map_location='cpu',
                           weights_only=False)['state_dict']
        written = _digest({k[len('model.'):]: v for k, v in saved.items()
                           if k.startswith('model.')})
        model = init_segmentor(cfg, ckpt)
        with torch.no_grad():
            logits = model.inference_logits(
                _request(cfg, 2500, TRAIN_HW).cuda())[0]
        finite = bool(torch.isfinite(logits).all())
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(run['root'], ignore_errors=True)
    digests = [r['digest'] for r in train]
    launches = [r['launches'] for r in train]
    log(f'[gspmd] (e) train_torch --sp 2 --launcher pytorch, 2 gloo ranks '
        f'sharing one GPU, {SP_CLI_ITERS} iterations of the leaf config at '
        f'full width, no evaluation, beside (c)\'s CLI: {wall:.1f} s; the '
        f'ranks\' students equal the checkpoint rank 0 wrote '
        f'{[d == written for d in digests]}; similarity launches fwd/bwd a '
        f'rank {launches}; the checkpoint loads into the single-process '
        f'port, its logits finite {finite} on {card}')
    if any(d != written for d in digests) or not finite or any(
            tuple(n) != (2 * SP_CLI_ITERS, SP_CLI_ITERS) for n in launches):
        raise AssertionError(f'[gspmd] (e) --sp 2: digests {digests} against '
                             f'{written}, finite {finite}, launches '
                             f'{launches}')
    return dict(launches=launches, wall=wall)


def _digest(state_dict):
    """A SHA-256 of a state dict's tensors, by name, bitwise."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _check_pipe_moe(res, card):
    pipe = res['pipe']
    other = res['pipe_other']
    grads1 = max(_rel(res['pipe_mine1'][k], other[k]) for k in other)
    pipe_grads = max(res['pipe_grads'][0], grads1)
    moe = res['moe']
    flash = [res['pipe_flash'], res['pipe_flash1']]
    log(f'[gspmd] (d) GPipe of ViT-B\'s {PIPE_BLOCKS} blocks as 2 stages of '
        f'{PIPE_BLOCKS // 2} at {PIPE_SHAPE}, {PIPE_MB} microbatches, fp32, '
        f'against the blocks in sequence: output {pipe["out"]:.2e}, input '
        f'gradient {pipe["dx"]:.2e}, parameter gradients {pipe_grads:.2e} '
        f'(largest |diff| over the largest |value|); flash launches '
        f'fwd/dkv/dq a stage {flash}; {res["pipe_wall"]:.2f} s forward and '
        f'backward. MoE of 2 ViT-B MLP experts on {MOE_TOKENS} tokens a '
        f'rank: ample capacity against the dense computation '
        f'{moe["ample"]:.2e}; capacity factor 0.5: kept tokens '
        f'{moe["tight_kept"]:.2e}, {moe["dropped"]} dropped, largest |out| '
        f'of a dropped token {moe["tight_dropped"]} on {card}')
    if max(pipe['out'], pipe['dx'], pipe_grads) > 1e-4 or \
            moe['ample'] > 1e-5 or moe['tight_kept'] > 1e-5 or \
            moe['tight_dropped'] != 0.0 or not moe['dropped']:
        raise AssertionError(f'[gspmd] (d) GPipe / MoE: {pipe}, {moe}')
    want = PIPE_MB * PIPE_BLOCKS // 2
    if any(tuple(f) != (want, want, want) for f in flash):
        raise AssertionError(f'[gspmd] (d) flash launches {flash}')
    return flash


def _spatial_cli(card, data):
    """(c): ``tools/test_torch.py --spatial 2 --launcher pytorch`` under
    torchrun on phase 13's packs, against ``single_gpu_test``."""
    from pfst_tpu_torch.apis import single_gpu_test
    from pfst_tpu_torch.apis.train import _build_val
    root = tempfile.mkdtemp(prefix='pfst_spatial_')
    try:
        pots, vaih, _ = data
        cfg = _loop_config(pots, vaih)
        cfg_path = osp.join(root, 'spatial_config.py')
        cfg.dump(cfg_path)
        model = init_segmentor(cfg)
        ckpt = osp.join(root, 'seeded.pth')
        torch.save({'state_dict': model.state_dict()}, ckpt)
        val = _build_val(cfg)
        single = single_gpu_test(model, val['loader'], pre_eval=True,
                                 progress=False)
        miou = val['dataset'].evaluate(single, metric='mIoU')['mIoU']
        del model
        torch.cuda.empty_cache()
        t0 = time.time()
        test, _ = _torchrun(root, 'test_torch', [
            cfg_path, ckpt, '--eval', 'mIoU', '--spatial', '2'],
            '(c) test_torch --spatial 2 under torchrun')
        cli = test[0]['result']['mIoU']
        wall = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f'[gspmd] (c) test_torch --spatial 2 --launcher pytorch on '
        f'{len(single)} tiles: mIoU {cli} against single_gpu_test\'s {miou} '
        f'({wall:.1f} s) on {card}')
    if cli != miou:
        raise AssertionError(f'[gspmd] (c) --spatial 2 mIoU {cli} != '
                             f'{miou}')
    return dict(miou=miou, cli=cli)


def phase_gspmd_start():
    """Phase 23's two ranks, started (``main`` starts them before phase
    22, which runs beside them): (their directory, processes, results'
    path, start time)."""
    root = tempfile.mkdtemp(prefix='pfst_gspmd_')
    return (root, *_gspmd_ranks(root), time.time())


def phase_gspmd(card, data, ranks):
    """Phase 23: tensor parallelism, ZeRO-1 and ZeRO-3, spatial inference,
    GPipe and the MoE, and spatially sharded training on two gloo ranks
    sharing the card, (a)-(e), the ranks of ``phase_gspmd_start``; the
    operations gloo stages through the host printed."""
    root, procs, path, t0 = ranks
    try:
        texts = _wait(procs, 'phase 23 ranks', GSPMD_TIMEOUT_S)
        ranks_s = time.time() - t0
        out = torch.load(path, weights_only=False)
        other = torch.load(path + '.rank1', weights_only=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del texts
    res = dict(tp_ref=out['tp']['ref'], tp=out['tp']['tp'],
               tp_flash=out['tp']['flash'], tp_flash1=other['tp_flash'],
               tp_agree=out['tp']['agree'], tp_heads=out['tp']['heads'],
               tp_wall=out['tp']['wall'], zero_ref=out['zero']['ref'],
               zero=out['zero'], audit1=other['audit'],
               zero_counts1=other['zero_counts'], peak1=other['peak'],
               spatial_whole=out['spatial']['whole'],
               spatial_logits=out['spatial']['logits'],
               spatial_logits1=other['logits'],
               spatial_wall=out['spatial']['wall'],
               spatial_peak=out['spatial']['peak_gib'],
               pipe_mine1=other['pipe_mine'], pipe_flash1=other['pipe_flash'],
               sp=out['spatial_train'], sp1=other['sp_train'],
               **{k: out['pipe_moe'][k] for k in (
                   'pipe', 'pipe_grads', 'pipe_other', 'pipe_flash',
                   'pipe_wall', 'moe')})
    sp_run = _spatial_train_cli_start(data)
    try:
        log(f'[gspmd] gloo stages through pinned host memory on the card: '
            f'{list(out["staged"])}; the ranks {ranks_s:.1f} s since their '
            f'start (beside phase 22); parts s ' + json.dumps(
                {k: round(out[k]['part_s'], 1)
                 for k in ('tp', 'zero', 'spatial', 'pipe_moe',
                           'spatial_train')}))
        tp_flash = _check_tp(res, card)
        zero_readings = _check_zero(res, card)
        spatial = _check_spatial(res, card)
        cli = _spatial_cli(card, data)
        pipe_flash = _check_pipe_moe(res, card)
        sp_train = _check_spatial_train(res, card)
    finally:
        sp_cli = _spatial_train_cli(card, sp_run)
    return dict(tp_flash=tp_flash, pipe_flash=pipe_flash,
                zero=zero_readings, spatial=spatial, cli=cli,
                sp_train=sp_train, sp_cli=sp_cli,
                staged=list(out['staged']))


def timed(fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_S`` under its name
    without ``phase_``."""
    t0 = time.time()
    out = fn(*args)
    PHASE_S[fn.__name__.removeprefix('phase_')] = round(time.time() - t0, 1)
    return out


def main():
    card = timed(phase_card)
    timed(phase_build)
    cases = timed(phase_kernel_vs_plain)
    bwd_cases, bwd_geometry = timed(phase_backward_vs_plain)
    flash_cases = timed(phase_flash_vs_plain)
    ab_cases = timed(phase_flash_bias_vs_plain)
    cfg = Config.fromfile(LEAF)
    model = init_segmentor(cfg)      # seeded random weights, on the card
    launches, _ = timed(phase_serving, cfg, model)
    timed(phase_card_vs_cpu, cfg, model)
    timed(phase_pseudo_label, cfg, model, card)
    del model
    torch.cuda.empty_cache()
    train = timed(phase_train, cfg, card)
    timed(phase_train_card_vs_cpu, cfg)
    vit_cfg = vit_config()
    vit_model = init_segmentor(vit_cfg)      # seeded random weights
    vit_serve = timed(phase_vit_serving, vit_cfg, vit_model)
    del vit_model
    torch.cuda.empty_cache()
    timed(phase_vit_card_vs_cpu)
    vit_train = timed(phase_vit_train, card)
    timed(phase_vit_train_card_vs_cpu)
    timed(phase_microbench)
    data_root = tempfile.mkdtemp(prefix='pfst_isprs_')
    try:
        data = timed(isprs_data, data_root)
        loop = timed(phase_loop, card, train['fp32'][0], data)
        configs = timed(phase_loop_configs, card, data)
        eo = timed(phase_eo, card)
        uda = timed(phase_uda, card, cfg, train['fp32'][0], data)
        adaptors = timed(phase_adaptors, card, cfg, train['fp32'][0], data)
        pseudo = timed(phase_pseudo_labels, card, data, cases)
        hooks = timed(phase_hooks, card, data)
        tf = timed(phase_transformers, card, data, ab_cases)
        a13 = timed(phase_a13_heads, card)
        timed(phase_quant, card, data)
        # phase 23's ranks run beside phase 22
        ranks = phase_gspmd_start()
        try:
            ddp = timed(phase_ddp, card, data, loop['s_iter_median'])
            gspmd = timed(phase_gspmd, card, data, ranks)
        finally:
            for p in ranks[1]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(ranks[0], ignore_errors=True)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    eo_fwd = sum(r['launches'][0] for r in eo.values())
    eo_bwd = sum(r['launches'][1] for r in eo.values())
    cfg_fwd = sum(r['launches'][0] for r in configs.values())
    cfg_bwd = sum(r['launches'][1] for r in configs.values())
    main_case = next(c for c in cases if c['shape'] == list(SIM_CASES[0][0])
                     and c['dtype'] == 'float32')
    bwd_case = next(c for c in bwd_cases if c['sim_type'] == 'cosine'
                    and c['dtype'] == 'float32'
                    and c['shape'] == list(BWD_SHAPE))
    train_fwd = sum(t[1][0] for t in train.values())
    train_bwd = sum(t[1][1] for t in train.values())
    kernels = [dict(
        name='neighborhood_similarity', route='cuda',
        source='pfst_tpu_torch/ops/csrc/neighborhood_sim.cu',
        replaces='pfst_tpu/ops/pallas_sim.py:35',
        launches=launches + train_fwd + vit_serve['sim']
        + sum(r['sim'] for r in tf['serve'].values())
        + sum(r['sim'] for r in a13['serve'].values())
        + loop['launches'][0] + loop['launches_b'][0] + eo_fwd
        + uda['launches'][0] + cfg_fwd + adaptors['launches'][0]
        + pseudo['launches'][0] + hooks['launches'][0]
        + ddp['a']['launches'][0] + sum(r[0] for r in ddp['c']['launches'])
        + sum(c[0] for r in gspmd['zero'].values() for c in r['counts'])
        + sum(c[0] for c in gspmd['sp_train']['counts'])
        + sum(c[0] for c in gspmd['sp_cli']['launches']),
        launches_per_request=(launches + vit_serve['sim'])
        / (N_REQUESTS + N_VIT_REQUESTS),
        launches_per_train_step=train_fwd / (TRAIN_STEPS * len(train)),
        launches_per_loop_iter=loop['launches'][0] / LOOP_ITERS,
        launches_per_eo_iter={n: r['launches'][0] / LOOP_ITERS
                              for n, r in eo.items()},
        launches_per_uda_step={n: r['launches']['neighborhood_similarity']
                               for n, r in uda['algorithms'].items()},
        launches_per_adaptor_step={
            n: r['launches']['neighborhood_similarity']
            for n, r in adaptors['algorithms'].items()},
        launches_pseudo_label_phase=pseudo['launches'][0],
        launches_hooks_phase=hooks['launches'][0],
        launches_a13_phase=sum(r['sim'] for r in a13['serve'].values()),
        launches_ddp_world_one=ddp['a']['launches'][0],
        launches_ddp_cli_per_rank=[r[0] for r in ddp['c']['launches']],
        launches_zero_per_rank={f'zero{lv}': [c[0] for c in r['counts']]
                                for lv, r in gspmd['zero'].items()},
        launches_sp_per_rank=[c[0] for c in gspmd['sp_train']['counts']],
        launches_sp_cli_per_rank=[c[0] for c in gspmd['sp_cli']['launches']],
        a13_feature_shapes={n: r['sim_shape']
                            for n, r in a13['serve'].items()},
        max_abs_err=max(c['max_abs_err'] for c in cases),
        ms=main_case['ms'], device_ms=main_case['device_ms'],
        plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=None, cases=cases), dict(
        name='neighborhood_similarity_backward', route='cuda',
        source='pfst_tpu_torch/ops/csrc/neighborhood_sim.cu',
        replaces='pfst_tpu/ops/pallas_sim.py:112',
        launches=train_bwd + loop['launches'][1] + loop['launches_b'][1]
        + eo_bwd + uda['launches'][1] + cfg_bwd + adaptors['launches'][1]
        + pseudo['launches'][1] + hooks['launches'][1]
        + ddp['a']['launches'][1] + sum(r[1] for r in ddp['c']['launches'])
        + sum(c[1] for r in gspmd['zero'].values() for c in r['counts'])
        + sum(c[1] for c in gspmd['sp_train']['counts'])
        + sum(c[1] for c in gspmd['sp_cli']['launches']),
        launches_per_request=0,
        launches_per_train_step=train_bwd / (TRAIN_STEPS * len(train)),
        launches_per_loop_iter=loop['launches'][1] / LOOP_ITERS,
        launches_per_eo_iter={n: r['launches'][1] / LOOP_ITERS
                              for n, r in eo.items()},
        launches_per_uda_step={
            n: r['launches']['neighborhood_similarity_backward']
            for n, r in uda['algorithms'].items()},
        launches_per_adaptor_step={
            n: r['launches']['neighborhood_similarity_backward']
            for n, r in adaptors['algorithms'].items()},
        launches_pseudo_label_phase=pseudo['launches'][1],
        launches_hooks_phase=hooks['launches'][1],
        launches_ddp_world_one=ddp['a']['launches'][1],
        launches_ddp_cli_per_rank=[r[1] for r in ddp['c']['launches']],
        launches_zero_per_rank={f'zero{lv}': [c[1] for c in r['counts']]
                                for lv, r in gspmd['zero'].items()},
        launches_sp_per_rank=[c[1] for c in gspmd['sp_train']['counts']],
        launches_sp_cli_per_rank=[c[1] for c in gspmd['sp_cli']['launches']],
        max_abs_err=max(c['max_abs_err'] for c in bwd_cases + bwd_geometry),
        ms=bwd_case['ms'], device_ms=bwd_case['device_ms'],
        plain_ms=bwd_case['plain_ms'],
        bound_ms=bwd_case['bound_ms'], bound_by=bwd_case['bound_by'],
        library_ms=None, cases=bwd_cases, geometry_cases=bwd_geometry)]
    kernels += _flash_entries(flash_cases, vit_serve, vit_train, ab_cases,
                              tf, a13, gspmd)
    log(f'[train] s/iter batch 2 of {TRAIN_HW}: fp32 {train["fp32"][0]:.4f}, '
        f'bf16 {train["bf16"][0]:.4f} on {card}')
    log(f'[vit] warm ms per {VIT_HW} request {vit_serve["warm_ms"]:.2f}; '
        f's/iter batch 2 of {VIT_HW}: fp32 {vit_train["fp32"][0]:.4f}, '
        f'bf16 {vit_train["bf16"][0]:.4f} on {card}')
    log(f'[loop] s/iter batch 2 of {TRAIN_HW} through the loop: median '
        f'{loop["s_iter_median"]:.4f} (bare step '
        f'{loop["bare_step_s_iter"]:.4f}), data stall median '
        f'{loop["data_stall_median"]:.4f} on {card}')
    for name, r in eo.items():
        log(f'[eo] {name}: s/iter batch {r["batch"]} through the loop: '
            f'median {r["s_iter_median"]:.4f}, mean {r["s_iter_mean"]:.4f}, '
            f'data stall median '
            f'{r["data_stall_median"]:.4f} on {card}')
    log(f'[uda] s/iter batch 2 of {TRAIN_HW}: ' + ', '.join(
        f'{n} {r["s_iter"]:.4f}' for n, r in uda['algorithms'].items())
        + f' (bare PFGST step {train["fp32"][0]:.4f}) on {card}')
    log(f'[adaptor] s/iter batch 2 of {TRAIN_HW}: ' + ', '.join(
        f'{n} {r["s_iter"]:.4f}' for n, r in adaptors['algorithms'].items())
        + f' (bare PFGST step {train["fp32"][0]:.4f}) on {card}')
    log('[configs] s/iter through the loop: ' + ', '.join(
        f'{n} {r["s_iter_median"]:.4f}' for n, r in configs.items())
        + f' on {card}')
    log(f'[phases] wall s {json.dumps(PHASE_S)}; in phases '
        f'{sum(PHASE_S.values()):.1f} s, since the imports '
        f'{time.time() - T_START:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--ddp-rank']:
        ddp_rank_main(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ['--gspmd-rank']:
        gspmd_rank_main(sys.argv[2])
        sys.exit(0)
    try:
        main()
    except Exception:  # noqa: BLE001 - report the failed phase, exit 1
        traceback.print_exc()
        sys.exit(1)
